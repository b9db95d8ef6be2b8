"""PDF stream filters: Flate (+PNG/TIFF predictors), LZW, ASCIIHex,
ASCII85, RunLength. Image codecs (DCT/JPX/CCITT/JBIG2) pass through raw —
they are decoded by PIL at rasterization time, not here."""

import zlib

from dial_rag_tpu_torch.documents.pdf.objects import Name, PdfError, Stream

_IMAGE_FILTERS = {"DCTDecode", "JPXDecode", "CCITTFaxDecode", "JBIG2Decode"}


def _as_name(x) -> str:
    return x.value if isinstance(x, Name) else str(x)


def apply_predictor(data: bytes, params: dict) -> bytes:
    predictor = params.get("Predictor", 1)
    if predictor <= 1:
        return data
    colors = params.get("Colors", 1)
    bpc = params.get("BitsPerComponent", 8)
    columns = params.get("Columns", 1)
    bpp = max(1, (colors * bpc) // 8)
    row_len = (columns * colors * bpc + 7) // 8

    if predictor == 2:  # TIFF horizontal differencing (8-bit only)
        out = bytearray(data)
        for r in range(0, len(out), row_len):
            for i in range(bpp, row_len):
                if r + i < len(out):
                    out[r + i] = (out[r + i] + out[r + i - bpp]) & 0xFF
        return bytes(out)

    # PNG predictors: each row prefixed with a filter-type byte
    out = bytearray()
    prev = bytearray(row_len)
    pos = 0
    while pos + 1 <= len(data):
        ft = data[pos]
        pos += 1
        row = bytearray(data[pos : pos + row_len])
        pos += row_len
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for i in range(bpp, len(row)):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:  # Up
            for i in range(len(row)):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:  # Average
            for i in range(len(row)):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(len(row)):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        else:
            raise PdfError(f"unknown PNG predictor filter {ft}")
        out.extend(row)
        prev = row
    return bytes(out)


def lzw_decode(data: bytes, early_change: int = 1) -> bytes:
    """LZW per the PDF spec (9-12 bit codes, 256=clear, 257=EOD)."""
    out = bytearray()
    dict_size = 258
    table: dict[int, bytes] = {i: bytes([i]) for i in range(256)}
    code_len = 9
    buffer = 0
    bits = 0
    prev: bytes | None = None
    for byte in data:
        buffer = (buffer << 8) | byte
        bits += 8
        while bits >= code_len:
            bits -= code_len
            code = (buffer >> bits) & ((1 << code_len) - 1)
            if code == 256:
                table = {i: bytes([i]) for i in range(256)}
                dict_size = 258
                code_len = 9
                prev = None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < dict_size and code in table:
                entry = table[code]
            else:
                entry = prev + prev[:1]
            out.extend(entry)
            if prev is not None:
                table[dict_size] = prev + entry[:1]
                dict_size += 1
            prev = entry
            if dict_size + early_change >= (1 << code_len) and code_len < 12:
                code_len += 1
    return bytes(out)


def ascii85_decode(data: bytes) -> bytes:
    data = data.replace(b"\n", b"").replace(b"\r", b"").replace(b" ", b"")
    data = data.replace(b"\t", b"")
    if data.startswith(b"<~"):
        data = data[2:]
    end = data.find(b"~>")
    if end >= 0:
        data = data[:end]
    data = data.replace(b"z", b"!!!!!")
    out = bytearray()
    for i in range(0, len(data), 5):
        group = data[i : i + 5]
        pad = 5 - len(group)
        group = group + b"u" * pad
        val = 0
        for c in group:
            val = val * 85 + (c - 33)
        chunk = val.to_bytes(4, "big")
        out.extend(chunk[: 4 - pad])
    return bytes(out)


def asciihex_decode(data: bytes) -> bytes:
    end = data.find(b">")
    if end >= 0:
        data = data[:end]
    hex_digits = bytes(c for c in data if c in b"0123456789abcdefABCDEF")
    if len(hex_digits) % 2:
        hex_digits += b"0"
    return bytes.fromhex(hex_digits.decode("ascii"))


def runlength_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n == 128:
            break
        if n < 128:
            out.extend(data[i : i + n + 1])
            i += n + 1
        else:
            if i < len(data):
                out.extend(data[i : i + 1] * (257 - n))
                i += 1
    return bytes(out)


def decode_stream(stream: Stream, resolve=None) -> bytes:
    """Apply the stream's filter chain. ``resolve`` maps indirect refs
    (needed when Filter/DecodeParms are refs)."""

    def rv(x):
        return resolve(x) if resolve is not None else x

    filters = rv(stream.dict.get("Filter"))
    if filters is None:
        return stream.raw
    if not isinstance(filters, list):
        filters = [filters]
    params = rv(stream.dict.get("DecodeParms") or stream.dict.get("DP"))
    if not isinstance(params, list):
        params = [params] * len(filters)

    data = stream.raw
    for f, p in zip(filters, params):
        name = _as_name(rv(f))
        p = rv(p) or {}
        if isinstance(p, dict):
            p = {k: rv(v) for k, v in p.items()}
        if name in ("FlateDecode", "Fl"):
            try:
                data = zlib.decompress(data)
            except zlib.error:
                try:
                    # tolerate trailing garbage / missing checksum
                    data = zlib.decompressobj().decompress(data)
                except zlib.error as e:
                    raise PdfError(f"corrupt Flate stream: {e}") from e
            data = apply_predictor(data, p)
        elif name in ("LZWDecode", "LZW"):
            data = lzw_decode(data, p.get("EarlyChange", 1))
            data = apply_predictor(data, p)
        elif name in ("ASCII85Decode", "A85"):
            data = ascii85_decode(data)
        elif name in ("ASCIIHexDecode", "AHx"):
            data = asciihex_decode(data)
        elif name in ("RunLengthDecode", "RL"):
            data = runlength_decode(data)
        elif name in _IMAGE_FILTERS:
            return data  # image codecs handled downstream
        elif name == "Crypt":
            raise PdfError("encrypted streams are not supported")
        else:
            raise PdfError(f"unsupported filter {name}")
    return data
