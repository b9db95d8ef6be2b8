"""Small encoders for the image files Pillow does not write: Adam7
(interlaced) PNG at any colour type and depth, 4- and 16-bit and RLE8 /
RLE4 BMP (Windows and OS/2 headers), and GIFs of several frames with
every disposal method, local palettes, transparency and interlace, their
LZW written here. numpy and the standard library only."""

import struct
import zlib

import numpy as np

# -- PNG -------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w * channels] samples as packed scanline bytes."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    flat = samples.reshape(h, -1).astype(np.uint8)
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat << shifts).sum(axis=2).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, filters: list[int]) -> bytes:
    """Each row led by its filter type (0-4) and filtered by it."""
    out = []
    prior = np.zeros(rows.shape[1], dtype=np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]]) if len(row) else row
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]]) if len(row) else row
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prior
        elif kind == 3:
            f = row - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
            f = row - pred
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def png(samples: np.ndarray, depth: int, color: int, palette: bytes = b"", interlace: bool = True,
        filters=(0, 1, 2, 3, 4), trns: bytes = b"") -> bytes:
    """``samples`` ([h, w] or [h, w, channels] integers at ``depth``) as a
    PNG, Adam7-interlaced unless ``interlace`` is false, the rows filtered
    by ``filters`` in turn."""
    h, w = samples.shape[:2]
    channels = _CHANNELS[color]
    samples = samples.reshape(h, w, channels)
    bpp = max(depth * channels // 8, 1)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter_rows(_pack_rows(sub, depth), bpp, list(filters))
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, list(filters))
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                                    int(interlace)))
    if palette:
        out += _png_chunk(b"PLTE", palette)
    if trns:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b"")



def apng(size: tuple[int, int], frames: list[dict], depth: int, color: int, palette: bytes = b"", trns: bytes = b"",
         default: np.ndarray | None = None) -> bytes:
    """An animated PNG of ``frames``: each a dict with "samples" ([h, w] or
    [h, w, channels] integers at ``depth``), and optional "at" ((x, y)),
    "dispose" (0-2) and "blend" (0-1). ``default`` is an image outside the
    animation, written as the IDAT; without it the first frame is the IDAT."""
    w, h = size
    channels = _CHANNELS[color]
    bpp = max(depth * channels // 8, 1)

    def data(samples):
        samples = np.asarray(samples).reshape(samples.shape[0], samples.shape[1], channels)
        return zlib.compress(_filter_rows(_pack_rows(samples, depth), bpp, [0, 1, 2, 3, 4]))

    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette:
        out += _png_chunk(b"PLTE", palette)
    if trns:
        out += _png_chunk(b"tRNS", trns)
    out += _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))
    if default is not None:
        out += _png_chunk(b"IDAT", data(default))
    seq = 0
    for k, frame in enumerate(frames):
        s = np.asarray(frame["samples"])
        x, y = frame.get("at", (0, 0))
        out += _png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, s.shape[1], s.shape[0], x, y, 1, 10,
                                               frame.get("dispose", 0), frame.get("blend", 0)))
        seq += 1
        if k == 0 and default is None:
            out += _png_chunk(b"IDAT", data(s))
        else:
            out += _png_chunk(b"fdAT", struct.pack(">I", seq) + data(s))
            seq += 1
    return out + _png_chunk(b"IEND", b"")

# -- BMP -------------------------------------------------------------------------

def _rle_rows(indexes: np.ndarray, rle4: bool, rng) -> bytes:
    """RLE8 / RLE4 of bottom-up rows: runs where pixels repeat, absolute
    runs elsewhere (even lengths in RLE4), an end of line after each row
    and an end of bitmap."""
    out = bytearray()
    for row in indexes[::-1]:
        row = row.tolist()
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or len(row) - x < 3:
                value = row[x] << 4 | row[x] if rle4 else row[x]
                out += bytes([run, value])
                x += run
                continue
            n = min(int(rng.integers(3, 12)), len(row) - x)
            if rle4:
                n -= n % 2
                if n < 3:
                    out += bytes([1, row[x] << 4])
                    x += 1
                    continue
                packed = [row[x + i] << 4 | row[x + i + 1] for i in range(0, n, 2)]
            else:
                packed = row[x:x + n]
            out += bytes([0, n]) + bytes(packed)
            if len(packed) % 2:
                out += b"\x00"  # runs end on a 16-bit boundary
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp(pixels: np.ndarray, bits: int, palette: np.ndarray | None = None, rle: bool = False,
        os2: bool = False, masks16=(0x7C00, 0x3E0, 0x1F), bitfields: bool = False, top_down: bool = False,
        rng=None) -> bytes:
    """A BMP of ``pixels``: [h, w] palette indexes at 1, 4 or 8 bits (with
    ``palette``, [n, 3] RGB), or [h, w, 3] RGB at 16 bits (``masks16``'s
    5-5-5 or 5-6-5 layout, as BI_BITFIELDS if ``bitfields``, else BI_RGB)
    or 24 bits; RLE8 / RLE4 at 8 / 4 bits if ``rle``; the OS/2 1.x core
    header if ``os2`` (uncompressed, bottom-up)."""
    h, w = pixels.shape[:2]
    header_size = 12 if os2 else 40
    compression = 0
    if rle:
        compression = 1 if bits == 8 else 2
        body = _rle_rows(pixels, bits == 4, rng if rng is not None else np.random.default_rng(0))
    else:
        if bits <= 8:
            rows = _pack_rows(pixels, bits)
        elif bits == 16:
            rgb = pixels.astype(np.uint32)
            if masks16 == (0xF800, 0x7E0, 0x1F):
                value = (rgb[..., 0] >> 3) << 11 | (rgb[..., 1] >> 2) << 5 | rgb[..., 2] >> 3
            else:
                value = (rgb[..., 0] >> 3) << 10 | (rgb[..., 1] >> 3) << 5 | rgb[..., 2] >> 3
            rows = value.astype("<u2").view(np.uint8).reshape(h, -1)
            compression = 3 if bitfields else 0
        else:
            rows = pixels[..., ::-1].reshape(h, -1).astype(np.uint8)
        stride = ((w * bits + 31) >> 3) & ~3
        rows = np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))
        body = (rows if top_down else rows[::-1]).tobytes()
    table = b""
    if bits <= 8:
        entry = 3 if os2 else 4
        # the OS/2 core header has no colour count: its table is 2 ** bits long
        pal = np.zeros(((1 << bits) if os2 else len(palette), entry), np.uint8)
        pal[: len(palette), :3] = palette[:, ::-1]
        table = pal.tobytes()
    extra = struct.pack("<III", *masks16) if compression == 3 else b""
    offset = 14 + header_size + len(extra) + len(table)
    if os2:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, compression, len(body), 2835,
                           2835, len(palette) if palette is not None else 0, 0)
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + info + extra + table + body


# -- GIF ---------------------------------------------------------------------------

def lzw(indexes: np.ndarray, min_size: int) -> bytes:
    """GIF LZW of ``indexes`` (a flat array), in sub-blocks, with a clear
    code whenever the table fills."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    size, table, next_code = min_size + 1, {}, end + 1
    bits, nbits, out = 0, 0, bytearray()

    def put(code):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(bits & 0xFF)
            bits >>= 8
            nbits -= 8

    put(clear)
    prefix = None
    for k in indexes.tolist():
        if prefix is None:
            prefix = (k,)
            continue
        key = prefix + (k,)
        if key in table or len(key) == 1:
            prefix = key
            continue
        put(table[prefix] if len(prefix) > 1 else prefix[0])
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code - 1 == (1 << size) and size < 12:
                size += 1
        else:
            put(clear)
            table, next_code, size = {}, end + 1, min_size + 1
        prefix = (k,)
    if prefix is not None:
        put(table[prefix] if len(prefix) > 1 else prefix[0])
    put(end)
    if nbits:
        out.append(bits & 0xFF)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255]) for i in range(0, len(out), 255))
    return bytes([min_size]) + blocks + b"\x00"


INTERLACE_ROWS = ((0, 8), (4, 8), (2, 4), (1, 2))


def gif(size: tuple[int, int], frames: list[dict], global_palette: np.ndarray | None = None,
        background: int = 0) -> bytes:
    """A GIF89a of ``frames``: each a dict with "indexes" ([h, w]), "at"
    ((x, y) in the screen), and optional "palette" (local, [n, 3]),
    "transparency" (an index), "disposal" (0-3), "interlace"."""
    w, h = size
    flags = 0
    table = b""
    if global_palette is not None:
        bits = max(int(np.ceil(np.log2(max(len(global_palette), 2)))), 1)
        pal = np.zeros((1 << bits, 3), np.uint8)
        pal[: len(global_palette)] = global_palette
        flags = 0x80 | 0x70 | (bits - 1)
        table = pal.tobytes()
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags, background, 0) + table
    for frame in frames:
        idx = np.asarray(frame["indexes"], np.uint8)
        fh, fw = idx.shape
        transparency = frame.get("transparency")
        gce_flags = (frame.get("disposal", 0) << 2) | (1 if transparency is not None else 0)
        out += b"\x21\xf9\x04" + struct.pack("<BHB", gce_flags, 10, transparency or 0) + b"\x00"
        x, y = frame.get("at", (0, 0))
        local = frame.get("palette")
        dflags = 0
        ltable = b""
        if local is not None:
            bits = max(int(np.ceil(np.log2(max(len(local), 2)))), 1)
            pal = np.zeros((1 << bits, 3), np.uint8)
            pal[: len(local)] = local
            dflags = 0x80 | (bits - 1)
            ltable = pal.tobytes()
        if frame.get("interlace"):
            dflags |= 0x40
            idx = np.concatenate([idx[start::step] for start, step in INTERLACE_ROWS])
        out += b"\x2c" + struct.pack("<HHHHB", x, y, fw, fh, dflags) + ltable
        out += lzw(idx.reshape(-1), max(int(idx.max()).bit_length(), 2) if idx.size else 2)
    return out + b"\x3b"


# -- TIFF --------------------------------------------------------------------------

def packbits(raw: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, else literal stretches of up to 128."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j + 1 < n and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), raw[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and raw[j + 1] == raw[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


def tiff_lzw(raw: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW as libtiff writes it (most significant bit first, the width
    growing when the next code would not fit), or the old style (least
    significant bit first, the width growing one code later)."""
    bits, nbits, out = 0, 0, bytearray()
    width = 9

    def put(code):
        nonlocal bits, nbits
        if old_style:
            bits |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(bits & 0xFF)
                bits >>= 8
                nbits -= 8
        else:
            bits = bits << width | code
            nbits += width
            while nbits >= 8:
                out.append((bits >> (nbits - 8)) & 0xFF)
                nbits -= 8
            bits &= (1 << nbits) - 1

    table, next_code = {}, 258
    put(256)

    def added():
        nonlocal width, next_code, table
        next_code += 1
        if next_code == 4094:
            put(256)
            width, next_code, table = 9, 258, {}
        elif next_code == (1 << width) + (1 if old_style else 0) and width < 12:
            width += 1

    prefix = None
    for k in raw:
        if prefix is None:
            prefix = bytes([k])
            continue
        key = prefix + bytes([k])
        if key in table:
            prefix = key
            continue
        put(table[prefix] if len(prefix) > 1 else prefix[0])
        table[key] = next_code
        added()
        prefix = bytes([k])
    if prefix is not None:
        put(table[prefix] if len(prefix) > 1 else prefix[0])
        next_code += 1
        if next_code == (1 << width) + (1 if old_style else 0) and width < 12:
            width += 1
    put(257)
    if nbits:
        out.append((bits << (8 - nbits)) & 0xFF if not old_style else bits & 0xFF)
    return bytes(out)


# ITU-T T.4 Modified Huffman codes: run -> bits
_WHITE_TERM = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
               "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 "
               "0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 "
               "00101000 00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
               "01010011 01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 "
               "00110010 00110011 00110100").split()
_WHITE_MAKEUP = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
                 "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
                 "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
               "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 "
               "00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 "
               "000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 000011010100 "
               "000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 000011011011 "
               "000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 000001010010 "
               "000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
               "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
                 "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
                 "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
                 "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
                 "0000001100100 0000001100101").split()
_EXTENDED = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
             "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
_MODES = {"pass": "0001", "horizontal": "001", 0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
          -2: "000010", -3: "0000010"}


def _run_code(run: int, black: bool) -> str:
    term, makeup = (_BLACK_TERM, _BLACK_MAKEUP) if black else (_WHITE_TERM, _WHITE_MAKEUP)
    out = ""
    while run >= 2560:
        out += _EXTENDED[-1]
        run -= 2560
    if run >= 1792:
        out += _EXTENDED[(run - 1792) // 64]
        run %= 64
    elif run >= 64:
        out += makeup[run // 64 - 1]
        run %= 64
    return out + term[run]


def _changes(row: np.ndarray) -> list[int]:
    """The positions where a row of bits (1 black) changes colour, from white."""
    padded = np.concatenate([[0], row.astype(np.int8)])
    return [int(i) for i in np.flatnonzero(np.diff(padded))]


def _row_1d(row: np.ndarray) -> str:
    width, out, at, black = len(row), "", 0, False
    for c in _changes(row) + [width]:
        out += _run_code(c - at, black)
        at, black = c, not black
    return out


def _row_2d(row: np.ndarray, ref_row: np.ndarray) -> str:
    """T.4 two-dimensional coding of ``row`` against ``ref_row``."""
    width = len(row)
    cur, ref = _changes(row) + [width, width], _changes(ref_row) + [width, width]
    out, a0, black = "", -1, False
    while a0 < width:
        a1 = next((c for c in cur if c > a0), width)
        k = next(i for i, c in enumerate(ref) if c > a0 and i % 2 == int(black))
        b1, b2 = ref[k], ref[k + 1] if k + 1 < len(ref) else width
        if b2 < a1:
            out += _MODES["pass"]
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += _MODES[a1 - b1]
            a0, black = a1, not black
        else:
            a2 = next((c for c in cur if c > a1), width)
            out += _MODES["horizontal"] + _run_code(a1 - max(a0, 0), black) + _run_code(a2 - a1, not black)
            a0 = a2
    return out


def ccitt(bits: np.ndarray, compression: int, two_d_every: int = 0) -> bytes:
    """[h, w] bits (1 black) as CCITT RLE (2), Group 3 (3: an EOL before each
    row, byte-aligned; with ``two_d_every`` k > 0, T.4 2D coding with a
    one-dimensional row every k rows after a tag bit) or Group 4 (4)."""
    out = ""
    ref = np.zeros(bits.shape[1], dtype=np.uint8)
    for y, row in enumerate(bits):
        if compression == 2:
            out += _row_1d(row)
            out += "0" * (-len(out) % 8)
        elif compression == 3:
            out += "0" * ((-len(out) - 12) % 8) + "000000000001"
            if two_d_every:
                one_d = y % two_d_every == 0
                out += ("1" + _row_1d(row)) if one_d else ("0" + _row_2d(row, ref))
            else:
                out += _row_1d(row)
        else:
            out += _row_2d(row, ref)
        ref = row
    if compression == 4:
        out += "000000000001" * 2
    out += "0" * (-len(out) % 8)
    return int(out, 2).to_bytes(len(out) // 8, "big") if out else b""


_REVERSE = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def _pack_samples(samples: np.ndarray, bits: int, order: str) -> bytes:
    """[rows, cols, n] samples as packed rows, each on a byte boundary."""
    rows = samples.shape[0]
    flat = samples.reshape(rows, -1)
    if bits == 16:
        return flat.astype(order + "u2").tobytes()
    if bits == 8:
        return flat.astype(np.uint8).tobytes()
    return _pack_rows(flat, bits).tobytes()


def tiff(pages: list[dict], order: str = "<", big: bool = False) -> bytes:
    """A TIFF of ``pages``, each a dict with "samples" ([h, w, n] integers)
    and "bits", and optional "photometric" (default 1), "compression" (1, 2,
    3, 4, 5, 8, 32773, 32946), "predictor" (2 for horizontal differencing),
    "planar" (2: each sample a plane of its own), "fill" (2: bits reversed in
    each byte), "tile" ((width, height)) or "rows_per_strip", "extra" (the
    ExtraSamples values), "colormap" ([3 * 2^bits] uint16), "two_d_every"
    (Group 3 2D coding), "lzw_old" (the old LZW bit order), "sample_format"
    and "bits_tag" (a BitsPerSample other than the samples' packing). ``order`` is "<" (II) or ">" (MM); ``big`` writes BigTIFF."""
    word, wsize, entry, count_fmt = ("Q", 8, 20, "Q") if big else ("I", 4, 12, "H")
    out = bytearray(b"II" if order == "<" else b"MM")
    out += struct.pack(order + ("HHHQ" if big else "HI"), *((43, 8, 0, 0) if big else (42, 0)))
    first_at = len(out) - wsize
    link = first_at
    for page in pages:
        s = np.asarray(page["samples"])
        s = s.reshape(s.shape[0], s.shape[1], -1)
        h, w, n = s.shape
        bits, comp = page["bits"], page.get("compression", 1)
        planar, fill, pred = page.get("planar", 1), page.get("fill", 1), page.get("predictor", 1)
        tile = page.get("tile")
        cw, ch = tile if tile else (w, page.get("rows_per_strip", h))
        across, down = -(-w // cw), -(-h // ch)
        planes = [s[..., [k]] for k in range(n)] if planar == 2 else [s]
        chunks = []
        for plane in planes:
            for ty in range(down):
                for tx in range(across):
                    part = plane[ty * ch:(ty + 1) * ch, tx * cw:(tx + 1) * cw]
                    if tile:
                        padded = np.zeros((ch, cw, plane.shape[2]), dtype=part.dtype)
                        padded[: part.shape[0], : part.shape[1]] = part
                        part = padded
                    if pred == 2:
                        mod = 1 << bits
                        part = part.astype(np.int64)
                        part = np.concatenate([part[:, :1], (part[:, 1:] - part[:, :-1]) % mod], axis=1)
                    if comp in (2, 3, 4):
                        raw = ccitt(part[..., 0], comp, page.get("two_d_every", 0))
                    else:
                        raw = _pack_samples(part, bits, order)
                        if comp == 5:
                            raw = tiff_lzw(raw, page.get("lzw_old", False))
                        elif comp in (8, 32946):
                            raw = zlib.compress(raw)
                        elif comp == 32773:
                            raw = packbits(raw)
                    if fill == 2:
                        raw = raw.translate(_REVERSE)
                    chunks.append(raw)
        offsets = []
        for raw in chunks:
            offsets.append(len(out))
            out += raw
            if len(out) % 2:
                out += b"\x00"
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [page.get("bits_tag", bits)] * n), 259: (3, [comp]),
                262: (3, [page.get("photometric", 1)]), 277: (3, [n]), 284: (3, [planar])}
        if fill != 1:
            tags[266] = (3, [fill])
        if pred != 1:
            tags[317] = (3, [pred])
        if comp == 3:
            tags[292] = (4, [1 if page.get("two_d_every") else 0])
        off_type = 16 if big else 4
        if tile:
            tags.update({322: (3, [cw]), 323: (3, [ch]), 324: (off_type, offsets),
                         325: (off_type, [len(c) for c in chunks])})
        else:
            tags.update({273: (off_type, offsets), 278: (4, [ch]), 279: (off_type, [len(c) for c in chunks])})
        if "extra" in page:
            tags[338] = (3, list(page["extra"]))
        if "colormap" in page:
            tags[320] = (3, [int(v) for v in page["colormap"]])
        if "sample_format" in page:
            tags[339] = (3, [page["sample_format"]] * n)
        codes = {3: "H", 4: "I", 16: "Q"}
        if len(out) % 2:
            out += b"\x00"
        ifd_at = len(out)
        struct.pack_into(order + word, out, link, ifd_at)
        body = bytearray(struct.pack(order + count_fmt, len(tags)))
        data_at = ifd_at + len(body) + entry * len(tags) + wsize
        extra_data = bytearray()
        for tag in sorted(tags):
            kind, values = tags[tag]
            payload = struct.pack(f"{order}{len(values)}{codes[kind]}", *values)
            body += struct.pack(order + "HH" + word, tag, kind, len(values))
            if len(payload) <= wsize:
                body += payload.ljust(wsize, b"\x00")
            else:
                body += struct.pack(order + word, data_at + len(extra_data))
                extra_data += payload
                if len(extra_data) % 2:
                    extra_data += b"\x00"
        link = ifd_at + len(body)
        body += b"\x00" * wsize
        out += body + extra_data
    return bytes(out)


# -- WebP --------------------------------------------------------------------------

def _riff(chunks: list[tuple[bytes, bytes]]) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1) for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """The chunks of a WebP file (tag, payload)."""
    out, at = [], 12
    while at + 8 <= len(data):
        tag, size = data[at:at + 4], struct.unpack_from("<I", data, at + 4)[0]
        out.append((tag, data[at + 8:at + 8 + size]))
        at += 8 + size + (size & 1)
    return out


_WEBP_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
                "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
                "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed", "preprocessing",
                "partitions", "partition_limit")
_libwebp = None


def _load_libwebp():
    """Pillow's bundled libwebp (its encoder takes options Pillow's save
    does not pass on: the loop filter's type, level and sharpness, token
    partitions, segments)."""
    global _libwebp
    if _libwebp is None:
        import ctypes
        import glob
        import os

        import PIL

        libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
        ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
        _libwebp = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    return _libwebp


def webp_encode(pixels: np.ndarray, **config) -> bytes:
    """``pixels`` ([h, w, 3] or [h, w, 4] uint8) as a WebP by libwebp's
    ``WebPEncode`` with the ``WebPConfig`` fields ``config`` names (the
    rest its defaults)."""
    import ctypes

    lib = _load_libwebp()
    abi = 0x0200
    cfg = ctypes.create_string_buffer(512)
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), abi):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in config.items():
        offset = 4 * _WEBP_CONFIG.index(key)
        if key == "quality":
            ctypes.c_float.from_buffer(cfg, offset).value = value
        else:
            ctypes.c_int.from_buffer(cfg, offset).value = value
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"invalid WebP options {config}")
    picture = ctypes.create_string_buffer(1024)  # WebPPicture: width at 8, height at 12, writer at 96
    if not lib.WebPPictureInitInternal(picture, abi):
        raise RuntimeError("WebPPictureInit failed")
    h, w, channels = pixels.shape
    ctypes.c_int.from_buffer(picture, 0).value = int(config.get("lossless", 0))  # use_argb: no YUV round trip
    ctypes.c_int.from_buffer(picture, 8).value = w
    ctypes.c_int.from_buffer(picture, 12).value = h
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    load = lib.WebPPictureImportRGBA if channels == 4 else lib.WebPPictureImportRGB
    if not load(picture, pixels.ctypes.data_as(ctypes.c_void_p), w * channels):
        raise RuntimeError("WebPPictureImport failed")
    writer = ctypes.create_string_buffer(64)
    lib.WebPMemoryWriterInit(writer)
    ctypes.c_void_p.from_buffer(picture, 96).value = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(picture, 104).value = ctypes.addressof(writer)
    ok = lib.WebPEncode(cfg, picture)
    out = ctypes.string_at(ctypes.c_void_p.from_buffer(writer, 0).value, ctypes.c_size_t.from_buffer(writer, 8).value)
    lib.WebPPictureFree(picture)
    lib.WebPMemoryWriterClear(writer)
    if not ok:
        raise RuntimeError("WebPEncode failed")
    return out


def _alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filter: 1 horizontal, 2 vertical, 3 gradient."""
    a = alpha.astype(np.int32)
    out = a.copy()
    if method == 0:
        return alpha
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    if a.shape[0] > 1:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        if method == 1:
            out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
        elif method == 2:
            out[1:, 1:] = a[1:, 1:] - a[:-1, 1:]
        else:
            pred = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
            out[1:, 1:] = a[1:, 1:] - pred
    return (out & 0xFF).astype(np.uint8)


def webp_with_alpha(lossy: bytes, alpha: np.ndarray, filter_method: int, compressed: bool,
                    levels_flag: bool = False) -> bytes:
    """A VP8X WebP of a lossy WebP's VP8 bitstream and ``alpha`` in an ALPH
    chunk, filtered by ``filter_method`` (0-3) and stored raw or (with
    ``compressed``) as the green channel of a lossless stream without its
    header; ``levels_flag`` sets the pre-processing bits."""
    vp8 = dict(webp_chunks(lossy))[b"VP8 "]
    h, w = alpha.shape
    filtered = _alpha_filter(alpha, filter_method)
    if compressed:
        green = np.zeros((h, w, 4), np.uint8)
        green[..., 1] = filtered
        green[..., 3] = 255
        lossless = webp_encode(green, lossless=1, quality=100.0, method=4)
        body = dict(webp_chunks(lossless))[b"VP8L"][5:]
    else:
        body = filtered.tobytes()
    header = bytes([int(compressed) | filter_method << 2 | int(levels_flag) << 4])
    vp8x = bytes([0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    return _riff([(b"VP8X", vp8x), (b"ALPH", header + body), (b"VP8 ", vp8)])


def webp_animation(size: tuple[int, int], frames: list[dict], background: tuple = (0, 0, 0, 0)) -> bytes:
    """An animated WebP of still WebPs: each frame a dict with "image" (a
    still WebP's bytes), and optional "at" ((x, y), even), "blend" (default
    True) and "dispose" (to background, default False)."""
    w, h = size
    chunks = [(b"VP8X", bytes([0x12, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")),
              (b"ANIM", bytes([background[2], background[1], background[0], background[3]]) + b"\x00\x00")]
    for frame in frames:
        parts = [(t, p) for t, p in webp_chunks(frame["image"]) if t in (b"ALPH", b"VP8 ", b"VP8L")]
        from PIL import Image
        import io

        fw, fh = Image.open(io.BytesIO(frame["image"])).size
        x, y = frame.get("at", (0, 0))
        flags = (0 if frame.get("blend", True) else 2) | int(frame.get("dispose", False))
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (fw - 1).to_bytes(3, "little")
                + (fh - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + bytes([flags]))
        body = b"".join(t + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1) for t, p in parts)
        chunks.append((b"ANMF", head + body))
    return _riff(chunks)
