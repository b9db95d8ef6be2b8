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


# -- JPEG: arithmetic coding (T.81 Annex D, F, G) and lossless (Annex H) -----------

# T.81 Table D.2 (jaricom.c): Qe, next state after an MPS, after an LPS, MPS switch
_QM = [(0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0), (0x03d8, 5, 20, 0),
       (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0), (0x0036, 9, 30, 0), (0x001a, 10, 33, 0),
       (0x000d, 11, 35, 0), (0x0006, 12, 9, 0), (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1),
       (0x3f25, 16, 36, 0), (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
       (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0), (0x0406, 25, 49, 0),
       (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0),
       (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0), (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0),
       (0x002c, 9, 33, 0), (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
       (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
       (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0), (0x0861, 49, 78, 0), (0x0706, 50, 79, 0),
       (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0), (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0),
       (0x025c, 56, 53, 0), (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
       (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0), (0x5b12, 65, 65, 1),
       (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0), (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0),
       (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0), (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0),
       (0x119c, 76, 74, 0), (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
       (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0), (0x34ee, 85, 91, 0),
       (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0),
       (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0), (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0),
       (0x56a8, 96, 95, 1), (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0),
       (0x3c3d, 100, 104, 0), (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0),
       (0x4639, 104, 107, 0), (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0),
       (0x4b85, 103, 109, 0), (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1),
       (0x5522, 109, 112, 0), (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
          21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
          60, 61, 54, 47, 55, 62, 63)
_LUMA_Q = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22,
           29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87,
           103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_CHROMA_Q = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66,
             99, 99, 99, 99, 99, 99) + (99,) * 32


class _QmEncoder:
    """The QM coder's encoder as jcarith.c writes it (D.1): arith_encode,
    its byte output with carry propagation, and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_pending(self, byte: int, stuff: bool = True):
        self.out.extend(b"\0" * self.zc)
        self.zc = 0
        self.out.append(byte)
        if stuff and byte == 0xFF:
            self.out.append(0)

    def encode(self, stats: bytearray, at: int, val: int):
        sv = stats[at]
        qe, nmps, nlps, sw = _QM[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[at] = (sv & 0x80) ^ (nlps | sw << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[at] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_pending(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_pending(self.buffer)
                    if self.sc:
                        self.out.extend(b"\0" * self.zc)
                        self.zc = 0
                        self.out.extend(b"\xff\x00" * self.sc)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            if self.sc:
                self.out.extend(b"\0" * self.zc)
                self.zc = 0
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._emit_pending((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit_pending((self.c >> 11) & 0xFF)
        self.reset()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def _quant_table(base, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.array(base) * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_blocks(plane: np.ndarray, rows: int, cols: int, q: np.ndarray) -> np.ndarray:
    """[rows, cols, 64] quantized DCT coefficients (natural order) of the
    plane, its edges repeated out to rows x cols blocks."""
    h, w = plane.shape
    padded = np.pad(plane.astype(np.float64), ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge") - 128
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(k == 0, np.sqrt(0.5), 1.0)[:, None] / 2
    blocks = padded.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,rcxy,vy->rcuv", basis, blocks, basis).reshape(rows, cols, 64)
    return np.round(coef / q).astype(np.int64)


def _jpeg_components(pixels: np.ndarray, sampling: list[tuple[int, int]], quality: int, ycbcr: bool):
    """(id, h, v, quant table index, blocks [rows, cols, 64]) of each
    component, blocks padded to whole MCUs; pixels [h, w] or [h, w, n]."""
    planes = pixels[..., None] if pixels.ndim == 2 else pixels
    planes = planes.astype(np.float64)
    if ycbcr and planes.shape[2] == 3:
        r, g, b = planes[..., 0], planes[..., 1], planes[..., 2]
        planes = np.stack([0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                           0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    h, w, n = planes.shape
    hmax = max(s[0] for s in sampling[:n])
    vmax = max(s[1] for s in sampling[:n])
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = []
    for c in range(n):
        ch, cv = sampling[c]
        fx, fy = hmax // ch, vmax // cv
        plane = np.pad(planes[..., c], ((0, (-h) % fy), (0, (-w) % fx)), mode="edge")
        plane = plane.reshape(plane.shape[0] // fy, fy, plane.shape[1] // fx, fx).mean(axis=(1, 3))
        cw, chh = -(-w * ch // hmax), -(-h * cv // vmax)
        plane = np.clip(np.round(plane[:chh, :cw]), 0, 255)
        tq = 0 if c == 0 or not ycbcr else 1
        q = _quant_table(_LUMA_Q if tq == 0 else _CHROMA_Q, quality)
        out.append((c + 1, ch, cv, tq, _dct_blocks(plane, mcuy * cv, mcux * ch, q), q, (chh, cw)))
    return out, (mcux, mcuy)


class _ArithScan:
    """One scan's arithmetic coding (jcarith.c's encode_mcu family)."""

    def __init__(self, qm: _QmEncoder, dac: dict):
        self.qm = qm
        self.dac = dac
        self.dc_stats = [bytearray(64) for _ in range(16)]
        self.ac_stats = [bytearray(256) for _ in range(16)]
        self.fixed = bytearray([113])

    def dc_value(self, comp: dict, v: int):
        stats = self.dc_stats[comp["td"]]
        st = comp["context"]
        if v == 0:
            self.qm.encode(stats, st, 0)
            comp["context"] = 0
            return
        self.qm.encode(stats, st, 1)
        if v > 0:
            self.qm.encode(stats, st + 1, 0)
            st += 2
            comp["context"] = 4
        else:
            v = -v
            self.qm.encode(stats, st + 1, 1)
            st += 3
            comp["context"] = 8
        m = 0
        v -= 1
        if v:
            self.qm.encode(stats, st, 1)
            m = 1
            v2 = v
            st = 20
            while v2 >> 1:
                v2 >>= 1
                self.qm.encode(stats, st, 1)
                m <<= 1
                st += 1
        self.qm.encode(stats, st, 0)
        low, high = self.dac.get(("dc", comp["td"]), (0, 1))
        if m < (1 << low) >> 1:
            comp["context"] = 0
        elif m > (1 << high) >> 1:
            comp["context"] += 8
        st += 14
        while m >> 1:
            m >>= 1
            self.qm.encode(stats, st, 1 if m & v else 0)

    def ac_value(self, comp: dict, st: int, k: int, v: int):
        stats = self.ac_stats[comp["ta"]]
        self.qm.encode(self.fixed, 0, 0 if v > 0 else 1)
        v = abs(v)
        st += 2
        m = 0
        v -= 1
        if v:
            self.qm.encode(stats, st, 1)
            m = 1
            v2 = v >> 1
            if v2:
                self.qm.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= self.dac.get(("ac", comp["ta"]), 5) else 217
                while v2 >> 1:
                    v2 >>= 1
                    self.qm.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        self.qm.encode(stats, st, 0)
        st += 14
        while m >> 1:
            m >>= 1
            self.qm.encode(stats, st, 1 if m & v else 0)

    def ac_first(self, comp: dict, coefs: list[int], ss: int, se: int):
        """coefs: the band's values (point transform applied) at ss..se."""
        stats = self.ac_stats[comp["ta"]]
        ke = max((k for k in range(ss, se + 1) if coefs[k - ss]), default=ss - 1)
        k = ss - 1
        while k < ke:
            st = 3 * k
            self.qm.encode(stats, st, 0)
            while True:
                k += 1
                if coefs[k - ss]:
                    self.qm.encode(stats, st + 1, 1)
                    break
                self.qm.encode(stats, st + 1, 0)
                st += 3
            self.ac_value(comp, st, k, coefs[k - ss])
        if k < se:
            self.qm.encode(stats, 3 * k, 1)

    def ac_refine(self, comp: dict, block: np.ndarray, ss: int, se: int, al: int):
        stats = self.ac_stats[comp["ta"]]
        mags = [abs(int(block[ZIGZAG[k]])) >> al for k in range(64)]
        ke = max((k for k in range(ss, se + 1) if mags[k]), default=ss - 1)
        kex = max((k for k in range(ss, ke + 1) if mags[k] >> 1), default=0)
        k = ss - 1
        while k < ke:
            st = 3 * k
            if k >= kex:
                self.qm.encode(stats, st, 0)
            while True:
                k += 1
                v = mags[k]
                if v:
                    if v >> 1:
                        self.qm.encode(stats, st + 2, v & 1)
                    else:
                        self.qm.encode(stats, st + 1, 1)
                        self.qm.encode(self.fixed, 0, 1 if block[ZIGZAG[k]] < 0 else 0)
                    break
                self.qm.encode(stats, st + 1, 0)
                st += 3
        if k < se:
            self.qm.encode(stats, 3 * k, 1)


def jpeg_arithmetic(pixels: np.ndarray, quality: int = 80, sampling: list[tuple[int, int]] | None = None,
                    progressive: bool = False, restart: int = 0, dac: dict | None = None,
                    script: list[tuple] | None = None, jfif: bool = True) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with ``progressive``) of
    ``pixels`` ([h, w] gray or [h, w, 3] RGB, stored as YCbCr). ``dac``
    maps ("dc", table) to (L, U) and ("ac", table) to Kx (DAC segments);
    ``restart`` is the interval in MCUs; ``script`` the progressive scans
    as (component indexes, Ss, Se, Ah, Al)."""
    n = 1 if pixels.ndim == 2 else pixels.shape[2]
    sampling = sampling or ([(2, 2), (1, 1), (1, 1)] if n == 3 else [(1, 1)] * n)
    comps, (mcux, mcuy) = _jpeg_components(pixels, sampling, quality, ycbcr=True)
    dac = dac or {}
    h, w = pixels.shape[:2]
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq in sorted({c[3] for c in comps}):
        q = next(c[5] for c in comps if c[3] == tq)
        out += _segment(0xDB, bytes([tq]) + bytes(int(q[ZIGZAG[k]]) for k in range(64)))
    sof = struct.pack(">BHHB", 8, h, w, n) + b"".join(bytes([cid, ch << 4 | cv, tq]) for cid, ch, cv, tq, *_ in comps)
    out += _segment(0xCA if progressive else 0xC9, sof)
    if dac:
        body = b""
        for (kind, table), value in sorted(dac.items()):
            body += bytes([(0 if kind == "dc" else 16) + table, value[0] | value[1] << 4 if kind == "dc" else value])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if not progressive:
        script = [(tuple(range(n)), 0, 63, 0, 0)]
    elif script is None:
        script = [(tuple(range(n)), 0, 0, 0, 1)] + [((c,), 1, 5, 0, 2) for c in range(n)] + \
                 [((c,), 6, 63, 0, 2) for c in range(n)] + [((c,), 1, 63, 2, 1) for c in range(n)] + \
                 [(tuple(range(n)), 0, 0, 1, 0)] + [((c,), 1, 63, 1, 0) for c in range(n)]
    for members, ss, se, ah, al in script:
        tables = {c: (0 if c == 0 else 1) for c in members}
        out += _segment(0xDA, bytes([len(members)]) + b"".join(bytes([comps[c][0], tables[c] << 4 | tables[c]])
                                                                  for c in members) + bytes([ss, se, ah << 4 | al]))
        out += _arith_scan(comps, members, tables, (mcux, mcuy), progressive, ss, se, ah, al, restart, dac)
    out += b"\xff\xd9"
    return bytes(out)


def _arith_scan(comps, members, tables, mcus, progressive, ss, se, ah, al, restart, dac) -> bytes:
    qm = _QmEncoder()
    coder = _ArithScan(qm, dac)
    state = {c: {"td": tables[c], "ta": tables[c], "context": 0, "last": 0} for c in members}
    if len(members) == 1:
        _, ch, cv, _, blocks, _, (chh, cw) = comps[members[0]]
        units = [[(members[0], by, bx)] for by in range(-(-chh // 8)) for bx in range(-(-cw // 8))]
    else:
        mcux, mcuy = mcus
        units = [[(c, my * comps[c][2] + v, mx * comps[c][1] + hh) for c in members for v in range(comps[c][2])
                  for hh in range(comps[c][1])] for my in range(mcuy) for mx in range(mcux)]
    out = bytearray()
    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            qm.finish()
            out += qm.out + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            qm.out = bytearray()
            for c in members:
                s = state[c]
                if not progressive or (ss == 0 and ah == 0):
                    coder.dc_stats[s["td"]][:] = bytes(64)
                    s["last"], s["context"] = 0, 0
                if not progressive or se:
                    coder.ac_stats[s["ta"]][:] = bytes(256)
        for c, by, bx in unit:
            block = comps[c][4][by, bx]
            s = state[c]
            if ss == 0 and (not progressive or ah == 0):
                dc = int(block[0]) >> al
                coder.dc_value(s, dc - s["last"])
                s["last"] = dc
            elif ss == 0:
                qm.encode(coder.fixed, 0, (int(block[0]) >> al) & 1)
            if progressive and ss == 0:
                continue
            lo = max(ss, 1)
            if ah:
                coder.ac_refine(s, block, lo, se, al)
            else:
                band = [int(np.sign(block[ZIGZAG[k]])) * (abs(int(block[ZIGZAG[k]])) >> al) for k in range(lo, se + 1)]
                coder.ac_first(s, band, lo, se)
    qm.finish()
    return bytes(out + qm.out)


# lossless Huffman code lengths of the 17 difference categories (Kraft sum below 1)
_LOSSLESS_LENGTHS = (3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)


def _canonical(lengths) -> tuple[bytes, dict]:
    """A DHT's counts and symbols, and symbol -> (code, length), for
    symbols 0.. with the given code lengths."""
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    counts = [0] * 16
    for s in order:
        counts[lengths[s] - 1] += 1
    codes, code, prev = {}, 0, lengths[order[0]]
    for s in order:
        code <<= lengths[s] - prev
        prev = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    return bytes(counts) + bytes(order), codes


def jpeg_lossless(pixels: np.ndarray, predictor: int = 1, point_transform: int = 0, restart_rows: int = 0,
                  interleaved: bool = True, ids: tuple[int, ...] | None = None, jfif: bool = False,
                  sampling: list[tuple[int, int]] | None = None) -> bytes:
    """A lossless JPEG (SOF3, Huffman) of ``pixels`` ([h, w] or [h, w, n]
    uint8, stored as they are), predictor 1-7 and point transform Pt;
    ``restart_rows`` MCU rows a restart interval; one scan, or one scan a
    component without ``interleaved``; ``sampling`` (h, v) factors a
    component (a subsampled component keeps every h-th, v-th sample)."""
    samples = pixels[..., None] if pixels.ndim == 2 else pixels
    h, w, n = samples.shape
    ids = ids or tuple(range(1, n + 1))
    sampling = sampling or [(1, 1)] * n
    hmax, vmax = max(f[0] for f in sampling), max(f[1] for f in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    planes = []
    for c, (ch, cv) in enumerate(sampling):
        plane = samples[::vmax // cv, ::hmax // ch, c].astype(np.int64) >> point_transform
        cw, chh = -(-w * ch // hmax), -(-h * cv // vmax)
        plane = plane[:chh, :cw]
        if interleaved:  # padded out to whole MCUs, the edge repeated
            plane = np.pad(plane, ((0, mcuy * cv - chh), (0, mcux * ch - cw)), mode="edge")
        planes.append(plane)
    table, codes = _canonical(_LOSSLESS_LENGTHS)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xC3, struct.pack(">BHHB", 8, h, w, n)
                    + b"".join(bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], 0]) for c in range(n)))
    out += _segment(0xC4, b"\x00" + table)
    groups = [tuple(range(n))] if interleaved else [(c,) for c in range(n)]
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * (mcux if interleaved else planes[0].shape[1])))
    for members in groups:
        out += _segment(0xDA, bytes([len(members)]) + b"".join(bytes([ids[c], 0]) for c in members)
                        + bytes([predictor, 0, point_transform]))
        bits: list[str] = []
        pieces = bytearray()

        def flush():
            text = "".join(bits)
            text += "1" * (-len(text) % 8)
            for k in range(0, len(text), 8):
                byte = int(text[k:k + 8], 2)
                pieces.append(byte)
                if byte == 0xFF:
                    pieces.append(0)
            bits.clear()

        def diff(c: int, y: int, x: int, first: bool) -> None:
            p = planes[c]
            if first:
                pred = (1 << (7 - point_transform)) if x == 0 else p[y, x - 1]
            elif x == 0:
                pred = p[y - 1, 0]
            else:
                ra, rb, rc = int(p[y, x - 1]), int(p[y - 1, x]), int(p[y - 1, x - 1])
                pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                        (ra + rb) >> 1)[predictor - 1]
            d = (int(p[y, x]) - int(pred)) & 0xFFFF
            d = d - 65536 if d >= 32768 else d
            s = abs(d).bit_length()
            code, length = codes[s]
            bits.append(format(code, f"0{length}b"))
            if 0 < s < 16:
                bits.append(format(d if d >= 0 else d - 1 + (1 << s), f"0{s}b")[-s:])

        if len(members) == 1:
            rows, (cv,) = planes[members[0]].shape[0], (1,)
            row_units = [[(members[0], y, x) for x in range(planes[members[0]].shape[1])] for y in range(rows)]
        else:
            row_units = []
            for my in range(mcuy):
                units = []
                for mx in range(mcux):
                    for c in members:
                        ch, cv = sampling[c]
                        units += [(c, my * cv + v, mx * ch + hh) for v in range(cv) for hh in range(ch)]
                row_units.append(units)
        # a sample row's first one after a restart is predicted as the first row
        first_rows: dict[int, set] = {c: {0} for c in members}
        for r, units in enumerate(row_units):
            if restart_rows and r and r % restart_rows == 0:
                flush()
                pieces.extend(bytes([0xFF, 0xD0 + (r // restart_rows - 1) % 8]))
                for c in members:
                    first_rows[c].add(r * (sampling[c][1] if len(members) > 1 else 1))
            for c, y, x in units:
                diff(c, y, x, y in first_rows[c])
        flush()
        out += pieces
    out += b"\xff\xd9"
    return bytes(out)


def jpeg_header_only(marker: int, precision: int = 8, size: tuple[int, int] = (16, 16), components: int = 1) -> bytes:
    """A JPEG whose frame header is ``marker`` (a SOF type) at ``precision``
    bits, with tables and a scan of zeros: enough for a decoder to refuse
    it or not (hierarchical, 12-bit, lossless arithmetic frames)."""
    w, h = size
    out = bytearray(b"\xff\xd8")
    out += _segment(0xDB, bytes([0]) + bytes([1] * 64))
    out += _segment(marker, struct.pack(">BHHB", precision, h, w, components)
                    + b"".join(bytes([i + 1, 0x11, 0]) for i in range(components)))
    table, _ = _canonical(_LOSSLESS_LENGTHS)
    out += _segment(0xC4, b"\x00" + table) + _segment(0xC4, b"\x10" + table)
    out += _segment(0xDA, bytes([components]) + b"".join(bytes([i + 1, 0]) for i in range(components))
                    + bytes([0, 63, 0]))
    out += b"\x00" * 64 + b"\xff\xd9"
    return bytes(out)
