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
