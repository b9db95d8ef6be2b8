"""BMP without PIL: every bitmap Pillow's BMP plugin reads, into
``[H, W, 3]`` uint8 as ``Image.open(...).convert("RGB")`` gives it.

- Headers: OS/2 ``BITMAPCOREHEADER`` (12 bytes: unsigned sizes, bottom-up,
  3-byte palette entries) and the Windows and OS/2 2.x headers of 40, 52,
  56, 64, 108 and 124 bytes (a negative height is top-down).
- Uncompressed 1-, 4- and 8-bit palette bitmaps (a palette that is the
  gray ramp, or black and white at 1 bit, reads as gray; a palette index
  past the table is black), 16-bit 5-5-5, 24-bit and 32-bit (fourth byte
  dropped).
- ``BI_BITFIELDS``: Pillow's layouts only, 16-bit 5-6-5 and 5-5-5, 24-bit
  B-G-R, 32-bit byte-aligned masks; 5- and 6-bit samples widen as Pillow
  widens them (``v * 255 // 31``, ``v * 255 // 63``).
- RLE8 and RLE4 (8- and 4-bit palettes) decoded as Pillow's
  ``BmpRleDecoder`` decodes them: runs clipped at the row's end, absolute
  runs not, escapes 0 (end of line: the row filled with index 0), 1 (end
  of bitmap), 2 (delta: Pillow reads two bytes it drops, then right and
  up, and fills the pixels skipped with index 0), absolute runs padded to
  an even file offset, an RLE4 absolute run of odd length losing its last
  pixel. A stream that ends before the bitmap is full raises, as in
  Pillow.
"""

import struct

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_MASKS16 = {(0xF800, 0x7E0, 0x1F): (11, 6, 5), (0x7C00, 0x3E0, 0x1F): (10, 5, 5)}
# Pillow's 32-bit layouts (R, G, B, A masks); all zero reads as B, G, R, A
_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0), (0xFF000000, 0xFF00, 0xFF, 0),
            (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)}


def read_header(data: bytes) -> tuple[int, int, int, int, int]:
    """(width, height, bits per pixel, compression, pixel data offset); a
    negative height marks a top-down bitmap."""
    if data[:2] != b"BM" or len(data) < 26:
        raise InvalidDocumentError("Not a BMP image")
    (offset, header_size) = struct.unpack_from("<II", data, 10)
    if header_size not in _HEADERS:
        raise InvalidDocumentError(f"Unsupported BMP header type ({header_size})")
    if len(data) < 14 + header_size:
        raise InvalidDocumentError("BMP header is truncated")
    if header_size == 12:  # OS/2 BITMAPCOREHEADER
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        return w, h, bpp, _RAW, offset
    w, h, _, bpp, compression = struct.unpack_from("<IiHHI", data, 18)
    return w, h, bpp, compression, offset


def _palette(data: bytes, header_size: int, colours: int) -> tuple[np.ndarray, bool]:
    """The colour table as [256, 3] RGB (zeros past it), read as Pillow
    reads it (``colours`` entries from the header's end, whatever the pixel
    offset), and whether Pillow reads the bitmap as gray (mode "1" or "L")."""
    entry = 3 if header_size == 12 else 4
    start = 14 + header_size
    raw = data[start:start + entry * colours]
    whole = len(raw) // entry
    table = np.frombuffer(raw, dtype=np.uint8, count=whole * entry).reshape(whole, entry)[:, 2::-1]
    ramp = np.array([0, 255] if colours == 2 else np.arange(colours) % 256, dtype=np.uint8)
    gray = len(raw) == entry * colours and bool((table == ramp[:, None]).all())
    out = np.zeros((256, 3), dtype=np.uint8)
    out[: min(whole, 256)] = table[:256]
    return out, gray


def _rle(data: bytes, start: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder: the indexes in file row order."""
    size = w * h
    out = bytearray()
    x = 0
    pos, n = start, len(data)
    while len(out) < size:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run
            count = max(0, w - x) if x + count > w else count
            if rle4:
                out += bytes([byte >> 4, byte & 15]) * (count // 2) + (bytes([byte >> 4]) if count % 2 else b"")
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta, after two bytes Pillow reads and drops
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise InvalidDocumentError("BMP RLE delta is truncated")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # an absolute run of ``byte`` pixels
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += len(chunk)
            if rle4:
                pairs = np.frombuffer(chunk, dtype=np.uint8)
                out += np.stack([pairs >> 4, pairs & 15], 1).tobytes()
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            pos += pos % 2  # runs end on an even file offset
    if len(out) < size:  # Pillow: "not enough image data"
        raise InvalidDocumentError("BMP RLE data ends before the bitmap is full")
    out = out[:size]
    return np.frombuffer(bytes(out), dtype=np.uint8).reshape(h, w)


def _unpack(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Indexes of 1-, 4- or 8-bit rows, most significant bits first."""
    if bpp == 8:
        return rows[:, :w]
    shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(rows.shape[0], -1)[:, :w]


def decode_bmp(data: bytes) -> np.ndarray:
    w, h, bpp, compression, offset = read_header(data)
    (header_size,) = struct.unpack_from("<I", data, 14)
    top_down = h < 0
    height = abs(h)
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise InvalidDocumentError(f"Unsupported BMP pixel depth ({bpp})")
    if compression not in (_RAW, _RLE8, _RLE4, _BITFIELDS):
        raise InvalidDocumentError(f"Unsupported BMP compression ({compression})")
    if w <= 0 or height == 0:
        raise InvalidDocumentError("BMP image has no pixels")
    if w * height > 178956970:  # Pillow's decompression-bomb limit
        raise InvalidDocumentError("BMP image is too large")
    colours = 0
    if bpp <= 8:
        colours = (struct.unpack_from("<I", data, 46)[0] if header_size >= 40 else 0) or (1 << bpp)
        if not 0 < colours <= 65536:
            raise InvalidDocumentError(f"Unsupported BMP Palette size ({colours})")
        if offset == 14 + header_size:  # Pillow's reading of an offset that leaves out the table
            offset += 4 * colours
    masks = None
    if compression == _BITFIELDS:
        masks = struct.unpack_from("<III", data, 54)
        alpha = struct.unpack_from("<I", data, 66)[0] if header_size >= 56 else 0
        if not ((bpp == 32 and masks + (alpha,) in _MASKS32) or (bpp == 24 and masks == (0xFF0000, 0xFF00, 0xFF)) or (bpp == 16 and masks in _MASKS16)):
            raise InvalidDocumentError("Unsupported BMP bitfields layout")
    if compression in (_RLE8, _RLE4):
        if bpp > 8:
            raise InvalidDocumentError(f"BMP RLE needs a palette, not {bpp} bits a pixel")
        indexes = _rle(data, offset, w, height, compression == _RLE4)
    else:
        stride = ((w * bpp + 31) >> 3) & ~3
        if len(data) < offset + stride * height:
            raise InvalidDocumentError("BMP pixel data is truncated")
        rows = np.frombuffer(data, dtype=np.uint8, count=stride * height, offset=offset).reshape(height, stride)
        if bpp > 8:
            if not top_down:
                rows = rows[::-1]
            return _true_colour(rows, w, bpp, masks)
        indexes = _unpack(rows, w, bpp)
    if not top_down:
        indexes = indexes[::-1]
    table, gray = _palette(data, header_size, colours)
    if gray:  # mode "1" or "L": the sample is the gray level
        if bpp == 1:
            level = indexes * np.uint8(255)
        else:
            level = indexes
        return np.repeat(np.ascontiguousarray(level)[:, :, None], 3, axis=2)
    return table[indexes]


def _true_colour(rows: np.ndarray, w: int, bpp: int, masks) -> np.ndarray:
    if bpp == 16:
        pixel = rows[:, : 2 * w].copy().view("<u2").astype(np.uint32)
        red_shift, green_bits, red_bits = _MASKS16.get(masks, (10, 5, 5))
        red = (pixel >> red_shift) & ((1 << red_bits) - 1)
        green = (pixel >> 5) & ((1 << green_bits) - 1)
        blue = pixel & 31
        return np.stack([red * 255 // ((1 << red_bits) - 1), green * 255 // ((1 << green_bits) - 1),
                         blue * 255 // 31], axis=-1).astype(np.uint8)
    pixels = rows[:, : w * bpp // 8].reshape(rows.shape[0], w, bpp // 8)
    order = [2, 1, 0]
    if masks is not None and bpp == 32 and any(masks):
        order = [m.bit_length() // 8 - 1 for m in masks]  # the byte each 8-bit mask selects
    return np.ascontiguousarray(pixels[:, :, order])
