"""BMP without PIL: uncompressed 24- and 32-bit and 8-bit palette
bitmaps (BI_RGB, and BI_BITFIELDS with byte-aligned masks), bottom-up or
top-down, read into ``[H, W, 3]`` uint8 as ``Image.open(...).convert(
"RGB")`` gives them (a 32-bit bitmap's fourth byte is dropped). RLE
compression raises ``NotPortedError`` (ROADMAP item 9d)."""

import struct

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError

_RLE = {1: "RLE8", 2: "RLE4"}


def read_header(data: bytes) -> tuple[int, int, int, int, int]:
    """(width, height, bits per pixel, compression, pixel data offset); a
    negative height marks a top-down bitmap."""
    if data[:2] != b"BM" or len(data) < 30:
        raise InvalidDocumentError("Not a BMP image")
    (offset,) = struct.unpack_from("<I", data, 10)
    (header_size,) = struct.unpack_from("<I", data, 14)
    if header_size == 12:  # OS/2 BITMAPCOREHEADER
        w, h, _, bpp = struct.unpack_from("<HhHH", data, 18)
        return w, h, bpp, 0, offset
    w, h, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    return w, h, bpp, compression, offset


def decode_bmp(data: bytes) -> np.ndarray:
    w, h, bpp, compression, offset = read_header(data)
    if compression in _RLE:
        raise NotPortedError(f"{_RLE[compression]}-compressed BMP images are not ported yet (ROADMAP item 9d)")
    if compression not in (0, 3) or bpp not in (8, 24, 32) or w <= 0 or h == 0:
        raise InvalidDocumentError(f"BMP images of {bpp} bits with compression {compression} are not supported")
    (header_size,) = struct.unpack_from("<I", data, 14)
    height = abs(h)
    stride = (w * bpp + 31) // 32 * 4
    if len(data) < offset + stride * height:
        raise InvalidDocumentError("BMP pixel data is truncated")
    rows = np.frombuffer(data, dtype=np.uint8, count=stride * height, offset=offset).reshape(height, stride)
    if h > 0:
        rows = rows[::-1]
    if bpp == 8:
        entry = 3 if header_size == 12 else 4
        (used,) = (struct.unpack_from("<I", data, 46) if header_size >= 40 else (0,))
        count = used or 256
        start = 14 + header_size
        table = np.zeros((256, 3), dtype=np.uint8)
        colours = np.frombuffer(data, dtype=np.uint8, count=min(count, (offset - start) // entry) * entry,
                                offset=start).reshape(-1, entry)
        table[: len(colours)] = colours[:, 2::-1]  # stored as B, G, R
        return table[rows[:, :w]]
    pixels = rows[:, : w * bpp // 8].reshape(height, w, bpp // 8)
    order = [2, 1, 0]
    if compression == 3:
        masks = struct.unpack_from("<III", data, 54)
        order = [_mask_byte(m) for m in masks]
    return np.ascontiguousarray(pixels[:, :, order])


def _mask_byte(mask: int) -> int:
    for byte in range(4):
        if mask == 0xFF << (8 * byte):
            return byte
    raise InvalidDocumentError(f"BMP channel mask {mask:#x} is not byte-aligned")
