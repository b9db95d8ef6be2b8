"""PNG without PIL: the page images the service sends, and the PNG
documents it reads, on the standard library's ``zlib`` and numpy.

``encode_png`` writes an ``[H, W, 3]`` uint8 array as 8-bit RGB, every
row Up-filtered (the difference from the row above: one vectorised pass,
and a page image's white margins and repeated rows deflate to almost
nothing), deflated at zlib level 6. Per-row choice among the filters, as
Pillow makes it, costs more than the deflate itself on a page image and
saves about 5 per cent of the bytes.

``decode_png`` reads every PNG of the specification (gray
1/2/4/8/16-bit, gray + alpha, RGB and RGBA 8/16-bit, palette 1/2/4/8-bit,
all five filters) into ``[H, W, 3]`` uint8 as ``Image.open(...).convert(
"RGB")`` gives it: 16-bit samples keep their high byte, but 16-bit gray,
which Pillow opens as ``I;16`` and clips to 255; low bit depths of gray
are scaled to 0-255; alpha is dropped, not composited; a palette image
takes its ``PLTE`` colours. Adam7-interlaced images read their seven
passes, each unfiltered on its own, into place.
"""

import struct
import zlib

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """``image`` ([H, W, 3] uint8) as PNG bytes."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, not {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = image.reshape(h, w * 3)
    filtered = np.empty((h, w * 3 + 1), dtype=np.uint8)
    filtered[:, 0] = 2  # Up
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_header(data: bytes) -> tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of a PNG."""
    if not data.startswith(SIGNATURE) or data[12:16] != b"IHDR" or len(data) < 29:
        raise InvalidDocumentError("Not a PNG image")
    w, h, depth, color, _, _, interlace = struct.unpack_from(">IIBBBBB", data, 16)
    return w, h, depth, color, interlace


def _chunks(data: bytes):
    at = len(SIGNATURE)
    while at + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, at)
        tag = data[at + 4:at + 8]
        yield tag, data[at + 8:at + 8 + length]
        if tag == b"IEND":
            return
        at += 12 + length


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of ``raw`` ([h, 1 + stride] bytes, each led by its
    filter type) with their filters undone."""
    if len(raw) < h * (stride + 1):
        raise InvalidDocumentError("PNG image data is truncated")
    lines = np.frombuffer(raw, dtype=np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), dtype=np.uint8)  # row 0: the zero row above the image
    for y in range(h):
        kind = int(lines[y, 0])
        row = lines[y, 1:]
        prior = out[y]
        if kind == 0:
            out[y + 1] = row
        elif kind == 2:
            out[y + 1] = row + prior
        elif kind == 1:
            # x[i] = f[i] + x[i - bpp]: a running sum over each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, dtype=np.uint8)
            lanes[:stride] = row
            out[y + 1] = np.cumsum(lanes.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind in (3, 4):
            out[y + 1] = _unfilter_sequential(kind, row.tolist(), prior.tolist(), bpp)
        else:
            raise InvalidDocumentError(f"PNG row filter {kind} is not defined")
    return out[1:]


def _unfilter_sequential(kind: int, row: list, prior: list, bpp: int) -> list:
    """Average (3) and Paeth (4): each byte depends on the one ``bpp``
    before it through a non-linear step, so the row is undone in order."""
    x = [0] * len(row)
    for i, f in enumerate(row):
        a = x[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            x[i] = (f + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            x[i] = (f + pred) & 0xFF
    return x


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: bytes, h: int, w: int, depth: int, channels: int) -> tuple[np.ndarray, int]:
    """The [h, w, channels] samples (uint16 at 16 bits) of ``raw``'s first
    h filtered scanlines, and the bytes those took."""
    bits = depth * channels
    stride = (w * bits + 7) // 8
    rows = _unfilter(raw, h, stride, max(bits // 8, 1))
    if depth < 8:
        # unpack the samples, most significant bits first
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per_byte)[:, :w]
        return samples.reshape(h, w, 1), h * (stride + 1)
    if depth == 16:
        wide = rows.reshape(h, w, channels, 2).astype(np.uint16)
        return wide[..., 0] << 8 | wide[..., 1], h * (stride + 1)
    return rows.reshape(h, w, channels), h * (stride + 1)


def decode_png(data: bytes) -> np.ndarray:
    """The RGB pixels ([H, W, 3] uint8) of a PNG, as Pillow's
    ``convert("RGB")`` gives them."""
    w, h, depth, color, interlace = read_header(data)
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or interlace not in (0, 1):
        raise InvalidDocumentError(f"PNG colour type {color} at bit depth {depth} is not defined")
    if w * h > 178956970:  # Pillow's decompression-bomb limit
        raise InvalidDocumentError("PNG image is too large")
    channels = _CHANNELS[color]
    palette = None
    idat = []
    for tag, payload in _chunks(data):
        if tag == b"IDAT":
            idat.append(payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, dtype=np.uint8)[: len(payload) // 3 * 3].reshape(-1, 3)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise InvalidDocumentError(f"PNG image data is corrupt: {e}") from e
    if not interlace:
        samples, _ = _samples(raw, h, w, depth, channels)
    else:
        # Adam7: seven passes, each a reduced image of its own scanlines and filters
        samples = np.zeros((h, w, channels), dtype=np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
            if pw and ph:
                part, used = _samples(raw[at:], ph, pw, depth, channels)
                samples[y0::dy, x0::dx] = part
                at += used
    if color == 3:
        return _palette_rgb(samples[..., 0], palette)
    if depth < 8:  # gray at 1, 2 or 4 bits, scaled to 0-255
        gray = (samples[..., 0].astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return np.repeat(gray[:, :, None], 3, axis=2)
    if depth == 16:
        if color == 0:
            # Pillow opens 16-bit gray as I;16 and clips it to 8 bits
            gray = np.minimum(samples[..., 0], 255).astype(np.uint8)
            return np.repeat(gray[:, :, None], 3, axis=2)
        samples = (samples >> 8).astype(np.uint8)
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _palette_rgb(indexes: np.ndarray, palette) -> np.ndarray:
    if palette is None:
        raise InvalidDocumentError("PNG palette image without a PLTE chunk")
    table = np.zeros((256, 3), dtype=np.uint8)
    table[: len(palette)] = palette
    return table[indexes]
