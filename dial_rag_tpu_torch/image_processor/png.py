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
from dataclasses import dataclass

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


def _check_header(w: int, h: int, depth: int, color: int, interlace: int) -> None:
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or interlace not in (0, 1):
        raise InvalidDocumentError(f"PNG colour type {color} at bit depth {depth} is not defined")
    if w * h > 178956970:  # Pillow's decompression-bomb limit
        raise InvalidDocumentError("PNG image is too large")


def _inflate(parts: list[bytes]) -> bytes:
    try:
        return zlib.decompress(b"".join(parts))
    except zlib.error as e:
        raise InvalidDocumentError(f"PNG image data is corrupt: {e}") from e


def _image_samples(raw: bytes, w: int, h: int, depth: int, color: int, interlace: int) -> np.ndarray:
    """The [h, w, channels] samples of one image's inflated data."""
    channels = _CHANNELS[color]
    if not interlace:
        return _samples(raw, h, w, depth, channels)[0]
    # Adam7: seven passes, each a reduced image of its own scanlines and filters
    samples = np.zeros((h, w, channels), dtype=np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw and ph:
            part, used = _samples(raw[at:], ph, pw, depth, channels)
            samples[y0::dy, x0::dx] = part
            at += used
    return samples


def _mode_samples(samples: np.ndarray, depth: int, color: int) -> np.ndarray:
    """Samples as Pillow holds them in the image's mode: gray at 1, 2 and 4
    bits scaled to 0-255 (modes "1" and "L"), 16-bit gray kept (I;16),
    other 16-bit samples by their high byte (16-bit gray + alpha as RGBA),
    palette indexes as they are."""
    if color == 3:
        return samples[..., :1].astype(np.uint8)
    if color == 0 and depth < 8:
        return (samples.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    if depth == 16:
        if color == 0:
            return samples
        samples = (samples >> 8).astype(np.uint8)
        if color == 4:
            return np.concatenate([np.repeat(samples[..., :1], 3, axis=2), samples[..., 1:]], axis=2)
    return samples


def _mode_rgb(image: np.ndarray, depth: int, color: int, palette) -> np.ndarray:
    """``convert("RGB")`` of an image in its mode: alpha is dropped, not
    composited; 16-bit gray (I;16) is clipped to 255; a palette image takes
    its PLTE colours."""
    if color == 3:
        return _palette_rgb(image[..., 0], palette)
    if color == 0 and depth == 16:
        return np.repeat(np.minimum(image, 255).astype(np.uint8), 3, axis=2)
    if image.shape[2] <= 2:
        return np.repeat(image[..., :1], 3, axis=2)
    return image[..., :3].copy()


def decode_png(data: bytes) -> np.ndarray:
    """The RGB pixels ([H, W, 3] uint8) of a PNG, as Pillow's
    ``convert("RGB")`` gives them (an animated PNG's first page)."""
    return decode_png_frames(data, [1])[0]


@dataclass
class _Frame:
    x0: int
    y0: int
    width: int
    height: int
    dispose: int | None  # fcTL dispose op: 0 none, 1 background, 2 previous; None for the default image
    blend: int | None  # fcTL blend op: 0 source, 1 over
    parts: list


def read_apng(data: bytes) -> tuple[int | None, list[_Frame], bytes | None, bytes | None]:
    """(acTL's frame count or None, frames, PLTE, tRNS) of a PNG, as Pillow
    reads them: without a valid acTL before the first IDAT the PNG is one
    frame; with one, an IDAT that no fcTL precedes is a default image and a
    frame of its own, and every fcTL with its fdAT chunks a frame."""
    w, h, _, _, _ = read_header(data)
    n_frames = None
    actl_seen = False
    palette = trns = None
    frames: list[_Frame] = []
    control = None
    in_idat = False
    for tag, payload in _chunks(data):
        if tag == b"acTL" and not frames and not in_idat:
            if len(payload) < 8:
                raise InvalidDocumentError("APNG contains a truncated acTL chunk")
            count = struct.unpack_from(">I", payload)[0]
            n_frames = None if actl_seen or count == 0 or count > 0x80000000 else count
            actl_seen = True
        elif tag == b"PLTE" and palette is None:
            palette = payload
        elif tag == b"tRNS" and trns is None:
            trns = payload
        elif tag == b"fcTL":
            if len(payload) < 26:
                raise InvalidDocumentError("APNG contains a truncated fcTL chunk")
            fw, fh, x0, y0 = struct.unpack_from(">IIII", payload, 4)
            if x0 + fw > w or y0 + fh > h:
                raise InvalidDocumentError("APNG contains invalid frames")
            control = _Frame(x0, y0, fw, fh, payload[24], payload[25], [])
        elif tag == b"IDAT":
            if not in_idat:
                in_idat = True
                frames.append(control or _Frame(0, 0, w, h, None, None, []))
                control = None
            frames[-1].parts.append(payload)
        elif tag == b"fdAT" and control is not None:
            frames.append(control)
            control = None
            frames[-1].parts.append(payload[4:])
        elif tag == b"fdAT" and frames:
            frames[-1].parts.append(payload[4:])
    if not frames:
        raise InvalidDocumentError("PNG image has no image data")
    if n_frames is None:
        del frames[1:]
    return n_frames, frames, palette, trns


def frame_count(data: bytes) -> int:
    """Pillow's ``n_frames``: acTL's count, one more where the IDAT image
    is a default image outside the animation."""
    n_frames, frames, _, _ = read_apng(data)
    if n_frames is None:
        return 1
    return n_frames + (frames[0].dispose is None)


def _mask(region: np.ndarray, color: int, depth: int, trns: bytes | None) -> np.ndarray:
    """The [h, w, 1] alpha Pillow pastes an OVER frame with (its
    ``convert("RGBA")``, or the RGB transparent colour, or the palette's
    tRNS alphas)."""
    if color in (4, 6):
        return region[..., -1:]
    alpha = np.full(region.shape[:2] + (1,), 255, dtype=np.uint8)
    if color == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]))
        alpha[(region[..., :3] == key).all(axis=2)] = 0
    elif color == 3 and trns:
        table = np.full(256, 255, dtype=np.uint8)
        table[: len(trns)] = np.frombuffer(trns[:256], dtype=np.uint8)
        alpha[..., 0] = table[region[..., 0]]
    return alpha


def decode_png_frames(data: bytes, numbers: list[int] | None = None) -> list[np.ndarray]:
    """The RGB pages of a PNG, frame ``numbers`` (1-based; every frame if
    None) in that order, composited as Pillow's APNG reader composites them:
    a frame's pixels replace its region, or with blend op 1 are pasted over
    the canvas through their alpha (each sample ``DIV255(old * (255 - a) +
    new * a)``); a frame's dispose op applies before the next frame (1: its
    region cleared to zeros, 2: restored; 2 on the first frame acts as 1);
    the first frame after a default image is drawn on that image."""
    w, h, depth, color, interlace = read_header(data)
    _check_header(w, h, depth, color, interlace)
    count = frame_count(data)
    numbers = numbers or list(range(1, count + 1))
    for number in numbers:
        if not 1 <= number <= count:
            raise InvalidDocumentError(f"page {number} out of range 1..{count}")
    _, frames, palette_raw, trns = read_apng(data)
    if max(numbers) > len(frames):
        raise InvalidDocumentError("No more images in APNG file")
    palette = None
    if palette_raw is not None:
        palette = np.frombuffer(palette_raw, dtype=np.uint8)[: len(palette_raw) // 3 * 3].reshape(-1, 3)
    channels = {0: 1, 2: 3, 3: 1, 4: 2 if depth == 8 else 4, 6: 4}[color]
    canvas = np.zeros((h, w, channels), dtype=np.uint16 if (depth, color) == (16, 0) else np.uint8)
    pages: dict[int, np.ndarray] = {}
    dispose = None  # (region, pixels) the previous frame leaves behind
    for k, f in enumerate(frames[: max(numbers)]):
        rows, cols = slice(f.y0, f.y0 + f.height), slice(f.x0, f.x0 + f.width)
        previous = None
        if k > 0:
            if dispose is not None:
                canvas[dispose[0]] = dispose[1]
            previous = canvas.copy()
        op = f.dispose
        if previous is None and op == 2:
            op = 1
        dispose = None
        if op == 2:
            dispose = ((rows, cols), previous[rows, cols].copy())
        elif op == 1:
            dispose = ((rows, cols), 0)
        raw = _inflate(f.parts)
        drawn = _mode_samples(_image_samples(raw, f.width, f.height, depth, color, interlace), depth, color)
        canvas[rows, cols] = drawn
        if previous is not None and f.blend == 1:
            if (depth, color) == (16, 0):  # Pillow cannot make the I;16 frame's mask
                raise InvalidDocumentError("APNG frames of 16-bit gray cannot blend over")
            a = _mask(drawn, color, depth, trns).astype(np.int64)
            t = previous[rows, cols].astype(np.int64) * (255 - a) + drawn.astype(np.int64) * a + 128
            canvas = previous
            canvas[rows, cols] = (((t >> 8) + t) >> 8).astype(canvas.dtype)
        if k + 1 in numbers:
            pages[k + 1] = _mode_rgb(canvas, depth, color, palette)
    return [pages[n] for n in numbers]


def _palette_rgb(indexes: np.ndarray, palette) -> np.ndarray:
    if palette is None:
        raise InvalidDocumentError("PNG palette image without a PLTE chunk")
    table = np.zeros((256, 3), dtype=np.uint8)
    table[: len(palette)] = palette
    return table[indexes]
