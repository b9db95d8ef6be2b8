"""WebP documents without PIL: a WebP is a document of as many pages as it
has frames (Pillow's ``n_frames``: the ``ANMF`` chunks of an animation,
else one), each page ``[H, W, 3]`` uint8 as Pillow's WebP plugin gives it
after ``seek(n)`` and ``convert("RGB")``.

Pillow reads every WebP through libwebp's ``WebPAnimDecoder`` into RGBA
(not premultiplied), and ``convert("RGB")`` drops the alpha. This module
walks the RIFF container (simple ``VP8 `` and ``VP8L`` files, and the
extended ``VP8X`` layout with ``ALPH``, ``ANIM`` and ``ANMF``) and
composites the frames as that decoder does:

- each frame's bitstream is decoded by the host core ``native/webp.cpp``
  (VP8 lossy key frames with their ``ALPH`` plane, or VP8L lossless)
  straight into its rectangle of the canvas;
- a key frame (the first; a full-canvas frame that has no alpha or does
  not blend; or one after a frame disposed to background that was full
  or itself a key frame) starts from a canvas cleared to transparent
  black, whatever the ``ANIM`` background colour says; any other frame
  starts from the previous canvas with the previous frame's rectangle
  cleared if it was disposed to background;
- a blending frame then blends its pixels that are not opaque over that
  previous canvas with libwebp's non-premultiplied integer formula
  (``BlendPixelNonPremult``), except where the previous frame's disposed
  rectangle lies, which keeps the frame's own pixels.
"""

import ctypes
import struct
from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.native.build import load_native

_MAX_PIXELS = 178956970  # Pillow's decompression-bomb limit


def is_webp(data: bytes) -> bool:
    """As Pillow's WebP plugin accepts a file: RIFF, WEBP, then a VP8 chunk."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (b"VP8 ", b"VP8X", b"VP8L")


@dataclass
class Frame:
    x0: int
    y0: int
    width: int
    height: int
    blend: bool
    dispose_background: bool
    bitstream: bytes  # the VP8 or VP8L chunk's payload
    lossless: bool
    alpha: bytes | None  # the ALPH chunk's payload
    has_alpha: bool


def _chunks(data: bytes, start: int, end: int) -> list[tuple[bytes, bytes]]:
    out = []
    at = start
    while at + 8 <= end:
        tag = data[at:at + 4]
        (size,) = struct.unpack_from("<I", data, at + 4)
        if at + 8 + size > end:
            raise InvalidDocumentError("WebP chunk is truncated")
        out.append((tag, data[at + 8:at + 8 + size]))
        at += 8 + size + (size & 1)
    return out


def _bitstream_size(payload: bytes, lossless: bool) -> tuple[int, int, bool]:
    """(width, height, alpha bit) from a VP8 or VP8L bitstream's header."""
    info = (ctypes.c_int * 3)()
    lib = load_native("webp")
    status = (lib.dial_webp_vp8l_info if lossless else lib.dial_webp_vp8_info)(payload, len(payload), info)
    if status:
        raise InvalidDocumentError("WebP bitstream header is corrupt")
    return info[0], info[1], bool(info[2]) if lossless else False


def _frame(chunks: list[tuple[bytes, bytes]], x0: int, y0: int, blend: bool, dispose: bool) -> Frame:
    """A frame from its chunks: an optional ALPH, then VP8 or VP8L."""
    alpha = None
    for tag, payload in chunks:
        if tag == b"ALPH" and alpha is None:
            alpha = payload
        elif tag in (b"VP8 ", b"VP8L"):
            lossless = tag == b"VP8L"
            if lossless and alpha is not None:
                raise InvalidDocumentError("WebP frame has an ALPH chunk before a VP8L bitstream")
            w, h, alpha_bit = _bitstream_size(payload, lossless)
            return Frame(x0, y0, w, h, blend, dispose, payload, lossless, None if lossless else alpha,
                         alpha_bit if lossless else alpha is not None)
    raise InvalidDocumentError("WebP frame has no bitstream")


def _check_size(width: int, height: int) -> None:
    """Pillow's open refuses a canvas past its decompression-bomb limit,
    a simple file's as a VP8X file's."""
    if width * height > _MAX_PIXELS:
        raise InvalidDocumentError("WebP image is too large")


def read_webp(data: bytes) -> tuple[tuple[int, int], list[Frame]]:
    """((canvas width, height), frames) of a WebP, as libwebp's demuxer
    reads them."""
    if not is_webp(data):
        raise InvalidDocumentError("Not a WebP image")
    (riff_size,) = struct.unpack_from("<I", data, 4)
    end = min(len(data), 8 + riff_size)
    if 8 + riff_size > len(data):
        raise InvalidDocumentError("WebP file is truncated")
    chunks = _chunks(data, 12, end)
    if not chunks:
        raise InvalidDocumentError("WebP file has no chunk")
    first = chunks[0][0]
    if first != b"VP8X":
        frame = _frame(chunks[:1], 0, 0, True, False)
        _check_size(frame.width, frame.height)
        return (frame.width, frame.height), [frame]
    header = chunks[0][1]
    if len(header) < 10:
        raise InvalidDocumentError("WebP VP8X chunk is truncated")
    flags = header[0]
    cw = 1 + int.from_bytes(header[4:7], "little")
    ch = 1 + int.from_bytes(header[7:10], "little")
    _check_size(cw, ch)
    frames = []
    if flags & 0x02:  # animation
        for tag, payload in chunks[1:]:
            if tag != b"ANMF":
                continue
            if len(payload) < 16:
                raise InvalidDocumentError("WebP ANMF chunk is truncated")
            x0 = 2 * int.from_bytes(payload[0:3], "little")
            y0 = 2 * int.from_bytes(payload[3:6], "little")
            fw = 1 + int.from_bytes(payload[6:9], "little")
            fh = 1 + int.from_bytes(payload[9:12], "little")
            bits = payload[15]
            frame = _frame(_chunks(payload, 16, len(payload)), x0, y0, not bits & 0x02, bool(bits & 0x01))
            if (frame.width, frame.height) != (fw, fh) or x0 + fw > cw or y0 + fh > ch:
                raise InvalidDocumentError("WebP frame does not fit its canvas")
            frames.append(frame)
    else:
        frame = _frame([c for c in chunks[1:] if c[0] in (b"ALPH", b"VP8 ", b"VP8L")], 0, 0, True, False)
        if (frame.width, frame.height) != (cw, ch):
            raise InvalidDocumentError("WebP image does not match its canvas")
        frames.append(frame)
    if not frames:
        raise InvalidDocumentError("WebP image has no frame")
    return (cw, ch), frames


def frame_count(data: bytes) -> int:
    """Pillow's ``n_frames``."""
    return len(read_webp(data)[1])


def decode_frame(frame: Frame) -> np.ndarray:
    """The frame's RGBA pixels, [height, width, 4] uint8."""
    out = np.empty((frame.height, frame.width, 4), dtype=np.uint8)
    lib = load_native("webp")
    if frame.lossless:
        status = lib.dial_webp_vp8l_decode(frame.bitstream, len(frame.bitstream), out.ctypes.data, frame.width,
                                           frame.height)
    else:
        status = lib.dial_webp_vp8_decode(frame.bitstream, len(frame.bitstream), out.ctypes.data, frame.width,
                                          frame.height)
        if status == 0:
            if frame.alpha is None:
                out[..., 3] = 255
            else:
                alpha = np.empty((frame.height, frame.width), dtype=np.uint8)
                status = lib.dial_webp_alpha(frame.alpha, len(frame.alpha), frame.width, frame.height,
                                             alpha.ctypes.data)
                out[..., 3] = alpha
    if status == 2:  # libwebp decodes key frames only
        raise InvalidDocumentError("WebP frame is not a key frame")
    if status:
        raise InvalidDocumentError("WebP image data is corrupt")
    return out


def _blend(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """libwebp's BlendPixelNonPremult of ``src`` over ``dst`` (RGBA rows),
    for the pixels of ``src`` that are not opaque."""
    s = src.astype(np.int64)
    d = dst.astype(np.int64)
    sa, da = s[..., 3:4], d[..., 3:4]
    dfa = (da * (256 - sa)) >> 8
    ba = sa + dfa
    scale = (1 << 24) // np.maximum(ba, 1)
    rgb = ((s[..., :3] * sa + d[..., :3] * dfa) * scale) >> 24
    blended = np.concatenate([rgb, ba], axis=-1).astype(np.uint8)
    out = np.where(sa == 0, dst, blended)
    return np.where(sa == 255, src, out)


class _Decoder:
    """WebPAnimDecoder: the canvas after each frame in turn."""

    def __init__(self, size: tuple[int, int], frames: list[Frame]):
        self.w, self.h = size
        self.frames = frames
        self.index = -1
        self.canvas = np.zeros((self.h, self.w, 4), dtype=np.uint8)
        self.disposed = self.canvas.copy()  # the previous canvas, its frame disposed
        self.previous_key = False

    def _is_key(self, f: Frame) -> bool:
        if self.index == 0:
            return True
        full = (f.width, f.height) == (self.w, self.h)
        if (not f.has_alpha or not f.blend) and full:
            return True
        p = self.frames[self.index - 1]
        return p.dispose_background and ((p.width, p.height) == (self.w, self.h) or self.previous_key)

    def next(self) -> None:
        self.index += 1
        f = self.frames[self.index]
        key = self._is_key(f)
        self.canvas = np.zeros_like(self.canvas) if key else self.disposed.copy()
        rows, cols = slice(f.y0, f.y0 + f.height), slice(f.x0, f.x0 + f.width)
        self.canvas[rows, cols] = decode_frame(f)
        if self.index > 0 and f.blend and not key:
            mask = np.ones((f.height, f.width), dtype=bool)
            p = self.frames[self.index - 1]
            if p.dispose_background:  # the disposed rectangle is not blended
                ys = slice(max(p.y0 - f.y0, 0), max(min(p.y0 + p.height - f.y0, f.height), 0))
                xs = slice(max(p.x0 - f.x0, 0), max(min(p.x0 + p.width - f.x0, f.width), 0))
                mask[ys, xs] = False
            region = self.canvas[rows, cols]
            blended = _blend(region, self.disposed[rows, cols])
            self.canvas[rows, cols] = np.where(mask[:, :, None], blended, region)
        self.previous_key = key
        self.disposed = self.canvas.copy()
        if f.dispose_background:
            self.disposed[rows, cols] = 0


def decode_webp_frames(data: bytes, numbers: list[int] | None = None) -> list[np.ndarray]:
    """The RGB pages of a WebP, frame ``numbers`` (1-based; every frame if
    None) in that order."""
    size, frames = read_webp(data)
    numbers = numbers or list(range(1, len(frames) + 1))
    for number in numbers:
        if not 1 <= number <= len(frames):
            raise InvalidDocumentError(f"page {number} out of range 1..{len(frames)}")
    pages: dict[int, np.ndarray] = {}
    decoder = _Decoder(size, frames)
    for number in range(1, max(numbers) + 1):
        decoder.next()
        if number in numbers:
            pages[number] = np.ascontiguousarray(decoder.canvas[..., :3])
    return [pages[n] for n in numbers]
