"""GIF documents without PIL: a GIF is a document of as many pages as it
has frames (Pillow's ``n_frames``), each page the frame as Pillow
composites it and ``convert("RGB")`` gives it, ``[H, W, 3]`` uint8.

The block structure is read here as Pillow's ``GifImagePlugin`` reads it;
each frame's LZW stream is decoded by the host core ``native/gif.cpp``
(built and loaded by ``native/build.py``; a failed build raises).
Compositing follows Pillow's default loading strategy (RGB after the
first frame):

- the first frame is a palette image (or gray, where no palette other
  than the gray ramp is given): the screen filled with its transparent
  index (else 0), the frame drawn over it, every pixel;
- from the second frame on the canvas is RGB: the previous frame's
  disposal is applied first (2: its extent filled with the transparent
  colour, else the background colour, each looked up in the frame's
  palette; 3: its extent restored to what it held before that frame),
  then the frame is drawn, its transparent pixels leaving the canvas;
- a disposal method stays in force until a frame names another (Pillow
  keeps the last nonzero one); a palette index past the palette is black;
- a first frame without a palette keeps the canvas gray, later frames
  drawn onto it skipping their transparent index.

A frame past the image's edge grows it, as Pillow grows it (the new area
black where the frame has a transparent index, else the frame's colour
0). Palette frames after a gray first frame, and frames without a
palette that grow an RGB canvas without transparency, raise
``NotPortedError``.
"""

import struct
from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.native.build import load_native

_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


@dataclass
class Frame:
    x0: int
    y0: int
    width: int
    height: int
    palette: np.ndarray | None | bool  # local: an [n, 3] table, False for the gray ramp, None for none
    transparency: int | None
    disposal: int  # the disposal method in force (Pillow's sticky ``disposal_method``)
    interlace: bool
    min_code_size: int
    lzw: bytes


def _palette(raw: bytes):
    """An [n, 3] table, or False where it is the gray ramp (Pillow's
    ``_is_palette_needed``)."""
    table = np.frombuffer(raw, dtype=np.uint8, count=len(raw) // 3 * 3).reshape(-1, 3)
    if (table == np.arange(len(table))[:, None]).all():
        return False
    return table


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The joined payloads of the sub-blocks at ``pos``, and the position
    after their terminator (or the end of the data)."""
    parts = []
    n = len(data)
    while pos < n and data[pos]:
        size = data[pos]
        parts.append(data[pos + 1:pos + 1 + size])
        pos += 1 + size
    return b"".join(parts), min(pos + 1, n)


def read_gif(data: bytes) -> tuple[tuple[int, int], np.ndarray | None, int, list[Frame]]:
    """(screen size (w, h), global palette or None, background index,
    frames), as Pillow's GIF plugin walks the blocks."""
    if len(data) < 13 or not data.startswith((b"GIF87a", b"GIF89a")):
        raise InvalidDocumentError("Not a GIF image")
    w, h, flags, background = struct.unpack_from("<HHBB", data, 6)
    pos = 13
    global_palette = None
    if flags & 128:
        size = 3 << ((flags & 7) + 1)
        table = _palette(data[pos:pos + size])
        global_palette = None if table is False else table
        pos += size
    else:
        background = 0  # Pillow reads the background index only with a global palette
    frames: list[Frame] = []
    disposal = 0
    n = len(data)
    while True:
        transparency = None
        found = None
        while pos < n:
            kind = data[pos]
            pos += 1
            if kind == 0x3B:  # trailer
                break
            if kind == 0x21:  # extension
                if pos >= n:
                    break
                label = data[pos]
                pos += 1
                first = b""
                if pos < n and data[pos]:
                    first = data[pos + 1:pos + 1 + data[pos]]
                    pos += 1 + data[pos]
                    if label == 0xF9:  # graphic control
                        if first[0] & 1:
                            transparency = first[3]
                        if (first[0] >> 2) & 7:
                            disposal = (first[0] >> 2) & 7
                    _, pos = _sub_blocks(data, pos)
                else:
                    pos += 1  # an empty first sub-block ends the extension
                continue
            if kind == 0x2C:  # image descriptor
                if pos + 9 > n:
                    raise InvalidDocumentError("GIF image descriptor is truncated")
                x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
                pos += 9
                local = None
                if fflags & 128:
                    size = 3 << ((fflags & 7) + 1)
                    local = _palette(data[pos:pos + size])
                    pos += size
                if pos >= n:
                    raise InvalidDocumentError("GIF image data is truncated")
                min_code_size = data[pos]
                lzw, pos = _sub_blocks(data, pos + 1)
                found = Frame(x0, y0, fw, fh, local, transparency, disposal, bool(fflags & 64), min_code_size, lzw)
                break
            # any other byte is skipped, as Pillow skips it
        if found is None:
            break
        frames.append(found)
    if not frames:
        raise InvalidDocumentError("GIF image has no frame")
    return (w, h), global_palette, background, frames


def frame_count(data: bytes) -> int:
    """Pillow's ``n_frames``."""
    return len(read_gif(data)[3])


def _indexes(frame: Frame) -> np.ndarray:
    """The frame's [height, width] palette indexes, rows in place."""
    count = frame.width * frame.height
    out = np.zeros(max(count, 1), dtype=np.uint8)
    got = load_native("gif").dial_gif_lzw(frame.lzw, len(frame.lzw), frame.min_code_size, out.ctypes.data, count)
    if got < 0:
        raise InvalidDocumentError("GIF image data is corrupt")
    if got < count:
        raise InvalidDocumentError("GIF image data ends before the frame is full")
    rows = out[:count].reshape(frame.height, frame.width)
    if frame.interlace:
        order = np.concatenate([np.arange(start, frame.height, step) for start, step in _INTERLACE])
        laid = np.empty_like(rows)
        laid[order] = rows
        rows = laid
    return rows


def _lut(palette) -> np.ndarray:
    """[256, 3] RGB of a palette (black past its end), or the gray ramp."""
    if palette is None or palette is False:
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    out = np.zeros((256, 3), dtype=np.uint8)
    out[: min(len(palette), 256)] = palette[:256]
    return out


def decode_gif_frames(data: bytes, numbers: list[int] | None = None) -> list[np.ndarray]:
    """The RGB pages of a GIF, frame ``numbers`` (1-based; every frame if
    None) in that order, each as one Pillow image gives ``seek(number -
    1)`` then ``convert("RGB")``: a number below the last one composites
    again from the first frame, in an image that has kept the size the
    frames read so far grew it to."""
    (w, h), global_palette, background, frames = read_gif(data)
    numbers = numbers or list(range(1, len(frames) + 1))
    for number in numbers:
        if not 1 <= number <= len(frames):
            raise InvalidDocumentError(f"page {number} out of range 1..{len(frames)}")
    pages, state = [], None
    for number in numbers:
        if state is None or number - 1 < state.index:
            state = _Compositor(frames, global_palette, background, (h, w))
        while state.index < number - 1:
            state.next()
        h, w = state.canvas.shape[:2]
        pages.append(state.page())
    return pages


class _Compositor:
    """One Pillow GIF image seeking forward: the canvas after frame
    ``index``, and the disposal the next frame applies first."""

    def __init__(self, frames: list[Frame], global_palette, background: int, size: tuple[int, int]):
        self.frames, self.global_palette, self.background = frames, global_palette, background
        first = frames[0]
        self.palette0 = first.palette if first.palette is not None else global_palette
        self.rgb = self.palette0 is not None and self.palette0 is not False  # Pillow's mode "P" (else "L")
        # indexes until the second frame
        self.canvas = np.full(_grown(size, first), first.transparency or 0, dtype=np.uint8)
        ext = _extent(first)
        self.dispose = _dispose(first, ext, None, first.transparency, background, self.palette0)
        self.canvas[ext] = _indexes(first)
        self.index = 0

    def page(self) -> np.ndarray:
        if self.canvas.ndim == 3:
            return self.canvas.copy()
        return _lut(self.palette0 if self.rgb else None)[self.canvas]

    def next(self) -> None:
        self.index += 1
        f = self.frames[self.index]
        if self.dispose is not None:
            where, value = self.dispose
            self.canvas[where] = value
        if self.rgb and self.canvas.ndim == 2:
            self.canvas = _lut(self.palette0)[self.canvas]  # Pillow converts the first frame to RGB here
        palette = f.palette if f.palette is not None else self.global_palette
        ext = _extent(f)
        size = _grown(self.canvas.shape[:2], f)
        if self.rgb:
            # the first frame's transparency left Pillow's info at the conversion
            self.dispose = _dispose(f, ext, self.canvas, f.transparency, self.background, palette)
            idx = _indexes(f)
            if size != self.canvas.shape[:2]:
                # Pillow pastes the canvas on black where the frame is transparent, else on index 0
                if f.transparency is None and (palette is None or palette is False):
                    raise NotPortedError("GIF frames without a palette that grow an RGB canvas are not ported "
                                         "yet (ROADMAP item 9d)")
                fill = (0, 0, 0) if f.transparency is not None else _lut(palette)[0]
                self.canvas = _paste_on(self.canvas, size, np.asarray(fill, dtype=np.uint8))
            drawn = _lut(palette)[idx]
            if f.transparency is not None:
                drawn = np.where((idx == f.transparency)[:, :, None], self.canvas[ext], drawn)
            self.canvas[ext] = drawn
            return
        if palette is not None and palette is not False:
            raise NotPortedError("GIF palette frames after a gray first frame are not ported yet (ROADMAP item 9d)")
        first = self.frames[0].transparency
        colour = first if first is not None else f.transparency
        self.dispose = _dispose(f, ext, self.canvas, colour, self.background, None)
        idx = _indexes(f)
        if size != self.canvas.shape[:2]:
            self.canvas = _paste_on(self.canvas, size, np.uint8(0))
        if f.transparency is not None:
            idx = np.where(idx == f.transparency, self.canvas[ext], idx)
        self.canvas[ext] = idx


def _extent(frame: Frame) -> tuple[slice, slice]:
    return slice(frame.y0, frame.y0 + frame.height), slice(frame.x0, frame.x0 + frame.width)


def _grown(size: tuple[int, int], frame: Frame) -> tuple[int, int]:
    """(height, width) of an image of ``size`` once ``frame`` is in it:
    Pillow grows the image to hold a frame past its edge."""
    h, w = max(size[0], frame.y0 + frame.height), max(size[1], frame.x0 + frame.width)
    if h * w > 178956970:  # Pillow's decompression-bomb limit
        raise InvalidDocumentError("GIF image is too large")
    return h, w


def _paste_on(canvas: np.ndarray, size: tuple[int, int], fill) -> np.ndarray:
    out = np.empty(size + canvas.shape[2:], dtype=np.uint8)
    out[...] = fill
    out[: canvas.shape[0], : canvas.shape[1]] = canvas
    return out


def _crop(canvas: np.ndarray, ext) -> np.ndarray:
    """``canvas[ext]``, zeros where the extent lies past the canvas (as
    Pillow crops)."""
    (rows, cols) = ext
    out = np.zeros((rows.stop - rows.start, cols.stop - cols.start) + canvas.shape[2:], dtype=np.uint8)
    part = canvas[ext]
    out[: part.shape[0], : part.shape[1]] = part
    return out


def _dispose(frame: Frame, ext, canvas, colour, background: int, palette):
    """What the frame's disposal puts in its extent before the next frame
    is drawn: (the extent, a fill value or the saved pixels), or None. On
    an index canvas (the first frame's, or a gray one) fills are indexes;
    on an RGB canvas colours of the frame's ``palette``."""
    if frame.disposal == 2:
        if colour is None:
            colour = background
        if canvas is None or canvas.ndim == 2:
            return ext, colour
        if palette is None or palette is False:
            return ext, np.array([colour] * 3, dtype=np.uint8)
        return ext, palette[colour if colour < len(palette) else 0]
    if frame.disposal == 3:
        if canvas is None:  # the first frame: Pillow has no image to save yet
            return (ext, frame.transparency) if frame.transparency is not None else None
        return ext, _crop(canvas, ext)
    return None
