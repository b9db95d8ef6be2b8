"""GIF documents without PIL: a GIF is a document of as many pages as it
has frames (Pillow's ``n_frames``), each page the frame as Pillow
composites it and ``convert("RGB")`` gives it, ``[H, W, 3]`` uint8.

The block structure is read here as Pillow's ``GifImagePlugin`` reads it;
each frame's LZW stream is decoded by the host core ``native/gif.cpp``
(built and loaded by ``native/build.py``; a failed build raises).
Compositing replays Pillow's default loading strategy (RGB after the
first frame) on a model of its core images (``_Core``: L and P images of
a byte a pixel, RGB, RGBA and LA of four):

- the first frame is a palette image, or gray where no palette other
  than the gray ramp is given (gray that takes the global palette, if
  any, as Pillow realises it on load): the screen filled with its
  transparent index (else 0), the frame drawn over it, every pixel;
- from the second frame on a palette image becomes RGB (RGBA where the
  first frame had a transparent index); each frame is drawn on an image
  of its own and pasted over the canvas, its transparent pixels leaving
  it; a frame past the image's edge grows the canvas, with transparent
  black where the frame has a transparent index, else with its colour 0;
- a gray canvas stays gray: later frames are drawn onto it, their
  transparent index skipped; a palette frame there keeps the canvas's
  bytes (Pillow shows it gray) until the next frame turns it RGB;
- the previous frame's disposal is applied first (2: its extent filled
  with the transparent colour, else the background colour, each looked up
  in the frame's palette; 3: its extent restored to what it held before
  that frame); a disposal method stays in force until a frame names
  another (Pillow keeps the last nonzero one); a palette index past the
  palette is black.

Where Pillow fails (a frame without a palette or transparency that grows
an RGB canvas, a palette frame after a transparent gray first frame) the
decoder raises ``InvalidDocumentError``.
"""

import struct
from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError
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
        h, w = state.size
        pages.append(state.page())
    return pages


class _Core:
    """A Pillow core image: mode "L" or "P" ([h, w] bytes, a P image with
    an RGBA palette, black past its entries) or "RGB", "RGBA" or "LA"
    ([h, w, 4] bytes, as Pillow stores them: RGB with a 255 fourth byte, LA
    as L, L, L, A)."""

    def __init__(self, mode: str, px: np.ndarray, lut: np.ndarray | None = None):
        self.mode, self.px, self.lut = mode, px, lut

    @staticmethod
    def fill(mode: str, size: tuple[int, int], colour=0) -> "_Core":
        if mode in ("L", "P"):
            return _Core(mode, np.full(size, colour, dtype=np.uint8), _palette_lut(None) if mode == "P" else None)
        px = np.zeros(size + (4,), dtype=np.uint8)
        px[...] = colour
        return _Core(mode, px)

    @property
    def size(self) -> tuple[int, int]:
        return self.px.shape[:2]

    def copy(self) -> "_Core":
        return _Core(self.mode, self.px.copy(), None if self.lut is None else self.lut.copy())

    def putpalette(self, palette) -> None:
        """Pillow's putpalette: an L or P image becomes P with ``palette``."""
        self.mode, self.lut = "P", _palette_lut(palette)

    def putpalettealpha(self, index: int) -> None:
        if self.mode != "P":
            raise InvalidDocumentError("image has no palette")
        self.lut[index, 3] = 0

    def convert(self, mode: str) -> "_Core":
        """convert("RGB") or convert("RGBA")."""
        if self.mode == "P":
            px = self.lut[self.px].copy()
        elif self.mode == "L":
            px = np.repeat(self.px[:, :, None], 4, axis=2)
        else:
            px = self.px.copy()
            if self.mode == "LA":
                px[..., 1:3] = px[..., :1]
        if mode == "RGB" or self.mode in ("L", "RGB"):
            px[..., 3] = 255
        return _Core(mode, px)

    def transparent_la(self, index: int) -> "_Core":
        """An L image's convert_transparent("LA", index)."""
        px = np.repeat(self.px[:, :, None], 4, axis=2)
        px[..., 3] = np.where(self.px == index, 0, 255)
        return _Core("LA", px)

    def crop(self, ext) -> "_Core":
        return _Core(self.mode, _crop(self.px, ext), self.lut)

    def paste(self, src: "_Core", ext, masked: bool = False) -> None:
        """Pillow's core paste at ``ext``'s corner: bytes copied (an image
        of another pixel size raises, as in Pillow), or with ``masked``
        only where the source's fourth byte (its alpha) is set."""
        if (src.px.ndim == 3) != (self.px.ndim == 3):
            raise InvalidDocumentError("images do not match")
        rows, cols = ext
        h = min(src.size[0], self.size[0] - rows.start)
        w = min(src.size[1], self.size[1] - cols.start)
        target = self.px[rows.start:rows.start + h, cols.start:cols.start + w]
        part = src.px[:h, :w]
        if masked:
            part = np.where(part[..., 3:4] == 255, part, target)
        target[...] = part

    def rgb(self) -> np.ndarray:
        """convert("RGB") as [h, w, 3]."""
        return np.ascontiguousarray(self.convert("RGB").px[..., :3])


def _palette_lut(palette) -> np.ndarray:
    """[256, 4] RGBA palette entries, black past the table."""
    out = np.zeros((256, 4), dtype=np.uint8)
    out[:, 3] = 255
    if palette is not None and palette is not False:
        out[: min(len(palette), 256), :3] = palette[:256]
    return out


class _Compositor:
    """One Pillow GIF image seeking forward (GifImagePlugin's ``_seek``,
    ``load_prepare`` and ``load_end`` under its default loading strategy):
    the image after frame ``index``, its mode, and the disposal the next
    frame applies first."""

    def __init__(self, frames: list[Frame], global_palette, background: int, size: tuple[int, int]):
        self.frames, self.global_palette, self.background = frames, global_palette, background
        self.size = size
        self.index = -1
        self.im: _Core | None = None
        self.mode = ""
        self.transparency_info = None  # info["transparency"]
        self.dispose = None  # (extent, _Core)
        self.next()

    def page(self) -> np.ndarray:
        if self.mode == "P" and self.transparency_info is not None and self.image_palette is None:
            # Pillow's convert needs the image's palette to carry the transparency over, and has none
            raise InvalidDocumentError("GIF palette frame after a gray first frame with transparency")
        return self.im.rgb()

    def next(self) -> None:
        self.index += 1
        k, f = self.index, self.frames[self.index]
        self.size = _grown(self.size, f)
        ext = _extent(f)
        if self.dispose is not None:
            self.im.paste(self.dispose[1], self.dispose[0])
        palette = f.palette if f.palette is not None else self.global_palette
        has_palette = palette is not None and palette is not False
        t = f.transparency
        if k == 0:
            self.mode = "P" if has_palette else "L"
            # the image's palette: the first frame's, else the global one
            self.image_palette = palette if has_palette else self.global_palette
        elif self.mode == "P":
            if self.transparency_info is not None:
                self.im.putpalettealpha(self.transparency_info)
                self.im, self.mode = self.im.convert("RGBA"), "RGBA"
                self.transparency_info = None
            else:
                self.im, self.mode = self.im.convert("RGB"), "RGB"
        rgb_mode = self.mode in ("RGB", "RGBA")

        def colour_of(index: int):
            if has_palette:
                if index * 3 + 3 > len(palette) * 3:
                    index = 0
                return tuple(int(v) for v in palette[index])
            return (index,) * 3

        dsize = (f.height, f.width)
        self.dispose = None
        if f.disposal == 2:
            colour = self.transparency_info if self.transparency_info is not None else t
            if colour is not None:
                fill = _Core.fill("RGBA", dsize, colour_of(colour) + (0,)) if rgb_mode else _Core.fill("P", dsize, colour)
            else:
                colour = self.background
                fill = _Core.fill("RGB", dsize, colour_of(colour) + (255,)) if rgb_mode else _Core.fill("P", dsize,
                                                                                                        colour)
            self.dispose = (ext, fill)
        elif f.disposal == 3:
            if self.im is not None:
                self.dispose = (ext, self.im.crop(ext))
            elif t is not None:
                self.dispose = (ext, _Core.fill("RGBA", dsize, colour_of(t) + (0,)) if rgb_mode
                                else _Core.fill("P", dsize, t))
        skip = -1
        if t is not None:
            if k == 0:
                self.transparency_info = t
            elif not rgb_mode:
                skip = t
        # load_prepare
        temp = "P" if has_palette else "L"
        previous = None
        if k == 0:
            self.im = _Core.fill(temp, self.size, t or 0)
            if temp == "P":
                self.im.putpalette(palette)
        elif rgb_mode:
            previous = self.im
            if has_palette:
                self.im = _Core.fill("P", self.size, t or 0)
                self.im.putpalette(palette)
            else:
                self.im = _Core.fill("L", self.size)
        if previous is None and self.im.size != self.size:
            grown = _Core.fill(self.im.mode, self.size)
            if has_palette:
                grown.putpalette(palette)
            grown.paste(self.im, (slice(0, 1), slice(0, 1)))
            self.im = grown
        self.mode = temp
        # the frame's indexes, its transparent index skipped
        idx = _indexes(f)
        target = self.im.px[ext]
        target[...] = idx if skip < 0 else np.where(idx == skip, target, idx)
        if k == 0 and not has_palette and self.image_palette is not None:
            # Pillow realises the image's palette (the global one, the first
            # frame's being the gray ramp) into the gray image as it loads it
            self.im.putpalette(self.image_palette)
        # load_end
        if previous is None:
            return
        if self.size != previous.size:
            if t is not None:
                grown = _Core.fill("RGBA", self.size)
            else:
                if self.im.mode != "P":
                    raise InvalidDocumentError("image has no palette")
                grown = _Core.fill("P", self.size)
                grown.lut = self.im.lut.copy()
                grown = grown.convert("RGB")
            grown.paste(previous, (slice(0, 1), slice(0, 1)))
            previous = grown
        if t is not None:
            if self.mode == "L":
                frame_im = self.im.transparent_la(t)
            else:
                self.im.putpalettealpha(t)
                frame_im = self.im.convert("RGBA")
        else:
            frame_im = self.im.convert("RGB")
        frame_im = frame_im.crop(ext)
        self.im, self.mode = previous, previous.mode
        previous.paste(frame_im, ext, masked=frame_im.mode in ("LA", "RGBA"))


def _extent(frame: Frame) -> tuple[slice, slice]:
    return slice(frame.y0, frame.y0 + frame.height), slice(frame.x0, frame.x0 + frame.width)


def _grown(size: tuple[int, int], frame: Frame) -> tuple[int, int]:
    """(height, width) of an image of ``size`` once ``frame`` is in it:
    Pillow grows the image to hold a frame past its edge."""
    h, w = max(size[0], frame.y0 + frame.height), max(size[1], frame.x0 + frame.width)
    if h * w > 178956970:  # Pillow's decompression-bomb limit
        raise InvalidDocumentError("GIF image is too large")
    return h, w


def _crop(canvas: np.ndarray, ext) -> np.ndarray:
    """``canvas[ext]``, zeros where the extent lies past the canvas (as
    Pillow crops)."""
    (rows, cols) = ext
    out = np.zeros((rows.stop - rows.start, cols.stop - cols.start) + canvas.shape[2:], dtype=np.uint8)
    part = canvas[ext]
    out[: part.shape[0], : part.shape[1]] = part
    return out
