"""JPEG 2000 without PIL: what ``Image.open(...).convert("RGB")`` gives for
a JPEG 2000 codestream or JP2 file (a PDF's ``JPXDecode`` stream carries
either). The host core ``native/jpeg2000.cpp`` decodes the codestream to
one int32 plane per component as OpenJPEG 2.5 does; this module reads the
JP2 boxes and turns the planes into Pillow's pixels, as Pillow's
``Jpeg2KImagePlugin`` and its C decoder (``Jpeg2KDecode.c``) do:

- the mode comes from the codestream's SIZ (1 component: ``L``, or
  ``I;16`` above 8 bits; 2: ``LA``; 3: ``RGB``; 4: ``RGBA``) or from the
  JP2 ``ihdr`` box, whose bit depth field is the precision less one, so a
  9-bit single component opens as ``L`` there; more than 4 components do
  not open. A ``colr`` box with enumerated colour space 12 on 4 components
  is ``CMYK``; a ``pclr`` box on ``L`` / ``LA`` makes ``P`` / ``PA``,
  whose palette ``ImagePalette.getcolor`` builds entry by entry, so a
  colour met again reuses its first index and the indexes after it shift;
- OpenJPEG's colour space comes from the ``colr`` box (16 sRGB, 17 gray,
  18 sYCC, 24 e-sYCC, 12 CMYK, anything else unknown) or, for a bare
  codestream, is unspecified and taken from the component count; an
  unknown colour space (an ICC ``colr``, a JP2 without ``colr``) fails the
  decode, as in Pillow. Pillow passes ``pclr``, ``cmap`` and ``cdef`` on
  to OpenJPEG unapplied: the components keep their codestream order, and
  a ``P`` image's samples are palette indexes;
- the planes go to Pillow's unpackers tile by tile: each sample shifted
  to 8 bits (16 for ``I;16``) with ``8 - precision``, a right shift
  adding half of its step first, a signed sample offset by half its range,
  all in unsigned arithmetic and stored modulo 256 (65536), so a signed
  component reads as its value plus 128; a subsampled component is read
  at ``x / dx`` and ``y / dy`` of a plane Pillow takes as ``(w / dx) x
  (h / dy)`` samples of the tile, which is what the decoder wrote when the
  tile's width and height are multiples of the factors;
- ``convert("RGB")`` repeats gray, looks a ``P`` index up in the palette,
  drops alpha (not composited), clamps ``I;16`` at 255, and turns CMYK
  through Pillow's ``cmyk2rgb``.

Probed on Pillow 12.1 with OpenJPEG 2.5.4 (the fixtures of
``tests/data/images``): precisions 1 to 16, signed components, ``pclr``
with repeated entries, ``cdef`` reordering, CMYK, and components
subsampled by 2 in a tile whose sizes they divide, decode as above. What
the port does not read raises ``NotPortedError`` (ROADMAP item 9d): sYCC
and e-sYCC (Pillow's YCbCr tables), a subsampled tile whose sizes the
factors do not divide (Pillow then reads past the samples the decoder
wrote), and what the core refuses (the high-throughput block coder, Part 2
extensions). Corrupt or truncated data raises ``InvalidDocumentError``
where Pillow fails; Pillow's decompression-bomb limit applies.
"""

import ctypes
import struct
from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.image_processor.jpeg import cmyk_to_rgb
from dial_rag_tpu_torch.native.build import load_native

_MAX_PIXELS = 178956970  # Pillow's decompression-bomb limit
_UNSUPPORTED = 2
_CODESTREAM = b"\xff\x4f\xff\x51"
_JP2 = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# OpenJPEG's colour spaces
_UNKNOWN, _UNSPECIFIED, _SRGB, _GRAY, _SYCC, _EYCC, _CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}


def is_jpeg2000(data: bytes) -> bool:
    """As Pillow's JPEG 2000 plugin accepts a file."""
    return data[:4] == _CODESTREAM or data[:12] == _JP2


def _not_ported(what: str) -> NotPortedError:
    return NotPortedError(f"{what} in JPEG 2000 images is not ported yet (ROADMAP item 9d)")


def _check(status: int) -> None:
    if status == _UNSUPPORTED:
        raise _not_ported("The high-throughput block coder or a Part 2 extension")
    if status:
        raise InvalidDocumentError("The JPEG 2000 image is corrupt")


@dataclass
class _Header:
    size: tuple[int, int]
    mode: str
    palette: list[tuple[int, ...]] | None
    color_space: int
    codestream: bytes


def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, payload end) of the boxes in data[start:end];
    a box that claims more than is there raises, as Pillow's BoxReader."""
    at = start
    while at < end:
        if at + 8 > end:
            raise InvalidDocumentError("JPEG 2000 box header is truncated")
        length, kind = struct.unpack_from(">I4s", data, at)
        head = 8
        if length == 1:
            if at + 16 > end:
                raise InvalidDocumentError("JPEG 2000 box header is truncated")
            (length,) = struct.unpack_from(">Q", data, at + 8)
            head = 16
        elif length == 0:
            length = end - at
        if length < head or at + length > end:
            raise InvalidDocumentError("Invalid JPEG 2000 box length")
        yield kind, at + head, at + length
        at += length


def _siz_mode(siz: bytes) -> tuple[tuple[int, int], str]:
    """Pillow's ``_parse_codestream``: the size and mode from the SIZ
    segment (``siz`` starts at its length field)."""
    if len(siz) < 38:
        raise InvalidDocumentError("JPEG 2000 SIZ is truncated")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    modes = {2: "LA", 3: "RGB", 4: "RGBA"}
    if csiz == 1:
        if len(siz) < 39:
            raise InvalidDocumentError("JPEG 2000 SIZ is truncated")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in modes:
        mode = modes[csiz]
    else:
        raise InvalidDocumentError("unable to determine J2K image mode")
    return (xsiz - xosiz, ysiz - yosiz), mode


def _getcolor_palette(entries: list[tuple[int, ...]]) -> list[tuple[int, ...]]:
    """The palette ``ImagePalette.getcolor`` builds from ``entries`` in
    order: a colour already present is not added again, and a 257th
    colour fails ("cannot allocate more than 256 colors")."""
    palette: list[tuple[int, ...]] = []
    for color in entries:
        if color not in palette:
            if len(palette) == 256:
                raise InvalidDocumentError("JPEG 2000 palette holds more than 256 colours")
            palette.append(color)
    return palette


def _check_box(kind: bytes, body: bytes, seen: set[bytes], columns: int) -> None:
    """The checks OpenJPEG makes reading the header boxes Pillow reads
    too (a box it refuses fails the decode)."""
    ok = True
    if kind == b"ihdr":
        ok = len(body) == 14 and min(struct.unpack_from(">IIH", body)) >= 1
    elif kind == b"colr":
        ok = len(body) >= 3 and (body[0] != 1 or len(body) >= 7)
    elif kind == b"pclr":
        ok = len(body) >= 3 and kind not in seen
        if ok:
            ne, npc = struct.unpack_from(">HB", body)
            depths = body[3:3 + npc]
            need = 3 + npc + ne * sum(min(((d & 0x7F) + 8) >> 3, 4) for d in depths)
            ok = 1 <= ne <= 1024 and npc >= 1 and len(depths) == npc and len(body) >= need
    elif kind == b"cmap":
        ok = b"pclr" in seen and kind not in seen and len(body) >= 4 * columns
    elif kind == b"cdef":
        ok = kind not in seen and len(body) >= 2 and 1 <= struct.unpack_from(">H", body)[0]
        ok = ok and len(body) >= 2 + 6 * struct.unpack_from(">H", body)[0]
    if not ok:
        raise InvalidDocumentError(f"JPEG 2000 {kind.decode('latin-1')} box is malformed")
    seen.add(kind)


def _parse_header(data: bytes) -> _Header:
    if data[:4] == _CODESTREAM:
        size, mode = _siz_mode(data[4:])
        return _Header(size, mode, None, _UNSPECIFIED, data)
    if data[:12] != _JP2:
        raise InvalidDocumentError("not a JPEG 2000 file")
    jp2h = codestream = None
    for kind, start, end in _boxes(data, 12, len(data)):
        if kind == b"jp2h" and jp2h is None:
            jp2h = (start, end)
        elif kind == b"jp2c" and codestream is None:
            codestream = data[start:end]
    if jp2h is None:
        raise InvalidDocumentError("Malformed JP2 header")
    size = mode = None
    nc = 0
    palette = None
    enumcs = None
    seen: set[bytes] = set()
    columns = 0
    for kind, start, end in _boxes(data, *jp2h):
        body = data[start:end]
        _check_box(kind, body, seen, columns)
        if kind == b"ihdr":
            height, width, nc, bpc = struct.unpack_from(">IIHB", body)
            size = (width, height)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif kind == b"colr":
            if enumcs is None:  # OpenJPEG reads the first colr box
                enumcs = struct.unpack_from(">I", body, 3)[0] if body[0] == 1 else 0
            if nc == 4 and body[0] == 1 and struct.unpack_from(">I", body, 3)[0] == 12:
                mode = "CMYK"
        elif kind == b"pclr":
            ne, columns = struct.unpack_from(">HB", body)
            if mode in ("L", "LA") and max(body[3:3 + columns]) <= 8:
                # Pillow's plugin reads a byte an entry per column, whatever the depth
                rows = body[3 + columns:3 + columns + ne * columns]
                if len(rows) < ne * columns:
                    raise InvalidDocumentError("Not enough data in header")
                palette = _getcolor_palette([tuple(rows[i * columns:(i + 1) * columns]) for i in range(ne)])
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise InvalidDocumentError("Malformed JP2 header")
    if codestream is None or codestream[:4] != _CODESTREAM:
        raise InvalidDocumentError("JP2 file holds no codestream")
    color_space = _UNKNOWN if enumcs is None else _ENUMCS.get(enumcs, _UNKNOWN)
    return _Header(size, mode, palette, color_space, codestream)


@dataclass
class _Info:
    x0: int
    y0: int
    x1: int
    y1: int
    ncomp: int
    tx0: int
    ty0: int
    tdx: int
    tdy: int
    tiles_x: int
    tiles_y: int
    prec: list[int]
    sgnd: list[int]
    dx: list[int]
    dy: list[int]


def _info(codestream: bytes) -> _Info:
    raw = (ctypes.c_int * 27)()
    _check(load_native("jpeg2000").dial_j2k_info(codestream, len(codestream), raw))
    v = list(raw)
    n = min(v[4], 4)
    comp = [v[11 + 4 * c:15 + 4 * c] for c in range(n)]
    return _Info(*v[:11], [c[0] for c in comp], [c[1] for c in comp], [c[2] for c in comp], [c[3] for c in comp])


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def read_header(data: bytes) -> tuple[int, int, str]:
    """(width, height, Pillow's mode) of a JPEG 2000 file, as ``Image.open``
    reads them; the bomb limit applies."""
    header = _parse_header(data)
    width, height = header.size
    if width * height > _MAX_PIXELS:
        raise InvalidDocumentError("JPEG 2000 image exceeds the decompression-bomb limit")
    return width, height, header.mode


def _color_space(header: _Header, info: _Info) -> int:
    """The colour space Pillow unpacks by: an unspecified or unknown one
    from the component count, three components with the second or third
    subsampled taken as sYCC."""
    n = info.ncomp
    if header.color_space not in (_UNSPECIFIED, _UNKNOWN):
        return header.color_space
    if n == 3 and any(info.dx[c] != 1 or info.dy[c] != 1 for c in (1, 2)):
        return _SYCC
    return _GRAY if n <= 2 else _SRGB


# Pillow's unpackers: (mode, colour space, components) -> (unpacker, taken when subsampled)
_UNPACKERS = {("L", _GRAY, 1): ("gray", False), ("P", _SRGB, 1): ("gray", False), ("PA", _SRGB, 2): ("graya", False),
              ("I;16", _GRAY, 1): ("gray", False), ("LA", _GRAY, 2): ("graya", False),
              ("RGB", _SRGB, 3): ("rgb", True), ("RGB", _SYCC, 3): ("ycc", True), ("RGB", _SRGB, 4): ("rgb", True),
              ("RGB", _SYCC, 4): ("ycc", True), ("RGBA", _GRAY, 1): ("gray_rgb", False),
              ("RGBA", _GRAY, 2): ("graya", False), ("RGBA", _SRGB, 3): ("rgb", True),
              ("RGBA", _SYCC, 3): ("ycc", True), ("RGBA", _SRGB, 4): ("rgba", True),
              ("RGBA", _SYCC, 4): ("ycca", True), ("RGBA", _GRAY, 4): ("rgba", True),
              ("CMYK", _CMYK, 4): ("rgba", True)}


def _unpack(header: _Header, info: _Info, planes: list[np.ndarray]) -> np.ndarray:
    """Pillow's image ([h, w, bands] uint8, or [h, w] uint16 for I;16)
    from the component planes, tile by tile as Jpeg2KDecode.c unpacks."""
    width, height = header.size
    mode = header.mode
    n = info.ncomp
    subsampled = any(info.dx[c] != 1 or info.dy[c] != 1 for c in range(1, n))
    entry = _UNPACKERS.get((mode, _color_space(header, info), n))
    if entry is None or (subsampled and not entry[1]) or (n <= 2 and (info.dx[0], info.dy[0]) != (1, 1)):
        raise InvalidDocumentError("JPEG 2000 image has no unpacker for its mode")
    unpacker = entry[0]
    bands = {"L": 1, "P": 1, "I;16": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    out = np.zeros((height, width) if mode == "I;16" else (height, width, bands),
                   dtype=np.uint16 if mode == "I;16" else np.uint8)
    csiz = []
    for c in range(n):
        size = (info.prec[c] + 7) >> 3
        csiz.append(4 if size == 3 else size)
    cx0 = [_ceildiv(info.x0, info.dx[c]) for c in range(n)]
    cy0 = [_ceildiv(info.y0, info.dy[c]) for c in range(n)]
    for q in range(info.tiles_y):
        for p in range(info.tiles_x):
            tx0 = max(info.tx0 + p * info.tdx, info.x0)
            ty0 = max(info.ty0 + q * info.tdy, info.y0)
            tx1 = min(info.tx0 + (p + 1) * info.tdx, info.x1)
            ty1 = min(info.ty0 + (q + 1) * info.tdy, info.y1)
            # the tile's samples as the decoder hands them over: each component's tile, csiz bytes a sample
            chunks = []
            for c in range(n):
                tcx0, tcx1 = _ceildiv(tx0, info.dx[c]), _ceildiv(tx1, info.dx[c])
                tcy0, tcy1 = _ceildiv(ty0, info.dy[c]), _ceildiv(ty1, info.dy[c])
                tile = planes[c][tcy0 - cy0[c]:tcy1 - cy0[c], tcx0 - cx0[c]:tcx1 - cx0[c]]
                chunks.append(tile.astype(f"<u{csiz[c]}").tobytes())
            buffer = np.frombuffer(b"".join(chunks), dtype=np.uint8)
            values = _unpacker(unpacker, mode, info, buffer, csiz, tx1 - tx0, ty1 - ty0)
            out[ty0 - info.y0:ty1 - info.y0, tx0 - info.x0:tx1 - info.x0] = values
    return out


def _words(buffer: np.ndarray, at: np.ndarray, size: int) -> np.ndarray:
    """The little-endian ``size``-byte words at byte offsets ``at``; Pillow
    would read past what the decoder wrote beyond the buffer."""
    if at.size and int(at.max()) + size > buffer.size:
        raise _not_ported("A subsampled tile Pillow reads past the decoded samples of")
    word = np.zeros(at.shape, dtype=np.int64)
    for k in range(size):
        word |= buffer[at + k].astype(np.int64) << (8 * k)
    return word


def _shifted(word: np.ndarray, prec: int, sgnd: int, depth: int) -> np.ndarray:
    """j2ku_shift(offset + word, depth - prec), stored modulo 2**depth."""
    shift = depth - prec
    offset = 1 << (prec - 1) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    value = (word + offset) & 0xFFFFFFFF
    value = value >> -shift if shift < 0 else value << shift
    return value & ((1 << depth) - 1)


def _unpacker(kind: str, mode: str, info: _Info, buffer: np.ndarray, csiz: list[int], w: int, h: int) -> np.ndarray:
    """One tile through Pillow's unpacker ``kind``: [h, w, bands] (or [h, w]
    for I;16) of the image's bands."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if kind in ("gray", "gray_rgb", "graya"):
        # j2ku_gray_l / j2ku_gray_i / j2ku_graya_la: component 0 at (y * w + x), alpha after w * h of it
        depth = 16 if mode == "I;16" else 8
        gray = _shifted(_words(buffer, csiz[0] * (ys * w + xs), csiz[0]), info.prec[0], info.sgnd[0], depth)
        if mode == "I;16":
            return gray.astype(np.uint16)
        if kind == "gray":
            return gray.astype(np.uint8)[..., None]
        if kind == "gray_rgb":
            return np.stack([gray] * 3 + [np.full_like(gray, 255)], -1).astype(np.uint8)
        alpha = _shifted(_words(buffer, csiz[0] * w * h + csiz[1] * (ys * w + xs), csiz[1]), info.prec[1],
                         info.sgnd[1], 8)
        if mode == "RGBA":
            return np.stack([gray] * 3 + [alpha], -1).astype(np.uint8)
        return np.stack([gray, alpha], -1).astype(np.uint8)
    # j2ku_srgb_rgb / j2ku_srgba_rgba / the sYCC ones: component n at (y / dy, x / dx) of a plane Pillow
    # takes as (w / dx) x (h / dy) samples, the planes one after the other
    used = 4 if kind in ("rgba", "ycca") else 3
    bands, start = [], 0
    for c in range(info.ncomp):
        dx, dy = info.dx[c], info.dy[c]
        if c < used:
            at = start + csiz[c] * ((ys // dy) * (w // dx) + xs // dx)
            bands.append(_shifted(_words(buffer, at, csiz[c]), info.prec[c], info.sgnd[c], 8))
        start += csiz[c] * (w // dx) * (h // dy)
    if used == 3 and mode in ("RGBA", "CMYK"):
        bands.append(np.full((h, w), 255, dtype=np.int64))
    if kind in ("ycc", "ycca"):
        bands[:3] = _ycbcr_to_rgb(*bands[:3])
    return np.stack(bands, -1).astype(np.uint8)


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> list[np.ndarray]:
    """Pillow's ``ImagingConvertYCbCr2RGB``."""
    from dial_rag_tpu_torch.image_processor import _ycbcr

    r_cr, b_cb = np.array(_ycbcr.R_CR), np.array(_ycbcr.B_CB)
    g_cb, g_cr = np.array(_ycbcr.G_CB), np.array(_ycbcr.G_CR)
    return [np.clip(y + r_cr[cr], 0, 255), np.clip(y + ((g_cb[cb] + g_cr[cr]) >> 6), 0, 255),
            np.clip(y + b_cb[cb], 0, 255)]


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """The RGB pixels ([H, W, 3] uint8) of a JPEG 2000 codestream or JP2
    file, as ``Image.open(...).convert("RGB")`` gives them."""
    header = _parse_header(data)
    width, height = header.size
    if width * height > _MAX_PIXELS:
        raise InvalidDocumentError("JPEG 2000 image exceeds the decompression-bomb limit")
    info = _info(header.codestream)
    if info.ncomp > 4:
        raise InvalidDocumentError("JPEG 2000 image has more than 4 components")
    if (info.x1 - info.x0, info.y1 - info.y0) != (width, height):
        raise InvalidDocumentError("JPEG 2000 image size differs from its header")
    sizes = [(_ceildiv(info.y1, info.dy[c]) - _ceildiv(info.y0, info.dy[c]),
              _ceildiv(info.x1, info.dx[c]) - _ceildiv(info.x0, info.dx[c])) for c in range(info.ncomp)]
    out = np.empty(sum(h * w for h, w in sizes), dtype=np.int32)
    _check(load_native("jpeg2000").dial_j2k_decode(header.codestream, len(header.codestream), out.ctypes.data,
                                                    out.size))
    planes, at = [], 0
    for h, w in sizes:
        planes.append(out[at:at + h * w].reshape(h, w))
        at += h * w
    image = _unpack(header, info, planes)
    mode = header.mode
    if mode == "I;16":
        return np.repeat(np.minimum(image, 255).astype(np.uint8)[..., None], 3, axis=2)
    if mode in ("L", "LA"):
        return np.repeat(image[..., :1], 3, axis=2)
    if mode in ("P", "PA"):
        palette = header.palette or []
        lut = np.zeros((256, 3), dtype=np.uint8)
        for i, color in enumerate(palette[:256]):
            lut[i] = (tuple(color) + (0, 0, 0))[:3]
        return lut[image[..., 0]]
    if mode == "CMYK":
        return cmyk_to_rgb(image)
    return np.ascontiguousarray(image[..., :3])
