"""TIFF documents without PIL: a TIFF is a document of as many pages as its
chain of image file directories has entries (Pillow's ``n_frames``), each
page ``[H, W, 3]`` uint8 as ``Image.open(...).seek(n).convert("RGB")``
gives it.

Headers: classic (``II*\\0``, ``MM\\0*``, and the two swapped magics
Pillow also opens) and BigTIFF. A page's strips or tiles, in planar
configuration 1 or 2, are decoded one by one and laid into place:

- none (1), PackBits (32773), LZW (5, both bit orders) and CCITT RLE,
  Group 3 (1D and 2D) and Group 4 (2, 3, 4) by the host core
  ``native/tiff.cpp``; Adobe Deflate (8) and Deflate (32946) by ``zlib``;
  JPEG (7) by ``native/jpeg.cpp``, each strip after the ``JPEGTables``
  it abbreviates (YCbCr converted to RGB as libtiff's RGB colour mode
  has libjpeg do it);
- FillOrder 2 reverses the bits of each strip's bytes first, as libtiff
  does; horizontal predictor 2 is undone at 8 and 16 bits.

Uncompressed data are read only for the rows and columns the page covers,
as Pillow's raw reader reads them, so a tile that says it is far larger
than its page costs nothing. A compressed tile decodes whole, so one larger
than both its page and a megapixel raises ``InvalidDocumentError`` before
it is allocated (no encoder writes one; Pillow would try to decode it). The
directory chain is walked once a document.

Samples become RGB as Pillow's modes for the page's key (byte order,
photometric interpretation, sample format, fill order, bits, extra
samples: ``OPEN_INFO`` of its TIFF plugin) convert: WhiteIsZero and
BlackIsZero at 1, 2, 4 and 8 bits (scaled, inverted for WhiteIsZero),
16-bit gray clipped to 255 (``I;16``, as ``png.py`` does), RGB with its
extra samples dropped (associated alpha divided out first, ``RGBa``),
16-bit RGB by its high bytes, palette images through their colour map's
high bytes, CMYK through Pillow's ``cmyk2rgb``. A key Pillow does not
open raises ``InvalidDocumentError``, as its open fails.

Old-style JPEG (6), LZMA, ZSTD, WebP-in-TIFF, SGILog and ThunderScan
compressions, the floating-point predictor 3, YCbCr outside JPEG, CIE
L*a*b*, 12- and 32-bit samples raise ``NotPortedError`` (ROADMAP item 9d).
"""

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.native.build import load_native

# the prefixes Pillow reads: (magic, byte order, BigTIFF); it takes a
# big-endian BigTIFF (MM\0+) for a classic header and cannot read it
_MAGICS = ((b"II*\x00", "<", False), (b"MM\x00*", ">", False), (b"MM*\x00", ">", False),
           (b"II\x00*", "<", False), (b"II+\x00", "<", True))
# type -> (struct code, size) of a value
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4), 10: ("i", 4), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_RATIONALS = (5, 10)
_NOT_PORTED = {6: "old-style JPEG", 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
               34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_DECODED = {1, 2, 3, 4, 5, 7, 8, 32773, 32946}
_PREDICTED = {5, 8, 32946}  # the codecs libtiff runs the predictor for
_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
_MAX_PIXELS = 178956970  # Pillow's decompression-bomb limit
# a compressed tile decodes whole, so one is refused that is larger than
# both its page and this (no encoder writes one; Pillow tries to decode it)
_MAX_TILE_PIXELS = 1 << 20


def is_tiff(data: bytes) -> bool:
    return data[:4] in {m for m, _, _ in _MAGICS}


def _header(data: bytes) -> tuple[str, bool, int]:
    """(byte order, BigTIFF, first directory's offset)."""
    for magic, order, big in _MAGICS:
        if data[:4] == magic:
            if big:
                if len(data) < 16:
                    break
                return order, True, struct.unpack_from(order + "Q", data, 8)[0]
            if len(data) < 8:
                break
            return order, False, struct.unpack_from(order + "I", data, 4)[0]
    raise InvalidDocumentError("Not a TIFF image")


def _directory(data: bytes, order: str, big: bool, offset: int) -> tuple[dict, int]:
    """The tags of the directory at ``offset`` (tag -> tuple of values) and
    the next directory's offset."""
    count_fmt, entry, inline = ("Q", 20, 8) if big else ("H", 12, 4)
    try:
        (count,) = struct.unpack_from(order + count_fmt, data, offset)
        at = offset + (8 if big else 2)
        tags = {}
        for k in range(count):
            pos = at + k * entry
            tag, kind = struct.unpack_from(order + "HH", data, pos)
            n = struct.unpack_from(order + ("Q" if big else "I"), data, pos + 4)[0]
            if kind not in _TYPES:
                continue
            code, size = _TYPES[kind]
            n_values = n * (2 if kind in _RATIONALS else 1)
            nbytes = size * n_values
            where = pos + (12 if big else 8)
            if nbytes > inline:
                where = struct.unpack_from(order + ("Q" if big else "I"), data, where)[0]
            if where + nbytes > len(data):
                continue
            if kind in (2, 7) or (tag == 347 and kind == 1):
                tags[tag] = data[where:where + nbytes]
            else:
                tags[tag] = struct.unpack_from(f"{order}{n_values}{code}", data, where)
        following = struct.unpack_from(order + ("Q" if big else "I"), data, at + count * entry)[0]
    except struct.error as e:
        raise InvalidDocumentError("TIFF directory is truncated") from e
    return tags, following


def _chain(data: bytes) -> tuple[str, bool, list[int]]:
    """(byte order, BigTIFF, the offsets of the image file directories),
    the chain walked once as Pillow walks it: a directory whose next offset
    was already read ends it."""
    order, big, offset = _header(data)
    if not offset:
        raise InvalidDocumentError("TIFF image has no directory")
    offsets: list[int] = []
    seen: set[int] = set()
    while offset and offset not in seen:
        offsets.append(offset)
        seen.add(offset)
        _, offset = _directory(data, order, big, offset)
    return order, big, offsets


def page_count(data: bytes) -> int:
    """Pillow's ``n_frames``."""
    return len(_chain(data)[2])


@dataclass
class _Page:
    tags: dict
    order: str
    width: int
    height: int
    compression: int
    photometric: int
    fill: int
    bits: tuple
    extra: tuple
    sample_format: tuple
    planar: int
    predictor: int

    @property
    def samples(self) -> int:
        return len(self.bits)


def _page(data: bytes, order: str, big: bool, offset: int) -> _Page:
    """The page of the directory at ``offset``."""
    tags, _ = _directory(data, order, big, offset)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    if 256 not in tags or 257 not in tags:
        raise InvalidDocumentError("TIFF image has no dimensions")
    compression = one(259, 1)
    photometric = one(262, 0)
    if compression in _NOT_PORTED:
        raise NotPortedError(f"{_NOT_PORTED[compression]} compressed TIFF images are not ported yet "
                             "(ROADMAP item 9d)")
    if compression not in _DECODED:
        raise InvalidDocumentError(f"TIFF compression {compression} is unknown")
    if one(317, 1) == 3:
        raise NotPortedError("TIFF images with the floating-point predictor are not ported yet (ROADMAP item 9d)")
    if photometric == 8 or (photometric == 6 and compression != 7):
        kind = "CIE L*a*b*" if photometric == 8 else "YCbCr"
        raise NotPortedError(f"{kind} TIFF images are not ported yet (ROADMAP item 9d)")
    # Pillow's key (TiffImagePlugin._setup)
    extra = tuple(tags.get(338, ()))
    samples = one(277, 1)
    bits = tuple(tags.get(258, (1,)))
    if samples < len(bits):
        bits = bits[:samples]
    elif samples > len(bits) and len(bits) == 1:
        bits = bits * samples
    if len(bits) != samples:
        raise InvalidDocumentError("TIFF image has an unknown data organization")
    sample_format = tuple(tags.get(339, (1,)))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    page = _Page(tags, order, one(256), one(257), compression, photometric, one(266, 1), bits, extra,
                 sample_format, one(284, 1), one(317, 1))
    if page.width * page.height > _MAX_PIXELS:
        raise InvalidDocumentError("TIFF image is too large")
    return page


def _open_info() -> dict:
    """The keys of Pillow's ``OPEN_INFO`` this module reads, without the
    byte order (16-bit gray is looked up with it): (photometric, sample
    format, fill order, bits, extra samples) -> how the samples become RGB:
    "gray" (1-8 bits), "gray16", "gray16s", "palette", "la", "rgb", "rgb_a"
    (associated alpha) or "cmyk"."""
    keys = {}
    for photometric in (0, 1):
        for fill in (1, 2):
            for depth in (1, 2, 4, 8):
                keys[(photometric, (1,), fill, (depth,), ())] = "gray"
    keys[(1, (2,), 1, (8,), ())] = "gray"
    keys[(1, (2,), 1, (16,), ())] = "gray16s"
    keys[(1, (1,), 1, (8, 8), (2,))] = "la"
    for fill in (1, 2):
        for depth in (1, 2, 4, 8):
            keys[(3, (1,), fill, (depth,), ())] = "palette"
    keys[(3, (1,), 1, (8, 8), (0,))] = keys[(3, (1,), 1, (8, 8), (2,))] = "palette"
    keys[(2, (1,), 2, (8,) * 3, ())] = keys[(6, (1,), 1, (8,) * 3, ())] = "rgb"
    for extra in ((0,), (0, 0), (0, 0, 0), (1,), (1, 0), (1, 0, 0), (2,), (2, 0), (2, 0, 0), (999,)):
        keys[(2, (1,), 1, (8,) * (3 + len(extra)), extra)] = "rgb_a" if extra[:1] == (1,) else "rgb"
    keys[(2, (1,), 1, (8,) * 3, ())] = keys[(2, (1,), 1, (8,) * 4, ())] = "rgb"  # RGBA without ExtraSamples too
    for extra in ((), (0,), (1,), (2,)):
        keys[(2, (1,), 1, (16,) * 4, extra)] = "rgb_a" if extra == (1,) else "rgb"
    keys[(2, (1,), 1, (16,) * 3, ())] = "rgb"
    for bits, extra in (((8,) * 4, ()), ((8,) * 5, (0,)), ((8,) * 6, (0, 0)), ((16,) * 4, ())):
        keys[(5, (1,), 1, bits, extra)] = "cmyk"
    return keys


_OPEN_INFO = _open_info()


def _mode(page: _Page) -> str:
    """How the page's samples become RGB, by Pillow's key for it; a key
    Pillow does not open raises InvalidDocumentError, as its open fails."""
    if any(b in (12, 32) for b in page.bits) or page.sample_format == (3,):
        raise NotPortedError(f"{page.bits[0]}-bit TIFF samples are not ported yet (ROADMAP item 9d)")
    key = (page.photometric, page.sample_format, page.fill, page.bits, page.extra)
    if page.bits == (16,) and page.sample_format == (1,):
        # I;16 little-endian either way and both fill orders, big-endian BlackIsZero only
        if page.order == "<" and (page.fill == 1 or page.photometric == 1) or page.photometric == page.fill == 1:
            return "gray16"
    if key not in _OPEN_INFO:
        raise InvalidDocumentError("TIFF image has an unknown pixel mode")
    mode = _OPEN_INFO[key]
    if page.compression == 1 and page.fill == 2 and (
            (page.photometric == 0 and page.bits == (8,)) or (page.photometric == 3 and page.bits[0] < 8)):
        # Pillow reads uncompressed strips itself, and has no raw mode for
        # these bit-reversed samples (L;IR, P;1R, P;2R, P;4R)
        raise InvalidDocumentError("TIFF samples Pillow has no raw mode for")
    if page.planar == 2 and page.samples > 1:
        # Pillow reads planes by one raw mode a band (uncompressed) or through
        # libtiff's planes (compressed), and fails past four bands, on an
        # unspecified extra sample, and uncompressed on a band its mode has no
        # raw mode for; libtiff's planes of four RGB samples without
        # ExtraSamples come out as associated alpha
        raw_ok = page.photometric in (2, 5) and page.extra in ((), (2,), (999,))
        if page.samples > 4 or 0 in page.extra or (page.compression == 1 and not raw_ok):
            raise InvalidDocumentError("TIFF planes Pillow cannot read")
        if page.compression != 1 and mode == "rgb" and page.samples == 4 and not page.extra:
            return "rgb_a"
    return mode


def _native(name: str, *args) -> int:
    return getattr(load_native("tiff"), name)(*args)


def _decompress(page: _Page, raw: bytes, rows: int, row_bytes: int, width: int) -> bytes:
    """One strip or tile's bytes, decoded to ``rows`` rows of ``row_bytes``."""
    need = rows * row_bytes
    c = page.compression
    if page.fill == 2:
        raw = raw.translate(_REVERSED)
    if c in (2, 3, 4):
        buf = np.zeros(need, dtype=np.uint8)
        t4 = page.tags.get(292, (0,))[0] if c == 3 else 0
        got = _native("dial_tiff_ccitt", raw, len(raw), c, t4, width, rows, buf.ctypes.data, need)
        if got < rows:
            raise InvalidDocumentError("TIFF CCITT data is corrupt")
        return buf.tobytes()
    elif c == 5:
        buf = np.zeros(need, dtype=np.uint8)
        got = _native("dial_tiff_lzw", raw, len(raw), buf.ctypes.data, need)
        if got < 0:
            raise InvalidDocumentError("TIFF LZW data is corrupt")
        out = buf[:got].tobytes()
    elif c == 32773:
        buf = np.zeros(need, dtype=np.uint8)
        got = _native("dial_tiff_packbits", raw, len(raw), buf.ctypes.data, need)
        out = buf[:got].tobytes()
    else:  # 8, 32946
        try:
            out = zlib.decompressobj().decompress(raw, need)
        except zlib.error as e:
            raise InvalidDocumentError(f"TIFF Deflate data is corrupt: {e}") from e
    if len(out) < need:
        raise InvalidDocumentError("TIFF image data is truncated")
    return out


def _raw_rows(page: _Page, raw: bytes, rows: int, stride: int, keep: int) -> bytes:
    """The first ``keep`` bytes of each of ``rows`` rows ``stride`` bytes
    apart in an uncompressed strip or tile: what Pillow's raw reader takes
    of it for the part of the page it covers, and all it needs."""
    if page.fill == 2:
        raw = raw.translate(_REVERSED)
    if rows and (rows - 1) * stride + keep > len(raw):
        raise InvalidDocumentError("TIFF image data is truncated")
    a = np.frombuffer(raw, dtype=np.uint8)
    return np.lib.stride_tricks.as_strided(a, (rows, keep), (stride, 1)).tobytes()


def _jpeg_chunk(page: _Page, raw: bytes) -> np.ndarray:
    """A JPEG strip or tile's samples, [rows, cols, channels]."""
    from dial_rag_tpu_torch.image_processor.jpeg import decode_jpeg_raw

    tables = page.tags.get(347)
    if tables and len(tables) > 4 and raw[:2] == b"\xff\xd8":
        raw = bytes(tables[:-2]) + raw[2:]  # the tables' stream without its EOI, the strip's without its SOI
    samples = decode_jpeg_raw(raw)
    if samples.shape[2] == 4:
        samples = 255 - samples  # the core reads CMYK inverted (Adobe's convention); libtiff hands it as stored
    return samples


def _unpack(page: _Page, raw: bytes, rows: int, cols: int, bits: tuple) -> np.ndarray:
    """[rows, cols, len(bits)] samples (uint16 at 16 bits, native order) of
    a chunk's decoded bytes, the predictor undone."""
    depth, n = bits[0], len(bits)
    if depth >= 8:
        if depth == 16:
            a = np.frombuffer(raw, dtype=page.order + "u2", count=rows * cols * n).astype(np.uint16)
        else:
            a = np.frombuffer(raw, dtype=np.uint8, count=rows * cols * n)
        a = a.reshape(rows, cols, n)
        if page.predictor == 2 and page.compression in _PREDICTED:
            a = np.cumsum(a, axis=1, dtype=a.dtype)
        return a
    if page.predictor == 2 and page.compression in _PREDICTED:
        raise InvalidDocumentError(f"TIFF horizontal predictor with {depth}-bit samples is not defined")
    stride = (cols * depth * n + 7) // 8
    packed = np.frombuffer(raw, dtype=np.uint8, count=rows * stride).reshape(rows, stride)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    values = ((packed[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(rows, -1)[:, : cols * n]
    return values.reshape(rows, cols, n)


def _samples(data: bytes, page: _Page) -> np.ndarray:
    """The page's [H, W, samples] samples."""
    tags, w, h = page.tags, page.width, page.height
    planes = page.samples if page.planar == 2 and page.samples > 1 else 1
    bits = page.bits[:1] if planes > 1 else page.bits
    tiled = 324 in tags
    if tiled:
        cw, ch = tags.get(322, (0,))[0], tags.get(323, (0,))[0]
        offsets, counts = tags.get(324, ()), tags.get(325, ())
    else:
        cw, ch = w, min(tags.get(278, (h,))[0] or h, h)
        offsets, counts = tags.get(273, ()), tags.get(279, ())
    if not cw or not ch:
        raise InvalidDocumentError("TIFF tiles have no size")
    if tiled and page.compression != 1 and cw * ch > max(w * h, _MAX_TILE_PIXELS):
        raise InvalidDocumentError("TIFF tiles are larger than the image needs")
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise InvalidDocumentError("TIFF image has fewer strips than its size needs")
    dtype = np.uint16 if page.bits[0] == 16 else np.uint8
    out = np.zeros((h, w, page.samples), dtype=dtype)
    row_bytes = (cw * bits[0] * len(bits) + 7) // 8
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                k = plane * across * down + ty * across + tx
                raw = data[offsets[k]:offsets[k] + counts[k]]
                y0, x0 = ty * ch, tx * cw
                rows, cols = min(ch, h - y0), min(cw, w - x0)
                if page.compression == 1 and planes > 1 and bits[0] == 16:
                    # Pillow reads an uncompressed plane of 16-bit samples with its band's 8-bit raw mode:
                    # the strip's bytes, a byte a pixel
                    raw = _raw_rows(page, raw, rows, cw, cols)
                    part = np.frombuffer(raw, np.uint8).reshape(rows, cols, 1).astype(np.uint16) << 8
                elif page.compression == 1:  # only the rows and columns of the page
                    raw = _raw_rows(page, raw, rows, row_bytes, (cols * bits[0] * len(bits) + 7) // 8)
                    part = _unpack(page, raw, rows, cols, bits)
                else:
                    rows = ch if tiled else rows
                    if page.compression == 7:
                        chunk = _jpeg_chunk(page, raw)
                        if chunk.shape[0] < rows or chunk.shape[1] < cw or chunk.shape[2] != len(bits):
                            raise InvalidDocumentError("TIFF JPEG strip does not match its image")
                        chunk = chunk[:rows, :cw]
                    else:
                        chunk = _unpack(page, _decompress(page, raw, rows, row_bytes, cw * len(bits)), rows, cw,
                                        bits)
                    part = chunk[: h - y0, : w - x0]
                if planes > 1:
                    out[y0:y0 + part.shape[0], x0:x0 + part.shape[1], plane] = part[..., 0]
                else:
                    out[y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
    return out


def _colour_map(page: _Page) -> np.ndarray:
    """The palette as [2^bits, 3] high bytes of the 16-bit colour map."""
    values = np.asarray(page.tags.get(320, ()), dtype=np.int64)
    n = len(values) // 3
    table = np.zeros((256, 3), dtype=np.uint8)
    if n:
        table[: min(n, 256)] = (values[: 3 * n].reshape(3, n).T // 256)[:256]
    return table


def _decode_page(data: bytes, page: _Page) -> np.ndarray:
    """A page as RGB ([H, W, 3] uint8)."""
    mode = _mode(page)
    s = _samples(data, page)
    depth = page.bits[0]
    if mode == "gray":
        g = s[..., 0].astype(np.uint16)
        top = (1 << depth) - 1
        g = g * 255 // top
        if page.photometric == 0:
            g = 255 - g
        return np.repeat(g.astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "gray16":
        return np.repeat(np.minimum(s[..., :1], 255).astype(np.uint8), 3, axis=2)
    if mode == "gray16s":
        return np.repeat(np.clip(s[..., :1].view(np.int16), 0, 255).astype(np.uint8), 3, axis=2)
    if mode == "la":
        return np.repeat(s[..., :1], 3, axis=2)
    if mode == "palette":
        return _colour_map(page)[s[..., 0]]
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    if mode == "cmyk":
        from dial_rag_tpu_torch.image_processor.jpeg import cmyk_to_rgb

        return cmyk_to_rgb(s[..., :4])
    rgb = s[..., :3]
    if mode == "rgb_a":  # Pillow's RGBa: the associated alpha divided out
        a = s[..., 3:4].astype(np.int32)
        rgb = np.where(a == 0, 0, np.minimum(255, rgb.astype(np.int32) * 255 // np.maximum(a, 1)))
    return np.ascontiguousarray(rgb.astype(np.uint8))


def decode_tiff_pages(data: bytes, numbers: list[int] | None = None) -> list[np.ndarray]:
    """The RGB pages ``numbers`` (1-based; every page if None) in that order."""
    order, big, offsets = _chain(data)
    numbers = numbers or list(range(1, len(offsets) + 1))
    for number in numbers:
        if not 1 <= number <= len(offsets):
            raise InvalidDocumentError(f"page {number} out of range 1..{len(offsets)}")
    return [_decode_page(data, _page(data, order, big, offsets[n - 1])) for n in numbers]
