"""JPEG 2000 files Pillow's save does not write, for the port's JPEG 2000
tests and fixtures:

- ``j2k_encode`` drives Pillow's bundled OpenJPEG encoder through ctypes
  with the options Pillow does not pass on: code-block styles (bypass,
  reset, termall, vertically causal, predictable termination,
  segmentation symbols), SOP and EPH markers, progression order changes
  (POC), a max-shift region of interest (RGN), tile-parts, components
  subsampled or of their own precision and sign;
- ``packed_headers`` moves the packet headers of a codestream written with
  SOP and EPH into PPM or PPT segments;
- ``jp2`` wraps a codestream in JP2 boxes (``ihdr``, ``colr``, ``pclr``,
  ``cmap``, ``cdef``) written here;
- ``add_segments`` puts marker segments (COC, QCC, RGN, COM, ...) into a
  main header, ``with_siz_precision`` rewrites a component's precision.
numpy and the standard library only (and PIL's shared library)."""

import ctypes
import glob
import os
import struct

import numpy as np

_lib = None
# opj_cparameters_t field offsets (OpenJPEG 2.5, x86-64), checked against
# opj_set_default_encoder_parameters' defaults in _params()
_OFF = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16, "cp_disto_alloc": 20,
        "csty": 48, "prog_order": 52, "POC": 56, "numpocs": 4792, "tcp_numlayers": 4796, "tcp_rates": 4800,
        "numresolution": 5600, "cblockw_init": 5604, "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
        "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632, "prch_init": 5764,
        "image_offset_x0": 18188, "image_offset_y0": 18192, "subsampling_dx": 18196, "decod_format": 18204,
        "cod_format": 18208, "tp_on": 18696, "tp_flag": 18697, "tcp_mct": 18698}
_PARAMS_SIZE = 18720
_POC_SIZE = 148  # opj_poc_t
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
# code-block style bits (COD's SPcod)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


def _load():
    global _lib
    if _lib is None:
        import PIL

        libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
        _lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2-*.so*"))[0])
        _lib.opj_image_create.restype = ctypes.c_void_p
        _lib.opj_create_compress.restype = ctypes.c_void_p
        _lib.opj_stream_create.restype = ctypes.c_void_p
        for name in ("opj_setup_encoder", "opj_start_compress", "opj_encode", "opj_end_compress"):
            getattr(_lib, name).argtypes = [ctypes.c_void_p] * (3 if name in ("opj_setup_encoder",
                                                                              "opj_start_compress") else 2)
        _lib.opj_stream_set_write_function.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _lib.opj_stream_set_skip_function.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _lib.opj_stream_set_seek_function.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
        _lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
        _lib.opj_image_destroy.argtypes = [ctypes.c_void_p]
    return _lib


def _params():
    buf = ctypes.create_string_buffer(_PARAMS_SIZE)
    _load().opj_set_default_encoder_parameters(buf)

    def get(name):
        return ctypes.c_int.from_buffer(buf, _OFF[name]).value

    defaults = {"numresolution": 6, "cblockw_init": 64, "cblockh_init": 64, "roi_compno": -1,
                "subsampling_dx": 1, "decod_format": -1, "cod_format": -1}
    if any(get(k) != v for k, v in defaults.items()):
        raise RuntimeError("opj_cparameters_t's layout is not the one this encoder was written for")
    return buf


def _set(buf, name: str, value, index: int = 0, ctype=ctypes.c_int):
    ctype.from_buffer(buf, _OFF[name] + index * ctypes.sizeof(ctype)).value = value


_WRITE = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p)
_SKIP = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)
_SEEK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)


def j2k_encode(components: list[np.ndarray], *, precision: list[int] | int = 8, signed: list[bool] | bool = False,
               subsampling: list[tuple[int, int]] | None = None, offset: tuple[int, int] = (0, 0),
               tile: tuple[int, int] | None = None, tile_offset: tuple[int, int] = (0, 0),
               resolutions: int | None = None, codeblock: tuple[int, int] = (64, 64),
               precincts: list[tuple[int, int]] | None = None, irreversible: bool = False, mct: int = 0,
               progression: str = "LRCP", layers: list[float] | None = None, style: int = 0,
               sop: bool = False, eph: bool = False, pocs: list[tuple[int, ...]] | None = None,
               roi: tuple[int, int] | None = None, tile_parts: str | None = None) -> bytes:
    """A raw codestream of ``components`` (each an int array at its own
    subsampled size) by OpenJPEG's encoder. ``pocs`` holds (tile (1-based),
    res start, comp start, layer end, res end, comp end, progression)
    tuples; ``roi`` (component, shift); ``tile_parts`` "R", "L" or "C";
    ``layers`` compression rates, one a layer (0 for lossless)."""
    lib = _load()
    n = len(components)
    precision = [precision] * n if isinstance(precision, int) else precision
    signed = [signed] * n if isinstance(signed, bool) else signed
    subsampling = subsampling or [(1, 1)] * n
    h0, w0 = components[0].shape
    dx0, dy0 = subsampling[0]
    x1, y1 = offset[0] + w0 * dx0, offset[1] + h0 * dy0
    parms = (ctypes.c_uint32 * (9 * n))()
    for c, comp in enumerate(components):
        dx, dy = subsampling[c]
        w, h = -(-x1 // dx) - -(-offset[0] // dx), -(-y1 // dy) - -(-offset[1] // dy)
        if comp.shape != (h, w):
            raise ValueError(f"component {c} is {comp.shape}, its grid {(h, w)}")
        parms[9 * c:9 * c + 9] = [dx, dy, w, h, -(-offset[0] // dx), -(-offset[1] // dy), precision[c], precision[c],
                                  int(signed[c])]
    color_space = 2 if n <= 2 else 1  # gray, sRGB
    image = lib.opj_image_create(n, parms, color_space)
    if not image:
        raise RuntimeError("opj_image_create failed")
    ctypes.c_uint32.from_address(image).value = offset[0]
    ctypes.c_uint32.from_address(image + 4).value = offset[1]
    ctypes.c_uint32.from_address(image + 8).value = x1
    ctypes.c_uint32.from_address(image + 12).value = y1
    comps = ctypes.c_void_p.from_address(image + 24).value
    for c, comp in enumerate(components):
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        flat = np.ascontiguousarray(comp, dtype=np.int32).reshape(-1)
        ctypes.memmove(data, flat.ctypes.data, flat.nbytes)
    if resolutions is None:  # as many as the smallest tile takes, at most 6
        resolutions = min(6, min(tile or (x1 - offset[0], y1 - offset[1])).bit_length())
    p = _params()
    _set(p, "numresolution", resolutions)
    _set(p, "cblockw_init", codeblock[0])
    _set(p, "cblockh_init", codeblock[1])
    _set(p, "irreversible", int(irreversible))
    _set(p, "prog_order", PROGRESSIONS.index(progression))
    _set(p, "mode", style)
    _set(p, "tcp_mct", mct, ctype=ctypes.c_char)
    _set(p, "image_offset_x0", offset[0])
    _set(p, "image_offset_y0", offset[1])
    csty = (2 if sop else 0) | (4 if eph else 0)
    if precincts:
        csty |= 1
        _set(p, "res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            _set(p, "prcw_init", pw, i)
            _set(p, "prch_init", ph, i)
    _set(p, "csty", csty)
    rates = layers or [0.0]
    _set(p, "tcp_numlayers", len(rates))
    for i, r in enumerate(rates):
        _set(p, "tcp_rates", r, i, ctypes.c_float)
    _set(p, "cp_disto_alloc", 1)
    if tile:
        _set(p, "tile_size_on", 1)
        _set(p, "cp_tdx", tile[0])
        _set(p, "cp_tdy", tile[1])
        _set(p, "cp_tx0", tile_offset[0])
        _set(p, "cp_ty0", tile_offset[1])
    if roi:
        _set(p, "roi_compno", roi[0])
        _set(p, "roi_shift", roi[1])
    if tile_parts:
        _set(p, "tp_on", 1, ctype=ctypes.c_char)
        _set(p, "tp_flag", tile_parts.encode(), ctype=ctypes.c_char)
    if pocs:
        _set(p, "numpocs", len(pocs))
        for i, (tileno, rs, cs, le, re, ce, prg) in enumerate(pocs):
            base = _OFF["POC"] + i * _POC_SIZE
            for off, v in ((0, rs), (4, cs), (8, le), (12, re), (16, ce), (32, PROGRESSIONS.index(prg)), (48, tileno)):
                ctypes.c_uint32.from_buffer(p, base + off).value = v
    out = bytearray()
    cursor = [0]

    def write(buf, size, user):
        at = cursor[0]
        if len(out) < at + size:
            out.extend(b"\0" * (at + size - len(out)))
        out[at:at + size] = ctypes.string_at(buf, size)
        cursor[0] += size
        return size

    def skip(size, user):
        cursor[0] += size
        return size

    def seek(at, user):
        cursor[0] = at
        return 1

    callbacks = (_WRITE(write), _SKIP(skip), _SEEK(seek))
    codec = lib.opj_create_compress(0)
    stream = lib.opj_stream_create(1 << 20, 0)
    try:
        lib.opj_stream_set_write_function(stream, ctypes.cast(callbacks[0], ctypes.c_void_p))
        lib.opj_stream_set_skip_function(stream, ctypes.cast(callbacks[1], ctypes.c_void_p))
        lib.opj_stream_set_seek_function(stream, ctypes.cast(callbacks[2], ctypes.c_void_p))
        if not lib.opj_setup_encoder(codec, p, image):
            raise RuntimeError("opj_setup_encoder failed")
        if not (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise RuntimeError("OpenJPEG's encoder failed")
    finally:
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
    return bytes(out)


# -- codestream rewrites -----------------------------------------------------------

def segments(codestream: bytes) -> tuple[list[tuple[int, bytes]], int]:
    """The main header's marker segments after SOC as (marker, payload),
    and the offset of the first SOT."""
    out, at = [], 2
    while True:
        (marker,) = struct.unpack_from(">H", codestream, at)
        if marker == 0xFF90:
            return out, at
        (length,) = struct.unpack_from(">H", codestream, at + 2)
        out.append((marker, codestream[at + 4:at + 2 + length]))
        at += 2 + length


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def add_segments(codestream: bytes, extra: list[tuple[int, bytes]], before_first_of: int | None = None) -> bytes:
    """``codestream`` with ``extra`` segments at the end of its main header
    (or before its first ``before_first_of`` segment)."""
    segs, sot = segments(codestream)
    at = len(segs)
    if before_first_of is not None:
        at = next(i for i, (m, _) in enumerate(segs) if m == before_first_of)
    segs = segs[:at] + list(extra) + segs[at:]
    return codestream[:2] + b"".join(_segment(m, p) for m, p in segs) + codestream[sot:]


def replace_segment(codestream: bytes, marker: int, payload: bytes) -> bytes:
    segs, sot = segments(codestream)
    segs = [(m, payload if m == marker else p) for m, p in segs]
    return codestream[:2] + b"".join(_segment(m, p) for m, p in segs) + codestream[sot:]


def with_siz_precision(codestream: bytes, precisions: list[int], signed: list[bool] | None = None) -> bytes:
    """``codestream`` with each component's Ssiz rewritten (its samples
    then read at that precision and sign)."""
    segs, _ = segments(codestream)
    siz = bytearray(dict(segs)[0xFF51])
    for c, prec in enumerate(precisions):
        siz[36 + 3 * c] = (prec - 1) | (0x80 if signed and signed[c] else 0)
    return replace_segment(codestream, 0xFF51, bytes(siz))


def tile_parts(codestream: bytes) -> list[tuple[int, bytes, bytes]]:
    """(Isot, tile-part header segments, bitstream) of each tile-part."""
    _, at = segments(codestream)
    out = []
    while at + 12 <= len(codestream) and codestream[at:at + 2] == b"\xff\x90":
        isot, psot = struct.unpack_from(">HI", codestream, at + 4)
        end = at + psot
        sod = codestream.index(b"\xff\x93", at + 12)
        out.append((isot, codestream[at + 12:sod], codestream[sod + 2:end]))
        at = end
    return out


def _split_packets(bitstream: bytes) -> list[tuple[bytes, bytes]]:
    """(header, body) of each packet of a bitstream written with SOP and
    EPH (neither marker can occur inside a header or a body)."""
    out = []
    starts = [i for i in range(len(bitstream) - 1) if bitstream[i] == 0xFF and bitstream[i + 1] == 0x91]
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(bitstream)
        packet = bitstream[s + 6:end]
        eph = packet.index(b"\xff\x92")
        out.append((packet[:eph], packet[eph + 2:end]))
    return out


def packed_headers(codestream: bytes, where: str) -> bytes:
    """A codestream written with SOP and EPH, its packet headers moved into
    PPM segments of the main header (``where`` "ppm") or PPT segments of
    each tile-part header ("ppt"), SOP and EPH dropped from COD."""
    segs, _ = segments(codestream)
    cod = bytearray(dict(segs)[0xFF52])
    cod[0] &= ~6
    parts = tile_parts(codestream)
    split = [(isot, header, _split_packets(bits)) for isot, header, bits in parts]
    main = [(m, bytes(cod) if m == 0xFF52 else p) for m, p in segs]
    if where == "ppm":
        ppm = b"".join(struct.pack(">I", sum(len(h) for h, _ in packets)) + b"".join(h for h, _ in packets)
                       for _, _, packets in split)
        # two PPM segments, the second carrying on mid-stream (Nppm spans them)
        half = len(ppm) // 2
        main += [(0xFF60, bytes([0]) + ppm[:half]), (0xFF60, bytes([1]) + ppm[half:])]
    out = [codestream[:2], b"".join(_segment(m, p) for m, p in main)]
    for k, (isot, header, packets) in enumerate(split):
        body = b"".join(b for _, b in packets)
        tp_header = header
        if where == "ppt":
            heads = b"".join(h for h, _ in packets)
            half = len(heads) // 2
            tp_header += _segment(0xFF61, bytes([0]) + heads[:half]) + _segment(0xFF61, bytes([1]) + heads[half:])
        tpsot = sum(1 for t, _, _ in split[:k] if t == isot)  # the tile's parts before this one
        tnsot = sum(1 for t, _, _ in split if t == isot)
        out.append(struct.pack(">HHHIBB", 0xFF90, 10, isot, len(tp_header) + len(body) + 14, tpsot, tnsot)
                   + tp_header + b"\xff\x93" + body)
    out.append(b"\xff\xd9")
    return b"".join(out)


# -- JP2 boxes ----------------------------------------------------------------------

def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + kind + payload


def jp2(codestream: bytes, *, colr: bytes | None = None, pclr: tuple[list[int], list[tuple[int, ...]]] | None = None,
        cmap: list[tuple[int, int, int]] | None = None, cdef: list[tuple[int, int, int]] | None = None,
        ihdr_components: int | None = None, ihdr_bpc: int | None = None) -> bytes:
    """``codestream`` in a JP2 file: ``ihdr`` from its SIZ (or the given
    component count and bit depth field), then ``colr`` (an enumerated
    colour space by default: sRGB, or gray for 1-2 components), ``pclr``
    ((bit depths, entries)), ``cmap`` ((component, type, palette column))
    and ``cdef`` ((channel, type, association)) as given."""
    segs, _ = segments(codestream)
    siz = dict(segs)[0xFF51]
    xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", siz, 2)
    (csiz,) = struct.unpack_from(">H", siz, 34)
    nc = csiz if ihdr_components is None else ihdr_components
    bpc = siz[36] if ihdr_bpc is None else ihdr_bpc
    header = box(b"ihdr", struct.pack(">IIHBBBB", ysiz - yo, xsiz - xo, nc, bpc, 7, 0, 0))
    if colr is None:
        colr = struct.pack(">BBBI", 1, 0, 0, 17 if csiz <= 2 else 16)
    if colr:
        header += box(b"colr", colr)
    if pclr:
        depths, entries = pclr
        header += box(b"pclr", struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
                      + b"".join(bytes(e) for e in entries))
    if cmap:
        header += box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap))
    if cdef:
        header += box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(struct.pack(">HHH", *d) for d in cdef))
    return (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a" + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + box(b"jp2h", header) + box(b"jp2c", codestream))
