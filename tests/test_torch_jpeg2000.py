"""The port's JPEG 2000 decoder (``image_processor/jpeg2000.py`` on
``native/jpeg2000.cpp``) held against PIL (Pillow 12.1 on OpenJPEG 2.5.4,
the JAX package's path) on the CPU.

Tolerances, stated before any comparison:
- reversible images (5/3, RCT or no MCT): equal to PIL's pixels (0
  levels);
- irreversible images (9/7, ICT): equal expected; the gate is
  IRREVERSIBLE_LEVELS, and the count of differing samples is printed (a
  fixture past 0 is a fault to record, not a reason to widen the gate);
- truncated and corrupt files: the port raises InvalidDocumentError
  exactly where PIL fails, and decodes PIL's pixels where PIL decodes;
- Pillow's YCbCr conversion (``_ycbcr.py``): equal on every (Cb, Cr);
- page counts and pages of documents: equal to the JAX package's.
Inputs: the committed fixtures (tests/data/images, images_refused) and
seeded sets that PIL's save, OpenJPEG's encoder (``j2k_encoders``) and
codestream rewrites write here.
"""

import io
import random
import struct

import numpy as np
import pytest
from PIL import Image

from dial_rag_tpu.documents.mime import detect_mime as jax_detect_mime
from dial_rag_tpu.documents.mime import sniff_mime as jax_sniff_mime
from dial_rag_tpu.image_processor.extract_pages import _extract_pages_sync as jax_pages
from dial_rag_tpu.image_processor.extract_pages import extract_number_of_pages as jax_number_of_pages
from dial_rag_tpu_torch.documents.mime import detect_mime, sniff_mime
from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.image_processor import _ycbcr
from dial_rag_tpu_torch.image_processor.extract_pages import (
    _extract_pages_sync,
    decode_pages,
    extract_number_of_pages,
    page_count,
)
from dial_rag_tpu_torch.image_processor.jpeg2000 import decode_jpeg2000, is_jpeg2000, read_header
from tests.utils import j2k_encoders as je
from tests.utils.make_image_fixtures import IMAGES, REFUSED, refused_fixtures
from tests.utils.make_jpeg_fixtures import photo

IRREVERSIBLE_LEVELS = 1


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_as_pil(data: bytes, irreversible: bool = False, what: str = "") -> None:
    """The port decodes PIL's pixels (within the gates), or raises
    InvalidDocumentError where PIL fails (OpenJPEG's encoder writes some
    files its decoder refuses, such as code-blocks of 4 x 8 in 16 x 16
    precincts with RPCL)."""
    state, ref = outcome(pil_rgb, data)
    if state != "ok":
        print(f"{what}: PIL fails ({state})")
        with pytest.raises(InvalidDocumentError):
            decode_jpeg2000(data)
        return
    ref = ref.astype(np.int64)
    got = decode_jpeg2000(data).astype(np.int64)
    assert got.shape == ref.shape, what
    gap = int(np.abs(got - ref).max())
    if irreversible:
        print(f"{what}: largest difference {gap}, {int((got != ref).sum())} samples differ")
        assert gap <= IRREVERSIBLE_LEVELS, what
    else:
        assert gap == 0, what


def outcome(fn, data: bytes):
    try:
        return "ok", fn(data)
    except Exception as e:  # noqa: BLE001 - which error is the point
        return type(e).__name__, None


def rgb_components(h: int, w: int, seed: int) -> list[np.ndarray]:
    a = photo(h, w, seed)
    return [a[..., c].astype(np.int32) for c in range(3)]


# -- what PIL's save writes ------------------------------------------------------------

SAVE_OPTIONS = [
    {},
    {"irreversible": True},
    {"no_jp2": True, "mct": 1},
    {"irreversible": True, "mct": 1, "quality_layers": [50, 20, 5]},
    {"tile_size": (20, 16), "tile_offset": (5, 3), "offset": (11, 7)},
    {"irreversible": True, "tile_size": (32, 32), "offset": (1, 1), "no_jp2": True},
    {"num_resolutions": 1},
    {"num_resolutions": 2, "irreversible": True},
    {"codeblock_size": (4, 8), "precinct_size": (16, 16), "progression": "RPCL"},
    {"codeblock_size": (16, 16), "precinct_size": (32, 64), "progression": "PCRL", "irreversible": True},
    {"progression": "RLCP", "quality_layers": [30, 10, 0]},
    {"progression": "CPRL", "codeblock_size": (8, 8)},
    {"plt": True, "signed": True},
    {"signed": True, "irreversible": True},
]


@pytest.mark.parametrize("k", range(len(SAVE_OPTIONS)))
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_files_pil_writes_match_pil(k, mode):
    options = SAVE_OPTIONS[k]
    rng = np.random.default_rng(100 + k)
    h, w = (int(v) for v in rng.integers(33, 90, 2))
    buf = io.BytesIO()
    Image.fromarray(photo(h, w, k)).convert(mode).save(buf, "JPEG2000", **options)
    assert_as_pil(buf.getvalue(), options.get("irreversible", False), f"{mode} {options}")


@pytest.mark.parametrize("mode", ["LA", "RGBA", "I;16"])
def test_alpha_and_sixteen_bit_files_match_pil(mode):
    """LA and RGBA drop their alpha; a 16-bit gray image clamps at 255, as
    Pillow's I;16 -> RGB does."""
    a = photo(30, 41, 7)
    image = {"LA": lambda: Image.fromarray(a[..., :2].copy(), "LA"),
             "RGBA": lambda: Image.fromarray(np.dstack([a, a[..., :1]]), "RGBA"),
             "I;16": lambda: Image.fromarray(a[..., 0].astype(np.uint16) * 251)}[mode]()
    for irreversible in (False, True):
        buf = io.BytesIO()
        image.save(buf, "JPEG2000", irreversible=irreversible)
        assert_as_pil(buf.getvalue(), irreversible, mode)


# -- what OpenJPEG's encoder writes beyond Pillow's save -----------------------------------

STYLES = [je.BYPASS, je.RESET, je.TERMALL, je.VSC, je.PTERM, je.SEGSYM, 63, je.BYPASS | je.TERMALL,
          je.BYPASS | je.VSC | je.SEGSYM]


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("style", STYLES)
def test_code_block_styles_match_pil(style, irreversible):
    comps = rgb_components(37, 45, style)
    data = je.j2k_encode(comps, style=style, irreversible=irreversible, mct=1, codeblock=(16, 8),
                         layers=[25.0, 6.0] if irreversible else [15.0, 0.0])
    assert je.segments(data)[0][1][1][8] == style  # COD's code-block style byte
    assert_as_pil(data, irreversible, f"style {style}")


@pytest.mark.parametrize("case", ["sop_eph", "ppm", "ppt", "poc", "rgn", "tile_parts_R", "tile_parts_L",
                                  "tile_parts_C", "coc_qcc", "derived"])
def test_marker_segments_match_pil(case):
    comps = rgb_components(41, 52, 9)
    if case in ("sop_eph", "ppm", "ppt"):
        data = je.j2k_encode(comps, sop=True, eph=True, codeblock=(8, 8), layers=[20.0, 0.0], tile=(24, 32),
                             progression="RLCP")
        if case != "sop_eph":
            data = je.packed_headers(data, case)
            assert bytes([0xFF, 0x60 if case == "ppm" else 0x61]) in data
    elif case == "poc":
        data = je.j2k_encode(comps, precincts=[(16, 16)] * 4, codeblock=(8, 8), resolutions=4, layers=[30.0, 0.0],
                             pocs=[(1, 0, 0, 2, 2, 2, "PCRL"), (1, 0, 2, 1, 4, 3, "RPCL"), (1, 0, 0, 2, 4, 3, "LRCP")])
        assert b"\xff\x5f" in data
    elif case == "rgn":
        data = je.j2k_encode(comps, roi=(0, 6), codeblock=(16, 16), layers=[10.0, 0.0])
        assert b"\xff\x5e" in data
    elif case.startswith("tile_parts"):
        data = je.j2k_encode(comps, tile=(24, 24), tile_parts=case[-1], layers=[20.0, 8.0, 0.0])
        assert len(je.tile_parts(data)) > 4
    elif case == "coc_qcc":
        data = je.j2k_encode(comps)
        segs = dict(je.segments(data)[0])
        data = je.add_segments(data, [(0xFF53, bytes([2]) + segs[0xFF52][4:]), (0xFF5D, bytes([1]) + segs[0xFF5C])])
    else:
        data = je.j2k_encode(comps, irreversible=True, resolutions=1, layers=[12.0])
        qcd = bytearray(dict(je.segments(data)[0])[0xFF5C])
        qcd[0] = (qcd[0] & 0xE0) | 1  # derived from the one step it expounds
        data = je.replace_segment(data, 0xFF5C, bytes(qcd))
    assert_as_pil(data, case == "derived", case)


@pytest.mark.parametrize("precision", [1, 2, 5, 7, 9, 12, 16])
def test_precisions_and_signs_match_pil(precision):
    """A gray component at 1-16 bits, unsigned and signed (Pillow shifts
    each to 8 bits, above 8 with rounding; a signed sample reads as its
    value plus half its range), in a codestream and in JP2 (whose ihdr
    makes a 9-bit component L, not I;16)."""
    g = (photo(30, 37, precision)[..., 0].astype(np.int32) * ((1 << precision) - 1)) // 255
    for signed in (False, True):
        data = je.j2k_encode([g - (1 << (precision - 1)) if signed else g], precision=precision, signed=signed)
        assert_as_pil(data, what=f"{precision} bits signed={signed}")
        assert_as_pil(je.jp2(data), what=f"{precision} bits signed={signed} JP2")


@pytest.mark.parametrize("factors", [(2, 2), (2, 1), (1, 2)])
@pytest.mark.parametrize("size", [(44, 60), (45, 61)])
def test_subsampled_components_match_pil(factors, size):
    """Pillow reads a bare codestream whose chroma is subsampled as sYCC
    and a JP2 marked sRGB as RGB, each plane at (w / dx) x (h / dy)
    samples of the tile, which is not what the decoder wrote where the
    tile's sizes are odd."""
    h, w = size
    dx, dy = factors
    a = photo(h, w, dx + 2 * dy)
    comps = [a[..., 0].astype(np.int32)] + [a[::dy, ::dx, c].astype(np.int32) for c in (1, 2)]
    data = je.j2k_encode(comps, subsampling=[(1, 1), factors, factors])
    assert_as_pil(data, what=f"bare {factors} {size}")
    assert_as_pil(je.jp2(data), what=f"JP2 {factors} {size}")


@pytest.mark.parametrize("enumcs", [12, 16, 17, 18, 24, 0, 3])
def test_jp2_colour_spaces_match_pil(enumcs):
    """colr's enumerated colour space, on 1, 3 and 4 components: decoded
    as PIL decodes it, or refused where PIL fails."""
    comps = rgb_components(25, 33, enumcs)
    for n in (1, 3, 4):
        data = je.jp2(je.j2k_encode((comps + comps[:1])[:n]), colr=struct.pack(">BBBI", 1, 0, 0, enumcs))
        ref, got = outcome(pil_rgb, data), outcome(decode_jpeg2000, data)
        if ref[0] != "ok":
            assert got[0] == "InvalidDocumentError", (enumcs, n, ref[0], got[0])
        else:
            assert got[0] == "ok" and np.array_equal(got[1], ref[1]), (enumcs, n)


def test_jp2_boxes_match_pil():
    """pclr (Pillow's palette built with getcolor: a repeated colour
    reuses its first index), cmap, cdef (not applied), an ICC colr and no
    colr at all; malformed pclr and cmap boxes fail as OpenJPEG fails, a
    palette of more than 256 colours as Pillow's getcolor fails."""
    indexes = (photo(30, 40, 1)[..., 0] // 16).astype(np.int32)
    entries = [(16 * i, 255 - 16 * i, 40 * i % 256) for i in range(16)]
    entries[3] = entries[11] = entries[7]
    pal = je.j2k_encode([indexes], precision=4)
    srgb = struct.pack(">BBBI", 1, 0, 0, 16)
    good = {"pclr": je.jp2(pal, colr=srgb, pclr=([7, 7, 7], entries), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
            "pclr no cmap": je.jp2(pal, colr=srgb, pclr=([7, 7, 7], entries)),
            "cdef": je.jp2(je.j2k_encode(rgb_components(20, 30, 2)), cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)]),
            "icc": je.jp2(je.j2k_encode(rgb_components(20, 30, 3)), colr=bytes([2, 0, 0]) + bytes(24)),
            "no colr": je.jp2(je.j2k_encode(rgb_components(20, 30, 4)[:1]), colr=b"")}
    for name, data in good.items():
        assert_as_pil(data, what=name)
    bad = {"pclr 9-bit entries a byte each": je.jp2(pal, colr=srgb, pclr=([8, 8, 8], entries)),
           "cmap short": je.jp2(pal, colr=srgb, pclr=([7, 7, 7], entries), cmap=[(0, 0, 0)]),
           "pclr on gray": je.jp2(pal, pclr=([7, 7, 7], entries), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
           "pclr of 300 colours": je.jp2(je.j2k_encode([indexes * 18], precision=9), colr=srgb,
                                         pclr=([7, 7, 7], [(i % 256, i // 256, 7) for i in range(300)]),
                                         cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])}
    for name, data in bad.items():
        assert outcome(pil_rgb, data)[0] != "ok", name
        with pytest.raises(InvalidDocumentError):
            decode_jpeg2000(data)


# -- the committed fixtures ------------------------------------------------------------

def test_committed_fixtures_carry_what_their_names_say():
    """Each JPEG 2000 fixture exercises its feature: the code-block style
    byte, SOP and EPH, PPM, PPT, POC, RGN, COC and QCC, derived
    quantization, tile-parts, subsampling, the JP2 boxes."""
    read = {p.name: p.read_bytes() for p in IMAGES.iterdir() if p.name.startswith("j2k_")}

    def codestream(data):
        return data if data[:4] == b"\xff\x4f\xff\x51" else data[data.index(b"jp2c") + 4:]

    def cod(name):
        return dict(je.segments(codestream(read[name]))[0])[0xFF52]

    assert cod("j2k_style_all_styles.j2k")[8] == 63
    assert cod("j2k_style_bypass_termall_97.j2k")[8] == je.BYPASS | je.TERMALL
    assert cod("j2k_sop_eph.j2k")[0] & 6 == 6
    markers = {"j2k_ppm.j2k": b"\xff\x60", "j2k_ppt.j2k": b"\xff\x61", "j2k_poc.j2k": b"\xff\x5f",
               "j2k_rgn.j2k": b"\xff\x5e", "j2k_coc_qcc.j2k": b"\xff\x53", "j2k_cdef.jp2": b"cdef",
               "j2k_palette.jp2": b"pclr"}
    for name, marker in markers.items():
        assert marker in read[name], name
    assert dict(je.segments(read["j2k_derived_97.j2k"])[0])[0xFF5C][0] & 31 == 1
    assert len(je.tile_parts(read["j2k_tile_parts.j2k"])) > len({t for t, _, _ in je.tile_parts(
        read["j2k_tile_parts.j2k"])})
    siz = dict(je.segments(read["j2k_subsampled_ycc.j2k"])[0])[0xFF51]
    assert siz[37:39] == b"\x01\x01" and siz[40:42] == b"\x02\x02"
    for name in ("j2k_rgb_97.j2k", "j2k_layers_97.jp2", "j2k_derived_97.j2k"):
        assert cod(name)[9] == 0, name  # the 9/7 wavelet


def test_committed_refused_files_are_what_the_maker_writes():
    files = refused_fixtures()
    assert sorted(files) == sorted(p.name for p in REFUSED.iterdir())
    for name, data in files.items():
        assert (REFUSED / name).read_bytes() == data, name


@pytest.mark.parametrize("name", sorted(p.name for p in REFUSED.iterdir()))
def test_files_pil_refuses_the_port_refuses(name):
    """What PIL cannot open or decode (a 12-bit, hierarchical, lossless
    arithmetic, 2-component or lossless YCbCr JPEG; a JPEG 2000 palette on
    a gray colour space, gray colr on RGB, 5 components, a truncated
    codestream) raises InvalidDocumentError in the port: as an image
    document, its page count or its pages."""
    data = (REFUSED / name).read_bytes()
    assert outcome(pil_rgb, data)[0] != "ok"
    with pytest.raises(InvalidDocumentError):
        page_count(data)
        decode_pages(data)


# -- truncation, corruption, limits ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["tiled", "jp2_97"])
def test_truncated_files_fail_where_pil_fails(kind):
    comps = rgb_components(40, 50, 11)
    if kind == "tiled":
        data = je.j2k_encode(comps, tile=(24, 24), tile_parts="R", layers=[20.0, 0.0])
    else:
        data = je.jp2(je.j2k_encode(comps, irreversible=True, layers=[30.0, 10.0]))
    cuts = sorted({0, 2, 10, 40, 90, len(data) // 3, len(data) // 2, len(data) - 40, len(data) - 3,
                   len(data) - 2, len(data) - 1} | set(range(100, len(data), 397)))
    for cut in cuts:
        ref, got = outcome(pil_rgb, data[:cut]), outcome(decode_jpeg2000, data[:cut])
        if ref[0] == "ok":
            assert got[0] == "ok" and np.array_equal(got[1], ref[1]), (kind, cut)
        else:
            assert got[0] == "InvalidDocumentError", (kind, cut, ref[0], got[0])


def test_corrupt_bytes_never_crash_and_fail_where_pil_fails():
    """Seeded byte flips in a tiled codestream of every code-block style:
    each decodes to PIL's pixels or raises InvalidDocumentError where PIL
    fails, unless a flip turned on what the port leaves out (a flipped COD
    byte asking for the high-throughput coder, which OpenJPEG reads):
    then NotPortedError naming item 9d."""
    data = je.j2k_encode(rgb_components(40, 50, 12), tile=(24, 24), style=63, layers=[30.0, 0.0])
    rng = random.Random(28)
    seen = set()
    for _ in range(120):
        b = bytearray(data)
        for _ in range(rng.randint(1, 6)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        ref, got = outcome(pil_rgb, bytes(b)), outcome(decode_jpeg2000, bytes(b))
        if got[0] == "NotPortedError":
            with pytest.raises(NotPortedError, match="9d"):
                decode_jpeg2000(bytes(b))
        elif ref[0] == "ok":
            assert got[0] == "ok" and np.array_equal(got[1], ref[1])
        else:
            assert got[0] == "InvalidDocumentError", (ref[0], got[0])
        seen.add(ref[0])
    assert "ok" in seen and len(seen) > 1


def test_decompression_bomb_limit_is_pillows():
    data = je.j2k_encode([np.zeros((8, 8), np.int32)])
    segs = dict(je.segments(data)[0])
    siz = bytearray(segs[0xFF51])
    siz[2:10] = struct.pack(">II", 20000, 20000)
    siz[18:26] = struct.pack(">II", 20000, 20000)
    bomb = je.replace_segment(data, 0xFF51, bytes(siz))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bomb))
    with pytest.raises(InvalidDocumentError, match="bomb"):
        read_header(bomb)
    with pytest.raises(InvalidDocumentError, match="bomb"):
        decode_jpeg2000(bomb)


def test_corners_left_out_raise_item_9d():
    """The high-throughput block coder (Part 15), a Part 2 Rsiz and a
    subsampled tile Pillow reads past the decoded samples of raise
    NotPortedError naming ROADMAP item 9d."""
    data = je.j2k_encode(rgb_components(24, 24, 13))
    segs = dict(je.segments(data)[0])
    cod = bytearray(segs[0xFF52])
    cod[8] |= 0x40
    with pytest.raises(NotPortedError, match="9d"):
        decode_jpeg2000(je.replace_segment(data, 0xFF52, bytes(cod)))
    siz = bytearray(segs[0xFF51])
    siz[0] |= 0x80
    with pytest.raises(NotPortedError, match="9d"):
        decode_jpeg2000(je.replace_segment(data, 0xFF51, bytes(siz)))
    a = photo(44, 60, 14)
    comps = [a[..., 0].astype(np.int32)] + [a[::3, ::3, c].astype(np.int32) for c in (1, 2)]
    with pytest.raises(NotPortedError, match="9d"):
        decode_jpeg2000(je.j2k_encode(comps, subsampling=[(1, 1), (3, 3), (3, 3)], tile=(16, 16)))


def test_ycbcr_tables_are_pillows():
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    r_cr, b_cb, g_cb, g_cr = (np.array(t) for t in (_ycbcr.R_CR, _ycbcr.B_CB, _ycbcr.G_CB, _ycbcr.G_CR))
    for y in (0, 1, 77, 128, 200, 254, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        ref = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB")).astype(np.int64)
        got = np.stack([np.clip(y + r_cr[cr], 0, 255), np.clip(y + ((g_cb[cb] + g_cr[cr]) >> 6), 0, 255),
                        np.clip(y + b_cb[cb], 0, 255)], -1)
        assert np.array_equal(got, ref), y


# -- mime and documents -----------------------------------------------------------------------

def test_sniff_and_detect_mime_are_unchanged():
    """JPEG 2000 bytes keep the mime the JAX package gives them (no image
    mime of the service's: they reach the port inside PDFs), and the
    image-document path reads them by their magic when a declared image
    mime sends them there, as PIL does."""
    codestream = je.j2k_encode(rgb_components(20, 24, 15))
    for data in (codestream, je.jp2(codestream)):
        assert is_jpeg2000(data)
        assert sniff_mime(data) == jax_sniff_mime(data)
        for declared, name in ((None, "a.jp2"), (None, "a.j2k"), ("image/jp2", None), ("image/png", "a.png")):
            assert detect_mime(declared, name, data) == jax_detect_mime(declared, name, data)
        assert extract_number_of_pages("image/png", data) == jax_number_of_pages("image/png", data) == 1
        ref = jax_pages("image/png", data, None, None)
        got = _extract_pages_sync("image/png", data, None, None)
        assert len(got) == len(ref) == 1 and np.array_equal(got[0], np.asarray(ref[0]))
