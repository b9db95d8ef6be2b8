"""Writes the image fixtures of ``tests/data/images/`` with PIL's decode of
each (``decoded.npz``: ``Image.open(...).convert("RGB")``, a GIF's frame
``n`` under ``<file>@<n>``), and the JAX package's HTML elements of the
documents ``tests/utils/html_docs.py`` builds from the corpus's chunks,
with the digest of its elements of each page ``tests/utils/html_pages.py``
generates (``tests/data/html/oracle.json``), so that a machine without
PIL, bs4 and lxml (the card's, in chip_smoke.py) can hold the port's
decoders and HTML parser against them.

It also writes ``tests/data/image_rates/``: documents at the sizes users
attach (an A4 fax page, 1024 x 768 screenshots and photographs, a 640 x
480 APNG), on which chip_smoke.py times the host decoders, with the
sha256 of each of PIL's pages (``digests.json``).

PIL writes the progressive JPEGs, the 1-bit BMP and one animated GIF;
``tests/utils/image_encoders.py`` writes what PIL cannot: Adam7 PNGs,
4- and 16-bit and RLE BMPs (OS/2 headers too) and a GIF with every
disposal method, local palettes, transparency and interlace. Run from
the repository root: ``python -m tests.utils.make_image_fixtures``.
"""

import dataclasses
import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
from PIL import Image

from tests.utils import image_encoders as enc
from tests.utils import j2k_encoders as je
from tests.utils.html_docs import build_html_documents
from tests.utils.make_jpeg_fixtures import photo

DATA = Path(__file__).resolve().parents[1] / "data"
IMAGES = DATA / "images"
# documents at the sizes users attach, for the host decoders' rates: their
# PIL pages kept as digests (digests.json), not as pixels
RATES = DATA / "image_rates"
RATE_DIGESTS = RATES / "digests.json"
# files PIL refuses to open or to decode, which the port must refuse too
REFUSED = DATA / "images_refused"
HTML_ORACLE = DATA / "html" / "oracle.json"
ORACLE_CHUNKS = DATA / "alps_oracle_chunks.json"

# name: (height, width, mode, save options) of the progressive JPEGs PIL writes
PROGRESSIVE = {
    "progressive_420_q80.jpg": (120, 160, "RGB", {"quality": 80, "subsampling": 2}),
    "progressive_444_restart.jpg": (61, 93, "RGB", {"quality": 90, "subsampling": 0, "restart_marker_blocks": 3}),
    "progressive_422_q85.jpg": (288, 384, "RGB", {"quality": 85, "subsampling": 1}),
    "progressive_gray.jpg": (45, 60, "L", {"quality": 70}),
    "progressive_cmyk.jpg": (45, 60, "CMYK", {"quality": 85}),
}


def _pil_bytes(image: Image.Image, fmt: str, **options) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format=fmt, **options)
    return buf.getvalue()


def image_fixtures() -> dict[str, bytes]:
    """File name -> bytes of every image fixture, from fixed seeds."""
    rng = np.random.default_rng(26)
    out = {}
    for seed, (name, (h, w, mode, options)) in enumerate(sorted(PROGRESSIVE.items())):
        out[name] = _pil_bytes(Image.fromarray(photo(h, w, 40 + seed)).convert(mode), "JPEG", progressive=True,
                               optimize=True, **options)
    base = photo(53, 71, 50)
    out["adam7_rgb.png"] = enc.png(base, 8, 2)
    out["adam7_rgba16.png"] = enc.png(rng.integers(0, 65536, (29, 37, 4)), 16, 6)
    out["adam7_gray2.png"] = enc.png(rng.integers(0, 4, (23, 31)), 2, 0)
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    out["adam7_palette4.png"] = enc.png(rng.integers(0, 16, (41, 19)), 4, 3, palette.tobytes())
    out["bmp1_pil.bmp"] = _pil_bytes(Image.fromarray(base[..., 0]).convert("1"), "BMP")
    indexes16 = np.repeat(rng.integers(0, 16, (37, 18)), 3, axis=1)[:, :53]
    out["bmp4.bmp"] = enc.bmp(indexes16, 4, palette)
    out["bmp4_os2.bmp"] = enc.bmp(indexes16, 4, palette, os2=True)
    out["bmp8_os2.bmp"] = enc.bmp(indexes16 * 15, 8, rng.integers(0, 256, (256, 3)).astype(np.uint8), os2=True)
    out["bmp16_555.bmp"] = enc.bmp(base, 16)
    out["bmp16_565_bitfields.bmp"] = enc.bmp(base, 16, masks16=(0xF800, 0x7E0, 0x1F), bitfields=True, top_down=True)
    out["bmp_rle8.bmp"] = enc.bmp(indexes16 * 15, 8, rng.integers(0, 256, (256, 3)).astype(np.uint8), rle=True,
                                  rng=rng)
    out["bmp_rle4.bmp"] = enc.bmp(indexes16, 4, palette, rle=True, rng=rng)
    out["frames.gif"] = _frames_gif(rng)
    frames = [Image.fromarray(photo(48, 64, 60 + k)).quantize(64) for k in range(4)]
    out["pil_animated.gif"] = _pil_bytes(frames[0], "GIF", save_all=True, append_images=frames[1:],
                                         disposal=[0, 1, 2, 3], duration=100, optimize=True)
    out.update(_gif_layouts(rng))
    out.update(tiff_fixtures(rng))
    out.update(webp_fixtures(rng))
    out.update(apng_fixtures(rng))
    out.update(jpeg2000_fixtures())
    out.update(jpeg_coding_fixtures())
    return out


def _jpeg2000(image: Image.Image, **options) -> bytes:
    return _pil_bytes(image, "JPEG2000", **options)


def jpeg2000_fixtures() -> dict[str, bytes]:
    """JPEG 2000 images (``_97`` in a name: the irreversible 9/7 path):
    PIL writes the options its save takes (JP2 and raw codestreams, tiles
    and offsets, the five progressions, layers, resolutions, code-block
    and precinct sizes, MCT, PLT, signed samples, gray, LA, RGBA, 16-bit
    gray); OpenJPEG's encoder through ctypes (``j2k_encoders``) writes the
    code-block styles, SOP / EPH, POC, RGN, tile-parts and subsampled
    components; the rewrites put headers into PPM / PPT, add COC, QCC and
    COM, switch to derived quantization, change the precision, and wrap
    codestreams in JP2 boxes (``colr`` 12, 16, 17, 18, ``pclr`` with a
    repeated colour, ``cmap``, ``cdef``)."""
    rgb = Image.fromarray(photo(40, 56, 120))
    out = {
        "j2k_rgb.jp2": _jpeg2000(rgb),
        "j2k_rgb_97.j2k": _jpeg2000(rgb, irreversible=True, no_jp2=True, quality_layers=[20]),
        "j2k_tiles_offset.j2k": _jpeg2000(Image.fromarray(photo(45, 61, 121)), tile_size=(24, 20),
                                          tile_offset=(3, 5), offset=(7, 9), no_jp2=True),
        "j2k_layers_97.jp2": _jpeg2000(rgb, irreversible=True, quality_layers=[60, 30, 15], mct=1),
        "j2k_one_resolution.j2k": _jpeg2000(rgb, num_resolutions=1, no_jp2=True),
        "j2k_mct.j2k": _jpeg2000(rgb, mct=1, no_jp2=True, plt=True),
        "j2k_signed.j2k": _jpeg2000(rgb, signed=True, no_jp2=True),
        "j2k_gray.jp2": _jpeg2000(rgb.convert("L")),
        "j2k_gray16.jp2": _jpeg2000(Image.fromarray((photo(30, 40, 122)[..., 0].astype(np.uint16) * 3))),
        "j2k_la.jp2": _jpeg2000(Image.fromarray(np.dstack([photo(30, 40, 123)[..., :1],
                                                          photo(30, 40, 124)[..., 1:2]]).copy(), "LA")),
        "j2k_rgba_97.jp2": _jpeg2000(Image.fromarray(np.dstack([photo(30, 40, 125), photo(30, 40, 126)[..., 0]]),
                                                     "RGBA"), irreversible=True),
    }
    big = Image.fromarray(photo(64, 80, 127))
    for k, prog in enumerate(je.PROGRESSIONS):
        options = {"progression": prog, "quality_layers": [40, 20, 0][:1 + k % 3], "no_jp2": True,
                   "codeblock_size": (16, 16), "num_resolutions": 4}
        if prog != "CPRL":  # OpenJPEG 2.5.4 writes CPRL with precincts that it cannot read back
            options["precinct_size"] = (32, 32)
        out[f"j2k_{prog.lower()}.j2k"] = _jpeg2000(big, **options)
    comps = [photo(36, 44, 128)[..., c].astype(np.int32) for c in range(3)]
    for name, style, irr in (("all_styles", 63, False), ("bypass_termall_97", je.BYPASS | je.TERMALL, True),
                             ("vsc_segsym", je.VSC | je.SEGSYM, False), ("reset_pterm_97", je.RESET | je.PTERM, True)):
        out[f"j2k_style_{name}.j2k"] = je.j2k_encode(comps, style=style, irreversible=irr, mct=1, codeblock=(16, 16),
                                                   layers=[30.0, 8.0] if irr else [20.0, 0.0])
    out["j2k_sop_eph.j2k"] = je.j2k_encode(comps, sop=True, eph=True, codeblock=(16, 16), layers=[20.0, 0.0])
    packed = je.j2k_encode(comps, sop=True, eph=True, codeblock=(16, 16), layers=[20.0, 0.0], tile=(24, 24))
    out["j2k_ppm.j2k"] = je.packed_headers(packed, "ppm")
    out["j2k_ppt.j2k"] = je.packed_headers(packed, "ppt")
    out["j2k_poc.j2k"] = je.j2k_encode(comps, precincts=[(16, 16)] * 4, codeblock=(8, 8), resolutions=4,
                                       layers=[30.0, 0.0], pocs=[(1, 0, 0, 1, 2, 3, "RPCL"), (1, 2, 0, 2, 4, 3, "CPRL"),
                                                               (1, 0, 0, 2, 4, 3, "LRCP")])
    out["j2k_rgn.j2k"] = je.j2k_encode(comps, roi=(1, 5), codeblock=(16, 16))
    out["j2k_tile_parts.j2k"] = je.j2k_encode(comps, tile=(24, 24), tile_parts="R", layers=[20.0, 0.0])
    gray = photo(36, 44, 129)[..., 0].astype(np.int32)
    coded = je.j2k_encode([gray])
    for prec in (1, 4, 12):
        out[f"j2k_precision_{prec}.j2k"] = je.with_siz_precision(coded, [prec])
    out["j2k_precision_12_signed.j2k"] = je.with_siz_precision(coded, [12], [True])
    out["j2k_precision_9.jp2"] = je.jp2(je.with_siz_precision(coded, [9]))
    rgb_cs = je.j2k_encode(comps)
    # COC and QCC restating COD and QCD for components 1 and 2, and a COM
    segs = dict(je.segments(rgb_cs)[0])
    out["j2k_coc_qcc.j2k"] = je.add_segments(rgb_cs, [(0xFF53, bytes([1]) + segs[0xFF52][4:]),
                                                      (0xFF5D, bytes([2]) + segs[0xFF5C]), (0xFF64, b"\x00\x01port")])
    # one resolution, irreversible: derived quantization reads the one step QCD expounds
    single = je.j2k_encode(comps, irreversible=True, resolutions=1, layers=[10.0])
    qcd = bytearray(dict(je.segments(single)[0])[0xFF5C])
    qcd[0] = (qcd[0] & 0xE0) | 1
    out["j2k_derived_97.j2k"] = je.replace_segment(single, 0xFF5C, bytes(qcd))
    a = photo(44, 60, 130).astype(np.int32)
    sub = [a[..., 0], a[::2, ::2, 1], a[::2, ::2, 2]]
    sampled = je.j2k_encode(sub, subsampling=[(1, 1), (2, 2), (2, 2)])
    out["j2k_subsampled_ycc.j2k"] = sampled  # a bare codestream subsampled: Pillow reads it as sYCC
    out["j2k_subsampled_srgb.jp2"] = je.jp2(sampled)
    out["j2k_sycc.jp2"] = je.jp2(rgb_cs, colr=struct.pack(">BBBI", 1, 0, 0, 18))
    four = je.j2k_encode(comps + [comps[0] // 2])
    out["j2k_cmyk.jp2"] = je.jp2(four, colr=struct.pack(">BBBI", 1, 0, 0, 12))
    out["j2k_cdef.jp2"] = je.jp2(four, cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])
    out["j2k_icc.jp2"] = je.jp2(rgb_cs, colr=bytes([2, 0, 0]) + bytes(20))
    indexes = (photo(30, 40, 131)[..., 0] // 16).astype(np.int32)
    entries = [(16 * i, 255 - 16 * i, 40 * i % 256) for i in range(16)]
    entries[5] = entries[9] = entries[2]  # getcolor reuses the first index of a repeated colour
    out["j2k_palette.jp2"] = je.jp2(je.j2k_encode([indexes], precision=4), colr=struct.pack(">BBBI", 1, 0, 0, 16),
                                    pclr=([7, 7, 7], entries), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    return out


def refused_fixtures() -> dict[str, bytes]:
    """Files PIL refuses, each the port must refuse with
    InvalidDocumentError: JPEG frames at 12 bits, hierarchical and lossless
    arithmetic processes, two components, a lossless YCbCr frame; JPEG
    2000 files OpenJPEG or Pillow's unpackers refuse."""
    out = {"jpeg_12bit.jpg": enc.jpeg_header_only(0xC1, precision=12),
           "jpeg_hierarchical.jpg": enc.jpeg_header_only(0xC5),
           "jpeg_lossless_arithmetic.jpg": enc.jpeg_header_only(0xCB),
           "jpeg_two_components.jpg": enc.jpeg_header_only(0xC0, components=2),
           "jpeg_lossless_jfif_ycc.jpg": enc.jpeg_lossless(photo(20, 24, 132), predictor=1, jfif=True)}
    comps = [photo(20, 24, 133)[..., c].astype(np.int32) for c in range(3)]
    gray = je.j2k_encode(comps[:1])
    out["j2k_palette_gray_colr.jp2"] = je.jp2(je.j2k_encode([comps[0] // 16], precision=4),
                                              pclr=([7, 7, 7], [(i, i, i) for i in range(16)]),
                                              cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    out["j2k_gray_as_rgb.jp2"] = je.jp2(je.j2k_encode(comps), colr=struct.pack(">BBBI", 1, 0, 0, 17))
    out["j2k_five_components.j2k"] = je.j2k_encode(comps + comps[:2])
    out["j2k_truncated.j2k"] = gray[:-40]
    return out


def jpeg_coding_fixtures() -> dict[str, bytes]:
    """JPEG codings PIL cannot write: arithmetic-coded sequential and
    progressive frames (with DAC conditioning and restarts) and lossless
    frames (``image_encoders.jpeg_arithmetic`` / ``jpeg_lossless``), and
    progressive JPEGs PIL writes, cut after chosen scans, which
    libjpeg-turbo smooths."""
    img = photo(45, 61, 140)
    out = {"jpeg_arith_420.jpg": enc.jpeg_arithmetic(img),
           "jpeg_arith_gray_dac.jpg": enc.jpeg_arithmetic(img[..., 0], dac={("dc", 0): (2, 5), ("ac", 0): 12}),
           "jpeg_arith_444_restart.jpg": enc.jpeg_arithmetic(img, sampling=[(1, 1)] * 3, restart=3, quality=90),
           "jpeg_arith_progressive.jpg": enc.jpeg_arithmetic(img, progressive=True,
                                                             dac={("dc", 1): (0, 0), ("ac", 1): 2}),
           "jpeg_arith_progressive_restart.jpg": enc.jpeg_arithmetic(photo(30, 40, 141), progressive=True, restart=2),
           "jpeg_lossless_gray.jpg": enc.jpeg_lossless(img[..., 1], predictor=1),
           "jpeg_lossless_rgb_restart.jpg": enc.jpeg_lossless(photo(24, 30, 142), predictor=4, restart_rows=5),
           "jpeg_lossless_scans_pt2.jpg": enc.jpeg_lossless(photo(24, 30, 143), predictor=7, point_transform=2,
                                                            interleaved=False),
           "jpeg_lossless_subsampled.jpg": enc.jpeg_lossless(photo(25, 31, 144), predictor=6, restart_rows=3,
                                                             sampling=[(2, 2), (1, 1), (1, 1)])}
    for name, (h, w, sub, keep) in {"jpeg_smooth_dc_only.jpg": (48, 64, 2, 1),
                                    "jpeg_smooth_narrow.jpg": (32, 24, 2, 1),
                                    "jpeg_smooth_low_ac.jpg": (45, 61, 0, 4)}.items():
        buf = io.BytesIO()
        Image.fromarray(photo(h, w, 144 + keep)).save(buf, "JPEG", quality=80, progressive=True, subsampling=sub)
        data = buf.getvalue()
        scans = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
        out[name] = data[:scans[keep]] + b"\xff\xd9"  # the first `keep` scans
    return out


def fax_page(rng, h: int = 160, w: int = 864) -> np.ndarray:
    """[h, w] bits (True black) like a scanned text page: lines of word
    blocks with ragged edges, a rule and a stamp."""
    bits = np.zeros((h, w), dtype=bool)
    for top in range(12, h - 16, 18):
        x = int(rng.integers(20, 60))
        while x < w - 80:
            length = int(rng.integers(12, 70))
            block = rng.random((10, length)) < 0.55
            bits[top:top + 10, x:x + length] = block
            x += length + int(rng.integers(6, 14))
    bits[h - 10:h - 8, 30:w - 30] = True  # a rule of long runs
    if h < 60 or w < 70:
        return bits
    yy, xx = np.mgrid[0:40, 0:40]
    bits[20:60, w - 70:w - 30] |= ((yy - 20) ** 2 + (xx - 20) ** 2 < 400) & ((yy - 20) ** 2 + (xx - 20) ** 2 > 300)
    return bits


def tiff_fixtures(rng) -> dict[str, bytes]:
    """TIFFs: PIL (libtiff) writes each compression and a multi-page file;
    the encoders write tiles, planes, big-endian and BigTIFF headers,
    FillOrder 2, 2-, 4- and 16-bit samples, the predictor, Group 3 2D and
    old-style LZW."""
    out = {}
    page = photo(48, 64, 70)
    out["tiff_lzw_rgb.tif"] = _pil_bytes(Image.fromarray(page), "TIFF", compression="tiff_lzw")
    out["tiff_deflate_gray.tif"] = _pil_bytes(Image.fromarray(page).convert("L"), "TIFF",
                                              compression="tiff_adobe_deflate")
    out["tiff_packbits_palette.tif"] = _pil_bytes(Image.fromarray(page).quantize(32), "TIFF", compression="packbits")
    out["tiff_jpeg_ycbcr.tif"] = _pil_bytes(Image.fromarray(photo(61, 83, 71)).convert("YCbCr"), "TIFF",
                                            compression="jpeg", quality=85)
    out["tiff_raw_cmyk.tif"] = _pil_bytes(Image.fromarray(page).convert("CMYK"), "TIFF")
    alpha = (np.arange(64)[None, :] * 4 % 256).repeat(48, axis=0).astype(np.uint8)
    out["tiff_rgba_deflate.tif"] = _pil_bytes(Image.fromarray(np.dstack([page, alpha]), "RGBA"), "TIFF",
                                              compression="tiff_deflate")
    fax = fax_page(rng)
    fax_image = Image.fromarray(~fax)  # mode "1": True is white
    more = [Image.fromarray(~fax_page(rng)) for _ in range(2)]
    out["tiff_g4_fax.tif"] = _pil_bytes(fax_image, "TIFF", compression="group4", save_all=True, append_images=more)
    out["tiff_g3_fax.tif"] = _pil_bytes(fax_image, "TIFF", compression="group3")
    out["tiff_ccitt_rle.tif"] = _pil_bytes(fax_image, "TIFF", compression="tiff_ccitt")
    pages = [Image.fromarray(photo(40, 56, 72 + k)) for k in range(3)]
    pages[1] = pages[1].convert("L")
    pages[2] = Image.fromarray(~fax[:60, :90])
    out["tiff_multipage.tif"] = _pil_bytes(pages[0], "TIFF", save_all=True, append_images=pages[1:],
                                           compression="tiff_lzw")
    small = photo(37, 45, 73)
    out["tiff_tiled_planar_be.tif"] = enc.tiff([{"samples": small, "bits": 8, "photometric": 2, "compression": 5,
                                                 "predictor": 2, "planar": 2, "tile": (16, 16)}], order=">")
    gray16 = (small[..., 0].astype(np.uint16) * 250 + rng.integers(0, 250, small.shape[:2])).astype(np.uint16)
    out["tiff_bigtiff_gray16.tif"] = enc.tiff([{"samples": gray16 // 200, "bits": 16, "compression": 8,
                                                "predictor": 2, "rows_per_strip": 8}], big=True)
    out["tiff_g3_2d_fill2.tif"] = enc.tiff([{"samples": fax[:64, :400, None].astype(np.uint8), "bits": 1,
                                             "photometric": 0, "compression": 3, "two_d_every": 4, "fill": 2,
                                             "rows_per_strip": 24}])
    out["tiff_gray4_packbits.tif"] = enc.tiff([{"samples": small[..., 1:2] >> 4, "bits": 4, "photometric": 0,
                                                "compression": 32773, "rows_per_strip": 10}])
    out["tiff_gray2_lzw_old.tif"] = enc.tiff([{"samples": small[..., 2:3] >> 6, "bits": 2, "compression": 5,
                                               "lzw_old": True}])
    out["tiff_gray16_be.tif"] = enc.tiff([{"samples": gray16 // 200, "bits": 16}], order=">")
    out["tiff_palette4_tiled.tif"] = enc.tiff([{"samples": small[..., :1] >> 4, "bits": 4, "photometric": 3,
                                                "colormap": rng.integers(0, 65536, 48), "tile": (16, 32),
                                                "compression": 8}])
    return out


def webp_fixtures(rng) -> dict[str, bytes]:
    """WebPs: PIL writes lossy, lossless, alpha and animated files; libwebp's
    encoder (``image_encoders.webp_encode``) the simple loop filter, token
    partitions and sharpness; the encoders an ALPH chunk with the gradient
    filter and an animation that disposes to background."""
    out = {}
    page = photo(72, 96, 80)
    alpha = np.clip(np.add.outer(np.arange(72) * 3, np.arange(96) * 2), 0, 255).astype(np.uint8)
    rgba = Image.fromarray(np.dstack([page, alpha]), "RGBA")
    out["webp_lossy.webp"] = _pil_bytes(Image.fromarray(page), "WEBP", quality=80)
    out["webp_lossy_alpha.webp"] = _pil_bytes(rgba, "WEBP", quality=70)
    out["webp_lossless.webp"] = _pil_bytes(Image.fromarray(page), "WEBP", lossless=True)
    out["webp_lossless_alpha.webp"] = _pil_bytes(rgba, "WEBP", lossless=True, exact=True)
    out["webp_simple_filter.webp"] = enc.webp_encode(photo(57, 83, 81), quality=60.0, filter_type=0, partitions=3,
                                                     filter_sharpness=5, filter_strength=70, autofilter=0)
    lossy = enc.webp_encode(photo(33, 47, 82), quality=75.0)
    ramp = np.add.outer(np.arange(33) * 5, np.arange(47) * 3).astype(np.uint8)
    out["webp_alpha_gradient.webp"] = enc.webp_with_alpha(lossy, ramp, 3, True, True)
    frames = []
    for k in range(4):
        a = photo(64, 80, 83 + k)
        a[20 * k:20 * k + 16] = a[0, 0]
        frames.append(Image.fromarray(np.dstack([a, np.where(np.arange(80)[None] < 10 * k, 0, 255).astype(np.uint8)
                                                 .repeat(64, axis=0)]), "RGBA"))
    out["webp_animated.webp"] = _pil_bytes(frames[0], "WEBP", save_all=True, append_images=frames[1:], duration=80,
                                           quality=70)
    stills = []
    for k, (h, w) in enumerate(((40, 60), (20, 24), (16, 30), (30, 20))):
        a = np.dstack([photo(h, w, 90 + k), rng.choice([0, 128, 255], (h, w)).astype(np.uint8)])
        stills.append(enc.webp_encode(a if k else a[..., :3], lossless=k % 2, quality=70.0))
    out["webp_anim_dispose.webp"] = enc.webp_animation(
        (60, 40), [{"image": stills[0]}, {"image": stills[1], "at": (4, 6), "dispose": True},
                   {"image": stills[2], "at": (10, 10), "blend": True}, {"image": stills[3], "at": (30, 8),
                                                                            "blend": False, "dispose": True}],
        background=(255, 0, 0, 255))
    return out


def apng_fixtures(rng) -> dict[str, bytes]:
    """Animated PNGs: PIL writes a default image outside the animation and
    every disposal and blend; the encoder a palette APNG with tRNS and
    frame regions."""
    out = {}
    frames = []
    for k in range(4):
        a = photo(40, 52, 100 + k)
        a[:, 13 * k:13 * k + 10] = a[0, 0]
        frames.append(Image.fromarray(np.dstack([a, np.where(np.arange(52)[None] % (k + 2) == 0, 0, 255)
                                                 .astype(np.uint8).repeat(40, axis=0)]), "RGBA"))
    out["apng_default_image.png"] = _pil_bytes(frames[0], "PNG", save_all=True, append_images=frames[1:],
                                               default_image=True, disposal=[0, 1, 2, 0], blend=[0, 1, 1, 1],
                                               duration=50)
    rgb = [Image.fromarray(photo(36, 44, 110 + k)) for k in range(3)]
    out["apng_rgb.png"] = _pil_bytes(rgb[0], "PNG", save_all=True, append_images=rgb[1:], disposal=[2, 0, 1],
                                     blend=[1, 0, 1], duration=50)
    palette = rng.integers(0, 256, 3 * 8).astype(np.uint8).tobytes()
    out["apng_palette_trns.png"] = enc.apng(
        (30, 20), [{"samples": rng.integers(0, 8, (20, 30))},
                   {"samples": rng.integers(0, 8, (8, 12)), "at": (4, 3), "dispose": 2, "blend": 1},
                   {"samples": rng.integers(0, 8, (10, 10)), "at": (15, 8), "dispose": 1, "blend": 1},
                   {"samples": rng.integers(0, 8, (6, 6)), "at": (2, 12), "blend": 0}],
        4, 3, palette, bytes([0, 255, 255, 0]))
    return out


def _gif_layouts(rng) -> dict[str, bytes]:
    """The GIF layouts Pillow composites its own way: a palette frame
    after a gray first frame (shown gray, then the canvas turns RGB), and a
    gray frame with transparency that grows an RGB canvas."""
    palette = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    gray_first = enc.gif((24, 18), [{"indexes": rng.integers(0, 8, (18, 24))},
                                    {"indexes": rng.integers(0, 8, (10, 12)), "at": (4, 4), "palette": palette},
                                    {"indexes": rng.integers(0, 8, (6, 20)), "at": (2, 10), "transparency": 3,
                                     "disposal": 2}])
    grows = enc.gif((20, 16), [{"indexes": rng.integers(0, 8, (16, 20)), "palette": palette},
                               {"indexes": rng.integers(0, 4, (12, 10)), "at": (16, 10), "transparency": 1},
                               {"indexes": rng.integers(0, 8, (8, 8)), "at": (2, 2), "palette": palette,
                                "disposal": 3}])
    return {"gif_gray_then_palette.gif": gray_first, "gif_gray_frame_grows_rgb.gif": grows}


def _frames_gif(rng) -> bytes:
    """A 96 x 72 GIF of 6 frames: a full first frame, then patches with
    each disposal method, a local palette, transparency and interlace."""
    w, h = 96, 72
    glob = rng.integers(0, 256, (32, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    frames = [{"indexes": ((x // 6 + y // 6) % 32), "disposal": 1}]
    for k in range(5):
        fw, fh = int(rng.integers(16, 48)), int(rng.integers(12, 40))
        at = (int(rng.integers(0, w - fw)), int(rng.integers(0, h - fh)))
        local = rng.integers(0, 256, (16, 3)).astype(np.uint8) if k % 2 else None
        n = 16 if local is not None else 32
        frame = {"indexes": rng.integers(0, n, (fh, fw)), "at": at, "disposal": [2, 3, 0, 1, 2][k],
                 "palette": local, "interlace": k in (1, 4)}
        if k != 3:
            frame["transparency"] = int(rng.integers(0, n))
        frames.append(frame)
    return enc.gif((w, h), frames, glob, background=3)


def glyph_bank(rng, n: int = 64, gh: int = 14, gw: int = 9) -> np.ndarray:
    """[n, gh, gw] bits: n letter-like glyphs, each of 2 to 4 straight
    strokes 2 pixels thick."""
    out = np.zeros((n, gh, gw), dtype=bool)
    for g in range(n):
        for _ in range(int(rng.integers(2, 5))):
            y0, y1 = rng.integers(0, gh, 2)
            x0, x1 = rng.integers(0, gw - 1, 2)
            for t in np.linspace(0, 1, 2 * max(gh, gw)):
                y, x = int(round(y0 + (y1 - y0) * t)), int(round(x0 + (x1 - x0) * t))
                out[g, y, x:x + 2] = True
    return out


def text_page(rng, h: int, w: int) -> np.ndarray:
    """[h, w] bits (True black) like a typed page scanned for a fax:
    margins, ragged lines of words of glyph_bank's letters, paragraph
    gaps and a rule."""
    bank = glyph_bank(rng)
    gh, gw = bank.shape[1:]
    bits = np.zeros((h, w), dtype=bool)
    top = 120
    while top < h - 140:
        x, end = 140, w - 140 - int(rng.integers(0, 200))
        while x < end:
            for _ in range(int(rng.integers(2, 10))):
                if x + gw > end:
                    break
                bits[top:top + gh, x:x + gw] = bank[int(rng.integers(len(bank)))]
                x += gw + 2
            x += 10
        top += 30 if rng.random() > 0.1 else 60
    bits[h - 100:h - 97, 140:w - 140] = True
    return bits


def office_page(rng, h: int, w: int, gradient: bool) -> np.ndarray:
    """[h, w, 3] uint8 like a screenshot of a report: a title band, a bar
    chart, lines of text, colour tiles, and with ``gradient`` a smooth
    band at the bottom."""
    img = np.full((h, w, 3), 246, dtype=np.uint8)
    img[:h // 12] = (40, 70, 130)
    bank = glyph_bank(rng)
    base = int(h * 0.73)
    for k in range(w // 85):
        img[base - int(rng.integers(h // 12, h * 2 // 5)):base, 80 + 70 * k:130 + 70 * k] = rng.integers(40, 220, 3)
    for top in range(h // 8, base - h // 2, 24):
        x = 40
        while x < w - 60:
            img[top:top + 14, x:x + 9][bank[int(rng.integers(len(bank)))]] = (20, 20, 20)
            x += 11 + (8 if rng.random() < 0.15 else 0)
    if gradient:
        yy, xx = np.mgrid[base + 40:h, 0:w]
        img[base + 40:] = np.stack([xx % 256, (yy * 2) % 256, np.full_like(xx, 180)], -1)
    else:
        for k in range(w // 170):
            img[base + 60:h - 18, 40 + 160 * k:180 + 160 * k] = rng.integers(60, 230, 3)
    return img


def web_photo(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 3] uint8 like a photograph on a web page: broad colour
    gradients, overlapping discs, a striped texture and sensor noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(float)
    img = np.stack([120 + 80 * np.sin(x / 90 + y / 150), 110 + 70 * np.cos(x / 120 - y / 80),
                    100 + 60 * np.sin((x + y) / 200)], -1)
    for _ in range(25):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(20, 120)
        disc = (y - cy) ** 2 + (x - cx) ** 2 < r ** 2
        img[disc] = img[disc] * 0.5 + rng.integers(0, 256, 3) * 0.5
    img += 10 * (np.sin(x / 3.1 + np.sin(y / 17) * 4) * (np.sin(y / 60) > 0))[..., None]
    img += rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def rate_fixtures() -> dict[str, bytes]:
    """File name -> bytes of the documents the host decoders are timed on,
    each at a size users attach: an A4 fax page (1728 x 2200, Group 4), a
    1024 x 768 report screenshot in LZW TIFF and in lossless WebP, a 1024 x
    768 photograph in lossy WebP and in an arithmetic-coded JPEG, a letter
    and a photograph on A4 pages at 150 dpi (1240 x 1754) in JPEG 2000
    (reversible gray, irreversible RGB), and a 640 x 480 screen recording of
    4 frames in APNG."""
    rng = np.random.default_rng(27)
    out = {"g4_a4_fax.tif": _pil_bytes(Image.fromarray(~text_page(rng, 2200, 1728)), "TIFF", compression="group4"),
           "lzw_report.tif": _pil_bytes(Image.fromarray(office_page(rng, 768, 1024, False)), "TIFF",
                                        compression="tiff_lzw"),
           "lossy_photo.webp": _pil_bytes(Image.fromarray(web_photo(768, 1024, 27)), "WEBP", quality=80),
           "lossless_screen.webp": _pil_bytes(Image.fromarray(office_page(rng, 768, 1024, True)), "WEBP",
                                              lossless=True)}
    screen = office_page(rng, 480, 640, True)
    frames = []
    for k in range(4):
        frame = screen.copy()
        frame[100 + 40 * k:140 + 40 * k, 100:400] = (200, 40 * k, 60)
        frames.append(Image.fromarray(frame))
    out["apng_screen.png"] = _pil_bytes(frames[0], "PNG", save_all=True, append_images=frames[1:], duration=80)
    # a letter scanned at 150 dpi on A4 (1240 x 1754) as a reversible gray JPX, a photograph on an A4
    # page as an irreversible RGB JPX, and a 1024 x 768 photograph as an arithmetic-coded JPEG (under the
    # 64 KiB Pillow hands libjpeg at once: an arithmetic scan past it fails under Pillow)
    letter = text_page(np.random.default_rng(28), 1754, 1240)
    letter[800:] = False
    out["jpx_letter_gray.jp2"] = _pil_bytes(Image.fromarray(np.where(letter, 30, 235).astype(np.uint8)), "JPEG2000")
    out["jpx_photo_97.jp2"] = _pil_bytes(Image.fromarray(web_photo(1754, 1240, 28)), "JPEG2000", irreversible=True,
                                         quality_layers=[40])
    out["arith_photo.jpg"] = enc.jpeg_arithmetic(web_photo(768, 1024, 29), quality=70)
    return out


def page_digests(pages: list[np.ndarray]) -> list[dict]:
    """Each page's shape and the sha256 of its bytes."""
    return [{"shape": list(p.shape), "sha256": hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()}
            for p in pages]


def pil_pages(data: bytes) -> list[np.ndarray]:
    """Each frame as the JAX package's page images read it."""
    with Image.open(io.BytesIO(data)) as im:
        pages = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            pages.append(np.asarray(im.convert("RGB")))
        return pages


GENERATED_PAGES = 240  # tests/utils/html_pages.py's seeds 0-239


def elements_digest(elements) -> str:
    """sha256 of a list of elements as JSON (sorted keys, no ASCII escapes)."""
    rows = [dataclasses.asdict(e) for e in elements]
    return hashlib.sha256(json.dumps(rows, sort_keys=True, ensure_ascii=False).encode()).hexdigest()


def html_oracle() -> dict:
    """The JAX package's elements of each HTML document, with its sha256,
    and the digest of its elements of each generated malformed page."""
    import bs4.dammit

    from dial_rag_tpu.documents.elements import html_elements
    from tests.utils.html_pages import page

    guesser = bs4.dammit._chardet_dammit
    bs4.dammit._chardet_dammit = lambda markup: None  # no guesser, as on the card's machine
    try:
        texts = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
        out = {}
        for name, data in build_html_documents(texts):
            out[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                         "elements": [dataclasses.asdict(e) for e in html_elements(data)]}
        out["generated"] = [elements_digest(html_elements(page(seed))) for seed in range(GENERATED_PAGES)]
        return out
    finally:
        bs4.dammit._chardet_dammit = guesser


def main() -> None:
    IMAGES.mkdir(parents=True, exist_ok=True)
    decoded = {}
    for name, data in sorted(image_fixtures().items()):
        (IMAGES / name).write_bytes(data)
        for i, page in enumerate(pil_pages(data), start=1):
            decoded[f"{name}@{i}"] = page
    np.savez_compressed(IMAGES / "decoded.npz", **decoded)
    REFUSED.mkdir(parents=True, exist_ok=True)
    for name, data in sorted(refused_fixtures().items()):
        (REFUSED / name).write_bytes(data)
    RATES.mkdir(parents=True, exist_ok=True)
    digests = {}
    for name, data in sorted(rate_fixtures().items()):
        (RATES / name).write_bytes(data)
        digests[name] = page_digests(pil_pages(data))
    RATE_DIGESTS.write_text(json.dumps(digests, indent=1) + "\n")
    HTML_ORACLE.parent.mkdir(parents=True, exist_ok=True)
    HTML_ORACLE.write_text(json.dumps(html_oracle(), indent=1, ensure_ascii=False) + "\n")


if __name__ == "__main__":
    main()
