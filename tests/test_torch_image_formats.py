"""The image formats of the port's page images held against PIL (the JAX
package's path) on the CPU: progressive JPEG (``native/jpeg.cpp``),
Adam7 and animated PNG (``png.py``), the BMPs Pillow reads (``bmp.py``:
1-, 4- and 16-bit, RLE8 and RLE4, OS/2 headers) and GIF documents
(``gif.py`` on ``native/gif.cpp``: a page a frame, composited as Pillow
composites it); the committed TIFF, WebP, JPEG 2000 and arithmetic,
lossless and smoothed JPEG fixtures too (their seeded sets are in
tests/test_torch_tiff.py, tests/test_torch_webp.py,
tests/test_torch_jpeg2000.py and tests/test_torch_jpeg_codings.py).

Tolerances, stated before any comparison:
- PNG (APNG composites too), BMP, GIF, TIFF but JPEG-in-TIFF, WebP:
  equal (bit for bit);
- JPEG 2000 irreversible (9/7, ``_97`` in a fixture's name): equal
  expected, a ceiling of J2K_IRREVERSIBLE_LEVELS with the count of
  differing samples printed; the other JPEG 2000 fixtures: equal;
- progressive, arithmetic-coded, lossless and smoothed JPEG and
  JPEG-in-TIFF: equal expected, with a ceiling of
  JPEG_LEVELS per
  channel (the gate of tests/test_torch_codecs.py); the largest
  difference read is printed;
- page counts and pages: equal to the JAX package's
  ``extract_number_of_pages`` and ``_extract_pages_sync`` (resized pages
  within RESIZE_LEVELS, the LANCZOS gate);
- a PDF of progressive DCT images: its page within IMAGE_LEVELS of the
  JAX package's render (tests/test_torch_render.py's gate).
Inputs are the committed fixtures (tests/data/images, written by
``python -m tests.utils.make_image_fixtures``) and seeded sets; PIL
writes what it can, ``tests/utils/image_encoders.py`` the rest.
"""

import hashlib
import io
import json

import numpy as np
import pytest
from PIL import Image

from dial_rag_tpu.documents.pdf import render as jax_render
from dial_rag_tpu.image_processor.extract_pages import _extract_pages_sync as jax_pages
from dial_rag_tpu.image_processor.extract_pages import extract_number_of_pages as jax_number_of_pages
from dial_rag_tpu_torch.documents.mime import detect_mime
from dial_rag_tpu_torch.documents.parser import extract_number_of_pages, parse_document
from dial_rag_tpu_torch.documents.pdf import render
from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.image_processor.bmp import decode_bmp
from dial_rag_tpu_torch.documents.mime import IMAGE_MIMES
from dial_rag_tpu_torch.image_processor.extract_pages import _extract_pages_sync, decode_pages, page_count
from dial_rag_tpu_torch.image_processor.gif import decode_gif_frames, frame_count
from dial_rag_tpu_torch.image_processor.jpeg import decode_jpeg
from dial_rag_tpu_torch.image_processor.png import decode_png, decode_png_frames
from dial_rag_tpu_torch.image_processor.png import frame_count as png_frame_count
from tests.utils import image_encoders as enc
from tests.utils.image_pdf import build_image_pdf
from tests.utils.make_image_fixtures import (
    GENERATED_PAGES,
    HTML_ORACLE,
    IMAGES,
    ORACLE_CHUNKS,
    RATE_DIGESTS,
    RATES,
    elements_digest,
    html_oracle,
    image_fixtures,
    page_digests,
    rate_fixtures,
)
from tests.utils.make_jpeg_fixtures import photo

JPEG_LEVELS = 2
J2K_IRREVERSIBLE_LEVELS = 1  # tests/test_torch_jpeg2000.py's gate
RESIZE_LEVELS = 1
IMAGE_LEVELS = 3
FIXTURES = sorted(p.name for p in IMAGES.iterdir() if p.suffix != ".npz")


def pil_pages(data: bytes) -> list[np.ndarray]:
    with Image.open(io.BytesIO(data)) as im:
        out = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out


def port_pages(name: str, data: bytes) -> tuple[list[np.ndarray], int]:
    """The port's pages and page count of a fixture, as an image document
    of its mime; a JPEG 2000 file (no image mime the service takes: it
    reaches the port inside PDFs) by its magic."""
    mime = detect_mime(None, name, data)  # a BigTIFF's magic is no mime's: its name gives it
    if mime not in IMAGE_MIMES:
        return decode_pages(data), page_count(data)
    return _extract_pages_sync(mime, data, None, None), extract_number_of_pages(mime, data)


def jpeg_gap(got: np.ndarray, ref: np.ndarray) -> int:
    assert got.shape == ref.shape
    return int(np.abs(got.astype(np.int64) - ref).max())


# -- the committed fixtures ------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_to_its_committed_pixels(name):
    data = (IMAGES / name).read_bytes()
    decoded = np.load(IMAGES / "decoded.npz")
    ref = [decoded[f"{name}@{i}"] for i in range(1, 1 + sum(k.startswith(name + "@") for k in decoded.files))]
    got, count = port_pages(name, data)
    assert len(got) == len(ref) == count
    for page, want in zip(got, ref):
        if name.endswith(".jpg") or "_jpeg" in name:
            gap = jpeg_gap(page, want)
            print(f"{name}: largest difference {gap}")
            assert gap <= JPEG_LEVELS
        elif "_97" in name:  # JPEG 2000's float 9/7 path: 0 expected
            gap = jpeg_gap(page, want)
            print(f"{name}: largest difference {gap}, {int((page != want).sum())} samples differ")
            assert gap <= J2K_IRREVERSIBLE_LEVELS
        else:
            assert page.shape == want.shape and np.array_equal(page, want)


def test_committed_fixtures_are_what_the_maker_writes():
    """The fixture files and their pixels are what PIL and the encoders
    give today (the maker's seeds), so the card holds the port to PIL."""
    files = image_fixtures()
    assert sorted(files) == FIXTURES
    decoded = np.load(IMAGES / "decoded.npz")
    for name, data in files.items():
        assert (IMAGES / name).read_bytes() == data, name
        for i, page in enumerate(pil_pages(data), start=1):
            assert np.array_equal(decoded[f"{name}@{i}"], page), name


RATE_FILES = sorted(p.name for p in RATES.iterdir() if p != RATE_DIGESTS)


def test_committed_rate_documents_are_what_the_maker_writes():
    """The documents the card times the host decoders on, and the digests
    of their PIL pages, are what PIL gives today (the maker's seeds)."""
    files = rate_fixtures()
    assert sorted(files) == RATE_FILES
    digests = json.loads(RATE_DIGESTS.read_text())
    assert sorted(digests) == RATE_FILES
    for name, data in files.items():
        assert (RATES / name).read_bytes() == data, name
        assert page_digests(pil_pages(data)) == digests[name], name


@pytest.mark.parametrize("name", RATE_FILES)
def test_rate_document_decodes_to_pils_pages(name):
    """Each timed document (an A4 fax page, 1024 x 768 screenshots and
    photographs, a 640 x 480 APNG) decodes in the port, page count and
    every page, bit for bit as PIL decodes it (by the digests the card
    checks)."""
    data = (RATES / name).read_bytes()
    want = json.loads(RATE_DIGESTS.read_text())[name]
    pages, count = port_pages(name, data)
    assert count == len(want)
    assert page_digests(pages) == want


def test_committed_html_oracle_is_the_jax_packages():
    """tests/data/html/oracle.json equals the JAX package's elements of
    tests/utils/html_docs.py's documents and the digests of its elements
    of tests/utils/html_pages.py's pages today (no charset guesser)."""
    from dial_rag_tpu_torch.documents.elements import html_elements
    from tests.utils.html_docs import build_html_documents
    from tests.utils.html_pages import page

    oracle = json.loads(HTML_ORACLE.read_text())
    assert oracle == html_oracle()
    texts = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
    assert {n: hashlib.sha256(d).hexdigest() for n, d in build_html_documents(texts)} == {
        n: v["sha256"] for n, v in oracle.items() if n != "generated"}
    # the port's elements of the generated pages give the oracle's digests (chip_smoke reads them on the card)
    assert [elements_digest(html_elements(page(seed))) for seed in range(GENERATED_PAGES)] == oracle["generated"]


# -- progressive JPEG --------------------------------------------------------------

PROGRESSIVE = [(mode, sub, opt, restart) for mode in ("RGB", "L", "CMYK") for sub in (0, 1, 2)
               for opt in (False, True) for restart in (0, 2) if mode == "RGB" or sub == 0]


@pytest.mark.parametrize("mode,subsampling,optimize,restart", PROGRESSIVE)
def test_progressive_jpeg_matches_pil(mode, subsampling, optimize, restart):
    rng = np.random.default_rng(PROGRESSIVE.index((mode, subsampling, optimize, restart)))
    worst = 0
    for shape in [(1, 1), (7, 300), (37, 53), (64, 64), tuple(rng.integers(8, 140, 2))]:
        kw = {"quality": int(rng.integers(30, 96)), "progressive": True, "optimize": optimize}
        if mode == "RGB":
            kw["subsampling"] = subsampling
        if restart:
            kw["restart_marker_blocks"] = restart
        buf = io.BytesIO()
        Image.fromarray(photo(*shape, seed=int(rng.integers(1 << 30)))).convert(mode).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        assert b"\xff\xc2" in data
        worst = max(worst, jpeg_gap(decode_jpeg(data), pil_pages(data)[0]))
    print(f"progressive {mode} {subsampling} optimize={optimize} restart={restart}: largest difference {worst}")
    assert worst <= JPEG_LEVELS


def test_progressive_jpeg_that_libjpeg_smooths_raises_item_9d():
    """A progressive JPEG whose AC coefficients never arrive (its scans
    stop after the DC scans), once refused (ROADMAP item 9d): libjpeg
    smooths its blocks, and so does the port now, to PIL's pixels within
    JPEG_LEVELS."""
    buf = io.BytesIO()
    Image.fromarray(photo(32, 32, seed=3)).save(buf, "JPEG", quality=80, progressive=True)
    data = buf.getvalue()
    scans = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    cut = data[: scans[1]] + b"\xff\xd9"  # the first (DC) scan only
    gap = jpeg_gap(decode_jpeg(cut), pil_pages(cut)[0])
    print(f"smoothed DC-only progressive JPEG: largest difference {gap}")
    assert gap <= JPEG_LEVELS


# -- PNG ---------------------------------------------------------------------------

PNG_MODES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16),
                                                 (6, 8), (6, 16)]


@pytest.mark.parametrize("color,depth", PNG_MODES)
def test_adam7_png_matches_pil(color, depth):
    rng = np.random.default_rng(color * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for shape in [(1, 1), (1, 9), (9, 1), (5, 3), (8, 8), tuple(rng.integers(2, 40, 2))]:
        palette = b""
        if color == 3:
            n = int(rng.integers(1, (1 << depth) + 1))
            samples = rng.integers(0, n, (*shape, 1))
            palette = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        else:
            samples = rng.integers(0, 1 << depth, (*shape, channels))
        data = enc.png(samples, depth, color, palette, interlace=True)
        assert np.array_equal(decode_png(data), pil_pages(data)[0])


# -- BMP ---------------------------------------------------------------------------

BMP_CASES = [(bits, os2, rle, top) for bits in (1, 4, 8, 16, 24) for os2 in (False, True)
             for rle in (False, True) for top in (False, True)
             if not (rle and (bits not in (4, 8) or os2 or top)) and not (os2 and (bits == 16 or top))]


@pytest.mark.parametrize("bits,os2,rle,top_down", BMP_CASES)
def test_bmp_matches_pil(bits, os2, rle, top_down):
    rng = np.random.default_rng(bits * 8 + os2 * 4 + rle * 2 + top_down)
    for shape in [(1, 1), (3, 7), (17, 33), tuple(rng.integers(1, 60, 2))]:
        if bits <= 8:
            n = int(rng.integers(2, (1 << bits) + 1))
            palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
            pixels = rng.integers(0, n, shape)
            if rle:
                pixels = np.repeat(pixels[:, ::3], 3, axis=1)[:, : shape[1]]
            data = enc.bmp(pixels, bits, palette, rle=rle, os2=os2, top_down=top_down, rng=rng)
        else:
            pixels = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
            masks = (0xF800, 0x7E0, 0x1F) if rng.random() < 0.5 else (0x7C00, 0x3E0, 0x1F)
            data = enc.bmp(pixels, bits, masks16=masks, bitfields=masks[0] == 0xF800, os2=os2, top_down=top_down)
        assert np.array_equal(decode_bmp(data), pil_pages(data)[0])


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_bmp_pil_writes_decode_as_pil_reads_them(mode):
    """The bitmaps PIL writes, the mode "1" one (1 bit a pixel) among them,
    read as PIL reads them."""
    image = Image.fromarray(photo(31, 45, seed=9)).convert(mode)
    buf = io.BytesIO()
    image.save(buf, "BMP")
    assert np.array_equal(decode_bmp(buf.getvalue()), pil_pages(buf.getvalue())[0])


def test_one_bit_bmp_indexes_and_renders_in_the_port():
    buf = io.BytesIO()
    Image.fromarray(photo(40, 60, seed=10)[..., 0]).convert("1").save(buf, "BMP")
    data = buf.getvalue()
    chunks = parse_document(data, "image/bmp", source_link="files/one-bit.bmp")
    assert [(c.text, c.metadata["page_number"]) for c in chunks] == [("", 1)]
    page = _extract_pages_sync("image/bmp", data, [1], 100)[0]
    ref = np.asarray(jax_pages("image/bmp", data, [1], 100)[0])
    assert page.shape == ref.shape and int(np.abs(page.astype(int) - ref).max()) <= RESIZE_LEVELS


# -- GIF ---------------------------------------------------------------------------

def random_gif(rng, frames: int) -> bytes:
    w, h = (int(v) for v in rng.integers(1, 40, 2))
    glob = rng.integers(0, 256, (int(rng.choice([2, 4, 16, 256])), 3)).astype(np.uint8) if rng.random() < 0.8 else None
    out = []
    for _ in range(frames):
        fw, fh = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        local = (rng.integers(0, 256, (int(rng.choice([2, 8, 64])), 3)).astype(np.uint8)
                 if glob is None or rng.random() < 0.3 else None)
        n = len(local if local is not None else glob)
        at = [int(rng.integers(0, w - fw + 1)), int(rng.integers(0, h - fh + 1))]
        if rng.random() < 0.2:  # past the logical screen: Pillow grows the image
            at = [at[0] + int(rng.integers(1, 8)), at[1] + int(rng.integers(0, 8))]
        frame = {"indexes": rng.integers(0, n, (fh, fw)), "at": tuple(at), "palette": local,
                 "disposal": int(rng.integers(0, 4)), "interlace": bool(rng.random() < 0.3)}
        if rng.random() < 0.5:
            frame["transparency"] = int(rng.integers(0, n))
        out.append(frame)
    return enc.gif((w, h), out, glob, background=int(rng.integers(0, 4)))


@pytest.mark.parametrize("frames", range(1, 9))
def test_gif_frames_match_pil(frames):
    rng = np.random.default_rng(1000 + frames)
    for _ in range(12):
        data = random_gif(rng, frames)
        ref = pil_pages(data)
        got = decode_gif_frames(data)
        assert frame_count(data) == len(ref) == len(got) == frames
        for a, b in zip(got, ref):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["P", "RGB", "L", "RGBA"])
def test_gifs_pil_writes_match_pil(mode):
    rng = np.random.default_rng(ord(mode[0]))
    images = []
    for k in range(4):
        a = photo(30, 40, seed=20 + k)
        a[:12] = a[0, 0]
        im = Image.fromarray(a)
        if mode == "P":
            im = im.quantize(int(rng.integers(2, 200)))
        elif mode == "L":
            im = im.convert("L")
        elif mode == "RGBA":
            im = Image.fromarray(np.dstack([a, (rng.random(a.shape[:2]) < 0.3).astype(np.uint8) * 255]), "RGBA")
        images.append(im)
    for options in ({}, {"optimize": True, "disposal": [0, 1, 2, 3]}, {"transparency": 0, "disposal": 2}):
        buf = io.BytesIO()
        images[0].save(buf, "GIF", save_all=True, append_images=images[1:], **options)
        data = buf.getvalue()
        for a, b in zip(decode_gif_frames(data), pil_pages(data), strict=True):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_gif_documents_match_the_jax_package(seed):
    rng = np.random.default_rng(2000 + seed)
    data = random_gif(rng, int(rng.integers(1, 7)))
    n = jax_number_of_pages("image/gif", data)
    assert extract_number_of_pages("image/gif", data) == n
    for numbers, size in ((None, None), ([n, 1], None), (None, 64)):
        ref = [np.asarray(p) for p in jax_pages("image/gif", data, numbers, size)]
        got = _extract_pages_sync("image/gif", data, numbers, size)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and int(np.abs(a.astype(int) - b).max()) <= (RESIZE_LEVELS if size else 0)
    with pytest.raises(InvalidDocumentError, match=f"page {n + 1} out of range 1..{n}"):
        _extract_pages_sync("image/gif", data, [n + 1], None)
    chunks = parse_document(data, "image/gif", source_link="files/a.gif")
    assert [c.metadata["page_number"] for c in chunks] == list(range(1, n + 1))


# -- a PDF of progressive DCT images -------------------------------------------------

def test_progressive_jpeg_in_a_pdf_renders_as_the_jax_package():
    images = []
    for k, (mode, sub) in enumerate((("RGB", 2), ("RGB", 0), ("L", 0), ("CMYK", 0))):
        a = photo(60 + 7 * k, 80 + 5 * k, seed=30 + k)
        buf = io.BytesIO()
        kw = {"subsampling": sub} if mode == "RGB" else {}
        Image.fromarray(a).convert(mode).save(buf, "JPEG", quality=85, progressive=True, **kw)
        images.append((72 + 260 * (k % 2), 420 - 200 * (k // 2), 200, 150,
                       ("dct", buf.getvalue(), a.shape[1], a.shape[0], {"RGB": 3, "L": 1, "CMYK": 4}[mode])))
    pdf = build_image_pdf([([], images)])
    for size in (None, 800):
        ref = np.asarray(next(jax_render.render_pdf_pages(pdf, scaled_size=size)))
        got = next(render.render_pdf_pages(pdf, scaled_size=size))
        assert got.shape == ref.shape
        assert int(np.abs(got.astype(np.int64) - ref).max()) <= IMAGE_LEVELS
        assert got.min() < 200  # the images were drawn


def test_gif_palette_frame_after_a_gray_first_frame_matches_pil():
    """A palette frame after a first frame without a palette: Pillow keeps
    the gray canvas's bytes (shown gray, the palette unused) and turns the
    canvas RGB at the next frame; the port's pages and page count are
    Pillow's."""
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    gray_first = enc.gif((8, 6), [{"indexes": rng.integers(0, 4, (6, 8))},
                                  {"indexes": rng.integers(0, 4, (6, 8)), "palette": palette},
                                  {"indexes": rng.integers(0, 4, (3, 5)), "at": (2, 2), "transparency": 1}])
    assert frame_count(gray_first) == jax_number_of_pages("image/gif", gray_first) == len(pil_pages(gray_first)) == 3
    for got, want in zip(decode_gif_frames(gray_first), pil_pages(gray_first), strict=True):
        assert np.array_equal(got, want)


GIF_LAYOUTS = ["gray_then_palette", "palette_over_gray_global", "gray_frame_grows_rgb", "palette_frame_grows_rgb",
               "no_palette_grows_rgb", "transparent_gray_then_palette"]


def layout_gif(layout: str, rng) -> bytes:
    palette = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    idx = lambda h, w, n=8: rng.integers(0, n, (h, w))  # noqa: E731
    if layout == "gray_then_palette":
        frames = [{"indexes": idx(12, 16)}, {"indexes": idx(6, 8), "at": (3, 2), "palette": palette, "disposal": 2},
                  {"indexes": idx(5, 9), "at": (1, 6), "transparency": 2}, {"indexes": idx(12, 16), "disposal": 3}]
        return enc.gif((16, 12), frames)
    if layout == "palette_over_gray_global":  # the first frame's palette is the gray ramp, the global one is not
        ramp = np.repeat(np.arange(8, dtype=np.uint8)[:, None], 3, axis=1)
        frames = [{"indexes": idx(12, 16), "palette": ramp}, {"indexes": idx(6, 8), "at": (3, 2), "palette": palette},
                  {"indexes": idx(4, 4), "at": (14, 10)}]
        return enc.gif((16, 12), frames, palette)
    if layout in ("gray_frame_grows_rgb", "no_palette_grows_rgb"):
        second = {"indexes": idx(8, 8, 4), "at": (12, 8)}
        if layout == "gray_frame_grows_rgb":
            second["transparency"] = 1
        return enc.gif((16, 12), [{"indexes": idx(12, 16), "palette": palette}, second,
                                  {"indexes": idx(4, 6), "at": (1, 1), "palette": palette}])
    if layout == "palette_frame_grows_rgb":
        return enc.gif((16, 12), [{"indexes": idx(12, 16), "palette": palette},
                                  {"indexes": idx(8, 8), "at": (12, 8), "palette": palette[::-1].copy()}])
    # a transparent gray first frame, then a palette frame: Pillow's convert fails on the second page
    return enc.gif((16, 12), [{"indexes": idx(12, 16), "transparency": 0},
                              {"indexes": idx(6, 8), "at": (3, 2), "palette": palette}])


@pytest.mark.parametrize("layout", GIF_LAYOUTS)
def test_gif_layouts_match_pil(layout):
    """The layouts Pillow composites its own way, each as Pillow gives it;
    where Pillow fails (a frame without a palette or transparency that
    grows an RGB canvas, a palette frame after a transparent gray frame)
    the port raises InvalidDocumentError, from the same page on."""
    data = layout_gif(layout, np.random.default_rng(GIF_LAYOUTS.index(layout)))
    assert frame_count(data) == jax_number_of_pages("image/gif", data)
    try:
        want = pil_pages(data)
    except (ValueError, AssertionError):
        want = None
    if want is None:
        with pytest.raises(InvalidDocumentError):
            decode_gif_frames(data)
        return
    for got, ref in zip(decode_gif_frames(data), want, strict=True):
        assert got.shape == ref.shape and np.array_equal(got, ref)
    reordered = decode_gif_frames(data, [len(want), 1])
    assert np.array_equal(reordered[0], want[-1])


# -- animated PNG ----------------------------------------------------------------------

APNG_MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 4), (3, 8), (4, 8), (4, 16),
              (6, 8), (6, 16)]


@pytest.mark.parametrize("color,depth", APNG_MODES)
def test_apng_matches_pil(color, depth):
    """Seeded APNGs of every colour type and depth: frame regions, dispose
    ops 0-2 and blend ops 0-1, with and without a default image, tRNS on
    gray, RGB and palette images; Pillow's pages, or its error (a 16-bit
    gray frame cannot blend over)."""
    rng = np.random.default_rng(color * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for _ in range(5):
        w, h = (int(v) for v in rng.integers(1, 24, 2))
        top, palette, trns = 1 << depth, b"", b""
        if color == 3:
            top = int(rng.integers(1, (1 << depth) + 1))
            palette = rng.integers(0, 256, 3 * top).astype(np.uint8).tobytes()
            if rng.random() < 0.6:
                trns = rng.integers(0, 256, int(rng.integers(1, top + 1))).astype(np.uint8).tobytes()
        elif color in (0, 2) and rng.random() < 0.5:
            trns = b"".join(int(v).to_bytes(2, "big") for v in rng.integers(0, min(top, 4), 1 if color == 0 else 3))
        frames = []
        for _ in range(int(rng.integers(1, 5))):
            fw, fh = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
            samples = rng.integers(0, min(top, 4) if rng.random() < 0.5 else top, (fh, fw, channels))
            if color in (4, 6):
                samples[..., -1] = rng.choice([0, (1 << depth) - 1, int(rng.integers(0, 1 << depth))], (fh, fw))
            frames.append({"samples": samples, "at": (int(rng.integers(0, w - fw + 1)), int(rng.integers(0, h - fh + 1))),
                           "dispose": int(rng.integers(0, 3)), "blend": int(rng.integers(0, 2))})
        default = rng.integers(0, top, (h, w, channels)) if rng.random() < 0.5 else None
        if default is None:
            frames[0].update(at=(0, 0), samples=rng.integers(0, top, (h, w, channels)))
        data = enc.apng((w, h), frames, depth, color, palette, trns, default)
        try:
            want = pil_pages(data)
        except ValueError:
            with pytest.raises(InvalidDocumentError):
                decode_png_frames(data)
            continue
        assert png_frame_count(data) == len(want)
        for got, ref in zip(decode_png_frames(data), want, strict=True):
            assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("default_image", [False, True])
def test_apng_documents_match_the_jax_package(default_image):
    """APNGs PIL writes (every disposal and blend): page counts, pages (all,
    reordered, scaled) and chunks as the JAX package gives them; the first
    page is the default image where the IDAT is outside the animation."""
    rng = np.random.default_rng(int(default_image))
    frames = []
    for k in range(4):
        a = photo(30, 40, seed=120 + k)
        a[:, 10 * k:10 * k + 8] = a[0, 0]
        frames.append(Image.fromarray(np.dstack([a, (rng.random((30, 40)) < 0.7).astype(np.uint8) * 255]), "RGBA"))
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:], default_image=default_image,
                   disposal=[0, 1, 2, 1], blend=[0, 1, 1, 0], duration=30)
    data = buf.getvalue()
    n = jax_number_of_pages("image/png", data)
    assert extract_number_of_pages("image/png", data) == n == 4
    for numbers, size in ((None, None), ([n, 1], None), (None, 32)):
        ref = [np.asarray(p) for p in jax_pages("image/png", data, numbers, size)]
        got = _extract_pages_sync("image/png", data, numbers, size)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and int(np.abs(a.astype(int) - b).max()) <= (RESIZE_LEVELS if size else 0)
    chunks = parse_document(data, "image/png", source_link="files/a.png")
    assert [c.metadata["page_number"] for c in chunks] == list(range(1, n + 1))
