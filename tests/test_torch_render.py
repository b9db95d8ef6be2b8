"""The port's page rasterizer (``documents/pdf/render.py`` with
``documents/pdf/_font.py``) against the JAX package's, which draws with
PIL, on the CPU.

Tolerances, stated before any comparison:
- page images: the same size;
- pixels outside the text lines' boxes: at most IMAGE_LEVELS per channel
  (the JPEG decode's 2 levels and the LANCZOS resample's 1);
- each text line: its ink box within INK_BOX_PX of PIL's, its summed ink
  within INK_RATIO of PIL's (FreeType auto-hints the font; the port
  models only part of the hinting, so ink is close, not pixel-equal);
- the font's whole-pixel advances, ascender and pen positions (no
  kerning, as PIL's basic layout): equal to PIL's; a line of missing
  characters' boxes: as a text line.
The PDFs carry text only, Flate RGB, Gray and CMYK images, DCT images
that PIL writes here from seeded arrays, JPX images (JPEG 2000, PIL's
save) and the JPEG codings PIL cannot write (tests/utils/image_encoders.py);
images PIL refuses are skipped by both (tests/utils/image_pdf.py).
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from dial_rag_tpu.documents.pdf import render as jax_render
from dial_rag_tpu.documents.pdf.writer import build_pdf
from dial_rag_tpu_torch.documents.pdf import _font, render
from dial_rag_tpu_torch.documents.pdf.document import PdfDocument
from dial_rag_tpu_torch.documents.pdf.layout import LayoutParams, group_chars_to_lines
from dial_rag_tpu_torch.documents.pdf.text import TextExtractor
from tests.utils import image_encoders as enc
from tests.utils.image_pdf import build_image_pdf
from tests.utils.make_image_fixtures import IMAGES as IMAGES_DIR
from tests.utils.make_image_fixtures import REFUSED as REFUSED_DIR

IMAGE_LEVELS = 3
INK_BOX_PX = 2
INK_RATIO = 0.10


def photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 13.0), 128 + 90 * np.cos(x / 5.0 - y / 9.0),
                    (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def jpx(image: np.ndarray, mode: str = "RGB", extra: bytes = b"", colour_space: bool = True, **kw) -> tuple:
    buf = io.BytesIO()
    Image.fromarray(image).convert(mode).save(buf, format="JPEG2000", **kw)
    channels = {"RGB": 3, "L": 1}[mode] if colour_space else 0
    return ("jpx", buf.getvalue(), image.shape[1], image.shape[0], channels, extra)


def jpeg(image: np.ndarray, mode: str = "RGB", **kw) -> tuple:
    buf = io.BytesIO()
    Image.fromarray(image).convert(mode).save(buf, format="JPEG", **kw)
    return ("dct", buf.getvalue(), image.shape[1], image.shape[0], {"RGB": 3, "L": 1, "CMYK": 4}[mode])


TEXT = "The Alps stretch 1,200 km across eight countries; Cadibona Pass marks their southern boundary."
CMYK = np.random.default_rng(11).integers(0, 256, (40, 50, 4), dtype=np.uint8)
PDFS = {
    "text": lambda: build_pdf([[(72, 740 - 30 * i, size, f"{size} pt: {TEXT[: 40 + 4 * i]}")
                               for i, size in enumerate((8, 9, 10, 11, 12, 14, 16, 18, 24, 30))]],
                              compress=True),
    "flate": lambda: build_image_pdf([(
        [(72, 300, 12, "Flate images: RGB, gray and CMYK, one across the page's right edge."),
         (72, 280, 10, TEXT)],
        [(72, 420, 200, 150, photo(90, 120, 1)), (300, 420, 120, 90, photo(60, 80, 2)[..., 0]),
         (72, 600, 100, 80, CMYK), (520, 600, 200, 120, photo(50, 90, 3))],
    )]),
    "dct": lambda: build_image_pdf([(
        [(72, 300, 12, "DCT images: 4:2:0, 4:4:4 with restarts, gray and CMYK."), (72, 280, 10, TEXT)],
        [(72, 420, 240, 180, jpeg(photo(90, 120, 4), quality=80)),
         (330, 420, 150, 100, jpeg(photo(61, 93, 5), quality=92, subsampling=0, restart_marker_blocks=2)),
         (72, 620, 120, 90, jpeg(photo(45, 60, 6), "L", quality=60)),
         (330, 620, 120, 90, jpeg(photo(45, 60, 7), "CMYK", quality=85))],
    )]),
    # JPX: a 9/7 photograph, a 5/3 gray scan (no /ColorSpace), a raw codestream whose /Decode and
    # /SMaskInData PIL ignores, and a JP2 whose palette OpenJPEG refuses (skipped, as in the JAX package)
    "jpx": lambda: build_image_pdf([(
        [(72, 300, 12, "JPX images: 9/7 and 5/3, a codestream and a refused palette."), (72, 280, 10, TEXT)],
        [(72, 420, 240, 180, jpx(photo(90, 120, 8), irreversible=True, quality_layers=[30])),
         (330, 420, 150, 100, jpx(photo(61, 93, 9), "L", colour_space=False)),
         (72, 620, 120, 90, jpx(photo(45, 60, 10), extra=b"/Decode [1 0 1 0 1 0] /SMaskInData 1 ", no_jp2=True,
                                tile_size=(32, 32))),
         (330, 620, 120, 90, ("jpx", (REFUSED_DIR / "j2k_palette_gray_colr.jp2").read_bytes(), 24, 20, 0))],
    )]),
    # the JPEG codings beyond Huffman DCT: arithmetic-coded, lossless, smoothed, and a 12-bit frame PIL refuses
    "jpeg_codings": lambda: build_image_pdf([(
        [(72, 300, 12, "Arithmetic, lossless and smoothed JPEGs, and a 12-bit one."), (72, 280, 10, TEXT)],
        [(72, 420, 240, 180, ("dct", enc.jpeg_arithmetic(photo(90, 120, 11), progressive=True), 120, 90, 3)),
         (330, 420, 150, 100, ("dct", enc.jpeg_lossless(photo(61, 93, 12), predictor=5), 93, 61, 3)),
         (72, 620, 120, 90, ("dct", (IMAGES_DIR / "jpeg_smooth_low_ac.jpg").read_bytes(), 61, 45, 3)),
         (330, 620, 120, 90, ("dct", (REFUSED_DIR / "jpeg_12bit.jpg").read_bytes(), 16, 16, 1))],
    )]),
}


def line_draws(pdf: bytes, scaled_size):
    """Each text line of page 1 as render_page draws it: (x, y, size, text)."""
    doc = PdfDocument(pdf)
    page = doc.pages()[0]
    mb = [float(doc.resolve(v)) for v in doc.resolve(page.get("MediaBox"))]
    page_w, page_h = mb[2] - mb[0], mb[3] - mb[1]
    scale = scaled_size / max(page_w, page_h) if scaled_size else render.DEFAULT_SCALE
    out = []
    for line in group_chars_to_lines(TextExtractor(doc, page).extract(), LayoutParams()):
        if line.text.strip():
            out.append(((line.x0 - mb[0]) * scale, (page_h - (line.y1 - mb[1])) * scale,
                        max(int(line.height * scale * 0.9), 4), line.text.strip()))
    return out


def ink(image: np.ndarray) -> np.ndarray:
    return 255 - image.astype(np.int64).min(axis=2)


def ink_box(values: np.ndarray):
    ys, xs = np.nonzero(values)
    return (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1) if len(xs) else None


def isolated_box(shape, x, y, size, text, pil: bool):
    canvas = np.full(shape, 255, np.uint8)
    if pil:
        im = Image.fromarray(canvas)
        ImageDraw.Draw(im).text((x, y), text, fill="black", font=ImageFont.load_default(size=size))
        canvas = np.asarray(im)
    else:
        _font.draw_text(canvas, (x, y), text, size)
    return ink_box(ink(canvas))


def assert_line_within(got: np.ndarray, ref: np.ndarray, what):
    box_got, box_ref = ink_box(got), ink_box(ref)
    assert box_got is not None and box_ref is not None, what
    assert max(abs(a - b) for a, b in zip(box_got, box_ref)) <= INK_BOX_PX, (what, box_got, box_ref)
    assert abs(int(got.sum()) - int(ref.sum())) <= INK_RATIO * int(ref.sum()), (what, got.sum(), ref.sum())


@pytest.mark.parametrize("scaled_size", [None, 800, 1536])
@pytest.mark.parametrize("name", sorted(PDFS))
def test_render_page_matches_the_jax_package(name, scaled_size):
    pdf = PDFS[name]()
    ref = np.asarray(next(jax_render.render_pdf_pages(pdf, scaled_size=scaled_size)))
    got = next(render.render_pdf_pages(pdf, scaled_size=scaled_size))
    assert got.shape == ref.shape and got.dtype == np.uint8
    outside = np.ones(ref.shape[:2], bool)
    lines = line_draws(pdf, scaled_size)
    assert lines
    for x, y, size, text in lines:
        boxes = [isolated_box(ref.shape, x, y, size, text, pil) for pil in (True, False)]
        x0, y0 = (max(min(b[i] for b in boxes) - 1, 0) for i in (0, 1))
        x1, y1 = (max(b[i] for b in boxes) + 1 for i in (2, 3))
        outside[y0:y1, x0:x1] = False
        assert_line_within(ink(got[y0:y1, x0:x1]), ink(ref[y0:y1, x0:x1]), (name, scaled_size, text))
    diff = np.abs(got.astype(np.int64) - ref)[outside]
    assert diff.max() <= IMAGE_LEVELS, (name, scaled_size, diff.max())


def test_pages_render_at_the_jax_sizes():
    pdf = build_pdf([[(72, 720, 12, f"Page {i}")] for i in range(3)])
    for size in (None, 300, 1536):
        got = [p.shape for p in render.render_pdf_pages(pdf, scaled_size=size)]
        ref = [np.asarray(p).shape for p in jax_render.render_pdf_pages(pdf, scaled_size=size)]
        assert got == ref
    assert [p.shape for p in render.render_pdf_pages(pdf, [2])] == [(1584, 1224, 3)]


@pytest.mark.parametrize("size", [4, 5, 7, 9, 10, 12, 16, 21, 30, 47, 64, 125])
def test_font_advances_and_ascender_are_pils(size):
    font = ImageFont.load_default(size=size)
    assert _font.ascender_px(size) == font.getmetrics()[0]
    for code, gid in sorted(_font.DEFAULT_FONT.cmap.items()):
        assert _font.advance_px(gid, size) == font.getlength(chr(code)), (size, chr(code))
    assert _font.advance_px(0, size) == font.getlength("中")


@pytest.mark.parametrize("text", ["中文字符 ☃ ✓ → €", "naïve café — “quoted” © ½", "\tTabs\tand symbols §¶•"])
@pytest.mark.parametrize("size", [9, 21])
def test_characters_the_font_lacks_draw_as_pil_draws_them(text, size):
    """A character the cmap lacks draws glyph 0 (the box), as PIL draws it."""
    shape = (size * 2 + 10, size * len(text) + 20, 3)
    pil = Image.fromarray(np.full(shape, 255, np.uint8))
    ImageDraw.Draw(pil).text((3.5, 4.25), text, fill="black", font=ImageFont.load_default(size=size))
    got = np.full(shape, 255, np.uint8)
    _font.draw_text(got, (3.5, 4.25), text, size)
    assert_line_within(ink(got), ink(np.asarray(pil)), (text, size))


@pytest.mark.parametrize("size", [5, 7, 9, 11, 13, 17, 21, 25, 27, 33, 40])
def test_missing_character_box_is_hinted_as_freetype_hints_it(size):
    """Glyph 0 takes the auto-hinter's fallback (CJK) style: its frame's
    stems widened and moved into whole pixels (``_cjk_stem``); a line of
    boxes against PIL's at each size."""
    text = "中" * 6
    shape = (size * 2 + 10, size * 7 + 20, 3)
    pil = Image.fromarray(np.full(shape, 255, np.uint8))
    ImageDraw.Draw(pil).text((2.25, 3.5), text, fill="black", font=ImageFont.load_default(size=size))
    got = np.full(shape, 255, np.uint8)
    _font.draw_text(got, (2.25, 3.5), text, size)
    assert_line_within(ink(got), ink(np.asarray(pil)), size)


@pytest.mark.parametrize("size", [9, 14, 40])
def test_layout_applies_no_kerning_as_pils_basic_layout(size):
    """load_default lays text out with the basic layout, which applies no
    kerning: each pen position is PIL's length of the text before it, kerning
    pairs ("AV", "To", "Ty", "We") included."""
    font = ImageFont.load_default(size=size)
    text = "AVATAR To Ty We yA Lv"
    gids, positions = _font.layout(text, size)
    assert gids == [_font.DEFAULT_FONT.glyph_index(ch) for ch in text]
    for i in range(1, len(text) + 1):
        end = positions[i] if i < len(text) else positions[-1] + _font.advance_px(gids[-1], size)
        assert end == font.getlength(text[:i]), (size, text[:i])
