"""First-party PDF page rasterizer without PIL (mirror of the JAX
package's ``documents/pdf/render.py``, its geometry line for line):

- embedded raster images (DCT through the port's JPEG decoder, every
  coding libjpeg-turbo reads; JPX through its JPEG 2000 decoder, the
  dictionary's /ColorSpace, /Decode and /SMaskInData ignored as PIL
  ignores them; Flate RGB, Gray and CMYK bitmaps through numpy) are
  resampled with LANCZOS into their CTM rectangles and pasted, clipped at
  the canvas edges;
- text is drawn at its exact page positions and sizes in the font Pillow
  draws it in (``_font.py``: Aileron Regular, the auto-hinter's advances;
  the ink within a few per cent of Pillow's, not equal to it).

Pages are [H, W, 3] uint8 arrays. What the decoders leave out (the JPEG
2000 corners of ``jpeg2000.py``'s docstring) raises ``NotPortedError``
(ROADMAP item 9d); an image the JAX
package would fail to decode (a ``PdfError``, ``zlib.error`` or
``ValueError``, or JPEG or JPEG 2000 data PIL refuses: corrupt, 12-bit,
hierarchical) is skipped, as there."""

import zlib

import numpy as np

from dial_rag_tpu_torch.documents.pdf._font import draw_text
from dial_rag_tpu_torch.documents.pdf.document import PdfDocument
from dial_rag_tpu_torch.documents.pdf.filters import decode_stream
from dial_rag_tpu_torch.documents.pdf.layout import LayoutParams, group_chars_to_lines
from dial_rag_tpu_torch.documents.pdf.objects import Name, PdfError, Stream
from dial_rag_tpu_torch.documents.pdf.text import TextExtractor
from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.image_processor.jpeg import cmyk_to_rgb, decode_jpeg
from dial_rag_tpu_torch.image_processor.jpeg2000 import decode_jpeg2000
from dial_rag_tpu_torch.image_processor.resize import resize_lanczos

DEFAULT_SCALE = 2.0  # ~144 dpi


def _decode_embedded_image(doc: PdfDocument, stream: Stream) -> np.ndarray | None:
    d = stream.dict
    rv = doc.resolve
    filters = rv(d.get("Filter"))
    if not isinstance(filters, list):
        filters = [filters] if filters is not None else []
    filter_names = {f.value for f in filters if isinstance(f, Name)}

    try:
        if "DCTDecode" in filter_names:
            return decode_jpeg(stream.raw)
        if "JPXDecode" in filter_names:
            return decode_jpeg2000(stream.raw)
        width = int(rv(d.get("Width", 0)))
        height = int(rv(d.get("Height", 0)))
        bpc = int(rv(d.get("BitsPerComponent", 8)))
        if not width or not height or bpc != 8:
            return None
        data = decode_stream(stream, resolve=rv)
        cs = rv(d.get("ColorSpace"))
        cs_name = cs.value if isinstance(cs, Name) else ""
        n = len(data) // (width * height)
        pixels = np.frombuffer(data, dtype=np.uint8)
        if cs_name == "DeviceRGB" or n == 3:
            return _samples(pixels, width, height, 3)
        if cs_name == "DeviceGray" or n == 1:
            return np.repeat(_samples(pixels, width, height, 1), 3, axis=2)
        if cs_name == "DeviceCMYK" or n == 4:
            return cmyk_to_rgb(_samples(pixels, width, height, 4))
    except (PdfError, zlib.error, ValueError, InvalidDocumentError):
        return None
    return None


def _samples(pixels: np.ndarray, width: int, height: int, channels: int) -> np.ndarray:
    """The first width x height pixels; too few bytes raise ValueError, as
    Pillow's frombytes does."""
    count = width * height * channels
    if len(pixels) < count:
        raise ValueError("not enough image data")
    return pixels[:count].reshape(height, width, channels)


def _paste(canvas: np.ndarray, image: np.ndarray, x0: int, y0: int) -> None:
    """``image`` onto ``canvas`` with its top left at (x0, y0), clipped."""
    h, w = canvas.shape[:2]
    ih, iw = image.shape[:2]
    left, top = max(x0, 0), max(y0, 0)
    right, bottom = min(x0 + iw, w), min(y0 + ih, h)
    if right > left and bottom > top:
        canvas[top:bottom, left:right] = image[top - y0:bottom - y0, left - x0:right - x0]


def render_page(doc: PdfDocument, page: dict, scaled_size: int | None = None) -> np.ndarray:
    """Rasterize one page dict to an [H, W, 3] uint8 RGB array."""
    media_box = doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792]
    mb = [float(doc.resolve(v)) for v in media_box]
    page_w = max(mb[2] - mb[0], 1.0)
    page_h = max(mb[3] - mb[1], 1.0)

    if scaled_size:
        scale = scaled_size / max(page_w, page_h)
    else:
        scale = DEFAULT_SCALE
    img_w = max(int(page_w * scale), 1)
    img_h = max(int(page_h * scale), 1)

    extractor = TextExtractor(doc, page)
    try:
        glyphs = extractor.extract()
    except PdfError:
        glyphs = []

    canvas = np.full((img_h, img_w, 3), 255, dtype=np.uint8)

    # embedded images first (text overlays them, like a real renderer)
    for stream, ctm in extractor.images:
        img = _decode_embedded_image(doc, stream)
        if img is None:
            continue
        # unit square corners under ctm
        xs, ys = [], []
        for ux, uy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            px = ctm[0] * ux + ctm[2] * uy + ctm[4]
            py = ctm[1] * ux + ctm[3] * uy + ctm[5]
            xs.append((px - mb[0]) * scale)
            ys.append((page_h - (py - mb[1])) * scale)
        x0, x1 = int(min(xs)), int(max(xs))
        y0, y1 = int(min(ys)), int(max(ys))
        if x1 - x0 < 1 or y1 - y0 < 1:
            continue
        _paste(canvas, resize_lanczos(img, x1 - x0, y1 - y0), x0, y0)

    for line in group_chars_to_lines(glyphs, LayoutParams()):
        text = line.text.strip()
        if not text:
            continue
        size_px = max(int(line.height * scale * 0.9), 4)
        x = (line.x0 - mb[0]) * scale
        y = (page_h - (line.y1 - mb[1])) * scale
        draw_text(canvas, (x, y), text, size_px)

    return canvas


def render_pdf_pages(
    data: bytes,
    page_numbers: list[int] | None = None,
    scaled_size: int | None = None,
):
    """Yield [H, W, 3] uint8 images for the given 1-based pages (all
    pages if None)."""
    doc = PdfDocument(data)
    pages = doc.pages()
    if page_numbers is None:
        page_numbers = list(range(1, len(pages) + 1))
    for number in page_numbers:
        if not 1 <= number <= len(pages):
            raise PdfError(f"page {number} out of range 1..{len(pages)}")
        yield render_page(doc, pages[number - 1], scaled_size)
