"""Page images by mime type (mirror of the JAX package's
``image_processor/extract_pages.py``, without PIL): PDFs render through
the port's rasterizer (``documents/pdf/render.py``); image documents decode
through the port's codecs, chosen by the bytes' magic as ``Image.open``
chooses: PNG (``png.py``; an animated PNG a page a frame), JPEG
(``jpeg.py``, the native core: Huffman, arithmetic and lossless codings),
BMP (``bmp.py``), GIF (``gif.py``, the native LZW core), TIFF (``tiff.py``,
a page a directory, the native ``tiff.cpp`` core), WebP (``webp.py``, a
page a frame, the native ``webp.cpp`` core) and JPEG 2000 (``jpeg2000.py``,
the native ``jpeg2000.cpp`` core), each page as Pillow's ``n_frames``
counts them. What those codecs leave out (the JPEG 2000 corners of its
module's docstring; old-style JPEG, LZMA, ZSTD,
WebP, SGILog and ThunderScan TIFF compressions, YCbCr outside JPEG, CIE
L*a*b* and 12- or 32-bit TIFF samples) raises ``NotPortedError`` (ROADMAP
item 9d); what Pillow refuses (a 12-bit or hierarchical JPEG) raises
``InvalidDocumentError``. Rendering runs in a single-worker executor, as
in the JAX package. Pages are [H, W, 3] uint8 arrays."""

import asyncio
import importlib
from typing import AsyncIterator

import numpy as np

from dial_rag_tpu_torch.documents.mime import IMAGE_MIMES, MIME_PDF, normalize_content_type, sniff_mime
from dial_rag_tpu_torch.errors import InvalidDocumentError

# one worker, as in the JAX package
_render_pool = None


def _get_render_pool():
    global _render_pool
    if _render_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _render_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="page_render")
    return _render_pool


def is_image(content_type: str) -> bool:
    return normalize_content_type(content_type) in IMAGE_MIMES


def are_image_pages_supported(mime_type: str) -> bool:
    return mime_type == MIME_PDF or mime_type in IMAGE_MIMES


def image_format(data: bytes) -> str:
    """The image format of ``data`` by its magic: "png", "jpeg", "bmp",
    "gif", "tiff", "webp" or "jpeg2000"; bytes Pillow does not identify
    raise InvalidDocumentError."""
    from dial_rag_tpu_torch.image_processor.jpeg2000 import is_jpeg2000
    from dial_rag_tpu_torch.image_processor.tiff import is_tiff
    from dial_rag_tpu_torch.image_processor.webp import is_webp

    kind = sniff_mime(data)
    if kind in ("image/png", "image/jpeg", "image/bmp", "image/gif"):
        return kind.split("/")[1]
    if is_tiff(data):
        return "tiff"
    if is_webp(data):
        return "webp"
    if is_jpeg2000(data):
        return "jpeg2000"
    raise InvalidDocumentError("Cannot identify the image file")


# format -> (module, its page count, its pages), each module imported at first use;
# JPEG, BMP and JPEG 2000 hold one frame, counted by reading the header
_CODECS = {"png": ("png", "frame_count", "decode_png_frames"), "gif": ("gif", "frame_count", "decode_gif_frames"),
           "tiff": ("tiff", "page_count", "decode_tiff_pages"), "webp": ("webp", "frame_count", "decode_webp_frames"),
           "jpeg": ("jpeg", "read_header", "decode_jpeg"), "bmp": ("bmp", "read_header", "decode_bmp"),
           "jpeg2000": ("jpeg2000", "read_header", "decode_jpeg2000")}
_ONE_FRAME = ("jpeg", "bmp", "jpeg2000")


def _codec(data: bytes) -> tuple[str, object, object]:
    kind = image_format(data)
    module, count, decode = _CODECS[kind]
    codec = importlib.import_module(f"dial_rag_tpu_torch.image_processor.{module}")
    return kind, getattr(codec, count), getattr(codec, decode)


def page_count(data: bytes) -> int:
    """Pillow's ``n_frames`` of an image document, read from its headers
    and block structure without decoding pixels."""
    kind, count, _ = _codec(data)
    if kind in _ONE_FRAME:
        count(data)
        return 1
    return count(data)


def decode_pages(data: bytes, numbers: list[int] | None = None) -> list[np.ndarray]:
    """The RGB pages ([H, W, 3] uint8) ``numbers`` (1-based; every page if
    None) of an image document, each as ``Image.open(...)``, ``seek(n -
    1)`` and ``convert("RGB")`` give it."""
    kind, _, decode = _codec(data)
    if kind not in _ONE_FRAME:
        return decode(data, numbers)
    for number in numbers or [1]:
        if number != 1:
            raise InvalidDocumentError(f"page {number} out of range 1..1")
    return [decode(data)] * len(numbers or [1])


def decode_image(data: bytes) -> np.ndarray:
    """The RGB pixels ([H, W, 3] uint8) of an image document's first page,
    as ``Image.open(...).convert("RGB")`` gives them."""
    return decode_pages(data, [1])[0]


def _image_pages(data: bytes, page_numbers: list[int] | None, scaled_size: int | None):
    from dial_rag_tpu_torch.image_processor.resize import resize_image

    for frame in decode_pages(data, page_numbers):
        if scaled_size:
            frame = resize_image(frame, scaled_size)
        yield frame


def _extract_pages_sync(
    mime_type: str,
    data: bytes,
    page_numbers: list[int] | None,
    scaled_size: int | None,
) -> list[np.ndarray]:
    if mime_type == MIME_PDF:
        from dial_rag_tpu_torch.documents.pdf.render import render_pdf_pages

        return list(render_pdf_pages(data, page_numbers, scaled_size))
    if mime_type in IMAGE_MIMES:
        return list(_image_pages(data, page_numbers, scaled_size))
    raise InvalidDocumentError(f"Page images are not supported for {mime_type}")


async def extract_pages(
    mime_type: str,
    data: bytes,
    page_numbers: list[int] | None = None,
    scaled_size: int | None = None,
) -> AsyncIterator[np.ndarray]:
    loop = asyncio.get_running_loop()
    images = await loop.run_in_executor(
        _get_render_pool(),
        _extract_pages_sync,
        mime_type,
        data,
        page_numbers,
        scaled_size,
    )
    for image in images:
        yield image


def extract_number_of_pages(mime_type: str, data: bytes) -> int:
    from dial_rag_tpu_torch.documents.parser import extract_number_of_pages as impl

    return impl(mime_type, data)
