"""Page images by mime type (mirror of the JAX package's
``image_processor/extract_pages.py``, without PIL): PDFs render through
the port's rasterizer (``documents/pdf/render.py``); image documents decode
through the port's codecs, chosen by the bytes' magic as ``Image.open``
chooses: PNG (``png.py``), JPEG (``jpeg.py``, the native core), BMP
(``bmp.py``) and GIF (``gif.py``, the native LZW core; a GIF is a
document of one page a frame, as Pillow's ``n_frames`` counts them).
TIFF and WebP documents, and animated PNGs, raise ``NotPortedError``
(ROADMAP item 9d). Rendering runs in a single-worker executor, as in the
JAX package. Pages are [H, W, 3] uint8 arrays."""

import asyncio
from typing import AsyncIterator

import numpy as np

from dial_rag_tpu_torch.documents.mime import IMAGE_MIMES, MIME_PDF, normalize_content_type, sniff_mime
from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError

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
    """The image format of ``data`` by its magic: "png", "jpeg", "bmp" or
    "gif"; the formats the port does not read raise NotPortedError (item
    9d), bytes of no image format InvalidDocumentError."""
    kind = sniff_mime(data)
    if kind == "image/png":
        from dial_rag_tpu_torch.image_processor.png import SIGNATURE

        # an animated PNG's frames (acTL before the first IDAT) are pages to Pillow
        head = data[: data.find(b"IDAT")] if b"IDAT" in data else data
        if b"acTL" in head[len(SIGNATURE):]:
            raise NotPortedError("Animated PNG documents are not ported yet (ROADMAP item 9d)")
        return "png"
    if kind == "image/jpeg":
        return "jpeg"
    if kind == "image/bmp":
        return "bmp"
    if kind == "image/gif":
        return "gif"
    if kind in ("image/tiff", "image/webp"):
        raise NotPortedError(f"{kind.split('/')[1].upper()} documents are not ported yet (ROADMAP item 9d)")
    raise InvalidDocumentError("Cannot identify the image file")


def decode_image(data: bytes) -> np.ndarray:
    """The RGB pixels ([H, W, 3] uint8) of a PNG, JPEG, BMP or GIF
    document (a GIF's first frame), as ``Image.open(...).convert("RGB")``
    gives them."""
    kind = image_format(data)
    if kind == "gif":
        from dial_rag_tpu_torch.image_processor.gif import decode_gif_frames

        return decode_gif_frames(data, [1])[0]
    if kind == "png":
        from dial_rag_tpu_torch.image_processor.png import decode_png

        return decode_png(data)
    if kind == "jpeg":
        from dial_rag_tpu_torch.image_processor.jpeg import decode_jpeg

        return decode_jpeg(data)
    from dial_rag_tpu_torch.image_processor.bmp import decode_bmp

    return decode_bmp(data)


def _image_pages(data: bytes, page_numbers: list[int] | None, scaled_size: int | None):
    from dial_rag_tpu_torch.image_processor.resize import resize_image

    if image_format(data) == "gif":  # a page a frame
        from dial_rag_tpu_torch.image_processor.gif import decode_gif_frames

        frames = decode_gif_frames(data, page_numbers)
    else:  # PNG, JPEG and BMP hold one frame
        for number in page_numbers or [1]:
            if number != 1:
                raise InvalidDocumentError(f"page {number} out of range 1..1")
        frames = [decode_image(data)] * len(page_numbers or [1])
    for frame in frames:
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
