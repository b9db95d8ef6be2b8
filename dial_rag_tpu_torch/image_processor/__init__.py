"""Page images without PIL: PDF pages rendered by
``documents/pdf/render.py``, image documents decoded by the port's PNG,
JPEG, BMP and GIF readers, LANCZOS resizing, and base64 PNG encoding. Pages
are [H, W, 3] uint8 arrays."""

from dial_rag_tpu_torch.image_processor.base64_utils import image_as_base64
from dial_rag_tpu_torch.image_processor.extract_pages import (
    are_image_pages_supported,
    extract_number_of_pages,
    extract_pages,
    is_image,
)
from dial_rag_tpu_torch.image_processor.resize import resize_image

__all__ = [
    "extract_pages",
    "extract_number_of_pages",
    "are_image_pages_supported",
    "is_image",
    "image_as_base64",
    "resize_image",
]
