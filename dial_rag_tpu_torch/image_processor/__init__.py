"""The two mime checks of ``dial_rag_tpu/image_processor`` that the
service's text path reads, as plain functions (no PIL). Page images,
image documents and the image-index arms wait for ROADMAP item 9b."""

from dial_rag_tpu_torch.documents.mime import IMAGE_MIMES, MIME_PDF, normalize_content_type


def is_image(content_type: str) -> bool:
    return normalize_content_type(content_type) in IMAGE_MIMES


def are_image_pages_supported(mime_type: str) -> bool:
    return mime_type == MIME_PDF or mime_type in IMAGE_MIMES


__all__ = ["are_image_pages_supported", "is_image"]
