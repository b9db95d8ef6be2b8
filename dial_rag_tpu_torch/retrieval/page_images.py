"""Page bitmaps -> base64 PNG async generator with count (mirror of the JAX
package's ``retrieval/page_images.py``; the port's PNG encoder in place of
PIL's)."""

from dial_rag_tpu_torch.documents.parser import extract_number_of_pages
from dial_rag_tpu_torch.image_processor import (
    are_image_pages_supported,
    extract_pages,
    image_as_base64,
)
from dial_rag_tpu_torch.runtime.limited import AsyncGeneratorWithTotal


async def extract_page_images(
    mime_type: str,
    document_bytes: bytes,
    scaled_size: int,
    stageio,
) -> AsyncGeneratorWithTotal | None:
    """Returns None for formats without page images."""
    if not are_image_pages_supported(mime_type):
        stageio.write(f"Page images are not supported for {mime_type}\n")
        return None

    number_of_pages = extract_number_of_pages(mime_type, document_bytes)
    stageio.write(f"Number of pages: {number_of_pages}\n")

    async def gen():
        async for image in extract_pages(
            mime_type, document_bytes, scaled_size=scaled_size
        ):
            yield image_as_base64(image)

    return AsyncGeneratorWithTotal(gen(), number_of_pages)
