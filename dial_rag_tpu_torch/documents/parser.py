"""Document parsing pipeline: bytes + mime -> chunks.

Mirror of the reference's get_document_chunks/parse_document
(document_loaders.py:164-296): format dispatch, by-title chunking, empty
chunks for image-only pages, source metadata (with #page= anchors for
PDFs), the 5 MiB extracted-text cap, and "document is empty" errors."""

import io
from dataclasses import dataclass

from dial_rag_tpu_torch.documents.elements import (
    csv_elements,
    html_elements,
    pdf_elements,
    text_elements,
)
from dial_rag_tpu_torch.documents.mime import (
    IMAGE_MIMES,
    MIME_CSV,
    MIME_HTML,
    MIME_MARKDOWN,
    MIME_PDF,
    are_image_pages_supported,
)
from dial_rag_tpu_torch.documents.model import Chunk, build_chunks_list
from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.text.chunker import chunk_by_title

MAX_DOCUMENT_TEXT_SIZE = 5 * 1024 * 1024  # reference default "5MiB"
DEFAULT_CHUNK_SIZE = 1000


@dataclass(frozen=True)
class ParserConfig:
    max_document_text_size: int = MAX_DOCUMENT_TEXT_SIZE
    chunk_size: int = DEFAULT_CHUNK_SIZE

    def index_settings(self) -> dict:
        """Fields that trigger index rebuild on change (the reference marks
        unstructured_chunk_size with IndexRebuildTrigger)."""
        return {"chunk_size": self.chunk_size}


def extract_number_of_pages(mime_type: str, data: bytes) -> int:
    if mime_type == MIME_PDF:
        from dial_rag_tpu_torch.documents.pdf import PdfDocument

        return PdfDocument(data).num_pages
    if mime_type in IMAGE_MIMES:
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            return getattr(im, "n_frames", 1)
    raise InvalidDocumentError(
        f"Page images are not supported for {mime_type}"
    )


def _elements_for(data: bytes, mime: str):
    if mime == MIME_PDF:
        return pdf_elements(data)
    if mime in (MIME_HTML, "application/xhtml+xml"):
        return html_elements(data, mime)
    if mime == MIME_CSV:
        return csv_elements(data)
    if mime in IMAGE_MIMES:
        return []  # image documents have no text elements
    if mime.startswith("text/") or mime == MIME_MARKDOWN:
        return text_elements(data, mime)
    from dial_rag_tpu_torch.documents.office import (
        NATIVE_OFFICE_MIMES,
        office_elements,
    )

    if mime in NATIVE_OFFICE_MIMES:
        return office_elements(data, mime)
    raise InvalidDocumentError(
        "Unable to load document content. Try another document format."
    )


def _add_image_only_chunks(
    data: bytes,
    mime: str,
    chunks: list[tuple[str, dict]],
    number_of_pages: int | None = None,
) -> list[tuple[str, dict]]:
    """Insert empty chunks for pages that produced no text so page-image
    indexes cover every page (reference add_image_only_chunks,
    document_loaders.py:164-204)."""
    if number_of_pages is None:
        number_of_pages = extract_number_of_pages(mime, data)
    result: list[tuple[str, dict]] = []
    idx = 0
    for page in range(1, number_of_pages + 1):
        while idx < len(chunks) and chunks[idx][1].get("page_number") == page:
            result.append(chunks[idx])
            idx += 1
        if not result or result[-1][1].get("page_number") != page:
            result.append(("", {"filetype": mime, "page_number": page}))
    result.extend(chunks[idx:])  # chunks with pages beyond the count, if any
    return result


def parse_document(
    document_bytes: bytes,
    mime_type: str,
    source_link: str,
    display_name: str | None = None,
    attachment_mime_type: str | None = None,
    config: ParserConfig | None = None,
) -> list[Chunk]:
    config = config or ParserConfig()
    number_of_pages = None
    if mime_type == MIME_PDF:
        # one PDF parse serves both the text elements and the page count
        from dial_rag_tpu_torch.documents.elements import pdf_elements_from_pages
        from dial_rag_tpu_torch.documents.pdf import extract_pages_text
        from dial_rag_tpu_torch.documents.pdf.objects import PdfError

        try:
            pages = extract_pages_text(document_bytes)
        except PdfError as e:
            # corrupt user input is a 400, not an internal error
            raise InvalidDocumentError(
                f"Unable to parse the PDF document: {e}"
            ) from e
        elements = pdf_elements_from_pages(pages)
        number_of_pages = len(pages)
    else:
        elements = _elements_for(document_bytes, mime_type)
    chunk_pairs = chunk_by_title(elements, max_characters=config.chunk_size)

    if are_image_pages_supported(mime_type):
        chunk_pairs = _add_image_only_chunks(
            document_bytes, mime_type, chunk_pairs, number_of_pages
        )

    if not chunk_pairs:
        raise InvalidDocumentError("The document is empty")

    total_text = sum(len(text.encode("utf-8")) for text, _ in chunk_pairs)
    if total_text > config.max_document_text_size:
        raise InvalidDocumentError(
            f"Document text is too large: {total_text} > "
            f"{config.max_document_text_size} bytes"
        )

    # source metadata; PDFs get a page anchor (reference
    # add_pdf_source_metadata, document_loaders.py:111-120)
    is_pdf = (attachment_mime_type or mime_type) == MIME_PDF
    stamped = []
    for text, metadata in chunk_pairs:
        metadata = dict(metadata)
        metadata["source"] = source_link
        if display_name:
            metadata["source_display_name"] = display_name
        if is_pdf and "page_number" in metadata:
            metadata["source"] += f"#page={metadata['page_number']}"
        stamped.append((text, metadata))

    return build_chunks_list(stamped)
