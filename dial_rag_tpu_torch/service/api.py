"""Public API schemas (wire-compatible mirrors of reference
retrieval_api.py / indexing_api.py)."""

from typing import ClassVar

from dial_rag_tpu_torch.service._model import BaseModel, Field


class Source(BaseModel):
    url: str = Field(
        description="URL for the source; may carry a fragment like #page=3."
    )
    display_name: str | None = Field(
        default=None, description="Human-readable name of the source."
    )


class Page(BaseModel):
    number: int = Field(description="1-based page number in the document.")
    image_index: int | None = Field(
        default=None,
        description="Index of the page image in the `images` list, 0-based.",
    )


class Image(BaseModel):
    data: str = Field(description="Base64 encoded image data (image/png).")
    mime_type: str = Field(
        default="image/png", description="MIME type of the image."
    )


class RetrievedChunk(BaseModel):
    attachment_url: str = Field(
        description="URL of the attached document the chunk belongs to; "
        "matches attachment.url in the request."
    )
    source: Source
    text: str | None = Field(
        default=None, description="Chunk text; may be empty for images."
    )
    page: Page | None = Field(default=None)


class RetrievalResponse(BaseModel):
    CONTENT_TYPE: ClassVar[str] = (
        "application/x.aidial-rag.retrieval-response+json"
    )

    chunks: list[RetrievedChunk] = Field(
        default_factory=list,
        description="Chunks found, in relevance order.",
    )
    images: list[Image] = Field(
        default_factory=list,
        description="Images related to the chunks.",
    )


class IndexingError(BaseModel):
    message: str = Field(description="Error during the indexing process.")


class DocumentIndexingResultResponse(BaseModel):
    errors: list[IndexingError] = Field(default_factory=list)


class IndexingResponse(BaseModel):
    CONTENT_TYPE: ClassVar[str] = (
        "application/x.aidial-rag.indexing-response+json"
    )

    indexing_result: dict[str, DocumentIndexingResultResponse] = Field(
        default_factory=dict,
        description="Document URL -> indexing result.",
    )
