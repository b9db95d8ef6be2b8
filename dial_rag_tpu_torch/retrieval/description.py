"""Description retriever: a vision LLM describes each page as structured
JSON; the description pieces are embedded with the LOCAL bge model and
packed per page, so queries ride the dense index on the device (mirror of
the JAX package's ``retrieval/description.py``; the prompt byte for byte).
The index lives on the embedder's device; the device cache's key ends
with it, as the port's other retrievers' do."""

import json
import logging
import re
from dataclasses import dataclass, field

import numpy as np

from dial_rag_tpu_torch.documents.model import (
    DocumentRecord,
    create_doc_embeddings_by_page,
    pack_multi_embeddings,
)
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.dense_index import DenseIndex
from dial_rag_tpu_torch.index.device_cache import cached_build
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.retrieval.page_images import extract_page_images
from dial_rag_tpu_torch.runtime.limited import (
    DialLimitedResources,
    map_with_resource_limits,
)
from dial_rag_tpu_torch.service.config import DescriptionIndexConfig
from dial_rag_tpu_torch.service.llm import LlmClient
from dial_rag_tpu_torch.utils.timing import timed_block

logger = logging.getLogger(__name__)

MAX_RETRIES = 1_000_000_000  # bounded by the map's wall-clock timeout

# PROVENANCE: pinned verbatim to the reference's page-description
# prompt (reference description_retriever/prompts.py) — recorded
# vision-LLM replay traffic keys on the exact prompt bytes, and the
# JSON fields it demands (incl. image_quality) are the parse contract.
PAGE_DESCRIPTION_PROMPT = """
Please create detailed description of provided image.
Ignore page header, footer, basic logo and background.
Describe all images (illustration), tables.
Text with bullet points is NOT a table or image.

Use only provided information.
DO NOT make up answer.

Provide answer in JSON format with fields:
{
    "page_summary": "page summary here",
    "keyfact"     : "the most important fact from the image",
    "image_quality": {
        "level": "level of image quality (normal, detailed)",
        "explanation": "explain why this detailisation is required"
    },
    "images":[
        {
            "description": "image description",
            "type"       : "image type (photo, illustration, diagram, etc.)",
            "keyfact"    : "the most important fact from the image"
        }
    ],
    "tables":[
        {
            "description": "table description",
            "keyfact"    : "the most important fact from the table"
        }
    ]
}
"""


@dataclass
class PageDescription:
    page_summary: str = ""
    keyfact: str = ""
    # how much detail the page image needs when shown to the QA vision
    # LLM: "high" (model said detailed), "low" (normal), "auto"
    # (missing/unrecognized) — reference page_description.py:82-90
    image_quality: str = "auto"
    image_quality_explanation: str = ""
    images: list[dict] = field(default_factory=list)
    tables: list[dict] = field(default_factory=list)

    def to_chunks(self) -> list[str]:
        """Flatten to embeddable text pieces, skipping model boilerplate."""

        def clean(text: str) -> str:
            return text.replace("\n", " ").replace("\r", " ")

        chunks = []
        if self.page_summary:
            chunks.append(clean(self.page_summary))
        if self.keyfact:
            chunks.append(clean(self.keyfact))
        for item in self.images + self.tables:
            desc = item.get("description", "")
            if "are present" in desc.lower() and desc.lower().startswith("no "):
                continue
            for piece in (desc, item.get("keyfact", "")):
                if piece:
                    chunks.append(clean(piece))
        return chunks


_JSON_BLOCK_RE = re.compile(r"\{.*\}", re.DOTALL)


def repair_and_parse_json(text: str) -> dict:
    """Tolerant JSON extraction: strip markdown fences, locate the outer
    object, drop trailing commas (mirror of the reference's repair logic,
    description_retriever.py:257-280)."""
    text = re.sub(r"```(?:json)?", "", text)
    m = _JSON_BLOCK_RE.search(text)
    if not m:
        raise ValueError(f"no JSON object found in: {text[:200]!r}")
    candidate = m.group(0)
    try:
        return json.loads(candidate)
    except json.JSONDecodeError:
        repaired = re.sub(r",\s*([}\]])", r"\1", candidate)
        repaired = repaired.replace("'", '"')
        return json.loads(repaired)


def parse_page_description(text: str) -> PageDescription:
    try:
        data = repair_and_parse_json(text)
    except (ValueError, json.JSONDecodeError) as e:
        logger.warning(f"Failed to parse page description: {e}")
        # fall back to using the raw text as the summary
        return PageDescription(page_summary=text.strip()[:2000])
    quality = data.get("image_quality")
    quality = quality if isinstance(quality, dict) else {}
    level = str(quality.get("level", "")).lower()
    return PageDescription(
        page_summary=str(data.get("page_summary", "")),
        keyfact=str(data.get("keyfact", "")),
        image_quality={"detailed": "high", "normal": "low"}.get(
            level, "auto"
        ),
        image_quality_explanation=str(quality.get("explanation", "")),
        images=[i for i in data.get("images", []) if isinstance(i, dict)],
        tables=[t for t in data.get("tables", []) if isinstance(t, dict)],
    )


class DescriptionRetriever:
    def __init__(self, embedder: BgeEmbedder, index: DenseIndex):
        self.embedder = embedder
        self.index = index

    @staticmethod
    def has_index(document_records: list[DocumentRecord]) -> bool:
        return any(
            doc.description_embeddings_index is not None
            and sum(len(np.asarray(e)) for e in doc.description_embeddings_index)
            > 0
            for doc in document_records
        )

    @classmethod
    def from_doc_records(
        cls,
        embedder: BgeEmbedder,
        document_records: list[DocumentRecord],
        k: int = 4,
        device_cache=None,
    ) -> "DescriptionRetriever":
        def build():
            doc_embeddings = [
                create_doc_embeddings_by_page(
                    doc.chunks, doc.description_embeddings_index
                )
                for doc in document_records
            ]
            return DenseIndex(
                RetrievalType.IMAGE, doc_embeddings, limit=k, device=embedder.device
            )

        key = ("description", k, str(embedder.device))
        index = cached_build(device_cache, document_records, key, build)
        return cls(embedder=embedder, index=index)

    async def aretrieve(self, query: str) -> list[SearchHit]:
        query_emb = await self.embedder.aembed_query(query)
        # cross-request scan coalescing (DenseIndex.afind)
        return await self.index.afind(query_emb)

    @staticmethod
    async def build_index(
        dial_url: str,
        api_key: str,
        dial_limited_resources: DialLimitedResources,
        index_config: DescriptionIndexConfig,
        embedder: BgeEmbedder,
        document_bytes: bytes,
        mime_type: str,
        stageio,
    ):
        async with timed_block("Building Description indexes", stageio):
            llm_config = index_config.llm.model_copy(
                update={"max_retries": 2}
            )
            llm = LlmClient(dial_url, api_key, llm_config)

            extracted = await extract_page_images(
                mime_type, document_bytes, index_config.image_size, stageio
            )
            if extracted is None:
                return None

            async def describe_page(image_base64: str) -> PageDescription:
                content = await llm.acomplete(
                    [
                        {
                            "role": "user",
                            "content": [
                                {
                                    "type": "text",
                                    "text": PAGE_DESCRIPTION_PROMPT,
                                },
                                {
                                    "type": "image_url",
                                    "image_url": {
                                        "url": "data:image/png;base64,"
                                        + image_base64
                                    },
                                },
                            ],
                        }
                    ]
                )
                return parse_page_description(content)

            stageio.write("Building page descriptions\n")
            descriptions = await map_with_resource_limits(
                dial_limited_resources,
                extracted,
                describe_page,
                index_config.estimated_page_tokens,
                index_config.llm.deployment_name,
                stageio,
            )

            # flatten description pieces, embed with the local model, and
            # pack back per page
            page_indexes: list[int] = []
            texts: list[str] = []
            for page_index, description in enumerate(descriptions):
                for piece in description.to_chunks():
                    page_indexes.append(page_index)
                    texts.append(piece)

            embeddings = await embedder.aembed_documents(texts)
            return pack_multi_embeddings(
                page_indexes, embeddings, len(descriptions)
            )
