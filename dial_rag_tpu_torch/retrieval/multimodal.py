"""Multimodal page-image retriever: remote multimodal embedding model for
both page images (build) and text queries (search); the local scan reuses
the dense index on the device (mirror of the JAX package's
``retrieval/multimodal.py``). The index lives on ``device``; the device
cache's key ends with it, as the port's other retrievers' do."""

import asyncio
import logging

from dial_rag_tpu_torch.documents.model import (
    DocumentRecord,
    create_doc_embeddings_by_page,
    pack_simple_embeddings,
)
from dial_rag_tpu_torch.embeddings.multimodal import MultimodalEmbeddingsClient
from dial_rag_tpu_torch.index.dense_index import DenseIndex
from dial_rag_tpu_torch.index.device_cache import cached_build
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.retrieval.page_images import extract_page_images
from dial_rag_tpu_torch.runtime.limited import (
    DialLimitedResources,
    map_with_resource_limits,
)
from dial_rag_tpu_torch.service.config import MultimodalIndexConfig
from dial_rag_tpu_torch.utils.timing import timed_block

logger = logging.getLogger(__name__)

MAX_RETRIES = 1_000_000_000  # bounded by the map's wall-clock timeout


class MultimodalRetriever:
    def __init__(
        self,
        index: DenseIndex,
        dial_url: str,
        api_key: str,
        index_config: MultimodalIndexConfig,
    ):
        self.index = index
        self.dial_url = dial_url
        self.api_key = api_key
        self.index_config = index_config

    @staticmethod
    def has_index(document_records: list[DocumentRecord]) -> bool:
        return any(
            doc.multimodal_embeddings_index is not None
            for doc in document_records
        )

    @classmethod
    def from_doc_records(
        cls,
        dial_url: str,
        api_key: str,
        index_config: MultimodalIndexConfig,
        document_records: list[DocumentRecord],
        k: int = 1,
        device_cache=None,
        device="cuda",
    ) -> "MultimodalRetriever":
        def build():
            doc_embeddings = [
                create_doc_embeddings_by_page(
                    doc.chunks, doc.multimodal_embeddings_index
                )
                for doc in document_records
            ]
            return DenseIndex(
                RetrievalType.IMAGE,
                doc_embeddings,
                metric=index_config.metric,
                limit=k,
                device=device,
            )

        key = ("multimodal", str(index_config.metric), k, str(device))
        index = cached_build(device_cache, document_records, key, build)
        return cls(
            index=index,
            dial_url=dial_url,
            api_key=api_key,
            index_config=index_config,
        )

    async def aretrieve(self, query: str) -> list[SearchHit]:
        client = MultimodalEmbeddingsClient(
            self.dial_url, self.api_key, self.index_config.embeddings_model
        )
        query_emb = await client.aembed_query(query)
        return await asyncio.get_running_loop().run_in_executor(
            None, self.index.find, query_emb
        )

    @staticmethod
    async def build_index(
        dial_url: str,
        api_key: str,
        dial_limited_resources: DialLimitedResources,
        index_config: MultimodalIndexConfig,
        mime_type: str,
        document_bytes: bytes,
        stageio,
    ):
        async with timed_block("Building Multimodal indexes", stageio):
            client = MultimodalEmbeddingsClient(
                dial_url,
                api_key,
                index_config.embeddings_model,
                max_retries=MAX_RETRIES,
            )
            extracted = await extract_page_images(
                mime_type, document_bytes, index_config.image_size, stageio
            )
            if extracted is None:
                return None
            stageio.write("Building image embeddings\n")
            embeddings = await map_with_resource_limits(
                dial_limited_resources,
                extracted,
                client.aembed_image,
                index_config.estimated_image_tokens,
                index_config.embeddings_model,
                stageio,
            )
            return pack_simple_embeddings(embeddings)
