"""Late-interaction (MaxSim) retriever (counterpart of
``dial_rag_tpu/retrieval/late_interaction.py``).

Build: per-token embeddings of every chunk, kept ragged in the document
record (``late_interaction_index``). Query: the query's per-token
embeddings scored with MaxSim on the device (``index/late_interaction.py``).
"""

import numpy as np

from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.device_cache import cached_build
from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit


class LateInteractionRetriever:
    def __init__(self, embedder: BgeEmbedder, index: LateInteractionIndex):
        self.embedder = embedder
        self.index = index

    @staticmethod
    def has_index(document_records: list[DocumentRecord]) -> bool:
        return any(doc.late_interaction_index is not None for doc in document_records)

    @classmethod
    def from_doc_records(
        cls,
        embedder: BgeEmbedder,
        document_records: list[DocumentRecord],
        k: int = 1,
        max_chunk_tokens: int = 256,
        storage_dtype: str = "float32",
        device_cache=None,
        mesh=None,
    ) -> "LateInteractionRetriever":
        """The index over every record's per-token embeddings, on the
        embedder's device; with ``device_cache`` reused across requests
        over the same records."""
        if mesh is not None:
            raise NotImplementedError(
                "LateInteractionRetriever mesh is not ported yet (ROADMAP Queue 1 item 10, the sharded indexes)"
            )

        def build():
            return LateInteractionIndex(
                RetrievalType.TEXT,
                [doc.late_interaction_index or [] for doc in document_records],
                max_chunk_tokens=max_chunk_tokens,
                limit=k,
                storage_dtype=storage_dtype,
                device=embedder.device,
            )

        index = cached_build(device_cache, document_records,
                             ("late_interaction", k, max_chunk_tokens, storage_dtype, False, str(embedder.device)),
                             build,
                             warm=lambda idx: idx.warm_query_buckets())
        return cls(embedder=embedder, index=index)

    def retrieve(self, query: str) -> list[SearchHit]:
        return self.index.find(self.embedder.embed_query_tokens(query))

    def retrieve_batch(self, queries: list[str]) -> list[list[SearchHit]]:
        """Many queries in one token encode and one batched MaxSim scan."""
        if not queries:
            return []
        return self.index.find_batch(self.embedder.embed_documents_tokens(queries, max_tokens=64))

    async def aretrieve(self, query: str) -> list[SearchHit]:
        """The query's rows left on the device (``embed_query_tokens_device``,
        in the query dispatch pool), scored in a MaxSim scan coalesced with
        concurrent requests'; the same hits as ``retrieve``."""
        return await self.index.afind(await self.embedder.aembed_query_tokens_device(query))

    @staticmethod
    async def build_index(
        embedder: BgeEmbedder, chunks: list[Chunk], max_chunk_tokens: int = 256
    ) -> list[np.ndarray]:
        """Per-token embeddings of every chunk -> ragged [t_i, D] list (the
        record's ``late_interaction_index``), in the indexing dispatch pool."""
        return await embedder.aembed_documents_tokens([chunk.text for chunk in chunks], max_chunk_tokens)
