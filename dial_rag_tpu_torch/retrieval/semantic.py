"""Semantic (dense) retriever over the local embedding model (counterpart
of ``dial_rag_tpu/retrieval/semantic.py``).

Build: embed every chunk text and append the rows to a dense index.
Query: embed the query (with the instruction prefix) and scan the index.
The metric defaults to sqeuclidean, as in the reference.
"""

import asyncio

import numpy as np

from dial_rag_tpu_torch.documents.model import (
    Chunk,
    MultiEmbeddings,
    create_doc_embeddings_by_chunk,
    pack_simple_embeddings,
)
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.dense_index import DenseIndex
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.ops.metrics import Metric


class SemanticRetriever:
    def __init__(self, embedder: BgeEmbedder, index: DenseIndex):
        self.embedder = embedder
        self.index = index

    @classmethod
    def from_doc_records(
        cls,
        embedder: BgeEmbedder,
        document_records: list,
        k: int = 1,
        metric: Metric = Metric.SQEUCLIDEAN_DIST,
        storage_dtype: str = "float32",
    ) -> "SemanticRetriever":
        """``document_records``: records carrying ``embeddings_index``
        (MultiEmbeddings or None), one per document, in document order.
        The index lives on the embedder's device."""
        doc_embeddings = [
            create_doc_embeddings_by_chunk(doc.embeddings_index)
            for doc in document_records
            if doc.embeddings_index is not None
        ]
        index = DenseIndex(
            RetrievalType.TEXT,
            doc_embeddings,
            metric=metric,
            limit=k,
            storage_dtype=storage_dtype,
            device=embedder.device,
        )
        return cls(embedder=embedder, index=index)

    def retrieve(self, query: str) -> list[SearchHit]:
        return self.index.find(self.embedder.embed_query(query))

    def retrieve_batch(self, queries: list[str]) -> list[list[SearchHit]]:
        """Many queries in one batched encode and one index scan."""
        if not queries:
            return []
        return self.index.find_batch(self.embedder.embed_queries(queries))

    async def aretrieve(self, query: str) -> list[SearchHit]:
        """``retrieve`` in the loop's executor."""
        return await asyncio.get_running_loop().run_in_executor(None, self.retrieve, query)

    @staticmethod
    def build_index(embedder: BgeEmbedder, chunks: list[Chunk]) -> MultiEmbeddings:
        """Embed all chunk texts -> MultiEmbeddings (one [1, D] per chunk)."""
        embeddings: np.ndarray = embedder.embed_documents([c.text for c in chunks])
        return pack_simple_embeddings(embeddings)
