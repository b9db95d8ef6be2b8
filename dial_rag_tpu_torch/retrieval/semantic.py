"""Semantic (dense) retriever over the local embedding model (counterpart
of ``dial_rag_tpu/retrieval/semantic.py``).

Build: embed every chunk text and append the rows to a dense index.
Query: embed the query (with the instruction prefix) and scan the index.
The metric defaults to sqeuclidean, as in the reference. ``aretrieve``
coalesces with concurrent requests: their query encodes share one encode
(``BgeEmbedder.aembed_query``) and their scans one scan
(``DenseIndex.afind``). With ``mesh`` the chunk matrix is row-sharded over
its devices (``parallel/sharded_index.py``), in every storage layout.
"""

import numpy as np

from dial_rag_tpu_torch.documents.model import (
    Chunk,
    MultiEmbeddings,
    create_doc_embeddings_by_chunk,
    pack_simple_embeddings,
)
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.dense_index import DenseIndex
from dial_rag_tpu_torch.index.device_cache import cached_build
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
        device_cache=None,
        mesh=None,
    ) -> "SemanticRetriever":
        """``document_records``: records carrying ``embeddings_index``
        (MultiEmbeddings or None), one per document, in document order.
        The index lives on the embedder's device, or with ``mesh`` row-sharded
        over its devices (per-shard stable top-k, one stable merge). With
        ``device_cache`` (``index.device_cache.DeviceIndexCache``) the built
        index is reused across requests over the same records."""

        def build():
            doc_embeddings = [
                create_doc_embeddings_by_chunk(doc.embeddings_index)
                for doc in document_records
                if doc.embeddings_index is not None
            ]
            if mesh is not None:
                from dial_rag_tpu_torch.parallel.sharded_index import ShardedDenseIndex

                return ShardedDenseIndex(
                    RetrievalType.TEXT, doc_embeddings, mesh, metric=metric, limit=k, storage_dtype=storage_dtype
                )
            return DenseIndex(
                RetrievalType.TEXT,
                doc_embeddings,
                metric=metric,
                limit=k,
                storage_dtype=storage_dtype,
                device=embedder.device,
            )

        key = ("semantic", str(metric), k, mesh is not None, storage_dtype, str(embedder.device))
        index = cached_build(device_cache, document_records, key, build, warm=lambda idx: idx.warm_query_buckets())
        return cls(embedder=embedder, index=index)

    def retrieve(self, query: str) -> list[SearchHit]:
        return self.index.find(self.embedder.embed_query(query))

    def retrieve_batch(self, queries: list[str]) -> list[list[SearchHit]]:
        """Many queries in one batched encode and one index scan."""
        if not queries:
            return []
        return self.index.find_batch(self.embedder.embed_queries(queries))

    async def aretrieve(self, query: str) -> list[SearchHit]:
        """The query's row of a coalesced encode, scanned in a coalesced
        scan: the hits of ``retrieve`` but for near-ties."""
        return await self.index.afind(await self.embedder.aembed_query(query))

    @staticmethod
    async def build_index(embedder: BgeEmbedder, chunks: list[Chunk]) -> MultiEmbeddings:
        """Embed all chunk texts -> MultiEmbeddings (one [1, D] per chunk),
        in the indexing dispatch pool (``aembed_documents``)."""
        embeddings: np.ndarray = await embedder.aembed_documents([c.text for c in chunks])
        return pack_simple_embeddings(embeddings)
