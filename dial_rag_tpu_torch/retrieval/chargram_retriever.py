"""Char-n-gram fuzzy-lexical retriever over document records (counterpart
of ``dial_rag_tpu/retrieval/chargram_retriever.py``).

The same structure as ``Bm25Retriever``: a record persists each chunk's
surface words (``chargram_index``); the scoring structure is built at
construction from every record's items flattened in document order, on
the device (``index/chargram.py``, a weighted-query ``Bm25Index``). Ties
go to the later item, as BM25's do. With ``mesh`` the inner index's item
rows shard over its devices through the BM25 sharded indexes. ``aretrieve`` coalesces with
concurrent requests' scoring.
"""

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord
from dial_rag_tpu_torch.index.chargram import _WORD_RE, DEFAULT_N_HI, DEFAULT_N_LO, ChargramIndex, chargram_words
from dial_rag_tpu_torch.index.device_cache import cached_build
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit


class ChargramRetriever:
    def __init__(self, doc_ids: np.ndarray, offsets: np.ndarray, index: ChargramIndex, k: int):
        # the flat item -> (doc, chunk) map of Bm25Retriever, O(docs)
        self._doc_ids = doc_ids
        self._offsets = offsets
        self._index = index
        self.k = k

    def _hit(self, i: int, score: float) -> SearchHit:
        j = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return SearchHit(
            doc_id=int(self._doc_ids[j]),
            chunk_id=int(i - self._offsets[j]),
            retrieval_type=RetrievalType.TEXT,
            score=float(score),
        )

    @staticmethod
    def _iter_items(doc_records: list[DocumentRecord]):
        for i, doc in enumerate(doc_records):
            if doc.chargram_index is not None:
                for chunk_index, words in enumerate(doc.chargram_index):
                    yield i, chunk_index, words

    @staticmethod
    def has_index(document_records: list[DocumentRecord]) -> bool:
        """True iff some chunk carries a word the index build keeps (the
        filter of ``ChargramIndex._sanitize``), so that the build cannot
        fail on records whose words are all invalid."""
        return any(
            len(w) <= 1024 and _WORD_RE.fullmatch(w)
            for _, _, words in ChargramRetriever._iter_items(document_records)
            for w in words
        )

    @classmethod
    def from_doc_records(
        cls,
        doc_records: list[DocumentRecord],
        k: int = 7,
        n_lo: int = DEFAULT_N_LO,
        n_hi: int = DEFAULT_N_HI,
        device: str | torch.device = "cuda",
        device_cache=None,
        mesh=None,
    ) -> "ChargramRetriever":
        """The index over every record's chargram words, on ``device``, or
        with ``mesh`` its gram-weight rows sharded over the mesh's devices
        (the inner index is a weighted-query ``Bm25Index``); with
        ``device_cache`` reused across requests over the same records."""
        doc_ids, counts = [], []
        for i, doc in enumerate(doc_records):
            if doc.chargram_index is not None:
                doc_ids.append(i)
                counts.append(len(doc.chargram_index))
        offsets = np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))])

        def build():
            word_lists = [words for _, _, words in cls._iter_items(doc_records)]
            if mesh is not None:
                from dial_rag_tpu_torch.parallel.sharded_index import ShardedBm25Index, ShardedBm25SparseIndex

                cg = ChargramIndex.build(word_lists, n_lo=n_lo, n_hi=n_hi, device="cpu", max_band_bytes=0)
                if cg.inner._weights is not None:
                    return cg.with_inner(ShardedBm25Index(cg.inner, mesh, limit=k))
                return cg.with_inner(ShardedBm25SparseIndex(cg.inner, mesh, limit=k))
            return ChargramIndex.build(word_lists, n_lo=n_lo, n_hi=n_hi, device=device)

        index = cached_build(device_cache, doc_records,
                             ("chargram", k, n_lo, n_hi, mesh is not None,
                              str(mesh.first_device if mesh else resolve_device(device))), build,
                             warm=lambda idx: idx.warm_query_buckets(k))
        return cls(doc_ids=np.asarray(doc_ids, dtype=np.int64), offsets=offsets, index=index, k=k)

    def retrieve(self, query: str) -> list[SearchHit]:
        top, scores = self._index.top_n_with_scores(query, self.k)
        return [self._hit(i, s) for i, s in zip(top, scores)]

    def retrieve_batch(self, queries: list[str]) -> list[list[SearchHit]]:
        """Many queries in blocks of ``index.bm25.Q_BLOCK``; the same hits
        as ``retrieve`` of each."""
        tops = self._index.top_n_batch_with_scores(queries, self.k)
        return [[self._hit(i, s) for i, s in zip(top, scores)] for top, scores in tops]

    async def aretrieve(self, query: str) -> list[SearchHit]:
        top, scores = await self._index.atop_n_with_scores(query, self.k)
        return [self._hit(i, s) for i, s in zip(top, scores)]

    @staticmethod
    async def build_index(chunks: list[Chunk]) -> list[list[str]]:
        """Surface words of each chunk, for the record's ``chargram_index``
        (grams and the corpus idf derive at construction), in the parse
        pool."""
        from dial_rag_tpu_torch.runtime.host_pools import run_in_parse_pool

        return await run_in_parse_pool(lambda: [chargram_words(c.text) for c in chunks])
