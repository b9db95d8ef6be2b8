"""BM25 keyword retriever over document records (counterpart of
``dial_rag_tpu/retrieval/bm25_retriever.py``).

A record's persisted text index is its chunks' keyword tokens; the scoring
structure is built at construction from every record's items, flattened
in document order. Query preprocessing and the top-n tie-break (later item
first) are the reference's; scoring runs on the device
(``index/bm25.py``). Word-vector query expansion (``expansion_config``)
scores each query as a stem -> weight mapping instead.
"""

import asyncio

import numpy as np
import torch

from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord
from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.text.keywords import keywords_preprocess
from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig, build_word_vectors, expand_query


class Bm25Retriever:
    def __init__(self, doc_ids: np.ndarray, offsets: np.ndarray, index: Bm25Index, k: int, expander=None):
        # flat item i belongs to contributing document j, the offsets bucket
        # holding i: doc_id = doc_ids[j], chunk_id = i - offsets[j]. O(docs)
        # to build, where a (doc, chunk) list would be O(items)
        self._doc_ids = doc_ids  # [d] record index of each contributing document
        self._offsets = offsets  # [d + 1] cumulative chunk counts
        self._index = index
        self.k = k
        # query -> stem weights (word-vector query expansion); None: the
        # reference's stemmed token queries
        self._expander = expander

    def _preprocess(self, query: str):
        if self._expander is not None:
            return self._expander(query)
        return keywords_preprocess(query)

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
            if doc.text_index is not None:
                for chunk_index, tokens in enumerate(doc.text_index):
                    yield i, chunk_index, tokens

    @staticmethod
    def has_index(document_records: list[DocumentRecord]) -> bool:
        return any(len(tokens) > 0 for _, _, tokens in Bm25Retriever._iter_items(document_records))

    @classmethod
    def from_doc_records(
        cls,
        doc_records: list[DocumentRecord],
        k: int = 4,
        device: str | torch.device = "cuda",
        device_cache=None,
        mesh=None,
        expansion_config: QueryExpansionConfig | None = None,
    ) -> "Bm25Retriever":
        """The index over every record's text index, on ``device``; raises
        if no record has a token.

        ``expansion_config`` turns on word-vector query expansion: word
        vectors are built from the records' chunk texts here, and each
        query scores as a stem -> weight mapping through the weighted-query
        path. Scores of unexpanded terms are unchanged."""
        for name, value, item in (
            ("mesh", mesh, "Queue 1 item 10, the sharded indexes"),
            ("device_cache", device_cache, "Queue 1 item 7, the device-index cache"),
        ):
            if value is not None:
                raise NotImplementedError(f"Bm25Retriever {name} is not ported yet (ROADMAP {item})")
        doc_ids, counts = [], []
        for i, doc in enumerate(doc_records):
            if doc.text_index is not None:
                doc_ids.append(i)
                counts.append(len(doc.text_index))
        offsets = np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))])
        tokenized = [tokens for _, _, tokens in cls._iter_items(doc_records)]
        index = Bm25Index.build(tokenized, device=device)
        expander = None
        if expansion_config is not None:
            ec = expansion_config
            wv = build_word_vectors(
                [c.text for doc in doc_records if doc.text_index is not None for c in doc.chunks],
                window=ec.window, dim=ec.dim, min_count=ec.min_count, max_vocab=ec.max_vocab,
            )

            def expander(query: str):
                return expand_query(query, wv, m=ec.neighbors, alpha=ec.alpha, sim_min=ec.sim_min)

        return cls(
            doc_ids=np.asarray(doc_ids, dtype=np.int64), offsets=offsets, index=index, k=k, expander=expander
        )

    def retrieve(self, query: str) -> list[SearchHit]:
        top, scores = self._index.top_n_with_scores(self._preprocess(query), self.k)
        return [self._hit(i, s) for i, s in zip(top, scores)]

    def retrieve_batch(self, queries: list[str]) -> list[list[SearchHit]]:
        """Many queries in blocks of ``index.bm25.Q_BLOCK``, each one device
        pass; the same hits as ``retrieve`` of each."""
        tops = self._index.top_n_batch_with_scores([self._preprocess(q) for q in queries], self.k)
        return [[self._hit(i, s) for i, s in zip(top, scores)] for top, scores in tops]

    async def aretrieve(self, query: str) -> list[SearchHit]:
        return await asyncio.get_running_loop().run_in_executor(None, self.retrieve, query)

    @staticmethod
    def build_index(chunks: list[Chunk]) -> list[list[str]]:
        """Keyword tokens of each chunk's text, for the record's text index
        (host work, run in the caller's thread)."""
        return [keywords_preprocess(c.text) for c in chunks]
