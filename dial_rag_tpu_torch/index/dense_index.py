"""Device-resident dense embedding index with distance + stable top-k
(counterpart of ``dial_rag_tpu/index/dense_index.py``, float32 and
bfloat16 layouts).

One flat ``[N, D]`` matrix in document order, then within-document
order. A single global stable top-``limit`` over all rows selects the same
hits, in the same tie order, as the reference's per-document scan: among
equal distances the earliest row wins. Squared row norms are cached at
build time, so the norm-bearing metrics read the matrix once per query.
"""

from dataclasses import dataclass

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.ops.metrics import Metric, pairwise_distances_batch, row_norm2
from dial_rag_tpu_torch.ops.stable_topk import stable_topk

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class DocEmbeddings:
    """Per-document flat embeddings: row i maps to chunk_ids[i]."""

    chunk_ids: np.ndarray  # [n] int
    embeddings: np.ndarray  # [n, D] f32

    def __post_init__(self):
        self.chunk_ids = np.asarray(self.chunk_ids, dtype=np.int64)
        self.embeddings = np.asarray(self.embeddings, dtype=np.float32)
        if self.embeddings.ndim == 1:  # empty
            self.embeddings = self.embeddings.reshape(0, 0)

    @property
    def num_rows(self) -> int:
        return self.embeddings.shape[0]


def hits_from_topk(
    vals, idx, n_rows, doc_ids, chunk_ids, retrieval_type
) -> tuple[list[SearchHit], list[float]]:
    """(values, indices) of a top-k -> SearchHits + distances. ``vals`` are
    distance-like (lower is better), so each hit carries ``score=-v``.
    Stops at an index past ``n_rows`` (fewer rows than k)."""
    hits: list[SearchHit] = []
    dists: list[float] = []
    for v, i in zip(vals, idx):
        if i >= n_rows:
            break
        v = float(v)
        hits.append(
            SearchHit(
                doc_id=int(doc_ids[i]),
                chunk_id=int(chunk_ids[i]),
                retrieval_type=retrieval_type,
                score=-v if np.isfinite(v) else None,
            )
        )
        dists.append(v)
    return hits, dists


class DenseIndex:
    """Flat dense index over several documents; queries scan on ``device``."""

    def __init__(
        self,
        retrieval_type: RetrievalType,
        doc_embeddings: list[DocEmbeddings],
        metric: Metric | str = Metric.SQEUCLIDEAN_DIST,
        limit: int = 1,
        storage_dtype: str = "float32",
        device: str | torch.device = "cuda",
    ):
        """``storage_dtype="bfloat16"`` stores the matrix half-size;
        distances still run in f32, and ranking differs from the f32 index
        only between near-tied rows."""
        if storage_dtype not in _STORAGE:
            raise ValueError(
                f"storage_dtype {storage_dtype!r} is not ported yet; "
                f"use one of {sorted(_STORAGE)}"
            )
        self.retrieval_type = retrieval_type
        self.metric = Metric(metric)
        self.limit = limit
        self.storage_dtype = storage_dtype
        self.device = resolve_device(device)
        non_empty = [(i, d) for i, d in enumerate(doc_embeddings) if d.num_rows]
        doc_ids = np.concatenate(
            [np.full(d.num_rows, i, dtype=np.int64) for i, d in non_empty]
            or [np.zeros(0, np.int64)]
        )
        chunk_ids = np.concatenate([d.chunk_ids for _, d in non_empty] or [np.zeros(0, np.int64)])
        emb = (
            torch.from_numpy(np.concatenate([d.embeddings for _, d in non_empty], axis=0))
            if non_empty
            else None
        )
        self._set_rows(emb, doc_ids, chunk_ids)

    @classmethod
    def from_device_matrix(
        cls,
        retrieval_type: RetrievalType,
        emb: torch.Tensor,
        chunk_ids: np.ndarray | None = None,
        doc_ids: np.ndarray | None = None,
        metric: Metric | str = Metric.SQEUCLIDEAN_DIST,
        limit: int = 1,
    ) -> "DenseIndex":
        """An index over an [n, D] matrix already on the device (the
        encode-append path: ``embed_documents_device`` -> here), kept in
        its own dtype without a host round trip."""
        self = cls.__new__(cls)
        self.retrieval_type = retrieval_type
        self.metric = Metric(metric)
        self.limit = limit
        self.storage_dtype = str(emb.dtype).removeprefix("torch.")
        if self.storage_dtype not in _STORAGE:
            raise ValueError(f"unsupported matrix dtype {emb.dtype}")
        self.device = emb.device
        n = int(emb.shape[0])
        self._set_rows(
            emb if n else None,
            np.zeros(n, np.int64) if doc_ids is None else np.asarray(doc_ids, np.int64),
            np.arange(n, dtype=np.int64) if chunk_ids is None else np.asarray(chunk_ids, np.int64),
        )
        return self

    def _set_rows(self, emb, doc_ids, chunk_ids):
        self._doc_ids = doc_ids
        self._chunk_ids = chunk_ids
        if emb is None:
            self.n_rows, self.dim = 0, 0
            self._emb = self._rn2 = None
            return
        self.n_rows, self.dim = int(emb.shape[0]), int(emb.shape[1])
        self._emb = emb.to(self.device, dtype=_STORAGE[self.storage_dtype]).contiguous()
        self._rn2 = row_norm2(self._emb)

    @property
    def nbytes(self) -> int:
        return 0 if self._emb is None else self._emb.numel() * self._emb.element_size()

    def _topk(self, queries: torch.Tensor):
        """[Q, D] -> (values, indices) [Q, k] on the host."""
        queries = queries.to(self.device, dtype=torch.float32).reshape(-1, self.dim)
        dists = pairwise_distances_batch(queries, self._emb, self.metric, self._rn2)
        vals, idx = stable_topk(dists, min(self.limit, self.n_rows))
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _as_tensor(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return queries
        return torch.from_numpy(np.asarray(queries, dtype=np.float32))

    def find_with_distances(self, query) -> tuple[list[SearchHit], list[float]]:
        if self._emb is None:
            return [], []
        vals, idx = self._topk(self._as_tensor(query).reshape(1, -1))
        return hits_from_topk(
            vals[0], idx[0], self.n_rows, self._doc_ids, self._chunk_ids, self.retrieval_type
        )

    def find(self, query) -> list[SearchHit]:
        return self.find_with_distances(query)[0]

    def find_batch(self, queries) -> list[list[SearchHit]]:
        """Per-query hits for ``queries`` [Q, D] in one scan of the matrix;
        identical results to Q ``find`` calls."""
        queries = self._as_tensor(queries)
        if queries.shape[0] == 0 or self._emb is None:
            return [[] for _ in range(queries.shape[0])]
        vals, idx = self._topk(queries)
        return [
            hits_from_topk(
                vals[q], idx[q], self.n_rows, self._doc_ids, self._chunk_ids, self.retrieval_type
            )[0]
            for q in range(len(vals))
        ]
