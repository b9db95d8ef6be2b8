"""Device-resident dense embedding index with distance + stable top-k
(counterpart of ``dial_rag_tpu/index/dense_index.py``).

One flat ``[N, D]`` matrix in document order, then within-document
order. A single global stable top-``limit`` over all rows selects the same
hits, in the same tie order, as the reference's per-document scan: among
equal distances the earliest row wins. Squared row norms are cached at
build time, so the norm-bearing metrics read the matrix once per query.

Layouts (``storage_dtype``):

- ``float32``, ``bfloat16``: the matrix itself; distances in f32;
- ``two_pass``: a bf16 copy scanned first and the f32 rows of a certified
  candidate window rescored, the same hits as the f32 scan at near-bf16
  scan cost (``_two_pass``);
- ``int8``: per-row absmax-quantized rows scanned as one s8 x s8 -> s32
  product, a quarter of the f32 bytes (``int8_distances``).

Every scan goes over the matrix a block of rows at a time (``_full_scan``),
so a scan holds one block's f32 rows (about a sixteenth of the index),
never an f32 copy of a bf16 matrix. Scores that fit the same budget whole
(a lone query's) are ranked by one stable top-k; a batch's are ranked a
block at a time and the blocks' winners merged, so it never holds a [Q, N]
score matrix. Matrices built from host rows are padded with zero rows to
the JAX package's row buckets (``_bucket_rows``), so two_pass's candidate
window is the JAX package's. The JAX package answers one float32 or
bfloat16 query through block-select (block minima, a certified window, a
fallback to the full scan); its hits are the full scan's by construction,
so the port takes the full scan.

Serving: concurrent ``afind`` calls coalesce into one ``find_batch`` a
wave (``runtime/micro_batcher.py``). A wave whose queries are the rows, in
order, of one encode's output, as ``BgeEmbedder.aembed_query`` tags them
(``micro_batcher.wave_rows``), scans that output's first wave-bucket rows
in place; any other wave is stacked once, padded to the wave bucket.
"""

from dataclasses import dataclass

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.ops.metrics import Metric, block_distances, distances_from_dot, int8_matmul, row_norm2
from dial_rag_tpu_torch.ops.stable_topk import stable_topk_rows
from dial_rag_tpu_torch.runtime import micro_batcher
from dial_rag_tpu_torch.runtime.micro_batcher import PerLoopBatcher, per_loop_batcher, wave_parent

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "two_pass": None, "int8": torch.int8}

# two_pass: pass 1's scores in blocks of _TP_BLK rows; the
# _TP_CBLK blocks with the smallest minima are the candidate window
_TP_BLK = 128
_TP_CBLK = 64

# a scan block may hold about this share of the index's bytes beyond it
# (its rows upcast to f32, its [Q, rows] scores and their top-k keys), within
# these bounds: fewer blocks launch fewer kernels, and the host paces the
# scan (scripts/dense_scan_variants.py)
_SCAN_SHARE = 1 / 16
_SCAN_BYTES = (48 << 20, 512 << 20)
_ROW_QUANTUM = 512  # scan blocks are whole multiples of it (and of _TP_BLK)


def _wave_bucket(q: int) -> int:
    """The JAX package's wave bucket of ``q`` queries: a power of two, at
    least 8."""
    return 1 << max(3, (q - 1).bit_length())


def _bucket_rows(n: int) -> int:
    """The JAX package's row bucket: 512-row steps up to 4096, then
    quarter-octave steps (p, 1.25p, 1.5p, 1.75p, 2p); every step is a
    multiple of 512."""
    n = max(n, 1)
    if n <= 4096:
        return -(-n // 512) * 512
    p = 4096
    while p < n:
        if n <= p + p // 4:
            return p + p // 4
        if n <= p + p // 2:
            return p + p // 2
        if n <= p + 3 * p // 4:
            return p + 3 * p // 4
        p *= 2
    return p


def _sel_metric(metric: Metric) -> Metric:
    """Pass 1 ranks euclidean distances by their squares."""
    return Metric.SQEUCLIDEAN_DIST if metric == Metric.EUCLIDEAN_DIST else metric


def _two_pass_bound(q_sq, err_a, err_b, norm_max, d: int, sel_metric: Metric):
    """Upper bound [Q] on |s_pass1 - s_f32| per row (the JAX package's
    ``_two_pass_bound``). Pass 1 computes q . bf16(x) in f32 with the f32
    query, so the stored rows are the only perturbation: for sqeuclidean
    |s~ - s| <= err_b + 2 |q| err_a, for the inner product |q| err_a.
    ``eps_round`` covers the f32 rounding by which two products of the same
    rows differ (5x D u |q| |x|), and the whole is doubled."""
    qn = torch.sqrt(q_sq)
    scale = (qn + err_a) * (norm_max + err_a) + (norm_max + err_a) ** 2
    eps_round = 3e-7 * d * scale
    if sel_metric == Metric.SQEUCLIDEAN_DIST:
        e = err_b + 2.0 * qn * err_a + eps_round
    else:
        e = qn * err_a + eps_round
    return 2.0 * e


def _select(tops: torch.Tensor, e_bound: torch.Tensor, k: int):
    """Candidate window of pass 1 (the JAX package's ``_two_pass_select``).

    ``tops`` [Q, NB, kk] holds each _TP_BLK-row block's kk = min(k,
    _TP_BLK) smallest pass-1 scores, ascending (padding rows +inf). The
    _TP_CBLK blocks with the smallest minima (earliest block on ties) are
    the window. ``ok`` [Q] holds when the worst selected minimum lies
    strictly above the window's k-th smallest score plus 2E: every row
    outside the window then scores above any row of the true top-k, ties
    included. Returns (ok, selected blocks [Q, cb] ascending)."""
    nb = tops.shape[1]
    cb = min(_TP_CBLK, nb)
    mins, blk = stable_topk_rows(tops[:, :, 0], torch.arange(nb, device=tops.device), cb)
    cut = mins[:, -1]
    blk = torch.sort(blk, dim=-1).values
    cand = torch.gather(tops, 1, blk[:, :, None].expand(-1, -1, tops.shape[2])).flatten(1)
    kth = torch.topk(cand, min(k, cb * _TP_BLK), dim=-1, largest=False, sorted=True).values[:, -1]
    return cut > kth + 2.0 * e_bound, blk


def _block_tops(s1: torch.Tensor, k: int) -> torch.Tensor:
    """[Q, R] pass-1 scores (R a multiple of _TP_BLK) -> [Q, R/_TP_BLK, kk]
    each block's kk = min(k, _TP_BLK) smallest, ascending."""
    blocks = s1.view(s1.shape[0], -1, _TP_BLK)
    return torch.topk(blocks, min(k, _TP_BLK), dim=-1, largest=False, sorted=True).values


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


def quantize_rows_int8(emb: np.ndarray):
    """Per-row absmax int8 quantization on the host, as the JAX package
    builds its int8 layout -> (rows [N, D] int8, scales [N] f32, squared
    norms [N] f32 of the dequantized rows). The squared norms are exact: the
    sum of squared int8 values is an exact integer, scaled in f64."""
    emb = np.asarray(emb, dtype=np.float32)
    absmax = np.max(np.abs(emb), axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.rint(emb / scales[:, None]).astype(np.int8)
    sumsq = np.einsum("ij,ij->i", q.astype(np.int32), q.astype(np.int32), dtype=np.int64)
    norm2 = (scales.astype(np.float64) ** 2 * sumsq.astype(np.float64)).astype(np.float32)
    return q, scales, norm2


def quantize_queries_int8(queries: torch.Tensor):
    """Per-query absmax int8 quantization with the zero-vector guard ->
    (q8 [Q, D] int8, scales [Q, 1] f32)."""
    sq = torch.amax(torch.abs(queries), dim=-1, keepdim=True) / 127.0
    sq = torch.where(sq > 0, sq, 1.0)
    return torch.round(queries / sq).to(torch.int8), sq


def int8_distances(prod, scales, row_norm2, sq, q_norm2, metric: Metric):
    """Distances from the s32 product ``prod`` [Q, R] of the quantized
    queries and rows (the JAX package's ``_int8_distances``, in its order
    of operations): the product dequantized as ``prod * (sq * scales)``,
    then ``max(|q|^2 - 2 dot + |x|^2, 0)`` with the rows' exact squared
    norms. ``q_norm2`` [Q] is the f32 squared norm of the f32 queries."""
    dot = prod.float().mul_(sq * scales[None, :])
    if metric == Metric.INNER_PRODUCT:
        return dot.neg_()
    sqe = dot.mul_(-2.0).add_(q_norm2[:, None]).add_(row_norm2[None, :]).clamp_(min=0.0)
    return sqe.sqrt_() if metric == Metric.EUCLIDEAN_DIST else sqe


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
        only between near-tied rows. ``"two_pass"`` keeps a bf16 and an f32
        copy (1.5x the f32 bytes) and returns the f32 scan's hits.
        ``"int8"`` stores per-row absmax-quantized rows (a quarter of the
        f32 bytes); near ties can reorder. Neither of the last two takes
        cosine, whose guarded denominator has no query-independent error
        bound."""
        if storage_dtype not in _STORAGE:
            raise ValueError(f"unsupported storage_dtype {storage_dtype!r}; use one of {sorted(_STORAGE)}")
        self.retrieval_type = retrieval_type
        self.metric = Metric(metric)
        self.limit = limit
        self.storage_dtype = storage_dtype
        if storage_dtype in ("two_pass", "int8") and self.metric == Metric.COSINE_SIM:
            raise ValueError(
                f"{storage_dtype} storage does not support cosine_sim (the eps-guarded denominator has no "
                "query-independent certified error bound); use float32"
            )
        self.device = resolve_device(device)
        non_empty = [(i, d) for i, d in enumerate(doc_embeddings) if d.num_rows]
        self._doc_ids = np.concatenate(
            [np.full(d.num_rows, i, dtype=np.int64) for i, d in non_empty] or [np.zeros(0, np.int64)]
        )
        self._chunk_ids = np.concatenate([d.chunk_ids for _, d in non_empty] or [np.zeros(0, np.int64)])
        self._clear()
        if not non_empty:
            return
        emb = np.concatenate([d.embeddings for _, d in non_empty], axis=0)
        self.n_rows, self.dim = emb.shape
        emb = np.pad(emb, ((0, _bucket_rows(self.n_rows) - self.n_rows), (0, 0)))
        if storage_dtype == "int8":
            q, scales, norm2 = quantize_rows_int8(emb)
            self._emb = torch.from_numpy(q).to(self.device)
            self._scales = torch.from_numpy(scales).to(self.device)
            self._rn2 = torch.from_numpy(norm2).to(self.device)
        elif storage_dtype == "two_pass":
            self._emb_f32 = torch.from_numpy(emb).to(self.device)
            self._emb = self._emb_f32.to(torch.bfloat16)
            self._rn2 = self._row_norm2(self._emb)
            self._rn2_f32 = self._row_norm2(self._emb_f32)
            self._err = self._two_pass_error_terms()
        else:
            self._set_matrix(torch.from_numpy(emb).to(self.device, dtype=_STORAGE[storage_dtype]))

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
        its own dtype and rows without a copy."""
        self = cls.__new__(cls)
        self.retrieval_type = retrieval_type
        self.metric = Metric(metric)
        self.limit = limit
        self.storage_dtype = str(emb.dtype).removeprefix("torch.")
        if self.storage_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported matrix dtype {emb.dtype}")
        self.device = emb.device
        n = int(emb.shape[0])
        self._doc_ids = np.zeros(n, np.int64) if doc_ids is None else np.asarray(doc_ids, np.int64)
        self._chunk_ids = np.arange(n, dtype=np.int64) if chunk_ids is None else np.asarray(chunk_ids, np.int64)
        self._clear()
        if n:
            self.n_rows, self.dim = n, int(emb.shape[1])
            self._set_matrix(emb.contiguous())
        return self

    def _clear(self):
        self.n_rows, self.dim = 0, 0
        self._emb = self._rn2 = self._emb_f32 = self._rn2_f32 = self._scales = None
        self._err = None

    def _set_matrix(self, emb: torch.Tensor):
        """A float32 / bfloat16 matrix and its cached squared norms."""
        self._emb = emb
        self._rn2 = self._row_norm2(emb)

    def _row_blocks(self, per_row_bytes: int):
        """[r0, r1) blocks over the stored rows, each a whole multiple of
        _ROW_QUANTUM rows (but the last) holding about _SCAN_SHARE of the
        index's bytes."""
        n = self._emb.shape[0]
        r = max(_ROW_QUANTUM, self._scan_budget() // max(per_row_bytes, 1) // _ROW_QUANTUM * _ROW_QUANTUM)
        return [(r0, min(r0 + r, n)) for r0 in range(0, n, r)]

    def _scan_budget(self) -> int:
        return min(max(int(self.nbytes * _SCAN_SHARE), _SCAN_BYTES[0]), _SCAN_BYTES[1])

    def _row_norm2(self, emb: torch.Tensor) -> torch.Tensor:
        """Squared f32 norms of the rows, a block at a time."""
        return torch.cat([row_norm2(emb[r0:r1]) for r0, r1 in self._row_blocks(emb.shape[1] * 8)])

    def _two_pass_error_terms(self):
        """(err_a, err_b, norm_max): max_i ||x_i - bf16(x_i)||, max_i
        | ||bf16(x_i)||^2 - ||x_i||^2 |, max_i ||x_i|| over the stored rows
        (zero padding rows add nothing)."""
        err2 = torch.cat([
            torch.sum((self._emb_f32[r0:r1] - self._emb[r0:r1].float()) ** 2, dim=-1)
            for r0, r1 in self._row_blocks(self.dim * 12)
        ])
        err_a = torch.sqrt(torch.max(err2))
        err_b = torch.max(torch.abs(self._rn2 - self._rn2_f32))
        return err_a, err_b, torch.sqrt(torch.max(self._rn2_f32))

    @property
    def nbytes(self) -> int:
        if self._emb is None:
            return 0
        total = self._emb.numel() * self._emb.element_size()
        if self._emb_f32 is not None:
            total += self._emb_f32.numel() * 4
        if self._scales is not None:
            total += self._scales.numel() * 4 + self._rn2.numel() * 4
        return total

    # --- scans ---------------------------------------------------------------

    def _prepare(self, queries: torch.Tensor):
        """[q, D] queries -> (f32 [q, D] on the device; their squared
        norms). A lone query stays one row: a [1, D] product rounds as the
        reference's matvec does, closer than a padded batch's."""
        queries = queries.to(self.device, dtype=torch.float32).reshape(-1, self.dim)
        return queries, torch.sum(queries * queries, dim=-1)

    def _per_row_bytes(self, q_rows: int, upcast: bool) -> int:
        """A block's bytes a row: its f32 upcast and its scores, then its
        scores and their top-k keys (int64, and one int64 temporary)."""
        return max((self.dim * 4 + q_rows * 4) if upcast else 0, q_rows * 24)

    def _scan(self, queries, q_sq, metric, emb, rn2):
        """Yields (r0, r1, [Q, r1 - r0] distances) over the stored rows of
        ``emb`` (the int8 layout when ``emb`` is None), +inf past n_rows."""
        upcast = emb is not None and emb.dtype != torch.float32
        if emb is None:
            q8, sq = quantize_queries_int8(queries)
            q8 = q8.T
        for r0, r1 in self._row_blocks(self._per_row_bytes(queries.shape[0], upcast)):
            if emb is None:
                prod = int8_matmul(self._emb[r0:r1], q8).T
                d = int8_distances(prod, self._scales[r0:r1], rn2[r0:r1], sq, q_sq, metric)
            else:
                d = block_distances(queries, q_sq, emb[r0:r1], rn2[r0:r1], metric)
            if r1 > self.n_rows:
                d[:, max(self.n_rows - r0, 0) :] = torch.inf
            yield r0, r1, d

    def _full_scan(self, queries, q_sq, k, emb=None, rn2=None):
        """Stable top-k of every stored row. Scores whose top-k keys fit
        the scan budget are kept whole and ranked once; larger ones are
        ranked a block at a time and the blocks' winners merged (in row
        order, so ties still go to the earliest row)."""
        whole = self._per_row_bytes(queries.shape[0], False) * self._emb.shape[0] <= self._scan_budget()
        vals, rows = [], []
        for r0, r1, d in self._scan(queries, q_sq, self.metric, emb, rn2):
            if whole:
                vals.append(d)
                continue
            v, r = stable_topk_rows(d, torch.arange(r0, r1, device=d.device), k)
            vals.append(v)
            rows.append(r)
        if whole:
            d = torch.cat(vals, dim=1) if len(vals) > 1 else vals[0]
            return stable_topk_rows(d, torch.arange(d.shape[1], device=d.device), k)
        if len(vals) == 1:
            return vals[0], rows[0]
        return stable_topk_rows(torch.cat(vals, dim=1), torch.cat(rows, dim=1), k)

    def _two_pass_window(self, queries, q_sq, k):
        """Pass 1 over the bf16 copy (upcast a block at a time: q .
        bf16(x) in f32 with the f32 query, the product ``_two_pass_bound``
        bounds), each block's smallest scores kept, and each query's window
        -> (ok [Q], selected blocks [Q, cb])."""
        sel = _sel_metric(self.metric)
        tops = torch.cat([_block_tops(d, k) for _, _, d in self._scan(queries, q_sq, sel, self._emb, self._rn2)], dim=1)
        err_a, err_b, norm_max = self._err
        return _select(tops, _two_pass_bound(q_sq, err_a, err_b, norm_max, self.dim, sel), k)

    def _two_pass(self, queries, q_sq, k, n_real: int):
        """The window's f32 rows rescored, in groups of queries. If the
        check of any of the first ``n_real`` queries fails, all take the
        full f32 scan (the rest are padding, whose answers are dropped)."""
        q = queries.shape[0]
        ok, blk = self._two_pass_window(queries, q_sq, k)
        if not bool(ok[:n_real].all()):
            return self._full_scan(queries, q_sq, k, self._emb_f32, self._rn2_f32)
        n_cand = blk.shape[1] * _TP_BLK
        rows = (blk[:, :, None] * _TP_BLK + torch.arange(_TP_BLK, device=blk.device)).reshape(q, n_cand)
        group = max(1, self._scan_budget() // (n_cand * self.dim * 4))
        vals, idx = [], []
        for g0 in range(0, q, group):
            r = rows[g0 : g0 + group]
            x = self._emb_f32[r.reshape(-1)].view(r.shape[0], n_cand, self.dim)
            dot = torch.bmm(x, queries[g0 : g0 + r.shape[0], :, None])[:, :, 0]
            d = distances_from_dot(dot, q_sq[g0 : g0 + r.shape[0], None], self._rn2_f32[r], self.metric)
            d = d.masked_fill_(r >= self.n_rows, torch.inf)
            del x  # before the next group's gather: one group's rows at a time
            v, i = stable_topk_rows(d, r, k)
            vals.append(v)
            idx.append(i)
        return torch.cat(vals), torch.cat(idx)

    def _topk(self, queries: torch.Tensor, n_real: int | None = None):
        """[q, D] -> (values, indices) [n_real, k] on the host, of the first
        ``n_real`` (default all) queries; the rest are scanned too."""
        queries, q_sq = self._prepare(queries)
        n_real = queries.shape[0] if n_real is None else n_real
        k = min(self.limit, self.n_rows)
        if self.storage_dtype == "two_pass":
            vals, idx = self._two_pass(queries, q_sq, k, n_real)
        else:
            vals, idx = self._full_scan(queries, q_sq, k, self._emb if self._scales is None else None, self._rn2)
        return vals[:n_real].cpu().numpy(), idx[:n_real].cpu().numpy()

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

    def find_batch(self, queries, n_real: int | None = None) -> list[list[SearchHit]]:
        """Per-query hits for ``queries`` [Q, D] in one scan of the matrix;
        the same hits as Q ``find`` calls. ``n_real`` marks how many leading
        rows are queries when the rest are padding (a wave's encode
        output): every row is scanned, and the padding's hits dropped."""
        queries = self._as_tensor(queries)
        n = queries.shape[0] if n_real is None else n_real
        if n == 0 or self._emb is None:
            return [[] for _ in range(n)]
        vals, idx = self._topk(queries, n)
        return [
            hits_from_topk(
                vals[q], idx[q], self.n_rows, self._doc_ids, self._chunk_ids, self.retrieval_type
            )[0]
            for q in range(len(vals))
        ]

    def warm_query_buckets(self) -> None:
        """One lone query and one batch at every wave bucket up to
        ``micro_batcher.MAX_WAVE``, on zero queries. PyTorch
        compiles nothing ahead; these calls make the caching allocator's
        first blocks and each shape's first launches happen off the request
        path (the device cache runs this on a thread after a build)."""
        if self._emb is None:
            return
        self.find(torch.zeros(self.dim, device=self.device))
        q = 8  # the smallest wave bucket
        while q <= micro_batcher.MAX_WAVE:
            self.find_batch(torch.zeros((q, self.dim), device=self.device))
            q *= 2

    async def afind(self, query) -> list[SearchHit]:
        """``find`` with cross-request coalescing: concurrent callers' single
        queries share one ``find_batch`` scan and one copy to the host a
        wave. The same hits as ``find``, but for near-ties (a lone query's
        [1, D] product rounds apart from a batch's)."""
        return await self._scan_batcher.submit(query)

    @property
    def _scan_batcher(self) -> PerLoopBatcher:
        return per_loop_batcher(self, "dense_scan", self._scan_wave)

    def _scan_wave(self, queries: list) -> list[list[SearchHit]]:
        if len(queries) == 1:
            return [self.find(queries[0])]  # a lone query keeps the one-row scan
        q, q_pad = len(queries), _wave_bucket(len(queries))
        parent = wave_parent(queries)
        if parent is not None and parent.shape[0] >= q_pad:
            # the rows of one encode wave, in order: scan its output in place
            return self.find_batch(parent[:q_pad], n_real=q)
        rows = [self._as_tensor(x).to(self.device, torch.float32).reshape(-1) for x in queries]
        rows.extend([rows[0]] * (q_pad - q))
        return self.find_batch(torch.stack(rows), n_real=q)
