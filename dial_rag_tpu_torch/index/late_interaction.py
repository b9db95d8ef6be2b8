"""Device-resident late-interaction (MaxSim) index (counterpart of
``dial_rag_tpu/index/late_interaction.py``).

One vector per token; a chunk scores

    score(Q, C) = sum over query tokens q of max over chunk tokens t of <q, t>

Storage is one flat padded ``[N, T, D]`` tensor on the device (rows in
document order, then chunk order, as the dense index) with an ``[N]``
token-count vector; chunks truncate or pad to ``T = max_chunk_tokens``.
Scoring streams the corpus in blocks of ``_ROW_BLOCK`` rows: one ``[block
* T, D] x [D, lanes]`` product per block, tokens past a chunk's count
masked to -inf before the max over T, query lanes past a query's count
masked to 0 before the sum. The sum over a query's lanes is a fixed tree
of halvings, so a query's score is the same bits alone and in a batch.
Scores are negated into distances for the stable top-k: ties go to the
earliest row, and rows with no token score -inf and never surface.

``storage_dtype``: ``float32`` (f32 products, TF32 off), ``bfloat16``
(half the bytes, upcast a block at a time, f32 products) or ``int8`` (per
token absmax-quantized, the query-token columns quantized per column, one
s8 x s8 -> s32 product per block dequantized as ``(prod * token scale) *
query scale`` before the masked max).

Serving: concurrent ``afind`` calls coalesce (``runtime/micro_batcher.py``).
Device queries at one lane bucket (``BgeEmbedder.embed_query_tokens_device``'s
rows) share one scan a group of at most _MAX_Q_LANES lanes, with the scores
``find`` gives each alone; any other query keeps ``find``.
"""

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.index.dense_index import hits_from_topk
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.ops.metrics import int8_matmul
from dial_rag_tpu_torch.ops.stable_topk import stable_topk_rows
from dial_rag_tpu_torch.runtime import micro_batcher
from dial_rag_tpu_torch.runtime.micro_batcher import PerLoopBatcher, per_loop_batcher

# chunk rows scored per step: bounds the [block, T, lanes] transient
# (512 x 256 x 128 f32 = 64 MiB at the lane cap) whatever the corpus size
_ROW_BLOCK = 512

# cap on (queries x query-token bucket) lanes of one product; larger
# batches split into groups, each still one corpus pass for its queries
_MAX_Q_LANES = 128

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _bucket_q(q: int) -> int:
    """Query token count -> its power-of-two lane bucket (>= 8)."""
    return 1 << max(3, (q - 1).bit_length())


def _bucket_rows_li(n: int) -> int:
    """Row padding: 64-row steps up to 512, then 512-row steps (every value
    is <= 512 or a multiple of 512)."""
    n = max(n, 1)
    if n <= 512:
        return -(-n // 64) * 64
    return -(-n // _ROW_BLOCK) * _ROW_BLOCK


def _quantize_query_tokens(qt_cols: torch.Tensor):
    """[D, L] f32 query-token columns -> (int8 [D, L], per-column scale
    [L]), the zero-column guard as the dense index's int8 path."""
    sq = torch.amax(torch.abs(qt_cols), dim=0) / 127.0
    sq = torch.where(sq > 0, sq, 1.0)
    return torch.round(qt_cols / sq[None, :]).to(torch.int8), sq


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) as a tree of halvings:
    the same order whatever the leading shape."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _maxsim_scores(x, counts, q_tokens, q_counts, x_scales=None):
    """MaxSim scores [N, G] of every row of ``x`` [N, T, D] (storage dtype)
    against the queries ``q_tokens`` [G, qp, D] f32 with ``q_counts`` [G]
    real tokens each (0: a padding query). Rows with no token score -inf.

    Blocks of _ROW_BLOCK rows when N is a multiple of it; one block below
    it; otherwise overlapped blocks whose last starts at N - _ROW_BLOCK and
    writes a few rows again with the same values."""
    n, t, d = x.shape
    g, qp, _ = q_tokens.shape
    q_mask = torch.arange(qp, device=x.device)[None, :] < q_counts[:, None]  # [G, qp]
    qt = torch.where(q_mask[:, :, None], q_tokens, 0.0).reshape(g * qp, d).T  # [D, G*qp]
    if x_scales is not None:
        q8, sq = _quantize_query_tokens(qt)
    t_iota = torch.arange(t, device=x.device)

    def block_scores(start, stop):
        xb = x[start:stop].reshape(-1, d)
        if x_scales is not None:
            prod = int8_matmul(xb, q8)  # [B*T, G*qp] s32
            sims = prod.float().mul_(x_scales[start:stop].reshape(-1)[:, None]).mul_(sq[None, :])
        else:
            sims = xb.float() @ qt
        cb = counts[start:stop]
        sims = sims.view(stop - start, t, g * qp)
        sims.masked_fill_(~(t_iota[None, :] < cb[:, None])[:, :, None], -torch.inf)
        per_q = torch.amax(sims, dim=1).view(stop - start, g, qp)
        scores = _lane_sum(torch.where(q_mask[None], per_q, 0.0))  # [B, G]
        return torch.where((cb > 0)[:, None], scores, -torch.inf)

    if n <= _ROW_BLOCK or n % _ROW_BLOCK == 0:
        block = min(n, _ROW_BLOCK)
        return torch.cat([block_scores(s, s + block) for s in range(0, n, block)])
    out = torch.zeros((n, g), dtype=torch.float32, device=x.device)
    for i in range(-(-n // _ROW_BLOCK)):
        start = min(i * _ROW_BLOCK, n - _ROW_BLOCK)
        out[start : start + _ROW_BLOCK] = block_scores(start, start + _ROW_BLOCK)
    return out


def pack_ragged_token_embeddings(doc_token_embeddings, max_chunk_tokens: int, row_bucket=_bucket_rows_li):
    """Per-document ragged [t_i, D] chunk arrays -> (x [n_pad, T, D] f32,
    counts [n_pad] int32, doc_ids, chunk_ids, n_rows, dim) on the host,
    ``n_pad = row_bucket(n_rows)``; x is None when there is no row or no
    chunk has a token. A chunk whose width differs from the index's keeps
    count 0 (never retrieved)."""
    per_chunk: list[np.ndarray] = []
    doc_ids: list[int] = []
    chunk_ids: list[int] = []
    for doc_id, chunks in enumerate(doc_token_embeddings):
        for chunk_id, arr in enumerate(chunks):
            arr = np.asarray(arr, dtype=np.float32)
            if arr.ndim != 2:
                arr = arr.reshape(0, 0)
            per_chunk.append(arr[:max_chunk_tokens])
            doc_ids.append(doc_id)
            chunk_ids.append(chunk_id)
    n_rows = len(per_chunk)
    dim = max((a.shape[1] for a in per_chunk if a.size), default=0)
    if n_rows == 0 or dim == 0:
        return None, None, None, None, n_rows, dim
    n_pad = row_bucket(n_rows)
    x = np.zeros((n_pad, max_chunk_tokens, dim), dtype=np.float32)
    counts = np.zeros((n_pad,), dtype=np.int32)
    for i, arr in enumerate(per_chunk):
        if arr.size and arr.shape[1] == dim:
            x[i, : arr.shape[0]] = arr
            counts[i] = arr.shape[0]
    return x, counts, np.asarray(doc_ids, dtype=np.int64), np.asarray(chunk_ids, dtype=np.int64), n_rows, dim


def pack_query_batch(queries_tokens, dim: int):
    """[q_i, D] token arrays -> (q_tok [nq_pad, qp, D] f32, q_counts
    [nq_pad] int32), power-of-two buckets; a malformed (not 2-D, or another
    width) query gets count 0 and no hits."""
    nq = len(queries_tokens)
    sane = [np.asarray(q, dtype=np.float32) for q in queries_tokens]
    sane = [q if q.ndim == 2 and q.shape[1] == dim else None for q in sane]
    qp = _bucket_q(max(max((q.shape[0] for q in sane if q is not None), default=1), 1))
    nq_pad = 1 << max(2, (nq - 1).bit_length())
    q_tok = np.zeros((nq_pad, qp, dim), dtype=np.float32)
    q_counts = np.zeros((nq_pad,), dtype=np.int32)
    for i, q in enumerate(sane):
        if q is None:
            continue
        q_tok[i, : min(q.shape[0], qp)] = q[:qp]
        q_counts[i] = min(q.shape[0], qp)
    return q_tok, q_counts


def finite_maxsim_hits(index, vals, idx):
    """Top-k output -> (hits, MaxSim scores), dropping rows with no token
    (their negated score is +inf): unlike the dense index, such a row is
    unscoreable and never a hit."""
    hits, neg_scores = hits_from_topk(
        np.asarray(vals), np.asarray(idx), index.n_rows, index._doc_ids, index._chunk_ids, index.retrieval_type
    )
    keep = [i for i, s in enumerate(neg_scores) if np.isfinite(s)]
    return [hits[i] for i in keep], [-neg_scores[i] for i in keep]


def batched_maxsim_lookup(index, queries_tokens, invoke):
    """The ``find_batch`` loop: packs the queries, splits them into groups of
    at most _MAX_Q_LANES lanes, and drops the no-token rows.
    ``invoke(q_tok, q_counts, k)`` returns (vals, idx) of a group."""
    nq = len(queries_tokens)
    if nq == 0 or index._x is None:
        return [[] for _ in range(nq)]
    q_tok, q_counts = pack_query_batch(queries_tokens, index.dim)
    qp = q_tok.shape[1]
    g = max(1, _MAX_Q_LANES // qp)
    g = min(1 << (g.bit_length() - 1), q_tok.shape[0])  # a power of two divides nq_pad
    k = min(index.limit, index.n_rows)
    vals, idx = [], []
    for i in range(0, q_tok.shape[0], g):
        v, j = invoke(q_tok[i : i + g], q_counts[i : i + g], k)
        vals.append(np.asarray(v))
        idx.append(np.asarray(j))
    vals, idx = np.concatenate(vals), np.concatenate(idx)
    return [finite_maxsim_hits(index, vals[qi], idx[qi])[0] if q_counts[qi] else [] for qi in range(nq)]


class LateInteractionIndex:
    """Flat token-level index over several documents; queries scan on
    ``device``."""

    def __init__(
        self,
        retrieval_type: RetrievalType,
        doc_token_embeddings: list[list[np.ndarray]],
        max_chunk_tokens: int = 256,
        limit: int = 1,
        storage_dtype: str = "float32",
        device: str | torch.device = "cuda",
    ):
        """``doc_token_embeddings``: per document, one ragged ``[t_i, D]``
        f32 array per chunk. Chunks truncate to ``max_chunk_tokens``."""
        if storage_dtype not in _STORAGE:
            raise ValueError(f"unsupported storage_dtype {storage_dtype!r}; use one of {sorted(_STORAGE)}")
        self.retrieval_type = retrieval_type
        self.limit = limit
        self.t = max_chunk_tokens
        self.storage_dtype = storage_dtype
        self.device = resolve_device(device)
        x, counts, doc_ids, chunk_ids, self.n_rows, self.dim = pack_ragged_token_embeddings(
            doc_token_embeddings, max_chunk_tokens
        )
        self._x = self._x_scales = self._counts = None
        if x is None:
            return
        self._doc_ids = doc_ids
        self._chunk_ids = chunk_ids
        self._load(x, counts)

    @classmethod
    def shard(cls, x: np.ndarray, counts: np.ndarray, n_valid: int, limit: int, storage_dtype: str,
              device: torch.device) -> "LateInteractionIndex":
        """One shard of a sharded index (``parallel/sharded_index.py``): the
        packed rows ``x`` [R, T, D] and ``counts`` [R] as they are, of which
        the first ``n_valid`` are real. Its scans report shard-local row ids."""
        self = cls.__new__(cls)
        self.retrieval_type = RetrievalType.TEXT
        self.limit, self.t, self.storage_dtype, self.device = limit, x.shape[1], storage_dtype, device
        self.n_rows, self.dim = n_valid, x.shape[2]
        self._doc_ids = self._chunk_ids = np.zeros(0, np.int64)
        self._load(x, counts)
        return self

    def _load(self, x: np.ndarray, counts: np.ndarray):
        """Uploads the packed rows in the index's layout (int8: per token
        absmax-quantized, the scales beside them)."""
        if self.storage_dtype == "int8":
            absmax = np.max(np.abs(x), axis=2)  # [N, T]
            scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
            self._x = torch.from_numpy(np.rint(x / scales[:, :, None]).astype(np.int8)).to(self.device)
            self._x_scales = torch.from_numpy(scales).to(self.device)
        else:
            self._x = torch.from_numpy(x).to(self.device, dtype=_STORAGE[self.storage_dtype])
            self._x_scales = None
        self._counts = torch.from_numpy(counts).to(self.device)

    @property
    def nbytes(self) -> int:
        if self._x is None:
            return 0
        total = self._x.numel() * self._x.element_size() + self._counts.numel() * 4
        if self._x_scales is not None:
            total += self._x_scales.numel() * 4
        return total

    def _find(self, q_tok: torch.Tensor, q_counts: torch.Tensor, k: int):
        """Stable top-k (vals, idx) [G, k] on the host over the negated
        scores of the queries ``q_tok`` [G, qp, D]."""
        vals, idx = self._find_device(q_tok, q_counts, k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _find_device(self, q_tok: torch.Tensor, q_counts: torch.Tensor, k: int):
        """``_find``'s top-k left on the device."""
        scores = _maxsim_scores(
            self._x, self._counts, q_tok.to(self.device, torch.float32), q_counts.to(self.device), self._x_scales
        )
        n = scores.shape[0]
        dists = torch.where(torch.arange(n, device=self.device)[None, :] < self.n_rows, -scores.T, torch.inf)
        return stable_topk_rows(dists, torch.arange(n, device=self.device), k)

    def find(self, query_tokens) -> list[SearchHit]:
        return self.find_with_scores(query_tokens)[0]

    def find_batch(self, queries_tokens: list[np.ndarray]) -> list[list[SearchHit]]:
        """Per-query hits for a list of [q_i, D] token arrays, each group of
        at most _MAX_Q_LANES lanes one pass over the corpus."""

        def invoke(q_tok, q_counts, k):
            return self._find(torch.from_numpy(q_tok), torch.from_numpy(q_counts), k)

        return batched_maxsim_lookup(self, queries_tokens, invoke)

    def find_with_scores(self, query_tokens):
        """``query_tokens``: [q, D] f32 per-token query embeddings -> (hits,
        MaxSim scores).

        A 2-D tensor (``embed_query_tokens_device``'s rows, padded positions
        exactly zero) is scored with every row counted as a token: a zero
        token adds exactly 0 to each chunk's score, so the result is the
        host path's for the same rows at the same lane bucket. Host arrays
        that are not 2-D or of another width give no hits; queries longer
        than _MAX_Q_LANES tokens are cut to it."""
        if self._x is None:
            return [], []
        if isinstance(query_tokens, torch.Tensor) and query_tokens.ndim == 2 and (
            0 < query_tokens.shape[0] <= _MAX_Q_LANES and query_tokens.shape[1] == self.dim
        ):
            q_tokens = query_tokens.to(self.device, torch.float32)
        else:
            q_tokens = np.asarray(
                query_tokens.cpu() if isinstance(query_tokens, torch.Tensor) else query_tokens, dtype=np.float32
            )
            if q_tokens.ndim != 2 or q_tokens.shape[0] == 0 or q_tokens.shape[1] != self.dim:
                return [], []
            q_tokens = torch.from_numpy(q_tokens[:_MAX_Q_LANES])
        q = q_tokens.shape[0]
        q_tokens = torch.nn.functional.pad(q_tokens, (0, 0, 0, _bucket_q(q) - q))
        vals, idx = self._find(q_tokens[None], torch.tensor([q], dtype=torch.int32), min(self.limit, self.n_rows))
        return finite_maxsim_hits(self, vals[0], idx[0])

    def warm_query_buckets(self) -> None:
        """The lone query at lane buckets 8, 16 and 32 (a 3-30 token query's)
        and batches of 4, 8, .. queries at 16 lanes, up to the most one scan
        takes there (``_MAX_Q_LANES // 16``, within
        ``micro_batcher.MAX_WAVE``), on zero queries on the device. PyTorch
        compiles nothing ahead; these calls make the caching allocator's
        first blocks and each shape's first launches happen off the request
        path."""
        if self._x is None:
            return
        for lanes in (8, 16, 32):
            self.find(torch.zeros((lanes, self.dim), device=self.device))
        probe = torch.zeros((16, self.dim), device=self.device)
        q = 4
        while q <= min(micro_batcher.MAX_WAVE, _MAX_Q_LANES // 16):
            self._scan_wave([probe] * q)
            q *= 2

    async def afind(self, query_tokens) -> list[SearchHit]:
        """``find`` with cross-request coalescing: device queries that arrive
        at the same power-of-two lane bucket share one MaxSim scan, with the
        same scores as ``find`` (a query's lanes sum alone whatever the
        group); host arrays and other widths keep ``find``."""
        return await self._scan_batcher.submit(query_tokens)

    @property
    def _scan_batcher(self) -> PerLoopBatcher:
        return per_loop_batcher(self, "maxsim_scan", self._scan_wave)

    def _scan_wave(self, queries: list) -> list[list[SearchHit]]:
        if self._x is None:
            return [[] for _ in queries]
        out: list = [None] * len(queries)
        groups: dict[int, list[int]] = {}
        for i, q in enumerate(queries):
            if (
                isinstance(q, torch.Tensor)
                and q.ndim == 2
                and 0 < q.shape[0] <= _MAX_Q_LANES
                and q.shape[1] == self.dim
                and _bucket_q(q.shape[0]) == q.shape[0]
            ):
                groups.setdefault(q.shape[0], []).append(i)
            else:
                out[i] = self.find(q)
        k = min(self.limit, self.n_rows)
        for qp, idxs in groups.items():
            g = max(1, _MAX_Q_LANES // qp)
            g = 1 << (g.bit_length() - 1)
            for s in range(0, len(idxs), g):
                part = idxs[s : s + g]
                if len(part) == 1:
                    out[part[0]] = self.find(queries[part[0]])
                    continue
                # padded to a power of two with row 0 again, counted 0 lanes:
                # padding queries score nothing and are dropped
                nq_pad = 1 << max(2, (len(part) - 1).bit_length())
                rows = [queries[i].to(self.device, torch.float32) for i in part]
                rows.extend([rows[0]] * (nq_pad - len(part)))
                counts = torch.zeros(nq_pad, dtype=torch.int32)
                counts[: len(part)] = qp
                vals, idx = self._find(torch.stack(rows), counts, k)
                for row, i in enumerate(part):
                    out[i] = finite_maxsim_hits(self, vals[row], idx[row])[0]
        return out
