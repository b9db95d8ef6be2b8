"""Row-sharded indexes over a device mesh (counterpart of
``dial_rag_tpu/parallel/sharded_index.py``).

Each index splits its rows into contiguous ranges, one a device of the
mesh (tp included), and keeps each range as the port's single-device index
of that layout on its device (``DenseIndex.shard``,
``LateInteractionIndex.shard``, a ``Bm25Index`` over the range's items).
A query launches every shard's scan, the single-device code on its own
rows, before it reads anything back; the shards' winners come to the
mesh's first device (and, across processes, through one all-gather) and
one stable merge ranks them (``merge_winners``):

* ties across shards: a shard's top-k lists equal values in its row
  order, and the merge sorts by global row id and then, stably, by value,
  so among equal values the earlier global row wins, exactly like one
  stable top-k over every row. BM25 and chargram rank the *later* item
  first on ties (the reference's ``argsort(kind="stable")[::-1]``): their
  shards take the single-device reverse top-k and the merge sorts rows
  descending first.

Padding: rows pad to the JAX package's per-shard quanta
(``_bucket_rows_sharded``, 512 rows; the late-interaction row bucket;
BM25's 8-row steps), and a pad row never wins: every shard masks rows at
or past the global row count, including a shard that holds none.

Per-shard statistics are the JAX package's: int8 scales are per row (per
token for MaxSim), so a shard's quantization is the unsharded index's;
two_pass takes its error terms as maxima over every shard (over every
process) and certifies each shard's candidate window on its own, and any
shard's failed certificate sends every shard to the full f32 scan.

Unlike the JAX package's sharded indexes, the port's keep the single-device
serving methods (``afind``, ``atop_n_with_scores``, ``warm_query_buckets``
with the single-device wave buckets): concurrent queries coalesce into
one sharded batch scan a wave. The BM25 shards score with the
single-device level-by-level scatter of the CSC tail plus the band's
product, one code for the JAX package's flat, uniform and single-query
scatter kernels.
"""

import numpy as np
import torch

from dial_rag_tpu_torch.index.bm25 import Q_BLOCK, Bm25Index, reverse_stable_topk
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.late_interaction import _STORAGE as _LI_STORAGE
from dial_rag_tpu_torch.index.late_interaction import (
    LateInteractionIndex,
    _bucket_rows_li,
    pack_ragged_token_embeddings,
)
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.ops.metrics import Metric
from dial_rag_tpu_torch.parallel.mesh import Mesh
from dial_rag_tpu_torch.parallel.multihost import gather_ranks

__all__ = [
    "DocEmbeddings",
    "ShardedBm25Index",
    "ShardedBm25SparseIndex",
    "ShardedDenseIndex",
    "ShardedLateInteractionIndex",
    "merge_winners",
]

_ROW_BLOCK = 512  # per-shard row quantum of the dense index


def _bucket_rows_sharded(n: int, n_shards: int) -> int:
    """Total rows padded so every shard holds the same _ROW_BLOCK-aligned
    count."""
    per_shard = -(-max(n, 1) // n_shards)
    per_shard = -(-per_shard // _ROW_BLOCK) * _ROW_BLOCK
    return per_shard * n_shards


def _shard_ranges(mesh: Mesh, rows_per_shard: int, n_rows: int):
    """(device, first global row, valid rows) of each of this process's
    shards."""
    out = []
    for j, dev in enumerate(mesh.local_devices):
        base = (mesh.shard_offset + j) * rows_per_shard
        out.append((dev, base, min(max(n_rows - base, 0), rows_per_shard)))
    return out


def merge_winners(mesh: Mesh, vals: list, rows: list, k: int, later_first: bool = False):
    """The shards' winner lists -> the global top-k on the mesh's first
    device.

    ``vals[i]`` / ``rows[i]`` [Q, k_i] are shard i's ascending winners
    (smaller is better) and their global row ids, on its device. Across
    processes every rank's lists are all-gathered, rank-major. One sort by
    row id (descending with ``later_first``) and one stable sort by value
    rank them: among equal values the earlier (later) row first. ``+ 0.0``
    makes -0.0 tie with +0.0. Returns (values [Q, k], rows [Q, k]) on the
    first device."""
    first = mesh.first_device
    v = torch.cat([x.to(first) for x in vals], dim=-1).float() + 0.0
    r = torch.cat([x.to(first, torch.int64) for x in rows], dim=-1)
    v, r = gather_ranks(mesh, v, dim=-1), gather_ranks(mesh, r, dim=-1)
    by_row = torch.sort(r, dim=-1, descending=later_first, stable=True).indices
    v, r = torch.gather(v, -1, by_row), torch.gather(r, -1, by_row)
    v, by_val = torch.sort(v, dim=-1, stable=True)
    return v[..., :k], torch.gather(r, -1, by_val)[..., :k]


def _all_ranks(mesh: Mesh, flags: list) -> bool:
    """True when every flag (a bool tensor on a shard's device) of every
    process holds."""
    local = torch.stack([f.to(mesh.first_device, torch.int32) for f in flags])
    return bool(gather_ranks(mesh, local).min() > 0)


class ShardedDenseIndex(DenseIndex):
    """Dense index with rows sharded over every device of a mesh; the
    host-facing API of ``DenseIndex``. Construction places each row shard
    on its device; queries may arrive on any device."""

    def __init__(
        self,
        retrieval_type: RetrievalType,
        doc_embeddings: list[DocEmbeddings],
        mesh: Mesh,
        metric: Metric | str = Metric.SQEUCLIDEAN_DIST,
        limit: int = 1,
        storage_dtype: str = "float32",
    ):
        emb = self._start(retrieval_type, doc_embeddings, metric, limit, storage_dtype)
        self.mesh = mesh
        self.device = mesh.first_device
        self.n_shards = mesh.size
        self._shards: list[tuple[int, DenseIndex]] = []
        if emb is None:
            return
        rps = _bucket_rows_sharded(self.n_rows, self.n_shards) // self.n_shards
        for dev, base, n_valid in _shard_ranges(mesh, rps, self.n_rows):
            rows = emb[base : base + n_valid]
            if n_valid < rps:
                rows = np.pad(rows, ((0, rps - n_valid), (0, 0)))
            self._shards.append((base, DenseIndex.shard(rows, n_valid, self.metric, limit, storage_dtype, dev)))
        self._emb = self._shards[0][1]._emb  # the marker of a non-empty index
        if storage_dtype == "two_pass":
            # error terms: maxima over every shard of every process, sound
            # for each shard's own certificate
            terms = torch.stack([torch.stack(sh._err).to(self.device) for _, sh in self._shards])
            terms = gather_ranks(mesh, terms).amax(dim=0)
            for _, sh in self._shards:
                sh._err = tuple(terms.to(sh.device).unbind())

    @property
    def nbytes(self) -> int:
        """Bytes of this process's shards."""
        return sum(sh.nbytes for _, sh in self._shards)

    def _topk(self, queries: torch.Tensor, n_real: int | None = None):
        n_real = queries.reshape(-1, self.dim).shape[0] if n_real is None else n_real
        k = min(self.limit, self.n_rows)
        prepared = [sh._prepare(queries) for _, sh in self._shards]  # the queries on each shard's device
        if self.storage_dtype == "two_pass":
            windows = [sh._two_pass_window(q, q_sq, k) for (_, sh), (q, q_sq) in zip(self._shards, prepared)]
            flags = [ok[:n_real].all() if sh.n_rows else torch.ones((), dtype=torch.bool, device=sh.device)
                     for (_, sh), (ok, _) in zip(self._shards, windows)]
            if _all_ranks(self.mesh, flags):
                outs = [sh._rescore(q, q_sq, k, blk)
                        for (_, sh), (q, q_sq), (_, blk) in zip(self._shards, prepared, windows)]
            else:  # a shard's window missed: every shard takes the full f32 scan
                outs = [sh._full_scan(q, q_sq, k, sh._emb_f32, sh._rn2_f32)
                        for (_, sh), (q, q_sq) in zip(self._shards, prepared)]
        else:
            outs = [sh._stored_scan(q, q_sq, k) for (_, sh), (q, q_sq) in zip(self._shards, prepared)]
        vals, rows = merge_winners(self.mesh, [v for v, _ in outs],
                                   [i + base for (base, _), (_, i) in zip(self._shards, outs)], k)
        return vals[:n_real].cpu().numpy(), rows[:n_real].cpu().numpy()


class ShardedLateInteractionIndex(LateInteractionIndex):
    """Late-interaction (MaxSim) index with chunk rows (and their token
    tensors, the bytes worth sharding) over every device of a mesh; the
    host-facing API of ``LateInteractionIndex``."""

    def __init__(
        self,
        retrieval_type: RetrievalType,
        doc_token_embeddings: list[list[np.ndarray]],
        mesh: Mesh,
        max_chunk_tokens: int = 256,
        limit: int = 1,
        storage_dtype: str = "float32",
    ):
        if storage_dtype not in _LI_STORAGE:
            raise ValueError(f"unsupported storage_dtype {storage_dtype!r}; use one of {sorted(_LI_STORAGE)}")
        self.retrieval_type = retrieval_type
        self.limit = limit
        self.t = max_chunk_tokens
        self.storage_dtype = storage_dtype
        self.mesh = mesh
        self.device = mesh.first_device
        n_shards = mesh.size

        def row_bucket(n):  # every shard's rows a count the blocked scan takes
            return _bucket_rows_li(-(-max(n, 1) // n_shards)) * n_shards

        # packed on the host and uploaded a shard at a time: the unsharded
        # tensor never lands on one device
        x, counts, doc_ids, chunk_ids, self.n_rows, self.dim = pack_ragged_token_embeddings(
            doc_token_embeddings, max_chunk_tokens, row_bucket
        )
        self._x = self._x_scales = self._counts = None
        self._shards: list[tuple[int, LateInteractionIndex]] = []
        if x is None:
            return
        self._doc_ids = doc_ids
        self._chunk_ids = chunk_ids
        rps = x.shape[0] // n_shards
        for dev, base, n_valid in _shard_ranges(mesh, rps, self.n_rows):
            sh = LateInteractionIndex.shard(x[base : base + rps], counts[base : base + rps], n_valid, limit,
                                            storage_dtype, dev)
            self._shards.append((base, sh))
        self._x = self._shards[0][1]._x  # the marker of a non-empty index

    @property
    def nbytes(self) -> int:
        """Bytes of this process's shards."""
        return sum(sh.nbytes for _, sh in self._shards)

    def _find(self, q_tok: torch.Tensor, q_counts: torch.Tensor, k: int):
        outs = [sh._find_device(q_tok, q_counts, k) for _, sh in self._shards]
        vals, rows = merge_winners(self.mesh, [v for v, _ in outs],
                                   [i + base for (base, _), (_, i) in zip(self._shards, outs)], k)
        return vals.cpu().numpy(), rows.cpu().numpy()


class _ShardedBm25(Bm25Index):
    """BM25 (or any linear term-weight model) with item rows sharded over a
    mesh: each shard a ``Bm25Index`` over its item range. Scores are the
    single-device index's, bit for bit: an item's terms add in the same
    order on its shard."""

    def _start(self, base: Bm25Index, mesh: Mesh, limit: int):
        if base.device.type != "cpu":
            raise ValueError(f"{type(self).__name__} shards a host build: Bm25Index.build(..., device='cpu')")
        Bm25Index.__init__(self, vocab=base.vocab, idf=base.idf, n_items=base.n_items, device=mesh.first_device)
        self.mesh = mesh
        self.limit = limit
        n = base.n_items
        self._rows_per_shard = -(-max(n, 8) // (8 * mesh.size)) * 8
        self._shards: list[tuple[int, int, Bm25Index]] = []  # (first item, valid items, shard)

    def _add_shard(self, base_row: int, n_valid: int, device) -> Bm25Index:
        sh = Bm25Index(vocab=self.vocab, idf=self.idf, n_items=self._rows_per_shard, device=device)
        self._shards.append((base_row, n_valid, sh))
        return sh

    @property
    def layout(self) -> str:
        return f"sharded {self._shards[0][2].layout}"

    @property
    def nbytes(self) -> int:
        """Bytes of this process's shards."""
        return sum(sh.nbytes for _, _, sh in self._shards)

    def _check(self, n: int) -> None:
        if n > self.limit:
            raise ValueError(f"n={n} exceeds the index limit {self.limit}")

    def get_scores_batch(self, queries: list) -> np.ndarray:
        out = []
        for i in range(0, len(queries), Q_BLOCK):
            block = queries[i : i + Q_BLOCK]
            scores = [sh._scores(block) for _, _, sh in self._shards]
            s = torch.cat([x.to(self.device) for x in scores], dim=1)
            out.append(gather_ranks(self.mesh, s, dim=1)[:, : self.n_items].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, self.n_items), dtype=np.float32)

    def top_n_batch_with_scores(self, queries: list, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """(indices, scores) of each query's top-n, later item first on
        ties (across shards too)."""
        self._check(n)
        k = min(n, self.n_items)
        out = []
        for i in range(0, len(queries), Q_BLOCK):
            block = queries[i : i + Q_BLOCK]
            keys, rows = [], []
            for base_row, n_valid, sh in self._shards:  # every shard launched before any result is read
                s = sh._scores(block)
                s[:, n_valid:] = -torch.inf  # padding items never rank
                v, j = reverse_stable_topk(s, min(k, self._rows_per_shard))
                keys.append(-v)
                rows.append(j + base_row)
            neg, idx = merge_winners(self.mesh, keys, rows, k, later_first=True)
            out.extend(zip(idx.cpu().numpy(), (-neg + 0.0).cpu().numpy()))
        return out

    def warm_query_buckets(self, k: int) -> None:
        Bm25Index.warm_query_buckets(self, min(k, self.limit))


class ShardedBm25SparseIndex(_ShardedBm25):
    """CSC-postings BM25 with item rows sharded over a mesh.

    ``base`` is a host build with no band (``Bm25Index.build(...,
    device="cpu", max_dense_bytes=0, max_band_bytes=0)``): its postings
    split by item range, each shard holding only its own items' postings
    in term-major order. Terms with ``df >= max(n // 64, 64)``, at most
    ``max_band_bytes // (shards x rows a shard x 4)`` by falling df, move
    to a row-sharded dense band scored by a per-shard product."""

    def __init__(self, base: Bm25Index, mesh: Mesh, limit: int, max_band_bytes: int = 512 * 1024 * 1024):
        if base._postings is None or base._band is not None:
            raise ValueError("sharded sparse BM25 shards host CSC postings without a band: build with "
                             "device='cpu', max_dense_bytes=0, max_band_bytes=0")
        self._start(base, mesh, limit)
        term_ptr, rows_t, vals_t = base._postings
        base._postings = None  # re-sharded below; the host copy goes
        rows, vals = rows_t.numpy().astype(np.int64), vals_t.numpy()
        v = len(term_ptr) - 1
        df = np.diff(term_ptr)
        term_of = np.repeat(np.arange(v, dtype=np.int64), df)
        rps = self._rows_per_shard
        k_cap = max(0, max_band_bytes // max(mesh.size * rps * 4, 1))
        heavy = np.nonzero(df >= max(self.n_items // 64, 64))[0]
        heavy = heavy[np.argsort(-df[heavy], kind="stable")][:k_cap]
        band_col = np.full(v, -1, dtype=np.int64)
        band_col[heavy] = np.arange(heavy.size)
        in_band = band_col[term_of] >= 0
        band_cols = {int(t): c for c, t in enumerate(heavy)}
        for dev, base_row, n_valid in _shard_ranges(mesh, rps, self.n_items):
            sh = self._add_shard(base_row, n_valid, dev)
            mine = (rows >= base_row) & (rows < base_row + rps)
            if heavy.size:
                sel = mine & in_band
                band = np.zeros((rps, heavy.size), dtype=np.float32)
                band[rows[sel] - base_row, band_col[term_of[sel]]] = vals[sel]
                sh._band = torch.from_numpy(band).to(dev)
                sh._band_cols = band_cols
                mine &= ~in_band
            ptr = np.zeros(v + 1, dtype=np.int64)
            np.cumsum(np.bincount(term_of[mine], minlength=v), out=ptr[1:])
            # rows stay term-major, item-ascending within a term
            sh._postings = (
                ptr,
                torch.from_numpy((rows[mine] - base_row).astype(np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(vals[mine])).to(dev),
            )


class ShardedBm25Index(_ShardedBm25):
    """Dense BM25 weights row-sharded over a mesh: ``base`` is a host build
    in the dense layout (``Bm25Index.build(..., device="cpu")``), each
    shard the [rows, V] weights of its item range."""

    def __init__(self, base: Bm25Index, mesh: Mesh, limit: int):
        if base._weights is None:
            raise ValueError("sharded BM25 requires the dense weights layout (build with device='cpu')")
        self._start(base, mesh, limit)
        w = base._weights.numpy()
        base._weights = None  # uploaded below; the host copy goes
        rps = self._rows_per_shard
        for dev, base_row, n_valid in _shard_ranges(mesh, rps, self.n_items):
            rows = w[base_row : base_row + n_valid]
            if n_valid < rps:
                rows = np.pad(rows, ((0, rps - n_valid), (0, 0)))
            self._add_shard(base_row, n_valid, dev)._weights = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
