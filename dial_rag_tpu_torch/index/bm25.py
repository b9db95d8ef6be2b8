"""Okapi BM25 scoring on the device (counterpart of
``dial_rag_tpu/index/bm25.py``).

Every per-(item, term) saturation weight is computed at build time,
``W[i, t] = idf(t) * tf (k1 + 1) / (tf + k1 (1 - b + b dl_i / avgdl))``, so
a query's scores are the linear form ``W @ q`` with ``q[t]`` the query's
count (or weight) of term t. That is rank-bm25's ``BM25Okapi`` score:

- idf = ln((N - df + 0.5) / (df + 0.5)), negative idfs replaced by
  ``EPSILON`` times the mean idf over all terms;
- a repeated query term counts once per occurrence;
- a term outside the vocabulary adds 0.

Layouts, chosen by the reference's arithmetic so the same corpus takes the
same one:

- dense ``[N, V]`` f32 weights while ``n_pad * v_pad * 4 <=
  max_dense_bytes``;
- else term-major CSC postings (item-ascending rows within a term) on the
  device, each term's posting range (``term_ptr``) on the host; terms with
  ``df >= max(n // 64, 64)``, at most ``max_band_bytes // (n_pad * 4)`` of
  them by falling df, move to a dense ``[N, K]`` band.

Scoring is f32 (TF32 stays off, ``device.resolve_device``). Queries go in
blocks of ``Q_BLOCK``: each product is ``[Q_BLOCK, V] @ [V, N]`` (the
band's ``[Q_BLOCK, K] @ [K, N]``) whatever the number of queries, so a
query gets the same bits alone and in a batch. The CSC tail adds the query's terms one
after another in ascending term order, as the reference's scan does: level
j of a block (the j-th tail term of every query in it) is one
``index_add_`` whose destinations are distinct (each query has its own row
of the accumulator and a term's rows are distinct), so no two additions
race and every score is summed in the same order on every run.

Top-n keeps the reference's tie-break, ``np.argsort(scores,
kind="stable")[::-1][:n]``: descending scores, the *later* item first on
ties. The scores are negated and flipped, the stable ascending top-k
(earliest first) taken, and the indices mapped back. A larger n's top
list is a smaller n's with more after it, so queries of several n share
one ranking.

Serving: concurrent ``atop_n_with_scores`` calls coalesce into one
``top_n_batch_with_scores`` a wave (``runtime/micro_batcher.py``).
"""

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.ops.stable_topk import stable_topk
from dial_rag_tpu_torch.runtime import micro_batcher
from dial_rag_tpu_torch.runtime.micro_batcher import PerLoopBatcher, per_loop_batcher

K1 = 1.5
B = 0.75
EPSILON = 0.25

_LANE = 128
Q_BLOCK = 64  # query rows of every product


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _iter_term_weights(query):
    """Queries are token lists (weight 1 an occurrence, rank-bm25's
    semantics) or term -> weight mappings (weighted queries: every score is
    linear in the query vector)."""
    if isinstance(query, dict):
        return query.items()
    return ((t, 1.0) for t in query)


def reverse_stable_topk(scores: torch.Tensor, k: int):
    """(scores, indices) of the k best of each row of ``scores`` [Q, N],
    ranked as ``np.argsort(row, kind="stable")[::-1][:k]``. The ``+ 0.0``
    makes every zero +0.0, so -0.0 and +0.0 tie, as they do for numpy."""
    n = scores.shape[-1]
    _, idx = stable_topk(torch.flip(-scores, dims=(-1,)) + 0.0, k)
    idx = (n - 1) - idx
    return torch.gather(scores, -1, idx), idx


class Bm25Index:
    """BM25 index over flattened items, resident on ``device``."""

    def __init__(self, vocab: dict, idf: np.ndarray, n_items: int, device: str | torch.device = "cuda"):
        self.vocab = vocab
        self.idf = idf  # [V] f64
        self.n_items = n_items
        self.device = resolve_device(device)
        self._weights: torch.Tensor | None = None  # dense [N, V] f32
        # CSC tail: (term_ptr [V + 1] int64 on the host, rows [nnz] int32,
        # vals [nnz] f32 on the device)
        self._postings: tuple | None = None
        self._band: torch.Tensor | None = None  # [N, K] f32
        self._band_cols: dict[int, int] | None = None  # term id -> band column

    @property
    def layout(self) -> str:
        if self._weights is not None:
            return "dense"
        return "band+csc" if self._band is not None else "csc"

    @property
    def nbytes(self) -> int:
        if self._weights is not None:
            return self._weights.numel() * 4
        _, rows, vals = self._postings
        band = 0 if self._band is None else self._band.numel() * 4
        return rows.numel() * 4 + vals.numel() * 4 + band

    @classmethod
    def build(
        cls,
        tokenized_items: list[list[str]],
        max_dense_bytes: int = 256 * 1024 * 1024,
        device: str | torch.device = "cuda",
        max_band_bytes: int = 512 * 1024 * 1024,
    ) -> "Bm25Index":
        n = len(tokenized_items)
        if sum(map(len, tokenized_items)) == 0:
            raise ValueError("Text index is empty.")
        vocab: dict[str, int] = {}
        item_ids: list[int] = []
        term_ids: list[int] = []
        tfs: list[int] = []
        dl = np.zeros(n, dtype=np.float64)
        for i, toks in enumerate(tokenized_items):
            dl[i] = len(toks)
            tf: dict[int, int] = {}
            for t in toks:
                tid = vocab.setdefault(t, len(vocab))
                tf[tid] = tf.get(tid, 0) + 1
            item_ids.extend([i] * len(tf))
            term_ids.extend(tf)
            tfs.extend(tf.values())
        item_ids = np.asarray(item_ids, dtype=np.int64)
        term_ids = np.asarray(term_ids, dtype=np.int64)
        f = np.asarray(tfs, dtype=np.float64)

        v = len(vocab)
        df = np.bincount(term_ids, minlength=v).astype(np.float64)
        idf = np.log(n - df + 0.5) - np.log(df + 0.5)
        average_idf = idf.sum() / v
        idf = np.where(idf < 0, EPSILON * average_idf, idf)
        avgdl = dl.sum() / n
        denom_norm = K1 * (1.0 - B + B * dl / avgdl)  # [N]
        # the reference's f64 expression, evaluated in its order
        weights = idf[term_ids] * f * (K1 + 1.0) / (f + denom_norm[item_ids])

        index = cls(vocab=vocab, idf=idf, n_items=n, device=device)
        index._assemble(item_ids, term_ids, weights.astype(np.float32), max_dense_bytes, max_band_bytes)
        return index

    @classmethod
    def from_term_weights(
        cls,
        vocab: dict[str, int],
        idf: np.ndarray,
        weight_rows: list[dict[int, float]],
        max_dense_bytes: int = 256 * 1024 * 1024,
        device: str | torch.device = "cuda",
        max_band_bytes: int = 512 * 1024 * 1024,
    ) -> "Bm25Index":
        """The layouts from explicit per-item term weights instead of the
        Okapi formula: any retrieval model of the linear form ``score[i] =
        sum_t q[t] W[i, t]`` runs on the same machinery."""
        if not any(weight_rows):
            raise ValueError("Text index is empty.")
        item_ids = np.repeat(np.arange(len(weight_rows)), [len(r) for r in weight_rows])
        term_ids = np.fromiter((t for r in weight_rows for t in r), dtype=np.int64, count=len(item_ids))
        weights = np.fromiter((w for r in weight_rows for w in r.values()), dtype=np.float32, count=len(item_ids))
        index = cls(vocab=vocab, idf=idf, n_items=len(weight_rows), device=device)
        index._assemble(item_ids, term_ids, weights, max_dense_bytes, max_band_bytes)
        return index

    @classmethod
    def from_term_weight_arrays(
        cls,
        vocab: dict,
        idf: np.ndarray,
        item_ids: np.ndarray,
        term_ids: np.ndarray,
        weights: np.ndarray,
        n_items: int,
        max_dense_bytes: int = 256 * 1024 * 1024,
        device: str | torch.device = "cuda",
        max_band_bytes: int = 512 * 1024 * 1024,
    ) -> "Bm25Index":
        """``from_term_weights`` from (item, term, weight) COO arrays whose
        (item, term) pairs are unique."""
        weights = np.asarray(weights, dtype=np.float32)
        if weights.size == 0:
            raise ValueError("Text index is empty.")
        index = cls(vocab=vocab, idf=idf, n_items=n_items, device=device)
        index._assemble(
            np.asarray(item_ids, dtype=np.int64), np.asarray(term_ids, dtype=np.int64), weights,
            max_dense_bytes, max_band_bytes,
        )
        return index

    def _assemble(self, item_ids, term_ids, weights, max_dense_bytes: int, max_band_bytes: int) -> None:
        """Lays the f32 COO weights out dense, or as band + CSC tail."""
        n, v = self.n_items, len(self.vocab)
        n_pad = _pad_to(max(n, 8), 8)
        v_pad = _pad_to(max(v, _LANE), _LANE)
        if n_pad * v_pad * 4 <= max_dense_bytes:
            w = np.zeros((n, v), dtype=np.float32)
            w[item_ids, term_ids] = weights
            self._weights = torch.from_numpy(w).to(self.device)
            return
        df = np.bincount(term_ids, minlength=v)
        k_cap = max(0, max_band_bytes // (n_pad * 4))
        heavy = np.nonzero(df >= max(n // 64, 64))[0]
        heavy = heavy[np.argsort(-df[heavy], kind="stable")][:k_cap]
        if heavy.size:
            band_col = np.full(v, -1, dtype=np.int64)
            band_col[heavy] = np.arange(heavy.size)
            in_band = band_col[term_ids] >= 0
            band = np.zeros((n, heavy.size), dtype=np.float32)
            band[item_ids[in_band], band_col[term_ids[in_band]]] = weights[in_band]
            self._band = torch.from_numpy(band).to(self.device)
            self._band_cols = {int(t): c for c, t in enumerate(heavy)}
            tail = ~in_band
            item_ids, term_ids, weights = item_ids[tail], term_ids[tail], weights[tail]
        order = np.argsort(term_ids * n + item_ids)  # term-major, item-ascending (the pairs are unique)
        term_ptr = np.zeros(v + 1, dtype=np.int64)
        np.cumsum(np.bincount(term_ids, minlength=v), out=term_ptr[1:])
        self._postings = (
            term_ptr,
            torch.from_numpy(item_ids[order].astype(np.int32)).to(self.device),
            torch.from_numpy(weights[order]).to(self.device),
        )

    def _query_terms(self, query) -> dict[int, float]:
        counts: dict[int, float] = {}
        for t, w in _iter_term_weights(query):
            tid = self.vocab.get(t)
            if tid is not None:
                counts[tid] = counts.get(tid, 0.0) + w
        return counts

    def _product(self, matrix: torch.Tensor, entries: list[tuple[int, int, float]]) -> torch.Tensor:
        """[Q_BLOCK, N] = Q @ matrix.T for ``matrix`` [N, C] and the
        (query, column, weight) entries of Q [Q_BLOCK, C]: one product of
        one shape, however many queries the block holds."""
        q = torch.zeros(Q_BLOCK, matrix.shape[1], dtype=torch.float32, device=self.device)
        if entries:
            # one host -> device copy: f64 holds the ids exactly and each
            # weight rounded to f32, as the reference's f32 query vector has it
            table = np.array(entries, dtype=np.float64).T
            table[2] = table[2].astype(np.float32)
            t = torch.from_numpy(table).to(self.device)
            q[t[0].long(), t[1].long()] = t[2].float()
        return q @ matrix.T

    def _tail(self, levels: list[list[tuple[int, int, int, float]]], n_queries: int) -> torch.Tensor:
        """[n_queries, N] sums of the CSC tail: ``levels[j]`` holds the j-th
        tail term (query, start, length, weight) of each query that has one,
        and each level is one ``index_add_`` after the one before."""
        n = self.n_items
        _, rows, vals = self._postings
        acc = torch.zeros(n_queries * n, dtype=torch.float32, device=self.device)
        segments = [s for level in levels for s in level]
        if segments:
            table = np.array(segments, dtype=np.float64).T  # query, start, length, weight
            table[3] = table[3].astype(np.float32)
            total = sum(s[2] for s in segments)
            t = torch.from_numpy(table).to(self.device)
            lens = t[2].long()
            seg = torch.repeat_interleave(torch.arange(len(segments), device=self.device), lens, output_size=total)
            first = torch.cumsum(lens, 0) - lens  # each segment's first position in the run
            pos = t[1].long()[seg] + torch.arange(total, device=self.device) - first[seg]
            dest = rows[pos].long() + t[0].long()[seg] * n
            src = vals[pos] * t[3].float()[seg]
            at = 0
            for level in levels:
                size = sum(s[2] for s in level)
                acc.index_add_(0, dest[at : at + size], src[at : at + size])
                at += size
        return acc.view(n_queries, n)

    def _scores(self, queries: list) -> torch.Tensor:
        """[len(queries), N] f32 scores on the device, ``len(queries) <=
        Q_BLOCK``: dense, the [N, V] product; else the CSC tail's terms in
        ascending term order, then the band's [N, K] product added."""
        terms = [self._query_terms(q) for q in queries]
        if self._weights is not None:
            entries = [(qi, tid, w) for qi, c in enumerate(terms) for tid, w in c.items()]
            return self._product(self._weights, entries)[: len(queries)]
        term_ptr = self._postings[0]
        band_entries = []
        levels: list[list[tuple[int, int, int, float]]] = []
        for qi, counts in enumerate(terms):
            j = 0
            for tid in sorted(counts):
                col = self._band_cols.get(tid) if self._band_cols else None
                if col is not None:
                    band_entries.append((qi, col, counts[tid]))
                    continue
                start, end = int(term_ptr[tid]), int(term_ptr[tid + 1])
                if end == start:
                    continue
                if j == len(levels):
                    levels.append([])
                levels[j].append((qi, start, end - start, counts[tid]))
                j += 1
        scores = self._tail(levels, len(queries))
        if band_entries:
            scores = scores + self._product(self._band, band_entries)[: len(queries)]
        return scores

    def get_scores_batch(self, queries: list) -> np.ndarray:
        """[Q, N] scores of token-list or term -> weight queries."""
        out = [self._scores(queries[i : i + Q_BLOCK]).cpu().numpy() for i in range(0, len(queries), Q_BLOCK)]
        return np.concatenate(out) if out else np.zeros((0, self.n_items), dtype=np.float32)

    def get_scores(self, query) -> np.ndarray:
        """[N] scores of a token list or term -> weight mapping."""
        return self.get_scores_batch([query])[0]

    def top_n_batch_with_scores(self, queries: list, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """(indices, scores) of each query's top-n, later item first on
        ties; a query gets the same result alone and in a batch."""
        k = min(n, self.n_items)
        out = []
        for i in range(0, len(queries), Q_BLOCK):
            vals, idx = reverse_stable_topk(self._scores(queries[i : i + Q_BLOCK]), k)
            out.extend(zip(idx.cpu().numpy(), vals.cpu().numpy()))
        return out

    def top_n_batch(self, queries: list, n: int) -> list[np.ndarray]:
        return [idx for idx, _ in self.top_n_batch_with_scores(queries, n)]

    def top_n_with_scores(self, query, n: int) -> tuple[np.ndarray, np.ndarray]:
        """(indices, scores): the top-n, later item first on ties, and each
        item's score (score-aware fusion reads them)."""
        return self.top_n_batch_with_scores([query], n)[0]

    def top_n(self, query, n: int) -> np.ndarray:
        return self.top_n_with_scores(query, n)[0]

    def warm_query_buckets(self, k: int) -> None:
        """One lone query and one batch at every wave size 2, 4, .. up to
        ``micro_batcher.MAX_WAVE``, at the serving top-``k``. PyTorch compiles nothing ahead;
        these calls make the caching allocator's first blocks and each
        shape's first launches happen off the request path."""
        if self.n_items == 0:
            return
        probe = [next(iter(self.vocab))] if self.vocab else []
        self.top_n_with_scores(probe, k)
        q = 2
        while q <= micro_batcher.MAX_WAVE:
            self.top_n_batch_with_scores([probe] * q, k)
            q *= 2

    async def atop_n_with_scores(self, query, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``top_n_with_scores`` with cross-request coalescing: concurrent
        callers' queries share one batched scoring and one copy to the host
        a wave. The same ranking as alone: a query gets the same bits in a
        batch, and a larger n's top list trims to a smaller n's."""
        return await self._scan_batcher.submit((query, n))

    @property
    def _scan_batcher(self) -> PerLoopBatcher:
        return per_loop_batcher(self, "bm25_scan", self._scan_wave)

    def _scan_wave(self, items: list) -> list:
        if len(items) == 1:
            query, n = items[0]
            return [self.top_n_with_scores(query, n)]
        n_max = max(n for _, n in items)
        outs = self.top_n_batch_with_scores([query for query, _ in items], n_max)
        return [(idx[:n], vals[:n]) for (idx, vals), (_, n) in zip(outs, items)]
