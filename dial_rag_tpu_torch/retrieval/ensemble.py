"""Reciprocal-rank-fusion ensemble (counterpart of
``dial_rag_tpu/retrieval/ensemble.py``, which it copies).

First-party replacement for langchain's EnsembleRetriever as used by the
reference (retrieval_chain.py:240-245: equal weights 1.0, per-retriever
k=7). Semantics match langchain's weighted_reciprocal_rank exactly:

- score(hit) = sum over retrievers of weight / (rank + c), rank 1-based,
  c = 60;
- hits are deduplicated by their "{doc_id}_{chunk_id}" key (the reference
  encodes this key in Document.page_content — index_record.py:33-34);
- final order: score descending, ties broken by first appearance when
  chaining the retrievers' lists in order (Python stable sort).

Sub-retrievers run concurrently (the reference inherits this from
langchain's async batch).
"""

import asyncio
import math
from collections import defaultdict

from dial_rag_tpu_torch.index.records import SearchHit

RRF_C = 60
# arms' top-SUPPORT_K membership drives the CombMNZ multiplier (the
# reference-parity per-arm serving depth, retrieval_chain.py:203)
SUPPORT_K = 7


def weighted_reciprocal_rank(
    hit_lists: list[list[SearchHit]], weights: list[float]
) -> list[SearchHit]:
    rrf_score: dict[str, float] = defaultdict(float)
    for hits, weight in zip(hit_lists, weights, strict=True):
        for rank, hit in enumerate(hits, start=1):
            rrf_score[hit.key] += weight / (rank + RRF_C)

    unique: list[SearchHit] = []
    seen: set[str] = set()
    for hits in hit_lists:
        for hit in hits:
            if hit.key not in seen:
                seen.add(hit.key)
                unique.append(hit)

    return sorted(unique, key=lambda h: rrf_score[h.key], reverse=True)


def _list_norm_scores(hits: list[SearchHit], norm: str) -> list[float]:
    """Per-list score normalization. Hits whose producers don't carry
    scores (None/non-finite) degrade the WHOLE list to a rank proxy —
    mixing native scores with rank proxies inside one list would skew
    the min/max/σ statistics."""
    scores = [h.score for h in hits]
    if any(s is None or not math.isfinite(s) for s in scores):
        scores = [-float(rank) for rank in range(1, len(hits) + 1)]
    if norm == "minmax":
        lo, hi = min(scores), max(scores)
        if hi > lo:
            return [(s - lo) / (hi - lo) for s in scores]
        return [0.0] * len(scores)
    if norm == "zscore":
        mu = sum(scores) / len(scores)
        var = sum((s - mu) ** 2 for s in scores) / len(scores)
        sd = math.sqrt(var)
        if sd > 0:
            return [(s - mu) / sd for s in scores]
        return [0.0] * len(scores)
    raise ValueError(f"unknown fusion norm {norm!r}")


def weighted_score_fusion(
    hit_lists: list[list[SearchHit]],
    weights: list[float],
    method: str = "combsum",
    norm: str = "minmax",
) -> list[SearchHit]:
    """Score-aware fusion (CombSUM / CombMNZ, Fox & Shaw 1994) over the
    retrievers' score-carrying hit lists — the opt-in alternative to
    rank-only RRF. Rank fusion discards score magnitudes; BM25's exact
    rare-term matches win by large margins that RRF lets correlated
    weaker arms out-vote (eval/tune_score_fusion.py).

    Semantics (mirrors the experiment's deployable form exactly):
    - each arm's scores are normalized WITHIN its returned list
      (min-max or z-score); docs absent from a list contribute 0;
    - fused(doc) = Σ_arm weight * normalized(doc);
    - CombMNZ multiplies by the number of arms ranking the doc in
      their top-``SUPPORT_K`` prefix (max'd with 1);
    - ties break by first appearance across the chained lists, the
      same rule ``weighted_reciprocal_rank`` uses."""
    if method not in ("combsum", "combmnz"):
        raise ValueError(f"unknown fusion method {method!r}")
    fused: dict[str, float] = defaultdict(float)
    support: dict[str, int] = defaultdict(int)
    for hits, weight in zip(hit_lists, weights, strict=True):
        # weight-0 arms contribute NOTHING, including CombMNZ support
        # (create_retriever never builds them; this guards direct use)
        if not hits or weight == 0.0:
            continue
        normed = _list_norm_scores(hits, norm)
        if method == "combmnz" and normed and min(normed) < 0:
            # MNZ multiplies the fused score by support count, which
            # inverts into a penalty on negative scores (possible under
            # zscore norm; minmax is already non-negative so this is a
            # no-op there): shift the list to non-negative so agreement
            # always promotes.
            lo = min(normed)
            normed = [s - lo for s in normed]
        for hit, s in zip(hits, normed):
            fused[hit.key] += weight * s
        for hit in hits[:SUPPORT_K]:
            support[hit.key] += 1
    if method == "combmnz":
        for key in fused:
            fused[key] *= max(support[key], 1)

    unique: list[SearchHit] = []
    seen: set[str] = set()
    for hits, weight in zip(hit_lists, weights, strict=True):
        if weight == 0.0:
            continue
        for hit in hits:
            if hit.key not in seen:
                seen.add(hit.key)
                unique.append(hit)
    return sorted(unique, key=lambda h: fused[h.key], reverse=True)


class EnsembleRetriever:
    def __init__(
        self,
        retrievers: list,
        weights: list[float] | None = None,
        fusion_method: str = "rrf",
        fusion_norm: str = "minmax",
        output_limit: int | None = None,
    ):
        """``fusion_method="rrf"`` (default) is the reference-parity
        rank fusion; "combsum"/"combmnz" fuse by normalized scores
        (``weighted_score_fusion``). ``output_limit`` truncates the
        fused list — score fusion retrieves DEEP per-arm lists (depth
        30 in the measured profile) whose full union would flood the
        QA prompt, so the serving layer caps the output at the same
        worst-case volume the RRF union produces."""
        self.retrievers = retrievers
        self.weights = weights or [1.0] * len(retrievers)
        self.fusion_method = fusion_method
        self.fusion_norm = fusion_norm
        self.output_limit = output_limit

    def _fuse(self, hit_lists: list[list[SearchHit]]) -> list[SearchHit]:
        if self.fusion_method == "rrf":
            fused = weighted_reciprocal_rank(hit_lists, self.weights)
        else:
            fused = weighted_score_fusion(
                hit_lists,
                self.weights,
                method=self.fusion_method,
                norm=self.fusion_norm,
            )
        return fused if self.output_limit is None else fused[: self.output_limit]

    async def aretrieve(self, query: str) -> list[SearchHit]:
        hit_lists = await asyncio.gather(
            *(r.aretrieve(query) for r in self.retrievers)
        )
        return self._fuse(list(hit_lists))

    async def aretrieve_batch(
        self, queries: list[str]
    ) -> list[list[SearchHit]]:
        """Batch fusion: sub-retrievers exposing retrieve_batch (semantic
        dense scan, dense BM25) serve all queries in one device dispatch
        each; the rest fall back to per-query calls."""
        loop = asyncio.get_running_loop()

        async def per_retriever(r) -> list[list[SearchHit]]:
            if hasattr(r, "retrieve_batch"):
                return await loop.run_in_executor(
                    None, r.retrieve_batch, queries
                )
            return list(
                await asyncio.gather(*(r.aretrieve(q) for q in queries))
            )

        all_lists = await asyncio.gather(
            *(per_retriever(r) for r in self.retrievers)
        )  # [n_retrievers][n_queries]
        return [
            self._fuse([lists[qi] for lists in all_lists])
            for qi in range(len(queries))
        ]
