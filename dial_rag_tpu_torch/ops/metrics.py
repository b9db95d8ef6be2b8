"""Distance metrics for the dense index scan (counterpart of
``dial_rag_tpu/ops/metrics.py``).

Every metric returns "smaller is better" ranking scores:

- ``inner_product``: negative inner product;
- ``cosine_sim``: negative cosine similarity, ``dot / max(|q||d|, 1e-8)``
  (the guard of ``torch.nn.functional.cosine_similarity``);
- ``sqeuclidean_dist``: the ``|d|^2 - 2 q.d + |q|^2`` expansion the
  reference uses for precision;
- ``euclidean_dist``: the square root of the above.

All arithmetic is f32; a bf16 matrix is upcast first. The q.d product is a
plain matmul (TF32 is off, see ``device.resolve_device``), so distances
keep the reference's numpy-exact f32 contract.
"""

from enum import Enum

import torch

_COSINE_EPS = 1e-8


class Metric(str, Enum):
    COSINE_SIM = "cosine_sim"
    EUCLIDEAN_DIST = "euclidean_dist"
    SQEUCLIDEAN_DIST = "sqeuclidean_dist"
    INNER_PRODUCT = "inner_product"


def row_norm2(docs: torch.Tensor) -> torch.Tensor:
    """``sum(docs**2, -1)`` in f32: the build-time cache of the index."""
    x = docs.float()
    return torch.sum(x * x, dim=-1)


def pairwise_distances_batch(
    queries: torch.Tensor,
    docs: torch.Tensor,
    metric: Metric | str,
    row_norm2_cache: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distances of ``queries`` [Q, D] against ``docs`` [N, D] -> [Q, N].

    ``row_norm2_cache`` [N] (optional) is ``row_norm2(docs)`` of the same
    stored matrix; it saves the second pass over the matrix."""
    metric = Metric(metric)
    docs = docs.float()
    queries = queries.float()
    dot = queries @ docs.T
    if metric == Metric.INNER_PRODUCT:
        return -dot
    rn2 = row_norm2(docs) if row_norm2_cache is None else row_norm2_cache
    q_sq = torch.sum(queries * queries, dim=-1)
    if metric == Metric.COSINE_SIM:
        denom = torch.clamp(
            torch.sqrt(q_sq)[:, None] * torch.sqrt(rn2)[None, :], min=_COSINE_EPS
        )
        return -(dot / denom)
    sq = rn2[None, :] - 2.0 * dot + q_sq[:, None]
    if metric == Metric.EUCLIDEAN_DIST:
        return torch.sqrt(sq)
    return sq


def pairwise_distances(
    query: torch.Tensor,
    docs: torch.Tensor,
    metric: Metric | str,
    row_norm2_cache: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ranking distances of ``query`` [D] against ``docs`` [N, D] -> [N];
    the same numerics per row as :func:`pairwise_distances_batch`."""
    return pairwise_distances_batch(
        query.reshape(1, -1), docs, metric, row_norm2_cache
    )[0]
