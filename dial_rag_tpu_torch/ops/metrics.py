"""Distance metrics for the dense index scan (counterpart of
``dial_rag_tpu/ops/metrics.py``).

Every metric returns "smaller is better" ranking scores:

- ``inner_product``: negative inner product;
- ``cosine_sim``: negative cosine similarity, ``dot / max(|q||d|, 1e-8)``
  (the guard of ``torch.nn.functional.cosine_similarity``);
- ``sqeuclidean_dist``: the ``|d|^2 - 2 q.d + |q|^2`` expansion the
  reference uses for precision;
- ``euclidean_dist``: the square root of the above.

All arithmetic is f32; a bf16 matrix is upcast first, a block of rows at a
time in the index scans (``block_distances``). The q.d product is a
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


def distances_from_dot(dot: torch.Tensor, q_sq: torch.Tensor, rn2: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Distances from the f32 products ``dot`` of queries and rows, in place
    on ``dot``; ``q_sq`` and ``rn2`` are the squared norms, shaped to
    broadcast against it. ``-2 dot + |d|^2 + |q|^2`` rounds as ``|d|^2 - 2
    dot + |q|^2`` does, bit for bit."""
    if metric == Metric.INNER_PRODUCT:
        return dot.neg_()
    if metric == Metric.COSINE_SIM:
        denom = torch.clamp(torch.sqrt(q_sq) * torch.sqrt(rn2), min=_COSINE_EPS)
        return dot.div_(denom).neg_()
    sq = dot.mul_(-2.0).add_(rn2).add_(q_sq)
    return sq.sqrt_() if metric == Metric.EUCLIDEAN_DIST else sq


def block_distances(
    queries: torch.Tensor,
    q_sq: torch.Tensor,
    docs: torch.Tensor,
    rn2: torch.Tensor,
    metric: Metric,
) -> torch.Tensor:
    """Distances of ``queries`` [Q, D] f32 (``q_sq`` [Q] their squared
    norms) against ``docs`` [R, D] (``rn2`` [R] its squared norms) -> [Q,
    R] f32. A bf16 ``docs`` is upcast here, so an index that scans its
    matrix a block of rows at a time holds one block in f32, never the
    whole."""
    return distances_from_dot(queries @ docs.float().T, q_sq[:, None], rn2[None, :], metric)


def pairwise_distances_batch(
    queries: torch.Tensor,
    docs: torch.Tensor,
    metric: Metric | str,
    row_norm2_cache: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distances of ``queries`` [Q, D] against ``docs`` [N, D] -> [Q, N].

    ``row_norm2_cache`` [N] (optional) is ``row_norm2(docs)`` of the same
    stored matrix; it saves the second pass over the matrix."""
    queries = queries.float()
    rn2 = row_norm2(docs) if row_norm2_cache is None else row_norm2_cache
    return block_distances(queries, torch.sum(queries * queries, dim=-1), docs, rn2, Metric(metric))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [M, K] int8 times ``b`` [K, N] int8 -> [M, N] int32, exact
    (``torch._int_mm``: s8 x s8 -> s32). On CUDA the product wants M > 16
    and K, N multiples of 8, and ``b`` as the transpose of a row-major [N,
    K] tensor: the operands are zero-padded to that, which adds exact
    zeros, and the result sliced back."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a, b)
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    bt = b.T
    if (np_, kp) != (n, k) or not bt.is_contiguous():
        bt = torch.nn.functional.pad(bt, (0, kp - k, 0, np_ - n)).contiguous()
    return torch._int_mm(a.contiguous(), bt.T)[:m, :n]


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
