"""The port's distance metrics and stable top-k.

Metrics are held against a float64 numpy computation of the same
formulas (f32 tolerance 1e-5 on unit-scale inputs) and against the JAX
package's metrics; top-k against numpy's stable argsort, with adversarial
ties (the earliest row must win), NaN rows (ranked as +inf) and real +inf
distances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.ops.metrics import pairwise_distances_batch as jax_pairwise_batch
from dial_rag_tpu_torch.ops.metrics import (
    Metric,
    pairwise_distances,
    pairwise_distances_batch,
    row_norm2,
)
from dial_rag_tpu_torch.ops.stable_topk import (
    ARGMIN_MAX_K,
    stable_topk,
    stable_topk_argmin,
    stable_topk_sort,
)


def _numpy_metric(q, d, metric):
    q, d = q.astype(np.float64), d.astype(np.float64)
    dot = q @ d.T
    if metric == Metric.INNER_PRODUCT:
        return -dot
    qn, dn = np.sqrt((q * q).sum(-1)), np.sqrt((d * d).sum(-1))
    if metric == Metric.COSINE_SIM:
        return -(dot / np.maximum(qn[:, None] * dn[None, :], 1e-8))
    sq = (d * d).sum(-1)[None, :] - 2 * dot + (q * q).sum(-1)[:, None]
    return np.sqrt(np.maximum(sq, 0)) if metric == Metric.EUCLIDEAN_DIST else sq


@pytest.mark.parametrize("metric", list(Metric))
@pytest.mark.parametrize("cached", [False, True])
def test_metrics_match_numpy_and_jax(metric, cached):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 48)).astype(np.float32)
    d = rng.standard_normal((300, 48)).astype(np.float32)
    d[7] = 0.0  # zero row: the cosine guard
    d[8] = d[3]  # exact duplicate
    td = torch.from_numpy(d)
    rn2 = row_norm2(td) if cached else None
    out = pairwise_distances_batch(torch.from_numpy(q), td, metric, rn2).numpy()
    np.testing.assert_allclose(out, _numpy_metric(q, d, metric), rtol=1e-5, atol=1e-4)
    jax_out = np.asarray(jax_pairwise_batch(jnp.asarray(q), jnp.asarray(d), metric.value))
    np.testing.assert_allclose(out, jax_out, rtol=1e-5, atol=1e-4)
    single = pairwise_distances(torch.from_numpy(q[2]), td, metric, rn2).numpy()
    np.testing.assert_allclose(single, out[2], rtol=1e-6, atol=1e-5)


def test_metrics_bf16_docs_upcast():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)).bfloat16()
    out = pairwise_distances_batch(q, d, Metric.SQEUCLIDEAN_DIST)
    ref = _numpy_metric(q.numpy(), d.float().numpy(), Metric.SQEUCLIDEAN_DIST)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def _np_stable(v, k):
    v = np.where(np.isnan(v), np.inf, v)
    idx = np.argsort(v, kind="stable")[:k]
    return v[idx], idx


TIE_ROWS = [
    np.array([3.0, 1.0, 1.0, 2.0, 1.0, 0.5, 0.5, 7.0], np.float32),
    np.array([np.nan, 2.0, np.inf, 2.0, np.nan, -1.0, np.inf, -1.0], np.float32),
    np.full(8, 4.0, np.float32),
    np.array([np.inf, np.nan, np.inf, 1.0, np.nan, 1.0, -np.inf, 0.0], np.float32),
]


@pytest.mark.parametrize("row", range(len(TIE_ROWS)))
@pytest.mark.parametrize("fn", [stable_topk_argmin, stable_topk_sort])
def test_stable_topk_adversarial_ties(row, fn):
    v = TIE_ROWS[row]
    for k in (1, 3, 8, 20):
        vals, idx = fn(torch.from_numpy(v), k)
        ref_vals, ref_idx = _np_stable(v, k)
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(vals.numpy(), ref_vals)


def test_stable_topk_batched_rows_and_dispatch():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 5, size=(6, 500)).astype(np.float32)  # mass ties
    v[2, ::7] = np.nan
    for k in (5, ARGMIN_MAX_K + 8):
        vals, idx = stable_topk(torch.from_numpy(v), k)
        for r in range(v.shape[0]):
            ref_vals, ref_idx = _np_stable(v[r], k)
            np.testing.assert_array_equal(idx[r].numpy(), ref_idx)
            np.testing.assert_array_equal(vals[r].numpy(), ref_vals)


def test_stable_topk_empty():
    vals, idx = stable_topk(torch.zeros(0), 3)
    assert vals.shape == (0,) and idx.shape == (0,)
