"""The port's dense-index layouts beyond the plain scan, against the JAX
package's on the CPU (tests/test_dense_index.py's corpora, numpy-seeded):

- two_pass: the same hits as the port's float32 index (distances within
  2e-6) on random data and on the adversarial-tie corpus (300 identical
  rows and 300 within 1e-7 of them), its ``ok`` equal to the JAX
  ``_find_two_pass_kernel``'s, the fallback taken where the window cannot
  separate the rows, and on random data the same hits as the JAX two_pass
  index (on the tie corpus the order of the tied rows is f32 rounding
  noise, which differs with the product's shape);
- one query (float32 and bfloat16): its whole scores ranked once give
  the blocked scan's hits and distances bit for bit, and on random data
  the hits of the JAX index's block-select;
- int8: rows, scales and norms equal to the JAX package's bit for bit,
  the distances of the same s32 product and query norm bit for bit (the
  euclidean ones within an ulp: torch's CPU sqrt), and
  the index's hits equal to the JAX index's, distances within rtol 1e-6
  and two ulps of |q|^2 (the f32 query norm is a sum whose order XLA and
  torch choose differently, so it may differ by an ulp);
- both reject cosine; ``nbytes``; batch equal to single; padding rows never
  surface.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.index import dense_index as jdi
from dial_rag_tpu.index.dense_index import DenseIndex as JaxDenseIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.ops.metrics import Metric as JaxMetric
from dial_rag_tpu_torch.index import dense_index as di
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.ops.metrics import Metric

NON_COSINE = [Metric.SQEUCLIDEAN_DIST, Metric.EUCLIDEAN_DIST, Metric.INNER_PRODUCT]


def port_index(emb, storage, metric=Metric.SQEUCLIDEAN_DIST, limit=7):
    return DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(len(emb)), emb)], metric=metric,
                      limit=limit, storage_dtype=storage, device="cpu")


def jax_index(emb, storage, metric=Metric.SQEUCLIDEAN_DIST, limit=7):
    return JaxDenseIndex(JaxRetrievalType.TEXT, [JaxDocEmbeddings(np.arange(len(emb)), emb)],
                         metric=metric.value, limit=limit, storage_dtype=storage)


def ids(hits):
    return [(h.doc_id, h.chunk_id) for h in hits]


def random_corpus(n=3000, d=48, seed=7):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    queries = [(emb[i] + 0.05 * rng.standard_normal(d)).astype(np.float32) for i in range(0, 40, 5)]
    queries += [rng.standard_normal(d).astype(np.float32) for _ in range(8)]
    return emb, np.stack(queries)


def tie_corpus(seed=13, n_noise=400):
    """tests/test_dense_index.py's adversarial corpus: 300 exact duplicates
    of ``base``, 300 rows within 1e-7 of it, noise, shuffled."""
    rng = np.random.default_rng(seed)
    d = 48
    base = rng.standard_normal(d).astype(np.float32)
    base /= np.linalg.norm(base)
    dup = np.tile(base, (300, 1))
    near = base + 1e-7 * rng.standard_normal((300, d)).astype(np.float32)
    noise = rng.standard_normal((n_noise, d)).astype(np.float32)
    emb = np.concatenate([noise[: n_noise // 2], dup, near, noise[n_noise // 2 :]]).astype(np.float32)
    emb = emb[rng.permutation(emb.shape[0])]
    queries = np.stack([base, (base + 1e-8).astype(np.float32), rng.standard_normal(d).astype(np.float32),
                        (emb[77] + 0.02 * rng.standard_normal(d)).astype(np.float32)])
    return emb, queries


def assert_same_hits(a, b, queries, atol=2e-6):
    for q in queries:
        ha, da = a.find_with_distances(q)
        hb, db = b.find_with_distances(q)
        assert ids(ha) == ids(hb)
        np.testing.assert_allclose(np.asarray(da, np.float32), np.asarray(db, np.float32), rtol=2e-6, atol=atol)


@pytest.mark.parametrize("corpus", ["random", "ties"])
@pytest.mark.parametrize("metric", NON_COSINE)
def test_two_pass_identical_to_float32(corpus, metric):
    emb, queries = random_corpus() if corpus == "random" else tie_corpus()
    f32 = port_index(emb, "float32", metric)
    tp = port_index(emb, "two_pass", metric)
    assert_same_hits(f32, tp, queries)
    for hits, f32_hits in zip(tp.find_batch(queries), f32.find_batch(queries)):
        assert ids(hits) == ids(f32_hits)
    if corpus == "random":  # on the tie corpus the order is f32 rounding noise, another for each product shape
        ref = jax_index(emb, "two_pass", metric)
        for q, hits in zip(queries, tp.find_batch(queries)):
            assert ids(hits) == ids(tp.find(q)) == ids(ref.find(q))


def test_two_pass_ok_matches_jax_and_falls_back_on_ties(monkeypatch):
    """``ok`` per query equals the JAX kernel's on the same inputs: true on
    separated data, false on the tie corpus's tied queries, where the port
    then takes the full f32 scan."""
    for (emb, queries), expect in ((random_corpus(seed=3), True), (tie_corpus(), False)):
        tp = port_index(emb, "two_pass")
        ref = jax_index(emb, "two_pass")
        qt, q_sq = tp._prepare(torch.from_numpy(queries[:2]))
        ok, _ = tp._two_pass_window(qt, q_sq, 7)
        for q, port_ok in zip(queries[:2], ok.tolist()):
            jax_ok, _, _ = jdi._find_two_pass_kernel(
                ref._emb, ref._emb_f32, jnp.asarray(q), jnp.int32(ref.n_rows), *ref._err,
                ref._rn2_bf16, ref._rn2_f32, metric=ref.metric, k=7)
            assert bool(jax_ok) == expect == port_ok
        calls = []
        monkeypatch.setattr(tp, "_full_scan", lambda *a, **k: calls.append(1) or di.DenseIndex._full_scan(tp, *a, **k))
        tp.find(queries[0])
        monkeypatch.undo()
        assert bool(calls) != expect


@pytest.mark.parametrize("m", [300, 1025, 20001])
def test_stable_topk_rows_matches_the_sort_form(m):
    """One topk of the (value, row) keys gives the stable order, ties, NaN
    and +-inf included, and so does a merge of two blocks' winners."""
    from dial_rag_tpu_torch.ops.stable_topk import stable_topk_rows, stable_topk_sort

    g = torch.Generator().manual_seed(m)
    for _ in range(5):
        v = torch.randint(-3, 3, (4, m), generator=g).float() * 0.5
        v[0, 5], v[2, :10], v[3, 3], v[1, -3:] = float("nan"), float("inf"), float("-inf"), float("nan")
        for k in (1, 7, 200):
            vals, rows = stable_topk_rows(v, torch.arange(m), k)
            ref_vals, ref_rows = stable_topk_sort(v, k)
            assert torch.equal(vals, ref_vals) and torch.equal(rows, ref_rows)
        h = m // 2
        a, b = stable_topk_rows(v[:, :h], torch.arange(h), 9), stable_topk_rows(v[:, h:], torch.arange(h, m), 9)
        merged = stable_topk_rows(torch.cat([a[0], b[0]], 1), torch.cat([a[1], b[1]], 1), 9)
        ref_vals, ref_rows = stable_topk_sort(v, 9)
        assert torch.equal(merged[0], ref_vals) and torch.equal(merged[1], ref_rows)
    assert stable_topk_rows(torch.full((2, m), float("inf")), torch.arange(m), 7)[1].tolist() == [list(range(7))] * 2


@pytest.mark.parametrize("corpus", ["random", "ties"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", NON_COSINE)
def test_single_query_is_the_full_scan_and_the_jax_blockselect(corpus, storage, metric, monkeypatch):
    """One query ranks its whole scores once; the same hits and distances,
    bit for bit, as the scan ranked a block at a time and merged, and on
    random data the hits of the JAX index, whose lone query takes
    block-select's window there (on the tie corpus the order of the tied
    rows is f32 rounding noise, another for each product shape)."""
    emb, queries = random_corpus(n=9000) if corpus == "random" else tie_corpus(seed=21, n_noise=2400)
    idx = port_index(emb, storage, metric)
    qt, q_sq = idx._prepare(torch.from_numpy(queries[:1]))
    assert idx._per_row_bytes(1, False) * idx._emb.shape[0] <= idx._scan_budget()  # ranked whole
    whole = [idx.find_with_distances(q) for q in queries]
    monkeypatch.setattr(di, "_SCAN_BYTES", (1, 1))  # every block a _ROW_QUANTUM of rows, ranked apart
    assert len(idx._row_blocks(idx._per_row_bytes(1, True))) > 1
    assert idx._per_row_bytes(1, False) * idx._emb.shape[0] > idx._scan_budget()
    for q, (hits, dists) in zip(queries, whole):
        b_hits, b_dists = idx.find_with_distances(q)
        assert ids(hits) == ids(b_hits)
        assert np.array_equal(np.asarray(dists, np.float32), np.asarray(b_dists, np.float32))
    if corpus == "random":
        ref = jax_index(emb, storage, metric)
        for q, (hits, _) in zip(queries, whole):
            ok, _, _ = jdi._find_blockselect_kernel(
                ref._emb, jnp.asarray(q), jnp.int32(ref.n_rows), ref._norm_max, getattr(ref, "_rn2_cache", None),
                metric=ref.metric, k=7)
            assert bool(ok)
            assert ids(hits) == ids(ref.find(q))


def test_device_matrix_and_cosine_single_query_match_full_scan():
    emb, queries = random_corpus(n=700, d=16)
    idx = DenseIndex.from_device_matrix(RetrievalType.TEXT, torch.from_numpy(emb), limit=5)
    assert idx._emb.shape[0] == 700 and idx.nbytes == 700 * 16 * 4
    full = port_index(emb, "float32", limit=5)
    for q in queries:
        assert ids(idx.find(q)) == ids(full.find(q))
    cos = port_index(emb, "float32", Metric.COSINE_SIM, limit=5)
    ref = jax_index(emb, "float32", Metric.COSINE_SIM, limit=5)
    for q, hits in zip(queries, cos.find_batch(queries)):
        assert ids(cos.find(q)) == ids(hits) == ids(ref.find(q))


@pytest.mark.parametrize("metric", NON_COSINE)
def test_int8_matches_jax_bit_for_bit(metric):
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(1000, 64)).astype(np.float32)
    rows[5] = 0.0  # the zero-row guard
    queries = (rows[:16] + rng.normal(size=(16, 64)).astype(np.float32) * 0.05).astype(np.float32)
    queries[3] = 0.0  # the zero-query guard
    port, ref = port_index(rows, "int8", metric), jax_index(rows, "int8", metric)
    assert np.array_equal(port._emb.numpy(), np.asarray(ref._emb))
    assert np.array_equal(port._scales.numpy(), np.asarray(ref._scales))
    assert np.array_equal(port._rn2.numpy(), np.asarray(ref._row_norm2))
    q8, sq = di.quantize_queries_int8(torch.from_numpy(queries))
    jq8, jsq = jdi._int8_quantize_query(jnp.asarray(queries))
    assert np.array_equal(q8.numpy(), np.asarray(jq8)) and np.array_equal(sq.numpy(), np.asarray(jsq))
    q_norm2 = np.sum(queries.astype(np.float64) ** 2, axis=-1).astype(np.float32)
    prod = torch._int_mm(port._emb, q8.T.contiguous()).T
    for m in {metric, Metric.SQEUCLIDEAN_DIST} if metric == Metric.EUCLIDEAN_DIST else {metric}:
        got = di.int8_distances(prod, port._scales, port._rn2, sq, torch.from_numpy(q_norm2), m).numpy()
        want = np.asarray(jdi._int8_distances(ref._emb, ref._scales, ref._row_norm2, jq8, jsq,
                                              jnp.asarray(q_norm2)[:, None], JaxMetric(m.value)))
        if m == Metric.EUCLIDEAN_DIST:
            # the square roots of the same bits: torch's vectorised CPU sqrt
            # rounds a few in a thousand one ulp away from numpy's and XLA's
            np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
        else:
            assert np.array_equal(got, want)
    batch = port.find_batch(queries)
    for q, hits in zip(queries, batch):
        h, d = port.find_with_distances(q)
        rh, rd = ref.find_with_distances(q)
        assert ids(h) == ids(rh) == ids(hits)
        # the f32 |q|^2 may differ by an ulp: the squared distance then too,
        # whatever its size (compared squared, as the square root magnifies
        # it near zero)
        if metric == Metric.EUCLIDEAN_DIST:
            d, rd = np.square(d), np.square(rd)
        np.testing.assert_allclose(d, rd, rtol=1e-6, atol=2.5e-7 * float(np.dot(q, q)))


def test_int8_top7_overlap_with_float32():
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(4096, 384)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    f32, i8 = port_index(rows, "float32"), port_index(rows, "int8")
    queries = rows[:32] + rng.normal(size=(32, 384)).astype(np.float32) * 0.05
    overlap = [len({h.chunk_id for h in a} & {h.chunk_id for h in b}) / 7
               for a, b in zip(f32.find_batch(queries), i8.find_batch(queries))]
    assert np.mean(overlap) >= 0.85, overlap
    assert i8.nbytes < f32.nbytes / 3


@pytest.mark.parametrize("storage", ["two_pass", "int8"])
def test_layouts_reject_cosine(storage):
    with pytest.raises(ValueError, match=storage):
        port_index(np.eye(3, dtype=np.float32), storage, Metric.COSINE_SIM)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "two_pass", "int8"])
def test_nbytes_matches_jax(storage):
    rows = np.random.default_rng(1).standard_normal((600, 32)).astype(np.float32)
    port = port_index(rows, storage, limit=5)
    assert port.nbytes == jax_index(rows, storage, limit=5).nbytes
    if storage == "two_pass":
        assert port.nbytes == port_index(rows, "float32").nbytes * 3 // 2


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "two_pass", "int8"])
@pytest.mark.parametrize("metric", NON_COSINE)
def test_batch_equals_single_and_padding_never_surfaces(storage, metric):
    """Ten rows padded to 512: ``limit`` above the row count returns every
    row once and no padding row, alone and in a batch, as the JAX index."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((10, 16)).astype(np.float32)
    queries = rng.standard_normal((5, 16)).astype(np.float32)
    port, ref = port_index(rows, storage, metric, limit=12), jax_index(rows, storage, metric, limit=12)
    assert port._emb.shape[0] == 512
    for q, hits in zip(queries, port.find_batch(queries)):
        assert ids(hits) == ids(port.find(q)) == ids(ref.find(q))
        assert sorted(h.chunk_id for h in hits) == list(range(10))


def test_scan_blocks_bound_the_transient(monkeypatch):
    """A matrix over several scan blocks gives the hits of one block: the
    per-block top-k and the merge keep the earliest row on ties."""
    emb, queries = tie_corpus()
    one = port_index(emb, "bfloat16")
    monkeypatch.setattr(di, "_SCAN_BYTES", (1, 1))  # every block a _ROW_QUANTUM of rows
    many = port_index(emb, "bfloat16")
    assert len(many._row_blocks(many._per_row_bytes(4, True))) == 2
    for a, b in zip(one.find_batch(queries), many.find_batch(queries)):
        assert ids(a) == ids(b)
