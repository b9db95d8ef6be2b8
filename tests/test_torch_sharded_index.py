"""The port's sharded indexes (``dial_rag_tpu_torch/parallel/sharded_index.py``)
against the JAX package's, on the CPU.

One case for each test of tests/test_sharded_index.py, under its name.
Each runs the JAX test's inputs (numpy, the same seeds) through the port's
sharded index on a mesh of 8 CPU slots (``[cpu] * 8``), through the JAX
sharded index on the conftest's 8 host devices, and through the port's
unsharded index, and holds the port's sharded result to both: the same
hits, distances within the JAX test's own tolerance (rtol 1e-6, atol 1e-6
where it states none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.index.bm25 import Bm25Index as JaxBm25Index
from dial_rag_tpu.index.dense_index import DenseIndex as JaxDenseIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.late_interaction import LateInteractionIndex as JaxLateInteractionIndex
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.parallel import mesh as jax_mesh_mod
from dial_rag_tpu.parallel import sharded_index as jsi
from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.ops.metrics import Metric
from dial_rag_tpu_torch.parallel.mesh import create_mesh
from dial_rag_tpu_torch.parallel.sharded_index import (
    ShardedBm25Index,
    ShardedBm25SparseIndex,
    ShardedDenseIndex,
    ShardedLateInteractionIndex,
)

TEXT = RetrievalType.TEXT
JTEXT = JaxRetrievalType.TEXT
NON_COSINE = [Metric.SQEUCLIDEAN_DIST, Metric.EUCLIDEAN_DIST, Metric.INNER_PRODUCT]


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jax_mesh_mod.create_mesh(8)


def ids(hits):
    return [(h.doc_id, h.chunk_id) for h in hits]


def dense_pair(docs, mesh, jmesh, **kw):
    """(the port's sharded, the JAX sharded, the port's unsharded) dense
    index over the same ``(chunk_ids, embeddings)`` documents."""
    port = ShardedDenseIndex(TEXT, [DocEmbeddings(c, e) for c, e in docs], mesh, **kw)
    jkw = {**kw, "metric": kw["metric"].value} if "metric" in kw else kw
    ref = jsi.ShardedDenseIndex(JTEXT, [JaxDocEmbeddings(c, e) for c, e in docs], jmesh, **jkw)
    single = DenseIndex(TEXT, [DocEmbeddings(c, e) for c, e in docs], device="cpu", **kw)
    return port, ref, single


def assert_dense_same(port, ref, single, queries, rtol=1e-6, atol=1e-6, jax_atol=None):
    """The same hits from all three; distances within (rtol, atol) of the
    port's unsharded index's and of the JAX package's (``jax_atol`` where
    that comparison needs its own)."""
    for q in queries:
        hp, dp = port.find_with_distances(q)
        hr, dr = ref.find_with_distances(q)
        hs, ds = single.find_with_distances(q)
        assert hp == hs
        assert ids(hp) == ids(hr)
        np.testing.assert_allclose(dp, ds, rtol=rtol, atol=atol)
        np.testing.assert_allclose(np.asarray(dp, np.float32), np.asarray(dr, np.float32), rtol=rtol,
                                   atol=atol if jax_atol is None else jax_atol)


def _random_docs(rng, n_docs, rows_per_doc, dim=16):
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(1, rows_per_doc + 1))
        docs.append((np.arange(n), rng.standard_normal((n, dim)).astype(np.float32)))
    return docs


@pytest.mark.parametrize("metric", list(Metric))
def test_matches_single_chip(mesh, jmesh, metric):
    rng = np.random.default_rng(0)
    docs = _random_docs(rng, n_docs=5, rows_per_doc=40)
    query = rng.standard_normal(16).astype(np.float32)
    assert_dense_same(*dense_pair(docs, mesh, jmesh, metric=metric, limit=7), [query])


def test_tie_break_across_shards(mesh, jmesh):
    # every distance ties: the first `limit` global rows in order, whatever
    # the shard boundaries
    n = 3000
    docs = [(np.arange(n), np.ones((n, 8), dtype=np.float32))]
    port, ref, single = dense_pair(docs, mesh, jmesh, metric=Metric.SQEUCLIDEAN_DIST, limit=5)
    q = np.ones(8, dtype=np.float32)
    assert [h.chunk_id for h in port.find(q)] == [h.chunk_id for h in ref.find(q)] == [0, 1, 2, 3, 4]
    assert port.find(q) == single.find(q)


def test_fewer_rows_than_limit(mesh, jmesh):
    rng = np.random.default_rng(1)
    docs = [(np.arange(3), rng.standard_normal((3, 8)).astype(np.float32))]
    port, ref, single = dense_pair(docs, mesh, jmesh, metric=Metric.COSINE_SIM, limit=7)
    q = rng.standard_normal(8).astype(np.float32)
    assert len(port.find(q)) == len(ref.find(q)) == 3
    assert_dense_same(port, ref, single, [q])


def test_empty_index(mesh, jmesh):
    port = ShardedDenseIndex(TEXT, [], mesh, limit=7)
    ref = jsi.ShardedDenseIndex(JTEXT, [], jmesh, limit=7)
    q = np.ones(8, dtype=np.float32)
    assert port.find(q) == ref.find(q) == []
    assert port.find_batch(np.ones((2, 8), np.float32)) == [[], []]
    assert port.nbytes == 0


def test_rows_spread_across_all_shards(mesh, jmesh):
    rng = np.random.default_rng(2)
    n = 8 * 512 + 17
    emb = rng.standard_normal((n, 8)).astype(np.float32)
    target = int(rng.integers(0, n))
    port, ref, single = dense_pair([(np.arange(n), emb)], mesh, jmesh, metric=Metric.SQEUCLIDEAN_DIST, limit=1)
    assert port.find(emb[target])[0].chunk_id == ref.find(emb[target])[0].chunk_id == target
    # the JAX package's layout: 515 rows a shard rounded up to the 512-row
    # quantum, so the last three shards hold padding only
    assert [base for base, _ in port._shards] == [s * 1024 for s in range(8)]
    assert [sh.n_rows for _, sh in port._shards] == [1024] * 4 + [17, 0, 0, 0]
    assert_dense_same(port, ref, single, [emb[target], emb[n - 1]])


def test_multihost_helpers_single_process():
    """One process: no group, a mesh over this process's devices."""
    from dial_rag_tpu.parallel import multihost as jmh
    from dial_rag_tpu_torch.parallel.multihost import create_global_mesh, initialize_multihost

    assert initialize_multihost() is False
    assert jmh.initialize_multihost() is False
    m = create_global_mesh(tp=2, devices=["cpu"] * 8)
    assert dict(m.shape) == dict(jmh.create_global_mesh(tp=2).shape) == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError):
        create_global_mesh(tp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        jmh.create_global_mesh(tp=3)


def test_find_batch_matches_single_chip_batch(mesh, jmesh):
    rng = np.random.default_rng(5)
    docs = _random_docs(rng, n_docs=4, rows_per_doc=50)
    queries = rng.standard_normal((6, 16)).astype(np.float32)
    port, ref, single = dense_pair(docs, mesh, jmesh, limit=7)
    got = port.find_batch(queries)
    assert got == single.find_batch(queries)
    assert [ids(h) for h in got] == [ids(h) for h in ref.find_batch(queries)]


def test_sharded_bfloat16_storage(mesh, jmesh):
    rng = np.random.default_rng(6)
    n = 1200
    emb = rng.standard_normal((n, 16)).astype(np.float32)
    docs = [(np.arange(n), emb)]
    port, ref, single = dense_pair(docs, mesh, jmesh, limit=3, storage_dtype="bfloat16")
    f32 = ShardedDenseIndex(TEXT, [DocEmbeddings(*docs[0])], mesh, limit=3)
    assert port.nbytes * 2 == f32.nbytes
    target = 321
    q = emb[target] + 0.01 * rng.standard_normal(16).astype(np.float32)
    assert port.find(q)[0].chunk_id == ref.find(q)[0].chunk_id == target
    # the JAX test states no distance tolerance here: the nearest row's
    # sqeuclidean distance (6e-4) is |x|^2 + |q|^2 - 2 q.x with |x|^2 near
    # 16, whose f32 products XLA and torch sum in orders of their own
    assert_dense_same(port, ref, single, [q], jax_atol=1e-5)


def bm25_items(seed, n, words, lo, hi):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(words, size=int(rng.integers(lo, hi)))) for _ in range(n)]


WORDS8 = ["alps", "climate", "glacier", "peak", "valley", "snow", "river", "pass"]
WORDS10 = WORDS8 + ["boundary", "cadibona"]


def test_sharded_bm25_matches_single_chip(mesh, jmesh):
    items = bm25_items(8, 60, WORDS8, 3, 10)
    single = Bm25Index.build(items, device="cpu")
    port = ShardedBm25Index(Bm25Index.build(items, device="cpu"), mesh, limit=7)
    ref = jsi.ShardedBm25Index(JaxBm25Index.build(items, device=False), jmesh, limit=7)
    assert port.layout == "sharded dense"
    for q in (["alps"], ["climate", "glacier"], ["peak", "missing"], ["snow", "snow", "river"]):
        got, got_scores = port.top_n_with_scores(q, 7)
        want, want_scores = single.top_n_with_scores(q, 7)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_scores, want_scores)
        np.testing.assert_array_equal(got, ref.top_n(q, 7))
        np.testing.assert_allclose(got_scores, ref.top_n_with_scores(q, 7)[1], rtol=1e-6, atol=1e-6)


def test_sharded_bm25_tiebreak_later_item_wins(mesh, jmesh):
    items = [["alps", "peak"]] * 40
    port = ShardedBm25Index(Bm25Index.build(items, device="cpu"), mesh, limit=5)
    ref = jsi.ShardedBm25Index(JaxBm25Index.build(items, device=False), jmesh, limit=5)
    np.testing.assert_array_equal(port.top_n(["alps"], 5), np.array([39, 38, 37, 36, 35]))
    np.testing.assert_array_equal(port.top_n(["alps"], 5), ref.top_n(["alps"], 5))


def sparse_pair(items, mesh, jmesh, limit, **kw):
    """(the port's sharded, the JAX sharded, the port's unsharded) CSC BM25."""
    port = ShardedBm25SparseIndex(
        Bm25Index.build(items, max_dense_bytes=0, device="cpu", max_band_bytes=0), mesh, limit=limit, **kw
    )
    ref = jsi.ShardedBm25SparseIndex(JaxBm25Index.build(items, max_dense_bytes=0, device=False), jmesh,
                                     limit=limit, **kw)
    single = Bm25Index.build(items, max_dense_bytes=0, device="cpu")
    return port, ref, single


def test_sharded_sparse_bm25_matches_single_chip(mesh, jmesh):
    items = bm25_items(11, 75, WORDS10, 3, 12)
    port, ref, single = sparse_pair(items, mesh, jmesh, 7)
    assert port.layout == "sharded csc" and single.layout == "csc"
    for q in (["alps"], ["climate", "glacier"], ["peak", "missing"], ["snow", "snow", "river"], ["missing-only"]):
        np.testing.assert_array_equal(port.get_scores(q), single.get_scores(q))
        np.testing.assert_allclose(port.get_scores(q), ref.get_scores(q), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(port.top_n(q, 7), single.top_n(q, 7))
        np.testing.assert_array_equal(port.top_n(q, 7), ref.top_n(q, 7))


def test_sharded_sparse_bm25_tiebreak_later_item_wins(mesh, jmesh):
    # ties everywhere, across shard boundaries too (5 items a shard)
    port, ref, _ = sparse_pair([["alps", "peak"]] * 40, mesh, jmesh, 12)
    np.testing.assert_array_equal(port.top_n(["alps"], 12), np.arange(39, 27, -1))
    np.testing.assert_array_equal(port.top_n(["alps"], 12), ref.top_n(["alps"], 12))


def test_sharded_sparse_bm25_retriever_wiring(mesh, jmesh, monkeypatch):
    """The retriever takes the sharded sparse index when the dense weights
    pass the byte cap on a mesh."""
    from dial_rag_tpu.documents import model as jmodel
    from dial_rag_tpu.retrieval import Bm25Retriever as JaxBm25Retriever
    from dial_rag_tpu_torch.documents import model
    from dial_rag_tpu_torch.retrieval import Bm25Retriever

    texts = [
        ("alps climate glacier", {"source": "s"}),
        ("cadibona boundary pass", {"source": "s"}),
        ("river valley snow", {"source": "s"}),
    ]

    def record(m):
        return m.DocumentRecord(
            format_version=m.FORMAT_VERSION, index_settings=m.IndexSettings(), chunks=m.build_chunks_list(texts),
            text_index=[t[0].split() for t in texts], embeddings_index=None, multimodal_embeddings_index=None,
            description_embeddings_index=None, mime_type="text/plain", document_bytes=b"",
        )

    for cls in (Bm25Index, JaxBm25Index):
        real = cls.build.__func__
        monkeypatch.setattr(cls, "build", classmethod(
            lambda c, items, _real=real, **kw: _real(c, items, **{**kw, "max_dense_bytes": 0})))
    port = Bm25Retriever.from_doc_records([record(model)], k=2, mesh=mesh)
    ref = JaxBm25Retriever.from_doc_records([record(jmodel)], k=2, mesh=jmesh)
    assert isinstance(port._index, ShardedBm25SparseIndex)
    got, want = port.retrieve("cadibona boundary"), ref.retrieve("cadibona boundary")
    assert got and got[0].chunk_id == 1
    assert ids(got) == ids(want)
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=1e-6, atol=1e-6)


def test_sharded_sparse_bm25_batch_matches_sequential(mesh, jmesh):
    items = bm25_items(13, 50, WORDS10, 3, 12)
    port, ref, single = sparse_pair(items, mesh, jmesh, 7)
    # 9 queries: more than the 8 shards, so a query/shard mixup shows
    queries = [["alps"], ["climate", "glacier", "climate"], ["missing-word"], ["snow", "river", "pass"],
               ["cadibona", "boundary"], ["valley"], ["peak", "peak"], ["glacier", "snow"],
               ["river", "cadibona", "alps"]]
    batched = port.top_n_batch(queries, 7)
    want = ref.top_n_batch(queries, 7)
    assert len(batched) == len(queries)
    for got, toks, w in zip(batched, queries, want):
        np.testing.assert_array_equal(got, port.top_n(toks, 7))
        np.testing.assert_array_equal(got, single.top_n(toks, 7))
        np.testing.assert_array_equal(got, w)


def _random_ragged_chunks(rng, n, d=16, t_max=9):
    return [rng.standard_normal((int(rng.integers(1, t_max)), d)).astype(np.float32) for _ in range(n)]


def li_trio(per_doc, mesh, jmesh, **kw):
    """(the port's sharded, the JAX sharded, the port's unsharded) MaxSim."""
    return (
        ShardedLateInteractionIndex(TEXT, per_doc, mesh, **kw),
        jsi.ShardedLateInteractionIndex(JTEXT, per_doc, jmesh, **kw),
        LateInteractionIndex(TEXT, per_doc, device="cpu", **kw),
    )


def assert_li_same(port, ref, single, queries, rtol=1e-6, atol=1e-5):
    for q in queries:
        hp, sp = port.find_with_scores(q)
        hr, sr = ref.find_with_scores(q)
        hs, ss = single.find_with_scores(q)
        assert hp == hs
        assert ids(hp) == ids(hr)
        np.testing.assert_allclose(sp, ss, rtol=rtol, atol=atol)
        np.testing.assert_allclose(sp, sr, rtol=rtol, atol=atol)


def test_sharded_maxsim_matches_single_chip(mesh, jmesh):
    rng = np.random.default_rng(0)
    doc_a = _random_ragged_chunks(rng, 700)
    doc_b = _random_ragged_chunks(rng, 650)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    assert_li_same(*li_trio([doc_a, doc_b], mesh, jmesh, max_chunk_tokens=16, limit=9), [q])


def test_sharded_maxsim_stable_ties_across_shards(mesh, jmesh):
    d = 8
    tok = np.zeros((1, d), dtype=np.float32)
    tok[0, 0] = 1.0
    rng = np.random.default_rng(1)
    chunks = [(rng.standard_normal((2, d)) * 0.01).astype(np.float32) for _ in range(2000)]
    copy_positions = [3, 700, 1500, 1999]
    for pos in copy_positions:
        chunks[pos] = tok.copy()
    port, ref, single = li_trio([chunks], mesh, jmesh, max_chunk_tokens=4, limit=4)
    assert [h.chunk_id for h in port.find(tok)] == [h.chunk_id for h in ref.find(tok)] == copy_positions
    assert port.find(tok) == single.find(tok)


def test_sharded_maxsim_empty_and_zero_token(mesh, jmesh):
    empty = np.zeros((0, 8), dtype=np.float32)
    q = np.ones((2, 8), dtype=np.float32)
    for per_doc in ([[]], [[empty, empty]]):
        port, ref, _ = li_trio(per_doc, mesh, jmesh, limit=3)
        assert port.find(q) == ref.find(q) == []
        assert port.nbytes == ref.nbytes == 0


def test_sharded_maxsim_find_batch_matches_single(mesh, jmesh):
    rng = np.random.default_rng(2)
    chunks = _random_ragged_chunks(rng, 900)
    port, ref, single = li_trio([chunks], mesh, jmesh, max_chunk_tokens=16, limit=5)
    queries = [rng.standard_normal((int(rng.integers(1, 6)), 16)).astype(np.float32) for _ in range(4)]
    queries.append(np.ones(16, np.float32))  # malformed -> []
    got = port.find_batch(queries)
    assert got[-1] == [] and ref.find_batch(queries)[-1] == []
    assert got == single.find_batch(queries)
    assert [ids(g) for g in got] == [ids(w) for w in ref.find_batch(queries)]


def test_sharded_sparse_band_activates_and_stays_exact(mesh, jmesh):
    """High-df terms ride a row-sharded dense band; scores and later-first
    rankings stay those of the bandless sharded layout and the unsharded
    index."""
    rng = np.random.default_rng(17)
    items = [
        (["common"] if i % 7 else []) + [f"w{int(x)}" for x in rng.integers(0, 200, size=6)]
        for i in range(500)
    ]
    banded, jbanded, single = sparse_pair(items, mesh, jmesh, 5)
    plain, _, _ = sparse_pair(items, mesh, jmesh, 5, max_band_bytes=0)
    assert all(sh._band is not None for _, _, sh in banded._shards)
    assert all(sh._band is None for _, _, sh in plain._shards)
    assert jbanded._band_sh is not None
    queries = [["common", "w3"], ["common"], ["w7", "w9"], ["zz-oov"]]
    for q in queries:
        np.testing.assert_allclose(banded.get_scores(q), plain.get_scores(q), rtol=1e-6)
        np.testing.assert_allclose(banded.get_scores(q), jbanded.get_scores(q), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(banded.get_scores(q), single.get_scores(q), rtol=1e-6)
        np.testing.assert_array_equal(banded.top_n(q, 5), plain.top_n(q, 5))
        np.testing.assert_array_equal(banded.top_n(q, 5), jbanded.top_n(q, 5))
    for g, w, j in zip(banded.top_n_batch(queries, 5), plain.top_n_batch(queries, 5), jbanded.top_n_batch(queries, 5)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def _assert_hits_identical(a_index, b_index, queries, rtol=1e-5):
    for q in queries:
        ha, da = a_index.find_with_distances(q)
        hb, db = b_index.find_with_distances(q)
        assert ids(hb) == ids(ha)
        np.testing.assert_allclose(np.asarray(db, dtype=np.float32), np.asarray(da, dtype=np.float32),
                                   rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("metric", NON_COSINE)
def test_sharded_two_pass_exactness_random(mesh, jmesh, metric):
    """Sharded two_pass gives the sharded f32 scan's hits: the per-shard
    certificates compose into the global claim."""
    rng = np.random.default_rng(70)
    n, d = 8 * 512 + 300, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    docs = [(np.arange(n), emb)]
    f32 = ShardedDenseIndex(TEXT, [DocEmbeddings(*docs[0])], mesh, metric=metric, limit=7)
    tp, jtp, single_tp = dense_pair(docs, mesh, jmesh, metric=metric, limit=7, storage_dtype="two_pass")
    queries = [(emb[i] + 0.05 * rng.standard_normal(d)).astype(np.float32) for i in range(0, 4000, 512)]
    queries += [rng.standard_normal(d).astype(np.float32) for _ in range(4)]
    _assert_hits_identical(f32, tp, queries)
    _assert_hits_identical(jtp, tp, queries)
    _assert_hits_identical(single_tp, tp, queries[:3])


def test_sharded_two_pass_adversarial_ties(mesh, jmesh):
    """Duplicate and near-tied rows across shard boundaries: a shard's
    certificate fails and every shard falls back, keeping the f32 scan's
    stable order."""
    rng = np.random.default_rng(71)
    d = 32
    base = rng.standard_normal(d).astype(np.float32)
    base /= np.linalg.norm(base)
    dup = np.tile(base, (600, 1))
    near = base + 1e-7 * rng.standard_normal((600, d)).astype(np.float32)
    noise = rng.standard_normal((3000, d)).astype(np.float32)
    emb = np.concatenate([noise[:1500], dup, near, noise[1500:]]).astype(np.float32)
    emb = emb[rng.permutation(emb.shape[0])]
    docs = [(np.arange(emb.shape[0]), emb)]
    f32, jf32, single = dense_pair(docs, mesh, jmesh, limit=7)
    tp = ShardedDenseIndex(TEXT, [DocEmbeddings(*docs[0])], mesh, limit=7, storage_dtype="two_pass")
    queries = [base, (base + 1e-8).astype(np.float32)]
    # a shard's certificate fails on the tied rows: the fallback is taken
    oks = [bool(sh._two_pass_window(*sh._prepare(torch.from_numpy(base)), 7)[0].all()) for _, sh in tp._shards]
    assert not all(oks)
    _assert_hits_identical(f32, tp, queries)
    _assert_hits_identical(single, tp, queries)
    # the JAX package's f32 scan: the same tied set at the same distances
    # (the order among rows whose distances are f32 rounding noise apart is
    # the product's shape's, tests/test_torch_dense_layouts.py)
    for q in queries:
        hp, dp = tp.find_with_distances(q)
        hr, dr = jf32.find_with_distances(q)
        np.testing.assert_allclose(dp, np.asarray(dr, np.float32), rtol=1e-5, atol=1e-6)
        near_set = set(np.nonzero(np.abs(emb - base).max(axis=1) < 1e-6)[0].tolist())
        assert {h.chunk_id for h in hp} <= near_set and {h.chunk_id for h in hr} <= near_set


def test_sharded_two_pass_fast_path_engages(mesh, jmesh):
    """On separated data every shard's certificate holds, in the JAX
    package's kernel and in the port's shards."""
    rng = np.random.default_rng(72)
    n, d = 8 * 8192 + 100, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    docs = [(np.arange(n), emb)]
    tp, jtp, _ = dense_pair(docs, mesh, jmesh, limit=7, storage_dtype="two_pass")
    q = rng.standard_normal(d).astype(np.float32)
    ok, _, _ = jsi._sharded_find_two_pass_kernel(
        jtp._emb, jtp._emb_f32, jnp.asarray(q), jnp.int32(jtp.n_rows), *jtp._err,
        mesh=jtp._mesh, metric=jtp.metric, k=7,
    )
    assert bool(ok)
    flags = [bool(sh._two_pass_window(*sh._prepare(torch.from_numpy(q)), 7)[0].all()) for _, sh in tp._shards]
    assert flags == [True] * 8
    # the error terms every shard certifies with are the JAX package's global
    # ones, to an ulp or so of the unit rows' squared norms (XLA and torch
    # sum a row's squares in orders of their own)
    for _, sh in tp._shards:
        for got, want in zip(sh._err, jtp._err):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    _assert_hits_identical(jtp, tp, [q])


def test_sharded_two_pass_batch_matches_single_queries(mesh, jmesh):
    rng = np.random.default_rng(73)
    n, d = 2200, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    tp, jtp, _ = dense_pair([(np.arange(n), emb)], mesh, jmesh, limit=5, storage_dtype="two_pass")
    queries = rng.standard_normal((6, d)).astype(np.float32)
    batch = tp.find_batch(queries)
    jbatch = jtp.find_batch(queries)
    for qi in range(6):
        assert batch[qi] == tp.find(queries[qi])
        assert ids(batch[qi]) == ids(jbatch[qi])


def test_sharded_two_pass_rejects_cosine(mesh, jmesh):
    with pytest.raises(ValueError, match="two_pass"):
        ShardedDenseIndex(TEXT, [], mesh, metric=Metric.COSINE_SIM, storage_dtype="two_pass")
    with pytest.raises(ValueError, match="two_pass"):
        jsi.ShardedDenseIndex(JTEXT, [], jmesh, metric="cosine_sim", storage_dtype="two_pass")


def test_sharded_int8_matches_single_chip_int8(mesh, jmesh):
    """The sharded int8 scan quantizes as the unsharded layout does and
    merges stably: the same hits as the unsharded int8 index."""
    rng = np.random.default_rng(74)
    n, d = 8 * 512 + 123, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for metric in NON_COSINE:
        port, ref, single = dense_pair([(np.arange(n), emb)], mesh, jmesh, metric=metric, limit=7,
                                       storage_dtype="int8")
        queries = [(emb[i] + 0.05 * rng.standard_normal(d)).astype(np.float32) for i in (0, 1000, 4000)]
        assert_dense_same(port, ref, single, queries, rtol=1e-5)


def test_sharded_int8_tie_break_across_shards(mesh, jmesh):
    n = 3000
    docs = [(np.arange(n), np.ones((n, 16), dtype=np.float32))]
    port, ref, single = dense_pair(docs, mesh, jmesh, limit=5, storage_dtype="int8")
    q = np.ones(16, dtype=np.float32)
    assert [h.chunk_id for h in port.find(q)] == [h.chunk_id for h in ref.find(q)] == [0, 1, 2, 3, 4]
    assert port.find(q) == single.find(q)


def test_sharded_int8_batch_matches_single_queries(mesh, jmesh):
    rng = np.random.default_rng(75)
    n, d = 1500, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    port, ref, _ = dense_pair([(np.arange(n), emb)], mesh, jmesh, limit=5, storage_dtype="int8")
    queries = rng.standard_normal((5, d)).astype(np.float32)
    batch = port.find_batch(queries)
    jbatch = ref.find_batch(queries)
    for qi in range(5):
        assert batch[qi] == port.find(queries[qi])
        assert ids(batch[qi]) == ids(jbatch[qi])


def test_sharded_int8_nbytes_quarter_of_f32(mesh, jmesh):
    rng = np.random.default_rng(76)
    n, d = 4096, 64
    emb = rng.standard_normal((n, d)).astype(np.float32)
    docs = [(np.arange(n), emb)]
    f32 = ShardedDenseIndex(TEXT, [DocEmbeddings(*docs[0])], mesh, limit=3)
    i8, ref, _ = dense_pair(docs, mesh, jmesh, limit=3, storage_dtype="int8")
    # int8 rows and 8 bytes a row of scale and norm
    assert i8.nbytes == f32.nbytes // 4 + n * 8 == ref.nbytes


def test_sharded_maxsim_int8_matches_single_chip_int8(mesh, jmesh):
    rng = np.random.default_rng(77)
    d = 16
    per_doc = []
    for _ in range(3):
        chunks = []
        for _ in range(40):
            rows = rng.standard_normal((int(rng.integers(1, 6)), d)).astype(np.float32)
            chunks.append(rows / np.linalg.norm(rows, axis=1, keepdims=True))
        per_doc.append(chunks)
    port, ref, single = li_trio(per_doc, mesh, jmesh, max_chunk_tokens=8, limit=5, storage_dtype="int8")
    assert all(sh._x.dtype == torch.int8 for _, sh in port._shards)
    queries = [rng.standard_normal((5, d)).astype(np.float32) for _ in range(4)]
    assert_li_same(port, ref, single, queries, rtol=1e-4)


def test_sharded_warm_query_buckets_compile_ahead(mesh, jmesh, monkeypatch):
    """Every sharded index warms its serving shapes (the single-device wave
    buckets, here up to 16) and answers as before after it."""
    from dial_rag_tpu_torch.runtime import micro_batcher

    monkeypatch.setattr(micro_batcher, "MAX_WAVE", 16)
    rng = np.random.default_rng(80)
    emb = rng.standard_normal((900, 16)).astype(np.float32)
    dense = ShardedDenseIndex(TEXT, [DocEmbeddings(np.arange(900), emb)], mesh, limit=5)
    dense.warm_query_buckets()
    jdense = jsi.ShardedDenseIndex(JTEXT, [JaxDocEmbeddings(np.arange(900), emb)], jmesh, limit=5)
    jdense.warm_query_buckets(max_q=16)
    assert dense.find(emb[123])[0].chunk_id == jdense.find(emb[123])[0].chunk_id == 123

    items = [[f"w{i % 40}", "common"] for i in range(300)]
    bm = ShardedBm25Index(Bm25Index.build(items, device="cpu"), mesh, limit=5)
    bm.warm_query_buckets(k=7)  # clamped to the limit
    jbm = jsi.ShardedBm25Index(JaxBm25Index.build(items, device=False), jmesh, limit=5)
    jbm.warm_query_buckets(k=5, max_q=8)
    np.testing.assert_array_equal(bm.top_n(["w3"], 5), jbm.top_n(["w3"], 5))
    assert len(bm.top_n(["w3"], 5)) == 5
    sparse = ShardedBm25SparseIndex(Bm25Index.build(items, max_dense_bytes=0, device="cpu", max_band_bytes=0),
                                    mesh, limit=5)
    sparse.warm_query_buckets(k=5)
    jsparse = jsi.ShardedBm25SparseIndex(JaxBm25Index.build(items, max_dense_bytes=0, device=False), jmesh, limit=5)
    np.testing.assert_array_equal(sparse.top_n(["w3"], 5), jsparse.top_n(["w3"], 5))
    with pytest.raises(ValueError, match="limit"):
        sparse.top_n(["w3"], 6)

    chunks = [rng.standard_normal((3, 16)).astype(np.float32) for _ in range(60)]
    li = ShardedLateInteractionIndex(TEXT, [chunks], mesh, max_chunk_tokens=4, limit=3)
    li.warm_query_buckets()
    jli = jsi.ShardedLateInteractionIndex(JTEXT, [chunks], jmesh, max_chunk_tokens=4, limit=3)
    assert li.find(chunks[7])[0].chunk_id == jli.find(chunks[7])[0].chunk_id == 7
