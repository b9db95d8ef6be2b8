"""The port's ``Bm25Index`` against the JAX package's on the CPU.

Every case of tests/test_bm25.py runs through both packages on the same
seeded corpora: the layout taken (dense, band + CSC, CSC), the scores
(rtol 1e-5 / atol 1e-6, the randomized case 1e-4 / 1e-5: that file's own
tolerances) and exactly equal top-n ids, later item first on ties. The
port's batch path must give a query the same bits as its single-query
path. ``bm25_okapi_reference`` is that file's transcription of
rank_bm25's ``BM25Okapi.get_scores``.
"""

import math

import numpy as np
import pytest
import torch

from dial_rag_tpu.index.bm25 import _VSLICE
from dial_rag_tpu.index.bm25 import Bm25Index as JaxBm25Index
from dial_rag_tpu_torch.index.bm25 import B, EPSILON, K1, Q_BLOCK, Bm25Index


def bm25_okapi_reference(corpus, query):
    """Transcription of rank_bm25.BM25Okapi.get_scores."""
    n = len(corpus)
    doc_freqs = []
    nd = {}
    for doc in corpus:
        freqs = {}
        for w in doc:
            freqs[w] = freqs.get(w, 0) + 1
        doc_freqs.append(freqs)
        for w in freqs:
            nd[w] = nd.get(w, 0) + 1
    idf, idf_sum, neg = {}, 0.0, []
    for w, f in nd.items():
        v = math.log(n - f + 0.5) - math.log(f + 0.5)
        idf[w] = v
        idf_sum += v
        if v < 0:
            neg.append(w)
    avg_idf = idf_sum / len(idf)
    for w in neg:
        idf[w] = EPSILON * avg_idf
    dl = np.array([len(d) for d in corpus], dtype=np.float64)
    avgdl = dl.sum() / n
    score = np.zeros(n)
    for q in query:
        q_freq = np.array([df.get(q, 0) for df in doc_freqs], dtype=np.float64)
        score += (idf.get(q) or 0.0) * (q_freq * (K1 + 1) / (q_freq + K1 * (1 - B + B * dl / avgdl)))
    return score


def reverse_stable(scores, k):
    return np.argsort(scores, kind="stable")[::-1][:k]


def jax_layout(index) -> str:
    if index._weights_dev is not None:
        return "dense"
    return "band+csc" if index._band_dev is not None else "csc"


CORPUS = [
    "the alps stretch across eight alpine countries".split(),
    "colle di cadibona marks the boundary of the alps".split(),
    "climate in the alps varies with elevation and latitude".split(),
    "glaciers shaped the alpine valleys over millennia".split(),
    "mont blanc is the highest peak of the alps".split(),
    [],  # empty chunk (image-only page)
    "cadibona cadibona pass".split(),
]
WORDS = ["alps", "climate", "glacier", "peak", "valley", "snow", "river", "pass", "summit", "trail"]


def _randomized():
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(50)]
    items = [list(rng.choice(words, size=rng.integers(1, 30))) for _ in range(64)]
    return items, [list(rng.choice(words, size=4)) for _ in range(5)]


def _postings():
    rng = np.random.default_rng(7)
    items = [list(rng.choice(WORDS, size=int(rng.integers(3, 12)))) for _ in range(57)]
    return items, [["alps"], ["climate", "glacier", "climate"], ["summit", "missing-word"], ["valley", "snow", "river"]]


def _batch_single():
    rng = np.random.default_rng(5)
    items = [[f"w{int(x)}" for x in rng.integers(0, 40, size=10)] for _ in range(500)]
    queries = [[f"w{int(x)}" for x in rng.integers(0, 50, size=4)] for _ in range(9)]
    return items, queries + [["zzz-not-in-vocab"]]


def _band():
    rng = np.random.default_rng(11)
    items = [
        (["common"] if i % 8 else []) + [f"w{int(x)}" for x in rng.integers(0, 300, size=6)]
        for i in range(600)
    ]
    return items, [["common", "w3", "w17"], ["common"], ["w4", "w9"], ["zzz-oov"]]


def _banded_ties():
    rng = np.random.default_rng(23)
    base = [[f"w{int(x)}" for x in rng.integers(0, 120, size=8)] for _ in range(300)]
    # duplicated items: exact score ties whose order is contractual
    items = base + base[:40] + [["common", "w1"]] * 25
    items = [(["common"] if i % 3 else []) + it for i, it in enumerate(items)]
    queries = [["common", "w1", "w1", "w2"], ["common"], ["w1", "w2", "w3", "w4", "w5"],
               ["w117", "w118", "zzz-oov"], ["zzz-oov"]]
    return items, queries


def _long_postings():
    rng = np.random.default_rng(31)
    n = _VSLICE * 2 + 513  # 'common' spans more than two of the reference's virtual slices
    items = [["common"] + [f"w{int(x)}" for x in rng.integers(0, 50, size=3)] for _ in range(n)]
    items[5] += ["common", "common"]
    items[_VSLICE + 7] += ["common"]
    return items, [["common"], ["common", "common", "w3"], ["w7", "common"], ["common", "w1"], ["w2"]]


def _heavy():
    rng = np.random.default_rng(3)
    items = [
        (["heavy"] if i % 2 else []) + [f"w{int(x)}" for x in rng.integers(0, 400, size=5)]
        for i in range(3000)
    ]
    queries = [["heavy", "w1"], ["w2"], ["w3"], ["w4"], ["w5"], ["w1"], ["heavy", "w2"], ["heavy", "w3"]]
    return items, queries


def _weighted():
    rng = np.random.default_rng(11)
    items = [list(rng.choice(WORDS, size=int(rng.integers(3, 12)))) for _ in range(64)]
    queries = [
        ["climate", "glacier", "glacier", "peak", "not-in-vocab"],
        {"climate": 1.0, "glacier": 2.0, "peak": 1.0, "not-in-vocab": 3.0},
        {"climate": 0.25},
        ["climate"],
    ]
    return items, queries


_OKAPI_QUERIES = [["cadibona"], ["alps", "climate"], ["alps", "alps"], ["unknownterm"], ["the"], []]

# name -> (corpus maker, build options, layout it takes, top-n depths, rtol, atol)
CASES = {
    "okapi dense": (lambda: (CORPUS, _OKAPI_QUERIES), {}, "dense", (1, 3, 7, 100), 1e-5, 1e-6),
    "okapi csc": (lambda: (CORPUS, _OKAPI_QUERIES), {"max_dense_bytes": 0}, "csc", (1, 3, 7, 100), 1e-5, 1e-6),
    "randomized": (_randomized, {}, "dense", (7,), 1e-4, 1e-5),
    "postings dense": (_postings, {}, "dense", (7,), 1e-5, 1e-6),
    "postings csc": (_postings, {"max_dense_bytes": 0}, "csc", (7,), 1e-5, 1e-6),
    "batch = single csc": (_batch_single, {"max_dense_bytes": 0}, "band+csc", (5,), 1e-5, 1e-6),
    "band": (_band, {"max_dense_bytes": 0}, "band+csc", (5,), 1e-5, 1e-6),
    "band off": (_band, {"max_dense_bytes": 0, "max_band_bytes": 0}, "csc", (5,), 1e-5, 1e-6),
    "banded ties": (_banded_ties, {"max_dense_bytes": 0}, "band+csc", (5, 12), 1e-5, 1e-6),
    "banded ties dense": (_banded_ties, {}, "dense", (5, 12), 1e-5, 1e-6),
    "long postings": (_long_postings, {"max_dense_bytes": 0, "max_band_bytes": 0}, "csc", (6, 9), 1e-5, 1e-6),
    "heavy tail": (_heavy, {"max_dense_bytes": 0, "max_band_bytes": 0}, "csc", (5,), 1e-5, 1e-6),
    "weighted dense": (_weighted, {}, "dense", (7,), 1e-5, 1e-6),
    "weighted csc": (_weighted, {"max_dense_bytes": 0}, "csc", (7,), 1e-5, 1e-6),
}


@pytest.fixture(scope="module")
def built():
    """name -> (items, queries, JAX index, port index), built once."""
    out = {}
    for name, (make, kw, *_rest) in CASES.items():
        items, queries = make()
        out[name] = (items, queries, JaxBm25Index.build(items, **kw), Bm25Index.build(items, device="cpu", **kw))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_matches_jax(built, name):
    _, _, jax_index, port = built[name]
    assert port.layout == jax_layout(jax_index) == CASES[name][2]
    assert port.n_items == jax_index.n_items and port.vocab == jax_index.vocab
    np.testing.assert_array_equal(port.idf, jax_index.idf)
    if port.layout == "band+csc":
        assert port._band_cols == jax_index._band_cols
    if port.layout != "dense":
        np.testing.assert_array_equal(port._postings[0], jax_index._postings[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_scores_match_jax(built, name):
    items, queries, jax_index, port = built[name]
    rtol, atol = CASES[name][4:]
    got = port.get_scores_batch(queries)
    for q, row in zip(queries, got):
        np.testing.assert_allclose(row, jax_index.get_scores(q), rtol=rtol, atol=atol)
        if isinstance(q, list):
            np.testing.assert_allclose(row, bm25_okapi_reference(items, q), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_top_n_matches_jax(built, name):
    """Exactly the JAX package's ids, and the reference's reverse-stable
    order of its host scores; scores within the case's tolerance."""
    items, queries, jax_index, port = built[name]
    rtol, atol = CASES[name][4:]
    for k in CASES[name][3]:
        for q in queries:
            idx, vals = port.top_n_with_scores(q, k)
            jax_idx, jax_vals = jax_index.top_n_with_scores(q, k)
            np.testing.assert_array_equal(idx, jax_idx)
            np.testing.assert_allclose(vals, jax_vals, rtol=rtol, atol=atol)
            if isinstance(q, list):
                np.testing.assert_array_equal(idx, reverse_stable(bm25_okapi_reference(items, q), k))
        for q, got in zip(queries, port.top_n_batch(queries, k)):
            np.testing.assert_array_equal(got, jax_index.top_n(q, k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_equals_single_bitwise(built, name):
    _, queries, _, port = built[name]
    for k in CASES[name][3]:
        for q, (bi, bv) in zip(queries, port.top_n_batch_with_scores(queries, k)):
            si, sv = port.top_n_with_scores(q, k)
            np.testing.assert_array_equal(bi, si)
            np.testing.assert_array_equal(bv, sv)
        for q, row in zip(queries, port.get_scores_batch(queries)):
            np.testing.assert_array_equal(row, port.get_scores(q))


@pytest.mark.parametrize("layout", [{}, {"max_dense_bytes": 0}])
def test_batch_past_one_block_equals_single(layout):
    """More queries than one product's columns: the second block gives
    each query the same bits as its single-query path."""
    items, _ = _batch_single()
    rng = np.random.default_rng(9)
    queries = [[f"w{int(x)}" for x in rng.integers(0, 45, size=3)] for _ in range(Q_BLOCK + 9)]
    port = Bm25Index.build(items, device="cpu", **layout)
    jax_index = JaxBm25Index.build(items, **layout)
    batch = port.top_n_batch_with_scores(queries, 7)
    assert len(batch) == len(queries)
    for q, (bi, bv) in zip(queries, batch):
        si, sv = port.top_n_with_scores(q, 7)
        np.testing.assert_array_equal(bi, si)
        np.testing.assert_array_equal(bv, sv)
        np.testing.assert_array_equal(bi, jax_index.top_n(q, 7))


def test_weighted_mapping_ranks_like_counted_list():
    items, _ = _weighted()
    dense = Bm25Index.build(items, device="cpu")
    sparse = Bm25Index.build(items, device="cpu", max_dense_bytes=0)
    as_list = ["climate", "glacier", "glacier", "peak", "not-in-vocab"]
    as_map = {"climate": 1.0, "glacier": 2.0, "peak": 1.0, "not-in-vocab": 3.0}
    for index in (dense, sparse):
        np.testing.assert_allclose(index.get_scores(as_map), index.get_scores(as_list), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(index.top_n(as_map, 7), dense.top_n(as_list, 7))
    np.testing.assert_allclose(
        dense.get_scores({"climate": 0.25}), 0.25 * dense.get_scores(["climate"]), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("layout", [{}, {"max_dense_bytes": 0}])
def test_published_okapi_goldens(layout):
    """The published formula's scores, frozen (tests/test_bm25.py): 'the'
    takes the epsilon floor of idf."""
    items = [
        "the alps are high".split(),
        "the climate varies with elevation".split(),
        "glaciers shaped the valleys".split(),
        "cadibona marks the boundary".split(),
    ]
    goldens = {
        ("alps",): [0.87033617, 0.0, 0.0, 0.0],
        ("the", "climate"): [0.16173933, 0.93083649, 0.16173933, 0.16173933],
        ("cadibona", "boundary"): [0.0, 0.0, 0.0, 1.74067234],
    }
    index = Bm25Index.build(items, device="cpu", **layout)
    for query, expected in goldens.items():
        np.testing.assert_allclose(
            index.get_scores(list(query)), np.asarray(expected, dtype=np.float32), rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("items", [[[], []], []])
def test_empty_corpus_raises(items):
    with pytest.raises(ValueError):
        Bm25Index.build(items, device="cpu")
    with pytest.raises(ValueError):
        JaxBm25Index.build(items)


@pytest.mark.parametrize("constructor", ["from_term_weights", "from_term_weight_arrays"])
def test_empty_term_weights_raise(constructor):
    with pytest.raises(ValueError):
        if constructor == "from_term_weights":
            Bm25Index.from_term_weights({}, np.zeros(0), [{}, {}], device="cpu")
        else:
            empty = np.zeros(0)
            Bm25Index.from_term_weight_arrays({}, np.zeros(0), empty, empty, empty, 2, device="cpu")


def _coo(seed, n, v, per_item, heavy_every=0):
    rng = np.random.default_rng(seed)
    items, terms = [], []
    for i in range(n):
        t = rng.choice(v, size=per_item, replace=False)
        if heavy_every and i % heavy_every:
            t = np.union1d(t, [0])  # term 0 in most items: a band column
        items.extend([i] * len(t))
        terms.extend(t.tolist())
    weights = rng.uniform(0.1, 2.0, size=len(items)).astype(np.float32)
    return np.array(items), np.array(terms), weights


@pytest.mark.parametrize(
    "seed,n,v,per_item,heavy_every,layout,expect",
    [
        (0, 40, 30, 5, 0, {}, "dense"),
        (1, 700, 200, 6, 3, {"max_dense_bytes": 0}, "band+csc"),
        (2, 700, 200, 6, 3, {"max_dense_bytes": 0, "max_band_bytes": 0}, "csc"),
    ],
)
def test_term_weight_arrays_match_jax(seed, n, v, per_item, heavy_every, layout, expect):
    """``from_term_weight_arrays`` and ``from_term_weights`` (the same
    weights as dicts) against the JAX package's, and against a host
    scoring of the COO weights."""
    items, terms, weights = _coo(seed, n, v, per_item, heavy_every)
    vocab = {f"t{i}": i for i in range(v)}
    idf = np.ones(v)
    port = Bm25Index.from_term_weight_arrays(vocab, idf, items, terms, weights, n, device="cpu", **layout)
    jax_index = JaxBm25Index.from_term_weight_arrays(vocab, idf, items, terms, weights, n, **layout)
    rows = [{} for _ in range(n)]
    for i, t, w in zip(items, terms, weights):
        rows[i][int(t)] = float(w)
    port_rows = Bm25Index.from_term_weights(vocab, idf, rows, device="cpu", **layout)
    assert port.layout == port_rows.layout == jax_layout(jax_index) == expect
    rng = np.random.default_rng(seed + 100)
    queries = [[f"t{int(x)}" for x in rng.integers(0, v, size=4)] for _ in range(6)]
    queries.append({"t0": 2.0, "t1": 0.5})
    dense = np.zeros((n, v))
    dense[items, terms] = weights
    for q in queries:
        qv = np.zeros(v)
        for t, w in (q.items() if isinstance(q, dict) else ((t, 1.0) for t in q)):
            qv[vocab[t]] += w
        host = dense @ qv
        for index in (port, port_rows):
            np.testing.assert_allclose(index.get_scores(q), host, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(index.top_n(q, 7), jax_index.top_n(q, 7))
        np.testing.assert_array_equal(port.get_scores(q), port_rows.get_scores(q))


def test_ties_rank_latest_first():
    """A group of identical items ranks latest first on every layout."""
    items = [["a", "b"], ["x"], ["a", "b"], ["y"], ["a", "b"], ["z"], ["a", "b"]]
    for layout in ({}, {"max_dense_bytes": 0}):
        index = Bm25Index.build(items, device="cpu", **layout)
        np.testing.assert_array_equal(index.top_n(["a"], 4), [6, 4, 2, 0])
        np.testing.assert_array_equal(index.top_n(["nothing"], 3), [6, 5, 4])


def test_scores_are_f32_on_the_index_device():
    index = Bm25Index.build(CORPUS, device="cpu")
    assert index.device == torch.device("cpu")
    assert index.get_scores(["alps"]).dtype == np.float32
    assert index.nbytes == len(CORPUS) * len(index.vocab) * 4
