"""The port's DenseIndex against the JAX package's, on the CPU: the same
documents and queries (numpy, seeded) give the same hits in the same
order, including adversarial ties (duplicate rows across documents: the
earliest row wins) and the bfloat16 layout. Distances agree to f32
rounding: rtol 1e-5, and for euclidean the squared distances to atol
1e-4 (|d|^2 - 2 q.d + |q|^2 at |d|^2 ~ 32 carries a few f32 ulps of
3.8e-6, which the square root magnifies near zero)."""

import numpy as np
import pytest
import torch

from dial_rag_tpu.index.dense_index import DenseIndex as JaxDenseIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.ops.metrics import Metric


def _docs(rng):
    docs = []
    for n in (7, 0, 12, 5):
        docs.append(rng.standard_normal((n, 32)).astype(np.float32) if n else np.zeros((0, 32), np.float32))
    docs[2][3] = docs[0][1]  # a duplicate in a later document: ties
    docs[3][0] = docs[0][1]
    docs[2][4] = docs[2][5]  # a duplicate inside one document
    return docs


def _pair(docs, metric, limit, storage):
    port = DenseIndex(
        RetrievalType.TEXT,
        [DocEmbeddings(np.arange(len(d)) * 10, d) for d in docs],
        metric=metric, limit=limit, storage_dtype=storage, device="cpu",
    )
    ref = JaxDenseIndex(
        JaxRetrievalType.TEXT,
        [JaxDocEmbeddings(np.arange(len(d)) * 10, d) for d in docs],
        metric=metric.value, limit=limit, storage_dtype=storage,
    )
    return port, ref


def _key(hits):
    return [(h.doc_id, h.chunk_id, h.retrieval_type.value) for h in hits]


@pytest.mark.parametrize("metric", list(Metric))
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_dense_index_matches_jax(metric, storage):
    rng = np.random.default_rng(0)
    docs = _docs(rng)
    queries = rng.standard_normal((5, 32)).astype(np.float32)
    queries[0] = docs[0][1]  # exact hit on the tied rows
    port, ref = _pair(docs, metric, 6, storage)
    assert port.n_rows == ref.n_rows == 24
    batch = port.find_batch(queries)
    ref_batch = ref.find_batch(queries)
    for qi, q in enumerate(queries):
        hits, dists = port.find_with_distances(q)
        ref_hits, ref_dists = ref.find_with_distances(q)
        assert _key(hits) == _key(ref_hits)
        if metric == Metric.EUCLIDEAN_DIST:
            np.testing.assert_allclose(np.square(dists), np.square(ref_dists), rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_allclose(dists, ref_dists, rtol=1e-5, atol=1e-5)
        assert _key(batch[qi]) == _key(ref_batch[qi]) == _key(hits)
        assert _key(port.find(q)) == _key(hits)


def test_tied_rows_keep_document_order():
    rng = np.random.default_rng(1)
    docs = _docs(rng)
    port, _ = _pair(docs, Metric.SQEUCLIDEAN_DIST, 3, "float32")
    hits = port.find(docs[0][1])
    assert [(h.doc_id, h.chunk_id) for h in hits] == [(0, 10), (2, 30), (3, 0)]


def test_from_device_matrix_and_empty_index():
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
    idx = DenseIndex.from_device_matrix(RetrievalType.TEXT, emb, limit=4)
    ref = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(50), emb.numpy())], limit=4, device="cpu")
    q = rng.standard_normal(16).astype(np.float32)
    assert _key(idx.find(q)) == _key(ref.find(q))
    assert idx.nbytes == 50 * 16 * 4
    empty = DenseIndex(RetrievalType.TEXT, [], device="cpu")
    assert empty.find(q) == [] and empty.find_batch(np.zeros((2, 16), np.float32)) == [[], []]
    few = DenseIndex(RetrievalType.TEXT, [DocEmbeddings([0, 1], emb.numpy()[:2])], limit=5, device="cpu")
    assert len(few.find(q)) == 2
    with pytest.raises(ValueError, match="storage_dtype"):
        DenseIndex(RetrievalType.TEXT, [], storage_dtype="float16", device="cpu")
