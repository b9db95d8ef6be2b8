"""The port's late-interaction (MaxSim) index, token encode and retriever
against the JAX package's on the CPU (numpy-seeded inputs):

- MaxSim scores against the JAX ``LateInteractionIndex`` in float32 and
  bfloat16 (rtol 1e-5, atol 1e-5) and int8 (rtol 1e-6), the same hits;
  the int8 rows and scales bit for bit;
- rows with no token never surface, chunks truncate to
  ``max_chunk_tokens``, malformed and wrong-width queries give no hits, a
  query past ``_MAX_Q_LANES`` tokens is cut to it, the overlapped last
  block at 700 rows (not a multiple of 512) scores as the JAX function
  does, batches split into lane-bounded groups, batch equal to single
  (int8: the same scores bit for bit);
- the token encode of ``checkpoints/alps-maxsim`` in f32 against the JAX
  ``embed_documents_tokens`` (2e-5, the reference's f32 gate), and
  ``embed_query_tokens_device``'s rows equal to the host rows bit for bit;
- ``LateInteractionRetriever`` against the JAX retriever: ``retrieve``,
  ``retrieve_batch`` and ``aretrieve``, ``mesh`` (8 CPU slots) serving
  the same hits, and ``device_cache`` hit on a second build.
"""

import asyncio
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.documents.model import FORMAT_VERSION as JAX_FORMAT_VERSION
from dial_rag_tpu.documents.model import DocumentRecord as JaxRecord
from dial_rag_tpu.documents.model import IndexSettings as JaxIndexSettings
from dial_rag_tpu.documents.model import build_chunks_list as jax_chunks_list
from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.index import late_interaction as jli
from dial_rag_tpu.index.late_interaction import LateInteractionIndex as JaxLateInteractionIndex
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.retrieval.late_interaction import LateInteractionRetriever as JaxLateInteractionRetriever
from dial_rag_tpu_torch.documents.model import DocumentRecord, IndexSettings, build_chunks_list
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index import late_interaction as li
from dial_rag_tpu_torch.index.late_interaction import _MAX_Q_LANES, LateInteractionIndex
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.retrieval import LateInteractionRetriever

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "alps-maxsim"
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-5), "int8": (1e-6, 1e-5)}


def ragged(rng, n, d=16, t_max=9, t_min=1):
    return [rng.standard_normal((int(rng.integers(t_min, t_max)), d)).astype(np.float32) for _ in range(n)]


def pair(docs, t=16, limit=5, storage="float32"):
    port = LateInteractionIndex(RetrievalType.TEXT, docs, max_chunk_tokens=t, limit=limit,
                                storage_dtype=storage, device="cpu")
    ref = JaxLateInteractionIndex(JaxRetrievalType.TEXT, docs, max_chunk_tokens=t, limit=limit,
                                  storage_dtype=storage)
    return port, ref


def ids(hits):
    return [(h.doc_id, h.chunk_id) for h in hits]


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_maxsim_matches_jax(storage):
    rng = np.random.default_rng(0)
    docs = [ragged(rng, 40, t_min=0), ragged(rng, 600, t_min=0), ragged(rng, 3)]
    port, ref = pair(docs, t=6, limit=7, storage=storage)
    assert port.nbytes == ref.nbytes and port._x.shape == ref._x.shape
    if storage == "int8":
        assert np.array_equal(port._x.numpy(), np.asarray(ref._x))
        assert np.array_equal(port._x_scales.numpy(), np.asarray(ref._x_scales))
    rtol, atol = TOL[storage]
    queries = [rng.standard_normal((int(rng.integers(1, 12)), 16)).astype(np.float32) for _ in range(9)]
    batch, ref_batch = port.find_batch(queries), ref.find_batch(queries)
    for q, hits, ref_hits in zip(queries, batch, ref_batch):
        h, s = port.find_with_scores(q)
        rh, rs = ref.find_with_scores(q)
        assert ids(h) == ids(rh) == ids(hits) == ids(ref_hits)
        np.testing.assert_allclose(s, rs, rtol=rtol, atol=atol)
        if storage == "int8":  # a query's lanes sum the same way alone and in a batch
            assert [x.score for x in hits] == [x.score for x in h]


def test_zero_token_chunks_truncation_and_malformed_queries():
    rng = np.random.default_rng(1)
    long_chunk = rng.standard_normal((30, 8)).astype(np.float32)
    chunks = [np.ones((2, 8), np.float32), np.zeros((0, 8), np.float32), long_chunk, np.ones((1, 8), np.float32) * 0.5]
    for storage in ("float32", "int8"):
        port, ref = pair([chunks], t=4, limit=4, storage=storage)
        hits = port.find(np.ones((2, 8), np.float32))
        assert 1 not in [h.chunk_id for h in hits] and ids(hits) == ids(ref.find(np.ones((2, 8), np.float32)))
        assert int(port._counts[2]) == 4  # truncated to max_chunk_tokens
        q = rng.standard_normal((3, 8)).astype(np.float32)
        np.testing.assert_allclose(port.find_with_scores(q)[1], ref.find_with_scores(q)[1], rtol=1e-5, atol=1e-5)
    assert port.find(rng.standard_normal((3, 5)).astype(np.float32)) == []  # another width
    assert port.find(np.zeros((0, 8), np.float32)) == [] and port.find(np.ones(8, np.float32)) == []
    out = port.find_batch([np.ones((2, 8), np.float32), np.ones((2, 5), np.float32), np.zeros(3, np.float32)])
    assert out[1] == [] and out[2] == [] and out[0] == port.find(np.ones((2, 8), np.float32))
    empty = LateInteractionIndex(RetrievalType.TEXT, [[np.zeros((0, 8), np.float32)]], device="cpu")
    assert empty.nbytes == 0 and empty.find(np.ones((1, 8), np.float32)) == [] and empty.find_batch([]) == []


def test_lane_cap_and_grouped_batches():
    rng = np.random.default_rng(2)
    chunks = ragged(rng, 30)
    port, ref = pair([chunks], limit=4)
    long_q = rng.standard_normal((_MAX_Q_LANES + 37, 16)).astype(np.float32)
    h_long, s_long = port.find_with_scores(long_q)
    h_cap, s_cap = port.find_with_scores(long_q[:_MAX_Q_LANES])
    assert ids(h_long) == ids(h_cap) == ids(ref.find(long_q)) and s_long == s_cap
    # 40 tokens -> lane bucket 64; 9 queries -> 16 padded; groups of 2
    queries = [rng.standard_normal((40, 16)).astype(np.float32) for _ in range(9)]
    calls = []
    orig = port._find
    port._find = lambda *a: calls.append(a[0].shape) or orig(*a)
    batch = port.find_batch(queries)
    assert calls and all(s[0] * s[1] <= _MAX_Q_LANES for s in calls)
    for q, hits in zip(queries, batch):
        assert ids(hits) == ids(port.find(q)) == ids(ref.find(q))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_overlapped_last_block_matches_jax(storage):
    """700 rows: blocks start at 0 and at 700 - 512, as the JAX function's."""
    rng = np.random.default_rng(21)
    n, t, d = 700, 3, 8
    x = rng.standard_normal((n, t, d)).astype(np.float32)
    counts = rng.integers(0, t + 1, size=n).astype(np.int32)
    q_tok = rng.standard_normal((2, 8, d)).astype(np.float32)
    q_counts = np.array([5, 8], dtype=np.int32)
    scales = None
    if storage == "int8":
        absmax = np.max(np.abs(x), axis=2)
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        x = np.rint(x / scales[:, :, None]).astype(np.int8)
    got = li._maxsim_scores(torch.from_numpy(x), torch.from_numpy(counts), torch.from_numpy(q_tok),
                            torch.from_numpy(q_counts), None if scales is None else torch.from_numpy(scales)).numpy()
    want = np.asarray(jli._maxsim_scores_batch(jnp.asarray(x), jnp.asarray(counts), jnp.asarray(q_tok),
                                               jnp.asarray(q_counts), None if scales is None else jnp.asarray(scales)))
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got)) and (~finite).sum() == 2 * (counts == 0).sum()
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def maxsim_embedders():
    jax_emb = JaxEmbedder.from_hf_checkpoint(str(CKPT), compute_dtype=jnp.float32)
    port = BgeEmbedder.from_hf_checkpoint(str(CKPT), compute_dtype=torch.float32, device="cpu")
    return jax_emb, port


TEXTS = [
    "The Alps are the highest mountain range lying entirely in Europe.",
    "Glaciers carved deep valleys into the limestone.",
    "The Rhine and the Rhone rise in the Alps.",
    "Mont Blanc is the highest peak.",
]
QUERIES = ["highest mountains in europe", "rivers of the alps", "glacier valleys"]


def test_token_encode_matches_jax(maxsim_embedders):
    jax_emb, port = maxsim_embedders
    got = port.embed_documents_tokens(TEXTS, max_tokens=12)
    want = jax_emb.embed_documents_tokens(TEXTS, max_tokens=12)
    assert [g.shape for g in got] == [w.shape for w in want] and got[0].shape[0] == 12
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5)
        np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-5)
    q = port.embed_query_tokens(QUERIES[0])
    np.testing.assert_allclose(q, jax_emb.embed_query_tokens(QUERIES[0]), atol=2e-5)


def test_device_query_rows_equal_host_rows(maxsim_embedders):
    _, port = maxsim_embedders
    for text in QUERIES + ["a " * 80]:
        dev = port.embed_query_tokens_device(text)
        host = port.embed_query_tokens(text)
        t = host.shape[0]
        assert dev.shape[0] == li._bucket_q(min(t, _MAX_Q_LANES)) and dev.shape[0] >= t
        assert np.array_equal(dev.numpy()[:t], host) and not dev.numpy()[t:].any()


def test_retriever_matches_jax(maxsim_embedders):
    jax_emb, port = maxsim_embedders
    jax_records, records = [], []
    for texts in (TEXTS[:2], TEXTS[2:]):
        jchunks = jax_chunks_list([(t, {}) for t in texts])
        jax_records.append(JaxRecord(
            format_version=JAX_FORMAT_VERSION, index_settings=JaxIndexSettings(), chunks=jchunks, text_index=None,
            embeddings_index=None, multimodal_embeddings_index=None, description_embeddings_index=None,
            mime_type="text/plain", document_bytes=b"",
            late_interaction_index=asyncio.run(JaxLateInteractionRetriever.build_index(jax_emb, jchunks, 32))))
        chunks = build_chunks_list([(t, {}) for t in texts])
        records.append(DocumentRecord(
            format_version=None, index_settings=IndexSettings(), chunks=chunks, text_index=None,
            embeddings_index=None, multimodal_embeddings_index=None, description_embeddings_index=None,
            mime_type="text/plain", document_bytes=b"",
            late_interaction_index=asyncio.run(LateInteractionRetriever.build_index(port, chunks, 32))))
    assert LateInteractionRetriever.has_index(records) and not LateInteractionRetriever.has_index(
        [DocumentRecord(None, IndexSettings(), [], None, None, None, None, "text/plain", b"")])
    r = LateInteractionRetriever.from_doc_records(port, records, k=3, max_chunk_tokens=32)
    ref = JaxLateInteractionRetriever.from_doc_records(jax_emb, jax_records, k=3, max_chunk_tokens=32)
    batch = r.retrieve_batch(QUERIES)
    for q, hits in zip(QUERIES, batch):
        single = r.retrieve(q)
        want = ref.retrieve(q)
        assert ids(single) == ids(want) == ids(hits) == ids(asyncio.run(r.aretrieve(q)))
        np.testing.assert_allclose([h.score for h in single], [h.score for h in want], rtol=1e-5)
    from dial_rag_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from dial_rag_tpu_torch.parallel.mesh import create_mesh

    sharded = LateInteractionRetriever.from_doc_records(port, records, k=3, max_chunk_tokens=32,
                                                        mesh=create_mesh(devices=["cpu"] * 8))
    jsharded = JaxLateInteractionRetriever.from_doc_records(jax_emb, jax_records, k=3, max_chunk_tokens=32,
                                                            mesh=jax_create_mesh(8))
    assert type(sharded.index).__name__ == "ShardedLateInteractionIndex"
    for q in QUERIES:
        assert sharded.retrieve(q) == r.retrieve(q)
        assert ids(sharded.retrieve(q)) == ids(jsharded.retrieve(q))
        assert ids(asyncio.run(sharded.aretrieve(q))) == ids(r.retrieve(q))


def test_retriever_device_cache_hit_on_second_build(maxsim_embedders):
    """``device_cache``: the second build over the same content tokens is a
    hit and serves the same hits."""
    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache

    _, port = maxsim_embedders
    records = []
    for i, texts in enumerate((TEXTS[:2], TEXTS[2:])):
        chunks = build_chunks_list([(t, {}) for t in texts])
        records.append(DocumentRecord(
            format_version=None, index_settings=IndexSettings(), chunks=chunks, text_index=None,
            embeddings_index=None, multimodal_embeddings_index=None, description_embeddings_index=None,
            mime_type="text/plain", document_bytes=b"",
            late_interaction_index=asyncio.run(LateInteractionRetriever.build_index(port, chunks, 32)), cache_token=("doc", i)))
    cache = DeviceIndexCache()
    first = LateInteractionRetriever.from_doc_records(port, records, k=3, max_chunk_tokens=32, device_cache=cache)
    second = LateInteractionRetriever.from_doc_records(port, records, k=3, max_chunk_tokens=32, device_cache=cache)
    assert second.index is first.index and (cache.misses, cache.hits) == (1, 1)
    assert cache.wait_warm(60)
    plain = LateInteractionRetriever.from_doc_records(port, records, k=3, max_chunk_tokens=32)
    for q in QUERIES:
        assert [h.key for h in second.retrieve(q)] == [h.key for h in plain.retrieve(q)]
