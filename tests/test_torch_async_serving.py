"""Concurrent serving in the port against its lone paths and the JAX
package, on the CPU:

- ``DenseIndex.afind`` under ``asyncio.gather`` (every layout): the hits
  of ``find`` and of the JAX ``find``, in waves of more than one query (as
  tests/test_batch_find.py's coalescing case); a wave whose queries are the
  rows of one encode output scans it in place with no ``torch.stack`` (the
  embedder's waves too), a scrambled or mixed wave stacks once, a lone
  query keeps ``find``;
- ``Bm25Index.atop_n_with_scores`` and ``ChargramIndex.atop_n_with_scores``
  under ``gather`` with several n in one wave: the ids and scores of
  ``top_n_with_scores`` bit for bit, and the JAX package's (rtol 1e-6);
- ``LateInteractionIndex.afind`` (tests/test_late_interaction.py's case):
  device queries at one lane bucket share one scan with the scores of
  ``find`` bit for bit, a host query keeps ``find``; the JAX hits;
- the four retrievers built through one ``DeviceIndexCache`` and their
  coalesced ``aretrieve``, and the RRF ``EnsembleRetriever.aretrieve`` of
  the four, equal to the JAX ensemble's on the two frozen goldens
  (tests/test_eval_harness.py::test_frozen_retrieval_goldens), the
  seeded encoder's weights carried over.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dial_rag_tpu.index.bm25 import Bm25Index as JaxBm25Index
from dial_rag_tpu.index.chargram import ChargramIndex as JaxChargramIndex
from dial_rag_tpu.index.dense_index import DenseIndex as JaxDenseIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.late_interaction import LateInteractionIndex as JaxLateInteractionIndex
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.retrieval import Bm25Retriever as JaxBm25Retriever
from dial_rag_tpu.retrieval import ChargramRetriever as JaxChargramRetriever
from dial_rag_tpu.retrieval import EnsembleRetriever as JaxEnsembleRetriever
from dial_rag_tpu.retrieval import LateInteractionRetriever as JaxLateInteractionRetriever
from dial_rag_tpu.retrieval import SemanticRetriever as JaxSemanticRetriever
from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord, IndexSettings
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.index.chargram import ChargramIndex
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.retrieval import (
    Bm25Retriever,
    ChargramRetriever,
    EnsembleRetriever,
    LateInteractionRetriever,
    SemanticRetriever,
)
from dial_rag_tpu_torch.runtime import micro_batcher as mb
from dial_rag_tpu_torch.weights import params_from_jax_numpy
from eval.corpus import build_corpus
from eval.eval_retriever import build_record, make_test_embedder

TIMEOUT = 120.0  # every gather below is bounded


def gather(*aws):
    async def run():
        return await asyncio.wait_for(asyncio.gather(*aws), timeout=TIMEOUT)

    return asyncio.run(run())


def pairs(hits) -> list[tuple[int, int]]:
    return [(h.doc_id, h.chunk_id) for h in hits]


def spy(index, name: str, waves: list):
    orig = getattr(index, name)

    def wave(items):
        waves.append(len(items))
        return orig(items)

    setattr(index, name, wave)


# --- the dense index --------------------------------------------------------


def dense_docs(seed: int):
    rng = np.random.default_rng(seed)
    return rng, [(np.arange(n), rng.standard_normal((n, 8)).astype(np.float32)) for n in (23, 41)]


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "two_pass", "int8"])
def test_dense_afind_coalesces_and_matches_find(storage):
    rng, docs = dense_docs(7)
    index = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(c, e) for c, e in docs], limit=5, storage_dtype=storage,
                       device="cpu")
    ref = JaxDenseIndex(JaxRetrievalType.TEXT, [JaxDocEmbeddings(c, e) for c, e in docs], limit=5,
                        storage_dtype=storage)
    waves: list[int] = []
    spy(index, "_scan_wave", waves)
    queries = rng.standard_normal((11, 8)).astype(np.float32)
    results = gather(*(index.afind(q) for q in queries))
    for q, hits in zip(queries, results):
        assert hits == index.find(q)
        assert pairs(hits) == pairs(ref.find(q))
    assert sum(waves) == len(queries) and max(waves) > 1, waves


def test_dense_wave_of_one_output_copies_no_row(monkeypatch):
    """The rows of one wave output, in order, as ``wave_rows`` tags them,
    are scanned in place (no ``torch.stack``), at most the wave bucket's
    rows of it; untagged rows (of a matrix that fills its storage too),
    scrambled rows and rows of two outputs stack once; every wave gives
    ``find``'s hits."""
    rng, docs = dense_docs(11)
    index = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(c, e) for c, e in docs], limit=5, device="cpu")
    with torch.inference_mode():  # as an encode's output
        parent = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)) * 1.0
        other = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)) * 1.0
    tagged, tagged_other = mb.wave_rows(parent, 64), mb.wave_rows(other, 8)
    stacks, scanned = [], []
    real_stack, real_find_batch = torch.stack, index.find_batch

    def counting_stack(*a, **kw):
        stacks.append(len(a[0]))
        return real_stack(*a, **kw)

    monkeypatch.setattr(torch, "stack", counting_stack)
    monkeypatch.setattr(index, "find_batch",
                        lambda q, n_real=None: scanned.append(q.shape[0]) or real_find_batch(q, n_real))
    in_place = index._scan_wave(tagged[:5])
    assert stacks == [] and scanned == [8]  # the wave bucket of 5, of the 64-row output
    untagged = index._scan_wave([parent[i] for i in range(5)])
    scrambled = index._scan_wave([tagged[i] for i in (3, 0, 4)])
    mixed = index._scan_wave([tagged[1], tagged_other[2]])
    assert stacks == [8, 8, 8]  # one stack each, padded to the wave bucket
    lone = index._scan_wave([tagged[6]])
    monkeypatch.undo()
    for i, (hits, plain) in enumerate(zip(in_place, untagged)):
        assert hits == plain == index.find(parent[i].numpy())
    for i, hits in zip((3, 0, 4), scrambled):
        assert hits == index.find(parent[i].numpy())
    assert mixed == [index.find(parent[1].numpy()), index.find(other[2].numpy())]
    assert lone == [index.find(parent[6].numpy())]


def test_embedder_wave_feeds_the_scan_in_place(monkeypatch):
    """``aembed_query`` rows of one wave reach ``afind`` as one wave and are
    scanned in place: the semantic arm's coalesced path stacks nothing."""
    emb = BgeEmbedder.from_random(device="cpu", batch_size=16)
    texts = ["abc", "def ghi", "jkl", "mno pqr stu", "vwx"]
    doc = emb.embed_documents(texts)
    index = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(len(texts)), doc)], limit=3, device="cpu")
    real_stack = torch.stack
    monkeypatch.setattr(torch, "stack", lambda *a, **kw: pytest.fail("a coalesced wave stacked its rows"))
    mb.reset_counts()

    async def request(q):
        return await index.afind(await emb.aembed_query(q))

    got = gather(*(request(q) for q in texts))
    monkeypatch.setattr(torch, "stack", real_stack)
    assert mb.WAVES == {"query_encode": 1, "dense_scan": 1} and mb.ITEMS["dense_scan"] == len(texts)
    for q, hits in zip(texts, got):
        assert hits == index.find(emb.embed_query(q))


# --- BM25 and chargram --------------------------------------------------------


def test_bm25_atop_coalesces_with_several_n():
    rng = np.random.default_rng(3)
    items = [[f"w{int(t)}" for t in rng.integers(0, 40, size=int(rng.integers(1, 12)))] for _ in range(120)]
    index, ref = Bm25Index.build(items, device="cpu"), JaxBm25Index.build(items)
    queries = [[f"w{int(t)}" for t in rng.integers(0, 45, size=3)] for _ in range(9)] + [[], ["zzz"]]
    ns = [1, 3, 5, 7, 200][: len(queries)] * 3
    waves: list[int] = []
    spy(index, "_scan_wave", waves)
    results = gather(*(index.atop_n_with_scores(q, n) for q, n in zip(queries, ns)))
    for q, n, (idx, vals) in zip(queries, ns, results):
        want_idx, want_vals = index.top_n_with_scores(q, n)
        assert np.array_equal(idx, want_idx) and np.array_equal(vals, want_vals)
        ref_idx, ref_vals = ref.top_n_with_scores(q, n)
        assert np.array_equal(idx, ref_idx)
        np.testing.assert_allclose(vals, ref_vals, rtol=1e-6)
    assert sum(waves) == len(queries) and max(waves) > 1, waves


def test_chargram_atop_coalesces():
    words = [["glacier", "valleys"], ["mountainous", "climate"], ["highest", "peak", "europe"], ["glaciers"],
             ["valley", "climbing"], ["peaks", "alpine"]]
    index, ref = ChargramIndex.build(words, device="cpu"), JaxChargramIndex.build(words)
    queries = ["glacier valley", "mountain climates", "peak", "zzz", "alpine peaks europe"]
    results = gather(*(index.atop_n_with_scores(q, 4) for q in queries))
    for q, (idx, vals) in zip(queries, results):
        want_idx, want_vals = index.top_n_with_scores(q, 4)
        assert np.array_equal(idx, want_idx) and np.array_equal(vals, want_vals)
        ref_idx, ref_vals = ref.top_n_with_scores(q, 4)
        assert np.array_equal(idx, ref_idx)
        np.testing.assert_allclose(vals, ref_vals, rtol=1e-5, atol=1e-6)


# --- late interaction -----------------------------------------------------------


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_late_interaction_afind_coalesces_same_bucket_queries(storage):
    rng = np.random.default_rng(11)
    chunks = [rng.standard_normal((int(rng.integers(1, 9)), 16)).astype(np.float32) for _ in range(29)]
    index = LateInteractionIndex(RetrievalType.TEXT, [chunks], max_chunk_tokens=16, limit=5, storage_dtype=storage,
                                 device="cpu")
    ref = JaxLateInteractionIndex(JaxRetrievalType.TEXT, [chunks], max_chunk_tokens=16, limit=5,
                                  storage_dtype=storage)
    dev_queries = []
    for _ in range(6):  # rows at lane bucket 8, zero past the query's tokens, as the embedder makes them
        q = np.zeros((8, 16), dtype=np.float32)
        t = int(rng.integers(2, 8))
        q[:t] = rng.standard_normal((t, 16)).astype(np.float32)
        dev_queries.append(torch.from_numpy(q))
    host_q = rng.standard_normal((3, 16)).astype(np.float32)
    waves: list[int] = []
    spy(index, "_scan_wave", waves)
    results = gather(*(index.afind(q) for q in dev_queries), index.afind(host_q))
    for q, hits in zip(dev_queries, results[:-1]):
        alone = index.find(q)
        # the coalesced scan's scores are find's, bit for bit
        assert hits == alone and [h.score for h in hits] == [h.score for h in alone]
        assert pairs(hits) == pairs(ref.find(q.numpy()))
    assert results[-1] == index.find(host_q) and pairs(results[-1]) == pairs(ref.find(host_q))
    assert sum(waves) == 7 and max(waves) > 1, waves


# --- the four retrievers and the RRF ensemble on the goldens -----------------------


@pytest.fixture(scope="module")
def harness():
    """tests/test_eval_harness.py's seeded corpus, the JAX record (with
    the chargram words added) and encoder, and the port's record over the
    same chunks with a cache token, its encoder carrying the JAX weights."""
    corpus = build_corpus(n_pages=5, seed=0)
    jax_emb = make_test_embedder(corpus)
    record, _ = asyncio.run(build_record(corpus, jax_emb))
    record = dataclasses.replace(record, chargram_index=asyncio.run(JaxChargramRetriever.build_index(record.chunks)))
    emb = BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=jax_emb.tokenizer.vocab),
        encoder=BertEncoder(BertConfig.tiny()),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_emb.params)),
        device="cpu",
        batch_size=jax_emb.batch_size,
    )
    chunks = [Chunk(text=c.text, metadata=dict(c.metadata)) for c in record.chunks]
    port = DocumentRecord(
        format_version=record.format_version, index_settings=IndexSettings(), chunks=chunks,
        text_index=record.text_index, embeddings_index=asyncio.run(SemanticRetriever.build_index(emb, chunks)),
        multimodal_embeddings_index=None, description_embeddings_index=None, mime_type="text/plain",
        document_bytes=b"", late_interaction_index=asyncio.run(LateInteractionRetriever.build_index(emb, chunks)),
        chargram_index=asyncio.run(ChargramRetriever.build_index(chunks)), cache_token=("atlas.pdf", "seed-0"),
    )
    return corpus, jax_emb, record, emb, port


def port_arms(emb, port, cache):
    return [
        SemanticRetriever.from_doc_records(emb, [port], k=7, device_cache=cache),
        LateInteractionRetriever.from_doc_records(emb, [port], k=7, device_cache=cache),
        Bm25Retriever.from_doc_records([port], k=7, device="cpu", device_cache=cache),
        ChargramRetriever.from_doc_records([port], k=7, device="cpu", device_cache=cache),
    ]


GOLDENS = [0, 3]  # tests/test_eval_harness.py::test_frozen_retrieval_goldens


def test_four_arms_coalesced_match_jax_on_goldens(harness):
    corpus, jax_emb, record, emb, port = harness
    assert port.chargram_index == record.chargram_index
    ref_arms = [
        JaxSemanticRetriever.from_doc_records(jax_emb, [record], k=7),
        JaxLateInteractionRetriever.from_doc_records(jax_emb, [record], k=7),
        JaxBm25Retriever.from_doc_records([record], k=7),
        JaxChargramRetriever.from_doc_records([record], k=7),
    ]
    cache = DeviceIndexCache()
    arms = port_arms(emb, port, cache)
    assert cache.wait_warm(TIMEOUT)
    questions = [corpus.questions[qi].question for qi in GOLDENS]
    mb.reset_counts()
    got = gather(*(arm.aretrieve(q) for arm in arms for q in questions))
    assert {name: mb.WAVES[name] for name in ("query_encode", "dense_scan", "bm25_scan")} == {
        "query_encode": 1, "dense_scan": 1, "bm25_scan": 2}  # the chargram arm scans its own BM25 index
    for a, (arm, ref) in enumerate(zip(arms, ref_arms)):
        for j, q in enumerate(questions):
            hits = got[a * len(questions) + j]
            assert pairs(hits) == pairs(arm.retrieve(q)) == pairs(ref.retrieve(q)), (a, q)
    # golden semantic and BM25 orders (k = 3 prefixes of k = 7)
    assert [h.chunk_id for h in got[4][:3]] == [0, 4, 3] and [h.chunk_id for h in got[5][:3]] == [1, 4, 3]
    assert [h.chunk_id for h in got[0][:3]] == [3, 2, 1] == [h.chunk_id for h in got[1][:3]]


def test_ensemble_coalesced_matches_jax_on_goldens(harness):
    """Each request rebuilds its four arms through the cache (hits after the
    first) and awaits the RRF ``aretrieve``; concurrent requests give the
    JAX ensemble's fused lists, and their lone runs' lists."""
    corpus, jax_emb, record, emb, port = harness
    ref = JaxEnsembleRetriever([
        JaxSemanticRetriever.from_doc_records(jax_emb, [record], k=7),
        JaxLateInteractionRetriever.from_doc_records(jax_emb, [record], k=7),
        JaxBm25Retriever.from_doc_records([record], k=7),
        JaxChargramRetriever.from_doc_records([record], k=7),
    ])
    cache = DeviceIndexCache()

    async def request(q):
        return await EnsembleRetriever(port_arms(emb, port, cache)).aretrieve(q)

    questions = [corpus.questions[qi].question for qi in GOLDENS]
    concurrent = gather(*(request(q) for q in questions * 2))
    assert cache.wait_warm(TIMEOUT)
    assert (cache.misses, cache.hits, len(cache)) == (4, 4 * 3, 4)
    lone = [gather(request(q))[0] for q in questions]
    for j, q in enumerate(questions):
        want = [h.key for h in asyncio.run(ref.aretrieve(q))]
        assert [h.key for h in concurrent[j]] == [h.key for h in concurrent[j + 2]] == want, q
        assert [h.key for h in lone[j]] == want, q
