"""The port's chargram arm, word vectors and query expansion, and the
four-arm RRF ensemble, against the JAX package's on the CPU:

- ``ChargramIndex`` scores (rtol 1e-5, atol 1e-6) and top-n against the
  JAX index in the dense and band + CSC layouts, the later item first on
  ties, batch equal to single;
- the C++ core's (chunk, key, count) triples and the numpy path's equal to
  each other and to the JAX package's, input the core rejects routed to
  numpy and counted in ``PATHS``;
- ``ChargramRetriever`` against the JAX retriever over two documents,
  ``has_index`` false on records whose words are all invalid, ``mesh``
  (8 CPU slots, the inner index sharded through ``with_inner``) serving
  the same hits, ``device_cache`` hit on a second build;
- ``build_word_vectors`` equal to the JAX package's bit for bit,
  ``expand_query`` weights equal, and ``Bm25Retriever`` with expansion
  finding the synonym chunk (tests/test_word_vectors.py's corpus);
- the four local arms (semantic, late_interaction, bm25, chargram; RRF, k
  = 7 each) on tests/test_eval_harness.py's seeded corpus: the fused lists
  equal to the JAX ``EnsembleRetriever``'s on the golden questions, alone
  and batched. (With expansion on, golden question 3 puts three BM25 items
  within an f32 rounding of each other, 0.081429, which the two packages'
  products order differently; the expanded arm is held to the JAX one in
  the tests above and in tests/test_torch_retrieval.py.)
"""

import asyncio
import random

import numpy as np
import pytest

from dial_rag_tpu.documents.model import DocumentRecord as JaxRecord
from dial_rag_tpu.documents.model import IndexSettings as JaxIndexSettings
from dial_rag_tpu.documents.model import build_chunks_list as jax_chunks_list
from dial_rag_tpu.index import chargram as jcg
from dial_rag_tpu.retrieval import Bm25Retriever as JaxBm25Retriever
from dial_rag_tpu.retrieval import EnsembleRetriever as JaxEnsembleRetriever
from dial_rag_tpu.retrieval import SemanticRetriever as JaxSemanticRetriever
from dial_rag_tpu.retrieval.chargram_retriever import ChargramRetriever as JaxChargramRetriever
from dial_rag_tpu.retrieval.late_interaction import LateInteractionRetriever as JaxLateInteractionRetriever
from dial_rag_tpu.service.config import QueryExpansionConfig as JaxQueryExpansionConfig
from dial_rag_tpu.text import word_vectors as jwv
from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord, IndexSettings, build_chunks_list
from dial_rag_tpu_torch.index import chargram as cg
from dial_rag_tpu_torch.retrieval import (
    Bm25Retriever,
    ChargramRetriever,
    EnsembleRetriever,
    LateInteractionRetriever,
    SemanticRetriever,
)
from dial_rag_tpu_torch.text import word_vectors as wv
from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig
from eval.corpus import build_corpus
from eval.eval_retriever import build_record, make_test_embedder
from test_torch_retrieval import port_embedder_of

TEXTS = [
    "The Alps are the highest mountain range entirely in Europe.",
    "Glaciers shaped the valleys over millions of years.",
    "Glaciation carved deep U-shaped alpine valleys.",
    "The climate varies with elevation and latitude.",
    "Monte Rosa and Mont Blanc are the highest peaks.",
    "Winter tourism brings skiers to mountainous regions.",
]
QUERIES = ["glacier valleys", "mountainous climate", "highest peak in europe", "the", "zzz qqq"]
WORD_LISTS = [cg.chargram_words(t) for t in TEXTS]


def record(texts, port=True):
    chunks = (build_chunks_list if port else jax_chunks_list)([(t, {}) for t in texts])
    cls, settings = (DocumentRecord, IndexSettings) if port else (JaxRecord, JaxIndexSettings)
    return cls(format_version=3, index_settings=settings(), chunks=chunks, text_index=None, embeddings_index=None,
               multimodal_embeddings_index=None, description_embeddings_index=None, mime_type="text/plain",
               document_bytes=b"", chargram_index=[cg.chargram_words(t) for t in texts])


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "csc"])
def test_chargram_index_matches_jax(dense):
    kw = {} if dense else {"max_dense_bytes": 0, "max_band_bytes": 0}
    port = cg.ChargramIndex.build(WORD_LISTS, device="cpu", **kw)
    ref = jcg.ChargramIndex.build(WORD_LISTS, **kw)
    assert port.inner.layout == ("dense" if dense else "csc") and port._vocab == ref._vocab
    batch = port.top_n_batch_with_scores(QUERIES, 4)
    for q, (b_idx, b_val) in zip(QUERIES, batch):
        assert port.query_weights(q) == ref.query_weights(q)
        np.testing.assert_allclose(port.get_scores(q), ref.get_scores(q), rtol=1e-5, atol=1e-6)
        idx, vals = port.top_n_with_scores(q, 4)
        ref_idx, _ = ref.top_n_with_scores(q, 4)
        assert idx.tolist() == np.asarray(ref_idx).tolist() == b_idx.tolist() == port.top_n(q, 4).tolist()
        assert vals.tolist() == b_val.tolist()


def test_chargram_ties_latest_first():
    port = cg.ChargramIndex.build([["alps"], ["alps"], ["valley"], ["alps"]], device="cpu")
    assert port.top_n("alps", 3).tolist() == [3, 1, 0]


def test_native_and_numpy_triples_match_jax():
    rng = random.Random(13)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    for trial in range(6):
        word_lists = [["".join(rng.choice(alphabet) for _ in range(rng.randrange(1, 15)))
                       for _ in range(rng.randrange(0, 40))] for _ in range(rng.randrange(0, 12))]
        n_lo, n_hi = sorted((rng.randrange(1, 6), rng.randrange(2, 9)))
        n_hi += n_lo == n_hi
        sets = [{(int(c), int(k), int(n)) for c, k, n in zip(*triples)} for triples in (
            cg._triples_native(word_lists, n_lo, n_hi), cg._triples_numpy(word_lists, n_lo, n_hi),
            jcg._triples_numpy(word_lists, n_lo, n_hi))]
        assert sets[0] == sets[1] == sets[2], trial
    # the core rejects a byte outside [a-z0-9]; the numpy path serves it
    assert cg._triples_native([["Alps"]], 2, 4) is None
    cg.reset_paths()
    cg.ChargramIndex.weight_arrays([["alps"], ["rhine"]], 2, 4)
    cg.ChargramIndex.weight_arrays([["Alps"]], 2, 4)
    assert cg.PATHS == {"native": 2, "numpy": 1}


def test_chargram_retriever_matches_jax():
    port_recs = [record(TEXTS[:3]), record(TEXTS[3:])]
    ref_recs = [record(TEXTS[:3], port=False), record(TEXTS[3:], port=False)]
    r = ChargramRetriever.from_doc_records(port_recs, k=4, device="cpu")
    ref = JaxChargramRetriever.from_doc_records(ref_recs, k=4)
    batch = r.retrieve_batch(QUERIES)
    for q, hits in zip(QUERIES, batch):
        single = r.retrieve(q)
        want = ref.retrieve(q)
        assert [h.key for h in single] == [h.key for h in want] == [h.key for h in hits]
        assert [h.key for h in asyncio.run(r.aretrieve(q))] == [h.key for h in single]
        np.testing.assert_allclose([h.score for h in single], [h.score for h in want], rtol=1e-5, atol=1e-6)
    bad = record(["placeholder"])
    bad.chargram_index = [["Zürich", "КЛИМАТ", "x" * 2000]]
    assert not ChargramRetriever.has_index([bad]) and ChargramRetriever.has_index([bad, port_recs[0]])
    assert asyncio.run(r.build_index(port_recs[0].chunks)) == port_recs[0].chargram_index
    assert ChargramRetriever.from_doc_records([bad, port_recs[0]], k=2, device="cpu").retrieve("alps")[0].doc_id == 1
    from dial_rag_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from dial_rag_tpu_torch.parallel.mesh import create_mesh

    sharded = ChargramRetriever.from_doc_records(port_recs, k=4, device="cpu", mesh=create_mesh(devices=["cpu"] * 8))
    jsharded = JaxChargramRetriever.from_doc_records(ref_recs, k=4, mesh=jax_create_mesh(8))
    assert type(sharded._index.inner).__name__ == "ShardedBm25Index"
    for q in QUERIES:
        assert sharded.retrieve(q) == r.retrieve(q)
        assert [h.key for h in sharded.retrieve(q)] == [h.key for h in jsharded.retrieve(q)]


def test_chargram_device_cache_hit_on_second_build():
    """``device_cache``: the second build over the same content tokens is a
    hit and serves the same hits."""
    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache

    recs = [record(TEXTS[:3]), record(TEXTS[3:])]
    for i, r in enumerate(recs):
        r.cache_token = ("doc", i)
    cache = DeviceIndexCache()
    first = ChargramRetriever.from_doc_records(recs, k=4, device="cpu", device_cache=cache)
    second = ChargramRetriever.from_doc_records(recs, k=4, device="cpu", device_cache=cache)
    assert second._index is first._index and (cache.misses, cache.hits) == (1, 1)
    assert cache.wait_warm(30)
    plain = ChargramRetriever.from_doc_records(recs, k=4, device="cpu")
    for q in QUERIES:
        assert [h.key for h in second.retrieve(q)] == [h.key for h in plain.retrieve(q)]


# tests/test_word_vectors.py's corpus: "glacier" and "ice" share contexts
CORPUS = [
    "the glacier high in the mountains melts slowly every summer",
    "the ice high in the mountains melts slowly every summer",
    "the glacier feeds the cold river below the mountains",
    "the ice feeds the cold river below the mountains",
    "income tax rates rose in the city parliament this year",
    "income tax law changed in the city parliament this year",
] * 3


def test_word_vectors_and_expansion_match_jax():
    for kw in ({"window": 3, "dim": 32}, {}):
        got = wv.build_word_vectors(CORPUS + TEXTS, **kw)
        want = jwv.build_word_vectors(CORPUS + TEXTS, **kw)
        assert got.words == want.words and got.index == want.index
        assert np.array_equal(got.vecs, want.vecs)
        for q in ("glacier river", "income tax", "highest peaks of the alps", "zzz"):
            assert wv.expand_query(q, got, m=3, sim_min=0.1) == jwv.expand_query(q, want, m=3, sim_min=0.1)
    assert QueryExpansionConfig() == QueryExpansionConfig(**JaxQueryExpansionConfig().model_dump())


def test_bm25_with_expansion_finds_synonym_chunk():
    chunks = build_chunks_list([(t, {"page_number": 1}) for t in CORPUS])
    rec = DocumentRecord(format_version=3, index_settings=IndexSettings(), chunks=chunks,
                         text_index=asyncio.run(Bm25Retriever.build_index(chunks)), embeddings_index=None,
                         multimodal_embeddings_index=None, description_embeddings_index=None,
                         mime_type="text/plain", document_bytes=b"")
    plain = Bm25Retriever.from_doc_records([rec], k=3, device="cpu")
    expanded = Bm25Retriever.from_doc_records([rec], k=3, device="cpu", expansion_config=QueryExpansionConfig(
        window=3, dim=32, neighbors=3, alpha=1.0, sim_min=0.1))
    ice = {i for i, t in enumerate(CORPUS) if "ice" in t.split()}
    assert not {h.chunk_id for h in plain.retrieve("glacier river")} & ice
    assert {h.chunk_id for h in expanded.retrieve("glacier river")} & ice
    assert [h.key for h in expanded.retrieve_batch(["glacier river"])[0]] == [
        h.key for h in expanded.retrieve("glacier river")]


@pytest.fixture(scope="module")
def four_arms():
    """tests/test_eval_harness.py's seeded corpus and encoder, each record
    with every local arm's index, and the four-arm ensembles."""
    corpus = build_corpus(n_pages=5, seed=0)
    jax_emb = make_test_embedder(corpus)
    ref_rec, _ = asyncio.run(build_record(corpus, jax_emb))
    ref_rec.chargram_index = asyncio.run(JaxChargramRetriever.build_index(ref_rec.chunks))
    emb = port_embedder_of(jax_emb, batch_size=jax_emb.batch_size)
    chunks = [Chunk(text=c.text, metadata=dict(c.metadata)) for c in ref_rec.chunks]
    rec = DocumentRecord(
        format_version=3, index_settings=IndexSettings(), chunks=chunks, text_index=ref_rec.text_index,
        embeddings_index=asyncio.run(SemanticRetriever.build_index(emb, chunks)), multimodal_embeddings_index=None,
        description_embeddings_index=None, mime_type="text/plain", document_bytes=b"",
        late_interaction_index=asyncio.run(LateInteractionRetriever.build_index(emb, chunks)),
        chargram_index=asyncio.run(ChargramRetriever.build_index(chunks)))
    for a, b in zip(rec.late_interaction_index, ref_rec.late_interaction_index):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert rec.chargram_index == ref_rec.chargram_index
    port = EnsembleRetriever([
        SemanticRetriever.from_doc_records(emb, [rec], k=7),
        LateInteractionRetriever.from_doc_records(emb, [rec], k=7),
        Bm25Retriever.from_doc_records([rec], k=7, device="cpu"),
        ChargramRetriever.from_doc_records([rec], k=7, device="cpu"),
    ])
    ref = JaxEnsembleRetriever([
        JaxSemanticRetriever.from_doc_records(jax_emb, [ref_rec], k=7),
        JaxLateInteractionRetriever.from_doc_records(jax_emb, [ref_rec], k=7),
        JaxBm25Retriever.from_doc_records([ref_rec], k=7),
        JaxChargramRetriever.from_doc_records([ref_rec], k=7),
    ])
    return corpus, port, ref


@pytest.mark.parametrize("qi", [0, 3])
def test_four_arm_rrf_matches_jax(four_arms, qi):
    corpus, port, ref = four_arms
    question = corpus.questions[qi].question
    got = asyncio.run(port.aretrieve(question))
    assert [h.key for h in got] == [h.key for h in asyncio.run(ref.aretrieve(question))]
    questions = [q.question for q in corpus.questions]
    batch = asyncio.run(port.aretrieve_batch(questions))
    assert [h.key for h in batch[qi]] == [h.key for h in got]
    assert [h.key for h in batch[qi]] == [h.key for h in asyncio.run(ref.aretrieve_batch(questions))[qi]]
