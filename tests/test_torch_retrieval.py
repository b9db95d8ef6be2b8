"""The port's retrieval layer against the JAX package's, on the CPU: the
BM25 retriever, the fusion functions, the RRF ensemble, and the slice as a
whole (keywords -> BM25, tokenize -> encode -> dense index, RRF).

- fusion: tests/test_retrieval_layer.py's RRF and CombSUM/CombMNZ cases,
  each function of the port against the JAX package's on the same hits;
- retrievers over two small records: the same hits and scores (rtol 1e-6)
  as the JAX retrievers, ``retrieve_batch`` and ``aretrieve`` equal to
  ``retrieve``, ``mesh`` (8 CPU slots) serving the JAX retriever's hits
  on its 8-device mesh, ``device_cache`` hit on a second build;
- the slice: tests/test_eval_harness.py's seeded corpus, record and
  encoder (carried across with ``params_from_jax_numpy``), the port fed
  its own parse of the corpus PDF (equal to the JAX package's chunks) and
  the JAX package's text index. BM25 [0, 4, 3] and
  [1, 4, 3], semantic [3, 2, 1] twice (test_frozen_retrieval_goldens), and
  RRF lists equal to the JAX ``EnsembleRetriever``'s;
- the reference's Cadibona golden (chunk 31, page 3), which needs the
  reference's alps corpus and skips where it is not present, as
  tests/test_alps_eval.py does.
"""

import asyncio
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

from dial_rag_tpu.documents.model import FORMAT_VERSION as JAX_FORMAT_VERSION
from dial_rag_tpu.documents.model import DocumentRecord as JaxRecord
from dial_rag_tpu.documents.model import IndexSettings as JaxIndexSettings
from dial_rag_tpu.documents.model import build_chunks_list as jax_chunks_list
from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.index.records import SearchHit as JaxHit
from dial_rag_tpu.models.tokenizer import build_test_vocab as jax_build_test_vocab
from dial_rag_tpu.retrieval import Bm25Retriever as JaxBm25Retriever
from dial_rag_tpu.retrieval import EnsembleRetriever as JaxEnsembleRetriever
from dial_rag_tpu.retrieval import SemanticRetriever as JaxSemanticRetriever
from dial_rag_tpu.retrieval import ensemble as jax_ensemble
from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord, IndexSettings, build_chunks_list
from dial_rag_tpu_torch.documents.parser import parse_document
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.retrieval import Bm25Retriever, EnsembleRetriever, SemanticRetriever
from dial_rag_tpu_torch.retrieval import ensemble
from dial_rag_tpu_torch.retrieval.base import Retriever
from dial_rag_tpu_torch.retrieval.postprocess import get_text_chunks
from dial_rag_tpu_torch.text.keywords import keywords_preprocess
from dial_rag_tpu_torch.weights import params_from_jax_numpy
from eval.corpus import build_corpus
from eval.eval_alps import DEFAULT_DATA_DIR, alps_data_available
from eval.eval_retriever import build_record, make_test_embedder

DOC1_TEXTS = [
    "the alps stretch across eight alpine countries",
    "colle di cadibona marks the southern boundary of the alps",
    "climate in the alps varies with elevation",
]
DOC2_TEXTS = [
    "mont blanc is the highest peak",
    "glaciers shaped the alpine valleys",
]
QUERIES = ["cadibona", "cadibona southern boundary", "climate in the alps", "alpine valleys", "zzz unknown"]


def port_embedder_of(jax_emb, batch_size: int) -> BgeEmbedder:
    """The JAX embedder's tokenizer vocab and weights in the port."""
    return BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=jax_emb.tokenizer.vocab),
        encoder=BertEncoder(BertConfig.tiny()),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_emb.params)),
        device="cpu",
        batch_size=batch_size,
    )


def port_record(chunks: list[Chunk], text_index, embeddings_index) -> DocumentRecord:
    return DocumentRecord(
        format_version=JAX_FORMAT_VERSION,
        index_settings=IndexSettings(),
        chunks=chunks,
        text_index=text_index,
        embeddings_index=embeddings_index,
        multimodal_embeddings_index=None,
        description_embeddings_index=None,
        mime_type="text/plain",
        document_bytes=b"",
    )


def keys(hits) -> list[str]:
    return [h.key for h in hits]


@pytest.fixture(scope="module")
def pair():
    """(JAX records, JAX embedder, port records, port embedder) over the
    two documents."""
    words = sorted(set(" ".join(DOC1_TEXTS + DOC2_TEXTS).split()))
    jax_emb = JaxEmbedder.from_random(vocab=jax_build_test_vocab(words + ["what", "is", "question", "?"]), batch_size=4)
    emb = port_embedder_of(jax_emb, batch_size=4)

    async def jax_records():
        out = []
        for texts in (DOC1_TEXTS, DOC2_TEXTS):
            chunks = jax_chunks_list([(t, {"source": "s"}) for t in texts])
            out.append(JaxRecord(
                format_version=JAX_FORMAT_VERSION, index_settings=JaxIndexSettings(), chunks=chunks,
                text_index=await JaxBm25Retriever.build_index(chunks),
                embeddings_index=await JaxSemanticRetriever.build_index(jax_emb, chunks),
                multimodal_embeddings_index=None, description_embeddings_index=None,
                mime_type="text/plain", document_bytes=b"",
            ))
        return out

    records = []
    for texts in (DOC1_TEXTS, DOC2_TEXTS):
        chunks = build_chunks_list([(t, {"source": "s"}) for t in texts])
        records.append(port_record(chunks, asyncio.run(Bm25Retriever.build_index(chunks)),
                                   asyncio.run(SemanticRetriever.build_index(emb, chunks))))
    return asyncio.run(jax_records()), jax_emb, records, emb


def test_records_index_like_jax(pair):
    jax_records, _, records, _ = pair
    for jr, r in zip(jax_records, records):
        assert r.text_index == jr.text_index
        assert [c.metadata for c in r.chunks] == [c.metadata for c in jr.chunks]
        for a, b in zip(r.embeddings_index, jr.embeddings_index):
            np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_bm25_retriever_matches_jax(pair, k):
    jax_records, _, records, _ = pair
    port = Bm25Retriever.from_doc_records(records, k=k, device="cpu")
    ref = JaxBm25Retriever.from_doc_records(jax_records, k=k)
    for q in QUERIES:
        hits, ref_hits = port.retrieve(q), ref.retrieve(q)
        assert keys(hits) == keys(ref_hits), q
        np.testing.assert_allclose([h.score for h in hits], [h.score for h in ref_hits], rtol=1e-6)
        assert [h.score for h in hits] == sorted((h.score for h in hits), reverse=True)
    batch = port.retrieve_batch(QUERIES)
    for q, hits in zip(QUERIES, batch):
        single = port.retrieve(q)
        assert keys(hits) == keys(single) and [h.score for h in hits] == [h.score for h in single]
        assert keys(asyncio.run(port.aretrieve(q))) == keys(single)


def test_bm25_exact_chunk_and_scores(pair):
    _, _, records, _ = pair
    r = Bm25Retriever.from_doc_records(records, k=4, device="cpu")
    assert r.retrieve("cadibona")[0] == SearchHit(0, 1, RetrievalType.TEXT)
    hits = r.retrieve("cadibona southern boundary")
    flat = r._index.get_scores(keywords_preprocess("cadibona southern boundary"))
    offsets = [0, len(records[0].chunks)]
    np.testing.assert_allclose([h.score for h in hits], flat[[offsets[h.doc_id] + h.chunk_id for h in hits]],
                               rtol=1e-6)


def test_bm25_has_index_and_empty_records(pair):
    _, _, records, _ = pair
    assert Bm25Retriever.has_index(records)
    empty = port_record([], [], None)
    assert not Bm25Retriever.has_index([empty])
    with pytest.raises(ValueError, match="empty"):
        Bm25Retriever.from_doc_records([empty, port_record([], [[]], None)], device="cpu")


@pytest.mark.parametrize("option", ["mesh"])
def test_unported_bm25_options_raise(pair, option):
    """``mesh`` used to raise until the sharded indexes were ported: now
    the index shards over a mesh of 8 CPU slots and serves the unsharded
    retriever's hits, and the JAX retriever's on its 8-device mesh."""
    from dial_rag_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from dial_rag_tpu_torch.parallel.mesh import create_mesh
    from dial_rag_tpu_torch.parallel.sharded_index import ShardedBm25Index

    jax_records, _, records, _ = pair
    sharded = Bm25Retriever.from_doc_records(records, k=3, device="cpu", **{option: create_mesh(devices=["cpu"] * 8)})
    assert isinstance(sharded._index, ShardedBm25Index)
    single = Bm25Retriever.from_doc_records(records, k=3, device="cpu")
    ref = JaxBm25Retriever.from_doc_records(jax_records, k=3, mesh=jax_create_mesh(8))
    for q in QUERIES:
        hits = sharded.retrieve(q)
        assert hits == single.retrieve(q)
        assert keys(hits) == keys(ref.retrieve(q))
        np.testing.assert_allclose([h.score for h in hits], [h.score for h in ref.retrieve(q)], rtol=1e-6)


@pytest.mark.parametrize("expand", [False, True])
def test_bm25_device_cache_hit_on_second_build(pair, expand):
    """``device_cache``: the second build over records with the same
    content tokens is a hit (the index, and the word vectors when the
    retriever expands), and serves the same hits."""
    from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
    from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig

    _, _, records, _ = pair
    stamped = [dataclasses.replace(r, cache_token=("doc", i)) for i, r in enumerate(records)]
    cfg = QueryExpansionConfig(min_count=1, sim_min=-1.0) if expand else None
    cache = DeviceIndexCache()
    first = Bm25Retriever.from_doc_records(stamped, k=3, device="cpu", device_cache=cache, expansion_config=cfg)
    second = Bm25Retriever.from_doc_records(stamped, k=3, device="cpu", device_cache=cache, expansion_config=cfg)
    n_objects = 2 if expand else 1
    assert second._index is first._index and (cache.misses, cache.hits, len(cache)) == (n_objects, n_objects, n_objects)
    assert cache.wait_warm(30)
    plain = Bm25Retriever.from_doc_records(records, k=3, device="cpu", expansion_config=cfg)
    for q in QUERIES:
        assert keys(second.retrieve(q)) == keys(plain.retrieve(q)), q


def test_bm25_with_expansion_config_matches_jax(pair):
    """``expansion_config`` builds word vectors over the records' chunks and
    scores each query as a stem -> weight mapping, as the JAX retriever
    does with the service's QueryExpansionConfig."""
    from dial_rag_tpu.service.config import QueryExpansionConfig as JaxQueryExpansionConfig
    from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig

    jax_records, _, records, _ = pair
    cfg = QueryExpansionConfig(min_count=1, sim_min=-1.0)
    assert QueryExpansionConfig() == QueryExpansionConfig(**JaxQueryExpansionConfig().model_dump())
    port = Bm25Retriever.from_doc_records(records, k=4, device="cpu", expansion_config=cfg)
    ref = JaxBm25Retriever.from_doc_records(
        jax_records, k=4, expansion_config=JaxQueryExpansionConfig(min_count=1, sim_min=-1.0))
    assert port._expander is not None
    for q in QUERIES:
        weights = port._preprocess(q)
        assert isinstance(weights, dict) and weights == pytest.approx(ref._preprocess(q), rel=1e-6)
        hits, ref_hits = port.retrieve(q), ref.retrieve(q)
        assert keys(hits) == keys(ref_hits), q
        np.testing.assert_allclose([h.score for h in hits], [h.score for h in ref_hits], rtol=1e-5)


def test_semantic_aretrieve_matches_jax(pair):
    jax_records, jax_emb, records, emb = pair
    port = SemanticRetriever.from_doc_records(emb, records, k=3)
    ref = JaxSemanticRetriever.from_doc_records(jax_emb, jax_records, k=3)
    for q in QUERIES:
        hits = asyncio.run(port.aretrieve(q))
        assert keys(hits) == keys(port.retrieve(q)) == keys(ref.retrieve(q))
    assert isinstance(port, Retriever)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0], [0.5, 1.0]])
def test_ensemble_matches_jax(pair, weights):
    jax_records, jax_emb, records, emb = pair
    port = EnsembleRetriever(
        [SemanticRetriever.from_doc_records(emb, records, k=3), Bm25Retriever.from_doc_records(records, k=3, device="cpu")],
        weights=weights,
    )
    ref = JaxEnsembleRetriever(
        [JaxSemanticRetriever.from_doc_records(jax_emb, jax_records, k=3),
         JaxBm25Retriever.from_doc_records(jax_records, k=3)],
        weights=weights,
    )
    batch = asyncio.run(port.aretrieve_batch(QUERIES))
    for q, hits in zip(QUERIES, batch):
        single = asyncio.run(port.aretrieve(q))
        assert keys(hits) == keys(single) == keys(asyncio.run(ref.aretrieve(q))), q


def test_get_text_chunks(pair):
    _, _, records, _ = pair
    hits = Bm25Retriever.from_doc_records(records, k=2, device="cpu").retrieve("cadibona")
    chunks = get_text_chunks(hits, records)
    assert chunks[0].text == DOC1_TEXTS[1]
    assert chunks[0].metadata == {"source": "s", "chunk_id": 1, "doc_id": 0, "retrieval_type": "text"}


# --- fusion functions ---------------------------------------------------


def both(d, c, score=None):
    """The same hit in the port and in the JAX package."""
    return SearchHit(d, c, RetrievalType.TEXT, score), JaxHit(d, c, JaxRetrievalType.TEXT, score)


def split(lists):
    return [[h[0] for h in hl] for hl in lists], [[h[1] for h in hl] for hl in lists]


def hits_from_scores(scores, depth, doc_id=0):
    order = np.argsort(-scores, kind="stable")[:depth]
    return [both(doc_id, int(i), float(scores[i])) for i in order]


class Fixed:
    def __init__(self, hits):
        self._hits = hits

    async def aretrieve(self, query):
        return self._hits


def test_rrf_matches_langchain_semantics():
    lists = [[both(0, 0), both(0, 1), both(0, 2)], [both(0, 1), both(1, 0), both(0, 0)]]
    port_lists, jax_lists = split(lists)
    got = asyncio.run(EnsembleRetriever([Fixed(h) for h in port_lists]).aretrieve("q"))
    score = {}
    for lst in port_lists:
        for rank, hit in enumerate(lst, start=1):
            score[hit.key] = score.get(hit.key, 0.0) + 1.0 / (rank + 60)
    unique = list({h.key: h for lst in port_lists for h in lst}.values())
    assert got == sorted(unique, key=lambda x: score[x.key], reverse=True)
    assert keys(got) == keys(jax_ensemble.weighted_reciprocal_rank(jax_lists, [1.0, 1.0]))
    assert keys(got[:2]) == ["0_1", "0_0"]


@pytest.mark.parametrize("weights", [[1.0, 1.0], [2.0, 1.0], [1.0, 0.0]])
def test_rrf_tie_order_first_appearance(weights):
    port_lists, jax_lists = split([[both(0, 0)], [both(1, 0)]])
    out = ensemble.weighted_reciprocal_rank(port_lists, weights)
    assert keys(out) == keys(jax_ensemble.weighted_reciprocal_rank(jax_lists, weights))
    assert keys(out) == ["0_0", "1_0"]


@pytest.mark.parametrize("method", ["combsum", "combmnz"])
@pytest.mark.parametrize("norm", ["minmax", "zscore"])
def test_weighted_score_fusion_matches_experiment_form(method, norm):
    """tests/test_retrieval_layer.py's numpy form of the experiment, and
    the JAX package's function, on random score vectors."""
    rng = np.random.default_rng(7)
    n, depth, k = 50, 12, 7
    weights = [0.5, 1.0, 1.5]
    for trial in range(5):
        mats = [rng.normal(size=n) for _ in range(3)]
        port_lists, jax_lists = split([hits_from_scores(m, depth) for m in mats])
        fused = ensemble.weighted_score_fusion(port_lists, weights, method=method, norm=norm)
        got = [h.chunk_id for h in fused[:k]]
        ref = np.zeros(n)
        support = np.zeros(n)
        for m, w in zip(mats, weights):
            top = np.argsort(-m, kind="stable")[:depth]
            sub = m[top]
            vals = (sub - sub.min()) / (sub.max() - sub.min()) if norm == "minmax" else (sub - sub.mean()) / sub.std()
            if method == "combmnz" and vals.min() < 0:
                vals = vals - vals.min()
            s = np.zeros(n)
            s[top] = vals
            ref += w * s
            support[np.argsort(-m, kind="stable")[:7]] += 1
        if method == "combmnz":
            ref *= np.maximum(support, 1)
        seen = {h.chunk_id for hl in port_lists for h in hl}
        assert got == [int(i) for i in np.argsort(-ref, kind="stable") if int(i) in seen][:k], trial
        jax_fused = jax_ensemble.weighted_score_fusion(jax_lists, weights, method=method, norm=norm)
        assert keys(fused) == keys(jax_fused)


def test_score_fusion_rank_proxy_fallback():
    port_lists, _ = split([[both(0, c) for c in (4, 2, 9)]])
    assert [h.chunk_id for h in ensemble.weighted_score_fusion(port_lists, [1.0])] == [4, 2, 9]


def test_combmnz_multi_arm_support_wins():
    a, b = np.zeros(10), np.zeros(10)
    a[3], a[5] = 1.0, 0.9
    b[5], b[8] = 1.0, 0.2
    port_lists, jax_lists = split([hits_from_scores(a, 7), hits_from_scores(b, 7)])
    fused = ensemble.weighted_score_fusion(port_lists, [1.0, 1.0], method="combmnz")
    assert fused[0].chunk_id == 5
    assert keys(fused) == keys(jax_ensemble.weighted_score_fusion(jax_lists, [1.0, 1.0], method="combmnz"))


def test_score_fusion_weight_zero_arm_is_inert():
    a, b = np.zeros(10), np.zeros(10)
    a[1], a[2] = 1.0, 0.5
    b[7], b[1] = 1.0, 0.9
    port_lists, _ = split([hits_from_scores(a, 7), hits_from_scores(b, 7)])
    with_zero = ensemble.weighted_score_fusion(port_lists, [1.0, 0.0], method="combmnz")
    alone = ensemble.weighted_score_fusion(port_lists[:1], [1.0], method="combmnz")
    assert keys(with_zero) == keys(alone)


@pytest.mark.parametrize("method,norm", [("bogus", "minmax"), ("combsum", "bogus")])
def test_score_fusion_rejects_unknown_options(method, norm):
    port_lists, _ = split([[both(0, 0, 1.0), both(0, 1, 0.5)]])
    with pytest.raises(ValueError):
        ensemble.weighted_score_fusion(port_lists, [1.0], method=method, norm=norm)


def test_score_fusion_ensemble_output_limit():
    port_lists, jax_lists = split([[both(0, c, 1.0 / (c + 1)) for c in range(6)], [both(1, c, 2.0 - c) for c in range(4)]])
    ens = EnsembleRetriever([Fixed(h) for h in port_lists], fusion_method="combmnz", output_limit=5)
    ref = JaxEnsembleRetriever([Fixed(h) for h in jax_lists], fusion_method="combmnz", output_limit=5)
    got = asyncio.run(ens.aretrieve("q"))
    assert len(got) == 5 and keys(got) == keys(asyncio.run(ref.aretrieve("q")))


# --- the slice as a whole -------------------------------------------------


@pytest.fixture(scope="module")
def harness():
    """tests/test_eval_harness.py's seeded corpus, JAX record and encoder,
    and the port's record over the port's own parse of the corpus PDF
    (chunks equal to the JAX record's) and the JAX record's text index."""
    corpus = build_corpus(n_pages=5, seed=0)
    jax_emb = make_test_embedder(corpus)
    record, _ = asyncio.run(build_record(corpus, jax_emb))
    emb = port_embedder_of(jax_emb, batch_size=jax_emb.batch_size)
    chunks = parse_document(corpus.pdf_bytes, "application/pdf", source_link="atlas.pdf", display_name="atlas.pdf")
    assert [(c.text, c.metadata) for c in chunks] == [(c.text, c.metadata) for c in record.chunks]
    port = port_record(chunks, record.text_index, asyncio.run(SemanticRetriever.build_index(emb, chunks)))
    return corpus, jax_emb, record, emb, port


def test_slice_text_index_and_embeddings_match_jax(harness):
    _, _, record, _, port = harness
    assert len(port.chunks) == 5
    assert asyncio.run(Bm25Retriever.build_index(port.chunks)) == record.text_index
    for a, b in zip(port.embeddings_index, record.embeddings_index):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize(
    "qi,question,bm25,semantic",
    [
        (0, "How many meters tall is Mount Drorfell?", [0, 4, 3], [3, 2, 1]),
        (3, "How many meters tall is Mount Glinwick?", [1, 4, 3], [3, 2, 1]),
    ],
)
def test_frozen_retrieval_goldens(harness, qi, question, bm25, semantic):
    """test_frozen_retrieval_goldens through the port."""
    corpus, _, _, emb, port = harness
    assert corpus.questions[qi].question == question
    bm25_r = Bm25Retriever.from_doc_records([port], k=3, device="cpu")
    sem_r = SemanticRetriever.from_doc_records(emb, [port], k=3)
    assert [h.chunk_id for h in bm25_r.retrieve(question)] == bm25
    assert [h.chunk_id for h in sem_r.retrieve(question)] == semantic


@pytest.mark.parametrize("qi", [0, 3])
def test_slice_rrf_ensemble_matches_jax(harness, qi):
    """The serving ensemble (semantic k=7, BM25 k=7, RRF) of the port
    equals the JAX package's on the golden questions, alone and batched.
    (The seeded encoder puts the five chunks within 2e-5 of each other, so
    other questions hold semantic near-ties that the JAX package itself
    orders differently in its batch and single paths.)"""
    corpus, jax_emb, record, emb, port = harness
    ens = EnsembleRetriever([SemanticRetriever.from_doc_records(emb, [port], k=7),
                             Bm25Retriever.from_doc_records([port], k=7, device="cpu")])
    ref = JaxEnsembleRetriever([JaxSemanticRetriever.from_doc_records(jax_emb, [record], k=7),
                                JaxBm25Retriever.from_doc_records([record], k=7)])
    question = corpus.questions[qi].question
    got = asyncio.run(ens.aretrieve(question))
    assert keys(got) == keys(asyncio.run(ref.aretrieve(question)))
    questions = [q.question for q in corpus.questions]
    batch = asyncio.run(ens.aretrieve_batch(questions))
    assert keys(batch[qi]) == keys(got)
    assert keys(batch[qi]) == keys(asyncio.run(ref.aretrieve_batch(questions))[qi])


# --- the reference's alps golden -----------------------------------------

# the reference checkout that holds the eval corpus also holds the parity PDF
TESTS_ALPS_PDF = Path(DEFAULT_DATA_DIR).parent.parent / "tests" / "data" / "alps_wiki.pdf"


@pytest.mark.skipif(not alps_data_available(), reason="the reference's alps corpus is not present")
def test_cadibona_golden_through_the_port():
    """BM25 'Colle di Cadibona' retrieves chunk 31 on page 3 (the
    reference's golden, tests/test_alps_eval.py) through the port's
    keywords and BM25, on the port's own parse of the PDF."""
    chunks = parse_document(TESTS_ALPS_PDF.read_bytes(), "application/pdf", source_link="alps_wiki.pdf",
                            display_name="alps_wiki.pdf")
    record = port_record(chunks, asyncio.run(Bm25Retriever.build_index(chunks)), None)
    hits = asyncio.run(Bm25Retriever.from_doc_records([record], k=7, device="cpu").aretrieve("Colle di Cadibona"))
    assert hits[0].chunk_id == 31
    assert chunks[31].page_number == 3
    assert "Colle di Cadibona" in chunks[31].text


def test_record_dataclasses_match_jax_fields():
    port_fields = [f.name for f in dataclasses.fields(DocumentRecord)]
    assert port_fields == [f.name for f in dataclasses.fields(JaxRecord)]
    assert IndexSettings({"a": 1}) == IndexSettings({"a": 1}) != IndexSettings()
