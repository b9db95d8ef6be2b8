"""The slice as a whole on the CPU: document bytes -> the port's parser ->
its BM25 and semantic indexes -> storage -> a fresh load -> retrieval,
against the JAX package.

tests/test_eval_harness.py's seeded corpus (``build_corpus(n_pages=5,
seed=0)``) goes through the port's ``parse_document`` and must give the
JAX package's chunks exactly. The record is built with the port's
retrievers on the JAX test embedder's weights (``port_embedder_of``),
stored through ``LocalFileStorage`` and loaded in a fresh ``IndexStorage``;
the loaded record gives test_frozen_retrieval_goldens' ids (BM25 [0, 4, 3]
/ [1, 4, 3], semantic [3, 2, 1] twice), its embeddings lie within atol
1e-4 of the JAX record's, and ``AllDocumentsRetriever`` returns the JAX
package's hits.
"""

import asyncio

import jax
import numpy as np
import pytest

from dial_rag_tpu.documents.parser import parse_document as jax_parse_document
from dial_rag_tpu.retrieval import AllDocumentsRetriever as JaxAllDocumentsRetriever
from dial_rag_tpu_torch.documents.model import FORMAT_VERSION, DocumentRecord, IndexSettings
from dial_rag_tpu_torch.documents.parser import parse_document
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.retrieval import AllDocumentsRetriever, Bm25Retriever, SemanticRetriever
from dial_rag_tpu_torch.storage import IndexStorage, LocalFileStorage
from dial_rag_tpu_torch.storage.storage import link_to_index_url
from dial_rag_tpu_torch.weights import params_from_jax_numpy
from eval.corpus import build_corpus
from eval.eval_retriever import build_record, make_test_embedder

MIME_PDF = "application/pdf"


def port_embedder_of(jax_emb) -> BgeEmbedder:
    """The JAX embedder's tokenizer vocab and weights in the port."""
    return BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=jax_emb.tokenizer.vocab),
        encoder=BertEncoder(BertConfig.tiny()),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_emb.params)),
        device="cpu",
        batch_size=jax_emb.batch_size,
    )


def pairs(chunks) -> list:
    return [(c.text, c.metadata) for c in chunks]


def fields_of(record) -> dict:
    """Every stored field, each array as (dtype, shape, bytes)."""
    out = {}
    for name, value in vars(record).items():
        if name.endswith("index") and name not in ("text_index", "chargram_index") and value is not None:
            value = [(a.dtype.str, a.shape, a.tobytes()) for a in value]
        out[name] = pairs(value) if name == "chunks" else value
    del out["cache_token"]
    return out


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """(corpus, JAX record, port embedder, the port's record as built and
    as loaded back from storage, the index url)."""
    corpus = build_corpus(n_pages=5, seed=0)
    jax_emb = make_test_embedder(corpus)
    jax_record, _ = asyncio.run(build_record(corpus, jax_emb))
    emb = port_embedder_of(jax_emb)
    chunks = parse_document(corpus.pdf_bytes, MIME_PDF, source_link="atlas.pdf", display_name="atlas.pdf")
    built = DocumentRecord(
        format_version=FORMAT_VERSION, index_settings=IndexSettings(), chunks=chunks,
        text_index=Bm25Retriever.build_index(chunks), embeddings_index=SemanticRetriever.build_index(emb, chunks),
        multimodal_embeddings_index=None, description_embeddings_index=None, mime_type=MIME_PDF,
        document_bytes=corpus.pdf_bytes,
    )
    root = str(tmp_path_factory.mktemp("index"))
    url = link_to_index_url("files/bucket/atlas.pdf", "rag-bucket")
    asyncio.run(IndexStorage(LocalFileStorage(root)).store(url, built))
    loaded = asyncio.run(IndexStorage(LocalFileStorage(root)).load(url, IndexSettings()))
    return corpus, jax_record, emb, built, loaded, url


def test_port_parse_equals_jax_parse(indexed):
    corpus, jax_record, _, built, _, _ = indexed
    assert len(built.chunks) == 5
    assert pairs(built.chunks) == pairs(jax_record.chunks)
    assert pairs(built.chunks) == pairs(jax_parse_document(corpus.pdf_bytes, MIME_PDF, source_link="atlas.pdf",
                                                           display_name="atlas.pdf"))


def test_loaded_record_equals_stored(indexed):
    _, jax_record, _, built, loaded, url = indexed
    assert loaded is not built and fields_of(loaded) == fields_of(built)
    assert loaded.cache_token == built.cache_token and loaded.cache_token[0] == url
    assert loaded.text_index == jax_record.text_index
    for a, b, ref in zip(loaded.embeddings_index, built.embeddings_index, jax_record.embeddings_index):
        assert a.tobytes() == b.tobytes()
        np.testing.assert_allclose(a, ref, atol=1e-4)


@pytest.mark.parametrize(
    "qi,question,bm25,semantic",
    [
        (0, "How many meters tall is Mount Drorfell?", [0, 4, 3], [3, 2, 1]),
        (3, "How many meters tall is Mount Glinwick?", [1, 4, 3], [3, 2, 1]),
    ],
)
def test_frozen_retrieval_goldens_after_store_and_load(indexed, qi, question, bm25, semantic):
    corpus, _, emb, built, loaded, _ = indexed
    assert corpus.questions[qi].question == question
    for record in (built, loaded):
        assert [h.chunk_id for h in Bm25Retriever.from_doc_records([record], k=3, device="cpu").retrieve(
            question)] == bm25
        assert [h.chunk_id for h in SemanticRetriever.from_doc_records(emb, [record], k=3).retrieve(
            question)] == semantic


def test_all_documents_retriever_matches_jax(indexed):
    _, jax_record, _, _, loaded, _ = indexed
    assert AllDocumentsRetriever.is_within_limit([loaded]) == JaxAllDocumentsRetriever.is_within_limit([jax_record])
    got = AllDocumentsRetriever.from_doc_records([loaded, loaded]).retrieve("anything")
    ref = JaxAllDocumentsRetriever.from_doc_records([jax_record, jax_record]).retrieve("anything")
    assert [(h.doc_id, h.chunk_id, h.retrieval_type.value) for h in got] == [
        (h.doc_id, h.chunk_id, h.retrieval_type.value) for h in ref]
    assert asyncio.run(AllDocumentsRetriever.from_doc_records([loaded]).aretrieve("q")) == got[:5]
    big = DocumentRecord(FORMAT_VERSION, IndexSettings(), parse_document(b"x" * 13000, "text/plain", source_link="s"),
                         None, None, None, None, "text/plain", b"")
    assert not AllDocumentsRetriever.is_within_limit([big])
    assert AllDocumentsRetriever.from_doc_records(None).retrieve("q") == []


def test_chip_smoke_documents_parse_like_jax_word_for_word():
    """chip_smoke's document corpus at a small size (3 PDFs of 4 pages, one
    per writer variant, and every other format): the port parses each
    document to the JAX package's chunks, and each PDF page's chunks hold
    the page's text word for word (the phase's first gate)."""
    import json

    import chip_smoke
    from dial_rag_tpu.documents.mime import detect_mime as jax_detect_mime

    vocab = WordPieceTokenizer.from_vocab_file(str(chip_smoke.CHECKPOINT / "vocab.txt")).vocab
    oracle = [c["text"] for c in json.loads(chip_smoke.ORACLE_CHUNKS.read_text())]
    texts = oracle[:6] + chip_smoke.synthetic_texts(vocab, 6, seed=0)
    extra = chip_smoke.synthetic_texts(vocab, chip_smoke.OFFICE_TEXTS * 6, seed=2)
    docs = chip_smoke.document_corpus(texts, extra, pdf_docs=3,
                                      other_docs=[(fmt, 1) for fmt, _ in chip_smoke.OTHER_DOCS])
    assert [name.rsplit(".", 1)[1] for name, _, _ in docs] == ["pdf"] * 3 + [f for f, _ in chip_smoke.OTHER_DOCS]
    for name, data, page_texts in docs:
        mime, chunks, _ = chip_smoke.parse_one(name, data)
        ref = jax_parse_document(data, jax_detect_mime(None, name, data), source_link=f"files/chip-smoke/{name}",
                                 display_name=name)
        assert pairs(chunks) == pairs(ref), name
        if page_texts is not None:
            assert mime == MIME_PDF and len(page_texts) == 4
            chip_smoke.check_pdf_words(name, chunks, page_texts)
    with pytest.raises(RuntimeError, match="word"):
        chip_smoke.check_pdf_words("manual-00.pdf", parse_document(docs[0][1], MIME_PDF, source_link="x"),
                                   [t + " extra" for t in docs[0][2]])
