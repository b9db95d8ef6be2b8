"""The port's first slice end to end against the JAX package on the CPU:
tokenize -> encode -> pool -> dense index -> query.

- a tiny 2-layer config with the JAX parameters fed to the port through
  ``params_from_jax_numpy``: embeddings equal (f32, atol 1e-4);
- the shipped ``checkpoints/alps-semantic`` in f32 on short chunks:
  embeddings equal (atol 1e-4), the same top-k ids, the same model_id.
"""

import asyncio
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.index.dense_index import DenseIndex as JaxDenseIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.models.bert import BertConfig as JaxConfig
from dial_rag_tpu.models.tokenizer import build_test_vocab as jax_build_test_vocab
from dial_rag_tpu_torch.documents.model import build_chunks_list
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder, init_params
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, build_test_vocab
from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever
from dial_rag_tpu_torch.weights import params_from_jax_numpy

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "alps-semantic"
WORDS = "the alps mountain range glacier river valley snow peak rock pass lake".split()


def _texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, size=rng.integers(lo, hi))) for _ in range(n)]


@pytest.mark.parametrize("n_texts", [5, 140])  # one batch; bulk batches of 128
def test_tiny_config_matches_jax(n_texts):
    rng = np.random.default_rng(0)
    vocab = build_test_vocab(WORDS + [chr(c) for c in range(97, 123)])
    assert vocab == jax_build_test_vocab(WORDS + [chr(c) for c in range(97, 123)])
    jax_emb = JaxEmbedder.from_random(config=JaxConfig.tiny(), vocab=vocab, seed=3)
    tree = jax.tree.map(np.asarray, jax_emb.params)
    port = BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=vocab),
        encoder=BertEncoder(BertConfig.tiny()),
        params=params_from_jax_numpy(tree),
        device="cpu",
    )
    texts = _texts(rng, n_texts, 1, 90)
    np.testing.assert_allclose(
        port.embed_documents(texts), jax_emb.embed_documents(texts), atol=1e-4
    )
    queries = _texts(rng, 3, 2, 6)
    np.testing.assert_allclose(
        port.embed_queries(queries), jax_emb.embed_queries(queries), atol=1e-4
    )


@pytest.fixture(scope="module")
def alps_pair():
    jax_emb = JaxEmbedder.from_hf_checkpoint(str(CKPT), compute_dtype=jnp.float32)
    port = BgeEmbedder.from_hf_checkpoint(str(CKPT), compute_dtype=torch.float32, device="cpu")
    return jax_emb, port


def test_alps_checkpoint_matches_jax(alps_pair):
    jax_emb, port = alps_pair
    assert port.model_id == jax_emb.model_id
    assert port.query_instruction == jax_emb.query_instruction == ""
    chunks = json.loads((ROOT / "tests/data/alps_oracle_chunks.json").read_text())
    texts = [c["text"][:300] for c in chunks[:4]]
    queries = ["satellite photo of the alps", "alpine space programme", "shelley atheos"]

    doc_port, doc_jax = port.embed_documents(texts), jax_emb.embed_documents(texts)
    np.testing.assert_allclose(doc_port, doc_jax, atol=1e-4)
    q_port, q_jax = port.embed_queries(queries), jax_emb.embed_queries(queries)
    np.testing.assert_allclose(q_port, q_jax, atol=1e-4)

    records = [type("Record", (), {"embeddings_index": [e[None, :] for e in doc_port]})()]
    retriever = SemanticRetriever.from_doc_records(port, records, k=3)
    jax_index = JaxDenseIndex(
        JaxRetrievalType.TEXT,
        [JaxDocEmbeddings(chunk_ids=np.arange(len(texts)), embeddings=doc_jax)],
        limit=3,
    )
    port_hits = retriever.retrieve_batch(queries)
    for qi in range(len(queries)):
        jax_hits = jax_index.find(q_jax[qi])
        assert [h.chunk_id for h in port_hits[qi]] == [h.chunk_id for h in jax_hits]
        assert [h.chunk_id for h in retriever.retrieve(queries[qi])] == [
            h.chunk_id for h in jax_hits
        ]
    built = asyncio.run(SemanticRetriever.build_index(port, build_chunks_list([(t, {}) for t in texts])))
    np.testing.assert_allclose(np.concatenate(built), doc_port, atol=1e-6)


def test_seeded_init_params_are_deterministic_and_encode():
    cfg = BertConfig.tiny()
    a = init_params(cfg, torch.Generator().manual_seed(7))
    b = init_params(cfg, torch.Generator().manual_seed(7))
    assert torch.equal(a["layers"][1]["qkv"]["kernel"], b["layers"][1]["qkv"]["kernel"])
    assert a["layers"][0]["ffn_in"]["kernel"].shape == (cfg.hidden_size, cfg.intermediate_size)
    vocab = build_test_vocab(WORDS)
    emb = BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=vocab),
        encoder=BertEncoder(cfg),
        params=a,
        device="cpu",
    )
    out = emb.embed_documents(["the alps", "a glacier lake"])
    assert out.shape == (2, cfg.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
