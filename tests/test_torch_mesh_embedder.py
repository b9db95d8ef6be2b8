"""The port's data-parallel embedder (``BgeEmbedder.shard_over``) against
the JAX package's, on the CPU.

One case for each test of tests/test_mesh_embedder.py, under its name: the
JAX embedder's seeded weights carried to the port
(``weights.params_from_jax_numpy``), the port's embedder sharded over a
mesh of 8 CPU slots (``[cpu] * 8``), the JAX one over the conftest's 8
host devices, and the outputs held to each other and to the unsharded
embedders at the JAX tests' rtol 1e-5, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.models.bert import BertEncoder as JaxBertEncoder
from dial_rag_tpu.models.tokenizer import build_test_vocab
from dial_rag_tpu.parallel import mesh as jax_mesh_mod
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.parallel.mesh import create_mesh, dp_slots
from dial_rag_tpu_torch.weights import params_from_jax_numpy

TOL = {"rtol": 1e-5, "atol": 1e-6}


@pytest.fixture(scope="module")
def jax_single():
    return JaxEmbedder.from_random(vocab=build_test_vocab([chr(c) for c in range(97, 123)]), batch_size=8)


@pytest.fixture(scope="module")
def single(jax_single):
    return BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=jax_single.tokenizer.vocab),
        encoder=BertEncoder(BertConfig.tiny()),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_single.params)),
        device="cpu",
        batch_size=jax_single.batch_size,
    )


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(8, tp=1, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8
    return jax_mesh_mod.create_mesh(8, tp=1)


def test_sharded_matches_single(single, jax_single, mesh, jmesh):
    sharded = single.shard_over(mesh)
    texts = [f"word{i} abc def" for i in range(13)]  # not a dp multiple
    a = single.embed_documents(texts)
    b = sharded.embed_documents(texts)
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(b, jax_single.shard_over(jmesh).embed_documents(texts), **TOL)
    # one replica of the weights: the mesh names one device eight times
    assert list(sharded.replicas) == [torch.device("cpu")]
    assert single.mesh is None and sharded.mesh is mesh


def test_sharded_query(single, jax_single, mesh, jmesh):
    sharded = single.shard_over(mesh)
    got = sharded.embed_query("abc def")
    np.testing.assert_allclose(got, single.embed_query("abc def"), **TOL)
    np.testing.assert_allclose(got, jax_single.shard_over(jmesh).embed_query("abc def"), **TOL)
    # the query encode's rows pad to a multiple of dp (a lone batch of 8)
    out, n = sharded._embed_queries_wave(["abc def", "ghi"])
    assert (tuple(out.shape), n) == ((8, single.dim), 2)


def test_batch_actually_sharded(single, jax_single, mesh, jmesh):
    sharded = single.shard_over(mesh)
    ids = np.zeros((16, 64), dtype=np.int32)
    mask = np.ones((16, 64), dtype=np.int32)
    dev_ids, _ = jax_single.shard_over(jmesh)._device_put_batch(ids, mask)
    assert len(dev_ids.sharding.device_set) == 8
    seen = []

    def record(params, ids_t, mask_t):
        seen.append((ids_t.device, ids_t.shape[0], params is sharded.replicas[ids_t.device]))
        return ids_t.float()

    out = sharded._run_rows(np.arange(16 * 64).reshape(16, 64), mask, record)
    assert seen == [(torch.device("cpu"), 2, True)] * 8  # eight dp slots of 2 rows
    np.testing.assert_array_equal(out.numpy(), np.arange(16 * 64).reshape(16, 64))  # gathered in row order
    assert [(str(d), s.start, s.stop) for d, s in dp_slots(mesh, 16)] == [
        ("cpu", 2 * i, 2 * i + 2) for i in range(8)
    ]


def test_embed_documents_device_matches_host(single, jax_single, mesh):
    texts = [f"doc {i} abc def ghi" for i in range(21)]  # ragged last batch
    host = single.embed_documents(texts)
    for emb in (single, single.shard_over(mesh)):
        dev = emb.embed_documents_device(texts)
        assert isinstance(dev, torch.Tensor) and tuple(dev.shape) == host.shape
        np.testing.assert_allclose(dev.numpy(), host, **TOL)
    np.testing.assert_allclose(host, np.asarray(jax_single.embed_documents_device(texts)), **TOL)


def test_from_device_matrix_matches_host_index(single, mesh):
    texts = [f"word{i} abc" for i in range(17)]
    emb_host = single.embed_documents(texts)
    host_index = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(len(texts)), emb_host)], limit=5,
                            device="cpu")
    q = emb_host[3]
    for emb in (single, single.shard_over(mesh)):
        dev_index = DenseIndex.from_device_matrix(RetrievalType.TEXT, emb.embed_documents_device(texts), limit=5)
        assert [h.chunk_id for h in dev_index.find(q)] == [h.chunk_id for h in host_index.find(q)]


def test_shard_over_rounds_batch_size_to_dp_multiple(single, jax_single, mesh, jmesh):
    odd = dataclasses.replace(single, batch_size=10).shard_over(mesh)  # not a multiple of dp=8
    jodd = dataclasses.replace(jax_single, batch_size=10).shard_over(jmesh)
    assert odd.batch_size == jodd.batch_size == 16
    texts = [f"doc {i} abc" for i in range(23)]
    out = odd.embed_documents(texts)
    assert out.shape[0] == 23
    np.testing.assert_allclose(out, jodd.embed_documents(texts), **TOL)
    np.testing.assert_allclose(out, single.embed_documents(texts), **TOL)


def test_mixed_bucket_group_matches_per_text(single, jax_single, mesh):
    """Batches in different sequence buckets encode each at its own width;
    the outputs are a text's alone."""
    short = ["ab cd"] * single.batch_size
    long = ["ab " * 40] * single.batch_size  # a higher bucket
    texts = (short + long) * 2 + short[:3]
    for emb in (single, single.shard_over(mesh)):
        host = emb.embed_documents(texts)
        per_text = np.concatenate([single.embed_documents(texts[i : i + 1]) for i in range(7)])
        np.testing.assert_allclose(host[:7], per_text, **TOL)
        assert host.shape == (len(texts), single.dim)
        np.testing.assert_allclose(host, jax_single.embed_documents(texts), **TOL)


def test_packed_transfer_matches_wide(single, jax_single, mesh, jmesh):
    """The port ships a batch's ids and mask as tensors in one layout; its
    sharded outputs (ragged last batch, mixed-bucket batches) are the JAX
    package's packed layout's, sharded and not, and its own unsharded
    ones."""
    packed = dataclasses.replace(jax_single, transfer_format="packed")
    sharded = single.shard_over(mesh)
    texts = [f"word{i} abc def ghi" for i in range(29)]  # ragged
    mixed = ["ab cd"] * single.batch_size + ["ab " * 40] * (single.batch_size + 3)
    for batch in (texts, mixed):
        got = sharded.embed_documents(batch)
        np.testing.assert_allclose(got, single.embed_documents(batch), **TOL)
        np.testing.assert_allclose(got, packed.embed_documents(batch), **TOL)
        np.testing.assert_allclose(got, packed.shard_over(jmesh).embed_documents(batch), **TOL)
    np.testing.assert_allclose(sharded.embed_documents_device(texts).numpy(),
                               np.asarray(packed.embed_documents_device(texts)), **TOL)


def test_idf_pooling_shards_like_cls(single, jax_single, mesh, jmesh):
    """idf pooling's [V] weight table rides the params: shard_over
    replicates it with the rest and the embeddings are the unsharded
    idf path's."""
    rng = np.random.default_rng(9)
    table = (rng.random(len(single.tokenizer.vocab)) + 0.05).astype(np.float32)
    idf_single = dataclasses.replace(
        single,
        encoder=BertEncoder(single.encoder.config, compute_dtype=single.encoder.compute_dtype, pooling="idf"),
        params={**single.params, "pooling_idf": torch.from_numpy(table)},
        query_instruction="",
    )
    jidf = dataclasses.replace(
        jax_single,
        encoder=JaxBertEncoder(jax_single.encoder.config, compute_dtype=jax_single.encoder.compute_dtype,
                               pooling="idf"),
        params={**jax_single.params, "pooling_idf": jnp.asarray(table)},
        query_instruction="",
    )
    sharded = idf_single.shard_over(mesh)
    assert "pooling_idf" in sharded.replicas[torch.device("cpu")]
    texts = [f"word{i} abc def" for i in range(11)]  # not a dp multiple
    a = idf_single.embed_documents(texts)
    b = sharded.embed_documents(texts)
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(b, jidf.shard_over(jmesh).embed_documents(texts), **TOL)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)
