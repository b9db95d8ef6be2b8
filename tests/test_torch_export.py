"""The port's checkpoint export and random embedder against the JAX
package's, on the CPU:

- ``models.bert.export_hf_state`` equal to the JAX ``export_hf_state`` key
  for key, bit for bit (the same seeded f32 weights in both), and a round
  trip through ``load_hf_weights`` that gives the weights back bit for bit;
- ``models.safetensors_io.save_file`` -> ``load_file``: F32 bit for bit,
  BF16 as PyTorch rounds f32 to bf16 (to nearest even), integer arrays in
  their own type;
- a checkpoint written by the port (``export_hf_state`` + ``save_file``,
  ``config.json``, ``vocab.txt``) read by the JAX ``from_hf_checkpoint``:
  its embeddings within 2e-5 of the port's (the reference's f32 gate), and
  by the port's ``from_hf_checkpoint``: the same bits as the port's;
- ``BgeEmbedder.from_random``: the JAX ``model_id`` for the same seed,
  widths and vocabulary, and the parameter tree of the JAX ``init_params``
  (names, shapes, dtypes).
"""

import json

import jax
import numpy as np
import pytest
import torch

from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.models.bert import BertConfig as JaxBertConfig
from dial_rag_tpu.models.bert import export_hf_state as jax_export_hf_state
from dial_rag_tpu.models.bert import init_params as jax_init_params
from dial_rag_tpu.models.tokenizer import build_test_vocab
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder, export_hf_state, init_params, load_hf_weights
from dial_rag_tpu_torch.models.safetensors_io import load_file, save_file
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.weights import map_params, params_from_jax_numpy, params_to_numpy

TEXTS = ["glaciers carve valleys", "the alps stretch across eight countries", "abc def"]


@pytest.fixture(scope="module")
def seeded():
    """(JAX params as numpy, the port's params, the vocabulary)."""
    jax_params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(3), JaxBertConfig.tiny()))
    # LayerNorm and biases off their init values, so every leaf is tested
    rng = np.random.default_rng(0)
    jax_params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.01).astype(np.float32), jax_params)
    vocab = build_test_vocab(sorted({w for t in TEXTS for w in t.split()}))
    return jax_params, params_from_jax_numpy(jax_params), vocab


def test_export_hf_state_matches_jax_bit_for_bit(seeded):
    jax_params, params, _ = seeded
    got = export_hf_state(params, BertConfig.tiny())
    want = jax_export_hf_state(jax_params, JaxBertConfig.tiny())
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32, name
        assert got[name].shape == want[name].shape and np.array_equal(got[name], want[name]), name
    back = params_to_numpy(load_hf_weights(got, BertConfig.tiny()))
    flat = []
    map_params(flat.append, jax.tree.map(lambda a, b: np.array_equal(a, b), back, jax_params))
    assert all(flat)


@pytest.mark.parametrize("dtype", ["F32", "BF16"])
def test_save_file_load_file_round_trip(tmp_path, dtype):
    rng = np.random.default_rng(1)
    tensors = {
        "w": rng.standard_normal((7, 5)).astype(np.float32),
        "t": np.ascontiguousarray(rng.standard_normal((5, 3)).astype(np.float32).T),
        "edge": np.array([np.inf, -np.inf, np.nan, 3.4e38, 1e-40, -0.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8], np.float32),
        "ids": np.arange(12, dtype=np.int64).reshape(3, 4),
        "mask": np.array([1, 0, 1], dtype=np.int32),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, dtype=dtype)
    back = load_file(path)
    assert list(back) == list(tensors)
    for name, arr in tensors.items():
        if arr.dtype == np.float32 and dtype == "BF16":
            arr = torch.from_numpy(arr).to(torch.bfloat16).float().numpy()
        assert back[name].dtype == arr.dtype and np.array_equal(back[name], arr, equal_nan=True), name
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0 and header["w"]["dtype"] == dtype and header["ids"]["dtype"] == "I64"
    with pytest.raises(ValueError, match="F32 or BF16"):
        save_file(tensors, path, dtype="F16")


def write_checkpoint(directory, params, config: BertConfig, vocab: dict, dtype: str = "F32") -> None:
    save_file(export_hf_state(params, config), str(directory / "model.safetensors"), dtype=dtype)
    (directory / "config.json").write_text(json.dumps({
        "architectures": ["BertModel"], "model_type": "bert", "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size, "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads, "intermediate_size": config.intermediate_size,
        "max_position_embeddings": config.max_position_embeddings, "type_vocab_size": config.type_vocab_size,
    }))
    (directory / "vocab.txt").write_text("".join(t + "\n" for t in sorted(vocab, key=vocab.get)))


def test_port_checkpoint_serves_in_both_packages(tmp_path, seeded):
    _, params, vocab = seeded
    port = BgeEmbedder(tokenizer=WordPieceTokenizer(vocab=vocab), encoder=BertEncoder(BertConfig.tiny()),
                       params=params, device="cpu")
    write_checkpoint(tmp_path, params, BertConfig.tiny(), vocab)
    want = port.embed_documents(TEXTS)
    back = BgeEmbedder.from_hf_checkpoint(str(tmp_path), compute_dtype=torch.float32, device="cpu")
    assert np.array_equal(back.embed_documents(TEXTS), want)
    assert np.array_equal(back.embed_query(TEXTS[0]), port.embed_query(TEXTS[0]))
    ref = JaxEmbedder.from_hf_checkpoint(str(tmp_path), compute_dtype=jax.numpy.float32)
    assert ref.model_id == back.model_id
    np.testing.assert_allclose(ref.embed_documents(TEXTS), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 7])
def test_from_random_matches_jax_identity_and_tree(seed):
    config = BertConfig.tiny()
    vocab = build_test_vocab([chr(c) for c in range(97, 123)])
    port = BgeEmbedder.from_random(config=config, vocab=vocab, seed=seed, device="cpu")
    ref = JaxEmbedder.from_random(config=JaxBertConfig.tiny(), vocab=vocab, seed=seed)
    assert port.model_id == ref.model_id == f"random-{seed}-64x2v1024-" + port.model_id.rsplit("-", 1)[1]
    assert BgeEmbedder.from_random(device="cpu").model_id == JaxEmbedder.from_random().model_id

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
        return [(prefix, tuple(tree.shape), str(tree.dtype).removeprefix("torch."))]

    raw = init_params(config, torch.Generator().manual_seed(seed))
    assert leaves(raw) == leaves(jax_init_params(jax.random.PRNGKey(seed), JaxBertConfig.tiny()))
    assert leaves(port.params) == leaves(raw)  # f32 compute: prepared as they are
    assert port.embed_documents(TEXTS).shape == (3, 64)
