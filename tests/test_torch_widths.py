"""The port at bge-base proportions (head_dim 64) against the JAX package,
on the CPU, and the kernels' support predicate.

bge-base-en-v1.5, e5-base-v2 and gte-base run H = 768 with 12 heads of 64;
the CUDA kernels are instantiated for that width beside bge-small's (H 384,
12 heads of 32), in f32 and bf16. Here a small config keeps the head
width of 64 (H = 128, 2 heads, 2 layers, FFN 512, S = 64): the same numpy
inputs go through the JAX functions (Pallas in interpret mode, as the
reference's own tests run them) and the port's (their plain versions on
a CPU tensor, the arithmetic the kernels are held to on the card).

Tolerances: the reference's own (tests/test_fused_encoder.py: f32 2e-5,
bf16 3e-2; tests/test_flash_attention.py: forward 2e-6, gradients atol
5e-5, rtol 1e-4); bf16 attention gradients 3e-2 of each batch row's
largest reference value (gradients are not O(1)); whole encoders and
embeddings as tests/test_torch_slice.py holds them (atol 1e-4 for f32
embeddings), bf16 hidden states 3e-2 of their O(1) LayerNorm scale.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.index.dense_index import DenseIndex as JaxDenseIndex
from dial_rag_tpu.index.dense_index import DocEmbeddings as JaxDocEmbeddings
from dial_rag_tpu.index.records import RetrievalType as JaxRetrievalType
from dial_rag_tpu.models.bert import BertConfig as JaxConfig
from dial_rag_tpu.models.bert import bert_forward as jax_bert_forward
from dial_rag_tpu.models.bert import init_params as jax_init_params
from dial_rag_tpu.models.tokenizer import build_test_vocab as jax_build_test_vocab
from dial_rag_tpu.ops import flash_attention as jfa
from dial_rag_tpu.ops import fused_encoder as jfe
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder, bert_forward
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, build_test_vocab
from dial_rag_tpu_torch.ops import flash_attention as tfa
from dial_rag_tpu_torch.ops import fused_encoder as tfe
from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever
from dial_rag_tpu_torch.weights import params_from_jax_numpy

ROOT = Path(__file__).resolve().parent.parent
B, S, H, HEADS, DH, INTER, LAYERS = 2, 64, 128, 2, 64, 512, 2
DTYPES = {
    "f32": (np.float32, torch.float32, jnp.float32, 2e-5),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16, 3e-2),
}
WORDS = "the alps mountain range glacier river valley snow peak rock pass lake".split()


def _config(jax=False, vocab_size=1024):
    cls = JaxConfig if jax else BertConfig
    return cls(vocab_size=vocab_size, hidden_size=H, num_layers=LAYERS, num_heads=HEADS,
               intermediate_size=INTER, max_position_embeddings=1024)


def _layer_weights(rng):
    """The reference's 12-tuple of one layer's weights, numpy f32."""
    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ones, zeros = np.ones(H, np.float32), np.zeros(H, np.float32)
    return (w(H, 3 * H, scale=0.05), w(3 * H, scale=0.02), w(H, H, scale=0.05), w(H, scale=0.02), ones, zeros,
            w(H, INTER, scale=0.05), w(INTER, scale=0.02), w(INTER, H, scale=0.05), w(H, scale=0.02), ones, zeros)


def _block_fns(name):
    """(port function, JAX function) of one fused block, as
    f(x, mask, weights, num_heads)."""
    if name == "attention":
        return (lambda x, m, w, h: tfe.fused_attention_block(x, m, *w[:6], h),
                lambda x, m, w, h: jfe.fused_attention_block(x, m, *w[:6], h))
    if name == "ffn":
        return (lambda x, m, w, h: tfe.fused_ffn_block(x, *w[6:]),
                lambda x, m, w, h: jfe.fused_ffn_block(x, *w[6:]))
    return tfe.fused_layer_block, jfe.fused_layer_block


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block", ["attention", "ffn", "layer"])
def test_fused_blocks_at_head_dim_64_match_jax(block, dtype):
    np_dtype, t_dtype, _, atol = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, H)).astype(np.float32).astype(np_dtype)
    weights = _layer_weights(rng)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 3 :] = 0
    port_fn, jax_fn = _block_fns(block)
    ref = jax_fn(jnp.asarray(x), jnp.asarray(mask), tuple(map(jnp.asarray, weights)), HEADS)
    out = port_fn(torch.from_numpy(np.asarray(x, np.float32)).to(t_dtype), torch.from_numpy(mask),
                  tuple(torch.from_numpy(w) for w in weights), HEADS)
    assert out.dtype == t_dtype and out.shape == x.shape
    # the attention's pad query rows are garbage in both; compare real tokens
    real = mask.astype(bool) if block != "ffn" else np.ones_like(mask, bool)
    np.testing.assert_allclose(out.float().numpy()[real], np.asarray(ref, np.float32)[real], atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ffn_block_at_bge_large_width_matches_jax(dtype):
    """The FFN block at bge-large's width (H 1024, FFN 4096), which the bf16
    and f32 FFN kernels take, as kernels 1 and 3 do: the port's plain version
    (the kernel's yardstick on the card) against the reference's Pallas
    kernel in interpret mode on 48 rows; f32 2e-5, bf16 3e-2."""
    np_dtype, t_dtype, _, atol = DTYPES[dtype]
    hid, inter = 1024, 4096
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 24, hid)).astype(np.float32).astype(np_dtype)
    w = [(rng.standard_normal(shape) * scale).astype(np.float32)
         for shape, scale in (((hid, inter), 0.05), ((inter,), 0.02), ((inter, hid), 0.05), ((hid,), 0.02))]
    w += [np.ones(hid, np.float32), np.zeros(hid, np.float32)]
    ref = jfe.fused_ffn_block(jnp.asarray(x), *map(jnp.asarray, w))
    out = tfe.fused_ffn_block(torch.from_numpy(np.asarray(x, np.float32)).to(t_dtype), *map(torch.from_numpy, w))
    assert out.dtype == t_dtype and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=atol)


LARGE_HID, LARGE_HEADS, LARGE_INTER = 1024, 16, 4096


def _large_case(dtype, seed):
    """x [2, 24, 1024] in ``dtype``, a ragged mask and one layer's weights
    (the reference's 12-tuple, numpy f32) at bge-large's widths."""
    np_dtype = DTYPES[dtype][0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, LARGE_HID)).astype(np.float32).astype(np_dtype)
    mask = np.ones((2, 24), np.int32)
    mask[1, 9:] = 0

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ones, zeros = np.ones(LARGE_HID, np.float32), np.zeros(LARGE_HID, np.float32)
    weights = (w(LARGE_HID, 3 * LARGE_HID, scale=0.05), w(3 * LARGE_HID, scale=0.02),
               w(LARGE_HID, LARGE_HID, scale=0.05), w(LARGE_HID, scale=0.02), ones, zeros,
               w(LARGE_HID, LARGE_INTER, scale=0.05), w(LARGE_INTER, scale=0.02),
               w(LARGE_INTER, LARGE_HID, scale=0.05), w(LARGE_HID, scale=0.02), ones, zeros)
    return x, mask, weights


def _large_block_matches_jax(block, dtype, seed):
    """The port's plain version of ``block`` (the kernel's yardstick on the
    card) against the reference's Pallas kernel in interpret mode at
    bge-large's widths, 16 heads of 64, on the real tokens."""
    _, t_dtype, _, atol = DTYPES[dtype]
    x, mask, weights = _large_case(dtype, seed)
    port_fn, jax_fn = _block_fns(block)
    ref = jax_fn(jnp.asarray(x), jnp.asarray(mask), tuple(map(jnp.asarray, weights)), LARGE_HEADS)
    out = port_fn(torch.from_numpy(np.asarray(x, np.float32)).to(t_dtype), torch.from_numpy(mask),
                  tuple(torch.from_numpy(w) for w in weights), LARGE_HEADS)
    assert out.dtype == t_dtype and out.shape == x.shape
    real = mask.astype(bool)
    np.testing.assert_allclose(out.float().numpy()[real], np.asarray(ref, np.float32)[real], atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_block_at_bge_large_width_matches_jax(dtype):
    """Kernel 1's function at H 1024 (16 heads of 64), the width its bf16
    and f32 kernels take: f32 2e-5, bf16 3e-2, a ragged mask."""
    _large_block_matches_jax("attention", dtype, seed=13)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_block_at_bge_large_width_matches_jax(dtype):
    """Kernel 3's function at H 1024 (16 heads of 64, FFN 4096), the width
    its bf16 and f32 kernels take: f32 2e-5, bf16 3e-2, a ragged mask."""
    _large_block_matches_jax("layer", dtype, seed=14)


def _attention_case(layout, s, dtype, seed):
    """Outputs and gradients of sum(out * cot) of both packages' attention
    (``fused_qkv``: packed [B, S, 3H]; ``flash``: head-major [B, h, S, 64])
    on the same inputs in ``dtype``."""
    np_dtype, t_dtype, _, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, s, 3 * H)).astype(np.float32).astype(np_dtype)
    mask = np.ones((B, s), np.int32)
    mask[1, s // 2 :] = 0
    cot = rng.standard_normal((B, s, H)).astype(np.float32)
    if layout == "fused_qkv":
        xs, cot_l = [qkv], cot
        port_fn = lambda ts, m: tfa.fused_qkv_attention(ts[0], m, HEADS)  # noqa: E731
        jax_fn = lambda ys, m: jfa.fused_qkv_attention(ys[0], m, HEADS)  # noqa: E731
    else:
        q5 = qkv.reshape(B, s, 3, HEADS, DH)
        xs = [np.ascontiguousarray(q5[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)]
        cot_l = np.ascontiguousarray(cot.reshape(B, s, HEADS, DH).transpose(0, 2, 1, 3))
        port_fn = lambda ts, m: tfa.flash_attention(*ts, m)  # noqa: E731
        jax_fn = lambda ys, m: jfa.flash_attention(*ys, m)  # noqa: E731
    leaves = [torch.from_numpy(np.asarray(x, np.float32)).to(t_dtype).requires_grad_(True) for x in xs]
    out = port_fn(leaves, torch.from_numpy(mask))
    (out.float() * torch.from_numpy(cot_l)).sum().backward()
    j_mask = jnp.asarray(mask)
    j_xs = [jnp.asarray(x) for x in xs]
    j_out = jax_fn(j_xs, j_mask)
    j_grads = jax.grad(
        lambda *ys: jnp.sum(jax_fn(list(ys), j_mask).astype(jnp.float32) * cot_l), argnums=tuple(range(len(xs)))
    )(*j_xs)
    return (out.detach().float().numpy(), np.asarray(j_out, np.float32),
            [t.grad.float().numpy() for t in leaves], [np.asarray(g, np.float32) for g in j_grads])


@pytest.mark.parametrize("s", [64, 520])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["fused_qkv", "flash"])
def test_attention_at_head_dim_64_matches_jax(layout, dtype, s):
    """Kernels 4 (packed qkv) and 5 (head-major) forward and kernel 8
    backward at head_dim 64, f32 and bf16, at S = 64 and at S = 520 (one
    tile past 512, not a multiple of 256: still single-tile in both)."""
    out, ref, grads, ref_grads = _attention_case(layout, s, dtype, seed=s + (dtype == "bf16"))
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, atol=2e-6)
        for g, r in zip(grads, ref_grads):
            np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(out, ref, atol=3e-2)
        for g, r in zip(grads, ref_grads):
            for row in range(B):
                assert np.abs(g[row] - r[row]).max() <= 3e-2 * np.abs(r[row]).max()


@pytest.mark.parametrize(
    "dtype,gelu,jax_impl,port_impl",
    [("f32", "tanh", "fused", "fused_plain"), ("bf16", "exact", "pallas", "pallas_plain")],
)
def test_bert_forward_at_head_dim_64_matches_jax(dtype, gelu, jax_impl, port_impl):
    """The two routes "auto" now runs on the card that it used to refuse:
    (f32, tanh) -> the fused blocks, (bf16, exact) -> the layout-native
    attention; each against the reference's own route, whole encoder."""
    _, t_dtype, j_dtype, _ = DTYPES[dtype]
    config = _config(jax=True)
    jparams = jax_init_params(jax.random.PRNGKey(2), config)
    rng = np.random.default_rng(5)
    ids = rng.integers(5, config.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    ref = jax_bert_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), num_heads=HEADS, compute_dtype=j_dtype,
                           attention_impl=jax_impl, gelu=gelu)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    out = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask), num_heads=HEADS,
                       compute_dtype=t_dtype, attention_impl=port_impl, gelu=gelu)
    assert out.dtype == t_dtype
    real = mask.astype(bool)
    np.testing.assert_allclose(out.float().numpy()[real], np.asarray(ref, np.float32)[real],
                               atol=1e-5 if dtype == "f32" else 3e-2)


def test_base_shaped_slice_matches_jax():
    """embed -> index -> query at head_dim 64: the same embeddings and the
    same top-k as the JAX embedder and dense index."""
    vocab = build_test_vocab(WORDS + [chr(c) for c in range(97, 123)])
    assert vocab == jax_build_test_vocab(WORDS + [chr(c) for c in range(97, 123)])
    jax_emb = JaxEmbedder.from_random(config=_config(jax=True, vocab_size=len(vocab)), vocab=vocab, seed=4)
    port = BgeEmbedder(tokenizer=WordPieceTokenizer(vocab=vocab),
                       encoder=BertEncoder(_config(vocab_size=len(vocab))),
                       params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_emb.params)), device="cpu")
    rng = np.random.default_rng(6)
    texts = [" ".join(rng.choice(WORDS, size=rng.integers(3, 40))) for _ in range(12)]
    queries = [" ".join(rng.choice(WORDS, size=rng.integers(2, 6))) for _ in range(4)]
    doc_port, doc_jax = port.embed_documents(texts), jax_emb.embed_documents(texts)
    np.testing.assert_allclose(doc_port, doc_jax, atol=1e-4)
    q_port, q_jax = port.embed_queries(queries), jax_emb.embed_queries(queries)
    np.testing.assert_allclose(q_port, q_jax, atol=1e-4)
    records = [type("Record", (), {"embeddings_index": [e[None, :] for e in doc_port]})()]
    hits = SemanticRetriever.from_doc_records(port, records, k=3).retrieve_batch(queries)
    jax_index = JaxDenseIndex(JaxRetrievalType.TEXT,
                              [JaxDocEmbeddings(chunk_ids=np.arange(len(texts)), embeddings=doc_jax)], limit=3)
    for qi in range(len(queries)):
        assert [h.chunk_id for h in hits[qi]] == [h.chunk_id for h in jax_index.find(q_jax[qi])]


def test_from_hf_checkpoint_at_base_proportions(tmp_path):
    """A plain HF BertModel directory whose config.json has bge-base's
    proportions (heads of 64, FFN 4H, 512 positions; narrow and shallow
    here): both packages read the same config, model_id and embeddings."""
    vocab_path = ROOT / "checkpoints" / "alps-semantic" / "vocab.txt"
    shutil.copy(vocab_path, tmp_path / "vocab.txt")
    n_vocab = sum(1 for _ in vocab_path.open())
    hf = {"architectures": ["BertModel"], "model_type": "bert", "vocab_size": n_vocab, "hidden_size": H,
          "num_hidden_layers": LAYERS, "num_attention_heads": HEADS, "intermediate_size": 4 * H,
          "max_position_embeddings": 512, "type_vocab_size": 2, "do_lower_case": True}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    rng = np.random.default_rng(8)

    def t(*shape, scale=0.02):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    state = {"embeddings.word_embeddings.weight": t(n_vocab, H),
             "embeddings.position_embeddings.weight": t(512, H),
             "embeddings.token_type_embeddings.weight": t(2, H),
             "embeddings.LayerNorm.weight": torch.ones(H), "embeddings.LayerNorm.bias": torch.zeros(H)}
    for i in range(LAYERS):
        p = f"encoder.layer.{i}."
        for name, (n_out, n_in) in {"attention.self.query": (H, H), "attention.self.key": (H, H),
                                    "attention.self.value": (H, H), "attention.output.dense": (H, H),
                                    "intermediate.dense": (4 * H, H), "output.dense": (H, 4 * H)}.items():
            state[p + name + ".weight"], state[p + name + ".bias"] = t(n_out, n_in, scale=0.05), t(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[p + name + ".weight"], state[p + name + ".bias"] = torch.ones(H), torch.zeros(H)
    torch.save(state, tmp_path / "pytorch_model.bin")

    jax_emb = JaxEmbedder.from_hf_checkpoint(str(tmp_path), compute_dtype=jnp.float32)
    port = BgeEmbedder.from_hf_checkpoint(str(tmp_path), compute_dtype=torch.float32, device="cpu")
    cfg = port.encoder.config
    assert (cfg.hidden_size // cfg.num_heads, cfg.intermediate_size) == (64, 4 * H)
    assert cfg.hidden_size == jax_emb.encoder.config.hidden_size and cfg.num_heads == jax_emb.encoder.config.num_heads
    assert port.model_id == jax_emb.model_id
    texts = ["the alps are the highest mountain range in europe", "glaciers carve valleys"]
    np.testing.assert_allclose(port.embed_documents(texts), jax_emb.embed_documents(texts), atol=1e-4)


SUPPORTED = [(torch.float32, 384, 32), (torch.float32, 768, 64), (torch.float32, 1024, 64),
             (torch.bfloat16, 384, 32), (torch.bfloat16, 768, 64), (torch.bfloat16, 1024, 64)]
UNSUPPORTED = [(torch.float16, 384, 32), (torch.float32, 512, 64), (torch.bfloat16, 768, 32),
               (torch.float32, 1024, 32), (torch.bfloat16, 512, 64)]
# the FFN kernel's (dtype, H): the same widths without a head width
FFN_SUPPORTED = [(d, h) for d, h, _ in SUPPORTED]


@pytest.mark.parametrize("dtype,hidden,head_dim", SUPPORTED + UNSUPPORTED)
def test_kernel_support_predicate(dtype, hidden, head_dim):
    """The kernels take f32 and bf16 at (H 384, head_dim 32), (H 768,
    head_dim 64) and (H 1024, head_dim 64); anything else raises a
    ValueError naming that set. The FFN kernel, which has no head width,
    takes the (dtype, H) pairs of that set."""
    assert tfe.kernel_supports(dtype, hidden, head_dim) == ((dtype, hidden, head_dim) in SUPPORTED)
    if (dtype, hidden, head_dim) in SUPPORTED:
        tfe.check_kernel_supports(dtype, hidden, head_dim)
        assert tfe.kernel_supports(dtype, hidden) and tfe.kernel_supports(dtype, head_dim=head_dim)
    else:
        with pytest.raises(ValueError) as err:
            tfe.check_kernel_supports(dtype, hidden, head_dim)
        for d, h, dh in SUPPORTED:
            assert f"({str(d)[6:]}, H {h}, head_dim {dh})" in str(err.value)
    assert tfe.kernel_supports(dtype, hidden) == ((dtype, hidden) in FFN_SUPPORTED)
    if (dtype, hidden) not in FFN_SUPPORTED:
        with pytest.raises(ValueError) as err:
            tfe.check_kernel_supports(dtype, hidden)
        for d, h, dh in SUPPORTED:
            assert f"({str(d)[6:]}, H {h}, head_dim {dh})" in str(err.value)
