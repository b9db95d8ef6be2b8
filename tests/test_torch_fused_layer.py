"""The port's whole-layer block (``fused_layer_block``, TPU kernel
``_layer_kernel``) and its "fused_layer" route against the JAX package's,
whose Pallas kernel runs in interpret mode on the CPU as
tests/test_fused_encoder.py runs it. On a CPU tensor the port's block runs
the plain version that the CUDA kernel is held to on the card
(tests/test_torch_kernels_cuda.py). Same numpy inputs from a seed.

Tolerances, those of tests/test_fused_encoder.py:141-200: the block f32
3e-5 and bf16 4e-2; its gradients (f32) atol 1e-4, rtol 1e-3; the encoder
route 6e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dial_rag_tpu.models.bert import BertConfig as JaxConfig
from dial_rag_tpu.models.bert import bert_forward as jax_bert_forward
from dial_rag_tpu.models.bert import init_params as jax_init_params
from dial_rag_tpu.ops import fused_encoder as jfe
from dial_rag_tpu_torch.models.bert import bert_forward
from dial_rag_tpu_torch.ops import fused_encoder as tfe
from dial_rag_tpu_torch.weights import params_from_jax_numpy

H, HEADS, INTER = 64, 2, 128


def _weights(rng):
    """The reference's 12-tuple, f32 numpy."""
    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ln = [np.ones(H, np.float32), np.zeros(H, np.float32)]
    attn = [w(H, 3 * H, scale=0.05), w(3 * H, scale=0.02), w(H, H, scale=0.05), w(H, scale=0.02), *ln]
    ffn = [w(H, INTER, scale=0.05), w(INTER, scale=0.02), w(INTER, H, scale=0.05), w(H, scale=0.02), *ln]
    return attn + ffn


def _inputs(seed, b, s, np_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H)).astype(np.float32).astype(np_dtype)
    mask = np.ones((b, s), np.int32)
    mask[-1, s // 2 :] = 0
    return x, mask, _weights(rng)


@pytest.mark.parametrize(
    "np_dtype,t_dtype,atol", [(np.float32, torch.float32, 3e-5), (ml_dtypes.bfloat16, torch.bfloat16, 4e-2)]
)
def test_layer_block_matches_jax(np_dtype, t_dtype, atol):
    b, s = 2, 48
    x, mask, w = _inputs(0, b, s, np_dtype)
    ref = jfe.fused_layer_block(jnp.asarray(x), jnp.asarray(mask), tuple(map(jnp.asarray, w)), HEADS)
    tfe.reset_launches()
    out = tfe.fused_layer_block(torch.from_numpy(np.asarray(x, np.float32)).to(t_dtype), torch.from_numpy(mask),
                                [torch.from_numpy(a) for a in w], HEADS)
    assert out.dtype == t_dtype and out.shape == x.shape
    assert tfe.LAUNCHES["fused_layer_block"] == 0  # the CPU runs the plain version
    ref = np.asarray(ref, np.float32)
    # pad query rows are garbage in both; compare the real tokens
    np.testing.assert_allclose(out[0].float().numpy(), ref[0], atol=atol)
    np.testing.assert_allclose(out[1, : s // 2].float().numpy(), ref[1, : s // 2], atol=atol)


def test_layer_block_plain_is_the_two_blocks():
    """The plain version is the attention block, its output in the compute
    type, then the FFN block: the layer kernel's cast points."""
    x, mask, w = _inputs(1, 2, 32, ml_dtypes.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    wt = [torch.from_numpy(a) for a in w]
    a = tfe.fused_attention_block_plain(xt, torch.from_numpy(mask), *wt[:6], HEADS)
    assert a.dtype == torch.bfloat16
    want = tfe.fused_ffn_block_plain(a, *wt[6:])
    assert torch.equal(tfe.fused_layer_block_plain(xt, torch.from_numpy(mask), wt, HEADS), want)


def test_layer_block_gradients_match_jax():
    """The recompute backward (autograd through the plain version) against
    ``jax.vjp`` of the reference block (its ``_layer_bwd``), f32."""
    b, s = 2, 16
    x, mask, w = _inputs(2, b, s)
    cot = np.random.default_rng(3).standard_normal((b, s, H)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: jfe.fused_layer_block(x, jnp.asarray(mask), w, HEADS),
                     jnp.asarray(x), tuple(map(jnp.asarray, w)))
    j_dx, j_dw = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    (tfe.fused_layer_block(xt, torch.from_numpy(mask), wt, HEADS) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), atol=1e-4, rtol=1e-3)
    for t, g in zip(wt, j_dw):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-3)


def _tiny():
    config = JaxConfig(vocab_size=256, hidden_size=H, num_layers=2, num_heads=HEADS, intermediate_size=INTER,
                       max_position_embeddings=128)
    jparams = jax_init_params(jax.random.PRNGKey(5), config)
    rng = np.random.default_rng(6)
    ids = rng.integers(5, config.vocab_size, size=(2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 25:] = 0
    return config, jparams, ids, mask


@pytest.mark.parametrize("impl", ["fused_layer", "fused_layer_plain"])
def test_bert_forward_fused_layer_route_matches_jax(impl):
    """JAX ``bert_forward(attention_impl="fused_layer")`` against the
    port's whole-layer routes, bf16 with tanh GELU (the routes' contract)."""
    config, jparams, ids, mask = _tiny()
    kw = dict(num_heads=config.num_heads, gelu="tanh")
    ref = jax_bert_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), compute_dtype=jnp.bfloat16,
                           attention_impl="fused_layer", **kw)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    out = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       compute_dtype=torch.bfloat16, attention_impl=impl, **kw)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out[0].float().numpy(), ref[0], atol=6e-2)
    np.testing.assert_allclose(out[1, :25].float().numpy(), ref[1, :25], atol=6e-2)


def test_bert_forward_fused_layer_route_gradients_match_jax():
    """Gradients of sum(hidden**2) with respect to every parameter through
    the "fused_layer" route, f32 with tanh GELU, against JAX's route."""
    config, jparams, ids, mask = _tiny()
    kw = dict(num_heads=config.num_heads, gelu="tanh")

    def jax_loss(p):
        return jnp.sum(jax_bert_forward(p, jnp.asarray(ids), jnp.asarray(mask), attention_impl="fused_layer",
                                        **kw) ** 2)

    j_grads = jax.grad(jax_loss)(jparams)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    leaves = jax.tree.leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for t in leaves:
        t.requires_grad_(True)
    hidden = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          attention_impl="fused_layer", **kw)
    (hidden**2).sum().backward()
    for t, g in zip(leaves, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-3)


def test_fused_layer_route_checks_its_contract():
    config, jparams, ids, mask = _tiny()
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    with pytest.raises(ValueError, match="tanh"):
        bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask), num_heads=HEADS,
                     attention_impl="fused_layer", gelu="exact")
