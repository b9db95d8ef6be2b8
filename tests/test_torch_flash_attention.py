"""The port's single-tile attention (``dial_rag_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_flash_attention.py runs them. On a CPU tensor the port's
autograd functions take their plain versions, so this holds their
arithmetic (forward and hand-written recompute-P backward) to the TPU
kernels'; tests/test_torch_kernels_cuda.py holds the CUDA kernels to the
same plain versions on the card.

Tolerances: forward atol 2e-6 and gradients atol 5e-5, rtol 1e-4, the
reference's own (tests/test_flash_attention.py); the encoder's hidden
states atol 1e-5, the reference's pallas-vs-xla encoder tolerance.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.models.bert import BertConfig as JaxConfig
from dial_rag_tpu.models.bert import bert_forward as jax_bert_forward
from dial_rag_tpu.models.bert import init_params as jax_init_params
from dial_rag_tpu.ops import flash_attention as jfa
from dial_rag_tpu_torch.models.bert import _pallas_attention, bert_forward, resolve_attention_impl
from dial_rag_tpu_torch.ops import flash_attention as tfa
from dial_rag_tpu_torch.weights import params_from_jax_numpy

B, HEADS, DH = 2, 4, 32


def _inputs(s, seed, masked_row=False):
    """Packed qkv [B, S, 3H] f32, a mask with row 1 half masked (row 1
    fully masked with ``masked_row``) and a cotangent [B, S, H]."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, s, 3 * HEADS * DH)).astype(np.float32)
    mask = np.ones((B, s), np.int32)
    mask[1, s // 2 :] = 0
    if masked_row:
        mask[1] = 0
    cot = rng.standard_normal((B, s, HEADS * DH)).astype(np.float32)
    return qkv, mask, cot


def _heads(a):
    """[B, S, 3H] numpy -> three [B, h, S, Dh] numpy arrays."""
    b, s, _ = a.shape
    a5 = a.reshape(b, s, 3, HEADS, DH)
    return [np.ascontiguousarray(a5[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)]


def _cot_heads(cot):
    b, s, _ = cot.shape
    return np.ascontiguousarray(cot.reshape(b, s, HEADS, DH).transpose(0, 2, 1, 3))


# (port function, JAX function) on the same numpy inputs: qkv packed, or
# q, k, v head-major; the cotangent in the matching layout
LAYOUTS = {
    "fused_qkv": (
        lambda xs, mask: tfa.fused_qkv_attention(xs[0], mask, HEADS),
        lambda xs, mask: jfa.fused_qkv_attention(xs[0], mask, HEADS),
        lambda qkv: [qkv],
        lambda cot: cot,
    ),
    "flash": (
        lambda xs, mask: tfa.flash_attention(*xs, mask),
        lambda xs, mask: jfa.flash_attention(*xs, mask),
        _heads,
        _cot_heads,
    ),
}


def _run_both(layout, s, seed, masked_row=False, grads=True):
    """Outputs of both packages, and with ``grads`` the gradients of
    sum(out * cot) with respect to every input."""
    port_fn, jax_fn, split, split_cot = LAYOUTS[layout]
    qkv, mask, cot = _inputs(s, seed, masked_row)
    xs, cot = split(qkv), split_cot(cot)

    t_xs = [torch.from_numpy(x).requires_grad_(grads) for x in xs]
    t_mask = torch.from_numpy(mask)
    out = port_fn(t_xs, t_mask)
    j_mask = jnp.asarray(mask)
    j_out = jax_fn([jnp.asarray(x) for x in xs], j_mask)
    if not grads:
        return out.detach().numpy(), np.asarray(j_out), None, None
    (out * torch.from_numpy(cot)).sum().backward()
    j_grads = jax.grad(
        lambda *ys: jnp.sum(jax_fn(list(ys), j_mask) * cot), argnums=tuple(range(len(xs)))
    )(*[jnp.asarray(x) for x in xs])
    return out.detach().numpy(), np.asarray(j_out), [t.grad.numpy() for t in t_xs], [np.asarray(g) for g in j_grads]


@pytest.mark.parametrize("s", [16, 64, 128])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_forward_matches_jax(layout, s):
    out, ref, _, _ = _run_both(layout, s, seed=s, grads=False)
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gradients_match_jax(layout, s):
    _, _, grads, ref = _run_both(layout, s, seed=100 + s)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fully_masked_row_stays_finite(layout):
    """f32.min bias, never -inf: a row with no real token gets uniform
    weights, finite values and finite gradients, as in the reference."""
    out, ref, grads, ref_grads = _run_both(layout, 32, seed=7, masked_row=True)
    assert np.isfinite(out).all() and all(np.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(out, ref, atol=2e-6)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_longer_than_one_tile_raises(layout):
    """S = 520 is longer than one 512 tile but not a multiple of 256, so
    the reference still runs its single-tile kernels (4 or 5 forward, 8
    backward) there, and so does the port: forward and gradients match,
    where the port used to raise."""
    out, ref, grads, ref_grads = _run_both(layout, 520, seed=520)
    np.testing.assert_allclose(out, ref, atol=2e-6)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_single_tile_forward_limit_is_f32_only(head_dim):
    """Only the f32 single-tile forward has a shared-memory S limit (the
    bf16 forward, the tensor-core kernel, has none): asked for a bf16
    forward limit, ``single_tile_max_s`` raises before it reaches a card."""
    with pytest.raises(ValueError, match="only the f32 single-tile forward"):
        tfa.single_tile_max_s("fwd", head_dim, dtype=torch.bfloat16)


@pytest.mark.parametrize("impl", ["pallas", "pallas_plain"])
def test_bert_forward_pallas_route_matches_jax(impl):
    """The port's "pallas" routes (on the CPU, the plain versions inside
    the same autograd functions) against JAX's "pallas" route (Pallas in
    interpret mode) on the tiny config: hidden states, and the gradient
    of sum(hidden**2) with respect to every parameter."""
    config = JaxConfig.tiny()
    jparams = jax_init_params(jax.random.PRNGKey(0), config)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, config.vocab_size, size=(3, 24)).astype(np.int32)
    mask = np.ones((3, 24), np.int32)
    mask[2, 10:] = 0

    def jax_loss(p):
        h = jax_bert_forward(p, jnp.asarray(ids), jnp.asarray(mask), num_heads=config.num_heads,
                             attention_impl="pallas")
        return jnp.sum(h**2), h

    (_, j_hidden), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(jparams)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    leaves = jax.tree.leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for t in leaves:
        t.requires_grad_(True)
    hidden = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          num_heads=config.num_heads, attention_impl=impl)
    (hidden**2).sum().backward()
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(j_hidden), atol=1e-5)
    for t, g in zip(leaves, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "is_cuda,dtype,gelu,s,want",
    [
        (True, torch.bfloat16, "tanh", 128, "fused"),
        (True, torch.float32, "exact", 128, "pallas"),
        (True, torch.float32, "exact", 512, "pallas"),
        (True, torch.float32, "exact", 520, "pallas"),
        (True, torch.bfloat16, "exact", 128, "pallas"),
        (False, torch.float32, "exact", 128, "xla"),
        (False, torch.bfloat16, "tanh", 128, "xla"),
    ],
)
def test_auto_route(is_cuda, dtype, gelu, s, want):
    """"auto" mirrors dial_rag_tpu/models/bert.py:510-523 on a CUDA tensor,
    whatever the dtype: fused blocks with tanh GELU at S <= 512, else the
    attention kernels, in f32 and bf16 (tests/test_torch_kernels_cuda.py
    runs both on the card; past the kernels' shared memory they raise
    instead of falling back to plain PyTorch); the plain "xla" route on
    the CPU. Where "auto" gives
    "pallas" above S = 512, that route's attention (heads split, then
    ``flash_attention``: the single-tile kernels at S = 520) matches the
    reference's on the CPU."""
    ids = types.SimpleNamespace(is_cuda=is_cuda, shape=(2, s))
    assert resolve_attention_impl("auto", ids, gelu) == want
    if want == "pallas" and s > 512:
        qkv, mask, _ = _inputs(s, seed=s)
        out = _pallas_attention(torch.from_numpy(qkv), torch.from_numpy(mask), HEADS, plain=False)
        q, k, v = (jnp.asarray(x) for x in _heads(qkv))
        ref = jfa.flash_attention(q, k, v, jnp.asarray(mask)).transpose(0, 2, 1, 3).reshape(B, s, -1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
