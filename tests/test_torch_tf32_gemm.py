"""The split-TF32 products of the port's f32 encoder blocks (TPU kernels
1-3 in f32: ``dial_rag_tpu_torch/csrc/gemm_tf32.cuh`` and the launch
sequences of ``csrc/encoder_tf32.cuh``), modelled in plain PyTorch on the
CPU and held against the JAX package's fused blocks
(``fused_attention_block``, ``fused_ffn_block``, ``fused_layer_block``,
their Pallas kernels in interpret mode as tests/test_fused_encoder.py
runs them).

The model of a product ``a [m, k] . w [k, n]``: both operands split as
the kernels split them (``split_tf32``: hi = rna(x), lo = rna(x - hi)),
K walked in the kernel's 32-deep slices in order, each slice's three
products hi.lo + lo.hi + hi.hi (each exact in f64, summed in f32, the
small terms first: ``mm3``) a partial, added to the running sum in f32.
The blocks around the products follow the launch sequences: kernel 1 the
QKV product + b_qkv, the single-tile attention (``forward_model``: the
split-TF32 single-tile forward's model, P . V one partial per 64 keys),
the output product, then LN(x + (y + b_out)); kernel 2 gelu_tanh(x . W1 +
b1), its product with W2, then LN(x + (y + b2)); kernel 3 the two in
turn. In f32 every cast of the reference is the identity.

Tolerances: the card's f32 gate for the blocks, 2e-5 (chip_smoke.py's
``F32_FWD_TOL``). A long product (K = 3072, the FFN's W2 at bge-base
widths) is held against the product in f64: no farther from it than 1.5
times the plain f32 product is (chip_smoke's gate against an f64
evaluation). This model is test code only: nothing in the port imports it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.ops import fused_encoder as jfe
from dial_rag_tpu_torch.ops import fused_encoder as tfe
from tests.test_torch_tf32_split import forward_model, mm3

SLICE = 32  # K rows of a slice: the kernels add one partial per slice


def gemm_model(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w as the split-TF32 product sums it: a partial per 32-deep K
    slice, added in f32 in order."""
    total = None
    for k0 in range(0, a.shape[-1], SLICE):
        part = mm3(a[..., k0 : k0 + SLICE], w[k0 : k0 + SLICE])
        total = part if total is None else total + part
    return total


def attention_block_model(x, mask, wqkv, bqkv, wout, bout, g, beta, heads):
    b, s, hid = x.shape
    qkv = gemm_model(x, wqkv) + bqkv
    q, k, v = qkv.view(b, s, 3, heads, hid // heads).permute(2, 0, 3, 1, 4)
    ctx = forward_model(q, k, v, mask).transpose(1, 2).reshape(b, s, hid)
    return tfe._layernorm_f32(x + (gemm_model(ctx, wout) + bout), g, beta)


def ffn_block_model(x, w1, b1, w2, b2, g, beta):
    h = torch.nn.functional.gelu(gemm_model(x, w1) + b1, approximate="tanh")
    return tfe._layernorm_f32(x + (gemm_model(h, w2) + b2), g, beta)


def _inputs(seed, b, s, hid, heads):
    """x [B, S, H] f32, a mask with a ragged last row, the reference's
    12-tuple of one layer's weights (f32 numpy), I = 4H."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = rng.standard_normal((b, s, hid)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[-1, s // 2 :] = 0
    inter = 4 * hid
    ln = [(1 + w(hid, scale=0.1)), w(hid, scale=0.1)]
    attn = [w(hid, 3 * hid, scale=0.05), w(3 * hid, scale=0.02), w(hid, hid, scale=0.05), w(hid, scale=0.02), *ln]
    ffn = [w(hid, inter, scale=0.05), w(inter, scale=0.02), w(inter, hid, scale=0.05), w(hid, scale=0.02), *ln]
    return x, mask, attn + ffn


def _real_tokens(out, ref, s):
    """The real query rows of both (the last batch row's pad rows attend
    to its real keys in both, but the reference leaves them out of its
    own tests)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return [(out[:-1], ref[:-1]), (out[-1, : s // 2], ref[-1, : s // 2])]


@pytest.mark.parametrize("hid,heads", [(64, 2), (128, 4)])
@pytest.mark.parametrize("s", [64, 100])
@pytest.mark.parametrize("block", ["attention", "ffn", "layer"])
def test_block_model_matches_jax(block, s, hid, heads):
    """Kernels 1, 2 and 3 in f32 through the split-TF32 model against the
    JAX package's blocks in interpret mode, within 2e-5."""
    x, mask, w = _inputs(s + hid, 2, s, hid, heads)
    jw = [jnp.asarray(a) for a in w]
    tx, tmask, tw = torch.from_numpy(x), torch.from_numpy(mask), [torch.from_numpy(a) for a in w]
    if block == "attention":
        ref = jfe.fused_attention_block(jnp.asarray(x), jnp.asarray(mask), *jw[:6], heads)
        out = attention_block_model(tx, tmask, *tw[:6], heads)
    elif block == "ffn":
        ref = jfe.fused_ffn_block(jnp.asarray(x), *jw[6:])
        out = ffn_block_model(tx, *tw[6:])
    else:
        ref = jfe.fused_layer_block(jnp.asarray(x), jnp.asarray(mask), tuple(jw), heads)
        out = ffn_block_model(attention_block_model(tx, tmask, *tw[:6], heads), *tw[6:])
    assert out.dtype == torch.float32 and out.shape == x.shape
    for got, want in (_real_tokens(out, ref, s) if block != "ffn" else [(out.numpy(), np.asarray(ref))]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("k", [384, 3072])
def test_long_product_model_against_f64(k):
    """A product over K = 3072 (and 384) through the model, its operands
    shaped like the FFN's down product (GELU outputs against N(0, 0.02)
    weights): no farther from the product in f64 than 1.5 times the plain
    f32 product is, and within 2^-20 of the f64 sum of |a| |w| per entry."""
    rng = np.random.default_rng(k)
    a = torch.nn.functional.gelu(torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)),
                                 approximate="tanh")
    w = torch.from_numpy((rng.standard_normal((k, 128)) * 0.02).astype(np.float32))
    exact = a.double() @ w.double()
    model_err = (gemm_model(a, w).double() - exact).abs()
    plain_err = ((a @ w).double() - exact).abs()
    assert model_err.max() <= 1.5 * plain_err.max(), (model_err.max().item(), plain_err.max().item())
    assert (model_err <= 2.0**-20 * (a.double().abs() @ w.double().abs())).all()


def test_gemm_model_sums_slices_in_order():
    """The model's slices are the kernel's: 32 deep, added in f32 in order;
    one slice is mm3 itself, and a K that is not a multiple of 32 is never
    given (the wrappers take I % 128 == 0, H 384 or 768)."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((8, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 16)).astype(np.float32))
    assert torch.equal(gemm_model(a[:, :32], w[:32]), mm3(a[:, :32], w[:32]))
    want = (mm3(a[:, :32], w[:32]) + mm3(a[:, 32:64], w[32:64])) + mm3(a[:, 64:], w[64:])
    assert torch.equal(gemm_model(a, w), want)
    assert math.isclose(gemm_model(a, w).double().sum().item(), (a.double() @ w.double()).sum().item(),
                        rel_tol=1e-5)
