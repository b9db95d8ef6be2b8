"""The split-TF32 (3xTF32) arithmetic of the port's f32 query-blocked
attention kernels (TPU kernels 6 and 9 on Hopper's tensor cores:
``dial_rag_tpu_torch/csrc/tensor_core_tf32.cuh``), modelled in plain
PyTorch on the CPU and held against the JAX package.

The model. ``split_tf32`` rounds an f32 value to 10 mantissa bits, to
nearest with ties away from zero, by integer bit operations, as
``cvt.rna.tf32.f32`` does: hi = rna(x), lo = rna(x - hi), the remainder
exact in f32. A product is hi.hi + hi.lo + lo.hi (lo.lo dropped): each
term is a product of two TF32 values, exact in f64, and the three are
summed in f32, the small terms first, as the kernels' ``mma3`` orders them.
The attention around the products follows the kernels: scores * scale +
bias, the exact row softmax, P . V and the gradients' long sums taken as
partials per 64-row chunk added in f32.

Two kinds of value behave otherwise under ``rna`` and are not tested here:
values within a TF32 ulp of f32's largest round to inf, and subnormals
keep fewer bits. Neither reaches a product of the kernels, whose operands
are q, k, v, dO, P and dS: the mask bias (f32.min) is added after the
product, never split.

Tolerances: the card's f32 gates (chip_smoke.py): forward 2e-5;
gradients atol 5e-5, rtol 1e-4. This model is test code only: nothing in
the port imports it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.ops import flash_attention as jfa
from dial_rag_tpu_torch.ops.fused_encoder import mask_bias

CHUNK = 64  # rows of a ring chunk: the kernels add one partial per chunk


def _rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to 10 mantissa bits, to nearest, ties away from zero:
    half of the 13 dropped bits added to the magnitude, then cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _rna(x)
    return hi, _rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in split TF32: hi.lo + lo.hi + hi.hi, each exact in f64,
    summed in f32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)

    def term(x, y):
        return (x.double() @ y.double()).float()

    return (term(ah, bl) + term(al, bh)) + term(ah, bh)


def _chunked(fn, n: int) -> torch.Tensor:
    """sum over 64-row chunks c of fn(slice c), added in f32 in order."""
    total = None
    for c0 in range(0, n, CHUNK):
        part = fn(slice(c0, c0 + CHUNK))
        total = part if total is None else total + part
    return total


def _probs(q, k, mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm3(q, k.transpose(-1, -2)) * scale + mask_bias(mask)[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def forward_model(q, k, v, mask):
    """The f32 query-blocked forward: o = sum over key chunks of P . V."""
    p = _probs(q, k, mask)
    return _chunked(lambda c: mm3(p[..., c], v[:, :, c]), q.shape[2])


def backward_model(q, k, v, do, mask):
    """The f32 query-blocked backward's two passes: dQ over key chunks,
    dK and dV over query chunks."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, mask)
    dp = mm3(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    n = q.shape[2]
    dq = _chunked(lambda c: mm3(ds[..., c], k[:, :, c]), n)
    dk = _chunked(lambda c: mm3(ds[:, :, c].transpose(-1, -2), q[:, :, c]), n)
    dv = _chunked(lambda c: mm3(p[:, :, c].transpose(-1, -2), do[:, :, c]), n)
    return dq, dk, dv


@pytest.mark.parametrize("exponent", [-24, -12, -4, 0, 4, 12, 24])
def test_split_keeps_22_bits(exponent):
    """hi + lo is within 2^-21 relative of x (in f64) on seeded normals
    scaled by 2^exponent, hi and lo carry TF32 values (the 13 low bits
    clear), and |lo| is at most half a TF32 ulp of hi."""
    rng = np.random.default_rng(exponent + 100)
    x = torch.from_numpy((rng.standard_normal(4096) * 2.0**exponent).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0**-21 * x.double().abs()).all(), (err / x.double().abs()).max().item()
    assert (lo.double().abs() <= 2.0**-11 * hi.double().abs()).all()


def test_split_rounds_ties_away_and_keeps_zeros():
    """cvt.rna: 1 + 2^-11, halfway between two TF32 values, rounds away
    from zero in both signs (round-to-even would give 1); zeros split into
    zeros."""
    x = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 0.0, -0.0], dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 0.0, -0.0]
    assert lo.tolist() == [-(2.0**-11), 2.0**-11, 0.0, 0.0]
    assert (hi + lo)[2:].eq(0).all()


def _inputs(b, h, s, dh, seed):
    """q, k, v, dO [B, h, S, dh], standard normal; the second-to-last row
    padded from S/3 on, the last fully masked (as
    tests/test_torch_long_backward.py makes them)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[-2, s // 3 :] = 0
    mask[-1] = 0
    return q, k, v, do, mask


@pytest.mark.parametrize("dh", [32, 64])
def test_forward_model_matches_jax(dh):
    """Kernel 6's split-TF32 arithmetic against the JAX package's
    ``_forward`` (the query-blocked Pallas kernel in interpret mode) at
    S = 1024, within the f32 forward gate 2e-5."""
    q, k, v, _, mask = _inputs(3, 2, 1024, dh, seed=dh)
    assert jfa._FULL_TILE_MAX_S < 1024 <= jfa._Q_BLOCKED_MAX_S
    out = forward_model(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    ref, lse = jfa._forward(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    assert lse is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dh", [32, 64])
def test_backward_model_matches_jax(dh):
    """Kernel 9's split-TF32 arithmetic against the JAX package's
    ``_backward`` (the query-blocked Pallas backward in interpret mode) at
    S = 1024 with a ragged and a fully masked row, within the f32 gradient
    gates atol 5e-5, rtol 1e-4."""
    q, k, v, do, mask = _inputs(3, 2, 1024, dh, seed=dh + 1)
    got = backward_model(*(torch.from_numpy(a) for a in (q, k, v, do)), torch.from_numpy(mask))
    want = jfa._backward(jnp.asarray(mask), *(jnp.asarray(a) for a in (q, k, v, do)))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4, err_msg=name)
