"""The split-TF32 (3xTF32) arithmetic of the port's f32 attention
kernels on Hopper's tensor cores (``dial_rag_tpu_torch/csrc/
tensor_core_tf32.cuh``): the query-blocked forward and backward (TPU
kernels 6 and 9), the single-tile forward and backward (TPU kernels 4,
5 and 8), the KV-blocked forward (TPU kernel 7) and the KV-blocked
backward passes (TPU kernels 10 and 11), modelled in plain PyTorch on
the CPU and held against the JAX package: its query-blocked route at S =
1024, its single-tile route (``_forward``, ``_backward`` and
``fused_qkv_attention`` with its VJP, in interpret mode) at S <= 520,
its KV-blocked forward (``_forward``, the threshold lowered to 512) at S
= 1024 and 1536, its KV-blocked backward (``_backward_kv_blocked`` after
its KV-blocked forward) at S = 1024.

The model. ``split_tf32`` rounds an f32 value to 10 mantissa bits, to
nearest with ties away from zero, by integer bit operations, as
``cvt.rna.tf32.f32`` does: hi = rna(x), lo = rna(x - hi), the remainder
exact in f32. A product is hi.hi + hi.lo + lo.hi (lo.lo dropped): each
term is a product of two TF32 values, exact in f64, and the three are
summed in f32, the small terms first, as the kernels' ``mma3`` orders them.
The attention around the products follows the kernels: scores * scale +
bias, the exact row softmax, P . V and the gradients' long sums taken as
partials per 64-row chunk added in f32. The single-tile kernels compute
the same expressions in the same chunks (Q K^T once in the forward; in
the backward dP twice, delta = rowsum(dP P) as the reference forms it),
so one model serves both. The KV-blocked forward takes the online
softmax one 64-key chunk at a time (the reference's 512-key blocks
rescale less often: the same function, rounded otherwise): m_next =
max(m, the chunk's row max), corr = exp(m - m_next), e = exp(s - m_next),
l = l corr + sum(e), acc = acc corr + e . V (the chunk's product a
partial of its own), then o = acc / l and lse = m + log(l). The
KV-blocked passes take P = exp(s - lse)
with the forward's lse and delta = rowsum(dO O) with its o, and add a
partial every 32 rows (half a chunk) with a compensation term (Kahan,
each step rounded in f32, as ``add_compensated`` does it, the term kept
as bf16).

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_rag_tpu.ops import flash_attention as jfa
from dial_rag_tpu_torch.ops import flash_attention as tfa
from dial_rag_tpu_torch.ops.fused_encoder import mask_bias

CHUNK = 64  # rows of a ring chunk: the kernels add one partial per chunk
HALF = 32  # rows of half a chunk: the KV-blocked passes add one partial per half


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
    """The f32 query-blocked and single-tile forwards: o = sum over key
    chunks of P . V."""
    p = _probs(q, k, mask)
    return _chunked(lambda c: mm3(p[..., c], v[:, :, c]), q.shape[2])


def backward_model(q, k, v, do, mask):
    """The f32 query-blocked backward's two passes and the single-tile
    backward's steps: dQ over key chunks, dK and dV over query chunks."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, mask)
    dp = mm3(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    n = q.shape[2]
    dq = _chunked(lambda c: mm3(ds[..., c], k[:, :, c]), n)
    dk = _chunked(lambda c: mm3(ds[:, :, c].transpose(-1, -2), q[:, :, c]), n)
    dv = _chunked(lambda c: mm3(p[:, :, c].transpose(-1, -2), do[:, :, c]), n)
    return dq, dk, dv


def kv_forward_model(q, k, v, mask):
    """The f32 KV-blocked forward: the online softmax over 64-key chunks
    from m = f32.min, e . V per chunk added to acc corr in f32; returns (o,
    lse)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm3(q, k.transpose(-1, -2)) * scale + mask_bias(mask)[:, None, None, :]
    m = torch.full(q.shape[:3] + (1,), torch.finfo(torch.float32).min)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape)
    for c0 in range(0, q.shape[2], CHUNK):
        sc = s[..., c0 : c0 + CHUNK]
        m_next = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_next)
        e = torch.exp(sc - m_next)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        acc = acc * corr + mm3(e, v[:, :, c0 : c0 + CHUNK])
        m = m_next
    return acc / l, (m + torch.log(l)).squeeze(-1)


def _compensated(fn, n: int) -> torch.Tensor:
    """sum over 32-row pieces c of fn(slice c), each added in order with a
    compensation term, every step rounded in f32 and the term kept as bf16
    (rounded to nearest even), as the kernels keep it."""
    total = comp = None
    for r0 in range(0, n, HALF):
        part = fn(slice(r0, r0 + HALF))
        if total is None:
            total, comp = torch.zeros_like(part), torch.zeros_like(part)
        y = part - comp
        t = total + y
        comp = ((t - total) - y).to(torch.bfloat16).float()
        total = t
    return total


def kv_backward_model(q, k, v, o, lse, do, mask):
    """The f32 KV-blocked dQ and dK/dV passes: P = exp(s - lse), delta =
    rowsum(dO O), dS = P (dP - delta) scale; dQ over the keys, dK and dV
    over the queries, one compensated partial per 32 rows."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm3(q, k.transpose(-1, -2)) * scale + mask_bias(mask)[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (mm3(do, v.transpose(-1, -2)) - delta) * scale
    n = q.shape[2]
    dq = _compensated(lambda c: mm3(ds[..., c], k[:, :, c]), n)
    dk = _compensated(lambda c: mm3(ds[:, :, c].transpose(-1, -2), q[:, :, c]), n)
    dv = _compensated(lambda c: mm3(p[:, :, c].transpose(-1, -2), do[:, :, c]), n)
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


# sequence lengths of the model tests: the single-tile route at a
# training bucket (64), ragged (100), the single-tile backward's limit on
# an H100 (128), one full tile (512), past it but not a multiple of 256
# (520: still single-tile), and the query-blocked route (1024)
SEQS = [64, 100, 128, 512, 520, 1024]


def _jax_route(s: int) -> str:
    return "single_tile" if s <= jfa._FULL_TILE_MAX_S or s % jfa._Q_BLOCK else "q_blocked"


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", SEQS)
def test_forward_model_matches_jax(s, dh):
    """Kernels 5 and 6's split-TF32 arithmetic against the JAX package's
    ``_forward`` (the single-tile Pallas kernel at S <= 520, the
    query-blocked one at S = 1024, in interpret mode), within the f32
    forward gate 2e-5."""
    q, k, v, _, mask = _inputs(3, 2, s, dh, seed=dh + s)
    assert _jax_route(s) == ("q_blocked" if s == 1024 else "single_tile")
    out = forward_model(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    ref, lse = jfa._forward(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    assert lse is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", SEQS)
def test_backward_model_matches_jax(s, dh):
    """Kernels 8 and 9's split-TF32 arithmetic against the JAX package's
    ``_backward`` (the single-tile Pallas backward at S <= 520, the
    query-blocked one at S = 1024, in interpret mode) with a ragged and a
    fully masked row, within the f32 gradient gates atol 5e-5, rtol
    1e-4."""
    q, k, v, do, mask = _inputs(3, 2, s, dh, seed=dh + s + 1)
    got = backward_model(*(torch.from_numpy(a) for a in (q, k, v, do)), torch.from_numpy(mask))
    want = jfa._backward(jnp.asarray(mask), *(jnp.asarray(a) for a in (q, k, v, do)))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4, err_msg=name)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H] -> [B, h, S, Dh]."""
    b, s, hid = x.shape
    return x.reshape(b, s, heads, hid // heads).transpose(1, 2)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", [64, 100, 128, 512, 520])
def test_packed_model_matches_jax(s, dh):
    """Kernel 4 and its backward (kernel 8 on the packed layout): the
    model on the heads of a packed qkv [B, S, 3H], the gradients repacked,
    against the JAX package's ``fused_qkv_attention`` and its VJP (the
    layout-native Pallas kernel and the single-tile backward in interpret
    mode), with a ragged and a fully masked row; forward 2e-5, gradient
    atol 5e-5, rtol 1e-4."""
    heads = 2
    rng = np.random.default_rng(s + dh + 2)
    qkv = rng.standard_normal((3, s, 3 * heads * dh)).astype(np.float32)
    cot = rng.standard_normal((3, s, heads * dh)).astype(np.float32)
    _, _, _, _, mask = _inputs(3, heads, s, dh, seed=0)
    qkv_t = torch.from_numpy(qkv)
    q, k, v = (_heads(x, heads) for x in qkv_t.chunk(3, dim=-1))
    mask_t = torch.from_numpy(mask)
    out = forward_model(q, k, v, mask_t).transpose(1, 2).reshape(3, s, heads * dh)
    grads = backward_model(q, k, v, _heads(torch.from_numpy(cot), heads), mask_t)
    dqkv = torch.cat([g.transpose(1, 2).reshape(3, s, heads * dh) for g in grads], dim=-1)

    ref, vjp = jax.vjp(lambda x: jfa.fused_qkv_attention(x, jnp.asarray(mask), heads), jnp.asarray(qkv))
    (ref_dqkv,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert torch.isfinite(dqkv).all()
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(ref_dqkv), atol=5e-5, rtol=1e-4)


@pytest.fixture
def kv_blocked(monkeypatch):
    """Lowers the KV-blocked threshold to 512 in both packages."""
    monkeypatch.setattr(jfa, "_Q_BLOCKED_MAX_S", 512)
    monkeypatch.setattr(tfa, "_Q_BLOCKED_MAX_S", 512)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", [1024, 1536])
def test_kv_forward_model_matches_jax(s, dh, kv_blocked):
    """Kernel 7's split-TF32 arithmetic (one rescale per 64-key chunk)
    against the JAX package's ``_forward`` on the KV-blocked route (the
    Pallas kernel in interpret mode, one rescale per 512-key block) at S =
    1024 and 1536, with a row padded across a 512-key block and a fully
    masked row (lse = f32.min + log(S) there): o within the f32 forward
    gate 2e-5, lse within 1e-5."""
    assert tfa.attention_route(s) == "kv_blocked"
    q, k, v, _, mask = _inputs(3, 2, s, dh, seed=dh + s + 5)
    o, lse = kv_forward_model(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    ref, ref_lse = jfa._forward(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    assert ref_lse is not None
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)


def _excess(a, w) -> float:
    """The largest |a - w| over rtol 1e-4 of |w|, in f64."""
    return ((a.double() - w).abs() - 1e-4 * w.abs()).max().item()


@pytest.mark.parametrize("dh", [32, 64])
def test_kv_blocked_backward_model_matches_jax(dh, kv_blocked):
    """Kernels 10 and 11's split-TF32 arithmetic at S = 1024 (two 512-key
    blocks, four 256-query blocks) against the JAX package's
    ``_backward_kv_blocked`` (both Pallas passes in interpret mode), each
    fed the o and lse of the JAX package's KV-blocked forward, with a
    ragged row and a fully masked one, within the f32 gradient gates atol
    5e-5, rtol 1e-4. On the fully masked row P is 1 for every key, so each
    gradient is a sum of S terms of size 1 (up to ~160 here), and the JAX
    package's own f32 sums lie up to ~6e-5 past rtol from the same
    expressions evaluated in f64 (3 of 8 seeds over 5e-5 at head_dim 64):
    there the model's excess over that f64 evaluation may not exceed
    max(5e-5, the JAX package's), the card's gate on that row."""
    s = 1024
    assert tfa.attention_route(s) == "kv_blocked"
    q, k, v, do, mask = _inputs(3, 2, s, dh, seed=dh + 3)
    jq, jk, jv, jdo, jmask = (jnp.asarray(a) for a in (q, k, v, do, mask))
    o, lse = jfa._forward(jq, jk, jv, jmask)
    assert lse is not None
    tq, tk, tv, to, tlse, tdo = (torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do))
    got = kv_backward_model(tq, tk, tv, to, tlse, tdo, torch.from_numpy(mask))
    want = [torch.from_numpy(np.array(w)) for w in jfa._backward_kv_blocked(jmask, jq, jk, jv, o, lse, jdo)]
    exact = tfa.attention_bwd_kv_blocked_plain(*(t.double() for t in (tq, tk, tv, to)), tlse, tdo.double(),
                                               torch.from_numpy(mask))
    for name, a, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a[:-1].numpy(), w[:-1].numpy(), atol=5e-5, rtol=1e-4, err_msg=name)
        assert _excess(a[-1], e[-1]) <= max(5e-5, _excess(w[-1], e[-1])), name


@pytest.mark.parametrize("dh", [32, 64])
def test_kv_blocked_backward_model_meets_the_card_gates(dh):
    """The card's gates on kernels 10 and 11 (chip_smoke.py's
    ``long_backward_rows``), met by the model at S = 1024 with the port's
    plain forward's o and lse: the rows not fully masked within atol 5e-5
    after rtol 1e-4 of the plain version; on the fully masked row, where
    every gradient is a sum of S terms of size 1, an excess over the plain
    version evaluated in f64 no larger than max(5e-5, the plain f32
    version's)."""
    q, k, v, do, mask = (torch.from_numpy(a) for a in _inputs(3, 2, 1024, dh, seed=dh + 4))
    o, lse = tfa.attention_kv_blocked_plain(q, k, v, mask)
    got = kv_backward_model(q, k, v, o, lse, do, mask)
    want = tfa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)
    exact = tfa.attention_bwd_kv_blocked_plain(*(t.double() for t in (q, k, v, o)), lse, do.double(), mask)
    for name, a, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert _excess(a[:-1], w[:-1].double()) <= 5e-5, name
        assert _excess(a[-1], e[-1]) <= max(5e-5, _excess(w[-1], e[-1])), name
