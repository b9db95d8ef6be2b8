"""The port's blocked attention backward (S > 512) against the JAX
package's, whose Pallas kernels run in interpret mode on the CPU as
tests/test_flash_attention.py runs them: ``_attention_bwd_q_blocked_kernel``
(kernel 9) at S = 1024 and 4352, and ``_bwd_dq_kv_blocked_kernel`` with
``_bwd_dkv_kv_blocked_kernel`` (kernels 10 and 11) at S = 1024, each in f32
and bf16 and at S = 1024 at head_dim 32 and 64, with a ragged row whose
padding crosses a 512-key block and a fully masked row; the single-tile
forward and backward at S = 1700, past the single-tile CUDA kernels'
shared-memory limit; the dispatch on the card (which code each S and
dtype takes); then the gradients of a pooled ``bert_forward`` on the
"pallas" route and one ``contrastive_loss`` with its passages at a blocked
S, in f32 (query-blocked) and in bf16 (KV-blocked). On a CPU tensor the
port's backward runs the plain versions that the CUDA kernels are held
to on the card (tests/test_torch_kernels_cuda.py). The bf16 tensor-core
arithmetic of kernel 9 and of kernels 10 and 11
(``csrc/attention_bwd_tc.cuh``: its order of sums and its casts) is
modelled here and held against the JAX package's query-blocked and
KV-blocked backwards at S = 1024.

Tolerances: f32 gradients atol 1e-4, rtol 1e-3, the reference's own
blocked-gradient tolerance (tests/test_flash_attention.py:185, 242); bf16
3e-2 of the reference gradient's largest magnitude in each batch row (the
port's bf16 tolerance, made relative because gradients are not O(1), and
per row because a fully masked row's KV-blocked gradients are sums over
every key); the contrastive
loss rtol 1e-5 and its gradients atol 1e-5, rtol 1e-4, as
tests/test_torch_training.py holds the S <= 512 loss. Kernels 10 and 11
run at S = 1024 with ``_Q_BLOCKED_MAX_S`` lowered to 512 in both packages,
as the reference's own test lowers it.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dial_rag_tpu.models.bert import BertConfig as JaxConfig
from dial_rag_tpu.models.bert import bert_forward as jax_bert_forward
from dial_rag_tpu.models.bert import init_params as jax_init_params
from dial_rag_tpu.ops import flash_attention as jfa
from dial_rag_tpu.training import contrastive as jc
from dial_rag_tpu_torch.models.bert import bert_forward
from dial_rag_tpu_torch.ops import flash_attention as tfa
from dial_rag_tpu_torch.ops.fused_encoder import mask_bias
from dial_rag_tpu_torch.training import contrastive as tc
from dial_rag_tpu_torch.weights import param_leaves, params_from_jax_numpy

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
BF16_REL = 3e-2


@pytest.fixture
def kv_blocked(monkeypatch):
    """Lowers the KV-blocked threshold to 512 in both packages."""
    monkeypatch.setattr(jfa, "_Q_BLOCKED_MAX_S", 512)
    monkeypatch.setattr(tfa, "_Q_BLOCKED_MAX_S", 512)


def _inputs(b, h, s, seed, np_dtype, dh=32):
    """q, k, v and a cotangent [B, h, S, dh], standard normal; a mask whose
    second-to-last row is padded from S/3 on (crossing the 512-key block at
    S = 1024) and whose last row is fully masked (B >= 3 keeps a full row)."""
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((b, h, s, dh)).astype(np.float32).astype(np_dtype) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[-2, s // 3 :] = 0
    mask[-1] = 0
    return q, k, v, cot, mask


def _grads(q, k, v, cot, mask, t_dtype):
    """(port dq, dk, dv), (JAX dq, dk, dv) of sum(flash_attention * cot), as f32 numpy."""
    xs = [torch.from_numpy(np.asarray(a, np.float32)).to(t_dtype).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*xs, torch.from_numpy(mask))
    (out.float() * torch.from_numpy(np.asarray(cot, np.float32))).sum().backward()
    port = [x.grad.float().numpy() for x in xs]
    j_mask, j_cot = jnp.asarray(mask), jnp.asarray(cot).astype(jnp.float32)
    ref = jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, j_mask).astype(jnp.float32) * j_cot),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a) for a in (q, k, v)))
    return port, [np.asarray(g, np.float32) for g in ref]


def _assert_grads_close(port, ref, dtype):
    for name, a, r in zip(("dq", "dk", "dv"), port, ref):
        assert np.isfinite(a).all(), name
        if dtype == "f32":
            np.testing.assert_allclose(a, r, atol=1e-4, rtol=1e-3, err_msg=name)
        else:
            for row_a, row_r in zip(a, r):
                np.testing.assert_allclose(row_a, row_r, atol=BF16_REL * np.abs(row_r).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,s,dh", [(3, 2, 1024, 32), (2, 1, 4352, 32), (3, 2, 1024, 64)])
def test_q_blocked_backward_matches_jax(dtype, b, h, s, dh):
    """Kernel 9: at S = 1024 at head_dim 32 and 64, and at S = 4352 (a
    multiple of 256 but not of 512 above 4096: still query-blocked) on one
    head."""
    np_dtype, t_dtype = DTYPES[dtype]
    assert tfa.attention_route(s) == "q_blocked"
    port, ref = _grads(*_inputs(b, h, s, seed=s + b, np_dtype=np_dtype, dh=dh), t_dtype)
    _assert_grads_close(port, ref, dtype)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_blocked_backward_matches_jax(dtype, dh, kv_blocked):
    """Kernels 10 and 11 at S = 1024 (two 512-key blocks, four 256-query
    blocks), at head_dim 32 and 64: P from the forward's lse, delta =
    rowsum(dO O)."""
    np_dtype, t_dtype = DTYPES[dtype]
    assert tfa.attention_route(1024) == "kv_blocked"
    port, ref = _grads(*_inputs(3, 2, 1024, seed=21, np_dtype=np_dtype, dh=dh), t_dtype)
    _assert_grads_close(port, ref, dtype)


@pytest.mark.parametrize("masked", ["padded tail", "fully masked"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_single_tile_past_the_kernel_limit_matches_jax(dtype, dh, masked):
    """S = 1700: a single-tile S (not a multiple of 256) past the
    single-tile CUDA kernels' shared-memory limits at both head widths, the
    S the port once refused. The port's plain forward and backward (which
    its kernels past that limit, the query-blocked codes, are held to on
    the card) against the JAX package's single-tile ``flash_attention``
    and its VJP in interpret mode: B = 1, 2 heads, a padded tail or a
    fully masked row. Forward f32 2e-5 (tests/test_torch_kernels_cuda.py's
    f32 forward tolerance), bf16 3e-2; gradients as above."""
    np_dtype, t_dtype = DTYPES[dtype]
    s = 1700
    assert tfa.attention_route(s) == "single_tile"
    rng = np.random.default_rng(dh + len(masked))
    q, k, v, cot = (rng.standard_normal((1, 2, s, dh)).astype(np.float32).astype(np_dtype) for _ in range(4))
    mask = np.ones((1, s), np.int32)
    mask[0, 1100 if masked == "padded tail" else 0 :] = 0
    out = tfa.flash_attention(*(torch.from_numpy(np.asarray(a, np.float32)).to(t_dtype) for a in (q, k, v)),
                              torch.from_numpy(mask))
    ref = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-5 if dtype == "f32" else BF16_REL)
    port, ref_grads = _grads(q, k, v, cot, mask, t_dtype)
    _assert_grads_close(port, ref_grads, dtype)


CHUNK, HALF = 64, 32  # rows of a ring chunk of the bf16 tensor-core passes, and of half of one


def _partials(fn, n: int, rows: int) -> torch.Tensor:
    """sum over pieces c of ``rows`` rows of fn(slice c), each piece's f32
    partial added to the total in f32, in order."""
    total = None
    for r0 in range(0, n, rows):
        part = fn(slice(r0, r0 + rows))
        total = part if total is None else total + part
    return total


def q_blocked_bf16_model(q, k, v, do, mask):
    """Kernel 9 in bf16 on the bf16 tensor cores, on f32 tensors that hold
    bf16 values: every product of two bf16 operands is exact in f32 and
    summed in f32 (here in f64, then rounded: the model leaves out the
    tensor core's own rounding of a product's sum); P exact per row,
    normalised in f32; delta = rowsum(dP P); dS = P (dP - delta) scale; P
    and dS rounded to bf16 before their products; dQ a sum of per-64-key
    partials in f32, dK and dV of per-32-query partials; the gradients
    rounded to bf16 once."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def mm(a, b):
        return (a.double() @ b.double()).float()

    s = mm(q, k.transpose(-1, -2)) * scale + mask_bias(mask)[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = mm(do, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()
    n = q.shape[2]
    dq = _partials(lambda c: mm(ds[..., c], k[:, :, c]), n, CHUNK)
    dk = _partials(lambda c: mm(ds[:, :, c].transpose(-1, -2), q[:, :, c]), n, HALF)
    dv = _partials(lambda c: mm(pb[:, :, c].transpose(-1, -2), do[:, :, c]), n, HALF)
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


@pytest.mark.parametrize("dh", [32, 64])
def test_q_blocked_bf16_model_matches_jax(dh):
    """Kernel 9's bf16 tensor-core arithmetic at S = 1024 against the JAX
    package's ``_backward`` on the query-blocked route (the Pallas kernel
    in interpret mode, bf16 inputs), a full row, a row padded across a
    512-key block and a fully masked one: each gradient within 3e-2 of
    each (batch row, head)'s largest reference magnitude."""
    s = 1024
    assert tfa.attention_route(s) == "q_blocked"
    q, k, v, do, mask = _inputs(3, 2, s, seed=dh + 31, np_dtype=ml_dtypes.bfloat16, dh=dh)
    got = q_blocked_bf16_model(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (q, k, v, do)),
                               torch.from_numpy(mask))
    want = jfa._backward(jnp.asarray(mask), *(jnp.asarray(a) for a in (q, k, v, do)))
    _assert_per_head_close(got, want)


def kv_blocked_bf16_model(q, k, v, o, lse, do, mask):
    """Kernels 10 and 11 in bf16 on the bf16 tensor cores, on f32 tensors
    that hold bf16 values, with the forward's lse [B, h, S]: products and
    sums as in ``q_blocked_bf16_model``; P = exp(s - lse), no division;
    delta = rowsum(dO O) in f32; dS = P (dP - delta) scale; P and dS
    rounded to bf16 before their products; dQ a sum of per-64-key partials
    in f32, dK and dV of per-32-query partials; the gradients rounded to
    bf16 once."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def mm(a, b):
        return (a.double() @ b.double()).float()

    s = mm(q, k.transpose(-1, -2)) * scale + mask_bias(mask)[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    delta = (do.double() * o.double()).sum(dim=-1, keepdim=True).float()
    dp = mm(do, v.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()
    n = q.shape[2]
    dq = _partials(lambda c: mm(ds[..., c], k[:, :, c]), n, CHUNK)
    dk = _partials(lambda c: mm(ds[:, :, c].transpose(-1, -2), q[:, :, c]), n, HALF)
    dv = _partials(lambda c: mm(pb[:, :, c].transpose(-1, -2), do[:, :, c]), n, HALF)
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def _assert_per_head_close(got, want):
    """Each gradient within 3e-2 of each (batch row, head)'s largest
    reference magnitude."""
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(a).all(), name
        for r in range(a.shape[0]):
            for h in range(a.shape[1]):
                np.testing.assert_allclose(a[r, h], w[r, h], atol=BF16_REL * np.abs(w[r, h]).max(), rtol=0,
                                           err_msg=f"{name} row {r} head {h}")


@pytest.mark.parametrize("dh", [32, 64])
def test_kv_blocked_bf16_model_matches_jax(dh, kv_blocked):
    """Kernels 10 and 11's bf16 tensor-core arithmetic at S = 1024 against
    the JAX package's ``_backward_kv_blocked`` (the Pallas kernels in
    interpret mode, bf16 inputs), both fed the JAX KV-blocked forward's o
    and lse: a full row, a row padded across a 512-key block and a fully
    masked one (P = 1 for every key); each gradient within 3e-2 of each
    (batch row, head)'s largest reference magnitude."""
    s = 1024
    assert tfa.attention_route(s) == "kv_blocked"
    q, k, v, do, mask = _inputs(3, 2, s, seed=dh + 41, np_dtype=ml_dtypes.bfloat16, dh=dh)
    j_mask, (jq, jk, jv, jdo) = jnp.asarray(mask), (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = jfa._forward(jq, jk, jv, j_mask)
    assert lse is not None
    want = jfa._backward_kv_blocked(j_mask, jq, jk, jv, o, lse, jdo)
    got = kv_blocked_bf16_model(*(torch.from_numpy(np.array(a, np.float32)) for a in (q, k, v, o, lse, do)),
                                torch.from_numpy(mask))
    _assert_per_head_close(got, want)


def _recording_kernels(monkeypatch, calls, limits=(1600, 1472)):
    """Every CUDA wrapper replaced by its plain version, recording its
    name, the single-tile kernels' shared-memory limits set to ``limits``
    (forward, backward; by default two limits past S = 512, so that the
    single-tile kernels serve every single-tile S of the tests), and the
    dispatch made to believe the tensors lie on the card: the control flow
    of a CUDA forward and backward, run on the CPU."""
    monkeypatch.setattr(tfa, "_use_kernel", lambda t, plain: not plain)
    monkeypatch.setattr(tfa, "single_tile_max_s", lambda direction, head_dim, device=None, dtype=None: dict(
        zip(("fwd", "bwd"), limits))[direction])

    def fwd(q, k, v, o, mask, counter="flash_attention_fwd"):
        calls.append("fwd")
        o.copy_(tfa.attention_forward_plain(q, k, v, mask))

    def tc(q, k, v, o, mask):
        calls.append("tc")
        o.copy_(tfa.attention_forward_plain(q, k, v, mask))

    def q_blocked(q, k, v, o, mask):
        calls.append("q_blocked")
        o.copy_(tfa.attention_q_blocked_plain(q, k, v, mask))

    def kv_blocked(q, k, v, o, mask):
        calls.append("kv_blocked")
        out, lse = tfa.attention_kv_blocked_plain(q, k, v, mask)
        o.copy_(out)
        return lse

    def bwd(q, k, v, do, dq, dk, dv, mask):
        calls.append("bwd")
        for out, g in zip((dq, dk, dv), tfa.attention_backward_plain(q, k, v, do, mask)):
            out.copy_(g)

    def bwd_q_blocked(q, k, v, do, dq, dk, dv, mask):
        calls.append("bwd_q_blocked")
        for out, g in zip((dq, dk, dv), tfa.attention_bwd_q_blocked_plain(q, k, v, do, mask)):
            out.copy_(g)

    stash = {}

    def bwd_dq(q, k, v, o, lse, do, dq, mask):
        calls.append("bwd_dq_kv_blocked")
        grads = tfa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)
        dq.copy_(grads[0])
        stash["dkv"], stash["delta"] = grads[1:], (do.float() * o.float()).sum(dim=-1)
        return stash["delta"]

    def bwd_dkv(q, k, v, do, lse, delta, dk, dv, mask):
        calls.append("bwd_dkv_kv_blocked")
        assert delta is stash["delta"]
        for out, g in zip((dk, dv), stash["dkv"]):
            out.copy_(g)

    for name, fn in (("_forward_kernel", fwd), ("_tc_kernel", tc), ("_q_blocked_kernel", q_blocked),
                     ("_kv_blocked_kernel", kv_blocked), ("_backward_kernel", bwd),
                     ("_bwd_q_blocked_kernel", bwd_q_blocked), ("_bwd_dq_kv_blocked_kernel", bwd_dq),
                     ("_bwd_dkv_kv_blocked_kernel", bwd_dkv)):
        monkeypatch.setattr(tfa, name, fn)


@pytest.mark.parametrize(
    "s,calls,limits",
    [(512, ["fwd", "bwd"], (1600, 1472)), (768, ["q_blocked", "bwd_q_blocked"], (1600, 1472)),
     (4352, ["q_blocked", "bwd_q_blocked"], (1600, 1472)),
     (1024, ["kv_blocked", "bwd_dq_kv_blocked", "bwd_dkv_kv_blocked"], (1600, 1472)),
     (300, ["q_blocked", "bwd_q_blocked"], (256, 256)), (300, ["fwd", "bwd_q_blocked"], (320, 256))],
)
def test_backward_dispatch_follows_bwd_rule(s, calls, limits, monkeypatch, kv_blocked):
    """On the card the backward takes the kernel the reference's
    ``_bwd_rule`` takes: kernels 10 and 11 (the dQ pass's delta handed to
    the dK/dV pass) after a forward that left an lse, kernel 9 at another
    blocked S, kernel 8 else, and kernel 9's code for a single-tile S past
    kernel 8's shared-memory limit (as the f32 forward past kernel 5's
    takes kernel 6's code); the gradients are the plain route's."""
    seen = []
    _recording_kernels(monkeypatch, seen, limits)
    q, k, v, cot, mask = _inputs(3, 1, s, seed=s, np_dtype=np.float32)
    cot_t, mask_t = torch.from_numpy(cot), torch.from_numpy(mask)

    def grads(plain):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        (tfa.flash_attention(*xs, mask_t, plain=plain) * cot_t).sum().backward()
        return [x.grad for x in xs]

    got = grads(False)
    assert seen == calls
    for a, w in zip(got, grads(True)):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    assert seen == calls  # plain=True reached no wrapper


@pytest.mark.parametrize(
    "dtype,s,calls,limits",
    [("f32", 200, ["fwd", "bwd"], (256, 256)), ("f32", 300, ["q_blocked", "bwd_q_blocked"], (256, 256)),
     ("bf16", 300, ["tc", "bwd_q_blocked"], (256, 256)), ("bf16", 200, ["tc", "bwd"], (256, 256))],
)
def test_fused_qkv_dispatch_past_the_limit(dtype, s, calls, limits, monkeypatch):
    """``fused_qkv_attention`` on the card (kernel 4 and its backward,
    kernel 8): f32 on the single-tile kernel up to its shared-memory limit
    and on the query-blocked kernels' code past it, bf16 forward on the
    tensor-core kernel at any S; the gradients are the plain route's."""
    np_dtype, t_dtype = DTYPES[dtype]
    seen = []
    _recording_kernels(monkeypatch, seen, limits)
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.standard_normal((2, s, 3 * 2 * 32)).astype(np.float32)).to(t_dtype)
    cot = torch.from_numpy(rng.standard_normal((2, s, 2 * 32)).astype(np.float32))
    mask = torch.ones(2, s, dtype=torch.int32)
    mask[1, s // 2 :] = 0

    def grads(plain):
        x = qkv.clone().requires_grad_(True)
        (tfa.fused_qkv_attention(x, mask, 2, plain=plain).float() * cot).sum().backward()
        return x.grad

    got = grads(False)
    assert seen == calls
    torch.testing.assert_close(got, grads(True), atol=1e-5, rtol=1e-5)


def _long_config():
    return JaxConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
                     max_position_embeddings=1024)


@pytest.mark.parametrize("s", [768, 1024])
def test_bert_forward_pallas_long_gradients_match_jax(s, kv_blocked):
    """Gradients of a masked-mean-pooled ``bert_forward(attention_impl=
    "pallas")`` w.r.t. every parameter against JAX's (kernels 6 and 9 at
    S = 768; 7, 10 and 11 at S = 1024), the last row padded."""
    config = _long_config()
    jparams = jax_init_params(jax.random.PRNGKey(5), config)
    rng = np.random.default_rng(s + 1)
    ids = rng.integers(5, config.vocab_size, size=(2, s)).astype(np.int32)
    mask = np.ones((2, s), np.int32)
    mask[1, s - 300 :] = 0
    w = rng.standard_normal(config.hidden_size).astype(np.float32)

    def j_loss(p):
        hidden = jax_bert_forward(p, jnp.asarray(ids), jnp.asarray(mask), num_heads=config.num_heads,
                                  attention_impl="pallas")
        m = jnp.asarray(mask, jnp.float32)[..., None]
        return jnp.sum(jnp.sum(hidden * m, axis=1) / jnp.sum(m, axis=1) @ jnp.asarray(w))

    j_grads = jax.tree.leaves(jax.grad(j_loss)(jparams))
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    for t in param_leaves(params):
        t.requires_grad_(True)
    hidden = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask), num_heads=config.num_heads,
                          attention_impl="pallas")
    m = torch.from_numpy(mask).float()[..., None]
    ((hidden * m).sum(dim=1) / m.sum(dim=1) @ torch.from_numpy(w)).sum().backward()
    leaves = param_leaves(params)
    assert len(leaves) == len(j_grads)
    for t, g in zip(leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-3)


def test_contrastive_loss_long_passages_matches_jax():
    """One ``contrastive_loss`` value and gradient with q and p padded to
    S = 1024 (the passages 300-1024 tokens long): the port's "pallas" route
    (the plain query-blocked forward and backward) against the JAX loss,
    which takes no ``attention_impl`` and runs its "xla" route on the CPU."""
    config = _long_config()
    jparams = jax_init_params(jax.random.PRNGKey(6), config)
    rng = np.random.default_rng(7)
    b, s = 4, 1024
    lengths = {"q": [12, 20, 9, 16], "p": [s, 700, 300, 900]}
    batch = {}
    for side, lens in lengths.items():
        batch[f"{side}_ids"] = rng.integers(5, config.vocab_size, size=(b, s)).astype(np.int32)
        batch[f"{side}_mask"] = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jc.contrastive_loss(p, batch, num_heads=config.num_heads, temperature=0.05)
    )(jparams)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    for t in param_leaves(params):
        t.requires_grad_(True)
    assert tfa.attention_route(s) == "q_blocked"
    loss = tc.contrastive_loss(params, batch, num_heads=config.num_heads, temperature=0.05, attention_impl="pallas")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for t, g in zip(param_leaves(params), jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4)


def test_contrastive_loss_bf16_kv_blocked_matches_jax(kv_blocked):
    """One bf16 ``contrastive_loss`` value and gradient with q and p padded
    to S = 1024 on the KV-blocked route (kernel 7 forward, kernels 10 and 11
    backward: the port's "pallas" route, on the CPU their plain versions)
    against the JAX package's bf16 loss, which takes no ``attention_impl``
    and runs its "xla" route on the CPU. bf16 tolerances: the loss rel 1e-3
    (the f32 loss lies 3.5e-3 away), the whole gradient's cosine above
    0.9999 (chip_smoke.py's GRAD_COS) and each tensor within 3e-2 of its
    largest reference magnitude (the port's bf16 tolerance)."""
    config = _long_config()
    jparams = jax_init_params(jax.random.PRNGKey(6), config)
    rng = np.random.default_rng(7)
    b, s = 4, 1024
    lengths = {"q": [12, 20, 9, 16], "p": [s, 700, 300, 900]}
    batch = {}
    for side, lens in lengths.items():
        batch[f"{side}_ids"] = rng.integers(5, config.vocab_size, size=(b, s)).astype(np.int32)
        batch[f"{side}_mask"] = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jc.contrastive_loss(p, batch, num_heads=config.num_heads, temperature=0.05,
                                      compute_dtype=jnp.bfloat16)
    )(jparams)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    for t in param_leaves(params):
        t.requires_grad_(True)
    assert tfa.attention_route(s) == "kv_blocked"
    loss = tc.contrastive_loss(params, batch, num_heads=config.num_heads, temperature=0.05,
                               compute_dtype=torch.bfloat16, attention_impl="pallas")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-3)
    got = [t.grad.double().flatten() for t in param_leaves(params)]
    want = [torch.from_numpy(np.asarray(g, np.float64)).flatten() for g in jax.tree.leaves(j_grads)]
    assert len(got) == len(want)
    assert torch.nn.functional.cosine_similarity(torch.cat(got), torch.cat(want), dim=0).item() > 0.9999
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= BF16_REL * w.abs().max().item()
