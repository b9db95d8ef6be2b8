"""The port's blocked attention backward (S > 512) against the JAX
package's, whose Pallas kernels run in interpret mode on the CPU as
tests/test_flash_attention.py runs them: ``_attention_bwd_q_blocked_kernel``
(kernel 9) at S = 1024 and 4352, and ``_bwd_dq_kv_blocked_kernel`` with
``_bwd_dkv_kv_blocked_kernel`` (kernels 10 and 11) at S = 1024, each in f32
and bf16, with a ragged row whose padding crosses a 512-key block and a
fully masked row; then the gradients of a pooled ``bert_forward`` on the
"pallas" route and one ``contrastive_loss`` with its passages at a blocked
S. On a CPU tensor the port's backward runs the plain versions that the
CUDA kernels are held to on the card (tests/test_torch_kernels_cuda.py).

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
from dial_rag_tpu_torch.training import contrastive as tc
from dial_rag_tpu_torch.weights import param_leaves, params_from_jax_numpy

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
BF16_REL = 3e-2


@pytest.fixture
def kv_blocked(monkeypatch):
    """Lowers the KV-blocked threshold to 512 in both packages."""
    monkeypatch.setattr(jfa, "_Q_BLOCKED_MAX_S", 512)
    monkeypatch.setattr(tfa, "_Q_BLOCKED_MAX_S", 512)


def _inputs(b, h, s, seed, np_dtype):
    """q, k, v and a cotangent [B, h, S, 32], standard normal; a mask whose
    second-to-last row is padded from S/3 on (crossing the 512-key block at
    S = 1024) and whose last row is fully masked (B >= 3 keeps a full row)."""
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((b, h, s, 32)).astype(np.float32).astype(np_dtype) for _ in range(4))
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
@pytest.mark.parametrize("b,h,s", [(3, 2, 1024), (2, 1, 4352)])
def test_q_blocked_backward_matches_jax(dtype, b, h, s):
    """Kernel 9: at S = 1024, and at S = 4352 (a multiple of 256 but not
    of 512 above 4096: still query-blocked) on one head."""
    np_dtype, t_dtype = DTYPES[dtype]
    assert tfa.attention_route(s) == "q_blocked"
    port, ref = _grads(*_inputs(b, h, s, seed=s + b, np_dtype=np_dtype), t_dtype)
    _assert_grads_close(port, ref, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_blocked_backward_matches_jax(dtype, kv_blocked):
    """Kernels 10 and 11 at S = 1024 (two 512-key blocks, four 256-query
    blocks): P from the forward's lse, delta = rowsum(dO O)."""
    np_dtype, t_dtype = DTYPES[dtype]
    assert tfa.attention_route(1024) == "kv_blocked"
    port, ref = _grads(*_inputs(3, 2, 1024, seed=21, np_dtype=np_dtype), t_dtype)
    _assert_grads_close(port, ref, dtype)


def _recording_kernels(monkeypatch, calls):
    """Every CUDA wrapper replaced by its plain version, recording its
    name, and the dispatch made to believe the tensors lie on the card:
    the control flow of a CUDA backward, run on the CPU."""
    monkeypatch.setattr(tfa, "_use_kernel", lambda t, plain: not plain)

    def fwd(q, k, v, o, mask):
        calls.append("fwd")
        o.copy_(tfa.attention_forward_plain(q, k, v, mask))

    def long_fwd(route, q, k, v, mask):
        calls.append(route)
        if route == "q_blocked":
            return tfa.attention_q_blocked_plain(q, k, v, mask), None
        return tfa.attention_kv_blocked_plain(q, k, v, mask)

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

    for name, fn in (("_forward_kernel", fwd), ("_long_kernel", long_fwd), ("_backward_kernel", bwd),
                     ("_bwd_q_blocked_kernel", bwd_q_blocked), ("_bwd_dq_kv_blocked_kernel", bwd_dq),
                     ("_bwd_dkv_kv_blocked_kernel", bwd_dkv)):
        monkeypatch.setattr(tfa, name, fn)


@pytest.mark.parametrize(
    "s,calls",
    [(512, ["fwd", "bwd"]), (768, ["q_blocked", "bwd_q_blocked"]), (4352, ["q_blocked", "bwd_q_blocked"]),
     (1024, ["kv_blocked", "bwd_dq_kv_blocked", "bwd_dkv_kv_blocked"])],
)
def test_backward_dispatch_follows_bwd_rule(s, calls, monkeypatch, kv_blocked):
    """On the card the backward takes the kernel the reference's
    ``_bwd_rule`` takes: kernels 10 and 11 (the dQ pass's delta handed to
    the dK/dV pass) after a forward that left an lse, kernel 9 at another
    blocked S, kernel 8 else; the gradients are the plain route's."""
    seen = []
    _recording_kernels(monkeypatch, seen)
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
