"""The port's long-sequence attention (S > 512) against the JAX package's
Pallas kernels, run in interpret mode on the CPU as
tests/test_flash_attention.py runs them: ``_attention_q_blocked_kernel``
(kernel 6) and ``_attention_kv_blocked_fwd_kernel`` (kernel 7, with its
log-sum-exp), each in f32 and bf16 at head_dim 32 and 64, and the whole
encoder's "pallas" route at S = 768 and S = 1024. On a CPU tensor the port's ``flash_attention``
runs the plain versions that the CUDA kernels are held to on the card
(tests/test_torch_kernels_cuda.py). The blocked backward is held against
the reference in tests/test_torch_long_backward.py.

Tolerances: f32 o atol 5e-6 and lse 1e-5, the reference's long-context
tolerances (tests/test_flash_attention.py:142-211); bf16 3e-2, the
reference's bf16 tolerance; hidden states atol 1e-5, the reference's
pallas-vs-xla encoder tolerance. Kernel 7 runs at S = 1024 with
``_Q_BLOCKED_MAX_S`` lowered to 512 in both packages, as the reference's
own test lowers it, so the CPU run stays small; in bf16 also at S = 1536
with the row max rising from block to block (the 512-key rescale).
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
from dial_rag_tpu_torch.models.bert import bert_forward
from dial_rag_tpu_torch.ops import flash_attention as tfa
from dial_rag_tpu_torch.weights import params_from_jax_numpy

DTYPES = {
    "f32": (np.float32, torch.float32, 5e-6),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16, 3e-2),
}


@pytest.fixture
def kv_blocked(monkeypatch):
    """Lowers the KV-blocked threshold to 512 in both packages."""
    monkeypatch.setattr(jfa, "_Q_BLOCKED_MAX_S", 512)
    monkeypatch.setattr(tfa, "_Q_BLOCKED_MAX_S", 512)


def _inputs(b, h, s, seed, np_dtype, pad_from, dh=32):
    """q, k, v [B, h, S, dh] and a mask whose last row is padded from
    ``pad_from`` on."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32).astype(np_dtype) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[-1, pad_from:] = 0
    return q, k, v, mask


def _run(q, k, v, mask, t_dtype):
    """(port o, port lse, JAX o, JAX lse) of the reference's ``_forward``."""
    o, lse = tfa._forward(*(torch.from_numpy(np.asarray(a, np.float32)).to(t_dtype) for a in (q, k, v)),
                          torch.from_numpy(mask))
    j_o, j_lse = jfa._forward(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    return (o.float().numpy(), None if lse is None else lse.numpy(), np.asarray(j_o, np.float32),
            None if j_lse is None else np.asarray(j_lse))


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_q_blocked_matches_jax(dtype, dh):
    """Kernel 6 at S = 768 (three 256-query blocks) with a padded tail, at
    head_dim 32 and 64."""
    np_dtype, t_dtype, atol = DTYPES[dtype]
    s = 768
    assert tfa.attention_route(s) == "q_blocked"
    q, k, v, mask = _inputs(2, 2, s, seed=11, np_dtype=np_dtype, pad_from=s - 100, dh=dh)
    o, lse, j_o, j_lse = _run(q, k, v, mask, t_dtype)
    assert lse is None and j_lse is None
    np.testing.assert_allclose(o[0], j_o[0], atol=atol)
    np.testing.assert_allclose(o[1, :, : s - 100], j_o[1, :, : s - 100], atol=atol)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_blocked_matches_jax(dtype, dh, kv_blocked):
    """Kernel 7 at S = 1024 (two 512-key blocks), padding crossing the
    block boundary; o and the log-sum-exp, at head_dim 32 and 64."""
    np_dtype, t_dtype, atol = DTYPES[dtype]
    s = 1024
    assert tfa.attention_route(s) == "kv_blocked"
    q, k, v, mask = _inputs(2, 2, s, seed=12, np_dtype=np_dtype, pad_from=s // 3, dh=dh)
    o, lse, j_o, j_lse = _run(q, k, v, mask, t_dtype)
    np.testing.assert_allclose(o[0], j_o[0], atol=atol)
    np.testing.assert_allclose(o[1, :, : s // 3], j_o[1, :, : s // 3], atol=atol)
    assert lse.shape == j_lse.shape == (2, 2, s)
    np.testing.assert_allclose(lse, j_lse, atol=1e-5 if dtype == "f32" else 3e-2)


@pytest.mark.parametrize("dh", [32, 64])
def test_kv_blocked_rising_max_matches_jax(dh, kv_blocked):
    """Kernel 7 in bf16 at S = 1536 (three 512-key blocks) with a score
    offset that grows block by block (q[..., 0] = 1, k[..., 0] = 0, 32, 64
    per block), so every row's max rises in the second and third blocks and
    corr = exp(m - m_next) < 1 rescales l and the accumulator, where
    bf16(e) is formed against the block's own max; the last row padded
    inside the third block. o within 3e-2, lse within the file's bf16
    tolerance, at head_dim 32 and 64."""
    np_dtype, t_dtype, atol = DTYPES["bf16"]
    s, blk = 1536, tfa._KV_BLOCK
    assert tfa.attention_route(s) == "kv_blocked" and s == 3 * blk
    q, k, v, mask = _inputs(2, 2, s, seed=14, np_dtype=np.float32, pad_from=s - 200, dh=dh)
    q[..., 0] = 1.0
    k[..., 0] = np.repeat([0.0, 32.0, 64.0], blk)
    q, k, v = (a.astype(np_dtype) for a in (q, k, v))
    scores = np.einsum("bhqd,bhkd->bhqk", np.asarray(q, np.float64), np.asarray(k, np.float64))
    scores = np.where(mask[:, None, None, :] == 1, scores, -np.inf)
    block_max = scores.reshape(2, 2, s, 3, blk).max(axis=-1)
    assert (np.diff(block_max, axis=-1) > 0).all()  # the max rises at blocks 2 and 3 in every row
    o, lse, j_o, j_lse = _run(q, k, v, mask, t_dtype)
    np.testing.assert_allclose(o[0], j_o[0], atol=atol)
    np.testing.assert_allclose(o[1, :, : s - 200], j_o[1, :, : s - 200], atol=atol)
    np.testing.assert_allclose(lse, j_lse, atol=3e-2)


@pytest.mark.parametrize("route,s", [("q_blocked", 768), ("kv_blocked", 1024)])
def test_fully_masked_row_stays_finite(route, s, kv_blocked):
    """f32.min bias, never -inf: a row with no real token gets uniform
    weights in both blocked kernels, as in the reference."""
    q, k, v, mask = _inputs(1, 1, s, seed=13, np_dtype=np.float32, pad_from=0)
    o, lse, j_o, j_lse = _run(q, k, v, mask, torch.float32)
    assert tfa.attention_route(s) == route and np.isfinite(o).all()
    np.testing.assert_allclose(o, j_o, atol=5e-6)
    np.testing.assert_allclose(o[0, 0, 0], v[0, 0].mean(axis=0), atol=5e-6)
    if lse is not None:
        np.testing.assert_allclose(lse, j_lse, rtol=1e-6)


@pytest.mark.parametrize("s", [768, 1024])
def test_bert_forward_pallas_long_matches_jax(s, kv_blocked):
    """JAX ``bert_forward(attention_impl="pallas")`` (kernels 6 and 7 in
    interpret mode) against the port's "pallas" route on a 2-layer config
    with 1024 positions and heads of 32, the last row padded."""
    config = JaxConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
                       intermediate_size=128, max_position_embeddings=1024)
    jparams = jax_init_params(jax.random.PRNGKey(4), config)
    rng = np.random.default_rng(s)
    ids = rng.integers(5, config.vocab_size, size=(2, s)).astype(np.int32)
    mask = np.ones((2, s), np.int32)
    mask[1, s - 300 :] = 0
    j_hidden = jax_bert_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), num_heads=config.num_heads,
                                attention_impl="pallas")
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    tfa.reset_launches()
    hidden = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          num_heads=config.num_heads, attention_impl="pallas")
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)  # the CPU runs the plain versions
    np.testing.assert_allclose(hidden[0].numpy(), np.asarray(j_hidden[0]), atol=1e-5)
    np.testing.assert_allclose(hidden[1, : s - 300].numpy(), np.asarray(j_hidden[1, : s - 300]), atol=1e-5)


@pytest.mark.parametrize(
    "s,route",
    [(512, "single_tile"), (520, "single_tile"), (768, "q_blocked"), (4096, "q_blocked"),
     (4352, "q_blocked"), (4608, "kv_blocked"), (8192, "kv_blocked")],
)
def test_route_follows_the_reference(s, route):
    """The reference's ``_forward`` thresholds (4352 is a multiple of 256
    but not of 512, so it stays query-blocked)."""
    assert tfa.attention_route(s) == route
    assert (tfa._FULL_TILE_MAX_S, tfa._Q_BLOCK, tfa._Q_BLOCKED_MAX_S, tfa._KV_BLOCK) == (
        jfa._FULL_TILE_MAX_S, jfa._Q_BLOCK, jfa._Q_BLOCKED_MAX_S, jfa._KV_BLOCK)
