"""The port's bf16 single-tile backward (TPU kernel 8,
``_attention_bwd_kernel``) and the bf16 short-context gradient that
launches it on the card, against the JAX package on the CPU: the JAX
package's Pallas kernels run in interpret mode there, as
tests/test_flash_attention.py runs them, and the port's autograd functions
take their plain versions (the yardsticks tests/test_torch_kernels_cuda.py
and chip_smoke.py hold the CUDA kernels to on the card).

- ``fused_qkv_attention`` in bf16 at S = 64, 100 (ragged) and 128 (the
  CUDA kernel's one-launch range), with a half-masked and a fully masked
  row: output and the gradient of sum(out * cot);
- the bf16 "pallas" route of ``bert_forward`` (kernel 4 forward, kernel 8
  backward): the gradient of a scalar of the CLS-pooled output with respect
  to every parameter, on the tiny config (4 heads of 16) and at head_dim
  32 (2 heads of 32), at S = 16 and at a ragged S = 40, the weights
  carried across by ``dial_rag_tpu_torch.weights``.

Tolerance: 3e-2 of each tensor's largest reference magnitude (per batch
row for the attention gradients), the port's bf16 tolerance made relative
because gradients are not O(1); the bf16 attention output 3e-2.
"""

import dataclasses

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
from dial_rag_tpu_torch.weights import param_leaves, params_from_jax_numpy

BF16_REL = 3e-2


@pytest.mark.parametrize("s", [64, 100, 128])
def test_fused_qkv_bf16_backward_matches_jax(s):
    """Kernel 4's forward and kernel 8's backward in bf16 on a packed qkv
    [3, S, 3 x 2 x 32]: row 1 masked from S/2 on, row 2 fully masked; the
    gradients held per batch row."""
    b, heads, dh = 3, 2, 32
    rng = np.random.default_rng(s)
    qkv = rng.standard_normal((b, s, 3 * heads * dh)).astype(np.float32).astype(ml_dtypes.bfloat16)
    cot = rng.standard_normal((b, s, heads * dh)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2 :] = 0
    mask[2] = 0
    leaf = torch.from_numpy(np.asarray(qkv, np.float32)).to(torch.bfloat16).requires_grad_(True)
    out = tfa.fused_qkv_attention(leaf, torch.from_numpy(mask), heads)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    j_mask, j_cot = jnp.asarray(mask), jnp.asarray(cot)

    def j_loss(x):
        o = jfa.fused_qkv_attention(x, j_mask, heads)
        return jnp.sum(o.astype(jnp.float32) * j_cot), o

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(qkv))
    assert out.dtype == leaf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(j_out, np.float32), atol=BF16_REL)
    got, want = leaf.grad.float().numpy(), np.asarray(j_grad, np.float32)
    assert np.isfinite(got).all()
    for row_got, row_want in zip(got, want):
        np.testing.assert_allclose(row_got, row_want, atol=BF16_REL * np.abs(row_want).max(), rtol=0)


@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("s", [16, 40])
def test_bert_forward_pallas_bf16_gradients_match_jax(s, heads):
    """The gradient of sum(CLS-pooled hidden state . w) through bf16
    ``bert_forward(attention_impl="pallas")``, exact GELU, with respect to
    every parameter: the port (kernel 4's and kernel 8's plain versions)
    against JAX (the Pallas kernels in interpret mode), the last row padded
    from S/3 on; each tensor within 3e-2 of its largest reference
    magnitude."""
    config = dataclasses.replace(JaxConfig.tiny(), num_heads=heads)
    jparams = jax_init_params(jax.random.PRNGKey(s + heads), config)
    rng = np.random.default_rng(s)
    ids = rng.integers(5, config.vocab_size, size=(3, s)).astype(np.int32)
    mask = np.ones((3, s), np.int32)
    mask[2, s // 3 :] = 0
    w = rng.standard_normal(config.hidden_size).astype(np.float32)

    def j_loss(p):
        hidden = jax_bert_forward(p, jnp.asarray(ids), jnp.asarray(mask), num_heads=heads,
                                  compute_dtype=jnp.bfloat16, attention_impl="pallas", gelu="exact")
        return jnp.sum(hidden[:, 0, :].astype(jnp.float32) @ jnp.asarray(w))

    j_grads = jax.tree.leaves(jax.grad(j_loss)(jparams))
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    hidden = bert_forward(params, torch.from_numpy(ids).long(), torch.from_numpy(mask), num_heads=heads,
                          compute_dtype=torch.bfloat16, attention_impl="pallas", gelu="exact")
    assert hidden.dtype == torch.bfloat16
    (hidden[:, 0, :].float() @ torch.from_numpy(w)).sum().backward()
    assert len(leaves) == len(j_grads)
    for t, g in zip(leaves, j_grads):
        want = np.asarray(g, np.float32)
        got = t.grad.float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=BF16_REL * np.abs(want).max(), rtol=0)
