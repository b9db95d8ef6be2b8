"""The port's fused encoder blocks against the JAX package's.

The JAX blocks run their Pallas kernels in interpret mode on the CPU (as
tests/test_fused_encoder.py runs them); the port's wrappers take their
plain PyTorch versions for CPU tensors. Same numpy inputs from a seed,
the tolerances of tests/test_fused_encoder.py: f32 2e-5, bf16 3e-2 (one
bf16 ulp at the LayerNorm output's scale). The CUDA kernels themselves are
held against the plain versions on the card in test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dial_rag_tpu.ops import fused_encoder as jfe
from dial_rag_tpu_torch.ops import fused_encoder as tfe

B, S, H, HEADS, INTER = 2, 64, 64, 4, 256
CASES = [(np.float32, torch.float32, 2e-5), (ml_dtypes.bfloat16, torch.bfloat16, 3e-2)]


def _weights(rng, shapes):
    ws = [rng.standard_normal(s).astype(np.float32) * (0.05 if len(s) == 2 else 0.02) for s in shapes]
    return ws + [np.ones(H, np.float32), np.zeros(H, np.float32)]


def _x(rng, np_dtype):
    return rng.standard_normal((B, S, H)).astype(np.float32).astype(np_dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("np_dtype,t_dtype,atol", CASES)
def test_ffn_block_matches_jax(np_dtype, t_dtype, atol):
    rng = np.random.default_rng(0)
    x = _x(rng, np_dtype)
    w = _weights(rng, [(H, INTER), (INTER,), (INTER, H), (H,)])
    ref = jfe.fused_ffn_block(jnp.asarray(x), *map(jnp.asarray, w))
    out = tfe.fused_ffn_block(_to_torch(x, t_dtype), *(_to_torch(a, torch.float32) for a in w))
    assert out.dtype == t_dtype and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("np_dtype,t_dtype,atol", CASES)
def test_attention_block_matches_jax(np_dtype, t_dtype, atol):
    rng = np.random.default_rng(1)
    x = _x(rng, np_dtype)
    w = _weights(rng, [(H, 3 * H), (3 * H,), (H, H), (H,)])
    mask = np.ones((B, S), np.int32)
    mask[1, S // 3 :] = 0
    ref = jfe.fused_attention_block(jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, w), HEADS)
    out = tfe.fused_attention_block(
        _to_torch(x, t_dtype), torch.from_numpy(mask), *(_to_torch(a, torch.float32) for a in w), HEADS
    )
    assert out.dtype == t_dtype and out.shape == x.shape
    # pad query rows are garbage in both; compare the real tokens
    np.testing.assert_allclose(out[0].float().numpy(), np.asarray(ref[0], np.float32), atol=atol)
    np.testing.assert_allclose(
        out[1, : S // 3].float().numpy(), np.asarray(ref[1, : S // 3], np.float32), atol=atol
    )


def test_cpu_wrappers_count_no_launch():
    tfe.reset_launches()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_x(rng, np.float32))
    w = [torch.from_numpy(a) for a in _weights(rng, [(H, INTER), (INTER,), (INTER, H), (H,)])]
    tfe.fused_ffn_block(x, *w)
    assert tfe.LAUNCHES == {"fused_attention_block": 0, "fused_ffn_block": 0}
