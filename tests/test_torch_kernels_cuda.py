"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip without one. This file imports no JAX,
so it runs on a machine with the card and PyTorch only:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the root conftest configures JAX for the CPU tests.)
Tolerance: bf16 3e-2, the reference's own bf16 tolerance for its fused
blocks (tests/test_fused_encoder.py).
"""

import pytest
import torch

from dial_rag_tpu_torch.ops import fused_encoder as tfe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (1, 64)])
def test_kernels_match_plain_on_card(cuda_device, b, s):
    """Both kernels against their plain versions at bge-small widths,
    bf16, a ragged S (not a multiple of the 64-row tiles), the longest S
    and a masked row; bf16 tolerance 3e-2."""
    hid, heads, inter = 384, 12, 1536
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to(cuda_device, dtype)

    x = rnd(b, s, hid, dtype=torch.bfloat16)
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[-1, 40:] = 0
    mask = mask.to(cuda_device)
    ones, zeros = torch.ones(hid, device=cuda_device), torch.zeros(hid, device=cuda_device)
    attn_w = (
        rnd(hid, 3 * hid, scale=0.05, dtype=torch.bfloat16), rnd(3 * hid, scale=0.02),
        rnd(hid, hid, scale=0.05, dtype=torch.bfloat16), rnd(hid, scale=0.02), ones, zeros,
    )
    ffn_w = (
        rnd(hid, inter, scale=0.05, dtype=torch.bfloat16), rnd(inter, scale=0.02),
        rnd(inter, hid, scale=0.05, dtype=torch.bfloat16), rnd(hid, scale=0.02), ones, zeros,
    )
    out = tfe.fused_attention_block(x, mask, *attn_w, heads)
    ref = tfe.fused_attention_block_plain(x, mask, *attn_w, heads)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2
    out = tfe.fused_ffn_block(x, *ffn_w)
    ref = tfe.fused_ffn_block_plain(x, *ffn_w)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_input_they_do_not_take(cuda_device):
    """A CUDA tensor goes to the kernel or raises; it never falls back."""
    x = torch.zeros(2, 8, 384, device=cuda_device)  # f32: the kernels take bf16
    w = torch.zeros(384, 1536, device=cuda_device, dtype=torch.bfloat16)
    v = torch.zeros(1536, device=cuda_device)
    h = torch.zeros(384, device=cuda_device)
    with pytest.raises(ValueError):
        tfe.fused_ffn_block(x, w, v, w.T.contiguous(), h, h, h)


def test_cuda_requested_without_card_raises(monkeypatch):
    from dial_rag_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
