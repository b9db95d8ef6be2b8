"""The two fused blocks of a bge-small encoder layer (counterpart of
``dial_rag_tpu/ops/fused_encoder.py``).

- ``fused_attention_block``: ``LN(x + W_out.MHA(bf16(W_qkv.x + b_qkv)) + b_out)``;
- ``fused_ffn_block``: ``LN(x + W2.bf16(gelu_tanh(W1.x + b1)) + b2)``.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/fused_attention.cu``, ``csrc/fused_ffn.cu``) or raises; it never
falls back. On a CPU tensor it runs the plain PyTorch version beside it,
which follows the TPU kernel's own order of casts (``_attn_block_kernel``,
``_ffn_kernel``): products accumulate in f32 and are not rounded before
the bias, residual and LayerNorm; qkv, the probabilities, ctx and the
GELU output are cast to the compute type where the TPU kernel casts them.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels.
"""

import math

import torch

LAYERNORM_EPS = 1e-12
# widths the CUDA kernels are specialised for (bge-small)
KERNEL_HIDDEN = 384
KERNEL_HEAD_DIM = 32

LAUNCHES = {"fused_attention_block": 0, "fused_ffn_block": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_block(s: int) -> bool:
    """The reference's single-tile bound, kept so both route alike."""
    return s <= 512


def _f32_matmul(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """a . w with both cast to ``dtype`` and the product kept in f32 (the
    TPU kernels' ``preferred_element_type=float32``)."""
    return a.to(dtype).float() @ w.to(dtype).float()


def _layernorm_f32(r, scale, bias):
    mean = r.mean(dim=-1, keepdim=True)
    var = torch.square(r - mean).mean(dim=-1, keepdim=True)
    return (r - mean) * torch.rsqrt(var + LAYERNORM_EPS) * scale.float() + bias.float()


def mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF extended mask: ``(1 - mask) * finfo(f32).min``, never -inf."""
    return (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min


def fused_ffn_block_plain(x, w1, b1, w2, b2, g, beta):
    """Plain version of the FFN kernel, in ``_ffn_kernel``'s cast order."""
    dt = x.dtype
    h = _f32_matmul(x, w1, dt) + b1.float()
    h = torch.nn.functional.gelu(h, approximate="tanh").to(dt)
    y = _f32_matmul(h, w2, dt) + b2.float()
    r = x.float() + y
    return _layernorm_f32(r, g, beta).to(dt)


def fused_attention_block_plain(
    x, attention_mask, wqkv, bqkv, wout, bout, g, beta, num_heads
):
    """Plain version of the attention kernel, in ``_attn_block_kernel``'s
    cast order: f32 softmax normalised before the cast of P."""
    dt = x.dtype
    b, s, hid = x.shape
    dh = hid // num_heads
    scale = 1.0 / math.sqrt(dh)
    qkv = (_f32_matmul(x, wqkv, dt) + bqkv.float()).to(dt)
    qkv = qkv.reshape(b, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, S, Dh]
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * scale + mask_bias(attention_mask)[:, None, None, :]
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    probs = e / e.sum(dim=-1, keepdim=True)
    ctx = probs.to(dt).float() @ v.float()
    ctx = ctx.transpose(1, 2).reshape(b, s, hid).to(dt)
    attn_out = _f32_matmul(ctx, wout, dt) + bout.float()
    r = x.float() + attn_out
    return _layernorm_f32(r, g, beta).to(dt)


def _check_cuda(name, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be on the card with x, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_kernel_x(x):
    _check_cuda("x", x, torch.bfloat16)
    if x.ndim != 3 or x.shape[2] != KERNEL_HIDDEN:
        raise ValueError(
            f"the CUDA kernels take x [B, S, {KERNEL_HIDDEN}] bf16, got {tuple(x.shape)}"
        )


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def fused_attention_block(
    x, attention_mask, wqkv, bqkv, wout, bout, g, beta, num_heads
):
    """LN(x + W_out.Attention(W_qkv.x + b) + b_out). x: [B, S, H],
    mask: [B, S] (1 = real token); returns [B, S, H] in x's dtype. Weights
    are [in, out]."""
    if not x.is_cuda:
        return fused_attention_block_plain(
            x, attention_mask, wqkv, bqkv, wout, bout, g, beta, num_heads
        )
    from dial_rag_tpu_torch.ops._build import build_kernels

    _check_kernel_x(x)
    b, s, hid = x.shape
    if num_heads * KERNEL_HEAD_DIM != hid:
        raise ValueError(f"the attention kernel takes head_dim {KERNEL_HEAD_DIM}")
    if not supports_fused_block(s):
        raise ValueError(f"the attention kernel takes S <= 512, got {s}")
    mask = attention_mask.to(torch.int32).contiguous()
    _check_cuda("attention_mask", mask, torch.int32, (b, s))
    _check_cuda("wqkv", wqkv, torch.bfloat16, (hid, 3 * hid))
    _check_cuda("wout", wout, torch.bfloat16, (hid, hid))
    _check_cuda("bqkv", bqkv, torch.float32, (3 * hid,))
    for name, t in (("bout", bout), ("ln scale", g), ("ln bias", beta)):
        _check_cuda(name, t, torch.float32, (hid,))
    lib = build_kernels().libs["fused_attention"]
    qkv = torch.empty((b, s, 3 * hid), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dial_attention_block_bf16(
            x.data_ptr(), mask.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wout.data_ptr(), bout.data_ptr(), g.data_ptr(), beta.data_ptr(),
            qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            b, s, num_heads, 1.0 / math.sqrt(KERNEL_HEAD_DIM), _stream(x),
        )
    _raise_on(err, "fused_attention_block")
    LAUNCHES["fused_attention_block"] += 1
    return out


def fused_ffn_block(x, w1, b1, w2, b2, g, beta):
    """LN(x + W2.GELU_tanh(W1.x + b1) + b2). x: [B, S, H]; returns the same
    shape and dtype. Weights are [in, out]."""
    if not x.is_cuda:
        return fused_ffn_block_plain(x, w1, b1, w2, b2, g, beta)
    from dial_rag_tpu_torch.ops._build import build_kernels

    _check_kernel_x(x)
    b, s, hid = x.shape
    inter = w1.shape[1]
    if inter % 64:
        raise ValueError(f"the FFN kernel takes an intermediate width % 64 == 0, got {inter}")
    _check_cuda("w1", w1, torch.bfloat16, (hid, inter))
    _check_cuda("w2", w2, torch.bfloat16, (inter, hid))
    _check_cuda("b1", b1, torch.float32, (inter,))
    for name, t in (("b2", b2), ("ln scale", g), ("ln bias", beta)):
        _check_cuda(name, t, torch.float32, (hid,))
    lib = build_kernels().libs["fused_ffn"]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dial_ffn_block_bf16(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), g.data_ptr(), beta.data_ptr(), out.data_ptr(),
            b * s, inter, _stream(x),
        )
    _raise_on(err, "fused_ffn_block")
    LAUNCHES["fused_ffn_block"] += 1
    return out
