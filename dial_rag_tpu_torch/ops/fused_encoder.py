"""The fused blocks of a BERT encoder layer (counterpart of
``dial_rag_tpu/ops/fused_encoder.py``).

- ``fused_attention_block``: ``LN(x + W_out.MHA(T(W_qkv.x + b_qkv)) + b_out)``;
- ``fused_ffn_block``: ``LN(x + W2.T(gelu_tanh(W1.x + b1)) + b2)``,
  T the compute type (x's dtype);
- ``fused_layer_block``: the two in one layer, ``a`` (the post-attention
  state) cast to the compute type between them (kernels 1 then 2 in one
  call).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/fused_attention.cu``, ``csrc/fused_ffn.cu`` in f32 and
``csrc/ffn_tc.cu`` in bf16, ``csrc/fused_layer.cu``) or raises; it never
falls back. The three run on the tensor cores as launch sequences of
products, the single-tile attention and a LayerNorm pass: in bf16 the
products on ``wgmma`` (``csrc/encoder_tc.cuh``), in f32 in split TF32 on
``mma.sync`` (``csrc/encoder_tf32.cuh``). The kernels are
instantiated for ``KERNEL_INSTANTIATIONS``: f32 and bf16 at (H 384,
head_dim 32), (H 768, head_dim 64) and (H 1024, head_dim 64) (bge-small,
bge-base and bge-large widths); ``kernel_supports`` is the predicate
the wrappers check (the FFN's without a head width). On a CPU tensor
each wrapper runs the plain PyTorch version beside it, which follows
the TPU kernel's own order of casts (``_attn_block_kernel``,
``_ffn_kernel``, ``_layer_kernel``): products accumulate in f32 and are
not rounded before the bias, residual and LayerNorm; qkv, the probabilities, ctx, ``a`` and the GELU output are cast
to the compute type where the TPU kernel casts them.

Each wrapper goes through one ``torch.autograd.Function`` whose backward
recomputes the block through its plain version and differentiates that, as the
reference's ``custom_vjp`` backwards do (``_attn_block_bwd``, ``_ffn_bwd``,
``_layer_bwd``); the reference has no backward kernel for them. Matrices
are cast to the compute type and vectors to f32 before the function, so
f32 parameters train through a bf16 block.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels; ``count_launch`` takes a lock, as
serving threads launch too.
"""

import math
import threading

import torch

LAYERNORM_EPS = 1e-12
# (hidden, head_dim) the CUDA kernels are instantiated for, in each dtype:
# the bge-small, bge-base and bge-large widths (12 heads of 32, 12 of 64,
# 16 of 64); the FFN width is any multiple of 128
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL_WIDTHS = ((384, 32), (768, 64), (1024, 64))
KERNEL_INSTANTIATIONS = tuple(
    (dtype, hidden, head_dim) for dtype in KERNEL_DTYPES for hidden, head_dim in KERNEL_WIDTHS
)

LAUNCHES = {"fused_attention_block": 0, "fused_ffn_block": 0, "fused_layer_block": 0}


_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    zero_launches(LAUNCHES)


def zero_launches(launches: dict) -> None:
    """Sets every count of ``launches`` (this module's or
    ``flash_attention``'s ``LAUNCHES``) to 0 under the counters' lock."""
    with _LAUNCH_LOCK:
        for name in launches:
            launches[name] = 0


def count_launch(launches: dict, name: str) -> None:
    """Adds one launch of ``name`` to ``launches`` under the counters'
    lock."""
    with _LAUNCH_LOCK:
        launches[name] += 1


def kernel_supports(dtype, hidden=None, head_dim=None) -> bool:
    """Whether a CUDA kernel is instantiated for (dtype, hidden, head_dim);
    None matches any width (the FFN has no head_dim, the attention kernels
    take any number of heads)."""
    return any(
        dtype == d and hidden in (None, h) and head_dim in (None, dh) for d, h, dh in KERNEL_INSTANTIATIONS
    )


def check_kernel_supports(dtype, hidden=None, head_dim=None) -> None:
    """Raises ValueError, naming the instantiations, unless ``kernel_supports``."""
    if not kernel_supports(dtype, hidden, head_dim):
        names = ", ".join(f"({str(d)[6:]}, H {h}, head_dim {dh})" for d, h, dh in KERNEL_INSTANTIATIONS)
        raise ValueError(
            f"no CUDA kernel is instantiated for dtype {dtype}, H {hidden}, head_dim {head_dim}: "
            f"the kernels take (dtype, H, head_dim) in {{{names}}}"
        )


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


def _check_kernel_x(x, head_dim=None):
    """x [B, S, H] on the card, contiguous, of an instantiated (dtype, H, head_dim)."""
    if x.ndim != 3:
        raise ValueError(f"the CUDA kernels take x [B, S, H], got {tuple(x.shape)}")
    check_kernel_supports(x.dtype, x.shape[2], head_dim)
    _check_cuda("x", x, x.dtype)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _on_card(x) -> bool:
    """A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    return x.is_cuda


def _recompute_grads(plain, inputs, needs, dout):
    """Gradients of ``plain`` at ``inputs`` for those that ``needs`` marks,
    by autograd through the plain version (None for the rest)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, dout) if wanted else ())
    return [next(grads) if n else None for n in needs]


def _check_aligned(what, **tensors):
    """The tensor-core kernels read these by 16-byte copies."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what} reads {name} by 16-byte copies, got it at {t.data_ptr()}")


def _planes(x, k: int, n: int) -> list:
    """The f32 products' scratch for W's split TF32 planes (hi and lo of
    each weight of the largest [k, n] product); none in bf16."""
    if x.dtype == torch.bfloat16:
        return []
    return [torch.empty(2 * k * n, dtype=torch.float32, device=x.device)]


def _attention_block_kernel(x, attention_mask, wqkv, bqkv, wout, bout, g, beta, num_heads):
    """The tensor-core launches of ``csrc/fused_attention.cu``: the QKV
    product into qkv [B*S, 3H], the attention into ctx [B*S, H] (both in
    x's dtype), the output product into y [B*S, H] f32, the residual +
    LayerNorm; in f32 each product after a launch that splits its W into
    the planes. They read x (and in bf16 W_qkv and W_out) by 16-byte
    copies. Counted once."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    b, s, hid = x.shape
    mask, dh = _check_attention_inputs(x, attention_mask, num_heads, wqkv, bqkv, wout, bout, g, beta)
    if x.dtype == torch.bfloat16:
        _check_aligned("the bf16 attention block", x=x, wqkv=wqkv, wout=wout)
    else:
        _check_aligned("the f32 attention block", x=x)
    scratch = [torch.empty((b, s, 3 * hid), dtype=x.dtype, device=x.device), torch.empty_like(x),
               torch.empty((b, s, hid), dtype=torch.float32, device=x.device), *_planes(x, hid, 3 * hid)]
    out = torch.empty_like(x)
    lib = build_kernels().libs["fused_attention"]
    with torch.cuda.device(x.device):
        err = getattr(lib, f"dial_attention_block_{KERNEL_DTYPES[x.dtype]}")(
            *(t.data_ptr() for t in (x, mask, wqkv, bqkv, wout, bout, g, beta, *scratch, out)),
            b, s, num_heads, dh, 1.0 / math.sqrt(dh), _stream(x),
        )
    _raise_on(err, "fused_attention_block")
    count_launch(LAUNCHES, "fused_attention_block")
    return out


def _check_attention_inputs(x, attention_mask, num_heads, wqkv, bqkv, wout, bout, g, beta):
    """Checks what the attention kernels take; returns the int32 mask and
    the head width."""
    b, s, hid = x.shape
    if hid % num_heads:
        raise ValueError(f"H={hid} is not a multiple of num_heads={num_heads}")
    dh = hid // num_heads
    _check_kernel_x(x, dh)
    if not supports_fused_block(s):
        raise ValueError(f"the attention kernels take S <= 512, got {s}")
    mask = attention_mask.to(torch.int32).contiguous()
    _check_cuda("attention_mask", mask, torch.int32, (b, s))
    _check_cuda("wqkv", wqkv, x.dtype, (hid, 3 * hid))
    _check_cuda("wout", wout, x.dtype, (hid, hid))
    _check_cuda("bqkv", bqkv, torch.float32, (3 * hid,))
    for name, t in (("bout", bout), ("ln scale", g), ("ln bias", beta)):
        _check_cuda(name, t, torch.float32, (hid,))
    return mask, dh


def _check_ffn_weights(x, w1, b1, w2, b2, g, beta):
    hid, inter = x.shape[2], w1.shape[1]
    if inter % 128:
        raise ValueError(f"the FFN kernel takes an intermediate width % 128 == 0, got {inter}")
    _check_cuda("w1", w1, x.dtype, (hid, inter))
    _check_cuda("w2", w2, x.dtype, (inter, hid))
    _check_cuda("b1", b1, torch.float32, (inter,))
    for name, t in (("b2", b2), ("ln scale", g), ("ln bias", beta)):
        _check_cuda(name, t, torch.float32, (hid,))
    return inter


def _ffn_block_kernel(x, w1, b1, w2, b2, g, beta):
    """The tensor-core launches of ``csrc/ffn_tc.cu`` (bf16) or
    ``csrc/fused_ffn.cu`` (f32): the up product into h [B*S, I] in x's
    dtype, the down product into y [B*S, H] f32, the residual +
    LayerNorm; in f32 each product after a launch that splits its W into
    the planes. They read x (and in bf16 W1 and W2) by 16-byte copies.
    Counted once."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    _check_kernel_x(x)
    b, s, hid = x.shape
    inter = _check_ffn_weights(x, w1, b1, w2, b2, g, beta)
    if x.dtype == torch.bfloat16:
        _check_aligned("the bf16 FFN kernel", x=x, w1=w1, w2=w2)
        entry = build_kernels().libs["ffn_tc"].dial_ffn_block_bf16
    else:
        _check_aligned("the f32 FFN kernel", x=x)
        entry = build_kernels().libs["fused_ffn"].dial_ffn_block_f32
    out = torch.empty_like(x)
    scratch = [torch.empty((b * s, inter), dtype=x.dtype, device=x.device),
               torch.empty((b * s, hid), dtype=torch.float32, device=x.device), *_planes(x, hid, inter)]
    with torch.cuda.device(x.device):
        err = entry(*(t.data_ptr() for t in (x, w1, b1, w2, b2, g, beta, out, *scratch)),
                    b * s, hid, inter, _stream(x))
    _raise_on(err, "fused_ffn_block")
    count_launch(LAUNCHES, "fused_ffn_block")
    return out


def _layer_block_kernel(x, attention_mask, weights, num_heads):
    """The launches of ``csrc/fused_layer.cu``: kernel 1's into a [B*S, H]
    scratch a in x's dtype, then kernel 2's on it (scratch qkv, ctx, y, h
    and, in f32, the planes as in those wrappers). Counted once."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    b, s, hid = x.shape
    mask, dh = _check_attention_inputs(x, attention_mask, num_heads, *weights[:6])
    inter = _check_ffn_weights(x, *weights[6:])
    if x.dtype == torch.bfloat16:
        wqkv, _, wout, _, _, _, w1, _, w2, _, _, _ = weights
        _check_aligned("the bf16 layer", x=x, wqkv=wqkv, wout=wout, w1=w1, w2=w2)
    else:
        _check_aligned("the f32 layer", x=x)
    scratch = [torch.empty((b, s, 3 * hid), dtype=x.dtype, device=x.device), torch.empty_like(x),
               torch.empty((b, s, hid), dtype=torch.float32, device=x.device), torch.empty_like(x),
               torch.empty((b, s, inter), dtype=x.dtype, device=x.device), *_planes(x, hid, max(3 * hid, inter))]
    out = torch.empty_like(x)
    lib = build_kernels().libs["fused_layer"]
    with torch.cuda.device(x.device):
        err = getattr(lib, f"dial_layer_block_{KERNEL_DTYPES[x.dtype]}")(
            *(t.data_ptr() for t in (x, mask, *weights, *scratch, out)),
            b, s, num_heads, dh, inter, 1.0 / math.sqrt(dh), _stream(x),
        )
    _raise_on(err, "fused_layer_block")
    count_launch(LAUNCHES, "fused_layer_block")
    return out


class _FusedBlock(torch.autograd.Function):
    """``kernel(x, *weights)`` on the card, ``plain(x, *weights)`` on the
    CPU; the backward differentiates ``plain`` at the saved inputs."""

    @staticmethod
    def forward(ctx, plain, kernel, x, *weights):
        ctx.plain = plain
        ctx.save_for_backward(x, *weights)
        return (kernel if _on_card(x) else plain)(x, *weights)

    @staticmethod
    def backward(ctx, dout):
        grads = _recompute_grads(ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:], dout)
        return None, None, *grads


def _cast(dtype, matrices, vectors):
    """Matrices in the compute type, vectors in f32, as the kernels take
    them (no-ops where they already are); autograd carries the casts."""
    return [w.to(dtype) for w in matrices], [v.float() for v in vectors]


def fused_attention_block(
    x, attention_mask, wqkv, bqkv, wout, bout, g, beta, num_heads
):
    """LN(x + W_out.Attention(W_qkv.x + b) + b_out). x: [B, S, H],
    mask: [B, S] (1 = real token); returns [B, S, H] in x's dtype. Weights
    are [in, out]. Differentiable w.r.t. x and every weight."""
    (wqkv, wout), (bqkv, bout, g, beta) = _cast(x.dtype, (wqkv, wout), (bqkv, bout, g, beta))
    return _FusedBlock.apply(
        lambda x, *w: fused_attention_block_plain(x, attention_mask, *w, num_heads),
        lambda x, *w: _attention_block_kernel(x, attention_mask, *w, num_heads),
        x, wqkv, bqkv, wout, bout, g, beta,
    )


def fused_ffn_block(x, w1, b1, w2, b2, g, beta):
    """LN(x + W2.GELU_tanh(W1.x + b1) + b2). x: [B, S, H]; returns the same
    shape and dtype. Weights are [in, out]. Differentiable w.r.t. x and
    every weight."""
    (w1, w2), (b1, b2, g, beta) = _cast(x.dtype, (w1, w2), (b1, b2, g, beta))
    return _FusedBlock.apply(fused_ffn_block_plain, _ffn_block_kernel, x, w1, b1, w2, b2, g, beta)


def fused_layer_block_plain(x, attention_mask, weights, num_heads):
    """Plain version of the whole-layer kernel (``_layer_kernel``): the
    attention block, whose output ``a`` is cast to x's dtype, then the FFN
    block. ``weights`` is the reference's 12-tuple (wqkv, bqkv, wout, bout,
    attn_ln_scale, attn_ln_bias, w1, b1, w2, b2, ffn_ln_scale, ffn_ln_bias)."""
    wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2 = weights
    a = fused_attention_block_plain(x, attention_mask, wqkv, bqkv, wout, bout, g1, beta1, num_heads)
    return fused_ffn_block_plain(a, w1, b1, w2, b2, g2, beta2)


def fused_layer_block(x, attention_mask, weights, num_heads):
    """One encoder layer, LN(a + FFN(a)) with a = LN(x + Attention(x)) in
    the compute type. ``weights`` as for ``fused_layer_block_plain``.
    Differentiable w.r.t. x and every weight."""
    wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2 = weights
    (wqkv, wout, w1, w2), (bqkv, bout, g1, beta1, b1, b2, g2, beta2) = _cast(
        x.dtype, (wqkv, wout, w1, w2), (bqkv, bout, g1, beta1, b1, b2, g2, beta2)
    )
    return _FusedBlock.apply(
        lambda x, *w: fused_layer_block_plain(x, attention_mask, w, num_heads),
        lambda x, *w: _layer_block_kernel(x, attention_mask, w, num_heads),
        x, wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2,
    )
