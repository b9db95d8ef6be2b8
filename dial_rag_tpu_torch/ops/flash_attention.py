"""Single-tile fused attention with a recompute-P backward (counterpart of
the S <= 512 part of ``dial_rag_tpu/ops/flash_attention.py``).

- ``fused_qkv_attention(qkv, mask, num_heads)``: attention read straight
  from the packed QKV projection ``[B, S, 3H]`` (head j of q at columns
  ``j*Dh``, of k at ``H + j*Dh``, of v at ``2H + j*Dh``), written as
  ``[B, S, H]`` (TPU kernel ``_qkv_native_kernel``);
- ``flash_attention(q, k, v, mask)``: the same attention on head-major
  ``[B, h, S, Dh]`` tensors (TPU kernel ``_attention_kernel``).

Both are ``torch.autograd.Function``s whose backward is the recompute-P
backward of ``_attention_bwd_kernel``. On a CUDA tensor they launch the
hand-written Hopper kernels (``csrc/flash_attention_fwd.cu``, one strided
kernel for both layouts; ``csrc/flash_attention_bwd.cu``) or raise; they
never fall back. On a CPU tensor, or with ``plain=True``, they run the
plain PyTorch versions beside them, which follow the TPU kernels' order:
``scores * scale + bias``, row max, exp, sum, divide, then ``P . V``; the
mask bias is ``(1 - mask) * f32.min``, never -inf, so a fully masked row
gets uniform weights and stays finite.

``LAUNCHES`` counts calls that reached a kernel, per TPU kernel: a
backward call counts once however many launches it makes.
"""

import ctypes
import math

import torch

from dial_rag_tpu_torch.ops.fused_encoder import KERNEL_HEAD_DIM, _raise_on, mask_bias

# the single-tile bound of the reference; longer sequences take its
# query-blocked and KV-blocked kernels, which the port has not yet
_FULL_TILE_MAX_S = 512

LAUNCHES = {"qkv_native_attention": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_qkv(s: int) -> bool:
    """The single-tile design point: one [S, S] score tile per head."""
    return s <= _FULL_TILE_MAX_S


def _check_single_tile(s: int) -> None:
    if not supports_fused_qkv(s):
        raise NotImplementedError(
            f"S={s} > {_FULL_TILE_MAX_S} needs the reference's blocked kernels "
            "(dial_rag_tpu/ops/flash_attention.py: _attention_q_blocked_kernel, "
            "_attention_kv_blocked_fwd_kernel, _attention_bwd_q_blocked_kernel, "
            "_bwd_dq_kv_blocked_kernel, _bwd_dkv_kv_blocked_kernel), which are "
            "not ported yet"
        )


def _probs_plain(q, k, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * scale + bias[:, None, None, :]
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / e.sum(dim=-1, keepdim=True)


def attention_forward_plain(q, k, v, attention_mask):
    """q, k, v: [B, h, S, Dh]; mask [B, S] -> [B, h, S, Dh] in q's dtype."""
    p = _probs_plain(q, k, mask_bias(attention_mask))
    return (p.to(q.dtype).float() @ v.float()).to(q.dtype)


def attention_backward_plain(q, k, v, do, attention_mask):
    """Recompute-P backward, written out as ``_attention_bwd_kernel`` does:
    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)),
    dQ = (scale dS) K, dK = (scale dS)^T Q."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs_plain(q, k, mask_bias(attention_mask))
    dof = do.float()
    dv = p.to(q.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_c = (ds * scale).to(q.dtype).float()
    dq = ds_c @ k.float()
    dk = ds_c.transpose(-1, -2) @ q.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _split_heads(qkv, num_heads):
    """[B, S, 3H] -> three [B, h, S, Dh] views (no copy)."""
    b, s, three_h = qkv.shape
    dh = three_h // 3 // num_heads
    qkv5 = qkv.view(b, s, 3, num_heads, dh)
    return tuple(qkv5[:, :, i].transpose(1, 2) for i in range(3))


def qkv_attention_plain(qkv, attention_mask, num_heads):
    """Plain version of the layout-native forward: [B, S, 3H] -> [B, S, H]."""
    b, s, three_h = qkv.shape
    o = attention_forward_plain(*_split_heads(qkv, num_heads), attention_mask)
    return o.transpose(1, 2).reshape(b, s, three_h // 3)


def qkv_attention_backward_plain(qkv, do, attention_mask, num_heads):
    """Plain version of the fused-qkv backward: dO [B, S, H] -> dqkv [B, S, 3H]."""
    b, s, three_h = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    do_heads = do.view(b, s, num_heads, -1).transpose(1, 2)
    grads = attention_backward_plain(q, k, v, do_heads, attention_mask)
    return torch.stack([g.transpose(1, 2).reshape(b, s, -1) for g in grads], dim=2).reshape(
        b, s, three_h
    )


# ---- kernel wrappers -------------------------------------------------------


def _check_kernel_input(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name} must be on the card, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(
            f"the attention kernels take float32 (a bf16 instantiation is not "
            f"written yet), got {name} {t.dtype}"
        )
    if t.shape[-1] != KERNEL_HEAD_DIM or t.stride(-1) != 1:
        raise ValueError(
            f"the attention kernels take head_dim {KERNEL_HEAD_DIM} with unit "
            f"stride, got {name} of shape {tuple(t.shape)}, strides {t.stride()}"
        )


def _strides(*tensors) -> ctypes.Array:
    """(batch, head, row) element strides of each [B, h, S, Dh] view."""
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _kernel_bias(attention_mask, b, s, device):
    if tuple(attention_mask.shape) != (b, s):
        raise ValueError(f"attention_mask must be [{b}, {s}], got {tuple(attention_mask.shape)}")
    return mask_bias(attention_mask.to(device)).contiguous()


def _forward_kernel(q, k, v, o, attention_mask):
    """Launches the strided forward on [B, h, S, Dh] views q, k, v -> o."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        _check_kernel_input(name, t)
    b, h, s, dh = q.shape
    _check_single_tile(s)
    bias = _kernel_bias(attention_mask, b, s, q.device)
    strides = _strides(q, k, v, o)
    lib = build_kernels().libs["flash_attention_fwd"]
    with torch.cuda.device(q.device):
        err = lib.dial_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), o.data_ptr(),
            ctypes.addressof(strides), b, h, s, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "attention forward")


def _backward_kernel(q, k, v, do, dq, dk, dv, attention_mask):
    """Launches the two-pass recompute-P backward on [B, h, S, Dh] views."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("dq", dq), ("dk", dk), ("dv", dv)):
        _check_kernel_input(name, t)
    b, h, s, dh = q.shape
    _check_single_tile(s)
    bias = _kernel_bias(attention_mask, b, s, q.device)
    # per (b, head, query row): softmax max, denominator and rowsum(dP * P)
    rows = torch.empty((b, h, s, 3), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, do, dq, dk, dv)
    lib = build_kernels().libs["flash_attention_bwd"]
    with torch.cuda.device(q.device):
        err = lib.dial_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rows.data_ptr(),
            ctypes.addressof(strides), b, h, s, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "attention backward")
    LAUNCHES["flash_attention_bwd"] += 1


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.is_cuda and not plain


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, attention_mask, num_heads, plain):
        b, s, three_h = qkv.shape
        _check_single_tile(s)
        ctx.num_heads, ctx.plain = num_heads, plain
        ctx.save_for_backward(qkv, attention_mask)
        if not _use_kernel(qkv, plain):
            return qkv_attention_plain(qkv, attention_mask, num_heads)
        if not qkv.is_contiguous():
            raise ValueError("fused_qkv_attention takes a contiguous [B, S, 3H] qkv")
        out = torch.empty((b, s, three_h // 3), dtype=qkv.dtype, device=qkv.device)
        q, k, v = _split_heads(qkv, num_heads)
        _forward_kernel(q, k, v, out.view(b, s, num_heads, -1).transpose(1, 2), attention_mask)
        LAUNCHES["qkv_native_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, attention_mask = ctx.saved_tensors
        num_heads = ctx.num_heads
        do = do.contiguous()
        if not _use_kernel(qkv, ctx.plain):
            return qkv_attention_backward_plain(qkv, do, attention_mask, num_heads), None, None, None
        b, s, three_h = qkv.shape
        # the kernel writes dq, dk and dv straight into the packed gradient
        dqkv = torch.empty_like(qkv)
        _backward_kernel(
            *_split_heads(qkv, num_heads),
            do.view(b, s, num_heads, -1).transpose(1, 2),
            *_split_heads(dqkv, num_heads),
            attention_mask,
        )
        return dqkv, None, None, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, attention_mask, plain):
        _check_single_tile(q.shape[2])
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, attention_mask)
        if not _use_kernel(q, plain):
            return attention_forward_plain(q, k, v, attention_mask)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _forward_kernel(q, k, v, out, attention_mask)
        LAUNCHES["flash_attention_fwd"] += 1
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, attention_mask = ctx.saved_tensors
        do = do.contiguous()
        if not _use_kernel(q, ctx.plain):
            return (*attention_backward_plain(q, k, v, do, attention_mask), None, None)
        grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v)]
        _backward_kernel(q, k, v, do, *grads, attention_mask)
        return (*grads, None, None)


def fused_qkv_attention(qkv, attention_mask, num_heads: int, plain: bool = False):
    """Layout-native attention: qkv [B, S, 3H] (heads packed column-wise),
    mask [B, S] (1 = real token) -> context [B, S, H] in qkv's dtype.
    Differentiable w.r.t. qkv. ``plain=True`` runs the plain versions on
    any device (the yardstick the kernels are held against)."""
    return _FusedQKVAttention.apply(qkv, attention_mask, num_heads, plain)


def flash_attention(q, k, v, attention_mask, plain: bool = False):
    """Head-major attention: q, k, v [B, h, S, Dh], mask [B, S] ->
    [B, h, S, Dh] in q's dtype. Differentiable w.r.t. q, k and v."""
    return _FlashAttention.apply(q, k, v, attention_mask, plain)
