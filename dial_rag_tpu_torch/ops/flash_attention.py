"""Fused attention with a recompute-P backward (counterpart of
``dial_rag_tpu/ops/flash_attention.py``).

- ``fused_qkv_attention(qkv, mask, num_heads)``: attention read straight
  from the packed QKV projection ``[B, S, 3H]`` (head j of q at columns
  ``j*Dh``, of k at ``H + j*Dh``, of v at ``2H + j*Dh``), written as
  ``[B, S, H]`` (TPU kernel ``_qkv_native_kernel``);
- ``flash_attention(q, k, v, mask)``: the same attention on head-major
  ``[B, h, S, Dh]`` tensors, dispatched by S as the reference's
  ``_forward`` dispatches it: the single-tile ``_attention_kernel`` for
  ``S <= 512`` or ``S % 256 != 0``; else the query-blocked
  ``_attention_q_blocked_kernel`` for ``S <= 4096`` or ``S % 512 != 0``;
  else the KV-blocked online-softmax ``_attention_kv_blocked_fwd_kernel``,
  which also gives the log-sum-exp for a blocked backward.

Both are ``torch.autograd.Function``s with a recompute-P backward,
dispatched as the reference's ``_bwd_rule`` dispatches it: after the
KV-blocked forward (which left a log-sum-exp) the two passes
``_bwd_dq_kv_blocked_kernel`` and ``_bwd_dkv_kv_blocked_kernel``; at any
other blocked S ``_attention_bwd_q_blocked_kernel``; else the single-tile
``_attention_bwd_kernel``. On a CUDA tensor they launch the hand-written
Hopper kernels or raise; they never fall back:

- forward in bf16: the tensor-core kernels of ``csrc/attention_tc.cu``,
  one for the single-tile and query-blocked forwards in both layouts, at
  any S, one for the KV-blocked forward;
- forward in f32: the single-tile kernel (``csrc/flash_attention_fwd.cu``:
  split-TF32 products on the tensor cores, Q K^T formed once) up to the S
  its shared memory takes (``single_tile_max_s``), the query-blocked
  kernel's code (``csrc/flash_attention_long.cu``, also split TF32) past
  it and on the query-blocked route: both compute the same function, as
  the reference's kernels do;
- the KV-blocked forward in f32 (``csrc/flash_attention_long.cu``,
  split-TF32 products, one sweep);
- backward: the single-tile kernel (``csrc/flash_attention_bwd.cu``: one
  launch per (head, batch row), in f32 of split-TF32 products, in bf16 of
  bf16 tensor-core products) up to its dtype's limit, the query-blocked backward's
  code past it and on the query-blocked route, the KV-blocked passes after
  the KV-blocked forward (``csrc/flash_attention_long_bwd.cu``; both
  blocked backwards in f32 on split-TF32 products on the tensor cores, in
  bf16 on the bf16 tensor cores, ``csrc/attention_bwd_tc.cuh``).

Every kernel takes head_dim 32 and 64 (``fused_encoder.kernel_supports``).
On a CPU tensor, or with ``plain=True``, they run the plain PyTorch
versions beside them, which follow the TPU kernels' order: ``scores *
scale + bias``, row max, exp, sum, divide, then ``P . V``; the mask bias
is ``(1 - mask) * f32.min``, never -inf, so a fully masked row stays
finite (uniform weights, except in the KV-blocked backward, where ``exp(s
- lse)`` gives it weight 1 per key, as in the reference). No plain version
builds a [B, h, S, S] tensor at a blocked S.

``LAUNCHES`` counts launches per CUDA kernel wrapper, so the counters say
which code ran: the single-tile forward by layout
(``qkv_native_attention``, ``flash_attention_fwd``), the tensor-core
forward (``attention_tc``, any layout), and one key per other kernel; a
backward call counts once however many launches it makes.
"""

import ctypes
import functools
import math

import torch

from dial_rag_tpu_torch.ops.fused_encoder import KERNEL_DTYPES, _raise_on, check_kernel_supports, mask_bias

# the reference's dispatch thresholds, under its names (a test patches
# both packages alike): sequences up to _FULL_TILE_MAX_S, or not a
# multiple of _Q_BLOCK, take one [S, S] score tile per head; up to
# _Q_BLOCKED_MAX_S (or not a multiple of _KV_BLOCK) the query-blocked
# kernel; beyond, the online softmax over _KV_BLOCK keys at a time
_FULL_TILE_MAX_S = 512
_Q_BLOCK = 256
_Q_BLOCKED_MAX_S = 4096
_KV_BLOCK = 512

LAUNCHES = {
    "qkv_native_attention": 0,
    "flash_attention_fwd": 0,
    "attention_tc": 0,
    "flash_attention_bwd": 0,
    "attention_q_blocked": 0,
    "attention_kv_blocked_fwd": 0,
    "attention_bwd_q_blocked": 0,
    "bwd_dq_kv_blocked": 0,
    "bwd_dkv_kv_blocked": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_qkv(s: int) -> bool:
    """Where the reference's "pallas" route takes the layout-native kernel
    (one [S, S] score tile per head); ``fused_qkv_attention`` itself has
    no S bound."""
    return s <= _FULL_TILE_MAX_S


def attention_route(s: int) -> str:
    """The reference's ``_forward``/``_backward`` choice of kernel by S."""
    if s <= _FULL_TILE_MAX_S or s % _Q_BLOCK != 0:
        return "single_tile"
    if s <= _Q_BLOCKED_MAX_S or s % _KV_BLOCK != 0:
        return "q_blocked"
    return "kv_blocked"


def _probs_plain(q, k, bias):
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = q.to(acc) @ k.to(acc).transpose(-1, -2)
    scores = scores * scale + bias[:, None, None, :]
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / e.sum(dim=-1, keepdim=True)


def attention_forward_plain(q, k, v, attention_mask):
    """q, k, v: [B, h, S, Dh]; mask [B, S] -> [B, h, S, Dh] in q's dtype."""
    p = _probs_plain(q, k, mask_bias(attention_mask))
    return (p.to(q.dtype).float() @ v.float()).to(q.dtype)


def attention_q_blocked_plain(q, k, v, attention_mask):
    """Plain version of ``_attention_q_blocked_kernel``: per block of
    ``_Q_BLOCK`` queries, the exact per-row softmax over every key, P cast
    to the input dtype after the division, then P . V in f32. f64 inputs
    run it all in f64 (a yardstick for the f32 rounding)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    bias = mask_bias(attention_mask)
    vf = v.to(acc)
    outs = [
        _probs_plain(q[:, :, q0 : q0 + _Q_BLOCK], k, bias).to(q.dtype).to(acc) @ vf
        for q0 in range(0, q.shape[2], _Q_BLOCK)
    ]
    return torch.cat(outs, dim=2).to(q.dtype)


def attention_kv_blocked_plain(q, k, v, attention_mask):
    """Plain version of ``_attention_kv_blocked_fwd_kernel``: the online
    softmax over blocks of ``_KV_BLOCK`` keys. The running max starts at
    f32.min; per block ``corr = exp(m_prev - m_next)``, ``e = exp(s -
    m_next)`` is cast to the input dtype before P . V, and ``o = acc / l``
    at the end. Returns (o, lse) with ``lse = m + log(l)`` [B, h, S] f32."""
    b, h, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    bias = mask_bias(attention_mask)[:, None, None, :]
    qf = q.float()
    m = torch.full((b, h, s, 1), torch.finfo(torch.float32).min, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, dh), device=q.device)
    for k0 in range(0, s, _KV_BLOCK):
        blk = slice(k0, k0 + _KV_BLOCK)
        scores = (qf @ k[:, :, blk].float().transpose(-1, -2)) * scale + bias[..., blk]
        m_next = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_next)
        e = torch.exp(scores - m_next)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        acc = acc * corr + e.to(q.dtype).float() @ v[:, :, blk].float()
        m = m_next
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


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


def attention_bwd_q_blocked_plain(q, k, v, do, attention_mask):
    """Plain version of ``_attention_bwd_q_blocked_kernel``: per block of
    ``_Q_BLOCK`` queries, P exact over every key (as the forward builds
    it), dV += cast(P)^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) from
    the f32 P, dQ = cast(scale dS) K per block, dK += cast(scale dS)^T Q;
    dK and dV summed in f32 over the blocks and cast at the end. f64
    inputs run it all in f64 (a yardstick for the f32 rounding)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bias = mask_bias(attention_mask)
    kf, vf = k.to(acc), v.to(acc)
    dk = torch.zeros(k.shape, dtype=acc, device=k.device)
    dv = torch.zeros(v.shape, dtype=acc, device=v.device)
    dqs = []
    for q0 in range(0, q.shape[2], _Q_BLOCK):
        blk = slice(q0, q0 + _Q_BLOCK)
        p = _probs_plain(q[:, :, blk], k, bias)
        dob = do[:, :, blk].to(acc)
        dv += p.to(q.dtype).to(acc).transpose(-1, -2) @ dob
        dp = dob @ vf.transpose(-1, -2)
        ds_c = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(q.dtype).to(acc)
        dqs.append((ds_c @ kf).to(q.dtype))
        dk += ds_c.transpose(-1, -2) @ q[:, :, blk].to(acc)
    return torch.cat(dqs, dim=2), dk.to(k.dtype), dv.to(v.dtype)


def _sum_over_query_blocks(a, b):
    """a^T b for a [B, h, S, K], b [B, h, S, D], as the reference's dK/dV
    pass forms it: one product per block of ``_Q_BLOCK`` queries, the
    blocks summed in f32. A ragged last block (an S the reference never
    gives it, which the card tests hand the kernels) is padded with zero
    rows, which add nothing."""
    pad = -a.shape[2] % _Q_BLOCK
    if pad:
        a, b = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (a, b))
    bb, h, s, kk = a.shape
    g = s // _Q_BLOCK
    a = a.reshape(bb, h, g, _Q_BLOCK, kk).transpose(-1, -2)
    return (a @ b.reshape(bb, h, g, _Q_BLOCK, -1)).sum(dim=2)


def attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, attention_mask):
    """Plain version of ``_bwd_dq_kv_blocked_kernel`` and
    ``_bwd_dkv_kv_blocked_kernel``: delta = rowsum(dO O) in f32 from the
    forward's o; per block of ``_KV_BLOCK`` keys, P = exp(s - lse),
    dP = dO V^T, dS = cast(P (dP - delta) scale), dQ += dS K (f32 over the
    key blocks), dV = cast(P)^T dO and dK = dS^T Q (f32 over the query
    blocks). f64 inputs run it all in f64 (the same expressions, a
    yardstick for the f32 rounding)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bias = mask_bias(attention_mask)[:, None, None, :]
    qf, dof = q.to(acc), do.to(acc)
    delta = (dof * o.to(acc)).sum(dim=-1, keepdim=True)
    lse = lse[..., None]
    dq = torch.zeros(q.shape, dtype=acc, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, q.shape[2], _KV_BLOCK):
        blk = slice(k0, k0 + _KV_BLOCK)
        kb, vb = k[:, :, blk].to(acc), v[:, :, blk].to(acc)
        p = torch.exp((qf @ kb.transpose(-1, -2)) * scale + bias[..., blk] - lse)
        dp = dof @ vb.transpose(-1, -2)
        ds_c = (p * (dp - delta) * scale).to(q.dtype).to(acc)
        dq += ds_c @ kb
        dvs.append(_sum_over_query_blocks(p.to(q.dtype).to(acc), dof).to(v.dtype))
        dks.append(_sum_over_query_blocks(ds_c, qf).to(k.dtype))
    return dq.to(q.dtype), torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


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


def _check_attention_inputs(**tensors):
    """The attention kernels take [B, h, S, Dh] views on the card with a
    unit head-dim stride, of one dtype and head width that
    ``kernel_supports`` (f32 or bf16; 32 or 64)."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be on the card, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"the attention kernels take a unit head-dim stride, got {name} strides {t.stride()}")
        check_kernel_supports(t.dtype, head_dim=t.shape[-1])
    kinds = {name: (t.dtype, t.shape[-1]) for name, t in tensors.items()}
    if len(set(kinds.values())) != 1:
        raise ValueError(f"the attention kernels take one dtype and head width, got {kinds}")


def _strides(*tensors) -> ctypes.Array:
    """(batch, head, row) element strides of each [B, h, S, Dh] view."""
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _kernel_bias(attention_mask, b, s, device):
    if tuple(attention_mask.shape) != (b, s):
        raise ValueError(f"attention_mask must be [{b}, {s}], got {tuple(attention_mask.shape)}")
    return mask_bias(attention_mask.to(device)).contiguous()


def single_tile_max_s(direction: str, head_dim: int, device=None, dtype=torch.float32) -> int:
    """The longest S the single-tile CUDA kernel (``"fwd"``: the f32
    forward; ``"bwd"``: the backward in ``dtype``) takes on ``device`` at
    ``head_dim``: its score tiles and operand tiles must fit in the shared
    memory one block may opt in to. The kernel's library works it out from
    its own layout (on an H100's 227 KB: forward 768 at head_dim 32, 704
    at 64; the backward 128 in both dtypes, a whole [S, S] tile a block,
    in bf16 also the registers' limit). Past it the wrappers take the query-blocked
    kernels' code, which has no S limit. The bf16 forward (the tensor-core
    kernel) has no limit, so ``"fwd"`` raises on any other dtype than f32."""
    if direction == "fwd" and dtype != torch.float32:
        raise ValueError(f"only the f32 single-tile forward has an S limit, not the {dtype} one")
    check_kernel_supports(dtype, head_dim=head_dim)
    index = torch.device(device if device is not None else "cuda").index
    name = "dial_attention_fwd_max_seq" if direction == "fwd" else f"dial_attention_bwd_max_seq_{KERNEL_DTYPES[dtype]}"
    return _max_seq(f"flash_attention_{direction}", name, torch.cuda.current_device() if index is None else index,
                    head_dim)


@functools.cache
def _max_seq(stem: str, name: str, index: int, head_dim: int) -> int:
    from dial_rag_tpu_torch.ops._build import build_kernels

    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(build_kernels().libs[stem], name)(head_dim, ctypes.addressof(out))
    _raise_on(err, f"{name} (shared-memory query)")
    return out.value


def _launch(stem, entry, what, q, pointers, views):
    """Calls ``entry`` of ``csrc/<stem>.cu`` with the tensors' pointers, the
    (batch, head, row) strides of ``views``, B, h, S, head_dim, the scale
    1/sqrt(head_dim) and q's current stream; raises on a CUDA error."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    b, h, s, dh = q.shape
    strides = _strides(*views)
    lib = build_kernels().libs[stem]
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in pointers), ctypes.addressof(strides), b, h, s, dh,
            1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, what)


def _forward_kernel(q, k, v, o, attention_mask, counter="flash_attention_fwd"):
    """Launches the single-tile f32 forward (split-TF32 products on the
    tensor cores) on [B, h, S, Dh] views q, k, v -> o; S within
    ``single_tile_max_s("fwd", Dh)``; q, k and v 16-byte aligned rows
    (cp.async copies). Counts the launch under ``counter``, the LAUNCHES
    key of the caller's layout (TPU kernel 4: packed qkv; 5: head-major)."""
    _check_attention_inputs(q=q, k=k, v=v, o=o)
    if q.dtype != torch.float32:
        raise ValueError(f"the single-tile f32 forward takes f32 (bf16 takes the tensor-core kernel), got {q.dtype}")
    _check_16_byte_rows("single-tile f32 forward", q=q, k=k, v=v)
    b, h, s, dh = q.shape
    if s > single_tile_max_s("fwd", dh, q.device):
        raise ValueError(f"S={s} is past the single-tile forward's shared-memory limit at head_dim {dh}")
    bias = _kernel_bias(attention_mask, b, s, q.device)
    _launch("flash_attention_fwd", "dial_attention_fwd_f32", "attention forward", q, (q, k, v, bias, o),
            (q, k, v, o))
    LAUNCHES[counter] += 1


def _check_16_byte_rows(what, **tensors):
    """Kernels that copy their operands' rows 16 bytes at a time (cp.async)
    take views 16-byte aligned, with (batch, head, row) strides in whole
    16 bytes."""
    for name, t in tensors.items():
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % per for st in t.stride()[:3]):
            raise ValueError(f"the {what} takes 16-byte aligned rows, got {name} at {t.data_ptr()} with strides "
                             f"{t.stride()}")


def _check_tc_inputs(q, k, v, o):
    """The bf16 tensor-core forwards' inputs: their 16-byte copies need q,
    k and v 16-byte aligned with strides in multiples of 8; o is written in
    pairs of values."""
    _check_attention_inputs(q=q, k=k, v=v, o=o)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core attention forward takes bf16, got {q.dtype}")
    _check_16_byte_rows("tensor-core attention forward", q=q, k=k, v=v)
    if o.data_ptr() % 4 or any(st % 2 for st in o.stride()[:3]):
        raise ValueError(f"the tensor-core attention forward writes pairs of values, got o strides {o.stride()}")


def _tc_kernel(q, k, v, o, attention_mask):
    """Launches the bf16 tensor-core forward (TPU kernels 4, 5 and 6 in
    bf16, any S) on [B, h, S, Dh] views q, k, v -> o."""
    _check_tc_inputs(q, k, v, o)
    b, h, s, _ = q.shape
    bias = _kernel_bias(attention_mask, b, s, q.device)
    _launch("attention_tc", "dial_attention_tc_bf16", "attention tensor-core forward", q, (q, k, v, bias, o),
            (q, k, v, o))
    LAUNCHES["attention_tc"] += 1


def _q_blocked_kernel(q, k, v, o, attention_mask):
    """Launches the query-blocked f32 forward (TPU kernel 6; split-TF32
    products on the tensor cores, any S) on [B, h, S, Dh] views q, k, v ->
    o; q, k and v 16-byte aligned rows (cp.async copies)."""
    _check_attention_inputs(q=q, k=k, v=v, o=o)
    if q.dtype != torch.float32:
        raise ValueError(f"the query-blocked f32 forward takes f32 (bf16 takes the bf16 tensor-core kernel), "
                         f"got {q.dtype}")
    _check_16_byte_rows("query-blocked f32 forward", q=q, k=k, v=v)
    b, h, s, _ = q.shape
    bias = _kernel_bias(attention_mask, b, s, q.device)
    _launch("flash_attention_long", "dial_attention_q_blocked_f32", "attention q_blocked forward", q,
            (q, k, v, bias, o), (q, k, v, o))
    LAUNCHES["attention_q_blocked"] += 1


def _kv_blocked_kernel(q, k, v, o, attention_mask):
    """Launches the KV-blocked forward (TPU kernel 7; f32 on split-TF32
    products, bf16 on the bf16 tensor cores; q, k and v 16-byte aligned
    rows, cp.async copies) on [B, h, S, Dh] views q, k, v -> o; returns its
    lse, f32 [B, h, S]."""
    if q.dtype == torch.bfloat16:
        _check_tc_inputs(q, k, v, o)
        stem = "attention_tc"
    else:
        _check_attention_inputs(q=q, k=k, v=v, o=o)
        _check_16_byte_rows("KV-blocked f32 forward", q=q, k=k, v=v)
        stem = "flash_attention_long"
    b, h, s, _ = q.shape
    bias = _kernel_bias(attention_mask, b, s, q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch(stem, f"dial_attention_kv_blocked_{KERNEL_DTYPES[q.dtype]}", "attention kv_blocked forward", q,
            (q, k, v, bias, o, lse), (q, k, v, o))
    LAUNCHES["attention_kv_blocked_fwd"] += 1
    return lse


def _forward_into(q, k, v, o, attention_mask, single_tile, counter="flash_attention_fwd"):
    """The forward on the card of the single-tile (``single_tile``) or
    query-blocked route into o: bf16 on the tensor-core kernel; f32 on the
    single-tile kernel (its launch counted under ``counter``) up to its
    shared-memory limit, else on the query-blocked kernel's code."""
    if q.dtype == torch.bfloat16:
        _tc_kernel(q, k, v, o, attention_mask)
    elif single_tile and q.shape[2] <= single_tile_max_s("fwd", q.shape[-1], q.device):
        _forward_kernel(q, k, v, o, attention_mask, counter)
    else:
        _q_blocked_kernel(q, k, v, o, attention_mask)


def _check_rows(name, t, shape):
    """A per-row statistic (lse, delta): a contiguous f32 [B, h, S] tensor."""
    if not (t.is_cuda and t.dtype == torch.float32 and tuple(t.shape) == shape and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous f32 {list(shape)} tensor on the card, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _backward_kernel(q, k, v, do, dq, dk, dv, attention_mask):
    """Launches the single-tile recompute-P backward (TPU kernel 8) on [B,
    h, S, Dh] views; S within ``single_tile_max_s("bwd", Dh, dtype=...)``:
    one launch per (head, batch row), in f32 of split-TF32 products, in
    bf16 of bf16 products, on the tensor cores (q, k, v and do 16-byte
    aligned rows, cp.async copies; in bf16 dq, dk and dv too, written 16
    bytes at a time)."""
    _check_attention_inputs(q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv)
    b, h, s, dh = q.shape
    if s > single_tile_max_s("bwd", dh, q.device, q.dtype):
        raise ValueError(f"S={s} is past the single-tile backward's shared-memory limit at head_dim {dh} in "
                         f"{q.dtype}")
    outs = {"dq": dq, "dk": dk, "dv": dv} if q.dtype == torch.bfloat16 else {}
    _check_16_byte_rows(f"single-tile {KERNEL_DTYPES[q.dtype]} backward", q=q, k=k, v=v, do=do, **outs)
    bias = _kernel_bias(attention_mask, b, s, q.device)
    _launch("flash_attention_bwd", f"dial_attention_bwd_{KERNEL_DTYPES[q.dtype]}", "attention backward", q,
            (q, k, v, do, bias, dq, dk, dv), (q, k, v, do, dq, dk, dv))
    LAUNCHES["flash_attention_bwd"] += 1


def _bwd_q_blocked_kernel(q, k, v, do, dq, dk, dv, attention_mask):
    """Launches the query-blocked backward (TPU kernel 9, two passes, any
    S) on [B, h, S, Dh] views, writing dq, dk and dv: in f32 split-TF32
    products on the tensor cores, in bf16 the bf16 tensor cores; q, k, v
    and do 16-byte aligned rows (cp.async copies)."""
    _check_attention_inputs(q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv)
    _check_16_byte_rows(f"query-blocked {KERNEL_DTYPES[q.dtype]} backward", q=q, k=k, v=v, do=do)
    b, h, s, _ = q.shape
    bias = _kernel_bias(attention_mask, b, s, q.device)
    # per (b, head, query row): softmax max and denominator, and delta
    stats = torch.empty((b, h, s, 2), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_attention_long_bwd", f"dial_attention_bwd_q_blocked_{KERNEL_DTYPES[q.dtype]}",
            "attention q_blocked backward", q, (q, k, v, do, bias, dq, dk, dv, stats, delta),
            (q, k, v, do, dq, dk, dv))
    LAUNCHES["attention_bwd_q_blocked"] += 1


def _bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, dq, attention_mask):
    """Launches the dQ pass of the KV-blocked backward (TPU kernel 10; in
    f32 split-TF32 products on the tensor cores, in bf16 the bf16 tensor
    cores; q, k, v, o and do 16-byte aligned rows, cp.async copies): writes
    dq and returns delta = rowsum(dO O), f32 [B, h, S], for the dK/dV
    pass."""
    _check_attention_inputs(q=q, k=k, v=v, o=o, do=do, dq=dq)
    _check_16_byte_rows(f"KV-blocked {KERNEL_DTYPES[q.dtype]} dQ backward", q=q, k=k, v=v, o=o, do=do)
    b, h, s, _ = q.shape
    _check_rows("lse", lse, (b, h, s))
    bias = _kernel_bias(attention_mask, b, s, q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_attention_long_bwd", f"dial_attention_bwd_dq_kv_blocked_{KERNEL_DTYPES[q.dtype]}",
            "attention kv_blocked dQ backward", q, (q, k, v, o, do, bias, lse, dq, delta), (q, k, v, o, do, dq))
    LAUNCHES["bwd_dq_kv_blocked"] += 1
    return delta


def _bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, dk, dv, attention_mask):
    """Launches the dK/dV pass of the KV-blocked backward (TPU kernel 11;
    in f32 split-TF32 products on the tensor cores, in bf16 the bf16 tensor
    cores; q, k, v and do 16-byte aligned rows) with the forward's lse and
    the dQ pass's delta."""
    _check_attention_inputs(q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    _check_16_byte_rows(f"KV-blocked {KERNEL_DTYPES[q.dtype]} dK/dV backward", q=q, k=k, v=v, do=do)
    b, h, s, _ = q.shape
    _check_rows("lse", lse, (b, h, s))
    _check_rows("delta", delta, (b, h, s))
    bias = _kernel_bias(attention_mask, b, s, q.device)
    _launch("flash_attention_long_bwd", f"dial_attention_bwd_dkv_kv_blocked_{KERNEL_DTYPES[q.dtype]}",
            "attention kv_blocked dK/dV backward", q, (q, k, v, do, bias, lse, delta, dk, dv),
            (q, k, v, do, dk, dv))
    LAUNCHES["bwd_dkv_kv_blocked"] += 1


def _backward_into(q, k, v, do, dq, dk, dv, attention_mask, single_tile):
    """The backward on the card without an lse: the single-tile kernel
    (``single_tile``: the single-tile route) up to its dtype's
    shared-memory limit, else the query-blocked backward's code."""
    if single_tile and q.shape[2] <= single_tile_max_s("bwd", q.shape[-1], q.device, q.dtype):
        _backward_kernel(q, k, v, do, dq, dk, dv, attention_mask)
    else:
        _bwd_q_blocked_kernel(q, k, v, do, dq, dk, dv, attention_mask)


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    return t.is_cuda and not plain


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, attention_mask, num_heads, plain):
        b, s, three_h = qkv.shape
        ctx.num_heads, ctx.plain = num_heads, plain
        ctx.save_for_backward(qkv, attention_mask)
        if not _use_kernel(qkv, plain):
            return qkv_attention_plain(qkv, attention_mask, num_heads)
        if not qkv.is_contiguous():
            raise ValueError("fused_qkv_attention takes a contiguous [B, S, 3H] qkv")
        out = torch.empty((b, s, three_h // 3), dtype=qkv.dtype, device=qkv.device)
        q, k, v = _split_heads(qkv, num_heads)
        _forward_into(q, k, v, out.view(b, s, num_heads, -1).transpose(1, 2), attention_mask, True,
                      "qkv_native_attention")
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
        _backward_into(
            *_split_heads(qkv, num_heads),
            do.view(b, s, num_heads, -1).transpose(1, 2),
            *_split_heads(dqkv, num_heads),
            attention_mask,
            single_tile=True,
        )
        return dqkv, None, None, None


def _forward(q, k, v, attention_mask, plain=False):
    """The reference's ``_forward``: (o, lse-or-None) by S; lse only from
    the KV-blocked kernel, where a blocked backward needs it. On the card o
    is laid out [B, S, h, Dh] in memory, so the model's merge of the heads
    is a view."""
    route = attention_route(q.shape[2])
    if not _use_kernel(q, plain):
        if route == "single_tile":
            return attention_forward_plain(q, k, v, attention_mask), None
        if route == "q_blocked":
            return attention_q_blocked_plain(q, k, v, attention_mask), None
        return attention_kv_blocked_plain(q, k, v, attention_mask)
    b, h, s, dh = q.shape
    o = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if route == "kv_blocked":
        return o, _kv_blocked_kernel(q, k, v, o, attention_mask)
    _forward_into(q, k, v, o, attention_mask, route == "single_tile")
    return o, None


def _backward(q, k, v, o, lse, do, attention_mask, plain=False):
    """The reference's ``_bwd_rule``: (dq, dk, dv) by what the forward
    left: lse -> the KV-blocked passes (kernels 10, 11); a blocked S
    without it -> the query-blocked backward (kernel 9); else the
    single-tile backward (kernel 8), whose code past its shared-memory
    limit is kernel 9's."""
    blocked = attention_route(q.shape[2]) != "single_tile"
    if not _use_kernel(q, plain):
        if lse is not None:
            return attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, attention_mask)
        if blocked:
            return attention_bwd_q_blocked_plain(q, k, v, do, attention_mask)
        return attention_backward_plain(q, k, v, do, attention_mask)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if lse is not None:
        delta = _bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, dq, attention_mask)
        _bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, dk, dv, attention_mask)
    else:
        _backward_into(q, k, v, do, dq, dk, dv, attention_mask, single_tile=not blocked)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, attention_mask, plain):
        ctx.plain = plain
        o, lse = _forward(q, k, v, attention_mask, plain)
        # o is kept only for the KV-blocked backward's delta, as the
        # reference's _fwd_rule keeps it; the model's merge of the heads
        # reads it without writing (autograd's version check would raise)
        ctx.save_for_backward(q, k, v, attention_mask, None if lse is None else o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, attention_mask, o, lse = ctx.saved_tensors
        return (*_backward(q, k, v, o, lse, do.contiguous(), attention_mask, ctx.plain), None, None)


def fused_qkv_attention(qkv, attention_mask, num_heads: int, plain: bool = False):
    """Layout-native attention: qkv [B, S, 3H] (heads packed column-wise),
    mask [B, S] (1 = real token) -> context [B, S, H] in qkv's dtype.
    Differentiable w.r.t. qkv. ``plain=True`` runs the plain versions on
    any device (the yardstick the kernels are held against)."""
    return _FusedQKVAttention.apply(qkv, attention_mask, num_heads, plain)


def flash_attention(q, k, v, attention_mask, plain: bool = False):
    """Head-major attention: q, k, v [B, h, S, Dh] (any strides with a
    unit head-dim stride), mask [B, S] -> [B, h, S, Dh] in q's dtype,
    dispatched by S as the reference dispatches it. Differentiable w.r.t.
    q, k and v at every S (the backward dispatched as the reference's)."""
    return _FlashAttention.apply(q, k, v, attention_mask, plain)
