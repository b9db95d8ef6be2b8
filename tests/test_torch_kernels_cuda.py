"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip without one. This file imports no JAX,
so it runs on a machine with the card and PyTorch only:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the root conftest configures JAX for the CPU tests.)
Tolerances: bf16 3e-2, the reference's own bf16 tolerance for its fused
blocks (tests/test_fused_encoder.py); the f32 attention forward 2e-5, ten
times the reference's 2e-6 (tests/test_flash_attention.py) for another
summation order over the keys; its gradients atol 5e-5, rtol 1e-4, the
reference's own; the KV-blocked kernel's log-sum-exp 1e-5, the
reference's long-context lse tolerance; the blocked backward kernels
(9-11) f32 atol 5e-5, rtol 1e-4 and bf16 3e-2 of the plain gradient's
largest magnitude. Every kernel runs at every instantiation of
``fused_encoder.KERNEL_INSTANTIATIONS``: f32 and bf16 at bge-small widths
(H 384, 12 heads of 32), bge-base widths (H 768, 12 heads of 64) and
bge-large's (H 1024, 16 heads of 64), the
blocked kernels at head_dim 32 and 64, the bf16 attention forward
(kernels 4, 5, 6) on the tensor-core kernel; the single-tile shapes past
the single-tile kernels' shared-memory limit on the query-blocked
kernels' code; bf16 gradients are held to 3e-2 of each batch row's
largest plain value.
The bf16 outputs of kernels 1-3 at H >= 768 are held to 3e-2 of each row's
largest plain value (a row: one token's H values), the limit the bf16
gradients use: there LayerNorm outputs reach |value| >= 4, where one bf16
ulp (2^-5) exceeds 3e-2, and the kernel and the plain version, summing in
different orders, can round such a value to neighbouring bf16 values.
"""

import collections

import numpy as np
import pytest
import torch

from dial_rag_tpu_torch.ops import flash_attention as tfa
from dial_rag_tpu_torch.ops import fused_encoder as tfe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


# (dtype, H, heads, FFN width, tolerance, tolerance per row): every
# instantiation of kernels 1-3
WIDTHS = [
    (torch.bfloat16, 384, 12, 1536, 3e-2, False),
    (torch.float32, 384, 12, 1536, 2e-5, False),
    (torch.bfloat16, 768, 12, 3072, 3e-2, True),
    (torch.float32, 768, 12, 3072, 2e-5, False),
    (torch.bfloat16, 1024, 16, 4096, 3e-2, True),
    (torch.float32, 1024, 16, 4096, 2e-5, False),
]


def _assert_close(out, ref, atol, per_row=False):
    """|out - ref| <= atol, or with ``per_row`` <= atol times the largest
    |ref| of each row (the last dimension)."""
    out, ref = out.float(), ref.float()
    limit = atol * ref.abs().amax(dim=-1, keepdim=True) if per_row else atol
    assert ((out - ref).abs() <= limit).all(), (out - ref).abs().max().item()


def _assert_head_close(out, ref, rel=3e-2):
    """bf16 attention outputs [B, h, S, Dh]: |out - ref| <= ``rel`` times
    the largest |ref| of each (batch row, head). A typical output is about
    sqrt(e / S), so an absolute 3e-2 alone is as large as what it compares
    at long S."""
    out, ref = out.float(), ref.float()
    limit = rel * ref.abs().amax(dim=(2, 3), keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
    assert ((out - ref).abs() <= limit).all(), ((out - ref).abs() / limit).max().item()


def _block_inputs(device, b, s, dtype, hid, inter, seed):
    """x [B, S, H] in ``dtype``, a mask with a ragged last row, and one
    layer's weights (matrices in ``dtype``, vectors f32) as the
    reference's 12-tuple."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to(device, dt)

    x = rnd(b, s, hid, dt=dtype)
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[-1, 40:] = 0
    ones, zeros = torch.ones(hid, device=device), torch.zeros(hid, device=device)
    weights = (
        rnd(hid, 3 * hid, scale=0.05, dt=dtype), rnd(3 * hid, scale=0.02),
        rnd(hid, hid, scale=0.05, dt=dtype), rnd(hid, scale=0.02), ones, zeros,
        rnd(hid, inter, scale=0.05, dt=dtype), rnd(inter, scale=0.02),
        rnd(inter, hid, scale=0.05, dt=dtype), rnd(hid, scale=0.02), ones, zeros,
    )
    return x, mask.to(device), weights


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hid,heads,inter,atol,per_row", WIDTHS)
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (1, 64)])
def test_kernels_match_plain_on_card(cuda_device, b, s, dtype, hid, heads, inter, atol, per_row):
    """Kernels 1 and 2 against their plain versions at each instantiation:
    a ragged S (not a multiple of the row tiles), the longest S and a
    masked row; bf16 tolerance 3e-2 (at H >= 768 of each row's largest
    value), f32 2e-5."""
    x, mask, weights = _block_inputs(cuda_device, b, s, dtype, hid, inter, seed=3)
    tfe.reset_launches()
    out = tfe.fused_attention_block(x, mask, *weights[:6], heads)
    ref = tfe.fused_attention_block_plain(x, mask, *weights[:6], heads)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    _assert_close(out, ref, atol, per_row)
    out = tfe.fused_ffn_block(x, *weights[6:])
    ref = tfe.fused_ffn_block_plain(x, *weights[6:])
    torch.cuda.synchronize()
    _assert_close(out, ref, atol, per_row)
    assert tfe.LAUNCHES["fused_attention_block"] == tfe.LAUNCHES["fused_ffn_block"] == 1


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_input_they_do_not_take(cuda_device):
    """A CUDA tensor goes to the kernel or raises; it never falls back:
    a dtype or a width with no instantiation raises, naming the set (H
    1024 in both dtypes)."""
    for dtype, hid in ((torch.float16, 384), (torch.float32, 512), (torch.float32, 640)):
        x = torch.zeros(2, 8, hid, device=cuda_device, dtype=dtype)
        w = torch.zeros(hid, 1536, device=cuda_device, dtype=dtype)
        v = torch.zeros(1536, device=cuda_device)
        h = torch.zeros(hid, device=cuda_device)
        with pytest.raises(ValueError, match=r"bfloat16, H 1024.*float32, H 1024|float32, H 1024.*bfloat16, H 1024"):
            tfe.fused_ffn_block(x, w, v, w.T.contiguous(), h, h, h)


def test_cuda_requested_without_card_raises(monkeypatch):
    from dial_rag_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _attention_inputs(device, b, s, heads=12, dh=32, seed=5, dtype=torch.float32):
    """Packed qkv [B, S, 3H] in ``dtype``, a ragged mask with one fully
    masked row, and a cotangent [B, S, H] (f32)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(device, dtype)
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[0, s // 2 :] = 0
    mask[-1, :] = 0
    cot = torch.randn(b, s, heads * dh, generator=g).to(device)
    return qkv, mask.to(device), cot


def _grads(fn, inputs, cot):
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    (fn(*inputs).float() * cot).sum().backward()
    return [t.grad for t in inputs]


def _assert_grads_close(got, want, dtype):
    """f32: atol 5e-5, rtol 1e-4; bf16: per batch row, 3e-2 of the plain
    gradient's largest magnitude."""
    for a, w in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=5e-5, rtol=1e-4)
        else:
            for r in range(a.shape[0]):
                assert (a[r].float() - w[r].float()).abs().max().item() <= 3e-2 * w[r].float().abs().max().item()


# (dtype, head_dim, forward tolerance): every instantiation of kernels 4, 5, 8
ATTENTION = [(torch.float32, 32, 2e-5), (torch.bfloat16, 32, 3e-2), (torch.float32, 64, 2e-5),
             (torch.bfloat16, 64, 3e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,atol", ATTENTION)
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (4, 64), (2, 520)])
def test_attention_kernels_match_plain_on_card(cuda_device, b, s, dtype, dh, atol):
    """Kernels 4 (packed qkv) and 5 (head-major) forward, and kernel 8
    through both backwards, against the plain versions at each
    instantiation: a ragged S (not a multiple of the 32-row tiles), S =
    512, S = 520 (past one 512 tile but not a multiple of 256, so still
    single-tile) and a fully masked row."""
    heads = 12
    qkv, mask, cot = _attention_inputs(cuda_device, b, s, heads, dh, dtype=dtype)
    tfa.reset_launches()
    out = tfa.fused_qkv_attention(qkv, mask, heads)
    ref = tfa.fused_qkv_attention(qkv, mask, heads, plain=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    _assert_close(out, ref, atol)
    got = _grads(lambda x: tfa.fused_qkv_attention(x, mask, heads), [qkv], cot)
    want = _grads(lambda x: tfa.fused_qkv_attention(x, mask, heads, plain=True), [qkv], cot)
    _assert_grads_close(got, want, dtype)

    q, k, v = (t.contiguous() for t in tfa._split_heads(qkv, heads))
    cot_h = cot.view(b, s, heads, -1).transpose(1, 2).contiguous()
    out = tfa.flash_attention(q, k, v, mask)
    ref = tfa.flash_attention(q, k, v, mask, plain=True)
    _assert_close(out, ref, atol)
    got = _grads(lambda *x: tfa.flash_attention(*x, mask), [q, k, v], cot_h)
    want = _grads(lambda *x: tfa.flash_attention(*x, mask, plain=True), [q, k, v], cot_h)
    _assert_grads_close(got, want, dtype)
    torch.cuda.synchronize()
    # f32 on the single-tile split-TF32 forward, per layout; bf16 on the
    # tensor-core forward (both layouts); the backward on kernel 8 up to
    # its dtype's limit (f32: S = 128), past it on kernel 9's code
    fwd = ({"attention_tc": 4} if dtype == torch.bfloat16
           else {"qkv_native_attention": 2, "flash_attention_fwd": 2})
    bwd = ("flash_attention_bwd" if s <= tfa.single_tile_max_s("bwd", head_dim=dh, dtype=dtype)
           else "attention_bwd_q_blocked")
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.LAUNCHES, 0), **fwd, bwd: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
def test_attention_kernel_backward_is_reproducible(cuda_device, dh, dtype):
    """No atomics: two backward calls (kernel 8: the f32 split-TF32 kernel,
    the bf16 tensor-core kernel) give the same bits."""
    qkv, mask, cot = _attention_inputs(cuda_device, 2, 128, dh=dh, dtype=dtype)
    tfa.reset_launches()
    a = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)[0]
    b = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)[0]
    assert tfa.LAUNCHES["flash_attention_bwd"] == 2
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", [64, 100, 128, "limit", "limit + 1"])
def test_bf16_tensor_core_backward_on_card(cuda_device, s, dh):
    """Kernel 8 in bf16, the one-launch tensor-core backward, called
    directly on head-major views against ``attention_backward_plain`` with a
    half-masked and a fully masked row: at S = 64, 100 (ragged), 128 and at
    its limit, one launch each; at the limit + 1 the backward's route takes
    the query-blocked backward's two passes (kernel 9's bf16 code), as the
    launch counters show. Per batch row within 3e-2 of the largest plain
    gradient; the same bits twice."""
    limit = tfa.single_tile_max_s("bwd", head_dim=dh, dtype=torch.bfloat16)
    assert limit == 128
    s = {"limit": limit, "limit + 1": limit + 1}.get(s, s)
    qkv, mask, cot = _attention_inputs(cuda_device, 3, s, dh=dh, dtype=torch.bfloat16)
    q, k, v = (t.contiguous() for t in tfa._split_heads(qkv, 12))
    do = cot.view(3, s, 12, dh).transpose(1, 2).contiguous().to(torch.bfloat16)
    want = tfa.attention_backward_plain(q, k, v, do, mask)
    runs = []
    for _ in range(2):
        got = [torch.empty_like(t) for t in (q, k, v)]
        tfa.reset_launches()
        tfa._backward_into(q, k, v, do, *got, mask, single_tile=True)
        torch.cuda.synchronize()
        key = "flash_attention_bwd" if s <= limit else "attention_bwd_q_blocked"
        assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {key: 1}, tfa.LAUNCHES
        _assert_grads_close(got, want, torch.bfloat16)
        runs.append(got)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    if s > limit:
        with pytest.raises(ValueError, match="shared-memory limit"):
            tfa._backward_kernel(q, k, v, do, *runs[0], mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("limit,offset", [(None, 64), (None, 100), (None, 128), (None, 512), (None, 520),
                                          ("fwd", 0), ("bwd", 0), ("fwd", 64), ("bwd", 64)])
def test_f32_split_tf32_single_tile_kernels_on_card(cuda_device, limit, offset, dh):
    """Kernels 4 (packed qkv) and 5 (head-major) in f32, the split-TF32
    single-tile forward, and kernel 8 in f32, the split-TF32 single-tile
    backward, against the plain versions in both layouts, with a ragged
    and a fully masked row: at S = 64, 100, 128, 512 and 520, at the
    forward's and the backward's shared-memory limits (``limit``) and 64
    past each, where the launch counters must show kernel 6's code (the
    forward) or kernel 9's (the backward)."""
    fwd_max, bwd_max = tfa.single_tile_max_s("fwd", head_dim=dh), tfa.single_tile_max_s("bwd", head_dim=dh)
    assert fwd_max > 512 and bwd_max >= 128
    s = offset + {None: 0, "fwd": fwd_max, "bwd": bwd_max}[limit]
    b = 2 if s > 256 else 3
    qkv, mask, cot = _attention_inputs(cuda_device, b, s, dh=dh)
    q, k, v = (t.contiguous() for t in tfa._split_heads(qkv, 12))
    cot_h = cot.view(b, s, 12, dh).transpose(1, 2).contiguous()
    tfa.reset_launches()
    with torch.no_grad():
        _assert_close(tfa.fused_qkv_attention(qkv, mask, 12), tfa.fused_qkv_attention(qkv, mask, 12, plain=True),
                      2e-5)
        if tfa.attention_route(s) == "single_tile":
            _assert_close(tfa.flash_attention(q, k, v, mask), tfa.flash_attention(q, k, v, mask, plain=True), 2e-5)
    got = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)
    _assert_grads_close(got, _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12, plain=True), [qkv], cot),
                        torch.float32)
    got = _grads(lambda *x: tfa.flash_attention(*x, mask), [q, k, v], cot_h)
    _assert_grads_close(got, _grads(lambda *x: tfa.flash_attention(*x, mask, plain=True), [q, k, v], cot_h),
                        torch.float32)
    torch.cuda.synchronize()
    # the code each call took: the packed layout is single-tile at every S
    # (kernel 4, kernel 6's code past the forward's limit); head-major by
    # the route, then the limit
    single = tfa.attention_route(s) == "single_tile"
    packed_bwd = "flash_attention_bwd" if s <= bwd_max else "attention_bwd_q_blocked"
    major_fwd = "flash_attention_fwd" if single and s <= fwd_max else "attention_q_blocked"
    want = collections.Counter({"qkv_native_attention" if s <= fwd_max else "attention_q_blocked": 2})
    want[major_fwd] += 2 if single else 1
    want[packed_bwd] += 1
    want["attention_bwd_q_blocked" if not single else packed_bwd] += 1
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == dict(want), tfa.LAUNCHES


@pytest.mark.cuda
def test_f32_split_tf32_kernels_raise_on_unaligned_views(cuda_device):
    """The f32 single-tile kernels, the bf16 single-tile backward, the f32
    KV-blocked forward and backward passes and the bf16 blocked backwards
    (query-blocked and KV-blocked, o too) copy rows 16 bytes at a time: a
    view whose rows are not 16-byte
    aligned raises (no fallback)."""
    x = torch.randn(2, 2, 64, 36, device=cuda_device)
    q = x[..., 1:33]  # unit head-dim stride, rows 4 bytes past 16-byte alignment
    mask = torch.ones(2, 64, dtype=torch.int32, device=cuda_device)
    o = torch.empty(2, 2, 64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._forward_kernel(q, q, q, o, mask)
    grads = [torch.empty(2, 2, 64, 32, device=cuda_device) for _ in range(3)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._backward_kernel(q, q, q, q, *grads, mask)
    qh = torch.randn(2, 2, 64, 40, device=cuda_device).to(torch.bfloat16)[..., 4:36]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._backward_kernel(qh, qh, qh, qh, *(g.to(torch.bfloat16) for g in grads), mask)
    rows = torch.zeros(2, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_dq_kv_blocked_kernel(o, o, o, q, rows, o, grads[0], mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_dkv_kv_blocked_kernel(o, o, o, q, rows, rows, *grads[1:], mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._kv_blocked_kernel(q, o, o, o, mask)
    xb = torch.randn(2, 2, 64, 40, device=cuda_device).to(torch.bfloat16)
    qb = xb[..., 4:36]  # bf16 rows 8 bytes past 16-byte alignment
    ob = torch.empty(2, 2, 64, 32, device=cuda_device, dtype=torch.bfloat16)
    grads_b = [torch.empty_like(ob) for _ in range(3)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_q_blocked_kernel(ob, ob, qb, ob, *grads_b, mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_dq_kv_blocked_kernel(ob, ob, ob, qb, rows, ob, grads_b[0], mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_dkv_kv_blocked_kernel(ob, ob, qb, ob, rows, rows, *grads_b[1:], mask)


@pytest.mark.cuda
def test_attention_kernels_raise_on_bf16_and_long_sequences(cuda_device):
    """bf16 has kernels: at each head width the bf16 kernels run and match
    the plain version; a dtype or head width with no instantiation raises,
    naming the set. Past the single-tile kernels' shared-memory limit,
    where they used to raise, the forward (f32: the query-blocked code;
    bf16: the tensor-core kernel, which has no limit) and the backward
    (past its dtype's limit: the query-blocked backward's code) run and
    match the plain versions, in both dtypes at both head widths."""
    for dh in (32, 64):
        qkv, mask, _ = _attention_inputs(cuda_device, 2, 64, dh=dh, dtype=torch.bfloat16)
        out = tfa.fused_qkv_attention(qkv, mask, 12)
        ref = tfa.fused_qkv_attention(qkv, mask, 12, plain=True)
        assert out.dtype == torch.bfloat16
        _assert_close(out, ref, 3e-2)
    qkv, mask, _ = _attention_inputs(cuda_device, 1, 64)
    with pytest.raises(ValueError, match="bfloat16, H 768, head_dim 64"):
        tfa.fused_qkv_attention(qkv.half(), mask, 12)
    q = torch.zeros(1, 2, 64, 48, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16, H 768, head_dim 64"):
        tfa.flash_attention(q, q, q, mask)
    # past the single-tile kernels' shared-memory limits
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        for dh in (32, 64):
            for direction in ("fwd", "bwd"):
                # "fwd": past the f32 forward's limit, in both dtypes (the
                # bf16 forward has none)
                limit_dtype = dtype if direction == "bwd" else torch.float32
                s = tfa.single_tile_max_s(direction, head_dim=dh, dtype=limit_dtype) + 64
                qkv, mask, cot = _attention_inputs(cuda_device, 2, s, dh=dh, dtype=dtype)
                tfa.reset_launches()
                got = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)
                torch.cuda.synchronize()
                fwd = "attention_tc" if dtype == torch.bfloat16 else (
                    "attention_q_blocked" if direction == "fwd" else "qkv_native_attention")
                # past the f32 forward's limit the bf16 backward (its own,
                # longer limit) is still kernel 8
                past_bwd = s > tfa.single_tile_max_s("bwd", head_dim=dh, dtype=dtype)
                bwd, other = (("attention_bwd_q_blocked", "flash_attention_bwd") if past_bwd
                              else ("flash_attention_bwd", "attention_bwd_q_blocked"))
                assert tfa.LAUNCHES[fwd] == 1 and tfa.LAUNCHES[bwd] == 1, tfa.LAUNCHES
                assert tfa.LAUNCHES[other] == 0
                want = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12, plain=True), [qkv], cot)
                _assert_grads_close(got, want, dtype)
                out = tfa.fused_qkv_attention(qkv, mask, 12)
                _assert_close(out, tfa.fused_qkv_attention(qkv, mask, 12, plain=True), atol)


def _one_layer(device, dtype, hid, max_positions, heads=12):
    from dial_rag_tpu_torch.models.bert import BertConfig, init_params, prepare_params

    config = BertConfig(vocab_size=64, hidden_size=hid, num_layers=1, num_heads=heads,
                        intermediate_size=4 * hid, max_position_embeddings=max_positions)
    return prepare_params(init_params(config, torch.Generator().manual_seed(0)), device, dtype)


@pytest.mark.cuda
def test_auto_route_raises_where_kernels_are_missing(cuda_device):
    """"auto" on the card takes the reference's TPU route. At S = 1700
    (f32, exact GELU) the single-tile kernels' shared memory runs out,
    where the port used to raise; now the forward and backward take the
    query-blocked kernels' code, which launches once each and matches the
    plain route."""
    from dial_rag_tpu_torch.models.bert import bert_forward

    params = _one_layer(cuda_device, torch.float32, 384, 2048)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(5, 64, (2, 1700), generator=g).to(cuda_device)
    mask = torch.ones(2, 1700, dtype=torch.int32)
    mask[1, 600:] = 0
    mask = mask.to(cuda_device)
    emb = params["embeddings"]["word"].requires_grad_(True)
    cot = torch.randn(2, 1700, 384, generator=g).to(cuda_device)

    def run(impl):
        emb.grad = None
        out = bert_forward(params, ids, mask, num_heads=12, compute_dtype=torch.float32, gelu="exact",
                           attention_impl=impl)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), emb.grad.clone()

    assert 1700 > tfa.single_tile_max_s("fwd", head_dim=32) and tfa.attention_route(1700) == "single_tile"
    tfa.reset_launches()
    out, grad = run("auto")
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.LAUNCHES, 0), "attention_q_blocked": 1,
                            "attention_bwd_q_blocked": 1}, tfa.LAUNCHES
    ref, ref_grad = run("pallas_plain")
    assert torch.isfinite(out).all()
    _assert_close(out, ref, 2e-5)
    cos = torch.nn.functional.cosine_similarity(grad.flatten().double(), ref_grad.flatten().double(), dim=0)
    assert cos.item() > 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [384, 768])
@pytest.mark.parametrize(
    "dtype,gelu,s,launched,plain_route,atol",
    [
        (torch.float32, "tanh", 64, ("fused_attention_block", "fused_ffn_block"), "fused_plain", 2e-5),
        (torch.bfloat16, "exact", 64, ("attention_tc", "flash_attention_bwd"), "pallas_plain", 3e-2),
        (torch.bfloat16, "exact", 520, ("attention_tc", "attention_bwd_q_blocked"), "pallas_plain", 3e-2),
    ],
)
def test_auto_route_runs_the_kernels(cuda_device, hid, dtype, gelu, s, launched, plain_route, atol):
    """The routes the port once refused: (f32, tanh) through kernels 1-2,
    (bf16, exact) through kernel 4 (the tensor-core forward) and its
    backward (kernel 8), bf16 at S = 520 through kernel 5 (the same
    tensor-core forward) and kernel 8's route past its S = 128 limit
    (kernel 9's code); each hidden state within the
    dtype's tolerance of the plain route, each launch counted."""
    from dial_rag_tpu_torch.models.bert import bert_forward

    params = _one_layer(cuda_device, dtype, hid, 1024)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(5, 64, (2, s), generator=g).to(cuda_device)
    mask = torch.ones(2, s, dtype=torch.int32)
    mask[1, s // 3 :] = 0
    mask = mask.to(cuda_device)
    emb = params["embeddings"]["word"].requires_grad_(True)
    # a random cotangent: the sum of a LayerNorm output has no gradient
    cot = torch.randn(2, s, hid, generator=g).to(cuda_device)

    def run(impl):
        emb.grad = None
        out = bert_forward(params, ids, mask, num_heads=12, compute_dtype=dtype, gelu=gelu, attention_impl=impl)
        (out.float() * cot).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), emb.grad.clone()

    tfe.reset_launches()
    tfa.reset_launches()
    out, grad = run("auto")
    counts = {**tfe.LAUNCHES, **tfa.LAUNCHES}
    assert all(counts[name] == 1 for name in launched), counts
    ref, ref_grad = run(plain_route)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    _assert_close(out, ref, atol)
    cos = torch.nn.functional.cosine_similarity(grad.flatten().double(), ref_grad.flatten().double(), dim=0)
    assert cos.item() > 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 512])
def test_auto_route_at_bge_large_width_runs_kernels_1_and_2(cuda_device, s):
    """"auto" (tanh GELU) at bge-large's width, H 1024 with 16 heads of 64,
    S <= 512, in bf16 and f32: kernels 1 and 2, once each for the one layer
    and no attention kernel, within 3e-2 of each row's largest value of the
    "fused_plain" route in bf16, within 2e-5 of it in f32."""
    from dial_rag_tpu_torch.models.bert import bert_forward

    params = _one_layer(cuda_device, torch.bfloat16, 1024, 512, heads=16)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(5, 64, (2, s), generator=g).to(cuda_device)
    mask = torch.ones(2, s, dtype=torch.int32)
    mask[1, s // 3 :] = 0
    mask = mask.to(cuda_device)

    def run(impl, p=params, dtype=torch.bfloat16):
        out = bert_forward(p, ids, mask, num_heads=16, compute_dtype=dtype, gelu="tanh", attention_impl=impl)
        torch.cuda.synchronize()
        return out

    tfe.reset_launches()
    tfa.reset_launches()
    out = run("auto")
    assert tfe.LAUNCHES == {"fused_attention_block": 1, "fused_ffn_block": 1, "fused_layer_block": 0}
    assert not any(tfa.LAUNCHES.values()), tfa.LAUNCHES
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    _assert_close(out, run("fused_plain"), 3e-2, per_row=True)
    f32 = _one_layer(cuda_device, torch.float32, 1024, 512, heads=16)
    tfe.reset_launches()
    out = run("auto", f32, torch.float32)
    assert tfe.LAUNCHES == {"fused_attention_block": 1, "fused_ffn_block": 1, "fused_layer_block": 0}
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    _assert_close(out, run("fused_plain", f32, torch.float32), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,atol", ATTENTION)
def test_single_tile_kernels_at_their_limit(cuda_device, dtype, dh, atol):
    """Kernels 4 and 5 at the longest S the f32 forward takes, kernel 8 at
    the longest its backward takes in the dtype, against the plain
    versions, at each instantiation (the bf16 forward, the tensor-core
    kernel, has no limit: it runs at the f32 forward's)."""
    fwd_s = tfa.single_tile_max_s("fwd", head_dim=dh)
    bwd_s = tfa.single_tile_max_s("bwd", head_dim=dh, dtype=dtype)
    assert fwd_s > 512 and bwd_s == 128
    qkv, mask, cot = _attention_inputs(cuda_device, 1, fwd_s, dh=dh, dtype=dtype)
    out = tfa.fused_qkv_attention(qkv, mask, 12)
    ref = tfa.fused_qkv_attention(qkv, mask, 12, plain=True)
    _assert_close(out, ref, atol)
    q, k, v = tfa._split_heads(qkv, 12)
    _assert_close(tfa.flash_attention(q, k, v, mask), tfa.flash_attention(q, k, v, mask, plain=True), atol)
    if tfa.attention_route(fwd_s) != "single_tile":
        # a limit that is a multiple of 256 past 512 takes the query-blocked
        # route head-major; kernel 5 is gated 64 rows below it
        s5 = fwd_s - 64
        assert tfa.attention_route(s5) == "single_tile"
        q, k, v = (t[:, :, :s5] for t in (q, k, v))
        out = tfa.flash_attention(q, k, v, mask[:, :s5])
        _assert_close(out, tfa.flash_attention(q, k, v, mask[:, :s5], plain=True), atol)
    qkv, mask, cot = _attention_inputs(cuda_device, 1, bwd_s, dh=dh, dtype=dtype)
    got = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)
    want = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12, plain=True), [qkv], cot)
    _assert_grads_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("b,s", [(3, 64), (2, 100), (2, 256), (2, 520), (2, 1700), (2, 4096)])
def test_tensor_core_forward_matches_plain_on_card(cuda_device, b, s, dh):
    """The bf16 tensor-core forward, which serves kernels 4 (packed qkv),
    5 (head-major, single-tile S) and 6 (head-major, query-blocked S), at
    each head width: ragged S (100, 520, 1700: a ragged last key chunk),
    one and many 64-key chunks, a half-masked row and a fully masked one
    (uniform over its S real keys), against the plain versions within 3e-2
    and within 3e-2 of each (batch row, head)'s largest plain value."""
    qkv, mask, _ = _attention_inputs(cuda_device, b, s, dh=dh, dtype=torch.bfloat16)
    tfa.reset_launches()
    out = tfa.fused_qkv_attention(qkv, mask, 12)
    q, k, v = tfa._split_heads(qkv, 12)
    head_major = tfa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.LAUNCHES, 0), "attention_tc": 2}, tfa.LAUNCHES
    for got, ref in ((out, tfa.fused_qkv_attention(qkv, mask, 12, plain=True)),
                     (head_major, tfa.flash_attention(q, k, v, mask, plain=True))):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        _assert_close(got, ref, 3e-2)
        if got.dim() == 3:
            got, ref = (x.view(b, s, 12, dh).transpose(1, 2) for x in (got, ref))
        _assert_head_close(got, ref)
    # the fully masked row: every query's output is the mean of its S values
    mean = v[-1:].float().mean(dim=2, keepdim=True).expand(-1, -1, s, -1)
    _assert_close(head_major[-1:], mean, 3e-2)
    _assert_head_close(head_major[-1:], mean)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "route,b,s", [("q_blocked", 2, 768), ("q_blocked", 1, 4096), ("kv_blocked", 1, 4608), ("kv_blocked", 3, 8192)]
)
def test_long_attention_kernels_match_plain_on_card(cuda_device, dtype, atol, route, b, s, dh):
    """Kernels 6 (query-blocked; in bf16 the tensor-core forward) and 7
    (KV-blocked, with its log-sum-exp; in f32 split-TF32 products, one
    rescale per 64-key chunk) against their plain versions at head_dim 32
    and 64, q, k and v read as strided views of a packed qkv, a ragged
    mask and a fully masked row, lse within 1e-5; bf16 also within 3e-2 of
    each (batch row, head)'s largest plain value."""
    qkv, mask, _ = _attention_inputs(cuda_device, b + 1, s, dh=dh)
    q, k, v = tfa._split_heads(qkv.to(dtype), 12)
    assert tfa.attention_route(s) == route
    tfa.reset_launches()
    out, lse = tfa._forward(q, k, v, mask)
    ref, ref_lse = tfa._forward(q, k, v, mask, plain=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= atol
    if dtype == torch.bfloat16:
        _assert_head_close(out, ref)
    name = {"kv_blocked": "attention_kv_blocked_fwd", "q_blocked": "attention_q_blocked"}[route]
    if route == "q_blocked" and dtype == torch.bfloat16:
        name = "attention_tc"
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.LAUNCHES, 0), name: 1}, tfa.LAUNCHES
    if route == "kv_blocked":
        assert torch.isfinite(lse).all() and (lse - ref_lse).abs().max().item() <= 1e-5
    else:
        assert lse is None and ref_lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", [(1, 4608), (3, 8192)])
def test_kv_blocked_tensor_core_forward_on_card(cuda_device, b, s, dtype, dh):
    """Kernel 7 on the tensor cores (bf16 products; in f32 split-TF32
    ones) against its plain version with a score offset that grows every
    512-key block (q[..., 0] = 1, k[..., 0] = 8 j in block j), so the row
    max rises from block to block and corr < 1 rescales l and the
    accumulator (in f32 at the first chunk of each block): bf16 o within
    3e-2 and within 3e-2 of each (batch row, head)'s largest plain value,
    f32 o within 2e-5; lse within 1e-5; a ragged row and, at B = 3, a full
    and a fully masked one."""
    qkv, _, _ = _attention_inputs(cuda_device, b, s, dh=dh, dtype=torch.float32)
    lengths = torch.tensor([s - 300] if b == 1 else [s, s - 300, 0])
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(cuda_device, torch.int32)
    q, k, v = (t.clone() for t in tfa._split_heads(qkv, 12))
    q[..., 0] = 1.0
    k[..., 0] = 8.0 * (torch.arange(s, device=cuda_device) // tfa._KV_BLOCK)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    assert tfa.attention_route(s) == "kv_blocked"
    tfa.reset_launches()
    out, lse = tfa._forward(q, k, v, mask)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.LAUNCHES, 0), "attention_kv_blocked_fwd": 1}, tfa.LAUNCHES
    ref, ref_lse = tfa._forward(q, k, v, mask, plain=True)
    assert out.dtype == dtype and torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    if dtype == torch.bfloat16:
        _assert_close(out, ref, 3e-2)
        _assert_head_close(out, ref)
    else:
        _assert_close(out, ref, 2e-5)
    assert (lse - ref_lse).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (1, 64)])
def test_ffn_kernel_at_h1024_on_card(cuda_device, b, s):
    """Kernel 2 in bf16 at bge-large's width (H 1024, FFN 4096), which
    kernels 1 and 3 take too (in f32 as well, ``WIDTHS``): against its
    plain version within 3e-2 of each row's largest plain value, one
    launch; a ragged row count."""
    x, _, weights = _block_inputs(cuda_device, b, s, torch.bfloat16, 1024, 4096, seed=7)
    assert tfe.kernel_supports(torch.bfloat16, 1024) and tfe.kernel_supports(torch.float32, 1024)
    tfe.reset_launches()
    out = tfe.fused_ffn_block(x, *weights[6:])
    torch.cuda.synchronize()
    assert tfe.LAUNCHES["fused_ffn_block"] == 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    _assert_close(out, tfe.fused_ffn_block_plain(x, *weights[6:]), 3e-2, per_row=True)


def _long_grads(fn, q, k, v, cot):
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    (fn(*xs).float() * cot).sum().backward()
    return [x.grad for x in xs]


def _excess(a, w, rtol=1e-4):
    return ((a - w).abs() - rtol * w.abs()).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "route,b,s", [("q_blocked", 2, 1024), ("q_blocked", 2, 4096), ("q_blocked", 2, 4352), ("kv_blocked", 2, 8192)]
)
def test_long_backward_kernels_match_plain_on_card(cuda_device, dtype, route, b, s, dh):
    """Kernels 9 (query-blocked) and 10-11 (KV-blocked, from the forward's
    o and lse) against their plain versions through ``flash_attention``'s
    backward, q, k and v strided views of a packed qkv, standard-normal
    inputs, a row ragged across a 512-key block and a fully masked row.
    f32: atol 5e-5, rtol 1e-4 (the single-tile backward's), except in the
    KV-blocked backward's fully masked row: there P = 1 for every key
    (exp(s - lse) with s = lse = f32.min, as in the reference), so each
    gradient is a sum of S = 8192 terms of size 1 whose f32 rounding alone
    exceeds atol, and the kernel must be at least as close as the plain
    version to the same expressions evaluated in f64. bf16: per batch row,
    3e-2 of the plain gradient's largest magnitude. At head_dim 32 and 64;
    S = 4096 is the shape chip_smoke.py times kernel 9 at."""
    qkv, mask, cot = _attention_inputs(cuda_device, b + 1, s, dh=dh)
    mask[-2, s // 3 :] = 0
    q, k, v = tfa._split_heads(qkv.to(dtype), 12)
    cot = cot.view(b + 1, s, 12, -1).transpose(1, 2)
    assert tfa.attention_route(s) == route
    tfa.reset_launches()
    got = _long_grads(lambda *x: tfa.flash_attention(*x, mask), q, k, v, cot)
    torch.cuda.synchronize()
    names = ["attention_bwd_q_blocked"] if route == "q_blocked" else ["bwd_dq_kv_blocked", "bwd_dkv_kv_blocked"]
    assert all(tfa.LAUNCHES[n] == 1 for n in names)
    want = _long_grads(lambda *x: tfa.flash_attention(*x, mask, plain=True), q, k, v, cot)
    exact = None
    if route == "kv_blocked" and dtype == torch.float32:
        with torch.no_grad():
            o, lse = tfa._forward(q, k, v, mask)
            do = cot.to(dtype)
            exact = tfa.attention_bwd_kv_blocked_plain(*(t.double() for t in (q, k, v, o)), lse, do.double(), mask)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        if dtype == torch.bfloat16:
            for r in range(b + 1):
                assert (a[r].float() - w[r].float()).abs().max().item() <= 3e-2 * w[r].float().abs().max().item()
        elif exact is None:
            torch.testing.assert_close(a, w, atol=5e-5, rtol=1e-4)
        else:
            torch.testing.assert_close(a[:-1], w[:-1], atol=5e-5, rtol=1e-4)
            e = exact[i][-1]
            assert _excess(a[-1].double(), e) <= max(5e-5, _excess(w[-1].double(), e))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("b,s", [(3, 1000), (3, 4200)])
def test_bf16_kv_blocked_passes_match_plain_on_card(cuda_device, b, s, dh):
    """Kernels 10 and 11 in bf16 (the tensor-core passes) called straight
    at an S that is not a multiple of 64 (a ragged last key chunk and query
    tile), fed the plain forward's o and lse: a full row, a ragged row and
    a fully masked one (P = 1 for every key). delta within 5e-5 of
    rowsum(dO O) (chip_smoke.py's gate); each gradient within 3e-2 of each
    (batch row, head)'s largest plain magnitude."""
    qkv, mask, cot = _attention_inputs(cuda_device, b, s, dh=dh, dtype=torch.bfloat16)
    q, k, v = tfa._split_heads(qkv, 12)
    do = cot.view(b, s, 12, -1).transpose(1, 2).to(torch.bfloat16)
    o, lse = tfa.attention_kv_blocked_plain(q, k, v, mask)
    grads = [torch.empty(t.shape, dtype=torch.bfloat16, device=cuda_device) for t in (q, k, v)]
    tfa.reset_launches()
    delta = tfa._bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, grads[0], mask)
    tfa._bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, *grads[1:], mask)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["bwd_dq_kv_blocked"] == 1 and tfa.LAUNCHES["bwd_dkv_kv_blocked"] == 1
    torch.testing.assert_close(delta, (do.float() * o.float()).sum(dim=-1), atol=5e-5, rtol=0)
    want = tfa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)
    for a, w in zip(grads, want):
        assert torch.isfinite(a.float()).all()
        _assert_head_close(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("route,s,dtype", [("q_blocked", 1024, torch.float32), ("kv_blocked", 8192, torch.float32),
                                           ("q_blocked", 1024, torch.bfloat16), ("kv_blocked", 8192, torch.bfloat16)])
def test_long_backward_is_reproducible(cuda_device, route, s, dtype, dh):
    """No atomics: two blocked backward calls give the same bits at
    head_dim 32 and 64: in f32 the split-TF32 kernel 9 (S = 1024) and the
    split-TF32 KV-blocked passes, kernels 10 and 11 (S = 8192); in bf16
    the tensor-core kernel 9 (S = 1024) and kernels 10 and 11 (S = 8192);
    head_dim 64 holds the most registers."""
    qkv, mask, cot = _attention_inputs(cuda_device, 2, s, dh=dh, dtype=dtype)
    q, k, v = tfa._split_heads(qkv, 12)
    cot = cot.view(2, s, 12, -1).transpose(1, 2)
    assert tfa.attention_route(s) == route
    tfa.reset_launches()
    a = _long_grads(lambda *x: tfa.flash_attention(*x, mask), q, k, v, cot)
    b = _long_grads(lambda *x: tfa.flash_attention(*x, mask), q, k, v, cot)
    names = ["attention_bwd_q_blocked"] if route == "q_blocked" else ["bwd_dq_kv_blocked", "bwd_dkv_kv_blocked"]
    assert all(tfa.LAUNCHES[n] == 2 for n in names), tfa.LAUNCHES
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hid,heads,inter,atol,per_row", WIDTHS)
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (1, 64)])
def test_layer_kernel_matches_plain_on_card(cuda_device, b, s, dtype, hid, heads, inter, atol, per_row):
    """Kernel 3 (the whole layer) against its plain version at each
    instantiation: a ragged S, the longest S and a masked row; and equal,
    bit for bit, to kernels 1 and 2 in turn (in bf16 it runs their launch
    sequences themselves, csrc/encoder_tc.cuh)."""
    x, mask, weights = _block_inputs(cuda_device, b, s, dtype, hid, inter, seed=4)
    tfe.reset_launches()
    out = tfe.fused_layer_block(x, mask, weights, heads)
    ref = tfe.fused_layer_block_plain(x, mask, weights, heads)
    torch.cuda.synchronize()
    assert tfe.LAUNCHES["fused_layer_block"] == 1
    _assert_close(out, ref, atol, per_row)
    two = tfe.fused_ffn_block(tfe.fused_attention_block(x, mask, *weights[:6], heads), *weights[6:])
    assert torch.equal(out, two)


@pytest.mark.cuda
def test_fused_block_gradients_on_card(cuda_device):
    """The fused blocks train in bf16 on the card: their backward
    recomputes through the plain versions, so the gradients through the
    kernel route equal those through the plain route."""
    hid, heads, inter, b, s = 384, 12, 1536, 2, 64
    g = torch.Generator().manual_seed(6)

    def leaf(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(cuda_device).requires_grad_(True)

    x = leaf(b, s, hid)
    mask = torch.ones(b, s, dtype=torch.int32, device=cuda_device)
    mask[1, 30:] = 0
    attn_w = [leaf(hid, 3 * hid, scale=0.05), leaf(3 * hid, scale=0.02), leaf(hid, hid, scale=0.05),
              leaf(hid, scale=0.02), leaf(hid, scale=0.1), leaf(hid, scale=0.1)]
    ffn_w = [leaf(hid, inter, scale=0.05), leaf(inter, scale=0.02), leaf(inter, hid, scale=0.05),
             leaf(hid, scale=0.02), leaf(hid, scale=0.1), leaf(hid, scale=0.1)]
    cot = torch.randn(b, s, hid, generator=g).to(cuda_device)

    def grads(attn, ffn):
        for t in [x, *attn_w, *ffn_w]:
            t.grad = None
        a = attn(x.bfloat16(), mask, *attn_w, heads)
        (ffn(a, *ffn_w).float() * cot).sum().backward()
        return [t.grad.clone() for t in [x, *attn_w, *ffn_w]]

    tfe.reset_launches()
    got = grads(tfe.fused_attention_block, tfe.fused_ffn_block)
    assert tfe.LAUNCHES["fused_attention_block"] == tfe.LAUNCHES["fused_ffn_block"] == 1
    want = grads(tfe.fused_attention_block_plain, tfe.fused_ffn_block_plain)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        cos = torch.nn.functional.cosine_similarity(a.flatten().double(), w.flatten().double(), dim=0)
        assert cos.item() > 0.9999


def _tf32_product(a, w, bias, epilogue, rows):
    """The split-TF32 product of the f32 blocks on its own (``csrc/
    fused_ffn.cu``'s ``dial_gemm_tf32``): rows 0 .. rows - 1 of a . w
    through ``epilogue`` (0 GELU of + bias, 1 the product, 2 + bias) into
    an output whose other rows stay NaN."""
    from dial_rag_tpu_torch.ops._build import build_kernels

    k, n = w.shape
    out = torch.full((a.shape[0], n), float("nan"), device=a.device)
    planes = torch.empty(2 * k * n, device=a.device)
    err = build_kernels().libs["fused_ffn"].dial_gemm_tf32(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), planes.data_ptr(), rows, n, k, epilogue,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(384, 1152), (1536, 384), (3072, 768)])
def test_f32_product_against_f64_on_card(cuda_device, k, n):
    """The f32 blocks' split-TF32 product at the QKV (K = 384), the FFN's
    down product at bge-small (1536) and bge-base (3072) widths, on m =
    1000 rows (not a multiple of its 128-row tile; the rows past m are
    never written): no farther from the product in f64 than 1.5 times the
    f32 product of cuBLAS (TF32 off) is, its bias and GELU epilogues too."""
    g = torch.Generator().manual_seed(k)
    m = 1000
    a = torch.randn(m + 24, k, generator=g)
    if k > 768:  # the FFN's h: GELU outputs
        a = torch.nn.functional.gelu(a, approximate="tanh")
    a, w = a.to(cuda_device), (torch.randn(k, n, generator=g) * 0.02).to(cuda_device)
    bias = (torch.randn(n, generator=g) * 0.02).to(cuda_device)
    def epilogues(product, b):
        return {1: product, 2: product + b, 0: torch.nn.functional.gelu(product + b, approximate="tanh")}

    exact = epilogues(a[:m].double() @ w.double(), bias.double())
    plain = epilogues(a[:m] @ w, bias)
    for epilogue, want in exact.items():
        out = _tf32_product(a, w, bias, epilogue, m)
        assert torch.isnan(out[m:]).all() and torch.isfinite(out[:m]).all()
        err = (out[:m].double() - want).abs().max().item()
        plain_err = (plain[epilogue].double() - want).abs().max().item()
        assert err <= 1.5 * plain_err, (epilogue, err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,inter", [(384, 12, 1536), (768, 12, 3072), (1024, 16, 4096)])
def test_f32_blocks_are_reproducible(cuda_device, hid, heads, inter):
    """f32 kernels 1, 2 and 3 give the same bits twice (no atomics: every
    product sums K in one order), at a serving bucket, B=16 S=256."""
    x, mask, weights = _block_inputs(cuda_device, 16, 256, torch.float32, hid, inter, seed=8)
    for run in (lambda: tfe.fused_attention_block(x, mask, *weights[:6], heads),
                lambda: tfe.fused_ffn_block(x, *weights[6:]),
                lambda: tfe.fused_layer_block(x, mask, weights, heads)):
        assert torch.equal(run(), run())


def _bm25_corpus():
    """tests/test_bm25.py's banded corpus: duplicated items (exact ties),
    a ubiquitous term (the band), rare tail terms."""
    rng = np.random.default_rng(23)
    base = [[f"w{int(x)}" for x in rng.integers(0, 120, size=8)] for _ in range(300)]
    items = base + base[:40] + [["common", "w1"]] * 25
    items = [(["common"] if i % 3 else []) + it for i, it in enumerate(items)]
    queries = [["common", "w1", "w1", "w2"], ["common"], ["w1", "w2", "w3", "w4", "w5"],
               ["w117", "w118", "zzz-oov"], ["zzz-oov"]]
    return items, queries + [[f"w{int(x)}" for x in rng.integers(0, 120, size=6)] for _ in range(40)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [{}, {"max_dense_bytes": 0}, {"max_dense_bytes": 0, "max_band_bytes": 0}])
def test_bm25_same_bits_and_latest_first_on_card(cuda_device, layout):
    """BM25 on the card (dense, band + CSC, CSC): the same queries give
    the same bits twice (the CSC tail adds in one fixed order, no racing
    atomics), a query the same bits alone and in a batch, scores within
    tests/test_bm25.py's rtol 1e-5 / atol 1e-6 of the CPU's, the same
    top-n, and identical items ranked latest first."""
    from dial_rag_tpu_torch.index.bm25 import Bm25Index

    items, queries = _bm25_corpus()
    card = Bm25Index.build(items, device=cuda_device, **layout)
    cpu = Bm25Index.build(items, device="cpu", **layout)
    first, again = card.get_scores_batch(queries), card.get_scores_batch(queries)
    assert np.array_equal(first.view(np.int32), again.view(np.int32))
    np.testing.assert_allclose(first, cpu.get_scores_batch(queries), rtol=1e-5, atol=1e-6)
    for k in (5, 12):
        for q, (idx, vals) in zip(queries, card.top_n_batch_with_scores(queries, k)):
            single_idx, single_vals = card.top_n_with_scores(q, k)
            np.testing.assert_array_equal(idx, single_idx)
            np.testing.assert_array_equal(vals, single_vals)
            np.testing.assert_array_equal(idx, cpu.top_n(q, k))
    ties = [["a", "b"], ["x"], ["a", "b"], ["y"], ["a", "b"], ["z"], ["a", "b"]]
    index = Bm25Index.build(ties, device=cuda_device, **layout)
    np.testing.assert_array_equal(index.top_n(["a"], 4), [6, 4, 2, 0])
    np.testing.assert_array_equal(index.top_n(["nothing"], 3), [6, 5, 4])


# --- the dense layouts and MaxSim on the card (torch products, no kernel of
# the port's own: tests/test_torch_dense_layouts.py and
# tests/test_torch_late_interaction.py hold the same code to the JAX
# package on the CPU)


def _normal_rows(n, d, seed):
    rows = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 1000, 4096])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_int8_dense_on_card_matches_cpu(cuda_device, n, q):
    """``torch._int_mm``'s shape limits (M > 16, K and N multiples of 8) at
    Q = 1, 8, 64 and N = 17, 1000, 4096: the s32 product is exact, so the
    card's distances are the CPU's within rtol 1e-6, the hits equal, batch
    equal to single."""
    from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
    from dial_rag_tpu_torch.index.records import RetrievalType

    rows = _normal_rows(n, 384, 0)
    queries = rows[np.arange(q) % n] + np.random.default_rng(1).standard_normal((q, 384)).astype(np.float32) * 0.05
    docs = [DocEmbeddings(np.arange(n), rows)]
    card = DenseIndex(RetrievalType.TEXT, docs, limit=7, storage_dtype="int8", device=cuda_device)
    cpu = DenseIndex(RetrievalType.TEXT, docs, limit=7, storage_dtype="int8", device="cpu")
    batch = card.find_batch(queries)
    for qv, hits in zip(queries, batch):
        h, d = card.find_with_distances(qv)
        ch, cd = cpu.find_with_distances(qv)
        assert [x.chunk_id for x in h] == [x.chunk_id for x in ch] == [x.chunk_id for x in hits]
        np.testing.assert_allclose(d, cd, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bfloat16", "two_pass"])
def test_dense_scan_memory_on_card(cuda_device, storage):
    """At 1M x 384 a 64-query scan and a single query hold at most a tenth
    of the index beyond it (no f32 copy of the bf16 matrix, no [Q, N]
    scores), and two_pass returns the float32 index's hits."""
    from dial_rag_tpu_torch.index.dense_index import DenseIndex
    from dial_rag_tpu_torch.index.records import RetrievalType

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mat = torch.randn((1_000_000, 384), generator=gen, device=cuda_device)
    mat /= mat.norm(dim=1, keepdim=True)
    queries = (mat[:64] + 0.05 * torch.randn((64, 384), generator=gen, device=cuda_device)).cpu()
    f32 = DenseIndex.from_device_matrix(RetrievalType.TEXT, mat, limit=7)
    if storage == "bfloat16":
        index = DenseIndex.from_device_matrix(RetrievalType.TEXT, mat.bfloat16(), limit=7)
    else:
        from dial_rag_tpu_torch.index.dense_index import DocEmbeddings

        index = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(1_000_000), mat.cpu().numpy())], limit=7,
                           storage_dtype="two_pass", device=cuda_device)
    index.find_batch(queries)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hits = index.find_batch(queries)
    index.find(queries[0])
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= 0.1 * index.nbytes
    if storage == "two_pass":
        for h, ref in zip(hits, f32.find_batch(queries)):
            assert [x.chunk_id for x in h] == [x.chunk_id for x in ref]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_maxsim_on_card_matches_cpu_and_repeats(cuda_device, storage):
    """MaxSim on the card: scores within 1e-5 of the same code on the CPU
    (int8: rtol 1e-6), the same hits, batch equal to single, and the same
    bits when a batch is scored twice."""
    from dial_rag_tpu_torch.index.late_interaction import LateInteractionIndex
    from dial_rag_tpu_torch.index.records import RetrievalType

    rng = np.random.default_rng(3)
    chunks = [rng.standard_normal((int(rng.integers(0, 40)), 64)).astype(np.float32) for _ in range(700)]
    chunks = [c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12) for c in chunks]
    queries = [rng.standard_normal((int(rng.integers(3, 20)), 64)).astype(np.float32) for _ in range(12)]
    card = LateInteractionIndex(RetrievalType.TEXT, [chunks], max_chunk_tokens=32, limit=7, storage_dtype=storage,
                                device=cuda_device)
    cpu = LateInteractionIndex(RetrievalType.TEXT, [chunks], max_chunk_tokens=32, limit=7, storage_dtype=storage,
                               device="cpu")
    batch = card.find_batch(queries)
    for q, hits in zip(queries, batch):
        h, s = card.find_with_scores(q)
        ch, cs = cpu.find_with_scores(q)
        assert [x.chunk_id for x in h] == [x.chunk_id for x in ch] == [x.chunk_id for x in hits]
        np.testing.assert_allclose(s, cs, rtol=1e-6 if storage == "int8" else 0, atol=0 if storage == "int8" else 1e-5)
    again = card.find_batch(queries)
    assert [[x.score for x in h] for h in again] == [[x.score for x in h] for h in batch]
