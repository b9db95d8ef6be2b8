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
largest magnitude.
"""

import pytest
import torch

from dial_rag_tpu_torch.ops import flash_attention as tfa
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


def _attention_inputs(device, b, s, heads=12, dh=32, seed=5):
    """Packed qkv [B, S, 3H] f32, a ragged mask with one fully masked row,
    and a cotangent [B, S, H]."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(device)
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[0, s // 2 :] = 0
    mask[-1, :] = 0
    cot = torch.randn(b, s, heads * dh, generator=g).to(device)
    return qkv, mask.to(device), cot


def _grads(fn, inputs, cot):
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    (fn(*inputs) * cot).sum().backward()
    return [t.grad for t in inputs]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (4, 64), (2, 520)])
def test_attention_kernels_match_plain_on_card(cuda_device, b, s):
    """Kernels 4 (packed qkv) and 5 (head-major) forward, and kernel 8
    through both backwards, against the plain versions: a ragged S (not a
    multiple of the 32-row tiles), S = 512, S = 520 (past one 512 tile but
    not a multiple of 256, so still single-tile) and a fully masked row."""
    heads = 12
    qkv, mask, cot = _attention_inputs(cuda_device, b, s, heads)
    tfa.reset_launches()
    out = tfa.fused_qkv_attention(qkv, mask, heads)
    ref = tfa.fused_qkv_attention(qkv, mask, heads, plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-5
    got = _grads(lambda x: tfa.fused_qkv_attention(x, mask, heads), [qkv], cot)[0]
    want = _grads(lambda x: tfa.fused_qkv_attention(x, mask, heads, plain=True), [qkv], cot)[0]
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)

    q, k, v = (t.contiguous() for t in tfa._split_heads(qkv, heads))
    cot_h = cot.view(b, s, heads, -1).transpose(1, 2).contiguous()
    out = tfa.flash_attention(q, k, v, mask)
    ref = tfa.flash_attention(q, k, v, mask, plain=True)
    assert (out - ref).abs().max().item() <= 2e-5
    got = _grads(lambda *x: tfa.flash_attention(*x, mask), [q, k, v], cot_h)
    want = _grads(lambda *x: tfa.flash_attention(*x, mask, plain=True), [q, k, v], cot_h)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=5e-5, rtol=1e-4)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"qkv_native_attention": 2, "flash_attention_fwd": 2, "flash_attention_bwd": 2,
                            "attention_q_blocked": 0, "attention_kv_blocked_fwd": 0, "attention_bwd_q_blocked": 0,
                            "bwd_dq_kv_blocked": 0, "bwd_dkv_kv_blocked": 0}


@pytest.mark.cuda
def test_attention_kernel_backward_is_reproducible(cuda_device):
    """No atomics: two backward calls give the same bits."""
    qkv, mask, cot = _attention_inputs(cuda_device, 2, 128)
    a = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)[0]
    b = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)[0]
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_attention_kernels_raise_on_bf16_and_long_sequences(cuda_device):
    qkv, mask, _ = _attention_inputs(cuda_device, 1, 64)
    with pytest.raises(ValueError, match="float32"):
        tfa.fused_qkv_attention(qkv.bfloat16(), mask, 12)
    q = torch.zeros(1, 2, 64, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_attention(q, q, q, mask)
    # past the single-tile kernels' shared-memory limit, which the error names
    for direction in ("fwd", "bwd"):
        s = tfa.single_tile_max_s(direction) + 64
        long_qkv = torch.zeros(1, s, 1152, device=cuda_device, requires_grad=direction == "bwd")
        with pytest.raises(NotImplementedError, match=f"limit of S <= {s - 64}"):
            out = tfa.fused_qkv_attention(long_qkv, torch.ones(1, s, device=cuda_device), 12)
            out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,gelu,s,error,match",
    [
        (torch.bfloat16, "exact", 64, ValueError, "float32"),
        (torch.float32, "tanh", 64, ValueError, "bfloat16"),
        (torch.bfloat16, "exact", 520, ValueError, "float32"),
        (torch.float32, "exact", 1700, NotImplementedError, "limit"),
    ],
)
def test_auto_route_raises_where_kernels_are_missing(cuda_device, dtype, gelu, s, error, match):
    """"auto" on the card takes the reference's TPU route; where the port
    lacks that route's kernels (the single-tile attention kernels in bf16
    or past their shared-memory limit, the fused blocks in f32) it raises
    instead of running plain PyTorch."""
    from dial_rag_tpu_torch.models.bert import BertConfig, bert_forward, init_params, prepare_params

    config = BertConfig(vocab_size=64, hidden_size=384, num_layers=1, num_heads=12,
                        intermediate_size=1536, max_position_embeddings=2048)
    params = prepare_params(init_params(config, torch.Generator().manual_seed(0)), cuda_device, dtype)
    ids = torch.ones(2, s, dtype=torch.long, device=cuda_device)
    mask = torch.ones(2, s, dtype=torch.int32, device=cuda_device)
    with pytest.raises(error, match=match):
        bert_forward(params, ids, mask, num_heads=12, compute_dtype=dtype, gelu=gelu)


@pytest.mark.cuda
def test_single_tile_kernels_at_their_limit(cuda_device):
    """Kernels 4 and 5 at the longest S their forward takes, kernel 8 at
    the longest its backward takes, against the plain versions."""
    fwd_s, bwd_s = tfa.single_tile_max_s("fwd"), tfa.single_tile_max_s("bwd")
    assert fwd_s >= bwd_s > 512
    qkv, mask, cot = _attention_inputs(cuda_device, 1, fwd_s)
    out = tfa.fused_qkv_attention(qkv, mask, 12)
    ref = tfa.fused_qkv_attention(qkv, mask, 12, plain=True)
    assert (out - ref).abs().max().item() <= 2e-5
    q, k, v = tfa._split_heads(qkv, 12)
    assert tfa.attention_route(fwd_s) == "single_tile"
    assert (tfa.flash_attention(q, k, v, mask) - tfa.flash_attention(q, k, v, mask, plain=True)).abs().max() <= 2e-5
    qkv, mask, cot = _attention_inputs(cuda_device, 1, bwd_s)
    got = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12), [qkv], cot)[0]
    want = _grads(lambda x: tfa.fused_qkv_attention(x, mask, 12, plain=True), [qkv], cot)[0]
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "route,b,s", [("q_blocked", 2, 768), ("q_blocked", 1, 4096), ("kv_blocked", 1, 4608), ("kv_blocked", 3, 8192)]
)
def test_long_attention_kernels_match_plain_on_card(cuda_device, dtype, atol, route, b, s):
    """Kernels 6 (query-blocked) and 7 (KV-blocked, with its log-sum-exp)
    against their plain versions, q, k and v read as strided views of a
    packed qkv, a ragged mask and a fully masked row."""
    qkv, mask, _ = _attention_inputs(cuda_device, b + 1, s)
    q, k, v = tfa._split_heads(qkv.to(dtype), 12)
    assert tfa.attention_route(s) == route
    tfa.reset_launches()
    out, lse = tfa._forward(q, k, v, mask)
    ref, ref_lse = tfa._forward(q, k, v, mask, plain=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= atol
    name = "attention_q_blocked" if route == "q_blocked" else "attention_kv_blocked_fwd"
    assert tfa.LAUNCHES[name] == 1
    if route == "kv_blocked":
        assert torch.isfinite(lse).all() and (lse - ref_lse).abs().max().item() <= 1e-5
    else:
        assert lse is None and ref_lse is None


def _long_grads(fn, q, k, v, cot):
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    (fn(*xs).float() * cot).sum().backward()
    return [x.grad for x in xs]


def _excess(a, w, rtol=1e-4):
    return ((a - w).abs() - rtol * w.abs()).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,b,s", [("q_blocked", 2, 1024), ("q_blocked", 2, 4352), ("kv_blocked", 2, 8192)])
def test_long_backward_kernels_match_plain_on_card(cuda_device, dtype, route, b, s):
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
    3e-2 of the plain gradient's largest magnitude."""
    qkv, mask, cot = _attention_inputs(cuda_device, b + 1, s)
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
def test_long_backward_is_reproducible(cuda_device):
    """No atomics: two blocked backward calls give the same bits."""
    qkv, mask, cot = _attention_inputs(cuda_device, 2, 1024)
    q, k, v = tfa._split_heads(qkv, 12)
    cot = cot.view(2, 1024, 12, -1).transpose(1, 2)
    a = _long_grads(lambda *x: tfa.flash_attention(*x, mask), q, k, v, cot)
    b = _long_grads(lambda *x: tfa.flash_attention(*x, mask), q, k, v, cot)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(3, 100), (2, 512), (1, 64)])
def test_layer_kernel_matches_plain_on_card(cuda_device, b, s):
    """Kernel 3 (the whole layer) against its plain version at bge-small
    widths, bf16: a ragged S, the longest S and a masked row."""
    hid, heads, inter = 384, 12, 1536
    g = torch.Generator().manual_seed(4)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to(cuda_device, dtype)

    x = rnd(b, s, hid, dtype=torch.bfloat16)
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[-1, 40:] = 0
    mask = mask.to(cuda_device)
    ones, zeros = torch.ones(hid, device=cuda_device), torch.zeros(hid, device=cuda_device)
    weights = (
        rnd(hid, 3 * hid, scale=0.05, dtype=torch.bfloat16), rnd(3 * hid, scale=0.02),
        rnd(hid, hid, scale=0.05, dtype=torch.bfloat16), rnd(hid, scale=0.02), ones, zeros,
        rnd(hid, inter, scale=0.05, dtype=torch.bfloat16), rnd(inter, scale=0.02),
        rnd(inter, hid, scale=0.05, dtype=torch.bfloat16), rnd(hid, scale=0.02), ones, zeros,
    )
    tfe.reset_launches()
    out = tfe.fused_layer_block(x, mask, weights, heads)
    ref = tfe.fused_layer_block_plain(x, mask, weights, heads)
    torch.cuda.synchronize()
    assert tfe.LAUNCHES["fused_layer_block"] == 1
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2


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
