#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dial_rag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a ``[phase]`` line:

1. device: the card's name, CUDA version and ``nvidia-smi`` name/power limit;
2. build: ``nvcc`` builds the kernels in ``dial_rag_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at B=128,
   S=256, H=384 bf16 with the shipped checkpoint's layer-0 weights, and
   timed (CUDA events) beside its bound and a PyTorch composition;
4. main path: ``BgeEmbedder`` (bf16, ``checkpoints/alps-semantic``) embeds
   2048 chunks into a ``SemanticRetriever`` and answers queries; a seeded
   1M x 384 f32 ``DenseIndex`` answers ``find_batch``. The kernels' launch
   counts must equal 12 x the encode batches; top-1 hits must agree with
   the same path through the plain versions; embeddings must agree with
   the f32 path on a few chunks.

5. attention kernels: the f32 attention forward (packed qkv and
   head-major, one strided CUDA kernel) and its recompute-P backward
   against their plain versions at bge-small widths (12 heads of 32),
   ragged S and a fully masked row, at fixed shapes and at every (B, S)
   the training and f32 serve phases give them; timed beside their
   bound, the plain version and ``F.scaled_dot_product_attention`` (f32,
   additive mask);
6. training: ``train()`` fine-tunes ``checkpoints/alps-semantic`` in f32
   at full width and depth for 20 steps of 32 (question, fact) pairs from
   ``eval/data/alps_handmade_questions.json``, no batch holding one fact
   twice (``positive_disjoint_stream``). Step 1 must match the
   plain route (loss rel 1e-5, gradient cosine > 0.9999); the losses must
   be finite and fall; the attention counters must read 12 layers x 2
   encodes x 20 steps; a restore from the step-10 checkpoint must be
   bit-exact and steps 11-20 must come out again (losses rel 1e-6).
   Checkpoints go to a temporary directory outside the checkout;
7. f32 serve: the trained params in an f32 ``BgeEmbedder`` embed the 155
   facts into a ``SemanticRetriever`` and answer the 155 questions; the
   forward counter must equal 12 x the encode batches and top-1 must
   agree with the plain route.

The second-to-last line is a JSON object with the kernels' numbers, the
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the result is printed. Writes nothing in the checkout but the kernels'
build directory.
"""

import copy
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints" / "alps-semantic"
ORACLE_CHUNKS = ROOT / "tests" / "data" / "alps_oracle_chunks.json"
QUESTIONS = ROOT / "eval" / "data" / "alps_handmade_questions.json"
N_DOCS = 2048
N_QUERIES = 64
N_TOP1 = 16
TOLERANCE = 3e-2  # bf16 kernel vs plain version: tests/test_fused_encoder.py's bf16 atol
TIE_GAP = 1e-3  # top-1 may differ from the plain path only between rows this close
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12  # H100 SXM f32, CUDA cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# f32 attention kernels vs plain versions: forward 2e-5, ten times the
# reference's 2e-6 (tests/test_flash_attention.py) for another summation
# order over S <= 512 keys; gradients the reference's own atol and rtol
F32_FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4


def phase(name: str) -> None:
    print(f"[phase] {name}", flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def synthetic_texts(vocab: dict, n: int, seed: int) -> list[str]:
    """Texts of 200-253 whole vocab words, one WordPiece token each, so a
    batch of them fills the 256-token bucket."""
    import numpy as np

    words = sorted(w for w in vocab if w.isascii() and w.isalpha() and w.islower() and len(w) > 1)
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(rng.integers(200, 254)))) for _ in range(n)]


def attention_inputs(torch, dev, b, s, heads, dh, seed):
    """Seeded packed qkv [B, S, 3H] f32, a mask with ragged rows and one
    fully masked row, and a cotangent [B, S, H]."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * heads * dh, generator=g).to(dev)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0] = s
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
    mask[-1] = 0
    cot = torch.randn(b, s, heads * dh, generator=g).to(dev)
    return qkv, mask.to(dev), cot


def attention_rows(torch, dev, card, heads: int, dh: int, path_shapes) -> dict:
    """Kernels 4, 5 and 8 against their plain versions (gated) at fixed
    shapes and at ``path_shapes``, the (use, B, S) the training and f32
    serve phases give them; timed beside their bound, the plain version
    and SDPA."""
    import torch.nn.functional as F

    from dial_rag_tpu_torch.ops import flash_attention as fa

    def grads(fn, inputs, cot):
        inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
        (fn(*inputs) * cot).sum().backward()
        return [t.grad for t in inputs]

    def check_fwd(name, out, ref):
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{name}: kernel output is not finite")
        err = (out - ref).abs().max().item()
        if not err <= F32_FWD_TOL:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version by {err}")
        return err

    def check_grads(name, got, want):
        torch.cuda.synchronize()
        err = 0.0
        for a, w in zip(got, want):
            excess = ((a - w).abs() - GRAD_RTOL * w.abs()).max().item()
            if not (torch.isfinite(a).all() and excess <= GRAD_ATOL):
                raise RuntimeError(f"{name}: gradient off its plain version by {excess} past rtol")
            err = max(err, (a - w).abs().max().item())
        return err

    # every shape gated: a full f32 serving bucket (B=128, S=256), a full
    # training bucket (B=32, S=128), a ragged S, the longest S, and each
    # shape the main path's phases below give the kernels
    fixed = [("bucket", 128, 256), ("bucket", 32, 128), ("ragged", 32, 100), ("longest", 4, 512)]
    for use, b, s in fixed + [t for t in path_shapes if t[1:] not in {f[1:] for f in fixed}]:
        qkv, mask, cot = attention_inputs(torch, dev, b, s, heads, dh, seed=b + s)
        with torch.no_grad():
            e4 = check_fwd("qkv_native_attention", fa.fused_qkv_attention(qkv, mask, heads),
                           fa.fused_qkv_attention(qkv, mask, heads, plain=True))
            q, k, v = (t.contiguous() for t in fa._split_heads(qkv, heads))
            e5 = check_fwd("flash_attention_fwd", fa.flash_attention(q, k, v, mask),
                           fa.flash_attention(q, k, v, mask, plain=True))
        e8p = check_grads(
            "flash_attention_bwd (packed qkv)",
            grads(lambda x: fa.fused_qkv_attention(x, mask, heads), [qkv], cot),
            grads(lambda x: fa.fused_qkv_attention(x, mask, heads, plain=True), [qkv], cot),
        )
        cot_h = cot.view(b, s, heads, dh).transpose(1, 2).contiguous()
        e8h = check_grads(
            "flash_attention_bwd (head-major)",
            grads(lambda *x: fa.flash_attention(*x, mask), [q, k, v], cot_h),
            grads(lambda *x: fa.flash_attention(*x, mask, plain=True), [q, k, v], cot_h),
        )
        print(f"attention kernels at B={b} S={s} ({use}; ragged rows, one fully masked): max abs err "
              f"qkv_native {e4:.3g}, head-major {e5:.3g} (tolerance {F32_FWD_TOL}); backward "
              f"packed {e8p:.3g}, head-major {e8h:.3g} (atol {GRAD_ATOL}, rtol {GRAD_RTOL})", flush=True)

    f32 = 4
    rows = {}

    def row(name, kernel, plain, library, err, flops, nbytes, replaces, source, shape):
        ms = cuda_ms(torch, kernel, iters=20)
        plain_ms = cuda_ms(torch, plain, iters=5)
        library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS)
        print(f"{name}: max_abs_err {err:.6g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA f32 "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), {shape} f32 {card}", flush=True)
        rows[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }

    # kernel 4 at the f32 serving shape
    b, s = 128, 256
    hid = heads * dh
    qkv, mask, cot = attention_inputs(torch, dev, b, s, heads, dh, seed=1)
    keep = fa.mask_bias(mask)[:, None, None, :]
    with torch.no_grad():
        err = check_fwd("qkv_native_attention", fa.fused_qkv_attention(qkv, mask, heads),
                        fa.fused_qkv_attention(qkv, mask, heads, plain=True))

        def sdpa_packed():
            q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep).transpose(1, 2).reshape(b, s, hid)

        row("qkv_native_attention", lambda: fa.fused_qkv_attention(qkv, mask, heads),
            lambda: fa.fused_qkv_attention(qkv, mask, heads, plain=True), sdpa_packed, err,
            4 * b * heads * s * s * dh, (b * s * 3 * hid + b * s * hid + b * s) * f32,
            "dial_rag_tpu/ops/flash_attention.py:638", "dial_rag_tpu_torch/csrc/flash_attention_fwd.cu",
            f"qkv [{b},{s},{3 * hid}]")

    # kernels 5 and 8 at the training shape, head-major
    b, s = 32, 128
    qkv, mask, cot = attention_inputs(torch, dev, b, s, heads, dh, seed=2)
    q, k, v = (t.contiguous() for t in fa._split_heads(qkv, heads))
    do = cot.view(b, s, heads, dh).transpose(1, 2).contiguous()
    keep = fa.mask_bias(mask)[:, None, None, :]
    head_bytes = b * heads * s * dh * f32
    with torch.no_grad():
        err = check_fwd("flash_attention_fwd", fa.flash_attention(q, k, v, mask),
                        fa.flash_attention(q, k, v, mask, plain=True))
        row("flash_attention_fwd", lambda: fa.flash_attention(q, k, v, mask),
            lambda: fa.flash_attention(q, k, v, mask, plain=True),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), err,
            4 * b * heads * s * s * dh, 4 * head_bytes + b * s * f32,
            "dial_rag_tpu/ops/flash_attention.py:43", "dial_rag_tpu_torch/csrc/flash_attention_fwd.cu",
            f"q, k, v [{b},{heads},{s},{dh}]")
    grad_out = [torch.empty_like(t) for t in (q, k, v)]
    got = fa.attention_backward_plain(q, k, v, do, mask)
    fa._backward_kernel(q, k, v, do, *grad_out, mask)
    err = check_grads("flash_attention_bwd", grad_out, got)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():
        for t in leaves:
            t.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=keep).backward(do)

    row("flash_attention_bwd", lambda: fa._backward_kernel(q, k, v, do, *grad_out, mask),
        lambda: fa.attention_backward_plain(q, k, v, do, mask), sdpa_fwd_bwd, err,
        10 * b * heads * s * s * dh, 7 * head_bytes + b * s * f32,
        "dial_rag_tpu/ops/flash_attention.py:313", "dial_rag_tpu_torch/csrc/flash_attention_bwd.cu",
        f"q, k, v, dO [{b},{heads},{s},{dh}]")
    return rows


def alps_questions() -> tuple[list[str], list[str]]:
    """The 155 hand-written questions and the first fact of each."""
    questions = json.loads(QUESTIONS.read_text())["questions"]
    return [q["facts"][0] for q in questions], [q["question"] for q in questions]


def training_setup(base):
    """The fine-tuning run's config and its stream of (question, first
    fact) pairs, no batch holding one fact twice."""
    from dial_rag_tpu_torch.training.data import positive_disjoint_stream
    from dial_rag_tpu_torch.training.loop import TrainConfig

    cfg = TrainConfig(batch_size=32, seq_len=128, learning_rate=2e-5, warmup_steps=2, total_steps=20,
                      checkpoint_every=10)
    facts, questions = alps_questions()
    pairs = [(base.query_instruction + q, f) for q, f in zip(questions, facts)]
    return cfg, positive_disjoint_stream(pairs, cfg.batch_size, cfg.total_steps, seed=0)


def main_path_shapes(base, cfg, stream) -> list[tuple[str, int, int]]:
    """(use, B, S) of every attention call of the training and f32 serve
    phases: each training batch (q and p padded to one S), and each encode
    of the serve (the facts in ``batch_size`` rows, the questions in one
    encode), padded as ``BgeEmbedder`` pads them."""
    from dial_rag_tpu_torch.embeddings.embedder import _bucket_rows
    from dial_rag_tpu_torch.training.loop import pairs_to_batches

    shapes = {("training", *batch["q_ids"].shape) for batch in pairs_to_batches(base.tokenizer, stream, cfg)}
    facts, questions = alps_questions()
    n = base.batch_size
    for i in range(0, len(facts), n):
        ids, _ = base.tokenizer.encode_batch(facts[i : i + n], max_len=base.max_len)
        shapes.add(("f32 serve", n if len(facts) > n else _bucket_rows(len(facts), n), ids.shape[1]))
    ids, _ = base.tokenizer.encode_batch([base.query_instruction + q for q in questions], max_len=base.max_len)
    shapes.add(("f32 serve", _bucket_rows(len(questions), n), ids.shape[1]))
    return sorted(shapes)


def training_phase(torch, card, base, num_layers: int, cfg, stream):
    """Fine-tunes ``base``'s f32 params with ``train()`` on ``stream``;
    returns the trained params and the attention counters of the 20-step
    run."""
    import numpy as np

    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss, create_train_state, make_train_step
    from dial_rag_tpu_torch.training.loop import (
        Checkpointer, make_optimizer, pairs_to_batches, train, trainable_params,
    )
    from dial_rag_tpu_torch.weights import param_leaves

    model, dev = base.encoder.config, base.device
    init = {"embeddings": base.params["embeddings"], "layers": base.params["layers"]}
    first = next(pairs_to_batches(base.tokenizer, stream, cfg))
    s = first["q_ids"].shape[1]
    print(f"training: {len(stream)} (question, fact) pairs, batch {cfg.batch_size}, S={s}, "
          f"{cfg.total_steps} steps, lr {cfg.learning_rate}, warmup {cfg.warmup_steps}", flush=True)

    # step 1 through the kernels and through the plain route
    def loss_and_grads(impl):
        params = trainable_params(init, dev)
        loss = contrastive_loss(params, first, num_heads=model.num_heads, temperature=cfg.temperature,
                                attention_impl=impl)
        loss.backward()
        return loss.item(), [t.grad for t in param_leaves(params)]

    loss_k, grads_k = loss_and_grads("pallas")
    loss_p, grads_p = loss_and_grads("pallas_plain")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos_min, zero = 1.0, 0
    for gk, gp in zip(grads_k, grads_p):
        if not gp.abs().max() > 0:
            zero += 1
            continue
        cos = torch.nn.functional.cosine_similarity(gk.flatten().double(), gp.flatten().double(), dim=0).item()
        cos_min = min(cos_min, cos)
    print(f"step 1, kernels vs plain route: loss {loss_k:.8f} vs {loss_p:.8f} (rel {rel:.3g}, limit 1e-5); "
          f"gradient cosine min {cos_min:.8f} over {len(grads_p) - zero} tensors (limit 0.9999; "
          f"{zero} all-zero in the plain route)", flush=True)
    if not (rel <= 1e-5 and cos_min > 0.9999):
        raise RuntimeError("step 1 through the kernels disagrees with the plain route")
    del grads_k, grads_p

    # where one step spends the card's time (profiler, one step)
    params = trainable_params(init, dev)
    state = create_train_state(params, *make_optimizer(cfg, params))
    step_fn = make_train_step(model, temperature=cfg.temperature)
    step_fn(state, first)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(state, first)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    print(f"profile of one train step (B={cfg.batch_size}, S={s}): device time {total_us / 1e3:.3f} ms {card}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d} x  {e.key[:90]}")
    del state, params, step_fn

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        run_dir, resume_dir = Path(tmp) / "run", Path(tmp) / "resume"
        times, snapshot = [], {}
        last = [0.0]

        def on_step(state, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append(now - last[0])
            last[0] = now
            if state.step == 10:
                snapshot["params"] = host_copy(param_leaves(state.params))
                snapshot["optimizer"] = host_copy(state.optimizer.state_dict())
                snapshot["scheduler"] = host_copy(state.scheduler.state_dict())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**20
        fa.reset_launches()
        last[0] = time.perf_counter()
        trained, losses = train(model, cfg, stream, base.tokenizer, checkpoint_dir=str(run_dir), init=init,
                                device=dev, on_step=on_step)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        for i, (loss, dt) in enumerate(zip(losses, times), start=1):
            print(f"  step {i:2d}: loss {loss:.6f}, {dt * 1e3:.2f} ms, {cfg.batch_size / dt:.1f} pairs/s")
        steady = sorted(times[1:])[len(times[1:]) // 2]
        print(f"training: median step {steady * 1e3:.2f} ms, {cfg.batch_size / steady:.1f} pairs/s "
              f"(steps 2-{cfg.total_steps}, host clock ending in synchronize, checkpoint saves included); "
              f"peak memory {peak:.1f} MiB, of which {held:.1f} MiB held before the run {card}")
        expected = num_layers * 2 * cfg.total_steps
        print(f"training launches {launches}; expected {expected} forward and backward "
              f"({num_layers} layers x 2 encodes x {cfg.total_steps} steps)", flush=True)
        if not all(np.isfinite(losses)) or len(losses) != cfg.total_steps:
            raise RuntimeError(f"training losses: {losses}")
        if not np.mean(losses[-4:]) < np.mean(losses[:4]):
            raise RuntimeError(f"training did not reduce the loss: {losses}")
        if launches["qkv_native_attention"] != expected or launches["flash_attention_bwd"] != expected:
            raise RuntimeError("the training path bypassed the attention kernels")

        # restore from the step-10 checkpoint: bit-exact, then resume 11-20
        if Checkpointer(str(run_dir)).steps() != [10, 20]:
            raise RuntimeError(f"checkpoints: {Checkpointer(str(run_dir)).steps()}")
        resume_dir.mkdir()
        step10 = Checkpointer(str(run_dir)).path(10)
        shutil.copy(step10, resume_dir / step10.name)
        params = trainable_params(init, dev)
        state = create_train_state(params, *make_optimizer(cfg, params))
        if Checkpointer(str(resume_dir)).restore(state) != 10:
            raise RuntimeError("no step-10 checkpoint to restore")
        exact = all(torch.equal(a.cpu(), b) for a, b in zip(param_leaves(state.params), snapshot["params"]))
        opt_now, opt_then = state.optimizer.state_dict(), snapshot["optimizer"]
        for i, st in opt_then["state"].items():
            exact &= all(torch.equal(st[key], opt_now["state"][i][key].cpu()) for key in st)
        exact &= opt_now["param_groups"] == opt_then["param_groups"]
        exact &= state.scheduler.state_dict() == snapshot["scheduler"]
        if not exact:
            raise RuntimeError("the step-10 checkpoint does not restore params and optimizer state exactly")
        del state, params
        fa.reset_launches()
        _, resumed = train(model, cfg, stream, base.tokenizer, checkpoint_dir=str(resume_dir), init=init,
                           device=dev)
        resume_launches = dict(fa.LAUNCHES)
        worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[10:]))
        print(f"restore of step 10: params, optimizer and scheduler state bit-exact; resumed steps 11-20 "
              f"losses within rel {worst:.3g} of the first run (limit 1e-6); launches {resume_launches}")
        if len(resumed) != 10 or not worst <= 1e-6:
            raise RuntimeError(f"resume did not reproduce steps 11-20: {resumed} vs {losses[10:]}")
        if resume_launches["qkv_native_attention"] != expected // 2:
            raise RuntimeError(f"resume launches {resume_launches}")
    return trained, launches


def host_copy(obj):
    """A copy of a (nested) state dict with every tensor on the host, so a
    snapshot takes no device memory."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [host_copy(v) for v in obj]
    return copy.deepcopy(obj)


def recall_at_1(embedder, facts, questions) -> float:
    import numpy as np

    d = embedder.embed_documents(facts)
    q = embedder.embed_queries(questions)
    dist = (q**2).sum(1)[:, None] - 2 * q @ d.T + (d**2).sum(1)[None, :]
    return float(np.mean(np.argmin(dist, axis=1) == np.arange(len(questions))))


def f32_serve_phase(torch, card, base, trained) -> int:
    """The trained params served in f32: returns the forward counter."""
    import numpy as np

    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.models.bert import BertEncoder
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    facts, queries = alps_questions()
    cfg = base.encoder.config
    params = dict(trained)
    if "pooling_idf" in base.params:
        params["pooling_idf"] = base.params["pooling_idf"]

    def embedder(impl):
        return BgeEmbedder(
            tokenizer=base.tokenizer,
            encoder=BertEncoder(cfg, compute_dtype=torch.float32, attention_impl=impl,
                                pooling=base.encoder.pooling),
            params=params, device=base.device, query_instruction=base.query_instruction, model_id="trained",
        )

    serve, plain = embedder("auto"), embedder("pallas_plain")
    serve.embed_documents(facts[:8])  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    record = type("Record", (), {"embeddings_index": SemanticRetriever.build_index(
        serve, build_chunks_list([(f, {}) for f in facts]))})()
    retriever = SemanticRetriever.from_doc_records(serve, [record], k=1)
    hits = retriever.retrieve_batch(queries)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fa.LAUNCHES["qkv_native_attention"]
    # the facts in bulk batches, the questions in one encode
    n_batches = -(-len(facts) // serve.batch_size) + 1
    print(f"f32 serve: {len(facts)} facts indexed and {len(queries)} questions answered in {elapsed:.3f} s; "
          f"launches {dict(fa.LAUNCHES)}; encode batches {n_batches} {card}")
    if launches != cfg.num_layers * n_batches:
        raise RuntimeError(f"f32 serve launched the attention kernel {launches} times, expected "
                           f"{cfg.num_layers * n_batches}: the path bypassed it")
    doc_emb = np.concatenate(record.embeddings_index)
    if doc_emb.shape != (len(facts), cfg.hidden_size) or not np.isfinite(doc_emb).all():
        raise RuntimeError(f"bad f32 fact embeddings: shape {doc_emb.shape}")
    q_kernel = serve.embed_queries(queries)
    d_plain, q_plain = plain.embed_documents(facts), plain.embed_queries(queries)
    print(f"f32 serve, kernel route vs plain route: max abs diff documents "
          f"{np.abs(doc_emb - d_plain).max():.3g}, queries {np.abs(q_kernel - q_plain).max():.3g}")
    plain_top = np.argmin(((q_plain[:, None, :] - d_plain[None, :, :]) ** 2).sum(-1), axis=1)
    ties = 0
    for qi, h in enumerate(hits):
        ck, cp = h[0].chunk_id, int(plain_top[qi])
        if ck == cp:
            continue
        d = ((doc_emb[[ck, cp]] - q_kernel[qi]) ** 2).sum(axis=1)
        gap = abs(float(d[0] - d[1]))
        print(f"top-1 near-tie, question {qi}: kernel fact {ck} vs plain fact {cp}, distance gap {gap:.3g}")
        if gap >= TIE_GAP:
            raise RuntimeError(f"f32 serve top-1 of question {qi} differs from the plain route by {gap}")
        ties += 1
    recall = float(np.mean([h[0].chunk_id == i for i, h in enumerate(hits)]))
    print(f"f32 serve top-1 of {len(queries)} questions: kernel route = plain route ({ties} near-ties "
          f"below {TIE_GAP}); recall@1 before training {recall_at_1(base, facts, queries):.4f}, after "
          f"{recall:.4f} (not gated)", flush=True)
    return launches


def main() -> int:
    phase("device")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "dial_rag_tpu_torch").is_dir() or not CHECKPOINT.is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from dial_rag_tpu_torch.index.dense_index import DenseIndex
    from dial_rag_tpu_torch.index.records import RetrievalType
    from dial_rag_tpu_torch.models.bert import BertEncoder, embed_tokens
    from dial_rag_tpu_torch.ops import fused_encoder as fe
    from dial_rag_tpu_torch.ops._build import build_kernels
    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    dev = torch.device("cuda")

    phase("build")
    build = build_kernels()
    print(f"build: {build.seconds:.2f} s (nvcc, all sources in parallel)"
          if build.seconds else "build: found built for these sources in dial_rag_tpu_torch/_build")
    for stem, lines in build.ptxas.items():
        for line in lines:
            print(f"ptxas {stem}: {line}")
    sys.stdout.flush()

    phase("kernels")
    embedder = BgeEmbedder.from_hf_checkpoint(str(CHECKPOINT), compute_dtype=torch.bfloat16, device="cuda")
    cfg = embedder.encoder.config
    oracle = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
    texts = oracle + synthetic_texts(embedder.tokenizer.vocab, N_DOCS - len(oracle), seed=0)
    b, s, hid, inter, heads = 128, 256, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads
    ids, mask = embedder.tokenizer.encode_batch(texts[len(oracle) : len(oracle) + b])
    assert ids.shape == (b, s), ids.shape
    ids_t = torch.from_numpy(ids).to(dev, dtype=torch.long)
    mask_t = torch.from_numpy(mask).to(dev)
    layer = embedder.params["layers"][0]
    x = embed_tokens(embedder.params, ids_t, torch.bfloat16)
    attn_args = (
        x, mask_t, layer["qkv"]["kernel"], layer["qkv"]["bias"], layer["attn_out"]["kernel"],
        layer["attn_out"]["bias"], layer["attn_ln"]["scale"], layer["attn_ln"]["bias"], heads,
    )
    a = fe.fused_attention_block_plain(*attn_args)
    ffn_args = (
        a, layer["ffn_in"]["kernel"], layer["ffn_in"]["bias"], layer["ffn_out"]["kernel"],
        layer["ffn_out"]["bias"], layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"],
    )
    m = b * s
    f32, bf16 = 4, 2
    vec_bytes = (3 * hid + 3 * hid) * f32  # bqkv + bout, gamma, beta
    attn_flops = 2 * m * hid * 3 * hid + 2 * 2 * b * heads * s * s * (hid // heads) + 2 * m * hid * hid
    attn_bytes = 2 * m * hid * bf16 + m * f32 + (hid * 3 * hid + hid * hid) * bf16 + vec_bytes
    ffn_flops = 2 * 2 * m * hid * inter
    ffn_bytes = 2 * m * hid * bf16 + 2 * hid * inter * bf16 + (inter + 3 * hid) * f32

    # PyTorch compositions of the same blocks (cuBLAS products, SDPA): a
    # yardstick for the kernels, used nowhere in the port
    lib_bias = {k: layer[k]["bias"].bfloat16() for k in ("qkv", "attn_out", "ffn_in", "ffn_out")}
    keep = mask_t.bool()[:, None, None, :]

    def attn_library():
        xx = attn_args[0].view(m, hid)
        qkv = torch.addmm(lib_bias["qkv"], xx, layer["qkv"]["kernel"])
        q, k, v = qkv.view(b, s, 3, heads, hid // heads).permute(2, 0, 3, 1, 4)
        ctx = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        o = torch.addmm(lib_bias["attn_out"], ctx.transpose(1, 2).reshape(m, hid), layer["attn_out"]["kernel"])
        return torch.nn.functional.layer_norm(
            (xx + o).float(), (hid,), layer["attn_ln"]["scale"], layer["attn_ln"]["bias"], 1e-12
        ).bfloat16()

    def ffn_library():
        xx = ffn_args[0].view(m, hid)
        h = torch.addmm(lib_bias["ffn_in"], xx, layer["ffn_in"]["kernel"])
        h = torch.nn.functional.gelu(h, approximate="tanh")
        y = torch.addmm(lib_bias["ffn_out"], h, layer["ffn_out"]["kernel"])
        return torch.nn.functional.layer_norm(
            (xx + y).float(), (hid,), layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"], 1e-12
        ).bfloat16()

    rows = {}
    for name, kernel, plain, args, library, flops, nbytes, source, replaces in (
        ("fused_attention_block", fe.fused_attention_block, fe.fused_attention_block_plain, attn_args,
         attn_library, attn_flops, attn_bytes, "dial_rag_tpu_torch/csrc/fused_attention.cu",
         "dial_rag_tpu/ops/fused_encoder.py:177"),
        ("fused_ffn_block", fe.fused_ffn_block, fe.fused_ffn_block_plain, ffn_args,
         ffn_library, ffn_flops, ffn_bytes, "dial_rag_tpu_torch/csrc/fused_ffn.cu",
         "dial_rag_tpu/ops/fused_encoder.py:76"),
    ):
        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"{name}: kernel output is not finite")
        err = (out.float() - ref.float()).abs().max().item()
        lib_err = (library().float().view_as(ref) - ref.float()).abs().max().item()
        ms = cuda_ms(torch, lambda: kernel(*args), iters=20)
        plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5)
        library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"{name}: max_abs_err {err:.6g} (tolerance {TOLERANCE}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, composition {library_ms:.4f} ms (its err {lib_err:.3g}), "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
              f"B={b} S={s} H={hid} {card}", flush=True)
        if not err <= TOLERANCE:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version by {err}")
        rows[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }
    del x, a, attn_args, ffn_args

    phase("main path")
    # host tokenization of the same texts, timed apart: the build's host share
    t0 = time.perf_counter()
    tokens = sum(len(embedder.tokenizer.encode(t, embedder.max_len)) for t in texts)
    t_tok = time.perf_counter() - t0
    chunks = build_chunks_list([(t, {"source": "oracle" if i < len(oracle) else "synthetic"})
                                for i, t in enumerate(texts)])
    rng = np.random.default_rng(1)
    queries = []
    for i in rng.choice(len(texts), size=N_QUERIES, replace=False):
        words = texts[i].split()
        j = int(rng.integers(0, max(1, len(words) - 8)))
        queries.append(" ".join(words[j : j + 8]))
    embedder.embed_documents(texts[: embedder.batch_size])  # warm-up: first use of each op
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launches()
    t0 = time.perf_counter()
    record = type("Record", (), {"embeddings_index": SemanticRetriever.build_index(embedder, chunks)})()
    retriever = SemanticRetriever.from_doc_records(embedder, [record], k=1)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    retriever.retrieve_batch(queries)  # warm-up at the query shapes
    t0 = time.perf_counter()
    hits = retriever.retrieve_batch(queries)
    t_batch = time.perf_counter() - t0
    single_ms = []
    for q in queries[:5]:
        t0 = time.perf_counter()
        retriever.retrieve(q)
        single_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = dict(fe.LAUNCHES)
    n_batches = -(-N_DOCS // embedder.batch_size) + 2 * -(-N_QUERIES // embedder.batch_size) + 5
    print(f"launches {launches}; encode batches {n_batches}; layers {cfg.num_layers}")
    for name in rows:
        rows[name]["launches"] = launches[name]
        if launches[name] != cfg.num_layers * n_batches:
            raise RuntimeError(f"{name} launched {launches[name]} times, expected "
                               f"{cfg.num_layers * n_batches}: the main path bypassed it")
    doc_emb = np.concatenate(record.embeddings_index)
    if doc_emb.shape != (N_DOCS, hid) or not np.isfinite(doc_emb).all():
        raise RuntimeError(f"bad document embeddings: shape {doc_emb.shape}")
    norms = np.linalg.norm(doc_emb, axis=1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise RuntimeError(f"embeddings are not unit norm: {norms.min()}..{norms.max()}")
    if any(len(h) != 1 for h in hits):
        raise RuntimeError("a query returned no hit")
    print(f"index build: {N_DOCS} chunks, {tokens} tokens in {t_build:.3f} s: "
          f"{N_DOCS / t_build:.1f} chunks/s, {tokens / t_build:.0f} tokens/s; host tokenization of "
          f"the same texts alone {t_tok:.3f} s {card}")
    print(f"query: {N_QUERIES} queries in one batch {t_batch * 1e3:.2f} ms; single query median "
          f"{sorted(single_ms)[2]:.2f} ms {card}")
    print(f"peak memory (index build + queries): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}",
          flush=True)

    # the same path through the plain versions, on the card
    plain_embedder = BgeEmbedder(
        tokenizer=embedder.tokenizer,
        encoder=BertEncoder(cfg, compute_dtype=torch.bfloat16, attention_impl="fused_plain",
                            pooling=embedder.encoder.pooling),
        params=embedder.params, device="cuda", query_instruction=embedder.query_instruction,
        model_id=embedder.model_id,
    )
    plain_doc = plain_embedder.embed_documents(texts)
    print(f"document embeddings, kernel path vs plain path: max abs diff "
          f"{np.abs(doc_emb - plain_doc).max():.3g}")
    q_kernel = embedder.embed_queries(queries[:N_TOP1])
    q_plain = plain_embedder.embed_queries(queries[:N_TOP1])
    kernel_top = retriever.index.find_batch(q_kernel)
    plain_index = SemanticRetriever.from_doc_records(
        plain_embedder, [type("R", (), {"embeddings_index": [e[None] for e in plain_doc]})()], k=1
    ).index
    plain_top = plain_index.find_batch(q_plain)
    ties = 0
    for qi in range(N_TOP1):
        ck, cp = kernel_top[qi][0].chunk_id, plain_top[qi][0].chunk_id
        if ck == cp:
            continue
        d = ((doc_emb[[ck, cp]] - q_kernel[qi]) ** 2).sum(axis=1)
        gap = abs(float(d[0] - d[1]))
        print(f"top-1 near-tie, query {qi}: kernel chunk {ck} vs plain chunk {cp}, distance gap {gap:.3g}")
        if gap >= TIE_GAP:
            raise RuntimeError(f"top-1 of query {qi} differs from the plain path by {gap}")
        ties += 1
    print(f"top-1 of {N_TOP1} queries: kernel path = plain path ({ties} near-ties below {TIE_GAP})")

    # f32 reference on a few real chunks: the path the CPU tests pin to JAX
    f32_embedder = BgeEmbedder.from_hf_checkpoint(str(CHECKPOINT), compute_dtype=torch.float32, device="cuda")
    ref = f32_embedder.embed_documents(oracle[:8])
    cos = (ref * doc_emb[:8]).sum(axis=1)
    print(f"bf16 kernel path vs f32 path on 8 chunks: cosine min {cos.min():.5f}")
    if not cos.min() > 0.99:
        raise RuntimeError(f"bf16 kernel path disagrees with the f32 path: cosine {cos.min()}")
    del f32_embedder, plain_embedder, plain_index

    # where one encode batch spends the card's time (profiler, one batch)
    ids_b, mask_b = embedder.tokenizer.encode_batch(texts[len(oracle) : len(oracle) + b])
    ids_b = torch.from_numpy(ids_b).to(dev, dtype=torch.long)
    mask_b = torch.from_numpy(mask_b).to(dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        embedder.encoder.encode(embedder.params, ids_b, mask_b)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    print(f"profile of one encode batch (B={b}, S={s}): device time {total_us / 1e3:.3f} ms {card}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d} x  {e.key[:90]}")

    # seeded 1M x 384 f32 dense index on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn((1_000_000, hid), generator=gen, device=dev)
    mat /= mat.norm(dim=1, keepdim=True)
    big = DenseIndex.from_device_matrix(RetrievalType.TEXT, mat, limit=5)
    qs = torch.from_numpy(embedder.embed_queries(queries))
    big_hits = big.find_batch(qs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_hits = big.find_batch(qs)
    t_big = time.perf_counter() - t0
    t0 = time.perf_counter()
    big.find(qs[0])
    t_big1 = time.perf_counter() - t0
    qd = qs[:4].to(dev, torch.float64)
    d64 = (mat.double() ** 2).sum(1)[None, :] - 2 * qd @ mat.double().T + (qd**2).sum(1)[:, None]
    top2 = torch.topk(d64, 2, largest=False)
    for qi in range(4):
        best, second = top2.indices[qi].tolist(), top2.values[qi].tolist()
        if big_hits[qi][0].chunk_id != best[0] and second[1] - second[0] >= 1e-5:
            raise RuntimeError(f"1M index top-1 of query {qi} is {big_hits[qi][0].chunk_id}, f64 says {best[0]}")
    print(f"dense index 1M x {hid} f32 ({big.nbytes / 1e9:.2f} GB): find_batch of {N_QUERIES} "
          f"{t_big * 1e3:.2f} ms, find {t_big1 * 1e3:.2f} ms; top-1 = f64 scan on 4 queries {card}")
    print(f"peak memory (bf16 main path and 1M index): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"{card}")
    del big, mat, d64, qd, embedder, retriever

    phase("attention kernels")
    base = BgeEmbedder.from_hf_checkpoint(str(CHECKPOINT), compute_dtype=torch.float32, device="cuda")
    train_cfg, stream = training_setup(base)
    path_shapes = main_path_shapes(base, train_cfg, stream)
    print(f"attention shapes of the training and f32 serve phases (use, B, S): {path_shapes}", flush=True)
    rows.update(attention_rows(torch, dev, card, cfg.num_heads, hid // cfg.num_heads, path_shapes))

    phase("training")
    trained, train_launches = training_phase(torch, card, base, cfg.num_layers, train_cfg, stream)
    for name in ("qkv_native_attention", "flash_attention_fwd", "flash_attention_bwd"):
        rows[name]["launches"] = train_launches[name]

    phase("f32 serve")
    serve_launches = f32_serve_phase(torch, card, base, trained)
    print(f"qkv_native_attention launches: training {train_launches['qkv_native_attention']}, "
          f"f32 serve {serve_launches}; flash_attention_fwd (the head-major wrapper of the same CUDA "
          f"kernel) is off both paths at S <= 512", flush=True)

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
