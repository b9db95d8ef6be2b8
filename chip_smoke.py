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

The second-to-last line is a JSON object with the kernels' numbers, the
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the result is printed. Writes nothing but the kernels' build directory.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints" / "alps-semantic"
ORACLE_CHUNKS = ROOT / "tests" / "data" / "alps_oracle_chunks.json"
N_DOCS = 2048
N_QUERIES = 64
N_TOP1 = 16
TOLERANCE = 3e-2  # bf16 kernel vs plain version: tests/test_fused_encoder.py's bf16 atol
TIE_GAP = 1e-3  # top-1 may differ from the plain path only between rows this close
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def synthetic_texts(vocab: dict, n: int, seed: int) -> list[str]:
    """Texts of 200-253 whole vocab words, one WordPiece token each, so a
    batch of them fills the 256-token bucket."""
    import numpy as np

    words = sorted(w for w in vocab if w.isascii() and w.isalpha() and w.islower() and len(w) > 1)
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(rng.integers(200, 254)))) for _ in range(n)]


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
    print(f"peak memory (whole run): {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
