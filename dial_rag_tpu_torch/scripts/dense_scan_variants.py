#!/usr/bin/env python3
"""Times the dense index's blocked scans on one NVIDIA GPU against variants
of their per-block stable top-k, their block size and the int8 product's
orientation.

    python3 dial_rag_tpu_torch/scripts/dense_scan_variants.py

Builds chip_smoke.py's seeded 1M x 384 matrix as float32, bfloat16 and int8
``DenseIndex``es and times ``find_batch`` of 64 queries and ``find`` of one
(host clock to a synchronise, the median of 5; and the profiler's device
time), the per-block top-k as built (``stable_topk_rows``: one
``torch.topk`` over int64 (value, row) keys), as a topk over groups of 128
keys and then over their winners, as a stable sort of the values and as k
argmin sweeps, at the built block budget and at 4x it (with the scan's
memory beyond the index); then
``torch._int_mm`` at one int8 scan block's shapes with the rows first
([R, D] x [D, Q]) and with the queries first ([Q, D] x [D, R], Q padded to
32). Every variant returns the built scan's hits, which it checks. Prints
the card's name and power limit.
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from dial_rag_tpu_torch.index import dense_index as di  # noqa: E402
from dial_rag_tpu_torch.index.records import RetrievalType  # noqa: E402
from dial_rag_tpu_torch.ops import stable_topk as st  # noqa: E402

ROWS, DIM, QUERIES = 1_000_000, 384, 64


def sort_rows(values, rows, k):
    """The k smallest by a stable sort of the values (the scans pass rows
    ascending wherever values can tie)."""
    v = torch.nan_to_num(values.float(), nan=torch.inf, posinf=torch.inf, neginf=-torch.inf).add_(0.0)
    v, pos = torch.sort(v, dim=-1, stable=True)
    k = min(k, v.shape[-1])
    return v[..., :k], torch.gather(rows.expand(pos.shape), -1, pos[..., :k])


def grouped_rows(values, rows, k):
    """``stable_topk_rows`` with a first stage: each group of 128 keys keeps
    its k smallest (one launch over many short slices), then the k smallest
    of those."""
    v = torch.nan_to_num(values.float(), nan=torch.inf, posinf=torch.inf, neginf=-torch.inf).add_(0.0)
    key = v.contiguous().view(torch.int32).to(torch.int64)
    key ^= (key >> 31) & 0x7FFFFFFF
    key <<= 32
    key |= rows
    m = key.shape[-1]
    k = min(k, m)
    if m > 1024 and k < 128:
        pad = key.new_full((*key.shape[:-1], -m % 128), torch.iinfo(torch.int64).max)
        key = torch.cat([key, pad], dim=-1).view(*key.shape[:-1], -1, 128)
        key = torch.topk(key, k, dim=-1, largest=False, sorted=False).values.flatten(-2)
    key, _ = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    b = (key >> 32).to(torch.int32)
    return (b ^ ((b >> 31) & 0x7FFFFFFF)).view(torch.float32), key & 0xFFFFFFFF


def argmin_rows(values, rows, k):
    vals, pos = st.stable_topk_argmin(values + 0.0, k)
    return vals, torch.gather(rows.expand(values.shape), -1, pos)


def host_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, top=0):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d} x  {e.key[:80]}")
    return total


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_scan_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn((ROWS, DIM), generator=gen, device=dev)
    mat /= mat.norm(dim=1, keepdim=True)
    qs = (mat[:QUERIES] + 0.05 * torch.randn((QUERIES, DIM), generator=gen, device=dev)).cpu()
    host = mat.cpu().numpy()
    del mat
    docs = [di.DocEmbeddings(np.arange(ROWS), host)]
    built_topk, built_share = di.stable_topk_rows, di._SCAN_SHARE
    for storage in ("float32", "bfloat16", "int8"):
        index = di.DenseIndex(RetrievalType.TEXT, docs, limit=7, storage_dtype=storage, device=dev)
        ref_batch = [[h.chunk_id for h in hs] for hs in index.find_batch(qs)]
        ref_one = [h.chunk_id for h in index.find(qs[0])]
        for name, topk, share in (("built", built_topk, built_share), ("grouped", grouped_rows, built_share),
                                  ("sort", sort_rows, built_share), ("argmin", argmin_rows, built_share),
                                  ("built, 4x block", built_topk, 4 * built_share)):
            di.stable_topk_rows, di._SCAN_SHARE = topk, share
            batch = [[h.chunk_id for h in hs] for hs in index.find_batch(qs)]
            one = [h.chunk_id for h in index.find(qs[0])]
            if batch != ref_batch or one != ref_one:
                raise RuntimeError(f"{storage} {name}: other hits than the built scan's")
            blocks = len(index._row_blocks(index._per_row_bytes(QUERIES, storage == "bfloat16")))
            b_host = host_ms(lambda: index.find_batch(qs))
            o_host = host_ms(lambda: index.find(qs[0]))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            index.find_batch(qs)
            held = torch.cuda.max_memory_allocated() - before
            print(f"{storage} {name}: {blocks} blocks a 64-query scan; find_batch of 64 {b_host:.2f} ms "
                  f"(device {device_ms(lambda: index.find_batch(qs)):.3f} ms, {held / 2**20:.1f} MiB beyond the "
                  f"{index.nbytes / 2**20:.0f} MiB index), find {o_host:.2f} ms (device "
                  f"{device_ms(lambda: index.find(qs[0])):.3f} ms) {card}", flush=True)
            if name == "built":
                print("  top kernels of find_batch:")
                device_ms(lambda: index.find_batch(qs), top=5)
        di.stable_topk_rows, di._SCAN_SHARE = built_topk, built_share
        del index
        torch.cuda.empty_cache()

    # torch._int_mm at an int8 scan block's shapes (and a MaxSim block's)
    for r in (32_768, 131_072):
        a = torch.randint(-127, 128, (r, DIM), dtype=torch.int8, device=dev)
        for q in (8, 16, 64, 128):
            b = torch.randint(-127, 128, (max(q, 32), DIM), dtype=torch.int8, device=dev)
            rows_first = cuda_ms(lambda: torch._int_mm(a, b[:q].T))
            queries_first = cuda_ms(lambda: torch._int_mm(b, a.T))
            f32 = cuda_ms(lambda: a.float() @ b[:q].float().T)
            print(f"_int_mm R={r} D={DIM} Q={q}: rows first [R, D] x [D, Q] {rows_first:.4f} ms; queries first "
                  f"[{max(q, 32)}, D] x [D, R] {queries_first:.4f} ms; f32 (upcast + matmul) {f32:.4f} ms {card}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
