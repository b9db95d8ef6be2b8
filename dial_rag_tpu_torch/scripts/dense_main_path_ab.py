#!/usr/bin/env python3
"""Times the main path's dense queries in this checkout against another
checkout (a parent commit) on one NVIDIA GPU, in turns.

    python3 dial_rag_tpu_torch/scripts/dense_main_path_ab.py --parent DIR

Each turn is a process of its own that imports one checkout's
``dial_rag_tpu_torch`` and runs what chip_smoke.py's main path runs: the
2048 chunks encoded by ``checkpoints/alps-semantic`` (read from this
checkout) in bf16 into a ``SemanticRetriever`` (k = 1), then
``retrieve_batch`` of the 64 queries and ``retrieve`` of 5 (three rounds),
and the seeded 1M x 384 float32
``DenseIndex.from_device_matrix`` (limit 5) answering ``find_batch`` of
the 64 query embeddings and ``find`` of 5 (three rounds). Host times are
medians to a synchronise; device times are the profiler's kernels of one
call; "held" is the peak memory a ``find_batch`` allocates beyond what was
allocated before it. The turns run parent, this checkout, this checkout
with its 1M scan in one block (``--one-block``: the 64 queries' whole [64,
N] scores ranked by one top-k), the same again, this checkout, parent.
Prints a line a turn and the card's name and power limit.
"""

import argparse
import asyncio
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def smoke_module():
    """chip_smoke.py of this checkout, for its texts, queries and timers."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(tree: Path, one_block: bool) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    cs = smoke_module()
    from dial_rag_tpu_torch.documents.model import build_chunks_list
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.index import dense_index as di
    from dial_rag_tpu_torch.index.records import RetrievalType
    from dial_rag_tpu_torch.ops._build import build_kernels
    from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

    assert Path(di.__file__).resolve().is_relative_to(tree.resolve()), di.__file__
    if one_block:
        di._SCAN_BYTES = (1 << 40, 1 << 40)
    build_kernels()
    embedder = BgeEmbedder.from_hf_checkpoint(str(ROOT / "checkpoints" / "alps-semantic"),
                                              compute_dtype=torch.bfloat16, device="cuda")
    oracle = [c["text"] for c in json.loads(cs.ORACLE_CHUNKS.read_text())]
    texts = oracle + cs.synthetic_texts(embedder.tokenizer.vocab, cs.N_DOCS - len(oracle), seed=0)
    chunks = build_chunks_list([(t, {}) for t in texts])
    rng = np.random.default_rng(1)
    queries = []
    for i in rng.choice(len(texts), size=cs.N_QUERIES, replace=False):
        words = texts[i].split()
        j = int(rng.integers(0, max(1, len(words) - 8)))
        queries.append(" ".join(words[j : j + 8]))
    embedder.embed_documents(texts[: embedder.batch_size])
    record = type("Record", (), {"embeddings_index": asyncio.run(SemanticRetriever.build_index(embedder, chunks))})()
    retriever = SemanticRetriever.from_doc_records(embedder, [record], k=1)

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def each_ms(fn, items):
        times = []
        for _ in range(3):
            for x in items:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    retriever.retrieve_batch(queries)
    out = {
        "semantic_batch_ms": host_ms(lambda: retriever.retrieve_batch(queries), 5),
        "semantic_one_ms": each_ms(retriever.retrieve, queries[:5]),
        "semantic_one_device_ms": cs.device_ms(torch, lambda: retriever.retrieve(queries[0])),
    }
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn((1_000_000, embedder.dim), generator=gen, device=dev)
    mat /= mat.norm(dim=1, keepdim=True)
    big = di.DenseIndex.from_device_matrix(RetrievalType.TEXT, mat, limit=5)
    qs = torch.from_numpy(embedder.embed_queries(queries))
    ref = [[h.chunk_id for h in hs] for hs in big.find_batch(qs)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    big.find_batch(qs)
    out["1m_batch_held_mib"] = (torch.cuda.max_memory_allocated() - before) / 2**20
    out["1m_batch_ms"] = host_ms(lambda: big.find_batch(qs), 5)
    out["1m_batch_device_ms"] = cs.device_ms(torch, lambda: big.find_batch(qs))
    out["1m_one_ms"] = each_ms(big.find, qs[:5])
    out["1m_one_device_ms"] = cs.device_ms(torch, lambda: big.find(qs[0]))
    out["1m_top5"] = ref[:4]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--tree", type=Path, help="(one turn) the checkout to import")
    ap.add_argument("--one-block", action="store_true", help="(one turn) rank the 1M scan in one block")
    args = ap.parse_args()
    if args.tree is not None:
        print(json.dumps(turn(args.tree, args.one_block)))
        return 0
    import torch

    if not torch.cuda.is_available() or args.parent is None:
        print("dense_main_path_ab: needs a CUDA device and --parent", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = [("parent", args.parent, False), ("change", ROOT, False), ("change, one block", ROOT, True),
             ("change, one block", ROOT, True), ("change", ROOT, False), ("parent", args.parent, False)]
    tops = set()
    for name, tree, one_block in turns:
        cmd = [sys.executable, __file__, "--tree", str(tree)] + (["--one-block"] if one_block else [])
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        tops.add(json.dumps(row.pop("1m_top5")))
        print(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in row.items()) + f" [{smi}]", flush=True)
    if len(tops) != 1:
        print("dense_main_path_ab: the turns ranked the 1M index differently", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
