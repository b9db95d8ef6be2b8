#!/usr/bin/env python3
"""Runs chip_smoke.py's "sharded serving" phase alone, over every visible card.

    python3 dial_rag_tpu_torch/scripts/sharded_serving_cards.py

With more than one card the phase's mesh is every card: each index puts
one shard on each card, the data-parallel encode one dp slot on each, and
the app with ``parallel.data_parallel: true`` meshes them all. With one
card it is chip_smoke.py's mesh of 4 slots of cuda:0. The phase's inputs
are built as chip_smoke.py builds them, through its own phases and their
gates: the kernels, the BM25 1M index, the dense layouts over the seeded
1M x 384 rows, the main path's 2048 chunks and 64 queries, and their
token encode by ``checkpoints/alps-maxsim``. Last, the app boots in its
default configuration (``data_parallel`` auto) and must build a mesh over
every card when there is more than one, none when there is one.

Prints the cards' names and power limits, the phases' lines and seconds.
"""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def smoke_module():
    """chip_smoke.py of this checkout, for its phases, texts and queries."""
    spec = importlib.util.spec_from_file_location("chip_smoke_sharded", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_serving_cards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    cs = smoke_module()
    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.ops._build import build_kernels
    from dial_rag_tpu_torch.service import app as app_module
    from dial_rag_tpu_torch.service.config import load_app_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()
    card = f"[{smi[0]}]"
    cards = torch.cuda.device_count()
    print(f"cards: {cards}: {smi}", flush=True)
    cs.phase("build")
    build = build_kernels()
    print(f"build: {build.seconds:.2f} s", flush=True)

    cs.phase("inputs")
    embedder = BgeEmbedder.from_hf_checkpoint(str(cs.CHECKPOINT), compute_dtype=torch.bfloat16, device="cuda")
    _, texts, chunks, queries = cs.main_inputs(embedder)
    qs = torch.from_numpy(embedder.embed_queries(queries))
    li_emb = BgeEmbedder.from_hf_checkpoint(str(cs.LI_CHECKPOINT), compute_dtype=torch.bfloat16, device="cuda")
    li_tokens = cs.late_interaction_tokens(li_emb, chunks)

    cs.phase("BM25 1M")
    bm25 = cs.bm25_1m_phase(torch, card)
    cs.phase("dense layouts")
    dense = cs.dense_layouts_phase(torch, card, torch.device("cuda"), qs)
    cs.phase("sharded serving")
    launches = cs.sharded_serving_phase(torch, card, embedder, li_emb, li_tokens, texts, queries, qs, dense, bm25)
    print(f"sharded serving launches of kernels 1-2: {launches}", flush=True)

    cs.phase("default configuration")
    t0 = time.perf_counter()
    config = load_app_config(environ={"DIAL_RAG__EMBEDDER__MODEL_PATH": str(cs.CHECKPOINT)})
    application = app_module.DialRagApplication(config)
    mesh = application.mesh
    if (mesh is None) != (cards <= 1) or (mesh is not None and (mesh.devices.size != cards
                                                                or application.embedder.mesh is not mesh)):
        raise RuntimeError(f"the default configuration on {cards} card(s) booted with mesh {mesh}")
    replicas = sorted(str(d) for d in (application.embedder.replicas or {}))
    print(f"default configuration on {cards} card(s): mesh {mesh}, embedder replicas {replicas}; boot "
          f"{time.perf_counter() - t0:.2f} s {card}", flush=True)
    cs.phase(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
