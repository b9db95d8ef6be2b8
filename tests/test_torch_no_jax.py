"""The port stands alone: ``dial_rag_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``dial_rag_tpu``, nor the packages the card's
machine lacks (safetensors, pydantic, yaml, aiohttp).

A subprocess installs an import hook that refuses those packages, imports
every module of the port, loads the shipped checkpoint and runs the CPU
main path end to end. An AST scan checks the sources as well.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dial_rag_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dial_rag_tpu", "safetensors", "pydantic", "yaml", "aiohttp")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"forbidden import in the port: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import dial_rag_tpu_torch
for mod in pkgutil.walk_packages(dial_rag_tpu_torch.__path__, "dial_rag_tpu_torch."):
    importlib.import_module(mod.name)

import torch
from dial_rag_tpu_torch.documents.model import build_chunks_list
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

emb = BgeEmbedder.from_hf_checkpoint(
    "checkpoints/alps-semantic", compute_dtype=torch.float32, device="cpu"
)
chunks = build_chunks_list([
    ("The Alps are the highest mountain range in Europe.", {}),
    ("Glaciers carve deep valleys into the rock.", {}),
    ("The Rhine and the Rhone rise in the Alps.", {}),
])
record = type("Record", (), {"embeddings_index": SemanticRetriever.build_index(emb, chunks)})()
retriever = SemanticRetriever.from_doc_records(emb, [record], k=2)
hits = retriever.retrieve_batch(["highest mountains in europe", "rivers of the alps"])
assert [len(h) for h in hits] == [2, 2], hits
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print("OK", hits[0][0].chunk_id, hits[1][0].chunk_id)
"""


def test_port_runs_with_forbidden_packages_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, ",".join(FORBIDDEN)],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "source",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_sources_name_no_forbidden_import(source):
    assert not _imported_roots(ROOT / source) & set(FORBIDDEN)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA (here) and outside the repo, the smoke run must fail
    and print no result line."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"],
            cwd=cwd,
            env=env,
            capture_output=True,
            text=True,
            timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
