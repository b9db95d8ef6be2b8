"""The port stands alone: ``dial_rag_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``dial_rag_tpu``, nor the packages the card's
machine lacks (safetensors, pydantic, yaml, aiohttp, optax, orbax, msgpack,
PIL, bs4, lxml, opentelemetry; the HTML and image parsers import bs4, lxml
and PIL inside their functions, never at module level).

A subprocess installs an import hook that refuses those packages, imports
every module of the port, loads the shipped checkpoint and runs the CPU
main path end to end, one f32 "pallas" encode, the long-document
"pallas" route and the whole-layer route, an encode at head_dim 64, one
training step, the bfloat16, two_pass and int8 dense layouts, an RRF
ensemble of the late-interaction, expanded BM25 and chargram arms, and
concurrent four-arm RRF requests through one ``DeviceIndexCache``, and
parses a PDF, a DOCX and a CSV, stores their records and loads them back.
An AST scan checks the sources (new modules included) as well.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dial_rag_tpu_torch"
FORBIDDEN = (
    "jax", "jaxlib", "dial_rag_tpu", "safetensors", "pydantic", "yaml", "aiohttp", "optax", "orbax",
    "msgpack", "PIL", "bs4", "lxml", "opentelemetry",
)
# imported only inside the functions that need them: HTML documents (bs4 with
# lxml) and image documents (PIL) are parsed on the CPU only
LAZY = ("PIL", "bs4", "lxml")

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
from dial_rag_tpu_torch.models.bert import BertEncoder
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

# the f32 "pallas" route (its autograd function on the plain versions here)
ids, mask = emb.tokenizer.encode_batch(["glaciers carve valleys"])
enc = emb.encoder
pallas = BertEncoder(enc.config, compute_dtype=torch.float32, attention_impl="pallas", pooling=enc.pooling)
out = pallas.encode(emb.params, torch.from_numpy(ids).long(), torch.from_numpy(mask))
ref = enc.encode(emb.params, torch.from_numpy(ids).long(), torch.from_numpy(mask))
assert torch.allclose(out, ref, atol=1e-5), (out - ref).abs().max()

# the long-document "pallas" route (S = 768: the query-blocked forward)
# and the whole-layer route, on their plain versions here
import dataclasses
from dial_rag_tpu_torch.models.bert import BertConfig, bert_forward, init_params
long_cfg = dataclasses.replace(BertConfig.tiny(), max_position_embeddings=1024)
long_params = init_params(long_cfg, torch.Generator().manual_seed(0))
long_ids = torch.randint(5, long_cfg.vocab_size, (1, 768), generator=torch.Generator().manual_seed(1))
long_mask = torch.ones(1, 768, dtype=torch.int32)
for impl, dtype in (("pallas", torch.float32), ("fused_layer", torch.bfloat16)):
    h = bert_forward(long_params, long_ids[:, : 768 if impl == "pallas" else 64],
                     long_mask[:, : 768 if impl == "pallas" else 64], num_heads=long_cfg.num_heads,
                     compute_dtype=dtype, attention_impl=impl)
    assert torch.isfinite(h.float()).all(), impl

# a bge-base-proportioned encode (heads of 64, the kernels' second width)
# through the whole-layer and "pallas" routes, plain versions here
base_cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=128, num_heads=2, intermediate_size=512)
base_params = init_params(base_cfg, torch.Generator().manual_seed(2))
for impl, dtype in (("pallas", torch.float32), ("fused_layer", torch.bfloat16)):
    h = bert_forward(base_params, long_ids[:, :64], long_mask[:, :64], num_heads=base_cfg.num_heads,
                     compute_dtype=dtype, attention_impl=impl)
    assert h.shape == (1, 64, 128) and torch.isfinite(h.float()).all(), impl

# one training step
from dial_rag_tpu_torch.training.loop import TrainConfig, train
cfg = TrainConfig(batch_size=2, seq_len=32, total_steps=1, warmup_steps=1, checkpoint_every=10)
tiny = dataclasses.replace(BertConfig.tiny(), vocab_size=enc.config.vocab_size)
_, losses = train(tiny, cfg, [("alps", "the alps"), ("rhine", "the rhine")], emb.tokenizer,
                  device="cpu")
assert len(losses) == 1 and losses[0] == losses[0], losses
# the dense layouts, late interaction, chargram and word-vector expansion
import asyncio
import numpy as np
from dial_rag_tpu_torch.documents.model import DocumentRecord, IndexSettings
from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
from dial_rag_tpu_torch.index.records import RetrievalType
from dial_rag_tpu_torch.retrieval import (
    Bm25Retriever, ChargramRetriever, EnsembleRetriever, LateInteractionRetriever,
)
from dial_rag_tpu_torch.text.word_vectors import QueryExpansionConfig
rows = np.random.default_rng(0).standard_normal((600, 8)).astype(np.float32)
for storage in ("bfloat16", "two_pass", "int8"):
    dense = DenseIndex(RetrievalType.TEXT, [DocEmbeddings(np.arange(600), rows)], limit=3,
                       storage_dtype=storage, device="cpu")
    assert dense.find(rows[5])[0].chunk_id == 5, storage
rec = DocumentRecord(None, IndexSettings(), chunks, Bm25Retriever.build_index(chunks), record.embeddings_index,
                     None, None, "text/plain", b"",
                     late_interaction_index=LateInteractionRetriever.build_index(emb, chunks, 32),
                     chargram_index=ChargramRetriever.build_index(chunks))
arms = [LateInteractionRetriever.from_doc_records(emb, [rec], k=2),
        Bm25Retriever.from_doc_records([rec], k=2, device="cpu", expansion_config=QueryExpansionConfig(min_count=1)),
        ChargramRetriever.from_doc_records([rec], k=2, device="cpu")]
fused = asyncio.run(EnsembleRetriever(arms).aretrieve_batch(["glaciers carve valleys", "rivers of the alps"]))
assert fused[0][0].chunk_id == 1 and all(fused), fused
# concurrent serving: the four arms rebuilt per request through one device
# cache, coalesced encodes and scans, the RRF aretrieve
from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache
from dial_rag_tpu_torch.runtime import micro_batcher
stamped = dataclasses.replace(rec, cache_token=("doc", "0"))
cache = DeviceIndexCache()

async def request(q):
    arms4 = [SemanticRetriever.from_doc_records(emb, [stamped], k=2, device_cache=cache),
             LateInteractionRetriever.from_doc_records(emb, [stamped], k=2, device_cache=cache),
             Bm25Retriever.from_doc_records([stamped], k=2, device="cpu", device_cache=cache,
                                            expansion_config=QueryExpansionConfig(min_count=1)),
             ChargramRetriever.from_doc_records([stamped], k=2, device="cpu", device_cache=cache)]
    return await EnsembleRetriever(arms4).aretrieve(q)

async def serve(queries):
    return await asyncio.wait_for(asyncio.gather(*(request(q) for q in queries)), timeout=120)

micro_batcher.reset_counts()
served = asyncio.run(serve(["glaciers carve valleys", "rivers of the alps", "highest mountains in europe"]))
assert cache.wait_warm(60) and (cache.misses, len(cache)) == (5, 5), (cache.misses, len(cache))
assert micro_batcher.WAVES["query_encode"] == 1 and served[0][0].chunk_id == 1, (micro_batcher.WAVES, served)
# document indexing: PDF, DOCX and CSV bytes -> parse -> BM25 -> storage -> load
import io, tempfile, zipfile
from dial_rag_tpu_torch.documents.mime import detect_mime
from dial_rag_tpu_torch.documents.model import FORMAT_VERSION
from dial_rag_tpu_torch.documents.parser import parse_document
from dial_rag_tpu_torch.documents.pdf.writer import build_pdf
from dial_rag_tpu_torch.storage import IndexStorage, LocalFileStorage
docx = io.BytesIO()
with zipfile.ZipFile(docx, "w") as zf:
    zf.writestr("word/document.xml", '<w:document xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/'
                '2006/main"><w:body><w:p><w:r><w:t>Glaciers carve valleys.</w:t></w:r></w:p></w:body></w:document>')
docs = {"a.pdf": build_pdf([[(72, 720, 12, "The Rhine rises in the Alps.")]], compress=True),
        "b.docx": docx.getvalue(), "c.csv": b"peak,height\nMont Blanc,4806"}
with tempfile.TemporaryDirectory() as root:
    storage = IndexStorage(LocalFileStorage(root))
    for name, data in docs.items():
        mime = detect_mime(None, name, data)
        doc_chunks = parse_document(data, mime, source_link=name)
        doc_rec = DocumentRecord(FORMAT_VERSION, IndexSettings(), doc_chunks, Bm25Retriever.build_index(doc_chunks),
                                 None, None, None, mime, data)
        asyncio.run(storage.store(f"files/{name}/index.bin", doc_rec))
        back = asyncio.run(IndexStorage(LocalFileStorage(root)).load(f"files/{name}/index.bin", IndexSettings()))
        assert back.cache_token == doc_rec.cache_token and back.text_index == doc_rec.text_index, name
        assert Bm25Retriever.from_doc_records([back], k=1, device="cpu").retrieve(doc_chunks[0].text.split()[-1]), name
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


def _imported_roots(path: Path, module_level: bool = False) -> set[str]:
    """The top-level packages a source imports; with ``module_level``, only
    those imported outside function bodies."""
    roots = set()
    todo = [ast.parse(path.read_text(), filename=str(path))]
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        if not (module_level and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))):
            todo.extend(ast.iter_child_nodes(node))
    return roots


@pytest.mark.parametrize(
    "source",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_sources_name_no_forbidden_import(source):
    assert not _imported_roots(ROOT / source) & (set(FORBIDDEN) - set(LAZY))
    assert not _imported_roots(ROOT / source, module_level=True) & set(FORBIDDEN)


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
