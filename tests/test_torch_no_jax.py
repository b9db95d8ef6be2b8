"""The port stands alone: ``dial_rag_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``dial_rag_tpu``, nor the packages the card's
machine lacks (safetensors, pydantic, yaml, aiohttp, optax, orbax, msgpack,
PIL, bs4, lxml, charset_normalizer, opentelemetry; HTML goes through the
port's own parser on the standard library's html.parser, page
images and image documents through the port's own codecs).

A subprocess installs an import hook that refuses those packages, imports
every module of the port, loads the shipped checkpoint and runs the CPU
main path end to end, one f32 "pallas" encode, the long-document
"pallas" route and the whole-layer route, an encode at head_dim 64, one
training step, the bfloat16, two_pass and int8 dense layouts, an RRF
ensemble of the late-interaction, expanded BM25 and chargram arms, and
concurrent four-arm RRF requests through one ``DeviceIndexCache``,
parses a PDF, a DOCX, a CSV and an HTML page, stores their records and
loads them back, reads a GIF document's frames and the pages of TIFF,
WebP and animated PNG fixtures,
renders a PDF page with an image to PNG and reads it back, and boots the
port's DIAL app on the standard-library fake Dial Core, which answers one
indexing and one retrieval request over HTTP in the default configuration
(the description index and 4 page images). An AST
scan checks the sources (new modules included: ``service/``, ``utils/``,
``runtime/``) as well.
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
    "msgpack", "PIL", "bs4", "lxml", "charset_normalizer", "opentelemetry",
)
# imported only inside the functions that need them (none: the port parses
# HTML with its own parser)
LAZY = ()

_CHILD = r"""
import asyncio, importlib, importlib.abc, json, pkgutil, sys

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
record = type("Record", (), {"embeddings_index": asyncio.run(SemanticRetriever.build_index(emb, chunks))})()
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
rec = DocumentRecord(None, IndexSettings(), chunks, asyncio.run(Bm25Retriever.build_index(chunks)), record.embeddings_index,
                     None, None, "text/plain", b"",
                     late_interaction_index=asyncio.run(LateInteractionRetriever.build_index(emb, chunks, 32)),
                     chargram_index=asyncio.run(ChargramRetriever.build_index(chunks)))
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
import base64, io, tempfile, zipfile
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
        "b.docx": docx.getvalue(), "c.csv": b"peak,height\nMont Blanc,4806",
        "d.html": b"<title>Alps</title><h1>Peaks</h1><p>Mont Blanc<p>The Matterhorn &amp; the Eiger<li>one<li>two"}
with tempfile.TemporaryDirectory() as root:
    storage = IndexStorage(LocalFileStorage(root))
    for name, data in docs.items():
        mime = detect_mime(None, name, data)
        doc_chunks = parse_document(data, mime, source_link=name)
        doc_rec = DocumentRecord(FORMAT_VERSION, IndexSettings(), doc_chunks, asyncio.run(Bm25Retriever.build_index(doc_chunks)),
                                 None, None, None, mime, data)
        asyncio.run(storage.store(f"files/{name}/index.bin", doc_rec))
        back = asyncio.run(IndexStorage(LocalFileStorage(root)).load(f"files/{name}/index.bin", IndexSettings()))
        assert back.cache_token == doc_rec.cache_token and back.text_index == doc_rec.text_index, name
        assert Bm25Retriever.from_doc_records([back], k=1, device="cpu").retrieve(doc_chunks[0].text.split()[-1]), name
# an image document: a GIF of two frames
from dial_rag_tpu_torch.image_processor.gif import decode_gif_frames, frame_count
gif = (b"GIF89a\x02\x00\x01\x00\xf0\x00\x00\x00\x00\x00\xff\xff\xff"
       b"\x2c\x00\x00\x00\x00\x02\x00\x01\x00\x00\x02\x02D\n\x00"
       b"\x2c\x00\x00\x00\x00\x02\x00\x01\x00\x00\x02\x02\x0c\n\x00\x3b")
frames = decode_gif_frames(gif)
assert frame_count(gif) == 2 and [f[0, :, 0].tolist() for f in frames] == [[0, 255], [255, 0]], frames
# TIFF, WebP, animated PNG, JPEG 2000 and arithmetic, lossless and smoothed JPEG documents: committed
# fixtures against PIL's committed pixels
from pathlib import Path
from dial_rag_tpu_torch.image_processor.extract_pages import decode_pages, page_count
decoded = np.load("tests/data/images/decoded.npz")
for name in ("tiff_g4_fax.tif", "tiff_multipage.tif", "webp_lossy_alpha.webp", "webp_animated.webp",
             "apng_default_image.png", "j2k_rgb.jp2", "j2k_rgb_97.j2k", "j2k_palette.jp2", "jpeg_arith_420.jpg",
             "jpeg_lossless_gray.jpg", "jpeg_smooth_dc_only.jpg"):
    data = Path("tests/data/images", name).read_bytes()
    pages = decode_pages(data)
    assert len(pages) == page_count(data) > 0, name
    assert all((p == decoded[f"{name}@{i}"]).all() for i, p in enumerate(pages, 1)), name
# a page image: a PDF page with a Flate image rendered, PNG-encoded and read back
from dial_rag_tpu_torch.documents.pdf.render import render_pdf_pages
from dial_rag_tpu_torch.image_processor.png import decode_png, encode_png
import importlib.util
spec = importlib.util.spec_from_file_location("image_pdf", "tests/utils/image_pdf.py")
image_pdf = importlib.util.module_from_spec(spec)
spec.loader.exec_module(image_pdf)
page = next(render_pdf_pages(image_pdf.build_image_pdf([([(72, 700, 12, "Alps")],
                                                         [(72, 300, 100, 80, np.zeros((8, 10, 3), np.uint8))])]), [1], 400))
assert page.shape == (400, 309, 3) and (decode_png(encode_png(page)) == page).all() and page.min() == 0
# the DIAL service: the port's app booted through the production loader on
# the standard-library fake Dial Core, one indexing and one retrieval
# request over HTTP, on the CPU
import importlib.util
spec = importlib.util.spec_from_file_location("fake_dial_stdlib", "tests/utils/fake_dial_stdlib.py")
fake_dial = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fake_dial)
from dial_rag_tpu_torch.service import http
from dial_rag_tpu_torch.service.app import create_app
from dial_rag_tpu_torch.service.config import load_app_config

async def service(root):
    fake = fake_dial.FakeDialCore()
    dial_url = await fake.start()
    fake.add_file("files/bucket/rhine.pdf", docs["a.pdf"], "application/pdf")
    config = load_app_config(environ={"DIAL_URL": dial_url, "DIAL_RAG__INDEX_STORAGE__LOCAL_STORAGE_PATH": root})
    server = await http.serve(create_app(config, embedder=emb, device="cpu"))
    out = []
    try:
        async with http.ClientSession(base_url=f"http://127.0.0.1:{server.port}/") as session:
            for kind in ("indexing", "retrieval"):
                body = {"messages": [{"role": "user", "content": "Where does the Rhine rise?",
                                      "custom_content": {"attachments": [{"url": "files/bucket/rhine.pdf"}]}}],
                        "custom_fields": {"configuration": {"request": {"type": kind}}}}
                async with session.post("openai/deployments/dial-rag/chat/completions", json=body,
                                        headers={"api-key": "k"}) as response:
                    assert response.status == 200, (kind, response.status, await response.text())
                    out.append(await response.json())
    finally:
        await server.close()
        await fake.stop()
    return out

with tempfile.TemporaryDirectory() as root:
    indexed, retrieved = asyncio.run(service(root))
attachments = indexed["choices"][0]["message"]["custom_content"]["attachments"]
assert attachments[0]["reference_url"] == "files/bucket/rhine.pdf", attachments
assert json.loads(attachments[-1]["data"]) == {"indexing_result": {}}, attachments
response = json.loads(retrieved["choices"][0]["message"]["custom_content"]["attachments"][0]["data"])
assert response["chunks"] and "Rhine" in response["chunks"][0]["text"], response["chunks"]
assert len(response["images"]) == 1 and decode_png(base64.b64decode(response["images"][0]["data"])).shape[0] == 1536
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
