"""The port's DIAL app end to end against the JAX package's, on the CPU.

Every scenario of tests/test_app_e2e.py but those that need what the port
does not serve yet (telemetry spans: item 9c) or more than the one device
a CPU app sees (the two mesh scenarios, whose counterparts below patch
the visible-device count) runs twice, unchanged: once against the JAX app (aiohttp's test server) and
once against the port's app (its own HTTP server, ``service/http.py``,
driven by aiohttp's client), each with a fresh ``PageImageFakeDial`` set
up the same way and the same ``from_random`` weights (the JAX embedder's,
carried over with ``params_from_jax_numpy``). The scenario's own
assertions hold for both, and every response is recorded and compared
field by field after dropping ``id``, ``created`` and the stage timings.
Both apps answer with page images (4 at 1536 px by default): the JAX app
renders them with PIL, the port with its own rasterizer, so a page image
is compared as decoded pixels under the render tolerance (the same size;
the ink box within INK_BOX_PX, the summed ink within INK_RATIO), not as
bytes. ``PageImageFakeDial`` embeds a page image as a continuous function
of its decoded coarse pixels (tests/utils/page_embeddings.py), so the two
renderers' pages get nearby embeddings.

The one intended difference: the text of an invalid custom
configuration's 400 after ``"Invalid configuration: "`` is the port's
``errors()``; the comparison holds the status, the error type and code,
and each error's (type, loc) pairs equal.
"""

import asyncio
import base64
import copy
import dataclasses
import inspect
import io
import json
import re
from contextlib import asynccontextmanager

import aiohttp
import jax
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

import tests.test_app_e2e as E
from dial_rag_tpu.embeddings.embedder import BgeEmbedder as JaxEmbedder
from dial_rag_tpu.models.bert import BertConfig as JaxBertConfig
from dial_rag_tpu.models.tokenizer import build_test_vocab
from dial_rag_tpu.service import app as jax_app
from dial_rag_tpu.service import config as jax_config
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.models.bert import BertConfig, BertEncoder
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.service import app as port_app
from dial_rag_tpu_torch.service import config as port_config
from dial_rag_tpu_torch.service import http
from dial_rag_tpu_torch.weights import params_from_jax_numpy
from tests.test_preset_boot_e2e import PRESET_DIR, PRESET_STAGES
from tests.utils.fake_dial import FakeDialCore
from tests.utils.page_embeddings import coarse_embedding
from tests.utils.pdf_builder import build_pdf

# the scenarios that need a part the port does not serve yet
NOT_PORTED = {
    "test_request_emits_telemetry_spans_and_counters": "9c",
}
# the scenarios that read the app's mesh, which a CPU app builds only when
# it is told that more than one device is visible: their counterparts
# below of the same names patch the count
MESH_SCENARIOS = ("test_mesh_auto_enabled_on_multi_device", "test_mesh_disabled_by_config")
SCENARIOS = sorted(n for n in dir(E) if n.startswith("test_") and n not in NOT_PORTED and n not in MESH_SCENARIOS)
# scenarios whose documents pass the "All documents" limit, so that the
# semantic, BM25, late-interaction and chargram arms each build an index
INDEXED_SCENARIOS = ["test_device_index_cache_hits_on_repeat_query", "test_late_interaction_index_e2e",
                     "test_chargram_index_e2e"]
CHAT_PATH = "/openai/deployments/dial-rag/chat/completions"
TIMING = re.compile(r" \[\d+\.\d+s\]")
TOOK = re.compile(r" took \d+\.\d+s")  # a timed block's line in a stage's content
INVALID = "Invalid configuration: "
RESPONSE_TYPE = "application/x.aidial-rag.retrieval-response+json"
# the render tolerance of a whole page image (tests/test_torch_render.py
# holds each text line to it)
INK_BOX_PX = 2
INK_RATIO = 0.10


def decode_png(data: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB"))


class PageImageFakeDial(FakeDialCore):
    """tests/utils/fake_dial.py's fake, but a page image's embedding is a
    continuous function of its decoded pixels (``coarse_embedding``), not a
    hash of its base64: the JAX app's and the port's renders of a page get
    nearby embeddings."""

    async def embeddings(self, request):
        body = await request.json()
        if self.embeddings_status is not None or not body.get("custom_input"):
            return await super().embeddings(request)
        data = [
            {"object": "embedding", "index": i,
             "embedding": coarse_embedding(decode_png(c["data"]), self.embedding_dim).tolist()}
            for i, c in enumerate(body["custom_input"])
        ]
        return web.json_response({"object": "list", "data": data})


class PageImage:
    """A base64 PNG page image, equal to another under the render
    tolerance: the same size, the ink boxes within INK_BOX_PX and the
    summed ink within INK_RATIO."""

    def __init__(self, data: str):
        ink = 255 - decode_png(data).astype(np.int64).min(axis=2)
        ys, xs = np.nonzero(ink)
        self.shape = ink.shape
        self.box = (xs.min(), ys.min(), xs.max(), ys.max()) if len(xs) else None
        self.ink = int(ink.sum())

    def __eq__(self, other):
        if not isinstance(other, PageImage) or self.shape != other.shape:
            return False
        if self.box is None or other.box is None:
            return self.box == other.box
        return (max(abs(a - b) for a, b in zip(self.box, other.box)) <= INK_BOX_PX
                and abs(self.ink - other.ink) <= INK_RATIO * max(self.ink, other.ink))

    def __repr__(self):
        return f"PageImage({self.shape}, box={self.box}, ink={self.ink})"


@pytest.fixture(scope="module")
def embedders():
    """tests/test_app_e2e.py's tiny embedder with 512 positions (its
    ``max_len``): the scenarios' 1000-character chunks pass 128 tokens,
    where a gather past the table clamps in JAX and raises in PyTorch."""
    config = dataclasses.replace(JaxBertConfig.tiny(), max_position_embeddings=512)
    jax_emb = JaxEmbedder.from_random(
        config=config, vocab=build_test_vocab(E.VOCAB_WORDS + ["?", ":"]), batch_size=8
    )
    port_emb = BgeEmbedder(
        tokenizer=WordPieceTokenizer(vocab=jax_emb.tokenizer.vocab),
        encoder=BertEncoder(dataclasses.replace(BertConfig.tiny(), max_position_embeddings=512)),
        params=params_from_jax_numpy(jax.tree.map(np.asarray, jax_emb.params)),
        device="cpu",
        batch_size=jax_emb.batch_size,
        model_id=jax_emb.model_id,
    )
    return {"jax": jax_emb, "port": port_emb}


def _error_keys(message: str) -> list:
    return re.findall(r"'type': '([^']+)', 'loc': (\([^)]*\))", message)


# the scenarios whose error tables repeat a row a number of times that the
# event loop's timing sets, in either app: how many of a document's pages
# fail before its build is cancelled (a rate-limit storm on every page)
TIMED_ROW_COUNTS = {"test_rate_limit_storm_collapses_to_single_429"}


def _distinct_rows(message: str) -> str:
    """A document-loading error's table with each repeated row once."""
    rows = []
    for line in message.split("\n"):
        if not (line.startswith("|") and rows and rows[-1] == line):
            rows.append(line)
    return "\n".join(rows)


def distinct_rows(value):
    """``value`` (recorded responses) with every ``message`` string's
    repeated table rows once (``_distinct_rows``)."""
    if isinstance(value, dict):
        return {k: _distinct_rows(v) if k == "message" and isinstance(v, str) else distinct_rows(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(distinct_rows(v) for v in value)
    return value


def normalize(value):
    """The comparable form of a response body: ``id`` and ``created``
    dropped, stage timings (and timed blocks' in stage contents) cut, an invalid configuration's text replaced
    by its errors' (type, loc) pairs, and a merged message's stages
    sorted by name without their indexes (the documents of a request are
    processed concurrently, so the order their stages open in is the
    event loop's, in either app), a retrieval response's JSON parsed and
    its page images compared as ``PageImage``."""
    if isinstance(value, dict):
        if isinstance(value.get("data"), str) and value.get("mime_type") == "image/png":
            return {**value, "data": PageImage(value["data"])}
        if value.get("type") == RESPONSE_TYPE and isinstance(value.get("data"), str):
            value = {**value, "data": json.loads(value["data"])}
        out = {}
        for k, v in value.items():
            if k in ("id", "created"):
                continue
            if k == "name" and isinstance(v, str):
                v = TIMING.sub("", v)
            if k == "content" and isinstance(v, str):
                v = TOOK.sub(" took", v)
            if k == "message" and isinstance(v, str) and v.startswith(INVALID):
                v = (INVALID, _error_keys(v))
            out[k] = normalize(v)
        stages = out.get("stages")
        if isinstance(stages, list) and all(isinstance(st, dict) and "status" in st for st in stages):
            out["stages"] = sorted(({k: v for k, v in st.items() if k != "index"} for st in stages),
                                   key=lambda st: (st.get("name", ""), json.dumps(st, sort_keys=True)))
        return out
    if isinstance(value, list):
        return [normalize(v) for v in value]
    return value


def body_of(raw: bytes, content_type: str):
    text = raw.decode("utf-8")
    if content_type.startswith("text/event-stream"):
        events = [e[len("data: "):] for e in text.split("\n\n") if e.startswith("data: ")]
        return ("sse", [e if e == "[DONE]" else normalize(json.loads(e)) for e in events])
    if content_type.startswith("application/json"):
        return ("json", normalize(json.loads(text)))
    return ("text", text)


class RecordingClient:
    """aiohttp's client calls of a scenario, each response recorded (its
    status and comparable body, in the order the calls were made)."""

    def __init__(self, session: aiohttp.ClientSession, base: str, app, records: list):
        self._session = session
        self._base = base
        self.app = app
        self.server = type("Server", (), {"app": app})()
        self.records = records

    async def _call(self, method: str, path: str, **kw) -> aiohttp.ClientResponse:
        slot = len(self.records)
        self.records.append(None)
        resp = await self._session.request(method, self._base + path, **kw)
        raw = await resp.read()
        self.records[slot] = (resp.status, body_of(raw, resp.headers.get("Content-Type", "")))
        return resp

    async def post(self, path: str, **kw):
        return await self._call("POST", path, **kw)

    async def get(self, path: str, **kw):
        return await self._call("GET", path, **kw)


def make_harness(pkg: str, embedder, records: list):
    """tests/test_app_e2e.py's ``harness`` factory, on ``pkg``'s app."""

    @asynccontextmanager
    async def make(app_config_overrides: dict | None = None, config_embedder: bool = False):
        fake = PageImageFakeDial()
        dial_url = await fake.start()
        fake.add_file("files/user-bucket/alps.pdf", build_pdf(E.ALPS_PDF_LINES, compress=True), "application/pdf")
        config_dict = {"dial_url": dial_url, "request": {"indexing": {"description_index": None}}}
        config = jax_config if pkg == "jax" else port_config
        if app_config_overrides:
            config_dict = config.deep_merge(config_dict, app_config_overrides)
        app_config = config.AppConfig.model_validate(config_dict)
        injected = None if config_embedder else embedder
        if pkg == "jax":
            client = TestClient(TestServer(jax_app.create_app(app_config, embedder=injected)))
            await client.start_server()
            session = client.session
            base = str(client.make_url(""))
            app = client.server.app
        else:
            app = port_app.create_app(app_config, embedder=injected, device="cpu")
            server = await http.serve(app)
            session = aiohttp.ClientSession()
            base = f"http://127.0.0.1:{server.port}"
        try:
            yield E.AppHarness(fake, RecordingClient(session, base, app, records))
        finally:
            if pkg == "jax":
                await client.close()
            else:
                await session.close()
                await server.close()
            await fake.stop()

    return make


class PortMonkeypatch:
    """pytest's ``monkeypatch`` for a scenario that patches a module of the
    JAX package: the port's module of the same name gets the same
    setting, so the scenario holds both apps to it."""

    def __init__(self, monkeypatch):
        self._monkeypatch = monkeypatch

    def setattr(self, target, name, value):
        self._monkeypatch.setattr(target, name, value)
        module = getattr(target, "__name__", "")
        if module.startswith("dial_rag_tpu."):
            import importlib

            port = importlib.import_module(module.replace("dial_rag_tpu.", "dial_rag_tpu_torch.", 1))
            self._monkeypatch.setattr(port, name, value)


async def run_scenario(name: str, pkg: str, embedder, monkeypatch) -> list:
    records: list = []
    scenario = getattr(E, name)
    if "monkeypatch" in inspect.signature(scenario).parameters:
        await scenario(make_harness(pkg, embedder, records), PortMonkeypatch(monkeypatch))
    else:
        await scenario(make_harness(pkg, embedder, records))
    return records


@pytest.mark.parametrize("name", SCENARIOS)
async def test_scenario_through_both_apps(name, embedders, monkeypatch):
    ref = await run_scenario(name, "jax", embedders["jax"], monkeypatch)
    got = await run_scenario(name, "port", embedders["port"], monkeypatch)
    if name in TIMED_ROW_COUNTS:
        ref, got = distinct_rows(ref), distinct_rows(got)
    assert ref, name
    assert [r[0] for r in got] == [r[0] for r in ref]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, (name, i)


def test_every_scenario_is_ported_or_named():
    scenarios = {n for n in dir(E) if n.startswith("test_")}
    assert set(NOT_PORTED) <= scenarios and set(MESH_SCENARIOS) <= scenarios
    assert set(MESH_SCENARIOS) <= set(globals())  # each has its counterpart here
    assert len(SCENARIOS) == len(scenarios) - len(NOT_PORTED) - len(MESH_SCENARIOS) == 33


def eight_slots(device):
    """The visible devices of a machine with 8 cards, as CPU slots."""
    return [device] * 8


async def test_mesh_auto_enabled_on_multi_device(embedders, monkeypatch):
    """With more than one visible card and the default ``data_parallel``
    (auto) the app builds a mesh over every card: 8 patched in, the mesh
    is cuda:0..7; 1 patched in, there is none. A CPU app told of 8 devices
    (8 CPU slots) shards its embedder and its indexes over them and
    serves."""
    import torch

    auto = port_config.AppConfig()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = port_app.DialRagApplication._create_mesh(auto, torch.device("cuda"))
    assert mesh.devices.size == 8 and dict(mesh.shape) == {"dp": 8, "tp": 1}
    assert [str(d) for d in mesh.local_devices] == [f"cuda:{i}" for i in range(8)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_app.DialRagApplication._create_mesh(auto, torch.device("cuda")) is None
    monkeypatch.setattr(port_app, "visible_devices", eight_slots)
    async with make_harness("port", embedders["port"], [])() as h:
        app = h.client.server.app["dial_rag"]
        assert app.mesh is not None and app.mesh.devices.size == 8
        assert app.embedder.mesh is app.mesh and app.embedder.batch_size % 8 == 0


async def test_mesh_disabled_by_config(embedders, monkeypatch):
    import torch

    off = port_config.AppConfig.model_validate({"parallel": {"data_parallel": False}})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert port_app.DialRagApplication._create_mesh(off, torch.device("cuda")) is None
    monkeypatch.setattr(port_app, "visible_devices", eight_slots)
    async with make_harness("port", embedders["port"], [])({"parallel": {"data_parallel": False}}) as h:
        app = h.client.server.app["dial_rag"]
        assert app.mesh is None and app.embedder.mesh is None


@pytest.mark.parametrize("name", INDEXED_SCENARIOS)
async def test_indexed_scenario_on_a_mesh_of_8_slots(name, embedders, monkeypatch):
    """A scenario whose requests build and query the four local arms'
    indexes, the port's app on a mesh of 8 CPU slots (the default
    configuration, 8 devices patched in) and the JAX app on the conftest's
    8 host devices (a mesh too): every response equal."""
    from dial_rag_tpu_torch.parallel import sharded_index

    monkeypatch.setattr(port_app, "visible_devices", eight_slots)
    merges = []
    merge = sharded_index.merge_winners
    monkeypatch.setattr(sharded_index, "merge_winners", lambda *a, **kw: merges.append(a[0].size) or merge(*a, **kw))
    ref = await run_scenario(name, "jax", embedders["jax"], monkeypatch)
    got = await run_scenario(name, "port", embedders["port"], monkeypatch)
    assert merges and set(merges) == {8}  # the port's queries went through 8-shard indexes
    assert ref and [r[0] for r in got] == [r[0] for r in ref]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, (name, i)


async def test_data_parallel_true_serves_the_same_hits(embedders):
    """``data_parallel: true`` on one device makes a one-device mesh, as
    the JAX package does; its retrieval answers are the unsharded app's."""
    bodies = {}
    for dp in (True, False):
        records: list = []
        async with make_harness("port", embedders["port"], records)({"parallel": {"data_parallel": dp}}) as h:
            app = h.client.server.app["dial_rag"]
            assert (app.mesh is not None) == dp
            if dp:
                assert app.mesh.devices.size == 1 and app.embedder.mesh is app.mesh
            h.fake.add_file("files/user-bucket/big.pdf", build_pdf(E._big_pdf_lines(), compress=True),
                            "application/pdf")
            for _ in range(2):  # the second request reads the cached indexes
                resp = await h.chat({
                    "messages": [E._attach_message("cadibona boundary pass", url="files/user-bucket/big.pdf")],
                    "custom_fields": {"configuration": {"request": {"type": "retrieval"}}},
                })
                assert resp.status == 200
        bodies[dp] = records
    assert bodies[True] == bodies[False]
    chunks = [c for r in bodies[True] for a in r[1][1]["choices"][0]["message"]["custom_content"]["attachments"]
              if a.get("type") == RESPONSE_TYPE for c in a["data"]["chunks"]]
    assert chunks


async def _preset_request(pkg: str, preset: str, embedder, num_page_images: int) -> tuple[int, dict]:
    fake = FakeDialCore()
    dial_url = await fake.start()
    fake.add_file("files/user-bucket/alps.pdf", build_pdf(E._big_pdf_lines(8), compress=True), "application/pdf")
    config = jax_config if pkg == "jax" else port_config
    app_config = config.load_app_config(
        environ={"DIAL_RAG__CONFIG_PATH": str(PRESET_DIR / preset), "DIAL_RAG__DIAL_URL": dial_url}
    )
    injected = None if app_config.embedder.model_path else embedder
    if pkg == "jax":
        client = TestClient(TestServer(jax_app.create_app(app_config, embedder=injected)))
        await client.start_server()
        session, base = client.session, str(client.make_url(""))
    else:
        server = await http.serve(port_app.create_app(app_config, embedder=injected, device="cpu"))
        session, base = aiohttp.ClientSession(), f"http://127.0.0.1:{server.port}"
    try:
        payload = {
            "stream": False,
            "messages": [{"role": "user", "content": "southern boundary of the Alps?",
                          "custom_content": {"attachments": [{"url": "files/user-bucket/alps.pdf"}]}}],
            "custom_fields": {"configuration": {
                "request": {"type": "retrieval"},
                "qa_chain": {"chat_chain": {"num_page_images_to_use": num_page_images}},
            }},
        }
        async with session.post(base + CHAT_PATH, json=payload, headers={"api-key": "test-key"}) as resp:
            return resp.status, normalize(await resp.json())
    finally:
        if pkg == "jax":
            await client.close()
        else:
            await session.close()
            await server.close()
        await fake.stop()


ARM_STAGES = ("Embeddings search", "Late interaction search", "Fuzzy keywords search", "Keywords search")


def stage_attachments(response, name: str) -> list:
    stages = response[1]["choices"][0]["message"]["custom_content"]["stages"]
    return next(s.get("attachments", []) for s in stages if s["name"].startswith(name))


def arms_unordered(response):
    """``response`` with each arm stage's attachments sorted."""
    status, body = response
    body = copy.deepcopy(body)
    for stage in body["choices"][0]["message"]["custom_content"]["stages"]:
        if stage["name"].startswith(ARM_STAGES):
            stage["attachments"] = sorted(stage.get("attachments", []), key=json.dumps)
    return status, body


TEXT_PRESETS = sorted(
    p for p in PRESET_STAGES
    if jax_config.load_app_config(environ={"DIAL_RAG__CONFIG_PATH": str(PRESET_DIR / p)}).request.indexing.description_index
    is None
    and jax_config.load_app_config(environ={"DIAL_RAG__CONFIG_PATH": str(PRESET_DIR / p)}).request.indexing.multimodal_index
    is None
)


@pytest.mark.parametrize("preset", TEXT_PRESETS)
async def test_preset_boot_engages_the_same_arms(preset, embedders):
    """tests/test_preset_boot_e2e.py's matrix over the presets without a
    description or multimodal index: booted through the production
    loader in both packages, the same stages and the same retrieval
    response."""
    expected, absent = PRESET_STAGES[preset]
    ref = await _preset_request("jax", preset, embedders["jax"], 0)
    got = await _preset_request("port", preset, embedders["port"], 0)
    # the fused hits and the retrieval response are equal; inside an arm
    # the corpus's near-tied chunks (its pages repeat one sentence) may
    # order differently (bf16 MaxSim, the SVD of the expansion's word
    # vectors), so each arm's stage is held to the same chunks
    assert arms_unordered(got) == arms_unordered(ref)
    assert stage_attachments(got, "Combined search") == stage_attachments(ref, "Combined search")
    status, body = got
    assert status == 200
    custom = body["choices"][0]["message"]["custom_content"]
    stages = [s["name"] for s in custom["stages"]]
    assert all(any(n in s for s in stages) for n in expected), stages
    assert not any(any(n in s for s in stages) for n in absent), stages
    response = next(a["data"] for a in custom["attachments"] if a.get("type") == RESPONSE_TYPE)
    assert response["chunks"]


def test_text_presets_are_the_tuned_profile():
    assert TEXT_PRESETS == ["zero_egress_tuned.yaml"]


DESCRIPTION = ('{"page_summary": "The Alps and the Cadibona pass.",'
               ' "keyfact": "Cadibona marks the southern boundary."}')
ANSWER = "The Cadibona pass marks the southern boundary."


def _describe_or_answer(body: dict) -> str:
    """The scripted vision LLM: a description for a page-description
    request (the prompt and one page image), the answer otherwise."""
    content = body["messages"][-1].get("content")
    if isinstance(content, list) and "page_summary" in (content[0].get("text") or ""):
        return DESCRIPTION
    return ANSWER


async def _image_preset_run(pkg: str, preset: str | None, embedder) -> tuple[list, int]:
    """A retrieval and a streamed rag request over an 8-page PDF, the app
    booted through the production loader from ``preset`` (None: the
    default configuration); the responses (the stream merged, as
    ``merged_stream`` merges it) and the page images the answer model
    received."""
    fake = PageImageFakeDial()
    dial_url = await fake.start()
    fake.add_file("files/user-bucket/alps.pdf", build_pdf(E._big_pdf_lines(8), compress=True), "application/pdf")
    fake.script_llm(_describe_or_answer)
    environ = {"DIAL_RAG__DIAL_URL": dial_url}
    if preset:
        environ["DIAL_RAG__CONFIG_PATH"] = str(PRESET_DIR / preset)
    config = jax_config if pkg == "jax" else port_config
    app_config = config.load_app_config(environ=environ)
    injected = None if app_config.embedder.model_path else embedder
    if pkg == "jax":
        client = TestClient(TestServer(jax_app.create_app(app_config, embedder=injected)))
        await client.start_server()
        session, base = client.session, str(client.make_url(""))
    else:
        server = await http.serve(port_app.create_app(app_config, embedder=injected, device="cpu"))
        session, base = aiohttp.ClientSession(), f"http://127.0.0.1:{server.port}"
    message = {"role": "user", "content": "southern boundary of the Alps?",
               "custom_content": {"attachments": [{"url": "files/user-bucket/alps.pdf"}]}}
    retrieval = {"stream": False, "messages": [message],
                 "custom_fields": {"configuration": {"request": {"type": "retrieval"}}}}
    try:
        async with session.post(base + CHAT_PATH, json=retrieval, headers={"api-key": "test-key"}) as resp:
            records = [(resp.status, normalize(await resp.json()))]
        async with session.post(base + CHAT_PATH, json={"stream": True, "messages": [message]},
                                headers={"api-key": "test-key"}) as resp:
            text = (await resp.read()).decode("utf-8")
            events = [json.loads(e[len("data: "):]) for e in text.split("\n\n")
                      if e.startswith("data: ") and e != "data: [DONE]"]
            records.append((resp.status, merged_stream(events)))
    finally:
        if pkg == "jax":
            await client.close()
        else:
            await session.close()
            await server.close()
        await fake.stop()
    answer = fake.llm_requests[-1]["messages"][-1]["content"]
    images = [c for c in answer if c.get("type") == "image_url"] if isinstance(answer, list) else []
    return records, len(images)


def merged_stream(events: list) -> dict:
    """A streamed response as a client merges it: the content appended;
    each stage's fields by its index, its content appended and its
    attachments extended; the message's attachments extended. The stages
    of concurrent arms open in the event loop's order, in either app, so
    they are compared as ``normalize`` orders a merged message's."""
    content, attachments, stages = "", [], {}
    for event in events:
        if not event.get("choices"):
            continue
        delta = event["choices"][0].get("delta", {})
        content += delta.get("content") or ""
        custom = delta.get("custom_content") or {}
        attachments += custom.get("attachments", [])
        for stage in custom.get("stages", []):
            merged = stages.setdefault(stage["index"], {})
            for key, value in stage.items():
                if key == "content":
                    merged["content"] = merged.get("content", "") + value
                elif key == "attachments":
                    merged.setdefault("attachments", []).extend(value)
                elif key != "index":
                    merged[key] = value
    return normalize({"content": content, "attachments": attachments, "stages": list(stages.values())})


@pytest.mark.parametrize("preset", ["azure_description.yaml", "gcp_embedding.yaml", None])
async def test_image_presets_serve_page_images(preset, embedders):
    """The reference's description and multimodal presets and the default
    configuration (the description index on, 4 page images), booted
    through the production loader in both packages: the port indexes the
    PDF, retrieves through the image arm and streams a rag answer whose
    model received 4 page images, with the JAX app's responses."""
    ref, ref_images = await _image_preset_run("jax", preset, embedders["jax"])
    got, got_images = await _image_preset_run("port", preset, embedders["port"])
    assert [r[0] for r in got] == [200, 200]
    assert got_images == ref_images == 4
    stages = [st["name"] for st in got[0][1]["choices"][0]["message"]["custom_content"]["stages"]]
    arm = "Multimodal search" if preset == "gcp_embedding.yaml" else "Page image search"
    assert any(arm in name for name in stages), stages
    assert ANSWER in got[1][1]["content"]
    assert got == ref


async def test_page_images_raise_not_implemented_at_the_default(embedders):
    """At the default num_page_images_to_use (4) a retrieval over a PDF
    needs page images: the port renders them (it once raised, ROADMAP
    item 9b), as the JAX app does, each under the render tolerance of
    the JAX app's; make_image_by_page gives none at 0."""
    from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
    from dial_rag_tpu_torch.service.retrieval_chain import make_image_by_page

    ref = await _preset_request("jax", "zero_egress_tuned.yaml", embedders["jax"], 4)
    got = await _preset_request("port", "zero_egress_tuned.yaml", embedders["port"], 4)
    assert got[0] == 200, got
    response = next(a["data"] for a in got[1]["choices"][0]["message"]["custom_content"]["attachments"]
                    if a.get("type") == RESPONSE_TYPE)
    images = response["images"]
    assert len(images) == 4 and all(isinstance(i["data"], PageImage) for i in images), response
    assert arms_unordered(got) == arms_unordered(ref)
    record = DocumentRecord(None, IndexSettings(), [Chunk(text="x", metadata={"page_number": 1})], None, None, None,
                            None, "application/pdf", build_pdf(E._big_pdf_lines(1), compress=True))
    hits = [SearchHit(doc_id=0, chunk_id=0, retrieval_type=RetrievalType.TEXT)]
    (image,) = (await make_image_by_page([record], hits, 4, 1536)).values()
    assert PageImage(image).shape[0] == 1536
    assert await make_image_by_page([record], hits, 0, 1536) == {}


@pytest.mark.parametrize(
    "config_name",
    ["description_index", "multimodal_index"],
)
async def test_image_index_configs_raise_not_implemented(config_name, embedders):
    """An indexing config with the description or the multimodal index
    builds it and serves its arm (the port once failed the document with
    a 501 naming ROADMAP item 9b), with the JAX app's response."""
    overrides = {"request": {"indexing": {config_name: {}}}}
    stage = {"description_index": "Page image search", "multimodal_index": "Multimodal search"}[config_name]
    out = {}
    for pkg in ("jax", "port"):
        records: list = []
        async with make_harness(pkg, embedders[pkg], records)(overrides) as h:
            h.fake.script_llm('{"page_summary": "The Alps and Cadibona.", "keyfact": "Cadibona is south."}')
            h.fake.add_file("files/user-bucket/big.pdf", build_pdf(E._big_pdf_lines(), compress=True),
                            "application/pdf")
            resp = await h.client.post(
                CHAT_PATH,
                json={"messages": [E._attach_message("cadibona", url="files/user-bucket/big.pdf")],
                      "custom_fields": {"configuration": {"request": {"type": "retrieval"},
                                                          "indexing": {config_name: {}}}}},
                headers={"api-key": "k"},
            )
            body = normalize(await resp.json())
        assert resp.status == 200, (pkg, body)
        stages = [s["name"] for s in body["choices"][0]["message"]["custom_content"]["stages"]]
        assert any(stage in s for s in stages), (pkg, stages)
        out[pkg] = body
    assert out["port"] == out["jax"]


async def test_profiler_and_mesh_raise_not_implemented(embedders):
    """use_profiler waits for ROADMAP item 9c and raises rather than
    serving without it. data_parallel no longer raises: on (on the CPU's
    one device) it builds a one-device mesh and the embedder shards over
    it; auto with one device builds none."""
    from dial_rag_tpu_torch.service.profiler import profiler_if_enabled

    with pytest.raises(NotImplementedError, match="item 9c"):
        async with profiler_if_enabled(None, True):
            pass
    async with profiler_if_enabled(None, False):
        pass
    config = port_config.AppConfig.model_validate({"parallel": {"data_parallel": True}})
    app = port_app.DialRagApplication(config, embedders["port"], device="cpu")
    assert app.mesh.devices.size == 1 and app.embedder.mesh is app.mesh and embedders["port"].mesh is None
    auto = port_config.AppConfig()
    assert port_app.DialRagApplication(auto, embedders["port"], device="cpu").mesh is None


def test_app_raises_without_a_card():
    """The port's app runs on the card by default and raises when there
    is none (here), rather than falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_app.create_app(port_config.AppConfig())


def test_fake_dial_stdlib_answers_as_the_aiohttp_fake():
    """tests/utils/fake_dial_stdlib.py answers every scripted call as
    tests/utils/fake_dial.py does: the same statuses and bodies."""
    from tests.utils import fake_dial_stdlib

    async def drive(fake) -> list:
        base = await fake.start()
        fake.add_file("files/b/doc.pdf", b"%PDF-1.4 data", "application/pdf")
        fake.script_llm("first answer, streamed in pieces", lambda body: "called", "last")
        out = []
        try:
            async with aiohttp.ClientSession() as s:
                async def call(method, path, **kw):
                    async with s.request(method, base + path, **kw) as r:
                        raw = await r.read()
                        out.append((method, path, r.status, r.headers.get("Content-Type", "").split(";")[0],
                                    r.headers.get("Content-Length") if method == "HEAD" else None, raw))

                await call("GET", "/v1/bucket")
                await call("GET", "/v1/deployments/gpt/limits")
                await call("GET", "/v1/files/b/doc.pdf")
                await call("HEAD", "/v1/files/b/doc.pdf")
                await call("GET", "/v1/files/b/missing.pdf")
                await call("GET", "/v1/metadata/files/b/doc.pdf")
                await call("GET", "/v1/metadata/files/b/missing.pdf")
                form = aiohttp.FormData()
                form.add_field("file", b"index bytes", filename="files/b/idx.bin", content_type="application/x-idx")
                await call("PUT", "/v1/files/b/idx.bin", data=form)
                await call("GET", "/v1/files/b/idx.bin")
                chat = "/openai/deployments/gpt/chat/completions"
                await call("POST", chat, json={"messages": [], "stream": True})
                await call("POST", chat, json={"messages": [], "tool_choice": {"function": {"name": "q"}}})
                await call("POST", chat, json={"messages": []})
                await call("POST", "/openai/deployments/emb/embeddings",
                           json={"input": ["a", "b"], "custom_input": [{"data": "c"}]})
                fake.embeddings_status = 429
                await call("POST", "/openai/deployments/emb/embeddings", json={"input": ["a"]})
                await call("POST", "/v1/bucket")
                await call("GET", "/nowhere")
        finally:
            await fake.stop()
        return out, fake.llm_requests, fake.content_types

    async def both():
        return await drive(FakeDialCore()), await drive(fake_dial_stdlib.FakeDialCore())

    ref, got = asyncio.run(both())
    assert got == ref
    assert [r[2] for r in got[0]] == [200, 200, 200, 200, 404, 200, 404, 200, 200, 200, 200, 200, 200, 429, 405, 404]


async def test_health_answers_while_an_index_encodes(embedders):
    """The event loop stays free while a document encodes: /health
    answers during an indexing request whose encode is held."""
    import threading

    release = threading.Event()
    emb = dataclasses.replace(embedders["port"])
    original = emb.embed_documents

    def held(texts):
        release.wait(30)
        return original(texts)

    object.__setattr__(emb, "embed_documents", held)
    records: list = []
    async with make_harness("port", emb, records)() as h:
        indexing = asyncio.ensure_future(
            h.chat({"messages": [E._attach_message("")],
                    "custom_fields": {"configuration": {"request": {"type": "indexing"}}}})
        )
        await asyncio.sleep(0.3)
        assert not indexing.done()
        health = await asyncio.wait_for(h.client.get("/health"), 5)
        assert health.status == 200 and await health.json() == {"status": "ok"}
        release.set()
        resp = await asyncio.wait_for(indexing, 60)
        assert resp.status == 200


@pytest.mark.parametrize("case", range(4))
async def test_chip_smoke_error_cases_are_the_jax_answers(case, embedders):
    """chip_smoke.py's service phase holds the port's error answers to the
    bodies in ``SERVICE_ERRORS``: they are the JAX app's, and the port's
    here too (a message ending in ": " is the invalid configuration's
    prefix)."""
    import chip_smoke

    what, payload, status, want = chip_smoke.SERVICE_ERRORS[case]
    for pkg in ("jax", "port"):
        records: list = []
        async with make_harness(pkg, embedders[pkg], records)() as h:
            kw = {"data": payload} if isinstance(payload, bytes) else {"json": payload}
            resp = await h.client.post(CHAT_PATH, headers={"api-key": "k"}, **kw)
            body = await resp.json()
        assert resp.status == status, (pkg, what)
        prefix = want["error"]["message"]
        if prefix.endswith(": "):
            assert body["error"]["message"].startswith(prefix), (pkg, what)
            body = {"error": {**body["error"], "message": prefix}}
        assert body == want, (pkg, what)
