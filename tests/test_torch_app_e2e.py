"""The port's DIAL app end to end against the JAX package's, on the CPU.

Every scenario of tests/test_app_e2e.py but those that need what the port
does not serve yet (telemetry spans: item 9c; the mesh: item 10; the
multimodal and description arms and the rate-limit storm on the
multimodal arm: item 9b) runs twice, unchanged: once against the JAX app
(aiohttp's test server) and once against the port's app (its own HTTP
server, ``service/http.py``, driven by aiohttp's client), each with a
fresh ``FakeDialCore`` set up the same way and the same ``from_random``
weights (the JAX embedder's, carried over with ``params_from_jax_numpy``).
The scenario's own assertions hold for both, and every response is
recorded and compared field by field after dropping ``id``, ``created``
and the stage timings. Both apps answer with
``num_page_images_to_use: 0``: the port raises ``NotImplementedError``
(ROADMAP item 9b) for page images, which ``test_page_images_raise_*``
checks at the default of 4.

The one intended difference: the text of an invalid custom
configuration's 400 after ``"Invalid configuration: "`` is the port's
``errors()``; the comparison holds the status, the error type and code,
and each error's (type, loc) pairs equal.
"""

import asyncio
import dataclasses
import json
import re
from contextlib import asynccontextmanager

import aiohttp
import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

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
from tests.utils.pdf_builder import build_pdf

# the scenarios that need a part the port does not serve yet
NOT_PORTED = {
    "test_request_emits_telemetry_spans_and_counters": "9c",
    "test_mesh_auto_enabled_on_multi_device": "10",
    "test_mesh_disabled_by_config": "10",
    "test_multimodal_index_e2e": "9b",
    "test_description_index_e2e": "9b",
    "test_rate_limit_storm_collapses_to_single_429": "9b",
}
SCENARIOS = sorted(n for n in dir(E) if n.startswith("test_") and n not in NOT_PORTED)
CHAT_PATH = "/openai/deployments/dial-rag/chat/completions"
TIMING = re.compile(r" \[\d+\.\d+s\]")
INVALID = "Invalid configuration: "


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


def normalize(value):
    """The comparable form of a response body: ``id`` and ``created``
    dropped, stage timings cut, an invalid configuration's text replaced
    by its errors' (type, loc) pairs, and a merged message's stages
    sorted by name without their indexes (the documents of a request are
    processed concurrently, so the order their stages open in is the
    event loop's, in either app)."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k in ("id", "created"):
                continue
            if k == "name" and isinstance(v, str):
                v = TIMING.sub("", v)
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


class Harness(E.AppHarness):
    async def chat(self, payload: dict, stream: bool = False):
        # both apps answer text-only: page images wait for item 9b
        configuration = payload.setdefault("custom_fields", {}).setdefault("configuration", {})
        configuration.setdefault("qa_chain", {}).setdefault("chat_chain", {}).setdefault(
            "num_page_images_to_use", 0
        )
        return await super().chat(payload, stream)


def make_harness(pkg: str, embedder, records: list):
    """tests/test_app_e2e.py's ``harness`` factory, on ``pkg``'s app."""

    @asynccontextmanager
    async def make(app_config_overrides: dict | None = None, config_embedder: bool = False):
        fake = FakeDialCore()
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
            yield Harness(fake, RecordingClient(session, base, app, records))
        finally:
            if pkg == "jax":
                await client.close()
            else:
                await session.close()
                await server.close()
            await fake.stop()

    return make


async def run_scenario(name: str, pkg: str, embedder) -> list:
    records: list = []
    await getattr(E, name)(make_harness(pkg, embedder, records))
    return records


@pytest.mark.parametrize("name", SCENARIOS)
async def test_scenario_through_both_apps(name, embedders):
    ref = await run_scenario(name, "jax", embedders["jax"])
    got = await run_scenario(name, "port", embedders["port"])
    assert ref, name
    assert [r[0] for r in got] == [r[0] for r in ref]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, (name, i)


def test_every_scenario_is_ported_or_named():
    scenarios = {n for n in dir(E) if n.startswith("test_")}
    assert set(NOT_PORTED) <= scenarios
    assert len(SCENARIOS) == len(scenarios) - len(NOT_PORTED) == 30


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
    body = json.loads(json.dumps(body))
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
    response = json.loads(next(a["data"] for a in custom["attachments"]
                               if a.get("type") == "application/x.aidial-rag.retrieval-response+json"))
    assert response["chunks"]


def test_text_presets_are_the_tuned_profile():
    assert TEXT_PRESETS == ["zero_egress_tuned.yaml"]


async def test_page_images_raise_not_implemented_at_the_default(embedders):
    """At the default num_page_images_to_use (4) a retrieval over a PDF
    needs page images: the port's request fails with a 501 naming ROADMAP
    item 9b, where the JAX app renders them; its make_image_by_page
    raises NotImplementedError."""
    from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord, IndexSettings
    from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
    from dial_rag_tpu_torch.service.retrieval_chain import make_image_by_page

    status, body = await _preset_request("port", "zero_egress_tuned.yaml", embedders["port"], 4)
    assert status == 501, body
    assert "ROADMAP item 9b" in body["error"]["message"]
    record = DocumentRecord(None, IndexSettings(), [Chunk(text="x", metadata={"page_number": 1})], None, None, None,
                            None, "application/pdf", b"")
    hits = [SearchHit(doc_id=0, chunk_id=0, retrieval_type=RetrievalType.TEXT)]
    with pytest.raises(NotImplementedError, match="ROADMAP item 9b"):
        await make_image_by_page([record], hits, 4, 1536)
    assert await make_image_by_page([record], hits, 0, 1536) == {}


@pytest.mark.parametrize(
    "config_name",
    ["description_index", "multimodal_index"],
)
async def test_image_index_configs_raise_not_implemented(config_name, embedders):
    """An indexing config with the description or the multimodal index
    fails the document with a 501 naming ROADMAP item 9b."""
    overrides = {"request": {"indexing": {config_name: {}}}}
    records: list = []
    async with make_harness("port", embedders["port"], records)(overrides) as h:
        resp = await h.client.post(
            CHAT_PATH,
            json={"messages": [E._attach_message("q")],
                  "custom_fields": {"configuration": {"request": {"type": "retrieval"},
                                                      "indexing": {config_name: {}}}}},
            headers={"api-key": "k"},
        )
        body = await resp.json()
    assert resp.status == 501, body
    assert "ROADMAP item 9b" in body["error"]["message"]


async def test_profiler_and_mesh_raise_not_implemented(embedders):
    """use_profiler waits for ROADMAP item 9c and data_parallel for item
    10: each raises rather than serving without them."""
    from dial_rag_tpu_torch.service.profiler import profiler_if_enabled

    with pytest.raises(NotImplementedError, match="item 9c"):
        async with profiler_if_enabled(None, True):
            pass
    async with profiler_if_enabled(None, False):
        pass
    config = port_config.AppConfig.model_validate({"parallel": {"data_parallel": True}})
    with pytest.raises(NotImplementedError, match="item 10"):
        port_app.create_app(config, embedder=embedders["port"], device="cpu")
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
