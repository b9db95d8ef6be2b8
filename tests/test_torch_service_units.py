"""The service's small units through the port, against the JAX package.

Every case of tests/test_commands.py, tests/test_citations.py and
tests/test_attachment_link.py, tests/test_runtime.py's resource-counter,
rate-limited map, timing, print-stats and error cases and
tests/test_log_config.py's logging cases runs twice: as written, against
the JAX package, and as a twin whose imports name ``dial_rag_tpu_torch``
instead, against the port; both must pass. The values those cases build
(parsed commands and their config overlay, rewritten citations, resolved
attachment links or their errors) are also compared between the packages
through ``tests/utils/port_parity.same``.

Left out: tests/test_runtime.py's profiler cases (the profiler waits for
ROADMAP item 9c) and tests/test_log_config.py's OpenTelemetry cases
(item 9c)."""

import asyncio
import dataclasses
import importlib
import inspect
import logging
import types

import pytest

from tests.utils.port_parity import same, twin_module

SOURCES = ("test_commands", "test_citations", "test_attachment_link", "test_runtime", "test_log_config")
NOT_PORTED = {
    "test_runtime": {
        "test_profiler_concurrent_requests_do_not_crash",
        "test_sampling_profiler_builds_wall_clock_tree",
        "test_profiler_stage_attaches_tree_and_table",
    },
    "test_log_config": {
        "test_telemetry_disabled_by_standard_env",
        "test_telemetry_present_instruments",
        "test_telemetry_instrument_failure_is_contained",
    },
}


N_CASES = 54
# the names the port does not have yet, dropped from a twin's imports
TWIN_DROPS = {"test_log_config": ("    init_telemetry_if_available,\n",)}


def twin(name: str) -> types.ModuleType:
    return twin_module(name, tuple((drop, "") for drop in TWIN_DROPS.get(name, ())))


def cases() -> list[str]:
    out = []
    for name in SOURCES:
        module = importlib.import_module(f"tests.{name}")
        for attr, value in vars(module).items():
            if attr.startswith("test_") and inspect.isfunction(value):
                out.append(f"{name}::{attr}")
            elif attr.startswith("Test") and inspect.isclass(value):
                out += [f"{name}::{attr}.{m}" for m in vars(value) if m.startswith("test_")]
    return [c for c in out if c.split("::")[1].split(".")[-1] not in NOT_PORTED.get(c.split("::")[0], ())]


def run_case(module: types.ModuleType, case: str, monkeypatch) -> None:
    owner, _, method = case.rpartition(".")
    fn = getattr(getattr(module, owner)(), method) if owner else getattr(module, case)
    kwargs = {"monkeypatch": monkeypatch} if "monkeypatch" in inspect.signature(fn).parameters else {}
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        if inspect.iscoroutinefunction(fn):
            asyncio.run(fn(**kwargs))
        else:
            fn(**kwargs)
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


@pytest.mark.parametrize("case", cases())
def test_case_passes_in_both_packages(case, monkeypatch):
    source, _, name = case.partition("::")
    run_case(importlib.import_module(f"tests.{source}"), name, monkeypatch)
    with monkeypatch.context() as m:
        run_case(twin(source), name, m)


def test_every_case_is_run_or_named():
    """The five files' cases, less the six that wait for item 9c."""
    assert len(cases()) == N_CASES


# --- values, compared between the packages -------------------------------------

COMMAND_MESSAGES = [
    ([("user", "look at this\n/attach files/bucket/a.pdf", None)], False),
    ([("user", "q\n/attach files/b/two.pdf", ["files/b/one.pdf"])], False),
    ([("user", "what?\n/model gpt-4o\n/query_model gpt-4o-mini\n/profile", None)], True),
    ([("user", "q\n/model gpt-4o", None)], False),
    ([("user", "q\n/ignore_document_loading_errors", None)], False),
    ([("user", "q\r\n/profile\r\n/model\tgpt-4o\r", None)], True),
    ([("user", "/ model x\n/modelxyz\nplain text", None)], True),
    ([("assistant", "/attach files/b/x.pdf", None), ("user", "/profile false\n/attach files/b/y.pdf", None)], True),
    ([("user", None, None), ("user", [{"type": "text", "text": "/profile"}], None)], True),
]


def _message(P, role, content, attachments):
    msg = {"role": role, "content": content}
    if attachments is not None:
        msg["custom_content"] = {"attachments": [{"url": u} for u in attachments]}
    return P.m("service.messages").Message.model_validate(msg)


@pytest.mark.parametrize("messages,debug", COMMAND_MESSAGES)
def test_commands_match_jax(messages, debug):
    def call(P):
        commands_mod = P.m("service.commands")
        parsed, commands = commands_mod.process_commands([_message(P, *m) for m in messages], debug)
        return (
            [m.model_dump(mode="json") for m in parsed],
            dataclasses.asdict(commands),
            commands_mod.commands_to_config_dict(commands),
        )

    same(call)


CITATION_CASES = [
    (["Answer <[2]> and more <[5]>."], 5),
    (["a <[3]> b <[1]> c <[3]> d"], 5),
    (["see <", "[1", "]> end"], 3),
    (["x <", "[2]> y"], 2),
    (["a <[9]> b <[0]> c"], 3),
    (["literal [1] and <b> tags"], 3),
    (["trailing <[1"], 3),
    (["no citations here"], 0),
    (["<[1]><[2]><[1]> multi <[3]>."], 4),
    (["a", " <[", "1]", "> b <[2", "]>"], 2),
]


@pytest.mark.parametrize("pieces,n", CITATION_CASES)
def test_citations_match_jax(pieces, n):
    def call(P):
        rewrite = P.m("service.citations").rewrite_citations

        async def run():
            async def gen():
                for p in pieces:
                    yield p

            text, used = [], None
            async for piece, final in rewrite(gen(), n):
                if final is not None:
                    used = final
                else:
                    text.append(piece)
            return "".join(text), used

        return asyncio.run(run())

    same(call)


class _Ctx:
    dial_url = "http://dial.example"

    def is_dial_url(self, url: str) -> bool:
        return url.startswith(self.dial_url)

    @property
    def dial_base_url(self):
        return f"{self.dial_url}/v1/"

    @property
    def dial_metadata_base_url(self):
        return f"{self.dial_base_url}metadata/"


ATTACHMENT_LINKS = [
    "files/bucket/folder/doc.pdf",
    "https://example.com/some/doc.pdf",
    "http://dial.example/v1/files/bucket/doc.pdf",
    "files/bucket/my%20doc%C3%A9.pdf",
    "files/bucket/doc.pdf?x=1#page=2",
    "images/bucket/doc.png",
    "files/bucket",
    "/files/bucket/doc.pdf",
    "http://dial.example/elsewhere/doc.pdf",
]


@pytest.mark.parametrize("link", ATTACHMENT_LINKS)
def test_attachment_links_match_jax(link):
    same(lambda P: P.m("service.attachments").AttachmentLink.from_link(_Ctx(), link, "t").model_dump())


def test_attachment_links_of_messages_match_jax():
    messages = [
        {"role": "user", "content": "a", "custom_content": {"attachments": [{"url": "files/b/1.pdf"}]}},
        {"role": "assistant", "content": "b", "custom_content": {"attachments": [{"url": "files/b/2.pdf"}]}},
        {"role": "user", "content": "c", "custom_content": {"attachments": [{"url": "files/b/3.pdf",
                                                                             "type": "x"}]}},
        {"role": "user", "content": "d", "custom_content": {"attachments": [{"title": "no url"}]}},
    ]

    def call(P):
        msgs = [P.m("service.messages").Message.model_validate(m) for m in messages]
        out = []
        for n in (3, 4):
            try:
                out.append([a.model_dump() for a in P.m("service.attachments").get_attachment_links(_Ctx(), msgs[:n])])
            except Exception as e:  # noqa: BLE001 - the error is compared
                out.append((type(e).__name__, str(e)))
        return out

    same(call)


def test_stage_protocol_matches_jax():
    """A streamed choice with stages, attachments and state merges to the
    same message in both packages (``TimedStage`` on the port's
    non-recording span)."""

    def call(P):
        protocol = P.m("service.protocol")

        async def run():
            responder = protocol.ChatCompletionResponder()
            choice = responder.choice
            choice.set_state({"k": 1})
            async with protocol.TimedStage(choice, "Stage one") as stage:
                stage.append_content("text")
                stage.add_attachment(title="t", data="d")
            try:
                async with protocol.TimedStage(choice, "Stage two"):
                    raise ValueError("boom")
            except ValueError:
                pass
            choice.append_content("answer")
            choice.add_attachment(type="text/markdown", title="[1] a", data="x", reference_url="files/b/a")
            choice.close()
            body = await responder.aggregate()
            for s in body["choices"][0]["message"]["custom_content"]["stages"]:
                s["name"] = s["name"].rsplit(" [", 1)[0]
            return body["choices"], body["object"], body["model"]

        return asyncio.run(run())

    same(call)


class _Sink:
    def __init__(self):
        self.text = []

    def write(self, text):
        self.text.append(text)


@pytest.mark.parametrize("mime", [
    "application/pdf",
    "text/plain",
    "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    "application/vnd.oasis.opendocument.text",
    "application/msword",
    "application/vnd.ms-powerpoint",
])
def test_converter_matches_jax(mime):
    """Without LibreOffice (here, and on the card's machine) both packages
    pass native formats through and refuse the legacy ones alike."""
    import shutil

    if shutil.which("soffice"):
        pytest.skip("soffice is installed: the conversion would run")

    def call(P):
        sink = _Sink()
        out = asyncio.run(P.m("service.converter").convert_document_if_needed(mime, b"bytes", sink))
        return out, sink.text

    same(call)


def test_native_keywords_first_use_sets_stopwords_once(monkeypatch):
    """The indexing request builds each document's BM25 tokens in the parse
    pool's threads at once: the C++ core's stopword set, which its
    preprocessing reads, must be written once, not by every thread that
    arrives first (a crash when one thread rewrites it under another)."""
    import threading
    import time

    from dial_rag_tpu_torch.text import keywords

    real = keywords.load_native("keywords")
    calls = []

    class Lib:
        def kw_set_stopwords(self, data, n):
            calls.append(n)
            time.sleep(0.05)  # widen the window another thread would race in
            real.kw_set_stopwords(data, n)

        def __getattr__(self, name):
            return getattr(real, name)

    monkeypatch.setattr(keywords, "load_native", lambda name: Lib())
    monkeypatch.setattr(keywords, "_native_lib", None)
    barrier = threading.Barrier(8)
    out = []

    def first_use():
        barrier.wait()
        out.append(keywords.keywords_preprocess("The foxes were jumping over dogs."))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert out == [["the", "fox", "jump", "dog", "."]] * 8
