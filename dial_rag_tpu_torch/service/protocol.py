"""DIAL chat-completion wire protocol: streamed choices with stages,
attachments and state.

First-party replacement for the aidial-sdk response layer the reference
builds on (DIALApp/Choice/Stage). The DIAL extensions ride the standard
OpenAI chunk format under ``delta.custom_content``:

- ``stages``: incremental updates keyed by stage ``index`` — name/content
  appends, attachments, and a final status ("completed"/"failed");
- ``attachments``: cited-document attachments on the choice;
- ``state``: opaque per-choice state echoed back by the client.

Supports SSE streaming and non-stream aggregation (one merged JSON body),
so tests and non-streaming clients see the same logical response.
"""

import asyncio
import json
import time
import uuid
from dataclasses import dataclass
from time import perf_counter
from typing import Any, AsyncIterator


@dataclass
class Attachment:
    type: str | None = None
    title: str | None = None
    data: str | None = None
    url: str | None = None
    reference_url: str | None = None

    def to_dict(self) -> dict:
        return {
            k: v
            for k, v in (
                ("type", self.type),
                ("title", self.title),
                ("data", self.data),
                ("url", self.url),
                ("reference_url", self.reference_url),
            )
            if v is not None
        }


class Stage:
    def __init__(self, choice: "Choice", index: int, name: str):
        self._choice = choice
        self.index = index
        self.name = name
        self._closed = False
        self._choice._emit_stage(self.index, {"name": name})

    def append_name(self, name_suffix: str):
        self.name += name_suffix
        self._choice._emit_stage(self.index, {"name": name_suffix})

    def append_content(self, content: str):
        self._choice._emit_stage(self.index, {"content": content})

    def add_attachment(self, **kwargs):
        att = Attachment(**kwargs)
        self._choice._emit_stage(
            self.index, {"attachments": [att.to_dict()]}
        )

    @property
    def content_stream(self):
        stage = self

        class _Writer:
            def write(self, content: str):
                stage.append_content(content)

        return _Writer()

    def close(self, status: str = "completed"):
        if not self._closed:
            self._closed = True
            self._choice._emit_stage(self.index, {"status": status})

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close("failed" if exc_type else "completed")
        return False


class Choice:
    """Producer side of one streamed choice."""

    def __init__(self, index: int = 0):
        self.index = index
        self._queue: asyncio.Queue[dict | None] = asyncio.Queue()
        self._stage_count = 0
        self._opened = False
        self._closed = False

    # -- producer API ------------------------------------------------------

    def _emit(self, delta: dict):
        if self._closed:
            return
        if not self._opened:
            self._opened = True
            delta = {"role": "assistant", **delta}
        self._queue.put_nowait(delta)

    def _emit_stage(self, stage_index: int, update: dict):
        self._emit(
            {
                "custom_content": {
                    "stages": [{"index": stage_index, **update}]
                }
            }
        )

    def append_content(self, content: str):
        self._emit({"content": content})

    def create_stage(self, name: str) -> Stage:
        stage = Stage(self, self._stage_count, name)
        self._stage_count += 1
        return stage

    def add_attachment(self, **kwargs):
        self._emit(
            {
                "custom_content": {
                    "attachments": [Attachment(**kwargs).to_dict()]
                }
            }
        )

    def set_state(self, state: Any):
        self._emit({"custom_content": {"state": state}})

    def close(self):
        if not self._closed:
            if not self._opened:
                # a choice always opens with the assistant role
                self._queue.put_nowait({"role": "assistant"})
            self._closed = True
            self._queue.put_nowait(None)

    # -- consumer API ------------------------------------------------------

    async def deltas(self) -> AsyncIterator[dict]:
        while True:
            delta = await self._queue.get()
            if delta is None:
                return
            yield delta


class TimedStage:
    """Stage wrapper adding elapsed time to the name and keep-alive pings
    (reference utils.timed_stage, utils.py:36-47). Each stage is also an
    OpenTelemetry span ("stage: <name>") made current for its body, so
    device-dispatch spans inside the stage parent under it."""

    def __init__(self, choice: Choice, name: str, ping_interval: float = 15.0):
        self._choice = choice
        self._name = name
        self._ping_interval = ping_interval
        self.stage: Stage | None = None
        self._ping_task: asyncio.Task | None = None
        self._start = 0.0
        self._span = None
        self._otel_token = None

    async def __aenter__(self) -> Stage:
        from dial_rag_tpu_torch import telemetry

        self.stage = self._choice.create_stage(self._name)
        # the port's tracer has only the disabled path (the card's machine
        # has no opentelemetry; ROADMAP item 9c): the span records nothing
        # and there is no context to make it current in
        self._span = telemetry.tracer().start_span(
            f"stage: {self._name}"
        )
        self._start = perf_counter()

        async def ping():
            while True:
                await asyncio.sleep(self._ping_interval)
                self.stage.append_content("")

        self._ping_task = asyncio.create_task(ping())
        return self.stage

    async def __aexit__(self, exc_type, exc, tb):
        # await the cancelled ping so a just-woken ping cannot append a
        # content delta AFTER the stage's completed/failed status delta
        self._ping_task.cancel()
        try:
            await self._ping_task
        except asyncio.CancelledError:
            pass
        elapsed = perf_counter() - self._start
        self.stage.append_name(f" [{elapsed:.2f}s]")
        self.stage.close("failed" if exc_type else "completed")
        if exc_type is not None:
            self._span.set_status("ERROR", str(exc))
            if exc is not None:
                self._span.record_exception(exc, escaped=True)
        self._span.end()
        return False


def _merge_stage(acc: dict, update: dict):
    if "name" in update:
        acc["name"] = acc.get("name", "") + update["name"]
    if "content" in update:
        acc["content"] = acc.get("content", "") + update["content"]
    if "attachments" in update:
        acc.setdefault("attachments", []).extend(update["attachments"])
    if "status" in update:
        acc["status"] = update["status"]


def merge_deltas(deltas: list[dict]) -> dict:
    """Aggregate streamed deltas into one message (non-stream responses)."""
    message: dict = {"role": "assistant", "content": ""}
    stages: dict[int, dict] = {}
    attachments: list[dict] = []
    state = None
    has_custom = False
    for delta in deltas:
        if "content" in delta:
            message["content"] += delta["content"]
        cc = delta.get("custom_content")
        if cc:
            has_custom = True
            for stage_update in cc.get("stages", []):
                acc = stages.setdefault(stage_update["index"], {"index": stage_update["index"]})
                _merge_stage(acc, stage_update)
            attachments.extend(cc.get("attachments", []))
            if "state" in cc:
                state = cc["state"]
    if has_custom:
        custom: dict = {}
        if stages:
            custom["stages"] = [stages[i] for i in sorted(stages)]
        if attachments:
            custom["attachments"] = attachments
        if state is not None:
            custom["state"] = state
        message["custom_content"] = custom
    return message


class ChatCompletionResponder:
    """Envelope producer for one request (single choice, like the
    reference's create_single_choice)."""

    def __init__(self, model: str = "dial-rag"):
        self.id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self.created = int(time.time())
        self.model = model
        self.choice = Choice(0)

    def _envelope(self, payload: dict, object_name: str) -> dict:
        return {
            "id": self.id,
            "object": object_name,
            "created": self.created,
            "model": self.model,
            "choices": [payload],
        }

    async def sse_data_chunks(self) -> AsyncIterator[bytes]:
        """Delta chunks only — the caller decides how to terminate the
        stream (finish chunk + [DONE] on success, error payload on
        failure) AFTER awaiting the producer task."""
        async for delta in self.choice.deltas():
            chunk = self._envelope(
                {"index": 0, "delta": delta, "finish_reason": None},
                "chat.completion.chunk",
            )
            yield f"data: {json.dumps(chunk, separators=(',', ':'))}\n\n".encode()

    def sse_finish_chunks(self) -> list[bytes]:
        final = self._envelope(
            {"index": 0, "delta": {}, "finish_reason": "stop"},
            "chat.completion.chunk",
        )
        return [
            f"data: {json.dumps(final, separators=(',', ':'))}\n\n".encode(),
            b"data: [DONE]\n\n",
        ]

    async def sse_chunks(self) -> AsyncIterator[bytes]:
        async for chunk in self.sse_data_chunks():
            yield chunk
        for chunk in self.sse_finish_chunks():
            yield chunk

    async def aggregate(self) -> dict:
        deltas = [d async for d in self.choice.deltas()]
        message = merge_deltas(deltas)
        return self._envelope(
            {"index": 0, "message": message, "finish_reason": "stop"},
            "chat.completion",
        )
