"""OpenAI-compatible chat client over the Dial Core (first-party HTTP,
replaces the reference's AzureChatOpenAI/langchain stack — llm.py:40-56).

Supports streamed content deltas, non-streamed completion, and forced
function calling (for the standalone-question chain)."""

import asyncio
import json
import logging
from typing import Any, AsyncIterator

from dial_rag_tpu_torch.service import http

from dial_rag_tpu_torch.errors import DialRagError, RateLimitError
from dial_rag_tpu_torch.service.config import LlmConfig

logger = logging.getLogger(__name__)

API_VERSION = "2023-03-15-preview"


def _raise_streamed_error(chunk: dict) -> None:
    """DIAL/OpenAI stream failures arrive as a data: {"error": ...} event
    with HTTP 200; silently skipping it would present a truncated answer
    as a successful completion."""
    if "error" in chunk:
        message = chunk["error"].get("message", "LLM request failed")
        code = str(chunk["error"].get("code", ""))
        error: DialRagError = (
            RateLimitError(message) if code == "429" else DialRagError(message)
        )
        raise error


class LlmClient:
    def __init__(self, dial_url: str, api_key: str, config: LlmConfig):
        self.dial_url = dial_url
        self.api_key = api_key
        self.config = config

    def _session(self) -> http.ClientSession:
        # generous streaming budget (aiohttp defaults to total=300s, which
        # kills long answers mid-stream); sock_read guards stalls instead
        return http.ClientSession(
            timeout=http.ClientTimeout(
                total=self.config.request_timeout_seconds,
                sock_read=120,
            )
        )

    @property
    def _url(self) -> str:
        return (
            f"{self.dial_url}/openai/deployments/"
            f"{self.config.deployment_name}/chat/completions"
        )

    def _body(self, messages: list[dict], stream: bool, **extra) -> dict:
        body: dict[str, Any] = {
            "messages": messages,
            "temperature": self.config.temperature,
            "stream": stream,
            **extra,
        }
        if self.config.max_prompt_tokens:
            body["max_prompt_tokens"] = self.config.max_prompt_tokens
        return body

    async def _post(self, session: http.ClientSession, body: dict):
        response = await session.post(
            self._url,
            params={"api-version": API_VERSION},
            headers={"api-key": self.api_key},
            json=body,
        )
        if response.status == 429:
            response.release()
            raise RateLimitError("Rate limit exceeded for the LLM request")
        response.raise_for_status()
        return response

    async def astream(self, messages: list[dict]) -> AsyncIterator[str]:
        """Yield content deltas of a streamed completion, with retries on
        connection errors before the first token."""
        attempts = self.config.max_retries + 1
        for attempt in range(attempts):
            started = False
            try:
                async with self._session() as session:
                    response = await self._post(
                        session, self._body(messages, stream=True)
                    )
                    async for line in response.content:
                        line = line.strip()
                        if not line.startswith(b"data:"):
                            continue
                        payload = line[len(b"data:") :].strip()
                        if payload == b"[DONE]":
                            return
                        chunk = json.loads(payload)
                        _raise_streamed_error(chunk)
                        for choice in chunk.get("choices", []):
                            delta = choice.get("delta", {})
                            content = delta.get("content")
                            if content:
                                started = True
                                yield content
                    return
            except (
                http.ClientError,
                asyncio.TimeoutError,
                json.JSONDecodeError,
            ) as e:
                if started or attempt == attempts - 1:
                    raise
                logger.warning(f"LLM stream failed (attempt {attempt}): {e}")

    async def acomplete(self, messages: list[dict]) -> str:
        async with self._session() as session:
            response = await self._post(
                session, self._body(messages, stream=False)
            )
            data = await response.json()
        return data["choices"][0]["message"].get("content") or ""

    async def call_function(
        self, messages: list[dict], name: str, description: str, parameters: dict
    ) -> dict:
        """Force a single function call and return its parsed arguments."""
        body = self._body(
            messages,
            stream=False,
            tools=[
                {
                    "type": "function",
                    "function": {
                        "name": name,
                        "description": description,
                        "parameters": parameters,
                    },
                }
            ],
            tool_choice={"type": "function", "function": {"name": name}},
        )
        async with self._session() as session:
            response = await self._post(session, body)
            data = await response.json()
        message = data["choices"][0]["message"]
        tool_calls = message.get("tool_calls") or []
        if not tool_calls:
            raise ValueError("Model did not call the requested function")
        return json.loads(tool_calls[0]["function"]["arguments"])
