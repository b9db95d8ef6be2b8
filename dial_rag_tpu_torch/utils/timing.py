"""Timing/timeout helpers (mirrors reference utils.py:16-47,107-116)."""

import asyncio
from contextlib import asynccontextmanager
from time import perf_counter

from dial_rag_tpu_torch.errors import DialRagError


@asynccontextmanager
async def timed_block(name: str, file):
    file.write(f"{name} started\n")
    start = perf_counter()
    try:
        yield
    finally:
        file.write(f"{name} took {perf_counter() - start:.2f}s\n")


@asynccontextmanager
async def timeout(seconds: float, error_message: str | None = None):
    try:
        async with asyncio.timeout(seconds) as cm:
            yield
    except TimeoutError:
        # only relabel OUR expiry; an inner operation's TimeoutError
        # (e.g. an aiohttp request timeout) keeps its own identity so the
        # dedicated download-timeout mapping still applies
        if not cm.expired():
            raise
        raise DialRagError(
            error_message
            or f"Failed to process request in {seconds} seconds"
        ) from None


def format_size(size: int) -> str:
    for unit in ("bytes", "KiB", "MiB", "GiB"):
        if size < 1024 or unit == "GiB":
            if unit == "bytes":
                return f"{size} {unit}"
            return f"{size:.2f} {unit}"
        size /= 1024
    raise AssertionError("unreachable")
