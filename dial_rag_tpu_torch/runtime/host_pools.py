"""Named host thread pools (counterpart of
``dial_rag_tpu/runtime/host_pools.py``, which it copies; the reference's
CPU-pool policy).

- ``parse`` (``max(1, CPU - 2)`` workers): CPU-bound host work (parsing,
  chunking, keyword preprocessing) that must not starve the event loop or
  the dispatch threads;
- ``indexing_dispatch`` (1 worker): bulk encodes run one after another, so
  concurrent indexing requests interleave at batch granularity;
- ``query_dispatch`` (1 worker): query encodes take a lane of their own, so
  a query never queues behind a bulk indexing stream's tokenization.

``init_host_pools`` starts every worker ahead of the first request. Work
runs with the caller's ``contextvars`` copied into the worker.
"""

import asyncio
import contextvars
import os
from concurrent.futures import ThreadPoolExecutor

_pools: dict[str, ThreadPoolExecutor] | None = None


def _create() -> dict[str, ThreadPoolExecutor]:
    cpu = os.cpu_count() or 1
    return {
        "parse": ThreadPoolExecutor(max_workers=max(1, cpu - 2), thread_name_prefix="parse"),
        "indexing_dispatch": ThreadPoolExecutor(max_workers=1, thread_name_prefix="indexing-dispatch"),
        "query_dispatch": ThreadPoolExecutor(max_workers=1, thread_name_prefix="query-dispatch"),
    }


def get_pools() -> dict[str, ThreadPoolExecutor]:
    global _pools
    if _pools is None:
        _pools = _create()
    return _pools


def init_host_pools() -> None:
    """Create every pool and start its workers (a no-op task each)."""
    for pool in get_pools().values():
        for _ in range(pool._max_workers):
            pool.submit(lambda: None)


async def _run_in(pool_name: str, fn, *args):
    ctx = contextvars.copy_context()
    return await asyncio.get_running_loop().run_in_executor(get_pools()[pool_name], lambda: ctx.run(fn, *args))


async def run_in_parse_pool(fn, *args):
    return await _run_in("parse", fn, *args)


async def run_in_indexing_dispatch_pool(fn, *args):
    return await _run_in("indexing_dispatch", fn, *args)


async def run_in_query_dispatch_pool(fn, *args):
    return await _run_in("query_dispatch", fn, *args)
