"""Micro-batching of concurrent single-item requests into one call
(counterpart of ``dial_rag_tpu/runtime/micro_batcher.py``, which it
copies).

Concurrent requests' query encodes (``BgeEmbedder.aembed_query``) and
index scans (``DenseIndex.afind``, ``Bm25Index.atop_n_with_scores``,
``LateInteractionIndex.afind``) share one batched call: an encode of [Q, S]
costs the card about what [1, S] costs, and a scan reads the index once
for all its queries. The batcher collects items that arrive within a short
window (or up to ``max_batch``) and runs one batch call; per-item results
resolve each caller's future.

The window delays a query only when the service is concurrent enough for
batching to pay: the first item schedules a flush at ``window_s``; a full
batch flushes at once. With no concurrency the added latency is
``window_s``: ``ENCODE_WINDOW_S`` (2 ms) for the query encode, whose
callers arrive from independent requests. The index scans take
``SCAN_WINDOW_S`` (0): their callers are the rows of one encode wave, or
arms started in one loop iteration, which all submit before the next
iteration runs the flush, so a wall-clock window would only add latency.

While a wave is in flight, new arrivals accumulate with no timer and
flush the moment the wave completes: the in-flight wave holds the device
path the next wave needs, so waiting for it costs nothing, and wave sizes
align to the arrival rate instead of fragmenting into one wave a request.

``MAX_WAVE`` is the one wave size: every batcher's ``max_batch`` and the
largest bucket the indexes' ``warm_query_buckets`` run.

``WAVES`` and ``ITEMS`` count the waves and the items of each named
batcher (``reset_counts`` sets them to 0); items per wave is the
coalescing health number under concurrent load.
"""

import asyncio
import threading
import weakref
from typing import Awaitable, Callable, Generic, TypeVar

T = TypeVar("T")
R = TypeVar("R")

MAX_WAVE = 64
ENCODE_WINDOW_S = 0.002
SCAN_WINDOW_S = 0.0

WAVES: dict[str, int] = {}
ITEMS: dict[str, int] = {}
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    with _COUNT_LOCK:
        WAVES.clear()
        ITEMS.clear()


def _count(name: str, items: int) -> None:
    with _COUNT_LOCK:
        WAVES[name] = WAVES.get(name, 0) + 1
        ITEMS[name] = ITEMS.get(name, 0) + items


class MicroBatcher(Generic[T, R]):
    def __init__(
        self,
        batch_fn: Callable[[list[T]], Awaitable[list[R]]],
        max_batch: int | None = None,
        window_s: float = ENCODE_WINDOW_S,
        name: str = "microbatch",
    ):
        self._batch_fn = batch_fn
        self.max_batch = MAX_WAVE if max_batch is None else max_batch
        self.window_s = window_s
        self.name = name
        self._pending: list[tuple[T, asyncio.Future]] = []
        self._flush_handle: asyncio.TimerHandle | None = None
        self._inflight = 0
        # strong refs: the loop keeps only weak refs to tasks, and a
        # collected flush task would strand every waiter in its batch
        self._tasks: set[asyncio.Task] = set()

    async def submit(self, item: T) -> R:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((item, fut))
        if len(self._pending) >= self.max_batch:
            self._start_flush()
        elif self._inflight == 0 and self._flush_handle is None:
            self._flush_handle = loop.call_later(self.window_s, self._start_flush)
        # else: a wave is in flight; accumulate, its completion flushes
        return await fut

    def _start_flush(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        if not self._pending:
            return
        batch = self._pending
        self._pending = []
        _count(self.name, len(batch))
        task = asyncio.get_running_loop().create_task(self._run(batch))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run(self, batch: list[tuple[T, asyncio.Future]]) -> None:
        items = [item for item, _ in batch]
        self._inflight += 1
        try:
            try:
                results = await self._batch_fn(items)
                if len(results) != len(items):
                    raise RuntimeError(f"batch_fn returned {len(results)} results for {len(items)} items")
            except BaseException as e:  # CancelledError included: never strand a waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                if not isinstance(e, Exception):
                    raise  # cancellation goes on to the task machinery
                return
            for (_, fut), result in zip(batch, results):
                if not fut.done():
                    fut.set_result(result)
        finally:
            self._inflight -= 1
            if self._inflight == 0 and self._pending:
                self._start_flush()


class PerLoopBatcher(Generic[T, R]):
    """One MicroBatcher per event loop (tests and services each run their
    own loops; futures cannot cross loops)."""

    def __init__(self, make: Callable[[], MicroBatcher[T, R]]):
        self._make = make
        self._by_loop: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    async def submit(self, item: T) -> R:
        loop = asyncio.get_running_loop()
        batcher = self._by_loop.get(loop)
        if batcher is None:
            batcher = self._make()
            self._by_loop[loop] = batcher
        return await batcher.submit(item)


def wave_rows(out, n: int) -> list:
    """Rows 0..n-1 of a wave's [Qb, D] output as views (no launch), each
    tagged with (``out``, its row number), so that a scan of the same rows
    reads ``out`` in place (``wave_parent``)."""
    rows = []
    for i in range(n):
        row = out[i]
        row._wave_row = (out, i)
        rows.append(row)
    return rows


def wave_parent(rows: list):
    """The output whose rows 0..q-1 ``rows`` are, in order, as
    ``wave_rows`` tagged them; else None."""
    tags = [getattr(row, "_wave_row", None) for row in rows]
    parent = tags[0][0] if tags[0] is not None else None
    if parent is None or any(t is None or t[0] is not parent or t[1] != i for i, t in enumerate(tags)):
        return None
    return parent


def per_loop_batcher(owner, name: str, batch_fn) -> PerLoopBatcher:
    """``owner``'s index-scan batcher named ``name``, made on first use and
    kept in its ``__dict__``: ``batch_fn(items)`` runs in the loop's default
    executor, a wave at most ``MAX_WAVE`` items, ``SCAN_WINDOW_S`` after
    its first."""
    batcher = owner.__dict__.get("_batcher_" + name)
    if batcher is None:

        async def run_all(items: list) -> list:
            return await asyncio.get_running_loop().run_in_executor(None, batch_fn, items)

        batcher = PerLoopBatcher(lambda: MicroBatcher(run_all, window_s=SCAN_WINDOW_S, name=name))
        owner.__dict__["_batcher_" + name] = batcher
    return batcher
