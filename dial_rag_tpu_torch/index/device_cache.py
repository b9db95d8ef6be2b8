"""LRU cache of device-resident indexes (counterpart of
``dial_rag_tpu/index/device_cache.py``, which it copies).

The reference rebuilds its index objects per request from the
deserialized document records. On the card that rebuild uploads the
chunk matrix (and the BM25, chargram and MaxSim tensors) to device memory
again, which repeat queries against the same documents should not pay.
This cache keys a built index by the records' content tokens (the
``cache_token`` that storage stamps on every stored or loaded record) and
the retriever's configuration. A record without a token (never
persisted) disables caching for its record set. Eviction is LRU by bytes.
"""

import logging
import time
from collections import OrderedDict
from threading import Lock, Thread

logger = logging.getLogger(__name__)

DEFAULT_CAPACITY_BYTES = 1 << 30  # 1 GiB of device memory for cached indexes


class DeviceIndexCache:
    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY_BYTES):
        self.capacity_bytes = capacity_bytes
        self._entries: OrderedDict = OrderedDict()
        self._building: dict = {}  # key -> Lock (single-flight)
        self._size = 0
        self._lock = Lock()
        self._warm_threads: list[Thread] = []
        self.hits = 0
        self.misses = 0

    def get_or_build(self, records: list, config_key: tuple, builder, warm=None):
        """The cached index for (record tokens, config_key), or
        ``builder()``'s, inserted. ``builder()`` returns an object with an
        ``nbytes`` attribute. Concurrent first requests for one key build
        it once (single flight): one thread uploads, the rest wait.

        ``warm(index)``, when given, runs on a daemon thread right after a
        miss inserts the new index (``warm_query_buckets``: the first
        launches at every wave bucket, off the request path). It never
        runs on hits and never blocks the building request."""
        tokens = [getattr(r, "cache_token", None) for r in records]
        if not records or any(t is None for t in tokens):
            return builder()  # unpersisted records: no stable identity
        key = (tuple(tokens), config_key)
        with self._lock:
            index = self._entries.get(key)
            if index is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return index
            build_lock = self._building.get(key)
            if build_lock is None:
                build_lock = Lock()
                self._building[key] = build_lock
        with build_lock:
            with self._lock:
                index = self._entries.get(key)
                if index is not None:  # a racer finished the build
                    self.hits += 1
                    return index
            try:
                index = builder()
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                raise
            with self._lock:
                # insert before the build lock leaves _building: popping it
                # first would let a newcomer see neither and build again
                replaced = self._entries.pop(key, None)
                if replaced is not None:
                    self._size -= replaced.nbytes
                self._entries[key] = index
                self._size += index.nbytes
                self.misses += 1
                while self._size > self.capacity_bytes and len(self._entries) > 1:
                    _, evicted = self._entries.popitem(last=False)
                    self._size -= evicted.nbytes
                self._building.pop(key, None)
            if warm is not None:
                self._spawn_warm(warm, index)
        return index

    def _spawn_warm(self, warm, index) -> None:
        def run():
            try:
                warm(index)
            except Exception:
                logger.warning("index warm-up failed", exc_info=True)

        t = Thread(target=run, daemon=True, name="index-warm")
        with self._lock:
            self._warm_threads = [w for w in self._warm_threads if w.is_alive()]
            self._warm_threads.append(t)
        t.start()

    def wait_warm(self, timeout: float) -> bool:
        """Waits up to ``timeout`` seconds in all for the warm-up threads
        (benchmarks and tests keep warm-ups out of timed runs); True when
        none is still running."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._warm_threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in threads)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def size_bytes(self) -> int:
        return self._size


def cached_build(device_cache: DeviceIndexCache | None, records: list, config_key: tuple, builder, warm=None):
    """``builder()``'s index, through ``device_cache`` when there is one."""
    if device_cache is None:
        return builder()
    return device_cache.get_or_build(records, config_key, builder, warm=warm)
