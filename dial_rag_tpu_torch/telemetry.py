"""The counter half of ``dial_rag_tpu/telemetry.py``: a first-party
counter registry (``get_counter``, ``metrics``) that storage counts its
cache hits and misses through.

The tracing half (spans, providers and the OTLP exporters, with the
registry's OTLP snapshot) needs ``opentelemetry``, which the card's
machine lacks; it comes with the service layer.
"""

import threading
import time
from typing import Mapping, Optional


class Counter:
    def __init__(self, name: str, registry: "_MetricsRegistry"):
        self.name = name
        self._registry = registry

    def add(self, amount: int | float, attributes: Optional[Mapping] = None):
        self._registry._add(self.name, amount, attributes)


class _MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._start_ns = time.time_ns()
        # name -> {frozenset(attr items) -> cumulative value}
        self._counters: dict[str, dict[frozenset, float]] = {}

    def _add(self, name, amount, attributes):
        key = frozenset((attributes or {}).items())
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0) + amount

    def snapshot(self) -> dict[str, dict[frozenset, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._counters.items()}

    def value(self, name: str, attributes: Optional[Mapping] = None) -> float:
        key = frozenset((attributes or {}).items())
        with self._lock:
            return self._counters.get(name, {}).get(key, 0)

    def total(self, name: str) -> float:
        """Sum over all attribute series of one counter."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


_REGISTRY = _MetricsRegistry()


def get_counter(name: str) -> Counter:
    return Counter(name, _REGISTRY)


def metrics() -> _MetricsRegistry:
    return _REGISTRY
