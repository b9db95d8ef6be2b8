"""The counter half of ``dial_rag_tpu/telemetry.py``: a first-party
counter registry (``get_counter``, ``metrics``) that storage and the
service count through; and of the tracing half, the disabled path only
(``span``, ``tracer``, ``provider``, ``set_provider``): every span is
non-recording, as the JAX package's are when no provider is set or
``OTEL_SDK_DISABLED=true``.

The recording spans, providers and OTLP exporters (with the registry's
OTLP snapshot) need ``opentelemetry``, which the card's machine lacks;
they wait for ROADMAP item 9c.
"""

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Mapping, Optional


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


# --------------------------------------------------------------------------
# tracing: the disabled path


class NonRecordingSpan:
    """A span that records nothing (OpenTelemetry's ``NonRecordingSpan``)."""

    def set_attribute(self, key: str, value) -> None:
        pass

    def set_status(self, status, description: Optional[str] = None) -> None:
        pass

    def record_exception(self, exception: BaseException, attributes=None, timestamp=None, escaped=False) -> None:
        pass

    def end(self, end_time=None) -> None:
        pass


class _DisabledTracer:
    def start_span(self, name: str, context=None, kind=None, attributes=None, **kw) -> NonRecordingSpan:
        return NonRecordingSpan()

    @contextmanager
    def start_as_current_span(self, name: str, context=None, kind=None, attributes=None,
                              **kw) -> Iterator[NonRecordingSpan]:
        yield NonRecordingSpan()


_PROVIDER = None
_DISABLED_TRACER = _DisabledTracer()


def provider():
    return _PROVIDER


def set_provider(p) -> None:
    """Test hook of the JAX package: swap the module-level provider. The
    port has only the disabled path, so ``None`` is the one provider it
    takes."""
    global _PROVIDER
    if p is not None:
        raise NotImplementedError(
            "recording spans need the tracing half of telemetry, which waits for ROADMAP item 9c"
        )
    _PROVIDER = p


def tracer() -> _DisabledTracer:
    return _DISABLED_TRACER


@contextmanager
def span(name: str, **attributes) -> Iterator[NonRecordingSpan]:
    """The one-liner the service code uses: a non-recording span."""
    with tracer().start_as_current_span(name, attributes=attributes) as s:
        yield s
