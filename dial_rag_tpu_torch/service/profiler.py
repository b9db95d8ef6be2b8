"""Opt-in per-request profiling (``use_profiler``): the port's
counterpart of ``dial_rag_tpu/service/profiler.py`` serves the disabled
path only. The profile (a sampling wall-clock tree with cProfile's table)
waits for ROADMAP item 9c, with ``utils/sampling_profiler.py``."""

from contextlib import asynccontextmanager

from dial_rag_tpu_torch.errors import NotPortedError
from dial_rag_tpu_torch.service.protocol import Choice


@asynccontextmanager
async def profiler_if_enabled(choice: Choice, enabled: bool):
    if enabled:
        raise NotPortedError(
            "The request profiler (use_profiler) is not ported yet "
            "(ROADMAP item 9c)"
        )
    yield
