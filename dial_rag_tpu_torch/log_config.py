"""Logging configuration (mirror of reference log_config.py): root level
from LOG_LEVEL, per-module overrides from LOG_LEVEL_OVERRIDE
("module=LEVEL,module2=LEVEL"), uvicorn-style formatter.

The logging half of ``dial_rag_tpu/log_config.py``: its telemetry half
(the OpenTelemetry provider and instrumentation) waits for ROADMAP item
9c with telemetry's tracing half."""

import logging
import os
import sys

LOG_FORMAT = "%(levelname)s:%(asctime)s:%(name)s:%(lineno)d: %(message)s"


def init_logging(level: str | None = None):
    level = level or os.environ.get("LOG_LEVEL", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    try:
        root.setLevel(level.upper())
    except ValueError:
        root.setLevel(logging.INFO)
        root.warning(f"Unknown LOG_LEVEL {level!r}; defaulting to INFO")

    overrides = os.environ.get("LOG_LEVEL_OVERRIDE", "")
    for item in overrides.split(","):
        if "=" in item:
            name, mod_level = item.split("=", 1)
            try:
                logging.getLogger(name.strip()).setLevel(
                    mod_level.strip().upper()
                )
            except ValueError:
                root.warning(
                    f"Ignoring invalid LOG_LEVEL_OVERRIDE entry {item!r}"
                )
