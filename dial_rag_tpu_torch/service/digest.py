"""Provenance digests recorded into choice state (mirror of reference
config_digest.py + repository_digest.py): which config came from where,
and which build served the request."""

import json
import logging
import subprocess
from dataclasses import asdict, dataclass, field

from dial_rag_tpu_torch import __version__

logger = logging.getLogger(__name__)


@dataclass
class RepositoryDigest:
    version: str = __version__
    status: str = "unknown"


DEFAULT_DIGEST_PATH = "/opt/repository-digest.json"


def read_repository_digest(path: str | None = None) -> RepositoryDigest:
    """Baked digest file if present (container builds bake it at
    /opt/repository-digest.json like the reference — app.py:200-207;
    overridable via REPOSITORY_DIGEST_PATH), else git describe."""
    if path is None:
        import os

        path = os.environ.get("REPOSITORY_DIGEST_PATH", DEFAULT_DIGEST_PATH)
    if path:
        try:
            with open(path) as f:
                data = json.load(f)
            return RepositoryDigest(
                version=data.get("version", __version__),
                status=data.get("status", "unknown"),
            )
        except (OSError, json.JSONDecodeError):
            pass
    try:
        version = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            capture_output=True,
            text=True,
            timeout=5,
        ).stdout.strip()
        if version:
            return RepositoryDigest(version=version, status="git")
    except (OSError, subprocess.SubprocessError):
        pass
    return RepositoryDigest()


@dataclass
class ConfigDigest:
    app_config_path: str
    configuration: dict
    from_custom_configuration: dict = field(default_factory=dict)
    from_commands: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)
