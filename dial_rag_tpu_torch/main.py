"""Server entrypoint: ``python -m dial_rag_tpu_torch.main`` (mirror of
reference main.py running uvicorn; here the port's own HTTP server,
``service/http.py``). Serves on ``PORT`` (default 5000) with the app
built from ``load_app_config()`` (``DIAL_RAG__*`` env, the YAML at
``DIAL_RAG__CONFIG_PATH``) on the card; it raises when no GPU is
present."""

import os

from dial_rag_tpu_torch.log_config import init_logging

init_logging()

from dial_rag_tpu_torch.service import http  # noqa: E402
from dial_rag_tpu_torch.service.app import create_app  # noqa: E402
from dial_rag_tpu_torch.service.config import load_app_config  # noqa: E402


def main():
    app_config = load_app_config()
    app = create_app(app_config)
    port = int(os.environ.get("PORT", "5000"))
    http.run_app(app, host="0.0.0.0", port=port)


if __name__ == "__main__":
    main()
