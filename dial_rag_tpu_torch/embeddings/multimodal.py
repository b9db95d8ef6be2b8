"""Remote multimodal embeddings over the Dial embeddings API (mirror of the
JAX package's ``embeddings/multimodal.py`` on the port's HTTP client,
``service/http.py``): images ride the DIAL ``custom_input`` extension,
queries use the standard input."""

import asyncio
import logging

import numpy as np

from dial_rag_tpu_torch.service import http

MULTIMODAL_EMBEDDING_TIMEOUT: float = 60
API_VERSION = "2023-03-15-preview"

logger = logging.getLogger(__name__)


class MultimodalEmbeddingsClient:
    def __init__(
        self,
        dial_url: str,
        api_key: str,
        embeddings_model: str,
        max_retries: int = 0,
    ):
        self.dial_url = dial_url
        self.api_key = api_key
        self.model = embeddings_model
        self.max_retries = max_retries

    @property
    def _url(self) -> str:
        return f"{self.dial_url}/openai/deployments/{self.model}/embeddings"

    async def _create(self, body: dict) -> np.ndarray:
        attempt = 0
        while True:
            try:
                timeout = http.ClientTimeout(total=MULTIMODAL_EMBEDDING_TIMEOUT)
                async with http.ClientSession(timeout=timeout) as session:
                    async with session.post(
                        self._url,
                        params={"api-version": API_VERSION},
                        headers={"api-key": self.api_key},
                        json=body,
                    ) as response:
                        response.raise_for_status()
                        data = await response.json()
                assert len(data["data"]) == 1
                return np.array(data["data"][0]["embedding"], dtype=np.float32)
            except (http.ClientError, TimeoutError) as e:
                # effectively-infinite retries are bounded by the caller's
                # computed wall-clock timeout (reference MAX_RETRIES=1e9)
                attempt += 1
                if attempt > self.max_retries:
                    status = getattr(e, "status", None)
                    if status == 429:
                        # a rate-limit storm must collapse to a single
                        # 429, not an opaque 500 (reference
                        # errors.py:84-106 unwraps RateLimitError the
                        # same way)
                        from dial_rag_tpu_torch.errors import RateLimitError

                        raise RateLimitError(
                            f"Rate limit exceeded for {self.model}"
                        ) from e
                    raise
                logger.warning(f"multimodal embedding retry {attempt}: {e}")
                await asyncio.sleep(min(2.0 * attempt, 30.0))

    async def aembed_image(self, image_base64: str) -> np.ndarray:
        return await self._create(
            {
                "input": [],
                "encoding_format": "float",
                "custom_input": [
                    {"type": "image/png", "data": image_base64}
                ],
            }
        )

    async def aembed_query(self, text: str) -> np.ndarray:
        return await self._create(
            {"input": [text], "encoding_format": "float"}
        )
