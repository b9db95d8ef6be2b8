"""Dial Core HTTP clients: bucket/file API, user limits, document download
(mirrors dial_api_client.py, dial_user_limits.py, document_loaders.py
download paths)."""

import logging

from dial_rag_tpu_torch.service import http

from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.runtime.limited import TokenStats, UserLimitsForModel
from dial_rag_tpu_torch.service.config import HttpClientConfig
from dial_rag_tpu_torch.service.request_context import RequestContext
from dial_rag_tpu_torch.storage.storage import IndexStorageBackend

logger = logging.getLogger(__name__)

INDEX_MIME_TYPE = "application/x.aidial-rag.index.v1+tpu"


def _client_timeout(config: HttpClientConfig) -> http.ClientTimeout:
    return http.ClientTimeout(
        total=config.timeout_seconds,
        connect=config.connect_timeout_seconds,
        sock_connect=config.connect_timeout_seconds,
    )


def _require_dial_relative(url: str) -> str:
    """The File API client only ever talks to Dial Core. An absolute URL
    here would win over the session base_url and ship the caller's
    api-key header (and the uploaded index bytes) to an arbitrary host —
    a key-exfiltration channel via user-supplied index attachments."""
    if "://" in url.split("?", 1)[0] or url.startswith("//"):
        raise InvalidDocumentError(
            f"Dial file paths must be relative to the Dial API: {url}"
        )
    return url.lstrip("/")


class DialApiClient:
    def __init__(self, dial_api_base_url: str, headers: dict, bucket_id: str):
        self.bucket_id = bucket_id
        self._base_url = dial_api_base_url
        self._headers = headers

    async def get_file(self, relative_url: str) -> bytes | None:
        relative_url = _require_dial_relative(relative_url)
        async with http.ClientSession(base_url=self._base_url) as session:
            async with session.get(
                relative_url, headers=self._headers
            ) as response:
                response.raise_for_status()
                return await response.read()

    async def head_file(self, relative_url: str) -> dict | None:
        """HEAD metadata for a stored file (lower-cased header map), or
        None when the server does not serve HEAD for it."""
        relative_url = _require_dial_relative(relative_url)
        async with http.ClientSession(base_url=self._base_url) as session:
            async with session.head(
                relative_url, headers=self._headers
            ) as response:
                if response.status != 200:
                    return None
                return {
                    k.lower(): v for k, v in response.headers.items()
                }

    async def put_file(
        self, relative_url: str, data: bytes, content_type: str
    ) -> dict:
        import io

        relative_url = _require_dial_relative(relative_url)
        form = http.FormData()
        form.add_field(
            "file",
            io.BytesIO(data),
            filename=relative_url,
            content_type=content_type,
        )
        async with http.ClientSession(base_url=self._base_url) as session:
            async with session.put(
                relative_url, data=form, headers=self._headers
            ) as response:
                response.raise_for_status()
                return await response.json()


async def create_dial_api_client(
    request_context: RequestContext,
) -> DialApiClient:
    headers = request_context.get_api_key_headers()
    async with http.ClientSession(
        base_url=request_context.dial_base_url
    ) as session:
        async with session.get("bucket", headers=headers) as response:
            response.raise_for_status()
            bucket_id = (await response.json())["bucket"]
    return DialApiClient(request_context.dial_base_url, headers, bucket_id)


class DialFileStorage(IndexStorageBackend):
    """Index storage backend over the Dial File API."""

    def __init__(self, dial_api_client: DialApiClient):
        self._client = dial_api_client

    async def load(self, url: str) -> bytes | None:
        try:
            return await self._client.get_file(url)
        except http.ClientError as e:
            logger.warning(f"Failed to load index from {url}: {e}")
            return None

    async def store(self, url: str, data: bytes) -> dict:
        return await self._client.put_file(url, data, INDEX_MIME_TYPE)

    async def validator(self, url: str) -> object | None:
        """Content-change token from HEAD metadata (one RTT instead of
        re-downloading a multi-GB index to rehash it). Only an ETag or
        Last-Modified qualifies — Content-Length alone cannot attest
        that content is unchanged."""
        try:
            headers = await self._client.head_file(url)
        except http.ClientError:
            return None
        if not headers:
            return None
        etag = headers.get("etag")
        last_modified = headers.get("last-modified")
        if not etag and not last_modified:
            return None
        return ("head", etag, last_modified, headers.get("content-length"))


async def get_user_limits_for_model(
    dial_url: str, api_key: str, model_name: str
) -> UserLimitsForModel:
    """GET /v1/deployments/{model}/limits (reference dial_user_limits.py)."""
    async with http.ClientSession(base_url=f"{dial_url}/v1/") as session:
        async with session.get(
            f"deployments/{model_name}/limits",
            headers={"api-key": api_key},
        ) as response:
            response.raise_for_status()
            data = await response.json()
    minute = data.get("minuteTokenStats", {})
    day = data.get("dayTokenStats", {})
    return UserLimitsForModel(
        minute_token_stats=TokenStats(
            total=minute.get("total", 0), used=minute.get("used", 0)
        ),
        day_token_stats=TokenStats(
            total=day.get("total", 0), used=day.get("used", 0)
        ),
    )


async def download_attachment(
    url: str, headers: dict, download_config: HttpClientConfig | None = None
) -> tuple[str, bytes]:
    """Returns (content_type, bytes); reference document_loaders.py:87-99."""
    download_config = download_config or HttpClientConfig()
    async with http.ClientSession() as session:
        async with session.get(
            url, headers=headers, timeout=_client_timeout(download_config)
        ) as response:
            response.raise_for_status()
            content_type = response.headers.get("Content-Type", "")
            content = await response.read()
            logger.debug(f"Downloaded {url}: {len(content)} bytes")
            return content_type, content


async def load_attachment(
    absolute_url: str,
    display_name: str,
    headers: dict,
    download_config: HttpClientConfig | None = None,
) -> tuple[str, bytes]:
    content_type, attachment_bytes = await download_attachment(
        absolute_url, headers, download_config
    )
    if not attachment_bytes:
        raise InvalidDocumentError(
            f"Attachment {display_name}, can't be read properly"
        )
    return content_type, attachment_bytes


async def check_document_access(
    request_context: RequestContext,
    metadata_url: str,
    config: HttpClientConfig | None = None,
) -> dict:
    """Metadata GET doubles as the access check (documents.py:66)."""
    config = config or HttpClientConfig()
    headers = request_context.get_file_access_headers(metadata_url)
    async with http.ClientSession(
        timeout=_client_timeout(config)
    ) as session:
        async with session.get(metadata_url, headers=headers) as response:
            if not response.ok:
                raise InvalidDocumentError(
                    f"{response.status} {response.reason}"
                )
            return await response.json()
