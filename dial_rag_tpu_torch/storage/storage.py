"""Index storage: byte-bounded LRU cache + pluggable file backends.

Mirrors the reference's composition (aidial_rag/index_storage.py:47-186):
a size-bounded in-memory LRU (default 128 MiB) optionally write-through to
a remote file store (Dial File API) or a local directory; loads validate
format version and index settings and treat any mismatch or deserialization
failure as a miss (rebuild). The persisted index IS the checkpoint/resume
system: per-document, content-addressed (SURVEY.md §5)."""

import asyncio
import hashlib
import logging
from abc import ABC, abstractmethod
from collections import OrderedDict
from pathlib import Path

from dial_rag_tpu_torch.errors import InvalidAttachmentError
from dial_rag_tpu_torch.documents.model import (
    FORMAT_VERSION,
    DocumentRecord,
    IndexSettings,
)
from dial_rag_tpu_torch.storage.serialization import (
    deserialize_record,
    serialize_record,
)

logger = logging.getLogger(__name__)

DEFAULT_CACHE_CAPACITY = 128 * 1024 * 1024  # reference default 128MiB

# Number of characters per directory segment of the index path. Part of the
# algorithm, not configuration: changing it orphans existing index files
# (reference indexing_task.py:36-39).
INDEX_PATH_PART_SIZE = 8


def link_to_index_url(document_link: str, bucket_id: str) -> str:
    """Content-addressed index path: sha256 of the document link split into
    8-char directory segments (reference indexing_task.py:35-49)."""
    key = hashlib.sha256(document_link.encode()).hexdigest()
    dir_path = "/".join(
        key[i : i + INDEX_PATH_PART_SIZE]
        for i in range(0, len(key), INDEX_PATH_PART_SIZE)
    )
    return f"files/{bucket_id}/dial-rag-index/{dir_path}/index.bin"


class IndexStorageBackend(ABC):
    @abstractmethod
    async def load(self, url: str) -> bytes | None: ...

    @abstractmethod
    async def store(self, url: str, data: bytes) -> dict: ...

    async def validator(self, url: str) -> object | None:
        """Cheap content-change token (e.g. a stat fingerprint), or
        None when the backend cannot provide one. Contract: any change
        to the stored content MUST change the token. Lets the record
        memo serve a decoded record without re-reading the bytes — at
        corpus scale the read+sha of a multi-GB record dominates
        request latency even on memo hits."""
        return None


class LRUCacheStorage(IndexStorageBackend):
    """Byte-size-bounded LRU (first-party; cachetools is not in the image)."""

    def __init__(self, capacity: int = DEFAULT_CACHE_CAPACITY):
        self._capacity = capacity
        self._size = 0
        self._cache: OrderedDict[str, bytes] = OrderedDict()

    async def load(self, url: str) -> bytes | None:
        from dial_rag_tpu_torch import telemetry

        data = self._cache.get(url)
        if data is not None:
            self._cache.move_to_end(url)
            telemetry.get_counter("dial_rag.index_cache.hits").add(1)
        else:
            telemetry.get_counter("dial_rag.index_cache.misses").add(1)
        return data

    async def store(self, url: str, data: bytes) -> dict:
        if len(data) > self._capacity:
            return {}  # too large to cache at all
        if url in self._cache:
            self._size -= len(self._cache.pop(url))
        self._cache[url] = data
        self._size += len(data)
        while self._size > self._capacity:
            _, evicted = self._cache.popitem(last=False)
            self._size -= len(evicted)
        return {}

    def drop(self, url: str) -> None:
        data = self._cache.pop(url, None)
        if data is not None:
            self._size -= len(data)

    @property
    def size(self) -> int:
        return self._size


class LocalFileStorage(IndexStorageBackend):
    """Filesystem backend (self-hosted deployments without Dial Core)."""

    def __init__(self, root: str):
        self._root = Path(root).resolve()

    def _path(self, url: str) -> Path:
        # index URLs can be user-supplied (index attachments); refuse any
        # path that escapes the storage root ('..' traversal)
        path = (self._root / url.lstrip("/")).resolve()
        if not path.is_relative_to(self._root):
            raise InvalidAttachmentError(
                f"Index path escapes the storage root: {url}"
            )
        return path

    async def load(self, url: str) -> bytes | None:
        path = self._path(url)

        def read():
            try:
                return path.read_bytes()
            except FileNotFoundError:
                return None

        return await asyncio.get_running_loop().run_in_executor(None, read)

    async def store(self, url: str, data: bytes) -> dict:
        path = self._path(url)

        def write():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(data)
            tmp.replace(path)  # atomic within the same filesystem

        await asyncio.get_running_loop().run_in_executor(None, write)
        return {"url": url}

    async def validator(self, url: str) -> object | None:
        path = self._path(url)  # same traversal guard as load/store

        def stat():
            try:
                st = path.stat()
            except FileNotFoundError:
                return None
            # inode changes on the tmp+replace store above; mtime_ns +
            # size cover in-place rewrites by other writers
            return ("stat", st.st_ino, st.st_size, st.st_mtime_ns)

        return await asyncio.get_running_loop().run_in_executor(None, stat)


class CachedStorage(IndexStorageBackend):
    """Read-through/write-through LRU in front of a slower backend.

    When the backend provides a content-change validator, LRU hits are
    revalidated against it (one stat-grade call per load), so an
    out-of-band rewrite of the backing store — e.g. another replica
    re-minting an index — is picked up instead of served stale for as
    long as the bytes stay cached."""

    _VTOKEN_CAP = 1024

    def __init__(self, storage: IndexStorageBackend, cache: LRUCacheStorage):
        self._storage = storage
        self._cache = cache
        self._vtokens: OrderedDict[str, object] = OrderedDict()

    def _remember(self, url: str, vtoken: object) -> None:
        self._vtokens[url] = vtoken
        self._vtokens.move_to_end(url)
        while len(self._vtokens) > self._VTOKEN_CAP:
            self._vtokens.popitem(last=False)

    async def load(self, url: str) -> bytes | None:
        vtoken = await self._storage.validator(url)
        data = await self._cache.load(url)  # counts the hit/miss
        if data is not None:
            if vtoken is None or self._vtokens.get(url) == vtoken:
                return data
            self._cache.drop(url)  # content changed behind the cache
        data = await self._storage.load(url)
        if data is not None:
            await self._cache.store(url, data)
            if vtoken is not None:
                self._remember(url, vtoken)
        return data

    async def store(self, url: str, data: bytes) -> dict:
        await self._cache.store(url, data)
        result = await self._storage.store(url, data)
        vtoken = await self._storage.validator(url)
        if vtoken is not None:
            self._remember(url, vtoken)
        return result

    async def validator(self, url: str) -> object | None:
        return await self._storage.validator(url)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class RecordMemo:
    """Deserialized-record LRU shared across requests.

    At corpus scale the per-request cost is NOT the byte cache but
    deserialize_record (msgpack decode of a multi-hundred-MB record)
    plus the sha256 over its bytes — ~1 s/request at 1M chunks, which
    would dominate service latency. Keyed by (index_url, content sha),
    so a re-minted index at the same URL misses. The memo'd record is
    SHARED across concurrent requests: DocumentRecord is treated as
    read-only everywhere after construction (retrievers only read), and
    cache_token is re-stamped with an identical value.

    sha256 itself is memoized by bytes-object identity per URL: the
    byte LRU returns the same object while cached, so repeat requests
    skip the hash too. The memo entry holds a reference to the bytes it
    hashed — identity comparison is only sound while that object is
    alive (CPython recycles id() after free, which could otherwise
    return a stale digest for different bytes at a reused address).
    That reference pins the blob, so pinned BYTES are budgeted, not
    just entry count: an entry can only ever hit again while the byte
    LRU still serves the same object, so pinning more than the byte
    cache's own budget is pure waste (a blob too large for the byte
    cache is re-loaded as a fresh object every request and can never
    identity-match — those are not memoized at all)."""

    def __init__(
        self,
        max_records: int = 4,
        max_sha_entries: int = 64,
        max_sha_bytes: int = 128 << 20,
    ):
        self._cap = max_records
        self._sha_cap = max_sha_entries
        self._sha_bytes_cap = max_sha_bytes
        self._sha_bytes = 0
        self._records: OrderedDict[tuple, DocumentRecord] = OrderedDict()
        self._sha_by_url: OrderedDict[str, tuple[bytes, str]] = OrderedDict()
        # url -> (backend validator token, record cache token): lets a
        # repeat load skip reading the bytes entirely when the backend
        # attests (cheaply, e.g. by stat) that the content is unchanged
        self._vtoken_by_url: OrderedDict[str, tuple[object, tuple]] = (
            OrderedDict()
        )

    def sha(self, url: str, data: bytes) -> str:
        memo = self._sha_by_url.get(url)
        if memo is not None and memo[0] is data:
            self._sha_by_url.move_to_end(url)
            return memo[1]
        digest = _sha256(data)
        if len(data) > self._sha_bytes_cap:
            return digest
        old = self._sha_by_url.pop(url, None)
        if old is not None:
            self._sha_bytes -= len(old[0])
        self._sha_by_url[url] = (data, digest)
        self._sha_bytes += len(data)
        while self._sha_by_url and (
            len(self._sha_by_url) > self._sha_cap
            or self._sha_bytes > self._sha_bytes_cap
        ):
            _, (evicted, _d) = self._sha_by_url.popitem(last=False)
            self._sha_bytes -= len(evicted)
        return digest

    def record_token_for(self, url: str, vtoken: object) -> tuple | None:
        memo = self._vtoken_by_url.get(url)
        if memo is not None and memo[0] == vtoken:
            self._vtoken_by_url.move_to_end(url)
            return memo[1]
        return None

    def remember_validator(
        self, url: str, vtoken: object, record_token: tuple
    ) -> None:
        self._vtoken_by_url[url] = (vtoken, record_token)
        self._vtoken_by_url.move_to_end(url)
        while len(self._vtoken_by_url) > self._sha_cap:
            self._vtoken_by_url.popitem(last=False)

    def get(self, token: tuple) -> DocumentRecord | None:
        record = self._records.get(token)
        if record is not None:
            self._records.move_to_end(token)
        return record

    def put(self, token: tuple, record: DocumentRecord) -> None:
        self._records[token] = record
        self._records.move_to_end(token)
        while len(self._records) > self._cap:
            self._records.popitem(last=False)


class IndexStorage:
    """Typed record load/store with version + settings invalidation."""

    def __init__(
        self, backend: IndexStorageBackend, memo: RecordMemo | None = None
    ):
        self._backend = backend
        self._memo = memo

    async def load(
        self, index_url: str, index_settings: IndexSettings
    ) -> DocumentRecord | None:
        from dial_rag_tpu_torch import telemetry

        vtoken = None
        if self._memo is not None:
            # validated fast path: when the backend attests (cheaply,
            # e.g. by stat) that the stored content is unchanged since
            # the memo'd decode, serve the record without re-reading the
            # bytes — at corpus scale the read+sha of a multi-GB record
            # dominates request latency even on decode-memo hits. A
            # changed content flips the token (backend contract) and
            # falls through to the full read+sha+decode below.
            vtoken = await self._backend.validator(index_url)
            if vtoken is not None:
                token = self._memo.record_token_for(index_url, vtoken)
                record = (
                    self._memo.get(token) if token is not None else None
                )
                if record is not None:
                    telemetry.get_counter(
                        "dial_rag.record_memo.validated_hits"
                    ).add(1)
                    return self._checked(record, token, index_url,
                                         index_settings)
        data = await self._backend.load(index_url)
        if data is None:
            return None
        token = (
            (index_url, self._memo.sha(index_url, data))
            if self._memo is not None
            else (index_url, _sha256(data))
        )
        record = self._memo.get(token) if self._memo is not None else None
        if record is None:
            try:
                record = deserialize_record(data)
            except Exception as e:
                logger.warning(
                    f"Failed to deserialize index {index_url}: {e}"
                )
                return None
        result = self._checked(record, token, index_url, index_settings)
        if result is not None and self._memo is not None:
            self._memo.put(token, record)
            if vtoken is not None:
                # the pre-read vtoken: if the file changed between stat
                # and read this remembers a stale token, which can only
                # cause a harmless extra full load next time
                self._memo.remember_validator(index_url, vtoken, token)
        return result

    def _checked(
        self, record, token, index_url: str, index_settings: IndexSettings
    ) -> DocumentRecord | None:
        # version/settings checks run on memo hits too: the memo skips
        # decode (and, validated, read+sha) cost, never invalidation
        # (e.g. an embedder change makes the expected settings differ
        # from the memo'd record's)
        if record.format_version != FORMAT_VERSION:
            logger.warning(
                f"Index format version mismatch for {index_url}: "
                f"{record.format_version}"
            )
            return None
        if record.index_settings != index_settings:
            logger.warning(f"Index settings mismatch for {index_url}")
            return None
        record.cache_token = token
        return record

    async def store(self, index_url: str, record: DocumentRecord) -> dict:
        data = serialize_record(record)
        # stamp the same identity a future load of these bytes will get,
        # so device-index cache entries survive from first build onward
        token = (index_url, _sha256(data))
        record.cache_token = token
        logger.debug(f"Stored index at {index_url} ({len(data)} bytes)")
        result = await self._backend.store(index_url, data)
        if self._memo is not None:
            # prime the memo with the just-built record so the first
            # request after indexing skips the read+sha+decode too
            self._memo.put(token, record)
            vtoken = await self._backend.validator(index_url)
            if vtoken is not None:
                self._memo.remember_validator(index_url, vtoken, token)
        return result


class IndexStorageHolder:
    """Process-wide cache shared across per-request storage instances
    (reference IndexStorageHolder, index_storage.py:168-186)."""

    def __init__(self, capacity: int = DEFAULT_CACHE_CAPACITY):
        self._cache = LRUCacheStorage(capacity)
        self._records = RecordMemo()

    def get_storage(
        self, remote_backend: IndexStorageBackend | None = None
    ) -> IndexStorage:
        if remote_backend is None:
            return IndexStorage(self._cache, memo=self._records)
        return IndexStorage(
            CachedStorage(remote_backend, self._cache), memo=self._records
        )
