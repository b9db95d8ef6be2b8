from dial_rag_tpu_torch.storage.serialization import (
    deserialize_record,
    serialize_record,
)
from dial_rag_tpu_torch.storage.storage import (
    CachedStorage,
    IndexStorage,
    IndexStorageHolder,
    LocalFileStorage,
    LRUCacheStorage,
)

__all__ = [
    "serialize_record",
    "deserialize_record",
    "LRUCacheStorage",
    "LocalFileStorage",
    "CachedStorage",
    "IndexStorage",
    "IndexStorageHolder",
]
