"""DocumentRecord serialization: typed msgpack + gzip, no pickle.

The reference persists records as docarray pickle+gzip
(aidial_rag/index_storage.py:44), which is unsafe to load from shared
storage. This container is a closed, typed schema: numpy arrays are
(dtype, shape, raw bytes) triples, everything else is plain msgpack data.
Unknown keys or types fail deserialization, which the storage layer treats
as a cache miss -> rebuild. The msgpack codec is the port's own
(``_msgpack``), byte for byte what ``msgpack`` writes for these types.
"""

import gzip

import numpy as np

from dial_rag_tpu_torch.documents.model import (
    Chunk,
    DocumentRecord,
    IndexSettings,
)
from dial_rag_tpu_torch.storage import _msgpack as msgpack

_ND = "__nd__"


def _pack_array(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        _ND: True,
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": arr.tobytes(),
    }


def _unpack_array(obj: dict) -> np.ndarray:
    return np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"])).reshape(
        obj["shape"]
    )


def _pack_multi(multi) -> list | None:
    if multi is None:
        return None
    return [_pack_array(np.asarray(a, dtype=np.float32)) for a in multi]


def _unpack_multi(obj) -> list | None:
    if obj is None:
        return None
    return [_unpack_array(a) for a in obj]


def serialize_record(record: DocumentRecord, compresslevel: int = 1) -> bytes:
    payload = {
        "format_version": record.format_version,
        "index_settings": record.index_settings.indexes,
        "chunks": [{"text": c.text, "metadata": c.metadata} for c in record.chunks],
        "text_index": record.text_index,
        "embeddings_index": _pack_multi(record.embeddings_index),
        "multimodal_embeddings_index": _pack_multi(
            record.multimodal_embeddings_index
        ),
        "description_embeddings_index": _pack_multi(
            record.description_embeddings_index
        ),
        "late_interaction_index": _pack_multi(record.late_interaction_index),
        "chargram_index": record.chargram_index,
        "mime_type": record.mime_type,
        "document_bytes": record.document_bytes,
    }
    return gzip.compress(
        msgpack.packb(payload, use_bin_type=True), compresslevel=compresslevel
    )


def deserialize_record(data: bytes) -> DocumentRecord:
    payload = msgpack.unpackb(
        gzip.decompress(data), raw=False, strict_map_key=False
    )
    return DocumentRecord(
        format_version=payload["format_version"],
        index_settings=IndexSettings(indexes=payload["index_settings"]),
        chunks=[
            Chunk(text=c["text"], metadata=c["metadata"])
            for c in payload["chunks"]
        ],
        text_index=payload["text_index"],
        embeddings_index=_unpack_multi(payload["embeddings_index"]),
        multimodal_embeddings_index=_unpack_multi(
            payload["multimodal_embeddings_index"]
        ),
        description_embeddings_index=_unpack_multi(
            payload["description_embeddings_index"]
        ),
        late_interaction_index=_unpack_multi(
            # .get: v1 records lack the key (they are discarded by the
            # FORMAT_VERSION check anyway, but deserialization must not
            # be the thing that fails)
            payload.get("late_interaction_index")
        ),
        # .get: records persisted before the chargram arm lack the key;
        # enabling the arm changes IndexSettings, which triggers the
        # rebuild — deserialization itself must not fail
        chargram_index=payload.get("chargram_index"),
        mime_type=payload["mime_type"],
        document_bytes=payload["document_bytes"],
    )
