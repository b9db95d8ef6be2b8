from dial_rag_tpu_torch.documents.model import (
    FORMAT_VERSION,
    Chunk,
    DocumentRecord,
    IndexSettings,
    build_chunks_list,
)

__all__ = [
    "FORMAT_VERSION",
    "Chunk",
    "DocumentRecord",
    "IndexSettings",
    "build_chunks_list",
]
