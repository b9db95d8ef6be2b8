"""The parts of ``dial_rag_tpu/documents/model.py`` the semantic retriever
uses: chunks and the per-chunk embedding lists of a document record.

``MultiEmbeddings`` is a list with one ``[m, D]`` float32 array per chunk
(a chunk may carry several embedding rows).
"""

from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.index.dense_index import DocEmbeddings

MultiEmbeddings = list  # list[np.ndarray [m, D] f32]


@dataclass
class Chunk:
    text: str
    metadata: dict


def build_chunks_list(chunk_docs: list[tuple[str, dict]]) -> list[Chunk]:
    """(text, metadata) pairs -> Chunk list with chunk_id stamped into
    metadata."""
    chunks = [Chunk(text=t, metadata=dict(m)) for t, m in chunk_docs]
    for i, chunk in enumerate(chunks):
        chunk.metadata["chunk_id"] = i
    return chunks


def create_doc_embeddings_by_chunk(multi: MultiEmbeddings | None) -> DocEmbeddings:
    """MultiEmbeddings -> (chunk_ids, flat embeddings) for the dense index."""
    if multi is None:
        return DocEmbeddings(chunk_ids=np.array([]), embeddings=np.array([]))
    chunk_ids, embeddings = [], []
    for i, arr in enumerate(multi):
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(0, 0) if arr.size == 0 else arr.reshape(1, -1)
        chunk_ids.extend([i] * arr.shape[0])
        embeddings.extend(arr)
    return DocEmbeddings(
        chunk_ids=np.array(chunk_ids, dtype=np.int64),
        embeddings=np.array(embeddings, dtype=np.float32),
    )


def pack_simple_embeddings(embeddings) -> MultiEmbeddings:
    """One embedding per item."""
    return [np.asarray(e, dtype=np.float32).reshape(1, -1) for e in embeddings]
