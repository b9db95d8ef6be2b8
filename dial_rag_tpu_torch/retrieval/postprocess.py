"""Hits -> text chunks (counterpart of ``dial_rag_tpu/retrieval/postprocess.py``).

Index hits carry only ``{doc_id, chunk_id, retrieval_type}``; callers need
each chunk's text and metadata from the document records.
"""

from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord
from dial_rag_tpu_torch.index.records import SearchHit


def get_text_chunks(hits: list[SearchHit], document_records: list[DocumentRecord]) -> list[Chunk]:
    """Each hit's chunk, its metadata extended by the hit's identity."""
    chunks = []
    for hit in hits:
        chunk = document_records[hit.doc_id].chunks[hit.chunk_id]
        metadata = dict(chunk.metadata)
        metadata.update(hit.to_metadata())
        chunks.append(Chunk(text=chunk.text, metadata=metadata))
    return chunks
