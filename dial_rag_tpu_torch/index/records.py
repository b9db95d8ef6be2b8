"""Index hit records.

Mirrors the reference's index_record.py: a retrieval hit carries only
``{doc_id, chunk_id, retrieval_type}`` and the string key ``"{doc_id}_
{chunk_id}"`` is the identity used for ensemble fusion (the reference
encodes it in langchain Document.page_content — index_record.py:29-38).
"""

from dataclasses import dataclass, field
from enum import Enum


class RetrievalType(str, Enum):
    TEXT = "text"
    IMAGE = "image"


@dataclass(frozen=True)
class SearchHit:
    doc_id: int
    chunk_id: int
    retrieval_type: RetrievalType
    # retriever-native relevance, HIGHER is better (dense: -distance,
    # BM25: Okapi score, late-interaction: MaxSim). Optional: rank-only
    # producers leave it None and score-aware fusion falls back to a
    # rank proxy. compare=False keeps hit equality/hash = identity
    # (doc, chunk, type), the reference's fusion contract.
    score: float | None = field(default=None, compare=False)

    @property
    def key(self) -> str:
        """Fusion identity: same chunk found by different retrievers merges."""
        return f"{self.doc_id}_{self.chunk_id}"

    def to_metadata(self) -> dict:
        return {
            "doc_id": self.doc_id,
            "chunk_id": self.chunk_id,
            "retrieval_type": self.retrieval_type.value,
        }
