"""All-documents short-circuit retriever.

When the whole corpus fits in the prompt budget, skip search entirely and
return every chunk (reference all_documents_retriever.py:10-64, limit
12000 bytes including per-chunk prompt attribute overhead)."""

from dial_rag_tpu_torch.documents.model import Chunk, DocumentRecord
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit

MAX_LENGTH_IN_BYTES = 12000
CHUNK_PROMPT_OVERHEAD = 30


def _format_attributes_len(i: int, chunk: Chunk) -> int:
    # mirrors qa_chain.format_attributes rendering used for the estimate
    parts = [f"id='{i}'"]
    page = chunk.metadata.get("page_number")
    if page is not None:
        parts.append(f"page_number='{page}'")
    source = chunk.metadata.get("source")
    if source:
        parts.append(f"source='{source}'")
    return len(" ".join(parts))


class AllDocumentsRetriever:
    def __init__(self, hits: list[SearchHit]):
        self._hits = hits

    @staticmethod
    def is_within_limit(document_records: list[DocumentRecord]) -> bool:
        # every chunk contributes at least its prompt overhead, so the
        # chunk count alone rules out any large corpus in O(docs) —
        # this check runs on EVERY request (retrieval_chain), and the
        # full formatted-length sum over a 1M-chunk corpus was the
        # single largest host cost of a retrieval request
        n_chunks = sum(len(doc.chunks) for doc in document_records)
        if n_chunks * CHUNK_PROMPT_OVERHEAD > MAX_LENGTH_IN_BYTES:
            return False
        total = 0
        i = 0
        for doc in document_records:
            for chunk in doc.chunks:
                total += (
                    len(chunk.text)
                    + _format_attributes_len(i, chunk)
                    + CHUNK_PROMPT_OVERHEAD
                )
                if total > MAX_LENGTH_IN_BYTES:
                    return False  # monotone: all terms are positive
                i += 1
        return True

    @classmethod
    def from_doc_records(
        cls, document_records: list[DocumentRecord] | None = None
    ) -> "AllDocumentsRetriever":
        document_records = document_records or []
        hits = [
            SearchHit(doc_id=i, chunk_id=j, retrieval_type=RetrievalType.TEXT)
            for i, doc in enumerate(document_records)
            for j in range(len(doc.chunks))
        ]
        return cls(hits)

    def retrieve(self, query: str) -> list[SearchHit]:
        return self._hits

    async def aretrieve(self, query: str) -> list[SearchHit]:
        return self._hits
