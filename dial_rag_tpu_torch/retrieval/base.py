"""Retriever protocol: async text query -> ranked SearchHit list
(counterpart of ``dial_rag_tpu/retrieval/base.py``)."""

from typing import Protocol, runtime_checkable

from dial_rag_tpu_torch.index.records import SearchHit


@runtime_checkable
class Retriever(Protocol):
    async def aretrieve(self, query: str) -> list[SearchHit]: ...
