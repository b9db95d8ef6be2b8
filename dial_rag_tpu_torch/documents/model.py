"""Document data model.

First-party replacement for the reference's docarray records
(aidial_rag/document_record.py): a parsed document plus its four indexes.
No pickle anywhere — records serialize through a typed msgpack+raw-buffer
container (storage/serialization.py) so persisted indexes are
safe to load and portable across versions.

``MultiEmbeddings`` is a list with one ``[m, D]`` float32 array per item
(chunk or page): a chunk/page may carry several embedding rows.
"""

from dataclasses import dataclass, field

import numpy as np

# Bump whenever the serialized layout or any index semantics change;
# mismatched persisted records are discarded and rebuilt (the reference
# does the same with its FORMAT_VERSION=12, index_storage.py:139-149).
# v2: added the optional late_interaction_index field.
FORMAT_VERSION: int = 2

MultiEmbeddings = list  # list[np.ndarray [m, D] f32]


@dataclass
class Chunk:
    text: str
    metadata: dict

    @property
    def page_number(self) -> int | None:
        return self.metadata.get("page_number")


@dataclass
class IndexSettings:
    """Settings that participated in index construction. A change in any of
    these invalidates persisted records (rebuild-trigger semantics,
    reference base_config.py:7-21)."""

    indexes: dict = field(default_factory=dict)

    def __eq__(self, other):
        return isinstance(other, IndexSettings) and self.indexes == other.indexes


@dataclass
class DocumentRecord:
    format_version: int | None
    index_settings: IndexSettings
    chunks: list[Chunk]
    text_index: list[list[str]] | None  # tokenized text per chunk (BM25)
    embeddings_index: MultiEmbeddings | None  # semantic, per chunk
    multimodal_embeddings_index: MultiEmbeddings | None  # per page
    description_embeddings_index: MultiEmbeddings | None  # per page
    mime_type: str
    document_bytes: bytes  # original or office->pdf converted document
    # per-token chunk embeddings for late-interaction (MaxSim) retrieval;
    # one ragged [t_i, D] f32 array per chunk. None unless the (off by
    # default) late_interaction_index is configured.
    late_interaction_index: MultiEmbeddings | None = None
    # surface word tokens per chunk (unstemmed, unlike text_index) for
    # the char-n-gram fuzzy-lexical arm; grams + corpus idf derive at
    # retriever construction. None unless the (off by default)
    # chargram_index is configured.
    chargram_index: list[list[str]] | None = None
    # content identity stamped by the storage layer (url, sha256 of the
    # serialized bytes); keys the device-index cache across requests.
    # Not serialized.
    cache_token: tuple | None = field(default=None, compare=False)


def build_chunks_list(chunk_docs: list[tuple[str, dict]]) -> list[Chunk]:
    """(text, metadata) pairs -> Chunk list with chunk_id stamped into
    metadata (the reference does the same, document_record.py:55-70)."""
    chunks = [Chunk(text=t, metadata=dict(m)) for t, m in chunk_docs]
    for i, chunk in enumerate(chunks):
        chunk.metadata["chunk_id"] = i
    return chunks


def create_doc_embeddings_by_chunk(multi: MultiEmbeddings | None):
    """MultiEmbeddings -> (chunk_ids, flat embeddings) for the dense index
    (mirrors reference create_index_by_chunk, embeddings_index.py:121-136)."""
    from dial_rag_tpu_torch.index.dense_index import DocEmbeddings

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


def create_doc_embeddings_by_page(
    chunks: list[Chunk], pages_embeddings: MultiEmbeddings | None
):
    """Per-page embeddings mapped onto chunks via their 1-based page_number
    (mirrors reference create_index_by_page, embeddings_index.py:101-118)."""
    from dial_rag_tpu_torch.index.dense_index import DocEmbeddings

    if pages_embeddings is None:
        return DocEmbeddings(chunk_ids=np.array([]), embeddings=np.array([]))
    chunk_ids, embeddings = [], []
    for i, chunk in enumerate(chunks):
        page_embs = np.asarray(
            pages_embeddings[chunk.metadata["page_number"] - 1],
            dtype=np.float32,
        )
        for row in page_embs:
            chunk_ids.append(i)
            embeddings.append(row)
    return DocEmbeddings(
        chunk_ids=np.array(chunk_ids, dtype=np.int64),
        embeddings=np.array(embeddings, dtype=np.float32),
    )


def pack_multi_embeddings(
    indexes: list[int], embeddings, number_of_items: int
) -> MultiEmbeddings:
    """Group flat (item_index, embedding) pairs into per-item arrays
    (mirrors reference pack_multi_embeddings, embeddings_index.py:139-153)."""
    per_item: list[list[np.ndarray]] = [[] for _ in range(number_of_items)]
    for item_index, emb in zip(indexes, embeddings, strict=True):
        per_item[item_index].append(np.asarray(emb, dtype=np.float32))
    return [np.array(e, dtype=np.float32) for e in per_item]


def pack_simple_embeddings(embeddings) -> MultiEmbeddings:
    """One embedding per item (mirrors pack_simple_embeddings)."""
    return [
        np.asarray(e, dtype=np.float32).reshape(1, -1) for e in embeddings
    ]
