"""Retrieval orchestration (mirror of reference retrieval_chain.py +
stages.py + app.py doc_to_attach): retriever construction with stage
wrappers, page-image selection, and the RetrievalResponse assembly.

With ``mesh`` the semantic, late-interaction, BM25 and chargram indexes
shard over its devices (``parallel/sharded_index.py``). Without it the
BM25, chargram and multimodal arms take the embedder's device: the port's
indexes live on a device the caller names. Page images are [H, W, 3]
uint8 arrays, encoded to PNG by the port's encoder."""

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

from dial_rag_tpu_torch.documents.model import DocumentRecord
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.image_processor import (
    are_image_pages_supported,
    extract_pages,
    image_as_base64,
)
from dial_rag_tpu_torch.index.records import RetrievalType, SearchHit
from dial_rag_tpu_torch.retrieval import (
    AllDocumentsRetriever,
    Bm25Retriever,
    EnsembleRetriever,
    SemanticRetriever,
)
from dial_rag_tpu_torch.retrieval.description import DescriptionRetriever
from dial_rag_tpu_torch.retrieval.multimodal import MultimodalRetriever
from dial_rag_tpu_torch.service.api import (
    Image,
    Page,
    RetrievalResponse,
    RetrievedChunk,
    Source,
)
from dial_rag_tpu_torch.service.attachments import AttachmentLink
from dial_rag_tpu_torch.service.config import ChatChainConfig, IndexingConfig
from dial_rag_tpu_torch.service.protocol import Choice, TimedStage

RETRIEVER_K = 7  # per-retriever k in the ensemble (retrieval_chain.py:203)


def doc_to_attach(
    hit: SearchHit,
    document_records: list[DocumentRecord],
    index=None,
) -> dict | None:
    """Found chunk -> DIAL attachment dict (reference app.py:73-105)."""
    doc_record = document_records[hit.doc_id]
    chunk = doc_record.chunks[hit.chunk_id]
    if index is None:
        index = f"{hit.doc_id}.{hit.chunk_id}"

    if hit.retrieval_type == RetrievalType.TEXT:
        data = chunk.text
    else:
        data = (
            f"[Image of the page {chunk.metadata['page_number']}]"
            if "page_number" in chunk.metadata
            else "[Image]"
        )
    return {
        "type": "text/markdown",
        "data": data or " ",
        "title": "[{index}] {source_display_name}".format(
            **chunk.metadata, index=index
        ),
        "reference_url": chunk.metadata["source"],
    }


class RetrieverStage:
    """Runs the inner retriever inside a timed stage and attaches the
    found chunks (mirror of reference stages.RetrieverStage)."""

    def __init__(
        self,
        choice: Choice,
        stage_name: str,
        retriever,
        document_records: list[DocumentRecord],
    ):
        self.choice = choice
        self.stage_name = stage_name
        self.retriever = retriever
        self.document_records = document_records

    async def aretrieve(self, query: str) -> list[SearchHit]:
        async with TimedStage(self.choice, self.stage_name) as stage:
            hits = await self.retriever.aretrieve(query)
            for hit in hits:
                if attachment := doc_to_attach(hit, self.document_records):
                    stage.add_attachment(**attachment)
            return hits


def _make_retrieval_stage_default(retriever, stage_name: str):
    return retriever


def create_retriever(
    embedder: BgeEmbedder,
    dial_url: str,
    api_key: str,
    document_records: list[DocumentRecord],
    indexing_config: IndexingConfig,
    make_retrieval_stage: Callable = _make_retrieval_stage_default,
    mesh=None,
    device_cache=None,
    index_dtype: str = "float32",
    li_embedder: BgeEmbedder | None = None,
    ensemble_weights: dict[str, float] | None = None,
    fusion_method: str = "rrf",
    fusion_norm: str = "minmax",
    fusion_depth: int = 30,
    query_expansion=None,
):
    """AllDocuments short-circuit, else RRF ensemble of the available
    retrievers (reference retrieval_chain.py:193-252). With ``mesh`` the
    semantic, late-interaction, BM25 and chargram index rows are sharded
    over its devices; with
    ``device_cache`` HBM-resident indexes are reused across requests.

    ``ensemble_weights`` maps arm name -> fusion weight (config
    RetrievalConfig.ensemble_weights); missing arms weigh the
    reference-parity 1.0, and an arm weighted 0 is neither built nor
    queried (the measured zero-egress recommendation is
    {'semantic': 0} — see eval/tune_ensemble.py and BASELINE.md).

    ``fusion_method``/``fusion_norm``/``fusion_depth`` select the
    fusion rule (RetrievalConfig): "rrf" (default) serves the
    reference-parity rank fusion at per-arm k=7; "combsum"/"combmnz"
    fuse by list-normalized scores over per-arm depth
    ``fusion_depth``, output-capped at k=7 x arm count (the RRF
    union's worst-case volume)."""
    if AllDocumentsRetriever.is_within_limit(document_records):
        return make_retrieval_stage(
            AllDocumentsRetriever.from_doc_records(document_records),
            "All documents",
        )

    arm_weights = ensemble_weights or {}
    arm_k = RETRIEVER_K if fusion_method == "rrf" else fusion_depth

    def w(arm: str) -> float:
        return arm_weights.get(arm, 1.0)

    retrievers = []
    weights = []
    if w("semantic") > 0:
        retrievers.append(
            make_retrieval_stage(
                SemanticRetriever.from_doc_records(
                    embedder,
                    document_records,
                    arm_k,
                    mesh=mesh,
                    device_cache=device_cache,
                    storage_dtype=index_dtype,
                ),
                "Embeddings search",
            )
        )
        weights.append(w("semantic"))

    from dial_rag_tpu_torch.retrieval.late_interaction import (
        LateInteractionRetriever,
    )

    if w("late_interaction") > 0 and LateInteractionRetriever.has_index(
        document_records
    ):
        li_config = indexing_config.late_interaction_index
        retrievers.append(
            make_retrieval_stage(
                LateInteractionRetriever.from_doc_records(
                    li_embedder or embedder,
                    document_records,
                    arm_k,
                    max_chunk_tokens=(
                        li_config.max_chunk_tokens if li_config else 256
                    ),
                    storage_dtype=(
                        li_config.index_dtype if li_config else "float32"
                    ),
                    device_cache=device_cache,
                    mesh=mesh,
                ),
                "Late interaction search",
            )
        )
        weights.append(w("late_interaction"))

    from dial_rag_tpu_torch.retrieval.chargram_retriever import ChargramRetriever

    if w("chargram") > 0 and ChargramRetriever.has_index(document_records):
        cg_config = indexing_config.chargram_index
        retrievers.append(
            make_retrieval_stage(
                ChargramRetriever.from_doc_records(
                    document_records,
                    arm_k,
                    n_lo=cg_config.n_lo if cg_config else 2,
                    n_hi=cg_config.n_hi if cg_config else 4,
                    device=embedder.device,
                    device_cache=device_cache,
                    mesh=mesh,
                ),
                "Fuzzy keywords search",
            )
        )
        weights.append(w("chargram"))

    if w("bm25") > 0 and Bm25Retriever.has_index(document_records):
        retrievers.append(
            make_retrieval_stage(
                Bm25Retriever.from_doc_records(
                    document_records,
                    arm_k,
                    device=embedder.device,
                    device_cache=device_cache,
                    mesh=mesh,
                    expansion_config=query_expansion,
                ),
                "Keywords search"
                if query_expansion is None
                else "Keywords search (expanded)",
            )
        )
        weights.append(w("bm25"))

    if w("multimodal") > 0 and MultimodalRetriever.has_index(
        document_records
    ):
        assert indexing_config.multimodal_index
        retrievers.append(
            make_retrieval_stage(
                MultimodalRetriever.from_doc_records(
                    dial_url,
                    api_key,
                    indexing_config.multimodal_index,
                    document_records,
                    arm_k,
                    device_cache=device_cache,
                    device=embedder.device,
                ),
                "Multimodal search",
            )
        )
        weights.append(w("multimodal"))

    if w("description") > 0 and DescriptionRetriever.has_index(
        document_records
    ):
        retrievers.append(
            make_retrieval_stage(
                DescriptionRetriever.from_doc_records(
                    embedder,
                    document_records,
                    arm_k,
                    device_cache=device_cache,
                ),
                "Page image search",
            )
        )
        weights.append(w("description"))

    if not retrievers:
        from dial_rag_tpu_torch.errors import InvalidConfigurationError

        raise InvalidConfigurationError(
            "retrieval.ensemble_weights disabled every retriever arm "
            "that has an index for these documents; leave at least one "
            "indexed arm with weight > 0"
        )

    return make_retrieval_stage(
        EnsembleRetriever(
            retrievers=retrievers,
            weights=weights,
            fusion_method=fusion_method,
            fusion_norm=fusion_norm,
            output_limit=(
                None
                if fusion_method == "rrf"
                else RETRIEVER_K * len(retrievers)
            ),
        ),
        "Combined search",
    )


# --- page images + retrieval response ------------------------------------


@dataclass(frozen=True, order=True)
class PageKey:
    doc_id: int
    page_number: int


def collect_pages_with_images(
    doc_records: list[DocumentRecord], hits: list[SearchHit]
):
    """IMAGE-typed hits first (higher priority), then text hits with pages
    (reference retrieval_chain.py:46-71)."""
    for want_image in (True, False):
        for hit in hits:
            doc_record = doc_records[hit.doc_id]
            if not are_image_pages_supported(doc_record.mime_type):
                continue
            chunk = doc_record.chunks[hit.chunk_id]
            is_image_hit = hit.retrieval_type == RetrievalType.IMAGE
            if is_image_hit == want_image and "page_number" in chunk.metadata:
                yield (hit.doc_id, chunk.metadata["page_number"])


# rendered-page cache: rasterizing + PNG-encoding a retrieved page is
# deterministic in (document content, page, size), and popular pages
# repeat across requests in steady-state serving — a measured per-request
# host cost worth ~150 ms at defaults. Keyed by the record's
# content-derived cache_token (records without one skip the cache), so a
# re-minted document can never serve stale renders. Byte-bounded LRU.
_PAGE_RENDER_CACHE: OrderedDict[tuple, str] = OrderedDict()
_PAGE_RENDER_CACHE_BYTES = 0
_PAGE_RENDER_CACHE_CAP = 64 << 20
_PAGE_RENDER_LOCK = threading.Lock()


def _page_render_cache_get(key: tuple) -> str | None:
    with _PAGE_RENDER_LOCK:
        value = _PAGE_RENDER_CACHE.get(key)
        if value is not None:
            _PAGE_RENDER_CACHE.move_to_end(key)
        return value


def _page_render_cache_put(key: tuple, value: str) -> None:
    global _PAGE_RENDER_CACHE_BYTES
    if len(value) > _PAGE_RENDER_CACHE_CAP:
        return
    with _PAGE_RENDER_LOCK:
        old = _PAGE_RENDER_CACHE.pop(key, None)
        if old is not None:
            _PAGE_RENDER_CACHE_BYTES -= len(old)
        _PAGE_RENDER_CACHE[key] = value
        _PAGE_RENDER_CACHE_BYTES += len(value)
        while _PAGE_RENDER_CACHE_BYTES > _PAGE_RENDER_CACHE_CAP:
            _, evicted = _PAGE_RENDER_CACHE.popitem(last=False)
            _PAGE_RENDER_CACHE_BYTES -= len(evicted)


async def make_image_by_page(
    doc_records: list[DocumentRecord],
    hits: list[SearchHit],
    num_pages_to_use: int,
    page_image_size: int,
) -> dict[PageKey, str]:
    required: set[PageKey] = set()
    for doc_id, page_number in collect_pages_with_images(doc_records, hits):
        if len(required) >= num_pages_to_use:
            break
        required.add(PageKey(doc_id, page_number))

    image_by_page: dict[PageKey, str] = {}
    by_doc: dict[int, list[PageKey]] = {}
    for key in sorted(required):
        record_token = doc_records[key.doc_id].cache_token
        if record_token is not None:
            cached = _page_render_cache_get(
                (record_token, key.page_number, page_image_size)
            )
            if cached is not None:
                image_by_page[key] = cached
                continue
        by_doc.setdefault(key.doc_id, []).append(key)

    for doc_id, keys in by_doc.items():
        doc_record = doc_records[doc_id]
        keys_it = iter(keys)
        async for image in extract_pages(
            doc_record.mime_type,
            doc_record.document_bytes,
            page_numbers=[k.page_number for k in keys],
            scaled_size=page_image_size,
        ):
            key = next(keys_it)
            # PNG encoding a rendered page costs ~20 ms of pure CPU;
            # off the event loop so concurrent requests keep flowing
            # (measured 11% of loop time under 16-way load)
            from dial_rag_tpu_torch.runtime.host_pools import run_in_parse_pool

            encoded = await run_in_parse_pool(image_as_base64, image)
            image_by_page[key] = encoded
            if doc_record.cache_token is not None:
                _page_render_cache_put(
                    (doc_record.cache_token, key.page_number,
                     page_image_size),
                    encoded,
                )
    return image_by_page


def create_retrieval_response(
    doc_records: list[DocumentRecord],
    doc_records_links: list[AttachmentLink],
    hits: list[SearchHit],
    image_by_page: dict[PageKey, str],
) -> RetrievalResponse:
    images: list[Image] = []
    chunks: list[RetrievedChunk] = []
    used_image_keys: set[PageKey] = set()

    for hit in hits:
        doc_record = doc_records[hit.doc_id]
        link = doc_records_links[hit.doc_id]
        chunk = doc_record.chunks[hit.chunk_id]
        chunk_data = RetrievedChunk(
            attachment_url=link.dial_link,
            text=chunk.text,
            source=Source(
                url=chunk.metadata["source"],
                display_name=chunk.metadata.get("source_display_name"),
            ),
            page=None,
        )
        if (page_number := chunk.metadata.get("page_number")) is not None:
            chunk_data.page = Page(number=page_number, image_index=None)
            page_key = PageKey(hit.doc_id, page_number)
            if page_key in image_by_page and page_key not in used_image_keys:
                used_image_keys.add(page_key)
                chunk_data.page.image_index = len(images)
                images.append(Image(data=image_by_page[page_key]))
        chunks.append(chunk_data)

    return RetrievalResponse(chunks=chunks, images=images)


@dataclass
class RetrievalResult:
    query: str
    found_items: list[SearchHit] = field(default_factory=list)
    image_by_page: dict = field(default_factory=dict)
    retrieval_response: RetrievalResponse | None = None


async def run_retrieval_pipeline(
    retriever,
    query: str,
    doc_records: list[DocumentRecord],
    doc_records_links: list[AttachmentLink],
    chat_chain_config: ChatChainConfig,
) -> RetrievalResult:
    """query -> found_items -> image_by_page -> retrieval_response
    (the reference's RunnablePassthrough pipeline,
    retrieval_chain.py:273-279)."""
    found_items = await retriever.aretrieve(query)
    image_by_page = await make_image_by_page(
        doc_records,
        found_items,
        chat_chain_config.num_page_images_to_use,
        chat_chain_config.page_image_size,
    )
    response = create_retrieval_response(
        doc_records, doc_records_links, found_items, image_by_page
    )
    return RetrievalResult(
        query=query,
        found_items=found_items,
        image_by_page=image_by_page,
        retrieval_response=response,
    )
