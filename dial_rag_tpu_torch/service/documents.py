"""Per-document load/index driver (mirror of reference documents.py):
access check -> cached-index load -> else download -> convert -> parallel
build of 4 indexes in one TaskGroup -> store; per-document failure
isolation so one bad document never fails the request."""

import asyncio
import logging
from email.policy import EmailPolicy

from dial_rag_tpu_torch.documents.model import (
    FORMAT_VERSION,
    Chunk,
    DocumentRecord,
    IndexSettings,
)
from dial_rag_tpu_torch.documents.mime import detect_mime
from dial_rag_tpu_torch.documents.parser import parse_document
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.errors import DocumentProcessingError, InvalidDocumentError
from dial_rag_tpu_torch.image_processor import is_image
from dial_rag_tpu_torch.retrieval.bm25_retriever import Bm25Retriever
from dial_rag_tpu_torch.retrieval.description import DescriptionRetriever
from dial_rag_tpu_torch.retrieval.multimodal import MultimodalRetriever
from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever
from dial_rag_tpu_torch.service.attachments import AttachmentLink
from dial_rag_tpu_torch.service.config import RequestConfig
from dial_rag_tpu_torch.service.converter import convert_document_if_needed
from dial_rag_tpu_torch.service.dial_client import (
    DialApiClient,
    check_document_access,
    load_attachment,
)
from dial_rag_tpu_torch.service.indexing_results import (
    DocumentIndexingFailure,
    DocumentIndexingResult,
    DocumentIndexingSuccess,
)
from dial_rag_tpu_torch.service.indexing_task import (
    IndexingTask,
    validate_indexing_task,
)
from dial_rag_tpu_torch.runtime.host_pools import run_in_parse_pool
from dial_rag_tpu_torch.utils.print_stats import print_chunk_stats
from dial_rag_tpu_torch.service.protocol import TimedStage
from dial_rag_tpu_torch.service.request_context import RequestContext
from dial_rag_tpu_torch.storage.storage import IndexStorage
from dial_rag_tpu_torch.utils.streams import (
    LoggerStream,
    MarkdownStream,
    MultiStream,
    StreamWithPrefix,
)
from dial_rag_tpu_torch.utils.timing import format_size

logger = logging.getLogger(__name__)


def parse_content_type(content_type: str) -> tuple[str, dict]:
    header = EmailPolicy.header_factory("content-type", content_type)
    return header.content_type, dict(header.params)


def get_default_image_chunk(attachment_link: AttachmentLink) -> Chunk:
    return Chunk(
        text="",
        metadata={
            "page_number": 1,
            "chunk_id": 0,
            "source_display_name": attachment_link.display_name,
            "source": attachment_link.dial_link,
        },
    )


async def load_document_impl(
    request_context: RequestContext,
    embedder: BgeEmbedder,
    attachment_link: AttachmentLink,
    stage_stream,
    index_settings: IndexSettings,
    config: RequestConfig,
    li_embedder: BgeEmbedder | None = None,
) -> DocumentRecord:
    logger_stream = LoggerStream()
    if config.log_document_links:
        logger_stream = StreamWithPrefix(
            logger_stream, f"<{attachment_link.dial_link}>: "
        )
    io_stream = MultiStream(MarkdownStream(stage_stream), logger_stream)

    headers = request_context.get_file_access_headers(
        attachment_link.absolute_url
    )
    content_type, original_doc_bytes = await load_attachment(
        attachment_link.absolute_url,
        attachment_link.display_name,
        headers,
        config.download,
    )
    attachment_mime_type, _ = parse_content_type(content_type)
    attachment_mime_type = detect_mime(
        attachment_mime_type, attachment_link.display_name, original_doc_bytes
    )
    io_stream.write(f"File type: {attachment_mime_type}\n")
    io_stream.write(
        f"Document size: {format_size(len(original_doc_bytes))}\n"
    )

    mime_type, doc_bytes = await convert_document_if_needed(
        attachment_mime_type,
        original_doc_bytes,
        StreamWithPrefix(io_stream, "Converter: "),
    )

    index_config = config.indexing
    dial_url = request_context.dial_url
    api_key = request_context.api_key
    limited = request_context.dial_limited_resources

    async with asyncio.TaskGroup() as tg:
        multimodal_task = None
        if index_config.multimodal_index is not None:
            multimodal_task = tg.create_task(
                MultimodalRetriever.build_index(
                    dial_url,
                    api_key,
                    limited,
                    index_config.multimodal_index,
                    mime_type,
                    doc_bytes,
                    StreamWithPrefix(io_stream, "MultimodalRetriever: "),
                )
            )

        description_task = None
        if index_config.description_index is not None:
            description_task = tg.create_task(
                DescriptionRetriever.build_index(
                    dial_url,
                    api_key,
                    limited,
                    index_config.description_index,
                    embedder,
                    doc_bytes,
                    mime_type,
                    StreamWithPrefix(io_stream, "DescriptionRetriever: "),
                )
            )

        if is_image(content_type) or is_image(attachment_mime_type):
            chunks_list = [get_default_image_chunk(attachment_link)]
        else:
            parse_stream = StreamWithPrefix(io_stream, "Parser: ")
            parse_stream.write("Loader: dial-rag-tpu\n")
            chunks_list = await run_in_parse_pool(
                lambda: parse_document(
                    doc_bytes,
                    mime_type,
                    source_link=attachment_link.dial_link,
                    display_name=attachment_link.display_name,
                    attachment_mime_type=attachment_mime_type,
                    config=index_config.parser.to_parser_config(),
                )
            )
            print_chunk_stats(parse_stream, chunks_list)

        text_index_task = tg.create_task(
            Bm25Retriever.build_index(chunks_list)
        )
        embeddings_index_task = tg.create_task(
            SemanticRetriever.build_index(embedder, chunks_list)
        )

        chargram_task = None
        if index_config.chargram_index is not None:
            from dial_rag_tpu_torch.retrieval.chargram_retriever import (
                ChargramRetriever,
            )

            chargram_task = tg.create_task(
                ChargramRetriever.build_index(chunks_list)
            )

        late_interaction_task = None
        if index_config.late_interaction_index is not None:
            from dial_rag_tpu_torch.retrieval.late_interaction import (
                LateInteractionRetriever,
            )

            late_interaction_task = tg.create_task(
                LateInteractionRetriever.build_index(
                    li_embedder or embedder,
                    chunks_list,
                    index_config.late_interaction_index.max_chunk_tokens,
                )
            )

    from dial_rag_tpu_torch import telemetry

    telemetry.get_counter("dial_rag.chunks_indexed").add(
        len(chunks_list), {"mime_type": mime_type}
    )
    return DocumentRecord(
        format_version=FORMAT_VERSION,
        index_settings=index_settings,
        chunks=chunks_list,
        text_index=text_index_task.result(),
        embeddings_index=embeddings_index_task.result(),
        multimodal_embeddings_index=(
            multimodal_task.result() if multimodal_task else None
        ),
        description_embeddings_index=(
            description_task.result() if description_task else None
        ),
        late_interaction_index=(
            late_interaction_task.result() if late_interaction_task else None
        ),
        chargram_index=(
            chargram_task.result() if chargram_task else None
        ),
        mime_type=mime_type,
        document_bytes=doc_bytes,
    )


class _FailStage(Exception):
    pass


async def load_document(
    request_context: RequestContext,
    embedder: BgeEmbedder,
    task: IndexingTask,
    index_storage: IndexStorage,
    dial_api_client: DialApiClient,
    config: RequestConfig,
    li_embedder: BgeEmbedder | None = None,
) -> DocumentRecord:
    attachment_link = task.attachment_link
    try:
        validate_indexing_task(task, dial_api_client)
        index_settings = config.indexing.collect_fields_that_rebuild_index()
        # the semantic index stores THIS embedder's document vectors;
        # serving a record built by different weights would score
        # queries in a mismatched space, so the CONTENT identity of the
        # weights is a rebuild trigger. The dedicated late-interaction
        # checkpoint gets the same treatment: its config model_path is
        # already a trigger, but only as a path string — re-minting
        # weights in place (the Makefile's staged recipe) changes the
        # content hash, not the path.
        index_settings.indexes["embedder"] = {"model_id": embedder.model_id}
        if li_embedder is not None:
            index_settings.indexes["li_embedder"] = {
                "model_id": li_embedder.model_id
            }
        choice = request_context.choice

        if attachment_link.is_dial_document:
            async with TimedStage(
                choice, f"Access document '{attachment_link.display_name}'"
            ):
                await check_document_access(
                    request_context,
                    attachment_link.dial_metadata_url,
                    config.check_access,
                )

        doc_record = None
        try:
            async with TimedStage(
                choice, f"Load indexes for '{attachment_link.display_name}'"
            ) as load_stage:
                doc_record = await index_storage.load(
                    task.index_url, index_settings
                )
                if doc_record is None:
                    raise _FailStage()
                load_stage.append_content(
                    f"Chunks: {len(doc_record.chunks)}\n\n"
                )
        except _FailStage:
            pass

        if doc_record is None:
            async with TimedStage(
                choice,
                f"Processing document '{attachment_link.display_name}'",
            ) as doc_stage:
                try:
                    doc_record = await load_document_impl(
                        request_context,
                        embedder,
                        attachment_link,
                        doc_stage.content_stream,
                        index_settings,
                        config,
                        li_embedder=li_embedder,
                    )
                except InvalidDocumentError as e:
                    doc_stage.append_content(e.message)
                    raise
                doc_stage.append_content(
                    f"Chunks: {len(doc_record.chunks)}\n\n"
                )
            async with TimedStage(
                choice, f"Store indexes for '{attachment_link.display_name}'"
            ):
                await index_storage.store(task.index_url, doc_record)

        return doc_record
    except Exception as e:
        logger.warning(
            f"Failed to process document: {type(e).__name__}",
            exc_info=config.log_document_links,
        )
        raise DocumentProcessingError(attachment_link.display_name, e) from e


async def load_document_task(
    request_context: RequestContext,
    embedder: BgeEmbedder,
    task: IndexingTask,
    index_storage: IndexStorage,
    dial_api_client: DialApiClient,
    config: RequestConfig,
    li_embedder: BgeEmbedder | None = None,
) -> DocumentIndexingResult:
    try:
        doc_record = await load_document(
            request_context,
            embedder,
            task,
            index_storage,
            dial_api_client,
            config,
            li_embedder=li_embedder,
        )
        return DocumentIndexingSuccess(task=task, doc_record=doc_record)
    except DocumentProcessingError as e:
        assert isinstance(e.__cause__, Exception)
        return DocumentIndexingFailure(task=task, exception=e.__cause__)


async def load_documents(
    request_context: RequestContext,
    embedder: BgeEmbedder,
    tasks: list[IndexingTask],
    index_storage: IndexStorage,
    dial_api_client: DialApiClient,
    config: RequestConfig,
    li_embedder: BgeEmbedder | None = None,
) -> list[DocumentIndexingResult]:
    return await asyncio.gather(
        *[
            load_document_task(
                request_context,
                embedder,
                task,
                index_storage,
                dial_api_client,
                config,
                li_embedder=li_embedder,
            )
            for task in tasks
        ]
    )
