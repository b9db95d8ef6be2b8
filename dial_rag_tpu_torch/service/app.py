"""The DIAL-compatible HTTP application (on ``service/http.py``).

Mirror of the reference app layer (app.py + main.py on aidial-sdk/
FastAPI, neither available here): an OpenAI-compatible
``/openai/deployments/dial-rag/chat/completions`` endpoint with the three
request types (rag / retrieval / indexing), the ``/configuration`` schema
endpoint, and a healthcheck. The local embedding model is a process-wide
singleton running on the card (``device``, default ``cuda``; ``cpu`` only
when the caller asks for it).

With more than one visible card (or ``parallel.data_parallel: true``)
the app builds a mesh over every card, as the JAX package's does: the
embedders encode data-parallel over it (``BgeEmbedder.shard_over``) and
the retrievers shard their indexes over it (``parallel/``).

Where the port differs from the JAX package's app: it serves on the
port's own HTTP module; ``use_profiler`` raises (item 9c); the warm-up
runs every tokenizer bucket and one dense scan."""

import asyncio
import json
import logging

import torch

from dial_rag_tpu_torch.service import http
from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.errors import DialRagError, RateLimitError
from dial_rag_tpu_torch.parallel.mesh import create_mesh, visible_devices
from dial_rag_tpu_torch.runtime.limited import DialLimitedResources
from dial_rag_tpu_torch.service.attachments import get_attachment_links
from dial_rag_tpu_torch.service.commands import (
    Commands,
    commands_to_config_dict,
    process_commands,
)
from dial_rag_tpu_torch.service.config import (
    AppConfig,
    Configuration,
    RequestType,
    merge_config,
    validate_custom_configuration,
)
from dial_rag_tpu_torch.service.dial_client import (
    DialFileStorage,
    create_dial_api_client,
    get_user_limits_for_model,
)
from dial_rag_tpu_torch.service.digest import ConfigDigest, read_repository_digest
from dial_rag_tpu_torch.service.documents import load_documents
from dial_rag_tpu_torch.service.history import transform_history
from dial_rag_tpu_torch.service.indexing_results import (
    create_document_loading_exception,
    create_indexing_results_attachments,
    format_document_loading_errors,
    get_indexing_failures,
)
from dial_rag_tpu_torch.service.indexing_task import create_indexing_tasks
from dial_rag_tpu_torch.service.messages import ChatRequest
from dial_rag_tpu_torch.service.profiler import profiler_if_enabled
from dial_rag_tpu_torch.service.protocol import ChatCompletionResponder, TimedStage
from dial_rag_tpu_torch.service.qa_chain import generate_answer
from dial_rag_tpu_torch.service.query_chain import get_query
from dial_rag_tpu_torch.service.request_context import RequestContext
from dial_rag_tpu_torch.service.retrieval_chain import (
    RetrieverStage,
    create_retriever,
    doc_to_attach,
    run_retrieval_pipeline,
)
from dial_rag_tpu_torch.storage.storage import IndexStorageHolder, LocalFileStorage

APP_NAME = "dial-rag"

logger = logging.getLogger(__name__)


def _collect_document_records(indexing_results):
    from dial_rag_tpu_torch.service.indexing_results import DocumentIndexingSuccess

    records, links = [], []
    for result in indexing_results:
        if isinstance(result, DocumentIndexingSuccess):
            records.append(result.doc_record)
            links.append(result.task.attachment_link)
    return records, links


class DialRagApplication:
    def __init__(
        self,
        app_config: AppConfig,
        embedder: BgeEmbedder | None = None,
        device: str = "cuda",
    ):
        self.app_config = app_config
        self.repository_digest = read_repository_digest()
        self.device = resolve_device(device)
        if embedder is None:
            if app_config.embedder.model_path:
                embedder = BgeEmbedder.from_hf_checkpoint(
                    app_config.embedder.model_path,
                    batch_size=app_config.embedder.batch_size,
                    device=self.device,
                )
            else:
                logger.warning(
                    "No embedder.model_path configured; using a random-"
                    "weight embedding model (tests/benchmarks only)"
                )
                embedder = BgeEmbedder.from_random(
                    batch_size=app_config.embedder.batch_size,
                    device=self.device,
                )
        self.mesh = self._create_mesh(app_config, self.device)
        if self.mesh is not None:
            embedder = embedder.shard_over(self.mesh)
        self.embedder = embedder
        self.index_storage_holder = IndexStorageHolder(
            app_config.index_storage.in_memory_cache_capacity
        )
        from dial_rag_tpu_torch.index.device_cache import DeviceIndexCache

        self.device_index_cache = DeviceIndexCache()
        # dedicated late-interaction encoders, loaded once per distinct
        # checkpoint path (requests may select one via
        # indexing.late_interaction_index.model_path)
        self._li_embedders: dict[str, BgeEmbedder] = {}

    def _get_li_embedder(self, request_config) -> BgeEmbedder | None:
        li = request_config.indexing.late_interaction_index
        path = li.model_path if li else ""
        if not path:
            return None
        if path not in self._li_embedders:
            embedder = BgeEmbedder.from_hf_checkpoint(
                path,
                batch_size=self.app_config.embedder.batch_size,
                device=self.device,
            )
            if self.mesh is not None:
                embedder = embedder.shard_over(self.mesh)
            self._li_embedders[path] = embedder
        return self._li_embedders[path]

    @staticmethod
    def _create_mesh(app_config: AppConfig, device: torch.device):
        """(dp,) mesh over every visible card of ``device``'s kind when
        data_parallel is on (auto: only with more than one, where a
        one-device mesh would only add overhead); None when it is off."""
        dp = app_config.parallel.data_parallel
        if dp is False:
            return None
        devices = visible_devices(device)
        if dp is None and len(devices) <= 1:
            return None
        logger.info(f"data-parallel over {len(devices)} devices")
        return create_mesh(devices=devices)

    def _merge_config_sources(
        self, request: ChatRequest, commands: Commands
    ) -> tuple[ConfigDigest, Configuration]:
        # Deliberate divergence from the reference (app.py:223), which
        # dumps with exclude_none=True: that drops the presets' explicit
        # `description_index: null`, resurrecting the default-ON
        # description index on embedding-flavor deployments. Dumping
        # only explicitly-set fields keeps YAML/env nulls as disables
        # while untouched fields fall through to Configuration defaults.
        configuration = merge_config(
            Configuration(),
            self.app_config.request.model_dump(exclude_unset=True),
        )
        custom = validate_custom_configuration(
            request.custom_fields.configuration
            if request.custom_fields
            else None
        )
        if custom:
            configuration = merge_config(configuration, custom)
        commands_dict = commands_to_config_dict(commands)
        if commands_dict:
            configuration = merge_config(configuration, commands_dict)
        digest = ConfigDigest(
            app_config_path=str(self.app_config.config_path),
            configuration=configuration.model_dump(mode="json"),
            from_custom_configuration=custom,
            from_commands=commands_dict,
        )
        return digest, configuration

    def _get_index_storage(self, dial_api_client):
        remote = None
        if self.app_config.index_storage.local_storage_path:
            remote = LocalFileStorage(
                self.app_config.index_storage.local_storage_path
            )
        elif self.app_config.index_storage.use_dial_file_storage:
            remote = DialFileStorage(dial_api_client)
        return self.index_storage_holder.get_storage(remote)

    async def chat_completion(
        self, request: ChatRequest, responder: ChatCompletionResponder
    ) -> None:
        from dial_rag_tpu_torch import telemetry

        with telemetry.span("rag_request") as request_span:
            await self._chat_completion(request, responder, request_span)

    async def _chat_completion(
        self, request, responder, request_span
    ) -> None:
        choice = responder.choice
        request_context = RequestContext(
            dial_url=self.app_config.dial_url,
            api_key=request.api_key,
            choice=choice,
            dial_limited_resources=DialLimitedResources(
                lambda model: get_user_limits_for_model(
                    self.app_config.dial_url, request.api_key, model
                )
            ),
        )

        messages, commands = process_commands(
            request.messages, self.app_config.enable_debug_commands
        )
        config_digest, request_config = self._merge_config_sources(
            request, commands
        )
        choice.set_state(
            {
                "repository_digest": self.repository_digest.__dict__,
                "config_digest": config_digest.to_dict(),
            }
        )

        attachment_links = list(
            get_attachment_links(request_context, messages)
        )
        dial_api_client = await create_dial_api_client(request_context)
        index_storage = self._get_index_storage(dial_api_client)
        indexing_tasks = create_indexing_tasks(
            attachment_links, dial_api_client
        )
        indexing_results = await load_documents(
            request_context,
            self.embedder,
            indexing_tasks,
            index_storage,
            dial_api_client,
            config=request_config,
            li_embedder=self._get_li_embedder(request_config),
        )

        request_type = request_config.request.type
        request_span.set_attribute("dial_rag.request_type", request_type.value)
        request_span.set_attribute(
            "dial_rag.attachments", len(attachment_links)
        )
        if request_type == RequestType.INDEXING:
            for attachment in create_indexing_results_attachments(
                indexing_results
            ):
                choice.add_attachment(**attachment.to_dict())
            return

        indexing_failures = get_indexing_failures(indexing_results)
        if (
            indexing_failures
            and not request_config.ignore_document_loading_errors
        ):
            if request_type != RequestType.RAG:
                raise create_document_loading_exception(indexing_failures)
            choice.append_content(
                format_document_loading_errors(indexing_failures)
            )
            return

        document_records, document_records_links = _collect_document_records(
            indexing_results
        )

        last_message_content = messages[-1].content if messages else None
        if last_message_content is None:
            return
        if not isinstance(last_message_content, str):
            error = DialRagError("Message content is not a string")
            error.status_code = 400
            raise error
        if not last_message_content.strip():
            return

        chat_history = transform_history(messages)

        async with TimedStage(choice, "Prepare indexes for search"):
            retriever = create_retriever(
                self.embedder,
                request_context.dial_url,
                request_context.api_key,
                document_records,
                request_config.indexing,
                make_retrieval_stage=lambda r, name: RetrieverStage(
                    choice, name, r, document_records
                ),
                mesh=self.mesh,
                device_cache=self.device_index_cache,
                index_dtype=self.app_config.parallel.index_dtype,
                li_embedder=self._get_li_embedder(request_config),
                ensemble_weights=request_config.retrieval.ensemble_weights,
                fusion_method=request_config.retrieval.fusion_method,
                fusion_norm=request_config.retrieval.fusion_norm,
                fusion_depth=request_config.retrieval.fusion_depth,
                query_expansion=request_config.retrieval.query_expansion,
            )

        async with profiler_if_enabled(choice, request_config.use_profiler):
            query = await get_query(
                request_context,
                request_config.qa_chain.query_chain,
                chat_history,
            )
            retrieval = await run_retrieval_pipeline(
                retriever,
                query,
                document_records,
                document_records_links,
                request_config.qa_chain.chat_chain,
            )

            if request_type == RequestType.RETRIEVAL:
                choice.add_attachment(
                    title="Retrieval response",
                    type=retrieval.retrieval_response.CONTENT_TYPE,
                    data=retrieval.retrieval_response.model_dump_json(
                        indent=2
                    ),
                )
                return

            reference_items = await generate_answer(
                request_context,
                request_config.qa_chain.chat_chain,
                chat_history,
                query,
                retrieval.found_items,
                retrieval.retrieval_response,
                content_callback=choice.append_content,
            )
            for i, hit in enumerate(reference_items):
                if attachment := doc_to_attach(
                    hit, document_records, index=(i + 1)
                ):
                    choice.add_attachment(**attachment)


def _unwrap_exception(e: BaseException) -> BaseException:
    """ExceptionGroup unpacking with 429 prioritization (reference
    errors.py:84-106)."""
    if isinstance(e, BaseExceptionGroup):
        leaves = []

        def collect(group):
            for inner in group.exceptions:
                if isinstance(inner, BaseExceptionGroup):
                    collect(inner)
                else:
                    leaves.append(inner)

        collect(e)
        for leaf in leaves:
            if isinstance(leaf, RateLimitError):
                return leaf
        return leaves[0] if leaves else e
    return e


def _error_payload(e: BaseException) -> tuple[int, dict]:
    e = _unwrap_exception(e)
    if isinstance(e, DialRagError):
        status = e.status_code
        message = e.message
    else:
        status = 500
        message = "Internal error"
    return status, {
        "error": {
            "message": message,
            "type": "runtime_error" if status >= 500 else "invalid_request_error",
            "code": str(status),
        }
    }


def _warmup_device(application: "DialRagApplication") -> None:
    """Run the serving-path programs once ahead of traffic: the encoder
    at every sequence bucket (query-sized and full batches) and the dense
    scan. PyTorch compiles nothing here; the first launch of each shape
    still pays its allocations and the kernels' first loads."""
    import numpy as np

    from dial_rag_tpu_torch.index.dense_index import DenseIndex, DocEmbeddings
    from dial_rag_tpu_torch.index.records import RetrievalType

    embedder = application.embedder
    logger.info("warmup: running encoder/scan programs")
    for bucket in embedder.tokenizer.buckets:
        # bucket-2 single-token words + CLS/SEP lands exactly in `bucket`
        word = "a " * max(1, bucket - 2)
        embedder.embed_queries([word])
        embedder.embed_documents([word] * embedder.batch_size)
    emb = embedder.embed_documents(["warmup text"])
    index = DenseIndex(
        RetrievalType.TEXT,
        [DocEmbeddings(chunk_ids=np.arange(1), embeddings=emb)],
        limit=7,
        device=embedder.device,
    )
    index.find(emb[0])
    logger.info("warmup: done")


def create_app(
    app_config: AppConfig,
    embedder: BgeEmbedder | None = None,
    device: str = "cuda",
) -> http.Application:
    application = DialRagApplication(app_config, embedder, device=device)
    app = http.Application(client_max_size=512 * 1024 * 1024)
    app["dial_rag"] = application

    async def warm_pools(app):
        # reference warms its CPU pools in the app lifespan
        # (app.py:376-382) so first requests skip thread-spawn latency
        from dial_rag_tpu_torch.runtime.host_pools import init_host_pools

        init_host_pools()
        if app_config.embedder.warmup_on_startup:
            await asyncio.get_running_loop().run_in_executor(
                None, _warmup_device, application
            )

    app.on_startup.append(warm_pools)

    async def chat_completions(request: http.Request) -> http.StreamResponse:
        try:
            body = await request.json()
            chat_request = ChatRequest.model_validate(body)
        except Exception as e:  # malformed JSON / schema violation -> 400
            logger.info(f"invalid request body: {type(e).__name__}")
            return http.json_response(
                {
                    "error": {
                        "message": "Invalid request body",
                        "type": "invalid_request_error",
                        "code": "400",
                    }
                },
                status=400,
            )
        chat_request.api_key = request.headers.get("api-key", "")

        responder = ChatCompletionResponder(model=APP_NAME)

        async def produce():
            try:
                await application.chat_completion(chat_request, responder)
            finally:
                responder.choice.close()

        task = asyncio.ensure_future(produce())

        if chat_request.stream:
            response = http.StreamResponse(
                headers={
                    "Content-Type": "text/event-stream",
                    "Cache-Control": "no-cache",
                }
            )
            try:
                await response.prepare(request)
                async for chunk in responder.sse_data_chunks():
                    await response.write(chunk)
                # terminate the stream based on the producer's outcome:
                # errors must precede [DONE] or clients never see them
                try:
                    await task
                except Exception as e:
                    logger.exception("chat_completion failed mid-stream")
                    _, payload = _error_payload(e)
                    await response.write(
                        f"data: {json.dumps(payload)}\n\n".encode()
                    )
                    await response.write(b"data: [DONE]\n\n")
                else:
                    for chunk in responder.sse_finish_chunks():
                        await response.write(chunk)
                await response.write_eof()
            finally:
                # client disconnects must not leave the pipeline running
                # for a dead connection (or its exception unobserved)
                if not task.done():
                    task.cancel()
                await asyncio.gather(task, return_exceptions=True)
            return response

        try:
            result = await responder.aggregate()
        finally:
            # client disconnects must not leave the pipeline running
            if not task.done():
                task.cancel()
        try:
            await task
        except Exception as e:
            logger.exception("chat_completion failed")
            status, payload = _error_payload(e)
            return http.json_response(payload, status=status)
        return http.json_response(result)

    async def configuration(request: http.Request) -> http.Response:
        return http.json_response(Configuration.model_json_schema())

    async def health(request: http.Request) -> http.Response:
        return http.json_response({"status": "ok"})

    app.router.add_post(
        f"/openai/deployments/{APP_NAME}/chat/completions", chat_completions
    )
    app.router.add_get(
        f"/openai/deployments/{APP_NAME}/configuration", configuration
    )
    app.router.add_post(
        f"/openai/deployments/{APP_NAME}/configuration", configuration
    )
    app.router.add_get("/health", health)
    return app
