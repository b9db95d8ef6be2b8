"""Layered configuration system.

Mirror of the reference's config architecture (base_config.py,
app_config.py, configuration_endpoint.py, indexing_config.py,
qa_chain_config.py, llm.py config models): frozen pydantic models with
``extra="forbid"``, an IndexRebuildTrigger field marker feeding the
persisted IndexSettings, deep-merge config layering
(defaults <- app yaml/env <- per-request configuration <- commands), and
the Configuration JSON schema served by the /configuration endpoint.

pydantic-settings and deepmerge are not in the image, so env/YAML loading
and the merger are first-party (env prefix DIAL_RAG__, nested ``__``
delimiter, source order init > env > yaml).

In the port the models stand on ``service/_model.py`` and the YAML reader
is ``service/_yaml.py`` (the card's machine has neither pydantic nor
PyYAML). The one intended difference from the JAX package: the text of
an invalid custom configuration's 400 after ``"Invalid configuration: "``
is the port's ``ValidationError.errors()`` (no pydantic ``url`` keys);
its status, ``type`` and ``code`` are the same."""

import os
from enum import Enum
from typing import Annotated, Any, Literal, TypeVar

from dial_rag_tpu_torch.service._model import (
    BaseModel,
    ConfigDict,
    Field,
    ValidationError,
    field_validator,
)
from dial_rag_tpu_torch.service import _yaml
from dial_rag_tpu_torch.errors import InvalidConfigurationError


class IndexRebuildTrigger:
    """Marker for config fields whose change invalidates persisted indexes."""


class BaseConfig(BaseModel):
    model_config = ConfigDict(extra="forbid", frozen=True)


BaseConfigType = TypeVar("BaseConfigType", bound=BaseConfig)


def collect_fields_with_trigger(
    config: BaseModel, trigger_cls=IndexRebuildTrigger
) -> dict[str, Any]:
    out = {}
    for name, field_info in config.__class__.model_fields.items():
        if any(isinstance(meta, trigger_cls) for meta in field_info.metadata):
            value = getattr(config, name)
            if isinstance(value, BaseModel):
                value = value.model_dump(mode="json")
            out[name] = value
    return out


def deep_merge(base: dict, override: dict) -> dict:
    """Dict-merge with override semantics (reference uses deepmerge with
    dict merge / list append / scalar override)."""
    out = dict(base)
    for key, value in override.items():
        if (
            key in out
            and isinstance(out[key], dict)
            and isinstance(value, dict)
        ):
            out[key] = deep_merge(out[key], value)
        elif key in out and isinstance(out[key], list) and isinstance(value, list):
            out[key] = out[key] + value
        else:
            out[key] = value
    return out


def merge_config(
    config: BaseConfigType, new_fields: dict[str, Any]
) -> BaseConfigType:
    merged = deep_merge(config.model_dump(), new_fields)
    return config.model_validate(merged)


def create_update_dict(field_path: str, new_value: Any) -> dict[str, Any]:
    update: dict[str, Any] = new_value
    for part in reversed(field_path.split(".")):
        update = {part: update}
    return update


def update_config_field(
    config: BaseConfigType, field_path: str, new_value: Any
) -> BaseConfigType:
    return merge_config(config, create_update_dict(field_path, new_value))


# --- leaf configs ---------------------------------------------------------


class HttpClientConfig(BaseConfig):
    timeout_seconds: int = Field(
        default=30,
        description="Timeout for the whole request, including connection "
        "establishment, sending the request, and receiving the response.",
    )
    connect_timeout_seconds: int = Field(
        default=30,
        description="Timeout for establishing a connection to the server.",
    )


class LlmConfig(BaseConfig):
    deployment_name: str = Field(
        default="gpt-4.1-2025-04-14",
        description="Deployment name of the LLM used in the chain.",
    )
    max_prompt_tokens: int = Field(
        default=0,
        description="max_prompt_tokens for history truncation; 0 disables.",
    )
    max_retries: int = Field(
        default=2, description="Retries for LLM requests."
    )
    request_timeout_seconds: int = Field(
        default=1200,
        description="Total wall-clock budget for one LLM request, "
        "including a long streamed answer.",
    )
    temperature: float = Field(default=0.0, description="LLM temperature.")


class ParserConfig(BaseConfig):
    max_document_text_size: int = Field(
        default=5 * 1024 * 1024,
        description="Limit on the size of the text extracted from a "
        "document (bytes).",
    )
    chunk_size: Annotated[int, IndexRebuildTrigger()] = Field(
        default=1000,
        description="Chunk size (characters) for the by-title chunker.",
        validation_alias="chunk_size",
    )

    def to_parser_config(self):
        from dial_rag_tpu_torch.documents.parser import ParserConfig as P

        return P(
            max_document_text_size=self.max_document_text_size,
            chunk_size=self.chunk_size,
        )


class EmbedderConfig(BaseConfig):
    """Local embedding model (the reference hard-codes bge-small-en via
    env; here it is a first-class config)."""

    model_path: str = Field(
        default="",
        description="Local HF checkpoint directory for the embedding model "
        "(config.json + model.safetensors + vocab.txt). Empty uses a "
        "deterministic random-weight model (tests/benchmarks only).",
    )
    batch_size: int = Field(
        default=128, description="Embedding batch size per device dispatch."
    )
    warmup_on_startup: bool = Field(
        default=False,
        description="Compile the encoder (all sequence buckets) and the "
        "index-scan kernels during startup so the first request does not "
        "pay jit latency. Adds tens of seconds to boot on a TPU.",
    )


class MultimodalIndexConfig(BaseConfig):
    embeddings_model: Annotated[str, IndexRebuildTrigger()] = Field(
        default="multimodalembedding@001",
        description="Remote multimodal embedding model deployment.",
    )
    metric: Annotated[str, IndexRebuildTrigger()] = Field(
        default="sqeuclidean_dist",
        description="Distance metric for the multimodal index.",
    )
    estimated_image_tokens: int = Field(
        default=500,
        description="Estimated tokens per image for rate limiting.",
    )
    image_size: Annotated[int, IndexRebuildTrigger()] = Field(
        default=1536, description="Page image size for embedding."
    )


class DescriptionIndexConfig(BaseConfig):
    llm: LlmConfig = Field(
        default=LlmConfig(),
        description="Vision LLM used to describe page images.",
    )
    estimated_page_tokens: int = Field(
        default=4000,
        description="Estimated tokens per page for rate limiting.",
    )
    image_size: Annotated[int, IndexRebuildTrigger()] = Field(
        default=800, description="Page image size for description."
    )


class LateInteractionIndexConfig(BaseConfig):
    """Token-level (MaxSim / ColBERT-style) retrieval over the local
    encoder — a capability beyond the reference, off by default. Memory:
    ~min(chunk_tokens, max_chunk_tokens) x D floats per chunk."""

    model_path: Annotated[str, IndexRebuildTrigger()] = Field(
        default="",
        description="Optional dedicated checkpoint for the "
        "late-interaction encoder (e.g. a MaxSim-objective artifact "
        "like checkpoints/alps-maxsim); empty shares the main "
        "embedder. Different weights rebuild the index.",
    )
    max_chunk_tokens: Annotated[int, IndexRebuildTrigger()] = Field(
        default=256,
        description="Per-chunk token embeddings kept in the index "
        "(longer chunks truncate).",
    )
    index_dtype: str = Field(
        default="float32",
        description="HBM storage dtype of the token-embedding tensor; "
        "'bfloat16' halves memory at f32 accumulation; 'int8' is the "
        "quarter-byte capacity layout (per-token absmax quantization "
        "scored as an s8xs8->s32 MXU matmul — approximate: near ties "
        "can reorder).",
    )


class ChargramIndexConfig(BaseConfig):
    """Char-n-gram fuzzy-lexical retrieval (TF-IDF cosine over
    word-boundary-marked char n-grams) — a corpus-only capability beyond
    the reference, off by default. Recovers morphological paraphrase
    matches Porter2 stemming drops; measured to lift held-out paraphrase
    MRR above bm25-only when fused (eval/tune_chargram.py,
    BASELINE.md). Memory: ~1.5k distinct grams per 1000-char chunk in
    the band+CSC layout past the dense byte cap."""

    n_lo: Annotated[int, IndexRebuildTrigger()] = Field(
        default=2,
        ge=1,
        le=8,
        description="Shortest char n-gram (the DEV-selected shape is "
        "2..4).",
    )
    n_hi: Annotated[int, IndexRebuildTrigger()] = Field(
        default=4,
        ge=1,
        le=12,
        description="Longest char n-gram.",
    )


class IndexingConfig(BaseConfig):
    parser: ParserConfig = Field(default=ParserConfig())
    multimodal_index: MultimodalIndexConfig | None = Field(
        default=None,
        description="Enables the multimodal page-image embedding index.",
    )
    description_index: DescriptionIndexConfig | None = Field(
        default=DescriptionIndexConfig(),
        description="Enables the vision-LLM page description index.",
    )
    late_interaction_index: LateInteractionIndexConfig | None = Field(
        default=None,
        description="Enables token-level late-interaction (MaxSim) "
        "retrieval with the local encoder.",
    )
    chargram_index: ChargramIndexConfig | None = Field(
        default=None,
        description="Enables char-n-gram fuzzy-lexical retrieval "
        "(morphology-robust TF-IDF cosine, no model required).",
    )

    def collect_fields_that_rebuild_index(self):
        from dial_rag_tpu_torch.documents.model import IndexSettings

        indexes = {}
        for name in self.__class__.model_fields:
            index_config = getattr(self, name)
            if index_config is not None:
                indexes[name] = collect_fields_with_trigger(index_config)
        return IndexSettings(indexes=indexes)


class QueryChainConfig(BaseConfig):
    llm: LlmConfig = Field(
        default=LlmConfig(),
        description="LLM for the standalone-question reformulation; must "
        "support tool calling if use_history is enabled.",
    )
    use_history: bool = Field(
        default=True,
        description="Summarize chat history into a standalone question; if "
        "false the last user message is used as-is.",
    )


class ChatChainConfig(BaseConfig):
    llm: LlmConfig = Field(
        default=LlmConfig(),
        description="LLM for answer generation; must support vision if "
        "num_page_images_to_use > 0.",
    )
    system_prompt_template_override: str | None = Field(
        default=None, description="Override for the system prompt template."
    )
    use_history: bool = Field(
        default=True,
        description="Pass previous chat messages to the answer model.",
    )
    num_page_images_to_use: int = Field(
        default=4,
        description="Page images passed to the answer model (0 = text-only).",
    )
    page_image_size: int = Field(
        default=1536, description="Size of the page images for the answer."
    )


class QAChainConfig(BaseConfig):
    chat_chain: ChatChainConfig = Field(default=ChatChainConfig())
    query_chain: QueryChainConfig = Field(default=QueryChainConfig())


ENSEMBLE_ARMS = (
    "semantic",
    "late_interaction",
    "bm25",
    "chargram",
    "multimodal",
    "description",
)


class QueryExpansionConfig(BaseConfig):
    """Corpus-trained distributional query expansion for the BM25 arm
    (text/word_vectors.py) — a zero-egress synonymy capability beyond
    the reference. Word vectors (PPMI + truncated SVD over the indexed
    documents' co-occurrence) are built at retriever construction and
    cached; each query's in-vocab words contribute their top distrib-
    utional neighbors as decayed stem weights through the weighted-
    query BM25 path. Defaults are the DEV-selected winner
    (eval/tune_word_vectors.py; handmade paraphrase TEST recall@7
    0.948 -> 0.987 with the chargram arm fused)."""

    window: int = Field(
        default=2, ge=1, description="Co-occurrence window (+/- words)."
    )
    dim: int = Field(
        default=128, ge=8, description="Embedding dimension (SVD rank)."
    )
    min_count: int = Field(
        default=2,
        ge=1,
        description="Minimum corpus frequency for a word to embed.",
    )
    max_vocab: int = Field(
        default=8192,
        ge=64,
        description="Embedded-vocabulary cap (most frequent words win): "
        "bounds the dense co-occurrence matrix at corpus scale.",
    )
    neighbors: int = Field(
        default=5,
        ge=1,
        description="Expansion terms added per query word.",
    )
    alpha: float = Field(
        default=1.0,
        ge=0.0,
        description="Expansion weight multiplier (x cosine similarity).",
    )
    sim_min: float = Field(
        default=0.25,
        description="Minimum cosine similarity for an expansion term.",
    )


class RetrievalConfig(BaseConfig):
    """Fusion tunables for the retriever ensemble."""

    query_expansion: QueryExpansionConfig | None = Field(
        default=None,
        description="Enables distributional query expansion on the BM25 "
        "arm (corpus-trained word vectors; no model download). Off by "
        "default for reference parity.",
    )

    ensemble_weights: dict[str, float] = Field(
        default={},
        description="Per-arm RRF weights keyed by arm name "
        f"({', '.join(ENSEMBLE_ARMS)}); missing arms default to the "
        "reference-parity 1.0, weight 0 disables an arm entirely (it is "
        "not built or queried). The measured recommendation for the "
        "shipped zero-egress checkpoints is {'semantic': 0} — BM25 + "
        "late-interaction fusion dominates the all-arm default on every "
        "eval split (eval/tune_ensemble.py protocol; BASELINE.md).",
    )

    fusion_method: Literal["rrf", "combsum", "combmnz"] = Field(
        default="rrf",
        description="How the arms' hit lists fuse: 'rrf' is the "
        "reference-parity rank-only reciprocal-rank fusion; 'combsum' "
        "and 'combmnz' are score-aware (per-arm list-normalized score "
        "sums; CombMNZ multiplies by the count of arms ranking the doc "
        "in their top-7). The measured zero-egress recommendation is "
        "combmnz with ensemble_weights {'semantic': 0, "
        "'late_interaction': 0.5}: paraphrase-set recall@7 rises to "
        "BM25 parity (0.948 vs rrf's 0.935) while keeping the LLM-set "
        "win (eval/tune_score_fusion.py; BASELINE.md).",
    )
    fusion_norm: Literal["minmax", "zscore"] = Field(
        default="minmax",
        description="Per-arm score normalization for the score-aware "
        "fusion methods (ignored under rrf).",
    )
    fusion_depth: int = Field(
        default=30,
        ge=1,
        le=1000,
        description="Per-arm retrieval depth for the score-aware "
        "fusion methods (ignored under rrf, which serves the "
        "reference-parity k=7): deeper lists give the normalization "
        "real score context; 30 is the measured optimum.",
    )

    @field_validator("ensemble_weights")
    @classmethod
    def _check_arms(cls, v: dict[str, float]) -> dict[str, float]:
        unknown = set(v) - set(ENSEMBLE_ARMS)
        if unknown:
            raise ValueError(
                f"unknown ensemble arm(s) {sorted(unknown)}; "
                f"valid arms: {list(ENSEMBLE_ARMS)}"
            )
        if any(w < 0 for w in v.values()):
            raise ValueError("ensemble weights must be >= 0")
        if v and all(
            v.get(arm, 1.0) == 0 for arm in ENSEMBLE_ARMS
        ):
            raise ValueError("at least one ensemble arm must have weight > 0")
        return v


class RequestType(str, Enum):
    RAG = "rag"
    RETRIEVAL = "retrieval"
    INDEXING = "indexing"


class ApiRequest(BaseConfig):
    type: RequestType = Field(
        default=RequestType.RAG,
        description="Type of the request for the Dial RAG service.",
    )


class RequestConfig(BaseConfig):
    """Per-request tunables (app defaults overridable per request)."""

    ignore_document_loading_errors: bool = Field(
        default=False,
        description="Ignore errors during document loading (multi-document "
        "requests).",
    )
    use_profiler: bool = Field(
        default=False,
        description="Collect a performance profile for the request.",
    )
    log_document_links: bool = Field(
        default=False,
        description="Allow document links in INFO+ level logs.",
    )
    download: HttpClientConfig = Field(default=HttpClientConfig())
    check_access: HttpClientConfig = Field(default=HttpClientConfig())
    indexing: IndexingConfig = Field(default=IndexingConfig())
    retrieval: RetrievalConfig = Field(default=RetrievalConfig())
    qa_chain: QAChainConfig = Field(
        default=QAChainConfig(
            chat_chain=ChatChainConfig(llm=LlmConfig(max_prompt_tokens=16000)),
            query_chain=QueryChainConfig(
                llm=LlmConfig(max_prompt_tokens=8000)
            ),
        )
    )


class Configuration(RequestConfig):
    """Schema served by /configuration; accepted via
    custom_fields.configuration in chat requests."""

    request: ApiRequest = Field(default=ApiRequest())


class IndexStorageConfig(BaseConfig):
    use_dial_file_storage: bool = Field(
        default=False,
        description="Store indexes in the Dial File Storage instead of "
        "memory only.",
    )
    local_storage_path: str = Field(
        default="",
        description="Store indexes under a local directory (self-hosted "
        "deployments without Dial Core file storage).",
    )
    in_memory_cache_capacity: int = Field(
        default=128 * 1024 * 1024,
        description="In-memory LRU capacity (bytes) for document indexes.",
    )


class ParallelConfig(BaseConfig):
    """Device-mesh scale-out. With data_parallel on and more than one
    visible device, the embedder's batches shard over a (dp,) mesh and
    the semantic index rows shard over every device (per-shard stable
    top-k + all-gather merge); results are bit-identical to single-chip
    (see tests/test_sharded_index.py, tests/test_mesh_embedder.py)."""

    data_parallel: bool | None = Field(
        default=None,
        description="Shard encode batches and the dense index over all "
        "visible devices. None (default) = auto: on when more than one "
        "device is visible.",
    )
    index_dtype: str = Field(
        default="float32",
        description="HBM storage dtype of the dense index matrix. "
        "'bfloat16' halves index memory and roughly doubles query scan "
        "throughput (bandwidth-bound); arithmetic stays f32, so only "
        "near-tied candidates can reorder vs the exact default. "
        "'two_pass' keeps bf16+f32 copies (1.5x f32 memory): queries "
        "scan the bf16 copy and re-score a certified candidate window "
        "in f32 — provably identical results to 'float32' at "
        "near-bfloat16 latency. 'int8' stores per-row absmax-quantized "
        "rows (quarter the f32 bytes — the >10M-chunk capacity layout) "
        "scanned as one s8xs8->s32 MXU matmul; row norms are exact, "
        "only the query's own quantization approximates (near ties can "
        "reorder). All four layouts also serve sharded over a device "
        "mesh (per-shard scales/certificates, stable cross-shard "
        "merge).",
    )


class AppConfig(BaseConfig):
    config_path: str = Field(
        default="", description="Path to the yaml configuration file."
    )
    dial_url: str = Field(
        default="http://dial-proxy.dial-proxy",
        description="Url to the dial core.",
    )
    enable_debug_commands: bool = Field(
        default=False,
        description="Enable in-message debug commands (staging only).",
    )
    embedder: EmbedderConfig = Field(default=EmbedderConfig())
    index_storage: IndexStorageConfig = Field(default=IndexStorageConfig())
    parallel: ParallelConfig = Field(default=ParallelConfig())
    request: RequestConfig = Field(default=RequestConfig())


ENV_PREFIX = "DIAL_RAG__"


def _env_overrides(environ: dict[str, str]) -> dict:
    """DIAL_RAG__A__B=x -> {"a": {"b": x}}; bare DIAL_URL-style aliases for
    the reference's validation_alias fields."""
    out: dict = {}
    aliases = {
        "DIAL_URL": "dial_url",
        "ENABLE_DEBUG_COMMANDS": "enable_debug_commands",
    }
    for key, value in environ.items():
        path = None
        if key in aliases:
            path = aliases[key]
        elif key.startswith(ENV_PREFIX):
            path = key[len(ENV_PREFIX) :].lower().replace("__", ".")
        if path is None:
            continue
        parsed: Any = value
        if value.lower() in ("true", "false"):
            parsed = value.lower() == "true"
        elif value.isdigit():
            parsed = int(value)
        out = deep_merge(out, create_update_dict(path, parsed))
    return out


def load_app_config(environ: dict[str, str] | None = None, **init) -> AppConfig:
    """Source order: init > env > yaml (reference app_config.py:49-68)."""
    environ = dict(os.environ if environ is None else environ)
    env = _env_overrides(environ)

    config_path = init.get("config_path") or env.get("config_path") or ""
    yaml_fields: dict = {}
    if config_path:
        with open(config_path) as f:
            yaml_fields = _yaml.safe_load(f) or {}

    merged = deep_merge(deep_merge(yaml_fields, env), init)
    return AppConfig.model_validate(merged)


def validate_custom_configuration(configuration: dict | None) -> dict:
    """Validate custom_fields.configuration against the schema but return
    the original dict (to know which fields were explicitly set)."""
    if not configuration:
        return {}
    try:
        Configuration.model_validate(configuration)
    except ValidationError as e:
        raise InvalidConfigurationError(
            f"Invalid configuration: {e.errors()}"
        ) from e
    return configuration
