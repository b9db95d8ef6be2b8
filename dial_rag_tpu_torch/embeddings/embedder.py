"""The local embedding model: tokenizer + encoder + batching policy
(counterpart of ``dial_rag_tpu/embeddings/embedder.py``).

Documents are embedded as they are; queries get the BGE instruction
prefix (dropped under idf pooling, as in the reference); outputs are
L2-normalised poolings; the late-interaction index takes the final hidden
states per token instead (``embed_documents_tokens``). Batches of ``batch_size`` texts run one after the
other; each is padded to its own sequence bucket, and its rows to a power
of two (one batch) or to ``batch_size`` (a bulk encode), as the reference
pads them. PyTorch launches asynchronously, so the host tokenizes the next
batch while the card encodes the current one; the results come back to
the host in one copy.

On the card the encoder's "auto" route takes the fused bf16 blocks under
bf16 and the f32 attention kernels ("pallas") under f32. An embedder
built from trained params (``training.loop.train``) serves them as they
are.

Serving (the ``a*`` methods): query encodes run in the query dispatch
pool and bulk encodes in the indexing dispatch pool
(``runtime/host_pools.py``). Concurrent ``aembed_query`` calls coalesce
into one encode a wave (``runtime/micro_batcher.py``); each caller gets
its row of the wave's output as a view on the device, so a dense scan of
the wave reads that output in place.
"""

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.models.bert import (
    BertConfig,
    BertEncoder,
    bert_forward,
    init_params,
    load_hf_weights,
    prepare_params,
)
from dial_rag_tpu_torch.models.safetensors_io import load_file
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, build_test_vocab
from dial_rag_tpu_torch.runtime.host_pools import run_in_indexing_dispatch_pool, run_in_query_dispatch_pool
from dial_rag_tpu_torch.runtime.micro_batcher import MicroBatcher, PerLoopBatcher, wave_rows

# langchain_community's DEFAULT_QUERY_BGE_INSTRUCTION_EN, which the
# reference inherits via HuggingFaceBgeEmbeddings defaults.
DEFAULT_QUERY_INSTRUCTION = "Represent this question for searching relevant passages: "

EMBEDDINGS_BATCH_SIZE = 128


def _bucket_rows(n: int, cap: int) -> int:
    """Row count of a lone batch: a power of two (>= 8, <= cap), as the
    reference pads it."""
    if n >= cap:
        return n
    return min(cap, max(8, 1 << (n - 1).bit_length()))


@dataclass
class BgeEmbedder:
    tokenizer: WordPieceTokenizer
    encoder: BertEncoder
    params: dict
    device: str | torch.device = "cuda"
    query_instruction: str = DEFAULT_QUERY_INSTRUCTION
    batch_size: int = EMBEDDINGS_BATCH_SIZE
    max_len: int = 512
    # identity of the weights; persisted indexes are keyed on it, so it is
    # byte-identical to the reference's for the same checkpoint
    model_id: str = "random"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = prepare_params(self.params, self.device, self.encoder.compute_dtype)

    @classmethod
    def from_random(
        cls,
        config: BertConfig | None = None,
        vocab: dict | None = None,
        seed: int = 0,
        compute_dtype=torch.float32,
        device="cuda",
        **kw,
    ) -> "BgeEmbedder":
        """Seeded random-weight embedder (tests, benchmarks); deployments
        load a checkpoint with ``from_hf_checkpoint``. Its ``model_id``
        names the seed, the widths and the vocabulary, in the reference's
        format, so indexes built by one tokenization are never served by
        another."""
        config = config or BertConfig.tiny()
        if vocab is None:
            vocab = build_test_vocab([chr(c) for c in range(97, 123)])
        vocab_tag = hashlib.sha256("\x00".join(sorted(vocab)).encode("utf-8")).hexdigest()[:8]
        kw.setdefault(
            "model_id", f"random-{seed}-{config.hidden_size}x{config.num_layers}v{config.vocab_size}-{vocab_tag}"
        )
        return cls(
            tokenizer=WordPieceTokenizer(vocab=vocab),
            encoder=BertEncoder(config, compute_dtype=compute_dtype),
            params=init_params(config, torch.Generator().manual_seed(seed)),
            device=device,
            **kw,
        )

    @classmethod
    def from_hf_checkpoint(
        cls, model_dir: str, compute_dtype=torch.bfloat16, device="cuda", **kw
    ) -> "BgeEmbedder":
        """Load a local checkpoint directory: a plain HF ``BertModel``
        (config.json + model.safetensors or pytorch_model.bin + vocab.txt),
        or a ``SentenceTransformer.save()`` tree (modules.json naming the
        Transformer dir, ``1_Pooling/config.json`` choosing cls or mean,
        ``sentence_bert_config.json`` carrying max_seq_length). An
        ``idf_pooling.npz`` beside it selects idf pooling."""

        def read_json(*parts):
            with open(os.path.join(*parts)) as f:
                return json.load(f)

        transformer_dir = model_dir
        pooling = "cls"
        if os.path.isfile(os.path.join(model_dir, "modules.json")):
            for module in read_json(model_dir, "modules.json"):
                subdir = os.path.join(model_dir, module.get("path", ""))
                kind = module.get("type", "")
                if kind.endswith("models.Transformer"):
                    transformer_dir = subdir
                elif kind.endswith("models.Pooling"):
                    pool_cfg = read_json(subdir, "config.json")
                    if pool_cfg.get("pooling_mode_cls_token"):
                        pooling = "cls"
                    elif pool_cfg.get("pooling_mode_mean_tokens"):
                        pooling = "mean"
                    else:
                        raise ValueError(
                            f"unsupported pooling config in {subdir}: "
                            "need cls or mean token pooling"
                        )
            st_cfg_path = os.path.join(transformer_dir, "sentence_bert_config.json")
            if os.path.isfile(st_cfg_path):
                max_len = read_json(st_cfg_path).get("max_seq_length")
                if max_len:
                    kw.setdefault("max_len", int(max_len))

        hf = read_json(transformer_dir, "config.json")
        config = BertConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=hf.get("type_vocab_size", 2),
        )
        weights_path = os.path.join(transformer_dir, "model.safetensors")
        if os.path.isfile(weights_path):
            state = load_file(weights_path)
        else:
            weights_path = os.path.join(transformer_dir, "pytorch_model.bin")
            if not os.path.isfile(weights_path):
                raise FileNotFoundError(
                    f"no model.safetensors or pytorch_model.bin under {transformer_dir}"
                )
            state = torch.load(weights_path, map_location="cpu", weights_only=True)
        params = load_hf_weights(state, config)
        idf_path = os.path.join(model_dir, "idf_pooling.npz")
        if os.path.isfile(idf_path):
            weights = np.load(idf_path)["weights"].astype(np.float32)
            if weights.shape != (config.vocab_size,):
                raise ValueError(
                    f"idf_pooling.npz weights shape {weights.shape} does "
                    f"not match vocab_size {config.vocab_size}"
                )
            params["pooling_idf"] = torch.from_numpy(weights)
            pooling = "idf"
            # the instruction tunes the CLS objective; under idf pooling its
            # rare (high-idf) tokens would dominate every query vector
            kw.setdefault("query_instruction", "")
        tokenizer = WordPieceTokenizer.from_vocab_file(
            os.path.join(transformer_dir, "vocab.txt"),
            lowercase=hf.get("do_lower_case", True),
        )
        if "model_id" not in kw:
            # content hash, computed exactly as the reference computes it
            digest = hashlib.sha256()
            digest.update(f"pooling={pooling};max_len={kw.get('max_len', '')}".encode())
            for part in (
                weights_path,
                idf_path,
                os.path.join(transformer_dir, "vocab.txt"),
                os.path.join(transformer_dir, "config.json"),
            ):
                if os.path.isfile(part):
                    with open(part, "rb") as f:
                        for block in iter(lambda: f.read(1 << 20), b""):
                            digest.update(block)
            kw["model_id"] = f"sha256:{digest.hexdigest()[:16]}"
        return cls(
            tokenizer=tokenizer,
            encoder=BertEncoder(config, compute_dtype=compute_dtype, pooling=pooling),
            params=params,
            device=device,
            **kw,
        )

    @property
    def dim(self) -> int:
        return self.encoder.config.hidden_size

    def _encode_padded(self, texts: list[str], rows: int) -> torch.Tensor:
        """One encode of ``texts`` padded to ``rows`` rows -> [rows, D] on
        the device; the rows past ``len(texts)`` encode padding."""
        ids, mask = self.tokenizer.encode_batch(texts, max_len=self.max_len)
        if rows > len(texts):
            ids = np.pad(ids, ((0, rows - len(texts)), (0, 0)))
            mask = np.pad(mask, ((0, rows - len(texts)), (0, 0)))
        return self.encoder.encode(
            self.params,
            torch.from_numpy(ids).to(self.device, dtype=torch.long, non_blocking=True),
            torch.from_numpy(mask).to(self.device, non_blocking=True),
        )

    def _encode_rows(self, texts: list[str], rows: int) -> torch.Tensor:
        """``_encode_padded``'s real rows, [len, D]."""
        return self._encode_padded(texts, rows)[: len(texts)]

    def embed_documents_device(self, texts: list[str]) -> torch.Tensor:
        """[n, D] f32 embeddings left on the device."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        if len(texts) <= self.batch_size:
            return self._encode_rows(texts, _bucket_rows(len(texts), self.batch_size))
        outs = [
            self._encode_rows(texts[i : i + self.batch_size], self.batch_size)
            for i in range(0, len(texts), self.batch_size)
        ]
        return torch.cat(outs, dim=0)

    def embed_documents(self, texts: list[str]) -> np.ndarray:
        """[n, D] float32 on the host (for record persistence)."""
        return self.embed_documents_device(texts).cpu().numpy()

    def embed_queries(self, texts: list[str]) -> np.ndarray:
        """[n, D] query embeddings (instruction-prefixed), one encode."""
        return self.embed_queries_device(texts).cpu().numpy()

    def embed_queries_device(self, texts: list[str]) -> torch.Tensor:
        """[n, D] query embeddings left on the device, one encode (a view of
        its output)."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        return self._embed_queries_wave(texts)[0][: len(texts)]

    def _embed_queries_wave(self, texts: list[str]) -> tuple[torch.Tensor, int]:
        """(the [Qb, D] output of one encode of the instruction-prefixed
        ``texts``, n): rows past n encode padding and are ignored. Qb is
        the rows of a lone batch, a power of two."""
        prefixed = [self.query_instruction + t for t in texts]
        return self._encode_padded(prefixed, _bucket_rows(len(texts), self.batch_size)), len(texts)

    async def aembed_query(self, text: str) -> torch.Tensor:
        """The query's [D] embedding on the device: a row (a view) of the
        output of the encode that concurrent queries share
        (``_query_batcher``). Query encodes take their own lane, so they
        never queue behind a bulk indexing stream. ``DenseIndex.afind``
        scans a wave of such rows in place."""
        return await self._query_batcher.submit(text)

    @property
    def _query_batcher(self) -> PerLoopBatcher:
        batcher = self.__dict__.get("_query_batcher_cached")
        if batcher is None:

            async def encode_all(texts: list[str]) -> list[torch.Tensor]:
                out, n = await run_in_query_dispatch_pool(self._embed_queries_wave, texts)
                return wave_rows(out, n)

            batcher = PerLoopBatcher(lambda: MicroBatcher(encode_all, name="query_encode"))
            self.__dict__["_query_batcher_cached"] = batcher
        return batcher

    async def aembed_documents(self, texts: list[str]) -> np.ndarray:
        """``embed_documents`` in the indexing dispatch pool: concurrent
        indexing streams interleave at batch granularity."""
        return await run_in_indexing_dispatch_pool(self.embed_documents, texts)

    def embed_query(self, text: str) -> np.ndarray:
        """[D] float32 with the query instruction prefix."""
        return self.embed_queries([text])[0]

    def _token_hidden(self, texts: list[str], max_tokens: int):
        """One encode of ``texts`` (rows padded as a lone batch) -> (the
        [rows, S, D] f32 final hidden states L2-normalised per token on the
        device, the [rows, S] mask on the device, the mask on the host)."""
        ids, mask = self.tokenizer.encode_batch(texts, max_len=min(self.max_len, max_tokens))
        rows = _bucket_rows(len(texts), self.batch_size)
        if rows > len(texts):
            ids = np.pad(ids, ((0, rows - len(texts)), (0, 0)))
            mask = np.pad(mask, ((0, rows - len(texts)), (0, 0)))
        mask_t = torch.from_numpy(mask).to(self.device, non_blocking=True)
        with torch.inference_mode():
            hidden = bert_forward(
                self.params,
                torch.from_numpy(ids).to(self.device, dtype=torch.long, non_blocking=True),
                mask_t,
                num_heads=self.encoder.config.num_heads,
                compute_dtype=self.encoder.compute_dtype,
                attention_impl=self.encoder.attention_impl,
                gelu=self.encoder.gelu,
            ).float()
            norm = torch.sqrt(torch.sum(hidden * hidden, dim=-1, keepdim=True))
            hidden = hidden / torch.clamp(norm, min=1e-12)
        return hidden, mask_t, mask

    def embed_documents_tokens(self, texts: list[str], max_tokens: int = 256) -> list[np.ndarray]:
        """Per-token embeddings for the late-interaction (MaxSim) index: one
        ``[t_i, D]`` f32 array per text, the encoder's final hidden states
        L2-normalised per token, real tokens only (CLS and SEP included),
        truncated to ``max_tokens``. One encode a batch of ``batch_size``."""
        out: list[np.ndarray] = []
        for i in range(0, len(texts), self.batch_size):
            batch = texts[i : i + self.batch_size]
            hidden, _, mask = self._token_hidden(batch, max_tokens)
            hidden = hidden.cpu().numpy()
            out.extend(hidden[row, : int(mask[row].sum())] for row in range(len(batch)))
        return out

    def embed_query_tokens(self, text: str, max_tokens: int = 64) -> np.ndarray:
        """[t, D] per-token query embeddings for MaxSim; no instruction
        prefix (it tunes the CLS pooling, not token-level matching)."""
        return self.embed_documents_tokens([text], max_tokens=max_tokens)[0]

    async def aembed_query_tokens(self, text: str) -> np.ndarray:
        return await run_in_query_dispatch_pool(self.embed_query_tokens, text)

    async def aembed_query_tokens_device(self, text: str) -> torch.Tensor:
        return await run_in_query_dispatch_pool(self.embed_query_tokens_device, text)

    async def aembed_documents_tokens(self, texts: list[str], max_tokens: int = 256) -> list[np.ndarray]:
        return await run_in_indexing_dispatch_pool(self.embed_documents_tokens, texts, max_tokens)

    def embed_query_tokens_device(self, text: str, max_tokens: int = 64) -> torch.Tensor:
        """[q_pad, D] per-token query embeddings left on the device, padded
        positions exactly zero, at the power-of-two lane bucket the host
        path pads to, so ``LateInteractionIndex.find`` scores them as it
        scores ``embed_query_tokens``. The mask and slice are a step of
        their own after the encode, exact operations on its output, so the
        real rows are the host path's bits."""
        from dial_rag_tpu_torch.index.late_interaction import _MAX_Q_LANES, _bucket_q

        hidden, mask_t, mask = self._token_hidden([text], max_tokens)
        q_pad = _bucket_q(max(1, min(int(mask[0].sum()), _MAX_Q_LANES)))
        rows = (hidden * mask_t[..., None].to(hidden.dtype))[0]
        if q_pad <= rows.shape[0]:
            return rows[:q_pad]
        return torch.nn.functional.pad(rows, (0, 0, 0, q_pad - rows.shape[0]))
