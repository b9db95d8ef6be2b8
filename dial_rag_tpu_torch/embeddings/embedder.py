"""The local embedding model: tokenizer + encoder + batching policy
(counterpart of ``dial_rag_tpu/embeddings/embedder.py``).

Documents are embedded as they are; queries get the BGE instruction
prefix (dropped under idf pooling, as in the reference); outputs are
L2-normalised poolings. Batches of ``batch_size`` texts run one after the
other; each is padded to its own sequence bucket, and its rows to a power
of two (one batch) or to ``batch_size`` (a bulk encode), as the reference
pads them. PyTorch launches asynchronously, so the host tokenizes the next
batch while the card encodes the current one; the results come back to
the host in one copy.
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
    load_hf_weights,
    prepare_params,
)
from dial_rag_tpu_torch.models.safetensors_io import load_file
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer

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

    def _encode_rows(self, texts: list[str], rows: int) -> torch.Tensor:
        """One encode of ``texts`` padded to ``rows`` rows -> [len, D] on
        the device."""
        ids, mask = self.tokenizer.encode_batch(texts, max_len=self.max_len)
        if rows > len(texts):
            ids = np.pad(ids, ((0, rows - len(texts)), (0, 0)))
            mask = np.pad(mask, ((0, rows - len(texts)), (0, 0)))
        out = self.encoder.encode(
            self.params,
            torch.from_numpy(ids).to(self.device, dtype=torch.long, non_blocking=True),
            torch.from_numpy(mask).to(self.device, non_blocking=True),
        )
        return out[: len(texts)]

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
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        prefixed = [self.query_instruction + t for t in texts]
        return self._encode_rows(prefixed, _bucket_rows(len(texts), self.batch_size)).cpu().numpy()

    def embed_query(self, text: str) -> np.ndarray:
        """[D] float32 with the query instruction prefix."""
        return self.embed_queries([text])[0]
