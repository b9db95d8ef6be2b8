"""BERT-family text encoder in PyTorch (counterpart of
``dial_rag_tpu/models/bert.py``): a BERT-family sentence encoder (bge,
e5, gte, MiniLM), its widths from the checkpoint's config.

Parameters are a plain dict of tensors in the reference's layout (dense
kernels [in, out], QKV fused into one [H, 3H] kernel), so a JAX parameter
tree converts leaf by leaf (``weights.params_from_jax_numpy``). Every
product accumulates in f32 under a bf16 ``compute_dtype``; LayerNorm,
softmax and GELU run in f32.

Attention routes (``attention_impl``):

- ``"xla"``: plain PyTorch in the reference's unfused order (its "xla"
  path); the route on the CPU;
- ``"fused"``: each layer is the two fused blocks of
  ``ops.fused_encoder``, whose wrappers launch the hand-written Hopper
  kernels on a CUDA tensor;
- ``"fused_plain"``: the same blocks through their plain versions, the
  reference the kernels are held against on the card;
- ``"fused_layer"``: each layer is one ``ops.fused_encoder.fused_layer_block``
  (the whole-layer kernel; the post-attention state stays on chip);
  ``"fused_layer_plain"``: the same through its plain version;
- ``"pallas"``: the unfused layer with its attention through
  ``ops.flash_attention``, as the reference's "pallas" route: at S <= 512
  ``fused_qkv_attention`` on the packed qkv, longer sequences split into
  heads for ``flash_attention`` (the query-blocked or KV-blocked forward
  above S = 512, by S, and the matching blocked backward). Their autograd
  functions launch the hand-written attention kernels on a CUDA tensor;
- ``"pallas_plain"``: the same autograd functions on their plain versions;
- ``"auto"``: the reference's TPU choice on a CUDA tensor: ``"fused"``
  with tanh GELU at S <= 512 (kernels 1-2, f32 or bf16), else
  ``"pallas"`` (exact GELU at S <= 512: kernels 4 and 8; every S > 512,
  bf16 included: kernel 5 at a single-tile S, the blocked kernels and
  their backward past it). The kernels take the widths of
  ``ops.fused_encoder.KERNEL_INSTANTIATIONS`` (bge-small, bge-base and
  bge-large: H 384 with 12 heads of 32, H 768 with 12 heads of 64, H 1024
  with 16 heads of 64, in f32 and bf16). Where the port lacks a
  route's kernel (another width) the route raises and names it; it never
  falls back to plain PyTorch on the card.
  ``"xla"`` is the route on the CPU.

``bert_forward`` is differentiable; ``remat=True`` recomputes each layer
in the backward (``torch.utils.checkpoint``) instead of saving it.
"""

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dial_rag_tpu_torch.ops import flash_attention as fa
from dial_rag_tpu_torch.ops import fused_encoder as fe

LAYERNORM_EPS = 1e-12
ATTENTION_IMPLS = (
    "auto", "xla", "fused", "fused_plain", "fused_layer", "fused_layer_plain", "pallas", "pallas_plain",
)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2

    @staticmethod
    def tiny() -> "BertConfig":
        """Small config for fast tests."""
        return BertConfig(
            vocab_size=1024,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )


def init_params(
    config: BertConfig, generator: torch.Generator, dtype=torch.float32
) -> dict:
    """Seeded random init (normal, std 0.02; biases 0, LayerNorm 1/0)."""
    c = config

    def normal(*shape):
        return (torch.randn(shape, generator=generator) * 0.02).to(dtype)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out), "bias": torch.zeros(n_out, dtype=dtype)}

    def ln():
        return {
            "scale": torch.ones(c.hidden_size, dtype=dtype),
            "bias": torch.zeros(c.hidden_size, dtype=dtype),
        }

    return {
        "embeddings": {
            "word": normal(c.vocab_size, c.hidden_size),
            "position": normal(c.max_position_embeddings, c.hidden_size),
            "token_type": normal(c.type_vocab_size, c.hidden_size),
            "layernorm": ln(),
        },
        "layers": [
            {
                "qkv": dense(c.hidden_size, 3 * c.hidden_size),
                "attn_out": dense(c.hidden_size, c.hidden_size),
                "attn_ln": ln(),
                "ffn_in": dense(c.hidden_size, c.intermediate_size),
                "ffn_out": dense(c.intermediate_size, c.hidden_size),
                "ffn_ln": ln(),
            }
            for _ in range(c.num_layers)
        ],
    }


def load_hf_weights(state_dict: dict, config: BertConfig) -> dict:
    """Map an HF ``BertModel`` state dict (numpy arrays or tensors) into the
    parameter dict, in f32. torch Linear stores [out, in]; we store
    [in, out]. Keys may carry a ``bert.`` prefix."""

    def get(name):
        for key in (name, "bert." + name):
            if key in state_dict:
                return torch.from_numpy(np.asarray(state_dict[key], dtype=np.float32))
        raise KeyError(name)

    def dense(prefix):
        return {
            "kernel": get(prefix + ".weight").T.contiguous(),
            "bias": get(prefix + ".bias"),
        }

    def lnorm(prefix):
        return {"scale": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    layers = []
    for i in range(config.num_layers):
        p = f"encoder.layer.{i}."
        q, k, v = (dense(p + f"attention.self.{n}") for n in ("query", "key", "value"))
        layers.append(
            {
                "qkv": {
                    "kernel": torch.cat([q["kernel"], k["kernel"], v["kernel"]], dim=1),
                    "bias": torch.cat([q["bias"], k["bias"], v["bias"]]),
                },
                "attn_out": dense(p + "attention.output.dense"),
                "attn_ln": lnorm(p + "attention.output.LayerNorm"),
                "ffn_in": dense(p + "intermediate.dense"),
                "ffn_out": dense(p + "output.dense"),
                "ffn_ln": lnorm(p + "output.LayerNorm"),
            }
        )
    return {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "layernorm": lnorm("embeddings.LayerNorm"),
        },
        "layers": layers,
    }


def export_hf_state(params: dict, config: BertConfig) -> dict:
    """The inverse of ``load_hf_weights``: the parameter dict -> an HF
    ``BertModel`` state dict of f32 numpy arrays (Linear weights [out, in],
    the packed QKV split into query, key and value), so a trained encoder is
    served through ``from_hf_checkpoint`` like any checkpoint;
    ``safetensors_io.save_file`` picks the type on disk."""

    def arr(x):
        return x.detach().to("cpu", torch.float32).numpy()

    def dense(prefix, p):
        return {prefix + ".weight": arr(p["kernel"]).T, prefix + ".bias": arr(p["bias"])}

    def lnorm(prefix, p):
        return {prefix + ".weight": arr(p["scale"]), prefix + ".bias": arr(p["bias"])}

    emb = params["embeddings"]
    state = {
        "embeddings.word_embeddings.weight": arr(emb["word"]),
        "embeddings.position_embeddings.weight": arr(emb["position"]),
        "embeddings.token_type_embeddings.weight": arr(emb["token_type"]),
        **lnorm("embeddings.LayerNorm", emb["layernorm"]),
    }
    h = config.hidden_size
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}."
        qkv_k, qkv_b = arr(layer["qkv"]["kernel"]), arr(layer["qkv"]["bias"])  # [in, 3h], [3h]
        for j, name in enumerate(("query", "key", "value")):
            state[p + f"attention.self.{name}.weight"] = qkv_k[:, j * h : (j + 1) * h].T
            state[p + f"attention.self.{name}.bias"] = qkv_b[j * h : (j + 1) * h]
        state.update(dense(p + "attention.output.dense", layer["attn_out"]))
        state.update(lnorm(p + "attention.output.LayerNorm", layer["attn_ln"]))
        state.update(dense(p + "intermediate.dense", layer["ffn_in"]))
        state.update(dense(p + "output.dense", layer["ffn_out"]))
        state.update(lnorm(p + "output.LayerNorm", layer["ffn_ln"]))
    return state


_MATRICES = ("qkv", "attn_out", "ffn_in", "ffn_out")


def prepare_params(params: dict, device, compute_dtype) -> dict:
    """Params on ``device``: the layers' matrices in ``compute_dtype`` (every
    route casts them so before use), everything else f32. Doing the cast
    once here keeps it out of every forward."""

    def move(t, dtype=torch.float32):
        # detached: an encoder serves trained params as they are, and a
        # training run that goes on does not change what it serves
        return t.detach().to(device=device, dtype=dtype).contiguous()

    out = {
        "embeddings": {
            "word": move(params["embeddings"]["word"]),
            "position": move(params["embeddings"]["position"]),
            "token_type": move(params["embeddings"]["token_type"]),
            "layernorm": {k: move(v) for k, v in params["embeddings"]["layernorm"].items()},
        },
        "layers": [
            {
                name: {
                    k: move(v, compute_dtype if k == "kernel" and name in _MATRICES else torch.float32)
                    for k, v in sub.items()
                }
                for name, sub in layer.items()
            }
            for layer in params["layers"]
        ],
    }
    if "pooling_idf" in params:
        out["pooling_idf"] = move(params["pooling_idf"])
    return out


def _layernorm(x, scale, bias):
    # LayerNorm in f32 whatever the compute dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LAYERNORM_EPS)
    return (y * scale + bias).to(x.dtype)


def _dense(x, p):
    return (fe._f32_matmul(x, p["kernel"], x.dtype) + p["bias"].float()).to(x.dtype)


def _xla_attention(qkv, bias, num_heads):
    """The reference's unfused attention ("xla" route), cast for cast:
    [B, S, 3H] -> [B, S, H]."""
    b, s, three_h = qkv.shape
    dh = three_h // 3 // num_heads
    q, k, v = qkv.reshape(b, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores / np.sqrt(dh) + bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    ctx = (probs.float() @ v.float()).to(qkv.dtype)
    return ctx.transpose(1, 2).reshape(b, s, three_h // 3)


def _unfused_layer(x, layer, attend, gelu):
    """One layer in the reference's unfused order: QKV product, attention
    (``attend``: [B, S, 3H] -> [B, S, H]), out-projection, residual and
    LayerNorm, FFN."""
    x = _layernorm(
        x + _dense(attend(_dense(x, layer["qkv"])), layer["attn_out"]),
        layer["attn_ln"]["scale"],
        layer["attn_ln"]["bias"],
    )
    ffn = _dense(x, layer["ffn_in"])
    if gelu == "exact":
        ffn = torch.nn.functional.gelu(ffn.float()).to(x.dtype)
    else:
        ffn = torch.nn.functional.gelu(ffn, approximate="tanh")
    ffn = _dense(ffn, layer["ffn_out"])
    return _layernorm(x + ffn, layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"])


def _fused_layer(x, layer, attention_mask, num_heads, attn_block, ffn_block):
    x = attn_block(
        x,
        attention_mask,
        layer["qkv"]["kernel"],
        layer["qkv"]["bias"],
        layer["attn_out"]["kernel"],
        layer["attn_out"]["bias"],
        layer["attn_ln"]["scale"],
        layer["attn_ln"]["bias"],
        num_heads,
    )
    return ffn_block(
        x,
        layer["ffn_in"]["kernel"],
        layer["ffn_in"]["bias"],
        layer["ffn_out"]["kernel"],
        layer["ffn_out"]["bias"],
        layer["ffn_ln"]["scale"],
        layer["ffn_ln"]["bias"],
    )


def _layer_weights(layer) -> tuple:
    """The reference's 12-tuple of one layer's weights for ``fused_layer_block``."""
    return tuple(
        layer[name][key]
        for name, key in (
            ("qkv", "kernel"), ("qkv", "bias"), ("attn_out", "kernel"), ("attn_out", "bias"),
            ("attn_ln", "scale"), ("attn_ln", "bias"), ("ffn_in", "kernel"), ("ffn_in", "bias"),
            ("ffn_out", "kernel"), ("ffn_out", "bias"), ("ffn_ln", "scale"), ("ffn_ln", "bias"),
        )
    )


def _pallas_attention(qkv, attention_mask, num_heads, plain):
    """The reference's "pallas" attention: [B, S, 3H] -> [B, S, H]."""
    b, s, three_h = qkv.shape
    if fa.supports_fused_qkv(s):
        return fa.fused_qkv_attention(qkv, attention_mask, num_heads, plain=plain)
    # heads split (views of qkv) for the blocked kernels, then merged
    ctx = fa.flash_attention(*fa._split_heads(qkv, num_heads), attention_mask, plain=plain)
    return ctx.transpose(1, 2).reshape(b, s, three_h // 3)


def embed_tokens(params, input_ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Word + position + token-type embeddings, LayerNorm in f32, then the
    cast to ``compute_dtype``: the input of layer 0."""
    emb = params["embeddings"]
    s = input_ids.shape[1]
    x = (
        emb["word"][input_ids]
        + emb["position"][:s][None, :, :]
        + emb["token_type"][0][None, None, :]
    )
    return _layernorm(x, emb["layernorm"]["scale"], emb["layernorm"]["bias"]).to(compute_dtype)


def resolve_attention_impl(attention_impl, input_ids, gelu):
    """``"auto"`` -> on a CUDA tensor, the route the reference's TPU run
    takes (``dial_rag_tpu/models/bert.py:510-523``); on the CPU, "xla"."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"unsupported attention_impl: {attention_impl!r}")
    if attention_impl != "auto":
        return attention_impl
    if not input_ids.is_cuda:
        return "xla"
    if fe.supports_fused_block(input_ids.shape[1]) and gelu == "tanh":
        return "fused"
    return "pallas"


def bert_forward(
    params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    num_heads: int,
    compute_dtype=torch.float32,
    attention_impl: str = "auto",
    remat: bool = False,
    gelu: str = "auto",
) -> torch.Tensor:
    """[B, S] ids + mask -> [B, S, H] hidden states in ``compute_dtype``.

    ``gelu``: "exact" (erf, HF BertModel), "tanh", or "auto" = exact under
    f32 and tanh under bf16, as in the reference. ``remat=True`` wraps each
    layer in ``torch.utils.checkpoint``: under autograd its activations are
    recomputed in the backward instead of saved."""
    if gelu == "auto":
        gelu = "exact" if compute_dtype == torch.float32 else "tanh"
    attention_impl = resolve_attention_impl(attention_impl, input_ids, gelu)
    s = input_ids.shape[1]
    if attention_impl.startswith("fused"):
        if not fe.supports_fused_block(s):
            raise ValueError(f"attention_impl={attention_impl!r} needs S <= 512, got S={s}")
        if gelu != "tanh":
            raise ValueError(f"attention_impl={attention_impl!r} implements tanh GELU only")
    if attention_impl in ("fused_layer", "fused_layer_plain"):
        block = fe.fused_layer_block if attention_impl == "fused_layer" else fe.fused_layer_block_plain

        def layer_fn(x, layer):
            return block(x, attention_mask, _layer_weights(layer), num_heads)
    elif attention_impl in ("fused", "fused_plain"):
        blocks = (
            (fe.fused_attention_block, fe.fused_ffn_block)
            if attention_impl == "fused"
            else (fe.fused_attention_block_plain, fe.fused_ffn_block_plain)
        )

        def layer_fn(x, layer):
            return _fused_layer(x, layer, attention_mask, num_heads, *blocks)
    else:
        if attention_impl == "xla":
            bias = fe.mask_bias(attention_mask)

            def attend(qkv):
                return _xla_attention(qkv, bias, num_heads)
        else:
            plain = attention_impl == "pallas_plain"

            def attend(qkv):
                return _pallas_attention(qkv, attention_mask, num_heads, plain)

        def layer_fn(x, layer):
            return _unfused_layer(x, layer, attend, gelu)

    x = embed_tokens(params, input_ids, compute_dtype)
    for layer in params["layers"]:
        x = checkpoint(layer_fn, x, layer, use_reentrant=False) if remat else layer_fn(x, layer)
    return x


def pool(hidden, input_ids, attention_mask, pooling: str, pooling_idf=None):
    """[B, S, H] hidden states -> [B, H] L2-normalised f32 embeddings."""
    if pooling == "cls":
        pooled = hidden[:, 0, :].float()
    elif pooling == "idf":
        # idf-weighted sum of per-token L2-normalised hidden states
        h = hidden.float()
        tok = h / torch.clamp(torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True)), min=1e-12)
        w = pooling_idf[input_ids] * attention_mask.float()
        pooled = torch.sum(w[:, :, None] * tok, dim=1)
    else:
        mask = attention_mask.float()[:, :, None]
        pooled = torch.sum(hidden.float() * mask, dim=1)
        pooled = pooled / torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    norm = torch.sqrt(torch.sum(pooled * pooled, dim=-1, keepdim=True))
    return pooled / torch.clamp(norm, min=1e-12)


class BertEncoder:
    """A BERT encoder with bge pooling (cls, mean or idf) over a params dict."""

    def __init__(
        self,
        config: BertConfig,
        compute_dtype=torch.float32,
        attention_impl: str = "auto",
        pooling: str = "cls",
        gelu: str = "auto",
    ):
        if pooling not in ("cls", "mean", "idf"):
            raise ValueError(f"unsupported pooling mode: {pooling!r}")
        if gelu not in ("auto", "exact", "tanh"):
            raise ValueError(f"unsupported gelu mode: {gelu!r}")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unsupported attention_impl: {attention_impl!r}")
        self.config = config
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.pooling = pooling
        self.gelu = gelu

    @torch.inference_mode()
    def encode(self, params, input_ids, attention_mask) -> torch.Tensor:
        """[B, S] -> [B, H] pooled, L2-normalised f32 embeddings."""
        hidden = bert_forward(
            params,
            input_ids,
            attention_mask,
            num_heads=self.config.num_heads,
            compute_dtype=self.compute_dtype,
            attention_impl=self.attention_impl,
            gelu=self.gelu,
        )
        return pool(
            hidden, input_ids, attention_mask, self.pooling, params.get("pooling_idf")
        )
