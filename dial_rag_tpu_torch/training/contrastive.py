"""Contrastive fine-tuning of the embedding encoder (counterpart of
``dial_rag_tpu/training/contrastive.py``).

The symmetric in-batch-negatives InfoNCE objective of the BGE family,
with the reference's lexical (``teacher_scores``) and corpus-level
(``teacher_corpus`` over a stop-gradient passage bank, with live
``bank_cols``) distillation terms. One train step is a forward and
backward through ``bert_forward`` (whose f32 ``"pallas"`` route runs the
hand-written attention kernels forward and backward on the card), then
an AdamW step and a learning-rate schedule step. The sharded train step
(over a mesh) is the next slice of the port.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dial_rag_tpu_torch.models.bert import BertConfig, bert_forward


@dataclass
class TrainState:
    params: dict  # leaf tensors with requires_grad, the optimizer's parameters
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def _tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _encode(params, ids, mask, *, num_heads, compute_dtype, remat=False, attention_impl="auto"):
    """[B, S] -> [B, H] L2-normalised f32 CLS embeddings, differentiable."""
    hidden = bert_forward(
        params, ids, mask, num_heads=num_heads, compute_dtype=compute_dtype,
        attention_impl=attention_impl, remat=remat,
    )
    cls = hidden[:, 0, :].float()
    return cls / torch.clamp(torch.linalg.vector_norm(cls, dim=-1, keepdim=True), min=1e-12)


def _encode_tokens(params, ids, mask, *, num_heads, compute_dtype, remat, attention_impl="auto"):
    """Per-token L2-normalised hidden states [B, S, H] (the
    late-interaction representation)."""
    hidden = bert_forward(
        params, ids, mask, num_heads=num_heads, compute_dtype=compute_dtype,
        attention_impl=attention_impl, remat=remat,
    ).float()
    norm = torch.sqrt(torch.sum(hidden * hidden, dim=-1, keepdim=True))
    return hidden / torch.clamp(norm, min=1e-12)


def maxsim_scores_pairwise(q_tok, q_mask, p_tok, p_mask):
    """All-pairs MaxSim logits [B, C]: the sum over real q tokens of the max
    over real p tokens of the per-token cosine. The [B, C, S, S] sim tensor
    is materialised. A passage with zero real tokens scores -1e9 against
    every query, so the loss stays finite."""
    sims = torch.einsum("bsd,ctd->bcst", q_tok.float(), p_tok.float())
    sims = torch.where(p_mask[None, :, None, :].bool(), sims, -torch.inf)
    per_q = sims.amax(dim=-1)  # [B, C, S]
    per_q = torch.where(q_mask[:, None, :].bool(), per_q, 0.0)
    scores = per_q.sum(dim=-1)
    has_tokens = p_mask.sum(dim=-1) > 0  # [C]
    return torch.where(has_tokens[None, :], scores, -1e9)


def _soft_cross_entropy(logits, targets):
    return -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def contrastive_loss(
    params,
    batch,
    *,
    num_heads: int,
    temperature: float = 0.02,
    compute_dtype=torch.float32,
    remat: bool = False,
    objective: str = "cls",
    kd_weight: float = 0.5,
    teacher_temperature: float = 4.0,
    corpus_kd_weight: float = 0.5,
    attention_impl: str = "auto",
):
    """Symmetric InfoNCE over in-batch negatives, as the reference defines
    it. ``batch`` holds q_ids/q_mask/p_ids/p_mask [B, S] (numpy arrays or
    tensors, moved to the params' device), and optionally
    ``teacher_scores`` [B, B], or ``teacher_corpus`` [B, N] with
    ``bank_emb`` [N, D] and ``bank_cols`` [B]."""
    device = params["embeddings"]["word"].device
    ids = {k: _tensor(batch[k], device, torch.long) for k in ("q_ids", "p_ids")}
    masks = {k: _tensor(batch[k], device, torch.int32) for k in ("q_mask", "p_mask")}
    enc_kw = dict(
        num_heads=num_heads, compute_dtype=compute_dtype, remat=remat, attention_impl=attention_impl
    )
    if objective == "cls":
        q = _encode(params, ids["q_ids"], masks["q_mask"], **enc_kw)
        p = _encode(params, ids["p_ids"], masks["p_mask"], **enc_kw)
        logits = q @ p.T
    elif objective == "maxsim":
        q_tok = _encode_tokens(params, ids["q_ids"], masks["q_mask"], **enc_kw)
        p_tok = _encode_tokens(params, ids["p_ids"], masks["p_mask"], **enc_kw)
        logits = maxsim_scores_pairwise(q_tok, masks["q_mask"], p_tok, masks["p_mask"])
    else:
        raise ValueError(f"unknown objective: {objective!r}")
    logits = logits / temperature
    labels = torch.arange(logits.shape[0], device=device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    if "teacher_scores" in batch:
        # lexical distillation: a teacher's in-batch score distribution
        # softens the one-hot InfoNCE target
        targets = F.softmax(_tensor(batch["teacher_scores"], device, torch.float32) / teacher_temperature, dim=-1)
        loss = (1.0 - kd_weight) * loss + kd_weight * _soft_cross_entropy(logits, targets)
    if "teacher_corpus" in batch:
        # corpus-level distillation against a stop-gradient passage bank
        if objective != "cls":
            raise ValueError(
                "corpus distillation needs the cls objective "
                "(the bank stores single-vector embeddings)"
            )
        bank = _tensor(batch["bank_emb"], device, torch.float32).detach()  # [N, D]
        if "bank_cols" in batch:
            # live columns: the batch positives' bank rows become the
            # current, differentiable passage embeddings
            bank = bank.index_copy(0, _tensor(batch["bank_cols"], device, torch.long), p)
        logits_c = (q @ bank.T) / temperature
        targets_c = F.softmax(
            _tensor(batch["teacher_corpus"], device, torch.float32) / teacher_temperature, dim=-1
        )
        loss = (1.0 - corpus_kd_weight) * loss + corpus_kd_weight * _soft_cross_entropy(logits_c, targets_c)
    return loss


def make_bank_encoder(config: BertConfig, compute_dtype=torch.float32, block: int = 64):
    """Full-corpus encoder for the distillation bank: [N, S] chunk tokens ->
    [N, D] CLS embeddings, ``block`` rows at a time (activation memory of
    one block whatever the corpus size), with no gradient. The last block
    is padded with all-PAD rows, which are sliced away; numerics match
    the single-vector encode (``_encode``)."""

    @torch.no_grad()
    def encode_bank(params, ids, mask):
        device = params["embeddings"]["word"].device
        ids = _tensor(ids, device, torch.long)
        mask = _tensor(mask, device, torch.int32)
        n = ids.shape[0]
        pad = (-n) % block
        ids = F.pad(ids, (0, 0, 0, pad))
        mask = F.pad(mask, (0, 0, 0, pad))
        embs = [
            _encode(
                params, ids[i : i + block], mask[i : i + block], num_heads=config.num_heads,
                compute_dtype=compute_dtype,
            )
            for i in range(0, n + pad, block)
        ]
        return torch.cat(embs)[:n]

    return encode_bank


def create_train_state(params, optimizer, scheduler) -> TrainState:
    """``params``: the parameter dict the optimizer was built over."""
    return TrainState(params=params, optimizer=optimizer, scheduler=scheduler, step=0)


def make_train_step(
    config: BertConfig,
    mesh=None,
    temperature: float = 0.02,
    compute_dtype=torch.float32,
    remat: bool = False,
    objective: str = "cls",
    kd_weight: float = 0.5,
    teacher_temperature: float = 4.0,
    corpus_kd_weight: float = 0.5,
):
    """The train step: ``step(state, batch) -> loss`` (a detached scalar
    tensor on the params' device) runs the loss forward and backward,
    then one optimizer and one schedule step, in place on ``state``."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded train step is not ported yet: ROADMAP Queue 1 item 10, the sharded train step "
            "(the next bring-up slice); serving shards already (parallel/)"
        )

    def step(state: TrainState, batch) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        loss = contrastive_loss(
            state.params,
            batch,
            num_heads=config.num_heads,
            temperature=temperature,
            compute_dtype=compute_dtype,
            remat=remat,
            objective=objective,
            kd_weight=kd_weight,
            teacher_temperature=teacher_temperature,
            corpus_kd_weight=corpus_kd_weight,
        )
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach()

    return step
