"""Training loop with checkpoint and resume for the contrastive objective
(counterpart of ``dial_rag_tpu/training/loop.py``).

- host-side tokenization of text pairs through the serving tokenizer;
- AdamW with the reference's optax schedule (linear warmup from 0, then
  cosine decay), reproduced step for step;
- checkpoints of {params, optimizer and scheduler state, step} with
  ``torch.save``, written under a temporary name and renamed, the last 3
  kept, resume from the latest;
- ``device`` defaults to ``cuda``; pass ``device="cpu"`` to train on the
  CPU (through the plain versions of the kernels).
"""

import logging
import math
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from dial_rag_tpu_torch.device import resolve_device
from dial_rag_tpu_torch.models.bert import BertConfig, init_params
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from dial_rag_tpu_torch.training.contrastive import (
    TrainState,
    create_train_state,
    make_bank_encoder,
    make_train_step,
)
from dial_rag_tpu_torch.weights import map_params, param_leaves

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    seq_len: int = 128
    learning_rate: float = 2e-5
    warmup_steps: int = 100
    total_steps: int = 1000
    # InfoNCE temperature; None resolves per objective in __post_init__:
    # 0.02 for cosine-calibrated CLS logits in [-1, 1], 1.0 for MaxSim
    # logits (sums over ~query-length tokens, an order of magnitude
    # larger — 0.02 there causes measured held-out collapse)
    temperature: float | None = None
    checkpoint_every: int = 200
    seed: int = 0
    # rematerialize encoder layers in the backward: O(1)-layer
    # activation memory for ~1/3 extra FLOPs (long-seq / big batches)
    remat: bool = False
    # "cls" = single-vector bge-style representation (semantic retriever);
    # "maxsim" = token-level late-interaction representation
    objective: str = "cls"
    # lexical-distillation mix (active only when a teacher provides
    # per-batch scores): loss = (1-kd_weight)*InfoNCE + kd_weight*KD
    kd_weight: float = 0.5
    teacher_temperature: float = 4.0
    # corpus-level distillation (active only when train() gets
    # bank_tokens + a corpus_teacher): mix weight of the
    # full-corpus KD term and the stop-gradient passage-bank refresh
    # cadence in steps (ANCE/TAS-B-style cached embeddings)
    corpus_kd_weight: float = 0.5
    bank_refresh_every: int = 100

    def __post_init__(self):
        if self.objective not in ("cls", "maxsim"):
            raise ValueError(f"unknown objective {self.objective!r}")
        if self.bank_refresh_every < 1:
            raise ValueError(
                "bank_refresh_every must be >= 1 (the bank is encoded "
                "at step 0 and re-encoded every bank_refresh_every steps)"
            )
        if self.temperature is None:
            object.__setattr__(
                self,
                "temperature",
                0.02 if self.objective == "cls" else 1.0,
            )


def warmup_cosine_lr(config: TrainConfig, count: int) -> float:
    """The learning rate of update ``count`` (0-based), as
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))`` gives it: linear from 0 over the warmup, then a cosine
    decay to 0 at the total."""
    peak, warmup = config.learning_rate, config.warmup_steps
    if count < warmup:
        return peak * count / warmup
    decay = max(config.total_steps, warmup + 1) - warmup
    t = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def make_optimizer(config: TrainConfig, params: dict):
    """AdamW (betas 0.9/0.999, eps 1e-8, weight decay 0.01, as optax's
    ``adamw``) over every leaf of ``params`` (biases and LayerNorm
    included: the reference masks none) and the warmup-cosine schedule as
    a ``LambdaLR``. The first update runs at lr 0."""
    optimizer = torch.optim.AdamW(
        param_leaves(params),
        lr=config.learning_rate,
        betas=(0.9, 0.999),
        eps=1e-8,
        weight_decay=0.01,
    )
    peak = config.learning_rate
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: warmup_cosine_lr(config, count) / peak if peak else 0.0
    )
    return optimizer, scheduler


def pairs_to_batches(
    tokenizer: WordPieceTokenizer,
    pairs: Iterable[tuple[str, str]],
    config: TrainConfig,
    teacher=None,
    corpus_teacher=None,
) -> Iterator[dict]:
    """(query, passage) text pairs -> numpy token batches with q and p
    padded to one S, dropping the ragged tail. ``teacher(buf)`` may return
    a [B, B] score matrix attached as ``teacher_scores``;
    ``corpus_teacher(buf)`` a [B, N] full-corpus score matrix (or a tuple
    of it and the batch's [B] live bank columns) attached as
    ``teacher_corpus`` (and ``bank_cols``)."""
    buf: list[tuple[str, str]] = []
    for pair in pairs:
        buf.append(pair)
        if len(buf) == config.batch_size:
            q_ids, q_mask = tokenizer.encode_batch([q for q, _ in buf], max_len=config.seq_len)
            p_ids, p_mask = tokenizer.encode_batch([p for _, p in buf], max_len=config.seq_len)
            s = max(q_ids.shape[1], p_ids.shape[1])

            def pad(a):
                return np.pad(a, ((0, 0), (0, s - a.shape[1])))

            batch = {"q_ids": pad(q_ids), "q_mask": pad(q_mask), "p_ids": pad(p_ids), "p_mask": pad(p_mask)}
            if teacher is not None:
                batch["teacher_scores"] = np.asarray(teacher(buf), dtype=np.float32)
            if corpus_teacher is not None:
                rows = corpus_teacher(buf)
                if isinstance(rows, tuple):
                    rows, cols = rows
                    cols = np.asarray(cols, dtype=np.int32)
                    if len(np.unique(cols)) != len(cols):
                        # duplicate columns would make the live scatter keep
                        # an arbitrary competing row: silent wrong gradients
                        raise ValueError(
                            "corpus_teacher returned duplicate bank "
                            "columns in one batch; build batches "
                            "positive-disjoint at pos_key granularity"
                        )
                    batch["bank_cols"] = cols
                batch["teacher_corpus"] = np.asarray(rows, dtype=np.float32)
            yield batch
            buf = []


class Checkpointer:
    """Save and restore of {params, optimizer and scheduler state, step}:
    one ``step_<N>.pt`` file per checkpoint, written under a temporary
    name and renamed, the last 3 kept."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")
    _KEEP = 3

    def __init__(self, directory: str):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list[int]:
        found = (self._NAME.match(p.name) for p in self._dir.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self._dir / f"step_{step:08d}.pt"

    def save(self, step: int, state: TrainState) -> None:
        payload = {
            "step": step,
            "params": [t.detach().cpu() for t in param_leaves(state.params)],
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
        }
        tmp = self._dir / f".step_{step:08d}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[: -self._KEEP]:
            self.path(old).unlink(missing_ok=True)

    def restore(self, state: TrainState) -> int | None:
        """Loads the latest checkpoint into ``state`` (params in place,
        optimizer and scheduler state); returns its step, or None when the
        directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self.path(step), map_location="cpu", weights_only=True)
        leaves = param_leaves(state.params)
        if len(leaves) != len(payload["params"]):
            raise ValueError(f"checkpoint holds {len(payload['params'])} tensors, the model {len(leaves)}")
        with torch.no_grad():
            for leaf, saved in zip(leaves, payload["params"]):
                leaf.copy_(saved)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = step
        return step


def trainable_params(params: dict, device) -> dict:
    """A copy of ``params`` (the parameter dict of ``init_params`` or a
    checkpoint) as f32 leaf tensors on ``device`` that require grad."""
    return map_params(
        lambda t: t.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True), params
    )


def train(
    model_config: BertConfig,
    train_config: TrainConfig,
    pairs: Iterable[tuple[str, str]],
    tokenizer: WordPieceTokenizer,
    mesh=None,
    checkpoint_dir: str | None = None,
    init: dict | None = None,
    teacher=None,
    corpus_teacher=None,
    bank_tokens: tuple | None = None,
    device="cuda",
    on_step: Callable[[TrainState, torch.Tensor], None] | None = None,
):
    """Run the loop; returns (params, losses). Resumes from the latest
    checkpoint in ``checkpoint_dir`` when one exists, skipping the batches
    the checkpointed run consumed. ``init=None`` takes the seeded
    ``init_params``; the params are trained in f32 on ``device``.

    ``corpus_teacher(buf) -> [B, N]`` + ``bank_tokens`` (the corpus's
    (ids, mask) token arrays, [N, S]) enable corpus-level distillation:
    every ``bank_refresh_every`` steps the full corpus is re-encoded with
    the current params into a stop-gradient embedding bank.
    ``on_step(state, loss)`` is called after every step."""
    if mesh is not None:
        raise NotImplementedError("a sharded train loop is not ported yet (ROADMAP: parallel)")
    if (corpus_teacher is None) != (bank_tokens is None):
        raise ValueError("corpus distillation needs BOTH corpus_teacher and bank_tokens")
    device = resolve_device(device)
    if init is None:
        init = init_params(model_config, torch.Generator().manual_seed(train_config.seed))
    params = trainable_params(init, device)
    state = create_train_state(params, *make_optimizer(train_config, params))

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    start_step = 0
    if ckpt is not None and ckpt.restore(state) is not None:
        start_step = state.step
        logger.info(f"resumed from step {start_step}")

    step_fn = make_train_step(
        model_config,
        temperature=train_config.temperature,
        remat=train_config.remat,
        objective=train_config.objective,
        kd_weight=train_config.kd_weight,
        teacher_temperature=train_config.teacher_temperature,
        corpus_kd_weight=train_config.corpus_kd_weight,
    )
    encode_bank = make_bank_encoder(model_config) if bank_tokens is not None else None
    bank_emb = None

    losses = []  # device scalars, read once at the end
    last_saved = ckpt.latest_step() if ckpt is not None else None
    batches = pairs_to_batches(tokenizer, pairs, train_config, teacher=teacher, corpus_teacher=corpus_teacher)
    # resume continues the data stream where the checkpointed run left off
    for _ in range(start_step):
        if next(batches, None) is None:
            break
    for batch in batches:
        if state.step >= train_config.total_steps:
            break
        if encode_bank is not None:
            if bank_emb is None or state.step % train_config.bank_refresh_every == 0:
                # stop-gradient refresh with the current params
                bank_emb = encode_bank(state.params, *bank_tokens)
            batch["bank_emb"] = bank_emb
        loss = step_fn(state, batch)
        losses.append(loss)
        if state.step % 1000 == 0:
            # heartbeat from host state only: no wait on the device
            print(f"train step {state.step}/{train_config.total_steps}", flush=True)
        if on_step is not None:
            on_step(state, loss)
        if ckpt is not None and state.step % train_config.checkpoint_every == 0:
            ckpt.save(state.step, state)
            last_saved = state.step
    if ckpt is not None and state.step > start_step and state.step != last_saved:
        ckpt.save(state.step, state)
    return map_params(torch.Tensor.detach, state.params), [float(x) for x in losses]
