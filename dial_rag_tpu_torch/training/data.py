"""Training data: sharded JSONL (query, passage) pair reader.

Feeds training/loop.py from files instead of in-memory lists: each line
is ``{"query": ..., "passage": ...}``; shards are read in a seeded
order with a bounded shuffle buffer (deterministic given the seed, so
checkpoint resume + the loop's skip-consumed-batches logic replays the
same stream)."""

import glob
import json
import logging
from pathlib import Path
from typing import Iterator

import numpy as np

logger = logging.getLogger(__name__)


def jsonl_pairs(
    pattern: str | list[str],
    seed: int = 0,
    shuffle_buffer: int = 4096,
    repeat: int = 1,
) -> Iterator[tuple[str, str]]:
    """Yield (query, passage) pairs from JSONL shard(s).

    - ``pattern``: a glob (or list of paths); shard ORDER is shuffled
      per epoch with the seeded rng.
    - ``shuffle_buffer``: reservoir size for within-stream shuffling
      (0 disables).
    - ``repeat``: number of epochs (-1 = endless).
    """
    if isinstance(pattern, str):
        paths = sorted(glob.glob(pattern))
    else:
        paths = [str(p) for p in pattern]
    if not paths:
        raise FileNotFoundError(f"no training shards match {pattern!r}")
    rng = np.random.default_rng(seed)

    def read_shards(epoch_paths):
        for path in epoch_paths:
            with open(path, encoding="utf-8") as f:
                for line_no, line in enumerate(f, start=1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                        query, passage = row["query"], row["passage"]
                        if not isinstance(query, str) or not isinstance(
                            passage, str
                        ):
                            raise TypeError("non-string pair")
                        yield query, passage
                    except (json.JSONDecodeError, KeyError, TypeError):
                        logger.warning(
                            f"skipping malformed pair at "
                            f"{Path(path).name}:{line_no}"
                        )

    epoch = 0
    while repeat < 0 or epoch < repeat:
        epoch += 1
        epoch_paths = list(paths)
        rng.shuffle(epoch_paths)
        stream = read_shards(epoch_paths)
        if shuffle_buffer <= 1:
            yield from stream
            continue
        buffer: list[tuple[str, str]] = []
        for pair in stream:
            if len(buffer) < shuffle_buffer:
                buffer.append(pair)
                continue
            j = int(rng.integers(0, shuffle_buffer))
            yield buffer[j]
            buffer[j] = pair
        order = rng.permutation(len(buffer))
        for j in order:
            yield buffer[int(j)]


def positive_disjoint_stream(
    pairs: list[tuple[str, str]],
    batch_size: int,
    n_batches: int,
    seed: int = 0,
    pos_key=None,
) -> list[tuple[str, str]]:
    """Arrange (query, positive) pairs into a stream whose consecutive
    ``batch_size`` slices draw from DISTINCT positives.

    In-batch-negatives InfoNCE is poisoned by duplicate positives in a
    batch: for query i, a second pair j with the same passage makes
    logits[i, j] == logits[i, i], so the loss scores a copy of the
    positive as a negative (measured held-out collapse). ICT pairs
    share positives heavily (many sentences per chunk), so batches are
    built positive-disjoint; queries rotate per positive.

    ``pos_key(passage)`` optionally maps passages to a SOURCE key so
    augmented views of one source count as the same positive (two views
    of one chunk in a batch would label a near-copy of the positive as
    a negative).
    """
    rng = np.random.default_rng(seed)
    unique_pos, by_pos, cursors = _group_by_positive(
        pairs, batch_size, pos_key
    )
    stream: list[tuple[str, str]] = []
    while len(stream) < n_batches * batch_size:
        chosen = rng.choice(len(unique_pos), size=batch_size, replace=False)
        for ci in chosen:
            kp = unique_pos[int(ci)]
            qps = by_pos[kp]
            stream.append(qps[cursors[kp] % len(qps)])
            cursors[kp] += 1
    return stream[: n_batches * batch_size]


def _group_by_positive(pairs, batch_size, pos_key):
    if pos_key is None:
        pos_key = lambda p: p  # noqa: E731
    unique_pos = sorted({pos_key(p) for _, p in pairs})
    if len(unique_pos) < 2:
        raise ValueError("contrastive training needs >= 2 distinct positives")
    if batch_size > len(unique_pos):
        raise ValueError(
            f"batch_size {batch_size} exceeds the {len(unique_pos)} "
            "distinct positives: batches could not be positive-disjoint "
            "(duplicate positives poison in-batch-negatives InfoNCE). "
            "Lower the batch size or provide more sources."
        )
    by_pos: dict = {kp: [] for kp in unique_pos}
    for q, p in pairs:
        by_pos[pos_key(p)].append((q, p))
    cursors = {kp: 0 for kp in unique_pos}
    return unique_pos, by_pos, cursors


def hard_negative_stream(
    pairs: list[tuple[str, str]],
    batch_size: int,
    n_batches: int,
    neighbors: dict,
    seed: int = 0,
    pos_key=None,
) -> list[tuple[str, str]]:
    """Positive-disjoint stream whose batches cluster CONFUSABLE
    positives (ANCE/DPR-style hard in-batch negatives).

    Random in-batch negatives teach coarse topic separation; retrieval
    errors live among lexically-similar neighbours. Each batch seeds on
    one source and fills the rest by sampling ``batch_size - 1`` of the
    seed's ranked ``neighbors`` (falling back to random sources when the
    neighbour list runs short), so InfoNCE discriminates among the
    candidates an index would actually confuse.

    ``neighbors[kp]`` is the seed source key's neighbour keys, hardest
    first (e.g. BM25 chunk-as-query ranks). Sampling draws from the top
    ``2 * batch_size`` so consecutive epochs see varied-but-hard batches.
    """
    rng = np.random.default_rng(seed)
    unique_pos, by_pos, cursors = _group_by_positive(
        pairs, batch_size, pos_key
    )
    known = set(unique_pos)
    stream: list[tuple[str, str]] = []
    while len(stream) < n_batches * batch_size:
        seed_kp = unique_pos[int(rng.integers(len(unique_pos)))]
        cand = [
            kp
            for kp in neighbors.get(seed_kp, [])
            if kp in known and kp != seed_kp
        ][: 2 * batch_size]
        take = min(batch_size - 1, len(cand))
        picked = list(
            rng.choice(len(cand), size=take, replace=False)
        ) if take else []
        chosen = {seed_kp, *(cand[int(i)] for i in picked)}
        while len(chosen) < batch_size:  # short neighbour list: pad random
            chosen.add(unique_pos[int(rng.integers(len(unique_pos)))])
        order = sorted(chosen)
        rng.shuffle(order)
        for kp in order:
            qps = by_pos[kp]
            stream.append(qps[cursors[kp] % len(qps)])
            cursors[kp] += 1
    return stream[: n_batches * batch_size]
