"""Corpus-trained distributional word vectors for query expansion
(counterpart of ``dial_rag_tpu/text/word_vectors.py``, which it copies).

PPMI over a +/-window word co-occurrence matrix with context-distribution
smoothing, then a truncated randomized SVD seeded from ``seed``: host
numpy at index construction, the same bits as the JAX package's on the
same machine. ``expand_query`` maps each query word's nearest corpus
words to stems with decayed weights; ``Bm25Retriever`` scores the
expanded stem -> weight mapping through the weighted-query BM25 path.
"""

import re
from collections import Counter
from dataclasses import dataclass

import numpy as np

from dial_rag_tpu_torch.text.keywords import keywords_preprocess

_WORD_RE = re.compile(r"[a-z0-9]+")


@dataclass(frozen=True)
class QueryExpansionConfig:
    """The service's ``QueryExpansionConfig`` fields and defaults
    (``dial_rag_tpu/service/config.py``), as a plain dataclass: the
    co-occurrence window, the SVD rank, the minimum corpus count, the
    vocabulary cap, the neighbours added per query word, their weight
    multiplier and their least cosine."""

    window: int = 2
    dim: int = 128
    min_count: int = 2
    max_vocab: int = 8192
    neighbors: int = 5
    alpha: float = 1.0
    sim_min: float = 0.25


@dataclass
class WordVectors:
    """Unit-norm word embedding table with its vocab maps."""

    vecs: np.ndarray  # [V, dim] f32, L2-normalized rows
    index: dict  # word -> row
    words: list  # row -> word

    @property
    def nbytes(self) -> int:
        return int(self.vecs.nbytes)


def build_word_vectors(
    chunk_texts: list[str],
    window: int = 2,
    dim: int = 128,
    min_count: int = 2,
    cds: float = 0.75,
    shift: float = 1.0,
    seed: int = 0,
    max_vocab: int = 8192,
) -> WordVectors:
    """PPMI + truncated randomized SVD word vectors from the corpus.

    Defaults are the DEV-selected stage-1 winner
    (eval/out/word_vectors.json): window 2, dim 128, no shift.

    ``max_vocab`` bounds the dense [V, V] co-occurrence matrix (256 MB
    f32 at the default) — the vocabulary keeps the most frequent words,
    which are also the only ones with enough co-occurrence signal to
    embed; corpus-scale corpora would otherwise go quadratic."""
    toks_per_chunk = [_WORD_RE.findall(t.lower()) for t in chunk_texts]
    counts = Counter(w for toks in toks_per_chunk for w in toks)
    eligible = [(w, c) for w, c in counts.items() if c >= min_count]
    if len(eligible) > max_vocab:
        # deterministic: frequency desc, then lexicographic
        eligible.sort(key=lambda wc: (-wc[1], wc[0]))
        eligible = eligible[:max_vocab]
    words = sorted(w for w, _ in eligible)
    index = {w: i for i, w in enumerate(words)}
    v = len(words)
    if v == 0:
        return WordVectors(np.zeros((0, dim), np.float32), {}, [])
    cooc = np.zeros((v, v), dtype=np.float32)
    # vectorized accumulation: all chunks concatenate into one id
    # stream with `window` separator sentinels between chunks (so no
    # pair crosses a chunk boundary), then each offset d in 1..window
    # is ONE masked np.add.at over the whole corpus — the Python pair
    # loop measured unusable at corpus scale
    parts = []
    sep = np.full(window, -1, dtype=np.int64)
    for toks in toks_per_chunk:
        parts.append(
            np.fromiter(
                (index.get(w, -1) for w in toks),
                dtype=np.int64,
                count=len(toks),
            )
        )
        parts.append(sep)
    all_ids = (
        np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
    )
    for d in range(1, window + 1):
        if all_ids.shape[0] <= d:
            break
        a, b = all_ids[:-d], all_ids[d:]
        keep = (a >= 0) & (b >= 0)
        if keep.any():
            np.add.at(cooc, (a[keep], b[keep]), 1.0)
            np.add.at(cooc, (b[keep], a[keep]), 1.0)
    total = cooc.sum()
    if total == 0:
        return WordVectors(np.zeros((v, dim), np.float32), index, words)
    pw = cooc.sum(axis=1) / total
    pc = cooc.sum(axis=0) ** cds
    pc /= pc.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log(
            (cooc / total)
            / np.outer(np.maximum(pw, 1e-12), np.maximum(pc, 1e-12))
        )
    pmi[~np.isfinite(pmi)] = 0.0
    ppmi = np.maximum(pmi - np.log(shift), 0.0).astype(np.float32)
    rng = np.random.default_rng(seed)
    d = min(dim, v)
    g = rng.standard_normal((v, d + 10)).astype(np.float32)
    y = ppmi @ g
    q, _ = np.linalg.qr(y)
    b = q.T @ ppmi
    ub, s, _ = np.linalg.svd(b, full_matrices=False)
    u = (q @ ub)[:, :d]
    vecs = u * np.sqrt(np.maximum(s[:d], 0.0))[None, :]
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = (vecs / np.maximum(norms, 1e-12)).astype(np.float32)
    return WordVectors(vecs, index, words)


def expand_query(
    query: str,
    wv: WordVectors,
    m: int = 5,
    alpha: float = 1.0,
    sim_min: float = 0.25,
    include_original: bool = True,
) -> dict:
    """Stem->weight expansion of a query.

    Original stems at weight 1 (when ``include_original``) plus each
    in-vocab query word's top-``m`` distributional neighbors at weight
    ``alpha * cosine``, skipping neighbors that stem-collide with the
    query (morphological variants belong to the chargram arm; this one
    targets synonymy). Defaults are the DEV-selected winner."""
    weights: Counter = Counter()
    q_stems = keywords_preprocess(query)
    if include_original:
        for s in q_stems:
            weights[s] += 1.0
    q_stem_set = set(q_stems)
    if wv.vecs.shape[0] == 0:
        return dict(weights)
    for w in dict.fromkeys(_WORD_RE.findall(query.lower())):
        i = wv.index.get(w)
        if i is None:
            continue
        sims = wv.vecs @ wv.vecs[i]
        order = np.argsort(-sims)
        taken = 0
        for j in order:
            if taken >= m:
                break
            if j == i:
                continue  # a word's own vector is always its top hit
            if sims[j] < sim_min:
                break
            cand_stems = keywords_preprocess(wv.words[j])
            fresh = [s for s in cand_stems if s not in q_stem_set]
            if not fresh:
                continue  # stopword or morphological variant
            for s in fresh:
                weights[s] += alpha * float(sims[j])
            taken += 1
    return dict(weights)
