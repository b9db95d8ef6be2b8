"""Char-n-gram fuzzy-lexical index: TF-IDF cosine over char n-grams
(counterpart of ``dial_rag_tpu/index/chargram.py``, which it copies).

Word-boundary-marked char n-grams (``<word>``, fastText-style) are shared
across morphological variants (glacier / glaciation), so they match where
stemming does not, with no training. A chunk's score is the linear form
``score[i] = sum_g q[g] W[i, g]``: ``W`` the per-chunk L2-normalised
sublinear TF-IDF gram weights, ``q`` the query's TF-IDF gram vector. That
is a weighted-query BM25 scan, so the index is the port's ``Bm25Index``
built with ``from_term_weight_arrays`` (its dense or band + CSC layouts,
``Q_BLOCK`` query blocks, the later item first on ties).

A record persists the per-chunk surface words (lowercased ``[a-z0-9]+``,
unstemmed); grams and the corpus idf derive at build. Grams of up to 8
bytes pack losslessly into uint64 keys, longer whole words hash (FNV-1a
64 with the top bit set). The triples (chunk, key, count) come from the
C++ core ``native/chargram.cpp``, or from numpy when the core rejects
the input (a byte outside ``[a-z0-9]``); ``PATHS`` counts the texts each
served.
"""

import ctypes
import math
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from dial_rag_tpu_torch.index.bm25 import Bm25Index
from dial_rag_tpu_torch.native.build import load_native

_WORD_RE = re.compile(r"[a-z0-9]+")

# DEV-selected shape (eval/tune_chargram.py stage 1): 2..4-grams won
# over 3..5 / 3..4 / 4..5 on the handmade DEV half
DEFAULT_N_LO = 2
DEFAULT_N_HI = 4


def chargram_words(text: str) -> list[str]:
    """Surface word tokens (lowercased, ``[a-z0-9]+``) — the persisted
    per-chunk form grams derive from."""
    return _WORD_RE.findall(text.lower())


def gram_counts(words: list[str], n_lo: int, n_hi: int) -> dict[str, int]:
    """Word-boundary-marked char n-grams plus the whole marked word
    (so exact word matches keep full weight)."""
    grams: dict[str, int] = {}
    for w in words:
        marked = f"<{w}>"
        grams[marked] = grams.get(marked, 0) + 1
        for n in range(n_lo, n_hi + 1):
            if len(marked) <= n:
                continue
            for i in range(len(marked) - n + 1):
                g = marked[i : i + n]
                grams[g] = grams.get(g, 0) + 1
    return grams


_SPACER = 0  # NUL can never appear in a marked word ([a-z0-9<>])


def _pack_windows_numpy(
    word_lists: list[list[str]], n_lo: int, n_hi: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized gram extraction for n_hi <= 8.

    Sub-word grams of <= 8 ASCII bytes pack LOSSLESSLY into uint64 (the
    bytes themselves are the key, big-endian left-aligned — no hashing,
    no collisions: marked words never contain NUL, so zero-padded
    packings of different lengths stay distinct). The same key space the
    native core (native/chargram.cpp) emits.

    Returns raw (chunk_ids [m] i32, gram_keys [m] u64) window pairs
    (one entry per occurrence; aggregate with :func:`_aggregate_pairs`).
    """
    # one byte stream per chunk: "<w1>\0\0\0<w2>..." — n_hi - 1 spacers
    # guarantee any window spanning two words contains a NUL
    pad = b"\x00" * max(n_hi - 1, 1)
    streams = [
        pad.join(f"<{w}>".encode("ascii") for w in ws) if ws else b""
        for ws in word_lists
    ]
    lens = np.array([len(s) for s in streams], dtype=np.int64)
    if int(lens.sum()) == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint64)
    flat = np.frombuffer(b"".join(streams), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)])
    chunk_of = np.repeat(
        np.arange(len(streams), dtype=np.int32), lens
    )

    all_keys = []
    all_chunks = []
    for n in range(n_lo, n_hi + 1):
        if flat.size < n:
            continue
        # sliding windows [L-n+1, n] without copying
        win = np.lib.stride_tricks.sliding_window_view(flat, n)
        # valid: window inside one chunk, no NUL spacer inside, and not
        # the whole marked word (dict path: len(marked) > n required)
        wchunk = chunk_of[: win.shape[0]]
        inside = (
            np.arange(win.shape[0], dtype=np.int64) + n
            <= starts[wchunk + 1]
        )
        no_nul = ~(win == _SPACER).any(axis=1)
        # whole-word windows start with '<' and end with '>' — exactly
        # the case the dict path skips (len(marked) == n has no window)
        whole = (win[:, 0] == ord("<")) & (win[:, -1] == ord(">"))
        ok = inside & no_nul & ~whole
        if not ok.any():
            continue
        keys = np.zeros(win.shape[0], dtype=np.uint64)
        for j in range(n):  # pack big-endian: byte j in the high bytes
            keys |= win[:, j].astype(np.uint64) << np.uint64(8 * (7 - j))
        all_keys.append(keys[ok])
        all_chunks.append(wchunk[ok])

    if all_keys:
        return np.concatenate(all_chunks), np.concatenate(all_keys)
    return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint64)


def _aggregate_pairs(chunk_ids: np.ndarray, keys: np.ndarray):
    """(chunk, key) pairs -> unique pairs + counts, sorted by (key,
    chunk) — the term-major order the CSC layout wants."""
    if chunk_ids.size == 0:
        return (
            chunk_ids.astype(np.int32),
            keys,
            np.zeros(0, dtype=np.int64),
        )
    order = np.lexsort((chunk_ids, keys))
    k = keys[order]
    c = chunk_ids[order]
    new = np.empty(k.size, dtype=bool)
    new[0] = True
    new[1:] = (k[1:] != k[:-1]) | (c[1:] != c[:-1])
    idx = np.nonzero(new)[0]
    counts = np.diff(np.concatenate([idx, [k.size]]))
    return c[idx], k[idx], counts


_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_U64_MASK = (1 << 64) - 1
_TOP_BIT = 1 << 63


def _pack_key_str(gram: str) -> int:
    """<=8-byte ASCII gram -> packed uint64 (big-endian left-aligned)."""
    key = 0
    for j, byte in enumerate(gram.encode("ascii")):
        key |= byte << (8 * (7 - j))
    return key


def _long_word_key(marked: bytes) -> int:
    """Whole marked word > 8 bytes -> FNV-1a 64 with the top bit forced
    set (packed ASCII keys always have it clear, so the spaces are
    disjoint; two long words colliding is ~V^2/2^63 and harmless — they
    would merely share a term id)."""
    h = _FNV_OFFSET
    for b in marked:
        h = ((h ^ b) * _FNV_PRIME) & _U64_MASK
    return h | _TOP_BIT


# texts served by the C++ core and by the numpy path
PATHS = {"native": 0, "numpy": 0}


def reset_paths() -> None:
    for name in PATHS:
        PATHS[name] = 0


def _triples_native(word_lists, n_lo: int, n_hi: int):
    """(chunk_ids, keys, counts) via the C++ core; None when the core
    rejects the input (the numpy path then serves it)."""
    lib = load_native("chargram")
    try:
        flat_words = [w for ws in word_lists for w in ws]
        blob = "".join(flat_words).encode("ascii")
    except UnicodeEncodeError:
        return None
    word_lens = np.array([len(w) for w in flat_words], dtype=np.int32)
    chunk_counts = np.array([len(ws) for ws in word_lists], dtype=np.int32)
    # exact upper bound on distinct (chunk, gram) pairs: every window +
    # the whole word, per occurrence
    spans = word_lens.astype(np.int64) + 2
    cap = int(((n_hi - n_lo + 1) * spans + 1).sum()) + 16
    out_chunk = np.empty(cap, dtype=np.int32)
    out_key = np.empty(cap, dtype=np.uint64)
    out_cnt = np.empty(cap, dtype=np.int32)
    n = lib.chargram_triples(
        ctypes.c_char_p(blob),
        word_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(len(flat_words)),
        chunk_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(len(word_lists)),
        ctypes.c_int(n_lo),
        ctypes.c_int(n_hi),
        out_chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_key.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(cap),
        ctypes.c_int(min(8, os.cpu_count() or 1)),
    )
    if n < 0:
        return None
    return out_chunk[:n], out_key[:n], out_cnt[:n].astype(np.int64)


def _triples_numpy(word_lists, n_lo: int, n_hi: int):
    """(chunk_ids, keys, counts) — numpy fallback, byte-identical key
    space to the native core (parity fuzz-tested)."""
    gc, gk = _pack_windows_numpy(word_lists, n_lo, n_hi)
    g_items, g_keys, g_cnt = _aggregate_pairs(gc, gk)

    n_words = [len(ws) for ws in word_lists]
    w_chunk = np.repeat(
        np.arange(len(word_lists), dtype=np.int32), n_words
    )
    flat_words = [w for ws in word_lists for w in ws]
    if flat_words:
        uniq_words, w_inv = np.unique(
            np.array(flat_words, dtype=np.str_), return_inverse=True
        )
        word_keys = np.array(
            [
                _pack_key_str(f"<{w}>")
                if len(w) <= 6
                else _long_word_key(f"<{w}>".encode("ascii"))
                for w in uniq_words
            ],
            dtype=np.uint64,
        )
        w_items, w_wid, w_cnt = _aggregate_pairs(
            w_chunk, w_inv.astype(np.uint64)
        )
        w_keys = word_keys[w_wid.astype(np.int64)]
    else:
        w_items = np.zeros(0, dtype=np.int32)
        w_keys = np.zeros(0, dtype=np.uint64)
        w_cnt = np.zeros(0, dtype=np.int64)

    return (
        np.concatenate([g_items, w_items]),
        np.concatenate([g_keys, w_keys]),
        np.concatenate([g_cnt, w_cnt]),
    )


@dataclass
class ChargramIndex:
    """TF-IDF cosine over char n-grams, served by the BM25 machinery.

    ``inner`` is the assembled ``Bm25Index``; this class owns gram
    extraction and query weighting."""

    inner: Bm25Index
    n_lo: int
    n_hi: int
    # query weighting looks keys up in the SAME vocab dict + idf array
    # the assembled Bm25Index holds (references, not copies — a corpus-
    # scale vocab is millions of grams). Key space matches the build
    # path: packed uint64 (vectorized/native, n_hi <= 8) or plain gram
    # strings (dict fallback).
    _vocab: dict = field(default_factory=dict, repr=False)
    _idf_arr: object = field(default=None, repr=False)
    _packed_keys: bool = False

    @property
    def n_items(self) -> int:
        return self.inner.n_items

    @property
    def nbytes(self) -> int:
        return self.inner.nbytes

    @staticmethod
    def weight_rows(
        word_lists: list[list[str]], n_lo: int, n_hi: int
    ) -> tuple[dict[str, int], np.ndarray, list[dict[int, float]]]:
        """(vocab, idf array, per-item L2-normalized TF-IDF weight rows)
        — the explicit-weight form Bm25Index.from_term_weights takes."""
        counts = [gram_counts(ws, n_lo, n_hi) for ws in word_lists]
        vocab: dict[str, int] = {}
        df: list[int] = []
        for c in counts:
            for g in c:
                if g not in vocab:
                    vocab[g] = len(vocab)
                    df.append(0)
                df[vocab[g]] += 1
        n_docs = len(word_lists)
        idf = np.array(
            [math.log((n_docs + 1) / (d + 1)) + 1.0 for d in df],
            dtype=np.float64,
        )
        rows: list[dict[int, float]] = []
        for c in counts:
            row = {
                vocab[g]: (1.0 + math.log(tf)) * idf[vocab[g]]
                for g, tf in c.items()
            }
            norm = math.sqrt(sum(v * v for v in row.values()))
            if norm > 0:
                row = {k: v / norm for k, v in row.items()}
            rows.append(row)
        return vocab, idf, rows

    @staticmethod
    def weight_arrays(
        word_lists: list[list[str]], n_lo: int, n_hi: int
    ):
        """Vectorized (vocab, idf, item_ids, term_ids, weights) for
        ``Bm25Index.from_term_weight_arrays`` — numerically the same
        TF-IDF formulation as :meth:`weight_rows`, computed from
        (chunk, packed-key, count) triples instead of per-gram Python
        dicts (measured 2 orders of magnitude on realistic chunks).
        Extraction runs on the C++ core, or on the numpy window packing
        where the core rejects the input. Requires n_hi <= 8 (8 ASCII
        bytes pack a uint64)."""
        triples = _triples_native(word_lists, n_lo, n_hi)
        PATHS["native" if triples is not None else "numpy"] += len(word_lists)
        if triples is None:
            triples = _triples_numpy(word_lists, n_lo, n_hi)
        item_ids, keys, counts = triples

        uniq_keys, term_ids = np.unique(keys, return_inverse=True)
        item_ids = item_ids.astype(np.int64)
        term_ids = term_ids.astype(np.int64)
        v = uniq_keys.size
        n_docs = len(word_lists)
        df = np.bincount(term_ids, minlength=v)
        idf = np.log((n_docs + 1) / (df + 1.0)) + 1.0
        weights = (1.0 + np.log(counts.astype(np.float64))) * idf[term_ids]
        norm2 = np.bincount(
            item_ids, weights=weights * weights, minlength=n_docs
        )
        norm = np.sqrt(norm2)[item_ids]
        weights = np.where(norm > 0, weights / np.where(norm > 0, norm, 1.0), weights)

        vocab: dict = {int(k): i for i, k in enumerate(uniq_keys)}
        return vocab, idf, item_ids, term_ids, weights.astype(np.float32)

    @staticmethod
    def _sanitize(word_lists: list[list[str]]) -> list[list[str]]:
        """Persisted chargram_index fields are UNTRUSTED (crafted
        records must not crash the ascii fast paths): keep only words
        the tokenizer contract can produce ([a-z0-9]+, bounded length);
        anything else is dropped deterministically — same behavior in
        the native core, the numpy path, and the dict fallback."""
        return [
            [w for w in ws if len(w) <= 1024 and _WORD_RE.fullmatch(w)]
            for ws in word_lists
        ]

    @classmethod
    def build(
        cls,
        word_lists: list[list[str]],
        n_lo: int = DEFAULT_N_LO,
        n_hi: int = DEFAULT_N_HI,
        device: str | torch.device = "cuda",
        max_dense_bytes: int = 256 * 1024 * 1024,
        max_band_bytes: int = 512 * 1024 * 1024,
    ) -> "ChargramIndex":
        word_lists = cls._sanitize(word_lists)
        if n_hi <= 8:
            vocab, idf, item_ids, term_ids, weights = cls.weight_arrays(
                word_lists, n_lo, n_hi
            )
            inner = Bm25Index.from_term_weight_arrays(
                vocab,
                idf,
                item_ids,
                term_ids,
                weights,
                n_items=len(word_lists),
                max_dense_bytes=max_dense_bytes,
                device=device,
                max_band_bytes=max_band_bytes,
            )
            return cls(
                inner=inner,
                n_lo=n_lo,
                n_hi=n_hi,
                _vocab=vocab,
                _idf_arr=idf,
                _packed_keys=True,
            )
        vocab, idf, rows = cls.weight_rows(word_lists, n_lo, n_hi)
        inner = Bm25Index.from_term_weights(
            vocab,
            idf,
            rows,
            max_dense_bytes=max_dense_bytes,
            device=device,
            max_band_bytes=max_band_bytes,
        )
        return cls(
            inner=inner, n_lo=n_lo, n_hi=n_hi, _vocab=vocab, _idf_arr=idf
        )

    def _key_of(self, gram: str):
        """Gram string -> the build path's vocab key: packed uint64 for
        <=8 ASCII bytes (windows are always <= n_hi <= 8 here; short
        whole words pack the same way and can never byte-equal a window
        of another word), FNV|topbit for longer whole words."""
        if not self._packed_keys:
            return gram
        if len(gram) <= 8:
            return _pack_key_str(gram)
        return _long_word_key(gram.encode("ascii"))

    def query_weights(self, query_text: str) -> dict:
        """L2-normalized TF-IDF gram vector of the query: the inner
        linear scan then yields exact cosine similarity scores."""
        c = gram_counts(chargram_words(query_text), self.n_lo, self.n_hi)
        w = {}
        for g, tf in c.items():
            key = self._key_of(g)
            tid = self._vocab.get(key)
            if tid is not None:
                w[key] = (1.0 + math.log(tf)) * float(self._idf_arr[tid])
        norm = math.sqrt(sum(v * v for v in w.values()))
        if norm > 0:
            w = {k: v / norm for k, v in w.items()}
        return w

    # --- query API (text in, cosine scores out) -------------------------
    def get_scores(self, query_text: str) -> np.ndarray:
        return self.inner.get_scores(self.query_weights(query_text))

    def top_n(self, query_text: str, n: int) -> np.ndarray:
        return self.inner.top_n(self.query_weights(query_text), n)

    def top_n_with_scores(self, query_text: str, n: int):
        return self.inner.top_n_with_scores(self.query_weights(query_text), n)

    def warm_query_buckets(self, k: int) -> None:
        """Weighted queries ride the inner BM25 index's scans, so warming it
        covers every wave bucket of this arm."""
        self.inner.warm_query_buckets(k)

    async def atop_n_with_scores(self, query_text: str, n: int):
        """``top_n_with_scores`` coalesced with concurrent callers' queries
        through the inner index's ``atop_n_with_scores``."""
        return await self.inner.atop_n_with_scores(self.query_weights(query_text), n)

    def top_n_batch_with_scores(self, query_texts: list[str], n: int):
        return self.inner.top_n_batch_with_scores(
            [self.query_weights(q) for q in query_texts], n
        )
