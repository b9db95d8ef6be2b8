"""BERT WordPiece tokenizer, pure Python (counterpart of the Python path
of ``dial_rag_tpu/models/tokenizer.py``, which it copies).

BERT "basic" pretokenization (cleanup, lowercase + accent stripping,
punctuation and CJK splitting) followed by greedy longest-match WordPiece,
producing ``[CLS] ... [SEP]`` rows padded to bucketed lengths. The ids are
those of the reference; its native C++ core is not ported yet.
"""

import unicodedata
from dataclasses import dataclass, field

import numpy as np

# Sequence-length buckets: every batch is padded up to one of these (the
# reference's widths, so both encode the same shapes). 96/160/192/224 sit
# between the powers of two because by-title chunks cluster at ~180-240
# wordpiece tokens.
DEFAULT_BUCKETS = (64, 96, 128, 160, 192, 224, 256, 512)

_SPECIAL = {"pad": "[PAD]", "unk": "[UNK]", "cls": "[CLS]", "sep": "[SEP]"}
_MAX_WORD_CHARS = 100


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicode says otherwise
    if (
        (33 <= cp <= 47)
        or (58 <= cp <= 64)
        or (91 <= cp <= 96)
        or (123 <= cp <= 126)
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """BERT basic tokenizer: cleanup, CJK spacing, lowercase+strip accents,
    punctuation splitting, whitespace split."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif _is_whitespace(ch):
            out.append(" ")
        else:
            out.append(ch)
    tokens = []
    for word in "".join(out).split():
        if lowercase:
            word = word.lower()
            word = "".join(
                c
                for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
        # split on punctuation
        current = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


@dataclass
class WordPieceTokenizer:
    vocab: dict[str, int]
    lowercase: bool = True
    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    _ids: dict[str, int] = field(init=False, repr=False)
    # word -> its WordPiece ids; a pure function of the word and the vocab
    _word_ids: dict[str, list[int]] = field(init=False, repr=False)

    def __post_init__(self):
        self._ids = {k: self.vocab[v] for k, v in _SPECIAL.items()}
        self._word_ids = {}

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab=vocab, **kw)

    @property
    def pad_id(self) -> int:
        return self._ids["pad"]

    def wordpiece(self, word: str) -> list[str]:
        """Greedy longest-match-first subword split."""
        if len(word) > _MAX_WORD_CHARS:
            return [_SPECIAL["unk"]]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [_SPECIAL["unk"]]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        tokens = []
        for word in basic_tokenize(text, self.lowercase):
            tokens.extend(self.wordpiece(word))
        return tokens

    def _ids_of_word(self, word: str) -> list[int]:
        ids = self._word_ids.get(word)
        if ids is None:
            unk = self._ids["unk"]
            ids = [self.vocab.get(t, unk) for t in self.wordpiece(word)]
            self._word_ids[word] = ids
        return ids

    def encode(self, text: str, max_len: int = 512) -> list[int]:
        ids = []
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self._ids_of_word(word))
        ids = ids[: max_len - 2]
        return [self._ids["cls"]] + ids + [self._ids["sep"]]

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def encode_batch(self, texts: list[str], max_len: int = 512):
        """Returns (input_ids [B, S], attention_mask [B, S]) int32 numpy
        arrays, padded to the smallest bucket >= the longest sequence."""
        max_len = min(max_len, self.buckets[-1])
        encoded = [self.encode(t, max_len) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        s = self._bucket(min(longest, max_len))
        ids = np.full((len(texts), s), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), s), dtype=np.int32)
        for i, e in enumerate(encoded):
            e = e[:s]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask


def build_test_vocab(corpus_words: list[str], size: int = 1024) -> dict[str, int]:
    """Tiny deterministic vocab for tests: specials + single chars + whole
    words + common suffix pieces. Not a trainer — real deployments load the
    model's own vocab.txt."""
    tokens = [
        _SPECIAL["pad"],
        _SPECIAL["unk"],
        _SPECIAL["cls"],
        _SPECIAL["sep"],
        "[MASK]",
    ]
    chars = sorted({c for w in corpus_words for c in w.lower()})
    tokens += chars
    tokens += ["##" + c for c in chars]
    seen = set(tokens)
    for w in corpus_words:
        w = w.lower()
        if w not in seen:
            tokens.append(w)
            seen.add(w)
        if len(tokens) >= size:
            break
    return {t: i for i, t in enumerate(tokens)}
