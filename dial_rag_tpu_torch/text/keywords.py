"""Keyword preprocessing for the BM25 index, on the host (counterpart of
``dial_rag_tpu/text/keywords.py``, which it copies).

The pipeline is ``[stem(t.lower()) for t in word_tokenize(text) if t not
in STOPWORDS]``. The stopword check runs on the *unlowered* token against
a lowercase list, so capitalized stopwords ("The") pass the filter and get
stemmed; that quirk is kept.

ASCII text runs through the C++ core ``native/keywords.cpp`` (Treebank
tokenization and the Snowball English stemmer in one pass); the core
rejects any other text, which takes the Python path:

- sentences split on a regex (punkt's model is downloadable data);
- words by NLTK's data-free ``TreebankWordTokenizer`` when ``nltk``
  imports, else a first-party regex with the same core rules;
- the English stopword list is inline (NLTK's canonical list);
- stems by NLTK's ``SnowballStemmer`` when ``nltk`` imports, else the
  first-party suffix stripper ``porter_lite``, whose stems differ.

``PATHS`` counts the texts each path served; ``nltk_available`` says
which Python path runs here.
"""

import ctypes
import re
from functools import lru_cache

from dial_rag_tpu_torch.native.build import load_native

# NLTK English stopword list (canonical, all-lowercase).
STOPWORDS = frozenset(
    """i me my myself we our ours ourselves you you're you've you'll you'd
your yours yourself yourselves he him his himself she she's her hers herself
it it's its itself they them their theirs themselves what which who whom
this that that'll these those am is are was were be been being have has had
having do does did doing a an the and but if or because as until while of
at by for with about against between into through during before after above
below to from up down in out on off over under again further then once here
there when where why how all any both each few more most other some such no
nor not only own same so than too very s t can will just don don't should
should've now d ll m o re ve y ain aren aren't couldn couldn't didn didn't
doesn doesn't hadn hadn't hasn hasn't haven haven't isn isn't ma mightn
mightn't mustn mustn't needn needn't shan shan't shouldn shouldn't wasn
wasn't weren weren't won won't wouldn wouldn't""".split()
)

# texts served by the C++ core and by the Python path
PATHS = {"native": 0, "python": 0}


def reset_paths() -> None:
    for name in PATHS:
        PATHS[name] = 0


_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> list[str]:
    """Regex stand-in for punkt: split after ./!/? followed by whitespace."""
    return [s for s in _SENT_RE.split(text) if s]


@lru_cache(maxsize=1)
def _treebank():
    try:
        from nltk.tokenize import TreebankWordTokenizer

        return TreebankWordTokenizer()
    except Exception:  # the reference's guard: any failure to load nltk
        return None


def nltk_available() -> bool:
    """Whether the Python path tokenizes and stems with ``nltk``."""
    return _treebank() is not None


_FALLBACK_TOKEN_RE = re.compile(
    r"""
      \w+(?:[-'.]\w+)*   # words with internal hyphens/apostrophes/dots
    | \S                  # any other single non-space char (punctuation)
    """,
    re.VERBOSE,
)


def word_tokenize(text: str) -> list[str]:
    """Treebank-style word tokenization over regex-split sentences."""
    tb = _treebank()
    tokens: list[str] = []
    for sent in split_sentences(text):
        if tb is not None:
            tokens.extend(tb.tokenize(sent))
        else:
            tokens.extend(_FALLBACK_TOKEN_RE.findall(sent))
    return tokens


@lru_cache(maxsize=1)
def _stemmer():
    try:
        from nltk.stem.snowball import SnowballStemmer

        return SnowballStemmer("english").stem
    except Exception:  # the reference's guard: any failure to load nltk
        # trivial suffix-stripping fallback; only used if nltk is absent
        def porter_lite(w: str) -> str:
            for suf in ("ingly", "edly", "ing", "ed", "ly", "es", "s"):
                if w.endswith(suf) and len(w) - len(suf) >= 3:
                    return w[: -len(suf)]
            return w

        return porter_lite


@lru_cache(maxsize=1)
def _native() -> ctypes.CDLL:
    """The C++ pipeline, built at first use (raises if the build fails),
    with the stopword list set."""
    lib = load_native("keywords")
    stop = "\n".join(sorted(STOPWORDS)).encode()
    lib.kw_set_stopwords(stop, len(stop))
    return lib


def native_preprocess(text: str) -> list[str] | None:
    """The C++ core's tokens, or None where it rejects the text (any
    non-ASCII byte)."""
    lib = _native()
    data = text.encode("utf-8")
    cap = max(4096, 2 * len(data) + 1024)
    buf = ctypes.create_string_buffer(cap)
    n = lib.kw_preprocess(data, len(data), buf, cap)
    if n == -2:  # undersized buffer (stems never exceed 2x input)
        cap = 4 * len(data) + 65536
        buf = ctypes.create_string_buffer(cap)
        n = lib.kw_preprocess(data, len(data), buf, cap)
    if n < 0:
        return None
    raw = buf.raw[:n].decode("utf-8")
    return raw.split("\n")[:-1] if raw else []


def python_preprocess(text: str) -> list[str]:
    stem = _stemmer()
    return [stem(t.lower()) for t in word_tokenize(text) if t not in STOPWORDS]


def keywords_preprocess(text: str) -> list[str]:
    """Tokenize -> filter stopwords (on the raw token) -> lowercase and
    stem: ASCII text through the C++ core, anything else through the
    Python path."""
    tokens = native_preprocess(text)
    if tokens is not None:
        PATHS["native"] += 1
        return tokens
    PATHS["python"] += 1
    return python_preprocess(text)
