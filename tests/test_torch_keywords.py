"""The port's keyword pipeline and WordPiece tokenizer against the JAX
package's, on the CPU.

- ``keywords_preprocess`` of both packages, token for token, on the fixed
  and fuzzed texts of tests/test_native_keywords.py; the port's C++ core
  (``native/keywords.cpp``) against its Python path on ASCII text, and
  non-ASCII text rejected by the core and served by the Python path;
- the port's native WordPiece path (``native/wordpiece.cpp``) in
  ``encode_batch`` against the JAX tokenizer on
  tests/test_native_tokenizer.py's cases, and against the port's own
  Python path;
- the build helper: a core that fails to compile raises.
"""

import numpy as np
import pytest

from dial_rag_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from dial_rag_tpu.text.keywords import keywords_preprocess as jax_keywords
from dial_rag_tpu_torch.models import tokenizer as port_tokenizer
from dial_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, build_test_vocab
from dial_rag_tpu_torch.native import build as native_build
from dial_rag_tpu_torch.text import keywords as kw

CASES = [
    "The Alps are the highest mountain range that lies entirely in Europe.",
    "Good muffins cost $3.88\nin New York.  Please buy me\ntwo of them.\nThanks.",
    "They'll save and invest more. hi, my name can't hello,",
    'She said "hello there" and left... Didn\'t she? Yes!',
    "The colonel's-body was generational, communal, and arsenic-laden.",
    "running runner ran runs easily fairly sportingly dying lying news",
    "conditional rational national relational irrational operational",
    "agreed feed proceed exceed succeed misdeed indeed",
    "hopping hoping controlled controlling preferred offering",
    "ties cries flies skis skies dies lies applies",
    "connection connective connectivity activate sensational sensibility",
    "(parentheses) [brackets] {braces} <angles> -- dashes",
    "it's we've they're I'm you'd gonna wanna gotta lemme cannot d'ye",
    "'tis 'twas more'n the best of times;",
    "a:b c,d 1,000 3:30 http://x.y/z e@f.g #tag $5 100%",
    "generate generates generating general generally generous gener",
    "communism community communal commune",
    "arsenal arsenic arson",
    "luxuriously ugly early only singly sky atlas cosmos bias andes",
    "inning innings outing outings canning herring earring proceed",
    "ABC DEF lowercase MiXeD CaSe WORDS",
    "trailing period.",
    "multiple.  sentences! with? terminators. end",
    "",
    "   ",
    "x",
    "ab",
    "alpha.\x1cbeta gamma\x1ddelta\x1eepsilon\x1fzeta",
    "The Alps are beautiful mountains.",
    "Hello, world!",
]
NON_ASCII = [
    "Daß die Wörter über Berée gehen.",
    "café in the alps",
    "naïve climbers über the glaciers",
]


def _fuzz_texts():
    rng = np.random.default_rng(0)
    words = (
        "the quick brown fox can't jumps-over lazy dogs' it's ``quoted'' "
        "(aside) [note] {x} 3.88 1,000 50% @h #t $9 a.m. e.g. i.e. U.S. "
        "running; said: done? yes! no... more'n gonna cannot 'tis don't "
        "beautiful nationalization considerably optimization probabilities"
    ).split()
    texts = []
    for _ in range(200):
        text = " ".join(rng.choice(words, size=int(rng.integers(1, 30))))
        if rng.random() < 0.3:
            text += "."
        if rng.random() < 0.2:
            text = '"' + text + '"'
        texts.append(text)
    rng = np.random.default_rng(1)
    alphabet = list(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,!?;:'\"()[]{}<>-_@#$%&*~`\n\t"
    )
    texts += ["".join(rng.choice(alphabet, size=int(rng.integers(0, 80)))) for _ in range(300)]
    return texts


@pytest.mark.parametrize("text", CASES)
def test_keywords_match_jax_on_fixed_texts(text):
    before = dict(kw.PATHS)
    assert kw.native_preprocess(text) == kw.python_preprocess(text)
    assert kw.keywords_preprocess(text) == jax_keywords(text)
    assert kw.PATHS["native"] == before["native"] + 1


@pytest.mark.parametrize("text", NON_ASCII)
def test_non_ascii_takes_the_python_path(text):
    before = dict(kw.PATHS)
    assert kw.native_preprocess(text) is None
    assert kw.keywords_preprocess(text) == jax_keywords(text) == kw.python_preprocess(text)
    assert kw.PATHS["python"] == before["python"] + 1


@pytest.mark.parametrize("part", range(5))
def test_keywords_match_jax_on_fuzzed_texts(part):
    texts = _fuzz_texts()[part::5]
    for text in texts:
        assert kw.native_preprocess(text) == kw.python_preprocess(text), repr(text)
        assert kw.keywords_preprocess(text) == jax_keywords(text), repr(text)


def test_keyword_basics_and_stopword_quirk():
    """tests/test_bm25.py's keyword cases: "The" passes the stopword
    filter (checked on the raw token) and is lowercased."""
    toks = kw.keywords_preprocess("The Alps are beautiful mountains.")
    assert "the" in toks and "are" not in toks and "mountain" in toks
    assert kw.keywords_preprocess("glaciers")[0] == "glacier"
    assert kw.keywords_preprocess("stretching")[0] == "stretch"
    toks = kw.keywords_preprocess("Hello, world!")
    assert "," in toks and "!" in toks
    assert kw.keywords_preprocess("") == []
    assert kw.nltk_available()


WORDS = (
    "the alps are highest mountain range entirely europe climate glaciers "
    "snow peaks colle di cadibona pass stretching approximately across"
).split()
SAMPLES = [
    "The Alps are the HIGHEST mountain range, entirely in Europe!",
    "colle di cadibona... pass?? (stretching) [approximately]",
    "mountains mountaineering snow-peaks",
    "",
    "    \t\n  ",
    "a" * 150,  # oversized word -> [UNK]
    "climate;glaciers:snow",
    "don't stop",
]
MIXED = ["the alps", "café in the alps", "naïve climbers über the glaciers", "snow peaks!", ""]


@pytest.fixture(scope="module")
def vocab():
    return build_test_vocab(WORDS + ["moun", "##tain", "##s", "##ing", "##e"])


def _python_only(vocab):
    """The port's tokenizer with the C++ core turned off."""
    tok = WordPieceTokenizer(vocab=vocab)
    tok._native_tried = True
    return tok


def _batches():
    rng = np.random.default_rng(7)
    pool = WORDS + ["xyzzy", "MOUNTAINS", "123", "42.5", "!!", "(a)", "b-c", "café"]
    out = [(SAMPLES, 512), (MIXED, 512)]
    out += [([" ".join(["alps"] * n) for n in (1, 30, 70, 200, 600)], m) for m in (64, 128, 512)]
    out += [(["ab cd", "ef gh ij", " ".join(["alps"] * 100)], m) for m in (8, 16, 32, 63)]
    for _ in range(20):
        texts = [" ".join(rng.choice(pool, size=rng.integers(0, 60))) for _ in range(rng.integers(1, 9))]
        out.append((texts, 512))
    return out


@pytest.mark.parametrize("case", range(len(_batches())))
def test_wordpiece_batch_matches_jax(vocab, case):
    texts, max_len = _batches()[case]
    tok = WordPieceTokenizer(vocab=vocab)
    assert tok._get_native() is not None
    before = dict(port_tokenizer.PATHS)
    ids, mask = tok.encode_batch(texts, max_len=max_len)
    rejected = sum(not t.isascii() for t in texts)
    assert port_tokenizer.PATHS["native"] == before["native"] + len(texts) - rejected
    assert port_tokenizer.PATHS["python"] == before["python"] + rejected
    jax_ids, jax_mask = JaxTokenizer(vocab=vocab).encode_batch(texts, max_len=max_len)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(mask, jax_mask)
    py_ids, py_mask = _python_only(vocab).encode_batch(texts, max_len=max_len)
    np.testing.assert_array_equal(ids, py_ids)
    np.testing.assert_array_equal(mask, py_mask)


@pytest.mark.parametrize("text", SAMPLES + MIXED)
def test_wordpiece_single_text_matches_jax(vocab, text):
    tok = WordPieceTokenizer(vocab=vocab)
    assert tok.encode(text) == JaxTokenizer(vocab=vocab).encode(text)
    ids, _ = tok.encode_batch([text])
    assert ids[0, : len(tok.encode(text))].tolist() == tok.encode(text)


@pytest.mark.parametrize(
    "vocab_of,lowercase",
    [
        (lambda v: v, False),  # the core lowercases
        (lambda v: {t: 2 * i for t, i in v.items()}, True),  # ids not 0..N-1
    ],
)
def test_wordpiece_core_guards(vocab, vocab_of, lowercase):
    """Where the core does not apply, the Python path serves every text."""
    v = vocab_of(vocab)
    tok = WordPieceTokenizer(vocab=v, lowercase=lowercase)
    assert tok._get_native() is None
    before = port_tokenizer.PATHS["python"]
    ids, mask = tok.encode_batch(SAMPLES)
    assert port_tokenizer.PATHS["python"] == before + len(SAMPLES)
    jax_ids, jax_mask = JaxTokenizer(vocab=v, lowercase=lowercase).encode_batch(SAMPLES)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(mask, jax_mask)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A core that does not compile raises, and leaves no library."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "_SRC_DIR", tmp_path)
    monkeypatch.setattr(native_build, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(native_build.SIGNATURES, "broken", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ build of native/broken.cpp failed"):
        native_build.load_native("broken")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_build_is_cached_by_source_hash():
    lib = native_build.load_native("keywords")
    assert native_build.load_native("keywords") is lib
    assert list(native_build._BUILD_DIR.glob("keywords-*.so"))
