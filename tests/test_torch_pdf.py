"""The port's PDF stack against the JAX package's, on the same bytes: the
writer (byte for byte, in its plain, Flate and xref-stream variants), the
lexer and filters, ``PdfDocument``, fonts, the layout rules, glyph
extraction and ``extract_pages_text``.

Every case of tests/test_pdf_parser.py and tests/test_pdf_layout.py runs
through both packages (``tests/utils/port_parity.same``), and a seeded
property test writes random pages (ASCII and Latin-1 words, sizes and
positions) and parses them in both.
"""

import os
import zlib

import numpy as np
import pytest

from dial_rag_tpu.documents.pdf.writer import build_pdf as jax_build_pdf
from dial_rag_tpu_torch.documents.pdf.writer import build_pdf
from tests.utils.port_parity import same

ALPS_PDF = "/root/reference/tests/data/alps_wiki.pdf"
VARIANTS = [{}, {"compress": True}, {"compress": True, "use_xref_stream": True}]
VARIANT_IDS = ["plain", "flate", "xref_stream"]

FIXTURES = {
    "single": [[(72, 720, 12, "Hello World")]],
    "two_pages": [[(72, 720, 18, "Title Page"), (72, 700, 11, "Some body text.")],
                  [(72, 720, 11, "Second page content here")]],
    "stream_xref": [[(72, 720, 12, "Stream xref works")]],
    "font_sizes": [[(72, 720, 18, "Heading"), (72, 695, 11, "First paragraph line one."),
                    (72, 681, 11, "First paragraph line two.")]],
    "chapters": [[(72, 720, 18, "Chapter One"), (72, 695, 11, "First chapter body.")],
                 [(72, 720, 11, "Second page body.")]],
    "empty_page": [[(72, 720, 11, "text page")], []],
    "escapes": [[(72, 720, 12, r"paren (a) and back\slash"), (300, 500, 9, "café naïve Zürich")]],
}


# --- writer ------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_writer_bytes_equal_jax(name, variant):
    data = build_pdf(FIXTURES[name], **variant)
    assert data == jax_build_pdf(FIXTURES[name], **variant)
    assert data.startswith(b"%PDF-1.5") and (b"/ObjStm" in data) == bool(variant.get("use_xref_stream"))


# --- lexer and filters -------------------------------------------------------


@pytest.mark.parametrize(
    "data",
    [b"42", b"-3", b"3.14", b"+.5", b"4.", b"12 0 R", b"12 0", rb"(hello)", rb"(a\(b\)c)", rb"(nest(ed))",
     rb"(oct\101al)", rb"(nl\n)", b"<48656C6C6F>", b"<48656C6C6F2>", b"/Type", b"/A#20B", b"[1 2 /X (s)]",
     b"<< /A 1 /B [2 3] /C << /D true >> >>", b"% comment\n null", b"1.2.3 ", b"<< /Length 3 >>\nstream\nabc\nendstream",
     b"", b"]", b"<< /A", b"(unterminated"],
)
def test_lexer_parse_object(data):
    same(lambda P: P.m("documents.pdf.objects").Lexer(data).parse_object())


def test_lexer_expectations_on_the_port():
    from dial_rag_tpu_torch.documents.pdf.objects import Lexer, Name, PdfError, Ref

    def parse(data):
        return Lexer(data).parse_object()

    assert (parse(b"42"), parse(b"-3"), parse(b"3.14"), parse(b"+.5"), parse(b"4.")) == (42, -3, 3.14, 0.5, 4.0)
    assert parse(b"12 0 R") == Ref(12, 0) and parse(b"12 0") == 12
    assert parse(rb"(oct\101al)") == b"octAal" and parse(b"<48656C6C6F2>") == b"Hello "
    assert parse(b"/A#20B") == Name("A B") and parse(b"[1 2 /X (s)]") == [1, 2, Name("X"), b"s"]
    assert parse(b"<< /A 1 /B [2 3] /C << /D true >> >>") == {"A": 1, "B": [2, 3], "C": {"D": True}}
    assert parse(b"% comment\n null") is None
    with pytest.raises(PdfError):
        parse(b"1.2.3 ")


def _lzw_encode(data: bytes) -> bytes:
    table = {bytes([i]): i for i in range(256)}
    next_code, code_len = 258, 9
    out, buf, bits = bytearray(), 0, 0

    def emit(code):
        nonlocal buf, bits
        buf = (buf << code_len) | code
        bits += code_len
        while bits >= 8:
            bits -= 8
            out.append((buf >> bits) & 0xFF)

    emit(256)
    w = b""
    for b in data:
        c = bytes([b])
        if w + c in table:
            w = w + c
            continue
        emit(table[w])
        table[w + c] = next_code
        next_code += 1
        if next_code >= (1 << code_len) and code_len < 12:
            code_len += 1
        w = c
    if w:
        emit(table[w])
    emit(257)
    if bits:
        out.append((buf << (8 - bits)) & 0xFF)
    return bytes(out)


@pytest.mark.parametrize(
    "fn,args,expected",
    [
        ("asciihex_decode", (b"48 65 6C 6C 6F>",), b"Hello"),
        ("ascii85_decode", (b"87cUR~>",), b"Hell"),
        ("ascii85_decode", (b"z~>",), b"\0\0\0\0"),
        ("runlength_decode", (bytes([1]) + b"ab" + bytes([254]) + b"c" + bytes([128]),), b"abccc"),
        ("lzw_decode", (_lzw_encode(b"TOBEORNOTTOBEORTOBEORNOT" * 3),), b"TOBEORNOTTOBEORTOBEORNOT" * 3),
        ("lzw_decode", (_lzw_encode(bytes(np.random.default_rng(0).integers(0, 16, 5000, dtype=np.uint8))), 1),
         bytes(np.random.default_rng(0).integers(0, 16, 5000, dtype=np.uint8))),
        ("apply_predictor", (bytes([0, 1, 2, 3]) + bytes([2, 1, 1, 1]), {"Predictor": 12, "Columns": 3}),
         bytes([1, 2, 3, 2, 3, 4])),
        ("apply_predictor", (bytes([1, 5, 1, 1, 3, 9, 2, 2, 4, 0, 3, 3]), {"Predictor": 15, "Columns": 3}), None),
        ("ascii85_decode", (b"!!!~~>",), None),
        ("asciihex_decode", (b"4G>",), None),
    ],
)
def test_filters(fn, args, expected):
    got = same(lambda P: getattr(P.m("documents.pdf.filters"), fn)(*args))
    if expected is not None:
        assert got == ("ok", expected)


@pytest.mark.parametrize(
    "filt,raw",
    [
        ("FlateDecode", b"\xff\xfe\xfd\xfc"),
        ("FlateDecode", zlib.compress(b"BT /F1 12 Tf (x) Tj ET")),
        ("ASCIIHexDecode", b"414243>"),
        ("Bogus", b"abc"),
    ],
)
def test_decode_stream(filt, raw):
    def call(P):
        objects = P.m("documents.pdf.objects")
        stream = objects.Stream(dict={"Filter": objects.Name(filt), "Length": len(raw)}, raw=raw)
        return P.m("documents.pdf.filters").decode_stream(stream, resolve=lambda x: x)

    got = same(call)
    if raw == b"\xff\xfe\xfd\xfc":
        assert got[:2] == ("raise", "PdfError") and got[3] == "PKG.documents.pdf.objects"


# --- documents, fonts, glyphs and pages --------------------------------------


def document_view(P, data):
    doc = P.m("documents.pdf").PdfDocument(data)
    pages = doc.pages()
    return {"num_pages": doc.num_pages, "catalog": doc.catalog, "pages": pages,
            "content": [doc.page_content(p) for p in pages]}


def fonts_view(P, data):
    """Each page's fonts: decoded text, widths and code splitting over
    every single-byte code."""
    from_text = P.m("documents.pdf.text")
    doc = P.m("documents.pdf").PdfDocument(data)
    out = []
    for page in doc.pages():
        ex = from_text.TextExtractor(doc, page)
        resources = doc.resolve(page.get("Resources")) or {}
        for name in sorted(doc.resolve(resources.get("Font")) or {}):
            font = ex._get_font(name, resources)
            out.append((name, font.subtype, font.descent, list(font.iter_codes(bytes(range(256)))),
                        [font.code_to_unicode(c) for c in range(256)], [font.code_width(c) for c in range(256)]))
    return out


def glyphs_view(P, data):
    text = P.m("documents.pdf.text")
    doc = P.m("documents.pdf").PdfDocument(data)
    return [text.TextExtractor(doc, page).extract() for page in doc.pages()]


def pages_view(P, data):
    pages = P.m("documents.pdf").extract_pages_text(data)
    return pages, [p.text for p in pages]


VIEWS = {"document": document_view, "fonts": fonts_view, "glyphs": glyphs_view, "pages": pages_view}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_parses_like_jax(name, variant, view):
    data = jax_build_pdf(FIXTURES[name], **variant)
    got = same(lambda P: VIEWS[view](P, data))
    assert got[0] == "ok"


def test_page_expectations_on_the_port():
    from dial_rag_tpu_torch.documents.pdf import PdfDocument, PdfError, extract_pages_text

    assert PdfDocument(build_pdf(FIXTURES["single"])).num_pages == 1
    assert extract_pages_text(build_pdf(FIXTURES["single"]))[0].text == "Hello World"
    pages = extract_pages_text(build_pdf(FIXTURES["two_pages"], compress=True))
    assert "Some body text." in pages[0].text and pages[1].text == "Second page content here"
    assert extract_pages_text(build_pdf(FIXTURES["stream_xref"], compress=True,
                                        use_xref_stream=True))[0].text == "Stream xref works"
    blocks = extract_pages_text(build_pdf(FIXTURES["font_sizes"]))[0].blocks
    assert [b.text for b in blocks] == ["Heading", "First paragraph line one. First paragraph line two."]
    assert blocks[0].font_size > blocks[1].font_size
    with pytest.raises(PdfError):
        PdfDocument(b"plain text")


@pytest.mark.parametrize(
    "data",
    [
        jax_build_pdf([[(72, 720, 12, "Recovered")]]).replace(b"startxref", b"startxref\n999999\n%%garbled", 1),
        jax_build_pdf([[(72, 720, 12, "real text")]]).replace(b"BT /F1", b"/F1 1 0 0 1 0 cm BT /F1", 1),
        b"plain text",
        b"%PDF-1.4\n",
    ],
    ids=["damaged_xref", "malformed_operand", "not_a_pdf", "header_only"],
)
def test_damaged_pdf_like_jax(data):
    got = same(lambda P: pages_view(P, data))
    if data.startswith(b"plain"):
        assert got[:2] == ("raise", "PdfError")


@pytest.mark.skipif(not os.path.exists(ALPS_PDF), reason="reference data absent")
def test_real_world_pdf_like_jax():
    with open(ALPS_PDF, "rb") as f:
        data = f.read()
    got = same(lambda P: pages_view(P, data))
    assert sum(len(t) for t in got[1][1][1][1]) > 20000


@pytest.mark.parametrize("use_xref_stream", [False, True])
def test_fuzzed_pdf_parses_alike(use_xref_stream):
    """tests/test_pdf_parser.py's byte mutations: each mutated PDF parses
    to the same chunks or raises the same InvalidDocumentError in both."""
    rng = np.random.default_rng(0)
    base = jax_build_pdf([[(72, 720, 12, "some text to mutate around")]], compress=True,
                         use_xref_stream=use_xref_stream)
    for _ in range(80):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 10))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        got = same(lambda P: P.m("documents.parser").parse_document(bytes(data), "application/pdf",
                                                                      source_link="f.pdf"))
        assert got[0] == "ok" or got[1] == "InvalidDocumentError", got


def test_tounicode_cmap_and_glyph_names():
    cmap = (b"begincmap\n2 beginbfchar\n<01> <0041>\n<02> <D83DDE00>\nendbfchar\n"
            b"1 beginbfrange\n<10> <12> <0061>\nendbfrange\n1 beginbfrange\n<20> <21> [<0078> <0079>]\n"
            b"endbfrange\nendcmap")
    same(lambda P: P.m("documents.pdf.fonts").parse_tounicode_cmap(cmap))
    for name in ("eacute", "uni00E9", "u1F600", "A", "g123", "uniZZZZ", ""):
        same(lambda P: P.m("documents.pdf.fonts").glyph_name_to_unicode(name))


# --- layout ------------------------------------------------------------------


def _line(P, text, x0, y0, x1, y1):
    layout, text_mod = P.m("documents.pdf.layout"), P.m("documents.pdf.text")
    ln = layout.TextLineH()
    w = (x1 - x0) / max(len(text), 1)
    for i, ch in enumerate(text):
        ln.add(text_mod.Glyph(text=ch, x0=x0 + i * w, y0=y0, x1=x0 + (i + 1) * w, y1=y1), word_margin=0.0)
    return ln


LINE_CASES = {
    "left_aligned_paragraph_merges": ([("first line of text", 36, 688, 300, 700),
                                       ("second line of text", 36, 672, 300, 684)], 1),
    "paragraph_gap_splits": ([("paragraph one", 36, 688, 300, 700), ("paragraph two", 36, 660, 300, 672)], 2),
    "hanging_indent_continuation_merges": ([("101. An item that wraps to the margin", 28, 688, 570, 700),
                                            ("continuation line", 55, 672, 200, 684)], 1),
    "outdent_after_continuation_splits": ([("101. An item that wraps to the margin", 28, 688, 570, 700),
                                           ("continuation line", 55, 672, 200, 684),
                                           ("102. Next item", 28, 656, 150, 668)], 2),
    "over_wide_indented_line_is_new_element": ([("61. Short item text", 35, 688, 518, 700),
                                                ("x" * 50, 55, 672, 570, 684)], 2),
    "right_aligned_wrap_merges": ([("text beside an image", 246, 688, 576, 700),
                                   ("full width continuation line goes here", 36, 672, 576, 684)], 1),
    "same_line_pieces_merge_when_near": ([("Austrian-born Adolf", 261, 688, 469, 700),
                                          ("lifelong", 478, 688, 576, 700)], 1),
    "same_line_distant_caption_stays_separate": ([("body column text here", 246, 688, 576, 700),
                                                  ("margin caption", 40, 687, 215, 699)], 2),
    "interleaved_caption_continues_its_own_element": ([("body text line one x", 201, 688, 576, 700),
                                                       ("Edelweiss caption", 40, 682, 155, 692),
                                                       ("body text line two x", 201, 672, 576, 684),
                                                       ("second caption line", 40, 668, 120, 678)], 2),
}


@pytest.mark.parametrize("name", sorted(LINE_CASES))
def test_group_lines_to_elements(name):
    lines, n = LINE_CASES[name]

    def call(P):
        layout = P.m("documents.pdf.layout")
        els = layout.group_lines_to_elements([_line(P, *a) for a in lines], layout.LayoutParams())
        return [(e.text, e.x0, e.y0, e.x1, e.y1, e.max_char_height) for e in els]

    got = same(call)
    assert len(got[1][1]) == n


CHAR_CASES = {
    "wide_gap_splits_line": ([("a", 10, 0, 16, 12), ("b", 40, 0, 46, 12)], ["a", "b"]),
    "small_gap_chains": ([("a", 10, 0, 16, 12), ("b", 20, 0, 26, 12)], ["a b"]),
    "different_baselines_split": ([("a", 10, 0, 16, 12), ("b", 17, -20, 23, -8)], ["a", "b"]),
}


@pytest.mark.parametrize("name", sorted(CHAR_CASES))
def test_group_chars_to_lines(name):
    chars, texts = CHAR_CASES[name]

    def call(P):
        layout, text_mod = P.m("documents.pdf.layout"), P.m("documents.pdf.text")
        glyphs = [text_mod.Glyph(text=t, x0=a, y0=b, x1=c, y1=d) for t, a, b, c, d in chars]
        return [ln.text for ln in layout.group_chars_to_lines(glyphs, layout.LayoutParams())]

    assert same(call) == ("ok", ("list", texts))


# --- seeded property test ----------------------------------------------------

ASCII = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,;:!?-'"
LATIN1 = "àáâãäåæçèéêëìíîïñòóôõöøùúûüýÿÀÉÎÕÜß£§°±µ¿«»"


def random_pages(rng) -> list:
    pages = []
    for _ in range(int(rng.integers(1, 4))):
        lines = []
        for _ in range(int(rng.integers(0, 14))):
            words = []
            for _ in range(int(rng.integers(1, 9))):
                alphabet = LATIN1 if rng.random() < 0.25 else ASCII
                words.append("".join(rng.choice(list(alphabet), size=int(rng.integers(1, 10)))))
            x = float(rng.choice([36, 72, 72, 90, 300])) + float(rng.integers(0, 4))
            y = float(rng.integers(40, 760))
            size = float(rng.choice([8, 9, 10, 11, 11, 12, 14, 18, 24]))
            lines.append((x, y, size, " ".join(words)))
        pages.append(lines)
    return pages


@pytest.mark.parametrize("seed", range(16))
def test_random_pages_parse_alike(seed):
    rng = np.random.default_rng(seed)
    pages = random_pages(rng)
    variant = VARIANTS[seed % 3]
    data = build_pdf(pages, **variant)
    assert data == jax_build_pdf(pages, **variant)
    got = same(lambda P: pages_view(P, data))
    assert got[0] == "ok"
    same(lambda P: P.m("documents.parser").parse_document(data, "application/pdf", source_link="r.pdf"))
