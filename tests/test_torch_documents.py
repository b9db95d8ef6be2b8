"""The port's document pipeline against the JAX package's, on the same
bytes: MIME detection, the Title/Narrative heuristics, by-title chunking,
the text, Markdown, CSV, HTML and office elements, and ``parse_document``.

Every case of tests/test_parser_pipeline.py, tests/test_office_parser.py
(but the service converter's, which comes with the service layer) and
tests/test_texttype.py runs through both packages
(``tests/utils/port_parity.same``): chunks and elements equal in text and
metadata, errors the port's counterpart class with the same message. The
original expectations are asserted on the port's result as well.
"""

import io
import json
import re
import zipfile
from pathlib import Path

import numpy as np
import pytest

from dial_rag_tpu.documents.pdf.writer import build_pdf
from tests.utils.office_builder import build_docx, build_odp, build_odt, build_pptx, build_xlsx
from tests.utils.port_parity import PORT, outcome, same

MIME_DOCX = "application/vnd.openxmlformats-officedocument.wordprocessingml.document"
MIME_PPTX = "application/vnd.openxmlformats-officedocument.presentationml.presentation"
MIME_ODT = "application/vnd.oasis.opendocument.text"
MIME_ODP = "application/vnd.oasis.opendocument.presentation"
MIME_XLSX = "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet"


def chunks_of(result):
    """(text, metadata) pairs of a ``same`` result holding Chunk objects."""
    assert result[0] == "ok", result
    return [(c[1]["text"], c[1]["metadata"]) for c in result[1][1]]


def elements_of(result, *fields):
    assert result[0] == "ok", result
    return [tuple(e[1][f] for f in fields) for e in result[1][1]]


def parse(data, mime, **kw):
    return lambda P: P.m("documents.parser").parse_document(data, mime, **kw)


# --- by-title chunking -------------------------------------------------------


def chunk(elements, **kw):
    def call(P):
        Element = P.m("text.chunker").Element
        return P.m("text.chunker").chunk_by_title([Element(*a, **k) for a, k in elements], **kw)

    return call


def test_title_starts_new_chunk():
    got = same(chunk([(("Intro text.",), {}), (("Heading",), {"is_title": True}), (("Body under heading.",), {})]))
    assert [c[1][0] for c in got[1][1]] == ["Intro text.", "Heading\n\nBody under heading."]


def test_max_characters():
    got = same(chunk([(("a" * 600,), {}), (("b" * 600,), {})], max_characters=1000))
    assert [len(c[1][0]) for c in got[1][1]] == [600, 600]


def test_oversized_element_split_on_words():
    text = " ".join(["word"] * 300)
    got = same(chunk([((text,), {})], max_characters=1000))
    assert len(got[1][1]) == 2 and " ".join(c[1][0] for c in got[1][1]) == text


def test_no_multipage_sections():
    got = same(chunk([(("Page one text",), {"page_number": 1}), (("Page two text",), {"page_number": 2})]))
    assert [c[1][1]["page_number"] for c in got[1][1]] == [1, 2]


def test_empty_elements_skipped():
    assert same(chunk([(("  ",), {}), (("",), {})])) == ("ok", ("list", []))


@pytest.mark.parametrize("seed", range(6))
def test_chunk_by_title_on_random_elements(seed):
    """Seeded element streams (titles, page breaks, oversized and empty
    elements, metadata) chunk alike at several sizes."""
    rng = np.random.default_rng(seed)
    words = ["alps", "ridge", "glacier", "x" * 40, "valley", "Mont", "Blanc", ""]
    elements = []
    for i in range(int(rng.integers(5, 40))):
        text = " ".join(rng.choice(words, size=int(rng.integers(0, 300))))
        elements.append(((text,), {"is_title": bool(rng.random() < 0.2), "page_number": int(i // 7) + 1,
                                   "metadata": {"filetype": "x", "n": i}}))
    for size in (50, 300, 1000):
        same(chunk(elements, max_characters=size))


# --- MIME detection ----------------------------------------------------------


def bmp_bytes():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (4, 4)).save(buf, format="BMP")
    return buf.getvalue()


@pytest.mark.parametrize(
    "args,expected",
    [
        (("text/plain", "doc.txt", build_pdf([[(72, 720, 12, "x")]])), "application/pdf"),
        (("text/html; charset=utf-8", None, b"<p>hi</p>"), "text/html"),
        ((None, "notes.md", b"# hi"), "text/markdown"),
        ((None, None, b"just words"), "text/plain"),
        (("text/plain", "report.txt", b"BMW sales report for 2026\nnumbers follow..."), "text/plain"),
        ((None, "deck.pptx", b"PK\x03\x04"), MIME_PPTX),
        (("application/octet-stream", "table.xlsx", b"PK\x03\x04"), MIME_XLSX),
        ((None, "scan.bin", b"\x89PNG\r\n\x1a\n...."), "image/png"),
        ((None, "a.csv", b"a,b\n1,2"), "text/csv"),
    ],
)
def test_detect_mime(args, expected):
    assert same(lambda P: P.m("documents.mime").detect_mime(*args)) == ("ok", expected)


@pytest.mark.parametrize("data", [b"%PDF-1.4", b"GIF89a..", b"BM", b"BMW sales", b"", b"II*\x00", None],
                         ids=["pdf", "gif", "bm", "bm_text", "empty", "tiff", "bmp"])
def test_sniff_mime(data):
    data = bmp_bytes() if data is None else data
    got = same(lambda P: P.m("documents.mime").sniff_mime(data))
    if data.startswith(b"BM") and len(data) > 20:
        assert got == ("ok", "image/bmp")


# --- Title / Narrative heuristics --------------------------------------------

TEXTS = [
    'Retrieved from "https://en.wikipedia.org/x"',
    "The Alps are high. They stretch far. Really!",
    "Short. This sentence has five words here.",
    "101. (2000), 27 12–13",
    "Etymology and toponymy",
    '128. "Rail". (http://www.swissworld.org/en/rail/) Swissworld.org. Retrieved August 20, 2012',
    "Caspar David Friedrich",
    "Retrieved August 20, 2012",
    "According to the survey",
    "(Reverted edits by Urmomy (talk))",
    "the mountains were formed",
    "External links",
    "References",
    "Geography",
    "Edelweiss (Leontopodium alpinum)",
    "Prehistory to Christianity",
    "The Alps are a classic example of what happens when a temperate area at lower altitude gives way to "
    "higher-elevation terrain.",
    'Retrieved from "https://en.wikipedia.org/w/index.php?x=1"',
    "Monaco,",
    "130. Hudson (2000), 107",
    "Template:Lang-de",
    "• first item",
    "•",
    "",
    "ÉTÉ À ZÜRICH",
]
FUNCTIONS = [
    ("word_tokenize", {}), ("split_sentences", {}), ("sentence_count", {}), ("sentence_count", {"min_length": 3}),
    ("under_non_alpha_ratio", {}), ("contains_verb", {}), ("exceeds_cap_ratio", {}), ("is_bulleted_text", {}),
    ("is_possible_narrative_text", {}), ("is_possible_title", {}), ("classify_text", {}),
]


@pytest.mark.parametrize("name,kw", FUNCTIONS, ids=[f"{n}{'-' + str(k) if k else ''}" for n, k in FUNCTIONS])
def test_texttype_function_matches_jax(name, kw):
    for text in TEXTS:
        same(lambda P: getattr(P.m("text.texttype"), name)(text, **kw))


def test_texttype_expectations_on_the_port():
    from dial_rag_tpu_torch.text import texttype as tt

    toks = tt.word_tokenize('Retrieved from "https://en.wikipedia.org/x"')
    assert "Retrieved" in toks and '"' in toks and any(t.startswith("https://") for t in toks)
    assert len(tt.split_sentences("The Alps are high. They stretch far. Really!")) == 3
    assert tt.sentence_count(TEXTS[2]) == 2 and tt.sentence_count(TEXTS[2], 3) == 1
    assert tt.under_non_alpha_ratio(TEXTS[3]) and not tt.under_non_alpha_ratio(TEXTS[4])
    assert not tt.exceeds_cap_ratio(TEXTS[5]) and tt.exceeds_cap_ratio(TEXTS[6])
    assert tt.contains_verb(TEXTS[7]) and tt.contains_verb(TEXTS[8]) and not tt.contains_verb(TEXTS[9])
    assert tt.contains_verb(TEXTS[10]) and not tt.contains_verb(TEXTS[4])
    assert all(tt.classify_text(t) == "title" for t in TEXTS[11:16] + [TEXTS[4], TEXTS[6]])
    assert all(tt.classify_text(t) != "title" for t in (TEXTS[16], TEXTS[17], TEXTS[5]))
    assert tt.classify_text("Monaco,") == "text" and tt.classify_text("130. Hudson (2000), 107") == "text"
    assert tt.is_possible_title("Template:Lang-de") and not tt.is_possible_narrative_text("Template:Lang-de")
    assert tt.classify_text("• first item") == "list_item" and tt.classify_text("•") == "text"


# --- elements: text, Markdown, CSV, HTML -------------------------------------


@pytest.mark.parametrize(
    "data,mime",
    [
        (b"para one\n\npara two", "text/plain"),
        (b"# Title\n\nBody text.\n\n# Other\n\nMore.", "text/markdown"),
        (b"# not a title\nsecond line\n\n## Sub\n\n\n\ntail", "text/plain"),
        ("café — naïve\n\n\xff".encode("utf-8") + b"\xff\xfe", "text/plain"),
    ],
)
def test_text_elements(data, mime):
    same(lambda P: P.m("documents.elements").text_elements(data, mime))


@pytest.mark.parametrize("data", [b"name,age\nalice,30\nbob,25", b'a," b ",,\n\n"q,uoted",x\n', b"\xff,1\n"])
def test_csv_elements(data):
    same(lambda P: P.m("documents.elements").csv_elements(data))


HTML_CASES = [
    b"""<html><head><style>p{}</style></head><body>
    <h1>Main Title</h1><p>Paragraph one about alps.</p>
    <h2>Sub</h2><p>Paragraph two.</p>
    <script>ignore()</script></body></html>""",
    b"<html><body><p>Before the table.</p><table><tr><th>Name</th><th>Height</th></tr>"
    b"<tr><td>Mont Blanc</td><td>4810</td></tr></table><p>After the table.</p></body></html>",
    b"<html><body><p>The Alps (<i>/\xc3\xa6lps/</i>; <a href='x'>high</a> peaks).</p></body></html>",
    b"<div>direct text<div>nested <b>bold</b></div><ul><li>one</li><li>two</li></ul></div>",
]


@pytest.mark.parametrize("data", HTML_CASES, ids=["titles", "table", "inline", "divs"])
def test_html_elements(data):
    same(lambda P: P.m("documents.elements").html_elements(data))


# --- parse_document: PDF and the text formats --------------------------------


def test_parse_pdf_chunks_with_pages_and_sources():
    pdf = build_pdf([[(72, 720, 18, "Chapter One"), (72, 695, 11, "First chapter body.")],
                     [(72, 720, 11, "Second page body.")]])
    got = chunks_of(same(parse(pdf, "application/pdf", source_link="files/bucket/doc.pdf", display_name="doc.pdf",
                               attachment_mime_type="application/pdf")))
    assert [t for t, _ in got] == ["Chapter One\n\nFirst chapter body.", "Second page body."]
    assert [(m["page_number"], m["source"], m["chunk_id"]) for _, m in got] == [
        (1, "files/bucket/doc.pdf#page=1", 0), (2, "files/bucket/doc.pdf#page=2", 1)]


def test_parse_pdf_image_only_page_gets_empty_chunk():
    pdf = build_pdf([[(72, 720, 11, "text page")], []])
    got = chunks_of(same(parse(pdf, "application/pdf", source_link="u", display_name="d")))
    assert len(got) == 2 and got[1][0] == "" and got[1][1]["page_number"] == 2


def test_parse_html():
    got = chunks_of(same(parse(HTML_CASES[0], "text/html", source_link="u")))
    assert [t for t, _ in got] == ["Main Title\n\nParagraph one about alps.", "Sub\n\nParagraph two."]


def test_parse_html_table_isolated_and_inline_markup():
    texts = [t for t, _ in chunks_of(same(parse(HTML_CASES[1], "text/html", source_link="t.html")))]
    ti = texts.index("Name Height Mont Blanc 4810")
    assert "Before" in texts[ti - 1] and "After" in texts[ti + 1]
    got = chunks_of(same(parse(HTML_CASES[2], "text/html", source_link="t.html")))
    assert got[0][0] == "The Alps (/ælps/; high peaks)."


def test_parse_recorded_html_chunks():
    """tests/test_parser_pipeline.py's alps_wiki.html oracle, through both
    packages; it needs the reference's HTML corpus, as the original does."""
    html_path = Path("/root/reference/tests/data/alps_wiki.html")
    fixture = Path(__file__).parent / "data" / "alps_html_oracle_chunks.json"
    if not html_path.is_file() or not fixture.is_file():
        pytest.skip("reference html corpus not mounted")
    got = chunks_of(same(parse(html_path.read_bytes(), "text/html", source_link="alps_wiki.html")))
    mine = {t for t, _ in got}
    assert sum(1 for t in json.load(open(fixture)) if t in mine) >= 10


@pytest.mark.parametrize(
    "data,mime,expected",
    [
        (b"para one\n\npara two", "text/plain", ["para one\n\npara two"]),
        (b"# Title\n\nBody text.\n\n# Other\n\nMore.", "text/markdown", ["Title\n\nBody text.", "Other\n\nMore."]),
        (b"name,age\nalice,30\nbob,25", "text/csv", None),
    ],
)
def test_parse_text_formats(data, mime, expected):
    got = chunks_of(same(parse(data, mime, source_link="u", display_name="u.txt")))
    if expected is not None:
        assert [t for t, _ in got] == expected
    else:
        assert "alice 30" in got[0][0]


def test_parse_image_document_single_empty_chunk():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (10, 10), "red").save(buf, format="PNG")
    got = chunks_of(same(parse(buf.getvalue(), "image/png", source_link="u")))
    assert len(got) == 1 and got[0][0] == "" and got[0][1]["page_number"] == 1


@pytest.mark.parametrize(
    "data,mime,kw,message",
    [
        (b"\x00\x01", "application/zip", {}, "Unable to load document content"),
        (b"", "text/plain", {}, "empty"),
        (b"x" * 200, "text/plain", {"max_document_text_size": 100}, "too large"),
        (b"not a pdf", "application/pdf", {}, "Unable to parse the PDF"),
    ],
)
def test_parse_errors(data, mime, kw, message):
    def call(P):
        parser = P.m("documents.parser")
        return parser.parse_document(data, mime, source_link="u",
                                     config=parser.ParserConfig(**kw) if kw else None)

    got = same(call)
    assert got[:2] == ("raise", "InvalidDocumentError") and message in got[2] and got[3] == "PKG.errors"


def test_parser_config_and_page_count():
    same(lambda P: P.m("documents.parser").ParserConfig(chunk_size=500).index_settings())
    pdf = build_pdf([[(72, 720, 11, "a")], [], [(72, 720, 11, "c")]])
    assert same(lambda P: P.m("documents.parser").extract_number_of_pages("application/pdf", pdf)) == ("ok", 3)
    same(lambda P: P.m("documents.parser").extract_number_of_pages("text/plain", b"x"))


# --- office formats ----------------------------------------------------------

OFFICE = {
    "docx": (build_docx([("Introduction", "Heading1"), ("First paragraph of text.", None),
                         ("Second paragraph.", None), ("Conclusion", "Heading2"), ("Final remarks.", None)]),
             MIME_DOCX),
    "docx_table": (build_docx([("Name|Height", "table"), ("After table.", None)]), MIME_DOCX),
    "pptx": (build_pptx([[("Slide One Title", True), ("Bullet A", False)],
                         [("Slide Two Title", True), ("Bullet B", False)]]), MIME_PPTX),
    "odt": (build_odt([("Heading", True), ("Body text.", False)]), MIME_ODT),
    "odp": (build_odp([[("Title", True)], [("Content", False)]]), MIME_ODP),
    "xlsx": (build_xlsx({"Peaks": [["Name", "Height"], ["Zarvok", "4123"]], "Rivers": [["Quilmar", "Long"]]}),
             MIME_XLSX),
}
EXPECTED = {
    "docx": [("Introduction", None, True), ("First paragraph of text.", None, False),
             ("Second paragraph.", None, False), ("Conclusion", None, True), ("Final remarks.", None, False)],
    "docx_table": [("Name | Height", None, False), ("After table.", None, False)],
    "pptx": [("Slide One Title", 1, True), ("Bullet A", 1, False), ("Slide Two Title", 2, True),
             ("Bullet B", 2, False)],
    "odt": [("Heading", None, True), ("Body text.", None, False)],
    "odp": [("Title", 1, True), ("Content", 2, False)],
    "xlsx": [("Peaks", None, True), ("Name | Height", None, False), ("Zarvok | 4123", None, False),
             ("Rivers", None, True), ("Quilmar | Long", None, False)],
}


@pytest.mark.parametrize("name", sorted(OFFICE))
def test_office_elements(name):
    data, mime = OFFICE[name]
    fn = {MIME_DOCX: "docx_elements", MIME_PPTX: "pptx_elements", MIME_ODT: "odt_elements",
          MIME_ODP: "odp_elements", MIME_XLSX: "xlsx_elements"}[mime]
    got = same(lambda P: getattr(P.m("documents.office"), fn)(data))
    assert elements_of(got, "text", "page_number", "is_title") == EXPECTED[name]
    assert same(lambda P: P.m("documents.office").office_elements(data, mime)) == got


@pytest.mark.parametrize("name", sorted(OFFICE))
def test_parse_office_document(name):
    data, mime = OFFICE[name]
    got = chunks_of(same(parse(data, mime, source_link=f"doc.{name}", display_name=f"doc.{name}")))
    assert got and all(m["source"] == f"doc.{name}" for _, m in got)


def test_parse_document_docx_end_to_end():
    data = build_docx([("Section", "Heading1")] + [(f"Sentence number {i} about mountains.", None)
                                                   for i in range(30)])
    got = chunks_of(same(parse(data, MIME_DOCX, source_link="doc.docx", display_name="doc.docx")))
    assert len(got) >= 2 and got[0][0].startswith("Section")


def test_xlsx_parse_document_end_to_end():
    data = build_xlsx({"Data": [["alpha", "beta"], ["gamma", "delta"]]})
    got = chunks_of(same(parse(data, MIME_XLSX, source_link="t.xlsx", display_name="t.xlsx")))
    assert "alpha | beta" in got[0][0]


def _zip_without_content():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("other.xml", "<x/>")
    return buf.getvalue()


def _rewrite_zip_member(data: bytes, name: str, payload: str) -> bytes:
    src = zipfile.ZipFile(io.BytesIO(data))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as zf:
        for item in src.namelist():
            zf.writestr(item, payload if item == name else src.read(item))
    return out.getvalue()


@pytest.mark.parametrize(
    "data,mime",
    [
        (b"not a zip at all", MIME_DOCX),
        (_zip_without_content(), MIME_DOCX),
        (_rewrite_zip_member(build_docx([("Body text.", None)]), "word/document.xml", "<a><b></a>"), MIME_DOCX),
    ] + [
        (_rewrite_zip_member(build_xlsx({"S": [["a", "b"]]}), part, "<not </xml"), MIME_XLSX)
        for part in ("xl/sharedStrings.xml", "xl/_rels/workbook.xml.rels", "xl/worksheets/sheet1.xml",
                     "xl/workbook.xml")
    ],
    ids=["not_a_zip", "no_content_part", "docx_bad_xml", "xlsx_bad_shared_strings", "xlsx_bad_rels",
         "xlsx_bad_sheet", "xlsx_bad_workbook"],
)
def test_invalid_office_document_rejected(data, mime):
    got = same(lambda P: P.m("documents.office").office_elements(data, mime))
    assert got[:2] == ("raise", "InvalidDocumentError") and got[3] == "PKG.errors"


def test_xlsx_package_absolute_relationship_target():
    base = build_xlsx({"Peaks": [["Zarvok", "4123"]]})
    rels = zipfile.ZipFile(io.BytesIO(base)).read("xl/_rels/workbook.xml.rels").decode()
    data = _rewrite_zip_member(base, "xl/_rels/workbook.xml.rels",
                               re.sub(r'Target="worksheets/', 'Target="/xl/worksheets/', rels))
    got = same(lambda P: P.m("documents.office").xlsx_elements(data))
    assert elements_of(got, "text", "is_title") == [("Peaks", True), ("Zarvok | 4123", False)]


@pytest.mark.parametrize("name", ["docx", "pptx", "xlsx", "odt"])
def test_fuzzed_office_parses_alike(name):
    """tests/test_office_parser.py's byte mutations: each mutated archive
    parses to the same chunks or raises the same InvalidDocumentError in
    both packages."""
    rng = np.random.default_rng(3)
    base, mime = OFFICE[name]
    for _ in range(60):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 10))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        got = same(parse(bytes(data), mime, source_link="f"))
        assert got[0] == "ok" or got[1] == "InvalidDocumentError", got


def test_port_errors_are_its_own_classes():
    from dial_rag_tpu_torch.documents.parser import parse_document
    from dial_rag_tpu_torch.errors import DialRagError, InvalidDocumentError

    with pytest.raises(InvalidDocumentError) as e:
        parse_document(b"", "text/plain", source_link="u")
    assert isinstance(e.value, DialRagError) and e.value.status_code == 400
    assert outcome(PORT, parse(b"", "text/plain", source_link="u"))[3] == "PKG.errors"
