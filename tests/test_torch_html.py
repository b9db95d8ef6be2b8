"""The port's HTML parsing (``documents/_html.py``, the HTML parser on the
standard library's ``html.parser``, and ``documents/elements.py::
html_elements`` on it) held against the JAX package's (bs4 over lxml) on
the CPU: the elements and ``parse_document``'s chunks through both
packages, and the port's tree against bs4's, node for node.

The tolerance is exact equality. The inputs are HTML_CASES of
tests/test_torch_documents.py, one named case for each construct of lxml's
HTML recovery the port reproduces, and GENERATED seeded malformed pages
(``tests/utils/html_pages.py``). bs4's charset guesser is switched off in
every test (``bs4.dammit._chardet_dammit`` returns None): that is how the
JAX package decodes where no guesser is installed, as on the card's
machine, and the port carries none.
"""

import bs4
import bs4.dammit
import pytest
from bs4.element import (
    Comment,
    Doctype,
    NavigableString,
    RubyParenthesisString,
    RubyTextString,
    Script,
    Stylesheet,
    TemplateString,
)

from dial_rag_tpu_torch.documents._html import NavigableString as PortString
from dial_rag_tpu_torch.documents._html import decode_html, parse_html
from tests.test_torch_documents import HTML_CASES
from tests.utils.html_pages import page
from tests.utils.port_parity import same

GENERATED = 240

NAMED = {
    "loose_text_no_implied_p": b"loose text<p>a</p>",
    "no_tbody_inserted": b"<table><tr><td>a</td><td>b</td></tr></table>",
    "block_closes_p": b"<p>a<div>b</div>c</p>",
    "li_closes_li": b"<ul><li>one<li>two<li>three</ul>",
    "td_closes_td": b"<table><tr><td>a<td>b<tr><td>c</table>",
    "dt_dd": b"<dl><dt>term<dd>def<dt>term2<dd>def2</dl>",
    "option_closes_option": b"<select><option>a<option>b</select><p>after</p>",
    "stray_end_tags": b"</p></div><p>x</span></b>y</p></li>",
    "text_between_head_and_body": b"<html><head><title>t</title></head>between<body><p>x</p></body></html>",
    "head_only_elements": b"<title>T</title><meta charset=utf-8><link rel=x><style>p{}</style><p>body text</p>",
    "text_in_head_opens_body": b"<head>loose<title>t</title><p>q</p>",
    "void_elements": b"<p>a<br>b<img src=x>c<hr>d<input>e</p><p>f<br/>g</p>",
    "entities": b"<p>&nbsp;a &amp; b &lt;c&gt; &copy 2024 &bogus; &#8212; &#x41; &#128; &notin; &noti x</p>",
    "numeric_controls": b"<p>[&#1;][&#11;][&#127;][&#xFDD0;][&#0;][&#xD800;][&#x110000;]</p>",
    "comments": b"<div>a<!-- c -->b<!---->c<!-->d<!-- a -- b -->e<?pi x?>f<![CDATA[z]]>g</div>",
    "comment_gives_div_direct_text": b"<div><!--note--><span>only child text</span></div>",
    "script_style_raw_text": b"<p>a<script>if (a < b) { x = '<p>'; }</script>b<style>p>b{}</style>c</p>",
    "raw_text_elements": b"<div><xmp><b>x</b>&amp;</xmp><textarea>&amp; <i>t</i></textarea></div>",
    "misplaced_html_body": b"<p>x<html><body>y</body>z</p><body>w",
    "after_html_end": b"<p>a</p></body></html>after<p>late</p>",
    "heading_in_list": b"<ul><li><h2>Head</h2>text<li>second</ul>",
    "nested_tables": b"<table><tr><td><table><tr><td>inner</table>outer<td>2</table>",
    "end_priority": b"<div><td>cell</div>text</td>more",
    "table_in_p": b"<p>before<table><tr><td>cell</td></tr></table>after</p>",
    "ruby": "<p>漢<ruby>字<rt>ji</rt><rp>(</rp></ruby></p>".encode(),
    "template_and_noscript": b"<template><p>hidden</p></template><noscript><p>no script</p></noscript><p>shown</p>",
    "uppercase_tags": b"<DIV><P>Upper <B>bold</B></P></DIV>",
    "cut_off_tag": b"<p>text</p><div class='a",
    "whitespace_text": b"<div><b>a</b> <i>b</i>\n<span>c</span></div>",
    "bom_utf8": b"\xef\xbb\xbf<p>caf\xc3\xa9</p>",
    "bom_utf16le": b"\xff\xfe" + "<p>café ΕΛ</p>".encode("utf-16-le"),
    "meta_charset": '<meta charset="iso-8859-2"><p>Łódź ąę</p>'.encode("iso-8859-2"),
    "http_equiv_charset": '<meta http-equiv="Content-Type" content="text/html; charset=koi8-r"><p>Привет</p>'.encode(
        "koi8-r"),
    "xml_declaration_charset": '<?xml version="1.0" encoding="iso-8859-7"?><p>Ελλάδα</p>'.encode("iso-8859-7"),
    "undeclared_latin1": "<p>café naïve</p>".encode("latin-1"),
    "invalid_utf8_bytes": b"<p>a\xe9\xb1b \xf0\x9f\x98c \xc0\xaf d \xff</p>",
}

_KINDS = {Comment: "comment", Doctype: "doctype", RubyTextString: "ruby", RubyParenthesisString: "ruby",
          Script: "script", Stylesheet: "style", TemplateString: "template", NavigableString: "text"}


@pytest.fixture(autouse=True)
def no_charset_guesser(monkeypatch):
    monkeypatch.setattr(bs4.dammit, "_chardet_dammit", lambda markup: None)


def bs4_tree(node) -> list:
    """(depth, name) of tags, (depth, kind, value) of strings, in document
    order; a doctype's text is left out (the port keeps only its name)."""
    out = []

    def walk(n, depth):
        for c in n.children:
            if isinstance(c, NavigableString):
                kind = _KINDS[type(c)]
                out.append((depth, kind, None if kind == "doctype" else str(c)))
            else:
                out.append((depth, c.name))
                walk(c, depth + 1)

    walk(node, 0)
    return out


def port_tree(node) -> list:
    out = []

    def walk(n, depth):
        for c in n.contents:
            if isinstance(c, PortString):
                out.append((depth, c.kind, None if c.kind == "doctype" else str(c)))
            else:
                out.append((depth, c.name))
                walk(c, depth + 1)

    walk(node, 0)
    return out


def check(data: bytes) -> None:
    assert port_tree(parse_html(data)) == bs4_tree(bs4.BeautifulSoup(data, "lxml"))
    same(lambda P: P.m("documents.elements").html_elements(data))
    same(lambda P: [(c.text, c.metadata) for c in P.m("documents.parser").parse_document(
        data, "text/html", source_link="files/t.html", display_name="t.html")])


@pytest.mark.parametrize("data", HTML_CASES, ids=["titles", "table", "inline", "divs"])
def test_html_cases_match_the_jax_package(data):
    check(data)


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_constructs_match_lxml(name):
    check(NAMED[name])


@pytest.mark.parametrize("seed", range(GENERATED))
def test_generated_malformed_pages_match_lxml(seed):
    check(page(seed))


def test_xhtml_mime_and_empty_documents():
    data = b"<html xmlns='http://www.w3.org/1999/xhtml'><body><p>x</p></body></html>"
    same(lambda P: P.m("documents.elements").html_elements(data, "application/xhtml+xml"))
    for empty in (b"", b"   ", b"<html><head><title>only</title></head></html>", b"<!-- c -->"):
        same(lambda P: P.m("documents.parser").parse_document(empty, "text/html", source_link="u"))


def test_decoding_order():
    """The byte-order mark wins over a declared charset; a declared charset
    Python does not know is passed over; then UTF-8, invalid bytes each one
    U+FFFD."""
    assert decode_html(b"\xef\xbb\xbf<meta charset=iso-8859-1><p>\xc3\xa9") == "<meta charset=iso-8859-1><p>é"
    assert decode_html(b"<meta charset=bogus-x><p>\xc3\xa9\xe9") == "<meta charset=bogus-x><p>é�"
    assert decode_html(b"<p>\xf0\x9f\x98c") == "<p>���c"
    late = b"<p>" + b"x" * 3000 + b"</p><meta charset=iso-8859-1><p>caf\xe9"
    assert decode_html(late).endswith("caf�")  # a declaration past bs4's window is not read
