"""Format-specific parsers producing chunkable Elements.

PDF uses the first-party parser (documents/pdf/); HTML the port's own
parser on the standard library's html.parser (documents/_html.py);
plain text / markdown / CSV are first-party.
Each parser returns a flat Element list in reading order with Title
elements marking section starts for the by-title chunker."""

import csv
import io
import re

from dial_rag_tpu_torch.documents._html import parse_html
from dial_rag_tpu_torch.documents.mime import (
    MIME_CSV,
    MIME_HTML,
    MIME_MARKDOWN,
    MIME_PDF,
    MIME_PLAIN,
)
from dial_rag_tpu_torch.documents.pdf import extract_pages_text
from dial_rag_tpu_torch.text.chunker import Element
from dial_rag_tpu_torch.text.texttype import classify_text


def pdf_elements(data: bytes) -> list[Element]:
    return pdf_elements_from_pages(extract_pages_text(data))


def pdf_elements_from_pages(pages) -> list[Element]:
    """Elements from already-extracted PageText (lets the parser reuse
    one PDF parse for both text elements and the page count). Title
    detection follows the reference's text-type heuristics (see
    text/texttype.py), NOT font size — the chunker starts a chunk at
    every Title, so this is part of the exact-chunk contract."""
    elements = []
    for page in pages:
        for block in page.blocks:
            elements.append(
                Element(
                    text=block.text,
                    is_title=classify_text(block.text) == "title",
                    page_number=page.page_number,
                    metadata={"filetype": MIME_PDF},
                )
            )
    return elements


_HTML_SKIP_TAGS = {"script", "style", "noscript", "head", "template"}
_HTML_BLOCK_TAGS = [
    "h1", "h2", "h3", "h4", "h5", "h6",
    "p", "li", "pre", "blockquote", "figcaption", "caption", "table",
]


def _clean_inline(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _div_direct_text(tag) -> str:
    return _clean_inline(
        " ".join(tag.find_all(string=True, recursive=False))
    )


def html_elements(data: bytes, mime: str = MIME_HTML) -> list[Element]:
    soup = parse_html(data)
    for tag in soup.find_all(_HTML_SKIP_TAGS):
        tag.decompose()

    elements = []
    emitted_divs: set = set()
    for tag in soup.find_all(_HTML_BLOCK_TAGS + ["div"]):
        # skip content already captured by an enclosing element (block
        # tag or an emitted text div) — every text node belongs to
        # exactly one element
        if any(
            p.name in _HTML_BLOCK_TAGS or id(p) in emitted_divs
            for p in tag.parents
        ):
            continue
        if tag.name == "div":
            # divs carrying DIRECT text (wiki hatnotes like
            # "Main article: ...") are elements in the reference's
            # segmentation; container divs (text only via children)
            # are not, and a div with block children defers to them
            if (
                not _div_direct_text(tag)
                or tag.find(_HTML_BLOCK_TAGS) is not None
                or any(
                    _div_direct_text(d) for d in tag.find_all("div")
                )
            ):
                continue
            elements.append(
                Element(
                    text=_clean_inline(tag.get_text()),
                    metadata={"filetype": mime},
                )
            )
            emitted_divs.add(id(tag))
            continue
        if tag.name == "table":
            # the reference emits a whole <table> as ONE Table element
            # (evidenced by its recorded chunks: the peaks table and the
            # navboxes each arrive as a single space-joined text blob),
            # and the chunker isolates it into its own chunk(s)
            cells = [
                " ".join(c.stripped_strings)
                for c in tag.find_all(["td", "th"])
            ]
            text = _clean_inline(" ".join(c for c in cells if c))
            if text:
                elements.append(
                    Element(
                        text=text,
                        metadata={"filetype": mime, "category": "table"},
                    )
                )
            continue
        else:
            # join inline elements WITHOUT inserting spaces (inline
            # markup like <i>/<a> splits words otherwise: "(/ælps/;"
            # must not become "( / æ l p s / ;"), then collapse the
            # document's own whitespace runs like the reference's
            # clean_extra_whitespace does
            text = _clean_inline(tag.get_text())
        if not text:
            continue
        elements.append(
            Element(
                text=text,
                is_title=tag.name.startswith("h"),
                metadata={"filetype": mime},
            )
        )
    if not elements:
        body_text = soup.get_text(" ", strip=True)
        if body_text:
            elements.append(
                Element(text=body_text, metadata={"filetype": mime})
            )
    return elements


def text_elements(data: bytes, mime: str = MIME_PLAIN) -> list[Element]:
    text = data.decode("utf-8", errors="replace")
    elements = []
    for para in text.split("\n\n"):
        para = para.strip()
        if not para:
            continue
        is_title = False
        if mime == MIME_MARKDOWN or para.startswith("#"):
            stripped = para.lstrip("#").strip()
            if para.startswith("#") and stripped and "\n" not in para:
                para = stripped
                is_title = True
        elements.append(
            Element(text=para, is_title=is_title, metadata={"filetype": mime})
        )
    return elements


def csv_elements(data: bytes) -> list[Element]:
    text = data.decode("utf-8", errors="replace")
    elements = []
    for row in csv.reader(io.StringIO(text)):
        line = " ".join(c.strip() for c in row if c.strip())
        if line:
            elements.append(Element(text=line, metadata={"filetype": MIME_CSV}))
    return elements
