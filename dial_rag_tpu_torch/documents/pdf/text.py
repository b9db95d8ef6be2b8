"""PDF text extraction: content-stream interpreter + layout assembly.

Interprets the text operators of ISO 32000 (BT/ET, Tf, Td/TD/Tm/T*,
Tc/Tw/Tz/TL/Ts, Tj/TJ/'/") with full text-space -> device-space transforms
(Tm x CTM), decodes bytes through the font layer, and assembles the
content-ordered chars into lines/boxes/reading-order with the
pdfminer-compatible analysis in layout.py (the reference's segmentation
goldens depend on that exact grouping — see layout.py docstring)."""

import logging
import math
import re
from dataclasses import dataclass, field

from dial_rag_tpu_torch.documents.pdf.document import PdfDocument
from dial_rag_tpu_torch.documents.pdf.fonts import PdfFont
from dial_rag_tpu_torch.documents.pdf.layout import LayoutParams, analyze_page
from dial_rag_tpu_torch.documents.pdf.objects import Lexer, Name, PdfError, Stream

logger = logging.getLogger(__name__)

Matrix = tuple[float, float, float, float, float, float]
IDENTITY: Matrix = (1, 0, 0, 1, 0, 0)


def mat_mul(a: Matrix, b: Matrix) -> Matrix:
    a0, a1, a2, a3, a4, a5 = a
    b0, b1, b2, b3, b4, b5 = b
    return (
        a0 * b0 + a1 * b2,
        a0 * b1 + a1 * b3,
        a2 * b0 + a3 * b2,
        a2 * b1 + a3 * b3,
        a4 * b0 + a5 * b2 + b4,
        a4 * b1 + a5 * b3 + b5,
    )


def apply_mat(m: Matrix, x: float, y: float) -> tuple[float, float]:
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


@dataclass
class Glyph:
    """A positioned char in device space; bbox matches pdfminer's LTChar
    convention (y0 = baseline + descent x size, height = font size)."""

    text: str
    x0: float
    y0: float
    x1: float
    y1: float

    @property
    def width(self) -> float:
        return self.x1 - self.x0

    @property
    def height(self) -> float:
        return self.y1 - self.y0


def clean_block_text(raw: str) -> str:
    """Newlines/nbsp -> spaces, collapse space runs, strip — the
    cleaning the reference applies to each extracted element
    (unstructured clean_extra_whitespace semantics, evidenced by the
    recorded element texts in the reference's cached traffic)."""
    return re.sub(r"  +", " ", re.sub(r"[\xa0\n]", " ", raw)).strip()


@dataclass
class TextBlock:
    text: str  # cleaned single-line text
    raw: str  # multi-line text as extracted (one trailing \n per line)
    font_size: float  # max char height in the block
    y: float  # top coordinate (larger = higher on page)
    x: float


@dataclass
class PageText:
    page_number: int  # 1-based
    blocks: list[TextBlock]

    @property
    def text(self) -> str:
        return "\n\n".join(b.text for b in self.blocks)


_SHOW_OPS = (b"Tj", b"TJ", b"'", b'"')


class TextExtractor:
    def __init__(self, doc: PdfDocument, page: dict):
        self.doc = doc
        self.page = page
        self.fonts: dict[str, PdfFont] = {}
        self.glyphs: list[Glyph] = []
        # image XObject placements: (stream, ctm at Do time); the unit
        # square transformed by ctm is the image's page-space rectangle
        self.images: list[tuple[Stream, Matrix]] = []

    def _get_font(self, name: str, resources: dict) -> PdfFont | None:
        if name in self.fonts:
            return self.fonts[name]
        fonts = self.doc.resolve(resources.get("Font")) or {}
        fdict = self.doc.resolve(fonts.get(name))
        font = PdfFont(self.doc, fdict) if isinstance(fdict, dict) else None
        self.fonts[name] = font
        return font

    def extract(self) -> list[Glyph]:
        resources = self.doc.resolve(self.page.get("Resources")) or {}
        content = self.doc.page_content(self.page)
        self._run(content, resources, IDENTITY, depth=0)
        return self.glyphs

    def _run(self, content: bytes, resources: dict, base_ctm: Matrix, depth: int):
        if depth > 8:
            return
        lex = Lexer(content, 0)
        n = len(content)
        stack: list = []
        gs_stack: list[Matrix] = []
        ctm = base_ctm

        font: PdfFont | None = None
        tfs = 0.0  # font size
        tc = 0.0  # char spacing
        tw = 0.0  # word spacing
        tz = 100.0  # horizontal scale (%)
        tl = 0.0  # leading
        ts = 0.0  # rise
        tm: Matrix = IDENTITY
        tlm: Matrix = IDENTITY

        def show(raw: bytes):
            nonlocal tm
            if font is None or not isinstance(raw, bytes):
                return
            h = tz / 100.0
            for code, is_space in font.iter_codes(raw):
                w0 = font.code_width(code) / 1000.0
                trm = mat_mul((tfs * h, 0, 0, tfs, 0, ts), mat_mul(tm, ctm))
                ch = font.code_to_unicode(code)
                scale = math.hypot(trm[0], trm[1])
                adv = (w0 * tfs + tc + (tw if is_space else 0.0)) * h
                # device-space glyph origin
                gx, gy = trm[4], trm[5]
                dev_size = math.hypot(trm[2], trm[3]) or abs(tfs) or 1.0
                if not ch and is_space:
                    ch = " "
                if ch:
                    # bbox per pdfminer's LTChar: advance wide, one font
                    # size tall, bottom at baseline + descent
                    gy0 = gy + font.descent * dev_size
                    self.glyphs.append(
                        Glyph(
                            text=ch,
                            x0=gx,
                            y0=gy0,
                            x1=gx + w0 * scale,
                            y1=gy0 + dev_size,
                        )
                    )
                tm = mat_mul((1, 0, 0, 1, adv, 0), tm)

        def tj_array(items):
            nonlocal tm
            h = tz / 100.0
            for item in items:
                if isinstance(item, bytes):
                    show(item)
                elif isinstance(item, (int, float)):
                    tm = mat_mul((1, 0, 0, 1, -item / 1000.0 * tfs * h, 0), tm)

        while True:
            lex.skip_ws()
            if lex.pos >= n:
                break
            c = content[lex.pos]
            try:
                if c in b"/<([+-.0123456789" or content[lex.pos : lex.pos + 2] in (
                    b"<<",
                ):
                    stack.append(lex.parse_object())
                    continue
                if c == 0x5D:  # stray ]
                    lex.pos += 1
                    continue
                op = lex.read_regular()
                if not op:
                    lex.pos += 1
                    continue
            except PdfError:
                lex.pos += 1
                continue

            try:
                if op == b"q":
                    gs_stack.append(ctm)
                elif op == b"Q":
                    if gs_stack:
                        ctm = gs_stack.pop()
                elif op == b"cm" and len(stack) >= 6:
                    m = tuple(float(v) for v in stack[-6:])
                    ctm = mat_mul(m, ctm)
                elif op == b"BT":
                    tm = tlm = IDENTITY
                elif op == b"ET":
                    pass
                elif op == b"Tf" and len(stack) >= 2:
                    size = stack[-1]
                    fname = stack[-2]
                    if isinstance(fname, Name):
                        font = self._get_font(fname.value, resources)
                    tfs = float(size)
                elif op == b"Tc" and stack:
                    tc = float(stack[-1])
                elif op == b"Tw" and stack:
                    tw = float(stack[-1])
                elif op == b"Tz" and stack:
                    tz = float(stack[-1])
                elif op == b"TL" and stack:
                    tl = float(stack[-1])
                elif op == b"Ts" and stack:
                    ts = float(stack[-1])
                elif op == b"Td" and len(stack) >= 2:
                    tlm = mat_mul((1, 0, 0, 1, float(stack[-2]), float(stack[-1])), tlm)
                    tm = tlm
                elif op == b"TD" and len(stack) >= 2:
                    tl = -float(stack[-1])
                    tlm = mat_mul((1, 0, 0, 1, float(stack[-2]), float(stack[-1])), tlm)
                    tm = tlm
                elif op == b"Tm" and len(stack) >= 6:
                    tlm = tuple(float(v) for v in stack[-6:])
                    tm = tlm
                elif op == b"T*":
                    tlm = mat_mul((1, 0, 0, 1, 0, -tl), tlm)
                    tm = tlm
                elif op == b"Tj" and stack:
                    show(stack[-1])
                elif op == b"TJ" and stack:
                    if isinstance(stack[-1], list):
                        tj_array(stack[-1])
                elif op == b"'" and stack:
                    tlm = mat_mul((1, 0, 0, 1, 0, -tl), tlm)
                    tm = tlm
                    show(stack[-1])
                elif op == b'"' and len(stack) >= 3:
                    tw = float(stack[-3])
                    tc = float(stack[-2])
                    tlm = mat_mul((1, 0, 0, 1, 0, -tl), tlm)
                    tm = tlm
                    show(stack[-1])
                elif op == b"Do" and stack:
                    xname = stack[-1]
                    if isinstance(xname, Name):
                        self._run_xobject(xname.value, resources, ctm, depth)
                elif op == b"BI":
                    # inline image: skip to EI
                    idx = content.find(b"EI", lex.pos)
                    lex.pos = idx + 2 if idx >= 0 else n

            except (TypeError, ValueError, KeyError) as e:
                # malformed operands (e.g. a Name where a number is
                # expected) must not abort the whole page/document
                logger.debug(f"skipping malformed operator {op!r}: {e}")
            stack.clear()  # operands are consumed per operator

        return

    def _run_xobject(self, name: str, resources: dict, ctm: Matrix, depth: int):
        xobjects = self.doc.resolve(resources.get("XObject")) or {}
        xobj = self.doc.resolve(xobjects.get(name))
        if not isinstance(xobj, Stream):
            return
        subtype = xobj.dict.get("Subtype")
        if isinstance(subtype, Name) and subtype.value == "Image":
            self.images.append((xobj, ctm))
            return
        if not (isinstance(subtype, Name) and subtype.value == "Form"):
            return
        inner_resources = (
            self.doc.resolve(xobj.dict.get("Resources")) or resources
        )
        inner_ctm = ctm
        mtx = self.doc.resolve(xobj.dict.get("Matrix"))
        if isinstance(mtx, list) and len(mtx) == 6:
            inner_ctm = mat_mul(tuple(float(v) for v in mtx), ctm)
        from dial_rag_tpu_torch.documents.pdf.filters import decode_stream

        try:
            content = decode_stream(xobj, resolve=self.doc.resolve)
        except PdfError:
            return
        self._run(content, inner_resources, inner_ctm, depth + 1)


def blocks_from_glyphs(
    glyphs: list[Glyph], params: LayoutParams | None = None
) -> list[TextBlock]:
    """Content-ordered glyphs -> reading-ordered text blocks via the
    pdfminer-compatible layout analysis."""
    blocks = []
    for box in analyze_page(glyphs, params):
        cleaned = clean_block_text(box.text)
        if not cleaned:
            continue
        blocks.append(
            TextBlock(
                text=cleaned,
                raw=box.text,
                font_size=box.max_char_height,
                y=box.y1,
                x=box.x0,
            )
        )
    return blocks


def extract_pages_text(data: bytes) -> list[PageText]:
    """Parse a PDF and return per-page text blocks in reading order."""
    doc = PdfDocument(data)
    pages = []
    for i, page in enumerate(doc.pages(), start=1):
        try:
            glyphs = TextExtractor(doc, page).extract()
            blocks = blocks_from_glyphs(glyphs)
        except PdfError:
            blocks = []
        pages.append(PageText(page_number=i, blocks=blocks))
    return pages
