"""An HTML parser on the standard library's ``html.parser``.

It builds the tree that ``BeautifulSoup(data, "lxml")`` gives (bs4 over
lxml's HTML parser, libxml2 2.14), as far as the HTML elements of
``documents/elements.py`` read it: element names and nesting, and the
strings with their kinds. The tokenizer is ``html.parser.HTMLParser``,
set to libxml2's raw-text elements; the tree construction is libxml2's:

- ``html``, ``head`` and ``body`` are implied as libxml2 implies them:
  head-only elements (``script``, ``style``, ``meta``, ``link``,
  ``title``, ``base``) open an implied ``head`` once, any other element
  or text an implied ``body`` once; text with only ``html`` or ``head``
  open closes ``head`` and goes to the body;
- a start tag first closes the open elements that it ends
  (``_START_CLOSES``: ``<p>a<div>`` closes the ``p``, ``<li>`` an open
  ``li``, ``<td>`` an open ``td``), one at a time from the innermost;
- an end tag closes every element up to its own, unless one on the way
  ranks above it (``_END_PRIORITY``); an end tag of no open element is
  dropped; misplaced ``html``, ``head`` and ``body`` tags are dropped;
- void elements close at once; whitespace before the root is dropped.

bs4's part: adjacent text is one string; a string of ASCII whitespace
becomes ``"\\n"`` (if it holds one) or ``" "``, outside ``pre`` and
``textarea``; comments, processing instructions and CDATA sections are
comment strings; strings inside ``script``, ``style``, ``template``,
``rt`` and ``rp`` have their own kinds, and ``get_text`` reads only
plain text.

Bytes are decoded as bs4 picks the encoding when no guesser is
installed: the byte-order mark, then a charset declared in an XML
declaration or a ``<meta>`` tag near the start, then UTF-8, with each
byte of an invalid sequence one U+FFFD, as libxml2 reads it.
"""

import codecs
import html
import re
from html.parser import HTMLParser

# -- libxml2's tree construction tables ---------------------------------------

# the new tag -> the open elements it closes (libxml2's htmlStartClose)
_CLOSED_BY: dict[str, tuple[str, ...]] = {
    "a": ("a", "fieldset", "table", "td", "th"),
    "address": ("dd", "dl", "dt", "form", "li", "ul"),
    "b": ("center", "p", "td", "th"),
    "big": ("p",),
    "caption": ("col", "colgroup", "tbody", "tfoot", "thead", "tr"),
    "colgroup": ("colgroup", "tbody", "tfoot", "thead", "tr"),
    "dd": ("dt",),
    "dir": ("dd", "dl", "dt", "form", "ul"),
    "dl": ("form", "li"),
    "dt": ("dd", "dl"),
    "font": ("center", "td", "th"),
    "form": ("form",),
    "h1": ("fieldset", "form", "li", "p", "table"),
    "h2": ("fieldset", "form", "li", "p", "table"),
    "h3": ("fieldset", "form", "li", "p", "table"),
    "h4": ("fieldset", "form", "li", "p", "table"),
    "h5": ("fieldset", "form", "li", "p", "table"),
    "h6": ("fieldset", "form", "li", "p", "table"),
    "i": ("center", "p", "td", "th"),
    "legend": ("fieldset",),
    "li": ("li",),
    "menu": ("dd", "dl", "dt", "form", "ul"),
    "ol": ("form",),
    "option": ("optgroup", "option"),
    "p": ("address", "blockquote", "body", "caption", "center", "col", "colgroup", "dd", "dir", "div", "dl",
          "dt", "fieldset", "form", "frameset", "h1", "h2", "h3", "h4", "h5", "h6", "head", "hr", "li",
          "listing", "menu", "ol", "p", "pre", "table", "tbody", "td", "tfoot", "th", "title", "tr", "ul",
          "xmp"),
    "pre": ("dd", "dl", "dt", "fieldset", "form", "li", "table", "ul"),
    "s": ("p",),
    "small": ("p",),
    "span": ("td", "th"),
    "strike": ("p",),
    "tbody": ("tbody", "tfoot"),
    "td": ("tbody", "td", "tfoot", "th", "tr"),
    "tfoot": ("tbody",),
    "th": ("tbody", "td", "tfoot", "th", "tr"),
    "thead": ("tbody", "tfoot"),
    "tr": ("tbody", "tfoot", "tr"),
    "tt": ("p",),
    "u": ("p", "td", "th"),
    "ul": ("address", "form", "menu", "pre"),
    "listing": ("dd", "dl", "dt", "fieldset", "form", "li", "table", "ul"),
    "head": ("a", "abbr", "body", "acronym", "address", "b", "bdo", "big", "blockquote", "br", "center", "cite",
             "code", "dd", "dfn", "dir", "div", "dl", "dt", "em", "fieldset", "font", "form", "frameset",
             "h1", "h2", "h3", "h4", "h5", "h6", "hr", "i", "iframe", "img", "kbd", "li", "listing", "map",
             "menu", "ol", "p", "pre", "q", "s", "samp", "small", "span", "strike", "strong", "sub", "sup",
             "table", "tt", "u", "ul", "var", "xmp"),
}
# the new tag -> the open elements it closes
_START_CLOSES = {new: frozenset(old for old, news in _CLOSED_BY.items() if new in news)
                 for new in {n for news in _CLOSED_BY.values() for n in news}}

# an end tag closes no element of higher rank on its way (htmlEndPriority)
_END_PRIORITY = {"div": 150, "td": 160, "th": 160, "tr": 170, "thead": 180, "tbody": 180, "tfoot": 180,
                 "table": 190, "head": 200, "body": 200, "html": 220}
_DEFAULT_PRIORITY = 100

_VOID = frozenset(("area", "base", "basefont", "br", "col", "frame", "hr", "img", "input", "isindex", "link", "meta",
                   "param"))
_HEAD_ONLY = frozenset(("script", "style", "meta", "link", "title", "base"))
_NO_BODY = frozenset(("noframes", "frame", "frameset"))
_BLANK = " \t\n\r"

# bs4: the string kinds of these elements' text, and where whitespace stays
_STRING_KINDS = {"rt": "ruby", "rp": "ruby", "style": "style", "script": "script", "template": "template"}
_PRESERVE_WHITESPACE = frozenset(("pre", "textarea"))
_ASCII_SPACES = "\x20\x0a\x09\x0c\x0d"
_COMMENT_CLOSE = re.compile(r"--!?>")
_TAG_NAME = re.compile(r"[a-zA-Z][^\t\n\r\f />\x00]*")
_END_TAG_REST = re.compile(r"""(?:[^>'"]|'[^']*'|"[^"]*")*>""")
_ASCII_LOWER = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")


def _ascii_lower(name: str) -> str:
    return name.translate(_ASCII_LOWER)


# html.unescape's pattern; numeric references as HTML and libxml2 read
# them (controls and noncharacters kept, which html.unescape drops)
_CHARREF = re.compile(r"&(#[0-9]+;?|#[xX][0-9a-fA-F]+;?|[^\t\n\f <&#;]{1,32};?)")


def _charref(match) -> str:
    ref = match.group(1)
    if ref[0] != "#":
        return html.unescape("&" + ref)  # named: the longest legacy prefix without ";"
    digits = ref[1:].rstrip(";")
    num = int(digits[1:], 16) if digits[0] in "xX" else int(digits)
    if num == 0 or 0xD800 <= num <= 0xDFFF or num > 0x10FFFF:
        return "\ufffd"
    if 0x80 <= num <= 0x9F:
        try:
            return bytes([num]).decode("cp1252")
        except UnicodeDecodeError:
            return chr(num)
    if num == 0x0D:
        return "\r"
    return chr(num)


def unescape(text: str) -> str:
    return _CHARREF.sub(_charref, text) if "&" in text else text


# -- the tree -------------------------------------------------------------------

class NavigableString(str):
    """A string of the tree: ``kind`` is "text" for document text, else
    "comment", "doctype", or the kind of its raw-text or ruby element."""

    kind = "text"
    parent = None


def _new_string(value: str, kind: str, parent) -> NavigableString:
    s = NavigableString(value)
    s.kind = kind
    s.parent = parent
    return s


class Tag:
    """An element: ``name``, ``attrs``, ``contents`` (tags and strings)."""

    def __init__(self, name: str, attrs: dict | None = None, parent=None):
        self.name = name
        self.attrs = attrs or {}
        self.parent = parent
        self.contents: list = []

    @property
    def parents(self):
        node = self.parent
        while node is not None:
            yield node
            node = node.parent

    @property
    def descendants(self):
        stack = list(reversed(self.contents))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, Tag):
                stack.extend(reversed(node.contents))

    def find_all(self, name=None, string=None, recursive: bool = True) -> list:
        """Descendants in document order: tags whose name is ``name`` (a
        name or a collection of names), or with ``string=True`` strings of
        every kind; ``recursive=False`` reads the children only."""
        nodes = self.descendants if recursive else iter(self.contents)
        if string is True:
            return [n for n in nodes if isinstance(n, NavigableString)]
        names = {name} if isinstance(name, str) else set(name)
        return [n for n in nodes if isinstance(n, Tag) and n.name in names]

    def find(self, name):
        names = {name} if isinstance(name, str) else set(name)
        for n in self.descendants:
            if isinstance(n, Tag) and n.name in names:
                return n
        return None

    def _strings(self, strip: bool):
        for n in self.descendants:
            if isinstance(n, NavigableString) and n.kind == "text":
                if strip:
                    n = n.strip()
                    if not n:
                        continue
                yield n

    @property
    def stripped_strings(self):
        return self._strings(True)

    def get_text(self, separator: str = "", strip: bool = False) -> str:
        return separator.join(self._strings(strip))

    def decompose(self) -> None:
        if self.parent is not None:
            self.parent.contents.remove(self)
            self.parent = None


# -- decoding -----------------------------------------------------------------

# bs4's declared-encoding patterns (bs4/dammit.py), searched the same spans
_XML_ENCODING = re.compile(rb"^\s*<\?.*encoding=['\"](.*?)['\"].*\?>", re.I)
_HTML_META = re.compile(rb"<\s*meta[^>]+charset\s*=\s*[\"']?([^>]*?)[ /;'\">]", re.I)
_BOMS = ((b"\xef\xbb\xbf", "utf-8"), (b"\x00\x00\xfe\xff", "utf-32be"), (b"\xff\xfe\x00\x00", "utf-32le"))


def _strip_bom(data: bytes) -> tuple[bytes, str | None]:
    if len(data) >= 4 and data[:2] == b"\xfe\xff" and data[2:4] != b"\x00\x00":
        return data[2:], "utf-16be"
    if len(data) >= 4 and data[:2] == b"\xff\xfe" and data[2:4] != b"\x00\x00":
        return data[2:], "utf-16le"
    for bom, encoding in _BOMS:
        if data.startswith(bom):
            return data[len(bom):], encoding
    return data, None


def _declared_encoding(data: bytes) -> str | None:
    match = _XML_ENCODING.search(data, 0, 1024)
    if not match:
        match = _HTML_META.search(data, 0, max(2048, int(len(data) * 0.05)))
    if match and match.group(1):
        return match.group(1).decode("ascii", "replace").lower()
    return None


def _decode_utf8(data: bytes) -> str:
    # libxml2 gives one U+FFFD for each byte of an invalid sequence
    text = data.decode("utf-8", "surrogateescape")
    return re.sub("[\udc80-\udcff]", "\ufffd", text)


def decode_html(data: bytes) -> str:
    """The text of HTML bytes: the byte-order mark's encoding, else the
    declared one (if Python knows it and it decodes the bytes), else
    UTF-8 with invalid bytes replaced."""
    body, sniffed = _strip_bom(data)
    for encoding in (sniffed, _declared_encoding(body)):
        try:
            name = codecs.lookup(encoding).name if encoding else None
        except LookupError:
            continue
        if name == "utf-8":
            return _decode_utf8(body)
        if name:
            try:
                return body.decode(name)
            except UnicodeDecodeError:
                continue
    return _decode_utf8(body)


# -- the parser ------------------------------------------------------------------

class _TreeParser(HTMLParser):
    # libxml2's raw-text (not unescaped) and escapable raw-text elements,
    # pinned here: html.parser's own sets differ across Python releases
    CDATA_CONTENT_ELEMENTS = ("script", "style", "xmp", "iframe", "noembed", "noframes", "plaintext")
    RCDATA_CONTENT_ELEMENTS = ("textarea", "title")

    def __init__(self, amp: str):
        # every "&" of the document is fed as ``amp`` (a character the
        # document lacks), so html.parser unescapes nothing and the text's
        # references are read here, libxml2's way
        super().__init__(convert_charrefs=True)
        self.amp = amp
        self.raw_text = False
        self._set_support_cdata(False)  # <![CDATA[...]]> is a bogus comment in HTML
        self.document = Tag("[document]")
        self.stack: list[Tag] = []
        self.in_content = False  # past the prolog's comments and doctype, whose blanks are dropped
        self.html_level = 0  # 3 once a head was opened, 10 once a body was
        self.discarded = 0  # html / head / body start tags dropped, whose end tags are dropped too
        self.pending: list[str] = []  # text not yet a string: bs4 joins adjacent text

    def _restore(self, value: str) -> str:
        return value.replace(self.amp, "&")

    def clear_cdata_mode(self):
        super().clear_cdata_mode()
        self.raw_text = False

    def set_cdata_mode(self, elem, *args, **kwargs):
        super().set_cdata_mode(elem, *args, **kwargs)
        self.raw_text = elem in self.CDATA_CONTENT_ELEMENTS
        if elem == "plaintext":  # the rest of the document is its text
            self.interesting = re.compile(r"\Z")

    def parse_comment(self, i, report=True):
        # HTML's comment states: "<!-->" and "<!--->" are empty comments
        rawdata = self.rawdata
        for abrupt in (">", "->"):
            if rawdata.startswith(abrupt, i + 4):
                if report:
                    self.handle_comment("")
                return i + 4 + len(abrupt)
        match = _COMMENT_CLOSE.search(rawdata, i + 4)
        if not match:
            return -1
        if report:
            self.handle_comment(rawdata[i + 4:match.start()])
        return match.end()

    def parse_endtag(self, i):
        # HTML's end tag open state: "</>" is dropped, "</" and no letter
        # opens a bogus comment; names are lowered in ASCII only, as libxml2
        # lowers them
        rawdata = self.rawdata
        end = rawdata.find(">", i + 2)
        if end < 0:
            return -1
        self.in_content = True
        if not _TAG_NAME.match(rawdata, i + 2):
            if end == i + 2:
                return end + 1
            self.handle_comment(rawdata[i + 2:end])
            return end + 1
        if self.cdata_elem:  # html.parser only ends raw text at its own end tag
            return super().parse_endtag(i)
        name = _TAG_NAME.match(rawdata, i + 2).group()
        # the tag ends at the first ">" outside a quoted attribute value
        match = _END_TAG_REST.match(rawdata, i + 2 + len(name))
        if not match:
            return -1
        self.handle_endtag(self._tag_name(name, 0))
        self.clear_cdata_mode()
        return match.end()

    # -- bs4's string handling

    def _current(self) -> Tag:
        return self.stack[-1] if self.stack else self.document

    def _flush(self) -> None:
        if self.pending:
            value = "".join(self.pending)
            self.pending = []
            self._append_string(value, self._text_kind())

    def _append_string(self, value: str, kind: str) -> None:
        if not value.strip(_ASCII_SPACES) and not any(t.name in _PRESERVE_WHITESPACE for t in self.stack):
            value = "\n" if "\n" in value else " "
        parent = self._current()
        parent.contents.append(_new_string(value, kind, parent))

    def _text_kind(self) -> str:
        for tag in reversed(self.stack):
            if tag.name in _STRING_KINDS:
                return _STRING_KINDS[tag.name]
        return "text"

    def _add_special(self, value: str, kind: str) -> None:
        self._flush()
        self._append_string(value, kind)

    # -- libxml2's tree construction

    def _push(self, name: str, attrs: dict | None = None) -> None:
        self._flush()
        if name == "head" and self.html_level < 3:
            self.html_level = 3
        if name == "body" and self.html_level < 10:
            self.html_level = 10
        parent = self._current()
        tag = Tag(name, attrs, parent)
        parent.contents.append(tag)
        self.stack.append(tag)

    def _pop(self) -> None:
        self._flush()
        self.stack.pop()

    def _auto_close(self, name: str) -> None:
        closes = _START_CLOSES.get(name)
        while closes and self.stack and self.stack[-1].name in closes:
            self._pop()

    def _check_implied(self, name: str) -> None:
        if name == "html":
            return
        if not self.stack:
            self._push("html")
        if name in ("body", "head"):
            return
        if len(self.stack) <= 1 and name in _HEAD_ONLY:
            if self.html_level >= 3:
                return
            self._push("head")
        elif name not in _NO_BODY:
            if self.html_level >= 10:
                return
            if any(t.name in ("body", "head") for t in self.stack):
                return
            self._push("body")

    def _tag_name(self, text: str, at: int) -> str:
        return _ascii_lower(self._restore(_TAG_NAME.match(text, at).group()))

    def handle_starttag(self, tag, attrs):
        tag = self._tag_name(self.get_starttag_text(), 1)
        self.in_content = True
        self._auto_close(tag)
        self._check_implied(tag)
        if (tag == "html" and self.stack) or (tag == "head" and len(self.stack) != 1) or (
            tag == "body" and any(t.name == "body" for t in self.stack)
        ):
            self.discarded += 1
            return
        self._push(tag, {k: unescape(self._restore(v or "")) for k, v in attrs})
        if tag in _VOID:
            self._pop()

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs)
        tag = self._tag_name(self.get_starttag_text(), 1)
        if tag not in _VOID and self.stack and self.stack[-1].name == tag:
            self._pop()

    def handle_endtag(self, tag):
        if self.discarded and tag in ("html", "body", "head"):
            self.discarded -= 1
            return
        names = [t.name for t in self.stack]
        if tag not in names:
            return
        priority = _END_PRIORITY.get(tag, _DEFAULT_PRIORITY)
        for name in reversed(names):
            if name == tag:
                break
            if _END_PRIORITY.get(name, _DEFAULT_PRIORITY) > priority:
                return
        while self.stack[-1].name != tag:
            self._pop()
        self._pop()

    def handle_data(self, data):
        data = self._restore(data)
        if not self.raw_text:
            data = unescape(data)
        data = data.replace("\x00", "\ufffd")
        if not self.in_content:
            data = data.lstrip(_BLANK)
        if not data:
            return
        self.in_content = True
        if data.strip(_BLANK) and (not self.stack or self.stack[-1].name in ("html", "head")):
            lead = data[: len(data) - len(data.lstrip(_BLANK))]
            if lead:
                self.pending.append(lead)
                data = data[len(lead):]
            self._auto_close("p")
            self._check_implied("p")
        self.pending.append(data)

    def handle_comment(self, data):
        self._add_special(self._restore(data), "comment")

    def handle_pi(self, data):
        self._add_special("?" + self._restore(data), "comment")

    def unknown_decl(self, data):
        self._add_special("[" + self._restore(data) + "]", "comment")

    def handle_decl(self, decl):
        parts = self._restore(decl).split(None, 1)
        name = parts[1].split(None, 1)[0].lower() if len(parts) > 1 else ""
        self._add_special(name, "doctype")

    def finish(self) -> Tag:
        # a start tag cut off by the end of the document is dropped, after
        # libxml2 has implied the elements it would sit in
        if self.rawdata.startswith("<") and _TAG_NAME.match(self.rawdata, 1) and not self.cdata_elem:
            self.in_content = True
            tag = self._tag_name(self.rawdata, 1)
            self._auto_close(tag)
            self._check_implied(tag)
        self.close()
        while self.stack:
            self._pop()
        self._flush()
        return self.document


def parse_html(data: bytes | str) -> Tag:
    """The document tree of HTML bytes (decoded by ``decode_html``) or text."""
    text = decode_html(data) if isinstance(data, bytes) else data
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    amp = next(c for c in map(chr, range(0xFDD0, 0x10000)) if c not in text)
    parser = _TreeParser(amp)
    parser.feed(text.replace("&", amp))
    return parser.finish()
