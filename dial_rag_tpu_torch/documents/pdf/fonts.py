"""PDF font decoding: code bytes -> unicode text + glyph widths.

Supports simple fonts (Type1/TrueType/Type3: single-byte codes, base
encodings + /Differences, /Widths) and composite Type0 fonts with
Identity-H/V CID maps (2-byte codes, /W widths), with /ToUnicode CMaps
taking precedence for text extraction."""

from dial_rag_tpu_torch.documents.pdf.filters import decode_stream
from dial_rag_tpu_torch.documents.pdf.objects import Lexer, Name, PdfError, Stream

# Minimal Adobe Glyph List subset: names seen in /Differences arrays of
# real-world text PDFs. "uniXXXX"/"uXXXX[XX]" names are handled in code.
AGL = {
    "space": " ", "exclam": "!", "quotedbl": '"', "numbersign": "#",
    "dollar": "$", "percent": "%", "ampersand": "&", "quotesingle": "'",
    "parenleft": "(", "parenright": ")", "asterisk": "*", "plus": "+",
    "comma": ",", "hyphen": "-", "period": ".", "slash": "/",
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "colon": ":", "semicolon": ";", "less": "<", "equal": "=",
    "greater": ">", "question": "?", "at": "@", "bracketleft": "[",
    "backslash": "\\", "bracketright": "]", "asciicircum": "^",
    "underscore": "_", "grave": "`", "braceleft": "{", "bar": "|",
    "braceright": "}", "asciitilde": "~",
    "quoteleft": "‘", "quoteright": "’",
    "quotedblleft": "“", "quotedblright": "”",
    "endash": "–", "emdash": "—", "bullet": "•",
    "fi": "ﬁ", "fl": "ﬂ", "ff": "ﬀ", "ffi": "ﬃ",
    "ellipsis": "…", "dagger": "†", "daggerdbl": "‡",
    "trademark": "™", "copyright": "©", "registered": "®",
    "degree": "°", "plusminus": "±", "mu": "µ",
    "middot": "·", "periodcentered": "·",
    "germandbls": "ß", "agrave": "à", "aacute": "á",
    "acircumflex": "â", "atilde": "ã", "adieresis": "ä",
    "aring": "å", "ae": "æ", "ccedilla": "ç",
    "egrave": "è", "eacute": "é", "ecircumflex": "ê",
    "edieresis": "ë", "igrave": "ì", "iacute": "í",
    "icircumflex": "î", "idieresis": "ï", "ntilde": "ñ",
    "ograve": "ò", "oacute": "ó", "ocircumflex": "ô",
    "otilde": "õ", "odieresis": "ö", "divide": "÷",
    "oslash": "ø", "ugrave": "ù", "uacute": "ú",
    "ucircumflex": "û", "udieresis": "ü", "yacute": "ý",
    "ydieresis": "ÿ", "Euro": "€", "sterling": "£",
    "yen": "¥", "cent": "¢", "section": "§",
    "paragraph": "¶", "guillemotleft": "«",
    "guillemotright": "»", "exclamdown": "¡",
    "questiondown": "¿", "minus": "−", "fraction": "⁄",
    "nbspace": " ",
}
for _c in range(26):
    AGL[chr(65 + _c)] = chr(65 + _c)
    AGL[chr(97 + _c)] = chr(97 + _c)


def glyph_name_to_unicode(name: str) -> str:
    if name in AGL:
        return AGL[name]
    if name.startswith("uni") and len(name) >= 7:
        try:
            return chr(int(name[3:7], 16))
        except ValueError:
            pass
    if name.startswith("u") and len(name) in (5, 7):
        try:
            return chr(int(name[1:], 16))
        except ValueError:
            pass
    if len(name) == 1:
        return name
    return ""


def _base_encoding_map(name: str) -> dict[int, str]:
    table = {}
    if name == "MacRomanEncoding":
        codec = "mac_roman"
    else:  # WinAnsiEncoding and StandardEncoding approximated by cp1252
        codec = "cp1252"
    for code in range(32, 256):
        try:
            ch = bytes([code]).decode(codec)
        except UnicodeDecodeError:
            continue
        table[code] = ch
    return table


def parse_tounicode_cmap(data: bytes) -> dict[int, str]:
    """Parse bfchar/bfrange sections of a ToUnicode CMap."""
    cmap: dict[int, str] = {}
    lex = Lexer(data, 0)
    n = len(data)

    def utf16_of(b: bytes) -> str:
        try:
            return b.decode("utf-16-be")
        except UnicodeDecodeError:
            return ""

    while lex.pos < n:
        idx_char = data.find(b"beginbfchar", lex.pos)
        idx_range = data.find(b"beginbfrange", lex.pos)
        if idx_char < 0 and idx_range < 0:
            break
        if idx_range < 0 or (0 <= idx_char < idx_range):
            lex.pos = idx_char + len(b"beginbfchar")
            while True:
                lex.skip_ws()
                if lex.try_keyword(b"endbfchar"):
                    break
                try:
                    src = lex.parse_object()
                    dst = lex.parse_object()
                except PdfError:
                    break
                if isinstance(src, bytes) and isinstance(dst, bytes):
                    cmap[int.from_bytes(src, "big")] = utf16_of(dst)
        else:
            lex.pos = idx_range + len(b"beginbfrange")
            while True:
                lex.skip_ws()
                if lex.try_keyword(b"endbfrange"):
                    break
                try:
                    lo = lex.parse_object()
                    hi = lex.parse_object()
                    dst = lex.parse_object()
                except PdfError:
                    break
                if not (isinstance(lo, bytes) and isinstance(hi, bytes)):
                    break
                lo_i = int.from_bytes(lo, "big")
                hi_i = int.from_bytes(hi, "big")
                if isinstance(dst, bytes):
                    base = int.from_bytes(dst, "big") if dst else 0
                    width = len(dst)
                    for i in range(hi_i - lo_i + 1):
                        cmap[lo_i + i] = utf16_of(
                            (base + i).to_bytes(max(width, 2), "big")
                        )
                elif isinstance(dst, list):
                    for i, item in enumerate(dst):
                        if isinstance(item, bytes):
                            cmap[lo_i + i] = utf16_of(item)
    return cmap


class PdfFont:
    def __init__(self, doc, font_dict: dict):
        rv = doc.resolve
        self.subtype = ""
        st = rv(font_dict.get("Subtype"))
        if isinstance(st, Name):
            self.subtype = st.value
        self.is_cid = self.subtype == "Type0"
        self.two_byte = False
        self.tounicode: dict[int, str] = {}
        self.encoding_map: dict[int, str] = {}
        self.widths: dict[int, float] = {}
        self.default_width = 500.0
        # glyph-space descent (negative, /1000): char bbox bottom =
        # baseline + descent * size, matching pdfminer's LTChar bbox
        # convention the layout analysis tolerances are calibrated to
        self.descent = 0.0
        desc = rv(font_dict.get("FontDescriptor"))
        if not isinstance(desc, dict):
            df = rv(font_dict.get("DescendantFonts")) or []
            cid = rv(df[0]) if df else None
            if isinstance(cid, dict):
                desc = rv(cid.get("FontDescriptor"))
        if isinstance(desc, dict):
            d = rv(desc.get("Descent"))
            if isinstance(d, (int, float)):
                self.descent = float(d) / 1000.0

        tu = rv(font_dict.get("ToUnicode"))
        if isinstance(tu, Stream):
            try:
                self.tounicode = parse_tounicode_cmap(
                    decode_stream(tu, resolve=rv)
                )
            except Exception:
                self.tounicode = {}

        if self.is_cid:
            self._init_type0(doc, font_dict)
        else:
            self._init_simple(doc, font_dict)

    def _init_simple(self, doc, font_dict):
        rv = doc.resolve
        self.encoding_map = _base_encoding_map("StandardEncoding")
        enc = rv(font_dict.get("Encoding"))
        if isinstance(enc, Name):
            self.encoding_map = _base_encoding_map(enc.value)
        elif isinstance(enc, dict):
            base = rv(enc.get("BaseEncoding"))
            if isinstance(base, Name):
                self.encoding_map = _base_encoding_map(base.value)
            diffs = rv(enc.get("Differences")) or []
            code = 0
            for item in diffs:
                item = rv(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                elif isinstance(item, Name):
                    ch = glyph_name_to_unicode(item.value)
                    if ch:
                        self.encoding_map[code] = ch
                    code += 1

        first = rv(font_dict.get("FirstChar"))
        widths = rv(font_dict.get("Widths"))
        if isinstance(first, int) and isinstance(widths, list):
            for i, w in enumerate(widths):
                w = rv(w)
                if isinstance(w, (int, float)):
                    self.widths[first + i] = float(w)
        desc = rv(font_dict.get("FontDescriptor"))
        if isinstance(desc, dict):
            mw = rv(desc.get("MissingWidth"))
            if isinstance(mw, (int, float)):
                self.default_width = float(mw)
            else:
                self.default_width = 0.0
        else:
            self.default_width = 500.0

    def _init_type0(self, doc, font_dict):
        rv = doc.resolve
        enc = rv(font_dict.get("Encoding"))
        if isinstance(enc, Name) and enc.value in ("Identity-H", "Identity-V"):
            self.two_byte = True
        else:
            self.two_byte = True  # most Type0 CMaps in the wild are 2-byte
        desc_fonts = rv(font_dict.get("DescendantFonts")) or []
        if desc_fonts:
            cid_font = rv(desc_fonts[0])
            if isinstance(cid_font, dict):
                dw = rv(cid_font.get("DW"))
                self.default_width = (
                    float(dw) if isinstance(dw, (int, float)) else 1000.0
                )
                w = rv(cid_font.get("W")) or []
                self._parse_cid_widths([rv(x) for x in w], rv)
        else:
            self.default_width = 1000.0

    def _parse_cid_widths(self, w: list, rv):
        i = 0
        while i < len(w):
            first = w[i]
            if i + 1 >= len(w):
                break
            second = rv(w[i + 1])
            if isinstance(second, list):
                for j, width in enumerate(second):
                    width = rv(width)
                    if isinstance(width, (int, float)):
                        self.widths[int(first) + j] = float(width)
                i += 2
            else:
                if i + 2 >= len(w):
                    break
                width = rv(w[i + 2])
                for cid in range(int(first), int(second) + 1):
                    if isinstance(width, (int, float)):
                        self.widths[cid] = float(width)
                i += 3

    def iter_codes(self, raw: bytes):
        """Yield (code, is_space_byte) for each character code in raw."""
        if self.two_byte:
            for i in range(0, len(raw) - 1, 2):
                yield (raw[i] << 8) | raw[i + 1], False
            if len(raw) % 2:
                yield raw[-1], False
        else:
            for b in raw:
                yield b, b == 0x20

    def code_to_unicode(self, code: int) -> str:
        if code in self.tounicode:
            return self.tounicode[code]
        if not self.is_cid and code in self.encoding_map:
            return self.encoding_map[code]
        if self.is_cid:
            return ""  # no ToUnicode, no Identity mapping to text
        if 32 <= code < 127:
            return chr(code)
        return ""

    def code_width(self, code: int) -> float:
        return self.widths.get(code, self.default_width)
