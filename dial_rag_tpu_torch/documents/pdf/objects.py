"""PDF object model + lexer/parser.

First-party replacement for the pdfminer layer the reference gets through
`unstructured`/`pdfplumber` (SURVEY.md §2.2) — none of those are available
in a zero-egress TPU image, and parsing is host-side string work anyway.

Implements the COS object layer of ISO 32000: booleans, numbers, strings
(literal + hex), names, arrays, dictionaries, streams, null, and indirect
references. The parser is position-based over the raw bytes.
"""

from dataclasses import dataclass


class PdfError(Exception):
    pass


@dataclass(frozen=True)
class Name:
    value: str

    def __repr__(self):
        return f"/{self.value}"


@dataclass(frozen=True)
class Ref:
    num: int
    gen: int


@dataclass
class Stream:
    dict: dict
    raw: bytes  # undecoded stream payload

    def decoded(self) -> bytes:
        from dial_rag_tpu_torch.documents.pdf.filters import decode_stream

        return decode_stream(self)


WHITESPACE = b"\x00\t\n\x0c\r "
DELIMITERS = b"()<>[]{}/%"


def _is_ws(c: int) -> bool:
    return c in WHITESPACE


def _is_delim(c: int) -> bool:
    return c in DELIMITERS


def _is_regular(c: int) -> bool:
    return not _is_ws(c) and not _is_delim(c)


class Lexer:
    """Byte-level tokenizer/parser for COS objects."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    # -- low level ---------------------------------------------------------

    def skip_ws(self):
        data, n = self.data, len(self.data)
        pos = self.pos
        while pos < n:
            c = data[pos]
            if _is_ws(c):
                pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while pos < n and data[pos] not in b"\r\n":
                    pos += 1
            else:
                break
        self.pos = pos

    def peek(self) -> int:
        if self.pos >= len(self.data):
            raise PdfError("unexpected EOF")
        return self.data[self.pos]

    def read_regular(self) -> bytes:
        start = self.pos
        data, n = self.data, len(self.data)
        while self.pos < n and _is_regular(data[self.pos]):
            self.pos += 1
        return data[start : self.pos]

    def expect_keyword(self, kw: bytes):
        self.skip_ws()
        if self.data[self.pos : self.pos + len(kw)] != kw:
            raise PdfError(
                f"expected {kw!r} at {self.pos}, got "
                f"{self.data[self.pos : self.pos + len(kw) + 8]!r}"
            )
        self.pos += len(kw)

    def try_keyword(self, kw: bytes) -> bool:
        self.skip_ws()
        end = self.pos + len(kw)
        if self.data[self.pos : end] == kw and (
            end >= len(self.data) or not _is_regular(self.data[end])
        ):
            self.pos = end
            return True
        return False

    # -- objects -----------------------------------------------------------

    def parse_object(self):
        self.skip_ws()
        c = self.peek()
        if c == 0x2F:  # /
            return self.parse_name()
        if c == 0x28:  # (
            return self.parse_literal_string()
        if c == 0x3C:  # <
            if self.data[self.pos : self.pos + 2] == b"<<":
                d = self.parse_dict()
                return self._maybe_stream(d)
            return self.parse_hex_string()
        if c == 0x5B:  # [
            return self.parse_array()
        if c in b"+-.0123456789":
            return self.parse_number_or_ref()
        word = self.read_regular()
        if word == b"true":
            return True
        if word == b"false":
            return False
        if word == b"null":
            return None
        raise PdfError(f"unexpected token {word!r} at {self.pos}")

    def parse_name(self) -> Name:
        if self.data[self.pos] != 0x2F:
            raise PdfError(f"expected name at {self.pos}")
        self.pos += 1
        raw = bytearray()
        data, n = self.data, len(self.data)
        while self.pos < n and _is_regular(data[self.pos]):
            c = data[self.pos]
            if c == 0x23 and self.pos + 2 < n:  # '#' hex escape
                try:
                    raw.append(int(data[self.pos + 1 : self.pos + 3], 16))
                    self.pos += 3
                    continue
                except ValueError:
                    pass
            raw.append(c)
            self.pos += 1
        return Name(raw.decode("latin-1"))

    def parse_literal_string(self) -> bytes:
        if self.data[self.pos] != 0x28:
            raise PdfError(f"expected string at {self.pos}")
        self.pos += 1
        out = bytearray()
        depth = 1
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            self.pos += 1
            if c == 0x5C:  # backslash
                if self.pos >= n:
                    break
                e = data[self.pos]
                self.pos += 1
                if e in b"nrtbf":
                    out.append({0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12}[e])
                elif e in b"()\\":
                    out.append(e)
                elif e in b"01234567":  # octal, up to 3 digits
                    digits = [e]
                    while (
                        len(digits) < 3
                        and self.pos < n
                        and data[self.pos] in b"01234567"
                    ):
                        digits.append(data[self.pos])
                        self.pos += 1
                    out.append(int(bytes(digits), 8) & 0xFF)
                elif e in b"\r\n":  # line continuation
                    if e == 0x0D and self.pos < n and data[self.pos] == 0x0A:
                        self.pos += 1
                else:
                    out.append(e)
            elif c == 0x28:
                depth += 1
                out.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    return bytes(out)
                out.append(c)
            else:
                out.append(c)
        raise PdfError("unterminated string")

    def parse_hex_string(self) -> bytes:
        if self.data[self.pos] != 0x3C:
            raise PdfError(f"expected hex string at {self.pos}")
        self.pos += 1
        hex_digits = bytearray()
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            self.pos += 1
            if c == 0x3E:  # >
                break
            if c in b"0123456789abcdefABCDEF":
                hex_digits.append(c)
        if len(hex_digits) % 2:
            hex_digits.append(0x30)
        return bytes.fromhex(hex_digits.decode("ascii"))

    def parse_array(self) -> list:
        if self.data[self.pos] != 0x5B:
            raise PdfError(f"expected array at {self.pos}")
        self.pos += 1
        items = []
        while True:
            self.skip_ws()
            if self.peek() == 0x5D:
                self.pos += 1
                return items
            items.append(self.parse_object())

    def parse_dict(self) -> dict:
        if self.data[self.pos : self.pos + 2] != b"<<":
            raise PdfError(f"expected dict at {self.pos}")
        self.pos += 2
        d = {}
        while True:
            self.skip_ws()
            if self.data[self.pos : self.pos + 2] == b">>":
                self.pos += 2
                return d
            key = self.parse_name()
            d[key.value] = self.parse_object()

    def parse_number_or_ref(self):
        start = self.pos
        num = self._parse_number()
        if isinstance(num, int) and num >= 0:
            save = self.pos
            self.skip_ws()
            gen_start = self.pos
            data, n = self.data, len(self.data)
            while self.pos < n and data[self.pos] in b"0123456789":
                self.pos += 1
            if self.pos > gen_start:
                gen = int(data[gen_start : self.pos])
                if self.try_keyword(b"R"):
                    return Ref(num, gen)
            self.pos = save
        return num

    def _parse_number(self):
        data, n = self.data, len(self.data)
        start = self.pos
        if data[self.pos] in b"+-":
            self.pos += 1
        is_float = False
        while self.pos < n and data[self.pos] in b"0123456789.":
            if data[self.pos] == 0x2E:
                is_float = True
            self.pos += 1
        text = data[start : self.pos].decode("ascii")
        try:
            if is_float:
                # PDF allows "4." and ".5"; "1.2.3" or "." are malformed
                return float(text)
            if text in ("+", "-", ""):
                raise ValueError(text)
            return int(text)
        except ValueError as e:
            raise PdfError(f"bad number {text!r} at {start}") from e

    def _maybe_stream(self, d: dict):
        save = self.pos
        self.skip_ws()
        if self.data[self.pos : self.pos + 6] != b"stream":
            self.pos = save
            return d
        self.pos += 6
        # EOL after "stream": CRLF or LF
        if self.data[self.pos : self.pos + 2] == b"\r\n":
            self.pos += 2
        elif self.data[self.pos : self.pos + 1] in (b"\n", b"\r"):
            self.pos += 1
        length = d.get("Length")
        if isinstance(length, int):
            raw = self.data[self.pos : self.pos + length]
            end = self.pos + length
            # validate: endstream should follow (possibly after EOL)
            probe = self.data[end : end + 20]
            if b"endstream" not in probe:
                raw, end = self._scan_endstream()
            else:
                self.pos = end
                self.try_keyword(b"endstream")
        else:
            # Length is an indirect ref we cannot resolve here; scan
            raw, end = self._scan_endstream()
        return Stream(dict=d, raw=raw)

    def _scan_endstream(self):
        idx = self.data.find(b"endstream", self.pos)
        if idx < 0:
            raise PdfError("unterminated stream")
        raw = self.data[self.pos : idx]
        # strip at most one trailing EOL added before "endstream"
        if raw.endswith(b"\r\n"):
            raw = raw[:-2]
        elif raw.endswith(b"\n") or raw.endswith(b"\r"):
            raw = raw[:-1]
        self.pos = idx + len(b"endstream")
        return raw, self.pos
