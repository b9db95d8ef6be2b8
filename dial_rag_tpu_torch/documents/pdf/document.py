"""PDF document structure: xref (tables + streams), object store, page tree.

Robustness strategy mirrors production parsers: honor the xref chain when
valid, but fall back to a full scan of ``N G obj`` markers for damaged
files (pdfminer does the same)."""

import re

from dial_rag_tpu_torch.documents.pdf.filters import decode_stream
from dial_rag_tpu_torch.documents.pdf.objects import (
    Lexer,
    Name,
    PdfError,
    Ref,
    Stream,
)

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")

# Page-tree attributes inherited from ancestors (ISO 32000 7.7.3.4)
_INHERITABLE = ("Resources", "MediaBox", "CropBox", "Rotate")


class PdfDocument:
    def __init__(self, data: bytes):
        if not data.lstrip()[:5].startswith(b"%PDF-"):
            raise PdfError("not a PDF document")
        self.data = data
        self._offsets: dict[int, int] = {}  # obj num -> byte offset
        self._compressed: dict[int, tuple[int, int]] = {}  # num -> (stm, idx)
        self._cache: dict[int, object] = {}
        self._objstm_cache: dict[int, list] = {}
        self.trailer: dict = {}
        try:
            self._parse_xref_chain()
        except PdfError:
            self._offsets.clear()
            self._compressed.clear()
        if not self._offsets or "Root" not in self.trailer:
            self._scan_all_objects()
        if "Root" not in self.trailer:
            raise PdfError("no document catalog")
        if "Encrypt" in self.trailer:
            raise PdfError("encrypted PDF documents are not supported")

    # -- xref --------------------------------------------------------------

    def _parse_xref_chain(self):
        tail = self.data[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m is None:
            raise PdfError("startxref not found")
        offset = int(m.group(1))
        seen = set()
        while offset and offset not in seen:
            seen.add(offset)
            offset = self._parse_xref_section(offset)

    def _parse_xref_section(self, offset: int) -> int | None:
        lex = Lexer(self.data, offset)
        lex.skip_ws()
        if lex.try_keyword(b"xref"):
            return self._parse_xref_table(lex)
        # xref stream: "N G obj << ... >> stream"
        obj = self._parse_indirect_at(offset)
        if not isinstance(obj, Stream):
            raise PdfError("bad xref section")
        return self._parse_xref_stream(obj)

    def _parse_xref_table(self, lex: Lexer) -> int | None:
        while True:
            lex.skip_ws()
            if lex.try_keyword(b"trailer"):
                break
            start = lex.parse_object()
            count = lex.parse_object()
            if not isinstance(start, int) or not isinstance(count, int):
                raise PdfError("bad xref subsection header")
            lex.skip_ws()
            for i in range(count):
                entry = self.data[lex.pos : lex.pos + 20]
                fields = entry.split()
                if len(fields) < 3:
                    raise PdfError("bad xref entry")
                off, _gen, kind = fields[0], fields[1], fields[2]
                num = start + i
                if kind == b"n" and num not in self._offsets:
                    try:
                        self._offsets[num] = int(off)
                    except ValueError as e:
                        raise PdfError(f"bad xref offset {off!r}") from e
                # advance: entries are 20 bytes but tolerate 19/18
                nl = entry.find(b"\n")
                lex.pos += 20 if nl in (-1, 19) else nl + 1
        lex.skip_ws()
        trailer = lex.parse_dict()
        for k, v in trailer.items():
            self.trailer.setdefault(k, v)
        if "XRefStm" in trailer:  # hybrid files
            try:
                self._parse_xref_section(trailer["XRefStm"])
            except PdfError:
                pass
        prev = trailer.get("Prev")
        return int(prev) if isinstance(prev, (int, float)) else None

    def _parse_xref_stream(self, stream: Stream) -> int | None:
        d = stream.dict
        for k, v in d.items():
            if k not in ("Length", "Filter", "DecodeParms", "W", "Index", "Type"):
                self.trailer.setdefault(k, v)
        data = decode_stream(stream, resolve=self.resolve)
        try:
            w = [int(self.resolve(x)) for x in d["W"]]
            size = int(self.resolve(d["Size"]))
            index = d.get("Index", [0, size])
            index = [int(self.resolve(x)) for x in index]
        except (KeyError, TypeError, ValueError) as e:
            raise PdfError(f"malformed xref stream dict: {e!r}") from e
        row_len = sum(w)
        pos = 0

        def read_field(row, start, width, default):
            if width == 0:
                return default
            return int.from_bytes(row[start : start + width], "big")

        for i in range(0, len(index), 2):
            start, count = index[i], index[i + 1]
            for num in range(start, start + count):
                row = data[pos : pos + row_len]
                pos += row_len
                if len(row) < row_len:
                    break
                ftype = read_field(row, 0, w[0], 1)
                f2 = read_field(row, w[0], w[1], 0)
                f3 = read_field(row, w[0] + w[1], w[2], 0)
                if ftype == 1 and num not in self._offsets:
                    self._offsets[num] = f2
                elif ftype == 2 and num not in self._compressed:
                    self._compressed[num] = (f2, f3)
        prev = d.get("Prev")
        return int(self.resolve(prev)) if prev is not None else None

    def _scan_all_objects(self):
        """Damaged-file fallback: index every `N G obj` in the file."""
        for m in _OBJ_RE.finditer(self.data):
            num = int(m.group(1))
            self._offsets[num] = m.start()  # later wins (incremental updates)
        if "Root" not in self.trailer:
            # find a catalog object
            for num in list(self._offsets):
                try:
                    obj = self.get_object(num)
                except PdfError:
                    continue
                d = obj.dict if isinstance(obj, Stream) else obj
                if isinstance(d, dict):
                    t = d.get("Type")
                    if isinstance(t, Name) and t.value == "Catalog":
                        self.trailer["Root"] = Ref(num, 0)
                    if isinstance(t, Name) and t.value == "XRef":
                        for k, v in d.items():
                            if k not in ("Type", "W", "Index", "Filter",
                                         "Length", "DecodeParms"):
                                self.trailer.setdefault(k, v)

    # -- object access -----------------------------------------------------

    def _parse_indirect_at(self, offset: int):
        lex = Lexer(self.data, offset)
        lex.skip_ws()
        m = _OBJ_RE.match(self.data, lex.pos)
        if not m:
            raise PdfError(f"no object at offset {offset}")
        lex.pos = m.end()
        obj = lex.parse_object()
        if isinstance(obj, Stream) and not isinstance(
            obj.dict.get("Length"), int
        ):
            # re-read with resolved Length for exactness
            length = self.resolve(obj.dict.get("Length"))
            if isinstance(length, int):
                obj.dict["Length"] = length
        return obj

    def get_object(self, num: int):
        if num in self._cache:
            return self._cache[num]
        if num in self._offsets:
            obj = self._parse_indirect_at(self._offsets[num])
        elif num in self._compressed:
            obj = self._get_from_object_stream(*self._compressed[num], num)
        else:
            obj = None
        self._cache[num] = obj
        return obj

    def _get_from_object_stream(self, stm_num: int, idx: int, num: int):
        entries = self._objstm_cache.get(stm_num)
        if entries is None:
            stm = self.get_object(stm_num)
            if not isinstance(stm, Stream):
                raise PdfError(f"object stream {stm_num} missing")
            data = decode_stream(stm, resolve=self.resolve)
            try:
                n = int(self.resolve(stm.dict["N"]))
                first = int(self.resolve(stm.dict["First"]))
            except (KeyError, TypeError, ValueError) as e:
                raise PdfError(
                    f"malformed object stream {stm_num}: {e!r}"
                ) from e
            head = Lexer(data, 0)
            pairs = []
            for _ in range(n):
                head.skip_ws()
                onum = head.parse_object()
                ooff = head.parse_object()
                try:
                    pairs.append((int(onum), int(ooff)))
                except (TypeError, ValueError) as e:
                    raise PdfError(
                        f"malformed object stream header: {e!r}"
                    ) from e
            entries = []
            for onum, ooff in pairs:
                body = Lexer(data, first + ooff)
                entries.append((onum, body.parse_object()))
            self._objstm_cache[stm_num] = entries
        if idx < len(entries) and entries[idx][0] == num:
            return entries[idx][1]
        for onum, obj in entries:
            if onum == num:
                return obj
        return None

    def resolve(self, obj, depth: int = 0):
        while isinstance(obj, Ref):
            if depth > 32:
                raise PdfError("reference cycle")
            obj = self.get_object(obj.num)
            depth += 1
        return obj

    # -- pages ---------------------------------------------------------------

    @property
    def catalog(self) -> dict:
        root = self.resolve(self.trailer["Root"])
        if not isinstance(root, dict):
            raise PdfError("bad catalog")
        return root

    def pages(self) -> list[dict]:
        """Flattened page dicts with inherited attributes materialized."""
        pages_root = self.resolve(self.catalog.get("Pages"))
        if not isinstance(pages_root, dict):
            raise PdfError("no page tree")
        out: list[dict] = []
        seen: set[int] = set()

        def walk(node: dict, inherited: dict):
            inh = dict(inherited)
            for key in _INHERITABLE:
                if key in node:
                    inh[key] = node[key]
            t = node.get("Type")
            tname = t.value if isinstance(t, Name) else None
            kids = node.get("Kids")
            if tname == "Page" or (kids is None and tname != "Pages"):
                page = dict(node)
                for key, val in inh.items():
                    page.setdefault(key, val)
                out.append(page)
                return
            for kid in self.resolve(kids) or []:
                if isinstance(kid, Ref):
                    if kid.num in seen:
                        continue
                    seen.add(kid.num)
                kid = self.resolve(kid)
                if isinstance(kid, dict):
                    walk(kid, inh)

        walk(pages_root, {})
        return out

    def page_content(self, page: dict) -> bytes:
        """Concatenated decoded content streams of a page."""
        contents = self.resolve(page.get("Contents"))
        if contents is None:
            return b""
        if isinstance(contents, Stream):
            streams = [contents]
        else:
            streams = [self.resolve(s) for s in contents]
        parts = []
        for s in streams:
            if isinstance(s, Stream):
                parts.append(decode_stream(s, resolve=self.resolve))
        return b"\n".join(parts)

    @property
    def num_pages(self) -> int:
        return len(self.pages())
