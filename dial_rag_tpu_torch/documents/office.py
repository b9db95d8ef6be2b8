"""First-party Office text extraction (OOXML and OpenDocument).

The reference can only handle office formats by shelling out to a
LibreOffice binary to produce a PDF (reference converter.py:29-55).
Modern office files are zip archives of XML, so this module extracts
chunkable elements directly — no external binary:

- DOCX (``word/document.xml``): paragraphs with Heading/Title styles
  marked as titles; tables flattened row-wise like the HTML parser.
- PPTX (``ppt/slides/slideN.xml``): one page per slide; title
  placeholders marked as titles.
- ODT / ODP (``content.xml``): ``text:h`` headings and ``text:p``
  paragraphs; presentation pages map to page numbers.

Legacy binary formats (.doc, .ppt) still require the LibreOffice
conversion path. When LibreOffice IS present, office files are
converted to PDF instead so that page-image retrieval works; this
parser is the fallback that keeps text retrieval working on minimal
images (and a direct path for text-only configs).
"""

import io
import re
import struct
import zipfile
import zlib
from xml.etree import ElementTree

from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.text.chunker import Element

_NS_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_NS_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_NS_P = "{http://schemas.openxmlformats.org/presentationml/2006/main}"
_NS_TEXT = "{urn:oasis:names:tc:opendocument:xmlns:text:1.0}"
_NS_DRAW = "{urn:oasis:names:tc:opendocument:xmlns:drawing:1.0}"
_NS_PRES = "{urn:oasis:names:tc:opendocument:xmlns:presentation:1.0}"

MIME_DOCX = (
    "application/vnd.openxmlformats-officedocument"
    ".wordprocessingml.document"
)
MIME_PPTX = (
    "application/vnd.openxmlformats-officedocument"
    ".presentationml.presentation"
)
MIME_ODT = "application/vnd.oasis.opendocument.text"
MIME_ODP = "application/vnd.oasis.opendocument.presentation"
MIME_XLSX = (
    "application/vnd.openxmlformats-officedocument"
    ".spreadsheetml.sheet"
)

NATIVE_OFFICE_MIMES = {MIME_DOCX, MIME_PPTX, MIME_ODT, MIME_ODP, MIME_XLSX}


def _open_zip(data: bytes) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(io.BytesIO(data))
    except zipfile.BadZipFile as e:
        raise InvalidDocumentError(
            "The office document is not a valid archive."
        ) from e


def _read_xml(zf: zipfile.ZipFile, name: str) -> ElementTree.Element:
    try:
        payload = zf.read(name)
    except KeyError as e:
        raise InvalidDocumentError(
            f"The office document is missing its content part ({name})."
        ) from e
    try:
        return ElementTree.fromstring(payload)
    except ElementTree.ParseError as e:
        raise InvalidDocumentError(
            "The office document content is not well-formed XML."
        ) from e


# --- DOCX -----------------------------------------------------------------


def _docx_paragraph_text(p) -> str:
    parts = []
    for node in p.iter():
        if node.tag == _NS_W + "t":
            parts.append(node.text or "")
        elif node.tag == _NS_W + "tab":
            parts.append("\t")
        elif node.tag in (_NS_W + "br", _NS_W + "cr"):
            parts.append("\n")
    return "".join(parts).strip()


def _docx_is_heading(p) -> bool:
    style = p.find(f"{_NS_W}pPr/{_NS_W}pStyle")
    if style is None:
        return False
    val = style.get(_NS_W + "val", "")
    return bool(re.match(r"(?i)heading\d*$|title$|subtitle$", val))


def docx_elements(data: bytes, mime: str = MIME_DOCX) -> list[Element]:
    with _open_zip(data) as zf:
        root = _read_xml(zf, "word/document.xml")
    body = root.find(_NS_W + "body")
    if body is None:
        return []
    elements = []
    for child in body:
        if child.tag == _NS_W + "p":
            text = _docx_paragraph_text(child)
            if text:
                elements.append(
                    Element(
                        text=text,
                        is_title=_docx_is_heading(child),
                        metadata={"filetype": mime},
                    )
                )
        elif child.tag == _NS_W + "tbl":
            for row in child.iter(_NS_W + "tr"):
                cells = []
                for cell in row.iter(_NS_W + "tc"):
                    cell_text = " ".join(
                        t
                        for p in cell.iter(_NS_W + "p")
                        if (t := _docx_paragraph_text(p))
                    )
                    if cell_text:
                        cells.append(cell_text)
                if cells:
                    elements.append(
                        Element(
                            text=" | ".join(cells),
                            metadata={"filetype": mime},
                        )
                    )
    return elements


# --- PPTX -----------------------------------------------------------------


def _pptx_slide_names(zf: zipfile.ZipFile) -> list[str]:
    pattern = re.compile(r"ppt/slides/slide(\d+)\.xml$")
    found = []
    for name in zf.namelist():
        m = pattern.match(name)
        if m:
            found.append((int(m.group(1)), name))
    return [name for _, name in sorted(found)]


def pptx_elements(data: bytes, mime: str = MIME_PPTX) -> list[Element]:
    elements = []
    with _open_zip(data) as zf:
        slides = _pptx_slide_names(zf)
        if not slides:
            raise InvalidDocumentError(
                "The presentation contains no slides."
            )
        for page_number, name in enumerate(slides, start=1):
            root = _read_xml(zf, name)
            for shape in root.iter(_NS_P + "sp"):
                ph = shape.find(
                    f"{_NS_P}nvSpPr/{_NS_P}nvPr/{_NS_P}ph"
                )
                is_title = ph is not None and ph.get("type", "") in (
                    "title",
                    "ctrTitle",
                )
                for para in shape.iter(_NS_A + "p"):
                    text = "".join(
                        t.text or "" for t in para.iter(_NS_A + "t")
                    ).strip()
                    if text:
                        elements.append(
                            Element(
                                text=text,
                                is_title=is_title,
                                page_number=page_number,
                                metadata={"filetype": mime},
                            )
                        )
    return elements


# --- ODF (ODT / ODP) ------------------------------------------------------


def _odf_text(node) -> str:
    # ODF inlines tabs/line-breaks as elements; itertext covers spans
    return "".join(node.itertext()).strip()


def odt_elements(data: bytes, mime: str = MIME_ODT) -> list[Element]:
    with _open_zip(data) as zf:
        root = _read_xml(zf, "content.xml")
    elements = []
    for node in root.iter():
        if node.tag == _NS_TEXT + "h":
            text = _odf_text(node)
            if text:
                elements.append(
                    Element(
                        text=text, is_title=True, metadata={"filetype": mime}
                    )
                )
        elif node.tag == _NS_TEXT + "p":
            text = _odf_text(node)
            if text:
                elements.append(
                    Element(text=text, metadata={"filetype": mime})
                )
    return elements


def odp_elements(data: bytes, mime: str = MIME_ODP) -> list[Element]:
    with _open_zip(data) as zf:
        root = _read_xml(zf, "content.xml")
    elements = []
    page_number = 0
    for page in root.iter(_NS_DRAW + "page"):
        page_number += 1
        for frame in page.iter(_NS_DRAW + "frame"):
            is_title = frame.get(_NS_PRES + "class", "") == "title"
            for p in frame.iter(_NS_TEXT + "p"):
                text = _odf_text(p)
                if text:
                    elements.append(
                        Element(
                            text=text,
                            is_title=is_title,
                            page_number=page_number,
                            metadata={"filetype": mime},
                        )
                    )
    if not elements and page_number == 0:
        raise InvalidDocumentError(
            "The presentation contains no slides."
        )
    return elements


# --- XLSX -----------------------------------------------------------------

_NS_S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_NS_REL = (
    "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
)


def _xlsx_shared_strings(zf: zipfile.ZipFile) -> list[str]:
    if "xl/sharedStrings.xml" not in zf.namelist():
        return []
    root = _read_xml(zf, "xl/sharedStrings.xml")
    strings = []
    for si in root.iter(_NS_S + "si"):
        strings.append("".join(t.text or "" for t in si.iter(_NS_S + "t")))
    return strings


def _xlsx_sheets(zf: zipfile.ZipFile) -> list[tuple[str, str]]:
    """(sheet display name, zip path) in workbook order."""
    wb = _read_xml(zf, "xl/workbook.xml")
    rels = {}
    if "xl/_rels/workbook.xml.rels" in zf.namelist():
        rel_root = _read_xml(zf, "xl/_rels/workbook.xml.rels")
        pkg = "{http://schemas.openxmlformats.org/package/2006/relationships}"
        for rel in rel_root.iter(pkg + "Relationship"):
            target = rel.get("Target", "")
            if target.startswith("/"):
                # package-absolute target (valid per OPC): resolve from
                # the package root, not relative to xl/
                rels[rel.get("Id")] = target.lstrip("/")
            else:
                rels[rel.get("Id")] = "xl/" + target
    sheets = []
    for sh in wb.iter(_NS_S + "sheet"):
        rid = sh.get(_NS_REL + "id")
        path = rels.get(rid)
        if path is None:  # fall back to conventional naming
            path = f"xl/worksheets/sheet{len(sheets) + 1}.xml"
        sheets.append((sh.get("name", f"Sheet{len(sheets) + 1}"), path))
    return sheets


def _xlsx_cell_value(cell, shared: list[str]) -> str:
    kind = cell.get("t", "n")
    if kind == "inlineStr":
        is_node = cell.find(_NS_S + "is")
        if is_node is not None:
            return "".join(
                t.text or "" for t in is_node.iter(_NS_S + "t")
            )
        return ""
    v = cell.find(_NS_S + "v")
    if v is None or v.text is None:
        return ""
    if kind == "s":
        try:
            return shared[int(v.text)]
        except (ValueError, IndexError):
            return ""
    return v.text


def xlsx_elements(data: bytes, mime: str = MIME_XLSX) -> list[Element]:
    """One element per row (like the CSV parser), sheet names as titles."""
    elements = []
    with _open_zip(data) as zf:
        shared = _xlsx_shared_strings(zf)
        sheets = _xlsx_sheets(zf)
        if not sheets:
            raise InvalidDocumentError(
                "The spreadsheet contains no sheets."
            )
        for sheet_name, path in sheets:
            if path not in zf.namelist():
                continue
            root = _read_xml(zf, path)
            elements.append(
                Element(
                    text=sheet_name,
                    is_title=True,
                    metadata={"filetype": mime},
                )
            )
            for row in root.iter(_NS_S + "row"):
                cells = [
                    v
                    for c in row.iter(_NS_S + "c")
                    if (v := _xlsx_cell_value(c, shared).strip())
                ]
                if cells:
                    elements.append(
                        Element(
                            text=" | ".join(cells),
                            metadata={"filetype": mime},
                        )
                    )
    return elements


_PARSERS = {
    MIME_DOCX: docx_elements,
    MIME_PPTX: pptx_elements,
    MIME_ODT: odt_elements,
    MIME_ODP: odp_elements,
    MIME_XLSX: xlsx_elements,
}


def office_elements(data: bytes, mime: str) -> list[Element]:
    parser = _PARSERS.get(mime)
    if parser is None:
        raise InvalidDocumentError(
            "This office format requires LibreOffice conversion, which is "
            "not available. Please convert the document to PDF."
        )
    try:
        return parser(data, mime)
    except (
        zipfile.BadZipFile,
        zlib.error,
        NotImplementedError,  # unsupported zip features in corrupt archives
        EOFError,
        OSError,
        UnicodeDecodeError,
        struct.error,
        ValueError,  # zipfile seeks/int parses on corrupt central dirs
        IndexError,
        KeyError,
        RuntimeError,  # zipfile 'encrypted, password required'
        ElementTree.ParseError,  # SyntaxError subclass — not a ValueError
    ) as e:
        # corrupt archives surface mid-read (CRC, deflate, overlap checks);
        # they are bad user input, not internal errors
        raise InvalidDocumentError(
            f"The office document is corrupt: {type(e).__name__}"
        ) from e
