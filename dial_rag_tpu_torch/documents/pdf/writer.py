"""Tiny first-party PDF writer: generates valid single/multi-page text PDFs
with classic xref tables or xref+object streams, optionally Flate-compressed
content. Used by the eval harness to synthesize deterministic corpora and by
tests so they need no binary fixtures."""

import zlib


def _escape(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def build_pdf(
    pages: list[list[tuple[float, float, float, str]]],
    compress: bool = False,
    use_xref_stream: bool = False,
) -> bytes:
    """pages: per page, a list of (x, y, font_size, text) text lines."""
    objects: dict[int, bytes] = {}
    page_ids = []
    next_id = 4  # 1=catalog, 2=pages, 3=font
    content_ids = []

    for lines in pages:
        ops = []
        for x, y, size, text in lines:
            ops.append(
                f"BT /F1 {size:g} Tf {x:g} {y:g} Td ({_escape(text)}) Tj ET"
            )
        content = "\n".join(ops).encode("latin-1")
        extra = b""
        if compress:
            content = zlib.compress(content)
            extra = b" /Filter /FlateDecode"
        content_id = next_id
        next_id += 1
        objects[content_id] = (
            b"<< /Length " + str(len(content)).encode() + extra + b" >>\n"
            b"stream\n" + content + b"\nendstream"
        )
        content_ids.append(content_id)

    for content_id in content_ids:
        page_id = next_id
        next_id += 1
        objects[page_id] = (
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
            b"/Resources << /Font << /F1 3 0 R >> >> /Contents "
            + str(content_id).encode()
            + b" 0 R >>"
        )
        page_ids.append(page_id)

    objects[1] = b"<< /Type /Catalog /Pages 2 0 R >>"
    kids = b" ".join(b"%d 0 R" % p for p in page_ids)
    objects[2] = (
        b"<< /Type /Pages /Kids [" + kids + b"] /Count "
        + str(len(page_ids)).encode() + b" >>"
    )
    objects[3] = (
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
        b"/Encoding /WinAnsiEncoding >>"
    )

    if use_xref_stream:
        return _emit_xref_stream(objects, next_id)
    return _emit_classic(objects)


def _emit_classic(objects: dict[int, bytes]) -> bytes:
    out = bytearray(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
    offsets = {}
    for num in sorted(objects):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num + objects[num] + b"\nendobj\n"
    xref_pos = len(out)
    max_id = max(objects) + 1
    out += b"xref\n0 %d\n" % max_id
    out += b"0000000000 65535 f \n"
    for num in range(1, max_id):
        if num in offsets:
            out += b"%010d 00000 n \n" % offsets[num]
        else:
            out += b"0000000000 65535 f \n"
    out += (
        b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
        % (max_id, xref_pos)
    )
    return bytes(out)


def _emit_xref_stream(objects: dict[int, bytes], next_id: int) -> bytes:
    """Pack non-stream objects into an ObjStm, index via an xref stream."""
    out = bytearray(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
    offsets: dict[int, int] = {}
    compressed: dict[int, int] = {}  # num -> index in objstm

    stream_objs = {n: b for n, b in objects.items() if b"stream" in b[:200]}
    plain_objs = {n: b for n, b in objects.items() if n not in stream_objs}

    for num in sorted(stream_objs):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num + stream_objs[num] + b"\nendobj\n"

    # object stream
    objstm_id = next_id
    next_id += 1
    header_parts = []
    body = bytearray()
    for idx, num in enumerate(sorted(plain_objs)):
        header_parts.append(b"%d %d" % (num, len(body)))
        body += plain_objs[num] + b"\n"
        compressed[num] = idx
    header = b" ".join(header_parts) + b"\n"
    payload = zlib.compress(bytes(header + body))
    offsets[objstm_id] = len(out)
    out += (
        b"%d 0 obj\n<< /Type /ObjStm /N %d /First %d /Length %d "
        b"/Filter /FlateDecode >>\nstream\n"
        % (objstm_id, len(plain_objs), len(header), len(payload))
        + payload
        + b"\nendstream\nendobj\n"
    )

    # xref stream
    xref_id = next_id
    next_id += 1
    xref_pos = len(out)
    size = next_id
    rows = bytearray()
    for num in range(size):
        if num == 0:
            rows += bytes([0]) + (0).to_bytes(4, "big") + bytes([255])
        elif num in offsets:
            rows += bytes([1]) + offsets[num].to_bytes(4, "big") + bytes([0])
        elif num in compressed:
            rows += (
                bytes([2])
                + objstm_id.to_bytes(4, "big")
                + bytes([compressed[num]])
            )
        elif num == xref_id:
            rows += bytes([1]) + xref_pos.to_bytes(4, "big") + bytes([0])
        else:
            rows += bytes([0]) + (0).to_bytes(4, "big") + bytes([255])
    payload = zlib.compress(bytes(rows))
    out += (
        b"%d 0 obj\n<< /Type /XRef /Size %d /W [1 4 1] /Root 1 0 R "
        b"/Length %d /Filter /FlateDecode >>\nstream\n"
        % (xref_id, size, len(payload))
        + payload
        + b"\nendstream\nendobj\n"
    )
    out += b"startxref\n%d\n%%%%EOF\n" % xref_pos
    return bytes(out)
