"""PDFs that carry image XObjects beside text, for the page-render tests
and the card's smoke run (standard library and numpy only: chip_smoke.py
loads this file by path on a machine without PIL).

``build_image_pdf(pages)``: each page is ``(lines, images)``; ``lines``
are ``(x, y, font_size, text)`` as ``documents/pdf/writer.py``'s
``build_pdf`` takes them (Helvetica, WinAnsi), ``images`` are
``(x, y, width, height, image)`` in points, the image placed by the CTM
``[width 0 0 height x y]``. ``image`` is either an ``[H, W, C]`` uint8
array (C 1, 3 or 4: DeviceGray, DeviceRGB, DeviceCMYK), written
Flate-compressed, or ``("dct", jpeg_bytes, W, H, C)``, written as is with
``/DCTDecode``, or ``("jpx", jpeg2000_bytes, W, H, C)`` with
``/JPXDecode`` (C 0 writes no /ColorSpace, as a JPX image may leave it
out); an optional sixth element holds more dictionary entries (bytes,
such as ``/Decode [1 0] /SMaskInData 1``).
"""

import zlib

import numpy as np

_SPACES = {1: b"/DeviceGray", 3: b"/DeviceRGB", 4: b"/DeviceCMYK"}


def _escape(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def _image_object(image) -> bytes:
    extra = b""
    if isinstance(image, tuple):
        kind, data, w, h, c = image[:5]
        extra = image[5] if len(image) > 5 else b""
        filt = b"/DCTDecode" if kind == "dct" else b"/JPXDecode"
    else:
        image = np.asarray(image, dtype=np.uint8)
        if image.ndim == 2:
            image = image[:, :, None]
        h, w, c = image.shape
        data = zlib.compress(image.tobytes())
        filt = b"/FlateDecode"
    space = b"/ColorSpace %s " % _SPACES[c] if c else b""
    return (
        b"<< /Type /XObject /Subtype /Image /Width %d /Height %d %s"
        b"/BitsPerComponent 8 /Filter %s %s/Length %d >>\nstream\n" % (w, h, space, filt, extra, len(data))
        + data + b"\nendstream"
    )


def build_image_pdf(pages: list) -> bytes:
    objects: dict[int, bytes] = {}
    next_id = 4  # 1 catalog, 2 pages, 3 font
    page_ids = []
    for lines, images in pages:
        names = []
        for image in images:
            objects[next_id] = _image_object(image[4])
            names.append(next_id)
            next_id += 1
        ops = [
            f"q {w:g} 0 0 {h:g} {x:g} {y:g} cm /Im{k} Do Q"
            for k, (x, y, w, h, _) in enumerate(images)
        ]
        ops += [f"BT /F1 {size:g} Tf {x:g} {y:g} Td ({_escape(text)}) Tj ET" for x, y, size, text in lines]
        content = zlib.compress("\n".join(ops).encode("latin-1"))
        objects[next_id] = (b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(content)
                            + content + b"\nendstream")
        content_id = next_id
        next_id += 1
        xobjects = b" ".join(b"/Im%d %d 0 R" % (k, n) for k, n in enumerate(names))
        objects[next_id] = (
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
            b"/Resources << /Font << /F1 3 0 R >> /XObject << " + xobjects + b" >> >> "
            b"/Contents %d 0 R >>" % content_id
        )
        page_ids.append(next_id)
        next_id += 1
    objects[1] = b"<< /Type /Catalog /Pages 2 0 R >>"
    kids = b" ".join(b"%d 0 R" % p for p in page_ids)
    objects[2] = b"<< /Type /Pages /Kids [" + kids + b"] /Count %d >>" % len(page_ids)
    objects[3] = b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica /Encoding /WinAnsiEncoding >>"

    out = bytearray(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
    offsets = {}
    for num in sorted(objects):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num + objects[num] + b"\nendobj\n"
    xref = len(out)
    size = max(objects) + 1
    out += b"xref\n0 %d\n0000000000 65535 f \n" % size
    for num in range(1, size):
        out += b"%010d 00000 n \n" % offsets[num]
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (size, xref)
    return bytes(out)
