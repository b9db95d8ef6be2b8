"""Writes the image fixtures of ``tests/data/images/`` with PIL's decode of
each (``decoded.npz``: ``Image.open(...).convert("RGB")``, a GIF's frame
``n`` under ``<file>@<n>``), and the JAX package's HTML elements of the
documents ``tests/utils/html_docs.py`` builds from the corpus's chunks,
with the digest of its elements of each page ``tests/utils/html_pages.py``
generates (``tests/data/html/oracle.json``), so that a machine without
PIL, bs4 and lxml (the card's, in chip_smoke.py) can hold the port's
decoders and HTML parser against them.

PIL writes the progressive JPEGs, the 1-bit BMP and one animated GIF;
``tests/utils/image_encoders.py`` writes what PIL cannot: Adam7 PNGs,
4- and 16-bit and RLE BMPs (OS/2 headers too) and a GIF with every
disposal method, local palettes, transparency and interlace. Run from
the repository root: ``python -m tests.utils.make_image_fixtures``.
"""

import dataclasses
import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

from tests.utils import image_encoders as enc
from tests.utils.html_docs import build_html_documents
from tests.utils.make_jpeg_fixtures import photo

DATA = Path(__file__).resolve().parents[1] / "data"
IMAGES = DATA / "images"
HTML_ORACLE = DATA / "html" / "oracle.json"
ORACLE_CHUNKS = DATA / "alps_oracle_chunks.json"

# name: (height, width, mode, save options) of the progressive JPEGs PIL writes
PROGRESSIVE = {
    "progressive_420_q80.jpg": (120, 160, "RGB", {"quality": 80, "subsampling": 2}),
    "progressive_444_restart.jpg": (61, 93, "RGB", {"quality": 90, "subsampling": 0, "restart_marker_blocks": 3}),
    "progressive_422_q85.jpg": (288, 384, "RGB", {"quality": 85, "subsampling": 1}),
    "progressive_gray.jpg": (45, 60, "L", {"quality": 70}),
    "progressive_cmyk.jpg": (45, 60, "CMYK", {"quality": 85}),
}


def _pil_bytes(image: Image.Image, fmt: str, **options) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format=fmt, **options)
    return buf.getvalue()


def image_fixtures() -> dict[str, bytes]:
    """File name -> bytes of every image fixture, from fixed seeds."""
    rng = np.random.default_rng(26)
    out = {}
    for seed, (name, (h, w, mode, options)) in enumerate(sorted(PROGRESSIVE.items())):
        out[name] = _pil_bytes(Image.fromarray(photo(h, w, 40 + seed)).convert(mode), "JPEG", progressive=True,
                               optimize=True, **options)
    base = photo(53, 71, 50)
    out["adam7_rgb.png"] = enc.png(base, 8, 2)
    out["adam7_rgba16.png"] = enc.png(rng.integers(0, 65536, (29, 37, 4)), 16, 6)
    out["adam7_gray2.png"] = enc.png(rng.integers(0, 4, (23, 31)), 2, 0)
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    out["adam7_palette4.png"] = enc.png(rng.integers(0, 16, (41, 19)), 4, 3, palette.tobytes())
    out["bmp1_pil.bmp"] = _pil_bytes(Image.fromarray(base[..., 0]).convert("1"), "BMP")
    indexes16 = np.repeat(rng.integers(0, 16, (37, 18)), 3, axis=1)[:, :53]
    out["bmp4.bmp"] = enc.bmp(indexes16, 4, palette)
    out["bmp4_os2.bmp"] = enc.bmp(indexes16, 4, palette, os2=True)
    out["bmp8_os2.bmp"] = enc.bmp(indexes16 * 15, 8, rng.integers(0, 256, (256, 3)).astype(np.uint8), os2=True)
    out["bmp16_555.bmp"] = enc.bmp(base, 16)
    out["bmp16_565_bitfields.bmp"] = enc.bmp(base, 16, masks16=(0xF800, 0x7E0, 0x1F), bitfields=True, top_down=True)
    out["bmp_rle8.bmp"] = enc.bmp(indexes16 * 15, 8, rng.integers(0, 256, (256, 3)).astype(np.uint8), rle=True,
                                  rng=rng)
    out["bmp_rle4.bmp"] = enc.bmp(indexes16, 4, palette, rle=True, rng=rng)
    out["frames.gif"] = _frames_gif(rng)
    frames = [Image.fromarray(photo(48, 64, 60 + k)).quantize(64) for k in range(4)]
    out["pil_animated.gif"] = _pil_bytes(frames[0], "GIF", save_all=True, append_images=frames[1:],
                                         disposal=[0, 1, 2, 3], duration=100, optimize=True)
    return out


def _frames_gif(rng) -> bytes:
    """A 96 x 72 GIF of 6 frames: a full first frame, then patches with
    each disposal method, a local palette, transparency and interlace."""
    w, h = 96, 72
    glob = rng.integers(0, 256, (32, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    frames = [{"indexes": ((x // 6 + y // 6) % 32), "disposal": 1}]
    for k in range(5):
        fw, fh = int(rng.integers(16, 48)), int(rng.integers(12, 40))
        at = (int(rng.integers(0, w - fw)), int(rng.integers(0, h - fh)))
        local = rng.integers(0, 256, (16, 3)).astype(np.uint8) if k % 2 else None
        n = 16 if local is not None else 32
        frame = {"indexes": rng.integers(0, n, (fh, fw)), "at": at, "disposal": [2, 3, 0, 1, 2][k],
                 "palette": local, "interlace": k in (1, 4)}
        if k != 3:
            frame["transparency"] = int(rng.integers(0, n))
        frames.append(frame)
    return enc.gif((w, h), frames, glob, background=3)


def pil_pages(data: bytes) -> list[np.ndarray]:
    """Each frame as the JAX package's page images read it."""
    with Image.open(io.BytesIO(data)) as im:
        pages = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            pages.append(np.asarray(im.convert("RGB")))
        return pages


GENERATED_PAGES = 240  # tests/utils/html_pages.py's seeds 0-239


def elements_digest(elements) -> str:
    """sha256 of a list of elements as JSON (sorted keys, no ASCII escapes)."""
    rows = [dataclasses.asdict(e) for e in elements]
    return hashlib.sha256(json.dumps(rows, sort_keys=True, ensure_ascii=False).encode()).hexdigest()


def html_oracle() -> dict:
    """The JAX package's elements of each HTML document, with its sha256,
    and the digest of its elements of each generated malformed page."""
    import bs4.dammit

    from dial_rag_tpu.documents.elements import html_elements
    from tests.utils.html_pages import page

    guesser = bs4.dammit._chardet_dammit
    bs4.dammit._chardet_dammit = lambda markup: None  # no guesser, as on the card's machine
    try:
        texts = [c["text"] for c in json.loads(ORACLE_CHUNKS.read_text())]
        out = {}
        for name, data in build_html_documents(texts):
            out[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                         "elements": [dataclasses.asdict(e) for e in html_elements(data)]}
        out["generated"] = [elements_digest(html_elements(page(seed))) for seed in range(GENERATED_PAGES)]
        return out
    finally:
        bs4.dammit._chardet_dammit = guesser


def main() -> None:
    IMAGES.mkdir(parents=True, exist_ok=True)
    decoded = {}
    for name, data in sorted(image_fixtures().items()):
        (IMAGES / name).write_bytes(data)
        for i, page in enumerate(pil_pages(data), start=1):
            decoded[f"{name}@{i}"] = page
    np.savez_compressed(IMAGES / "decoded.npz", **decoded)
    HTML_ORACLE.parent.mkdir(parents=True, exist_ok=True)
    HTML_ORACLE.write_text(json.dumps(html_oracle(), indent=1, ensure_ascii=False) + "\n")


if __name__ == "__main__":
    main()
