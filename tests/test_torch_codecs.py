"""The port's image codecs and resampling without PIL, held against PIL on
the CPU (PIL is the JAX package's path: ``Image.open(...).convert("RGB")``
and ``Image.resize(..., Image.LANCZOS)``).

Tolerances, stated before any comparison:
- PNG (Adam7 too), BMP and GIF decode: equal (lossless formats; PIL's
  ``convert("RGB")`` semantics, alpha dropped, not composited);
- sequential and progressive JPEG decode (``native/jpeg.cpp``): at most
  JPEG_LEVELS per channel of PIL's libjpeg-turbo decode (islow IDCT,
  fancy upsampling);
- LANCZOS resampling: at most RESIZE_LEVELS of PIL's;
- Pillow's CMYK -> RGB: equal.
Inputs are made from seeds with numpy; PIL writes the files.
"""

import asyncio
import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dial_rag_tpu.image_processor.extract_pages import extract_number_of_pages as jax_number_of_pages
from dial_rag_tpu.image_processor.extract_pages import extract_pages as jax_extract_pages
from dial_rag_tpu.image_processor.resize import resize_image as jax_resize_image
from dial_rag_tpu_torch.documents.parser import extract_number_of_pages
from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.image_processor import image_as_base64, resize_image
from dial_rag_tpu_torch.image_processor.bmp import decode_bmp
from dial_rag_tpu_torch.image_processor.extract_pages import decode_image, extract_pages
from dial_rag_tpu_torch.image_processor.jpeg import cmyk_to_rgb, decode_jpeg, decode_jpeg_raw
from dial_rag_tpu_torch.image_processor.png import decode_png, encode_png
from dial_rag_tpu_torch.image_processor.resize import resize_lanczos
from tests.utils import image_encoders

JPEG_LEVELS = 2
RESIZE_LEVELS = 1


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def saved(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format=fmt, **kw)
    return buf.getvalue()


def photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth seeded test image with noise (what a camera or a chart gives)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 13.0), 128 + 90 * np.cos(x / 5.0 - y / 9.0),
                    (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def raw_png(samples: np.ndarray, depth: int, color: int, palette: bytes = b"") -> bytes:
    """A PNG written by hand (filter 0 on every row), for the modes PIL does not write."""
    h, w = samples.shape[:2]
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth < 8:
        per = 8 // depth
        flat = samples.reshape(h, -1).astype(np.uint8)
        pad = (-flat.shape[1]) % per
        flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = (flat << shifts).sum(axis=2).astype(np.uint8)
    else:
        rows = samples.reshape(h, -1).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag, payload):
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette:
        out += chunk(b"PLTE", palette)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# -- PNG -----------------------------------------------------------------------

BASE = photo(37, 53, seed=1)
PIL_MODES = {
    "RGB": lambda: Image.fromarray(BASE),
    "L": lambda: Image.fromarray(BASE[..., 0]),
    "LA": lambda: Image.fromarray(np.ascontiguousarray(BASE[..., :2]), "LA"),
    "RGBA": lambda: Image.fromarray(np.dstack([BASE, BASE[..., :1]]), "RGBA"),
    "P8": lambda: Image.fromarray(BASE).quantize(200),
    "P4": lambda: Image.fromarray(BASE).quantize(16),
    "P2": lambda: Image.fromarray(BASE).quantize(4),
    "P1": lambda: Image.fromarray(BASE).quantize(2),
    "1": lambda: Image.fromarray(BASE[..., 0]).convert("1"),
    "I16": lambda: Image.fromarray((BASE[..., 0].astype(np.uint16) * 3)).convert("I;16"),
}


@pytest.mark.parametrize("mode", sorted(PIL_MODES))
@pytest.mark.parametrize("optimize", [False, True])
def test_png_files_pil_wrote_decode_as_pil_reads_them(mode, optimize):
    data = saved(PIL_MODES[mode](), "PNG", optimize=optimize)
    assert np.array_equal(decode_png(data), pil_rgb(data))


RNG = np.random.default_rng(7)
RAW_MODES = {
    "gray2": (RNG.integers(0, 4, (13, 29)), 2, 0, b""),
    "gray4": (RNG.integers(0, 16, (13, 29)), 4, 0, b""),
    "gray16": (RNG.integers(0, 1024, (13, 29)), 16, 0, b""),
    "la16": (RNG.integers(0, 65536, (13, 29, 2)), 16, 4, b""),
    "rgb16": (RNG.integers(0, 65536, (13, 29, 3)), 16, 2, b""),
    "rgba16": (RNG.integers(0, 65536, (13, 29, 4)), 16, 6, b""),
    "palette_short": (RNG.integers(0, 5, (13, 29)), 8, 3, bytes(range(15))),
}


@pytest.mark.parametrize("mode", sorted(RAW_MODES))
def test_png_modes_pil_does_not_write(mode):
    samples, depth, color, palette = RAW_MODES[mode]
    data = raw_png(samples, depth, color, palette)
    assert np.array_equal(decode_png(data), pil_rgb(data))


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 3), (200, 150)])
def test_png_encode_round_trips_through_pil(shape):
    image = photo(*shape, seed=2)
    data = encode_png(image)
    assert np.array_equal(pil_rgb(data), image)
    assert np.array_equal(decode_png(data), image)
    assert np.array_equal(decode_png(base64.b64decode(image_as_base64(image))), image)


def test_png_interlaced_raises_item_9d():
    """Adam7 PNGs, once refused (ROADMAP item 9d), now decode as PIL reads
    them: RGB with every filter, and 2-bit gray (passes of a few pixels)."""
    data = saved(Image.fromarray(BASE), "PNG")
    interlaced = image_encoders.png(BASE, 8, 2)
    assert interlaced[28] == 1  # IHDR's interlace byte
    assert np.array_equal(decode_png(interlaced), pil_rgb(interlaced))
    assert np.array_equal(decode_png(interlaced), BASE)
    gray2 = image_encoders.png(RAW_MODES["gray2"][0], 2, 0)
    assert np.array_equal(decode_png(gray2), pil_rgb(gray2))
    assert np.array_equal(decode_png(data), BASE)


# -- JPEG ----------------------------------------------------------------------

JPEG_SHAPES = [(64, 64), (37, 53), (1, 1), (7, 300), (123, 17), (2, 3)]


@pytest.mark.parametrize("shape", JPEG_SHAPES)
@pytest.mark.parametrize("subsampling", [0, 1, 2])  # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("quality", [30, 50, 75, 95])
def test_jpeg_colour_matches_pil(shape, subsampling, quality):
    data = saved(Image.fromarray(photo(*shape)), "JPEG", quality=quality, subsampling=subsampling)
    assert np.abs(decode_jpeg(data).astype(int) - pil_rgb(data)).max() <= JPEG_LEVELS


@pytest.mark.parametrize("shape", JPEG_SHAPES)
@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_jpeg_gray_and_cmyk_match_pil(shape, mode):
    image = Image.fromarray(photo(*shape)).convert(mode)
    data = saved(image, "JPEG", quality=85)
    raw = decode_jpeg_raw(data)
    opened = np.asarray(Image.open(io.BytesIO(data)))
    assert np.abs(raw.reshape(opened.shape).astype(int) - opened).max() <= JPEG_LEVELS
    assert np.abs(decode_jpeg(data).astype(int) - pil_rgb(data)).max() <= JPEG_LEVELS


@pytest.mark.parametrize("option", [{"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
                                    {"restart_marker_blocks": 1}])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_jpeg_restart_intervals_match_pil(option, subsampling):
    data = saved(Image.fromarray(photo(45, 77)), "JPEG", quality=70, subsampling=subsampling, **option)
    assert b"\xff\xdd" in data  # a DRI marker
    assert np.abs(decode_jpeg(data).astype(int) - pil_rgb(data)).max() <= JPEG_LEVELS


def test_jpeg_adobe_rgb_and_ycck_match_pil():
    """Adobe transform 0 (RGB, no conversion) and 2 (YCCK): the first as
    PIL writes it with keep_rgb, the second a CMYK file with its Adobe
    transform byte set to 2 (PIL writes no YCCK), both read the way PIL
    reads them."""
    rgb = saved(Image.fromarray(photo(33, 41)), "JPEG", quality=80, keep_rgb=True)
    assert np.abs(decode_jpeg(rgb).astype(int) - pil_rgb(rgb)).max() <= JPEG_LEVELS
    cmyk = bytearray(saved(Image.fromarray(photo(33, 41)).convert("CMYK"), "JPEG", quality=80))
    adobe = cmyk.index(b"Adobe")
    assert cmyk[adobe + 11] == 0
    cmyk[adobe + 11] = 2
    ycck = bytes(cmyk)
    assert np.abs(decode_jpeg(ycck).astype(int) - pil_rgb(ycck)).max() <= JPEG_LEVELS


def test_jpeg_progressive_raises_item_9d():
    """Progressive JPEGs, once refused (ROADMAP item 9d), now decode as PIL
    reads them; so does an arithmetic-coded frame (SOF9, here Huffman data
    relabelled, which libjpeg-turbo decodes as arithmetic-coded data all
    the same), and bytes that are no JPEG raise InvalidDocumentError."""
    data = saved(Image.fromarray(photo(40, 40)), "JPEG", quality=80, progressive=True)
    assert b"\xff\xc2" in data  # SOF2
    assert np.abs(decode_jpeg(data).astype(int) - pil_rgb(data)).max() <= JPEG_LEVELS
    arithmetic = saved(Image.fromarray(photo(40, 40)), "JPEG", quality=80).replace(b"\xff\xc0", b"\xff\xc9", 1)
    assert np.abs(decode_jpeg(arithmetic).astype(int) - pil_rgb(arithmetic)).max() <= JPEG_LEVELS
    with pytest.raises(InvalidDocumentError):
        decode_jpeg(b"\xff\xd8\xff\xe0 not a jpeg")


def test_corrupt_jpegs_raise_and_never_crash():
    """Seeded byte flips and cuts of a JPEG: each decodes or raises one of
    the port's errors (the native core bounds every read and allocation)."""
    import random

    data = saved(Image.fromarray(photo(40, 50)), "JPEG", quality=75)
    rng = random.Random(25)
    outcomes = set()
    for _ in range(400):
        b = bytearray(data)
        for _ in range(rng.randint(1, 8)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        if rng.random() < 0.2:
            b = b[: rng.randrange(len(b))]
        try:
            decode_jpeg(bytes(b))
            outcomes.add("decoded")
        except (InvalidDocumentError, NotPortedError) as e:
            outcomes.add(type(e).__name__)
    assert {"decoded", "InvalidDocumentError"} <= outcomes


def test_cmyk_to_rgb_is_pils():
    cmyk = np.random.default_rng(3).integers(0, 256, (64, 64, 4), dtype=np.uint8)
    ref = np.asarray(Image.frombytes("CMYK", (64, 64), cmyk.tobytes()).convert("RGB"))
    assert np.array_equal(cmyk_to_rgb(cmyk), ref)
    assert cmyk_to_rgb(np.array([[[100, 0, 0, 50]]], np.uint8)).tolist() == [[[125, 205, 205]]]


# -- BMP -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_bmp_matches_pil(mode):
    image = {"RGB": lambda: Image.fromarray(BASE), "RGBA": PIL_MODES["RGBA"], "L": PIL_MODES["L"],
             "P": lambda: Image.fromarray(BASE).quantize(100)}[mode]()
    data = saved(image, "BMP")
    assert np.array_equal(decode_bmp(data), pil_rgb(data))


def test_bmp_rle_raises_item_9d():
    """RLE8 and RLE4 BMPs, once refused (ROADMAP item 9d), now decode as
    PIL reads them."""
    rng = np.random.default_rng(26)
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    indexes = np.repeat(rng.integers(0, 16, (37, 18)), 3, axis=1)[:, :53]
    for bits in (8, 4):
        data = image_encoders.bmp(indexes, bits, palette, rle=True, rng=rng)
        assert struct.unpack_from("<I", data, 30)[0] == {8: 1, 4: 2}[bits]  # BI_RLE8, BI_RLE4
        assert np.array_equal(decode_bmp(data), pil_rgb(data))


# -- resampling ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_lanczos_matches_pil(seed):
    rng = np.random.default_rng(100 + seed)
    h, w = rng.integers(1, 120, 2)
    out_w, out_h = rng.integers(1, 160, 2)
    image = photo(h, w, seed=seed)
    ref = np.asarray(Image.fromarray(image).resize((out_w, out_h), Image.LANCZOS))
    assert np.abs(resize_lanczos(image, out_w, out_h).astype(int) - ref).max() <= RESIZE_LEVELS


@pytest.mark.parametrize("shape,size", [((400, 200), 100), ((30, 50), 100), ((1836, 2376), 1536), ((10, 10), 10)])
def test_resize_image_matches_the_jax_package(shape, size):
    image = photo(*shape, seed=4)
    ref = np.asarray(jax_resize_image(Image.fromarray(image), size))
    got = resize_image(image, size)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref).max() <= RESIZE_LEVELS


# -- image documents -----------------------------------------------------------

async def _pages(extract, mime, data, **kw):
    return [np.asarray(p) for p in [page async for page in extract(mime, data, **kw)]]


@pytest.mark.parametrize("fmt,mime", [("PNG", "image/png"), ("JPEG", "image/jpeg"), ("BMP", "image/bmp")])
def test_image_documents_match_the_jax_package(fmt, mime):
    data = saved(Image.fromarray(photo(300, 150, seed=5)), fmt)
    assert extract_number_of_pages(mime, data) == jax_number_of_pages(mime, data) == 1
    for size in (None, 200):
        ref = asyncio.run(_pages(jax_extract_pages, mime, data, scaled_size=size))
        got = asyncio.run(_pages(extract_pages, mime, data, scaled_size=size))
        assert len(got) == len(ref) == 1 and got[0].shape == ref[0].shape
        assert np.abs(got[0].astype(int) - ref[0]).max() <= JPEG_LEVELS + RESIZE_LEVELS


@pytest.mark.parametrize("fmt", ["GIF", "TIFF", "WEBP"])
def test_other_image_documents_raise_item_9d(fmt):
    """GIF, TIFF and WebP documents, once refused (ROADMAP item 9d), now
    read: their page count and page as the JAX package gives them (WebP
    lossy at PIL's default quality, decoded as libwebp decodes it)."""
    data = saved(Image.fromarray(BASE), fmt)
    mime = "image/" + fmt.lower()
    assert extract_number_of_pages(mime, data) == jax_number_of_pages(mime, data) == 1
    assert np.array_equal(decode_image(data), pil_rgb(data))
    ref = asyncio.run(_pages(jax_extract_pages, mime, data))
    assert np.array_equal(asyncio.run(_pages(extract_pages, mime, data))[0], ref[0])
