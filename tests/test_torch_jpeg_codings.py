"""The JPEG codings libjpeg-turbo 3.1 reads beyond Huffman DCT, in the
port's JPEG core (``native/jpeg.cpp``, ``image_processor/jpeg.py``), held
against PIL on the CPU: arithmetic-coded sequential and progressive
frames (SOF9, SOF10: DAC conditioning, restarts), lossless frames (SOF3:
predictors 1-7, point transform, restarts, one scan a component),
libjpeg's block smoothing of progressive images left partly refined, and
what PIL refuses (12 bits, hierarchical processes, lossless arithmetic
coding, 2 components, a lossless frame marked YCbCr, an arithmetic scan
past the 64 KiB Pillow hands libjpeg at once).

Tolerances, stated before any comparison:
- every decoded image: within JPEG_LEVELS per channel of PIL's (the gate
  of tests/test_torch_codecs.py); equal expected (lossless, arithmetic
  and smoothing add no rounding of their own to the Huffman path's), the
  largest difference printed;
- what PIL refuses: InvalidDocumentError, as an image document (page
  count and pages) and skipped inside a PDF as the JAX package skips it
  (the page within IMAGE_LEVELS of the JAX package's render);
- corrupt data: decodes or raises one of the port's errors, never crashes.
Inputs are written here from seeded arrays: PIL's save for the smoothed
progressive JPEGs (cut after chosen scans), ``image_encoders``'s
arithmetic and lossless encoders for what PIL cannot write.
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

from dial_rag_tpu.documents.pdf import render as jax_render
from dial_rag_tpu.image_processor.extract_pages import _extract_pages_sync as jax_pages
from dial_rag_tpu.image_processor.extract_pages import extract_number_of_pages as jax_number_of_pages
from dial_rag_tpu_torch.documents.pdf import render
from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.image_processor.extract_pages import _extract_pages_sync, extract_number_of_pages
from dial_rag_tpu_torch.image_processor.jpeg import decode_jpeg, read_header
from tests.utils import image_encoders as enc
from tests.utils.image_pdf import build_image_pdf
from tests.utils.make_jpeg_fixtures import photo

JPEG_LEVELS = 2
IMAGE_LEVELS = 3


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_as_pil(data: bytes, what: str) -> None:
    ref = pil_rgb(data).astype(np.int64)
    got = decode_jpeg(data).astype(np.int64)
    assert got.shape == ref.shape, what
    gap = int(np.abs(got - ref).max())
    print(f"{what}: largest difference {gap}")
    assert gap <= JPEG_LEVELS, what


def pil_fails(data: bytes) -> bool:
    try:
        pil_rgb(data)
    except Exception:  # noqa: BLE001 - PIL's refusals are OSError or its subclasses
        return True
    return False


# -- arithmetic coding --------------------------------------------------------------------

SEQUENTIAL = [("gray", None, 0, None), ("rgb", [(2, 2), (1, 1), (1, 1)], 0, None),
              ("rgb", [(1, 1)] * 3, 2, None), ("rgb", [(2, 1), (1, 1), (1, 1)], 5, {("dc", 0): (3, 7)}),
              ("rgb", [(1, 2), (1, 1), (1, 1)], 1, {("ac", 0): 1, ("ac", 1): 40}),
              ("gray", None, 3, {("dc", 0): (0, 0), ("ac", 0): 63})]


@pytest.mark.parametrize("case", range(len(SEQUENTIAL)))
def test_arithmetic_sequential_matches_pil(case):
    kind, sampling, restart, dac = SEQUENTIAL[case]
    rng = np.random.default_rng(40 + case)
    for shape in [(1, 1), (9, 130), tuple(int(v) for v in rng.integers(8, 90, 2))]:
        a = photo(*shape, seed=int(rng.integers(1 << 30)))
        data = enc.jpeg_arithmetic(a[..., 0] if kind == "gray" else a, quality=int(rng.integers(30, 96)),
                                   sampling=sampling, restart=restart, dac=dac)
        assert b"\xff\xc9" in data
        assert_as_pil(data, f"SOF9 {kind} {sampling} restart {restart} {dac} {shape}")


SCRIPTS = [None,
           [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
           [((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 2, 0, 3), ((0,), 3, 63, 0, 1), ((0,), 1, 2, 3, 2), ((0,), 1, 2, 2, 1),
            ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0), ((0, 1, 2), 0, 0, 2, 1), ((0, 1, 2), 0, 0, 1, 0),
            ((0,), 1, 63, 1, 0)]]


@pytest.mark.parametrize("script", range(len(SCRIPTS)))
@pytest.mark.parametrize("restart", [0, 3])
def test_arithmetic_progressive_matches_pil(script, restart):
    """SOF10 scans: DC first and refinements, AC first and refinements
    (successive approximation down several bits), with restarts and DAC."""
    rng = np.random.default_rng(60 + 2 * script + restart)
    for shape in [(8, 8), (37, 51), tuple(int(v) for v in rng.integers(16, 80, 2))]:
        data = enc.jpeg_arithmetic(photo(*shape, seed=int(rng.integers(1 << 30))), quality=int(rng.integers(40, 95)),
                                   progressive=True, restart=restart, script=SCRIPTS[script],
                                   dac={("dc", 1): (1, 4), ("ac", 0): 3} if restart else None)
        assert b"\xff\xca" in data
        assert_as_pil(data, f"SOF10 script {script} restart {restart} {shape}")


def test_arithmetic_scans_past_pillows_first_blocks_fail_as_in_pil():
    """Pillow hands libjpeg the file 64 KiB at a time and libjpeg's
    arithmetic decoder cannot wait for more: an arithmetic scan that reads
    past the blocks handed over when it began fails under Pillow, and in
    the port; one that fits decodes."""
    small = enc.jpeg_arithmetic(photo(120, 160, 3), quality=80)
    padding = b"\xff\xe1" + (40000).to_bytes(2, "big") + bytes(39998)
    crossing = small[:2] + padding + padding[:4] + small[2:]  # a second segment cut to its marker: begins in block 2
    cases = {"fits": small, "after one block": small[:2] + padding + small[2:],
             "after two": small[:2] + padding + padding + small[2:], "crossing": crossing}
    outcomes = set()
    for name, data in cases.items():
        if pil_fails(data):
            with pytest.raises(InvalidDocumentError):
                decode_jpeg(data)
            outcomes.add("fails")
        else:
            assert_as_pil(data, name)
            outcomes.add("ok")
    big = enc.jpeg_arithmetic(photo(660, 1024, 4)[..., 0], quality=90)
    assert len(big) > 65536 and pil_fails(big)
    with pytest.raises(InvalidDocumentError):
        decode_jpeg(big)
    assert outcomes == {"ok", "fails"}


def test_huffman_data_relabelled_as_arithmetic_matches_pil():
    """A Huffman JPEG whose SOF0 says SOF9: libjpeg-turbo decodes its data
    as arithmetic-coded (ignoring DHT) into whatever it gives; so does the
    port, restarts too."""
    for options in ({}, {"restart_marker_blocks": 2}, {"subsampling": 0}):
        buf = io.BytesIO()
        Image.fromarray(photo(40, 56, 5)).save(buf, "JPEG", quality=80, **options)
        data = buf.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1)
        assert_as_pil(data, f"relabelled {options}")


# -- lossless ------------------------------------------------------------------------------

@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors_match_pil(predictor):
    """Every predictor with point transforms 0 and 2, restarts, one scan a
    component; gray, RGB (not colour-converted: libjpeg-turbo reads a
    lossless frame without a JFIF or Adobe marker as RGB) and CMYK."""
    rng = np.random.default_rng(80 + predictor)
    a = photo(*(int(v) for v in rng.integers(9, 40, 2)), seed=predictor)
    for pixels, kw in ((a[..., 0], {}), (a, {"point_transform": 2}),
                       (a, {"restart_rows": 3, "interleaved": False}),
                       (np.dstack([a, a[..., 1]]), {"point_transform": 1, "restart_rows": 2}),
                       (a, {"ids": (82, 71, 66)})):
        data = enc.jpeg_lossless(pixels, predictor=predictor, **kw)
        assert b"\xff\xc3" in data
        assert_as_pil(data, f"SOF3 predictor {predictor} {pixels.shape} {kw}")
        if kw.get("point_transform", 0) == 0:
            assert np.array_equal(decode_jpeg(data)[..., 0], pixels[..., 0] if pixels.ndim == 3 else pixels)


# -- block smoothing ----------------------------------------------------------------------

SMOOTHED = [("RGB", 2, (48, 64)), ("RGB", 2, (32, 24)), ("RGB", 0, (45, 61)), ("RGB", 1, (77, 41)),
            ("L", 0, (40, 17)), ("CMYK", 0, (30, 30)), ("RGB", 2, (16, 16)), ("RGB", 2, (90, 8))]


@pytest.mark.parametrize("case", range(len(SMOOTHED)))
def test_progressive_jpegs_libjpeg_smooths_match_pil(case):
    """A progressive JPEG cut after each of its scans (EOI appended): with
    its DC known and some of AC 1-9 not fully refined, libjpeg smooths
    its blocks from the 5 x 5 blocks' DC values (and the DC itself where
    no AC arrived); narrow images repeat their edge columns."""
    mode, sub, shape = SMOOTHED[case]
    buf = io.BytesIO()
    kw = {"subsampling": sub} if mode == "RGB" else {}
    Image.fromarray(photo(*shape, seed=90 + case)).convert(mode).save(buf, "JPEG", quality=75, progressive=True, **kw)
    data = buf.getvalue()
    scans = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    for k in range(1, len(scans) + 1):
        cut = data[:scans[k]] + b"\xff\xd9" if k < len(scans) else data
        assert_as_pil(cut, f"{mode} {sub} {shape}: {k} of {len(scans)} scans")


# -- what PIL refuses ---------------------------------------------------------------------

REFUSED = {"12-bit baseline": (0xC0, 12, 1), "12-bit extended": (0xC1, 12, 3), "12-bit progressive": (0xC2, 12, 1),
           "16-bit lossless": (0xC3, 16, 1), "differential sequential": (0xC5, 8, 1),
           "differential progressive": (0xC6, 8, 3), "differential lossless": (0xC7, 8, 1),
           "lossless arithmetic": (0xCB, 8, 1), "differential arithmetic": (0xCD, 8, 1),
           "differential arithmetic progressive": (0xCE, 8, 1), "differential arithmetic lossless": (0xCF, 8, 1),
           "two components": (0xC0, 8, 2)}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_jpegs_pil_refuses_raise_invalid_document(name):
    marker, precision, components = REFUSED[name]
    data = enc.jpeg_header_only(marker, precision=precision, components=components)
    assert pil_fails(data)
    with pytest.raises(InvalidDocumentError):
        read_header(data)
        decode_jpeg(data)
    with pytest.raises(InvalidDocumentError):
        extract_number_of_pages("image/jpeg", data)


def test_lossless_marked_ycbcr_fails_as_in_pil():
    """libjpeg-turbo converts no colour in lossless mode: a 3-component
    lossless frame that a JFIF marker calls YCbCr opens (one page) and
    fails to decode, in PIL and in the port."""
    data = enc.jpeg_lossless(photo(20, 30, 6), predictor=1, jfif=True)
    assert extract_number_of_pages("image/jpeg", data) == jax_number_of_pages("image/jpeg", data) == 1
    assert pil_fails(data)
    with pytest.raises(InvalidDocumentError):
        decode_jpeg(data)


SAMPLINGS = [[(2, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (2, 2)], [(2, 1), (1, 1), (1, 1)],
             [(1, 2), (1, 1), (1, 1)], [(2, 2), (1, 2), (2, 1)], [(4, 2), (1, 1), (2, 1)]]


@pytest.mark.parametrize("sampling", range(len(SAMPLINGS)))
def test_subsampled_lossless_matches_pil(sampling):
    """Lossless frames with subsampled components: libjpeg-turbo replicates
    their samples (no fancy upsampling); an interleaved MCU of more than
    10 samples fails there (JERR_BAD_MCU_SIZE) and in the port, one scan a
    component decodes."""
    factors = SAMPLINGS[sampling]
    for shape in [(1, 1), (3, 7), (45, 61)]:
        a = photo(*shape, seed=sampling)
        for kw in ({}, {"restart_rows": 2, "predictor": 6}, {"interleaved": False, "point_transform": 1}):
            data = enc.jpeg_lossless(a, sampling=factors, **{"predictor": 4, **kw})
            if sum(h * v for h, v in factors) > 10 and kw.get("interleaved", True):
                assert pil_fails(data)
                with pytest.raises(InvalidDocumentError):
                    decode_jpeg(data)
                continue
            assert_as_pil(data, f"SOF3 {factors} {shape} {kw}")


def test_refused_jpegs_in_a_pdf_are_skipped_as_the_jax_package_skips_them():
    images = [(72, 420, 200, 150, ("dct", enc.jpeg_header_only(0xC1, precision=12), 16, 16, 1)),
              (330, 420, 200, 150, ("dct", enc.jpeg_header_only(0xC5), 16, 16, 1)),
              (72, 200, 200, 150, ("dct", enc.jpeg_arithmetic(photo(50, 70, 7)), 70, 50, 3))]
    pdf = build_image_pdf([([(72, 700, 12, "Refused and arithmetic-coded images.")], images)])
    for size in (None, 800):
        ref = np.asarray(next(jax_render.render_pdf_pages(pdf, scaled_size=size)))
        got = next(render.render_pdf_pages(pdf, scaled_size=size))
        assert got.shape == ref.shape
        below_text = ref.shape[0] // 4  # the text line above is drawn in a font only close to PIL's
        assert int(np.abs(got.astype(np.int64) - ref)[below_text:].max()) <= IMAGE_LEVELS


# -- documents ---------------------------------------------------------------------------------

@pytest.mark.parametrize("coding", ["arithmetic", "arithmetic progressive", "lossless", "smoothed"])
def test_jpeg_documents_match_the_jax_package(coding):
    """An image/jpeg attachment in each coding: its page count and its page
    (whole and resized) as the JAX package gives them."""
    a = photo(70, 90, 8)
    if coding == "smoothed":
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG", quality=80, progressive=True)
        full = buf.getvalue()
        data = full[:[i for i in range(len(full) - 1) if full[i:i + 2] == b"\xff\xda"][2]] + b"\xff\xd9"
    elif coding == "lossless":
        data = enc.jpeg_lossless(a, predictor=6)
    else:
        data = enc.jpeg_arithmetic(a, progressive=coding.endswith("progressive"), restart=4)
    assert extract_number_of_pages("image/jpeg", data) == jax_number_of_pages("image/jpeg", data) == 1
    for size in (None, 48):
        ref = [np.asarray(p) for p in jax_pages("image/jpeg", data, None, size)]
        got = _extract_pages_sync("image/jpeg", data, None, size)
        assert len(got) == len(ref) == 1 and got[0].shape == ref[0].shape
        assert int(np.abs(got[0].astype(np.int64) - ref[0]).max()) <= JPEG_LEVELS + (1 if size else 0)


def test_corrupt_arithmetic_and_lossless_jpegs_never_crash():
    rng = random.Random(28)
    outcomes = set()
    for data in (enc.jpeg_arithmetic(photo(40, 50, 9), progressive=True, restart=2),
                 enc.jpeg_lossless(photo(30, 40, 10), predictor=4, restart_rows=4)):
        for _ in range(150):
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
