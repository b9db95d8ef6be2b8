"""WebP documents in the port (``image_processor/webp.py`` on the host core
``native/webp.cpp``) held against PIL (libwebp's ``WebPAnimDecoder``) and
the JAX package on the CPU.

Tolerances, stated before any comparison:
- VP8 lossy (libwebp's fancy upsampling and fixed-point YUV -> RGB), VP8L
  lossless, ALPH planes and animated composites: equal (bit for bit) to
  PIL's pixels (RGBA where a frame is compared alone, else each page's
  ``convert("RGB")``);
- scaled pages: within RESIZE_LEVELS of the JAX package's.
Inputs are seeded: PIL writes lossy, lossless, alpha and animated files,
libwebp's encoder (``image_encoders.webp_encode``) the loop filters, token
partitions, segments and sharpness Pillow's save does not pass on, and
``image_encoders`` the ALPH filters and animations that dispose to
background.
"""

import io

import numpy as np
import pytest
from PIL import Image

from dial_rag_tpu.image_processor.extract_pages import _extract_pages_sync as jax_pages
from dial_rag_tpu.image_processor.extract_pages import extract_number_of_pages as jax_number_of_pages
from dial_rag_tpu_torch.documents.parser import extract_number_of_pages, parse_document
from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.image_processor.extract_pages import _extract_pages_sync
from dial_rag_tpu_torch.image_processor.webp import decode_frame, decode_webp_frames, frame_count, read_webp
from tests.utils import image_encoders as enc
from tests.utils.make_jpeg_fixtures import photo

RESIZE_LEVELS = 1


def pil_pages(data: bytes) -> list[np.ndarray]:
    with Image.open(io.BytesIO(data)) as im:
        out = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out


def pil_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def assert_pages(data: bytes) -> None:
    want = pil_pages(data)
    got = decode_webp_frames(data)
    assert frame_count(data) == len(want) == len(got)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)


def alpha_plane(rng, h: int, w: int) -> np.ndarray:
    kind = int(rng.integers(4))
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == 0:
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == 1:
        return ((xx * 5 + yy * 3) % 256).astype(np.uint8)
    if kind == 2:
        return np.where(rng.random((h, w)) < 0.5, 0, 255).astype(np.uint8)
    return np.where(xx < w // 2, 255, int(rng.integers(256))).astype(np.uint8)


SHAPES = [(1, 1), (2, 3), (16, 16), (17, 33), (7, 300)]


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("quality", [5, 50, 95, 100])
def test_lossy_webp_matches_pil(quality, alpha):
    rng = np.random.default_rng(quality * 2 + alpha)
    for shape in SHAPES + [tuple(int(v) for v in rng.integers(1, 120, 2))]:
        a = photo(*shape, seed=int(rng.integers(1 << 20)))
        if alpha:
            image = Image.fromarray(np.dstack([a, alpha_plane(rng, *shape)]), "RGBA")
        else:
            image = Image.fromarray(a)
        buf = io.BytesIO()
        image.save(buf, "WEBP", quality=quality, method=int(rng.integers(0, 7)))
        data = buf.getvalue()
        assert_pages(data)
        _, frames = read_webp(data)
        assert np.array_equal(decode_frame(frames[0])[..., 3], pil_rgba(data)[..., 3])


# (filter_type, partitions, sharpness, segments, filter_strength): the simple and normal loop filters, 1-8 token
# partitions, sharpness, segment maps and no filter at all
VP8_OPTIONS = [(0, 0, 0, 4, 30), (0, 3, 5, 1, 100), (1, 1, 7, 4, 60), (1, 2, 0, 2, 0), (1, 3, 3, 4, 100),
               (0, 2, 2, 3, 10)]


@pytest.mark.parametrize("options", VP8_OPTIONS, ids=lambda o: "-".join(map(str, o)))
def test_vp8_coding_options_match_pil(options):
    filter_type, partitions, sharpness, segments, strength = options
    rng = np.random.default_rng(sum(options))
    for shape in [(1, 1), (33, 47), tuple(int(v) for v in rng.integers(1, 160, 2))]:
        data = enc.webp_encode(photo(*shape, seed=int(rng.integers(1 << 20))), quality=float(rng.integers(5, 100)),
                               filter_type=filter_type, partitions=partitions, filter_sharpness=sharpness,
                               segments=segments, filter_strength=strength, autofilter=0,
                               sns_strength=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)))
        assert_pages(data)


@pytest.mark.parametrize("kind", ["photo", "few_colours", "two_colours", "alpha"])
@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossless_webp_matches_pil(kind, method):
    """VP8L: the predictor, cross-colour and subtract-green transforms
    (photos), colour indexing with 1-, 2-, 4- and 8-bit packing (few
    colours), the colour cache and meta prefix codes (larger images)."""
    rng = np.random.default_rng(method * 10 + len(kind))
    for shape in SHAPES + [tuple(int(v) for v in rng.integers(40, 200, 2))]:
        a = photo(*shape, seed=int(rng.integers(1 << 20)))
        if kind in ("few_colours", "two_colours"):
            colours = rng.integers(0, 256, (2 if kind == "two_colours" else int(rng.integers(3, 40)), 3))
            a = colours[rng.integers(0, len(colours), shape)].astype(np.uint8)
        image = Image.fromarray(np.dstack([a, alpha_plane(rng, *shape)]), "RGBA") if kind == "alpha" else \
            Image.fromarray(a)
        buf = io.BytesIO()
        image.save(buf, "WEBP", lossless=True, method=method, quality=int(rng.integers(0, 101)), exact=True)
        data = buf.getvalue()
        assert_pages(data)
        assert np.array_equal(decode_frame(read_webp(data)[1][0]), pil_rgba(data))


@pytest.mark.parametrize("filter_method", [0, 1, 2, 3])
@pytest.mark.parametrize("compressed", [False, True])
def test_alph_chunks_match_pil(filter_method, compressed):
    """ALPH planes raw or VP8L-compressed, under each of the three filters
    (and none), with and without the level-reduction flag."""
    rng = np.random.default_rng(filter_method * 2 + compressed)
    for levels in (False, True):
        for shape in [(1, 1), (5, 9), tuple(int(v) for v in rng.integers(1, 80, 2))]:
            lossy = enc.webp_encode(photo(*shape, seed=int(rng.integers(1 << 20))), quality=70.0)
            alpha = alpha_plane(rng, *shape)
            data = enc.webp_with_alpha(lossy, alpha, filter_method, compressed, levels)
            got = decode_frame(read_webp(data)[1][0])
            assert np.array_equal(got[..., 3], alpha)
            assert np.array_equal(got, pil_rgba(data))
            assert_pages(data)


def random_animation(rng) -> bytes:
    w, h = (int(v) for v in rng.integers(4, 48, 2))
    frames = []
    for _ in range(int(rng.integers(1, 6))):
        fw, fh = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        x, y = int(rng.integers(0, (w - fw) // 2 + 1)) * 2, int(rng.integers(0, (h - fh) // 2 + 1)) * 2
        a = photo(fh, fw, int(rng.integers(1 << 20)))
        if rng.random() < 0.6:
            a = np.dstack([a, rng.choice([0, 255, int(rng.integers(256))], (fh, fw)).astype(np.uint8)])
        frames.append({"image": enc.webp_encode(a, lossless=int(rng.integers(2)), quality=70.0), "at": (x, y),
                       "blend": bool(rng.integers(2)), "dispose": bool(rng.integers(2))})
    return enc.webp_animation((w, h), frames, tuple(int(v) for v in rng.integers(0, 256, 4)))


@pytest.mark.parametrize("seed", range(6))
def test_animated_webp_matches_pil(seed):
    """Frames blended or not, disposed to background or not, at offsets,
    lossy with ALPH and lossless: WebPAnimDecoder's canvases; then what
    PIL's animated save writes (sub-frames of its own choosing)."""
    rng = np.random.default_rng(4000 + seed)
    for _ in range(6):
        assert_pages(random_animation(rng))
    h, w = (int(v) for v in rng.integers(8, 48, 2))
    base = photo(h, w, seed)
    frames = []
    for _ in range(4):
        a = base.copy()
        y0, x0 = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
        a[y0:y0 + 4, x0:x0 + 6] = rng.integers(0, 256, 3)
        alpha = np.full((h, w), 255, np.uint8)
        alpha[y0:y0 + 3] = int(rng.integers(0, 255))
        frames.append(Image.fromarray(np.dstack([a, alpha]), "RGBA"))
        base = a
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=bool(seed % 2), quality=80,
                   minimize_size=bool(seed % 3), kmax=int(rng.integers(0, 6)), kmin=int(rng.integers(0, 3)))
    assert_pages(buf.getvalue())


@pytest.mark.parametrize("seed", range(3))
def test_webp_documents_match_the_jax_package(seed):
    """Page counts, pages (all, reordered, scaled) and chunks, as the JAX
    package gives them: an animation, then a lossy still with alpha."""
    rng = np.random.default_rng(5000 + seed)
    if seed < 2:
        data = random_animation(rng)
    else:
        a = np.dstack([photo(50, 70, seed), alpha_plane(rng, 50, 70)])
        buf = io.BytesIO()
        Image.fromarray(a, "RGBA").save(buf, "WEBP", quality=60)
        data = buf.getvalue()
    mime = "image/webp"
    n = jax_number_of_pages(mime, data)
    assert extract_number_of_pages(mime, data) == n
    for numbers, size in ((None, None), ([n, 1], None), (None, 24)):
        ref = [np.asarray(p) for p in jax_pages(mime, data, numbers, size)]
        got = _extract_pages_sync(mime, data, numbers, size)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and int(np.abs(a.astype(int) - b).max()) <= (RESIZE_LEVELS if size else 0)
    with pytest.raises(InvalidDocumentError, match=f"page {n + 1} out of range 1..{n}"):
        _extract_pages_sync(mime, data, [n + 1], None)
    chunks = parse_document(data, mime, source_link="files/a.webp")
    assert [(c.text, c.metadata["page_number"]) for c in chunks] == [("", p) for p in range(1, n + 1)]


@pytest.mark.parametrize("fault", ["truncated", "inter_frame", "corrupt_tokens"])
def test_webps_pil_cannot_read_raise(fault):
    """A truncated file, a VP8 inter frame (libwebp decodes key frames
    only) and a corrupt lossless stream fail in PIL; the port raises
    InvalidDocumentError for them."""
    buf = io.BytesIO()
    Image.fromarray(photo(24, 40, 3)).save(buf, "WEBP", lossless=fault == "corrupt_tokens", quality=70)
    data = bytearray(buf.getvalue())
    if fault == "truncated":
        data = data[: len(data) // 2]
    elif fault == "inter_frame":
        data[20] |= 1  # the frame tag's key-frame bit (0 for a key frame)
    else:
        data[25:] = b"\xff" * (len(data) - 25)
    data = bytes(data)
    with pytest.raises(Exception):
        pil_pages(data)
    with pytest.raises(InvalidDocumentError):
        decode_webp_frames(data)


def _vp8l(w: int, h: int) -> bytes:
    """A simple lossless file whose header declares w x h (its body is a
    few bytes of no image)."""
    bits = (w - 1) | (h - 1) << 14
    payload = b"\x2f" + bits.to_bytes(4, "little") + bytes(9)
    return b"RIFF" + (4 + 8 + len(payload)).to_bytes(4, "little") + b"WEBPVP8L" + len(payload).to_bytes(4, "little") \
        + payload


def _vp8(w: int, h: int) -> bytes:
    """A simple lossy file whose key frame declares w x h."""
    payload = bytes([0x10, 0x02, 0x00]) + b"\x9d\x01\x2a" + w.to_bytes(2, "little") + h.to_bytes(2, "little") \
        + bytes(8)
    return b"RIFF" + (4 + 8 + len(payload)).to_bytes(4, "little") + b"WEBPVP8 " + len(payload).to_bytes(4, "little") \
        + payload


@pytest.mark.parametrize("layout", ["vp8l", "vp8", "vp8x"])
def test_webp_past_the_decompression_bomb_limit_raises_as_pillow_does(layout):
    """Pillow's open refuses a canvas of more than 2 * MAX_IMAGE_PIXELS
    pixels whatever the file's layout; the port raises InvalidDocumentError
    for it before it decodes (or counts) anything."""
    if layout == "vp8l":
        data = _vp8l(16384, 16384)
    elif layout == "vp8":
        data = _vp8(16383, 16383)
    else:
        still = io.BytesIO()
        Image.fromarray(photo(8, 8, 1)).save(still, "WEBP", lossless=True)
        data = enc.webp_animation((20000, 10000), [{"image": still.getvalue()}])
    with pytest.raises(Image.DecompressionBombError):
        pil_pages(data)
    with pytest.raises(InvalidDocumentError, match="too large"):
        frame_count(data)
    with pytest.raises(InvalidDocumentError, match="too large"):
        decode_webp_frames(data)
    with pytest.raises(InvalidDocumentError, match="too large"):
        extract_number_of_pages("image/webp", data)


def test_webp_at_the_decompression_bomb_limit_is_counted():
    """Just under the limit (16383 x 10923 pixels) Pillow opens the file and
    counts one page; the port counts it from the header alone."""
    data = _vp8l(16383, 10923)
    assert 16383 * 10923 <= 178956970
    with pytest.warns(Image.DecompressionBombWarning), Image.open(io.BytesIO(data)) as im:
        assert frame_count(data) == getattr(im, "n_frames", 1) == 1
