"""TIFF documents in the port (``image_processor/tiff.py`` on the host core
``native/tiff.cpp``) held against PIL and the JAX package on the CPU.

Tolerances, stated before any comparison:
- every compression but JPEG: equal (bit for bit) to PIL's
  ``convert("RGB")`` of each page;
- JPEG-in-TIFF: within JPEG_LEVELS per channel (the native JPEG core's
  gate, tests/test_torch_image_formats.py);
- scaled pages: within RESIZE_LEVELS of the JAX package's.
Inputs are seeded: PIL (libtiff) writes each compression it writes,
``tests/utils/image_encoders.tiff`` the layouts it writes on request only
(tiles, planes, BigTIFF, big-endian, FillOrder 2, 2-, 4- and 16-bit
samples, the predictor, Group 3 2D, old-style LZW).
"""

import io
import struct
import tracemalloc

import numpy as np
import pytest
from PIL import Image

from dial_rag_tpu.image_processor.extract_pages import _extract_pages_sync as jax_pages
from dial_rag_tpu.image_processor.extract_pages import extract_number_of_pages as jax_number_of_pages
from dial_rag_tpu_torch.documents.parser import extract_number_of_pages, parse_document
from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.image_processor.extract_pages import _extract_pages_sync
from dial_rag_tpu_torch.image_processor.tiff import decode_tiff_pages, page_count
from tests.utils import image_encoders as enc
from tests.utils.make_image_fixtures import fax_page
from tests.utils.make_jpeg_fixtures import photo
from tests.utils.port_parity import same

JPEG_LEVELS = 2
RESIZE_LEVELS = 1


def pil_pages(data: bytes) -> list[np.ndarray]:
    with Image.open(io.BytesIO(data)) as im:
        out = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out


def assert_pages(data: bytes, levels: int = 0) -> None:
    want = pil_pages(data)
    got = decode_tiff_pages(data)
    assert page_count(data) == len(want) == len(got)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert int(np.abs(a.astype(np.int64) - b).max()) <= levels


# -- what PIL (libtiff) writes --------------------------------------------------------

PIL_MODES = ["1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "LA", "RGBX"]
PIL_COMPRESSIONS = [None, "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits", "group3", "group4",
                    "tiff_ccitt", "jpeg"]


def pil_image(mode: str, shape, seed: int) -> Image.Image:
    a = photo(*shape, seed=seed)
    if mode == "I;16":
        return Image.fromarray((a[..., 0].astype(np.uint16) * (seed % 300 + 1)).astype(np.uint16))
    if mode == "P":
        return Image.fromarray(a).quantize(int(seed % 200) + 2)
    return Image.fromarray(a).convert(mode)


@pytest.mark.parametrize("compression", PIL_COMPRESSIONS, ids=lambda c: c or "raw")
def test_tiffs_pil_writes_match_pil(compression):
    rng = np.random.default_rng(PIL_COMPRESSIONS.index(compression))
    modes = ["1"] if compression in ("group3", "group4", "tiff_ccitt") else (
        ["L", "RGB", "CMYK"] if compression == "jpeg" else PIL_MODES)
    for mode in modes:
        for shape in [(1, 1), (17, 33), (7, 300), tuple(int(v) for v in rng.integers(2, 90, 2))]:
            buf = io.BytesIO()
            options = {"compression": compression} if compression else {}
            if compression == "jpeg":
                options["quality"] = int(rng.integers(30, 96))
            pil_image(mode, shape, int(rng.integers(1 << 20))).save(buf, "TIFF", **options)
            assert_pages(buf.getvalue(), JPEG_LEVELS if compression == "jpeg" else 0)


@pytest.mark.parametrize("compression", ["group4", "group3", "tiff_ccitt"])
def test_fax_pages_with_long_runs_match_pil(compression):
    """Fax pages as wide as A4 scans and wider: runs past 64 (makeup codes)
    and past 1792 (the extended makeup codes both colours share)."""
    rng = np.random.default_rng(len(compression))
    for w in (1728, 3000):
        bits = np.zeros((24, w), dtype=bool)
        for y in range(24):
            cuts = np.sort(rng.integers(0, w, int(rng.integers(0, 9))))
            for a, b in zip(cuts[::2], cuts[1::2]):
                bits[y, a:b] = True
        bits[:4, :] = fax_page(rng, 4, w)
        buf = io.BytesIO()
        Image.fromarray(~bits).save(buf, "TIFF", compression=compression)
        assert_pages(buf.getvalue())


@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L", "CMYK"])
def test_jpeg_in_tiff_matches_pil(mode):
    """JPEG strips after their JPEGTables: YCbCr converted to RGB as
    libtiff's RGB colour mode has libjpeg convert it, RGB, gray and CMYK
    as stored."""
    rng = np.random.default_rng(len(mode))
    worst = 0
    for shape in [(8, 8), (61, 83), tuple(int(v) for v in rng.integers(9, 120, 2))]:
        buf = io.BytesIO()
        Image.fromarray(photo(*shape, seed=int(rng.integers(1 << 20)))).convert(mode).save(
            buf, "TIFF", compression="jpeg", quality=int(rng.integers(40, 95)))
        data = buf.getvalue()
        got, want = decode_tiff_pages(data)[0], pil_pages(data)[0]
        assert got.shape == want.shape
        worst = max(worst, int(np.abs(got.astype(np.int64) - want).max()))
    print(f"JPEG-in-TIFF {mode}: largest difference {worst}")
    assert worst <= JPEG_LEVELS


# -- what the encoders write -------------------------------------------------------

# (photometric, samples, bits, extra samples)
KEYS = [(1, 1, 1, ()), (0, 1, 1, ()), (1, 1, 2, ()), (0, 1, 4, ()), (1, 1, 8, ()), (0, 1, 8, ()), (1, 1, 16, ()),
        (2, 3, 8, ()), (2, 4, 8, (2,)), (2, 4, 8, (1,)), (2, 4, 8, (0,)), (2, 3, 16, ()), (2, 4, 16, (1,)),
        (3, 1, 1, ()), (3, 1, 4, ()), (3, 1, 8, ()), (5, 4, 8, ()), (1, 2, 8, (2,)), (2, 4, 8, ()),
        (2, 5, 8, (1, 0))]
LAYOUTS = ["strips", "tiles", "planar", "bigtiff", "fill_order_2", "predictor", "variant"]
ENCODED = [1, 2, 3, 4, 5, 8, 32773, 32946]


@pytest.mark.parametrize("compression", ENCODED)
@pytest.mark.parametrize("order", ["<", ">"])
def test_encoded_tiffs_match_pil(compression, order):
    """Every key above under every layout it takes (the "variant" layout:
    Group 3 2D coding, old-style LZW), at seeded sizes; where PIL itself
    fails (planes past four bands or with an unspecified extra sample,
    bit-reversed raw modes Pillow lacks) the port raises
    InvalidDocumentError."""
    rng = np.random.default_rng(ENCODED.index(compression) * 2 + (order == ">"))
    checked = 0
    for photometric, n, bits, extra in KEYS:
        if compression in (2, 3, 4) and bits != 1:
            continue
        for layout in LAYOUTS:
            h, w = (int(v) for v in rng.integers(1, 70, 2))
            if bits == 1:
                s = np.repeat((rng.random((h, w, n)) < 0.3)[:, ::5], 5, axis=1)[:, :w].astype(np.uint8)
            else:
                s = rng.integers(0, 1 << bits, (h, w, n))
            page = {"samples": s, "bits": bits, "photometric": photometric, "compression": compression,
                    "rows_per_strip": int(rng.integers(1, h + 1))}
            if extra:
                page["extra"] = extra
            if photometric == 3:
                page["colormap"] = rng.integers(0, 65536, 3 << bits)
            if layout == "tiles":
                page["tile"] = (16, 32)
            elif layout == "planar":
                if n == 1:
                    continue
                page["planar"] = 2
            elif layout == "fill_order_2":
                page["fill"] = 2
            elif layout == "predictor":
                if bits < 8 or compression in (2, 3, 4):
                    continue
                page["predictor"] = 2
            elif layout == "variant":
                if compression == 3:
                    page["two_d_every"] = int(rng.integers(2, 5))
                elif compression == 5:
                    page["lzw_old"] = True
                else:
                    continue
            data = enc.tiff([page], order=order, big=layout == "bigtiff" and order == "<")
            try:
                want = pil_pages(data)
            except (OSError, ValueError, SyntaxError):
                # a layout Pillow does not read: the port raises too
                with pytest.raises(InvalidDocumentError):
                    decode_tiff_pages(data)
                continue
            got = decode_tiff_pages(data)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.shape == b.shape and np.array_equal(a, b), (photometric, n, bits, extra, layout)
            checked += 1
    assert checked >= 10


def test_ccitt_rle_row_after_an_aligned_row_reads_as_libtiff_reads_it():
    """CCITT RLE rows start on byte boundaries. Where a row fills its last
    byte and the data ends within the next row's lookup, libtiff's
    accumulator counts padding bits and its alignment drops real ones, so
    the last row starts late and ends at an EOL, the rest white; the port
    reads it as libtiff does (Pillow's pages)."""
    row = [0] * 10 + [1] * 4  # ten white then four black: exactly one byte of codes
    for rows in ([row, row], [row, row, row], [[1] * 14, row], [row, [0] * 14]):
        samples = np.array(rows, np.uint8)[..., None]
        data = enc.tiff([{"samples": samples, "bits": 1, "photometric": 0, "compression": 2,
                          "rows_per_strip": len(rows)}])
        assert_pages(data)


def test_big_endian_bigtiff_fails_as_in_pil():
    """Pillow takes a big-endian BigTIFF's header for a classic one and
    cannot open the file; the port raises InvalidDocumentError for it."""
    data = enc.tiff([{"samples": np.zeros((4, 4, 1), np.uint8), "bits": 8}], order=">", big=True)
    with pytest.raises(Exception):
        pil_pages(data)
    with pytest.raises(InvalidDocumentError):
        decode_tiff_pages(data)


def with_tile_size(data: bytes, cw: int, ch: int) -> bytes:
    """A little-endian classic TIFF with its first page's TileWidth and
    TileLength rewritten (as LONGs), its tile data left as they are."""
    data = bytearray(data)
    ifd = struct.unpack_from("<I", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        pos = ifd + 2 + 12 * k
        tag = struct.unpack_from("<H", data, pos)[0]
        if tag in (322, 323):
            struct.pack_into("<HHII", data, pos, tag, 4, 1, cw if tag == 322 else ch)
    return bytes(data)


# (rows, columns) of the page, the tile's (width, length) in its tags; its data fill a 16 x 16 tile
TILE_CASES = [((1, 1), (65536, 65536)), ((1, 3), (4096, 16)), ((2, 3), (16, 4096)), ((2, 3), (4096, 16))]


@pytest.mark.parametrize("case", TILE_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-tile{c[1][0]}x{c[1][1]}")
@pytest.mark.parametrize("bits", [1, 8])
def test_uncompressed_tiles_larger_than_the_page_read_as_pil_reads_them(case, bits):
    """Pillow reads only the rows and columns of an uncompressed tile that
    its page covers, however large the tile says it is, and fails where
    those rows lie past the tile's data; so does the port, without
    allocating the tile."""
    (h, w), tile = case
    samples = (np.arange(h * w).reshape(h, w, 1) % 2).astype(np.uint8) * (1 if bits == 1 else 200)
    data = with_tile_size(enc.tiff([{"samples": samples, "bits": bits, "photometric": 0 if bits == 1 else 1,
                                     "tile": (16, 16)}]), *tile)
    fits = (h - 1) * (tile[0] * bits // 8) + (w * bits + 7) // 8 <= 16 * 16 * bits // 8
    if not fits:
        with pytest.raises(Exception):
            pil_pages(data)
        with pytest.raises(InvalidDocumentError, match="truncated"):
            decode_tiff_pages(data)
        return
    tracemalloc.start()
    try:
        assert_pages(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 22


@pytest.mark.parametrize("compression", [5, 8, 32773])
def test_compressed_tiles_far_larger_than_the_page_raise_before_allocating(compression):
    """A compressed tile decodes whole. One of 8192 x 8192 on a 2 x 3 page,
    whose data fill a 16 x 16 tile, fails in PIL (libtiff finds too little
    data); the port refuses it from its tags, before it allocates it."""
    data = enc.tiff([{"samples": np.ones((2, 3, 1), np.uint8), "bits": 8, "compression": compression,
                      "tile": (16, 16)}])
    data = with_tile_size(data, 8192, 8192)
    with pytest.raises(Exception):
        pil_pages(data)
    tracemalloc.start()
    try:
        with pytest.raises(InvalidDocumentError, match="larger than the image needs"):
            decode_tiff_pages(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 22
    assert page_count(data) == 1


@pytest.mark.parametrize("tile", [(256, 256), (1024, 1024), (16, 1024)])
@pytest.mark.parametrize("compression", [5, 8])
def test_compressed_tiles_larger_than_a_small_page_match_pil(tile, compression):
    """Tiles up to a megapixel larger than their page, as encoders write
    them for small images, decode as PIL decodes them."""
    rng = np.random.default_rng(sum(tile) + compression)
    samples = rng.integers(0, 256, (7, 10, 3))
    assert_pages(enc.tiff([{"samples": samples, "bits": 8, "photometric": 2, "compression": compression,
                            "tile": tile}]))


def test_pages_of_a_long_chain_walk_the_chain_once(monkeypatch):
    """Decoding every page of a multi-page TIFF reads each directory twice
    at most (the walk, then the page), not once a page for each page
    before it."""
    from dial_rag_tpu_torch.image_processor import tiff

    pages = [{"samples": np.full((2, 2, 1), k, np.uint8), "bits": 8} for k in range(60)]
    data = enc.tiff(pages)
    calls = []
    real = tiff._directory
    monkeypatch.setattr(tiff, "_directory", lambda *a: calls.append(a[3]) or real(*a))
    got = decode_tiff_pages(data)
    assert [int(p[0, 0, 0]) for p in got] == list(range(60))
    assert len(calls) <= 2 * len(pages)


# -- documents ----------------------------------------------------------------------

def multipage(rng) -> bytes:
    pages = [Image.fromarray(photo(30 + 7 * k, 40 + 5 * k, seed=int(rng.integers(1 << 20)))) for k in range(4)]
    pages[1] = pages[1].convert("L")
    pages[3] = pages[3].convert("1")
    buf = io.BytesIO()
    pages[0].save(buf, "TIFF", save_all=True, append_images=pages[1:], compression="tiff_lzw")
    return buf.getvalue()


@pytest.mark.parametrize("seed", range(3))
def test_tiff_documents_match_the_jax_package(seed):
    """Page counts, pages (all, reordered, scaled) and chunks of multi-page
    TIFFs, as the JAX package gives them."""
    rng = np.random.default_rng(3000 + seed)
    data = multipage(rng) if seed < 2 else enc.tiff(
        [{"samples": rng.integers(0, 256, (20, 30, 3)), "bits": 8, "photometric": 2, "compression": 8},
         {"samples": fax_page(rng, 40, 200)[..., None].astype(np.uint8), "bits": 1, "photometric": 0,
          "compression": 4}], big=True)
    mime = "image/tiff"
    n = jax_number_of_pages(mime, data)
    assert extract_number_of_pages(mime, data) == n
    for numbers, size in ((None, None), ([n, 1], None), (None, 64)):
        ref = [np.asarray(p) for p in jax_pages(mime, data, numbers, size)]
        got = _extract_pages_sync(mime, data, numbers, size)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and int(np.abs(a.astype(int) - b).max()) <= (RESIZE_LEVELS if size else 0)
    with pytest.raises(InvalidDocumentError, match=f"page {n + 1} out of range 1..{n}"):
        _extract_pages_sync(mime, data, [n + 1], None)
    chunks = parse_document(data, mime, source_link="files/a.tif")
    assert [(c.text, c.metadata["page_number"]) for c in chunks] == [("", p) for p in range(1, n + 1)]


def test_directory_chain_that_loops_counts_as_pillow_counts():
    """A last directory that points back at an earlier one ends the chain
    (Pillow's n_frames), in the port as in the JAX package."""
    data = bytearray(multipage(np.random.default_rng(5)))
    offsets = [struct.unpack_from("<I", data, 4)[0]]
    while True:
        count = struct.unpack_from("<H", data, offsets[-1])[0]
        link = offsets[-1] + 2 + 12 * count
        following = struct.unpack_from("<I", data, link)[0]
        if not following:
            break
        offsets.append(following)
    struct.pack_into("<I", data, link, offsets[1])
    data = bytes(data)
    assert page_count(data) == jax_number_of_pages("image/tiff", data) == len(offsets)


# -- what the port leaves out ----------------------------------------------------------

NOT_PORTED = {"old-style JPEG": {"compression": 6}, "LZMA": {"compression": 34925}, "ZSTD": {"compression": 50000},
              "WebP": {"compression": 50001}, "SGILog": {"compression": 34676},
              "ThunderScan": {"compression": 32809}, "float predictor": {"compression": 8, "predictor": 3},
              "YCbCr": {"photometric": 6, "n": 3}, "CIE L*a*b*": {"photometric": 8, "n": 3},
              "12-bit": {"bits": 16, "bits_tag": 12}}


@pytest.mark.parametrize("kind", sorted(NOT_PORTED))
def test_formats_left_out_raise_item_9d(kind):
    spec = dict(NOT_PORTED[kind])
    n = spec.pop("n", 1)
    page = {"samples": np.zeros((4, 6, n), np.uint8), "bits": spec.pop("bits", 8), **spec}
    data = enc.tiff([page])
    assert page_count(data) == 1
    with pytest.raises(NotPortedError, match="9d"):
        decode_tiff_pages(data)
    with pytest.raises(NotPortedError, match="9d"):
        _extract_pages_sync("image/tiff", data, None, None)


# -- magic ---------------------------------------------------------------------------

MAGIC = {"tiff_le": b"II*\x00\x08\x00\x00\x00", "tiff_be": b"MM\x00*\x00\x00\x00\x08",
         "bigtiff_le": b"II+\x00\x08\x00\x00\x00" + bytes(8), "bigtiff_be": b"MM\x00+\x00\x08\x00\x00" + bytes(8),
         "tiff_swapped": b"MM*\x00\x00\x00\x00\x08", "webp": b"RIFF\x1a\x00\x00\x00WEBPVP8L" + bytes(10),
         "webp_other_chunk": b"RIFF\x1a\x00\x00\x00WEBPXXXX" + bytes(10), "riff_wave": b"RIFF\x24\x00\x00\x00WAVEfmt ",
         "riff_short": b"RIFF\x04\x00\x00\x00WEB"}


@pytest.mark.parametrize("name", sorted(MAGIC))
@pytest.mark.parametrize("declared", [None, "image/tiff", "application/octet-stream"])
def test_sniff_and_detect_mime_match_the_jax_package(name, declared):
    """The port's mime sniffing on TIFF (both byte orders, BigTIFF), WebP and
    RIFF files that are not WebP: the JAX package's answers, by magic, by
    declared type and by file name."""
    data = MAGIC[name]
    same(lambda P: P.m("documents.mime").sniff_mime(data))
    for file_name in (None, "scan.tif", "photo.webp", "sound.wav"):
        same(lambda P: P.m("documents.mime").detect_mime(declared, file_name, data))
