"""Huffman JPEG without PIL: the host core ``native/jpeg.cpp`` (built and
loaded by ``native/build.py``; a failed build raises) decodes sequential
and progressive JPEGs, and this module gives its samples the RGB that
``Image.open(...).convert("RGB")`` gives: gray repeated, CMYK (read
inverted, as Pillow reads it) through Pillow's ``cmyk2rgb``. Lossless,
hierarchical and arithmetic-coded JPEGs, 12-bit samples, and progressive
JPEGs that leave low AC coefficients unrefined (which libjpeg smooths),
raise ``NotPortedError`` (ROADMAP item 9d)."""

import ctypes

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError, NotPortedError
from dial_rag_tpu_torch.native.build import load_native

_UNSUPPORTED = 2


def _check(status: int) -> None:
    if status == _UNSUPPORTED:
        raise NotPortedError(
            "Lossless, hierarchical, arithmetic-coded and 12-bit JPEG images, and progressive ones that "
            "leave low AC coefficients unrefined, are not ported yet (ROADMAP item 9d)"
        )
    if status:
        raise InvalidDocumentError("The JPEG image is corrupt")


def read_header(data: bytes) -> tuple[int, int, int]:
    """(width, height, channels) of a JPEG: channels is 1 (L), 3 (RGB) or
    4 (CMYK)."""
    info = (ctypes.c_int * 3)()
    _check(load_native("jpeg").dial_jpeg_info(data, len(data), info))
    return info[0], info[1], info[2]


def decode_jpeg_raw(data: bytes) -> np.ndarray:
    """The decoded samples ([H, W, channels] uint8) in the mode Pillow
    opens the JPEG in: L, RGB or CMYK."""
    width, height, channels = read_header(data)
    out = np.empty((height, width, channels), dtype=np.uint8)
    _check(load_native("jpeg").dial_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes))
    return out


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's CMYK -> RGB: with nk = 255 - K, each channel is
    nk - MULDIV255(C, nk), MULDIV255 rounding a product / 255."""
    nk = 255 - cmyk[..., 3:4].astype(np.int32)
    t = cmyk[..., :3].astype(np.int32) * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """The RGB pixels ([H, W, 3] uint8) of a sequential or progressive JPEG."""
    samples = decode_jpeg_raw(data)
    if samples.shape[2] == 1:
        return np.repeat(samples, 3, axis=2)
    if samples.shape[2] == 4:
        return cmyk_to_rgb(samples)
    return samples
