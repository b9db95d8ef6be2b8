"""JPEG without PIL: the host core ``native/jpeg.cpp`` (built and loaded by
``native/build.py``; a failed build raises) decodes every coding
libjpeg-turbo 3.1 reads at 8 bits (sequential and progressive Huffman and
arithmetic coding, lossless Huffman, with libjpeg's block smoothing of
progressive images left partly refined), and this module gives its
samples the RGB that ``Image.open(...).convert("RGB")`` gives: gray
repeated, CMYK (read inverted, as Pillow reads it) through Pillow's
``cmyk2rgb``. What Pillow or libjpeg-turbo refuse (a precision other than
8, 2 components, the hierarchical processes, lossless arithmetic coding,
an arithmetic scan past the 64 KiB Pillow hands libjpeg at once) raises
``InvalidDocumentError``, as the JAX package fails on it."""

import ctypes

import numpy as np

from dial_rag_tpu_torch.errors import InvalidDocumentError
from dial_rag_tpu_torch.native.build import load_native


def _check(status: int) -> None:
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
    """The RGB pixels ([H, W, 3] uint8) of a JPEG."""
    samples = decode_jpeg_raw(data)
    if samples.shape[2] == 1:
        return np.repeat(samples, 3, axis=2)
    if samples.shape[2] == 4:
        return cmyk_to_rgb(samples)
    return samples
