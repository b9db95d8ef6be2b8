"""LANCZOS resampling without PIL, as Pillow's ``Image.resize(size,
Image.LANCZOS)`` computes it for 8-bit images (``libImaging/Resample.c``),
on numpy, and the proportional ``resize_image`` of the JAX package's
``image_processor/resize.py`` (the largest side to ``scaled_size``; never
upscales).

Per output pixel: the filter sinc(x) sinc(x / 3) on |x| < 3, widened by
the scale factor when downscaling, its taps normalised to sum 1 and
rounded to 22-bit fixed point; the horizontal pass first (only over the
rows the vertical pass reads), each value rounded and clipped to uint8,
then the vertical pass."""

import numpy as np

SUPPORT = 3.0
PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        safe = np.where(v == 0.0, 1.0, v * np.pi)
        return np.where(v == 0.0, 1.0, np.sin(safe) / safe)

    return np.where((-SUPPORT <= x) & (x < SUPPORT), sinc(x) * sinc(x / 3.0), 0.0)


def _coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first input index [out], window length [out], fixed-point taps
    [out, ksize]); taps past an output's window are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _lanczos((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << PRECISION_BITS))).astype(np.int64)
    return xmin, xmax, fixed


def _pass(image: np.ndarray, xmin: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """One resampling pass along ``axis`` (0 rows, 1 columns) of an
    [H, W, C] uint8 array."""
    size = image.shape[axis]
    # int32 sums, as Pillow's: the taps' magnitudes sum to well under
    # 2 ** 31 / (255 << PRECISION_BITS)
    acc = np.full(image.shape[:axis] + (len(xmin),) + image.shape[axis + 1:], 1 << (PRECISION_BITS - 1),
                  dtype=np.int32)
    for k in range(taps.shape[1]):
        weight = taps[:, k]
        if not weight.any():
            continue
        index = np.minimum(xmin + k, size - 1)
        shape = [1, 1, 1]
        shape[axis] = len(xmin)
        acc += np.take(image, index, axis=axis) * weight.astype(np.int32).reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``image`` ([H, W, C] uint8) resampled to [height, width, C]."""
    h, w = image.shape[:2]
    if (w, h) == (width, height):
        return image.copy()
    ymin, ycount, ytaps = _coefficients(h, height)
    out = image
    if width != w:
        # only the rows the vertical pass reads
        first, last = int(ymin[0]), int(ymin[-1] + ycount[-1])
        xmin, _, xtaps = _coefficients(w, width)
        out = _pass(image[first:last], xmin, xtaps, axis=1)
        ymin = ymin - first
    if height != h:
        out = _pass(out, ymin, ytaps, axis=0)
    return np.ascontiguousarray(out)


def resize_image(image: np.ndarray, scaled_size: int) -> np.ndarray:
    """Scale so that the largest side equals ``scaled_size``; never
    upscales."""
    height, width = image.shape[:2]
    largest = max(width, height)
    if largest <= scaled_size:
        return image
    ratio = scaled_size / largest
    return resize_lanczos(image, max(int(width * ratio), 1), max(int(height * ratio), 1))
