"""Writes ``dial_rag_tpu_torch/image_processor/_ycbcr.py``: Pillow's
YCbCr -> RGB conversion (``ImagingConvertYCbCr2RGB``) as integer tables,
read back from Pillow itself. For each Y, Cb and Cr, Pillow gives
R = clip(Y + R_CR[Cr]), B = clip(Y + B_CB[Cb]) and
G = clip(Y + ((G_CB[Cb] + G_CR[Cr]) >> 6)); the R and B offsets are read
off directly, the two G tables solved from the 65536 (Cb, Cr) offsets as
a system of difference constraints (any solution reproduces Pillow's G
exactly; ``tests/test_torch_jpeg2000.py`` checks every Cb, Cr pair).
Run from the repository root: ``python -m tests.utils.make_ycbcr_tables``.
"""

from pathlib import Path

import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parents[2] / "dial_rag_tpu_torch" / "image_processor" / "_ycbcr.py"


def pillow_rgb(y: int) -> np.ndarray:
    """[cb, cr, 3] Pillow's RGB of (y, cb, cr) for every cb, cr."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
    return np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB")).astype(np.int64)


def offsets() -> np.ndarray:
    """[cb, cr, 3]: the t with clip(y + t) equal to Pillow's channel at every y."""
    outs = np.stack([pillow_rgb(y) for y in range(256)])
    ys = np.arange(256)[:, None, None, None]
    found = np.full(outs.shape[1:], 999)
    for t in range(-300, 301):
        ok = (np.clip(ys + t, 0, 255) == outs).all(axis=0)
        found = np.where(ok & (found == 999), t, found)
    if (found == 999).any():
        raise RuntimeError("Pillow's YCbCr conversion is no offset per (Cb, Cr)")
    return found


def tables() -> dict[str, list[int]]:
    off = offsets()
    g = off[..., 1]
    # A[cb] + B[cr] in [64 g, 64 g + 63]: shortest paths over the constraint graph
    a = np.zeros(256, np.int64)
    c = np.zeros(256, np.int64)  # c = -B
    for _ in range(10000):
        na = np.minimum(a, (c[None, :] + 64 * g + 63).min(axis=1))
        nc = np.minimum(c, (na[:, None] - 64 * g).min(axis=0))
        if (na == a).all() and (nc == c).all():
            break
        a, c = na, nc
    b = -c
    a, b = a - a[128], b + a[128]
    if not (((a[:, None] + b[None, :]) >> 6) == g).all():
        raise RuntimeError("no tables reproduce Pillow's G")
    return {"R_CR": off[0, :, 0].tolist(), "B_CB": off[:, 0, 2].tolist(), "G_CB": a.tolist(), "G_CR": b.tolist()}


def main() -> None:
    lines = ['"""Pillow\'s YCbCr -> RGB (``ImagingConvertYCbCr2RGB``) as tables:',
             "R = clip(Y + R_CR[Cr]), G = clip(Y + ((G_CB[Cb] + G_CR[Cr]) >> 6)),",
             "B = clip(Y + B_CB[Cb]). Written by ``python -m tests.utils.make_ycbcr_tables``",
             '(read back from Pillow); do not edit."""', ""]
    for name, values in tables().items():
        lines.append(f"{name} = (")
        for i in range(0, 256, 16):
            lines.append("    " + ", ".join(str(v) for v in values[i:i + 16]) + ",")
        lines.append(")")
    OUT.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
