"""Writes the baseline JPEG fixtures of ``tests/data/jpeg/`` and PIL's
decode of each (``decoded.npz``, ``Image.open(...).convert("RGB")``), so
that a machine without PIL (the card's, in chip_smoke.py) can hold the
port's native JPEG decoder against PIL. The images are seeded arrays
written by PIL at the qualities, samplings and restart intervals named in
FIXTURES. Run from the repository root:
``python -m tests.utils.make_jpeg_fixtures``.
"""

import io
from pathlib import Path

import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parents[1] / "data" / "jpeg"
# name: (height, width, mode, save options)
FIXTURES = {
    "photo_420_q80": (120, 160, "RGB", {"quality": 80, "subsampling": 2}),
    "photo_444_q92_restart": (61, 93, "RGB", {"quality": 92, "subsampling": 0, "restart_marker_blocks": 2}),
    "photo_422_q85": (288, 384, "RGB", {"quality": 85, "subsampling": 1}),
    "gray_q60": (45, 60, "L", {"quality": 60}),
    "cmyk_q85": (45, 60, "CMYK", {"quality": 85}),
}


def photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 13.0), 128 + 90 * np.cos(x / 5.0 - y / 9.0),
                    (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    decoded = {}
    for seed, (name, (h, w, mode, options)) in enumerate(sorted(FIXTURES.items())):
        buf = io.BytesIO()
        Image.fromarray(photo(h, w, seed)).convert(mode).save(buf, format="JPEG", **options)
        data = buf.getvalue()
        (OUT / f"{name}.jpg").write_bytes(data)
        decoded[name] = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.savez_compressed(OUT / "decoded.npz", **decoded)


if __name__ == "__main__":
    main()
