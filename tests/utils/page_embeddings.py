"""The scripted multimodal embedding of a page image: a continuous
function of its decoded pixels (a fixed seeded projection of the ink of
its GRID x GRID area means, normalised), so pages that render alike get
nearby embeddings and no quantisation edge splits them. It depends on
the pixels, never on the PNG's bytes, so two renderers whose pages agree
within the render tolerance get nearby vectors. numpy only: the card's
smoke run loads it from its file beside the standard-library fake Dial
Core."""

import numpy as np

GRID = 16
SEED = 25


def coarse_embedding(rgb: np.ndarray, dim: int) -> np.ndarray:
    """``rgb`` ([H, W, 3] uint8, H and W at least GRID) as a unit vector
    of ``dim`` floats."""
    ink = 1.0 - rgb.astype(np.float64).mean(axis=2) / 255.0
    h, w = ink.shape
    ys = np.arange(GRID + 1) * h // GRID
    xs = np.arange(GRID + 1) * w // GRID
    # area means through a summed-area table
    table = np.zeros((h + 1, w + 1))
    table[1:, 1:] = ink.cumsum(axis=0).cumsum(axis=1)
    sums = table[ys[1:]][:, xs[1:]] - table[ys[:-1]][:, xs[1:]] - table[ys[1:]][:, xs[:-1]] + table[ys[:-1]][:, xs[:-1]]
    means = sums / np.outer(np.diff(ys), np.diff(xs))
    projection = np.random.default_rng(SEED).standard_normal((GRID * GRID, dim))
    vec = means.reshape(-1) @ projection
    return vec / max(np.linalg.norm(vec), 1e-12)
