"""Page image -> base64 PNG (mirror of the JAX package's
``image_processor/base64_utils.py`` on arrays: ``png.py`` in place of
PIL)."""

import base64

import numpy as np

from dial_rag_tpu_torch.image_processor.png import encode_png


def image_as_base64(image: np.ndarray) -> str:
    """``image`` ([H, W, 3] uint8) as base64 PNG."""
    return base64.b64encode(encode_png(image)).decode("ascii")

