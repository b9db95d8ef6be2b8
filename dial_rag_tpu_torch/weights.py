"""Parameter conversion from the JAX package's layout.

The port keeps the reference's parameter tree (nested dicts and lists,
dense kernels [in, out]), so conversion is leaf by leaf: each array,
given as numpy, becomes an f32 CPU tensor. Tests use it to feed both
implementations the same weights.
"""

import numpy as np
import torch


def params_from_jax_numpy(tree):
    """A JAX parameter pytree whose leaves are numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) -> the port's parameter dict."""
    if isinstance(tree, dict):
        return {k: params_from_jax_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))
