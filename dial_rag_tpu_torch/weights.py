"""Parameter trees: conversion to and from the JAX package's layout.

The port keeps the reference's parameter tree (nested dicts and lists,
dense kernels [in, out]), so conversion is leaf by leaf: each array,
given as numpy, becomes an f32 CPU tensor. Tests use it to feed both
implementations the same weights.
"""

import numpy as np
import torch


def map_params(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def params_from_jax_numpy(tree):
    """A JAX parameter pytree whose leaves are numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) -> the port's parameter dict."""
    return map_params(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)


def params_to_numpy(tree):
    """The port's parameter dict -> the same tree with numpy f32 leaves
    (the inverse of ``params_from_jax_numpy``): a copy, which a later
    update of the params leaves as it was."""
    return map_params(lambda t: t.detach().to("cpu", torch.float32, copy=True).numpy(), tree)


def param_leaves(tree) -> list:
    """The leaf tensors of a parameter dict in a fixed order (dict keys
    sorted, lists in order): the optimizer's parameter list, so its state
    lines up across a checkpoint save and restore."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in param_leaves(v)]
    return [tree]
