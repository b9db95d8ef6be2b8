"""Runs one call through the JAX package and through its PyTorch port and
compares what comes out: values (dataclasses field by field), or the
exception's class name, message and module (the port's own class, at the
same place in its package)."""

import dataclasses
import importlib
import math

JAX, PORT = "dial_rag_tpu", "dial_rag_tpu_torch"


class Pkg:
    """One package: ``P.m("documents.parser")`` is its module."""

    def __init__(self, root: str):
        self.root = root

    def m(self, path: str):
        return importlib.import_module(f"{self.root}.{path}")


def plain(obj):
    """A comparable form: dataclasses as (class name, fields), containers
    element by element, NaN as a string."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [plain(x) for x in obj])
    if isinstance(obj, dict):
        return {k if isinstance(k, (str, int, bytes)) else repr(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    return obj


def outcome(root: str, call):
    try:
        return ("ok", plain(call(Pkg(root))))
    except Exception as e:  # noqa: BLE001 - the exception is what is compared
        module = type(e).__module__
        module = module.replace(PORT, "PKG") if root == PORT else module.replace(JAX, "PKG")
        return ("raise", type(e).__name__, str(e), module)


def same(call):
    """``call(P)`` in both packages; asserts equal outcomes and returns
    the port's."""
    ref, got = outcome(JAX, call), outcome(PORT, call)
    assert got == ref
    return got
