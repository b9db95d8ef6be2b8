"""The ctypes signatures of the port's CUDA entry points, on the CPU.

``ops/_build.py::SIGNATURES`` gives ctypes each entry point's parameter
types. A pointer declared as ``c_int`` is cut to 32 bits and faults far
from the cause on the card, where nothing here can build or call the
library. So every ``extern "C"`` declaration of ``csrc/*.cu`` is parsed
and held against its signature, parameter by parameter: a pointer is
``c_void_p``, an ``int`` ``c_int``, a ``float`` ``c_float``. Every entry
point needs a signature under its source's stem and every signature an
entry point. The scripts that build variants of a source by text
substitution (``dial_rag_tpu_torch/scripts/*_variants.py``) must still
find every text they replace.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import pytest

from dial_rag_tpu_torch.ops._build import SIGNATURES

CSRC = Path(__file__).resolve().parent.parent / "dial_rag_tpu_torch" / "csrc"
_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(param: str):
    """The ctypes type of one C parameter declaration."""
    if "*" in param:
        return ctypes.c_void_p
    kind = param.split()[-2]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _declared() -> dict:
    """(stem, entry point) -> its parameters' ctypes types, from the sources."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in _DECL.findall(path.read_text()):
            found[(path.stem, name)] = [_ctype(p) for p in params.split(",")]
    return found


DECLARED = _declared()
SIGNED = {(stem, name): argtypes for stem, fns in SIGNATURES.items() for name, argtypes in fns.items()}


@pytest.mark.parametrize("stem,name", sorted(set(DECLARED) | set(SIGNED)), ids=lambda v: v)
def test_entry_point_signature_matches_its_declaration(stem, name):
    assert (stem, name) in DECLARED, f"SIGNATURES names {stem}.{name}, which csrc/{stem}.cu does not declare"
    assert (stem, name) in SIGNED, f"csrc/{stem}.cu declares {name}, which SIGNATURES lacks"
    assert SIGNED[(stem, name)] == DECLARED[(stem, name)]


SCRIPTS = CSRC.parent / "scripts"


@pytest.mark.parametrize(
    "script", ["kv_blocked_bwd_variants", "kv_blocked_fwd_variants", "gemm_tf32_variants", "bwd_single_tile_variants"]
)
def test_variant_script_finds_its_targets(script):
    """Each variant's substitutions match the source as many times as the
    script expects (``_swap`` raises otherwise), and change it."""
    spec = importlib.util.spec_from_file_location(script, SCRIPTS / f"{script}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    source = (CSRC / module.SOURCE).read_text()
    texts = module.variants(source)
    assert texts and all(text != source for text in texts.values())
