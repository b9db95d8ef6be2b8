"""Builds the hand-written CUDA kernels in ``csrc/`` and loads them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). All sources compile in parallel, at
first use, into ``dial_rag_tpu_torch/_build/<hash>/`` where the hash
covers every source and the flags. A library is written under a temporary
name and renamed into place, so a build that was cut off leaves no file
that a later run would take for a finished one, and no lock.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_ROOT = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_NVCC_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points, by source stem
SIGNATURES = {
    "fused_attention": {
        "dial_attention_block_bf16": [_P] * 11 + [_I, _I, _I, _F, _P],
    },
    "fused_ffn": {
        "dial_ffn_block_bf16": [_P] * 8 + [_I, _I, _P],
    },
}


@dataclass
class KernelBuild:
    libs: dict  # source stem -> ctypes.CDLL
    seconds: float  # wall time of this process's build (0 when cached)
    ptxas: dict  # source stem -> the -Xptxas -v report lines


_lock = threading.Lock()
_loaded: KernelBuild | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(found):
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def _ptxas_lines(stderr: str) -> list[str]:
    return [
        line.strip()
        for line in stderr.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]


def build_kernels() -> KernelBuild:
    """Builds (once per source hash) and loads every kernel library."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        out_dir = _BUILD_ROOT / _source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for stem in SIGNATURES:
            target = out_dir / f"lib{stem}.so"
            if target.is_file():
                continue
            tmp = out_dir / f"lib{stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")]
            procs[stem] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
                ),
                tmp,
                target,
            )
        ptxas = {}
        failures = []
        for stem, (proc, tmp, target) in procs.items():
            try:
                out, err = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                failures.append(f"{stem}: nvcc timed out after {_NVCC_TIMEOUT_S} s")
                continue
            if proc.returncode != 0:
                failures.append(f"{stem}: nvcc exit {proc.returncode}\n{out}{err}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, target)
            ptxas[stem] = _ptxas_lines(err)
            (out_dir / f"{stem}.ptxas.txt").write_text(err)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        seconds = time.perf_counter() - t0 if procs else 0.0
        libs = {}
        for stem, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
            for name, argtypes in fns.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            libs[stem] = lib
            if stem not in ptxas:
                report = out_dir / f"{stem}.ptxas.txt"
                ptxas[stem] = (
                    _ptxas_lines(report.read_text()) if report.is_file() else []
                )
        _loaded = KernelBuild(libs=libs, seconds=seconds, ptxas=ptxas)
        return _loaded
