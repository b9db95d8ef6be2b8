"""Reads how the f32 encoder blocks' split-TF32 product
(``csrc/gemm_tf32.cuh``, TPU kernels 1-3 in f32) sums K on the card: as
built, each 32-deep K slice's products go to a partial that is added to
the sum in f32 (``kSlicePartials``); the variant ``running_sum`` sums
every product in the tensor core's running accumulator. It builds
``csrc/fused_ffn.cu`` (the FFN block and the product's own entry point)
from the sources as they are and with that text substituted.

Each build is read on the product alone at the blocks' shapes (m = 32768:
the QKV projection at bge-small and bge-base widths, K = 384 and 768;
the FFN's down product, K = 1536 and 3072, on GELU outputs) and on the
FFN block at B=128, S=256, H 384 and 768: the largest distance from the
same function evaluated in f64 beside the plain f32 version's (cuBLAS,
TF32 off), and the signed mean of the product's error along the sign of
the exact value (negative: toward zero). Then the FFN block at H 768 and
the K = 3072 product are timed, as built and variant in turns.

    python3 dial_rag_tpu_torch/scripts/gemm_tf32_variants.py

One JSON line per reading; the card's name and power limit first. Builds
go to the gitignored ``dial_rag_tpu_torch/_build/gemm_variants/``.
"""

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this script
sys.path.insert(0, str(HERE))
SOURCE = "gemm_tf32.cuh"  # the text substituted
BUILT = "fused_ffn.cu"  # the source built from it
M = 32768
PRODUCTS = ((384, 1152), (768, 2304), (1536, 384), (3072, 768))  # (K, n)


def _swap(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"{SOURCE} holds {text.count(old)} copies of {old!r}, not {count}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """Each variant's text of the source."""
    return {"running_sum": _swap(src, "constexpr bool kSlicePartials = true;",
                                 "constexpr bool kSlicePartials = false;", 1)}


def build(dirs: dict, out: Path) -> dict:
    """name -> csrc directory, built in parallel: name -> ctypes library."""
    from dial_rag_tpu_torch.ops import _build

    procs = {}
    for name, csrc in dirs.items():
        lib = out / f"lib_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / BUILT)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=_build._NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{err}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES["fused_ffn"].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    import torch

    from dial_rag_tpu_torch.ops import _build
    from dial_rag_tpu_torch.ops import fused_encoder as fe

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels = _build.build_kernels()
    out = _build._BUILD_ROOT / "gemm_variants"
    shutil.rmtree(out, ignore_errors=True)
    dirs = {}
    for name, text in variants((_build._CSRC / SOURCE).read_text()).items():
        dirs[name] = out / name
        shutil.copytree(_build._CSRC, dirs[name])
        (dirs[name] / SOURCE).write_text(text)
    libs = {"as_built": kernels.libs["fused_ffn"], **build(dirs, out)}
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def product(lib, a, w, planes, result):
        k, n = w.shape
        err = lib.dial_gemm_tf32(a.data_ptr(), w.data_ptr(), w.data_ptr(), result.data_ptr(), planes.data_ptr(),
                                 a.shape[0], n, k, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dial_gemm_tf32 returned CUDA error {err}")
        return result

    for k, n in PRODUCTS:
        a = torch.randn(M, k, generator=g)
        if k > 768:  # the FFN's h
            a = torch.nn.functional.gelu(a, approximate="tanh")
        a, w = a.to(dev), (torch.randn(k, n, generator=g) * 0.02).to(dev)
        exact = a.double() @ w.double()
        plain_dist = ((a @ w).double() - exact).abs().max().item()
        planes, result = torch.empty(2 * k * n, device=dev), torch.empty(M, n, device=dev)
        for name, lib in libs.items():
            err = product(lib, a, w, planes, result).double() - exact
            torch.cuda.synchronize()
            print(json.dumps({"reading": "product", "build": name, "m": M, "k": k, "n": n,
                              "vs_f64": err.abs().max().item(), "plain_vs_f64": plain_dist,
                              "signed_mean_along_exact": (err * exact.sign()).mean().item()}), flush=True)
        del a, w, exact, planes, result
        torch.cuda.empty_cache()

    for hid in (384, 768):
        inter = 4 * hid

        def rnd(*shape, scale=0.02):
            return (torch.randn(shape, generator=g) * scale).to(dev)

        x = torch.nn.functional.layer_norm(rnd(128, 256, hid, scale=1.0), (hid,))
        weights = [rnd(hid, inter), rnd(inter), rnd(inter, hid), rnd(hid), 1 + rnd(hid, scale=0.1),
                   rnd(hid, scale=0.1)]
        exact = smoke.f64_ffn_block(x, *weights)
        plain_dist = (fe.fused_ffn_block_plain(x, *weights).double() - exact).abs().max().item()
        for name, lib in libs.items():
            kernels.libs["fused_ffn"] = lib
            got = fe.fused_ffn_block(x, *weights)
            torch.cuda.synchronize()
            print(json.dumps({"reading": "ffn block", "build": name, "shape": [128, 256, hid],
                              "vs_f64": (got.double() - exact).abs().max().item(), "plain_vs_f64": plain_dist}),
                  flush=True)
        if hid == 768:
            times = []
            for name in ("as_built", "running_sum", "running_sum", "as_built"):
                kernels.libs["fused_ffn"] = libs[name]
                times.append([name, smoke.cuda_ms(torch, lambda: fe.fused_ffn_block(x, *weights), iters=10)])
            print(json.dumps({"reading": "ffn block ms", "shape": [128, 256, hid], "ms": times}), flush=True)
            a = weights[0].new_empty(M, 3072).normal_().clamp_(-3, 3)
            w = weights[2]
            planes, result = torch.empty(2 * 3072 * hid, device=dev), torch.empty(M, hid, device=dev)
            times = [[name, smoke.cuda_ms(torch, lambda: product(libs[name], a, w, planes, result), iters=10)]
                     for name in ("as_built", "running_sum", "running_sum", "as_built")]
            print(json.dumps({"reading": "product ms (split included)", "m": M, "k": 3072, "n": hid,
                              "ms": times}), flush=True)
        del x, weights, exact
        torch.cuda.empty_cache()
    kernels.libs["fused_ffn"] = libs["as_built"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
