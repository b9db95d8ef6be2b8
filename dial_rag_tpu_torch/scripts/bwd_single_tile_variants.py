"""Reads how the bf16 single-tile backward (TPU kernel 8 in bf16,
``single_tile_bwd_tc_kernel`` in ``csrc/flash_attention_bwd.cu``) writes
its gradients on the card: as built, dQ, dK and dV are rounded into
staging tiles in shared memory and written out 16 bytes a store; the
variant ``per_value_stores`` writes each value from its fragment
(``tc::store_rows``, two bytes a store), as the blocked backwards do. It
builds ``csrc/flash_attention_bwd.cu`` from the sources as they are and
with that text substituted.

At [32, 12, S, Dh] for S = 128 and 64 and head_dim 32 and 64 (a ragged
row and a fully masked one, chip_smoke.py's ``attention_inputs``) each
build is held against ``attention_backward_plain`` (3e-2 of each batch
row's largest plain gradient) and the two builds against each other (the
same bits), then timed by the kernel's device time in turns: as built,
variant, variant, as built.

    python3 dial_rag_tpu_torch/scripts/bwd_single_tile_variants.py

One JSON line per shape; the card's name and power limit first. Builds go
to the gitignored ``dial_rag_tpu_torch/_build/bwd_single_tile_variants/``.
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
SOURCE = "flash_attention_bwd.cu"  # the text substituted, and the source built
STEM = "flash_attention_bwd"
STAGED = """  __syncthreads();

  // the three gradients through staging tiles in place of q, k and v, out
  // in 16-byte stores
  store_tile_bf16(s_q, kLd, dq_acc, s);
  store_tile_bf16(s_k, kLd, dk_acc, s);
  store_tile_bf16(s_v, kLd, dv_acc, s);
  __syncthreads();
  store_staged<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, s_q, s);
  store_staged<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, s_k, s);
  store_staged<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, s_v, s);
"""
PER_VALUE = """  tc::store_rows<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, 16 * warp, s, dq_acc);
  tc::store_rows<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, 16 * warp, s, dk_acc);
  tc::store_rows<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, 16 * warp, s, dv_acc);
"""
BF16_GRAD_REL = 3e-2


def _swap(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"{SOURCE} holds {text.count(old)} copies of {old!r}, not {count}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """Each variant's text of the source."""
    return {"per_value_stores": _swap(src, STAGED, PER_VALUE, 1)}


def build(dirs: dict, out: Path) -> dict:
    """name -> csrc directory, built in parallel: name -> ctypes library."""
    from dial_rag_tpu_torch.ops import _build

    procs = {}
    for name, csrc in dirs.items():
        lib = out / f"lib_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=_build._NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{err}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES[STEM].items():
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
    from dial_rag_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels = _build.build_kernels()
    out = _build._BUILD_ROOT / "bwd_single_tile_variants"
    shutil.rmtree(out, ignore_errors=True)
    dirs = {}
    for name, text in variants((_build._CSRC / SOURCE).read_text()).items():
        dirs[name] = out / name
        shutil.copytree(_build._CSRC, dirs[name])
        (dirs[name] / SOURCE).write_text(text)
    libs = {"as_built": kernels.libs[STEM], **build(dirs, out)}
    for dh in (32, 64):
        for s in (128, 64):
            qkv, mask, cot = smoke.attention_inputs(torch, "cuda", 32, s, 12, dh, seed=3 + s, dtype=torch.bfloat16)
            q, k, v = (t.contiguous() for t in fa._split_heads(qkv, 12))
            do = cot.view(32, s, 12, dh).transpose(1, 2).contiguous().to(torch.bfloat16)
            want = fa.attention_backward_plain(q, k, v, do, mask)
            got, rel = {}, {}
            for name, lib in libs.items():
                kernels.libs[STEM] = lib
                got[name] = [torch.empty_like(t) for t in (q, k, v)]
                fa._backward_kernel(q, k, v, do, *got[name], mask)
                torch.cuda.synchronize()
                rel[name] = max(((a[r].float() - w[r].float()).abs().max() / w[r].float().abs().max()).item()
                                for a, w in zip(got[name], want) for r in range(32))
                if not rel[name] <= BF16_GRAD_REL:
                    raise RuntimeError(f"{name} at S={s}, head_dim {dh}: {rel[name]} of a row's largest gradient")
            same = all(torch.equal(a, b) for a, b in zip(*got.values()))
            times = []
            for name in ("as_built", "per_value_stores", "per_value_stores", "as_built"):
                kernels.libs[STEM] = libs[name]
                grads = got[name]
                times.append([name, smoke.kernel_device_ms(
                    torch, lambda: fa._backward_kernel(q, k, v, do, *grads, mask), "single_tile_bwd_tc", iters=50)])
            print(json.dumps({"shape": [32, 12, s, dh], "rel_to_plain": rel, "same_bits": same,
                              "device_ms": times}), flush=True)
            if not same:
                raise RuntimeError(f"the builds differ at S={s}, head_dim {dh}")
    kernels.libs[STEM] = libs["as_built"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
