"""Reads the register choice of the bf16 tensor-core backward passes
(``csrc/attention_bwd_tc.cuh``) on the card: ``dkv_tc_kernel`` as built
(``__launch_bounds__(128)``: ptxas holds the KV-blocked head_dim 32
instantiation to 128 registers, four blocks an SM, and spills 4 bytes)
against a build with ``__launch_bounds__(128, LSE && DH == 32 ? 3 : 1)``
(no spill at 3 blocks an SM; the other instantiations with a minimum of
one block). Prints each build's ``-Xptxas -v`` lines of ``dkv_tc_kernel``
and times, in turns (as built, variant, variant, as built), the
KV-blocked dK/dV pass at [4, 12, 8192, Dh] and kernel 9 (both passes) at
[4, 12, 4096, Dh], Dh = 32 and 64, in bf16, with whether the two builds
give the same bits.

    python3 dial_rag_tpu_torch/scripts/bwd_tc_min_blocks.py

Builds go to the gitignored ``dial_rag_tpu_torch/_build/min_blocks/``.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this script
sys.path.insert(0, str(HERE))
SOURCE = "attention_bwd_tc.cuh"
BOUNDS = "template <int DH, bool LSE>\n__global__ void __launch_bounds__(tc::kThreads)\n    dkv_tc_kernel("
VARIANT = ("template <int DH, bool LSE>\n__global__ void __launch_bounds__(tc::kThreads, (LSE && DH == 32) ? 3 : 1)\n"
           "    dkv_tc_kernel(")


def main() -> int:
    import torch

    from dial_rag_tpu_torch.ops import _build
    from dial_rag_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels = _build.build_kernels()
    out = _build._BUILD_ROOT / "min_blocks"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build._CSRC, out)
    text = (out / SOURCE).read_text()
    if text.count(BOUNDS) != 1:
        raise RuntimeError(f"{SOURCE} holds {text.count(BOUNDS)} copies of dkv_tc_kernel's launch bounds, not 1")
    (out / SOURCE).write_text(text.replace(BOUNDS, VARIANT))
    lib = out / "libflash_attention_long_bwd.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "flash_attention_long_bwd.cu")],
                          capture_output=True, text=True, timeout=_build._NVCC_TIMEOUT_S)
    if done.returncode:
        raise RuntimeError(f"nvcc exit {done.returncode}\n{done.stderr}")
    for name, lines in (("as built", kernels.ptxas["flash_attention_long_bwd"]), ("variant", _build._ptxas_lines(done.stderr))):
        for i, line in enumerate(lines[:-2]):
            if "dkv_tc_kernel" in line:
                kernel = line[line.index("dkv_tc_kernel"):].split("EEEv")[0]
                print(f"{name}: {kernel}: {lines[i + 2]}; {lines[i + 1]}")
    variant = ctypes.CDLL(str(lib))
    for name, argtypes in _build.SIGNATURES["flash_attention_long_bwd"].items():
        getattr(variant, name).argtypes = argtypes
        getattr(variant, name).restype = ctypes.c_int
    libs = {"as built": kernels.libs["flash_attention_long_bwd"], "variant": variant}

    def ms(fn, iters=10):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    for dh in (32, 64):
        for s in (8192, 4096):
            g = torch.Generator().manual_seed(3)
            q, k, v = fa._split_heads(torch.randn(4, s, 3 * 12 * dh, generator=g).to(dev, torch.bfloat16), 12)
            do = torch.randn(4, s, 12, dh, generator=g).to(dev, torch.bfloat16).transpose(1, 2)
            mask = torch.ones(4, s, dtype=torch.int32, device=dev)
            mask[1, s // 3 :] = 0
            mask[3] = 0
            dq, dk, dv = (torch.empty(t.shape, dtype=torch.bfloat16, device=dev) for t in (q, k, v))
            with torch.no_grad():
                o, lse = fa._forward(q, k, v, mask)
            if lse is not None:
                delta = fa._bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, dq, mask)
                what = "KV-blocked dK/dV pass"

                def fn():
                    fa._bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, dk, dv, mask)
            else:
                what = "kernel 9, both passes"

                def fn():
                    fa._bwd_q_blocked_kernel(q, k, v, do, dq, dk, dv, mask)
            times, outs = {}, {}
            for name in ("as built", "variant", "variant", "as built"):
                kernels.libs["flash_attention_long_bwd"] = libs[name]
                times.setdefault(name, []).append(ms(fn))
                outs.setdefault(name, (dk.clone(), dv.clone()))
            kernels.libs["flash_attention_long_bwd"] = libs["as built"]
            same = all(torch.equal(a, b) for a, b in zip(outs["as built"], outs["variant"]))
            print(f"{what}, bf16 [4, 12, {s}, {dh}]: as built {times['as built']} ms, variant {times['variant']} ms, "
                  f"same bits {same} {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
