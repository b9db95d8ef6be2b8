"""Reads the design choices of the f32 KV-blocked backward (TPU kernels 10
and 11: ``dq_tf32_kernel`` and ``dkv_tf32_kernel`` with ``LSE`` true in
``csrc/flash_attention_long_bwd.cu``) on the card. It builds that source as
it is and as variants made from it by text substitution, each undoing one
decision:

- ``one_accumulator``: dP's small terms summed into its running sum
  (``kDpSmallApart`` false);
- ``apart_at_32``: dP's small terms apart at head_dim 32 too;
- ``chunk_partials``: one compensated partial per 64-row chunk in both
  passes, not one per 32-row half;
- ``plain_dkv``: the dK/dV pass's partials added without compensation;

and, with ``--parent DIR``, the same source of another checkout (the
previous commit unpacked into DIR). Each is read at [4, 12, 8192, Dh], Dh
= 32 and 64, on standard-normal inputs with a full, a padded, a ragged and
a fully masked row, fed the KV-blocked forward's o and lse: its registers
and spill (``-Xptxas -v``), the fully masked row's excess over rtol against
the plain version evaluated in f64 beside the plain f32 version's (the
gate of chip_smoke.py: the kernel's no larger than max(atol, the plain
version's)), the other rows' excess against the plain f32 version, whether
two runs give the same bits, and each pass's CUDA-event time. With
``--parent``, kernel 9 (the query-blocked backward, on the same templates
with ``LSE`` false) is also timed at [4, 12, 4096, Dh], parent and
checkout in turns.

    python3 dial_rag_tpu_torch/scripts/kv_blocked_bwd_variants.py [--parent DIR]

One JSON line per (head width, build); the card's name and power limit
first. Builds go to the gitignored ``dial_rag_tpu_torch/_build/variants/``.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this script
sys.path.insert(0, str(HERE))
SOURCE = "flash_attention_long_bwd.cu"
HEADS, BATCH, SEQ = 12, 4, 8192


def _swap(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"{SOURCE} holds {text.count(old)} copies of {old!r}, not {count}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """Each variant's text of the source."""
    apart = "constexpr bool kDpSmallApart = LSE && DH == 64;"
    loop = "#pragma unroll\n    for (int hf = 0; hf < 2; ++hf) {\n      const float* q_rows"
    chunk = _swap(src, "if (LSE || hf == 1) add_partial<true, DH>(acc, comp, part);",
                  "if (hf == 1) add_partial<true, DH>(acc, comp, part);")
    chunk = _swap(chunk, loop, "    float dv_part[DH / 8][4] = {}, dk_part[DH / 8][4] = {};\n" + loop)
    for part, tile, rows, grad in (("dv_part", "p", "do_rows", "dv"), ("dk_part", "ds", "q_rows", "dk")):
        chunk = _swap(chunk, "      {\n        float part[DH / 8][4] = {};\n"
                      f"        tf32::accumulate_pairs<kHalfTiles, DH>(part, {tile}, {rows});\n"
                      f"        add_partial<LSE, DH>({grad}_sum, {grad}_comp, part);\n      }}\n",
                      f"      tf32::accumulate_pairs<kHalfTiles, DH>({part}, {tile}, {rows});\n"
                      f"      if (hf == 1) add_partial<LSE, DH>({grad}_sum, {grad}_comp, {part});\n")
    return {
        "one_accumulator": _swap(src, apart, "constexpr bool kDpSmallApart = false;"),
        "apart_at_32": _swap(src, apart, "constexpr bool kDpSmallApart = LSE;"),
        "chunk_partials": chunk,
        "plain_dkv": _swap(src, "add_partial<LSE, DH>(", "add_partial<false, DH>(", 2),
    }


def build(builds: dict, out: Path) -> dict:
    """name -> (csrc directory) built in parallel: name -> (ctypes library,
    -Xptxas -v lines of the split-TF32 kernels)."""
    from dial_rag_tpu_torch.ops import _build

    procs = {}
    for name, csrc in builds.items():
        lib = out / f"lib_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=_build._NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{err}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES["flash_attention_long_bwd"].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        lines = _build._ptxas_lines(err)
        resources = {}
        for i in range(len(lines) - 2):
            kernel = re.search(r"d(?:q|kv)_tf32_kernelILi\d+ELb\d", lines[i])
            if kernel:
                resources[kernel.group(0)] = f"{lines[i + 2]}; {lines[i + 1]}"
        libs[name] = (cdll, resources)
    return libs


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="another checkout whose KV-blocked backward is read too")
    args = parser.parse_args()
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
    out = _build._BUILD_ROOT / "variants"
    shutil.rmtree(out, ignore_errors=True)
    dirs = {}
    for name, text in variants((_build._CSRC / SOURCE).read_text()).items():
        dirs[name] = out / name
        shutil.copytree(_build._CSRC, dirs[name])
        (dirs[name] / SOURCE).write_text(text)
    dirs["as_built"] = _build._CSRC
    if args.parent:
        dirs["parent"] = args.parent.resolve() / "dial_rag_tpu_torch" / "csrc"
    libs = build(dirs, out)

    def excess(a, w):
        return ((a - w).abs() - smoke.GRAD_RTOL * w.abs()).max().item()

    dev = torch.device("cuda")
    for dh in (32, 64):
        g = torch.Generator().manual_seed(SEQ)
        q, k, v = fa._split_heads(torch.randn(BATCH, SEQ, 3 * HEADS * dh, generator=g).to(dev), HEADS)
        do = torch.randn(BATCH, SEQ, HEADS, dh, generator=g).to(dev).transpose(1, 2)
        lengths = torch.randint(SEQ // 2, SEQ, (BATCH,), generator=g)
        lengths[0], lengths[1], lengths[-1] = SEQ, SEQ // 3 + 100, 0
        mask = (torch.arange(SEQ)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
        masked = mask.sum(dim=1) == 0
        with torch.no_grad():
            o, lse = fa._forward(q, k, v, mask)
            plain = fa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)
            exact = fa.attention_bwd_kv_blocked_plain(*(t.double() for t in (q, k, v, o)), lse, do.double(), mask)
        plain_masked = [excess(plain[i][masked].double(), exact[i][masked]) for i in range(3)]
        for name in sorted(libs, key=lambda n: (n != "as_built", n)):
            lib, resources = libs[name]
            kernels.libs["flash_attention_long_bwd"] = lib
            grads = [torch.empty(BATCH, HEADS, SEQ, dh, device=dev) for _ in range(3)]

            def dq_pass():
                return fa._bwd_dq_kv_blocked_kernel(q, k, v, o, lse, do, grads[0], mask)

            delta = dq_pass()
            fa._bwd_dkv_kv_blocked_kernel(q, k, v, do, lse, delta, grads[1], grads[2], mask)
            torch.cuda.synchronize()
            first = [t.clone() for t in grads]
            kernel_masked = [excess(grads[i][masked].double(), exact[i][masked]) for i in range(3)]
            others = [excess(grads[i][~masked], plain[i][~masked]) for i in range(3)]
            row = {
                "build": name, "shape": [BATCH, HEADS, SEQ, dh],
                "fully_masked_excess_vs_f64": dict(zip(("dq", "dk", "dv"), kernel_masked)),
                "plain_fully_masked_excess_vs_f64": dict(zip(("dq", "dk", "dv"), plain_masked)),
                "other_rows_excess_vs_plain": dict(zip(("dq", "dk", "dv"), others)),
                "gates_hold": all(x <= smoke.GRAD_ATOL for x in others) and all(
                    kx <= max(smoke.GRAD_ATOL, px) for kx, px in zip(kernel_masked, plain_masked)),
                "dq_ms": smoke.cuda_ms(torch, dq_pass, iters=3, warmup=1),
                "dkv_ms": smoke.cuda_ms(torch, lambda: fa._bwd_dkv_kv_blocked_kernel(
                    q, k, v, do, lse, delta, grads[1], grads[2], mask), iters=3, warmup=1),
                "reproducible": all(torch.equal(a, b) for a, b in zip(first, grads)),
                "resources": {key: val for key, val in resources.items() if f"ILi{dh}E" in key},
            }
            print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, plain, exact, grads
        torch.cuda.empty_cache()
        if args.parent:
            g = torch.Generator().manual_seed(11)
            q, k, v = fa._split_heads(torch.randn(BATCH, 4096, 3 * HEADS * dh, generator=g).to(dev), HEADS)
            do = torch.randn(BATCH, 4096, HEADS, dh, generator=g).to(dev).transpose(1, 2)
            mask = torch.ones(BATCH, 4096, dtype=torch.int32, device=dev)
            mask[1, 1500:] = 0
            grads = [torch.empty(BATCH, HEADS, 4096, dh, device=dev) for _ in range(3)]
            times = []
            for name in ("parent", "as_built", "as_built", "parent"):
                kernels.libs["flash_attention_long_bwd"] = libs[name][0]
                times.append([name, smoke.cuda_ms(
                    torch, lambda: fa._bwd_q_blocked_kernel(q, k, v, do, *grads, mask), iters=3, warmup=1)])
            print(json.dumps({"kernel_9_ms": times, "shape": [BATCH, HEADS, 4096, dh]}), flush=True)
            del q, k, v, do, grads
            torch.cuda.empty_cache()
    kernels.libs["flash_attention_long_bwd"] = libs["as_built"][0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
