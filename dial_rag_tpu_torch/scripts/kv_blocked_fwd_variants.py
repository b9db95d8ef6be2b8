"""Reads how the f32 long-sequence forwards sum Q K^T on the card: the
KV-blocked forward (TPU kernel 7, ``kv_blocked_tf32_kernel`` in
``csrc/flash_attention_long.cu``), which adds each head-width step's
split-TF32 products to the score as a partial in f32 (``kStepPartials``),
and the query-blocked forward (kernel 6, ``q_blocked_tf32_kernel``), which
sums them in the tensor core's running accumulator. It builds that source
as it is and as variants made by text substitution:

- ``running_sum``: kernel 7's Q K^T in the running accumulator, as kernel
  6 sums it;
- ``step_partials_6``: kernel 6's Q K^T with step partials, as kernel 7
  sums it.

Each build is read at [3, 12, S, Dh] (S = 8192 for kernel 7, 4096 for
kernel 6; Dh = 32 and 64; a full, a ragged and a fully masked row) on
standard-normal q, k and v ("normal") and with a score offset that rises
every 512 keys ("rising": q[..., 0] = 1, k[..., 0] = 8 j in block j, so
|q . k| reaches 120 at S = 8192 and the row max rises block by block):
o's and lse's largest distance from the function evaluated in f64 beside
the plain version's, and from the plain version. Then each build is
timed at [1, 12, S, Dh], as built and variant in turns.

    python3 dial_rag_tpu_torch/scripts/kv_blocked_fwd_variants.py

One JSON line per reading; the card's name and power limit first. Builds
go to the gitignored ``dial_rag_tpu_torch/_build/fwd_variants/``.
"""

import ctypes
import importlib.util
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this script
sys.path.insert(0, str(HERE))
SOURCE = "flash_attention_long.cu"
HEADS = 12


def _swap(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"{SOURCE} holds {text.count(old)} copies of {old!r}, not {count}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """Each variant's text of the source."""
    return {
        "running_sum": _swap(src, "tf32_scores<DH, true>(", "tf32_scores<DH, false>(", 1),
        "step_partials_6": _swap(src, "tf32_scores(x, q_warp, sm, st, scale);",
                                 "tf32_scores<DH, true>(x, q_warp, sm, st, scale);", 2),
    }


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
        for fn, argtypes in _build.SIGNATURES["flash_attention_long"].items():
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
    out = _build._BUILD_ROOT / "fwd_variants"
    shutil.rmtree(out, ignore_errors=True)
    dirs = {}
    for name, text in variants((_build._CSRC / SOURCE).read_text()).items():
        dirs[name] = out / name
        shutil.copytree(_build._CSRC, dirs[name])
        (dirs[name] / SOURCE).write_text(text)
    libs = {"as_built": kernels.libs["flash_attention_long"], **build(dirs, out)}
    dev = torch.device("cuda")

    def lse_f64(q, k, mask, dh):
        bias = fa.mask_bias(mask).double()[:, None, None, :]
        kd = k.double().transpose(-1, -2)
        return torch.cat([torch.logsumexp(q[:, :, q0 : q0 + 256].double() @ kd / math.sqrt(dh) + bias, dim=-1)
                          for q0 in range(0, q.shape[2], 256)], dim=2)

    def inputs(b, s, dh, rising, lengths):
        g = torch.Generator().manual_seed(s + dh)
        q, k, v = (t.clone() for t in fa._split_heads(torch.randn(b, s, 3 * HEADS * dh, generator=g).to(dev), HEADS))
        if rising:
            q[..., 0] = 1.0
            k[..., 0] = 8.0 * (torch.arange(s, device=dev) // fa._KV_BLOCK)
        mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(dev, torch.int32)
        return q, k, v, mask

    for dh in (32, 64):
        for kernel, s, builds in ((7, 8192, ("as_built", "running_sum")), (6, 4096, ("as_built", "step_partials_6"))):
            for kind in ("normal", "rising"):
                q, k, v, mask = inputs(3, s, dh, kind == "rising", [s, s - 300, 0])
                with torch.no_grad():
                    exact = fa.attention_q_blocked_plain(q.double(), k.double(), v.double(), mask)
                    exact_lse = lse_f64(q, k, mask, dh) if kernel == 7 else None
                    ref, ref_lse = fa._forward(q, k, v, mask, plain=True)
                for name in builds:
                    kernels.libs["flash_attention_long"] = libs[name]
                    with torch.no_grad():
                        o, lse = fa._forward(q, k, v, mask)
                    torch.cuda.synchronize()
                    row = {"kernel": kernel, "build": name, "inputs": kind, "shape": [3, HEADS, s, dh],
                           "o_vs_f64": (o.double() - exact).abs().max().item(),
                           "plain_o_vs_f64": (ref.double() - exact).abs().max().item(),
                           "o_vs_plain": (o - ref).abs().max().item()}
                    if exact_lse is not None:
                        row.update(lse_vs_f64=(lse.double() - exact_lse).abs().max().item(),
                                   plain_lse_vs_f64=(ref_lse.double() - exact_lse).abs().max().item(),
                                   lse_vs_plain=(lse - ref_lse).abs().max().item())
                    print(json.dumps(row), flush=True)
                del q, k, v, exact, exact_lse, ref, ref_lse
            q, k, v, mask = inputs(1, s, dh, False, [s])
            times = []
            for name in (builds[0], builds[1], builds[1], builds[0]):
                kernels.libs["flash_attention_long"] = libs[name]
                with torch.no_grad():
                    times.append([name, smoke.cuda_ms(torch, lambda: fa._forward(q, k, v, mask), iters=10)])
            print(json.dumps({"kernel": kernel, "shape": [1, HEADS, s, dh], "ms": times}), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    kernels.libs["flash_attention_long"] = libs["as_built"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
