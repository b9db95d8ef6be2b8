"""Times the f32 attention of one checkout on the card at the sequence
lengths where the single-tile kernels' shared-memory limits decide which
kernel a call runs: the packed backward (``fused_qkv_attention``'s
autograd) at [32, 12, S, Dh] for S = 256 and 512, and the packed forward at
[32, 12, S, Dh] for S = 768 and 1024, at head_dim 32 and 64. Each shape
runs a full row, ragged rows and a fully masked row (chip_smoke.py's
``attention_inputs``), and is held against the plain version with
chip_smoke.py's f32 gates.

    python3 dial_rag_tpu_torch/scripts/time_attention_ranges.py [--root DIR]

``--root`` names the checkout whose ``dial_rag_tpu_torch`` is timed (by
default the one that holds this script, whose chip_smoke.py lends its
helpers in either case), so that two commits are compared on one card in
one session: unpack the other's package into a directory and run both in
turn, in the order A, B, B, A. Each shape prints one JSON line: the device
time of one call (every kernel the call launches, mask bias included), its
CUDA-event time, the launch counters of one call and the error against the
plain version. The card's name and power limit come first.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this script
HEADS = 12
BATCH = 32
BACKWARD_SEQS = (256, 512)
FORWARD_SEQS = (768, 1024)


def load_chip_smoke():
    """This checkout's chip_smoke.py, loaded by path, so that ``--root``
    alone decides where ``dial_rag_tpu_torch`` comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(torch, fa, smoke, direction: str, s: int, dh: int) -> dict:
    qkv, mask, cot = smoke.attention_inputs(torch, "cuda", BATCH, s, HEADS, dh, seed=s + dh)
    if direction == "forward":
        def call():
            with torch.no_grad():
                return fa.fused_qkv_attention(qkv, mask, HEADS)

        with torch.no_grad():
            err = (call() - fa.fused_qkv_attention(qkv, mask, HEADS, plain=True)).abs().max().item()
        ok = err <= smoke.F32_FWD_TOL
    else:
        leaf = qkv.detach().requires_grad_(True)
        out = fa.fused_qkv_attention(leaf, mask, HEADS)

        def call():
            return torch.autograd.grad(out, leaf, cot, retain_graph=True)[0]

        plain = qkv.detach().requires_grad_(True)
        want = torch.autograd.grad(fa.fused_qkv_attention(plain, mask, HEADS, plain=True), plain, cot)[0]
        got = call()
        err = (got - want).abs().max().item()
        ok = ((got - want).abs() - smoke.GRAD_RTOL * want.abs()).max().item() <= smoke.GRAD_ATOL
    fa.reset_launches()
    call()
    torch.cuda.synchronize()
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}
    result = {"direction": direction, "shape": [BATCH, HEADS, s, dh],
              "device_ms": smoke.kernel_device_ms(torch, call, ""), "call_ms": smoke.cuda_ms(torch, call, iters=20),
              "launches": launches, "max_abs_err": err}
    if not ok:
        raise RuntimeError(f"{direction} at {result['shape']} disagrees with the plain version: {result}")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=HERE, help="checkout whose dial_rag_tpu_torch is timed")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from dial_rag_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; timing {fa.__file__}", flush=True)
    for dh in (32, 64):
        for direction, seqs in (("backward", BACKWARD_SEQS), ("forward", FORWARD_SEQS)):
            for s in seqs:
                print(json.dumps({"root": str(args.root), **measure(torch, fa, smoke, direction, s, dh)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
