"""Reads how far bf16 rounding moves the S = 8192 contrastive gradient on
the card, route against route and each against the f32 gradient: the
basis of chip_smoke.py's BF16_NOISE_RATIO.

On the long-context training's S = 8192 batch (4 pairs) of the seeded
12-layer encoder with 8192 positions that chip_smoke.py trains (head_dim
32: bge-small widths; 64: BAAI/bge-base-en-v1.5's), one bf16
``contrastive_loss`` gradient through each of

- ``auto``: kernel 7 forward, kernels 10 and 11 backward, all in bf16;
- ``auto, 10/11 plain``: kernel 7, the backward's plain version;
- ``auto, 7 plain``: the forward's plain version, kernels 10 and 11;
- ``pallas_plain``: both plain versions;
- ``pallas_plain, 256-key blocks``: the same with the plain versions'
  blocks of 512 keys cut to 256 (the same function, another f32 order of
  sums);

and one f32 gradient through "pallas" (the split-TF32 kernels, which
chip_smoke.py holds to f64 evaluations). Prints each loss, each bf16
route's distance 1 - cos to the f32 gradient, and the whole-gradient
cosine of every pair of bf16 routes with its four worst tensors. A route
that swaps a kernel for its plain version does so by replacing the
kernel's wrapper in ``ops.flash_attention`` for that run.

    python3 dial_rag_tpu_torch/scripts/bf16_long_gradient_routes.py [--head-dim 32 64]
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this script
sys.path.insert(0, str(HERE))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--head-dim", type=int, nargs="+", default=[32, 64], choices=[32, 64])
    args = parser.parse_args()
    import torch

    from dial_rag_tpu_torch.embeddings.embedder import BgeEmbedder
    from dial_rag_tpu_torch.models.bert import BertConfig, init_params
    from dial_rag_tpu_torch.models.tokenizer import DEFAULT_BUCKETS, WordPieceTokenizer
    from dial_rag_tpu_torch.ops import flash_attention as fa
    from dial_rag_tpu_torch.training.contrastive import contrastive_loss
    from dial_rag_tpu_torch.training.loop import TrainConfig, pairs_to_batches, trainable_params
    from dial_rag_tpu_torch.weights import param_leaves

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    small = BgeEmbedder.from_hf_checkpoint(str(cs.CHECKPOINT), device="cpu").encoder.config
    tokenizer = WordPieceTokenizer.from_vocab_file(str(cs.CHECKPOINT / "vocab.txt"),
                                                   buckets=DEFAULT_BUCKETS + cs.LONG_BUCKETS)
    cfg = TrainConfig(batch_size=cs.LONG_TRAIN_BATCH, seq_len=cs.LONG_BUCKETS[-1], learning_rate=cs.LONG_TRAIN_LR,
                      warmup_steps=2, total_steps=len(cs.LONG_TRAIN_SEQS))
    s = cs.LONG_TRAIN_SEQS[-1]
    batch = next(b for b in pairs_to_batches(tokenizer, cs.long_training_pairs(tokenizer, 1), cfg)
                 if b["p_ids"].shape[1] == s)

    kernels = {n: getattr(fa, n) for n in ("_kv_blocked_kernel", "_bwd_dq_kv_blocked_kernel",
                                           "_bwd_dkv_kv_blocked_kernel")}
    dkv = {}

    def plain_fwd(q, k, v, o, mask):
        out, lse = fa.attention_kv_blocked_plain(q, k, v, mask)
        o.copy_(out)
        return lse

    def plain_dq(q, k, v, o, lse, do, dq, mask):
        grads = fa.attention_bwd_kv_blocked_plain(q, k, v, o, lse, do, mask)
        dq.copy_(grads[0])
        dkv["grads"] = grads[1:]
        return (do.float() * o.float()).sum(dim=-1)

    def plain_dkv(q, k, v, do, lse, delta, dk, dv, mask):
        dk.copy_(dkv["grads"][0])
        dv.copy_(dkv["grads"][1])

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()

    for dh in args.head_dim:
        widths = ({"hidden_size": small.hidden_size, "num_layers": small.num_layers, "num_heads": small.num_heads,
                   "intermediate_size": small.intermediate_size} if dh == 32 else cs.BASE_WIDTHS)
        config = BertConfig(vocab_size=small.vocab_size, type_vocab_size=small.type_vocab_size,
                            **{**widths, "max_position_embeddings": cs.LONG_MAX_POSITIONS})
        params = init_params(config, torch.Generator().manual_seed(0))
        names = cs.leaf_names(params)

        def grads(impl, dtype=torch.bfloat16, fwd_plain=False, bwd_plain=False, block=fa._KV_BLOCK):
            swaps = {"_kv_blocked_kernel": plain_fwd if fwd_plain else None,
                     "_bwd_dq_kv_blocked_kernel": plain_dq if bwd_plain else None,
                     "_bwd_dkv_kv_blocked_kernel": plain_dkv if bwd_plain else None}
            kept_block = fa._KV_BLOCK
            for name, fn in swaps.items():
                setattr(fa, name, fn or kernels[name])
            fa._KV_BLOCK = block
            try:
                p = trainable_params(params, dev)
                loss = contrastive_loss(p, batch, num_heads=config.num_heads, temperature=cfg.temperature,
                                        compute_dtype=dtype, attention_impl=impl)
                loss.backward()
                torch.cuda.synchronize()
                return loss.item(), [t.grad for t in param_leaves(p)]
            finally:
                fa._KV_BLOCK = kept_block
                for name in swaps:
                    setattr(fa, name, kernels[name])

        runs = {
            "auto": grads("auto"),
            "auto, 10/11 plain": grads("auto", bwd_plain=True),
            "auto, 7 plain": grads("auto", fwd_plain=True),
            "pallas_plain": grads("pallas_plain"),
            "pallas_plain, 256-key blocks": grads("pallas_plain", block=256),
        }
        loss_f, ref = grads("pallas", torch.float32)
        kept = [i for i, r in enumerate(ref) if r.abs().max() > 0]

        def whole(a, b):
            return cos(torch.cat([a[i].flatten() for i in kept]), torch.cat([b[i].flatten() for i in kept]))

        print(f"head_dim {dh}, [{batch['p_ids'].shape[0]}, {config.num_heads}, {s}, {dh}], passage lengths "
              f"{batch['p_mask'].sum(1).tolist()}; f32 loss {loss_f:.8f} {card}")
        for name, (loss, g) in runs.items():
            print(f"  {name}: loss {loss:.8f}, 1 - cos to the f32 gradient {1 - whole(g, ref):.6g}")
        keys = list(runs)
        for i, x in enumerate(keys):
            for y in keys[i + 1 :]:
                a, b = runs[x][1], runs[y][1]
                worst = sorted((cos(a[j], b[j]), names[j]) for j in kept)[:4]
                print(f"  {x} vs {y}: whole cos {whole(a, b):.6f}; worst "
                      + ", ".join(f"{n} {c:.5f}" for c, n in worst), flush=True)
        del runs, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
