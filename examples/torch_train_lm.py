"""End-to-end training script of the PyTorch port: train an LM with the
whole stack (data pipeline, AdamW, checkpointing, fault tolerance,
online auto-tuning of the step and, with ``--kernel-tuning kernel`` or
``both``, of its hand kernels).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 \\
        --params 100m --autotune
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --params 1m --steps 20 --seq 64

The counterpart of ``examples/train_lm.py``, with ``--device`` (default:
the CUDA card). The sizes keep the reference's widths and depths but
use heads of 128 (deepseek-7b's head dim; the hand attention kernel is
also instantiated at 16 and 64), so on the card every step launches
both the rmsnorm and the flash attention kernels. The run is resumable: re-running the same command
continues from the last checkpoint.
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.api import TuningConfig, train_tuning_defaults
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.runtime.train_loop import TrainLoopConfig, train

SIZES = {
    "1m": dict(n_layers=2, d_model=128, n_heads=1, n_kv_heads=1, d_head=128,
               d_ff=512, vocab=2048),
    "10m": dict(n_layers=4, d_model=384, n_heads=3, n_kv_heads=1, d_head=128,
                d_ff=1536, vocab=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=6, n_kv_heads=2,
                 d_head=128, d_ff=3072, vocab=32768),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", choices=SIZES, default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    # the canonical tuning flag set (--autotune, --strategy,
    # --kernel-tuning, ...) declared once from the train-loop defaults
    base = train_tuning_defaults()
    TuningConfig.add_flags(ap, base=base)
    args = ap.parse_args()

    cfg = ModelConfig(name=f"lm-{args.params}", family="dense",
                      **SIZES[args.params])
    print(f"model: {cfg.n_params()/1e6:.1f}M params")
    shape = ShapeSpec("train", "train", args.seq, args.batch)
    loop = TrainLoopConfig(
        steps=args.steps,
        ckpt_every=max(args.steps // 10, 1),
        ckpt_dir=args.ckpt_dir,
        compress_grads=args.compress_grads,
        tuning=TuningConfig.from_flags(args, base=base),
    )
    out = train(cfg, shape, loop, device=args.device)
    print(f"steps {out['start_step']} -> {out['steps']}   "
          f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}   "
          f"wall {out['wall_s']:.1f}s   "
          f"stragglers flagged: {out['stragglers_flagged']}")
    if "autotune" in out:
        a = out["autotune"]
        print(f"autotune: {a['regenerations']} variants, {a['swaps']} swaps, "
              f"overhead {a['overhead_frac']:.1%}, best {a['best_point']}")


if __name__ == "__main__":
    main()
