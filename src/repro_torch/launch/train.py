"""Training launcher CLI.

Mirrors ``repro/launch/train.py``, with one more flag, ``--device``
(default: the CUDA card; ``cpu`` runs the plain PyTorch versions)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --reduced --device cpu --steps 20 --seq 64 --batch 4 \\
        --ckpt-dir /tmp/vtrain_t --autotune

Re-running with a higher ``--steps`` and the same ``--ckpt-dir`` resumes
from the latest checkpoint and warm-starts tuning from the ``tuned.json``
beside it. Tuning knobs are the canonical flag set
(:meth:`repro_torch.TuningConfig.add_flags` with the training defaults);
the loop drives them through one :class:`repro_torch.TuningSession`.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    # repro_torch.api imports nothing heavy: --help and flag errors stay
    # fast; the model and the kernels load only after parsing succeeds
    from repro_torch.api import TuningConfig, train_tuning_defaults

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (recovery demo)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    base = train_tuning_defaults()
    TuningConfig.add_flags(ap, base=base)
    args = ap.parse_args(argv)
    return args, TuningConfig.from_flags(args, base=base)


def main(argv=None) -> None:
    args, tcfg = parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    loop = TrainLoopConfig(
        steps=args.steps, ckpt_every=max(args.steps // 10, 1),
        ckpt_dir=args.ckpt_dir,
        compress_grads=args.compress_grads, fail_at_step=args.fail_at,
        tuning=tcfg)
    out = train(cfg, shape, loop, device=args.device)
    print({k: v for k, v in out.items() if k not in ("losses", "step_s")})


if __name__ == "__main__":
    main()
