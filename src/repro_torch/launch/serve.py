"""Serving launcher CLI.

Mirrors ``repro/launch/serve.py``, with one more flag, ``--device``
(default: the CUDA card; ``cpu`` runs the plain PyTorch versions)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --autotune --kernel-tuning kernel [--batch 4 --prompt-len 512 \\
        --tokens 32 --requests 2]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --reduced --device cpu --autotune --kernel-tuning kernel

All tuning knobs are the canonical flag set, declared once by
:meth:`repro_torch.TuningConfig.add_flags`; the CLI builds one
:class:`repro_torch.TuningSession` and every request rides it, so later
requests reuse the variants earlier ones discovered (and ``--registry``
persists them across restarts). ``--kernel-tuning kernel`` tunes the
model's matmul / attention / rmsnorm / decode_attention kernels as
independent session-managed compilettes. Request ``req``'s prompt is
drawn from ``torch.Generator`` seeded with ``req``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    # repro_torch.api imports nothing heavy: --help and flag errors stay
    # fast; the model and the kernels load only after parsing succeeds
    from repro_torch.api import TuningConfig, serve_tuning_defaults

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card)")
    # the canonical tuning flag set, declared once; the serving regime
    # (busy-time budget, charged init, 5% cap) seeds the flag defaults
    base = serve_tuning_defaults()
    TuningConfig.add_flags(ap, base=base)
    args = ap.parse_args(argv)
    return args, TuningConfig.from_flags(args, base=base)


def serve(args, tcfg, *, on_request=None) -> list[dict]:
    """Serve ``args.requests`` requests; returns each request's result.

    ``on_request(req, out)`` runs after each request.
    """
    import torch

    from repro_torch.api import TuningSession
    from repro_torch.configs import get_config
    from repro_torch.core.persistence import device_fingerprint
    from repro_torch.interop import resolve_device
    from repro_torch.runtime.serve_loop import ServeConfig, generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    serve_cfg = ServeConfig(max_new_tokens=args.tokens, tuning=tcfg)
    # kernel_tuning="off" disables tuning even with --autotune: no
    # session, and generate() emits no "autotune" stats block
    session = (TuningSession(tcfg, device=device_fingerprint(device))
               if tcfg.active else None)
    outs = []
    try:
        for req in range(args.requests):
            gen = torch.Generator(device=device).manual_seed(req)
            batch = {"tokens": torch.randint(
                0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                device=device)}
            out = generate(cfg, batch, serve_cfg, session=session)
            outs.append(out)
            if on_request is not None:
                on_request(req, out)
    finally:
        if session is not None:
            session.close()
    return outs


def format_request(req: int, out: dict, args) -> str:
    line = (f"req {req}: {out['decode_tokens_per_s']:.1f} tok/s, "
            f"prefill {out['prefill_s']*1e3:.0f} ms")
    a = out.get("autotune")
    if a is not None:
        lc = a["lifecycle"]
        gc = a["generation_cache"]
        line += (f"  [tuning({args.strategy}/{args.kernel_tuning}): "
                 f"{a['regenerations']} regens, {a['swaps']} swaps, "
                 f"overhead {a['overhead_frac']*100:.1f}%, "
                 f"gen stall {a['gen_stall_s']*1e3:.0f} ms, "
                 f"cache {gc['hit_rate']*100:.0f}% hit, "
                 f"tuners {a['n_kernels']} "
                 f"({lc['converged']} converged, "
                 f"{lc['retired']} retired)]")
        if args.kernel_tuning in ("kernel", "both"):
            per = ", ".join(
                f"{name}:{k['strategy']}×{k['regenerations']}"
                for name, k in sorted(a["kernels"].items())
                if k.get("plane_managed"))
            line += f"\n        kernels: {per}"
    return line


def main(argv=None) -> None:
    args, tcfg = parse_args(argv)
    serve(args, tcfg, on_request=lambda req, out: print(format_request(req, out, args)))


if __name__ == "__main__":
    main()
