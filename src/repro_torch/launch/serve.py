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
persists them across restarts: a restarted process prints a ``warm``
line for each kernel handle it started from a persisted best). ``--kernel-tuning kernel`` tunes the
model's matmul / attention / rmsnorm / decode_attention kernels as
independent session-managed compilettes. Request ``req``'s prompt is
drawn from ``torch.Generator`` seeded with ``req``; the stub modality
inputs, as the reference draws them, from one seeded with 1: frame
embeddings (B, ``enc_frames``, d) for the encoder-decoder family and 16
patch embeddings (B, 16, d) for the VLM, both times 0.05. (The serve
loop still sizes the VLM's cache and positions by ``cfg.vision_patches``,
as the reference does: ROADMAP Queue 3, R2.)
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


def make_session(args, tcfg):
    """The session every request rides, keyed by the serving device's
    fingerprint; ``None`` when ``tcfg`` does not tune (kernel_tuning="off"
    disables tuning even with --autotune: no session, and generate() emits
    no "autotune" stats block)."""
    from repro_torch.api import TuningSession
    from repro_torch.core.persistence import device_fingerprint
    from repro_torch.interop import resolve_device

    if not tcfg.active:
        return None
    return TuningSession(tcfg, device=device_fingerprint(resolve_device(args.device)))


def serve(args, tcfg, session, *, on_request=None) -> list[dict]:
    """Serve ``args.requests`` requests under ``session`` (from
    :func:`make_session`; the caller closes it); returns each request's
    result. ``on_request(req, out)`` runs after each request.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.interop import resolve_device
    from repro_torch.runtime.serve_loop import ServeConfig, generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    serve_cfg = ServeConfig(max_new_tokens=args.tokens, tuning=tcfg)
    outs = []
    for req in range(args.requests):
        gen = torch.Generator(device=device).manual_seed(req)
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
            device=device)}
        stub = torch.Generator(device=device).manual_seed(1)
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.randn(
                args.batch, cfg.enc_frames, cfg.d_model, generator=stub,
                device=device) * 0.05
        if cfg.family == "vlm":
            batch["vision"] = torch.randn(
                args.batch, 16, cfg.d_model, generator=stub, device=device) * 0.05
        out = generate(cfg, batch, serve_cfg, session=session)
        outs.append(out)
        if on_request is not None:
            on_request(req, out)
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
            # "(warm)": the handle started from a registry's best
            per = ", ".join(
                f"{name}:{k['strategy']}×{k['regenerations']}"
                + ("(warm)" if k.get("warm_started") else "")
                for name, k in sorted(a["kernels"].items())
                if k.get("plane_managed"))
            line += f"\n        kernels: {per}"
    return line


def format_warm(session) -> str:
    """One line per kernel handle that started from a registry's best:
    the point, and the regeneration whose evaluation re-validated it (a
    warm handle proposes its persisted best first; with no regeneration
    at all it serves that point as its reference)."""
    lines = []
    for h in (session.plane.handles() if session.plane is not None else ()):
        if not h.warm_started:
            continue
        ex = h.tuner.explorer
        at = next((i for i, (p, _s) in enumerate(ex.history, 1) if p == ex.base_point),
                  None)
        lines.append(
            f"warm {h.name}: started from {ex.base_point}; "
            + (f"re-validated at regeneration {at} of {len(ex.history)}" if at
               else f"served as the reference, {len(ex.history)} regenerations"))
    return "\n".join(lines)


def main(argv=None) -> None:
    args, tcfg = parse_args(argv)
    session = make_session(args, tcfg)
    try:
        serve(args, tcfg, session,
              on_request=lambda req, out: print(format_request(req, out, args)))
        warm = format_warm(session) if session is not None else ""
        if warm:
            print(warm)
    finally:
        if session is not None:
            session.close()


if __name__ == "__main__":
    main()
