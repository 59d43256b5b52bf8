"""Serving example: batched prefill + greedy decode with a KV cache, on a
reduced config of an assigned architecture.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch deepseek-7b \\
        --autotune --kernel-tuning kernel
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --tokens 8

The port's counterpart of ``examples/serve_lm.py``, with ``--device``
(default: the CUDA card). The config is the architecture's
``.reduced()`` one (2 layers, d_model 64, heads of 16), so on the card
the prefill's attention runs the hand flash-attention kernel at head dim
16 (causal self-attention; for whisper-tiny also the encoder's and the
cross-attention's non-causal calls) and the RMS norms the rmsnorm
kernel. Every family is served: dense, MoE (qwen3-moe-30b-a3b,
llama4-scout-17b-a16e), VLM (qwen2-vl-7b, with 16 stub patch embeddings),
encoder-decoder (whisper-tiny, with stub frame embeddings), RWKV
(rwkv6-1.6b: no attention, an O(1) state) and hybrid (hymba-1.5b: its
windowed attention runs the plain version, as the reference's does, and
a prompt past the reduced window of 32 exercises the window).

The session and the request loop are the serving CLI's own
(:func:`repro_torch.launch.serve.make_session` and
:func:`repro_torch.launch.serve.serve`); this script adds the reduced
config, a generous overhead cap for short demo runs and a verbose
per-request print. With ``--autotune`` the request streams tokens while
one :class:`repro_torch.TuningSession` tunes the step-programs and (with
``--kernel-tuning kernel|both``) their constituent hand kernels online;
``--requests N`` sends N requests through the same session so tuning pays
off across requests; ``--registry PATH`` persists the tuned points, and a
second run with the same path warm-starts every handle from them. The
tuning flags are the canonical ``repro_torch.tune`` set declared by
``repro_torch.TuningConfig.add_flags``. Request ``req``'s prompt is drawn
from a ``torch.Generator`` seeded with ``req``. After the requests it
prints the serving CLI's ``warm`` line for each handle that started from
the registry.
"""

import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

from repro_torch.api import TuningConfig, serve_tuning_defaults
from repro_torch.configs import REGISTRY
from repro_torch.interop import resolve_device
from repro_torch.launch import serve as serve_cli


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=sorted(REGISTRY))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card)")
    # demo-friendly base: a generous overhead cap for short runs
    base = dataclasses.replace(serve_tuning_defaults(), max_overhead=0.2)
    TuningConfig.add_flags(ap, base=base)
    args = ap.parse_args(argv)
    args.reduced = True

    tcfg = TuningConfig.from_flags(args, base=base)
    device = resolve_device(args.device)
    t0 = [time.perf_counter()]

    def on_request(req, out):
        print(f"req {req}  arch={args.arch} (reduced)  batch={args.batch}  "
              f"device={device}")
        print(f"  prefill {out['prefill_s']*1e3:.0f} ms   "
              f"decode {out['decode_s']*1e3:.0f} ms   "
              f"{out['decode_tokens_per_s']:.1f} tok/s   "
              f"total {time.perf_counter()-t0[0]:.1f}s")
        t0[0] = time.perf_counter()
        if "autotune" not in out:
            return
        a = out["autotune"]
        lc = a["lifecycle"]
        print(f"  tuning[{args.strategy}/{args.kernel_tuning}]: "
              f"{a['regenerations']} regens {a['swaps']} swaps "
              f"overhead {a['overhead_frac']*100:.1f}% "
              f"(budget {a['budget_s']*1e3:.0f} ms, "
              f"init {a['init_spent_s']*1e3:.0f} ms) "
              f"tuners {a['n_kernels']} "
              f"({lc['converged']} converged {lc['retired']} retired)")
        if args.kernel_tuning in ("kernel", "both"):
            for name, k in sorted(a["kernels"].items()):
                if not k.get("plane_managed"):
                    continue
                print(f"    kernel {name}: {k['strategy']} "
                      f"{k['regenerations']} regens "
                      f"gen {k['gen_spent_s']*1e3:.1f} ms "
                      f"eval {k['eval_spent_s']*1e3:.1f} ms"
                      + ("  warm-started" if k.get("warm_started") else ""))

    session = serve_cli.make_session(args, tcfg)
    try:
        t0[0] = time.perf_counter()
        outs = serve_cli.serve(args, tcfg, session, on_request=on_request)
        warm = serve_cli.format_warm(session) if session is not None else ""
        if warm:
            print(warm)
    finally:
        if session is not None:
            session.close()
    if outs:
        print("first sequence:", outs[-1]["tokens"][0].tolist())
    return outs


if __name__ == "__main__":
    main()
