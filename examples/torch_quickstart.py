"""Quickstart: online auto-tuning through the one front door, `repro_torch.tune`.

    PYTHONPATH=src python examples/torch_quickstart.py             # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --virtual   # no hardware

The port's counterpart of ``examples/quickstart.py``. The whole
integration is ~20 lines: build a ``repro_torch.TuningSession``,
decorate your function with ``@repro_torch.tuned(space=...)``, and keep
calling it. The session explores machine-code variants *while the
application runs* — each tuning point's keys are passed to the function
as constants bound when the variant is generated (the paper's run-time
specialization), variants are generated off the hot path, and the
active function swaps when a variant measures faster, all under a
bounded overhead budget.

The real run tunes Streamcluster's distances (N 2048, M 64, D 64) on the
hand-written euclid kernel: ``block_d`` is one of its template
parameters, so every point is its own compiled instantiation. With
``--device cpu`` the kernel's plain PyTorch version stands in.

``--virtual``, ``--fleet`` and ``--transfer`` run the same control loop
on a ``VirtualClock`` (costs declared, no sleeps, bit-deterministic):
pure arithmetic, so they print exactly what the reference's modes print.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import repro_torch
from repro_torch.core import Param, product_space


def main(device=None) -> dict:
    import torch

    from repro_torch.interop import resolve_device
    from repro_torch.kernels.euclid.euclid import euclid_cuda
    from repro_torch.kernels.euclid.ops import DEFAULT_POINT
    from repro_torch.kernels.euclid.ref import euclid_ref

    dev = resolve_device(device)
    N, M, D = 2048, 64, 64           # points × centers × dimension
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(N, D, generator=gen).to(dev)
    c = torch.randn(M, D, generator=gen).to(dev)

    # --- the canonical ~20-line integration --------------------------------
    session = repro_torch.TuningSession(repro_torch.TuningConfig(
        max_overhead=0.05, invest=0.5, pump_every=2))

    @repro_torch.tuned(session=session, space=product_space([
        Param("block_d", (16, 32, 64), phase=1)]))
    def distances(x, c, *, block_d):
        # Streamcluster euclidean distances, the paper's CPU-bound kernel:
        # `block_d` (the depth of one slice of the d loop) is a template
        # parameter of the hand kernel, so every point is its own
        # instantiation (the deGoal specialization analogue)
        return euclid_cuda(x, c, dict(DEFAULT_POINT, block_d=block_d))

    t0 = time.perf_counter()
    calls = 200
    for _ in range(calls):
        out = distances(x, c)        # the application just calls the kernel
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    # -----------------------------------------------------------------------

    s = distances.stats()
    print(f"app ran {calls} kernel calls in {wall*1e3:.0f} ms on {dev}")
    print(f"explored {s['n_explored']} variants, {s['swaps']} swaps, "
          f"tuning overhead {s['tuning_spent_s']/wall:.1%}")
    print(f"reference {s['reference_score_s']*1e6:.0f} us/call -> "
          f"active {s['active_score_s']*1e6:.0f} us/call")
    print(f"best point: {distances.best_point}")

    err = (distances(x, c) - euclid_ref(x, c)).abs().max()
    print(f"max abs err vs oracle: {float(err):.2e}")
    session.close()
    if float(err) > 1e-3:
        raise SystemExit("tuned kernel diverged from the oracle")
    return {"calls": calls, "wall_s": wall, "stats": s,
            "best_point": distances.best_point, "max_abs_err": float(err)}


def main_virtual() -> None:
    """The same loop, deterministic: declared costs, VirtualClock, no sleeps."""
    from repro_torch.core import VirtualClock, VirtualClockEvaluator

    clock = VirtualClock()
    # gate_mode="canary": every variant passes the oracle gate, then
    # serves a canary fraction of calls before promotion — the trusted
    # swaps path the fault-injection scenarios exercise under traffic
    session = repro_torch.TuningSession(repro_torch.TuningConfig(
        max_overhead=1.0, invest=0.5, pump_every=1,
        gate_mode="canary", canary_fraction=0.5, canary_calls=4),
        clock=clock)

    def cost(unroll: int) -> float:
        return 0.010 / unroll        # known optimum: the largest unroll

    @repro_torch.tuned(session=session, gen_cost_s=0.002,
                 space=product_space([Param("unroll", (1, 2, 4, 8),
                                            phase=1)]),
                 evaluator=VirtualClockEvaluator(
                     clock, score_fn=lambda f: cost(f.point["unroll"])))
    def kernel(step, *, unroll):
        clock.advance(cost(unroll))  # 'execution' burns simulated time
        return step

    # run the full trace: the last candidate still needs to serve its
    # canary probation (canary_calls canaried calls) after the explorer
    # finishes before it can be promoted to incumbent
    for step in range(400):
        kernel(step)

    s = kernel.stats()
    print(f"virtual: explored {s['n_explored']} variants in "
          f"{clock():.3f} simulated s, best {kernel.best_point}, "
          f"gen stall {s['gen_stall_s']:.3f} s")
    print(f"trusted swaps: {s['gate_checks']} gate checks "
          f"({s['gate_failures']} failed), {s['canary_calls']} canary "
          f"calls, {s['canary_promotions']} promotions, "
          f"{s['rollbacks']} rollbacks, {s['quarantined']} quarantined")
    session.close()
    if kernel.best_point != {"unroll": 8}:
        raise SystemExit(f"did not converge to the optimum: "
                         f"{kernel.best_point}")
    if s["gen_stall_s"] != 0.0:
        raise SystemExit("async generation stalled the hot path")
    if s["canary_promotions"] < 1:
        raise SystemExit("no variant survived its canary probation")
    if s["rollbacks"] or s["quarantined"] or s["gate_failures"]:
        raise SystemExit("clean variants tripped the trusted-swaps "
                         "defenses (expected none)")


def main_fleet() -> None:
    """Two-replica fleet: one shared backend, disjoint exploration.

    Each replica hash-owns half the search space (``replica_id`` /
    ``replica_count``), publishes its measurements and best through the
    shared ``registry_backend``, and adopts the peer's best as a gated
    CANDIDATE — so the fleet pays for each variant's compile once and
    both replicas converge to the same optimum. Swap the in-memory
    ``FleetBus`` for ``registry_backend="shared:/tmp/fleet.json"`` to
    run real replicas in separate processes against one file.
    """
    from repro_torch.core import FleetBus, VirtualClock, VirtualClockEvaluator

    bus = FleetBus()

    def cost(p) -> float:
        return 0.010 / p["unroll"] + 0.001 * p["lane"]

    kernels, clocks = [], []
    for rid in range(2):
        clock = VirtualClock()
        session = repro_torch.TuningSession(repro_torch.TuningConfig(
            max_overhead=1.0, invest=0.5, pump_every=1,
            replica_id=rid, replica_count=2, sync_every_s=0.05),
            clock=clock, registry_backend=bus)

        def make(session, clock):
            @repro_torch.tuned(session=session, gen_cost_s=0.002,
                         space=product_space([
                             Param("unroll", (1, 2, 4, 8), phase=1),
                             Param("lane", (0, 1, 2, 3), phase=1)]),
                         evaluator=VirtualClockEvaluator(
                             clock, score_fn=lambda f: cost(f.point)))
            def kernel(step, *, unroll, lane):
                clock.advance(cost({"unroll": unroll, "lane": lane}))
                return step
            return kernel

        kernels.append((make(session, clock), session))
        clocks.append(clock)

    for step in range(800):
        for kernel, _ in kernels:
            kernel(step)

    total = 0
    for rid, (kernel, session) in enumerate(kernels):
        s = kernel.stats()
        total += s["n_explored"]
        print(f"replica {rid}: explored {s['n_explored']}/16 variants "
              f"in {clocks[rid]():.3f} simulated s, "
              f"best {kernel.best_point}")
        if s["n_explored"] >= 16:
            raise SystemExit(f"replica {rid} explored the whole space — "
                             "partitioning did not stick")
        if kernel.best_point != {"unroll": 8, "lane": 0}:
            raise SystemExit(f"replica {rid} missed the fleet optimum: "
                             f"{kernel.best_point}")
        session.close()
    # 16 points compiled once per fleet, plus at most a couple of
    # peer-best re-validations (the CANDIDATE path measures locally)
    print(f"fleet total: {total} evaluations for a 16-point space")
    if total > 20:
        raise SystemExit("fleet re-compiled peers' work")


def main_transfer() -> None:
    """Transfer plane: an UNSEEN device warm-starts from a similar one.

    Device A tunes a 16-point space to convergence and publishes its
    best into a shared registry — stamped with its ``DeviceTraits``.
    Device B has a fingerprint the registry has *never* seen, so the
    exact warm start misses; with ``transfer=True`` the nearest-
    fingerprint lookup ranks A's best by trait similarity and injects
    it as a gated CANDIDATE seed. B serves the fleet optimum within two
    regenerations instead of re-sweeping the space from cold.
    """
    from repro_torch.core import TunedRegistry, VirtualClock, VirtualClockEvaluator

    registry = TunedRegistry()   # shared across both devices

    def cost(rate, p) -> float:
        return rate / p["unroll"] + 0.0005 * p["lane"]

    def bring_up(device, rate, transfer, calls):
        clock = VirtualClock()
        session = repro_torch.TuningSession(repro_torch.TuningConfig(
            max_overhead=1.0, invest=0.5, pump_every=1,
            gate_mode="check", transfer=transfer),
            clock=clock, registry=registry, device=device)

        @repro_torch.tuned(session=session, gen_cost_s=0.002,
                     space=product_space([
                         Param("unroll", (1, 2, 4, 8), phase=1),
                         Param("lane", (0, 1, 2, 3), phase=1)]),
                     evaluator=VirtualClockEvaluator(
                         clock, score_fn=lambda f: cost(rate, f.point)))
        def kernel(step, *, unroll, lane):
            clock.advance(cost(rate, {"unroll": unroll, "lane": lane}))
            return step

        for step in range(calls):
            kernel(step)
        return kernel, session

    # device A: a known core explores all 16 points and publishes its
    # best (trait-stamped) into the shared registry
    k_a, s_a = bring_up("gpu:sim-a", 0.010, False, 600)
    sa = k_a.stats()
    print(f"device A (cold): explored {sa['n_explored']}/16 variants, "
          f"best {k_a.best_point}")
    s_a.close()

    # device B: same platform, different silicon (20% slower clock) and
    # a fingerprint no registry entry matches — only the transfer plane
    # can warm it up, and only through the gate
    k_b, s_b = bring_up("gpu:sim-b", 0.012, True, 40)
    sb = k_b.stats()
    fleet = s_b.stats()
    print(f"device B (transfer): {fleet['transfer_hits']} seeds injected, "
          f"{fleet['transfer_adopted']} adopted, best found in "
          f"{fleet['seeded_regens_to_best']:.0f} regen(s) after "
          f"{sb['n_explored']} evaluations ({sb['gate_checks']} gate "
          f"checks), best {k_b.best_point}")
    s_b.close()

    if k_a.best_point != {"unroll": 8, "lane": 0}:
        raise SystemExit(f"device A missed the optimum: {k_a.best_point}")
    if fleet["transfer_hits"] < 1 or not k_b.handle.transfer_seed_keys:
        raise SystemExit("no transfer seeds reached device B")
    if k_b.best_point != {"unroll": 8, "lane": 0}:
        raise SystemExit(f"device B missed the optimum: {k_b.best_point}")
    if fleet["seeded_regens_to_best"] is None \
            or fleet["seeded_regens_to_best"] > 2:
        raise SystemExit("transfer seed did not shortcut the search "
                         f"(regens to best: {fleet['seeded_regens_to_best']})")
    if sb["gate_checks"] < 1:
        raise SystemExit("transfer seed bypassed the gate")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", action="store_true",
                    help="deterministic VirtualClock smoke (no hardware, "
                         "no sleeps)")
    ap.add_argument("--fleet", action="store_true",
                    help="two-replica fleet demo: shared registry backend "
                         "+ partitioned exploration (virtual, no hardware)")
    ap.add_argument("--transfer", action="store_true",
                    help="transfer-plane demo: an unseen device warm-"
                         "starts from a trait-similar one (virtual)")
    ap.add_argument("--device", default=None,
                    help="where the real run's kernel runs (default: the CUDA "
                         "card; 'cpu' runs its plain PyTorch version)")
    args = ap.parse_args()
    if args.transfer:
        main_transfer()
    elif args.fleet:
        main_fleet()
    elif args.virtual:
        main_virtual()
    else:
        main(args.device)
