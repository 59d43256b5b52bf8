"""Variant correctness gate (trusted swaps, step 1).

The Kernel Tuning Toolkit (arXiv:1910.08498) validates every dynamically
tuned configuration against a reference implementation before it is
allowed to serve; this module is that validation step for the online
auto-tuner. On first harvest of a variant the gate runs it once on the
kernel's example inputs and compares the outputs against the catalog
oracle (``KernelDef.oracle`` — the kernel's ``ref.py``) within per-kernel
tolerances (``KernelDef.tolerance``, overridable per session).

Virtual backends carry no numerics: there a scripted verdict
(``compilette.gate_script``, a ``point -> bool`` callable installed by the
test/replay harness) decides pass/fail so VirtualClock runs stay
deterministic, and the check bills its natural cost — one simulated
execution of the variant — to the virtual clock.

The gate only renders verdicts; acting on a failure (explorer + registry
quarantine, never re-proposing or re-trusting the point) is the
auto-tuner's and coordinator's job.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.tuning_space import Point

# gate_mode knob: "off" = promote on measurement alone (pre-gate behavior),
# "check" = oracle check then immediate swap, "canary" = oracle check then
# staged promotion (CANDIDATE -> CANARY -> INCUMBENT) with auto-rollback.
GATE_MODES = ("off", "check", "canary")

# Conservative defaults for float32 kernel-vs-reference comparison; kernels
# that accumulate in lower precision declare looser per-kernel tolerances.
DEFAULT_RTOL = 1e-3
DEFAULT_ATOL = 1e-5


class VariantGate:
    """Oracle check for one compilette's freshly generated variants.

    ``check(point, fn)`` returns ``(ok, reason)``. A compilette without an
    oracle or example inputs (e.g. a program-level ``repro_torch.tuned``
    function) passes trivially — the gate can only be as strong as the
    reference the kernel declares.
    """

    def __init__(
        self,
        compilette: Any,
        *,
        rtol: float | None = None,
        atol: float | None = None,
    ) -> None:
        self.compilette = compilette
        tol = dict(getattr(compilette, "tolerance", None) or {})
        self.rtol = float(rtol if rtol is not None
                          else tol.get("rtol", DEFAULT_RTOL))
        self.atol = float(atol if atol is not None
                          else tol.get("atol", DEFAULT_ATOL))
        self.checks = 0
        self.failures = 0

    def check(self, point: Point, fn: Callable[..., Any]) -> tuple[bool, str]:
        self.checks += 1
        ok, reason = self._verdict(point, fn)
        if not ok:
            self.failures += 1
        return ok, reason

    # ------------------------------------------------------------ verdicts
    def _scripted(self, script: Callable[..., Any], point: Point,
                  ) -> tuple[bool, str]:
        try:
            if bool(script(dict(point))):
                return True, ""
        except Exception as e:
            return False, f"gate script raised: {e!r}"
        return False, "scripted oracle mismatch"

    def _verdict(self, point: Point, fn: Callable[..., Any],
                 ) -> tuple[bool, str]:
        comp = self.compilette
        script = getattr(comp, "gate_script", None)
        if getattr(comp, "virtual", None) is not None:
            # Virtual variants carry no numerics. Bill the check's natural
            # cost — one simulated execution — then consult the script.
            try:
                fn(None)
            except Exception as e:
                return False, f"variant raised: {e!r}"
            if script is None:
                return True, ""
            return self._scripted(script, point)
        if script is not None:
            return self._scripted(script, point)
        oracle = getattr(comp, "oracle", None)
        example = getattr(comp, "example_call_args", None)
        if oracle is None or example is None:
            return True, ""
        try:
            args = example()
        except Exception:
            # no example inputs for this spec: nothing to run the check on
            return True, ""
        try:
            got = fn(*args)
        except Exception as e:
            return False, f"variant raised: {e!r}"
        try:
            want = oracle(*args)
        except Exception:
            # a broken oracle is an environment bug, not evidence against
            # the variant; failing closed here would quarantine the whole
            # space and silently end tuning
            return True, ""
        return self._compare(got, want)

    def _compare(self, got: Any, want: Any) -> tuple[bool, str]:
        import numpy as np

        g = tuple(got) if isinstance(got, (tuple, list)) else (got,)
        w = tuple(want) if isinstance(want, (tuple, list)) else (want,)
        if len(g) != len(w):
            return False, f"output arity {len(g)} != oracle arity {len(w)}"
        for i, (a, b) in enumerate(zip(g, w)):
            # numpy cannot read device memory: bring tensors to the host
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu()
            if isinstance(b, torch.Tensor):
                b = b.detach().cpu()
            try:
                aa = np.asarray(a).astype(np.float64)
                bb = np.asarray(b).astype(np.float64)
            except (TypeError, ValueError):
                if a != b:
                    return False, f"output {i}: {a!r} != oracle {b!r}"
                continue
            if aa.shape != bb.shape:
                return False, (f"output {i} shape {aa.shape} != "
                               f"oracle shape {bb.shape}")
            if not np.allclose(aa, bb, rtol=self.rtol, atol=self.atol):
                err = float(np.max(np.abs(aa - bb))) if aa.size else 0.0
                return False, (f"output {i} max|err|={err:.3e} beyond "
                               f"rtol={self.rtol:g} atol={self.atol:g}")
        return True, ""
