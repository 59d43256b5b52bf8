"""A run's comparison catches a broken timed path: the harness's whole
run (set-up, window, comparison) on the CPU at a small size, past its
look for a card, with a fault planted under ``generate``, must come out
not ``correct`` at the cell's own limit; the sound run must come out
``correct``. The faults a served cell on one card can have: a decode
step that leaves its state (the KV cache) unchanged, half the batch
left out (its rows copied from the other half), a token altered where
it is produced. (One card: no exchange between chips to leave out.)"""

import contextlib
import time

import pytest
import torch

from pbench import spec
from pbench.cellrun import run_cell
from pbench.model import program_config
from pbench.runner import patched
from small import small_config, small_mix

#: every cell of BENCHMARK.json
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


@contextlib.contextmanager
def fault(kind, model_cls):
    """The fault ``kind`` planted under ``generate``: in the port's cache
    write, or in the decode step of ``model_cls``, the class the program
    builds for the cell."""
    from repro_torch.models import layers

    if kind == "sound":
        yield
        return
    if kind == "state_unchanged":
        original = layers._write_slot
        layers._write_slot = lambda cache, new, slot: None
        try:
            yield
        finally:
            layers._write_slot = original
        return
    step = model_cls.decode_step

    def broken(*args, **kwargs):
        logits, cache = step(*args, **kwargs)
        logits = logits.clone()
        if kind == "half_batch":
            half = logits.shape[0] // 2
            logits[logits.shape[0] - half:] = logits[:half]
        else:                                   # a token altered
            row = logits[0, -1]
            row[(int(row.argmax()) + 1) % row.numel()] = row.max() + 1.0
        return logits, cache

    with patched(model_cls, "decode_step", lambda fn: broken):
        yield


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["sound", "state_unchanged", "half_batch", "token_altered"])
def test_a_fault_fails_the_comparison(name, kind):
    r = run_with_fault(spec.cell(name), kind, spec.ROOT)
    assert r["correct"] == (kind == "sound"), r["checks"]


def run_with_fault(cell, kind: str, root) -> dict:
    """A run of ``cell`` (of the checkout ``root``) at a small size on the
    CPU with the fault ``kind`` planted; its checks are the cell's."""
    from repro_torch.models.model import build_model

    assert cell.limits and all(lim["limit"] > 0 for lim in cell.limits.values())
    lengths = (8, 12) if len(cell.mix["prompt_lengths"]) > 1 else (20,)
    mix = small_mix(cell.mix, lengths=lengths, batch=4, new_tokens=6)
    conf = small_config(cell.config, root)
    with fault(kind, type(build_model(program_config(conf, root)))):
        torch.manual_seed(0)
        r = run_cell(cell, 2**31 + 17, 0.0, False, "cpu", time.perf_counter(),
                     conf=conf, mix_spec=mix, root=root)
    assert set(r["checks"]) == set(cell.limits), r["checks"]
    return r
