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
from small import small_config, small_mix

CELLS = ("deepseek-7b.prefill-long", "qwen3-moe-30b-a3b.decode-batch")


@contextlib.contextmanager
def fault(kind):
    from repro_torch.models import layers, transformer

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
    step = transformer.TransformerLM.decode_step

    def broken(self, params, cache, tokens, pos, rope_pos=None):
        logits, cache = step(self, params, cache, tokens, pos, rope_pos)
        logits = logits.clone()
        if kind == "half_batch":
            half = logits.shape[0] // 2
            logits[logits.shape[0] - half:] = logits[:half]
        else:                                   # a token altered
            row = logits[0, -1]
            row[(int(row.argmax()) + 1) % row.numel()] = row.max() + 1.0
        return logits, cache

    transformer.TransformerLM.decode_step = broken
    try:
        yield
    finally:
        transformer.TransformerLM.decode_step = step


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["sound", "state_unchanged", "half_batch", "token_altered"])
def test_a_fault_fails_the_comparison(name, kind):
    cell = spec.cell(name)
    assert cell.limits and all(lim["limit"] > 0 for lim in cell.limits.values())
    lengths = (8, 12) if len(cell.mix["prompt_lengths"]) > 1 else (20,)
    mix = small_mix(cell.mix, lengths=lengths, batch=4, new_tokens=6)
    with fault(kind):
        torch.manual_seed(0)
        r = run_cell(cell, 2**31 + 17, 0.0, False, "cpu", time.perf_counter(),
                     conf=small_config(cell.config), mix_spec=mix)
    assert set(r["checks"]) == set(cell.limits)
    assert r["correct"] == (kind == "sound"), r["checks"]
