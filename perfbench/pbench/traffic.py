"""The one traffic generator: a closed loop of batches from a mix file.

A mix (``perfbench/traffic/<name>.json``) gives ``batch`` (prompts a
batch), ``prompt_lengths`` (one length a batch, in this fixed cycle),
``new_tokens`` (greedy tokens a request), the ``tuning`` the serving
session runs under, and ``check_batches`` (how many of the window's
batches the comparison takes). The seed draws only token ids: every seed
serves the same lengths in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: stream tags under one run seed
WEIGHTS, PROMPTS, CHECK = 1, 2, 3


def derive(seed: int, tag: int) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any
    whole number, however large)."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass(frozen=True)
class Mix:
    batch: int
    prompt_lengths: tuple[int, ...]
    new_tokens: int
    check_batches: int
    trace_decode_steps: "int | None" = None   # the traced stretch's decode steps

    @classmethod
    def from_spec(cls, spec: dict) -> "Mix":
        if spec.get("loop", "closed") != "closed":
            raise ValueError(f"loop {spec['loop']!r}: only a closed loop is generated")
        return cls(batch=int(spec["batch"]),
                   prompt_lengths=tuple(int(t) for t in spec["prompt_lengths"]),
                   new_tokens=int(spec["new_tokens"]),
                   check_batches=int(spec["check_batches"]),
                   trace_decode_steps=spec.get("trace_decode_steps"))

    @property
    def cycle(self) -> int:
        """Batches in one cycle of lengths: the window holds whole cycles."""
        return len(self.prompt_lengths)

    def length(self, i: int) -> int:
        return self.prompt_lengths[i % self.cycle]

    def shapes(self) -> list[tuple[int, int, int]]:
        """Each distinct (batch, prompt length, cache length) served."""
        return [(self.batch, t, t + self.new_tokens)
                for t in dict.fromkeys(self.prompt_lengths)]


class Prompts:
    """Batch ``i``'s prompt tokens, drawn in order from the run's seed."""

    def __init__(self, mix: Mix, vocab: int, seed: int, device) -> None:
        self.mix = mix
        self.vocab = vocab
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(derive(seed, PROMPTS))
        self.drawn: list[torch.Tensor] = []

    def __getitem__(self, i: int) -> torch.Tensor:
        while len(self.drawn) <= i:
            n = len(self.drawn)
            self.drawn.append(torch.randint(
                0, self.vocab, (self.mix.batch, self.mix.length(n)),
                generator=self.gen, device=self.device))
        return self.drawn[i]


def check_sample(mix: Mix, n_batches: int, seed: int) -> list[int]:
    """Which finished batches the comparison takes: ``check_batches`` of
    them drawn from the seed, one of the longest prompt length always
    among them, the others spread over the other lengths first."""
    rng = np.random.default_rng(derive(seed, CHECK))
    by_len: dict[int, list[int]] = {}
    for i in range(n_batches):
        by_len.setdefault(mix.length(i), []).append(i)
    order = sorted(by_len, reverse=True)
    picked: list[int] = []
    for t in order:                               # one a length, longest first
        if len(picked) == mix.check_batches:
            break
        picked.append(int(rng.choice(by_len[t])))
    rest = [i for i in range(n_batches) if i not in picked]
    extra = min(mix.check_batches - len(picked), len(rest))
    if extra > 0:
        picked += [int(i) for i in rng.choice(rest, size=extra, replace=False)]
    return sorted(picked)
