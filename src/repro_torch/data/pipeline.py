"""Deterministic synthetic data pipeline.

Mirrors ``repro/data/pipeline.py``. ``DataConfig``, ``SyntheticLM`` and
``batches_for`` are the reference's, in numpy: batch ``i`` is a pure
function of (seed, i), so a job restarted from step N regenerates
exactly the batches from N on, and both packages train on the same
tokens. ``batches_for`` adds the encoder-decoder and VLM stub inputs,
as the reference does, for the families that wait to be ported.
``device_put_batch`` places a batch on a device (the card unless the
caller asks for the CPU); the reference's per-key shardings have no
counterpart on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.interop import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab: int = 32000
    batch: int = 8
    seq_len: int = 128


class SyntheticLM:
    """Markov-ish synthetic tokens (not uniform noise, so loss can drop)."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg

    def batch_at(self, index: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        B, T = cfg.batch, cfg.seq_len
        # structured stream: tok_{t+1} = (a * tok_t + noise) % vocab
        a = 31
        toks = np.empty((B, T + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        noise = rng.integers(0, 7, (B, T))
        for t in range(T):
            toks[:, t + 1] = (a * toks[:, t] + noise[:, t]) % cfg.vocab
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def batches_for(cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 1234,
                start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
    """Model-aware stream (adds stub modality inputs where required)."""
    B, T = shape.global_batch, shape.seq_len
    T_text = T - cfg.vision_patches if cfg.family == "vlm" else T
    lm = SyntheticLM(DataConfig(seed=seed, vocab=cfg.vocab, batch=B,
                                seq_len=T_text))
    i = start_step
    while True:
        b = lm.batch_at(i)
        if cfg.family == "encdec":
            rng = np.random.default_rng((seed, i, 7))
            b["audio_embeds"] = rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32) * 0.05
        if cfg.family == "vlm":
            rng = np.random.default_rng((seed, i, 9))
            b["vision"] = rng.standard_normal(
                (B, cfg.vision_patches, cfg.d_model)).astype(np.float32) * 0.05
        yield b
        i += 1


def device_put_batch(batch: dict, device: "torch.device | str | None" = None) -> dict:
    """The batch's arrays as tensors on ``device`` (CUDA by default),
    dtypes kept (tokens and labels int32, as in the reference)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
