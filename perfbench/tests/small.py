"""Small stand-ins of the cells' configurations and mixes for the CPU
tests: each configuration's kind makes its own (``small_config``), the
mix keeps its settings at tiny batches and lengths."""

from __future__ import annotations

from pbench import spec


def small_config(conf: dict, root=spec.ROOT, **opts) -> dict:
    """``conf``'s kind's tiny stand-in (``opts``: ``dtype``, the served type)."""
    return spec.reference(conf, root).small_config(conf, **opts)


def small_mix(mix: dict, *, lengths=(8, 12), batch: int = 3, new_tokens: int = 4) -> dict:
    return dict(mix, batch=batch, prompt_lengths=list(lengths), new_tokens=new_tokens,
                check_batches=len(lengths))
