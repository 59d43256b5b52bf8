"""Small stand-ins of the cells' configurations and mixes for the CPU
tests: the same families and settings, tiny widths."""

from __future__ import annotations

import copy


def small_config(conf: dict, *, dtype: str | None = None, group: int = 32) -> dict:
    c = copy.deepcopy(conf)
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, vocab_size=256)
    if c["runs_as"]["family"] == "moe":
        c.update(num_key_value_heads=2, head_dim=16, moe_intermediate_size=32,
                 num_experts=8, num_experts_per_tok=2)
        c["runs_as"] = dict(c["runs_as"], moe_group_size=group)
    else:
        c.update(num_key_value_heads=4, intermediate_size=128)
    if dtype:
        c["runs_as"] = dict(c["runs_as"], dtype=dtype)
    return c


def small_mix(mix: dict, *, lengths=(8, 12), batch: int = 3, new_tokens: int = 4) -> dict:
    return dict(mix, batch=batch, prompt_lengths=list(lengths), new_tokens=new_tokens,
                check_batches=len(lengths))
