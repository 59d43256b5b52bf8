"""The program's model config for a configuration file: the port's
registered config of the same architecture, at the file's sizes."""

from __future__ import annotations

import dataclasses

import torch

from pbench.shapes import shapes


def program_config(conf: dict):
    """``repro_torch``'s ``ModelConfig`` that runs ``conf``."""
    from repro_torch.configs import get_config

    s = shapes(conf)
    if s.eps != 1e-6:
        raise ValueError(f"rms_norm_eps {s.eps}: the port's rmsnorm runs at 1e-6")
    run = conf["runs_as"]
    dtype = getattr(torch, run["dtype"])
    fields = dict(
        family=s.family, n_layers=s.n_layers, d_model=s.d, n_heads=s.heads,
        n_kv_heads=s.kv_heads, d_head=s.d_head, d_ff=s.d_ff, vocab=s.vocab,
        rope_theta=s.rope_theta, act="swiglu", qkv_bias=False,
        param_dtype=dtype, compute_dtype=dtype)
    if s.family == "moe":
        fields.update(n_experts=s.experts, top_k=s.top_k, n_shared_experts=0,
                      capacity_factor=s.capacity_factor, moe_group_size=s.group_size)
    return dataclasses.replace(get_config(run["arch"]), **fields)
