"""Model dispatcher: config -> model instance; constituent-kernel specs.

Mirrors ``repro/models/model.py``: the port builds all six families
(dense, MoE, VLM, RWKV, hybrid and encoder-decoder).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.vlm import VLM
from repro_torch.models.whisper import WhisperLM


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe"):
        return TransformerLM(cfg)
    if cfg.family == "vlm":
        return VLM(cfg)
    if cfg.family == "rwkv":
        return RWKV6LM(cfg)
    if cfg.family == "hybrid":
        return HymbaLM(cfg)
    if cfg.family == "encdec":
        return WhisperLM(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")


def model_kernel_specs(
    cfg: ModelConfig, *, batch: int, seq: int, max_len: int | None = None,
) -> list[tuple[str, dict]]:
    """Constituent tunable kernels of a model's step-programs.

    The hierarchical-registration shape list: for a (batch, seq) traffic
    cell, the step-programs decompose into these catalog kernels, each
    registered as an independent coordinator-managed compilette (its own
    tuning space, strategy, registry key and cache lines). The paper's
    unit of analysis — the individual short-running kernel — keyed by
    the run-time constants the model bakes into it.

    ``max_len`` is the (pre-bucketed) KV-cache extent of a decode path:
    when given, the flash-decoding ``decode_attention`` kernel registers
    keyed per cache-length bucket (training loops pass nothing — they
    have no decode step).

    Latent attention (``cfg.kv_lora_rank``) registers its expanded
    prefill's flash attention at q and k head dim ``d_head`` over v head
    dim ``v_head_dim``, every head its own keys, and no
    ``decode_attention``: its decode reads the latent cache in plain
    PyTorch (:func:`repro_torch.models.layers._mla_decode`).
    """
    dt = str(cfg.compute_dtype).removeprefix("torch.")
    specs: list[tuple[str, dict]] = [
        # pre-attention / pre-MLP norms run over the flattened tokens
        ("rmsnorm", {"N": batch * seq, "d": cfg.d_model, "dtype": dt}),
        # MLP up-projection: the model's hot matmul shape
        ("matmul", {"M": batch * seq, "N": cfg.d_ff, "K": cfg.d_model,
                    "dtype": dt}),
    ]
    if cfg.kv_lora_rank:
        specs.append(
            ("attention", {"B": batch, "Tq": seq, "Tkv": seq, "H": cfg.n_heads,
                           "Hk": cfg.n_heads, "Dh": cfg.d_head, "Dv": cfg.v_head_dim,
                           "causal": True, "dtype": dt}))
    elif cfg.n_heads and cfg.d_head:
        specs.append(
            ("attention", {"B": batch, "Tq": seq, "Tkv": seq,
                           "H": cfg.n_heads, "Hk": cfg.n_kv_heads,
                           "Dh": cfg.d_head, "causal": True, "dtype": dt}))
        if max_len:
            # decode path: the KV-chunk scan over the allocated cache
            specs.append(
                ("decode_attention", {"B": batch, "S": int(max_len),
                                      "H": cfg.n_heads,
                                      "Hk": cfg.n_kv_heads,
                                      "Dh": cfg.d_head, "dtype": dt}))
    return specs
