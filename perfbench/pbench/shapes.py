"""A configuration file's sizes, read the same way by the weights, the
yardstick and the reference (none of which imports the program)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shapes:
    family: str          # dense | moe
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    d_head: int
    d_ff: int            # the dense MLP's width, or one expert's
    vocab: int
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    group_size: int = 0
    rope_theta: float = 1e4
    eps: float = 1e-6

    @property
    def q_width(self) -> int:
        return self.heads * self.d_head

    @property
    def kv_width(self) -> int:
        return self.kv_heads * self.d_head


def shapes(conf: dict) -> Shapes:
    """The sizes of a configuration file (Hugging Face ``config.json``
    keys, with the run's settings under ``runs_as``)."""
    run = conf["runs_as"]
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {conf['hidden_act']!r}: only SwiGLU (silu) is run")
    if conf.get("tie_word_embeddings"):
        raise ValueError("tied embeddings are not run")
    heads = int(conf["num_attention_heads"])
    d = int(conf["hidden_size"])
    moe = run["family"] == "moe"
    return Shapes(
        family=run["family"],
        n_layers=int(conf["num_hidden_layers"]),
        d=d, heads=heads,
        kv_heads=int(conf.get("num_key_value_heads") or heads),
        d_head=int(conf.get("head_dim") or d // heads),
        d_ff=int(conf["moe_intermediate_size"] if moe else conf["intermediate_size"]),
        vocab=int(conf["vocab_size"]),
        experts=int(conf["num_experts"]) if moe else 0,
        top_k=int(conf["num_experts_per_tok"]) if moe else 0,
        capacity_factor=float(run["capacity_factor"]) if moe else 0.0,
        group_size=int(run["moe_group_size"]) if moe else 0,
        rope_theta=float(conf["rope_theta"]),
        eps=float(conf["rms_norm_eps"]),
    )
