"""A kind of block for the tests: the ``transformer`` kind's experts with
shared experts beside them (``n_shared_experts`` in the configuration,
DeepSeek's key), each as wide as a routed one and run by every token,
ungated, as the port's MoE layer runs them (``ModelConfig.n_shared_experts``:
one SwiGLU of ``n_shared_experts`` times the expert width, its output
added to the routed experts'). ``perfbench/tests/test_bench_kinds.py``
adds it to a copy of the checkout by files alone."""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

from pbench.spec import load_file_module
from pbench.yardstick import BF16_BYTES

base = load_file_module(Path(__file__).with_name("transformer.py"), "reference")

head_flops = base.head_flops
causal_attention_flops = base.causal_attention_flops
decode_attention_flops = base.decode_attention_flops
small_config = base.small_config


@dataclasses.dataclass(frozen=True)
class Shapes(base.Shapes):
    shared: int = 0      # shared experts, each of the routed experts' width

    @property
    def shared_ff(self) -> int:
        return self.shared * self.d_ff


def shapes(conf: dict) -> Shapes:
    return Shapes(**dataclasses.asdict(base.shapes(conf)), shared=int(conf["n_shared_experts"]))


def param_layout(s: Shapes) -> list:
    L, d, ff = s.n_layers, s.d, s.shared_ff
    return base.param_layout(s) + [
        (("layers", "ffn", "shared", "w_gate"), (L, d, ff), 1.0 / math.sqrt(d)),
        (("layers", "ffn", "shared", "w_up"), (L, d, ff), 1.0 / math.sqrt(d)),
        (("layers", "ffn", "shared", "w_down"), (L, ff, d), 1.0 / math.sqrt(ff)),
    ]


def program_fields(s: Shapes, conf: dict) -> dict:
    return dict(base.program_fields(s, conf), n_shared_experts=s.shared)


def linear_flops_per_token(s: Shapes) -> float:
    return base.linear_flops_per_token(s) + 2.0 * s.n_layers * 3 * s.d * s.shared_ff


def moe_call(s: Shapes, tokens: int, experts_used: int) -> tuple[float, float]:
    flops, nbytes = base.moe_call(s, tokens, experts_used)
    return (flops + 2.0 * tokens * 3 * s.d * s.shared_ff,
            nbytes + BF16_BYTES * 3 * s.d * s.shared_ff)


def _ffn(h, p, s, calls, products):
    return base.ffn(h, p, s, calls, products) + base._mlp(h, p["shared"], products)


def served_logits(params, conf, prompts, served, products="fp32"):
    return base.served_logits(params, conf, prompts, served, products, ffn=_ffn)
