"""Architecture registry: --arch <id> resolves through REGISTRY, then
PORT_ONLY.

Mirrors ``repro/configs/__init__.py``: ``REGISTRY`` holds the reference's
architectures, and ``PORT_ONLY`` those the port serves that the
reference has no counterpart of (latent attention).
"""

from repro_torch.configs.base import (
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
    MLAConfig, ModelConfig, ShapeSpec, YarnScaling,
)

from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE
from repro_torch.configs.command_r_35b import CONFIG as COMMAND_R
from repro_torch.configs.deepseek_coder_33b import CONFIG as DEEPSEEK_CODER
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN2_5
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA
from repro_torch.configs.deepseek_v2_lite import CONFIG as DEEPSEEK_V2_LITE

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        LLAMA4_SCOUT, QWEN3_MOE, COMMAND_R, DEEPSEEK_CODER, QWEN2_5,
        DEEPSEEK_7B, RWKV6, QWEN2_VL, WHISPER_TINY, HYMBA,
    )
}


PORT_ONLY: dict[str, ModelConfig] = {c.name: c for c in (DEEPSEEK_V2_LITE,)}


def get_config(name: str) -> ModelConfig:
    for reg in (REGISTRY, PORT_ONLY):
        if name in reg:
            return reg[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted({**REGISTRY, **PORT_ONLY})}")
