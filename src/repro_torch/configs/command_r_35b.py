"""command-r-35b [dense] — GQA kv=8, parallel attn+FFN block, layernorm,
no bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab=256000,
    parallel_block=True,
    norm="layernorm",
    rope_theta=8e6,
    act="swiglu",
)
