"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained d_ff=768.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=768,
    vocab=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1e6,
    act="swiglu",
    microbatches=8,   # fits 16 GB/device on the 16x16 mesh (EXPERIMENTS §Dry-run)
)
