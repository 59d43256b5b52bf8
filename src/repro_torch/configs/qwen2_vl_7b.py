"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).
[arXiv:2409.12191; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),   # sums to d_head/2 = 64
    vision_patches=1024,
    rope_theta=1e6,
    act="swiglu",
    microbatches=8,   # fits 16 GB/device on the 16x16 mesh (EXPERIMENTS §Dry-run)
)
