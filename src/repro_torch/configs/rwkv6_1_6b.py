"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # derived: d_model / rwkv_head_size
    n_kv_heads=32,
    d_head=64,
    rwkv_head_size=64,
    d_ff=7168,
    vocab=65536,
    act="sqrelu",
)
