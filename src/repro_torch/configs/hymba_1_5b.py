"""hymba-1.5b [hybrid] — parallel attention + mamba heads, sliding-window
attention + SSM state (O(1) decode). [arXiv:2411.13676; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    window=2048,
    rope_theta=1e4,
    act="swiglu",
)
