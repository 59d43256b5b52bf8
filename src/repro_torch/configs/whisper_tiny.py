"""whisper-tiny [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    enc_layers=4,
    enc_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    use_rope=False,
    act="gelu",
)
