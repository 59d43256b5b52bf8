"""deepseek-v2-lite [moe] — latent attention (MLA, kv_lora_rank 512, no
q_lora), YaRN RoPE, layer 0 a dense SwiGLU, layers 1-26 64 routed experts
top-6 (softmax, no renormalisation) beside 2 shared experts.
[hf:deepseek-ai/DeepSeek-V2-Lite; hf] The port's own: the reference has
no latent attention."""

from repro_torch.configs.base import MLAConfig, YarnScaling

CONFIG = MLAConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=192,              # qk_nope_head_dim + qk_rope_head_dim
    d_ff=1408,               # one routed (and one shared) expert's width
    vocab=102400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    rope_theta=1e4,
    act="swiglu",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=10944,
    norm_topk_prob=False,
    rope_scaling=YarnScaling(factor=40.0, original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707),
)
