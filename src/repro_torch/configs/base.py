"""Model/runtime configuration dataclasses.

Mirrors ``repro/configs/base.py``: the same fields and defaults, with
torch dtypes. One ``ModelConfig`` per assigned architecture lives in
``src/repro_torch/configs/<id>.py``; reduced smoke-test variants are
derived via ``.reduced()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512      # GShard dispatch group length (tokens)
    # --- SSM / RWKV ---
    ssm_state: int = 16
    ssm_conv: int = 4
    rwkv_head_size: int = 64
    # --- attention details ---
    qkv_bias: bool = False
    use_rope: bool = True          # False: absolute positions (whisper)
    rope_theta: float = 1e6
    window: int | None = None      # sliding-window attention (tokens)
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    parallel_block: bool = False   # command-r style parallel attn+FFN
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu | sqrelu
    logit_softcap: float | None = None
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500
    # --- vlm ---
    vision_patches: int = 0        # stub frontend: # of precomputed patches
    # --- numerics / runtime ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: str = "dots"            # none | dots | full
    attn_q_chunk: int = 512    # §Perf H8b: larger chunks cut kv re-reads
    attn_k_chunk: int = 1024
    decode_k_chunk: int = 4096     # flash-decoding KV-chunk (serve tuning)
    scan_chunk: int = 128          # rwkv/ssm chunk length
    attn_impl: str = "chunked"     # chunked | ref | pallas
    attn_scores_f32: bool = True   # False: bf16 score blocks (models the
                                   # Pallas kernel's VMEM-resident scores)
    max_decode_len: int = 32768
    microbatches: int = 0          # grad-accumulation steps (0 = auto)

    # --- latent attention (MLA), leading dense layers, routing without
    # renormalisation, YaRN: fields of :class:`MLAConfig` alone (the
    # reference's configs have none of them); every other config reads
    # these class-level values, which leave its paths as they are
    kv_lora_rank = 0               # 0: multi-head attention, no latent cache
    qk_nope_head_dim = 0
    qk_rope_head_dim = 0
    v_head_dim = 0
    first_k_dense = 0              # leading layers with a dense FFN
    dense_d_ff = 0                 # their width
    norm_topk_prob = True          # renormalise the router's top-k gates
    rope_scaling = None            # YarnScaling, or None

    # ------------------------------------------------------------- derived
    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.d_head

    @property
    def supports_long_decode(self) -> bool:
        """O(1)-state decode (SSM/hybrid) — eligible for long_500k."""
        return self.family in ("rwkv", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * d
        # whisper ties the unembedding and adds a learned decoder pos table
        out_head = V * d if self.family != "encdec" \
            else self.max_decode_len * d
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid"):
            attn = d * self.d_qkv + 2 * d * self.n_kv_heads * self.d_head \
                + self.d_qkv * d
            per_layer += attn
        if self.family == "hybrid":
            # mamba branch: in/out proj + ssm params
            di = self.d_model
            per_layer += 2 * d * di + di * d + 2 * di * self.ssm_state * 2
        if self.family == "rwkv":
            per_layer += 6 * d * d          # r,k,v,g,o,w projections
            per_layer += 2 * d * ff         # channel mix (sq-relu)
        elif self.family == "moe":
            n_mat = 3 if self.act == "swiglu" else 2
            per_layer += self.n_experts * n_mat * d * ff + d * self.n_experts
            per_layer += self.n_shared_experts * n_mat * d * ff
        else:
            n_mat = 3 if self.act == "swiglu" else 2
            per_layer += n_mat * d * ff
        total = emb + out_head + L * per_layer
        if self.family == "encdec":
            enc_per = d * self.d_qkv * 2 + 2 * d * self.n_kv_heads * self.d_head \
                + 2 * d * ff
            total += self.enc_layers * enc_per
            total += L * (d * self.d_qkv + 2 * d * self.n_kv_heads * self.d_head
                          + self.d_qkv * d)  # cross-attention
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE discounts inactive experts)."""
        if self.family != "moe":
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        n_mat = 3 if self.act == "swiglu" else 2
        inactive = self.n_experts - (self.top_k + self.n_shared_experts)
        return self.n_params() - L * inactive * n_mat * d * ff

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_group_size=32,
            ssm_state=8,
            rwkv_head_size=16,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=32,
            vision_patches=min(self.vision_patches, 16) if self.vision_patches else 0,
            window=min(self.window, 32) if self.window else None,
            mrope_sections=(4, 2, 2) if self.mrope_sections else None,
            attn_q_chunk=32,
            attn_k_chunk=32,
            scan_chunk=16,
            max_decode_len=128,
            microbatches=0,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """YaRN's RoPE scaling, as DeepSeek-V2's ``rope_scaling`` (type
    ``"yarn"``) gives it: the frequencies past the correction range
    divided by ``factor``, a linear ramp between (see
    :func:`repro_torch.models.layers.rope_freqs`), and the attention's
    softmax scale times ``yarn_mscale(factor, mscale_all_dim)`` squared."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A DeepSeek-V2 decoder: latent attention (MLA) in every layer, the
    first ``first_k_dense`` layers a dense SwiGLU of ``dense_d_ff``, the
    rest routed experts of ``d_ff`` beside ``n_shared_experts`` shared
    ones. ``d_head`` is a query's and a key's head dim (``qk_nope_head_dim
    + qk_rope_head_dim``); a value's is ``v_head_dim``. The port's own: the
    reference has no such architecture."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 0
    dense_d_ff: int = 0
    norm_topk_prob: bool = True
    rope_scaling: YarnScaling | None = None

    def n_params(self) -> int:
        d, H, L, V = self.d_model, self.n_heads, self.n_layers, self.vocab
        R, rope = self.kv_lora_rank, self.qk_rope_head_dim
        attn = (d * H * self.d_head + d * (R + rope) + R
                + R * H * (self.qk_nope_head_dim + self.v_head_dim) + H * self.v_head_dim * d)
        swiglu = 3 * d
        experts = (self.n_experts + self.n_shared_experts) * swiglu * self.d_ff \
            + d * self.n_experts
        k = self.first_k_dense
        return (2 * V * d + d + L * (attn + 2 * d) + k * swiglu * self.dense_d_ff
                + (L - k) * experts)

    def n_active_params(self) -> int:
        inactive = self.n_experts - self.top_k
        return self.n_params() - (self.n_layers - self.first_k_dense) * inactive \
            * 3 * self.d_model * self.d_ff

    def reduced(self, **overrides: Any) -> "MLAConfig":
        small = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                     v_head_dim=16, d_head=24, dense_d_ff=96,
                     first_k_dense=min(self.first_k_dense, 1))
        small.update(overrides)
        return super().reduced(**small)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
