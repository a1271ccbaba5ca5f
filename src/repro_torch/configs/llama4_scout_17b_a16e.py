"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
MoE 16 experts top-1 + shared expert every layer; iRoPE pattern — 3 chunked
local-attention layers (RoPE) : 1 global layer (NoPE).
48L d_model=5120 40H (kv=8) d_ff_expert=8192 vocab=202048."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        segments=((("moe_local", "moe_local", "moe_local", "moe_nope"), 12),),
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
        window_size=8192,
        rope_theta=5e5,
        tie_embeddings=False,
        optimizer="adafactor",
        subquadratic=False,     # global NoPE layers are full attention
    )
