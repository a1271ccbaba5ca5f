"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-90B-Vision; unverified].
100L backbone: cross-attention to (stub) vision patch embeddings every 5th
layer. d_model=8192 64H (kv=8) d_ff=28672 vocab=128256."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        segments=((("attn", "attn", "attn", "attn", "cross"), 20),),
        rope_theta=5e5,
        tie_embeddings=False,
        cross_source="vision",
        encoder_seq=1601,        # vision tokens (stub patch embeddings)
        encoder_dim=1280,        # pre-projection stub dim
        optimizer="adafactor",
        grad_accum_dtype="bfloat16",
        subquadratic=False,
    )
