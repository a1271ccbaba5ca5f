"""Gemma-3-4B [hf:google/gemma-3-*-pt; unverified]. 5:1 local:global
attention (window 1024), head_dim=256, GeGLU, 262k vocab, embed scaling.
34L d_model=2560 8H (kv=4) d_ff=10240."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        segments=(
            (("attn_local",) * 5 + ("attn",), 5),   # 5 blocks of 5L:1G = 30
            (("attn_local",), 4),                   # remainder locals = 34
        ),
        window_size=1024,
        rope_theta=1e6,
        rope_theta_local=1e4,
        act="gelu",
        embed_scale=True,
        tie_embeddings=True,
        subquadratic=True,     # local-dominant; global decode cache seq-sharded
    )
