"""RecurrentGemma-9B [arXiv:2402.19427; unverified]. Griffin: RG-LRU
recurrent blocks + local attention 2:1, MQA (kv=1), window 2048.
38L d_model=4096 16H d_ff=12288 vocab=256000."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        segments=(
            (("rglru", "rglru", "attn_local"), 12),
            (("rglru",), 2),
        ),
        window_size=2048,
        lru_width=4096,
        rope_theta=1e4,
        rope_theta_local=1e4,
        act="gelu",
        embed_scale=True,
        tie_embeddings=True,
        subquadratic=True,
    )
