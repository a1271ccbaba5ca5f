"""StarCoder2-3B [arXiv:2402.19173; hf]. Dense GQA + RoPE, LayerNorm,
plain-GELU MLP. 30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        segments=((("attn",), 30),),
        rope_theta=1e6,
        norm="layernorm",
        act="gelu",
        mlp_gated=False,
        tie_embeddings=True,
        subquadratic=False,
    )
