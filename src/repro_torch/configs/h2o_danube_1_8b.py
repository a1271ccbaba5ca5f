"""H2O-Danube-1.8B [arXiv:2401.16818; hf]. Llama+Mistral mix with sliding-
window attention. 24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        segments=((("attn_local",), 24),),
        window_size=4096,
        rope_theta=1e4,
        rope_theta_local=1e4,
        tie_embeddings=False,
        subquadratic=True,     # pure SWA
    )
