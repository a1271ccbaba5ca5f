"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]. Llama-arch dense GQA.
62L d_model=7168 56H (kv=8) d_ff=19200 vocab=32256."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        segments=((("attn",), 62),),
        rope_theta=1e5,
        tie_embeddings=False,
        optimizer="adafactor",
        subquadratic=False,
    )
