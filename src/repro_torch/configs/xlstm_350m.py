"""xLSTM-350M [arXiv:2405.04517; unverified]. xLSTM[7:1] — 7 mLSTM : 1 sLSTM
blocks; no positional embeddings. 24L d_model=1024 4H vocab=50304."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        segments=(((("mlstm",) * 7) + ("slstm",), 3),),
        mlstm_proj_factor=2.0,
        pos_embed="none",
        tie_embeddings=True,
        param_dtype="float32",   # small model; recurrent gates are bf16-fragile
        subquadratic=True,
    )
