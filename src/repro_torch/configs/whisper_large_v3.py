"""Whisper-large-v3 [arXiv:2212.04356; unverified]. Encoder-decoder backbone;
conv frontend is a STUB (input_specs provides post-conv frame embeddings,
(B, 1500, 1280)). 32 enc + 32 dec layers, d_model=1280 20H (MHA) d_ff=5120
vocab=51866 (padded to 51968 for sharding). Decoder positions are learned;
the 4k/32k decode shapes exercise the backbone beyond whisper's native 448-
token decoder limit."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        segments=((("cross",), 32),),
        num_encoder_layers=32,
        encoder_seq=1500,
        encoder_dim=1280,
        cross_source="audio",
        norm="layernorm",
        act="gelu",
        mlp_gated=False,
        pos_embed="learned",
        max_position=33_280,    # covers decode_32k; whisper native is 448
        tie_embeddings=True,
        subquadratic=False,
    )
