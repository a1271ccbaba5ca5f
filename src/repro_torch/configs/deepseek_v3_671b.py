"""DeepSeek-V3-671B [arXiv:2412.19437; hf]. MLA attention (compressed KV),
3 dense + 58 MoE layers, 256 routed experts top-8 + 1 shared.
61L d_model=7168 128H d_ff_expert=2048 (dense 18432) vocab=129280."""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,       # informational; MLA cache is latent, not per-head
        d_ff=18432,             # dense layers (first 3)
        vocab_size=129280,
        segments=(
            (("mla_dense",), 3),
            (("mla_moe",), 58),
        ),
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=1e4,
        tie_embeddings=False,
        optimizer="adafactor",
        grad_accum_dtype="bfloat16",
        subquadratic=True,      # 500k decode viable: latent cache, seq-sharded
        mtp_depth=1,
    )
