"""Configuration dataclasses + registry for all architectures.

A ModelConfig fully describes one architecture. Layer stacks are expressed as
``segments``: an ordered tuple of (unit, repeats) where ``unit`` is a tuple of
layer-kind names. The reference lowers each segment as ONE ``lax.scan``
over ``repeats``; parameters are stacked along that leading dimension.

The PyTorch port's own copy of ``repro/configs/base.py``: the same
dataclasses and ``reduced()``, with ``param_count`` answered by the port's
model registry. In the port each segment runs as a Python loop over the
stacked leading dimension.

Layer kinds the port builds so far (see models/transformer.py registry):
  attn        global self-attention + dense MLP
  attn_local  sliding-window self-attention + dense MLP (same param shapes as attn)
  rglru       RG-LRU recurrent block (Griffin) + dense MLP
  mlstm       xLSTM matrix-memory block (chunkwise-parallel kernel)
  slstm       xLSTM scalar-memory block (sequential) + gated FFN
  moe         global self-attention + MoE FFN (routed experts + optional shared)
  moe_local   sliding-window self-attention + MoE FFN
  moe_nope    global self-attention without RoPE (NoPE) + MoE FFN
  mla_dense   multi-head latent attention (DeepSeek-V3) + dense MLP
  mla_moe     multi-head latent attention + MoE FFN
  cross       self-attention + cross-attention + dense MLP (vision / decoder)
  enc         bidirectional self-attention + dense MLP (encoder)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

Segment = Tuple[Tuple[str, ...], int]  # (unit kinds, repeats)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | hybrid | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    head_dim: Optional[int] = None   # default: d_model // num_heads

    # --- attention details ---
    window_size: int = 0             # sliding window for attn_local (tokens)
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    logit_softcap: float = 0.0       # gemma-style attention logit soft-capping

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_noise: float = 0.0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.0     # load-balance aux loss (deepseek uses bias instead)

    # --- MLA (DeepSeek-V3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- recurrent (RG-LRU / xLSTM) ---
    conv1d_width: int = 4
    lru_width: int = 0               # default d_model
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- encoder-decoder / cross-attention ---
    num_encoder_layers: int = 0      # whisper encoder depth
    encoder_seq: int = 0             # stub frontend sequence length (frames/patches)
    encoder_dim: int = 0             # stub frontend embedding dim (pre-projection)
    cross_source: str = ""           # "audio" | "vision" | ""

    # --- embeddings / numerics ---
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d_model) embedding scaling
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu | geglu is implied by mlp kind
    mlp_gated: bool = True           # SwiGLU/GeGLU vs plain 2-layer MLP
    pos_embed: str = "rope"          # rope | learned | sincos (enc side)
    max_position: int = 532_000      # learned-pos table size if pos_embed=learned

    # --- numerics / memory policy ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    grad_accum_dtype: str = "float32"
    optimizer: str = "adamw"         # adamw | adafactor
    remat: str = "full"              # full | nothing_saveable-like policy name

    # --- capability flags (drive the cell matrix) ---
    subquadratic: bool = False       # eligible for long_500k
    has_decoder: bool = True         # decode shapes apply
    mtp_depth: int = 0               # deepseek multi-token-prediction modules

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(len(unit) * reps for unit, reps in self.segments)

    def param_count(self) -> int:
        """Analytic parameter count (matches init)."""
        from repro_torch.models.registry import count_params
        return count_params(self)


# ---------------------------------------------------------------------------
# registry

_REGISTRY: dict = {}


def register(fn: Callable[[], ModelConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = cfg
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def _load_all():
    # import every config module once so @register side effects run
    import importlib
    for mod in ("starcoder2_3b", "gemma3_4b", "recurrentgemma_9b",
                "xlstm_350m", "deepseek_coder_33b", "h2o_danube_1_8b",
                "llama4_scout_17b_a16e", "deepseek_v3_671b",
                "whisper_large_v3", "llama_3_2_vision_90b"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduced(cfg: ModelConfig, *, d_model: int = 64, vocab: int = 128) -> ModelConfig:
    """A tiny config of the same family/pattern for CPU smoke tests.

    Keeps one repeat of every distinct segment unit so every layer kind in the
    architecture is exercised, but shrinks widths to toy scale.
    """
    heads = 4
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 2
    segs = tuple((unit, min(reps, 1)) for unit, reps in cfg.segments)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=d_model * 2,
        vocab_size=vocab,
        segments=segs,
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=d_model * 2 if cfg.d_ff_expert else 0,
        d_ff_shared=d_model * 2 if cfg.d_ff_shared else 0,
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        lru_width=d_model if cfg.lru_width else 0,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        encoder_dim=32 if cfg.encoder_dim else 0,
        max_position=4_096,
        param_dtype="float32",
        compute_dtype="float32",
    )
