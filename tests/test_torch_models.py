"""The port's models against the reference's on the same JAX-initialized
params (carried over with ``params_from_numpy``), in f32 at reduced size:
forward logits, and prefill + decode logits and greedy tokens. Configs with
cross layers get the same numpy-seeded ``enc_input`` in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_step import greedy_token

# f32 logits tolerance: one layer agrees to ~2e-6; random-init depth
# amplifies last-ulp differences between XLA's and torch's f32 kernels about
# threefold per layer, and reduced gemma3-4b has 7 layers (~2e-4 measured).
# Reduced recurrentgemma-9b has 4 layers (3 rglru, 1 attn_local); on the CPU
# the reference's rglru layers run the associative scan and the port's the
# sequential one, which round differently (1.1e-5 measured on the forward,
# 3e-6 on prefill and decode). Reduced xlstm-350m has 8 layers (7 mlstm,
# 1 slstm); its chunked mLSTM and sequential sLSTM sum in other orders than
# XLA's (2.4e-5 measured on the forward, 1.3e-5 on prefill and decode).
# Reduced deepseek-coder-33b (1 attn layer, RMSNorm, gated SiLU MLP) and
# h2o-danube-1.8b (1 attn_local layer, window 16, so the 20-token prompt
# takes the ring path): 7.5e-6 and 1.3e-5 measured on the forward, 6.4e-6
# and 6.3e-6 on prefill and decode. Reduced deepseek-v3-671b (one mla_dense
# and one mla_moe layer, 4 experts at top-2 and a shared expert, its MTP
# module carried but not read): 1.1e-5 measured on the forward, 3.0e-6 on
# prefill and 5.6e-6 on the absorbed decode. Reduced whisper-large-v3 (2 enc
# layers, 1 cross layer, LayerNorm, GELU, learned decoder positions, 16
# frames): 2.4e-5 measured on the forward, 1.3e-5 on prefill and decode.
# Reduced llama-3.2-vision-90b (one (attn x 4, cross) unit over 16
# projected patches, untied logits reaching 3.8): 5.9e-4 measured on the
# forward, 1.3e-3 on prefill and decode; each of its layers agrees to 1e-5
# of its output's scale (tests/test_torch_cross.py), and 5 layers amplify
ARCHS = {"starcoder2-3b": 1e-4, "gemma3-4b": 1e-3, "recurrentgemma-9b": 1e-4,
         "xlstm-350m": 1e-4, "deepseek-coder-33b": 1e-4,
         "h2o-danube-1.8b": 1e-4, "deepseek-v3-671b": 1e-4,
         "whisper-large-v3": 1e-4, "llama-3.2-vision-90b": 2e-3}


def _pair(arch):
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def _enc_input(cfg, batch, seed):
    """(B, S_enc, encoder_dim) frames for configs with cross layers, else
    None."""
    if not cfg.encoder_seq:
        return None
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.encoder_seq, cfg.encoder_dim)).astype(np.float32)


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_logits_match_reference(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    assert cfg.param_count() == jcfg.param_count()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    enc = _enc_input(cfg, 2, 4)
    exp = np.asarray(jmodel.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                    _jax(enc)))
    out = model.forward(params, torch.as_tensor(tokens), _torch(enc))
    assert out.shape == exp.shape
    np.testing.assert_allclose(out.numpy(), exp, atol=ARCHS[arch], rtol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_match_reference(arch):
    """Prompt of 20 tokens (longer than reduced gemma's 16-token window, so
    its local layers take the ring-alignment path), then 6 decode steps fed
    the reference's greedy tokens: the same tokens and close logits."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    tol = ARCHS[arch]
    prompts = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 20))
    enc = _enc_input(cfg, 2, 5)
    jcache = jmodel.init_cache(2, 32)
    cache = model.init_cache(2, 32, device="cpu")
    jlogits, jcache = jmodel.prefill(jparams, jcache,
                                     jnp.asarray(prompts, jnp.int32),
                                     _jax(enc))
    logits, cache = model.prefill(params, cache, torch.as_tensor(prompts),
                                  _torch(enc))
    for pos in range(20, 26):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=tol, rtol=0)
        tok = greedy_token(cfg, logits)
        jtok = np.asarray(jnp.argmax(jlogits[..., :jcfg.vocab_size], -1))
        np.testing.assert_array_equal(tok.numpy(), jtok)
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, jnp.asarray(jtok, jnp.int32),
            jnp.asarray(pos, jnp.int32))
        logits, cache = model.decode_step(params, cache, tok, pos)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_forward_last_token(arch):
    """Prefill's last-position logits equal the forward's (cache path end
    to end, port alone)."""
    _, _, _, cfg, model, params = _pair(arch)
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12)))
    enc = _torch(_enc_input(cfg, 1, 6))
    full = model.forward(params, tokens, enc)
    pre, _ = model.prefill(params, model.init_cache(1, 32, device="cpu"),
                           tokens, enc)
    torch.testing.assert_close(pre[:, 0], full[:, -1], atol=1e-5, rtol=1e-5)
