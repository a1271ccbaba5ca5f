"""The port's ``cross`` and ``enc`` kinds, ``_encode``, whisper-large-v3 and
llama-3.2-vision-90b against the reference, on the CPU in f32 at reduced
size (whisper: 2 enc layers, 1 cross layer, 16 frames of ``encoder_dim``
32; llama-3.2-vision: one ``(attn x 4, cross)`` unit over 16 projected
patches): the layers' apply, prefill (self and cross caches) and decode,
the encoder, parameter counts, a checkpoint written by the reference's
manager and restored by the port's through its burst buffer, served
tokens, and the serving CLI. Inputs are numpy-seeded; parameters are built
by the reference and carried into the port through the checkpoint format
or ``params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_buffer import STEADY_PING_S

from repro.checkpoint import serializer as jser
from repro.checkpoint.bbckpt import BBCheckpointManager as JManager
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import transformer as jtransformer
from repro.models.common import init_tree as jinit_tree
from repro.models.registry import build_model as jbuild_model
from repro.models.registry import count_params as jcount_params
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.launch.serve import serve_batch
from repro_torch.models import attention, transformer
from repro_torch.models.common import map_tree
from repro_torch.models.registry import build_model, count_params

WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-90b"
# f32 on the same params and inputs: |port - reference| <= LAYER_TOL times
# the output's largest magnitude plus LAYER_TOL of the element. The
# reference's init draws the (d, heads, head_dim) projections with the
# head axis as fan-in, so reduced scores have a standard deviation near 16
# and the layer outputs reach 60; the softmax then carries f32 rounding to
# 3.4e-4 (whisper's cross layer) and 4.4e-4 (vision's) in absolute terms,
# 5.4e-6 and 8.4e-6 of the largest output, and an f64 run of the port puts
# both packages equally far from exact (3.9e-4 and 4.0e-4 for whisper's)
LAYER_TOL = 1e-5
# the layers under test: (arch, kind)
LAYERS = [(WHISPER, "enc"), (WHISPER, "cross"), (VISION, "cross")]


def _np(t):
    return t.detach().numpy()


def _close(out, exp):
    exp = np.asarray(exp)
    assert out.shape == exp.shape
    np.testing.assert_allclose(_np(out), exp, rtol=LAYER_TOL,
                               atol=LAYER_TOL * np.abs(exp).max())


def _kind_pair(arch, kind, seed=3):
    """The reduced config's ``kind`` block, params from the reference."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = jinit_tree(jtransformer.KINDS[kind].descs(jcfg),
                    jax.random.PRNGKey(seed), jnp.float32)
    p = params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jp, cfg, p


def _inputs(cfg, seed, b=2, s=20):
    """x (B, S, d), the context (B, S_enc, d) and positions (B, S)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    ctx = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return x, ctx, pos


def test_reduced_configs_and_trees_match_reference():
    """Reduced whisper keeps 2 enc layers and one cross layer over 16
    frames of 32 (LayerNorm, GELU, learned decoder positions); reduced
    vision one (attn x 4, cross) unit and the projection only. Both trees
    have the reference's leaf paths and shapes."""
    for arch in (WHISPER, VISION):
        jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        params = build_model(cfg).init(0, device="cpu")
        got = [(n, tuple(t.shape)) for n, t in ser.tree_paths(params)]
        assert got == [(n, tuple(a.shape))
                       for n, a in jser.tree_paths(jparams)]
        shapes = dict(got)
        assert shapes["enc_proj"] == (32, cfg.d_model)
        assert (cfg.encoder_seq, cfg.encoder_dim) == (16, 32)
        if arch == WHISPER:
            assert cfg.segments == ((("cross",), 1),)
            assert cfg.num_encoder_layers == 2
            assert shapes["encoder/0/attn/wq"] == (2, cfg.d_model, 4, 16)
            assert shapes["enc_final_norm/bias"] == (cfg.d_model,)
            assert shapes["embed/positions"] == (4096, cfg.d_model)
        else:
            assert cfg.segments == ((("attn",) * 4 + ("cross",), 1),)
            assert not any(n.startswith(("encoder", "enc_final"))
                           for n in shapes)
        assert shapes["segments/seg0/" + str(len(cfg.segments[0][0]) - 1)
                      + "/xattn/wk"][1:] == (cfg.d_model, cfg.num_kv_heads,
                                            16)


@pytest.mark.parametrize("arch,kind", LAYERS)
def test_layer_apply_matches_reference(arch, kind):
    """The training / scoring form: enc (bidirectional self-attention),
    cross (causal self-attention, then the flash kernel non-causally over
    a 16-frame context: Sq 20 != Sk 16)."""
    jcfg, jp, cfg, p = _kind_pair(arch, kind)
    x, ctx, pos = _inputs(cfg, 7)
    exp = jtransformer.KINDS[kind].apply(
        jcfg, jp, jnp.asarray(x), {"positions": jnp.asarray(pos),
                                   "ctx": jnp.asarray(ctx)})
    out = transformer.KINDS[kind].apply(
        cfg, p, torch.as_tensor(x), {"positions": torch.as_tensor(pos),
                                     "ctx": torch.as_tensor(ctx)})
    _close(out, exp)


def test_enc_layer_is_bidirectional():
    """The enc kind is the attn kind with causal=False: on the same params
    the last position (which sees every key either way) agrees with the
    attn kind's, the first does not."""
    _, _, cfg, p = _kind_pair(WHISPER, "enc")
    x, _, pos = _inputs(cfg, 8)
    ext = {"positions": torch.as_tensor(pos), "ctx": None}
    y = transformer.KINDS["enc"].apply(cfg, p, torch.as_tensor(x), ext)
    causal = transformer.KINDS["attn"].apply(cfg, p, torch.as_tensor(x), ext)
    torch.testing.assert_close(y[:, -1], causal[:, -1])
    assert (y[:, 0] - causal[:, 0]).abs().max() > 1e-2


@pytest.mark.parametrize("arch,kind", LAYERS)
def test_prefill_and_decode_match_reference_with_their_caches(arch, kind):
    """Prefill over 20 tokens (cross: the self cache from position 0 and
    the context's K / V cache), then 4 decode steps against the caches:
    outputs and every cache after the prefill and after each step."""
    jcfg, jp, cfg, p = _kind_pair(arch, kind, seed=4)
    jk, k = jtransformer.KINDS[kind], transformer.KINDS[kind]
    b, s, max_seq = 2, 20, 32
    x, ctx, pos = _inputs(cfg, 9, b, s)
    jcache = jk.init_cache(jcfg, b, max_seq)
    cache = k.init_cache(cfg, b, max_seq, "cpu")
    assert map_tree(lambda t: tuple(t.shape), cache) == jax.tree.map(
        lambda a: tuple(a.shape), jcache)
    jy, jcache = jk.prefill(jcfg, jp, jnp.asarray(x), jcache,
                            {"positions": jnp.asarray(pos),
                             "ctx": jnp.asarray(ctx)})
    with torch.inference_mode():
        y, cache = k.prefill(cfg, p, torch.as_tensor(x), cache,
                             {"positions": torch.as_tensor(pos),
                              "ctx": torch.as_tensor(ctx)})

    def same(jy, y):
        _close(y, jy)
        for (name, t), (_, a) in zip(ser.tree_paths(cache),
                                     jser.tree_paths(jcache)):
            _close(t, a)

    same(jy, y)
    assert not cache["kv"]["k"][:, s:].any()
    rng = np.random.default_rng(10)
    for t in range(s, s + 4):
        xt = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jk.decode(jcfg, jp, jnp.asarray(xt), jcache,
                               {"pos": jnp.asarray(t, jnp.int32),
                                "positions": jnp.full((b, 1), t, jnp.int32)})
        with torch.inference_mode():
            y, cache = k.decode(cfg, p, torch.as_tensor(xt), cache,
                                {"pos": t})
        same(jy, y)


def test_decode_cross_attention_runs_in_a_profiler_range():
    """The decode's attention over the context cache runs in a profiler
    range "xattn_cache", which chip_smoke.py's decode profile reads."""
    from torch.profiler import ProfilerActivity, profile
    _, _, cfg, p = _kind_pair(WHISPER, "cross")
    cache = attention.init_cross_cache(cfg, 2, cfg.encoder_seq, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        attention.decode_cross_attention(cfg, p["xattn"],
                                         torch.randn(2, 1, cfg.d_model),
                                         cache)
    assert [e.name for e in prof.events()].count("xattn_cache") == 1


@pytest.fixture(scope="module", params=[WHISPER, VISION])
def pair(request):
    arch = request.param
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def test_encode_matches_reference(pair):
    """whisper: the projection in the compute dtype, the sincos table, 2
    enc layers and the final norm; vision: the projection only."""
    jcfg, _, jparams, cfg, _, params = pair
    enc = np.random.default_rng(11).normal(
        size=(2, cfg.encoder_seq, cfg.encoder_dim)).astype(np.float32)
    exp = jtransformer._encode(jcfg, jparams, jnp.asarray(enc))
    out = transformer._encode(cfg, params, torch.as_tensor(enc))
    _close(out, exp)


def test_sincos_table_matches_reference():
    """The port's own copy of the table, at whisper's 1500 x 1280."""
    from repro.models.common import sincos_positions as jsincos
    from repro_torch.models.common import sincos_positions
    np.testing.assert_array_equal(sincos_positions(1500, 1280),
                                  jsincos(1500, 1280))


# the full configs and their reductions -> params
COUNTS = {(WHISPER, "full"): 1_579_176_960, (VISION, "full"): 90_697_342_976}


@pytest.mark.parametrize("arch", [WHISPER, VISION])
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_count_params_matches_reference(arch, size):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if size == "reduced":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    assert count_params(cfg) == jcount_params(jcfg) == cfg.param_count()
    if size == "full":
        assert cfg.param_count() == COUNTS[arch, size]


def test_reference_checkpoint_restores_through_the_buffer_and_serves():
    """Reduced whisper's params, saved by the reference's manager (its
    serializer) into the port's burst buffer and flushed, restored by the
    port's manager into a zero tree: every leaf byte for byte the
    reference's. The restored params then serve the reference's greedy
    tokens for the same prompts and frames (prefill, 6 decode steps)."""
    jcfg, cfg = jreduced(jget_config(WHISPER)), reduced(get_config(WHISPER))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    prompts = rng.integers(1, cfg.vocab_size, (2, 20))
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.encoder_dim)) \
        .astype(np.float32)
    target = map_tree(torch.zeros_like, model.init(0, device="cpu"))
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=STEADY_PING_S)) as bb:
        JManager(bb, quantize=False).save(7, {"params": jparams},
                                          blocking_flush=True)
        restored, step = BBCheckpointManager(bb, quantize=False).restore(
            {"params": target})
    assert step == 7
    got = ser.tree_paths(restored["params"])
    want = jser.tree_paths(jax.device_get(jparams))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, a) in zip(got, want):
        assert t.numpy().tobytes() == np.asarray(a).tobytes(), name
    jtokens = jserve_batch(jcfg, jmodel, jparams,
                           jnp.asarray(prompts, jnp.int32), gen_tokens=7,
                           enc_input=jnp.asarray(enc))
    tokens = serve_batch(cfg, model, restored["params"],
                         torch.as_tensor(prompts), gen_tokens=7,
                         enc_input=torch.as_tensor(enc))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


def test_served_tokens_match_reference(pair):
    """serve_batch with the stub frontend's frames / patches: prefill
    encodes them once, 6 decode steps read the cross cache."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(13)
    prompts = rng.integers(1, cfg.vocab_size, (2, 20))
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.encoder_dim)) \
        .astype(np.float32)
    jtokens = jserve_batch(jcfg, jmodel, jparams,
                           jnp.asarray(prompts, jnp.int32), gen_tokens=7,
                           enc_input=jnp.asarray(enc))
    tokens = serve_batch(cfg, model, params, torch.as_tensor(prompts),
                         gen_tokens=7, enc_input=torch.as_tensor(enc))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


def test_serve_cli_runs_reduced_whisper_on_cpu(capsys):
    """``--arch whisper-large-v3 --reduced --device cpu`` draws the frames
    from the seed and serves end to end."""
    from repro_torch.launch import serve
    serve.main(["--arch", WHISPER, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "4",
                "--requests", "1"])
    out = capsys.readouterr().out
    assert "[serve] request-batch 0: (2, 4)" in out
