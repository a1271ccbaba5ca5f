"""The port's multi-head latent attention and ``deepseek-v3-671b`` against
the reference, on the CPU in f32 at reduced size (q_lora 32, kv_lora 16,
qk_nope 16, qk_rope 8, v 16: the flash head dim is 24, V padded from 16):
``mla_attention`` (prefill) and the absorbed ``decode_mla_attention`` with
the latent cache they fill; the absorbed-decode check ``chip_smoke.py``
runs on the card and two mutations it must catch; the checkpoint bridge
with the MTP module; parameter counts at the full config and the chip's
cuts; the serving CLI. Parameters are built by the reference and carried
into the port through the checkpoint format or ``params_from_numpy``."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import mla as jmla
from repro.models import transformer as jtransformer
from repro.models.common import init_tree as jinit_tree
from repro.models.registry import build_model as jbuild_model
from repro.models.registry import count_params as jcount_params
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.schedule import constant as jconstant
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.models import mla, transformer
from repro_torch.models.attention import NEG_INF, _out_proj
from repro_torch.models.common import map_tree
from repro_torch.models.registry import build_model, count_params

ARCH = "deepseek-v3-671b"
ROOT = Path(__file__).resolve().parents[1]
# f32 on the same params and input, atol = rtol: XLA and torch sum the
# projections and the attention in other orders (up to 1.0e-5 measured on
# the layer's outputs, which reach 15, and on the caches)
LAYER_TOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def kind_pair():
    """The reduced config's mla_dense block, params from the reference."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = jinit_tree(jtransformer.KINDS["mla_dense"].descs(jcfg),
                    jax.random.PRNGKey(3), jnp.float32)
    p = params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jp, cfg, p


def test_reduced_config_and_leaves_match_reference(kind_pair):
    """Reduced deepseek-v3 keeps one mla_dense and one mla_moe layer (4
    experts at top-2) and its MTP module; the MLA leaves have the
    reference's paths and shapes."""
    jcfg, jp, cfg, p = kind_pair
    assert cfg.segments == ((("mla_dense",), 1), (("mla_moe",), 1))
    assert (cfg.num_experts, cfg.top_k, cfg.mtp_depth) == (4, 2, 1)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim) == (32, 16, 16, 8, 16)
    got = [(n, tuple(t.shape)) for n, t in ser.tree_paths(p)]
    assert got == [(n, tuple(a.shape)) for n, a in jser.tree_paths(jp)]
    shapes = dict(got)
    assert shapes["attn/wq_b"] == (32, 4, 24)
    assert shapes["attn/wkv_a"] == (cfg.d_model, 16 + 8)
    assert shapes["attn/wo"] == (4, 16, cfg.d_model)


@pytest.mark.parametrize("seq", [12, 40])
def test_mla_attention_matches_reference(kind_pair, seq):
    """The prefill path (K / V rebuilt from the latent, flash at head dim
    24 with V padded from 16, causal) over 12 and 40 tokens."""
    jcfg, jp, cfg, p = kind_pair
    x = np.random.default_rng(seq).normal(size=(2, seq, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq)).copy()
    exp = jmla.mla_attention(jcfg, jp["attn"], jnp.asarray(x),
                             jnp.asarray(pos))
    out = mla.mla_attention(cfg, p["attn"], torch.as_tensor(x),
                            torch.as_tensor(pos))
    assert out.shape == exp.shape
    np.testing.assert_allclose(_np(out), np.asarray(exp), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


@pytest.mark.parametrize("kind", ["mla_dense", "mla_moe"])
def test_prefill_and_decode_match_reference_with_their_caches(kind):
    """A block of each MLA kind: prefill over 20 tokens, then 4 decode
    steps (the absorbed form over the latent cache): outputs and the
    (c_kv, k_rope) cache after the prefill and after every step."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = jinit_tree(jtransformer.KINDS[kind].descs(jcfg),
                    jax.random.PRNGKey(4), jnp.float32)
    p = params_from_numpy(jax.device_get(jp), device="cpu")
    jk, k = jtransformer.KINDS[kind], transformer.KINDS[kind]
    rng = np.random.default_rng(9)
    b, s, max_seq = 2, 20, 32
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jcache = jk.init_cache(jcfg, b, max_seq)
    cache = k.init_cache(cfg, b, max_seq, "cpu")
    jy, jcache = jk.prefill(jcfg, jp, jnp.asarray(x), jcache,
                            {"positions": jnp.asarray(pos)})
    with torch.inference_mode():
        y, cache = k.prefill(cfg, p, torch.as_tensor(x), cache,
                             {"positions": torch.as_tensor(pos)})

    def same(jy, y):
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_np(cache["mla"][name]),
                                       np.asarray(jcache["mla"][name]),
                                       atol=LAYER_TOL, rtol=LAYER_TOL)

    same(jy, y)
    assert not cache["mla"]["c_kv"][:, s:].any()
    for t in range(s, s + 4):
        xt = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jk.decode(jcfg, jp, jnp.asarray(xt), jcache,
                               {"pos": jnp.asarray(t, jnp.int32)})
        with torch.inference_mode():
            y, cache = k.decode(cfg, p, torch.as_tensor(xt), cache,
                                {"pos": t})
        same(jy, y)


def test_init_mla_cache_shapes():
    """The latent cache holds kv_lora + qk_rope values a token, in the
    compute dtype; the full config's is 512 + 64 bf16."""
    cfg = reduced(get_config(ARCH))
    jc = jmla.init_mla_cache(jreduced(jget_config(ARCH)), 3, 20)
    c = mla.init_mla_cache(cfg, 3, 20, device="cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in c.items()} == {
        "c_kv": ((3, 20, 16), torch.float32),
        "k_rope": ((3, 20, 8), torch.float32)}
    assert {n: tuple(t.shape) for n, t in c.items()} == \
        {n: tuple(a.shape) for n, a in jc.items()}
    full = mla.init_mla_cache(get_config(ARCH), 1, 4, device="meta")
    assert {n: (tuple(t.shape), t.dtype) for n, t in full.items()} == {
        "c_kv": ((1, 4, 512), torch.bfloat16),
        "k_rope": ((1, 4, 64), torch.bfloat16)}


# -------------------------------------------------- the absorbed-decode check

# the check's bound in f32 (relative L2 error of a row's logits, and of its
# first layer's attention output): the two paths agree to 4.3e-7 to 7.5e-7
# at the logits and 3.0e-7 to 5.5e-7 at the attention output here; the
# mutations miss by 0.53 to 1.56 at the logits and 0.36 to 1.43 at the
# attention output, above the card's bf16 bound (chip_smoke.MLA_DECODE_TOL,
# 3.1e-2) too
F32_DECODE_TOL = 1e-4


def _mutant(mutation):
    """``decode_mla_attention`` with one fault: the rope score term dropped,
    or W_uk not absorbed into q (q_nope taken against the latent as it is:
    the reduced qk_nope and kv_lora are both 16)."""
    def decode(cfg, p, x, cache, pos):
        b = x.shape[0]
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        pos_b = torch.full((b, 1), pos, dtype=torch.int32)
        q_nope, q_rope = mla._project_q(cfg, p, x, pos_b)
        c_new, kr_new = mla._compress_kv(cfg, p, x, pos_b)
        cache["c_kv"][:, pos] = c_new[:, 0]
        cache["k_rope"][:, pos] = kr_new[:, 0]
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        q_abs = q_nope if mutation == "wk_b not absorbed" else \
            torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
        s = torch.einsum("bshr,btr->bhst", q_abs, c_kv) * (dn + dr) ** -0.5
        if mutation != "rope term dropped":
            s = s + torch.einsum("bshk,btk->bhst", q_rope, k_rope) \
                * (dn + dr) ** -0.5
        valid = torch.arange(c_kv.shape[1]) <= pos
        w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
        o = torch.einsum("bshr,rhk->bshk",
                         torch.einsum("bhst,btr->bshr", w, c_kv), p["wv_b"])
        return _out_proj(cfg, p, o), cache
    return decode


@pytest.mark.parametrize("mutation", ["none", "rope term dropped",
                                      "wk_b not absorbed"])
def test_absorbed_decode_check(mutation, monkeypatch, capsys):
    """``chip_smoke.absorbed_decode_check`` on reduced deepseek-v3 (4 rows
    of 24 tokens): the port's absorbed decode passes it at the first
    layer's attention output on every row, and at the logits on rows 0 to
    2; row 3's new
    token comes last in the prefill's expert order and is dropped past an
    expert's capacity there (its logits then differ by 3.7e-2), so the
    logits leave it out. Each mutation of the decode fails the check on
    the error bound of a row it holds."""
    smoke = _chip_smoke()
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (4, 24)))
    if mutation != "none":
        monkeypatch.setattr(mla, "decode_mla_attention", _mutant(mutation))
        with pytest.raises(SystemExit):
            smoke.absorbed_decode_check(cfg, model, params, prompts,
                                        F32_DECODE_TOL)
        out = capsys.readouterr().out
        assert "FAIL: absorbed decode check: relative error" in out, out
        return
    held, attn = smoke.absorbed_decode_check(cfg, model, params, prompts,
                                             F32_DECODE_TOL)
    assert sorted(held) == [0, 1, 2]
    assert max(held.values()) <= F32_DECODE_TOL
    assert len(attn) == 4 and max(attn) <= F32_DECODE_TOL
    assert "left out: row 3 (dropped in the prefill)" in \
        capsys.readouterr().out


# ----------------------------------------------------------- the whole model


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    payloads, manifest = jser.serialize_tree(jax.device_get(jparams))
    params = ser.deserialize_tree(
        map_tree(torch.zeros_like, model.init(0, device="cpu")), payloads,
        manifest)
    return jcfg, jmodel, jparams, cfg, model, params


def test_served_tokens_match_reference(pair):
    """A 20-token prompt and 6 new tokens (the absorbed decode over the
    latent cache): the port's serve_batch generates the reference's
    tokens."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    prompts = np.random.default_rng(12).integers(1, cfg.vocab_size, (2, 20))
    jtokens = jserve_batch(jcfg, jmodel, jparams,
                           jnp.asarray(prompts, jnp.int32), gen_tokens=6)
    tokens = serve_batch(cfg, model, params, torch.as_tensor(prompts),
                         gen_tokens=6)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


def test_checkpoint_payloads_byte_identical(pair):
    """Reduced deepseek-v3's params, the MTP module included, and its
    Adafactor state: carried by ``params_from_numpy`` and by the
    reference's payloads they are the same tensors, and the port's
    payloads and manifest equal the reference's, unquantized and with int8
    moments."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    names = [n for n, _ in ser.tree_paths(params)]
    assert "mtp/proj" in names and "mtp/layer/0/attn/wk_b" in names
    jopt = JAdafactor(lr=jconstant(1e-3), momentum=0.9)
    jstate = {"params": jparams, "opt_state": jopt.init(jparams)}
    state = params_from_numpy(jax.device_get(jstate), device="cpu")
    for (n, a), (m, b) in zip(ser.tree_paths(state), ser.tree_paths(
            {"params": params, "opt_state": state["opt_state"]})):
        assert n == m and torch.equal(a, b), n
    for policy in (None, "quant"):
        jpay, jman = jser.serialize_tree(
            jstate, jser.default_quant_policy if policy else None)
        pay, man = ser.serialize_tree(
            state, ser.default_quant_policy if policy else None)
        assert list(pay) == list(jpay)
        for name in jpay:
            assert pay[name] == jpay[name], name
        assert ser.manifest_bytes(man) == jser.manifest_bytes(jman)


# the full config and the chip's cuts (segments, MTP depth) -> params
CUTS = {
    "full": (None, 1, 682_636_472_320),
    "two layers with MTP": (((("mla_dense",), 1), (("mla_moe",), 1)), 1,
                            25_554_202_624),
    "part B: two layers": (((("mla_dense",), 1), (("mla_moe",), 1)), 0,
                           13_944_134_656),
    "part A: mla_dense with MTP": (((("mla_dense",), 1),), 1,
                                   3_123_113_984),
}


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_count_params_matches_reference(cut):
    """In all and active only (routed experts at top_k / num_experts)."""
    segments, mtp, n = CUTS[cut]
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if segments:
        jcfg = dataclasses.replace(jcfg, segments=segments, mtp_depth=mtp)
        cfg = dataclasses.replace(cfg, segments=segments, mtp_depth=mtp)
    for active in (False, True):
        assert count_params(cfg, active_only=active) == \
            jcount_params(jcfg, active_only=active)
    assert count_params(cfg) == n == cfg.param_count()


def test_serve_cli_runs_reduced_deepseek_v3_on_cpu(capsys):
    """``--arch deepseek-v3-671b --reduced --device cpu`` serves end to
    end: MLA prefill, absorbed decode, top-2 of 4 experts."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "12", "--gen", "4", "--requests", "1"])
    out = capsys.readouterr().out
    assert "[serve] request-batch 0: (2, 4)" in out
