"""The port's mixture-of-experts layer and ``llama4-scout-17b-a16e`` against
the reference, on the CPU in f32 at reduced size: the sorted capacity
dispatch of ``repro.models.moe._apply_moe_dense`` (routing indices first,
then outputs), the reference's MoE property tests on the port, and reduced
llama4 as a whole model (forward, served tokens, one Adafactor train step,
parameter counts, checkpoint payloads). Parameters are built by the
reference and carried into the port through the checkpoint format (the
reference's serializer out, the port's in)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import moe as jmoe
from repro.models.common import init_tree as jinit_tree
from repro.models.registry import build_model as jbuild_model
from repro.models.registry import count_params as jcount_params
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.grad import clip_by_global_norm as jclip
from repro.optim.schedule import constant as jconstant
from repro.runtime import train_step as jts
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.common import (activation, init_tree, map_tree,
                                       padded_vocab)
from repro_torch.models.registry import build_model, count_params
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.schedule import constant
from repro_torch.runtime.train_step import (TrainState, cross_entropy,
                                            make_train_step)

ARCH = "llama4-scout-17b-a16e"
# the chip's depth cut of llama4: one layer of each of its two kinds
TWO_LAYERS = ((("moe_local", "moe_nope"), 1),)


def _zeros(descs):
    return map_tree(lambda d: torch.zeros(d.shape), descs)


def _bridge(jtree, target):
    """A reference tree, serialized by the reference and restored by the
    port into ``target``'s structure."""
    payloads, manifest = jser.serialize_tree(jax.device_get(jtree))
    return ser.deserialize_tree(target, payloads, manifest)


# ------------------------------------------------------------ the MoE layer

# the four dispatch regimes on reduced llama4 (4 experts, d_ff_expert 128,
# a shared expert of 128), over 2 x 64 = 128 tokens: top-1 as llama4 routes
# (capacity 40 of ~32 a expert); top-2 without a shared expert (capacity 80
# of ~64: token pairs summed in the combine); a capacity factor of 1e-6
# (capacity 8: three quarters of the assignments drop); and 8.0 (capacity
# 256: none drops). And top-8 as deepseek-v3-671b routes, on its reduced
# config with 16 experts and its shared expert (capacity 80 of ~64): the
# combine sums each token's 8 rows in top-k rank order, the reference in
# expert-sorted order
MOE_CASES = {"llama4": {}, "top2": {"top_k": 2, "num_shared_experts": 0},
             "drops": {"capacity_factor": 1e-6},
             "no-drops": {"capacity_factor": 8.0},
             "top8": {"arch": "deepseek-v3-671b", "num_experts": 16,
                      "top_k": 8}}
# f32 on the same params and input: the routed and shared products sum in
# XLA's and torch's orders (4.8e-7 measured on the llama4 case; 7.2e-7 on
# top8, whose 8 rows a token also add in another order, none dropped)
MOE_TOL = 1e-5


def _moe_pair(case):
    kw = dict(MOE_CASES[case])
    arch = kw.pop("arch", ARCH)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    jp = jinit_tree(jmoe.moe_descs(jcfg), jax.random.PRNGKey(4), jnp.float32)
    return jcfg, jp, cfg, _bridge(jp, _zeros(moe.moe_descs(cfg)))


def _reference_routing(jcfg, jp, x):
    """The reference's routing lines (``_apply_moe_dense``, f32 softmax,
    ``jax.lax.top_k``): normalized top-k weights and expert ids."""
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    logits = jnp.einsum("td,de->te", xt, jp["router"].astype(jnp.float32))
    topw, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    topw = topw / jnp.maximum(jnp.sum(topw, axis=-1, keepdims=True), 1e-9)
    return np.asarray(topw), np.asarray(topi)


def _dropped(topi, cfg):
    """Assignments beyond their expert's capacity, counted from the ids."""
    counts = np.bincount(topi.reshape(-1), minlength=cfg.num_experts)
    cap = moe.capacity(cfg, topi.shape[0])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_reference(case):
    jcfg, jp, cfg, p = _moe_pair(case)
    x = np.random.default_rng(5).normal(size=(2, 64, cfg.d_model)) \
        .astype(np.float32)
    jw, ji = _reference_routing(jcfg, jp, x)
    w, i = moe.route(cfg, p, torch.as_tensor(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-6, atol=1e-7)
    dropped = _dropped(ji, cfg)
    n = ji.size
    assert {"drops": dropped > n // 2, "no-drops": dropped == 0}.get(
        case, dropped < n // 4), f"{case}: {dropped} of {n} dropped"

    exp = np.asarray(jmoe._apply_moe_dense(jcfg, jp, jnp.asarray(x)))
    out = moe.apply_moe(cfg, p, torch.as_tensor(x))
    assert out.shape == exp.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), exp, atol=MOE_TOL, rtol=MOE_TOL)


def test_top_k_ties_pick_the_lower_expert():
    """Equal router probabilities (a zero router): the lower expert ids
    win, as ``jax.lax.top_k`` picks them, and top-2 splits the weight."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)), top_k=2)
    p = {"router": torch.zeros((cfg.d_model, cfg.num_experts))}
    w, i = moe.route(cfg, p, torch.randn(5, cfg.d_model))
    assert i.tolist() == [[0, 1]] * 5
    assert torch.equal(w, torch.full((5, 2), 0.5))


def test_apply_moe_runs_in_a_profiler_range():
    """Each MoE FFN runs in a profiler range "moe", which chip_smoke.py's
    prefill profile reads to split the FFN's device time by op."""
    from torch.profiler import ProfilerActivity, profile
    _, _, cfg, p = _moe_pair("llama4")
    x = torch.randn(2, 8, cfg.d_model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.apply_moe(cfg, p, x)
    ranges = [e for e in prof.events() if e.name == "moe"]
    assert len(ranges) == 1
    inside = {c.name for c in ranges[0].cpu_children}
    assert "aten::bmm" in inside or "aten::matmul" in inside, inside


def _property_cfg(**kw):
    return dataclasses.replace(reduced(get_config(ARCH)), **kw)


@pytest.mark.parametrize("prop", ["finite-and-shaped", "drops-are-graceful",
                                  "router-weights-normalized"])
def test_moe_properties(prop):
    """The reference's three dispatch properties (``tests/test_moe.py``) on
    the port, with torch-initialized params on reduced llama4's widths:
    outputs finite and shaped; with a capacity factor near zero the output
    shrinks toward the shared expert's and stays finite; identical experts
    give one dense expert MLP's output whatever the routing (the top-k
    weights sum to 1)."""
    gen = torch.Generator().manual_seed(0)
    if prop == "router-weights-normalized":
        cfg = _property_cfg(num_experts=4, top_k=4, d_ff_expert=16,
                            num_shared_experts=0, capacity_factor=8.0)
        p = init_tree(moe.moe_descs(cfg), gen, torch.float32, "cpu")
        p = {"router": p["router"],
             **{k: p[k][:1].expand_as(p[k]) for k in ("w_gate", "w_up",
                                                     "w_down")}}
        x = torch.randn((1, 8, cfg.d_model), generator=gen)
        y = moe.apply_moe(cfg, p, x)
        xt = x.reshape(-1, cfg.d_model)
        ref = (activation(cfg, xt @ p["w_gate"][0]) * (xt @ p["w_up"][0])) \
            @ p["w_down"][0]
        torch.testing.assert_close(y.reshape(-1, cfg.d_model), ref,
                                   atol=1e-4, rtol=1e-4)
        return
    cfg = _property_cfg(num_experts=8, top_k=2, d_ff_expert=32)
    if prop == "drops-are-graceful":
        cfg = dataclasses.replace(cfg, capacity_factor=1e-6)
    p = init_tree(moe.moe_descs(cfg), gen, torch.float32, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y = moe.apply_moe(cfg, p, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    if prop == "drops-are-graceful":
        full = moe.apply_moe(dataclasses.replace(cfg, capacity_factor=8.0),
                             p, x)
        assert y.abs().mean() <= full.abs().mean()


# -------------------------------------------------------- reduced llama4

# f32 logits of the 4-layer reduced model: one layer agrees to ~1e-6 of its
# output's magnitude, and the residual stream grows to ~90 over the four
# layers of random-init weights, each amplifying the difference it is fed
# about fivefold (5.5e-4 measured on the forward's logits, ~4 in size)
LOGITS_TOL = 2e-3


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = _bridge(jparams, map_tree(torch.zeros_like,
                                       model.init(0, device="cpu")))
    return jcfg, jmodel, jparams, cfg, model, params


def test_layer_kinds_and_leaves_match_reference(pair):
    """Reduced llama4 keeps one repeat of (moe_local x 3, moe_nope), and
    the port's leaves have the reference's paths and shapes: the experts
    stacked to 4-D (reps, E, d, f), the router (reps, d, E)."""
    jcfg, _, jparams, cfg, _, params = pair
    assert cfg.segments == ((("moe_local",) * 3 + ("moe_nope",), 1),)
    assert (cfg.num_experts, cfg.top_k, cfg.d_ff_expert, cfg.d_ff_shared,
            cfg.window_size) == (4, 1, 128, 128, 16)
    got = [(n, tuple(t.shape)) for n, t in ser.tree_paths(params)]
    assert got == [(n, tuple(a.shape)) for n, a in jser.tree_paths(jparams)]
    shapes = dict(got)
    d = cfg.d_model
    assert shapes["segments/seg0/3/moe/w_gate"] == (1, 4, d, 128)
    assert shapes["segments/seg0/3/moe/w_down"] == (1, 4, 128, d)
    assert shapes["segments/seg0/0/moe/router"] == (1, d, 4)
    assert shapes["segments/seg0/0/moe/shared/w_up"] == (1, d, 128)


def test_forward_logits_match_reference(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    exp = np.asarray(jmodel.forward(jparams, jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        out = model.forward(params, torch.as_tensor(tokens))
    assert out.shape == exp.shape
    np.testing.assert_allclose(out.numpy(), exp, atol=LOGITS_TOL, rtol=0)


def test_served_tokens_match_reference(pair):
    """A 24-token prompt, past the reduced window of 16 (the moe_local
    layers take the ring path, the moe_nope layer keeps every key), 8 new
    tokens: the port's serve_batch generates the reference's tokens, and
    the prefill logits agree."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    prompts = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 24))
    jtokens = jserve_batch(jcfg, jmodel, jparams,
                           jnp.asarray(prompts, jnp.int32), gen_tokens=8)
    tokens = serve_batch(cfg, model, params, torch.as_tensor(prompts),
                         gen_tokens=8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    jlogits, _ = jmodel.prefill(jparams, jmodel.init_cache(2, 32),
                                jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        logits, _ = model.prefill(params, model.init_cache(2, 32, "cpu"),
                                  torch.as_tensor(prompts))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_TOL, rtol=0)


def _rel_err(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# the Adafactor update from identical grads and state, as
# tests/test_torch_adafactor.py holds it: f32 leaves (params, vr, vc) within
# rtol 2e-6 and atol 1e-9, the bf16 m within one bf16 ulp
F32_RTOL, F32_ATOL, BF16_RTOL = 2e-6, 1e-9, 2.0 ** -7
# one train step from the same state and batch, as tests/test_torch_train.py
# holds the Adafactor config's: the loss within 1e-5 relative, the grad
# norm within 2e-3, the params' change within 1e-2 of its norm per leaf.
# The MoE leaves' grads within 1e-3 of their norm (up to 9.1e-5 measured;
# the forward's logits agree to ~1.4e-4 of their size, see LOGITS_TOL)
LOSS_TOL, GNORM_TOL, STEP_TOL, GRAD_TOL = 1e-5, 2e-3, 1e-2, 1e-3
LR = 1e-3


def test_adafactor_train_step_matches_reference(pair):
    """One train step of reduced llama4 with Adafactor (momentum 0.9 in
    bf16) from the same params and batch: the loss and grad norm; each MoE
    leaf's gradient (the router's is zero up to rounding in both, at
    top-1); the params' change. Then the optimizer alone from the
    reference's clipped grads: every leaf of params and state, the 4-D
    expert leaves factored over their last two dims (vr (1, E, d), vc
    (1, E, f))."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    jopt = JAdafactor(lr=jconstant(LR), momentum=0.9)
    opt = Adafactor(lr=constant(LR), momentum=0.9)
    rng = np.random.default_rng(6)
    tok = rng.integers(1, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    tbatch = {k: torch.as_tensor(v, dtype=torch.int64)
              for k, v in batch.items()}
    vp = padded_vocab(cfg)

    jgrads = jax.jit(jax.grad(lambda p: jts.cross_entropy(
        jmodel.forward(p, jnp.asarray(batch["inputs"])),
        jnp.asarray(batch["labels"]), vp)))(jparams)
    lp = ser.tree_map_with_path(
        lambda _, t: t.detach().requires_grad_(True), params)
    names, leaves = zip(*ser.tree_paths(lp))
    loss = cross_entropy(model.forward(lp, tbatch["inputs"]),
                         tbatch["labels"], vp)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = dict(jser.tree_paths(jax.device_get(jgrads)))
    moe_names = [n for n in names if "/moe/" in n]
    assert len(moe_names) == 4 * 7
    for n in moe_names:
        g, w = grads[n].numpy(), np.asarray(want[n])
        if n.endswith("/router"):
            # zero up to rounding in both packages: at top-1 the normalized
            # weight of the one chosen expert is 1 whatever the router says
            scale = np.linalg.norm(want[n.replace("router", "w_up")])
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= 1e-6 * scale
            continue
        err = _rel_err(g, w)
        assert err <= GRAD_TOL, f"{n}: grad off by {err:.2e} of its norm"

    jstate = jts.TrainState(jparams, jopt.init(jparams))
    state = TrainState(params, opt.init(params))
    jstate2, jm = jax.jit(jts.make_train_step(jcfg, jmodel, jopt))(jstate,
                                                                  batch)
    state2, m = make_train_step(cfg, model, opt)(state, tbatch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=GNORM_TOL)
    before = {n: t.numpy() for n, t in ser.tree_paths(params)}
    jafter = dict(jser.tree_paths(jax.device_get(jstate2.params)))
    for n, t in ser.tree_paths(state2.params):
        if n.endswith("/router"):
            # Adafactor scales the router's rounding-noise gradient to unit
            # RMS in both packages, so its change is noise; the update of a
            # shared gradient is compared below
            continue
        err = _rel_err(t.numpy() - before[n], np.asarray(jafter[n])
                       - before[n])
        assert err <= STEP_TOL, f"{n}: params' change off by {err:.2e}"

    # the optimizer alone, on the reference's clipped grads
    clipped, _ = jax.jit(jclip)(jgrads, 1.0)
    jp2, jst2 = jax.jit(jopt.update)(clipped, jstate.opt_state, jparams)
    p2, st2 = opt.update(params_from_numpy(jax.device_get(clipped),
                                           device="cpu"),
                         state.opt_state, params)
    assert st2.vr["segments"]["seg0"]["3"]["moe"]["w_gate"].shape == \
        (1, 4, cfg.d_model)
    assert st2.vc["segments"]["seg0"]["3"]["moe"]["w_gate"].shape == \
        (1, 4, cfg.d_ff_expert)
    got = {n: t.float().numpy() for n, t in ser.tree_paths(
        {"p": p2, "s": st2})}
    exp = {n: params_from_numpy(np.asarray(a), device="cpu").float().numpy()
           for n, a in jser.tree_paths(jax.device_get({"p": jp2,
                                                       "s": jst2}))}
    assert list(got) == list(exp)
    for n, leaf in got.items():
        if n.startswith("s/.m/"):
            np.testing.assert_allclose(leaf, exp[n], rtol=BF16_RTOL, atol=0,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(leaf, exp[n], rtol=F32_RTOL,
                                       atol=F32_ATOL, err_msg=n)


@pytest.mark.parametrize("segments", ["full", "two-layer"])
def test_count_params_matches_reference(segments):
    """The full config (48 layers) and the chip's two-layer cut, in all and
    active only (routed experts at top_k / num_experts)."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if segments == "two-layer":
        jcfg = dataclasses.replace(jcfg, segments=TWO_LAYERS)
        cfg = dataclasses.replace(cfg, segments=TWO_LAYERS)
    for active in (False, True):
        assert count_params(cfg, active_only=active) == \
            jcount_params(jcfg, active_only=active)
    if segments == "two-layer":
        assert count_params(cfg) == 6_475_146_240
        assert cfg.param_count() == 6_475_146_240


def test_moe_checkpoint_payloads_byte_identical(pair):
    """Reduced llama4's params and Adafactor state: carried by
    ``params_from_numpy`` and by the reference's payloads they are the same
    tensors, and the port's payloads and manifest equal the reference's,
    unquantized and with int8 moments."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    jopt = JAdafactor(lr=jconstant(LR), momentum=0.9)
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


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_port_refuses_mla_mtp_cross_and_encoders(arch):
    """The reference's configs with cross attention (and, for whisper, an
    encoder), taken as the port's ModelConfig, build in the port with the
    reference's tree: the ``cross`` and ``enc`` kinds, ``enc_proj``, the
    stacked ``encoder`` and ``enc_final_norm``
    (``tests/test_torch_cross.py``); both train too (below, and
    ``tests/test_torch_enc_train.py``)."""
    jcfg = jget_config(arch)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    descs = transformer.model_descs(cfg)
    assert "enc_proj" in descs
    assert ("encoder" in descs) == bool(cfg.num_encoder_layers)
    assert count_params(cfg) == jcount_params(jcfg)


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_train_step_takes_encoder_inputs(arch):
    """Both cross-attention configs build a train step and take one step on
    a batch with ``enc_input`` (B, encoder_seq, encoder_dim): a finite loss
    and every param moved. ``tests/test_torch_enc_train.py`` holds the step
    against the reference's."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt = Adafactor(lr=constant(LR))
    rng = np.random.default_rng(4)
    tok = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 9)))
    enc = torch.as_tensor(rng.normal(size=(2, cfg.encoder_seq,
                                           cfg.encoder_dim)),
                          dtype=torch.float32)
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:], "enc_input": enc}
    state, m = make_train_step(cfg, model, opt)(
        TrainState(params, opt.init(params)), batch)
    assert torch.isfinite(m["loss"]) and m["grad_norm"] > 0
    for (name, a), (_, b) in zip(ser.tree_paths(state.params),
                                 ser.tree_paths(params)):
        assert not torch.equal(a, b), f"{name}: not updated"


def test_serve_cli_runs_reduced_llama4_on_cpu(capsys):
    """``--arch llama4-scout-17b-a16e --reduced --device cpu`` serves a
    prompt longer than the reduced window (16) end to end."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "24", "--gen", "4", "--requests", "1"])
    out = capsys.readouterr().out
    assert "[serve] request-batch 0: (2, 4)" in out


def test_train_cli_runs_reduced_llama4_on_cpu(capsys):
    """``--arch llama4-scout-17b-a16e --reduced --device cpu``: Adafactor
    trains the MoE kinds and checkpoints (bf16 m of the 4-D experts in
    int8) end to end."""
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--seq", "32", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out
