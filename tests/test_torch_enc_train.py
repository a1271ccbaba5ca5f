"""The train step with encoder inputs in the port against the reference, on
the CPU in f32 at reduced size: ``make_train_step`` feeds each microbatch's
float ``enc_input`` (B, encoder_seq, encoder_dim) to ``model.forward``, as
``repro/runtime/train_step.py`` does, for reduced whisper-large-v3 (2
``enc`` layers and a ``cross`` layer over 16 frames; AdamW) and reduced
llama-3.2-vision-90b (``(attn x 4, cross)`` over 16 projected patches;
Adafactor): the loss, every leaf's gradient, the grad norm and one step;
the microbatch split of ``enc_input``; reduced whisper through
``train_loop``'s kill and bit-exact restore; the training CLI; and the plain
flash backward at whisper's head dim 64 without a mask, Sq != Sk over a
ragged Sk, against ``jax.vjp`` through the reference's ``_flash_vjp``.
Parameters are built by the reference and carried into the port through
the checkpoint format."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.registry import build_model as jbuild_model
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.runtime import train_step as jts
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.train import batch_to
from repro_torch.models import common
from repro_torch.models.common import map_tree, padded_vocab
from repro_torch.models.registry import build_model
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad import clip_by_global_norm
from repro_torch.optim.schedule import constant
from repro_torch.runtime.train_step import (TrainState, cross_entropy,
                                            make_train_step)
import test_torch_flash_bwd as flash_bwd
from test_torch_train_integration import _train_loop_kill_restore_bit_exact

WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-90b"
ARCHS = (WHISPER, VISION)
LR = 1e-3
# a batch of 4 x 16 tokens over the reduced configs' 16 frames / patches
BATCH, SEQ, DATA_SEED = 4, 16, 5
# Each leaf's gradient, in f32 in both packages, against the port's own
# float64 run as the yardstick: ||g - g64|| <= GRAD_TOL ||g64||, for the
# port and the reference alike. The reduced models are ill-conditioned at
# init (the reference's init gives scores of standard deviation ~16, see
# tests/test_torch_cross.py), and f32 rounding moves their gradients by
# far more than its unit roundoff. Measured on this batch: whisper, the
# port 2.8e-4 and the reference 2.0e-4 of the leaf's norm at most
# (encoder/0/norm1/bias; one process of eleven put the port's at 1.6e-3,
# its loss 2 f32 ulp off the others'); vision (grad norm 339), the port
# 2.7e-3 and the reference 1.3e-3 (segments/seg0/0/attn/wk), and on
# another batch the two packages 4.0e-3 apart. Both held at about three
# times the largest of these.
GRAD_TOL = {WHISPER: 5e-3, VISION: 1e-2}
# the step's loss (measured: equal, and 3e-7 apart) and grad norm (measured
# 1.8e-6 and 7.9e-4 relative), as tests/test_torch_train.py holds them
LOSS_TOL, GNORM_TOL = 1e-5, 2e-3
# One step's change of each param leaf. From zero moments AdamW moves every
# element by ~LR sign(g): a gradient element within rounding of zero moves
# by ~LR either way, so the change is held by the gradients (above) and by
# the port's optimizer fed the reference's gradients, against the
# reference's step (measured 4.1e-6 of the change's norm for AdamW, 2.6e-5
# for Adafactor, whose bf16 momentum rounds once; held to 1e-4).
# Adafactor's change, which follows g / rms(g), is also held directly
# (measured 3.0e-3 of its norm at most; held to 1e-2, as test_torch_mtp.py)
FED_TOL, STEP_TOL = 1e-4, 1e-2


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _optimizers(cfg):
    if cfg.optimizer == "adafactor":
        return (JAdafactor(lr=jconstant(LR), momentum=0.9),
                Adafactor(lr=constant(LR), momentum=0.9))
    return JAdamW(lr=jconstant(LR)), AdamW(lr=constant(LR))


def _batch(cfg):
    """The pipeline's batch 0: tokens, labels and ``enc_input`` (numpy)."""
    return SyntheticLMPipeline(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=DATA_SEED, enc_seq=cfg.encoder_seq,
        enc_dim=cfg.encoder_dim)._batch_at(0)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, model, params; port cfg, model, params) of a reduced
    cross-attention config, the params drawn by the reference."""
    arch = request.param
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    payloads, manifest = jser.serialize_tree(jax.device_get(jparams))
    params = ser.deserialize_tree(
        map_tree(torch.zeros_like, model.init(0, device="cpu")), payloads,
        manifest)
    return arch, jcfg, jmodel, jparams, cfg, model, params


def _port_grads(cfg, params, tbatch, dtype):
    """{leaf path: gradient as float64 numpy} and the loss of the port's
    loss at ``dtype`` (params and ``enc_input`` cast to it)."""
    lp = ser.tree_map_with_path(
        lambda _, t: t.detach().to(dtype).requires_grad_(True), params)
    names, leaves = zip(*ser.tree_paths(lp))
    logits = build_model(cfg).forward(lp, tbatch["inputs"],
                                      tbatch["enc_input"].to(dtype))
    loss = cross_entropy(logits, tbatch["labels"], padded_vocab(cfg))
    grads = torch.autograd.grad(loss, leaves)
    return {n: g.double().numpy() for n, g in zip(names, grads)}, loss


def test_encoder_input_grads_match_reference(pair, monkeypatch):
    """Every leaf's gradient of the loss over tokens and ``enc_input``
    (``enc_proj``, the encoder or the cross layers' K / V projections
    included: only the frames reach them), from the reference's jitted
    ``jax.grad`` and the port's autograd in f32, each against the port's
    float64 run; the f32 losses within LOSS_TOL of the float64 one."""
    arch, jcfg, jmodel, jparams, cfg, _, params = pair
    batch = _batch(cfg)
    tbatch = batch_to(batch, "cpu")
    assert tbatch["enc_input"].dtype == torch.float32
    vp = padded_vocab(cfg)
    jgrads = jax.jit(jax.grad(lambda p: jts.cross_entropy(
        jmodel.forward(p, jnp.asarray(batch["inputs"]),
                       jnp.asarray(batch["enc_input"])),
        jnp.asarray(batch["labels"]), vp)))(jparams)
    want = {n: np.asarray(g, np.float64)
            for n, g in jser.tree_paths(jax.device_get(jgrads))}
    got, loss = _port_grads(cfg, params, tbatch, torch.float32)
    monkeypatch.setitem(common.DTYPES, "float64", torch.float64)
    exact, loss64 = _port_grads(
        dataclasses.replace(cfg, param_dtype="float64",
                            compute_dtype="float64"),
        params, tbatch, torch.float64)
    assert list(got) == list(want) == list(exact)
    assert "enc_proj" in got
    np.testing.assert_allclose(loss.item(), loss64.item(), rtol=LOSS_TOL)
    tol = GRAD_TOL[arch]
    for n, g64 in exact.items():
        assert np.linalg.norm(g64) > 0, n
        for who, g in (("port", got[n]), ("reference", want[n])):
            err = _rel(g, g64)
            assert err <= tol, f"{n}: the {who}'s f32 gradient is off by " \
                               f"{err:.2e} of its norm from float64"


def test_encoder_input_train_step_matches_reference(pair):
    """One step of ``make_train_step`` (AdamW for whisper, Adafactor with
    momentum 0.9 for vision) from the same params and batch: the loss and
    grad norm against the reference's jitted ``make_train_step``; the step
    equal bit for bit to the port's clipping and update applied to the
    port's own gradients; the port's clipping and update fed the
    reference's gradients within FED_TOL of the reference's step; and,
    for Adafactor, the step itself within STEP_TOL."""
    _, jcfg, jmodel, jparams, cfg, model, params = pair
    jopt, opt = _optimizers(cfg)
    batch = _batch(cfg)
    tbatch = batch_to(batch, "cpu")
    jstate = jts.TrainState(jparams, jopt.init(jparams))
    jstate2, jm = jax.jit(jts.make_train_step(jcfg, jmodel, jopt))(jstate,
                                                                  batch)
    state2, m = make_train_step(cfg, model, opt)(
        TrainState(params, opt.init(params)), tbatch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=GNORM_TOL)

    def stepped(grads):
        clipped, _ = clip_by_global_norm(grads, 1.0)
        return opt.update(clipped, opt.init(params), params)[0]

    grads, _ = _port_grads(cfg, params, tbatch, torch.float32)
    own = stepped(ser.tree_map_with_path(
        lambda n, t: torch.from_numpy(grads[n]).float(), params))
    for (n, a), (_, b) in zip(ser.tree_paths(state2.params),
                              ser.tree_paths(own)):
        assert torch.equal(a, b), f"{n}: the step is not its own gradients' " \
                                  f"update"

    jgrads = jax.jit(jax.grad(lambda p: jts.cross_entropy(
        jmodel.forward(p, jnp.asarray(batch["inputs"]),
                       jnp.asarray(batch["enc_input"])),
        jnp.asarray(batch["labels"]), padded_vocab(cfg))))(jparams)
    fed = stepped(params_from_numpy(jax.device_get(jgrads), device="cpu"))
    before = {n: t.numpy() for n, t in ser.tree_paths(params)}
    jafter = dict(jser.tree_paths(jax.device_get(jstate2.params)))
    step_tol = STEP_TOL if cfg.optimizer == "adafactor" else None
    for n, f in ser.tree_paths(fed):
        change = np.asarray(jafter[n]) - before[n]
        assert np.linalg.norm(change) > 0, n
        err = _rel(f.numpy() - before[n], change)
        assert err <= FED_TOL, f"{n}: the update of the reference's " \
                               f"gradients off by {err:.2e}"
    if step_tol:
        for n, t in ser.tree_paths(state2.params):
            change = np.asarray(jafter[n]) - before[n]
            err = _rel(t.numpy() - before[n], change)
            assert err <= step_tol, f"{n}: params' change off by {err:.2e}"


def test_accumulation_slices_enc_input_with_the_tokens():
    """With ``accum_steps`` 2 the step's loss is the mean of the two
    microbatches' losses, each over its own rows of tokens and frames, and
    differs from the mean over the frames swapped between them."""
    cfg = reduced(get_config(WHISPER))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    _, opt = _optimizers(cfg)
    tbatch = batch_to(_batch(cfg), "cpu")
    _, m = make_train_step(cfg, model, opt, accum_steps=2)(
        TrainState(params, opt.init(params)), tbatch)
    half = BATCH // 2
    rows = (slice(0, half), slice(half, BATCH))

    def mean_loss(frames):
        with torch.no_grad():
            return sum(cross_entropy(
                model.forward(params, tbatch["inputs"][r], frames[i]),
                tbatch["labels"][r], padded_vocab(cfg)) / 2
                for i, r in enumerate(rows))

    enc = tbatch["enc_input"]
    np.testing.assert_allclose(m["loss"].item(),
                               mean_loss([enc[r] for r in rows]).item(),
                               rtol=1e-6)
    swapped = mean_loss([enc[rows[1]], enc[rows[0]]]).item()
    assert abs(m["loss"].item() - swapped) > 1e-4


def test_whisper_train_loop_restore_bit_exact(monkeypatch):
    """Reduced whisper-large-v3 (AdamW) through ``train_loop``'s kill and
    restore: every batch carries the pipeline's ``enc_input`` (a resumed
    run draws the same frames from the restored data step), and run B's
    params and AdamW state equal run A's bit for bit (``enc_proj``, the
    encoder and the learned positions among them)."""
    from repro_torch.launch import train
    cfg = reduced(get_config(WHISPER))
    seen = []

    def recording(batch, device):
        seen.append(batch["enc_input"].shape)
        return batch_to(batch, device)

    monkeypatch.setattr(train, "batch_to", recording)
    state = _train_loop_kill_restore_bit_exact(WHISPER)
    # run A 6 steps, run B 3 + 3
    assert seen == [(4, cfg.encoder_seq, cfg.encoder_dim)] * 12
    assert type(state.opt_state).__name__ == "AdamWState"
    assert "enc_proj" in state.params and "positions" in state.params["embed"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_reduced_encoder_configs_on_cpu(arch, capsys):
    """``--arch whisper-large-v3`` / ``llama-3.2-vision-90b --reduced
    --device cpu``: the pipeline's frames / patches go into every step, and
    the run checkpoints (int8 moments) end to end."""
    from repro_torch.launch import train
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--seq", "32", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out


# whisper's attention without a mask at head dim 64, Sq != Sk: fewer
# queries than keys (its cross-attention, 448 over 1500) and more, Sk
# ragged in the chunks of 48 (100 = 2 x 48 + 4, 150 = 3 x 48 + 6), f32 and
# bf16: (B, Sq, Sk, H, KV, D, causal, window, softcap, q_offset, dtype)
D64_CASES = [(2, sq, sk, 4, 4, 64, False, 0, 0.0, 0, dtype)
             for sq, sk in ((28, 100), (150, 100))
             for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("case", D64_CASES, ids=str)
def test_plain_d64_backward_without_mask_matches_reference_vjp(
        case, monkeypatch):
    """dq, dk, dv of the port's CPU Function (the plain forward with row
    statistics, then ``flash_bwd_chunked``) against ``jax.vjp`` of the
    reference's ``ops.flash_attention`` (``_flash_vjp``), as
    ``tests/test_torch_flash_bwd.py`` holds its cases, at the reference's
    kernel tolerances."""
    flash_bwd.test_port_gradients_match_reference_vjp(case, monkeypatch)
