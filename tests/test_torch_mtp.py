"""DeepSeek-V3's multi-token prediction in the port against the reference, on
the CPU in f32 at reduced size: ``transformer.forward_with_mtp`` (the trunk,
then the MTP module: [h_norm(h_t) ; e_norm(emb(t+1))] through ``mtp/proj``
and one more layer of the trunk's last kind) and one Adafactor train step
with the MTP loss (weight 0.3, targets ``labels[:, 1:]``), at reduced
deepseek-v3 (MTP layer ``mla_moe``, top-2 of 4) and at the card's cut
reduced (one ``mla_dense`` layer, so an ``mla_dense`` MTP layer); then
reduced deepseek-v3 through ``train_loop``'s kill and bit-exact restore,
and the training CLI. Parameters are built by the reference and carried
into the port through the checkpoint format."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jbuild_model
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.schedule import constant as jconstant
from repro.runtime import train_step as jts
from repro_torch.checkpoint import serializer as ser
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer
from repro_torch.models.common import map_tree, padded_vocab
from repro_torch.models.registry import build_model
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.schedule import constant
from repro_torch.runtime.train_step import (MTP_WEIGHT, TrainState,
                                            cross_entropy, make_train_step)
from test_torch_train_integration import _train_loop_kill_restore_bit_exact

ARCH = "deepseek-v3-671b"
# the reduced config (mla_dense, mla_moe: the MTP layer is mla_moe) and
# chip_smoke.py's cut for training on the card, reduced (one mla_dense
# layer: the MTP layer is mla_dense)
CUTS = {"reduced": None, "card cut": ((("mla_dense",), 1),)}
# f32 logits of the reduced model against the reference's, atol: as
# tests/test_torch_moe.py holds a whole model's logits (the MTP head's pass
# through one more layer and the shared unembedding)
LOGITS_TOL = 2e-3
# one train step from the same state and batch, as
# tests/test_torch_moe.py::test_adafactor_train_step_matches_reference
# holds it: the loss within 1e-5 relative, the grad norm within 2e-3, each
# leaf's grad within 1e-3 of its norm, the params' change within 1e-2 of
# its norm per leaf
LOSS_TOL, GNORM_TOL, GRAD_TOL, STEP_TOL = 1e-5, 2e-3, 1e-3, 1e-2
LR = 1e-3


def _cfgs(cut):
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    if CUTS[cut]:
        jcfg = dataclasses.replace(jcfg, segments=CUTS[cut])
        cfg = dataclasses.replace(cfg, segments=CUTS[cut])
    return jcfg, cfg


@pytest.fixture(scope="module", params=sorted(CUTS))
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    payloads, manifest = jser.serialize_tree(jax.device_get(jparams))
    params = ser.deserialize_tree(
        map_tree(torch.zeros_like, model.init(0, device="cpu")), payloads,
        manifest)
    return request.param, jcfg, jmodel, jparams, cfg, model, params


def test_mtp_layer_is_the_trunk_s_last_kind(pair):
    """The MTP module's layer has the leaves of the trunk's last kind:
    an MoE FFN on the reduced config, a dense MLP on the card's cut."""
    cut, _, _, jparams, cfg, _, params = pair
    names = [n for n, _ in ser.tree_paths(params)]
    assert names == [n for n, _ in jser.tree_paths(jparams)]
    ffn = "moe/router" if cut == "reduced" else "mlp/w_up"
    assert f"mtp/layer/0/{ffn}" in names
    assert cfg.segments[-1][0][-1] == ("mla_moe" if cut == "reduced"
                                       else "mla_dense")


def test_forward_with_mtp_matches_reference(pair):
    """Both heads' logits over 24 tokens: (B, S, V) and (B, S-1, V)."""
    _, jcfg, _, jparams, cfg, _, params = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    jlogits, jmtp = jtransformer.forward_with_mtp(
        jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        logits, mtp = transformer.forward_with_mtp(cfg, params,
                                                   torch.as_tensor(tokens))
        plain = transformer.forward(cfg, params, torch.as_tensor(tokens))
    assert logits.shape == jlogits.shape == (2, 24, padded_vocab(cfg))
    assert mtp.shape == jmtp.shape == (2, 23, padded_vocab(cfg))
    # the main head is the plain forward's, op for op
    assert torch.equal(logits, plain)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(mtp.numpy(), np.asarray(jmtp),
                               atol=LOGITS_TOL, rtol=0)


def _rel_err(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_adafactor_mtp_train_step_matches_reference(pair):
    """One train step with Adafactor (momentum 0.9 in bf16) and the MTP
    loss from the same params and batch: every leaf's gradient (the
    ``mtp/...`` leaves included: only the MTP loss reaches them), then the
    step's loss, grad norm and the params' change against the reference's
    ``make_train_step``."""
    _, jcfg, jmodel, jparams, cfg, model, params = pair
    jopt = JAdafactor(lr=jconstant(LR), momentum=0.9)
    opt = Adafactor(lr=constant(LR), momentum=0.9)
    rng = np.random.default_rng(6)
    tok = rng.integers(1, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    tbatch = {k: torch.as_tensor(v, dtype=torch.int64)
              for k, v in batch.items()}
    vp = padded_vocab(cfg)

    def jloss(p):
        # the reference's loss_fn (repro/runtime/train_step.py) with MTP
        logits, mtp_logits = jtransformer.forward_with_mtp(
            jcfg, p, jnp.asarray(batch["inputs"]))
        labels = jnp.asarray(batch["labels"])
        return (jts.cross_entropy(logits, labels, vp)
                + 0.3 * jts.cross_entropy(mtp_logits, labels[:, 1:], vp))

    jgrads = jax.jit(jax.grad(jloss))(jparams)
    lp = ser.tree_map_with_path(
        lambda _, t: t.detach().requires_grad_(True), params)
    names, leaves = zip(*ser.tree_paths(lp))
    logits, mtp_logits = transformer.forward_with_mtp(cfg, lp,
                                                      tbatch["inputs"])
    labels = tbatch["labels"]
    loss = cross_entropy(logits, labels, vp) \
        + MTP_WEIGHT * cross_entropy(mtp_logits, labels[:, 1:], vp)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = dict(jser.tree_paths(jax.device_get(jgrads)))
    assert MTP_WEIGHT == 0.3 and list(grads) == list(want)
    mtp_names = [n for n in names if n.startswith("mtp/")]
    assert len(mtp_names) > 10
    for n in names:
        g, w = grads[n].numpy(), np.asarray(want[n])
        if not np.linalg.norm(w):
            # an expert no token was routed to, in both packages
            assert not np.linalg.norm(g), n
            continue
        err = _rel_err(g, w)
        assert err <= GRAD_TOL, f"{n}: grad off by {err:.2e} of its norm"
        if n in mtp_names:
            assert np.linalg.norm(w) > 0, n

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
        change = np.asarray(jafter[n]) - before[n]
        if not np.linalg.norm(change):
            assert np.array_equal(t.numpy(), before[n]), n
            continue
        err = _rel_err(t.numpy() - before[n], change)
        assert err <= STEP_TOL, f"{n}: params' change off by {err:.2e}"


def test_train_step_without_mtp_ignores_the_module():
    """With ``mtp_depth`` 0 the step is the plain forward's cross entropy:
    the MTP loss is added only for a config that carries the module."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)), mtp_depth=0)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    assert "mtp" not in params
    opt = Adafactor(lr=constant(LR), momentum=0.9)
    tok = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 9)), dtype=torch.int64)
    batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
    _, m = make_train_step(cfg, model, opt)(
        TrainState(params, opt.init(params)), batch)
    with torch.no_grad():
        want = cross_entropy(model.forward(params, batch["inputs"]),
                             batch["labels"], padded_vocab(cfg))
    assert torch.equal(m["loss"], want)


def test_mtp_train_loop_restore_bit_exact():
    """Reduced deepseek-v3 (mla_dense, mla_moe, the MTP module) through
    ``train_loop``: a kill, a restore into a state from another seed, and
    every leaf of params and Adafactor state (``mtp/...`` and m, vr, vc
    included) equal to the uninterrupted run's bit for bit."""
    state = _train_loop_kill_restore_bit_exact(ARCH)
    assert state.opt_state.m["mtp"]["proj"].dtype == torch.bfloat16
    assert state.opt_state.vc["mtp"]["proj"].shape == \
        state.params["mtp"]["proj"].shape[-1:]


def test_train_cli_runs_reduced_deepseek_v3_on_cpu(capsys):
    """``--arch deepseek-v3-671b --reduced --device cpu``: Adafactor trains
    with the MTP loss and checkpoints end to end."""
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--seq", "32", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out
