"""The port's training path against the reference's, on the CPU: the LR
schedules, global-norm clipping, one AdamW update and the loss from
identical inputs; K train steps of reduced xlstm-350m and of reduced
starcoder2-3b from one JAX-initialised state on the same
SyntheticLMPipeline batches; the torch counterpart of the reference's
bit-exact restore after a burst-buffer server is killed; a checkpoint
written by the reference's ``train_loop`` resumed by the port's; the data
stream's first batches after a restore, in the reference's order of
prefetch and restore and in the port's; and the training CLI. The mLSTM and flash kernels themselves run in
``chip_smoke.py``'s training restarts on the card."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_buffer import STEADY_PING_S

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import BBConfig as JBBConfig
from repro.core import BurstBufferSystem as JBurstBufferSystem
from repro.data.pipeline import SyntheticLMPipeline as JPipeline
from repro.launch.train import train_loop as jtrain_loop
from repro.models.registry import build_model as jbuild_model
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.grad import clip_by_global_norm as jclip
from repro.optim.schedule import constant as jconstant
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.runtime import train_step as jts
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch import train
from repro_torch.models.registry import build_model
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad import clip_by_global_norm
from repro_torch.optim.schedule import constant, warmup_cosine
from repro_torch.runtime.train_step import (TrainState, cross_entropy,
                                            make_train_step)

ARCH = "xlstm-350m"
# the architectures trained against the reference: xLSTM (mLSTM, sLSTM),
# the north star's dense attention model (flash forward and backward) and
# the dense model that trains with Adafactor
TRAIN_ARCHS = ("xlstm-350m", "starcoder2-3b", "deepseek-coder-33b")
SEQ, BATCH, DATA_SEED = 16, 4, 11


def _tree(seed, shapes=(("emb", (40, 66)), ("w", (3, 8, 8)),
                        ("norm", (8,)))):
    rng = np.random.default_rng(seed)
    return {"blk": {k: rng.normal(size=s).astype(np.float32)
                    for k, s in shapes[1:]},
            shapes[0][0]: rng.normal(size=shapes[0][1]).astype(np.float32)}


def _flat(tree):
    return {n: np.asarray(leaf.float().numpy()
                          if isinstance(leaf, torch.Tensor) else leaf,
                          np.float32)
            for n, leaf in ser.tree_paths(tree)}


def test_schedules_match_reference():
    """At the warm-up's start, inside it, at its end, along the cosine and
    past the total (equal bits measured; held to 1e-6 relative)."""
    for steps in ([0, 1, 57, 199], [200, 201, 5000, 9999, 10_000, 20_000]):
        s = np.asarray(steps, np.int32)
        exp = jwarmup_cosine(3e-4, 200, 10_000)(jnp.asarray(s))
        out = warmup_cosine(3e-4, 200, 10_000)(torch.from_numpy(s))
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-6,
                                   atol=0)
    one = torch.tensor(5, dtype=torch.int32)
    assert constant(1e-3)(one).item() == float(jconstant(1e-3)(
        jnp.asarray(5, jnp.int32)))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Above the norm (every leaf scaled) and below it (unchanged); the
    sums of squares add in another order (measured 1.9e-7 relative; held
    to 1e-6)."""
    g = _tree(1)
    exp, enorm = jclip(jax.tree.map(jnp.asarray, g), max_norm)
    out, norm = clip_by_global_norm(params_from_numpy(g, device="cpu"),
                                    max_norm)
    np.testing.assert_allclose(norm.item(), float(enorm), rtol=1e-6)
    e = _flat(jax.device_get(exp))
    for name, leaf in _flat(out).items():
        np.testing.assert_allclose(leaf, e[name], rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("step0", [0, 7])
def test_adamw_update_matches_reference(step0):
    """One update from identical params, grads and moments (from a zero
    state and from step 7): decay only on ndim >= 2, bias correction from
    the int32 step; f32, held to 1e-6 relative (equal bits measured here;
    XLA's and torch's pow may round differently elsewhere)."""
    params, grads = _tree(2), _tree(3)
    m = jax.tree.map(lambda a: a * 1e-2, _tree(4))
    v = jax.tree.map(lambda a: np.abs(a) * 1e-4, _tree(5))
    sched = (jwarmup_cosine(1e-3, 3, 100), warmup_cosine(1e-3, 3, 100))
    jopt, opt = JAdamW(lr=sched[0]), AdamW(lr=sched[1])
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    jstate = jstate._replace(step=jnp.asarray(step0, jnp.int32),
                             m=jax.tree.map(jnp.asarray, m),
                             v=jax.tree.map(jnp.asarray, v))
    state = params_from_numpy(jax.device_get(jstate), device="cpu")
    jp, jnew = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                           jax.tree.map(jnp.asarray, params))
    p, new = opt.update(params_from_numpy(grads, device="cpu"), state,
                        params_from_numpy(params, device="cpu"))
    assert new.step.dtype == torch.int32 and new.step.item() == step0 + 1
    exp = _flat(jax.device_get({"p": jp, "m": jnew.m, "v": jnew.v}))
    for name, leaf in _flat({"p": p, "m": new.m, "v": new.v}).items():
        np.testing.assert_allclose(leaf, exp[name], rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    # no decay on the 1-D leaf: a zero gradient and zero moments leave it
    zero = AdamW(lr=sched[1]).init(params_from_numpy(params, device="cpu"))
    p0, _ = opt.update(params_from_numpy(jax.tree.map(np.zeros_like, grads),
                                         device="cpu"), zero,
                       params_from_numpy(params, device="cpu"))
    assert torch.equal(p0["blk"]["norm"], torch.from_numpy(
        params["blk"]["norm"]))
    assert not torch.equal(p0["blk"]["w"], torch.from_numpy(
        params["blk"]["w"]))


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 5, 256)).astype(np.float32) * 3
    labels = rng.integers(0, 200, (2, 5))
    exp = jts.cross_entropy(jnp.asarray(logits),
                            jnp.asarray(labels, jnp.int32), 256)
    out = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        256)
    np.testing.assert_allclose(out.item(), float(exp), rtol=1e-6)


# ------------------------------------------------------- train steps

# a constant learning rate, so that each step moves a param by up to ~1e-3
# (make_optimizer's warm-up starts at 1.5e-6)
LR = 1e-3


def _port_state(jstate):
    """The reference's train state carried into the port's, bit for bit."""
    js = jax.device_get(jstate)
    return TrainState(params_from_numpy(js.params, device="cpu"),
                      params_from_numpy(js.opt_state, device="cpu"))


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def pair(request):
    """A reduced ``TRAIN_ARCHS`` model in both packages from one JAX train
    state, each with the config's optimizer (AdamW, or Adafactor with
    make_optimizer's momentum 0.9) at the constant ``LR``: (jax cfg, model,
    optimizer, state; port cfg, model, optimizer, state). The state has
    taken one reference
    step on a batch of another stream, so that its moments are not zero:
    from zero moments AdamW moves every element by ~LR * sign(grad), and
    the few elements whose gradient is within the two packages' rounding
    of zero move by ~LR in either direction (their update is covered bit
    for bit by test_adamw_update_matches_reference)."""
    arch = request.param
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jmodel = jbuild_model(jcfg)
    if cfg.optimizer == "adafactor":
        jopt = JAdafactor(lr=jconstant(LR), momentum=0.9)
        opt = Adafactor(lr=constant(LR), momentum=0.9)
    else:
        jopt, opt = JAdamW(lr=jconstant(LR)), AdamW(lr=constant(LR))
    jstate = jts.init_train_state(jcfg, jmodel, jopt, jax.random.PRNGKey(0))
    warm = JPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                     global_batch=BATCH, seed=DATA_SEED + 1)._batch_at(0)
    jstate, _ = jax.jit(jts.make_train_step(jcfg, jmodel, jopt))(jstate,
                                                                 warm)
    return (jcfg, jmodel, jopt, jstate, cfg, build_model(cfg), opt,
            _port_state(jstate))


def _assert_update_close(got, exp, before, tol):
    """The port's step against the reference's from one state: for every
    leaf of the params' change (after - ``before``, the flat params the
    step started from) and of the optimizer's moments (AdamW's m and v,
    Adafactor's vr, vc and m), ||port - reference|| <= tol *
    ||reference||; the step bit for bit. A step that updates
    nothing reads 1 on every param leaf, half an update 0.5, an update from
    the wrong bias correction tens of percent; a fixed atol could not
    separate them (v ~ grad^2 ~ 1e-8)."""
    g, e = _flat(got), _flat(jax.device_get(exp))
    assert list(g) == list(e)
    for name, leaf in g.items():
        ref = e[name]
        if name.startswith(".params/"):
            p0 = before[name[len(".params/"):]]
            leaf, ref = leaf - p0, ref - p0
        elif not name.startswith(".opt_state/.") \
                or name == ".opt_state/.step":
            assert np.array_equal(leaf, ref), name
            continue
        err = np.linalg.norm(leaf - ref)
        assert err <= tol * np.linalg.norm(ref), \
            f"{name}: |port - reference| {err:.3e} of |reference| " \
            f"{np.linalg.norm(ref):.3e}"


# f32 at reduced width. The loss of a step agrees to <= 3.5e-7 relative
# (held to 1e-5). The grad norm before clipping (182 at init, 30 to 350 on
# later batches: xLSTM's exponential gates) agrees to 5e-6 to 9.7e-4
# relative, batch by batch; held to 2e-3. Per leaf, the step's param change
# and the moments agree to <= 2.2e-3 of their norm (all measured); held to
# 1e-2. starcoder2-3b (grad norm 3.7 to 6.6) agrees closer: loss 1.7e-7,
# grad norm 1.3e-6, params' change and moments 3.8e-5 (measured);
# deepseek-coder-33b with Adafactor: loss 8.2e-8, grad norm 1.3e-6, params'
# change 1.6e-4, the bf16 m 2.3e-4 (one bf16 rounding of two f32 values that
# differ in the last place moves an element by a whole bf16 ulp), vr and vc
# 3.1e-6 (measured)
LOSS_TOL, GNORM_TOL, STEP_TOL = 1e-5, 2e-3, 1e-2


def test_train_steps_match_reference(pair):
    """K = 4 steps on the same SyntheticLMPipeline batches along the
    reference's trajectory: each step starts both packages from the
    reference's state (chained, the two drift apart at LR = 1e-3 by ~15 x
    a step, from 6e-4 after one step to 6e-2 after four, while the drift
    of one step from a shared state stays below 1e-3: the training
    dynamics amplify rounding). The loss, the grad norm, the params' change
    and the moments of every step."""
    jcfg, jmodel, jopt, jstate, cfg, model, opt, state = pair
    assert isinstance(state, TrainState)
    jstep = jax.jit(jts.make_train_step(jcfg, jmodel, jopt))
    step = make_train_step(cfg, model, opt)
    jpipe = JPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=DATA_SEED)
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH, seed=DATA_SEED)
    for k in range(4):
        state = _port_state(jstate)
        before = _flat(state.params)
        jstate, jm = jstep(jstate, next(jpipe))
        state, m = step(state, train.batch_to(next(pipe), "cpu"))
        assert state.opt_state.step.item() == k + 2
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=GNORM_TOL)
        _assert_update_close(state, jstate, before, STEP_TOL)


def test_microbatch_accumulation_matches_reference(pair):
    """Two microbatches of 2 accumulated in f32 (the reference's scan)."""
    jcfg, jmodel, jopt, jstate, cfg, model, opt, state = pair
    jstep = jax.jit(jts.make_train_step(jcfg, jmodel, jopt, accum_steps=2))
    step = make_train_step(cfg, model, opt, accum_steps=2)
    batch = JPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=DATA_SEED)._batch_at(9)
    before = _flat(state.params)
    jstate, jm = jstep(jstate, batch)
    state, m = step(state, train.batch_to(batch, "cpu"))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_TOL)
    _assert_update_close(state, jstate, before, STEP_TOL)


def test_failure_restore_bit_exact_continuation(pair):
    """The torch counterpart of the reference's flagship test on reduced
    xlstm-350m: 4 steps, an unquantized checkpoint, server/0 killed, a
    fresh state from another seed restored from the replicas, 4 more
    steps; params and optimizer state equal an uninterrupted 8-step run bit
    for bit."""
    cfg = pair[4]
    model, opt, state, step_fn = train.build(cfg, seed=0, device="cpu")
    mk_pipe = lambda: SyntheticLMPipeline(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH,
                                          seed=DATA_SEED)
    ref_state, ref_pipe = state, mk_pipe()
    for _ in range(8):
        ref_state, _ = step_fn(ref_state, train.batch_to(next(ref_pipe),
                                                         "cpu"))

    pipe = mk_pipe()
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=0.1)) as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        for _ in range(4):
            state, _ = step_fn(state, train.batch_to(next(pipe), "cpu"))
        mgr.save(4, {"params": state.params, "opt_state": state.opt_state,
                     "data": {"step": torch.tensor(pipe.step,
                                                   dtype=torch.int32)}},
                 blocking_flush=False)
        bb.kill_server("server/0")
        time.sleep(0.8)
        for c in bb.clients:
            c.put_timeout = 0.8
        _, _, fresh, _ = train.build(cfg, seed=99, device="cpu")
        restored, ck_step = mgr.restore(
            {"params": fresh.params, "opt_state": fresh.opt_state,
             "data": {"step": torch.zeros((), dtype=torch.int32)}})
        assert ck_step == 4
        state = TrainState(restored["params"], restored["opt_state"])
        pipe = mk_pipe()
        pipe.load_state_dict({**pipe.state_dict(),
                              "step": int(restored["data"]["step"])})
        for _ in range(4):
            state, _ = step_fn(state, train.batch_to(next(pipe), "cpu"))

    got, exp = ser.tree_paths(state), ser.tree_paths(ref_state)
    assert [n for n, _ in got] == [n for n, _ in exp]
    for (name, a), (_, b) in zip(got, exp):
        assert torch.equal(a, b), f"{name}: the restored continuation " \
                                  f"diverged from the uninterrupted run"


# Both buffers in the test below ping every STEADY_PING_S (10 s; the
# buffers' default is 0.25 s): a false death during the reference's step-3
# flush left a PFS copy that was not the checkpoint, which the port, over a
# fresh buffer, read (losses 5.566888 and 5.534484 for the reference's
# 5.538018 and 5.544424, or an empty manifest, a FileNotFoundError that
# train_loop takes for "no checkpoint"). No server is killed here, so a
# slow cadence loses nothing (tests/_torch_buffer.py)


# the AdamW configs only: the reference's checkpoint manager pwrites an
# Adafactor state's empty (0,) payloads, which put an empty chunk under the
# key of the next leaf's first chunk, and under load the two puts land in
# either order (the port's manager, which wrote them the same way, lost
# that chunk in 2 of 4 loaded runs of the kill test above; ROADMAP Queue
# 3). A reference Adafactor checkpoint restores in the port bit for bit in
# tests/test_torch_adafactor.py, through the serializers
@pytest.mark.parametrize("pair", ["xlstm-350m", "starcoder2-3b"],
                         indirect=True)
def test_reference_train_loop_checkpoint_resumes_in_torch(pair, tmp_path):
    """The reference's ``train_loop`` trains 4 steps and checkpoints after
    step 3 (flushed to the PFS directory); the port's ``train_loop``, over
    its own burst buffer on the same PFS directory, restores it and trains
    to step 6, as the reference's does from the same checkpoint: the
    losses within LOSS_TOL, and the params' change from the checkpoint and
    the moments within STEP_TOL of the reference's (make_optimizer's
    warm-up, as both loops build it: each param moves ~1e-5 in these two
    steps, so a fixed atol would not see a step that was not taken)."""
    jcfg, cfg = pair[0], pair[4]
    kw = dict(steps=4, global_batch=BATCH, seq_len=SEQ, ckpt_every=3,
              quantize_ckpt=False, log_every=1)
    pfs = str(tmp_path / "pfs")
    with JBurstBufferSystem(JBBConfig(num_servers=4, num_clients=4,
                                      dram_capacity=64 << 20, pfs_dir=pfs,
                                      stabilize_interval=STEADY_PING_S)
                            ) as jbb:
        jck, _, _ = jtrain_loop(jcfg, bb_system=jbb, **kw)
        kw.update(steps=6, restore=True, ckpt_every=0)
        jstate, jhist, _ = jtrain_loop(jcfg, bb_system=jbb, **kw)
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20, pfs_dir=pfs,
                                    stabilize_interval=STEADY_PING_S)
                           ) as bb:
        state, hist, mgr = train.train_loop(cfg, bb_system=bb, seed=5,
                                            device="cpu", **kw)
    assert mgr.metrics[3]["restore_s"] > 0
    assert [s for s, _ in hist] == [s for s, _ in jhist] == [4, 5]
    np.testing.assert_allclose([l for _, l in hist], [l for _, l in jhist],
                               rtol=LOSS_TOL)
    assert state.opt_state.step.item() == 6
    _assert_update_close(state, jstate, _flat(jax.device_get(jck.params)),
                         STEP_TOL)


# ------------------------------------------- the data stream across a restore

# the pipeline's load_state_dict stops a running prefetch thread with a 2 s
# join, then clears the stop flag and starts a thread at the restored step.
# A batch that takes longer than the join to build outlives it, and the old
# thread then goes on feeding the queue; one that takes less (here 0.5 s,
# five times the thread's 0.1 s put poll) ends with its thread
JOIN_S = 2.0


def _slow_pipe(delay):
    """A pipeline whose ``_batch_at`` sleeps ``delay`` s first, the fast one
    of the same stream, and an event set once a batch is being built."""
    pipe = SyntheticLMPipeline(vocab_size=128, seq_len=SEQ,
                               global_batch=BATCH, seed=DATA_SEED)
    fast, building = pipe._batch_at, threading.Event()

    def slow(step):
        building.set()
        time.sleep(delay)
        return fast(step)

    pipe._batch_at = slow
    return pipe, fast, building


@pytest.mark.parametrize("order,delay,restored", [
    ("reference", 0.5, True), ("reference", JOIN_S + 0.5, False),
    ("port", JOIN_S + 0.5, True)])
def test_first_batches_after_a_restore(order, delay, restored):
    """The reference's ``train_loop`` starts the prefetch and then loads the
    restored stream state (``load_state_dict``); the port's loads it first
    and then starts the prefetch. The first two batches after a restore at
    step 7 are ``_batch_at(7)`` and ``_batch_at(8)`` in the reference's
    order while a batch takes less than the join, and in the port's order
    however long a batch takes; in the reference's order a batch slower
    than the join lets the old thread put the batch of step 0 first."""
    pipe, fast, building = _slow_pipe(delay)
    state = {**pipe.state_dict(), "step": 7}
    try:
        if order == "reference":
            pipe.start_prefetch()
            assert building.wait(10.0)    # the thread is in _batch_at(0)
            pipe.load_state_dict(state)
        else:
            pipe.load_state_dict(state)
            pipe.start_prefetch()
        got = [next(pipe)["inputs"] for _ in range(2)]
    finally:
        pipe.stop_prefetch()
    want = [fast(7)["inputs"], fast(8)["inputs"]]
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) == restored
    if not restored:
        assert np.array_equal(got[0], fast(0)["inputs"])
    assert pipe.step == 9


def test_train_cli_runs_reduced_xlstm_on_cpu(capsys):
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--seq", "32", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out


def test_train_cli_default_arch_runs_reduced_starcoder2_on_cpu(capsys):
    """The CLI's default ``--arch`` is starcoder2-3b: its reduced config
    trains (the flash backward's plain Function on the CPU) and
    checkpoints."""
    train.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch",
                "2", "--seq", "32", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out


def test_train_cli_runs_reduced_deepseek_coder_on_cpu(capsys):
    """``--arch deepseek-coder-33b --reduced --device cpu``: Adafactor
    trains and checkpoints (its bf16 m quantized to int8) end to end."""
    train.main(["--arch", "deepseek-coder-33b", "--reduced", "--device",
                "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
                "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out
