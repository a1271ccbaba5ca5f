"""The port's examples (``examples/torch_*.py``) against the reference, on
the CPU in f32 at reduced size: the quickstart's training with int8
checkpoints from the reference's initial state (the losses), its buffer
report (the residency, manifest and file names) and its greedy decode
(the tokens) against the same loop written with the reference's API; the
restart demo through a kill, a full eviction and a stage, bit for bit an
uninterrupted run, and a checkpoint written and evicted by the reference's
manager, staged and restored by the port's; and the training and serving
examples through their ``main`` on the CPU, each refusing to run without a
card unless asked for the CPU. Parameters are built by the reference and
carried into the port through ``params_from_numpy``."""
import contextlib
import dataclasses
import importlib.util
import io
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_buffer import STEADY_PING_S

from repro.checkpoint.bbckpt import BBCheckpointManager as JManager
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import BBConfig as JBBConfig
from repro.core import BurstBufferSystem as JBurstBufferSystem
from repro.data.pipeline import SyntheticLMPipeline as JPipeline
from repro.models.registry import build_model as jbuild_model
from repro.optim.adamw import AdamWState as JAdamWState
from repro.runtime import train_step as jts
from repro.runtime.serve_step import greedy_token as jgreedy_token
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.core.filesystem import BBFileSystem
from repro_torch.launch import train
from repro_torch.models.registry import build_model
from repro_torch.runtime.train_step import (TrainState, make_optimizer,
                                            make_train_step)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# the quickstart's loop at a smaller size than its main's 20 steps of
# 8 x 64 tokens: 6 steps of 4 x 32, an int8 checkpoint after every third
QS_STEPS, QS_EVERY, QS_BATCH, QS_SEQ = 6, 3, 4, 32
# Each step's loss in the port's loop against the reference's step from the
# same state on the same batch, f32 (as tests/test_torch_train.py's
# LOSS_TOL). The two loops are not compared step for step past the first
# update: reduced gemma3-4b is ill-conditioned at init (its scores have a
# standard deviation near 16, see tests/test_torch_cross.py), and f32
# rounding moves its gradients far beyond the unit roundoff, so each
# package's own trajectory drifts. Measured on the quickstart's first batch
# against a float64 run of the port: the reference's gradient 7.7e-3 and
# the port's 1.8e-2 of the leaf's norm at most (segments/seg0/3/norm1/
# scale), grad norms 1016.6 and 1012.1 against 1018.4; AdamW's first steps
# move every element by ~lr sign(g), so the loops' losses part from the
# second update on (2.6e-4 relative at step 2, 1.4e-3 at step 5), while
# every step from a shared state agrees to 3e-7
LOSS_TOL = 1e-5
# Every buffer these tests start pings its servers every STEADY_PING_S
# (tests/_torch_buffer.py) instead of the default 0.25 s. The restart demo
# kills server/0 on purpose: its test pings at the demo's 0.1 s from the
# kill until the manager counts server/0 dead (``_handle_kill``)
KILL_TIMEOUT_S = 30.0


def _example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


quickstart = _example("torch_quickstart")
restart_demo = _example("torch_restart_demo")
train_lm = _example("torch_train_lm")
serve_lm = _example("torch_serve_lm")


def _port_state(jstate):
    js = jax.device_get(jstate)
    return TrainState(params_from_numpy(js.params, device="cpu"),
                      params_from_numpy(js.opt_state, device="cpu"))


def _reference_quickstart(jcfg, jstate):
    """The quickstart's loop and buffer report written with the reference's
    API at the test's size (``examples/quickstart.py``'s code): the losses,
    the final state, the last checkpoint's residency, the manifest text and
    the buffered files."""
    jmodel = jbuild_model(jcfg)
    jopt = jts.make_optimizer(jcfg, peak_lr=1e-3)
    step_fn = jax.jit(jts.make_train_step(jcfg, jmodel, jopt,
                                          accum_steps=1))
    pipe = JPipeline(vocab_size=jcfg.vocab_size, seq_len=QS_SEQ,
                     global_batch=QS_BATCH).start_prefetch()
    losses = []
    with JBurstBufferSystem(JBBConfig(num_servers=4, num_clients=4,
                                      dram_capacity=128 << 20,
                                      stabilize_interval=STEADY_PING_S)
                            ) as bb:
        mgr = JManager(bb, quantize=True)
        for step in range(QS_STEPS):
            jstate, metrics = step_fn(jstate, next(pipe))
            losses.append(float(metrics["loss"]))
            if step % QS_EVERY == QS_EVERY - 1:
                mgr.save(step, {"params": jstate.params,
                                "opt_state": jstate.opt_state,
                                "data": {"step": jnp.asarray(pipe.step)}})
        mgr.wait_flushes()
        pipe.stop_prefetch()
        fs = bb.fs()
        st = fs.stat(f"ckpt_{max(mgr.metrics):08d}")
        with fs.open("run_info.txt", "w", policy="batched") as f:
            f.write(f"arch={jcfg.name} steps={QS_STEPS} ckpts="
                    f"{sorted(mgr.metrics)}\n".encode())
        with fs.open("run_info.txt", "r") as f:
            manifest = f.read().decode().strip()
        names = fs.listdir()
    return losses, jstate, {"residency": st["residency"],
                            "manifest": manifest, "listdir": names}


def _recording(steps):
    """A ``make_train_step`` whose steps append (state before, batch, loss)
    to ``steps``."""
    make = quickstart.make_train_step

    def make_recording(*args, **kw):
        step_fn = make(*args, **kw)

        def step(state, batch):
            new, metrics = step_fn(state, batch)
            steps.append((state, batch, metrics["loss"].item()))
            return new, metrics
        return step
    return make_recording


@pytest.fixture(scope="module")
def qs_runs():
    """Reduced gemma3-4b (the quickstart's d_model 128, vocab 512) from the
    reference's ``init_train_state(PRNGKey(0))``: the reference's loop and
    the port's ``train_with_checkpoints`` + ``buffer_report`` (their
    printed lines captured, each step's state, batch and loss recorded)
    from that one state."""
    jcfg = jreduced(jget_config("gemma3-4b"), d_model=128, vocab=512)
    cfg = reduced(get_config("gemma3-4b"), d_model=128, vocab=512)
    jmodel = jbuild_model(jcfg)
    jstate = jts.init_train_state(jcfg, jmodel,
                                  jts.make_optimizer(jcfg, peak_lr=1e-3),
                                  jax.random.PRNGKey(0))
    port0 = _port_state(jstate)
    jlosses, jfinal, jreport = _reference_quickstart(jcfg, jstate)
    out, steps = io.StringIO(), []
    make = quickstart.make_train_step
    quickstart.make_train_step = _recording(steps)
    try:
        with contextlib.redirect_stdout(out), BurstBufferSystem(BBConfig(
                num_servers=4, num_clients=4, dram_capacity=128 << 20,
                stabilize_interval=STEADY_PING_S)) as bb:
            model, state, losses, mgr = quickstart.train_with_checkpoints(
                cfg, bb, "cpu", steps=QS_STEPS, ckpt_every=QS_EVERY,
                batch=QS_BATCH, seq=QS_SEQ, state=port0)
            report = quickstart.buffer_report(cfg, bb, mgr, steps=QS_STEPS)
    finally:
        quickstart.make_train_step = make
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jlosses=jlosses, jfinal=jfinal, jreport=jreport,
                losses=losses, steps=steps, state=state, mgr=mgr,
                report=report, printed=out.getvalue())


def _reference_state(state):
    """The port's train state as the reference's, bit for bit."""
    to_jax = lambda t: jnp.asarray(t.detach().numpy())
    opt = state.opt_state
    return jts.TrainState(
        jax.tree.map(to_jax, state.params),
        JAdamWState(step=to_jax(opt.step), m=jax.tree.map(to_jax, opt.m),
                    v=jax.tree.map(to_jax, opt.v)))


def test_quickstart_losses_match_reference(qs_runs):
    """Six steps of the quickstart's loop with int8 checkpoints after steps
    2 and 5 (flushed): each step's loss within LOSS_TOL of the reference's
    step (make_optimizer's AdamW, peak lr 1e-3) from the state the port's
    step started from, on the port's batch of that step, the saves
    included; and the loops' first two losses (the first update has lr 0,
    so both start from the reference's state) within LOSS_TOL of the
    reference's loop's."""
    jcfg, jmodel, steps = qs_runs["jcfg"], qs_runs["jmodel"], qs_runs["steps"]
    jstep = jax.jit(jts.make_train_step(
        jcfg, jmodel, jts.make_optimizer(jcfg, peak_lr=1e-3), accum_steps=1))
    assert [loss for *_, loss in steps] == qs_runs["losses"]
    assert len(steps) == QS_STEPS
    for k, (state, batch, loss) in enumerate(steps):
        _, metrics = jstep(_reference_state(state),
                           {key: np.asarray(v.numpy(), np.int32)
                            for key, v in batch.items()})
        np.testing.assert_allclose(loss, float(metrics["loss"]),
                                   rtol=LOSS_TOL, err_msg=f"step {k}")
    np.testing.assert_allclose(qs_runs["losses"][:2], qs_runs["jlosses"][:2],
                               rtol=LOSS_TOL)
    mgr = qs_runs["mgr"]
    assert sorted(mgr.metrics) == [2, 5]
    assert all(m.get("flushed") for m in mgr.metrics.values())


class _RecordingOptimizer:
    """An optimizer whose updates append (grads, state, params, result)
    to ``calls``."""

    def __init__(self, optimizer):
        self.optimizer, self.calls = optimizer, []

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, state, params):
        out = self.optimizer.update(grads, state, params)
        self.calls.append((grads, state, params, out))
        return out


def test_quickstart_updates_match_reference(qs_runs):
    """Each of the quickstart loop's six steps, the int8 saves after steps
    2 and 5 included. The state the loop carried out of the step (into the
    next one, or returned after the last) is bit for bit the port's own
    step from the recorded state on that step's batch: a save left the
    live state as it was, and the loop's optimizer is make_optimizer's
    AdamW at peak lr 1e-3. That step's update (from its clipped gradients,
    moments and params) is the reference's AdamW from make_optimizer at the
    same peak lr, within 1e-6 relative (as test_torch_train.py holds one
    update): the schedule's lr at the step, the bias correction, the
    decay. The reference's whole step from the same state is held by its
    loss only: its f32 gradients of reduced gemma3-4b's ill-conditioned
    leaves (attn wq / wk, norm scales) are 1e-2 to 4.6e-2 of the moments'
    norm from the port's (measured), above the int8 rounding of a save."""
    jcfg, cfg, steps = qs_runs["jcfg"], qs_runs["cfg"], qs_runs["steps"]
    opt = _RecordingOptimizer(make_optimizer(cfg, peak_lr=1e-3))
    step_fn = make_train_step(cfg, qs_runs["model"], opt, accum_steps=1)
    jopt = jts.make_optimizer(jcfg, peak_lr=1e-3)
    to_jax = lambda tree: jax.tree.map(
        lambda t: jnp.asarray(t.detach().numpy()), tree)
    carried = [state for state, *_ in steps[1:]] + [qs_runs["state"]]
    for k, ((state, batch, _), out) in enumerate(zip(steps, carried)):
        new, _ = step_fn(state, batch)
        got, exp = _leaves(out), _leaves(new)
        assert list(got) == list(exp)
        for name, leaf in exp.items():
            assert torch.equal(got[name], leaf), f"step {k}: {name}"
        grads, opt_state, params, (p, s) = opt.calls[-1]
        jp, js = jopt.update(to_jax(grads), JAdamWState(
            step=to_jax(opt_state.step), m=to_jax(opt_state.m),
            v=to_jax(opt_state.v)), to_jax(params))
        assert s.step.item() == int(js.step) == k + 1
        want = _leaves(params_from_numpy(jax.device_get(
            {"params": jp, "m": js.m, "v": js.v}), device="cpu"))
        have = _leaves({"params": p, "m": s.m, "v": s.v})
        assert list(have) == list(want)
        for name, leaf in want.items():
            np.testing.assert_allclose(have[name].numpy(), leaf.numpy(),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"step {k}: {name}")


def test_quickstart_report_names_match_reference(qs_runs):
    """The residency's tiers and bytes, the manifest's text and the buffered
    files are the reference's, and the printed lines carry them."""
    report, jreport = qs_runs["report"], qs_runs["jreport"]
    assert report["residency"] == jreport["residency"]
    assert report["residency"]["dram"] > 0
    assert report["manifest"] == jreport["manifest"] == (
        "arch=gemma3-4b-reduced steps=6 ckpts=[2, 5]")
    assert report["listdir"] == jreport["listdir"] == [
        "ckpt_00000002", "ckpt_00000002.manifest", "ckpt_00000005",
        "ckpt_00000005.manifest", "run_info.txt"]
    lines = qs_runs["printed"].splitlines()
    assert any(line.startswith("ckpt_00000005 residency: {'dram': ")
               for line in lines)
    assert any(line.startswith("cluster pressure: occupancy max ")
               for line in lines)
    assert f"run manifest (via burst buffer): {jreport['manifest']}" in lines
    assert f"buffered files: {jreport['listdir']}" in lines
    assert any(line.startswith("checkpoint timings: {2: ") for line in lines)


def test_greedy_serve_matches_reference(qs_runs):
    """From the reference's trained params (carried into the port), the
    quickstart's decode of 2 x 16 prompt tokens and 8 more: the port's
    ``greedy_serve`` gives the reference's prefill / decode_step /
    greedy_token tokens."""
    jcfg, jmodel, cfg = qs_runs["jcfg"], qs_runs["jmodel"], qs_runs["cfg"]
    jparams = qs_runs["jfinal"].params
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 16))
    cache = jmodel.init_cache(2, 96)
    logits, cache = jmodel.prefill(jparams, cache,
                                   jnp.asarray(prompts, jnp.int32))
    tok = jgreedy_token(jcfg, logits)
    exp = [tok]
    for i in range(8):
        logits, cache = jmodel.decode_step(jparams, cache, tok,
                                           jnp.asarray(16 + i, jnp.int32))
        tok = jgreedy_token(jcfg, logits)
        exp.append(tok)
    exp = np.asarray(jnp.concatenate(exp, axis=1))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    out = quickstart.greedy_serve(cfg, build_model(cfg), params,
                                  torch.from_numpy(prompts), new_tokens=8,
                                  max_seq=96)
    assert out.dtype == torch.int32 and out.shape == (2, 9)
    np.testing.assert_array_equal(out.numpy(), exp)


def _leaves(tree):
    return dict(ser.tree_paths(tree))


def _handle_kill(bb):
    """After the demo's kill: ping at the demo's cadence until the manager
    counts server/0 dead, then at STEADY_PING_S again."""
    for srv in bb.servers.values():
        srv.stabilize_interval = restart_demo.DEMO_BB.stabilize_interval
    deadline = time.monotonic() + KILL_TIMEOUT_S
    while "server/0" not in bb.manager.dead:
        assert time.monotonic() < deadline, "server/0's death not handled"
        time.sleep(0.05)
    for srv in bb.servers.values():
        srv.stabilize_interval = STEADY_PING_S


def test_restart_demo_bit_exact_after_eviction_and_stage(monkeypatch):
    """Reduced h2o-danube-1.8b through the demo's run: 5 steps, a flushed
    unquantized checkpoint, server/0 killed (and the death handled,
    ``_handle_kill``, before the demo's own pause), the checkpoint evicted
    until nothing of it is buffered, staged (called only after that),
    restored into a state from another seed, 5 more steps: every leaf of
    params and AdamW state bit for bit the uninterrupted 10-step run's."""
    stages = []
    orig_stage, orig_kill = BBFileSystem.stage, BurstBufferSystem.kill_server

    def stage(self, path, *args, **kw):
        if kw.get("wait", True):
            stages.append(self.stat(path)["residency"])
        return orig_stage(self, path, *args, **kw)

    def kill_server(self, name):
        orig_kill(self, name)
        _handle_kill(self)

    monkeypatch.setattr(BBFileSystem, "stage", stage)
    monkeypatch.setattr(BurstBufferSystem, "kill_server", kill_server)
    cfg = reduced(get_config("h2o-danube-1.8b"))
    ref, state, info = restart_demo.restart_after_eviction(
        cfg, "cpu", bb_config=dataclasses.replace(
            restart_demo.DEMO_BB, stabilize_interval=STEADY_PING_S))
    got, exp = _leaves(state), _leaves(ref)
    assert list(got) == list(exp)
    for name, leaf in exp.items():
        assert torch.equal(got[name], leaf), name
    assert state.opt_state.step.item() == restart_demo.STEPS
    # the demo's stage, then the restore's (a no-op by then)
    assert len(stages) == 2
    assert stages[0]["dram"] == stages[0]["ssd"] == 0 < stages[0]["pfs"]
    assert info["evicted"] == stages[0]
    assert info["staged"] is True and info["stage_stats"]["epochs"] >= 1
    assert info["stage_stats"]["staged_bytes"] > 0
    assert info["residency"]["dram"] > 0
    assert info["restore_s"] > 0 and info["dead"] == ["server/0"]


def test_reference_checkpoint_evicted_and_staged_restores_in_torch(tmp_path):
    """A reduced h2o-danube-1.8b train state (one reference step, so its
    moments are not zero) saved unquantized by the reference's manager with
    a blocking flush, evicted from the reference's buffer until nothing of
    it is buffered; the port's buffer over the same PFS directory stages it
    (``evict_and_stage``) and the port's manager restores it into a state
    from another seed: every leaf bit for bit the reference's."""
    jcfg = jreduced(jget_config("h2o-danube-1.8b"))
    cfg = reduced(get_config("h2o-danube-1.8b"))
    jmodel = jbuild_model(jcfg)
    jopt = jts.make_optimizer(jcfg)
    jstate = jts.init_train_state(jcfg, jmodel, jopt, jax.random.PRNGKey(0))
    batch = JPipeline(vocab_size=jcfg.vocab_size, seq_len=32,
                      global_batch=4, seed=42)._batch_at(0)
    jstate, _ = jax.jit(jts.make_train_step(jcfg, jmodel, jopt))(jstate,
                                                                 batch)
    ckpt = {"params": jstate.params, "opt_state": jstate.opt_state,
            "data": {"step": jnp.asarray(1, jnp.int32)}}
    fname, pfs = "ckpt_00000001", str(tmp_path / "pfs")
    with JBurstBufferSystem(JBBConfig(num_servers=4, num_clients=4,
                                      dram_capacity=128 << 20, pfs_dir=pfs,
                                      stabilize_interval=STEADY_PING_S)
                            ) as jbb:
        JManager(jbb, quantize=False).save(1, ckpt, blocking_flush=True)
        jbb.evict(fname)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            res = jbb.fs().stat(fname)["residency"]
            if res["dram"] == res["ssd"] == 0:
                break
            time.sleep(0.05)
        assert res["dram"] == res["ssd"] == 0 < res["pfs"]

    _, _, fresh, _ = train.build(cfg, seed=123, device="cpu")
    target = {"params": fresh.params, "opt_state": fresh.opt_state,
              "data": {"step": torch.zeros((), dtype=torch.int32)}}
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=128 << 20, pfs_dir=pfs,
                                    stabilize_interval=STEADY_PING_S)) as bb:
        info = restart_demo.evict_and_stage(bb, fname)
        restored, step = BBCheckpointManager(bb, quantize=False).restore(
            target)
    assert step == 1
    assert info["evicted"]["dram"] == info["evicted"]["ssd"] == 0
    assert info["staged"] is True and info["residency"]["dram"] > 0
    exp = _leaves(params_from_numpy(jax.device_get(ckpt), device="cpu"))
    got = _leaves(restored)
    assert list(got) == list(exp)
    for name, leaf in exp.items():
        assert got[name].dtype == leaf.dtype, name
        assert torch.equal(got[name], leaf), name


def test_train_lm_tiny_on_cpu(capsys):
    """``torch_train_lm.py --preset tiny`` through ``train_loop`` on the
    CPU: 11 steps with an int8 checkpoint after step 10, finite losses."""
    state, history, mgr = train_lm.main(
        ["--preset", "tiny", "--steps", "11", "--batch", "2", "--seq", "16",
         "--device", "cpu"])
    assert [s for s, _ in history] == [0, 10]
    assert all(np.isfinite(l) for _, l in history)
    assert sorted(mgr.metrics) == [10]
    assert state.opt_state.step.item() == 11
    out = capsys.readouterr().out
    assert "[train_lm] lm-110m-reduced: " in out
    assert "[train_lm] loss trajectory: ['0:" in out


def test_serve_lm_on_cpu(capsys):
    """``torch_serve_lm.py`` adds --reduced and serves a request batch on
    the CPU."""
    serve_lm.main(["--arch", "h2o-danube-1.8b", "--requests", "1",
                   "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] request-batch 0: (4, 4)" in out


@pytest.mark.parametrize("example,argv", [
    ("quickstart", []), ("restart_demo", []),
    ("train_lm", ["--preset", "tiny", "--steps", "1"]),
    ("serve_lm", ["--arch", "h2o-danube-1.8b"])])
def test_examples_refuse_cuda_without_a_card(example, argv):
    """Each example runs on the card by default and raises without one
    (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    main = {"quickstart": quickstart, "restart_demo": restart_demo,
            "train_lm": train_lm, "serve_lm": serve_lm}[example].main
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
