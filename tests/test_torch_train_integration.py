"""The port's counterpart of the reference's flagship integration test
(``tests/test_train_integration.py``) on reduced starcoder2-3b, the north
star's dense attention model: training with async burst-buffer
checkpoints survives a burst-buffer server failure and restores to a
bit-exact state, and a checkpoint's ingest returns to training before its
flush to the PFS ends; reduced deepseek-coder-33b and llama4-scout-17b-a16e
(Adafactor, the MoE kinds) go through ``train_loop``'s kill and restore. On
the CPU the flash attention forward and backward are the plain versions;
``chip_smoke.py`` runs the same path on the card through the CUDA
kernels."""
import threading
import time

import pytest
import torch

from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.train import batch_to
from repro_torch.models.registry import build_model
from repro_torch.runtime.train_step import (TrainState, init_train_state,
                                            make_optimizer, make_train_step)

ARCH = "starcoder2-3b"


def _setup(seed=0):
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg)
    opt = make_optimizer(cfg)
    state = init_train_state(cfg, model, opt, seed, device="cpu")
    step_fn = make_train_step(cfg, model, opt, accum_steps=1)
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, seed=11)
    return cfg, model, opt, state, step_fn, pipe


def _step(step_fn, state, pipe):
    return step_fn(state, batch_to(next(pipe), "cpu"))


def test_failure_restore_bit_exact_continuation():
    """4 steps, an unquantized checkpoint whose flush drains while
    server/0 is killed, a fresh state from another seed restored from the
    replicas, 4 more steps: every leaf of params and AdamW state equals an
    uninterrupted 8-step run bit for bit (the reference compares the
    params)."""
    cfg, model, opt, state, step_fn, pipe = _setup()

    ref_state = state
    ref_pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=11)
    for _ in range(8):
        ref_state, _ = _step(step_fn, ref_state, ref_pipe)

    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=0.1)) as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        for _ in range(4):
            state, _ = _step(step_fn, state, pipe)
        ckpt = {"params": state.params, "opt_state": state.opt_state,
                "data": {"step": torch.tensor(pipe.step, dtype=torch.int32)}}
        mgr.save(4, ckpt, blocking_flush=False)

        # kill a burst-buffer server while the flush drains
        bb.kill_server("server/0")
        time.sleep(0.8)
        for c in bb.clients:
            c.put_timeout = 0.8

        # "crash": rebuild a fresh state, restore from the BB (replicas)
        state2 = init_train_state(cfg, model, opt, 99, device="cpu")
        target = {"params": state2.params, "opt_state": state2.opt_state,
                  "data": {"step": torch.zeros((), dtype=torch.int32)}}
        restored, ck_step = mgr.restore(target)
        assert ck_step == 4
        state2 = TrainState(restored["params"], restored["opt_state"])
        pipe2 = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4, seed=11)
        pipe2.load_state_dict({"step": int(restored["data"]["step"]),
                               "seed": 11, "shard_id": 0, "num_shards": 1})
        for _ in range(4):
            state2, _ = _step(step_fn, state2, pipe2)

    got, exp = ser.tree_paths(state2), ser.tree_paths(ref_state)
    assert [n for n, _ in got] == [n for n, _ in exp]
    for (name, a), (_, b) in zip(got, exp):
        assert torch.equal(a, b), f"{name}: the restored continuation " \
                                  f"diverged from the uninterrupted run"


def test_checkpoint_overlap_does_not_block_training():
    """``save`` returns in the ingest time (the critical path) and before
    the flush ends: the flush is held at a gate until training has taken
    its next step, so the overlap does not hang on the flush being quick.
    As the reference: the return time within 0.5 s of the ingest, the
    ingest under 5 s, and the flush recorded once it ends."""
    cfg, model, opt, state, step_fn, pipe = _setup()
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=256 << 20)) as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        state, _ = _step(step_fn, state, pipe)
        ckpt = {"params": state.params, "opt_state": state.opt_state,
                "data": {"step": torch.tensor(1, dtype=torch.int32)}}
        mgr.save(1, ckpt, blocking_flush=False)    # warm serialize path
        mgr.wait_flushes()

        gate, flushing = threading.Event(), threading.Event()
        real_flush = bb.flush

        def gated_flush(epoch, timeout=30.0):
            flushing.set()
            assert gate.wait(60.0)
            return real_flush(epoch, timeout=timeout)

        bb.flush = gated_flush
        try:
            t0 = time.perf_counter()
            ingest = mgr.save(2, ckpt, blocking_flush=False)
            t_return = time.perf_counter() - t0
            assert flushing.wait(10.0)
            # training resumes while the flush is still pending
            assert "flush_s" not in mgr.metrics[2]
            state, metrics = _step(step_fn, state, pipe)
            assert torch.isfinite(metrics["loss"])
            assert "flush_s" not in mgr.metrics[2]
        finally:
            gate.set()
        mgr.wait_flushes()
        assert t_return == pytest.approx(ingest, abs=0.5)
        assert ingest < 5.0
        assert mgr.metrics[2]["flush_s"] > 0


def _train_loop_kill_restore_bit_exact(arch):
    """Reduced ``arch`` (the config's optimizer: Adafactor with bf16
    momentum, or AdamW) through ``train_loop``, as chip_smoke.py's training
    restarts drive it: run A takes 6 steps; run B takes 3 with an
    unquantized checkpoint after step 2, loses server/0, restores from the
    replicas into a state drawn from another seed and takes the rest. B's
    losses and every leaf of params and optimizer state equal A's bit for
    bit. Returns B's final state."""
    from repro_torch.launch.train import train_loop
    cfg = reduced(get_config(arch))
    kw = dict(global_batch=4, seq_len=16, log_every=1, device="cpu")
    state_a, hist_a, _ = train_loop(cfg, steps=6, ckpt_every=0, seed=0, **kw)
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=0.1)) as bb:
        _, hist_b, _ = train_loop(cfg, steps=3, ckpt_every=2, bb_system=bb,
                                  quantize_ckpt=False, seed=0, **kw)
        bb.kill_server("server/0")
        time.sleep(0.8)
        for c in bb.clients:
            c.put_timeout = 0.8
        state_b, hist_b2, mgr = train_loop(cfg, steps=6, ckpt_every=0,
                                           bb_system=bb, restore=True,
                                           seed=1, **kw)
    assert mgr.metrics[2]["restore_s"] > 0
    assert [s for s, _ in hist_b2] == [3, 4, 5]
    assert hist_b + hist_b2 == hist_a
    if cfg.optimizer == "adafactor":
        assert type(state_b.opt_state).__name__ == "AdafactorState"
        assert state_b.opt_state.m["embed"]["tokens"].dtype == torch.bfloat16
        assert state_b.opt_state.vc["final_norm"]["scale"].shape == (0,)
    got, exp = ser.tree_paths(state_b), ser.tree_paths(state_a)
    assert [n for n, _ in got] == [n for n, _ in exp]
    for (name, a), (_, b) in zip(got, exp):
        assert torch.equal(a, b), f"{name}: the restored run diverged"
    return state_b


def test_adafactor_train_loop_restore_bit_exact():
    """Reduced deepseek-coder-33b: the zero-size vc of the final norm, the
    bf16 m and vr / vc of the dense leaves through the kill."""
    _train_loop_kill_restore_bit_exact("deepseek-coder-33b")


def test_moe_train_loop_restore_bit_exact():
    """Reduced llama4-scout-17b-a16e (moe_local x 3, moe_nope; 4 experts,
    top-1, a shared expert): the MoE layers' 4-D expert leaves and their
    Adafactor moments (vr (1, E, d), vc (1, E, f)) come back bit for bit
    through the kill, and so does the run."""
    state = _train_loop_kill_restore_bit_exact("llama4-scout-17b-a16e")
    moe = state.params["segments"]["seg0"]["3"]["moe"]
    assert moe["w_gate"].dim() == 4 and moe["router"].dim() == 3
    assert state.opt_state.vc["segments"]["seg0"]["3"]["moe"]["w_gate"] \
        .shape == moe["w_gate"].shape[:2] + moe["w_gate"].shape[3:]
