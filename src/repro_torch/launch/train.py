"""End-to-end training with burst-buffer checkpointing.

Counterpart of ``repro/launch/train.py``. Wires together: config -> model
-> optimizer -> train step -> synthetic data pipeline ->
BBCheckpointManager (async save/flush) -> failure handling (restore from
burst-buffer replicas after a simulated node loss). Runs on the GPU
(``--device cuda``, the default) unless asked for the CPU; batches go from
numpy to the device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --reduced --steps 20 --batch 4 --seq 64 --ckpt-every 10 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.models.registry import build_model
from repro_torch.runtime.train_step import (TrainState, init_train_state,
                                            make_optimizer, make_train_step)


def build(cfg, *, accum=1, peak_lr=3e-4, seed=0, device="cuda"):
    model = build_model(cfg)
    optimizer = make_optimizer(cfg, peak_lr=peak_lr)
    state = init_train_state(cfg, model, optimizer, seed,
                             resolve_device(device))
    step_fn = make_train_step(cfg, model, optimizer, accum_steps=accum)
    return model, optimizer, state, step_fn


def batch_to(batch, device):
    """A numpy batch of the pipeline as tensors on ``device``: token ids as
    int64 (torch's index type), other arrays as they are."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.int64 if v.dtype.kind in "iu" else None)
        for k, v in batch.items()}


def train_loop(cfg, *, steps, global_batch, seq_len, ckpt_every,
               bb_system=None, quantize_ckpt=True, accum=1, log_every=10,
               restore=False, seed=0, device="cuda"):
    """As the reference's ``train_loop``, with the seed of the initial
    params and the device as arguments. Returns (state, history, mgr);
    history holds (step, loss) every ``log_every`` steps, and a restore
    records its seconds as ``mgr.metrics[step]["restore_s"]``."""
    device = resolve_device(device)
    model, optimizer, state, step_fn = build(cfg, accum=accum, seed=seed,
                                             device=device)
    # prefetch starts after a restore has set the stream's step, not before
    # as in the reference: load_state_dict stops a running prefetch thread
    # with a 2 s join and then clears the stop flag for the new one, so a
    # thread that outlived the join would go on queueing the old stream
    pipe = SyntheticLMPipeline(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        enc_seq=cfg.encoder_seq, enc_dim=cfg.encoder_dim)

    own_bb = bb_system is None
    bb = bb_system or BurstBufferSystem(BBConfig(
        num_servers=4, num_clients=4, dram_capacity=256 << 20)).start()
    mgr = BBCheckpointManager(bb, quantize=quantize_ckpt)

    start_step = 0
    if restore:
        target = {"params": state.params, "opt_state": state.opt_state,
                  "data": {"step": torch.zeros((), dtype=torch.int32,
                                               device=device)}}
        t0 = time.perf_counter()
        try:
            restored, ck_step = mgr.restore(target)
            state = TrainState(restored["params"], restored["opt_state"])
            data_step = int(restored["data"]["step"])
            # neither the restore's target (the state drawn from ``seed``)
            # nor the restored tree outlives the restore: held through the
            # run, each kept one more train state on the card
            del target, restored
            pipe.load_state_dict({**pipe.state_dict(), "step": data_step})
            start_step = ck_step + 1
            restore_s = time.perf_counter() - t0
            mgr.metrics.setdefault(ck_step, {})["restore_s"] = restore_s
            print(f"[train] restored from step {ck_step} in "
                  f"{restore_s:.3f}s")
        except FileNotFoundError:
            pass
    pipe.start_prefetch()

    history = []
    t_last = time.perf_counter()
    for step in range(start_step, steps):
        batch = batch_to(next(pipe), device)
        state, metrics = step_fn(state, batch)
        if ckpt_every and step and step % ckpt_every == 0:
            ckpt = {"params": state.params, "opt_state": state.opt_state,
                    "data": {"step": torch.tensor(pipe.step,
                                                  dtype=torch.int32,
                                                  device=device)}}
            ingest = mgr.save(step, ckpt)
            print(f"[ckpt] step {step}: ingest {ingest*1e3:.1f} ms "
                  f"({mgr.metrics[step]['bytes']/1e6:.1f} MB), "
                  f"flush async")
        if step % log_every == 0:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            history.append((step, loss))
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.2f}s)")
    mgr.wait_flushes()
    pipe.stop_prefetch()
    if own_bb:
        bb.stop()
    return state, history, mgr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    state, history, mgr = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_every=args.ckpt_every, quantize_ckpt=not args.no_quant,
        accum=args.accum, restore=args.restore, device=args.device)
    print("final losses:", [f"{l:.4f}" for _, l in history[-5:]])
    print("ckpt metrics:", {k: v for k, v in sorted(mgr.metrics.items())})


if __name__ == "__main__":
    main()
