"""Failure + eviction demo on the PyTorch port: a burst-buffer server dies
mid-training AND the checkpoint is fully evicted to the PFS (what the drain
engine does to cold data); the job stages the checkpoint back into the
buffer (`fs.stage`, each surviving server re-ingesting its own domain in
parallel), restores through a prefetching handle, and continues
BIT-EXACTLY as if nothing happened (compared against an uninterrupted
reference run).

The counterpart of ``examples/restart_demo.py`` over ``repro_torch``. Runs
on the GPU (``--device cuda``, the default) unless asked for the CPU:

  PYTHONPATH=src python examples/torch_restart_demo.py --device cpu
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.train import batch_to
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.runtime.train_step import (TrainState, init_train_state,
                                            make_optimizer, make_train_step)

STEPS, CKPT_AT = 10, 5
# the demo's buffer: 4 servers of 128 MiB, pinged every 0.1 s
DEMO_BB = BBConfig(num_servers=4, num_clients=4, dram_capacity=128 << 20,
                   stabilize_interval=0.1)


def fresh(cfg, model, optimizer, device, seed=0, *, batch=4, seq=32):
    state = init_train_state(cfg, model, optimizer, seed, device)
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=42)
    return state, pipe


def _wait_unbuffered(bb, path, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = bb.fs().stat(path)
        if st["residency"]["dram"] == 0 and st["residency"]["ssd"] == 0:
            return
        time.sleep(0.05)
    raise RuntimeError(f"{path} still buffered after evict")


def evict_and_stage(bb, fname, *, unbuffered_timeout=15.0):
    """The drain engine's endgame for cold data (every buffered copy of
    ``fname`` tombstoned, its bytes only on the PFS), then the stage-in:
    one manager-coordinated bulk load, each surviving server re-ingesting
    its own lookup-table domain in parallel. Returns {"evicted": residency
    once unbuffered, "staged": what ``fs.stage`` returned, "stage_s": its
    seconds, "stage_stats": the manager's, "residency": after the
    stage}."""
    bb.evict(fname)
    _wait_unbuffered(bb, fname, unbuffered_timeout)
    evicted = bb.fs().stat(fname)["residency"]
    print(f"[demo] checkpoint fully evicted: residency={evicted}")

    t0 = time.perf_counter()
    staged = bb.fs().stage(fname)
    stage_s = time.perf_counter() - t0
    st = bb.fs().stat(fname)
    print(f"[demo] fs.stage({fname!r}) -> {staged}, "
          f"stage_stats={bb.manager.stage_stats}, "
          f"residency={st['residency']}")
    return {"evicted": evicted, "staged": staged, "stage_s": stage_s,
            "stage_stats": dict(bb.manager.stage_stats),
            "residency": st["residency"]}


def restart_after_eviction(cfg, device, *, steps=STEPS, ckpt_at=CKPT_AT,
                           batch=4, seq=32, bb_config=DEMO_BB,
                           unbuffered_timeout=15.0):
    """Run A: ``steps`` uninterrupted steps. Run B, over a burst buffer of
    ``bb_config``: ``ckpt_at`` steps, an unquantized checkpoint flushed to
    the PFS before ``save`` returns, server/0 killed, the checkpoint
    evicted and staged (``evict_and_stage``), restored into a state drawn
    from another seed, and the rest of the steps. The job waits a second
    after the kill. Returns (run A's state, run B's state, the stage's
    record with the checkpoint's ``save_s`` (ingest and flush),
    ``ingest_s``, ``bytes`` and ``flushed``, the ``restore_s`` and the
    servers counted ``dead`` after the restore added)."""
    model = build_model(cfg)
    optimizer = make_optimizer(cfg)
    step_fn = make_train_step(cfg, model, optimizer, accum_steps=1)

    # ---- reference: uninterrupted run ----
    state, pipe = fresh(cfg, model, optimizer, device, batch=batch, seq=seq)
    for _ in range(steps):
        state, _ = step_fn(state, batch_to(next(pipe), device))
    ref = state

    # ---- run with failure + full eviction ----
    state, pipe = fresh(cfg, model, optimizer, device, batch=batch, seq=seq)
    with BurstBufferSystem(bb_config) as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        for _ in range(ckpt_at):
            state, _ = step_fn(state, batch_to(next(pipe), device))
        fname = f"ckpt_{ckpt_at:08d}"
        t0 = time.perf_counter()
        mgr.save(ckpt_at, {"params": state.params,
                           "opt_state": state.opt_state,
                           "data": {"step": torch.tensor(
                               pipe.step, dtype=torch.int32, device=device)}},
                 blocking_flush=True)           # durable on the PFS
        save_s = time.perf_counter() - t0
        print(f"[demo] checkpoint at step {ckpt_at} ingested + flushed")
        del state

        bb.kill_server("server/0")
        print("[demo] killed server/0 (stabilization + manager broadcast)")
        time.sleep(1.0)
        for c in bb.clients:
            c.put_timeout = 0.8

        info = evict_and_stage(bb, fname,
                               unbuffered_timeout=unbuffered_timeout)
        info.update(save_s=save_s, **{k: mgr.metrics[ckpt_at][k] for k in (
            "ingest_s", "bytes", "flushed")})

        print("[demo] simulating job crash: discarding training state")
        state2, pipe2 = fresh(cfg, model, optimizer, device, seed=123,
                              batch=batch, seq=seq)           # wrong seed!
        target = {"params": state2.params, "opt_state": state2.opt_state,
                  "data": {"step": torch.zeros((), dtype=torch.int32,
                                               device=device)}}
        del state2
        # restore() stages (cheap no-op here — already staged) and reads
        # through a prefetching handle with parallel fan-out
        t0 = time.perf_counter()
        restored, ck = mgr.restore(target)
        info["restore_s"] = time.perf_counter() - t0
        info["dead"] = sorted(bb.manager.dead)
        del target
        print(f"[demo] restored step {ck} from staged burst-buffer chunks")
        state2 = TrainState(restored["params"], restored["opt_state"])
        pipe2.load_state_dict({"step": int(restored["data"]["step"]),
                               "seed": 42, "shard_id": 0, "num_shards": 1})
        del restored
        for _ in range(steps - ckpt_at):
            state2, _ = step_fn(state2, batch_to(next(pipe2), device))
    return ref, state2, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("h2o-danube-1.8b"))
    ref, state2, _ = restart_after_eviction(cfg, device)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state2.params), tree_leaves(ref.params)))
    print(f"[demo] continuation bit-exact vs uninterrupted run: {same}")
    assert same


if __name__ == "__main__":
    main()
