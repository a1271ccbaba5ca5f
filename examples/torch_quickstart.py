"""Quickstart on the PyTorch port: train a small LM with burst-buffer
checkpointing, then serve.

The counterpart of ``examples/quickstart.py`` over ``repro_torch``.
Checkpoints ride the BBFileSystem file-session API: ``bb.fs()`` opens
striped file handles over the burst buffer, every write returns a BBFuture,
and ``sync()``/``close()`` are the ingest barriers (failures raise there —
no error lists to poll). BBCheckpointManager uses the same handles
internally, and quantizes the optimizer moments to int8 on the device
before they leave it.

Runs on the GPU (``--device cuda``, the default) unless asked for the CPU,
where it takes about a minute:

  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import batch_to
from repro_torch.models.registry import build_model
from repro_torch.runtime.train_step import (init_train_state, make_optimizer,
                                            make_train_step)


def train_with_checkpoints(cfg, bb, device, *, steps, ckpt_every, batch, seq,
                           seed=0, state=None):
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens from the
    pipeline, saving an int8-moment checkpoint into ``bb`` after every
    ``ckpt_every``-th step (flushed to the PFS off the critical path), then
    wait for the flushes and print the checkpoint timings. ``state``: the
    train state to start from; by default one drawn from ``seed``.
    Returns (model, final state, the losses of every step, the manager)."""
    model = build_model(cfg)
    optimizer = make_optimizer(cfg, peak_lr=1e-3)
    if state is None:
        state = init_train_state(cfg, model, optimizer, seed, device)
    step_fn = make_train_step(cfg, model, optimizer, accum_steps=1)
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch).start_prefetch()
    mgr = BBCheckpointManager(bb, quantize=True)
    losses = []
    try:
        for step in range(steps):
            state, metrics = step_fn(state, batch_to(next(pipe), device))
            losses.append(float(metrics["loss"]))
            if step % ckpt_every == ckpt_every - 1:
                ckpt = {"params": state.params,
                        "opt_state": state.opt_state,
                        "data": {"step": torch.tensor(
                            pipe.step, dtype=torch.int32, device=device)}}
                dt = mgr.save(step, ckpt)
                print(f"step {step:3d} loss {losses[-1]:.4f}  "
                      f"[ckpt ingest {dt * 1e3:.0f} ms, flush async]")
            else:
                print(f"step {step:3d} loss {losses[-1]:.4f}")
    finally:
        pipe.stop_prefetch()
    mgr.wait_flushes()
    print("checkpoint timings:", {k: f"{v['ingest_s']*1e3:.0f}ms ingest/"
                                     f"{v.get('flush_s', 0)*1e3:.0f}ms flush"
                                  for k, v in sorted(mgr.metrics.items())})
    return model, state, losses, mgr


def buffer_report(cfg, bb, mgr, steps):
    """The control-plane view: where the latest checkpoint's bytes sit and
    the cluster pressure the QoS engine acts on; then a run manifest
    written next to the checkpoints and read back through the buffer, and
    the buffered files. Prints each and returns {"residency", "manifest",
    "listdir"}."""
    fs = bb.fs()
    last = max(mgr.metrics)
    st = fs.stat(f"ckpt_{last:08d}")
    print(f"ckpt_{last:08d} residency:",
          {t: f"{n/1e6:.1f} MB" for t, n in st["residency"].items()},
          f"({st['evicted_chunks']} chunks evicted to PFS)")
    pr = bb.pressure()
    q = pr["qos"]
    print("cluster pressure:",
          f"occupancy max {q['max_occupancy']:.2f} / "
          f"mean {q['mean_occupancy']:.2f},",
          f"ingest {q['aggregate_ingest_bps']/1e6:.0f} MB/s,",
          f"{q['draining']} draining;",
          f"drain epochs {pr['drain']['epochs']}"
          f" ({pr['drain']['drained_bytes']/1e6:.1f} MB drained),",
          f"stage epochs {pr['stage']['epochs']}")

    with fs.open("run_info.txt", "w", policy="batched") as f:
        f.write(f"arch={cfg.name} steps={steps} ckpts="
                f"{sorted(mgr.metrics)}\n".encode())
    with fs.open("run_info.txt", "r") as f:
        manifest = f.read().decode().strip()
    print("run manifest (via burst buffer):", manifest)
    names = fs.listdir()
    print("buffered files:", names)
    return {"residency": st["residency"], "manifest": manifest,
            "listdir": names}


def greedy_serve(cfg, model, params, prompts, *, new_tokens=8, max_seq=None):
    """Prefill ``prompts`` (B, S) and decode greedily: the prefill's token
    and ``new_tokens`` more, (B, new_tokens + 1) int32. ``max_seq``: the
    cache's length (by default S + new_tokens)."""
    return serve_batch(cfg, model, params, prompts,
                       gen_tokens=new_tokens + 1, max_seq=max_seq)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("gemma3-4b"), d_model=128, vocab=512)
    print(f"== training {cfg.name} ({cfg.num_layers} layers, "
          f"d={cfg.d_model}) with async burst-buffer checkpoints ==")
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=128 << 20)) as bb:
        model, state, _, mgr = train_with_checkpoints(
            cfg, bb, device, steps=20, ckpt_every=5, batch=8, seq=64)
        buffer_report(cfg, bb, mgr, steps=20)

    print("== greedy decode from the trained model ==")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    prompts = torch.randint(1, cfg.vocab_size, (2, 16), generator=gen,
                            device=device)
    out = greedy_serve(cfg, model, state.params, prompts, new_tokens=8,
                       max_seq=96)
    print("generated tokens:", out.tolist())


if __name__ == "__main__":
    main()
