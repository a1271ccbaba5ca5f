"""End-to-end driver on the PyTorch port: train a ~100M-param LM with
burst-buffer checkpoints.

The counterpart of ``examples/train_lm.py`` over ``repro_torch``. Default
config is a 12L/768d GPT-small-class model (~110M params); --preset tiny
runs the same code path at toy scale. Runs on the GPU (``--device cuda``,
the default) unless asked for the CPU:

  PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 30 \\
      --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # ~100M model
"""
import argparse
import dataclasses

from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.launch.train import train_loop
from repro_torch.models.registry import count_params


def config_100m() -> ModelConfig:
    base = get_config("starcoder2-3b")
    return dataclasses.replace(
        base, name="lm-110m", d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=3072, vocab_size=32768,
        segments=((("attn",), 12),),
        param_dtype="float32", compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("100m", "tiny"), default="100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.preset == "tiny":
        cfg = reduced(config_100m())
        args.seq = min(args.seq, 64)
        args.ckpt_every = min(args.ckpt_every, 10)
    else:
        cfg = config_100m()

    print(f"[train_lm] {cfg.name}: {count_params(cfg)/1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")
    state, history, mgr = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_every=args.ckpt_every, quantize_ckpt=True, log_every=10,
        device=args.device)
    print("[train_lm] loss trajectory:",
          [f"{s}:{l:.3f}" for s, l in history])
    return state, history, mgr


if __name__ == "__main__":
    main()
