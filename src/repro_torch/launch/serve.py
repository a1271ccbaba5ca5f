"""Batched serving driver: prefill + decode loop with a request queue.

Counterpart of ``repro/launch/serve.py``. Requests are batched up to
--batch; each batch is prefilled and decoded greedily for --gen tokens.
Model weights can be restored from the burst buffer (serving restarts read
hot weights from server DRAM instead of the PFS — the paper's restart path
applied to inference). Runs on the GPU (``--device cuda``, the default)
unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_step import (greedy_token, make_decode_step,
                                            make_prefill)


@torch.inference_mode()
def serve_batch(cfg, model, params, prompts, *, gen_tokens=16, max_seq=None,
                enc_input=None):
    """prompts: (B, S) int tensor -> generated (B, gen_tokens) int32.
    enc_input: (B, S_enc, encoder_dim) frames or patches for configs with
    cross layers, encoded once, at the prefill.

    The reference donates the decode cache to its jitted step; here the
    cache is allocated once per batch and updated in place.
    """
    b, s = prompts.shape
    max_seq = max_seq or (s + gen_tokens)
    cache = model.init_cache(b, max_seq, device=prompts.device)
    prefill = make_prefill(cfg, model)
    decode = make_decode_step(cfg, model)

    logits, cache = prefill(params, cache, prompts, enc_input)
    tok = greedy_token(cfg, logits)
    out = [tok]
    pos = s
    for _ in range(gen_tokens - 1):
        logits, cache = decode(params, cache, tok, pos)
        tok = greedy_token(cfg, logits)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    params = model.init(0, device=device)
    rng = np.random.default_rng(0)

    enc = None
    if cfg.encoder_seq:
        enc = torch.as_tensor(rng.normal(
            0, 1, (args.batch, cfg.encoder_seq, cfg.encoder_dim)),
            dtype=torch.float32, device=device)

    for r in range(args.requests):
        prompts = torch.as_tensor(rng.integers(
            1, cfg.vocab_size, (args.batch, args.prompt_len)),
            dtype=torch.int64, device=device)
        t0 = time.perf_counter()
        toks = serve_batch(cfg, model, params, prompts, gen_tokens=args.gen,
                           enc_input=enc)
        toks = toks.cpu()           # waits for the device
        dt = time.perf_counter() - t0
        print(f"[serve] request-batch {r}: {tuple(toks.shape)} in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s) "
              f"sample={toks[0, :8].tolist()}")


if __name__ == "__main__":
    main()
