"""Time variants of the bf16 tensor-core flash backward on one CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.tune_flash_bwd \
        [--head-dim 80|128|256]

``csrc/flash_attention_bwd.cu`` fixes its tiles in ``MmaBwdPlan``. This script
builds copies of that source with one plan constant changed (the dk / dv
kernel's q step and how many queries of scores it forms at once, the dq
kernel's key tile and blocks an SM) or with the library's ``expf`` in place
of ``ex2.approx``, prints the registers and spills of each instance at the
head dim asked for, and holds each against the committed kernels at that
head dim's training shape (``SHAPES``: D = 128, the default, starcoder2-3b's
B=8, S=2048, H=24, KV=2; D = 80, h2o-danube-1.8b's B=8, S=2048, H=32, KV=8,
window 4096; D = 256, recurrentgemma-9b's B=8, S=2048, H=16, KV=1, window
2048; bf16, causal): bit for bit where only the tiles change, within one
bf16 ulp of the plain backward for ``expf``. A tile variant is built only
for the head dims whose plan it changes (``HEAD_DIMS``).
Two probes compute wrong gradients on purpose (no exp; no "lo" half of the
split products of P and dS) to show what the per-element work and the split
cost; they are timed only. Times: CUDA events over 10 calls, three rounds in
alternating order, then each kernel's device time from the profiler. The
card's name and power limit come first. It needs nvcc and a card, and stops
at the first mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa

# head dim -> (B, S, H, KV, window), causal
SHAPES = {128: (8, 2048, 24, 2, 0), 80: (8, 2048, 32, 8, 4096),
          256: (8, 2048, 16, 1, 2048)}
TOL = 8e-3                             # one bf16 ulp, as chip_smoke.py holds it
KV_BQ = "static constexpr int KV_BQ = D > 128 ? 16 : 64;"
KV_QS = "static constexpr int KV_QS = D == 128 ? 16 : KV_BQ;"
Q_BK = "static constexpr int Q_BK = D > 128 ? 16 : D >= 80 ? 32 : 64;"
Q_BLOCKS = "static constexpr int Q_BLOCKS = D > 128 ? 2 : D >= 80 ? 3 : 2;"
EX2 = "p = keep ? ex2(fmaf(x, LOG2E, -rm)) * rli : 0.f;"
LO_PRODUCTS = [f"mma_bf16({acc}[2 * dp2{j}], {lo}[kk], bf[{b0}], bf[{b1}]);"
               for acc, lo in (("adv", "pl"), ("adk", "sl"), ("acc", "sl"))
               for j, b0, b1 in (("", 0, 1), (" + 1", 2, 3))]
# name -> (substitutions, how the result is held: "bits", "tol" or None)
VARIANTS = {
    "q step 32": ({KV_BQ: KV_BQ.replace("64", "32")}, "bits"),
    "q step 16": ({KV_BQ: KV_BQ.replace("64", "16")}, "bits"),
    "scores of a whole q step at once": (
        {KV_QS: "static constexpr int KV_QS = KV_BQ;"}, "bits"),
    "scores 32 queries at a time": (
        {KV_QS: "static constexpr int KV_QS = D > 128 ? KV_BQ : 32;"},
        "bits"),
    "scores 16 queries at a time": (
        {KV_QS: "static constexpr int KV_QS = 16;"}, "bits"),
    "dq 64-key tiles, 2 blocks an SM": (
        {Q_BK: Q_BK.replace("32", "64"),
         Q_BLOCKS: Q_BLOCKS.replace("3", "2")}, "bits"),
    "dq 2 blocks an SM": ({Q_BLOCKS: Q_BLOCKS.replace("3", "2")}, "bits"),
    # D = 256: a 32-row q step (1 block an SM: 135,936 bytes), its scores
    # 32 or 16 queries at a time; dq 32-key tiles (1 block: 135,168 bytes)
    "d256 q step 32": ({KV_BQ: KV_BQ.replace("16", "32")}, "bits"),
    "d256 q step 32, scores 16 queries at a time": (
        {KV_BQ: KV_BQ.replace("16", "32"),
         KV_QS: "static constexpr int KV_QS = D >= 128 ? 16 : KV_BQ;"},
        "bits"),
    "d256 dq 32-key tiles, 1 block an SM": (
        {Q_BK: Q_BK.replace("? 16", "? 32"),
         Q_BLOCKS: Q_BLOCKS.replace("? 2 :", "? 1 :")}, "bits"),
    "expf (and m not scaled by log2 e)": (
        {EX2: "p = keep ? expf(x - rm) * rli : 0.f;",
         "rv[tid] = nok ? nm * LOG2E : 0.f;": "rv[tid] = nok ? nm : 0.f;",
         "rm[u] = m[r] * LOG2E;": "rm[u] = m[r];"}, "tol"),
    "probe: no exp": ({EX2: "p = keep ? x * rli : 0.f;"}, None),
    "probe: no lo products": ({line: "" for line in LO_PRODUCTS}, None),
}
# the head dims whose plan a tile variant changes (the others: every one)
HEAD_DIMS = {name: (256,) if name.startswith("d256") else (80, 128)
             for name, (_, check) in VARIANTS.items() if check == "bits"}


def _build(d):
    """{name: C entry point} of every variant, built in parallel; prints
    the head dim ``d`` instances' registers and spills."""
    out = build.BUILD_DIR / "tune_flash_bwd"
    out.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        if d not in HEAD_DIMS.get(name, (d,)):
            continue
        src = text
        for old, new in subs.items():
            if old not in src:
                sys.exit(f"tune_flash_bwd: {name}: {old!r} not in the source")
            src = src.replace(old, new)
        cu, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {"committed": fa._bwd_kernel()}
    logs = {"committed": build.build_logs()["flash_attention_bwd"]}
    for name, (proc, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"tune_flash_bwd: {name}: nvcc failed\n{logs[name]}")
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd
        fn.argtypes, fn.restype = fns["committed"].argtypes, ctypes.c_int
        fns[name] = fn
    for name, log in logs.items():
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*?(flash_bwd_mma_\w+"
                          rf"_kernel)ILi{d}E", line)
            if m or "Compiling entry function" in line:
                entry = m.group(1) if m else None
            elif entry and ("registers" in line or "spill" in line):
                print(f"[ptxas] {name}: {entry}<{d}>: {line.strip()}",
                      flush=True)
    return fns


def _events_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--head-dim", type=int, default=128,
                    choices=sorted(SHAPES))
    d = ap.parse_args(argv).head_dim
    if not torch.cuda.is_available():
        sys.exit("tune_flash_bwd: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    fns = _build(d)
    b, s, h, kvh, window = SHAPES[d]
    print(f"shape (B, S, H, KV, D) = {(b, s, h, kvh, d)}, bf16, causal, "
          f"window {window}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(b, s, h, d), mk(b, s, kvh, d), mk(b, s, kvh, d), \
        mk(b, s, h, d)
    o, m, l = fa.flash_attention(q, k, v, window=window, return_stats=True)
    delta = torch.empty((b, s, h), dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(t) for t in (q, k, v)]

    def launch(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                 *(g.data_ptr() for g in grads), b, s, s, h, kvh, d, 1, 1,
                 window, 0.0, float(d ** -0.5), 0, build.stream_ptr(q))
        build.check(err, "flash_attention_bwd")

    plain = ops.flash_bwd_chunked(q, k, v, o, m, l, do, window=window)
    launch(fns["committed"])
    want = [g.clone() for g in grads]
    for name, fn in fns.items():
        check = VARIANTS.get(name, (None, "tol"))[1]
        launch(fn)
        torch.cuda.synchronize()
        if check == "bits" and not all(map(torch.equal, grads, want)):
            sys.exit(f"tune_flash_bwd: {name} differs from the committed "
                     f"kernels")
        if check == "tol":
            worst = max((((g.float() - p.float()).abs()
                          / (TOL + TOL * p.float().abs())).max().item())
                        for g, p in zip(grads, plain))
            print(f"{name}: worst element {worst:.3f} of the bound "
                  f"(atol = rtol = {TOL:g})", flush=True)
            if worst > 1.0:
                sys.exit(f"tune_flash_bwd: {name} leaves the bound")
    times = {name: [] for name in fns}
    for r in range(3):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(_events_ms(lambda: launch(fns[name])))
    from torch.profiler import ProfilerActivity, profile
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                launch(fn)
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            found = re.search(r"(flash_bwd_\w+_kernel)", e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA and found:
                split[found.group(1)] = split.get(found.group(1), 0.0) \
                    + e.time_range.elapsed_us() / 3e3
        print(f"{name}: " + ", ".join(f"{t:.4f}" for t in times[name])
              + " ms by events; device " + "; ".join(
                  f"{kn} {ms:.4f} ms" for kn, ms in sorted(split.items())),
              flush=True)


if __name__ == "__main__":
    main()
