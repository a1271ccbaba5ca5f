"""Time the RG-LRU kernels' tile choices on one CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.tune_rg_lru
    PYTHONPATH=src python -m repro_torch.kernels.tune_rg_lru --bwd

``csrc/rg_lru.cu`` compiles its ring kernel for one time tile and ring
depth (``TILE_S``, ``STAGES``). This script builds the same source once more
with bf16 instances for other (tile, stages) pairs, each with aligned and
with shifted rows, checks each bit for bit against the plain version at the
recurrentgemma-9b prefill shape (B=4, S=3072, D=4096, bf16) and prints its
time: CUDA events over 50 calls, and the device time of one call from a
CUDA graph of 20, against the bytes bound. The pairs run twice, in opposite
orders. Then the wrapper's own kernels: at that shape, at D = 4100 (bf16
rows off 16-byte boundaries, so shifted rows), and the step kernel launched
at both. The card's name and power limit come first. It needs nvcc and a
card, and stops at the first mismatch.

``--bwd`` does the same for the backward's ring kernel (``BWD_TILE_S``,
``BWD_STAGES``): every time tile of 16, 32 and 64 steps in rings of 3, 4
and 6 stages, each held bit for bit against the plain backward from the
plain forward's f32 carry. At recurrentgemma-9b's training shape (B=2,
S=4096, D=4096, bf16) the variants run twice, in opposite orders; then
once each at the prefill shape (4, 3072, 4096) and at (2, 4096, 4100),
whose bf16 rows sit off 16-byte boundaries (shifted rows); then the
wrapper's backward and the forward with its carry at the training shape.
The fastest variant at the training shape by device time comes last.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import build, ref, rg_lru

PAIRS = ((16, 4), (16, 6), (16, 8), (32, 2), (32, 3), (32, 4), (32, 6),
         (64, 2), (64, 3), (64, 4), (64, 6), (128, 2), (128, 3))
SHAPE = (4, 3072, 4096)
BWD_TILES, BWD_DEPTHS = (16, 32, 64), (3, 4, 6)
BWD_VARIANTS = tuple((t, st) for t in BWD_TILES for st in BWD_DEPTHS)
TRAIN_SHAPE = (2, 4096, 4096)
BWD_SHAPES = (TRAIN_SHAPE, (4, 3072, 4096), (2, 4096, 4100))
HBM_BPS = 3.35e12          # H100 SXM data sheet


def _source() -> str:
    cases = "\n".join(
        f"  if (ts == {t} && st == {s})\n"
        f"    return aligned ? launch_ring<bf16, true, {t}, {s}>("
        f"a, gx, h0, h, hl, nullptr, B, S, D, stream)\n"
        f"                   : launch_ring<bf16, false, {t}, {s}>("
        f"a, gx, h0, h, hl, nullptr, B, S, D, stream);" for t, s in PAIRS)
    return (f'#include "{build.CSRC / "rg_lru.cu"}"\n\n'
            'extern "C" int tile_fwd(const void* a, const void* gx, '
            'const void* h0, void* h, void* hl, int B, int S, int D, '
            'int ts, int st, int aligned, void* s) {\n'
            '  cudaStream_t stream = static_cast<cudaStream_t>(s);\n'
            f'{cases}\n  return -1;\n}}\n')


def _bwd_source() -> str:
    cases = "\n".join(
        f"  if (ts == {t} && st == {s})\n"
        f"    return aligned ? launch_bwd_ring<bf16, true, {t}, {s}>("
        f"a, h32, nullptr, dh, nullptr, da, dgx, nullptr, B, S, D, stream)\n"
        f"                   : launch_bwd_ring<bf16, false, {t}, {s}>("
        f"a, h32, nullptr, dh, nullptr, da, dgx, nullptr, B, S, D, stream);"
        for t, s in BWD_VARIANTS)
    return (f'#include "{build.CSRC / "rg_lru.cu"}"\n\n'
            'extern "C" int tile_bwd(const void* a, const void* h32, '
            'const void* dh, void* da, void* dgx, int B, int S, int D, '
            'int ts, int st, int aligned, void* s) {\n'
            '  cudaStream_t stream = static_cast<cudaStream_t>(s);\n'
            f'{cases}\n  return -1;\n}}\n')


def _compile(name, source, symbol, argtypes):
    out = build.BUILD_DIR / "tune_rg_lru"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(source)
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    # the -Xptxas -v report (registers, spills) beside the library
    (out / f"{name}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _tile_kernels():
    return _compile("tiles", _source(), "tile_fwd",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])


def _events_ms(fn, iters=50, warmup=3) -> float:
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


def _device_ms(fn, calls=20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _events_ms(graph.replay, iters=10, warmup=2) / calls


def _inputs(b, s, d, gen):
    """The prefill's inputs: a in (0.7, 1), gx small normals, zero h0."""
    a = (0.7 + 0.299 * torch.rand((b, s, d), generator=gen,
                                  device="cuda")).to(torch.bfloat16)
    gx = (0.1 * torch.randn((b, s, d), generator=gen,
                            device="cuda")).to(torch.bfloat16)
    return a, gx, torch.zeros((b, d), dtype=torch.bfloat16, device="cuda")


def _report(name, launch, outputs, want, bound_ms):
    """Run once and hold the outputs bit for bit, then time ``launch``;
    returns its device ms."""
    for x in outputs():
        x.zero_()
    launch()
    torch.cuda.synchronize()
    if not all(torch.equal(x, w) for x, w in zip(outputs(), want)):
        sys.exit(f"tune_rg_lru: {name} differs from the plain version")
    dev = _device_ms(launch)
    print(f"{name}: {_events_ms(launch):.5f} ms by events, {dev:.5f} ms "
          f"device, {bound_ms / dev:.3f} of the {bound_ms:.5f} ms bound",
          flush=True)
    return dev


def _step_launch(a, gx, h0, h, h_last):
    """The step kernel at a's shape, whatever S (the C entry point takes
    the step plan at any S)."""
    b, s, d = a.shape
    plan = rg_lru.launch_plan(b, 1, d, a.dtype)
    fn = rg_lru._kernel()

    def launch():
        err = fn(a.data_ptr(), gx.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), None, b, s, d, 1, 0, plan.tile_s,
                 plan.tile_d,
                 plan.stages, 1, plan.grid[0], plan.smem,
                 build.stream_ptr(a))
        build.check(err, "rg_lru_fwd (step)")
    return launch


def _report_bwd(tiles, name, a, h32, dh, want, bound_ms, ts, st, aligned):
    """One ring variant held bit for bit and timed; its device ms."""
    b, s, d = a.shape
    da, dgx = torch.empty_like(a), torch.empty_like(a)

    def launch():
        err = tiles(a.data_ptr(), h32.data_ptr(), dh.data_ptr(),
                    da.data_ptr(), dgx.data_ptr(), b, s, d, ts, st, aligned,
                    build.stream_ptr(a))
        build.check(err, "tile_bwd")
    return _report(name, launch, lambda: (da, dgx), want, bound_ms)


def tune_bwd(gen):
    """The backward ring's (tile, stages) variants at BWD_SHAPES against
    the bytes bound (a and dh read in bf16, the carry in f32, da and dgx
    written: 12 bytes an element), then the wrapper's backward and the
    forward with its carry (10 bytes an element)."""
    tiles = _compile("bwd", _bwd_source(), "tile_bwd",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    times = {}
    for b, s, d in BWD_SHAPES:
        a, gx, _ = _inputs(b, s, d, gen)
        dh = torch.randn(a.shape, generator=gen, device="cuda").to(a.dtype)
        want_fwd = ref.rg_lru(a, gx, None, return_carry=True)
        h32 = want_fwd[2]
        want = ref.rg_lru_bwd(a, h32, dh)[:2]
        n = a.numel()
        bound_ms = 12 * n / HBM_BPS * 1e3
        aligned = int(d * a.element_size() % 16 == 0)
        print(f"(B, S, D) = {(b, s, d)} bf16, backward: the wrapper's plan "
              f"{rg_lru.bwd_launch_plan(b, s, d, a.dtype)}", flush=True)
        order = BWD_VARIANTS + (BWD_VARIANTS[::-1] if (b, s, d) ==
                                TRAIN_SHAPE else ())
        for ts, st in order:
            dev = _report_bwd(
                tiles, f"  ring {ts} x {st}, "
                f"{'aligned' if aligned else 'shifted'} rows", a, h32, dh,
                want, bound_ms, ts, st, aligned)
            if (b, s, d) == TRAIN_SHAPE:
                times.setdefault((ts, st), []).append(dev)
        if (b, s, d) != TRAIN_SHAPE:
            continue
        da, dgx = torch.empty_like(a), torch.empty_like(a)
        last = {"out": (da, dgx)}

        def wrapper():
            last["out"] = rg_lru.rg_lru_bwd(a, h32, dh)[:2]
        _report("  the wrapper's backward", wrapper, lambda: last["out"],
                want, bound_ms)

        def forward():
            last["fwd"] = rg_lru.rg_lru(a, gx, None, return_carry=True)
        last["fwd"] = tuple(torch.empty_like(x) for x in want_fwd)
        _report("  the forward with its carry", forward,
                lambda: last["fwd"], want_fwd,
                (10 * n + 2 * b * d) / HBM_BPS * 1e3)
        del da, dgx, last
        del a, gx, dh, want_fwd, h32, want
    best = min(times, key=lambda k: max(times[k]))
    print(f"fastest at {TRAIN_SHAPE} by the slower of its two device times: "
          f"ring {best[0]} x {best[1]}: "
          f"{', '.join(f'{t:.5f}' for t in times[best])} ms", flush=True)


def main(argv=None):
    args = argparse.ArgumentParser()
    args.add_argument("--bwd", action="store_true")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tune_rg_lru: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.bwd:
        tune_bwd(gen)
        return
    tiles = _tile_kernels()
    for b, s, d in (SHAPE, SHAPE[:2] + (4100,)):
        a, gx, h0 = _inputs(b, s, d, gen)
        want = ref.rg_lru(a, gx, h0)
        bound_ms = 2 * (3 * a.numel() + 2 * b * d) / HBM_BPS * 1e3
        h, h_last = torch.empty_like(a), torch.empty_like(h0)
        print(f"(B, S, D) = {(b, s, d)} bf16: the wrapper's plan "
              f"{rg_lru.launch_plan(b, s, d, a.dtype)}", flush=True)
        if (b, s, d) == SHAPE:
            for ts, st in PAIRS + PAIRS[::-1]:
                for aligned in (1, 0):
                    def launch(ts=ts, st=st, aligned=aligned):
                        err = tiles(a.data_ptr(), gx.data_ptr(),
                                    h0.data_ptr(), h.data_ptr(),
                                    h_last.data_ptr(), b, s, d, ts, st,
                                    aligned, build.stream_ptr(a))
                        build.check(err, "tile_fwd")
                    _report(f"  ring {ts} x {st}, "
                            f"{'aligned' if aligned else 'shifted'} rows",
                            launch, lambda: (h, h_last), want, bound_ms)
        last = {"out": (h, h_last)}

        def wrapper():
            last["out"] = rg_lru.rg_lru(a, gx, h0)
        _report("  the wrapper", wrapper, lambda: last["out"], want,
                bound_ms)
        _report("  the step kernel", _step_launch(a, gx, h0, h, h_last),
                lambda: (h, h_last), want, bound_ms)
        del a, gx, h0, h, h_last, want, last


if __name__ == "__main__":
    main()
