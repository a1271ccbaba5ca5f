"""Time the RG-LRU ring kernel's tile choices on one CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.tune_rg_lru

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
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import build, ref, rg_lru

PAIRS = ((16, 4), (16, 6), (16, 8), (32, 2), (32, 3), (32, 4), (32, 6),
         (64, 2), (64, 3), (64, 4), (64, 6), (128, 2), (128, 3))
SHAPE = (4, 3072, 4096)
HBM_BPS = 3.35e12          # H100 SXM data sheet


def _source() -> str:
    cases = "\n".join(
        f"  if (ts == {t} && st == {s})\n"
        f"    return aligned ? launch_ring<bf16, true, {t}, {s}>("
        f"a, gx, h0, h, hl, B, S, D, stream)\n"
        f"                   : launch_ring<bf16, false, {t}, {s}>("
        f"a, gx, h0, h, hl, B, S, D, stream);" for t, s in PAIRS)
    return (f'#include "{build.CSRC / "rg_lru.cu"}"\n\n'
            'extern "C" int tile_fwd(const void* a, const void* gx, '
            'const void* h0, void* h, void* hl, int B, int S, int D, '
            'int ts, int st, int aligned, void* s) {\n'
            '  cudaStream_t stream = static_cast<cudaStream_t>(s);\n'
            f'{cases}\n  return -1;\n}}\n')


def _tile_kernels():
    out = build.BUILD_DIR / "tune_rg_lru"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "tiles.cu", out / "libtiles.so"
    src.write_text(_source())
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib)).tile_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    """Run once and hold the outputs bit for bit, then time ``launch``."""
    for x in outputs():
        x.zero_()
    launch()
    torch.cuda.synchronize()
    h, h_last = outputs()
    if not (torch.equal(h, want[0]) and torch.equal(h_last, want[1])):
        sys.exit(f"tune_rg_lru: {name} differs from the plain version")
    dev = _device_ms(launch)
    print(f"{name}: {_events_ms(launch):.5f} ms by events, {dev:.5f} ms "
          f"device, {bound_ms / dev:.3f} of the {bound_ms:.5f} ms bound",
          flush=True)


def _step_launch(a, gx, h0, h, h_last):
    """The step kernel at a's shape, whatever S (the C entry point takes
    the step plan at any S)."""
    b, s, d = a.shape
    plan = rg_lru.launch_plan(b, 1, d, a.dtype)
    fn = rg_lru._kernel()

    def launch():
        err = fn(a.data_ptr(), gx.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), b, s, d, 1, 0, plan.tile_s, plan.tile_d,
                 plan.stages, 1, plan.grid[0], plan.smem,
                 build.stream_ptr(a))
        build.check(err, "rg_lru_fwd (step)")
    return launch


def main():
    if not torch.cuda.is_available():
        sys.exit("tune_rg_lru: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
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
