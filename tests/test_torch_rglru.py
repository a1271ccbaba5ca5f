"""The port's RG-LRU path against the reference's on the same numpy inputs:
the plain scan against the JAX oracle, the Pallas kernel (interpret mode)
and the associative scan the reference's model runs on the CPU (and a torch
copy of that scan, kept here as a test helper); the CUDA kernels' launch
plan (which kernel, tiles, grid, shared memory) at every shape
``chip_smoke.py`` launches; the recurrent block on reduced
recurrentgemma-9b; and the serving CLI. The CUDA kernels themselves are
held against the plain version on the card by ``chip_smoke.py``."""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rg_lru import rg_lru_pallas
from repro.models import rglru as jrglru
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as rg_lru_kernel
from repro_torch.launch import serve
from repro_torch.models import rglru

# (B, S, D, Pallas (block_s, block_d), h0 given, dtype): the reference's
# shapes (tests/test_kernels.py), a ragged S = 300 (the CUDA kernel has no
# S % block_s restriction; the Pallas kernel is given blocks of 60), no h0,
# bf16 in and out, and the decode shape S = 1 with h0
CASES = [
    (2, 256, 128, (128, 128), True, "float32"),
    (1, 512, 256, (256, 128), True, "float32"),
    (3, 128, 384, (64, 128), True, "float32"),
    (2, 300, 384, (60, 128), False, "float32"),
    (2, 300, 384, (60, 128), True, "bfloat16"),
    (2, 64, 128, (64, 128), False, "bfloat16"),
    (4, 1, 256, (1, 128), True, "float32"),
    (4, 1, 256, (1, 128), True, "bfloat16"),
]
# f32: XLA on the CPU contracts each step of the JAX oracle and of the
# Pallas kernel into a fused multiply-add, the port rounds the product
# first (as the CUDA kernel does), so the sequential versions differ by an
# ulp a step (measured max 1.8e-7 here), held to 1e-6; the log-depth scans
# reassociate the products, which the reference's own test bounds by 1e-5.
# bf16: the f32 carries agree, so the outputs differ by at most one bf16
# rounding step (2^-8 relative; measured 4.9e-4 absolute).
TOL = {"float32": {"sequential": 1e-6, "assoc": 1e-5},
       "bfloat16": {"sequential": 2.0 ** -8, "assoc": 2.0 ** -8}}


def _inputs(b, s, d, with_h0, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (b, s, d)).astype(np.float32)
    gx = (rng.normal(size=(b, s, d)) * 0.1).astype(np.float32)
    h0 = (rng.normal(size=(b, d)) * 0.1).astype(np.float32) \
        if with_h0 else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [None if x is None else jnp.asarray(x, jd) for x in (a, gx, h0)]
    t = [None if x is None else torch.from_numpy(x).to(td)
         for x in (a, gx, h0)]
    return j, t


def _rg_lru_assoc(a, gx, h0=None):
    """The recurrence as an O(log S) scan over the pairs (a, h) with
    ``(a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2)``, in f32: a torch copy of
    the reference's CPU path ``repro/kernels/ops.py::_rg_lru_assoc`` (a
    Hillis-Steele scan here, so it rounds differently from both the
    reference's and the sequential version)."""
    af, gf = a.float(), gx.float()
    if h0 is not None:
        # fold h0 into the first element: h_1 = a_1 * h0 + gx_1
        gf = gf.clone()
        gf[:, 0] += af[:, 0] * h0.float()
    s, k = a.shape[1], 1
    while k < s:
        gf = torch.cat([gf[:, :k], gf[:, :-k] * af[:, k:] + gf[:, k:]], 1)
        af = torch.cat([af[:, :k], af[:, :-k] * af[:, k:]], 1)
        k *= 2
    return gf.to(a.dtype), gf[:, -1].to(a.dtype)


def _close(out, exp, tol):
    out = out.float().numpy()
    exp = np.asarray(exp, np.float32)
    if tol == 0.0:
        np.testing.assert_array_equal(out, exp)
    else:
        np.testing.assert_allclose(out, exp, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
def test_plain_rg_lru_matches_reference(case):
    """The port's CPU path (``ops.rg_lru`` -> the sequential plain version)
    against the JAX oracle, the Pallas kernel and the associative scan."""
    b, s, d, (bs, bd), with_h0, dtype = case
    (aj, gj, hj), (at, gt, ht) = _inputs(b, s, d, with_h0, dtype)
    h, h_last = ops.rg_lru(at, gt, ht)
    assert h.dtype == at.dtype and h.shape == (b, s, d)
    assert h_last.dtype == at.dtype and h_last.shape == (b, d)
    tol = TOL[dtype]
    for name, (eh, el) in {
            "sequential": jref.rg_lru(aj, gj, hj),
            "pallas": rg_lru_pallas(aj, gj, hj, block_s=bs, block_d=bd,
                                    interpret=True),
            "assoc": jops._rg_lru_assoc(aj, gj, hj)}.items():
        t = tol["assoc" if name == "assoc" else "sequential"]
        _close(h, eh, t)
        _close(h_last, el, t)


@pytest.mark.parametrize("case", CASES)
def test_port_assoc_scan_matches_reference(case):
    """A torch copy of the reference's CPU scan against the reference's and
    against the port's sequential version: the log-depth and the sequential
    orders agree on torch's side as on JAX's."""
    b, s, d, _, with_h0, dtype = case
    (aj, gj, hj), (at, gt, ht) = _inputs(b, s, d, with_h0, dtype, seed=1)
    h, h_last = _rg_lru_assoc(at, gt, ht)
    assert h.dtype == at.dtype and h_last.shape == (b, d)
    eh, el = jops._rg_lru_assoc(aj, gj, hj)
    _close(h, eh, TOL[dtype]["assoc"])
    _close(h_last, el, TOL[dtype]["assoc"])
    sh, sl = ref.rg_lru(at, gt, ht)
    _close(h, sh.float().numpy(), TOL[dtype]["assoc"])
    _close(h_last, sl.float().numpy(), TOL[dtype]["assoc"])


def test_rg_lru_dispatch_on_cpu_is_the_sequential_plain_version():
    _, (at, gt, ht) = _inputs(2, 33, 40, True, "float32", seed=2)
    h, h_last = ops.rg_lru(at, gt, ht)
    sh, sl = ref.rg_lru(at, gt, ht)
    assert torch.equal(h, sh) and torch.equal(h_last, sl)
    # a missing h0 is a zero h0
    h0, l0 = ops.rg_lru(at, gt)
    hz, lz = ops.rg_lru(at, gt, torch.zeros_like(ht))
    assert torch.equal(h0, hz) and torch.equal(l0, lz)


# ------------------------------------------------------ the launch plan

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# every (B, S, D, dtype, h0) chip_smoke.py holds the kernels to
SMOKE_CASES = _chip_smoke()._rg_lru_cases(rg_lru_kernel.TILE_S)
H100_SMS, H100_BLOCK_SMEM = 132, 232_448


def _computed(plan, b, s, d):
    """How often each (b, t, c) is computed, walking the grid and the time
    tiles as the kernels do."""
    done = np.zeros((b, s, d), np.uint8)
    assert plan.grid[1] == b
    for x in range(plan.grid[0]):
        c0 = x * plan.tile_d
        for t0 in range(0, s, plan.tile_s):
            t1 = min(s, t0 + plan.tile_s)
            done[:, t0:t1, c0:min(d, c0 + plan.tile_d)] += 1
    return done


def _ring_copies(plan, n, shift, size, row_bytes=rg_lru_kernel.ROW_BYTES):
    """The offsets (from the block's first channel) each 16-byte copy of
    one row brings in, for a block of n channels of ``size`` bytes whose
    row of ``row_bytes`` starts ``shift`` elements past a 16-byte boundary,
    as ``copy_rows`` picks them (a row read at a shift is copied as its
    aligned window, 16 bytes wider)."""
    vec = 16 // size
    chunks = row_bytes // 16 + (0 if plan.aligned else 1)
    return [range(j * vec - shift, (j + 1) * vec - shift)
            for j in range(chunks) if j * vec - shift < n]


@pytest.mark.parametrize("case", SMOKE_CASES, ids=str)
def test_launch_plan_covers_each_element_once(case):
    """Each (b, t, c) is computed once; in the ring, each of a row's
    channels is brought in by exactly one 16-byte copy and every copy holds
    one of them, at every shift a row can have; the block fits an H100 SM:
    shared memory within 227 KB, its size that of the ring's stages."""
    b, s, d, dtype, _ = case
    size = getattr(torch, dtype).itemsize
    vec = 16 // size
    for aligned in (True, False):
        plan = rg_lru_kernel.launch_plan(b, s, d, getattr(torch, dtype),
                                         aligned=aligned)
        assert (_computed(plan, b, s, d) == 1).all()
        assert (plan.grid[0] - 1) * plan.tile_d < d  # no block without work
        assert plan.tile_d <= 1024  # threads a block, one a channel
        assert 0 <= plan.smem <= H100_BLOCK_SMEM and plan.blocks_per_sm >= 1
        if plan.kernel == "step":
            assert plan.stages == plan.smem == 0
            continue
        assert plan.tile_d * size == rg_lru_kernel.ROW_BYTES
        assert plan.aligned == (aligned and d * size % 16 == 0)
        # rows (b, t) start (b S + t) d elements past an aligned base
        shifts = range(vec) if not plan.aligned else \
            np.unique(np.arange(b * s) * d % vec)
        assert plan.aligned <= (list(shifts) == [0])
        for n in {plan.tile_d, d - (plan.grid[0] - 1) * plan.tile_d}:
            for shift in shifts:
                copies = _ring_copies(plan, n, int(shift), size)
                got = np.concatenate([list(c) for c in copies])
                got = got[(got >= 0) & (got < n)]
                assert sorted(got) == list(range(n))
                assert all(c.start < n and c.stop > 0 for c in copies)
        chunks = rg_lru_kernel.ROW_BYTES // 16 + (0 if plan.aligned else 1)
        assert plan.smem == plan.stages * 2 * plan.tile_s * chunks * 16


def test_launch_plan_serving_prefill_fills_the_card_in_one_wave():
    plan = rg_lru_kernel.launch_plan(4, 3072, 4096, torch.bfloat16)
    assert plan.kernel == "ring" and plan.aligned
    assert plan.grid == (64, 4) and plan.tile_d == 64
    blocks = plan.grid[0] * plan.grid[1]
    # every SM busy, every block resident at once
    assert H100_SMS <= blocks <= H100_SMS * plan.blocks_per_sm
    assert plan.blocks_per_sm >= 2
    # the ring's tiles in flight ahead of the chain: >= 3 MB on the card
    ahead = (plan.stages - 1) * plan.smem // plan.stages
    assert blocks * ahead >= 3 << 20


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_dispatches_by_sequence_length(dtype):
    """Decode (S = 1) and anything shorter than one time tile take the
    step kernel; from one tile on, the ring."""
    tile = rg_lru_kernel.TILE_S
    for s, kernel in ((1, "step"), (2, "step"), (tile - 1, "step"),
                      (tile, "ring"), (tile + 1, "ring"), (3072, "ring")):
        assert rg_lru_kernel.launch_plan(4, s, 4096, dtype).kernel == kernel
    step = rg_lru_kernel.launch_plan(4, 1, 4096, dtype)
    assert step.grid == (16, 4) and step.tile_d == 256 and step.smem == 0


def test_launch_plan_matches_the_cuda_source_constants():
    """The plan's numbers are the compiled instances' (the C entry point
    refuses any other plan)."""
    src = (ROOT / "src/repro_torch/kernels/csrc/rg_lru.cu").read_text()
    for name in ("STEP_THREADS", "U", "ROW_BYTES", "TILE_S", "STAGES"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(rg_lru_kernel, name), name


# ------------------------------------------------------------ the block

ARCH = "recurrentgemma-9b"
# f32 at reduced width (d_model 64): the reference's block runs the
# associative scan on the CPU, the port the sequential one, and XLA's and
# torch's f32 matmuls round differently; measured max 9.5e-7 on outputs of
# order 1, held to 5e-6
BLOCK_TOL = 5e-6


def _block_pair():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jblock = jax.tree.map(lambda a: a[0],
                          jparams["segments"]["seg0"]["0"]["block"])
    block = params_from_numpy(jax.device_get(jblock), device="cpu")
    return jcfg, jblock, cfg, block


def test_apply_rglru_block_matches_reference():
    jcfg, jblock, cfg, block = _block_pair()
    x = np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    exp = jrglru.apply_rglru_block(jcfg, jblock, jnp.asarray(x))
    out = rglru.apply_rglru_block(cfg, block, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=BLOCK_TOL,
                               rtol=0)


def test_decode_rglru_block_matches_reference():
    """Prefill-style call over 20 tokens from a fresh cache, then three
    one-token steps: outputs and the carried state (h and the conv's
    trailing inputs) agree, and the port updates its cache in place."""
    jcfg, jblock, cfg, block = _block_pair()
    rng = np.random.default_rng(5)
    jcache = jrglru.init_rglru_cache(jcfg, 2)
    cache = rglru.init_rglru_cache(cfg, 2, device="cpu")
    h_buf = cache["h"]
    for s in (20, 1, 1, 1):
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        exp, jcache = jrglru.decode_rglru_block(jcfg, jblock, jnp.asarray(x),
                                                jcache)
        out, cache = rglru.decode_rglru_block(cfg, block,
                                              torch.from_numpy(x), cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(exp),
                                   atol=BLOCK_TOL, rtol=0)
        for k in ("h", "conv"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       atol=BLOCK_TOL, rtol=0)
    assert cache["h"] is h_buf


def test_serve_cli_runs_reduced_recurrentgemma_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "1", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] request-batch 0: (4, 4)" in out
