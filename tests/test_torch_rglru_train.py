"""Training through the port's RG-LRU scan against the reference, on the CPU:
the plain backward ``ref.rg_lru_bwd`` (the reverse scan the CUDA kernel
``rg_lru_bwd`` runs bit for bit on the card) against ``jax.vjp`` of the
reference's associative scan ``_rg_lru_assoc`` (what its model
differentiates on the CPU) and of its sequential oracle; the CPU Function
against autograd through the plain forward's loop; the backward kernel's
launch plan at every shape ``chip_smoke.py`` launches, and the wrappers'
refusals before any build; the loss in row chunks against autograd through
the whole tensors; then reduced recurrentgemma-9b: every leaf's
gradient, the loss, the grad norm and one AdamW step against the
reference's jitted ``jax.grad`` and ``make_train_step``, ``train_loop``
through a kill and a bit-exact restore, and the training CLI. Parameters
are built by the reference and carried into the port through the checkpoint
format."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.registry import build_model as jbuild_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.runtime import train_step as jts
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as rg_lru_kernel
from repro_torch.launch.train import batch_to
from repro_torch.models.common import map_tree, padded_vocab
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad import clip_by_global_norm
from repro_torch.optim.schedule import constant
from repro_torch.runtime.train_step import (TrainState, cross_entropy,
                                            make_train_step)
from test_torch_rglru import (CASES, ROOT, SMOKE_CASES, _computed, _inputs,
                              _ring_copies)
from test_torch_train_integration import _train_loop_kill_restore_bit_exact

# ------------------------------------------------------- the plain backward

# |port - reference| <= rtol |reference| + atol max|reference|, per element
# of da, dgx and dh0. f32: both sum in f32 in other orders (XLA contracts
# the sequential oracle's products into fused multiply-adds, the port
# rounds each product first); measured at most 1.4e-7 (assoc) and 8.5e-8
# (sequential) of the gradient's norm, and 1.9e-7 of its largest element
# per element; held to 1e-6. bf16: the f32 gradients agree that closely
# and each package rounds them to bf16 once, so an element may sit one
# bf16 ulp apart (2^-7 relative; measured 1.56e-2 on an element of ~4, and
# 2.7e-5 of the norm).
VJP_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2.0 ** -7, 1e-6)}
ORACLES = {"assoc": jops._rg_lru_assoc, "sequential": jref.rg_lru}


def _cotangents(b, s, d, dtype, with_dh_last, seed=7):
    rng = np.random.default_rng(seed)
    dh = rng.normal(size=(b, s, d)).astype(np.float32)
    dh_last = (rng.normal(size=(b, d)).astype(np.float32) if with_dh_last
               else np.zeros((b, d), np.float32))
    td = getattr(torch, dtype)
    return (dh, dh_last, torch.from_numpy(dh).to(td),
            torch.from_numpy(dh_last).to(td) if with_dh_last else None)


@pytest.mark.parametrize("oracle", sorted(ORACLES))
@pytest.mark.parametrize("with_dh_last", [True, False],
                         ids=["dh_last", "no_dh_last"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_reference_vjp(case, with_dh_last, oracle):
    """da, dgx (and dh0 with h0) of ``ref.rg_lru_bwd``, fed the plain
    forward's f32 carry, against ``jax.vjp`` of the reference's scan."""
    b, s, d, _, with_h0, dtype = case
    (aj, gj, hj), (at, gt, ht) = _inputs(b, s, d, with_h0, dtype, seed=3)
    dh, dh_last, dht, dlt = _cotangents(b, s, d, dtype, with_dh_last)
    _, _, h32 = ref.rg_lru(at, gt, ht, return_carry=True)
    assert h32.dtype == torch.float32 and h32.shape == (b, s, d)
    got = ref.rg_lru_bwd(at, h32, dht, dlt, ht)
    assert (got[2] is None) == (not with_h0)
    args = (aj, gj) + ((hj,) if with_h0 else ())
    _, vjp = jax.vjp(ORACLES[oracle], *args)
    jd = getattr(jnp, dtype)
    want = vjp((jnp.asarray(dh, jd), jnp.asarray(dh_last, jd)))
    rtol, atol = VJP_TOL[dtype]
    for name, g, w in zip(("da", "dgx", "dh0"), got, want):
        assert g.dtype == at.dtype, name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol * np.abs(w).max(), err_msg=name)


# (B, S, D, h0 given, dtype): CASES' features at S <= 64 (autograd through
# the loop slices a (B, S, D) gradient out of every step, so its cost
# grows as S^2): ragged S, h0 given or not, both dtypes, the decode's S = 1
LOOP_CASES = [(2, 64, 128, True, "float32"), (1, 48, 256, True, "float32"),
              (3, 33, 96, True, "float32"), (2, 37, 80, False, "float32"),
              (2, 37, 80, True, "bfloat16"), (2, 64, 128, False, "bfloat16"),
              (4, 1, 256, True, "float32"), (4, 1, 256, True, "bfloat16")]


@pytest.mark.parametrize("used", ["h", "h_last", "both"])
@pytest.mark.parametrize("case", LOOP_CASES, ids=str)
def test_cpu_function_equals_autograd_through_the_loop(case, used):
    """On the CPU, ``ops.rg_lru`` under autograd runs the plain Function
    (forward with its f32 carry, backward ``ref.rg_lru_bwd``): its
    gradients equal, bit for bit, autograd's through the plain forward's
    loop, whichever outputs the loss reads (the other's gradient None)."""
    b, s, d, with_h0, dtype = case
    _, inputs = _inputs(b, s, d, with_h0, dtype, seed=4)
    _, _, dht, dlt = _cotangents(b, s, d, dtype, True, seed=8)
    grads = []
    for fn in (ops.rg_lru, ref.rg_lru):
        leaves = [x.clone().requires_grad_(True) for x in inputs
                  if x is not None]
        h, h_last = fn(*leaves) if with_h0 else fn(*leaves, None)
        outs, cots = {"h": ((h,), (dht,)), "h_last": ((h_last,), (dlt,)),
                      "both": ((h, h_last), (dht, dlt))}[used]
        if fn is ops.rg_lru:
            assert type(h.grad_fn).__name__ == "_PlainRGLRUFunctionBackward"
        grads.append(torch.autograd.grad(outs, leaves, cots))
    for g, w in zip(*grads):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_plain_backward_without_output_gradients_is_zero():
    """dh None and dh_last None: every gradient zero, in a's dtype."""
    _, (at, gt, ht) = _inputs(2, 40, 24, True, "bfloat16", seed=5)
    _, _, h32 = ref.rg_lru(at, gt, ht, return_carry=True)
    for g in ref.rg_lru_bwd(at, h32, None, None, ht):
        assert g.dtype == torch.bfloat16 and not g.any()


# --------------------------------------------------- the backward kernel

H100_SMS = 132


@pytest.mark.parametrize("case", SMOKE_CASES, ids=str)
def test_bwd_launch_plan_covers_each_channel_once(case):
    """Every (b, t, channel) is computed once, by the ring at every S (one
    partial tile below one tile); no block is without work; each channel of
    a row of a and dh (in a's dtype) and of the f32 carry is brought in by
    exactly one 16-byte copy (cp.async) and every copy holds one of them,
    at every shift a row can have, and the copies of a row fit its stage
    row."""
    b, s, d, dtype, _ = case
    dt = getattr(torch, dtype)
    size = dt.itemsize
    for aligned in (True, False):
        plan = rg_lru_kernel.bwd_launch_plan(b, s, d, dt, aligned=aligned)
        assert (_computed(plan, b, s, d) == 1).all()
        assert (plan.grid[0] - 1) * plan.tile_d < d
        assert plan.tile_d <= 1024
        assert plan.kernel == "ring" and plan.tile_s == \
            rg_lru_kernel.BWD_TILE_S
        assert plan.tile_d * size == rg_lru_kernel.ROW_BYTES
        assert plan.aligned == (aligned and d * size % 16 == 0)
        pad = 0 if plan.aligned else 16
        for esize, row_bytes in ((size, rg_lru_kernel.ROW_BYTES),
                                 (4, plan.tile_d * 4)):
            vec = 16 // esize
            shifts = range(vec) if not plan.aligned else [0]
            for n in {plan.tile_d, d - (plan.grid[0] - 1) * plan.tile_d}:
                for shift in shifts:
                    copies = _ring_copies(plan, n, shift, esize, row_bytes)
                    got = np.concatenate([list(c) for c in copies])
                    assert sorted(got[(got >= 0) & (got < n)]) == \
                        list(range(n))
                    assert all(c.start < n and c.stop > 0 for c in copies)
                    assert 16 * len(copies) <= row_bytes + pad


@pytest.mark.parametrize("case", SMOKE_CASES, ids=str)
def test_bwd_launch_plan_fits_an_h100_sm(case):
    """The plan's shared memory is its ring's stages (a, dh and the carry,
    each row padded by 16 bytes at a shift, and two mbarriers a stage) and
    fits an H100 SM with its reserved KB; its blocks an SM follow from
    threads (two a channel), shared memory and registers at 255 a
    thread."""
    b, s, d, dtype, _ = case
    for aligned in (True, False):
        plan = rg_lru_kernel.bwd_launch_plan(b, s, d, getattr(torch, dtype),
                                             aligned=aligned)
        pad = 0 if plan.aligned else 16
        stage = plan.tile_s * (2 * (rg_lru_kernel.ROW_BYTES + pad)
                               + plan.tile_d * 4 + pad)
        assert plan.smem == plan.stages * (stage + 16)
        threads = 2 * plan.tile_d  # a consumer and a producer a channel
        assert 0 <= plan.smem + rg_lru_kernel.SMEM_RESERVED \
            <= rg_lru_kernel.SM_SMEM
        assert plan.blocks_per_sm == min(
            rg_lru_kernel.SM_THREADS // threads, rg_lru_kernel.SM_BLOCKS,
            rg_lru_kernel.SM_REGISTERS // (threads
                                           * rg_lru_kernel.MAX_REGISTERS),
            rg_lru_kernel.SM_SMEM // (plan.smem
                                      + rg_lru_kernel.SMEM_RESERVED)) >= 1


def test_bwd_launch_plan_spreads_the_training_shape_over_the_card():
    """At recurrentgemma-9b's training shape (2, 4096, 4096) bf16 the ring's
    blocks (one batch row, 64 channels each) are 128, about one on each of
    the H100's 132 SMs, and its tiles in flight ahead of the chain come to
    at least 3 MB on the card (a register walk of 16 steps a chain keeps
    ~1 MB)."""
    plan = rg_lru_kernel.bwd_launch_plan(2, 4096, 4096, torch.bfloat16)
    assert plan.kernel == "ring" and plan.aligned
    assert plan.grid == (64, 2) and plan.tile_d == 64
    blocks = plan.grid[0] * plan.grid[1]
    assert H100_SMS - 8 <= blocks <= H100_SMS
    stage = plan.tile_s * (2 * rg_lru_kernel.ROW_BYTES + plan.tile_d * 4)
    assert blocks * (plan.stages - 1) * stage >= 3 << 20
    assert plan.blocks_per_sm >= 1


def _ring_walk(a, h32, dh, dh_last, h0, tile_s, tile_d):
    """The ring kernel's walk in torch: a block a (b, channel segment), the
    time tiles from the end, a stage's row r holding a_t, dh_t and the
    carry one step back (h32 row t - 1; h0 at t = 0), each product rounded
    before its add (f32 tensors round each op)."""
    b, s, d = a.shape
    da = torch.empty(a.shape, dtype=torch.float32)
    dgx = torch.empty(a.shape, dtype=torch.float32)
    dh0 = torch.empty((b, d), dtype=torch.float32)
    for bi in range(b):
        for c0 in range(0, d, tile_d):
            cs = slice(c0, min(d, c0 + tile_d))
            g_in = (dh_last[bi, cs].float() if dh_last is not None
                    else torch.zeros(cs.stop - c0))
            for t0 in range(-(-s // tile_s) * tile_s - tile_s, -1, -tile_s):
                rows = min(tile_s, s - t0)
                sa = a[bi, t0:t0 + rows, cs].float()
                sd = (dh[bi, t0:t0 + rows, cs].float() if dh is not None
                      else None)
                sh = h32[bi, max(t0 - 1, 0):t0 + rows - 1, cs]
                if t0 == 0:
                    init = (h0[bi, cs].float() if h0 is not None
                            else torch.zeros(cs.stop - c0))
                    sh = torch.cat([init[None], sh])
                for r in range(rows - 1, -1, -1):
                    g = g_in if sd is None else sd[r] + g_in
                    dgx[bi, t0 + r, cs] = g
                    da[bi, t0 + r, cs] = g * sh[r]
                    g_in = sa[r] * g
            dh0[bi, cs] = g_in
    return (da.to(a.dtype), dgx.to(a.dtype),
            None if h0 is None else dh0.to(a.dtype))


# (B, S, D, h0 given, dh given, dh_last given, dtype): ragged S, one tile
# exactly, a ragged channel segment, no dh, both dtypes, and S below one
# tile (one partial tile; S = 1 reads no carry row)
WALK_CASES = [(2, 70, 80, True, True, True, "bfloat16"),
              (1, 32, 64, False, True, False, "bfloat16"),
              (2, 33, 40, True, False, True, "float32"),
              (3, 95, 36, False, True, True, "float32"),
              (2, 1, 72, True, True, True, "bfloat16"),
              (2, 31, 40, True, True, False, "float32")]


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_bwd_ring_walk_equals_the_plain_backward(case):
    """The ring's walk (tiles from the end, the carry one step back in a
    stage) at the plan's tiles gives ``ref.rg_lru_bwd``'s bits."""
    b, s, d, with_h0, with_dh, with_last, dtype = case
    _, (at, gt, ht) = _inputs(b, s, d, with_h0, dtype, seed=6)
    _, _, dht, dlt = _cotangents(b, s, d, dtype, with_last, seed=9)
    _, _, h32 = ref.rg_lru(at, gt, ht, return_carry=True)
    dht = dht if with_dh else None
    plan = rg_lru_kernel.bwd_launch_plan(b, s, d, at.dtype)
    assert plan.kernel == "ring"
    got = _ring_walk(at, h32, dht, dlt, ht, plan.tile_s, plan.tile_d)
    want = ref.rg_lru_bwd(at, h32, dht, dlt, ht)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def test_bwd_plan_and_entry_points_match_the_cuda_source():
    """The plan's constants are the compiled instances' (the C entry point
    refuses any other plan), and the ctypes argument
    lists match the C entry points (6 pointers, 11 ints and the stream for
    the forward; 8 pointers, 11 ints and the stream for the backward)."""
    src = (ROOT / "src/repro_torch/kernels/csrc/rg_lru.cu").read_text()
    for name in ("BWD_TILE_S", "BWD_STAGES"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(rg_lru_kernel, name), name
    for name, args in (("rg_lru_fwd", rg_lru_kernel.FWD_ARGTYPES),
                       ("rg_lru_bwd", rg_lru_kernel.BWD_ARGTYPES)):
        params = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                           re.S).group(1).split(",")
        kinds = ["ptr" if "*" in p else "int" for p in params]
        want = ["int" if a is ctypes.c_int else "ptr" for a in args]
        assert kinds == want, name


def test_wrappers_refuse_cpu_tensors_before_any_build():
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rg_lru_kernel.rg_lru_bwd(a, a, a)
    with pytest.raises(ValueError, match="CUDA"):
        rg_lru_kernel.rg_lru(a.requires_grad_(True), a)
    assert rg_lru_kernel.rg_lru_bwd.launches == 0
    assert rg_lru_kernel.rg_lru.launches == 0


# ------------------------------------------------------------- the loss


def _whole_tensor_cross_entropy(logits, labels):
    """The loss as autograd differentiates it through whole tensors: an
    f32 copy of the logits, logsumexp and gather over the last dim."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    return (lse - torch.gather(lf, -1, labels[..., None])[..., 0]).mean()


@pytest.mark.parametrize("shifted", [False, True], ids=["whole", "shifted"])
@pytest.mark.parametrize("rows", [1, 3, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_in_row_chunks_equals_the_whole_tensor_loss(
        dtype, rows, shifted, monkeypatch):
    """``cross_entropy`` takes CE_ROWS rows of the logits at a time (the
    card's memory at recurrentgemma-9b's 256,000-entry vocab): its loss and
    the logits' gradient equal, bit for bit, autograd's through the whole
    tensors, at chunks of 1 and 3 rows and one chunk for all, for logits
    as the model makes them and shifted by a position as the MTP loss
    takes them (labels not contiguous)."""
    from repro_torch.runtime import train_step as ts
    monkeypatch.setattr(ts, "CE_ROWS", rows)
    gen = torch.Generator().manual_seed(9)
    x = (3 * torch.randn((3, 37, 500), generator=gen)).to(getattr(torch,
                                                                 dtype))
    labels = torch.randint(0, 500, (3, 37), generator=gen)
    sl = (slice(None), slice(1, None)) if shifted else (slice(None),)
    out = []
    for fn in (lambda l, y: ts.cross_entropy(l, y, 500),
               _whole_tensor_cross_entropy):
        leaf = x.clone().requires_grad_(True)
        loss = fn(leaf[sl], labels[sl])
        out.append((loss, torch.autograd.grad(loss, leaf)[0]))
    (loss, grad), (want_loss, want_grad) = out
    assert loss.dtype == torch.float32 and grad.dtype == x.dtype
    assert torch.equal(loss, want_loss) and torch.equal(grad, want_grad)


# ------------------------------------------- reduced recurrentgemma-9b

ARCH = "recurrentgemma-9b"
LR = 1e-3
# 4 x 48 tokens: the reduced config's window of 16 is live
BATCH, SEQ, DATA_SEED = 4, 48, 5
# Each leaf's gradient in f32, ||port - reference|| <= GRAD_TOL ||reference||:
# the port runs the sequential scan and its reverse, the reference the
# associative scan and its autodiff, and XLA's and torch's f32 products
# round differently; measured 2.3e-5 at most (the conv kernel and
# w_gate_branch of the first rglru block), held to 2e-4
GRAD_TOL = 2e-4
# the loss (measured 1.7e-7 apart) and grad norm, as
# tests/test_torch_enc_train.py holds them
LOSS_TOL, GNORM_TOL = 1e-5, 2e-3
# AdamW's step from zero moments moves every element by ~LR sign(g), so a
# gradient element within rounding of zero moves by ~LR either way: the
# step is held equal to the port's own clipping and update of its own
# gradients, and the port's clipping and update fed the reference's
# gradients within FED_TOL of the reference's step (as
# tests/test_torch_enc_train.py)
FED_TOL = 1e-4


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, model, params; port cfg, model, params) of reduced
    recurrentgemma-9b in f32, the params drawn by the reference, and the
    pipeline's batch 0 (numpy)."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    payloads, manifest = jser.serialize_tree(jax.device_get(jparams))
    params = ser.deserialize_tree(
        map_tree(torch.zeros_like, model.init(0, device="cpu")), payloads,
        manifest)
    batch = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                global_batch=BATCH,
                                seed=DATA_SEED)._batch_at(0)
    return jcfg, jmodel, jparams, cfg, model, params, batch


def _jgrads(jcfg, jmodel, jparams, batch):
    vp = padded_vocab(jcfg)
    return jax.jit(jax.grad(lambda p: jts.cross_entropy(
        jmodel.forward(p, jnp.asarray(batch["inputs"])),
        jnp.asarray(batch["labels"]), vp)))(jparams)


def _port_grads(cfg, model, params, batch):
    tbatch = batch_to(batch, "cpu")
    lp = ser.tree_map_with_path(
        lambda _, t: t.detach().clone().requires_grad_(True), params)
    names, leaves = zip(*ser.tree_paths(lp))
    loss = cross_entropy(model.forward(lp, tbatch["inputs"]),
                         tbatch["labels"], padded_vocab(cfg))
    return dict(zip(names, torch.autograd.grad(loss, leaves))), loss


def test_reduced_recurrentgemma_grads_match_reference(pair):
    """Every leaf's gradient of the loss (the rglru blocks' gates, lam, the
    conv and the projections, through the scan's backward; the
    attn_local layer through the flash backward) against the reference's
    jitted ``jax.grad``."""
    jcfg, jmodel, jparams, cfg, model, params, batch = pair
    want = {n: np.asarray(g, np.float64) for n, g in
            jser.tree_paths(jax.device_get(_jgrads(jcfg, jmodel, jparams,
                                                   batch)))}
    got, _ = _port_grads(cfg, model, params, batch)
    assert list(got) == list(want)
    assert any("lam" in n for n in got) and any("conv" in n for n in got)
    for n, w in want.items():
        assert np.linalg.norm(w) > 0, n
        err = _rel(got[n].double().numpy(), w)
        assert err <= GRAD_TOL, f"{n}: off by {err:.2e} of its norm"


def test_reduced_recurrentgemma_adamw_step_matches_reference(pair):
    """One step of ``make_train_step`` with AdamW from the same params and
    batch: the loss and grad norm against the reference's jitted
    ``make_train_step``; the step equal bit for bit to the port's clipping
    and update of its own gradients; the port's clipping and update fed
    the reference's gradients within FED_TOL of the reference's step."""
    jcfg, jmodel, jparams, cfg, model, params, batch = pair
    jopt, opt = JAdamW(lr=jconstant(LR)), AdamW(lr=constant(LR))
    jstate2, jm = jax.jit(jts.make_train_step(jcfg, jmodel, jopt))(
        jts.TrainState(jparams, jopt.init(jparams)), batch)
    state2, m = make_train_step(cfg, model, opt)(
        TrainState(params, opt.init(params)), batch_to(batch, "cpu"))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=GNORM_TOL)

    def stepped(grads):
        clipped, _ = clip_by_global_norm(grads, 1.0)
        return opt.update(clipped, opt.init(params), params)[0]

    own, _ = _port_grads(cfg, model, params, batch)
    mine = stepped(ser.tree_map_with_path(lambda n, t: own[n], params))
    for (n, a), (_, b) in zip(ser.tree_paths(state2.params),
                              ser.tree_paths(mine)):
        assert torch.equal(a, b), f"{n}: the step is not its own " \
                                  f"gradients' update"
    fed = stepped(params_from_numpy(jax.device_get(
        _jgrads(jcfg, jmodel, jparams, batch)), device="cpu"))
    before = {n: t.numpy() for n, t in ser.tree_paths(params)}
    jafter = dict(jser.tree_paths(jax.device_get(jstate2.params)))
    for n, f in ser.tree_paths(fed):
        change = np.asarray(jafter[n]) - before[n]
        assert np.linalg.norm(change) > 0, n
        err = _rel(f.numpy() - before[n], change)
        assert err <= FED_TOL, f"{n}: the update of the reference's " \
                               f"gradients off by {err:.2e}"


def test_recurrentgemma_train_loop_restore_bit_exact():
    """Reduced recurrentgemma-9b (AdamW) through ``train_loop``'s kill and
    restore: run B's params and AdamW state equal run A's bit for bit."""
    state = _train_loop_kill_restore_bit_exact(ARCH)
    assert type(state.opt_state).__name__ == "AdamWState"
    assert "lam" in state.params["segments"]["seg0"]["0"]["block"]


def test_train_cli_runs_reduced_recurrentgemma_on_cpu(capsys):
    """``--arch recurrentgemma-9b --reduced --device cpu``: the scan's
    backward in every step, an int8-moment checkpoint end to end."""
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--seq", "32", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out
    assert "[ckpt] step 2: ingest" in out
