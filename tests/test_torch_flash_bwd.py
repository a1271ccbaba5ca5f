"""The port's flash-attention backward against the reference's on the CPU:
the gradients of the port's CPU autograd Function against ``jax.vjp``
through the reference's custom VJP (``repro/kernels/ops.py::_flash_vjp``),
the plain backward ``flash_bwd_chunked`` against autograd through the plain
forward, the forward's row statistics against
``_flash_chunked_jnp(..., return_stats=True)``, the dispatch of a CPU
tensor that needs a gradient, and the wrappers' refusals; and, in plain
torch, the roundings of the bf16 tensor-core backward (P and dS split into
two bf16 operands each) against the plain backward. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa

# the reference's ATTN_CASES (tests/test_kernels.py), a q offset with
# Sq < Sk (the last 64 queries of 200 keys) and a window that ends inside
# chunks: (B, Sq, Sk, H, KV, D, causal, window, softcap, q_offset, dtype)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, 0, "float32"),
    (2, 96, 96, 4, 2, 32, True, 0, 0.0, 0, "float32"),
    (1, 128, 128, 8, 2, 64, True, 48, 0.0, 0, "float32"),
    (1, 64, 64, 2, 1, 128, False, 0, 0.0, 0, "float32"),
    (1, 128, 128, 4, 4, 64, True, 0, 20.0, 0, "float32"),
    (1, 128, 128, 4, 2, 64, True, 0, 0.0, 0, "bfloat16"),
    (2, 80, 80, 4, 4, 48, True, 0, 0.0, 0, "float32"),      # ragged seq
]
EXTRA_CASES = [
    (1, 64, 200, 4, 2, 32, True, 0, 0.0, 136, "float32"),   # q offset
    (1, 160, 160, 4, 2, 32, True, 100, 0.0, 0, "float32"),  # window
    # head dim 80 (h2o-danube-1.8b) at GQA 4: a window edge inside the
    # chunks of a ragged S, and a q offset with Sq < Sk, f32 and bf16
    (1, 200, 200, 8, 2, 80, True, 64, 0.0, 0, "float32"),
    (1, 72, 200, 8, 2, 80, True, 0, 0.0, 128, "float32"),
    (1, 200, 200, 8, 2, 80, True, 64, 0.0, 0, "bfloat16"),
    # head dim 256 (recurrentgemma-9b, gemma3-4b) at GQA 2 with a window
    # edge inside the chunks of a ragged S, f32 and bf16
    (1, 100, 100, 4, 2, 256, True, 40, 0.0, 0, "float32"),
    (1, 100, 100, 4, 2, 256, True, 40, 0.0, 0, "bfloat16"),
    # head dim 192 (deepseek-v3-671b's MLA: as many kv heads as q heads),
    # causal over a ragged S, f32 and bf16
    (1, 100, 100, 4, 4, 192, True, 0, 0.0, 0, "float32"),
    (1, 100, 100, 4, 4, 192, True, 0, 0.0, 0, "bfloat16"),
]
# chunks of 48 keys: a ragged last chunk in every case, padded by the
# reference and cut short by the port
CHUNK = 48
# the port's gradients against jax.vjp through _flash_vjp, as
# |port - reference| / (1 + |reference|) over all elements: f32 sums in
# other orders, measured up to 1.2e-6 (head dim 80), held at the
# reference's f32 kernel tolerance, 2e-5; bf16 (each rounds its f32
# results to bf16 once) measured up to 3.8e-3 (half a bf16 ulp at |x| ~ 1,
# head dim 80), held at the reference's bf16 tolerance, 3e-2
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _opts(case):
    *_, causal, window, cap, q_offset, _ = case
    return dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)


def _inputs(case, seed=7):
    """q, k, v and the output gradient as numpy f32, from one seed."""
    b, sq, sk, h, kv, d = case[:6]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return mk(b, sq, h, d), mk(b, sk, kv, d), mk(b, sk, kv, d), mk(b, sq, h, d)


def _torch(a, dtype, grad=False):
    return torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(grad)


def _close(out, exp, tol, what):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("case", ATTN_CASES + EXTRA_CASES)
def test_port_gradients_match_reference_vjp(case, monkeypatch):
    """dq, dk, dv of the port's CPU Function against ``jax.vjp`` of the
    reference's ``ops.flash_attention`` on the CPU, which goes through
    ``_flash_vjp`` (the Pallas path, taken in interpret mode, has no VJP)."""
    monkeypatch.delenv("REPRO_FORCE_INTERPRET", raising=False)
    dtype = case[-1]
    q, k, v, do = _inputs(case)
    jdt = getattr(jnp, dtype)
    fn = lambda q_, k_, v_: jops.flash_attention(q_, k_, v_, chunk=CHUNK,
                                                 **_opts(case))
    jo, vjp = jax.vjp(fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))
    leaves = [_torch(x, dtype, grad=True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, chunk=CHUNK, **_opts(case))
    assert type(out.grad_fn).__name__ == "_PlainFlashFunctionBackward"
    grads = torch.autograd.grad(out, leaves, _torch(do, dtype))
    _close(out.detach().float(), jo, TOL[dtype], "o")
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == leaves[0].dtype and g.shape == jg.shape, name
        _close(g.float(), jg, TOL[dtype], name)


# deepseek-v3-671b's MLA pads V from its head dim 128 to the q / k head dim
# 192 with zeros, and slices the output back, so dO's padded columns are
# zero too: at reduced width, V and dO zero in their last 64 of 192 columns
MLA_PAD_CASES = [(1, 100, 100, 4, 4, 192, True, 0, 0.0, 0, dtype)
                 for dtype in ("float32", "bfloat16")]
MLA_PAD = 64


@pytest.mark.parametrize("case", MLA_PAD_CASES, ids=lambda c: c[-1])
def test_padded_v_gradients_match_reference_vjp(case, monkeypatch):
    """The D = 192 backward with V and dO zero-padded as ``models/mla.py``
    pads them: dq, dk, dv against ``jax.vjp`` of the reference at its
    tolerance, and dv's padded columns exactly zero in both packages (each
    element a sum of p dO terms with dO = 0)."""
    monkeypatch.delenv("REPRO_FORCE_INTERPRET", raising=False)
    dtype = case[-1]
    q, k, v, do = _inputs(case, seed=9)
    v[..., -MLA_PAD:] = 0.0
    do[..., -MLA_PAD:] = 0.0
    jdt = getattr(jnp, dtype)
    fn = lambda q_, k_, v_: jops.flash_attention(q_, k_, v_, chunk=CHUNK,
                                                 **_opts(case))
    jo, vjp = jax.vjp(fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))
    leaves = [_torch(x, dtype, grad=True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, chunk=CHUNK, **_opts(case))
    grads = torch.autograd.grad(out, leaves, _torch(do, dtype))
    assert not out.detach()[..., -MLA_PAD:].any()
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(g.float(), jg, TOL[dtype], name)
    assert not grads[2][..., -MLA_PAD:].any()
    assert not np.asarray(jgrads[2], np.float32)[..., -MLA_PAD:].any()


# the plain backward against autograd through the plain forward, both in
# f32 on the same tensors: measured up to 1.6e-6 (as above); held
# elementwise to atol = rtol = 1e-5
PLAIN_TOL = 1e-5


@pytest.mark.parametrize(
    "case", [c for c in ATTN_CASES + EXTRA_CASES if c[-1] == "float32"])
def test_plain_backward_matches_autograd(case):
    q, k, v, do = (_torch(x, "float32") for x in _inputs(case, seed=3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_chunked(*leaves, chunk=CHUNK, **_opts(case))
    exp = torch.autograd.grad(out, leaves, do)
    o, m, l = ops.flash_chunked(q, k, v, chunk=CHUNK, return_stats=True,
                                **_opts(case))
    assert torch.equal(o, out.detach())
    got = ops.flash_bwd_chunked(q, k, v, o, m, l, do, chunk=CHUNK,
                                **_opts(case))
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        torch.testing.assert_close(g, e, atol=PLAIN_TOL, rtol=PLAIN_TOL,
                                   msg=name)


@pytest.mark.parametrize("case", ATTN_CASES + EXTRA_CASES)
def test_row_stats_match_reference(case):
    """m and l of ``flash_chunked(..., return_stats=True)``, (B, Sq, H),
    against the reference's (B, Sq, KV, G) statistics: measured up to
    1.2e-6 (as above; bf16 inputs are upcast alike); held to 5e-6."""
    dtype = case[-1]
    q, k, v, _ = _inputs(case)
    jdt = getattr(jnp, dtype)
    _, jm, jl = jops._flash_chunked_jnp(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), chunk=CHUNK,
        return_stats=True, **_opts(case))
    o, m, l = ops.flash_chunked(*(_torch(x, dtype) for x in (q, k, v)),
                                chunk=CHUNK, return_stats=True,
                                **_opts(case))
    b, sq, h = case[0], case[1], case[3]
    assert m.shape == l.shape == (b, sq, h)
    assert m.dtype == l.dtype == torch.float32
    _close(m, np.asarray(jm).reshape(b, sq, h), 5e-6, "m")
    _close(l, np.asarray(jl).reshape(b, sq, h), 5e-6, "l")


def test_cpu_tensor_that_needs_a_gradient_takes_the_plain_function():
    """The plain Function, which saves (q, k, v, o, m, l) as the reference's
    ``_flash_fwd`` does, and no kernel library is loaded or launched;
    without a gradient the plain forward runs alone."""
    case = ATTN_CASES[1]
    q, k, v, do = (_torch(x, "float32") for x in _inputs(case))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, chunk=CHUNK, **_opts(case))
    saved = out.grad_fn.saved_tensors
    b, sq, h = case[0], case[1], case[3]
    assert [tuple(t.shape) for t in saved] == [
        tuple(q.shape), tuple(k.shape), tuple(v.shape), tuple(q.shape),
        (b, sq, h), (b, sq, h)]
    grads = torch.autograd.grad(out, leaves, do)
    o, m, l = ops.flash_chunked(q, k, v, chunk=CHUNK, return_stats=True,
                                **_opts(case))
    exp = ops.flash_bwd_chunked(q, k, v, o, m, l, do, chunk=CHUNK,
                                **_opts(case))
    assert all(torch.equal(g, e) for g, e in zip(grads, exp))
    with torch.no_grad():
        plain = ops.flash_attention(*leaves, chunk=CHUNK, **_opts(case))
    assert plain.grad_fn is None and torch.equal(plain, o)
    assert fa._fwd is None and fa._bwd is None and build._libs == {}
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention_bwd.launches == 0


def _refusals():
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    q, kv, st = z(1, 8, 4, 16), z(1, 8, 2, 16), z(1, 8, 4)
    qb, kvb = q.bfloat16(), kv.bfloat16()
    off = lambda t: torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(
        t.shape)
    fwd = lambda *a: fa.flash_attention(*a)
    bwd = lambda q_, k_, v_, o=q, m=st, l=st, do=q: fa.flash_attention_bwd(
        q_, k_, v_, o, m, l, do)
    return [
        ("fwd half", fwd, (z(1, 8, 4, 16, dt=torch.float16),
                           z(1, 8, 2, 16, dt=torch.float16),
                           z(1, 8, 2, 16, dt=torch.float16)), "dtypes"),
        ("fwd mixed", fwd, (q, kv.bfloat16(), kv), "dtypes"),
        ("fwd head dim 96", fwd, (z(1, 8, 4, 96), z(1, 8, 2, 96),
                                  z(1, 8, 2, 96)), "head dim"),
        ("bwd head dim 24", lambda *a: bwd(
            *a, o=z(1, 8, 4, 24), m=st, l=st, do=z(1, 8, 4, 24)),
         (z(1, 8, 4, 24), z(1, 8, 2, 24), z(1, 8, 2, 24)), "head dim"),
        ("bwd head dim 96", lambda *a: bwd(
            *a, o=z(1, 8, 4, 96), m=st, l=st, do=z(1, 8, 4, 96)),
         (z(1, 8, 4, 96), z(1, 8, 2, 96), z(1, 8, 2, 96)), "head dim 96"),
        ("fwd under autograd head dim 96", fwd,
         tuple(z(1, 8, h, 96).requires_grad_(True) for h in (4, 2, 2)),
         "head dim 96"),
        ("fwd groups", fwd, (q, z(1, 8, 3, 16), z(1, 8, 3, 16)), "shapes"),
        ("fwd strided", fwd, (z(1, 4, 8, 16).transpose(1, 2), kv, kv),
         "contiguous"),
        ("fwd on the cpu", fwd, (q, kv, kv), "CUDA"),
        ("bwd stats dtype", lambda *a: bwd(*a, m=st.double()), (q, kv, kv),
         "dtypes"),
        ("bwd dO shape", lambda *a: bwd(*a, do=z(1, 8, 4, 32)), (q, kv, kv),
         "shapes"),
        ("bwd stats shape", lambda *a: bwd(*a, l=z(1, 4, 8)), (q, kv, kv),
         "shapes"),
        ("bwd strided dO", lambda *a: bwd(
            *a, do=z(1, 4, 8, 16).transpose(1, 2)), (q, kv, kv),
         "contiguous"),
        ("bwd on the cpu", bwd, (q, kv, kv), "CUDA"),
        # 16-byte cp.async: a bf16 tensor one element past an aligned start
        ("bwd misaligned bf16 q", lambda *a: bwd(*a, o=qb, do=qb),
         (off(qb), kvb, kvb), "aligned"),
        ("bwd misaligned bf16 dO", lambda *a: bwd(*a, o=qb, do=off(qb)),
         (qb, kvb, kvb), "aligned"),
    ]


@pytest.mark.parametrize("name,call,args,match", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_wrappers_refuse_before_any_build(name, call, args, match):
    """Dtype, head dim, shape and contiguity are checked before the device,
    and all of it before a kernel library is built or loaded."""
    with pytest.raises(ValueError, match=match):
        call(*args)
    assert fa._fwd is None and fa._bwd is None and build._libs == {}


# The numerics of the bf16 tensor-core backward (csrc/flash_attention_bwd.cu,
# flash_bwd_mma_dkdv_kernel / flash_bwd_mma_dq_kernel), emulated in plain
# torch and held against the plain backward within chip_smoke.py's bound for
# bf16 gradients (atol = rtol = 8e-3, one bf16 ulp at every magnitude).
BF16_TOL = 8e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _parts(x, split):
    """x as the f32 operand reaches the tensor cores: bf16(x), plus
    bf16(x - bf16(x)) when split."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _tensor_core_rounding(q, k, v, o, m, l, do, *, split, chunk=512):
    """The causal ``flash_bwd_chunked`` as the bf16 kernels round it: S =
    q k^T (then d^-0.5) and dP = dO v^T as exact products of the bf16
    inputs summed in f32; P and dS enter dv = P^T dO, dk = dS^T q and
    dq = dS k as bf16 operands (hi + lo when ``split``, else rounded once),
    each product summed in f32; p, dS and D in f32 as the plain version."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    shape = (b, sq, kvh, h // kvh)
    scale = d ** -0.5
    qf = q.float().reshape(*shape, d)
    go = do.float().reshape(*shape, d)
    m = m.reshape(shape)
    linv = 1.0 / torch.clamp_min(l.reshape(shape), 1e-30)
    delta = (go * o.float().reshape(*shape, d)).sum(dim=-1)
    qpos = torch.arange(sq)[:, None]
    dq = torch.zeros((*shape, d))
    dks, dvs = [], []
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        kpos = torch.arange(c0, c0 + kb.shape[1])[None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kb) * scale
        p = torch.where((kpos <= qpos)[None, :, None, None, :],
                        torch.exp(s - m[..., None]), 0.0) * linv[..., None]
        dp = torch.einsum("bqkgd,bckd->bqkgc", go, vb)
        ds = p * (dp - delta[..., None]) * scale
        dvs.append(sum(torch.einsum("bqkgc,bqkgd->bckd", x, go)
                       for x in _parts(p, split)))
        dsx = _parts(ds, split)
        dks.append(sum(torch.einsum("bqkgc,bqkgd->bckd", x, qf)
                       for x in dsx))
        dq = dq + sum(torch.einsum("bqkgc,bckd->bqkgd", x, kb) for x in dsx)
    return (dq.reshape(b, sq, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


# one GQA group, causal, S 2048, (B, Sq, Sk, H, KV, D): starcoder2-3b's
# training shape (12 query heads to a kv head, D 128) and recurrentgemma-
# 9b's (16 to one, D 256: the dk / dv kernel's dv and dk blocks there)
SC_GROUP = (1, 2048, 2048, 12, 1, 128)
RG_GROUP = (1, 2048, 2048, 16, 1, 256)
# deepseek-v3-671b's MLA: a group of one (a kv head for each query head) at
# D 192, V and dO zero in their last 64 columns as models/mla.py pads them
MLA_GROUP = (1, 2048, 2048, 1, 1, 192)


@functools.lru_cache(maxsize=1)
def _rounding_case(case, pad=0):
    """``case`` in bf16 from one seed, V and dO zero in their last ``pad``
    columns: the inputs, the plain forward's o, m, l and the plain
    backward's dq, dk, dv."""
    q, k, v, do = (_torch(x, "bfloat16") for x in _inputs(case, seed=0))
    if pad:
        v[..., -pad:] = 0
        do[..., -pad:] = 0
    o, m, l = ops.flash_chunked(q, k, v, return_stats=True)
    return (q, k, v, o, m, l, do), ops.flash_bwd_chunked(q, k, v, o, m, l, do)


def _worst_over_bound(split, case=SC_GROUP, pad=0):
    """{dq, dk, dv: max |emulation - plain| / (8e-3 + 8e-3 |plain|)}."""
    inputs, plain = _rounding_case(case, pad)
    emu = _tensor_core_rounding(*inputs, split=split)
    return {name: ((a.float() - p.float()).abs()
                   / (BF16_TOL + BF16_TOL * p.float().abs())).max().item()
            for name, a, p in zip(("dq", "dk", "dv"), emu, plain)}


def test_tensor_core_rounding_stays_within_one_bf16_ulp():
    """With P and dS split hi + lo, dq, dk and dv stay within the 8e-3
    bound of the plain backward (measured 0.32, 0.38, 0.47 of it)."""
    worst = _worst_over_bound(split=True)
    assert max(worst.values()) <= 1.0, worst


def test_one_bf16_rounding_of_p_is_not_enough():
    """With P and dS each rounded to bf16 once, dv (a sum over every query
    of the 12-head group) leaves the bound (measured 1.48 x it; dk 1.19 x):
    the reason the kernels pay for the second product of each."""
    worst = _worst_over_bound(split=False)
    assert worst["dv"] > 1.0, worst


def test_tensor_core_rounding_at_head_dim_256_stays_within_one_bf16_ulp():
    """The same at recurrentgemma-9b's group, 16 query heads over one kv
    head at D 256, S 2048 (measured 0.32, 0.31, 0.55 of it)."""
    worst = _worst_over_bound(split=True, case=RG_GROUP)
    assert max(worst.values()) <= 1.0, worst


def test_one_bf16_rounding_of_p_is_not_enough_at_head_dim_256():
    """At that group, P and dS each rounded to bf16 once: dv leaves the
    bound (measured 1.43 x it; dk 1.07 x), so the dv and dk blocks keep the
    split."""
    worst = _worst_over_bound(split=False, case=RG_GROUP)
    assert worst["dv"] > 1.0, worst


def test_tensor_core_rounding_at_head_dim_192_stays_within_one_bf16_ulp():
    """The same at deepseek-v3-671b's MLA, one query head a kv head at
    D 192 with V padded from 128, S 2048 (dk / dv blocks of their own, as
    at D 256): dq, dk, dv within the bound (measured 0.19, 0.11, 0.19 of
    it; rounded once, 0.32, 0.48, 0.64: a group of one sums dv over 2048
    queries, not 16 x 2048), and the padded columns of dv exactly zero in
    the emulation as in the plain backward."""
    worst = _worst_over_bound(split=True, case=MLA_GROUP, pad=MLA_PAD)
    assert max(worst.values()) <= 1.0, worst
    inputs, plain = _rounding_case(MLA_GROUP, MLA_PAD)
    emu = _tensor_core_rounding(*inputs, split=True)
    assert not emu[2][..., -MLA_PAD:].any()
    assert not plain[2][..., -MLA_PAD:].any()


def test_tuning_variants_change_the_committed_source():
    """Each variant of ``python -m repro_torch.kernels.tune_flash_bwd`` finds
    the lines it changes in ``csrc/flash_attention_bwd.cu`` (the script
    stops on the card when one is missing)."""
    from repro_torch.kernels import tune_flash_bwd as tune
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for name, (subs, _) in tune.VARIANTS.items():
        assert subs and all(old in src for old in subs), name
    assert len(tune.LO_PRODUCTS) == 6
    assert all(src.count(line) == 1 for line in tune.LO_PRODUCTS)


def _smoke_module():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# what the profiler records in successive observations of one launch, by
# demangled kernel name; the labels device_kernels must return (None: it
# fails) and the number of observations
_DELTA = "void (anonymous namespace)::flash_bwd_delta_kernel(float const*)"
_DKDV = ("void (anonymous namespace)::flash_bwd_mma_dkdv_kernel<128>"
         "(__nv_bfloat16 const*)")
_DQ = ("void (anonymous namespace)::flash_bwd_mma_dq_kernel<128>"
       "(__nv_bfloat16 const*)")
_SIMT_DQ = ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16,"
            " 128>(__nv_bfloat16 const*)")
_WANT = ["flash_bwd_delta_kernel", "flash_bwd_mma_dkdv_kernel<128>",
         "flash_bwd_mma_dq_kernel<128>"]
PROFILER_OBSERVATIONS = {
    "all at once": ([[_DELTA, _DKDV, _DQ]], _WANT, 1),
    "records dropped once": ([[_DQ], [_DELTA, _DKDV, _DQ]], _WANT, 2),
    "no record, then all": ([[], [_DELTA, _DKDV, _DQ]], _WANT, 2),
    "always a part": ([[_DQ]] * 5, ["flash_bwd_mma_dq_kernel<128>"], 5),
    "a wrong kernel": ([[_DELTA, _DKDV, _SIMT_DQ], [_DELTA, _DKDV, _DQ]],
                       ["flash_bwd_delta_kernel", "flash_bwd_dq_kernel<bf16, "
                        "128>", "flash_bwd_mma_dkdv_kernel<128>"], 1),
    "never a port kernel": ([["aten::mm"]] * 5, None, 5),
}


@pytest.mark.parametrize("case", sorted(PROFILER_OBSERVATIONS))
def test_device_kernels_reobserves_only_dropped_records(case, monkeypatch):
    """chip_smoke.py's ``device_kernels`` profiles a launch again only while
    the profiler recorded a strict part of the expected kernels (a dropped
    record), at most five observations, and returns the first call's
    output; a kernel outside the expected set ends the observations (the
    caller's equality check then fails), and no kernel of the port in any
    observation fails."""
    from types import SimpleNamespace
    smoke = _smoke_module()
    seen, want, calls = PROFILER_OBSERVATIONS[case]
    observations = iter(seen)
    cuda = torch.autograd.DeviceType.CUDA

    class Profile:
        def __init__(self, activities):
            self.names = next(observations)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [SimpleNamespace(name=n, device_type=cuda)
                    for n in self.names]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(smoke, "_profiler_warmup", lambda: None)
    launches = []

    def launch():
        launches.append(1)
        return len(launches)

    if want is None:
        with pytest.raises(SystemExit):
            smoke.device_kernels(launch, _WANT, "[test]")
    else:
        assert smoke.device_kernels(launch, _WANT, "[test]") == (1, want)
    assert len(launches) == calls
