"""The port's mLSTM path against the reference's on the same numpy inputs:
the plain chunked mLSTM and the sequential oracle against the Pallas kernel
(interpret mode), the reference's chunked form and its oracle; the
stateful split; the dispatch on the CPU; the kernel's autograd wiring (its
backward is autograd through the plain chunked form, as the reference's
training is through ``_mlstm_chunked_jnp``); and the mLSTM and sLSTM blocks
on reduced xlstm-350m. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``; the model-level logits of reduced
xlstm-350m are in ``tests/test_torch_models.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mlstm import mlstm_pallas
from repro.models import xlstm as jxlstm
from repro.models.registry import build_model as jbuild_model
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import mlstm as kmlstm
from repro_torch.kernels import ops, ref
from repro_torch.models import xlstm

# (B, S, H, D), chunk, dtype of q/k/v: the reference's kernel-test shapes
# (tests/test_kernels.py), xlstm-350m's head dim 512, and a bf16 case (the
# dtype the training path hands the kernel)
CASES = [((1, 128, 2, 32), 64, "float32"), ((2, 256, 1, 64), 128, "float32"),
         ((1, 192, 4, 16), 64, "float32"), ((1, 256, 1, 512), 128, "float32"),
         ((1, 256, 2, 128), 64, "bfloat16")]
# the reference's kernel-test tolerances for h and C (and n), 1e-5 for m;
# measured here: h 6.3e-5 (D = 512, outputs up to ~20), C 1.4e-6, m 9.5e-7
ATOL, RTOL, M_TOL = 5e-4, 1e-3, 1e-5
# bf16: the references get the same bf16-rounded q/k/v as f32 and return
# f32; the port rounds h, C and n to bf16 once, which moves each by at most
# half a bf16 ulp (2^-8 |x|); atol = rtol = 8e-3 is one ulp at every
# magnitude, the tolerance chip_smoke.py holds the card's kernel to
BF16_TOL = 8e-3

PLAIN = {
    "chunked": lambda q, k, v, lf, li, chunk: ops.mlstm_chunked(
        q, k, v, lf, li, chunk=chunk),
    "oracle": lambda q, k, v, lf, li, chunk: ref.mlstm(q, k, v, lf, li),
}


def _inputs(shape, seed=0, dtype="float32"):
    """q, k, v normal; log_f = log(U(0.85, 0.999)), log_i = 0.5 N(0, 1), as
    the reference's kernel tests draw them. -> (jax arrays, tensors). In
    bf16, q/k/v tensors are bf16 and the jax arrays their values in f32."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    arrs.append(np.log(rng.uniform(0.85, 0.999, (b, s, h))).astype(
        np.float32))
    arrs.append((rng.normal(size=(b, s, h)) * 0.5).astype(np.float32))
    tensors = [torch.from_numpy(a) for a in arrs]
    if dtype == "bfloat16":
        tensors[:3] = [t.to(torch.bfloat16) for t in tensors[:3]]
        arrs[:3] = [t.float().numpy() for t in tensors[:3]]
    return [jnp.asarray(a) for a in arrs], tensors


def _close(out, exp, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(exp, np.float32), atol=atol,
                               rtol=rtol)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's three versions on the case's inputs (computed once
    for both plain versions of the port)."""
    shape, chunk, dtype = case
    j, _ = _inputs(shape, dtype=dtype)
    return {
        "pallas": mlstm_pallas(*j, chunk=chunk, interpret=True),
        "chunked_jnp": jops._mlstm_chunked_jnp(*j, chunk=chunk),
        "oracle": jref.mlstm(*j),
    }


@pytest.mark.parametrize("plain", sorted(PLAIN))
@pytest.mark.parametrize("case", CASES)
def test_plain_mlstm_matches_reference(case, plain):
    shape, chunk, dtype = case
    _, t = _inputs(shape, dtype=dtype)
    h, (c, n, m) = PLAIN[plain](*t, chunk)
    assert h.shape == shape and c.shape == shape[:1] + shape[2:3] + (
        shape[3], shape[3]) and m.dtype == torch.float32
    assert h.dtype == c.dtype == n.dtype == getattr(torch, dtype)
    tol = ((BF16_TOL, BF16_TOL) if dtype == "bfloat16" else (ATOL, RTOL))
    for name, (eh, (ec, en, em)) in _reference(case).items():
        _close(h, eh, *tol)
        _close(c, ec, *tol)
        _close(n, en, *tol)
        _close(m, em, atol=M_TOL, rtol=0)


def test_stateful_split_matches_full_pass():
    """The decode-path contract, as the reference's test: carrying (C, n, m)
    across a split of the sequence equals one full pass, for the oracle
    (cut at 40) and for the chunked form (two halves of 32 steps, chunk
    16); and the reference's chunked form with the same carried state."""
    (jq, jk, jv, jlf, jli), t = _inputs((1, 64, 2, 16), seed=1)
    full, _ = ref.mlstm(*t)
    for run, cut in ((lambda x, st: ref.mlstm(*x, *st), 40),
                     (lambda x, st: ops.mlstm_chunked(
                         *x, state=st or None, chunk=16), 32)):
        h1, st = run([a[:, :cut] for a in t], ())
        h2, _ = run([a[:, cut:] for a in t], st)
        _close(torch.cat([h1, h2], 1), full.numpy(), atol=1e-4, rtol=1e-4)
    h1, st = ops.mlstm_chunked(*[a[:, :32] for a in t], chunk=16)
    h2, _ = ops.mlstm_chunked(*[a[:, 32:] for a in t], state=st, chunk=16)
    jst = tuple(jnp.asarray(x.numpy()) for x in st)
    eh2, _ = jops._mlstm_chunked_jnp(jq[:, 32:], jk[:, 32:], jv[:, 32:],
                                     jlf[:, 32:], jli[:, 32:], jst, chunk=16)
    _close(h2, eh2)


def test_mlstm_dispatch_on_cpu():
    """CPU tensors: a stateless call whose S the chunk (min(128, S))
    divides is the chunked form; any other S is the oracle; a one-step call
    with a state is the oracle, as in the reference."""
    for s, plain in ((12, "chunked"), (256, "chunked"), (200, "oracle")):
        _, t = _inputs((2, s, 2, 16), seed=s)
        h, (c, n, m) = ops.mlstm(*t)
        eh, (ec, en, em) = (ops.mlstm_chunked(*t, chunk=min(128, s))
                            if plain == "chunked" else ref.mlstm(*t))
        for a, b in ((h, eh), (c, ec), (n, en), (m, em)):
            assert torch.equal(a, b), (s, plain)
    _, t = _inputs((2, 1, 2, 16), seed=3)
    _, state = ref.mlstm(*_inputs((2, 5, 2, 16), seed=4)[1])
    h, new = ops.mlstm(*t, state=state)
    eh, enew = ref.mlstm(*t, *state)
    assert torch.equal(h, eh) and all(torch.equal(a, b)
                                      for a, b in zip(new, enew))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _parts(x, split):
    """x as the f32 operand reaches the tensor cores: bf16(x), plus
    bf16(x - bf16(x)) when split."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _mlstm_tensor_core_rounding(q, k, v, log_f, log_i, chunk, split=True):
    """The bf16 CUDA kernel's rounding in plain torch: ``mlstm_chunked`` with
    every product taken as bf16 operands summed in f32. q k^T is one product
    (q and k are bf16 already) scaled by d^-0.5 after it; the f32 operands
    (the weights w o q k^T, the state C, K' = k d^-0.5 src_coeff) enter as
    the hi / lo pair, each pair's products summed; row sums, q . n, the
    gates and n stay f32."""
    b, s, h, d = q.shape
    nc = s // chunk
    scale = d ** -0.5

    def chunks(x):
        x = x.float().transpose(1, 2)
        return x.reshape((b, h, nc, chunk) + x.shape[3:])

    qf, kf, vf = chunks(q), chunks(k), chunks(v)
    lf, li = chunks(log_f), chunks(log_i)
    C = torch.zeros((b, h, d, d))
    n = torch.zeros((b, h, d))
    m = torch.full((b, h), ops.NEG_INF)
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    hs = []
    for i in range(nc):
        qc, kc, vc = qf[:, :, i], kf[:, :, i], vf[:, :, i]
        F = ops._cumsum(lf[:, :, i])
        src = li[:, :, i] - F
        m_t = F + torch.maximum(m[..., None], torch.cummax(src, -1).values)
        w = torch.exp(torch.where(causal, F[..., :, None] + src[..., None, :]
                                  - m_t[..., :, None], ops.NEG_INF))
        ws = w * (torch.einsum("bhtd,bhud->bhtu", qc, kc) * scale)
        intra = sum(torch.einsum("bhtu,bhud->bhtd", p, vc)
                    for p in _parts(ws, split))
        cc = torch.exp(F + m[..., None] - m_t)
        inter = sum(torch.einsum("bhtd,bhdk->bhtk", qc, p)
                    for p in _parts(C, split))
        den = torch.einsum("bhtd,bhd->bht", qc, n) * cc + ws.sum(-1)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        hs.append((inter * cc[..., None] + intra) / den[..., None])
        m_last, f_all = m_t[..., -1], F[..., -1]
        stc = torch.exp(f_all + m - m_last)
        kp = kc * scale * torch.exp(f_all[..., None] + src
                                    - m_last[..., None])[..., None]
        C = C * stc[..., None, None] + sum(
            torch.einsum("bhud,bhuk->bhdk", p, vc) for p in _parts(kp, split))
        n = n * stc[..., None] + kp.sum(-2)
        m = m_last
    out = torch.stack(hs, 2).reshape(b, h, s, d).transpose(1, 2)
    return out.to(q.dtype), (C.to(q.dtype), n.to(q.dtype), m)


def _worst_over_bound(split):
    """Largest |emulation - mlstm_chunked| / (8e-3 + 8e-3 |mlstm_chunked|)
    over h, C and n on bf16 inputs over 8 chunks of 64, and max |m - m|."""
    _, t = _inputs((1, 512, 2, 128), seed=10, dtype="bfloat16")
    eh, (ec, en, em) = _mlstm_tensor_core_rounding(*t, 64, split=split)
    ph, (pc, pn, pm) = ops.mlstm_chunked(*t, chunk=64)
    worst = max(((a.float() - p.float()).abs()
                 / (BF16_TOL + BF16_TOL * p.float().abs())).max().item()
                for a, p in ((eh, ph), (ec, pc), (en, pn)))
    return worst, (em - pm).abs().max().item()


def test_tensor_core_rounding_stays_within_one_bf16_ulp():
    """The numerics the bf16 CUDA kernel is built on: with the hi / lo split
    of its f32 operands, h, C and n stay within chip_smoke.py's atol = rtol
    = 8e-3 of the plain version (measured 0.69 of the bound), and m is the
    same."""
    worst, dm = _worst_over_bound(split=True)
    assert worst <= 1.0 and dm == 0.0, (worst, dm)


def test_one_bf16_rounding_of_the_f32_operands_is_not_enough():
    """Without the split (w o q k^T, C and K' each rounded to bf16 once), h
    leaves the 8e-3 bound (measured 3.5 x it): the reason the kernel pays
    for the second product."""
    worst, _ = _worst_over_bound(split=False)
    assert worst > 1.0, worst


def test_hillis_steele_cumsum_is_a_prefix_sum():
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 2, 128)).astype(np.float32))
    for n in (1, 12, 64, 128):
        torch.testing.assert_close(ops._cumsum(x[..., :n]),
                                   torch.cumsum(x[..., :n], -1),
                                   atol=1e-5, rtol=1e-6)


def test_kernel_backward_is_autograd_through_the_plain_version(monkeypatch):
    """The kernel's autograd wiring on the CPU: with the launch replaced by
    the plain version (the card runs the kernel there), gradients through
    ``_MLSTMFunction`` equal autograd through ``mlstm_chunked`` exactly,
    for losses on h alone and on h and the final state; and they match the
    reference's gradient through ``_mlstm_chunked_jnp`` (f32; measured
    6.8e-7 of the largest gradient, held to 1e-5 of it)."""
    def plain_launch(q, k, v, log_f, log_i, chunk):
        h, (c, n, m) = ops.mlstm_chunked(q, k, v, log_f, log_i, chunk=chunk)
        return h, c, n, m

    monkeypatch.setattr(kmlstm, "_launch", plain_launch)
    j, t = _inputs((2, 64, 2, 16), seed=6)
    g = np.random.default_rng(7).normal(size=(2, 64, 2, 16)).astype(
        np.float32)

    def grads(fn, with_state):
        xs = [a.clone().requires_grad_(True) for a in t]
        h, (c, n, m) = fn(*xs)
        loss = (h * torch.from_numpy(g)).sum()
        if with_state:
            loss = loss + c.square().sum() + n.sum() + m.sum()
        loss.backward()
        return [x.grad for x in xs]

    for with_state in (False, True):
        got = grads(lambda *x: _MLSTM(*x, chunk=16), with_state)
        exp = grads(lambda *x: ops.mlstm_chunked(*x, chunk=16), with_state)
        for a, b in zip(got, exp):
            assert torch.equal(a, b)

    def jloss(*xs):
        h, _ = jops._mlstm_chunked_jnp(*xs, chunk=16)
        return jnp.sum(h * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*j)
    for a, b in zip(grads(lambda *x: _MLSTM(*x, chunk=16), False), jgrads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def _MLSTM(q, k, v, log_f, log_i, chunk):
    """The kernel wrapper's autograd path without its CUDA checks."""
    h, c, n, m = kmlstm._MLSTMFunction.apply(q, k, v, log_f, log_i, chunk)
    return h, (c, n, m)


# ------------------------------------------------------------ the blocks

ARCH = "xlstm-350m"
# f32 at reduced width (d_model 64, mLSTM head dim 32, sLSTM head dim 16):
# XLA's and torch's f32 matmuls and reductions round differently; measured
# max 2.0e-6 (apply) and 3.8e-6 (the sLSTM decode's state) on values of
# order 1, held to 1e-5
BLOCK_TOL = 1e-5


def _block_pair(kind):
    """The first layer of ``kind`` of reduced xlstm-350m: (jax config,
    params; port config, params)."""
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    unit = jcfg.segments[0][0]
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jblock = jax.tree.map(lambda a: a[0],
                          jparams["segments"]["seg0"][str(unit.index(kind))])
    return jcfg, jblock, cfg, params_from_numpy(jax.device_get(jblock),
                                                device="cpu")


BLOCKS = {
    "mlstm": (jxlstm.apply_mlstm_block, xlstm.apply_mlstm_block),
    "slstm": (jxlstm.apply_slstm_block, xlstm.apply_slstm_block),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_apply_block_matches_reference(kind):
    """S = 48: the mLSTM runs one 48-step chunk on both sides."""
    jcfg, jblock, cfg, block = _block_pair(kind)
    x = np.random.default_rng(8).normal(size=(2, 48, cfg.d_model)).astype(
        np.float32)
    japply, apply = BLOCKS[kind]
    exp = japply(jcfg, jblock, jnp.asarray(x))
    out = apply(cfg, block, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=BLOCK_TOL,
                               rtol=0)


DECODE = {
    "mlstm": (jxlstm.init_mlstm_cache, jxlstm.decode_mlstm_block,
              xlstm.init_mlstm_cache, xlstm.decode_mlstm_block),
    "slstm": (jxlstm.init_slstm_cache, jxlstm.decode_slstm_block,
              xlstm.init_slstm_cache, xlstm.decode_slstm_block),
}


@pytest.mark.parametrize("kind", sorted(DECODE))
def test_decode_block_matches_reference(kind):
    """A prefill-style call over 20 tokens from a fresh cache (the mLSTM's
    chunked form with a state), then three one-token steps (its oracle):
    outputs and every cached state tensor agree, and the port updates its
    cache tensors in place."""
    jcfg, jblock, cfg, block = _block_pair(kind)
    jinit, jdecode, init, decode = DECODE[kind]
    jcache = jinit(jcfg, 2)
    cache = init(cfg, 2, device="cpu")
    bufs = [leaf for _, leaf in _leaves(cache)]
    rng = np.random.default_rng(9)
    for s in (20, 1, 1, 1):
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        exp, jcache = jdecode(jcfg, jblock, jnp.asarray(x), jcache)
        out, cache = decode(cfg, block, torch.from_numpy(x), cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(exp),
                                   atol=BLOCK_TOL, rtol=0)
        jl = dict(_leaves(jax.device_get(jcache)))
        for name, leaf in _leaves(cache):
            np.testing.assert_allclose(leaf.numpy(), jl[name],
                                       atol=BLOCK_TOL, rtol=0, err_msg=name)
    assert all(a is b for a, b in zip(bufs, (v for _, v in _leaves(cache))))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, tuple):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]
