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

# (B, S, H, D), chunk: the reference's kernel-test shapes
# (tests/test_kernels.py) and xlstm-350m's head dim 512
CASES = [((1, 128, 2, 32), 64), ((2, 256, 1, 64), 128), ((1, 192, 4, 16), 64),
         ((1, 256, 1, 512), 128)]
# the reference's kernel-test tolerances for h and C (and n), 1e-5 for m;
# measured here: h 6.3e-5 (D = 512, outputs up to ~20), C 1.4e-6, m 9.5e-7
ATOL, RTOL, M_TOL = 5e-4, 1e-3, 1e-5

PLAIN = {
    "chunked": lambda q, k, v, lf, li, chunk: ops.mlstm_chunked(
        q, k, v, lf, li, chunk=chunk),
    "oracle": lambda q, k, v, lf, li, chunk: ref.mlstm(q, k, v, lf, li),
}


def _inputs(shape, seed=0):
    """q, k, v normal; log_f = log(U(0.85, 0.999)), log_i = 0.5 N(0, 1), as
    the reference's kernel tests draw them. -> (jax arrays, tensors)."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    arrs.append(np.log(rng.uniform(0.85, 0.999, (b, s, h))).astype(
        np.float32))
    arrs.append((rng.normal(size=(b, s, h)) * 0.5).astype(np.float32))
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(out, exp, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(exp, np.float32), atol=atol,
                               rtol=rtol)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's three versions on the case's inputs (computed once
    for both plain versions of the port)."""
    shape, chunk = case
    j, _ = _inputs(shape)
    return {
        "pallas": mlstm_pallas(*j, chunk=chunk, interpret=True),
        "chunked_jnp": jops._mlstm_chunked_jnp(*j, chunk=chunk),
        "oracle": jref.mlstm(*j),
    }


@pytest.mark.parametrize("plain", sorted(PLAIN))
@pytest.mark.parametrize("case", CASES)
def test_plain_mlstm_matches_reference(case, plain):
    shape, chunk = case
    _, t = _inputs(shape)
    h, (c, n, m) = PLAIN[plain](*t, chunk)
    assert h.shape == shape and c.shape == shape[:1] + shape[2:3] + (
        shape[3], shape[3]) and m.dtype == torch.float32
    for name, (eh, (ec, en, em)) in _reference(case).items():
        _close(h, eh)
        _close(c, ec)
        _close(n, en)
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
