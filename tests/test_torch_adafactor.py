"""The port's Adafactor and int8 gradient compression against the
reference's (``repro/optim/adafactor.py``, ``repro/optim/grad.py``) on the
CPU, from the same numpy inputs: the factored state's layout leaf for
leaf, three updates on a stacked tree, the reference's own optimizer tests
(``tests/test_optim.py``) in the port, and an Adafactor train state through
the checkpoint bridge (the reference's payloads restore in the port bit for
bit; the port's payloads equal the reference's byte for byte, quantized and
not, the zero-size ``vc`` leaves included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.registry import build_model as jbuild_model
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.adafactor import AdafactorState as JAdafactorState
from repro.optim.grad import compress_error_feedback as jcompress_ef
from repro.optim.grad import compress_int8 as jcompress
from repro.optim.grad import decompress_int8 as jdecompress
from repro.optim.schedule import constant as jconstant
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.registry import build_model
from repro_torch.optim.adafactor import Adafactor, AdafactorState
from repro_torch.optim.grad import (compress_error_feedback, compress_int8,
                                    decompress_int8)
from repro_torch.optim.schedule import constant
from repro_torch.runtime.train_step import make_optimizer

ARCH = "deepseek-coder-33b"
# reduced width of the train states below: wide enough that the quant
# policy (ndim >= 2, a whole 2048-element block) takes vr and vc leaves too
# (wq's vr (1, 512, 4) and vc (1, 512, 16)), not only m
D_MODEL = 512


def _cfgs():
    return (jreduced(jget_config(ARCH), d_model=D_MODEL),
            reduced(get_config(ARCH), d_model=D_MODEL))


def _stacked_tree(seed):
    """A stacked-segment tree of every leaf kind Adafactor factors or not:
    a 4-D (L, d, H, hd) projection (vr (L, d, H), vc (L, d, hd)), a stacked
    (L, d) norm scale (vr (L,), vc (d,)), a 1-D final scale (unfactored, a
    (0,) vc) and a 2-D embedding."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"segments": {"seg0": {"wq": f32(2, 8, 4, 6),
                                  "scale": f32(2, 8)}},
            "final_norm": {"scale": f32(8)}, "embed": f32(40, 8)}


def _np(tree):
    """{path: float32 numpy} of a torch or jax tree (bf16 upcast)."""
    out = {}
    for name, leaf in ser.tree_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = params_from_numpy(np.asarray(leaf), device="cpu")
        out[name] = leaf.float().numpy()
    return out


def test_adafactor_factored_shapes():
    """The port's counterpart of the reference's test of the same name."""
    opt = Adafactor(lr=constant(0.01), momentum=0.9)
    p = {"w": torch.zeros((8, 16)), "b": torch.zeros((16,))}
    st = opt.init(p)
    assert st.vr["w"].shape == (8,)
    assert st.vc["w"].shape == (16,)
    assert st.vr["b"].shape == (16,)       # unfactored fallback
    assert st.vc["b"].shape == (0,)
    assert st.m["w"].dtype == torch.bfloat16
    assert st.step.dtype == torch.int32


def test_adafactor_converges_quadratic():
    """The port's counterpart of the reference's test of the same name:
    200 steps on f(w) = |w|^2 from 3.0 reach |w| < 0.05."""
    opt = Adafactor(lr=constant(0.2), momentum=0.0, weight_decay=0.0)
    p = {"w": torch.full((4, 4), 3.0)}
    state = opt.init(p)
    for _ in range(200):
        p, state = opt.update({"w": 2 * p["w"]}, state, p)
    assert float(p["w"].abs().max()) < 0.05


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_state_layout_matches_reference(momentum):
    """Reduced deepseek-coder-33b's params: the port's zero state has the
    reference's leaf paths, shapes and dtypes, leaf for leaf: factored over
    the trailing two dims of each stacked leaf (the stacked (L, d) norm
    scales too), a (0,) vc for the 1-D final norm, a bf16 m (a (0,) f32
    sentinel without momentum) and an int32 step."""
    jcfg, cfg = _cfgs()
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = build_model(cfg).init(0, device="cpu")
    jst = JAdafactor(lr=jconstant(1e-3), momentum=momentum).init(jparams)
    st = Adafactor(lr=constant(1e-3), momentum=momentum).init(params)
    got = [(n, tuple(t.shape), ser.dtype_name(t.dtype))
           for n, t in ser.tree_paths(st)]
    assert got == [(n, tuple(a.shape), str(a.dtype))
                   for n, a in jser.tree_paths(jst)]
    names = dict((n, s) for n, s, _ in got)
    assert names[".step"] == ()
    assert names[".vc/final_norm/scale"] == (0,)
    assert names[".vr/segments/seg0/0/attn/wq"] == (1, D_MODEL,
                                                    cfg.num_heads)
    assert names[".vc/segments/seg0/0/attn/wq"] == (1, D_MODEL,
                                                    cfg.resolved_head_dim)
    assert names[".vr/segments/seg0/0/norm1/scale"] == (1,)
    assert names[".vc/segments/seg0/0/norm1/scale"] == (D_MODEL,)
    assert all(not torch.any(t) for _, t in ser.tree_paths(st))


# three updates from identical params, grads and state. f32 leaves (params,
# vr, vc): the means over rows and columns sum in other orders, measured up
# to 1.9e-7 relative on vr and 1e-9 on params; held to rtol 2e-6 with an
# atol of 1e-9 for elements near 0. m is bf16, rounded once from f32 values
# that agree as closely, so within one bf16 ulp: rtol 2^-7, atol 0
F32_RTOL, F32_ATOL, BF16_RTOL = 2e-6, 1e-9, 2.0 ** -7


@pytest.mark.parametrize("momentum,weight_decay",
                         [(0.9, 0.0), (0.0, 0.1), (0.9, 0.1)],
                         ids=["momentum", "no-momentum-decay",
                              "momentum-decay"])
def test_adafactor_updates_match_reference(momentum, weight_decay):
    params = _stacked_tree(0)
    jopt = JAdafactor(lr=jconstant(1e-2), momentum=momentum,
                      weight_decay=weight_decay)
    opt = Adafactor(lr=constant(1e-2), momentum=momentum,
                    weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    p = params_from_numpy(params, device="cpu")
    st = opt.init(p)
    for k in range(3):
        grads = _stacked_tree(10 + k)
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp)
        p, st = opt.update(params_from_numpy(grads, device="cpu"), st, p)
        assert isinstance(st, AdafactorState)
        assert st.step.dtype == torch.int32 and st.step.item() == k + 1
        exp = _np(jax.device_get({"p": jp, "s": jst}))
        got = _np({"p": p, "s": st})
        assert list(got) == list(exp)
        for name, leaf in got.items():
            assert leaf.shape == exp[name].shape, name
            if name.startswith("s/.m/"):
                np.testing.assert_allclose(leaf, exp[name], rtol=BF16_RTOL,
                                           atol=0, err_msg=name)
            else:
                np.testing.assert_allclose(leaf, exp[name], rtol=F32_RTOL,
                                           atol=F32_ATOL, err_msg=name)
    if not momentum:
        assert all(t.shape == (0,) for _, t in ser.tree_paths(st.m))
    assert st.vc["final_norm"]["scale"].shape == (0,)


def test_weight_decay_only_on_matrices():
    """A zero gradient from a zero state: decay moves the leaves of ndim
    >= 2 and leaves the 1-D scale as it was (the update itself is 0)."""
    opt = Adafactor(lr=constant(0.1), weight_decay=0.5)
    p = params_from_numpy(_stacked_tree(1), device="cpu")
    zeros = {"segments": {"seg0": {k: torch.zeros_like(v) for k, v in
                                   p["segments"]["seg0"].items()}},
             "final_norm": {"scale": torch.zeros(8)},
             "embed": torch.zeros_like(p["embed"])}
    out, _ = opt.update(zeros, opt.init(p), p)
    assert torch.equal(out["final_norm"]["scale"], p["final_norm"]["scale"])
    for leaf, before in ((out["embed"], p["embed"]),
                         (out["segments"]["seg0"]["scale"],
                          p["segments"]["seg0"]["scale"])):
        torch.testing.assert_close(leaf, before * (1 - 0.1 * 0.5),
                                   rtol=1e-6, atol=0)


def test_make_optimizer_picks_adafactor_as_the_reference_does():
    opt = make_optimizer(get_config(ARCH))
    assert isinstance(opt, Adafactor)
    assert opt.momentum == 0.9 and opt.momentum_dtype == "bfloat16"
    assert opt.lr(torch.tensor(100, dtype=torch.int32)).item() == \
        pytest.approx(1.5e-4)


# ------------------------------------------------------- int8 compression


def _grads(seed):
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(0, 0.02, (64, 96)).astype(np.float32),
         "b": rng.normal(0, 0.02, (96,)).astype(np.float32),
         "zero": np.zeros((5,), np.float32)}
    # exact ties: max|x| 127 gives a scale of 1.0, so x / scale lands on .5
    # and round-half-to-even decides (2.5 -> 2, 3.5 -> 4, -0.5 -> -0)
    g["ties"] = np.asarray([127.0, 2.5, 3.5, -0.5, -126.5, 0.0], np.float32)
    return g


def test_compress_int8_matches_reference():
    """The same int8 payload and per-leaf scales (0-d f32) bit for bit, an
    all-zero leaf at the 1e-12 floor, and the same decompression."""
    g = _grads(0)
    jq, js = jcompress(jax.tree.map(jnp.asarray, g))
    q, s = compress_int8(params_from_numpy(g, device="cpu"))
    for name in g:
        assert q[name].dtype == torch.int8 and s[name].shape == ()
        np.testing.assert_array_equal(q[name].numpy(), np.asarray(jq[name]),
                                      err_msg=name)
        assert s[name].item() == float(js[name]), name
    assert q["ties"].tolist() == [127, 2, 4, 0, -126, 0]
    assert s["zero"].item() == np.float32(1e-12 / np.float32(127.0))
    jx = jdecompress(jq, js)
    for name, leaf in decompress_int8(q, s).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jx[name]),
                                      err_msg=name)
    assert decompress_int8(q, s, torch.bfloat16)["w"].dtype == torch.bfloat16


def test_error_feedback_matches_reference():
    """Five rounds of compress_error_feedback: the same q, scales and
    residuals (f32 sums and products in one order: equal bits measured;
    the residuals held to 1e-9 absolute)."""
    g = _grads(1)
    jres = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, g))
    res = {k: torch.zeros_like(v) for k, v in
           params_from_numpy(g, device="cpu").items()}
    for _ in range(5):
        jq, js, jres = jcompress_ef(jax.tree.map(jnp.asarray, g), jres)
        q, s, res = compress_error_feedback(params_from_numpy(g,
                                                              device="cpu"),
                                            res)
        for name in g:
            np.testing.assert_array_equal(q[name].numpy(),
                                          np.asarray(jq[name]))
            assert s[name].item() == float(js[name])
            np.testing.assert_allclose(res[name].numpy(),
                                       np.asarray(jres[name]), rtol=0,
                                       atol=1e-9)


def test_int8_compression_error_feedback_converges():
    """The port's counterpart of the reference's test: error feedback keeps
    the long-run average unbiased (within 2e-3 after 40 rounds)."""
    g = {"w": torch.from_numpy(np.linspace(-1, 1, 64).astype(np.float32))}
    residual = {"w": torch.zeros(64)}
    acc = torch.zeros(64)
    n = 40
    for _ in range(n):
        q, s, residual = compress_error_feedback(g, residual)
        acc = acc + decompress_int8(q, s)["w"]
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(), atol=2e-3)


# ------------------------------------------------- the checkpoint bridge


def _jax_train_state():
    """Reduced deepseek-coder-33b's train-state layout in the reference:
    params and an AdafactorState two updates old (nonzero moments, a bf16
    m), and the data step."""
    jparams = jbuild_model(_cfgs()[0]).init(jax.random.PRNGKey(0))
    jopt = JAdafactor(lr=jconstant(1e-3), momentum=0.9)
    jst = jopt.init(jparams)
    for k in range(2):
        rng = np.random.default_rng(20 + k)
        grads = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(0, 0.02, a.shape), a.dtype), jparams)
        jparams, jst = jopt.update(grads, jst, jparams)
    return {"params": jparams, "opt_state": jst,
            "data": {"step": jnp.asarray(64, jnp.int32)}}


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() \
        if t.numel() else b""


def test_params_from_numpy_carries_an_adafactor_state():
    jstate = jax.device_get(_jax_train_state())
    state = params_from_numpy(jstate, device="cpu")
    assert isinstance(jstate["opt_state"], JAdafactorState)
    assert isinstance(state["opt_state"], AdafactorState)
    assert state["opt_state"].m["embed"]["tokens"].dtype == torch.bfloat16
    for (name, leaf), (jname, jleaf) in zip(ser.tree_paths(state),
                                            jser.tree_paths(jstate)):
        assert name == jname
        assert _bits(leaf) == np.asarray(jleaf).tobytes(), name


def test_reference_adafactor_checkpoint_restores_bit_for_bit():
    """Unquantized payloads of the reference's serializer, restored by the
    port's into a zero state of the port's own: every leaf bit for bit,
    the zero-size vc leaves as (0,)."""
    jstate = _jax_train_state()
    jpay, jman = jser.serialize_tree(jstate)
    cfg = _cfgs()[1]
    params = build_model(cfg).init(1, device="cpu")
    target = {"params": params, "opt_state": make_optimizer(cfg).init(params),
              "data": {"step": torch.zeros((), dtype=torch.int32)}}
    out = ser.deserialize_tree(target, jpay, jman)
    assert isinstance(out["opt_state"], AdafactorState)
    want = dict(jser.tree_paths(jax.device_get(jstate)))
    for name, leaf in ser.tree_paths(out):
        assert _bits(leaf) == np.asarray(want[name]).tobytes(), name
        assert tuple(leaf.shape) == want[name].shape, name
    assert out["opt_state"].vc["final_norm"]["scale"].shape == (0,)


@pytest.mark.parametrize("quantize", [False, True])
def test_adafactor_payloads_byte_identical(quantize):
    """The port's payloads and manifest for the same Adafactor train state
    equal the reference's, quantized (by the quant policy: the m, vr and vc
    leaves of ndim >= 2 and at least one block) and not."""
    jstate = _jax_train_state()
    state = params_from_numpy(jax.device_get(jstate), device="cpu")
    jpay, jman = jser.serialize_tree(
        jstate, jser.default_quant_policy if quantize else None)
    pay, man = ser.serialize_tree(
        state, ser.default_quant_policy if quantize else None)
    assert list(pay) == list(jpay)
    for name in jpay:
        assert pay[name] == jpay[name], name
    assert ser.manifest_bytes(man) == jser.manifest_bytes(jman)
    assert pay["opt_state/.vc/final_norm/scale"] == b""
    quantized = {m["name"].split("/")[1] for m in man["leaves"]
                 if m["quant"]}
    assert quantized == ({".m", ".vr", ".vc"} if quantize else set())
