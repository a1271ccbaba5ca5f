"""The port's checkpoint serializer against the reference's: byte-identical
payloads and manifests, restore across packages in both directions, and the
reference's leaf names for a training-layout state."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.registry import build_model as jbuild_model
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWState


def _numpy_state(seed=0):
    """A training-layout state in numpy: f32 and bf16 params, quantizable
    f32 moments (one of them not a whole number of blocks), int32 steps."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 0.02, s).astype(np.float32)
    params = {"w": f32(64, 96), "b": f32(96),
              "emb": f32(40, 66).astype(ml_dtypes.bfloat16)}
    moment = lambda: {"w": f32(64, 96), "b": f32(96),
                      "emb": f32(40, 66)}
    return {"params": params,
            "opt_state": JAdamWState(step=np.asarray(7, np.int32),
                                     m=moment(), v=moment()),
            "data": {"step": np.asarray(13, np.int32)}}


def _jax_tree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("quantize", [False, True])
def test_payloads_and_manifest_byte_identical(quantize):
    state = _numpy_state()
    jpolicy = jser.default_quant_policy if quantize else None
    policy = ser.default_quant_policy if quantize else None
    jpay, jman = jser.serialize_tree(_jax_tree(state), jpolicy)
    pay, man = ser.serialize_tree(params_from_numpy(state, device="cpu"),
                                  policy)
    assert list(pay) == list(jpay)
    for name in jpay:
        assert pay[name] == jpay[name], name
    assert ser.manifest_bytes(man) == jser.manifest_bytes(jman)
    quantized = [m["name"] for m in man["leaves"] if m["quant"]]
    # f32 2-D moments quantize (40*66 pads to two blocks); bf16 params and
    # 1-D leaves stay raw
    assert quantized == ([] if not quantize else
                         ["opt_state/.m/emb", "opt_state/.m/w",
                          "opt_state/.v/emb", "opt_state/.v/w"])


def test_jax_checkpoint_restores_in_torch():
    state = _numpy_state(1)
    jpay, jman = jser.serialize_tree(_jax_tree(state),
                                     jser.default_quant_policy)
    target = params_from_numpy(_numpy_state(2), device="cpu")
    out = ser.deserialize_tree(target, jpay, jman)
    assert isinstance(out["opt_state"], AdamWState)
    exp = jser.deserialize_tree(_jax_tree(state), jpay, jman)
    exp_leaves = dict(jser.tree_paths(exp))
    for name, leaf in ser.tree_paths(out):
        want = np.asarray(exp_leaves[name])
        assert _to_numpy(leaf).dtype == want.dtype, name
        np.testing.assert_array_equal(_to_numpy(leaf), want, err_msg=name)
    # and both are the source state: raw leaves exactly, moments within
    # half a quantization step (max|x| / 254) plus f32 slack
    np.testing.assert_array_equal(_to_numpy(out["params"]["emb"]),
                                  state["params"]["emb"])
    for name in ("w", "emb"):
        src = state["opt_state"].m[name]
        err = np.abs(_to_numpy(out["opt_state"].m[name]) - src)
        assert err.max() <= np.abs(src).max() / 254 * (1 + 1e-4)


def test_torch_checkpoint_restores_in_jax():
    state = _numpy_state(3)
    pay, man = ser.serialize_tree(params_from_numpy(state, device="cpu"),
                                  ser.default_quant_policy)
    jtarget = _jax_tree(_numpy_state(4))
    out = jser.deserialize_tree(jtarget, pay, jser.manifest_from_bytes(
        ser.manifest_bytes(man)))
    exp = ser.deserialize_tree(params_from_numpy(state, device="cpu"), pay,
                               man)
    exp_leaves = dict(ser.tree_paths(exp))
    for name, leaf in jser.tree_paths(out):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      _to_numpy(exp_leaves[name]),
                                      err_msg=name)
    # raw leaves are bit-exact to the source state
    np.testing.assert_array_equal(np.asarray(out["params"]["emb"]),
                                  state["params"]["emb"])


def test_leaf_names_match_reference_train_state():
    cfg = jreduced(jget_config("starcoder2-3b"))
    params = jbuild_model(cfg).init(jax.random.PRNGKey(0))
    opt = JAdamW(lr=lambda s: 1e-3).init(params)
    jstate = {"params": params, "opt_state": opt,
              "data": {"step": jnp.asarray(0, jnp.int32)}}
    state = params_from_numpy(jax.device_get(jstate), device="cpu")
    names = [n for n, _ in ser.tree_paths(state)]
    assert names == [n for n, _ in jser.tree_paths(jstate)]
    assert len(names) == 41
    assert names[:2] == ["data/step", "opt_state/.step"]
    assert "opt_state/.m/segments/seg0/0/attn/wq" in names
    assert "params/segments/seg0/0/norm1/bias" in names


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-4b",
                                  "recurrentgemma-9b", "deepseek-coder-33b",
                                  "h2o-danube-1.8b"])
def test_param_tree_matches_reference_through_serializer(arch):
    """The port's own params of a reduced config have the reference's leaf
    names, shapes and dtypes, and the reference's params carried into the
    port serialize to the reference's payloads and manifest."""
    jparams = jbuild_model(jreduced(jget_config(arch))).init(
        jax.random.PRNGKey(0))
    params = build_model(reduced(get_config(arch))).init(0, device="cpu")
    jleaves = jser.tree_paths(jparams)
    assert [(n, tuple(t.shape), ser.dtype_name(t.dtype))
            for n, t in ser.tree_paths(params)] == \
        [(n, tuple(a.shape), str(a.dtype)) for n, a in jleaves]
    jpay, jman = jser.serialize_tree(jparams)
    pay, man = ser.serialize_tree(
        params_from_numpy(jax.device_get(jparams), device="cpu"))
    assert ser.manifest_bytes(man) == jser.manifest_bytes(jman)
    assert pay == jpay


@pytest.mark.parametrize("quantize", [False, True])
def test_short_payload_raises(quantize):
    """A payload shorter than its metadata implies (a read cut short)
    raises instead of coming back as an uninitialized tensor; a zero-size
    leaf's empty payload restores as an empty tensor."""
    leaf = torch.arange(4096, dtype=torch.float32).reshape(2, 2048)
    data, meta = ser.serialize_leaf(leaf, quantize)
    for cut in (b"", data[:-4]):
        with pytest.raises(ValueError, match="expected"):
            ser.deserialize_leaf(cut, meta)
    empty, emeta = ser.serialize_leaf(torch.zeros((0,)), False)
    assert empty == b""
    assert ser.deserialize_leaf(empty, emeta).shape == (0,)
