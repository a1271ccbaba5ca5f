"""The serving restart end to end on the CPU, through both packages: a
training-layout state is saved with ``quantize=True`` into a burst buffer,
restored, and served. The port's run (its own ``repro_torch.core`` copy,
``BBCheckpointManager`` and ``serve_batch``) must restore the same params
and moments as the reference's and generate the same tokens; a restore
after a server is killed must return the same state."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.bbckpt import BBCheckpointManager as JManager
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import BBConfig as JBBConfig
from repro.core import BurstBufferSystem as JBurstBufferSystem
from repro.launch.serve import serve_batch as jserve_batch
from repro.models.registry import build_model as jbuild_model
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import BBConfig, BurstBufferSystem
from repro_torch.launch.serve import serve_batch
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW

ARCH = "starcoder2-3b"
STEP = 40


def _numpy_state(jparams, seed):
    """Params from the reference's init; random moments (a trained state's
    stand-in) so that quantization has work to do."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(jparams)
    moment = lambda scale: jax.tree.map(
        lambda p: (rng.normal(0, scale, p.shape)).astype(np.float32), params)
    return {"params": params,
            "opt_state": JAdamWState(step=np.asarray(STEP, np.int32),
                                     m=moment(1e-3), v=moment(1e-6)),
            "data": {"step": np.asarray(STEP * 8, np.int32)}}


def _leaves(tree):
    return {n: leaf.numpy() for n, leaf in ser.tree_paths(tree)}


def test_save_restore_serve_matches_reference():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    state = _numpy_state(jmodel.init(jax.random.PRNGKey(0)), seed=1)
    prompts = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 24))

    # the port: save -> restore -> serve, then restore again after a kill
    bbcfg = BBConfig(num_servers=4, num_clients=4, dram_capacity=64 << 20,
                     stabilize_interval=0.1)
    with BurstBufferSystem(bbcfg) as bb:
        mgr = BBCheckpointManager(bb, quantize=True)
        mgr.save(STEP, params_from_numpy(state, device="cpu"),
                 blocking_flush=True)
        fresh = model.init(7, device="cpu")
        target = {"params": fresh, "opt_state": AdamW(lr=None).init(fresh),
                  "data": {"step": torch.zeros((), dtype=torch.int32)}}
        restored, step = mgr.restore(target)
        assert step == STEP
        tokens = serve_batch(cfg, model, restored["params"],
                             torch.as_tensor(prompts), gen_tokens=6)

        bb.kill_server("server/1")
        time.sleep(1.0)               # stabilization + client updates
        for c in bb.clients:
            c.put_timeout = 0.8
        after_kill, _ = mgr.restore(target)

    # the reference, from the same numpy state
    with JBurstBufferSystem(JBBConfig(num_servers=4, num_clients=4,
                                      dram_capacity=64 << 20)) as jbb:
        jmgr = JManager(jbb, quantize=True)
        jstate = jax.tree.map(jnp.asarray, state)
        jmgr.save(STEP, jstate, blocking_flush=True)
        jrestored, _ = jmgr.restore(jstate)
        jtokens = jserve_batch(jcfg, jmodel, jrestored["params"],
                               jnp.asarray(prompts, jnp.int32), gen_tokens=6)

    got, after = _leaves(restored), _leaves(after_kill)
    want = {n: np.asarray(leaf) for n, leaf in
            ser.tree_paths(jax.device_get(jrestored))}
    assert list(got) == list(want)
    for name in want:
        # params bit-exact, moments equal after dequantize, steps equal
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(after[name], want[name], err_msg=name)
    src = dict(ser.tree_paths(state))
    for name in src:
        if name.startswith("params/"):
            np.testing.assert_array_equal(got[name], src[name], err_msg=name)
    # the moments went through int8: off the source by at most half a step
    m = "opt_state/.m/embed/tokens"
    err = np.abs(got[m] - src[m])
    assert 0 < err.max() <= np.abs(src[m]).max() / 254 * (1 + 1e-4)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


def test_serve_cli_runs_reduced_h2o_danube_on_cpu(capsys):
    """``--arch h2o-danube-1.8b --reduced --device cpu`` serves a prompt
    longer than the reduced sliding window (16) end to end."""
    from repro_torch.launch import serve
    serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "24", "--gen", "4",
                "--requests", "1"])
    out = capsys.readouterr().out
    assert "[serve] request-batch 0: (2, 4)" in out


@pytest.mark.parametrize("arch", ["whisper-large-v3", "starcoder2-3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_token_masks_the_padding_out_of_place(arch, dtype):
    """``greedy_token`` on plain tensors, bit for bit the reference's and
    the former in-place mask over a clone: whisper's vocab 51866 padded to
    51968 (the mask decides rows whose largest logit is a padding column)
    and starcoder2-3b's unpadded 49152; a tie (the first index wins), a
    row whose real logits are all -inf; the logits are left as they
    were."""
    from repro.runtime.serve_step import greedy_token as jgreedy_token
    from repro_torch.models.common import padded_vocab
    from repro_torch.runtime.serve_step import greedy_token
    cfg = get_config(arch)
    v, vp = cfg.vocab_size, padded_vocab(cfg)
    assert (vp != v) == (arch == "whisper-large-v3")
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((5, 1, vp))
                              .astype(np.float32))
    logits[0, 0, vp - 1] = 100.0          # a padding column (if any) on top
    logits[1, 0, 7] = logits[1, 0, 9] = 50.0          # a tie
    logits[2, 0, :v] = -torch.inf
    logits = logits.to(getattr(torch, dtype))
    before = logits.clone()
    got = greedy_token(cfg, logits)
    former = logits.clone()
    former[..., v:] = -torch.inf
    assert torch.equal(logits, before)
    assert got.dtype == torch.int32 and got.shape == (5, 1)
    assert torch.equal(got, torch.argmax(former, dim=-1).to(torch.int32))
    want = jgreedy_token(cfg, jnp.asarray(logits.float().numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 0] == 7 and got[2, 0] == 0
    if vp != v:
        assert got[0, 0] < v
