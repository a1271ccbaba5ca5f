"""The port's ``BBCheckpointManager`` (``repro_torch/checkpoint/bbckpt.py``)
as the reference's manager tests in ``tests/test_checkpoint.py`` hold
``repro/checkpoint/bbckpt.py``: a save / restore round trip, the latest of
several saves with retention evicting the oldest, and a restore of an
evicted checkpoint from the PFS (staged back into the buffer). Torch trees
on the CPU; the same code runs on the card in ``chip_smoke.py``'s
restarts."""
import numpy as np
import torch

from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import BBCheckpointManager
from repro_torch.core import BBConfig, BurstBufferSystem


def _tree(seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dtype)
    return {
        "params": {"w": t(64, 32), "b": t(32)},
        "opt_state": {"m": t(64, 32),
                      "step": torch.tensor(7, dtype=torch.int32)},
        "data": {"step": torch.tensor(13, dtype=torch.int32)},
    }


def _assert_equal(out, exp):
    got, want = ser.tree_paths(out), ser.tree_paths(exp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _system():
    return BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                      dram_capacity=64 << 20))


def test_manager_save_restore_roundtrip():
    with _system() as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        tree = _tree(1)
        mgr.save(5, tree, blocking_flush=True)
        restored, step = mgr.restore(_tree(99))
        assert step == 5
        _assert_equal(restored, tree)


def test_restore_latest_of_many_and_retention():
    with _system() as bb:
        mgr = BBCheckpointManager(bb, quantize=False, retention=2)
        for step in (1, 2, 3):
            mgr.save(step, _tree(step), blocking_flush=True)
        assert sorted(mgr.saved_steps) == [2, 3]     # retention evicted 1
        restored, step = mgr.restore(_tree(0))
        assert step == 3
        _assert_equal(restored, _tree(3))


def test_restore_from_pfs_after_eviction():
    """Evicted epochs are durably on the PFS; restore falls back there."""
    with _system() as bb:
        mgr = BBCheckpointManager(bb, quantize=False, retention=1)
        mgr.save(1, _tree(1), blocking_flush=True)
        mgr.save(2, _tree(2), blocking_flush=True)
        assert mgr.saved_steps == [2]
        restored, step = mgr.restore(_tree(0), step=1)   # evicted from BB
        assert step == 1
        _assert_equal(restored, _tree(1))
