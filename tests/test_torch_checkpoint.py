"""The port's ``BBCheckpointManager`` (``repro_torch/checkpoint/bbckpt.py``)
as the reference's manager tests in ``tests/test_checkpoint.py`` hold
``repro/checkpoint/bbckpt.py``: a save / restore round trip, the latest of
several saves with retention evicting the oldest, and a restore of an
evicted checkpoint from the PFS (staged back into the buffer); and, the
port's own, a flush that waits until its epoch is durable, a save that
writes each leaf as it serializes it, a restore that reads each leaf as it
rebuilds it, and ``chip_smoke.py``'s wait for the buffer to handle a
server's loss before a restore. Torch trees on the CPU; the same code runs
on the card in ``chip_smoke.py``'s restarts."""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
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


def test_flush_waits_until_the_epoch_is_durable():
    """A flush waits ``FLUSH_TIMEOUT_S`` for its epoch, past the system's own
    default of 30 s (a 12.95 GB checkpoint outlasts it): the manager asks
    the system for that wait in both the async and the blocking flush,
    records ``flushed``, and the PFS holds both files byte for byte."""
    import os
    from repro_torch.checkpoint.bbckpt import FLUSH_TIMEOUT_S
    with _system() as bb:
        real_flush, waits = bb.flush, []

        def flush(epoch, timeout=30.0):
            waits.append(timeout)
            return real_flush(epoch, timeout=timeout)

        bb.flush = flush
        mgr = BBCheckpointManager(bb, quantize=False)
        tree = _tree(3)
        mgr.save(4, tree)
        mgr.wait_flushes(timeout=60.0)
        assert waits == [FLUSH_TIMEOUT_S] and FLUSH_TIMEOUT_S > 30.0
        assert mgr.metrics[4]["flushed"] is True
        assert bb.manager.flush_complete(4)
        for name in ("ckpt_00000004", "ckpt_00000004.manifest"):
            assert os.path.exists(os.path.join(bb.pfs_dir, name)), name
        mgr.save(5, tree, blocking_flush=True)
        assert waits == [FLUSH_TIMEOUT_S] * 2
        assert mgr.metrics[5]["flushed"] is True
        restored, step = mgr.restore(_tree(99), step=4)
        _assert_equal(restored, tree)


def test_restore_reads_each_leaf_as_it_rebuilds_it(monkeypatch):
    """The restore holds one leaf's payload at a time: each leaf's read is
    followed by that leaf's rebuild before the next read (the reference
    reads every payload first, which for a 12.95 GB checkpoint is as much
    host memory again)."""
    from repro_torch.checkpoint import bbckpt
    events = []
    read = bbckpt._LeafReads.__getitem__
    rebuild = ser.deserialize_leaf

    def logged_read(self, name):
        events.append(("read", name))
        return read(self, name)

    def logged_rebuild(payload, meta, device="cpu"):
        events.append(("rebuild", meta["name"]))
        return rebuild(payload, meta, device=device)

    monkeypatch.setattr(bbckpt._LeafReads, "__getitem__", logged_read)
    monkeypatch.setattr(ser, "deserialize_leaf", logged_rebuild)
    with _system() as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        tree = _tree(2)
        mgr.save(3, tree, blocking_flush=True)
        restored, _ = mgr.restore(_tree(0))
    _assert_equal(restored, tree)
    names = [n for n, _ in ser.tree_paths(tree)]
    assert events == [(kind, n) for n in names
                      for kind in ("read", "rebuild")]


def test_save_writes_each_leaf_as_it_serializes_it(monkeypatch):
    """The save holds one leaf's payload at a time: each leaf is written
    before the next is serialized (the reference serializes the whole tree
    first), at the offsets and with the manifest ``serialize_tree`` gives,
    and the checkpoint restores bit for bit."""
    from repro_torch.core import filesystem
    events = []
    serialize = ser.serialize_leaf
    pwrite = filesystem.BBFile.pwrite

    def logged_serialize(leaf, quantize):
        data, meta = serialize(leaf, quantize)
        events.append(("serialize", len(data)))
        return data, meta

    def logged_pwrite(self, data, offset):
        if self.path == "ckpt_00000006":      # not the manifest's file
            events.append(("write", offset))
        return pwrite(self, data, offset)

    tree = _tree(4)
    _, manifest = ser.serialize_tree(tree)
    monkeypatch.setattr(ser, "serialize_leaf", logged_serialize)
    monkeypatch.setattr(filesystem.BBFile, "pwrite", logged_pwrite)
    with _system() as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        mgr.save(6, tree, blocking_flush=True)
        with bb.fs().open("ckpt_00000006.manifest", "r") as mf:
            saved = ser.manifest_from_bytes(mf.read())
        restored, _ = mgr.restore(_tree(0))
    _assert_equal(restored, tree)
    assert saved == manifest
    assert events == [e for m in manifest["leaves"] for e in
                      (("serialize", m["nbytes"]), ("write", m["offset"]))]


def test_settle_after_kill_waits_for_the_failure_to_be_handled():
    """``chip_smoke.settle_after_kill`` returns once the manager counts the
    killed server dead and the survivors' queues have stayed empty (their
    re-replication absorbed); the restore that follows reads the checkpoint
    back bit for bit from the replicas."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=0.1)) as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        tree = _tree(5)
        mgr.save(2, tree, blocking_flush=True)
        bb.kill_server("server/0")
        waited = chip_smoke.settle_after_kill(bb, "server/0")
        assert waited is not None and waited >= chip_smoke.SETTLE_QUIET_S
        assert "server/0" in bb.manager.dead
        assert all(srv.ep.inbox.empty() for name, srv in bb.servers.items()
                   if name != "server/0")
        restored, step = BBCheckpointManager(bb).restore(_tree(0))
    assert step == 2
    _assert_equal(restored, tree)


@pytest.mark.parametrize("cadence", ["default", "serving"])
def test_a_stalled_server_is_declared_dead_only_at_the_default_cadence(
        cadence):
    """A server whose loop stalls for 7 s (as while the flush writes its
    domain of a large checkpoint) misses its predecessor's pings: at the
    buffer's default cadence (0.25 s) it is declared dead, and its peers
    re-replicate; at ``chip_smoke.SERVE_STABILIZE_S``, the serving
    restarts' cadence, it is not."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    interval = chip_smoke.SERVE_STABILIZE_S if cadence == "serving" \
        else BBConfig.stabilize_interval
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=interval)) as bb:
        srv = bb.servers["server/1"]
        dispatch, stalled = srv._dispatch, []

        def stall_once(msg):
            if msg.kind == "ping" and not stalled:
                stalled.append(msg)
                time.sleep(7.0)
            return dispatch(msg)

        srv._dispatch = stall_once
        deadline = time.monotonic() + 3 * interval + 1.0
        while time.monotonic() < deadline and not stalled:
            time.sleep(0.05)
        assert stalled
        # the stall, and 2 s for the failure report to reach the manager
        deadline = time.monotonic() + 9.0
        while time.monotonic() < deadline \
                and "server/1" not in bb.manager.dead:
            time.sleep(0.1)
        assert ("server/1" in bb.manager.dead) == (cadence == "default")
