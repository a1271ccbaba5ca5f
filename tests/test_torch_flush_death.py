"""A flush is never counted durable while its PFS copy may lack a domain.

A server whose loop stalls while a flush ships its domain misses its
peers' pings at the buffer's default 0.25 s cadence and is declared dead;
the buffer's flush epoch then completes among the survivors
(``core/manager.py::flush_complete`` excuses the dead) while the PFS copy
lacks the stalled server's domain: wrong bytes, or a short file and an
unreadable manifest when the stalled server owns the tail. The port's
``checkpoint/bbckpt.py::_flush`` flushes such a step again among the
survivors and counts it durable only when a flush completes with no such
loss; until then a marker beside the PFS copy keeps ``latest_step`` from
offering it, and retention keeps its buffered copy. The stall is injected
into one server instance's dispatch here; ``core/`` is not changed."""
import os
import shutil
import time

import numpy as np
import pytest
import torch

from _torch_buffer import STEADY_PING_S
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.bbckpt import (FLUSH_TIMEOUT_S, INCOMPLETE,
                                           BBCheckpointManager)
from repro_torch.core import BBConfig, BurstBufferSystem

# long enough for three missed 0.6 s pings; the flush's own work is ~0.1 s.
# Under load the peers take longer to count the stalled server dead and to
# finish the epoch without it, so the stall lasts until the manager counts
# it dead and the epoch complete (at most DEATH_WAIT_S more), and
# AFTER_DEATH_S beyond, while the manager's checkpoint flush looks at it
STALL_S, DEATH_WAIT_S, AFTER_DEATH_S = 2.5, 30.0, 2.0
# 9.4 MB: past the 1 MiB-aligned domains of four servers, so each server
# owns a domain of the file (a small file is all the last server's)
SIDE = 1536


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {
        "w": torch.from_numpy(rng.normal(size=(SIDE, SIDE))
                              .astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(SIDE,)).astype(np.float32))},
        "data": {"step": torch.tensor(seed, dtype=torch.int32)}}


def _zeros(tree):
    return {k: {n: torch.zeros_like(t) for n, t in v.items()}
            for k, v in tree.items()}


def _pfs_bytes(pfs, step):
    with open(os.path.join(pfs, f"ckpt_{step:08d}"), "rb") as f:
        data = f.read()
    with open(os.path.join(pfs, f"ckpt_{step:08d}.manifest"), "rb") as f:
        manifest = f.read()
    return data, manifest


def _saved_bytes(tree):
    payloads, manifest = ser.serialize_tree(tree)
    data = b"".join(payloads[m["name"]] for m in manifest["leaves"])
    return data, ser.manifest_bytes(manifest)


def _stall_shuffle(bb, name):
    """Stall ``name``'s loop once, at the first shuffle piece it receives
    (``STALL_S``, then until the manager counts it dead and the piece's
    epoch complete, then ``AFTER_DEATH_S``); returns the list that records
    the stall."""
    srv = bb.servers[name]
    dispatch, stalled = srv._dispatch, []

    def stall_once(msg):
        if msg.kind == "shuffle_data" and not stalled:
            epoch = msg.payload["epoch"]
            stalled.append(epoch)
            time.sleep(STALL_S)
            deadline = time.monotonic() + DEATH_WAIT_S
            while not (name in bb.manager.dead
                       and bb.manager.flush_complete(epoch)) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(AFTER_DEATH_S)
        return dispatch(msg)

    srv._dispatch = stall_once
    return stalled


def _restore_fresh(pfs, tmp_path, tree):
    """A fresh buffer over a copy of ``pfs``: (restored, step), or None when
    it finds no durable step."""
    copy = tmp_path / "pfs_copy"
    shutil.copytree(pfs, copy)
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    pfs_dir=str(copy),
                                    stabilize_interval=STEADY_PING_S)) as bb:
        mgr = BBCheckpointManager(bb, quantize=False)
        if mgr.latest_step() is None:
            return None
        return mgr.restore(_zeros(tree))


# server/1 owns a middle domain; server/3, the ring's last, owns the tail
# (the file's length and the manifest's bytes)
@pytest.mark.parametrize("stalled_server", ["server/1", "server/3"])
def test_a_flush_with_a_false_death_is_not_durable_until_whole(
        stalled_server, tmp_path):
    tree = _tree(3)
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20)) as bb:
        time.sleep(0.5)                 # the ring's first pings
        stalled = _stall_shuffle(bb, stalled_server)
        mgr = BBCheckpointManager(bb, quantize=False)
        mgr.save(3, tree, blocking_flush=True)
        # the case this test is about happened: the stalled server was
        # declared dead during the step's first flush epoch, before it
        # reported its domain written
        assert stalled == [3]
        assert stalled_server in bb.manager.dead
        assert mgr._lost(3) == {stalled_server}
        flushed = mgr.metrics[3]["flushed"]
        pfs = bb.pfs_dir
        whole = _pfs_bytes(pfs, 3) == _saved_bytes(tree)
        marked = os.path.exists(os.path.join(pfs, f"ckpt_00000003{INCOMPLETE}"))
        fresh = _restore_fresh(pfs, tmp_path, tree)
        # the buffered copy stays restorable either way
        restored, step = mgr.restore(_zeros(tree))
    assert step == 3 and ser.serialize_tree(restored) == \
        ser.serialize_tree(tree)
    # durable only when whole, and the marker says which
    assert not flushed or whole
    assert marked == (not flushed)
    if fresh is None:
        assert not flushed
    else:
        restored, step = fresh
        assert step == 3
        assert ser.serialize_tree(restored) == ser.serialize_tree(tree)
    # the repeat among the survivors makes it whole well inside the wait
    assert flushed


def test_a_flush_that_never_completes_is_not_offered_nor_evicted(tmp_path):
    """A step whose flush ends without durability keeps its buffered copy
    past retention, is marked incomplete on the PFS, and a fresh buffer's
    ``latest_step`` offers only the durable step before it."""
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=STEADY_PING_S)) as bb:
        mgr = BBCheckpointManager(bb, quantize=False, retention=1)
        small = {"params": {"w": torch.arange(64.0)}}
        mgr.save(1, small, blocking_flush=True)
        real_flush = bb.flush
        # step 2's flush writes its PFS copy but ends as a lost one does
        bb.flush = lambda epoch, timeout=30.0: \
            real_flush(epoch, timeout) and False
        mgr.save(2, small, blocking_flush=True)
        bb.flush = real_flush
        mgr.save(3, small, blocking_flush=True)
        assert [mgr.metrics[s]["flushed"] for s in (1, 2, 3)] == \
            [True, False, True]
        # retention 1 evicted step 1, not the undurable step 2
        assert sorted(mgr.saved_steps) == [2, 3]
        restored, _ = mgr.restore({"params": {"w": torch.zeros(64)}}, step=2)
        assert torch.equal(restored["params"]["w"], small["params"]["w"])
        pfs = bb.pfs_dir
        assert os.path.exists(os.path.join(pfs, f"ckpt_00000002{INCOMPLETE}"))
        assert os.path.exists(os.path.join(pfs, "ckpt_00000002"))
        # the PFS as it stood before step 3's flush
        copy = tmp_path / "pfs"
        copy.mkdir()
        for name in set(os.listdir(pfs)) - {"ckpt_00000003",
                                            "ckpt_00000003.manifest"}:
            shutil.copy(os.path.join(pfs, name), copy / name)
    with BurstBufferSystem(BBConfig(num_servers=2, num_clients=2,
                                    dram_capacity=64 << 20,
                                    pfs_dir=str(copy),
                                    stabilize_interval=STEADY_PING_S)) as bb:
        assert BBCheckpointManager(bb).latest_step() == 1


def test_a_flush_without_a_death_takes_one_epoch():
    """No loss: one flush epoch, no marker, no repeat."""
    epochs = []
    with BurstBufferSystem(BBConfig(num_servers=4, num_clients=4,
                                    dram_capacity=64 << 20,
                                    stabilize_interval=STEADY_PING_S)) as bb:
        real_flush = bb.flush

        def flush(epoch, timeout=30.0):
            epochs.append((epoch, timeout))
            return real_flush(epoch, timeout=timeout)

        bb.flush = flush
        mgr = BBCheckpointManager(bb, quantize=False)
        tree = _tree(4)
        mgr.save(4, tree, blocking_flush=True)
        assert mgr.metrics[4]["flushed"] is True
        assert epochs == [(4, FLUSH_TIMEOUT_S)]
        assert not any(n.endswith(INCOMPLETE)
                       for n in os.listdir(bb.pfs_dir))
        assert _pfs_bytes(bb.pfs_dir, 4) == _saved_bytes(tree)
