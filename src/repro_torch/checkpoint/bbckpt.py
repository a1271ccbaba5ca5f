"""BBCheckpointManager: async burst-buffer checkpointing for PyTorch state.

Counterpart of ``repro/checkpoint/bbckpt.py`` over the port's own copy of
the burst buffer (``repro_torch.core``) and serializer; same file names,
lane, retention, staging, trace spans and histograms.

This is the paper's checkpointing flow mapped onto a training loop, written
entirely against the BBFileSystem file-session API:
  1. save(step, state): serialize the sharded train state and pwrite it
     through a BBFile handle. The handle stripes chunks across clients and
     the client write pipeline (paper Fig 4) carries them; close() is the
     sync barrier and raises BBWriteError if any chunk failed — ingest is
     the only part on the training critical path, bounded by BB ingress
     (DRAM write + replication ACK), not the PFS.
  2. A background flush thread triggers the servers' two-phase I/O so the
     checkpoint drains to the PFS while the next compute phase runs, and
     waits until the epoch is durable there (the reference stops waiting
     after the system's 30 s): ``metrics[step]["flush_s"]`` is the time to
     durability and ``["flushed"]`` says whether it was reached.
  3. Recent epochs are retained in the buffer (paper §III-C) so restore()
     is served from server DRAM/SSD without touching the PFS; older epochs
     are evicted once durably flushed (retention eviction leaves tombstones,
     so even a direct get of a retired chunk falls through to the PFS).
  4. restore() reads through BBFile.pread, which itself falls back:
     buffered chunks -> BB lookup-table range read -> PFS file. The same
     chain covers chunks the autonomous drain engine evicted under memory
     pressure mid-training — a restore spanning drained data is byte-exact
     without the checkpoint manager knowing anything moved.

When the servers run with the drain engine enabled (the default), save()
records the cluster pressure snapshot alongside ingest timings, so training
logs show how close the buffer ran to its watermarks at each step.

io_mode maps directly onto BBFile write policies: "sync" (one replicated
round-trip per chunk), "async" (pipelined, barrier at close), "batched"
(async + write coalescing into put_batch messages).

On a multi-host pod each host runs one client pinned (ISO placement) to the
co-located server, and puts only its addressable shards; here one process
plays all clients round-robin (the BBFile handle does this internally).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import serializer as ser
from repro_torch.core import telemetry
from repro_torch.core.system import BurstBufferSystem

# how long a flush waits for its epoch to be durable on the PFS (the system's
# own default is 30 s): a 12.95 GB checkpoint over four servers took 35 to
# 57 s to flush on an H100 machine's host, and a restore begun while the
# servers still wrote their domains found the manifest unreadable (their
# message loops busy, its PFS copy not written yet)
FLUSH_TIMEOUT_S = 600.0


class BBCheckpointManager:
    def __init__(self, system: BurstBufferSystem, *,
                 quantize: bool = False,
                 retention: int = 2,
                 chunk_bytes: int = 4 << 20,
                 io_mode: str = "async",
                 ack_timeout: float = 60.0,
                 clock: Callable[[], float] = time.perf_counter):
        self.system = system
        self.quantize = quantize
        self.retention = retention
        self.chunk_bytes = chunk_bytes
        self.io_mode = io_mode          # "async" | "batched" | "sync"
        self.ack_timeout = ack_timeout
        self._clock = clock
        self.saved_steps: List[int] = []
        self._flush_threads: List[threading.Thread] = []
        self.metrics: Dict[int, dict] = {}
        # telemetry: save/restore latency histograms; save() and
        # restore() also open trace roots, so one checkpoint becomes a span
        # tree across client -> server -> replica -> manager
        self._m_save = telemetry.histogram("ckpt.save_s")
        self._m_restore = telemetry.histogram("ckpt.restore_s")

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking_flush: bool = False,
             io_mode: Optional[str] = None):
        """Ingest the state into the burst buffer; flush to PFS off-path.

        Serialized leaves are pwritten at their manifest offsets through one
        BBFile handle per artifact (data + manifest); close() is the ingest
        barrier and raises if any chunk failed to achieve a replicated ACK.
        """
        mode = io_mode or self.io_mode
        t0 = self._clock()
        policy = ser.default_quant_policy if self.quantize else None
        payloads, manifest = ser.serialize_tree(state, policy)
        fname = f"ckpt_{step:08d}"
        offset_of = {m["name"]: m["offset"] for m in manifest["leaves"]}

        # checkpoint-lane writes: the highest QoS priority — a
        # concurrent background stream can no longer queue ahead of the
        # burst on either the client dispatch queue or the server put path.
        # The trace root spans the whole ingest, so every chunk put, replica
        # hop and fs RPC below parents back to this one checkpoint.
        fs = self.system.fs()
        with telemetry.span("ckpt.save", "checkpoint", step=step):
            f = fs.open(fname, "w", policy=mode,
                        chunk_bytes=self.chunk_bytes, lane="checkpoint")
            for name, data in payloads.items():
                # an empty payload (Adafactor's zero-size sentinels) writes
                # nothing: a zero-length pwrite still puts an empty chunk
                # under the key of the chunk at its offset, which is the
                # next leaf's first chunk (pread of 0 bytes reads nothing)
                if data:
                    f.pwrite(data, offset_of[name])
            mf = fs.open(f"{fname}.manifest", "w", policy=mode,
                         lane="checkpoint")
            mf.write(ser.manifest_bytes(manifest))
            # barrier: both handles' write pipelines must drain before the
            # checkpoint counts as ingested (paper Fig 4 thread-2); the
            # manifest barrier must run even when the data barrier raises,
            # or its failed ops would leak into the next save's drain cycle
            try:
                f.close(self.ack_timeout)
            finally:
                mf.close(self.ack_timeout)
        ingest_s = self._clock() - t0
        self._m_save.observe(ingest_s)

        self.saved_steps.append(step)
        self.metrics[step] = {"ingest_s": ingest_s,
                              "bytes": manifest["total_bytes"],
                              "pressure": self.system.pressure()}

        epoch = step
        if blocking_flush:
            self.metrics[step]["flushed"] = self._flush(epoch)
            self._retire(step)
        else:
            t = threading.Thread(target=self._flush_async,
                                 args=(epoch, step), daemon=True)
            t.start()
            self._flush_threads.append(t)
        return ingest_s

    def _flush_async(self, epoch: int, step: int):
        t0 = self._clock()
        with telemetry.span("ckpt.flush", "checkpoint", step=step):
            flushed = self._flush(epoch)
        self.metrics[step]["flushed"] = flushed
        self.metrics[step]["flush_s"] = self._clock() - t0
        self._retire(step)

    def _flush(self, epoch: int) -> bool:
        """Flush ``epoch`` and wait until it is durable on the PFS, at most
        ``FLUSH_TIMEOUT_S``; True if it is."""
        return self.system.flush(epoch, timeout=FLUSH_TIMEOUT_S)

    def _retire(self, step: int):
        """Evict buffered epochs beyond the retention window (they are
        durable on the PFS by now)."""
        keep = sorted(self.saved_steps)[-self.retention:]
        for s in list(self.saved_steps):
            if s not in keep:
                self.system.evict(f"ckpt_{s:08d}")
                self.saved_steps.remove(s)

    def wait_flushes(self, timeout: float = 60.0):
        for t in self._flush_threads:
            t.join(timeout)
        self._flush_threads = []

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        if self.saved_steps:
            return max(self.saved_steps)
        # fall back to PFS directory listing
        pfs = self.system.pfs_dir
        steps = [int(f[5:13]) for f in os.listdir(pfs)
                 if f.startswith("ckpt_") and not f.endswith(".manifest")]
        return max(steps) if steps else None

    def restore(self, target_state, step: Optional[int] = None, *,
                stage: bool = True):
        """Rebuild a train state. target_state provides structure/shapes
        (e.g. a freshly-initialized state on the device the
        restored tensors should live on). All reads go through BBFile
        handles, whose pread already prefers buffered chunks, then the
        lookup table, then the PFS.

        A retired/evicted checkpoint is STAGED first: one
        manager-coordinated bulk load pulls the PFS copy back into the
        buffer with every server re-ingesting its own domain in parallel,
        instead of the deserialization loop faulting it in one miss at a
        time. Staging is best-effort — if the manager is busy or a server
        dies mid-stage, the handle's read fallback chain still returns
        byte-exact data — and the payload handle keeps ``prefetch`` on so
        any unstaged tail is read ahead of the loop."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        fname = f"ckpt_{step:08d}"
        fs = self.system.fs()
        t0 = self._clock()
        with telemetry.span("ckpt.restore", "checkpoint", step=step):
            if stage:
                # short deadline: a manager busy draining (likely, if
                # pressure is why the checkpoint was evicted) must not stall
                # the restart — the fallback chain reads byte-exact without
                # the stage
                fs.stage(fname, timeout=5.0)

            with fs.open(f"{fname}.manifest", "r") as mf:
                manifest = ser.manifest_from_bytes(mf.read())
            payloads: Dict[str, bytes] = {}
            with fs.open(fname, "r", prefetch=True) as f:
                for meta in manifest["leaves"]:
                    payloads[meta["name"]] = f.pread(meta["offset"],
                                                     meta["nbytes"])
            out = ser.deserialize_tree(target_state, payloads, manifest)
        self._m_restore.observe(self._clock() - t0)
        return out, step
