"""File-session API over the burst buffer: BBFileSystem / BBFile / BBFuture.

The paper presents the burst buffer as a *file* abstraction — checkpoints
are striped across SSD servers and gradually flushed to Lustre — and
BurstFS/UnifyFS converge on the same shape: a mount-like interface with
explicit sync barriers. This module is that client-facing surface:

  fs = system.fs()
  f = fs.open("ckpt_00000001", "w", policy="batched")
  fut = f.pwrite(data, offset)      # returns a BBFuture
  f.sync()                          # barrier: raises on any failed write
  f.close()

A ``BBFile`` handle stripes data into fixed-size chunks, round-robins them
over the system's clients, and routes every chunk through the client's
single internal ``WriteOp`` pipeline (client.py). Each write returns a
``BBFuture``; per-op failures surface as exceptions on the future or on the
``sync()``/``close()`` barrier — there is no shared last-failed list to
race on.

Write policies:
  "sync"     one replicated round-trip per chunk (blocking)
  "async"    pipelined through the ACK ledger, one barrier at sync()
  "batched"  async + small chunks coalesced into put_batch messages
  "through"  QoS write-through bypass: bytes go straight to the
             durable PFS copy, never occupying the buffer; servers get
             metadata-only residency reports so reads stay transparent.
             Streams the per-handle traffic classifier tags SEQUENTIAL
             take this route automatically (unless policy is "sync").
Handles also carry a QoS ``lane`` (checkpoint > interactive > background)
that orders their chunks against other traffic end to end.

Reads assemble a byte range from three sources, freshest first: buffered
chunks via the servers' per-file manifests, post-flush lookup-table range
reads, and finally the durable PFS copy. The read side is parallel:
manifest chunk fetches and gap fills fan out across threads and
round-robin over the system's clients instead of serially hammering one
endpoint, ``fs.stage(path)`` bulk-loads an evicted file back into the
buffer through the manager-coordinated stage-in protocol, and a handle
opened with ``prefetch=True`` detects sequential reads and stages the next
window ahead of the reader.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import locktrack, qos, staging, telemetry
from repro_torch.core.qos import QoSConfig
from repro_torch.core.staging import StageConfig

POLICIES = ("sync", "async", "batched", "through")


class BBError(RuntimeError):
    """Base class for burst-buffer file/write errors."""


class BBWriteError(BBError):
    """A write op exhausted its retries or had no live server to go to."""

    def __init__(self, keys, reason: str = "write failed"):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        super().__init__(f"{reason}: {self.keys}")


class BBFuture:
    """Completion handle for one write op (or a gather of several).

    done()/result()/exception() follow concurrent.futures semantics:
    ``result`` re-raises the op's failure, ``exception`` returns it.
    Completion is first-win — a late ACK for an op that already failed
    (abandoned, timed out) is ignored.
    """

    __slots__ = ("key", "_done", "_result", "_exc", "_cbs", "_event",
                 "_lock")

    def __init__(self, key: Optional[str] = None):
        self.key = key
        self._done = False
        self._result = None
        self._exc: Optional[BaseException] = None
        self._cbs: Optional[List] = None
        # the Event is allocated lazily, only when a thread actually has to
        # block: on the hot ingest path most futures resolve before anyone
        # waits, and per-op Event allocation + set() is measurable overhead
        self._event: Optional[threading.Event] = None
        self._lock = threading.Lock()

    # -------------------------------------------------------------- completion
    def _finish(self, result, exc) -> bool:
        """First-win completion. Returns False when the future was already
        done (the late result is discarded) so callers can tell whether
        their outcome actually took effect."""
        with self._lock:
            if self._done:
                return False
            self._result, self._exc = result, exc
            self._done = True
            cbs, self._cbs = self._cbs, None
            ev = self._event
        if ev is not None:
            ev.set()
        if cbs:
            for cb in cbs:
                cb(self)
        return True

    def _set_result(self, value) -> bool:
        return self._finish(value, None)

    def _set_exception(self, exc: BaseException) -> bool:
        return self._finish(None, exc)

    # ------------------------------------------------------------------- query
    def done(self) -> bool:
        return self._done

    def _wait(self, timeout: Optional[float]) -> bool:
        if self._done:
            return True
        with self._lock:
            if self._done:
                return True
            if self._event is None:
                self._event = threading.Event()
            ev = self._event
        return ev.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._wait(timeout):
            raise TimeoutError(f"write not acknowledged: {self.key}")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._wait(timeout):
            raise TimeoutError(f"write not acknowledged: {self.key}")
        return self._exc

    def add_done_callback(self, cb):
        with self._lock:
            if not self._done:
                if self._cbs is None:
                    self._cbs = []
                self._cbs.append(cb)
                return
        cb(self)

    @classmethod
    def gather(cls, futures: List["BBFuture"]) -> "BBFuture":
        """A future that resolves once every input does; fails on the first
        input failure (first-win, like the per-op futures)."""
        g = cls(key=None)
        if not futures:
            g._set_result(True)
            return g
        remaining = [len(futures)]
        lock = threading.Lock()

        def _cb(f: "BBFuture"):
            exc = f._exc
            if exc is not None:
                g._set_exception(exc)
                return
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                g._set_result(True)

        for f in futures:
            f.add_done_callback(_cb)
        return g


@dataclass(eq=False)      # identity semantics: ops live in sets/buffers
class WriteOp:
    """One chunk travelling the client write pipeline. Every put — blocking,
    pipelined, or coalesced — is a WriteOp; the policy knobs only change how
    it is shipped and awaited. ``lane`` is the QoS priority lane:
    it orders the op against other traffic on the client dispatch queue and
    the server put path, and counts it against that lane's congestion
    window while on the wire."""
    key: str
    value: bytes
    file: Optional[str]
    offset: int
    future: BBFuture
    lane: int = qos.LANE_INTERACTIVE
    redirects: int = 0
    attempts: int = 0
    msg_id: Optional[int] = None     # current in-flight message, if any
    counted: bool = False            # held against the lane window right now
    # telemetry stamps, set only while telemetry is enabled:
    parked_at: float = 0.0           # when the op entered the lane queue
    issued_at: float = 0.0           # when it last went on the wire
    # trace context captured when the op parked: the dispatch
    # pump runs on another thread with no span of its own, so the lane
    # wait is attributed back to the submitting span through this
    trace_ctx: Optional[list] = None


class BBFile:
    """An open burst-buffer file. Write calls stripe into chunks keyed
    ``{path}:{offset}`` (so prefix eviction and the two-phase flush see the
    same namespace as the legacy KV API) and return BBFutures; ``sync()``
    flushes coalesce buffers and raises if any chunk failed.

    Mode "w" truncates an existing incarnation. Rewriting the same offset
    with the same striping is last-writer-wins (chunks share a key);
    PARTIALLY overlapping writes at different offsets have no defined
    recency across servers — write aligned, non-overlapping ranges."""

    def __init__(self, fs: "BBFileSystem", path: str, mode: str, *,
                 policy: str = "async", chunk_bytes: Optional[int] = None,
                 prefetch: Optional[bool] = None, lane=None):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be r/w/a, got {mode!r}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        if policy == "through" and not fs.pfs_dir:
            raise ValueError("policy='through' needs a PFS directory")
        self.fs = fs
        self.path = path
        self.mode = mode
        self.policy = policy
        self.chunk_bytes = chunk_bytes or fs.chunk_bytes
        # QoS: the stream's priority lane, and a per-stream
        # traffic classifier — SEQUENTIAL (steady, in-order, sub-burst-rate)
        # streams are routed around the buffer entirely (write-through to
        # the PFS) so BB capacity stays free for the bursts that need it
        self.lane = qos.lane_index(lane if lane is not None
                                   else fs.lane_default)
        self._clf = qos.TrafficClassifier(fs.qos_cfg) \
            if fs.qos_cfg.enabled and mode != "r" else None
        self.bypassed_bytes = 0
        self._thru_fh = None           # cached PFS handle (bypass writes)
        self._thru_run: Optional[List[int]] = None   # unreported [lo, hi)
        # read-ahead: sequential-access detection on positional
        # reads issues asynchronous stage-ins of the next window
        if prefetch is None:
            prefetch = fs.prefetch_default
        self._ra = staging.ReadAhead(fs.stage_cfg) \
            if prefetch and fs.stage_cfg.enabled else None
        self._pos = 0
        self._size = 0
        self._rr = 0                       # round-robin cursor over clients
        self._futures: List[BBFuture] = []
        # offset -> (key, length, holder servers), merged across servers
        self._chunks: Optional[Dict[int, Tuple]] = None
        self._closed = False
        if mode == "r":
            st = fs.stat(path)
            self._size = st["size"]
        elif mode == "a":
            try:
                self._size = fs.stat(path)["size"]
            except FileNotFoundError:
                self._size = 0
            self._pos = self._size

    # ----------------------------------------------------------------- helpers
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check_open(self, writing: bool):
        if self._closed:
            raise ValueError(f"I/O on closed file {self.path!r}")
        if writing and self.mode == "r":
            raise ValueError(f"file {self.path!r} opened read-only")

    def seek(self, pos: int) -> int:
        self._pos = max(0, pos)
        return self._pos

    def tell(self) -> int:
        return self._pos

    @property
    def size(self) -> int:
        return self._size

    # ------------------------------------------------------------------ writes
    def write(self, data: bytes) -> BBFuture:
        """Append at the cursor; returns a future for the whole write."""
        fut = self.pwrite(data, self._pos)
        self._pos += len(data)
        return fut

    def pwrite(self, data: bytes, offset: int) -> BBFuture:
        """Positional write: stripe ``data`` into chunks and submit each to
        the next client's write pipeline. Under policy "sync" each chunk
        blocks on its replicated ACK (raising on failure); otherwise the
        returned future completes when every chunk of this call does.

        QoS routing: a handle opened with ``policy="through"``,
        or one whose traffic classifier has tagged the stream SEQUENTIAL
        (steady, in-order, below the burst rate), writes straight to the
        PFS — the bytes never occupy the buffer, and residency metadata
        registered with the servers keeps reads transparent."""
        self._check_open(writing=True)
        if self._clf is not None:
            self._clf.observe(offset, len(data))
        if self.policy == "through" or (
                self._clf is not None and self.fs.qos_cfg.auto_bypass
                and self.fs.pfs_dir and self.policy != "sync"
                and self.lane != qos.LANE_CHECKPOINT   # bursts stay buffered
                and self._clf.classify() == qos.SEQUENTIAL):
            return self._pwrite_through(data, offset)
        # a pending bypass run must be reported BEFORE a buffered write
        # ships: servers evict chunks a run covers, so a report chasing a
        # fresher buffered rewrite of the same range would evict new bytes
        self._flush_bypass_report()
        clients = self.fs.clients
        # "batched" forces coalescing (a chunk at/above batch_bytes still
        # ships immediately as its own batch); other policies pipeline
        # each chunk individually so §III-A redirects stay available
        coalesce = True if self.policy == "batched" else False
        futs: List[BBFuture] = []
        for off in range(0, max(len(data), 1), self.chunk_bytes):
            piece = bytes(data[off:off + self.chunk_bytes])
            c = clients[self._rr % len(clients)]
            self._rr += 1
            key = f"{self.path}:{offset + off}"
            fut = c.submit(key, piece, file=self.path, offset=offset + off,
                           coalesce=coalesce, lane=self.lane)
            if self.policy == "sync":
                try:
                    fut.result(c.sync_put_timeout())
                except TimeoutError:
                    c.abandon_by_future(fut)   # wedged op must not linger
                    c._consume_failed(key)
                    raise
                except BBWriteError:
                    c._consume_failed(key)     # observed here, not at drain
                    raise
            futs.append(fut)
        self._size = max(self._size, offset + len(data))
        self._futures.extend(futs)
        self._chunks = None    # read-after-write must see the new chunks
        return futs[0] if len(futs) == 1 else BBFuture.gather(futs)

    # report a bypass run to the servers once it grows this large (or on
    # sync/close, or when the stream seeks) — metadata stays timely without
    # a per-write broadcast
    BYPASS_REPORT_BYTES = 8 << 20

    def _pwrite_through(self, data: bytes, offset: int) -> BBFuture:
        """Write-through bypass: the bytes go straight to the
        durable PFS copy — zero BB occupancy, no replication traffic, no
        later drain work — and the write is durable when this returns, so
        the future is already complete. The servers get a metadata-only
        ``bypass_report`` per contiguous run: every one max-merges the
        file's lookup-table size (range reads cover the extent) and the
        run's placement owner records an eviction tombstone, making a
        bypassed run indistinguishable from a drained-and-evicted chunk on
        the read path. The PFS handle is cached on the BBFile (one open
        per stream, not per write) and flushed per write so concurrent
        readers of the durable copy always see the bytes."""
        fs = self.fs
        if self._thru_fh is None:
            with fs._pfs_lock:
                p = os.path.join(fs.pfs_dir, self.path)
                self._thru_fh = open(p, "r+b" if os.path.exists(p)
                                     else "w+b")
        self._thru_fh.seek(offset)
        self._thru_fh.write(data)
        self._thru_fh.flush()
        # many BBFile handles (one per writer thread) share these counters
        with fs._pfs_lock:
            fs.bypass_stats["writes"] += 1
            fs.bypass_stats["bytes"] += len(data)
        hi = offset + len(data)
        if self._thru_run is not None and offset == self._thru_run[1]:
            self._thru_run[1] = hi
        else:
            self._flush_bypass_report()
            self._thru_run = [offset, hi]
        if self._thru_run[1] - self._thru_run[0] >= self.BYPASS_REPORT_BYTES:
            self._flush_bypass_report()
        self.bypassed_bytes += len(data)
        self._size = max(self._size, hi)
        self._chunks = None
        fut = BBFuture(f"{self.path}:{offset}")
        fut._set_result(True)
        return fut

    def _flush_bypass_report(self):
        run, self._thru_run = self._thru_run, None
        if run is not None:
            self.fs._report_bypass(self.path, run[0], run[1] - run[0],
                                   self.chunk_bytes)

    def sync(self, timeout: float = 60.0) -> "BBFile":
        """Barrier (paper Fig 4 thread-2 drain, per handle): flush every
        client's coalesce buffer, wait for all of this handle's outstanding
        futures, and raise BBWriteError listing the failed chunk keys if any
        write did not achieve a replicated ACK."""
        self._flush_bypass_report()     # bypassed runs: metadata barrier
        for c in self.fs.clients:
            c.flush_coalesced()
        deadline = self.fs._clock() + timeout
        failed: List[str] = []
        try:
            for f in self._futures:
                remaining = max(0.0, deadline - self.fs._clock())
                exc = f.exception(remaining)   # raises TimeoutError on expiry
                if exc is not None:
                    failed.append(f.key if f.key is not None else "<gather>")
        except TimeoutError:
            # abandon the stragglers and consume everything this barrier
            # observed, mirroring BBClient.drain()'s timeout behaviour —
            # an errored handle must not poison a later drain cycle
            for g in self._futures:
                if not g.done():
                    for c in self.fs.clients:
                        if c.abandon_by_future(g):
                            break
            for key in failed:
                for c in self.fs.clients:
                    c._consume_failed(key)
            self._futures = []
            raise
        self._futures = []
        if failed:
            # the failure is observed HERE, on this barrier — consume it so
            # it cannot also fail a later legacy wait_acks()/drain() cycle
            for key in failed:
                for c in self.fs.clients:
                    c._consume_failed(key)
            raise BBWriteError(failed, "sync barrier found failed writes")
        self.fs._register_sync(self.path, self._size)
        # an autonomous drain may have evicted or re-tiered chunks while the
        # barrier waited; re-merge the manifests on the next read
        self._chunks = None
        return self

    def close(self, timeout: float = 60.0):
        """Sync (for writable handles) and invalidate the handle."""
        if self._closed:
            return
        try:
            if self.mode != "r":
                self.sync(timeout)
        finally:
            self._closed = True
            if self._thru_fh is not None:
                self._thru_fh.close()
                self._thru_fh = None

    # ------------------------------------------------------------------- reads
    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = max(0, self._size - self._pos)
        data = self.pread(self._pos, n)
        self._pos += len(data)
        return data

    def pread(self, offset: int, length: int) -> bytes:
        """Positional read, freshest source first:
          1. buffered chunks located via the servers' per-file manifests
             (individual gets are replica-aware, so this survives failover),
          2. post-flush lookup-table range read (paper §III-C),
          3. the durable PFS copy.
        Chunk fetches and gap fills fan out over ``fs.read_fanout`` threads
        and round-robin across the system's clients — a restart-
        sized read keeps every server busy instead of one.
        """
        self._check_open(writing=False)
        # POSIX short-read semantics at EOF: never fabricate zero bytes
        # beyond the known size
        length = min(length, max(0, self._size - offset))
        if length <= 0:
            return b""
        if self._ra is not None:
            win = self._ra.observe(offset, length, self._size)
            if win is not None:
                # true fire-and-forget read-ahead: the request runs off a
                # daemon thread so a slow or dead manager never stalls the
                # reading thread; a rejection (manager busy with a drain
                # epoch) simply costs the prefetch
                threading.Thread(
                    target=self.fs.stage,
                    args=(self.path, win[0], win[1] - win[0]),
                    kwargs={"wait": False}, daemon=True,
                    name="bb-readahead").start()
                # staged chunks land in the servers' manifests; drop the
                # cached merge so subsequent reads see them (triggers fire
                # every half window, so staleness is bounded by design)
                self._chunks = None
        out = bytearray(length)
        covered: List[List[int]] = []
        chunks = self._chunk_map()
        jobs = []                            # (base, key, ln, holders, lo, hi)
        for base in sorted(chunks):
            key, ln, holders = chunks[base]
            lo, hi = max(offset, base), min(offset + length, base + ln)
            if lo < hi:
                jobs.append((base, key, ln, holders, lo, hi))

        def _fetch(job):
            base, key, ln, holders, _lo, _hi = job
            client = self.fs.next_client()
            for server in holders:           # primary + replicas
                piece = client.get_at(server, key)
                if piece is not None and len(piece) == ln:
                    return piece
                # wrong length = stale replica of a same-offset rewrite;
                # a raw slice-assign would silently RESIZE the bytearray
            return None                      # evicted/unreachable: fall back

        pieces = staging.parallel_map(_fetch, jobs, self.fs.read_fanout)
        # assembly stays in ascending-offset order: overlap resolution is
        # deterministic (chunks at the SAME offset are last-writer-wins via
        # their shared key; partially-overlapping writes at different
        # offsets have no cross-server recency order — avoid them)
        for (base, _key, _ln, _holders, lo, hi), piece in zip(jobs, pieces):
            if piece is None:
                continue
            out[lo - offset:hi - offset] = piece[lo - base:hi - base]
            covered.append([lo, hi])
        missing = _gaps(_merge(covered), offset, offset + length)
        if not missing:
            return bytes(out)

        def _fill(gap):
            lo, hi = gap
            data = self.fs.next_client().read_file(self.path, lo, hi - lo)
            if data is None:
                data = self._pread_pfs(lo, hi - lo)
            return data

        fills = staging.parallel_map(_fill, missing, self.fs.read_fanout)
        for (lo, hi), data in zip(missing, fills):
            if data is None or len(data) < hi - lo:
                # a short fallback read would silently zero-fill — the range
                # is inside the known size, so this is real data loss
                raise BBError(
                    f"unreadable range [{lo}, {hi}) of {self.path!r}")
            out[lo - offset:lo - offset + len(data)] = data
        return bytes(out)

    def _chunk_map(self) -> Dict[int, Tuple]:
        if self._chunks is None:
            self._chunks = self.fs.next_client().file_chunks(self.path)
        return self._chunks

    def _pread_pfs(self, offset: int, length: int) -> Optional[bytes]:
        path = os.path.join(self.fs.pfs_dir, self.path) \
            if self.fs.pfs_dir else None
        if path is None or not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)


class BBFileSystem:
    """Mount-like facade over a set of burst-buffer clients.

    One BBFileSystem per application (``system.fs()``); handles from
    ``open()`` share the clients and stripe across them. The manager keeps
    the namespace registry (fs_open/fs_sync), so ``listdir``/``exists``
    reflect every client's files, not just this process's."""

    def __init__(self, clients, *, chunk_bytes: int = 4 << 20,
                 pfs_dir: Optional[str] = None, manager: str = "manager",
                 read_fanout: int = 4, stage: Optional[StageConfig] = None,
                 prefetch: bool = False, qos_cfg: Optional[QoSConfig] = None,
                 lane_default="interactive", control_timeout: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if not clients:
            raise ValueError("BBFileSystem needs at least one client")
        self._clock = clock
        self.clients = list(clients)
        self.chunk_bytes = chunk_bytes
        self.pfs_dir = pfs_dir
        self.manager = manager
        self.read_fanout = max(1, read_fanout)
        self.stage_cfg = stage or StageConfig()
        self.prefetch_default = prefetch
        self.qos_cfg = qos_cfg or QoSConfig()
        self.lane_default = lane_default
        # one knob for every manager/control RPC deadline, mirroring the
        # read_timeout cleanup (was a scatter of hardcoded 1.0s)
        self.control_timeout = control_timeout
        # bypass writers share PFS files
        self._pfs_lock = locktrack.lock("BBFileSystem._pfs_lock")
        self.bypass_stats = {"writes": 0, "bytes": 0}
        self._rr = itertools.count()
        # telemetry: the registry polls the bypass counters —
        # under our own lock, only when someone scrapes — instead of the
        # hot bypass path pushing per-write updates
        telemetry.poll("fs.bypass", self._bypass_snapshot)

    def _bypass_snapshot(self) -> dict:
        with self._pfs_lock:
            return dict(self.bypass_stats)

    def next_client(self):
        """Round-robin over the system's clients. Every read-side RPC used
        to go through ``clients[0]`` — one endpoint became the funnel for
        manifest fetches, direct gets, and fallback range reads while the
        others sat idle."""
        return self.clients[next(self._rr) % len(self.clients)]

    # -------------------------------------------------------------- namespace
    def _mgr_request(self, kind: str, payload: dict,
                     timeout: Optional[float] = None):
        c = self.next_client()
        if timeout is None:
            timeout = 2 * self.control_timeout
        return c.transport.request(c.ep, self.manager, kind, payload,
                                   timeout=timeout)

    # ----------------------------------------------------- write-through path
    def _report_bypass(self, path: str, offset: int, length: int,
                       chunk_bytes: int):
        """Metadata-only broadcast for a bypassed run: every server
        max-merges the lookup-table size and evicts live chunks the run
        covers; each chunk-granular slice's placement owner records an
        eviction tombstone, so direct KV gets of ANY ``{path}:{offset}``
        inside the run fall through to the PFS just as they would for an
        identically-striped buffered-then-drained stream. Fire-and-forget
        — even with zero reports delivered, reads stay byte-exact via the
        PFS fallback."""
        c = self.next_client()
        chunks = []
        for off in range(offset, offset + length, chunk_bytes):
            ln = min(chunk_bytes, offset + length - off)
            try:
                owner = c.owner(f"{path}:{off}")
            except RuntimeError:
                owner = None
            chunks.append([off, ln, owner])
        payload = {"file": path, "offset": offset, "length": length,
                   "size": offset + length, "chunks": chunks}
        for s in c._alive_servers():
            c.transport.send(c.tname, s, "bypass_report", payload)

    def open(self, path: str, mode: str = "r", *, policy: str = "async",
             chunk_bytes: Optional[int] = None,
             prefetch: Optional[bool] = None, lane=None) -> BBFile:
        if mode in ("w", "a"):
            r = self._mgr_request("fs_open", {"path": path, "mode": mode})
            if mode == "w":
                existed = r is not None and r.payload.get("existed")
                if not existed:
                    existed = bool(self.pfs_dir) and os.path.exists(
                        os.path.join(self.pfs_dir, path))
                if not existed:
                    # chunks written through the legacy put(file=...) shims
                    # share the key namespace but bypass the manager — the
                    # servers' manifests are the source of truth
                    existed = self.clients[0].file_stat(path)["known"]
                if existed:
                    # truncate semantics: a shorter rewrite must never read
                    # back stale tail bytes of a longer previous incarnation
                    self.truncate(path)
        return BBFile(self, path, mode, policy=policy,
                      chunk_bytes=chunk_bytes, prefetch=prefetch, lane=lane)

    def stage(self, path: str, offset: int = 0,
              length: Optional[int] = None, *, wait: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Bulk-load ``path`` (or a byte range of it) from the PFS back into
        the burst buffer — the drain engine run in reverse. The manager runs
        one stage epoch at a time (serialized against drain micro-epochs);
        each server re-ingests its own lookup-table domain in parallel, and
        the staged chunks are CLEAN (durable copy exists), so later pressure
        evicts them for free.

        wait=True blocks until the epoch completes and returns whether it
        did; wait=False fires the request and returns whether the manager
        accepted it (read-ahead callers just drop a rejection). Staging is
        best-effort either way: reads are byte-exact with or without it."""
        if not self.stage_cfg.enabled:
            return False
        if timeout is None:
            timeout = self.stage_cfg.stage_timeout_s
        hi = -1 if length is None else offset + length
        payload = {"path": path, "lo": offset, "hi": hi}
        deadline = self._clock() + timeout
        c = self.next_client()
        req_timeout = self.control_timeout if wait \
            else self.control_timeout / 4
        epoch = None
        while epoch is None:
            r = c.transport.request(c.ep, self.manager, "stage_request",
                                    payload, timeout=req_timeout)
            if r is not None and r.payload.get("accepted"):
                epoch = r.payload["epoch"]
                break
            if not wait or self._clock() >= deadline:
                return False     # manager busy (drain/flush in flight)
            time.sleep(self.stage_cfg.request_retry_interval)
        if not wait:
            return True
        while self._clock() < deadline:
            r = c.transport.request(c.ep, self.manager, "stage_status",
                                    {"epoch": epoch},
                                    timeout=self.control_timeout)
            if r is not None:
                state = r.payload["state"]
                if state == "done":
                    return True
                if state in ("aborted", "unknown"):
                    return False
            time.sleep(self.stage_cfg.status_poll_interval)
        return False

    def truncate(self, path: str):
        """Drop every buffered chunk of ``path`` on every server (replicas
        included), its lookup-table entries, the durable PFS copy, and the
        manager's recorded size. Raises BBError if any server fails to
        acknowledge — an unacknowledged truncation could resurrect stale
        tail bytes of a longer previous incarnation later."""
        # ops of the dead incarnation still parked client-side must never
        # ship after the truncate (they would resurrect stale chunks)
        for cl in self.clients:
            cl.cancel_parked(path)
        c = self.clients[0]
        to = self.control_timeout
        for s in c._alive_servers():
            r = c.transport.request(c.ep, s, "file_truncate", {"file": path},
                                    timeout=to)
            if r is None:       # one retry: deep inboxes happen under load
                r = c.transport.request(c.ep, s, "file_truncate",
                                        {"file": path}, timeout=to)
            if r is None:
                raise BBError(f"truncate of {path!r} unacknowledged by {s}")
        if self.pfs_dir:
            p = os.path.join(self.pfs_dir, path)
            if os.path.exists(p):
                os.remove(p)
        self._mgr_request("fs_truncate", {"path": path},
                          timeout=self.control_timeout)

    def _register_sync(self, path: str, size: int):
        self._mgr_request("fs_sync", {"path": path, "size": size},
                          timeout=self.control_timeout)

    def listdir(self, prefix: str = "") -> List[str]:
        r = self._mgr_request("fs_list", {"prefix": prefix})
        names = set(r.payload["paths"]) if r is not None else set()
        if self.pfs_dir and os.path.isdir(self.pfs_dir):
            names.update(n for n in os.listdir(self.pfs_dir)
                         if n.startswith(prefix))
        return sorted(names)

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except FileNotFoundError:
            return False

    def stat(self, path: str) -> dict:
        """Merged metadata: buffered extent across servers' chunk manifests,
        post-flush lookup-table size, the PFS copy, and the manager's
        namespace (which alone knows zero-byte synced files). ``residency``
        reports where the file's bytes physically sit (DRAM / SSD / PFS,
        replica copies included) — the observable trace of the autonomous
        drain engine, which moves bytes down the tiers without ever changing
        what reads return."""
        c = self.clients[0]
        st = c.file_stat(path)
        buffered = st["buffered"]
        flushed = st["flushed_size"] or 0
        pfs = 0
        if self.pfs_dir:
            p = os.path.join(self.pfs_dir, path)
            if os.path.exists(p):
                pfs = os.path.getsize(p)
        r = self._mgr_request("fs_stat", {"path": path},
                              timeout=self.control_timeout)
        ns_known = r is not None and r.payload["known"]
        ns_size = r.payload["size"] if ns_known else 0
        if not (buffered or flushed or pfs or st["known"] or ns_known):
            raise FileNotFoundError(path)
        return {"size": max(buffered, flushed, pfs, ns_size),
                "buffered": buffered, "flushed_size": flushed,
                "pfs_size": pfs, "chunks": st["chunks"],
                "residency": st.get("residency",
                                    {"dram": 0, "ssd": 0, "pfs": 0}),
                "evicted_chunks": st.get("evicted_chunks", 0)}

    def unlink(self, path: str):
        """Drop the path from the namespace and its buffered chunks on
        every server (exact-match file_truncate — unlinking ``run`` leaves
        ``run_info.txt`` alone). The durable PFS copy, if flushed, is left
        in place."""
        self._mgr_request("fs_unlink", {"path": path})


# interval helpers shared by the read-assembly path (one implementation,
# in staging.py — the stage planner needs the identical math)
_merge = staging.merge_intervals
_gaps = staging.gaps
