"""Burst buffer client (paper §II, §III, §IV-B): the compute-node-side API.

ONE write path. Every write — whether it arrives through a ``BBFile``
handle, the legacy ``put``/``put_async`` shims, or a coalesced batch — is a
``WriteOp`` submitted to the same pipeline:

  submit(key, value) -> BBFuture
      The op is either fired at its owner immediately (pipelined, paper
      Fig 4) or parked in a per-destination coalesce buffer and shipped as
      one ``put_batch`` message; a background ACK pump (the paper's Fig 4
      "thread 2") drains replies, handles redirects and failover re-issues,
      and completes the op's BBFuture. Failures surface as exceptions on
      the future / the ``BBFile.sync()`` barrier — never on a shared
      mutable error list.

Pipelining vs coalescing are *policies* on this path, not separate APIs:
  coalesce=False  ship now, ACK out-of-band          (old put_async)
  coalesce=True   buffer, ship as a batch            (old coalesced path)
  fut.result()    block the caller on the ACK        (old blocking put)

The client also handles:
  - placement (Ketama / ISO / rendezvous)
  - overload redirects from servers (paper §III-A)
  - timeout -> predecessor failure confirmation -> manager report (§IV-B2)
  - reads preferring the burst buffer, replicas on primary failure, and
    post-shuffle range reads via the servers' lookup tables (§III-C)

Compatibility shims (one release): ``put``, ``put_async``, ``wait_acks``,
``flush_batches``, ``failed_keys`` delegate to the pipeline and keep the
old bool/list semantics for callers that have not migrated to
``BBFileSystem`` handles.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core import locktrack, qos, staging, telemetry
from repro_torch.core.filesystem import BBFuture, BBWriteError, WriteOp
from repro_torch.core.hashing import IsoPlacement, KetamaRing, RendezvousHash
from repro_torch.core.qos import QoSConfig
from repro_torch.core.transport import Message, Transport


class _AckSink:
    """Reply sink for the ACK pump. Unlike a queue.Queue, a put() on an
    already-signalled sink is a cheap no-op wake-wise: the pump is woken
    once per BURST of ACKs, not once per ACK — under pipelined small-chunk
    load a per-ACK wake preempts the submitting thread thousands of times
    a second and throttles ingest."""
    __slots__ = ("items", "event")

    def __init__(self):
        self.items: collections.deque = collections.deque()
        self.event = threading.Event()

    def put(self, msg):                    # transport sink protocol
        self.items.append(msg)
        self.event.set()


class _Inflight:
    """One in-flight message: a single WriteOp or a coalesced batch of them."""
    __slots__ = ("ops", "target", "deadline", "batch")

    def __init__(self, ops: List[WriteOp], target: str, deadline: float,
                 batch: bool):
        self.ops = ops
        self.target = target
        self.deadline = deadline
        self.batch = batch


class BBClient:
    MAX_ATTEMPTS = 6

    def __init__(self, name: str, transport: Transport, *,
                 client_index: int = 0,
                 placement: str = "iso",
                 replication: int = 2,
                 put_timeout: float = 3.0,
                 read_timeout: float = 1.0,
                 control_timeout: float = 1.0,
                 read_fanout: int = 4,
                 batch_bytes: int = 1 << 20,
                 coalesce_threshold: int = 64 << 10,
                 ack_poll_interval: float = 0.02,
                 ack_scan_interval: float = 0.05,
                 drain_poll_interval: float = 0.003,
                 connect_retry_interval: float = 0.05,
                 pump_join_timeout: float = 1.0,
                 qos_cfg: Optional[QoSConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.tname = name
        self._clock = clock
        self.ack_poll_interval = ack_poll_interval
        self.ack_scan_interval = ack_scan_interval
        self.drain_poll_interval = drain_poll_interval
        self.connect_retry_interval = connect_retry_interval
        self.pump_join_timeout = pump_join_timeout
        self.transport = transport
        self.ep = transport.register(name)
        self.client_index = client_index
        self.placement_kind = placement
        self.replication = replication
        self.put_timeout = put_timeout
        # one knob for every read-side RPC deadline (manifest fetches,
        # direct gets, stats); range reads get twice the budget since the
        # server may have to touch the PFS to fill gaps
        self.read_timeout = read_timeout
        # ... and one for every control-plane RPC (manager hellos, failure
        # confirmation probes) — mirrors the read_timeout cleanup
        self.control_timeout = control_timeout
        self.read_fanout = read_fanout
        self.batch_bytes = batch_bytes
        self.coalesce_threshold = coalesce_threshold
        # QoS: lane-ordered dispatch gated by per-lane congestion
        # windows; ACK-piggybacked occupancy feeds the windows
        self.qos_cfg = qos_cfg or QoSConfig()
        if self.qos_cfg.enabled:
            self._laneq: Optional[qos.LaneQueue] = qos.LaneQueue(
                self.qos_cfg.lane_weights, self.qos_cfg.quantum_bytes)
            self._cwnd: Optional[qos.CongestionWindows] = \
                qos.CongestionWindows(self.qos_cfg, owner=name)
        else:
            self._laneq = None
            self._cwnd = None
        self._lane_inflight = [0] * len(qos.LANES)
        self.ring: List[str] = []
        self.dead: set = set()
        self._placement = None
        self._overrides: Dict[str, str] = {}     # key -> redirected server
        self._lock = locktrack.lock("BBClient._lock")  # membership/placement
        # --- write pipeline (paper Fig 4): in-flight ops + coalesce buffers.
        # All pipeline state is guarded by _op_lock; replies funnel into one
        # completion queue drained by the ACK pump thread.
        self._op_lock = locktrack.lock("BBClient._op_lock")
        self._pending: Dict[int, _Inflight] = {}   # msg_id -> in-flight entry
        self._inflight: set = set()                # WriteOps not yet done
        self._coalesce: Dict[str, List[WriteOp]] = {}
        self._coalesce_nbytes: Dict[str, int] = {}
        self._acks = _AckSink()
        self._last_reply: Dict[str, float] = {}    # server -> last-ack time
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # legacy-shim error snapshot (wait_acks/failed_keys compat)
        self._failed: List[str] = []
        self.last_failed: List[str] = []
        # counters are bumped from API callers, the ACK pump, and expiry
        # threads concurrently; a dedicated leaf lock keeps them exact
        self._stats_lock = locktrack.lock("BBClient._stats_lock")
        self.stats = {"puts": 0, "put_bytes": 0, "redirects": 0,
                      "failovers": 0, "gets": 0, "bb_hits": 0,
                      "async_puts": 0, "batched_puts": 0, "batches": 0,
                      "evicted_reads": 0}
        # telemetry: per-lane latency histograms bind once here
        # (shared no-ops when disabled — _tele guards the clock stamps so
        # the hot path pays nothing); the registry polls the legacy
        # counters under _stats_lock only when someone scrapes
        self._tele = telemetry.enabled()
        self._m_lane_wait = telemetry.histogram("client.lane_wait_s")
        self._m_dispatch = telemetry.histogram("client.dispatch_s")
        telemetry.poll("client.ops", self._stats_snapshot, label=name)

    def _bump(self, stat: str, n: int = 1):
        with self._stats_lock:
            self.stats[stat] += n

    def _stats_snapshot(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    # ------------------------------------------------------------ membership
    def connect(self, timeout: float = 10.0):
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            r = self.transport.request(self.ep, "manager", "client_hello", {},
                                       timeout=self.control_timeout)
            if r is not None and r.kind == "ring":
                self._set_ring(r.payload["ring"],
                               set(r.payload.get("dead", [])))
                return
            time.sleep(self.connect_retry_interval)
        raise TimeoutError("manager did not provide a ring")

    def close(self):
        """Stop the ACK pump and fail any still-in-flight ops so no thread
        is left blocked on a future that can never complete (system
        teardown path)."""
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=self.pump_join_timeout)
            self._pump = None
        with self._op_lock:
            pending = list(self._inflight)
            self._inflight.clear()
            self._pending.clear()
            self._coalesce.clear()
            self._coalesce_nbytes.clear()
            if self._laneq is not None:
                self._laneq.discard(lambda ent: True)
            self._lane_inflight = [0] * len(qos.LANES)
        for op in pending:
            op.future._set_exception(BBWriteError(op.key, "client closed"))

    def _set_ring(self, ring: List[str], dead: Optional[set] = None):
        with self._lock:
            self.ring = list(ring)
            self.dead = set(dead or ())
            self._rebuild_placement()

    def _rebuild_placement(self):
        alive = [s for s in self.ring if s not in self.dead]
        if self.placement_kind == "ketama":
            self._placement = KetamaRing(alive)
        elif self.placement_kind == "rendezvous":
            self._placement = RendezvousHash(alive)
        else:
            self._placement = IsoPlacement(alive)

    def _drain_membership(self):
        """Apply any ring/ring_update notifications sitting in the inbox."""
        while True:
            msg = self.ep.recv(timeout=0)
            if msg is None:
                return
            if msg.kind == "ring":
                self._set_ring(msg.payload["ring"])
            elif msg.kind == "ring_update":
                with self._lock:
                    self.dead.update(msg.payload.get("dead", []))
                    for s in msg.payload.get("joined", []):
                        self.dead.discard(s)
                        if s not in self.ring:
                            self.ring.append(s)
                    self._rebuild_placement()

    def owner(self, key: str) -> str:
        self._drain_membership()
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
            if not any(s not in self.dead for s in self.ring):
                raise RuntimeError("no alive burst-buffer servers")
            if self.placement_kind == "iso":
                return self._placement.lookup_for_client(self.client_index)
            return self._placement.lookup(key)

    def replica_set(self, key: str) -> List[str]:
        """Primary + ring successors (replica holders)."""
        primary = self.owner(key)
        with self._lock:
            alive = [s for s in self.ring if s not in self.dead]
            if primary not in alive:
                alive.append(primary)
                alive.sort()
            i = alive.index(primary)
            return [alive[(i + j) % len(alive)]
                    for j in range(min(self.replication, len(alive)))]

    # ------------------------------------------------------- write pipeline
    def submit(self, key: str, value: bytes, *, file: Optional[str] = None,
               offset: int = 0, coalesce: Optional[bool] = None,
               lane: int = qos.LANE_INTERACTIVE) -> BBFuture:
        """THE write path. Returns a BBFuture that completes with True on a
        replicated ACK or with a BBWriteError once retries are exhausted.
        ``coalesce`` None applies the size threshold; True/False force the
        coalesced/pipelined route. ``lane`` is the QoS priority lane: with
        QoS enabled, ops go on the wire in weighted lane order and only
        while their lane's congestion window has room — a background flood
        parks client-side instead of stuffing the server's inbox ahead of
        a checkpoint burst."""
        self._bump("puts")
        self._bump("put_bytes", len(value))
        lane = qos.lane_index(lane)
        fut = BBFuture(key)
        op = WriteOp(key, value, file, offset, fut, lane=lane)
        if coalesce is None:
            coalesce = len(value) < self.coalesce_threshold
        self._ensure_pump()
        try:
            target = self.owner(key)
        except RuntimeError as e:
            self._fail_op(op, BBWriteError(key, str(e)))
            return fut
        with self._op_lock:
            self._inflight.add(op)
            if coalesce:
                ckey = (target, lane)
                self._coalesce.setdefault(ckey, []).append(op)
                nb = self._coalesce_nbytes.get(ckey, 0) + len(value)
                self._coalesce_nbytes[ckey] = nb
                if nb >= self.batch_bytes:
                    self._flush_target_locked(ckey)
            elif self._laneq is None:
                self._issue_locked([op], target, batch=False)
            else:
                if self._tele:
                    op.parked_at = self._clock()
                    op.trace_ctx = telemetry.current_ctx()
                self._laneq.push(lane, [[op], target, False], len(value))
                self._dispatch_locked()
        return fut

    def flush_coalesced(self):
        """Ship every pending coalesce buffer (one put_batch per server)."""
        with self._op_lock:
            for ckey in list(self._coalesce):
                self._flush_target_locked(ckey)

    def outstanding(self) -> int:
        """Write ops submitted but not yet completed — includes ops still
        sitting in coalesce buffers, so a drain that returns with
        outstanding() > 0 can never be mistaken for success."""
        with self._op_lock:
            return len(self._inflight)

    def drain(self, timeout: float = 30.0) -> List[str]:
        """Flush coalesce buffers and wait until every in-flight op
        completes. On overall timeout the stragglers are abandoned (their
        futures fail). Returns the keys of ops that FAILED since the last
        drain; [] means full success."""
        self.flush_coalesced()
        deadline = self._clock() + timeout
        failed: List[WriteOp] = []
        while True:
            with self._op_lock:
                pending = list(self._inflight)
            if not pending:
                break
            if self._clock() > deadline:
                for op in pending:
                    self._abandon(op, "drain timeout")
                break
            time.sleep(self.drain_poll_interval)
        # every completed-with-error op since the last drain
        with self._op_lock:
            keys, self._failed = self._failed, []
        self.last_failed = keys
        return keys

    def sync_put_timeout(self) -> float:
        """Worst-case time for one op to succeed or fail through the
        pipeline: per-attempt liveness timeout plus failure-confirmation
        round-trips, across MAX_ATTEMPTS."""
        return (self.put_timeout + 1.5) * self.MAX_ATTEMPTS + 2.0

    # --- internals -------------------------------------------------------
    def _ensure_pump(self):
        if self._pump is not None and self._pump.is_alive():
            return
        with self._op_lock:
            if self._pump is not None and self._pump.is_alive():
                return
            self._stop.clear()
            self._pump = threading.Thread(
                target=self._ack_loop, daemon=True,
                name=f"{self.tname}-ackpump")
            self._pump.start()

    def _ack_loop(self):
        """Paper Fig 4 "thread 2": drain ACKs, re-issue on redirect, expire
        entries whose server has gone quiet and fail over (§IV-B2)."""
        next_scan = 0.0
        sink = self._acks
        while not self._stop.is_set():
            if not sink.items:
                sink.event.wait(self.ack_poll_interval)
            sink.event.clear()             # clear-then-drain: a concurrent
            while sink.items:              # append re-signals for next pass
                msg = sink.items.popleft()
                if self._tele:
                    # re-parent under the server's reply span so the ACK
                    # leg shows up in the same trace as the put it answers
                    with telemetry.msg_span("client." + msg.kind,
                                            self.tname, msg.payload):
                        self._on_ack(msg)
                else:
                    self._on_ack(msg)
            now = self._clock()
            if now >= next_scan:
                self._check_deadlines(now)
                next_scan = now + self.ack_scan_interval

    def _issue_locked(self, ops: List[WriteOp], target: str, batch: bool):
        """Fire ops at ``target`` as one message. Caller holds _op_lock."""
        if batch:
            self._bump("batches")
            self._bump("batched_puts", len(ops))
            payload = {"items": [{"key": o.key, "value": o.value,
                                  "file": o.file, "offset": o.offset}
                                 for o in ops],
                       "lane": ops[0].lane}
            msg_id = self.transport.request_async(
                self.ep, target, "put_batch", payload, sink=self._acks)
        else:
            op = ops[0]
            msg_id = self.transport.request_async(
                self.ep, target, "put",
                {"key": op.key, "value": op.value, "file": op.file,
                 "offset": op.offset, "lane": op.lane,
                 # after 2 redirects force acceptance (server spills to SSD)
                 # to avoid ping-pong on stale free-memory gossip
                 "redirectable": op.redirects < 2},
                sink=self._acks)
        if self._tele:
            now = self._clock()
            lane_name = qos.LANES[ops[0].lane]
            for op in ops:
                if op.parked_at:       # parked in the lane queue until now
                    wait = now - op.parked_at
                    self._m_lane_wait.observe(wait, label=lane_name)
                    # completed-span record under the submitter's trace —
                    # the health engine's "queue" segment
                    telemetry.observe_span("client.lane_wait", self.tname,
                                           op.trace_ctx, op.parked_at,
                                           wait, lane=lane_name)
                    op.parked_at = 0.0
                    op.trace_ctx = None
                op.issued_at = now
        for op in ops:
            op.msg_id = msg_id
            if not op.counted:      # window accounting (re-issues stay held)
                op.counted = True
                self._lane_inflight[op.lane] += len(op.value)
        self._pending[msg_id] = _Inflight(
            ops, target, self._clock() + self.put_timeout, batch)

    def _flush_target_locked(self, ckey: tuple):
        ops = self._coalesce.pop(ckey, [])
        self._coalesce_nbytes.pop(ckey, None)
        if not ops:
            return
        target, lane = ckey
        if self._laneq is None:
            self._issue_locked(ops, target, batch=True)
        else:
            if self._tele:
                now = self._clock()
                ctx = telemetry.current_ctx()
                for op in ops:
                    op.parked_at = now
                    op.trace_ctx = ctx
            self._laneq.push(lane, [ops, target, True],
                             sum(len(o.value) for o in ops))
            self._dispatch_locked()

    def _can_issue(self, lane: int, nbytes: int) -> bool:
        """Congestion gate for one lane-queue head. An idle lane may always
        issue one entry (progress even when a single op exceeds the
        window); otherwise the lane's in-flight bytes must fit."""
        infl = self._lane_inflight[lane]
        return infl == 0 or infl + nbytes <= self._cwnd.window(lane)

    def _dispatch_locked(self):
        """Move queued entries onto the wire in weighted lane order, as far
        as the congestion windows allow. Caller holds _op_lock. Runs on
        every submit, every ACK (window space freed), and the pump's
        deadline scan — queued ops can never strand."""
        while True:
            ent = self._laneq.pop(self._can_issue)
            if ent is None:
                return
            ops, target, batch = ent
            if ops:                 # abandon may have emptied the entry
                self._issue_locked(ops, target, batch)

    def _uncount_locked(self, op: WriteOp):
        """Release the op's congestion-window hold. Caller holds _op_lock."""
        if op.counted:
            op.counted = False
            self._lane_inflight[op.lane] -= len(op.value)

    def _fail_op(self, op: WriteOp, exc: Exception):
        # record BEFORE completing the future: a blocking put() woken by the
        # exception consumes its key from _failed, so the key must already
        # be there or it would leak into the next drain cycle
        with self._op_lock:
            self._inflight.discard(op)
            self._uncount_locked(op)
            self._failed.append(op.key)
        if not op.future._set_exception(exc):
            self._consume_failed(op.key)    # op had already succeeded

    def _complete_op(self, op: WriteOp):
        with self._op_lock:
            self._inflight.discard(op)
            self._uncount_locked(op)
        op.future._set_result(True)

    def _abandon(self, op: WriteOp, reason: str):
        """Cancel an op wherever it currently is (coalesce buffer, lane
        queue, or wire) and fail its future. Late ACKs for it are ignored
        (first-win)."""
        with self._op_lock:
            for ckey, ops in list(self._coalesce.items()):
                if op in ops:
                    ops.remove(op)
                    self._coalesce_nbytes[ckey] = \
                        self._coalesce_nbytes.get(ckey, 0) - len(op.value)
                    if not ops:
                        del self._coalesce[ckey]
                        self._coalesce_nbytes.pop(ckey, None)
            if self._laneq is not None:
                # pull the op out of any queued entry; an emptied entry is
                # dropped whole (dispatch also skips empties defensively)
                for ent in self._laneq.entries():
                    if op in ent[0]:
                        ent[0].remove(op)
                self._laneq.discard(lambda ent: not ent[0])
            if op.msg_id is not None:
                ent = self._pending.get(op.msg_id)
                if ent is not None and op in ent.ops:
                    ent.ops.remove(op)
                    if not ent.ops:
                        del self._pending[op.msg_id]
                        self.transport.cancel_async(self.ep, op.msg_id)
        self._fail_op(op, BBWriteError(op.key, reason))

    def _on_ack(self, msg: Message):
        with self._op_lock:
            ent = self._pending.pop(msg.reply_to, None)
            if ent is None:
                return                      # late reply for a re-issued op
            # written here (pump), read by _check_deadlines — keep both
            # under _op_lock like the rest of the pipeline state
            self._last_reply[ent.target] = self._clock()
        # backpressure: every server reply piggybacks its store
        # occupancy; the congestion windows shrink background lanes first
        occ = msg.payload.get("occupancy") if msg.payload else None
        if occ is not None and self._cwnd is not None:
            self._cwnd.on_pressure(occ)
        if msg.kind in ("put_ack", "put_batch_ack"):
            # one lock round for the whole entry (batches carry many ops)
            with self._op_lock:
                self._inflight.difference_update(ent.ops)
                for op in ent.ops:
                    self._uncount_locked(op)
                if self._laneq is not None:
                    self._dispatch_locked()   # window space just freed
            if self._tele:
                now = self._clock()
                for op in ent.ops:
                    if op.issued_at:
                        self._m_dispatch.observe(now - op.issued_at,
                                                 label=qos.LANES[op.lane])
            for op in ent.ops:
                op.future._set_result(True)
            return
        if msg.kind == "redirect":
            self._bump("redirects")
            target = msg.payload["target"]
            telemetry.record(self.tname, "redirect", target=target,
                             n_ops=len(ent.ops))
            with self._lock:
                for op in ent.ops:
                    self._overrides[op.key] = target
            for op in ent.ops:
                op.redirects += 1
                op.attempts += 1
            with self._op_lock:
                # servers never redirect batches today, but route them
                # correctly if that changes
                self._issue_locked(ent.ops, target, batch=ent.batch)

    def _check_deadlines(self, now: float):
        # a deadline alone does not condemn a server: under pipelined load a
        # healthy target may simply have a deep inbox. Expire an entry only
        # when its server has ALSO acked nothing for a full put_timeout —
        # i.e. the timeout judges per-server liveness, not per-message queue
        # position. A dead server acks nothing, so real failures still fire.
        with self._op_lock:
            if self._laneq is not None:
                self._dispatch_locked()   # insurance: windows may have grown
            expired = [mid for mid, e in self._pending.items()
                       if e.deadline < now
                       and self._last_reply.get(e.target, -1e9)
                       + self.put_timeout < now]
            entries = []
            for mid in expired:
                entries.append(self._pending.pop(mid))
                self.transport.cancel_async(self.ep, mid)
        if entries:
            # failure confirmation blocks on RPCs for seconds — run it off
            # the pump thread so ACKs for healthy servers keep draining
            # (entries are already popped, so no double-processing)
            threading.Thread(
                target=lambda: [self._expire(e) for e in entries],
                daemon=True, name=f"{self.tname}-expire").start()

    def _expire(self, ent: _Inflight):
        """An in-flight message timed out: confirm the suspect's failure via
        its predecessor, then re-issue survivors to their failover owners
        (regrouping batches, since placement may split them)."""
        telemetry.record(self.tname, "put_timeout", target=ent.target,
                         n_ops=len(ent.ops))
        retryable = [op for op in ent.ops
                     if op.attempts + 1 < self.MAX_ATTEMPTS]
        exhausted = [op for op in ent.ops if op not in retryable]
        failover = None
        if retryable:
            failover = self._handle_timeout(retryable[0].key, ent.target)
        if failover is None:
            exhausted = ent.ops
            retryable = []
        for op in exhausted:
            self._fail_op(op, BBWriteError(
                op.key, f"no replicated ACK after {op.attempts + 1} attempts"
                        f" (last target {ent.target})"))
        if not retryable:
            return
        groups: Dict[str, List[WriteOp]] = {}
        for op in retryable:
            op.attempts += 1
            try:
                groups.setdefault(self.owner(op.key), []).append(op)
            except RuntimeError as e:
                self._fail_op(op, BBWriteError(op.key, str(e)))
        with self._op_lock:
            for target, ops in groups.items():
                if ent.batch and len(ops) > 1:
                    self._issue_locked(ops, target, batch=True)
                else:
                    for op in ops:
                        self._issue_locked([op], target, batch=False)

    def _handle_timeout(self, key: str, target: str) -> Optional[str]:
        """Paper §IV-B2: confirm failure via the suspect's predecessor, then
        let the manager broadcast; fail over to the replica successor.
        Returns the failover target, or None when no alive server remains."""
        self._bump("failovers")
        telemetry.record(self.tname, "failover", suspect=target, key=key)
        with self._lock:
            alive = [s for s in self.ring if s not in self.dead]
        pred = None
        if target in alive:
            i = alive.index(target)
            pred = alive[(i - 1) % len(alive)]
        if pred and pred != target:
            self.transport.request(self.ep, pred, "confirm_failure",
                                   {"suspect": target},
                                   timeout=self.control_timeout)
        with self._lock:
            self.dead.add(target)
            self._rebuild_placement()
            self._overrides = {k: v for k, v in self._overrides.items()
                               if v != target}
            if not any(s not in self.dead for s in self.ring):
                return None
        try:
            return self.owner(key)
        except RuntimeError:
            return None

    # ------------------------------------------------- legacy compat shims
    # One release of grace for pre-BBFileSystem callers. Everything below
    # delegates to submit()/drain(); nothing else in the client distinguishes
    # "sync" from "async" from "batched" writes.
    def put(self, key: str, value: bytes, *, file: Optional[str] = None,
            offset: int = 0) -> bool:
        """[compat] Blocking put: submit + wait on the future. True on a
        replicated ACK, False on failure. The caller observes the failure
        here, so it is consumed — it must not ALSO fail a later
        wait_acks()/drain() cycle of unrelated async ops."""
        fut = self.submit(key, value, file=file, offset=offset,
                          coalesce=False)
        try:
            fut.result(self.sync_put_timeout())
            return True
        except TimeoutError:
            # abandon so a wedged op cannot poison a later drain barrier
            self.abandon_by_future(fut)
            self._consume_failed(key)
            return False
        except BBWriteError:
            self._consume_failed(key)
            return False

    def _consume_failed(self, key: str):
        with self._op_lock:
            try:
                self._failed.remove(key)
            except ValueError:
                pass

    def cancel_parked(self, file: str):
        """Truncate support: complete-and-drop every op of ``file`` still
        parked client-side (lane queue or coalesce buffer). A parked op
        dispatched AFTER the truncate RPC would re-land stale bytes of the
        dead incarnation; completing it as success gives the caller the
        FIFO-equivalent outcome — applied, then truncated."""
        done: List[WriteOp] = []
        with self._op_lock:
            if self._laneq is not None:
                for ent in self._laneq.entries():
                    for op in [o for o in ent[0] if o.file == file]:
                        ent[0].remove(op)
                        self._inflight.discard(op)
                        self._uncount_locked(op)
                        done.append(op)
                self._laneq.discard(lambda ent: not ent[0])
            for ckey, ops in list(self._coalesce.items()):
                stale = [o for o in ops if o.file == file]
                for op in stale:
                    ops.remove(op)
                    self._coalesce_nbytes[ckey] = \
                        self._coalesce_nbytes.get(ckey, 0) - len(op.value)
                    self._inflight.discard(op)
                    done.append(op)
                if not ops:
                    del self._coalesce[ckey]
                    self._coalesce_nbytes.pop(ckey, None)
        for op in done:
            op.future._set_result(True)

    def abandon_by_future(self, fut) -> bool:
        """Cancel the in-flight op behind ``fut`` and consume its failure
        record (the caller observed the outcome through the future, so it
        must not leak into a later legacy drain cycle). Returns False if no
        such op is in flight."""
        with self._op_lock:
            op = next((o for o in self._inflight if o.future is fut), None)
        if op is None:
            return False
        self._abandon(op, "barrier timeout")
        self._consume_failed(op.key)
        return True

    def put_async(self, key: str, value: bytes, *, file: Optional[str] = None,
                  offset: int = 0, coalesce: Optional[bool] = None
                  ) -> BBFuture:
        """[compat] Pipelined put; completion is observed via wait_acks()
        (legacy) or the returned future (preferred)."""
        self._bump("async_puts")
        return self.submit(key, value, file=file, offset=offset,
                           coalesce=coalesce)

    def flush_batches(self):
        """[compat] Old name for flush_coalesced()."""
        self.flush_coalesced()

    def wait_acks(self, timeout: float = 30.0) -> bool:
        """[compat] Drain the pipeline; True only when every op submitted
        since the last drain achieved a replicated ACK. Unlike the pre-
        BBFuture version, a timeout can never report True while ops are
        still buffered or in flight: outstanding() is authoritative."""
        failed = self.drain(timeout)
        return not failed and self.outstanding() == 0

    def failed_keys(self) -> List[str]:
        """[compat] Keys that failed in the last drain/wait_acks cycle."""
        return list(self.last_failed)

    # ------------------------------------------------------------------- get
    def get(self, key: str) -> Optional[bytes]:
        """Read back a buffered value, trying primary then replicas. If every
        copy was drained-and-evicted, fall through transparently: the miss
        reply carries the chunk's (file, offset, length) residency record,
        and the bytes come back via the post-shuffle lookup table / PFS —
        callers never observe eviction."""
        self._bump("gets")
        try:
            replicas = self.replica_set(key)
        except RuntimeError:
            return None
        evicted = None
        for target in replicas:
            r = self.transport.request(self.ep, target, "get", {"key": key},
                                       timeout=self.read_timeout)
            if r is not None and r.payload.get("hit"):
                self._bump("bb_hits")
                return r.payload["value"]
            if r is not None and evicted is None:
                evicted = r.payload.get("evicted")
        if evicted is not None:
            file, offset, length = evicted
            data = self.read_file(file, offset, length)
            if data is not None:
                self._bump("evicted_reads")
                return data
        return None

    def file_info(self, file: str):
        try:
            replicas = self.replica_set(file)
        except RuntimeError:
            return None
        for target in replicas:
            r = self.transport.request(self.ep, target, "file_info",
                                       {"file": file},
                                       timeout=self.read_timeout)
            if r is not None and r.payload.get("size") is not None:
                return r.payload
        return None

    def _alive_servers(self) -> List[str]:
        self._drain_membership()
        with self._lock:
            return [s for s in self.ring if s not in self.dead]

    def file_chunks(self, file: str) -> Dict[int, tuple]:
        """Merged per-file chunk manifest across all alive servers:
        {offset: (key, length, holders)}. Primaries and replicas both
        report a chunk, so ``holders`` doubles as the replica set for
        direct fetches — placement-independent reads survive failover.
        A DIRTY copy outranks a CLEAN (staged) one at the same offset:
        staged chunks are re-ingests of the durable PFS copy, so a
        buffered write racing a stage epoch must win the merge and its
        holder is tried first."""
        merged: Dict[int, tuple] = {}
        clean_at: Dict[int, bool] = {}
        servers = self._alive_servers()
        replies = staging.parallel_map(
            lambda s: self.transport.request(self.ep, s, "file_chunks",
                                             {"file": file},
                                             timeout=self.read_timeout),
            servers, self.read_fanout)
        for s, r in zip(servers, replies):
            if r is None:
                continue
            for off, key, length, clean in r.payload["chunks"]:
                ent = merged.get(off)
                if ent is None:
                    merged[off] = (key, length, [s])
                    clean_at[off] = clean
                elif not clean and clean_at[off]:
                    # dirty beats staged: its key/length define the chunk
                    # and its holder goes to the front of the line
                    merged[off] = (key, length, [s] + ent[2])
                    clean_at[off] = False
                else:
                    ent[2].append(s)
        return merged

    def get_at(self, server: str, key: str) -> Optional[bytes]:
        """Fetch a value from one specific server (manifest-directed read —
        bypasses placement, which only knows where THIS client writes)."""
        self._bump("gets")
        r = self.transport.request(self.ep, server, "get", {"key": key},
                                   timeout=self.read_timeout)
        if r is not None and r.payload.get("hit"):
            self._bump("bb_hits")
            return r.payload["value"]
        return None

    def file_stat(self, file: str) -> dict:
        """Merged file metadata across alive servers: buffered extent,
        chunk count, post-flush size (lookup table), and physical residency
        (bytes per tier, replica copies included — it reports where bytes
        actually sit, so replication factors in)."""
        buffered, chunks, flushed, known = 0, 0, None, False
        residency = {"dram": 0, "ssd": 0, "pfs": 0}
        evicted_chunks = 0
        servers = self._alive_servers()
        replies = staging.parallel_map(
            lambda s: self.transport.request(self.ep, s, "file_stat",
                                             {"file": file},
                                             timeout=self.read_timeout),
            servers, self.read_fanout)
        for r in replies:
            if r is None:
                continue
            p = r.payload
            buffered = max(buffered, p["buffered"])
            chunks += p["chunks"]
            if p["flushed_size"] is not None:
                flushed = max(flushed or 0, p["flushed_size"])
            known = known or p["known"]
            for tier, n in p.get("residency", {}).items():
                residency[tier] = residency.get(tier, 0) + n
            evicted_chunks += p.get("evicted_chunks", 0)
        return {"buffered": buffered, "chunks": chunks,
                "flushed_size": flushed, "known": known,
                "residency": residency, "evicted_chunks": evicted_chunks}

    def read_file(self, file: str, offset: int, length: int
                  ) -> Optional[bytes]:
        """Post-flush read through the lookup table (paper §III-C): locate
        the domain owners for the range and fetch without touching the PFS.
        Domain fetches fan out concurrently — a restart-sized
        range spans every server's domain, and serial round-trips would
        leave all but one server idle."""
        info = self.file_info(file)
        if info is None:
            return None
        spans = []
        for server, a, b in info["domains"]:
            lo, hi = max(offset, a), min(offset + length, b)
            if lo < hi:
                spans.append((server, lo, hi))

        def _fetch(span):
            server, lo, hi = span
            return self.transport.request(
                self.ep, server, "read_range",
                {"file": file, "offset": lo, "length": hi - lo},
                timeout=2 * self.read_timeout)

        replies = staging.parallel_map(_fetch, spans, self.read_fanout)
        out = bytearray(length)
        filled = 0
        for (server, lo, hi), r in zip(spans, replies):
            if r is None or not r.payload.get("complete"):
                return None     # never fabricate bytes: let callers fall back
            out[lo - offset:hi - offset] = r.payload["data"]
            filled += hi - lo
        if filled < length:     # range extends beyond every domain
            return None
        return bytes(out)
