"""Burst buffer manager (paper §II, §IV-A): singleton that initializes the
server ring, distributes membership to servers and clients, brokers failure
reports and joins, keeps the file-session namespace registry (paths opened
through BBFileSystem, with their last synced sizes), and coordinates the
autonomous drain engine's micro-epochs: servers report occupancy pressure
and request drains; the manager serializes one drain micro-epoch at a time
through the two-phase protocol, broadcasts the eviction once EVERY
participant reported its PFS writes done, and aborts the epoch (nothing is
evicted, nothing is lost) on any mid-epoch server death or timeout.

It also coordinates the stage-in engine (the drain in reverse):
a client's stage_request starts ONE stage epoch at a time — serialized
against drain micro-epochs AND application flushes, so the two engines can
never thrash the same segments — broadcasting stage_begin to the ring
snapshot; the epoch completes when every participant reports stage_done,
and aborts (harmlessly: staged bytes are clean copies of durable data) on
death or timeout. Clients poll stage_status for the outcome.
Collocated with a server on a real deployment.

Crash recovery: the manager keeps an append-only JSON-lines
journal of its durable state — the fs namespace registry, the global lookup
table (file -> flushed size, learned from flush_done reports), and the
drain/stage epoch counters — each record fsynced before the triggering
request is acked. A restarted manager replays the journal before its first
message (truncating a torn tail at the first unparsable line), so manager
death is a failover, not a metadata outage: stat/list answer for files
synced before the crash, range reads find their lookup sizes (re-seeded to
servers and through ring bootstrap), and re-allocated epoch ids can never
collide with pre-crash ones."""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core import locktrack, telemetry
from repro_torch.core.health import HealthConfig, HealthEngine
from repro_torch.core.transport import Message, Transport

# drain micro-epochs and stage epochs live in their own id spaces so they
# can never collide with application-chosen flush epochs (or each other)
DRAIN_EPOCH_BASE = 1 << 30
STAGE_EPOCH_BASE = 2 << 30


class BBManager(threading.Thread):
    def __init__(self, transport: Transport, expected_servers: int,
                 name: str = "manager",
                 drain_epoch_timeout: float = 12.0,
                 poll_interval: float = 0.05,
                 flush_poll_interval: float = 0.01,
                 drain_serialize_poll: float = 0.005,
                 journal_path: Optional[str] = None,
                 health_cfg: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(daemon=True, name=name)
        self.tname = name
        self._clock = clock
        self.poll_interval = poll_interval
        self.flush_poll_interval = flush_poll_interval
        self.drain_serialize_poll = drain_serialize_poll
        self.transport = transport
        self.ep = transport.register(name)
        self.expected = expected_servers
        self.ring: List[str] = []
        self.dead: Set[str] = set()
        self.clients: Set[str] = set()
        self.flush_done: Dict[int, Set[str]] = {}
        self.flush_bytes: Dict[int, int] = {}
        self.flush_ledger_cap = 256     # completed/aborted epochs retained
        self._registered: Set[str] = set()
        self._stop = threading.Event()
        self.ring_ready = threading.Event()
        self.errors: List[dict] = []
        # file-session namespace (BBFileSystem): path -> metadata
        self.namespace: Dict[str, dict] = {}
        # global lookup table (file -> flushed size), max-merged from
        # flush_done reports; journaled and re-seeded to servers via ring
        # messages so range reads survive a whole-cluster restart
        self.lookup: Dict[str, int] = {}
        self.journal_path = journal_path
        self._journal_fh = None
        # drain coordination: per-server pressure reports + one in-flight
        # micro-epoch at a time (overlapping epochs share server-side
        # shuffle buffers; serializing them keeps eviction decisions sound)
        self.drain_epoch_timeout = drain_epoch_timeout
        self.pressure: Dict[str, dict] = {}
        self.drain_stats = {"epochs": 0, "aborts": 0,
                            "evicted_keys": 0, "drained_bytes": 0}
        self._drain: Optional[dict] = None
        self._next_drain_epoch = DRAIN_EPOCH_BASE
        self._flush_lock = locktrack.lock("BBManager._flush_lock")
        self._user_flushes: Dict[int, float] = {}   # epoch -> begin time
        # participant snapshot per user flush epoch, taken at begin_flush:
        # completion is judged against it, never against an empty ring
        # (set() >= set() was vacuously True)
        self._flush_expected: Dict[int, Set[str]] = {}
        # stage-in coordination: one stage epoch at a time,
        # serialized against drain micro-epochs; finished epochs keep a
        # bounded result record for stage_status polling
        self.stage_stats = {"epochs": 0, "aborts": 0, "staged_bytes": 0}
        self._stage: Optional[dict] = None
        self._next_stage_epoch = STAGE_EPOCH_BASE
        self._stage_results: Dict[int, dict] = {}
        # telemetry: epoch-duration histograms + abort-cause
        # counter; _tele captured once so the disabled path stays free
        self._tele = telemetry.enabled()
        self._m_drain_s = telemetry.histogram("manager.drain_epoch_s")
        self._m_stage_s = telemetry.histogram("manager.stage_epoch_s")
        self._m_aborts = telemetry.counter("manager.epoch_aborts")
        telemetry.poll("manager.ops", self._ops_snapshot)
        # health engine: constructed only when telemetry is on —
        # with it off the run loop pays one ``is not None`` check and the
        # report is a static "disabled" stub
        self.health_cfg = health_cfg or HealthConfig()
        self._health: Optional[HealthEngine] = \
            HealthEngine(self.health_cfg, clock=clock) if self._tele else None
        self._health_last = 0.0

    # ------------------------------------------------------------------ api
    def alive_ring(self) -> List[str]:
        return [s for s in self.ring if s not in self.dead]

    def wait_ring(self, timeout: float = 10.0) -> bool:
        return self.ring_ready.wait(timeout)

    def flush_complete(self, epoch: int) -> bool:
        """True once every PARTICIPANT — the alive ring snapshotted at
        begin_flush — reported flush_done, excusing mid-epoch deaths. The
        empty set is never a quorum: before any server registers, or after
        the whole snapshot died, this is False (the old comparison against
        the live ring made ``set() >= set()`` vacuously True). Reads the
        snapshot without _flush_lock — _on_flush_done calls in holding it,
        and dict reads are atomic under the GIL."""
        expected = self._flush_expected.get(epoch)
        if expected is None:
            expected = set(self.alive_ring())
        live = expected - self.dead
        return bool(live) and self.flush_done.get(epoch, set()) >= live

    def wait_flush(self, epoch: int, timeout: float = 30.0) -> bool:
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if self.flush_complete(epoch):
                return True
            time.sleep(self.flush_poll_interval)
        return False

    def stop(self):
        self._stop.set()

    # --------------------------------------------------------------- thread
    def run(self):
        # replay the journal before the first message: handlers must never
        # observe (or journal over) a half-recovered namespace
        self._replay_journal()
        while not self._stop.is_set():
            msg = self.ep.recv(timeout=self.poll_interval)
            now = self._clock()
            if self._drain is not None \
                    and now - self._drain["started"] > self.drain_epoch_timeout:
                self._abort_drain("timeout")
            if self._stage is not None \
                    and now - self._stage["started"] > self.drain_epoch_timeout:
                self._abort_stage("timeout")
            self._sweep_stale_flushes(now)
            if self._health is not None and \
                    now - self._health_last >= self.health_cfg.interval_s:
                self._health_last = now
                self._evaluate_health(now)
            if msg is None:
                continue
            handler = getattr(self, f"_on_{msg.kind}", None)
            if handler is not None:
                if self._tele:
                    with telemetry.msg_span("manager." + msg.kind,
                                            self.tname, msg.payload):
                        handler(msg)
                else:
                    handler(msg)
        # close in the owning thread, after the last handler could write
        fh, self._journal_fh = self._journal_fh, None
        if fh is not None:
            fh.close()

    # ------------------------------------------------- recovery journal
    def _journal(self, rec: dict):
        """Append one journal record, durable before return: the ack a
        handler sends after this is a promise the metadata survives."""
        if not self.journal_path:
            return
        if self._journal_fh is None:
            self._journal_fh = open(self.journal_path, "ab")
        self._journal_fh.write(json.dumps(rec, sort_keys=True).encode()
                               + b"\n")
        self._journal_fh.flush()
        os.fsync(self._journal_fh.fileno())

    def _journal_ns(self, path: str):
        ent = self.namespace.get(path)
        if ent is not None:
            self._journal({"op": "ns", "path": path,
                           "size": ent["size"], "synced": ent["synced"]})

    def _replay_journal(self):
        """Rebuild namespace/lookup/epoch counters from the journal. Stops
        at the first unparsable or incomplete line (a torn tail from a
        mid-append crash) and truncates it away so the append-only
        invariant holds for the new incarnation."""
        if not self.journal_path or not os.path.exists(self.journal_path):
            return
        good = 0
        with open(self.journal_path, "rb") as fh:
            for line in fh:
                if not line.endswith(b"\n"):
                    break
                try:
                    self._apply_journal(json.loads(line))
                except (ValueError, KeyError, TypeError):
                    break
                good += len(line)
        if good < os.path.getsize(self.journal_path):
            with open(self.journal_path, "r+b") as fh:
                fh.truncate(good)
                fh.flush()
                os.fsync(fh.fileno())

    def _apply_journal(self, rec: dict):
        op = rec["op"]
        if op == "ns":
            self.namespace[rec["path"]] = {
                "size": int(rec["size"]), "synced": bool(rec["synced"]),
                "opened_by": set()}   # sessions do not survive a restart
        elif op == "ns_del":
            self.namespace.pop(rec["path"], None)
        elif op == "lookup":
            for f, sz in rec["sizes"].items():
                if int(sz) > self.lookup.get(f, -1):
                    self.lookup[f] = int(sz)
        elif op == "lookup_del":
            self.lookup.pop(rec["path"], None)
        elif op == "epoch":
            # re-allocated ids must never collide with pre-crash ones
            if "drain" in rec:
                self._next_drain_epoch = max(self._next_drain_epoch,
                                             int(rec["drain"]) + 1)
            if "stage" in rec:
                self._next_stage_epoch = max(self._next_stage_epoch,
                                             int(rec["stage"]) + 1)
        # unknown ops from a newer incarnation are ignored, not fatal

    def _sweep_stale_flushes(self, now: float):
        """A user epoch wedged past any plausible completion must not
        block drain micro-epochs forever."""
        stale = now - 4 * self.drain_epoch_timeout
        with self._flush_lock:
            for e in [e for e, t in self._user_flushes.items() if t < stale]:
                self._user_flushes.pop(e, None)

    # ------------------------------------------------------------- handlers
    def _on_register(self, msg: Message):
        """Servers register at startup; once all expected have arrived, the
        manager arranges the ring (sorted ids) and distributes it."""
        self._registered.add(msg.src)
        if len(self._registered) >= self.expected and not self.ring:
            self.ring = sorted(self._registered)
            self._broadcast_ring()
            self.ring_ready.set()

    def _on_client_hello(self, msg: Message):
        self.clients.add(msg.src)
        if self.ring:
            self.transport.reply(self.tname, msg, "ring",
                                 {"ring": self.ring,
                                  "dead": sorted(self.dead)})

    def _broadcast_ring(self):
        # the lookup table rides along so a recovered manager re-seeds
        # flushed-file sizes into every server at ring formation
        for dst in list(self.ring) + sorted(self.clients):
            self.transport.send(self.tname, dst, "ring",
                                {"ring": self.ring,
                                 "dead": sorted(self.dead),
                                 "lookup": dict(self.lookup)})

    def _on_failure_report(self, msg: Message):
        dead = msg.payload["dead"]
        if dead in self.dead or dead not in self.ring:
            return
        self.dead.add(dead)
        telemetry.record(self.tname, "server_dead", server=dead,
                         reported_by=msg.src)
        # a death mid-drain invalidates the epoch's domain plan (the dead
        # server's owned domains may never reach the PFS) — abort before
        # anything can be evicted; the chunks re-drain from replicas later.
        # A death mid-stage just aborts the bulk load: staged bytes are
        # clean copies of durable data, reads stay correct via fallback.
        self._abort_drain(f"server failure: {dead}")
        self._abort_stage(f"server failure: {dead}")
        for dst in self.alive_ring() + sorted(self.clients):
            self.transport.send(self.tname, dst, "ring_update",
                                {"dead": [dead]})

    def _on_join_request(self, msg: Message):
        """Paper Fig 3: a joining server names its predecessor; the manager
        inserts it and triggers stabilization via a ring_update."""
        server = msg.payload["server"]
        pred = msg.payload.get("pred")
        if server in self.ring and server not in self.dead:
            return
        if server in self.dead:
            self.dead.discard(server)
        elif pred in self.ring:
            self.ring.insert(self.ring.index(pred) + 1, server)
        else:
            self.ring.append(server)
        for dst in self.alive_ring() + sorted(self.clients):
            self.transport.send(self.tname, dst, "ring_update",
                                {"joined": [server], "pred": pred})
        # the joiner itself gets the authoritative membership + lookup
        # table directly — a crash-restarted server rejoins with an empty
        # lookup and must relearn flushed-file sizes for range reads
        self.transport.send(self.tname, server, "ring",
                            {"ring": self.ring, "dead": sorted(self.dead),
                             "lookup": dict(self.lookup)})

    def _on_flush_done(self, msg: Message):
        epoch = msg.payload["epoch"]
        self.flush_done.setdefault(epoch, set()).add(msg.payload["server"])
        self.flush_bytes[epoch] = self.flush_bytes.get(epoch, 0) \
            + msg.payload.get("bytes", 0)
        # learn flushed-file sizes (max-merge, like the servers' own
        # lookup tables) and journal only what actually grew
        grown = {f: int(sz)
                 for f, sz in msg.payload.get("sizes", {}).items()
                 if int(sz) > self.lookup.get(f, -1)}
        if grown:
            self.lookup.update(grown)
            self._journal({"op": "lookup", "sizes": grown})
        # completion ledgers are bounded FIFO caches: epochs that aborted
        # (their flush_done never reaches quorum) would otherwise leak an
        # entry forever
        while len(self.flush_done) > self.flush_ledger_cap:
            e = next(iter(self.flush_done))
            self.flush_done.pop(e, None)
            self.flush_bytes.pop(e, None)
        with self._flush_lock:
            if epoch in self._user_flushes and self.flush_complete(epoch):
                del self._user_flushes[epoch]
        d = self._drain
        if d is not None and epoch == d["epoch"]:
            d["done"].add(msg.payload["server"])
            d["drained"].update(msg.payload.get("drained", []))
            d["bytes"] += msg.payload.get("bytes", 0)
            # strict completion: EVERY snapshot participant must report its
            # PFS writes durable before eviction may be broadcast (a death
            # mid-epoch goes through _abort_drain instead)
            if d["done"] >= d["expected"]:
                self._drain = None
                self.drain_stats["epochs"] += 1
                self.drain_stats["evicted_keys"] += len(d["drained"])
                self.drain_stats["drained_bytes"] += d["bytes"]
                if self._tele:
                    self._m_drain_s.observe(self._clock() - d["started"])
                telemetry.record(self.tname, "drain_complete", epoch=epoch,
                                 keys=len(d["drained"]), nbytes=d["bytes"])
                keys = sorted(d["drained"])
                for s in self.alive_ring():
                    self.transport.send(self.tname, s, "drain_evict",
                                        {"epoch": epoch, "keys": keys})

    def _on_server_error(self, msg: Message):
        self.errors.append(msg.payload)

    # autonomous drain coordination ------------------------------
    def _on_drain_pressure(self, msg: Message):
        self.pressure[msg.payload.get("server", msg.src)] = msg.payload

    def _on_drain_request(self, msg: Message):
        """A pressured server asked for a drain micro-epoch. One at a time,
        and never while an application flush epoch is in flight — the two-
        phase state (shuffle buffers, lookup sizes) is shared per server."""
        with self._flush_lock:
            busy = bool(self._user_flushes)
        if self._drain is not None or self._stage is not None or busy \
                or not self.ring:
            return
        epoch = self._next_drain_epoch
        self._next_drain_epoch += 1
        self._journal({"op": "epoch", "drain": epoch})
        self._drain = {"epoch": epoch, "started": self._clock(),
                       "expected": set(self.alive_ring()), "done": set(),
                       "drained": set(), "bytes": 0,
                       "requested_by": msg.payload.get("server")}
        telemetry.record(self.tname, "drain_begin", epoch=epoch,
                         requested_by=msg.payload.get("server"))
        for s in self.alive_ring():
            self.transport.send(self.tname, s, "flush_begin",
                                {"epoch": epoch, "drain": True})

    def _abort_drain(self, reason: str):
        d, self._drain = self._drain, None
        if d is None:
            return
        self.drain_stats["aborts"] += 1
        # cause label keeps the cardinality bounded: "server failure: s2"
        # collapses to "drain/server failure"
        self._m_aborts.inc(label="drain/" + reason.split(":")[0])
        telemetry.record(self.tname, "drain_abort", epoch=d["epoch"],
                         reason=reason)
        # notify every epoch PARTICIPANT, not just the currently-alive ring:
        # a falsely-dead server is still running and must refund its token
        # budget and drop its epoch snapshot (really-dead ones black-hole)
        for s in sorted(set(self.alive_ring()) | d["expected"]):
            self.transport.send(self.tname, s, "flush_abort",
                                {"epoch": d["epoch"], "reason": reason})

    # health engine ---------------------------------------------
    def _evaluate_health(self, now: float):
        """One SLO/watchdog/attribution pass on the run-loop cadence. The
        engine must never take the manager down: an evaluation error is
        flight-recorded and the stale report stands until the next tick."""
        reg = telemetry.registry()
        if reg is None:
            return
        inflight = {}
        d, st = self._drain, self._stage
        if d is not None:
            inflight["drain"] = {"epoch": d["epoch"],
                                 "started": d["started"]}
        if st is not None:
            inflight["stage"] = {"epoch": st["epoch"],
                                 "started": st["started"]}
        try:
            self._health.evaluate(reg.snapshot(), inflight=inflight,
                                  tracer=reg.tracer, now=now)
        except Exception as e:      # pragma: no cover - defensive
            telemetry.record("health", "evaluate_error", error=repr(e))

    def health_report(self) -> dict:
        """The latest health verdict (``health_query`` payload). A static
        stub when telemetry (and therefore the engine) is disabled."""
        if self._health is None:
            return {"status": "disabled", "evals": 0, "t": 0.0, "slos": [],
                    "watchdogs": [], "bottlenecks": {"ops": {}, "top": None}}
        return self._health.report()

    def _on_health_query(self, msg: Message):
        self.transport.reply(self.tname, msg, "health",
                             dict(self.health_report()))

    def _ops_snapshot(self) -> dict:
        """Telemetry poll callback: epoch counters + membership
        summary. Own-thread-mutated dicts of GIL-atomic ints — copies are
        coherent without a lock."""
        return {"drain": dict(self.drain_stats),
                "stage": dict(self.stage_stats),
                "dead": sorted(self.dead), "errors": len(self.errors)}

    def pressure_report(self) -> dict:
        """Cluster pressure view: per-server occupancy reports plus drain
        and stage progress counters, and the QoS summary the congestion
        windows act on."""
        d, st = self._drain, self._stage
        return {"servers": dict(self.pressure),
                "drain": dict(self.drain_stats),
                "stage": dict(self.stage_stats),
                "qos": self.qos_summary(),
                "health": self.health_report(),
                "inflight_epoch": d["epoch"] if d is not None else None,
                "inflight_stage": st["epoch"] if st is not None else None}

    def qos_summary(self) -> dict:
        """Cluster-level congestion view from the per-server pressure
        reports: occupancy spread and aggregate foreground ingest rate —
        what an operator (or the quickstart demo) reads to see whether the
        control plane is throttling background lanes."""
        occ = [p.get("fraction", 0.0) for p in self.pressure.values()]
        rates = [p.get("ingest_bps", 0.0) for p in self.pressure.values()]
        return {"servers_reporting": len(occ),
                "max_occupancy": max(occ, default=0.0),
                "mean_occupancy": sum(occ) / len(occ) if occ else 0.0,
                "aggregate_ingest_bps": sum(rates),
                "draining": sum(1 for p in self.pressure.values()
                                if p.get("draining"))}

    # stage-in coordination --------------------------------------
    def _on_stage_request(self, msg: Message):
        """A client asked to bulk-load a PFS file (or byte range) back into
        the buffer. One stage epoch at a time, never while a drain micro-
        epoch or an application flush is in flight — the two engines would
        otherwise thrash the same segments (stage admitting bytes the drain
        is busy flushing, drain evicting bytes the stage just loaded)."""
        with self._flush_lock:
            busy = bool(self._user_flushes)
        if self._stage is not None or self._drain is not None or busy \
                or not self.ring:
            self.transport.reply(self.tname, msg, "stage_ack",
                                 {"accepted": False})
            return
        epoch = self._next_stage_epoch
        self._next_stage_epoch += 1
        self._journal({"op": "epoch", "stage": epoch})
        ring = self.alive_ring()
        self._stage = {"epoch": epoch, "path": msg.payload["path"],
                       "started": self._clock(),
                       "expected": set(ring), "done": set(), "bytes": 0}
        telemetry.record(self.tname, "stage_begin", epoch=epoch,
                         path=msg.payload["path"])
        for s in ring:
            self.transport.send(self.tname, s, "stage_begin",
                                {"epoch": epoch,
                                 "file": msg.payload["path"],
                                 "lo": msg.payload.get("lo", 0),
                                 "hi": msg.payload.get("hi", -1),
                                 "ring": ring})
        self.transport.reply(self.tname, msg, "stage_ack",
                             {"accepted": True, "epoch": epoch})

    def _on_stage_done(self, msg: Message):
        st = self._stage
        epoch = msg.payload["epoch"]
        if st is None or epoch != st["epoch"]:
            return                   # straggler for an aborted epoch
        st["done"].add(msg.payload["server"])
        st["bytes"] += msg.payload.get("bytes", 0)
        if st["done"] >= st["expected"]:
            self._stage = None
            self.stage_stats["epochs"] += 1
            self.stage_stats["staged_bytes"] += st["bytes"]
            if self._tele:
                self._m_stage_s.observe(self._clock() - st["started"])
            telemetry.record(self.tname, "stage_complete", epoch=epoch,
                             nbytes=st["bytes"])
            self._record_stage(epoch, "done", st["bytes"])

    def _abort_stage(self, reason: str):
        st, self._stage = self._stage, None
        if st is None:
            return
        self.stage_stats["aborts"] += 1
        self._m_aborts.inc(label="stage/" + reason.split(":")[0])
        telemetry.record(self.tname, "stage_abort", epoch=st["epoch"],
                         reason=reason)
        self._record_stage(st["epoch"], "aborted", st["bytes"])
        for s in sorted(set(self.alive_ring()) | st["expected"]):
            self.transport.send(self.tname, s, "stage_abort",
                                {"epoch": st["epoch"], "reason": reason})

    def _record_stage(self, epoch: int, state: str, nbytes: int):
        self._stage_results[epoch] = {"state": state, "bytes": nbytes}
        while len(self._stage_results) > 1024:   # bounded poll history
            self._stage_results.pop(next(iter(self._stage_results)))

    def _on_stage_status(self, msg: Message):
        epoch = msg.payload["epoch"]
        st = self._stage
        if st is not None and st["epoch"] == epoch:
            out = {"state": "inflight", "bytes": st["bytes"]}
        else:
            out = self._stage_results.get(epoch, {"state": "unknown",
                                                  "bytes": 0})
        self.transport.reply(self.tname, msg, "stage_status_ack",
                             {"epoch": epoch, **out})

    # file-session namespace (BBFileSystem) --------------------------------
    def _on_fs_open(self, msg: Message):
        """Register a path on open-for-write; idempotent. "w" resets the
        recorded size (truncate semantics); ``existed`` reports the state
        BEFORE this open so the client knows to truncate stale chunks."""
        path = msg.payload["path"]
        # any prior open-for-write counts as existing — even an unsynced
        # (crashed) incarnation may have landed chunks that must truncate
        existed = path in self.namespace
        ent = self.namespace.setdefault(
            path, {"size": 0, "synced": False, "opened_by": set()})
        ent["opened_by"].add(msg.src)
        if msg.payload.get("mode") == "w":
            ent["size"] = 0
            ent["synced"] = False
        self._journal_ns(path)
        self.transport.reply(self.tname, msg, "fs_open_ack",
                             {"path": path, "existed": existed,
                              "size": ent["size"]})

    def _on_fs_sync(self, msg: Message):
        """A sync barrier completed: record the session's high-water size."""
        path = msg.payload["path"]
        ent = self.namespace.setdefault(
            path, {"size": 0, "synced": False, "opened_by": set()})
        ent["size"] = max(ent["size"], msg.payload.get("size", 0))
        ent["synced"] = True
        # journaled BEFORE the ack: once the app's sync() returns, the
        # path's existence and size survive a manager crash
        self._journal_ns(path)
        self.transport.reply(self.tname, msg, "fs_sync_ack", {"path": path})

    def _on_fs_stat(self, msg: Message):
        """Namespace view of a path: the only source that knows about
        zero-byte synced files (no chunks, no PFS copy)."""
        ent = self.namespace.get(msg.payload["path"])
        self.transport.reply(self.tname, msg, "fs_stat_ack",
                             {"known": ent is not None and ent["synced"],
                              "size": ent["size"] if ent else 0})

    def _on_fs_list(self, msg: Message):
        # synced entries only, matching _on_fs_stat's "known" rule — an
        # opened-but-never-synced path must not appear to exist
        prefix = msg.payload.get("prefix", "")
        self.transport.reply(
            self.tname, msg, "fs_list_ack",
            {"paths": sorted(p for p, e in self.namespace.items()
                             if p.startswith(prefix) and e["synced"])})

    def _on_fs_truncate(self, msg: Message):
        path = msg.payload["path"]
        ent = self.namespace.get(path)
        if ent is not None:
            ent["size"] = 0
            ent["synced"] = False
            self._journal_ns(path)
        if path in self.lookup:
            self.lookup.pop(path, None)
            self._journal({"op": "lookup_del", "path": path})
        self.transport.reply(self.tname, msg, "fs_truncate_ack",
                             {"path": path})

    def _on_fs_unlink(self, msg: Message):
        """Drop a path from the namespace and its buffered chunks on every
        server. Uses the exact-match file_truncate message, NOT prefix
        eviction — unlinking "run" must not destroy "run_info.txt"."""
        path = msg.payload["path"]
        if self.namespace.pop(path, None) is not None:
            self._journal({"op": "ns_del", "path": path})
        if path in self.lookup:
            self.lookup.pop(path, None)
            self._journal({"op": "lookup_del", "path": path})
        for s in self.alive_ring():
            self.transport.send(self.tname, s, "file_truncate",
                                {"file": path})
        self.transport.reply(self.tname, msg, "fs_unlink_ack", {"path": path})

    def begin_flush(self, epoch: int):
        """Start an application flush epoch. Serialized against drain
        micro-epochs: overlapping epochs would share server-side shuffle
        buffers and lookup sizes, so wait (bounded) for an in-flight drain
        to finish or abort before broadcasting."""
        if epoch >= DRAIN_EPOCH_BASE:
            raise ValueError(
                f"user flush epoch {epoch} collides with the reserved "
                f"drain/stage id space (must be < {DRAIN_EPOCH_BASE})")
        deadline = self._clock() + self.drain_epoch_timeout
        while self._drain is not None and self._clock() < deadline:
            time.sleep(self.drain_serialize_poll)
        with self._flush_lock:
            self._user_flushes[epoch] = self._clock()
            # participant snapshot for flush_complete(); bounded FIFO like
            # the done/bytes ledgers (aborted epochs never clean up)
            self._flush_expected[epoch] = set(self.alive_ring())
            while len(self._flush_expected) > self.flush_ledger_cap:
                self._flush_expected.pop(next(iter(self._flush_expected)))
        for s in self.alive_ring():
            self.transport.send(self.tname, s, "flush_begin", {"epoch": epoch})

    def evict(self, prefix: str):
        for s in self.alive_ring():
            self.transport.send(self.tname, s, "evict_epoch",
                                {"prefix": prefix})
