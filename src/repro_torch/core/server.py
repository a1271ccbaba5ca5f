"""Burst buffer server daemon (paper §II, §III, §IV).

One thread per server. Responsibilities:
  - store key-value pairs in the log-structured DRAM/SSD store (tiering.py)
  - chain replication along ring successors with ACKs back to the primary
    (paper Fig 4), pipelined: the primary ACKs the client once its own store
    plus R-1 successor ACKs have arrived
  - load-balanced buffering (paper §III-A): when DRAM is exhausted, query
    ring neighbours for free memory and redirect the client to the best one
  - Chord-style stabilization (paper §IV-A): periodic ping of PRE/SUC1/SUC2;
    on a dead successor, splice it out, adopt the next, inform the manager
  - two-phase I/O flush (paper §III-B): all-to-all metadata exchange, file
    domains, shuffle, one sequential PFS write per domain
  - post-shuffle lookup table (paper §III-C): (file -> global size), from
    which any server can compute which peer owns any byte range
  - autonomous drain engine: watermark policy over LogStore
    occupancy requests manager-coordinated drain micro-epochs that push
    whole cold segments through the two-phase planner, then evict them
    (index tombstones) once every participant reported the epoch durable;
    a burst detector defers draining while ingest is hot and a token
    bucket caps drain bandwidth so flushing never competes with absorption
  - stage-in engine: the drain run in reverse — a manager-
    coordinated stage epoch re-ingests a PFS file into the buffer,
    partitioned by lookup-table domains so every server loads its own
    domain in parallel; staged bytes are marked CLEAN (durable copy
    exists), giving the drainer a free clean-evict fast path and staging
    an admission guard so it can never trigger a drain storm
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core import qos, staging, telemetry, twophase
from repro_torch.core.drain import DrainConfig, DrainEngine
from repro_torch.core.qos import QoSConfig
from repro_torch.core.staging import StageConfig
from repro_torch.core.tiering import LogStore
from repro_torch.core.transport import Message, Transport


# interval math shared with the stage planner (one implementation)
_merge_intervals = staging.merge_intervals
_gaps = staging.gaps


class BBServer(threading.Thread):
    def __init__(self, name: str, transport: Transport, *,
                 dram_capacity: int = 64 << 20,
                 ssd_dir: Optional[str] = None,
                 ssd_capacity: Optional[int] = None,
                 segment_bytes: Optional[int] = None,
                 pfs_dir: str = "/tmp/pfs",
                 replication: int = 2,
                 stabilize_interval: float = 0.25,
                 poll_interval: float = 0.02,
                 drain: Optional[DrainConfig] = None,
                 stage: Optional[StageConfig] = None,
                 qos_cfg: Optional[QoSConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(daemon=True, name=name)
        self.tname = name
        self._clock = clock
        self.transport = transport
        self.ep = transport.register(name)
        self.store = LogStore(dram_capacity, ssd_dir,
                              name=name.replace("/", "_"),
                              ssd_capacity=ssd_capacity,
                              segment_bytes=segment_bytes,
                              clock=clock)
        self.pfs_dir = pfs_dir
        self.replication = replication
        self.stabilize_interval = stabilize_interval
        self.poll_interval = poll_interval
        self.drain_cfg = drain or DrainConfig()
        # QoS: lane-priority dequeue of buffered puts, plus ONE
        # background-bandwidth arbiter shared by the drain + stage engines
        self.qos_cfg = qos_cfg or QoSConfig()
        if self.qos_cfg.enabled:
            self.arbiter: Optional[qos.BandwidthArbiter] = \
                qos.BandwidthArbiter(self.qos_cfg,
                                     self.drain_cfg.bw_bytes_per_s)
            self._laneq: Optional[qos.LaneQueue] = qos.LaneQueue(
                self.qos_cfg.lane_weights, self.qos_cfg.quantum_bytes)
        else:
            self.arbiter = None
            self._laneq = None
        self.drainer = DrainEngine(self.drain_cfg, bucket=self.arbiter) \
            if self.drain_cfg.enabled else None
        self.stage_cfg = stage or StageConfig()

        self.ring: List[str] = []            # manager-ordered server list
        self.alive: Dict[str, bool] = {}
        self.manager = "manager"
        self._stop = threading.Event()
        self._last_stab = 0.0

        # replication bookkeeping, keyed by (client, msg_id) so a stray or
        # colliding replica_ack can never satisfy an unrelated client's put:
        # (client, msg_id) -> [client, acks_needed, original_msg]
        self._pending_primary: Dict[tuple, List] = {}
        # segments buffered for flush: key -> Segment
        self._segments: Dict[str, twophase.Segment] = {}
        # per-file chunk manifest (BBFileSystem metadata path):
        # file -> {offset: (key, length)} — same facts as _segments, indexed
        # by file so open/stat/read never scan every buffered key
        self._files: Dict[str, Dict[int, tuple]] = {}
        # flush state per epoch
        self._flush: Dict[int, dict] = {}
        # post-shuffle lookup table: file -> global size (paper §III-C)
        self.lookup_table: Dict[str, int] = {}
        # domain data received from shuffle: (file, offset) -> bytes
        self._domain_data: Dict[str, Dict[int, bytes]] = {}
        # drain-engine bookkeeping: evicted-chunk tombstone records (the
        # transparent read path needs (file, offset, length) to fall through
        # to the lookup table / PFS) and per-drain-epoch snapshots
        self._evicted: Dict[str, tuple] = {}     # key -> (file, off, len)
        self._evicted_files: Dict[str, Dict[int, tuple]] = {}
        self._drain_epochs: Dict[int, dict] = {}  # epoch -> keys/gens/bytes
        # stage-in epochs: epoch -> coverage metas + range state
        self._stage_epochs: Dict[int, dict] = {}
        # epochs already written or aborted: late flush_meta/shuffle_done
        # stragglers must not resurrect them through _flush_state's
        # auto-create (a zombie entry would wedge self._flush forever and
        # block the _domain_data reclamation gated on it)
        self._closed_epochs: set = set()
        self._last_pressure = 0.0
        self.stats = {"puts": 0, "batch_puts": 0, "redirects": 0, "spills": 0,
                      "flushes": 0, "stabilize_repairs": 0,
                      "drain_epochs": 0, "drained_bytes": 0, "evictions": 0,
                      "stage_epochs": 0, "staged_bytes": 0,
                      "clean_evictions": 0, "clean_evicted_bytes": 0,
                      "bypass_chunks": 0, "bypass_bytes": 0,
                      "recovered_keys": 0, "recovered_bytes": 0,
                      "puts_by_lane": [0] * len(qos.LANES)}
        # unknown-kind messages (protocol black-hole detector):
        # kind -> count; surfaced in drain_pressure and stats_query, and the
        # first occurrence of each kind is reported as a server_error
        self.unknown_kinds: Dict[str, int] = {}
        # telemetry: _tele is captured once — when telemetry is
        # disabled the factories hand back the shared no-op and the guarded
        # clock stamps below are skipped, so the per-message path is free
        self._tele = telemetry.enabled()
        self._m_lane_wait = telemetry.histogram("server.lane_wait_s")
        self._m_dispatch = telemetry.histogram("server.dispatch_s")
        self._m_occ = telemetry.ring("server.occupancy")
        telemetry.poll("server.ops", self._stats_snapshot, label=name)
        # async stabilization state
        self._inflight_pings: Dict[int, tuple] = {}   # nonce -> (peer, deadline)
        self._ping_misses: Dict[str, int] = {}
        self._last_pong: Dict[str, float] = {}
        self._neighbor_free: Dict[str, int] = {}      # gossiped free DRAM
        self._pending_confirms: List[list] = []

    # ------------------------------------------------------------- ring math
    def _idx(self) -> int:
        return self.ring.index(self.tname)

    def successors(self, n: Optional[int] = None) -> List[str]:
        n = n if n is not None else self.replication
        if self.tname not in self.ring:
            return []
        i = self._idx()
        out = []
        for j in range(1, len(self.ring)):
            s = self.ring[(i + j) % len(self.ring)]
            if self.alive.get(s, True) and s != self.tname:
                out.append(s)
            if len(out) >= n:
                break
        return out

    def predecessor(self) -> Optional[str]:
        if self.tname not in self.ring:
            return None
        i = self._idx()
        for j in range(1, len(self.ring)):
            s = self.ring[(i - j) % len(self.ring)]
            if self.alive.get(s, True) and s != self.tname:
                return s
        return None

    def alive_ring(self) -> List[str]:
        return [s for s in self.ring if self.alive.get(s, True)]

    # ---------------------------------------------------------------- thread
    def run(self):
        # Crash recovery: if the LogStore came up over a surviving
        # SSD log, rebuild the chunk manifests from the recovered keys
        # before touching the inbox — messages just queue up meanwhile, so
        # no read can observe a half-rebuilt manifest.
        self._recover_manifests()
        while not self._stop.is_set():
            # With QoS enabled, the inbox is drained in bursts: control
            # messages dispatch immediately (reads and pings stay responsive
            # under a put flood), while put/put_batch messages park in the
            # lane queue and are applied below in weighted priority order —
            # a checkpoint burst no longer waits behind every background put
            # that happened to arrive first.
            busy = self._laneq is not None and len(self._laneq) > 0
            msg = self.ep.recv(timeout=0.0 if busy else self.poll_interval)
            burst = self.qos_cfg.server_recv_burst
            while msg is not None:
                self._safe_dispatch(msg)
                burst -= 1
                if burst <= 0:
                    break
                msg = self.ep.recv(timeout=0)
            if self._laneq is not None:
                for _ in range(self.qos_cfg.server_ops_per_tick):
                    ent = self._laneq.pop()
                    if ent is None:
                        break
                    self._safe_dispatch(ent, queued=True)
            now = self._clock()
            if now - self._last_stab > self.stabilize_interval and self.ring:
                self._last_stab = now
                self._stabilize(now)
            self._check_ping_deadlines(now)
            self._check_confirm_deadlines(now)
            self._drain_tick(now)
            self._stage_tick(now)

    def _safe_dispatch(self, msg: Message, queued: bool = False):
        try:
            if not queued and self._qos_enqueue(msg):
                return
            if not self._tele:
                self._dispatch(msg)
                return
            lane_name = None
            if msg.kind in self._LANED_KINDS:
                lane = msg.payload.get("lane")
                lane_name = qos.LANES[qos.LANE_INTERACTIVE if lane is None
                                      else qos.lane_index(lane)]
                parked = getattr(msg, "_parked_at", 0.0)
                if parked:
                    wait = self._clock() - parked
                    self._m_lane_wait.observe(wait, label=lane_name)
                    # a parked message has no thread to hold a span open,
                    # so the wait is recorded as an already-completed span
                    # under the put's trace — the health engine's critical-
                    # path pass reads it as the "queue" segment
                    telemetry.observe_span(
                        "server.lane_wait", self.tname,
                        telemetry.trace_from(msg.payload), parked, wait,
                        lane=lane_name)
            t0 = self._clock()
            with telemetry.msg_span("server." + msg.kind, self.tname,
                                    msg.payload):
                self._dispatch(msg)
            if lane_name is not None:
                self._m_dispatch.observe(self._clock() - t0, label=lane_name)
        except Exception as e:   # pragma: no cover - defensive
            self.transport.send(self.tname, self.manager, "server_error",
                                {"server": self.tname, "error": repr(e)})

    _LANED_KINDS = ("put", "put_batch", "replica_put", "replica_put_batch")

    def _qos_enqueue(self, msg: Message) -> bool:
        """Park puts — client-facing AND replica-chain — in the lane queue
        (everything else: reads, ACKs, control, dispatches immediately).
        Replica traffic carries the originating put's lane: a checkpoint
        chunk's ACK depends on its replica hop, so an unprioritized
        replica path would hand the background flood the priority back.
        FIFO order is preserved within a lane, so same-key rewrites from
        one stream stay ordered; cross-lane writes to one key were never
        ordered."""
        if self._laneq is None or msg.kind not in self._LANED_KINDS:
            return False
        p = msg.payload
        lane = p.get("lane")
        lane = qos.LANE_INTERACTIVE if lane is None else qos.lane_index(lane)
        if "items" in p:
            nbytes = sum(len(it["value"]) for it in p["items"])
        else:
            nbytes = len(p["value"])
        if self._tele:
            msg._parked_at = self._clock()
        self._laneq.push(lane, msg, nbytes)
        if msg.kind in ("put", "put_batch"):
            self.stats["puts_by_lane"][lane] += 1
        return True

    def stop(self):
        self._stop.set()

    # -------------------------------------------------------------- dispatch
    def _dispatch(self, msg: Message):
        handler = getattr(self, f"_on_{msg.kind}", None)
        if handler is None:
            # protocol black-hole detector: a typo'd or stale
            # kind must be distinguishable from server death — count it,
            # and tell the manager the first time each kind shows up
            n = self.unknown_kinds.get(msg.kind, 0) + 1
            self.unknown_kinds[msg.kind] = n
            if n == 1:
                telemetry.record(self.tname, "unknown_kind",
                                 kind=msg.kind, src=msg.src)
                self.transport.send(
                    self.tname, self.manager, "server_error",
                    {"server": self.tname,
                     "error": f"unknown message kind {msg.kind!r} "
                              f"from {msg.src}"})
            return
        handler(msg)

    def _recover_manifests(self):
        """Rebuild per-file chunk manifests from keys a LogStore recovery
        brought back. Chunk keys are ``{path}:{offset}``; anything
        else (no separator, non-numeric offset) is kept readable by key but
        cannot join a file manifest."""
        keys = self.store.recovered_keys
        if not keys:
            return
        lengths = self.store.items_bytes()
        nbytes = 0
        for key in keys:
            length = lengths.get(key)
            if length is None:
                continue
            file, sep, off = key.rpartition(":")
            if sep and file and off.isdigit():
                self._record_segment(key, file, int(off), length)
            nbytes += length
        self.stats["recovered_keys"] = len(keys)
        self.stats["recovered_bytes"] = nbytes

    # ring bootstrap / updates -------------------------------------------
    def _on_ring(self, msg: Message):
        self.ring = list(msg.payload["ring"])
        dead = set(msg.payload.get("dead", []))
        self.alive = {s: s not in dead for s in self.ring}
        # a manager journal replay re-seeds the lookup table through the
        # ring bootstrap, so range reads of flushed files survive a
        # whole-cluster restart
        self._merge_lookup(msg.payload.get("lookup", {}))

    def _on_ring_update(self, msg: Message):
        dead = msg.payload.get("dead", [])
        joined = msg.payload.get("joined", [])
        for s in dead:
            self.alive[s] = False
        for s in joined:
            if s not in self.ring:
                # join at the announced position (paper Fig 3)
                pred = msg.payload.get("pred")
                if pred in self.ring:
                    self.ring.insert(self.ring.index(pred) + 1, s)
                else:
                    self.ring.append(s)
            self.alive[s] = True
        if dead:
            self._re_replicate()
            self._prune_flush_expected(set(dead))

    # put path -------------------------------------------------------------
    def _record_segment(self, key: str, file: Optional[str], offset: int,
                        length: int):
        """Track a buffered chunk in both flush-segment and per-file views.
        A live buffered chunk shadows any tombstone at its key (a rewrite
        of drained/bypassed bytes is fresher than the PFS copy), so the
        tombstone record is dropped here."""
        if file is None:
            return
        old = self._segments.get(key)
        if old is not None:
            fmap = self._files.get(old.file)
            if fmap is not None and fmap.get(old.offset, (None, 0))[0] == key:
                del fmap[old.offset]
        if key in self._evicted:
            self._evicted.pop(key, None)
            emap = self._evicted_files.get(file)
            if emap is not None and emap.get(offset, (None, 0))[0] == key:
                del emap[offset]
                if not emap:
                    del self._evicted_files[file]
        self._segments[key] = twophase.Segment(file, offset, length)
        self._files.setdefault(file, {})[offset] = (key, length)

    def _drop_segment(self, key: str):
        seg = self._segments.pop(key, None)
        if seg is None:
            return
        fmap = self._files.get(seg.file)
        if fmap is not None and fmap.get(seg.offset, (None, 0))[0] == key:
            del fmap[seg.offset]
            if not fmap:
                del self._files[seg.file]

    def _occupancy_frac(self) -> float:
        return self.store.occupancy()["fraction"]

    def _note_foreground(self, nbytes: int):
        """Feed the burst detector AND the background-bandwidth arbiter:
        foreground ingest is the signal that throttles drain/stage."""
        if self.drainer is not None:
            self.drainer.note_ingest(nbytes)
        if self.arbiter is not None:
            self.arbiter.note_foreground(nbytes)

    def _on_put(self, msg: Message):
        p = msg.payload
        key, value = p["key"], p["value"]
        self.stats["puts"] += 1
        if p.get("_stale"):        # truncated while parked: ack, don't store
            self.transport.reply(self.tname, msg, "put_ack",
                                 {"key": key,
                                  "occupancy": self._occupancy_frac()})
            return
        self._note_foreground(len(value))

        # load-balanced buffering: redirect if DRAM exhausted (paper §III-A)
        if p.get("redirectable", True) \
                and self.store.dram_free() < len(value):
            target = self._least_loaded_neighbor(len(value))
            if target is not None:
                self.stats["redirects"] += 1
                telemetry.record(self.tname, "redirect", key=key,
                                 target=target)
                self.transport.reply(self.tname, msg, "redirect",
                                     {"key": key, "target": target,
                                      "occupancy": self._occupancy_frac()})
                return

        tier = self.store.put(key, value)
        if tier == "ssd":
            self.stats["spills"] += 1
        self._record_segment(key, p.get("file"), p.get("offset", 0),
                             len(value))

        chain: List[str] = p.get("chain")
        if chain is None:
            chain = self.successors(self.replication - 1)
        if chain:
            nxt, rest = chain[0], chain[1:]
            self._pending_primary[(msg.src, msg.msg_id)] = \
                [msg.src, len(chain), msg]
            self.transport.send(self.tname, nxt, "replica_put", {
                "key": key, "value": value, "chain": rest,
                "primary": self.tname, "primary_msg": msg.msg_id,
                "client": msg.src, "lane": p.get("lane"),
                "file": p.get("file"), "offset": p.get("offset", 0)})
        else:
            self.transport.reply(self.tname, msg, "put_ack",
                                 {"key": key,
                                  "occupancy": self._occupancy_frac()})

    def _on_put_batch(self, msg: Message):
        """Coalesced put (client write coalescing): store every segment in
        one message, replicate the whole batch down the chain, ACK once.
        Batches are never redirected — the store spills to SSD instead, so
        the per-batch cost stays a single round-trip."""
        items = msg.payload["items"]
        self.stats["puts"] += len(items)
        self.stats["batch_puts"] += 1
        self._note_foreground(sum(len(it["value"]) for it in items
                                  if not it.get("_stale")))
        for it in items:
            if it.get("_stale"):   # truncated while parked: ack, don't store
                continue           # (the flag travels the replica chain too)
            tier = self.store.put(it["key"], it["value"])
            if tier == "ssd":
                self.stats["spills"] += 1
            self._record_segment(it["key"], it.get("file"),
                                 it.get("offset", 0), len(it["value"]))
        chain = self.successors(self.replication - 1)
        if chain:
            nxt, rest = chain[0], chain[1:]
            self._pending_primary[(msg.src, msg.msg_id)] = \
                [msg.src, len(chain), msg]
            self.transport.send(self.tname, nxt, "replica_put_batch", {
                "items": items, "chain": rest, "primary": self.tname,
                "primary_msg": msg.msg_id, "client": msg.src,
                "lane": msg.payload.get("lane")})
        else:
            self.transport.reply(self.tname, msg, "put_batch_ack",
                                 {"count": len(items),
                                  "occupancy": self._occupancy_frac()})

    def _on_replica_put(self, msg: Message):
        p = msg.payload
        if not p.get("_stale"):    # truncated while parked: protocol only
            self._note_foreground(len(p["value"]))
            self.store.put(p["key"], p["value"])
            self._record_segment(p["key"], p.get("file"),
                                 p.get("offset", 0), len(p["value"]))
        if p["chain"]:
            nxt, rest = p["chain"][0], p["chain"][1:]
            self.transport.send(self.tname, nxt, "replica_put",
                                {**p, "chain": rest})
        if p.get("primary_msg") is None:
            return              # re-replication copy: nobody is waiting
        self.transport.send(self.tname, p["primary"], "replica_ack",
                            {"primary_msg": p["primary_msg"],
                             "client": p.get("client"), "key": p["key"]})

    def _on_replica_put_batch(self, msg: Message):
        p = msg.payload
        self._note_foreground(sum(len(it["value"]) for it in p["items"]
                                  if not it.get("_stale")))
        for it in p["items"]:
            if it.get("_stale"):
                continue
            self.store.put(it["key"], it["value"])
            self._record_segment(it["key"], it.get("file"),
                                 it.get("offset", 0), len(it["value"]))
        if p["chain"]:
            nxt, rest = p["chain"][0], p["chain"][1:]
            self.transport.send(self.tname, nxt, "replica_put_batch",
                                {**p, "chain": rest})
        self.transport.send(self.tname, p["primary"], "replica_ack",
                            {"primary_msg": p["primary_msg"],
                             "client": p.get("client"),
                             "key": p["items"][0]["key"]})

    def _on_replica_ack(self, msg: Message):
        pm = msg.payload.get("primary_msg")
        if pm is None:
            return              # re-replication sentinel: not a client put
        entry = self._pending_primary.get((msg.payload.get("client"), pm))
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            client, _, orig = self._pending_primary.pop(
                (msg.payload.get("client"), pm))
            occ = self._occupancy_frac()
            if orig.kind == "put_batch":
                self.transport.reply(self.tname, orig, "put_batch_ack",
                                     {"count": len(orig.payload["items"]),
                                      "occupancy": occ})
            else:
                self.transport.reply(self.tname, orig, "put_ack",
                                     {"key": msg.payload["key"],
                                      "occupancy": occ})

    def _least_loaded_neighbor(self, need: int) -> Optional[str]:
        """Pick the neighbour with the most free DRAM (paper §III-A). Free-
        memory info is gossiped on every stabilization pong, so this is a
        local lookup — the server loop never blocks on an RPC."""
        best, best_free = None, max(self.store.dram_free(), need)
        for peer, free in self._neighbor_free.items():
            if peer != self.tname and self.alive.get(peer, False) \
                    and free > best_free:
                best, best_free = peer, free
        return best

    # get path -------------------------------------------------------------
    def _on_get(self, msg: Message):
        key = msg.payload["key"]
        val = self.store.get(key)
        if val is not None:
            self.transport.reply(self.tname, msg, "get_ack",
                                 {"key": key, "value": val, "hit": True})
            return
        miss = {"key": key, "value": None, "hit": False}
        ev = self._evicted.get(key)
        if ev is not None:
            # drained-and-evicted chunk: tell the client where the bytes
            # live (file, offset, length) so it can fall through to the
            # lookup-table range read / PFS — eviction stays invisible
            miss["evicted"] = list(ev)
        self.transport.reply(self.tname, msg, "get_ack", miss)

    def _on_read_range(self, msg: Message):
        """Serve a post-shuffle byte range of a flushed file (paper §III-C)."""
        p = msg.payload
        f, off, length = p["file"], p["offset"], p["length"]
        chunks = self._domain_data.get(f, {})
        buf = bytearray(length)
        covered = []                        # [lo, hi) intervals, file space
        for base, data in chunks.items():
            lo = max(off, base)
            hi = min(off + length, base + len(data))
            if lo < hi:
                buf[lo - off:hi - off] = data[lo - base:hi - base]
                covered.append([lo, hi])
        covered = _merge_intervals(covered)
        filled = sum(hi - lo for lo, hi in covered)
        if filled < length:
            # fill only the gaps from the PFS — buffered chunks are at least
            # as fresh as the durable copy and must not be clobbered
            path = os.path.join(self.pfs_dir, f)
            if os.path.exists(path):
                with open(path, "rb") as fh:
                    fh.seek(off)
                    pfs = fh.read(length)
                for lo, hi in _gaps(covered, off, off + len(pfs)):
                    buf[lo - off:hi - off] = pfs[lo - off:hi - off]
                    covered.append([lo, hi])
                covered = _merge_intervals(covered)
                filled = sum(hi - lo for lo, hi in covered)
        self.transport.reply(self.tname, msg, "range_ack",
                             {"data": bytes(buf), "complete": filled >= length})

    def _on_file_info(self, msg: Message):
        f = msg.payload["file"]
        size = self.lookup_table.get(f)
        doms = None
        if size is not None:
            doms = twophase.domains(size, self.alive_ring())
        self.transport.reply(self.tname, msg, "file_info_ack",
                             {"file": f, "size": size, "domains": doms})

    # file-session metadata (BBFileSystem) ---------------------------------
    def _file_stat_payload(self, f: str) -> dict:
        fmap = self._files.get(f, {})
        emap = self._evicted_files.get(f, {})
        buffered = max((off + ln for off, (_, ln) in fmap.items()), default=0)
        residency = {"dram": 0, "ssd": 0, "pfs": 0}
        for _off, (key, ln) in fmap.items():
            tier = self.store.tier_of(key)
            if tier in residency:
                residency[tier] += ln
        residency["pfs"] += sum(ln for _, ln in emap.values())
        return {"file": f, "buffered": buffered, "chunks": len(fmap),
                "flushed_size": self.lookup_table.get(f),
                "residency": residency, "evicted_chunks": len(emap),
                "known": f in self._files or f in self.lookup_table
                or f in self._evicted_files}

    def _on_file_stat(self, msg: Message):
        """Per-file metadata: buffered extent + chunk count from the local
        manifest, durable size from the post-shuffle lookup table."""
        self.transport.reply(self.tname, msg, "file_stat_ack",
                             self._file_stat_payload(msg.payload["file"]))

    def _on_file_chunks(self, msg: Message):
        """The local chunk manifest for one file: [(offset, key, length,
        clean)]. Clients merge manifests across servers to assemble
        buffered reads without knowing the writer's striping; the clean
        flag lets the merge prefer dirty copies — a buffered write is at
        least as fresh as any staged re-ingest of the PFS copy."""
        fmap = self._files.get(msg.payload["file"], {})
        chunks = [[off, key, ln, self.store.is_clean(key)]
                  for off, (key, ln) in fmap.items()]
        self.transport.reply(self.tname, msg, "file_chunks_ack",
                             {"file": msg.payload["file"], "chunks": chunks})

    def _on_file_truncate(self, msg: Message):
        """Open-for-write truncation: drop every buffered chunk of the file
        (primary and replica copies alike — the message is broadcast), its
        shuffle data, and its lookup-table entry, so a rewrite can never
        read back stale tail bytes from a longer previous incarnation.

        Puts of this file still PARKED in the lane queue are marked stale:
        pre-QoS the FIFO inbox guaranteed they applied before the truncate
        that followed them, but lane parking would apply them after it and
        resurrect the dead incarnation. A stale put is ACKed without being
        stored — byte-for-byte the FIFO outcome (applied, then truncated a
        moment later)."""
        f = msg.payload["file"]
        if self._laneq is not None:
            for queued in self._laneq.entries():
                p = queued.payload
                for it in p.get("items", (p,)):
                    if it.get("file") == f:
                        it["_stale"] = True
        for off, (key, _ln) in self._files.pop(f, {}).items():
            self.store.delete(key)
            self._segments.pop(key, None)
        for off, (key, _ln) in self._evicted_files.pop(f, {}).items():
            self.store.delete(key)      # clears the tombstone too
            self._evicted.pop(key, None)
        # a replay must not resurrect chunks of the truncated file
        self.store.sync()
        self.lookup_table.pop(f, None)
        self._domain_data.pop(f, None)
        self.transport.reply(self.tname, msg, "file_truncate_ack",
                             {"file": f})

    def _on_bypass_report(self, msg: Message):
        """A client wrote bytes of ``file`` straight to the PFS (QoS
        write-through bypass) — the bytes never touch the buffer,
        only their residency metadata lands here. Every server max-merges
        the file's lookup-table size so post-shuffle range reads cover the
        bypassed extent, and EVICTS any live buffered chunk the run fully
        covers: those chunks hold older bytes of the same range (the
        handle flushes its pending run before any buffered write, so a
        report can never chase a fresher put), and leaving them live would
        shadow the newer PFS copy forever. The tombstones point reads at
        the PFS like any drained chunk. A chunk only PARTIALLY covered by
        the run is left alone — its uncovered bytes exist nowhere else,
        and sub-chunk overlapping writes are documented-undefined.
        Each chunk-granular slice of the run carries its own placement
        owner, which records the slice as an eviction tombstone so direct
        KV gets of ANY ``{file}:{offset}`` inside the run fall through."""
        p = msg.payload
        f, off, ln = p["file"], p["offset"], p["length"]
        lo, hi = off, off + ln
        self._merge_lookup({f: p.get("size", hi)})
        for c_off, (key, c_ln) in list(self._files.get(f, {}).items()):
            if lo <= c_off and c_off + c_ln <= hi:
                # the PFS run covers this chunk end to end: the durable
                # copy supersedes it (mid-drain-epoch safe — the shuffle
                # skips evicted keys, drain_evict frees 0 on them)
                self.store.evict(key)
                self._evicted[key] = (f, c_off, c_ln)
                self._evicted_files.setdefault(f, {})[c_off] = (key, c_ln)
                self._drop_segment(key)
        # harden the tombstones NOW: here (unlike a drain evict) the PFS
        # copy is NEWER than the buffered bytes, so a replay resurrecting
        # them would serve stale data
        self.store.sync()
        for s_off, s_ln, owner in p.get("chunks", ()):
            if owner != self.tname:
                continue
            key = f"{f}:{s_off}"
            if key not in self.store and key not in self._segments:
                self._evicted[key] = (f, s_off, s_ln)
                self._evicted_files.setdefault(f, {})[s_off] = (key, s_ln)
            self.stats["bypass_chunks"] += 1
            self.stats["bypass_bytes"] += s_ln

    # stabilization --------------------------------------------------------
    # Fully asynchronous (the server loop never blocks): pings are fired and
    # tracked with deadlines; pongs piggyback free-DRAM gossip (paper §III-A
    # + §IV-A in one mechanism). Missing ``miss_limit`` consecutive pongs
    # marks the neighbour dead — splice, adopt next successor, tell manager.

    MISS_LIMIT = 3
    PING_TIMEOUT = 0.6

    def _stabilize(self, now: float):
        for s in self.successors(2):
            if any(peer == s for peer, _ in self._inflight_pings.values()):
                continue
            nonce = self._ping_nonce = getattr(self, "_ping_nonce", 0) + 1
            self._inflight_pings[nonce] = (s, now + self.PING_TIMEOUT)
            self.transport.send(self.tname, s, "ping",
                                {"nonce": nonce, "from": self.tname})

    def _check_ping_deadlines(self, now: float):
        expired = [n for n, (peer, dl) in self._inflight_pings.items()
                   if dl < now]
        for n in expired:
            peer, _ = self._inflight_pings.pop(n)
            self._ping_misses[peer] = self._ping_misses.get(peer, 0) + 1
            if self._ping_misses[peer] >= self.MISS_LIMIT \
                    and self.alive.get(peer, False):
                self._declare_dead(peer)

    def _declare_dead(self, peer: str):
        self.alive[peer] = False
        self.stats["stabilize_repairs"] += 1
        nxt = self.successors(1)
        if nxt:
            self.transport.send(self.tname, nxt[0], "neighbor_died",
                                {"dead": peer})
        self.transport.send(self.tname, self.manager, "failure_report",
                            {"dead": peer, "reporter": self.tname})
        self._re_replicate()
        self._prune_flush_expected({peer})

    def _on_ping(self, msg: Message):
        self.transport.send(self.tname, msg.src, "pong",
                            {"nonce": msg.payload["nonce"],
                             "free": self.store.dram_free()})

    def _on_pong(self, msg: Message):
        self._inflight_pings.pop(msg.payload["nonce"], None)
        self._ping_misses[msg.src] = 0
        self._last_pong[msg.src] = self._clock()
        self._neighbor_free[msg.src] = msg.payload["free"]
        # a pong from a node we thought dead -> it is back (partition healed)
        if not self.alive.get(msg.src, True):
            self.alive[msg.src] = True

    def _on_neighbor_died(self, msg: Message):
        dead = msg.payload["dead"]
        if self.alive.get(dead, True):
            self.alive[dead] = False
            self._re_replicate()
            self._prune_flush_expected({dead})

    def _on_confirm_failure(self, msg: Message):
        """Client-initiated confirmation via the predecessor (paper §IV-B2):
        fire a probe ping; reply when the pong arrives or the deadline
        passes (non-blocking state machine)."""
        suspect = msg.payload["suspect"]
        nonce = self._ping_nonce = getattr(self, "_ping_nonce", 0) + 1
        now = self._clock()
        self._pending_confirms.append([msg, suspect, now,
                                       now + self.PING_TIMEOUT])
        self.transport.send(self.tname, suspect, "ping",
                            {"nonce": nonce, "from": self.tname})

    def _check_confirm_deadlines(self, now: float):
        still = []
        for entry in self._pending_confirms:
            msg, suspect, started, deadline = entry
            if self._last_pong.get(suspect, -1.0) >= started:
                self.transport.reply(self.tname, msg, "failure_confirmed",
                                     {"suspect": suspect, "confirmed": False})
            elif deadline < now:
                if self.alive.get(suspect, True):
                    self._declare_dead(suspect)
                self.transport.reply(self.tname, msg, "failure_confirmed",
                                     {"suspect": suspect, "confirmed": True})
            else:
                still.append(entry)
        self._pending_confirms = still

    def _re_replicate(self):
        """Restore replication factor for keys this server holds after a
        membership change: re-forward to the current successor chain."""
        chain = self.successors(self.replication - 1)
        for key in self.store.keys():
            seg = self._segments.get(key)
            for peer in chain:
                # primary_msg None is the "no client is waiting" sentinel:
                # replicas store the copy but send no replica_ack, so these
                # copies can never satisfy a pending client put
                self.transport.send(self.tname, peer, "replica_put", {
                    "key": key, "value": self.store.get(key), "chain": [],
                    "primary": self.tname, "primary_msg": None,
                    "client": None, "lane": qos.LANE_DRAIN,
                    "file": seg.file if seg else None,
                    "offset": seg.offset if seg else 0})

    # two-phase flush --------------------------------------------------------
    def _flush_state(self, epoch: int) -> dict:
        """Per-epoch flush state. The ring is snapshotted ONCE, when the
        epoch is first seen: shuffle planning and the PFS write must use the
        same membership view, otherwise servers that observe a death or join
        mid-flush compute different domain ownership and bytes get dropped
        or double-written."""
        return self._flush.setdefault(epoch, {
            "meta": {}, "done": set(),
            "ring": self.alive_ring(),
            "expected": set(self.alive_ring()),
            # drain micro-epochs carry a cold SUBSET of segments; my_metas
            # snapshots this server's contribution at flush_begin so the
            # shuffle ships exactly what the epoch advertised
            "drain": False, "my_metas": None,
            # known file sizes broadcast with the metadata: subset planning
            # must pin domains to the files' true sizes (see plan_shuffle)
            "sizes": {}, "epoch_sizes": None,
            "shuffled": False, "written": False})

    def _close_epoch(self, epoch: int):
        self._flush.pop(epoch, None)
        self._closed_epochs.add(epoch)
        if len(self._closed_epochs) > 4096:      # bounded straggler memory
            self._closed_epochs.clear()

    def _merge_lookup(self, sizes: Dict[str, int]):
        """Lookup-table updates are max-merge: a drain micro-epoch that made
        only a cold prefix of a file durable must never shrink the recorded
        global size (truncation drops the entry instead)."""
        for f, sz in sizes.items():
            if sz > self.lookup_table.get(f, -1):
                self.lookup_table[f] = sz

    def _on_flush_begin(self, msg: Message):
        """Phase 1: broadcast my segment metadata to every live server.
        For a drain micro-epoch (payload drain=True) the contribution is the
        cold, file-attributed subset allowed by the token bucket; everyone
        else still participates in the exchange with empty metadata."""
        epoch = msg.payload["epoch"]
        if epoch in self._closed_epochs:
            return
        st = self._flush_state(epoch)
        st["drain"] = bool(msg.payload.get("drain"))
        if st["drain"]:
            # drain epochs are serialized by the manager, so any leftover
            # snapshot belongs to an epoch whose abort we never saw (e.g.
            # we were falsely declared dead mid-epoch): refund and drop it
            for stale in [e for e in self._drain_epochs if e != epoch]:
                dr = self._drain_epochs.pop(stale)
                if self.drainer is not None:
                    self.drainer.refund(dr["bytes"])
            keys: List[str] = []
            nbytes = 0
            if self.drainer is not None and self.drainer.draining:
                budget = min(self.drain_cfg.max_epoch_bytes,
                             self.drainer.peek())
                if budget > 0:
                    keys, nbytes = self._drain_select(budget)
                    self.drainer.take(nbytes)
            # gens snapshot covers EVERY local file-attributed key, not just
            # the contributed ones: the evict broadcast names keys drained by
            # any participant, and replicas of those keys live here too
            self._drain_epochs[epoch] = {
                "keys": keys, "bytes": nbytes,
                "gens": {k: self.store.gen_of(k) for k in self._segments}}
            segs = {k: self._segments[k] for k in keys
                    if k in self._segments}
        else:
            # clean (staged) chunks are byte-identical to their durable PFS
            # copy — re-shuffling and re-writing them would be pure waste
            segs = {k: s for k, s in self._segments.items()
                    if not self.store.is_clean(k)}
        st["my_metas"] = segs
        metas = [(s.file, s.offset, s.length, k) for k, s in segs.items()]
        sizes = {s.file: self.lookup_table[s.file] for s in segs.values()
                 if s.file in self.lookup_table}
        for peer in st["ring"]:
            self.transport.send(self.tname, peer, "flush_meta",
                                {"epoch": epoch, "from": self.tname,
                                 "metas": metas, "sizes": sizes})

    def _on_flush_meta(self, msg: Message):
        epoch = msg.payload["epoch"]
        if epoch in self._closed_epochs:
            return                       # straggler for an aborted/done epoch
        st = self._flush_state(epoch)
        st["meta"][msg.payload["from"]] = msg.payload["metas"]
        for f, sz in msg.payload.get("sizes", {}).items():
            if sz > st["sizes"].get(f, -1):
                st["sizes"][f] = sz
        if set(st["meta"]) >= st["expected"] and not st["shuffled"]:
            self._shuffle(epoch, st)

    def _on_flush_abort(self, msg: Message):
        """The manager aborted an epoch (server death / timeout mid-drain):
        drop the epoch state and refund the drain-bandwidth budget — nothing
        was evicted, the chunks stay buffered and re-drain from replicas in
        a later micro-epoch."""
        epoch = msg.payload["epoch"]
        self._close_epoch(epoch)
        dr = self._drain_epochs.pop(epoch, None)
        if dr is not None and self.drainer is not None:
            self.drainer.refund(dr["bytes"])

    def _shuffle(self, epoch: int, st: dict):
        """Phase 2: ship segments to domain owners (epoch ring snapshot)."""
        st["shuffled"] = True
        all_meta = {
            src: [twophase.Segment(f, o, l) for f, o, l, _ in metas]
            for src, metas in st["meta"].items()}
        segs = st["my_metas"]
        if segs is None:            # flush_begin never seen (late join)
            segs = {} if st["drain"] else dict(self._segments)
        sizes, doms, sends = twophase.plan_shuffle(
            list(segs.values()), all_meta, st["ring"],
            known_sizes=st["sizes"])
        st["epoch_sizes"] = dict(sizes)
        self._merge_lookup(sizes)
        key_of = {(s.file, s.offset): k for k, s in segs.items()}
        for owner, seg, file_off, local_off, length in sends:
            data = self.store.get(key_of[(seg.file, seg.offset)])
            if data is None:
                continue       # evicted mid-epoch: already durable on PFS
            piece = data[local_off:local_off + length]
            self.transport.send(self.tname, owner, "shuffle_data",
                                {"epoch": epoch, "file": seg.file,
                                 "offset": file_off, "data": piece})
        for peer in st["ring"]:
            self.transport.send(self.tname, peer, "shuffle_done",
                                {"epoch": epoch, "from": self.tname,
                                 "sizes": sizes})

    def _on_shuffle_data(self, msg: Message):
        p = msg.payload
        self._domain_data.setdefault(p["file"], {})[p["offset"]] = p["data"]

    def _on_shuffle_done(self, msg: Message):
        epoch = msg.payload["epoch"]
        if epoch in self._closed_epochs:
            return                       # straggler for an aborted/done epoch
        st = self._flush_state(epoch)
        st["done"].add(msg.payload["from"])
        self._merge_lookup(msg.payload["sizes"])
        if st["epoch_sizes"] is None:
            st["epoch_sizes"] = {}
        for f, sz in msg.payload["sizes"].items():
            if sz > st["epoch_sizes"].get(f, -1):
                st["epoch_sizes"][f] = sz
        if st["done"] >= st["expected"] and not st["written"]:
            st["written"] = True
            self._write_pfs(epoch, st)

    def _write_pfs(self, epoch: int, st: dict):
        """Phase 2b: sequential writes of owned, COVERED ranges only, with
        domain ownership computed from the epoch's ring snapshot.

        Only files touched by this epoch are written, and within an owned
        domain only the byte runs actually present in the shuffle buffer.
        An earlier version zero-filled each owned domain end-to-end across
        every file in the lookup table — once chunks can be evicted (the
        drain engine, checkpoint retention) that clobbers durable PFS bytes
        with zeros on the next flush. The file is still grown to its full
        size by the tail-domain owner so PFS reads never come up short."""
        os.makedirs(self.pfs_dir, exist_ok=True)
        written = 0
        for f in sorted(st["epoch_sizes"] or {}):
            # epoch_sizes is identical on every participant (max-merge of
            # the same shuffle_done broadcasts), so domain ownership agrees
            size = st["epoch_sizes"][f]
            doms = twophase.domains(size, st["ring"])
            my = [(a, b) for s, a, b in doms if s == self.tname]
            if not my:
                continue
            chunks = self._domain_data.get(f, {})
            path = os.path.join(self.pfs_dir, f)
            with open(path, "r+b" if os.path.exists(path) else "w+b") as fh:
                for a, b in my:
                    runs = []
                    for base, data in chunks.items():
                        lo, hi = max(a, base), min(b, base + len(data))
                        if lo < hi:
                            runs.append([lo, hi])
                    for lo, hi in _merge_intervals(runs):
                        buf = bytearray(hi - lo)
                        for base, data in sorted(chunks.items()):
                            l2 = max(lo, base)
                            h2 = min(hi, base + len(data))
                            if l2 < h2:
                                buf[l2 - lo:h2 - lo] = \
                                    data[l2 - base:h2 - base]
                        fh.seek(lo)
                        fh.write(bytes(buf))  # sequential covered run
                        written += hi - lo
                if my[-1][1] == size:
                    fh.seek(0, os.SEEK_END)
                    if fh.tell() < size:
                        fh.truncate(size)     # tail owner fixes the length
        self.stats["flushes"] += 1
        dr = self._drain_epochs.get(epoch)
        self._close_epoch(epoch)
        self.transport.send(self.tname, self.manager, "flush_done",
                            {"epoch": epoch, "server": self.tname,
                             "bytes": written,
                             "sizes": dict(st["epoch_sizes"] or {}),
                             "drained": dr["keys"] if dr else []})

    # autonomous drain engine --------------------------------------
    def _drain_tick(self, now: float):
        """Watermark check, run from the server loop: report pressure to the
        manager on a fixed cadence, and request a drain micro-epoch when the
        engine's hysteresis + burst detector + token bucket all agree."""
        eng = self.drainer
        if eng is None or not self.ring or self.tname not in self.ring:
            return
        occ = self.store.occupancy()
        if now - self._last_pressure >= self.drain_cfg.pressure_interval:
            self._last_pressure = now
            self._m_occ.note(occ["fraction"], label=self.tname)
            self.transport.send(self.tname, self.manager, "drain_pressure",
                                {"server": self.tname, **occ,
                                 "draining": eng.draining,
                                 "unknown_kinds": sum(
                                     self.unknown_kinds.values()),
                                 "ingest_bps": eng.ingest_rate(now)})
        if not self._segments:
            return                  # nothing file-attributed: nothing to drain
        if not eng.update(occ["fraction"], now):
            return
        # clean-evict fast path: staged bytes already have a
        # durable PFS copy, so under pressure they are dropped first —
        # locally, for free, with no flush epoch and no token-bucket debit
        if self._clean_evict():
            return
        if eng.peek(now) <= 0:
            return
        keys, nbytes = self._drain_select(self.drain_cfg.max_epoch_bytes)
        if not keys:
            # bare-KV pressure: rate-limit the (full-scan) reprobe so a
            # permanently-undrainable store doesn't burn the server loop
            eng.note_scan(now)
            return
        eng.note_requested(now)
        # root the drain-epoch trace here: the request is the first causal
        # event of the epoch, so every downstream hop (manager planning,
        # flush fan-out, evict confirms) parents back to this span
        with telemetry.span("server.drain_request", self.tname,
                            drainable=nbytes):
            self.transport.send(self.tname, self.manager, "drain_request",
                                {"server": self.tname,
                                 "occupancy": occ["fraction"],
                                 "drainable": nbytes})

    def _drain_select(self, budget: int):
        """Cold, sealed, FILE-ATTRIBUTED chunks in age order up to ``budget``
        bytes (always at least one chunk). Bare KV keys cannot travel the
        two-phase planner and are skipped; clean (staged) keys never need a
        drain epoch — the clean-evict fast path drops them for free."""
        out: List[str] = []
        total = 0
        for key, length in self.store.cold_keys(self.drain_cfg.min_idle_s,
                                                clean=False):
            if key not in self._segments:
                continue
            if out and total + length > budget:
                break
            out.append(key)
            total += length
        return out, total

    def _clean_evict(self, skip_file: Optional[str] = None) -> int:
        """Evict cold CLEAN chunks (stage-in re-ingests): they are durable
        on the PFS by construction, so no flush epoch, no coordination, no
        bandwidth debit — tombstone, remember the residency for transparent
        read fallthrough, compact. ``skip_file`` protects the file an
        in-progress stage is loading from being cannibalized by its own
        admission guard. Returns bytes freed."""
        freed = 0
        for key, length in self.store.cold_keys(clean=True):
            seg = self._segments.get(key)
            if seg is not None and seg.file == skip_file:
                continue
            n = self.store.evict(key)
            if n == 0:
                continue
            freed += n
            self.stats["clean_evictions"] += 1
            if seg is not None:
                self._evicted[key] = (seg.file, seg.offset, seg.length)
                self._evicted_files.setdefault(
                    seg.file, {})[seg.offset] = (key, seg.length)
            self._drop_segment(key)
        if freed:
            self.store.compact()
            self.stats["clean_evicted_bytes"] += freed
        return freed

    def _on_drain_evict(self, msg: Message):
        """The manager confirmed a drain micro-epoch fully durable: evict the
        named chunks (all copies — primary and replica alike). A key whose
        write generation moved since the epoch's snapshot was rewritten
        mid-drain and is SKIPPED: the PFS holds the old bytes, the buffer
        holds the new ones, and evicting would lose the rewrite."""
        epoch = msg.payload["epoch"]
        dr = self._drain_epochs.pop(epoch, None)
        gens = dr["gens"] if dr else {}
        freed = 0
        touched: set = set()
        for key in msg.payload["keys"]:
            gen = gens.get(key)
            if gen is None or self.store.gen_of(key) != gen:
                continue
            seg = self._segments.get(key)
            n = self.store.evict(key)
            if n == 0:
                continue
            freed += n
            self.stats["evictions"] += 1
            if seg is not None:
                self._evicted[key] = (seg.file, seg.offset, seg.length)
                self._evicted_files.setdefault(
                    seg.file, {})[seg.offset] = (key, seg.length)
                touched.add(seg.file)
            self._drop_segment(key)
        if freed:
            self.store.compact()
            self.stats["drained_bytes"] += freed
            self.stats["drain_epochs"] += 1
            telemetry.record(self.tname, "drain_evict", epoch=epoch,
                             freed=freed, keys=len(msg.payload["keys"]))
        # the shuffle receive-buffers for drained files are durable on the
        # PFS now — dropping them is part of the space this engine reclaims.
        # Never while another epoch is mid-flight and may still need them.
        if not self._flush:
            for f in touched:
                self._domain_data.pop(f, None)

    def _prune_flush_expected(self, dead: set):
        """A mid-epoch death must not wedge the epoch forever: drop the dead
        from every in-flight epoch's expected set and advance epochs that
        are now complete. (Drain micro-epochs are additionally ABORTED by
        the manager on any death — eviction must never proceed off a plan a
        dead owner cannot finish writing.)"""
        for epoch in list(self._flush):
            st = self._flush.get(epoch)
            if st is None or not (st["expected"] & dead):
                continue
            st["expected"] -= dead
            if set(st["meta"]) >= st["expected"] and not st["shuffled"]:
                self._shuffle(epoch, st)
            st = self._flush.get(epoch)
            if st is not None and st["done"] >= st["expected"] \
                    and not st["written"]:
                st["written"] = True
                self._write_pfs(epoch, st)

    # stage-in engine ----------------------------------------------
    def _stage_state(self, epoch: int) -> dict:
        """Per-epoch stage state; the ring is snapshotted from the manager's
        stage_begin so every participant computes the same domains (exactly
        the flush-epoch rule, in reverse)."""
        return self._stage_epochs.setdefault(epoch, {
            "file": None, "lo": 0, "hi": -1, "ring": [], "expected": set(),
            "meta": {}, "size": 0, "begun": False, "staged": False})

    def _close_stage(self, epoch: int):
        self._stage_epochs.pop(epoch, None)
        self._closed_epochs.add(epoch)
        if len(self._closed_epochs) > 4096:
            self._closed_epochs.clear()

    def _on_stage_begin(self, msg: Message):
        """Phase 1 of a stage epoch: broadcast my live buffered coverage of
        the file to every participant. Bytes ANYONE still buffers are at
        least as fresh as the durable PFS copy — staging over them could
        resurrect stale bytes, so the coverage union defines what must NOT
        be re-ingested."""
        p = msg.payload
        epoch = p["epoch"]
        if epoch in self._closed_epochs:
            return
        st = self._stage_state(epoch)
        st["file"], st["lo"], st["hi"] = p["file"], p["lo"], p["hi"]
        st["ring"] = list(p["ring"])
        st["expected"] = set(p["ring"])
        st["begun"] = True
        fmap = self._files.get(p["file"], {})
        covered = staging.merge_intervals(
            [[off, off + ln] for off, (_k, ln) in fmap.items()])
        size = max(self.lookup_table.get(p["file"], 0),
                   max((off + ln for off, (_k, ln) in fmap.items()),
                       default=0))
        path = os.path.join(self.pfs_dir, p["file"])
        if os.path.exists(path):
            size = max(size, os.path.getsize(path))
        for peer in st["ring"]:
            self.transport.send(self.tname, peer, "stage_meta",
                                {"epoch": epoch, "from": self.tname,
                                 "covered": covered, "size": size})
        self._maybe_stage(epoch, st)

    def _on_stage_meta(self, msg: Message):
        epoch = msg.payload["epoch"]
        if epoch in self._closed_epochs:
            return
        st = self._stage_state(epoch)
        st["meta"][msg.payload["from"]] = msg.payload["covered"]
        st["size"] = max(st["size"], msg.payload["size"])
        self._maybe_stage(epoch, st)

    def _on_stage_abort(self, msg: Message):
        """The manager aborted the epoch (death / timeout mid-stage). Drop
        the state; slices already re-ingested are CLEAN copies of durable
        bytes, so nothing needs undoing and reads stay correct either way."""
        self._close_stage(msg.payload["epoch"])

    def _maybe_stage(self, epoch: int, st: dict):
        if st["begun"] and set(st["meta"]) >= st["expected"] \
                and not st["staged"]:
            st["staged"] = True
            self._plan_stage(epoch, st)

    def _plan_stage(self, epoch: int, st: dict):
        """Phase 2 setup: plan MY lookup-table domain's uncovered slices.
        The re-ingest itself runs incrementally from ``_stage_tick`` (at
        most ``tick_bytes`` per server-loop pass) so a large stage cannot
        stall ping/pong long enough for peers to declare this server dead
        mid-epoch."""
        f, size = st["file"], st["size"]
        lo = max(0, st["lo"])
        hi = size if st["hi"] < 0 else min(st["hi"], size)
        path = os.path.join(self.pfs_dir, f)
        plan: List = []
        if size > 0:
            self._merge_lookup({f: size})
        if size > 0 and lo < hi and os.path.exists(path):
            doms = twophase.domains(size, st["ring"])
            mine = [(a, b) for s, a, b in doms if s == self.tname]
            covered = [iv for metas in st["meta"].values() for iv in metas]
            plan = staging.plan_stage(mine, (lo, hi), covered,
                                      self.stage_cfg.slice_bytes)
        st["plan"] = list(plan)
        st["path"] = path
        st["bytes"] = 0
        if not st["plan"]:
            self._finish_stage(epoch, st)

    def _stage_tick(self, now: float):
        """Re-ingest up to ``tick_bytes`` of the in-flight stage plan, then
        return to the message loop (every participant stages its own domain
        in parallel — this is what makes a cold restart a cluster-wide bulk
        load instead of one client's serial miss loop)."""
        for epoch, st in list(self._stage_epochs.items()):
            plan = st.get("plan")
            if not plan:
                continue
            f = st["file"]
            budget = self.stage_cfg.tick_bytes
            if self.arbiter is not None:
                # unified background budget: stage slices debit
                # the same per-server bucket as drain micro-epochs, and the
                # bucket refills slower while foreground ingest is hot — a
                # stage can no longer compete with an active burst
                budget = min(budget, self.arbiter.peek(now))
                if budget <= 0:
                    continue    # wait for a refill — the plan keeps its
                    #             remaining slices for a later tick, and
                    #             reads stay exact via the PFS fallback
            consumed = 0
            while plan and budget > 0:
                if not self._stage_admit(f):
                    plan.clear()    # buffer under real pressure: stop, the
                    break           # rest stays readable via PFS fallback
                off, ln = plan.pop(0)
                with open(st["path"], "rb") as fh:
                    fh.seek(off)
                    data = fh.read(ln)
                if len(data) < ln:
                    plan.clear()    # PFS copy shorter than advertised
                    break
                if self._ingest_clean(f, off, data):
                    st["bytes"] += len(data)
                budget -= ln
                consumed += ln
            if consumed and self.arbiter is not None:
                self.arbiter.take(consumed, now)
            if not plan:
                self._finish_stage(epoch, st)

    def _finish_stage(self, epoch: int, st: dict):
        staged = st.get("bytes", 0)
        self._close_stage(epoch)
        if staged:
            self.stats["stage_epochs"] += 1
            self.stats["staged_bytes"] += staged
        self.transport.send(self.tname, self.manager, "stage_done",
                            {"epoch": epoch, "server": self.tname,
                             "bytes": staged})

    def _stage_admit(self, file: str) -> bool:
        """Admission guard: staging must never push the store into a drain
        storm. At the high watermark, clean-evict older staged bytes first
        (free, no epoch); if occupancy is STILL at the watermark, refuse
        further slices — dirty data is never displaced to make room for
        bytes that already have a durable copy."""
        occ = self.store.occupancy()["fraction"]
        if occ < self.drain_cfg.high_watermark:
            return True
        self._clean_evict(skip_file=file)
        return self.store.occupancy()["fraction"] \
            < self.drain_cfg.high_watermark

    def _ingest_clean(self, file: str, offset: int, data: bytes) -> bool:
        """Store one staged slice as a CLEAN chunk under the ordinary
        ``{file}:{offset}`` key namespace (manifest-directed reads find it
        like any buffered chunk), clearing any tombstone it re-covers.

        A write that landed AFTER the epoch's coverage snapshot is fresher
        than the PFS copy, so the slice is SKIPPED when its key is live or
        any live local chunk overlaps its range — staging over it would
        resurrect stale bytes and, worse, mark them clean (evictable with
        no flush). Returns whether the slice was ingested."""
        key = f"{file}:{offset}"
        if key in self.store:
            return False
        fmap = self._files.get(file)
        if fmap:
            lo, hi = offset, offset + len(data)
            for off, (_k, ln) in fmap.items():
                if off < hi and lo < off + ln:
                    return False
        self.store.put(key, data, clean=True)
        # the offset is resident again: clear a matching tombstone record
        self._evicted.pop(key, None)
        emap = self._evicted_files.get(file)
        if emap is not None and emap.get(offset, (None, 0))[0] == key:
            del emap[offset]
            if not emap:
                del self._evicted_files[file]
        self._record_segment(key, file, offset, len(data))
        return True

    # checkpoint retention ---------------------------------------------------
    def _on_evict_epoch(self, msg: Message):
        """Durable eviction by prefix (checkpoint retention): keys with file
        attribution become tombstones — reads fall through to the lookup
        table / PFS — while bare KV keys are deleted outright."""
        prefix = msg.payload["prefix"]
        for key in list(self.store.keys()):
            if not key.startswith(prefix):
                continue
            seg = self._segments.get(key)
            if seg is not None:
                self.store.evict(key)
                self._evicted[key] = (seg.file, seg.offset, seg.length)
                self._evicted_files.setdefault(
                    seg.file, {})[seg.offset] = (key, seg.length)
                self.stats["evictions"] += 1
            else:
                self.store.delete(key)
            self._drop_segment(key)
        self.store.compact()
        for f in list(self._domain_data):
            if f.startswith(prefix):
                del self._domain_data[f]
        for f in list(self._files):
            if f.startswith(prefix):
                del self._files[f]

    def _stats_payload(self) -> dict:
        occ = self.store.occupancy()
        payload = {
            **self.stats, "dram_used": self.store.dram_used,
            "ssd_used": self.store.ssd_used,
            "keys": len(self.store.keys()),
            "lookup_files": len(self.lookup_table),
            "occupancy": occ["fraction"],
            "evicted_keys": len(self._evicted),
            "unknown_kinds": dict(self.unknown_kinds)}
        if self.drainer is not None:
            payload["drain"] = self.drainer.snapshot()
        if self.arbiter is not None:
            payload["arbiter"] = dict(self.arbiter.stats)
        if self._laneq is not None:
            payload["queued_puts"] = len(self._laneq)
        return payload

    def _stats_snapshot(self) -> dict:
        """Telemetry poll callback: the stats dict is mutated only
        by this server's own thread with GIL-atomic updates, so a shallow
        copy — plus the one nested list — is coherent without a lock."""
        snap = dict(self.stats)
        snap["puts_by_lane"] = list(self.stats["puts_by_lane"])
        if self.drainer is not None:
            snap["drain"] = self.drainer.snapshot()
        if self._laneq is not None:
            # lane-queue depth rides along for the health engine's
            # queue-growth watchdog and queue_depth SLO
            snap["queued_puts"] = len(self._laneq)
        return snap

    def _on_stats_query(self, msg: Message):
        self.transport.reply(self.tname, msg, "stats", self._stats_payload())

    def _on_metrics_query(self, msg: Message):
        """Telemetry scrape: the stats payload, plus the full
        registry snapshot when the caller asks for instruments (remote
        scrapers; BurstBufferSystem.scrape() reads the in-process registry
        directly and asks each server only for its stats)."""
        payload = {"server": self.tname, "stats": self._stats_payload()}
        if msg.payload.get("instruments"):
            payload["instruments"] = telemetry.snapshot()
        self.transport.reply(self.tname, msg, "metrics", payload)
