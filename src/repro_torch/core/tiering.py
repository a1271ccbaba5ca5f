"""Hybrid-storage log-structured store (paper §V: DRAM + SSD spill).

Writes append to an in-memory segment log (DRAM tier); when DRAM capacity is
exceeded, *whole segments* spill to an SSD-tier file with a single sequential
append — log-structuring is exactly what made bbIORSSD (198.8 MB/s) match
SSDSeq (206 MB/s) in the paper's Fig 6 while direct semi-random writes got
166.7 MB/s. An index maps key -> (tier, segment/file, offset, length, gen).

Drain-engine support:
  - every put stamps a monotonically increasing write generation, so the
    drainer can tell "same key, rewritten since the drain epoch snapshot"
    from "same bytes the epoch made durable" and never evict fresh data;
  - ``evict()`` tombstones a durably-flushed key (tier "pfs"): reads miss,
    the residency is remembered, and the bytes are reclaimed by compact();
  - ``compact()`` reclaims BOTH tiers — dead DRAM segments are dropped and
    the SSD log is rewritten keeping only live entries;
  - ``occupancy()``/``cold_keys()`` feed the watermark policy: occupancy is
    used bytes over DRAM+SSD capacity, cold keys are whole sealed segments
    in age order (SSD first — it spilled earliest — then DRAM by segment id).

Stage-in support: a put may be marked ``clean`` — the bytes were
re-ingested from a durable PFS copy (staging.py), so eviction loses nothing
and needs no flush epoch. ``cold_keys(clean=True)`` lists the free-eviction
candidates; a plain rewrite of the key clears the flag.

Crash recovery: the SSD log is self-describing. Every spill writes
one record per key — a fixed header (magic ``BBR1``, flags carrying the
clean/tombstone bits, write generation, key length, payload length) plus a
CRC32 over header+key+payload — and ``compact()`` preserves the format.
``delete()``/``evict()`` of an SSD-resident key append a tombstone record so
replay converges. On construction over an existing non-empty log the store
*recovers* instead of truncating: records are scanned last-gen-wins, a torn
tail is truncated at the first bad header/CRC, and the index, byte
accounting and generation counter are rebuilt; ``recovered_keys`` exposes
what came back so the server can rebuild its chunk manifests. Durability
discipline: spilled records are fsynced *before* the index publishes them as
tier "ssd", and compact fsyncs its tmp file before the atomic replace (the
old log stays valid until then, so a crash at any point replays cleanly).
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import locktrack, telemetry

# SSD log record: header | key bytes | payload bytes. The CRC is computed
# over the header (with the crc field zeroed) + key + payload, so a torn or
# bit-flipped record is detected and recovery truncates the tail there.
_REC_MAGIC = b"BBR1"
_REC_HDR = struct.Struct(">4sBQHII")  # magic, flags, gen, key_len, len, crc
_REC_CLEAN = 0x01   # payload has a durable PFS copy (stage-in re-ingest)
_REC_TOMB = 0x02    # tombstone: the key was deleted/evicted at this gen


@dataclass
class _Loc:
    tier: str          # "dram" | "ssd" | "pfs" (evicted tombstone)
    segment: int       # dram segment id or ssd file offset base id
    offset: int
    length: int
    gen: int = 0       # write generation (monotonic per store)
    clean: bool = False  # a durable PFS copy exists (stage-in re-ingest):
    #                      evictable for free, without a flush epoch


class LogStore:
    SEGMENT_BYTES = 4 << 20

    def __init__(self, dram_capacity: int, ssd_dir: Optional[str] = None,
                 name: str = "srv", *,
                 ssd_capacity: Optional[int] = None,
                 segment_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.dram_capacity = dram_capacity
        self.ssd_dir = ssd_dir
        self.name = name
        self.segment_bytes = segment_bytes or self.SEGMENT_BYTES
        self._segments: Dict[int, bytearray] = {}
        self._open_seg = 0
        self._segments[0] = bytearray()
        self._index: Dict[str, _Loc] = {}
        self._dram_bytes = 0
        self._ssd_bytes = 0
        self._next_seg = 1
        self._gen = 0
        self._seg_touched: Dict[int, float] = {0: clock()}
        self._lock = locktrack.rlock("LogStore._lock")
        self._ssd_path = None
        self._read_fh = None     # cached SSD read handle
        self._append_fh = None   # cached SSD append handle
        self._unsynced = False   # tombstones flushed but not yet fsynced
        self.recovered_keys: List[str] = []
        # telemetry: spill/compact/fsync latencies + CRC-failure
        # counter; bound before recover() runs so the recovery scan can
        # count bad records. No-op singletons when telemetry is disabled.
        self._m_spill = telemetry.histogram("store.spill_s")
        self._m_fsync = telemetry.histogram("store.fsync_s")
        self._m_compact = telemetry.histogram("store.compact_s")
        self._m_crc = telemetry.counter("store.crc_failures")
        if ssd_dir:
            os.makedirs(ssd_dir, exist_ok=True)
            self._ssd_path = os.path.join(ssd_dir, f"{name}.log")
            if os.path.exists(self._ssd_path) \
                    and os.path.getsize(self._ssd_path) > 0:
                self.recover()
            else:
                open(self._ssd_path, "wb").close()
        if ssd_capacity is None:
            # soft budget for the watermark policy, not a hard write limit:
            # the log absorbs past it, the drainer is what pulls it back down
            ssd_capacity = 4 * dram_capacity if self._ssd_path else 0
        self.ssd_capacity = ssd_capacity

    # ------------------------------------------------------- SSD log records
    @staticmethod
    def record_overhead(key: str) -> int:
        """File bytes a record costs beyond its payload (header + key)."""
        return _REC_HDR.size + len(key.encode("utf-8"))

    def _read_handle(self):
        """Cached read handle (caller holds _lock). Reopening the log on
        every SSD-tier read was measurably dumb; the handle is dropped
        whenever the underlying file is replaced (compact/recover)."""
        if self._read_fh is None:
            self._read_fh = open(self._ssd_path, "rb")
        return self._read_fh

    def _append_handle(self):
        """Cached append handle (caller holds _lock)."""
        if self._append_fh is None:
            self._append_fh = open(self._ssd_path, "ab")
        return self._append_fh

    def _drop_handles(self):
        """Invalidate cached handles; caller holds _lock. Called whenever
        the log file is swapped out from under them (compact/recover)."""
        for fh in (self._read_fh, self._append_fh):
            if fh is not None:
                fh.close()
        self._read_fh = self._append_fh = None

    def _append_record(self, f, key: str, payload: bytes, gen: int, *,
                       clean: bool = False, tombstone: bool = False) -> int:
        """Append one self-describing record; returns the *payload* offset
        (what the index stores, so reads never re-parse headers). Caller
        holds _lock and owns the flush/fsync policy."""
        kb = key.encode("utf-8")
        flags = (_REC_CLEAN if clean else 0) | (_REC_TOMB if tombstone else 0)
        crc = zlib.crc32(
            _REC_HDR.pack(_REC_MAGIC, flags, gen, len(kb), len(payload), 0))
        crc = zlib.crc32(kb, crc)
        crc = zlib.crc32(payload, crc) & 0xFFFFFFFF
        f.write(_REC_HDR.pack(_REC_MAGIC, flags, gen, len(kb),
                              len(payload), crc))
        f.write(kb)
        off = f.tell()
        f.write(payload)
        return off

    def _tombstone(self, key: str, gen: int):
        """Append + flush a tombstone record (caller holds _lock). NOT
        fsynced here: an fsync per evicted key serializes the drain engine
        on disk flushes, and every later fsync of the append handle (spill
        batch, compact, ``sync()``) covers all tombstones before it in the
        stream. Call sites where resurrection would serve STALE bytes (the
        write-through bypass evict, file truncate) must follow the batch
        with ``sync()``; a drain-epoch evict may skip it — the PFS copy is
        byte-identical, so a replay resurrecting the record is harmless."""
        f = self._append_handle()
        self._append_record(f, key, b"", gen, tombstone=True)
        f.flush()
        self._unsynced = True

    def sync(self):
        """Make every appended tombstone durable (coalesced fsync). No-op
        when nothing is pending."""
        with self._lock:
            if self._unsynced and self._ssd_path:
                f = self._append_handle()
                f.flush()
                t0 = self._clock()
                with telemetry.child_span("store.fsync", self.name,
                                          caller="sync"):
                    os.fsync(f.fileno())
                self._m_fsync.observe(self._clock() - t0, label="sync")
            self._unsynced = False

    def recover(self):
        """Rebuild the in-memory state from an existing SSD log.

        Scans records front to back, keeping the highest generation seen per
        key (compact preserves gens but reorders records, so file order is
        NOT gen order); a tombstone at the winning gen deletes the key. The
        scan stops at the first bad magic, impossible length, or CRC
        mismatch — everything from there is a torn tail from a mid-append
        crash and is truncated, restoring the append-only invariant. The
        index, ``_ssd_bytes`` and the generation counter are rebuilt;
        ``recovered_keys`` lists the live keys for manifest rebuild."""
        with self._lock:
            size = os.path.getsize(self._ssd_path)
            live: Dict[str, Tuple[int, int, int, bool, bool]] = {}
            pos = 0
            max_gen = 0
            with open(self._ssd_path, "rb") as f:
                while pos + _REC_HDR.size <= size:
                    f.seek(pos)
                    magic, flags, gen, klen, plen, crc = _REC_HDR.unpack(
                        f.read(_REC_HDR.size))
                    end = pos + _REC_HDR.size + klen + plen
                    if magic != _REC_MAGIC or end > size:
                        break
                    body = f.read(klen + plen)
                    want = zlib.crc32(_REC_HDR.pack(
                        _REC_MAGIC, flags, gen, klen, plen, 0))
                    want = zlib.crc32(body, want) & 0xFFFFFFFF
                    if want != crc:
                        self._m_crc.inc(label=self.name)
                        break
                    key = body[:klen].decode("utf-8", errors="replace")
                    max_gen = max(max_gen, gen)
                    cur = live.get(key)
                    if cur is None or gen >= cur[0]:
                        live[key] = (gen, pos + _REC_HDR.size + klen, plen,
                                     bool(flags & _REC_CLEAN),
                                     bool(flags & _REC_TOMB))
                    pos = end
            if pos < size:                      # torn tail: truncate it away
                telemetry.record("store", "torn_tail", store=self.name,
                                 truncated_at=pos, size=size)
                with open(self._ssd_path, "r+b") as f:
                    f.truncate(pos)
                    f.flush()
                    os.fsync(f.fileno())
            self._drop_handles()
            self.recovered_keys = []
            for key, (gen, off, plen, clean, dead) in sorted(
                    live.items(), key=lambda kv: kv[1][1]):
                if dead:
                    continue
                self._index[key] = _Loc("ssd", 0, off, plen, gen, clean)
                self._ssd_bytes += plen
                self.recovered_keys.append(key)
            self._gen = max(self._gen, max_gen)

    # ------------------------------------------------------------------ info
    @property
    def dram_used(self) -> int:
        with self._lock:
            return self._dram_bytes

    @property
    def ssd_used(self) -> int:
        with self._lock:
            return self._ssd_bytes

    def dram_free(self) -> int:
        with self._lock:
            return max(0, self.dram_capacity - self._dram_bytes)

    def occupancy(self) -> Dict[str, float]:
        """Watermark input: used bytes over total (DRAM + SSD) capacity.
        The fraction can exceed 1.0 — the SSD log is soft-capped and keeps
        absorbing; that is exactly the pressure signal the drainer acts on."""
        with self._lock:
            cap = self.dram_capacity + self.ssd_capacity
            used = self._dram_bytes + self._ssd_bytes
            return {"dram_used": self._dram_bytes,
                    "dram_capacity": self.dram_capacity,
                    "ssd_used": self._ssd_bytes,
                    "ssd_capacity": self.ssd_capacity,
                    "used": used, "capacity": cap,
                    "fraction": used / cap if cap else 0.0}

    def keys(self) -> List[str]:
        with self._lock:
            return [k for k, loc in self._index.items() if loc.tier != "pfs"]

    def __contains__(self, key: str) -> bool:
        with self._lock:
            loc = self._index.get(key)
            return loc is not None and loc.tier != "pfs"

    def tier_of(self, key: str) -> Optional[str]:
        """Residency of a key: "dram" | "ssd" | "pfs" (evicted) | None."""
        with self._lock:
            loc = self._index.get(key)
            return loc.tier if loc is not None else None

    def gen_of(self, key: str) -> Optional[int]:
        with self._lock:
            loc = self._index.get(key)
            return loc.gen if loc is not None else None

    def was_evicted(self, key: str) -> bool:
        return self.tier_of(key) == "pfs"

    def is_clean(self, key: str) -> bool:
        """True when the key's bytes were staged in from a durable PFS copy
        (and not rewritten since): evicting them loses nothing."""
        with self._lock:
            loc = self._index.get(key)
            return loc is not None and loc.tier != "pfs" and loc.clean

    # ----------------------------------------------------------------- write
    def put(self, key: str, value: bytes, *, clean: bool = False) -> str:
        """Append to the DRAM log; spill oldest segments to SSD if needed.
        Returns the tier the value landed in. ``clean`` marks the bytes as
        having a durable PFS copy already (stage-in re-ingest) — a plain
        rewrite of the same key clears the flag."""
        with self._lock:
            if key in self._index:
                self.delete(key)
            self._gen += 1
            seg = self._segments[self._open_seg]
            loc = _Loc("dram", self._open_seg, len(seg), len(value),
                       self._gen, clean)
            seg += value
            self._index[key] = loc
            self._dram_bytes += len(value)
            self._seg_touched[self._open_seg] = self._clock()
            if len(seg) >= self.segment_bytes:
                self._roll_segment()
            spilled = self._maybe_spill()
            return "ssd" if spilled and self._index[key].tier == "ssd" \
                else "dram"

    def _roll_segment(self):
        self._segments[self._next_seg] = bytearray()
        self._open_seg = self._next_seg
        self._seg_touched[self._open_seg] = self._clock()
        self._next_seg += 1

    def _maybe_spill(self) -> bool:
        """Spill closed segments (oldest first) while over DRAM capacity.

        Each live key becomes one self-describing record (dead bytes within
        the segment are dropped at the door — they'd only be compacted away
        later anyway). Durability before visibility: the batch is fsynced
        BEFORE the index publishes any entry as tier "ssd", so the index
        never trusts bytes a crash could lose."""
        if self._dram_bytes <= self.dram_capacity or not self._ssd_path:
            return False
        t0 = self._clock()
        # spill hysteresis: once over capacity, keep going down to a LOW
        # watermark so the batch's single fsync covers several segments —
        # an fsync per sealed segment serializes the ingest path on the
        # disk's flush latency and was measured 5x slower under drain
        target = max(0, self.dram_capacity
                     - max(self.dram_capacity // 4, self.segment_bytes))
        # if the open segment alone holds the overflow, roll it so it can
        # spill too (log-structured: only sealed segments move)
        if len(self._segments) == 1 and self._segments[self._open_seg]:
            self._roll_segment()
        pending: Dict[str, _Loc] = {}
        f = self._append_handle()
        for seg_id in sorted(self._segments):
            if self._dram_bytes <= target:
                break
            if seg_id == self._open_seg:
                continue
            data = self._segments.pop(seg_id)
            self._seg_touched.pop(seg_id, None)
            for k, loc in self._index.items():
                if loc.tier == "dram" and loc.segment == seg_id:
                    payload = bytes(data[loc.offset:loc.offset + loc.length])
                    off = self._append_record(f, k, payload, loc.gen,
                                              clean=loc.clean)
                    pending[k] = _Loc("ssd", 0, off, loc.length,
                                      loc.gen, loc.clean)
                    self._ssd_bytes += loc.length
            self._dram_bytes -= len(data)
        if not pending:
            return False
        f.flush()
        t1 = self._clock()
        with telemetry.child_span("store.fsync", self.name, caller="spill"):
            os.fsync(f.fileno())
        now = self._clock()
        self._m_fsync.observe(now - t1, label="spill")
        self._m_spill.observe(now - t0)
        self._unsynced = False    # the fsync covered any pending tombstones
        self._index.update(pending)
        return True

    # ------------------------------------------------------------------ read
    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            loc = self._index.get(key)
            if loc is None or loc.tier == "pfs":
                return None
            if loc.tier == "dram":
                seg = self._segments[loc.segment]
                return bytes(seg[loc.offset:loc.offset + loc.length])
            f = self._read_handle()
            f.seek(loc.offset)
            return f.read(loc.length)

    def delete(self, key: str):
        """Log-structured delete: drop the index entry (tombstones too);
        dead bytes are reclaimed by compact(). Deleting an SSD-resident key
        appends a tombstone record — durable at the next fsynced append or
        ``sync()`` — so a post-crash replay does not resurrect it."""
        with self._lock:
            loc = self._index.pop(key, None)
            if loc is not None and loc.tier == "ssd" and self._ssd_path:
                self._gen += 1
                self._tombstone(key, self._gen)

    def evict(self, key: str) -> int:
        """Tombstone a durably-flushed key: the index remembers it moved to
        the "pfs" tier (reads miss, residency is reportable), and the dead
        bytes are reclaimed by compact(). Idempotent — evicting a missing or
        already-evicted key frees 0, so a replayed drain_evict can never
        double-free accounting. An SSD-resident key also gets a tombstone
        record in the log: its PFS copy is the durable truth now, and a
        replay must not resurrect the buffered bytes (which may be older
        than the PFS copy on the write-through bypass path — those call
        sites follow the evict batch with ``sync()``)."""
        with self._lock:
            loc = self._index.get(key)
            if loc is None or loc.tier == "pfs":
                return 0
            if loc.tier == "ssd" and self._ssd_path:
                self._gen += 1
                self._tombstone(key, self._gen)
            self._index[key] = _Loc("pfs", -1, 0, loc.length, loc.gen)
            return loc.length

    def cold_keys(self, min_idle_s: float = 0.0,
                  now: Optional[float] = None, *,
                  clean: Optional[bool] = None) -> List[Tuple[str, int]]:
        """Drain candidates in age order: SSD-resident keys first (they
        spilled earliest, i.e. are the coldest), then keys of sealed DRAM
        segments oldest-segment-first. The open segment never drains, and a
        DRAM segment appended to within ``min_idle_s`` is considered warm.
        ``clean`` filters by the clean flag (True: only staged/re-ingested
        keys — the free-eviction candidates; False: only dirty keys — the
        ones that need a drain epoch; None: both). Returns [(key, length)]."""
        now = self._clock() if now is None else now
        with self._lock:
            ssd = sorted((loc.offset, k, loc.length)
                         for k, loc in self._index.items()
                         if loc.tier == "ssd"
                         and (clean is None or loc.clean == clean))
            dram = sorted(
                (loc.segment, loc.offset, k, loc.length)
                for k, loc in self._index.items()
                if loc.tier == "dram" and loc.segment != self._open_seg
                and (clean is None or loc.clean == clean)
                and now - self._seg_touched.get(loc.segment, 0.0)
                >= min_idle_s)
            return [(k, ln) for _, k, ln in ssd] \
                + [(k, ln) for _, _, k, ln in dram]

    def items_bytes(self) -> Dict[str, int]:
        with self._lock:
            return {k: loc.length for k, loc in self._index.items()
                    if loc.tier != "pfs"}

    def compact(self):
        """Reclaim dead bytes on BOTH tiers: drop fully-dead DRAM segments,
        and rewrite the SSD log keeping only live entries (one sequential
        copy, then an atomic replace) so deleted/evicted SSD bytes are
        actually returned — without this the drain engine would tombstone
        forever while the SSD file only ever grew."""
        with self._lock:
            live = {loc.segment for loc in self._index.values()
                    if loc.tier == "dram"}
            for seg_id in list(self._segments):
                if seg_id != self._open_seg and seg_id not in live:
                    self._dram_bytes -= len(self._segments[seg_id])
                    del self._segments[seg_id]
                    self._seg_touched.pop(seg_id, None)
            if not self._ssd_path:
                return
            ssd = sorted((loc.offset, k) for k, loc in self._index.items()
                         if loc.tier == "ssd")
            live_bytes = sum(self._index[k].length for _, k in ssd)
            if live_bytes >= self._ssd_bytes:
                self.sync()       # nothing dead; harden pending tombstones
                return
            t0 = self._clock()
            tmp = self._ssd_path + ".compact"
            new_locs: Dict[str, _Loc] = {}
            src = self._read_handle()
            with open(tmp, "wb") as dst:
                for _, k in ssd:
                    loc = self._index[k]
                    src.seek(loc.offset)
                    payload = src.read(loc.length)
                    off = self._append_record(dst, k, payload, loc.gen,
                                              clean=loc.clean)
                    new_locs[k] = _Loc("ssd", 0, off, loc.length,
                                       loc.gen, loc.clean)
                # fsync before the atomic replace publishes the rewrite; the
                # old log stays fully valid (live records + dead bytes)
                # until the rename, so a crash anywhere here replays cleanly
                dst.flush()
                t1 = self._clock()
                with telemetry.child_span("store.fsync", self.name,
                                          caller="compact"):
                    os.fsync(dst.fileno())
                self._m_fsync.observe(self._clock() - t1, label="compact")
            self._drop_handles()
            os.replace(tmp, self._ssd_path)
            # pending tombstones went out with the old file: a removed key
            # simply has no record in the new log, which replays the same
            self._unsynced = False
            self._index.update(new_locs)
            self._ssd_bytes = live_bytes
            self._m_compact.observe(self._clock() - t0)
