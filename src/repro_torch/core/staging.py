"""Stage-in engine: manager-coordinated PFS -> BB prefetch.

The drain engine (drain.py) moves cold bytes DOWN the tiers; this module is
the same machinery run in reverse. Production burst buffers are
bidirectional staging areas — Romanus et al. (arXiv:1509.05492) name
stage-in/stage-out coupling a core capability — and after the drain engine
evicts a checkpoint, a restart that reads it back one miss at a time through
a single client serializes exactly the I/O the buffer exists to absorb.

Three cooperating pieces, split the same way drain.py splits from server.py:

  - pure planning (THIS module): domain-partitioned stage plans — given the
    union of everyone's buffered coverage, which byte ranges of MY lookup-
    table domain must be re-ingested from the PFS, sliced for sequential
    reads; a sequential-access detector that turns read() patterns into
    read-ahead windows; and a bounded thread fan-out helper shared by the
    parallel read paths.
  - the protocol driver (server.py / manager.py): stage_request ->
    stage_begin broadcast -> all-to-all stage_meta coverage exchange ->
    each server re-ingests its own domain in parallel -> stage_done.
    The manager runs ONE stage epoch at a time, serialized against drain
    micro-epochs, so the two engines can never thrash the same segments.
  - the API surface (filesystem.py): fs.stage(path) and
    BBFile(..., prefetch=...).

Staged bytes are marked CLEAN in the LogStore: they have a durable PFS copy
by construction, so the drain engine can drop them for free (tombstone, no
flush epoch) — the clean-evict fast path that keeps staging from triggering
a drain storm.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple


@dataclass
class StageConfig:
    enabled: bool = True
    slice_bytes: int = 1 << 20      # PFS read / clean-ingest granularity
    tick_bytes: int = 8 << 20       # max re-ingest per server-loop tick: the
    #                                 loop must keep answering pings mid-stage
    prefetch_window: int = 8 << 20  # read-ahead stage-in window per trigger
    prefetch_min_run: int = 2       # sequential reads before read-ahead fires
    stage_timeout_s: float = 30.0   # fs.stage(wait=True) default deadline
    request_retry_interval: float = 0.01   # stage_request retry cadence
    status_poll_interval: float = 0.005    # stage_status poll cadence


# ----------------------------------------------------------- interval math

def merge_intervals(iv: Sequence[Sequence[int]]) -> List[List[int]]:
    out: List[List[int]] = []
    for lo, hi in sorted(list(p) for p in iv):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def gaps(covered: Sequence[Sequence[int]], lo: int, hi: int
         ) -> List[List[int]]:
    """Sub-intervals of [lo, hi) not covered by the (merged) interval list."""
    out = []
    pos = lo
    for a, b in covered:
        if a > pos:
            out.append([pos, min(a, hi)])
        pos = max(pos, b)
        if pos >= hi:
            break
    if pos < hi:
        out.append([pos, hi])
    return [g for g in out if g[0] < g[1]]


def plan_stage(my_domains: Sequence[Tuple[int, int]],
               requested: Tuple[int, int],
               covered: Sequence[Sequence[int]],
               slice_bytes: int) -> List[Tuple[int, int]]:
    """The stage plan for one server: (offset, length) slices of the PFS
    file this server must re-ingest.

    ``my_domains`` are this server's lookup-table domains of the file,
    ``requested`` the [lo, hi) byte range being staged, and ``covered`` the
    UNION of every participant's live buffered coverage — bytes someone
    already holds are at least as fresh as the PFS copy and must never be
    re-ingested over (a staged chunk shadowing a buffered rewrite would
    resurrect stale bytes). Gaps are sliced to ``slice_bytes`` so each
    ingest is one bounded sequential PFS read."""
    merged = merge_intervals(covered)
    lo, hi = requested
    plan: List[Tuple[int, int]] = []
    for a, b in my_domains:
        a, b = max(a, lo), min(b, hi)
        if a >= b:
            continue
        for g_lo, g_hi in gaps(merged, a, b):
            pos = g_lo
            while pos < g_hi:
                ln = min(slice_bytes, g_hi - pos)
                plan.append((pos, ln))
                pos += ln
    return plan


# --------------------------------------------------------------- read-ahead

class ReadAhead:
    """Sequential-access detector behind BBFile prefetching (pure; no I/O).

    observe(offset, length, size) is called on every positional read; once
    ``prefetch_min_run`` consecutive reads form a forward-sequential run it
    returns the next (lo, hi) window to stage in, advancing a high-water
    mark so overlapping windows are never requested twice and the next
    window is only issued once the reader is within half a window of the
    mark (staging must track the reader, not sprint ahead of it). A seek
    breaks the run (restart workloads read manifests out of order first,
    then stream the payload — only the stream should trigger)."""

    def __init__(self, cfg: StageConfig):
        self.cfg = cfg
        self._next: Optional[int] = None    # expected offset of the next read
        self._run = 0
        self._staged_to = 0                 # high-water mark of issued windows
        self.stats = {"triggers": 0, "sequential_runs": 0}

    def observe(self, offset: int, length: int, size: int
                ) -> Optional[Tuple[int, int]]:
        if length <= 0:
            return None
        if offset == self._next:
            self._run += 1
            if self._run == self.cfg.prefetch_min_run:
                self.stats["sequential_runs"] += 1
        else:
            self._run = 1
        self._next = offset + length
        if self._run < self.cfg.prefetch_min_run:
            return None
        if self._staged_to - self._next > self.cfg.prefetch_window // 2:
            return None                 # plenty staged ahead of the reader
        lo = max(self._next, self._staged_to)
        hi = min(size, lo + self.cfg.prefetch_window)
        if lo >= hi:
            return None
        self._staged_to = hi
        self.stats["triggers"] += 1
        return (lo, hi)


# ------------------------------------------------------------- thread fan-out

def parallel_map(fn: Callable, items: Sequence, workers: int) -> List:
    """Run ``fn`` over ``items`` with up to ``workers`` threads; results in
    input order. Shared by the parallel read paths (manifest chunk fetches,
    per-domain range reads) — blocking transport.request calls from several
    threads overlap their round-trips instead of hammering one server at a
    time. The first exception is re-raised in the caller. Inline for a
    single item or a single worker: fan-out must cost nothing when it
    cannot help."""
    items = list(items)
    if not items:
        return []
    if workers <= 1 or len(items) == 1:
        return [fn(it) for it in items]
    results: List = [None] * len(items)
    errors: List[BaseException] = []
    cursor = [0]
    lock = threading.Lock()

    def _worker():
        while True:
            with lock:
                if errors or cursor[0] >= len(items):
                    return
                i = cursor[0]
                cursor[0] += 1
            try:
                results[i] = fn(items[i])
            except BaseException as e:      # surfaced to the caller
                with lock:
                    errors.append(e)
                return

    threads = [threading.Thread(target=_worker, daemon=True,
                                name=f"fanout-{i}")
               for i in range(min(workers, len(items)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
