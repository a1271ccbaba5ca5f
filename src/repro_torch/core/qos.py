"""Traffic-aware QoS engine: classification, lanes, backpressure.

The system's whole premise is that burst buffers absorb *bursty* I/O, yet
until this module every byte was treated identically: a background analysis
stream filled the same DRAM/SSD tiers as a checkpoint burst, the drain
engine shovelled it all back out, and a saturated server inbox served
checkpoint chunks strictly behind whatever background traffic arrived
first. Shi et al. (arXiv:1902.05746) show that classifying traffic and
routing non-bursty streams *around* the buffer preserves BB capacity for
the bursts that need it; Romanus et al. (arXiv:1509.05492) name contention
between concurrent workloads the central shared-burst-buffer problem.

Four pure, clock-injected policy pieces (protocol drivers live in
client.py / server.py / filesystem.py):

  - ``TrafficClassifier``: per-stream sliding-window burst detector
    (arrival rate + sequentiality) that tags a stream BURSTY, SEQUENTIAL,
    or IDLE. Streams are BURSTY until proven boring — misclassifying a
    burst as background would be the expensive mistake.
  - priority lanes + ``LaneQueue``: a weighted deficit round-robin
    scheduler over CHECKPOINT > INTERACTIVE > BACKGROUND > DRAIN lanes,
    used by the client write pipeline (which ops go on the wire next) and
    the server put path (which buffered put is applied next).
  - ``CongestionWindows``: per-lane in-flight byte windows fed by the
    occupancy that server ACKs piggyback — a saturated cluster shrinks the
    background lanes first (geometrically, by lane index) so checkpoints
    never time out behind someone else's flood.
  - ``BandwidthArbiter``: ONE per-server token bucket for all background
    byte movement (drain micro-epochs AND stage-in slices), whose refill
    throttles while foreground ingest is hot — background flush can no
    longer starve a foreground burst, and drain + stage can no longer
    each claim a full bandwidth budget.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from . import telemetry

# stream classes
BURSTY = "bursty"            # buffer it: this is what the BB exists for
SEQUENTIAL = "sequential"    # steady + in-order: bypass to the PFS
IDLE = "idle"                # no recent arrivals

# priority lanes, highest first. DRAIN covers every background byte-mover
# (drain micro-epochs, stage-in) — it is the lane foreground never waits on.
LANE_CHECKPOINT = 0
LANE_INTERACTIVE = 1
LANE_BACKGROUND = 2
LANE_DRAIN = 3
LANES = ("checkpoint", "interactive", "background", "drain")


def lane_index(lane) -> int:
    """Accept a lane index or name; return the index."""
    if isinstance(lane, str):
        try:
            return LANES.index(lane)
        except ValueError:
            raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
    i = int(lane)
    if not 0 <= i < len(LANES):
        raise ValueError(f"lane index out of range: {lane}")
    return i


@dataclass
class QoSConfig:
    enabled: bool = True
    # --- traffic classifier
    window_s: float = 0.25            # arrival-rate sliding window
    bursty_bytes_per_s: int = 24 << 20  # rate at/above which a stream is BURSTY
    seq_min_run: int = 4              # consecutive in-order writes for SEQUENTIAL
    classify_min_bytes: int = 16 << 20  # evidence before leaving BURSTY
    idle_s: float = 1.0               # no arrivals for this long -> IDLE
    auto_bypass: bool = True          # SEQUENTIAL streams write through to PFS
    # --- lane scheduler (client dispatch + server put dequeue)
    lane_weights: Tuple[int, ...] = (8, 4, 2, 1)
    quantum_bytes: int = 256 << 10    # WDRR deficit quantum
    # queued puts applied per server-loop pass: ONE, so the loop re-drains
    # its inbox between services — a freshly-arrived priority put (or its
    # replica hop) never waits out more than a single background service,
    # each of which may include a multi-ms SSD spill
    server_ops_per_tick: int = 1
    server_recv_burst: int = 256      # inbox messages drained per pass
    # --- per-lane congestion windows (client, in-flight bytes on the wire)
    window_bytes: Tuple[int, ...] = (64 << 20, 16 << 20, 4 << 20, 4 << 20)
    window_floor: int = 64 << 10      # a lane is never fully closed
    low_occupancy: float = 0.50       # below this: full windows
    high_occupancy: float = 0.95      # at/above this: background at the floor
    # --- unified background-bandwidth arbiter (drain + stage, per server)
    hot_bytes_per_s: int = 96 << 20   # foreground rate that throttles background
    arb_hot_frac: float = 0.25        # background refill fraction while hot


class RateWindow:
    """Sliding-window byte-rate tracker (pure; injected clock). One
    implementation for every arrival-rate signal in the system: the
    per-stream classifier, the arbiter's foreground-hot detector, and the
    drain engine's burst detector all note (t, nbytes) events and ask for
    the windowed rate."""

    __slots__ = ("window_s", "_events", "_bytes")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._events: collections.deque = collections.deque()
        self._bytes = 0

    def note(self, nbytes: int, now: float):
        self._events.append((now, nbytes))
        self._bytes += nbytes
        self.trim(now)

    def trim(self, now: float):
        horizon = now - self.window_s
        dq = self._events
        while dq and dq[0][0] < horizon:
            self._bytes -= dq.popleft()[1]

    def rate(self, now: float) -> float:
        self.trim(now)
        return self._bytes / max(self.window_s, 1e-9)


class TrafficClassifier:
    """Per-stream burst detector (pure; injected clock).

    ``observe(offset, nbytes)`` on every write; ``classify()`` returns the
    stream's current class. A stream is BURSTY by default and stays so
    until it has produced ``classify_min_bytes`` of evidence AND its
    sliding-window arrival rate sits below ``bursty_bytes_per_s`` AND its
    writes form an in-order run of ``seq_min_run`` — only then is it
    SEQUENTIAL (steady, PFS-friendly, safe to route around the buffer).
    Misrouting a checkpoint to the PFS is the expensive mistake, so the
    default errs toward buffering."""

    def __init__(self, cfg: QoSConfig, now: Optional[float] = None):
        self.cfg = cfg
        now = time.monotonic() if now is None else now
        self._window = RateWindow(cfg.window_s)
        self._next_offset: Optional[int] = None
        self._run = 0
        self._total = 0
        self._last_arrival = now - 2 * cfg.idle_s   # fresh stream: IDLE
        self.stats = {"observed": 0, "observed_bytes": 0}

    def observe(self, offset: int, nbytes: int,
                now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.stats["observed"] += 1
        self.stats["observed_bytes"] += nbytes
        self._window.note(nbytes, now)
        self._total += nbytes
        self._last_arrival = now
        if offset == self._next_offset or self._next_offset is None:
            self._run += 1
        else:
            self._run = 1                   # a seek breaks the run
        self._next_offset = offset + nbytes

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return self._window.rate(now)

    def classify(self, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        if now - self._last_arrival >= self.cfg.idle_s:
            return IDLE
        if self.rate(now) >= self.cfg.bursty_bytes_per_s:
            return BURSTY
        if self._total >= self.cfg.classify_min_bytes \
                and self._run >= self.cfg.seq_min_run:
            return SEQUENTIAL
        return BURSTY


class LaneQueue:
    """Weighted deficit round robin over the priority lanes.

    Entries are opaque; each is pushed with its byte cost. ``pop`` serves
    lanes highest-priority-first, each lane consuming deficit credit
    replenished in proportion to its weight — under full backlog the lanes
    share bytes ``lane_weights``-proportionally, and an empty lane banks
    nothing (its deficit resets). ``can_pop(lane, nbytes)`` lets the
    caller veto a lane (congestion-window gating); a vetoed lane is simply
    skipped, never charged."""

    def __init__(self, weights: Sequence[int] = QoSConfig.lane_weights,
                 quantum: int = QoSConfig.quantum_bytes):
        self.weights = tuple(weights)
        self.quantum = quantum
        self._qs: List[collections.deque] = \
            [collections.deque() for _ in self.weights]
        self._deficit = [0] * len(self.weights)
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def push(self, lane: int, item, nbytes: int):
        self._qs[lane].append([item, nbytes])
        self._count += 1

    def pop(self, can_pop: Optional[Callable[[int, int], bool]] = None):
        """Next entry by WDRR, or None when empty / every lane is vetoed."""
        if self._count == 0:
            return None
        eligible: List[Tuple[int, int]] = []    # (lane, head nbytes)
        for lane, q in enumerate(self._qs):
            if not q:
                self._deficit[lane] = 0         # no banking while empty
                continue
            nbytes = q[0][1]
            if can_pop is not None and not can_pop(lane, nbytes):
                continue
            if self._deficit[lane] >= nbytes:
                return self._take(lane)
            eligible.append((lane, nbytes))
        if not eligible:
            return None
        # nobody's deficit covers its head: advance every eligible lane by
        # the same number of quantum rounds — the fewest that unblocks one —
        # so weighted fairness is preserved and pop() always serves an
        # eligible entry (a 1 MB batch must not wedge behind a tiny quantum)
        def rounds(lane: int, nbytes: int) -> int:
            per = max(1, self.weights[lane] * self.quantum)
            return -(-(nbytes - self._deficit[lane]) // per)
        lane, _ = min(eligible, key=lambda e: (rounds(*e), e[0]))
        r = rounds(lane, self._qs[lane][0][1])
        for other, _nb in eligible:
            self._deficit[other] += r * self.weights[other] * self.quantum
        return self._take(lane)

    def _take(self, lane: int):
        item, nbytes = self._qs[lane].popleft()
        self._count -= 1
        if self._qs[lane]:
            self._deficit[lane] -= nbytes
        else:
            self._deficit[lane] = 0
        return item

    def discard(self, pred: Callable) -> int:
        """Drop entries matching ``pred(item)`` (abandon/teardown path).
        Returns how many were removed."""
        removed = 0
        for lane, q in enumerate(self._qs):
            keep = collections.deque(e for e in q if not pred(e[0]))
            removed += len(q) - len(keep)
            self._qs[lane] = keep
        self._count -= removed
        return removed

    def entries(self) -> List:
        """Every queued item (introspection / teardown)."""
        return [e[0] for q in self._qs for e in q]


class CongestionWindows:
    """Per-lane in-flight byte windows driven by piggybacked occupancy.

    Server ACKs carry the store's occupancy fraction; an EWMA of those
    reports scales each lane's window by ``f ** lane`` where ``f`` falls
    linearly from 1 (at ``low_occupancy``) to 0 (at ``high_occupancy``) —
    so a saturating cluster closes the DRAIN lane first, then BACKGROUND,
    then INTERACTIVE, while the CHECKPOINT lane (exponent 0) keeps its
    full window: the buffer's job is absorbing exactly that burst."""

    EWMA = 0.3

    def __init__(self, cfg: QoSConfig, owner: str = ""):
        self.cfg = cfg
        self._occ = 0.0
        # telemetry: the EWMA doubles as the cluster-pressure
        # gauge, labeled by the owning client (no-op when disabled)
        self._owner = owner
        self._g_occ = telemetry.gauge("qos.occupancy_ewma")

    def on_pressure(self, occupancy: float):
        self._occ += self.EWMA * (float(occupancy) - self._occ)
        self._g_occ.set(self._occ, label=self._owner)

    def occupancy(self) -> float:
        return self._occ

    def window(self, lane: int) -> int:
        lo, hi = self.cfg.low_occupancy, self.cfg.high_occupancy
        if self._occ <= lo:
            f = 1.0
        elif self._occ >= hi:
            f = 0.0
        else:
            f = (hi - self._occ) / (hi - lo)
        scale = f ** lane            # lane 0 -> 1.0 always
        return max(self.cfg.window_floor,
                   int(self.cfg.window_bytes[lane] * scale))


class BandwidthArbiter:
    """ONE background-bandwidth budget per server, shared by the drain and
    stage engines (pre-QoS each had its own: the drain engine a token
    bucket, the stage engine an unmetered per-tick byte cap — together
    they could claim twice the intended background bandwidth against a
    foreground burst). Token bucket whose refill rate drops to
    ``arb_hot_frac`` while foreground ingest runs at/above
    ``hot_bytes_per_s`` — absorption wins while the burst lasts, and the
    full rate returns the moment it ends. ``take`` may overdraw (progress
    needs at least one segment/slice per epoch); ``peek`` then reports 0
    until the refill pays the debt, which is what enforces the average
    cap. ``refund`` gives an aborted epoch's debit back, clamped at one
    bucket."""

    def __init__(self, cfg: QoSConfig, rate_bytes_per_s: int,
                 now: Optional[float] = None):
        self.cfg = cfg
        self.rate = float(rate_bytes_per_s)
        now = time.monotonic() if now is None else now
        self._tokens = self.rate            # start full: first burst drains
        self._token_t = now
        self._fg = RateWindow(cfg.window_s)
        self.stats = {"granted_bytes": 0, "refunded_bytes": 0,
                      "throttled_s": 0.0}

    # ------------------------------------------------------- foreground load
    def note_foreground(self, nbytes: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self._fg.note(nbytes, now)

    def foreground_hot(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return self._fg.rate(now) >= self.cfg.hot_bytes_per_s

    # ----------------------------------------------------------- token bucket
    def _refill(self, now: float):
        rate = self.rate
        if self.foreground_hot(now):
            rate *= self.cfg.arb_hot_frac
            # accumulate throttled WALL TIME, not call count — peek() runs
            # every server-loop pass, so a per-call counter would measure
            # loop frequency rather than throttling
            self.stats["throttled_s"] += max(0.0, now - self._token_t)
        self._tokens = min(self.rate,
                           self._tokens + (now - self._token_t) * rate)
        self._token_t = now

    def peek(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        self._refill(now)
        return max(0, int(self._tokens))

    def take(self, nbytes: int, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        self._refill(now)
        self._tokens = max(self._tokens - int(nbytes), -self.rate)
        self.stats["granted_bytes"] += int(nbytes)
        return int(nbytes)

    def refund(self, nbytes: int):
        self._tokens = min(self.rate, self._tokens + nbytes)
        self.stats["refunded_bytes"] += nbytes
