"""Autonomous drain policy: watermarks, burst detection, bandwidth tokens.

The paper's core promise is that a burst buffer "allows for gradual flushing
of data to back-end filesystems", yet an explicit, manager-triggered flush
cannot keep a staging area from filling under sustained ingest. Romanus et
al. (arXiv:1509.05492) call staging-area space management the central burst
buffer design challenge; Shi et al. (arXiv:1902.05746) show traffic-aware
drain scheduling is what keeps the SSD tier absorbing bursts. This module is
the pure per-server policy behind both observations:

  - watermark hysteresis over LogStore occupancy: crossing the high
    watermark starts draining, falling to the low watermark stops it;
  - a sliding-window burst detector: while ingest is hot, draining defers
    (absorption wins) — unless occupancy passes the panic watermark;
  - a token bucket capping drain bandwidth, so micro-epochs can never
    monopolize the store/transport against foreground ingest.

All inputs (occupancy, the clock) are passed in, so the policy unit-tests
without a server. The protocol driver — drain micro-epochs through the
two-phase planner, tombstone eviction, read fallthrough — lives in
server.py / manager.py.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.qos import RateWindow


@dataclass
class DrainConfig:
    enabled: bool = True
    high_watermark: float = 0.70    # occupancy fraction that starts draining
    low_watermark: float = 0.40     # occupancy fraction that stops draining
    panic_watermark: float = 0.90   # drain even while ingest is hot
    request_interval: float = 0.30  # min seconds between drain requests
    max_epoch_bytes: int = 32 << 20  # per-server contribution per micro-epoch
    bw_bytes_per_s: int = 256 << 20  # token-bucket drain bandwidth cap
    burst_window_s: float = 0.25    # ingest-rate sliding window
    hot_bytes_per_s: int = 96 << 20  # ingest rate that defers draining
    min_idle_s: float = 0.0         # segment idle age before it is "cold"
    epoch_timeout_s: float = 12.0   # manager aborts a stuck micro-epoch
    pressure_interval: float = 0.25  # cadence of pressure reports to manager


class DrainEngine:
    """Per-server drain policy state machine (pure; injected clock).

    ``bucket`` replaces the engine's private token bucket with a
    shared one — the server passes its QoS ``BandwidthArbiter`` so drain
    micro-epochs and stage-in slices debit ONE background-bandwidth budget
    instead of each claiming their own against a foreground burst. The
    watermark/burst policy is unchanged either way."""

    def __init__(self, cfg: DrainConfig, now: Optional[float] = None,
                 bucket=None):
        self.cfg = cfg
        now = time.monotonic() if now is None else now
        self.draining = False           # watermark hysteresis state
        self._ingest = RateWindow(cfg.burst_window_s)
        # start with a full bucket: the first burst past the watermark must
        # be allowed to drain immediately, not wait out a refill period
        self._tokens = float(cfg.bw_bytes_per_s)
        self._token_t = now
        self._bucket = bucket
        self._last_request = -1e9
        self.stats = {"requests": 0, "deferred_hot": 0,
                      "granted_bytes": 0, "refunded_bytes": 0}

    # ---------------------------------------------------- burst detection
    def note_ingest(self, nbytes: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self._ingest.note(nbytes, now)

    def ingest_rate(self, now: Optional[float] = None) -> float:
        """Bytes/s of ingest over the sliding window."""
        now = time.monotonic() if now is None else now
        return self._ingest.rate(now)

    def hot(self, now: Optional[float] = None) -> bool:
        return self.ingest_rate(now) >= self.cfg.hot_bytes_per_s

    # ------------------------------------------------ watermark hysteresis
    def update(self, occupancy: float, now: Optional[float] = None) -> bool:
        """Advance the hysteresis state for one tick. Returns True when a
        drain micro-epoch should be REQUESTED now: the store is draining
        (between watermarks, entered from above high), ingest is not hot
        (unless occupancy passed the panic watermark — then space wins),
        and the request rate limit allows it."""
        now = time.monotonic() if now is None else now
        if occupancy >= self.cfg.high_watermark:
            self.draining = True
        elif occupancy <= self.cfg.low_watermark:
            self.draining = False
        if not self.draining:
            return False
        if self.hot(now) and occupancy < self.cfg.panic_watermark:
            self.stats["deferred_hot"] += 1
            return False
        if now - self._last_request < self.cfg.request_interval:
            return False
        return True

    def note_requested(self, now: Optional[float] = None):
        self._last_request = time.monotonic() if now is None else now
        self.stats["requests"] += 1

    def snapshot(self) -> dict:
        """Engine state for stats_query / the telemetry poll:
        the counters plus the hysteresis flag, as one plain dict."""
        return {**self.stats, "draining": self.draining}

    def note_scan(self, now: Optional[float] = None):
        """Rate-limit the next candidate scan without counting a request —
        a scan that found nothing drainable costs as much as one that did,
        so it must not repeat every server-loop tick."""
        self._last_request = time.monotonic() if now is None else now

    # ----------------------------------------------------- bandwidth tokens
    def _refill(self, now: float):
        rate = self.cfg.bw_bytes_per_s
        self._tokens = min(float(rate),
                           self._tokens + (now - self._token_t) * rate)
        self._token_t = now

    def peek(self, now: Optional[float] = None) -> int:
        """Currently available drain-bandwidth budget in bytes."""
        if self._bucket is not None:
            return self._bucket.peek(now)
        now = time.monotonic() if now is None else now
        self._refill(now)
        return max(0, int(self._tokens))

    def take(self, nbytes: int, now: Optional[float] = None) -> int:
        if self._bucket is not None:
            self.stats["granted_bytes"] += int(nbytes)
            return self._bucket.take(nbytes, now)
        return self._take_local(nbytes, now)

    def _take_local(self, nbytes: int, now: Optional[float] = None) -> int:
        """Debit ``nbytes`` of budget in full. The bucket may go NEGATIVE —
        a single cold segment can exceed what is left, and progress demands
        at least one segment per epoch — and peek() then reports 0 until
        the refill pays the debt back, which is what enforces the average
        bandwidth cap. Debiting exactly what was selected also keeps abort
        refunds symmetric: refund(bytes) returns precisely what take(bytes)
        charged, never fabricating tokens. The debt is floored at one
        bucket so a pathological selection cannot mortgage minutes."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        self._tokens = max(self._tokens - int(nbytes),
                           -float(self.cfg.bw_bytes_per_s))
        self.stats["granted_bytes"] += int(nbytes)
        return int(nbytes)

    def refund(self, nbytes: int):
        """Return budget consumed by an aborted micro-epoch (the bytes were
        never actually drained, so they must not count against the cap)."""
        self.stats["refunded_bytes"] += nbytes
        if self._bucket is not None:
            self._bucket.refund(nbytes)
            return
        self._tokens = min(float(self.cfg.bw_bytes_per_s),
                           self._tokens + nbytes)
