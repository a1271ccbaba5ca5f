"""Cluster health and diagnosis engine.

Telemetry gave the system eyes (metrics registry, causal tracer, flight
recorder); this module is the part that *interprets* those signals. Three
passes, one ``HealthEngine.evaluate()`` call, driven on the manager's
clock-injected run-loop cadence (``HealthConfig.interval_s`` via
``BBConfig.health``):

- **SLO rules** (``SLO_RULES``, declared up front like
  ``telemetry.CATALOG``): burn-rate style windows over the existing
  latency histograms — each evaluation diffs the per-bucket counts
  against the previous snapshot and computes the p99 of *this window's*
  samples, so a fresh fsync slowdown flags within one cadence instead of
  being averaged away by an hour of healthy history — plus occupancy and
  queue-depth checks. Every rule yields ``ok | warn | critical`` with the
  offending numbers attached.

- **Stall watchdogs**: wedged state machines that no latency histogram
  can see, because the stalled operation never completes and therefore
  never observes a sample. A drain/stage epoch open longer than
  ``stall_factor ×`` its own histogram p99; a server whose
  ``transport.src_msgs`` counter stops advancing while peers' advance; a
  server lane queue whose depth grows monotonically across N
  evaluations. New anomalies are recorded into the flight recorder
  (component ``health``) and counted in ``health.anomalies``.

- **Critical-path attribution** over completed ``Tracer`` span trees:
  each root span (a put, a ``ckpt.save``, a drain epoch) is decomposed
  into queue-wait / service / network / fsync segments from the span
  names telemetry emits (``*.lane_wait`` → queue, ``store.fsync`` → fsync,
  un-instrumented gaps → network, everything else → service), using
  per-span self time (duration minus direct children). Per-op-kind
  aggregates answer "what dominates this op?" — e.g. *fsync is 61% of
  ckpt.save*.

The report surfaces through ``BBManager.pressure_report()["health"]``,
the ``health_query`` protocol message, ``BurstBufferSystem.health()``,
and the ``tools/bbtop.py`` dashboard. Everything here is clock-injected
(bbcheck rule 4) and holds no locks while evaluating — the registry
snapshot it consumes is already a coherent copy.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import telemetry

_RANK = {"ok": 0, "warn": 1, "critical": 2}


def worst(verdicts) -> str:
    """The most severe of a set of verdicts (``ok`` when empty)."""
    out = "ok"
    for v in verdicts:
        if _RANK.get(v, 0) > _RANK[out]:
            out = v
    return out


def quantile(bounds, buckets, count, q) -> float:
    """Approximate quantile from histogram bucket counts: linear within
    the winning bucket, upper bound for the overflow bucket. Same math as
    ``tools/bbstat`` — shared here so SLO verdicts and the CLI agree."""
    target = count * q
    seen = 0
    for i, n in enumerate(buckets):
        if not n:
            continue
        if seen + n >= target:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i else 0.0
            frac = (target - seen) / n
            return lo + (bounds[i] - lo) * frac
        seen += n
    return bounds[-1] if bounds else 0.0


# Every SLO the engine evaluates, alphabetical by rule name (mirrors
# telemetry.CATALOG's declare-up-front discipline; docs/OBSERVABILITY.md
# lists these):  (name, kind, instrument, label, warn, critical, summary).
#
# kinds:
#   latency_p99  p99 of the instrument's *current window* (bucket deltas
#                since the previous evaluation; cumulative on the first),
#                per label — ``label=None`` checks every label and reports
#                the worst offender, thresholds in seconds
#   ring_last    most recent sample per label of a ring instrument
#   poll_max     ``instrument:key`` — the named integer from each label's
#                poll snapshot, worst label reported
SLO_RULES: Tuple[Tuple[str, str, str, Optional[str], float, float, str],
                 ...] = (
    ("ckpt_lane_wait_p99", "latency_p99", "client.lane_wait_s",
     "checkpoint", 0.1, 1.0,
     "checkpoint-lane client queueing must stay bounded under floods"),
    ("ckpt_restore_p99", "latency_p99", "ckpt.restore_s", None, 2.0, 8.0,
     "checkpoint restore wall time"),
    ("ckpt_save_p99", "latency_p99", "ckpt.save_s", None, 2.0, 8.0,
     "checkpoint save ingest wall time"),
    ("drain_epoch_p99", "latency_p99", "manager.drain_epoch_s", None,
     4.0, 10.0,
     "drain micro-epochs approaching the abort timeout"),
    ("fsync_p99", "latency_p99", "store.fsync_s", None, 0.25, 1.0,
     "record-log fsync latency (spill / sync / compact)"),
    ("occupancy", "ring_last", "server.occupancy", None, 0.9, 0.98,
     "server storage occupancy near eviction pressure"),
    ("queue_depth", "poll_max", "server.ops:queued_puts", None,
     512.0, 4096.0,
     "server lane-queue backlog"),
    ("server_lane_wait_p99", "latency_p99", "server.lane_wait_s",
     "checkpoint", 0.1, 1.0,
     "checkpoint-lane server queueing must stay bounded under floods"),
)

# histogram that sizes the "how long should an epoch take" baseline for
# the epoch-stall watchdog, per inflight phase
_PHASE_HIST = {"drain": "manager.drain_epoch_s",
               "stage": "manager.stage_epoch_s"}


@dataclass
class HealthConfig:
    """Knobs for the evaluator. ``interval_s`` is the manager run-loop
    cadence; the watchdog counts are in units of evaluations, so their
    wall-clock reaction time scales with it."""
    interval_s: float = 0.25       # manager evaluation cadence
    stall_factor: float = 4.0      # epoch stalled at factor x histogram p99
    stall_floor_s: float = 2.0     # ...but never earlier than this
    silent_evals: int = 4          # evals without sends while peers advance
    queue_growth_evals: int = 4    # consecutive strictly-growing depths
    trace_ring: int = 256          # per-op-kind duration samples for p99
    max_pending_traces: int = 1024  # unfinalized span-tree buffer bound


def _segment(name: str) -> str:
    """Map a span name onto a critical-path segment."""
    if "lane_wait" in name:
        return "queue"
    if name.startswith("store.fsync"):
        return "fsync"
    return "service"


class HealthEngine:
    """Stateful evaluator: feed it registry snapshots (plus the manager's
    inflight-epoch view and the tracer) on a fixed cadence; read the last
    report any time. All mutation happens inside ``evaluate()`` — its
    single caller is the manager run loop — and the report is replaced
    wholesale, so cross-thread readers (``pressure_report``, the
    ``health_query`` handler, bbtop) see a coherent dict without a lock.
    """

    def __init__(self, cfg: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rules=SLO_RULES):
        self.cfg = cfg or HealthConfig()
        self.rules = rules
        self._clock = clock
        self._evals = 0
        # burn-rate windows: (instrument, label) -> (count, buckets) at
        # the previous evaluation
        self._prev_hist: Dict[Tuple[str, str], Tuple[int, List[int]]] = {}
        # silent-server watchdog: src -> [last_total, stalled_evals]
        self._progress: Dict[str, List[float]] = {}
        # queue-growth watchdog: server -> [last_depth, growing_evals]
        self._qgrowth: Dict[str, List[float]] = {}
        # anomaly keys currently firing (flight-record only transitions)
        self._active: set = set()
        # critical-path state: buffered span trees + per-op aggregates
        self._traces: Dict[int, dict] = {}
        self._events_seen = 0
        self._agg: Dict[str, dict] = {}
        self._report: dict = {
            "status": "ok", "evals": 0, "t": 0.0, "slos": [],
            "watchdogs": [], "bottlenecks": {"ops": {}, "top": None}}
        self._m_anom = telemetry.counter("health.anomalies")
        self._m_eval = telemetry.histogram("health.eval_s")

    # ------------------------------------------------------------------ api
    def report(self) -> dict:
        """The most recent evaluation's report (cheap, lock-free)."""
        return self._report

    def evaluate(self, snapshot: dict, inflight: Optional[dict] = None,
                 tracer=None, now: Optional[float] = None) -> dict:
        """One full pass: SLO rules + watchdogs + critical-path ingest.

        ``snapshot`` is a ``Registry.snapshot()`` dict; ``inflight`` is the
        manager's view of open epochs (``{"drain": {"epoch", "started"},
        "stage": {...}}``); ``tracer`` is the live ``Tracer`` (or None to
        skip attribution — e.g. when rendering a saved snapshot)."""
        now = self._clock() if now is None else now
        t0 = self._clock()
        self._evals += 1
        slos = [self._eval_rule(rule, snapshot) for rule in self.rules]
        watchdogs = self._watchdogs(snapshot, inflight or {}, now)
        if tracer is not None:
            self._ingest(tracer)
        bottlenecks = self._bottlenecks()
        status = worst([s["verdict"] for s in slos]
                       + [w["verdict"] for w in watchdogs])
        self._report = {"status": status, "evals": self._evals, "t": now,
                        "slos": slos, "watchdogs": watchdogs,
                        "bottlenecks": bottlenecks}
        self._m_eval.observe(self._clock() - t0)
        return self._report

    # ------------------------------------------------------------ SLO rules
    def _eval_rule(self, rule, snapshot: dict) -> dict:
        name, kind, instrument, label, warn, critical, summary = rule
        if kind == "latency_p99":
            candidates = self._windowed_p99s(instrument, label, snapshot)
        elif kind == "ring_last":
            candidates = self._ring_lasts(instrument, snapshot)
        else:                                   # poll_max
            candidates = self._poll_values(instrument, snapshot)
        out = {"rule": name, "kind": kind, "instrument": instrument,
               "verdict": "ok", "value": None, "label": None,
               "warn": warn, "critical": critical, "summary": summary}
        for lb, value, extra in candidates:
            verdict = "critical" if value >= critical else \
                "warn" if value >= warn else "ok"
            if _RANK[verdict] > _RANK[out["verdict"]] or (
                    out["value"] is None) or (
                    _RANK[verdict] == _RANK[out["verdict"]]
                    and value > out["value"]):
                out.update({"verdict": verdict, "value": value,
                            "label": lb, **extra})
        return out

    def _windowed_p99s(self, instrument: str, label: Optional[str],
                       snapshot: dict):
        """Per-label p99 of the samples observed since the previous
        evaluation (cumulative on the first sight of a series). Labels
        with no new samples this window yield nothing — an idle series is
        not evidence of health or sickness."""
        hist = snapshot.get("histograms", {}).get(instrument)
        if not hist:
            return []
        bounds = hist.get("bounds", [])
        out = []
        for lb, st in sorted(hist.get("series", {}).items()):
            if label is not None and lb != label:
                continue
            key = (instrument, lb)
            prev = self._prev_hist.get(key)
            buckets, count = st["buckets"], st["count"]
            if prev is not None and prev[0] <= count:
                dcount = count - prev[0]
                dbuckets = [c - p for c, p in zip(buckets, prev[1])]
            else:                   # first sight (or a registry reset)
                dcount, dbuckets = count, buckets
            self._prev_hist[key] = (count, list(buckets))
            if dcount <= 0:
                continue
            out.append((lb, quantile(bounds, dbuckets, dcount, 0.99),
                        {"window_count": dcount}))
        return out

    def _ring_lasts(self, instrument: str, snapshot: dict):
        last: Dict[str, float] = {}
        for _t, lb, value in snapshot.get("rings", {}).get(instrument, []):
            last[lb] = value        # samples are time-ordered
        return [(lb, v, {}) for lb, v in sorted(last.items())]

    def _poll_values(self, instrument: str, snapshot: dict):
        inst, _, field = instrument.partition(":")
        out = []
        for lb, snap in sorted(
                snapshot.get("polls", {}).get(inst, {}).items()):
            v = snap.get(field) if isinstance(snap, dict) else None
            if isinstance(v, (int, float)):
                out.append((lb, float(v), {}))
        return out

    # ------------------------------------------------------------ watchdogs
    def _watchdogs(self, snapshot: dict, inflight: dict,
                   now: float) -> List[dict]:
        anomalies = []
        anomalies.extend(self._wd_epoch_stall(snapshot, inflight, now))
        anomalies.extend(self._wd_silent_server(snapshot))
        anomalies.extend(self._wd_queue_growth(snapshot))
        # flight-record (and count) only the *transitions* into anomaly, so
        # a wedge held across many evaluations is one event, not a flood
        firing = set()
        for a in anomalies:
            key = (a["kind"], a.get("server") or a.get("phase"))
            firing.add(key)
            if key not in self._active:
                self._m_anom.inc(label=a["kind"])
                telemetry.record("health", a["kind"],
                                 **{k: v for k, v in a.items()
                                    if k != "kind"})
        self._active = firing
        return anomalies

    def _wd_epoch_stall(self, snapshot: dict, inflight: dict, now: float):
        """An open drain/stage epoch older than ``stall_factor ×`` its own
        completion-time p99 (with a floor while the histogram is young) is
        wedged: completions observe the histogram, so a stuck epoch never
        raises the baseline it is judged against."""
        out = []
        for phase, hist_name in sorted(_PHASE_HIST.items()):
            info = inflight.get(phase)
            if not info:
                continue
            age = now - info.get("started", now)
            hist = snapshot.get("histograms", {}).get(hist_name, {})
            limit = self.cfg.stall_floor_s
            series = hist.get("series", {}).get("")
            if series and series["count"]:
                p99 = quantile(hist.get("bounds", []), series["buckets"],
                               series["count"], 0.99)
                limit = max(limit, self.cfg.stall_factor * p99)
            if age > limit:
                out.append({"kind": "epoch_stall", "verdict": "critical",
                            "phase": phase, "epoch": info.get("epoch"),
                            "age_s": age, "limit_s": limit})
        return out

    def _wd_silent_server(self, snapshot: dict):
        """A server whose ``transport.src_msgs`` counter froze for
        ``silent_evals`` evaluations while at least one peer's advanced.
        Idle clusters are exempt: with nobody advancing there is no
        evidence of asymmetry (servers heartbeat pressure reports and
        stabilization pings, so a healthy loaded cluster always sends)."""
        totals = {src: total for src, total in snapshot.get(
            "counters", {}).get("transport.src_msgs", {}).items()
            if src.startswith("server")}
        # advancement is judged against the previous evaluation only —
        # first-sight servers have no baseline yet and just record one
        peers_advanced = any(
            src in self._progress and total > self._progress[src][0]
            for src, total in totals.items())
        out = []
        for src, total in sorted(totals.items()):
            st = self._progress.get(src)
            if st is None:
                self._progress[src] = [total, 0]
                continue
            if total > st[0]:
                st[0], st[1] = total, 0
            elif peers_advanced:
                st[1] += 1
            if st[1] >= self.cfg.silent_evals:
                out.append({"kind": "silent_server", "verdict": "critical",
                            "server": src, "msgs": total,
                            "stalled_evals": st[1]})
        return out

    def _wd_queue_growth(self, snapshot: dict):
        """A lane queue whose depth grew strictly monotonically across
        ``queue_growth_evals`` evaluations: arrival rate has outrun
        service rate for the whole observation window, which ends in the
        queue-depth SLO going critical if nothing intervenes."""
        out = []
        for server, snap in sorted(snapshot.get("polls", {}).get(
                "server.ops", {}).items()):
            depth = snap.get("queued_puts") if isinstance(snap, dict) \
                else None
            if not isinstance(depth, (int, float)):
                continue
            st = self._qgrowth.setdefault(server, [depth, 0])
            st[1] = st[1] + 1 if depth > st[0] else 0
            st[0] = depth
            if st[1] >= self.cfg.queue_growth_evals:
                out.append({"kind": "queue_growth", "verdict": "warn",
                            "server": server, "depth": depth,
                            "growing_evals": st[1]})
        return out

    # -------------------------------------------- critical-path attribution
    def _ingest(self, tracer):
        """Consume spans finished since the last evaluation and finalize
        the trace trees that have settled. A trace is attributed one
        evaluation after its last span lands: span trees complete across
        threads, so the cadence gap doubles as the straggler barrier."""
        total = tracer.events_total()
        fresh = total - self._events_seen
        self._events_seen = total
        if fresh > 0:
            events = tracer.events()
            for ev in events[-fresh:] if fresh < len(events) else events:
                trace_id, span_id, parent, name, _comp, _t0, dur, _args = ev
                ent = self._traces.get(trace_id)
                if ent is None:
                    while len(self._traces) >= self.cfg.max_pending_traces:
                        self._traces.pop(next(iter(self._traces)))
                    ent = self._traces[trace_id] = {
                        "spans": [], "root": None, "touched": 0}
                ent["spans"].append((span_id, parent, name, dur))
                if parent == 0:
                    ent["root"] = (name, dur)
                ent["touched"] = self._evals
        settled = [tid for tid, ent in self._traces.items()
                   if ent["root"] is not None
                   and ent["touched"] < self._evals]
        for tid in settled:
            self._finalize(self._traces.pop(tid))

    def _finalize(self, ent: dict):
        """Decompose one completed trace: per-span self time (duration
        minus direct children) lands in its name's segment — except the
        root's, which is by construction the time no handler span covers:
        the network/scheduling gap between hops. Shares are normalized
        over the segment total, so concurrent child threads (self time
        exceeding root wall) stay a partition."""
        kind, wall = ent["root"]
        child_dur: Dict[int, float] = {}
        for span_id, parent, _name, dur in ent["spans"]:
            child_dur[parent] = child_dur.get(parent, 0.0) + dur
        segs = {"queue": 0.0, "service": 0.0, "fsync": 0.0, "network": 0.0}
        total_self = 0.0
        for span_id, parent, name, dur in ent["spans"]:
            self_t = dur - child_dur.get(span_id, 0.0)
            if self_t > 0.0:
                segs["network" if parent == 0
                     else _segment(name)] += self_t
                total_self += self_t
        if wall > total_self:
            segs["network"] += wall - total_self
        agg = self._agg.get(kind)
        if agg is None:
            agg = self._agg[kind] = {
                "count": 0, "wall": 0.0,
                "durs": collections.deque(maxlen=self.cfg.trace_ring),
                "segs": {"queue": 0.0, "service": 0.0, "fsync": 0.0,
                         "network": 0.0}}
        agg["count"] += 1
        agg["wall"] += wall
        agg["durs"].append(wall)
        for seg, v in segs.items():
            agg["segs"][seg] += v

    def _bottlenecks(self) -> dict:
        ops = {}
        top = None
        for kind, agg in sorted(self._agg.items()):
            total = sum(agg["segs"].values())
            denom = total if total > 0.0 else 1.0
            durs = sorted(agg["durs"])
            p99 = durs[min(len(durs) - 1, int(0.99 * len(durs)))] \
                if durs else 0.0
            dominant = max(agg["segs"], key=lambda s: agg["segs"][s])
            share = agg["segs"][dominant] / denom
            ops[kind] = {
                "count": agg["count"], "wall_s": agg["wall"], "p99_s": p99,
                "segments": {s: {"s": v, "share": v / denom}
                             for s, v in sorted(agg["segs"].items())},
                "dominant": dominant,
                "summary": f"{dominant} is {share * 100.0:.0f}% "
                           f"of {kind}"}
            if top is None or agg["wall"] > ops[top]["wall_s"]:
                top = kind
        return {"ops": ops,
                "top": None if top is None else {
                    "op": top, "segment": ops[top]["dominant"],
                    "share": ops[top]["segments"][
                        ops[top]["dominant"]]["share"],
                    "summary": ops[top]["summary"]}}
