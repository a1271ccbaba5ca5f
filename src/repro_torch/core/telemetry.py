"""Unified telemetry: metrics registry, causal tracing, flight recorder.

Three concerns, one substrate, all off by default:

- **Metrics registry**: named counters / gauges / fixed-bucket latency
  histograms / bounded time-series rings, declared up front in ``CATALOG``
  (``docs/METRICS.md`` is rendered from it and drift-checked by
  ``scripts/ci.sh --lint``). Components bind instruments once at
  construction; with telemetry disabled every factory returns the shared
  ``NOOP`` singleton, so the hot paths pay a single no-op method call at
  most. Existing ad-hoc stats dicts (``client.stats``,
  ``manager.drain_stats``, ``bypass_stats``, per-server ``stats_query``
  payloads) are absorbed without touching their owners' locking: the
  owner registers a *poll* callback that snapshots the dict under its own
  lock, and the registry calls it — holding no registry lock — only when
  someone actually scrapes.

- **Causal tracing**: a thread-local span stack plus a trace context
  (``[trace_id, parent_span_id]``) that ``Transport.send/request/reply``
  piggybacks on dict payloads under the ``TRACE_KEY`` key. Handlers never
  read that key themselves — dispatch loops wrap handler calls in
  ``msg_span``, which re-parents the receive-side span under the sender's
  span, so one logical op (a put, a pread, a drain micro-epoch, a
  checkpoint save) becomes a span tree across client -> server -> replica
  -> manager. Only explicitly-opened roots are traced: an untraced
  message costs one dict ``.get``. ``export_chrome`` emits Chrome
  trace-event JSON loadable in Perfetto / ``chrome://tracing``.

- **Flight recorder**: a bounded per-component ring of recent structured
  events (epoch begin/abort/complete, evictions, redirects, timeouts,
  failovers, server death). ``tests/conftest.py`` dumps it to
  ``$BB_FLIGHT_ARTIFACT`` on any test failure, next to the lock-order
  artifact, so a red test ships its own post-mortem.

Clock-injected throughout (bbcheck rule 4): the registry owns one
monotonic clock and every timestamp routes through it, so tests can drive
telemetry time deterministically.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import locktrack

# The key Transport injects into dict payloads to carry the trace context.
# tools/bbcheck's schema pass knows it as transport-injected; handlers must
# go through msg_span()/trace_from() instead of reading it directly.
TRACE_KEY = "_trace"

# Every instrument the system may bind, alphabetical by name:
# (name, type, unit, owner component, description). docs/METRICS.md is
# rendered from this tuple (tools/bbcheck --emit-metrics); binding a name
# that is not declared here raises, which is what keeps the doc honest.
CATALOG: Tuple[Tuple[str, str, str, str, str], ...] = (
    ("ckpt.restore_s", "histogram", "seconds", "checkpoint",
     "Wall time of one CheckpointManager.restore() call."),
    ("ckpt.save_s", "histogram", "seconds", "checkpoint",
     "Wall time of one CheckpointManager.save() ingest (the async PFS "
     "flush is timed separately under the same trace)."),
    ("client.dispatch_s", "histogram", "seconds", "client",
     "Write-op wire dispatch to replicated-ACK completion, keyed by QoS "
     "lane."),
    ("client.lane_wait_s", "histogram", "seconds", "client",
     "Time a write op parks in the client WDRR lane queue before "
     "dispatch, keyed by QoS lane."),
    ("client.ops", "poll", "count", "client",
     "Per-client op counters (BBClient.stats), one label per client."),
    ("fs.bypass", "poll", "count", "filesystem",
     "Write-through bypass counters (BBFileSystem.bypass_stats)."),
    ("health.anomalies", "counter", "count", "health",
     "Stall-watchdog anomalies raised by the health engine, keyed by "
     "anomaly kind (epoch_stall / silent_server / queue_growth)."),
    ("health.eval_s", "histogram", "seconds", "health",
     "Wall time of one HealthEngine.evaluate() pass over a registry "
     "snapshot."),
    ("manager.drain_epoch_s", "histogram", "seconds", "manager",
     "Drain micro-epoch duration, drain_request arrival to the last "
     "flush_done."),
    ("manager.epoch_aborts", "counter", "count", "manager",
     "Aborted drain/stage epochs, keyed by phase/cause."),
    ("manager.ops", "poll", "count", "manager",
     "Manager epoch counters (drain_stats + stage_stats)."),
    ("manager.stage_epoch_s", "histogram", "seconds", "manager",
     "Stage-in epoch duration, stage_request arrival to stage_done."),
    ("qos.occupancy_ewma", "gauge", "fraction", "qos",
     "Congestion-window occupancy EWMA (CongestionWindows), labeled by "
     "owning client."),
    ("server.dispatch_s", "histogram", "seconds", "server",
     "Handler service time for laned kinds (put / put_batch / "
     "replica_put / replica_put_batch), keyed by lane."),
    ("server.lane_wait_s", "histogram", "seconds", "server",
     "Time a laned message parks in the server WDRR queue before "
     "dispatch, keyed by lane."),
    ("server.occupancy", "ring", "fraction", "server",
     "Sampled storage-occupancy fraction at the drain pressure cadence, "
     "labeled by server."),
    ("server.ops", "poll", "count", "server",
     "Per-server op counters (BBServer.stats), one label per server."),
    ("store.compact_s", "histogram", "seconds", "tiering",
     "Wall time of one LogStore.compact() pass including its fsync."),
    ("store.crc_failures", "counter", "count", "tiering",
     "Log records dropped at recovery because the stored CRC did not "
     "match the payload, labeled by store."),
    ("store.fsync_s", "histogram", "seconds", "tiering",
     "Record-log fsync latency, keyed by caller (spill / sync / "
     "compact)."),
    ("store.spill_s", "histogram", "seconds", "tiering",
     "Wall time of one DRAM->SSD spill batch including its barrier "
     "fsync."),
    ("transport.msgs", "counter", "count", "transport",
     "Messages accepted by Transport.send/request, keyed by kind."),
    ("transport.src_msgs", "counter", "count", "transport",
     "Messages accepted by Transport.send/request, keyed by the sending "
     "endpoint — the health engine's silent-server watchdog reads this "
     "to spot a server whose send counter stops advancing while peers' "
     "advance."),
)

_CATALOG_BY_NAME = {spec[0]: spec for spec in CATALOG}


class _Noop:
    """Shared do-nothing instrument *and* span: every recording method is
    a pass and it is its own context manager, so disabled call sites cost
    one attribute lookup and nothing else."""

    __slots__ = ()

    def inc(self, n: int = 1, label: Optional[str] = None):
        pass

    def add(self, n: int, label: Optional[str] = None):
        pass

    def set(self, value: float, label: Optional[str] = None):
        pass

    def observe(self, value: float, label: Optional[str] = None):
        pass

    def note(self, value: float, label: Optional[str] = None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


# ------------------------------------------------------------- instruments
class Counter:
    """Monotonic counter, one integer cell per label."""

    def __init__(self, name: str, clock: Callable[[], float]):
        self.name = name
        self._lock = locktrack.lock("Counter._lock")
        self._vals: Dict[str, float] = {}

    def inc(self, n: int = 1, label: Optional[str] = None):
        with self._lock:
            key = label or ""
            self._vals[key] = self._vals.get(key, 0) + n

    add = inc

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)


class Gauge:
    """Last-write-wins point-in-time value per label."""

    def __init__(self, name: str, clock: Callable[[], float]):
        self.name = name
        self._lock = locktrack.lock("Gauge._lock")
        self._vals: Dict[str, float] = {}

    def set(self, value: float, label: Optional[str] = None):
        with self._lock:
            self._vals[label or ""] = float(value)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)


class Histogram:
    """Fixed-bucket latency histogram per label.

    Geometric bounds, half-decade steps from 10us to 10s plus an overflow
    bucket — wide enough for an fsync and a drain epoch on one scale."""

    BOUNDS = (1e-5, 3.16e-5, 1e-4, 3.16e-4, 1e-3, 3.16e-3, 1e-2, 3.16e-2,
              0.1, 0.316, 1.0, 3.16, 10.0)

    def __init__(self, name: str, clock: Callable[[], float]):
        self.name = name
        self._lock = locktrack.lock("Histogram._lock")
        self._series: Dict[str, dict] = {}

    def observe(self, value: float, label: Optional[str] = None):
        idx = bisect.bisect_right(self.BOUNDS, value)
        with self._lock:
            st = self._series.get(label or "")
            if st is None:
                st = self._series[label or ""] = {
                    "count": 0, "sum": 0.0, "min": value, "max": value,
                    "buckets": [0] * (len(self.BOUNDS) + 1)}
            st["count"] += 1
            st["sum"] += value
            if value < st["min"]:
                st["min"] = value
            if value > st["max"]:
                st["max"] = value
            st["buckets"][idx] += 1

    def snapshot(self) -> dict:
        with self._lock:
            series = {k: {**v, "buckets": list(v["buckets"])}
                      for k, v in self._series.items()}
        return {"bounds": list(self.BOUNDS), "series": series}


class Ring:
    """Bounded time series: (t, label, value) samples, oldest dropped."""

    MAXLEN = 512

    def __init__(self, name: str, clock: Callable[[], float]):
        self.name = name
        self._clock = clock
        self._lock = locktrack.lock("Ring._lock")
        self._dq: collections.deque = collections.deque(maxlen=self.MAXLEN)

    def note(self, value: float, label: Optional[str] = None):
        with self._lock:
            self._dq.append((self._clock(), label or "", float(value)))

    def snapshot(self) -> List[list]:
        with self._lock:
            return [list(t) for t in self._dq]


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "ring": Ring}
_SNAPSHOT_KEYS = {"counter": "counters", "gauge": "gauges",
                  "histogram": "histograms", "ring": "rings"}


# ----------------------------------------------------------------- tracing
class _SpanStack(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


_SPANS = _SpanStack()


class Span:
    """One timed node of a trace tree; a context manager. While entered it
    sits on this thread's span stack, so any Transport send issued inside
    it carries ``[trace_id, span_id]`` to the receiver."""

    __slots__ = ("_tracer", "name", "component", "trace_id", "span_id",
                 "parent_id", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, component: str,
                 trace_id: int, parent_id: int, args: dict):
        self._tracer = tracer
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.span_id = next(tracer._ids)
        self.parent_id = parent_id
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = self._tracer._clock()
        _SPANS.stack.append(self)
        return self

    def __exit__(self, *exc):
        st = _SPANS.stack
        if st and st[-1] is self:
            st.pop()
        else:                               # defensive: misnested exit
            try:
                st.remove(self)
            except ValueError:
                pass
        self._tracer._finish(self, self._tracer._clock())
        return False


class Tracer:
    """Bounded ring of completed spans + the span/trace id allocator."""

    MAXLEN = 65536

    def __init__(self, clock: Callable[[], float]):
        self._clock = clock
        self._ids = itertools.count(1)
        self._lock = locktrack.lock("Tracer._lock")
        self._events: collections.deque = collections.deque(
            maxlen=self.MAXLEN)
        # lifetime count of finished spans — the deque drops its oldest
        # entries, so incremental consumers (the health engine's critical-
        # path pass) diff this to know how many tail events are new
        self._count = 0

    def current_ctx(self) -> Optional[List[int]]:
        st = _SPANS.stack
        if not st:
            return None
        top = st[-1]
        return [top.trace_id, top.span_id]

    def root(self, name: str, component: str, **args) -> Span:
        return Span(self, name, component, next(self._ids), 0, args)

    def span(self, name: str, component: str, ctx=None, **args):
        """Child span: parented by an explicit message context if one
        rode in, else by this thread's current span; with neither, the
        work stays untraced (roots are only opened explicitly)."""
        if isinstance(ctx, (list, tuple)) and len(ctx) == 2:
            return Span(self, name, component, ctx[0], ctx[1], args)
        cur = _SPANS.stack
        if not cur:
            return NOOP
        top = cur[-1]
        return Span(self, name, component, top.trace_id, top.span_id, args)

    def _finish(self, span: Span, t1: float):
        with self._lock:
            self._count += 1
            self._events.append((span.trace_id, span.span_id,
                                 span.parent_id, span.name, span.component,
                                 span._t0, t1 - span._t0, span.args))

    def observe(self, name: str, component: str, ctx, t0: float,
                dur: float, **args):
        """Record an externally-timed, already-completed span parented by
        an explicit trace context — for wait intervals measured outside a
        ``with`` block (a message parked in a lane queue has no thread
        executing it, so nothing could hold a live span open)."""
        if not (isinstance(ctx, (list, tuple)) and len(ctx) == 2):
            return
        with self._lock:
            self._count += 1
            self._events.append((ctx[0], next(self._ids), ctx[1], name,
                                 component, t0, dur, args))

    def events(self) -> List[tuple]:
        with self._lock:
            return list(self._events)

    def events_total(self) -> int:
        """Finished spans over this tracer's lifetime (not bounded by the
        ring) — the watermark for incremental event consumers."""
        with self._lock:
            return self._count

    def chrome_events(self) -> List[dict]:
        """Chrome trace-event JSON: one complete ('X') event per span plus
        thread_name metadata mapping tids back to components."""
        tids: Dict[str, int] = {}
        out: List[dict] = []
        for trace, span_id, parent, name, comp, t0, dur, args in \
                self.events():
            tid = tids.setdefault(comp, len(tids) + 1)
            out.append({"name": name, "cat": comp, "ph": "X", "pid": 1,
                        "tid": tid, "ts": t0 * 1e6, "dur": dur * 1e6,
                        "args": {"trace": trace, "span": span_id,
                                 "parent": parent, **args}})
        for comp, tid in sorted(tids.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid, "args": {"name": comp}})
        return out


# --------------------------------------------------------- flight recorder
class FlightRecorder:
    """Bounded per-component ring of recent structured events, dumped to a
    JSON artifact on crash or test failure (conftest wires the latter)."""

    PER_COMPONENT = 512

    def __init__(self, clock: Callable[[], float]):
        self._clock = clock
        self._lock = locktrack.lock("FlightRecorder._lock")
        self._by_component: Dict[str, collections.deque] = {}

    def record(self, component: str, event: str, **fields):
        t = self._clock()
        with self._lock:
            dq = self._by_component.get(component)
            if dq is None:
                dq = self._by_component[component] = collections.deque(
                    maxlen=self.PER_COMPONENT)
            dq.append({"t": t, "event": event, **fields})

    def snapshot(self) -> Dict[str, List[dict]]:
        with self._lock:
            return {c: list(dq)
                    for c, dq in sorted(self._by_component.items())}

    def dump(self, path: str, **extra) -> str:
        doc = {"flight": self.snapshot(), **extra}
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=repr)
        return path


# ---------------------------------------------------------------- registry
class Registry:
    """One clock, one instrument table, one tracer, one flight recorder.

    Instruments are created lazily on first bind and validated against
    CATALOG; poll callbacks are keyed by (name, label) so re-constructed
    components (every test builds a fresh system) replace rather than
    accumulate."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = locktrack.lock("Registry._lock")
        self._instruments: Dict[str, Any] = {}
        self._pollers: Dict[Tuple[str, str], Callable[[], dict]] = {}
        self.tracer = Tracer(clock)
        self.flight = FlightRecorder(clock)

    def _get(self, name: str, kind: str):
        spec = _CATALOG_BY_NAME.get(name)
        if spec is None or spec[1] != kind:
            raise ValueError(
                f"unknown {kind} instrument {name!r} — declare it in "
                f"telemetry.CATALOG (docs/METRICS.md is rendered from it)")
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = _TYPES[kind](
                    name, self._clock)
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def ring(self, name: str) -> Ring:
        return self._get(name, "ring")

    def poll(self, name: str, fn: Callable[[], dict], label: str = ""):
        spec = _CATALOG_BY_NAME.get(name)
        if spec is None or spec[1] != "poll":
            raise ValueError(
                f"unknown poll instrument {name!r} — declare it in "
                f"telemetry.CATALOG (docs/METRICS.md is rendered from it)")
        with self._lock:
            self._pollers[(name, label)] = fn

    def snapshot(self) -> dict:
        """Full registry dump. Poll callbacks run with no registry lock
        held — they take their owner's lock, never the reverse, which is
        what keeps the lock-order graph acyclic."""
        with self._lock:
            instruments = dict(self._instruments)
            pollers = dict(self._pollers)
        out: Dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}, "rings": {}, "polls": {}}
        for name, inst in sorted(instruments.items()):
            out[_SNAPSHOT_KEYS[_CATALOG_BY_NAME[name][1]]][name] = \
                inst.snapshot()
        for (name, label), fn in sorted(pollers.items()):
            try:
                val = fn()
            except Exception:       # owner mid-teardown: skip, don't fail
                continue
            out["polls"].setdefault(name, {})[label] = val
        return out


# ------------------------------------------------------------- module API
# Mirrors locktrack: a module-level singleton the factories consult, so
# components bind real instruments only when a harness (conftest, bbstat,
# an operator) opted in before constructing the system.
_registry: Optional[Registry] = None


def enable(clock: Callable[[], float] = time.monotonic) -> Registry:
    """Idempotent: returns the existing registry if already enabled."""
    global _registry
    if _registry is None:
        _registry = Registry(clock)
    return _registry


def disable():
    global _registry
    _registry = None


def enabled() -> bool:
    return _registry is not None


def registry() -> Optional[Registry]:
    return _registry


def counter(name: str):
    reg = _registry
    return NOOP if reg is None else reg.counter(name)


def gauge(name: str):
    reg = _registry
    return NOOP if reg is None else reg.gauge(name)


def histogram(name: str):
    reg = _registry
    return NOOP if reg is None else reg.histogram(name)


def ring(name: str):
    reg = _registry
    return NOOP if reg is None else reg.ring(name)


def poll(name: str, fn: Callable[[], dict], label: str = ""):
    reg = _registry
    if reg is not None:
        reg.poll(name, fn, label)


def snapshot() -> dict:
    reg = _registry
    return {} if reg is None else reg.snapshot()


def record(component: str, event: str, **fields):
    reg = _registry
    if reg is not None:
        reg.flight.record(component, event, **fields)


def span(name: str, component: str = "app", **args):
    """Open a span: child of this thread's current span if one is active,
    else a brand-new trace root."""
    reg = _registry
    if reg is None:
        return NOOP
    ctx = reg.tracer.current_ctx()
    if ctx is not None:
        return reg.tracer.span(name, component, ctx=ctx, **args)
    return reg.tracer.root(name, component, **args)


def child_span(name: str, component: str, **args):
    """Open a span ONLY if this thread already has one active — untraced
    work stays untraced (``span()`` would open a brand-new root). For
    instrumenting interior segments (an fsync inside a put) without
    rooting a trace per call."""
    reg = _registry
    if reg is None:
        return NOOP
    return reg.tracer.span(name, component, **args)


def observe_span(name: str, component: str, ctx, t0: float, dur: float,
                 **args):
    """Record an externally-timed completed span under an explicit
    ``[trace_id, parent_span_id]`` context (no-op when ctx is None — the
    op was untraced). See ``Tracer.observe``."""
    reg = _registry
    if reg is not None:
        reg.tracer.observe(name, component, ctx, t0, dur, **args)


def current_ctx() -> Optional[List[int]]:
    """This thread's current ``[trace_id, span_id]``, or None. For stamping
    a trace context onto work that will complete on another thread."""
    reg = _registry
    return None if reg is None else reg.tracer.current_ctx()


def msg_span(name: str, component: str, payload):
    """Receive-side span for one handled message, parented by the trace
    context the sender's Transport injected. The ONLY sanctioned reader of
    TRACE_KEY outside transport.py — handlers never subscript it."""
    reg = _registry
    if reg is None:
        return NOOP
    ctx = payload.get(TRACE_KEY) if isinstance(payload, dict) else None
    return reg.tracer.span(name, component, ctx=ctx)


def trace_from(payload) -> Optional[List[int]]:
    """The raw [trace_id, parent_span_id] context riding a payload."""
    if isinstance(payload, dict):
        ctx = payload.get(TRACE_KEY)
        if isinstance(ctx, (list, tuple)) and len(ctx) == 2:
            return list(ctx)
    return None


def trace_inject(payload):
    """Called by Transport on every send: piggyback the current trace
    context on dict payloads. No active span (the steady state) means no
    key and near-zero cost."""
    reg = _registry
    if reg is None or not isinstance(payload, dict):
        return payload
    ctx = reg.tracer.current_ctx()
    if ctx is not None:
        payload[TRACE_KEY] = ctx
    return payload


def export_chrome(path: Optional[str] = None):
    """Completed spans as Chrome trace-event JSON (Perfetto-loadable).
    Returns the event list, or writes ``{"traceEvents": [...]}`` to
    ``path`` and returns the path."""
    reg = _registry
    events = [] if reg is None else reg.tracer.chrome_events()
    if path is None:
        return events
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh, indent=1, default=repr)
    return path


def dump_flight(path: str, **extra) -> str:
    """Flight-recorder artifact, written even when telemetry is disabled
    (an empty artifact still tells the post-mortem reader that much)."""
    reg = _registry
    if reg is None:
        with open(path, "w") as fh:
            json.dump({"flight": {}, **extra}, fh, indent=2,
                      sort_keys=True)
        return path
    return reg.flight.dump(path, **extra)
