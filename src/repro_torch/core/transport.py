"""Message transport between burst-buffer entities.

The paper uses CCI over Gemini/IB verbs; here entities (clients, servers,
manager) are threads in one process and the transport is a registry of
per-endpoint queues. All inter-entity interaction goes through ``send`` /
``request`` — entities never touch each other's state directly, so the
protocol logic is exactly what would run over a socket/RDMA transport on a
real deployment (swap Transport for a gRPC/CCI-backed one).

``drop()`` black-holes an endpoint (failure injection): messages to a dropped
endpoint vanish, requests to it time out — matching the paper's §IV-B2
timeout-based failure detection.
"""
from __future__ import annotations

import itertools
import queue
from dataclasses import dataclass
from typing import Any, Dict, Optional

from . import locktrack, telemetry


@dataclass
class Message:
    kind: str
    src: str
    dst: str
    payload: Any = None
    msg_id: int = 0
    reply_to: Optional[int] = None     # msg_id this replies to


class Endpoint:
    def __init__(self, name: str, transport: "Transport"):
        self.name = name
        self.transport = transport
        self.inbox: "queue.Queue[Message]" = queue.Queue()
        self._pending: Dict[int, "queue.Queue[Message]"] = {}
        self._lock = locktrack.lock("Endpoint._lock")

    def deliver(self, msg: Message):
        if msg.reply_to is not None:
            # pop, not get: one reply per request, and async requests have
            # no other cleanup point — leaving entries behind would leak one
            # per acked put on the hot ingest path
            with self._lock:
                waiter = self._pending.pop(msg.reply_to, None)
            if waiter is not None:
                waiter.put(msg)
                return
        self.inbox.put(msg)

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self.inbox.get(timeout=timeout)
        except queue.Empty:
            return None


class Transport:
    def __init__(self):
        self._endpoints: Dict[str, Endpoint] = {}
        self._dropped: set = set()
        self._ids = itertools.count(1)
        self._lock = locktrack.lock("Transport._lock")
        self.bytes_sent: Dict[str, int] = {}
        # per-kind message counter; the shared no-op when telemetry is off
        self._m_msgs = telemetry.counter("transport.msgs")
        # per-SOURCE counter: the health engine's silent-server
        # watchdog flags an endpoint whose send counter stops advancing
        # while its peers' advance — per-kind totals can't see that
        self._m_src = telemetry.counter("transport.src_msgs")

    def register(self, name: str) -> Endpoint:
        ep = Endpoint(name, self)
        with self._lock:
            self._endpoints[name] = ep
            self._dropped.discard(name)
        return ep

    def drop(self, name: str):
        """Fail an endpoint: all future traffic to it is black-holed."""
        with self._lock:
            self._dropped.add(name)

    def restore(self, name: str):
        with self._lock:
            self._dropped.discard(name)

    def alive(self, name: str) -> bool:
        with self._lock:
            return name in self._endpoints and name not in self._dropped

    def endpoints(self):
        with self._lock:
            return sorted(self._endpoints)

    def _size_of(self, payload) -> int:
        if isinstance(payload, (bytes, bytearray, memoryview)):
            return len(payload)
        if isinstance(payload, dict):
            return sum(self._size_of(v) for v in payload.values())
        if isinstance(payload, (list, tuple)):
            return sum(self._size_of(v) for v in payload)
        return 64   # control-message overhead estimate

    def send(self, src: str, dst: str, kind: str, payload: Any = None,
             reply_to: Optional[int] = None) -> int:
        # piggyback the sender's trace context (telemetry.TRACE_KEY) on
        # dict payloads so the receive-side dispatch loop can re-parent
        # its span under ours; replies route through here too
        payload = telemetry.trace_inject(payload)
        self._m_msgs.inc(label=kind)
        self._m_src.inc(label=src)
        msg_id = next(self._ids)
        with self._lock:
            ep = self._endpoints.get(dst)
            dead = dst in self._dropped or src in self._dropped
            self.bytes_sent[src] = self.bytes_sent.get(src, 0) \
                + self._size_of(payload)
        if ep is None or dead:
            return msg_id                          # black hole
        ep.deliver(Message(kind, src, dst, payload, msg_id, reply_to))
        return msg_id

    def request_async(self, src_ep: Endpoint, dst: str, kind: str,
                      payload: Any = None,
                      sink: Optional["queue.Queue[Message]"] = None) -> int:
        """Non-blocking RPC (paper Fig 4 pipelining): fire the request and
        return its msg_id immediately. The reply, when it arrives, is put on
        ``sink`` — one queue may serve many outstanding requests, which is
        exactly the client's ACK ledger. The caller owns deadline tracking;
        abandon an id with ``cancel_async`` so a late reply falls through to
        the regular inbox instead of a stale waiter."""
        payload = telemetry.trace_inject(payload)
        self._m_msgs.inc(label=kind)
        self._m_src.inc(label=src_ep.name)
        if sink is None:
            sink = queue.Queue()
        msg_id = next(self._ids)
        with src_ep._lock:
            src_ep._pending[msg_id] = sink
        with self._lock:
            ep = self._endpoints.get(dst)
            dead = dst in self._dropped or src_ep.name in self._dropped
            self.bytes_sent[src_ep.name] = \
                self.bytes_sent.get(src_ep.name, 0) + self._size_of(payload)
        if ep is not None and not dead:
            ep.deliver(Message(kind, src_ep.name, dst, payload, msg_id))
        return msg_id

    def cancel_async(self, src_ep: Endpoint, msg_id: int):
        """Stop routing the reply for an abandoned async request."""
        with src_ep._lock:
            src_ep._pending.pop(msg_id, None)

    def request(self, src_ep: Endpoint, dst: str, kind: str,
                payload: Any = None, timeout: float = 2.0) -> Optional[Message]:
        """Blocking RPC: send and wait for the reply (None on timeout)."""
        payload = telemetry.trace_inject(payload)
        self._m_msgs.inc(label=kind)
        self._m_src.inc(label=src_ep.name)
        waiter: "queue.Queue[Message]" = queue.Queue()
        msg_id = next(self._ids)
        with src_ep._lock:
            src_ep._pending[msg_id] = waiter
        with self._lock:
            ep = self._endpoints.get(dst)
            dead = dst in self._dropped or src_ep.name in self._dropped
            self.bytes_sent[src_ep.name] = \
                self.bytes_sent.get(src_ep.name, 0) + self._size_of(payload)
        if ep is not None and not dead:
            ep.deliver(Message(kind, src_ep.name, dst, payload, msg_id))
        try:
            return waiter.get(timeout=timeout)
        except queue.Empty:
            return None
        finally:
            with src_ep._lock:
                src_ep._pending.pop(msg_id, None)

    def reply(self, src: str, msg: Message, kind: str, payload: Any = None):
        self.send(src, msg.src, kind, payload, reply_to=msg.msg_id)
