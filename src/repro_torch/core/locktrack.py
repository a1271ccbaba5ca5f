"""Runtime lock-order tracking (the dynamic half of bbcheck rule 2).

Core modules create their locks through ``lock()``/``rlock()`` instead of
``threading.Lock()``/``threading.RLock()``. With tracking disabled (the
default) these return the plain threading primitives — zero overhead on
the hot paths. ``tests/conftest.py`` enables tracking for the whole test
suite and asserts zero recorded inversions at teardown, so every real
acquisition order the protocol exercises is checked on every CI run.

An inversion is recorded when lock B is acquired while A is held after the
opposite order (a path B -> ... -> A in the acquisition graph) was ever
observed — across all threads, whether or not the orders ever actually
deadlocked — and when two DISTINCT instances sharing one name are nested
(unordered same-class nesting: a self-deadlock candidate the name graph
cannot order). Names aggregate instances ("Endpoint._lock" is one node no
matter how many endpoints exist) because the protocol gives every instance
of a class the same role in the acquisition order; per-name edges are
exactly the invariant worth enforcing.
"""
from __future__ import annotations

import json
import sys
import threading
import traceback
from typing import Dict, List, Optional


def _call_site() -> str:
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:                               # pragma: no cover
        return "?"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class LockOrderTracker:
    """Global acquisition-order digraph + per-thread held-lock stacks."""

    def __init__(self):
        # outer name -> {inner name: "file:line" where first observed}
        self.edges: Dict[str, Dict[str, str]] = {}
        self.inversions: List[dict] = []
        self._mu = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------------- queries
    def _held(self) -> list:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = []
            self._tls.held = st
        return st

    def held_names(self) -> List[str]:
        return [name for _lk, name, _n in self._held()]

    def _path_exists(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.edges.get(n, ()))
        return False

    # ------------------------------------------------------------- events
    def on_acquired(self, lk: "TrackedLock"):
        held = self._held()
        for ent in held:
            if ent[0] is lk:        # reentrant re-acquire: no new ordering
                ent[2] += 1
                return
        if held:
            site = _call_site()
            inner = lk.name
            with self._mu:
                for _obj, outer, _n in held:
                    if outer == inner:
                        self.inversions.append({
                            "kind": "same-name-nesting", "name": inner,
                            "site": site,
                            "thread": threading.current_thread().name,
                            "stack": traceback.format_stack()})
                        continue
                    known = self.edges.setdefault(outer, {})
                    if inner in known:
                        continue
                    if self._path_exists(inner, outer):
                        self.inversions.append({
                            "kind": "order-inversion",
                            "first": f"{inner} -> {outer} "
                                     f"(seen {self.edges[inner].get(outer)})",
                            "second": f"{outer} -> {inner}", "site": site,
                            "thread": threading.current_thread().name,
                            "stack": traceback.format_stack()})
                    known[inner] = site
        held.append([lk, lk.name, 1])

    # ------------------------------------------------------------ artifact
    def dump(self, path: str) -> str:
        """Write the acquisition digraph, every recorded inversion (with
        the stack captured when it was recorded), and a snapshot of each
        live thread's current stack to a JSON artifact — enough to
        reconstruct the interleaving post-mortem without re-running."""
        frames = sys._current_frames()
        threads = {}
        for t in threading.enumerate():
            f = frames.get(t.ident)
            threads[t.name] = traceback.format_stack(f) if f is not None \
                else []
        with self._mu:
            report = {"edges": self.edges,
                      "inversions": self.inversions,
                      "threads": threads}
            with open(path, "w") as fh:
                json.dump(report, fh, indent=2, sort_keys=True)
        return path

    def on_released(self, lk: "TrackedLock"):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lk:
                held[i][2] -= 1
                if held[i][2] == 0:
                    del held[i]
                return


class TrackedLock:
    """Lock/RLock wrapper feeding a LockOrderTracker."""

    __slots__ = ("name", "_lk", "_tr")

    def __init__(self, name: str, tracker: LockOrderTracker,
                 reentrant: bool = False):
        self.name = name
        self._tr = tracker
        self._lk = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._tr.on_acquired(self)
        return ok

    def release(self):
        self._tr.on_released(self)
        self._lk.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


# ------------------------------------------------------------- module API
_tracker: Optional[LockOrderTracker] = None


def enable() -> LockOrderTracker:
    """Turn tracking on. Only locks CREATED after this call are tracked
    (the factories below capture the active tracker at construction)."""
    global _tracker
    if _tracker is None:
        _tracker = LockOrderTracker()
    return _tracker


def disable():
    global _tracker
    _tracker = None


def tracker() -> Optional[LockOrderTracker]:
    return _tracker


def lock(name: str):
    t = _tracker
    return threading.Lock() if t is None else TrackedLock(name, t)


def rlock(name: str):
    t = _tracker
    return threading.RLock() if t is None \
        else TrackedLock(name, t, reentrant=True)
