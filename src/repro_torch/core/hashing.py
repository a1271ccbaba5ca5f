"""Data placement: Ketama consistent hashing and ISO (isolated) placement.

The paper (§V) implements both and finds ISO — each client's traffic pinned
to a single server — scales best for burst-buffer ingestion because it
localizes traffic per server (no cross-server interference). Ketama spreads
each client's key-value pairs over all servers, balancing capacity at the
cost of fan-out. Rendezvous (HRW) hashing is included as a beyond-paper
third option (better minimal-remap behaviour without virtual-node tables).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import List, Sequence


def _md5_u32(data: str) -> int:
    return int.from_bytes(hashlib.md5(data.encode()).digest()[:4], "little")


class KetamaRing:
    """libketama-style ring: 160 virtual points per server, MD5 hash space."""

    def __init__(self, servers: Sequence[str], vnodes: int = 160):
        self.vnodes = vnodes
        self._points: List[int] = []
        self._owners: List[str] = []
        self._servers: List[str] = []
        for s in servers:
            self.add_server(s)

    def add_server(self, server: str):
        if server in self._servers:
            return
        self._servers.append(server)
        for v in range(self.vnodes):
            h = _md5_u32(f"{server}#{v}")
            i = bisect.bisect(self._points, h)
            self._points.insert(i, h)
            self._owners.insert(i, server)

    def remove_server(self, server: str):
        if server not in self._servers:
            return
        self._servers.remove(server)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != server]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    @property
    def servers(self) -> List[str]:
        return list(self._servers)

    def lookup(self, key: str) -> str:
        if not self._points:
            raise RuntimeError("empty ring")
        h = _md5_u32(key)
        i = bisect.bisect(self._points, h)
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def successors(self, key: str, n: int) -> List[str]:
        """n distinct servers following the key's point (replica set)."""
        if not self._points:
            raise RuntimeError("empty ring")
        h = _md5_u32(key)
        i = bisect.bisect(self._points, h)
        out: List[str] = []
        for j in range(len(self._points)):
            owner = self._owners[(i + j) % len(self._points)]
            if owner not in out:
                out.append(owner)
                if len(out) == n:
                    break
        return out


class IsoPlacement:
    """Isolated placement: client c -> servers[c mod n] for ALL its keys."""

    def __init__(self, servers: Sequence[str]):
        self._servers = list(servers)

    @property
    def servers(self) -> List[str]:
        return list(self._servers)

    def add_server(self, server: str):
        if server not in self._servers:
            self._servers.append(server)

    def remove_server(self, server: str):
        if server in self._servers:
            self._servers.remove(server)

    def lookup_for_client(self, client_index: int) -> str:
        return self._servers[client_index % len(self._servers)]


class RendezvousHash:
    """Highest-random-weight hashing (beyond-paper placement option)."""

    def __init__(self, servers: Sequence[str]):
        self._servers = list(servers)

    @property
    def servers(self) -> List[str]:
        return list(self._servers)

    def add_server(self, server: str):
        if server not in self._servers:
            self._servers.append(server)

    def remove_server(self, server: str):
        if server in self._servers:
            self._servers.remove(server)

    def lookup(self, key: str) -> str:
        return max(self._servers, key=lambda s: _md5_u32(f"{s}|{key}"))

    def successors(self, key: str, n: int) -> List[str]:
        ranked = sorted(self._servers, key=lambda s: _md5_u32(f"{s}|{key}"),
                        reverse=True)
        return ranked[:n]
