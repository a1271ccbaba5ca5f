"""Two-phase I/O (paper §III-B): file-domain partitioning + segment splitting.

Pure functions — the protocol driver lives in server.py. Each shared file is
logically partitioned into n contiguous domains (n = number of servers);
every server ships its buffered segments to the domain owners; owners then
issue ONE sequential write per file to the PFS, eliminating the lock
contention of interleaved writers (ROMIO-style collective buffering).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Segment:
    file: str
    offset: int
    length: int


def file_sizes(metas: Sequence[Segment]) -> Dict[str, int]:
    sizes: Dict[str, int] = {}
    for m in metas:
        sizes[m.file] = max(sizes.get(m.file, 0), m.offset + m.length)
    return sizes


def domains(size: int, servers: Sequence[str]) -> List[Tuple[str, int, int]]:
    """Partition [0, size) into len(servers) contiguous domains.
    Returns [(server, start, end)]; the remainder goes to the last domain.
    Domain boundaries are aligned to 1 MiB (the Lustre default stripe size in
    the paper's testbed) so each owner's PFS write is stripe-aligned."""
    n = len(servers)
    align = 1 << 20
    base = size // n
    base -= base % align
    out = []
    start = 0
    for i, s in enumerate(servers):
        end = size if i == n - 1 else min(size, start + base)
        out.append((s, start, end))
        start = end
    return out


def owner_of(offset: int, doms: List[Tuple[str, int, int]]) -> str:
    for s, a, b in doms:
        if a <= offset < b:
            return s
    return doms[-1][0]


def split_segment(seg: Segment, doms: List[Tuple[str, int, int]]
                  ) -> List[Tuple[str, int, int, int]]:
    """Split a segment across domain boundaries.
    Returns [(owner, file_offset, local_offset, length)] pieces."""
    pieces = []
    pos = seg.offset
    end = seg.offset + seg.length
    for s, a, b in doms:
        if b <= pos or a >= end or a == b:
            continue
        lo = max(pos, a)
        hi = min(end, b)
        pieces.append((s, lo, lo - seg.offset, hi - lo))
    return pieces


def plan_shuffle(my_segments: Sequence[Segment],
                 all_meta: Dict[str, List[Segment]],
                 servers: Sequence[str],
                 known_sizes: Optional[Dict[str, int]] = None):
    """Given this server's buffered segments and everyone's metadata, compute
    (sizes, per-file domain lists, outgoing pieces).

    ``known_sizes`` enables segment-subset planning (drain micro-epochs):
    when an epoch carries only a cold subset of a file's chunks, the subset's
    own extent may end short of the file's true size, and domains computed
    from it would disagree with the layout every earlier epoch wrote to the
    PFS. Passing the already-known global size per file (the lookup table)
    pins the domain partition to max(subset extent, known size), so owners
    agree across full flushes and partial drains alike. Every participant
    must pass the same map — the protocol driver broadcasts the known sizes
    with the epoch metadata to guarantee that."""
    merged: List[Segment] = [m for metas in all_meta.values() for m in metas]
    sizes = file_sizes(merged)
    if known_sizes:
        for f in sizes:
            if f in known_sizes:
                sizes[f] = max(sizes[f], known_sizes[f])
    doms = {f: domains(sz, servers) for f, sz in sizes.items()}
    sends = []
    for seg in my_segments:
        for owner, file_off, local_off, length in split_segment(
                seg, doms[seg.file]):
            sends.append((owner, seg, file_off, local_off, length))
    return sizes, doms, sends
