"""BurstBufferSystem: wires manager + servers + clients over one transport.

This is the deployable composition root. On a real pod each server would be
one daemon per host and the transport a network fabric; here they are
threads, but all interaction is message-passing so the topology, protocols
and failure behaviour are identical.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import telemetry
from repro_torch.core.client import BBClient
from repro_torch.core.drain import DrainConfig
from repro_torch.core.filesystem import BBFileSystem
from repro_torch.core.health import HealthConfig
from repro_torch.core.manager import BBManager
from repro_torch.core.qos import QoSConfig
from repro_torch.core.server import BBServer
from repro_torch.core.staging import StageConfig
from repro_torch.core.transport import Transport


@dataclass
class BBConfig:
    num_servers: int = 4
    num_clients: int = 4
    replication: int = 2
    placement: str = "iso"              # iso | ketama | rendezvous
    dram_capacity: int = 64 << 20
    ssd_dir: Optional[str] = None       # None -> tmpdir
    ssd_capacity: Optional[int] = None  # None -> 4x dram (soft, for drain)
    segment_bytes: Optional[int] = None  # None -> LogStore.SEGMENT_BYTES
    pfs_dir: Optional[str] = None       # None -> tmpdir
    stabilize_interval: float = 0.25
    # write pipeline (paper Fig 4) / client-side write coalescing
    batch_bytes: int = 1 << 20          # flush a coalesced batch at this size
    coalesce_threshold: int = 64 << 10  # writes below this auto-coalesce
    chunk_bytes: int = 4 << 20          # BBFile striping unit
    # read path: one knob for every read-side RPC deadline, and
    # the thread fan-out width for parallel manifest/range fetches
    read_timeout: float = 1.0
    # control plane: one knob for every manager/control RPC
    # deadline (hellos, fs namespace ops, stage requests, failure probes)
    control_timeout: float = 1.0
    read_fanout: int = 4
    # cadence knobs: every run-loop poll / retry / scan interval
    # in core routes through here — bbcheck rule 5 rejects new literals
    startup_timeout: float = 10.0        # wait_ring bound at start()
    manager_poll_interval: float = 0.05  # manager run-loop recv timeout
    server_poll_interval: float = 0.02   # server run-loop idle recv timeout
    flush_poll_interval: float = 0.01    # manager wait_flush spin
    drain_serialize_poll: float = 0.005  # begin_flush wait-for-drain spin
    ack_poll_interval: float = 0.02      # client ACK-ledger event wait
    ack_scan_interval: float = 0.05      # client deadline-scan cadence
    client_drain_poll: float = 0.003     # client drain() spin
    connect_retry_interval: float = 0.05  # client connect() hello retry
    pump_join_timeout: float = 1.0       # client close() pump-thread join
    # autonomous drain engine: watermark-driven background flush
    drain: DrainConfig = field(default_factory=DrainConfig)
    # stage-in engine: PFS -> BB bulk re-ingest + read-ahead
    stage: StageConfig = field(default_factory=StageConfig)
    # QoS engine: traffic classification, priority lanes,
    # congestion windows, write-through bypass, unified background arbiter
    qos: QoSConfig = field(default_factory=QoSConfig)
    # health engine: SLO rules + stall watchdogs + critical-path
    # attribution, evaluated on the manager run loop every
    # ``health.interval_s`` (only when telemetry is enabled)
    health: HealthConfig = field(default_factory=HealthConfig)


class BurstBufferSystem:
    def __init__(self, cfg: BBConfig):
        self.cfg = cfg
        self.transport = Transport()
        self._tmp = tempfile.mkdtemp(prefix="bbsys_")
        self.ssd_dir = cfg.ssd_dir or os.path.join(self._tmp, "ssd")
        self.pfs_dir = cfg.pfs_dir or os.path.join(self._tmp, "pfs")
        os.makedirs(self.ssd_dir, exist_ok=True)
        os.makedirs(self.pfs_dir, exist_ok=True)

        self.manager = BBManager(self.transport, cfg.num_servers,
                                 drain_epoch_timeout=cfg.drain.epoch_timeout_s,
                                 poll_interval=cfg.manager_poll_interval,
                                 flush_poll_interval=cfg.flush_poll_interval,
                                 drain_serialize_poll=cfg.drain_serialize_poll,
                                 journal_path=os.path.join(
                                     self.ssd_dir, "manager.journal"),
                                 health_cfg=cfg.health)
        self.servers: Dict[str, BBServer] = {}
        for i in range(cfg.num_servers):
            name = f"server/{i}"
            self.servers[name] = self._make_server(name)
        self.clients: List[BBClient] = [
            BBClient(f"client/{i}", self.transport, client_index=i,
                     placement=cfg.placement, replication=cfg.replication,
                     read_timeout=cfg.read_timeout,
                     control_timeout=cfg.control_timeout,
                     read_fanout=cfg.read_fanout,
                     batch_bytes=cfg.batch_bytes,
                     coalesce_threshold=cfg.coalesce_threshold,
                     ack_poll_interval=cfg.ack_poll_interval,
                     ack_scan_interval=cfg.ack_scan_interval,
                     drain_poll_interval=cfg.client_drain_poll,
                     connect_retry_interval=cfg.connect_retry_interval,
                     pump_join_timeout=cfg.pump_join_timeout,
                     qos_cfg=cfg.qos)
            for i in range(cfg.num_clients)]
        self._fs: Optional[BBFileSystem] = None

    def _make_server(self, name: str) -> BBServer:
        """One construction path for initial, joining AND crash-restarted
        servers — a restarted server MUST come up with the same ssd_dir so
        its LogStore recovers the previous incarnation's log."""
        cfg = self.cfg
        return BBServer(name, self.transport,
                        dram_capacity=cfg.dram_capacity,
                        ssd_dir=self.ssd_dir,
                        ssd_capacity=cfg.ssd_capacity,
                        segment_bytes=cfg.segment_bytes,
                        pfs_dir=self.pfs_dir,
                        replication=cfg.replication,
                        stabilize_interval=cfg.stabilize_interval,
                        poll_interval=cfg.server_poll_interval,
                        drain=cfg.drain, stage=cfg.stage, qos_cfg=cfg.qos)

    # ---------------------------------------------------------------- launch
    def start(self):
        self.manager.start()
        for s in self.servers.values():
            s.start()
            self.transport.send(s.tname, "manager", "register", {})
        assert self.manager.wait_ring(self.cfg.startup_timeout), \
            "ring init failed"
        for c in self.clients:
            c.connect()
        return self

    def stop(self):
        for c in self.clients:
            c.close()
        for s in self.servers.values():
            s.stop()
        self.manager.stop()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------------- actions
    def fs(self) -> BBFileSystem:
        """The file-session facade over this system's clients (one per
        application; handles from fs().open() stripe across all clients)."""
        if self._fs is None:
            self._fs = BBFileSystem(self.clients,
                                    chunk_bytes=self.cfg.chunk_bytes,
                                    pfs_dir=self.pfs_dir,
                                    read_fanout=self.cfg.read_fanout,
                                    stage=self.cfg.stage,
                                    qos_cfg=self.cfg.qos,
                                    control_timeout=self.cfg.control_timeout)
        return self._fs

    def flush(self, epoch: int, timeout: float = 30.0) -> bool:
        self.manager.begin_flush(epoch)
        return self.manager.wait_flush(epoch, timeout)

    def evict(self, prefix: str):
        self.manager.evict(prefix)

    def pressure(self) -> dict:
        """Cluster pressure view (autonomous drain engine): per-server
        occupancy reports + drain epoch/abort/evict counters."""
        return self.manager.pressure_report()

    def kill_server(self, name: str):
        """Failure injection: stop the thread and black-hole its traffic."""
        srv = self.servers[name]
        srv.stop()
        self.transport.drop(name)

    def join_server(self, pred: Optional[str] = None) -> str:
        i = len(self.servers)
        name = f"server/{i}"
        srv = self._make_server(name)
        self.servers[name] = srv
        srv.start()
        # the joining server knows the ring via the manager's ring_update;
        # seed its view first so it can serve immediately (paper Fig 3)
        srv.ring = self.manager.alive_ring() + [name]
        srv.alive = {s: True for s in srv.ring}
        self.transport.send(name, "manager", "join_request",
                            {"server": name, "pred": pred})
        return name

    def restart_server(self, name: str, pred: Optional[str] = None) -> BBServer:
        """Crash-recovery restart: bring a killed server back over
        its surviving SSD log. The new incarnation's LogStore replays the
        log (last-gen-wins, torn tail truncated), the server rebuilds its
        chunk manifests from the recovered keys, re-registers its transport
        endpoint (un-black-holing it), and rejoins the ring through the
        existing join_request path — the manager un-marks it dead and sends
        it the authoritative ring + lookup table."""
        srv = self._make_server(name)
        self.servers[name] = srv
        srv.start()
        srv.ring = self.manager.alive_ring() + [name]
        srv.alive = {s: True for s in srv.ring}
        self.transport.send(name, "manager", "join_request",
                            {"server": name, "pred": pred})
        return srv

    def server_stats(self) -> Dict[str, dict]:
        out = {}
        probe = self.clients[0] if self.clients else None
        for name in self.servers:
            if not self.transport.alive(name):
                continue
            r = self.transport.request(
                probe.ep, name, "stats_query", {},
                timeout=self.cfg.control_timeout) if probe else None
            if r is not None:
                out[name] = r.payload
        return out

    def scrape(self) -> dict:
        """Telemetry scrape: the full in-process registry snapshot
        plus a metrics_query round-trip to every live server. The registry
        is read directly (this process owns it), so the per-server probe
        asks only for the stats payload — ``{"instruments": True}`` would
        return the same shared registry once per server.

        Dead servers are skipped via ``transport.alive()`` (the scrape
        stays bounded by ``control_timeout`` per unreachable survivor) but
        never silently: ``expected`` lists the configured membership and
        ``missing`` whoever failed to answer, so bbstat/bbtop — and CI —
        can alert on a partial scrape.
        """
        out = {"registry": telemetry.snapshot(), "servers": {},
               "expected": sorted(self.servers), "missing": []}
        probe = self.clients[0] if self.clients else None
        if probe is None:
            out["missing"] = sorted(self.servers)
            return out
        for name in self.servers:
            r = self.transport.request(
                probe.ep, name, "metrics_query", {"instruments": False},
                timeout=self.cfg.control_timeout) \
                if self.transport.alive(name) else None
            if r is not None:
                out["servers"][name] = r.payload
            else:
                out["missing"].append(name)
        out["missing"].sort()
        return out

    def health(self) -> dict:
        """Latest health-engine report via the ``health_query``
        protocol round-trip — exactly what a remote operator tool sees.
        Falls back to the manager's in-process report when there is no
        client endpoint to probe through (or the RPC times out)."""
        probe = self.clients[0] if self.clients else None
        if probe is not None:
            r = self.transport.request(
                probe.ep, "manager", "health_query", {},
                timeout=self.cfg.control_timeout)
            if r is not None and isinstance(r.payload, dict):
                report = dict(r.payload)
                report.pop(telemetry.TRACE_KEY, None)
                return report
        return self.manager.health_report()
