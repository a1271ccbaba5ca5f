# The paper's primary contribution: a burst buffer system with consistent-
# hashing placement (Ketama/ISO), a Chord-style server ring with
# stabilization, chain replication with pipelined ACKs, two-phase I/O
# flushing to the PFS, hybrid DRAM/SSD log-structured storage, and
# restart-from-buffer support. See DESIGN.md for the TPU/JAX adaptation.
from repro_torch.core.system import BBConfig, BurstBufferSystem  # noqa: F401
from repro_torch.core.client import BBClient                     # noqa: F401
from repro_torch.core.drain import DrainConfig, DrainEngine      # noqa: F401
from repro_torch.core.filesystem import (BBError, BBFile,        # noqa: F401
                                   BBFileSystem, BBFuture, BBWriteError)
from repro_torch.core.server import BBServer                     # noqa: F401
from repro_torch.core.manager import BBManager                   # noqa: F401
from repro_torch.core.qos import (BandwidthArbiter,              # noqa: F401
                            CongestionWindows, LaneQueue, QoSConfig,
                            TrafficClassifier)
from repro_torch.core.staging import ReadAhead, StageConfig      # noqa: F401
from repro_torch.core.transport import Transport                 # noqa: F401
