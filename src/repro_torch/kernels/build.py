"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled at first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``. All sources compile at once, one ``nvcc`` each.
Libraries land in ``build/kernels/`` at the repository root, named by a hash
of their source and flags, so a second process reuses them and an edited
source rebuilds. Nothing here runs at import time: the CPU tests import the
wrapper modules on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: quantize relies on IEEE division and rintf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; returns {stem: .so path}.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside each library as ``<lib>.log``. Raises with the compiler's
    output when any source fails to build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failures = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- {stem} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds on first use)."""
    with _lock:
        if stem not in _libs:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA kernels need a CUDA device; "
                                   "torch.cuda.is_available() is false")
            for name, path in build_all().items():
                _libs.setdefault(name, ctypes.CDLL(str(path)))
        return _libs[stem]


def build_logs() -> Dict[str, str]:
    """The compiler reports of the built libraries, by source stem."""
    logs = {}
    for src in sorted(CSRC.glob("*.cu")):
        log = _target(src).with_suffix(".log")
        if log.exists():
            logs[src.stem] = log.read_text()
    return logs


def local_only(what: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor: a launch takes each rank's
    local tensors (``kernels/ops.py`` maps a kernel over the shards); a
    DTensor's data pointer is not its shard's."""
    from repro_torch.launch.sharding import is_dtensor
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{what}: got a DTensor; call it through "
                        f"repro_torch.kernels.ops, which runs the kernel on "
                        f"each rank's local shards")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
