"""Build the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/<name>-<hash>.so`` (the hash covers the source text, every
shared header ``csrc/*.cuh`` and the flags, so an edited source or header
never reuses a stale library).  The sources
expose a plain C interface, so nothing includes PyTorch's headers and a
build takes seconds.  :func:`build_all` starts one ``nvcc`` per source at
once; :func:`load` builds on first use and returns the ``ctypes.CDLL``.

A failed build raises :class:`KernelBuildError` carrying nvcc's stderr.
Nothing here falls back to a plain PyTorch version: a CUDA tensor whose
kernel does not build is an error.
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

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas's per-kernel report (registers, shared memory, spills) of the
#: last build of each source, for the chip smoke's log
ptxas_info: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc refused a source; the message holds its stderr."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "build only where the CUDA toolkit is installed")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def sources():
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built, all nvcc processes at once.
    Returns name -> library path; raises KernelBuildError on any
    failure (after every process has ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    out = {}
    for name in sources():
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        ptxas_info[name] = stderr
        os.replace(tmp, target)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building every source
    on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as a pointer value (the
    raw accessor: ``torch.cuda.current_stream`` builds a Stream object
    under a device switch, microseconds on every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
