"""Build the port's CUDA sources into shared libraries, at first use.

Each ``msha_gnn_torch/csrc/<name>.cu`` becomes one library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/msha_gnn_torch/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited source
builds anew and an unchanged one is built once.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "msha_gnn_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    Returns the seconds each build took (0.0 when it was already built).
    The compiler's messages, register and shared-memory use included, are
    kept next to each library as ``.log``.  Raises with nvcc's output when
    a build fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's messages from the build of ``name`` ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
