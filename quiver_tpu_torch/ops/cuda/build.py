"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/quiver_tpu_torch/lib<name>-<hash>.so`` beside the package (or into
the persistent cache ``recovery.registry`` may name), then loaded with
``ctypes``; each library loaded counts as a build of the registry's
``kernel`` subsystem.  The hash covers the source and every header it
includes from ``csrc`` (``#include "..."``), so an edited kernel or shared
header is never served from a stale library.  Builds happen at first use;
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all.  Importing this module needs no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` calls one on the tensor's device and current stream and
raises when it is not 0.  A failed build, load or launch raises
:class:`KernelError` (an ``OSError`` where ``nvcc`` cannot be started):
serving answers it as a fault of the kernel, never as a fault of its lane
(no breaker counts it, no failover hides it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from ...recovery.registry import library_dir, library_found, program_cache

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KernelError",
           "KernelArgumentError", "build_all",
           "load_libraries", "load", "check", "launch"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "quiver_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # the sampling hop must reproduce fp32 products and quotients exactly:
    # no fused multiply-add contraction, IEEE division
    "-fmad=false", "-prec-div=true", "-Xptxas", "-v",
)

_lock = threading.Lock()
# loaded kernel libraries, accounted under the registry's "kernel"
# subsystem: a library loaded after seal() is a post-seal build
_libs = program_cache("kernel")
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


class KernelError(RuntimeError):
    """A kernel of the port failed to build, load or launch."""


class KernelArgumentError(KernelError, ValueError):
    """A kernel's wrapper refused its arguments (dtype, shape, device or a
    size the kernel cannot index): a fault of the caller's program."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    each once, in the order first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return library_dir(BUILD_DIR) / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if library_found(out):
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return proc, log, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, _, tmp, out = job
    rc = proc.wait()
    if rc != 0:
        raise KernelError(
            f"nvcc failed on {name}.cu (rc {rc}):\n"
            + out.with_suffix(".log").read_text())
    os.replace(tmp, out)


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile every named kernel that is not built yet, in parallel."""
    with _lock:
        jobs = []
        try:
            for n in names:
                jobs.append((n, _start(n)))
            for n, job in jobs:
                _finish(n, job)
        finally:
            # a failed build stops the others: no nvcc outlives the call
            for _, job in jobs:
                if job is None:
                    continue
                proc, log = job[0], job[1]
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
    return [_lib_path(n) for n in names]


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (register and
    shared-memory use per kernel, from ``-Xptxas -v``)."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load_libraries(names: Sequence[str]) -> None:
    """Build (in parallel) and load every named kernel library that is not
    loaded yet; raises :class:`KernelError` on the first that fails."""
    missing = [n for n in names if n not in _libs]
    for name, path in zip(missing, build_all(missing)):
        try:
            loaded = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load kernel library {path}: {e}") \
                from e
        with _lock:
            _libs.setdefault(name, loaded)


def load(name: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``fn`` of kernel library ``name``, built at first
    use, with its argument types set and an ``int`` result.  Resolved once:
    later calls return the same function object."""
    f = _fns.get((name, fn))
    if f is not None:
        return f
    if name not in _libs:
        load_libraries([name])
    f = getattr(_libs[name], fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    with _lock:
        return _fns.setdefault((name, fn), f)


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def launch(fn: ctypes._CFuncPtr, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream, made the
    current device only when it is not (the context costs host time on
    every call); raises when the launch returned an error.  The stream's
    handle is read raw: a ``torch.cuda.Stream`` object costs the host
    about 8 us a launch on the H100's host, the raw read under 1."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    check(rc, f"{fn.__name__} launch")
