"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first CUDA use into ``<repo>/build/kernels/<name>-<sha1 of source>.so``,
so a changed source rebuilds and an unchanged one is loaded as built.
Building needs ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
``PATH``); nothing here runs at import time, so the CPU tests import the
kernel modules without a toolkit. A failed build raises with nvcc's
stderr — there is no fallback. :func:`launch` calls a bound entry on
the current stream with as little host work as a call can take."""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "nvcc_path", "build", "load", "launch",
           "source_digest"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas register/shared-memory report of each kernel built by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built on this host")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def source_digest() -> str:
    """sha1 over every kernel source and the nvcc flags: what a built
    kernel depends on in the checkout."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


@contextlib.contextmanager
def _dir_lock():
    """An exclusive ``flock`` on ``BUILD_DIR/lock``: one process builds at
    a time, the others wait (the kernel drops the lock with its holder,
    so a killed build leaves nothing to clean up)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all
    nvcc processes started together, and return the library paths. A
    process that finds a library missing takes the build directory's
    file lock and looks again, so rank processes that start together
    never write the same library: one builds, the others wait and load
    it (``spawn`` callers build in the parent first)."""
    out = {n: _target(n) for n in names}
    if all(out[n].exists() for n in names):
        return out
    nvcc = nvcc_path()
    with _dir_lock():
        todo = [n for n in names if not out[n].exists()]
        if todo:
            _compile(todo, out, nvcc)
    return out


def _compile(todo: Sequence[str], out: Dict[str, Path], nvcc: str) -> None:
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        so, se = p.communicate()
        build_logs[n] = so + se
        if p.returncode != 0:
            failed.append(f"nvcc failed on csrc/{n}.cu "
                          f"(exit {p.returncode}):\n{se}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` on the current stream of CUDA device
    ``index`` (``tensor.get_device()``), entering a device guard only when
    it is not the current device; returns the entry's error code (0 on
    success)."""
    if index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(index).cuda_stream)
    with torch.cuda.device(index):
        return fn(*args, torch.cuda.current_stream(index).cuda_stream)
