"""Build, bind and count the port's hand-written CUDA kernels.

Each source under ``theanompi_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface
under ``build/kernels/`` at the repository root, at first use, and bound
with ``ctypes``.  The library name carries a digest of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per missing source, all
together, and keeps each compiler's ``-Xptxas -v`` report (registers,
shared memory, spills).

A :class:`Kernel` is one C entry point with its own launch count: the
count goes up by one each time the entry point launched and returned
``cudaSuccess``, and nowhere else.  Nothing here is imported or built
when the module is imported; the CPU tests import every module and this
machine may have no ``nvcc``.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: library name -> its source under csrc/
SOURCES = {"fused_bn": "fused_bn.cu", "maxpool": "maxpool.cu",
           "lrn": "lrn.cu", "attention": "attention.cu"}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def find_nvcc() -> str | None:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build(names=None) -> dict[str, dict]:
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` per source started together.  Returns
    ``{name: {"path", "seconds", "ptxas", "cached"}}``; raises
    :class:`KernelBuildError` if ``nvcc`` is missing or fails."""
    names = list(SOURCES) if names is None else list(names)
    with _build_lock:
        return _build_locked(names)


def _build_locked(names: list[str]) -> dict[str, dict]:
    out: dict[str, dict] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "ptxas": "",
                         "cached": True}
            continue
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                f"cannot build kernel library {name!r}: nvcc not found "
                "(set CUDA_HOME or put nvcc on PATH)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.monotonic())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path),
                     "seconds": time.monotonic() - t0,
                     "ptxas": log, "cached": False}
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        with _build_lock:
            lib = _libs.setdefault(name, ctypes.CDLL(path))
    return lib


def bind_all() -> None:
    """Build the libraries of every kernel defined so far and bind each:
    done before worker threads launch kernels concurrently, so none of
    them builds or binds on the way."""
    build(sorted({k.library for k in KERNELS.values()}))
    for k in list(KERNELS.values()):
        if k._fn is None:
            k._bind()


def on_cpu(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CPU, the only case in which a wrapper
    takes its kernel's plain version."""
    return t.device.type == "cpu"


class Kernel:
    """One C entry point of a kernel library and its launch count."""

    def __init__(self, name: str, library: str, symbol: str, argtypes):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()
        KERNELS[name] = self

    def _bind(self):
        fn = getattr(load(self.library), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current PyTorch stream, which is passed
        as the entry point's last argument; raise unless it returned
        ``cudaSuccess``."""
        fn = self._fn or self._bind()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"kernel {self.name} ({self.symbol}) failed to launch: "
                f"cudaError {err}")
        with self._count_lock:
            self.launches += 1


class Counter:
    """A thread-safe event count (e.g. gradient copies a wrapper made)."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


#: every kernel the port defines, by name
KERNELS: dict[str, Kernel] = {}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0
