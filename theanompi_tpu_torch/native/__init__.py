"""The native host augment: crop, reflect pad, flip and normalize in one
C++ pass, bound with ctypes.

Counterpart of ``theanompi_tpu/native``.  ``augment.cpp`` fuses the
whole per-image transform of the host data path (``data/utils.py``)
into one pass over each crop window, with numpy's f32 operation order,
so a batch is bitwise equal to the numpy path's; a pthread fan-out
splits the batch across ``n_threads``.

The library is compiled with ``g++`` at first use into ``build/native/``
at the repository root, named by a digest of the source and the flags
(as ``ops/_kernels.py`` names the CUDA libraries), so an edited source
is rebuilt and a stale library is never loaded; nothing is built next
to the source.

Where no ``g++`` is found, :func:`native_available` is false and the
callers take the numpy path, as the JAX package does.  Where ``g++`` is
found and the build or the load fails, :class:`NativeBuildError` is
raised: the JAX package falls back then too, the port does not hide a
broken build.  :data:`ENABLED` (JAX: ``THEANOMPI_TPU_NATIVE=0``) turns
the native path off.  :data:`CALLS` counts the batches the native pass
carried, so a run can show that it was used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
ABI_VERSION = 2

#: False: every caller takes the numpy path
ENABLED = True


class NativeBuildError(RuntimeError):
    """``g++`` was found but the library did not build or load."""


class _Calls:
    """A thread-safe count of native calls."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


#: native ``crop_flip_normalize`` calls that returned a batch
CALLS = _Calls()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"augment-{digest[:16]}.so"


def _build(gxx: str) -> Path:
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    p = subprocess.run([gxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise NativeBuildError(
            f"g++ exit {p.returncode} building {SOURCE}:\n{p.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    return path


def _load() -> ctypes.CDLL | None:
    """The bound library; None where it is off or no ``g++`` exists.
    A failure is raised every time it is asked for, not cached away."""
    global _lib, _tried
    if not ENABLED:
        return None
    with _lock:
        if _tried:
            return _lib
        gxx = shutil.which("g++")
        if gxx is None:
            _tried = True
            return None
        try:
            lib = ctypes.CDLL(str(_build(gxx)))
        except OSError as e:
            raise NativeBuildError(f"cannot load the native augment: {e}")
        lib.tm_native_abi_version.restype = ctypes.c_int
        if lib.tm_native_abi_version() != ABI_VERSION:
            raise NativeBuildError(
                f"native augment ABI {lib.tm_native_abi_version()}, "
                f"expected {ABI_VERSION}")
        lib.tm_crop_flip_normalize.restype = None
        lib.tm_crop_flip_normalize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_int,
        ]
        _lib, _tried = lib, True
        return lib


def native_available() -> bool:
    """True when the native pass is on and built (building it now if
    needed); false only where it is off or no ``g++`` is found."""
    return _load() is not None


def crop_flip_normalize(
    images: np.ndarray,
    ys: np.ndarray,
    xs: np.ndarray,
    flips: np.ndarray,
    crop_h: int,
    crop_w: int,
    mean: np.ndarray,
    std: np.ndarray,
    divisor: float = 255.0,
    pad: int = 0,
    n_threads: int | None = None,
) -> np.ndarray:
    """Fused native crop+flip+normalize: out = ((px/divisor)-mean)/std
    with numpy's exact f32 op order (bitwise equal to the numpy path).
    ``images`` uint8 NHWC; ``ys``/``xs`` int64 crop origins in padded
    coords; ``flips`` uint8; ``mean``/``std`` float32 per channel.
    Raises RuntimeError if the native library is unavailable — call
    ``native_available()`` first."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native augment library unavailable")
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(
            f"expected uint8 NHWC images, got {images.dtype} "
            f"ndim={images.ndim}")
    n, h, w, c = images.shape
    ys = np.ascontiguousarray(ys, np.int64)
    xs = np.ascontiguousarray(xs, np.int64)
    flips = np.ascontiguousarray(flips, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean/std must have shape ({c},), got "
                         f"{mean.shape}/{std.shape}")
    if ys.shape != (n,) or xs.shape != (n,) or flips.shape != (n,):
        raise ValueError("ys/xs/flips must be per-image vectors")
    if (n and (ys.min() < 0 or xs.min() < 0
               or ys.max() > h + 2 * pad - crop_h
               or xs.max() > w + 2 * pad - crop_w)):
        raise ValueError(
            f"crop origins out of range for {h}x{w}+pad {pad} "
            f"crop {crop_h}x{crop_w}")
    out = np.empty((n, crop_h, crop_w, c), np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.tm_crop_flip_normalize(
        images.ctypes.data, n, h, w, c, pad,
        ys.ctypes.data, xs.ctypes.data, flips.ctypes.data,
        crop_h, crop_w, mean.ctypes.data, std.ctypes.data,
        ctypes.c_float(divisor), out.ctypes.data, n_threads)
    CALLS.add()
    return out
