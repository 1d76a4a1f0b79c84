"""ctypes bindings for the native batched Fano decoder.

The shared library is compiled on demand with g++ (cached next to this
file); no pybind11 dependency. Falls back cleanly if no compiler exists —
callers should catch ImportError/OSError and use the Python/JAX backends.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from uwspr_tpu.utils.native_build import load_native

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "fano_native.cc"
_LIB = _DIR / "libuwspr_fano.so"


def _configure(lib: ctypes.CDLL) -> None:
    lib.uwspr_fano_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.uwspr_fano_decode_batch.restype = None
    lib.uwspr_fano_num_threads.restype = ctypes.c_int


def _load() -> ctypes.CDLL:
    return load_native(_SRC, _LIB, _configure)


def fano_decode_batch_native(symbols: np.ndarray, mettab: np.ndarray,
                             delta: int = 60, maxcycles: int = 10000,
                             nbits: int = 81):
    """Decode (n_lanes, 2*nbits) soft symbols on the host CPU.

    Returns (success (n,), data (n, nbits//8), metric, cycles, maxnp).
    """
    assert nbits <= 81, nbits           # fano_lane.h kMaxBits
    symbols = np.ascontiguousarray(symbols, dtype=np.uint8)
    if symbols.ndim == 1:
        symbols = symbols[None]
    n, width = symbols.shape
    assert width == 2 * nbits, (width, nbits)
    mettab = np.ascontiguousarray(mettab, dtype=np.int32)
    assert mettab.shape == (2, 256)
    nbytes = nbits >> 3
    data = np.zeros((n, nbytes), dtype=np.uint8)
    success = np.zeros(n, dtype=np.int32)
    metric = np.zeros(n, dtype=np.int32)
    cycles = np.zeros(n, dtype=np.uint32)
    maxnp = np.zeros(n, dtype=np.uint32)
    lib = _load()
    lib.uwspr_fano_decode_batch(
        symbols.ctypes.data, n, nbits, mettab.ctypes.data, delta, maxcycles,
        data.ctypes.data, success.ctypes.data, metric.ctypes.data,
        cycles.ctypes.data, maxnp.ctypes.data)
    return success.astype(bool), data, metric, cycles, maxnp


def num_threads() -> int:
    return _load().uwspr_fano_num_threads()


__all__ = ["fano_decode_batch_native", "num_threads"]
