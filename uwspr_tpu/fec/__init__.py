"""FEC subsystem: batched Fano sequential decoding, three interchangeable
backends with identical (bit-exact) semantics:

- ``native``  — multithreaded C++ host decoder (ctypes), the default for
  host-side pipelines; per-lane early exit, no lockstep cost.
- ``cuda``    — (device engine only, fec/fano_cuda.py) one GPU thread per
  lane running the lane code of the native backend (native/fano_lane.h).
- ``jax``     — batched lockstep device decoder (lax.while_loop), keeps the
  whole pipeline on-device.
- ``ref``     — pure-Python oracle used by the test suite.
"""

from __future__ import annotations

import warnings

import numpy as np

from uwspr_tpu.protocol.constants import FANO_METTAB, N_CODED_BITS

# set after the first failed attempt to build/load the native library so the
# (possibly slow) compiler invocation isn't retried on every call
_native_unavailable: str | None = None


def fano_decode_batch(symbols: np.ndarray, mettab: np.ndarray = FANO_METTAB,
                      active: np.ndarray | None = None, *, backend: str = "native",
                      delta: int = 60, maxcycles: int = 10000,
                      nbits: int = N_CODED_BITS):
    """Decode (L, 2*nbits) soft symbols.

    Returns (success (L,), data (L, nbits//8), metric, cycles, maxnp).
    """
    symbols = np.asarray(symbols, dtype=np.uint8).reshape(-1, 2 * nbits)
    L = symbols.shape[0]
    if active is None:
        active_np = np.ones(L, dtype=bool)
    else:
        active_np = np.asarray(active, dtype=bool)

    if backend == "jax":
        from uwspr_tpu.fec.fano_jax import fano_decode_batch as _jax
        return _jax(symbols, mettab, active_np, delta=delta,
                    maxcycles=maxcycles, nbits=nbits)

    if backend == "native":
        # graceful degradation: a host without g++ (or a failed build/load)
        # falls back to the pure-Python reference backend instead of
        # crashing the default pipeline
        global _native_unavailable
        if _native_unavailable is None:
            try:
                import subprocess

                from uwspr_tpu.fec.native import fano_decode_batch_native
                idx = np.flatnonzero(active_np)
                success = np.zeros(L, dtype=bool)
                data = np.zeros((L, nbits >> 3), dtype=np.uint8)
                metric = np.zeros(L, dtype=np.int32)
                cycles = np.zeros(L, dtype=np.uint32)
                maxnp = np.zeros(L, dtype=np.uint32)
                if len(idx):
                    s, d, m, c, n = fano_decode_batch_native(
                        symbols[idx], mettab, delta=delta,
                        maxcycles=maxcycles, nbits=nbits)
                    success[idx], data[idx] = s, d
                    metric[idx], cycles[idx], maxnp[idx] = m, c, n
                return success, data, metric, cycles, maxnp
            except (ImportError, OSError,
                    subprocess.CalledProcessError) as e:
                _native_unavailable = str(e)
                warnings.warn(
                    f"native fano backend unavailable ({e}); "
                    "falling back to the pure-Python backend",
                    RuntimeWarning, stacklevel=2)
        backend = "ref"

    if backend == "ref":
        from uwspr_tpu.fec.fano_ref import fano_decode
        success = np.zeros(L, dtype=bool)
        data = np.zeros((L, nbits >> 3), dtype=np.uint8)
        metric = np.zeros(L, dtype=np.int32)
        cycles = np.zeros(L, dtype=np.uint32)
        maxnp = np.zeros(L, dtype=np.uint32)
        for i in range(L):
            if not active_np[i]:
                continue
            r = fano_decode(symbols[i], mettab, delta=delta,
                            maxcycles=maxcycles, nbits=nbits)
            success[i], data[i] = r.success, r.data
            metric[i], cycles[i], maxnp[i] = r.metric, r.cycles, r.maxnp
        return success, data, metric, cycles, maxnp

    raise ValueError(f"unknown fano backend {backend!r}")


__all__ = ["fano_decode_batch"]
