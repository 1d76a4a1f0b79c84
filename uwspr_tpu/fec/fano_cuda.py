"""Batched Fano sequential decoder on the GPU through the XLA foreign
function interface.

Why this exists: the XLA ``lax.while_loop`` formulation (fec/fano_jax.py)
runs its masked body as separate kernels and copies the loop predicate
back to the host every iteration, so a deep-SNR lane that exhausts the
reference's full 10,000-cycle/bit budget
(lib/sync_and_demodulate_impl.cc:329) turns one decode into tens of
thousands of dispatches, and every lane of the batch steps in lockstep
with the slowest. Here one CUDA kernel launch decodes the whole batch:
one thread per lane runs the classic sequential search of
``native/fano_lane.h`` — the same lane code the host backend
(``native/fano_native.cc``) runs, so the CPU tests of the host backend
test the kernel's arithmetic — and each lane stops on its own.

The library is compiled from ``native/fano_cuda.cu`` with nvcc for sm_90a
at first use, next to the source (gitignored), and registered as the
FFI target ``uwspr_fano``. There is no interpret mode: on the CPU the
wrapper's shapes are testable with ``jax.eval_shape`` on ``_ffi_fano``.

Semantics are bit-exact with fec.fano_ref / fec.fano_jax / the native
host backend (identical success/data/metric/cycles/maxnp), including the
reference's cycle accounting and finish-on-last-cycle-counts-as-timeout
quirk (lib/Fano.cc:110-252).
"""

from __future__ import annotations

import functools
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from uwspr_tpu.protocol.constants import N_CODED_BITS
from uwspr_tpu.utils.native_build import load_native

_DIR = pathlib.Path(__file__).resolve().parent / "native"
_SRC = _DIR / "fano_cuda.cu"
_LIB = _DIR / "libuwspr_fano_cuda.so"
TARGET = "uwspr_fano"


def nvcc_command(src: pathlib.Path, lib: pathlib.Path) -> list[str]:
    """The nvcc invocation that builds the FFI library for Hopper."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", str(lib), str(src)]


def _nvcc_build(src: pathlib.Path, lib: pathlib.Path) -> None:
    p = subprocess.run(nvcc_command(src, lib), capture_output=True,
                       text=True)
    if p.returncode:
        raise OSError(f"nvcc failed ({p.returncode}):\n{p.stderr[-4000:]}")


@functools.cache
def register() -> None:
    """Build the library if stale and register the FFI target (once)."""
    lib = load_native(_SRC, _LIB, lambda _lib: None, build=_nvcc_build)
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.UwsprFano),
                                platform="CUDA")


def _ffi_fano(symbols, mettab, active, *, nbits, delta, maxcycles):
    L = symbols.shape[0]
    i32 = jnp.int32
    data, succ, metric, cycles, maxnp = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((L, nbits >> 3), jnp.uint8),)
        + (jax.ShapeDtypeStruct((L,), i32),) * 4,
    )(symbols.astype(i32), mettab.astype(i32), active.astype(i32),
      delta=np.int32(delta), maxcycles=np.int32(maxcycles),
      nbits=np.int32(nbits))
    return {"success": succ != 0, "data": data, "metric": metric,
            "cycles": cycles, "maxnp": maxnp}


@functools.partial(jax.jit, static_argnames=("nbits", "delta", "maxcycles"))
def fano_decode_batch_cuda(symbols: jnp.ndarray, mettab: jnp.ndarray,
                           active: jnp.ndarray | None = None,
                           *, nbits: int = N_CODED_BITS, delta: int = 60,
                           maxcycles: int = 10000):
    """Drop-in replacement for fano_decode_batch_jax (same result dict);
    needs a GPU and nvcc."""
    register()
    if active is None:
        active = jnp.ones(symbols.shape[0], bool)
    return _ffi_fano(symbols, mettab, active, nbits=nbits, delta=delta,
                     maxcycles=maxcycles)


__all__ = ["fano_decode_batch_cuda", "register", "nvcc_command", "TARGET"]
