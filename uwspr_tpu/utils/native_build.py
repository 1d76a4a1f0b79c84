"""Compile-on-demand loader shared by the native (C++/ctypes) backends.

One implementation of the build-and-cache dance — g++ with an
-march=native attempt (or a caller's own build, e.g. nvcc), a .so next
to the source invalidated when the source or a header beside it is newer,
one build per process — so a fix here (compiler discovery, stale-library
races, clearer errors) reaches every backend (fec/native,
pipeline/native, the GPU Fano kernel).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _build(src: pathlib.Path, lib: pathlib.Path) -> None:
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
           str(src), "-o", str(lib)]
    # -march=native when available; harmless to drop if unsupported
    try:
        subprocess.run(cmd[:1] + ["-march=native"] + cmd[1:], check=True,
                       capture_output=True)
    except subprocess.CalledProcessError:
        subprocess.run(cmd, check=True, capture_output=True)


def load_native(src: str | pathlib.Path, lib: str | pathlib.Path,
                configure, build=_build) -> ctypes.CDLL:
    """Build (if stale) and dlopen a single-source C++ backend.

    ``configure(lib)`` sets argtypes/restypes on first load; the loaded
    handle is cached per path. ``build(src, lib)`` compiles (default:
    g++). Raises OSError/subprocess errors the caller is expected to catch
    for graceful fallback.
    """
    src = pathlib.Path(src)
    lib = pathlib.Path(lib)
    key = str(lib)
    with _lock:
        if key in _loaded:
            return _loaded[key]
        newest = max(p.stat().st_mtime
                     for p in [src, *src.parent.glob("*.h")])
        if not lib.exists() or lib.stat().st_mtime < newest:
            build(src, lib)
        handle = ctypes.CDLL(key)
        configure(handle)
        _loaded[key] = handle
        return handle


__all__ = ["load_native"]
