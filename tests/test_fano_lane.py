"""The Fano lane algorithm the GPU kernel runs, tested on the CPU.

``native/fano_lane.h`` holds one lane of the sequential search; the host
backend (``native/fano_native.cc``) and the CUDA kernel
(``native/fano_cuda.cu``) both run it. These tests hold the host build of
that code to the Python oracle bit for bit, and to the lockstep
``lax.while_loop`` path, in the regimes that exercise every branch of the
search: clean decodes (forward-only), noisy decodes (deep backtracking),
hopeless lanes (full-budget timeout), tiny budgets (the timeout quirk),
and inactive lanes. The CUDA wrapper's shapes and launch geometry are
checked without a card; tests/test_gpu.py runs the kernel itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uwspr_tpu.fec.fano_ref import fano_decode
from uwspr_tpu.protocol.constants import FANO_METTAB
from uwspr_tpu.protocol.fec_encode import encode_bits


def _lanes(rng, n, sigma, scale=50.0):
    """n soft-symbol lanes: encoded random payloads + gaussian noise.
    sigma ~ scale puts lanes near the decode threshold (deep
    backtracking); sigma >> scale makes them hopeless (timeouts)."""
    lanes = []
    for _ in range(n):
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        soft = (np.where(coded == 1, 1.0, -1.0) * scale
                + rng.normal(0, sigma, 162) + 128)
        lanes.append(np.clip(soft, 0, 255).astype(np.uint8))
    return np.stack(lanes)


def _native(symbols, active=None, **kw):
    """The host build of fano_lane.h (no fallback to another backend)."""
    from uwspr_tpu.fec.native import fano_decode_batch_native
    symbols = np.asarray(symbols)
    act = np.ones(len(symbols), bool) if active is None else active
    out = fano_decode_batch_native(symbols[act], FANO_METTAB, **kw)
    full = [np.zeros((len(symbols),) + o.shape[1:], o.dtype) for o in out]
    for f, o in zip(full, out):
        f[act] = o
    return full


def _assert_matches_oracle(symbols, active=None, *, delta=60,
                           maxcycles=10000):
    succ, data, metric, cycles, maxnp = _native(symbols, active,
                                                delta=delta,
                                                maxcycles=maxcycles)
    for i in range(len(symbols)):
        if active is not None and not active[i]:
            assert not succ[i]
            continue
        r = fano_decode(symbols[i], FANO_METTAB, delta=delta,
                        maxcycles=maxcycles)
        assert succ[i] == r.success, f"lane {i} success"
        assert metric[i] == r.metric, f"lane {i} metric"
        assert cycles[i] == r.cycles, f"lane {i} cycles"
        assert maxnp[i] == r.maxnp, f"lane {i} maxnp"
        np.testing.assert_array_equal(data[i], r.data, f"lane {i} data")


def test_clean_decodes():
    rng = np.random.default_rng(0)
    _assert_matches_oracle(_lanes(rng, 6, sigma=10.0))


def test_noisy_backtracking():
    rng = np.random.default_rng(1)
    _assert_matches_oracle(_lanes(rng, 6, sigma=48.0))


def test_timeout_lanes():
    # pure noise: every lane exhausts the (small) budget; cycle counts and
    # the finish-on-last-cycle quirk must match the oracle exactly
    rng = np.random.default_rng(2)
    symbols = rng.integers(0, 256, size=(4, 162)).astype(np.uint8)
    _assert_matches_oracle(symbols, maxcycles=40)


def test_tiny_budget_mixed():
    rng = np.random.default_rng(3)
    lanes = np.concatenate([
        _lanes(rng, 3, sigma=45.0),
        rng.integers(0, 256, size=(3, 162)).astype(np.uint8),
    ])
    _assert_matches_oracle(lanes, maxcycles=25)


def test_inactive_lanes():
    rng = np.random.default_rng(4)
    lanes = _lanes(rng, 5, sigma=25.0)
    active = np.array([True, False, True, False, True])
    _assert_matches_oracle(lanes, active)


def test_matches_jax_backend_batch():
    """The lane code and the lax.while_loop path agree on every active
    lane of a mixed batch (both already oracle-exact)."""
    from uwspr_tpu.fec.fano_jax import fano_decode_batch_jax as jax_batch

    rng = np.random.default_rng(5)
    lanes = np.concatenate([
        _lanes(rng, 4, sigma=20.0),
        _lanes(rng, 4, sigma=50.0),
        rng.integers(0, 256, size=(2, 162)).astype(np.uint8),
    ])
    active = np.ones(10, bool)
    active[7] = False
    a = _native(lanes, active, maxcycles=120)
    b = jax_batch(jnp.asarray(lanes, jnp.int32), jnp.asarray(FANO_METTAB),
                  jnp.asarray(active), maxcycles=120)
    for got, key in zip(a, ("success", "data", "metric", "cycles",
                            "maxnp")):
        np.testing.assert_array_equal(
            got[active], np.asarray(b[key])[active].astype(got.dtype),
            err_msg=key)


@pytest.mark.parametrize("L", [1, 33, 300])
def test_cuda_wrapper_shapes(L):
    """The FFI call's result types for lane counts on and off the
    kernel's 128-thread block (the kernel masks the ragged last block)."""
    from uwspr_tpu.fec.fano_cuda import _ffi_fano
    f = functools.partial(_ffi_fano, nbits=81, delta=60, maxcycles=10000)
    out = jax.eval_shape(f, jax.ShapeDtypeStruct((L, 162), jnp.int32),
                         jax.ShapeDtypeStruct((2, 256), jnp.int32),
                         jax.ShapeDtypeStruct((L,), jnp.bool_))
    assert out["data"].shape == (L, 10) and out["data"].dtype == jnp.uint8
    assert out["success"].shape == (L,) and out["success"].dtype == bool
    for k in ("metric", "cycles", "maxnp"):
        assert out[k].shape == (L,) and out[k].dtype == jnp.int32


def test_cuda_build_targets_hopper():
    import pathlib

    from uwspr_tpu.fec.fano_cuda import nvcc_command
    cmd = nvcc_command(pathlib.Path("k.cu"), pathlib.Path("k.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd
    assert cmd[-1] == "k.cu" and cmd[cmd.index("-o") + 1] == "k.so"
