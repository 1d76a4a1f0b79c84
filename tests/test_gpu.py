"""Tests that need the card: the CUDA Fano kernel against the Python
oracle, and device-vs-host spot parity of the serving engine at
W=8. They skip where JAX has no GPU (the ``gpu`` fixture); on the card run

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

chip_smoke.py runs the same checks at full size.
"""

import numpy as np
import pytest

from uwspr_tpu.fec.fano_ref import fano_decode
from uwspr_tpu.protocol.constants import FANO_METTAB
from uwspr_tpu.protocol.fec_encode import encode_bits


@pytest.mark.gpu
def test_compiled_fano_kernel_matches_oracle(gpu):
    import jax.numpy as jnp

    from uwspr_tpu.fec.fano_cuda import fano_decode_batch_cuda

    rng = np.random.default_rng(11)
    lanes = []
    for sigma in [10.0] * 20 + [48.0] * 20:
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        soft = (np.where(coded == 1, 50.0, -50.0)
                + rng.normal(0, sigma, 162) + 128)
        lanes.append(np.clip(soft, 0, 255).astype(np.uint8))
    lanes += list(rng.integers(0, 256, size=(8, 162)).astype(np.uint8))
    lanes = np.stack(lanes)
    active = np.ones(len(lanes), bool)
    active[3] = False
    out = fano_decode_batch_cuda(jnp.asarray(lanes, jnp.int32),
                                 jnp.asarray(FANO_METTAB),
                                 jnp.asarray(active), maxcycles=300)
    succ, data, metric, cycles, maxnp = (np.asarray(out[k]) for k in (
        "success", "data", "metric", "cycles", "maxnp"))
    for i in range(len(lanes)):
        if not active[i]:
            assert not succ[i]
            continue
        r = fano_decode(lanes[i], FANO_METTAB, maxcycles=300)
        assert (succ[i], metric[i], cycles[i], maxnp[i]) == (
            r.success, r.metric, r.cycles, r.maxnp), i
        np.testing.assert_array_equal(data[i], r.data)


@pytest.mark.gpu
def test_serving_engine_matches_host_at_w8(gpu):
    import jax

    import chip_smoke
    from bench import make_windows
    from uwspr_tpu.config import (PipelineConfig, resolve_backend,
                                  with_serving_defaults)
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder

    assert resolve_backend().engine == "device"
    windows, expected = make_windows(8, seed=3)
    with jax.default_device(gpu):
        dec = DeviceDecoder(with_serving_defaults(PipelineConfig(), 8))
        out = dec.decode_batch(windows)
    dev = [dec.spots(out.window(w)) for w in range(8)]
    host = chip_smoke.host_spots(PipelineConfig(), windows)
    for w in range(8):
        assert expected[w] in {s.message for s in dev[w]}
        chip_smoke.compare_spots(f"window {w}", dev[w], host[w])
