#!/usr/bin/env python3
"""A/B of the two device Fano implementations on one GPU, in one process.

Serving scene, end to end: W=128 decodable windows (bench.py's VE3EMB
frames at -18 dB, offset +/-5 Hz, start 0-2 s) through the serving
configuration (with_serving_defaults at W=128), fano_impl "cuda" (the
CUDA kernel) against "while" (lax.while_loop). Both programs are
compiled first, then timed in turns (cuda, while, while, cuda), each
turn the median of 5 batches ended by block_until_ready; the packed
outputs of the two must be identical.

Deep scene: the Fano stage alone on 128 all-timeout lanes (uniform random
soft symbols) at maxcycles=1000, in the same turns, results identical.

    python scripts/fano_ab.py        # prints a table and one JSON line
"""

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _median_time(fn, n=5):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    from uwspr_tpu.utils.device import (card_name_and_power_limit,
                                        device_summary, require_gpu)
    devices = require_gpu()
    from uwspr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax.numpy as jnp

    from bench import make_windows
    from uwspr_tpu.config import (DemodConfig, PipelineConfig,
                                  with_serving_defaults)
    from uwspr_tpu.demod.finesync import complex_to_ri
    from uwspr_tpu.fec.fano_jax import fano_decode_batch_jax
    from uwspr_tpu.fec.fano_cuda import fano_decode_batch_cuda
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
    from uwspr_tpu.protocol.constants import FANO_METTAB

    card = card_name_and_power_limit()
    print(f"card: {card}; jax: {device_summary(devices)}", flush=True)
    W = 128
    windows, _ = make_windows(W)
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in windows]))
    decs = {impl: DeviceDecoder(with_serving_defaults(PipelineConfig(
        demod=DemodConfig(fano_impl=impl)), W)) for impl in ("cuda",
                                                            "while")}
    packed = {}
    for impl, dec in decs.items():
        t0 = time.perf_counter()
        packed[impl] = np.asarray(dec.decode_windows_ri(ri)
                                  .block_until_ready())
        print(f"serving {impl}: compile + first batch "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    np.testing.assert_array_equal(packed["cuda"], packed["while"])
    serving = {"cuda": [], "while": []}
    for impl in ("cuda", "while", "while", "cuda"):
        dec = decs[impl]
        serving[impl].append(_median_time(
            lambda: dec.decode_windows_ri(ri).block_until_ready()))

    rng = np.random.default_rng(7)
    lanes = jnp.asarray(rng.integers(0, 256, size=(128, 162)), jnp.int32)
    met = jnp.asarray(FANO_METTAB)
    fns = {"cuda": fano_decode_batch_cuda, "while": fano_decode_batch_jax}
    outs = {impl: fn(lanes, met, maxcycles=1000) for impl, fn in fns.items()}
    for key in outs["cuda"]:
        np.testing.assert_array_equal(np.asarray(outs["cuda"][key]),
                                      np.asarray(outs["while"][key]))
    deep = {"cuda": [], "while": []}
    for impl in ("cuda", "while", "while", "cuda"):
        fn = fns[impl]
        deep[impl].append(_median_time(
            lambda: fn(lanes, met, maxcycles=1000)["success"]
            .block_until_ready(), n=3))

    doc = {
        "card": card,
        "serving_w128_batch_s": serving,
        "serving_ms_per_window": {k: [t / W * 1e3 for t in v]
                                  for k, v in serving.items()},
        "deep_128_timeout_lanes_maxcycles1000_s": deep,
    }
    print("| scene | cuda kernel | while |")
    print("|---|---|---|")
    print(f"| serving W=128 batch, s | {serving['cuda']} | "
          f"{serving['while']} |")
    print(f"| deep 128 timeout lanes, mc=1000, s | {deep['cuda']} | "
          f"{deep['while']} |")
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
