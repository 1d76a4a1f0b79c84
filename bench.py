#!/usr/bin/env python3
"""Benchmark: multichannel WSPR window decode throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Baseline: the reference decodes one 45000-sample window (120 s of one
channel) per 9 s hop on a single CPU thread — an effective processing rate
of 5000 window-samples/s (BASELINE.md, "real-time constraint"). vs_baseline
is our sustained window-samples/s divided by that.

Workload: decodable windows (the golden VE3EMB frame + AWGN at -18 dB,
randomized frequency offsets/starts) — every window runs the full pipeline
including gated Fano decodes. The decoder is the serving configuration:
the platform's engine and kernels (config.resolve_backend) with
with_serving_defaults at the batch width. Decoded messages are checked; a
run that fails to decode reports value 0. Fails without a GPU.

Device, card and per-batch timings go to stderr; stdout carries only the
JSON line.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

N_WINDOWS = int(os.environ.get("BENCH_WINDOWS", "128"))
SNR_DB = float(os.environ.get("BENCH_SNR", "-18"))
BASELINE_SAMPLES_PER_S = 5000.0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_windows(n, seed=0):
    """n seeded VE3EMB windows at SNR_DB: frequency offset +/-5 Hz, frame
    start 0..2000 samples. Returns (complex64 (n, fl), expected messages)."""
    from uwspr_tpu.io.channel import awgn
    from uwspr_tpu.protocol.modulate import synthesize_frame
    rng = np.random.default_rng(seed)
    windows, expected = [], []
    for i in range(n):
        f = float(rng.uniform(-5, 5))
        start = int(rng.integers(0, 2000))
        z = synthesize_frame("VE3EMB", "FN25", 30, start_sample=start,
                             freq_offset=f)
        windows.append(awgn(z, SNR_DB, rng=rng))
        expected.append("VE3EMB FN25 30")
    return np.stack(windows), expected


def main():
    import jax.numpy as jnp

    from uwspr_tpu.utils.device import (card_name_and_power_limit,
                                        device_summary, require_gpu)
    devices = require_gpu()
    from uwspr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from uwspr_tpu.config import (PipelineConfig, resolve_backend,
                                  with_serving_defaults)
    from uwspr_tpu.demod.finesync import complex_to_ri
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
    from uwspr_tpu.protocol.messages import unpack_message
    from uwspr_tpu.utils.roofline import analyze, cost_of, peaks_for

    device = device_summary(devices)
    log(f"device: {device}")
    log(f"card: {card_name_and_power_limit()}")
    backend = resolve_backend()
    config = PipelineConfig()
    if backend.serving_defaults:
        config = with_serving_defaults(config, N_WINDOWS)
    decoder = DeviceDecoder(config)
    log(f"engine: {backend.engine} fano_impl: {decoder.fano_impl} "
        f"demod: {config.demod} coarse: {config.coarse}")
    windows, expected = make_windows(N_WINDOWS)
    ri_j = jnp.asarray(np.stack([complex_to_ri(w) for w in windows]))

    # warmup / compile
    t0 = time.perf_counter()
    decoder.decode_windows_ri(ri_j).block_until_ready()
    log(f"compile+first decode of {N_WINDOWS} windows: "
        f"{time.perf_counter() - t0:.1f}s")

    # timed run: one batch at a time, each ended by block_until_ready
    reps = int(os.environ.get("BENCH_REPS", "8"))
    rep_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        packed = decoder.decode_windows_ri(ri_j).block_until_ready()
        rep_s.append(time.perf_counter() - t0)
    dt = float(np.median(rep_s))
    log("per-batch seconds: " + " ".join(f"{d:.4f}" for d in rep_s))
    out = decoder.unpack_output(np.asarray(packed))

    # correctness check
    ok = 0
    for w in range(N_WINDOWS):
        msgs = [u.text for c in np.flatnonzero(out.success[w])
                if (u := unpack_message(bytes(out.payload[w][c])))]
        if expected[w] in msgs:
            ok += 1
    log(f"{ok}/{N_WINDOWS} windows decoded correctly; "
        f"{dt / N_WINDOWS * 1000:.3f} ms/window (median batch)")

    # whole-program roofline: XLA's cost analysis of the compiled program
    # against the card's peaks
    compiled = decoder.decode_windows_ri.lower(ri_j).compile()
    flops, nbytes = cost_of(compiled)
    log("roofline: " + analyze(flops, nbytes, dt,
                               peaks_for(device["kind"])).line())

    value = N_WINDOWS * 45000.0 / dt if ok else 0.0
    print(json.dumps({
        "metric": "window_samples_per_s_per_chip",
        "value": value,
        "unit": "samples/s",
        "vs_baseline": value / BASELINE_SAMPLES_PER_S,
        "device": device,
    }))


if __name__ == "__main__":
    main()
