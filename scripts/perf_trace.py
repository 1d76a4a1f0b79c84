#!/usr/bin/env python3
"""Capture an XLA device trace of the batched decode and print top ops.

    timeout 1800 python scripts/perf_trace.py

Parses the TensorBoard trace-event dump directly (no tensorboard needed):
aggregates device-lane events by op name and prints the heaviest.
"""

import glob
import gzip
import json
import pathlib
import shutil
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from uwspr_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp

from uwspr_tpu.demod.finesync import complex_to_ri
from uwspr_tpu.io.channel import awgn
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
from uwspr_tpu.protocol.modulate import synthesize_frame

W = int(sys.argv[1]) if len(sys.argv) > 1 else 128
TRACE_DIR = str(pathlib.Path(__file__).resolve().parents[1]
                / "chiprun_out" / "trace")


def make_batch(seed=0):
    import os
    rng = np.random.default_rng(seed)
    wins = []
    if os.environ.get("UWSPR_WIDEBAND") == "1":
        from uwspr_tpu.io.channel import noise_sigma
        sigma = noise_sigma(-15.0)
        for w in range(W):
            z = (rng.normal(scale=sigma, size=45000)
                 + 1j * rng.normal(scale=sigma, size=45000)
                 ).astype(np.complex64)
            for k, f in enumerate(np.linspace(-170, 170, 10)):
                z += synthesize_frame(
                    "VE3EMB", "FN25", 30,
                    start_sample=int(rng.integers(0, 2000)),
                    freq_offset=float(f + rng.uniform(-2, 2)),
                    pad_to=45000)
            wins.append(z)
    else:
        for w in range(W):
            z = synthesize_frame("VE3EMB", "FN25", 30,
                                 start_sample=int(rng.integers(0, 3000)),
                                 freq_offset=float(rng.uniform(-100, 100)))
            wins.append(awgn(z, -18, rng=rng))
    return jnp.asarray(np.stack([complex_to_ri(z) for z in wins]))


def main():
    print("backend:", jax.default_backend(), jax.devices(), "W =", W,
          flush=True)
    ri = make_batch()
    # serving-config knobs (same env names as perf_stages_batch.py)
    import os
    lanes_k = int(os.environ.get("UWSPR_REFINE_LANES", "0"))
    dtype = os.environ.get("UWSPR_PROBE_DTYPE", "f32")
    fano_lanes = int(os.environ.get("UWSPR_FANO_LANES", "0"))
    cand_lanes = int(os.environ.get("UWSPR_CAND_LANES", "0"))
    wb = os.environ.get("UWSPR_WIDEBAND") == "1"
    if lanes_k or fano_lanes or cand_lanes or dtype != "f32" or wb:
        from uwspr_tpu.config import (CoarseConfig, DemodConfig,
                                      PipelineConfig)
        coarse = (CoarseConfig(halfbandwidth=187, maxfreqs=200) if wb
                  else CoarseConfig())
        dec = DeviceDecoder(PipelineConfig(coarse=coarse,
                                           demod=DemodConfig(
            refine_max_lanes=lanes_k, probe_dtype=dtype,
            fano_compact_lanes=fano_lanes, cand_compact_lanes=cand_lanes)))
        print(f"refine_lanes={lanes_k} dtype={dtype} fano_lanes={fano_lanes}"
              f" cand_lanes={cand_lanes} wideband={wb}", flush=True)
    else:
        dec = DeviceDecoder()
    t0 = time.perf_counter()
    np.asarray(dec.decode_windows_ri(ri))
    print(f"compile+first: {time.perf_counter() - t0:.1f} s", flush=True)

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        for _ in range(3):
            out = dec.decode_windows_ri(ri)
        np.asarray(out)
    files = glob.glob(TRACE_DIR + "/**/*.trace.json.gz", recursive=True)
    print("trace files:", files, flush=True)
    agg = {}
    lanes = {}
    for f in files:
        with gzip.open(f, "rt") as fh:
            data = json.load(fh)
        # pid/tid metadata -> lane names
        names = {}
        for e in data.get("traceEvents", []):
            if e.get("ph") == "M" and e.get("name") == "process_name":
                names[e["pid"]] = e["args"].get("name", "")
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            pname = names.get(e.get("pid"), "")
            lanes.setdefault(pname, 0)
            lanes[pname] += e.get("dur", 0)
            if "GPU" not in pname and "device" not in pname.lower():
                continue
            name = e.get("name", "?")
            agg.setdefault(name, [0, 0])
            agg[name][0] += e.get("dur", 0)
            agg[name][1] += 1
    print("\nlane totals (us):")
    for k, v in sorted(lanes.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:>12} {k}")
    print("\ntop device ops (total us over 3 reps):")
    for name, (dur, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:40]:
        print(f"  {dur:>9} us  x{n:<5} {name[:110]}")


if __name__ == "__main__":
    main()
