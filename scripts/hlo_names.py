#!/usr/bin/env python3
"""Map trace op names (fusion.N, copy.N, reshape.N ...) in the SERVING
config's optimized HLO back to source metadata, and rank the largest
buffers. One-off perf-attribution companion to perf_trace.py.

    timeout 1800 python scripts/hlo_names.py fusion.99 while.60 ...
"""

import pathlib
import re
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from uwspr_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp

from uwspr_tpu.config import DemodConfig, PipelineConfig
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder

W, FL = 128, 45000


def main():
    names = sys.argv[1:]
    dec = DeviceDecoder(PipelineConfig(demod=DemodConfig(
        refine_max_lanes=256, probe_dtype="bf16", fano_compact_lanes=256)))
    ri = jnp.zeros((W, 2, FL), jnp.float32)
    txt = dec.decode_windows_ri.lower(ri).compile().as_text()
    print(f"HLO: {len(txt.splitlines())} lines", flush=True)
    out = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serving.hlo").write_text(txt)

    # definition lines for the requested names
    for nm in names:
        pat = re.compile(r"%?" + re.escape(nm) + r" = ")
        for ln in txt.splitlines():
            if pat.search(ln):
                meta = re.search(r'metadata=\{[^}]*\}', ln)
                shape = re.search(r"= (\S+)", ln)
                kind = re.search(r"= \S+ (\w+)\(", ln)
                print(f"\n{nm}: {shape.group(1) if shape else '?'} "
                      f"{kind.group(1) if kind else '?'}")
                if meta:
                    print("   " + meta.group(0)[:400])
                break

    # largest tensors materialized anywhere (by shape on def lines)
    sizes = []
    for ln in txt.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = ((\w+)\[([\d,]*)\][^ ]*) ", ln)
        if not m:
            continue
        dt = m.group(3)
        bytes_per = {"f32": 4, "s32": 4, "u32": 4, "c64": 8, "bf16": 2,
                     "pred": 1, "s8": 1, "u8": 1, "f16": 2, "s16": 2}.get(dt)
        if not bytes_per:
            continue
        n = 1
        for d in m.group(4).split(","):
            if d:
                n *= int(d)
        sizes.append((n * bytes_per, m.group(1), m.group(2), ln))
    sizes.sort(reverse=True)
    print("\nlargest tensors (top 25):")
    seen = set()
    for sz, nm, shape, ln in sizes[:60]:
        key = shape
        if key in seen:
            continue
        seen.add(key)
        meta = re.search(r'metadata=\{[^}]*op_name="([^"]*)"', ln)
        src = re.search(r'source_file="([^"]*)" source_line=(\d+)', ln)
        print(f"  {sz/1e6:9.1f} MB  {nm:<28} {shape[:44]:<44} "
              f"{(meta.group(1)[-70:] if meta else '')} "
              f"{(src.group(1).split('/')[-1] + ':' + src.group(2)) if src else ''}")
        if len(seen) >= 25:
            break


if __name__ == "__main__":
    main()
