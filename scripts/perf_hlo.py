#!/usr/bin/env python3
"""Dump the optimized HLO of the batched decode and summarize named ops.

    nohup timeout 1200 python scripts/perf_hlo.py fusion.580 fusion.3038 ...
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

from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder

W = 128
FL = 45000


def main():
    names = sys.argv[1:]
    dec = DeviceDecoder()
    ri = jnp.zeros((W, 2, FL), jnp.float32)
    txt = dec.decode_windows_ri.lower(ri).compile().as_text()
    out = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    out = out / "decode_hlo.txt"
    out.write_text(txt)
    print("wrote", out, len(txt), "bytes", flush=True)
    # print the definition line (root + a few lines of context) of each
    # requested computation/op name
    lines = txt.splitlines()
    for name in names:
        pat = re.compile(r"\b" + re.escape(name) + r"\b")
        for i, ln in enumerate(lines):
            if pat.search(ln) and ("= " in ln) and (" fusion(" in ln or
                                                    " while(" in ln or
                                                    " copy(" in ln or
                                                    " custom" in ln):
                print("\n====", name, "(line", i, ")")
                print(ln.strip()[:400])
                m = re.search(r"calls=([%\w.\-]+)", ln)
                if m:
                    comp = m.group(1).lstrip("%")
                    # print the computation body roots
                    for j, l2 in enumerate(lines):
                        if l2.startswith(comp + " ") or \
                           re.match(r"%?" + re.escape(comp) + r"\b", l2):
                            # print up to 40 lines of the computation
                            k = j
                            depth = 0
                            cnt = 0
                            while k < len(lines) and cnt < 50:
                                print("   ", lines[k].strip()[:240])
                                if "{" in lines[k]:
                                    depth += lines[k].count("{")
                                depth -= lines[k].count("}")
                                if depth <= 0 and cnt > 0:
                                    break
                                k += 1
                                cnt += 1
                            break
                break


if __name__ == "__main__":
    main()
