#!/usr/bin/env python3
"""Smoke test of the WSPR decoder on one GPU: the serving path end to end,
the wideband path, and the compiled Fano kernel, each checked against the
repository's host references.

    python chip_smoke.py          # one GPU: phases a-c
    python chip_smoke.py --four   # four GPUs: phase d (the mesh) only

Phases (one process; fails on the first phase that fails):

a. Narrowband serving: DeviceRingDecoder (the `uwspr serve --runtime ring`
   path), built through config.resolve_backend, 128 channels each carrying
   a seeded VE3EMB frame at -18 dB (offset +/-5 Hz, start 0-2 s). Every
   channel must decode VE3EMB FN25 30, and the spots of sampled windows
   must equal the host engine's (WindowDecoder on the CPU device).
b. Wideband: one W=16 batch of the reference's full-passband GRC config
   (halfbandwidth=187, maxfreqs=200) on a 10-signal scene, checked against
   the host engine the same way.
c. Fano kernel: the CUDA kernel (fec/fano_cuda.py, built with nvcc at
   first use) must be bit-exact against the Python oracle
   (fec/fano_ref.py) on 256 decodable lanes and on 128 all-timeout lanes
   at maxcycles=10000; its time and the lax.while_loop path's time are
   printed side by side.
d. (--four) A 2x2 ("channel", "time") mesh of ShardedStreamDecoder on four
   cards, with a frame straddling every time shard, against the same stream
   decoded on one card.

Exits non-zero, without the final "ok" line, when JAX finds no GPU. The
last line of stdout is {"ok": true, "device": {platform, kind, count}}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

# Device-vs-host spot tolerances. The serving configuration computes the
# STFT and the probe correlations in bf16 (f32 accumulation) while the host
# engine is f32 throughout, so a refinement argmax may land one grid step
# away: fine frequency steps are 0.05 Hz and fine lag steps 16 samples.
# The device sync grid is a convolution, the host's an einsum; their ~1 ulp
# difference can resolve the reference's order-dependent model selection
# differently on float-noise ties (coarse.search.coarse_score_grid), so the
# engines may refine the same frame under different drift models (linear
# vs SLM). Such spots are counted and held to one tone spacing instead.
FREQ_TOL_HZ = 0.1            # two fine-frequency steps
MODEL_TIE_FREQ_TOL_HZ = 1.5  # one 4-FSK tone spacing (1.46 Hz)
SHIFT_TOL = 32               # two fine-lag steps (0.085 s of dt)
SNR_TOL_DB = 0.5             # bf16 DFT power error is ~1% (~0.04 dB)
SNR_DB = -18.0
FS = 375


def log(msg: str) -> None:
    print(msg, flush=True)


def _memory(name: str, compiled) -> None:
    ma = compiled.memory_analysis()
    log(f"  memory_analysis[{name}]: args {ma.argument_size_in_bytes} B, "
        f"outputs {ma.output_size_in_bytes} B, temps {ma.temp_size_in_bytes}"
        f" B, code {ma.generated_code_size_in_bytes} B")


def _peak(device) -> None:
    log(f"  peak_bytes_in_use: {device.memory_stats()['peak_bytes_in_use']}")


def host_spots(config, windows) -> list:
    """Host-engine (WindowDecoder) spots of each window, on the CPU device."""
    import jax

    from uwspr_tpu.pipeline.decoder import WindowDecoder
    with jax.default_device(jax.devices("cpu")[0]):
        dec = WindowDecoder(config)
        return [dec(np.asarray(w)).spots for w in windows]


def compare_spots(label: str, dev: list, host: list) -> dict:
    """Equal message sets, and freq/shift/SNR within the tolerances above.
    Returns the largest deviations seen (freq over same-model spots) and
    the number of model ties."""
    dmsg = sorted(s.message for s in dev)
    hmsg = sorted(s.message for s in host)
    assert set(dmsg) == set(hmsg), f"{label}: device {dmsg} != host {hmsg}"
    worst = {"freq_hz": 0.0, "shift": 0, "snr_db": 0.0, "model_ties": 0}
    for h in host:
        d = min((s for s in dev if s.message == h.message),
                key=lambda s: abs(s.freq - h.freq))
        df, dsh, dsn = (abs(d.freq - h.freq), abs(d.shift - h.shift),
                        abs(d.snr - h.snr))
        tie = d.mode != h.mode
        tol = MODEL_TIE_FREQ_TOL_HZ if tie else FREQ_TOL_HZ
        assert df <= tol, f"{label} {h.message}: freq {d.freq} {h.freq}"
        assert dsh <= SHIFT_TOL, f"{label} {h.message}: shift {d.shift} {h.shift}"
        assert dsn <= SNR_TOL_DB, f"{label} {h.message}: snr {d.snr} {h.snr}"
        if tie:
            log(f"  model tie at {label} {h.message}: device mode {d.mode} "
                f"{d.freq:.3f} Hz, host mode {h.mode} {h.freq:.3f} Hz")
        worst = {"freq_hz": worst["freq_hz"] if tie
                 else max(worst["freq_hz"], df),
                 "shift": max(worst["shift"], dsh),
                 "snr_db": max(worst["snr_db"], dsn),
                 "model_ties": worst["model_ties"] + tie}
    return worst


def _merge(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] if k == "model_ties" else max(a[k], b[k])
            for k in a}


def _parity_line(n: int, w: dict) -> str:
    return (f"  host parity on {n} windows: message sets equal; worst "
            f"|dfreq| {w['freq_hz']:.4f} Hz (tol {FREQ_TOL_HZ}), |dshift| "
            f"{w['shift']} samples (tol {SHIFT_TOL}), |dsnr| "
            f"{w['snr_db']:.3f} dB (tol {SNR_TOL_DB}); {w['model_ties']} "
            f"drift-model ties (tol {MODEL_TIE_FREQ_TOL_HZ} Hz)")


# -- phase a ---------------------------------------------------------------

def phase_serving(device, n_channels=128, n_hops=4, n_compare=8, seed=0):
    import jax

    from uwspr_tpu.config import (PipelineConfig, resolve_backend,
                                  with_serving_defaults)
    from uwspr_tpu.io.channel import noise_sigma
    from uwspr_tpu.pipeline.device_ring import DeviceRingDecoder
    from uwspr_tpu.protocol.modulate import synthesize_frame

    backend = resolve_backend()
    ring = DeviceRingDecoder(n_channels=n_channels)
    serving = with_serving_defaults(PipelineConfig(), n_channels)
    log(f"a. serving ring: engine {backend.engine}, serving defaults "
        f"{backend.serving_defaults}, fano_impl {ring._device.fano_impl}, "
        f"{n_channels} channels, {n_hops} hops per push_hops")
    assert backend.engine == "device" and backend.serving_defaults
    assert ring._device.config == serving, ring._device.config

    fl, hop = ring.fl, ring.hop
    n_fill = -(-fl // hop) - 1             # push_hop calls before a decode
    total = (n_fill + n_hops) * hop
    first = (n_fill + 1) * hop - fl        # stream start of decoded window 0
    rng = np.random.default_rng(seed)
    sigma = noise_sigma(SNR_DB)
    stream = (rng.normal(scale=sigma, size=(n_channels, total))
              + 1j * rng.normal(scale=sigma, size=(n_channels, total))
              ).astype(np.complex64)
    for c in range(n_channels):
        frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None,
                                 freq_offset=float(rng.uniform(-5, 5)))
        s0 = first + int(rng.integers(0, 2 * FS))
        stream[c, s0:s0 + len(frame)] += frame

    blocks = stream.reshape(n_channels, -1, hop).transpose(1, 0, 2)
    t0 = time.perf_counter()
    for k in range(n_fill):
        assert ring.push_hop(blocks[k]) is None
    packed = ring.push_hops(blocks[n_fill:]).block_until_ready()
    log(f"  prefill + compile + first push_hops: "
        f"{time.perf_counter() - t0:.1f} s")
    out = ring.fetch(packed)                           # (K, C, ...)

    decoded = set()
    dev_spots = {}
    for k in range(n_hops):
        for c in range(n_channels):
            sp = ring._device.spots(out.window(k).window(c))
            dev_spots[(k, c)] = sp
            if any(s.message == "VE3EMB FN25 30" for s in sp):
                decoded.add(c)
    log(f"  channels decoding VE3EMB FN25 30: {len(decoded)}/{n_channels}")
    assert len(decoded) == n_channels, sorted(set(range(n_channels))
                                              - decoded)

    ring_in = ring._ring
    new = (jax.device_put(np.zeros((n_hops, n_channels, 2, hop),
                                   np.float32)),
           jax.device_put(np.ones((n_hops, n_channels), np.float32)))
    _memory("ring push_hops", ring._multi.lower(ring_in, new).compile())
    _peak(device)

    picks = [(c % n_hops, int(c)) for c in
             rng.choice(n_channels, size=n_compare, replace=False)]
    wins = [stream[c, (n_fill + 1 + k) * hop - fl:(n_fill + 1 + k) * hop]
            for k, c in picks]
    worst = {"freq_hz": 0.0, "shift": 0, "snr_db": 0.0, "model_ties": 0}
    for (k, c), hs in zip(picks, host_spots(PipelineConfig(), wins)):
        worst = _merge(worst, compare_spots(f"hop {k} ch {c}",
                                            dev_spots[(k, c)], hs))
    log(_parity_line(n_compare, worst))


# -- phase b ---------------------------------------------------------------

CALLS = ["K1ABC", "W9XYZ", "N2AB", "VE3EMB", "G4CDE",
         "JA1FG", "VK2HI", "PY3JK", "ZS6LM", "OH2NP"]
GRIDS = ["FN42", "EM12", "FN31", "FN25", "IO91",
         "PM95", "QF56", "GF49", "KG33", "KP20"]


def wideband_scene(n_windows=16, n_sig=10, snr_db=-15.0, seed=3):
    """n_windows windows, each with n_sig frames spread over the 375 Hz
    passband (>= 8 Hz apart) at snr_db. Returns (windows, expected sets)."""
    from uwspr_tpu.io.channel import noise_sigma
    from uwspr_tpu.protocol.modulate import synthesize_frame

    rng = np.random.default_rng(seed)
    sigma = noise_sigma(snr_db)
    windows, expected = [], []
    for _ in range(n_windows):
        z = (rng.normal(scale=sigma, size=45000)
             + 1j * rng.normal(scale=sigma, size=45000)).astype(np.complex64)
        exp = set()
        base = np.linspace(-170, 170, n_sig)
        for k in range(n_sig):
            f = float(base[k] + rng.uniform(-2, 2))
            z += synthesize_frame(CALLS[k], GRIDS[k], 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=f, pad_to=45000)
            exp.add(f"{CALLS[k]} {GRIDS[k]} 30")
        windows.append(z)
        expected.append(exp)
    return windows, expected


def phase_wideband(device, n_windows=16, n_compare=8):
    import jax.numpy as jnp

    from uwspr_tpu.config import (CoarseConfig, PipelineConfig,
                                  with_serving_defaults)
    from uwspr_tpu.demod.finesync import complex_to_ri
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder

    base = PipelineConfig(coarse=CoarseConfig(halfbandwidth=187,
                                              maxfreqs=200))
    dec = DeviceDecoder(with_serving_defaults(base, n_windows))
    windows, expected = wideband_scene(n_windows)
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in windows]))
    log(f"b. wideband: W={n_windows}, halfbandwidth 187, maxfreqs 200, "
        f"{dec.n_cand} candidate lanes/window, 10 signals/window")
    t0 = time.perf_counter()
    packed = dec.decode_windows_ri(ri).block_until_ready()
    log(f"  compile + first batch: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    packed = dec.decode_windows_ri(ri).block_until_ready()
    dt = time.perf_counter() - t0
    log(f"  warm batch: {dt:.4f} s ({dt / n_windows * 1e3:.3f} ms/window)")
    _memory("wideband decode", dec.decode_windows_ri.lower(ri).compile())
    _peak(device)
    out = dec.unpack_output(np.asarray(packed))
    dev = [dec.spots(out.window(w)) for w in range(n_windows)]
    found = sum(len({s.message for s in d} & e)
                for d, e in zip(dev, expected))
    n_exp = sum(len(e) for e in expected)
    log(f"  decoded {found}/{n_exp} embedded frames")
    worst = {"freq_hz": 0.0, "shift": 0, "snr_db": 0.0, "model_ties": 0}
    for w, hs in enumerate(host_spots(base, windows[:n_compare])):
        worst = _merge(worst, compare_spots(f"wideband window {w}",
                                            dev[w], hs))
    log(_parity_line(n_compare, worst))


# -- phase c ---------------------------------------------------------------

def soft_lanes(rng, n, sigma_lo, sigma_hi, scale=50.0):
    """n soft-symbol lanes: encoded random payloads + gaussian noise of a
    per-lane sigma in [sigma_lo, sigma_hi] (sigma ~ scale puts lanes near
    the decode threshold)."""
    from uwspr_tpu.protocol.fec_encode import encode_bits

    lanes = []
    for _ in range(n):
        bits = rng.integers(0, 2, size=50).astype(np.uint8)
        coded = encode_bits(np.concatenate([bits, np.zeros(31, np.uint8)]))
        sigma = rng.uniform(sigma_lo, sigma_hi)
        soft = (np.where(coded == 1, 1.0, -1.0) * scale
                + rng.normal(0, sigma, 162) + 128)
        lanes.append(np.clip(soft, 0, 255).astype(np.uint8))
    return np.stack(lanes)


def _oracle(args):
    from uwspr_tpu.fec.fano_ref import fano_decode
    from uwspr_tpu.protocol.constants import FANO_METTAB
    symbols, maxcycles = args
    r = fano_decode(symbols, FANO_METTAB, maxcycles=maxcycles)
    return r.success, r.data, r.metric, r.cycles, r.maxnp


def _assert_exact(label, got, ref):
    succ, data, metric, cycles, maxnp = (np.asarray(got[k]) for k in
                                         ("success", "data", "metric",
                                          "cycles", "maxnp"))
    for i, (s, d, m, c, n) in enumerate(ref):
        assert (succ[i], metric[i], cycles[i], maxnp[i]) == (s, m, c, n), \
            (label, i, (succ[i], metric[i], cycles[i], maxnp[i]),
             (s, m, c, n))
        np.testing.assert_array_equal(data[i], d, err_msg=f"{label} {i}")


def _timed(fn, *args, **kw):
    fn(*args, **kw)["success"].block_until_ready()       # compile + warm
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    out["success"].block_until_ready()
    return out, time.perf_counter() - t0


def phase_fano(device, n_serving=256, n_timeout=128, maxcycles=10000,
               deep_ab_maxcycles=1000):
    import multiprocessing as mp

    import jax.numpy as jnp

    from uwspr_tpu.fec.fano_jax import fano_decode_batch_jax
    from uwspr_tpu.fec.fano_cuda import fano_decode_batch_cuda
    from uwspr_tpu.protocol.constants import FANO_METTAB

    rng = np.random.default_rng(7)
    serving = soft_lanes(rng, n_serving, 10.0, 55.0)
    hopeless = rng.integers(0, 256, size=(n_timeout, 162)).astype(np.uint8)
    log("c. Fano kernel (CUDA, one thread per lane) vs oracle and vs the "
        "while_loop path")
    # the oracle is pure Python (~3 s per all-timeout lane at
    # maxcycles=10000): compute it in child processes that never import
    # JAX, while this process drives the card
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(16, mp.cpu_count())) as pool:
        ref_serv = pool.map_async(_oracle, [(s, maxcycles) for s in serving])
        ref_deep = pool.map_async(_oracle, [(s, maxcycles)
                                            for s in hopeless])
        ref_ab = pool.map_async(_oracle, [(s, deep_ab_maxcycles)
                                          for s in hopeless])

        met = jnp.asarray(FANO_METTAB)
        srv = jnp.asarray(serving, jnp.int32)
        hop = jnp.asarray(hopeless, jnp.int32)
        k_srv, t_k_srv = _timed(fano_decode_batch_cuda, srv, met,
                                maxcycles=maxcycles)
        _memory(f"fano kernel ({n_serving} lanes)",
                fano_decode_batch_cuda.lower(
                    srv, met, maxcycles=maxcycles).compile())
        w_srv, t_w_srv = _timed(fano_decode_batch_jax, srv, met,
                                maxcycles=maxcycles)
        k_deep, t_k_deep = _timed(fano_decode_batch_cuda, hop, met,
                                  maxcycles=maxcycles)
        k_ab, t_k_ab = _timed(fano_decode_batch_cuda, hop, met,
                              maxcycles=deep_ab_maxcycles)
        w_ab, t_w_ab = _timed(fano_decode_batch_jax, hop, met,
                              maxcycles=deep_ab_maxcycles)
        _peak(device)
        ref_serv, ref_deep, ref_ab = (ref_serv.get(), ref_deep.get(),
                                      ref_ab.get())
    _assert_exact("serving kernel", k_srv, ref_serv)
    _assert_exact("serving while", w_srv, ref_serv)
    _assert_exact("timeout kernel", k_deep, ref_deep)
    _assert_exact("deep a/b kernel", k_ab, ref_ab)
    _assert_exact("deep a/b while", w_ab, ref_ab)
    n_ok = int(np.asarray(k_srv["success"]).sum())
    assert not np.asarray(k_deep["success"]).any()
    log(f"  bit-exact vs fano_ref: {n_serving} serving lanes ({n_ok} "
        f"decode), {n_timeout} all-timeout lanes at maxcycles={maxcycles}, "
        f"and both paths at maxcycles={deep_ab_maxcycles}")
    log(f"  serving lanes ({n_serving}, maxcycles={maxcycles}): kernel "
        f"{t_k_srv:.4f} s, while {t_w_srv:.4f} s")
    log(f"  all-timeout lanes ({n_timeout}, maxcycles={deep_ab_maxcycles}): "
        f"kernel {t_k_ab:.4f} s, while {t_w_ab:.4f} s")
    log(f"  all-timeout lanes ({n_timeout}, maxcycles={maxcycles}): kernel "
        f"{t_k_deep:.4f} s")


# -- phase d ---------------------------------------------------------------

def straddling_stream(dec, n_channels, seed=1):
    """A noise stream one mesh step long (plus its halo) with a VE3EMB
    frame whose 111 s span crosses every time-shard boundary."""
    from uwspr_tpu.io.channel import noise_sigma
    from uwspr_tpu.protocol.modulate import synthesize_frame

    rng = np.random.default_rng(seed)
    total = dec.step_len + dec.halo
    sigma = noise_sigma(SNR_DB)
    x = (rng.normal(scale=sigma, size=(n_channels, total))
         + 1j * rng.normal(scale=sigma, size=(n_channels, total))
         ).astype(np.complex64)
    frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None,
                             freq_offset=1.5)
    for c in range(n_channels):
        x[c, 700:700 + len(frame)] += frame
    return x


def phase_mesh(devices, n_channel=2, n_time=2):
    from uwspr_tpu.parallel.mesh import ShardedStreamDecoder, make_mesh

    mesh = make_mesh(n_channel, n_time, devices=devices[:n_channel * n_time])
    sharded = ShardedStreamDecoder(mesh=mesh, n_channels=n_channel)
    single = ShardedStreamDecoder(mesh=make_mesh(1, 1, devices=devices[:1]),
                                  n_channels=n_channel,
                                  wins_per_shard=n_time)
    assert single.step_len == sharded.step_len
    x = straddling_stream(sharded, n_channel)
    log(f"d. mesh {dict(mesh.shape)} on {n_channel * n_time} cards vs one "
        f"card: {n_channel} channels, {sharded.step_len // sharded.hop} "
        f"windows per channel, engine {sharded.engine}, fano_impl "
        f"{sharded.dec.decoder.fano_impl}")
    t0 = time.perf_counter()
    got = sharded.push(x)
    log(f"  mesh: compile + step {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref = single.push(x)
    log(f"  one card: compile + step {time.perf_counter() - t0:.1f} s")
    for ch in range(n_channel):
        msgs = {s.message for c, _, s in got if c == ch}
        assert "VE3EMB FN25 30" in msgs, (ch, msgs)
    worst = {"freq_hz": 0.0, "shift": 0, "snr_db": 0.0, "model_ties": 0}
    keys = sorted({(c, w) for c, w, _ in got} | {(c, w) for c, w, _ in ref})
    for c, w in keys:
        worst = _merge(worst, compare_spots(
            f"ch {c} window {w}",
            [s for cc, ww, s in got if (cc, ww) == (c, w)],
            [s for cc, ww, s in ref if (cc, ww) == (c, w)]))
    log(f"  mesh == one card on {len(keys)} (channel, window) pairs with "
        f"spots, {len(got)} spots; worst |dfreq| {worst['freq_hz']:.6f} Hz,"
        f" |dshift| {worst['shift']}, |dsnr| {worst['snr_db']:.6f} dB, "
        f"{worst['model_ties']} drift-model ties")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card mesh phase")
    args = p.parse_args(argv)

    from uwspr_tpu.utils.device import (card_name_and_power_limit,
                                        device_summary, require_gpu)
    devices = require_gpu()
    from uwspr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    log(f"card: {card_name_and_power_limit()}")
    summary = device_summary(devices)
    log(f"jax: platform {summary['platform']}, device_kind "
        f"{summary['kind']}, device count {summary['count']}")
    t0 = time.perf_counter()
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 GPUs, JAX sees {len(devices)}")
        phase_mesh(devices)
    else:
        phase_serving(devices[0])
        phase_wideband(devices[0])
        phase_fano(devices[0])
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
