"""Device-decoder (single-XLA-program) and mesh-sharding tests.

These exercise the GPU serving path on the virtual CPU device grid; the
run on the card is chip_smoke.py (and tests/test_gpu.py).
"""

import jax
import numpy as np
import pytest

from uwspr_tpu.config import (
    CoarseConfig,
    DemodConfig,
    PipelineConfig,
    StreamConfig,
)
from uwspr_tpu.io.c2file import read_c2
from uwspr_tpu.io.channel import awgn, noise_sigma
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
from uwspr_tpu.protocol.modulate import synthesize_frame


@pytest.fixture(scope="module")
def device_decoder():
    return DeviceDecoder()


def test_device_golden_decode(device_decoder, reference_examples):
    c2 = read_c2(reference_examples / "VE3EMB.c2")
    out = device_decoder(c2.samples)
    msgs = device_decoder.messages(out)
    assert "VE3EMB FN25 30" in msgs


def test_device_single_jiggle():
    """n_jiggles=1 exercises the two-phase Fano's J==1 early path (no
    phase 2); an aligned strong frame must still decode identically."""
    config = PipelineConfig(demod=DemodConfig(maxcycles=2000, n_jiggles=1))
    dec = DeviceDecoder(config)
    z = synthesize_frame("K1ABC", "FN42", 37, start_sample=600,
                         freq_offset=1.5)
    z = awgn(z, -17, rng=np.random.default_rng(3))
    out = dec(z)
    assert "K1ABC FN42 37" in dec.messages(out)
    spot = next(s for s in dec.spots(out) if s.message == "K1ABC FN42 37")
    assert spot.jiggle == 0


def test_hybrid_fano_matches_device():
    """fano_mode="host" (hybrid engine: device pipeline + native host
    Fano) must reproduce the all-device output exactly — the backends are
    bit-exact and the first-success-in-jiggle-order selection is shared."""
    config = PipelineConfig(demod=DemodConfig(maxcycles=2000))
    dev = DeviceDecoder(config)
    hyb = DeviceDecoder(config, fano_mode="host")
    rng = np.random.default_rng(7)
    wins = []
    for snr in (-17.0, -23.0, -26.0):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 700)),
                             freq_offset=float(rng.uniform(-4, 4)))
        wins.append(awgn(z, snr, rng=rng))
    a = dev.decode_batch(np.stack(wins))
    b = hyb.decode_batch(np.stack(wins))
    np.testing.assert_array_equal(a.success, b.success)
    np.testing.assert_array_equal(a.payload[a.success], b.payload[b.success])
    np.testing.assert_array_equal(a.jiggle[a.success], b.jiggle[b.success])
    np.testing.assert_allclose(a.sync, b.sync, rtol=1e-6)
    assert a.success.sum() >= 3          # every window decodes


def test_device_matches_host_on_noisy(device_decoder):
    rng = np.random.default_rng(11)
    z = synthesize_frame("K1ABC", "FN42", 37, start_sample=600,
                         freq_offset=-3.0)
    z = awgn(z, -18, rng=rng)
    out = device_decoder(z)
    assert "K1ABC FN42 37" in device_decoder.messages(out)
    spots = device_decoder.spots(out)
    assert any(s.message == "K1ABC FN42 37" for s in spots)
    s = next(s for s in spots if s.message == "K1ABC FN42 37")
    assert s.freq == pytest.approx(-3.0, abs=0.4)


@pytest.mark.slow
def test_device_vs_host_parity():
    """The device decoder and the host WindowDecoder share kernels but
    orchestrate differently (one fused XLA program vs staged host calls);
    they must produce the same message sets and closely matching refined
    (freq, shift) across the usable SNR range on identical windows."""
    from uwspr_tpu.pipeline.decoder import WindowDecoder

    # maxcycles=2000 (serving profile): identical for both engines; the
    # full 10000-cycle budget makes the lockstep device Fano crawl on the
    # CPU backend without changing decode outcomes above -28 dB
    config = PipelineConfig(coarse=CoarseConfig(maxfreqs=48),
                            demod=DemodConfig(maxcycles=2000))
    device_decoder = DeviceDecoder(config)
    host = WindowDecoder(config)
    rng = np.random.default_rng(42)
    calls = ["VE3EMB", "K1ABC", "W9XYZ", "VE3EMB", "K1ABC"]
    for i, snr in enumerate([-15.0, -18.0, -21.0, -24.0, -26.0]):
        f = float(rng.uniform(-6, 6))
        start = int(rng.integers(0, 3000))
        z = synthesize_frame(calls[i], "FN25", 30, start_sample=start,
                             freq_offset=f)
        z = awgn(z, snr, rng=rng)
        dev_out = device_decoder(z)
        dev_spots = device_decoder.spots(dev_out)
        host_spots = host(z).spots
        dev_msgs = {s.message for s in dev_spots}
        host_msgs = {s.message for s in host_spots}
        assert dev_msgs == host_msgs, (snr, dev_msgs, host_msgs)
        assert f"{calls[i]} FN25 30" in dev_msgs, (snr, dev_msgs)
        for hs in host_spots:
            ds = next(s for s in dev_spots if s.message == hs.message)
            assert abs(ds.freq - hs.freq) < 0.06, (snr, ds.freq, hs.freq)
            assert abs(ds.shift - hs.shift) <= 16, (snr, ds.shift, hs.shift)


def _assert_packed_equal(a: np.ndarray, b: np.ndarray, discrete):
    """Discrete columns (flags, shifts, payload bytes) bit-equal; the
    remaining continuous columns (freqs, metrics, soft symbols) to f32
    ulp tolerance — vmap vs lax.map compile the same einsums with
    different fusion/reduction order, so last-bit drift is expected."""
    disc = np.zeros(a.shape[-1], dtype=bool)
    disc[list(discrete)] = True
    np.testing.assert_array_equal(a[..., disc], b[..., disc])
    np.testing.assert_allclose(a[..., ~disc], b[..., ~disc],
                               rtol=1e-5, atol=1e-6)


def test_batched_vmap_matches_map():
    """window_batch="vmap" (vmapped pre-Fano pipeline + one cross-window
    Fano batch) must match the serial lax.map path — discrete outputs
    bit-equal, continuous outputs to ulp tolerance — in both the
    all-device and hybrid engines, including multi-signal and
    noise-only windows."""
    import jax.numpy as jnp

    from uwspr_tpu.demod.finesync import complex_to_ri

    config = PipelineConfig(demod=DemodConfig(maxcycles=2000))
    rng = np.random.default_rng(7)
    wins = []
    for w in range(3):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-5, 5)))
        if w == 1:   # two frames in one window
            z = z + synthesize_frame("K1ABC", "FN42", 37, start_sample=500,
                                     freq_offset=-6.0, pad_to=45000)
        if w == 2:   # noise only
            z = 0 * z
        wins.append(awgn(z, (-20, -16, -30)[w], rng=rng))
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in wins]))

    dm = DeviceDecoder(config, window_batch="map")
    dv = DeviceDecoder(config, window_batch="vmap")
    om = np.asarray(dm.decode_windows_ri(ri))
    ov = np.asarray(dv.decode_windows_ri(ri))
    # layout: 0 success 1 valid 2 freq 3 snr 4 sync 5 shift 6 drift
    #         7 mode 8 jiggle 9:13 slm 13:20 payload 20 overflow
    _assert_packed_equal(om, ov,
                         [0, 1, 5, 7, 8, *range(13, 20), 20])
    typed = dv.unpack_output(ov)
    assert "VE3EMB FN25 30" in dv.messages(typed.window(0))
    assert {"VE3EMB FN25 30", "K1ABC FN42 37"} <= set(
        dv.messages(typed.window(1)))
    assert not typed.success[2].any()

    hm = DeviceDecoder(config, fano_mode="host", window_batch="map")
    hv = DeviceDecoder(config, fano_mode="host", window_batch="vmap")
    pm = np.asarray(hm.decode_windows_ri(ri))
    pv = np.asarray(hv.decode_windows_ri(ri))
    # prefano layout: 0 valid 1 worth 2 freq 3 snr 4 shift 5 drift 6 mode
    #                 7:11 slm 11:11+J sync2 11+J:11+2J gate 11+2J: deint
    # gate flags and the quantized uint8 deint symbols are discrete: any
    # ulp drift upstream must not flip a quantization bucket
    J = (pm.shape[-1] - 11) // 164
    _assert_packed_equal(pm, pv,
                         [0, 1, 4, 6, *range(11 + J, pm.shape[-1])])


def test_refine_compaction_matches_full():
    """refine_max_lanes > 0 (cross-window compaction of the post-worth
    refine stages) must decode the same messages with the same refined
    (freq, shift) as the uncompacted batch, in both device and hybrid
    engines; worth lanes beyond the cap degrade gracefully and surface in
    fano_overflow."""
    import jax.numpy as jnp

    from uwspr_tpu.demod.finesync import complex_to_ri

    rng = np.random.default_rng(13)
    wins = []
    for w in range(4):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-5, 5)))
        if w == 1:   # two frames in one window
            z = z + synthesize_frame("K1ABC", "FN42", 37, start_sample=500,
                                     freq_offset=-6.0, pad_to=45000)
        if w == 3:   # noise only
            z = 0 * z
        wins.append(awgn(z, (-20, -16, -24, -30)[w], rng=rng))
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in wins]))

    base = PipelineConfig(demod=DemodConfig(maxcycles=2000))
    comp = PipelineConfig(demod=DemodConfig(maxcycles=2000,
                                            refine_max_lanes=8))
    d0 = DeviceDecoder(base)
    d1 = DeviceDecoder(comp)
    o0 = d0.unpack_output(np.asarray(d0.decode_windows_ri(ri)))
    o1 = d1.unpack_output(np.asarray(d1.decode_windows_ri(ri)))
    for w in range(4):
        m0 = sorted(d0.messages(o0.window(w)))
        m1 = sorted(d1.messages(o1.window(w)))
        assert m0 == m1, (w, m0, m1)
    sel0, sel1 = o0.success, o1.success
    np.testing.assert_array_equal(sel0, sel1)
    np.testing.assert_array_equal(o0.shift[sel0], o1.shift[sel1])
    np.testing.assert_allclose(o0.freq[sel0], o1.freq[sel1], atol=1e-5)
    assert int(o1.fano_overflow.sum()) == 0

    # hybrid engine through the same compaction
    h1 = DeviceDecoder(comp, fano_mode="host")
    ph = h1.decode_ri_batch(np.asarray(ri))
    for w in range(4):
        msgs = sorted(h1.messages(ph.window(w)))
        assert msgs == sorted(d0.messages(o0.window(w))), (w, msgs)

    # cap smaller than the worth-lane count: decodes degrade gracefully
    # and the dropped lanes are counted
    tiny = PipelineConfig(demod=DemodConfig(maxcycles=2000,
                                            refine_max_lanes=2))
    d2 = DeviceDecoder(tiny)
    o2 = d2.unpack_output(np.asarray(d2.decode_windows_ri(ri)))
    assert int(o2.fano_overflow.sum()) >= 1
    assert o2.success.sum() <= o0.success.sum()


def test_fano_compaction_matches_per_window():
    """fano_compact_lanes > 0 (cross-window gather of gated Fano lanes
    into one small batch per phase) must reproduce the per-window-compacted
    batch exactly: same successes, payloads, jiggle selection, and overflow
    accounting. Lanes beyond the cap degrade gracefully and are counted."""
    import jax.numpy as jnp

    from uwspr_tpu.demod.finesync import complex_to_ri

    rng = np.random.default_rng(23)
    wins = []
    for w in range(5):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 2500)),
                             freq_offset=float(rng.uniform(-5, 5)))
        if w == 2:   # two frames in one window -> two gated lanes
            z = z + synthesize_frame("K1ABC", "FN42", 37, start_sample=400,
                                     freq_offset=-6.0, pad_to=45000)
        if w == 4:   # noise only -> no gated lanes
            z = 0 * z
        wins.append(awgn(z, (-18, -22, -16, -24, -30)[w], rng=rng))
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in wins]))

    base = PipelineConfig(demod=DemodConfig(maxcycles=2000))
    comp = PipelineConfig(demod=DemodConfig(maxcycles=2000,
                                            fano_compact_lanes=10))
    d0 = DeviceDecoder(base)
    d1 = DeviceDecoder(comp)
    o0 = d0.unpack_output(np.asarray(d0.decode_windows_ri(ri)))
    o1 = d1.unpack_output(np.asarray(d1.decode_windows_ri(ri)))
    np.testing.assert_array_equal(o0.success, o1.success)
    np.testing.assert_array_equal(o0.payload[o0.success],
                                  o1.payload[o1.success])
    np.testing.assert_array_equal(o0.jiggle, o1.jiggle)
    np.testing.assert_array_equal(o0.fano_overflow, o1.fano_overflow)
    assert int(o0.success.sum()) >= 4   # every non-noise window decoded

    # composes with refine-lane compaction (the bench operating point)
    both = PipelineConfig(demod=DemodConfig(maxcycles=2000,
                                            refine_max_lanes=10,
                                            fano_compact_lanes=10))
    d2 = DeviceDecoder(both)
    o2 = d2.unpack_output(np.asarray(d2.decode_windows_ri(ri)))
    np.testing.assert_array_equal(o0.success, o2.success)
    np.testing.assert_array_equal(o0.payload[o0.success],
                                  o2.payload[o2.success])

    # cap smaller than the gated-lane count (r5 never-drop semantics):
    # _compact_fano walks the gated lanes in cap-sized while_loop chunks
    # until every one is decoded — results identical to the uncapped
    # path and ZERO Fano overflow, matching the reference's retry loop
    # that never sheds a candidate (lib/sync_and_demodulate_impl.cc:
    # 457-482). The cap is now purely a throughput knob.
    tiny = PipelineConfig(demod=DemodConfig(maxcycles=2000,
                                            fano_compact_lanes=2))
    d3 = DeviceDecoder(tiny)
    o3 = d3.unpack_output(np.asarray(d3.decode_windows_ri(ri)))
    np.testing.assert_array_equal(o0.success, o3.success)
    np.testing.assert_array_equal(o0.payload[o0.success],
                                  o3.payload[o3.success])
    np.testing.assert_array_equal(o0.jiggle, o3.jiggle)
    assert int(o3.fano_overflow.sum()) == 0


def test_probe_dtype_bf16_decodes():
    """probe_dtype="bf16" (real bf16 matmuls, f32 accumulation) must decode
    the same frames as f32 at operating SNR."""
    import jax.numpy as jnp

    from uwspr_tpu.demod.finesync import complex_to_ri

    rng = np.random.default_rng(11)
    wins = []
    for i in range(3):
        z = synthesize_frame("VE3EMB", "FN25", 30,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-5, 5)))
        wins.append(awgn(z, -22, rng=rng))
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in wins]))
    cfg = PipelineConfig(demod=DemodConfig(maxcycles=2000,
                                           probe_dtype="bf16"))
    dec = DeviceDecoder(cfg)
    typed = dec.unpack_output(np.asarray(dec.decode_windows_ri(ri)))
    for w in range(3):
        assert "VE3EMB FN25 30" in dec.messages(typed.window(w))


def test_device_noise_only(device_decoder):
    rng = np.random.default_rng(5)
    sigma = noise_sigma(-18.0)
    z = (rng.normal(scale=sigma, size=45000)
         + 1j * rng.normal(scale=sigma, size=45000)).astype(np.complex64)
    out = device_decoder(z)
    assert not out.success.any()


def test_sharded_decoder_mesh():
    """(channel, time) shard_map decode on the 8-device CPU grid; halo
    exchange must hand complete windows to the time shards."""
    from uwspr_tpu.parallel.mesh import ShardedDecoder, make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    config = PipelineConfig(
        coarse=CoarseConfig(maxfreqs=8),
        demod=DemodConfig(maxcycles=64, n_jiggles=3),
        stream=StreamConfig(),
    )
    dec = ShardedDecoder(config, mesh)
    hop = dec.hop
    rng = np.random.default_rng(3)
    sigma = noise_sigma(-10.0)
    x = (rng.normal(scale=sigma, size=(2, 2 * hop))
         + 1j * rng.normal(scale=sigma, size=(2, 2 * hop))
         ).astype(np.complex64)
    out, n_spots = dec.decode(x)
    assert out["success"].shape[0] == 2      # channels gathered
    assert int(n_spots) == int(np.asarray(out["success"]).sum())


def test_cand_compaction_matches_full():
    """cand_compact_lanes > 0 (cross-window compaction of VALID candidate
    lanes before the phase-A/B refine — the wideband fast path) must
    decode the same messages with the same refined (freq, shift) as the
    uncompacted batch; valid lanes beyond the cap degrade gracefully and
    surface in fano_overflow."""
    import jax.numpy as jnp

    from uwspr_tpu.demod.finesync import complex_to_ri
    from uwspr_tpu.io.channel import noise_sigma

    rng = np.random.default_rng(17)
    wins = []
    sigma = noise_sigma(-15.0)
    for w in range(3):
        z = (rng.normal(scale=sigma, size=45000)
             + 1j * rng.normal(scale=sigma, size=45000)).astype(np.complex64)
        # several signals spread across the wide passband
        for k, (call, grid, f) in enumerate([
                ("VE3EMB", "FN25", -140.0), ("K1ABC", "FN42", -30.0),
                ("W9XYZ", "EM48", 55.0), ("N2AB", "FN31", 150.0)]):
            if w == 2 and k > 0:
                break                        # window 2: single signal
            z += synthesize_frame(call, grid, 30,
                                  start_sample=int(rng.integers(0, 2000)),
                                  freq_offset=f + float(rng.uniform(-2, 2)))
        wins.append(z)
    ri = jnp.asarray(np.stack([complex_to_ri(z) for z in wins]))

    wb = dict(halfbandwidth=187, maxfreqs=64)
    base = PipelineConfig(coarse=CoarseConfig(**wb),
                          demod=DemodConfig(maxcycles=2000))
    comp = PipelineConfig(coarse=CoarseConfig(**wb),
                          demod=DemodConfig(maxcycles=2000,
                                            cand_compact_lanes=96))
    d0 = DeviceDecoder(base)
    d1 = DeviceDecoder(comp)
    o0 = d0.unpack_output(np.asarray(d0.decode_windows_ri(ri)))
    o1 = d1.unpack_output(np.asarray(d1.decode_windows_ri(ri)))
    for w in range(3):
        m0 = sorted(d0.messages(o0.window(w)))
        m1 = sorted(d1.messages(o1.window(w)))
        assert m0 == m1, (w, m0, m1)
    assert o0.success.sum() >= 4             # the scene actually decodes
    np.testing.assert_array_equal(o0.success, o1.success)
    sel = o0.success
    np.testing.assert_array_equal(o0.shift[sel], o1.shift[sel])
    np.testing.assert_allclose(o0.freq[sel], o1.freq[sel], atol=1e-5)
    assert int(o1.fano_overflow.sum()) == 0

    # composes with refine + Fano compaction (the wideband serving point)
    comp2 = PipelineConfig(coarse=CoarseConfig(**wb),
                           demod=DemodConfig(maxcycles=2000,
                                             cand_compact_lanes=96,
                                             refine_max_lanes=32,
                                             fano_compact_lanes=64))
    d2 = DeviceDecoder(comp2)
    o2 = d2.unpack_output(np.asarray(d2.decode_windows_ri(ri)))
    np.testing.assert_array_equal(o0.success, o2.success)

    # hybrid engine through candidate compaction
    h1 = DeviceDecoder(comp, fano_mode="host")
    ph = h1.decode_ri_batch(np.asarray(ri))
    for w in range(3):
        msgs = sorted(h1.messages(ph.window(w)))
        assert msgs == sorted(d0.messages(o0.window(w))), (w, msgs)

    # cap smaller than the valid-lane count: graceful + observable
    tiny = PipelineConfig(coarse=CoarseConfig(**wb),
                          demod=DemodConfig(maxcycles=2000,
                                            cand_compact_lanes=4))
    d3 = DeviceDecoder(tiny)
    o3 = d3.unpack_output(np.asarray(d3.decode_windows_ri(ri)))
    assert int(o3.fano_overflow.sum()) >= 1
    assert o3.success.sum() <= o0.success.sum()
