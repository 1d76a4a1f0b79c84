"""Coarse search vs the loop-by-loop NumPy oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from oracles import coarse_search_oracle, smoothed_oracle, stft_power_oracle
from uwspr_tpu.config import CoarseConfig
from uwspr_tpu.coarse.search import (
    CoarseSearch,
    detect_peaks,
    smoothed_snr_spectrum,
)
from uwspr_tpu.io.channel import awgn
from uwspr_tpu.protocol.modulate import synthesize_frame


@pytest.fixture(scope="module")
def noisy_window():
    z = (synthesize_frame("VE3EMB", "FN25", 30, start_sample=900,
                          freq_offset=3.0)
         + synthesize_frame("K1ABC", "EM79", 37, start_sample=1800,
                            freq_offset=-5.5, amplitude=0.7))
    return awgn(z, -15.0, rng=np.random.default_rng(11))


@pytest.fixture(scope="module")
def searcher():
    return CoarseSearch(CoarseConfig())


def test_stft_power_matches_oracle(noisy_window, searcher):
    ps = np.asarray(searcher.power_spectrum(noisy_window))
    ref = stft_power_oracle(noisy_window, searcher.cfg)
    assert ps.shape == ref.shape == (348, 512)
    np.testing.assert_allclose(ps, ref, rtol=2e-4, atol=1e-3)


def test_smoothed_spectrum_matches_oracle(noisy_window, searcher):
    cfg = searcher.cfg
    ps = searcher.power_spectrum(noisy_window)
    sm = np.asarray(smoothed_snr_spectrum(ps, hpbm=cfg.hpbm,
                                          m=cfg.fft_size // 2))
    ref = smoothed_oracle(np.asarray(ps, dtype=np.float64), cfg)
    np.testing.assert_allclose(sm, ref, rtol=1e-4)


def test_candidates_match_oracle(noisy_window, searcher):
    cands = searcher(noisy_window)
    ref = coarse_search_oracle(noisy_window, searcher.cfg)
    n = cands.n
    assert n == len(ref)
    assert n >= 2
    agree_mode = 0
    for i, rc in enumerate(ref):
        assert cands.freq[i] == pytest.approx(rc["freq"], abs=1e-6)
        assert cands.snr[i] == pytest.approx(rc["snr"], rel=1e-4)
        # float-accumulation order differs; near-ties may pick a different
        # (equally good) grid point, so compare scores at matched tolerance
        assert cands.sync[i] == pytest.approx(rc["sync"], rel=2e-3, abs=2e-3)
        if (cands.mode[i] == rc["mode"] and cands.shift[i] == rc["shift"]):
            agree_mode += 1
    # the exact winning grid point must agree for nearly all candidates
    assert agree_mode >= n - 1


def test_two_signals_found(noisy_window, searcher):
    cands = searcher(noisy_window)
    freqs = cands.freq[cands.valid]
    assert np.any(np.abs(freqs - 3.0) < 1.0)
    assert np.any(np.abs(freqs + 5.5) < 1.0)


def test_peak_cap_and_order(searcher):
    rng = np.random.default_rng(0)
    z = (rng.normal(size=45000) + 1j * rng.normal(size=45000)).astype(np.complex64)
    cfg = searcher.cfg
    sm = np.asarray(smoothed_snr_spectrum(searcher.power_spectrum(z),
                                          hpbm=cfg.hpbm, m=cfg.fft_size // 2))
    valid, if0, snr = detect_peaks(sm, cfg)
    n = valid.sum()
    assert n <= cfg.maxfreqs
    s = snr[:n]
    assert np.all(np.diff(s) <= 1e-6)  # sorted descending


def test_select_best_event_skip_matches_scan():
    """The production event-skipping select_best must be bit-identical to
    the literal sequential fold on every case, including the reference's
    division quirk for negative running maxima and NaN scores."""
    from uwspr_tpu.coarse.search import select_best, select_best_scan

    rng = np.random.default_rng(7)
    M = 9
    is_nl = jnp.asarray(np.array([False, True, True, False, True,
                                  True, True, False, True]))
    cases = []
    # generic random grids
    for _ in range(4):
        cases.append(rng.normal(size=(5, 5, 26, M)).astype(np.float32))
    # all-negative grid: only the negative-best nonlinear branch can fire
    cases.append((-np.abs(rng.normal(size=(3, 5, 26, M))) - 0.01
                  ).astype(np.float32))
    # chain of escalating nonlinear acceptances
    esc = np.full((1, 5, 26, M), 0.01, np.float32)
    esc[0, 0, 0, 0] = 0.02          # linear seed
    esc[0, 0, 1, 1] = 0.5           # nl: ratio 25 > 10
    esc[0, 0, 2, 2] = 8.0           # nl: ratio 16 > 10
    esc[0, 1, 0, 4] = 10.0          # nl: ratio 1.25 -> rejected
    cases.append(esc)
    # NaNs are never accepted
    nan_case = rng.normal(size=(2, 5, 26, M)).astype(np.float32)
    nan_case[0, 2, 3, :] = np.nan
    cases.append(nan_case)
    # all-NaN nonlinear columns in later groups with a positive running
    # best: the group-extreme prescreen may flag such groups (inf ratio)
    # and must recover via a barren rescan without accepting anything
    nl = np.asarray(is_nl)
    nn = np.full((2, 5, 26, M), 0.01, np.float32)
    nn[0, 0, 0, 0] = 3.0            # linear seed, best > 0
    nn[:, 1:, :, :][..., nl] = np.nan
    nn[1, 2, 5, 3] = np.nan
    cases.append(nn)
    # the reference's negative-ratio quirk makes best DECREASE: a negative
    # nonlinear score with ratio > threshold replaces a larger negative
    # best, re-enabling later linear acceptances
    dec = np.full((1, 5, 26, M), -100.0, np.float32)
    dec[0, 0, 0, 0] = -5.0          # linear: best -1e30 -> -5
    dec[0, 0, 2, 1] = -80.0         # nl: -80/-5 = 16 > 10 -> best -80
    dec[0, 0, 4, 3] = -60.0         # linear: -60 > -80 -> best -60
    dec[0, 1, 3, 0] = -50.0         # linear in a later group
    cases.append(dec)
    for sync in cases:
        b1, i1 = select_best(jnp.asarray(sync), is_nl, threshold=10.0)
        b2, i2 = select_best_scan(jnp.asarray(sync), is_nl, threshold=10.0)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


def test_conv_f_window_matches_full_grid():
    """The passband-restricted conv scoring (f_window) must be bit-identical
    to the full 512-column conv grid whenever every gathered column
    (if0 +/- 2) lies at least the kernel reach (+/-6) inside the window —
    the contract the device decoder relies on to skip ~90% of the grid."""
    from uwspr_tpu.coarse.search import build_drift_models, coarse_score_grid
    from uwspr_tpu.protocol.constants import SYNC_VECTOR

    cfg = CoarseConfig()
    bank = build_drift_models(cfg)
    rng = np.random.default_rng(3)
    ps = jnp.asarray(rng.uniform(0.1, 4.0, size=(348, 512)).astype(np.float32))
    m = cfg.fft_size // 2
    # candidates across the passband, incl. the extreme peak bins
    if0 = jnp.asarray(np.array(
        [m - cfg.hpbm + 1, m - 3, m, m + 5, m + cfg.hpbm - 2], np.int32))
    offs = jnp.asarray(bank.offsets)
    sign = jnp.asarray(2.0 * SYNC_VECTOR.astype(np.float32) - 1.0)
    full = coarse_score_grid(ps, if0, offs, sign, impl="conv")
    win = coarse_score_grid(
        ps, if0, offs, sign, impl="conv",
        f_window=(m - cfg.hpbm - 1 - 6, m + cfg.hpbm + 1 + 6))
    np.testing.assert_array_equal(np.asarray(win), np.asarray(full))
    # an out-of-range window clamps to [0, size) and stays exact
    clamped = coarse_score_grid(ps, if0, offs, sign, impl="conv",
                                f_window=(-17, 4096))
    np.testing.assert_array_equal(np.asarray(clamped), np.asarray(full))


def test_golden_c2_candidate(searcher, reference_examples):
    from uwspr_tpu.io.c2file import read_c2
    c2 = read_c2(reference_examples / "VE3EMB.c2")
    cands = searcher(c2.samples)
    ref = coarse_search_oracle(c2.samples, searcher.cfg)
    assert cands.n == len(ref) == 1
    assert cands.freq[0] == pytest.approx(ref[0]["freq"])
    assert cands.shift[0] == ref[0]["shift"]
    assert cands.mode[0] == ref[0]["mode"]
    if ref[0]["mode"] == 1:
        assert tuple(cands.slm_params[0][:2]) == ref[0]["slm"][:2]
        assert cands.slm_params[0][3] == ref[0]["slm"][3]


def test_stft_matmul_bf16_matches_fft():
    """CoarseConfig.stft_impl="matmul_bf16" (the byte-lean serving DFT,
    ops/stft.py): spectrum within bf16 rounding of the XLA FFT, and the
    device engine still decodes a golden frame through it."""
    import jax.numpy as jnp

    from uwspr_tpu.config import CoarseConfig, DemodConfig, PipelineConfig
    from uwspr_tpu.io.channel import awgn
    from uwspr_tpu.ops.stft import stft_power_core
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
    from uwspr_tpu.protocol.modulate import synthesize_frame

    rng = np.random.default_rng(17)
    z = awgn(synthesize_frame("VE3EMB", "FN25", 30, start_sample=400,
                              freq_offset=2.0), -18.0, rng=rng)
    zj = jnp.asarray(z)
    a = np.asarray(stft_power_core(zj))
    b = np.asarray(stft_power_core(zj, impl="matmul_bf16"))
    # relative error where the spectrum carries energy (bf16 inputs,
    # f32 accumulation); near-zero bins are absolute-error-dominated
    mask = a > 1e-3 * a.max()
    rel = np.abs(a[mask] - b[mask]) / a[mask]
    assert np.median(rel) < 0.01
    assert np.percentile(rel, 99) < 0.05

    dec = DeviceDecoder(PipelineConfig(
        coarse=CoarseConfig(stft_impl="matmul_bf16"),
        demod=DemodConfig(probe_dtype="bf16")))
    assert "VE3EMB FN25 30" in {s.message for s in dec.spots(dec(z))}


def test_column_windowed_coarse_matches_full():
    """The column-windowed device coarse path (r5): stft col_window,
    smoothed_snr_spectrum col0, and the relative-coordinate conv grid
    must be bit-identical to the full 512-column pipeline — nothing
    downstream reads outside the passband plus reach, so the device
    engine computes only ~2*hpbm+20 columns. Pinned exactly for both
    STFT impls (each DFT output column is an independent dot product)."""
    import jax.numpy as jnp

    from uwspr_tpu.coarse.search import (build_drift_models,
                                         coarse_score_grid,
                                         smoothed_snr_spectrum)
    from uwspr_tpu.ops.stft import stft_power_core
    from uwspr_tpu.protocol.constants import SYNC_VECTOR

    rng = np.random.default_rng(7)
    z = (rng.normal(size=45000) + 1j * rng.normal(size=45000)
         ).astype(np.complex64)
    cfg = CoarseConfig()
    m, hpbm = cfg.fft_size // 2, cfg.hpbm
    cb0 = max(0, m - hpbm - 10)
    cb1 = min(cfg.fft_size, m + hpbm + 10)
    for impl in ("fft", "matmul_bf16"):
        full = np.asarray(stft_power_core(jnp.asarray(z), impl=impl))
        win = np.asarray(stft_power_core(jnp.asarray(z), impl=impl,
                                         col_window=(cb0, cb1)))
        np.testing.assert_array_equal(full[:, cb0:cb1], win)
    ps_full = np.asarray(stft_power_core(jnp.asarray(z), impl="fft"))
    ps_win = ps_full[:, cb0:cb1]
    sm_f = smoothed_snr_spectrum(jnp.asarray(ps_full), hpbm=hpbm, m=m)
    sm_w = smoothed_snr_spectrum(jnp.asarray(ps_win), hpbm=hpbm, m=m,
                                 col0=cb0)
    np.testing.assert_array_equal(np.asarray(sm_f), np.asarray(sm_w))
    bank = build_drift_models(cfg)
    sign = 2.0 * SYNC_VECTOR.astype(np.float32) - 1.0
    if0 = np.array([m - 3, m + 5, m - hpbm + 1, m + hpbm - 2], np.int32)
    g_f = coarse_score_grid(
        jnp.asarray(ps_full), jnp.asarray(if0), jnp.asarray(bank.offsets),
        jnp.asarray(sign), impl="conv", f_window=(m - hpbm - 7, m + hpbm + 7))
    g_w = coarse_score_grid(
        jnp.asarray(ps_win), jnp.asarray(if0 - cb0),
        jnp.asarray(bank.offsets), jnp.asarray(sign), impl="conv",
        f_window=(m - hpbm - 7 - cb0, m + hpbm + 7 - cb0))
    np.testing.assert_array_equal(np.asarray(g_f), np.asarray(g_w))


def test_select_best_scan_path_matches_oracle():
    """The r5 group-synchronous closed-form select_best (linear-first
    ordered masks — the production shape) must be bit-identical to the
    literal fold, including intra-group nonlinear accept chains, the
    4-deep chain that triggers the exact while_loop fallback (dirty
    lane), multi-linear segments, NaNs, and negative-best chains."""
    from uwspr_tpu.coarse.search import select_best, select_best_scan

    rng = np.random.default_rng(11)
    M = 12
    # ordered: 3 linear models then 9 nonlinear (maxdrift=1-style)
    is_nl = jnp.asarray(np.array([False] * 3 + [True] * 9))
    cases = []
    for _ in range(4):
        cases.append(rng.normal(size=(5, 5, 26, M)).astype(np.float32))
    # intra-group chain of exactly 3 nonlinear accepts (scan limit)
    c3 = np.full((1, 5, 26, M), 1e-6, np.float32)
    c3[0, 0, 0, 1] = 1e-4           # linear segment max (idx 1 of 3)
    c3[0, 0, 0, 4] = 2e-3           # nl: ratio 20
    c3[0, 0, 0, 7] = 0.3            # nl: ratio 150
    c3[0, 0, 0, 10] = 40.0          # nl: ratio 133
    cases.append(c3)
    # 4-deep intra-group chain: exceeds the closed-form depth, must be
    # flagged dirty and recovered exactly by the while_loop fallback
    c4 = np.full((2, 5, 26, M), 1e-9, np.float32)
    c4[0, 1, 3, 0] = 1e-7
    c4[0, 1, 3, 3] = 5e-6
    c4[0, 1, 3, 5] = 1e-4
    c4[0, 1, 3, 8] = 9e-3
    c4[0, 1, 3, 11] = 0.7
    c4[1, 0, 0, 2] = 0.5            # other lane: plain linear winner
    cases.append(c4)
    # second linear model is the segment max; later groups try nl
    ml = np.full((1, 5, 26, M), 0.001, np.float32)
    ml[0, 0, 0, 0] = 0.2
    ml[0, 0, 0, 1] = 0.4            # linear record after record
    ml[0, 0, 0, 2] = 0.4            # tie: first occurrence wins
    ml[0, 2, 7, 5] = 4.5            # nl: ratio 11.25 > 10
    cases.append(ml)
    # NaNs never accepted, in both segments
    nn = rng.normal(size=(2, 5, 26, M)).astype(np.float32)
    nn[0, 0, 0, :3] = np.nan
    nn[1, :, :, 3:] = np.nan
    cases.append(nn)
    # negative chains (reference's decrease quirk) in ordered masks
    dec = np.full((1, 5, 26, M), -100.0, np.float32)
    dec[0, 0, 0, 0] = -5.0
    dec[0, 0, 2, 4] = -80.0         # nl: 16 > 10 -> best decreases
    dec[0, 0, 4, 1] = -60.0         # linear accept against -80
    cases.append(dec)
    for sync in cases:
        b1, i1 = select_best(jnp.asarray(sync), is_nl, threshold=10.0)
        b2, i2 = select_best_scan(jnp.asarray(sync), is_nl, threshold=10.0)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
