"""Coarse candidate search (the reference's "FDR" block, as dense array ops).

Pipeline per 45000-sample window (behavioral spec: lib/FDR_impl.cc:214-456):

1. STFT power spectrum: 348 half-sine-windowed 512-pt FFTs stepped by half
   symbols -> ps (348, 512), DC at column 256  (ops/stft.py, batched XLA FFT).
2. Noise normalization: column-sum psavg, +/-3-bin smoothing over the
   passband, 30th-percentile noise floor, SNR normalize and clamp
   (FDR_impl.cc:257-291).
3. Peak picking: strict local maxima, capped at ``maxfreqs`` in ascending
   frequency order, then stable-sorted by SNR descending (the reference's
   bubble sort is stable; FDR_impl.cc:293-319).
4. Coarse (freq x lag x drift-model) sync scoring.  The reference's triple
   loop calling powersum() 2.7M times becomes one dense tensor contraction:

   - sqrt-power derivatives A/B are precomputed once per window
     (A = (r[f-1]+r[f+3])-(r[f-3]+r[f+1]), B = sum of the four; these are
     the sync-correlation and total-power kernels of powersum(),
     FDR_impl.cc:188-210);
   - every drift model (2*maxdrift+1 linear + 125 SLM trajectories) is
     reduced to a per-symbol integer bin-offset row, combined with the
     per-symbol sync sign into a one-hot weight matrix W (models, 162*9);
   - all (lag k0, model, frequency) scores come from one einsum
     'mkd,wkdf->wmf' (a GEMM on the device).

5. Exact sequential selection. The reference's order-dependent update rule
   (linear models: strictly-greater; nonlinear: accepted when
   sync/current_best > threshold — a *ratio* against a running maximum that
   earlier nonlinear acceptances may have changed, FDR_impl.cc:344-405) is
   reproduced bit-for-bit in evaluation order by a lax.scan over the
   flattened (freq, lag, model) grid with all candidates vectorized.

Reference quirks consciously preserved (SURVEY.md section 7.3):
- integer truncation t = k*111//162 mapping symbol index to whole seconds
  (FDR_impl.cc:382);
- drift bin offsets floor()ed exactly like C's float->int conversion of the
  (positive) total bin index;
- sync initialized to -1e30 and the division-based nonlinear gate, including
  its behavior for negative running maxima.
Divergence (documented): out-of-range spectrum reads (possible only with
halfbandwidth near fs/2, where the reference reads out of bounds —
FDR_impl.cc:268-275 / :199-205) are treated as zero power here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from uwspr_tpu.config import CoarseConfig
from uwspr_tpu.models import slm
from uwspr_tpu.ops.stft import stft_power
from uwspr_tpu.protocol.constants import SYNC_VECTOR

MODE_LINEAR = 0
MODE_NONLINEAR = 1

# offsets d in [-4, 4] cover every drift model at the defaults
_D_MIN, _D_MAX = -6, 6
_N_SHIFTS = _D_MAX - _D_MIN + 1


@dataclass
class DriftModelBank:
    """Per-model per-symbol bin offsets + metadata, in reference order."""

    offsets: np.ndarray       # (M, 162) int32 bin offsets (floor of drift/df)
    is_nonlinear: np.ndarray  # (M,) bool
    drift: np.ndarray         # (M,) float32 linear drift value (0 for SLM)
    slm_params: np.ndarray    # (M, 4) float32 (V1, V2, p1, p2); 0 for linear


def build_drift_models(cfg: CoarseConfig) -> DriftModelBank:
    df = cfg.df
    k = np.arange(162)
    rows, nonlin, drifts, params = [], [], [], []
    # linear models, drift = -maxdrift..maxdrift (reference loop order)
    for drift in range(-cfg.maxdrift, cfg.maxdrift + 1):
        x = (k - 81.0) / 81.0 * drift / (2.0 * df)
        rows.append(np.floor(x).astype(np.int32))
        nonlin.append(False)
        drifts.append(float(drift))
        params.append((0.0, 0.0, 0.0, 0.0))
    if cfg.search_nonlinear:
        # SLM trajectories in generator order; t = k*111//162 whole seconds
        t = slm.symbol_times_coarse()
        for v1, v2, p1, p2 in slm.TRAJECTORIES:
            # float32 to mirror the reference's float return value
            d = slm.slm_frequency_drift(v1, v2, p1, p2, cfg.cf, t)
            x = d.astype(np.float32) / np.float32(df)
            rows.append(np.floor(x).astype(np.int32))
            nonlin.append(True)
            drifts.append(0.0)
            params.append((v1, v2, p1, p2))
    bank = DriftModelBank(
        offsets=np.stack(rows),
        is_nonlinear=np.array(nonlin),
        drift=np.array(drifts, dtype=np.float32),
        slm_params=np.array(params, dtype=np.float32),
    )
    assert bank.offsets.min() >= _D_MIN and bank.offsets.max() <= _D_MAX, \
        (bank.offsets.min(), bank.offsets.max())
    return bank


def max_peaks(cfg: CoarseConfig) -> int:
    """Structural cap on the candidate-lane count.

    Peaks are strict local maxima over the finpb-2 interior passband bins
    (lib/FDR_impl.cc:293-319); no two can be adjacent, so at most
    (finpb-1)//2 exist. For the narrowband example config (hpbm=14 ->
    finpb=28) that is 13 — padding every per-candidate stage to the
    wideband maxfreqs=200 default would be 15x wasted work with identical
    semantics."""
    return min(cfg.maxfreqs, (2 * cfg.hpbm - 1) // 2)


@dataclass
class Candidates:
    """Padded candidate batch (fixed maxfreqs lanes + validity mask)."""

    valid: np.ndarray        # (C,) bool
    freq: np.ndarray         # (C,) float32  baseband Hz (tuned)
    snr: np.ndarray          # (C,) float32  6 Hz SNR, dB
    sync: np.ndarray         # (C,) float32  coarse sync score
    shift: np.ndarray        # (C,) int32    time offset, samples (128*k0)
    mode: np.ndarray         # (C,) int32    MODE_LINEAR / MODE_NONLINEAR
    drift: np.ndarray        # (C,) float32  linear drift (symbols/frame)
    slm_params: np.ndarray   # (C, 4) float32 (V1, V2, p1, p2)

    @property
    def n(self) -> int:
        return int(self.valid.sum())


# ---------------------------------------------------------------------------
# stages 2+3: noise-normalized smoothed spectrum and peak picking
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("hpbm", "m", "col0"))
def smoothed_snr_spectrum(ps: jnp.ndarray, *, hpbm: int, m: int,
                          col0: int = 0) -> jnp.ndarray:
    """(..., n, ncols) power -> (..., 2*hpbm) SNR-normalized smooth spectrum.

    ``col0``: absolute spectrum column held by ps column 0 — the
    column-windowed device pipeline passes only the passband plus reach
    (stft_power_core col_window); 0 = full-width spectrum. The zero pad
    at the (windowed) array edges reproduces the full-width behavior
    exactly: smoothing only ever reads columns [m-hpbm-3, m+hpbm+3),
    which the window provides wherever they exist absolutely, and the
    absolute array edge (column 0/size, reachable only with
    halfbandwidth near fs/2, where the window is the full spectrum
    anyway) stays the documented zero-contribution rule."""
    psavg = ps.sum(axis=-2)                               # (..., ncols)
    finpb = 2 * hpbm
    lo = m - hpbm - col0
    # +/-3-bin box smoothing over the passband (zero-padded at array edges)
    pad = jnp.pad(psavg, [(0, 0)] * (psavg.ndim - 1) + [(3, 3)])
    idx = lo + jnp.arange(finpb)
    sm = sum(pad[..., idx + 3 + j] for j in range(-3, 4))
    # 30th percentile noise floor
    srt = jnp.sort(sm, axis=-1)
    noise = srt[..., int(np.floor(0.3 * finpb))]
    snr = sm / noise[..., None] - 1.0
    min_snr = 10.0 ** (-7.0 / 10.0)
    return jnp.where(snr < min_snr, 0.1 * min_snr, snr).astype(jnp.float32)


def detect_peaks(smspec: np.ndarray, cfg: CoarseConfig
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side peak pick: returns (valid (C,), bin_if0 (C,), snr_db (C,)).

    bin_if0 is the absolute ps column index (if0 = peak_j - hpbm + m).
    Ascending-frequency cap at maxfreqs, then stable sort by SNR descending
    (== the reference's scan order + stable bubble sort).
    """
    finpb = 2 * cfg.hpbm
    C = cfg.maxfreqs
    s = np.asarray(smspec)
    j = np.arange(1, finpb - 1)
    is_peak = (s[j] > s[j - 1]) & (s[j] > s[j + 1])
    peaks = j[is_peak][:C]
    snr = 10.0 * np.log10(s[peaks])
    order = np.argsort(-snr, kind="stable")
    peaks, snr = peaks[order], snr[order]
    valid = np.zeros(C, dtype=bool)
    if0 = np.zeros(C, dtype=np.int32)
    out_snr = np.zeros(C, dtype=np.float32)
    npk = len(peaks)
    valid[:npk] = True
    if0[:npk] = peaks - cfg.hpbm + cfg.fft_size // 2
    out_snr[:npk] = snr
    return valid, if0, out_snr


# ---------------------------------------------------------------------------
# stage 4: dense sync-score grid (GEMM / conv)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("n_lags", "impl", "f_window",
                                    "dtype"))
def coarse_score_grid(ps: jnp.ndarray, if0: jnp.ndarray,
                      offsets: jnp.ndarray, sync_sign: jnp.ndarray,
                      *, n_lags: int = 26, impl: str = "einsum",
                      f_window: tuple[int, int] | None = None,
                      dtype: str = "f32") -> jnp.ndarray:
    """Score sync correlation over (candidate, freq+/-2, lag, model).

    ps: (n, size) power; if0: (C,) candidate center bins;
    offsets: (M, 162) int32; sync_sign: (162,) +/-1.
    Returns sync (C, 5, n_lags, M) = ss/pow in float32.

    ss[w, m, f] = sum_k sign[k] * A[w + 2k, f + offs[m, k]].  Two impls,
    identical math up to f32 summation order:

    - ``impl="einsum"`` contracts an im2col gather XA[w,k,d,f] = A[w+2k,
      f+d] against a one-hot (symbol, shift) weight matrix.  Its f32
      rounding reproduces the loop oracle's selection on knife-edge
      near-ties (the golden VE3EMB window has cells tied to < 5e-8
      relative, where the strict ``v > best`` update rule makes selection
      ulp-sensitive) — so this is the host/CoarseSearch default.
    - ``impl="conv"`` evaluates the same sum as a 2-D correlation of the
      A/B kernel planes with the per-model stencil: one
      conv_general_dilated with row dilation 2 (the half-symbol lag
      stride) per plane.  The einsum's im2col materializes
      26x-duplicated ~1.8 GB row-gather copies per 128-window batch; the
      conv reads A/B directly.  Its accumulation order differs by ~1 ulp,
      which can resolve float-noise ties differently — used by the batched
      device pipeline, whose numerics already diverge from the CPU oracle
      (bf16 matmuls).

    ``f_window=(lo, hi)`` (both impls) restricts scoring to absolute
    spectrum columns [lo, hi).  Candidates only ever gather columns within
    the passband +/-2, and the scoring stencil reaches +/-_D_MAX further,
    so a caller that knows the passband can pass lo = m - hpbm - 2 -
    _D_MAX, hi = m + hpbm + 2 + _D_MAX and skip scoring the other ~90% of
    the 512 columns (the reference scans only the passband too,
    FDR_impl.cc:330). Columns outside [0, size) keep the
    zero-contribution edge rule. ``dtype="bf16"`` (both impls) runs the
    contraction operands in bfloat16 with f32 accumulation (one-hot/sign
    weights exact; only the A/B powersum planes round).
    """
    n, size = ps.shape
    r = jnp.sqrt(ps)                                       # (n, size)
    pad = jnp.pad(r, ((0, 0), (_D_MAX + 3, _D_MAX + 3)))
    f = jnp.arange(size) + _D_MAX + 3
    # powersum kernels at every (row, bin): A = sync metric, B = total power
    A = (pad[:, f - 1] + pad[:, f + 3]) - (pad[:, f - 3] + pad[:, f + 1])
    B = pad[:, f - 3] + pad[:, f - 1] + pad[:, f + 1] + pad[:, f + 3]
    onehot = jax.nn.one_hot(offsets - _D_MIN, _N_SHIFTS, dtype=jnp.float32)
    # f32 scores are compared against the loop oracle: keep the GPU's
    # matmul units from rounding f32 operands to TF32
    precision = jax.lax.Precision.HIGHEST if dtype == "f32" else None
    lo = 0
    if impl == "conv":
        if f_window is not None:
            # gathered columns must lie in [lo+_D_MAX, hi-_D_MAX) (or at a
            # clamped 0/size boundary, where the zero rule applies anyway)
            lo, hi = max(f_window[0], 0), min(f_window[1], size)
            A = A[:, lo:hi]
            B = B[:, lo:hi]
        # explicit zero pad keeps the documented edge rule: shifts that
        # read outside the f grid contribute zero
        Ax = jnp.pad(A, ((0, 0), (_D_MAX, -_D_MIN)))[None, None]
        Bx = jnp.pad(B, ((0, 0), (_D_MAX, -_D_MIN)))[None, None]
        K_ss = (onehot * sync_sign[None, :, None].astype(jnp.float32)
                )[:, None]                                 # (M, 1, 162, D)
        K_pw = onehot[:, None]
        if dtype == "bf16":
            # bf16 conv operands with f32 accumulation (kernels are
            # one-hot +-1/0, exact in bf16 —
            # only the A/B powersum planes round). The device path's
            # selection already tolerates bf16-class value noise
            # (probe_dtype ladder precedent); the host CoarseSearch
            # keeps the f32 einsum oracle path.
            Ax, Bx = Ax.astype(jnp.bfloat16), Bx.astype(jnp.bfloat16)
            K_ss, K_pw = (K_ss.astype(jnp.bfloat16),
                          K_pw.astype(jnp.bfloat16))
        dn = jax.lax.conv_dimension_numbers(Ax.shape, K_ss.shape,
                                            ("NCHW", "OIHW", "NCHW"))
        conv = functools.partial(
            jax.lax.conv_general_dilated, window_strides=(1, 1),
            padding="VALID", rhs_dilation=(2, 1), dimension_numbers=dn,
            preferred_element_type=jnp.float32, precision=precision)
        # keep the conv's native (m, w, f) layout: transposing here
        # materializes two full grids (2 x 214 MB at wideband W=32) —
        # gather candidates in conv layout and transpose only the
        # (C,5)-gathered result below
        ss = conv(Ax, K_ss)[0, :, :n_lags]                 # (m, w, f)
        pw = conv(Bx, K_pw)[0, :, :n_lags]
    else:
        # im2col einsum: one (M, 162*13) x (162*13, lags*width) GEMM per
        # plane. With dtype="bf16" the shifted-copy build and GEMM
        # operands are bfloat16 (f32 accumulation; the one-hot/sign
        # weights are exact in bf16) — the wideband serving formulation.
        if f_window is not None:
            lo, hi = max(f_window[0], 0), min(f_window[1], size)
            A = A[:, lo:hi]
            B = B[:, lo:hi]
        width = A.shape[1]
        if dtype == "bf16":
            A = A.astype(jnp.bfloat16)
            B = B.astype(jnp.bfloat16)
        # shifted copies: S[row, d, f] = X[row, f + d + _D_MIN] (zero
        # outside the f window — the documented edge rule, like conv).
        # Built entirely from static slices, not a gather.
        padA = jnp.pad(A, ((0, 0), (_N_SHIFTS, _N_SHIFTS)))
        padB = jnp.pad(B, ((0, 0), (_N_SHIFTS, _N_SHIFTS)))
        off0 = _D_MIN + _N_SHIFTS
        SA = jnp.stack([padA[:, dd + off0:dd + off0 + width]
                        for dd in range(_N_SHIFTS)], axis=1)      # (n,D,w)
        SB = jnp.stack([padB[:, dd + off0:dd + off0 + width]
                        for dd in range(_N_SHIFTS)], axis=1)
        # lag rows kidx = k0 + 2k via the even/odd parity split — 26
        # static slices instead of a 26*162-row gather
        assert n >= 2 * 162 + n_lags - 2, (n, n_lags)

        def lag_rows(S):
            Se, So = S[0::2], S[1::2]
            return jnp.stack(
                [(Se if k0 % 2 == 0 else So)[k0 // 2:k0 // 2 + 162]
                 for k0 in range(n_lags)], axis=0)  # (lags, 162, D, w)

        XA = lag_rows(SA)
        XB = lag_rows(SB)
        wdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        W_ss = (onehot * sync_sign[None, :, None].astype(jnp.float32)
                ).astype(wdt)
        ss = jnp.einsum("mkd,wkdf->wmf", W_ss, XA,
                        preferred_element_type=jnp.float32,
                        precision=precision)
        pw = jnp.einsum("mkd,wkdf->wmf", onehot.astype(wdt), XB,
                        preferred_element_type=jnp.float32,
                        precision=precision)
    # per-candidate frequency gather: ifr = if0 + (-2..2). The conv
    # branch carries (m, w, f), the einsum branch (w, m, f); both gather
    # the same elements and differ only in the final transpose — the
    # division itself is element-for-element identical either way.
    ifr = if0[:, None] + jnp.arange(-2, 3)[None, :] - lo   # (C, 5)
    ss_c = ss[:, :, ifr]                                   # (., ., C, 5)
    pw_c = pw[:, :, ifr]
    sync = ss_c / pw_c
    perm = (2, 3, 1, 0) if impl == "conv" else (2, 3, 0, 1)
    return jnp.transpose(sync, perm).astype(jnp.float32)   # (C,5,w,M)


# ---------------------------------------------------------------------------
# stage 5: exact sequential selection
# ---------------------------------------------------------------------------


SELECT_UNROLL = 16


@functools.partial(jax.jit, static_argnames=("threshold",))
def select_best_scan(sync: jnp.ndarray, is_nonlinear: jnp.ndarray,
                     *, threshold: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Literal sequential fold over the (freq, lag, model) grid — the
    direct transcription of the reference's selection loop. Kept as the
    oracle for select_best; the event-skipping version below is the
    production path."""
    C = sync.shape[0]
    flat = sync.reshape(C, -1).T                           # (steps, C)
    n_steps = flat.shape[0]
    Mdim = sync.shape[3]
    step_is_nl = jnp.tile(is_nonlinear, n_steps // Mdim)

    def body(carry, xs):
        best, best_idx, j = carry
        v, nl = xs
        lin_upd = (~nl) & (v > best)
        ratio = v / best
        nl_upd = nl & (ratio > threshold)
        upd = lin_upd | nl_upd
        best = jnp.where(upd, v, best)
        best_idx = jnp.where(upd, j, best_idx)
        return (best, best_idx, j + 1), None

    init = (jnp.full(C, -1e30, jnp.float32), jnp.zeros(C, jnp.int32),
            jnp.int32(0))
    # unroll: the scan is ~16k tiny steps; unrolling trades compile size
    # for a shorter serial chain on device
    (best, best_idx, _), _ = jax.lax.scan(body, init, (flat, step_is_nl),
                                          unroll=SELECT_UNROLL)
    return best, best_idx


@functools.partial(jax.jit, static_argnames=("threshold",))
def _select_best_events(sync: jnp.ndarray, is_nonlinear: jnp.ndarray,
                        *, threshold: float,
                        active0: jnp.ndarray | None = None
                        ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Event-skipping while_loop selection — r4's production path, kept
    as the EXACT FALLBACK for select_best's flagged lanes (``active0``
    masks which lanes run; the loop exits immediately when none do). It
    makes no assumption about model ordering or chain depth.

    The grid is walked in (freq, lag, model) order; between update events
    the running best is constant, so acceptance can be tested per
    (freq, lag) GROUP of M model scores using only each group's extreme
    values: a linear step accepts iff v > best, so some step in the group
    accepts iff lin_max > best (the max is itself an element); a nonlinear
    step accepts iff v/best > threshold (division kept verbatim), and
    because f32 division is monotone in the numerator for any fixed
    denominator — including the best<0 start and the signed-zero /
    infinity edge cases — the extreme ratio over a group is attained at
    nl_max or nl_min. Each while_loop round fine-scans the (C, M) current
    group with the exact predicate and then jumps every lane straight to
    its next acceptable group via the (C, G) extreme tables: the
    16380-step serial scan becomes ~2 events' worth of rounds over
    M+G-sized arrays (~60x less traffic per round than masking the full
    grid). NaN scores never accept (NaN comparisons are false), so they
    are excluded from the extreme tables.

    sync: (C, 5, W, M) scores in evaluation order (freq, lag, model).
    Returns (best_sync (C,), best_flat_index (C,)).
    """
    C = sync.shape[0]
    Mdim = sync.shape[3]
    flat = sync.reshape(C, -1)                             # (C, steps)
    G = flat.shape[1] // Mdim
    g3 = flat.reshape(C, G, Mdim)
    is_nl = is_nonlinear[None, :]                          # (1, M)
    nan = jnp.isnan(g3)
    ninf, pinf = jnp.float32(-jnp.inf), jnp.float32(jnp.inf)
    lin_max = jnp.where(is_nl[:, None] | nan, ninf, g3).max(axis=2)  # (C,G)
    nl_max = jnp.where(~is_nl[:, None] | nan, ninf, g3).max(axis=2)
    nl_min = jnp.where(~is_nl[:, None] | nan, pinf, g3).min(axis=2)
    any_nl = jnp.any(is_nonlinear)
    g_idx = jnp.arange(G, dtype=jnp.int32)[None, :]
    m_idx = jnp.arange(Mdim, dtype=jnp.int32)[None, :]
    cidx = jnp.arange(C)

    def cond(state):
        return jnp.any(state[3])

    def body(state):
        # every update is gated on `act`: the loop runs until ALL lanes
        # finish, and best may legally DECREASE across events (the
        # reference's negative-ratio quirk), so a finished lane must not
        # re-scan — the body has to be idempotent for inactive lanes
        best, best_idx, t_cur, act = state
        g_cur = t_cur // Mdim
        off = t_cur - g_cur * Mdim
        # exact fine scan of the current group from offset `off`
        row = jnp.take_along_axis(g3, g_cur[:, None, None], axis=1)[:, 0]
        accept = jnp.where(is_nl, (row / best[:, None]) > threshold,
                           row > best[:, None])
        accept = accept & (m_idx >= off[:, None])
        has_e = jnp.any(accept, axis=1) & act
        e = jnp.argmax(accept, axis=1).astype(jnp.int32)   # first True
        best = jnp.where(has_e, row[cidx, e], best)
        best_idx = jnp.where(has_e, g_cur * Mdim + e, best_idx)
        # a hit rescans the same group against the new best next round; a
        # miss jumps to the first LATER group whose extremes can accept
        # (nl flags may rarely be a superset — e.g. all-NaN nl columns
        # with best > 0 — which only costs a barren rescan, never a miss)
        rl = lin_max > best[:, None]
        rn = (((nl_max / best[:, None]) > threshold)
              | ((nl_min / best[:, None]) > threshold)) & any_nl
        gmask = (rl | rn) & (g_idx > g_cur[:, None])
        has_g = jnp.any(gmask, axis=1)
        g_next = jnp.argmax(gmask, axis=1).astype(jnp.int32)
        t_cur = jnp.where(
            act, jnp.where(has_e, g_cur * Mdim + e + 1, g_next * Mdim),
            t_cur)
        active = (has_e | has_g) & act
        return best, best_idx, t_cur, active

    act0 = jnp.ones(C, bool) if active0 is None else active0
    init = (jnp.full(C, -1e30, jnp.float32), jnp.zeros(C, jnp.int32),
            jnp.zeros(C, jnp.int32), act0)
    best, best_idx, _, _ = jax.lax.while_loop(cond, body, init)
    return best, best_idx


@functools.partial(jax.jit, static_argnames=("threshold",))
def _select_best_grouped(sync: jnp.ndarray, is_nonlinear: jnp.ndarray,
                         *, threshold: float
                         ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Event-skip selection with CLOSED-FORM group resolution (r5).

    The r4 loop resolved one accept per round and re-scanned the same
    group after every hit, so rounds ~ 2x the event count (measured
    0.034 ms/window at the W=128 serving point — the #1 stage after the
    STFT cut; a group-synchronous scan alternative measured 0.119,
    rejected). Here every VISITED group is resolved completely in one
    round, so rounds == distinct event groups (typically the ~5 running
    records of 130 groups):

    - the group's LINEAR segment (models are linear-first in
      build_drift_models order — guaranteed by the select_best
      dispatcher) is a strict-max walk, so its last accept is exactly
      the segment max at its first-occurrence index (NaNs excluded:
      NaN comparisons never accept);
    - the NONLINEAR segment accepts v whenever v/best > threshold
      (division verbatim, including negative-best and signed-zero
      cases). Each accept moves |best| by > threshold, and |sync| =
      |ss|/pow <= 1, so in-group accept chains are short: three chain
      steps resolve exactly, and a (pathological, ~threshold**-3-flat)
      fourth accept just revisits the same group next round from past
      the chain position — still exact, never wrong.

    Jumps between event groups use the same extreme-value tables as
    _select_best_events. Oracle: select_best_scan, tested on random and
    adversarial chain/NaN/negative inputs (tests/test_coarse.py).

    sync: (C, 5, W, M) scores in evaluation order (freq, lag, model).
    Returns (best_sync (C,), best_flat_index (C,)).
    """
    C = sync.shape[0]
    Mdim = sync.shape[3]
    g3 = sync.reshape(C, -1, Mdim)                         # (C, G, M)
    G = g3.shape[1]
    is_nl = is_nonlinear[None, :]                          # (1, M)
    nan = jnp.isnan(g3)
    ninf, pinf = jnp.float32(-jnp.inf), jnp.float32(jnp.inf)
    lin_max = jnp.where(is_nl[:, None] | nan, ninf, g3).max(axis=2)  # (C,G)
    nl_max = jnp.where(~is_nl[:, None] | nan, ninf, g3).max(axis=2)
    nl_min = jnp.where(~is_nl[:, None] | nan, pinf, g3).min(axis=2)
    any_nl = jnp.any(is_nonlinear)
    g_idx = jnp.arange(G, dtype=jnp.int32)[None, :]
    midx = jnp.arange(Mdim, dtype=jnp.int32)[None, :]
    cidx = jnp.arange(C)
    thr = jnp.float32(threshold)

    def cond(state):
        return jnp.any(state[4])

    def body(state):
        best, bidx, g_cur, off, act = state
        row = jnp.take_along_axis(g3, g_cur[:, None, None], axis=1)[:, 0]
        bad = jnp.isnan(row)
        # linear segment from offset `off`: strict-max walk == segment
        # max at its first occurrence (`off` skips models the oracle
        # walk already passed when re-entering after a deep chain)
        linvals = jnp.where(is_nl | bad | (midx < off[:, None]), ninf, row)
        lmax = linvals.max(axis=1)
        lidx = jnp.argmax(linvals, axis=1).astype(jnp.int32)
        accL = act & (lmax > best)
        best = jnp.where(accL, lmax, best)
        bidx = jnp.where(accL, g_cur * Mdim + lidx, bidx)
        # nonlinear chain, <= 3 exact steps (first-accept order)
        prev = off - 1
        for _ in range(3):
            ok = (is_nl & (row / best[:, None] > thr)
                  & (midx > prev[:, None]) & act[:, None])
            has = jnp.any(ok, axis=1)
            c = jnp.argmax(ok, axis=1).astype(jnp.int32)
            v = row[cidx, c]
            best = jnp.where(has, v, best)
            bidx = jnp.where(has, g_cur * Mdim + c, bidx)
            prev = jnp.where(has, c, Mdim)
        resid = jnp.any(is_nl & (row / best[:, None] > thr)
                        & (midx > prev[:, None]) & act[:, None], axis=1)
        # next group: residual chains revisit this group past `prev`;
        # everyone else jumps to the first LATER group whose extremes
        # can accept against the updated best
        rl = lin_max > best[:, None]
        rn = (((nl_max / best[:, None]) > thr)
              | ((nl_min / best[:, None]) > thr)) & any_nl
        gmask = (rl | rn) & (g_idx > g_cur[:, None])
        has_g = jnp.any(gmask, axis=1)
        g_next = jnp.argmax(gmask, axis=1).astype(jnp.int32)
        off = jnp.where(resid, prev + 1, 0)
        g_cur = jnp.where(act & ~resid & has_g, g_next, g_cur)
        act = act & (resid | has_g)
        return best, bidx, g_cur, off, act

    init = (jnp.full(C, -1e30, jnp.float32), jnp.zeros(C, jnp.int32),
            jnp.zeros(C, jnp.int32), jnp.zeros(C, jnp.int32),
            jnp.ones(C, bool))
    # NOTE (r5 measured): replacing the while-cond with a fixed-trip
    # fori phase (8 rounds) + straggler while_loop measured 0.038 vs
    # 0.036 ms/window — the cost is the ~15 kernel launches per body
    # iteration, not the cross-lane any() cond, so the simple loop stays
    best, bidx, _, _, _ = jax.lax.while_loop(cond, body, init)
    return best, bidx


def select_best(sync: jnp.ndarray, is_nonlinear: jnp.ndarray,
                *, threshold: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Production selection dispatcher: the closed-form grouped loop for
    linear-first model banks (what build_drift_models always produces),
    the order-agnostic event loop otherwise (or when the mask is a
    traced value whose ordering cannot be inspected)."""
    try:
        nl = np.asarray(is_nonlinear)
        ordered = bool(np.all(nl[1:] >= nl[:-1]))
    except Exception:                        # traced mask: unknown order
        ordered = False
    if ordered:
        return _select_best_grouped(sync, is_nonlinear, threshold=threshold)
    return _select_best_events(sync, is_nonlinear, threshold=threshold)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


class CoarseSearch:
    """Configured coarse search over one or many 45000-sample windows."""

    def __init__(self, cfg: CoarseConfig | None = None):
        self.cfg = cfg or CoarseConfig()
        if self.cfg.halfbandwidth > self.cfg.fs // 2:
            raise ValueError("halfbandwidth must be below fs/2")
        self.models = build_drift_models(self.cfg)
        self._sign = (2.0 * SYNC_VECTOR.astype(np.float32) - 1.0)

    def power_spectrum(self, z: np.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        return stft_power(z, n_ffts=cfg.n_ffts, size=cfg.fft_size,
                          hop=cfg.spb // 2)

    def __call__(self, z: np.ndarray) -> Candidates:
        """One window -> candidate batch."""
        cfg = self.cfg
        ps = self.power_spectrum(z)
        sm = smoothed_snr_spectrum(ps, hpbm=cfg.hpbm, m=cfg.fft_size // 2)
        valid, if0, snr = detect_peaks(np.asarray(sm), cfg)
        sync = coarse_score_grid(ps, jnp.asarray(if0),
                                 jnp.asarray(self.models.offsets),
                                 jnp.asarray(self._sign))
        best, best_idx = select_best(sync, jnp.asarray(self.models.is_nonlinear),
                                     threshold=float(cfg.threshold))
        best = np.asarray(best)
        best_idx = np.asarray(best_idx)
        Mdim = self.models.offsets.shape[0]
        fi = best_idx // (26 * Mdim)
        k0 = (best_idx // Mdim) % 26
        mm = best_idx % Mdim
        m_half = cfg.fft_size // 2
        ifr = if0 + (fi - 2)
        freq = (ifr - m_half) * cfg.df
        return Candidates(
            valid=valid,
            freq=freq.astype(np.float32),
            snr=snr,
            sync=best.astype(np.float32),
            shift=(128 * k0).astype(np.int32),
            mode=np.where(self.models.is_nonlinear[mm], MODE_NONLINEAR,
                          MODE_LINEAR).astype(np.int32),
            drift=self.models.drift[mm],
            slm_params=self.models.slm_params[mm],
        )


__all__ = [
    "CoarseSearch", "Candidates", "DriftModelBank", "build_drift_models",
    "smoothed_snr_spectrum", "detect_peaks", "coarse_score_grid",
    "select_best", "MODE_LINEAR", "MODE_NONLINEAR",
]
