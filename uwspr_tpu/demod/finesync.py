"""Fine sync and soft-symbol demodulation (reference "sync_and_demodulate").

The reference refines each candidate's (lag, frequency, drift) with an
iterative 3-mode kernel that regenerates 4 tone waveforms per symbol by a
cos/sin phase recurrence and correlates 256 samples at a time
(lib/sync_and_demodulate_impl.cc:126-256), then extracts soft symbols and
retries Fano over up to 17 "jiggled" time shifts (:457-482).

Array re-design: each stage evaluates its whole probe grid densely —

    corr[c, l, i, j] = sum_k z[lag+256*i+k] * exp(-2*pi*j*(f_probe + drift_i
                        + tone_j) * k * dt)

factorized as (signal gather) x (per-candidate drift phasor, elementwise)
x (per-probe tone bank, one (162,256)@(256,F*4) matmul per candidate).
The staged schedule (coarse lag +/-128/64 -> freq +/-0.5/0.25 -> linear
drift +/-0.5 -> fine lag +/-32/16 -> fine freq +/-0.1/0.05 -> 17 jiggles)
follows the reference exactly, with all candidates batched; grid argmaxes
use first-max-wins order (freq outer, lag inner) to mirror the strict-
greater update rule.

Reference quirks handled:
- correlation guard ``0 < n < np`` excludes sample 0 (impl.cc:205);
- soft symbols: clamp to [-128, 127] *before* +128 bias, then C float->
  uint8 truncation == floor (impl.cc:247-252);
- the reference's nonlinear branch uses an *uninitialized* symbol time
  (the ``t = i*111/162`` statement at impl.cc:177 is dead code between case
  labels — a latent reference bug). We deliberately fix it to the coarse
  search's integer-truncated t = i*111//162 (FDR_impl.cc:382) and document
  the divergence here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from uwspr_tpu.coarse.search import MODE_NONLINEAR, Candidates
from uwspr_tpu.config import CoarseConfig, DemodConfig
from uwspr_tpu.models import slm
from uwspr_tpu.protocol.constants import (
    SAMPLE_RATE,
    SYNC_VECTOR,
    TONE_OFFSETS,
    TONE_SPACING,
)

_DT = 1.0 / SAMPLE_RATE
_TONES_HZ = (TONE_OFFSETS * TONE_SPACING).astype(np.float32)  # (4,)


def jiggle_offsets(n_jiggles: int, iifac: int) -> np.ndarray:
    """Retry-shift schedule 0, -iifac, +iifac, -2*iifac, ... in the
    reference's idt order (impl.cc:460-464). The single source for every
    consumer (FineSync, DeviceDecoder, multipass.spot_lag) — they must
    agree exactly, since spot_lag reconstructs a decoder's lag from the
    stored jiggle index."""
    idt = np.arange(n_jiggles)
    ii = (idt + 1) // 2
    ii = np.where(idt % 2 == 1, -ii, ii)
    return (ii * iifac).astype(np.int32)


def drift_offsets(cands: Candidates, drift1: np.ndarray, cf: float
                  ) -> np.ndarray:
    """(C, 162) per-symbol frequency offset in Hz for each candidate.

    linear: (drift1/2) * (i-81)/81   (impl.cc:173)
    nonlinear: SLM drift at t = i*111//162 whole seconds (see module doc).
    """
    C = len(cands.freq)
    i = np.arange(162, dtype=np.float64)
    lin = (drift1[:, None] / 2.0) * (i[None, :] - 81.0) / 81.0
    t = (np.arange(162) * 111 // 162).astype(np.float64)
    v1 = cands.slm_params[:, 0:1].astype(np.float64)
    v2 = cands.slm_params[:, 1:2].astype(np.float64)
    p1 = cands.slm_params[:, 2:3].astype(np.float64)
    p2 = cands.slm_params[:, 3:4].astype(np.float64)
    nl = slm.slm_frequency_drift(v1, v2, p1, p2, cf, t[None, :])
    is_nl = (cands.mode == MODE_NONLINEAR)[:, None]
    return np.where(is_nl, nl, lin).astype(np.float32)


def _probe_powers_xla(z, lags, freqs, drift_sym, *, n_lags):
    """Pure-XLA probe powers p (C, F, L, 162, 4).

    One contiguous slice per *candidate* (not per lag): all of a
    candidate's probe lags lie within a <=256-sample span by construction
    (stage grids are +/-128, jiggles +/-64), so a single 256-aligned
    (162, W=1024) overlapped-row window covers every lag, and each lag's
    256-sample symbol correlation is selected by masking the tone bank to
    aligned columns [b, b+256). Evaluating the derotation/tone phases at
    the aligned index j' = j + b multiplies each correlation by the unit
    phasor exp(-i*w*b) — irrelevant, since only |corr| is consumed.

    Sharing one slice across lags instead of one dynamic slice per
    (candidate, lag) cuts the gathered bytes 17x and turns the per-lag
    work into one einsum.
    """
    N = z.shape[0]
    C, F = freqs.shape
    W = 1024
    frame_len = 162 * 256
    ext_len = frame_len + W
    pad = 4096
    zp = jnp.pad(z, (pad, pad + W)).at[pad].set(0)
    starts = jnp.clip(lags.astype(jnp.int32) + pad, 0, pad + N)   # (C, L)
    base = jnp.minimum((jnp.min(starts, axis=1) // 256) * 256,
                       zp.shape[0] - ext_len)                     # (C,)
    b = jnp.clip(starts - base[:, None], 0, W - 256)              # (C, L)

    A = jax.vmap(
        lambda s: jax.lax.dynamic_slice(zp, (s,), (ext_len,)))(base)
    # overlapped rows: Amat[c, i, j'] = zp[base + 256*i + j'], j' in [0, W)
    blocks = [A[:, 256 * j: 256 * j + frame_len].reshape(C, 162, 256)
              for j in range(W // 256)]
    Amat = jnp.concatenate(blocks, axis=2)                        # (C,162,W)

    jpf = jnp.arange(W, dtype=jnp.float32)
    wd = (-2.0 * jnp.pi * _DT) * drift_sym[..., None] * jpf
    zd = Amat * jax.lax.complex(jnp.cos(wd), jnp.sin(wd))         # (C,162,W)

    ft = freqs[..., None] + jnp.asarray(_TONES_HZ)                # (C, F, 4)
    wb = (-2.0 * jnp.pi * _DT) * ft[..., None] * jpf              # (C,F,4,W)
    bank = jax.lax.complex(jnp.cos(wb), jnp.sin(wb))
    bank = bank.reshape(C, 1, 4 * F, W)
    mask = ((jpf[None, None, :] >= b[..., None])
            & (jpf[None, None, :] < b[..., None] + 256)
            ).astype(jnp.float32)                                 # (C, L, W)
    bankm = bank * mask[:, :, None, :]                            # (C,L,4F,W)
    corr = jnp.einsum("ciw,clmw->clim", zd, bankm,
                      preferred_element_type=jnp.complex64,
                      precision=jax.lax.Precision.HIGHEST)
    p = jnp.abs(corr).reshape(C, n_lags, 162, F, 4)
    return jnp.transpose(p, (0, 3, 1, 2, 4))                      # (C,F,L,162,4)


def _probe_powers_xla_gather(z, lags, freqs, drift_sym, *, n_lags):
    """Original per-lag-slice formulation — kept as the semantic reference
    for tests (direct transcription of the per-lag correlation)."""
    N = z.shape[0]
    C, F = freqs.shape
    k = jnp.arange(256, dtype=jnp.float32)
    # per-candidate drift phasor (C, 162, 256)
    wd = (-2.0 * jnp.pi * _DT) * drift_sym[..., None] * k
    phasor_d = jax.lax.complex(jnp.cos(wd), jnp.sin(wd))
    # tone bank per probe frequency: (C, F, 4, 256) -> (C, F*4, 256)
    ft = freqs[..., None] + jnp.asarray(_TONES_HZ)            # (C, F, 4)
    wb = (-2.0 * jnp.pi * _DT) * ft[..., None] * k            # (C,F,4,256)
    bank = jax.lax.complex(jnp.cos(wb), jnp.sin(wb)).reshape(C, F * 4, 256)

    # Each (candidate, lag) needs the contiguous 162*256-sample frame at
    # z[lag : lag+41472], taken as a contiguous dynamic_slice.  Zero padding
    # reproduces the reference's correlation guard 0 < n < N
    # (impl.cc:205): out-of-range samples contribute nothing, and z[0]
    # itself is excluded by zeroing it in the padded copy.
    frame_len = 162 * 256
    pad = 4096
    zp = jnp.pad(z, (pad, pad)).at[pad].set(0)

    def one_lag(lag_c):
        start = jnp.clip(lag_c + pad, 0, 2 * pad + N - frame_len)
        zz = jax.vmap(
            lambda s: jax.lax.dynamic_slice(zp, (s,), (frame_len,)))(start)
        zd = zz.reshape(C, 162, 256) * phasor_d
        corr = jnp.einsum("cik,cmk->cim", zd, bank,
                          preferred_element_type=jnp.complex64,
                          precision=jax.lax.Precision.HIGHEST)
        return jnp.abs(corr).reshape(C, 162, F, 4)            # power p

    ps = [one_lag(lags[:, l]) for l in range(n_lags)]
    p = jnp.stack(ps, axis=1)                                 # (C, L, 162, F, 4)
    return jnp.transpose(p, (0, 3, 1, 2, 4))                  # (C, F, L, 162, 4)


# ---------------------------------------------------------------------------
# shared probe context (device decoder): ONE aligned window per candidate
# reused by every refinement stage; each stage is just a masked-bank einsum.
# ---------------------------------------------------------------------------

_W = 1024
_PAD = 4096
_FRAME = 162 * 256
_REACH = 224            # max |lag - center| across all stages (128+32+64)


def _overlap_blocks(A: jnp.ndarray, W: int) -> jnp.ndarray:
    """(.., _FRAME+W) gathered span -> (.., 162, W) overlapped symbol rows.

    Columns [o, o+n) of row i live at A[.., o + 256*i : o + 256*i + n].
    Each sub-block slice materializes a full (.., _FRAME) frame copy, so
    emit 256-wide sub-blocks (fully kept) wherever possible and a
    half-kept 128-wide one only for a remainder."""
    lead = A.shape[:-1]
    blocks, off = [], 0
    while off < W:
        blk = A[..., off: off + _FRAME].reshape(lead + (162, 256))
        if W - off >= 256:
            blocks.append(blk)
            off += 256
        else:
            blocks.append(blk[..., :128])
            off += 128
    return jnp.concatenate(blocks, axis=-1)


def make_shared_probe(z: jnp.ndarray, center: jnp.ndarray, *,
                      reach: int = _REACH, W: int = _W, block: int = 256,
                      dtype: str = "c64"):
    """(N,) complex z + (C,) int32 lag centers -> (Amat, base (C,) int32
    absolute padded start). dtype "c64": Amat (C,162,W) complex64.
    dtype "bf16": Amat (C,2,162,W) bfloat16 real/imag planes — the whole
    construction chain (block gather, overlap rows, concat) runs at half
    the HBM bytes, and downstream consumers skip their f32->bf16 casts.

    Amat[c, i, j'] = zp[base_c + 256*i + j']: overlapped 512-stride rows
    covering every probe lag within center +/- reach.  base is aligned to
    ``block`` samples, so the window must absorb the probe span plus the
    alignment slack: W >= 2*reach + 256 + (block - 1), W % 128 == 0.
    Narrower stage-local windows matter because every downstream pass
    (derotation, masked-bank einsum) is HBM-bound in W.
    """
    assert W % 128 == 0 and W % block == 0, (W, block)
    assert W >= 2 * reach + 256 + (block - 1), (W, reach, block)
    C = center.shape[0]
    zp = jnp.pad(z, (_PAD, _PAD + W)).at[_PAD].set(0)
    start_min = center.astype(jnp.int32) + _PAD - reach
    base = jnp.clip((start_min // block) * block, 0,
                    zp.shape[0] - (_FRAME + W))
    # base is block-aligned, so the per-candidate slice is a gather of
    # whole blocks: one vectorized gather instead of a vmapped
    # dynamic_slice per (window, candidate) pair.
    nblk = -(-zp.shape[0] // block)
    zpad = jnp.pad(zp, (0, nblk * block - zp.shape[0]))
    rows = base[:, None] // block + jnp.arange((_FRAME + W) // block)[None, :]
    if dtype == "bf16":
        # pair-plane rows: row r = [real block r | imag block r], so the
        # gather keeps the f32 path's row count at half the bytes per row
        zblk = jnp.stack([jnp.real(zpad).reshape(nblk, block),
                          jnp.imag(zpad).reshape(nblk, block)],
                         axis=1).astype(jnp.bfloat16).reshape(nblk,
                                                              2 * block)
        A = (zblk[rows].reshape(C, -1, 2, block)
             .swapaxes(1, 2).reshape(C, 2, _FRAME + W))
    else:
        zblk = zpad.reshape(nblk, block)
        A = zblk[rows].reshape(C, _FRAME + W)
    return _overlap_blocks(A, W), base


def make_shared_probe_lanes(z_all: jnp.ndarray, widx: jnp.ndarray,
                            center: jnp.ndarray, *, reach: int = _REACH,
                            W: int = _W, block: int = 256,
                            dtype: str = "c64"):
    """Cross-window lane variant of make_shared_probe: (B, N) complex
    windows + (L,) per-lane window indices + (L,) lag centers ->
    (Amat (L, 162, W) complex — or (L, 2, 162, W) bfloat16 real/imag
    planes for dtype "bf16" — and base (L,) int32).

    Identical per-lane semantics to make_shared_probe(z_all[widx[l]],
    center[l:l+1]) — the block-row gather just adds a widx*nblk row
    offset, so L compacted lanes drawn from different windows still cost
    ONE vectorized gather. This is what makes cross-window candidate
    compaction (DemodConfig.cand_compact_lanes) possible: the wideband
    default carries maxfreqs=200 static candidate lanes per window of
    which only the accepted few are real, and the refine phases are
    ~linear in static lanes."""
    assert W % 128 == 0 and W % block == 0, (W, block)
    assert W >= 2 * reach + 256 + (block - 1), (W, reach, block)
    B, N = z_all.shape
    zp = jnp.pad(z_all, ((0, 0), (_PAD, _PAD + W))).at[:, _PAD].set(0)
    Np = zp.shape[1]
    start_min = center.astype(jnp.int32) + _PAD - reach
    base = jnp.clip((start_min // block) * block, 0, Np - (_FRAME + W))
    nblk = -(-Np // block)
    zpad = jnp.pad(zp, ((0, 0), (0, nblk * block - Np)))
    L = center.shape[0]
    nrange = jnp.arange((_FRAME + W) // block)
    rows = (widx.astype(jnp.int32) * nblk + base // block)[:, None] \
        + nrange[None, :]
    if dtype == "bf16":
        # pair-plane rows (see make_shared_probe): same row count as f32,
        # half the bytes per row
        zblk = jnp.stack([jnp.real(zpad).reshape(B * nblk, block),
                          jnp.imag(zpad).reshape(B * nblk, block)],
                         axis=1).astype(jnp.bfloat16).reshape(B * nblk,
                                                              2 * block)
        A = (zblk[rows].reshape(L, -1, 2, block)
             .swapaxes(1, 2).reshape(L, 2, _FRAME + W))
    else:
        zblk = zpad.reshape(B * nblk, block)
        A = zblk[rows].reshape(L, _FRAME + W)
    return _overlap_blocks(A, W), base


def phasor_ramp(theta: jnp.ndarray, W: int) -> jnp.ndarray:
    """exp(i * theta * j) for j in [0, W), theta (...,) -> (..., W).

    Split exponential: j = j1 + 64*j2 so exp(i*theta*j) =
    exp(i*theta*j1) * exp(i*theta*64*j2). Evaluating 64 + W/64
    transcendentals per theta instead of W matters because the probe
    pipeline is transcendental-bound, not matmul-bound (the derotation
    phasor alone is (C, 162, 1024) cos+sin pairs, ~4x per window). The
    extra unit-phasor
    product adds one f32 rounding vs direct cos/sin — irrelevant to the
    magnitude-only correlations downstream."""
    j1 = jnp.arange(64, dtype=jnp.float32)
    j2 = jnp.arange(W // 64, dtype=jnp.float32) * 64.0
    a1 = theta[..., None] * j1
    a2 = theta[..., None] * j2
    u = jax.lax.complex(jnp.cos(a1), jnp.sin(a1))       # (..., 64)
    v = jax.lax.complex(jnp.cos(a2), jnp.sin(a2))       # (..., W/64)
    return (v[..., :, None] * u[..., None, :]).reshape(theta.shape + (W,))


def _phasor_ramp_ri(theta: jnp.ndarray, W: int, dtype) -> tuple:
    """phasor_ramp as (cos, sin) planes materialized in ``dtype``.

    Same split-exponential evaluation; the outer products emit directly
    at the storage dtype (bfloat16 halves the two (C,162,W) ramp planes,
    the second-largest tensors of the refine stages after the windows
    themselves). Unit-phasor bf16 rounding is ~0.4% per element —
    noise-floor-level against the magnitude-only correlations."""
    j1 = jnp.arange(64, dtype=jnp.float32)
    j2 = jnp.arange(W // 64, dtype=jnp.float32) * 64.0
    a1 = theta[..., None] * j1
    a2 = theta[..., None] * j2
    # cast the tiny factors BEFORE the outer products so the W-wide
    # results are computed and materialized at the storage dtype (an
    # astype on the f32 product materializes the f32 intermediate first
    # — measured 690 MB/plane at the W=128 batch)
    ur, ui = jnp.cos(a1).astype(dtype), jnp.sin(a1).astype(dtype)
    vr, vi = jnp.cos(a2).astype(dtype), jnp.sin(a2).astype(dtype)
    cr = (vr[..., :, None] * ur[..., None, :]
          - vi[..., :, None] * ui[..., None, :])
    ci = (vr[..., :, None] * ui[..., None, :]
          + vi[..., :, None] * ur[..., None, :])
    shp = theta.shape + (W,)
    return cr.reshape(shp), ci.reshape(shp)


def probe_derotate(Amat: jnp.ndarray, drift_sym: jnp.ndarray) -> jnp.ndarray:
    """Apply the per-symbol drift phasor at the aligned index j'.

    Evaluating at the window-local index (not the absolute sample index)
    rotates each (candidate, symbol) row by a constant unit phasor, which
    factors out of every per-row correlation — only |corr| is consumed.

    Accepts either the complex64 (C,162,W) window or the bfloat16
    (C,2,162,W) real/imag-plane form (make_shared_probe dtype="bf16");
    the bf16 branch reads and writes only bf16 bytes (the complex
    multiply runs in f32 registers, converts fused into the elementwise
    op).
    """
    theta = (-2.0 * jnp.pi * _DT) * drift_sym
    if jnp.iscomplexobj(Amat):
        return Amat * phasor_ramp(theta, Amat.shape[-1])
    cr, ci = _phasor_ramp_ri(theta, Amat.shape[-1], Amat.dtype)
    # all-bf16 elementwise: upcasting the operands materializes f32
    # copies of the two largest tensors in the program (measured); the
    # extra bf16 rounding is noise-floor-level for the magnitude-only
    # correlations downstream
    ar = Amat[..., 0, :, :]
    ai = Amat[..., 1, :, :]
    zr = ar * cr - ai * ci
    zi = ar * ci + ai * cr
    return jnp.stack([zr, zi], axis=-3)


def shared_probe_eval(zd: jnp.ndarray, base: jnp.ndarray, lags: jnp.ndarray,
                      freqs: jnp.ndarray, *, n_lags: int,
                      want_symbols: bool = False, dtype: str = "f32"):
    """Evaluate sync (C, F, L) [+ tone powers] for probes against a shared
    derotated window. Phases are evaluated at the aligned index, which
    rotates each correlation by a unit phasor — only |corr| is consumed.

    dtype "bf16": the correlation einsum runs as four real bfloat16
    matmuls with float32 accumulation. Inputs are unit-scale phasors
    times the window, so bf16's 8-bit mantissa costs ~0.4% relative
    error per element, averaged down by the 256-sample accumulation.
    zd may then also arrive as the (C,2,162,W) bfloat16 real/imag-plane
    window (probe_derotate of a make_shared_probe dtype="bf16" build),
    which skips the f32->bf16 casts entirely."""
    C, F = freqs.shape
    W = zd.shape[-1]
    jpf = jnp.arange(W, dtype=jnp.float32)
    # The clip is a safety net for the padded-stream edges only: every
    # in-range probe must satisfy 0 <= lag + _PAD - base <= W - 256 by
    # construction (make_shared_probe's W >= 2*reach + 256 + block - 1
    # guarantee). A lag grid wider than the window's reach would be
    # silently clamped here into wrong correlations — callers own that
    # invariant (see the phase-A note in pipeline/jit_decoder.py, which
    # runs this with zero slack: max offset 383 vs bound 384 at W=640).
    b = jnp.clip(lags.astype(jnp.int32) + _PAD - base[:, None], 0, W - 256)
    ft = freqs[..., None] + jnp.asarray(_TONES_HZ)                # (C, F, 4)
    bank = phasor_ramp((-2.0 * jnp.pi * _DT) * ft, W
                       ).reshape(C, 1, 4 * F, W)
    mask = ((jpf[None, None, :] >= b[..., None])
            & (jpf[None, None, :] < b[..., None] + 256)
            ).astype(jnp.float32)                                 # (C, L, W)
    if dtype == "bf16":
        bf = jnp.bfloat16
        # cast-before-multiply: mask is exactly 0/1, so the product is
        # bit-identical to multiply-then-cast but never materializes the
        # (C,L,4F,W) f32 intermediate
        maskb = mask.astype(bf)[:, :, None, :]
        br = jnp.real(bank).astype(bf) * maskb                   # (C,L,4F,W)
        bi = jnp.imag(bank).astype(bf) * maskb
        if jnp.iscomplexobj(zd):
            zr = jnp.real(zd).astype(bf)
            zi = jnp.imag(zd).astype(bf)
        else:
            zr = zd[..., 0, :, :]
            zi = zd[..., 1, :, :]
        dot = functools.partial(jnp.einsum, "ciw,clmw->clim",
                                preferred_element_type=jnp.float32)
        re = dot(zr, br) - dot(zi, bi)
        im = dot(zr, bi) + dot(zi, br)
        p = jnp.sqrt(re * re + im * im).reshape(C, n_lags, 162, F, 4)
    else:
        assert jnp.iscomplexobj(zd), (
            "RI-plane zd requires dtype='bf16'")
        bankm = bank * mask[:, :, None, :]                        # (C,L,4F,W)
        corr = jnp.einsum("ciw,clmw->clim", zd, bankm,
                          preferred_element_type=jnp.complex64,
                          precision=jax.lax.Precision.HIGHEST)
        p = jnp.abs(corr).reshape(C, n_lags, 162, F, 4)
    p = jnp.transpose(p, (0, 3, 1, 2, 4))                         # (C,F,L,162,4)
    sign = jnp.asarray(2.0 * SYNC_VECTOR.astype(np.float32) - 1.0)
    cmet = (p[..., 1] + p[..., 3]) - (p[..., 0] + p[..., 2])
    ss = jnp.einsum("cfli,i->cfl", cmet, sign,
                    precision=jax.lax.Precision.HIGHEST)
    totp = p.sum(axis=(-2, -1))
    sync = (ss / totp).astype(jnp.float32)
    if want_symbols:
        return sync, p
    return sync


def eval_probe_grid_core(z: jnp.ndarray, lags: jnp.ndarray, freqs: jnp.ndarray,
                         drift_sym: jnp.ndarray, *, n_lags: int,
                         want_symbols: bool = False):
    """Evaluate sync for every (candidate, freq, lag) probe (in-graph).

    z: (N,) complex64 traced; lags: (C, L) int32; freqs: (C, F) float32
    absolute probe frequencies; drift_sym: (C, 162) float32 per-symbol
    drift in Hz.

    Returns sync (C, F, L) float32 and, if want_symbols, the per-symbol
    tone powers p (C, F, L, 162, 4) float32.
    """
    p = _probe_powers_xla(z, lags, freqs, drift_sym, n_lags=n_lags)

    sign = jnp.asarray(2.0 * SYNC_VECTOR.astype(np.float32) - 1.0)
    cmet = (p[..., 1] + p[..., 3]) - (p[..., 0] + p[..., 2])  # (C,F,L,162)
    ss = jnp.einsum("cfli,i->cfl", cmet, sign,
                    precision=jax.lax.Precision.HIGHEST)
    totp = p.sum(axis=(-2, -1))
    sync = (ss / totp).astype(jnp.float32)
    if want_symbols:
        return sync, p
    return sync


@functools.partial(jax.jit, static_argnames=("n_lags", "want_symbols"))
def _eval_probe_grid_ri(ri, lags, freqs, drift_sym, *, n_lags,
                        want_symbols=False):
    z = jax.lax.complex(ri[0], ri[1])
    return eval_probe_grid_core(z, lags, freqs, drift_sym, n_lags=n_lags,
                                want_symbols=want_symbols)


def complex_to_ri(z: np.ndarray) -> np.ndarray:
    """(N,) complex -> (2, N) float32 — the host<->device sample ABI."""
    z = np.asarray(z)
    return np.stack([z.real.astype(np.float32), z.imag.astype(np.float32)])


def eval_probe_grid(z, lags, freqs, drift_sym, *, n_lags,
                    want_symbols=False):
    """Host entry: numpy complex samples (or a pre-stacked (2, N) float
    pair) -> probe grid scores."""
    ri = z if (isinstance(z, np.ndarray) and z.ndim == 2) else complex_to_ri(z)
    return _eval_probe_grid_ri(jnp.asarray(ri), jnp.asarray(lags),
                               jnp.asarray(freqs), jnp.asarray(drift_sym),
                               n_lags=n_lags, want_symbols=want_symbols)


def _first_argmax(sync: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(C, F, L) -> best (fi, li) per candidate, first-max-wins in C order."""
    C, F, L = sync.shape
    flat = sync.reshape(C, -1)
    idx = flat.argmax(axis=1)
    return idx // L, idx % L


@dataclass
class Refined:
    """Per-candidate state after the staged refinement."""

    freq: np.ndarray          # (C,) f1
    shift: np.ndarray         # (C,) shift1
    drift: np.ndarray         # (C,) drift1
    sync: np.ndarray          # (C,) sync1
    worth_a_try: np.ndarray   # (C,) bool


class FineSync:
    def __init__(self, demod_cfg: DemodConfig | None = None,
                 coarse_cfg: CoarseConfig | None = None):
        self.cfg = demod_cfg or DemodConfig()
        self.coarse = coarse_cfg or CoarseConfig()

    # -- staged refinement (reference impl.cc:389-456) ---------------------

    def refine(self, z: np.ndarray, cands: Candidates) -> Refined:
        zj = complex_to_ri(z)
        C = len(cands.freq)
        f1 = cands.freq.astype(np.float32).copy()
        shift1 = cands.shift.astype(np.int32).copy()
        drift1 = cands.drift.astype(np.float32).copy()
        cf = float(self.coarse.cf)

        def stage(lag_grid, freq_grid, dsym):
            sync = eval_probe_grid(zj, np.asarray(lag_grid, np.int32),
                                   np.asarray(freq_grid, np.float32), dsym,
                                   n_lags=lag_grid.shape[1])
            return np.asarray(sync)

        dsym = drift_offsets(cands, drift1, cf)

        # stage 0: coarse lag search, +/-128 step 64
        lag_grid = shift1[:, None] + np.arange(-128, 129, 64)[None, :]
        sync = stage(lag_grid, f1[:, None], dsym)
        fi, li = _first_argmax(sync)
        shift1 = lag_grid[np.arange(C), li].astype(np.int32)
        sync1 = sync[np.arange(C), 0, li]

        # stage 1: coarse freq search, +/-2 * 0.25 Hz
        freq_grid = f1[:, None] + (np.arange(-2, 3) * 0.25)[None, :]
        sync = stage(shift1[:, None], freq_grid.astype(np.float32), dsym)
        fi, li = _first_argmax(sync)
        f1 = freq_grid[np.arange(C), fi].astype(np.float32)
        sync1 = sync[np.arange(C), fi, 0]

        # stage 2 (linear only): drift +/- 0.5 refinement.  The reference
        # evaluates both probes against the *base* sync and applies them as
        # if/else-if — the minus probe never fires when plus won
        # (impl.cc:423-441).
        is_lin = cands.mode != MODE_NONLINEAR
        driftp = drift1 + np.float32(0.5)
        driftm = drift1 - np.float32(0.5)
        syncp = stage(shift1[:, None], f1[:, None],
                      drift_offsets(cands, driftp, cf))[:, 0, 0]
        syncm = stage(shift1[:, None], f1[:, None],
                      drift_offsets(cands, driftm, cf))[:, 0, 0]
        updp = is_lin & (syncp > sync1)
        updm = is_lin & ~updp & (syncm > sync1)
        drift1 = np.where(updp, driftp,
                          np.where(updm, driftm, drift1)).astype(np.float32)
        sync1 = np.where(updp, syncp, np.where(updm, syncm, sync1))
        dsym = drift_offsets(cands, drift1, cf)

        # stage 3: fine lag (+/-32 step 16) and fine freq (+/-2 * 0.05)
        worth = sync1 > self.cfg.minsync1
        lag_grid = shift1[:, None] + np.arange(-32, 33, 16)[None, :]
        sync = stage(lag_grid, f1[:, None], dsym)
        fi, li = _first_argmax(sync)
        shift1 = np.where(worth, lag_grid[np.arange(C), li], shift1
                          ).astype(np.int32)
        sync1 = np.where(worth, sync[np.arange(C), 0, li], sync1)

        freq_grid = (f1[:, None] + (np.arange(-2, 3) * 0.05)[None, :]
                     ).astype(np.float32)
        sync = stage(shift1[:, None], freq_grid, dsym)
        fi, li = _first_argmax(sync)
        f1 = np.where(worth, freq_grid[np.arange(C), fi], f1
                      ).astype(np.float32)
        sync1 = np.where(worth, sync[np.arange(C), fi, 0], sync1)

        return Refined(freq=f1, shift=shift1, drift=drift1,
                       sync=sync1.astype(np.float32),
                       worth_a_try=worth & cands.valid)

    # -- mode-2 soft symbols over all jiggled shifts -----------------------

    def jiggle_offsets(self) -> np.ndarray:
        return jiggle_offsets(self.cfg.n_jiggles, self.cfg.iifac)

    def soft_symbols(self, z: np.ndarray, cands: Candidates, ref: Refined
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (symbols (C, J, 162) uint8, sync (C, J), rms (C, J))."""
        zj = complex_to_ri(z)
        C = len(ref.freq)
        jig = self.jiggle_offsets()
        lag_grid = ref.shift[:, None] + jig[None, :]          # (C, J)
        dsym = drift_offsets(cands, ref.drift, float(self.coarse.cf))
        sync, p = eval_probe_grid(zj, np.asarray(lag_grid, np.int32),
                                  ref.freq[:, None], dsym,
                                  n_lags=lag_grid.shape[1], want_symbols=True)
        sync = np.asarray(sync)[:, 0, :]                      # (C, J)
        p = np.asarray(p)[:, 0]                               # (C, J, 162, 4)
        sync_bit = SYNC_VECTOR.astype(bool)[None, None, :]
        fsymb = np.where(sync_bit, p[..., 3] - p[..., 1],
                         p[..., 2] - p[..., 0]).astype(np.float32)
        fsum = fsymb.mean(axis=-1, keepdims=True)
        f2sum = (fsymb * fsymb).mean(axis=-1, keepdims=True)
        fac = np.sqrt(f2sum - fsum * fsum)
        with np.errstate(divide="ignore", invalid="ignore"):
            scaled = self.cfg.symfac * fsymb / fac
        scaled = np.clip(np.nan_to_num(scaled), -128.0, 127.0)
        symbols = np.floor(scaled + 128.0).astype(np.uint8)
        y = symbols.astype(np.float32) - 128.0
        rms = np.sqrt((y * y).mean(axis=-1))
        return symbols, sync, rms


__all__ = ["FineSync", "Refined", "eval_probe_grid",
           "eval_probe_grid_core", "complex_to_ri", "drift_offsets",
           "jiggle_offsets", "make_shared_probe", "make_shared_probe_lanes",
           "probe_derotate",
           "shared_probe_eval"]
