"""Fully on-device window decoder: one jittable function from samples to
packed messages. This is the serving path on the GPU (and the flagship entry
point compiled by __graft_entry__): the host WindowDecoder shares the same
kernels but orchestrates stages from Python for flexibility.

decode_window(z) runs, entirely inside one XLA program:
  STFT power -> smoothed SNR spectrum -> device peak pick -> dense coarse
  drift-model scoring (conv/einsum) -> exact sequential model selection ->
  staged fine sync -> soft symbols for all jiggles -> sync/rms gates ->
  batched lockstep Fano -> first-success selection -> (C, 7) payload bytes.

Message-to-text unpacking (strings, hashtable) stays on the host; a (C, 7)
uint8 payload array is the device/host boundary, mirroring the reference's
7-byte blob PDUs (lib/sync_and_demodulate_impl.cc:528-530).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from uwspr_tpu.coarse.search import (
    build_drift_models,
    coarse_score_grid,
    max_peaks,
    select_best,
    smoothed_snr_spectrum,
)
from uwspr_tpu.config import PipelineConfig, resolve_backend
from uwspr_tpu.demod.finesync import (
    make_shared_probe,
    make_shared_probe_lanes,
    probe_derotate,
    shared_probe_eval,
)
from uwspr_tpu.fec.fano_jax import fano_decode_batch_jax
from uwspr_tpu.models.slm import slm_frequency_drift_jnp
from uwspr_tpu.ops.stft import stft_power_core as stft_power
from uwspr_tpu.protocol.constants import (
    FANO_METTAB,
    INTERLEAVE_PERM,
    SYNC_VECTOR,
)


@dataclass
class DeviceDecoderOutput:
    """Per-candidate arrays returned by decode_window (all length C)."""

    success: np.ndarray       # bool
    payload: np.ndarray       # (C, 7) uint8 packed message
    freq: np.ndarray
    snr: np.ndarray
    sync: np.ndarray
    shift: np.ndarray
    drift: np.ndarray
    mode: np.ndarray
    slm_params: np.ndarray    # (C, 4) V1,V2,p1,p2 (nonlinear candidates)
    jiggle: np.ndarray
    valid: np.ndarray
    fano_overflow: np.ndarray  # scalar: gated lanes dropped past
                               # fano_max_lanes (graceful-degradation count)
    fano_attempts: np.ndarray  # scalar: gated (candidate, jiggle) lanes
                               # this window (the reference's Fano retry
                               # count; load/capacity observability)
    osd: np.ndarray            # per candidate: 0 = Fano decode, else the
                               # OSD search order that recovered it — the
                               # deep-SNR fallback (on-device order <= 4
                               # via fec/osd_jax.py; host/hybrid engines
                               # any order via fec/osd.py)

    def window(self, w: int) -> "DeviceDecoderOutput":
        """Select one window from a batched (leading axis W) output."""
        import dataclasses
        return DeviceDecoderOutput(**{
            f.name: getattr(self, f.name)[w]
            for f in dataclasses.fields(self)})


class DeviceDecoder:
    """Configuration-baked jittable decoder."""

    def __init__(self, config: PipelineConfig | None = None,
                 truncate_stage: str | None = None,
                 fano_mode: str = "device",
                 window_batch: str = "vmap"):
        # truncate_stage ("post_refine" | "pre_fano" | "post_fano"): build a
        # program that stops after that stage and returns a reduction —
        # profiling aid for per-stage cost attribution.
        self.truncate_stage = truncate_stage
        # fano_mode "device": everything in one XLA program (default). The
        # full reference cycle budget (10000/bit,
        # lib/sync_and_demodulate_impl.cc:329) stays bounded on the GPU
        # with the CUDA Fano kernel (DemodConfig.fano_impl).
        # fano_mode "host" (the hybrid engine): the program stops after the
        # sync/rms gates and returns gated soft symbols; Fano runs on the
        # host via the native C++ backend (per-lane early exit, lowest
        # latency when most gated lanes are hopeless, and host OSD at any
        # order). Both modes produce identical spots.
        self.fano_mode = fano_mode
        self.config = config or PipelineConfig()
        cfg = self.config.coarse
        # Candidate-lane count: min(maxfreqs, structural peak bound). For
        # the narrowband default (hpbm=14 -> at most 13 strict local maxima
        # in the passband) this shrinks every per-candidate stage ~15x vs
        # padding to maxfreqs=200, with identical semantics.
        self.n_cand = max_peaks(cfg)
        models = build_drift_models(cfg)
        # constants are kept as HOST numpy arrays: jit embeds them directly
        # into the program instead of closing over committed device arrays
        # (which would cost a device->host copy at trace time).
        self._offsets = np.asarray(models.offsets)
        self._is_nl = np.asarray(models.is_nonlinear)
        self._model_drift = np.asarray(models.drift)
        self._model_slm = np.asarray(models.slm_params)
        self._sign = 2.0 * SYNC_VECTOR.astype(np.float32) - 1.0
        self._sync_bit = SYNC_VECTOR.astype(bool)
        self._mettab = np.asarray(FANO_METTAB)
        self._perm = np.asarray(INTERLEAVE_PERM)
        # on-device OSD fallback (fec/osd_jax.py) — static branch: when
        # osd_depth == 0 (the default) no OSD code enters the program
        if (self.config.demod.osd_depth > 0
                and self.config.demod.osd_max_lanes > 0):
            from uwspr_tpu.fec.osd import generator_matrix
            self._osd_G = np.asarray(generator_matrix(), np.int32)
        else:
            self._osd_G = None
        dcfg = self.config.demod
        from uwspr_tpu.demod.finesync import jiggle_offsets
        self._jiggles = jiggle_offsets(dcfg.n_jiggles, dcfg.iifac)
        # on-device Fano implementation (see DemodConfig.fano_impl); "auto"
        # is the platform's choice (config.resolve_backend). Both bit-exact.
        impl = dcfg.fano_impl
        if impl == "auto":
            impl = resolve_backend().fano_impl
        if impl == "cuda":
            from uwspr_tpu.fec.fano_cuda import fano_decode_batch_cuda
            self._fano_batch = fano_decode_batch_cuda
        elif impl == "while":
            self._fano_batch = fano_decode_batch_jax
        else:
            raise ValueError(f"unknown fano_impl {dcfg.fano_impl!r}")
        self.fano_impl = impl
        # The jitted entry points return ONE packed (C, 23) f32 array, not
        # the field dict: one device->host transfer per batch instead of
        # eleven. unpack_output() recovers the typed fields on the host.
        self.decode_window_ri = jax.jit(
            lambda ri: self._pack(self._decode_window_ri(ri)))
        # batched windows: one XLA program decodes (W, 2, fl).
        # window_batch "vmap" (default): the whole pre-Fano pipeline is
        # vmapped over W — each probe einsum carries the full (W*C) lane
        # batch (vs C=13 lanes per serial step, which leaves the matmul
        # units latency-bound) — and all windows' gated lanes are compacted
        # per-window then decoded in ONE cross-window Fano batch, so the
        # while_loop dispatch overhead is paid once per batch instead of
        # once per window. window_batch "map": serial lax.map over
        # windows (round-1 behavior; smaller live buffers).
        if window_batch == "vmap" and truncate_stage != "post_fano":
            # (post_fano truncation lives in the per-window _fano_select;
            # profile it via the map path)
            self.decode_windows_ri = jax.jit(self._decode_windows_batched)
        else:
            self.decode_windows_ri = jax.jit(
                lambda ris: jax.lax.map(
                    lambda ri: self._pack(self._decode_window_ri(ri)), ris))
        self.window_batch = window_batch

    # -- output packing: one d2h array instead of eleven --------------------
    # column layout (all exactly representable in f32):
    #   0 success  1 valid  2 freq  3 snr  4 sync  5 shift  6 drift
    #   7 mode  8 jiggle  9:13 slm_params  13:20 payload  20 fano_overflow
    #   21 fano_attempts (gated lanes this window)  22 osd (0 = Fano,
    #   else the on-device OSD order that rescued the candidate)

    @staticmethod
    def _pack(out: dict) -> jnp.ndarray:
        if "_t" in out:                     # truncated profiling program
            return out["_t"]
        if "_prefano" in out:               # hybrid engine: gates + symbols
            return out["_prefano"]
        head = jnp.stack([
            out["success"].astype(jnp.float32),
            out["valid"].astype(jnp.float32),
            out["freq"].astype(jnp.float32),
            out["snr"].astype(jnp.float32),
            out["sync"].astype(jnp.float32),
            out["shift"].astype(jnp.float32),
            out["drift"].astype(jnp.float32),
            out["mode"].astype(jnp.float32),
            out["jiggle"].astype(jnp.float32),
        ], axis=-1)                                             # (..., C, 9)
        def percol(v):
            return jnp.broadcast_to(v.astype(jnp.float32)[..., None, None],
                                    head.shape[:-1] + (1,))
        return jnp.concatenate(
            [head, out["slm_params"].astype(jnp.float32),
             out["payload"].astype(jnp.float32),
             percol(out["fano_overflow"]),
             percol(out["fano_attempts"]),
             out["osd"].astype(jnp.float32)[..., None]], axis=-1)

    @staticmethod
    def unpack_output(a: np.ndarray) -> DeviceDecoderOutput:
        """Packed (..., C, 23) f32 -> typed DeviceDecoderOutput."""
        a = np.asarray(a)
        return DeviceDecoderOutput(
            success=a[..., 0] > 0.5,
            valid=a[..., 1] > 0.5,
            freq=a[..., 2].astype(np.float32),
            snr=a[..., 3].astype(np.float32),
            sync=a[..., 4].astype(np.float32),
            shift=a[..., 5].astype(np.int32),
            drift=a[..., 6].astype(np.float32),
            mode=a[..., 7].astype(np.int32),
            jiggle=a[..., 8].astype(np.int32),
            slm_params=a[..., 9:13].astype(np.float32),
            payload=a[..., 13:20].astype(np.uint8),
            fano_overflow=a[..., 0, 20].astype(np.int32),
            fano_attempts=a[..., 0, 21].astype(np.int32),
            osd=a[..., 22].astype(np.int32),
        )

    # -- coarse: device peak pick -----------------------------------------

    def _peaks(self, sm: jnp.ndarray):
        cfg = self.config.coarse
        finpb = 2 * cfg.hpbm
        C = self.n_cand
        m = cfg.fft_size // 2
        j = jnp.arange(finpb)
        left = jnp.roll(sm, 1)
        right = jnp.roll(sm, -1)
        is_peak = (sm > left) & (sm > right) & (j >= 1) & (j <= finpb - 2)
        rank = jnp.cumsum(is_peak)
        keep = is_peak & (rank <= C)
        key = jnp.where(keep, j, finpb + 1)
        key = jnp.concatenate([key, jnp.full((C,), finpb + 1, key.dtype)])
        sel = jnp.sort(key)[:C]
        valid = sel < finpb
        sel = jnp.minimum(sel, finpb - 1)
        snr_db = 10.0 * jnp.log10(sm[sel])
        sortkey = jnp.where(valid, -snr_db, jnp.inf)
        order = jnp.argsort(sortkey, stable=True)
        sel, valid, snr_db = sel[order], valid[order], snr_db[order]
        if0 = sel - cfg.hpbm + m
        return valid, if0.astype(jnp.int32), jnp.where(valid, snr_db, 0.0)

    # -- demod helpers -----------------------------------------------------

    def _drift_offsets(self, mode, drift, slm_params):
        """(C,) metadata -> (C, 162) per-symbol drift in Hz (float32)."""
        i = jnp.arange(162, dtype=jnp.float32)
        lin = (drift[:, None] / 2.0) * (i[None, :] - 81.0) / 81.0
        t = ((jnp.arange(162) * 111) // 162).astype(jnp.float32)
        nl = slm_frequency_drift_jnp(
            slm_params[:, 0:1], slm_params[:, 1:2], slm_params[:, 2:3],
            slm_params[:, 3:4], float(self.config.coarse.cf), t[None, :])
        return jnp.where((mode == 1)[:, None], nl, lin).astype(jnp.float32)

    # -- the full device program ------------------------------------------

    def _decode_window_ri(self, ri: jnp.ndarray) -> dict:
        """Device ABI entry: ri is a (2, fl) float32 real/imag pair."""
        return self._decode_window(jax.lax.complex(ri[0], ri[1]))

    def _prefano_ri(self, ri: jnp.ndarray) -> dict:
        return self._prefano(jax.lax.complex(ri[0], ri[1]))

    def _prefano_head_ri(self, ri: jnp.ndarray) -> dict:
        return self._prefano_head(jax.lax.complex(ri[0], ri[1]))

    def _prefano(self, z: jnp.ndarray) -> dict:
        st = self._prefano_head(z)
        if "_t" in st:
            return st
        return self._prefano_tail(st)

    def _prefano_head(self, z: jnp.ndarray) -> dict:
        """Samples -> per-candidate coarse + phase-A + drift-refined state
        (everything the reference runs for *every* candidate before the
        sync1 > minsync1 gate, lib/sync_and_demodulate_impl.cc:443)."""
        z = jnp.asarray(z).astype(jnp.complex64)
        st = self._coarse_stage(z)
        if "_t" in st:
            return st
        pdt = "bf16" if self.config.demod.probe_dtype == "bf16" else "c64"
        return self._refine_common(
            st, probe=lambda center, reach, W, block: make_shared_probe(
                z, center, reach=reach, W=W, block=block, dtype=pdt))

    def _coarse_stage(self, z: jnp.ndarray) -> dict:
        """Samples -> (C,) per-candidate coarse metadata (peak pick +
        drift-model grid scoring + acceptance)."""
        cfg = self.config.coarse
        z = z.astype(jnp.complex64)

        # ---- coarse search ----
        # Column window (r5): nothing downstream ever reads spectrum
        # columns outside the passband plus reach — smoothing needs
        # [m-hpbm-3, m+hpbm+3), the conv grid's A/B powersum planes need
        # [m-hpbm-10, m+hpbm+10) (f_window +/-7 plus the r[f+/-3]
        # stencil) — so the device pipeline computes/keeps only those
        # ~2*hpbm+20 columns (48 of 512 at the narrowband example
        # config). The matmul DFT embeds the sliced cos/sin matrices
        # (identical per-column math, ~10x less matmul work and output
        # bytes); the FFT impl slices after. Degenerates to the
        # full spectrum at wideband (hpbm near m). Peak/candidate bins
        # (if0) stay ABSOLUTE; only ps-indexed calls shift by cb0.
        m = cfg.fft_size // 2
        cb0 = max(0, m - cfg.hpbm - 10)
        cb1 = min(cfg.fft_size, m + cfg.hpbm + 10)
        # "auto" is the config sentinel: unless with_serving_defaults
        # upgraded it to matmul_bf16, it resolves to the f32-exact FFT
        stft_impl = "fft" if cfg.stft_impl == "auto" else cfg.stft_impl
        ps = stft_power(z, n_ffts=cfg.n_ffts, size=cfg.fft_size,
                        hop=cfg.spb // 2, impl=stft_impl,
                        col_window=(cb0, cb1))
        if self.truncate_stage == "post_stft":
            return {"_t": ps.sum()}
        sm = smoothed_snr_spectrum(ps, hpbm=cfg.hpbm, m=m, col0=cb0)
        valid, if0, snr = self._peaks(sm)
        if self.truncate_stage == "post_peaks":
            return {"_t": if0.sum().astype(jnp.float32) + snr.sum()}
        # conv impl: 1-ulp accumulation-order difference from the einsum
        # is irrelevant here (device path already diverges from the CPU
        # oracle via bf16 matmuls).
        # f_window: candidates only gather passband+/-2 columns, so skip
        # scoring the rest of the grid (kernel reach +/-6). Both f_window
        # and if0 are passed in ps-window-relative coordinates; the
        # zero-contribution edge rule applies at absolute column 0/size
        # exactly as before (the window ends there or further out).
        grid_impl = cfg.grid_impl
        if grid_impl == "auto":
            # conv for narrowband; the im2col GEMM for wideband
            grid_impl = "einsum" if cfg.hpbm > 32 else "conv"
        grid_dtype = cfg.grid_dtype
        if grid_dtype == "auto":
            # bf16 halves the wideband im2col copies; f32 for the
            # narrowband conv. Only the "auto" sentinel resolves — an
            # explicit grid_dtype is always honored.
            grid_dtype = "bf16" if grid_impl == "einsum" else "f32"
        syncgrid = coarse_score_grid(
            ps, if0 - cb0, self._offsets, self._sign, impl=grid_impl,
            f_window=(m - cfg.hpbm - 1 - 6 - cb0,
                      m + cfg.hpbm + 1 + 6 - cb0),
            dtype=grid_dtype)
        if self.truncate_stage == "post_grid":
            return {"_t": syncgrid.sum()}
        best, best_idx = select_best(syncgrid, self._is_nl,
                                     threshold=float(cfg.threshold))
        Mdim = self._offsets.shape[0]
        fi = best_idx // (26 * Mdim)
        k0 = (best_idx // Mdim) % 26
        mm = best_idx % Mdim
        m_half = cfg.fft_size // 2
        freq = ((if0 + fi - 2) - m_half) * jnp.float32(cfg.df)
        shift = (128 * k0).astype(jnp.int32)
        mode = jnp.where(jnp.asarray(self._is_nl)[mm], 1, 0).astype(jnp.int32)
        drift = jnp.asarray(self._model_drift)[mm]
        slm_params = jnp.asarray(self._model_slm)[mm]
        if self.truncate_stage == "post_coarse":
            return {"_t": freq.sum() + shift.sum() + snr.sum()
                    + drift.sum()}
        return {
            "valid": valid, "snr": snr, "freq": freq.astype(jnp.float32),
            "shift": shift, "drift": drift, "mode": mode,
            "slm_params": slm_params,
        }

    def _refine_common(self, st: dict, probe) -> dict:
        """Phase A + phase B refinement over (L,) candidate lanes.

        ``probe(center, reach, W, block) -> (Amat (L,162,W), base (L,))``
        builds the shared probe window — make_shared_probe closed over a
        single window's samples (the per-window vmapped path), or
        make_shared_probe_lanes with per-lane window indices (the
        cross-window cand_compact_lanes path). Identical per-lane math
        either way (tests/test_device.py parity).

        ---- staged fine sync (mirrors demod.finesync.FineSync.refine).
        Every pass over a (C, 162, W) derotated window is HBM-bound in W,
        so each stage group gets the narrowest window its probe reach
        allows, and consecutive (lag, freq) stages are evaluated as ONE
        joint grid — the reference's sequential stage order is reproduced
        exactly by *indexing* the joint grid (lag argmax along the
        original-frequency row, then freq argmax along the chosen-lag
        column), since stage k's probes are a subset of the grid."""
        dcfg = self.config.demod
        valid, snr = st["valid"], st["snr"]
        mode, slm_params = st["mode"], st["slm_params"]
        C = valid.shape[0]
        cidx = jnp.arange(C)
        spe = functools.partial(shared_probe_eval, dtype=dcfg.probe_dtype)
        f1 = st["freq"].astype(jnp.float32)
        shift1 = st["shift"]
        drift1 = st["drift"]
        dsym = self._drift_offsets(mode, drift1, slm_params)

        # phase A: window covering the coarse-lag reach (+/-128).
        # block=128 alignment admits W=640 (vs 768 at block=256: the
        # window must absorb reach + alignment slack, 2*128+256+127) —
        # every probe still reads the same masked 256 columns, and the
        # derotation/bank/einsum passes are all ~linear in W.
        # NOTE: W=640 is EXACTLY minimal for this +/-128 lag grid (max
        # window-local probe offset 383 vs the clip bound W-256=384 in
        # shared_probe_eval, zero slack). Widening the lag grid or reach
        # without growing W would be silently clamped into wrong sync
        # correlations — grow W together with any reach change.
        Amat1, base1 = probe(shift1, 128, 640, 128)
        zd1 = probe_derotate(Amat1, dsym)
        lag_grid = shift1[:, None] + jnp.arange(-128, 129, 64)[None, :]
        freq_grid = f1[:, None] + (jnp.arange(-2, 3) * 0.25)[None, :]
        s = spe(zd1, base1, lag_grid.astype(jnp.int32),
                freq_grid.astype(jnp.float32), n_lags=5)          # (C, 5, 5)
        li = jnp.argmax(s[:, 2, :], axis=1)           # stage 0: lag @ f0
        shift1 = lag_grid[cidx, li].astype(jnp.int32)
        fi2 = jnp.argmax(s[cidx, :, li], axis=1)      # stage 1: freq @ lag
        f1 = freq_grid[cidx, fi2].astype(jnp.float32)
        sync1 = s[cidx, fi2, li]
        if self.truncate_stage == "post_phase_a":
            return {"_t": sync1.sum() + f1.sum() + shift1.sum()}

        # phase B: window centered on the refined lag; reach 96 covers the
        # fine-lag (+/-32) and jiggle (+/-64) probes, block=128 alignment
        Amat2, base2 = probe(shift1, 96, 640, 128)
        # drift +/-0.5 probes read a single per-symbol 256-sample window;
        # any candidate's window start b lies in [96, 224), so derotating
        # the static 384-column slice [96, 480) covers every probe at ~60%
        # of the full-width cost per probe
        Amat2d = Amat2[..., 96:480]
        base2d = base2 + 96
        is_lin = mode != 1
        driftp = drift1 + 0.5
        driftm = drift1 - 0.5
        sp = spe(
            probe_derotate(Amat2d, self._drift_offsets(mode, driftp,
                                                       slm_params)),
            base2d, shift1[:, None], f1[:, None], n_lags=1)[:, 0, 0]
        sm_ = spe(
            probe_derotate(Amat2d, self._drift_offsets(mode, driftm,
                                                       slm_params)),
            base2d, shift1[:, None], f1[:, None], n_lags=1)[:, 0, 0]
        updp = is_lin & (sp > sync1)
        updm = is_lin & ~updp & (sm_ > sync1)
        drift1 = jnp.where(updp, driftp, jnp.where(updm, driftm, drift1))
        sync1 = jnp.where(updp, sp, jnp.where(updm, sm_, sync1))
        if self.truncate_stage == "post_head":
            # the sum forces the phase-B window build (gather + overlap
            # rows) at ~one full read of Amat2 — cheap relative to the
            # stages it separates
            force = (jnp.real(Amat2).sum() + jnp.imag(Amat2).sum()
                     if jnp.iscomplexobj(Amat2)
                     else Amat2.astype(jnp.float32).sum())
            return {"_t": sync1.sum() + drift1.sum() + force}
        return {
            "valid": valid, "snr": snr, "freq": f1, "shift": shift1,
            "drift": drift1, "mode": mode, "slm_params": slm_params,
            "sync1": sync1, "worth0": sync1 > dcfg.minsync1,
            "Amat2": Amat2, "base2": base2,
        }

    def _prefano_tail(self, st: dict) -> dict:
        """Post-worth stages (joint fine grid + soft symbols + gates) —
        the part the refine_max_lanes compaction runs on worth lanes only."""
        dcfg = self.config.demod
        C = st["shift"].shape[0]
        cidx = jnp.arange(C)
        spe = functools.partial(shared_probe_eval, dtype=dcfg.probe_dtype)
        valid, snr = st["valid"], st["snr"]
        f1, shift1, drift1 = st["freq"], st["shift"], st["drift"]
        mode, slm_params, sync1 = st["mode"], st["slm_params"], st["sync1"]
        Amat2, base2 = st["Amat2"], st["base2"]
        dsym = self._drift_offsets(mode, drift1, slm_params)
        zd2 = probe_derotate(Amat2, dsym)

        # joint fine (freq x lag) grid; gated stage-order selection
        worth = st["worth0"]
        lag_grid = shift1[:, None] + jnp.arange(-32, 33, 16)[None, :]
        freq_grid = (f1[:, None] + (jnp.arange(-2, 3) * 0.05)[None, :]
                     ).astype(jnp.float32)
        s = spe(zd2, base2, lag_grid.astype(jnp.int32), freq_grid,
                n_lags=5)                                         # (C, 5, 5)
        li = jnp.argmax(s[:, 2, :], axis=1)
        shift1 = jnp.where(worth, lag_grid[cidx, li], shift1).astype(jnp.int32)
        # fine freq evaluates at the post-fine-lag shift: chosen-lag column
        # if the lag update fired, the center column (original shift) if not
        li = jnp.where(worth, li, 2)
        fi2 = jnp.argmax(s[cidx, :, li], axis=1)
        f1 = jnp.where(worth, freq_grid[cidx, fi2], f1).astype(jnp.float32)
        sync1 = jnp.where(worth, s[cidx, fi2, li], sync1)
        worth = worth & valid
        if self.truncate_stage == "post_refine":
            return {"_t": sync1.sum() + f1.sum() + shift1.sum()
                    + drift1.sum()}

        # ---- soft symbols over all jiggles ----
        J = dcfg.n_jiggles
        lag_grid = shift1[:, None] + self._jiggles[None, :]
        sync2, p = spe(zd2, base2, lag_grid.astype(jnp.int32),
                                     f1[:, None], n_lags=J,
                                     want_symbols=True)
        sync2 = sync2[:, 0, :]                                # (C, J)
        p = p[:, 0]                                           # (C, J, 162, 4)
        fsymb = jnp.where(self._sync_bit[None, None, :],
                          p[..., 3] - p[..., 1], p[..., 2] - p[..., 0])
        fsum = fsymb.mean(axis=-1, keepdims=True)
        f2sum = (fsymb * fsymb).mean(axis=-1, keepdims=True)
        fac = jnp.sqrt(f2sum - fsum * fsum)
        scaled = dcfg.symfac * fsymb / jnp.maximum(fac, 1e-12)
        scaled = jnp.clip(jnp.nan_to_num(scaled), -128.0, 127.0)
        symbols = jnp.floor(scaled + 128.0).astype(jnp.uint8)
        y = symbols.astype(jnp.float32) - 128.0
        rms = jnp.sqrt((y * y).mean(axis=-1))                 # (C, J)

        gate = (worth[:, None] & (sync2 > dcfg.minsync2)
                & (rms > dcfg.minrms))                        # (C, J)
        if self.truncate_stage == "pre_fano":
            return {"_t": gate.sum() + symbols.astype(jnp.int32).sum()
                    + rms.sum()}

        deint = (symbols.reshape(C * J, 162)[:, self._perm]
                 .reshape(C, J, 162))                         # uint8
        return {
            "valid": valid, "worth": worth, "freq": f1, "snr": snr,
            "shift": shift1, "drift": drift1, "mode": mode,
            "slm_params": slm_params, "sync2": sync2, "gate": gate,
            "deint": deint,
        }

    def _pack_prefano(self, pre: dict) -> jnp.ndarray:
        """hybrid engine: candidate metadata + gated deinterleaved symbols
        in ONE packed f32 array (one d2h transfer); Fano + first-success
        selection run in _host_fano_assemble.
        layout: 0 valid 1 worth 2 freq 3 snr 4 shift 5 drift 6 mode
                7:11 slm  11:11+J sync2  11+J:11+2J gate
                11+2J:11+(2+162)J deinterleaved symbols  last: overflow"""
        C, J = pre["gate"].shape
        head = jnp.stack([
            pre["valid"].astype(jnp.float32),
            pre["worth"].astype(jnp.float32),
            pre["freq"], pre["snr"], pre["shift"].astype(jnp.float32),
            pre["drift"], pre["mode"].astype(jnp.float32)], axis=-1)
        # refine-lane compaction overflow (worth lanes dropped by the cap,
        # _compact_refine_tail) — the host Fano itself has no lane cap
        ovf = jnp.asarray(pre.get("refine_overflow", 0), jnp.float32)
        return jnp.concatenate(
            [head, pre["slm_params"].astype(jnp.float32), pre["sync2"],
             pre["gate"].astype(jnp.float32),
             pre["deint"].reshape(C, J * 162).astype(jnp.float32),
             jnp.broadcast_to(ovf, (C, 1))], axis=-1)

    def _decode_window(self, z: jnp.ndarray) -> dict:
        pre = self._prefano(z)
        if "_t" in pre:
            return pre
        if self.fano_mode == "host":
            return {"_prefano": self._pack_prefano(pre)}
        return self._fano_select(pre)

    def _fano_select(self, pre: dict) -> dict:
        dcfg = self.config.demod
        C, J = pre["gate"].shape
        cidx = jnp.arange(C)
        valid, worth, gate = pre["valid"], pre["worth"], pre["gate"]
        f1, snr, shift1 = pre["freq"], pre["snr"], pre["shift"]
        drift1, mode, slm_params = pre["drift"], pre["mode"], pre["slm_params"]
        sync2 = pre["sync2"]

        # ---- batched Fano over gated lanes, two phases ----
        # The reference tries jiggled shifts sequentially and stops at the
        # first success (lib/sync_and_demodulate_impl.cc:457-482); almost
        # always jiggle 0 (the refined shift) decodes. A single lockstep
        # batch over all C*J lanes runs as slow as its SLOWEST lane — and
        # the off-by-up-to-64-sample jiggle lanes backtrack far more than
        # the aligned one. So: phase 1 decodes only the jiggle-0 lanes;
        # phase 2 decodes jiggles 1.. solely for candidates phase 1 did
        # not decode (usually none — the while_loop exits immediately).
        # First-success-in-jiggle-order output is preserved exactly.
        deint = pre["deint"].astype(jnp.int32)                # (C, J, 162)

        ML1 = min(dcfg.fano_max_lanes, C)
        gate0 = gate[:, 0]
        sel1 = jnp.argsort(~gate0, stable=True)[:ML1]
        out1 = self._fano_batch(deint[sel1, 0], self._mettab,
                                     gate0[sel1],
                                     maxcycles=dcfg.maxcycles,
                                     delta=dcfg.fano_delta)
        succ0 = jnp.zeros(C, bool).at[sel1].set(out1["success"] & gate0[sel1])
        nbytes = out1["data"].shape[1]
        data0 = jnp.zeros((C, nbytes), jnp.uint8).at[sel1].set(out1["data"])

        if J == 1:
            if self.truncate_stage == "post_fano":
                return {"_t": out1["success"].sum()
                        + out1["data"].astype(jnp.int32).sum()}
            success = succ0[:, None]
            data = data0[:, None]
            fano_overflow = jnp.maximum(gate0.sum() - ML1, 0
                                        ).astype(jnp.int32)
            any_success = succ0
            jbest = jnp.zeros(C, jnp.int32)
            payload = data0[:, :7]
            osd = None
            if self._osd_G is not None:
                any_success, payload, jbest, osd, dropped = self._osd_rescue(
                    pre, deint, any_success, payload, jbest)
                fano_overflow = fano_overflow + dropped.sum().astype(
                    jnp.int32)
            return self._outputs(any_success & worth, payload, f1, snr,
                                 sync2[cidx, jbest], shift1, drift1, mode,
                                 slm_params, jbest, valid, fano_overflow,
                                 gate0.sum().astype(jnp.int32), osd=osd)

        # phase 2: remaining jiggles, masked off where phase 1 succeeded
        R = C * (J - 1)
        ML2 = min(dcfg.fano_max_lanes, R)
        gate_rest = (gate[:, 1:] & ~succ0[:, None]).reshape(R)
        sel2 = jnp.argsort(~gate_rest, stable=True)[:ML2]
        out2 = self._fano_batch(
            deint[:, 1:].reshape(R, 162)[sel2], self._mettab,
            gate_rest[sel2], maxcycles=dcfg.maxcycles,
            delta=dcfg.fano_delta)
        if self.truncate_stage == "post_fano":
            return {"_t": out1["success"].sum() + out2["success"].sum()
                    + out1["data"].astype(jnp.int32).sum()
                    + out2["data"].astype(jnp.int32).sum()}
        succ_rest = jnp.zeros(R, bool).at[sel2].set(
            out2["success"] & gate_rest[sel2])
        data_rest = jnp.zeros((R, nbytes), jnp.uint8).at[sel2].set(
            out2["data"])
        success = jnp.concatenate(
            [succ0[:, None], succ_rest.reshape(C, J - 1)], axis=1)
        data = jnp.concatenate(
            [data0[:, None], data_rest.reshape(C, J - 1, nbytes)], axis=1)

        # observable degradation counter: gated lanes beyond the compacted
        # batches silently report failure — surface how many were dropped
        fano_overflow = (
            jnp.maximum(gate0.sum() - ML1, 0)
            + jnp.maximum(gate_rest.sum() - ML2, 0)).astype(jnp.int32)

        # first success in jiggle order
        any_success = jnp.any(success, axis=1)
        jbest = jnp.argmax(success, axis=1)                   # first True
        payload = data[cidx, jbest, :7]
        osd = None
        if self._osd_G is not None:
            any_success, payload, jbest, osd, dropped = self._osd_rescue(
                pre, deint, any_success, payload, jbest)
            fano_overflow = fano_overflow + dropped.sum().astype(jnp.int32)
        return self._outputs(any_success & worth, payload, f1, snr,
                             sync2[cidx, jbest], shift1, drift1, mode,
                             slm_params, jbest, valid, fano_overflow,
                             gate.sum().astype(jnp.int32), osd=osd)

    def _decode_windows_batched(self, ris: jnp.ndarray, pack: bool = True):
        """(W, 2, fl) windows -> packed (W, C, 23) [device mode] or packed
        prefano (W, C, 11+2J+162J) [hybrid]. The pre-Fano pipeline is
        vmapped over windows (probe einsums carry W*C lanes instead of C);
        gated Fano lanes are compacted per window
        (identical overflow semantics to the per-window path) and decoded
        in ONE cross-window two-phase batch, so the while_loop dispatch
        cost is paid per batch, not per window.

        pack=False (the sharded mesh path) returns the device-mode result
        as the field dict instead of the packed array; hybrid always
        returns the packed prefano (its consumer is _host_fano_assemble
        either way)."""
        dcfg = self.config.demod
        if dcfg.cand_compact_lanes > 0:
            # truncate_stage flows THROUGH the compacted path (stage
            # deltas then attribute the program at the serving operating
            # point, compaction gathers included); the other compactions
            # below keep the historical bypass (their truncated heads
            # predate cand compaction and stay comparable to the
            # round-2 tables).
            pre = self._compact_cand_pre(ris)
        elif dcfg.refine_max_lanes > 0 and not self.truncate_stage:
            head = jax.vmap(self._prefano_head_ri)(ris)
            pre = self._compact_refine_tail(head)
        else:
            pre = jax.vmap(self._prefano_ri)(ris)
        if "_t" in pre:                     # truncated profiling program
            return pre["_t"].sum()
        if self.fano_mode == "host":
            return jax.vmap(self._pack_prefano)(pre)
        out = self._fano_select_batch(pre)
        return self._pack(out) if pack else out

    def _compact_refine_tail(self, head: dict) -> dict:
        """Cross-window compaction of the post-worth refine stages.

        The reference runs the fine lag/freq refinement and the Fano retry
        loop only for candidates with sync1 > 0.10
        (lib/sync_and_demodulate_impl.cc:443) — typically 1 of C per
        window. The lockstep batch cannot skip lanes, but it can *compact*
        them: gather the worth lanes of every window into one
        (refine_max_lanes,)-lane batch, run the joint fine grid + soft
        symbols there, and scatter the results back. Worth lanes beyond
        the cap degrade gracefully (reported undecoded) and surface in the
        per-window fano_overflow counter, like the Fano lane cap."""
        dcfg = self.config.demod
        W, C = head["sync1"].shape
        J = dcfg.n_jiggles
        ML = min(dcfg.refine_max_lanes, W * C)
        worthy = head["worth0"] & head["valid"]                 # (W, C)
        flat = worthy.reshape(W * C)
        sel = jnp.argsort(~flat, stable=True)[:ML]

        sub = {k: head[k].reshape((W * C,) + head[k].shape[2:])[sel]
               for k in ("valid", "snr", "freq", "shift", "drift", "mode",
                         "slm_params", "sync1", "Amat2", "base2")}
        sub["worth0"] = flat[sel]     # padding lanes (if < ML worthy) stay
                                      # unworthy: no updates, gate False
        tail = self._prefano_tail(sub)

        def scatter(base_flat, vals):
            return base_flat.at[sel].set(vals).reshape((W, C) + vals.shape[1:])

        zeros = jnp.zeros
        selmask = jnp.zeros(W * C, bool).at[sel].set(True)
        return {
            "valid": head["valid"], "snr": head["snr"],
            "mode": head["mode"], "slm_params": head["slm_params"],
            "drift": head["drift"],
            "worth": scatter(jnp.zeros(W * C, bool), tail["worth"]),
            "freq": scatter(head["freq"].reshape(W * C), tail["freq"]),
            "shift": scatter(head["shift"].reshape(W * C), tail["shift"]),
            "sync2": scatter(zeros((W * C, J), jnp.float32), tail["sync2"]),
            "gate": scatter(zeros((W * C, J), bool), tail["gate"]),
            "deint": scatter(zeros((W * C, J, 162), jnp.uint8),
                             tail["deint"]),
            # worth lanes dropped by the cap, per window
            "refine_overflow": (worthy & ~selmask.reshape(W, C))
            .sum(axis=1).astype(jnp.int32),
        }

    def _compact_cand_pre(self, ris: jnp.ndarray) -> dict:
        """Cross-window CANDIDATE compaction: coarse search on every
        window, then phase A/B + the post-worth tail on only the valid
        candidate lanes gathered across the window batch.

        This is the wideband fast path: the reference default carries
        maxfreqs=200 static candidate slots per window
        (grc/uwspr_FDR.xml:31-36) of which only the
        ratio-acceptance-passing few are real, and every refine pass is
        ~linear in static lanes. Gathering the valid
        lanes of all windows into one (cand_compact_lanes,) batch via
        make_shared_probe_lanes prices refine by the ACCEPTED candidate
        count. Valid lanes beyond the cap (weakest coarse SNR first) are
        dropped observably via refine_overflow. Per-lane results are
        identical to the uncompacted path for every selected lane."""
        dcfg = self.config.demod
        z_all = jax.lax.complex(ris[:, 0], ris[:, 1]).astype(jnp.complex64)
        coarse = jax.vmap(self._coarse_stage)(z_all)          # (W, C) fields
        if "_t" in coarse:                  # truncated profiling program
            return {"_t": coarse["_t"].sum()}
        W, C = coarse["valid"].shape
        J = dcfg.n_jiggles
        ML = min(dcfg.cand_compact_lanes, W * C)
        flat = {k: v.reshape((W * C,) + v.shape[2:])
                for k, v in coarse.items()}
        # keep every valid lane when they fit; under overflow drop the
        # weakest coarse-SNR lanes first
        key = jnp.where(flat["valid"], -flat["snr"], jnp.inf)
        sel = jnp.argsort(key, stable=True)[:ML]
        widx = (sel // C).astype(jnp.int32)
        st = {k: v[sel] for k, v in flat.items()}
        pdt = "bf16" if dcfg.probe_dtype == "bf16" else "c64"
        head = self._refine_common(
            st, probe=lambda center, reach, Wp, block:
            make_shared_probe_lanes(z_all, widx, center, reach=reach,
                                    W=Wp, block=block, dtype=pdt))
        if "_t" in head:                    # truncated profiling program
            return head

        # post-worth tail on the compacted lanes (sub-compacted further if
        # refine_max_lanes is set and smaller)
        worthy = head["worth0"] & head["valid"]               # (ML,)
        ML2 = (min(dcfg.refine_max_lanes, ML)
               if dcfg.refine_max_lanes > 0 else ML)
        sel2 = jnp.argsort(~worthy, stable=True)[:ML2]
        sub = {k: head[k][sel2]
               for k in ("valid", "snr", "freq", "shift", "drift", "mode",
                         "slm_params", "sync1", "Amat2", "base2")}
        sub["worth0"] = worthy[sel2]
        tail = self._prefano_tail(sub)
        if "_t" in tail:                    # truncated profiling program
            return tail
        gsel = sel[sel2]              # global (W*C) indices of tail lanes

        def scat(base_flat, vals):
            return (base_flat.at[gsel].set(vals)
                    .reshape((W, C) + vals.shape[1:]))

        zeros = jnp.zeros
        # refined freq/shift/drift for every selected lane (phase A/B),
        # then the fine-grid updates for the tail lanes on top — matching
        # the uncompacted path lane-for-lane on all selected lanes
        freq = flat["freq"].at[sel].set(head["freq"])
        shift = flat["shift"].at[sel].set(head["shift"])
        drift = flat["drift"].at[sel].set(head["drift"])
        kept = jnp.zeros(W * C, bool).at[sel].set(True)
        tailed = jnp.zeros(ML, bool).at[sel2].set(True)
        worth_dropped = jnp.zeros(W * C, bool).at[sel].set(worthy & ~tailed)
        overflow = ((flat["valid"] & ~kept).reshape(W, C).sum(axis=1)
                    + worth_dropped.reshape(W, C).sum(axis=1)
                    ).astype(jnp.int32)
        return {
            "valid": coarse["valid"], "snr": coarse["snr"],
            "mode": coarse["mode"], "slm_params": coarse["slm_params"],
            "drift": drift.reshape(W, C),
            "worth": scat(zeros(W * C, bool), tail["worth"]),
            "freq": scat(freq, tail["freq"]),
            "shift": scat(shift, tail["shift"]),
            "sync2": scat(zeros((W * C, J), jnp.float32), tail["sync2"]),
            "gate": scat(zeros((W * C, J), bool), tail["gate"]),
            "deint": scat(zeros((W * C, J, 162), jnp.uint8), tail["deint"]),
            "refine_overflow": overflow,
        }

    def _compact_fano(self, gate_flat: jnp.ndarray, deint_flat: jnp.ndarray,
                      cap: int):
        """Gated lanes anywhere in the flat batch -> compacted Fano
        batches of ``cap`` lanes (the cross-window analogue of the
        per-window fano_max_lanes gather). The lockstep decoder pays its
        branch-metric matmul and while-loop state for every static lane,
        active or not, so shrinking W*C (or W*C*(J-1)) lanes to the few
        actually-gated ones is nearly free throughput.

        EVERY gated lane is decoded (r5): when more than ``cap`` lanes
        are gated — the deep-SNR case, where jiggle-retry populations
        exceed the serving-sized cap — a bounded lax.while_loop walks
        the gated-first lane ordering in ``cap``-sized chunks until all
        gated lanes are done, instead of silently dropping the tail.
        This matches the reference's never-drop retry loop
        (lib/sync_and_demodulate_impl.cc:457-482); ``cap`` is now purely
        a throughput knob (chunk width), not a correctness cliff. At the
        serving steady state (~1 gated lane/window) the loop body runs
        once — identical cost to the old single pass — and an all-idle
        batch skips the Fano entirely.

        Returns (success (N,), data (N, nbytes), dropped (N,) bool);
        ``dropped`` is always all-False now and kept only so callers'
        overflow accounting (which still observes refine/cand compaction
        drops) stays uniform."""
        dcfg = self.config.demod
        N = gate_flat.shape[0]
        FL = min(cap, N)
        sel_all = jnp.argsort(~gate_flat, stable=True)      # gated first
        n_gated = gate_flat.sum()

        # state layout without running the decoder: abstract-eval only
        shapes = jax.eval_shape(
            lambda d, g: self._fano_batch(d, self._mettab, g,
                                          maxcycles=dcfg.maxcycles,
                                          delta=dcfg.fano_delta),
            jax.ShapeDtypeStruct((FL, 162), deint_flat.dtype),
            jax.ShapeDtypeStruct((FL,), jnp.bool_))
        nbytes = shapes["data"].shape[1]

        def cond(state):
            return state[0] * FL < n_gated

        def body(state):
            i, succ, data = state
            # the final chunk clamps into the tail: its overlap re-decodes
            # a few already-done lanes with identical results (the scatter
            # overwrites equal values), never skips a gated one
            start = jnp.minimum(i * FL, N - FL)
            sel = jax.lax.dynamic_slice_in_dim(sel_all, start, FL)
            g = gate_flat[sel]
            out = self._fano_batch(deint_flat[sel], self._mettab, g,
                                   maxcycles=dcfg.maxcycles,
                                   delta=dcfg.fano_delta)
            succ = succ.at[sel].set(out["success"] & g)
            data = data.at[sel].set(out["data"])
            return i + 1, succ, data

        init = (jnp.int32(0), jnp.zeros(N, bool),
                jnp.zeros((N, nbytes), shapes["data"].dtype))
        _, succ, data = jax.lax.while_loop(cond, body, init)
        return succ, data, jnp.zeros(N, bool)

    def _fano_select_batch(self, pre: dict) -> dict:
        dcfg = self.config.demod
        W, C, J = pre["gate"].shape
        widx = jnp.arange(W)[:, None]
        cidx = jnp.arange(C)[None, :]
        gate = pre["gate"]
        deint = pre["deint"].astype(jnp.int32)               # (W, C, J, 162)
        compact = dcfg.fano_compact_lanes

        # phase 1: jiggle-0 lanes of every window, one flat batch
        gate0 = gate[:, :, 0]                                # (W, C)
        if compact > 0:
            succ0f, data0f, drop1 = self._compact_fano(
                gate0.reshape(W * C), deint[:, :, 0].reshape(W * C, 162),
                compact)
            succ0 = succ0f.reshape(W, C)
            nbytes = data0f.shape[-1]
            data0 = data0f.reshape(W, C, nbytes)
            overflow0 = (drop1.reshape(W, C).sum(axis=1)
                         + pre.get("refine_overflow",
                                   jnp.zeros(W, jnp.int32)))
        else:
            ML1 = min(dcfg.fano_max_lanes, C)
            sel1 = jnp.argsort(~gate0, axis=1, stable=True)[:, :ML1]
            g1 = jnp.take_along_axis(gate0, sel1, axis=1)    # (W, ML1)
            d1 = deint[widx, sel1, 0]                        # (W, ML1, 162)
            out1 = self._fano_batch(d1.reshape(W * ML1, 162),
                                         self._mettab, g1.reshape(W * ML1),
                                         maxcycles=dcfg.maxcycles,
                                         delta=dcfg.fano_delta)
            succ1 = out1["success"].reshape(W, ML1) & g1
            nbytes = out1["data"].shape[1]
            data1 = out1["data"].reshape(W, ML1, nbytes)
            succ0 = jnp.zeros((W, C), bool).at[widx, sel1].set(succ1)
            data0 = (jnp.zeros((W, C, nbytes), jnp.uint8)
                     .at[widx, sel1].set(data1))
            overflow0 = (jnp.maximum(gate0.sum(axis=1) - ML1, 0)
                         + pre.get("refine_overflow",
                                   jnp.zeros(W, jnp.int32)))

        if J == 1:
            fano_overflow = overflow0.astype(jnp.int32)
            any_success = succ0
            jbest = jnp.zeros((W, C), jnp.int32)
            payload = data0[:, :, :7]
        else:
            # phase 2: remaining jiggles where phase 1 failed, one batch
            R = C * (J - 1)
            gate_rest = (gate[:, :, 1:] & ~succ0[:, :, None]).reshape(W, R)
            if compact > 0:
                succrf, datarf, drop2 = self._compact_fano(
                    gate_rest.reshape(W * R),
                    deint[:, :, 1:].reshape(W * R, 162), compact)
                succ_rest = succrf.reshape(W, R)
                data_rest = datarf.reshape(W, R, nbytes)
                over2 = drop2.reshape(W, R).sum(axis=1)
            else:
                ML2 = min(dcfg.fano_max_lanes, R)
                sel2 = jnp.argsort(~gate_rest, axis=1, stable=True)[:, :ML2]
                g2 = jnp.take_along_axis(gate_rest, sel2, axis=1)
                drest = deint[:, :, 1:].reshape(W, R, 162)
                d2 = drest[widx, sel2]                       # (W, ML2, 162)
                out2 = self._fano_batch(d2.reshape(W * ML2, 162),
                                             self._mettab,
                                             g2.reshape(W * ML2),
                                             maxcycles=dcfg.maxcycles,
                                             delta=dcfg.fano_delta)
                succ2 = out2["success"].reshape(W, ML2) & g2
                data2 = out2["data"].reshape(W, ML2, nbytes)
                succ_rest = jnp.zeros((W, R), bool).at[widx, sel2].set(succ2)
                data_rest = (jnp.zeros((W, R, nbytes), jnp.uint8)
                             .at[widx, sel2].set(data2))
                over2 = jnp.maximum(gate_rest.sum(axis=1) - ML2, 0)
            success = jnp.concatenate(
                [succ0[:, :, None], succ_rest.reshape(W, C, J - 1)], axis=2)
            data = jnp.concatenate(
                [data0[:, :, None],
                 data_rest.reshape(W, C, J - 1, nbytes)], axis=2)
            fano_overflow = (overflow0 + over2).astype(jnp.int32)
            any_success = jnp.any(success, axis=2)
            jbest = jnp.argmax(success, axis=2)              # first True
            payload = data[widx, cidx, jbest][..., :7]
        osd = None
        if self._osd_G is not None:
            any_success, payload, jbest, osd, dropped = self._osd_rescue(
                pre, deint, any_success, payload, jbest)
            fano_overflow = fano_overflow + dropped.sum(axis=-1).astype(
                jnp.int32)
        sync = pre["sync2"][widx, cidx, jbest]
        return self._outputs(any_success & pre["worth"], payload,
                             pre["freq"], pre["snr"], sync, pre["shift"],
                             pre["drift"], pre["mode"], pre["slm_params"],
                             jbest, pre["valid"], fano_overflow,
                             gate.sum(axis=(1, 2)).astype(jnp.int32),
                             osd=osd)

    @staticmethod
    def _outputs(success, payload, freq, snr, sync, shift, drift, mode,
                 slm_params, jbest, valid, fano_overflow,
                 fano_attempts, osd=None) -> dict:
        return {
            "success": success,
            "payload": payload,
            "freq": freq,
            "snr": snr,
            "sync": sync,
            "shift": shift,
            "drift": drift,
            "mode": mode,
            "slm_params": slm_params,
            "jiggle": jbest.astype(jnp.int32),
            "valid": valid,
            "fano_overflow": fano_overflow,
            "fano_attempts": fano_attempts,
            "osd": jnp.zeros_like(jbest, dtype=jnp.int32)
            if osd is None else osd.astype(jnp.int32),
        }

    def _osd_rescue(self, pre: dict, deint: jnp.ndarray,
                    any_success: jnp.ndarray, payload: jnp.ndarray,
                    jbest: jnp.ndarray):
        """On-device OSD fallback (fec/osd_jax.py): worth candidates whose
        gated Fano lanes ALL failed get an order-<=4 ordered-statistics
        decode of their TWO most-synced gated jiggle lanes. Failed lanes
        across the whole batch are compacted to DemodConfig.osd_max_lanes
        (the deep-SNR tail is sparse); lanes beyond the cap degrade
        gracefully (no rescue) and surface in the returned dropped mask.

        Acceptance (calibrated, OSD_CALIB*.json): quality >=
        osd_min_quality AND (margin >= osd_min_margin, OR the two lanes'
        payloads AGREE and margin >= osd_margin_agree) — wrong codewords
        fit one noisy demodulation but not two independently jiggled
        ones (0/31 order-3 wrong decodes agreed in calibration), and
        when deeper searches do replicate a wrong codeword across
        correlated lanes the landscape is flat (margin <= 0.0105).
        Protocol unpacking still re-screens device-OSD spots at egress.

        Shapes: pre fields (..., C[, J]); returns (any_success, payload,
        jbest, osd, dropped) with the same leading shape."""
        import functools
        import operator

        from uwspr_tpu.fec.osd_jax import bits_to_payload, osd2_decode_jax

        dcfg = self.config.demod
        gate, worth, sync2 = pre["gate"], pre["worth"], pre["sync2"]
        lead = gate.shape[:-1]                  # (..., C)
        J = gate.shape[-1]
        L = functools.reduce(operator.mul, lead, 1)
        gate_f = gate.reshape(L, J)
        fail = (worth.reshape(L) & gate_f.any(-1)
                & ~any_success.reshape(L))                      # (L,)
        skey = jnp.where(gate_f, sync2.reshape(L, J), -jnp.inf)
        jsel = jnp.argmax(skey, axis=-1)                        # (L,)
        skey2 = skey.at[jnp.arange(L), jsel].set(-jnp.inf)
        jsel2 = jnp.argmax(skey2, axis=-1)      # 2nd-best gated lane
        has2 = gate_f.sum(axis=-1) >= 2
        deint_f = deint.reshape(L, J, 162)
        soft = jnp.take_along_axis(
            deint_f, jsel[:, None, None], axis=1)[:, 0]
        soft2 = jnp.take_along_axis(
            deint_f, jsel2[:, None, None], axis=1)[:, 0]

        ML = min(dcfg.osd_max_lanes, L)
        order = min(dcfg.osd_depth, 4)
        sel = jnp.argsort(~fail, stable=True)[:ML]
        lanes = jnp.concatenate(
            [soft[sel], soft2[sel]]).astype(jnp.float32)        # (2ML, 162)
        uu, qq, mm, _ = jax.vmap(
            lambda s: osd2_decode_jax(s, self._osd_G, order))(lanes)
        u, u2 = uu[:ML], uu[ML:]
        q, m = qq[:ML], mm[:ML]
        agree = jnp.all(u == u2, axis=-1) & has2[sel]
        ok = (fail[sel] & (q >= dcfg.osd_min_quality)
              & ((m >= dcfg.osd_min_margin)
                 | (agree & (m >= dcfg.osd_margin_agree))))
        pl = bits_to_payload(u)                                 # (ML, 7)

        pay_f = payload.reshape(L, payload.shape[-1])
        pay_f = pay_f.at[sel].set(
            jnp.where(ok[:, None], pl[:, :pay_f.shape[-1]], pay_f[sel]))
        jb_f = jbest.reshape(L)
        jb_f = jb_f.at[sel].set(
            jnp.where(ok, jsel[sel].astype(jb_f.dtype), jb_f[sel]))
        acc = jnp.zeros(L, bool).at[sel].set(ok)
        osd = jnp.zeros(L, jnp.int32).at[sel].set(
            jnp.where(ok, order, 0))
        dropped = fail & ~jnp.zeros(L, bool).at[sel].set(True)
        return ((any_success.reshape(L) | acc).reshape(lead),
                pay_f.reshape(payload.shape), jb_f.reshape(lead),
                osd.reshape(lead), dropped.reshape(lead))

    def _host_fano_assemble(self, a: np.ndarray) -> DeviceDecoderOutput:
        """Packed prefano (..., C, 11+2J+162J) -> Fano on the host (native
        C++ backend, per-lane early exit) -> typed output identical in
        semantics to the all-device path (first success in jiggle order)."""
        from uwspr_tpu.fec import fano_decode_batch

        dcfg = self.config.demod
        a = np.asarray(a)
        C, J = self.n_cand, dcfg.n_jiggles
        lead = a.shape[:-2]
        flat = a.reshape(-1, C, a.shape[-1])
        W = flat.shape[0]
        valid = flat[..., 0] > 0.5
        worth = flat[..., 1] > 0.5
        freq = flat[..., 2].astype(np.float32)
        snr = flat[..., 3].astype(np.float32)
        shift = flat[..., 4].astype(np.int32)
        drift = flat[..., 5].astype(np.float32)
        mode = flat[..., 6].astype(np.int32)
        slm = flat[..., 7:11].astype(np.float32)
        sync2 = flat[..., 11:11 + J].astype(np.float32)       # (W, C, J)
        gate = flat[..., 11 + J:11 + 2 * J] > 0.5
        deint = (flat[..., 11 + 2 * J:11 + (2 + 162) * J]
                 .reshape(W, C, J, 162).astype(np.uint8))
        refine_overflow = flat[..., 0, -1].astype(np.int32)   # (W,)

        # Two phases, like the device path: the jiggle-0 lane almost always
        # decodes, and the off-by-up-to-64-sample jiggle lanes backtrack far
        # more (each can burn the full cycle budget at deep SNR) — so decode
        # jiggle-0 lanes first and the remaining jiggles only for candidates
        # whose jiggle-0 lane failed. First-success-in-jiggle-order output
        # is unchanged: a jiggle-0 success always wins the argmax below.
        succ0, data0, _, _, _ = fano_decode_batch(
            deint[:, :, 0].reshape(-1, 162), self._mettab,
            gate[:, :, 0].reshape(-1), backend=self.config.fano_backend,
            delta=dcfg.fano_delta, maxcycles=dcfg.maxcycles)
        succ0 = (succ0.reshape(W, C) & gate[:, :, 0])
        nbytes = data0.shape[-1]
        success = succ0[:, :, None]
        data = data0.reshape(W, C, 1, nbytes)
        if J > 1:
            gate_rest = gate[:, :, 1:] & ~succ0[:, :, None]
            succr, datar, _, _, _ = fano_decode_batch(
                deint[:, :, 1:].reshape(-1, 162), self._mettab,
                gate_rest.reshape(-1), backend=self.config.fano_backend,
                delta=dcfg.fano_delta, maxcycles=dcfg.maxcycles)
            success = np.concatenate(
                [success, succr.reshape(W, C, J - 1) & gate_rest], axis=2)
            data = np.concatenate(
                [data, datar.reshape(W, C, J - 1, nbytes)], axis=2)

        any_s = success.any(axis=-1)
        jbest = np.argmax(success, axis=-1).astype(np.int32)  # first True
        wi, ci = np.indices((W, C))
        payload = data[wi, ci, jbest, :7]

        # OSD fallback (deep-SNR): candidates whose gated lanes all failed
        # Fano get an ordered-statistics decode of their two best gated
        # lanes; acceptance = cross-jiggle agreement OR list-decoding
        # margin (calibrated, fec/osd.py module doc) + unpack screen
        osd = np.zeros((W, C), np.int32)
        if dcfg.osd_depth > 0:
            from uwspr_tpu.fec.osd import accept_osd
            from uwspr_tpu.protocol.messages import unpack_message
            for w, c in zip(*np.nonzero(worth & ~any_s & gate.any(axis=-1))):
                j, pl = accept_osd(deint[w, c], gate[w, c], sync2[w, c],
                                   dcfg)
                if pl is None or unpack_message(pl) is None:
                    continue
                any_s[w, c] = True
                payload[w, c] = np.frombuffer(pl, np.uint8)
                jbest[w, c] = j
                osd[w, c] = dcfg.osd_depth

        return DeviceDecoderOutput(
            success=(any_s & worth).reshape(*lead, C),
            payload=payload.reshape(*lead, C, 7),
            freq=freq.reshape(*lead, C),
            snr=snr.reshape(*lead, C),
            sync=sync2[wi, ci, jbest].reshape(*lead, C),
            shift=shift.reshape(*lead, C),
            drift=drift.reshape(*lead, C),
            mode=mode.reshape(*lead, C),
            slm_params=slm.reshape(*lead, C, 4),
            jiggle=jbest.reshape(*lead, C),
            valid=valid.reshape(*lead, C),
            # the host Fano has no lane cap; only refine-lane compaction
            # (if enabled) can drop worth lanes
            fano_overflow=refine_overflow.reshape(lead),
            fano_attempts=gate.sum(axis=(1, 2)).astype(np.int32)
            .reshape(lead),
            osd=osd.reshape(*lead, C),
        )

    def __call__(self, z: np.ndarray) -> DeviceDecoderOutput:
        from uwspr_tpu.demod.finesync import complex_to_ri
        out = np.asarray(self.decode_window_ri(
            jnp.asarray(complex_to_ri(z))))
        if self.fano_mode == "host":
            return self._host_fano_assemble(out)
        return self.unpack_output(out)

    def decode_batch(self, zs: np.ndarray) -> DeviceDecoderOutput:
        """(W, fl) complex windows -> batched output (leading axis W)."""
        from uwspr_tpu.demod.finesync import complex_to_ri
        ri = np.stack([complex_to_ri(z) for z in np.asarray(zs)])
        return self.decode_ri_batch(ri)

    def decode_ri_batch(self, ri: np.ndarray) -> DeviceDecoderOutput:
        """(W, 2, fl) float32 windows -> typed output, honoring fano_mode."""
        out = np.asarray(self.decode_windows_ri(jnp.asarray(ri)))
        if self.fano_mode == "host":
            return self._host_fano_assemble(out)
        return self.unpack_output(out)

    def messages(self, out: DeviceDecoderOutput, hashtable=None) -> list[str]:
        from uwspr_tpu.protocol.messages import unpack_message
        msgs = []
        for c in np.flatnonzero(out.success):
            u = unpack_message(bytes(out.payload[c]), hashtable)
            if u is not None:
                msgs.append(u.text)
        return msgs

    def spots(self, out: DeviceDecoderOutput, hashtable=None) -> list:
        """DeviceDecoderOutput -> list[pipeline.decoder.Spot] (host unpack).

        On-device OSD candidates whose payload fails protocol unpacking
        are dropped here — the authoritative false-decode screen the jit
        program cannot apply (matching the host engines' acceptance,
        pipeline/decoder._osd_fallback)."""
        from uwspr_tpu.pipeline.decoder import Spot
        from uwspr_tpu.protocol.messages import unpack_message
        spots = []
        for c in np.flatnonzero(out.success):
            payload = bytes(out.payload[c])
            u = unpack_message(payload, hashtable)
            if u is None and int(out.osd[c]) > 0:
                continue
            spots.append(Spot(
                message=u.text if u is not None else "",
                payload=payload,
                freq=float(out.freq[c]),
                snr=float(out.snr[c]),
                sync=float(out.sync[c]),
                shift=int(out.shift[c]),
                drift=float(out.drift[c]),
                mode=int(out.mode[c]),
                slm_params=tuple(np.asarray(out.slm_params[c], float))
                if int(out.mode[c]) else (),
                candidate=int(c),
                jiggle=int(out.jiggle[c]),
                unpacked=u,
                osd=int(out.osd[c]),
            ))
        return spots


__all__ = ["DeviceDecoder", "DeviceDecoderOutput"]
