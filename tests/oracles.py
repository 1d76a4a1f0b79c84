"""Slow NumPy oracles implementing the reference block semantics loop-by-loop.

These mirror the *behavior* of the reference C++ (cited per function) as
directly as possible, trading speed for obviousness, and are used to verify
the device implementations.
"""

import numpy as np

from uwspr_tpu.config import CoarseConfig
from uwspr_tpu.models import slm
from uwspr_tpu.protocol.constants import SYNC_VECTOR


def stft_power_oracle(z: np.ndarray, cfg: CoarseConfig) -> np.ndarray:
    """lib/FDR_impl.cc:222-254."""
    size = cfg.fft_size
    n = cfg.n_ffts
    w = np.sin(np.pi / (size - 1) * np.arange(size))
    ps = np.empty((n, size), dtype=np.float64)
    for i in range(n):
        seg = z[i * (cfg.spb // 2): i * (cfg.spb // 2) + size] * w
        F = np.fft.fft(seg)
        for j in range(size):
            k = (j + cfg.spb) % size
            ps[i, j] = abs(F[k]) ** 2
    return ps


def smoothed_oracle(ps: np.ndarray, cfg: CoarseConfig) -> np.ndarray:
    """lib/FDR_impl.cc:257-291."""
    size = cfg.fft_size
    m = size // 2
    hpbm = cfg.hpbm
    finpb = 2 * hpbm
    psavg = ps.sum(axis=0)
    sm = np.zeros(finpb)
    for i in range(finpb):
        for j in range(-3, 4):
            k = m - hpbm + i + j
            if 0 <= k < size:
                sm[i] += psavg[k]
    srt = np.sort(sm)
    noise = srt[int(np.floor(0.3 * finpb))]
    sm = sm / noise - 1.0
    min_snr = 10 ** (-7.0 / 10.0)
    sm[sm < min_snr] = 0.1 * min_snr
    return sm


def coarse_search_oracle(z: np.ndarray, cfg: CoarseConfig):
    """Full FDR transform (lib/FDR_impl.cc:214-456). Returns a list of dicts."""
    size = cfg.fft_size
    m = size // 2
    hpbm = cfg.hpbm
    df = cfg.df
    ps = stft_power_oracle(z, cfg)
    sm = smoothed_oracle(ps, cfg)
    finpb = 2 * hpbm
    # peak picking in ascending frequency order, capped
    cands = []
    for j in range(1, finpb - 1):
        if sm[j] > sm[j - 1] and sm[j] > sm[j + 1] and len(cands) < cfg.maxfreqs:
            cands.append({
                "freq": (j - hpbm) * df,
                "snr": 10 * np.log10(sm[j]),
            })
    # stable bubble sort by SNR descending
    cands.sort(key=lambda c: -c["snr"])
    rt = np.sqrt(ps)
    sign = 2.0 * SYNC_VECTOR.astype(np.float64) - 1.0
    k = np.arange(162)
    t_sec = (k * 111) // 162
    trajs = slm.TRAJECTORIES

    def powergrid(ifd_arr, k0):
        """Vectorized sum over symbols of the powersum() terms."""
        kidx = k0 + 2 * k
        p0 = rt[kidx, ifd_arr - 3]
        p1 = rt[kidx, ifd_arr - 1]
        p2 = rt[kidx, ifd_arr + 1]
        p3 = rt[kidx, ifd_arr + 3]
        ss = (sign * ((p1 + p3) - (p0 + p2))).sum()
        pw = (p0 + p1 + p2 + p3).sum()
        return np.float32(ss), np.float32(pw)

    for c in cands:
        c["sync"] = -1e30
        if0 = int(np.float32(c["freq"] / df + m))  # float round-trip as in C
        for ifr in range(if0 - 2, if0 + 3):
            for k0 in range(26):
                for drift in range(-cfg.maxdrift, cfg.maxdrift + 1):
                    x = (k - 81.0) / 81.0 * drift / (2.0 * df)
                    ifd = np.floor(ifr + x).astype(np.int64)
                    ss, pw = powergrid(ifd, k0)
                    sync = np.float32(ss / pw)
                    if sync > c["sync"]:
                        c.update(shift=128 * k0, freq=(ifr - m) * df,
                                 sync=sync, mode=0, drift=float(drift))
                if cfg.search_nonlinear:
                    for (v1, v2, p1_, p2_) in trajs:
                        d = slm.slm_frequency_drift(v1, v2, p1_, p2_,
                                                    cfg.cf, t_sec)
                        ifd = np.floor(
                            ifr + d.astype(np.float32) / np.float32(df)
                        ).astype(np.int64)
                        ss, pw = powergrid(ifd, k0)
                        sync = np.float32(ss / pw)
                        if sync / c["sync"] > cfg.threshold:
                            c.update(shift=128 * k0, freq=(ifr - m) * df,
                                     sync=sync, mode=1,
                                     slm=(v1, v2, p1_, p2_))
    return cands
