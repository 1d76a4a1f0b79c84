"""On-device ordered-statistics decoding (order <= 4) as one XLA program.

The host OSD (fec/osd.py) gives the hybrid/host engines their deep-SNR
fallback; this module is the same algorithm restructured for the device so
the all-device and sharded-mesh engines can apply it without host round
trips. The reference (michelbarbeau/gr-uwspr) has only the Fano decoder.

Structure (everything fixed-shape, vmappable over failed lanes):

- reliability sort: one argsort over the 162 soft symbols;
- most-reliable information set: greedy GF(2) row basis — instead of the
  host's per-row elimination walk (162 x 50 sequential steps), 50 rounds
  of full-column elimination: each round pivots on the FIRST (most
  reliable) still-unselected nonzero row and eliminates its leading
  column everywhere, which selects exactly the greedy independent set;
- (50, 50) GF(2) inversion: 50 Gauss-Jordan rounds;
- candidate scoring: the order-1/order-2 flip search is two small dense
  matmuls, identical to the host formulation (fec/osd.py:134-151);
  order 3 scores all C(50,3) triples at once via one (K,K,K) tensor —
  inclusion-exclusion over the XOR of three codeword deltas:
  score(p,q,r) = s0 + w_p+w_q+w_r - 2(M2_pq+M2_pr+M2_qr) + 4*T_pqr with
  T = einsum(s, D, D, D) — 0.5 MB, trivial for the device, vs the host's
  sequential 19,600-candidate walk.

GF(2) products use int32 matmuls (exact: inner dim <= 162) masked with
& 1. The f32 score contractions run at HIGHEST precision so the GPU's
matmul units do not round them to TF32 (the argmin tie-breaks must match
the host's).

Acceptance (calibrated in scripts/osd_calibrate.py / OSD_CALIB.json):
the decoder also returns the LIST-DECODING MARGIN — (2nd-best candidate
score - best score) / total reliability. On wrong decodes the candidate
landscape is flat (measured max wrong-decode margin 0.017 at -30..-32 dB)
while true rescues usually separate; callers combine
``margin >= DemodConfig.osd_min_margin`` with cross-jiggle payload
agreement (two independently demodulated lanes of the same candidate
decoding to the SAME payload — 0/31 wrong decodes agreed in calibration
vs 11/13 correct). The host engines apply the same rule plus the
protocol-unpack screen, which still re-screens device spots at egress.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST

N, K = 162, 50


def _basis_select(Gp: jnp.ndarray) -> jnp.ndarray:
    """First K linearly independent rows of the reliability-ordered
    generator Gp (N, K) int32 {0,1} — greedy in row order, as a (K,)
    index vector (ascending row order, matching fec/osd._gf2_basis)."""
    rows = jnp.arange(N)

    def step(_, st):
        R, selected = st
        nonzero = (R.sum(axis=1) > 0) & ~selected
        i = jnp.argmax(nonzero)               # first unselected nonzero row
        row = R[i]
        c = jnp.argmax(row)                   # its leading column
        elim = (R[:, c] > 0) & (rows != i)
        R = jnp.where(elim[:, None], R ^ row[None, :], R)
        return R, selected.at[i].set(True)

    _, selected = jax.lax.fori_loop(
        0, K, step, (Gp, jnp.zeros(N, bool)))
    return jnp.argsort(~selected, stable=True)[:K]


def _gf2_inv(A: jnp.ndarray) -> jnp.ndarray:
    """Inverse of an invertible (K, K) GF(2) matrix, int32 {0,1}."""
    rows = jnp.arange(K)
    M = jnp.concatenate([A, jnp.eye(K, dtype=A.dtype)], axis=1)  # (K, 2K)

    def step(col, M):
        piv = jnp.argmax((M[:, col] > 0) & (rows >= col))
        rowc, rowp = M[col], M[piv]
        M = M.at[col].set(rowp)
        M = M.at[piv].set(jnp.where(piv == col, rowp, rowc))
        elim = (M[:, col] > 0) & (rows != col)
        return jnp.where(elim[:, None], M ^ M[col][None, :], M)

    M = jax.lax.fori_loop(0, K, step, M)
    return M[:, K:]


def osd2_decode_jax(soft: jnp.ndarray, G: np.ndarray, order: int = 2):
    """One lane: soft (162,) float32 in the Fano convention (>=128 means
    coded bit 1, |x-128| is the reliability) -> (info_bits (50,) int32,
    quality float32, margin float32, flips int32). Same candidate set and
    strict-< preference order as the host fec/osd.osd_decode at
    order <= 2; margin matches OsdResult.margin."""
    assert order in (1, 2, 3, 4)
    Gj = jnp.asarray(G, jnp.int32)
    y = soft - 128.0
    h = (y >= 0)
    r = jnp.abs(y)
    idx = jnp.argsort(-r, stable=True)
    sel = idx[_basis_select(Gj[idx])]         # information-set positions

    A = Gj[sel]                               # (K, K), invertible
    Ainv = _gf2_inv(A)
    u0 = (Ainv @ h[sel].astype(jnp.int32)) & 1
    D = (Gj @ Ainv) & 1                       # codeword delta per basis flip
    c0 = (Gj @ u0) & 1
    m0 = c0 != h.astype(jnp.int32)
    s = r * (1.0 - 2.0 * m0)
    score0 = jnp.sum(r * m0)

    Df = D.astype(jnp.float32)
    w = jnp.matmul(s, Df, precision=_HI)      # (K,) order-1 score deltas
    p1 = jnp.argmin(w)
    s_best = score0
    flips = jnp.zeros(K, jnp.int32)
    n_flips = jnp.int32(0)
    take1 = score0 + w[p1] < s_best
    s_best = jnp.where(take1, score0 + w[p1], s_best)
    flips = jnp.where(take1, flips.at[p1].add(1), flips)
    n_flips = jnp.where(take1, 1, n_flips)
    # per-stage two smallest candidate scores, for the list-decoding
    # margin (all candidates are distinct codewords: flip vectors map
    # injectively through the invertible Ainv)
    top2 = [score0[None], -jax.lax.top_k(-(score0 + w), 2)[0]]

    if order >= 2:
        M2 = jnp.matmul((Df * s[:, None]).T, Df, precision=_HI)  # (K, K)
        pair = score0 + w[:, None] + w[None, :] - 2.0 * M2
        pair = jnp.where(jnp.triu(jnp.ones((K, K), bool), k=1),
                         pair, jnp.inf)
        flat = jnp.argmin(pair)
        p2, q2 = flat // K, flat % K
        top2.append(-jax.lax.top_k(-pair.reshape(-1), 2)[0])
        take2 = pair[p2, q2] < s_best
        s_best = jnp.where(take2, pair[p2, q2], s_best)
        pairvec = jnp.zeros(K, jnp.int32).at[p2].add(1).at[q2].add(1)
        flips = jnp.where(take2, pairvec, flips)
        n_flips = jnp.where(take2, 2, n_flips)

    if order >= 3:
        # XOR of three columns by inclusion-exclusion (d are 0/1):
        # dp^dq^dr = dp+dq+dr - 2(dpdq+dpdr+dqdr) + 4 dpdqdr, so
        # score(p,q,r) = s0 + w_p+w_q+w_r - 2(M2_pq+M2_pr+M2_qr) + 4T_pqr
        T = jnp.einsum("i,ip,iq,ir->pqr", s, Df, Df, Df, precision=_HI)
        trip = (score0 + w[:, None, None] + w[None, :, None]
                + w[None, None, :]
                - 2.0 * (M2[:, :, None] + M2[:, None, :] + M2[None, :, :])
                + 4.0 * T)
        kk = jnp.arange(K)
        strict = ((kk[:, None, None] < kk[None, :, None])
                  & (kk[None, :, None] < kk[None, None, :]))
        trip = jnp.where(strict, trip, jnp.inf)
        flat3 = jnp.argmin(trip)              # first min = lexicographic,
        p3 = flat3 // (K * K)                 # matching the host's
        q3 = (flat3 // K) % K                 # combinations() walk
        r3 = flat3 % K
        top2.append(-jax.lax.top_k(-trip.reshape(-1), 2)[0])
        take3 = trip[p3, q3, r3] < s_best
        s_best = jnp.where(take3, trip[p3, q3, r3], s_best)
        tripvec = (jnp.zeros(K, jnp.int32)
                   .at[p3].add(1).at[q3].add(1).at[r3].add(1))
        flips = jnp.where(take3, tripvec, flips)
        n_flips = jnp.where(take3, 3, n_flips)

    if order >= 4:
        # order-4 (r5): all C(50,4) quadruples, chunked over the first
        # flip index p to bound memory at one (K,K,K) tensor per step.
        # Scores via the +/-1 product form (like the host's order>=4
        # path): with E = 1-2D, q4(p,q,r,t) = sum_i s_i E_ip E_iq E_ir
        # E_it and score = score0 + (sum(s) - q4)/2 = score0 + sum over
        # flipped-XOR disagreements. fori_loop p ascending with
        # strict-< keeps the host's lexicographic first-min tie-break.
        E = (1.0 - 2.0 * Df)
        T_s = jnp.sum(s)
        kk = jnp.arange(K)
        strict3 = ((kk[:, None, None] < kk[None, :, None])
                   & (kk[None, :, None] < kk[None, None, :]))

        def chunk(p, carry):
            s_best4, pv, qv, rv, tv, two = carry
            q4 = jnp.einsum("i,iq,ir,it->qrt", s * E[:, p], E, E, E,
                            precision=_HI)
            sc = score0 + (T_s - q4) / 2.0
            ok = strict3 & (kk[:, None, None] > p)
            sc = jnp.where(ok, sc, jnp.inf)
            flat = jnp.argmin(sc)
            q_ = (flat // (K * K)).astype(jnp.int32)
            r_ = ((flat // K) % K).astype(jnp.int32)
            t_ = (flat % K).astype(jnp.int32)
            v = sc[q_, r_, t_]
            # two smallest across the whole search (for the margin)
            two = -jax.lax.top_k(
                -jnp.concatenate([two,
                                  -jax.lax.top_k(-sc.reshape(-1), 2)[0]]),
                2)[0]
            take = v < s_best4
            return (jnp.where(take, v, s_best4),
                    jnp.where(take, jnp.int32(p), pv),
                    jnp.where(take, q_, qv), jnp.where(take, r_, rv),
                    jnp.where(take, t_, tv), two)

        init4 = (jnp.float32(jnp.inf), jnp.int32(0), jnp.int32(0),
                 jnp.int32(0), jnp.int32(0),
                 jnp.full(2, jnp.inf, jnp.float32))
        s_b4, p4i, q4i, r4i, t4i, two4 = jax.lax.fori_loop(0, K, chunk,
                                                           init4)
        top2.append(two4)
        take4 = s_b4 < s_best
        s_best = jnp.where(take4, s_b4, s_best)
        quadvec = (jnp.zeros(K, jnp.int32).at[p4i].add(1).at[q4i].add(1)
                   .at[r4i].add(1).at[t4i].add(1))
        flips = jnp.where(take4, quadvec, flips)
        n_flips = jnp.where(take4, 4, n_flips)

    u = (u0 + Ainv @ flips) & 1
    total = jnp.maximum(jnp.sum(r), 1e-9)
    quality = (total - 2.0 * s_best) / total
    two = -jax.lax.top_k(-jnp.concatenate(top2), 2)[0]
    margin = (two[1] - two[0]) / total
    return u, quality, margin, n_flips


def bits_to_payload(u: jnp.ndarray) -> jnp.ndarray:
    """(..., 50) info bits -> (..., 7) uint8, MSB-first per byte with the
    trailing 6 bits zero (protocol.fec_encode.bits_to_bytes layout)."""
    pad = jnp.zeros(u.shape[:-1] + (6,), u.dtype)
    b = jnp.concatenate([u, pad], axis=-1).reshape(u.shape[:-1] + (7, 8))
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    return (b * weights).sum(axis=-1).astype(jnp.uint8)


__all__ = ["osd2_decode_jax", "bits_to_payload"]
