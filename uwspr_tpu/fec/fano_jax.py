"""Batched Fano sequential decoder on the device (JAX lax.while_loop).

The Fano algorithm is branchy and data-dependent — the opposite of what XLA
likes — so it is reformulated as a *lockstep vectorized state machine*:

- Every lane (one candidate x jiggle attempt) carries a struct-of-arrays
  trellis state: per-node cumulative metric, encoder state, sorted branch
  metrics, and branch index, plus a scalar node pointer / threshold / phase.
- One while-loop iteration advances every active lane by exactly one
  primitive step: either a *forward look* (threshold test + move/tighten) or
  a single *backward-scan* step. The reference's inner backward loop
  (lib/Fano.cc:219-238) is unrolled across iterations via a phase flag, so
  all lanes stay in lockstep and the whole batch is pure vector ops.
- Cycle accounting matches the reference: one "cycle" per forward look, a
  budget of maxcycles*nbits, and the finish-on-last-cycle-counts-as-timeout
  quirk (Fano.cc:250).

Bit-exact against fec.fano_ref (the Python oracle) and fec.native (C++).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from uwspr_tpu.protocol.constants import FANO_METTAB, N_CODED_BITS, POLY1, POLY2

_U32 = jnp.uint32

# Primitive fano steps per while-loop iteration: every step is masked and
# idempotent for finished lanes, so testing the exit condition only every
# WHILE_UNROLL steps cuts the serial loop-control cost (one predicate copy
# to the host per iteration on the GPU) at no change in results.
WHILE_UNROLL = 32


def _branch_symbol(state: jnp.ndarray) -> jnp.ndarray:
    """2-bit branch symbol for uint32 encoder states (vectorized)."""
    p1 = jax.lax.population_count(state & _U32(POLY1)) & _U32(1)
    p2 = jax.lax.population_count(state & _U32(POLY2)) & _U32(1)
    return ((p1 << 1) | p2).astype(jnp.int32)


def branch_metrics(symbols: jnp.ndarray, mettab: jnp.ndarray,
                   nbits: int) -> jnp.ndarray:
    """(L, 2*nbits) soft symbols -> (L, nbits, 4) int32 branch metrics,
    metrics[l, k, j] with j = (poly1_bit<<1)|poly2_bit.

    Plain table gathers: exact integers, and on the GPU a gather of this
    size is one small fused kernel.
    """
    m = mettab.astype(jnp.int32)               # (2, 256)
    y0 = symbols[:, 0::2]                      # (L, nbits)
    y1 = symbols[:, 1::2]
    m0y0, m1y0 = m[0][y0], m[1][y0]
    m0y1, m1y1 = m[0][y1], m[1][y1]
    return jnp.stack([
        m0y0 + m0y1,
        m0y0 + m1y1,
        m1y0 + m0y1,
        m1y0 + m1y1,
    ], axis=-1)                                # (L, nbits, 4)


@functools.partial(jax.jit, static_argnames=("nbits", "delta", "maxcycles"))
def fano_decode_batch_jax(symbols: jnp.ndarray,
                          mettab: jnp.ndarray,
                          active: jnp.ndarray | None = None,
                          *, nbits: int = N_CODED_BITS, delta: int = 60,
                          maxcycles: int = 10000):
    """Decode (L, 2*nbits) soft symbols; returns a dict of per-lane results.

    ``active``: optional (L,) bool — lanes with False are skipped (they
    report failure immediately); lets callers batch gated jiggle attempts
    without paying for unused lanes' convergence.
    """
    symbols = symbols.astype(jnp.int32)
    L = symbols.shape[0]
    tail = nbits - 31
    budget = maxcycles * nbits

    metrics = branch_metrics(symbols, mettab, nbits)   # (L, nbits, 4)

    lanes = jnp.arange(L)
    in_tail = jnp.arange(nbits + 1) >= tail    # (nbits+1,)

    def expand(k, enc, tm, branch, metrics):
        """Recompute sorted branch metrics at each lane's node k."""
        ek = enc[lanes, k]                                  # (L,) uint32
        lsym = _branch_symbol(ek)
        mk = metrics[lanes, jnp.minimum(k, nbits - 1)]      # (L, 4)
        a = mk[lanes, lsym]
        b = mk[lanes, 3 ^ lsym]
        is_tail = in_tail[k]
        swap = (~is_tail) & (a <= b)
        tm0 = jnp.where(swap, b, a)
        tm1 = jnp.where(is_tail, tm[lanes, k, 1], jnp.where(swap, a, b))
        enc = enc.at[lanes, k].set(jnp.where(swap, ek + _U32(1), ek))
        tm = tm.at[lanes, k, 0].set(tm0)
        tm = tm.at[lanes, k, 1].set(tm1)
        branch = branch.at[lanes, k].set(0)
        return enc, tm, branch

    # --- initial state ---------------------------------------------------
    k = jnp.zeros(L, jnp.int32)
    t = jnp.zeros(L, jnp.int32)
    gamma = jnp.zeros((L, nbits + 1), jnp.int32)
    enc = jnp.zeros((L, nbits + 1), jnp.uint32)
    tm = jnp.zeros((L, nbits + 1, 2), jnp.int32)
    branch = jnp.zeros((L, nbits + 1), jnp.int32)
    enc, tm, branch = expand(k, enc, tm, branch, metrics)
    phase = jnp.zeros(L, jnp.int32)            # 0 = forward look, 1 = back scan
    cycles = jnp.zeros(L, jnp.int32)           # completed forward looks
    maxnp = jnp.zeros(L, jnp.int32)
    done = jnp.zeros(L, jnp.bool_)
    success = jnp.zeros(L, jnp.bool_)
    if active is not None:
        done = done | ~active

    def cond(state):
        return ~jnp.all(state[0])

    def body(state):
        done, success, phase, k, t, cycles, maxnp, gamma, enc, tm, branch = state

        fwd = (~done) & (phase == 0)
        bwd = (~done) & (phase == 1)

        # ---- forward look (one reference "cycle") -----------------------
        # timeout gate: starting cycle number cycles+1 must be <= budget
        timeout = fwd & (cycles >= budget)
        fwd = fwd & ~timeout
        maxnp = jnp.where(fwd, jnp.maximum(maxnp, k), maxnp)
        gk = gamma[lanes, k]
        tmk = tm[lanes, k, branch[lanes, k]]
        ngamma = gk + tmk
        ok = ngamma >= t
        move = fwd & ok
        violate = fwd & ~ok

        # threshold tightening (first visit): t += delta*((ngamma-t)//delta)
        tighten = move & (gk < t + delta) & (ngamma >= t + delta)
        t = jnp.where(tighten, t + delta * ((ngamma - t) // delta), t)

        k_next = k + 1
        gamma = gamma.at[lanes, jnp.where(move, k_next, 0)].set(
            jnp.where(move, ngamma, gamma[lanes, 0]))
        enc = enc.at[lanes, jnp.where(move, k_next, 0)].set(
            jnp.where(move, enc[lanes, k] << _U32(1), enc[lanes, 0]))
        k = jnp.where(move, k_next, k)
        complete = move & (k == nbits)
        # expand the new node for lanes that moved and aren't complete
        expanding = move & ~complete
        enc2, tm2, branch2 = expand(jnp.where(expanding, k, 0),
                                    enc, tm, branch, metrics)
        sel = expanding[:, None]
        enc = jnp.where(sel, enc2, enc)
        branch = jnp.where(sel, branch2, branch)
        tm = jnp.where(sel[..., None], tm2, tm)

        cycles = jnp.where(fwd, cycles + 1, cycles)
        success = success | (complete & (cycles < budget))
        # reference timeout leaves its loop counter at budget+1 (Fano.cc:172)
        cycles = jnp.where(timeout, budget + 1, cycles)
        done = done | complete | timeout
        phase = jnp.where(violate, 1, phase)

        # ---- backward scan: exactly one step ----------------------------
        relax = bwd & ((k == 0) | (gamma[lanes, jnp.maximum(k - 1, 0)] < t))
        step_back = bwd & ~relax
        # relax: t -= delta; revert to best branch
        t = jnp.where(relax, t - delta, t)
        revert = relax & (branch[lanes, k] != 0)
        enc = enc.at[lanes, k].set(
            jnp.where(revert, enc[lanes, k] ^ _U32(1), enc[lanes, k]))
        branch = branch.at[lanes, k].set(
            jnp.where(revert, 0, branch[lanes, k]))
        phase = jnp.where(relax, 0, phase)
        # step back: --k; maybe switch to next-best branch
        k = jnp.where(step_back, k - 1, k)
        switch = step_back & (k < tail) & (branch[lanes, k] != 1)
        enc = enc.at[lanes, k].set(
            jnp.where(switch, enc[lanes, k] ^ _U32(1), enc[lanes, k]))
        branch = branch.at[lanes, k].set(
            jnp.where(switch, branch[lanes, k] + 1, branch[lanes, k]))
        phase = jnp.where(switch, 0, phase)
        # else: stay in phase 1 and keep scanning back next iteration

        return done, success, phase, k, t, cycles, maxnp, gamma, enc, tm, branch

    state = (done, success, phase, k, t, cycles, maxnp, gamma, enc, tm, branch)
    # Run several primitive steps per while iteration: every operation in
    # the body is masked by the per-lane done/phase flags, so the body is
    # idempotent for finished lanes and checking the exit condition only
    # every WHILE_UNROLL steps preserves semantics while cutting the
    # serial loop-control overhead.
    def body_unrolled(state):
        for _ in range(WHILE_UNROLL):
            state = body(state)
        return state

    state = jax.lax.while_loop(cond, body_unrolled, state)
    done, success, phase, k, t, cycles, maxnp, gamma, enc, tm, branch = state

    nbytes = nbits >> 3
    harvest = enc[:, 7::8][:, :nbytes] & _U32(0xFF)     # (L, nbytes)
    return {
        "success": success,
        "data": harvest.astype(jnp.uint8),
        "metric": gamma[lanes, k],
        "cycles": cycles + 1,
        "maxnp": maxnp,
    }


def fano_decode_batch(symbols: np.ndarray, mettab: np.ndarray = FANO_METTAB,
                      active: np.ndarray | None = None, *, delta: int = 60,
                      maxcycles: int = 10000, nbits: int = N_CODED_BITS):
    """NumPy-friendly wrapper; returns (success, data, metric, cycles, maxnp)."""
    out = fano_decode_batch_jax(
        jnp.asarray(symbols, jnp.int32).reshape(-1, 2 * nbits),
        jnp.asarray(mettab),
        None if active is None else jnp.asarray(active, jnp.bool_),
        nbits=nbits, delta=delta, maxcycles=maxcycles)
    return (np.asarray(out["success"]), np.asarray(out["data"]),
            np.asarray(out["metric"]), np.asarray(out["cycles"]),
            np.asarray(out["maxnp"]))


__all__ = ["fano_decode_batch_jax", "fano_decode_batch", "branch_metrics"]
