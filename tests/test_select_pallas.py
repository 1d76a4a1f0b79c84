"""Model selection on the device path: coarse.search.select_best (the XLA
event-skip loop every backend runs; a dedicated selection kernel was
removed, see ROADMAP Reach).

Must be bit-identical to the literal sequential fold
(coarse.search.select_best_scan) on every adversarial case: in-group
nonlinear accept chains, deep-chain group revisits, NaN rows/columns,
the negative-best decrease quirk, and plain noise grids, alone and
vmapped over windows as the batched device pipeline uses it.
"""

import jax.numpy as jnp
import numpy as np

from uwspr_tpu.config import CoarseConfig
from uwspr_tpu.coarse.search import (
    build_drift_models,
    select_best,
    select_best_scan,
)


def test_select_pallas_matches_scan_oracle():
    bank = build_drift_models(CoarseConfig())
    is_nl = jnp.asarray(bank.is_nonlinear)
    M = bank.offsets.shape[0]
    rng = np.random.default_rng(17)
    cases = [rng.normal(size=(13, 5, 26, M)).astype(np.float32) * 0.1
             for _ in range(3)]
    nanc = cases[0].copy()
    nanc[0, 2, 3, :] = np.nan
    nanc[1, :, :, 40:] = np.nan
    cases.append(nanc)
    neg = np.full((2, 5, 26, M), -100.0, np.float32)
    neg[0, 0, 0, 0] = -5.0       # linear seed
    neg[0, 0, 2, 1] = -80.0      # nl decrease (ratio 16 > 10)
    neg[0, 0, 4, 3] = -60.0      # linear accept against -80
    cases.append(neg)
    esc = np.full((1, 5, 26, M), 1e-6, np.float32)
    esc[0, 0, 0, 0] = 1e-4       # chain of 3 in-group nl accepts
    esc[0, 0, 0, 4] = 2e-3
    esc[0, 0, 0, 7] = 0.3
    esc[0, 0, 0, 10] = 40.0
    cases.append(esc)
    deep = np.full((1, 5, 26, M), 1e-9, np.float32)
    deep[0, 1, 3, 0] = 1e-7      # 4-deep chain: exceeds the 3-step
    deep[0, 1, 3, 3] = 5e-6      # closed form, forces the group revisit
    deep[0, 1, 3, 5] = 1e-4
    deep[0, 1, 3, 8] = 9e-3
    deep[0, 1, 3, 11] = 0.7
    cases.append(deep)
    for sync in cases:
        b1, i1 = select_best(jnp.asarray(sync), is_nl, threshold=10.0)
        b2, i2 = select_best_scan(jnp.asarray(sync), is_nl,
                                  threshold=10.0)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


def test_select_pallas_vmapped_batch():
    """vmap over windows (the batched device pipeline's usage)."""
    import jax

    bank = build_drift_models(CoarseConfig())
    is_nl = jnp.asarray(bank.is_nonlinear)
    M = bank.offsets.shape[0]
    rng = np.random.default_rng(19)
    sync = rng.normal(size=(3, 5, 5, 26, M)).astype(np.float32) * 0.1
    f = jax.jit(jax.vmap(lambda s: select_best(s, is_nl, threshold=10.0)))
    b1, i1 = f(jnp.asarray(sync))
    for w in range(3):
        b2, i2 = select_best_scan(jnp.asarray(sync[w]), is_nl,
                                  threshold=10.0)
        np.testing.assert_array_equal(np.asarray(i1[w]), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(b1[w]), np.asarray(b2))
