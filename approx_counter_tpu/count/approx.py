"""Approximate-count stage: candidates x windows -> ranked counts.

Device-side glue around the approximate-count kernels (kernels/bpm.py),
replacing ``errorCount`` + the following ``get_most_frequent`` re-rank
(/root/reference/approx_counter.cpp:531-601, :922-923).

Ranking parity subtlety: the reference stores ``results[kmer] = total`` for
*every* candidate -- including total == 0 -- and those zero-count entries
legitimately appear in the exported approx ranking.  The CompareCount sort
key therefore offsets valid counts by +1 (order-preserving) so that a valid
zero-count candidate still sorts strictly before padding entries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from approx_counter_tpu.core.complexity import dimer_sum
from approx_counter_tpu.kernels.bpm import approx_counts, build_peq


@functools.partial(jax.jit, static_argnames=("k", "maxerr", "impl"))
def approx_count_rank(
    windows,        # uint8 [W, m] sampled windows (padded rows = BASE_PAD)
    n_valid,        # int32 scalar: real window count
    sel_hi,         # uint32 [cap] candidate code halves (CompareCount order)
    sel_lo,         # uint32 [cap]
    sel_valid,      # bool [cap]
    k: int,
    maxerr: int = 2,
    impl: str | None = None,
):
    """Returns (hi, lo, count, valid) ranked by CompareCount.

    ``count`` is the Σ max(0, maxerr+1 - d_min) total per candidate;
    invalid candidate slots rank last.  ``impl`` picks the counting
    implementation (kernels/bpm.py ``approx_counts``).
    """
    W = windows.shape[0]
    window_valid = jax.lax.broadcasted_iota(jnp.int32, (W,), 0) < n_valid

    peq = build_peq(sel_hi, sel_lo, k)          # [cap, 4]
    # Invalid candidate slots: a zero peq row decodes as poly-A in the
    # kernel's bit planes and computes a real (garbage) count.  That
    # is safe only because rank_with_zero_counts masks counts by sel_valid
    # before ranking -- do NOT rely on invalid slots returning zero.
    windows_t = jnp.transpose(windows, (1, 0))  # [m, W]
    counts = approx_counts(peq, windows_t, window_valid, k, maxerr=maxerr,
                           impl=impl)

    return rank_with_zero_counts(sel_hi, sel_lo, counts, sel_valid, k)


def rank_with_zero_counts(sel_hi, sel_lo, counts, sel_valid, k: int):
    """CompareCount ranking with the +1 zero-count offset (see module doc).

    Returns (hi, lo, count, valid) with invalid slots strictly last.
    """
    counts = jnp.where(sel_valid, counts, 0).astype(jnp.uint32)
    cnt_key = jnp.where(sel_valid, counts + jnp.uint32(1), jnp.uint32(0))
    k1 = ~cnt_key
    k2 = dimer_sum(sel_hi, sel_lo, k).astype(jnp.uint32)
    k3 = ~jnp.asarray(sel_hi, jnp.uint32)
    k4 = ~jnp.asarray(sel_lo, jnp.uint32)
    o1, o2, o3, o4, o_cnt, o_val = jax.lax.sort(
        [k1, k2, k3, k4, counts, sel_valid.astype(jnp.int32)], num_keys=4
    )
    return (
        (~o3).astype(jnp.uint32),
        (~o4).astype(jnp.uint32),
        o_cnt,
        o_val.astype(jnp.bool_),
    )
