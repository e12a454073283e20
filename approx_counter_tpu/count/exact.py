"""Exact k-mer counting + candidate selection, TPU-style.

Replaces the reference's sliding-window hash-map count and std::sort
selection (``count_kmers`` approx_counter.cpp:487-519, ``get_most_frequent``
:396-405, ``get_solid_kmers`` :372-388) with a dense, static-shape array
program:

  1. pack every window position's k-mer into a (hi, lo) uint32 code pair in
     one vectorized sweep, tracking N/pad validity as a mask;
  2. ``lax.sort`` the codes (invalid positions mapped to code 0 and
     corrected out of the first run, keeping the sort single-key for
     k <= 16) and run-length encode to get unique codes + counts -- no
     hash map;
  3. mask low-complexity (DUST) and forbidden codes on the *unique* entries
     (equivalent to the reference's per-position filtering because the
     filters depend only on the code);
  4. rank with the CompareCount composite key (count desc, complexity asc,
     code desc) in a second ``lax.sort`` and keep the top ``cap`` entries.

Selection modes:
  * ``solid_km == 0``: top-``limit`` by CompareCount (ref :396-405).
  * ``solid_km > 0``: all k-mers with count >= solid_km (ref :372-388).  The
    reference's sort there has *no tie-break* (unspecified order among equal
    counts); we emit CompareCount order -- a deterministic refinement,
    documented in SURVEY.md §5 quirk 5.

Everything is order-independent, so sharding windows across devices and
psum-merging counts (dist/) cannot change results.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from approx_counter_tpu.core.complexity import dimer_sum, max_dimer_sum
from approx_counter_tpu.core.ordering import compare_count_keys


def _as_sortable_i32(x):
    """Monotonic uint32 -> int32 map (order-preserving) for lax.top_k."""
    return jax.lax.bitcast_convert_type(
        x ^ jnp.uint32(0x80000000), jnp.int32
    )


def _topk_global(x_i32, cap: int):
    """Exact global top-``cap`` (values desc + indices) via TWO-LEVEL
    top_k: row-wise top_k on an [R, P/R] reshape, then top_k of the row
    winners -- a top_k whose cost grows with the reduced-axis length runs
    faster split this way than as one long reduction.  The largest
    power-of-two R <= 256 that divides P and keeps every row >= cap wide
    is used.

    Exactness: every global top-``cap`` element is one of its row's top
    ``cap`` (fewer than cap elements can rank above it anywhere, so
    certainly within its row), hence it survives to level 2; level-2
    top_k then returns exactly the global winners.  Ties select
    row-major-first instead of the flat call's global-index-first -- the
    caller (_topk_rank) is insensitive to which class members represent a
    tied *value* (see its coverage argument).  Falls back to the flat
    call when the reshape doesn't divide.

    An alternative that does NOT work: lax.approx_max_k on
    order-preserving float32 bitcasts is inexact on tie-heavy/monotone
    inputs even at recall_target=1.0 -- byte parity forbids it at any
    setting."""
    P = x_i32.shape[0]
    R = 256
    while R > 1 and (P % R or P // R < cap):
        R //= 2
    if R == 1:
        return jax.lax.top_k(x_i32, cap)
    v, i = jax.lax.top_k(x_i32.reshape(R, P // R), cap)  # [R, cap]
    gi = (jnp.arange(R, dtype=jnp.int32)[:, None] * (P // R) + i).reshape(-1)
    v2, j = jax.lax.top_k(v.reshape(-1), cap)
    return v2, gi[j]


def _cap_slice(x, cap: int, fill):
    """``x[:cap]``, right-padded with ``fill`` when x is shorter than cap
    -- solid-mode cap regrowth can push cap past P on small batches, and
    a bare slice would silently return P-sized arrays that break the
    fixed-cap output contract."""
    if x.shape[0] >= cap:
        return x[:cap]
    pad = jnp.full((cap - x.shape[0],), fill, x.dtype)
    return jnp.concatenate([x, pad])


def _topk_rank_rowsort(key1, s_lo, cap: int):
    """Exact CompareCount top-``cap`` selection as ONE batched composite
    row sort (the fused replacement for ``_topk_rank``'s two
    hierarchical ``top_k`` passes + merge sort).

    Reshape the P entries to [R, C] rows, sort each row by the FULL
    composite order (key1 asc, ~code asc) in one 2-key ``lax.sort``, keep
    each row's first ``cap`` columns, then sort the [R*cap] survivors
    once more.  Coverage: the composite order is a total order on entry
    values; any global top-``cap`` element is within its row's top-cap by
    that same order, so it survives to level 2.  Ties are identical
    (key1, code) value pairs -- only count-0 duplicates of one code can
    collide, and those are bit-identical, hence interchangeable -- so no
    index dedup is needed (unlike ``_topk_rank``'s boundary-class
    corner).  Returns the same (o1, o4) = (packed key1, ~code) contract.
    R: largest power of two <= 512 that divides P with rows >= cap.
    """
    P = key1.shape[0]
    # The driver pads window rows to a WT=256 multiple, so P = n*p is
    # divisible by 256 and this picks R >= 256 whenever P >= 256*cap.
    # Un-padded library embeddings with awkward P factorizations fall to
    # the exact-but-slower flat 2-key sort below (R == 1).
    R = 512
    while R > 1 and (P % R or P // R < cap):
        R //= 2
    if R == 1:  # tiny batches / huge caps: plain full sort
        o1, o4 = jax.lax.sort([key1, ~s_lo], num_keys=2, is_stable=False)
        return o1[:cap], o4[:cap]
    C = P // R
    r1, r4 = jax.lax.sort(
        [key1.reshape(R, C), (~s_lo).reshape(R, C)], dimension=1,
        num_keys=2, is_stable=False,
    )
    f1, f4 = jax.lax.sort(
        [r1[:, :cap].reshape(-1), r4[:, :cap].reshape(-1)],
        num_keys=2, is_stable=False,
    )
    return f1[:cap], f4[:cap]


def _topk_rank(key1, s_lo, cap: int):
    """Exact CompareCount top-``cap`` selection without sorting all P
    entries: two (hierarchical) top_k passes + a tiny exact sort.

    Correctness: let kb be the cap-th smallest key1 (counted with
    multiplicity).  Every true winner has key1 < kb, or key1 == kb and a
    code among the class's top-(cap - n_less) by code desc.  top_k #1
    (smallest key1) contains all entries with key1 < kb; top_k #2 (largest
    code within the kb class) contains the class's code-desc winners --
    with the one corner (the class's all-A code-0 member needed as a
    winner, indistinguishable from unmasked zeros) arising only when the
    whole class fits in top_k #1 anyway (code 0 is the class minimum, so
    it wins only when class_size <= cap - n_less).  The union therefore
    always covers the true top-cap; a 2*cap exact sort (with duplicate
    indices masked to rank-last) restores full CompareCount order.

    Returns (o1, o4) = (packed key1, ~code) of the top ``cap`` entries.
    """
    nk1 = _as_sortable_i32(~key1)
    v1, i1 = _topk_global(nk1, cap)                  # cap smallest key1
    kb = ~jax.lax.bitcast_convert_type(
        v1[cap - 1], jnp.uint32
    ) ^ jnp.uint32(0x80000000)                       # cap-th smallest key1
    mask_b = key1 == kb
    bvals = _as_sortable_i32(jnp.where(mask_b, s_lo, jnp.uint32(0)))
    _, i2 = _topk_global(bvals, cap)                 # class top codes
    sidx = jnp.sort(jnp.concatenate([i1, i2]))       # [2cap]
    dup = jnp.concatenate(
        [jnp.zeros(1, bool), sidx[1:] == sidx[:-1]]
    )
    g_key1 = jnp.where(dup, jnp.uint32(0xFFFFFFFF), key1[sidx])
    g_ncode = jnp.where(dup, jnp.uint32(0xFFFFFFFF), ~s_lo[sidx])
    o1, o4 = jax.lax.sort([g_key1, g_ncode], num_keys=2)
    return o1[:cap], o4[:cap]


@functools.partial(
    jax.jit, static_argnames=("k", "cap", "n_forbidden", "use_solid")
)
def exact_count_select(
    windows,          # uint8 [n, m] -- BASE_PAD rows beyond n_valid
    n_valid,          # int32 scalar: number of real windows (prefix rows)
    k: int,
    lc_sum_thr,
    forbidden_hi,
    forbidden_lo,
    limit,
    solid_km,
    cap: int,
    n_forbidden: int,
    use_solid: bool,
):
    """Prefix-valid convenience wrapper around
    :func:`exact_count_select_rows` (single-host layouts put all real
    windows first)."""
    n = windows.shape[0]
    row_mask = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) < n_valid
    return exact_count_select_rows(
        windows, row_mask, k, lc_sum_thr, forbidden_hi, forbidden_lo,
        limit, solid_km, cap=cap, n_forbidden=n_forbidden,
        use_solid=use_solid,
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "cap", "n_forbidden", "use_solid", "transposed",
                     "select_impl"),
)
def exact_count_select_rows(
    windows,          # uint8 [n, m] ([m, n] when ``transposed``)
    row_mask,         # bool [n]: which rows are real windows (any layout --
    #                   multi-host shards interleave valid rows)
    k: int,
    lc_sum_thr,       # int32 scalar: integer dimer-sum threshold
    #                   (host-precomputed via complexity.lc_sum_threshold;
    #                   bit-equivalent to the reference's f32 compare)
    forbidden_hi,     # uint32 [F] (F may be 0)
    forbidden_lo,     # uint32 [F]
    limit,            # int32 scalar: top-N limit (top mode)
    solid_km,         # int32 scalar: solid threshold (solid mode)
    cap: int,         # static output size (>= number of entries we keep)
    n_forbidden: int, # static F (for tracing; == len(forbidden_hi))
    use_solid: bool,
    transposed: bool = False,
    select_impl: str = "rowsort",  # "rowsort" | "topk": which exact
    #                   top-cap selection runs on the k<=16 hot path (both
    #                   byte-exact; neither yet measured on the GPU)
):
    # ``transposed``: consume the [m, n] (text-major) layout the BPM
    # kernel already wants, so a fused pass materializes ONE batch layout
    # instead of [n, m] plus a 4 MB device transpose.  The packing sweep
    # slides along axis 0 and position order inside the flat P axis
    # changes (position-major instead of window-major) -- irrelevant:
    # everything downstream of the sweep is a sort/sum over P.
    if transposed:
        m, n = windows.shape
    else:
        n, m = windows.shape
    p = m - k + 1  # sliding positions per window (ref :496)
    shp = (p, n) if transposed else (n, p)

    # --- 1. vectorized packing sweep --------------------------------------
    hi = jnp.zeros(shp, jnp.uint32)
    lo = jnp.zeros(shp, jnp.uint32)
    has_n = jnp.zeros(shp, jnp.bool_)    # contains an N base (symbol 4)
    has_pad = jnp.zeros(shp, jnp.bool_)  # touches padding (symbol >= 5)
    for j in range(k):
        sym = jax.lax.slice_in_dim(windows, j, j + p,
                                   axis=0 if transposed else 1)
        has_n = has_n | (sym == 4)
        has_pad = has_pad | (sym >= 5)
        sym32 = sym.astype(jnp.uint32)
        if k > 16:  # hi word is identically zero otherwise
            hi = (hi << np.uint32(2)) | (lo >> np.uint32(30))
        lo = (lo << np.uint32(2)) | sym32
    if transposed:
        row_valid = jnp.broadcast_to(row_mask[None, :], shp)
    else:
        row_valid = jnp.broadcast_to(row_mask[:, None], shp)
    valid = ~(has_n | has_pad) & row_valid
    # N-containing k-mers in real windows (ref had_n tally :513-517).
    # Positions touching padding are not real sliding positions (the batch
    # carries one inert pad column on start windows) and never tally.
    had_n = jnp.sum((has_n & ~has_pad & row_valid).astype(jnp.int32))

    P = n * p
    hi = hi.reshape(P)
    lo = lo.reshape(P)
    valid = valid.reshape(P)

    # --- 2. sort by code + run-length encode -------------------------------
    # Invalid positions are mapped to code 0 (the all-A k-mer) rather than
    # carrying an extra invalid sort key: after the sort they coalesce into
    # the *first* run, whose length we correct by the (known) invalid count.
    # This keeps the 3.5M-element sort at a single uint32 key for k <= 16
    # (no 32-bit sentinel is free at k == 16 -- all-T IS 0xFFFFFFFF) and two
    # keys for k > 16.
    # is_stable=False on every P-sized sort here (a stable sort costs more).
    # Safe: these sorts carry no payloads beyond their keys (equal-key
    # entries are bit-identical and interchangeable).
    n_total_valid = jnp.sum(valid.astype(jnp.int32))
    n_invalid = jnp.int32(P) - n_total_valid
    if k <= 16:
        lo_s = jnp.where(valid, lo, jnp.uint32(0))
        (s_lo,) = jax.lax.sort([lo_s], num_keys=1, is_stable=False)
        s_hi = jnp.zeros_like(s_lo)
    else:
        hi_s = jnp.where(valid, hi, jnp.uint32(0))
        lo_s = jnp.where(valid, lo, jnp.uint32(0))
        s_hi, s_lo = jax.lax.sort([hi_s, lo_s], num_keys=2,
                                  is_stable=False)

    idx = jax.lax.broadcasted_iota(jnp.int32, (P,), 0)
    prev_lo = jnp.roll(s_lo, 1)
    if k <= 16:
        code_change = s_lo != prev_lo
    else:
        prev_hi = jnp.roll(s_hi, 1)
        code_change = (s_hi != prev_hi) | (s_lo != prev_lo)
    is_start = (idx == 0) | code_change

    start_idx = jnp.where(is_start, idx, jnp.int32(P))
    # next run start at or after i+1:
    next_start = jax.lax.cummin(start_idx, axis=0, reverse=True)
    next_start = jnp.concatenate([next_start[1:], jnp.full((1,), P, jnp.int32)])
    # run 0 holds every invalid position (all mapped to code 0) plus any
    # real all-A k-mers; subtracting n_invalid there makes counts exact.
    run_count = next_start - idx - jnp.where(idx == 0, n_invalid, 0)
    is_start = is_start & (run_count > 0)  # run 0 may be pure-invalid
    n_unique = jnp.sum(is_start.astype(jnp.int32))

    # --- 3. filters on unique entries -------------------------------------
    keep = is_start
    # haveLowComplexity: score >= threshold -> reject; integer-sum compare
    # is bit-equivalent (incl. the k==2 NaN never-rejects quirk, for which
    # lc_sum_thr arrives as an unreachable s_max+1).
    keep = keep & ~(dimer_sum(s_hi, s_lo, k) >= lc_sum_thr)
    if n_forbidden > 0:
        # Membership test via chunked broadcast compare: O(P * F) VPU ops,
        # bounded HLO size.  Typical forbidden lists (adapter k-mers) are
        # tens of entries; chunking keeps the (P, chunk) intermediates small
        # if a user supplies thousands.
        fhit = jnp.zeros_like(keep)
        chunk = 64
        for f0 in range(0, n_forbidden, chunk):
            fh = jax.lax.slice_in_dim(
                forbidden_hi, f0, min(f0 + chunk, n_forbidden)
            )
            fl = jax.lax.slice_in_dim(
                forbidden_lo, f0, min(f0 + chunk, n_forbidden)
            )
            hit = (s_hi[:, None] == fh[None, :]) & (s_lo[:, None] == fl[None, :])
            fhit = fhit | jnp.any(hit, axis=1)
        keep = keep & ~fhit

    count = jnp.where(keep, run_count, 0).astype(jnp.uint32)
    if use_solid:
        keep = keep & (count >= solid_km.astype(jnp.uint32))
        count = jnp.where(keep, count, 0)
    n_pass = jnp.sum(keep.astype(jnp.int32))

    # --- 4. CompareCount ranking ------------------------------------------
    # (count desc, dimer asc) pack into ONE uint32 key whenever count's
    # static bound P fits above the dimer bits (always true at reference
    # defaults: P ~ 3.5M needs 22 bits, dimer(k=16) needs 8) -- the ranking
    # sort then runs with 2 keys for k <= 16 (3 for k > 16) instead of 3/4.
    # The count is NOT carried as a sort payload: it is recoverable from
    # the lead key (count = P - (key1 >> db), or ~k1 in the fallback), and
    # dropping the extra 3.5M-element operand measurably shrinks the
    # ranking sort's data movement.
    # NOTE on top_k: a naive lax.top_k on key1 breaks byte parity -- the
    # boundary tie class is unbounded (count-1 k-mers sharing a dimer sum
    # number in the millions) and top_k would keep an arbitrary subset,
    # losing the code-desc tie-break.  _topk_rank fixes this exactly with
    # a second top_k *by code within the boundary class* (see its
    # docstring for the coverage argument), replacing the full-P ranking
    # sort on the k <= 16 hot path.
    db = max_dimer_sum(k).bit_length()
    dimer = dimer_sum(s_hi, s_lo, k).astype(jnp.uint32)
    if P < (1 << (32 - db)):
        key1 = ((jnp.uint32(P) - count) << np.uint32(db)) | dimer
        if k <= 16 and P > 2 * cap:
            # partial-selection path: avoid sorting all P positions by
            # full CompareCount order.  Two exact implementations:
            # "rowsort" (one batched composite row sort) and "topk" (two
            # hierarchical top_k passes + merge).
            sel_fn = (_topk_rank_rowsort if select_impl == "rowsort"
                      else _topk_rank)
            o1, o4 = sel_fn(key1, s_lo, cap)
            sel_hi = jnp.zeros(cap, jnp.uint32)
        elif k <= 16:  # hi is identically zero; drop its key from the sort
            o1, o4 = jax.lax.sort([key1, ~s_lo], num_keys=2,
                                  is_stable=False)
            sel_hi = jnp.zeros(cap, jnp.uint32)
        else:
            o1, o3, o4 = jax.lax.sort([key1, ~s_hi, ~s_lo], num_keys=3,
                                      is_stable=False)
            sel_hi = _cap_slice((~o3).astype(jnp.uint32), cap, 0)
        raw = _cap_slice(o1, cap, np.uint32(0xFFFFFFFF)) >> np.uint32(db)
        o_count = jnp.where(raw <= jnp.uint32(P), jnp.uint32(P) - raw,
                            jnp.uint32(0))
    else:  # gigantic batches: unpacked 3/4-key fallback
        k1, k2, k3, k4 = compare_count_keys(s_hi, s_lo, count, k, valid=keep)
        if k <= 16:
            o1, o2, o4 = jax.lax.sort([k1, k2, k4], num_keys=3,
                                      is_stable=False)
            sel_hi = jnp.zeros(cap, jnp.uint32)
        else:
            o1, o2, o3, o4 = jax.lax.sort([k1, k2, k3, k4], num_keys=4,
                                          is_stable=False)
            sel_hi = _cap_slice((~o3).astype(jnp.uint32), cap, 0)
        o_count = ~_cap_slice(o1, cap, np.uint32(0xFFFFFFFF))
    sel_lo = _cap_slice((~o4).astype(jnp.uint32), cap, 0)
    sel_count = o_count[:cap]
    rank = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
    n_keep = n_pass if use_solid else jnp.minimum(n_pass, limit)
    sel_valid = (rank < n_keep) & (sel_count > 0)

    return dict(
        sel_hi=sel_hi,
        sel_lo=sel_lo,
        sel_count=sel_count,
        sel_valid=sel_valid,
        n_unique=n_unique,
        n_pass=n_pass,
        n_keep=n_keep,
        had_n=had_n,
    )
