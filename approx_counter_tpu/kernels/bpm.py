"""Approximate-match counting: candidates x windows -> per-candidate counts.

Replaces the reference's bidirectional FM-index + SeqAn search-scheme
``find<0,2>(..., EditDistance())`` enumeration
(reference approx_counter.cpp:531-601) with a dense formulation: for
every (candidate k-mer x sampled window) pair, find the minimum semi-global
edit distance d_min of the candidate against any substring of the window,
then accumulate the per-window contribution

    contribution = max(0, (MAXERR+1) - d_min)

which reproduces the reference's per-error-level bit-field counting: a read
contributes one count per error level e in {0..MAXERR} at which an alignment
exists, and an alignment with exactly e ops exists iff e >= d_min (validated
against the exact-stratum DP in oracle.py; SURVEY.md §3C).

Two implementations with one contract ([C, 4] peq x [m, W] windows ->
[C] int32 counts):

  * ``approx_counts_jnp`` -- Myers 1999 bit-parallel DP as a ``lax.scan``
    over text positions, one uint32 word per pair.  The plain reference,
    and what the CPU runs.
  * ``approx_counts_kernel`` -- a Pallas kernel through Triton for the GPU:
    the candidate-bit-sliced level NFA (below), a different algorithm and
    layout, so agreement between the two is a strong check on both.

Windows arrive transposed as [m, W] so each DP step reads one row (every
window's j-th base).  Window symbols >= 4 (N, pad) match no candidate base,
so N behaves exactly like SeqAn's Dna5 'N' against an ACGT needle (unit
mismatch cost) and trailing padding can never lower d_min (monotonicity
argument in SURVEY.md §3C / tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

MAXERR = 2  # reference default (approx_counter.cpp:25 -- fixed at compile
#             time there; here a static kernel parameter, 0 <= maxerr <= 3)

#: Implementations ``approx_counts`` can be asked for by name.
IMPLS = ("jnp", "kernel")


def build_peq(hi, lo, k: int):
    """Per-candidate Myers Peq masks, shape [C, 4] uint32.

    Bit i (LSB = first pattern base, Myers convention) of ``peq[c, b]`` is
    set iff pattern base i == b.  Pattern bases decode from the packed code
    high-bits-first (approx_counter.cpp:55-62).
    """
    hi = jnp.asarray(hi, jnp.uint32)
    lo = jnp.asarray(lo, jnp.uint32)
    bases = []
    for i in range(k):
        sh = 2 * (k - 1 - i)
        if sh >= 32:
            b = (hi >> np.uint32(sh - 32)) & np.uint32(3)
        else:
            b = (lo >> np.uint32(sh)) & np.uint32(3)
        bases.append(b)
    base = jnp.stack(bases, axis=-1)  # [C, k] uint32
    peq = []
    for c in range(4):
        bits = (base == np.uint32(c)).astype(jnp.uint32)
        mask = jnp.zeros(hi.shape, jnp.uint32)
        for i in range(k):
            mask = mask | (bits[..., i] << np.uint32(i))
        peq.append(mask)
    return jnp.stack(peq, axis=-1)  # [C, 4]


def _bpm_step(c_row, VP, VN, score, minsc, peq_cols, k: int):
    """One Myers DP step over a whole [C, W] state.

    ``c_row``: (1, W) int32 window bases at text position j.
    ``peq_cols``: the four (C, 1) peq columns.
    """
    high = np.uint32(1) << np.uint32(k - 1)
    # the peq column of the text base; N and pad (4, 5) match nothing
    Eq = jnp.uint32(0)
    for b in range(4):
        Eq = jnp.where(c_row == b, peq_cols[b], Eq)
    Xv = Eq | VN
    Xh = (((Eq & VP) + VP) ^ VP) | Eq
    Ph = VN | ~(Xh | VP)
    Mh = VP & Xh
    score = (
        score
        + ((Ph & high) >> np.uint32(k - 1)).astype(jnp.int32)
        - ((Mh & high) >> np.uint32(k - 1)).astype(jnp.int32)
    )
    Ph = Ph << np.uint32(1)
    Mh = Mh << np.uint32(1)
    VP = Mh | ~(Xv | Ph)
    VN = Ph & Xv
    minsc = jnp.minimum(minsc, score)
    return VP, VN, score, minsc


# ---------------------------------------------------------------------------
# Plain reference: lax.scan over text positions
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "maxerr"))
def approx_counts_jnp(peq, windows_t, window_valid, k: int,
                      maxerr: int = MAXERR):
    """Reference implementation: lax.scan over text positions.

    peq:          [C, 4] uint32
    windows_t:    [m, W] uint8 (transposed windows)
    window_valid: [W] bool/int
    returns       [C] int32 counts = sum_w max(0, MAXERR+1 - d_min(c, w))
    """
    C = peq.shape[0]
    W = windows_t.shape[1]
    peq_cols = tuple(peq[:, b][:, None] for b in range(4))  # (C,1) x4
    VP = jnp.full((C, W), np.uint32(0xFFFFFFFF), jnp.uint32)
    VN = jnp.zeros((C, W), jnp.uint32)
    score = jnp.full((C, W), k, jnp.int32)
    minsc = jnp.full((C, W), k, jnp.int32)

    def step(carry, c_row):
        VP, VN, score, minsc = carry
        out = _bpm_step(c_row[None, :].astype(jnp.int32), VP, VN, score, minsc,
                        peq_cols, k)
        return out, None

    (VP, VN, score, minsc), _ = jax.lax.scan(
        step, (VP, VN, score, minsc), windows_t.astype(jnp.int32)
    )
    contrib = jnp.maximum(0, (maxerr + 1) - minsc)
    contrib = contrib * window_valid.astype(jnp.int32)[None, :]
    return jnp.sum(contrib, axis=1, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# GPU kernel: candidate-bit-sliced level NFA (Wu-Manber / Baeza-Yates
# k-differences, Navarro 2001 search form).  R_d bit i is set iff the
# pattern prefix P[0..i] matches a substring ending at the current text
# position with <= d edits.  Instead of one word per candidate holding k
# state bits, word bit c holds ONE state bit of candidate c: 32 candidates
# per uint32, one value per (error level d, pattern position i).  The
# NFA's shift by one position becomes an index rename, so the update per
# text base costs, per 32-candidate word:
#
#   Eq[i]   = ((P0[i] ^ x0) & (P1[i] ^ x1)) & vm
#   Rn_0[i] = R_0[i-1] & Eq[i]                        (Rn_0[0] = Eq[0])
#   Rn_d[i] = (R_d[i-1] & Eq[i]) | R_{d-1}[i] | R_{d-1}[i-1] | Rn_{d-1}[i-1]
#             (match            | insertion  | substitution | deletion)
#   h_d    |= Rn_d[k-1]
#
# P0[i]/P1[i] are the candidates' base bit-planes (bit c = bit 0/1 of
# candidate c's base at position i, ``build_sliced_planes``); x0/x1 are
# all-ones iff the text base's bit 0/1 is 0, and vm is all-ones iff the
# text symbol is a base (N and pad match nothing).  Positions i < d are
# all-ones at every step (i+1 <= d leading pattern chars are deletable),
# so they are constants, never carried; levels d > k-1 are all constant
# (every window hits) and fold into a per-window additive term.  Levels
# nest (R_{d-1} within R_d), so the sticky hit words give the contribution
# sum_d hit_d == max(0, (maxerr+1) - d_min) with no score tracking.
#
# Layout on the card: one program takes one 32-candidate word and a tile
# of ``wt`` windows, and walks the m text rows itself, loading one
# coalesced row of ``windows_t`` per step.  The whole NFA state is one
# value per (level, position) per window, held in registers.  Programs
# write per-window-tile partial counts; XLA sums them (integer sums are
# exact in any order).
# ---------------------------------------------------------------------------


def build_sliced_planes(peq, k: int):
    """Candidate bit-planes: [C, 4] peq -> (P0, P1), each [C // 32, k]
    uint32.

    Bit c of ``P0[w, i]`` is bit 0 of candidate (32w + c)'s base at pattern
    position i (i.e. base in {C, T}); ``P1`` is bit 1 (base in {G, T}).
    C must be a multiple of 32 (callers pad with zero peq rows).
    """
    C = peq.shape[0]
    assert C % 32 == 0, C
    mask0 = (peq[:, 1] | peq[:, 3]).astype(jnp.uint32)  # bit i = bit0(base_i)
    mask1 = (peq[:, 2] | peq[:, 3]).astype(jnp.uint32)

    def bitslice(mw):
        bits = (mw[:, None] >> jnp.arange(k, dtype=jnp.uint32)[None, :]) & (
            jnp.uint32(1)
        )  # [C, k]
        sh = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
        return jnp.sum(
            bits.reshape(C // 32, 32, k) << sh, axis=1, dtype=jnp.uint32
        )

    return bitslice(mask0), bitslice(mask1)


def _nfa_levels(k: int, maxerr: int) -> int:
    """Error levels with any variable position (the rest are constant)."""
    return min(maxerr, k - 1) + 1


@functools.partial(jax.jit, static_argnames=("k",))
def _nfa_step(c, P0, P1, R, h, k: int):
    """One text base ``c`` (int32 window row) through the sliced NFA.
    Jitted so the kernel's unrolled steps share one trace."""
    x0 = ((c & 1) - 1).astype(jnp.uint32)
    x1 = (((c >> 1) & 1) - 1).astype(jnp.uint32)
    vm = ((c - 4) >> 31).astype(jnp.uint32)
    Eq = [((P0[i] ^ x0) & (P1[i] ^ x1)) & vm for i in range(k)]
    newR = [tuple([Eq[0]] + [R[0][i - 1] & Eq[i] for i in range(1, k)])]
    # R[d] holds the variable positions i in [d, k-1] at index i - d
    for d in range(1, len(R)):
        prev, below, belown = R[d], R[d - 1], newR[d - 1]
        cur = []
        for i in range(d, k):
            # R_d[d-1] is the all-ones constant region
            match = Eq[i] if i == d else prev[i - 1 - d] & Eq[i]
            cur.append(match | below[i - d + 1] | below[i - d]
                       | belown[i - d])
        newR.append(tuple(cur))
    h = tuple(hh | nr[k - 1 - d] for d, (hh, nr) in enumerate(zip(h, newR)))
    return tuple(newR), h


def _nfa_kernel(p0_ref, p1_ref, win_ref, valid_ref, out_ref, *, k: int,
                m: int, n_levels: int, unroll: int):
    P0 = [p0_ref[0, i] for i in range(k)]
    P1 = [p1_ref[0, i] for i in range(k)]
    wt = win_ref.shape[1]
    zeros = jnp.zeros((wt,), jnp.uint32)
    carry = (tuple(tuple(zeros for _ in range(d, k))
                   for d in range(n_levels)),
             tuple(zeros for _ in range(n_levels)))

    def row(j):
        return win_ref[j, :].astype(jnp.int32)

    def group(g, carry):
        # issue the group's row loads together, ahead of their steps
        rows = [row(g * unroll + u) for u in range(unroll)]
        for c in rows:
            carry = _nfa_step(c, P0, P1, *carry, k)
        return carry

    carry = jax.lax.fori_loop(0, m // unroll, group, carry)
    for j in range(m - m % unroll, m):
        carry = _nfa_step(row(j), P0, P1, *carry, k)
    _, h = carry

    valid = (-valid_ref[...]).astype(jnp.uint32)  # all-ones iff valid
    shifts = jax.lax.broadcasted_iota(jnp.uint32, (1, 32), 1)
    hits = jnp.zeros((wt, 32), jnp.int32)
    for hd in h:
        hits = hits + (((hd & valid)[:, None] >> shifts)
                       & jnp.uint32(1)).astype(jnp.int32)
    out_ref[0, :] = jnp.sum(hits, axis=0)


#: Window tile of one kernel program (one window per thread, so each NFA
#: state value is one register; two per thread spill at k=32), and the
#: text rows per loop iteration.  Measured on the card: PERF.md "Kernel
#: choices".
KERNEL_WT = 128
KERNEL_UNROLL = 4


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@functools.partial(
    jax.jit,
    static_argnames=("k", "maxerr", "wt", "unroll", "interpret"),
)
def approx_counts_kernel(peq, windows_t, window_valid, k: int,
                         maxerr: int = MAXERR, wt: int = KERNEL_WT,
                         unroll: int = KERNEL_UNROLL,
                         interpret: bool = False):
    """Sliced level-NFA through Pallas/Triton; same contract as
    ``approx_counts_jnp``.

    Any C and W: candidates pad to a multiple of 32 with zero peq rows
    (which compute counts that are sliced off), windows pad to a multiple
    of ``wt`` (a power of two) with pad symbols and ``window_valid`` False.
    ``interpret=True`` runs the kernel through the Pallas interpreter (the
    CPU tests); nothing else sets it.
    """
    C = peq.shape[0]
    m, W = windows_t.shape
    assert wt & (wt - 1) == 0, wt
    Cpad = _round_up(max(C, 1), 32)
    if Cpad != C:
        peq = jnp.pad(peq, ((0, Cpad - C), (0, 0)))
    P0, P1 = build_sliced_planes(peq.astype(jnp.uint32), k)  # [Cw, k]
    Cw = Cpad // 32
    Wp = _round_up(max(W, 1), wt)
    valid = window_valid.astype(jnp.int32)
    if Wp != W:
        windows_t = jnp.pad(windows_t, ((0, 0), (0, Wp - W)),
                            constant_values=np.uint8(5))
        valid = jnp.pad(valid, (0, Wp - W))
    n_wt = Wp // wt
    n_levels = _nfa_levels(k, maxerr)
    partial = pl.pallas_call(
        functools.partial(_nfa_kernel, k=k, m=m, n_levels=n_levels,
                          unroll=unroll),
        out_shape=jax.ShapeDtypeStruct((n_wt, Cpad), jnp.int32),
        grid=(n_wt, Cw),
        in_specs=[
            pl.BlockSpec((1, k), lambda w, c: (c, 0)),
            pl.BlockSpec((1, k), lambda w, c: (c, 0)),
            pl.BlockSpec((m, wt), lambda w, c: (0, w)),
            pl.BlockSpec((wt,), lambda w, c: (w,)),
        ],
        out_specs=pl.BlockSpec((1, 32), lambda w, c: (w, c)),
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=max(1, wt // 32), num_stages=1),
        interpret=interpret,
        name="bpm_nfa",
    )(P0, P1, windows_t, valid)
    # bit c of word w is candidate 32w + c: row-major order is candidate order
    counts = jnp.sum(partial, axis=0)[:C]
    n_const = maxerr + 1 - n_levels
    if n_const:  # k <= d levels hit on every valid window
        counts = counts + n_const * jnp.sum(valid)
    return counts


def default_impl(backend: str | None = None) -> str:
    """The implementation a backend runs: the plain scan on the CPU, the
    kernel on the GPU.  No other backend has one."""
    backend = backend or jax.default_backend()
    if backend == "cpu":
        return "jnp"
    if backend == "gpu":
        return "kernel"
    raise NotImplementedError(
        f"no approximate-count implementation for backend {backend!r}"
    )


def resolve_impl(impl: str | None = None) -> str:
    """``impl`` checked against the backend (None: its default).  The
    kernel runs only on a GPU; nothing falls back to another
    implementation."""
    backend = jax.default_backend()
    if impl is None:
        return default_impl(backend)
    if impl not in IMPLS:
        raise ValueError(f"unknown approximate-count implementation "
                         f"{impl!r} (one of {', '.join(IMPLS)})")
    if impl == "kernel" and backend != "gpu":
        raise ValueError(f"the approximate-count kernel needs a GPU; "
                         f"the backend is {backend}")
    return impl


def approx_counts(peq, windows_t, window_valid, k: int, maxerr: int = MAXERR,
                  impl: str | None = None):
    """[C, 4] peq x [m, W] windows -> [C] int32 counts, by ``impl``
    (one of ``IMPLS``; None picks the backend's default)."""
    if resolve_impl(impl) == "kernel":
        return approx_counts_kernel(peq, windows_t, window_valid, k,
                                    maxerr=maxerr)
    return approx_counts_jnp(peq, windows_t, window_valid, k, maxerr=maxerr)
