"""Targeted cases for the GPU approximate-count kernel, interpreted on the
CPU against the plain Myers scan: planted edits of each kind at the level
boundaries, short texts, unroll and tile variants, saturated state.  The
random sweep over k x maxerr is tests/test_bpm_kernel.py."""

import numpy as np
import pytest

from approx_counter_tpu.core.codec import encode_kmer, split_code
from approx_counter_tpu.kernels.bpm import (
    approx_counts_jnp,
    approx_counts_kernel,
    build_peq,
)


def _peq(pats, k):
    codes = np.array([encode_kmer(p) for p in pats], dtype=np.uint64)
    hi, lo = split_code(codes)
    return build_peq(hi, lo, k)


def _both(peq, wins, valid, k, maxerr, **kw):
    wt = wins.T.copy()
    want = np.asarray(approx_counts_jnp(peq, wt, valid, k, maxerr=maxerr))
    got = np.asarray(approx_counts_kernel(peq, wt, valid, k, maxerr=maxerr,
                                          interpret=True, **kw))
    return got, want


def _edit(pat, rng, kind, n):
    """``pat`` with ``n`` edits of one kind (substitution, insertion or
    deletion) at random positions."""
    p = list(pat)
    for _ in range(n):
        i = int(rng.integers(0, len(p)))
        if kind == "sub":
            p[i] = (p[i] + int(rng.integers(1, 4))) % 4
        elif kind == "ins":
            p.insert(i, int(rng.integers(0, 4)))
        elif len(p) > 1:
            del p[i]
    return np.array(p, np.uint8)


@pytest.mark.parametrize("kind", ["sub", "ins", "del"])
@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [8, 16, 32])
def test_kernel_planted_edits(kind, maxerr, k, rng):
    """Copies with 0..maxerr+1 edits of one kind exercise each NFA
    transition (match, substitution, insertion, deletion) right at the
    level boundaries."""
    C, W, m = 8, 64, 48
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    for w in range(W):
        cp = _edit(pats[w % C], rng, kind, w % (maxerr + 2))[: m]
        pos = rng.integers(0, m - len(cp) + 1)
        wins[w, pos : pos + len(cp)] = cp
    got, want = _both(_peq(pats, k), wins, np.ones(W, bool), k, maxerr)
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("m", [1, 6, 19])
@pytest.mark.parametrize("k", [16, 32])
def test_kernel_short_texts(m, k, rng):
    """Texts shorter than the pattern and shorter than one unrolled group
    of rows (the kernel's static tail steps)."""
    C, W = 33, 64
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
    for maxerr in range(4):
        got, want = _both(_peq(pats, k), wins, np.ones(W, bool), k, maxerr)
        np.testing.assert_array_equal(got, want, err_msg=f"maxerr={maxerr}")


@pytest.mark.parametrize("unroll", [1, 3, 4])
def test_kernel_unroll(unroll, rng):
    """The unrolled row groups and the static tail give the same counts
    for every unroll (m = 33 is a multiple of none of 3's neighbours)."""
    k, C, W, m = 16, 40, 130, 33
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
    for w in range(0, W, 3):
        pos = rng.integers(0, m - k + 1)
        wins[w, pos : pos + k] = pats[w % C]
    got, want = _both(_peq(pats, k), wins, np.ones(W, bool), k, 2,
                      unroll=unroll)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wt", [32, 64, 256])
def test_kernel_window_tiles(wt, rng):
    """Other window tiles: more programs per candidate word, and one tile
    wider than the whole batch."""
    k, C, W, m = 12, 64, 200, 30
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
    for w in range(0, W, 2):
        pos = rng.integers(0, m - k + 1)
        wins[w, pos : pos + k] = pats[w % C]
    valid = np.ones(W, bool)
    valid[-1] = False
    got, want = _both(_peq(pats, k), wins, valid, k, 2, wt=wt)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [8, 16, 32])
def test_kernel_saturated_state(k, rng):
    """Poly-A candidates against poly-A text set every state bit of their
    lanes at every step; their neighbours in the same 32-candidate word
    (no A at all) must not pick any of it up."""
    C, W, m = 32, 64, 40
    pats = np.zeros((C, k), np.uint8)
    pats[1::2] = rng.integers(1, 4, (C // 2, k))
    wins = np.zeros((W, m), np.uint8)
    for maxerr in range(4):
        got, want = _both(_peq(list(pats), k), wins, np.ones(W, bool), k,
                          maxerr)
        np.testing.assert_array_equal(got, want, err_msg=f"maxerr={maxerr}")
