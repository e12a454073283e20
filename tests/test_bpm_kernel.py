"""The GPU approximate-count kernel (candidate-bit-sliced level NFA), run
through the Pallas interpreter on the CPU, against the plain Myers scan
``approx_counts_jnp`` -- two independent algorithms and layouts, so their
agreement checks both.  The same kernel compiled for the card is checked
at real widths by ``chip_smoke.py`` and tests/test_gpu.py."""

import numpy as np
import pytest

from approx_counter_tpu.core.codec import encode_kmer, split_code
from approx_counter_tpu.kernels.bpm import (
    approx_counts_jnp,
    approx_counts_kernel,
    build_peq,
    build_sliced_planes,
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


@pytest.mark.parametrize("k", [2, 3, 5, 8, 12, 15, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
def test_kernel_matches_jnp(k, maxerr, rng):
    """Random windows with N (4) and pad (5) symbols, planted candidate
    copies, masked rows; C and W not multiples of the kernel's tiles (32
    candidates, 128 windows); k <= maxerr where k is 2 or 3."""
    C, W, m = 37, 150, 40
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
    for w in range(0, W, 4):
        pos = rng.integers(0, m - k + 1)
        wins[w, pos : pos + k] = pats[w % C]
    valid = np.ones(W, bool)
    valid[-9:] = False
    valid[3] = False
    got, want = _both(_peq(pats, k), wins, valid, k, maxerr)
    np.testing.assert_array_equal(got, want)


def test_kernel_maxerr_at_least_k(rng):
    """k <= maxerr: every valid window matches the empty substring
    (d_min <= k), the levels folded into the constant term."""
    k, C, W, m = 2, 4, 128, 24
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    valid = np.ones(W, bool)
    valid[:5] = False
    got, want = _both(_peq(pats, k), wins, valid, k, 3)
    np.testing.assert_array_equal(got, want)
    # d_min <= k == 2 always, so every valid window contributes >= 2
    assert (want >= 2 * (W - 5)).all()


@pytest.mark.parametrize("k", [1, 16, 32])
def test_sliced_planes(k, rng):
    """Bit c of plane word w, position i, is bit 0/1 of candidate 32w+c's
    i-th base."""
    C = 64
    pats = rng.integers(0, 4, (C, max(k, 2))).astype(np.uint8)[:, :k]
    peq = np.zeros((C, 4), np.uint32)
    for c in range(C):
        for i, b in enumerate(pats[c]):
            peq[c, b] |= np.uint32(1) << np.uint32(i)
    P0, P1 = map(np.asarray, build_sliced_planes(peq, k))
    assert P0.shape == P1.shape == (C // 32, k)
    for c in range(C):
        for i in range(k):
            assert (int(P0[c // 32, i]) >> (c % 32)) & 1 == pats[c, i] & 1
            assert (int(P1[c // 32, i]) >> (c % 32)) & 1 == pats[c, i] >> 1
