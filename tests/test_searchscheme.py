"""Pin the counting semantics: independent search-scheme enumeration vs
the exact-stratum DP vs the Sigma max(0, (maxerr+1) - d_min) closed form.

This is the COMPAT #13 retirement test: the reference's hot engine marks ``tcount[errors][read_id] = true`` for every
occurrence reported by SeqAn's search-scheme ``find<0,2>``
(/root/reference/approx_counter.cpp:556-586).  approx_counter_tpu
re-implements the published optimal search schemes from scratch
(searchscheme.py) and this suite asserts, on randomized and adversarial
fixtures, that the per-read level sets they report equal

    { e in [0, maxerr] : e >= d_min }

(the closed form the counting kernels compute) and the exact-stratum DP
(oracle.py).  Any future disagreement between search-scheme enumeration
and the closed form fails here.
"""

import numpy as np
import pytest

from approx_counter_tpu.oracle import (
    oracle_dmin,
    oracle_error_count,
    oracle_exact_error_levels,
)
from approx_counter_tpu.searchscheme import (
    SCHEMES,
    connected,
    scheme_covers,
    search_scheme_error_count,
    search_scheme_levels,
    split_pieces,
)


class TestSchemeTables:
    def test_connected_orders(self):
        for scheme in SCHEMES.values():
            for s in scheme:
                assert connected(s.pi), s

    @pytest.mark.parametrize("K", [0, 1, 2, 3])
    def test_error_distribution_coverage(self, K):
        """The scheme-correctness criterion: every distribution of <= K
        errors over the K+1 pieces is admitted by >= 1 search."""
        assert scheme_covers(SCHEMES[K], K)

    def test_k2_single_searches_insufficient(self):
        """No single search of the published K=2 scheme covers alone (the
        scheme is a genuine union; note S2+S3 do cover without S1 -- the
        paper optimizes enumeration cost, not search count, so S1 exists
        to make the common zero-error case cheap)."""
        for s in SCHEMES[2]:
            assert not scheme_covers((s,), 2), s

    def test_split_pieces(self):
        assert split_pieces(16, 3) == [(0, 6), (6, 11), (11, 16)]
        assert split_pieces(2, 3) == [(0, 1), (1, 2), (2, 2)]  # empty piece
        assert split_pieces(32, 4) == [(0, 8), (8, 16), (16, 24), (24, 32)]


def _level_triple(pat, txt, maxerr):
    got = search_scheme_levels(pat, txt, maxerr)
    d = oracle_dmin(pat, txt)
    closed = set(range(d, maxerr + 1)) if d <= maxerr else set()
    strata = oracle_exact_error_levels(pat, txt, maxerr)
    return got, closed, strata


class TestLevelSets:
    @pytest.mark.parametrize("maxerr", [0, 1, 2, 3])
    @pytest.mark.parametrize("k", [2, 3, 5, 8, 16])
    def test_random_differential(self, k, maxerr, rng):
        """Randomized windows incl. N symbols and planted (band-edge)
        occurrences: scheme enumeration == closed form == stratum DP."""
        for trial in range(12):
            pat = rng.integers(0, 4, k).astype(np.uint8)
            L = int(rng.integers(k, 28))
            txt = rng.integers(0, 5, L).astype(np.uint8)
            if trial % 3 == 0:
                pos = 0 if trial % 6 == 0 else int(
                    rng.integers(0, L - k + 1)
                )
                txt[pos : pos + k] = pat
            got, closed, strata = _level_triple(pat, txt, maxerr)
            assert got == closed == strata, (
                k, maxerr, pat.tolist(), txt.tolist(), got, closed, strata
            )

    def test_k32_split_code_boundary(self, rng):
        """k=32 (two-word codes, 4 pieces of 8) on a short window."""
        pat = rng.integers(0, 4, 32).astype(np.uint8)
        txt = rng.integers(0, 4, 40).astype(np.uint8)
        txt[5:37] = pat
        txt[20] = (txt[20] + 1) % 4  # one substitution in the plant
        got, closed, strata = _level_triple(pat, txt, 2)
        assert got == closed == strata == {1, 2}

    @pytest.mark.parametrize("maxerr", [1, 2, 3])
    def test_window_shorter_than_pattern(self, maxerr, rng):
        """Text shorter than the pattern: only insertion-heavy alignments
        exist; d_min >= k - len(text)."""
        pat = rng.integers(0, 4, 5).astype(np.uint8)
        txt = pat[:3].copy()  # 2 chars must be inserted
        got, closed, strata = _level_triple(pat, txt, maxerr)
        assert got == closed == strata
        assert (2 in got) == (maxerr >= 2)

    def test_all_n_window(self):
        """Pure-N window: N never matches, d_min = k."""
        pat = np.array([0, 1, 2, 3], dtype=np.uint8)
        txt = np.full(12, 4, dtype=np.uint8)
        for maxerr in (0, 2, 3):
            got, closed, strata = _level_triple(pat, txt, maxerr)
            assert got == closed == strata
            assert got == (set() if maxerr < 4 else {4})

    @pytest.mark.parametrize("k", [2, 3])
    def test_degenerate_k_le_maxerr(self, k, rng):
        """k <= maxerr: the empty-substring alignment (delete all pattern
        chars) makes every window hit at level k and above."""
        pat = rng.integers(0, 4, k).astype(np.uint8)
        txt = np.full(6, (pat[0] + 1) % 4, dtype=np.uint8)  # no matches
        got, closed, strata = _level_triple(pat, txt, 3)
        assert got == closed == strata
        assert min(got) <= k

    def test_exact_match_yields_all_levels(self, rng):
        """An exact occurrence must be reported at e=0 AND 1 AND 2 --
        the behavior the reference's per-level bit fields depend on
        (approx_counter.cpp:571-579 documents the intent)."""
        k = 8
        pat = rng.integers(0, 4, k).astype(np.uint8)
        txt = np.concatenate([pat, rng.integers(0, 4, 6).astype(np.uint8)])
        assert search_scheme_levels(pat, txt, 2) == {0, 1, 2}


class TestErrorCountEquivalence:
    def test_error_count_matches_closed_form(self, rng):
        """Full errorCount totals: search-scheme delegate semantics ==
        Sigma max(0, (maxerr+1) - d_min) (the kernel's contract)."""
        k, n_win, n_cand = 6, 8, 5
        windows = [
            rng.integers(0, 5, int(rng.integers(k, 20))).astype(np.uint8)
            for _ in range(n_win)
        ]
        cands = [int(c) for c in rng.integers(0, 1 << (2 * k), n_cand)]
        # plant one candidate exactly in half the windows
        pat0 = np.empty(k, np.uint8)
        v = cands[0]
        for i in range(k - 1, -1, -1):
            pat0[i] = v & 3
            v >>= 2
        for w in windows[::2]:
            w[: k] = pat0
        for maxerr in (0, 2):
            got = search_scheme_error_count(windows, cands, k, maxerr)
            want = oracle_error_count(windows, cands, k, maxerr)
            assert got == want, maxerr

    def test_error_count_matches_kernel(self, rng):
        """Search-scheme totals == the jnp kernel path on a dense batch."""
        from approx_counter_tpu.core.codec import split_code
        from approx_counter_tpu.kernels.bpm import approx_counts_jnp, build_peq

        k, W, m = 8, 12, 20
        codes = rng.integers(0, 1 << (2 * k), 6, dtype=np.uint64)
        wins = rng.integers(0, 5, (W, m)).astype(np.uint8)
        hi, lo = split_code(codes)
        peq = build_peq(hi, lo, k)
        kern = np.asarray(
            approx_counts_jnp(peq, wins.T.copy(), np.ones(W, bool), k,
                              maxerr=2)
        )
        ss = search_scheme_error_count(
            [wins[i] for i in range(W)], [int(c) for c in codes], k, 2
        )
        for ci, code in enumerate(codes):
            assert kern[ci] == ss[int(code)], ci
