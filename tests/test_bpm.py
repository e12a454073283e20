"""Differential tests for the Myers BPM engine (SURVEY.md §4.3).

Ground truth is the naive Sellers DP (oracle_dmin); the closed-form counting
semantics (Σ max(0, 3 - d_min)) is validated against the exact-stratum DP
(oracle_exact_error_levels).
"""

import numpy as np
import pytest

from approx_counter_tpu.core.codec import BASE_PAD, encode_kmer
from approx_counter_tpu.kernels.bpm import (
    MAXERR,
    approx_counts,
    approx_counts_jnp,
    build_peq,
    default_impl,
)
from approx_counter_tpu.core.codec import split_code
from approx_counter_tpu.oracle import (
    oracle_dmin,
    oracle_error_count,
    oracle_exact_error_levels,
)


def _random_patterns(rng, n, k):
    return [rng.integers(0, 4, k).astype(np.uint8) for _ in range(n)]


def _codes(patterns):
    return np.array([encode_kmer(p) for p in patterns], dtype=np.uint64)


class TestClosedForm:
    """Exactly-e alignments exist iff e >= d_min (e <= MAXERR)."""

    @pytest.mark.parametrize("k,L", [(3, 8), (5, 12), (8, 6), (16, 30)])
    def test_levels_match_dmin(self, k, L, rng):
        for trial in range(30):
            pat = rng.integers(0, 4, k).astype(np.uint8)
            # bias some trials toward near-matches
            if trial % 3 == 0 and L > k:
                txt = np.concatenate(
                    [rng.integers(0, 4, L - k).astype(np.uint8), pat]
                )[:L]
            else:
                txt = rng.integers(0, 5, L).astype(np.uint8)  # incl. N
            d = oracle_dmin(pat, txt)
            levels = oracle_exact_error_levels(pat, txt, MAXERR)
            want = {e for e in range(MAXERR + 1) if e >= d}
            assert levels == want, (pat, txt, d, levels)


class TestBpmJnp:
    @pytest.mark.parametrize("k", [2, 3, 7, 16, 17, 31, 32])
    def test_dmin_vs_oracle(self, k, rng):
        C, W, m = 8, 16, max(2 * k, 40)
        pats = _random_patterns(rng, C, k)
        wins = rng.integers(0, 5, (W, m)).astype(np.uint8)
        # plant exact/near hits
        for w in range(0, W, 3):
            pos = rng.integers(0, m - k + 1)
            wins[w, pos : pos + k] = pats[w % C]
        hi, lo = split_code(_codes(pats))
        peq = build_peq(hi, lo, k)
        got = np.asarray(
            approx_counts_jnp(peq, wins.T.copy(), np.ones(W, bool), k)
        )
        want = np.zeros(C, np.int32)
        for ci, p in enumerate(pats):
            for w in range(W):
                want[ci] += max(0, MAXERR + 1 - oracle_dmin(p, wins[w]))
        np.testing.assert_array_equal(got, want)

    def test_padding_windows_masked(self, rng):
        k = 2  # worst case: an all-pad window has d_min == k == MAXERR
        pats = _random_patterns(rng, 4, k)
        wins = rng.integers(0, 4, (8, 20)).astype(np.uint8)
        pad = np.full((8, 20), BASE_PAD, np.uint8)
        both = np.concatenate([wins, pad], axis=0)
        valid = np.concatenate([np.ones(8, bool), np.zeros(8, bool)])
        hi, lo = split_code(_codes(pats))
        peq = build_peq(hi, lo, k)
        got = np.asarray(approx_counts_jnp(peq, both.T.copy(), valid, k))
        want = np.asarray(
            approx_counts_jnp(peq, wins.T.copy(), np.ones(8, bool), k)
        )
        np.testing.assert_array_equal(got, want)

    def test_trailing_pad_harmless(self, rng):
        # SURVEY §3C monotonicity: trailing pad symbols never lower d_min.
        k = 16
        pats = _random_patterns(rng, 8, k)
        wins = rng.integers(0, 4, (16, 50)).astype(np.uint8)
        padded = np.concatenate(
            [wins, np.full((16, 13), BASE_PAD, np.uint8)], axis=1
        )
        hi, lo = split_code(_codes(pats))
        peq = build_peq(hi, lo, k)
        a = np.asarray(approx_counts_jnp(peq, wins.T.copy(), np.ones(16, bool), k))
        b = np.asarray(approx_counts_jnp(peq, padded.T.copy(), np.ones(16, bool), k))
        np.testing.assert_array_equal(a, b)

    def test_error_count_oracle_agreement(self, rng):
        k = 8
        pats = _random_patterns(rng, 4, k)
        codes = _codes(pats)
        wins = [rng.integers(0, 4, 30).astype(np.uint8) for _ in range(6)]
        want = oracle_error_count(wins, codes.tolist(), k)
        hi, lo = split_code(codes)
        peq = build_peq(hi, lo, k)
        wmat = np.stack(wins)
        got = np.asarray(
            approx_counts_jnp(peq, wmat.T.copy(), np.ones(6, bool), k)
        )
        for i, c in enumerate(codes.tolist()):
            assert got[i] == want[c]


class TestMaxErr:
    @pytest.mark.parametrize("maxerr", [0, 1, 3])
    def test_jnp_matches_oracle(self, maxerr, rng):
        k = 8
        pats = _random_patterns(rng, 4, k)
        codes = _codes(pats)
        wins = [rng.integers(0, 4, 30).astype(np.uint8) for _ in range(6)]
        # plant a near-hit
        wins[0][3 : 3 + k] = pats[0]
        want = oracle_error_count(wins, codes.tolist(), k, maxerr=maxerr)
        hi, lo = split_code(codes)
        peq = build_peq(hi, lo, k)
        wmat = np.stack(wins)
        got = np.asarray(
            approx_counts_jnp(peq, wmat.T.copy(), np.ones(6, bool), k,
                              maxerr=maxerr)
        )
        for i, c in enumerate(codes.tolist()):
            assert got[i] == want[c], (maxerr, i)


class TestApproxCountRank:
    """The device glue around the counting implementation: peq build,
    transpose, dispatch, CompareCount re-rank with the zero-count +1 key
    offset -- differential vs a host-side oracle composition."""

    @pytest.mark.parametrize("k,maxerr", [(8, 2), (8, 0), (17, 1),
                                          (17, 3)])
    def test_glue_matches_oracle(self, k, maxerr, rng):
        from approx_counter_tpu.count.approx import approx_count_rank
        from approx_counter_tpu.core.codec import join_code, split_code
        from approx_counter_tpu.oracle import (
            oracle_error_count,
            oracle_sort_compare_count,
        )

        cap, W, m = 16, 64, 24
        pats = _random_patterns(rng, 10, k)
        codes = _codes(pats)
        wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
        for w in range(0, W, 3):  # plant some exact hits
            pos = rng.integers(0, m - k + 1)
            wins[w, pos : pos + k] = pats[w % len(pats)]
        n_valid = W - 5
        hi, lo = split_code(codes)
        sel_hi = np.zeros(cap, np.uint32)
        sel_lo = np.zeros(cap, np.uint32)
        sel_valid = np.zeros(cap, bool)
        sel_hi[: len(codes)], sel_lo[: len(codes)] = hi, lo
        sel_valid[: len(codes)] = True

        a_hi, a_lo, a_cnt, a_val = map(np.asarray, approx_count_rank(
            wins, np.int32(n_valid), sel_hi, sel_lo, sel_valid, k,
            maxerr=maxerr,
        ))
        n = int(a_val.sum())
        assert n == len(codes)  # zero-count candidates stay in the ranking
        got = list(zip(join_code(a_hi[:n], a_lo[:n]).tolist(),
                       a_cnt[:n].tolist()))

        counter = oracle_error_count(
            [wins[i] for i in range(n_valid)], [int(c) for c in codes], k,
            maxerr=maxerr,
        )
        want = oracle_sort_compare_count(counter, k)
        assert got == want


class TestDispatch:
    """One backend-keyed choice of implementation, and no silent
    fallback."""

    @pytest.mark.parametrize("backend,impl", [("cpu", "jnp"),
                                              ("gpu", "kernel")])
    def test_backend_default(self, backend, impl):
        assert default_impl(backend) == impl

    @pytest.mark.parametrize("backend", ["rocm", "metal", "neuron"])
    def test_other_backends_raise(self, backend):
        with pytest.raises(NotImplementedError):
            default_impl(backend)

    def test_cpu_default_is_the_scan(self, rng):
        k = 8
        pats = _random_patterns(rng, 4, k)
        hi, lo = split_code(_codes(pats))
        peq = build_peq(hi, lo, k)
        wins = rng.integers(0, 6, (16, 30)).astype(np.uint8)
        valid = np.ones(16, bool)
        np.testing.assert_array_equal(
            np.asarray(approx_counts(peq, wins.T.copy(), valid, k)),
            np.asarray(approx_counts_jnp(peq, wins.T.copy(), valid, k)),
        )

    def test_unknown_impl_raises(self, rng):
        peq = build_peq(np.zeros(2, np.uint32), np.zeros(2, np.uint32), 4)
        wins = np.zeros((8, 4), np.uint8)
        with pytest.raises(ValueError):
            approx_counts(peq, wins, np.ones(4, bool), 4, impl="pallas")

    def test_kernel_does_not_fall_back_on_cpu(self):
        """Asked for the kernel, the CPU refuses: it is never silently
        interpreted or replaced by the scan."""
        peq = build_peq(np.zeros(2, np.uint32), np.zeros(2, np.uint32), 4)
        wins = np.zeros((8, 4), np.uint8)
        with pytest.raises(ValueError, match="needs a GPU"):
            approx_counts(peq, wins, np.ones(4, bool), 4, impl="kernel")

    def test_cli_refuses_kernel_on_cpu(self, tmp_path, capsys):
        from approx_counter_tpu.__main__ import main

        fa = tmp_path / "r.fa"
        fa.write_text(">r\n" + "ACGT" * 30 + "\n")
        rc = main([str(fa), "-k", "8", "-sl", "20", "-o",
                   str(tmp_path / "o"), "--bpm-impl", "kernel"])
        assert rc == 1
        assert "needs a GPU" in capsys.readouterr().err
        assert not (tmp_path / "o_0.start").exists()
