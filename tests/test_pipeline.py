"""End-to-end pipeline tests vs a full oracle run (SURVEY.md §4.1).

Identity-sampling fixtures: every read has the same length >= 2*sl and
sn >= n_reads, so the sample is a permutation of all reads; both counting
stages are order-independent sets/sums, making outputs deterministic and
oracle-comparable byte for byte.
"""

import numpy as np
import pytest

from approx_counter_tpu.core.codec import codes_to_seq, decode_kmers
from approx_counter_tpu.core.complexity import adjust_threshold
from approx_counter_tpu.oracle import (
    oracle_count_kmers,
    oracle_error_count,
    oracle_get_most_frequent,
    oracle_get_solid_kmers,
    oracle_sort_compare_count,
)
from approx_counter_tpu.params import Params
from approx_counter_tpu.pipeline import run_pipeline

N_READS, READ_LEN = 16, 80
SL = 25  # start windows 25 bases; end windows 26 (off-by-one quirk)
K = 8
LIMIT = 15
ADAPTER = "ACGTCCTAGCAT"


@pytest.fixture
def fasta(tmp_path, rng):
    reads = []
    for i in range(N_READS):
        s = codes_to_seq(rng.integers(0, 4, READ_LEN).astype(np.uint8))
        # plant an adapter-like motif at most read starts
        if i % 4 != 3:
            s = ADAPTER + s[len(ADAPTER):]
        reads.append(s)
    p = tmp_path / "reads.fasta"
    with open(p, "w") as f:
        for i, s in enumerate(reads):
            f.write(f">read{i}\n{s[:40]}\n{s[40:]}\n")  # multi-line records
    return p, reads


def oracle_outputs(reads, k, sl, param_lc, limit, solid_km=0, end=False,
                   forbidden=frozenset(), maxerr=2):
    lc = adjust_threshold(param_lc, 16, k)
    if end:
        windows = [
            np.frombuffer(r[len(r) - 1 - sl :].encode(), np.uint8) for r in reads
        ]
    else:
        windows = [np.frombuffer(r[:sl].encode(), np.uint8) for r in reads]
    from approx_counter_tpu.core.codec import _CHAR_TO_CODE

    windows = [_CHAR_TO_CODE[w] for w in windows]
    counter, _ = oracle_count_kmers(windows, k, lc, set(forbidden))
    if solid_km:
        sel = oracle_get_solid_kmers(counter, solid_km, k)
    else:
        sel = oracle_get_most_frequent(counter, limit, k)
    approx = oracle_error_count(windows, [c for c, _ in sel], k, maxerr=maxerr)
    ranked = oracle_sort_compare_count(approx, k)[:limit]
    exact_lines = "".join(
        f"{decode_kmers(np.array([c], np.uint64), k)[0]}\t{n}\n" for c, n in sel
    )
    approx_lines = "".join(
        f"{decode_kmers(np.array([c], np.uint64), k)[0]}\t{n}\n" for c, n in ranked
    )
    return exact_lines, approx_lines


def test_end_to_end_byte_parity(fasta, tmp_path, capsys):
    path, reads = fasta
    out = tmp_path / "out.txt"
    exact = tmp_path / "exact.txt"
    prm = Params(
        input_file=str(path),
        output=str(out),
        exact_out=str(exact),
        k=K,
        sl=SL,
        sn=N_READS + 5,  # identity sampling (clamped, with warning)
        limit=LIMIT,
        param_lc=1.0,
        v=1,
        seed=7,
    )
    assert run_pipeline(prm) == 0

    for end in (False, True):
        suffix = "_0.end" if end else "_0.start"
        want_exact, want_approx = oracle_outputs(
            reads, K, SL, 1.0, LIMIT, end=end
        )
        got_exact = open(str(exact) + suffix).read()
        got_approx = open(str(out) + suffix).read()
        assert got_exact == want_exact, f"exact {suffix}"
        assert got_approx == want_approx, f"approx {suffix}"

    echo = capsys.readouterr().out
    assert "Kmer size:             8" in echo
    assert "Number of kept kmer:   15" in echo


@pytest.mark.parametrize(
    "k,sl,limit,param_lc,solid_km,seed",
    [
        (2, 8, 6, 1.0, 0, 11),     # k=2: NaN LC quirk, tiny alphabet
        (5, 14, 12, 0.5, 0, 12),   # aggressive LC filter
        (11, 22, 20, 2.0, 0, 13),  # lax LC filter
        (16, 16, 10, 1.0, 0, 14),  # k == sl (one position per start row)
        (7, 18, 25, 1.0, 2, 15),   # solid mode
        (17, 20, 10, 1.0, 0, 16),  # k > 16: two-word codes / k3 sort key
    ],
)
def test_randomized_config_byte_parity(tmp_path, k, sl, limit, param_lc,
                                       solid_km, seed):
    """Full-pipeline byte parity vs the oracle across randomized configs
    (identity sampling); sweeps the LC threshold, solid mode, k==sl, and
    both sides of the k<=16 code-width specialization."""
    rng = np.random.default_rng(seed)
    n_reads, read_len = 12, max(2 * sl, 40)
    reads = [
        codes_to_seq(rng.integers(0, 4, read_len).astype(np.uint8))
        for _ in range(n_reads)
    ]
    p = tmp_path / "r.fasta"
    with open(p, "w") as f:
        for i, s in enumerate(reads):
            f.write(f">r{i}\n{s}\n")
    out, exact = tmp_path / "o.txt", tmp_path / "e.txt"
    prm = Params(
        input_file=str(p), output=str(out), exact_out=str(exact),
        k=k, sl=sl, sn=n_reads, limit=limit, param_lc=param_lc,
        solid_km=solid_km, v=0, seed=3,
    )
    assert run_pipeline(prm) == 0
    for end in (False, True):
        suffix = "_0.end" if end else "_0.start"
        want_exact, want_approx = oracle_outputs(
            reads, k, sl, param_lc, limit, solid_km=solid_km, end=end
        )
        assert open(str(exact) + suffix).read() == want_exact, suffix
        assert open(str(out) + suffix).read() == want_approx, suffix


def test_forbidden_and_maxerr_byte_parity(tmp_path):
    """End-to-end byte parity with a forbidden-k-mer list and a non-default
    --max-error bound (the two knobs the randomized sweep doesn't vary)."""
    from approx_counter_tpu.core.codec import decode_kmers as _dk

    rng = np.random.default_rng(21)
    k, sl, limit, n_reads = 6, 16, 15, 10
    reads = [
        codes_to_seq(rng.integers(0, 4, 40).astype(np.uint8))
        for _ in range(n_reads)
    ]
    p = tmp_path / "r.fasta"
    with open(p, "w") as f:
        for i, s in enumerate(reads):
            f.write(f">r{i}\n{s}\n")
    # forbid the two overall most frequent start k-mers
    windows = [
        np.frombuffer(r[:sl].encode(), np.uint8) for r in reads
    ]
    from approx_counter_tpu.core.codec import _CHAR_TO_CODE

    counter, _ = oracle_count_kmers(
        [_CHAR_TO_CODE[w] for w in windows], k, 1000.0, set()
    )
    top2 = [c for c, _ in oracle_get_most_frequent(counter, 2, k)]
    fk = tmp_path / "forbid.txt"
    fk.write_text("".join(
        _dk(np.array([c], np.uint64), k)[0] + "\n" for c in top2
    ))

    out, exact = tmp_path / "o.txt", tmp_path / "e.txt"
    prm = Params(
        input_file=str(p), output=str(out), exact_out=str(exact),
        k=k, sl=sl, sn=n_reads, limit=limit, param_lc=1000.0,
        forbid_kmer=str(fk), max_error=1, v=0, seed=9,
    )
    assert run_pipeline(prm) == 0
    for end in (False, True):
        suffix = "_0.end" if end else "_0.start"
        want_exact, want_approx = oracle_outputs(
            reads, k, sl, 1000.0, limit, end=end,
            forbidden=frozenset(int(c) for c in top2), maxerr=1,
        )
        assert open(str(exact) + suffix).read() == want_exact, suffix
        assert open(str(out) + suffix).read() == want_approx, suffix
        got = open(str(out) + suffix).read()
        for c in top2:
            assert _dk(np.array([c], np.uint64), k)[0] not in got


def test_solid_mode_and_skip_end(fasta, tmp_path):
    path, reads = fasta
    out = tmp_path / "out.txt"
    exact = tmp_path / "ex.txt"
    prm = Params(
        input_file=str(path),
        output=str(out),
        exact_out=str(exact),
        k=K,
        sl=SL,
        sn=100,
        limit=LIMIT,
        solid_km=3,
        skip_end=True,
        v=0,
        seed=3,
    )
    assert run_pipeline(prm) == 0
    want_exact, want_approx = oracle_outputs(
        reads, K, SL, 1.0, LIMIT, solid_km=3
    )
    assert open(str(exact) + "_0.start").read() == want_exact
    assert open(str(out) + "_0.start").read() == want_approx
    # intended skip: no end files
    import os

    assert not os.path.exists(str(out) + "_0.end")


def test_multi_run_suffixes(fasta, tmp_path):
    path, _ = fasta
    out = tmp_path / "o.txt"
    prm = Params(
        input_file=str(path),
        output=str(out),
        k=K,
        sl=SL,
        sn=4,
        limit=5,
        nb_of_runs=2,
        v=1,
        seed=11,
    )
    assert run_pipeline(prm) == 0
    import os

    for r in range(2):
        for e in ("start", "end"):
            assert os.path.exists(f"{out}_{r}.{e}")


def test_prefetch_pass_equals_sequential(rng):
    """The pipelined path (_PendingPass + prefetch device_put) must return
    exactly what the sequential fused path returns."""
    from approx_counter_tpu.pipeline import Engine

    prm = Params(input_file="<mem>", output="/tmp/x", k=K, sl=SL, limit=LIMIT)
    eng = Engine(prm)
    windows = rng.integers(0, 4, (64, SL + 1)).astype(np.uint8)
    from approx_counter_tpu.core.codec import BASE_PAD

    windows[:, -1] = BASE_PAD  # start-style trailing pad column
    n_valid = 61

    (e1, c1), (a1, n1), s1 = eng.count_one_end(windows, n_valid)
    (e2, c2), (a2, n2), s2 = eng.start_pass(
        windows, n_valid, prefetch=True
    ).finish()
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(n1, n2)
    assert s1 == s2


def test_multirun_pipelined_rng_order(fasta, tmp_path):
    """Cross-run prefetching must not change the sampling draw order:
    seeded sub-sampled multi-run outputs equal a manually-driven
    sequential run (start0, end0, start1, end1 rng order)."""
    from approx_counter_tpu.io.export import export_counter
    from approx_counter_tpu.io.fastx import read_fastx
    from approx_counter_tpu.pipeline import WT, Engine
    from approx_counter_tpu.sample.sampler import sample_windows

    path, _ = fasta
    out = tmp_path / "o.txt"
    prm = Params(
        input_file=str(path), output=str(out), k=K, sl=SL,
        sn=5,  # sub-sampled: draw order matters
        limit=7, nb_of_runs=2, v=0, seed=99,
    )
    assert run_pipeline(prm) == 0

    reads = read_fastx(str(path))
    rng = np.random.default_rng(99)
    eng = Engine(prm)
    for r in range(2):
        for end in (False, True):
            batch = sample_windows(reads, 5, SL, end=end, rng=rng, pad_to=WT)
            _, (ac, an), _ = eng.count_one_end(batch.windows, batch.n_valid)
            want = tmp_path / f"want_{r}.{'end' if end else 'start'}"
            assert export_counter(ac, an, K, str(want))
            got = f"{out}_{r}.{'end' if end else 'start'}"
            assert open(got).read() == open(want).read()


def test_n_reads_byte_parity_and_warning(tmp_path, capsys):
    """End-to-end with N-containing reads: exercises the sparse-N window
    transfer (2-bit plane + scatter list) through the fused pass -- byte
    parity vs the oracle plus the reference's had-N stderr warning."""
    rng = np.random.default_rng(31)
    k, sl, limit, n_reads = 6, 16, 12, 10
    reads = []
    for i in range(n_reads):
        s = list(codes_to_seq(rng.integers(0, 4, 40).astype(np.uint8)))
        if i % 3 != 2:  # Ns inside both the start and end windows
            s[rng.integers(0, sl)] = "N"
            s[40 - 1 - rng.integers(0, sl)] = "N"
        reads.append("".join(s))
    p = tmp_path / "r.fasta"
    with open(p, "w") as f:
        for i, s in enumerate(reads):
            f.write(f">r{i}\n{s}\n")
    out, exact = tmp_path / "o.txt", tmp_path / "e.txt"
    prm = Params(
        input_file=str(p), output=str(out), exact_out=str(exact),
        k=k, sl=sl, sn=n_reads, limit=limit, param_lc=1000.0, v=0, seed=4,
    )
    assert run_pipeline(prm) == 0
    err = capsys.readouterr().err
    assert "sequences with 'N' symbols" in err
    for end in (False, True):
        suffix = "_0.end" if end else "_0.start"
        want_exact, want_approx = oracle_outputs(
            reads, k, sl, 1000.0, limit, end=end
        )
        assert open(str(exact) + suffix).read() == want_exact, suffix
        assert open(str(out) + suffix).read() == want_approx, suffix


def test_start_pass_device_resident_batch(rng):
    """A device-resident window batch must dispatch directly (raw fused
    variant) and return exactly what the host-batch path returns."""
    import jax.numpy as jnp

    from approx_counter_tpu.pipeline import Engine

    prm = Params(input_file="<mem>", output="/tmp/x", k=K, sl=SL, limit=LIMIT)
    eng = Engine(prm)
    windows = rng.integers(0, 4, (64, SL + 1)).astype(np.uint8)
    n_valid = 60

    want = eng.start_pass(windows, n_valid).finish()
    got = eng.start_pass(jnp.asarray(windows), n_valid).finish()
    np.testing.assert_array_equal(want[0][0], got[0][0])
    np.testing.assert_array_equal(want[0][1], got[0][1])
    np.testing.assert_array_equal(want[1][0], got[1][0])
    np.testing.assert_array_equal(want[1][1], got[1][1])
    assert want[2] == got[2]


def test_solid_mode_fused_cap_regrowth(rng):
    """Solid mode rides the fused single-dispatch pass (round 4); when the
    data-dependent candidate count exceeds the initial cap (512), finish()
    must re-trace at the true size and stay byte-correct vs the oracle."""
    from approx_counter_tpu.core.codec import join_code, split_code  # noqa
    from approx_counter_tpu.pipeline import Engine

    k, sl, n = 6, 31, 40
    windows = np.full((n, sl + 1), 5, np.uint8)
    windows[:, :sl] = rng.integers(0, 4, (n, sl))
    prm = Params(input_file="<mem>", output="/tmp/x", k=k, sl=sl,
                 solid_km=1, limit=100, param_lc=100.0)
    eng = Engine(prm)
    pend = eng.start_pass(windows, n)
    assert pend.cap == 512
    (ec, ecnt), (ac, acnt), stats = pend.finish()
    assert stats["n_keep"] > 512  # the regrowth actually happened

    wins_list = [windows[i, :sl] for i in range(n)]
    lc = adjust_threshold(100.0, 16, k)
    counter, _ = oracle_count_kmers(wins_list, k, lc, set())
    want_sel = oracle_get_solid_kmers(counter, 1, k)
    want_sel = oracle_sort_compare_count(dict(want_sel), k)  # quirk 5:
    # deterministic CompareCount order replaces the ref's tie-free sort
    assert stats["n_keep"] == len(want_sel)
    assert list(zip(ec.tolist(), ecnt.tolist())) == want_sel
    approx = oracle_error_count(wins_list, [c for c, _ in want_sel], k)
    ranked = oracle_sort_compare_count(approx, k)[: prm.limit]
    assert list(zip(ac.tolist(), acnt.tolist())) == ranked


def test_dense_fallback_fused_packed_output(rng):
    """A batch with more Ns than the sparse format's scatter cap falls
    back to the dense two-plane format -- which must flow through the
    round-4 packed-output plumbing identically to the sparse path."""
    from approx_counter_tpu.core.codec import pack_windows_sparse
    from approx_counter_tpu.pipeline import Engine

    k, sl, n = 6, 31, 64
    windows = np.full((n, sl + 1), 5, np.uint8)
    windows[:, :sl] = rng.integers(0, 4, (n, sl))
    prm = Params(input_file="<mem>", output="/tmp/x", k=k, sl=sl,
                 limit=20, param_lc=100.0)
    noisy = windows.copy()
    pos = rng.integers(0, sl, size=(n, 10))
    for i in range(n):
        noisy[i, pos[i]] = 4  # 640 Ns
    assert pack_windows_sparse(noisy, n, ncap=16) is None  # would fall back
    eng2 = Engine(prm)

    import approx_counter_tpu.core.codec as codec

    orig = codec.pack_windows_sparse
    try:
        codec_pws = lambda w, nv, **kw: orig(w, nv, ncap=16)  # noqa: E731
        import approx_counter_tpu.pipeline as pl_mod

        pl_mod.pack_windows_sparse = codec_pws
        got = eng2.start_pass(noisy, n).finish()
    finally:
        pl_mod.pack_windows_sparse = orig
    # same batch through the sparse path (default ncap comfortably holds
    # 640 Ns) must agree byte-for-byte with the dense fallback
    eng3 = Engine(prm)
    want2 = eng3.start_pass(noisy, n).finish()
    for a, b in zip(got[:2], want2[:2]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert got[2] == want2[2]
    assert got[2]["had_n"] > 0
