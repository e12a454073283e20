"""Mesh-invariance tests on the virtual 8-device CPU mesh (SURVEY.md §4.4).

Counting is order-independent (§3C), so results must be identical across
mesh shapes 1/2/4/8 -- the determinism assertion that replaces the
reference's thread-safety argument.
"""

import functools

import jax
import numpy as np
import pytest

from approx_counter_tpu.core.codec import encode_kmer, split_code
from approx_counter_tpu.dist.mesh import (
    approx_counts_sharded,
    data_mesh,
    shard_windows,
)
from approx_counter_tpu.kernels.bpm import (
    approx_counts_jnp,
    approx_counts_kernel,
    build_peq,
)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_approx_counts_mesh_invariant(n_dev, rng):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough virtual devices")
    k, C, W, m = 16, 8, 64, 40
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    codes = np.array([encode_kmer(p) for p in pats], dtype=np.uint64)
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    for w in range(0, W, 4):
        pos = rng.integers(0, m - k + 1)
        wins[w, pos : pos + k] = pats[w % C]
    valid = np.ones(W, bool)
    valid[-5:] = False
    hi, lo = split_code(codes)
    peq = build_peq(hi, lo, k)

    want = np.asarray(approx_counts_jnp(peq, wins.T.copy(), valid, k))

    mesh = data_mesh(jax.devices()[:n_dev])
    # pre-place the batch with the production sharding helper; shard_map
    # then consumes the already-sharded arrays without a relayout
    ws, vs = shard_windows(wins.T.copy(), valid, mesh)
    got = np.asarray(
        approx_counts_sharded(peq, ws, vs, k, mesh=mesh, impl="jnp")
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("k,maxerr", [(16, 2), (5, 3)])
def test_kernel_under_shard_map(n_dev, k, maxerr, rng):
    """The multi-card compute path: the GPU kernel (interpreted) inside
    shard_map + psum on the virtual CPU mesh -- validates the specs and
    shapes of the per-shard pallas_call, with shards that are not a
    multiple of the kernel's window tile."""
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough virtual devices")
    C, W, m = 40, 96 * n_dev, 40
    pats = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(C)]
    codes = np.array([encode_kmer(p) for p in pats], dtype=np.uint64)
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)  # incl. N + pad
    for w in range(0, W, 4):
        pos = rng.integers(0, m - k + 1)
        wins[w, pos : pos + k] = pats[w % C]
    valid = np.ones(W, bool)
    valid[-5:] = False
    hi, lo = split_code(codes)
    peq = build_peq(hi, lo, k)

    want = np.asarray(approx_counts_jnp(peq, wins.T.copy(), valid, k,
                                        maxerr=maxerr))
    mesh = data_mesh(jax.devices()[:n_dev])
    got = np.asarray(
        approx_counts_sharded(
            peq, wins.T.copy(), valid, k, mesh=mesh, maxerr=maxerr,
            counts_fn=functools.partial(approx_counts_kernel,
                                        interpret=True),
        )
    )
    np.testing.assert_array_equal(got, want)


def test_exact_count_sharded_matches_single(rng):
    """jit auto-SPMD over sharded windows == single-device result."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from approx_counter_tpu.core.codec import join_code
    from approx_counter_tpu.core.complexity import lc_sum_threshold
    from approx_counter_tpu.count.exact import exact_count_select

    k, n, m = 8, 64, 30
    windows = rng.integers(0, 4, (n, m)).astype(np.uint8)
    args = dict(
        k=k, cap=64, n_forbidden=0, use_solid=False,
    )
    fhi = np.empty(0, np.uint32)
    flo = np.empty(0, np.uint32)
    thr = np.int32(lc_sum_threshold(100.0, k))

    single = exact_count_select(
        windows, np.int32(n), args["k"], thr, fhi, flo,
        np.int32(20), np.int32(0), cap=64, n_forbidden=0, use_solid=False,
    )

    mesh = data_mesh(jax.devices()[:8])
    wsharded = jax.device_put(windows, NamedSharding(mesh, P("data", None)))
    sharded = exact_count_select(
        wsharded, np.int32(n), args["k"], thr, fhi, flo,
        np.int32(20), np.int32(0), cap=64, n_forbidden=0, use_solid=False,
    )
    np.testing.assert_array_equal(
        join_code(np.asarray(single["sel_hi"]), np.asarray(single["sel_lo"])),
        join_code(np.asarray(sharded["sel_hi"]), np.asarray(sharded["sel_lo"])),
    )
    np.testing.assert_array_equal(
        np.asarray(single["sel_count"]), np.asarray(sharded["sel_count"])
    )


class TestMultihost:
    def test_shard_paths_partition(self):
        from approx_counter_tpu.dist.multihost import shard_paths

        paths = [f"f{i}" for i in range(7)]
        shards = [shard_paths(paths, i, 3) for i in range(3)]
        # disjoint and complete
        flat = [p for s in shards for p in s]
        assert sorted(flat) == sorted(paths)
        assert len(set(flat)) == len(paths)

    def test_global_windows_single_process(self, rng):
        import jax

        from approx_counter_tpu.dist.mesh import data_mesh
        from approx_counter_tpu.dist.multihost import global_windows

        mesh = data_mesh(jax.devices()[:4])
        local = rng.integers(0, 4, (16, 10)).astype(np.uint8)
        arr = global_windows(local, mesh)
        assert arr.shape == (16, 10)  # single process: local == global
        np.testing.assert_array_equal(np.asarray(arr), local)


class TestMultihostPipeline:
    def test_single_process_degrade_matches_stream(self, tmp_path, rng):
        """process_count==1: the multihost driver must produce the same
        bytes as the single-host streaming pipeline at identity sampling."""
        from approx_counter_tpu.core.codec import codes_to_seq
        from approx_counter_tpu.dist.multihost import run_pipeline_multihost
        from approx_counter_tpu.params import Params
        from approx_counter_tpu.pipeline import run_pipeline

        sl, k = 12, 6
        seqs = [codes_to_seq(rng.integers(0, 4, 40)) for _ in range(20)]
        fa = tmp_path / "r.fasta"
        with open(fa, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">r{i}\n{s}\n")
        prm_mh = Params(input_file=str(fa), output=str(tmp_path / "mh.txt"),
                        exact_out=str(tmp_path / "mhe.txt"),
                        k=k, sl=sl, sn=100, limit=10, v=0, seed=1,
                        multihost=True)
        assert run_pipeline_multihost(prm_mh) == 0
        prm_s = Params(input_file=str(fa), output=str(tmp_path / "s.txt"),
                       exact_out=str(tmp_path / "se.txt"),
                       k=k, sl=sl, sn=100, limit=10, v=0, seed=1,
                       stream=True)
        assert run_pipeline(prm_s) == 0
        for end in ("start", "end"):
            assert (tmp_path / f"mh.txt_0.{end}").read_bytes() == (
                tmp_path / f"s.txt_0.{end}"
            ).read_bytes(), end
            assert (tmp_path / f"mhe.txt_0.{end}").read_bytes() == (
                tmp_path / f"se.txt_0.{end}"
            ).read_bytes(), end

    def test_single_process_degrade_stdout_parity(self, tmp_path, rng,
                                                  capsys):
        """CLI parity (round-4 verdict #3): at process_count==1 the
        multihost driver's *stdout* -- parameter echo, every mr_v log
        line, counts -- must equal the single-host streaming pipeline's,
        modulo the [ms] wall-clock prefixes."""
        import re

        from approx_counter_tpu.core.codec import codes_to_seq
        from approx_counter_tpu.dist.multihost import run_pipeline_multihost
        from approx_counter_tpu.params import Params
        from approx_counter_tpu.pipeline import run_pipeline

        sl, k = 12, 6
        seqs = [codes_to_seq(rng.integers(0, 4, 40)) for _ in range(20)]
        fa = tmp_path / "r.fasta"
        with open(fa, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">r{i}\n{s}\n")

        def strip_ts(text):
            return re.sub(r"\[[0-9.]+ ms\]", "[ms]", text)

        prm_mh = Params(input_file=str(fa), output=str(tmp_path / "mh.txt"),
                        exact_out=str(tmp_path / "mhe.txt"),
                        k=k, sl=sl, sn=100, limit=10, v=1, seed=1,
                        multihost=True)
        assert run_pipeline_multihost(prm_mh) == 0
        out_mh = strip_ts(capsys.readouterr().out)
        prm_s = Params(input_file=str(fa), output=str(tmp_path / "s.txt"),
                       exact_out=str(tmp_path / "se.txt"),
                       k=k, sl=sl, sn=100, limit=10, v=1, seed=1,
                       stream=True)
        assert run_pipeline(prm_s) == 0
        out_s = strip_ts(capsys.readouterr().out)
        assert out_mh == out_s

    def test_single_process_degrade_quirks_and_resume(self, tmp_path, rng):
        """--compat-quirks and --from-exact work through the multihost
        driver (round-4 verdict #3: feature parity, not just echo)."""
        from approx_counter_tpu.core.codec import codes_to_seq
        from approx_counter_tpu.dist.multihost import run_pipeline_multihost
        from approx_counter_tpu.params import Params

        sl, k = 12, 6
        fa = tmp_path / "r.fasta"
        with open(fa, "w") as f:
            for i in range(20):
                f.write(f">r{i}\n{codes_to_seq(rng.integers(0, 4, 40))}\n")

        # skip_end honored: only .start files appear
        prm = Params(input_file=str(fa), output=str(tmp_path / "a.txt"),
                     k=k, sl=sl, sn=100, limit=10, v=0, seed=1,
                     skip_end=True, multihost=True)
        assert run_pipeline_multihost(prm) == 0
        assert (tmp_path / "a.txt_0.start").exists()
        assert not (tmp_path / "a.txt_0.end").exists()

        # compat-quirks + muted verbosity: the reference bug runs a second
        # pass with bottom == false -- a START re-sample exported under
        # `.end` (approx_counter.cpp:943-953).  At identity sampling the
        # re-sample is the same set, so `.end` byte-equals `.start`.
        prm = Params(input_file=str(fa), output=str(tmp_path / "b.txt"),
                     k=k, sl=sl, sn=100, limit=10, v=0, seed=1,
                     skip_end=True, compat_quirks=True, multihost=True)
        assert run_pipeline_multihost(prm) == 0
        assert ((tmp_path / "b.txt_0.end").read_text()
                == (tmp_path / "b.txt_0.start").read_text())

        # --from-exact resume: candidates from a prior exact export
        prm = Params(input_file=str(fa), output=str(tmp_path / "c.txt"),
                     exact_out=str(tmp_path / "ce.txt"),
                     k=k, sl=sl, sn=100, limit=10, v=0, seed=1,
                     multihost=True)
        assert run_pipeline_multihost(prm) == 0
        prm2 = Params(input_file=str(fa), output=str(tmp_path / "d.txt"),
                      k=k, sl=sl, sn=100, limit=10, v=0, seed=1,
                      multihost=True,
                      from_exact=str(tmp_path / "ce.txt_0.start"))
        assert run_pipeline_multihost(prm2) == 0
        # same candidate set + identity sampling => same approx ranking
        assert (tmp_path / "d.txt_0.start").read_bytes() == (
            tmp_path / "c.txt_0.start"
        ).read_bytes()


class TestDryrunStretch:
    """Virtual-mesh evidence beyond the driver's 8-device dryrun (round-4
    verdict #9): 16 and 32 virtual devices, plus production-like shapes
    (k=16 / cap=512 / m=101) -- each in a subprocess because the device
    count is fixed at process start."""

    _WORKER = (
        "import sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(int(sys.argv[2]),\n"
        "                   production=sys.argv[3] == '1')\n"
        "print('ok')\n"
    )

    @pytest.mark.parametrize("n,production", [(16, False), (32, False),
                                              (16, True)])
    def test_dryrun_stretch(self, n, production, tmp_path):
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        worker = tmp_path / "w.py"
        worker.write_text(self._WORKER)
        env = {k_: v_ for k_, v_ in os.environ.items()
               if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
        r = subprocess.run(
            [sys.executable, str(worker), repo, str(n),
             "1" if production else "0"],
            env=env, capture_output=True, text=True, timeout=540,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "ok" in r.stdout


class TestMultihostSolidRegrowth:
    def test_end_pass_regrows_its_own_cap(self, tmp_path, rng):
        """Regression (round-4 review): both ends pre-dispatch at the
        initial cap; when the start pass's regrowth enlarged the SHARED
        cap, the end pass's stale smaller-cap arrays passed the n_keep
        check and results were silently truncated.  Solid mode with
        ~1000 candidates per end forces both passes to regrow."""
        from approx_counter_tpu.core.codec import codes_to_seq
        from approx_counter_tpu.dist.multihost import run_pipeline_multihost
        from approx_counter_tpu.params import Params
        from approx_counter_tpu.pipeline import run_pipeline

        sl, k = 31, 6
        fa = tmp_path / "r.fasta"
        with open(fa, "w") as f:
            for i in range(40):
                f.write(f">r{i}\n{codes_to_seq(rng.integers(0, 4, 70))}\n")
        common = dict(k=k, sl=sl, sn=100, limit=100, solid_km=1,
                      param_lc=100.0, v=0, seed=3)
        prm_mh = Params(input_file=str(fa), output=str(tmp_path / "m.txt"),
                        exact_out=str(tmp_path / "me.txt"),
                        multihost=True, **common)
        assert run_pipeline_multihost(prm_mh) == 0
        prm_s = Params(input_file=str(fa), output=str(tmp_path / "s.txt"),
                       exact_out=str(tmp_path / "se.txt"),
                       stream=True, **common)
        assert run_pipeline(prm_s) == 0
        for end in ("start", "end"):
            me = (tmp_path / f"me.txt_0.{end}").read_bytes()
            se = (tmp_path / f"se.txt_0.{end}").read_bytes()
            assert me == se, end
            # the point of the fixture: way more candidates than the cap
            assert me.count(b"\n") > 512, end
            assert (tmp_path / f"m.txt_0.{end}").read_bytes() == (
                tmp_path / f"s.txt_0.{end}").read_bytes(), end


class TestDryrunDifferentialGate:
    """dryrun_multichip is a differential gate (round-4 verdict #5): the
    n-device mesh output must byte-equal a 1-device run.  The negative
    case proves a deliberately-broken psum (double allreduce => counts
    multiplied by the device count) FAILS the comparison that the old
    bounds checks (n_keep > 0, count <= 3*W_valid on small fixtures)
    could let through."""

    def test_dryrun_differential_passes(self):
        import __graft_entry__ as g

        g.dryrun_multichip(len(jax.devices()))

    def test_broken_psum_fails_gate(self):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        import __graft_entry__ as g
        from approx_counter_tpu.core.complexity import lc_sum_threshold
        from approx_counter_tpu.count.approx import rank_with_zero_counts
        from approx_counter_tpu.count.exact import exact_count_select_rows
        from approx_counter_tpu.dist.mesh import data_mesh, make_full_step
        from approx_counter_tpu.kernels.bpm import approx_counts, build_peq

        n = len(jax.devices())
        k, cap, m = 8, 64, 24
        W = 16 * n
        rng = np.random.default_rng(1)
        windows = rng.integers(0, 4, (W, m)).astype(np.uint8)
        wvalid = np.ones(W, bool)
        wvalid[-3:] = False
        mesh = data_mesh()
        axis = "data"

        def broken_counts(peq, windows_t, window_valid):
            def shard_fn(peq_rep, wt_shard, wv_shard):
                counts = approx_counts(peq_rep, wt_shard, wv_shard, k,
                                       impl="jnp")
                # BROKEN: psum twice -- the merged total is re-summed
                # across devices, multiplying every count by n
                return jax.lax.psum(jax.lax.psum(counts, axis), axis)

            return jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=(P(), P(None, axis), P(axis)), out_specs=P(),
                check_vma=False,
            )(peq, windows_t, window_valid)

        @jax.jit
        def broken_step(w, wv, lc_thr, fhi, flo, limit, solid_km):
            out = exact_count_select_rows(
                w, wv, k, lc_thr, fhi, flo, limit, solid_km, cap=cap,
                n_forbidden=0, use_solid=False,
            )
            peq = build_peq(out["sel_hi"], out["sel_lo"], k)
            counts = broken_counts(peq, jnp.transpose(w, (1, 0)), wv)
            a_hi, a_lo, a_cnt, a_val = rank_with_zero_counts(
                out["sel_hi"], out["sel_lo"], counts, out["sel_valid"], k
            )
            return dict(exact=out, approx_hi=a_hi, approx_lo=a_lo,
                        approx_count=a_cnt, approx_valid=a_val)

        scalars = (jnp.int32(lc_sum_threshold(100.0, k)),
                   jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.uint32),
                   jnp.int32(20), jnp.int32(0))
        w_sh = jax.device_put(jnp.asarray(windows),
                              NamedSharding(mesh, P(axis, None)))
        wv_sh = jax.device_put(jnp.asarray(wvalid),
                               NamedSharding(mesh, P(axis)))
        bad = broken_step(w_sh, wv_sh, *scalars)

        mesh1 = data_mesh(jax.devices()[:1])
        step1 = make_full_step(mesh1, k, cap, impl="jnp")
        good = step1(
            jax.device_put(jnp.asarray(windows),
                           NamedSharding(mesh1, P(axis, None))),
            jax.device_put(jnp.asarray(wvalid),
                           NamedSharding(mesh1, P(axis))),
            *scalars,
        )
        mism = g.output_mismatches(bad, good)
        assert mism, "double-psum output slipped through the gate"
        assert any("approx_count" in p for p in mism), mism
