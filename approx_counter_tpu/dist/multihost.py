"""Multi-host orchestration (one or more hosts, each with local devices).

The reference is a single shared-memory process; this is the framework's
scale-out story (BASELINE.json configs 4-5): per-host FASTQ shards, a
global device mesh, and psum-merged counts (NVLink between the cards of a
host, the network across hosts).  With one process it shards the windows
over every local device.

Flow (every host runs the same program, SPMD):

  1. ``initialize()``            -- jax.distributed handshake
  2. ``shard_paths(paths)``      -- round-robin input files to this host
  3. each host streams its shard through the distributed bottom-k sampler
     (dist/sampling.py): i.i.d. uint64 priorities per eligible read, one
     small priority allgather, identical global-cutoff computation on
     every host.  The union is a uniform min(sn, N_eligible)-subset of
     the union of eligible reads for ANY shard sizes -- including
     unbalanced shards, where fixed per-host quotas would not be
     uniform.
  4. ``global_windows(local)``   -- assemble a jax.Array whose shards are
     the per-host window batches (make_array_from_process_local_data)
  5. ``dist.mesh.make_full_step``-- the same jitted step as single-host:
     exact count via XLA's distributed sort, BPM via shard_map, counts
     psum-merged; selections/rankings replicated on every host
  6. host 0 logs and exports (CLI parity with pipeline.run_pipeline:
     same parameter echo, clamp/had_n warnings, mr_v log lines,
     --compat-quirks, --from-exact; both ends dispatch before either
     fetch, so the end pass's device work overlaps the start pass's
     fetch/export).

Only step 1 needs real multi-host hardware; everything below it is the
mesh-shape-invariant code validated on virtual devices (tests/test_dist.py)
-- counting is order-independent, so the multi-host result equals the
single-host result on the same sampled windows.

Intentional divergences from the single-host driver are listed in
COMPAT.md ("Multihost divergences").
"""

from __future__ import annotations

import sys
import time

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed handshake; arguments default to JAX's environment
    auto-detection (JAX_COORDINATOR_ADDRESS et al.)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def shard_paths(
    paths: list[str],
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[str]:
    """Deterministic round-robin assignment of input files to this host."""
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    return [p for i, p in enumerate(paths) if i % process_count == process_index]


def global_windows(
    local_windows: np.ndarray, mesh: Mesh, axis: str = "data"
) -> jax.Array:
    """Assemble the global row-sharded window array from per-host batches.

    Every host passes its local [W_local, m] batch (same m, W_local equal
    across hosts -- pad with BASE_PAD rows + validity masking as usual);
    the result is a global [W_local * n_hosts, m] jax.Array sharded along
    ``axis``.

    The batch ships raw uint8 (not the single-device sparse-N 2-bit
    format): make_array_from_process_local_data needs the final row
    layout, and each host feeds only its local devices.
    """
    sharding = NamedSharding(mesh, P(axis, None))
    return jax.make_array_from_process_local_data(sharding, local_windows)


def run_pipeline_multihost(prm, log=None, devices=None) -> int:
    """SPMD multi-host driver: every host runs this same function.

    ``prm.input_file`` may be a comma-separated list of files; each host
    streams its round-robin shard; the sample is globally uniform over
    the union of eligible reads (dist/sampling.py).  Host 0 logs and
    exports; stdout (modulo [ms] timestamps) matches
    ``pipeline.run_pipeline`` with ``--stream`` at identity sampling.
    With process_count == 1 this degrades to a single-host run (how it
    is tested here).  ``devices`` restricts the mesh (default: every
    device); counts do not depend on it.

    Mirrors the reference main loop (approx_counter.cpp:679-957) with
    the same log-line sequence as the single-host driver.
    """
    import jax.numpy as jnp

    from approx_counter_tpu.core.codec import join_code, split_code
    from approx_counter_tpu.core.complexity import lc_sum_threshold
    from approx_counter_tpu.dist.mesh import (
        data_mesh,
        make_approx_step,
        make_full_step,
    )
    from approx_counter_tpu.dist.sampling import distributed_sample_windows
    from approx_counter_tpu.io.kmer_list import parse_kmer_list
    from approx_counter_tpu.io.logging import Log, warn
    from approx_counter_tpu.kernels.bpm import resolve_impl
    from approx_counter_tpu.pipeline import (
        CT,
        WT,
        candidates_from_codes,
        echo_params,
        report_and_export_end,
    )

    log = log or Log()
    pc, pi = jax.process_count(), jax.process_index()
    is_host0 = pi == 0
    # host 0 carries all user-visible output; control flow uses the
    # unmuted values so every host executes the same collectives
    v = prm.v if is_host0 else 0
    mr_v = prm.mr_v if is_host0 else 0

    if prm.forbid_kmer and is_host0:
        # (typo "fobidden" preserved from approx_counter.cpp:767)
        log("Parsing the fobidden kmer list")

    try:
        prm.validate()
        resolve_impl(prm.bpm_impl)
    except ValueError as e:
        if is_host0:
            sys.stderr.write(str(e) + "\n")
        return 1

    echo_params(prm, v)

    tab_level = 0
    if v > 0 and prm.nb_of_runs > 1:
        print(f"\nA total of {prm.nb_of_runs} runs will be performed.")

    mesh = data_mesh(devices)
    n_local_dev = len([d for d in mesh.devices.flat
                       if d.process_index == pi])

    def round_up(x, mult):
        return ((x + mult - 1) // mult) * mult

    if prm.forbid_kmer:
        forb = parse_kmer_list(prm.forbid_kmer)
    else:
        forb = np.empty(0, np.uint64)
    fhi, flo = split_code(forb)
    lc_thr = jnp.int32(lc_sum_threshold(prm.adjusted_lc, prm.k))

    paths = prm.input_file.split(",")
    my_paths = shard_paths(paths, pi, pc)

    # priority streams must differ per host (independent uniform keys)
    rng = np.random.default_rng(
        None if prm.seed is None else prm.seed + 1000003 * pi
    )

    resume_codes = None
    if prm.from_exact:
        from approx_counter_tpu.io.export import parse_exact_export

        resume_codes = parse_exact_export(prm.from_exact, prm.k)
        if v > 0:
            log(f"Resuming from {len(resume_codes)} exact-count candidates")

    cap = max(512, round_up(min(prm.limit, 1 << 20), CT))
    steps: dict[int, object] = {}  # cap -> jitted step (avoid retracing)
    approx_step = None

    def get_step(c):
        if c not in steps:
            steps[c] = make_full_step(
                mesh, prm.k, c,
                n_forbidden=len(forb), use_solid=prm.solid_km > 0,
                maxerr=prm.max_error, impl=prm.bpm_impl,
            )
        return steps[c]

    def get_approx_step():
        nonlocal approx_step
        if approx_step is None:
            approx_step = make_approx_step(mesh, prm.k,
                                           maxerr=prm.max_error,
                                           impl=prm.bpm_impl)
        return approx_step

    sn = prm.sn
    # reference skip_end bug gate: same flag on every host (prm.mr_v, not
    # the host-muted mr_v -- hosts must run identical collectives).  The
    # faithful bug (approx_counter.cpp:943-953): the muted break never
    # fires AND `bottom = true` (in the else of if(skip_end)) never
    # executes, so the second pass re-samples the START and exports it
    # under `.end`.
    runs_end_pass = (not prm.skip_end) or (prm.compat_quirks and
                                           prm.mr_v == 0)
    quirk_end_is_start = prm.skip_end and runs_end_pass

    for current_run in range(prm.nb_of_runs):
        run_suffix = f"_{current_run}"
        if prm.nb_of_runs > 1 and v > 0:
            print(f"Starting run number {current_run + 1}")

        if mr_v > 0:
            log("Streaming pass (reservoir sampling both ends)", tab_level)
        t_stream = time.perf_counter()
        b_start, b_end, n_reads, g_counts = distributed_sample_windows(
            my_paths, sn, prm.sl, rng=rng, process_count=pc,
            process_index=pi, row_mult=WT * n_local_dev,
            end_is_start=quirk_end_is_start, v=mr_v,
        )
        t_stream = time.perf_counter() - t_stream
        batches = {"start": (b_start, g_counts[0]),
                   "end": (b_end, g_counts[1])}
        if v > 0 and current_run == 0:
            log(f"Number of sequences found: {n_reads}.", tab_level)

        if sn > n_reads:  # clamp-by-mutation quirk (:844-848)
            if is_host0:
                warn("Sequence set too small for the requested sample size")
                warn("The whole set will be used.")
            sn = n_reads

        # dispatch phase: both ends queue on device before either fetch,
        # so the end pass's compute overlaps the start pass's fetch and
        # host-side export (the multihost analog of _PendingPass)
        limit32 = jnp.int32(min(prm.limit, np.iinfo(np.int32).max))

        def dispatch(batch):
            """-> a redispatch closure: cap -> device output (the cap is
            bound at each call, NOT here -- the caller records which cap
            each in-flight output was built with)."""
            gw = global_windows(batch.windows, mesh)
            wvalid_local = np.zeros(batch.windows.shape[0], bool)
            wvalid_local[: batch.n_valid] = True
            gv = jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("data")), wvalid_local
            )
            if resume_codes is not None:
                sel_hi, sel_lo, sel_valid, _rcap = candidates_from_codes(
                    resume_codes
                )
                dev = get_approx_step()(gw, gv, jnp.asarray(sel_hi),
                                        jnp.asarray(sel_lo),
                                        jnp.asarray(sel_valid))
                return lambda _c: dev
            return lambda c2: get_step(c2)(
                gw, gv, lc_thr, jnp.asarray(fhi), jnp.asarray(flo),
                limit32, jnp.int32(prm.solid_km)
            )

        ends = ("start", "end") if runs_end_pass else ("start",)
        pending = {}
        for which_end in ends:
            redispatch = dispatch(batches[which_end][0])
            # each pending pass carries the cap its arrays were built
            # with -- checking n_keep against a LATER-grown shared cap
            # would silently accept truncated results
            pending[which_end] = (redispatch, redispatch(cap), cap)

        tab_level += 1
        for which_end in ("start", "end"):
            bottom = which_end == "end" and not quirk_end_is_start
            if v > 0:
                log(f"Working on sequence {which_end}.", tab_level - 1)
            if mr_v > 0:
                log("Sampling", tab_level)
                log(
                    "Sampling the ends of reads"
                    if bottom
                    else "Sampling the start of reads",
                    tab_level,
                )
            batch, g_n = batches[which_end]
            if mr_v > 0:
                log(f"Sampled {g_n} sequences", tab_level)

            if mr_v > 0:
                log("Exact k-mer count", tab_level)
            t_count = time.perf_counter()
            redispatch, dev, dcap = pending[which_end]
            if resume_codes is not None:
                out = jax.device_get(dev)
                n_approx = min(int(out["approx_valid"].sum()), prm.limit)
                approx_codes = join_code(out["approx_hi"][:n_approx],
                                         out["approx_lo"][:n_approx])
                approx_counts = out["approx_count"][:n_approx].astype(
                    np.uint64)
                exact_codes = resume_codes
                exact_counts = np.zeros(len(resume_codes), np.uint64)
                stats = dict(n_unique=len(resume_codes),
                             n_keep=len(resume_codes), had_n=0)
            else:
                while True:
                    out = jax.device_get(dev)
                    n_keep = int(out["exact"]["n_keep"])
                    if n_keep <= dcap:  # THIS pass's dispatch cap
                        break
                    # solid mode can exceed the cap; every host sees the
                    # same replicated n_keep, so all re-trace identically
                    dcap = round_up(n_keep, CT)
                    cap = max(cap, dcap)  # future dispatches start here
                    dev = redispatch(dcap)
                ex = out["exact"]
                exact_codes = join_code(ex["sel_hi"][:n_keep],
                                        ex["sel_lo"][:n_keep])
                exact_counts = ex["sel_count"][:n_keep].astype(np.uint64)
                n_approx = min(int(out["approx_valid"].sum()), prm.limit)
                approx_codes = join_code(out["approx_hi"][:n_approx],
                                         out["approx_lo"][:n_approx])
                approx_counts = out["approx_count"][:n_approx].astype(
                    np.uint64)
                stats = dict(n_unique=int(ex["n_unique"]), n_keep=n_keep,
                             had_n=int(ex["had_n"]))
            t_count = time.perf_counter() - t_count
            if mr_v >= 2:
                pairs = stats["n_keep"] * g_n
                log(
                    f"[stats] sample {t_stream * 1e3:.1f} ms | "
                    f"count+score {t_count * 1e3:.1f} ms (pipelined) | "
                    f"{g_n / max(t_count, 1e-9):.0f} windows/s | "
                    f"{pairs / max(t_count, 1e-9):.3g} pairs/s",
                    tab_level,
                )
            ok = report_and_export_end(
                prm, log, mr_v, tab_level, run_suffix, which_end, stats,
                (exact_codes, exact_counts), (approx_codes, approx_counts),
                resume=resume_codes is not None,
                do_export=is_host0, do_warn=is_host0,
            )
            if pc > 1:
                # only host 0 can fail an export; every host must take
                # the SAME return path or the survivors deadlock on the
                # next collective -- one tiny flag allgather per end
                from approx_counter_tpu.dist.sampling import _allgather_rows

                ok = not bool(
                    _allgather_rows(np.array([0 if ok else 1],
                                             np.int64)).max()
                )
            if not ok:
                return 1

            if prm.skip_end:
                if mr_v > 0:
                    log("Skipping end adapter ressearch")
                if not runs_end_pass:
                    break
        tab_level -= 1
    return 0
