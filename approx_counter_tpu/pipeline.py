"""End-to-end pipeline orchestrator.

Mirrors the reference's ``main()`` driver loop
(/root/reference/approx_counter.cpp:679-957): parameter echo, FASTA/FASTQ
parse, then for each run x each end {start, end}: sample -> exact count ->
selection -> optional exact export -> approximate count -> re-rank ->
export.  File naming reproduces the reference exactly: outputs always get a
``_<run>`` suffix plus ``.start`` / ``.end`` (quirk 3, SURVEY.md §5), and
``sn`` is clamped to the read count by *mutation* that persists across
runs/ends (quirk 4, :844-848).

skip_end: the reference's break sits inside ``if(mr_v>0)``
(approx_counter.cpp:943-948) so muted runs process the end anyway -- AND
``bottom = true`` sits in the *else* of ``if(skip_end)`` (:950-952), so
that second pass runs with ``bottom == false``: it RE-SAMPLES THE START
(fresh shuffle, sl-base prefix windows) and exports those counts under
``.end``.  We implement the *intended* skip unless ``compat_quirks`` asks
for the bug, in which case both halves are reproduced faithfully (at
identity sampling the quirk ``.end`` export byte-equals ``.start``).
"""

from __future__ import annotations

import functools
import os
import sys
import time

import jax
import numpy as np

from approx_counter_tpu.core.codec import (
    join_code,
    pack_windows_host,
    pack_windows_sparse,
    split_code,
    unpack_windows_jnp,
    unpack_windows_sparse_jnp,
    unpack_windows_sparse_t_jnp,
)
from approx_counter_tpu.core.complexity import lc_sum_threshold
from approx_counter_tpu.count.approx import approx_count_rank
from approx_counter_tpu.count.exact import exact_count_select
from approx_counter_tpu.io.export import export_counter
from approx_counter_tpu.io.fastx import Reads, read_fastx
from approx_counter_tpu.io.kmer_list import parse_kmer_list
from approx_counter_tpu.io.logging import Log, warn
from approx_counter_tpu.io.stream import stream_sample_windows
from approx_counter_tpu.kernels.bpm import resolve_impl
from approx_counter_tpu.params import Params
from approx_counter_tpu.sample.sampler import sample_windows

#: Shape rounding: candidate caps round up to a multiple of CT and window
#: batches pad to a multiple of WT rows, so nearby sizes share one compiled
#: executable (and the exact stage's row sort finds a wide divisor of the
#: position count, count/exact.py).
CT, WT = 128, 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(jax.jit, static_argnames=("m",))
def _unpack_windows(planes, m: int):
    return unpack_windows_jnp(planes, m)


@functools.partial(jax.jit, static_argnames=("m",))
def _unpack_windows_sparse(lo_planes, n_idx, n_valid, ncols, m: int):
    return unpack_windows_sparse_jnp(lo_planes, n_idx, n_valid, ncols, m)


def _fmt_num(x: float) -> str:
    """C++ default stream float formatting (6 significant digits)."""
    return f"{x:.6g}"


def echo_params(prm: Params, v: int) -> None:
    """The parameter echo block (approx_counter.cpp:793-808), shared with
    the multihost driver so both produce identical stdout."""
    if v <= 0:
        return
    print(f"Kmer size:             {prm.k}")
    print(f"Sampled sequences:     {prm.sn}")
    print(f"Sampling length        {prm.sl}")
    print(f"LC filter threshold:   {_fmt_num(prm.param_lc)}")
    print(f"Adjusted LC threshold: {_fmt_num(prm.adjusted_lc)}")
    print(f"Nb thread:             {prm.nb_thread}")
    if prm.solid_km != 0:
        print(f"Solid kmers:           {prm.solid_km}")
    else:
        print(f"Number of kept kmer:   {prm.limit}")
    print(f"Number of runs:        {prm.nb_of_runs}")
    print(f"Verbosity level:       {v}")


def had_n_warning(had_n: int) -> None:
    """The reference's end-of-count N warning (approx_counter.cpp:513-517),
    emitted to stderr when any k-mer contained an N."""
    if had_n > 0:
        sys.stderr.write(
            "/!\\ WARNING: This dataset contained sequences with 'N' "
            "symbols. /!\\ WARNING: Current implementation ignores "
            "k-mers containing 'N'."
            f"/!\\ WARNING: A total of {had_n} k-mers were "
            "ignored.\n"
        )


def report_and_export_end(prm, log, mr_v: int, tab_level: int,
                          run_suffix: str, which_end: str, stats: dict,
                          exact_sel, approx_sel, resume: bool,
                          do_export: bool = True,
                          do_warn: bool = True) -> bool:
    """Shared per-end tail of the reference main loop
    (approx_counter.cpp:874-934): had_n warning, selection log lines,
    exact + approx export.  Used by BOTH the single-host and multihost
    drivers so their stdout and failure behavior cannot drift.

    Returns True on success; on an export failure the error text has
    already been written (and the "Done" line suppressed, like the
    reference's early return) -- the caller maps False to exit code 1
    (the multihost driver additionally allgathers the flag so every host
    takes the same return path).  ``do_export``/``do_warn`` are False on
    non-0 multihost ranks, whose mr_v is muted anyway.
    """
    from approx_counter_tpu.io.logging import error

    if do_warn:
        had_n_warning(stats["had_n"])
    if mr_v > 0:
        log(f"Number of kmer found: {stats['n_unique']}", tab_level)
        log(
            "Keeping solid k-mer"
            if prm.solid_km
            else "Keeping most frequent k-mer",
            tab_level,
        )
        log(f"Number of kmer kept:  {stats['n_keep']}", tab_level)

    exact_codes, exact_counts = exact_sel
    approx_codes, approx_counts = approx_sel
    if prm.exact_out and not resume:
        if mr_v > 0:
            log("Exporting exact kmer count", tab_level)
        if do_export:
            path = prm.exact_out + run_suffix + "." + which_end
            if not export_counter(exact_codes, exact_counts, prm.k, path):
                error("Failed to export exact k-mer count")
                sys.stderr.write(f"Path: {path}\n")
                return False

    if mr_v > 0:
        log("Approximate k-mer count", tab_level)
        # errorCount's three stage lines (approx_counter.cpp:536-549),
        # printed at the same tab level between the count announcement and
        # the export line.  The labels name reference stages; the
        # tpu-native equivalents are: "Preparing index" = candidate Peq
        # bitmask table build, "Creating index" = fused-pass device
        # dispatch, "Starting approximate counting" = kernel execution.
        log("Preparing index", tab_level)
        log("Creating index", tab_level)
        log("Starting approximate counting", tab_level)
        log("Exporting approximate count", tab_level)
    if do_export:
        path = prm.output + run_suffix + "." + which_end
        if not export_counter(approx_codes, approx_counts, prm.k, path):
            error("Failed to export approximate k-mer count")
            sys.stderr.write(f"Path: {path}\n")
            return False

    if mr_v > 0:
        log("Done", tab_level)
    return True


def _pack_pass_output(out, cap: int, k: int):
    """Device-side: flatten the fused pass's output dict into ONE uint32
    vector so the host pays a single fetch round trip instead of ~10
    (scalars first, then [cap] blocks; see unpack_pass_output)."""
    import jax.numpy as jnp

    ex = out["exact"]
    head = jnp.stack([
        ex["n_unique"].astype(jnp.uint32),
        ex["n_keep"].astype(jnp.uint32),
        ex["had_n"].astype(jnp.uint32),
        ex["n_pass"].astype(jnp.uint32),
    ])
    parts = [
        head,
        ex["sel_lo"], ex["sel_count"],
        ex["sel_valid"].astype(jnp.uint32),
        out["approx_lo"], out["approx_count"],
        out["approx_valid"].astype(jnp.uint32),
    ]
    if k > 16:
        parts += [ex["sel_hi"], out["approx_hi"]]
    return jnp.concatenate(parts)


def unpack_pass_output(arr: np.ndarray, cap: int, k: int) -> dict:
    """Host-side inverse of :func:`_pack_pass_output` -> the same dict
    shape ``_fused_fn`` returns unpacked."""
    arr = np.asarray(arr)
    blocks = [arr[4 + i * cap: 4 + (i + 1) * cap] for i in range(8)]
    zeros = np.zeros(cap, np.uint32)
    ex = dict(
        n_unique=np.int32(arr[0]), n_keep=np.int32(arr[1]),
        had_n=np.int32(arr[2]), n_pass=np.int32(arr[3]),
        sel_lo=blocks[0], sel_count=blocks[1],
        sel_valid=blocks[2].astype(bool),
        sel_hi=blocks[6] if k > 16 else zeros,
    )
    return dict(
        exact=ex,
        approx_hi=blocks[7] if k > 16 else zeros,
        approx_lo=blocks[3], approx_count=blocks[4],
        approx_valid=blocks[5].astype(bool),
    )


def candidates_from_codes(codes: np.ndarray):
    """Build padded selection arrays from an explicit candidate list
    (resume-from-exact mode).  Codes are re-ranked by CompareCount with
    their file counts ignored (the approx stage re-counts).  Shared by
    the single-host Engine and the multihost driver."""
    cap = max(512, _round_up(max(len(codes), 1), CT))
    hi, lo = split_code(codes)
    sel_hi = np.zeros(cap, np.uint32)
    sel_lo = np.zeros(cap, np.uint32)
    sel_hi[: len(codes)] = hi
    sel_lo[: len(codes)] = lo
    sel_valid = np.zeros(cap, bool)
    sel_valid[: len(codes)] = True
    return sel_hi, sel_lo, sel_valid, cap


class _PendingPass:
    """An in-flight fused top-N pass: dispatched, not yet fetched.

    Splitting dispatch from fetch lets the driver overlap the *next*
    pass's host work (sampling, 2-bit packing, H2D) with this pass's
    device compute.
    """

    def __init__(self, engine: "Engine", redispatch, cap: int):
        self.engine = engine
        self.redispatch = redispatch  # cap -> device dict; kept for the
        #                               (rare) larger-cap re-trace
        self.cap = cap
        # capture the output format at DISPATCH time: a caller may toggle
        # the engine switch while this pass is in flight, and finish must
        # decode what was actually built
        self.packed_out = engine.packed_out
        self.dev = redispatch(cap)

    def finish(self):
        """Block, fetch, and post-process; same contract as
        ``Engine.count_one_end``."""
        engine = self.engine
        cap, dev = self.cap, self.dev
        while True:
            fetched = jax.device_get(dev)
            if self.packed_out:
                out = unpack_pass_output(fetched, cap, engine.prm.k)
            else:
                out = fetched
            n_keep = int(out["exact"]["n_keep"])
            if n_keep <= cap:
                break
            # only reachable when limit > 2^20 unique passing k-mers:
            # the cap clamp truncated; re-trace at the true size
            cap = _round_up(n_keep, CT)
            dev = self.redispatch(cap)
        approx = engine._truncate_approx(
            out["approx_hi"], out["approx_lo"], out["approx_count"],
            out["approx_valid"],
        )
        ex = out["exact"]
        stats = dict(
            n_unique=int(ex["n_unique"]),
            n_keep=n_keep,
            had_n=int(ex["had_n"]),
        )
        exact_codes = join_code(ex["sel_hi"][:n_keep], ex["sel_lo"][:n_keep])
        exact_counts = ex["sel_count"][:n_keep].astype(np.uint64)
        return (exact_codes, exact_counts), approx, stats


class Engine:
    """Reusable device-side engine for one parameter set."""

    def __init__(self, prm: Params):
        self.prm = prm
        self.lc_sum_thr = np.int32(lc_sum_threshold(prm.adjusted_lc, prm.k))
        if prm.forbid_kmer:
            self.forbidden = parse_kmer_list(prm.forbid_kmer)
        else:
            self.forbidden = np.empty(0, np.uint64)
        self.fhi, self.flo = split_code(self.forbidden)
        # Switches for the fused sparse pass:
        #   transposed -- unpack straight to the [m, W] text-major layout
        #     (no [n, m] materialization, no device transpose);
        #   packed_out -- one concatenated uint32 output vector, one host
        #     fetch instead of one per output leaf.
        self.transposed = True
        self.packed_out = True
        self._fused_cache: dict[tuple, object] = {}
        self._tail_cache = None
        self._pool = None  # device window pool (build_pool)

    def _tail_dev(self):
        """The five pass-invariant arguments, device-resident once per
        Engine: passing them as host numpy values would re-ship each of
        them on every dispatch."""
        if self._tail_cache is None:
            prm = self.prm
            self._tail_cache = tuple(
                jax.device_put(x) for x in (
                    self.lc_sum_thr, self.fhi, self.flo,
                    np.int32(min(prm.limit, np.iinfo(np.int32).max)),
                    np.int32(prm.solid_km),
                )
            )
        return self._tail_cache

    def candidates_from_codes(self, codes: np.ndarray):
        return candidates_from_codes(codes)

    def build_pool(self, reads, sl: int,
                   ends: tuple = ("start", "end")) -> bool:
        """Device-resident window pool (multi-pass transfer cut).

        Ships the cut windows (start sl-base prefix; end sl+1-base
        suffix -- the reference off-by-one) of every eligible read
        (len >= 2*sl) ONCE in the packed 2-bit format, unpacks and
        transposes them on device into resident [m, E] pool planes.
        Every subsequent pass then ships only its chosen-read index
        vector (4 B/row, ~160 KB at sn=40000 vs the 1.06 MB plane) and
        gathers its batch on device (``fmt='pool'`` executable).  Rows
        past n_valid gather pool row 0 and are masked invalid, so
        outputs are byte-identical to the host-gather path.

        ``ends`` lists the planes the pass plan can actually reach --
        a skip_end or quirk (end-samples-start) run never reads the end
        plane, so the driver omits it from the build and the cost model.

        Returns False (pool disabled) when no read is eligible.
        Ref workload: the -mr N / both-ends loop, approx_counter.cpp:
        835-955."""
        from approx_counter_tpu.core.codec import BASE_PAD
        from approx_counter_tpu.sample.sampler import gather_rows

        lengths = reads.lengths
        elig = np.nonzero(lengths >= 2 * sl)[0]
        E = len(elig)
        if E == 0:
            self._pool = None
            return False
        width = sl + 1
        inv = np.full(len(reads), -1, np.int64)
        inv[elig] = np.arange(E)
        pools = {}
        for which in ends:
            end = which == "end"
            wins = np.full((max(E, 8), width), BASE_PAD, np.uint8)
            offs = reads.offsets
            starts = offs[elig + 1] - 1 - sl if end else offs[elig]
            gather_rows(reads.buf, starts, width if end else sl, wins)
            dev = self.device_windows(wins, n_valid=E)  # packed H2D, once
            pools[which] = jax.numpy.transpose(dev, (1, 0))
        self._pool = dict(pools=pools, inv=inv, m=width, E=E)
        return True

    def start_pass_pool(self, chosen: np.ndarray, n_valid: int,
                        end: bool, prefetch: bool = False):
        """Dispatch one fused pass that gathers its windows from the
        device pool -- the per-pass H2D is ONE small index vector
        (uint16 when the pool has < 2^16 rows, int32 otherwise).  Same
        ``_PendingPass`` contract as ``start_pass``."""
        pool = self._pool
        cap = max(512, _round_up(min(self.prm.limit, 1 << 20), CT))
        w_pad = max(_round_up(max(int(n_valid), 1), WT), WT)
        if pool["E"] < (1 << 16):
            # n_valid (which may exceed 2^16-1) rides two u16 tail slots
            idx_ext = np.zeros(w_pad + 2, np.uint16)
            idx_ext[:n_valid] = pool["inv"][chosen]
            idx_ext[-2] = n_valid & 0xFFFF
            idx_ext[-1] = n_valid >> 16
        else:
            idx_ext = np.zeros(w_pad + 1, np.int32)
            idx_ext[:n_valid] = pool["inv"][chosen]
            idx_ext[-1] = n_valid
        if prefetch:
            idx_ext = jax.device_put(idx_ext)
        pool_t = pool["pools"]["end" if end else "start"]
        tail = self._tail_dev()
        po = self.packed_out
        m = pool["m"]

        def redispatch(cap):
            return self._fused_fn(cap, m, "pool", packed_out=po)(
                pool_t, idx_ext, *tail
            )

        return _PendingPass(self, redispatch, cap)

    def device_windows(self, windows, n_valid: int | None = None):
        """Ship a host window batch to the device 2-bit-packed (sparse-N
        format when ``n_valid`` is known and the batch has <= 4096 Ns:
        0.25 B/base; dense two-plane format otherwise: 0.375 B/base,
        against 1 B/base raw) and unpack on device.  Device arrays pass
        through untouched."""
        if not isinstance(windows, np.ndarray):
            return windows
        if n_valid is not None:
            sp = pack_windows_sparse(windows, int(n_valid))
            if sp is not None:
                lo, n_idx, ncols, m = sp
                return _unpack_windows_sparse(
                    lo, n_idx, np.int32(n_valid), np.int32(ncols), m=m
                )
        planes, m = pack_windows_host(windows)
        return _unpack_windows(planes, m=m)

    def count_one_end(self, windows, n_valid: int):
        """Full device pipeline for one sampled batch.

        Returns (exact_sel, approx_sel) as (codes, counts) numpy pairs in
        CompareCount order, plus stats.

        Both selection modes run as one jitted call and one batched
        fetch.  Solid mode's data-dependent candidate count rides the same
        cap-regrowth loop as top-N's limit>2^20 corner: when n_keep
        exceeds the cap, ``finish`` re-traces at the true size."""
        return self.start_pass(windows, n_valid).finish()

    def _fused_fn(self, cap: int, m: int, fmt: str = "dense",
                  transposed: bool | None = None,
                  packed_out: bool | None = None):
        """One jitted device program for a full top-N pass: packed-window
        unpack + exact count + selection + BPM scoring + CompareCount
        re-rank (single dispatch, single fetch, packed H2D).

        ``fmt``: 'sparse' ships the 2-bit plane + N scatter list
        (0.25 B/base, the production path); 'dense' ships the two-plane
        format (0.375 B/base, the fallback for > ncap Ns and the
        ``_fused_step`` compatibility path); 'raw' takes an already
        device-resident uint8 [n, m] batch (no transfer, no unpack --
        the library-embedding path); 'pool' gathers the batch on device
        from a resident transposed [m, E] window pool using a shipped
        index vector (~KB per pass -- the multi-pass path, see
        ``build_pool``).

        ``transposed`` (sparse fmt only): unpack straight into the [m, W]
        text-major layout both the BPM kernel and the transposed exact
        stage consume -- no [n, m] materialization, no device
        transpose.  ``packed_out``: flatten the whole output dict into
        one uint32 vector so the host fetch is a single round trip.
        Defaults come from the Engine's production switches.

        Cached per config in an instance dict (a method-level lru_cache
        would pin ``self`` forever -- a leak for library embeddings that
        create many Engines)."""
        if transposed is None:
            transposed = self.transposed and fmt == "sparse"
        if packed_out is None:
            packed_out = self.packed_out
        transposed = transposed and fmt == "sparse"
        use_solid = self.prm.solid_km > 0
        key = (cap, m, fmt, transposed, packed_out, use_solid)
        if key in self._fused_cache:
            return self._fused_cache[key]
        prm = self.prm
        from approx_counter_tpu.count.approx import (
            approx_count_rank,
            rank_with_zero_counts,
        )

        def body(windows, n_valid, lc_thr, fhi, flo, limit, solid_km):
            ex = exact_count_select(
                windows, n_valid, prm.k, lc_thr, fhi, flo, limit, solid_km,
                cap=cap, n_forbidden=len(self.forbidden),
                use_solid=use_solid,
            )
            a_hi, a_lo, a_cnt, a_val = approx_count_rank(
                windows, n_valid, ex["sel_hi"], ex["sel_lo"],
                ex["sel_valid"], prm.k, maxerr=prm.max_error,
                impl=prm.bpm_impl,
            )
            return dict(
                exact=ex, approx_hi=a_hi, approx_lo=a_lo,
                approx_count=a_cnt, approx_valid=a_val,
            )

        def body_t(windows_t, n_valid, lc_thr, fhi, flo, limit, solid_km):
            """Transposed-layout body: one [m, W] batch feeds both stages."""
            import jax.numpy as jnp

            from approx_counter_tpu.count.exact import (
                exact_count_select_rows,
            )
            from approx_counter_tpu.kernels.bpm import (
                approx_counts,
                build_peq,
            )

            W = windows_t.shape[1]
            row_mask = jax.lax.broadcasted_iota(
                jnp.int32, (W,), 0) < n_valid
            ex = exact_count_select_rows(
                windows_t, row_mask, prm.k, lc_thr, fhi, flo, limit,
                solid_km, cap=cap, n_forbidden=len(self.forbidden),
                use_solid=use_solid, transposed=True,
            )
            peq = build_peq(ex["sel_hi"], ex["sel_lo"], prm.k)
            counts = approx_counts(
                peq, windows_t, row_mask, prm.k, maxerr=prm.max_error,
                impl=prm.bpm_impl,
            )
            a_hi, a_lo, a_cnt, a_val = rank_with_zero_counts(
                ex["sel_hi"], ex["sel_lo"], counts, ex["sel_valid"], prm.k
            )
            return dict(
                exact=ex, approx_hi=a_hi, approx_lo=a_lo,
                approx_count=a_cnt, approx_valid=a_val,
            )

        def finish_out(out):
            return _pack_pass_output(out, cap, prm.k) if packed_out else out

        if fmt == "sparse" and transposed:

            @jax.jit
            def step(lo_planes, n_idx_ext, lc_thr, fhi, flo,
                     limit, solid_km):
                # per-pass scalars ride the tail of the n_idx buffer so a
                # pass ships exactly two device transfers (the plane + the
                # scatter list)
                n_idx = n_idx_ext[:-2]
                n_valid = n_idx_ext[-2]
                ncols = n_idx_ext[-1]
                windows_t = unpack_windows_sparse_t_jnp(
                    lo_planes, n_idx, n_valid, ncols, m
                )
                return finish_out(body_t(windows_t, n_valid, lc_thr, fhi,
                                         flo, limit, solid_km))

        elif fmt == "sparse":

            @jax.jit
            def step(lo_planes, n_idx_ext, lc_thr, fhi, flo,
                     limit, solid_km):
                n_idx = n_idx_ext[:-2]
                n_valid = n_idx_ext[-2]
                ncols = n_idx_ext[-1]
                windows = unpack_windows_sparse_jnp(
                    lo_planes, n_idx, n_valid, ncols, m
                )
                return finish_out(body(windows, n_valid, lc_thr, fhi, flo,
                                       limit, solid_km))

        elif fmt == "pool":
            import jax.numpy as jnp

            @jax.jit
            def step(pool_t, idx_ext, lc_thr, fhi, flo, limit, solid_km):
                # idx_ext = [Wpad chosen pool rows | n_valid]; rows past
                # n_valid point at pool row 0 and are masked invalid by
                # body_t's iota row mask, so they change no counts.
                # uint16 variant (pools with E < 2^16 rows -- the common
                # case): n_valid rides TWO u16 tail slots (lo, hi).
                if idx_ext.dtype == jnp.uint16:
                    idx = idx_ext[:-2].astype(jnp.int32)
                    n_valid = (idx_ext[-2].astype(jnp.int32)
                               | (idx_ext[-1].astype(jnp.int32) << 16))
                else:
                    idx = idx_ext[:-1]
                    n_valid = idx_ext[-1]
                windows_t = jnp.take(pool_t, idx, axis=1)
                return finish_out(body_t(windows_t, n_valid, lc_thr, fhi,
                                         flo, limit, solid_km))

        elif fmt == "raw":

            @jax.jit
            def step(windows, n_valid, lc_thr, fhi, flo, limit, solid_km):
                return finish_out(body(windows, n_valid, lc_thr, fhi, flo,
                                       limit, solid_km))

        else:

            @jax.jit
            def step(planes, n_valid, lc_thr, fhi, flo, limit, solid_km):
                windows = unpack_windows_jnp(planes, m)
                return finish_out(body(windows, n_valid, lc_thr, fhi, flo,
                                       limit, solid_km))

        self._fused_cache[key] = step
        return step

    def _dispatch_fused(self, planes, m: int, n_valid, cap: int):
        """Async-dispatch one fused top-N pass on pre-packed planes."""
        return self._fused_fn(cap, m)(planes, n_valid, *self._tail_dev())

    def _fused_step(self, windows, n_valid, cap: int):
        """windows: host uint8 [n, m] batch -- packed on the host, shipped
        as 2-bit planes, one fused device dispatch for the whole pass."""
        planes, m = pack_windows_host(np.asarray(windows))
        return self._dispatch_fused(planes, m, n_valid, cap)

    def start_pass(self, windows, n_valid: int, prefetch: bool = False):
        """Pack + dispatch one fused top-N pass; returns a ``_PendingPass``
        (call ``.finish()`` for the results).

        Host batches ship in the sparse-N 2-bit format (0.25 B/base:
        2-bit plane + N scatter list + derivable pad) unless the batch
        carries more than 4096 Ns, in which case the dense two-plane
        format (0.375 B/base) is used.  Device-resident batches dispatch
        directly (no transfer).

        ``prefetch=True`` additionally ships the packed buffers with an
        explicit async ``device_put`` *before* dispatch, so a pass queued
        behind an in-flight one starts its H2D immediately instead of at
        execution time."""
        cap = max(512, _round_up(min(self.prm.limit, 1 << 20), CT))
        n_valid32 = np.int32(n_valid)
        tail = self._tail_dev()
        # snapshot the engine switches: a later cap-regrowth redispatch
        # must build the same executable format this pass decodes
        tr, po = self.transposed, self.packed_out
        if not isinstance(windows, np.ndarray):
            # already device-resident (library embedding): dispatch the
            # raw-batch executable -- np.asarray here would copy the batch
            # to the host only to repack and re-upload it
            m = windows.shape[1]

            def redispatch(cap):
                return self._fused_fn(cap, m, "raw", packed_out=po)(
                    windows, n_valid32, *tail
                )

            return _PendingPass(self, redispatch, cap)

        sparse = pack_windows_sparse(windows, int(n_valid))
        if sparse is not None:
            lo_planes, n_idx, ncols, m = sparse
            # fold the per-pass scalars into the scatter buffer: the pass
            # ships exactly two arrays (plane + list), nothing else
            n_idx_ext = np.empty(len(n_idx) + 2, np.int32)
            n_idx_ext[:-2] = n_idx
            n_idx_ext[-2] = n_valid
            n_idx_ext[-1] = ncols
            if prefetch:
                lo_planes = jax.device_put(lo_planes)
                n_idx_ext = jax.device_put(n_idx_ext)

            def redispatch(cap):
                return self._fused_fn(cap, m, "sparse", transposed=tr,
                                      packed_out=po)(
                    lo_planes, n_idx_ext, *tail
                )

        else:
            planes, m = pack_windows_host(windows)
            if prefetch:
                planes = jax.device_put(planes)

            def redispatch(cap):
                return self._fused_fn(cap, m, "dense", packed_out=po)(
                    planes, n_valid32, *tail
                )

        return _PendingPass(self, redispatch, cap)

    def _truncate_approx(self, a_hi, a_lo, a_cnt, a_val):
        """Truncate fetched approx arrays to limit (the final resize, :923)."""
        n_approx = min(int(a_val.sum()), self.prm.limit)
        return (
            join_code(a_hi[:n_approx], a_lo[:n_approx]),
            a_cnt[:n_approx].astype(np.uint64),
        )

    def _approx_dispatch(self, windows, n_valid, sel_hi, sel_lo, sel_valid,
                         cap):
        """Launch BPM scoring + CompareCount re-rank; returns device arrays
        (async -- no host sync)."""
        prm = self.prm
        return approx_count_rank(
            windows,
            np.int32(n_valid),
            sel_hi,
            sel_lo,
            sel_valid,
            prm.k,
            maxerr=prm.max_error,
            impl=prm.bpm_impl,
        )

    def _approx_finish(self, dev_approx):
        """Fetch + truncate to limit (the final resize, :923)."""
        a_hi, a_lo, a_cnt, a_val = jax.device_get(dev_approx)
        n_approx = min(int(a_val.sum()), self.prm.limit)
        approx_codes = join_code(a_hi[:n_approx], a_lo[:n_approx])
        approx_counts = a_cnt[:n_approx].astype(np.uint64)
        return approx_codes, approx_counts

    def approx_stage(self, windows, n_valid, sel_hi, sel_lo, sel_valid, cap):
        """BPM scoring + CompareCount re-rank -> (codes, counts) truncated
        to limit (resume-from-exact path)."""
        windows = self.device_windows(windows, n_valid)
        return self._approx_finish(
            self._approx_dispatch(windows, n_valid, sel_hi, sel_lo,
                                  sel_valid, cap)
        )


def run_pipeline(prm: Params, log: Log | None = None) -> int:
    """The full CLI driver.  Returns the process exit code."""
    log = log or Log()
    v = prm.v
    mr_v = prm.mr_v

    if prm.forbid_kmer:
        # (typo "fobidden" preserved from approx_counter.cpp:767)
        log("Parsing the fobidden kmer list")

    try:
        prm.validate()
        resolve_impl(prm.bpm_impl)
    except ValueError as e:
        sys.stderr.write(str(e) + "\n")
        return 1

    engine = Engine(prm)

    # Parameter echo (approx_counter.cpp:793-808).
    echo_params(prm, v)

    tab_level = 0
    if v > 0 and prm.nb_of_runs > 1:
        print(f"\nA total of {prm.nb_of_runs} runs will be performed.")

    reads = None
    if not prm.stream:
        if v > 0:
            log("Parsing FASTA file", tab_level)
        reads = read_fastx(prm.input_file)
        if v > 0:
            log(f"Number of sequences found: {len(reads)}.", tab_level)
    elif not os.path.exists(prm.input_file):
        raise FileNotFoundError(prm.input_file)

    resume_codes = None
    if prm.from_exact:
        from approx_counter_tpu.io.export import parse_exact_export

        resume_codes = parse_exact_export(prm.from_exact, prm.k)
        if v > 0:
            log(f"Resuming from {len(resume_codes)} exact-count candidates")

    rng = np.random.default_rng(prm.seed)
    sn = prm.sn

    # Pass pipelining: while one pass computes on device, the NEXT pass's
    # host work (sampling, 2-bit packing, async H2D) runs on the host and
    # its dispatch queues behind the in-flight pass.  The next pass is the
    # same run's end pass, or (multi-run) the next run's start pass.  Sampling order (start, end, start, ...) is unchanged, so
    # seeded outputs are byte-identical to the sequential path.
    can_pipeline = resume_codes is None
    runs_end_pass = (not prm.skip_end) or (
        prm.compat_quirks and mr_v == 0  # reference skip_end bug
    )
    # The faithful bug (approx_counter.cpp:943-953): when the muted break
    # fails to fire, `bottom = true` in the else of if(skip_end) ALSO never
    # executes -- the second pass samples the START again (fresh shuffle,
    # sl-base prefix windows) and its counts are exported under `.end`.
    quirk_end_is_start = prm.skip_end and runs_end_pass

    # Device window pool: for multi-pass runs, ship every eligible read's
    # two cut windows ONCE and gather each pass's batch on device from a
    # ~KB index vector instead of packing + shipping a ~1 MB plane per
    # pass.  Used when the pool's one-time bytes (2E rows) undercut the
    # per-pass planes (total_passes * padded sample rows); force with
    # --device-pool on/off.
    use_pool = False
    if (not prm.stream and resume_codes is None and reads is not None
            and prm.device_pool != "off"):
        total_passes = prm.nb_of_runs * (2 if runs_end_pass else 1)
        # the end plane is unreachable when the end pass never runs OR
        # the quirk makes it a start re-sample -- don't ship or price it
        need_end = runs_end_pass and not quirk_end_is_start
        ends_needed = ("start", "end") if need_end else ("start",)
        n_elig = int(np.count_nonzero(reads.lengths >= 2 * prm.sl))
        eff = min(sn, len(reads), n_elig)
        w_rows = max(_round_up(max(eff, 1), WT), WT)
        worth = (total_passes >= 2
                 and len(ends_needed) * n_elig < total_passes * w_rows)
        if n_elig > 0 and (prm.device_pool == "on" or worth):
            use_pool = engine.build_pool(reads, prm.sl, ends=ends_needed)

    def dispatch_pass(batch, end_flag: bool):
        if use_pool:
            return engine.start_pass_pool(
                batch.chosen, batch.n_valid, end=end_flag, prefetch=True
            )
        return engine.start_pass(batch.windows, batch.n_valid,
                                 prefetch=True)

    def next_pass_key(run: int, which_end: str):
        if which_end == "start" and runs_end_pass:
            return (run, "end")
        if run + 1 < prm.nb_of_runs and not prm.stream:
            # cross-run: next run's start (streaming re-reads the file at
            # the top of the run loop, so only in-memory mode prefetches)
            return (run + 1, "start")
        return None

    prefetched = None  # (key, batch, t_sample, pending, warn_msgs)

    for current_run in range(prm.nb_of_runs):
        run_suffix = f"_{current_run}"
        if prm.nb_of_runs > 1 and v > 0:
            print(f"Starting run number {current_run + 1}")

        stream_batches = None
        if prm.stream:
            if mr_v > 0:
                log("Streaming pass (reservoir sampling both ends)", tab_level)
            b_start, b_end, n_reads = stream_sample_windows(
                prm.input_file, sn, prm.sl, rng=rng, pad_to=WT,
                end_is_start=quirk_end_is_start, v=mr_v,
            )
            stream_batches = {"start": b_start, "end": b_end}
            if v > 0 and current_run == 0:
                log(f"Number of sequences found: {n_reads}.", tab_level)
        else:
            n_reads = len(reads)

        if sn > n_reads:  # clamp-by-mutation quirk (:844-848)
            warn("Sequence set too small for the requested sample size")
            warn("The whole set will be used.")
            sn = n_reads

        tab_level += 1
        for which_end in ("start", "end"):
            bottom = which_end == "end" and not quirk_end_is_start
            if v > 0:
                log(f"Working on sequence {which_end}.", tab_level - 1)
            if mr_v > 0:
                log("Sampling", tab_level)
            if mr_v > 0:
                log(
                    "Sampling the ends of reads"
                    if bottom
                    else "Sampling the start of reads",
                    tab_level,
                )
            pending = None
            from_prefetch = False
            if prefetched is not None and prefetched[0] == (current_run,
                                                           which_end):
                _, batch, t_sample, pending, warn_msgs = prefetched
                prefetched = None
                from_prefetch = True
                for msg in warn_msgs:  # deferred short-read warnings
                    warn(msg)          # (sampled early by the prefetcher)
            else:
                t_sample = time.perf_counter()
                if stream_batches is not None:
                    batch = stream_batches[which_end]
                else:
                    batch = sample_windows(
                        reads, sn, prm.sl, end=bottom, rng=rng, pad_to=WT,
                        v=mr_v, gather=not use_pool,
                    )
                t_sample = time.perf_counter() - t_sample
            if mr_v > 0:
                log(f"Sampled {batch.n_valid} sequences", tab_level)

            if mr_v > 0:
                log("Exact k-mer count", tab_level)
            t_count = time.perf_counter()
            if resume_codes is not None:
                sel_hi, sel_lo, sel_valid, cap = engine.candidates_from_codes(
                    resume_codes
                )
                approx = engine.approx_stage(
                    batch.windows, batch.n_valid, sel_hi, sel_lo, sel_valid,
                    cap,
                )
                exact_codes = resume_codes
                exact_counts = np.zeros(len(resume_codes), np.uint64)
                approx_codes, approx_counts = approx
                stats = dict(n_unique=len(resume_codes),
                             n_keep=len(resume_codes), had_n=0)
            else:
                if pending is None and can_pipeline:
                    # prefetch=True: async-put the buffers even for the
                    # first pass, so the H2D starts before dispatch
                    pending = dispatch_pass(batch, bottom)
                nxt = next_pass_key(current_run, which_end)
                if pending is not None and nxt is not None:
                    # a pass is in flight: overlap the next pass's
                    # sample + pack + H2D + dispatch with it
                    t_s2 = time.perf_counter()
                    warn_msgs2: list = []
                    end2 = nxt[1] == "end" and not quirk_end_is_start
                    if stream_batches is not None and nxt[0] == current_run:
                        batch2 = stream_batches[nxt[1]]
                    else:
                        batch2 = sample_windows(
                            reads, sn, prm.sl, end=end2,
                            rng=rng, pad_to=WT, v=mr_v,
                            warn_sink=warn_msgs2, gather=not use_pool,
                        )
                    t_s2 = time.perf_counter() - t_s2
                    prefetched = (
                        nxt,
                        batch2,
                        t_s2,
                        dispatch_pass(batch2, end2),
                        warn_msgs2,
                    )
                if pending is not None:
                    (
                        (exact_codes, exact_counts),
                        (approx_codes, approx_counts),
                        stats,
                    ) = pending.finish()
                else:
                    (
                        (exact_codes, exact_counts),
                        (approx_codes, approx_counts),
                        stats,
                    ) = engine.count_one_end(batch.windows, batch.n_valid)
            t_count = time.perf_counter() - t_count
            if mr_v >= 2:
                n_cand = stats["n_keep"]
                pairs = n_cand * batch.n_valid
                pipelined = " (pipelined)" if from_prefetch else ""
                log(
                    f"[stats] sample {t_sample * 1e3:.1f} ms | "
                    f"count+score {t_count * 1e3:.1f} ms{pipelined} | "
                    f"{batch.n_valid / max(t_count, 1e-9):.0f} windows/s | "
                    f"{pairs / max(t_count, 1e-9):.3g} pairs/s",
                    tab_level,
                )
            if not report_and_export_end(
                prm, log, mr_v, tab_level, run_suffix, which_end, stats,
                (exact_codes, exact_counts), (approx_codes, approx_counts),
                resume=resume_codes is not None,
            ):
                return 1

            if prm.skip_end:
                # runs_end_pass is the single source of truth for whether
                # the end pass executes (the prefetcher's next_pass_key
                # keys off the same flag -- they must never diverge, or a
                # prefetched pass would be orphaned and its sample_windows
                # call would silently shift the seeded rng stream).
                # Reference bug (compat_quirks): the break sits inside
                # if(mr_v>0), so muted runs process the end anyway.
                if mr_v > 0:
                    log("Skipping end adapter ressearch")
                if not runs_end_pass:
                    break
        tab_level -= 1
    return 0
