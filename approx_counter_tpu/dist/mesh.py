"""Data-parallel distribution over a device mesh.

This component has no counterpart in the reference -- its only parallelism
is OpenMP threads inside ``errorCount``
(/root/reference/approx_counter.cpp:547-599) with an ``omp critical``
reduction.  The design here (SURVEY.md §2 parallelism audit):

  * sampled read **windows are sharded** along a 1-D ``data`` mesh axis;
  * **candidate k-mers are replicated** (the Peq table is a few KB);
  * each device scores its window shard with the approximate-count kernel
    and the per-candidate partial counts merge with a ``psum`` allreduce
    (NVLink between the cards of a host, the network across hosts via
    jax.distributed init);
  * the exact-count stage is a plain ``jit`` over globally-sharded window
    arrays: packing is embarrassingly parallel and the sort/RLE lowers to
    XLA's distributed sort, so no hand-written collective is needed.

Counting is order-independent and every per-window contribution is summed
exactly once, so results are invariant to mesh shape (asserted by
tests/test_dist.py, the determinism story replacing the reference's
thread-safety-by-construction).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def shard_windows(windows_t, window_valid, mesh: Mesh, axis: str = "data"):
    """Place a transposed window batch on the mesh in the layout the approx
    path consumes: ``windows_t`` is [m, W] with the *window* axis (last)
    sharded, ``window_valid`` is [W] sharded the same way.  Window counts
    are pre-padded to a multiple of the device count by the sampler's
    ``pad_to``."""
    ws = jax.device_put(windows_t, NamedSharding(mesh, P(None, axis)))
    vs = jax.device_put(window_valid, NamedSharding(mesh, P(axis)))
    return ws, vs


@functools.lru_cache(maxsize=None)
def _sharded_counts_fn(mesh: Mesh, axis: str, k: int, maxerr: int,
                       impl: str | None, counts_fn):
    """Build + jit the shard_map fan-out once per config (a bare
    shard_map call re-traces on every invocation)."""
    from approx_counter_tpu.kernels.bpm import approx_counts

    if counts_fn is None:
        counts_fn = functools.partial(approx_counts, impl=impl)

    def shard_fn(peq_rep, wt_shard, wv_shard):
        counts = counts_fn(peq_rep, wt_shard, wv_shard, k, maxerr=maxerr)
        return jax.lax.psum(counts, axis)

    return jax.jit(jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(None, axis), P(axis)),
        out_specs=P(),
        # constant-initialized scan carries trip the varying-manual-axes
        # typecheck; correctness of the reduction is carried by the psum
        check_vma=False,
    ))


def approx_counts_sharded(
    peq,            # [C, 4] uint32, replicated
    windows_t,      # [m, W] uint8; W sharded
    window_valid,   # [W] bool; sharded
    k: int,
    mesh: Mesh,
    axis: str = "data",
    maxerr: int = 2,
    impl: str | None = None,
    counts_fn=None,
):
    """shard_map fan-out of the approximate count + psum merge -> [C] int32.

    ``impl`` picks the per-shard implementation (kernels/bpm.py
    ``approx_counts``); ``counts_fn`` replaces it outright with a function
    of the same signature (tests run the kernel interpreted this way)."""
    fn = _sharded_counts_fn(mesh, axis, k, maxerr, impl, counts_fn)
    return fn(peq, windows_t, window_valid)


def make_approx_step(
    mesh: Mesh,
    k: int,
    axis: str = "data",
    maxerr: int = 2,
    impl: str | None = None,
):
    """Approx-only mesh step (the multihost ``--from-exact`` resume path):
    explicit candidate selection in, approximate counts + CompareCount
    re-rank out; no exact-count stage."""
    from approx_counter_tpu.count.approx import rank_with_zero_counts
    from approx_counter_tpu.kernels.bpm import build_peq

    @jax.jit
    def step(windows, window_valid, sel_hi, sel_lo, sel_valid):
        peq = build_peq(sel_hi, sel_lo, k)
        windows_t = jnp.transpose(windows, (1, 0))
        counts = approx_counts_sharded(
            peq, windows_t, window_valid, k, mesh=mesh, axis=axis,
            maxerr=maxerr, impl=impl,
        )
        a_hi, a_lo, a_cnt, a_val = rank_with_zero_counts(
            sel_hi, sel_lo, counts, sel_valid, k
        )
        return dict(approx_hi=a_hi, approx_lo=a_lo, approx_count=a_cnt,
                    approx_valid=a_val)

    return step


def make_full_step(
    mesh: Mesh,
    k: int,
    cap: int,
    axis: str = "data",
    n_forbidden: int = 0,
    use_solid: bool = False,
    maxerr: int = 2,
    impl: str | None = None,
):
    """Build the jitted full counting step over a mesh: window batch in,
    CompareCount-ranked exact + approximate counts out.

    Windows arrive sharded P(axis, None); the exact stage runs under XLA
    auto-SPMD; the approx stage fans out through shard_map + psum;
    selections/rankings are replicated.
    """
    from approx_counter_tpu.count.approx import rank_with_zero_counts
    from approx_counter_tpu.count.exact import exact_count_select_rows
    from approx_counter_tpu.kernels.bpm import build_peq

    @jax.jit
    def step(windows, window_valid, lc_sum_thr, fhi, flo, limit, solid_km):
        # window_valid: explicit [W] bool row mask -- multi-host layouts
        # interleave valid rows per host shard, so an iota < n_valid test
        # would be wrong there.
        out = exact_count_select_rows(
            windows, window_valid, k, lc_sum_thr, fhi, flo, limit, solid_km,
            cap=cap, n_forbidden=n_forbidden, use_solid=use_solid,
        )
        peq = build_peq(out["sel_hi"], out["sel_lo"], k)
        windows_t = jnp.transpose(windows, (1, 0))
        counts = approx_counts_sharded(
            peq, windows_t, window_valid, k, mesh=mesh, axis=axis,
            maxerr=maxerr, impl=impl,
        )
        a_hi, a_lo, a_cnt, a_val = rank_with_zero_counts(
            out["sel_hi"], out["sel_lo"], counts, out["sel_valid"], k
        )
        return dict(
            exact=out,
            approx_hi=a_hi,
            approx_lo=a_lo,
            approx_count=a_cnt,
            approx_valid=a_val,
        )

    return step
