"""Distributed uniform window sampling (bottom-k / priority sampling).

The reference samples a uniform ``sn``-subset of all *eligible* reads
(len >= 2*sl) via shuffle-then-walk (/root/reference/approx_counter.cpp:
415-476).  A multi-host split with fixed per-host quotas
(``sn // process_count``) is NOT that distribution when shards are
unbalanced: a read in a small shard has a strictly higher inclusion
probability, and a shard with fewer eligible reads than its quota silently
undersamples the global budget.

The uniform construction used here is classic bottom-k sampling:

  * every host tags each eligible read in its shard with an independent
    uniform 64-bit priority (per-host seeded RNG) and keeps its local
    bottom-``sn`` items (a max-heap; O(log sn) per replacement);
  * hosts exchange ONLY their sorted priority lists (<= sn uint64 each,
    padded) plus (n_reads, n_eligible) tallies -- one small allgather;
  * every host identically computes the global cutoff: the
    min(sn, N_eligible)-th smallest priority over the union, with ties
    broken by (host rank, local arrival order) -- deterministic even in
    the measure-zero equal-priority case;
  * each host keeps its items under the cutoff.  The global bottom-k of
    i.i.d. uniform keys over disjoint shards is a uniform k-subset of the
    union, for ANY shard sizes -- this is the whole point.

Start and end samples are two *independent* draws in the reference (two
separate shuffles), so two independent priority streams / bottom-k
structures are kept, exactly like io/stream.py's twin reservoirs.
"""

from __future__ import annotations

import heapq

import numpy as np

from approx_counter_tpu.core.codec import BASE_PAD
from approx_counter_tpu.io.stream import iter_read_seqs
from approx_counter_tpu.sample.sampler import WindowBatch, _round_up

_PRIO_PAD = np.uint64(0xFFFFFFFFFFFFFFFF)  # sorts after every real priority


class _BottomK:
    """Streaming bottom-``sn`` window sample keyed by uniform priorities."""

    def __init__(self, sn: int, sl: int, end: bool,
                 rng: np.random.Generator):
        self.sn = sn
        self.sl = sl
        self.end = end
        self.rng = rng
        self.ncols = sl + 1 if end else sl
        self.heap: list[tuple[int, int]] = []  # (-prio, arrival_idx)
        self.store: dict[int, np.ndarray] = {}  # arrival_idx -> window
        self.n_offered = 0

    def offer(self, seq: np.ndarray) -> None:
        prio = int(self.rng.integers(0, 1 << 64, dtype=np.uint64))
        idx = self.n_offered
        self.n_offered += 1
        if self.sn <= 0:
            return
        if len(self.heap) < self.sn:
            self.store[idx] = self._cut(seq)
            heapq.heappush(self.heap, (-prio, idx))
        elif -prio > self.heap[0][0]:  # prio < current local max
            _, evicted = heapq.heapreplace(self.heap, (-prio, idx))
            del self.store[evicted]
            self.store[idx] = self._cut(seq)

    def _cut(self, seq: np.ndarray) -> np.ndarray:
        # .copy(), NOT ascontiguousarray: a contiguous slice comes back as
        # a VIEW that pins the whole source read (on the native parser
        # path, the whole ~4 MB chunk buffer) -- sn views could retain
        # gigabytes where the contract is O(sn * sl) resident bytes.
        if self.end:
            # sl+1 bases: the reference off-by-one (:463)
            return seq[len(seq) - 1 - self.sl:].copy()
        return seq[: self.sl].copy()

    def items(self) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        """-> (priorities u64, arrival idx i64, windows), priority-sorted."""
        entries = sorted((-negp, idx) for negp, idx in self.heap)
        prio = np.array([p for p, _ in entries], dtype=np.uint64)
        idx = np.array([i for _, i in entries], dtype=np.int64)
        wins = [self.store[i] for _, i in entries]
        return prio, idx, wins


def _allgather_rows(local: np.ndarray) -> np.ndarray:
    """Allgather a fixed-shape per-host array -> [pc, *shape] on every
    host (jax.experimental.multihost_utils over the global device
    backend; hosts must call this collectively, same shapes)."""
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(local, tiled=False)
    )


def global_bottomk_mask(
    prio_local: np.ndarray,  # u64 [k_local], sorted ascending
    sn: int,
    process_count: int,
    process_index: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Compute which local items fall in the global bottom-``sn``.

    Returns (keep_mask bool [k_local], k_per_host int64 [pc]).  Every host
    computes the identical global answer from one allgathered [pc, sn]
    priority matrix (padded with u64 max).  Ties at the cutoff value are
    broken by (host rank, local sorted order) -- deterministic.
    """
    if process_count == 1:
        keep = np.ones(len(prio_local), bool)  # local bottom-k IS global
        return keep, np.array([len(prio_local)], dtype=np.int64)

    padded = np.full(sn, _PRIO_PAD, np.uint64)
    padded[: len(prio_local)] = prio_local
    gp = _allgather_rows(padded)  # [pc, sn]
    k_per_host = select_from_gathered(gp, sn)

    mine = np.zeros(len(prio_local), bool)
    mine[: int(k_per_host[process_index])] = True  # sorted ascending
    return mine, k_per_host


def select_from_gathered(gp: np.ndarray, sn: int) -> np.ndarray:
    """Pure global-cut computation: gathered priority matrix [pc, sn]
    (rows sorted ascending, padded with u64 max) -> per-host kept counts
    summing to min(sn, #real entries).  Deterministic, identical on every
    host (same input matrix everywhere)."""
    flat = gp.reshape(-1)
    real = flat[flat != _PRIO_PAD]
    total = len(real)
    if total <= sn:
        return (gp != _PRIO_PAD).sum(axis=1).astype(np.int64)

    cutoff = np.partition(real, sn - 1)[sn - 1]
    below = gp < cutoff            # strictly in
    at = gp == cutoff              # tie candidates
    n_below = int(below.sum())
    slots = sn - n_below           # >= 1 by choice of cutoff
    # distribute tie slots in (host, local order) order; rows are sorted,
    # so a host's ties are a contiguous run and lower ranks win first
    at_counts = at.sum(axis=1).astype(np.int64)
    tie_taken = np.minimum(np.maximum(slots - np.concatenate(
        [[0], np.cumsum(at_counts)[:-1]]), 0), at_counts)
    return below.sum(axis=1).astype(np.int64) + tie_taken


def distributed_sample_windows(
    paths: list[str],
    sn: int,
    sl: int,
    rng: np.random.Generator,
    process_count: int,
    process_index: int,
    row_mult: int = 8,
    chunk_size: int = 1 << 22,
    end_is_start: bool = False,
    v: int = 0,
):
    """One streaming pass over this host's shard -> globally-uniform
    start/end samples.  ``end_is_start``: the second sample draws START
    windows again (--compat-quirks skip_end bug: the reference's second
    pass runs with ``bottom == false``, approx_counter.cpp:943-953).
    ``v >= 2``: per-read short-read stderr warning
    (approx_counter.cpp:449-457), read id = this host's shard-stream
    ordinal (host 0 only in the multihost driver, COMPAT M3).

    Returns (start WindowBatch, end WindowBatch, n_reads_global,
    (g_start, g_end)) where both batches are padded to ``w_local`` rows
    (identical on every host: all hosts compute the same global
    selection, so the same max local count), ``n_valid`` is this host's
    share of the global sample, and ``g_start``/``g_end`` are the GLOBAL
    sample sizes min(sn, N_eligible) -- what the reference's "Sampled N
    sequences" log line reports.
    """
    bk_start = _BottomK(sn, sl, end=False, rng=rng)
    bk_end = _BottomK(sn, sl, end=not end_is_start, rng=rng)
    n_reads = 0
    for seq in iter_read_seqs(paths, chunk_size):
        n_reads += 1
        if len(seq) < 2 * sl:
            if v >= 2 and len(seq) < sl:
                from approx_counter_tpu.io.logging import (
                    short_read_warning,
                    warn,
                )

                warn(short_read_warning(n_reads - 1))
            continue  # eligibility, approx_counter.cpp:461
        bk_start.offer(seq)
        bk_end.offer(seq)

    width = sl + 1  # unified batch width (sample/sampler.py module doc)
    batches = []
    k_vectors = []
    for bk in (bk_start, bk_end):
        prio, _, wins = bk.items()
        keep, k_per_host = global_bottomk_mask(
            prio, sn, process_count, process_index
        )
        k_vectors.append(k_per_host)
        kept = [w for w, m in zip(wins, keep) if m]
        batches.append((kept, bk.ncols))

    # equal local row counts across hosts, stable across typical runs
    max_k = max(int(kv.max()) for kv in k_vectors) if k_vectors else 0
    w_local = max(_round_up(max_k, row_mult), row_mult)

    out = []
    for kept, ncols in batches:
        wb = np.full((w_local, width), BASE_PAD, np.uint8)
        for i, w in enumerate(kept):
            wb[i, :ncols] = w
        out.append(WindowBatch(windows=wb, n_valid=len(kept)))

    if process_count > 1:
        n_reads = int(
            _allgather_rows(np.array([n_reads], np.int64)).sum()
        )
    g_counts = tuple(int(kv.sum()) for kv in k_vectors)
    return out[0], out[1], n_reads, g_counts
