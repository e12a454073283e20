"""Benchmark harness (driver contract: print ONE JSON line).

North-star metric (BASELINE.json): read-windows x candidate-k-mers scored
per second per card at k=16, ed<=2 -- i.e. the backend's approximate-count
implementation (kernels/bpm.py) on the default workload shape (512
candidates x 40960 windows x 101-base windows; the reference's defaults are
500 candidates x 40000 windows, approx_counter.cpp:708-710, padded to tile
multiples).

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is an optimized CPU stand-in for its hot loop -- the same Myers
BPM in C++ with OpenMP (native/cpu_baseline.cpp), compiled -O3
-march=native at bench time and measured on this host, scaled to the
reference's default 4 threads.  This is *favorable* to the reference: a
dense BPM sweep is typically faster per pair than SeqAn's FM-index
search-scheme enumeration it actually performs.

All diagnostics go to stderr; stdout carries exactly one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

C, W, M, K = 512, 40960, 101, 16
ITERS = 20  # timed calls per measurement (median)
REF_THREADS = 4  # reference default, approx_counter.cpp:706


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one per line."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def median_time(run, iters: int) -> float:
    """Median seconds per ``run()`` call over ``iters`` timed calls, each
    ended by ``block_until_ready``, after one warm-up (compile) call."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    log(f"first call (compile): {time.perf_counter() - t0:.2f}s")
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_gpu() -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from approx_counter_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from approx_counter_tpu.kernels.bpm import approx_counts, build_peq

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"bench.py measures the GPU; backend is {backend}")
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"nvidia-smi: {card_name_and_power_limit()}")

    rng = np.random.default_rng(12345)
    codes = rng.integers(0, 1 << (2 * K), C, dtype=np.uint64)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    peq = jax.device_put(build_peq(hi, lo, K))
    win = jax.device_put(
        jnp.asarray(rng.integers(0, 4, (W, M)).astype(np.uint8).T)
    )
    wv = jax.device_put(jnp.ones(W, bool))

    dt = median_time(lambda: approx_counts(peq, win, wv, K), ITERS)
    pairs_per_s = C * W / dt
    log(
        f"kernel: {dt * 1e3:.3f} ms/iter, {pairs_per_s / 1e9:.2f} Gpairs/s, "
        f"{C * W * M / dt / 1e12:.3f} Tcell/s"
    )

    # Secondary diagnostic (stderr only): one full counting pass -- exact
    # count + selection + BPM + re-rank as the pipeline's fused jit step.
    try:
        from approx_counter_tpu.params import Params
        from approx_counter_tpu.pipeline import Engine

        eng = Engine(Params(input_file="bench", sn=W, sl=M - 1, k=K))
        wbuf = rng.integers(0, 4, (W, M)).astype(np.uint8)
        dt = median_time(lambda: eng.start_pass(wbuf, W - 5).finish()[1][1],
                         5)
        log(f"full pass (sparse-N 2-bit H2D, fused exact+BPM+rank, "
            f"fetch): {dt * 1e3:.2f} ms")
        from approx_counter_tpu.io.fastx import Reads

        n_reads, read_len = 50000, 2 * M
        pbuf = rng.integers(0, 4, n_reads * read_len).astype(np.uint8)
        poffs = np.arange(n_reads + 1, dtype=np.int64) * read_len
        eng.build_pool(Reads(buf=pbuf, offsets=poffs), M - 1)
        chosen = rng.permutation(n_reads)[:W]
        dt = median_time(
            lambda: eng.start_pass_pool(chosen, W, end=False).finish()[1][1],
            5,
        )
        log(f"device-pool pass: {dt * 1e3:.2f} ms")
    except Exception as e:  # noqa: BLE001
        log(f"full-pass diagnostic unavailable: {e}")
    return pairs_per_s


def bench_cpu_baseline() -> float | None:
    """Compile + run the C++ OpenMP BPM baseline; returns pairs/s at the
    reference's 4 threads (scaled from this host's core count if lower)."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "native", "cpu_baseline.cpp")
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    exe = os.path.join(here, "build", "cpu_baseline")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-std=c++14",
             "-o", exe, src],
            check=True, capture_output=True, timeout=120,
        )
        ncpu = os.cpu_count() or 1
        threads = min(REF_THREADS, ncpu)
        # subsample W to keep the CPU run short; pairs/s is size-independent
        sub_w = 4096
        # best-of-2: a throttled or shared host gives a slow denominator,
        # which silently inflates vs_baseline
        per_s, info = 0.0, ""
        for _ in range(2):
            r = subprocess.run(
                [exe, str(C), str(sub_w), str(M), str(K), str(threads)],
                check=True, capture_output=True, timeout=600, text=True,
            )
            if float(r.stdout.strip()) > per_s:
                per_s, info = float(r.stdout.strip()), r.stderr.strip()
        log(f"cpu baseline ({threads} thr, best of 2): "
            f"{per_s / 1e6:.2f} Mpairs/s [{info}]")
        if threads < REF_THREADS:
            per_s *= REF_THREADS / threads  # optimistic linear scaling
            log(f"scaled to {REF_THREADS} thr: {per_s / 1e6:.2f} Mpairs/s")
        return per_s
    except Exception as e:  # noqa: BLE001
        log(f"cpu baseline unavailable: {e}")
        return None


def main() -> None:
    dev = bench_gpu()
    base = bench_cpu_baseline()
    vs = dev / base if base else None
    print(
        json.dumps(
            {
                "metric": "window-candidate pairs scored/sec/chip "
                          "(k=16, ed<=2, m=101)",
                "value": round(dev, 1),
                "unit": "pairs/s",
                "vs_baseline": round(vs, 1) if vs else None,
            }
        )
    )


if __name__ == "__main__":
    main()
