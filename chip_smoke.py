"""Smoke test of the counting pipeline on a GPU, in one process.

    python chip_smoke.py [--seed N]      # one card
    python chip_smoke.py --four          # the 4-card mesh path only

Phases (any failure exits nonzero and prints no result line):

1. Device check: JAX's first device must be a GPU; prints ``nvidia-smi``'s
   card name and power limit.
2. The approximate-count kernel, compiled for the card at real widths
   (512 candidates x 40 960 windows x 101 bases), against the plain scan
   ``approx_counts_jnp`` on the card over k x maxerr -- exact equality --
   and both against ``oracle.py`` on a small slice.  Prints the kernel and
   scan times and the fused pass's ``memory_analysis()``.
3. The CLI at the reference defaults and at ``-mr 2`` on a seeded
   nanopore-like FASTQ (~190 MB, 60 000 reads): exports byte-identical to
   the same runs with ``--bpm-impl jnp``, adapter 16-mers ranked first.

``--four`` runs only the multihost driver on a 4-card mesh and the
production-shaped multi-device dry run, each compared byte for byte with
its 1-card result.

The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from bench import card_name_and_power_limit, median_time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

#: Phase 2's real widths: the reference's 500 candidates x 40 000 windows,
#: padded as the pipeline pads them, with 101-base windows (sl = 100).
C_REAL, W_REAL, M_REAL = 512, 40960, 101
KERNEL_KS = (2, 8, 16, 17, 31, 32)
KERNEL_MAXERRS = (0, 1, 2, 3)
TIMED = ((16, 2), (32, 3))
DEFAULTS = ["-sn", "40000", "-sl", "100", "-k", "16", "-lim", "500",
            "-lc", "1.0"]


def say(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """Phase 1: the first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform}")
    return dev


def build_native() -> bool:
    """Rebuild the native parser from source (never reuse a binary), and
    report whether the pipeline will use it."""
    lib = os.path.join(REPO, "native", "libfastx.so")
    if os.path.exists(lib):
        os.remove(lib)
    r = subprocess.run(["make", "-C", REPO, "native/libfastx.so"],
                       capture_output=True, text=True)
    if r.returncode:
        say(f"native parser build failed: {r.stderr.strip()[-500:]}")
    try:
        from approx_counter_tpu.io.native import _load

        _load()
        return True
    except (ImportError, OSError):
        return False


# ---------------------------------------------------------------------------
# Phase 2: the kernel against the plain scan and the oracle
# ---------------------------------------------------------------------------


def kernel_inputs(k: int, C: int, W: int, m: int, seed: int):
    """Candidates, windows and validity for one kernel check: random
    windows with N (4) and pad (5) symbols, copies of the candidates
    planted at random offsets with one substitution in every other copy,
    and the last 37 windows masked invalid."""
    from approx_counter_tpu.core.codec import split_code

    rng = np.random.default_rng(seed * 1000 + k)
    codes = rng.integers(0, 1 << (2 * k), C, dtype=np.uint64)
    pats = [[(int(c) >> (2 * (k - 1 - i))) & 3 for i in range(k)]
            for c in codes]
    wins = rng.integers(0, 6, (W, m)).astype(np.uint8)
    for w in range(0, W, 3):
        pos = int(rng.integers(0, m - k + 1))
        pat = np.array(pats[w % C], np.uint8)
        if w % 2:
            pat[int(rng.integers(0, k))] ^= 1
        wins[w, pos:pos + k] = pat
    valid = np.ones(W, bool)
    valid[-37:] = False
    hi, lo = split_code(codes)
    return codes, hi, lo, wins, valid


def check_kernel(k: int, maxerr: int, C: int = C_REAL, W: int = W_REAL,
                 m: int = M_REAL, seed: int = 0) -> None:
    """Kernel == plain scan on the card, exactly; raises otherwise."""
    import jax.numpy as jnp

    from approx_counter_tpu.kernels.bpm import (
        approx_counts_jnp,
        approx_counts_kernel,
        build_peq,
    )

    _, hi, lo, wins, valid = kernel_inputs(k, C, W, m, seed)
    peq = build_peq(hi, lo, k)
    wt = jnp.asarray(wins.T.copy())
    vd = jnp.asarray(valid)
    want = np.asarray(approx_counts_jnp(peq, wt, vd, k, maxerr=maxerr))
    got = np.asarray(approx_counts_kernel(peq, wt, vd, k, maxerr=maxerr))
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0]
        raise SystemExit(
            f"kernel != scan at k={k} maxerr={maxerr}: {len(bad)} of {C} "
            f"candidates differ, first {bad[:5].tolist()} "
            f"(kernel {got[bad[:5]].tolist()}, scan {want[bad[:5]].tolist()})"
        )
    if not want.any():
        raise SystemExit(f"k={k} maxerr={maxerr}: every count is zero")


def check_oracle_slice(k: int, maxerr: int, seed: int = 0) -> None:
    """Kernel and scan on the card == oracle.py on a small slice."""
    import jax.numpy as jnp

    from approx_counter_tpu.kernels.bpm import (
        approx_counts_jnp,
        approx_counts_kernel,
        build_peq,
    )
    from approx_counter_tpu.oracle import oracle_error_count

    C, W = 6, 24
    codes, hi, lo, wins, valid = kernel_inputs(k, C, W, M_REAL, seed)
    valid[:] = True
    peq = build_peq(hi, lo, k)
    wt = jnp.asarray(wins.T.copy())
    vd = jnp.asarray(valid)
    counter = oracle_error_count(list(wins), [int(c) for c in codes], k,
                                 maxerr=maxerr)
    want = np.array([counter[int(c)] for c in codes])
    for name, fn in (("scan", approx_counts_jnp),
                     ("kernel", approx_counts_kernel)):
        got = np.asarray(fn(peq, wt, vd, k, maxerr=maxerr))
        if not np.array_equal(got, want):
            raise SystemExit(f"{name} != oracle at k={k} maxerr={maxerr}: "
                             f"{got.tolist()} vs {want.tolist()}")


def time_kernel(k: int, maxerr: int, label: str) -> tuple[float, float]:
    """(kernel ms, scan ms), medians of 7 after a warm-up call."""
    import jax.numpy as jnp

    from approx_counter_tpu.kernels.bpm import (
        approx_counts_jnp,
        approx_counts_kernel,
        build_peq,
    )

    _, hi, lo, wins, valid = kernel_inputs(k, C_REAL, W_REAL, M_REAL, 1)
    peq = build_peq(hi, lo, k)
    wt = jnp.asarray(wins.T.copy())
    vd = jnp.asarray(valid)
    t_kernel = 1e3 * median_time(
        lambda: approx_counts_kernel(peq, wt, vd, k, maxerr=maxerr), 7)
    t_scan = 1e3 * median_time(
        lambda: approx_counts_jnp(peq, wt, vd, k, maxerr=maxerr), 7)
    say(f"[{label}] approx count C={C_REAL} W={W_REAL} m={M_REAL} k={k} "
        f"maxerr={maxerr}: kernel {t_kernel:.3f} ms, scan {t_scan:.3f} ms "
        f"(median of 7)")
    return t_kernel, t_scan


def fused_pass_memory() -> str:
    """``memory_analysis()`` of the fused default pass's executable."""
    from approx_counter_tpu.core.codec import pack_windows_sparse
    from approx_counter_tpu.params import Params
    from approx_counter_tpu.pipeline import Engine

    eng = Engine(Params(input_file="smoke", sn=W_REAL, sl=M_REAL - 1))
    wins = np.random.default_rng(2).integers(0, 4, (W_REAL, M_REAL))
    lo, n_idx, ncols, m = pack_windows_sparse(wins.astype(np.uint8),
                                              W_REAL - 5)
    n_idx_ext = np.concatenate([n_idx, [W_REAL - 5, ncols]]).astype(np.int32)
    step = eng._fused_fn(512, m, "sparse")
    return str(step.lower(lo, n_idx_ext, *eng._tail_dev())
               .compile().memory_analysis())


def phase_kernel(label: str) -> None:
    t0 = time.perf_counter()
    for k in KERNEL_KS:
        for maxerr in KERNEL_MAXERRS:
            check_kernel(k, maxerr)
        say(f"kernel == scan at k={k}, maxerr {list(KERNEL_MAXERRS)}")
    for k, maxerr in ((8, 2), (17, 3), (32, 0)):
        check_oracle_slice(k, maxerr)
    say(f"kernel == scan == oracle on slices; phase 2 checks took "
        f"{time.perf_counter() - t0:.1f} s")
    for k, maxerr in TIMED:
        time_kernel(k, maxerr, label)
    say(f"fused pass memory: {fused_pass_memory()}")


# ---------------------------------------------------------------------------
# Phase 3: the CLI end to end
# ---------------------------------------------------------------------------


def make_reads(seed: int) -> str:
    from approx_counter_tpu.synth import write_nanopore_fastq

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"reads_{seed}.fastq")
    t0 = time.perf_counter()
    n = write_nanopore_fastq(path, seed)
    say(f"input: {path}, {n / 1e6:.1f} MB, generated in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    return path


def run_cli(args: list[str], label: str, tag: str) -> dict:
    """One CLI run in this process; returns its wall time, per-pass
    ``-v 2`` stats and exported files' bytes."""
    from approx_counter_tpu.__main__ import main

    out = os.path.join(WORK, tag)
    argv = [*args, "-o", out + ".approx", "-e", out + ".exact", "-v", "2"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"CLI run {tag} exited {rc}:\n{buf.getvalue()}")
    passes = [float(x) for x in
              re.findall(r"count\+score ([0-9.]+) ms", buf.getvalue())]
    say(f"[{label}] CLI {tag}: wall {wall:.3f} s, count+score per pass "
        f"{passes} ms")
    return dict(wall=wall, passes=passes, files=exports(tag))


def exports(tag: str) -> dict:
    """The bytes of every file a run tagged ``tag`` wrote, by suffix."""
    files = {}
    for name in sorted(os.listdir(WORK)):
        if name.startswith(tag + "."):
            with open(os.path.join(WORK, name), "rb") as f:
                files[name[len(tag):]] = f.read()
    return files


def same_exports(a: dict, b: dict, what: str) -> None:
    if not a["files"] or a["files"].keys() != b["files"].keys():
        raise SystemExit(f"{what}: export sets differ: "
                         f"{sorted(a['files'])} vs {sorted(b['files'])}")
    for name in a["files"]:
        if a["files"][name] != b["files"][name]:
            raise SystemExit(f"{what}: {name} differs")
    say(f"{what}: {len(a['files'])} exports byte-identical")


def adapters_first(run: dict, k: int = 16) -> None:
    """The top approximate k-mer of each end is an adapter k-mer."""
    from approx_counter_tpu.synth import ADAPTER_END, ADAPTER_START

    for end, adapter in (("start", ADAPTER_START), ("end", ADAPTER_END)):
        top = run["files"][f".approx_0.{end}"].split(b"\n", 1)[0]
        kmer = top.split(b"\t")[0].decode()
        if len(kmer) != k or kmer not in adapter:
            raise SystemExit(f"top {end} k-mer {top!r} is not from the "
                             f"{end} adapter {adapter}")
        say(f"top {end} k-mer: {top.decode()}")


def phase_cli(seed: int, label: str) -> None:
    fq = make_reads(seed)
    base = [fq, *DEFAULTS, "--seed", str(seed)]
    runs = {}
    for tag in ("kernel", "jnp", "jnp_warm", "kernel_warm"):
        impl = ["--bpm-impl", tag.split("_")[0]]
        runs[tag] = run_cli(base + impl, label, tag)
    same_exports(runs["kernel"], runs["jnp"], "defaults, kernel vs jnp")
    same_exports(runs["kernel_warm"], runs["jnp_warm"],
                 "defaults (warm), kernel vs jnp")
    adapters_first(runs["kernel"])
    mr_k = run_cli(base + ["-mr", "2", "--bpm-impl", "kernel"], label,
                   "mr2_kernel")
    mr_j = run_cli(base + ["-mr", "2", "--bpm-impl", "jnp"], label,
                   "mr2_jnp")
    same_exports(mr_k, mr_j, "-mr 2 (device pool), kernel vs jnp")
    if len(mr_k["files"]) != 8:
        raise SystemExit(f"-mr 2 wrote {sorted(mr_k['files'])}")


# ---------------------------------------------------------------------------
# --four: the mesh path across 4 cards
# ---------------------------------------------------------------------------


def phase_four(seed: int, label: str) -> None:
    import jax

    import __graft_entry__
    from approx_counter_tpu.config.cli import resolve_params
    from approx_counter_tpu.dist.multihost import run_pipeline_multihost

    if len(jax.devices()) != 4:
        raise SystemExit(f"--four needs 4 cards, found {len(jax.devices())}")
    fq = make_reads(seed)
    results = {}
    for tag, devices in (("mh4", jax.devices()), ("mh1", jax.devices()[:1])):
        out = os.path.join(WORK, tag)
        prm = resolve_params([fq, *DEFAULTS, "--seed", str(seed),
                              "--multihost", "-o", out + ".approx",
                              "-e", out + ".exact", "-v", "0"])
        t0 = time.perf_counter()
        if run_pipeline_multihost(prm, devices=devices) != 0:
            raise SystemExit(f"multihost run {tag} failed")
        wall = time.perf_counter() - t0
        say(f"[{label}] multihost {tag} ({len(devices)} cards): wall "
            f"{wall:.3f} s")
        results[tag] = dict(files=exports(tag))
    same_exports(results["mh4"], results["mh1"],
                 "--multihost, 4-card mesh vs 1 card")
    __graft_entry__.dryrun_multichip(4, production=True)
    say("dryrun_multichip(4, production=True): 4-card mesh == 1 card")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh path and its 1-card "
                         "comparison")
    args = ap.parse_args(argv)

    dev = require_gpu()
    import jax

    from approx_counter_tpu.compile_cache import enable_compile_cache

    smi = card_name_and_power_limit()
    say(smi)
    label = smi.splitlines()[0]
    say(f"jax: {jax.__version__}, {dev.device_kind} x{len(jax.devices())}, "
        f"compile cache {enable_compile_cache()}")
    say(f"native parser in use: {build_native()}")
    t0 = time.perf_counter()
    if args.four:
        phase_four(args.seed, label)
    else:
        phase_kernel(label)
        phase_cli(args.seed, label)
    say(f"[{label}] smoke phases took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
