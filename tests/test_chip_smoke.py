"""The on-card smoke script's CPU-side contract, its input generator, and
the compile-cache helper every entry point shares."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from approx_counter_tpu import compile_cache
from approx_counter_tpu.synth import ADAPTER_END, ADAPTER_START, nanopore_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_smoke_fails_alone(tmp_path):
    """Copied away from the repo, the script exits nonzero with no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_reads_deterministic_per_seed():
    a = nanopore_fastq(3, n_reads=40)
    assert a == nanopore_fastq(3, n_reads=40)
    assert a != nanopore_fastq(4, n_reads=40)


def test_reads_shape(tmp_path):
    """Parsable FASTQ; every read at least min_len plus adapters long; N
    runs in a share of the reads; an adapter 16-mer near most read ends."""
    from approx_counter_tpu.io.fastx import read_fastx_py

    n = 300
    path = tmp_path / "r.fastq"
    path.write_bytes(nanopore_fastq(5, n_reads=n, n_read_share=0.2))
    reads = read_fastx_py(str(path))
    assert len(reads) == n
    lengths = np.diff(reads.offsets)
    assert lengths.min() >= 250 + 40
    assert 0.1 < np.mean(
        [(reads.buf[a:b] == 4).any()
         for a, b in zip(reads.offsets[:-1], reads.offsets[1:])]) < 0.3
    text = path.read_bytes().split(b"\n")[1::4]
    heads = sum(ADAPTER_START[4:20].encode() in r[:45] for r in text)
    tails = sum(ADAPTER_END[4:20].encode() in r[-40:] for r in text)
    assert heads > n // 3 and tails > n // 3


def test_read_lengths_heavy_tailed():
    from approx_counter_tpu.synth import nanopore_fastq as gen

    recs = gen(9, n_reads=2000).split(b"\n")[1::4]
    lengths = np.array([len(r) for r in recs])
    assert lengths.max() > 4 * np.median(lengths)


def test_kernel_inputs():
    """Phase 2's inputs: deterministic, with N and pad symbols, planted
    copies and masked windows."""
    a = chip_smoke.kernel_inputs(16, 64, 300, 101, 0)
    b = chip_smoke.kernel_inputs(16, 64, 300, 101, 0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    codes, hi, lo, wins, valid = a
    assert wins.shape == (300, 101) and wins.max() == 5
    assert (wins == 4).any() and not valid[-1] and valid[0]


def _run(files):
    return {"files": files}


def test_same_exports():
    chip_smoke.same_exports(_run({".a": b"x"}), _run({".a": b"x"}), "t")
    with pytest.raises(SystemExit):
        chip_smoke.same_exports(_run({".a": b"x"}), _run({".a": b"y"}), "t")
    with pytest.raises(SystemExit):
        chip_smoke.same_exports(_run({".a": b"x"}), _run({".b": b"x"}), "t")


def test_adapters_first():
    good = {".approx_0.start": f"{ADAPTER_START[3:19]}\t9\n".encode(),
            ".approx_0.end": f"{ADAPTER_END[:16]}\t9\n".encode()}
    chip_smoke.adapters_first(_run(good))
    bad = dict(good, **{".approx_0.end": b"ACGTACGTACGTACGT\t9\n"})
    with pytest.raises(SystemExit):
        chip_smoke.adapters_first(_run(bad))


def test_cache_dir_from_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as is, nothing set in code."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_dir_default_in_checkout(monkeypatch):
    """Unset: one fixed path inside the checkout."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert os.path.isdir(path)
