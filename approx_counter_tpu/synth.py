"""Seeded nanopore-like FASTQ read sets for end-to-end runs and benchmarks.

Reads have heavy-tailed (log-normal) lengths, an adapter at each end with
substitution and indel errors, and runs of N in a share of the reads --
the shape of input adapter inference is run on.  The same seed gives the
same bytes.
"""

from __future__ import annotations

import numpy as np

#: Adapter ends modelled on Oxford Nanopore's ligation-kit adapters: the
#: start adapter leads a read, the end adapter trails it.
ADAPTER_START = "AATGTACTTCGTTCAGTTACGTATTGCT"
ADAPTER_END = "AGCAATACGTAACTGAACGAAGTACATT"

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _mutate(adapter: bytes, rng, p_sub: float, p_ins: float,
            p_del: float) -> bytes:
    """One sequenced copy of ``adapter`` with per-base errors."""
    out = bytearray()
    for b in adapter:
        r = rng.random()
        if r < p_del:
            continue
        if r < p_del + p_sub:
            b = int(_ACGT[(int(np.searchsorted(_ACGT, b)) + rng.integers(1, 4))
                          % 4])
        out.append(b)
        if rng.random() < p_ins:
            out.append(int(_ACGT[rng.integers(0, 4)]))
    return bytes(out)


def nanopore_fastq(seed: int, n_reads: int = 60000, median_len: int = 1100,
                   sigma: float = 0.8, min_len: int = 250,
                   max_len: int = 60000, n_read_share: float = 0.05,
                   p_sub: float = 0.03, p_ins: float = 0.01,
                   p_del: float = 0.01) -> bytes:
    """The FASTQ text of ``n_reads`` reads.

    Insert lengths are log-normal (``median_len``, ``sigma``), clipped to
    [``min_len``, ``max_len``].  Every read is ``[0-9 random bases]
    ADAPTER_START insert ADAPTER_END``, each adapter copy with independent
    errors; ``n_read_share`` of the reads carry one run of 1-40 Ns.
    """
    rng = np.random.default_rng(seed)
    lens = np.clip(
        rng.lognormal(np.log(median_len), sigma, n_reads).astype(np.int64),
        min_len, max_len,
    )
    lead = rng.integers(0, 10, n_reads)
    body = _ACGT[rng.integers(0, 4, int(lens.sum() + lead.sum()), np.uint8)]
    offs = np.concatenate([[0], np.cumsum(lens + lead)])
    n_reads_with_n = rng.random(n_reads) < n_read_share
    start, end = ADAPTER_START.encode(), ADAPTER_END.encode()
    records = []
    for i in range(n_reads):
        seq = body[offs[i]:offs[i + 1]]
        if n_reads_with_n[i]:
            seq = seq.copy()
            a = int(rng.integers(0, len(seq)))
            seq[a:a + int(rng.integers(1, 41))] = ord("N")
        head = seq[:lead[i]].tobytes()
        read = (head + _mutate(start, rng, p_sub, p_ins, p_del)
                + seq[lead[i]:].tobytes()
                + _mutate(end, rng, p_sub, p_ins, p_del))
        records.append(b"@read%d\n%s\n+\n%s\n"
                       % (i, read, b"5" * len(read)))
    return b"".join(records)


def write_nanopore_fastq(path: str, seed: int, **kwargs) -> int:
    """Write ``nanopore_fastq(seed, **kwargs)`` to ``path``; returns the
    byte count."""
    data = nanopore_fastq(seed, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
