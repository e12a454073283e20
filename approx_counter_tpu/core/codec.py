"""2-bit DNA codec.

Reproduces the packing semantics of the reference's ``dna2int`` / ``int2dna``
(/root/reference/approx_counter.cpp:55-78): bases are packed **first base in
the high bits** -- ``value = value << 2 | ord(c)`` with A=0, C=1, G=2, T=3
(the SeqAn Dna5 ordinal order, N=4).

k-mer codes are up to 64 bits (k <= 32).  On the host they are plain Python
ints / ``np.uint64``; on device they are carried as a ``(hi, lo)`` pair of
``uint32`` arrays (hi = bits 32..63) because TPU has no native 64-bit integer
path -- all device-side comparisons and sort keys operate on the pair.
"""

from __future__ import annotations

import numpy as np

# Base ordinals (SeqAn Dna5 order, approx_counter.cpp:22 "ACGT" + N).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
#: Padding symbol used for rows/columns beyond real data.  Distinct from N so
#: that padding never triggers the reference's had-N warning accounting
#: (approx_counter.cpp:513-517) and never matches any needle base.
BASE_PAD = 5

_DNA = "ACGT"

# char -> ordinal lookup (everything unknown -> N, matching SeqAn's Dna5
# conversion of arbitrary chars to 'N'; lowercase maps like uppercase).
_CHAR_TO_CODE = np.full(256, BASE_N, dtype=np.uint8)
for _i, _c in enumerate(_DNA):
    _CHAR_TO_CODE[ord(_c)] = _i
    _CHAR_TO_CODE[ord(_c.lower())] = _i

_CODE_TO_CHAR = np.frombuffer(b"ACGTN?", dtype=np.uint8)


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII DNA -> uint8 ordinal array (A=0..T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CHAR_TO_CODE[raw]


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 ordinal array -> ASCII DNA string (4 -> 'N')."""
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def is_dna(seq: str | bytes | np.ndarray) -> bool:
    """True iff the sequence is pure ACGT (case-insensitive).

    Mirrors ``is_DNA`` (approx_counter.cpp:313-321): any symbol with
    ordinal >= 4 (N or other IUPAC) fails.
    """
    codes = seq if isinstance(seq, np.ndarray) else seq_to_codes(seq)
    return bool(np.all(codes < BASE_N))


def encode_kmer(seq: str | bytes | np.ndarray) -> int:
    """Pack a pure-ACGT k-mer into an int, first base in the high bits.

    Mirrors ``dna2int`` (approx_counter.cpp:55-62).  The caller must guard
    with a DNA-validity check, as the reference does: an N injects ordinal 4
    and corrupts the code.
    """
    codes = seq if isinstance(seq, np.ndarray) else seq_to_codes(seq)
    value = 0
    for c in codes:
        value = (value << 2) | int(c)
    return value


def decode_kmer(value: int, k: int) -> str:
    """Unpack an int code back to a k-length DNA string.

    Mirrors ``int2dna`` (approx_counter.cpp:70-78): consume low 2 bits per
    base, prepending.
    """
    out = []
    for _ in range(k):
        out.append(_DNA[value & 3])
        value >>= 2
    return "".join(reversed(out))


def decode_kmers(values: np.ndarray, k: int) -> list[str]:
    """Vectorized ``int2dna`` over an array of uint64 codes."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    if n == 0:
        return []
    chars = np.empty((n, k), dtype=np.uint8)
    v = values.copy()
    for i in range(k - 1, -1, -1):
        chars[:, i] = _CODE_TO_CHAR[(v & np.uint64(3)).astype(np.uint8)]
        v >>= np.uint64(2)
    return [row.tobytes().decode("ascii") for row in chars]


def split_code(value: int | np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 code -> (hi, lo) uint32 pair for device-side use."""
    v = np.asarray(value, dtype=np.uint64)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join_code(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 pair -> uint64 code (host side)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )


# ---------------------------------------------------------------------------
# Packed window transfer: the sampled batch is 3-bit symbols (0..3 bases,
# 4 N, 5 pad) shipped host->device one byte per base -- ~4 MB per default
# pass.  Two packed formats:
#
#   * sparse-N (production, 0.25 B/base): the 2-bit plane alone + a
#     fixed-size N-position scatter list; pad is *derived* on device from
#     (ncols, n_valid) iota masks via the sampler contract (every valid
#     row holds exactly ncols real symbols, rows >= n_valid are all pad).
#     Falls back to dense when the batch has > ncap Ns or violates the
#     contract.  Host side rides a fused C++ single pass when the native
#     lib is built (io/native.py pack_windows_sparse_native).
#   * dense two-plane (fallback, 0.375 B/base): 2-bit base plane
#     (4 bases/byte) + high-bit plane (8 bases/byte); represents ANY
#     symbol batch exactly: sym == (sym & 3) | ((sym >> 2) << 2)
#     restores 4 -> 0|4, 5 -> 1|4.
#
# The device unpack is a handful of shift/ands (+ one small scatter for
# sparse) that XLA fuses into the consuming pass; every downstream
# consumer sees the same uint8 [n, m] batch.
# ---------------------------------------------------------------------------


def _padded_words(windows: np.ndarray):
    """[n, m] uint8 -> contiguous uint32 view of the mp-padded batch
    (mp = ceil(m/8)*8; pad value BASE_PAD), 4 bases per little-endian
    word.  Shared by both pack formats so their 2-bit planes can never
    diverge."""
    n, m = windows.shape
    mp = -(-m // 8) * 8
    w = windows
    if mp != m or not w.flags.c_contiguous:
        w = np.full((n, mp), BASE_PAD, np.uint8)
        w[:, :m] = windows
    return w.reshape(-1).view(np.uint32), mp


def _lo_plane_swar(x: np.ndarray, n: int, mp: int) -> np.ndarray:
    """uint32 word view -> [n, mp/4] 2-bit plane (base j of each 4-group
    at bit 2*(j%4)): SWAR bit-gather of the four 2-bit fields of each
    word into one byte (a strided-slice formulation measured ~24 ms on
    this throttle-prone host; this runs in a few ms)."""
    t = x & np.uint32(0x03030303)
    t = t | (t >> np.uint32(6))
    t = (t | (t >> np.uint32(12))) & np.uint32(0xFF)
    return t.astype(np.uint8).reshape(n, mp // 4)


def pack_windows_host(windows: np.ndarray):
    """uint8 [n, m] ordinal batch -> (planes [n, ceil(m/8)*3], m): one
    contiguous uint8 buffer holding the 2-bit plane (first 2*mp/8 columns)
    then the high-bit plane (byte j%8 at bit j) -- a single array so the
    transfer is one H2D op."""
    n, m = windows.shape
    x, mp = _padded_words(windows)
    planes = np.empty((n, (mp // 8) * 3), np.uint8)
    planes[:, : mp // 4] = _lo_plane_swar(x, n, mp)
    # high-bit plane: nibble per word via bit-gather multiply
    u = (x >> np.uint32(2)) & np.uint32(0x01010101)
    nib = ((u * np.uint32(0x01020408)) >> np.uint32(24)) & np.uint32(0xF)
    nib = nib.reshape(n, mp // 4)
    planes[:, mp // 4 :] = (nib[:, 0::2] | (nib[:, 1::2] << np.uint32(4))
                            ).astype(np.uint8)
    return planes, m


def pack_windows_sparse(windows: np.ndarray, n_valid: int,
                        ncols: int | None = None, ncap: int = 4096):
    """Sparse-N variant of :func:`pack_windows_host`: ship ONLY the 2-bit
    plane (0.25 bytes/base) plus a fixed-size list of N positions.

    The high-bit plane of the dense format distinguishes N(4)/pad(5) from
    bases, but pad is fully derivable from scalars: the sampler contract
    (sample/sampler.py) guarantees every valid row carries exactly
    ``ncols`` real symbols (start windows: width-1 with one trailing pad
    column; end windows: full width) and rows >= n_valid are all pad.
    Only N positions are real data, and basecalled reads contain few or
    none -- so they travel as a scatter list of flattened row*m+col
    indices (padded with INT32_MAX -- always out of bounds, so the
    device's mode='drop' scatter ignores it; -1 would WRAP to the last
    element under JAX indexing).

    Returns (lo_planes uint8 [n, mp/4], n_idx int32 [ncap], ncols, m), or
    **None** when the batch has more than ``ncap`` Ns (caller falls back
    to the dense format).  ``ncols=None`` auto-detects start vs end
    batches from the trailing column of the valid rows.
    """
    n, m = windows.shape
    if n * m >= 2**31:
        return None  # scatter indices are int32; dense format has no limit
    if ncols is None:
        ncols = m
        if n_valid > 0 and (windows[:n_valid, m - 1] == BASE_PAD).all():
            ncols = m - 1

    if windows.flags.c_contiguous:
        try:  # native fused pack + N scan (one streaming pass instead
            #   of the numpy SWAR pack's several)
            from approx_counter_tpu.io.native import (
                pack_windows_sparse_native,
            )

            res = pack_windows_sparse_native(windows, int(n_valid),
                                             int(ncols), ncap)
            if res is None:
                return None
            return res[0], res[1], ncols, m
        except ImportError:
            pass

    valid = windows[:n_valid, :ncols]
    n_idx = np.full(ncap, np.iinfo(np.int32).max, np.int32)
    # fast path: np.max is a cheap single scan; batches are usually N-free
    if valid.size and int(valid.max()) >= BASE_N:
        rows, cols = np.nonzero(valid >= BASE_N)
        if len(rows) > ncap:
            return None
        if (valid[rows, cols] != BASE_N).any():
            # pad (or junk) INSIDE the valid region: the batch violates
            # the sampler contract this format relies on -- the scatter
            # would rewrite it as N.  Dense format preserves it exactly.
            return None
        n_idx[: len(rows)] = rows.astype(np.int64) * m + cols

    x, mp = _padded_words(windows)
    lo = _lo_plane_swar(x, n, mp)
    return lo, n_idx, ncols, m


def unpack_windows_sparse_jnp(lo_planes, n_idx, n_valid, ncols, m: int):
    """Device-side inverse of :func:`pack_windows_sparse` -> uint8 [n, m].

    Reconstructs pad from (ncols, n_valid) iota masks and scatters BASE_N
    at the listed positions (mode='drop' ignores the out-of-bounds
    INT32_MAX padding).  ncols
    and n_valid are traced scalars, so one executable serves both start
    and end batches.  Plain jnp -- callers jit it (alone or fused)."""
    import jax.numpy as jnp

    n = lo_planes.shape[0]
    l32 = lo_planes.astype(jnp.uint32)
    b = jnp.stack(
        [(l32 >> jnp.uint32(2 * j)) & jnp.uint32(3) for j in range(4)],
        axis=2,
    ).reshape(n, -1)[:, :m]
    col = jnp.arange(m, dtype=jnp.int32)[None, :]
    row = jnp.arange(n, dtype=jnp.int32)[:, None]
    sym = jnp.where(
        (col < ncols) & (row < n_valid), b, jnp.uint32(BASE_PAD)
    )
    sym = (
        sym.reshape(-1)
        .at[n_idx]
        .set(jnp.uint32(BASE_N), mode="drop")
        .reshape(n, m)
    )
    return sym.astype(jnp.uint8)


def unpack_windows_sparse_t_jnp(lo_planes, n_idx, n_valid, ncols, m: int):
    """Transposed-layout inverse of :func:`pack_windows_sparse` -> uint8
    [m, n] (the layout the BPM kernel and the transposed exact stage
    consume), so the fused pass never materializes the [n, m] batch or
    pays a full 4 MB device transpose -- only the packed planes (1 MB)
    transpose.  Flat N indices r*m + c translate to c*n + r."""
    import jax.numpy as jnp

    n = lo_planes.shape[0]
    l32 = jnp.transpose(lo_planes, (1, 0)).astype(jnp.uint32)  # [mp/4, n]
    b = jnp.stack(
        [(l32 >> jnp.uint32(2 * j)) & jnp.uint32(3) for j in range(4)],
        axis=1,
    ).reshape(-1, n)[:m]  # [m, n]
    row = jnp.arange(m, dtype=jnp.int32)[:, None]   # text position axis
    col = jnp.arange(n, dtype=jnp.int32)[None, :]   # window axis
    sym = jnp.where(
        (row < ncols) & (col < n_valid), b, jnp.uint32(BASE_PAD)
    )
    # transposed flat index; the INT32_MAX pad stays out of bounds: for it
    # (f % m) * n + f // m < m*n + 2^31/m -- still >= n*m? No: compute and
    # re-sentinel explicitly so mode='drop' keeps ignoring pad entries.
    tgt = (n_idx % jnp.int32(m)) * jnp.int32(n) + n_idx // jnp.int32(m)
    tgt = jnp.where(n_idx == jnp.int32(np.iinfo(np.int32).max),
                    jnp.int32(np.iinfo(np.int32).max), tgt)
    sym = (
        sym.reshape(-1)
        .at[tgt]
        .set(jnp.uint32(BASE_N), mode="drop")
        .reshape(m, n)
    )
    return sym.astype(jnp.uint8)


def unpack_windows_jnp(planes, m: int):
    """Device-side inverse of :func:`pack_windows_host` -> uint8 [n, m].
    Plain jnp (callers jit it, alone or fused into a larger step)."""
    import jax.numpy as jnp

    n = planes.shape[0]
    mp8 = planes.shape[1] // 3
    lob = planes[:, : 2 * mp8]
    hib = planes[:, 2 * mp8 :]
    l32 = lob.astype(jnp.uint32)
    b = jnp.stack(
        [(l32 >> jnp.uint32(2 * j)) & jnp.uint32(3) for j in range(4)],
        axis=2,
    ).reshape(n, -1)
    h32 = hib.astype(jnp.uint32)
    hi = jnp.stack(
        [(h32 >> jnp.uint32(j)) & jnp.uint32(1) for j in range(8)],
        axis=2,
    ).reshape(n, -1)
    return (b | (hi << jnp.uint32(2))).astype(jnp.uint8)[:, :m]
