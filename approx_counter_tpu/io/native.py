"""ctypes binding to the native C++ FASTA/FASTQ parser.

Loads ``native/libfastx.so`` (built by ``make -C native`` / repo Makefile).
Raises ImportError when the library isn't built so callers fall back to the
pure-Python parser transparently (io/fastx.py ``read_fastx``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from approx_counter_tpu.io.fastx import Reads

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    path = os.path.join(root, "native", "libfastx.so")
    if not os.path.exists(path):
        raise ImportError(f"native parser not built: {path}")
    lib = ctypes.CDLL(path)
    lib.fastx_parse.restype = ctypes.c_void_p
    lib.fastx_parse.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)
    ]
    lib.fastx_n_reads.restype = ctypes.c_int64
    lib.fastx_n_reads.argtypes = [ctypes.c_void_p]
    lib.fastx_total_bases.restype = ctypes.c_int64
    lib.fastx_total_bases.argtypes = [ctypes.c_void_p]
    lib.fastx_buf.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fastx_buf.argtypes = [ctypes.c_void_p]
    lib.fastx_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.fastx_offsets.argtypes = [ctypes.c_void_p]
    lib.fastx_free.argtypes = [ctypes.c_void_p]
    lib.fastx_parse_chunk.restype = ctypes.c_void_p
    lib.fastx_parse_chunk.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.fastx_gather_windows.restype = None
    lib.fastx_gather_windows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.fastx_pack_windows_sparse.restype = ctypes.c_int64
    lib.fastx_pack_windows_sparse.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    _LIB = lib
    return lib


def pack_windows_sparse_native(
    windows: np.ndarray, n_valid: int, ncols: int, ncap: int
):
    """Native fused 2-bit pack + N scan (see core/codec.py
    pack_windows_sparse for the format).  Returns (lo, n_idx) on success,
    None when the batch needs the dense fallback (> ncap Ns or a non-N
    symbol >= 4 inside the valid region); raises ImportError when the
    library isn't built (caller falls back to the numpy SWAR pack)."""
    lib = _load()
    assert windows.flags.c_contiguous and windows.dtype == np.uint8
    n, m = windows.shape
    if n * m >= 2**31:  # scatter indices are int32
        return None
    mp = -(-m // 8) * 8
    lo = np.empty((n, mp // 4), np.uint8)
    n_idx = np.full(ncap, np.iinfo(np.int32).max, np.int32)
    rc = lib.fastx_pack_windows_sparse(
        windows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, m, n_valid, ncols,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ncap,
    )
    if rc < 0:
        return None
    return lo, n_idx


def gather_windows_native(
    buf: np.ndarray, starts: np.ndarray, ncols: int, out: np.ndarray
) -> None:
    """Row i of ``out[:, :ncols]`` <- ``buf[starts[i] : starts[i]+ncols]``.

    Native memcpy-per-row replacement for numpy fancy-indexing (which
    can be much slower on some virtualized hosts).  ``out`` must be C-
    contiguous uint8; ``buf`` contiguous uint8; raises ImportError when the
    library isn't built (callers fall back to numpy).
    """
    lib = _load()
    assert out.flags.c_contiguous and out.dtype == np.uint8
    assert buf.flags.c_contiguous and buf.dtype == np.uint8
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = len(starts)
    if n == 0:
        return
    lib.fastx_gather_windows(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.strides[0],
    )


def read_fastx_native(path: str) -> Reads:
    lib = _load()
    err = ctypes.c_char_p()
    h = lib.fastx_parse(path.encode(), ctypes.byref(err))
    if not h:
        msg = err.value.decode() if err.value else "parse failed"
        if "could not open" in msg:
            raise FileNotFoundError(path)
        from approx_counter_tpu.io.fastx import InputFormatError

        raise InputFormatError(msg)
    n = lib.fastx_n_reads(h)
    total = lib.fastx_total_bases(h)
    if total == 0:
        lib.fastx_free(h)
        return Reads(
            buf=np.empty(0, np.uint8),
            offsets=np.zeros(n + 1, np.int64),
        )
    # Zero-copy wrap of the C++ base buffer: a second pass over a multi-GB
    # file just to memcpy it is measurable on this (throttled) host.  The
    # ctypes array borrows the handle's memory and becomes the numpy base;
    # the finalizer frees the handle only once the last view dies.
    import weakref

    cbuf = (ctypes.c_uint8 * total).from_address(
        ctypes.addressof(lib.fastx_buf(h).contents)
    )
    weakref.finalize(cbuf, lib.fastx_free, h)
    buf = np.frombuffer(cbuf, dtype=np.uint8)
    # offsets are 8*(n+1) bytes -- a copy is cheap and decouples lifetime
    offsets = np.frombuffer(
        bytearray(ctypes.string_at(lib.fastx_offsets(h), 8 * (n + 1))),
        dtype=np.int64,
    )
    return Reads(buf=buf, offsets=offsets)


def parse_chunk_native(
    data: bytes, is_final: bool
) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse the complete records in ``data`` -> (buf, offsets, consumed).

    ``buf`` holds the records' bases as ordinals, ``offsets`` is
    [n_records + 1] boundaries into it, ``consumed`` is how many input
    bytes were used (a trailing partial record is left for the caller to
    carry into the next chunk).  With ``is_final`` the tail is resolved
    with the streaming iterators' EOF semantics (io/stream.py)."""
    lib = _load()
    err = ctypes.c_char_p()
    consumed = ctypes.c_int64()
    h = lib.fastx_parse_chunk(
        data, len(data), 1 if is_final else 0,
        ctypes.byref(consumed), ctypes.byref(err),
    )
    if not h:
        from approx_counter_tpu.io.fastx import InputFormatError

        raise InputFormatError(
            err.value.decode() if err.value else "parse failed"
        )
    try:
        n = lib.fastx_n_reads(h)
        total = lib.fastx_total_bases(h)
        buf = np.frombuffer(
            bytearray(ctypes.string_at(lib.fastx_buf(h), total)),
            dtype=np.uint8,
        )
        offsets = np.frombuffer(
            bytearray(ctypes.string_at(lib.fastx_offsets(h), 8 * (n + 1))),
            dtype=np.int64,
        )
    finally:
        lib.fastx_free(h)
    return buf, offsets, int(consumed.value)
