"""ctypes bindings for the native (C++) Criteo data engine.

Loads native/libdlrm_data.so, which is built from the committed source
(``make -C native``) at first use: the library is never committed.  Pure-
Python fallbacks in criteo.py keep everything working where no compiler is
available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libdlrm_data.so")

_lib = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_SO_PATH) and not _make():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.dlrm_parse_buffer.restype = ctypes.c_int64
        lib.dlrm_parse_buffer.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dlrm_marshal_batch.restype = None
        lib.dlrm_marshal_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.dlrm_vocab_build.restype = ctypes.c_void_p
        lib.dlrm_vocab_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        lib.dlrm_vocab_size.restype = ctypes.c_int64
        lib.dlrm_vocab_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.dlrm_vocab_export.restype = None
        lib.dlrm_vocab_export.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        lib.dlrm_vocab_reindex.restype = ctypes.c_int32
        lib.dlrm_vocab_reindex.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32]
        lib.dlrm_vocab_free.restype = None
        lib.dlrm_vocab_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, AttributeError):
        # AttributeError = a STALE .so missing a newer symbol — the
        # fallback contract (graceful Python degradation) must hold for
        # that case too, not just a failed dlopen
        _load_failed = True
    return _lib


def _make() -> bool:
    """Run ``make -C native`` under an exclusive file lock, so concurrent
    first uses (test workers, loader threads) build the library once."""
    import fcntl

    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except FileNotFoundError:  # no make / compiler in this image
            return False
        except subprocess.CalledProcessError as e:
            # surface the compiler's complaint — a bare False hides why
            import sys
            print("native build failed:\n"
                  f"{e.stderr.decode(errors='replace')}", file=sys.stderr)
            return False
    return True


def build() -> bool:
    """Compile the native library in place (idempotent)."""
    global _load_failed
    if not _make():
        return False
    _load_failed = False
    return _load() is not None


def available() -> bool:
    return _load() is not None


def parse_buffer(text: bytes, num_threads: int = 0) -> np.ndarray:
    """Parse raw Criteo text bytes into a DAC record array (C++ path)."""
    from dlrm_tpu.data.criteo import DAC_DTYPE

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    capacity = text.count(b"\n") + 2
    out = np.zeros(capacity, dtype=DAC_DTYPE)
    err_off = ctypes.c_int64(-1)
    n = lib.dlrm_parse_buffer(
        text, len(text), out.ctypes.data_as(ctypes.c_void_p), capacity,
        num_threads, ctypes.byref(err_off))
    if n < 0:
        if err_off.value >= 0:
            line_no = text.count(b"\n", 0, err_off.value) + 1
            snippet = text[err_off.value:err_off.value + 80]
            raise ValueError(
                f"native parser: malformed Criteo line {line_no} "
                f"(byte offset {err_off.value} of this chunk): "
                f"{snippet!r}")
        raise ValueError("native parser: malformed Criteo line")
    # slice VIEW, not copy: capacity exceeds n by <= 2 rows + blank
    # lines, while a copy would add a full extra pass over ~hundreds of
    # MB per chunk during Terabyte-day preprocessing
    return out[:n]


# NOTE: there is deliberately NO native-module binarize() here — the one
# binarize entry point is data/criteo.binarize, which streams the file
# through parse_buffer in bounded chunks (a Terabyte day is ~45 GB of
# text; a whole-file read would OOM).


def build_vocab_and_reindex(records: np.ndarray, *,
                            reindex: bool = True,
                            num_threads: int = 0):
    """One C++ pass: build the 26-column first-appearance vocabulary over
    ``records`` and (optionally) rewrite the categorical columns to dense
    1-based ids in place.  Returns the per-column appearance-order value
    arrays — semantically identical to the Python Vocabulary fold +
    reindex (data/criteo.py), ~40x faster.

    ``records`` must be a writable, contiguous DAC record array when
    ``reindex`` is on (memmap with mode='r+' works).
    """
    from dlrm_tpu.data.criteo import DAC_DTYPE

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not records.flags["C_CONTIGUOUS"]:
        raise ValueError("records must be C-contiguous")
    if records.dtype != DAC_DTYPE:
        # the C++ side reads AND writes len(records) x 160-byte DacRecords
        # — a wrong dtype would make it stride past the allocation
        raise ValueError(f"records must be DAC_DTYPE, got {records.dtype}")
    if reindex and not records.flags["WRITEABLE"]:
        # check BEFORE the build: discovering it after minutes of
        # Terabyte-scale vocabulary work wastes the whole pass
        raise ValueError("records must be writable to reindex in place")
    cpus = os.cpu_count() or 1
    build_threads = (num_threads if num_threads > 0 else min(cpus, 26))
    # the reindex pass is row-parallel and scales past 26 columns
    reindex_threads = num_threads if num_threads > 0 else cpus
    n = len(records)
    handle = lib.dlrm_vocab_build(
        records.ctypes.data_as(ctypes.c_void_p), n, build_threads)
    if not handle:
        # NULL from the C++ builder (allocation failure) — raise instead
        # of segfaulting inside the next library call
        raise RuntimeError("dlrm_vocab_build returned NULL")
    try:
        appear = []
        for j in range(26):
            size = lib.dlrm_vocab_size(handle, j)
            out = np.empty(size, np.uint32)
            lib.dlrm_vocab_export(handle, j,
                                  out.ctypes.data_as(ctypes.c_void_p))
            appear.append(out)
        if reindex:
            rc = lib.dlrm_vocab_reindex(
                handle, records.ctypes.data_as(ctypes.c_void_p), n,
                reindex_threads)
            if rc != 0:
                # only reachable when reindexing records the vocabulary
                # was NOT built over; the buffer is then partially
                # rewritten and must be discarded
                raise RuntimeError(
                    "reindex hit a value missing from the vocabulary; "
                    "the records buffer is partially rewritten — rebuild "
                    "it (build the vocabulary over the same records, or "
                    "use Vocabulary.remap_column for foreign data)")
    finally:
        lib.dlrm_vocab_free(handle)
    return appear


def marshal_batch(records: np.ndarray, start: int, count: int,
                  id_shift: int = 1):
    """C++ batch marshal: records[start:start+count] -> (labels, dense,
    sparse) with 0-based ids."""
    from dlrm_tpu.data.criteo import DAC_DTYPE

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if records.dtype != DAC_DTYPE:
        raise ValueError(f"records must be DAC_DTYPE, got {records.dtype}")
    if not records.flags["C_CONTIGUOUS"]:
        # a strided view's base pointer would make the C++ 160-byte
        # stride walk the wrong rows
        raise ValueError("records must be C-contiguous")
    if start < 0 or count < 0 or start + count > len(records):
        # the C++ loop trusts these bounds; out-of-range would silently
        # marshal stray heap memory into the batch
        raise ValueError(f"marshal_batch range [{start}, {start + count}) "
                         f"outside records[0, {len(records)})")
    labels = np.empty(count, np.float32)
    dense = np.empty((count, 13), np.float32)
    sparse = np.empty((count, 26), np.int32)
    lib.dlrm_marshal_batch(
        records.ctypes.data_as(ctypes.c_void_p), start, count,
        labels.ctypes.data_as(ctypes.c_void_p),
        dense.ctypes.data_as(ctypes.c_void_p),
        sparse.ctypes.data_as(ctypes.c_void_p), id_shift)
    return {"labels": labels, "dense": dense, "sparse": sparse}
