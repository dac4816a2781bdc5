"""Native (C++) runtime components, loaded via ctypes.

The reference's whole runtime is native C (SURVEY.md §0: ~100k LoC).
Here the device compute path is JAX/XLA; the file-driven host
runtime stays Python EXCEPT where a pure-Python loop measured as a real
bottleneck. Residents:

  - libhtkio (htkio.cpp): HTK feature-file codec — CRC16, _C
    decompression, batch corpus loader (~2x on compressed corpora) —
    and the MLF structure scanner (1.2x loads).
  - libhtknative (htknative.cpp): the ARPA n-gram codec
    (`HTKLib/HLM.c : ReadLModel` role) — the Python line loop measured
    13.7 s on a 44 MB / 2M-gram file; recipes ship LMs 10x that size.

Both libraries build lazily on first use with the system g++ (no
pybind11 — plain C ABI via ctypes, numpy buffers copied across); every
native entry point has a pure-Python twin and equality tests
(tests/test_native.py), so a toolchain-less box only loses speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libhtkio.so")
_SRC = os.path.join(_HERE, "htkio.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    for cc in ("g++", "c++", "clang++"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", _SO],
                capture_output=True, timeout=120,
            )
            if r.returncode == 0:
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def get_htkio() -> Optional[ctypes.CDLL]:
    """The libhtkio handle, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not os.path.exists(_SO) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
    ):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.htkio_crc16.restype = ctypes.c_uint16
    lib.htkio_crc16.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.htkio_load.restype = ctypes.c_int64
    lib.htkio_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.htkio_load_batch.restype = ctypes.c_int64
    lib.htkio_load_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.htkio_mlf_marks.restype = ctypes.c_int64
    lib.htkio_mlf_marks.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def load_corpus_batch(paths, max_frames: int, width: int):
    """Load many HTK feature files in one native call.

    Returns (arena (N, max_frames, width) f32, frames (N,) i64,
    periods (N,) i32, kinds (N,) i32) or None when native is unavailable.
    Files that fail to load report negative frame counts.

    Measured on this box: ~2x faster than the numpy reader for _C
    compressed corpora (the scalar dequantise dominates there); for
    uncompressed float32 files numpy's SIMD byteswap already wins, so
    callers should route through here only for compressed data.
    """
    import numpy as np

    lib = get_htkio()
    if lib is None:
        return None
    n = len(paths)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.empty((n, max_frames, width), np.float32)
    periods = np.zeros(n, np.int32)
    kinds = np.zeros(n, np.int32)
    frames = np.zeros(n, np.int64)
    lib.htkio_load_batch(
        blob, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_frames, width,
        periods.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out, frames, periods, kinds


# ---------------------------------------------------------------------------
# ARPA n-gram codec (htknative.cpp)

_ARPA_SRC = os.path.join(_HERE, "htknative.cpp")
_CACHE = os.path.join(_HERE, "_cache")

_arpa_lib = None
_arpa_tried = False


def _build_arpa() -> Optional[str]:
    # hash-keyed cache + atomic rename: concurrent builders (parallel
    # pytest workers) converge on one .so without partial-file races
    try:
        with open(_ARPA_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = os.path.join(_CACHE, f"htknative-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_CACHE, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", tmp,
           _ARPA_SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def get_arpa_lib():
    """The ARPA codec library, or None when it cannot be built/loaded."""
    global _arpa_lib, _arpa_tried
    if _arpa_tried:
        return _arpa_lib
    _arpa_tried = True
    if os.environ.get("HTKTPU_NO_NATIVE"):
        return None
    so = _build_arpa()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.ht_arpa_parse.restype = ctypes.c_void_p
    lib.ht_arpa_parse.argtypes = [ctypes.c_char_p]
    lib.ht_arpa_error.restype = ctypes.c_char_p
    lib.ht_arpa_error.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_order.restype = ctypes.c_int
    lib.ht_arpa_order.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_nwords.restype = ctypes.c_int64
    lib.ht_arpa_nwords.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_vocab_bytes.restype = ctypes.c_int64
    lib.ht_arpa_vocab_bytes.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_copy_vocab.restype = None
    lib.ht_arpa_copy_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ht_arpa_count.restype = ctypes.c_int64
    lib.ht_arpa_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ht_arpa_copy.restype = None
    lib.ht_arpa_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.ht_arpa_free.restype = None
    lib.ht_arpa_free.argtypes = [ctypes.c_void_p]
    _arpa_lib = lib
    return _arpa_lib


def parse_arpa(path: str) -> Optional[dict]:
    """Parse an ARPA file natively.

    Returns None when the native library is unavailable or the file
    cannot be opened (callers fall back to the Python reader, which owns
    the error reporting). Otherwise a dict:
      {"order": int, "vocab": list[str],
       n: (ids (count, n) uint32, logp (count,) f64 raw log10,
           bo (count,) f64 raw log10, has_bo (count,) bool)
       for n in 1..order with entries in file order}
    """
    import numpy as np

    lib = get_arpa_lib()
    if lib is None:
        return None
    h = lib.ht_arpa_parse(os.fsencode(path))
    if not h:
        return None
    try:
        err = lib.ht_arpa_error(h)
        if err:
            return None
        nw = lib.ht_arpa_nwords(h)
        blob = ctypes.create_string_buffer(
            max(1, int(lib.ht_arpa_vocab_bytes(h))))
        lib.ht_arpa_copy_vocab(h, blob)
        vocab = [w.decode("utf-8", errors="replace")
                 for w in blob.raw[:-1].split(b"\0")] if nw else []
        out = {"order": int(lib.ht_arpa_order(h)), "vocab": vocab}
        for n in range(1, out["order"] + 1):
            cnt = int(lib.ht_arpa_count(h, n))
            ids = np.empty((cnt, n), np.uint32)
            logp = np.empty(cnt, np.float64)
            bo = np.empty(cnt, np.float64)
            hb = np.empty(cnt, np.uint8)
            if cnt:
                lib.ht_arpa_copy(
                    h, n, ids.ctypes.data_as(ctypes.c_void_p),
                    logp.ctypes.data_as(ctypes.c_void_p),
                    bo.ctypes.data_as(ctypes.c_void_p),
                    hb.ctypes.data_as(ctypes.c_void_p))
            out[n] = (ids, logp, bo, hb.astype(bool))
        return out
    finally:
        lib.ht_arpa_free(h)
