"""Build and load the native matching-statistics library (libms).

The port's copy of :mod:`memo_tpu.native.build`. Compiles ``libms.cpp`` on
first use with g++ into a per-source-hash shared object under
``memo_tpu_torch/build/native/`` (gitignored, beside the CUDA kernels'
build), then binds it via ctypes (no pybind11 dependency). If no C++
toolchain is available the caller falls back to the pure-Python automaton in
:mod:`memo_tpu_torch.index.ms`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "libms.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED: str | None = None


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "build", "native")


def _cache_dir() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return _BUILD_DIR


def _sanitize() -> bool:
    """ASAN/UBSAN build mode (SURVEY §5 sanitizer row): MEMO_TPU_ASAN=1
    compiles libms with -fsanitize=address,undefined for fuzz/CI runs."""
    return os.environ.get("MEMO_TPU_ASAN", "") == "1"


def _build() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    tag = "-asan" if _sanitize() else ""
    so_path = os.path.join(_cache_dir(), f"libms-{digest}{tag}.so")
    if os.path.exists(so_path):
        return so_path
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-pthread",
    ]
    if _sanitize():
        cmd += ["-fsanitize=address,undefined", "-fno-omit-frame-pointer", "-g"]
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd += [_SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)
    return so_path


def load_libms() -> ctypes.CDLL | None:
    """Compile (cached) and load libms; returns None if unavailable."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _FAILED is not None:
            return None
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError, FileNotFoundError) as e:
            _FAILED = str(e)
            return None
        lib.ms_build.restype = ctypes.c_void_p
        lib.ms_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.ms_free.restype = None
        lib.ms_free.argtypes = [ctypes.c_void_p]
        lib.ms_num_states.restype = ctypes.c_int64
        lib.ms_num_states.argtypes = [ctypes.c_void_p]
        lib.ms_query.restype = None
        lib.ms_query.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ms_build_capped.restype = ctypes.c_void_p
        lib.ms_build_capped.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        lib.ms_sa.restype = ctypes.c_int64
        lib.ms_sa.argtypes = [
            ctypes.c_char_p,  # text
            ctypes.c_int64,  # n
            ctypes.c_char_p,  # pivot (records joined by 0x01)
            ctypes.c_int64,  # m
            ctypes.POINTER(ctypes.c_int32),  # out [m]
        ]
        lib.ms_gsa.restype = ctypes.c_int64
        lib.ms_gsa.argtypes = [
            ctypes.c_char_p,  # text (all units, '$'-terminated)
            ctypes.c_int64,  # n
            ctypes.POINTER(ctypes.c_int64),  # unit_ends [n_units]
            ctypes.c_int64,  # n_units
            ctypes.POINTER(ctypes.c_int32),  # unit_color [n_units]
            ctypes.c_int32,  # n_colors
            ctypes.c_char_p,  # pivot (records joined by 0x01)
            ctypes.c_int64,  # m
            ctypes.POINTER(ctypes.c_int32),  # out [n_colors * m]
        ]
        lib.ms_gsa_mt.restype = ctypes.c_int64
        lib.ms_gsa_mt.argtypes = lib.ms_gsa.argtypes + [
            ctypes.c_int32,  # n_threads for the per-color scan pairs
        ]
        # Streaming GSA API: build once, scan color blocks with bounded
        # memory (pangenome_ms folds each block into per-doc accumulators).
        lib.gsa_build.restype = ctypes.c_int64
        lib.gsa_build.argtypes = lib.ms_gsa.argtypes[:8] + [
            ctypes.POINTER(ctypes.c_void_p),  # out handle
        ]
        lib.gsa_scan.restype = ctypes.c_int64
        lib.gsa_scan.argtypes = [
            ctypes.c_void_p,  # handle
            ctypes.c_int32,  # c0
            ctypes.c_int32,  # c1
            ctypes.POINTER(ctypes.c_int32),  # out [(c1-c0) * m]
            ctypes.c_int32,  # n_threads (parallel color blocks)
        ]
        lib.gsa_free.restype = None
        lib.gsa_free.argtypes = [ctypes.c_void_p]
        lib.ms_overlaps_chunk.restype = ctypes.c_int64
        lib.ms_overlaps_chunk.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # ms chunk [P, D]
            ctypes.c_int64,  # P (chunk rows)
            ctypes.c_int64,  # D
            ctypes.c_int64,  # pos0
            ctypes.c_int64,  # L
            ctypes.c_int32,  # is_final (emit sentinel)
            ctypes.POINTER(ctypes.c_int32),  # prev_row [D]
            ctypes.POINTER(ctypes.c_int64),  # prev_end [D] (in/out)
            ctypes.c_int64,  # cap
            ctypes.POINTER(ctypes.c_int64),  # out_s
            ctypes.POINTER(ctypes.c_int64),  # out_e
            ctypes.POINTER(ctypes.c_int32),  # out_o
        ]
        lib.ms_rc_start.restype = None
        lib.ms_rc_start.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # ms_rc [m]
            ctypes.c_int64,  # m
            ctypes.POINTER(ctypes.c_int32),  # out [m]
        ]
        lib.sais_u8.restype = ctypes.c_int32
        lib.sais_u8.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ms_overlaps.restype = ctypes.c_int64
        lib.ms_overlaps.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # ms [P*D] row-major
            ctypes.c_int64,  # P
            ctypes.c_int64,  # D
            ctypes.c_int64,  # L
            ctypes.c_int64,  # cap
            ctypes.POINTER(ctypes.c_int64),  # out starts
            ctypes.POINTER(ctypes.c_int64),  # out ends
            ctypes.POINTER(ctypes.c_int32),  # out orders
        ]
        _LIB = lib
        return lib


def build_error() -> str | None:
    return _FAILED
