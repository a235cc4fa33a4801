"""Build the package's CUDA kernels with nvcc on first use and load them.

The sources in ``memo_tpu_torch/csrc`` have a plain C interface: nvcc
compiles them into one shared library (no PyTorch headers, so the build takes
seconds), which is loaded with ctypes. The library lands in
``memo_tpu_torch/build/<hash>/``, keyed by a hash of the sources and flags, so
an edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libmemo_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel, kept in build.log
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")
    return path


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_library() -> pathlib.Path:
    """Path of the compiled kernel library, compiling it if this source set
    has not been built yet. Raises with nvcc's stderr when the build fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}"
        )
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the old state or the whole file
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built if needed)."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.memo_fused_query.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.memo_fused_query.restype = i32
    lib.memo_cuda_error_string.argtypes = [i32]
    lib.memo_cuda_error_string.restype = ctypes.c_char_p
    return lib
