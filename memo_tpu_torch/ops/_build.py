"""Build the package's CUDA kernels with nvcc on first use and load them.

The sources in ``memo_tpu_torch/csrc`` have a plain C interface: nvcc
compiles each ``.cu`` file to an object, all of them at once in parallel (no
PyTorch headers, so each takes seconds), and links them into one shared
library, which is loaded with ctypes. The library lands in
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

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libmemo_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    cu = [s for s in _sources() if s.suffix == ".cu"]
    objects = [out_dir / f"{s.stem}.{os.getpid()}.o" for s in cu]
    log = _run_together(
        [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(s)] for s, obj in zip(cu, objects)]
    )
    log += _run_together([[nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)]])
    (out_dir / "build.log").write_text(log)
    for obj in objects:
        obj.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the old state or the whole file
    return lib


def _run_together(cmds: list[list[str]]) -> str:
    """Start every command at once and wait for all; raise with nvcc's
    stderr if any failed. Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{err}")
    return "".join(out + err for out, err in outs)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built if needed)."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # v1: 6 store row pointers, params, prefix, scratch, out, the ragged
    # offsets (or null), the event-path tile count (or null); the offsets' total;
    # n_rows, Q, L, C, c0, G, k, tile, n_docs, membership; the stream.
    lib.memo_fused_query_rows.argtypes = [ptr] * 12 + [i64] + [i32] * 10 + [ptr]
    lib.memo_fused_query_rows.restype = i32
    # v1's split of a conservation launch's tiles: G, tile, tiles, ragged.
    lib.memo_fused_query_event_rows.argtypes = [i32, i32, i64, i32]
    lib.memo_fused_query_event_rows.restype = i32
    # v2: 6 store row pointers, params, prefix, state, sums, out, the ragged
    # offsets (or null); their total and tiles; n_rows, Q, L, C, c0, G, k,
    # tile, stages, n_docs, membership; the stream.
    lib.memo_fused_query_v2_rows.argtypes = [ptr] * 12 + [i64] * 2 + [i32] * 11 + [ptr]
    lib.memo_fused_query_v2_rows.restype = i32
    # window parameters: 4 store row pointers, 2 key pointers, the starts on
    # the card (or null), the starts on the host (by value), out; rec_lo,
    # rec_n, n_keys, L, k, stride, first_key; Q, C, monotone; the stream.
    lib.memo_window_params.argtypes = [ptr] * 9 + [i64] * 7 + [i32] * 3 + [ptr]
    lib.memo_window_params.restype = i32
    lib.memo_window_inline_starts.argtypes = []
    lib.memo_window_inline_starts.restype = i32
    lib.memo_cuda_error_string.argtypes = [i32]
    lib.memo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry, device: torch.device, *args) -> int:
    """``entry(*args, stream)``, a C entry point of the library that launches
    on the current device, given the raw handle of ``device``'s current
    stream; ``device`` is made current for the call only where it is not.
    Returns the entry point's CUDA error code. The handle comes from the
    accessor torch's own generated kernels use: the public ``Stream``
    object costs several microseconds more a call (PERF.md, section 6)."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
