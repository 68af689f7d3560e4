"""Build, load and call the port's CUDA kernels.

Each source in ``mvdfusion_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, and one more ``nvcc`` call links the
objects into one shared library with a plain C interface (no PyTorch header,
so the build takes seconds), loaded with ``ctypes``. The library goes to
``build/mvdfusion_tpu_torch/`` beside the package at first use, and is
rebuilt when any source is newer than it. Every entry point takes raw device
pointers and the current CUDA stream and returns ``cudaGetLastError()``;
:func:`call` raises on a non-zero code.

``LAUNCHES`` counts, per wrapper, the launches of its kernel; a wrapper adds
one exactly where it launches and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvdfusion_tpu_torch"
LIB_PATH = BUILD_DIR / "libmvdf_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]

LAUNCHES: collections.Counter = collections.Counter()

# entry point -> argument kinds: p pointer, i int32, l int64, f float32
_SIGNATURES = {
    "mvdf_groupnorm": "ppppiiiifiip",
    "mvdf_gn_stats": "pppppp" + "iiiii" + "f" + "ii" + "p",
    "mvdf_gn_apply": "ppppiiiiip",
    "mvdf_conv3x3": "pppppppp" + "iiiiiii" + "p",
    "mvdf_attention": "ppppiiiiillllllllfip",
    "mvdf_layernorm": "pipppiiifp",
    "mvdf_gemm": "ppppipipiipiiiiiip",
    "mvdf_block_single": "ppi" + "p" * 17 + "p" + "ppppp" + "iiiii" + "ff" + "ip",
    "mvdf_big_attention": "pppiiiifip",
    "mvdf_cv_gather": "pppppppppipiiiiiip",
    "mvdf_cv_gather_tokens": "ppppppppipiiiiiip",
    "mvdf_cv_token_gelu": "pppiiiip",
    "mvdf_cv_attention": "ppiiiifip",
    "mvdf_cv_pool": "ppppiiiip",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64, "f": ctypes.c_float}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    t = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > t for p in list(_sources()) + list(CSRC.glob("*.cuh")))


def build(force: bool = False) -> dict:
    """Compile every csrc/*.cu (one nvcc process each, in parallel) and link
    them into LIB_PATH (if stale). Returns {"seconds", "log", "path",
    "built"}; the log holds -Xptxas -v's per-kernel registers, shared memory
    and spills."""
    if not force and not _stale():
        return {"seconds": 0.0, "log": "", "path": str(LIB_PATH), "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = BUILD_DIR / f".libmvdf_kernels.{tag}.so"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stdout + proc.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-6000:] for f in failed))
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new, never half
    return {"seconds": seconds, "log": log, "path": str(LIB_PATH), "built": True}


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                handle = ctypes.CDLL(str(LIB_PATH))
                for name, sig in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = [_CTYPES[c] for c in sig]
                    fn.restype = ctypes.c_int
                handle.mvdf_error_string.argtypes = [ctypes.c_int]
                handle.mvdf_error_string.restype = ctypes.c_char_p
                _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Launch entry point `name` on the current stream; raise on a CUDA error.
    Tensor arguments are passed as device pointers; they stay referenced here
    until the launch is enqueued, so a temporary cannot be freed and its
    memory reused before the kernel reads it."""
    L = lib()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(L, name)(*(ptr(a) if isinstance(a, torch.Tensor) else a for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({L.mvdf_error_string(rc).decode()})")


def ptr(t) -> int | None:
    """Device pointer of a contiguous CUDA tensor (None passes through as NULL)."""
    if t is None:
        return None
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous CUDA tensors")
    return t.data_ptr()


def view_ptr(t) -> int:
    """Device pointer of a CUDA tensor view that may be strided (the kernel
    takes its strides separately)."""
    if not t.is_cuda:
        raise ValueError("kernel operands must be CUDA tensors")
    return t.data_ptr()


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise TypeError(f"the CUDA kernels take bfloat16 or float32, not {dtype}")


def is_bf16(t) -> int:
    return 0 if t is None else dtype_code(t.dtype)
