"""The native image loader (counterpart of mvdfusion_tpu/native/): loader.cc
decodes jpg and png files, resizes them (an area average to downscale, a
half-pixel bilinear to upscale) and composites RGBA on white where alpha <
0.5, a batch at a time on a pool of C++ threads.

The library is built at first use by one ``g++`` process into
``build/mvdfusion_tpu_torch/libmvdf_loader.so`` beside the package, and
rebuilt when loader.cc is newer than it; it needs the libjpeg, libpng and
zlib headers. ctypes releases the interpreter lock for the call, so a
prefetch thread (data/prefetch.py) decodes beside the train step.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvdfusion_tpu_torch"
LIB_PATH = BUILD_DIR / "libmvdf_loader.so"
CXX = "g++"
# the JAX package's native/Makefile: the same flags give the same floats
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-ljpeg", "-lpng", "-lz", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_why: Optional[str] = None  # why the library could not be built or loaded, once tried
_lock = threading.Lock()


class DecodeError(RuntimeError):
    """The built decoder refused a file (missing, truncated, not a jpg or png)."""


def _stale() -> bool:
    return not LIB_PATH.exists() or SOURCE.stat().st_mtime > LIB_PATH.stat().st_mtime


def build(force: bool = False) -> dict:
    """Compile loader.cc into LIB_PATH if it is missing or older than the
    source (always with `force`). Returns {"seconds", "path", "built"};
    raises RuntimeError with the compiler's output when the build fails."""
    if not force and not _stale():
        return {"seconds": 0.0, "path": str(LIB_PATH), "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libmvdf_loader.{os.getpid()}.so"
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{(proc.stdout + proc.stderr)[-6000:]}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees the old library or the new one
    return {"seconds": time.perf_counter() - t0, "path": str(LIB_PATH), "built": True}


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None (and `reason()`
    says why) where it cannot be built or loaded. Tries once a process."""
    global _lib, _why
    with _lock:
        if _lib is None and _why is None:
            try:
                build()
                lib = ctypes.CDLL(str(LIB_PATH))
            except (RuntimeError, OSError) as e:
                _why = str(e)
                return None
            lib.mvdf_decode.restype = ctypes.c_int
            lib.mvdf_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
            lib.mvdf_decode_batch.restype = ctypes.c_int
            lib.mvdf_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int]
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def reason() -> Optional[str]:
    """Why the library is unavailable (None before the first try and once loaded)."""
    return _why


def decode_batch(
    paths: Sequence[str],
    out_h: int,
    out_w: int,
    out_c: int = 3,
    white_composite: bool = True,
    n_threads: int = 4,
) -> np.ndarray:
    """Decode, resize to (out_h, out_w) and (with `white_composite`) put RGBA
    on white where alpha < 0.5: (N, out_h, out_w, out_c) float32, samples
    divided by 255. out_c 1 keeps the first channel (the red one of a colour
    image). Raises RuntimeError where the library is unavailable and
    DecodeError naming every file the decoder refused."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {_why}")
    if min(out_h, out_w) < 1 or not 1 <= out_c <= 4:
        raise ValueError(f"output {out_h}x{out_w}x{out_c}: sizes >= 1 and 1 to 4 channels")
    n = len(paths)
    out = np.empty((n, out_h, out_w, out_c), np.float32)
    encoded = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    failures = lib.mvdf_decode_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w, out_c,
                                     1 if white_composite else 0, max(1, n_threads))
    if failures:
        # the batch call counts its failures; one call a file names them
        one = np.empty((out_h, out_w, out_c), np.float32)
        ptr = one.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        bad = [str(p) for p, e in zip(paths, encoded)
               if lib.mvdf_decode(e, ptr, out_h, out_w, out_c, 1 if white_composite else 0)]
        raise DecodeError(f"the native loader could not decode {failures} of {n} files: {', '.join(bad)}")
    return out
