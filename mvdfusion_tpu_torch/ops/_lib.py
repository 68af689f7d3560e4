"""Build, load and call the port's CUDA kernels.

Each source in ``mvdfusion_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, and one more ``nvcc`` call links the
objects into one shared library with a plain C interface (no PyTorch header,
so the build takes seconds), loaded with ``ctypes``. The library goes to
``build/mvdfusion_tpu_torch/`` beside the package at first use, and is
rebuilt when any source is newer than it. Every entry point takes raw device
pointers and the current CUDA stream and returns ``cudaGetLastError()``;
:func:`call` raises on a non-zero code.

Every entry point launches its kernel on a CUDA tensor and takes its plain
version on a CPU tensor or under the kernel-off switch (`kernel_route`):
``MVDF_DISABLE_PALLAS`` set to any non-empty value, read when called, as the
reference reads it, or `plain_versions()` around a call. An entry point with
a gradient runs its kernel inside `with_plain_backward`, a
torch.autograd.Function whose backward is its plain version's autograd,
recomputed on the saved inputs (the reference's custom VJPs); a launcher
reached with an input that needs a gradient outside one raises
(`no_graph`), so a kernel never returns a tensor that silently drops the
graph.

``LAUNCHES`` counts, per wrapper, the launches of its kernel; a wrapper adds
one exactly where it launches and nowhere else. ``GEMM_SHAPES`` breaks the
GEMM's launches down by route and shape (ops/block.py::gemm), and
``GN_SHAPES`` K1's by (B, N, C, act) (ops/groupnorm.py::launch_group_norm,
the UNet's GroupNorms and the sites' own), ``LN_SHAPES`` the sites'
LayerNorm's by (M, C) (ops/block.py::layernorm). These four count what the
host launches. A replay of a captured CUDA graph (utils/graphs.py) launches
its kernels from the graph: it adds the counts its capture made to
``REPLAYED``, under the counter's name, and `counted` gives both together.
"""

from __future__ import annotations

import collections
import contextlib
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
GEMM_SHAPES: collections.Counter = collections.Counter()
GN_SHAPES: collections.Counter = collections.Counter()
LN_SHAPES: collections.Counter = collections.Counter()
_COUNTERS = dict(LAUNCHES=LAUNCHES, GEMM_SHAPES=GEMM_SHAPES, GN_SHAPES=GN_SHAPES, LN_SHAPES=LN_SHAPES)
REPLAYED: dict = {name: collections.Counter() for name in _COUNTERS}

# entry point -> argument kinds: p pointer, i int32, l int64, f float32
_SIGNATURES = {
    "mvdf_groupnorm": "pppp" + "iiii" + "iiiiii" + "f" + "ii" + "p" + "i" + "p",
    "mvdf_gn_max_clusters": "iiiiip",
    "mvdf_gn_stats": "ppppppp" + "iiiiii" + "f" + "ii" + "p",
    "mvdf_gn_apply": "pppp" + "iiiiiii" + "p",
    "mvdf_conv3x3": "pppppppp" + "iiiiiii" + "p",
    "mvdf_attention": "ppppiiiiillllllllfiip",
    "mvdf_attention_sm90": "pppppiiiillllllllf" + "p",
    "mvdf_layernorm": "pppp" + "ii" + "f" + "i" + "p",
    "mvdf_gemm": "ppppipipiipiiiiiip",
    "mvdf_tma_desc": "piiip",
    "mvdf_gemm_sm90": "ppppipipiipiiiiiip",
    "mvdf_block_single": "ppi" + "p" * 17 + "p" + "ppppp" + "p" + "iiiii" + "ff" + "ip",
    "mvdf_big_attention": "pppp" + "iiii" + "f" + "ii" + "p",
    "mvdf_qkv_attention_sm90": "ppppiiiiifp",
    "mvdf_cv_gather": "pppppppppipiiiiiiiip",
    "mvdf_cv_attention": "ppiiiifip",
    "mvdf_cv_layernorm": "ppppiifip",
    "mvdf_cv_pool": "ppppiiiip",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64, "f": ctypes.c_float}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for c in (*_COUNTERS.values(), *REPLAYED.values()):
        c.clear()


def counted(name: str = "LAUNCHES") -> collections.Counter:
    """Counter `name` (LAUNCHES or a shape counter) with the graph replays'
    counts added: every kernel that ran, from the host or a graph."""
    return _COUNTERS[name] + REPLAYED[name]


@contextlib.contextmanager
def uncounted():
    """The calls inside count nothing: on exit the counters are as they were
    before, and the yielded dict holds, by counter name, what the calls
    counted (a graph's capture, which launches nothing)."""
    before = {name: collections.Counter(c) for name, c in _COUNTERS.items()}
    got = {}
    try:
        yield got
    finally:
        for name, c in _COUNTERS.items():
            got[name] = c - before[name]
            c.clear()
            c.update(before[name])


def count_replay(counts: dict) -> None:
    """Add a replay's counts (uncounted's dict of its capture) to REPLAYED."""
    for name, c in counts.items():
        REPLAYED[name].update(c)


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
    "built", "sources"}: "sources" maps each source's name to the seconds
    after the start at which its nvcc ended (the build waits for the last);
    the log holds -Xptxas -v's per-kernel registers, shared memory and
    spills."""
    if not force and not _stale():
        return {"seconds": 0.0, "log": "", "path": str(LIB_PATH), "built": False, "sources": {}}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outs, ended = {}, {}

    def wait(src, proc):
        outs[src] = proc.communicate()[0]
        ended[src] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(cmd[-1], proc)) for cmd, _, proc in jobs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = [], []
    for cmd, _, proc in jobs:
        logs.append(" ".join(cmd) + "\n" + outs[cmd[-1]])
        if proc.returncode != 0:
            failed.append(outs[cmd[-1]])
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
    return {"seconds": seconds, "log": log, "path": str(LIB_PATH), "built": True,
            "sources": {Path(src).name: t for src, t in ended.items()}}


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


def tma_desc(t, box_rows: int):
    """The tensor map of a CUDA (rows, cols) bf16 matrix read in boxes of 64
    columns x box_rows rows (csrc/gemm_sm90.cu), as a 128-byte host buffer."""
    buf = ctypes.create_string_buffer(128)
    rc = lib().mvdf_tma_desc(ptr(t), t.shape[0], t.shape[1], box_rows, buf)
    if rc != 0:
        raise RuntimeError(f"mvdf_tma_desc: CUDA error {rc} ({lib().mvdf_error_string(rc).decode()})")
    return buf


def gn_max_clusters(k: int, threads: int, smem: int, resident: bool, dtype_code: int) -> int:
    """How many of K1's clusters (k CTAs of `threads` threads and `smem`
    bytes of dynamic shared memory, keeping their rows or not) the current
    card holds at once (cudaOccupancyMaxActiveClusters)."""
    n = ctypes.c_int(0)
    rc = lib().mvdf_gn_max_clusters(k, threads, smem, int(resident), dtype_code, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"mvdf_gn_max_clusters: CUDA error {rc} ({lib().mvdf_error_string(rc).decode()})")
    return n.value


SWITCH = "MVDF_DISABLE_PALLAS"


def switched_off() -> bool:
    """Whether the kernel-off switch is set: MVDF_DISABLE_PALLAS non-empty,
    read when called (the reference's test, ops/attention.py:301)."""
    return bool(os.environ.get(SWITCH))


def kernel_route(device_type: str, off: bool | None = None) -> bool:
    """Whether an entry point launches its kernel for a tensor on
    `device_type` with the switch `off` (default: as set now): on "cuda"
    unless switched off; else it takes its plain version."""
    return device_type == "cuda" and not (switched_off() if off is None else off)


def launches(t) -> bool:
    """kernel_route for tensor `t`'s device and the switch as set now."""
    return kernel_route(t.device.type)


@contextlib.contextmanager
def plain_versions():
    """Set the kernel-off switch for the calls inside (every route takes its
    plain version); restores the variable's previous state on exit."""
    old = os.environ.get(SWITCH)
    os.environ[SWITCH] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(SWITCH, None)
        else:
            os.environ[SWITCH] = old


def reads_prepared(t) -> bool:
    """Whether the model's kernel sites read their cached prepared weights
    for activations `t`: where the kernels launch (the plain versions read
    the parameters as they are)."""
    return launches(t)


def needs_grad(*tensors) -> bool:
    """Whether autograd records an operation on any of `tensors` (None and
    nested lists or tuples allowed)."""
    if not torch.is_grad_enabled():
        return False
    for t in tensors:
        if isinstance(t, (list, tuple)):
            if needs_grad(*t):
                return True
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


def no_graph(name: str, *tensors) -> None:
    """Raise if autograd would record an operation on one of `tensors`: a
    kernel's output has no graph, so a launcher runs only under no_grad, on
    inputs that need no gradient, or inside with_plain_backward's forward."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name}: a kernel launch drops the autograd graph; call its entry point (a "
                           "torch.autograd.Function), or launch under torch.no_grad()")


class _PlainBackward(torch.autograd.Function):
    """forward: launch(*tensors); backward: the autograd of plain(*tensors),
    recomputed on the saved inputs (the reference's custom VJPs, whose
    backward is the vjp of the kernel's plain twin)."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) if t is not None else None for t, w in zip(saved, wants)]
            out = ctx.plain(*ins)
            leaves = [t for t, w in zip(ins, wants) if w]
            got = iter(torch.autograd.grad(out, leaves, grad, allow_unused=True))
        return (None, None, *(next(got) if w else None for w in wants))


def with_plain_backward(launch, plain, *tensors):
    """launch(*tensors), one tensor; where autograd records on `tensors`, as
    a torch.autograd.Function whose backward is plain's autograd on the saved
    inputs. `launch` and `plain` take the tensors in order (None allowed)."""
    if not needs_grad(*tensors):
        return launch(*tensors)
    return _PlainBackward.apply(launch, plain, *tensors)


def cached(owner, attr: str, params, dtype, build):
    """build(), kept on `owner` under `attr` until the data pointer, version
    or dtype of one of `params` changes, or `dtype` does."""
    key = (dtype, *((p.data_ptr(), p._version, p.dtype) for p in params))
    hit = getattr(owner, attr, None)
    if hit is None or hit[0] != key:
        hit = (key, build())
        setattr(owner, attr, hit)
    return hit[1]


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
