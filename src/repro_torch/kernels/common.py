"""Shared machinery of the port's kernels: device resolution, chunk
resolution, and the build-and-load of the hand-written CUDA libraries.

Every CUDA source (``kernels/<name>/csrc/*.cu``) is compiled by ``nvcc``
into its own shared library with a plain C interface and loaded through
``ctypes``.  Nothing is compiled when a module is imported: the first call
that needs a library builds every source at once, one ``nvcc`` process per
source, all started together, into ``build/`` at the root of the checkout.
Each library's file name carries a hash of its source, of every shared
header (``*.cuh`` under ``kernels/``, which the sources may include through
the ``-I`` of the shared Hopper header directory) and of the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "resolve_device",
    "DTYPE_CODE",
    "check_kernel_tensors",
    "validate_divisible",
    "largest_divisor_chunk",
    "KERNEL_SOURCES",
    "BUILD_DIR",
    "HEADER_ROOT",
    "HOPPER_INCLUDE",
    "BUILD_REPORT",
    "ENTRY_POINTS",
    "build_libraries",
    "open_library",
    "load_library",
    "launch_stream",
    "sm_count",
]


# --------------------------------------------------------------------------
# Devices
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and
    absent: nothing moves to the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


# --------------------------------------------------------------------------
# Kernel argument checks
# --------------------------------------------------------------------------

#: dtype -> the C interfaces' dtype code.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_kernel_tensors(name: str, strided: tuple = (), **tensors) -> None:
    """Every tensor given (``None`` skipped) lies on the first one's CUDA
    device, is contiguous (those named in ``strided`` excepted: their
    wrapper checks their layout) and does not require grad: the raw kernel
    wrappers take no autograd (the WKV gradient goes through
    ``wkv.vjp.WKVFunction``)."""
    given = {k: x for k, x in tensors.items() if x is not None}
    dev = next(iter(given.values())).device
    for key, x in given.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be on one CUDA device, got {x.device}")
        if key not in strided and not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if x.requires_grad:
            raise ValueError(
                f"{name}: {key} requires grad; the raw kernel wrappers take no "
                "autograd")


# --------------------------------------------------------------------------
# Chunk validation (kernel wrappers)
# --------------------------------------------------------------------------

def validate_divisible(name: str, total: int, block: int) -> None:
    if block < 1 or total % block:
        raise ValueError(f"{name}={total} not divisible by block={block}")


def largest_divisor_chunk(t: int, chunk: int) -> int:
    """Largest c <= min(chunk, t) with t % c == 0 (always exists: c=1)."""
    for c in range(min(chunk, t), 0, -1):
        if t % c == 0:
            return c
    return 1


# --------------------------------------------------------------------------
# CUDA build and load
# --------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent
#: library name -> its CUDA source.
KERNEL_SOURCES = {
    "wkv_chunked": _PKG / "wkv" / "csrc" / "wkv_chunked.cu",
    "wkv_decode": _PKG / "wkv" / "csrc" / "wkv_decode.cu",
    "wkv_bwd": _PKG / "wkv" / "csrc" / "wkv_bwd.cu",
    "elevator_scan": _PKG / "elevator_scan" / "csrc" / "elevator_scan.cu",
    "token_shift": _PKG / "token_shift" / "csrc" / "token_shift.cu",
    "flash_attention": _PKG / "local_attention" / "csrc" / "flash_attention.cu",
    "stencil2d": _PKG / "stencil2d" / "csrc" / "stencil2d.cu",
    "matmul_fwd": _PKG / "matmul_fwd" / "csrc" / "matmul_fwd.cu",
}
#: ``build/`` at the root of the checkout (listed in ``.gitignore``).
BUILD_DIR = _PKG.parents[2] / "build"
#: Where the shared headers live: every ``*.cuh`` below it enters every
#: library's hash.
HEADER_ROOT = _PKG
#: The shared Hopper header (``sm90.cuh``: mbarriers, TMA, wgmma, setmaxnreg).
HOPPER_INCLUDE = _PKG / "hopper" / "csrc"

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
    "-I", str(HOPPER_INCLUDE),
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: library -> its C entry points -> their argument types (pointers and the
#: stream as ``c_void_p``, else ctypes would pass each as a 32-bit int).
#: Every entry point returns an int: the launches 0, a ``cudaError_t`` or
#: 10000 + the ``CUresult`` of a tensor map, the ``*_smem`` functions a byte
#: count.  :func:`open_library` binds them once, when the library is loaded,
#: so no wrapper sets them on a call.
ENTRY_POINTS = {
    "wkv_chunked": {
        "wkv_chunked_fwd": [_P] * 8 + [_I] * 7 + [_P],
        "wkv_chunked_train_fwd": [_P] * 9 + [_I] * 7 + [_P],
        "wkv_chunked_summary_fwd": [_P] * 9 + [_I] * 8 + [_P],
        "wkv_chunked_train_summary_fwd": [_P] * 10 + [_I] * 8 + [_P],
        "wkv_chunked_smem": [_I] * 3,
    },
    "wkv_decode": {
        "wkv_decode_window_fwd": [_P] * 8 + [_I] * 6 + [_P],
        "wkv_decode_smem": [_I] * 2,
    },
    "wkv_bwd": {
        "wkv_bwd": [_P] * 14 + [_I] * 8 + [_P],
        "wkv_bwd_smem": [_I] * 3,
    },
    "elevator_scan": {
        "elevator_scan_fwd": [_P] * 4 + [_I] * 7 + [_P],
        "elevator_decode_window_fwd": [_P] * 5 + [_I] * 7 + [_P],
    },
    "token_shift": {"token_shift_fwd": [_P] * 3 + [_I] * 5 + [_P]},
    "flash_attention": {"flash_attention_fwd": [_P] * 4 + [_I] * 8 + [_F, _I, _P]},
    "stencil2d": {"stencil2d_fwd": [_P] * 3 + [_I] * 2 + [_F, _I, _P]},
    "matmul_fwd": {"matmul_fwd": [_P] * 4 + [_I] * 8 + [_P]},
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> (seconds to build or 0.0 if cached, compiler's report).
BUILD_REPORT: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library's path in ``build/``, named by a hash of its source,
    every shared header (sorted, by content) and the flags."""
    h = hashlib.sha256(KERNEL_SOURCES[name].read_bytes())
    for header in sorted(HEADER_ROOT.rglob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries() -> dict[str, Path]:
    """Build every library that is not built yet, one ``nvcc`` per source,
    all running at once.  Returns name -> path.  Raises with the
    compiler's output if any build fails."""
    names = list(KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:
        if n not in todo:
            BUILD_REPORT.setdefault(n, (0.0, "cached"))
    procs = {}
    t0 = time.perf_counter()
    nvcc = _nvcc() if todo else None
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        report, _ = proc.communicate()
        BUILD_REPORT[n] = (time.perf_counter() - t0, report)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{report}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])   # atomic: no reader sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def open_library(name: str, path) -> ctypes.CDLL:
    """Load the shared object at ``path`` as library ``name``, its entry
    points bound to their :data:`ENTRY_POINTS` signatures."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``; the first call builds every source."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            for n, path in build_libraries().items():
                if n not in _LIBS:
                    _LIBS[n] = open_library(n, path)
        return _LIBS[name]


def launch_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` names (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
