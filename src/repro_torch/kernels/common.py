"""Shared machinery of the port's kernels: device resolution, chunk
resolution, and the build-and-load of the hand-written CUDA libraries.

Every CUDA source (``kernels/<name>/csrc/*.cu``) is compiled by ``nvcc``
into its own shared library with a plain C interface and loaded through
``ctypes``.  Nothing is compiled when a module is imported: the first call
that needs a library builds every source at once, one ``nvcc`` process per
source, all started together, into ``build/`` at the root of the checkout.
Each library's file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
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
    "BUILD_REPORT",
    "build_libraries",
    "load_library",
    "launch_stream",
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

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

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
    src = KERNEL_SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``; the first call builds every source."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            for n, path in build_libraries().items():
                if n not in _LIBS:
                    _LIBS[n] = ctypes.CDLL(str(path))
            lib = _LIBS[name]
        return lib


def launch_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
