"""Shared machinery of the port's kernels: device resolution, chunk
resolution, the build-and-load of the hand-written CUDA libraries, and the
launch declarations (:class:`KernelLaunch`) that ``repro_torch.analysis``
audits.

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
import math
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from repro_torch.core.h100 import (  # noqa: F401 — re-exported
    H100_SMS,
    SMEM_LIMIT,
    SMEM_PER_SM,
    SMEM_RESERVED,
)

__all__ = [
    "resolve_device",
    "DTYPE_CODE",
    "check_kernel_tensors",
    "on_kernel_device",
    "by_device",
    "pointer_alignment",
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
    "H100_SMS",
    "SMEM_LIMIT",
    "SMEM_PER_SM",
    "SMEM_RESERVED",
    "KernelLaunch",
    "KERNEL_LAUNCH_SPECS",
    "EVERY_ARCH_SPECS",
    "register_launch_spec",
    "occupancy_entry",
    "scoring_shape",
    "SERVE_BATCH",
    "SERVE_PROMPT",
    "DECODE_WINDOWS",
    "TRAIN_BATCH",
    "TRAIN_TOKENS",
    "train_microbatch",
    "SEQ_SHARDS",
    "SEQ_PROMPT",
    "SEQ_GRAD",
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


def check_kernel_tensors(name: str, strided: tuple = (), *, device_type: str = "cuda",
                         **tensors) -> None:
    """Every tensor given (``None`` skipped) lies on the first one's CUDA
    device, is contiguous (those named in ``strided`` excepted: their
    wrapper checks their layout) and does not require grad: the raw kernel
    wrappers take no autograd (gradients go through the ``vjp.py``
    Functions, which hand them detached tensors).  The meta twins of the
    wrappers check the same with ``device_type="meta"``."""
    given = {k: x for k, x in tensors.items() if x is not None}
    dev = next(iter(given.values())).device
    where = "one CUDA device" if device_type == "cuda" else "the meta device"
    for key, x in given.items():
        if x.device != dev or x.device.type != device_type:
            raise ValueError(f"{name}: {key} must be on {where}, got {x.device}")
        if key not in strided and not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if x.requires_grad:
            raise ValueError(
                f"{name}: {key} requires grad; the raw kernel wrappers take no "
                "autograd")


def on_kernel_device(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels: CUDA tensors launch them, meta
    tensors take their meta twins (``repro_torch.core.lowering``)."""
    return x.device.type in ("cuda", "meta")


def by_device(x: torch.Tensor, cuda, meta, plain=None):
    """The kernel wrapper for CUDA tensors, its meta twin for meta tensors,
    the plain version for any other.  ``plain=None`` means the wrapper
    itself, which runs its plain version on CPU tensors."""
    return {"cuda": cuda, "meta": meta}.get(x.device.type, plain or cuda)


def pointer_alignment(*tensors) -> int:
    """The largest power of two, at most 16, that divides every tensor's
    address."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


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
    "flash_attention_bwd": _PKG / "local_attention" / "csrc" / "flash_attention_bwd.cu",
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
#: count, and each library's ``<library>_occupancy(kernel, p0, .., p4)``
#: the card's blocks an SM for the instantiation a plan launches (or minus
#: a ``cudaError_t``).  :func:`open_library` binds them once, when the
#: library is loaded, so no wrapper sets them on a call.
ENTRY_POINTS = {
    "wkv_chunked": {
        "wkv_chunked_fwd": [_P] * 8 + [_I] * 7 + [_P],
        "wkv_chunked_train_fwd": [_P] * 9 + [_I] * 7 + [_P],
        "wkv_chunked_summary_fwd": [_P] * 9 + [_I] * 8 + [_P],
        "wkv_chunked_train_summary_fwd": [_P] * 10 + [_I] * 8 + [_P],
        "wkv_chunked_smem": [_I] * 3,
        "wkv_chunked_occupancy": [_I] * 6,
    },
    "wkv_decode": {
        "wkv_decode_window_fwd": [_P] * 8 + [_I] * 6 + [_P],
        "wkv_decode_smem": [_I] * 2,
        "wkv_decode_occupancy": [_I] * 6,
    },
    "wkv_bwd": {
        "wkv_bwd": [_P] * 14 + [_I] * 8 + [_P],
        "wkv_bwd_smem": [_I] * 3,
        "wkv_bwd_occupancy": [_I] * 6,
    },
    "elevator_scan": {
        "elevator_scan_fwd": [_P] * 4 + [_I] * 7 + [_P],
        "elevator_decode_window_fwd": [_P] * 5 + [_I] * 7 + [_P],
        "elevator_scan_bwd": [_P] * 7 + [_I] * 6 + [_P],
        "elevator_scan_smem": [_I] * 5,
        "elevator_window_smem": [_I] * 4,
        "elevator_scan_bwd_smem": [_I] * 4,
        "elevator_scan_occupancy": [_I] * 6,
    },
    "token_shift": {"token_shift_fwd": [_P] * 3 + [_I] * 5 + [_P],
                    "token_shift_bwd": [_P] * 5 + [_I] * 10 + [_P],
                    "token_shift_bwd_smem": [_I] * 4,
                    "token_shift_fwd_rows": [_I] * 5,
                    "token_shift_occupancy": [_I] * 6},
    "flash_attention": {"flash_attention_fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
                        "flash_fwd_smem": [_I] * 2,
                        "flash_attention_occupancy": [_I] * 6},
    "flash_attention_bwd": {"flash_attention_bwd": [_P] * 10 + [_I] * 8 + [_F] + [_I] * 6 + [_P],
                            "flash_bwd_smem": [_I] * 3,
                            "flash_attention_bwd_occupancy": [_I] * 6},
    "stencil2d": {"stencil2d_fwd": [_P] * 3 + [_I] * 2 + [_F, _I, _I, _P],
                  "stencil2d_occupancy": [_I] * 6},
    "matmul_fwd": {"matmul_fwd": [_P] * 4 + [_I] * 8 + [_P],
                   "matmul_smem": [_I] * 3,
                   "matmul_fwd_occupancy": [_I] * 6},
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


# --------------------------------------------------------------------------
# Launch declarations
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelLaunch:
    """One kernel launch that a main path makes at full width, as its
    planner and its launcher shape it.

    ``kernel`` names the wrapper (its launch counter's name), ``shape`` the
    path and its inputs, ``location`` the launcher in the repo.  ``grid``,
    ``threads``, ``cluster`` and ``dynamic_smem`` are what the launcher
    passes; ``static_smem`` the kernel's ``__shared__`` bytes where known.
    ``occupancy`` holds the arguments of the library's
    ``<library>_occupancy`` query for the instantiation this launch takes;
    each entry of ``queries`` is a C entry point, its arguments and the
    value the Python mirror computed (the C must answer the same).
    ``meta`` keeps the launch's dimensions for the passes' cross-checks, and
    ``state_bytes`` the recurrent state a block reads and writes in device
    memory, where it has one."""

    kernel: str
    location: str
    shape: str
    grid: tuple[int, int, int]
    threads: int
    dynamic_smem: int
    library: str
    occupancy: tuple[int, ...]
    queries: tuple[tuple[str, tuple[int, ...], int], ...] = ()
    cluster: tuple[int, int, int] = (1, 1, 1)
    static_smem: int | None = None
    state_bytes: int | None = None
    meta: tuple[tuple[str, int], ...] = ()

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def cluster_size(self) -> int:
        return math.prod(self.cluster)

    def smem_blocks_per_sm(self) -> int:
        """Blocks an SM that shared memory alone allows: the SM's bytes over
        a block's static and dynamic bytes and the card's reservation."""
        per = self.dynamic_smem + (self.static_smem or 0) + SMEM_RESERVED
        return SMEM_PER_SM // per


#: kernel name -> ``fn(cfg, sms) -> list[KernelLaunch]`` (empty where the
#: arch never launches the kernel).  Each kernel's module registers its own,
#: from its own planner.
KERNEL_LAUNCH_SPECS: dict[str, Callable] = {}
#: The specs whose launches do not depend on the arch (the paper demo's).
EVERY_ARCH_SPECS: set[str] = set()


def register_launch_spec(name: str, fn: Callable, *, every_arch: bool = False) -> Callable:
    """Register ``fn(cfg, sms)`` as the launch spec of kernel ``name``."""
    KERNEL_LAUNCH_SPECS[name] = fn
    if every_arch:
        EVERY_ARCH_SPECS.add(name)
    return fn


def occupancy_entry(library: str) -> str:
    """The C entry point of ``library``'s launch query."""
    return f"{library}_occupancy"


# The main paths' shapes at full width (PERF.md, section 4), which the
# launch specs cover: serving prefill B=4 of 256-token prompts and decode
# windows of these sizes, prompt scoring (B=1, T=4096; the MoE archs B=8,
# T=1024 in their prefill chunks), each training microbatch, and the
# sequence-parallel path's shards.
SERVE_BATCH = 4
SERVE_PROMPT = 256
DECODE_WINDOWS = (1, 8, 32, 64)
#: The trained archs' batch and tokens (``chip_smoke.py`` phases 3b, 3n),
#: split into ``cfg.microbatch`` microbatches.
TRAIN_BATCH = 8
TRAIN_TOKENS = {"rwkv6-1.6b": 256, "gemma3-1b": 2048, "recurrentgemma-2b": 1024}
#: The seq path's shards, its prefill's prompt and its gradient's tokens.
SEQ_SHARDS, SEQ_PROMPT, SEQ_GRAD = 4, 4096, 2048
_SCORING, _SCORING_CHUNKED = (1, 4096), (8, 1024)


def train_microbatch(cfg) -> tuple[int, int] | None:
    """(batch, tokens) of one training microbatch of a trained arch, or
    None: RWKV6 (4, 256), Gemma3-1B (4, 2048), RecurrentGemma-2B (2,
    1024)."""
    if cfg.name not in TRAIN_TOKENS:
        return None
    return TRAIN_BATCH // max(1, cfg.microbatch), TRAIN_TOKENS[cfg.name]


def scoring_shape(cfg) -> tuple[int, int]:
    """(batch of one prefill chunk, tokens) of the arch's prompt scoring."""
    if cfg.prefill_chunks > 1:
        b, t = _SCORING_CHUNKED
        return max(1, b // cfg.prefill_chunks), t
    return _SCORING
