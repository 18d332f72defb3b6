"""Build and bind the port's CUDA kernels: `nvcc` -> shared library -> `ctypes`.

Each source under `csrc/` exports plain C functions (pointers, sizes and the
CUDA stream as arguments, `cudaGetLastError()` as the result).  At first use
it is compiled for Hopper by its own `nvcc` process,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

into `build/` beside this file (listed in .gitignore).  The library name
carries a hash of the source, the headers under `csrc/` and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module on
machines without `nvcc` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("prox_update", "logistic_prox", "flash_attention", "flash_attention_bwd",
           "decode_attention", "ssm_scan", "ssm_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPES = (torch.float32, torch.float64)  # K1 and K2
ATTENTION_DTYPES = (torch.bfloat16, torch.float32)  # K4, K5, K6, K6b, K7 and K7b
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA kernels "
            "are compiled at first use with the CUDA toolkit"
        )
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # what sources include
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no library yet: one `nvcc` per
    source, all started together.  Returns each new build's compiler report
    (ptxas registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The named kernel library (built if needed) with every exported
    function's `argtypes` declared and `restype` set to the CUDA error int."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, types in argtypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


# The current stream's raw handle without building a torch.cuda.Stream (a
# few microseconds a call, which a T = 1 decode launch would notice); CUDA
# builds of PyTorch have it, the public spelling is the fallback.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device (kernels launch there)."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def needs_grad(*tensors) -> bool:
    """Whether grad mode is on and a given tensor (None skipped) requires a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def check_cuda_operands(kernel: str, *, dtypes=DTYPES, **tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every operand is a contiguous CUDA tensor of one dtype
    (one of ``dtypes``) on one device; returns that dtype."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected a CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, other operands on {first.device}")
        if t.dtype not in dtypes:
            takes = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{kernel}: {name} has dtype {t.dtype}; the kernel takes {takes}")
        if t.dtype != first.dtype:
            raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, other operands {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return first.dtype


def check_aligned(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every operand starts on a 16-byte boundary (vector loads)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


def row_scalars(kernel: str, names: tuple[str, str], values, rows: int, like: torch.Tensor):
    """Two per-row scalar operands as ``(a, b, stride)``: scalars broadcast
    with stride 0, ``(rows,)`` tensors are read with stride 1 (a scalar beside
    a tensor is expanded to one)."""
    out = []
    for name, v in zip(names, values):
        if isinstance(v, torch.Tensor) and (v.device != like.device or v.dtype != like.dtype):
            raise ValueError(f"{kernel}: {name} is {v.dtype} on {v.device}, "
                             f"operands are {like.dtype} on {like.device}")
        t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
        if t.ndim and (t.shape != (rows,) or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a scalar or a contiguous ({rows},) tensor")
        out.append(t)
    if all(t.ndim == 0 for t in out):
        return out[0].reshape(1), out[1].reshape(1), 0
    a, b = (t.broadcast_to((rows,)).contiguous() for t in out)
    return a, b, 1


def check_status(kernel: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")
