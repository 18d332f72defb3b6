"""Per-backend peaks and model FLOPs utilization.

Port of the peak half of `repro.utils.roofline`: the datasheet table
(`PEAKS`, `BackendPeak`), a measured CPU peak (`calibrated_cpu_peak`: time a
dense matmul on this host, cache it), `get_peak` and `mfu`.  The platform
comes from torch: ``"gpu"`` where CUDA is available, ``"cpu"`` otherwise.

The reference's other half, the optimized-HLO parser (`parse_computations`,
`computation_multipliers`, `collective_stats`) and `xla_flops`, reads what
XLA compiles; nothing in the port is compiled by XLA, so it has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class BackendPeak:
    """One backend's roofline ceiling: peak FLOP/s (and bandwidths when the
    datasheet gives them — None means 'not modeled for this backend')."""

    flops: float  # peak FLOP/s per chip
    hbm_bw: float | None  # B/s per chip
    ici_bw: float | None  # B/s per link per chip (NVLink for the GPU row)
    source: str  # "datasheet" or the calibration recipe used


# Datasheet peaks.  The GPU row is the H100 SXM's bf16 dense tensor-core
# rate, its HBM3 bandwidth and its NVLink rate.  CPU has no datasheet row on
# purpose: `get_peak("cpu")` measures this host instead.
PEAKS: dict[str, BackendPeak] = {
    "gpu": BackendPeak(989e12, 3350e9, 900e9, "datasheet (H100 SXM, bf16)"),
}

_CPU_PEAK_CACHE: dict[str, BackendPeak] = {}


def calibrated_cpu_peak(dtype: str = "float32", n: int = 512, reps: int = 5) -> BackendPeak:
    """Measured CPU peak FLOP/s: best-of-`reps` dense (n, n) matmul (2 n^3
    flops) timed on THIS host with torch, cached per (dtype, n).  An MFU
    against it is a same-host fraction."""
    import torch

    key = f"{dtype}:{n}"
    if key not in _CPU_PEAK_CACHE:
        a = torch.ones((n, n), dtype=getattr(torch, dtype))
        torch.matmul(a, a)  # warm the BLAS outside the timed region
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            torch.matmul(a, a)
            best = min(best, time.perf_counter() - t0)
        _CPU_PEAK_CACHE[key] = BackendPeak(
            2.0 * n**3 / best, None, None,
            f"calibrated ({n}x{n} {dtype} matmul, best of {reps})",
        )
    return _CPU_PEAK_CACHE[key]


def default_platform() -> str:
    """``"gpu"`` where torch sees a CUDA device, ``"cpu"`` otherwise."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def get_peak(platform: str | None = None, dtype: str = "float32") -> BackendPeak:
    """The roofline ceiling for `platform` (default: `default_platform()`).

    The GPU comes from the datasheet table; CPU is measured on first use
    (`calibrated_cpu_peak`) and cached for the process."""
    if platform is None:
        platform = default_platform()
    if platform in PEAKS:
        return PEAKS[platform]
    if platform == "cpu":
        return calibrated_cpu_peak(dtype=dtype)
    raise ValueError(
        f"no peak entry for platform {platform!r}: add it to "
        "repro_torch.utils.roofline.PEAKS"
    )


def mfu(achieved_flops_per_s: float, platform: str | None = None,
        dtype: str = "float32") -> float:
    """Model FLOPs utilization: achieved FLOP/s over the backend peak."""
    return achieved_flops_per_s / get_peak(platform, dtype=dtype).flops
