"""Where the port runs: the GPU unless the caller names another device.

Every entry point of `repro_torch` (the problem generators, `run_batch`,
`run_sequential`, the ``run_*`` drivers, `convert.problem_from_arrays`)
resolves its `device=` argument here.  `None`
means CUDA; with no card present that raises instead of quietly running the
plain PyTorch path on the CPU.  Tests and CPU references pass `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA when it is None."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:  # "cuda" names the current card, as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def problem_device(problem, device: str | torch.device | None = None) -> torch.device:
    """The device an entry point that takes a built problem runs on: `device`
    resolved as `resolve_device` does, which must be where `problem` lives."""
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(
            f"problem lives on {problem.device} but this run is on {dev}; "
            "build the problem with device=..."
        )
    return dev


def full_precision_matmul() -> None:
    """Keep float32 products in full float32: no TF32 in cuBLAS or cuDNN.

    The engine's float32 gradients are batched `matmul`s; TF32 keeps about
    three decimal digits, far below the tolerances the port is held to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
