"""Optimizers and schedules (the port of `repro.optim`)."""
from repro_torch.optim.optimizers import (
    OptState,
    SGDMState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup_cosine,
    sgdm_init,
    sgdm_update,
)

__all__ = [
    "OptState",
    "SGDMState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
    "sgdm_init",
    "sgdm_update",
]
