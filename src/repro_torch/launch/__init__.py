"""Serving on one card: `BatchServer` and the single-device prefill and serve steps."""
from repro_torch.launch.serve import BatchServer, ServeConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step

__all__ = ["BatchServer", "ServeConfig", "make_prefill_step", "make_serve_step"]
