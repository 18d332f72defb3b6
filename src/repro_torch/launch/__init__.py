"""One card: DeepSVRP training (`make_svrp_train_step`, the `train` launcher) and
serving (`BatchServer`, the prefill and serve steps)."""
from repro_torch.launch.serve import BatchServer, ServeConfig
from repro_torch.launch.steps import (
    SVRPServerState,
    make_prefill_step,
    make_serve_step,
    make_svrp_train_step,
)

__all__ = ["BatchServer", "SVRPServerState", "ServeConfig", "make_prefill_step",
           "make_serve_step", "make_svrp_train_step"]
