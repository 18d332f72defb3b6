"""One card: DeepSVRP training (`make_svrp_train_step`, the `train` launcher),
the AdamW baseline (`make_adamw_train_step`) and serving (`BatchServer`, the
prefill and serve steps, bf16 or int8 weights)."""
from repro_torch.launch.serve import BatchServer, ServeConfig
from repro_torch.launch.steps import (
    AdamWTrainState,
    SVRPServerState,
    make_adamw_train_step,
    make_prefill_step,
    make_serve_step,
    make_svrp_train_step,
)

__all__ = ["AdamWTrainState", "BatchServer", "SVRPServerState", "ServeConfig",
           "make_adamw_train_step", "make_prefill_step", "make_serve_step",
           "make_svrp_train_step"]
