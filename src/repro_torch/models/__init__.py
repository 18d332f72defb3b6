"""The model zoo of the port: the dense GQA transformer, hybrid (zamba2), ssm (rwkv6),
moe (deepseek-moe, qwen3-moe), audio (seamless-m4t) and vlm (internvl2) families."""
from repro_torch.models.model import decode_step, forward, init_decode_cache, init_params, loss_fn

__all__ = ["decode_step", "forward", "init_decode_cache", "init_params", "loss_fn"]
