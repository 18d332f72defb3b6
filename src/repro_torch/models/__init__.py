"""The model zoo of the port: the dense GQA transformer, hybrid (zamba2) and ssm (rwkv6)
families so far."""
from repro_torch.models.model import decode_step, forward, init_decode_cache, init_params, loss_fn

__all__ = ["decode_step", "forward", "init_decode_cache", "init_params", "loss_fn"]
