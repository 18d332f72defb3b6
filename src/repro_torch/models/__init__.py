"""The model zoo of the port: the dense GQA transformer family so far."""
from repro_torch.models.model import decode_step, forward, init_decode_cache, init_params, loss_fn

__all__ = ["decode_step", "forward", "init_decode_cache", "init_params", "loss_fn"]
