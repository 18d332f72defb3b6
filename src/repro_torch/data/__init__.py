"""Synthetic federated token data (numpy), equal to `repro.data`'s for a seed."""
from repro_torch.data.pipeline import ShardedBatcher
from repro_torch.data.synthetic import SyntheticLMDataset, client_partition

__all__ = ["SyntheticLMDataset", "client_partition", "ShardedBatcher"]
