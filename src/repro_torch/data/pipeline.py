"""Host feed: assembles per-cohort client batches, cohort-major.

A copy of `repro.data.pipeline` (numpy only).  Rows ``[m*b:(m+1)*b]`` of a
batch come from client m: the reference's mesh 'data' axis, and the cohort
loop of the one-card train step (`launch.steps.make_svrp_train_step`)."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import SyntheticLMDataset


class ShardedBatcher:
    """Yields global batches where rows [m*b:(m+1)*b] come from client m —
    the layout the SVRP train_step expects (cohort == data-axis shard)."""

    def __init__(
        self,
        dataset: SyntheticLMDataset,
        num_cohorts: int,
        per_cohort_batch: int,
        seq_len: int,
    ):
        assert dataset.num_clients >= num_cohorts, "need >= 1 client per cohort"
        self.ds = dataset
        self.num_cohorts = num_cohorts
        self.per_cohort_batch = per_cohort_batch
        self.seq_len = seq_len

    def next_batch(self) -> dict:
        parts = [
            self.ds.batch(m % self.ds.num_clients, self.per_cohort_batch, self.seq_len)
            for m in range(self.num_cohorts)
        ]
        return {
            k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]
        }  # (num_cohorts * b, seq)

    def __iter__(self):
        while True:
            yield self.next_batch()
