"""Synthetic token pipeline with *heterogeneous clients* — the data substrate
for the federated experiments on the model zoo.

A copy of `repro.data.synthetic` (numpy only), so that the same seed gives
the port and the reference equal token arrays.

Each client m draws from its own Markov token source; a Dirichlet(alpha)
mixture over a few shared "topic" transition matrices controls inter-client
heterogeneity (alpha -> inf: iid clients, small delta; alpha -> 0: disjoint
topics, large delta).  This mirrors how the paper's statistical-similarity
examples behave (Section 9: iid sampling => small delta) while letting the
benchmarks *vary* similarity, which is the quantity SVRP's rate depends on.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMDataset:
    def __init__(
        self,
        vocab_size: int,
        num_clients: int,
        num_topics: int = 4,
        alpha: float = 1.0,
        order_dim: int = 64,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.num_clients = num_clients
        rng = np.random.default_rng(seed)
        # low-rank topic transition structure: logits = E_topic @ D_topic[token]
        self.emit = rng.standard_normal((num_topics, order_dim, vocab_size)) * 0.7
        self.ctx = rng.standard_normal((num_topics, vocab_size, order_dim)) * 0.7
        self.mix = rng.dirichlet(np.full(num_topics, alpha), size=num_clients)
        self._rngs = [np.random.default_rng(seed + 1 + m) for m in range(num_clients)]

    def sample(self, client: int, batch: int, seq_len: int) -> np.ndarray:
        """(batch, seq_len+1) int32 token stream for one client."""
        rng = self._rngs[client]
        mix = self.mix[client]
        emit = np.einsum("t,tov->ov", mix, self.emit)
        ctx = np.einsum("t,tvo->vo", mix, self.ctx)
        out = np.empty((batch, seq_len + 1), np.int32)
        tok = rng.integers(0, self.vocab_size, size=batch)
        out[:, 0] = tok
        for t in range(seq_len):
            logits = ctx[tok] @ emit  # (batch, vocab)
            logits -= logits.max(axis=-1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(axis=-1, keepdims=True)
            cum = np.cumsum(p, axis=-1)
            u = rng.uniform(size=(batch, 1))
            tok = (cum < u).sum(axis=-1).astype(np.int32)
            out[:, t + 1] = tok
        return out

    def batch(self, client: int, batch: int, seq_len: int) -> dict:
        toks = self.sample(client, batch, seq_len)
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def client_partition(n_items: int, num_clients: int, alpha: float, seed: int = 0) -> list[np.ndarray]:
    """Dirichlet partition of item indices across clients (standard FL split)."""
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(np.full(num_clients, alpha))
    counts = np.maximum((props * n_items).astype(int), 1)
    counts[-1] = n_items - counts[:-1].sum()
    perm = rng.permutation(n_items)
    out, ofs = [], 0
    for c in counts:
        out.append(perm[ofs : ofs + c])
        ofs += c
    return out
