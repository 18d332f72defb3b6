"""Bridge helpers for the port's tests: replay `repro`'s PRNG draws as numpy.

`repro` draws its client indices and refresh coins from threefry keys inside
the round (`repro.core.rounds.RoundOps`); `repro_torch` reads them from a
`Draws` record.  `replay_draws` makes the reference's exact draws for a sweep
— per trial b: ``key(seed_b)`` -> ``split(key, K)`` -> per round ``split`` ->
``randint`` / ``choice(replace=False)`` / ``bernoulli`` (sppm: ``randint`` on
the round key itself; Catalyst first splits ``(key, num_outer)``) — so both
packages run the same trajectories and ``comm`` agrees integer-exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core.draws import Draws


def _per_round_trial(fn):
    """``fn`` on every (round, trial) key of a (K, B) key array."""
    return jax.vmap(jax.vmap(fn))


def _round_draws(keys, algo: str, M: int, num_steps: int, p, batch_clients):
    """(clients, coins) numpy arrays for (B,) trial keys: (K, B[, b]), (K, B)."""
    step_keys = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, num_steps))(keys), 0, 1)

    def uniform(k):
        return jax.random.randint(k, (), 0, M)

    if algo == "sppm":
        return np.asarray(_per_round_trial(uniform)(step_keys)), None
    split = _per_round_trial(jax.random.split)(step_keys)  # (K, B, 2)
    key_m, key_c = split[:, :, 0], split[:, :, 1]
    if batch_clients is None:
        clients = _per_round_trial(uniform)(key_m)
    else:
        clients = _per_round_trial(
            lambda k: jax.random.choice(k, M, shape=(batch_clients,), replace=False)
        )(key_m)
    coins = _per_round_trial(jax.random.bernoulli)(key_c, jnp.broadcast_to(p, key_c.shape))
    return np.asarray(clients), np.asarray(coins)


def replay_draws(algo: str, seeds, M: int, cfg: dict, p=None, dtype=jnp.float64):
    """The reference's draws for a fused sweep, as numpy ``(clients, coins)``.

    ``seeds`` is the per-trial seed array, ``cfg`` the static config
    (num_steps / batch_clients, or num_outer / inner_steps for Catalyst) and
    ``p`` the per-trial refresh probability."""
    keys = jax.vmap(jax.random.key)(jnp.asarray(np.asarray(seeds), dtype=jnp.uint32))
    p = None if p is None else jnp.asarray(np.asarray(p), dtype)
    if algo == "catalyzed_svrp":
        T, K = cfg["num_outer"], cfg["inner_steps"]
        stage_keys = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, T))(keys), 0, 1)
        stages = [_round_draws(stage_keys[t], "svrp", M, K, p, None) for t in range(T)]
        return np.stack([c for c, _ in stages]), np.stack([c for _, c in stages])
    return _round_draws(keys, algo, M, cfg["num_steps"], p, cfg.get("batch_clients"))


def draws_from_numpy(clients, coins, device="cpu") -> Draws:
    return Draws(
        torch.tensor(np.array(clients, dtype=np.int64), device=device),
        None if coins is None else torch.tensor(np.array(coins, dtype=bool), device=device),
    )
