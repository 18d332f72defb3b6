"""Bridge helpers for the port's tests: replay `repro`'s PRNG draws as numpy.

`repro` draws its client indices and refresh coins from threefry keys inside
the round (`repro.core.rounds.RoundOps`, `repro.core.baselines`);
`repro_torch` reads them from a `Draws` record.  `replay_draws` makes the
reference's exact draws for a sweep — per trial b: ``key(seed_b)`` ->
``split(key, K)`` -> per round ``split`` -> ``randint`` /
``choice(replace=False)`` / ``bernoulli`` (sppm, sgd and scaffold:
``randint`` on the round key itself; deep_svrp: ``bernoulli`` on the round
key itself, no client; Catalyst first splits ``(key, num_outer)``) — so
both packages run the same trajectories and ``comm``
agrees integer-exactly; `replay_trial` gives one trial's record for the
per-trial drivers.

For the DeepSVRP training tests: `deep_coins` replays the refresh coins the
reference flips from ``fold_in(rng, step)``, `mixed_coin_prob` picks an
anchor probability whose first rounds hold both kinds of round, and the
reduced qwen2 configs, a cohort-major batch and tree comparisons are shared.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.data import ShardedBatcher as JBatcher
from repro.data import SyntheticLMDataset as JDataset
from repro_torch.configs import REGISTRY
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
    if algo == "deep_svrp":  # no client draw: the coin flips on the round key itself
        coins = _per_round_trial(jax.random.bernoulli)(step_keys,
                                                       jnp.broadcast_to(p, step_keys.shape))
        return None, np.asarray(coins)
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


# The baselines draw as the rounds they mirror: sgd and scaffold one client
# from each round key (`repro.core.baselines` randint on the key), svrg a
# client and a coin from its split; composite draws as svrp
# (`repro.core.composite`: split, randint, bernoulli).
_PATTERN = {"sgd": "sppm", "scaffold": "sppm", "svrg": "svrp", "composite": "svrp"}


def replay_draws(algo: str, seeds, M: int, cfg: dict, p=None, dtype=jnp.float64):
    """The reference's draws for a sweep, as numpy ``(clients, coins)``.

    ``seeds`` is the per-trial seed array, ``cfg`` the static config
    (num_steps / num_rounds / batch_clients, or num_outer / inner_steps for
    Catalyst) and ``p`` the per-trial refresh probability."""
    keys = jax.vmap(jax.random.key)(jnp.asarray(np.asarray(seeds), dtype=jnp.uint32))
    p = None if p is None else jnp.asarray(np.asarray(p), dtype)
    if algo == "catalyzed_svrp":
        T, K = cfg["num_outer"], cfg["inner_steps"]
        stage_keys = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, T))(keys), 0, 1)
        stages = [_round_draws(stage_keys[t], "svrp", M, K, p, None) for t in range(T)]
        return np.stack([c for c, _ in stages]), np.stack([c for _, c in stages])
    K = cfg["num_steps"] if "num_steps" in cfg else cfg["num_rounds"]
    return _round_draws(keys, _PATTERN.get(algo, algo), M, K, p, cfg.get("batch_clients"))


def draws_from_numpy(clients, coins, device="cpu", batched=True) -> Draws:
    return Draws(
        None if clients is None else torch.tensor(np.array(clients, dtype=np.int64),
                                                  device=device),
        None if coins is None else torch.tensor(np.array(coins, dtype=bool), device=device),
        batched=batched,
    )


def replay_trial(algo: str, seed: int, M: int, cfg: dict, p=None) -> Draws:
    """One trial's record (no trial axis) of the reference's draws from
    ``jax.random.key(seed)``, for the per-trial ``run_*`` drivers."""
    clients, coins = replay_draws(algo, [seed], M, cfg, None if p is None else [p])
    return draws_from_numpy(clients, coins).trial(0)


# ------------------------------------------------------- DeepSVRP training
ROUND_TOL = {"float32": dict(rtol=1e-4, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def qwen2_configs(dtype="float32"):
    """The reference's and the port's reduced qwen2-1.5b config in ``dtype``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(JAX_REGISTRY["qwen2-1.5b"].reduced(), **kw),
            dataclasses.replace(REGISTRY["qwen2-1.5b"].reduced(), **kw))


def np_tree(tree):
    """A jax tree as float32 numpy (bf16 held exactly)."""
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def lm_batch(vocab, cohorts, b=2, seq=16):
    """One cohort-major batch from the synthetic federated data (numpy)."""
    ds = JDataset(vocab_size=vocab, num_clients=cohorts, alpha=0.5, seed=0)
    return JBatcher(ds, num_cohorts=cohorts, per_cohort_batch=b, seq_len=seq).next_batch()


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def assert_tree_close(got, want, tol, what):
    """``got`` a torch tree, ``want`` a numpy tree of the same dict structure."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{what}.{k}")
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want, **tol, err_msg=what)


def deep_coins(key, steps, p):
    """The reference's refresh coins ``bernoulli(fold_in(key, step), p)``."""
    return [bool(jax.random.bernoulli(jax.random.fold_in(key, s), p)) for s in range(steps)]


def mixed_coin_prob(key, steps=3):
    """An anchor probability whose first ``steps`` coins under ``key`` hold
    both a refresh and a plain round."""
    for p in (0.5, 0.3, 0.7, 0.2, 0.8):
        coins = deep_coins(key, steps, p)
        if any(coins) and not all(coins):
            return p, coins
    raise AssertionError("no anchor probability mixes the coins")
