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
reduced qwen2 configs, a cohort-major batch and tree comparisons are shared;
`deep_step_matches_reference` runs one cohort's train step in both packages
from given weights (the recurrent families' tests).
"""
from __future__ import annotations

import contextlib
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
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # a float32 gradient leaf (tests/test_torch_train.py)


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


# A local step at which Algorithm 7's iteration contracts on the reduced
# models (tests/test_torch_deepsvrp_step.py).
SVRP_KW = dict(eta=1.0, local_lr=0.05, local_steps=3)


def deep_step_matches_reference(jcfg, tcfg, tree, dtype="float32", rounds=2, seq=16):
    """One cohort of 2 x ``seq`` tokens: the port's `make_svrp_train_step`
    against the reference's on a 1 x 1 debug mesh, ``rounds`` rounds from the
    weights ``tree`` (numpy) with gbar = the gradient at x0 (SVRP's
    invariant; the port's, handed to both), the reference's refresh coins
    injected (a refresh and a plain round among them).  The reference's state
    is built as its ``init_state`` builds it, without its eager init, and
    placed on the step's shardings (its second round would compile the step
    again for unplaced inputs).  After
    every round the loss, x and w are held to ``ROUND_TOL[dtype]``, gbar (a
    gradient, taken at x after a refresh) to the gradient tolerance of the
    float32 model tests, ``GRAD_TOL``: the Mamba-2 model's gradients reach
    ~0.5, and its refresh gradient at the new x reads up to 6.2e-6 apart
    (0.35% of the embedding's elements over ROUND_TOL's atol of 1e-6), as far
    as its gradient at one point is between the packages (8e-7) grown by the
    round's step."""
    from repro.core import deep as jdeep
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.steps import SVRPServerState as JState
    from repro.launch.steps import make_svrp_train_step as ref_make_svrp_train_step
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.core import deep as tdeep
    from repro_torch.launch import make_svrp_train_step
    from repro_torch.models import model as TM
    from repro_torch.utils.tree import tree_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    key = jax.random.key(0)
    p, coins = mixed_coin_prob(key, rounds)
    svrp_kw = dict(SVRP_KW, anchor_prob=p)
    batch = lm_batch(tcfg.vocab_size, 1, b=2, seq=seq)
    mesh = make_debug_mesh(data=1, model=1)
    make_step, helpers = ref_make_svrp_train_step(jcfg, mesh, jdeep.DeepSVRPConfig(**svrp_kw))
    jstep = make_step(jax_batch(batch))
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k), key)
    jparams = jax.tree.map(lambda like, a: jnp.asarray(a, like.dtype), shapes, tree)
    x0 = np_tree(jparams)
    params = convert.params_from_numpy(x0, tcfg, device="cpu")
    grads = tdeep.grad_of(lambda q, b: TM.loss_fn(q, tcfg, b), torch_batch(batch))(params)
    gbar = tree_map(lambda g: g.detach().float().numpy(), grads)
    jstate = JState(params=jparams, anchor=jparams, anchor_grad=jax.tree.map(jnp.asarray, gbar),
                    step=jnp.zeros((), jnp.int32), rng=jax.random.key_data(key))
    zero = jax.tree.map(lambda spec: NamedSharding(mesh, spec), helpers["zero_specs"],
                        is_leaf=lambda x: isinstance(x, P))
    jstate = jax.device_put(jstate, JState(zero, zero, zero, NamedSharding(mesh, P()),
                                           NamedSharding(mesh, P())))
    assert deep_coins(jax.random.wrap_key_data(jstate.rng), rounds, p) == coins
    step, _ = make_svrp_train_step(tcfg, tdeep.DeepSVRPConfig(**svrp_kw), device="cpu")
    state = convert.svrp_state_from_numpy(
        {"params": x0, "anchor": x0, "anchor_grad": gbar, "step": 0}, tcfg, device="cpu")
    tol = ROUND_TOL[dtype]
    for r, coin in enumerate(coins):
        jstate, metrics = jstep(jstate, jax_batch(batch))
        state, tmetrics = step(state, batch, refresh=coin)
        np.testing.assert_allclose(tmetrics["loss"].item(), float(metrics["loss"]), **tol)
        for field in ("params", "anchor", "anchor_grad"):
            got = getattr(state, field)
            assert_tree_close(got, np_tree(getattr(jstate, field)),
                              GRAD_TOL if field == "anchor_grad" and dtype == "float32" else tol,
                              f"round {r} {field}")
        assert state.step == int(jstate.step) == r + 1


def reference_params(jcfg, seed: int = 0):
    """The reference's `init_params(jcfg, key(seed))` as numpy leaves,
    jitted: eager init of the recurrent layers compiles op by op, seconds
    more on the CPU."""
    from repro.models import model as JM

    init = jax.jit(lambda key: JM.init_params(jcfg, key))
    return jax.tree.map(np.asarray, init(jax.random.key(seed)))


def randomize_recurrent(tree, family: str, seed: int):
    """Fill, in a reference parameter tree of numpy leaves, the leaves whose
    init values hide wiring faults (zeros and ones; a decay nearly constant
    and a small bonus) with seeded values, as tests/test_torch_hybrid.py and
    tests/test_torch_rwkv.py do: hybrid LoRA ``b`` normal * rank**-0.5,
    ``conv_b`` normal * 0.1, ``D`` normal; ssm ``w0`` uniform in [-6, 1],
    ``w_b`` normal * 64**-0.5, ``u`` normal.  Returns the tree."""
    rng = np.random.default_rng(seed)

    def fill(a, scale, shift=0.0):
        return (rng.standard_normal(a.shape) * scale + shift).astype(a.dtype)

    if family == "hybrid":
        for site in tree["loras"].values():
            site["b"] = fill(site["b"], site["b"].shape[-2] ** -0.5)
        tree["mamba_layers"]["conv_b"] = fill(tree["mamba_layers"]["conv_b"], 0.1)
        tree["mamba_layers"]["D"] = fill(tree["mamba_layers"]["D"], 1.0)
    elif family == "ssm":
        tm = tree["layers"]["tm"]
        tm["w0"] = rng.uniform(-6.0, 1.0, tm["w0"].shape).astype(tm["w0"].dtype)
        tm["w_b"]["w"] = fill(tm["w_b"]["w"], 64**-0.5)
        tm["u"] = fill(tm["u"], 1.0)
    return tree


class _Float64Numpy:
    """`jax.numpy` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def reference_in_float64(module):
    """Run a `repro` module's code with its float32 casts read as float64:
    the module's ``jnp`` seen through a proxy (nothing in `repro` is edited),
    for float64 references of functions that cast to float32 inside."""
    saved = module.jnp
    module.jnp = _Float64Numpy()
    try:
        yield
    finally:
        module.jnp = saved
