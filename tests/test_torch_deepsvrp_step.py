"""The port's DeepSVRP train step (`launch.make_svrp_train_step`, C cohorts
run in turn on one device) against the reference's `make_svrp_train_step` on
a debug mesh, on the CPU.

Both start from one state: the reference's weights with gbar = the cohort
mean of the float32 gradients at x0, carried across as numpy
(`convert.svrp_state_from_numpy`); the token batch comes from the same
numpy seed and the refresh coins are the reference's own, ``bernoulli(
fold_in(rng, step), p)`` (src/repro/launch/steps.py:243-246), injected
into the port.  Three rounds, a refresh and a plain round among them: one
cohort in float32 and in bf16 on a 1 x 1 mesh in-process, two cohorts on a
2 x 1 mesh in a subprocess with two host devices.

Tolerances: x, w, gbar and the loss after each round rtol 1e-4, atol 1e-6
in float32, the reference's 2e-2 in bf16.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import (  # noqa: E402
    ROUND_TOL,
    assert_tree_close,
    deep_coins,
    jax_batch,
    lm_batch,
    mixed_coin_prob,
    np_tree,
    qwen2_configs,
)
from repro.core import deep as jdeep  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.launch.steps import make_svrp_train_step as ref_make_svrp_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import deep as tdeep  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.prox_update import prox_update  # noqa: E402
from repro_torch.launch import make_svrp_train_step  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model's ops are tiny, and with several
    test processes on the host torch's thread pools contend (70x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_launches_nothing():
    prox_update.launches = flash_attention.launches = flash_attention_bwd.launches = 0
    yield
    assert prox_update.launches == flash_attention.launches == flash_attention_bwd.launches == 0


def _port_rounds(tcfg, state_np, batch, coins, svrp_kw, cohorts):
    """The port's train step from a reference state: per round (state, loss)."""
    step, _ = make_svrp_train_step(tcfg, tdeep.DeepSVRPConfig(**svrp_kw), cohorts=cohorts,
                                   device="cpu")
    state = convert.svrp_state_from_numpy(state_np, tcfg, device="cpu")
    out = []
    for coin in coins:
        state, metrics = step(state, batch, refresh=coin)
        out.append((convert.state_to_numpy(state), metrics["loss"].item()))
    return out


# A local step at which Algorithm 7's iteration contracts on this model:
# at the reference test's lr 0.2 (eta 0.5) it multiplies a difference in x
# by ~3e3 a round (the reduced model's curvature reaches ~60), so float32
# summation-order differences alone outgrow any tolerance within a round.
SVRP_KW = dict(eta=1.0, local_lr=0.05, local_steps=3)


def _start_state(jcfg, jparams, batch, cohorts):
    """The reference's initial server state with gbar = the cohort mean of
    the float32 gradients at x0 (SVRP's invariant), as numpy: its own
    `init_state` starts from gbar = 0, where x stays at x0 up to rounding and
    the rounds would compare rounding noise."""
    b = batch["tokens"].shape[0] // cohorts
    shards = [jax_batch({k: v[c * b:(c + 1) * b] for k, v in batch.items()})
              for c in range(cohorts)]
    grad = jax.jit(jax.grad(lambda p, shard: JM.loss_fn(p, jcfg, shard, remat=False)))
    grads = [grad(jparams, shard) for shard in shards]
    gbar = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g) / cohorts, *grads)
    x0 = np_tree(jparams)
    return {"params": x0, "anchor": x0, "anchor_grad": gbar, "step": 0}


def _to_jax_state(state, state_np):
    """``state`` (a reference SVRPServerState) with x, w and gbar from ``state_np``."""
    cast = lambda like, new: jax.tree.map(  # noqa: E731
        lambda a, b: jnp.asarray(b, a.dtype), like, new)
    return state._replace(params=cast(state.params, state_np["params"]),
                          anchor=cast(state.anchor, state_np["anchor"]),
                          anchor_grad=cast(state.anchor_grad, state_np["anchor_grad"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_one_cohort_matches_reference(dtype):
    """(c) C = 1 against the reference's step on a 1 x 1 debug mesh,
    in-process; (e) the same in bf16 at the reference's bf16 tolerance."""
    jcfg, tcfg = qwen2_configs(dtype)
    key = jax.random.key(0)
    p, coins = mixed_coin_prob(key)
    svrp_kw = dict(SVRP_KW, anchor_prob=p)
    batch = lm_batch(tcfg.vocab_size, 1, b=2, seq=16)
    make_step, helpers = ref_make_svrp_train_step(jcfg, make_debug_mesh(data=1, model=1),
                                                  jdeep.DeepSVRPConfig(**svrp_kw))
    jstep = make_step(jax_batch(batch))
    jstate = helpers["init_state"](key)
    assert deep_coins(jax.random.wrap_key_data(jstate.rng), 3, p) == coins
    state_np = _start_state(jcfg, jstate.params, batch, 1)
    jstate = _to_jax_state(jstate, state_np)
    got = _port_rounds(tcfg, state_np, batch, coins, svrp_kw, cohorts=1)
    tol = ROUND_TOL[dtype]
    for r, (state, loss) in enumerate(got):
        jstate, metrics = jstep(jstate, jax_batch(batch))
        np.testing.assert_allclose(loss, float(metrics["loss"]), **tol)
        for field in ("params", "anchor", "anchor_grad"):
            want = np_tree(getattr(jstate, field))
            assert_tree_close(tree_map(torch.from_numpy, state[field]), want, tol,
                              f"round {r} {field}")
        assert state["step"] == int(jstate.step)


_TWO_COHORTS = r"""
import json, sys, dataclasses
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_enable_x64", True)
from repro.configs import REGISTRY
from repro.core.deep import DeepSVRPConfig
from repro.data import ShardedBatcher, SyntheticLMDataset
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import make_svrp_train_step

args = json.loads(sys.argv[1])
cfg = dataclasses.replace(REGISTRY["qwen2-1.5b"].reduced(), param_dtype="float32",
                          compute_dtype="float32")
ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, num_clients=2, alpha=0.5, seed=0)
batch = ShardedBatcher(ds, num_cohorts=2, per_cohort_batch=2, seq_len=16).next_batch()
make_step, helpers = make_svrp_train_step(cfg, make_debug_mesh(data=2, model=1),
                                          DeepSVRPConfig(**args["svrp"]))
jb = {k: jnp.asarray(v) for k, v in batch.items()}
step = make_step(jb)
state = helpers["init_state"](jax.random.key(0))
gbar0 = np.load(args["gbar0"])
paths, treedef = jax.tree_util.tree_flatten_with_path(state.anchor_grad)
name = lambda path: "/".join(str(k.key) for k in path)
state = state._replace(anchor_grad=jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(gbar0[name(path)]) for path, _ in paths]))
out = {}
for r in range(3):
    state, m = step(state, jb)
    out[f"{r}/loss"] = np.asarray(m["loss"])
    for field in ("params", "anchor", "anchor_grad"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(getattr(state, field))[0]:
            out[f"{r}/{field}/{name(path)}"] = np.asarray(leaf, np.float32)
np.savez(args["out"], **out)
"""


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_train_step_two_cohorts_matches_reference(tmp_path):
    """(d) C = 2 cohorts in turn against the reference's 2 x 1 debug mesh,
    which runs in a subprocess with two host devices."""
    jcfg, tcfg = qwen2_configs()
    key = jax.random.key(0)
    p, coins = mixed_coin_prob(key)
    svrp_kw = dict(SVRP_KW, anchor_prob=p)
    batch = lm_batch(tcfg.vocab_size, 2, b=2, seq=16)
    state_np = _start_state(jcfg, JM.init_params(jcfg, key), batch, 2)
    flat = jax.tree_util.tree_flatten_with_path(state_np["anchor_grad"])[0]
    np.savez(tmp_path / "gbar0.npz", **{"/".join(str(k.key) for k in path): leaf
                                        for path, leaf in flat})
    out = tmp_path / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    args = {"svrp": svrp_kw, "out": str(out), "gbar0": str(tmp_path / "gbar0.npz")}
    r = subprocess.run([sys.executable, "-c", _TWO_COHORTS, json.dumps(args)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    ref = np.load(out)
    got = _port_rounds(tcfg, state_np, batch, coins, svrp_kw, cohorts=2)
    tol = ROUND_TOL["float32"]
    for name in ref.files:
        r_, field, *rest = name.split("/")
        state, loss = got[int(r_)]
        if field == "loss":
            np.testing.assert_allclose(loss, ref[name], **tol)
        else:
            np.testing.assert_allclose(_leaf(state[field], "/".join(rest)), ref[name], **tol,
                                       err_msg=name)
    assert len(ref.files) == 3 * (1 + 3 * len(flat))
