"""The bridge between the packages: draw replay, native draws and isolation.

* `replay_draws` (tests/_torch_replay.py) must reproduce the exact client
  indices and coins the reference's `RoundOps` draws from its keys;
* `draw_schedule` draws trial s identically whatever the batch size;
* `repro_torch` imports neither `jax` nor `repro`, and its entry points run
  on CUDA by default: with no card they raise instead of running on the CPU.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_replay import replay_draws  # noqa: E402

from repro.core.rounds import RoundOps  # noqa: E402
from repro.problems import make_synthetic_quadratic  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import Draws, draw_schedule  # noqa: E402
from repro_torch.experiments import run_batch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
M = 10


def _ref_ops(B, p, cohort=None):
    prob = make_synthetic_quadratic(num_clients=M, dim=3, seed=0)
    hp = type("HP", (), {"p": jnp.asarray(p)})()
    return RoundOps(prob, hp, jnp.zeros(3), jnp.float64, batched=True, num_trials=B,
                    cohort_size=cohort)


@pytest.mark.parametrize("algo", ["sppm", "svrp", "svrp_minibatch"])
def test_replay_matches_reference_round_primitives(algo):
    """The replayed record equals what the reference's batched RoundOps draws
    (schedule_keys -> split -> uniform_client / sample_cohort / bernoulli)."""
    seeds = np.array([0, 0, 5, 7])
    p = np.array([0.2, 0.5, 0.2, 0.9])
    K = 12
    cohort = 3 if algo == "svrp_minibatch" else None
    clients, coins = replay_draws(algo, seeds, M, {"num_steps": K, "batch_clients": cohort}, p)
    ops = _ref_ops(len(seeds), p, cohort)
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, dtype=jnp.uint32))
    step_keys = ops.schedule_keys(keys, K)
    for k in range(K):
        if algo == "sppm":
            np.testing.assert_array_equal(clients[k], np.asarray(ops.uniform_client(step_keys[k])))
            continue
        key_m, key_c = ops.split(step_keys[k])
        want = ops.sample_cohort(key_m) if cohort else ops.uniform_client(key_m)
        np.testing.assert_array_equal(clients[k], np.asarray(want))
        np.testing.assert_array_equal(coins[k], np.asarray(ops.bernoulli(key_c, ops.hp.p)))
    assert coins is None if algo == "sppm" else coins.shape == (K, len(seeds))


def test_replay_catalyst_stages():
    """Catalyst: per-trial split(key, num_outer), then the svrp draws per stage."""
    seeds, p = np.array([1, 2]), np.array([0.3, 0.3])
    clients, coins = replay_draws("catalyzed_svrp", seeds, M,
                                  {"num_outer": 3, "inner_steps": 4}, p)
    assert clients.shape == (3, 4, 2) and coins.shape == (3, 4, 2)
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, dtype=jnp.uint32))
    stage_keys = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, 3))(keys), 0, 1)
    ops = _ref_ops(2, p)
    step_keys = ops.schedule_keys(stage_keys[2], 4)
    key_m, key_c = ops.split(step_keys[1])
    np.testing.assert_array_equal(clients[2, 1], np.asarray(ops.uniform_client(key_m)))
    np.testing.assert_array_equal(coins[2, 1], np.asarray(ops.bernoulli(key_c, ops.hp.p)))


def test_draw_schedule_is_per_trial():
    """Trial s draws the same numbers whatever B is, and cohorts hold
    distinct clients."""
    big = draw_schedule(np.array([3, 4, 5]), M, 30, np.array([0.1, 0.5, 0.9]))
    small = draw_schedule(np.array([5]), M, 30, 0.9)
    assert torch.equal(big.clients[:, 2], small.clients[:, 0])
    assert torch.equal(big.coins[:, 2], small.coins[:, 0])
    assert big.refresh.shape == (30,) and big.refresh.dtype == bool
    assert int(big.clients.min()) >= 0 and int(big.clients.max()) < M
    cohorts = draw_schedule(np.arange(4), M, 25, 0.2, batch_clients=4)
    assert cohorts.clients.shape == (25, 4, 4) and cohorts.num_trials == 4
    assert all(len(set(row.tolist())) == 4 for row in cohorts.clients.reshape(-1, 4))
    stacked = draw_schedule(np.arange(2), M, 5, 0.2, num_outer=3)
    assert stacked.clients.shape == (3, 5, 2) and stacked.stage(1).refresh.shape == (5,)
    assert draw_schedule(np.arange(2), M, 5).coins is None


def test_refresh_mask_is_any_trial():
    coins = torch.tensor([[False, False], [True, False], [False, True]])
    d = Draws(torch.zeros((3, 2), dtype=torch.int64), coins)
    np.testing.assert_array_equal(d.refresh, [False, True, True])


def test_port_imports_without_jax_or_repro():
    """In a process where `jax` and `repro` cannot be imported, the port and
    every submodule still import."""
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, repro_torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax\b|repro(\.|\s|$))", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO))
                                        for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_jax_or_repro_imports_in_port(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), f"{path} imports jax or repro"


def test_default_device_raises_without_cuda():
    """With no card, run_batch's default device raises and runs nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    prob = make_synthetic_quadratic(num_clients=M, dim=4, seed=0)
    port_p = problem_from_arrays("quadratic", {"A": np.asarray(prob.A), "b": np.asarray(prob.b)},
                                 device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_batch("svrp", port_p, grid={"eta": 0.1, "p": 0.1, "smoothness": 10.0},
                  num_steps=3, fused=True, prox_solver="gd", prox_steps=2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        problem_from_arrays("quadratic", {"A": np.asarray(prob.A), "b": np.asarray(prob.b)})
