"""Float32 drift of the port and of the reference from one float64 run.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/measure_f32_drift.py

Two checks of the CPU tests hold a float32 number of the port to the
reference's float32 number: the AdamW train step's gradient norm
(tests/test_torch_optim.py, ``test_adamw_train_step_matches_reference``)
and the loss of DeepSVRP on the federated LM over the recurrent families
(tests/test_torch_fed_lm.py,
``test_deep_svrp_on_the_recurrent_families_matches_the_reference``).  This
runs the same steps again in float64 in both packages: the reference with
its float32 casts read as float64 (`reference_in_float64` on each module
that pins float32), the port under `Float64Mode` (every float32 cast and
float32 ``dtype=`` read as float64).  It prints, for each case, the two
float64 runs' relative gap (they must agree: the truth) and each package's
float32 relative distance from the reference's float64 run, the largest
over the steps.  For the gradient norm it prints both packages' distance
twice: the norm as each step reports it (float32 sums), and the float64
norm of the step's float32 gradients (the gradients' own accuracy; the
test holds the port's reported norm to the reference's float64 one).
The port runs on one intra-op thread, as both tests run it: its float32
sums depend on the thread count.  Where the port's distance is no larger
than the reference's, the float32 gap between the packages is summation
order, and a test's tolerance is set from these distances.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_replay import randomize_recurrent, reference_in_float64, reference_params  # noqa: E402
from _torch_replay import replay_draws  # noqa: E402

REF_MODULES = ("repro.models.layers", "repro.models.model", "repro.models.rwkv",
               "repro.models.hybrid", "repro.models.ssm", "repro.models.transformer",
               "repro.kernels.ops", "repro.kernels.ref", "repro.kernels._ssm_chunked",
               "repro.kernels.ssm_scan", "repro.kernels.rwkv6_scan",
               "repro.kernels.flash_attention", "repro.kernels.decode_attention",
               "repro.optim.optimizers")


class Float64Mode(TorchDispatchMode):
    """The port's code with every float32 cast read as float64: each aten
    operation, backwards included, with ``torch.float32`` as an argument or
    as ``dtype=`` gets ``torch.float64`` instead, under a float64 default
    dtype."""

    def __enter__(self):
        self._default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        return super().__enter__()

    def __exit__(self, *exc):
        torch.set_default_dtype(self._default)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        args = tuple(torch.float64 if a is torch.float32 else a for a in args)
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        return func(*args, **kwargs)


@contextlib.contextmanager
def reference_f64():
    import importlib

    with contextlib.ExitStack() as stack:
        for name in REF_MODULES:
            mod = importlib.import_module(name)
            if hasattr(mod, "jnp"):
                stack.enter_context(reference_in_float64(mod))
        yield


def _f64(cfg):
    return dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                        / np.abs(np.asarray(b, np.float64))))


# ------------------------------------------------------------------ AdamW
def adamw_case(name: str, steps: int = 3) -> dict:
    from repro import optim as jopt
    from repro.configs import REGISTRY as JREG
    from repro.data import ShardedBatcher as JBatcher
    from repro.data import SyntheticLMDataset as JDataset
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.configs import REGISTRY
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_update, clip_by_global_norm
    from repro_torch.utils.tree import tree_leaves, tree_map, value_and_grad

    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(JREG[name].reduced(), **kw)
    tcfg = dataclasses.replace(REGISTRY[name].reduced(), **kw)
    lr, clip = 3e-4, 1.0
    if tcfg.family == "dense":
        tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0)))
    else:
        tree = randomize_recurrent(reference_params(jcfg), tcfg.family, 100)
    ds = JDataset(vocab_size=tcfg.vocab_size, num_clients=1, alpha=0.5, seed=0)
    batcher = JBatcher(ds, num_cohorts=1, per_cohort_batch=2, seq_len=16)
    batches = [batcher.next_batch() for _ in range(steps)]

    def reference(cfg, dtype):
        def body(state, batch):
            loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(p, cfg, batch))(state["params"])
            exact = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float64) ** 2)
                                 for g in jax.tree.leaves(grads)))
            grads, gnorm = jopt.clip_by_global_norm(grads, clip)
            params, opt = jopt.adamw_update(grads, state["opt"], state["params"], lr=lr)
            return {"params": params, "opt": opt}, loss, gnorm, exact

        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        state = {"params": params, "opt": jopt.adamw_init(params)}
        if dtype == jnp.float64:
            state["opt"] = jax.tree.map(lambda a: a.astype(jnp.float64)
                                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                                        state["opt"])
        step = jax.jit(body)
        norms, losses, exact = [], [], []
        for b in batches:
            state, loss, norm, ex = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            norms.append(float(norm))
            losses.append(float(loss))
            exact.append(float(ex))
        return norms, losses, exact

    def port(cfg, f64: bool):
        """The body of `make_adamw_train_step`, with the float64 norm of
        the float32 gradients beside the norm the step reports."""
        jstate = {"params": tree, "opt": jax.tree.map(
            np.asarray, jopt.adamw_init(jax.tree.map(jnp.asarray, tree)))}
        state = convert.adamw_state_from_numpy(jstate, cfg, device="cpu")
        params, opt = state.params, state.opt
        if f64:
            params = tree_map(torch.Tensor.double, params)
            opt = opt._replace(mu=tree_map(torch.Tensor.double, opt.mu),
                               nu=tree_map(torch.Tensor.double, opt.nu))
        norms, exact, losses = [], [], []
        for b in batches:
            batch = {k: torch.as_tensor(v).long() for k, v in b.items()}
            loss, grads = value_and_grad(lambda p, bb: TM.loss_fn(p, cfg, bb), params, batch)
            exact.append(float(torch.sqrt(sum((g.double() ** 2).sum()
                                              for g in tree_leaves(grads)))))
            grads, gnorm = clip_by_global_norm(grads, clip)
            params, opt = adamw_update(grads, opt, params, lr=lr)
            norms.append(gnorm.item())
            losses.append(loss.item())
        return norms, losses, exact

    r32 = reference(jcfg, jnp.float32)
    with reference_f64():
        r64 = reference(_f64(jcfg), jnp.float64)
    p32 = port(tcfg, False)
    with Float64Mode():
        p64 = port(_f64(tcfg), True)
    # [0] the norm each step reports (float32 sums), [2] the float64 norm of
    # its float32 gradients: the test holds the port's [0] to the reference's [2]
    return {"case": f"adamw grad_norm {name}", "f64_gap": _rel(p64[2], r64[2]),
            "ref_f32_dist": _rel(r32[2], r64[2]), "port_f32_dist": _rel(p32[0], r64[2]),
            "port_grads_f32_dist": _rel(p32[2], r64[2]),
            "ref_reported_f32_dist": _rel(r32[0], r64[2]),
            "port_vs_ref_f32": _rel(p32[0], r32[2]),
            "loss": {"f64_gap": _rel(p64[1], r64[1]), "ref_f32_dist": _rel(r32[1], r64[1]),
                     "port_f32_dist": _rel(p32[1], r64[1])}}


# ------------------------------------------------------------------ FedLM
def fed_lm_case(name: str, rounds: int = 2) -> dict:
    from jax.flatten_util import ravel_pytree

    from repro.configs import REGISTRY as JREG
    from repro.data import SyntheticLMDataset as JDataset
    from repro.experiments import run_batch as ref_run_batch
    from repro.problems.fed_lm import FedLMProblem
    from repro_torch.configs import REGISTRY
    from repro_torch.convert import fed_lm_x0_from_numpy
    from repro_torch.core import Draws
    from repro_torch.experiments import run_batch
    from repro_torch.problems.fed_lm import make_fed_lm_problem

    M, BSZ, SEQ, SEED, K = 3, 2, 16, 0, 2
    grid = {"eta": 1.0, "local_lr": 0.2, "anchor_prob": 0.5}
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(JREG[name].reduced(), **kw)
    tcfg = dataclasses.replace(REGISTRY[name].reduced(), **kw)
    tree = randomize_recurrent(reference_params(jcfg, SEED), tcfg.family, 100)
    ds = JDataset(vocab_size=jcfg.vocab_size, num_clients=M, alpha=0.3, seed=SEED)
    toks = np.stack([ds.sample(m, BSZ, SEQ) for m in range(M)])

    def reference(cfg, dtype):
        x0, unravel = ravel_pytree(jax.tree.map(lambda a: jnp.asarray(a, dtype), tree))
        prob = FedLMProblem(tokens=jnp.asarray(toks[:, :, :-1], jnp.int32),
                            labels=jnp.asarray(toks[:, :, 1:], jnp.int32), cfg=cfg,
                            unravel=unravel, num_params=int(x0.size))
        return ref_run_batch("deep_svrp", prob, grid=grid, seeds=[1], x0=x0, x_star=x0,
                             num_steps=rounds, local_steps=K)

    ref32 = reference(jcfg, jnp.float32)
    _, coins = replay_draws("deep_svrp", ref32.seeds, M, {"num_steps": rounds},
                            ref32.hparams["anchor_prob"], dtype=jnp.float32)
    with reference_f64():
        ref64 = reference(_f64(jcfg), jnp.float64)

    def port(cfg):
        prob, _ = make_fed_lm_problem(cfg, num_clients=M, per_client_batch=BSZ, seq_len=SEQ,
                                      alpha=0.3, seed=SEED, device="cpu")
        x0 = fed_lm_x0_from_numpy(tree, cfg, device="cpu")
        return run_batch("deep_svrp", prob, grid=grid, seeds=[1], x0=x0, x_star=x0,
                         num_steps=rounds, local_steps=K,
                         draws=Draws(None, torch.tensor(coins)), device="cpu")

    p32 = port(tcfg).dist_sq.numpy()
    with Float64Mode():
        p64 = port(_f64(tcfg)).dist_sq.numpy()
    r32, r64 = np.asarray(ref32.dist_sq), np.asarray(ref64.dist_sq)
    return {"case": f"fed_lm dist_sq {name}", "f64_gap": _rel(p64, r64),
            "ref_f32_dist": _rel(r32, r64), "port_f32_dist": _rel(p32, r64),
            "port_vs_ref_f32": _rel(p32, r32)}


def main() -> None:
    torch.set_num_threads(1)  # as both tests run: the port's float32 sums depend on it
    for name in ("qwen2-1.5b", "llama3.2-3b", "zamba2-2.7b", "rwkv6-1.6b"):
        print(json.dumps(adamw_case(name)), flush=True)
    for name in ("zamba2-2.7b", "rwkv6-1.6b"):
        print(json.dumps(fed_lm_case(name)), flush=True)


if __name__ == "__main__":
    main()
