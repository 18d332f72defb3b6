"""What to run: the algorithm registry and the shared `RunSpec`.

Port of `repro.experiments.spec`: every `ALGOS` entry of the reference.
Resolution, trial table, static config, theory-stepsize resolution
(`core.theory.theory_grid`) and every validation error text are the
reference's, so a sweep that `repro` rejects fails here with the same message.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.baselines import (
    AccEGParams,
    DANEParams,
    ScaffoldParams,
    SGDParams,
    SVRGParams,
    acc_extragradient_scan,
    dane_scan,
    scaffold_scan,
    sgd_scan,
    svrg_scan,
)
from repro_torch.core.catalyst import CatalyzedSVRPParams, catalyzed_svrp_scan
from repro_torch.core.channel import get_channel
from repro_torch.core.composite import CompositeSVRPParams, composite_svrp_scan
from repro_torch.core.deep import DeepSVRPScanParams, deep_svrp_scan
from repro_torch.core.minibatch import MinibatchParams, svrp_minibatch_scan
from repro_torch.core.prox import get_prox_solver
from repro_torch.core.sppm import SPPMParams, sppm_scan
from repro_torch.core.svrp import SVRPParams, svrp_scan
from repro_torch.core.types import RunResult
from repro_torch.experiments.grid import expand_grid, with_seeds

_REQUIRED = object()


@dataclass(frozen=True)
class AlgoSpec:
    """How the engine drives one algorithm.

    `defaults` maps every hparam field of `params_cls` to its default value
    (`_REQUIRED` = the caller's grid must provide it); `static` maps every
    static-config kwarg of `scan_fn` likewise.  `scan_fn(problem, x0,
    x_star, draws, hp, **static)` runs the algorithm over the lanes of its
    hparams: one trial (`run_sequential`) or a ``(B,)`` batch (`run_batch`).
    """

    params_cls: type
    scan_fn: Callable[..., RunResult]
    defaults: Mapping[str, Any]
    static: Mapping[str, Any]
    fusable: bool = False  # runs on the fused substrate (rounds.batched_scan)
    # Which static-config key supplies the fused path's Algorithm-7 inner step
    # count, and which one the fused loop's ROUND count per trajectory segment
    # ("inner_steps" for Catalyst's nested stages).
    fused_inner_steps: str | None = None
    fused_round_steps: str = "num_steps"
    deterministic: bool = False  # draws nothing; run_batch rejects multi-seed sweeps
    requires_x_star: bool = False  # problem.minimizer() is NOT the right reference point


_PROX_STATIC = {
    "num_steps": _REQUIRED,
    "prox_solver": "exact",
    "prox_steps": 50,
    "prox_tol": 1e-10,
    "channel": None,
}

ALGOS: dict[str, AlgoSpec] = {
    "sppm": AlgoSpec(
        SPPMParams, sppm_scan,
        defaults={"eta": _REQUIRED, "smoothness": 0.0},
        static=_PROX_STATIC, fusable=True, fused_inner_steps="prox_steps",
    ),
    "svrp": AlgoSpec(
        SVRPParams, svrp_scan,
        defaults={"eta": _REQUIRED, "p": _REQUIRED, "smoothness": 0.0},
        static=_PROX_STATIC, fusable=True, fused_inner_steps="prox_steps",
    ),
    "svrp_minibatch": AlgoSpec(
        MinibatchParams, svrp_minibatch_scan,
        defaults={"eta": _REQUIRED, "p": _REQUIRED, "smoothness": 0.0},
        static={**_PROX_STATIC, "batch_clients": _REQUIRED},
        fusable=True, fused_inner_steps="prox_steps",
    ),
    "catalyzed_svrp": AlgoSpec(
        CatalyzedSVRPParams, catalyzed_svrp_scan,
        defaults={
            "mu": _REQUIRED, "gamma": _REQUIRED, "eta": _REQUIRED,
            "p": _REQUIRED, "smoothness": 0.0,
        },
        static={
            "num_outer": _REQUIRED, "inner_steps": _REQUIRED,
            "prox_solver": "exact", "prox_steps": 50, "prox_tol": 1e-10,
            "channel": None,
        },
        fusable=True, fused_inner_steps="prox_steps",
        fused_round_steps="inner_steps",  # per-stage round count (nested loop)
    ),
    "sgd": AlgoSpec(
        SGDParams, sgd_scan,
        defaults={"stepsize": _REQUIRED},
        static={"num_steps": _REQUIRED},
    ),
    "svrg": AlgoSpec(
        SVRGParams, svrg_scan,
        defaults={"stepsize": _REQUIRED, "p": _REQUIRED},
        static={"num_steps": _REQUIRED},
    ),
    "scaffold": AlgoSpec(
        ScaffoldParams, scaffold_scan,
        defaults={"local_lr": _REQUIRED, "global_lr": 1.0},
        static={"num_rounds": _REQUIRED, "local_steps": _REQUIRED},
    ),
    "dane": AlgoSpec(
        DANEParams, dane_scan,
        defaults={"theta": _REQUIRED},
        static={"num_rounds": _REQUIRED, "surrogate_client": 0},
        deterministic=True,
    ),
    "acc_extragradient": AlgoSpec(
        AccEGParams, acc_extragradient_scan,
        defaults={"theta": _REQUIRED, "mu": _REQUIRED},
        static={"num_rounds": _REQUIRED, "surrogate_client": 0},
        deterministic=True,
    ),
    "composite": AlgoSpec(
        CompositeSVRPParams, composite_svrp_scan,
        defaults={
            "eta": _REQUIRED, "p": _REQUIRED,
            "smoothness": _REQUIRED, "mu": _REQUIRED,
        },
        static={"num_steps": _REQUIRED, "prox_R": _REQUIRED, "prox_steps": 80},
        requires_x_star=True,  # dist_sq must be measured to the COMPOSITE optimum
    ),
    "deep_svrp": AlgoSpec(
        DeepSVRPScanParams, deep_svrp_scan,
        defaults={"eta": _REQUIRED, "local_lr": _REQUIRED, "anchor_prob": _REQUIRED},
        static={"num_steps": _REQUIRED, "local_steps": 4, "channel": None},
        # its local solver IS Algorithm 7 (no prox_solver switch)
        fusable=True, fused_inner_steps="local_steps",
    ),
}


def horizon_rounds(cfg: Mapping[str, Any]) -> int:
    """The rounds a resolved static config runs, per Catalyst stage for
    Catalyst: the length of the draws' round axis."""
    for key in ("inner_steps", "num_steps", "num_rounds"):
        if key in cfg:
            return int(cfg[key])
    raise KeyError("static config names no round count")


def session_horizon(cfg: Mapping[str, Any]) -> int:
    """The total rounds a resolved static config prescribes (Catalyst's
    ``num_outer * inner_steps``): the horizon a session draws its record for
    at open and never steps past."""
    if "num_outer" in cfg:
        return int(cfg["num_outer"]) * int(cfg["inner_steps"])
    return horizon_rounds(cfg)


# ---------------------------------------------------------------- substrates
_SESSION_SUBSTRATES = ("sequential", "batched", "clients")


def check_substrate(substrate: str) -> str:
    """Validate a session-substrate name (the reference's error text)."""
    if substrate not in _SESSION_SUBSTRATES:
        raise ValueError(
            f"unknown substrate {substrate!r}; supported: "
            "'sequential', 'batched', 'clients'"
        )
    return substrate


# ------------------------------------------------------------ pool signatures
# Static-config keys that ONLY set the round horizon and never shape the round
# body: pool tenants may differ on these.  Catalyst's num_outer/inner_steps
# are not here: its step carries the stage structure.
_POOL_HORIZON_KEYS = frozenset({"num_steps", "num_rounds"})


def _tensor_signature(obj) -> tuple:
    """(name, shape, dtype) of the tensors a problem dataclass (or one tensor) holds."""
    if isinstance(obj, torch.Tensor):
        return ((None, tuple(obj.shape), str(obj.dtype)),)
    return tuple(
        (f.name, tuple(v.shape), str(v.dtype))
        for f in dataclasses.fields(obj)
        if isinstance(v := getattr(obj, f.name), torch.Tensor)
    )


def pool_entry_signature(
    algo: str, cfg: Mapping[str, Any], num_trials: int, problem, x0, x_star
) -> tuple:
    """The signature every tenant of one `serve.SessionPool` must share:
    algorithm, round-body static config (horizon-only keys excluded), trial
    count, and the problem type and tensor shapes / dtypes, x0's and
    x_star's.  Hyperparameters, seeds, horizons and `stop_eps` are absent:
    they vary freely per tenant (the reference's fields and error text)."""
    static = tuple((k, v) for k, v in sorted(cfg.items()) if k not in _POOL_HORIZON_KEYS)
    return (
        algo,
        static,
        int(num_trials),
        type(problem).__name__,
        _tensor_signature(problem),
        _tensor_signature(x0),
        _tensor_signature(x_star),
    )


_POOL_SIG_FIELDS = (
    "algo", "static config (horizon keys excluded)", "trial count",
    "problem structure", "problem leaf shapes/dtypes",
    "x0 shape/dtype", "x_star shape/dtype",
)


def check_pool_entry(expected: tuple, got: tuple) -> None:
    """Raise a field-by-field mismatch error if ``got`` cannot share the
    pool's binding with ``expected`` (the signature fixed by the first admit)."""
    if expected == got:
        return
    diffs = [
        f"  {name}: pool has {a!r}, tenant has {b!r}"
        for name, a, b in zip(_POOL_SIG_FIELDS, expected, got)
        if a != b
    ]
    raise ValueError(
        "tenant is not poolable with the sessions already admitted — every "
        "tenant shares ONE round binding, so algo, round-body static config "
        "and shapes must match (hyperparameters, seeds and horizons may "
        "differ):\n" + "\n".join(diffs)
    )


# ------------------------------------------------------------------- RunSpec
class ResolvedRun(NamedTuple):
    """A `RunSpec` bound to a problem: everything the substrates consume."""

    algo: str
    aspec: AlgoSpec
    hparams: dict[str, np.ndarray]  # host trial table, each (B,)
    seeds: np.ndarray  # (B,)
    cfg: dict[str, Any]  # full static config (defaults merged, validated)
    x0: torch.Tensor
    x_star: torch.Tensor

    def device_hparams(self, device):
        return self.aspec.params_cls(**_device_hparams(self.hparams, device))


@dataclass(frozen=True)
class RunSpec:
    """One sweep, independent of how it is executed (see the reference's
    `repro.experiments.spec.RunSpec`).  `static` carries the algorithm's
    static config (num_steps, prox_solver, ...)."""

    algo: str
    grid: Mapping[str, Any] | None = None
    seeds: int | Sequence[int] = 1
    x0: torch.Tensor | None = None
    x_star: torch.Tensor | None = None
    stepsize: str | None = None
    target_eps: float = 1e-6
    theory_constants: Any = None
    substrate: str | None = None
    static: Mapping[str, Any] = field(default_factory=dict)

    def resolve(self, problem) -> ResolvedRun:
        """Bind to a problem: trial table, static config, validation and
        x0/x_star defaults."""
        aspec = resolve_algo(self.algo)
        if self.substrate is not None:
            check_substrate(self.substrate)
        algo, grid, x0, x_star = self.algo, self.grid, self.x0, self.x_star
        if x0 is None:
            x0 = torch.zeros(problem.dim, dtype=_problem_dtype(problem), device=problem.device)
        if x_star is None:
            if aspec.requires_x_star:
                raise ValueError(
                    f"{algo}: pass x_star explicitly — problem.minimizer() is the "
                    "UNCONSTRAINED optimum, not this algorithm's reference point "
                    "(use e.g. composite_minimizer_pgd)"
                )
            if hasattr(problem, "privacy_spent"):
                raise ValueError(
                    f"{algo}: DP problems need an explicit x_star — "
                    "problem.minimizer() is the NOISED optimum; pass "
                    "problem.base_problem().minimizer() to measure utility "
                    "against the non-private solution, or problem.minimizer() "
                    "to measure convergence of the private objective"
                )
            x_star = problem.minimizer()
        if self.stepsize is not None:
            if self.stepsize != "theory":
                raise ValueError(
                    f"unknown stepsize mode {self.stepsize!r}; supported: 'theory' "
                    "(or pass explicit values in the grid)"
                )
            from repro_torch.core.theory import theory_grid

            # The caller's grid entries override the theorem-prescribed ones;
            # theory_constants (a measured ProblemConstants) skips the measurement.
            grid = {**theory_grid(algo, problem, eps=self.target_eps, x0=x0,
                                  x_star=x_star, constants=self.theory_constants),
                    **(grid or {})}
        hparams, seed_arr = _build_trials(aspec, algo, grid, self.seeds)
        cfg = _static_config(aspec, algo, self.static)
        if aspec.deterministic and np.unique(seed_arr).size > 1:
            raise ValueError(
                f"{algo} ignores the PRNG key; a multi-seed axis would run "
                "bit-identical duplicate trials. Pass seeds=1 (default)."
            )
        if "prox_solver" in cfg:
            get_prox_solver(cfg["prox_solver"], problem)
        if "channel" in cfg:
            get_channel(cfg["channel"])
        if cfg.get("prox_solver") == "gd":
            if "smoothness" not in aspec.params_cls._fields:
                raise ValueError(f"{algo} does not support prox_solver='gd'")
            if "smoothness" not in (grid or {}):
                raise ValueError(
                    f"{algo}: prox_solver='gd' needs 'smoothness' in the grid "
                    "(Algorithm 7's stepsize is 1/(L + 1/eta); L=0 silently diverges)"
                )
        return ResolvedRun(algo, aspec, hparams, seed_arr, cfg, x0, x_star)


def as_runspec(
    algo: str | RunSpec,
    *,
    grid: Mapping[str, Any] | None = None,
    seeds: int | Sequence[int] = 1,
    x0: torch.Tensor | None = None,
    x_star: torch.Tensor | None = None,
    stepsize: str | None = None,
    target_eps: float = 1e-6,
    theory_constants: Any = None,
    substrate: str | None = None,
    static: Mapping[str, Any] | None = None,
) -> RunSpec:
    """The legacy-kwargs shim: `run_batch("svrp", problem, grid=...,
    num_steps=...)` packs its keywords through here into a `RunSpec`; mixing a
    `RunSpec` with keyword run options is rejected."""
    if isinstance(algo, RunSpec):
        clashes = [
            name
            for name, val in (
                ("grid", grid), ("x0", x0), ("x_star", x_star),
                ("stepsize", stepsize), ("theory_constants", theory_constants),
                ("substrate", substrate),
            )
            if val is not None
        ]
        if seeds != 1:
            clashes.append("seeds")
        if target_eps != 1e-6:
            clashes.append("target_eps")
        if static:
            clashes.append("static config")
        if clashes:
            raise ValueError(
                f"got both a RunSpec and keyword run options {clashes}; "
                "put run options on the RunSpec itself"
            )
        return algo
    return RunSpec(
        algo=algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star,
        stepsize=stepsize, target_eps=target_eps,
        theory_constants=theory_constants, substrate=substrate,
        static=dict(static or {}),
    )


def resolve_algo(algo: str) -> AlgoSpec:
    if algo not in ALGOS:
        raise KeyError(f"unknown algo {algo!r}; available: {sorted(ALGOS)}")
    return ALGOS[algo]


def _build_trials(
    spec: AlgoSpec, algo: str, grid: Mapping[str, Any] | None, seeds
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    fields = list(spec.params_cls._fields)
    grid = dict(grid or {})
    unknown = set(grid) - set(fields)
    if unknown:
        raise ValueError(f"{algo}: unknown hparams {sorted(unknown)}; fields: {fields}")
    axes = {}
    for name in fields:  # field order fixes the cartesian-product nesting
        if name in grid:
            axes[name] = grid[name]
        elif spec.defaults[name] is _REQUIRED:
            raise ValueError(f"{algo}: grid must provide required hparam {name!r}")
        else:
            axes[name] = spec.defaults[name]
    return with_seeds(expand_grid(**axes), seeds)


def _static_config(spec: AlgoSpec, algo: str, overrides: Mapping[str, Any]) -> dict:
    unknown = set(overrides) - set(spec.static)
    if unknown:
        raise ValueError(
            f"{algo}: unknown static config {sorted(unknown)}; accepts: {sorted(spec.static)}"
        )
    cfg = {**spec.static, **overrides}
    missing = [k for k, v in cfg.items() if v is _REQUIRED]
    if missing:
        raise ValueError(f"{algo}: missing required static config {missing}")
    return cfg


def _problem_dtype(problem):
    """The dtype the problem's own arrays carry (quadratic A / logistic Z)."""
    for attr in ("A", "Z"):
        if hasattr(problem, attr):
            return getattr(problem, attr).dtype
    return None


def _device_hparams(hparams: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Host grid arrays -> (B,) device tensors (float64 / int64 kept exact)."""
    return {k: torch.as_tensor(v, device=device) for k, v in hparams.items()}
