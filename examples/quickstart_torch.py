"""Quickstart on the PyTorch port: SVRP vs SGD/SVRG on a synthetic federated quadratic.

    PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch on the CPU

The twin of `examples/quickstart.py` on `repro_torch`: the same problem,
stepsizes and horizons, and the same table.  With high second-order
similarity (delta << L), SVRP reaches machine precision in a fraction of the
communication any L-dependent method needs.  It runs on CUDA unless
``--device`` names another device, and raises when there is no card.
"""
import argparse

import torch

from repro_torch.core import run_sgd, run_svrg, run_svrp, theorem2_stepsize
from repro_torch.problems import make_synthetic_quadratic

M, DIM = 100, 30
HORIZONS = {"SVRP": 4000, "SVRG": 40_000, "SGD": 40_000}
EPS = 1e-10


def make_problem(device=None):
    """The quickstart's federated quadratic on ``device`` (default CUDA)."""
    return make_synthetic_quadratic(num_clients=M, dim=DIM, mu=1.0, L=2000.0, delta=8.0,
                                    seed=0, device=device)


def drivers(prob, horizons=HORIZONS, seed: int = 0, draws=None) -> dict:
    """{name: a call that runs that method} on ``prob``, at the paper's
    stepsizes.  Each run draws from ``seed``, or reads ``draws[name]`` (a
    per-trial `Draws` record) where given."""
    draws = draws or {}
    mu = float(prob.strong_convexity())
    delta = float(prob.similarity())
    L = float(prob.smoothness_max())
    x_star = prob.minimizer()
    x0 = torch.zeros(DIM, dtype=x_star.dtype, device=x_star.device)
    kw = dict(seed=seed, device=x_star.device)
    return {
        "SVRP": lambda: run_svrp(prob, x0, x_star, eta=theorem2_stepsize(mu, delta), p=1 / M,
                                 num_steps=horizons["SVRP"], draws=draws.get("SVRP"), **kw),
        "SVRG": lambda: run_svrg(prob, x0, x_star, stepsize=1 / (6 * L), p=1 / M,
                                 num_steps=horizons["SVRG"], draws=draws.get("SVRG"), **kw),
        "SGD": lambda: run_sgd(prob, x0, x_star, stepsize=1 / (2 * L),
                               num_steps=horizons["SGD"], draws=draws.get("SGD"), **kw),
    }


def run(device=None, horizons=HORIZONS, seed: int = 0, draws=None) -> dict:
    """The three runs on ``device``: {name: RunResult}."""
    prob = make_problem(device)
    return {name: fn() for name, fn in drivers(prob, horizons, seed, draws).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    prob = make_problem(args.device)
    mu = float(prob.strong_convexity())
    delta = float(prob.similarity())
    L = float(prob.smoothness_max())
    print(f"problem: M={M} d={DIM}  mu={mu:.2f}  delta={delta:.2f}  L={L:.0f}")
    print(f"SVRP's favourable regime: delta={delta:.1f} << sqrt(L*mu)={(L * mu) ** 0.5:.1f}\n")
    print(f"{'method':12s} {'final dist^2':>14s} {'comm to 1e-10':>14s}")
    for name, fn in drivers(prob).items():
        res = fn()
        c = float(res.comm_to_accuracy(EPS))
        c_str = f"{int(c)}" if c == c and c != float("inf") else "never"
        print(f"{name:12s} {float(res.dist_sq[-1]):14.2e} {c_str:>14s}")


if __name__ == "__main__":
    main()
