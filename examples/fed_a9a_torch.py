"""The paper's real-data experiments on a9a-style data, on the PyTorch port:
ridge regression (Fig. 1 bottom row) and l2-regularized logistic regression
(Section 9), each method a multi-seed `run_batch` sweep.

    PYTHONPATH=src python examples/fed_a9a_torch.py --clients 20 --seeds 3
    PYTHONPATH=src python examples/fed_a9a_torch.py --device cpu

The twin of `examples/fed_a9a.py` on `repro_torch`: the same data (the a9a
generator is the reference's numpy code, so one seed gives the same
features), stepsizes, budgets and table.  Clients subsample a pool with
a9a's published statistics (123 binary features, ~14 nonzeros a row) i.i.d.,
which is what makes delta small (Section 9).  The ridge track solves each
prox by the spectral solver, the logistic track by guarded Newton.  The
draws are the port's own (`core.draws.draw_schedule`), so the medians are
those of other samples than the reference's.  Runs on CUDA unless
``--device`` names another device.
"""
import argparse

import torch

from repro_torch.core import theorem2_stepsize
from repro_torch.experiments import run_batch
from repro_torch.problems import make_a9a_like_problem, make_ridge_problem


def _report(title: str, runs: dict, budget: int) -> None:
    print(f"\n{title}")
    print(f"{'method':10s} {'median dist^2 @ comm budget':>28s}")
    for name, res in runs.items():
        print(f"{name:10s} {res.final_at_budget(budget):28.3e}")


def run_panel(prob, *, budget: int, seeds: int, prox_solver: str, label: str, device=None):
    mu = float(prob.strong_convexity())
    L = float(prob.smoothness_max())
    M = prob.num_clients
    x_star = prob.minimizer()
    if hasattr(prob, "similarity"):
        delta = float(prob.similarity())
    else:
        delta = float(prob.similarity_at(x_star))  # measured at x_* (logistic)
    print(f"{label}: M={M}  measured L={L:.2f}  delta={delta:.3f}  mu={mu:.2f}")

    common = dict(x0=torch.zeros(prob.dim, dtype=x_star.dtype, device=x_star.device),
                  x_star=x_star, seeds=seeds, device=device)
    runs = {
        "svrp": run_batch(
            "svrp", prob, grid={"eta": theorem2_stepsize(mu, delta), "p": 1 / M},
            num_steps=budget // 5, prox_solver=prox_solver, **common,
        ),
        "svrg": run_batch(
            "svrg", prob, grid={"stepsize": 1 / (6 * L), "p": 1 / M},
            num_steps=budget // 5, **common,
        ),
        "scaffold": run_batch(
            "scaffold", prob, grid={"local_lr": 1 / (4 * L), "global_lr": 1.0},
            local_steps=5, num_rounds=budget // 2, **common,
        ),
    }
    _report(label, runs, budget)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    # Defaults are sized for a ~1-minute demo; the paper's setup is
    # --comm-budget 10000 --n-per-client 2000.
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--comm-budget", type=int, default=5000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--n-per-client", type=int, default=500)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    lp = make_a9a_like_problem(num_clients=args.clients, n_per_client=args.n_per_client,
                               n_pool=8000, lam=0.1, seed=0, device=args.device)

    # Track 1 — ridge regression on the a9a features (quadratic: spectral prox).
    ridge = make_ridge_problem(lp.Z.cpu().numpy(), lp.y.cpu().numpy(), lam=0.1,
                               device=args.device)
    panels = {"ridge": run_panel(ridge, budget=args.comm_budget, seeds=args.seeds,
                                 prox_solver="spectral", label="a9a-like ridge",
                                 device=args.device)}

    # Track 2 — the actual logistic problem (non-quadratic: guarded Newton prox).
    panels["logistic"] = run_panel(lp, budget=args.comm_budget, seeds=args.seeds,
                                   prox_solver="newton", label="a9a-like logistic",
                                   device=args.device)
    return panels


if __name__ == "__main__":
    main()
