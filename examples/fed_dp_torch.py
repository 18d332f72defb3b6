"""DP-ERM end to end on the PyTorch port: the paper's headline application.

Builds the a9a-style logistic problem, privatizes it (row clipping and a
per-client Gaussian objective perturbation), runs a multi-seed SVRP sweep at
the theorem-prescribed stepsize through `run_batch`, and prints what the
accountant, the similarity bound and the theory table say about the run:

* the zCDP accountant's (eps, delta) for the round schedule,
* the clip-composed O(1/sqrt(n)) similarity bound beside the measured delta,
* the theory table's predicted communication beside the engine's measurement.

    PYTHONPATH=src python examples/fed_dp_torch.py               # on the GPU
    PYTHONPATH=src python examples/fed_dp_torch.py --device cpu

The twin of `examples/fed_dp.py` on `repro_torch`.  The features are the
reference's (the same numpy generator); the noise table and the draws come
from `torch.Generator`s, so the numbers are those of another sample.
"""
import argparse

import numpy as np

from repro_torch.core import measure_constants, predict_comm_for
from repro_torch.experiments import run_batch
from repro_torch.problems import make_dp_a9a_problem

M = 10
NUM_STEPS = 400
SEEDS = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = {}
    for sigma in (1.0, 4.0):
        prob = make_dp_a9a_problem(M, sigma=sigma, clip=1.0, n_per_client=200, n_pool=2000,
                                   lam=0.1, device=args.device)
        x_star = prob.base_problem().minimizer()  # the NON-private comparator
        consts = measure_constants(prob, x_star=x_star)

        res = run_batch(
            "svrp", prob, stepsize="theory", theory_constants=consts,
            seeds=SEEDS, num_steps=NUM_STEPS,
            prox_solver="newton-cg", x_star=x_star, device=args.device,
        )
        p = float(res.hparams["p"][0])
        eps, delta_dp = prob.privacy_spent(NUM_STEPS, p)
        final = float(np.median(res.dist_sq.cpu().numpy()[:, -1]))
        eps_opt = 2.0 * final  # a reachable target for the comm comparison
        measured_comm = float(np.median(res.comm_to_accuracy(eps_opt)))
        predicted_comm = predict_comm_for(prob, "svrp", eps=eps_opt, constants=consts)

        print(f"sigma={sigma:g}:")
        print(f"  privacy:    ({eps:.2f}, {delta_dp:g})-DP after {NUM_STEPS} rounds at p={p:.2f}")
        print(f"  similarity: measured delta={consts.delta:.4f}  "
              f"clip-composed bound={prob.similarity_bound():.4f}")
        print(f"  utility:    median final dist to non-private optimum = {final:.3e}")
        print(f"  comm to {eps_opt:.1e}: measured {measured_comm:.0f}, "
              f"theory bound {predicted_comm:.0f}")
        out[sigma] = dict(eps=eps, delta=consts.delta, bound=prob.similarity_bound(),
                          final=final, measured_comm=measured_comm,
                          predicted_comm=predicted_comm)
    return out


if __name__ == "__main__":
    main()
