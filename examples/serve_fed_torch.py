"""Streaming federated round server on the PyTorch port.

    PYTHONPATH=src python examples/serve_fed_torch.py                 # on the GPU
    PYTHONPATH=src python examples/serve_fed_torch.py --quick         # small and short
    PYTHONPATH=src python examples/serve_fed_torch.py --pool          # multi-tenant
    PYTHONPATH=src python examples/serve_fed_torch.py --device cpu    # plain PyTorch

The twin of `examples/serve_fed.py` on `repro_torch.serve`.  Clients churn
on a `ClientStream`; each round's client (or cohort) is drawn from the
clients resident when it starts, on the host from the server's generator;
SVRP rounds run continuously with `pipeline_depth` rounds queued ahead of
the stats readback.  The round is the registry binding the batch engine
runs (`core.rounds.registry_step_def`).

`--pool` serves several federations at once through `SessionPool`: tenants
with distinct problems, hyperparameters and horizons, their svrp lanes
stacked into one lane batch a tick, driven by `FedRoundServer(pool=...)`;
tenants whose horizon runs out freeze mid-run while the rest keep serving.
It runs on CUDA unless ``--device`` names another device, and raises when
there is no card.
"""
import argparse

import numpy as np

from repro_torch.core import theorem2_stepsize
from repro_torch.problems import make_synthetic_quadratic
from repro_torch.serve import ClientStream, FedRoundServer, SessionPool


def run_stream(args) -> None:
    M = args.clients or (10 if args.quick else 32)
    rounds = args.rounds or (120 if args.quick else 600)
    prob = make_synthetic_quadratic(num_clients=M, dim=8, mu=1.0, L=80.0, delta=4.0, seed=1,
                                    device=args.device)
    eta = theorem2_stepsize(1.0, float(prob.similarity()))
    hparams = {"svrp": {"eta": eta, "p": 0.2},
               "sppm": {"eta": 0.05},
               "svrp_minibatch": {"eta": 3 * eta, "p": 0.25}}[args.algo]
    extra = {"batch_clients": max(2, M // 4)} if args.algo == "svrp_minibatch" else {}
    stream = ClientStream(M, churn=args.churn, seed=args.seed + 1)
    srv = FedRoundServer(args.algo, prob, hparams=hparams, stream=stream, seed=args.seed,
                         device=args.device, **extra)
    print(f"serving {args.algo}: {M} clients, churn={args.churn}, "
          f"{rounds} continuous rounds ...")
    stats = srv.run(rounds)
    print(stats.report())
    s = stats.summary()
    assert s["rounds"] == rounds
    assert s["p95_ms"] == s["p95_ms"], "latency percentiles must be populated"


def run_pool(args) -> None:
    M = args.clients or (10 if args.quick else 32)
    rounds = args.rounds or (60 if args.quick else 400)
    P = 4 if args.quick else 8
    pool = SessionPool(capacity=P)
    tenants = []  # (tenant id, horizon)
    for i in range(P):
        prob = make_synthetic_quadratic(num_clients=M, dim=8, mu=1.0, L=80.0, delta=4.0,
                                        seed=args.seed + i + 1, device=args.device)
        eta = theorem2_stepsize(1.0, float(prob.similarity()))
        # Mixed horizons: odd tenants run out halfway and freeze while even
        # tenants keep serving.
        horizon = rounds if i % 2 == 0 else max(2, rounds // 2)
        tid = pool.admit("svrp", prob, grid={"eta": eta, "p": 0.2}, seeds=2, num_steps=horizon,
                         device=args.device)
        tenants.append((tid, horizon))
    srv = FedRoundServer(pool=pool)
    print(f"serving {P} pooled svrp tenants ({M} clients each, mixed horizons, "
          f"{'one lane batch' if pool.stacked else 'tenant by tenant'} a tick), "
          f"up to {rounds} ticks ...")
    stats = srv.run(rounds)
    print(stats.report())
    elapsed = stats.elapsed_s[-1]
    agg = pool.total_rounds / elapsed if elapsed > 0 else float("inf")
    print(f"aggregate: {pool.total_rounds} tenant-rounds in {elapsed:.2f}s = {agg:.0f} "
          f"rounds/sec across the pool ({stats.summary()['rounds_per_sec']:.0f} ticks/sec)")
    print("| tenant | horizon | rounds served | final median dist^2 |")
    print("|---:|---:|---:|---:|")
    for tid, horizon in tenants:
        ses = pool.session(tid)
        d2 = ses.dist_sq.cpu().numpy()
        final = float(np.median(d2[:, -1]))
        print(f"| {tid} | {horizon} | {ses.t} | {final:.3e} |")
        assert ses.t == horizon, (tid, ses.t, horizon)
        assert final < float(np.median(d2[:, 0]))
    assert pool.freeze_exhausted(1) == 0, "no tenant should have rounds left"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small population, few rounds")
    ap.add_argument("--pool", action="store_true", help="multi-tenant SessionPool serving")
    ap.add_argument("--algo", choices=["svrp", "sppm", "svrp_minibatch"], default="svrp")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--churn", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args()
    if args.pool:
        run_pool(args)
    else:
        run_stream(args)


if __name__ == "__main__":
    main()
