"""A world of gloo ranks on the CPU for the port's client-sharded tests.

`run_world(cases, inputs, world, tmp)` spawns ``world`` processes (gloo,
a file store under ``tmp``, a timeout on the group and on the join), and
each rank runs every case of ``cases`` through `repro_torch` and writes its
results as numpy arrays; the parent gets ``[rank 0's results, rank 1's,
...]``.  The ranks import `repro_torch` and numpy only, never JAX or
`repro`: the parent computes the reference's side.

A case is a dict: ``problem`` (a key of ``inputs``: the arrays
`convert.problem_from_arrays` takes, under ``kind``), ``algo``, ``kw``
(`run_batch`'s keywords), ``draws`` (numpy ``(clients, coins)`` or None),
``shard`` ("data" / "clients"), ``session`` (chunk sizes to step a
``substrate="clients"`` session by, in place of `run_batch`), ``prox_R``
(composite's regularizer: an l2-ball radius) and ``unsharded`` (rank 0 also
runs the case without ``shard=``).  Each rank records the sweep's
``dist_sq`` / ``comm`` / ``x_final``, the `all_reduce` calls it made and
the rounds whose host refresh mask is set.
"""
from __future__ import annotations

import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _problem(inputs, key, cache):
    from repro_torch.convert import problem_from_arrays

    if key not in cache:
        spec = inputs[key]
        cache[key] = problem_from_arrays(spec["kind"], spec, device="cpu")
    return cache[key]


def _kwargs(case):
    from repro_torch.core import Draws
    from repro_torch.core.composite import prox_l2ball

    kw = dict(case["kw"], device="cpu")
    if case.get("draws") is not None:
        clients, coins = case["draws"]
        kw["draws"] = Draws(None if clients is None else torch.tensor(clients, dtype=torch.int64),
                            None if coins is None else torch.tensor(coins, dtype=torch.bool))
    if "x_star" in kw:
        kw["x_star"] = torch.tensor(kw["x_star"], dtype=torch.float64)
    if case.get("prox_R") is not None:
        kw["prox_R"] = prox_l2ball(case["prox_R"])
    return kw


def _arrays(res) -> dict:
    return {f: getattr(res, f).numpy() for f in ("dist_sq", "comm", "x_final")}


def _run_case(case, problem) -> dict:
    from repro_torch.experiments import run_batch
    from repro_torch.launch.mesh import all_reduce
    from repro_torch.serve import open_session

    kw = _kwargs(case)
    before = all_reduce.all_reduces
    if case.get("session"):
        sess = open_session(case["algo"], problem, substrate="clients", **kw)
        for n in case["session"]:
            sess.step(n)
        out = _arrays(sess.result())
        out["refresh_rounds"] = None
    else:
        res = run_batch(case["algo"], problem, shard=case["shard"], **kw)
        out = _arrays(res)
    out["all_reduces"] = all_reduce.all_reduces - before
    if case.get("session"):
        out["run_batch"] = _arrays(run_batch(case["algo"], problem, shard="clients", **kw))
    elif kw.get("draws") is not None and kw["draws"].refresh is not None:
        out["refresh_rounds"] = int(np.sum(kw["draws"].refresh))
    return out


def _rank_main(rank, world, init, case_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(case_path, "rb") as f:
            cases, inputs = pickle.load(f)
        from repro_torch.experiments import run_batch

        problems, results = {}, {}
        for name, case in cases.items():
            problem = _problem(inputs, case["problem"], problems)
            results[name] = _run_case(case, problem)
            if rank == 0 and case.get("unsharded"):
                results[name]["unsharded"] = _arrays(run_batch(case["algo"], problem,
                                                               **_kwargs(case)))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_world(cases: dict, inputs: dict, world: int, tmp: str):
    """Start the ranks; returns a function that joins them (within the
    timeout, failing on any rank's failure) and returns their results."""
    case_path = os.path.join(tmp, "cases.pkl")
    with open(case_path, "wb") as f:
        pickle.dump((cases, inputs), f)
    init = "file://" + os.path.join(tmp, "store")
    ctx = mp.start_processes(_rank_main, args=(world, init, case_path, tmp), nprocs=world,
                             join=False, start_method="spawn")

    def join():
        end = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
                if time.monotonic() >= end:
                    raise TimeoutError(f"the {world} ranks did not finish within {TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    return join
