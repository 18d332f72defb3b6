#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100, the CUDA toolkit
(`nvcc`) and PyTorch built for CUDA.  It imports nothing of JAX or `repro`.
Phases, each printed as one JSON line:

1. device  — `nvidia-smi` name and power limit, torch/CUDA versions, and the
   build of every kernel from `src/repro_torch/kernels/csrc` (one `nvcc` per
   source, all started together) with its ptxas report;
2. parity  — each kernel against its plain PyTorch version on the card at the
   main path's shapes, float32 and float64, at the reference's tolerances,
   and timed with CUDA events beside its bound;
3. main path — `run_batch(..., fused=True, prox_solver="gd")` in float64 on
   the paper's Figure-1 quadratic (M = 1000, d = 40, L = 3330, delta = 10):
   svrp, catalyzed_svrp, svrp_minibatch; and on the Figure-2 a9a-like logistic
   problem (M = 60, n = 2000, d = 123, lambda = 0.1): svrp.  The launch counts
   are zeroed just before and read just after; every kernel must have run.
   Each sweep's first 20 rounds are later replayed on the CPU (plain
   versions) with the same injected draws: comm must be equal and dist_sq
   within rtol 1e-9;
4. profile — the first 20 rounds of each sweep again under torch.profiler:
   host wall time, device busy time and idle share, the top kernels;
5. the `kernels` line, then the `ok` line.

Any failed check exits non-zero before the `ok` line.  Without CUDA, or
without the repository beside it, the script exits 1 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # H100 SXM, outside the tensor cores
K1_TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "float64": dict(rtol=1e-12, atol=0.0)}
K2_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-12, atol=1e-13)}
CPU_REPLAY_ROUNDS = 20
CPU_REPLAY_RTOL = 1e-9


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_times_us(prof) -> dict[str, tuple[float, int]]:
    """Device time (us) and launch count of every kernel in a profiler trace."""
    import torch

    out: dict[str, tuple[float, int]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = out.get(e.name, (0.0, 0))
            out[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    return out


def profiled(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler: (host wall ms, kernel times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, kernel_times_us(prof)


def device_ms(fn, reps: int) -> float | None:
    """Device time per call of ``fn``: every kernel it launches, summed
    (profiler); None when the profiler saw no device activity."""
    _, kernels = profiled(fn, reps)
    if not kernels:
        return None
    return sum(t for t, _ in kernels.values()) / reps / 1e3


# --------------------------------------------------------------- problems
def fig1_quadratic(device):
    from repro_torch.problems import make_synthetic_quadratic

    return make_synthetic_quadratic(1000, 40, mu=1.0, L=3330.0, delta=10.0, seed=0, device=device)


def fig2_logistic(device):
    from repro_torch.problems import make_a9a_like_problem

    return make_a9a_like_problem(60, n_per_client=2000, lam=0.1, n_pool=32561, seed=0, device=device)


def sweeps(qprob, lprob, l_star):
    """The main path's sweeps: (label, problem kind, run_batch kwargs)."""
    from repro_torch.core import theorem2_stepsize, theorem3_gamma

    M = qprob.num_clients
    mu, delta = float(qprob.strong_convexity()), float(qprob.similarity())
    L = float(qprob.smoothness_max())
    eta = theorem2_stepsize(mu, delta)
    gamma = max(theorem3_gamma(mu, delta, M), 1.0)
    eta_in = theorem2_stepsize(mu + gamma, delta)
    lmu, lL = float(lprob.strong_convexity()), float(lprob.smoothness_max())
    leta = theorem2_stepsize(lmu, float(lprob.similarity_at(l_star)))
    gd = dict(fused=True, prox_solver="gd", seeds=8)
    return [
        ("svrp/fig1_quadratic", "quadratic", dict(
            algo="svrp", grid={"eta": [eta, eta / 2], "p": 1.0 / M, "smoothness": L},
            num_steps=400, prox_steps=200, **gd)),
        ("svrp/fig2_logistic", "logistic", dict(
            algo="svrp", grid={"eta": [leta, leta / 2], "p": 1.0 / lprob.num_clients,
                               "smoothness": lL},
            num_steps=300, prox_steps=20, **gd)),
        ("catalyzed_svrp/fig1_quadratic", "quadratic", dict(
            algo="catalyzed_svrp",
            grid={"mu": mu, "gamma": gamma, "eta": eta_in, "p": 1.0 / M, "smoothness": L + gamma},
            num_outer=3, inner_steps=60, prox_steps=200, **gd)),
        ("svrp_minibatch/fig1_quadratic", "quadratic", dict(
            algo="svrp_minibatch", grid={"eta": [eta, eta / 2], "p": 1.0 / M, "smoothness": L},
            num_steps=150, batch_clients=4, prox_steps=200, **gd)),
    ]


def sweep_draws(kw, M: int):
    """Native draws for a sweep (seed-major trials, as `with_seeds` orders them)."""
    import numpy as np

    from repro_torch.core import draw_schedule
    from repro_torch.experiments.grid import grid_size

    seeds = np.repeat(np.arange(kw["seeds"]), grid_size(kw["grid"]))
    p = kw["grid"].get("p")
    if kw["algo"] == "catalyzed_svrp":
        return draw_schedule(seeds, M, kw["inner_steps"], p, num_outer=kw["num_outer"])
    return draw_schedule(seeds, M, kw["num_steps"], p, batch_clients=kw.get("batch_clients"))


def replay_head(kw, draws):
    """The sweep and draws cut to the first CPU_REPLAY_ROUNDS rounds."""
    from repro_torch.core import Draws

    k = CPU_REPLAY_ROUNDS
    kw = dict(kw)
    if kw["algo"] == "catalyzed_svrp":
        kw.update(num_outer=1, inner_steps=k)
        return kw, Draws(draws.clients[:1, :k].cpu(), draws.coins[:1, :k].cpu())
    kw["num_steps"] = k
    coins = None if draws.coins is None else draws.coins[:k].cpu()
    return kw, Draws(draws.clients[:k].cpu(), coins)


# ----------------------------------------------------------------- phases
def phase_device() -> dict:
    import torch

    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in reports.items()
    }
    info = {
        "phase": "device", "nvidia_smi": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernel_build_s": build_s, "ptxas": ptxas,
    }
    emit(info)
    return info


def phase_parity(qprob, lprob) -> dict:
    """Kernel vs plain version on the card at the main path's shapes."""
    import torch

    from repro_torch.kernels.logistic_prox import (
        logistic_prox_gd_batched, logistic_prox_gd_batched_plain,
    )
    from repro_torch.kernels.prox_update import prox_update_batched, prox_update_batched_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()

        # K1 at the Figure-1 svrp shape: R = 16 trials, d = 40.
        R, d = 16, qprob.dim
        y, g, z = (torch.randn(R, d, generator=gen, device="cuda", dtype=dtype) for _ in range(3))
        lr = torch.rand(R, generator=gen, device="cuda", dtype=dtype) * 1e-3
        ie = 100.0 + torch.rand(R, generator=gen, device="cuda", dtype=dtype) * 100.0
        out = prox_update_batched(y, g, z, lr, ie)
        ref = prox_update_batched_plain(y, g, z, lr, ie)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **K1_TOL[dname])
        b_ms, b_by = bound_ms((4 * R * d + 2 * R) * isz, 5 * R * d, dname)
        results[("prox_update_batched", dname)] = dict(
            shape=[R, d], max_abs_err=(out - ref).abs().max().item(),
            ms=time_ms(lambda: prox_update_batched(y, g, z, lr, ie), 500),
            plain_ms=time_ms(lambda: prox_update_batched_plain(y, g, z, lr, ie), 500),
            device_ms=device_ms(lambda: prox_update_batched(y, g, z, lr, ie), 100),
            plain_device_ms=device_ms(lambda: prox_update_batched_plain(y, g, z, lr, ie), 100),
            bound_ms=b_ms, bound_by=b_by, tol=K1_TOL[dname],
        )

        # K2 at the Figure-2 svrp shape: R = 16 sampled clients' label-signed rows.
        steps = 20
        m = torch.randint(0, lprob.num_clients, (16,), generator=gen, device="cuda")
        A = (lprob.Z[m] * lprob.y[m][:, :, None]).to(dtype)
        R, n, d = A.shape
        zz = torch.randn(R, d, generator=gen, device="cuda", dtype=dtype) * 0.3
        eta = 0.5 + torch.rand(R, generator=gen, device="cuda", dtype=dtype)
        beta = 1.0 / (float(lprob.smoothness_max()) + 1.0 / eta)
        out = logistic_prox_gd_batched(A, zz, beta, 1.0 / eta, lprob.lam, steps)
        ref = logistic_prox_gd_batched_plain(A, zz, beta, 1.0 / eta, lprob.lam, steps)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **K2_TOL[dname])
        flops = steps * R * (4 * n * d + 4 * n + 7 * d)
        b_ms, b_by = bound_ms((R * n * d + 2 * R * d + 2 * R) * isz, flops, dname)
        inv_eta = 1.0 / eta

        def k2():
            return logistic_prox_gd_batched(A, zz, beta, inv_eta, lprob.lam, steps)

        def k2_plain():
            return logistic_prox_gd_batched_plain(A, zz, beta, inv_eta, lprob.lam, steps)

        results[("logistic_prox_gd_batched", dname)] = dict(
            shape=[R, n, d, steps], max_abs_err=(out - ref).abs().max().item(),
            ms=time_ms(k2, 20), plain_ms=time_ms(k2_plain, 20),
            device_ms=device_ms(k2, 5), plain_device_ms=device_ms(k2_plain, 5),
            bound_ms=b_ms, bound_by=b_by, tol=K2_TOL[dname],
        )
    emit({"phase": "parity", "library_ms": None,
          "library_note": "no single PyTorch call computes either function",
          "kernels": [{"name": k, "dtype": dt, **v} for (k, dt), v in results.items()]})
    return results


def phase_main_path(qprob, lprob, l_star) -> tuple[dict, list]:
    """Drive every sweep on the card; the launch counts cover exactly these runs."""
    import numpy as np
    import torch

    from repro_torch.experiments import run_batch
    from repro_torch.kernels.logistic_prox import logistic_prox_gd_batched
    from repro_torch.kernels.prox_update import prox_update_batched

    plan = sweeps(qprob, lprob, l_star)
    runs = []
    prox_update_batched.launches = 0
    logistic_prox_gd_batched.launches = 0
    for label, kind, kw in plan:
        problem = qprob if kind == "quadratic" else lprob
        x_star = problem.minimizer() if kind == "quadratic" else l_star
        draws = sweep_draws(kw, problem.num_clients)
        k1, k2 = prox_update_batched.launches, logistic_prox_gd_batched.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_batch(kw["algo"], problem, x_star=x_star, draws=draws,
                        **{k: v for k, v in kw.items() if k != "algo"})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d2 = res.dist_sq.cpu().numpy()
        rounds = d2.shape[1]
        r0 = float(((torch.zeros_like(x_star) - x_star) ** 2).sum())
        check(np.isfinite(d2).all(), f"{label}: non-finite dist_sq")
        check(d2.shape == (res.num_trials, rounds) and res.x_final.shape[-1] == problem.dim,
              f"{label}: unexpected result shapes")
        final = float(np.median(d2[:, -1]))
        check(0 < final < r0,
              f"{label}: median final dist_sq {final} not in (0, ||x0 - x*||^2 = {r0})")
        launched = {"prox_update_batched": prox_update_batched.launches - k1,
                    "logistic_prox_gd_batched": logistic_prox_gd_batched.launches - k2}
        info = {
            "phase": "main_path", "sweep": label, "trials": res.num_trials, "rounds": rounds,
            "wall_s": wall, "rounds_per_s": rounds / wall, "dist_sq_initial": r0,
            "dist_sq_final_median": final,
            "comm_final_median": float(np.median(res.comm.cpu().numpy()[:, -1])),
            "launches": launched,
        }
        emit(info)
        # Catalyst takes the elementwise kernel on every problem (the reference's form).
        uses_k2 = kind == "logistic" and kw["algo"] != "catalyzed_svrp"
        kernel = "logistic_prox_gd_batched" if uses_k2 else "prox_update_batched"
        check(launched[kernel] > 0 and info["rounds_per_s"] > 0,
              f"{label}: {kernel} was never launched")
        runs.append((label, kind, problem, kw, draws, x_star, res))
    launches = {"prox_update_batched": prox_update_batched.launches,
                "logistic_prox_gd_batched": logistic_prox_gd_batched.launches}
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")
    return launches, runs


def phase_profile(runs) -> None:
    """Where a round's time goes: the first rounds of each sweep again under
    torch.profiler, with the host wall time, the device's busy and idle
    share, and the kernels that take the most device time."""
    from repro_torch.experiments import run_batch

    for label, _, problem, kw, draws, x_star, _ in runs:
        kw_h, draws_h = replay_head(kw, draws)
        draws_h = draws_h.to(x_star.device)

        def run():
            return run_batch(kw_h["algo"], problem, x_star=x_star, draws=draws_h,
                             **{k: v for k, v in kw_h.items() if k != "algo"})

        wall_ms, kernels = profiled(run, 1)
        # None = not measured: the profiler saw no device activity.
        busy_ms = sum(t for t, _ in kernels.values()) / 1e3 if kernels else None
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        emit({"phase": "profile", "sweep": label, "rounds": CPU_REPLAY_ROUNDS,
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
              "kernel_launches": sum(c for _, c in kernels.values()),
              "top_kernels": [{"name": name[:80], "device_ms": t / 1e3, "count": c}
                              for name, (t, c) in top]})


def phase_cpu_replay(runs, cpu_problems) -> None:
    """The first rounds of every sweep again on the CPU (plain versions)."""
    import numpy as np

    from repro_torch.experiments import run_batch

    for label, kind, _, kw, draws, x_star, res in runs:
        kw_c, draws_c = replay_head(kw, draws)
        t0 = time.perf_counter()
        res_c = run_batch(kw_c["algo"], cpu_problems[kind], x_star=x_star.cpu(), draws=draws_c,
                          device="cpu", **{k: v for k, v in kw_c.items() if k != "algo"})
        k = CPU_REPLAY_ROUNDS
        gpu_d2 = res.dist_sq[:, :k].cpu().numpy()
        cpu_d2 = res_c.dist_sq.numpy()
        check(res_c.comm.dtype == res.comm.dtype, f"{label}: comm dtype differs from the CPU run")
        check(np.array_equal(res.comm[:, :k].cpu().numpy(), res_c.comm.numpy()),
              f"{label}: comm differs from the CPU run")
        rel = float(np.max(np.abs(gpu_d2 - cpu_d2) / np.abs(cpu_d2)))
        check(rel <= CPU_REPLAY_RTOL, f"{label}: dist_sq differs from the CPU run by rtol {rel}")
        emit({"phase": "cpu_replay", "sweep": label, "rounds": k, "comm_equal": True,
              "dist_sq_max_rel_diff": rel, "rtol": CPU_REPLAY_RTOL,
              "cpu_s": time.perf_counter() - t0})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'}: {e}", file=sys.stderr)
        return 1
    from repro_torch.device import full_precision_matmul

    full_precision_matmul()
    try:
        phase_device()
        qprob, lprob = fig1_quadratic("cuda"), fig2_logistic("cuda")
        l_star = lprob.minimizer()
        parity = phase_parity(qprob, lprob)
        launches, runs = phase_main_path(qprob, lprob, l_star)
        phase_profile(runs)
        phase_cpu_replay(runs, {"quadratic": fig1_quadratic("cpu"), "logistic": fig2_logistic("cpu")})
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    sources = {
        "prox_update_batched": ("src/repro_torch/kernels/csrc/prox_update.cu",
                                "src/repro/kernels/prox_update.py:91"),
        "logistic_prox_gd_batched": ("src/repro_torch/kernels/csrc/logistic_prox.cu",
                                     "src/repro/kernels/logistic_prox.py:64"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        p = parity[(name, "float64")]  # the main path runs in float64
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": p["max_abs_err"], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
