"""Streaming run statistics for the federated round server.

Port of `repro.serve.stats` (numpy and the host clock).  `ServeStats`
accumulates one record per completed round — wall-clock latency, elapsed
time since the run started, the server's dist-to-opt and cumulative
communication — and summarizes them the way a serving dashboard would:
throughput (rounds/sec) plus p50/p95/p99 round-latency percentiles, and the
dist-to-opt-over-wall-clock trace.  `PipelinedReadback` keeps up to
``depth`` rounds in flight: a round's device values are read back (the
host waits on the device) only when its slot drains, never in ``push``.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable

import numpy as np


class PipelinedReadback:
    """Depth-bounded in-flight results: overlap device rounds with host stats.

    The serving loops (`FedRoundServer.run`, both stream and pool mode) never
    block on a round's scalar stats before queueing the next round — they
    `push` the device tensors and this helper drains (i.e. calls the
    blocking `drain_one`) only once `depth` results are in flight, so CUDA's
    asynchronous launches keep up to `depth` rounds queued between the
    device and the host readback.  On the CPU every operation is synchronous
    and the overlap is nil, but the structure (and the stats it records) is
    identical.
    """

    def __init__(self, depth: int, drain_one: Callable[..., None]) -> None:
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self._depth = depth
        self._drain_one = drain_one
        self._in_flight: deque[tuple[Any, ...]] = deque()

    def push(self, *item: Any) -> None:
        self._in_flight.append(item)
        while len(self._in_flight) >= self._depth:
            self._drain_one(*self._in_flight.popleft())

    def flush(self) -> None:
        """Drain everything still in flight (end of a `run`)."""
        while self._in_flight:
            self._drain_one(*self._in_flight.popleft())

    def __len__(self) -> int:
        return len(self._in_flight)


class ServeStats:
    """Per-round latency/progress accumulator for `FedRoundServer.run`."""

    def __init__(self) -> None:
        self.latencies_s: list[float] = []  # dispatch -> result, per round
        self.elapsed_s: list[float] = []  # run start -> result, per round
        self.dist_sq: list[float] = []  # server dist-to-opt after the round
        self.comm: list[int] = []  # cumulative communication steps
        self.comm_bytes: list[int] = []  # cumulative wire bytes (when priced)
        self.flops: list[float] = []  # cumulative analytic FLOPs (when priced)

    def record(
        self, latency_s: float, elapsed_s: float, dist_sq: float, comm: int,
        comm_bytes: int | None = None, flops: float | None = None,
    ) -> None:
        self.latencies_s.append(float(latency_s))
        self.elapsed_s.append(float(elapsed_s))
        self.dist_sq.append(float(dist_sq))
        self.comm.append(int(comm))
        if comm_bytes is not None:
            self.comm_bytes.append(int(comm_bytes))
        if flops is not None:
            self.flops.append(float(flops))

    @property
    def rounds(self) -> int:
        return len(self.latencies_s)

    def latency_percentiles_ms(self) -> dict[str, float]:
        if not self.latencies_s:
            return {"p50_ms": float("nan"), "p95_ms": float("nan"), "p99_ms": float("nan")}
        lat = np.asarray(self.latencies_s) * 1e3
        return {
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
        }

    def summary(self) -> dict[str, float]:
        """Rounds/sec + latency percentiles + final progress, JSON-friendly."""
        out = {"rounds": self.rounds, **self.latency_percentiles_ms()}
        if self.rounds:
            total = self.elapsed_s[-1]
            out["rounds_per_sec"] = self.rounds / total if total > 0 else float("inf")
            out["final_dist_sq"] = self.dist_sq[-1]
            out["total_comm"] = self.comm[-1]
        else:
            out["rounds_per_sec"] = float("nan")
            out["final_dist_sq"] = float("nan")
            out["total_comm"] = 0
        if self.comm_bytes:
            out["total_comm_bytes"] = self.comm_bytes[-1]
        if self.flops:
            # Cumulative analytic FLOPs (repro_torch.core.flops) and the
            # achieved rate over the run's wall clock — the serving-side MFU
            # numerator (`utils.roofline.mfu`).
            out["total_flops"] = self.flops[-1]
            total = self.elapsed_s[-1] if self.elapsed_s else 0.0
            out["gflops_per_sec"] = (
                self.flops[-1] / total / 1e9 if total > 0 else float("nan")
            )
        return out

    def trace(self) -> np.ndarray:
        """(rounds, 3) [elapsed_s, dist_sq, comm] — dist-to-opt over wall-clock."""
        return np.column_stack(
            [
                np.asarray(self.elapsed_s, dtype=np.float64),
                np.asarray(self.dist_sq, dtype=np.float64),
                np.asarray(self.comm, dtype=np.float64),
            ]
        ) if self.rounds else np.zeros((0, 3))

    def report(self) -> str:
        s = self.summary()
        return (
            f"rounds={s['rounds']}  rounds/sec={s['rounds_per_sec']:.1f}  "
            f"latency p50={s['p50_ms']:.2f}ms p95={s['p95_ms']:.2f}ms "
            f"p99={s['p99_ms']:.2f}ms  final dist^2={s['final_dist_sq']:.3e}  "
            f"comm={s['total_comm']}"
        )

    def markdown(self, title: str = "Federated round server") -> str:
        """The summary as a markdown table."""
        s = self.summary()
        hdr = "| rounds | rounds/sec | p50 (ms) | p95 (ms) | p99 (ms) | final dist^2 | comm |"
        sep = "|---:|---:|---:|---:|---:|---:|---:|"
        row = (
            f"| {s['rounds']} | {s['rounds_per_sec']:.1f} | {s['p50_ms']:.2f} "
            f"| {s['p95_ms']:.2f} | {s['p99_ms']:.2f} "
            f"| {s['final_dist_sq']:.3e} | {s['total_comm']} |"
        )
        if "gflops_per_sec" in s:
            hdr += " GFLOP/s |"
            sep += "---:|"
            row += f" {s['gflops_per_sec']:.2f} |"
        return "\n".join([f"### {title}", "", hdr, sep, row, ""])
