"""Online round engine: incremental sessions and streaming federated serving.

Port of `repro.serve`.  Two layers over the SAME step definitions the
engine's substrates run (`core.rounds.registry_step_def` for the
rounds-defined algorithms, `core.catalyst.catalyzed_step_def`, the
baselines' and composite's ``*_step_def``):

* `open_session` / `FedSession` — a sweep held open: `session.step(n)` runs n
  rounds of every trial with its state on the device, `session.run_until(eps)`
  stops early; k incremental rounds == the first k columns of `run_batch`,
  bit for bit, because both read the record drawn once for the horizon.
* `FedRoundServer` / `ClientStream` / `ServeStats` — a streaming simulation:
  clients churn on a stream, cohorts form from the resident clients, rounds
  run continuously with pipelined stats readback (rounds/sec, p50/p95/p99
  round latency, dist-to-opt over wall-clock, achieved FLOP/s).
* `SessionPool` — multi-tenant serving: many same-shaped sessions stepped
  together each tick (one stacked lane batch where the problems stack),
  each tenant's trajectory equal to its standalone `FedSession`;
  `FedRoundServer(pool=...)` drives it with the same pipelined readback.

The reference's `donate_argnums_for` (`repro.serve.donation`) has no
counterpart: buffer donation is an XLA hint for jitted dispatches, and the
port has none — its round layer replaces the state tensors each round, and
the previous round's tensors are freed when nothing refers to them.

Not to be confused with `repro_torch.launch.serve`, the model-decode batch
server.
"""
from repro_torch.serve.pool import SessionPool
from repro_torch.serve.server import ClientStream, FedRoundServer
from repro_torch.serve.session import FedSession, open_session, trial_step_def
from repro_torch.serve.stats import PipelinedReadback, ServeStats

__all__ = [
    "ClientStream",
    "FedRoundServer",
    "FedSession",
    "PipelinedReadback",
    "ServeStats",
    "SessionPool",
    "open_session",
    "trial_step_def",
]
