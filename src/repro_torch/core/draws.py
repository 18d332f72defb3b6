"""The random draws of a sweep, as a record made before the first round.

The reference draws its client indices and refresh coins inside the round
through JAX's threefry keys (`repro.core.rounds.RoundOps.split` /
`uniform_client` / `sample_cohort` / `bernoulli`, and Catalyst's per-stage
`split(key, num_outer)`).  PyTorch cannot replay threefry, so the port's
round layer reads the same decisions from a `Draws` record instead:

* ``clients``: ``(K, B)`` sampled client per round and trial (sppm/svrp), or
  ``(K, B, b)`` cohorts drawn without replacement (svrp_minibatch); Catalyst
  takes a ``(T, K, B)`` stack, one ``(K, B)`` block per outer stage;
* ``coins``: ``(K, B)`` (or ``(T, K, B)``) bool anchor-refresh coins, None for
  sppm, which never refreshes.

DeepSVRP draws no client (every client takes part in every round): its
record carries coins only, and ``clients`` is None.

The baselines follow the same two patterns: sgd and scaffold draw one client a
round (as sppm), svrg a client and a coin (as svrp); dane and
acc_extragradient draw nothing.  One trial's record (``batched=False``) has
no trial axis: ``(K,)`` clients and coins, ``(K, b)`` cohorts, ``(T, K)`` for
Catalyst; the per-trial drivers take one, or a batched record of one trial,
or a seed (`trial_draws`).

A record replayed from the reference's keys (the tests build one) makes the
port's ``comm`` integer-equal to the reference's.  `draw_schedule` draws one
natively: one `torch.Generator` per trial, seeded with the trial's seed, so
trial s draws the same numbers whatever the batch size.  Either way the whole
horizon is drawn up front and moved to the device once, and the per-round
"does any trial refresh" mask is computed on the host once, so the
batch-aware anchor refresh never waits on the device.

The online engine (`repro_torch.serve`) reads records in two more ways:

* `Draws.window` takes rounds ``[t, t + n)`` of a record with its host mask
  sliced to match, and `concat_trials` puts several tenants' windows side
  by side on the trial axis, their clients offset into a stacked problem
  and their host masks OR-ed (a session pool's tick);
* `ResidentDraws` is the streaming server's source: one round at a time,
  over the clients resident when the round starts, drawn from the server's
  own generator or read from a replayed record.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Draws:
    clients: torch.Tensor | None  # (K, B) / (K, B, b) int64; Catalyst (T, K, B); deep_svrp None
    coins: torch.Tensor | None = None  # (K, B) bool; Catalyst (T, K, B); None for sppm
    # Host (K,) / (T, K) mask: does any trial refresh its anchor at that round?
    refresh: np.ndarray | None = None
    batched: bool = True  # False: one trial's record, without the trial axis

    def __post_init__(self):
        if self.coins is not None and self.refresh is None:
            mask = self.coins.any(dim=-1) if self.batched else self.coins
            object.__setattr__(self, "refresh", mask.cpu().numpy())

    @property
    def num_trials(self) -> int:
        if not self.batched:
            return 1
        return (self.coins if self.coins is not None else self.clients).shape[-1]

    @property
    def lanes(self) -> tuple:
        """The state's trial axes: ``(B,)`` for a batched record, ``()`` for one trial."""
        return (self.num_trials,) if self.batched else ()

    def to(self, device) -> "Draws":
        return Draws(_opt(self.clients, lambda t: t.to(device)),
                     _opt(self.coins, lambda t: t.to(device)), self.refresh, self.batched)

    def stage(self, t: int) -> "Draws":
        """Catalyst's outer stage t as a plain ``(K, B)`` (or ``(K,)``) record."""
        refresh = None if self.refresh is None else self.refresh[t]
        return Draws(self.clients[t], _opt(self.coins, lambda c: c[t]), refresh, self.batched)

    def window(self, t: int, n: int) -> "Draws":
        """Rounds ``[t, t + n)`` of the record's round axis (the leading one;
        not a Catalyst stack), its host refresh mask sliced to match."""
        sl = slice(t, t + n)
        refresh = None if self.refresh is None else self.refresh[sl]
        return Draws(_opt(self.clients, lambda c: c[sl]), _opt(self.coins, lambda c: c[sl]),
                     refresh, self.batched)

    def trials(self, idx: torch.Tensor) -> "Draws":
        """Trials ``idx`` of a batched record, in that order (a rank's block
        of a ``shard="data"`` sweep, padded by repeating its last trial),
        with the host refresh mask of those trials alone."""
        axis = (self.coins if self.coins is not None else self.clients).ndim - 1
        return Draws(_opt(self.clients, lambda t: t.index_select(axis, idx.to(t.device))),
                     _opt(self.coins, lambda t: t.index_select(axis, idx.to(t.device))))

    def trial(self, i: int) -> "Draws":
        """Trial ``i`` of a batched record, as one trial's record."""
        axis = (self.coins if self.coins is not None else self.clients).ndim - 1
        return Draws(_opt(self.clients, lambda t: t.select(axis, i)),
                     _opt(self.coins, lambda t: t.select(axis, i)), batched=False)


def _opt(t, fn):
    return None if t is None else fn(t)


def concat_trials(records: Sequence[Draws], client_offsets: Sequence[int]) -> Draws:
    """Batched records of equal length side by side on the trial axis: the
    clients of record i offset by ``client_offsets[i]`` (into a problem whose
    clients are the records' problems' clients stacked in order), and the
    host refresh mask the OR of the records' (a round refreshes if any
    trial of any record does)."""
    first = records[0]
    clients = None
    if first.clients is not None:
        clients = torch.cat([r.clients + off for r, off in zip(records, client_offsets)], dim=1)
    coins = None if first.coins is None else torch.cat([r.coins for r in records], dim=1)
    refresh = None
    if first.refresh is not None:
        refresh = np.logical_or.reduce([np.asarray(r.refresh) for r in records])
    return Draws(clients, coins, refresh)


class _Round:
    """One round's value, indexed by round as a record's round axis is."""

    __slots__ = ("k", "value")

    def __init__(self):
        self.k, self.value = -1, None

    def __getitem__(self, k: int):
        if k != self.k:
            raise IndexError(f"round {k} was not drawn; this source holds round {self.k}")
        return self.value


class ResidentDraws:
    """The streaming server's draws: one trial, one round at a time, over
    the clients resident when the round starts.

    ``draw(k, mask)`` fills round ``k`` for the host residency mask
    ``mask`` (M,): natively from ``generator`` — a client uniform over the
    resident set (sppm / svrp), or a cohort of ``batch_clients`` drawn
    without replacement from it (svrp_minibatch), then a refresh coin
    ``u < p`` with ``u`` drawn at ``coin_dtype`` (the iterate's, as the
    reference flips its coins) — or from row ``k`` of ``replay``, a
    one-trial record, whose picks must be resident.  DeepSVRP
    (``clients=False``) draws its coin only: every client takes part.  The
    draws are made on the host, so the round's refresh mask is known there
    before the round is queued; the round layer reads ``clients[k]``,
    ``coins[k]`` and ``refresh[k]`` as it reads a record's, and reading
    another round than the one drawn raises."""

    batched = False
    lanes: tuple = ()
    num_trials = 1

    def __init__(self, num_clients: int, *, device, p=None, batch_clients: int | None = None,
                 clients: bool = True, coin_dtype=torch.float64,
                 generator: torch.Generator | None = None, replay: Draws | None = None):
        self.num_clients = num_clients
        self.device = device
        self.p = p
        self.batch_clients = batch_clients
        self.coin_dtype = coin_dtype
        self.generator = generator
        self.replay = None if replay is None else replay.to("cpu")
        self.clients = _Round() if clients else None
        self.coins = None if p is None else _Round()
        self.refresh = None if p is None else _Round()

    def draw(self, k: int, mask: np.ndarray) -> None:
        """Fill round ``k`` for the residency ``mask``."""
        resident = np.flatnonzero(mask)
        if self.clients is not None:
            if self.replay is not None:
                pick = self.replay.clients[k]
                if not mask[pick.numpy()].all():
                    raise ValueError(f"round {k}: the replayed clients {pick.tolist()} are not "
                                     f"all resident (resident: {resident.tolist()})")
            elif self.batch_clients is None:
                pick = torch.as_tensor(resident)[
                    torch.randint(len(resident), (), generator=self.generator)]
            else:
                order = torch.randperm(len(resident), generator=self.generator)
                pick = torch.as_tensor(resident)[order[:self.batch_clients]]
            self._set(self.clients, k, pick.to(self.device))
        if self.coins is not None:
            if self.replay is not None:
                coin = self.replay.coins[k]
            else:
                u = torch.rand((), generator=self.generator, dtype=self.coin_dtype)
                coin = u < torch.as_tensor(self.p, dtype=self.coin_dtype)
            self._set(self.refresh, k, bool(coin))
            self._set(self.coins, k, coin.to(self.device))

    @staticmethod
    def _set(slot: _Round, k: int, value) -> None:
        slot.k, slot.value = k, value


def draw_schedule(
    seeds,
    num_clients: int,
    num_steps: int,
    p=None,
    *,
    batch_clients: int | None = None,
    num_outer: int | None = None,
    clients: bool = True,
    device=None,
) -> Draws:
    """Draw a sweep's whole horizon natively, one generator per trial.

    ``seeds`` is the ``(B,)`` per-trial seed array; ``p`` the ``(B,)`` (or
    scalar) refresh probability, None for sppm; ``batch_clients`` draws
    cohorts of that size without replacement; ``num_outer`` stacks Catalyst's
    stages; ``clients=False`` draws coins only (DeepSVRP).  Trial b's
    generator draws its clients first, then its coins."""
    seeds = np.asarray(seeds).reshape(-1)
    lead = (num_steps,) if num_outer is None else (num_outer, num_steps)
    probs = None if p is None else np.broadcast_to(np.asarray(p, np.float64), seeds.shape)
    picks, coins = [], []
    for b, seed in enumerate(seeds):
        gen = torch.Generator().manual_seed(int(seed))
        if clients and batch_clients is None:
            picks.append(torch.randint(0, num_clients, lead, generator=gen))
        elif clients:
            keys = torch.rand(lead + (num_clients,), generator=gen, dtype=torch.float64)
            picks.append(keys.argsort(dim=-1)[..., :batch_clients])
        if probs is not None:
            coins.append(torch.rand(lead, generator=gen, dtype=torch.float64) < float(probs[b]))
    axis = len(lead)
    draws = Draws(
        torch.stack(picks, dim=axis) if clients else None,
        None if probs is None else torch.stack(coins, dim=axis),
    )
    return draws if device is None else draws.to(device)


def trial_draws(
    draws: Draws | None,
    seed: int | None,
    num_clients: int,
    num_steps: int,
    p=None,
    *,
    batch_clients: int | None = None,
    num_outer: int | None = None,
    clients: bool = True,
    device=None,
) -> Draws:
    """One trial's record for a per-trial driver, on ``device``.

    ``draws`` may hold one trial's shapes — ``(K,)`` clients (``(K, b)``
    cohorts; Catalyst ``(T, K)``) and coins of the lead shape — or a batched
    record of one trial; when it is None, `draw_schedule` draws the record
    from ``seed``.  Client indices are checked against ``[0, num_clients)``
    here, once, on the host.  ``clients=False``: a coins-only record
    (DeepSVRP), checked by its coins' shape."""
    lead = (num_steps,) if num_outer is None else (num_outer, num_steps)
    cohort = () if batch_clients is None else (batch_clients,)
    if draws is None:
        if seed is None:
            raise ValueError("pass draws= (a per-trial record) or seed= to draw one")
        draws = draw_schedule([seed], num_clients, num_steps, p, batch_clients=batch_clients,
                              num_outer=num_outer, clients=clients).trial(0)
    else:
        picked = draws.clients if clients else draws.coins
        got = None if picked is None else tuple(picked.shape)
        if draws.batched and got == lead + (1,) + cohort:
            draws = draws.trial(0)
        elif got == lead + cohort:
            if draws.batched:
                draws = Draws(draws.clients, draws.coins, batched=False)
        else:
            raise ValueError(
                f"the draws have {'clients' if clients else 'coins'} {got}; this run needs "
                f"{lead + cohort} (or {lead + (1,) + cohort})"
            )
        if not clients and draws.clients is not None:
            raise ValueError("this run draws no clients; the draws carry some")
    coins_shape = None if draws.coins is None else tuple(draws.coins.shape)
    if coins_shape != (None if p is None else lead):
        raise ValueError(f"the draws have coins {coins_shape}; this run needs "
                         f"{None if p is None else lead}")
    if draws.clients is not None and draws.clients.numel():
        lo, hi = (int(v) for v in torch.aminmax(draws.clients))
        if lo < 0 or hi >= num_clients:
            raise ValueError(f"the draws' clients span [{lo}, {hi}], outside [0, {num_clients})")
    return draws if device is None else draws.to(device)
