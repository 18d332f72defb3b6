"""Mixture-of-Experts decoder (deepseek-moe, qwen3-moe): the port of `repro.models.moe`.

Fine-grained experts with top-k routing, optional always-on shared experts
(deepseek: 2 shared + 64 routed top-6), capacity-based dispatch: each batch
row's token assignments are sorted by expert, placed into per-expert
capacity buffers (E, C, D), run through the stacked expert FFN, and
combined back with the router weights.  Assignments past an expert's
capacity are dropped (GShard/Switch semantics; ``capacity_factor`` sets the
slack), last tokens first, as the reference's stable sort orders them.

The parameter layout is the reference's: ``moe_layers`` leaves stacked
``(L_moe, ...)``, the routed experts ``(L_moe, E, ...)`` and the shared
experts ``(L_moe, S, ...)`` inside them, the leading dense layers
``dense_layers`` stacked ``(L_dense, ...)`` as the dense family's.  Its
`lax.scan`s over layers are Python loops over views of those stacks; its
sharding hints are the identity on one card.  Attention goes through
`kernels.ops` (K4 over a full sequence, K5 at decode, as the dense family);
routing, dispatch and the expert products stay PyTorch, as the reference
leaves them to XLA.

The reference's ``"gather"`` dispatch multiplies by one-hot (E, C, S+1)
tables to steer a TPU mesh's sharding; on one card the port computes the
same function from the same slot tables: an index gather from ``x`` padded
by one zero row, and an ``index_add`` over the slot's token, summed in
float32 and rounded once, as XLA's dot rounds.  ``"scatter"`` keeps the
reference's direct scatter and gather by (expert, position) pairs.

Routing rules that keep the port's experts the reference's: the router's
logits round to the compute dtype before the float32 softmax; top-k is a
stable descending sort (``lax.top_k`` takes the lower expert among equal
probabilities, ``torch.topk`` promises no order); the sort of assignments
by expert is stable.  `route` is a module-level function, so a caller can
rebind it (chip_smoke.py records a run's routing and replays it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models.transformer import (
    _attn_cfg,
    _layer_apply,
    _layer_init,
    layer_params,
    stacked_init,
)
from repro_torch.utils.tree import tree_leaves, tree_map


# ------------------------------------------------------------------ init
def _draw_(dst, gen, scale: float):
    """Fill ``dst`` (..., d_in, d_out) in place, one matrix at a time, with
    normal * ``scale`` drawn in float32 from ``gen`` and rounded to ``dst``'s
    dtype (`layers.linear_init`'s draw), so no second copy of a stack is
    held.  A meta tensor (shapes only) draws nothing."""
    if dst.is_meta:
        return dst
    for m in dst.view(-1, *dst.shape[-2:]):
        m.copy_(torch.randn(m.shape, generator=gen, dtype=torch.float32, device=dst.device)
                .mul_(scale))
    return dst


def _mlp_empty(cfg: ModelConfig, lead: tuple, dtype, device):
    """A router + routed + shared experts tree with leading dims ``lead``
    (``(E,)`` or ``(S,)`` inside, as the reference's vmapped init), uninitialised."""
    d, ff = cfg.d_model, cfg.moe_d_ff

    def experts(count):
        def w(*shape):
            return {"w": torch.empty((*lead, count, *shape), dtype=dtype, device=device)}
        return {"gate": w(d, ff), "up": w(d, ff), "down": w(ff, d)}

    p = {"router": {"w": torch.empty((*lead, d, cfg.num_experts), dtype=dtype, device=device)},
         "experts": experts(cfg.num_experts)}
    if cfg.num_shared_experts:
        p["shared"] = experts(cfg.num_shared_experts)
    return p


def _draw_mlp_(p, gen):
    """One layer's router (scale d**-0.5), then its routed and shared experts
    expert by expert (gate, up, down; scale d_in**-0.5), drawn in place."""
    _draw_(p["router"]["w"], gen, p["router"]["w"].shape[-2] ** -0.5)
    for stack in [p["experts"]] + ([p["shared"]] if "shared" in p else []):
        for e in range(stack["gate"]["w"].shape[0]):
            for name in ("gate", "up", "down"):
                w = stack[name]["w"][e]
                _draw_(w, gen, w.shape[0] ** -0.5)
    return p


def moe_mlp_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    """Router (d, E) + stacked routed experts (E, ...) + shared experts (S, ...)."""
    return _draw_mlp_(_mlp_empty(cfg, (), dtype, device), gen)


def _moe_layers_init(gen, cfg: ModelConfig, n: int, dtype, device):
    """The ``n`` MoE layers, every leaf allocated once at its stacked shape
    ``(n, ...)`` and drawn layer by layer (the attention by `stacked_init`,
    each layer's experts into their slices right after its attention), so no
    second copy of the weights is held: 32.75 GB for deepseek-moe-16b in
    bf16."""
    acfg = _attn_cfg(cfg)
    moe_p = _mlp_empty(cfg, (n,), dtype, device)
    experts = (tree_map(lambda t, i=i: t[i], moe_p) for i in range(n))

    def draw():
        one = nn.attn_init(gen, acfg, dtype, device)
        _draw_mlp_(next(experts), gen)
        return one

    attn = stacked_init(n, draw)
    ones = torch.ones((n, cfg.d_model), dtype=dtype, device=device)
    return {"ln1": {"scale": ones}, "attn": attn, "ln2": {"scale": ones.clone()}, "moe": moe_p}


def moe_init(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = getattr(torch, cfg.param_dtype)
    p = {"embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)}
    if cfg.first_dense_layers:
        p["dense_layers"] = stacked_init(cfg.first_dense_layers,
                                         lambda: _layer_init(gen, cfg, dtype, device))
    p["moe_layers"] = _moe_layers_init(gen, cfg, cfg.num_layers - cfg.first_dense_layers, dtype,
                                       device)
    p["ln_f"] = nn.rmsnorm_init(cfg.d_model, dtype, device)
    p["head"] = nn.linear_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------- routing
def top_k(probs, k: int):
    """(values, ids) of the ``k`` largest probabilities, largest first,
    the lower expert first among equal values: ``lax.top_k``'s order, by a
    stable descending sort."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def route(router, cfg: ModelConfig, x):
    """The router on x (B, S, D): (probs (B, S, E) float32, renormalised
    top-k weights (B, S, k) float32, ids (B, S, k) int64).  The logits
    round to x's dtype before the float32 softmax, as the reference's."""
    logits = nn.linear_apply(router, x).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = top_k(probs, cfg.num_experts_per_tok)
    return probs, w / w.sum(dim=-1, keepdim=True), ids


def capacity(cfg: ModelConfig, S: int, capacity_factor: float) -> int:
    """Slots an expert holds a batch row: ``int(max(1, ceil(S k / E) cf))``."""
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    return int(max(1, (-(-S * k // E)) * capacity_factor))


def _assignments(ids, E: int, C: int):
    """Each row's assignments sorted stably by expert: (order, sorted_eid,
    pos, keep), all (B, S k); ``pos`` the slot in its expert's buffer,
    ``keep`` pos < C."""
    B, Sk = ids.shape[0], ids.shape[1] * ids.shape[2]
    ids_flat = ids.reshape(B, Sk)
    order = torch.argsort(ids_flat, dim=-1, stable=True)
    sorted_eid = torch.gather(ids_flat, 1, order)
    # the reference's bincount, as a scatter-add: CUDA's bincount reads the
    # largest id back to the host to size its output
    counts = torch.zeros(B, E, dtype=torch.int64, device=ids.device).scatter_add_(
        1, ids_flat, torch.ones_like(ids_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(Sk, device=ids.device)[None] - torch.gather(starts, 1, sorted_eid)
    return order, sorted_eid, pos, pos < C


def _slot_tables(order, sorted_eid, pos, keep, k: int, S: int, E: int, C: int):
    """(slot_tok, slot_flat), each (B, E, C): the token and the assignment in
    each expert slot, S and S k where the slot is empty.  Assignments past
    capacity write to a spill slot cut off after (the reference's
    ``mode="drop"``)."""
    B = order.shape[0]
    rows = torch.arange(B, device=order.device)[:, None]
    slot = torch.where(keep, (rows * E + sorted_eid) * C + pos, B * E * C)
    tok = torch.full((B * E * C + 1,), S, dtype=torch.int64, device=order.device)
    flat = torch.full((B * E * C + 1,), S * k, dtype=torch.int64, device=order.device)
    tok[slot.reshape(-1)] = (order // k).reshape(-1)
    flat[slot.reshape(-1)] = order.reshape(-1)
    return tok[:-1].view(B, E, C), flat[:-1].view(B, E, C)


# ---------------------------------------------------------------- experts
def _expert_w(leaf, dtype):
    """Stacked expert weight in ``dtype``; an int8 ``{"q", "s"}`` one
    (`repro_torch.quant`) dequantised whole, ``q`` and ``s`` cast to
    ``dtype`` and their product rounded there, as the reference's."""
    if isinstance(leaf, dict):
        return nn.dequantize_weight(leaf, dtype)
    return leaf.to(dtype)


def _expert_ffn(experts, buf):
    """buf (E, N, D) -> (E, N, D) through the stacked SwiGLU expert weights."""
    g = torch.bmm(buf, _expert_w(experts["gate"]["w"], buf.dtype))
    u = torch.bmm(buf, _expert_w(experts["up"]["w"], buf.dtype))
    return torch.bmm(F.silu(g) * u, _expert_w(experts["down"]["w"], buf.dtype))


def _experts_over_rows(experts, buf):
    """buf (B, E, C, D): every row's buffers through the experts at once."""
    B, E, C, D = buf.shape
    out = _expert_ffn(experts, buf.transpose(0, 1).reshape(E, B * C, D))
    return out.view(E, B, C, D).transpose(0, 1)


def _shared_sum(shared, x):
    """The shared experts on x (the reference's vmapped MLPs, here one
    batched product over the stack), summed over the stack in float32 and
    rounded once, as the reference's ``jnp.sum``."""
    B, S, D = x.shape
    n = tree_leaves(shared)[0].shape[0]
    y = _expert_ffn(shared, x.reshape(1, B * S, D).expand(n, -1, -1))
    return y.float().sum(dim=0).to(x.dtype).view(B, S, D)


def load_balance_loss(cfg: ModelConfig, probs, ids):
    """The Switch-style auxiliary loss: E sum_e density_e / k mean_prob_e.
    density, the mean over tokens of each expert's one-hot count, has no
    gradient (counted by a scatter-add: CUDA's one_hot reads the ids back
    to check their range); the gradient flows through ``probs``."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    B, S = ids.shape[:2]
    density = torch.zeros(E, dtype=torch.float32, device=ids.device).scatter_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), dtype=torch.float32, device=ids.device))
    return E * torch.sum(density / (B * S) / k * probs.mean(dim=(0, 1)))


def moe_mlp_apply(p, cfg: ModelConfig, x, *, capacity_factor: float | None = None):
    """x: (B, S, D) -> (y, aux loss), with capacity dispatch per batch row."""
    y, probs, ids = _moe_mlp(p, cfg, x, capacity_factor)
    return y, load_balance_loss(cfg, probs, ids)


def _moe_mlp(p, cfg: ModelConfig, x, capacity_factor: float | None = None):
    """`moe_mlp_apply` without the aux loss: (y, probs, ids).  Decode calls it
    directly, as the reference's compiled decode drops the unused loss."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, S, cfg.capacity_factor if capacity_factor is None else capacity_factor)
    probs, w_topk, ids = route(p["router"], cfg, x)
    order, sorted_eid, pos, keep = _assignments(ids, E, C)
    rows = torch.arange(B, device=x.device)
    if cfg.moe_dispatch == "gather":
        slot_tok, slot_flat = _slot_tables(order, sorted_eid, pos, keep, k, S, E, C)
        xpad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
        buf = xpad[rows[:, None, None], slot_tok]  # (B, E, C, D)
        out_buf = _experts_over_rows(p["experts"], buf)
        w_flat = torch.cat([w_topk.reshape(B, S * k).to(x.dtype), x.new_zeros(B, 1)], dim=1)
        w_slot = torch.gather(w_flat, 1, slot_flat.view(B, E * C)).view(B, E, C)
        contrib = (out_buf * w_slot[..., None]).float()
        index = (rows[:, None, None] * (S + 1) + slot_tok).reshape(-1)
        y = torch.zeros(B * (S + 1), D, dtype=torch.float32, device=x.device).index_add(
            0, index, contrib.reshape(-1, D))
        y = y.view(B, S + 1, D)[:, :S].to(x.dtype)
    elif cfg.moe_dispatch == "scatter":
        r = rows[:, None]
        slot = torch.where(keep, (r * E + sorted_eid) * C + pos, B * E * C)
        x_tok = x[r, order // k]  # (B, S k, D)
        buf = x.new_zeros(B * E * C + 1, D).index_put((slot.reshape(-1),), x_tok.reshape(-1, D))
        out_buf = _experts_over_rows(p["experts"], buf[:-1].view(B, E, C, D))
        got = out_buf.reshape(B * E * C, D)[slot.clamp(max=B * E * C - 1)]  # (B, S k, D)
        y_sorted = got * keep[..., None].to(x.dtype)
        inverse = torch.empty_like(order).scatter_(
            1, order, torch.arange(S * k, device=x.device).expand(B, -1))
        y_flat = y_sorted[r, inverse].view(B, S, k, D)
        y = (y_flat * w_topk[..., None].to(x.dtype)).float().sum(dim=2).to(x.dtype)
    else:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}; expected 'gather' or "
                         f"'scatter'")

    if "shared" in p:  # always-on shared experts (deepseek), summed, then added
        y = y + _shared_sum(p["shared"], x)
    return y, probs, ids


# --------------------------------------------------------------- full model
def moe_forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int -> (logits (B, S, V), aux): aux the load-balance
    loss averaged over the MoE layers."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], tokens).to(cdt)
    rope = nn.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.head_dim, cfg.rope_theta)
    acfg = _attn_cfg(cfg)
    if "dense_layers" in params:
        for lp in layer_params(params["dense_layers"]):
            x = _layer_apply(lp, cfg, x, rope)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_params(params["moe_layers"]):
        x = x + nn.attn_apply(lp["attn"], acfg, nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps), rope)
        y, a = moe_mlp_apply(lp["moe"], cfg, nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))
        x, aux = x + y, aux + a
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    n_moe = cfg.num_layers - cfg.first_dense_layers
    return nn.unembed_apply(params["head"], x), aux / max(n_moe, 1)


# ----------------------------------------------------------------- decode
def moe_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None):
    """``{"moe": {"k", "v"}, "dense": {"k", "v"}}`` of zeros, each
    ``(L, B, S, KVH, Dh)`` over its layers (``"dense"`` only with leading
    dense layers); a ring buffer of min(cache_len, window) slots for
    sliding-window configs."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)

    def kv(L):
        shape = (L, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache = {"moe": kv(cfg.num_layers - cfg.first_dense_layers)}
    if cfg.first_dense_layers:
        cache["dense"] = kv(cfg.first_dense_layers)
    return cache


def moe_decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position.  Returns (logits (B, V),
    cache); the cache is updated in place."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], token[:, None]).to(cdt)  # (B, 1, D)
    acfg = _attn_cfg(cfg)
    tables = nn.decode_tables(acfg, pos, cache["moe"]["k"].shape[2], x.device)

    def attend(lp, x, kv, i):
        h = nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = nn.attn_decode_apply(lp["attn"], acfg, h, kv["k"][i], kv["v"][i], pos, tables)
        return x + a

    if "dense_layers" in params:
        for i, lp in enumerate(layer_params(params["dense_layers"])):
            x = attend(lp, x, cache["dense"], i)
            x = x + nn.mlp_apply(lp["mlp"], nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))
    for i, lp in enumerate(layer_params(params["moe_layers"])):
        x = attend(lp, x, cache["moe"], i)
        x = x + _moe_mlp(lp["moe"], cfg, nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))[0]
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)[:, 0], cache
