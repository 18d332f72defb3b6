"""Carry state across from `repro`: numpy arrays in, the port's objects out.

The port never imports `repro`; what crosses between the two packages is
plain numpy.  `problem_from_arrays` rebuilds a `repro` problem from its
leaves (``A``/``b`` for a quadratic, ``Z``/``y``/``lam`` for a logistic
problem, and ``dp_shift`` with the DP metadata for a DP-ERM one),
`fed_lm_x0_from_numpy` a federated LM's flat parameter vector from the
reference's parameter tree, `hparams_from_numpy` a per-trial hparam table,
`dense_params_from_numpy`, `hybrid_params_from_numpy`,
`ssm_params_from_numpy`, `moe_params_from_numpy`,
`audio_params_from_numpy` and `vlm_params_from_numpy` a dense, hybrid
(zamba2), ssm (rwkv6), moe (deepseek-moe, qwen3-moe), audio (seamless-m4t)
or vlm (internvl2) model's parameter tree (`params_from_numpy` any of the
six by ``cfg.family``),
`svrp_state_from_numpy` a DeepSVRP train state and
`adamw_state_from_numpy` an AdamW train state, so both packages compute on
the same data, the same weights and the same state; `state_to_numpy`
takes a state back out for comparison.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.experiments.spec import resolve_algo
from repro_torch.launch.steps import AdamWTrainState, SVRPServerState
from repro_torch.models import model as M
from repro_torch.optim import OptState
from repro_torch.problems import LogisticProblem, QuadraticProblem
from repro_torch.problems.dp_erm import DPLogisticProblem, DPQuadraticProblem


def problem_from_arrays(
    kind: str,
    arrays: Mapping[str, np.ndarray],
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float64,
):
    """The port's problem of ``kind`` ("quadratic" or "logistic") on the
    given leaves, as tensors of ``dtype`` on ``device`` (default CUDA).

    With a ``dp_shift`` leaf it is the DP-ERM problem as the reference holds
    it (`DPQuadraticProblem`: ``b`` already noised; `DPLogisticProblem`:
    ``Z`` already clipped), and ``dp_sigma``, ``dp_clip`` and (quadratic)
    ``dp_n`` give its metadata."""
    dev = resolve_device(device)

    def t(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)

    dp = {}
    if "dp_shift" in arrays:
        dp = dict(dp_shift=t("dp_shift"), dp_sigma=float(arrays["dp_sigma"]),
                  dp_clip=float(arrays["dp_clip"]))
    if kind == "quadratic":
        if dp:
            return DPQuadraticProblem(A=t("A"), b=t("b"), dp_n=int(arrays["dp_n"]), **dp)
        return QuadraticProblem(A=t("A"), b=t("b"))
    if kind == "logistic":
        cls = DPLogisticProblem if dp else LogisticProblem
        return cls(Z=t("Z"), y=t("y"), lam=float(arrays["lam"]), **dp)
    raise ValueError(f"unknown problem kind {kind!r}; expected 'quadratic' or 'logistic'")


def fed_lm_x0_from_numpy(tree, cfg: ModelConfig, device=None) -> torch.Tensor:
    """A federated LM's flat float32 parameter vector from the reference's
    parameter tree with numpy leaves: the leaves in `jax.flatten_util.
    ravel_pytree`'s order (dict keys sorted at every level), so it equals
    the reference's ravelled ``x0`` bit for bit."""
    from repro_torch.problems.fed_lm import ravel_params

    return ravel_params(params_from_numpy(tree, cfg, device, dtype=torch.float32))


def hparams_from_numpy(algo: str, values: Mapping[str, np.ndarray], *, device=None):
    """``algo``'s params NamedTuple from a ``{field: (B,) array}`` table."""
    dev = resolve_device(device)
    params_cls = resolve_algo(algo).params_cls
    missing = set(params_cls._fields) - set(values)
    if missing:
        raise ValueError(f"{algo}: hparams need fields {sorted(missing)}")
    return params_cls(**{
        k: torch.tensor(np.asarray(values[k]), device=dev) for k in params_cls._fields
    })


def _params_from_numpy(tree, cfg: ModelConfig, family: str, device, dtype):
    """``tree`` checked against the keys and shapes `init_params` gives
    ``cfg``, as tensors on ``device``: every leaf in ``dtype``, or, with
    ``dtype`` None, in the dtype `init_params` gives that leaf."""
    if cfg.family != family:
        raise ValueError(f"{cfg.name} is of the {cfg.family} family, not {family}")
    dev = resolve_device(device)
    expected = M.init_params(cfg, torch.Generator(), device="meta")

    def convert(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"params{path}: expected keys {sorted(want)}, got {got}")
            return {k: convert(node[k], want[k], f"{path}[{k!r}]") for k in want}
        a = np.asarray(node, dtype=np.float32)
        if a.shape != tuple(want.shape):
            raise ValueError(f"params{path}: expected shape {tuple(want.shape)}, got {a.shape}")
        return torch.tensor(a, dtype=dtype or want.dtype, device=dev)

    return convert(tree, expected, "")


def dense_params_from_numpy(tree, cfg: ModelConfig, device=None, dtype=None):
    """The port's parameters of the dense model ``cfg`` from the reference's
    params pytree with numpy leaves (``jax.tree.map(np.asarray, params)``):
    the same nested dicts and stacked (L, ...) leaves, as tensors of
    ``dtype`` (default ``cfg.param_dtype``) on ``device`` (default CUDA).
    Leaves go through float32, which holds bfloat16 exactly.  Raises unless
    the tree has exactly the keys and shapes `init_params` gives ``cfg``."""
    return _params_from_numpy(tree, cfg, "dense", device,
                              dtype or getattr(torch, cfg.param_dtype))


def hybrid_params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's parameters of the hybrid model ``cfg`` (zamba2) from the
    reference's params pytree with numpy leaves: the same nested dicts,
    Mamba-2 leaves stacked (G, per_group, ...) and LoRA leaves (G, ...), on
    ``device`` (default CUDA).  Each leaf keeps the reference's dtype:
    ``cfg.param_dtype``, except the float32 ``A_log``, ``D`` and
    ``dt_bias`` of every Mamba-2 layer.  Raises unless the tree has exactly
    the keys and shapes `init_params` gives ``cfg``."""
    return _params_from_numpy(tree, cfg, "hybrid", device, None)


def ssm_params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's parameters of the ssm model ``cfg`` (rwkv6) from the
    reference's params pytree with numpy leaves: the same nested dicts with
    every layer leaf stacked (L, ...), on ``device`` (default CUDA).  Each
    leaf keeps the reference's dtype: ``cfg.param_dtype``, except the
    float32 ``w0`` and ``u`` of every time-mix block.  Raises unless the
    tree has exactly the keys and shapes `init_params` gives ``cfg``."""
    return _params_from_numpy(tree, cfg, "ssm", device, None)


def moe_params_from_numpy(tree, cfg: ModelConfig, device=None, dtype=None):
    """The port's parameters of the moe model ``cfg`` (deepseek-moe,
    qwen3-moe) from the reference's params pytree with numpy leaves: the same
    nested dicts, ``dense_layers`` leaves stacked (L_dense, ...),
    ``moe_layers`` leaves (L_moe, ...) with the routed experts (L_moe, E,
    ...) and the shared experts (L_moe, S, ...) inside, as tensors of
    ``dtype`` (default ``cfg.param_dtype``) on ``device`` (default CUDA).
    Raises unless the tree has exactly the keys and shapes `init_params`
    gives ``cfg``."""
    return _params_from_numpy(tree, cfg, "moe", device, dtype or getattr(torch, cfg.param_dtype))


def audio_params_from_numpy(tree, cfg: ModelConfig, device=None, dtype=None):
    """The port's parameters of the audio model ``cfg`` (seamless-m4t) from
    the reference's params pytree with numpy leaves: the same nested dicts,
    ``enc_layers`` leaves stacked (L_enc, ...) and ``dec_layers`` leaves
    (L_dec, ...) with ``self_attn`` and ``cross_attn`` inside, as tensors of
    ``dtype`` (default ``cfg.param_dtype``) on ``device`` (default CUDA).
    Raises unless the tree has exactly the keys and shapes `init_params`
    gives ``cfg``."""
    return _params_from_numpy(tree, cfg, "audio", device,
                              dtype or getattr(torch, cfg.param_dtype))


def vlm_params_from_numpy(tree, cfg: ModelConfig, device=None, dtype=None):
    """The port's parameters of the vlm model ``cfg`` (internvl2) from the
    reference's params pytree with numpy leaves: the dense decoder's tree
    (``layers`` leaves stacked (L, ...)) and ``projector`` (``ln`` over the
    vision width, ``fc1``, ``fc2``), as tensors of ``dtype`` (default
    ``cfg.param_dtype``) on ``device`` (default CUDA).  Raises unless the
    tree has exactly the keys and shapes `init_params` gives ``cfg``."""
    return _params_from_numpy(tree, cfg, "vlm", device, dtype or getattr(torch, cfg.param_dtype))


def params_from_numpy(tree, cfg: ModelConfig, device=None, dtype=None):
    """The port's parameters of ``cfg`` from the reference's, by ``cfg.family``
    (`dense_params_from_numpy`, `hybrid_params_from_numpy`,
    `ssm_params_from_numpy`, `moe_params_from_numpy`,
    `audio_params_from_numpy`, `vlm_params_from_numpy`): every leaf in
    ``dtype``, or, with ``dtype`` None, in the dtype `init_params` gives it."""
    return _params_from_numpy(tree, cfg, cfg.family, device, dtype)


def svrp_state_from_numpy(state_tree, cfg: ModelConfig, device=None,
                          rng: torch.Generator | None = None) -> SVRPServerState:
    """The port's DeepSVRP train state from the reference's, with numpy
    leaves (``jax.tree.map(np.asarray, state._asdict())``), for any ported
    family: x and w in their leaves' dtypes (`params_from_numpy`), gbar in
    float32, the step counter, and ``rng`` for the coins of a native run
    (default seed 0; the reference's key does not cross)."""
    params = params_from_numpy(state_tree["params"], cfg, device)
    anchor = params_from_numpy(state_tree["anchor"], cfg, device)
    gbar = params_from_numpy(state_tree["anchor_grad"], cfg, device, dtype=torch.float32)
    return SVRPServerState(params=params, anchor=anchor, anchor_grad=gbar,
                           step=int(np.asarray(state_tree.get("step", 0))),
                           rng=rng if rng is not None else torch.Generator().manual_seed(0))


def adamw_state_from_numpy(tree, cfg: ModelConfig, device=None) -> AdamWTrainState:
    """The port's AdamW train state from the reference's with numpy leaves
    (``jax.tree.map(np.asarray, state)``, or its ``_asdict()``), for any
    ported family: params in their leaves' dtypes (`params_from_numpy`), the
    moments ``mu`` and ``nu`` in float32, the step counter."""
    def field(node, name):
        return node[name] if isinstance(node, Mapping) else getattr(node, name)

    opt = field(tree, "opt")
    params = params_from_numpy(field(tree, "params"), cfg, device)
    mu, nu = (params_from_numpy(field(opt, k), cfg, device, dtype=torch.float32)
              for k in ("mu", "nu"))
    return AdamWTrainState(params, OptState(step=int(np.asarray(field(opt, "step"))), mu=mu,
                                            nu=nu))


def state_to_numpy(state) -> dict:
    """``params``, ``anchor`` and ``anchor_grad`` of a train or round state
    as trees of float32 numpy arrays (which hold bfloat16 exactly), and
    ``step``."""
    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return t.detach().float().cpu().numpy()

    return {"params": tree(state.params), "anchor": tree(state.anchor),
            "anchor_grad": tree(state.anchor_grad), "step": int(state.step)}
