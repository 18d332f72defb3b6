"""Federated transformer fine-tuning with DeepSVRP on the PyTorch port, through
the engine -- `run_batch` over a `FedLMProblem` -- with a comm channel on the wire.

    PYTHONPATH=src python examples/fed_transformer_torch.py --quick --device cpu  # smoke
    PYTHONPATH=src python examples/fed_transformer_torch.py                       # 20m, GPU
    PYTHONPATH=src python examples/fed_transformer_torch.py --channel quant8 --rounds 8

The twin of `examples/fed_transformer.py` on `repro_torch`: the same
presets, hyperparameters and printout.  The model's parameters travel as one
flat vector, the round is `rounds.ROUND_DEFS["deep_svrp"]`, the engine's
dist_sq column is the mean LM loss over clients (`FedLMProblem.metric`) and
`BatchResult.comm_bytes` is the bytes-on-the-wire ledger under the channel.
On the card each local GD step is one K1 launch over every client's row and
each client gradient runs K4 and K4b once a layer; the card's attention
kernels build head dims 64, 80 and 128, so the GPU presets are 20m and 100m
(Dh 64), and cpu-small (Dh 16) runs on the CPU.  The weights are drawn from
a `torch.Generator`, so the losses are not the reference's digit for digit.

`--compare` runs float32 and the chosen channel back to back and prints the
bytes ratio (quant8: <= 0.27x, with the loss decreasing).  `--dry-run-qwen`
prices one transfer of qwen2-1.5b's parameters per channel from shapes on
the ``meta`` device, allocating nothing.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.core.channel import CHANNELS, payload_nbytes
from repro_torch.experiments import RunSpec, run_batch
from repro_torch.problems import make_fed_lm_problem
from repro_torch.utils.tree import tree_leaves

PRESETS = {
    # (d_model, layers, heads, kv, d_ff, vocab, batch/client, seq)
    "cpu-small": (64, 2, 4, 2, 128, 128, 2, 32),
    "20m": (384, 6, 6, 2, 1024, 8192, 2, 128),
    "100m": (768, 12, 12, 4, 2048, 32000, 4, 256),
}
# The reference example's defaults.
HPARAMS = dict(eta=1.0, local_lr=0.2, local_steps=2, anchor_prob=0.25, alpha=0.3, clients=4)


def build_cfg(preset: str):
    d, L, h, kv, ff, vocab, bsz, seq = PRESETS[preset]
    cfg = dataclasses.replace(
        REGISTRY["llama3.2-3b"].reduced(),
        num_layers=L, d_model=d, num_heads=h, num_kv_heads=kv,
        head_dim=d // h, d_ff=ff, vocab_size=vocab,
        param_dtype="float32", compute_dtype="float32",
    )
    return cfg, bsz, seq


def dry_run_qwen():
    """Price one parameter transfer of qwen2-1.5b per channel from the
    parameter tree's shapes on the meta device (nothing allocated)."""
    from repro_torch.models import init_params

    cfg = REGISTRY["qwen2-1.5b"]
    shapes = init_params(cfg, torch.Generator(), device="meta")
    n = sum(t.numel() for t in tree_leaves(shapes))
    print(f"qwen2-1.5b dry run: {n/1e9:.2f}B params (meta tensors, nothing allocated)")
    base = payload_nbytes(None, shapes)
    for name in [None, *sorted(CHANNELS)]:
        b = payload_nbytes(name, shapes)
        print(f"  channel={name or 'None(native)':16s} "
              f"{b/1e9:8.3f} GB/transfer  ({b/base:.4f}x)")


def make_problem(preset, clients, alpha, seed, device=None):
    cfg, bsz, seq = build_cfg(preset)
    return make_fed_lm_problem(cfg, num_clients=clients, per_client_batch=bsz, seq_len=seq,
                               alpha=alpha, seed=seed, device=device)


def run(problem, x0, preset, rounds, channel, eta, local_lr, anchor_prob, local_steps, alpha,
        seed, device=None):
    """One DeepSVRP sweep of one trial on ``(problem, x0)``; returns the `BatchResult`."""
    print(f"model: {problem.dim/1e6:.1f}M params ({preset}); "
          f"{problem.num_clients} clients, alpha={alpha}, channel={channel}")
    spec = RunSpec(
        "deep_svrp",
        grid={"eta": eta, "local_lr": local_lr, "anchor_prob": anchor_prob},
        seeds=[seed],
        x0=x0, x_star=x0,  # unused: FedLMProblem reports metric(x) = mean loss
        static={"num_steps": rounds, "local_steps": local_steps, "channel": channel},
    )
    t0 = time.time()
    res = run_batch(spec, problem, device=device)
    dt = time.time() - t0
    loss = res.dist_sq[0].cpu().numpy()
    by = np.asarray(res.comm_bytes)[0]
    for r in range(rounds):
        print(f"round {r + 1:3d}  loss {loss[r]:.4f}  wire {by[r]/1e6:10.2f} MB")
    print(f"{dt/rounds:.2f}s/round; final loss {loss[-1]:.4f}; "
          f"total wire {by[-1]/1e9:.3f} GB")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="20m")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=HPARAMS["clients"])
    ap.add_argument("--alpha", type=float, default=HPARAMS["alpha"],
                    help="client heterogeneity (lower = more)")
    ap.add_argument("--eta", type=float, default=HPARAMS["eta"])
    ap.add_argument("--local-lr", type=float, default=HPARAMS["local_lr"])
    ap.add_argument("--local-steps", type=int, default=HPARAMS["local_steps"])
    ap.add_argument("--anchor-prob", type=float, default=HPARAMS["anchor_prob"])
    ap.add_argument("--channel", default="quant8", choices=["none", *sorted(CHANNELS)])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--compare", action="store_true",
                    help="run float32 and the channel back to back, print the bytes ratio")
    ap.add_argument("--dry-run-qwen", action="store_true",
                    help="price a qwen2-1.5b transfer per channel (meta tensors)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: cpu-small preset, few rounds, with compare + the qwen dry run")
    args = ap.parse_args(argv)

    if args.quick:
        args.preset, args.rounds, args.compare = "cpu-small", 4, True
        args.dry_run_qwen = True

    if args.dry_run_qwen:
        dry_run_qwen()

    channel = None if args.channel == "none" else args.channel
    hp = (args.eta, args.local_lr, args.anchor_prob, args.local_steps, args.alpha, args.seed)
    problem, x0 = make_problem(args.preset, args.clients, args.alpha, args.seed, args.device)
    res = run(problem, x0, args.preset, args.rounds, channel, *hp, device=args.device)

    if args.compare and channel is not None:
        base = run(problem, x0, args.preset, args.rounds, None, *hp, device=args.device)
        ratio = float(res.comm_bytes[0, -1]) / float(base.comm_bytes[0, -1])
        l0 = float(res.dist_sq[0, 0])
        lk = float(res.dist_sq[0, -1])
        print(f"bytes[{channel}] / bytes[float32] = {ratio:.4f}")
        assert lk < l0, f"loss did not decrease under {channel}: {l0} -> {lk}"
        print(f"loss decreased under {channel}: {l0:.4f} -> {lk:.4f}")
    return res


if __name__ == "__main__":
    main()
