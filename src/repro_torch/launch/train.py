"""Training launcher: DeepSVRP federated rounds on one card (the port of `repro.launch.train`).

    # the card (Qwen2-1.5B at full size, two client cohorts):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --cohorts 2 \\
        --rounds 3 --per-cohort-batch 2 --seq-len 1024

    # the CPU, at the reduced size in float32 (plain kernel versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
        --device cpu --cohorts 2 --rounds 2 --per-cohort-batch 2 --seq-len 32

Wires: config -> the one-card SVRP train step (C cohorts in turn) ->
heterogeneous-client data -> checkpointing.  The reference's ``--mesh DxM``
becomes ``--cohorts C``, its data axis on one card; ``--device`` defaults to
the card.  With ``--ckpt-dir D --ckpt-every N`` the state (``state._asdict()``:
x, w, gbar, the step and the coins' generator) is saved to
``D/ckpt_{round:08d}.npz`` every N rounds (`repro_torch.checkpoint`, the
reference's layout).  As in the reference there is no resume flag; a saved
state comes back with ``restore_checkpoint(D, round, helpers["init_state"]())``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.deep import DeepSVRPConfig
from repro_torch.data import ShardedBatcher, SyntheticLMDataset
from repro_torch.device import full_precision_matmul
from repro_torch.launch.steps import make_svrp_train_step


def main(argv=None) -> list[float]:
    """Run the rounds; returns the loss of every round."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale variant, float32")
    ap.add_argument("--cohorts", type=int, default=1, help="client cohorts, run in turn")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--per-cohort-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--local-lr", type=float, default=0.1)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--anchor-prob", type=float, default=0.0625)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32", compute_dtype="float32")
    n_coh = args.cohorts
    print(f"{cfg.name} on {args.device or 'cuda'}: {n_coh} client cohorts")

    svrp = DeepSVRPConfig(eta=args.eta, local_lr=args.local_lr,
                          local_steps=args.local_steps, anchor_prob=args.anchor_prob)
    full_precision_matmul()  # float32 products in full float32 (the reduced config)
    step, helpers = make_svrp_train_step(cfg, svrp, cohorts=n_coh, device=args.device)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, num_clients=n_coh, alpha=args.alpha,
                            seed=0)
    batcher = ShardedBatcher(ds, num_cohorts=n_coh, per_cohort_batch=args.per_cohort_batch,
                             seq_len=args.seq_len)
    state = helpers["init_state"]()

    losses = []
    t0 = time.time()
    for r in range(1, args.rounds + 1):
        state, metrics = step(state, batcher.next_batch())
        losses.append(float(metrics["loss"]))
        if r % max(args.rounds // 10, 1) == 0 or r == 1:
            print(f"round {r:5d}  loss {losses[-1]:.4f}  {(time.time() - t0) / r:.2f}s/round")
        if args.ckpt_dir and args.ckpt_every and r % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, r, state._asdict())
    print("done.")
    return losses


if __name__ == "__main__":
    main()
