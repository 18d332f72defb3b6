"""Both servers of the PyTorch port, side by side: model decode, then federated rounds.

    PYTHONPATH=src python examples/serve_torch.py                          # on the GPU
    PYTHONPATH=src python examples/serve_torch.py --arch rwkv6-1.6b --tokens 32
    PYTHONPATH=src python examples/serve_torch.py --device cpu             # plain PyTorch

The twin of `examples/serve.py` on `repro_torch`.  The port has two serving
layers that are easy to confuse:

* `repro_torch.launch.serve.BatchServer` — the model DECODE batch server:
  prefill a batch of prompts, then greedy-decode through the family's cache
  (K4 and K5 on the card for the dense family); shown first, on the reduced
  config of ``--arch`` in float32;
* `repro_torch.serve.FedRoundServer` — the federated ROUND server:
  continuous SVRP rounds over a churning client stream (the full version is
  examples/serve_fed_torch.py).

It runs on CUDA unless ``--device`` names another device, and raises when
there is no card.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import BatchServer, ServeConfig
from repro_torch.models import init_params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args()

    cfg = dataclasses.replace(get_config(args.arch).reduced(), param_dtype="float32",
                              compute_dtype="float32")
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    server = BatchServer(cfg, params, ServeConfig(max_batch=args.batch,
                                                  cache_len=args.prompt_len + args.tokens),
                         device=args.device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(0)).tolist()
    t0 = time.perf_counter()
    out = server.generate(prompts, max_new_tokens=args.tokens)
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} family={cfg.family}")
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.batch * args.tokens / max(dt, 1e-9):.1f} tok/s, reduced model)")
    print("sample:", out[0][:16])

    # --- and the OTHER server: continuous federated rounds ----------------
    from repro_torch.core import theorem2_stepsize
    from repro_torch.problems import make_synthetic_quadratic
    from repro_torch.serve import FedRoundServer

    prob = make_synthetic_quadratic(num_clients=10, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1,
                                    device=args.device)
    eta = theorem2_stepsize(1.0, float(prob.similarity()))
    srv = FedRoundServer("svrp", prob, hparams={"eta": eta, "p": 0.2}, device=args.device)
    stats = srv.run(80)
    print("federated round server (svrp, 10 churning clients):")
    print(" ", stats.report())


if __name__ == "__main__":
    main()
