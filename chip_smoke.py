#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100, the CUDA toolkit
(`nvcc`) and PyTorch built for CUDA.  It imports nothing of JAX or `repro`.
It drives eleven paths of the port: the paper's fused sweep (K1, K2), the
engine's registry and sequential substrates with composite SVRP, the lossy
channels and DP-ERM (K1's loop form and K2 where fused), DeepSVRP on a
federated transformer through the engine (K1, K4, K4b), the online round
engine (sessions, a pool, the streaming servers; K1, K4, K4b), dense-transformer
serving on Llama-3.2-3B (K4, K5), hybrid serving on
Zamba2-2.7B (K6, K4, K5), RWKV-6 serving on rwkv6-1.6b (K7), DeepSVRP
training on Qwen2-1.5B (K3, K4, K4b), the AdamW baseline and checkpoints on
Qwen2-1.5B (K4, K4b), int8 weight-only serving of the three families
(K4, K5, K6, K7), and DeepSVRP and AdamW training of Zamba2-2.7B (K6, K6b,
K4, K4b, K3) and rwkv6-1.6b (K7, K7b, K3).
Phases, each printed as one JSON line:

1. device  — `nvidia-smi` name and power limit, torch/CUDA versions, and the
   build of every kernel from `src/repro_torch/kernels/csrc` (one `nvcc` per
   source, all started together) with its ptxas report;
2. parity  — K1, its loop form (a whole quadratic solve in one launch, at
   the svrp and minibatch shapes: R 16 and 64, d 40, 200 steps, on the
   Figure-1 clients) and K2 against their plain PyTorch versions on the
   card at the sweep's shapes, float32 and float64, at the reference's
   tolerances (the loop form at K1_LOOP_TOL), timed with CUDA events beside
   the bound; the loop form running one step fewer (a planted fault) must
   fail its check.  K2 runs through the sweep's indexed entry (16 sampled
   Figure-2 clients' Z and y read in place; its bound counts the distinct
   clients' bytes), launched twice bit for bit, and also through the
   reference's entry on the gathered signed rows; one cluster rank's
   partial gradient dropped (a planted fault) must fail its check; in
   float64 the design's other options are timed beside it (every step
   reading A from L2; clusters of 8 and of 16 blocks); and K2 as the DP-ERM
   fold runs it (the target shifted by eta s, the start y0 = z) against its
   plain version at K2_TOL;
3. main path — `run_batch(..., fused=True, prox_solver="gd")` in float64 on
   the paper's Figure-1 quadratic (M = 1000, d = 40, L = 3330, delta = 10):
   svrp, catalyzed_svrp, svrp_minibatch; and on the Figure-2 a9a-like logistic
   problem (M = 60, n = 2000, d = 123, lambda = 0.1): svrp.  The launch counts
   are zeroed just before and read just after, and each sweep's are exact:
   one K1-loop launch a round for svrp (400) and minibatch (150), none of
   the elementwise K1; Catalyst 36,000 elementwise K1 launches (its shifted
   solves, one a GD step); the logistic svrp one K2 launch a round (300).
   Each sweep's first 20 rounds are later replayed on the CPU (plain
   versions) with the same injected draws: comm must be equal and dist_sq
   within rtol 1e-9;
4. profile — the first 20 rounds of each sweep again under torch.profiler:
   host wall time, device busy time and idle share, the top kernels;
5. engine — the registry and sequential substrates, which launch none of
   the sweep kernels (counted: every count must stay 0): the quickstart
   twin (examples/quickstart_torch.py) at its full horizons (SVRP 4000,
   SVRG and SGD 40,000 rounds; SVRP's final dist_sq <= 1e-28 and SVRG's
   comm to 1e-10 more than 10x SVRP's); `run_batch(fused=False)` with 8
   seeds for every ported algorithm on the Figure-1 quadratic (sppm, svrp,
   minibatch and Catalyst with the exact, spectral and gd solvers; sgd,
   svrg, scaffold; dane and acc_extragradient over 8 values of theta, being
   deterministic) and svrp with newton on the Figure-2 logistic, each
   timed (rounds/s); each sweep's first 20 rounds replayed on the CPU with
   the same draws (comm equal, dist_sq within rtol 1e-9); `run_sequential`
   against the lane batch for the exact-solver and baseline sweeps
   (ENGINE_PATH_TOL); the fused path (K1's loop form, 400 launches)
   against the registry gd path for svrp (ENGINE_FUSED_RTOL); a planted
   fault, a refresh that keeps the stale anchor gradient, which the CPU
   replay check must reject; and svrp (exact, newton) under the profiler;
6. engine, this slice's — composite SVRP (Algorithm 4, FISTA's joint prox;
   no kernel) with the l1, box and l2-ball regularizers on Figure 1, each
   binding at its solution (20,000 proximal-gradient steps), 8 seeds, 200
   rounds; svrp through the quant8, cast and cast16 channels on Figure 1,
   registry (exact) and fused (K1's loop form, once a round), 400 rounds;
   svrp on the DP-ERM a9a problem (Figure 2's shape, sigma 1, clip 1),
   fused (K2 with the noise folded into its target and y0 = z, once a
   round) and registry gd, 100 rounds, the two within ENGINE_FUSED_RTOL.
   Every sweep timed, its first 20 rounds replayed on the CPU (comm and
   comm_bytes equal, dist_sq rtol 1e-9); the planted fault, K2 without the
   noise fold, must fail that replay;
7. deep — K1 at the 20m sweep's rows (8 x 15,733,632 float32, bit for bit
   its plain version), K4 and K4b in float32 at Dh 64 at each preset's
   attention shape against their plain versions (K4b's skipped-tile fault
   must fail), each timed beside its bound; then DeepSVRP on the federated
   transformer (examples/fed_transformer_torch.py's presets and
   hyperparameters: eta 1, local_lr 0.2, 2 local steps, anchor_prob 0.25;
   4 clients, 2 trials), at full width and depth in float32.  20m (15,733,632 parameters, 6 layers,
   6/2 heads of Dh 64, vocab 8192, 2 x 128 tokens a client): 8 rounds of
   `run_batch("deep_svrp")` fused and registry, on identity and quant8;
   each sweep's K1 (one launch a local step), K4 and K4b launches counted
   and held to the formula derived from the round (`deep_expected`,
   printed beside the count), its seconds a round and peak memory; fused
   and registry bit for bit; the loss falling on both channels; quant8's
   bytes <= 0.27x float32's; the first 2 rounds replayed on the CPU (plain
   K1, K4, K4b; ROUND_TOL); the planted fault (the local loop starting from
   z) must fail that replay; one round under the profiler.  100m
   (124,668,672 parameters, 12 layers, 12/4 heads, vocab 32000, 4 x 256
   tokens a client): 3 rounds fused, then 2 rounds fused and registry, bit
   for bit, each timed and counted;
8. online — the online round engine (`repro_torch.serve`; no new kernel):
   on the Figure-1 quadratic (float64, 8 seeds, the exact prox) a session
   stepped 1 + 49 + 150 rounds must equal `run_batch` over the same record
   bit for bit, and a planted session that draws its record again at each
   `step` must not; `run_batch(stop_eps=1e-8)` over 1000 rounds must stop
   each trial at its first crossing in the full run; a `SessionPool` of four
   tenants (four Figure-1 draws, etas and horizons, one with stop_eps 1e-6)
   served by `FedRoundServer(pool=...)`: each lane within 1e-5 of its
   standalone session with comm and bytes exact, the stop_eps tenant frozen
   early, launches a tick beside a session's round, and a planted pool that
   keeps stepping a frozen lane must fail the frozen-lane gate;
   `FedRoundServer` for svrp and svrp_minibatch (cohorts of 10) under
   `ClientStream(churn=0.1)`, 500 rounds each (rounds/s, p50/p95/p99,
   GFLOP/s), their first 20 rounds equal to the same servers on the CPU
   (comm exact, dist_sq rtol 1e-9); then on the 20m federated LM a
   deep_svrp session stepped 1 + 2 rounds equal to `run_batch` (registry)
   over the same coins bit for bit, both with the exact K1 / K4 / K4b
   counts of `deep_expected`, and a `FedRoundServer("deep_svrp")` for 3
   rounds with its counts derived from its own refresh rounds;
9. attention parity — K4 (flash attention) and K5 (decode attention) against
   their plain versions at the serving path's shapes (K4: Llama prefill,
   bf16 and float32, causal; and small sliding-window, non-causal and head
   dim 80 / 64 cases, each with the route it took: wgmma + TMA for bf16 at
   Dh 64 and 128; on two of them the wgmma route dropping its last key
   tile, a planted fault, must fail; K5: B = 8, S = 4096, q bf16 against float32 and bf16
   caches, prefix and ring-buffer masks), at the reference's tolerances (K5
   also at a limit scaled to its output, K5_BF16_SCALED, which two planted
   faults must fail), timed with CUDA events beside the bound, the plain
   version and one `scaled_dot_product_attention` call (the yardstick; the
   port never calls it);
10. serving — Llama-3.2-3B at full width and depth in bf16, weights from seed
   0 on the card: `make_prefill_step` on 4 x 2048 tokens and
   `BatchServer(max_batch=8, cache_len=1024).generate` on 8 ragged prompts
   (128-512 tokens) with 64 greedy tokens each.  The K4 / K5 counts are
   zeroed before and read after each run: K4 must launch once a layer per
   prefill call, K5 once a layer per decode step.  Both are then replayed
   with the plain attention on the card (the decode teacher-forced on the
   served tokens) and every step's logits compared (SERVE_REL_TOL), and with
   a planted attention fault, which must exceed that limit;
11. serving profile — one prefill call and 16 decode steps under
   torch.profiler;
12. ssm parity — K6 (the Mamba-2 scan) against its plain version at Zamba2's
   prefill shape (B 4, T 2048, 80 heads, P 64, N 64; x, B and C as column
   views of one tensor, as the model hands them) in bf16 (the tensor-core
   route) and float32 (the FMA route), timed beside its bound and the plain
   version; and at
   T = 1000 (off the chunk), with a given state0, under strong decay
   (A = -16, dt in [0.5, 4]), at the reduced P 128 / N 16, with an odd head
   count, with x, B and C at an inner stride of 2 (the
   tensor-core route's plain-load staging), and against the sequential
   recurrence at T <= 256: bf16 at the reference's tolerance element by
   element, float32 at its 2e-4 in relative L2 against the plain version and
   a float64 recurrence (see k6_verdict); two planted faults must fail: the
   state not carried across chunks, and (bf16) the tensor-core route
   leaving out the low bf16 parts of its split operands;
13. hybrid serving — Zamba2-2.7B at full width and depth in bf16, weights from
   seed 0 on the card with LoRA b, conv_b and D randomised (zeros and ones at
   init hide a wrong wiring): `make_prefill_step` on 4 x 2048 tokens (K6 45
   times and K4 9 times a call) and `BatchServer(max_batch=8,
   cache_len=1024).generate` on the 8 prompts with 64 greedy tokens each (K5
   9 times a step, K6 never: decode is the one-step recurrence).  The prefill
   is replayed at every position with the plain scan and attention on the
   card (SERVE_REL_TOL) and with a planted K6 fault, and again with the
   same weights in float32 (HYBRID_F32_REL_TOL), where the fault must
   exceed the limit; the decode is replayed teacher-forced with the plain
   attention, and with a planted K5 fault;
14. hybrid profile — one prefill call and 16 decode steps under
   torch.profiler;
15. hybrid paths — the reduced zamba2 in float32: the prefill step (K6, K4)
   against teacher-forced decode (K5) at the last of 200 tokens
   (RECURRENT_PATHS_REL_TOL), and the planted K6 fault beyond it.  Phases
   11-13 and 15-17 run the same functions (phase_recurrent_serving,
   phase_serving_profile, phase_recurrent_paths) on each family's record
   (HYBRID_FAMILY, RWKV_FAMILY);
16. rwkv parity — K7 (the RWKV-6 WKV scan) against its plain version at
   rwkv6-1.6b's prefill shape (B 4, T 2048, 32 heads, K = V = 64) and decode
   shape (B 8, T 1, the state written over state0 as decode runs it) in
   bf16 and float32, timed beside the bound and the plain version (at
   decode the time is the wrapper's host time: back-to-back calls); and at
   T = 1000 (off the 32-step tile), at T = 300 written over state0, under
   strong decay (w in [0.03, 0.07]) and at the reference's small
   shapes (K 8, 16, 32): bf16 at the reference's tolerance element by
   element, float32 at its 1e-4 in relative L2 against the plain version
   and a float64 recurrence (see k7_verdict).  Three planted faults must
   fail: the state not carried across tiles, the bonus u dropped, state0
   ignored;
17. rwkv serving — rwkv6-1.6b at full width and depth in bf16
   (1,583,941,632 parameters), weights from seed 0 on the card with w0,
   w_b and u randomised (at init the decay is nearly one constant):
   `make_prefill_step` on 4 x 2048 tokens (K7 24 times a call) and
   `BatchServer(max_batch=8).generate` on the 8 prompts with 64 greedy
   tokens each (K7 24 times a decode step, T = 1 from the carried state,
   which it overwrites).
   The prefill is replayed at every position with the plain scan on the
   card (SERVE_REL_TOL) and with the planted no-carry fault, and again with
   the same weights in float32 (RWKV_F32_REL_TOL); the fault must exceed
   both limits; the decode is replayed teacher-forced with the plain scan,
   and with K7 ignoring state0, which must exceed SERVE_REL_TOL;
18. rwkv profile — one prefill call and 16 decode steps under
   torch.profiler;
19. rwkv paths — the reduced rwkv6 in float32: the prefill step against
   teacher-forced decode at the last of 200 tokens (RECURRENT_PATHS_REL_TOL),
   and the planted no-carry fault beyond it;
20. train parity — K3 (the DeepSVRP tree step) over the whole bf16
   Qwen2-1.5B tree in one launch and over small f32 / f64 trees; K4's output
   and log-sum-exp at Qwen2's group of 6; K4b (the attention backward) in bf16 and f32 at the
   training shape (B 2, S 1024, 12/2 heads, Dh 128, causal) and at a
   sliding-window, a q_offset (Sq != Skv), a no-key-rows and Dh 80 / 64
   case, with groups of 6 and of 1 at Dh 64 and 128 (bf16 there takes the
   wgmma + TMA route, Dh 80 the mma.sync one); each against its plain
   version on the card, timed beside its bound and (K4b) SDPA's forward +
   backward, with two launches of the wgmma route compared (dK and dV bit
   for bit, dQ's spread in relative L2); two planted K4b faults must fail
   the check: the first 64-key tile skipped, and one query head of each
   group left out of dK and dV (the wgmma route's group sum);
21. train — `make_svrp_train_step` on Qwen2-1.5B at full width and depth in
   bf16 (weights from seed 0 on the card), C = 2 cohorts of 2 x 1024 tokens
   from `SyntheticLMDataset` (vocab 151936, 2 clients, alpha 0.5, seed 0),
   K = 4, eta 1.0, local_lr 0.1, 3 rounds with the coins [1, 0, 1]; the
   counts are zeroed before and read after: K3 C K a round, K4 and K4b one
   a layer in each of the round's C (1 + K) + C refresh forward and
   backward passes; the loss finite;
22. train replay — round 1 again from the same state with the plain K3 and
   the plain attention forward and backward on the card, compared with the
   kernels' run where both runs share a point: the cohort-mean gradient at
   x0 and the loss there (TRAIN_GRAD_REL_TOL, TRAIN_LOSS_REL_TOL) and the
   round's update x' - x0 (TRAIN_UPDATE_REL_TOL); two planted faults (K4b
   skipping its first key tile, K3 with inv_eta 0) must exceed them;
23. train reduced — the reduced qwen2 in float32 through K3, K4 and K4b in
   float32: 10 rounds on 4 cohorts must bring the loss below 0.7 of its
   first value (the reference test's property);
24. train profile — one plain round under torch.profiler;
25. optim — `make_adamw_train_step` on Qwen2-1.5B at full size in bf16
   (float32 moments), the training phase's batch (4 x 1024) in one pass,
   lr 3e-4, clip 1.0, 3 steps: K4 and K4b 28 times a step, exact; the loss
   finite and falling; ms a step, tokens/s, peak memory.  The AdamW state
   saved, restored onto the card and compared bit for bit (bytes, seconds).
   Step 1 replayed with the plain attention (TRAIN_LOSS_REL_TOL on the loss,
   TRAIN_GRAD_REL_TOL on the gradient norm and the float32 first moment),
   which the planted K4b fault must exceed on the moment; the reduced qwen2
   in float32, 3 steps on the card against the CPU (OPTIM_REDUCED_REL_TOL),
   which AdamW without its bias correction must exceed; the DeepSVRP state
   after two rounds saved and restored bit for bit, then a round from each
   (the loss at w bit for bit, x' within CKPT_ROUND_REL_TOL);
26. quant — int8 weight-only serving (`repro_torch.quant`): Llama-3.2-3B
   int8 at most QUANT_BYTES_RATIO of bf16's bytes; prefill 4 x 2048 (K4 28 a
   call) within QUANT_LOGIT_GAP of the bf16 logits, which a planted
   dequantisation fault must exceed; `BatchServer(quantize=True).generate`
   on the serving prompts (K5 28 a step) with a lower peak than bf16's in
   the same run, both decode times, the greedy tokens' agreement; the int8
   prefill replayed with the plain attention (SERVE_REL_TOL).
   Zamba2-2.7B and rwkv6-1.6b int8: prefill 4 x 2048 (K6 45 + K4 9; K7 24),
   every position replayed with the plain versions, a 2-prompt generate of
   16 tokens, their bytes and logit gaps; the reduced llama3.2, zamba2 and
   rwkv6 in float32, int8 on the card against the CPU
   (QUANT_REDUCED_REL_TOL);
27. recurrent bwd parity — K6b and K7b (the scans' backwards) against
   their plain backwards on the card at each family's training shape
   (Zamba2: B 2, T 1024, H 80, P 64, N 64; rwkv6: B 2, T 1024, H 32, K 64),
   bf16 and float32, the relative L2 of every gradient within K6B_REL_TOL /
   K7B_REL_TOL, timed beside the bound and the plain backward, two launches
   bit for bit; smaller cases with state0 and a final-state cotangent
   (P 128 / N 16; strong and weak decay); K4b at Zamba2's attention shape
   (2 x 1024, 32/32 heads, Dh 80, bf16); planted faults that must fail: K6b
   without the carry between chunks, K7b's dw from S_t, K7b skipping one
   tile's recompute;
28. hybrid / rwkv train — `make_svrp_train_step` on Zamba2-2.7B and
   rwkv6-1.6b at full width and depth in bf16 (seed-0 weights), TRAIN's
   settings for 2 rounds (C 2 cohorts of 2 x 1024, K 4, coins [1, 0]; 1 x
   1024 a cohort if 2 x 1024 does not fit, said in a line): ms a round, trained
   tokens/s, peak memory; exact counts: K6 and K6b 45, K4 and K4b 9 a pass
   (Zamba2), K7 and K7b 24 a pass (rwkv6), K3 2 C K a round (two dtype
   groups: the float32 A_log, dt_bias, D, w0, u);
29. their profiles — one plain round each under torch.profiler (device
   activity only);
30. their replays — round 1 again with the plain K3, attention and scans
   (forward and backward) on the card (at RTRAIN_REPLAY_SEQ tokens a row),
   the gradient at x0, the loss and the update against the kernels' run at
   the training replay's limits (bf16 hides the planted backward faults
   there: they are held in float32 below);
31. their AdamW — 2 steps of `make_adamw_train_step` at full size on the
   4 x 1024 batch in one pass: ms a step, peak memory, exact counts;
32. their reduced checks — the reduced models in float32: one DeepSVRP
   round and 3 AdamW steps on the card against the CPU
   (RTRAIN_REDUCED_REL_TOL), and the round with the planted backward fault,
   which must exceed it;
33. their federated LM — 2 rounds of `run_batch("deep_svrp")` (fused, 2
   trials) on a `FedLMProblem` over the reduced models, exact counts, the
   loss against the CPU's (RTRAIN_FEDLM's rel_tol) and comm equal;
34. the `kernels` line (eleven rows: K1, its loop form, K2-K7, K4b, K6b and
   K7b), then the `ok` line.

Any failed check exits non-zero before the `ok` line.  Without CUDA, or
without the repository beside it, the script exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM: float32 / float64 outside the tensor cores, bf16 on them (dense)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
K1_TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "float64": dict(rtol=1e-12, atol=0.0)}
# K1's loop form (a whole quadratic solve in one launch) against its plain
# version: the update rounds as K1's does, but each step's matvec sums in
# another order than cuBLAS, about one unit roundoff of |y| a step (beta ~ 1/L
# cancels A's scale), carried at most num_steps times by the contracting
# iteration (2.4e-5 in f32, 4.4e-14 in f64 at 200 steps).  Its planted fault
# (one step fewer) moves y by beta |grad phi|, far above the f64 limit.
K1_LOOP_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "float64": dict(rtol=1e-11, atol=1e-11)}
K2_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-12, atol=1e-13)}
# The reference's: tests/test_kernels_attention.py:_tol, tests/test_kernels_decode.py.
K4_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
K5_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# K5 with a bf16 operand is also held to a limit scaled to its output: at the
# serving shape (3001 valid rows of unit-normal K/V) the output's RMS is ~0.03,
# the size of the reference's 3e-2 itself.  K5 and its plain version compute
# in float32 from the same values and differ where the output rounds to bf16:
# by at most one bf16 ulp at any element, <= 2^-7 of the output's largest
# magnitude, and by at most 2^-7 (twice the unit roundoff) in relative L2.
K5_BF16_SCALED = 2.0**-7
# Planted faults the K5 check must reject: the rows of one of the kernel's
# 16 half-warp streams (U = 4 rows a step at G <= 4), and one valid row.
K5_STREAM_ROWS, K5_STREAMS = 4, 16
CPU_REPLAY_ROUNDS = 20
CPU_REPLAY_RTOL = 1e-9
# The engine path (run_batch(fused=False), run_sequential): 8 trials a
# sweep; the quickstart twin's gates (examples/quickstart.py's claim: SVRP
# at machine precision, SVRG's comm to 1e-10 over 10x SVRP's);
# run_sequential against the lane batch
# at the CPU tests' per-solver tolerances (tests/test_torch_registry.py);
# the fused path (K1's loop form) against the registry gd path; the planted
# stale-refresh fault's refresh probability (p = 1/M would rarely refresh in
# CPU_REPLAY_ROUNDS rounds).
ENGINE_SEEDS = 8
QUICKSTART_SVRP_MAX = 1e-28
QUICKSTART_RATIO = 10.0
ENGINE_PATH_TOL = {"exact": dict(rtol=1e-6, atol=1e-24), "gd": dict(rtol=1e-6, atol=1e-24),
                   "spectral": dict(rtol=1e-4, atol=1e-20), "newton": dict(rtol=1e-4, atol=1e-20)}
ENGINE_FUSED_RTOL = 1e-9
ENGINE_FAULT_P = 0.25
# The engine's composite, channel and DP-ERM sweeps: composite SVRP with the
# l1 (weight COMPOSITE_L1), box and l2-ball regularizers on Figure 1, each
# binding at its solution (box and ball at half the unconstrained
# minimizer's largest entry and norm), the solution by COMPOSITE_PGD_STEPS
# proximal-gradient steps; svrp through each lossy channel on Figure 1; svrp
# on the DP-ERM a9a problem (Figure 2's shape, sigma 1, clip 1).
COMPOSITE_L1 = 0.01
COMPOSITE_PGD_STEPS = 20000
COMPOSITE_ROUNDS = 200
CHANNEL_ROUNDS = 400
DP_ROUNDS = 100
# DeepSVRP on the federated LM (examples/fed_transformer_torch.py's presets
# and hyperparameters): 2 trials (seeds), 4 clients.  The 20m sweeps run
# fused and registry on identity and quant8; their first DEEP_REPLAY_ROUNDS
# rounds are replayed on the CPU with the plain versions and the same coins,
# the loss held to the float32 round tolerance of the CPU tests
# (tests/_torch_replay.py ROUND_TOL) and comm and comm_bytes equal.  Fused
# against registry on the card: bit for bit, comm and comm_bytes equal (the
# two share the local solver's binding, and the float32 gradient sums in a
# fixed order: K4b's float32 route has no atomics, and the embedding's
# backward, an accumulating index_put_, sorts its indices on CUDA; read bit
# for bit on an H100 80GB HBM3 at 700 W at both presets).  quant8's bytes at most DEEP_BYTES_RATIO
# of float32's, with the loss falling on both channels.
DEEP_HP = dict(eta=1.0, local_lr=0.2, local_steps=2, anchor_prob=0.25)
DEEP_CLIENTS, DEEP_SEEDS, DEEP_ALPHA = 4, 2, 0.3
DEEP_ROUNDS = {"20m": 8, "100m": 3}
DEEP_REPLAYED = ("20m",)  # the presets with the four sweeps, CPU replay and fault
DEEP_PATH_ROUNDS = 2  # the other presets: fused against registry over this many
DEEP_REPLAY_ROUNDS = 2
DEEP_REPLAY_TOL = dict(rtol=1e-4, atol=1e-6)
DEEP_BYTES_RATIO = 0.27
# Serving: kernel run against the plain-attention replay, per step, as
# ||logits - plain||_2 / ||plain||_2.  Both runs are bf16 and differ only in
# the attention arithmetic (K4 rounds P to bf16 before P V; K5 sums in
# another order).  Read on an H100 80GB HBM3 at 700 W: decode median 1.07e-2,
# max 1.37e-2; prefill 1.91e-2.  The replay also plants one attention fault
# each, and fails unless each exceeds this limit; on the same card they read
# 1.22 (prefill, K4 skipping its first 64-key tile) and 9.1e-2 at the least,
# 1.56e-1 at most (64 decode steps, K5 dropping one half-warp stream's rows).
SERVE_REL_TOL = 5e-2
# Training.  K3: the reference's tolerances (tests/test_kernels_prox.py:146-177).
K3_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=1e-6, atol=1e-6),
          "float64": dict(rtol=1e-12, atol=0.0)}
K4_LSE_ATOL = 1e-5
# K4b: float32 the reference's gradient tolerance (tests/test_kernels_attention.py:59-78);
# bf16 max abs <= K4B_BF16_REL max|plain| and relative L2 <= K4B_BF16_REL.
K4B_F32_TOL = dict(rtol=5e-4, atol=5e-5)
K4B_BF16_REL = 2e-2
TRAIN = dict(arch="qwen2-1.5b", cohorts=2, per_cohort_batch=2, seq_len=1024, local_steps=4,
             eta=1.0, local_lr=0.1, coins=(True, False, True))
# Round 1 with the kernels against its replay with the plain K3 and plain
# attention (forward and backward) on the card, at points both runs share:
# the cohort-mean gradient at x0 (relative L2, float32) with the loss there,
# and the round's update x' - x0 (relative L2).  Read on an H100 80GB HBM3 at
# 700 W: two kernel runs agreed bit for bit until K4b's wgmma route, whose dQ
# sums across key tiles in no fixed order (two runs now read ~9e-3 on the
# gradient, 0 on the loss); the plain run reads 2.9e-2 on the
# gradient (worst leaf 3.6e-2), 2.8e-5 on the loss and 1.17 on the update,
# which in bf16 at lr 0.1 is made of rounding flips (0.13 in L2 over 1.78e9
# weights; K3 rounds once from float32, the plain version after every
# operation, so they flip different weights).  The planted faults read 0.61
# (K4b skipping its first key tile, on the gradient) and 6.36 (K3 with
# inv_eta 0, on the update).  Each limit sits between the two.
TRAIN_GRAD_REL_TOL = 0.1
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_UPDATE_REL_TOL = 2.5
# Hybrid serving.  K6: the reference's tolerances (tests/test_kernels_scans.py:53-59).
K6_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
K6_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
K6_CHUNK = 64  # K6's chunk (csrc/ssm_scan.cu kQ): the planted fault drops the state there
HYBRID = dict(arch="zamba2-2.7b", prefill=(4, 2048), max_batch=8, cache_len=1024, new_tokens=64)
# The reduced zamba2 and rwkv6 in float32 on the card, prefill (the scan over
# the sequence; zamba2 also K4) against teacher-forced decode (zamba2: the
# one-step recurrence and K5; rwkv6: K7 one step at a time from the carried
# state) at the last of 200 tokens, relative L2 of the logits: the float32
# model tolerance of the CPU tests (tests/test_torch_hybrid.py,
# tests/test_torch_rwkv.py), where the two paths read ~1e-6.
RECURRENT_PATHS_REL_TOL = 1e-4
# Zamba2-2.7B's prefill (every position's logits), kernels against the plain
# scan and attention, relative L2.  bf16 is held to SERVE_REL_TOL.  There the
# model's own rounding moves the logits by a few percent (the CPU tests read
# 1.6-3.1% between bf16 and float32 on the reduced model), as much as the
# planted K6 fault does (a dropped carry changes the few positions that open
# a chunk), so the fault is held in float32 with the same weights, where
# two right runs differ by rounding alone.
HYBRID_F32_REL_TOL = 1e-3
# RWKV-6 serving.  K7: the reference's tolerances (tests/test_kernels_scans.py:27-35):
# bf16 element by element; float32 in relative L2 against the plain version
# and a float64 recurrence (see k7_verdict).
K7_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
K7_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
K7_TILE = 32  # K7's tile (csrc/rwkv6_scan.cu kTile): the planted fault drops the state there
RWKV = dict(arch="rwkv6-1.6b", prefill=(4, 2048), max_batch=8, cache_len=1024, new_tokens=64)
# rwkv6-1.6b's prefill (every position's logits), kernels against the plain
# scan, relative L2.  bf16 is held to SERVE_REL_TOL, where the model's own
# rounding moves the logits by a few percent; float32 with the same weights,
# where two right runs differ by float32 rounding alone, to this limit.  Read
# on an H100 80GB HBM3 at 700 W: bf16 3.97e-2, float32 1.00e-5; the planted
# fault (the state not carried across K7's 32-step tiles) 1.31 in both, so
# it is held in both.
RWKV_F32_REL_TOL = 1e-3
# The AdamW baseline (`make_adamw_train_step`) on Qwen2-1.5B at full size:
# the training phase's batch in one pass, lr 3e-4, clip 1.0, 3 steps.  Its
# replay (step 1 with the plain attention on the card) is held to the
# training replay's limits: the loss to TRAIN_LOSS_REL_TOL, the gradient
# norm and the float32 first moment (a tenth of the clipped gradient after
# one step) to TRAIN_GRAD_REL_TOL in relative L2, which the planted K4b
# fault must exceed on the moment.  The reduced qwen2 in float32, 3 steps
# on the card against the same 3 on the CPU (plain versions): the
# parameter tree within OPTIM_REDUCED_REL_TOL in relative L2, the CPU
# tests' per-leaf limit (tests/test_torch_optim.py: float32 summation
# order, which Adam amplifies only at gradient elements as small as eps);
# the planted fault, AdamW without its bias correction (first steps of
# ~0.45 lr instead of lr), must exceed it.  Read on an H100 80GB HBM3 at
# 700 W: the plain replay 8.8e-6 on the loss, 0 on the bf16 norm, 2.87e-2
# on mu, the K4b fault 0.64 on mu; card against CPU 1.72e-6, the optimizer
# fault 3.76e-3.
OPTIM = dict(lr=3e-4, clip=1.0, steps=3)
OPTIM_REDUCED_REL_TOL = 1e-5
# Checkpoints at full size: the DeepSVRP state after 2 rounds (coins 1, 0:
# x and w differ, gbar is nonzero) and the AdamW state after its 3 steps,
# each saved, restored onto the card and compared bit for bit.  Then one
# round (coin 0) from the live state and one from the restored state: the
# loss at w bit for bit (K4's forward is deterministic), x' within
# CKPT_ROUND_REL_TOL in relative L2 (K4b's dQ sums in no fixed order, and
# bf16 rounds what differs to whole ulps; read on an H100 80GB HBM3 at
# 700 W: 1.37e-4).
CKPT_ROUND_REL_TOL = 1e-3
# int8 weight-only serving (`repro_torch.quant`) at full size: the int8 tree
# at most QUANT_BYTES_RATIO of the bf16 one (int8 values and float32
# scales; norms and biases stay bf16); the int8 model's last-position
# prefill logits within QUANT_LOGIT_GAP of the bf16 model's, as max |a - b|
# / max |b|, the reference's own bound (tests/test_quant.py:56-61), which a
# planted dequantisation fault (every column scaled by its matrix's first
# column's scale) must exceed.  The int8 tree replayed with the plain
# versions: SERVE_REL_TOL.  The reduced models in float32, int8 on the card
# against the CPU: QUANT_REDUCED_REL_TOL in relative L2 (float32 summation
# order; the quantized trees are equal bit for bit).  Read on an H100 80GB
# HBM3 at 700 W: Llama's gap 7.1e-2, the planted fault 0.72; the plain
# replays 1.9e-2 (Llama), 3.4e-2 (Zamba2), 3.9e-2 (rwkv6); card against CPU
# at most 1.9e-6.
QUANT_BYTES_RATIO = 0.51
QUANT_LOGIT_GAP = 0.12
QUANT_REDUCED_REL_TOL = 1e-5
QUANT_SHORT = dict(prompts=2, prompt_len=64, new_tokens=16)  # the recurrent families' generate
# Recurrent training.  K6b and K7b against their plain backwards on the
# card: the relative L2 of every gradient.  Read on an H100 80GB HBM3 at
# 700 W: K6b at most 1.1e-5 (f32) and 5.9e-5 (bf16: dx, dB and dC rounded
# to bf16 in both), its planted fault (no carry) 0.04-0.14 on dx, ddt, dA
# and dB; K7b at most 8.5e-7 (f32) and 3.3e-5 (bf16), its planted faults
# 1.0 (dw from S_t) and 0.25 (a tile not recomputed) on dw.
K6B_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
K7B_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
RTRAIN_SSM_SHAPE = (2, 1024, 80, 64, 64)  # Zamba2's training shape (B, T, H, P, N)
RTRAIN_RWKV_SHAPE = (2, 1024, 32, 64)  # rwkv6-1.6b's (B, T, H, K)
RTRAIN_ATTN_SHAPE = (2, 1024, 1024, 32, 32, 80)  # Zamba2's attention (B, Sq, Skv, H, KVH, Dh)
# DeepSVRP at full width and depth: the training phase's settings, for 2
# rounds (a refresh and a plain one) to keep the script inside its time.
RTRAIN = {**{k: v for k, v in TRAIN.items() if k != "arch"}, "coins": (True, False)}
# Round 1 replayed with the plain versions on the card, at the training
# replay's limits (TRAIN_*_REL_TOL), on the first RTRAIN_REPLAY_SEQ tokens
# of every row: four of K6b's 64-step chunks (Zamba2) and two of K7b's
# 32-step tiles (rwkv6), so both backwards carry their state across a chunk
# or a checkpoint.  The plain WKV scan steps one token at a time from the
# host (~100 launches a step and layer, forward and backward), the plain
# attention backward forms whole score matrices.  Read on an H100 80GB
# HBM3 at 700 W at these lengths: the plain run 5.1e-2 / 7.7e-2 on the
# gradient, 6.3e-6 / 3.5e-5 on the loss, 0.78 / 0.31 on the update.  The
# planted backward faults (K6b without the carry, K7b's dw from S_t) moved
# the gradient by only 1.9e-2 / 2.3e-2 at 1024 / 256 tokens (worst leaf
# 0.14 / 0.13): bf16 rounding hides them, so they are held in float32 on the
# reduced models (`phase_recurrent_reduced`), as the serving phases hold
# K6's.
RTRAIN_REPLAY_SEQ = {"hybrid": 256, "rwkv": 64}
# The reduced models in float32, card against CPU: one DeepSVRP round and 3
# AdamW steps, relative L2 of the parameters (and gbar, the loss).
RTRAIN_REDUCED_REL_TOL = {"hybrid": 1e-4, "rwkv": 1e-5}
RTRAIN_ADAMW_STEPS = 2
RTRAIN_FEDLM = dict(clients=3, batch=2, seq=64, rounds=2, local_steps=2, seeds=2,
                    anchor_prob=0.5, rel_tol=1e-4)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


CARD = None  # `nvidia-smi` name and power limit, set by phase_device


def emit(obj) -> None:
    """One JSON line; a phase's line carries the card it was measured on."""
    if "phase" in obj and CARD is not None:
        obj = {**obj, "card": CARD}
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
    """Device time (us) and launch count of every kernel in a profiler trace,
    read from the raw trace: building the profiler's event list
    (``prof.events()``) takes seconds for a training round's ~10^5 kernels."""
    import torch

    out: dict[str, tuple[float, int]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            t, c = out.get(e.name(), (0.0, 0))
            out[e.name()] = (t + e.duration_ns() / 1e3, c + 1)
    return out


def _spin(n: int = 16) -> None:
    """``n`` tiny device kernels (at::cuda::sleep's ``spin_kernel``), synchronised."""
    import torch

    for _ in range(n):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def profiled(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler: (host wall ms, kernel times).

    The profiler loses a few device events at the edges of a session (10
    calls of K4 read as 5), so throwaway spin kernels pad both edges, outside
    the timed window, and are left out of the kernel times.  It records
    device activity alone: the kernel times are all it returns, and host-side
    op events (~10^5 in a training round) would take the profiler tens of
    seconds to gather and stretch the timed window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spin()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _spin()
    kernels = kernel_times_us(prof)
    return wall_ms, {k: v for k, v in kernels.items() if "spin_kernel" not in k}


def device_ms(fn, reps: int) -> float | None:
    """Device time per call of ``fn``: every kernel it launches, summed
    (profiler); None when the profiler saw no device activity."""
    _, kernels = profiled(fn, reps)
    if not kernels:
        return None
    return sum(t for t, _ in kernels.values()) / reps / 1e3


# module of each kernel wrapper under repro_torch.kernels
WRAPPERS = {"prox_update": "prox_update", "prox_update_batched": "prox_update",
            "quadratic_prox_gd_batched": "prox_update",
            "logistic_prox_gd_batched": "logistic_prox", "flash_attention": "flash_attention",
            "flash_attention_bwd": "flash_attention", "decode_attention": "decode_attention",
            "ssm_scan": "ssm_scan", "rwkv6_scan": "rwkv6_scan", "ssm_scan_bwd": "ssm_scan",
            "rwkv6_scan_bwd": "rwkv6_scan"}
SERVE_KERNELS = ("flash_attention", "decode_attention")
TRAIN_KERNELS = ("prox_update", "flash_attention", "flash_attention_bwd")
HYBRID_KERNELS = ("ssm_scan", "flash_attention", "decode_attention")
RWKV_KERNELS = ("rwkv6_scan",)
SWEEP_KERNELS = ("quadratic_prox_gd_batched", "prox_update_batched", "logistic_prox_gd_batched")
DEEP_KERNELS = ("prox_update_batched", "flash_attention", "flash_attention_bwd")
ADAMW_KERNELS = ("flash_attention", "flash_attention_bwd")
HYBRID_TRAIN_KERNELS = ("ssm_scan", "ssm_scan_bwd", "flash_attention", "flash_attention_bwd")
RWKV_TRAIN_KERNELS = ("rwkv6_scan", "rwkv6_scan_bwd")
PATHS = ("sweep", "engine", "deep", "online", "serving", "hybrid", "ssm", "training", "optim",
         "quant", "recurrent_train")


def _wrapper(name):
    import importlib

    return getattr(importlib.import_module(f"repro_torch.kernels.{WRAPPERS[name]}"), name)


def launch_counts(names) -> dict:
    return {name: _wrapper(name).launches for name in names}


def zero_launch_counts(names) -> None:
    for name in names:
        _wrapper(name).launches = 0


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
    """Native draws for a sweep (seed-major trials, as `with_seeds` orders
    them); None for a deterministic algorithm."""
    import numpy as np

    from repro_torch.core import draw_schedule
    from repro_torch.experiments import ALGOS
    from repro_torch.experiments.grid import grid_size

    if ALGOS[kw["algo"]].deterministic:
        return None
    seeds = np.repeat(np.arange(kw["seeds"]), grid_size(kw["grid"]))
    p = kw["grid"].get("p")
    if kw["algo"] == "catalyzed_svrp":
        return draw_schedule(seeds, M, kw["inner_steps"], p, num_outer=kw["num_outer"])
    rounds = kw["num_steps"] if "num_steps" in kw else kw["num_rounds"]
    return draw_schedule(seeds, M, rounds, p, batch_clients=kw.get("batch_clients"))


def replay_head(kw, draws):
    """The sweep and draws cut to the first CPU_REPLAY_ROUNDS rounds."""
    from repro_torch.core import Draws

    k = CPU_REPLAY_ROUNDS
    kw = dict(kw)
    if kw["algo"] == "catalyzed_svrp":
        kw.update(num_outer=1, inner_steps=k)
        return kw, Draws(draws.clients[:1, :k].cpu(), draws.coins[:1, :k].cpu())
    kw["num_steps" if "num_steps" in kw else "num_rounds"] = k
    if draws is None:
        return kw, None
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
    global CARD
    card = CARD = smi.stdout.strip().splitlines()[0]
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

    from repro_torch.kernels import prox_update as k1
    from repro_torch.kernels.prox_update import prox_update_batched, prox_update_batched_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    # K1's loop form at the quadratic sweeps' shapes: svrp (R 16 trials) and
    # minibatch (R 64 = 16 trials x 4 cohort clients), d 40, 200 steps, on
    # the Figure-1 clients at the sweep's stepsizes.
    from repro_torch.core import theorem2_stepsize

    steps = 200
    eta0 = theorem2_stepsize(float(qprob.strong_convexity()), float(qprob.similarity()))
    L = float(qprob.smoothness_max())
    for R in (16, 64):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            isz = torch.empty((), dtype=dtype).element_size()
            A, b = qprob.A.to(dtype), qprob.b.to(dtype)
            m = torch.randint(0, qprob.num_clients, (R,), generator=gen, device="cuda")
            z = torch.randn(R, qprob.dim, generator=gen, device="cuda", dtype=dtype)
            eta = eta0 * (0.5 + torch.rand(R, generator=gen, device="cuda", dtype=dtype))
            beta, ie = 1.0 / (L + 1.0 / eta), 1.0 / eta

            def loop():
                return k1.quadratic_prox_gd_batched(A, b, m, z, beta, ie, steps,
                                                     check_indices=False)

            def loop_plain():
                return k1.quadratic_prox_gd_batched_plain(A, b, m, z, beta, ie, steps)

            out, ref = loop(), loop_plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **K1_LOOP_TOL[dname])
            d = qprob.dim
            b_ms, b_by = bound_ms((R * d * d + 4 * R * d + 2 * R) * isz + 8 * R,
                                  steps * R * (2 * d * d + 6 * d), dname)
            res = dict(shape=[R, d, steps], max_abs_err=(out - ref).abs().max().item(),
                       ms=time_ms(loop, 50), plain_ms=time_ms(loop_plain, 5, 1),
                       device_ms=device_ms(loop, 20), bound_ms=b_ms, bound_by=b_by,
                       tol=K1_LOOP_TOL[dname])
            if dtype == torch.float64:
                # Planted fault: the kernel runs one step fewer.
                k1._LOOP_SKIP_STEPS = 1
                try:
                    wrong = loop()
                finally:
                    k1._LOOP_SKIP_STEPS = 0
                fault = (wrong - ref).abs().max().item()
                check(not torch.allclose(wrong, ref, **K1_LOOP_TOL[dname]),
                      f"quadratic_prox_gd_batched: planted fault (one step fewer) passed the "
                      f"check at R {R}: max abs err {fault}")
                res["planted_fault_one_step_fewer_max_abs_err"] = fault
            results[("quadratic_prox_gd_batched", dname, R)] = res
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

        # K2 at the Figure-2 svrp shape through the sweep's entry: R = 16
        # sampled clients, their features and labels read in place.
        results[("logistic_prox_gd_batched", dname)] = k2_case(gen, lprob, dtype)
        results[("logistic_prox_gd_batched", dname, "y0")] = k2_y0_case(gen, lprob, dtype)
    emit({"phase": "parity", "library_ms": None,
          "library_note": "no single PyTorch call computes any of these functions",
          "kernels": [{"name": key[0], "dtype": key[1], **v} for key, v in results.items()]})
    return results


def k2_case(gen, lprob, dtype) -> dict:
    """K2 at the Figure-2 svrp shape (R 16 sampled clients of n 2000 rows,
    d 123, 20 steps) through the sweep's indexed entry, against its plain
    version (which gathers the signed rows first): the check, two launches
    bit for bit, the time beside the bound on the bytes this draw reads,
    the reference's entry on the gathered rows, and the planted fault (one
    cluster rank's partial gradient dropped), which must fail the check.
    In float64 also the design's options: every step reading A from L2,
    clusters of 8 blocks (two waves at R 16: the card holds 15 such
    clusters) and of 16 (non-portable)."""
    import torch

    from repro_torch.kernels import logistic_prox as k2

    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    steps, R = 20, 16
    Z, y = lprob.Z.to(dtype), lprob.y.to(dtype)
    m = torch.randint(0, lprob.num_clients, (R,), generator=gen, device="cuda")
    _, n, d = Z.shape
    zz = torch.randn(R, d, generator=gen, device="cuda", dtype=dtype) * 0.3
    eta = 0.5 + torch.rand(R, generator=gen, device="cuda", dtype=dtype)
    beta = 1.0 / (float(lprob.smoothness_max()) + 1.0 / eta)
    inv_eta = 1.0 / eta
    A = Z[m] * y[m][:, :, None]

    def k2_run():
        return k2.logistic_prox_gd_indexed(Z, y, m, zz, beta, inv_eta, lprob.lam, steps,
                                           check_indices=False)

    def k2_plain():
        return k2.logistic_prox_gd_indexed_plain(Z, y, m, zz, beta, inv_eta, lprob.lam, steps)

    def k2_signed():
        return k2.logistic_prox_gd_batched(A, zz, beta, inv_eta, lprob.lam, steps)

    out, again, ref = k2_run(), k2_run(), k2_plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **K2_TOL[dname])
    check(torch.equal(out, again), "logistic_prox_gd_indexed: two launches differ")
    torch.testing.assert_close(k2_signed(), ref, **K2_TOL[dname])
    clients = int(torch.unique(m).numel())
    cluster = k2.cluster_size(R, n, d, dtype, Z.device)
    res_rows = k2.resident_rows(n, d, cluster, isz)
    # The distinct clients' features and labels read once; z, beta, inv_eta,
    # m read and the output written once.
    nbytes = (clients * (n * d + n) + 2 * R * d + 2 * R) * isz + 8 * R
    flops = steps * R * (4 * n * d + 4 * n + 7 * d)
    b_ms, b_by = bound_ms(nbytes, flops, dname)
    k2._DROP_RANK = 3
    try:
        wrong = k2_run()
    finally:
        k2._DROP_RANK = -1
    fault = (wrong - ref).abs().max().item()
    check(not torch.allclose(wrong, ref, **K2_TOL[dname]),
          f"logistic_prox_gd_indexed: the planted fault (rank 3's partial dropped) passed the "
          f"check: max abs err {fault}")
    res = dict(shape=[R, n, d, steps], clients=clients,
               cluster=cluster, resident_rows=res_rows,
               clusters_at_once=k2.clusters_at_once(dtype, d, cluster, res_rows),
               max_abs_err=(out - ref).abs().max().item(), bit_identical_relaunch=True,
               planted_fault_rank_dropped_max_abs_err=fault,
               plain_ms=time_ms(k2_plain, 5, 1), ms=time_ms(k2_run, 50),
               signed_entry_ms=time_ms(k2_signed, 50), device_ms=device_ms(k2_run, 10),
               plain_device_ms=device_ms(k2_plain, 5), bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, flops=flops, tol=K2_TOL[dname], library_ms=None)
    if dtype == torch.float64:
        options = {}
        for label, fixed, resident in (("l2_stream", None, False), ("resident_c8", 8, True),
                                       ("resident_c16", 16, True)):
            k2._CLUSTER, k2._RESIDENT = fixed, resident
            try:
                c = k2.cluster_size(R, n, d, dtype, Z.device)
                rows_c = k2.resident_rows(n, d, c, isz)
                got = k2_run()
                torch.cuda.synchronize()
                options[label] = dict(cluster=c, resident_rows=rows_c,
                                      clusters_at_once=k2.clusters_at_once(dtype, d, c, rows_c),
                                      max_abs_err=(got - ref).abs().max().item(),
                                      ms=time_ms(k2_run, 50))
            except RuntimeError as e:  # a cluster the card cannot schedule
                options[label] = dict(error=str(e)[:200])
            finally:
                k2._CLUSTER, k2._RESIDENT = None, True
        res["options"] = options
    return res


def k2_y0_case(gen, lprob, dtype) -> dict:
    """K2 as the DP-ERM fold runs it: the indexed entry at the Figure-2 svrp
    shape with the target shifted by eta s (s a noise table row) and the
    start y0 = z, against its plain version at the reference's tolerance."""
    import torch

    from repro_torch.kernels import logistic_prox as k2

    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    steps, R = 20, 16
    Z, y = lprob.Z.to(dtype), lprob.y.to(dtype)
    m = torch.randint(0, lprob.num_clients, (R,), generator=gen, device="cuda")
    _, n, d = Z.shape
    z = torch.randn(R, d, generator=gen, device="cuda", dtype=dtype) * 0.3
    shift = torch.randn(R, d, generator=gen, device="cuda", dtype=dtype) * 0.01
    eta = 0.5 + torch.rand(R, generator=gen, device="cuda", dtype=dtype)
    target = z - eta[:, None] * shift
    beta = 1.0 / (float(lprob.smoothness_max()) + 1.0 / eta)

    def run():
        return k2.logistic_prox_gd_indexed(Z, y, m, target, beta, 1.0 / eta, lprob.lam, steps,
                                           y0=z, check_indices=False)

    def plain():
        return k2.logistic_prox_gd_indexed_plain(Z, y, m, target, beta, 1.0 / eta, lprob.lam,
                                                 steps, z)

    out, ref = run(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **K2_TOL[dname])
    unshifted = k2.logistic_prox_gd_indexed_plain(Z, y, m, z, beta, 1.0 / eta, lprob.lam, steps,
                                                  z)
    check(not torch.allclose(out, unshifted, **K2_TOL[dname]),
          "logistic_prox_gd_indexed: the shifted target made no difference")
    clients = int(torch.unique(m).numel())
    nbytes = (clients * (n * d + n) + 3 * R * d + 2 * R) * isz + 8 * R
    b_ms, b_by = bound_ms(nbytes, steps * R * (4 * n * d + 4 * n + 7 * d), dname)
    return dict(shape=[R, n, d, steps], y0=True, max_abs_err=(out - ref).abs().max().item(),
                ms=time_ms(run, 50), plain_ms=time_ms(plain, 5, 1), bound_ms=b_ms,
                bound_by=b_by, tol=K2_TOL[dname], library_ms=None)


def phase_main_path(qprob, lprob, l_star) -> tuple[dict, list]:
    """Drive every sweep on the card; the launch counts cover exactly these runs."""
    import numpy as np
    import torch

    from repro_torch.experiments import run_batch

    plan = sweeps(qprob, lprob, l_star)
    runs = []
    zero_launch_counts(SWEEP_KERNELS)
    for label, kind, kw in plan:
        problem = qprob if kind == "quadratic" else lprob
        x_star = problem.minimizer() if kind == "quadratic" else l_star
        draws = sweep_draws(kw, problem.num_clients)
        before = launch_counts(SWEEP_KERNELS)
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
        launched = {k: n - before[k] for k, n in launch_counts(SWEEP_KERNELS).items()}
        info = {
            "phase": "main_path", "sweep": label, "trials": res.num_trials, "rounds": rounds,
            "wall_s": wall, "rounds_per_s": rounds / wall, "dist_sq_initial": r0,
            "dist_sq_final_median": final,
            "comm_final_median": float(np.median(res.comm.cpu().numpy()[:, -1])),
            "launches": launched,
        }
        emit(info)
        expected = expected_launches(kind, kw)
        check(launched == expected and info["rounds_per_s"] > 0,
              f"{label}: launched {launched}, expected exactly {expected}")
        runs.append((label, kind, problem, kw, draws, x_star, res))
    launches = launch_counts(SWEEP_KERNELS)
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")
    return launches, runs


def expected_launches(kind: str, kw) -> dict:
    """The sweep kernels' launches a sweep must make: one K1-loop launch per
    quadratic prox solve (a round), one K2 launch per logistic solve, and
    Catalyst's K1 once a GD step (its shifted solves stay elementwise)."""
    counts = dict.fromkeys(SWEEP_KERNELS, 0)
    if kw["algo"] == "catalyzed_svrp":
        counts["prox_update_batched"] = kw["num_outer"] * kw["inner_steps"] * kw["prox_steps"]
    elif kind == "quadratic":
        counts["quadratic_prox_gd_batched"] = kw["num_steps"]
    else:
        counts["logistic_prox_gd_batched"] = kw["num_steps"]
    return counts


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


# ---------------------------------------------- engine (registry, sequential)
def engine_sweeps(qprob, lprob, l_star):
    """The engine path's sweeps, ``run_batch(fused=False)``: every ported
    algorithm on the Figure-1 quadratic (the rounds-defined ones and Catalyst
    with the exact, spectral and gd solvers), svrp with newton on the
    Figure-2 logistic.  (label, problem kind, solver, run_batch kwargs)."""
    from repro_torch.core import theorem2_stepsize, theorem3_gamma

    M = qprob.num_clients
    mu, delta = float(qprob.strong_convexity()), float(qprob.similarity())
    dmax, L = float(qprob.similarity_max()), float(qprob.smoothness_max())
    eta = theorem2_stepsize(mu, delta)
    gamma = max(theorem3_gamma(mu, delta, M), 1.0)
    eta_in = theorem2_stepsize(mu + gamma, delta)
    seeds = dict(seeds=ENGINE_SEEDS)
    plan = []
    for solver in ("exact", "spectral", "gd"):
        gd = solver == "gd"
        sk = dict(prox_solver=solver, **(dict(prox_steps=200) if gd else {}))
        smooth = {"smoothness": L} if gd else {}
        rounds = dict(
            sppm=dict(grid={"eta": [eta, eta / 2], **smooth}, num_steps=200),
            svrp=dict(grid={"eta": [eta, eta / 2], "p": 1.0 / M, **smooth}, num_steps=400),
            svrp_minibatch=dict(grid={"eta": [eta, eta / 2], "p": 1.0 / M, **smooth},
                                num_steps=150, batch_clients=4),
            catalyzed_svrp=dict(grid={"mu": mu, "gamma": gamma, "eta": eta_in, "p": 1.0 / M,
                                      **({"smoothness": L + gamma} if gd else {})},
                                num_outer=3, inner_steps=60),
        )
        for algo, kw in rounds.items():
            plan.append((f"{algo}/{solver}/fig1_quadratic", "quadratic", solver,
                         dict(algo=algo, **kw, **sk, **seeds)))
    # The baselines at the quickstart's stepsizes; dane and acc_extragradient
    # are deterministic (one seed), so their 8 trials are 8 values of theta.
    thetas = [dmax * f for f in (1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)]
    for algo, kw in (
        ("sgd", dict(grid={"stepsize": 1 / (2 * L)}, num_steps=2000, **seeds)),
        ("svrg", dict(grid={"stepsize": 1 / (6 * L), "p": 1.0 / M}, num_steps=2000, **seeds)),
        ("scaffold", dict(grid={"local_lr": 1 / (4 * L)}, num_rounds=2000, local_steps=4,
                          **seeds)),
        ("dane", dict(grid={"theta": thetas}, num_rounds=40)),
        ("acc_extragradient", dict(grid={"theta": thetas, "mu": mu}, num_rounds=40)),
    ):
        plan.append((f"{algo}/fig1_quadratic", "quadratic", "exact", dict(algo=algo, **kw)))
    lmu = float(lprob.strong_convexity())
    leta = theorem2_stepsize(lmu, float(lprob.similarity_at(l_star)))
    plan.append(("svrp/newton/fig2_logistic", "logistic", "newton", dict(
        algo="svrp", grid={"eta": [leta, leta / 2], "p": 1.0 / lprob.num_clients},
        num_steps=100, prox_solver="newton", **seeds)))
    return plan


def _run(entry, problem, kw, draws, x_star, **extra):
    """One engine run, timed on the host clock ending in a synchronise."""
    return _timed(lambda: entry(kw["algo"], problem, x_star=x_star, draws=draws, **extra,
                                **{k: v for k, v in kw.items() if k != "algo"}))


def traj_gap(a, b, tol, k: int | None = None) -> tuple[bool, float]:
    """(comm equal and dist_sq within ``tol``, the largest relative gap of
    dist_sq above tol's floor) between two runs' (B, K) trajectories, over
    their first ``k`` rounds when given."""
    import numpy as np

    k = a.dist_sq.shape[1] if k is None else k
    ca, cb = a.comm[:, :k].cpu().numpy(), b.comm[:, :k].cpu().numpy()
    da, db = a.dist_sq[:, :k].cpu().numpy(), b.dist_sq[:, :k].cpu().numpy()
    rel = float(np.max(np.abs(da - db) / np.maximum(np.abs(db), tol["atol"])))
    ok = (ca.dtype == cb.dtype and np.array_equal(ca, cb)
          and np.allclose(da, db, rtol=tol["rtol"], atol=tol["atol"]))
    return ok, rel


def phase_engine(qprob, lprob, l_star, cpu_problems) -> None:
    """The engine path: the quickstart at full horizon, every ported
    algorithm's ``run_batch(fused=False)`` sweep, each against a CPU run of
    the first rounds and against `run_sequential`, the registry against the
    fused path for svrp/gd, and a planted stale-refresh fault."""
    import numpy as np
    import torch

    from repro_torch.core import rounds as rounds_mod
    from repro_torch.experiments import run_batch, run_sequential

    # 1. The quickstart twin (examples/quickstart_torch.py) at its full
    # horizons, each driver timed alone; no sweep kernel may launch.
    qs = _load_example("quickstart_torch")
    zero_launch_counts(SWEEP_KERNELS)
    res = {}
    for name, fn in qs.drivers(qs.make_problem("cuda")).items():
        res[name], secs = _timed(fn)
        horizon = qs.HORIZONS[name]
        emit({"phase": "engine_rate", "run": f"quickstart {name}", "substrate": "sequential",
              "trials": 1, "rounds": horizon, "wall_s": secs, "rounds_per_s": horizon / secs})
    c2a = {name: float(r.comm_to_accuracy(qs.EPS)) for name, r in res.items()}
    final = {name: float(r.dist_sq[-1]) for name, r in res.items()}
    launched = launch_counts(SWEEP_KERNELS)
    emit({"phase": "engine_quickstart", "horizons": qs.HORIZONS, "final_dist_sq": final,
          "comm_to_1e-10": c2a, "launches": launched})
    check(not any(launched.values()), f"quickstart launched sweep kernels: {launched}")
    check(final["SVRP"] <= QUICKSTART_SVRP_MAX,
          f"quickstart: SVRP's final dist_sq {final['SVRP']} > {QUICKSTART_SVRP_MAX}")
    check(np.isfinite(c2a["SVRP"]) and c2a["SVRG"] > QUICKSTART_RATIO * c2a["SVRP"],
          f"quickstart: SVRG's comm to 1e-10 {c2a['SVRG']} is not > {QUICKSTART_RATIO} x "
          f"SVRP's {c2a['SVRP']}")

    # 2. Every ported algorithm's registry sweep; no sweep kernel may launch.
    plan = engine_sweeps(qprob, lprob, l_star)
    problems = {"quadratic": qprob, "logistic": lprob}
    stars = {"quadratic": qprob.minimizer(), "logistic": l_star}
    runs = {}
    zero_launch_counts(SWEEP_KERNELS)
    for label, kind, solver, kw in plan:
        problem, x_star = problems[kind], stars[kind]
        draws = sweep_draws(kw, problem.num_clients)
        res, wall = _run(run_batch, problem, kw, draws, x_star)
        d2 = res.dist_sq.cpu().numpy()
        K = d2.shape[1]
        r0 = float((x_star ** 2).sum())
        check(np.isfinite(d2).all() and res.x_final.shape == (d2.shape[0], problem.dim),
              f"{label}: non-finite dist_sq or wrong shapes")
        # SPPM and SGD at a constant stepsize converge to a neighbourhood of
        # x_* (Theorem 1; SGD's noise ball), here wider than ||x0 - x_*||^2.
        check(kw["algo"] in ("sppm", "sgd") or float(np.median(d2[:, -1])) < r0,
              f"{label}: the median trial did not descend")
        runs[label] = (kind, solver, kw, draws, x_star, res)
        emit({"phase": "engine_rate", "run": label, "substrate": "registry",
              "trials": res.num_trials, "rounds": K, "wall_s": wall, "rounds_per_s": K / wall,
              "trial_rounds_per_s": K * res.num_trials / wall,
              "dist_sq_final_median": float(np.median(d2[:, -1])), "dist_sq_initial": r0})
    registry_launches = launch_counts(SWEEP_KERNELS)
    check(not any(registry_launches.values()),
          f"the registry path launched sweep kernels: {registry_launches}")

    # 3. Each sweep's first rounds on the CPU (plain PyTorch), the same draws.
    for label, (kind, solver, kw, draws, x_star, res) in runs.items():
        kw_c, draws_c = replay_head(kw, draws)
        t0 = time.perf_counter()
        res_c = run_batch(kw_c["algo"], cpu_problems[kind], x_star=x_star.cpu(), draws=draws_c,
                          device="cpu", **{k: v for k, v in kw_c.items() if k != "algo"})
        k = res_c.dist_sq.shape[1]
        ok, rel = traj_gap(res, res_c, dict(rtol=CPU_REPLAY_RTOL, atol=0.0), k)
        emit({"phase": "engine_cpu_replay", "run": label, "rounds": k, "comm_equal": ok,
              "dist_sq_max_rel_diff": rel, "rtol": CPU_REPLAY_RTOL,
              "cpu_s": time.perf_counter() - t0})
        check(ok, f"{label}: the card's first {k} rounds differ from the CPU run "
                  f"(comm or dist_sq beyond rtol {CPU_REPLAY_RTOL}: {rel})")

    # 4. run_sequential, one driver call a trial, against the lane batch.
    for label, (kind, solver, kw, draws, x_star, res) in runs.items():
        if solver != "exact" or kind != "quadratic":
            continue
        seq, wall = _run(run_sequential, problems[kind], kw, draws, x_star)
        ok, rel = traj_gap(seq, res, ENGINE_PATH_TOL[solver])
        K = seq.dist_sq.shape[1]
        emit({"phase": "engine_rate", "run": label, "substrate": "sequential",
              "trials": seq.num_trials, "rounds": K, "wall_s": wall,
              "rounds_per_s": K * seq.num_trials / wall,
              "vs_registry_ok": ok, "vs_registry_max_rel_diff": rel,
              "tol": ENGINE_PATH_TOL[solver]})
        check(ok, f"{label}: run_sequential differs from run_batch (rel {rel})")

    # 5. The fused path (K1's loop form) against the registry gd path, svrp.
    label = "svrp/gd/fig1_quadratic"
    kind, solver, kw, draws, x_star, res = runs[label]
    zero_launch_counts(SWEEP_KERNELS)
    fused, wall = _run(run_batch, qprob, kw, draws, x_star, fused=True)
    ok, rel = traj_gap(fused, res, dict(rtol=ENGINE_FUSED_RTOL, atol=0.0))
    head = dict(zip(("ok", "rel"), traj_gap(fused, res, dict(rtol=ENGINE_FUSED_RTOL, atol=0.0),
                                            CPU_REPLAY_ROUNDS)))
    K = fused.dist_sq.shape[1]
    emit({"phase": "engine_rate", "run": label, "substrate": "fused", "trials": fused.num_trials,
          "rounds": K, "wall_s": wall, "rounds_per_s": K / wall,
          "vs_registry_ok": ok, "vs_registry_max_rel_diff": rel, "rtol": ENGINE_FUSED_RTOL,
          "head_vs_registry": head, "launches": launch_counts(SWEEP_KERNELS)})
    check(launch_counts(SWEEP_KERNELS)["quadratic_prox_gd_batched"] == K,
          f"{label}: the fused run launched {launch_counts(SWEEP_KERNELS)}")
    check(ok, f"{label}: the fused path differs from the registry path (rel {rel})")

    # 6. Planted fault: a refresh that keeps the stale anchor gradient.
    label = "svrp/exact/fig1_quadratic"
    kind, solver, kw, draws, x_star, res = runs[label]
    kw_f, draws_f = replay_head({**kw, "grid": {**kw["grid"], "p": ENGINE_FAULT_P}}, None)
    draws_f = sweep_draws(kw_f, qprob.num_clients)
    check(bool(draws_f.refresh.any()), "planted fault: its draws never refresh")
    good = run_batch("svrp", cpu_problems["quadratic"], x_star=x_star.cpu(), device="cpu",
                     draws=draws_f, **{k: v for k, v in kw_f.items() if k != "algo"})
    refresh = rounds_mod.RoundOps.refresh_grad
    rounds_mod.RoundOps.refresh_grad = lambda self, k, c, w_next, gbar: gbar
    try:
        stale, _ = _run(run_batch, qprob, kw_f, draws_f.to("cuda"), x_star)
    finally:
        rounds_mod.RoundOps.refresh_grad = refresh
    ok, rel = traj_gap(stale, good, dict(rtol=CPU_REPLAY_RTOL, atol=0.0))
    emit({"phase": "engine_fault", "run": f"{label}, p {ENGINE_FAULT_P}, {CPU_REPLAY_ROUNDS} "
          "rounds, stale anchor gradient", "refresh_rounds": int(draws_f.refresh.sum()),
          "rejected": not ok, "dist_sq_max_rel_diff": rel})
    check(not ok, f"planted fault (stale refresh) passed the CPU-replay check: rel {rel}")

    # 7. Where a round's time goes: registry svrp (exact, and newton on Figure 2).
    for label in ("svrp/exact/fig1_quadratic", "svrp/newton/fig2_logistic"):
        kind, solver, kw, draws, x_star, _ = runs[label]
        kw_h, draws_h = replay_head(kw, draws)
        draws_h = draws_h.to("cuda")

        def run():
            return run_batch(kw_h["algo"], problems[kind], x_star=x_star, draws=draws_h,
                             **{k: v for k, v in kw_h.items() if k != "algo"})

        wall_ms, kernels = profiled(run, 1)
        busy_ms = sum(t for t, _ in kernels.values()) / 1e3 if kernels else None
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        emit({"phase": "engine_profile", "run": label, "rounds": CPU_REPLAY_ROUNDS,
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
              "kernel_launches": sum(c for _, c in kernels.values()),
              "top_kernels": [{"name": name[:80], "device_ms": t / 1e3, "count": c}
                              for name, (t, c) in top]})


def composite_plan(qprob_cpu):
    """Composite SVRP's three regularizers on Figure 1: (name, prox_R,
    x_star on the CPU), each binding at its solution."""
    from repro_torch.core.composite import composite_minimizer_pgd, prox_box, prox_l1, prox_l2ball

    x_unc = qprob_cpu.minimizer()
    box, radius = 0.5 * float(x_unc.abs().max()), 0.5 * float(x_unc.norm())
    L = float(qprob_cpu.smoothness())
    plan = []
    for name, prox in (("l1", lambda z, t: prox_l1(z, COMPOSITE_L1 * t)),
                       ("box", prox_box(-box, box)), ("l2ball", prox_l2ball(radius))):
        x_star = composite_minimizer_pgd(qprob_cpu, prox, L=L, num_steps=COMPOSITE_PGD_STEPS)
        check(float((x_star - x_unc).norm()) > 1e-3 * float(x_unc.norm()),
              f"composite {name}: the regularizer does not bind at the solution")
        plan.append((name, prox, x_star))
    return plan


def _replay_on_cpu(label, res, kw, draws, cpu_problem, x_star, *, fault=None) -> tuple:
    """The first CPU_REPLAY_ROUNDS rounds of a card sweep again on the CPU
    (plain versions, the same draws): (ok, dist_sq's largest relative gap),
    comm and comm_bytes equal; with ``fault`` (a card result), the faulted
    run is held to the CPU run instead."""
    import numpy as np

    from repro_torch.experiments import run_batch

    kw_c, draws_c = replay_head(kw, draws)
    res_c = run_batch(kw_c["algo"], cpu_problem, x_star=x_star.cpu(), draws=draws_c,
                      device="cpu", **{k: v for k, v in kw_c.items() if k != "algo"})
    k = res_c.dist_sq.shape[1]
    card = res if fault is None else fault
    ok, rel = traj_gap(card, res_c, dict(rtol=CPU_REPLAY_RTOL, atol=0.0), k)
    ok = ok and np.array_equal(card.comm_bytes[:, :k], res_c.comm_bytes)
    if fault is None:
        emit({"phase": "engine_cpu_replay", "run": label, "rounds": k, "comm_equal": ok,
              "dist_sq_max_rel_diff": rel, "rtol": CPU_REPLAY_RTOL})
        check(ok, f"{label}: the card's first {k} rounds differ from the CPU run (rel {rel})")
    return ok, rel


def phase_engine_slice(qprob, cpu_problems) -> None:
    """The engine's composite SVRP, lossy channels and DP-ERM problem on the
    card: every sweep timed, its first rounds replayed on the CPU, the fused
    DP sweep through K2 with the noise fold (once a round) against the
    registry path and against a planted fault (K2 without the fold)."""
    import numpy as np
    import torch

    from repro_torch.core import theorem2_stepsize
    from repro_torch.experiments import run_batch
    from repro_torch.kernels import logistic_prox as k2
    from repro_torch.problems import make_dp_a9a_problem

    M = qprob.num_clients
    mu, delta = float(qprob.strong_convexity()), float(qprob.similarity())
    L = float(qprob.smoothness_max())
    eta = theorem2_stepsize(mu, delta)
    seeds = dict(seeds=ENGINE_SEEDS)

    # 1. Composite SVRP (no kernel on its path: FISTA is plain PyTorch).
    for name, prox, x_star_cpu in composite_plan(cpu_problems["quadratic"]):
        x_star = x_star_cpu.to("cuda")
        label = f"composite/{name}/fig1_quadratic"
        kw = dict(algo="composite", grid={"eta": [eta, eta / 2], "p": 1.0 / M, "smoothness": L,
                                          "mu": mu},
                  num_steps=COMPOSITE_ROUNDS, prox_R=prox, **seeds)
        draws = sweep_draws(kw, M)
        zero_launch_counts(SWEEP_KERNELS)
        res, wall = _run(run_batch, qprob, kw, draws, x_star)
        d2 = res.dist_sq.cpu().numpy()
        r0 = float((x_star ** 2).sum())
        emit({"phase": "engine_rate", "run": label, "substrate": "registry",
              "trials": res.num_trials, "rounds": COMPOSITE_ROUNDS, "wall_s": wall,
              "rounds_per_s": COMPOSITE_ROUNDS / wall, "dist_sq_initial": r0,
              "dist_sq_final_median": float(np.median(d2[:, -1])),
              "launches": launch_counts(SWEEP_KERNELS)})
        check(np.isfinite(d2).all() and float(np.median(d2[:, -1])) < r0,
              f"{label}: non-finite or the median trial did not descend")
        check(not any(launch_counts(SWEEP_KERNELS).values()), f"{label}: launched a sweep kernel")
        _replay_on_cpu(label, res, kw, draws, cpu_problems["quadratic"], x_star)

    # 2. svrp through each lossy channel, registry (exact) and fused (K1's loop form).
    x_star = qprob.minimizer()
    for channel in ("quant8", "cast", "cast16"):
        for fused in (False, True):
            label = f"svrp/{channel}/{'fused' if fused else 'registry'}/fig1_quadratic"
            grid = {"eta": [eta, eta / 2], "p": 1.0 / M}
            extra = dict(prox_solver="exact")
            if fused:
                grid["smoothness"] = L
                extra = dict(prox_solver="gd", prox_steps=200, fused=True)
            kw = dict(algo="svrp", grid=grid, num_steps=CHANNEL_ROUNDS, channel=channel,
                      **extra, **seeds)
            draws = sweep_draws(kw, M)
            zero_launch_counts(SWEEP_KERNELS)
            res, wall = _run(run_batch, qprob, kw, draws, x_star)
            launched = launch_counts(SWEEP_KERNELS)
            d2 = res.dist_sq.cpu().numpy()
            emit({"phase": "engine_rate", "run": label,
                  "substrate": "fused" if fused else "registry", "trials": res.num_trials,
                  "rounds": CHANNEL_ROUNDS, "wall_s": wall, "rounds_per_s": CHANNEL_ROUNDS / wall,
                  "dist_sq_final_median": float(np.median(d2[:, -1])),
                  "comm_bytes_final_median": float(np.median(res.comm_bytes[:, -1])),
                  "launches": launched})
            want = CHANNEL_ROUNDS if fused else 0
            check(launched["quadratic_prox_gd_batched"] == want
                  and launched["prox_update_batched"] == launched["logistic_prox_gd_batched"] == 0,
                  f"{label}: launched {launched}")
            check(np.isfinite(d2).all() and float(np.median(d2[:, -1])) < float((x_star ** 2).sum()),
                  f"{label}: non-finite or the median trial did not descend")
            _replay_on_cpu(label, res, kw, draws, cpu_problems["quadratic"], x_star)

    # 3. svrp on the DP-ERM a9a problem: fused (K2 with the noise fold, once
    # a round), registry (gd: the noised gradient oracle), CPU replays, and
    # K2 without the fold, which the replay must reject.
    dp = make_dp_a9a_problem(60, n_per_client=2000, lam=0.1, n_pool=32561, seed=0, sigma=1.0,
                             clip=1.0, device="cuda")
    dp_cpu = make_dp_a9a_problem(60, n_per_client=2000, lam=0.1, n_pool=32561, seed=0,
                                 sigma=1.0, clip=1.0, device="cpu")
    check(torch.equal(dp.dp_shift.cpu(), dp_cpu.dp_shift), "DP noise differs between devices")
    x_star = dp.minimizer()
    leta = theorem2_stepsize(dp.lam, float(dp.similarity_at(x_star)))
    base = dict(algo="svrp", grid={"eta": [leta, leta / 2], "p": 1.0 / dp.num_clients,
                                   "smoothness": float(dp.smoothness_max())},
                num_steps=DP_ROUNDS, prox_solver="gd", prox_steps=20, **seeds)
    draws = sweep_draws(base, dp.num_clients)
    out = {}
    for fused in (True, False):
        label = f"svrp/dp_a9a/{'fused' if fused else 'registry'}"
        kw = {**base, **({"fused": True} if fused else {})}
        zero_launch_counts(SWEEP_KERNELS)
        res, wall = _run(run_batch, dp, kw, draws, x_star)
        launched = launch_counts(SWEEP_KERNELS)
        d2 = res.dist_sq.cpu().numpy()
        emit({"phase": "engine_rate", "run": label, "substrate": "fused" if fused else "registry",
              "trials": res.num_trials, "rounds": DP_ROUNDS, "wall_s": wall,
              "rounds_per_s": DP_ROUNDS / wall, "dist_sq_final_median": float(np.median(d2[:, -1])),
              "dist_sq_initial": float((x_star ** 2).sum()), "launches": launched})
        check(launched["logistic_prox_gd_batched"] == (DP_ROUNDS if fused else 0),
              f"{label}: launched {launched}")
        check(np.isfinite(d2).all() and float(np.median(d2[:, -1])) < float((x_star ** 2).sum()),
              f"{label}: non-finite or the median trial did not descend")
        _replay_on_cpu(label, res, kw, draws, dp_cpu, x_star)
        out[fused] = (kw, res)
    ok, rel = traj_gap(out[True][1], out[False][1], dict(rtol=ENGINE_FUSED_RTOL, atol=0.0))
    emit({"phase": "engine_rate", "run": "svrp/dp_a9a", "fused_vs_registry_ok": ok,
          "fused_vs_registry_max_rel_diff": rel, "rtol": ENGINE_FUSED_RTOL})
    check(ok, f"svrp/dp_a9a: the fused path differs from the registry path (rel {rel})")
    kw, good = out[True]
    real = k2.logistic_prox_gd_indexed

    def no_fold(Z, y, m, z, beta, inv_eta, lam, steps, *, y0=None, check_indices=True):
        return real(Z, y, m, z if y0 is None else y0, beta, inv_eta, lam, steps, y0=y0,
                    check_indices=check_indices)

    kw_h, draws_h = replay_head(kw, draws)
    k2.logistic_prox_gd_indexed = no_fold
    try:
        faulted, _ = _run(run_batch, dp, kw_h, draws_h.to("cuda"), x_star)
    finally:
        k2.logistic_prox_gd_indexed = real
    ok, rel = _replay_on_cpu("svrp/dp_a9a/fused", good, kw, draws, dp_cpu, x_star, fault=faulted)
    emit({"phase": "engine_fault", "run": f"svrp/dp_a9a/fused, {CPU_REPLAY_ROUNDS} rounds, K2 "
          "without the noise fold", "rejected": not ok, "dist_sq_max_rel_diff": rel})
    check(not ok, f"planted fault (no DP fold) passed the CPU-replay check: rel {rel}")


# ------------------------------------------- DeepSVRP on the federated LM
def deep_expected(cfg, rounds: int, draws) -> tuple[dict, str]:
    """The kernel launches of one deep_svrp sweep, derived from the round:
    one K1 launch a local step; a client gradient is one K4 (with lse) and
    one K4b a layer, a metric pass one K4 a layer.  Gradients: M for the
    initial anchor, then B M (1 + K) a round (the control variates at w and
    K local steps for every lane and client), and B M on each round where
    some lane refreshes (the full gradient of every lane); B M metric
    passes a round."""
    B, M, K, L = DEEP_SEEDS, DEEP_CLIENTS, DEEP_HP["local_steps"], cfg.num_layers
    refresh = int(draws.refresh[:rounds].sum())
    grads = M + rounds * B * M * (1 + K) + refresh * B * M
    metric = rounds * B * M
    counts = {"prox_update_batched": K * rounds, "flash_attention": L * (grads + metric),
              "flash_attention_bwd": L * grads}
    formula = (f"K1 = K R = {K}*{rounds}; grads G = M + R B M (1+K) + F B M = {M} + "
               f"{rounds}*{B}*{M}*{1 + K} + {refresh}*{B}*{M} = {grads} (F = rounds where a "
               f"lane refreshes); K4b = L G = {L}*{grads}; K4 = L (G + R B M) = "
               f"{L}*({grads} + {metric})")
    return counts, formula


def deep_run(problem, x0, draws, rounds: int, *, fused: bool, channel=None, device="cuda"):
    """One deep_svrp sweep of DEEP_SEEDS trials through `run_batch`."""
    from repro_torch.experiments import run_batch

    return run_batch("deep_svrp", problem, grid=dict(
        eta=DEEP_HP["eta"], local_lr=DEEP_HP["local_lr"], anchor_prob=DEEP_HP["anchor_prob"]),
        seeds=list(range(DEEP_SEEDS)), x0=x0, x_star=x0, num_steps=rounds,
        local_steps=DEEP_HP["local_steps"], channel=channel, fused=fused, draws=draws,
        device=device)


def deep_sweep(preset, problem, x0, draws, rounds, *, fused, channel=None) -> tuple:
    """A timed, counted deep_svrp sweep on the card: (result, info)."""
    import numpy as np
    import torch

    from repro_torch.core import Draws

    draws = Draws(None, draws.coins[:rounds])
    zero_launch_counts(DEEP_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    res, wall = _timed(lambda: deep_run(problem, x0, draws, rounds, fused=fused, channel=channel))
    launched = launch_counts(DEEP_KERNELS)
    expected, formula = deep_expected(problem.cfg, rounds, draws)
    loss = res.dist_sq.cpu().numpy()
    info = {"phase": "deep_sweep", "preset": preset, "substrate": "fused" if fused else "registry",
            "channel": channel or "identity", "trials": res.num_trials, "rounds": rounds,
            "wall_s": wall, "s_per_round": wall / rounds,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": loss.tolist(), "comm_final": res.comm[:, -1].cpu().tolist(),
            "comm_bytes_final": res.comm_bytes[:, -1].tolist(), "launches": launched,
            "expected_launches": expected, "launch_formula": formula}
    emit(info)
    check(loss.shape == (DEEP_SEEDS, rounds) and np.isfinite(loss).all(),
          f"deep {preset}: non-finite loss or wrong shape {loss.shape}")
    check(launched == expected, f"deep {preset}: launched {launched}, expected {expected} "
                                f"({formula})")
    return res, info


def deep_gap(a, b, rtol: float, k: int | None = None) -> tuple[bool, float, bool]:
    """(comm and comm_bytes equal and loss within rtol, the largest relative
    loss gap, bit for bit) over the first ``k`` rounds."""
    import numpy as np

    k = a.dist_sq.shape[1] if k is None else k
    la, lb = a.dist_sq[:, :k].cpu().numpy(), b.dist_sq[:, :k].cpu().numpy()
    same_comm = (np.array_equal(a.comm[:, :k].cpu().numpy(), b.comm[:, :k].cpu().numpy())
                 and np.array_equal(a.comm_bytes[:, :k], b.comm_bytes[:, :k]))
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    return same_comm and rel <= rtol, rel, bool(np.array_equal(la, lb))


def _faulted_round():
    """The planted fault: the round's local loop starts from its targets z,
    not from the broadcast iterate."""
    from repro_torch.core import rounds as rounds_mod

    real = rounds_mod.ROUND_DEFS["deep_svrp"]

    def round_fn(ops, s, k):
        local = ops.local_prox_gd
        ops.local_prox_gd = lambda z, x: local(z, z)
        try:
            return real.round(ops, s, k)
        finally:
            ops.local_prox_gd = local

    return real, rounds_mod.RoundDef("deep_svrp", real.init, round_fn)


def phase_deep_parity() -> dict:
    """K1, K4 and K4b at the shapes the federated LM gives them: K1 over the
    20m preset's 2 trials x 4 clients rows of 15,733,632 float32 values (bit
    for bit its plain version); K4 and K4b in float32 at Dh 64 at each
    preset's attention shape (one client's batch)."""
    import torch

    from repro_torch.kernels.prox_update import prox_update_batched, prox_update_batched_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    R, d = DEEP_SEEDS * DEEP_CLIENTS, 15_733_632
    y, g, z = (torch.randn(R, d, generator=gen, device="cuda") for _ in range(3))
    lr = torch.full((R,), DEEP_HP["local_lr"], device="cuda")
    ie = torch.full((R,), 1.0 / DEEP_HP["eta"], device="cuda")
    out, ref = prox_update_batched(y, g, z, lr, ie), prox_update_batched_plain(y, g, z, lr, ie)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "prox_update_batched at the deep width differs from its plain "
                                 "version")
    b_ms, b_by = bound_ms((4 * R * d + 2 * R) * 4, 5 * R * d, "float32")
    results = {"prox_update_batched": dict(
        shape=[R, d], dtype="float32", max_abs_err=0.0, bit_identical=True,
        ms=time_ms(lambda: prox_update_batched(y, g, z, lr, ie), 20),
        plain_ms=time_ms(lambda: prox_update_batched_plain(y, g, z, lr, ie), 5, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)}
    del y, g, z, out, ref
    for preset, (B, S, H, KVH) in (("20m", (2, 128, 6, 2)), ("100m", (4, 256, 12, 4))):
        results[f"flash_attention {preset}"] = k4_case(gen, B, S, S, H, KVH, 64, torch.float32)
        results[f"flash_attention_bwd {preset}"] = k4b_case(gen, B, S, S, H, KVH, 64,
                                                            torch.float32, timed=True)
    emit({"phase": "deep_parity", "kernels": [{"name": k, **v} for k, v in results.items()]})
    torch.cuda.empty_cache()
    return results


def phase_deep(presets=("20m", "100m")) -> dict:
    """DeepSVRP on the federated transformer at full width and depth."""
    import numpy as np
    import torch

    from repro_torch.core import draw_schedule
    from repro_torch.core import rounds as rounds_mod

    ex = _load_example("fed_transformer_torch")
    out = {}
    for preset in presets:
        problem, x0 = ex.make_problem(preset, DEEP_CLIENTS, DEEP_ALPHA, 0, "cuda")
        cfg = problem.cfg
        R = DEEP_ROUNDS[preset]
        draws = draw_schedule(list(range(DEEP_SEEDS)), DEEP_CLIENTS, R, DEEP_HP["anchor_prob"],
                              clients=False)
        emit({"phase": "deep_model", "preset": preset, "params": problem.dim,
              "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
              "tokens_per_client": list(problem.tokens.shape[1:]), "clients": DEEP_CLIENTS,
              "trials": DEEP_SEEDS, "hparams": DEEP_HP, "coins": draws.coins.tolist()})
        if preset not in DEEP_REPLAYED:
            res, _ = deep_sweep(preset, problem, x0, draws, R, fused=True)
            k = DEEP_PATH_ROUNDS
            fused, fi = deep_sweep(preset, problem, x0, draws, k, fused=True)
            reg, ri = deep_sweep(preset, problem, x0, draws, k, fused=False)
            ok, rel, bits = deep_gap(fused, reg, 0.0)
            emit({"phase": "deep_paths", "preset": preset, "rounds": k, "fused_s_per_round":
                  fi["s_per_round"], "registry_s_per_round": ri["s_per_round"],
                  "loss_max_rel_diff": rel, "bit_identical": bits})
            check(ok and bits, f"deep {preset}: fused and registry differ (rel {rel})")
            out[preset] = res
            del problem, x0, res, fused, reg
            torch.cuda.empty_cache()
            continue
        runs = {}
        for channel in (None, "quant8"):
            for fused in (True, False):
                runs[channel, fused], _ = deep_sweep(preset, problem, x0, draws, R, fused=fused,
                                                     channel=channel)
        for channel in (None, "quant8"):
            ok, rel, bits = deep_gap(runs[channel, True], runs[channel, False], 0.0)
            loss = runs[channel, True].dist_sq.cpu().numpy()
            falls = bool((loss[:, -1] < loss[:, 0]).all())
            emit({"phase": "deep_paths", "preset": preset, "channel": channel or "identity",
                  "rounds": R, "loss_max_rel_diff": rel, "bit_identical": bits,
                  "loss_falls": falls})
            check(ok and bits, f"deep {preset} {channel}: fused and registry differ (rel {rel})")
            check(falls, f"deep {preset} {channel}: the loss did not fall: {loss.tolist()}")
        ratio = float(runs["quant8", True].comm_bytes[0, -1]) / float(runs[None, True].comm_bytes[0, -1])
        emit({"phase": "deep_bytes", "preset": preset, "quant8_over_f32": ratio,
              "limit": DEEP_BYTES_RATIO})
        check(ratio <= DEEP_BYTES_RATIO, f"deep {preset}: quant8 bytes ratio {ratio}")

        # The first rounds on the CPU (plain K1, K4, K4b) from the card's x0.
        k = DEEP_REPLAY_ROUNDS
        cpu_problem, _ = ex.make_problem(preset, DEEP_CLIENTS, DEEP_ALPHA, 0, "cpu")
        check(torch.equal(cpu_problem.tokens, problem.tokens.cpu()), "deep: tokens differ")
        t0 = time.perf_counter()
        from repro_torch.core import Draws

        cpu = deep_run(cpu_problem, x0.cpu(), Draws(None, draws.coins[:k]), k, fused=True,
                       device="cpu")
        cpu_s = time.perf_counter() - t0
        ok, rel, _ = deep_gap(runs[None, True], cpu, DEEP_REPLAY_TOL["rtol"], k)
        emit({"phase": "deep_cpu_replay", "preset": preset, "rounds": k, "ok": ok,
              "loss_max_rel_diff": rel, "tol": DEEP_REPLAY_TOL, "cpu_s": cpu_s})
        check(ok, f"deep {preset}: the card's first {k} rounds differ from the CPU's (rel {rel})")
        real, faulty = _faulted_round()
        rounds_mod.ROUND_DEFS["deep_svrp"] = faulty
        try:
            bad = deep_run(problem, x0, Draws(None, draws.coins[:k]), k, fused=True)
        finally:
            rounds_mod.ROUND_DEFS["deep_svrp"] = real
        ok, rel, _ = deep_gap(bad, cpu, DEEP_REPLAY_TOL["rtol"], k)
        emit({"phase": "deep_fault", "preset": preset, "fault": "the local loop starts from z",
              "rejected": not ok, "loss_max_rel_diff": rel})
        check(not ok, f"deep {preset}: the planted fault passed the CPU replay (rel {rel})")

        # One round under the profiler.
        one = Draws(None, draws.coins[:1])
        wall_ms, kernels = profiled(lambda: deep_run(problem, x0, one, 1, fused=True), 1)
        busy_ms = sum(t for t, _ in kernels.values()) / 1e3 if kernels else None
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        emit({"phase": "deep_profile", "preset": preset, "rounds": 1, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms,
              "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
              "kernel_launches": sum(c for _, c in kernels.values()),
              "top_kernels": [{"name": name[:80], "device_ms": t / 1e3, "count": c}
                              for name, (t, c) in top]})
        out[preset] = runs[None, True]
        del problem, x0, runs, cpu_problem, cpu, bad
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ online engine
ONLINE_SEEDS = 8
ONLINE_CHUNKS = (1, 49, 150)  # the Figure-1 session's step sizes: 200 rounds
ONLINE_STOP_EPS = 1e-8
ONLINE_STOP_ROUNDS = 1000
ONLINE_STOP_P = 0.01
ONLINE_POOL = [  # (Figure-1 draw seed, eta scale, horizon, stop_eps)
    (0, 1.0, 200, None), (1, 0.9, 300, None), (2, 0.8, 250, None), (3, 1.0, 600, 1e-6)]
ONLINE_POOL_TOL = dict(rtol=1e-5, atol=1e-24)
ONLINE_SERVER_ROUNDS = 500
ONLINE_SERVER_CHURN = 0.1
ONLINE_MINIBATCH = 10
ONLINE_DEEP_CHUNKS = (1, 2)
ONLINE_PROFILE_TICKS = 20


def _online_kw(qprob, scale=1.0):
    from repro_torch.core import theorem2_stepsize

    M = qprob.num_clients
    eta = theorem2_stepsize(float(qprob.strong_convexity()), float(qprob.similarity()))
    return dict(grid={"eta": scale * eta, "p": 1.0 / M}, seeds=ONLINE_SEEDS, device=qprob.device)


def _redrawing_session(algo, problem, **kw):
    """The planted fault: a session that draws its record again at every
    `step` call (fresh seeds each call) instead of reading the rows of the
    record drawn at open."""
    from repro_torch.core import draw_schedule
    from repro_torch.serve import open_session
    from repro_torch.serve.session import trial_step_def

    sess = open_session(algo, problem, **kw)
    real_step, calls = sess.step, [0]

    def step(n=1):
        calls[0] += 1
        fresh = draw_schedule(sess._seeds + 1000 * calls[0], problem.num_clients, sess.horizon,
                              sess._hparams["p"]).to(problem.device)
        sess._sds = [trial_step_def(algo, problem, sess._x0, sess._x_star, sess._hp, sess._cfg,
                                    fresh)]
        return real_step(n)

    sess.step = step
    return sess


def _session_gate(sess, full) -> tuple[bool, dict]:
    """A session stepped ONLINE_CHUNKS against run_batch over the same record."""
    import torch

    for n in ONLINE_CHUNKS:
        sess.step(n)
    same = (torch.equal(sess.dist_sq, full.dist_sq) and torch.equal(sess.comm, full.comm)
            and torch.equal(sess.x(), full.x_final))
    gap = float(((sess.dist_sq - full.dist_sq).abs() / full.dist_sq.abs()).max())
    return same, {"bit_identical": same, "dist_sq_max_rel_diff": gap}


def _frozen_lane_gate(qprobs, *, fault: bool) -> tuple[bool, dict]:
    """Two svrp tenants, the first with a stop_eps: once it freezes, 20 more
    ticks must leave its rounds, trajectory and bytes as they were and its
    rows of the pooled output zero.  ``fault``: a pool that keeps stepping a
    frozen lane (`PoolTenant.running` ignoring the freeze)."""
    from repro_torch.serve import SessionPool, pool as pool_mod

    real = pool_mod.PoolTenant.running
    if fault:
        pool_mod.PoolTenant.running = property(lambda self: not self.evicted)
    try:
        pool = SessionPool(capacity=2)
        a = pool.admit("svrp", qprobs[3], stop_eps=ONLINE_POOL[3][3], num_steps=600,
                       **_online_kw(qprobs[3]))
        pool.admit("svrp", qprobs[0], num_steps=600, **_online_kw(qprobs[0]))
        while not pool.is_frozen(a):
            pool.step(1)
        t_frozen, bytes_frozen = pool.session(a).t, int(pool.session(a).comm_bytes[:, -1].sum())
        rows_zero = True
        for _ in range(20):
            d2, comm = pool.step(1)
            rows_zero &= not bool(d2[0].any()) and not bool(comm[0].any())
        ses = pool.session(a)
        ok = (ses.t == t_frozen and rows_zero
              and int(ses.comm_bytes[:, -1].sum()) == bytes_frozen)
    finally:
        pool_mod.PoolTenant.running = real
    return ok, {"frozen_at": t_frozen, "t_after_20_ticks": ses.t, "rows_zero": rows_zero}


def _launches_per_call(fn, reps: int) -> float:
    _, kernels = profiled(fn, reps)
    return sum(c for _, c in kernels.values()) / reps


def phase_online() -> None:
    """The online round engine (`repro_torch.serve`): Figure-1 sessions,
    early stopping, a pool of four tenants, the streaming servers and their
    CPU replay, DeepSVRP sessions and a server on the 20m federated LM with
    exact K1 / K4 / K4b counts, and two planted faults."""
    import numpy as np
    import torch

    from repro_torch.core import Draws
    from repro_torch.experiments import run_batch
    from repro_torch.problems import make_synthetic_quadratic
    from repro_torch.serve import ClientStream, FedRoundServer, SessionPool, open_session

    def fig1(seed, device):
        return make_synthetic_quadratic(1000, 40, mu=1.0, L=3330.0, delta=10.0, seed=seed,
                                        device=device)

    qprobs = [fig1(seed, "cuda") for seed, *_ in ONLINE_POOL]
    qprob = qprobs[0]
    M = qprob.num_clients
    rounds = sum(ONLINE_CHUNKS)

    # 1. A Figure-1 session stepped 1 + 49 + 150 rounds == run_batch, bit
    # for bit; then the planted redraw-per-step fault must fail that gate.
    kw = dict(_online_kw(qprob), num_steps=rounds)
    full = run_batch("svrp", qprob, **kw)  # warm-up; timed again below
    sess = open_session("svrp", qprob, **kw)
    (ok, info), sess_s = _timed(lambda: _session_gate(sess, full))
    again, rb_s = _timed(lambda: run_batch("svrp", qprob, **kw))
    ok = ok and torch.equal(again.dist_sq, full.dist_sq)
    emit({"phase": "online_session", "problem": "fig1_quadratic", "algo": "svrp", "solver": "exact",
          "trials": full.num_trials, "chunks": list(ONLINE_CHUNKS), **info,
          "session_rounds_per_s": rounds / sess_s, "run_batch_rounds_per_s": rounds / rb_s,
          "card": CARD})
    check(ok, f"online: the Figure-1 session differs from run_batch ({info})")
    bad_ok, bad = _session_gate(_redrawing_session("svrp", qprob, **kw), full)
    emit({"phase": "online_fault", "fault": "the session draws its record again at each step",
          "rejected": not bad_ok, **bad})
    check(not bad_ok, "online: the redraw-per-step fault passed the session gate")

    # 2. run_batch(stop_eps=...): each trial's stopped round is its first
    # crossing in the full run's trajectory (p = 10 / M: at 1 / M a trial
    # that never refreshes in 1000 rounds never reaches eps).
    kw = dict(_online_kw(qprob), num_steps=ONLINE_STOP_ROUNDS)
    kw["grid"] = dict(kw["grid"], p=ONLINE_STOP_P)
    full = run_batch("svrp", qprob, **kw)
    stopped, stop_s = _timed(lambda: run_batch("svrp", qprob, stop_eps=ONLINE_STOP_EPS, **kw))
    d2 = full.dist_sq.cpu().numpy()
    hit = d2 <= ONLINE_STOP_EPS
    first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, -1)
    k = stopped.dist_sq.shape[1]
    prefix = bool(torch.equal(stopped.dist_sq, full.dist_sq[:, :k])
                  and torch.equal(stopped.comm, full.comm[:, :k]))
    emit({"phase": "online_stop_eps", "eps": ONLINE_STOP_EPS, "horizon": ONLINE_STOP_ROUNDS,
          "rounds_run": k, "stopped_round": stopped.stopped_round.tolist(),
          "first_crossing": first.tolist(), "prefix_bit_identical": prefix, "wall_s": stop_s,
          "card": CARD})
    check(np.array_equal(stopped.stopped_round, first) and prefix and (first > 0).all()
          and k < ONLINE_STOP_ROUNDS,
          f"online: stop_eps rounds {stopped.stopped_round} != first crossings {first}")

    # 3. A pool of four tenants (distinct Figure-1 draws, etas, horizons, one
    # with stop_eps) served by FedRoundServer(pool=...): each lane equals its
    # standalone session; launches a tick against a session's round.
    pool = SessionPool(capacity=len(ONLINE_POOL))
    tenants = []
    for prob, (_, scale, horizon, eps) in zip(qprobs, ONLINE_POOL):
        tkw = dict(_online_kw(prob, scale), num_steps=horizon)
        tenants.append((pool.admit("svrp", prob, stop_eps=eps, **tkw), prob, tkw))
    srv = FedRoundServer(pool=pool)
    stats = srv.run(max(h for _, _, h, _ in ONLINE_POOL))
    lanes = []
    for tid, prob, tkw in tenants:
        got = pool.result(tid)
        ref = open_session("svrp", prob, **tkw)
        ref.step(pool.session(tid).t)
        d_got, d_ref = got.dist_sq.cpu().numpy(), ref.dist_sq.cpu().numpy()
        lanes.append({"tenant": tid, "rounds": int(got.dist_sq.shape[1]),
                      "frozen": pool.is_frozen(tid),
                      "comm_equal": bool(torch.equal(got.comm, ref.comm)
                                         and np.array_equal(got.comm_bytes, ref.comm_bytes)),
                      "within_tol": bool(np.allclose(d_got, d_ref, **ONLINE_POOL_TOL)),
                      "dist_sq_max_rel_diff": float(np.max(np.abs(d_got - d_ref) / d_ref))})
    # One tick of a fresh four-tenant pool against the four sessions stepped
    # one round each in turn (what the pool replaces): launches and ms.
    fresh = SessionPool(capacity=len(ONLINE_POOL))
    alone = []
    for prob, (_, scale, horizon, _) in zip(qprobs, ONLINE_POOL):
        fresh.admit("svrp", prob, num_steps=horizon, **_online_kw(prob, scale))
        alone.append(open_session("svrp", prob, num_steps=horizon, **_online_kw(prob, scale)))

    def in_turn():
        for a in alone:
            a.step(1)

    n = ONLINE_PROFILE_TICKS
    tick_launches = _launches_per_call(lambda: fresh.step(1), n)
    turn_launches = _launches_per_call(in_turn, n)
    _, tick_s = _timed(lambda: [fresh.step(1) for _ in range(n)])
    _, turn_s = _timed(lambda: [in_turn() for _ in range(n)])
    emit({"phase": "online_pool", "tenants": len(ONLINE_POOL), "stacked": pool.stacked,
          "ticks": stats.rounds, **stats.summary(), "lanes": lanes,
          "launches_per_tick": tick_launches, "launches_tenant_by_tenant": turn_launches,
          "ms_per_tick": tick_s / n * 1e3, "ms_tenant_by_tenant": turn_s / n * 1e3,
          "tenant_rounds_per_s": pool.total_rounds / stats.elapsed_s[-1], "card": CARD})
    check(all(v["comm_equal"] and v["within_tol"] for v in lanes),
          f"online: a pooled lane differs from its standalone session ({lanes})")
    check(pool.is_frozen(tenants[3][0]) and lanes[3]["rounds"] < ONLINE_POOL[3][2],
          "online: the stop_eps tenant did not freeze before its horizon")
    for fault in (False, True):
        ok, info = _frozen_lane_gate(qprobs, fault=fault)
        emit({"phase": "online_fault" if fault else "online_frozen_lane",
              "fault": "the pool keeps stepping a frozen lane" if fault else None,
              "passed": ok, **info})
        check(ok != fault, f"online: frozen-lane gate {'passed a fault' if fault else 'failed'} "
                           f"({info})")

    # 4. The streaming servers under churn, 500 rounds; their first 20 rounds
    # against the same servers on the CPU (the draws are made on the host
    # from the same generator and masks, so they are the same draws).
    cpu_q = fig1(0, "cpu")
    kw = _online_kw(qprob)["grid"]
    for algo, extra in (("svrp", {}), ("svrp_minibatch", {"batch_clients": ONLINE_MINIBATCH})):
        def server(problem, device):
            return FedRoundServer(algo, problem, hparams=kw, seed=0, device=device,
                                  stream=ClientStream(M, churn=ONLINE_SERVER_CHURN, seed=1),
                                  **extra)

        srv = server(qprob, "cuda")
        stats = srv.run(ONLINE_SERVER_ROUNDS)
        s = stats.summary()
        cpu = server(cpu_q, "cpu").run(CPU_REPLAY_ROUNDS)
        k = CPU_REPLAY_ROUNDS
        same_comm = stats.comm[:k] == cpu.comm and stats.comm_bytes[:k] == cpu.comm_bytes
        rel = float(np.max(np.abs(np.array(stats.dist_sq[:k]) - cpu.dist_sq)
                           / np.abs(cpu.dist_sq)))
        emit({"phase": "online_server", "algo": algo, "clients": M,
              "churn": ONLINE_SERVER_CHURN, **s, "cpu_replay_rounds": k,
              "cpu_replay_comm_equal": same_comm, "cpu_replay_max_rel_diff": rel,
              "dist_sq_initial": stats.dist_sq[0], "card": CARD})
        check(s["rounds"] == ONLINE_SERVER_ROUNDS and np.isfinite(stats.dist_sq).all(),
              f"online: {algo} server rounds or dist_sq")
        check(same_comm and rel <= CPU_REPLAY_RTOL,
              f"online: {algo} server's first {k} rounds differ from the CPU (rel {rel})")
        check(stats.dist_sq[-1] < 1e-2 * stats.dist_sq[0],
              f"online: {algo} server made no progress under churn")
    del qprobs, qprob, cpu_q, pool, fresh, alone, sess, full, again, stopped
    torch.cuda.empty_cache()

    # 5. DeepSVRP on the 20m federated LM: a session stepped 1 + 2 rounds ==
    # run_batch (registry) over the same coins, bit for bit, each with the
    # exact K1 / K4 / K4b counts; then a server, 3 rounds.
    ex = _load_example("fed_transformer_torch")
    problem, x0 = ex.make_problem("20m", DEEP_CLIENTS, DEEP_ALPHA, 0, "cuda")
    R = sum(ONLINE_DEEP_CHUNKS)
    from repro_torch.core import draw_schedule

    draws = draw_schedule(list(range(DEEP_SEEDS)), DEEP_CLIENTS, R, DEEP_HP["anchor_prob"],
                          clients=False)
    expected, formula = deep_expected(problem.cfg, R, draws)
    zero_launch_counts(DEEP_KERNELS)
    full, rb_s = _timed(lambda: deep_run(problem, x0, Draws(None, draws.coins), R, fused=False))
    rb_counts = launch_counts(DEEP_KERNELS)
    zero_launch_counts(DEEP_KERNELS)

    def session():
        sess = open_session("deep_svrp", problem, grid=dict(
            eta=DEEP_HP["eta"], local_lr=DEEP_HP["local_lr"],
            anchor_prob=DEEP_HP["anchor_prob"]), seeds=list(range(DEEP_SEEDS)), x0=x0,
            x_star=x0, num_steps=R, local_steps=DEEP_HP["local_steps"],
            draws=Draws(None, draws.coins))
        for n in ONLINE_DEEP_CHUNKS:
            sess.step(n)
        return sess

    sess, sess_s = _timed(session)
    sess_counts = launch_counts(DEEP_KERNELS)
    same = bool(torch.equal(sess.dist_sq, full.dist_sq) and torch.equal(sess.comm, full.comm)
                and torch.equal(sess.x(), full.x_final))
    emit({"phase": "online_deep_session", "preset": "20m", "trials": DEEP_SEEDS,
          "chunks": list(ONLINE_DEEP_CHUNKS), "bit_identical": same,
          "session_s_per_round": sess_s / R, "run_batch_s_per_round": rb_s / R,
          "launches": sess_counts, "run_batch_launches": rb_counts,
          "expected_launches": expected, "launch_formula": formula,
          "flops_per_trial": sess.flops[:, -1].tolist(), "card": CARD})
    check(same, "online: the 20m DeepSVRP session differs from run_batch")
    check(sess_counts == expected and rb_counts == expected,
          f"online: 20m session launched {sess_counts}, run_batch {rb_counts}, "
          f"expected {expected} ({formula})")
    zero_launch_counts(DEEP_KERNELS)
    srv = FedRoundServer("deep_svrp", problem, x0=x0, x_star=x0, seed=0,
                         hparams={k: DEEP_HP[k] for k in ("eta", "local_lr", "anchor_prob")},
                         local_steps=DEEP_HP["local_steps"])
    stats = srv.run(R)
    counts = launch_counts(DEEP_KERNELS)
    Mc, K, L = DEEP_CLIENTS, DEEP_HP["local_steps"], problem.cfg.num_layers
    refresh = int(np.sum(np.diff([3 * Mc] + stats.comm) == 4 * Mc))
    grads = Mc + R * Mc * (1 + K) + refresh * Mc
    want = {"prox_update_batched": K * R, "flash_attention": L * (grads + R * Mc),
            "flash_attention_bwd": L * grads}
    s = stats.summary()
    emit({"phase": "online_deep_server", "preset": "20m", **s, "launches": counts,
          "expected_launches": want, "refresh_rounds": refresh, "card": CARD})
    check(counts == want and np.isfinite(stats.dist_sq).all(),
          f"online: the 20m server launched {counts}, expected {want}")
    del problem, x0, full, sess, srv
    torch.cuda.empty_cache()


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------- attention (K4, K5)
def attention_pairs(Sq: int, Skv: int, causal: bool, window, q_offset: int = 0) -> int:
    """(query, key) pairs the mask allows: the work K4 does on these inputs."""
    import numpy as np

    qp = np.arange(Sq)[:, None] + q_offset
    kp = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return int(mask.sum())


def _err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def k4_case(gen, B, Sq, Skv, H, KVH, Dh, dtype, *, causal=True, window=None,
            plant_fault=False):
    """K4 against its plain version on one input, timed beside the bound and
    SDPA.  With ``plant_fault`` (bf16 at Dh 64 / 128, the wgmma route), K4
    also runs dropping the last key tile of every row block, which the check
    must reject."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    dname = str(dtype).split(".")[-1]
    q = torch.randn(B, Sq, H, Dh, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, Skv, KVH, Dh, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, Skv, KVH, Dh, generator=gen, device="cuda", dtype=dtype)
    kw = dict(causal=causal, sliding_window=window)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **K4_TOL[dname])
    route = fa.forward_route(dtype, Dh)
    planted = None
    if plant_fault:
        check(route == "wgmma_tma", f"flash_attention: the planted fault needs the wgmma route, "
                                    f"not {route}")
        fa._FWD_SKIP_LAST_KEY_TILES = 1
        try:
            wrong = flash_attention(q, k, v, **kw)
        finally:
            fa._FWD_SKIP_LAST_KEY_TILES = 0
        planted = _err(wrong, ref)
        check(not torch.allclose(wrong.float(), ref.float(), **K4_TOL[dname]),
              f"flash_attention {[B, Sq, Skv, H, KVH, Dh]}: planted fault (last key tile "
              f"skipped) passed the check: max abs err {planted}")
    pairs = attention_pairs(Sq, Skv, causal, window)
    b_ms, b_by = bound_ms((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                          4 * B * H * Dh * pairs, dname)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, heads, S, Dh) views
    if window is None and (not causal or Sq == Skv):
        sdpa_kw = dict(is_causal=causal)
    else:  # absolute-position masks SDPA's is_causal does not express
        qp = torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Skv, device="cuda")[None, :]
        mask = (qp >= kp) if causal else torch.ones(Sq, Skv, dtype=torch.bool, device="cuda")
        if window is not None:
            mask &= qp - kp < window
        sdpa_kw = dict(attn_mask=mask)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)

    big = B * Sq * H > 100_000
    return dict(shape=[B, Sq, Skv, H, KVH, Dh], dtype=dname, causal=causal, window=window,
                route=route, max_abs_err=_err(out, ref), tol=K4_TOL[dname],
                planted_fault_last_tile_skipped_max_abs_err=planted,
                ms=time_ms(lambda: flash_attention(q, k, v, **kw), 10 if big else 50),
                plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw), 3 if big else 20, 1),
                library_ms=time_ms(sdpa, 10 if big else 50),
                device_ms=device_ms(lambda: flash_attention(q, k, v, **kw), 10),
                bound_ms=b_ms, bound_by=b_by, pairs=pairs)


def k5_verdict(out, ref, low: str) -> dict:
    """K5's errors against its plain version and whether they meet the
    reference's tolerance and, with a bf16 operand, the scaled limit."""
    import torch
    from torch.linalg import vector_norm

    out, ref = out.float(), ref.float()
    max_abs = (out - ref).abs().max().item()
    rel_l2 = (vector_norm(out - ref) / vector_norm(ref)).item()
    reference_tol = bool(torch.allclose(out, ref, **K5_TOL[low]))
    scaled = low == "float32" or (max_abs <= K5_BF16_SCALED * ref.abs().max().item()
                                  and rel_l2 <= K5_BF16_SCALED)
    return dict(max_abs_err=max_abs, rel_l2=rel_l2, reference_tol=reference_tol,
                scaled_limit=scaled, ok=reference_tol and scaled)


def k5_case(gen, B, S, H, KVH, Dh, q_dtype, cache_dtype, mask_kind):
    """K5 against its plain version, timed beside the bound and SDPA; and
    two planted faults (masks K5 is handed wrongly) that the check must reject."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    q = torch.randn(B, 1, H, Dh, generator=gen, device="cuda", dtype=q_dtype)
    k = torch.randn(B, S, KVH, Dh, generator=gen, device="cuda", dtype=cache_dtype)
    v = torch.randn(B, S, KVH, Dh, generator=gen, device="cuda", dtype=cache_dtype)
    idx = torch.arange(S, device="cuda")
    if mask_kind == "prefix":  # a full cache at position 3000
        valid = idx <= 3000
    else:  # a ring buffer of S slots at position 5000 under a 2048-token window
        pos, window = 5000, 2048
        abs_pos = idx + S * torch.div(pos - idx, S, rounding_mode="floor")
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (pos - abs_pos < window)
    out = decode_attention(q, k, v, valid)
    ref = decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    low = "bfloat16" if torch.bfloat16 in (q_dtype, cache_dtype) else "float32"
    verdict = k5_verdict(out, ref, low)
    check(verdict["ok"], f"decode_attention {mask_kind} {q_dtype}/{cache_dtype}: {verdict}")
    one_row = valid.clone()
    one_row[int(valid.nonzero().max())] = False
    faults = {"one_stream_dropped": valid & ((idx // K5_STREAM_ROWS) % K5_STREAMS != 0),
              "one_row_dropped": one_row}
    planted = {}
    for name, wrong in faults.items():
        planted[name] = k5_verdict(decode_attention(q, k, v, wrong), ref, low)
        check(not planted[name]["ok"], f"decode_attention: planted fault {name} passed the "
                                       f"check: {planted[name]}")
    n_valid = int(valid.sum())
    b_ms, b_by = bound_ms(2 * q.numel() * q.element_size() + S
                          + 2 * B * KVH * Dh * n_valid * k.element_size(),
                          4 * B * H * Dh * n_valid, "float32")
    # SDPA takes one dtype: q is cast to the cache's outside the timed call.
    qs = q.to(cache_dtype).transpose(1, 2)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = valid[None, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)

    return dict(shape=[B, S, H, KVH, Dh], q_dtype=str(q_dtype).split(".")[-1],
                cache_dtype=str(cache_dtype).split(".")[-1], mask=mask_kind, valid=n_valid,
                max_abs_err=verdict["max_abs_err"], rel_l2=verdict["rel_l2"], tol=K5_TOL[low],
                scaled_limit=None if low == "float32" else K5_BF16_SCALED,
                planted_faults=planted,
                ms=time_ms(lambda: decode_attention(q, k, v, valid), 100),
                plain_ms=time_ms(lambda: decode_attention_plain(q, k, v, valid), 20),
                library_ms=time_ms(sdpa, 100),
                device_ms=device_ms(lambda: decode_attention(q, k, v, valid), 20),
                bound_ms=b_ms, bound_by=b_by)


def phase_attention_parity() -> dict:
    """K4 and K5 against their plain versions at the serving path's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    k4 = {dname: k4_case(gen, 4, 2048, 2048, 24, 8, 128, dt, plant_fault=dt == bf16)
          for dname, dt in (("bfloat16", bf16), ("float32", f32))}
    small = [k4_case(gen, 2, 1000, 1000, 8, 2, 128, dt, window=256) for dt in (bf16, f32)]
    small += [k4_case(gen, 2, 300, 700, 8, 4, 64, dt, causal=False) for dt in (bf16, f32)]
    small += [k4_case(gen, 2, 513, 513, 32, 8, 80, dt) for dt in (bf16, f32)]
    small += [k4_case(gen, 1, 257, 257, 32, 8, 64, dt, window=64, plant_fault=dt == bf16)
              for dt in (bf16, f32)]
    k5 = {(str(c).split(".")[-1], m): k5_case(gen, 8, 4096, 24, 8, 128, bf16, c, m)
          for c in (f32, bf16) for m in ("prefix", "ring")}
    emit({"phase": "attention_parity", "flash_attention": list(k4.values()),
          "flash_attention_small": small, "decode_attention": list(k5.values()),
          "library": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True), "
                     "timed only as a yardstick"})
    return {"flash_attention": k4["bfloat16"], "decode_attention": k5[("float32", "prefix")]}


# ------------------------------------------------------------------ serving
@contextlib.contextmanager
def rebind(module, **fns):
    """Rebind names of ``module`` (looked up there at call time) for the
    block's duration."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def rebind_ops(**fns):
    """Rebind kernel entry points of `repro_torch.kernels.ops` (the model and
    round code look them up there at call time) for the block's duration."""
    from repro_torch.kernels import ops

    return rebind(ops, **fns)


def plain_attention(fault: bool = False):
    """The model's attention through the plain versions, on the card; with
    ``fault``, through plain versions with one planted fault each: full-
    sequence attention skips the first 64-key tile (queries 0-63 get 0), and
    decode attention drops the rows of one of K5's half-warp streams."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    def skip_first_tile(q, k, v, *, causal=True, sliding_window=None, q_offset=0):
        return flash_attention_plain(q, k[:, 64:], v[:, 64:], causal=causal,
                                     sliding_window=sliding_window, q_offset=q_offset - 64)

    def drop_stream(q, k_cache, v_cache, valid):
        idx = torch.arange(valid.shape[0], device=valid.device)
        return decode_attention_plain(q, k_cache, v_cache,
                                      valid & ((idx // K5_STREAM_ROWS) % K5_STREAMS != 0))

    if fault:
        return rebind_ops(attention=skip_first_tile, decode_attention=drop_stream)
    return rebind_ops(attention=flash_attention_plain, decode_attention=decode_attention_plain)


def rel_err(a, b) -> float:
    """||a - b||_2 / ||b||_2 in float32."""
    from torch.linalg import vector_norm

    a, b = a.float(), b.float()
    return (vector_norm(a - b) / vector_norm(b)).item()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def serving_prompts(vocab: int):
    """8 prompts of 128-512 tokens (numpy seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n).tolist() for n in rng.integers(128, 513, 8)]


REPLAY_CHECK_KEYS = ("rel_err_vs_plain_max", "rel_err_vs_plain_median", "planted_fault_rel_err")


def decode_replay(cfg, params, prompts, out, cache_len: int, plain=plain_attention,
                  fault=lambda: plain_attention(fault=True)) -> dict:
    """A served batch replayed teacher-forced on the card: every step with the
    kernels and with the plain versions (``plain()``, default the plain
    attention) in lockstep, each step's logits compared, and from the last
    prompt token on, on a copy of the plain run's cache, under ``fault()``
    (default a planted K5 fault: one half-warp stream's rows dropped)."""
    import numpy as np
    import torch

    from repro_torch.launch import make_serve_step
    from repro_torch.models import init_decode_cache

    step = make_serve_step(cfg)
    n, new = len(prompts), len(out[0])
    plen = max(len(p) for p in prompts)
    seq = np.zeros((n, plen + new), np.int64)
    for i, (p, o) in enumerate(zip(prompts, out)):
        seq[i, plen - len(p):plen] = p
        seq[i, plen:] = o
    seq = torch.from_numpy(seq).cuda()
    cache_k = init_decode_cache(cfg, n, cache_len, dtype=torch.float32)
    cache_p = init_decode_cache(cfg, n, cache_len, dtype=torch.float32)
    rels, agree, reproduced, fault_rels = [], [], [], []
    t0 = time.perf_counter()
    for t in range(plen + new - 1):
        lk, cache_k = step(params, cache_k, seq[:, t], t)
        with plain():
            lp, cache_p = step(params, cache_p, seq[:, t], t)
        rels.append(rel_err(lk, lp))
        if t >= plen - 1:  # logits that chose a served token
            if t == plen - 1:  # the planted fault acts from here, on a copy of the cache
                cache_f = _tree(lambda c: c.clone(), cache_p)
            with fault():
                lf, cache_f = step(params, cache_f, seq[:, t], t)
            fault_rels.append(rel_err(lf, lp))
            served = seq[:, t + 1]
            reproduced.append((lk.argmax(-1) == served).float().mean().item())
            agree.append((lp.argmax(-1) == served).float().mean().item())
    return {"rel_err_vs_plain_max": max(rels), "rel_err_vs_plain_median": float(np.median(rels)),
            "worst_step": int(np.argmax(rels)),
            "planted_fault_rel_err": {"max": max(fault_rels),
                                      "median": float(np.median(fault_rels)),
                                      "min": min(fault_rels)},
            "kernel_replay_reproduces_served_tokens": float(np.mean(reproduced)),
            "plain_greedy_agrees_with_served": float(np.mean(agree)),
            "replay_s": time.perf_counter() - t0}


def check_decode_replay(replay: dict, model: str, kernel: str = "K5") -> None:
    check(replay["rel_err_vs_plain_max"] <= SERVE_REL_TOL,
          f"{model}decode step {replay['worst_step']}: logits differ from the plain replay by "
          f"{replay['rel_err_vs_plain_max']} > {SERVE_REL_TOL}")
    check(replay["planted_fault_rel_err"]["max"] > SERVE_REL_TOL,
          f"a planted {kernel} fault moved the {model}decode logits by at most "
          f"{replay['planted_fault_rel_err']['max']}")


def phase_serving():
    """Prefill and batched greedy generation on Llama-3.2-3B at full size,
    through K4 and K5, then replayed with the plain attention."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params

    cfg = get_config("llama3.2-3b")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg)  # seed 0 on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))  # param_count() leaves out the norms

    # (a) prefill: 4 x 2048 tokens, last-position logits
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 2048)))
    tokens = tokens.cuda()
    prefill(params, {"tokens": tokens[:, :128]})  # warm-up (cuBLAS handles, kernel load)
    calls = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(SERVE_KERNELS)
    t0 = time.perf_counter()
    for _ in range(calls):
        logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / calls
    k4_prefill, k5_prefill = launch_counts(SERVE_KERNELS).values()
    prefill_peak = torch.cuda.max_memory_allocated()
    check(k4_prefill == L * calls and k5_prefill == 0,
          f"prefill launched K4 {k4_prefill} times (want {L * calls}) and K5 {k5_prefill}")
    B, S = tokens.shape
    check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} not finite of shape ({B}, {cfg.vocab_size})")
    with plain_attention():
        plain_logits = prefill(params, {"tokens": tokens})
    with plain_attention(fault=True):
        prefill_fault_rel = rel_err(prefill(params, {"tokens": tokens}), plain_logits)
    prefill_rel = rel_err(logits, plain_logits)
    prefill_agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
    emit({"phase": "serving_prefill_check", "rel_err_vs_plain": prefill_rel,
          "planted_fault_rel_err": prefill_fault_rel, "rel_tol": SERVE_REL_TOL})
    check(prefill_rel <= SERVE_REL_TOL,
          f"prefill logits differ from the plain replay by {prefill_rel} > {SERVE_REL_TOL}")
    check(prefill_fault_rel > SERVE_REL_TOL,
          f"a planted K4 fault moved the prefill logits by only {prefill_fault_rel}")
    del plain_logits
    model = (f"{cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads}"
             f" heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.param_dtype}")
    emit({"phase": "serving_prefill", "model": model, "params": n_params,
          "param_count": cfg.param_count(),
          "init_s": init_s, "batch": [B, S], "calls": calls, "s_per_call": prefill_s,
          "tokens_per_s": B * S / prefill_s, "peak_mem_gb": prefill_peak / 1e9,
          "launches": {"flash_attention": k4_prefill, "decode_attention": k5_prefill},
          "rel_err_vs_plain": prefill_rel, "argmax_agree": prefill_agree,
          "rel_tol": SERVE_REL_TOL, "planted_fault_rel_err": prefill_fault_rel,
          "max_abs_logit": logits.float().abs().max().item()})

    # (b) batched greedy generation
    serve = ServeConfig(max_batch=8, cache_len=1024)
    server = BatchServer(cfg, params, serve)
    prompts = serving_prompts(cfg.vocab_size)
    new = 64
    server.generate([p[:8] for p in prompts], max_new_tokens=2)  # warm-up
    plen = max(len(p) for p in prompts)
    steps = plen + new - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(SERVE_KERNELS)
    t0 = time.perf_counter()
    out = server.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    k4_gen, k5_gen = launch_counts(SERVE_KERNELS).values()
    gen_peak = torch.cuda.max_memory_allocated()
    check(k5_gen == L * steps and k4_gen == 0,
          f"generate launched K5 {k5_gen} times (want {L} x {steps} steps) and K4 {k4_gen}")
    check(len(out) == 8 and all(len(o) == new and all(0 <= t < cfg.vocab_size for t in o)
                                for o in out), "generate returned malformed tokens")

    # (c) teacher-forced replay: the kernels and the plain versions in lockstep
    replay = decode_replay(cfg, params, prompts, out, serve.cache_len)
    emit({"phase": "serving_generate_check", **{k: replay[k] for k in REPLAY_CHECK_KEYS},
          "rel_tol": SERVE_REL_TOL})
    check_decode_replay(replay, "")
    emit({"phase": "serving_generate", "prompts": [len(p) for p in prompts], "max_batch": 8,
          "cache_len": serve.cache_len, "cache_dtype": serve.cache_dtype, "new_tokens": new,
          "decode_steps": steps, "wall_s": gen_s, "ms_per_decode_step": gen_s / steps * 1e3,
          "decode_tokens_per_s": 8 * steps / gen_s, "generated_tokens_per_s": 8 * new / gen_s,
          "peak_mem_gb": gen_peak / 1e9,
          "launches": {"flash_attention": k4_gen, "decode_attention": k5_gen},
          "rel_tol": SERVE_REL_TOL, **replay})
    launches = {"flash_attention": k4_prefill, "decode_attention": k5_gen}
    return cfg, params, tokens, launches


def phase_serving_profile(cfg, params, tokens) -> None:
    """Where serving time goes: one prefill call, and 16 decode steps of the
    8-row batch at positions 528-543 of a 1024-slot float32 cache (after a
    warm-up round of 16 steps from position 512)."""
    import torch

    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_cache

    prefill = make_prefill_step(cfg)
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, 8, 1024, dtype=torch.float32)
    tok = tokens.reshape(-1)[:8]
    pos = iter(range(512, 10**6))

    def decode16():
        for _ in range(16):
            step(params, cache, tok, next(pos))

    B, S = tokens.shape
    for label, fn in ((f"prefill {B} x {S}", lambda: prefill(params, {"tokens": tokens})),
                      ("decode 16 steps x 8 rows", decode16)):
        wall_ms, kernels = profiled(fn, 1)
        busy_ms = sum(t for t, _ in kernels.values()) / 1e3 if kernels else None
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        emit({"phase": "serving_profile", "model": cfg.name, "run": label, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms,
              "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
              "kernel_launches": sum(c for _, c in kernels.values()),
              "top_kernels": [{"name": name[:80], "device_ms": t / 1e3, "count": c}
                              for name, (t, c) in top]})



# --------------------------------------------------------- hybrid (K6)
def ssm_inputs(gen, shape, dtype, *, strong=False, with_state=False, stride=1):
    """K6's operands as the model hands them: x, B and C column views of one
    (B, T, H P + 2 N) tensor (with ``stride`` 2, of every other column of a
    tensor twice as wide); dt after softplus (float32); A = -linspace(1,
    16, H) as at init (with ``strong``: A = -16 and dt in [0.5, 4]); D
    normal; an optional normal state0."""
    import torch
    import torch.nn.functional as F

    Bb, T, H, P, N = shape
    W = H * P + 2 * N
    xbc = torch.randn(Bb, T, stride * W, generator=gen, device="cuda").to(dtype)[..., ::stride]
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    if strong:
        dt = torch.rand(Bb, T, H, generator=gen, device="cuda") * 3.5 + 0.5
        A = torch.full((H,), -16.0, device="cuda")
    else:
        dt = F.softplus(torch.randn(Bb, T, H, generator=gen, device="cuda") - 1.0)
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
    D = torch.randn(H, generator=gen, device="cuda")
    s0 = torch.randn(Bb, H, P, N, generator=gen, device="cuda") if with_state else None
    return x, dt, A, Bm, Cm, D, s0


def ssm_scan_no_carry(x, dt, A, B_mat, C_mat, D, state0=None):
    """The planted K6 fault: K6 run chunk by chunk with the state not carried
    from one chunk to the next (the inter-chunk term dropped)."""
    import torch

    from repro_torch.kernels.ssm_scan import ssm_scan

    ys, h = [], None
    for t0 in range(0, x.shape[1], K6_CHUNK):
        c = slice(t0, t0 + K6_CHUNK)
        y, h = ssm_scan(x[:, c], dt[:, c], A, B_mat[:, c], C_mat[:, c], D,
                        state0 if t0 == 0 else None)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def recurrence_f64(x, dt, A, B_mat, C_mat, D, state0=None):
    """The reference's oracle `ref.ssm_scan`, the one-step recurrence, in
    float64: the yardstick of K6's float32 accuracy."""
    import torch

    f64 = torch.float64
    x, dt, A, B_mat, C_mat, D = (t.to(f64) for t in (x, dt, A, B_mat, C_mat, D))
    Bb, T, H, P = x.shape
    h = (torch.zeros(Bb, H, P, B_mat.shape[-1], dtype=f64, device=x.device)
         if state0 is None else state0.to(f64))
    y = torch.empty(Bb, T, H, P, dtype=f64, device=x.device)
    for t in range(T):
        h = torch.exp(A * dt[:, t])[..., None, None] * h \
            + (dt[:, t, :, None] * x[:, t])[..., None] * B_mat[:, t][:, None, None, :]
        y[:, t] = torch.einsum("bhpn,bn->bhp", h, C_mat[:, t]) + D[None, :, None] * x[:, t]
    return y, h


def k6_verdict(y, h, want_y, want_h, dname: str, truth=None) -> dict:
    """K6's errors against a plain result and whether they meet its
    tolerances.  bf16: the reference's, element by element.  float32: the
    reference's 2e-4 in relative L2, against the plain result and against
    the float64 recurrence ``truth`` where given; element by element it is
    reported.  At N 64 and A down to -16 the chunked form's exponent
    cum[t] - cum[s] loses ~|cum| 2^-24 to cancellation, and two right
    float32 results (K6 chunks at 64 steps, the plain version at 128) differ
    by up to ~2e-3 at single elements of magnitude ~10, each ~1e-3 from the
    float64 recurrence at its worst element."""
    import torch

    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    tol = K6_TOL[dname]
    yf, wf = y.float(), want_y.float()
    over = (yf - wf).abs() > tol["atol"] + tol["rtol"] * wf.abs()
    res = dict(max_abs_err=_err(y, want_y), rel_l2=rel_err(y, want_y),
               state_max_abs_err=_err(h, want_h), state_rel_l2=rel_err(h, want_h),
               elements_over_tol=int(over.sum()), finite=finite)
    ok = finite and bool(torch.allclose(h, want_h, **K6_STATE_TOL))
    if dname == "bfloat16":
        res["ok"] = ok and res["elements_over_tol"] == 0
        return res
    ok = ok and res["rel_l2"] <= tol["rtol"]
    if truth is not None:
        res["rel_l2_vs_f64"] = rel_err(y.double(), truth[0])
        res["max_abs_err_vs_f64"] = (y.double() - truth[0]).abs().max().item()
        res["plain_max_abs_err_vs_f64"] = (want_y.double() - truth[0]).abs().max().item()
        ok = ok and res["rel_l2_vs_f64"] <= tol["rtol"]
    res["ok"] = ok
    return res


def k6_case(gen, shape, dtype, *, strong=False, with_state=False, against_ref=False,
            timed=False, stride=1):
    """K6 against its plain version (and with ``against_ref`` the sequential
    recurrence) on one input; with ``timed``, K6 timed beside its bound and
    the plain version, and the planted faults, which must fail the check."""
    import torch

    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain, ssm_scan_ref

    dname = str(dtype).split(".")[-1]
    args = ssm_inputs(gen, shape, dtype, strong=strong, with_state=with_state, stride=stride)
    y, h = ssm_scan(*args)
    want_y, want_h = ssm_scan_plain(*args)
    torch.cuda.synchronize()
    truth = recurrence_f64(*args) if dname == "float32" else None
    route = sm.scan_route(dtype, shape[3], shape[4])
    res = dict(shape=list(shape), dtype=dname, route=route, strong_decay=strong,
               state0=with_state, stride=stride, **k6_verdict(y, h, want_y, want_h, dname, truth))
    check(res["ok"], f"ssm_scan {shape} {dname} strong={strong} state0={with_state}: {res}")
    if against_ref:
        ref_y, ref_h = ssm_scan_ref(*args)
        res["vs_ref"] = k6_verdict(y, h, ref_y, ref_h, dname)
        check(res["vs_ref"]["ok"], f"ssm_scan {shape} {dname} against the recurrence: {res}")
    if not timed:
        return res
    res["planted_fault"] = k6_verdict(*ssm_scan_no_carry(*args), want_y, want_h, dname, truth)
    check(not res["planted_fault"]["ok"],
          f"ssm_scan: a state not carried across chunks passed the check: {res['planted_fault']}")
    if route == "tensor_core":
        sm._DROP_LOW_HALF = True
        try:
            res["planted_fault_low_half"] = k6_verdict(*ssm_scan(*args), want_y, want_h, dname)
        finally:
            sm._DROP_LOW_HALF = False
        check(not res["planted_fault_low_half"]["ok"],
              f"ssm_scan: split operands without their low parts passed the check: "
              f"{res['planted_fault_low_half']}")
    Bb, T, H, P, N = shape
    esz = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * Bb * T * H * P * esz + Bb * T * H * 4 + 2 * Bb * T * N * esz + 2 * H * 4 \
        + Bb * H * P * N * 4 * (2 if with_state else 1)
    # operations of the reference's 128-step chunk form: C B^T, (L o C B^T)(dt x),
    # C h^T and the state update, per chunk and (b, h)
    Q = 128
    flops = -(-T // Q) * Bb * H * (2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * P * N)
    b_ms, b_by = bound_ms(nbytes, flops, dname)
    res.update(bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
               ms=time_ms(lambda: ssm_scan(*args), 10),
               plain_ms=time_ms(lambda: ssm_scan_plain(*args), 3, 1),
               device_ms=device_ms(lambda: ssm_scan(*args), 5), library_ms=None)
    res["bound_share"] = b_ms / res["ms"]
    return res


def phase_ssm_parity() -> dict:
    """K6 against its plain version on the card: Zamba2's prefill shape in
    bf16 and float32 (timed), T off the chunk, a given state0, strong decay,
    an odd head count, operands at an inner stride of 2, the reduced P 128 /
    N 16, and against the sequential recurrence at T <= 256; the planted
    faults must fail."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    zamba = (4, 2048, 80, 64, 64)
    main = {str(dt).split(".")[-1]: k6_case(gen, zamba, dt, timed=True) for dt in (bf16, f32)}
    cases = []
    for dt in (bf16, f32):
        cases += [k6_case(gen, (2, 1000, 80, 64, 64), dt),
                  k6_case(gen, (2, 512, 80, 64, 64), dt, with_state=True),
                  k6_case(gen, (2, 300, 5, 64, 64), dt, with_state=True),
                  k6_case(gen, (2, 300, 80, 64, 64), dt, with_state=True, stride=2),
                  k6_case(gen, (2, 512, 80, 64, 64), dt, strong=True, with_state=True),
                  k6_case(gen, (2, 1000, 4, 128, 16), dt, with_state=True),
                  k6_case(gen, (2, 256, 8, 64, 64), dt, with_state=True, against_ref=True),
                  k6_case(gen, (1, 200, 4, 128, 16), dt, strong=True, against_ref=True)]
    emit({"phase": "ssm_parity", "ssm_scan": list(main.values()), "ssm_scan_cases": cases,
          "library": None, "library_note": "no single PyTorch call computes the scan"})
    return main["bfloat16"]


def scan_ops(mode: str):
    """Rebind the model's scan: "plain" runs the plain version on the card,
    "fault" K6 with the state not carried across chunks."""
    from repro_torch.kernels.ssm_scan import ssm_scan_plain

    return rebind_ops(ssm_scan=ssm_scan_plain if mode == "plain" else ssm_scan_no_carry)


@contextlib.contextmanager
def hybrid_plain():
    """The hybrid model's scan and attention through their plain versions
    (decode runs no scan: there the attention alone)."""
    with plain_attention(), scan_ops("plain"):
        yield


def randomize_hybrid(params, cfg, seed: int) -> None:
    """Fill LoRA b, conv_b and D (zeros and ones at init, where a wrong LoRA
    or conv-bias wiring would add exactly zero) with seeded values, in place:
    b normal * rank**-0.5, conv_b normal * 0.1, D normal."""
    import torch

    gen = torch.Generator(device=params["embed"]["emb"].device).manual_seed(seed)

    def fill(t, scale):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * scale)

    for site in params["loras"].values():
        fill(site["b"], cfg.hybrid_lora_rank**-0.5)
    fill(params["mamba_layers"]["conv_b"], 0.1)
    fill(params["mamba_layers"]["D"], 1.0)


def hybrid_counts(cfg) -> tuple[dict, dict]:
    """Launches a prefill call (K6 a Mamba-2 layer, K4 an attention site) and
    a decode step (K5 an attention site; K6 never: decode is the one-step
    recurrence)."""
    G = cfg.num_layers // cfg.attn_every
    n_mamba = G * (cfg.attn_every - 1)
    return ({"ssm_scan": n_mamba, "flash_attention": G, "decode_attention": 0},
            {"ssm_scan": 0, "flash_attention": 0, "decode_attention": G})


def hybrid_model(cfg, params) -> str:
    per_call, _ = hybrid_counts(cfg)
    n_mamba, G = per_call["ssm_scan"], per_call["flash_attention"]
    check((n_mamba, G) == (45, 9), f"{cfg.name}: {n_mamba} Mamba-2 layers, {G} attention sites")
    return (f"{cfg.name}: {cfg.num_layers} slots ({n_mamba} Mamba-2, {G} shared-attention "
            f"sites), d_model {cfg.d_model}, SSM {cfg.ssm_num_heads} heads P "
            f"{cfg.d_model * cfg.ssm_expand // cfg.ssm_num_heads} N {cfg.ssm_state_dim}, "
            f"attention {cfg.num_heads}/{cfg.num_kv_heads} heads Dh {cfg.head_dim}, LoRA rank "
            f"{cfg.hybrid_lora_rank}, vocab {cfg.vocab_size}, {cfg.param_dtype}")


class Family(NamedTuple):
    """What the recurrent serving phases need of a model family."""
    label: str  # phase names: <label>_prefill, <label>_generate, ...
    spec: dict  # HYBRID or RWKV: the model and the serving run
    scan: str  # the family's scan kernel (the kernels line takes its launches)
    kernels: tuple  # the wrappers whose launches are counted and checked
    counts: Callable  # cfg -> (launches a prefill call, launches a decode step)
    describe: Callable  # (cfg, params) -> the model line; checks the model's size
    randomize: Callable  # (params, cfg, seed): seeded values where init hides faults
    plain: Callable  # () -> context: the plain versions, for both replays
    fault: Callable  # () -> context: the scan with the state not carried across tiles
    tile: int  # the scan's chunk or tile: the planted fault acts at its starts
    f32_tol: float  # the float32 prefill replay's limit
    hold_bf16_fault: bool  # whether bf16 rounding leaves the planted fault in view
    decode_fault: Callable  # () -> context: the decode replay's planted fault
    decode_fault_kernel: str


HYBRID_FAMILY = Family(
    label="hybrid", spec=HYBRID, scan="ssm_scan", kernels=HYBRID_KERNELS, counts=hybrid_counts,
    describe=hybrid_model, randomize=randomize_hybrid, plain=hybrid_plain,
    fault=lambda: scan_ops("fault"), tile=K6_CHUNK, f32_tol=HYBRID_F32_REL_TOL,
    hold_bf16_fault=False, decode_fault=lambda: plain_attention(fault=True),
    decode_fault_kernel="K5")


def phase_recurrent_serving(fam: Family):
    """Prefill and batched greedy generation of a recurrent family (Zamba2-2.7B
    or rwkv6-1.6b) at full size through its kernels, then replayed with the
    plain versions."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    cfg = get_config(fam.spec["arch"])
    per_call, per_step = fam.counts(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg)  # seed 0 on the card
    fam.randomize(params, cfg, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    model = fam.describe(cfg, params)

    # (a) prefill: 4 x 2048 tokens, last-position logits
    prefill = make_prefill_step(cfg)
    B, S = fam.spec["prefill"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    tokens = tokens.cuda()
    prefill(params, {"tokens": tokens[:, :128]})  # warm-up (cuBLAS handles, kernel load)
    calls = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(fam.kernels)
    t0 = time.perf_counter()
    for _ in range(calls):
        logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / calls
    prefill_counts = launch_counts(fam.kernels)
    prefill_peak = torch.cuda.max_memory_allocated()
    want = {k: n * calls for k, n in per_call.items()}
    check(prefill_counts == want, f"prefill launches {prefill_counts}, want {want}")
    check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} not finite of shape ({B}, {cfg.vocab_size})")

    # (b) the prefill replayed: every position's logits with the kernels, with
    # the plain versions and with the planted scan fault; in bf16 (the served
    # model) and with the same weights in float32, where two right runs
    # differ by float32 rounding alone
    def replay(p, c):
        def all_logits():
            return M.forward(p, c, {"tokens": tokens})[0]

        with torch.inference_mode():
            kern = all_logits()
            with fam.plain():
                plain = all_logits()
            with fam.fault():
                fault = all_logits()
        starts = torch.arange(fam.tile, S, fam.tile, device="cuda")
        return {"rel_err_vs_plain": rel_err(kern, plain),
                "last_position_rel_err_vs_plain": rel_err(kern[:, -1], plain[:, -1]),
                "tile_starts_rel_err_vs_plain": rel_err(kern[:, starts], plain[:, starts]),
                "argmax_agree": (kern.argmax(-1) == plain.argmax(-1)).float().mean().item(),
                "planted_fault_rel_err": rel_err(fault, plain),
                "planted_fault_rel_err_last_position": rel_err(fault[:, -1], plain[:, -1]),
                "planted_fault_rel_err_tile_starts": rel_err(fault[:, starts], plain[:, starts])}

    t0 = time.perf_counter()
    check_bf16 = replay(params, cfg)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = _tree(lambda t: t.float(), params)
    check_f32 = replay(params32, cfg32)
    del params32
    torch.cuda.empty_cache()
    emit({"phase": f"{fam.label}_prefill_check", "bfloat16": check_bf16, "float32": check_f32,
          "rel_tol_bf16": SERVE_REL_TOL, "rel_tol_f32": fam.f32_tol,
          "replay_s": time.perf_counter() - t0})
    check(check_bf16["rel_err_vs_plain"] <= SERVE_REL_TOL,
          f"{fam.label} prefill logits differ from the plain replay by {check_bf16}")
    check(check_f32["rel_err_vs_plain"] <= fam.f32_tol,
          f"float32 {fam.label} prefill logits differ from the plain replay by {check_f32}")
    check(not fam.hold_bf16_fault or check_bf16["planted_fault_rel_err"] > SERVE_REL_TOL,
          f"a planted {fam.scan} fault moved the {fam.label} prefill logits by only {check_bf16}")
    check(check_f32["planted_fault_rel_err"] > fam.f32_tol,
          f"a planted {fam.scan} fault moved the float32 {fam.label} prefill logits by only "
          f"{check_f32}")
    emit({"phase": f"{fam.label}_prefill", "model": model, "params": n_params,
          "param_count": cfg.param_count(), "init_s": init_s, "batch": [B, S], "calls": calls,
          "s_per_call": prefill_s, "tokens_per_s": B * S / prefill_s,
          "peak_mem_gb": prefill_peak / 1e9, "launches": prefill_counts,
          "rel_err_vs_plain": check_bf16["rel_err_vs_plain"], "rel_tol": SERVE_REL_TOL,
          "max_abs_logit": logits.float().abs().max().item()})

    # (c) batched greedy generation (prefill by teacher-forced decode)
    serve = ServeConfig(max_batch=fam.spec["max_batch"], cache_len=fam.spec["cache_len"])
    server = BatchServer(cfg, params, serve)
    prompts = serving_prompts(cfg.vocab_size)
    new = fam.spec["new_tokens"]
    server.generate([p[:8] for p in prompts], max_new_tokens=2)  # warm-up
    plen = max(len(p) for p in prompts)
    steps = plen + new - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(fam.kernels)
    t0 = time.perf_counter()
    out = server.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = launch_counts(fam.kernels)
    gen_peak = torch.cuda.max_memory_allocated()
    want = {k: n * steps for k, n in per_step.items()}
    check(gen_counts == want, f"generate launches {gen_counts}, want {want} ({steps} steps)")
    check(len(out) == len(prompts) and all(len(o) == new and all(0 <= t < cfg.vocab_size
                                                                 for t in o) for o in out),
          "generate returned malformed tokens")

    # (d) teacher-forced replay: the kernels and the plain versions in lockstep
    replay = decode_replay(cfg, params, prompts, out, serve.cache_len, plain=fam.plain,
                           fault=fam.decode_fault)
    emit({"phase": f"{fam.label}_generate_check", **{k: replay[k] for k in REPLAY_CHECK_KEYS},
          "rel_tol": SERVE_REL_TOL})
    check_decode_replay(replay, f"{fam.label} ", kernel=fam.decode_fault_kernel)
    emit({"phase": f"{fam.label}_generate", "prompts": [len(p) for p in prompts],
          "max_batch": serve.max_batch, "cache_len": serve.cache_len,
          "cache_dtype": serve.cache_dtype, "new_tokens": new, "decode_steps": steps,
          "wall_s": gen_s, "ms_per_decode_step": gen_s / steps * 1e3,
          "decode_tokens_per_s": len(prompts) * steps / gen_s,
          "generated_tokens_per_s": len(prompts) * new / gen_s, "peak_mem_gb": gen_peak / 1e9,
          "launches": gen_counts, "rel_tol": SERVE_REL_TOL, **replay})
    launches = {fam.scan: prefill_counts[fam.scan] + gen_counts[fam.scan]}
    return cfg, params, tokens, launches


def phase_recurrent_paths(fam: Family) -> dict:
    """The family's reduced model in float32 on the card: the prefill step
    against teacher-forced decode at the last of 200 tokens, with exact
    launch counts on both; the planted scan fault must exceed the limit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_cache, init_params

    cfg = dataclasses.replace(get_config(fam.spec["arch"]).reduced(), param_dtype="float32",
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    fam.randomize(params, cfg, seed=2)
    T = 200
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, T)))
    tokens = tokens.cuda()
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    zero_launch_counts(fam.kernels)
    pre = prefill(params, {"tokens": tokens})
    pre_counts = launch_counts(fam.kernels)
    cache = init_decode_cache(cfg, 4, T, dtype=torch.float32)
    zero_launch_counts(fam.kernels)
    for t in range(T):
        dec, cache = step(params, cache, tokens[:, t], t)
    dec_counts = launch_counts(fam.kernels)
    with fam.fault():
        faulted = prefill(params, {"tokens": tokens})
    res = {"phase": f"{fam.label}_paths", "model": f"{cfg.name} reduced, float32",
           "tokens": [4, T], "rel_err": rel_err(pre, dec),
           "planted_fault_rel_err": rel_err(faulted, dec), "rel_tol": RECURRENT_PATHS_REL_TOL,
           "launches": {"prefill": pre_counts, "decode": dec_counts}}
    emit(res)
    per_call, per_step = fam.counts(cfg)
    want = {"prefill": per_call, "decode": {k: n * T for k, n in per_step.items()}}
    check(res["launches"] == want, f"reduced {fam.label} launches {res['launches']}, want {want}")
    check(res["rel_err"] <= RECURRENT_PATHS_REL_TOL,
          f"{fam.label} prefill and teacher-forced decode differ by {res['rel_err']}")
    check(res["planted_fault_rel_err"] > RECURRENT_PATHS_REL_TOL,
          f"a planted {fam.scan} fault moved the reduced {fam.label} prefill by only "
          f"{res['planted_fault_rel_err']}")
    return res


# ------------------------------------------------------------ rwkv6 (K7)
def rwkv_inputs(gen, shape, dtype, *, decay="sigmoid", with_state=False):
    """K7's operands: r, k, v normal; w = sigmoid(normal) (the reference's
    test draw) or, with ``decay="strong"``, uniform in [0.03, 0.07] (``"weak"``:
    [0.99, 0.999]); u normal; an optional normal state0."""
    import torch

    Bb, T, H, K = shape
    r, k, v = (torch.randn(Bb, T, H, K, generator=gen, device="cuda").to(dtype) for _ in range(3))
    if decay == "strong":
        w = torch.rand(Bb, T, H, K, generator=gen, device="cuda") * 0.04 + 0.03
    elif decay == "weak":
        w = torch.rand(Bb, T, H, K, generator=gen, device="cuda") * 0.009 + 0.99
    else:
        w = torch.sigmoid(torch.randn(Bb, T, H, K, generator=gen, device="cuda"))
    u = torch.randn(H, K, generator=gen, device="cuda")
    s0 = torch.randn(Bb, H, K, K, generator=gen, device="cuda") if with_state else None
    return r, k, v, w.to(dtype), u, s0


def rwkv6_scan_no_carry(r, k, v, w, u, state0=None, *, out_state=None):
    """A planted K7 fault: K7 run tile by tile with the state not carried
    from one 32-step tile to the next."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    T, ys, S = r.shape[1], [], None
    for t0 in range(0, T, K7_TILE):
        c = slice(t0, t0 + K7_TILE)
        y, S = rwkv6_scan(r[:, c], k[:, c], v[:, c], w[:, c], u, state0 if t0 == 0 else None,
                          out_state=out_state if t0 + K7_TILE >= T else None)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def rwkv6_scan_no_bonus(r, k, v, w, u, state0=None, *, out_state=None):
    """A planted K7 fault: the bonus u dropped."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    return rwkv6_scan(r, k, v, w, u.new_zeros(u.shape), state0, out_state=out_state)


def rwkv6_scan_no_state0(r, k, v, w, u, state0=None, *, out_state=None):
    """A planted K7 fault: state0 ignored (every call starts from zeros)."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    return rwkv6_scan(r, k, v, w, u, out_state=out_state)


def k7_verdict(y, S, want_y, want_S, dname: str, truth=None) -> dict:
    """K7's errors against a plain result and whether they meet its
    tolerances.  bf16: the reference's, element by element.  float32: the
    reference's 1e-4 in relative L2, against the plain result and against
    the float64 recurrence ``truth`` where given; element by element it is
    reported: where the state sums many steps (w near 1) |y| reaches ~100
    and two right float32 results differ by ~1e-4 at elements near zero.
    The state: 1e-3 element by element."""
    import torch

    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    tol = K7_TOL[dname]
    yf, wf = y.float(), want_y.float()
    over = (yf - wf).abs() > tol["atol"] + tol["rtol"] * wf.abs()
    res = dict(max_abs_err=_err(y, want_y), rel_l2=rel_err(y, want_y),
               state_max_abs_err=_err(S, want_S), elements_over_tol=int(over.sum()),
               finite=finite)
    ok = finite and bool(torch.allclose(S, want_S.float(), **K7_STATE_TOL))
    if dname == "bfloat16":
        res["ok"] = ok and res["elements_over_tol"] == 0
        return res
    ok = ok and res["rel_l2"] <= tol["rtol"]
    if truth is not None:
        res["rel_l2_vs_f64"] = rel_err(y.double(), truth)
        res["max_abs_err_vs_f64"] = (y.double() - truth).abs().max().item()
        res["plain_max_abs_err_vs_f64"] = (want_y.double() - truth).abs().max().item()
        ok = ok and res["rel_l2_vs_f64"] <= tol["rtol"]
    res["ok"] = ok
    return res


K7_FAULTS = {"no_carry": rwkv6_scan_no_carry, "no_bonus": rwkv6_scan_no_bonus,
             "no_state0": rwkv6_scan_no_state0}


def k7_case(gen, shape, dtype, *, decay="sigmoid", with_state=False, alias=False, faults=(),
            timed=False):
    """K7 against its plain version on one input (float32 also against a
    float64 recurrence); with ``alias``, K7 writes the final state over
    (a copy of) state0, as decode runs it; each named planted fault must
    fail the same check; with ``timed``, K7 timed beside its bound and the
    plain version."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain

    dname = str(dtype).split(".")[-1]
    args = rwkv_inputs(gen, shape, dtype, decay=decay, with_state=with_state)

    def kernel(state):  # the final state into ``state`` (state0's copy) with alias
        if alias:
            return rwkv6_scan(*args[:5], state, out_state=state)
        return rwkv6_scan(*args)

    state = args[5].clone() if alias else None
    y, S = kernel(state)
    want_y, want_S = rwkv6_scan_plain(*args)
    torch.cuda.synchronize()
    truth = None
    if dname == "float32":
        truth = rwkv6_scan_plain(*args, acc_dtype=torch.float64)[0].double()
    res = dict(shape=list(shape), dtype=dname, decay=decay, state0=with_state,
               state0_as_output=alias, **k7_verdict(y, S, want_y, want_S, dname, truth))
    check(res["ok"], f"rwkv6_scan {shape} {dname} decay={decay} state0={with_state} "
                     f"alias={alias}: {res}")
    res["planted_faults"] = {}
    for name in faults:
        fault = k7_verdict(*K7_FAULTS[name](*args), want_y, want_S, dname, truth)
        res["planted_faults"][name] = fault
        check(not fault["ok"], f"rwkv6_scan: the planted fault {name} passed the check: {fault}")
    if not timed:
        return res
    Bb, T, H, K = shape
    esz = torch.empty((), dtype=dtype).element_size()
    # r, k, v, w read and y written once; u read; state0 read (if given) and the state written
    nbytes = 5 * Bb * T * H * K * esz + H * K * 4 + Bb * H * K * K * 4 * (2 if with_state else 1)
    # What the function needs a step and (b, h): the read S^T r (2 K V), the
    # decayed write diag(w) S + k v^T (3 K V), and the bonus, which factors
    # out as v (sum_k r_k u_k k_k): 3 K for the scalar, 2 V to add it in
    flops = Bb * T * H * (5 * K * K + 3 * K + 2 * K)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")  # the arithmetic is float32 in both dtypes
    big = Bb * T > 1000
    res.update(bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
               ms=time_ms(lambda: kernel(state), 10 if big else 200),
               plain_ms=time_ms(lambda: rwkv6_scan_plain(*args), 3 if big else 50, 1),
               device_ms=device_ms(lambda: kernel(state), 5 if big else 50), library_ms=None)
    return res


def phase_rwkv_parity() -> dict:
    """K7 against its plain version on the card: rwkv6-1.6b's prefill shape
    (bf16 and float32) and decode shape (B 8, T 1, the state written over
    state0 as decode does), timed; T off the tile, strong decay, the
    reference's small shapes; three planted faults must fail."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    prefill, decode = (4, 2048, 32, 64), (8, 1, 32, 64)
    main = {str(dt).split(".")[-1]: k7_case(gen, prefill, dt, faults=("no_carry", "no_bonus"),
                                            timed=True) for dt in (bf16, f32)}
    steps = {str(dt).split(".")[-1]: k7_case(gen, decode, dt, with_state=True, alias=True,
                                             faults=("no_state0", "no_bonus"), timed=True)
             for dt in (bf16, f32)}
    cases = []
    for dt in (bf16, f32):
        cases += [k7_case(gen, (2, 1000, 32, 64), dt, with_state=True, faults=("no_carry",)),
                  k7_case(gen, (2, 300, 32, 64), dt, with_state=True, alias=True),
                  k7_case(gen, (2, 300, 32, 64), dt, decay="strong", with_state=True),
                  k7_case(gen, (1, 33, 2, 8), dt, with_state=True),
                  k7_case(gen, (2, 100, 3, 16), dt),
                  k7_case(gen, (1, 64, 4, 32), dt, with_state=True)]
    emit({"phase": "rwkv_parity", "rwkv6_scan": list(main.values()),
          "rwkv6_scan_decode": list(steps.values()), "rwkv6_scan_cases": cases,
          "library": None, "library_note": "no single PyTorch call computes the WKV recurrence"})
    return main["bfloat16"]


def rwkv_scan_ops(mode: str):
    """Rebind the model's WKV scan: "plain" runs the plain version on the
    card, "no_carry" and "no_state0" K7 with that planted fault."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain

    return rebind_ops(rwkv6_scan={"plain": rwkv6_scan_plain, **K7_FAULTS}[mode])


def randomize_rwkv(params, cfg, seed: int) -> None:
    """Fill w0, w_b and u in place with seeded values: at init w0 = -4 for
    every channel and w_b is scaled by 0.01, so the decay is nearly one
    constant, and u = 0.1 N(0, 1) makes a dropped bonus small.  w0 uniform
    in [-6, 1] (decays from 0.9975 down to 0.066), w_b normal * 64**-0.5, u
    N(0, 1)."""
    import torch

    tm = params["layers"]["tm"]
    gen = torch.Generator(device=tm["w0"].device).manual_seed(seed)

    def fill(t, draw):
        t.copy_(draw(t.shape, generator=gen, device=t.device))

    fill(tm["w0"], lambda *a, **kw: torch.rand(*a, **kw) * 7.0 - 6.0)
    fill(tm["w_b"]["w"], lambda *a, **kw: torch.randn(*a, **kw) * 64**-0.5)
    fill(tm["u"], torch.randn)


def rwkv_counts(cfg) -> tuple[dict, dict]:
    """K7 once a layer a prefill call, and once a layer a decode step (T = 1
    from the carried state)."""
    return {"rwkv6_scan": cfg.num_layers}, {"rwkv6_scan": cfg.num_layers}


def rwkv_model(cfg, params) -> str:
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == 1_583_941_632, f"{cfg.name}: {n_params} parameters")
    H, K = cfg.num_heads, cfg.d_model // cfg.num_heads
    return (f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {H} heads of "
            f"K = V = {K}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}")


# The decode replay's planted fault: K7 ignoring state0, from the last
# prompt token on.  The no-carry fault is held in bf16 too (see
# RWKV_F32_REL_TOL).
RWKV_FAMILY = Family(
    label="rwkv", spec=RWKV, scan="rwkv6_scan", kernels=RWKV_KERNELS, counts=rwkv_counts,
    describe=rwkv_model, randomize=randomize_rwkv, plain=lambda: rwkv_scan_ops("plain"),
    fault=lambda: rwkv_scan_ops("no_carry"), tile=K7_TILE, f32_tol=RWKV_F32_REL_TOL,
    hold_bf16_fault=True, decode_fault=lambda: rwkv_scan_ops("no_state0"),
    decode_fault_kernel="K7")


# ------------------------------------------------------ training (K3, K4b)
def _tree(fn, *trees):
    from repro_torch.utils.tree import tree_map

    return tree_map(fn, *trees)


def tree_rel_err(a, b) -> tuple[float, float]:
    """(||a - b|| / ||b|| over the whole tree, the largest such ratio of one
    leaf), in float64 sums of float32 differences."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    num = den = 0.0
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d2 = torch.sum((x.float() - y.float()).double() ** 2).item()
        n2 = torch.sum(y.double() ** 2).item()
        num, den = num + d2, den + n2
        worst = max(worst, (d2 / n2) ** 0.5 if n2 > 0 else (0.0 if d2 == 0 else float("inf")))
    return (num / den) ** 0.5, worst


def k4b_verdict(got, want, dname: str) -> dict:
    """K4b's errors against the plain backward on each of dq, dk, dv, and
    whether all three meet its tolerance."""
    import torch
    from torch.linalg import vector_norm

    out, ok = {}, True
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        max_abs, scale = (a - b).abs().max().item(), b.abs().max().item()
        rel = (vector_norm(a - b) / vector_norm(b)).item() if scale > 0 else None
        if not bool(torch.isfinite(a).all()):
            good = False
        elif dname == "float32":
            good = bool(torch.allclose(a, b, **K4B_F32_TOL))
        elif scale == 0.0:  # no row sees a key: the gradient is exactly 0
            good = max_abs == 0.0
        else:
            good = max_abs <= K4B_BF16_REL * scale and rel <= K4B_BF16_REL
        out[name] = dict(max_abs_err=max_abs, max_abs_plain=scale, rel_l2=rel)
        ok = ok and good
    out["ok"] = ok
    return out


def k4b_case(gen, B, Sq, Skv, H, KVH, Dh, dtype, *, causal=True, window=None, q_offset=0,
             timed=False):
    """K4's log-sum-exp and K4b against their plain versions on one input
    (rows that see no key must get dq exactly 0); with ``timed``, K4b timed
    beside its bound, the plain backward and SDPA's forward + backward, two
    launches compared, and the planted faults (K4b skipping its first 64-key
    tile; the wgmma route leaving one query head of each group out of dK and
    dV) that the check must reject."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dname = str(dtype).split(".")[-1]
    q = torch.randn(B, Sq, H, Dh, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, Skv, KVH, Dh, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, Skv, KVH, Dh, generator=gen, device="cuda", dtype=dtype)
    do = torch.randn(B, Sq, H, Dh, generator=gen, device="cuda", dtype=dtype)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    out, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    torch.testing.assert_close(out, want_out, **K4_TOL[dname])  # K4 at the group of 6
    out_err = _err(out, want_out)
    del want_out
    seen = fa._mask(Sq, Skv, causal, window, q_offset, q.device).any(-1)
    lse_err = (lse - want_lse)[..., seen].abs().max().item() if bool(seen.any()) else 0.0
    check(bool(torch.isfinite(lse).all()) and lse_err <= K4_LSE_ATOL,
          f"flash_attention lse {dname} {[B, Sq, Skv, H, KVH, Dh]}: error {lse_err}")
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    verdict = k4b_verdict(got, want, dname)
    shape = [B, Sq, Skv, H, KVH, Dh]
    check(verdict["ok"], f"flash_attention_bwd {dname} {shape} {kw}: {verdict}")
    check(bool((got[0][:, ~seen] == 0).all()),
          f"flash_attention_bwd {dname} {shape} {kw}: a row with no key got dq != 0")
    route = fa.backward_route(dtype, Dh, H // KVH)
    res = dict(shape=shape, dtype=dname, route=route, causal=causal, window=window,
               q_offset=q_offset,
               fwd_max_abs_err=out_err, lse_max_abs_err=lse_err,
               rows_without_key=int((~seen).sum()),
               max_abs_err=max(verdict[n]["max_abs_err"] for n in ("dq", "dk", "dv")),
               errors=verdict)
    if not timed:
        return res
    fa._BWD_SKIP_KEY_TILES = 1
    try:
        planted = k4b_verdict(fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), want, dname)
    finally:
        fa._BWD_SKIP_KEY_TILES = 0
    check(not planted["ok"], f"flash_attention_bwd: a skipped key tile passed the check: {planted}")
    if route == "wgmma_tma":
        fa._BWD_DROP_GROUP_RANK = 3 % (H // KVH)
        try:
            res["planted_fault_group_rank"] = k4b_verdict(
                fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), want, dname)
        finally:
            fa._BWD_DROP_GROUP_RANK = -1
        check(not res["planted_fault_group_rank"]["ok"],
              f"flash_attention_bwd: a query head left out of the group sum passed the check: "
              f"{res['planted_fault_group_rank']}")
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        res["second_launch"] = dict(
            dk_dv_bit_identical=bool(torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])),
            dq_bit_identical=bool(torch.equal(again[0], got[0])),
            dq_rel_l2_between_launches=rel_err(again[0], got[0]))
        check(res["second_launch"]["dk_dv_bit_identical"]
              and res["second_launch"]["dq_rel_l2_between_launches"] <= K4B_BF16_REL,
              f"flash_attention_bwd: two launches disagree: {res['second_launch']}")
        del again
    del got, want
    pairs = attention_pairs(Sq, Skv, causal, window, q_offset)
    esz = q.element_size()
    b_ms, b_by = bound_ms((4 * q.numel() + 4 * k.numel()) * esz + 4 * lse.numel(),
                          10 * B * H * Dh * pairs, dname)
    check(causal and window is None and Sq == Skv and q_offset == 0,
          "the SDPA yardstick is timed at causal, unwindowed shapes only")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    def k4b():
        return fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)

    def plain():
        return fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)

    big = dtype == torch.float32
    res.update(planted_fault=planted, bound_ms=b_ms, bound_by=b_by, pairs=pairs,
               ms=time_ms(k4b, 5 if big else 20), plain_ms=time_ms(plain, 3, 1),
               library_ms=time_ms(sdpa_fwd_bwd, 20), device_ms=device_ms(k4b, 5),
               fwd_ms=time_ms(lambda: fa.flash_attention(q, k, v, with_lse=True, **kw),
                              5 if big else 20))
    res["bound_share"] = b_ms / res["ms"]
    return res


def phase_train_parity() -> dict:
    """K3, K4's log-sum-exp and K4b against their plain versions at the
    training path's shapes."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.prox_update import prox_update, prox_update_plain
    from repro_torch.models import init_params
    from repro_torch.utils.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = get_config(TRAIN["arch"])
    shapes = init_params(cfg, torch.Generator(), device="meta")
    bf16 = torch.bfloat16

    def rand_tree(dtype):
        return _tree(lambda m: torch.randn(m.shape, generator=gen, device="cuda", dtype=dtype),
                     shapes)

    # K3 over the whole bf16 tree, one launch
    y, g, z = rand_tree(bf16), rand_tree(bf16), rand_tree(bf16)
    n = sum(t.numel() for t in tree_leaves(y))
    prox_update.launches = 0
    got = ops.prox_update_tree(y, g, z, TRAIN["local_lr"], 1.0 / TRAIN["eta"])
    torch.cuda.synchronize()
    check(prox_update.launches == 1, f"K3 took {prox_update.launches} launches for one dtype group")
    errs = []
    for a, b, c, o in zip(tree_leaves(y), tree_leaves(g), tree_leaves(z), tree_leaves(got)):
        want = prox_update_plain(a, b, c, TRAIN["local_lr"], 1.0 / TRAIN["eta"])
        torch.testing.assert_close(o, want, **K3_TOL["bfloat16"])
        errs.append((o.float() - want.float()).abs().max().item())
    del got, want

    def k3():
        return ops.prox_update_tree(y, g, z, TRAIN["local_lr"], 1.0 / TRAIN["eta"])

    def k3_plain():
        return _tree(lambda a, b, c: prox_update_plain(a, b, c, TRAIN["local_lr"],
                                                       1.0 / TRAIN["eta"]), y, g, z)

    b_ms, b_by = bound_ms(4 * n * 2, 5 * n, "float32")  # bf16 loads, float32 arithmetic
    k3_res = dict(shape=[n], leaves=len(tree_leaves(y)), dtype="bfloat16", max_abs_err=max(errs),
                  tol=K3_TOL["bfloat16"], ms=time_ms(k3, 10), plain_ms=time_ms(k3_plain, 3, 1),
                  device_ms=device_ms(k3, 5), bound_ms=b_ms, bound_by=b_by, library_ms=None)
    k3_res["hbm_share"] = b_ms / k3_res["ms"]
    del y, g, z
    small = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        leaves = [(3, 37), (129,), (1,), (70001,), (4, 5, 6)]
        ys, gs, zs = ([torch.randn(s_, generator=gen, device="cuda", dtype=dtype) for s_ in leaves]
                      for _ in range(3))
        outs = prox_update(ys, gs, zs, 0.05, 2.0)
        err = 0.0
        for o, a, b, c in zip(outs, ys, gs, zs):
            want = prox_update_plain(a, b, c, 0.05, 2.0)
            torch.testing.assert_close(o, want, **K3_TOL[dname])
            err = max(err, (o - want).abs().max().item())
        small[dname] = dict(leaves=leaves, max_abs_err=err, tol=K3_TOL[dname])

    # K4's log-sum-exp and K4b: the training shape, then the mask and head-dim cases
    f32 = torch.float32
    main = {str(dt).split(".")[-1]: k4b_case(gen, 2, 1024, 1024, 12, 2, 128, dt, timed=True)
            for dt in (bf16, f32)}
    cases = []
    for dt in (bf16, f32):
        cases += [k4b_case(gen, 2, 1000, 1000, 12, 2, 128, dt, window=256),
                  k4b_case(gen, 1, 256, 1024, 12, 2, 128, dt, q_offset=768),
                  k4b_case(gen, 1, 100, 100, 12, 2, 64, dt, window=16, q_offset=100),
                  k4b_case(gen, 2, 513, 513, 12, 2, 80, dt),
                  k4b_case(gen, 2, 300, 300, 12, 2, 64, dt, causal=False),
                  k4b_case(gen, 2, 512, 512, 8, 8, 128, dt),
                  k4b_case(gen, 1, 300, 428, 6, 6, 64, dt, window=100, q_offset=128)]
    emit({"phase": "train_parity", "prox_update": k3_res, "prox_update_small": small,
          "flash_attention_bwd": list(main.values()), "flash_attention_bwd_cases": cases,
          "library": "K4b: scaled_dot_product_attention(is_causal, enable_gqa) forward + "
                     "autograd backward, timed only as a yardstick; K3: none"})
    return {"prox_update": k3_res, "flash_attention_bwd": main["bfloat16"]}


class PlainAttention:
    """The model's attention with a gradient through the plain versions on
    the card (forward with its log-sum-exp, the plain backward)."""

    fn = None

    @classmethod
    def apply(cls, q, k, v, *, causal=True, sliding_window=None, q_offset=0):
        import torch

        from repro_torch.kernels import flash_attention as fa

        if cls.fn is None:
            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, q, k, v, causal, window, q_offset):
                    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                        sliding_window=window,
                                                        q_offset=q_offset, with_lse=True)
                    ctx.save_for_backward(q, k, v, out, lse)
                    ctx.mask = dict(causal=causal, sliding_window=window, q_offset=q_offset)
                    return out

                @staticmethod
                def backward(ctx, do):
                    return (*fa.flash_attention_bwd_plain(*ctx.saved_tensors, do, **ctx.mask),
                            None, None, None)

            cls.fn = Fn
        return cls.fn.apply(q, k, v, causal, sliding_window, q_offset)


@contextlib.contextmanager
def train_ops(mode: str):
    """Rebind the training path's ops: "plain" runs the plain K3 and the plain
    attention forward and backward on the card; "k4b_fault" K4b skipping its
    first 64-key tile; "k3_fault" K3 with inv_eta 0 (the prox term dropped)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.prox_update import prox_update_plain

    saved = ops.attention, ops.prox_update_tree
    real_tree = ops.prox_update_tree
    if mode == "plain":
        ops.attention = PlainAttention.apply
        ops.prox_update_tree = lambda y, g, z, lr, ie: _tree(
            lambda a, b, c: prox_update_plain(a, b, c, lr, ie), y, g, z)
    elif mode == "k4b_fault":
        fa._BWD_SKIP_KEY_TILES = 1
    elif mode == "k3_fault":
        ops.prox_update_tree = lambda y, g, z, lr, ie: real_tree(y, g, z, lr, 0.0)
    try:
        yield
    finally:
        ops.attention, ops.prox_update_tree = saved
        fa._BWD_SKIP_KEY_TILES = 0


def train_batch(cfg) -> dict:
    """The training phase's tokens on the card: C cohorts of b x S from
    `SyntheticLMDataset` (seed 0), cohort-major."""
    import torch

    from repro_torch.data import ShardedBatcher, SyntheticLMDataset

    C = TRAIN["cohorts"]
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, num_clients=C, alpha=0.5, seed=0)
    batch = ShardedBatcher(ds, num_cohorts=C, per_cohort_batch=TRAIN["per_cohort_batch"],
                           seq_len=TRAIN["seq_len"]).next_batch()
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def train_svrp():
    from repro_torch.core.deep import DeepSVRPConfig

    return DeepSVRPConfig(eta=TRAIN["eta"], local_lr=TRAIN["local_lr"],
                          local_steps=TRAIN["local_steps"], anchor_prob=0.0625)


def phase_train():
    """DeepSVRP training of Qwen2-1.5B at full size on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_svrp_train_step
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(TRAIN["arch"])
    C, b, S, K = TRAIN["cohorts"], TRAIN["per_cohort_batch"], TRAIN["seq_len"], TRAIN["local_steps"]
    t0 = time.perf_counter()
    batch = train_batch(cfg)
    data_s = time.perf_counter() - t0
    step, helpers = make_svrp_train_step(cfg, train_svrp(), cohorts=C)
    t0 = time.perf_counter()
    state = helpers["init_state"]()  # seed 0 on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    check(cfg.num_layers == 28 and cfg.d_model == 1536 and abs(n_params - 1.777e9) < 1e7,
          f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, {n_params} parameters")
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(TRAIN_KERNELS)
    ms, losses = [], []
    for coin in TRAIN["coins"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, refresh=coin)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts(TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    passes = sum(C * (1 + K) + C * int(coin) for coin in TRAIN["coins"])
    want = {"prox_update": C * K * len(TRAIN["coins"]), "flash_attention": L * passes,
            "flash_attention_bwd": L * passes}
    check(launches == want, f"train launches {launches}, want {want} "
                            f"(K3: C K a round; K4, K4b: {L} a pass, C (1 + K) + C refresh passes)")
    check(all(np.isfinite(losses)), f"train losses {losses} not finite")
    tokens = C * b * S
    steady = float(np.mean(ms[1:]))
    model = (f"{cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads}"
             f" heads, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
             f"{cfg.param_dtype}")
    emit({"phase": "train", "model": model, "params": n_params, "init_s": init_s,
          "data_s": data_s, "batch": list(batch["tokens"].shape), "cohorts": C,
          "local_steps": K, "eta": TRAIN["eta"], "local_lr": TRAIN["local_lr"],
          "coins": list(TRAIN["coins"]), "losses": losses, "ms_per_round": ms,
          "ms_per_round_after_first": steady, "tokens_per_round": tokens,
          "trained_tokens_per_s": tokens / steady * 1e3, "passes": passes,
          "peak_mem_gb": peak / 1e9, "launches": launches, "launches_expected": want})
    del state
    return cfg, step, helpers, batch, launches


def phase_train_profile(step, helpers, batch, label: str = "train_profile") -> None:
    """Where a training round's time goes: one plain round (no refresh)
    under torch.profiler, after one unprofiled."""
    state = helpers["init_state"]()

    def one_round():
        step(state, batch, refresh=False)

    wall_ms, kernels = profiled(one_round, 1)
    del state
    busy_ms = sum(t for t, _ in kernels.values()) / 1e3 if kernels else None
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": label, "run": "one plain round, C = 2, K = 4", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
          "kernel_launches": sum(c for _, c in kernels.values()),
          "top_kernels": [{"name": name[:80], "device_ms": t / 1e3, "count": c}
                          for name, (t, c) in top]})


def tree_dist(a, b) -> float:
    """||a - b||_2 over a whole tree, float64 sums of float32 differences."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    return sum(torch.sum((x.float() - y.float()).double() ** 2).item()
               for x, y in zip(tree_leaves(a), tree_leaves(b))) ** 0.5


def phase_train_replay(cfg, step, helpers, batch) -> dict:
    """Round 1 again from the same state, with the kernels (twice), with the
    plain K3 and plain attention on the card, and with each planted fault.

    Two quantities are compared with the kernels' run, each at a point both
    runs share: the cohort-mean gradient at x0 (the round's first pass:
    K4 and K4b in all 28 layers) with the loss there, and the round's update
    x' - x0 (K3's four steps a cohort, on gradients through K4 and K4b)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.utils.tree import value_and_grad

    C = TRAIN["cohorts"]
    b = batch["tokens"].shape[0] // C
    shards = [{k: v[c * b:(c + 1) * b].long() for k, v in batch.items()} for c in range(C)]

    def loss(params, shard):
        return M.loss_fn(params, cfg, shard)

    results, kept = {}, {}
    for mode in ("kernels", "kernels_again", "plain", "k4b_fault", "k3_fault"):
        state = helpers["init_state"]()
        x0 = state.params
        g0, loss0 = None, 0.0
        with train_ops(mode):
            for shard in shards:
                l, g = value_and_grad(loss, x0, shard)
                loss0 += l.item() / C
                g0 = _tree(lambda t: t.float() / C, g) if g0 is None else \
                    _tree(lambda a, t: a.add_(t.float() / C), g0, g)
                del g
            new, _ = step(state, batch, refresh=False)  # x' is round 1's; no refresh pass
            with torch.no_grad():
                loss1 = sum(loss(new.params, shard).item() for shard in shards) / C
        torch.cuda.synchronize()
        entry = {"loss_at_x0": loss0, "loss_at_x1": loss1,
                 "x_entries_changed": sum(int((a != b_).sum()) for a, b_ in
                                          zip(_leaves(new.params), _leaves(x0)))}
        if mode == "kernels":
            kept = {"grad": g0, "x": new.params}
            entry["update_norm"] = tree_dist(new.params, x0)
            entry["grad_norm"] = tree_dist(g0, _tree(torch.zeros_like, g0))
        else:
            entry["grad_rel_l2"], entry["grad_worst_leaf_rel_l2"] = tree_rel_err(g0, kept["grad"])
            entry["update_rel_l2"] = tree_dist(new.params, kept["x"]) / \
                results["kernels"]["update_norm"]
            entry["loss_rel_err"] = abs(loss0 - results["kernels"]["loss_at_x0"]) / \
                abs(results["kernels"]["loss_at_x0"])
        results[mode] = entry
        del state, new, x0, g0
        torch.cuda.empty_cache()
    del kept
    emit({"phase": "train_replay", "round": 1, "grad_rel_tol": TRAIN_GRAD_REL_TOL,
          "update_rel_tol": TRAIN_UPDATE_REL_TOL, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
          "note": "each run against the kernels' run", **results})
    plain = results["plain"]
    check(plain["grad_rel_l2"] <= TRAIN_GRAD_REL_TOL and plain["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
          and plain["update_rel_l2"] <= TRAIN_UPDATE_REL_TOL,
          f"train replay: the plain run differs from the kernels' by {plain}")
    check(results["k4b_fault"]["grad_rel_l2"] > TRAIN_GRAD_REL_TOL,
          f"train replay: a K4b skipping its first key tile moved the gradient by only "
          f"{results['k4b_fault']['grad_rel_l2']}")
    check(results["k3_fault"]["update_rel_l2"] > TRAIN_UPDATE_REL_TOL,
          f"train replay: a K3 with inv_eta 0 moved the update by only "
          f"{results['k3_fault']['update_rel_l2']}")
    return results


def phase_train_reduced() -> dict:
    """The reduced qwen2 in float32 through K3, K4 and K4b in float32: the
    reference test's "it trains" property (tests/test_launch.py:71-91)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.deep import DeepSVRPConfig, draw_refresh
    from repro_torch.launch import make_svrp_train_step

    cfg = dataclasses.replace(get_config(TRAIN["arch"]).reduced(), param_dtype="float32",
                              compute_dtype="float32")
    C, K, rounds = 4, 3, 10
    svrp = DeepSVRPConfig(eta=0.5, local_lr=0.2, local_steps=K, anchor_prob=0.5)
    step, helpers = make_svrp_train_step(cfg, svrp, cohorts=C)
    state = helpers["init_state"](torch.Generator(device="cuda").manual_seed(0))
    coins = [draw_refresh(state.rng, svrp.anchor_prob) for _ in range(rounds)]
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (8, 32))).cuda()
    batch = {"tokens": toks, "labels": toks}
    zero_launch_counts(TRAIN_KERNELS)
    losses = []
    t0 = time.perf_counter()
    for coin in coins:
        state, metrics = step(state, batch, refresh=coin)
        losses.append(metrics["loss"].item())
    wall_s = time.perf_counter() - t0
    launches = launch_counts(TRAIN_KERNELS)
    passes = sum(C * (1 + K) + C * int(c) for c in coins)
    want = {"prox_update": C * K * rounds, "flash_attention": cfg.num_layers * passes,
            "flash_attention_bwd": cfg.num_layers * passes}
    emit({"phase": "train_reduced", "model": f"{cfg.name} reduced: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, float32",
          "cohorts": C, "rounds": rounds, "coins": coins, "losses": losses,
          "ratio_last_first": losses[-1] / losses[0], "wall_s": wall_s, "launches": launches})
    check(launches == want, f"train_reduced launches {launches}, want {want}")
    check(losses[-1] < 0.7 * losses[0], f"train_reduced does not train: {losses}")
    return launches


# ------------------------------------------------ optim (AdamW: K4, K4b)
def adamw_no_bias_correction(grads, state, params, **kw):
    """A planted optimizer fault: AdamW without its bias correction (the
    real update at a step where 1 - b**t rounds to 1 in float32)."""
    from repro_torch.optim import adamw_update

    params, opt = adamw_update(grads, state._replace(step=10**6), params, **kw)
    return params, opt._replace(step=state.step + 1)


def _bits(t):
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    """Two states (NamedTuples, dicts, tensors, ints, generators) equal bit
    for bit, tensors on the same device in the same dtype."""
    import torch

    if hasattr(a, "_fields"):
        return type(a) is type(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.device == b.device and a.shape == b.shape
                and torch.equal(_bits(a), _bits(b)))
    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    return a == b


def state_bytes(node) -> int:
    """Bytes of every tensor of a train state (NamedTuples and dicts)."""
    import torch

    if hasattr(node, "_fields"):
        node = node._asdict()
    if isinstance(node, dict):
        return sum(state_bytes(v) for v in node.values())
    return node.numel() * node.element_size() if isinstance(node, torch.Tensor) else 0


def checkpoint_roundtrip(label: str, state, step: int):
    """``state`` (a train state) saved with `save_checkpoint` into a fresh
    temporary directory, restored onto the card with `restore_checkpoint`
    and compared bit for bit; the files are deleted.  Returns the restored
    state."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        need = state_bytes(state)
        check(free > 1.1 * need, f"{label} checkpoint: {free / 1e9:.1f} GB free in {d}, "
                                 f"the state takes {need / 1e9:.1f} GB")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(d, step, state._asdict())
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = restore_checkpoint(d, step, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = same_bits(restored, state)
    emit({"phase": f"{label}_checkpoint", "tmpdir": d, "tmp_free_gb": free / 1e9,
          "state_gb": need / 1e9, "file_gb": nbytes / 1e9, "save_s": save_s,
          "restore_s": restore_s, "save_gb_per_s": nbytes / 1e9 / save_s,
          "restore_gb_per_s": nbytes / 1e9 / restore_s, "bit_for_bit": same,
          "files_left": os.path.exists(d)})
    check(same, f"{label} checkpoint: the restored state differs from the saved one")
    return restored


def phase_optim() -> dict:
    """The AdamW baseline on Qwen2-1.5B at full size through K4 and K4b, and
    its state's checkpoint round trip."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_adamw_train_step

    cfg = get_config(TRAIN["arch"])
    L = cfg.num_layers
    batch = train_batch(cfg)
    step, helpers = make_adamw_train_step(cfg, lr=OPTIM["lr"], clip=OPTIM["clip"])
    t0 = time.perf_counter()
    state = helpers["init_state"]()  # seed 0 on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(ADAMW_KERNELS)
    ms, losses, norms = [], [], []
    for _ in range(OPTIM["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts(ADAMW_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    want = {k: L * OPTIM["steps"] for k in ADAMW_KERNELS}
    steady = float(np.mean(ms[1:]))
    B, S = batch["tokens"].shape
    emit({"phase": "adamw", "model": f"{cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.param_dtype} params, float32 moments", "batch": [B, S], **OPTIM,
          "init_s": init_s, "losses": losses, "grad_norms": norms, "ms_per_step": ms,
          "ms_per_step_after_first": steady, "trained_tokens_per_s": B * S / steady * 1e3,
          "state_gb": state_bytes(state) / 1e9, "peak_mem_gb": peak / 1e9,
          "launches": launches, "launches_expected": want})
    check(launches == want, f"adamw launches {launches}, want {want} (one a layer a pass)")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"adamw losses {losses} or grad norms {norms} not finite")
    check(losses[-1] < losses[0], f"adamw: the loss does not fall over 3 steps: {losses}")
    checkpoint_roundtrip("adamw", state, OPTIM["steps"])
    del state
    torch.cuda.empty_cache()
    phase_adamw_replay(cfg, batch)
    torch.cuda.empty_cache()
    phase_optim_reduced()
    phase_svrp_checkpoint(cfg, batch)
    return launches


def phase_adamw_replay(cfg, batch) -> dict:
    """AdamW step 1 again from the seed-0 state: with the kernels, with the
    plain attention forward and backward on the card, and with K4b skipping
    its first key tile; the loss, the gradient norm and the float32 first
    moment against the kernels' run."""
    import torch

    from repro_torch.launch import make_adamw_train_step

    step, helpers = make_adamw_train_step(cfg, lr=OPTIM["lr"], clip=OPTIM["clip"])
    results, kept = {}, None
    for mode in ("kernels", "plain", "k4b_fault"):
        state = helpers["init_state"]()
        with train_ops(mode):
            state, metrics = step(state, batch)
        mu = state.opt.mu
        del state
        entry = {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item()}
        if kept is None:
            kept = mu
        else:
            ref = results["kernels"]
            entry["loss_rel_err"] = abs(entry["loss"] - ref["loss"]) / abs(ref["loss"])
            entry["grad_norm_rel_err"] = abs(entry["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            entry["mu_rel_l2"], entry["mu_worst_leaf_rel_l2"] = tree_rel_err(mu, kept)
        results[mode] = entry
        del mu
        torch.cuda.empty_cache()
    del kept
    emit({"phase": "adamw_replay", "step": 1, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
          "grad_rel_tol": TRAIN_GRAD_REL_TOL, "note": "each run against the kernels' run",
          **results})
    plain, fault = results["plain"], results["k4b_fault"]
    check(plain["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
          and plain["grad_norm_rel_err"] <= TRAIN_GRAD_REL_TOL
          and plain["mu_rel_l2"] <= TRAIN_GRAD_REL_TOL,
          f"adamw replay: the plain run differs from the kernels' by {plain}")
    check(fault["mu_rel_l2"] > TRAIN_GRAD_REL_TOL,
          f"adamw replay: a K4b skipping its first key tile moved mu by only {fault['mu_rel_l2']}")
    return results


def phase_optim_reduced() -> dict:
    """The reduced qwen2 in float32: 3 AdamW steps through K4 and K4b on the
    card against the same 3 steps on the CPU (plain versions), and on the
    card with the planted fault (no bias correction)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import AdamWTrainState, make_adamw_train_step
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config(TRAIN["arch"]).reduced(), param_dtype="float32",
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (OPTIM["steps"], 4, 32))

    def run(device, fault=False):
        step, _ = make_adamw_train_step(cfg, lr=OPTIM["lr"], clip=OPTIM["clip"], device=device)
        p = _tree(lambda t: t.to(device, copy=True), params)
        state, losses = AdamWTrainState(p, adamw_init(p)), []
        with rebind(steps_mod, adamw_update=adamw_no_bias_correction) if fault \
                else contextlib.nullcontext():
            for t in toks:
                state, metrics = step(state, {"tokens": t, "labels": t})
                losses.append(metrics["loss"].item())
        return _tree(lambda t: t.cpu(), state.params), losses

    zero_launch_counts(ADAMW_KERNELS)
    card, card_losses = run("cuda")
    launches = launch_counts(ADAMW_KERNELS)
    cpu, cpu_losses = run("cpu")
    faulted, _ = run("cuda", fault=True)
    rel, worst = tree_rel_err(card, cpu)
    res = {"phase": "adamw_reduced", "model": f"{cfg.name} reduced, float32",
           "steps": OPTIM["steps"], "losses_card": card_losses, "losses_cpu": cpu_losses,
           "params_rel_l2_vs_cpu": rel, "worst_leaf_rel_l2": worst,
           "planted_fault_rel_l2": tree_rel_err(faulted, cpu)[0],
           "rel_tol": OPTIM_REDUCED_REL_TOL, "launches": launches}
    emit(res)
    want = {k: cfg.num_layers * OPTIM["steps"] for k in ADAMW_KERNELS}
    check(launches == want, f"adamw_reduced launches {launches}, want {want}")
    check(rel <= OPTIM_REDUCED_REL_TOL, f"adamw_reduced: card and CPU differ by {rel}")
    check(res["planted_fault_rel_l2"] > OPTIM_REDUCED_REL_TOL,
          f"adamw_reduced: AdamW without bias correction moved the parameters by only "
          f"{res['planted_fault_rel_l2']}")
    return res


def phase_svrp_checkpoint(cfg, batch) -> dict:
    """The DeepSVRP state of Qwen2-1.5B after two rounds (coins 1, 0) saved
    and restored bit for bit; then one round (coin 0) from each."""
    import torch

    from repro_torch.launch import make_svrp_train_step

    step, helpers = make_svrp_train_step(cfg, train_svrp(), cohorts=TRAIN["cohorts"])
    state = helpers["init_state"]()
    for coin in (True, False):
        state, _ = step(state, batch, refresh=coin)
    restored = checkpoint_roundtrip("svrp", state, state.step)
    live, live_m = step(state, batch, refresh=False)
    del state
    again, again_m = step(restored, batch, refresh=False)
    del restored
    rel, worst = tree_rel_err(again.params, live.params)
    res = {"phase": "svrp_resume", "round": 3, "coin": 0,
           "loss_live": live_m["loss"].item(), "loss_restored": again_m["loss"].item(),
           "x_rel_l2": rel, "x_worst_leaf_rel_l2": worst, "rel_tol": CKPT_ROUND_REL_TOL,
           "w_and_gbar_bit_for_bit": same_bits(again.anchor, live.anchor)
           and same_bits(again.anchor_grad, live.anchor_grad)}
    del live, again
    torch.cuda.empty_cache()
    emit(res)
    check(res["loss_live"] == res["loss_restored"],
          f"svrp resume: the loss at w differs: {res['loss_live']} != {res['loss_restored']}")
    check(res["w_and_gbar_bit_for_bit"], "svrp resume: w or gbar differ after a plain round")
    check(rel <= CKPT_ROUND_REL_TOL, f"svrp resume: x' differs by {rel} > {CKPT_ROUND_REL_TOL}")
    return res


# ---------------------------------------------------- int8 serving (quant)
def max_rel_gap(a, b) -> float:
    """max |a - b| / max |b| in float32 (the reference's int8 metric)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def dequant_fault():
    """A planted dequantisation fault: every column of an int8 weight scaled
    by its matrix's first column's scale."""
    from repro_torch.models import layers

    return rebind(layers, dequantize_weight=lambda w, dtype: w["q"].to(dtype)
                  * w["s"][..., :1].to(dtype))


def phase_quant_llama() -> dict:
    """Llama-3.2-3B at full size: bf16 and int8 prefill (K4) and generate
    (K5), the int8 tree's bytes, logits and peak memory against bf16's, the
    int8 prefill replayed with the plain attention, the planted
    dequantisation fault."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.utils.tree import tree_bytes

    cfg = get_config("llama3.2-3b")
    L = cfg.num_layers
    params = init_params(cfg)  # seed 0 on the card
    bf16_bytes = tree_bytes(params)
    prefill = make_prefill_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 2048)))
    tokens = tokens.cuda()
    bf16_last = prefill(params, {"tokens": tokens})
    prompts = serving_prompts(cfg.vocab_size)
    new = 64
    steps = max(len(p) for p in prompts) + new - 1
    serve = ServeConfig(max_batch=8, cache_len=1024)

    def generate(server):
        """(tokens, seconds, peak bytes, resident bytes at the start, launches)"""
        server.generate([p[:8] for p in prompts], max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        zero_launch_counts(SERVE_KERNELS)
        t0 = time.perf_counter()
        out = server.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), resident, \
            launch_counts(SERVE_KERNELS)

    out_bf16, bf16_s, bf16_peak, bf16_resident, _ = generate(BatchServer(cfg, params, serve))
    server = BatchServer(cfg, params, dataclasses.replace(serve, quantize=True))
    del params  # from here only the int8 tree is on the card
    torch.cuda.empty_cache()
    qparams = server.params
    int8_bytes = tree_bytes(qparams)

    prefill(qparams, {"tokens": tokens[:, :128]})  # warm-up
    calls = 3
    torch.cuda.synchronize()
    zero_launch_counts(SERVE_KERNELS)
    t0 = time.perf_counter()
    for _ in range(calls):
        int8_last = prefill(qparams, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / calls
    prefill_counts = launch_counts(SERVE_KERNELS)
    gap = max_rel_gap(int8_last, bf16_last)
    with dequant_fault():
        fault_gap = max_rel_gap(prefill(qparams, {"tokens": tokens}), bf16_last)
    with plain_attention():
        prefill_rel = rel_err(int8_last, prefill(qparams, {"tokens": tokens}))

    out, int8_s, int8_peak, int8_resident, gen_counts = generate(server)
    agree = float(np.mean([a == b for o, ob in zip(out, out_bf16) for a, b in zip(o, ob)]))
    res = {"phase": "quant_llama", "model": f"{cfg.name}: {L} layers, int8 weights",
           "bf16_tree_gb": bf16_bytes / 1e9, "int8_tree_gb": int8_bytes / 1e9,
           "bytes_ratio": int8_bytes / bf16_bytes, "prefill_batch": list(tokens.shape),
           "prefill_s_per_call": prefill_s, "prefill_tokens_per_s": tokens.numel() / prefill_s,
           "prefill_launches": prefill_counts, "logit_gap_vs_bf16": gap,
           "planted_dequant_fault_gap": fault_gap, "logit_gap_tol": QUANT_LOGIT_GAP,
           "prefill_rel_err_vs_plain": prefill_rel, "rel_tol": SERVE_REL_TOL,
           "decode_steps": steps, "ms_per_decode_step_int8": int8_s / steps * 1e3,
           "ms_per_decode_step_bf16": bf16_s / steps * 1e3,
           "decode_ratio_int8_over_bf16": int8_s / bf16_s, "generate_launches": gen_counts,
           "peak_mem_gb_int8": int8_peak / 1e9, "peak_mem_gb_bf16": bf16_peak / 1e9,
           "resident_gb_int8": int8_resident / 1e9, "resident_gb_bf16": bf16_resident / 1e9,
           "greedy_tokens_agree_with_bf16": agree}
    emit(res)
    del server, qparams
    torch.cuda.empty_cache()
    check(res["bytes_ratio"] <= QUANT_BYTES_RATIO,
          f"int8 tree {int8_bytes} bytes > {QUANT_BYTES_RATIO} x bf16's {bf16_bytes}")
    check(prefill_counts == {"flash_attention": L * calls, "decode_attention": 0},
          f"int8 prefill launches {prefill_counts}, want K4 {L * calls}")
    check(gen_counts == {"flash_attention": 0, "decode_attention": L * steps},
          f"int8 generate launches {gen_counts}, want K5 {L} x {steps} steps")
    check(gap <= QUANT_LOGIT_GAP, f"int8 prefill logits {gap} from bf16's > {QUANT_LOGIT_GAP}")
    check(fault_gap > QUANT_LOGIT_GAP, f"a planted dequantisation fault moved the logits by "
                                       f"only {fault_gap}")
    check(prefill_rel <= SERVE_REL_TOL, f"int8 prefill differs from its plain replay by "
                                        f"{prefill_rel}")
    check(int8_peak < bf16_peak, f"int8 generate peak {int8_peak} not below bf16's {bf16_peak}")
    return res


def phase_quant_recurrent(fam: Family) -> dict:
    """A recurrent family at full size in int8 (`BatchServer(quantize=True)`):
    prefill 4 x 2048 with exact launch counts, every position replayed with
    the plain versions, the last position against the bf16 model's, and a
    short generate."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_bytes

    cfg = get_config(fam.spec["arch"])
    per_call, per_step = fam.counts(cfg)
    params = init_params(cfg)  # seed 0 on the card
    fam.randomize(params, cfg, seed=1)
    bf16_bytes = tree_bytes(params)
    B, S = fam.spec["prefill"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    tokens = tokens.cuda()
    prefill = make_prefill_step(cfg)
    bf16_last = prefill(params, {"tokens": tokens})
    n, plen, new = QUANT_SHORT["prompts"], QUANT_SHORT["prompt_len"], QUANT_SHORT["new_tokens"]
    server = BatchServer(cfg, params, ServeConfig(max_batch=n, cache_len=fam.spec["cache_len"],
                                                  quantize=True))
    del params
    torch.cuda.empty_cache()
    qparams = server.params
    prefill(qparams, {"tokens": tokens[:, :128]})  # warm-up
    calls = 3
    zero_launch_counts(fam.kernels)
    for _ in range(calls):
        int8_last = prefill(qparams, {"tokens": tokens})
    prefill_counts = launch_counts(fam.kernels)
    with torch.inference_mode():
        kern = M.forward(qparams, cfg, {"tokens": tokens})[0]
        with fam.plain():
            plain_rel = rel_err(kern, M.forward(qparams, cfg, {"tokens": tokens})[0])
    del kern
    prompts = [p[:plen] for p in serving_prompts(cfg.vocab_size)[:n]]
    zero_launch_counts(fam.kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.generate(prompts, max_new_tokens=new)
    gen_s = time.perf_counter() - t0
    gen_counts = launch_counts(fam.kernels)
    steps = plen + new - 1
    res = {"phase": f"quant_{fam.label}", "model": f"{cfg.name}, int8 weights",
           "bf16_tree_gb": bf16_bytes / 1e9, "int8_tree_gb": tree_bytes(qparams) / 1e9,
           "bytes_ratio": tree_bytes(qparams) / bf16_bytes, "prefill_batch": [B, S],
           "prefill_launches": prefill_counts, "logit_gap_vs_bf16": max_rel_gap(int8_last,
                                                                               bf16_last),
           "prefill_rel_err_vs_plain": plain_rel, "rel_tol": SERVE_REL_TOL,
           "generate": {"prompts": n, "prompt_len": plen, "new_tokens": new, "steps": steps,
                        "ms_per_decode_step": gen_s / steps * 1e3, "launches": gen_counts}}
    emit(res)
    del server, qparams
    torch.cuda.empty_cache()
    want = {k: v * calls for k, v in per_call.items()}
    check(prefill_counts == want, f"int8 {fam.label} prefill launches {prefill_counts}, "
                                  f"want {want}")
    want = {k: v * steps for k, v in per_step.items()}
    check(gen_counts == want, f"int8 {fam.label} generate launches {gen_counts}, want {want}")
    check(len(out) == n and all(len(o) == new and all(0 <= t < cfg.vocab_size for t in o)
                                for o in out), f"int8 {fam.label} generate: malformed tokens")
    check(plain_rel <= SERVE_REL_TOL, f"int8 {fam.label} prefill differs from its plain "
                                      f"replay by {plain_rel}")
    return res


def phase_quant_reduced() -> dict:
    """The reduced llama3.2, zamba2 and rwkv6 in float32 and int8: quantized
    on the card and on the CPU (equal bit for bit), prefill of 2 x 32
    tokens and 8 decode steps on each, held to QUANT_REDUCED_REL_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_decode_cache, init_params
    from repro_torch.models import model as M
    from repro_torch.quant import quantize_params

    results = {}
    for arch, randomize in (("llama3.2-3b", None), ("zamba2-2.7b", randomize_hybrid),
                            ("rwkv6-1.6b", randomize_rwkv)):
        cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32",
                                  compute_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        if randomize is not None:
            randomize(params, cfg, seed=2)
        q_cpu = quantize_params(params)
        q_card = quantize_params(_tree(lambda t: t.cuda(), params))
        tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))

        @torch.inference_mode()
        def run(q, device):
            tok = torch.from_numpy(tokens).to(device)
            pre = M.forward(q, cfg, {"tokens": tok})[0]
            cache = init_decode_cache(cfg, 2, 16, dtype=torch.float32, device=device)
            for t in range(8):
                logits, cache = M.decode_step(q, cfg, tok[:, t], cache, t)
            return pre.cpu(), logits.cpu()

        (pre_card, dec_card), (pre_cpu, dec_cpu) = run(q_card, "cuda"), run(q_cpu, "cpu")
        results[arch] = {"quantized_trees_bit_for_bit": same_bits(
                             _tree(lambda t: t.cpu(), q_card), q_cpu),
                         "prefill_rel_err": rel_err(pre_card, pre_cpu),
                         "decode_rel_err": rel_err(dec_card, dec_cpu)}
    emit({"phase": "quant_reduced", "float32, int8, card against CPU": results,
          "rel_tol": QUANT_REDUCED_REL_TOL})
    for arch, r in results.items():
        check(r["quantized_trees_bit_for_bit"], f"{arch} reduced: card and CPU quantize apart")
        check(max(r["prefill_rel_err"], r["decode_rel_err"]) <= QUANT_REDUCED_REL_TOL,
              f"{arch} reduced int8: card and CPU differ by {r}")
    return results


def phase_quant() -> None:
    phase_quant_llama()
    for fam in (HYBRID_FAMILY, RWKV_FAMILY):
        phase_quant_recurrent(fam)
    phase_quant_reduced()



# ------------------------------- recurrent training (K6, K6b, K4, K4b, K7, K7b, K3)
def _grad_errors(got, want, names) -> dict:
    """Relative L2 (and max abs) of every gradient against its plain one."""
    import torch

    out = {}
    for name, a, b in zip(names, got, want):
        if b is None:
            continue
        a64, b64 = a.double(), b.double()
        den = torch.linalg.vector_norm(b64).item()
        num = torch.linalg.vector_norm(a64 - b64).item()
        out[name] = dict(rel_l2=num / den if den > 0 else num,
                         max_abs_err=(a64 - b64).abs().max().item(),
                         finite=bool(torch.isfinite(a).all()))
    return out


def _grads_ok(errs: dict, tol: float) -> bool:
    return all(e["finite"] and e["rel_l2"] <= tol for e in errs.values())


def k6b_case(gen, shape, dtype, *, with_state=False, timed=False) -> dict:
    """K6b against the plain backward on one input (x, B and C column views of
    one tensor, as the model hands them); with ``timed``, K6b timed beside its
    bound and the plain backward, two launches compared bit for bit, and the
    planted fault (the state's cotangent not carried across chunks)."""
    import torch

    from repro_torch.kernels import ssm_scan as ssm

    dname = str(dtype).split(".")[-1]
    x, dt, A, Bm, Cm, D, s0 = ssm_inputs(gen, shape, dtype, with_state=with_state)
    Bb, T, H, P, N = shape
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    dh = (torch.randn((Bb, H, P, N), generator=gen, device="cuda") if with_state else None)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dstate0")
    got = ssm.ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh)
    want = ssm.ssm_scan_bwd_plain(x, dt, A, Bm, Cm, D, s0, dy, dh)
    errs = _grad_errors(got, want, names)
    tol = K6B_REL_TOL[dname]
    check(_grads_ok(errs, tol), f"ssm_scan_bwd {dname} {list(shape)}: {errs} (tol {tol})")
    res = dict(shape=list(shape), dtype=dname, state0=with_state, rel_tol=tol, errors=errs,
               max_abs_err=max(e["max_abs_err"] for e in errs.values()))
    if not timed:
        return res
    again = ssm.ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh)
    res["bit_identical_launches"] = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    check(res["bit_identical_launches"], "ssm_scan_bwd: two launches differ")
    ssm._BWD_DROP_CARRY = True
    try:
        planted = _grad_errors(ssm.ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh), want, names)
    finally:
        ssm._BWD_DROP_CARRY = False
    res["planted_fault_no_carry"] = planted
    check(not _grads_ok(planted, tol), f"ssm_scan_bwd: a dropped carry passed: {planted}")
    del got, want, again
    esz = x.element_size()
    nc = -(-T // K6_CHUNK)
    Q = K6_CHUNK
    nbytes = (2 * x.numel() * esz + 2 * dt.numel() * 4 + 4 * Bm.numel() * esz + 4 * H * 4
              + (3 * s0.numel() * 4 if with_state else 0))
    flops = Bb * H * nc * (2 * Q * Q * (3 * N + 2 * P) + 10 * Q * P * N)
    b_ms, b_by = bound_ms(nbytes, flops, dname)

    def k6b():
        return ssm.ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh)

    def plain():
        return ssm.ssm_scan_bwd_plain(x, dt, A, Bm, Cm, D, s0, dy, dh)

    res.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops, ms=time_ms(k6b, 10),
               plain_ms=time_ms(plain, 3, 1), device_ms=device_ms(k6b, 3), library_ms=None,
               fwd_ms=time_ms(lambda: ssm.ssm_scan(x, dt, A, Bm, Cm, D, s0), 10))
    res["bound_share"] = b_ms / res["ms"]
    return res


def k7b_case(gen, shape, dtype, *, decay="sigmoid", with_state=False, timed=False) -> dict:
    """K7b against the plain backward on one input; with ``timed``, K7b timed
    beside its bound and the plain backward, two launches compared bit for
    bit, and the planted faults (dw reading S_t for S_{t-1}; one tile's
    states not recomputed)."""
    import torch

    from repro_torch.kernels import rwkv6_scan as rw

    dname = str(dtype).split(".")[-1]
    r, k, v, w, u, s0 = rwkv_inputs(gen, shape, dtype, decay=decay, with_state=with_state)
    Bb, T, H, K = shape
    dy = torch.randn(r.shape, generator=gen, device="cuda").to(dtype)
    dS = torch.randn((Bb, H, K, K), generator=gen, device="cuda") if with_state else None
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    got = rw.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS)
    want = rw.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, dS)
    errs = _grad_errors(got, want, names)
    tol = K7B_REL_TOL[dname]
    check(_grads_ok(errs, tol), f"rwkv6_scan_bwd {dname} {list(shape)} {decay}: {errs} "
                                f"(tol {tol})")
    res = dict(shape=list(shape), dtype=dname, decay=decay, state0=with_state, rel_tol=tol,
               errors=errs, max_abs_err=max(e["max_abs_err"] for e in errs.values()))
    if not timed:
        return res
    again = rw.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS)
    res["bit_identical_launches"] = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    check(res["bit_identical_launches"], "rwkv6_scan_bwd: two launches differ")
    for fault, attr, value in (("dw_from_next_state", "_BWD_DW_FROM_NEXT_STATE", True),
                               ("skip_recompute_tile", "_BWD_SKIP_RECOMPUTE_TILE",
                                (T // K7_TILE) // 2)):
        setattr(rw, attr, value)
        try:
            planted = _grad_errors(rw.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS), want, names)
        finally:
            rw._BWD_DW_FROM_NEXT_STATE, rw._BWD_SKIP_RECOMPUTE_TILE = False, -1
        res[f"planted_fault_{fault}"] = planted
        check(not _grads_ok(planted, tol), f"rwkv6_scan_bwd: the {fault} fault passed: {planted}")
    del got, want, again
    esz = r.element_size()
    nbytes = 9 * r.numel() * esz + 2 * u.numel() * 4 + (3 * s0.numel() * 4 if with_state else 0)
    flops = 14 * Bb * T * H * K * K
    b_ms, b_by = bound_ms(nbytes, flops, "float32")  # the recurrence is elementwise float32

    def k7b():
        return rw.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS)

    def plain():
        return rw.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, dS)

    res.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops, ms=time_ms(k7b, 10),
               plain_ms=time_ms(plain, 1, 1), device_ms=device_ms(k7b, 3), library_ms=None,
               fwd_ms=time_ms(lambda: rw.rwkv6_scan(r, k, v, w, u, s0), 10))
    res["bound_share"] = b_ms / res["ms"]
    return res


def phase_recurrent_bwd_parity() -> dict:
    """K6b and K7b against their plain versions at each family's training
    shape in bf16 and float32 (timed, with the planted faults) and at smaller
    cases with state0 and a final-state cotangent; K4b at Zamba2's attention
    shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(24)
    bf16, f32 = torch.bfloat16, torch.float32
    k6b = {str(dt).split(".")[-1]: k6b_case(gen, RTRAIN_SSM_SHAPE, dt, timed=True)
           for dt in (bf16, f32)}
    k6b_cases = [k6b_case(gen, shape, dt, with_state=True)
                 for dt in (bf16, f32) for shape in ((2, 300, 4, 64, 64), (1, 129, 3, 128, 16))]
    torch.cuda.empty_cache()
    k7b = {str(dt).split(".")[-1]: k7b_case(gen, RTRAIN_RWKV_SHAPE, dt, timed=True)
           for dt in (bf16, f32)}
    k7b_cases = [k7b_case(gen, (2, 300, 4, 64), dt, decay=decay, with_state=True)
                 for dt in (bf16, f32) for decay in ("strong", "weak")]
    torch.cuda.empty_cache()
    k4b = k4b_case(gen, *RTRAIN_ATTN_SHAPE, bf16, timed=True)
    emit({"phase": "recurrent_bwd_parity", "ssm_scan_bwd": list(k6b.values()),
          "ssm_scan_bwd_cases": k6b_cases, "rwkv6_scan_bwd": list(k7b.values()),
          "rwkv6_scan_bwd_cases": k7b_cases, "flash_attention_bwd_zamba2": k4b,
          "library": "K6b, K7b: none (no PyTorch call computes a scan's gradient)"})
    return {"ssm_scan_bwd": k6b["bfloat16"], "rwkv6_scan_bwd": k7b["bfloat16"]}


class TrainFamily(NamedTuple):
    """What the recurrent training phases need of a model family."""
    label: str
    arch: str
    kernels: tuple  # the wrappers whose launches are counted and checked
    per_pass: Callable  # cfg -> launches of one forward and backward pass
    per_forward: Callable  # cfg -> launches of one forward pass without a gradient
    describe: Callable  # (cfg, params) -> the model line; checks the model's size
    randomize: Callable  # (params, cfg, seed)
    scan_fault: Callable  # () -> context: the family's planted backward fault
    replay_seq: int  # the replay's sequence length
    reduced_tol: float  # the reduced float32 card-against-CPU limit
    reduced_seq: int  # the reduced check's tokens a row (K6b: three chunks)


def _hybrid_pass(cfg) -> dict:
    per_call, _ = hybrid_counts(cfg)
    n, G = per_call["ssm_scan"], per_call["flash_attention"]
    return {"ssm_scan": n, "ssm_scan_bwd": n, "flash_attention": G, "flash_attention_bwd": G}


def _hybrid_forward(cfg) -> dict:
    return {**_hybrid_pass(cfg), "ssm_scan_bwd": 0, "flash_attention_bwd": 0}


def _rwkv_pass(cfg) -> dict:
    return {"rwkv6_scan": cfg.num_layers, "rwkv6_scan_bwd": cfg.num_layers}


def _rwkv_forward(cfg) -> dict:
    return {"rwkv6_scan": cfg.num_layers, "rwkv6_scan_bwd": 0}


def _kernel_module(name: str):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


HYBRID_TRAIN = TrainFamily(
    label="hybrid", arch=HYBRID["arch"], kernels=HYBRID_TRAIN_KERNELS, per_pass=_hybrid_pass,
    per_forward=_hybrid_forward, describe=hybrid_model, randomize=randomize_hybrid,
    scan_fault=lambda: rebind(_kernel_module("ssm_scan"), _BWD_DROP_CARRY=True),
    replay_seq=RTRAIN_REPLAY_SEQ["hybrid"], reduced_tol=RTRAIN_REDUCED_REL_TOL["hybrid"],
    reduced_seq=160)
RWKV_TRAIN = TrainFamily(
    label="rwkv", arch=RWKV["arch"], kernels=RWKV_TRAIN_KERNELS, per_pass=_rwkv_pass,
    per_forward=_rwkv_forward, describe=rwkv_model, randomize=randomize_rwkv,
    scan_fault=lambda: rebind(_kernel_module("rwkv6_scan"), _BWD_DW_FROM_NEXT_STATE=True),
    replay_seq=RTRAIN_REPLAY_SEQ["rwkv"], reduced_tol=RTRAIN_REDUCED_REL_TOL["rwkv"],
    reduced_seq=64)


@contextlib.contextmanager
def recurrent_train_ops(mode: str):
    """The training path's ops: "plain" the plain K3, attention and scans
    (forward and backward) on the card; the scans through `SSMScan` and
    `RWKV6Scan` with the kernel wrappers they call rebound to the plain
    versions."""
    if mode == "kernels":
        yield
        return
    ssm, rw = _kernel_module("ssm_scan"), _kernel_module("rwkv6_scan")
    with train_ops("plain"), \
            rebind(ssm, ssm_scan=ssm.ssm_scan_plain, ssm_scan_bwd=ssm.ssm_scan_bwd_plain), \
            rebind(rw, rwkv6_scan=rw.rwkv6_scan_plain, rwkv6_scan_bwd=rw.rwkv6_scan_bwd_plain):
        yield


def recurrent_batch(cfg, per_cohort_batch: int, seq_len: int) -> dict:
    """C cohorts of b x S tokens from `SyntheticLMDataset` (seed 0), cohort-major, on the card."""
    import torch

    from repro_torch.data import ShardedBatcher, SyntheticLMDataset

    C = RTRAIN["cohorts"]
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, num_clients=C, alpha=0.5, seed=0)
    batch = ShardedBatcher(ds, num_cohorts=C, per_cohort_batch=per_cohort_batch,
                           seq_len=seq_len).next_batch()
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _svrp_config():
    from repro_torch.core.deep import DeepSVRPConfig

    return DeepSVRPConfig(eta=RTRAIN["eta"], local_lr=RTRAIN["local_lr"],
                          local_steps=RTRAIN["local_steps"], anchor_prob=0.0625)


def _round_launches(fam, cfg, coins, dtype_groups: int) -> dict:
    C, K = RTRAIN["cohorts"], RTRAIN["local_steps"]
    passes = sum(C * (1 + K) + C * int(coin) for coin in coins)
    want = {k: n * passes for k, n in fam.per_pass(cfg).items()}
    want["prox_update"] = dtype_groups * C * K * len(coins)
    return want, passes


def phase_recurrent_train(fam: TrainFamily):
    """DeepSVRP training of the family's model at full width and depth in
    bf16 (weights from seed 0 on the card)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_svrp_train_step
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(fam.arch)
    C, K, S = RTRAIN["cohorts"], RTRAIN["local_steps"], RTRAIN["seq_len"]
    step, helpers = make_svrp_train_step(cfg, _svrp_config(), cohorts=C)
    state = helpers["init_state"]()
    model = fam.describe(cfg, state.params)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    groups = len({t.dtype for t in tree_leaves(state.params)})
    kernels = fam.kernels + ("prox_update",)
    for b in (RTRAIN["per_cohort_batch"], 1):
        batch = recurrent_batch(cfg, b, S)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts(kernels)
        ms, losses = [], []
        try:
            for coin in RTRAIN["coins"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, metrics = step(state, batch, refresh=coin)
                losses.append(metrics["loss"].item())
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                state = new
                del new
            break
        except torch.cuda.OutOfMemoryError:
            check(b > 1, f"{cfg.name}: DeepSVRP does not fit the card at 1 x {S} a cohort")
            emit({"phase": f"{fam.label}_train_oom", "per_cohort_batch": b,
                  "note": f"out of memory at {b} x {S} a cohort: dropping to 1 x {S}"})
            state = helpers["init_state"]()
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    want, passes = _round_launches(fam, cfg, RTRAIN["coins"], groups)
    tokens = C * b * S
    steady = float(np.mean(ms[1:]))
    emit({"phase": f"{fam.label}_train", "model": model, "params": n_params,
          "batch": list(batch["tokens"].shape), "cohorts": C, "local_steps": K,
          "eta": RTRAIN["eta"], "local_lr": RTRAIN["local_lr"], "coins": list(RTRAIN["coins"]),
          "losses": losses, "ms_per_round": ms, "ms_per_round_after_first": steady,
          "tokens_per_round": tokens, "trained_tokens_per_s": tokens / steady * 1e3,
          "passes": passes, "dtype_groups": groups, "peak_mem_gb": peak / 1e9,
          "launches": launches, "launches_expected": want})
    check(launches == want, f"{fam.label} train launches {launches}, want {want} ({passes} "
                            f"passes; K3 {groups} dtype groups x C K a round)")
    check(all(np.isfinite(losses)), f"{fam.label} train losses {losses} not finite")
    del state
    torch.cuda.empty_cache()
    return cfg, step, helpers, batch, launches


def phase_recurrent_replay(fam: TrainFamily, cfg, step, helpers, batch) -> dict:
    """Round 1 again from the seed-0 state with the kernels and with the
    plain K3, attention and scans (forward and backward) on the card, at
    ``fam.replay_seq`` tokens a row: the cohort-mean gradient at x0 with the
    loss there, and the round's update."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.utils.tree import value_and_grad

    C = RTRAIN["cohorts"]
    b = batch["tokens"].shape[0] // C
    S = fam.replay_seq
    shards = [{k: v[c * b:(c + 1) * b, :S].long() for k, v in batch.items()} for c in range(C)]
    cut = {k: v[:, :S] for k, v in batch.items()}

    def loss(params, shard):
        return M.loss_fn(params, cfg, shard)

    results, kept = {}, {}
    for mode in ("kernels", "plain"):
        state = helpers["init_state"]()
        x0 = state.params
        g0, loss0 = None, 0.0
        t0 = time.perf_counter()
        with recurrent_train_ops(mode):
            for shard in shards:
                l, g = value_and_grad(loss, x0, shard)
                loss0 += l.item() / C
                g0 = _tree(lambda t: t.float() / C, g) if g0 is None else \
                    _tree(lambda a, t: a.add_(t.float() / C), g0, g)
                del g
            new, _ = step(state, cut, refresh=False)
        torch.cuda.synchronize()
        entry = {"wall_s": time.perf_counter() - t0, "loss_at_x0": loss0}
        if mode == "kernels":
            kept = {"grad": g0, "x": new.params}
            entry["update_norm"] = tree_dist(new.params, x0)
        else:
            entry["grad_rel_l2"], entry["grad_worst_leaf_rel_l2"] = tree_rel_err(g0, kept["grad"])
            entry["update_rel_l2"] = tree_dist(new.params, kept["x"]) / \
                results["kernels"]["update_norm"]
            entry["loss_rel_err"] = abs(loss0 - results["kernels"]["loss_at_x0"]) / \
                abs(results["kernels"]["loss_at_x0"])
        results[mode] = entry
        del state, new, x0, g0
        torch.cuda.empty_cache()
    del kept
    emit({"phase": f"{fam.label}_train_replay", "round": 1, "tokens_per_row": S,
          "grad_rel_tol": TRAIN_GRAD_REL_TOL, "update_rel_tol": TRAIN_UPDATE_REL_TOL,
          "loss_rel_tol": TRAIN_LOSS_REL_TOL, "note": "each run against the kernels' run",
          **results})
    plain = results["plain"]
    check(plain["grad_rel_l2"] <= TRAIN_GRAD_REL_TOL
          and plain["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
          and plain["update_rel_l2"] <= TRAIN_UPDATE_REL_TOL,
          f"{fam.label} replay: the plain run differs from the kernels' by {plain}")
    return results


def _reduced_f32(arch):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), param_dtype="float32",
                               compute_dtype="float32")


def phase_recurrent_reduced(fam: TrainFamily) -> dict:
    """The reduced model in float32 (weights randomised where init hides
    faults), 4 x ``fam.reduced_seq`` tokens: one DeepSVRP round (C 2, K 2, a refresh, gbar =
    the gradient at x0) and 3 AdamW steps on the card against the same on
    the CPU; the round again on the card with the family's planted backward
    fault, which must leave the limit on gbar."""
    import numpy as np
    import torch

    from repro_torch.core.deep import DeepSVRPConfig, grad_of
    from repro_torch.launch import make_adamw_train_step, make_svrp_train_step
    from repro_torch.launch.steps import AdamWTrainState, SVRPServerState
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    cfg = _reduced_f32(fam.arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    fam.randomize(params, cfg, 5)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, fam.reduced_seq))
    batch_cpu = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    C = 2
    svrp = DeepSVRPConfig(eta=1.0, local_lr=0.05, local_steps=2, anchor_prob=0.5)
    gbar = _tree(lambda t: t / C, grad_of(lambda p, b: M.loss_fn(p, cfg, b),
                                          {k: v[:2] for k, v in batch_cpu.items()})(params))
    _tree(lambda a, t: a.add_(t / C), gbar, grad_of(lambda p, b: M.loss_fn(p, cfg, b),
                                                     {k: v[2:] for k, v in batch_cpu.items()})(params))
    def svrp_round(dev):
        p = _tree(lambda t: t.to(dev, copy=True), params)
        g = _tree(lambda t: t.to(dev, copy=True), gbar)
        batch = {k: v.to(dev) for k, v in batch_cpu.items()}
        step, _ = make_svrp_train_step(cfg, svrp, cohorts=C, device=dev)
        state = SVRPServerState(params=p, anchor=p, anchor_grad=g, step=0,
                                rng=torch.Generator().manual_seed(0))
        return (*step(state, batch, refresh=True), batch)

    out = {}
    for dev in ("cuda", "cpu"):
        zero_launch_counts(fam.kernels)
        state, metrics, batch = svrp_round(dev)
        svrp_launches = launch_counts(fam.kernels)
        astep, _ = make_adamw_train_step(cfg, lr=OPTIM["lr"], clip=OPTIM["clip"], device=dev)
        p2 = _tree(lambda t: t.to(dev, copy=True), params)
        astate = AdamWTrainState(p2, adamw_init(p2))
        losses = []
        for _ in range(3):
            astate, am = astep(astate, batch)
            losses.append(am["loss"].item())
        out[dev] = dict(svrp=state, svrp_loss=metrics["loss"].item(), adamw=astate.params,
                        adamw_losses=losses, svrp_launches=svrp_launches)
    card, cpu = out["cuda"], out["cpu"]
    res = {"model": f"{cfg.name} reduced, float32, {cfg.num_layers} layers, d_model "
                    f"{cfg.d_model}", "rel_tol": fam.reduced_tol,
           "svrp_loss_rel_err": abs(card["svrp_loss"] - cpu["svrp_loss"]) / abs(cpu["svrp_loss"]),
           "adamw_losses_card": card["adamw_losses"], "adamw_losses_cpu": cpu["adamw_losses"],
           "svrp_launches_card": card["svrp_launches"]}
    for field in ("params", "anchor", "anchor_grad"):
        res[f"svrp_{field}_rel_l2"], res[f"svrp_{field}_worst_leaf"] = tree_rel_err(
            _tree(lambda t: t.cpu(), getattr(card["svrp"], field)), getattr(cpu["svrp"], field))
    res["adamw_params_rel_l2"], res["adamw_params_worst_leaf"] = tree_rel_err(
        _tree(lambda t: t.cpu(), card["adamw"]), cpu["adamw"])
    with fam.scan_fault():
        faulted, _, _ = svrp_round("cuda")
    res["planted_fault_svrp_anchor_grad_rel_l2"], _ = tree_rel_err(
        _tree(lambda t: t.cpu(), faulted.anchor_grad), cpu["svrp"].anchor_grad)
    del faulted
    emit({"phase": f"{fam.label}_train_reduced", **res})
    worst = max(res["svrp_params_rel_l2"], res["svrp_anchor_grad_rel_l2"],
                res["adamw_params_rel_l2"], res["svrp_loss_rel_err"])
    check(worst <= fam.reduced_tol, f"{fam.label} reduced: card against CPU {worst} > "
                                    f"{fam.reduced_tol}: {res}")
    check(res["planted_fault_svrp_anchor_grad_rel_l2"] > fam.reduced_tol,
          f"{fam.label} reduced: the planted backward fault moved gbar by only "
          f"{res['planted_fault_svrp_anchor_grad_rel_l2']}")
    check(all(v > 0 for k, v in card["svrp_launches"].items() if "prox" not in k),
          f"{fam.label} reduced: the card's round launched {card['svrp_launches']}")
    return res


def phase_recurrent_adamw(fam: TrainFamily) -> dict:
    """2 AdamW steps on the family's model at full size in bf16 (float32
    moments) over the training batch in one pass: ms a step, peak memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_adamw_train_step

    cfg = get_config(fam.arch)
    batch = recurrent_batch(cfg, RTRAIN["per_cohort_batch"], RTRAIN["seq_len"])
    step, helpers = make_adamw_train_step(cfg, lr=OPTIM["lr"], clip=OPTIM["clip"])
    state = helpers["init_state"]()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(fam.kernels)
    ms, losses, norms = [], [], []
    for _ in range(RTRAIN_ADAMW_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts(fam.kernels)
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * RTRAIN_ADAMW_STEPS for k, n in fam.per_pass(cfg).items()}
    B, S = batch["tokens"].shape
    emit({"phase": f"{fam.label}_adamw", "model": cfg.name, "batch": [B, S],
          "steps": RTRAIN_ADAMW_STEPS, "lr": OPTIM["lr"], "clip": OPTIM["clip"],
          "losses": losses, "grad_norms": norms, "ms_per_step": ms,
          "trained_tokens_per_s_step2": B * S / ms[-1] * 1e3, "state_gb": state_bytes(state) / 1e9,
          "peak_mem_gb": peak / 1e9, "launches": launches, "launches_expected": want})
    check(launches == want, f"{fam.label} adamw launches {launches}, want {want}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{fam.label} adamw losses {losses} or norms {norms} not finite")
    del state
    torch.cuda.empty_cache()
    return launches


def phase_recurrent_fed_lm(fam: TrainFamily) -> dict:
    """2 rounds of run_batch("deep_svrp") on a FedLMProblem over the reduced
    model (float32) on the card, launch counts exact, the losses against the
    same rounds on the CPU."""
    import numpy as np
    import torch

    from repro_torch.core import Draws, draw_schedule
    from repro_torch.experiments import run_batch
    from repro_torch.problems.fed_lm import make_fed_lm_problem

    cfg = _reduced_f32(fam.arch)
    fl = RTRAIN_FEDLM
    seeds, M, R, K = list(range(fl["seeds"])), fl["clients"], fl["rounds"], fl["local_steps"]
    draws = draw_schedule(seeds, M, R, fl["anchor_prob"], clients=False)
    draws = Draws(None, draws.coins[:R])
    grid = dict(eta=1.0, local_lr=0.2, anchor_prob=fl["anchor_prob"])
    res = {}
    x0_card = None
    for dev in ("cuda", "cpu"):
        problem, x0 = make_fed_lm_problem(cfg, num_clients=M, per_client_batch=fl["batch"],
                                          seq_len=fl["seq"], seed=0, device=dev)
        # the CPU starts from the card's x0 (a generator's draws differ by device)
        x0_card = x0 if x0_card is None else x0_card
        x0 = x0_card.to(dev)
        zero_launch_counts(fam.kernels + ("prox_update_batched",))
        out, wall = _timed(lambda: run_batch(
            "deep_svrp", problem, grid=grid, seeds=seeds, x0=x0, x_star=x0, num_steps=R,
            local_steps=K, fused=True, draws=draws, device=dev))
        res[dev] = (out, wall, launch_counts(fam.kernels + ("prox_update_batched",)))
    card, wall, launched = res["cuda"]
    cpu = res["cpu"][0]
    B = len(seeds)
    refresh = int(draws.refresh[:R].sum())
    grads = M + R * B * M * (1 + K) + refresh * B * M
    metric = R * B * M
    want = {k: n * grads for k, n in fam.per_pass(cfg).items()}
    for k, n in fam.per_forward(cfg).items():
        want[k] += n * metric
    want["prox_update_batched"] = K * R
    loss, loss_cpu = card.dist_sq.cpu().numpy(), cpu.dist_sq.numpy()
    rel = float(np.max(np.abs(loss - loss_cpu) / np.abs(loss_cpu)))
    emit({"phase": f"{fam.label}_fed_lm", "model": f"{cfg.name} reduced, float32",
          "params": problem.dim, "clients": M, "tokens_per_client": [fl["batch"], fl["seq"]],
          "trials": B, "rounds": R, "local_steps": K, "coins": draws.coins.tolist(),
          "wall_s": wall, "loss": loss.tolist(), "loss_cpu": loss_cpu.tolist(),
          "loss_max_rel_diff": rel, "rel_tol": fl["rel_tol"],
          "comm_equal": bool(np.array_equal(card.comm.cpu().numpy(), cpu.comm.numpy())),
          "launches": launched, "launches_expected": want,
          "launch_formula": f"grads G = M + R B M (1+K) + F B M = {grads}, metric passes "
                            f"R B M = {metric}"})
    check(launched == want, f"{fam.label} fed_lm launches {launched}, want {want}")
    check(np.isfinite(loss).all() and rel <= fl["rel_tol"],
          f"{fam.label} fed_lm: card against CPU {rel} > {fl['rel_tol']}")
    check(np.array_equal(card.comm.cpu().numpy(), cpu.comm.numpy()),
          f"{fam.label} fed_lm: comm differs between card and CPU")
    return res


def phase_recurrent_training() -> dict:
    """The recurrent_train path: the backward kernels' parity, then each
    family's full-size DeepSVRP rounds, their replay, a profile, the reduced
    card-against-CPU checks, the AdamW steps and the federated LM."""
    import torch

    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    parity = timed("bwd_parity", phase_recurrent_bwd_parity)
    launches = {}
    for fam in (HYBRID_TRAIN, RWKV_TRAIN):
        cfg, step, helpers, batch, launches[fam.label] = timed(
            f"{fam.label}_train", phase_recurrent_train, fam)
        timed(f"{fam.label}_profile", phase_train_profile, step, helpers, batch,
              label=f"{fam.label}_train_profile")
        timed(f"{fam.label}_replay", phase_recurrent_replay, fam, cfg, step, helpers, batch)
        del cfg, step, helpers, batch
        timed(f"{fam.label}_adamw", phase_recurrent_adamw, fam)
        timed(f"{fam.label}_reduced", phase_recurrent_reduced, fam)
        timed(f"{fam.label}_fed_lm", phase_recurrent_fed_lm, fam)
    emit({"phase": "recurrent_train_seconds", **seconds, "total": sum(seconds.values())})
    return {"parity": parity, "launches": {**launches["hybrid"], **launches["rwkv"]}}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--only", choices=PATHS, default=None,
                    help="drive one path only (for development); the default drives all "
                         "eleven and prints the kernels line")
    args = ap.parse_args(argv)
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
    run = {name: args.only in (None, name) for name in PATHS}
    try:
        phase_device()
        if run["sweep"]:
            qprob, lprob = fig1_quadratic("cuda"), fig2_logistic("cuda")
            l_star = lprob.minimizer()
            parity = phase_parity(qprob, lprob)
            launches, runs = phase_main_path(qprob, lprob, l_star)
            phase_profile(runs)
            phase_cpu_replay(runs, {"quadratic": fig1_quadratic("cpu"),
                                    "logistic": fig2_logistic("cpu")})
            del qprob, lprob, runs
        if run["engine"]:
            qprob, lprob = fig1_quadratic("cuda"), fig2_logistic("cuda")
            cpu_problems = {"quadratic": fig1_quadratic("cpu"), "logistic": fig2_logistic("cpu")}
            phase_engine(qprob, lprob, lprob.minimizer(), cpu_problems)
            phase_engine_slice(qprob, cpu_problems)
            del qprob, lprob, cpu_problems
            torch.cuda.empty_cache()
        if run["deep"]:
            phase_deep_parity()
            phase_deep()
            torch.cuda.empty_cache()
        if run["online"]:
            phase_online()
        if run["serving"]:
            attention = phase_attention_parity()
            cfg, params, tokens, serve_launches = phase_serving()
            phase_serving_profile(cfg, params, tokens)
            del cfg, params, tokens
            torch.cuda.empty_cache()
        if run["hybrid"]:
            ssm = phase_ssm_parity()
            torch.cuda.empty_cache()
            cfg, params, tokens, hybrid_launches = phase_recurrent_serving(HYBRID_FAMILY)
            phase_serving_profile(cfg, params, tokens)
            del cfg, params, tokens
            torch.cuda.empty_cache()
            phase_recurrent_paths(HYBRID_FAMILY)
        if run["ssm"]:
            rwkv = phase_rwkv_parity()
            torch.cuda.empty_cache()
            cfg, params, tokens, rwkv_launches = phase_recurrent_serving(RWKV_FAMILY)
            phase_serving_profile(cfg, params, tokens)
            del cfg, params, tokens
            torch.cuda.empty_cache()
            phase_recurrent_paths(RWKV_FAMILY)
        if run["training"]:
            train_parity = phase_train_parity()
            torch.cuda.empty_cache()
            cfg_train, step, helpers, batch, train_launches = phase_train()
            phase_train_profile(step, helpers, batch)
            phase_train_reduced()
            phase_train_replay(cfg_train, step, helpers, batch)
            del cfg_train, step, helpers, batch
            torch.cuda.empty_cache()
        if run["optim"]:
            phase_optim()
            torch.cuda.empty_cache()
        if run["quant"]:
            phase_quant()
            torch.cuda.empty_cache()
        if run["recurrent_train"]:
            rtrain = phase_recurrent_training()
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if not all(run.values()):
        print(f"chip_smoke: --only {args.only}: no kernels line and no ok line", file=sys.stderr)
        return 0
    # The sweep runs in float64; serving in bf16 (K5: bf16 q against the
    # server's default float32 cache); hybrid serving (K6), rwkv serving (K7;
    # launches: prefill and generate) and training in bf16.
    rows = {
        "prox_update_batched": ("src/repro_torch/kernels/csrc/prox_update.cu",
                                "src/repro/kernels/prox_update.py:91",
                                launches, parity[("prox_update_batched", "float64")]),
        "quadratic_prox_gd_batched": ("src/repro_torch/kernels/csrc/prox_update.cu",
                                      "src/repro/kernels/prox_update.py:91",
                                      launches,
                                      parity[("quadratic_prox_gd_batched", "float64", 16)]),
        "logistic_prox_gd_batched": ("src/repro_torch/kernels/csrc/logistic_prox.cu",
                                     "src/repro/kernels/logistic_prox.py:64",
                                     launches, parity[("logistic_prox_gd_batched", "float64")]),
        "prox_update": ("src/repro_torch/kernels/csrc/prox_update.cu",
                        "src/repro/kernels/prox_update.py:45",
                        train_launches, train_parity["prox_update"]),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:105",
                            serve_launches, attention["flash_attention"]),
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/ops.py:105",
                                train_launches, train_parity["flash_attention_bwd"]),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:62",
                             serve_launches, attention["decode_attention"]),
        "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:68", hybrid_launches, ssm),
        "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan.py:58", rwkv_launches, rwkv),
        "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                         "src/repro/kernels/_ssm_chunked.py:18", rtrain["launches"],
                         rtrain["parity"]["ssm_scan_bwd"]),
        "rwkv6_scan_bwd": ("src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                           "src/repro/kernels/ref.py:58", rtrain["launches"],
                           rtrain["parity"]["rwkv6_scan_bwd"]),
    }
    kernels = []
    for name, (source, replaces, counts, p) in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": p["max_abs_err"], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p.get("library_ms"),
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
