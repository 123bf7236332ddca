#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases; any failure exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ray_tpu_torch/ops/csrc (nvcc, one
     process per source, in parallel): the Hopper kernels K1 flash_fwd, K2
     flash_bwd_dkdv and K3 flash_bwd_dq (bf16/fp16 at head_dim 64 or 128),
     the general kernels K4-K6 (*_general: fp32, or any other head_dim
     up to 256) and the LayerNorm kernels (layer_norm);
  3. holds each kernel against its plain PyTorch version on the card, on
     the same inputs; the kernels run on the whole tensors and are
     compared a chunk of (b, h) slices at a time (near 2 GB of the plain
     versions' fp32 scores a chunk). K1-K3: [8,12,1024,64] bf16 causal
     (GPT-2 124M's shape), fp16, non-causal ragged, causal Sq < Sk and
     Sq > Sk, D 128 (bf16 causal, and fp16 non-causal with Sq != Sk), and
     a row length of one tile plus one; then all three through autograd
     against fp32 autograd of the plain attention; then, with the same
     tolerances, each training path's own shape: [8,20,1024,64]
     (gpt2-774m), [4,25,1024,64] (gpt2-1.5b), [4,16,4096,64],
     [2,16,8192,64] and [1,16,16384,64] causal (bench_long_context's
     points, where the reference runs _flash_fwd_kernel), [1,2,4096,64]
     non-causal, [64,12,197,64] non-causal (ViT-B/16) and [1,2,4096,64]
     causal (a Ulysses rank's in phase 5j; ~15-30 s). K4-K6:
     llama-tiny's [2,4,64,16] fp32 causal, fp32 at D 64, 128 and 256 and
     at D 1, bf16 at D 32, fp16 at D 80, [8,12,1024,64] fp32,
     [1,2,8192,64] fp32 (bench_ring_parity's shape) and [4,16,1024,80]
     fp16 (fp32 within 1e-5, 16-bit within phase 3's tolerance; ~5 s);
  3d. Granite 4.0-H's attention path (``granite_phase``): K1-K3 through
     ``ops.attention.attention`` at [8,32,8192,128] bf16 causal with the
     score scale 0.0078125 (``attention_multiplier``, not 1/sqrt(128)),
     the 8 KV heads expanded onto 32 by ``expand_kv_heads``, held to
     ``mha_reference_with_lse`` (o within phase 3's kernel tolerance, lse
     within its lse tolerance) and to its fp32 autograd (dq, and dk, dv
     through the expansion, within phase 3's autograd tolerance), the
     reference a batch row and a KV head's four query heads at a time;
     then one training step of the 10-layer cut of granite-4.0-h-small
     (layers 0-9, experts 0-7 of 72 held; bf16, adafactor(1e-4), batch 8
     x S 8192) with the launch counters reset just before: a finite first
     loss within 1 of ln(vocab), K1 twice (the forward and the layer's
     recompute) and K2, K3 once an attention layer, no general kernel;
  4. after a second of warm-up, times each kernel at the GPT-2 shape
     (device time per call, from torch.profiler) beside its plain
     version, its bound from the data-sheet peaks, and
     F.scaled_dot_product_attention's forward and backward as yardsticks
     (never used by the port), and prints K1 / SDPA forward and K2 / SDPA
     backward; then K1, K2, K3 and SDPA's forward and backward at
     [1,16,16384,64] bf16 causal, each beside its bound; then K4-K6 at
     llama-tiny's shape, at [8,12,1024,64] fp32 and at [4,16,1024,80]
     fp16, and K4 also at [1,2,8192,64] fp32, against their plain
     versions, SDPA's forward in the same dtype and their bound (fp32: the
     CUDA cores' 67 TFLOP/s; fp16: the tensor cores'), and K5+K6 beside
     SDPA's backward (dq, dk, dv) in the same dtype and the backward's
     bound (5 products);
  4b. holds the LayerNorm kernels (through autograd) against the plain
     LayerNorm at the benchmark cells' shapes, [16384,1600] and
     [65536,1024] bf16, then times them forward and backward beside their
     bound (bytes over the data sheet's bandwidth), the plain composite
     and F.layer_norm (never used by the port); the training phases of 5
     count the LayerNorm launches a step and require them;
  4c. holds the scan's kernels (ops/ssd.py; chunk_state, state_pass,
     chunk_scan, chunk_dg, chunk_bc) against the plain scan at the
     granite-4.0-h-small cell's shape, [8,8192,128,64] n 128 chunk 256,
     x, B and C split from one bf16 row a position as the mixer leaves
     them: y and the gradients of x, dt, A, B and C against the plain
     version's fp32 autograd (TOL_SSD), each kernel launched as a call
     needs; then times the forward and the backward (device time) beside
     their bound (portbench/roofline_ssd.py), the plain version, and the
     instantiations' registers and spills; phase 3d's step requires each
     Mamba layer's launches (forward, recompute, and the backward's own
     chunk_state and state_pass forward before its five kernels);
  5. checks a tiny GPT-2 training step through the kernels against the
     same step through the plain attention, then trains gpt2-124m (bf16,
     fp32 master, adamw_lowmem, batch 8, seq 1024) for 2 + 5 steps with
     the launch counters reset just before, and checks every loss is
     finite, every layer launched each kernel once per step and no call
     went to the general kernels;
  6. serves llama-1b at full width (22 layers, d 2048, 32 heads, 4 KV
     heads, vocab 32000; bf16, random weights from torch.Generator seed 0):
     holds K1 against the plain attention on layer 0's q/k/v of a
     128-token prompt ([1,32,128,64] bf16 causal, phase 3's tolerances);
     holds forward() (K1, 22 launches, counted from zero) against an
     fp32 run of the same weights on every row, the paged prefill's last
     row against both and against the dense cache, and four chained paged
     decode steps against the dense cache; two planted faults (forward
     with non-causal K1, a decode step with one page of the table mapped
     to an unwritten page) must read above their gate's tolerance; drives
     SlotEngine(num_slots=8, chunk=128, page_size=16, decode_block=16)
     through bench_llm's traffic
     (128-token prompts, 128 new tokens, greedy) at concurrency 1, 4 and
     8 and with 32 requests queued, requiring every request to end with
     "length" and 128 tokens and the page pool to drain; checks a prefix
     hit (>= 112 matched tokens); replays one seeded temperature-0.8
     request and requires the same 128 tokens, with no block graph
     captured after warmup; times the sampler every decode step runs
     and its Gumbel noise beside the same noise with torch.log;
     calls LLMServer once plain and once streaming; then serves 4 requests
     of 128-token prompts and 64 new tokens, and teacher-forces their
     tokens through the paged functions for tp1's top-2 logit margins,
     the references of 6b;
 6b. llama-1b tp-sharded at tp = 2 (the same weights), two spawned ranks
     on the one card (gloo, each on cuda:0; rank 0 schedules, rank 1
     follows): the paged prefill's last row and four chained paged decode
     steps against an fp32 run of the same weights within TOL_LLAMA;
     planted faults, the w_down sum skipped on one layer (0, 11 or 21) and
     each rank attending to the other rank's KV heads, must read above it;
     SlotEngine(num_slots=8, chunk=128, page_size=16, decode_block=4,
     mesh=) on the 4 requests (blocks of 4: an eager tp2 step costs ~0.13
     s, and a block of 16 runs 16 steps for each prompt's prefill), each token equal to tp1's up to the first
     step whose tp1 top-2 margin is below TP2_MARGIN_FACTOR times the
     largest |tp2 - tp1| logit difference of the checks, and tp1's
     tokens teacher-forced through tp2's paged functions giving tp1's
     argmax at every step whose margin is not below it; each rank holds
     about half of tp1's parameter bytes and exactly half of the KV pool;
     no CUDA graph captured at tp2 (phase 6 requires tp1's two);
     LLMServer(tp=2) refused on one card; decode step ms at tp2 beside
     tp1's, printed, not gated; then bench.py's tp2 check, llama-tiny fp32
     (random weights, seed 1) tp1 against tp2 on the card, greedy and
     seeded-sampled (temperature 0.7, seed 99) tokens bit-equal;
  7. on-device PPO at bench.py's bench_ppo shape: OnDevicePPO(atari_sim(256),
     rollout_length=128, minibatches=8, num_sgd_iter=4), the Nature-CNN
     policy (random weights from torch.Generator seed 0). Holds the
     threefry draws and three env steps on the card bit-equal to the CPU's
     for the same keys and actions; the conv policy (bf16 trunk) against an
     fp32 evaluation in the JAX package's layout (NHWC patches, HWIO
     weights, (h, w, c) flatten), and GAE against a float64 loop, each gate
     above its planted fault (a (c, h, w) flatten, GAE without the done
     mask); one eager iteration followed by the capture of the iteration's
     CUDA graph, a warm replay, then 5 replays timed on the host clock with a sync on the last loss
     (env-steps/s = 5 * 128 * 256 / wall) and one replay on CUDA events;
     one replay against one eager iteration from the same state; every
     metric finite and timesteps_this_iter 32768; then CartPole
     (cartpole(64), rollout 128, 8 minibatches, 4 epochs, seed 0) must reach
     mean_episode_len >= 128 within 120 iterations;
 7b. the actor-based RLlib algorithms through ``XConfig()...build()`` (no
     device: the learner on the card; the rollout worker's policy on the
     CPU), locally: PPO on AtariSim at full width (16 envs x 128 steps,
     PPOConfig's defaults; 1 warm-up + 2 timed iterations), recurrent PPO
     (RepeatPrevObs, LSTM 256 over (256, 256); 2), A2C ((256, 256); 3),
     IMPALA, IMPALA-LSTM and APPO (8 batches an iteration; 2 each) and
     DQN at its defaults until the first target sync (500 updates).
     Gates: learner parameters and optimizer state on the card, the
     worker's policy on the CPU; every metric finite and timesteps_total
     as the settings imply; each algorithm's first learner update replayed
     on the card and the CPU from the same inputs under full_fp32 (loss
     1e-5, parameters 1e-4 of their norm; PPO: one SGD step so, then the
     whole update's parameters so and its last loss 1e-3; PPO-AtariSim's
     bf16 trunk: one SGD step, loss 2e-2, parameters 1e-2, and its
     ppo_loss gradients per leaf 2e-2, conv biases 1e-1); PPO-AtariSim's
     save/restore bit-identical on the card; no attention kernel. Prints
     PPO-AtariSim's env-steps/s, rollout and learner ms an iteration and
     each run's wall seconds (~30-90 s);
 7c. RLlib's other algorithms through ``XConfig()...build()`` (no device:
     the learner on the card, the workers' policies on the CPU), each at
     its config's defaults: SAC and TD3 on FastPendulum until 64 updates
     (SAC 17 iterations, TD3 9, half of TD3's with the delayed actor
     step); CQL for 4 iterations of 64 updates (behaviour cloning until
     update 200, then SAC's objective) on a Pendulum log the phase writes
     with the port's JsonWriter (16 envs x 1,000 uniform steps in [-2,
     2]); MARWIL (beta 1) and BC, 2 iterations each, on 4,096 CartPole
     steps logged from the port's PPO after 15 iterations (the recipe of
     tests/test_bc_td3.py), then DM and DR on that log, env-major, for
     MARWIL's policy, the fitted-Q model on the card; Ape-X (2 workers, 2
     shards) on InlineRuntime, this script's synchronous in-process
     runtime, until 2 iterations past learning_starts; ES and ARS, 2
     iterations each, locally on the CPU. Gates: learner parameters and
     optimizer state on the card, worker policies on the CPU; every
     metric finite and timesteps_total as the settings imply; recorded
     learner updates (SAC's first; TD3's first with and without its actor
     step; CQL's first in each phase; MARWIL's, BC's and Ape-X's DQN's
     first) replayed on the card and the CPU from the same inputs under
     full_fp32, within phase 7b's TOL_RL_LOSS (the primary loss relative,
     the others relative to max(|value|, 1)) and TOL_RL_PARAMS;
     FittedQModel's fit (500 Adam steps) on the card against the CPU from
     the same weights within TOL_FQE_CARD; no attention kernel launched.
     Prints SAC's and TD3's env-steps/s, each learner's ms an update
     (CUDA events), DM's and DR's estimates and each run's wall seconds;
  8. the Train library on InlineRuntime (``train_library_phase``). 8a:
     a 10 MB fp32 tensor, an 8 MB bf16 tensor and gpt2-124m's state dict
     through a protocol-5 pickler whose dispatch table holds the port's
     reducer: back on the card bit-equal, one out-of-band buffer a tensor,
     no storage in band; ms and GB/s each way. 8b: TorchTrainer.fit of
     gpt2-124m (batch 8, S 1024, bf16 + fp32 master, default_optimizer,
     default_rng(0) tokens), 6 steps, a checkpoint (params and optimizer
     state, async save, keep 2) at steps 3 and 6: losses bit-equal to the
     same 6 steps through build_train directly, K1-K3 12 launches a step
     and no general kernel; a second fit resumed from step 3's checkpoint
     directory gives steps 4-6's losses bit-equal; step ms beside
     build_train's, the report's host snapshots, each save's seconds and
     GB, the restore's seconds. 8c: TorchPredictor.from_checkpoint of the
     fit's result: logits of the 8 x 1024 batch bit-equal to the model's
     forward with the restored parameters; its ms. 8d:
     LLMServer(model="llama-1b", checkpoint_path=) over save_arrays of a
     llama-1b drawn from seed 0: four requests' tokens (three greedy, one
     seeded at temperature 0.8) equal LLMServer(params=the same tree)'s;
     the checkpoint's GB, save and restore seconds (~30-90 s in all);
  9. the LLM path's telemetry and external envs. 9a
     (``telemetry_phase``): llama-1b with phase 6's engine (8 slots,
     chunk 128, page 16, decode block 16; bf16, random weights from seed
     0), telemetry on and the port's tracer enabled: 16 requests of
     128-token prompts and 128 new tokens, each with a trace context, a
     prefix hit (>= 112 tokens matched) and a session exported and
     imported. Gates, exact: the registry's token, prefix hit/miss and
     tokens-saved counters moved as the engine's counters; the TTFT,
     stage and decode-per-token histograms one observation a request; the
     page gauges the pool's counts after the drain; rt_llm_roofline_frac
     decode_profile()'s; one llm.request span a request, parented to its
     context, with the four stage children, durations equal to its timing
     within 1 us. Then decode step ms and tokens/s with telemetry on and
     off in alternating pairs (printed only). 9b (``external_phase``): DQN
     on ExternalDQNWorker, fed by a CartPole simulator thread that owns
     its loop, 3 iterations of 512 rows: learner on the card, policy on
     the CPU, finite losses, next_obs[t] == obs[t+1] within an episode,
     the simulator ends; then a PolicyServerInput served to 2 PolicyClient
     threads over HTTP on localhost (10 episodes each): every episode
     ends, the server shuts down; env-steps/s, HTTP round trips/s and the
     learner's ms an update. No attention kernel on 9b (~30-60 s for 9);
 10. the Tune library (``tune_phase``), trials as threads of this
     process on InlineRuntime, each training gpt2-124m (batch 8, S 1024,
     bf16 + fp32 master, default_optimizer(lr), default_rng(0) tokens)
     through build_train from init(0). 10a: ASHA (max_t 8, grace 2,
     reduction 2) over lr 3e-3, 1e-3, 3e-4, 1e-4, two trials at a time,
     a function trainable reporting each step's loss: every trial's
     losses bit-equal to build_train's at its lr, each stopped trial's
     thread ended before its actor is killed with at most one step
     launched past its last report, K1-K3 12 launches for each launched
     step, the best trial the lowest last loss. 10b: PBT (interval 2)
     over two trials of 6 steps, a checkpoint (params, optimizer state)
     every 2: at least one exploit, the restored state bit-equal on the
     card to the source checkpoint. 10c: Tuner(TorchTrainer) over two
     lrs, 3 steps: each trial's one result equal to TorchTrainer.fit's
     and build_train's. Prints wall s per trial, step ms in a trial
     beside build_train's, each checkpoint's snapshot s and GB, peak
     memory at two concurrent trials and the phase's launches;
 11. prints the kernels as one JSON line (each entry also with its
     launches a step on phases 5h and 5i, a rank on phase 5j's
     ring-flash and Ulysses, on phase 7c, a step of phase 8b, phases 9a
     and 9b and the Tune runs of phase 10), the card again, and last
     {"ok": true, "device": {...}}.

Between phases 5 and 6 it also trains gpt2-774m at bench.py's configuration
(batch 8, seq 1024, bf16, fp32 master, adamw_lowmem, remat_policy="mem2",
bench.py's tokens): 2 + 5 steps, step time, MFU and peak memory, and
K1-K3 launches per step counted from zero (36 each: mem2 keeps attention);
then the same under remat_policy="none", whose losses must equal mem2's
to 1e-3 and whose peak memory must be larger (~15-40 s). Then:

  - gpt2-1.5b at bench_15b's configuration (48 layers, d 1600, 25 heads,
    bf16 parameters through cast_floating, mem2, adafactor(1e-4) without
    an fp32 master, batch 4, seq 1024, tokens from default_rng(0)): 2 + 5
    steps; step ms, tokens/s, MFU against 989 TFLOP/s, peak memory,
    Adafactor's state bytes beside AdamW-bf16's 2 x 2 x N, losses (finite,
    the first within 1 of ln 50304), 48 launches of each kernel a step
    and no general kernel (~20-40 s, most of it the CPU init);
  - bench_long_context's points, gpt2-355m at (seq, batch) (4096, 4),
    (8192, 2), (16384, 1), the same recipe with max_seq = seq, 2 + 4 steps
    each: tokens/s, MFU, peak memory, 24 launches of each kernel a step
    (~15-30 s);
  - ViT-B/16 at 224 x 224 (S 197, bf16, fp32 master, default_optimizer,
    batch 64, remat): 2 + 5 steps, images/s, MFU (6N + 12·L·d·S a token
    at S = 197), peak memory, a first loss near ln 1000, K1 24 and K2, K3
    12 launches a step, no general kernel (~5-15 s);
  - resnet18-cifar (fp32, batch 128, 32 x 32, default_optimizer, the
    batch statistics carried): 2 + 5 steps, images/s, peak memory, the
    first loss near ln 10 and the fp32 settings the convs ran under
    (~5-10 s);
  - fault C3: llama-tiny (fp32, head_dim 16) loss and gradients on the
    card against the CPU (1e-5 and 1e-4): each layer launches K4, K5 and
    K6 once, with the counts set to 0 just before, and no Hopper kernel
    (~1 s).

  - the parallel layer (``ray_tpu_torch/parallel``). 5h: a world of one on
    NCCL (an in-process KV, ``Bootstrap(world_size=1)``,
    ``initialize_torch("nccl")``, ``MeshSpec(dp=1).build()``) trains
    gpt2-124m through ``build_sharded_train`` with phase 5b's weights,
    tokens and recipe, 2 + 5 steps: its 7 losses within 1e-3 of
    ``build_train``'s (bit-equality printed), K1-K3 12 a step, step ms
    beside ``build_train``'s. 5i: MoE GPT-2 at gpt2-124m's widths (8
    experts, top-2, capacity 1.25, aux weight 0.01; 520,865,280
    parameters) on the same mesh, the same recipe, 2 + 5 steps: finite
    losses, the first within 1 of ln 50304 plus the aux weight, K1-K3 12
    a step, step ms, tokens/s, MFU on the active parameters and peak
    memory; then layer 0's MoE FFN on the card against the CPU on 8,192
    tokens (fp32): every token's experts equal, output and aux within
    1e-4; then the same MoE GPT-2 under remat_policy "dots" (the JAX
    model's default), 2 + 5 steps: step ms, tokens/s and peak memory, the
    losses within 1e-3 of the run without remat, a lower peak memory, K1
    24 and K2, K3 12 a step (the backward runs attention again), no
    general kernel. 5j: four spawned ranks on the one card (gloo; each on cuda:0):
    ring-flash at [1,2,8192,64] fp32, causal (K4 r + 1 times on rank r)
    and not (4 times), and the einsum ring forward and backward, within
    1e-4 of the plain attention (fp32 autograd for the gradients; no
    attention kernel in the einsum ring); Ulysses at [1,8,4096,64] bf16
    causal, forward and backward (K1-K3 once a rank, no general kernel)
    against fp32 autograd of the plain attention on the whole tensor
    within phase 3's autograd tolerance, 2e-2 (phase 3b holds K1-K3 to
    their plain versions at the per-rank [1,2,4096,64] causal); one MoE
    layer at gpt2-124m's widths over ep = 4
    against ep = 1 on each rank's own 1,024 tokens (capacity factor 8: none
    dropped) within 1e-5 (~30 s for the three).

The llama-1b serving phase and every training phase above require that
no general kernel was launched: every bench path runs K1-K3.

``--profile`` adds torch.profiler breakdowns (device time by kernel) of
one training step to chiprun_out/chip_smoke_profile.txt, of one eager
llama-1b decode step to chiprun_out/chip_smoke_profile_llama.txt, and of
one training step of gpt2-774m under each policy to
chiprun_out/chip_smoke_profile_774m_<policy>.txt, of one step of
gpt2-1.5b, of gpt2-355m at seq 16384 and of ViT-B/16
(chip_smoke_profile_gpt2-1.5b_s1024.txt, ..._gpt2-355m_s16384.txt,
..._vit.txt), and of one replayed and one eager PPO iteration to
chiprun_out/chip_smoke_profile_ppo_<how>.txt; it also counts the kernels
and device time of one Adafactor update (with its p + u) at gpt2-1.5b and
at gpt2-355m seq 16384, and splits one MoE GPT-2 step's device time into
its one-hot einsums, expert products, attention and the rest
(chiprun_out/chip_smoke_profile_moe.txt).
"""

import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 on the CUDA cores (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 (data sheet)

# Tolerances, as the largest |kernel - reference| over the largest
# |reference| (bf16 keeps 8 bits, so one rounding is ~4e-3 relative).
TOL_VS_PLAIN = 1e-2      # kernel vs its plain version, same bf16 inputs
TOL_VS_FP32 = 2e-2       # kernel vs fp32 autograd of the plain attention
TOL_LSE = 1e-3           # absolute, fp32 lse (natural log units)
TOL_VS_PLAIN_FP32 = 1e-5  # general kernels on fp32 inputs: sum order only
TOL_NORM = 2 ** -7       # LayerNorm kernels vs plain: one bf16 rounding
# The scan's kernels vs the plain fp32 scan, relative to the largest entry:
# their products take bf16 operands (dy, the states and the decays times
# C B^T rounded once), ~2-6e-3 read at the cell's shape.
TOL_SSD = 1e-2
TOL_E2E_LOSS = 1e-2      # tiny GPT-2: kernels vs plain attention, relative
TOL_E2E_GRAD = 5e-2      # same, per-parameter gradient, relative to max
# llama-1b serving checks, as the largest |logit difference| over the
# largest |logit|. Between bf16 paths whose arithmetic differs (K1 against
# the paged cache's fp32 softmax) or a bf16 path and an fp32 run of the
# same weights, rounding compounds through 22 layers: ~2.4e-2 of sound
# reading. The two cache layouts share their arithmetic and read 0.
TOL_LLAMA = 5e-2
TOL_LAYOUT = 1e-3
# gpt2-774m: mem2 against no remat, the same steps, absolute on a loss of
# ~10.8 (the forwards are the same kernels; the backward's weight products
# are summed in another order).
TOL_REMAT_LOSS = 1e-3
# PPO. The conv policy's bf16 trunk against an fp32 evaluation of the same
# weights, relative to the largest |logit| or |value|; GAE on the card
# against a float64 loop, relative to the largest advantage; one replayed
# iteration against one eager one, relative to each parameter's largest
# entry and to each metric.
TOL_PPO_NET = 5e-2
TOL_GAE = 1e-5
TOL_GRAPH = 1e-3
# Phase 7b, the actor-based RLlib learners: one learner update on the card
# against the same update on the CPU (fp32 under full_fp32): the loss,
# relative; the parameters as the L2 norm of their difference over all
# leaves over the parameters' norm (Adam's first steps move an element by
# about lr whatever its gradient's size, so an element whose gradient is
# near zero may step either way on the two devices). PPO-AtariSim's conv
# trunk is bf16 (as the JAX package's), and its gradients are held per
# leaf as the CPU tests hold the bf16 conv policy's (conv biases, sums
# over every position of bf16 cotangents, looser).
TOL_RL_LOSS = 1e-5
TOL_RL_PARAMS = 1e-4
# A multi-step update's loss is its last minibatch's, read after every
# step before it; the recurrent net runs each through a 64-step scan. On
# the CPU alone, moving the starting parameters by 1e-7 (relative) moves
# recurrent PPO's loss after its 32 steps by 1.4e-5.
TOL_RL_LOSS_MULTI = 1e-3
TOL_RL_LOSS_BF16 = 2e-2
TOL_RL_PARAMS_BF16 = 1e-2
TOL_RL_GRAD_BF16 = 2e-2
TOL_RL_GRAD_BF16_CONV_BIAS = 1e-1
# Phase 7c: FittedQModel's fit (20 backups x 25 Adam steps, 4,088 rows) on
# the card against the CPU from the same weights, relative: its Q-values
# over their largest, its weights' L2 over theirs, its final loss (an H100
# read 3.2e-7 at most).
TOL_FQE_CARD = 1e-5
# Fault C3's phase: llama-tiny's loss at this batch and sequence length.
C3_BATCH, C3_SEQ = 2, 64
# bench.py's bench_ppo: envs, rollout length, epochs, minibatches.
PPO_SHAPE = (256, 128, 4, 8)

# How every kernel is built. K1-K3 (csrc/hopper.cuh): TMA loads under
# mbarriers feeding wgmma. K4-K6 (csrc/general.cuh): register-blocked
# outer products on the CUDA cores, fed by staggered cp.async copies.
DESIGN = "wgmma_tma"
GENERAL_DESIGN = dict.fromkeys(
    ("flash_fwd_general", "flash_bwd_dkdv_general", "flash_bwd_dq_general"),
    "regblock_cpasync")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log):
    """Registers, static shared memory and spills of each kernel
    instantiation, from ``nvcc -Xptxas -v``; keyed by type and head dim."""
    out, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            if "4norm" in name:  # rtt::norm (LayerNorm): its mangled name
                inst = name
                out[inst] = dict(registers=None, smem_static=0,
                                 spill_stores=0, spill_loads=0)
                continue
            if "3ssd" in name:  # rtt::ssd (the scan): kernel, (p, n, chunk)
                inst = ssd_instance(name)
                out[inst] = dict(registers=None, smem_static=0,
                                 spill_stores=0, spill_loads=0)
                continue
            # Hopper kernels: sm90::Bf16/Fp16 and D; general kernels:
            # float/__nv_bfloat16/__half and DL = ceil(D / 32).
            if "Bf16" in name or "bfloat16" in name:
                ty = "bf16"
            elif "Fp16" in name or "half" in name:
                ty = "fp16"
            else:
                ty = "fp32"
            d = (re.search(r"ELi(\d+)E", name)
                 or re.search(r"Li(\d+)EEEv", name))
            inst = (f"{ty}_{'dl' if 'general' in name else 'd'}"
                    f"{d.group(1) if d else '?'}")
            out[inst] = dict(registers=None, smem_static=0, spill_stores=0,
                             spill_loads=0)
            continue
        if inst is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[inst]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[inst]["smem_static"] = int(sm.group(1)) if sm else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[inst]["spill_stores"] = int(m.group(1))
            out[inst]["spill_loads"] = int(m.group(2))
    return out


def ssd_instance(mangled):
    """A scan kernel's instantiation from its mangled name, as
    ``chunk_scan_64_128_256_bwd``: the kernel, its (p, n, chunk) or (p,
    chunk), and its mode (fwd/bwd; chunk_bc's dc/db)."""
    m = re.search(r"3ssd\d+(\w+?)I(.*)EEvNS0_4Args", mangled)
    if m is None:
        return mangled
    kernel, params = m.groups()
    dims = re.findall(r"Li(\d+)E", params)
    flag = re.search(r"Lb(\d)E", params)
    mode = "" if flag is None else "_" + (
        ("dc" if flag.group(1) == "1" else "db") if kernel == "chunk_bc"
        else ("fwd" if flag.group(1) == "1" else "bwd"))
    return "_".join([kernel] + dims) + mode


def rel_err(a, ref):
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().max() / ref.abs().max().clamp_min(1e-12)).item()


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(torch, fn, warmup=3, reps=20):
    """Device time of one call of ``fn`` in ms: the durations of the
    kernels and copies it puts on the card (torch.profiler), summed over
    ``reps`` calls and averaged. Host time between launches is left out:
    CUDA events around each call would time the host wherever it is slower
    than the kernels. A window in which the profiler records no device
    activity at all (seen once in dozens of windows a run) is profiled
    again, up to three windows; then it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
        print("time_ms: torch.profiler recorded no device activity; again")
    require(False, "torch.profiler saw no device activity to time")


def causal_pairs(sq, sk, causal):
    """(query, key) pairs the mask keeps, absolute positions q >= k."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.models.common import param_count
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import norm
    from ray_tpu_torch.train.optim import (adamw_lowmem,
                                           warmup_cosine_decay_schedule)
    from ray_tpu_torch.train.step import build_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. the card --------------------------------------------------------
    card = smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s wall; per source "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()))
    ptxas = {name: ptxas_report(log)
             for name, log in _build.build_logs.items()}
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"nvcc {name}: {line.strip()[:160]}")
        for inst, r in ptxas[name].items():
            print(f"ptxas {name} {inst}: {r['registers']} registers, "
                  f"{r['smem_static']} bytes static smem (+ dynamic "
                  f"tiles), spill stores {r['spill_stores']} loads "
                  f"{r['spill_loads']}")

    # -- 3. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    B, H, S, D = 8, 12, 1024, 64  # gpt2-124m at batch 8, seq 1024
    scale = D ** -0.5
    # (b, h, sq, sk, d, causal, dtype): the GPT-2 shape first, then fp16,
    # non-causal ragged, causal Sq < Sk and Sq > Sk, D 128, a row length
    # of one tile plus one, and an Sq whose lse rows need padding for TMA.
    bf, fp = torch.bfloat16, torch.float16
    errs = check_kernels(torch, A, [(B, H, S, S, D, True, bf)], gen)
    check_kernels(torch, A, [
        (2, 4, 1024, 1024, 64, True, fp), (2, 4, 1000, 1000, 64, False, bf),
        (2, 4, 384, 1024, 64, True, bf), (2, 4, 1024, 384, 64, True, bf),
        (2, 4, 512, 512, 128, True, bf), (2, 4, 333, 200, 128, False, fp),
        (1, 2, 129, 129, 64, True, bf)], gen)

    for (b, h, sq, d) in [(B, H, S, D), (2, 4, 1000, 64), (2, 4, 512, 128)]:
        xs = [rand(b, h, sq, d).requires_grad_() for _ in range(3)]
        g_o = rand(b, h, sq, d)
        A.flash_attention(*xs, causal=True).backward(g_o)
        refs = [x.detach().float().requires_grad_() for x in xs]
        A.mha_reference(*refs, causal=True).backward(g_o.float())
        torch.cuda.synchronize()
        for name, x, r in zip(("dq", "dk", "dv"), xs, refs):
            e = rel_err(x.grad, r.grad)
            print(f"check autograd {name} [{b},{h},{sq},{d}] vs fp32 plain "
                  f"autograd: rel {e:.3e} (tol {TOL_VS_FP32})")
            require(e < TOL_VS_FP32, f"autograd {name}")
    q, k, v, do = (rand(B, H, S, D) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    print(f"phase 3 (kernel checks at the GPT-2 shapes): "
          f"{time.perf_counter() - t0:.3f} s wall")

    # -- 3b. every training path's own shape: gpt2-774m, gpt2-1.5b, the
    # long-context points (Sk > 2048 is where the reference runs
    # _flash_fwd_kernel) and ViT-B/16 -------------------------------------
    t0 = time.perf_counter()
    path_errs = check_kernels(torch, A, [
        (8, 20, 1024, 1024, 64, True, bf), (4, 25, 1024, 1024, 64, True, bf)],
        gen)
    long_errs = check_kernels(torch, A, [
        (4, 16, 4096, 4096, 64, True, bf), (2, 16, 8192, 8192, 64, True, bf),
        (1, 16, 16384, 16384, 64, True, bf),
        (1, 2, 4096, 4096, 64, False, bf)], gen)
    vit_errs = check_kernels(torch, A, [(64, 12, 197, 197, 64, False, bf)],
                             gen)
    # Ulysses' shape on each of phase 5j's ranks: [1, 8/4 heads, 4096, 64].
    check_kernels(torch, A, [(1, 2, 4096, 4096, 64, True, bf)], gen)
    print(f"phase 3b (the training paths' shapes): "
          f"{time.perf_counter() - t0:.3f} s wall")

    # -- 3c. the general kernels: llama-tiny's shape first, then fp32 at D
    # 64, 128 and 256, bf16 at D 32, fp16 at D 80, D 1, and K4's timed
    # shapes: fp32 GPT-2, bench_ring_parity's [1,2,8192,64] fp32 and
    # [4,16,1024,80] fp16 --------------------------------------------------
    t0 = time.perf_counter()
    f32 = torch.float32
    tiny_llama = llama.CONFIGS["llama-tiny"]
    c3_shape = (C3_BATCH, tiny_llama.num_heads, C3_SEQ, tiny_llama.head_dim)
    general_errs = check_kernels(torch, A, [
        c3_shape[:3] + (C3_SEQ, tiny_llama.head_dim, True, tiny_llama.dtype),
        (2, 4, 200, 130, 64, True, f32),
        (2, 4, 130, 200, 128, False, f32), (2, 4, 100, 100, 32, False, bf),
        (2, 4, 70, 150, 80, True, fp), (1, 2, 48, 48, 256, True, f32),
        (1, 2, 33, 33, 1, True, f32), (8, 12, 1024, 1024, 64, True, f32),
        (1, 2, 8192, 8192, 64, True, f32), (4, 16, 1024, 1024, 80, True, fp)],
        gen, general=True)
    print(f"phase 3c (general kernels): {time.perf_counter() - t0:.3f} s "
          "wall")
    granite = granite_phase(torch, A, gen)

    # -- 4. timings at the GPT-2 shape --------------------------------------
    t_timing = time.perf_counter()
    # The card's clocks ramp up under load: without this the first kernel
    # timed reads up to half again slower than the rest.
    warm = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t_warm = time.perf_counter() + 1.0
    while time.perf_counter() < t_warm:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    pairs = B * H * causal_pairs(S, S, True)
    elem = B * H * S * D * 2  # bytes of one [B,H,S,D] bf16 tensor
    stat = B * H * S * 4      # bytes of one fp32 [B,H,S] (lse, delta)
    rows = {
        "flash_fwd": dict(
            fn=lambda: A.flash_fwd(q, k, v, True, scale),
            plain=lambda: A.mha_reference_with_lse(q, k, v, True, scale),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            flops=4 * D * pairs, nbytes=4 * elem + stat,
            source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
            replaces="ray_tpu/ops/attention.py:175 "
                     "(_flash_fwd_single_pass_kernel) and :95 "
                     "(_flash_fwd_kernel), via _flash_fwd_pallas:216"),
        "flash_bwd_dkdv": dict(
            fn=lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, True, scale),
            plain=lambda: A.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                     True, scale),
            library=None, flops=8 * D * pairs, nbytes=6 * elem + 2 * stat,
            source="ray_tpu_torch/ops/csrc/flash_bwd_dkdv.cu",
            replaces="ray_tpu/ops/attention.py:272 "
                     "(_flash_bwd_fused_kernel, dk/dv), via "
                     "_flash_bwd_pallas:347"),
        "flash_bwd_dq": dict(
            fn=lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
            plain=lambda: A.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                   True, scale),
            library=None, flops=6 * D * pairs, nbytes=5 * elem + 2 * stat,
            source="ray_tpu_torch/ops/csrc/flash_bwd_dq.cu",
            replaces="ray_tpu/ops/attention.py:272 "
                     "(_flash_bwd_fused_kernel, dq), via "
                     "_flash_bwd_pallas:347"),
    }
    timing = {}
    for name, r in rows.items():
        ms = time_ms(torch, r["fn"])
        plain_ms = time_ms(torch, r["plain"], warmup=1, reps=5)
        lib_ms = (time_ms(torch, r["library"]) if r["library"] else None)
        b_ms, b_by = bound(r["flops"], r["nbytes"])
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by)
        print(f"time {name} [{B},{H},{S},{D}] causal: {ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
              f"({r['flops'] / 1e9:.3f} GFLOP, {r['nbytes'] / 1e6:.3f} MB); "
              f"{r['flops'] / ms / 1e9:.1f} TFLOP/s; library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    # Yardstick for the backward pair: SDPA's backward (dq, dk, dv).
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, is_causal=True)
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, xs, do, retain_graph=True))
    pair_bound, pair_by = bound(10 * D * pairs, 7 * elem + 2 * stat)
    pair_ms = timing["flash_bwd_dkdv"]["ms"] + timing["flash_bwd_dq"]["ms"]
    print(f"time K2+K3 {pair_ms:.4f} ms; "
          f"bound of the backward (5 products) {pair_bound:.4f} ms by "
          f"{pair_by}; SDPA backward (dq, dk, dv) {sdpa_bwd:.4f} ms")
    fwd = timing["flash_fwd"]
    print(f"ratio K1 / SDPA forward {fwd['ms'] / fwd['library_ms']:.3f}"
          f"; K2 / SDPA backward "
          f"{timing['flash_bwd_dkdv']['ms'] / sdpa_bwd:.3f}; K2+K3 / SDPA "
          f"backward {pair_ms / sdpa_bwd:.3f}")
    del out, xs
    long_s = long_s_timings(torch, A, gen)
    general_time = general_timings(torch, A, gen, c3_shape)
    general_time_gpt2 = general_timings(torch, A, gen, (8, 12, 1024, 64))
    general_time_at = {
        "[1,2,8192,64] fp32": general_timings(
            torch, A, gen, (1, 2, 8192, 64), names=("flash_fwd_general",)),
        "[4,16,1024,80] fp16": general_timings(
            torch, A, gen, (4, 16, 1024, 80), torch.float16)}
    print(f"phase 4 (timings): {time.perf_counter() - t_timing:.3f} s wall")

    # -- 4b. the LayerNorm kernels at the benchmark cells' shapes ------------
    t0 = time.perf_counter()
    norm_time = norm_phase(torch, gen)
    print(f"phase 4b (LayerNorm): {time.perf_counter() - t0:.3f} s wall")

    # -- 4c. the scan's kernels at the Granite cell's shape --------------------
    t0 = time.perf_counter()
    ssd_time = ssd_phase(torch, gen, ptxas)
    print(f"phase 4c (scan): {time.perf_counter() - t0:.3f} s wall")

    # -- 5a. tiny GPT-2 step: kernels against the plain attention ------------
    tiny = dict(vocab_size=512, max_seq=128, num_layers=2, num_heads=2,
                d_model=128)
    models = {}
    for impl in ("flash", "reference"):
        cfg = gpt2.GPT2Config(**tiny, attention_impl=impl)
        m = gpt2.GPT2(cfg, torch.Generator().manual_seed(1)).to(dev)
        m.to(torch.bfloat16)
        models[impl] = m
    tok = torch.randint(0, 512, (4, 129), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    losses = {}
    for impl, m in models.items():
        loss = m.loss_fn({"tokens": tok})
        loss.backward()
        losses[impl] = loss.item()
    e_loss = abs(losses["flash"] - losses["reference"]) / abs(
        losses["reference"])
    e_grad = max(rel_err(pf.grad, pr.grad) for pf, pr in zip(
        models["flash"].parameters(), models["reference"].parameters()))
    print(f"check tiny GPT-2 (bf16, d128, 2 layers, S128): loss kernels "
          f"{losses['flash']:.6f} plain {losses['reference']:.6f} rel "
          f"{e_loss:.3e} (tol {TOL_E2E_LOSS}); worst grad rel {e_grad:.3e} "
          f"(tol {TOL_E2E_GRAD})")
    require(e_loss < TOL_E2E_LOSS and e_grad < TOL_E2E_GRAD, "tiny GPT-2")
    del models

    # -- 5b. the main path: gpt2-124m training --------------------------------
    t_phase = time.perf_counter()
    cfg = gpt2_124m_config(gpt2, torch)
    batch, seq, warm, steps = 8, 1024, 2, 5
    sched = warmup_cosine_decay_schedule(0.0, 1e-4, 100, 1000,
                                         end_value=1e-5)
    init, step_fn = build_train(lambda g: gpt2.GPT2(cfg, g),
                                lambda m, b: m.loss_fn(b),
                                optimizer=adamw_lowmem(sched),
                                master_fp32=True)
    model, opt_state, step = init(0)
    print(f"gpt2-124m: {param_count(model)} parameters, batch {batch}, "
          f"seq {seq}, bf16 + fp32 master, adamw_lowmem")
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, seq + 1), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    data = {"tokens": tokens}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    A.reset_launch_counts()
    norm.reset_counts()
    (model, opt_state, step), losses, norms, elapsed = run_steps(
        torch, step_fn, (model, opt_state, step), data, warm, steps)
    launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS}
    general = general_launches(A)
    norm_124m = layer_norm_calls("gpt2-124m", warm + steps, cfg.num_layers)
    print(f"losses {losses}")
    print(f"grad norms {norms}")
    require(all(math.isfinite(x) for x in losses + norms), "finite losses")
    require(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
            f"first loss {losses[0]} near ln(vocab) = "
            f"{math.log(cfg.vocab_size):.3f} at random init")
    n = warm + steps
    expect = n * cfg.num_layers
    print(f"launches over {n} steps: {launches} (expect {expect} each: "
          f"one per layer per step); general kernels {general}")
    require(all(v == expect for v in launches.values()), "launch counts")
    require(general == 0, "gpt2-124m: no general kernel")

    step_ms = elapsed / steps * 1e3
    tok_s = batch * seq * steps / elapsed
    mfu = tok_s * gpt2.flops_per_token(cfg, seq) / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"gpt2-124m train: step {step_ms:.3f} ms, {tok_s:.1f} tokens/s, "
          f"MFU {100 * mfu:.3f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, "
          f"peak memory {peak_gb:.3f} GB")
    ref_124m = dict(losses=losses, step_ms=step_ms, batch=batch, seq=seq,
                    data=data)

    if "--profile" in argv:
        profile_step(torch, step_fn, model, opt_state, step, data, root)
    del model, opt_state, data
    torch.cuda.empty_cache()
    print(f"gpt2-124m phase: {time.perf_counter() - t_phase:.3f} s wall")
    prof = root if "--profile" in argv else None

    # -- 5c. gpt2-774m at bench.py's configuration ----------------------------
    launches_774m, train_774m = gpt2_774m_phase(torch, A, profile_root=prof)

    # -- 5d. gpt2-1.5b at bench_15b's configuration ---------------------------
    train_15b = adafactor_gpt2(torch, A, "gpt2-1.5b", 1024, 4, 2, 5,
                               profile_root=prof)

    # -- 5e. bench_long_context's three points --------------------------------
    long_ctx = {}
    for seq, batch in ((4096, 4), (8192, 2), (16384, 1)):
        long_ctx[seq] = adafactor_gpt2(
            torch, A, "gpt2-355m", seq, batch, 2, 4,
            profile_root=prof if seq == 16384 else None)

    # -- 5f. ViT-B/16 and ResNet-18 -------------------------------------------
    train_vit = vit_phase(torch, A, profile_root=prof)
    train_resnet = resnet_phase(torch)

    # -- 5g. fault C3: an fp32, head_dim-16 model on the card -----------------
    c3_launches = c3_phase(torch, A, dev)

    # -- 5h-5j. the parallel layer: a mesh of one (gpt2-124m, MoE GPT-2),
    # then four ranks on the card ---------------------------------------------
    par = mesh_phases(torch, A, sched, ref_124m["data"], ref_124m,
                      profile_root=prof)
    del ref_124m["data"]
    sp4 = sp4_phase(torch)
    moe = par["moe"]
    print(f"parallel layer on {card}: gpt2-124m through build_sharded_train "
          f"(mesh of one) step {par['sharded']['step_ms']:.3f} ms against "
          f"build_train's {ref_124m['step_ms']:.3f} ms; moe gpt2 step "
          f"{moe['step_ms']:.3f} ms, {moe['tokens_s']:.1f} tokens/s, MFU "
          f"{moe['mfu_pct']:.3f}% (active parameters), peak memory "
          f"{moe['peak_gb']:.3f} GB; four ranks: ring-flash worst "
          f"{max(r['ring_flash_causal']['max_abs_err'] for r in sp4):.3e}"
          f", einsum ring worst "
          f"{max(r['ring_einsum']['max_abs_err'] for r in sp4):.3e}, "
          f"Ulysses worst "
          f"{max(r['ulysses']['max_abs_err'] for r in sp4):.3e}"
          f", MoE ep=4 worst "
          f"{max(r['moe_ep']['max_abs_err'] for r in sp4):.3e}")

    # -- 6. llama-1b serving --------------------------------------------------
    llama_k1, tp2_ref = serve_phase(
        torch, A, dev, profile_root=root if "--profile" in argv else None)

    # -- 6b. llama-1b tp-sharded: two ranks on the card -----------------------
    tp2_phase(torch, tp2_ref)

    # -- 7. on-device PPO ---------------------------------------------------
    ppo = ppo_phase(torch, A, dev,
                    profile_root=root if "--profile" in argv else None)
    # -- 7b. the actor-based RLlib algorithms, learner on the card ---------
    rl = rllib_phase(torch, A, dev, root)
    # -- 7c. SAC, TD3, CQL, MARWIL/BC, DM/DR, Ape-X, ES/ARS -----------------
    rl7c = offpolicy_phase(torch, A, dev, root)
    # -- 8. the Train library: tensors on the object plane, TorchTrainer,
    # TorchPredictor, LLMServer(checkpoint_path=) ------------------------------
    tl = train_library_phase(torch, A, dev, root)
    # -- 9. the LLM path's telemetry; external envs feeding a learner on the
    # card ----------------------------------------------------------------
    tele = telemetry_phase(torch, A, dev)
    ext = external_phase(torch, A, dev)
    # -- 10. the Tune library: ASHA, PBT and Tuner(TorchTrainer) sweeping
    # gpt2-124m, trials as threads of this process -------------------------
    tn = tune_phase(torch, A, dev, root)
    print(f"north-star paths on {card}: gpt2-774m/mem2 step "
          f"{train_774m['step_ms']:.3f} ms, MFU {train_774m['mfu_pct']:.3f}%, "
          f"peak memory {train_774m['peak_gb']:.3f} GB; gpt2-1.5b (bench_15b)"
          f" step {train_15b['step_ms']:.3f} ms, MFU "
          f"{train_15b['mfu_pct']:.3f}%, peak memory "
          f"{train_15b['peak_gb']:.3f} GB; ppo-atari-256 "
          f"{ppo['env_steps_s']:.1f} env-steps/s, an iteration "
          f"{ppo['iteration_ms']:.4f} ms on CUDA events; PPO-AtariSim "
          f"(actor-based, CPU rollout) {rl['env_steps_s']:.1f} env-steps/s, "
          f"rollout {rl['rollout_ms']:.1f} ms and learner "
          f"{rl['learner_ms']:.1f} ms an iteration; external DQN "
          f"{ext['env_steps_s']:.1f} env-steps/s, learner "
          f"{ext['learner_ms']:.3f} ms an update, policy server "
          f"{ext['round_trips_s']:.1f} HTTP round trips/s; llama-1b decode "
          f"step with telemetry on/off "
          + ", ".join(f"{p['on']['step_ms']}/{p['off']['step_ms']}"
                      for p in tele["pairs"]) + " ms")
    print("other training paths on " + card + ": " + "; ".join(
        f"gpt2-355m seq {seq}: {r['tokens_s']:.1f} tokens/s, MFU "
        f"{r['mfu_pct']:.3f}%, peak memory {r['peak_gb']:.3f} GB"
        for seq, r in long_ctx.items())
        + f"; vit-b16: {train_vit['images_s']:.1f} images/s, MFU "
        f"{train_vit['mfu_pct']:.3f}%; resnet18-cifar: "
        f"{train_resnet['images_s']:.1f} images/s")
    print("RLlib's other algorithms on " + card + ": " + "; ".join(
        f"{name} {r['wall_s']:.3f} s"
        + (f", {r['env_steps_s']:.1f} env-steps/s" if "env_steps_s" in r
           else "")
        + (f", {r['update_ms']:.3f} ms an update" if r.get("update_ms")
           else "")
        for name, r in rl7c.items() if "wall_s" in r))

    # -- 11. the record -------------------------------------------------------
    kernels = []
    for name, r in rows.items():
        kernels.append(dict(name=name, route="cuda", source=r["source"],
                            replaces=r["replaces"],
                            launches=launches[name],
                            max_abs_err=errs[name], **timing[name],
                            design=DESIGN, ptxas=ptxas[name]))
    # K1 on the llama-1b check (forward at [1, 32, 128, 64]), apart from
    # the GPT-2 training step's launches.
    kernels[0]["launches_llama"] = llama_k1
    # Per step of gpt2-774m, by remat policy, and of this slice's paths.
    for k in kernels:
        name = k["name"]
        k["launches_gpt2_774m_per_step"] = {
            policy: n[name] for policy, n in launches_774m.items()}
        k["launches_gpt2_1.5b_per_step"] = train_15b["launches"][name]
        k["launches_long_context_per_step"] = {
            seq: r["launches"][name] for seq, r in long_ctx.items()}
        k["launches_vit_b16_per_step"] = train_vit["launches"][name]
        k["launches_granite_per_step"] = granite["launches"][name]
        k["rel_err_granite_shape"] = granite["errs"][name]
        # At bench_long_context's longest point, and the largest errors of
        # the long-S (S 4096-16384) and ViT-shape checks.
        k["long_s"] = dict(long_s[name], max_abs_err=long_errs[name],
                           max_abs_err_vit_shape=vit_errs[name])
        k["max_abs_err_gpt2_774m_1.5b_shapes"] = path_errs[name]
    # K4-K6: their path is fault C3's phase (llama-tiny fp32 on the card),
    # timed at its shape and, for scale, at GPT-2 124M's shape in fp32 and
    # at fp16 D 80; K4 also at bench_ring_parity's fp32 shape.
    for name, rep_ in (("flash_fwd_general", rows["flash_fwd"]),
                       ("flash_bwd_dkdv_general", rows["flash_bwd_dkdv"]),
                       ("flash_bwd_dq_general", rows["flash_bwd_dq"])):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"ray_tpu_torch/ops/csrc/{name}.cu",
            replaces=rep_["replaces"] + ", for fp32 and head dims other "
                                        "than 64 and 128",
            launches=c3_launches[name], max_abs_err=general_errs[name],
            **general_time[name], design=GENERAL_DESIGN[name],
            ptxas=ptxas[name], shape=list(c3_shape),
            at_gpt2_124m_fp32=general_time_gpt2[name],
            at={s: t[name] for s, t in general_time_at.items() if name in t}))
    kernels[-1]["backward_pair_at_gpt2_124m_fp32"] = (
        general_time_gpt2["backward_pair"])
    # The parallel layer's paths: per step on the mesh of one, per rank at
    # sp = 4 (ring-flash causal; Ulysses forward and backward).
    for k in kernels:
        name = k["name"]
        k["launches_sharded_gpt2_124m"] = par["sharded"][
            "launches_per_step"].get(name, 0)
        k["launches_moe_gpt2_per_step"] = par["moe"][
            "launches_per_step"].get(name, 0)
        k["launches_moe_gpt2_dots_per_step"] = par["moe_dots"][
            "launches_per_step"].get(name, 0)
        k["launches_ring_sp4"] = [
            r["ring_flash_causal"]["launches"]
            if name == "flash_fwd_general" else 0 for r in sp4]
        k["launches_ulysses_sp4"] = [r["ulysses"]["launches"].get(name, 0)
                                     for r in sp4]
        k["launches_rllib_7c"] = rl7c["launches"][name]
        k["launches_train_8b_per_step"] = tl["launches_per_step"][name]
        k["launches_telemetry_9a"] = tele["launches"][name]
        k["launches_external_9b"] = ext["launches"][name]
        k["launches_tune_10"] = tn["launches"][name]
    # LayerNorm: the launches a step as the training phases counted them;
    # gpt2-1.5b (5d) and gpt2-355m at S 16384 (5e) have the benchmark
    # cells' layers and remat policy, so their counts are the cells'.
    ln = dict(name="layer_norm", route="cuda",
              source="ray_tpu_torch/ops/csrc/layer_norm.cu",
              replaces="none: XLA fuses ray_tpu/models/common.py layer_norm",
              ptxas=ptxas["layer_norm"], at=norm_time,
              launches_gpt2_124m_per_step=norm_124m)
    ln["launches_gpt2_774m_per_step"] = {
        policy: n["layer_norm"] for policy, n in launches_774m.items()}
    ln["launches_gpt2_1.5b_per_step"] = train_15b["layer_norm_calls"]
    ln["launches_long_context_per_step"] = {
        seq: r["layer_norm_calls"] for seq, r in long_ctx.items()}
    ln["launches_vit_b16_per_step"] = train_vit["layer_norm_calls"]
    ln["launches_mesh_of_one_per_step"] = {
        name: r["layer_norm_calls"] for name, r in par.items()}
    kernels.append(ln)
    kernels.append(dict(
        name="ssd", route="cuda",
        source="ray_tpu_torch/ops/csrc/ssd_{state,scan,grad}.cu",
        replaces="none: the JAX package has no Mamba layer",
        ptxas={lib: ptxas[lib] for lib in ("ssd_state", "ssd_scan",
                                           "ssd_grad")},
        at=ssd_time, launches_granite_per_step=granite["ssd_launches"]))
    for cell, calls in (
            ("gpt2-1.5b.s1024-b16", train_15b["layer_norm_calls"]),
            ("gpt2-355m.s16384-b4", long_ctx[16384]["layer_norm_calls"])):
        at = norm_time[cell]
        ms, plain = (sum(calls[way] * at[way][key]
                         for way in ("forward", "backward"))
                     for key in ("ms", "plain_ms"))
        print(f"layer_norm a step of {cell} at its shape: "
              f"{calls['forward']} forward and {calls['backward']} backward "
              f"launches (counted): kernel {ms:.2f} ms, plain {plain:.2f} ms")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def gpt2_774m_phase(torch, A, profile_root=None):
    """gpt2-774m at bench.py's configuration under remat_policy "mem2",
    then "none" if it fits. Returns K1-K3 launches per step by policy, and
    mem2's step ms, MFU (%) and peak memory (GB). With ``profile_root``,
    also writes a device-time breakdown of one step under each policy."""
    import numpy as np

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.common import param_count
    from ray_tpu_torch.ops import norm
    from ray_tpu_torch.train.optim import (adamw_lowmem,
                                           warmup_cosine_decay_schedule)
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    base = gpt2.CONFIGS["gpt2-774m"]
    batch, seq, warm, steps = 8, 1024, 2, 5
    # bench.py's tokens: numpy's default_rng(0), [batch, seq + 1].
    tokens = np.random.default_rng(0).integers(0, base.vocab_size,
                                               (batch, seq + 1))
    data = {"tokens": torch.from_numpy(tokens).cuda()}
    launches, losses, peaks, results = {}, {}, {}, {}
    for policy in ("mem2", "none"):
        cfg = gpt2.GPT2Config(vocab_size=base.vocab_size, max_seq=seq,
                              num_layers=base.num_layers,
                              num_heads=base.num_heads, d_model=base.d_model,
                              dtype=torch.bfloat16, attention_impl="flash",
                              remat_policy=policy)
        sched = warmup_cosine_decay_schedule(0.0, 1e-4, 100, 1000,
                                             end_value=1e-5)
        init, step_fn = build_train(lambda g: gpt2.GPT2(cfg, g),
                                    lambda m, b: m.loss_fn(b),
                                    optimizer=adamw_lowmem(sched),
                                    master_fp32=True)
        t0 = time.perf_counter()
        try:
            model, opt_state, step = init(0)
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            norm.reset_counts()
            (model, opt_state, step), losses[policy], _, elapsed = run_steps(
                torch, step_fn, (model, opt_state, step), data, warm, steps)
        except torch.cuda.OutOfMemoryError:
            require(policy != "mem2", "gpt2-774m under mem2 fits the card")
            print(f"gpt2-774m remat {policy}: out of memory; not run")
            model = opt_state = None
            torch.cuda.empty_cache()
            break
        n = warm + steps
        launches[policy] = {f.__name__: f.launches / n
                            for f in A.KERNEL_WRAPPERS}
        launches[policy]["layer_norm"] = layer_norm_calls(
            f"gpt2-774m remat {policy}", n, cfg.num_layers,
            recompute=policy == "mem2")
        require(general_launches(A) == 0,
                f"gpt2-774m {policy}: no general kernel")
        peaks[policy] = torch.cuda.max_memory_allocated() / 1e9
        step_ms = elapsed / steps * 1e3
        tok_s = batch * seq * steps / elapsed
        mfu = tok_s * gpt2.flops_per_token(cfg, seq) / PEAK_BF16_FLOPS
        results[policy] = dict(step_ms=step_ms, mfu_pct=100 * mfu,
                               peak_gb=peaks[policy])
        print(f"gpt2-774m remat {policy}: {param_count(model)} parameters, "
              f"batch {batch}, seq {seq}, bf16 + fp32 master, adamw_lowmem; "
              f"init {t_init:.3f} s")
        print(f"gpt2-774m remat {policy} losses {losses[policy]}")
        print(f"gpt2-774m remat {policy} train: step {step_ms:.3f} ms, "
              f"{tok_s:.1f} tokens/s, MFU {100 * mfu:.3f}% of "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, peak memory "
              f"{peaks[policy]:.3f} GB; launches per step {launches[policy]}"
              f" (expect {cfg.num_layers} each)")
        require(all(math.isfinite(x) for x in losses[policy]),
                f"gpt2-774m {policy}: finite losses")
        require(abs(losses[policy][0] - math.log(cfg.vocab_size)) < 1.0,
                f"gpt2-774m {policy}: first loss {losses[policy][0]} near "
                f"ln(vocab) = {math.log(cfg.vocab_size):.3f}")
        require(all(launches[policy][f.__name__] == cfg.num_layers
                    for f in A.KERNEL_WRAPPERS),
                f"gpt2-774m {policy}: one launch of each kernel per layer "
                "per step")
        if profile_root is not None:
            profile_step(torch, step_fn, model, opt_state, step, data,
                         profile_root, f"chip_smoke_profile_774m_{policy}.txt")
        del model, opt_state, step_fn, init
        torch.cuda.empty_cache()
    if "none" in losses:
        e = max(abs(a - b) for a, b in zip(losses["mem2"], losses["none"]))
        print(f"gpt2-774m mem2 vs none: largest loss difference {e:.3e} "
              f"(tol {TOL_REMAT_LOSS}); peak memory {peaks['mem2']:.3f} vs "
              f"{peaks['none']:.3f} GB")
        require(e < TOL_REMAT_LOSS, "gpt2-774m mem2 losses equal none's")
        require(peaks["mem2"] < peaks["none"],
                "mem2 keeps less than no remat")
    print(f"gpt2-774m phase: {time.perf_counter() - t_phase:.3f} s wall")
    return launches, results["mem2"]


def conv_policy_reference(torch, params, obs):
    """fp32 forward of the conv policy in the JAX package's layout, apart
    from the port's: NHWC frames cut into [B, Ho, Wo, C, k, k] patches,
    HWIO weights, the (h, w, c) flatten of the conv output."""
    from ray_tpu_torch.rllib.policy import _CONV_SPEC

    x = obs.float() / 255.0
    for i, (_cout, k, stride) in enumerate(_CONV_SPEC):
        w = params[f"conv{i}_w"].float().permute(2, 3, 1, 0)  # HWIO
        patches = x.unfold(1, k, stride).unfold(2, k, stride)
        x = torch.relu(torch.einsum("bhwcij,ijco->bhwo", patches, w)
                       + params[f"conv{i}_b"].float())
    x = torch.relu(x.reshape(x.shape[0], -1) @ params["dense_w"]
                   + params["dense_b"])
    return x @ params["pi_w"] + params["pi_b"], (
        x @ params["vf_w"] + params["vf_b"])[..., 0]


def chw_flatten_forward(torch, params, obs):
    """The planted layout fault: the port's conv policy with its conv
    output flattened in (c, h, w) order (the frames' channels unpadded)."""
    import torch.nn.functional as F

    from ray_tpu_torch.rllib.policy import _CONV_SPEC

    x = (obs.float() / 255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    for i, (_cout, _k, stride) in enumerate(_CONV_SPEC):
        x = F.conv2d(x, params[f"conv{i}_w"].to(x.dtype), stride=stride)
        x = torch.relu(x + params[f"conv{i}_b"].to(x.dtype)[:, None, None])
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["dense_w"].to(x.dtype)
                   + params["dense_b"].to(x.dtype)).float()
    return x @ params["pi_w"] + params["pi_b"], (
        x @ params["vf_w"] + params["vf_b"])[..., 0]


def ppo_phase(torch, A, dev, profile_root=None):
    """Phase 7: on-device PPO at bench_ppo's shape, then CartPole. Returns
    env-steps/s and one replayed iteration's ms."""
    from ray_tpu_torch import random as trandom
    from ray_tpu_torch.rllib import ondevice, policy
    from ray_tpu_torch.rllib.sample_batch import ACTIONS

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    N, T, E, M = PPO_SHAPE

    # -- threefry on the card against the CPU --------------------------------
    def draws(d):
        key = trandom.prng_key(1234, d)
        keys = trandom.split(key, T)
        return {"split": torch.stack(keys, -1),
                "uniform": trandom.uniform(keys, (N, 2), 20.0, 60.0),
                "choice": trandom.choice(
                    key, torch.tensor([-2.0, -1.0, 1.0, 2.0], device=d),
                    (N, 2)),
                "permutation": trandom.permutation(
                    trandom.split(key, E), T * N),
                "gumbel": trandom.gumbel(keys, (N, 6))}

    on_card, on_cpu = draws(dev), draws(cpu)
    torch.cuda.synchronize()
    for name, ref in on_cpu.items():
        same = torch.equal(on_card[name].cpu(), ref)
        print(f"check threefry {name} {list(ref.shape)} card vs CPU: "
              f"bit-equal {same}")
        require(same, f"threefry {name} on the card")

    # -- env steps on the card against the CPU --------------------------------
    envs = {"card": ondevice.atari_sim(N, dev), "cpu": ondevice.atari_sim(N, cpu)}
    key = trandom.prng_key(99)
    states = {}
    for name, env in envs.items():
        state, _ = env.reset(tuple(w.to(env.device) for w in key))
        state["t"][: N // 4] = 998  # a quarter of the envs restart
        states[name] = state
    acts = torch.randint(0, 6, (3, N), generator=torch.Generator().manual_seed(5))
    for i in range(3):
        key = trandom.take(trandom.split(key), 1)
        outs = {}
        for name, env in envs.items():
            d = env.device
            state, *outs[name] = env.step(states[name], acts[i].to(d),
                                          tuple(w.to(d) for w in key))
            states[name] = state
        same = all(torch.equal(a.cpu(), b) for a, b in zip(outs["card"],
                                                            outs["cpu"]))
        same &= all(torch.equal(states["card"][k].cpu(), v)
                    for k, v in states["cpu"].items())
        print(f"check atari_sim({N}) step {i} card vs CPU (frames, rewards, "
              f"dones, state): bit-equal {same}; dones "
              f"{int(outs['cpu'][2].sum())}")
        require(same, f"atari_sim step {i} on the card")
    frames = states["card"]["frames"]
    del envs, states, on_card, on_cpu

    # -- the learner at bench_ppo's shape ------------------------------------
    algo = ondevice.OnDevicePPO(ondevice.atari_sim(N), rollout_length=T,
                                minibatches=M, num_sgd_iter=E)
    n_params = sum(p.numel() for p in algo.params.values())
    print(f"ppo: OnDevicePPO(atari_sim({N}), rollout_length={T}, "
          f"minibatches={M}, num_sgd_iter={E}), {algo.net.kind} policy, "
          f"{n_params} parameters")
    with torch.no_grad():
        ref = conv_policy_reference(torch, algo.params, frames)
        got = policy.forward_conv(algo.params, frames)
        bad = chw_flatten_forward(torch, algo.params, frames)
    for i, name in enumerate(("logits", "values")):
        e, e_bad = rel_err(got[i], ref[i]), rel_err(bad[i], ref[i])
        print(f"check ppo conv policy {name} (bf16 trunk) vs fp32 JAX-layout "
              f"evaluation on {N} frames: rel {e:.3e} (tol {TOL_PPO_NET}); "
              f"control with a (c, h, w) flatten: rel {e_bad:.3e} (must "
              "exceed the tol)")
        require(e < TOL_PPO_NET, f"ppo conv policy {name}")
        require(e_bad > TOL_PPO_NET, f"the policy gate sees the layout fault "
                f"({name})")
    g = torch.Generator(device=dev).manual_seed(6)
    rewards = torch.randn((T, N), generator=g, device=dev)
    dones = torch.rand((T, N), generator=g, device=dev) < 0.05
    values = torch.randn((T, N), generator=g, device=dev) * 5
    last = torch.randn((N,), generator=g, device=dev)
    advs, _ = ondevice.gae(rewards, dones, values, last, 0.99, 0.95)
    no_mask, _ = ondevice.gae(rewards, torch.zeros_like(dones), values, last,
                              0.99, 0.95)
    r64, d64, v64 = (t.double().cpu() for t in (rewards, dones, values))
    nxt = torch.cat([v64[1:], last.double().cpu()[None]])
    want, adv = torch.zeros_like(r64), torch.zeros(N, dtype=torch.float64)
    for t in reversed(range(T)):
        keep = 1.0 - d64[t]
        adv = r64[t] + 0.99 * nxt[t] * keep - v64[t] + 0.99 * 0.95 * keep * adv
        want[t] = adv
    e, e_bad = rel_err(advs.cpu().double(), want), rel_err(
        no_mask.cpu().double(), want)
    print(f"check ppo gae [{T},{N}] on the card vs a float64 loop: rel "
          f"{e:.3e} (tol {TOL_GAE}); control without the done mask: rel "
          f"{e_bad:.3e} (must exceed the tol)")
    require(e < TOL_GAE, "gae on the card")
    require(e_bad > TOL_GAE, "the GAE gate sees a dropped done mask")

    A.reset_launch_counts()
    t0 = time.perf_counter()
    m = algo.iterate()  # eager, then the graph is captured
    torch.cuda.synchronize()
    print(f"ppo first iteration (eager) and capture: "
          f"{time.perf_counter() - t0:.3f} s; total_loss "
          f"{m['total_loss'].item():.6f}")
    algo.iterate()  # warm replay
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        m = algo.iterate()
    m["total_loss"].item()
    wall = time.perf_counter() - t0
    steps_s = iters * T * N / wall
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    algo.iterate()
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end)
    launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS}
    print(f"ppo bench: {iters} iterations of {T} x {N} env steps in "
          f"{wall:.4f} s: {steps_s:.1f} env-steps/s; one replayed iteration "
          f"{replay_ms:.4f} ms on CUDA events; K1-K3 launches {launches} "
          "(no attention on this path)")
    out = algo.train_iteration()
    print(f"ppo metrics {json.dumps(out)}")
    require(all(math.isfinite(v) for v in out.values()), "ppo metrics finite")
    require(out["timesteps_this_iter"] == T * N, "timesteps_this_iter")

    # -- one replay against one eager iteration from the same state ----------
    snap = algo.snapshot()
    mg = {k: v.item() for k, v in algo.iterate().items()}
    acts_g = algo.trajectory[ACTIONS].clone()
    after_g = algo.snapshot()
    algo.restore(snap)
    me = {k: v.item() for k, v in algo.iterate(graph=False).items()}
    acts_e = algo.trajectory[ACTIONS]
    after_e = algo.snapshot()
    n_p = len(algo.params)
    e_par = max(rel_err(a, b) for a, b in zip(after_g[:n_p], after_e[:n_p]))
    e_met = max(abs(mg[k] - me[k]) / max(abs(me[k]), 1e-6) for k in me)
    same_acts = torch.equal(acts_g, acts_e)
    print(f"check ppo graph replay vs eager from the same state: actions "
          f"equal {same_acts}; parameters rel {e_par:.3e}, metrics rel "
          f"{e_met:.3e} (tol {TOL_GRAPH})")
    require(same_acts and e_par < TOL_GRAPH and e_met < TOL_GRAPH,
            "ppo graph replay equals an eager iteration")
    if profile_root is not None:
        profile_ppo(torch, algo, profile_root)
    del algo, snap, after_g, after_e
    torch.cuda.empty_cache()

    # -- CartPole learns -----------------------------------------------------
    algo = ondevice.OnDevicePPO(ondevice.cartpole(64), rollout_length=128,
                                minibatches=8, num_sgd_iter=4, seed=0)
    t0 = time.perf_counter()
    for i in range(120):
        ep_len = algo.train_iteration()["mean_episode_len"]
        if ep_len >= 128.0:
            break
    print(f"ppo cartpole(64): mean_episode_len {ep_len} after {i + 1} "
          f"iterations ({time.perf_counter() - t0:.3f} s; need >= 128 "
          "within 120)")
    require(ep_len >= 128.0, "PPO learns CartPole")
    del algo
    torch.cuda.empty_cache()
    print(f"ppo phase: {time.perf_counter() - t_phase:.3f} s wall")
    return {"env_steps_s": steps_s, "iteration_ms": replay_ms}


RL_LSTM = {"use_lstm": True, "lstm_cell_size": 256,
           "fcnet_hiddens": (256, 256)}


def rl_configs():
    """Phase 7b's runs: (name, config, iterations). PPO on AtariSim at
    full width (84x84x4 frames, Nature CNN, 16 envs x 128 steps, the
    default train batch 2048 and PPOConfig's defaults), recurrent PPO at
    upstream RLlib's MODEL_DEFAULTS widths, A2C at its defaults with
    (256, 256), IMPALA (feedforward and LSTM) and APPO at 8 batches an
    iteration, and DQN at its defaults (iterations: until 500 updates, the
    first target sync)."""
    from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, DQNConfig,
                                     ImpalaConfig, PPOConfig)

    return [
        ("ppo_atari", PPOConfig().environment("AtariSim").rollouts(
            num_envs_per_worker=16, rollout_fragment_length=128), 3),
        ("ppo_lstm", PPOConfig().environment("RepeatPrevObs").rollouts(
            num_envs_per_worker=16, rollout_fragment_length=64).training(
                model=RL_LSTM), 2),
        ("a2c", A2CConfig().training(model={"fcnet_hiddens": (256, 256)}),
         3),
        ("impala", ImpalaConfig().training(num_batches_per_iter=8), 2),
        ("impala_lstm", ImpalaConfig().training(num_batches_per_iter=8,
                                                model=RL_LSTM), 2),
        ("appo", APPOConfig().training(num_batches_per_iter=8), 2),
        ("dqn", DQNConfig(), None),
    ]


def rl_steps(name, cfg, iters):
    """The env steps ``iters`` iterations of ``cfg`` must take."""
    per = cfg.num_envs_per_worker * cfg.rollout_fragment_length
    if name in ("impala", "impala_lstm", "appo"):
        per *= cfg.num_batches_per_iter
    return iters * per


def rl_tensors(tree):
    """Every tensor of nested tuples, lists and dicts, in order."""
    from ray_tpu_torch.rllib.algorithm import tree_map

    found = []
    tree_map(found.append, tree)
    return found


def rl_replay(torch, update, args, dev):
    """``update`` on copies of ``args`` on ``dev``: (the parameters after,
    the metrics' tensors; the loss first), on the CPU."""
    from ray_tpu_torch.rllib.algorithm import tree_map

    args = tree_map(lambda t: t.to(dev, copy=True), args)
    params = {k: v.requires_grad_() for k, v in args[0].items()}
    out = update(params, *args[1:])
    return ([t.detach().cpu() for t in rl_tensors(out[0])],
            [t.detach().cpu() for t in rl_tensors(out[2:])])


def rl_parity(torch, dev, update, args):
    """One learner update on the card and on the CPU from the same inputs,
    under full_fp32: (loss rel, parameters' L2 rel, CPU loss, card
    loss)."""
    from ray_tpu_torch.device import full_fp32

    with full_fp32():
        pg, mg = rl_replay(torch, update, args, dev)
        pc, mc = rl_replay(torch, update, args, "cpu")
    e_loss = abs(mg[0].item() - mc[0].item()) / abs(mc[0].item())
    diff = torch.sqrt(sum(((a - b).double() ** 2).sum()
                          for a, b in zip(pg, pc)))
    e_par = (diff / torch.sqrt(sum((b.double() ** 2).sum()
                                   for b in pc))).item()
    return e_loss, e_par, mc[0].item(), mg[0].item()


def rl_learner_checks(torch, dev, name, algo, update, args):
    """The learner on the card against the CPU, from the inputs of the
    run's first update (``args``). A2C, IMPALA, APPO and DQN: that update
    (one optimizer step). PPO: one step on the first minibatch (rows, or
    sequences for the recurrent net), then, for the fp32 nets, the whole
    update (its loss is the last minibatch's, after every step before it:
    TOL_RL_LOSS_MULTI); PPO-AtariSim's bf16 trunk also its ppo_loss
    gradients at the recorded parameters, per leaf."""
    from ray_tpu_torch.device import full_fp32
    from ray_tpu_torch.rllib.ppo import (build_ppo_update,
                                         build_ppo_update_recurrent,
                                         ppo_loss)
    from ray_tpu_torch.rllib.sample_batch import OBS

    cfg = algo.config
    bf16 = name == "ppo_atari"
    tols = ((TOL_RL_LOSS_BF16, TOL_RL_PARAMS_BF16) if bf16
            else (TOL_RL_LOSS, TOL_RL_PARAMS))
    checks = []
    if name.startswith("ppo"):
        net = algo.workers.local_worker.policy.net
        one = copy.copy(cfg)
        one.num_sgd_iter = 1
        batch, size = args[2], cfg.sgd_minibatch_size
        if algo._recurrent:
            step = build_ppo_update_recurrent(one, algo.optimizer, net)
            seqs = max(1, size // batch[OBS].shape[0])
            first = {k: v[:, :seqs] for k, v in batch.items()}
        else:
            step = build_ppo_update(one, algo.optimizer, net.apply)
            first = {k: v[:size] for k, v in batch.items()}
        checks.append(("one SGD step", step,
                       (args[0], args[1], first, args[3])) + tols)
        if not bf16:
            checks.append((f"the whole update ({cfg.num_sgd_iter} epochs)",
                           update, args, TOL_RL_LOSS_MULTI, TOL_RL_PARAMS))
    else:
        checks.append(("the update (one step)", update, args) + tols)
    for label, fn, fn_args, tol_loss, tol_par in checks:
        e_loss, e_par, l_cpu, l_card = rl_parity(torch, dev, fn, fn_args)
        print(f"check rllib {name}: {label}, card vs CPU (full_fp32): loss "
              f"{l_card:.7f} vs {l_cpu:.7f}, rel {e_loss:.3e} (tol "
              f"{tol_loss}); parameters rel {e_par:.3e} (tol {tol_par})")
        require(e_loss < tol_loss and e_par < tol_par,
                f"{name}: {label} on the card matches the CPU")
    if not bf16:
        return
    from ray_tpu_torch.rllib.policy import forward_conv

    mb = {k: v[:cfg.sgd_minibatch_size] for k, v in args[2].items()}
    grads = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        p = {k: v.to(d, copy=True).requires_grad_()
             for k, v in args[0].items()}
        with full_fp32():
            loss, _ = ppo_loss(p, {k: v.to(d) for k, v in mb.items()},
                               cfg.clip_param, cfg.vf_clip_param,
                               cfg.vf_loss_coeff, cfg.entropy_coeff,
                               forward_conv)
            g = torch.autograd.grad(loss, list(p.values()))
        grads[tag] = dict(zip(p, (t.cpu() for t in g)))
    e_grad = {k: rel_err(grads["card"][k], v)
              for k, v in grads["cpu"].items()}
    worst = max(e_grad, key=e_grad.get)
    print(f"check rllib {name}: gradients of ppo_loss at the recorded "
          f"parameters on {cfg.sgd_minibatch_size} frames, card vs CPU "
          f"(bf16 trunk): worst {worst} rel {e_grad[worst]:.3e} (tol "
          f"{TOL_RL_GRAD_BF16}, conv biases {TOL_RL_GRAD_BF16_CONV_BIAS})")
    for k, e in e_grad.items():
        conv_bias = k.startswith("conv") and k.endswith("_b")
        require(e < (TOL_RL_GRAD_BF16_CONV_BIAS if conv_bias
                     else TOL_RL_GRAD_BF16),
                f"{name}: gradient {k} on the card")


def rllib_phase(torch, A, dev, root):
    """Phase 7b: the actor-based algorithms through their public entry
    points (``XConfig()...build()``, no device: the learner on the card,
    the rollout workers' policies on the CPU), locally. Gates: learner
    parameters and optimizer state on the card and the worker's policy on
    the CPU; every metric finite and timesteps_total as the settings
    imply; one learner update of each, replayed on the card and the CPU
    from the same inputs, within the TOL_RL_* tolerances; PPO-AtariSim's
    save/restore bit-identical on the card; no attention kernel launched.
    Prints PPO-AtariSim's env-steps/s, rollout and learner ms an iteration
    (CUDA events around the update) and each run's wall seconds."""
    from ray_tpu_torch.rllib.algorithm import tree_map

    t_phase = time.perf_counter()
    card = smi_line()
    out = {}
    A.reset_launch_counts()
    for name, cfg, iters in rl_configs():
        t0 = time.perf_counter()
        algo = cfg.build()
        calls, update = [], algo._update
        learner_ms, rollout_ms = [], []

        def recorded(*args, update=update, calls=calls, ms=learner_ms):
            if not calls:
                calls.append(tree_map(lambda t: t.detach().cpu().clone(),
                                      args))
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            result = update(*args)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            return result

        algo._update = recorded
        sample = algo.workers.sample

        def timed_sample(*args, sample=sample, ms=rollout_ms):
            t = time.perf_counter()
            result = sample(*args)
            ms.append((time.perf_counter() - t) * 1e3)
            return result

        algo.workers.sample = timed_sample
        results, walls = [], []
        i = 0
        while True:
            t = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t)
            i += 1
            if iters is not None and i == iters:
                break
            if iters is None and (results[-1]["num_learner_updates"]
                                  >= cfg.target_network_update_freq):
                break
            require(i < 200, f"{name}: learner updates within 200 iterations")
        wall = time.perf_counter() - t0
        last = results[-1]
        bad = {k: v for r in results for k, v in r.items()
               if isinstance(v, float) and not math.isfinite(v)}
        require(not bad, f"{name}: finite metrics ({bad})")
        require(last["timesteps_total"] == rl_steps(name, cfg, i),
                f"{name}: timesteps_total {last['timesteps_total']} is "
                f"{rl_steps(name, cfg, i)}")
        learner = rl_tensors(algo.params) + rl_tensors(algo.opt_state)
        if name == "dqn":
            learner += rl_tensors(algo.target_params)
            require(last["loss"] is not None and last["num_learner_updates"]
                    >= 2, "dqn: learner updates ran")
        policy = algo.workers.local_worker.policy
        require(all(t.device.type == "cuda" for t in learner),
                f"{name}: every learner parameter and optimizer-state "
                "tensor on cuda")
        require(policy.device.type == "cpu" and all(
            p.device.type == "cpu" for p in policy.params.values()),
            f"{name}: the rollout policy on the CPU")
        # -- the learner, card against CPU ---------------------------------
        kind = policy.net.kind if hasattr(policy, "net") else "q-mlp"
        rl_learner_checks(torch, dev, name, algo, update, calls[0])
        n_params = sum(p.numel() for p in algo.params.values())
        print(f"rllib {name} on {card}: {i} iterations, {kind} policy, "
              f"{n_params} parameters, timesteps_total "
              f"{last['timesteps_total']}, {len(learner_ms)} learner "
              f"updates; {wall:.3f} s wall (train() "
              + ", ".join(f"{w:.3f}" for w in walls) + " s); last "
              + json.dumps({k: v for k, v in last.items()
                            if k not in ("time_this_iter_s",)}))
        if name == "ppo_atari":
            # The first iteration warms up; the rest are timed.
            steps = sum(r["timesteps_this_iter"] for r in results[1:])
            out = {"env_steps_s": steps / sum(walls[1:]),
                   "rollout_ms": sum(rollout_ms[1:]) / (i - 1),
                   "learner_ms": sum(learner_ms[1:]) / (i - 1)}
            print(f"rllib ppo_atari on {card}: {out['env_steps_s']:.1f} "
                  f"env-steps/s over {i - 1} timed iterations of "
                  f"{results[-1]['timesteps_this_iter']} steps; rollout "
                  f"{out['rollout_ms']:.1f} ms (host clock, CPU policy), "
                  f"learner {out['learner_ms']:.1f} ms (CUDA events, "
                  f"{cfg.num_sgd_iter} epochs x "
                  f"{last['timesteps_this_iter'] // cfg.sgd_minibatch_size}"
                  " minibatches) an "
                  "iteration; rollout by iteration "
                  + ", ".join(f"{m:.1f}" for m in rollout_ms)
                  + " ms, learner " + ", ".join(f"{m:.1f}" for m in
                                                learner_ms) + " ms")
            ckpt = os.path.join(root, "chiprun_out", "rllib_ppo_atari_ckpt")
            path = algo.save(ckpt)
            fresh = cfg.build()
            fresh.restore(path)
            same = all(torch.equal(fresh.params[k], v)
                       for k, v in algo.params.items())
            on_card = all(p.device.type == "cuda"
                          for p in fresh.params.values())
            print(f"check rllib ppo_atari save/restore: learner weights "
                  f"bit-identical {same}, on the card {on_card}")
            require(same and on_card, "ppo_atari save/restore")
            fresh.stop()
            os.remove(path)
            os.rmdir(ckpt)
        algo.stop()
        del algo, calls
        torch.cuda.empty_cache()
    launches = {f.__name__: f.launches
                for f in A.KERNEL_WRAPPERS + A.GENERAL_WRAPPERS}
    print(f"rllib phase: attention kernel launches {launches} (no attention "
          "on this path)")
    require(all(n == 0 for n in launches.values()),
            "no attention kernel on the RLlib path")
    print(f"phase 7b (rllib): {time.perf_counter() - t_phase:.3f} s wall; "
          f"{card}")
    return out


class InlineRuntime:
    """A synchronous in-process actor runtime, for phase 7c's Ape-X,
    phase 8's Train library and phase 10's Tune: ``remote(cls)`` builds
    the actor in this
    process, and ``actor.method.remote(...)`` runs the method at once and
    returns a ref to its result; ``get``, ``put``, ``wait`` (every ref is
    ready), ``kill``, and placement groups of one slot that are always
    ready (``placement_group``, ``remove_placement_group``,
    ``PlacementGroupSchedulingStrategy``). It is the ``runtime=`` interface
    the port takes; this script imports no runtime of the JAX package.
    A train loop runs whole at ``run_train_fn.remote()``, so its reports
    arrive in the trainer's final drain: the JAX package's semantics on a
    gang of one slot. A Tune trial's actor runs its function on a thread
    of its own (``start`` returns at once), so trials run at once as
    threads of this process; ``options(num_cpus=, resources=)`` is
    accepted and ignored."""

    class PlacementGroup:
        def __init__(self, bundles, strategy="PACK"):
            self.bundles, self.strategy = bundles, strategy

        def wait(self, timeout=None):
            return True

    class PlacementGroupSchedulingStrategy:
        def __init__(self, placement_group, placement_group_bundle_index=-1):
            self.placement_group = placement_group
            self.placement_group_bundle_index = placement_group_bundle_index

    def placement_group(self, bundles, strategy="PACK"):
        return InlineRuntime.PlacementGroup(bundles, strategy)

    def remove_placement_group(self, pg):
        pass

    class Ref:
        def __init__(self, value):
            self.value = value

    class Actor:
        def __init__(self, runtime, obj):
            self._runtime, self._obj, self._killed = runtime, obj, False

        def __getattr__(self, name):
            if self._killed:
                raise RuntimeError(f"actor {type(self._obj).__name__} killed")
            return InlineRuntime.Method(self._runtime,
                                        getattr(self._obj, name))

    class Method:
        def __init__(self, runtime, fn):
            self._runtime, self._fn = runtime, fn

        def remote(self, *args, **kwargs):
            args, kwargs = self._runtime.resolve(args, kwargs)
            return InlineRuntime.Ref(self._fn(*args, **kwargs))

    class ActorClass:
        def __init__(self, runtime, cls):
            self._runtime, self._cls = runtime, cls

        def options(self, **_):
            return self

        def remote(self, *args, **kwargs):
            args, kwargs = self._runtime.resolve(args, kwargs)
            return InlineRuntime.Actor(self._runtime,
                                       self._cls(*args, **kwargs))

    def resolve(self, args, kwargs):
        """Refs among the arguments become their values, as a runtime
        resolves top-level refs."""
        value = lambda a: a.value if isinstance(a, InlineRuntime.Ref) else a
        return ([value(a) for a in args],
                {k: value(v) for k, v in kwargs.items()})

    def remote(self, cls):
        return InlineRuntime.ActorClass(self, cls)

    def get(self, refs, timeout=None):
        if isinstance(refs, list):
            return [r.value for r in refs]
        return refs.value

    def put(self, value):
        return InlineRuntime.Ref(value)

    def wait(self, refs, num_returns=1, timeout=None):
        return list(refs[:num_returns]), list(refs[num_returns:])

    def kill(self, actor):
        actor._killed = True


def rl7c_metrics(name, out):
    """(the update's primary loss, its other losses) from one learner
    update's outputs."""
    if name in ("sac", "td3"):
        return out[2]["critic_loss"], [out[2]["actor_loss"]]
    if name.startswith("cql"):
        return out[4]["critic_loss"], [out[4]["actor_loss"],
                                       out[4]["td_loss"]]
    if name in ("marwil", "bc"):
        return out[2], [out[3]["policy_loss"], out[3]["vf_loss"],
                        out[3]["adv_norm"]]
    return out[2], []  # Ape-X: DQN's (params, opt_state, loss, td)


def rl7c_replay(torch, update, args, dev):
    """``update`` on copies of the recorded ``args`` on ``dev``: (the
    parameters after, on the CPU; the update's outputs)."""
    from ray_tpu_torch.rllib.algorithm import tree_map
    from ray_tpu_torch.rllib.algorithm import tree_leaves

    args = tree_map(lambda t: t.to(dev, copy=True), args)
    tree_map(lambda t: t.requires_grad_() if t.is_floating_point() else t,
             args[0])
    out = update(*args)
    return [t.detach().cpu() for t in tree_leaves(out[0])], out


def rl7c_parity(torch, dev, name, update, args, label):
    """One recorded learner update replayed on the card and on the CPU under
    full_fp32: the primary loss relative (TOL_RL_LOSS), the other losses
    relative to max(|CPU value|, 1) (an actor loss can sit near 0), the
    parameters as phase 7b's L2 over their norm (TOL_RL_PARAMS)."""
    from ray_tpu_torch.device import full_fp32

    with full_fp32():
        pg, og = rl7c_replay(torch, update, args, dev)
        pc, oc = rl7c_replay(torch, update, args, "cpu")
    lg, rest_g = rl7c_metrics(name, og)
    lc, rest_c = rl7c_metrics(name, oc)
    lg, lc = float(lg), float(lc)
    e_loss = abs(lg - lc) / max(abs(lc), 1e-12)
    e_rest = max([abs(float(a) - float(b)) / max(abs(float(b)), 1.0)
                  for a, b in zip(rest_g, rest_c)] or [0.0])
    diff = torch.sqrt(sum(((a - b).double() ** 2).sum()
                          for a, b in zip(pg, pc)))
    e_par = (diff / torch.sqrt(sum((b.double() ** 2).sum()
                                   for b in pc))).item()
    print(f"check rllib {name}: {label}, card vs CPU (full_fp32): loss "
          f"{lg:.7f} vs {lc:.7f}, rel {e_loss:.3e} (tol {TOL_RL_LOSS}); "
          f"other losses {e_rest:.3e} (tol {TOL_RL_LOSS}); parameters rel "
          f"{e_par:.3e} (tol {TOL_RL_PARAMS})")
    require(e_loss < TOL_RL_LOSS and e_rest < TOL_RL_LOSS
            and e_par < TOL_RL_PARAMS,
            f"{name}: {label} on the card matches the CPU")
    return {"loss_rel": e_loss, "other_rel": e_rest, "params_rel": e_par}


def rl7c_profile(torch, dev, name, update, args, key):
    """One recorded learner update replayed on the card under
    torch.profiler: its kernels (and copies), their device ms and the
    update's host ms to a synchronise, so the card's idle share; then the
    same for the update's key work alone (a split and two normal draws of
    the batch's actions, as SAC's update makes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import random as trandom
    from ray_tpu_torch.rllib.algorithm import tree_map

    def fresh():
        copy = tree_map(lambda t: t.to(dev, copy=True), args)
        tree_map(lambda t: t.requires_grad_() if t.is_floating_point()
                 else t, copy[0])
        return copy

    def draws():
        keys = trandom.split(key)
        shape = (args[2]["actions"].shape[0], args[2]["actions"].shape[1])
        trandom.normal(trandom.take(keys, 0), shape)
        trandom.normal(trandom.take(keys, 1), shape)

    out = {}
    for label, fn in (("update", lambda a: update(*a)),
                      ("key split + 2 normal draws", lambda a: draws())):
        fn(fresh())  # warm
        copy = fresh()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn(copy)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in events) / 1e3
        out[label] = {"kernels": len(events), "device_ms": dev_ms,
                      "host_ms": host_ms}
        print(f"profile rllib {name}: {label}: {len(events)} kernels and "
              f"copies, {dev_ms:.3f} ms of device time in {host_ms:.3f} ms "
              f"to a synchronise (the card idle "
              f"{100 * (1 - dev_ms / host_ms):.1f}%)")
    return out


def rl7c_record(torch, algo, key_of=lambda args: 0):
    """Wrap ``algo._update``: CUDA-event ms of every call, and a CPU copy
    of the first call's arguments of each kind (``key_of(args)``: TD3's
    actor flag, CQL's phase). Returns (the original update, the records
    by kind, the ms list)."""
    from ray_tpu_torch.rllib.algorithm import tree_map

    update, calls, ms = algo._update, {}, []

    def recorded(*args):
        kind = key_of(args)
        if kind not in calls:
            calls[kind] = tree_map(lambda t: t.detach().cpu().clone(), args)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        result = update(*args)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        return result

    algo._update = recorded
    return update, calls, ms


def rl7c_on_card(name, *trees):
    """Every tensor of ``trees`` (parameters, optimizer states) on cuda."""
    devices = {t.device.type for tree in trees for t in rl_tensors(tree)}
    require(devices == {"cuda"}, f"{name}: every learner parameter and "
            f"optimizer-state tensor on cuda (found {sorted(devices)})")


def rl7c_policy_on_cpu(name, policy):
    from ray_tpu_torch.rllib.algorithm import tree_leaves

    require(policy.device.type == "cpu" and all(
        p.device.type == "cpu" for p in tree_leaves(policy.params)),
        f"{name}: the rollout policy on the CPU")


def rl7c_finite(name, results):
    bad = {k: v for r in results for k, v in r.items()
           if isinstance(v, float) and not math.isfinite(v)}
    require(not bad, f"{name}: finite metrics ({bad})")


def rl7c_train(name, algo, until, limit=100):
    """``train()`` until ``until(result)``: (results, wall s of each)."""
    results, walls = [], []
    while True:
        t = time.perf_counter()
        results.append(algo.train())
        walls.append(time.perf_counter() - t)
        if until(results[-1]):
            return results, walls
        require(len(results) < limit, f"{name}: done within {limit} "
                "iterations")


def rl7c_datasets(torch, root):
    """Phase 7c's datasets, written with the port's JsonWriter under
    chiprun_out/rllib_7c_data: Pendulum, 16 envs x 1,000 steps of uniform
    actions in [-2, 2] (CQL's); CartPole, 4,096 steps logged time-major
    from the port's PPO after 15 iterations (MARWIL's and BC's, with the
    behaviour log-probabilities for DM and DR)."""
    import numpy as np

    from ray_tpu_torch.rllib import (FastPendulum, JsonWriter, PPOConfig,
                                     SampleBatch)
    from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, LOGPS,
                                                  NEXT_OBS, OBS, REWARDS)

    base = os.path.join(root, "chiprun_out", "rllib_7c_data")
    paths = {k: os.path.join(base, k) for k in ("pendulum", "cartpole")}
    env = FastPendulum(num_envs=16, seed=0)
    rng = np.random.default_rng(0)
    writer = JsonWriter(paths["pendulum"])
    obs = env.vector_reset()
    for _ in range(1000):
        acts = rng.uniform(-2, 2, size=(16, 1)).astype(np.float32)
        nobs, rews, dones, _ = env.vector_step(acts)
        writer.write(SampleBatch({OBS: obs.copy(), ACTIONS: acts,
                                  REWARDS: rews, NEXT_OBS: nobs.copy(),
                                  DONES: dones}))
        obs = nobs
    writer.close()
    algo = (PPOConfig().environment("FastCartPole")
            .rollouts(num_envs_per_worker=8, rollout_fragment_length=32)
            .training(train_batch_size=256, num_sgd_iter=6)
            .debugging(seed=0).build())
    for _ in range(15):
        algo.train()
    worker = algo.workers.local_worker
    writer = JsonWriter(paths["cartpole"])
    logged = 0
    while logged < 4000:
        batch = worker.sample(32)
        cols = {k: np.asarray(batch[k])
                for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS)}
        writer.write(SampleBatch(cols))
        logged += cols[REWARDS].size
    writer.close()
    behaviour = worker.episode_stats()["episode_reward_mean"]
    algo.stop()
    del algo
    return base, paths, behaviour


def rl7c_ope(torch, dev, card, path, policy):
    """DM and DR with the fitted-Q model on the card, on the CartPole log
    turned env-major (each env's column an episode sequence, cut at its
    end) and scored for ``policy`` (the trained MARWIL's, on the CPU); then
    FittedQModel's fit on the card against the CPU from the same weights
    (TOL_FQE_CARD)."""
    import numpy as np

    from ray_tpu_torch.device import full_fp32
    from ray_tpu_torch.rllib import (DirectMethod, DoublyRobust, JsonReader,
                                     SampleBatch)
    from ray_tpu_torch.rllib.offline import FittedQModel
    from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, LOGPS,
                                                  NEXT_OBS, OBS, REWARDS)

    data = JsonReader(path).read_all()  # [T, N, ...], time-major
    steps = data[REWARDS].shape[0] - 1

    def env_major(col, start=0):
        col = np.asarray(col)[start:start + steps]
        return np.swapaxes(col, 0, 1).reshape((-1,) + col.shape[2:])

    dones = np.asarray(data[DONES])[:steps].copy()
    dones[-1] = True  # each env's sequence ends where the log does
    batch = SampleBatch({OBS: env_major(data[OBS]),
                         NEXT_OBS: env_major(data[OBS], 1),
                         ACTIONS: env_major(data[ACTIONS]),
                         REWARDS: env_major(data[REWARDS]),
                         DONES: np.swapaxes(dones, 0, 1).reshape(-1),
                         LOGPS: env_major(data[LOGPS])})

    @torch.no_grad()
    def probs(obs):
        logits, _ = policy.net.apply(policy.params, torch.as_tensor(
            np.asarray(obs, np.float32)))
        return torch.softmax(logits.double(), -1).numpy()

    def logp(obs, actions):
        p = probs(obs)
        return np.log(p[np.arange(len(actions)),
                        np.asarray(actions).astype(np.int64)])

    out = {}
    for cls in (DirectMethod, DoublyRobust):
        t = time.perf_counter()
        est = cls(logp, target_probs_fn=probs, num_actions=2).estimate(batch)
        out[cls.__name__] = dict(est, wall_s=time.perf_counter() - t)
        require(all(math.isfinite(v) for v in est.values()),
                f"{cls.__name__}: finite estimate")
        print(f"rllib {cls.__name__} on {card}: v_behavior "
              f"{est['v_behavior']:.4f}, v_target {est['v_target']:.4f} "
              f"({len(batch[REWARDS])} rows; fitted-Q on the card) in "
              f"{out[cls.__name__]['wall_s']:.3f} s")
    obs = np.asarray(batch[OBS], np.float32)
    args = (obs, batch[ACTIONS], batch[REWARDS], batch[NEXT_OBS],
            batch[DONES], probs(batch[NEXT_OBS]), 0.99)
    models = {"card": FittedQModel(4, 2, device=dev),
              "cpu": FittedQModel(4, 2, device="cpu")}
    models["card"].set_weights(models["cpu"].get_weights())
    require(all(p.device.type == "cuda" for layer in models["card"].params
                for p in layer.values()), "FittedQModel on the card")
    fit, q = {}, {}
    with full_fp32():
        for k, m in models.items():
            t = time.perf_counter()
            fit[k] = m.fit(*args)
            print(f"rllib FittedQModel.fit on {k}: 20 backups x 25 Adam "
                  f"steps in {time.perf_counter() - t:.3f} s, final loss "
                  f"{fit[k]:.7f}")
            q[k] = m.q_values(obs)
    w = [np.concatenate([np.ravel(v) for layer in models[k].get_weights()
                         for v in layer.values()]) for k in ("card", "cpu")]
    e_q = float(np.abs(q["card"] - q["cpu"]).max() / np.abs(q["cpu"]).max())
    e_w = float(np.linalg.norm(w[0] - w[1]) / np.linalg.norm(w[1]))
    e_loss = abs(fit["card"] - fit["cpu"]) / abs(fit["cpu"])
    print(f"check rllib FittedQModel.fit card vs CPU (full_fp32): Q-values "
          f"rel {e_q:.3e}, weights rel {e_w:.3e}, final loss rel "
          f"{e_loss:.3e} (tol {TOL_FQE_CARD})")
    require(max(e_q, e_w, e_loss) < TOL_FQE_CARD,
            "FittedQModel.fit on the card matches the CPU")
    out["fqe_card_vs_cpu"] = {"q_rel": e_q, "weights_rel": e_w,
                              "loss_rel": e_loss}
    return out


def offpolicy_phase(torch, A, dev, root):
    """Phase 7c: SAC, TD3, CQL, MARWIL, BC, DM/DR, Ape-X, ES and ARS
    through their public entry points (``XConfig()...build()``, no device:
    the learner on the card, the workers' policies on the CPU), at their
    configs' defaults. Gates: learner tensors on the card and worker
    policies on the CPU; every metric finite and timesteps_total as the
    settings imply; recorded learner updates replayed on the card and the
    CPU within the TOL_RL_* tolerances (TD3 with and without its actor
    step, CQL in both phases); FittedQModel's fit on the card against the
    CPU; no attention kernel launched. Prints SAC's and TD3's env-steps/s
    and learner ms an update, CQL's and MARWIL's ms an update and each
    run's wall seconds."""
    import shutil

    import numpy as np

    from ray_tpu_torch.rllib import (ARSConfig, ApexConfig, BCConfig,
                                     CQLConfig, ESConfig, MARWILConfig,
                                     SACConfig, TD3Config)

    t_phase = time.perf_counter()
    card = smi_line()
    A.reset_launch_counts()
    out, parity = {}, {}
    base, paths, behaviour = rl7c_datasets(torch, root)
    print(f"rllib 7c datasets: Pendulum 16 x 1000 uniform steps, CartPole "
          f"4096 steps of PPO (behaviour reward {behaviour}) in "
          f"{time.perf_counter() - t_phase:.3f} s")

    def report(name, algo, results, walls, ms, extra=""):
        wall = sum(walls)
        last = results[-1]
        update_ms = float(np.mean(ms[1:] or ms)) if ms else 0.0
        learner = (f"{len(ms)} learner updates, {update_ms:.3f} ms an "
                   f"update after the first (CUDA events; first "
                   f"{ms[0]:.3f})" if ms else "no learner on the card")
        print(f"rllib {name} on {card}: {len(results)} iterations, "
              f"timesteps_total {last['timesteps_total']}, {learner}{extra}; "
              f"{wall:.3f} s wall (train() "
              + ", ".join(f"{w:.3f}" for w in walls) + " s); last "
              + json.dumps({k: v for k, v in last.items()
                            if k not in ("time_this_iter_s",
                                         "replay_shards")}))
        out[name] = {"iterations": len(results), "wall_s": wall,
                     "update_ms": update_ms if ms else None,
                     "timesteps_total": last["timesteps_total"]}

    # -- SAC and TD3 at their defaults, FastPendulum --------------------------
    for name, cfg, kind in (("sac", SACConfig(), lambda a: 0),
                            ("td3", TD3Config(), lambda a: bool(a[4]))):
        algo = cfg.build()
        update, calls, ms = rl7c_record(torch, algo, kind)
        results, walls = rl7c_train(
            name, algo, lambda r: r["num_learner_updates"] >= 64)
        rl7c_finite(name, results)
        per = cfg.num_envs_per_worker * cfg.rollout_fragment_length
        last = results[-1]
        require(last["timesteps_total"] == per * len(results)
                and last["num_learner_updates"] == 64,
                f"{name}: timesteps_total {last['timesteps_total']} is "
                f"{per} x {len(results)}, 64 updates")
        rl7c_on_card(name, algo.params, algo.opt_state)
        rl7c_policy_on_cpu(name, algo.workers.local_worker.policy)
        steps_s = last["timesteps_total"] / sum(walls)
        report(name, algo, results, walls, ms,
               f", {steps_s:.1f} env-steps/s over the run")
        out[name]["env_steps_s"] = steps_s
        if name == "td3":
            require(set(calls) == {True, False},
                    "td3: both kinds of update ran")
            for flag, label in ((True, "an update with its actor step"),
                                (False, "a critic-only update")):
                parity[f"td3_{flag}"] = rl7c_parity(
                    torch, dev, name, update, calls[flag], label)
        else:
            parity[name] = rl7c_parity(torch, dev, name, update, calls[0],
                                       "the first update")
            out[name]["profile"] = rl7c_profile(
                torch, dev, name, update, calls[0],
                tuple(t.to(dev) for t in calls[0][3]))
        algo.stop()
        del algo, calls

    # -- CQL at its defaults on the Pendulum log, 4 iterations ----------------
    algo = CQLConfig().offline_data(paths["pendulum"]).build()
    update, calls, ms = rl7c_record(torch, algo, lambda a: bool(a[6]))
    results, walls = rl7c_train("cql", algo, lambda r: r["num_updates"]
                                >= 4 * algo.config.num_updates_per_iter)
    rl7c_finite("cql", results)
    cfg = algo.config
    require(results[-1]["timesteps_total"]
            == 4 * cfg.num_updates_per_iter * cfg.train_batch_size,
            "cql: timesteps_total")
    require(set(calls) == {True, False}, "cql: both actor phases ran")
    rl7c_on_card("cql", algo.params, algo.critic_state, algo.actor_state,
                 algo.alpha_state)
    report("cql", algo, results, walls, ms,
           f" ({algo._n} logged rows; behaviour cloning to update "
           f"{cfg.bc_iters})")
    for flag, label in ((True, "a behaviour-cloning update"),
                        (False, "a SAC-objective update")):
        parity[f"cql_{flag}"] = rl7c_parity(torch, dev, f"cql_{flag}",
                                            update, calls[flag], label)
    del algo, calls

    # -- MARWIL (beta 1) and BC on the CartPole log, 2 iterations each --------
    marwil_policy = None
    for name, cfg in (("marwil", MARWILConfig()), ("bc", BCConfig())):
        algo = cfg.offline_data(paths["cartpole"]).build()
        update, calls, ms = rl7c_record(torch, algo)
        results, walls = rl7c_train(
            name, algo, lambda r: r["training_iteration"] >= 2)
        rl7c_finite(name, results)
        require(results[-1]["timesteps_total"]
                == 2 * cfg.num_updates_per_iter * cfg.train_batch_size,
                f"{name}: timesteps_total")
        rl7c_on_card(name, algo.params, algo.opt_state, algo._adv_norm)
        rl7c_policy_on_cpu(name, algo.workers.local_worker.policy)
        ev = algo.evaluate(episodes=8)
        report(name, algo, results, walls, ms,
               f", evaluated reward {ev['episode_reward_mean']:.1f} over "
               f"{ev['episodes']} episodes")
        parity[name] = rl7c_parity(torch, dev, name, update, calls[0],
                                   "the first update")
        if name == "marwil":
            marwil_policy = algo.workers.local_worker.policy
        algo.stop()
        del algo, calls

    # -- DM and DR, the fitted-Q model on the card ----------------------------
    out["ope"] = rl7c_ope(torch, dev, card, paths["cartpole"], marwil_policy)
    shutil.rmtree(base)

    # -- Ape-X at its defaults on an in-process runtime -----------------------
    cfg = ApexConfig()
    algo = cfg.build(runtime=InlineRuntime())
    update, calls, ms = rl7c_record(torch, algo)
    per_iter = cfg.num_updates_per_iter
    results, walls = rl7c_train(
        "apex", algo, lambda r: r["num_learner_updates"] >= 2 * per_iter)
    rl7c_finite("apex", [{k: v for k, v in r.items() if k != "loss"}
                         for r in results])
    last = results[-1]
    per = cfg.num_envs_per_worker * cfg.rollout_fragment_length
    require(last["timesteps_total"] == per * len(results)
            and last["loss"] is not None and math.isfinite(last["loss"]),
            "apex: timesteps_total and a finite loss")
    require(all(s["adds"] > 0 for s in last["replay_shards"])
            and sum(s["samples"] for s in last["replay_shards"]) > 0,
            f"apex: every shard fed and sampled ({last['replay_shards']})")
    rl7c_on_card("apex", algo.params, algo.target_params, algo.opt_state)
    for w in algo.workers.remote_workers:
        rl7c_policy_on_cpu("apex", w._obj.policy)
    eps = [w._obj.policy.epsilon for w in algo.workers.remote_workers]
    report("apex", algo, results, walls, ms,
           f", 2 workers (epsilons {eps}) and 2 shards on an in-process "
           "runtime")
    parity["apex"] = rl7c_parity(torch, dev, "apex", update, calls[0],
                                 "the first DQN update")
    algo.stop()
    del algo, calls

    # -- ES and ARS, locally on the CPU ---------------------------------------
    for name, cfg in (("es", ESConfig()), ("ars", ARSConfig())):
        algo = cfg.rollouts(num_rollout_workers=0).build()
        results, walls = rl7c_train(
            name, algo, lambda r: r["training_iteration"] >= 2)
        rl7c_finite(name, results)
        require(results[-1]["timesteps_total"] == sum(
            r["timesteps_this_iter"] for r in results)
            and all(r["episodes_this_iter"] == 2 * cfg.episodes_per_batch
                    for r in results), f"{name}: steps and episodes")
        require(algo._local.policy.device.type == "cpu",
                f"{name}: the evaluation policy on the CPU")
        report(name, algo, results, walls, [],
               f", {algo.dim} parameters, noise table "
               f"{cfg.noise_size}")
        algo.stop()

    launches = {f.__name__: f.launches
                for f in A.KERNEL_WRAPPERS + A.GENERAL_WRAPPERS}
    print(f"rllib 7c: attention kernel launches {launches} (no attention "
          "on this path)")
    require(all(n == 0 for n in launches.values()),
            "no attention kernel on the phase 7c path")
    out["parity"] = parity
    out["launches"] = launches
    torch.cuda.empty_cache()
    print(f"phase 7c (rllib: SAC, TD3, CQL, MARWIL, BC, DM/DR, Ape-X, ES, "
          f"ARS): {time.perf_counter() - t_phase:.3f} s wall; {card}")
    return out


def profile_ppo(torch, algo, root):
    """One replayed PPO iteration under torch.profiler, device time by
    kernel; then one eager iteration, whose kernels the profiler can tie to
    the operators that launched them. The learner's state is restored
    after each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(root, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    snap = algo.snapshot()
    for label, graph in (("replayed", True), ("eager", False)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            algo.iterate(graph=graph)
            torch.cuda.synchronize()
        algo.restore(snap)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in kernels) / 1e3
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40, max_name_column_width=90)
        name = f"chip_smoke_profile_ppo_{label}.txt"
        with open(os.path.join(out, name), "w") as f:
            f.write(table)
        print(f"profile of one {label} PPO iteration: {len(kernels)} "
              f"kernels, {dev_ms:.3f} ms of device time; by op (top 40) "
              f"written to chiprun_out/{name}")


def drain(engine, handles, limit=100000):
    """step() until every handle is done and the pipeline is empty."""
    for _ in range(limit):
        if not engine.step() and all(h._done.is_set() for h in handles):
            return
    raise SystemExit("chip_smoke: FAILED: engine did not drain")


def serve_phase(torch, A, dev, profile_root=None):
    """Phase 6: llama-1b on the port's serving path. Returns K1's launches
    on the forward check and what phase 6b holds tp2 to
    (``tp2_reference``). With ``profile_root``, also writes a device-time
    breakdown of one eager decode step."""
    import asyncio

    import numpy as np

    from ray_tpu_torch.llm import sampling
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.llm.serve import LLMServer
    from ray_tpu_torch.models import llama

    t_phase = time.perf_counter()
    name = "llama-1b"
    cfg = llama.CONFIGS[name]
    model = llama.Llama(cfg, torch.Generator(device=dev).manual_seed(0),
                        dev).to(cfg.dtype).requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name}: {n_params} parameters ({n_params * 2 / 1e9:.3f} GB "
          f"bf16), {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads, {cfg.num_kv_heads} KV heads, vocab "
          f"{cfg.vocab_size}, max_seq {cfg.max_seq}")
    rng = np.random.default_rng(0)
    prompt_len, max_new, ps = 128, 128, 16

    def prompt():
        return rng.integers(1, cfg.vocab_size, size=prompt_len).tolist()

    # -- K1 at the llama shape, on layer 0's q/k/v ----------------------------
    toks = torch.tensor(prompt(), device=dev)
    hd, n_rep = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    with torch.no_grad():
        x = model.wte[toks[None]].to(cfg.dtype)
        q, k, v = model.blocks[0].qkv(
            x, llama._rot(torch.arange(prompt_len, device=dev), cfg))
        k, v = (llama._repeat_kv(t, n_rep).contiguous() for t in (k, v))
        q = q.contiguous()
    o, lse = A.flash_fwd(q, k, v, True, hd ** -0.5)
    ro, rlse = A.mha_reference_with_lse(q, k, v, True, hd ** -0.5)
    torch.cuda.synchronize()
    e_o, e_lse = rel_err(o, ro), (lse - rlse).abs().max().item()
    k1_abs = (o.float() - ro.float()).abs().max().item()
    print(f"check {name} K1 {list(q.shape)} bf16 causal on layer 0's "
          f"q/k/v vs plain: rel {e_o:.3e} (tol {TOL_VS_PLAIN}), abs "
          f"{k1_abs:.3e}; lse abs {e_lse:.3e} (tol {TOL_LSE})")
    require(e_o < TOL_VS_PLAIN and e_lse < TOL_LSE, "K1 at the llama shape")
    del x, q, k, v, o, lse, ro, rlse

    # -- paths against each other ------------------------------------------
    causal_op = llama.attention_op

    def forward(m, attn=None):
        """All-row logits of ``m`` on the prompt, llama's attention swapped
        for ``attn`` when given (K1 otherwise)."""
        llama.attention_op = attn or causal_op
        try:
            with torch.no_grad():
                return m(toks[None])[0]
        finally:
            llama.attention_op = causal_op

    A.reset_launch_counts()
    fwd = forward(model)
    torch.cuda.synchronize()
    k1 = A.flash_fwd.launches
    print(f"{name} forward [1, {prompt_len}]: K1 launches {k1} (expect "
          f"{cfg.num_layers}); general kernels {general_launches(A)}")
    require(k1 == cfg.num_layers, "K1 launches on the llama forward")
    require(general_launches(A) == 0, f"{name}: no general kernel")
    # fp32 yardstick: the same (bf16-valued) weights with fp32 activations
    # and the plain attention.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = copy.deepcopy(model).float()
    for m in (model32, *model32.blocks):
        m.cfg = cfg32
    fwd32 = forward(model32, lambda q, k, v, causal: A.mha_reference(
        q, k, v, causal=causal))
    del model32
    # Control: the forward with K1's mask dropped.
    bad = forward(model, lambda q, k, v, causal: causal_op(q, k, v,
                                                           causal=False))
    e_all, e_bad = rel_err(fwd, fwd32), rel_err(bad, fwd32)
    print(f"check {name} forward (K1, bf16) vs fp32, all {prompt_len} rows:"
          f" rel {e_all:.3e} (tol {TOL_LLAMA}; max |logit| "
          f"{fwd32.abs().max().item():.4f}); control with non-causal K1: "
          f"rel {e_bad:.3e} (must exceed the tol)")
    require(e_all < TOL_LLAMA, "llama forward against fp32")
    require(e_bad > TOL_LLAMA, "the forward gate sees a dropped mask")
    pps = cfg.max_seq // ps
    paged = llama.init_paged_kv_cache(cfg, 2 * pps + 1, ps, dev)
    dense = llama.init_kv_cache(cfg, 2, dev)
    tables = torch.zeros((2, pps), dtype=torch.int64, device=dev)
    # Slot 1 on a scattered page set, slot 0 parked.
    tables[1] = 1 + torch.randperm(2 * pps, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(3))[:pps]
    lg_p, _ = llama.prefill_chunk_paged(model, paged, tables, toks, 1, 0,
                                        prompt_len, ps)
    lg_d, _ = llama.prefill_chunk(model, dense, toks, 1, 0,
                                  last_idx=prompt_len - 1)
    ref, ref32 = fwd[-1], fwd32[-1]
    e_fwd, e32 = rel_err(lg_p, ref), rel_err(lg_p, ref32)
    e_dense, e_bad_last = rel_err(lg_p, lg_d), rel_err(lg_p, bad[-1])
    print(f"check {name} paged prefill, last row: vs forward (K1) rel "
          f"{e_fwd:.3e}, vs fp32 {e32:.3e} (tol {TOL_LLAMA}); vs dense "
          f"prefill {e_dense:.3e} (tol {TOL_LAYOUT}); argmax paged "
          f"{int(lg_p.argmax())} forward {int(ref.argmax())} fp32 "
          f"{int(ref32.argmax())}; the last row alone reads the non-causal "
          f"forward at {e_bad_last:.3e}")
    require(max(e_fwd, e32) < TOL_LLAMA and e_dense < TOL_LAYOUT,
            "llama paged prefill")
    tok = lg_p.argmax()
    agree = 0
    for step in range(4):
        pos = torch.tensor([cfg.max_seq, prompt_len + step], device=dev)
        both = torch.stack([torch.zeros_like(tok), tok])
        lg_p, _ = llama.decode_slots_paged(model, paged, tables, both, pos,
                                           ps)
        # The dense layout parks idle rows at max_seq - 1.
        lg_d, _ = llama.decode_slots(model, dense, both,
                                     pos.clamp_max(cfg.max_seq - 1))
        e = rel_err(lg_p[1], lg_d[1])
        same = int(lg_p[1].argmax()) == int(lg_d[1].argmax())
        agree += same
        print(f"check {name} paged decode step {step} vs dense: rel "
              f"{e:.3e} (tol {TOL_LAYOUT}); argmax agree {same}")
        require(e < TOL_LAYOUT, f"llama paged decode step {step}")
        tok = lg_p[1].argmax()
    print(f"{name} paged vs dense greedy argmax agreement {agree}/4")
    # Control: one more step with the slot's page 3 (tokens 48-63)
    # mapped to an unwritten page.
    bad_tables = tables.clone()
    bad_tables[1, 3] = min(set(range(1, 2 * pps + 1))
                           - set(tables[1].tolist()))
    pos = torch.tensor([cfg.max_seq, prompt_len + 4], device=dev)
    both = torch.stack([torch.zeros_like(tok), tok])
    lg_p, _ = llama.decode_slots_paged(model, paged, bad_tables, both, pos,
                                       ps)
    lg_d, _ = llama.decode_slots(model, dense, both,
                                 pos.clamp_max(cfg.max_seq - 1))
    e_bad = rel_err(lg_p[1], lg_d[1])
    print(f"control {name} paged decode with one page mapped to an "
          f"unwritten page vs dense: rel {e_bad:.3e} (must exceed tol "
          f"{TOL_LAYOUT})")
    require(e_bad > TOL_LAYOUT, "the decode gate sees a wrong page")
    del paged, dense, fwd, fwd32, bad

    # -- the engine on bench_llm's traffic ------------------------------------
    engine = SlotEngine(model, num_slots=8, chunk=128, page_size=ps,
                        decode_block=16, device=dev)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"engine: 8 slots, chunk 128, page {ps}, decode block 16, "
          f"{engine.pages_total} pages; warmup {time.perf_counter() - t0:.3f} s"
          f", block graphs captured {len(engine._graphs)}")
    require(sorted(engine._graphs) == [False, True],
            "warmup captures both block graphs")

    def run(label, n, prompts=None, clear=True, **sampling):
        prompts = prompts or [prompt() for _ in range(n)]
        engine.reset_decode_profile()
        t0 = time.perf_counter()
        handles = [engine.submit(p, max_new=max_new, **sampling)
                   for p in prompts]
        drain(engine, handles)
        dt = time.perf_counter() - t0
        res = [h.result(timeout=0) for h in handles]
        require(all(r.finish_reason == "length" and len(r.tokens) == max_new
                    for r in res), f"{label}: every request ends with "
                f"'length' and {max_new} tokens")
        ttft = sorted(1e3 * (r.timing["admission_s"] + r.timing["queue_s"]
                             + r.timing["prefill_s"]) for r in res)
        prof = engine.decode_profile()
        print(f"serve {label}: {n} requests, {n * max_new / dt:.1f} "
              f"tokens/s, {n / dt:.3f} req/s, {dt:.3f} s; TTFT ms median "
              f"{ttft[len(ttft) // 2]:.3f} max {ttft[-1]:.3f}; decode step "
              f"{prof['avg_step_ms']} ms over {prof['steps']} steps, "
              f"{prof['achieved_gbps']} GB/s = "
              f"{100 * prof['roofline_frac']:.3f}% of "
              f"{prof['hbm_gbps']:.0f} GB/s")
        # The pool drains: no slot maps a page, the index holds the rest.
        require(not engine._tables.any()
                and engine.pages_used - 1 == engine.prefix_cache_len(),
                f"{label}: pages at rest are radix-held")
        if clear:
            engine.clear_prefix_cache()
            require(engine.pages_used == 1, f"{label}: pool drains to the "
                    "scratch page")
        return res

    for conc in (1, 4, 8):
        run(f"c{conc}", conc)
    run("sustained", 32)

    # -- a prefix hit --------------------------------------------------------
    p = prompt()
    hits0 = engine.prefix_hits
    cold = run("prefix cold", 1, [p], clear=False)[0]
    warm = run("prefix warm", 1, [p])[0]
    matched = warm.timing["matched_tokens"]
    same = sum(a == b for a, b in zip(cold.tokens, warm.tokens))
    print(f"prefix hit: matched {matched} tokens (need >= 112), hits "
          f"{hits0} -> {engine.prefix_hits}; tokens equal to the cold run "
          f"{same}/{max_new}")
    require(engine.prefix_hits == hits0 + 1 and matched >= 112,
            "prefix hit")

    # -- a seeded sampled request, replayed ---------------------------------
    seeded = dict(temperature=0.8, seed=1234)
    s1 = run("sampled t0.8", 1, [p], **seeded)[0]
    s2 = run("sampled t0.8 replay", 1, [p], **seeded)[0]
    same = sum(a == b for a, b in zip(s1.tokens, cold.tokens))
    print(f"sampled (temperature 0.8, seed 1234): replay equal "
          f"{s1.tokens == s2.tokens}; tokens equal to the greedy run "
          f"{same}/{max_new}; block graphs {len(engine._graphs)}")
    require(s1.tokens == s2.tokens, "a seeded request replays its tokens")
    require(s1.tokens != cold.tokens, "temperature 0.8 samples")
    require(len(engine._graphs) == 2, "no graph captured after warmup")
    # Every decode step samples (greedy rows take the argmax): its cost.
    logits = torch.randn((engine.num_slots, cfg.vocab_size), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    temps = torch.full((engine.num_slots,), 0.8, device=dev)
    seeds = torch.arange(engine.num_slots, dtype=torch.int32, device=dev)
    qpos = torch.full((engine.num_slots,), 200, device=dev)
    t_sample = time_ms(torch, lambda: sampling.sample(logits, temps, seeds,
                                                      qpos))
    t_argmax = time_ms(torch, lambda: torch.argmax(logits, dim=-1))
    # The Gumbel noise with XLA's log (the sampler's) against the same
    # noise with torch.log, which differs from XLA's in the last bit.
    from ray_tpu_torch import random as trandom
    key = trandom.fold_in(trandom.prng_key(seeds), qpos)
    shape = (cfg.vocab_size,)
    tiny = torch.finfo(torch.float32).tiny
    t_noise = time_ms(torch, lambda: trandom.gumbel(key, shape))
    t_noise_torch = time_ms(torch, lambda: -torch.log(-torch.log(
        trandom.uniform(key, shape, minval=tiny))))
    print(f"sampler: sampling.sample on [{engine.num_slots}, "
          f"{cfg.vocab_size}] {t_sample:.4f} ms of device time, argmax "
          f"alone {t_argmax:.4f} ms; its Gumbel noise {t_noise:.4f} ms "
          f"(with torch.log instead of XLA's: {t_noise_torch:.4f} ms)")
    if profile_root is not None:
        profile_decode(torch, model, engine, profile_root)
    tp2_ref = tp2_reference(torch, llama, model, engine,
                            [prompt() for _ in range(TP2_REQUESTS)], toks,
                            tables)
    del engine, model
    torch.cuda.empty_cache()

    # -- LLMServer ----------------------------------------------------------
    server = LLMServer(model=name, num_slots=8, chunk=128, page_size=ps,
                       decode_block=16, seed=0, default_max_tokens=max_new)

    async def call_both(p):
        plain = await server({"prompt": p, "max_tokens": max_new})
        stream = [t async for t in await server(
            {"prompt": p, "max_tokens": max_new, "stream": True})]
        return plain, stream

    plain, stream = asyncio.run(call_both(p))
    require(plain["finish_reason"] == "length"
            and len(plain["tokens"]) == max_new
            and len(stream) == max_new, "LLMServer plain and streaming")
    print(f"LLMServer: plain {len(plain['tokens'])} tokens, streamed "
          f"{len(stream)}; equal to the engine's cold run "
          f"{sum(a == b for a, b in zip(plain['tokens'], cold.tokens))}"
          f"/{max_new}, stream equal to plain "
          f"{sum(a == b for a, b in zip(plain['tokens'], stream))}/{max_new}")
    stats = server.stats()
    print(f"LLMServer stats: {json.dumps(stats)}")
    server.engine.stop()
    del server
    torch.cuda.empty_cache()
    print(f"serving phase: {time.perf_counter() - t_phase:.3f} s wall")
    return k1, tp2_ref


def profile_decode(torch, model, engine, root):
    """One eager decode step of every slot (8 rows, each 16 pages in, at
    position 200) under torch.profiler: device time by op, beside the
    engine's graph-replayed step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import llama

    cfg, rows, ps = model.cfg, engine.num_slots, engine.page_size
    pps = cfg.max_seq // ps
    tables = torch.zeros((rows, pps), dtype=torch.int64, device=model.wte.device)
    tables[:, :16] = 1 + torch.arange(rows * 16, device=tables.device).reshape(
        rows, 16)
    toks = torch.ones((rows,), dtype=torch.int64, device=tables.device)
    pos = torch.full((rows,), 200, device=tables.device)
    for _ in range(2):
        llama.decode_slots_paged(model, engine._cache, tables, toks, pos, ps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        llama.decode_slots_paged(model, engine._cache, tables, toks, pos, ps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out = os.path.join(root, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke_profile_llama.txt"), "w") as f:
        f.write(table)
    print(f"profile of one eager decode step: {len(kernels)} kernels, "
          f"{dev_ms:.3f} ms of device time; by op (top 40) written to "
          "chiprun_out/chip_smoke_profile_llama.txt")


def profile_step(torch, step_fn, model, opt_state, step, data, root,
                 name="chip_smoke_profile.txt"):
    """One training step under torch.profiler; device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(model, opt_state, step, data)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    out = os.path.join(root, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        f.write(table)
    print(f"profile of one step (top 40 by device time) written to "
          f"chiprun_out/{name}")


def tensor_bytes(tree):
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def check_kernels(torch, A, shapes, gen, general=False):
    """K1, K2 and K3 (K4, K5 and K6 with ``general``) against their plain
    versions on the same inputs, at each (b, h, sq, sk, d, causal, dtype).
    The kernels run on the whole [b, h, s, d] tensors; their outputs are
    held against the plain versions a few (b, h) slices at a time, so the
    plain versions' fp32 scores stay near 2 GB a chunk. Phase 3's
    tolerances (fp32 inputs: TOL_VS_PLAIN_FP32). Returns each kernel's
    largest absolute error over the shapes."""
    kernels = A.GENERAL_WRAPPERS if general else A.KERNEL_WRAPPERS
    fwd, dkdv, dq_of = kernels
    dev = gen.device
    worst = {f.__name__: 0.0 for f in kernels}
    for (b, h, sq, sk, d, causal, dt) in shapes:
        q, do = (torch.randn((b, h, sq, d), generator=gen, device=dev,
                             dtype=dt) for _ in range(2))
        k, v = (torch.randn((b, h, sk, d), generator=gen, device=dev,
                            dtype=dt) for _ in range(2))
        sc = d ** -0.5
        o, lse = fwd(q, k, v, causal, sc)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = dkdv(q, k, v, do, lse, delta, causal, sc)
        dq = dq_of(q, k, v, do, lse, delta, causal, sc)
        flat = [t.reshape(1, b * h, *t.shape[2:])
                for t in (q, k, v, do, lse, delta, o, dk, dv, dq)]
        diff = dict.fromkeys(("o", "dk", "dv", "dq"), 0.0)
        top = dict.fromkeys(diff, 0.0)
        e_lse = 0.0

        def add(name, got, ref):
            diff[name] = max(diff[name],
                             (got.float() - ref.float()).abs().max().item())
            top[name] = max(top[name], ref.float().abs().max().item())

        per = max(1, (1 << 31) // (sq * sk * 4))
        for c0 in range(0, b * h, per):
            fq, fk, fv, fdo, flse, fdelta, fo, fdk, fdv, fdq = (
                t[:, c0:c0 + per] for t in flat)
            ro, rlse = A.mha_reference_with_lse(fq, fk, fv, causal, sc)
            add("o", fo, ro)
            e_lse = max(e_lse, (flse - rlse).abs().max().item())
            del ro, rlse
            rdk, rdv = A.flash_bwd_dkdv_reference(fq, fk, fv, fdo, flse,
                                                  fdelta, causal, sc)
            add("dk", fdk, rdk)
            add("dv", fdv, rdv)
            del rdk, rdv
            add("dq", fdq, A.flash_bwd_dq_reference(fq, fk, fv, fdo, flse,
                                                    fdelta, causal, sc))
        torch.cuda.synchronize()
        e = {n: diff[n] / max(top[n], 1e-12) for n in diff}
        tol = TOL_VS_PLAIN_FP32 if dt == torch.float32 else TOL_VS_PLAIN
        tag = "K4-K6" if general else "K1-K3"
        print(f"check {tag} [{b},{h},{sq},{sk},{d}] causal={causal} "
              f"{str(dt).split('.')[-1]} (plain a chunk of {min(per, b * h)}"
              f" heads): o {e['o']:.3e} lse abs {e_lse:.3e}; dk "
              f"{e['dk']:.3e} dv {e['dv']:.3e}; dq {e['dq']:.3e} (rel tol "
              f"{tol}, lse tol {TOL_LSE})")
        require(e_lse < TOL_LSE and max(e.values()) < tol,
                f"{tag} vs plain at [{b},{h},{sq},{sk},{d}] causal={causal}"
                f" {dt}")
        for f, a in zip(kernels, (diff["o"], max(diff["dk"], diff["dv"]),
                                  diff["dq"])):
            worst[f.__name__] = max(worst[f.__name__], a)
        del q, k, v, do, o, lse, delta, dk, dv, dq, flat
        torch.cuda.empty_cache()
    return worst


def general_launches(A):
    """Launches of K4-K6 since the counts were last reset."""
    return sum(f.launches for f in A.GENERAL_WRAPPERS)


def general_timings(torch, A, gen, shape, dtype=None, names=None):
    """K4, K5 and K6 (or ``names``) at causal ``shape`` [b, h, s, d] in
    ``dtype`` (fp32 by default): device time a call beside the plain
    version, the bound (the type's peak: fp32 on the CUDA cores, 16-bit on
    the tensor cores; bytes of the type) and SDPA's forward in the same
    dtype as the forward's yardstick."""
    import torch.nn.functional as F

    dtype = dtype or torch.float32
    b, h, s, d = shape
    sc = d ** -0.5
    q, k, v, do = (torch.randn(shape, generator=gen, device=gen.device,
                               dtype=dtype) for _ in range(4))
    o, lse = A.flash_fwd_general(q, k, v, True, sc)
    delta = (do.float() * o.float()).sum(-1)
    pairs = b * h * causal_pairs(s, s, True)
    elem, stat = b * h * s * d * q.element_size(), b * h * s * 4
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    rows = {
        "flash_fwd_general": (
            lambda: A.flash_fwd_general(q, k, v, True, sc),
            lambda: A.mha_reference_with_lse(q, k, v, True, sc),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            4 * d * pairs, 4 * elem + stat),
        "flash_bwd_dkdv_general": (
            lambda: A.flash_bwd_dkdv_general(q, k, v, do, lse, delta, True,
                                             sc),
            lambda: A.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, True,
                                               sc),
            None, 8 * d * pairs, 6 * elem + 2 * stat),
        "flash_bwd_dq_general": (
            lambda: A.flash_bwd_dq_general(q, k, v, do, lse, delta, True, sc),
            lambda: A.flash_bwd_dq_reference(q, k, v, do, lse, delta, True,
                                             sc),
            None, 6 * d * pairs, 5 * elem + 2 * stat),
    }
    out = {}
    tag = f"{list(shape)} {str(dtype).split('.')[-1]} causal"
    for name in names or rows:
        fn, plain, lib, flops, nbytes = rows[name]
        ms = time_ms(torch, fn)
        plain_ms = time_ms(torch, plain, warmup=1, reps=5)
        lib_ms = time_ms(torch, lib) if lib else None
        b_ms, b_by = bound(flops, nbytes, peak)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        print(f"time {name} {tag}: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms by {b_by} at {peak / 1e12:.0f} TFLOP/s "
              f"({100 * b_ms / ms:.1f}% of bound, {flops / ms / 1e9:.2f} "
              f"TFLOP/s); library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    if "flash_bwd_dkdv_general" in out and "flash_bwd_dq_general" in out:
        # The pair beside SDPA's backward (dq, dk, dv) in the same dtype
        # and the backward's bound (5 products), as phase 4 for K2+K3.
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        ref = F.scaled_dot_product_attention(*xs, is_causal=True)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
            ref, xs, do, retain_graph=True))
        pair_ms = (out["flash_bwd_dkdv_general"]["ms"]
                   + out["flash_bwd_dq_general"]["ms"])
        pair_bound, pair_by = bound(10 * d * pairs, 7 * elem + 2 * stat,
                                    peak)
        out["backward_pair"] = dict(ms=pair_ms, bound_ms=pair_bound,
                                    bound_by=pair_by,
                                    sdpa_backward_ms=sdpa_bwd)
        print(f"time K5+K6 {tag}: {pair_ms:.4f} ms; bound of the backward "
              f"(5 products) {pair_bound:.4f} ms by {pair_by} "
              f"({100 * pair_bound / pair_ms:.1f}% of bound); SDPA backward "
              f"(dq, dk, dv) {sdpa_bwd:.4f} ms; K5+K6 / SDPA backward "
              f"{pair_ms / sdpa_bwd:.3f}")
        del xs, ref
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return out


def long_s_timings(torch, A, gen):
    """K1, K2, K3 and SDPA's forward and backward at [1,16,16384,64] bf16
    causal (bench_long_context's longest point, one layer's attention):
    device time per call, bound as phase 4 computes it."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    b, h, s, d = 1, 16, 16384, 64
    sc = d ** -0.5
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, True, sc)
    delta = (do.float() * o.float()).sum(-1)
    pairs = b * h * causal_pairs(s, s, True)
    elem, stat = b * h * s * d * 2, b * h * s * 4
    rows = {
        "flash_fwd": (lambda: A.flash_fwd(q, k, v, True, sc),
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True),
                      4 * d * pairs, 4 * elem + stat),
        "flash_bwd_dkdv": (lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta,
                                                    True, sc), None,
                           8 * d * pairs, 6 * elem + 2 * stat),
        "flash_bwd_dq": (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta,
                                                True, sc), None,
                         6 * d * pairs, 5 * elem + 2 * stat),
    }
    out = {}
    for name, (fn, lib, flops, nbytes) in rows.items():
        ms = time_ms(torch, fn, warmup=2, reps=10)
        lib_ms = time_ms(torch, lib, warmup=2, reps=10) if lib else None
        b_ms, b_by = bound(flops, nbytes)
        out[name] = dict(shape=[b, h, s, d], causal=True, ms=ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        print(f"time {name} [{b},{h},{s},{d}] causal: {ms:.4f} ms; bound "
              f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / ms:.1f}% of bound); "
              f"{flops / ms / 1e9:.1f} TFLOP/s; library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = F.scaled_dot_product_attention(*xs, is_causal=True)
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        ref, xs, do, retain_graph=True), warmup=2, reps=10)
    pair_ms = out["flash_bwd_dkdv"]["ms"] + out["flash_bwd_dq"]["ms"]
    pair_bound, pair_by = bound(10 * d * pairs, 7 * elem + 2 * stat)
    print(f"time K2+K3 [{b},{h},{s},{d}] {pair_ms:.4f} ms; bound of the "
          f"backward {pair_bound:.4f} ms by {pair_by}; SDPA backward "
          f"{sdpa_bwd:.4f} ms; K1 / SDPA forward "
          f"{out['flash_fwd']['ms'] / out['flash_fwd']['library_ms']:.3f}, "
          f"K2+K3 / SDPA backward {pair_ms / sdpa_bwd:.3f}")
    out["sdpa_backward_ms"] = sdpa_bwd
    del q, k, v, do, o, lse, delta, xs, ref
    torch.cuda.empty_cache()
    return out


# The benchmark cells' LayerNorm shapes, [B S, d] bf16.
NORM_SHAPES = (("gpt2-1.5b.s1024-b16", 16 * 1024, 1600),
               ("gpt2-355m.s16384-b4", 4 * 16384, 1024))


def norm_phase(torch, gen):
    """Phase 4b: the LayerNorm kernels at each cell's shape against the
    plain version (through autograd; one rounding of the output's type
    apart at most, TOL_NORM), then timed forward and backward beside
    their bound (bytes read once and written once over the data sheet's
    bandwidth), the plain composite and F.layer_norm (``library_ms``,
    never called by the port)."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import norm

    dev = gen.device
    out = {}
    for cell, rows, d in NORM_SHAPES:
        x, dy = (torch.randn((rows, d), generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        scale, bias = (torch.randn(d, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(2))
        xs = [t.clone().requires_grad_() for t in (x, scale, bias)]
        refs = [t.clone().requires_grad_() for t in (x, scale, bias)]
        lib = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y = norm.layer_norm(*xs)
        ry = norm.layer_norm_reference(*refs)
        ly = F.layer_norm(lib[0], (d,), lib[1], lib[2], 1e-5)
        torch.autograd.backward([y, ry], [dy, dy], retain_graph=True)
        torch.cuda.synchronize()
        errs = [rel_err(y, ry)] + [rel_err(a.grad, r.grad)
                                   for a, r in zip(xs, refs)]
        print(f"check layer_norm [{rows},{d}] bf16 (y, dx, dscale, dbias) "
              f"vs plain autograd: rel " + ", ".join(f"{e:.3e}" for e in errs)
              + f" (tol {TOL_NORM})")
        require(max(errs) <= TOL_NORM, f"layer_norm [{rows},{d}]")
        _, mean, rstd = norm.layer_norm_fwd(x, scale, bias)
        elem, stat, par = rows * d * 2, rows * 4, d * 2
        rows_out = {
            "forward": dict(
                fn=lambda: norm.layer_norm_fwd(x, scale, bias),
                plain=lambda: norm.layer_norm_reference(x, scale, bias),
                library=lambda: F.layer_norm(x, (d,), scale, bias, 1e-5),
                nbytes=2 * elem + 2 * stat + 2 * par),
            "backward": dict(
                fn=lambda: norm.layer_norm_bwd(dy, x, scale, mean, rstd),
                plain=lambda: torch.autograd.grad(ry, refs, dy,
                                                  retain_graph=True),
                library=lambda: torch.autograd.grad(ly, lib, dy,
                                                    retain_graph=True),
                nbytes=3 * elem + 2 * stat + 3 * par),
        }
        out[cell] = {}
        for way, r in rows_out.items():
            ms = time_ms(torch, r["fn"])
            plain_ms = time_ms(torch, r["plain"], warmup=1, reps=5)
            lib_ms = time_ms(torch, r["library"])
            b_ms, _ = bound(0, r["nbytes"])
            out[cell][way] = dict(
                shape=[rows, d], ms=ms, bound_ms=b_ms, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=max(errs))
            print(f"time layer_norm {way} [{rows},{d}] bf16: {ms:.4f} ms; "
                  f"bound {b_ms:.4f} ms by bytes ({r['nbytes'] / 1e6:.1f} "
                  f"MB, {100 * b_ms / ms:.1f}% of bound); plain "
                  f"{plain_ms:.4f} ms; library {lib_ms:.4f} ms")
        del x, dy, scale, bias, xs, refs, lib, y, ry, ly, mean, rstd
        torch.cuda.empty_cache()
    return out


SSD_SHAPE = (8, 8192, 128, 64, 128, 256)  # b, S, heads, p, n, chunk


def ssd_inputs(torch, gen, b, s, h, p, n):
    """The mixer's layout: x, B and C split from one bf16 row of h p + 2 n
    a position; dt after a softplus, A = -exp of normals."""
    dev = gen.device
    xbc = torch.randn(b, s, h * p + 2 * n, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev) - 1.0)
    A = -torch.exp(torch.randn(h, generator=gen, device=dev))
    return x, dt, A, B, C


def ssd_phase(torch, gen, ptxas):
    """Phase 4c: the scan's kernels at the Granite cell's shape against the
    plain scan's fp32 autograd (y and the five gradients within TOL_SSD of
    each one's largest entry; one launch of each kernel forward, and each
    of the backward's), then the forward and the backward timed (device
    time) beside their bound, the plain version and ptxas's registers and
    spills."""
    from portbench import roofline_ssd
    from ray_tpu_torch.ops import ssd

    b, s, h, p, n, q = SSD_SHAPE
    x, dt, A, B, C = ssd_inputs(torch, gen, b, s, h, p, n)
    dy = torch.randn(b, s, h, p, generator=gen, device=gen.device)
    ins = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
    ssd.reset_counts()
    y = ssd.ssd(*ins, chunk=q)
    grads = torch.autograd.grad(y, ins, dy)
    counts = ssd.counts()
    refs = [t.detach().float().requires_grad_() for t in (x, dt, A, B, C)]
    yr = ssd.ssd_reference(*refs, chunk=q)
    want = torch.autograd.grad(yr, refs, dy)
    torch.cuda.synchronize()
    names = ("y", "dx", "ddt", "dA", "dB", "dC")
    errs = dict(zip(names, [rel_err(y, yr)] + [rel_err(a, r) for a, r in
                                               zip(grads, want)]))
    del ins, y, grads, refs, yr, want
    # The backward makes the entering states again (chunk_state and
    # state_pass forward) before its own five kernels.
    expect = {"chunk_state": 3, "state_pass": 3, "chunk_scan": 2,
              "chunk_dg": 1, "chunk_bc": 2}
    print(f"check ssd [{b},{s},{h},{p}] n {n} chunk {q} (bf16 x, B, C) vs "
          f"fp32 plain autograd: rel " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {TOL_SSD}); launches {counts} (expect {expect})")
    require(max(errs.values()) <= TOL_SSD, "ssd kernels vs plain")
    require(counts == expect, "ssd launches a call")
    y = ssd.ssd_kernel_forward(x, dt, A, B, C, q)[0]
    work = roofline_ssd.ssd_call(b, s, h, p, n, q)
    ways = {
        "forward": dict(
            fn=lambda: ssd.ssd_kernel_forward(x, dt, A, B, C, q),
            plain=lambda: ssd.ssd_reference(x, dt, A, B, C, q)),
        "backward": dict(
            fn=lambda: ssd.ssd_kernel_backward(dy, x, dt, A, B, C, q)),
    }
    out = dict(shape=[b, s, h, p, n, q], errs=errs)
    for way, r in ways.items():
        ms = time_ms(torch, r["fn"], reps=10)
        if way == "forward":
            with torch.no_grad():
                plain_ms = time_ms(torch, r["plain"], warmup=1, reps=3)
        else:
            refs = [t.detach().float().requires_grad_()
                    for t in (x, dt, A, B, C)]
            yr = ssd.ssd_reference(*refs, chunk=q)
            plain_ms = time_ms(torch, lambda: torch.autograd.grad(
                yr, refs, dy, retain_graph=True), warmup=1, reps=3)
            del refs, yr
        w = work["fwd" if way == "forward" else "bwd"]
        b_ms, by = bound(w["flops"], w["bytes"])
        out[way] = dict(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain_ms,
                        gflop=w["flops"] / 1e9, mb=w["bytes"] / 1e6)
        print(f"time ssd {way} [{b},{s},{h},{p}] n {n} chunk {q}: {ms:.4f} "
              f"ms; bound {b_ms:.4f} ms by {by} ({w['flops'] / 1e9:.1f} "
              f"GFLOP, {w['bytes'] / 1e6:.1f} MB; {100 * b_ms / ms:.2f}% of "
              f"bound); plain {plain_ms:.4f} ms")
    for lib in ("ssd_state", "ssd_scan", "ssd_grad"):
        for inst, r in ptxas[lib].items():
            print(f"ptxas {inst}: {r['registers']} registers, spill stores "
                  f"{r['spill_stores']} loads {r['spill_loads']}")
    del x, dt, A, B, C, dy, y
    torch.cuda.empty_cache()
    return out


def layer_norm_calls(label, n, layers=None, recompute=False):
    """The LayerNorm calls a step over the ``n`` steps since
    ``norm.reset_counts()``: the forward and backward kernels' launches and
    the calls that took the plain version. Given ``layers``, requires what
    a model of plain tensors makes: ln1 and ln2 a layer and lnf, each once
    forward (twice for ln1 and ln2 where ``recompute``) and once backward,
    all through the kernels."""
    from ray_tpu_torch.ops import norm

    got = dict(forward=norm.layer_norm_fwd.launches / n,
               backward=norm.layer_norm_bwd.launches / n,
               plain=norm.layer_norm.plain_calls / n)
    expect = None if layers is None else dict(
        forward=(4 if recompute else 2) * layers + 1,
        backward=2 * layers + 1, plain=0)
    print(f"{label}: LayerNorm calls a step {got}"
          + ("" if expect is None else f" (expect {expect})"))
    if expect is not None:
        require(got == expect, f"{label}: LayerNorm through the kernels, "
                               f"{expect} a step")
    return got


def c3_phase(torch, A, dev):
    """Fault C3 on the card: llama-tiny (fp32, head_dim 16) loss and
    gradients on CUDA against the CPU. The Hopper kernels take neither, so
    each attention call runs K4 in the forward and K5 and K6 in the
    backward. Returns the card's launches of K4-K6."""
    import copy

    from ray_tpu_torch.device import full_fp32
    from ray_tpu_torch.models import llama

    t_phase = time.perf_counter()
    cfg = llama.CONFIGS["llama-tiny"]
    cpu = llama.Llama(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (C3_BATCH, C3_SEQ + 1),
                           generator=torch.Generator().manual_seed(1))
    losses, launches = {}, {}
    with full_fp32():
        for name, model in (("cpu", cpu), ("card", card)):
            A.reset_launch_counts()
            loss = model.loss_fn({"tokens": tokens.to(model.wte.device)})
            loss.backward()
            losses[name] = loss.item()
            launches[name] = {f.__name__: f.launches
                              for f in A.GENERAL_WRAPPERS}
            require(all(f.launches == 0 for f in A.KERNEL_WRAPPERS),
                    f"llama-tiny ({name}) launches no Hopper kernel")
    torch.cuda.synchronize()
    e_loss = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    e_grad = max(rel_err(a.grad.cpu(), b.grad) for a, b in
                 zip(card.parameters(), cpu.parameters()))
    print(f"check C3: llama-tiny (fp32, head_dim {cfg.head_dim}) loss_fn on "
          f"the card {losses['card']:.7f}, CPU {losses['cpu']:.7f}, rel "
          f"{e_loss:.3e} (tol 1e-5); worst gradient rel {e_grad:.3e} (tol "
          f"1e-4); general kernel launches on the card {launches['card']} "
          f"(expect {cfg.num_layers} each, one a layer), on the CPU "
          f"{launches['cpu']}; {time.perf_counter() - t_phase:.3f} s")
    require(e_loss < 1e-5 and e_grad < 1e-4, "llama-tiny fp32 on the card")
    require(all(n == 0 for n in launches["cpu"].values())
            and all(n == cfg.num_layers for n in launches["card"].values()),
            "general kernel launches of llama-tiny")
    return launches["card"]


def granite_phase(torch, A, gen):
    """Phase 3d: K1-K3 on Granite 4.0-H's attention at the benchmark
    cell's shape and scale against the plain attention and its autograd,
    then one training step of the 10-layer cut with its launches counted.
    Returns the launches of each kernel in that step and each kernel's
    relative error at the shape (K1: o; K2: the larger of dk's and dv's;
    K3: dq)."""
    from ray_tpu_torch.models import granite_hybrid as gh
    from ray_tpu_torch.models.common import expand_kv_heads, param_count
    from ray_tpu_torch.ops import ssd
    from ray_tpu_torch.train.optim import adafactor
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    dev = gen.device
    cfg = gh.GraniteHybridConfig(
        num_hidden_layers=10, layer_types=gh.PUBLISHED_LAYER_TYPES[:10],
        experts_held=(0, 8), dtype=torch.bfloat16)
    batch, seq = 8, 8192
    heads, kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
    group, sc = heads // kv, cfg.attention_multiplier

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q = rand(batch, heads, seq, hd).requires_grad_()
    k, v = (rand(batch, kv, seq, hd).requires_grad_() for _ in range(2))
    do = rand(batch, heads, seq, hd)
    A.reset_launch_counts()
    ek, ev = expand_kv_heads(k, v, heads, group)
    o = A.attention(q, ek, ev, causal=True, scale=sc)
    o.backward(do)
    launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS}
    require(all(n == 1 for n in launches.values())
            and general_launches(A) == 0,
            f"granite attention: one launch of each of K1-K3, got "
            f"{launches}, general {general_launches(A)}")
    _, lse = A.flash_fwd(q.detach(), ek.detach(), ev.detach(), True, sc)
    del ek, ev
    diff = dict.fromkeys(("o", "dq", "dk", "dv"), 0.0)
    top = dict.fromkeys(diff, 0.0)
    e_lse = 0.0
    for i in range(batch):
        for g in range(kv):
            qs = slice(g * group, (g + 1) * group)
            rq = q.detach()[i:i + 1, qs].float().requires_grad_()
            rk, rv = (t.detach()[i:i + 1, g:g + 1].float().requires_grad_()
                      for t in (k, v))
            ro, rlse = A.mha_reference_with_lse(
                rq, *expand_kv_heads(rk, rv, group, group, q0=g * group,
                                     k0=g), True, sc)
            ro.backward(do[i:i + 1, qs].float())
            e_lse = max(e_lse, (lse[i:i + 1, qs] - rlse.detach()).abs()
                        .max().item())
            for name, got, ref in (
                    ("o", o[i:i + 1, qs], ro), ("dq", q.grad[i:i + 1, qs],
                                                 rq.grad),
                    ("dk", k.grad[i:i + 1, g:g + 1], rk.grad),
                    ("dv", v.grad[i:i + 1, g:g + 1], rv.grad)):
                ref = ref.detach()
                diff[name] = max(diff[name], (got.detach().float() - ref)
                                 .abs().max().item())
                top[name] = max(top[name], ref.abs().max().item())
            del ro, rlse, rq, rk, rv
    e = {n: diff[n] / max(top[n], 1e-12) for n in diff}
    print(f"check K1-K3 via attention() [{batch},{heads},{seq},{hd}] "
          f"(KV heads {kv} expanded) causal bf16 scale {sc}: o {e['o']:.3e} "
          f"(tol {TOL_VS_PLAIN}), lse abs {e_lse:.3e} (tol {TOL_LSE}); vs "
          f"fp32 plain autograd: dq {e['dq']:.3e} dk {e['dk']:.3e} dv "
          f"{e['dv']:.3e} (tol {TOL_VS_FP32})")
    require(e["o"] < TOL_VS_PLAIN and e_lse < TOL_LSE,
            "granite attention forward vs plain")
    require(max(e["dq"], e["dk"], e["dv"]) < TOL_VS_FP32,
            "granite attention gradients vs fp32 autograd")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    init, step_fn = build_train(
        lambda _g: gh.GraniteHybrid(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        lambda m, b: m.loss_fn(b), optimizer=adafactor(1e-4))
    model, opt_state, step = init(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    ssd.reset_counts()
    t0 = time.perf_counter()
    *_, met = step_fn(model, opt_state, step, {"tokens": tokens})
    loss = met["loss"].item()
    step_s = time.perf_counter() - t0
    n_attn = cfg.layer_types.count("attention")
    step_launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS}
    expect = {"flash_fwd": 2 * n_attn, "flash_bwd_dkdv": n_attn,
              "flash_bwd_dq": n_attn}
    print(f"granite-4.0-h-small 10-layer cut: {param_count(model)} "
          f"parameters, batch {batch} x S {seq}: first loss {loss:.4f} "
          f"(ln vocab {math.log(cfg.vocab_size):.3f}), first step "
          f"{step_s:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; launches "
          f"{step_launches} (expect {expect}: each of {n_attn} attention "
          f"layers K1 for the forward and its recompute, K2 and K3 once); "
          f"general kernels {general_launches(A)}")
    require(math.isfinite(loss)
            and abs(loss - math.log(cfg.vocab_size)) < 1.0,
            f"granite first loss {loss}")
    require(step_launches == expect and general_launches(A) == 0,
            "granite launch counts")
    n_mamba = cfg.layer_types.count("mamba")
    ssd_expect = {"chunk_state": 4 * n_mamba, "state_pass": 4 * n_mamba,
                  "chunk_scan": 3 * n_mamba, "chunk_dg": n_mamba,
                  "chunk_bc": 2 * n_mamba}
    print(f"granite step: scan launches {ssd.counts()} (expect {ssd_expect}"
          f": each of {n_mamba} Mamba layers forward, recomputed and "
          f"backward)")
    require(ssd.counts() == ssd_expect, "granite scan launch counts")
    del model, opt_state, tokens, met
    torch.cuda.empty_cache()
    print(f"phase 3d (granite): {time.perf_counter() - t_phase:.3f} s wall")
    return dict(launches=step_launches, ssd_launches=ssd.counts(),
                errs={"flash_fwd": e["o"],
                      "flash_bwd_dkdv": max(e["dk"], e["dv"]),
                      "flash_bwd_dq": e["dq"]})


def run_steps(torch, step_fn, state, data, warm, steps):
    """``warm`` training steps, then ``steps`` timed on the host clock
    ending in a fetch of the last loss: the one timing loop of every
    training phase. ``state`` is (model, opt_state, step); returns it,
    every loss and gradient norm (floats) and the timed seconds."""
    mets = []
    for i in range(warm + steps):
        if i == warm:
            mets[-1]["loss"].item()
            t0 = time.perf_counter()
        model, opt_state, step, met = step_fn(*state, data)
        state = (model, opt_state, step)
        mets.append(met)
    mets[-1]["loss"].item()
    elapsed = time.perf_counter() - t0
    return (state, [m["loss"].item() for m in mets],
            [m["grad_norm"].item() for m in mets], elapsed)


def adafactor_gpt2(torch, A, name, seq, batch, warm, steps,
                   profile_root=None):
    """bench.py's bench_15b recipe (``bench_long_context``'s too):
    ``CONFIGS[name]`` at ``max_seq = seq``, bf16 parameters
    (``cast_floating``), remat "mem2", ``adafactor(1e-4)`` without the
    fp32 master, bench.py's tokens; ``warm`` steps, then ``steps`` timed
    on the host clock ending in a fetch of the loss. Returns the figures
    and the launches of each kernel a step, LayerNorm's too."""
    import numpy as np

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.common import cast_floating, param_count
    from ray_tpu_torch.ops import norm
    from ray_tpu_torch.train.optim import adafactor
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    base = gpt2.CONFIGS[name]
    cfg = gpt2.GPT2Config(vocab_size=base.vocab_size, max_seq=seq,
                          num_layers=base.num_layers,
                          num_heads=base.num_heads, d_model=base.d_model,
                          dtype=torch.bfloat16, attention_impl="flash",
                          remat_policy="mem2")
    opt = adafactor(1e-4)
    init, step_fn = build_train(
        lambda g: cast_floating(gpt2.GPT2(cfg, g), torch.bfloat16),
        lambda m, b: m.loss_fn(b), optimizer=opt, master_fp32=False)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (batch, seq + 1))
    data = {"tokens": torch.from_numpy(tokens).cuda()}
    t0 = time.perf_counter()
    model, opt_state, step = init(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = param_count(model)
    state_b = tensor_bytes(opt_state)
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    norm.reset_counts()
    (model, opt_state, step), losses, _, elapsed = run_steps(
        torch, step_fn, (model, opt_state, step), data, warm, steps)
    n = warm + steps
    launches = {f.__name__: f.launches / n for f in A.KERNEL_WRAPPERS}
    general = general_launches(A)
    label = f"{name} seq {seq} batch {batch}"
    norm_calls = layer_norm_calls(label, n, cfg.num_layers, recompute=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = elapsed / steps * 1e3
    tok_s = batch * seq * steps / elapsed
    mfu = tok_s * gpt2.flops_per_token(cfg, seq) / PEAK_BF16_FLOPS
    print(f"{label}: {n_params} parameters ({n_params * 2 / 1e9:.3f} GB "
          f"bf16), mem2, adafactor(1e-4), no master; init {t_init:.3f} s; "
          f"adafactor state {state_b} bytes ({state_b / 1e6:.3f} MB) against "
          f"AdamW-bf16's 2 x 2 x N = {4 * n_params / 1e9:.3f} GB")
    print(f"{label} losses {losses}")
    print(f"{label} train: step {step_ms:.3f} ms, {tok_s:.1f} tokens/s, MFU "
          f"{100 * mfu:.3f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
          f"({gpt2.flops_per_token(cfg, seq) / 1e9:.4f} GFLOP a token), peak "
          f"memory {peak:.3f} GB; launches per step {launches} (expect "
          f"{cfg.num_layers} each); general kernels {general}")
    require(all(math.isfinite(x) for x in losses), f"{label}: finite losses")
    require(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
            f"{label}: first loss {losses[0]} near ln(vocab) = "
            f"{math.log(cfg.vocab_size):.3f}")
    require(all(v == cfg.num_layers for v in launches.values()),
            f"{label}: one launch of each kernel per layer per step")
    require(general == 0, f"{label}: no general kernel")
    if profile_root is not None:
        profile_step(torch, step_fn, model, opt_state, step, data,
                     profile_root, f"chip_smoke_profile_{name}_s{seq}.txt")
        profile_optimizer(torch, model, opt_state, opt, data)
    del model, opt_state, step_fn, init, data
    torch.cuda.empty_cache()
    print(f"{label} phase: {time.perf_counter() - t_phase:.3f} s wall")
    return dict(step_ms=step_ms, tokens_s=tok_s, mfu_pct=100 * mfu,
                peak_gb=peak, losses=losses, state_bytes=state_b,
                launches=launches, layer_norm_calls=norm_calls)


def profile_optimizer(torch, model, opt_state, opt, data):
    """One optimizer update and its ``p + u`` on the model's gradients
    under torch.profiler: the kernels it launches and their device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = list(model.parameters())
    model.loss_fn(data).backward()
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        updates, _ = opt.update(grads, opt_state, [p.detach() for p in params])
        for p, u in zip(params, updates):
            p.copy_(p + u)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"profile of one adafactor update over {len(params)} tensors "
          f"({len(opt_state['groups'])} leaves) and its p + u: "
          f"{len(kernels)} kernels, {dev_ms:.3f} ms of device time, "
          f"{1e3 * wall:.3f} ms of host wall time under the profiler")


def vit_phase(torch, A, profile_root=None):
    """ViT-B/16 at 224 x 224 (S = 197, head_dim 64, 12 layers, remat):
    bf16, fp32 master, default_optimizer, batch 64, images and labels from
    default_rng(0), 2 + 5 steps."""
    import numpy as np

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.models.common import param_count
    from ray_tpu_torch.ops import norm
    from ray_tpu_torch.train.optim import default_optimizer
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    cfg = vit.CONFIGS["vit-b16"]
    batch, warm, steps = 64, 2, 5
    init, step_fn = build_train(lambda g: vit.ViT(cfg, g),
                                lambda m, b: m.loss_fn(b),
                                optimizer=default_optimizer(),
                                master_fp32=True)
    rng = np.random.default_rng(0)
    data = {"image": torch.from_numpy(rng.standard_normal(
        (batch, cfg.image_size, cfg.image_size, 3), dtype=np.float32)).cuda(),
        "label": torch.from_numpy(rng.integers(0, cfg.num_classes,
                                               (batch,))).cuda()}
    model, opt_state, step = init(0)
    n_params = param_count(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    norm.reset_counts()
    (model, opt_state, step), losses, _, elapsed = run_steps(
        torch, step_fn, (model, opt_state, step), data, warm, steps)
    n = warm + steps
    launches = {f.__name__: f.launches / n for f in A.KERNEL_WRAPPERS}
    general = general_launches(A)
    norm_calls = layer_norm_calls("vit-b16", n, cfg.num_layers,
                                  recompute=cfg.remat)
    peak = torch.cuda.max_memory_allocated() / 1e9
    img_s = batch * steps / elapsed
    fpi = vit.flops_per_image(cfg, n_params)
    mfu = img_s * fpi / PEAK_BF16_FLOPS
    s = cfg.num_patches + 1
    print(f"vit-b16: {n_params} parameters, batch {batch}, 224 x 224, S {s}, "
          f"bf16 + fp32 master, default_optimizer, remat")
    print(f"vit-b16 losses {losses}")
    print(f"vit-b16 train: step {elapsed / steps * 1e3:.3f} ms, "
          f"{img_s:.1f} images/s, MFU {100 * mfu:.3f}% of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s (6N + 12·L·d·S a token at "
          f"S = {s}: {fpi / 1e9:.4f} GFLOP an image), peak memory "
          f"{peak:.3f} GB; launches per step {launches} (expect K1 "
          f"{2 * cfg.num_layers}, K2 and K3 {cfg.num_layers}); general "
          f"kernels {general}")
    require(all(math.isfinite(x) for x in losses), "vit-b16: finite losses")
    require(abs(losses[0] - math.log(cfg.num_classes)) < 0.5,
            f"vit-b16: first loss {losses[0]} near ln(classes) = "
            f"{math.log(cfg.num_classes):.3f}")
    require(launches == {"flash_fwd": 2 * cfg.num_layers,
                         "flash_bwd_dkdv": cfg.num_layers,
                         "flash_bwd_dq": cfg.num_layers},
            "vit-b16: K1 twice a layer, K2 and K3 once")
    require(general == 0, "vit-b16: no general kernel")
    if profile_root is not None:
        profile_step(torch, step_fn, model, opt_state, step, data,
                     profile_root, "chip_smoke_profile_vit.txt")
    del model, opt_state, step_fn, init, data
    torch.cuda.empty_cache()
    print(f"vit-b16 phase: {time.perf_counter() - t_phase:.3f} s wall")
    return dict(step_ms=elapsed / steps * 1e3, images_s=img_s,
                mfu_pct=100 * mfu, peak_gb=peak, launches=launches,
                layer_norm_calls=norm_calls)


def resnet_phase(torch):
    """resnet18-cifar (fp32, as its config) at batch 128 on 32 x 32
    images from default_rng(0), default_optimizer, 2 + 5 steps; the batch
    statistics carried from step to step."""
    import numpy as np

    from ray_tpu_torch.device import fp32_settings
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.models.common import param_count
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    cfg = resnet.CONFIGS["resnet18-cifar"]
    batch, warm, steps = 128, 2, 5
    rng = np.random.default_rng(0)
    data = {"image": torch.from_numpy(rng.standard_normal(
        (batch, 32, 32, 3), dtype=np.float32)).cuda(),
        "label": torch.from_numpy(rng.integers(0, cfg.num_classes,
                                               (batch,))).cuda()}
    stats = [resnet.init_stats(cfg, data["image"].device)]

    def loss_fn(model, b):
        loss, (new, _acc) = model.loss_fn(stats[0], b)
        stats[0] = {k: v.detach() for k, v in new.items()}
        return loss

    init, step_fn = build_train(lambda g: resnet.ResNet(cfg, g), loss_fn)
    model, opt_state, step = init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (model, opt_state, step), losses, _, elapsed = run_steps(
        torch, step_fn, (model, opt_state, step), data, warm, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = (stats[0]["stem_bn_var"] - 1).abs().max().item()
    print(f"resnet18-cifar: {param_count(model)} parameters, batch {batch}, "
          f"32 x 32, fp32, default_optimizer; fp32 settings: "
          f"{fp32_settings()}")
    print(f"resnet18-cifar losses {losses}")
    print(f"resnet18-cifar train: step {elapsed / steps * 1e3:.3f} ms, "
          f"{batch * steps / elapsed:.1f} images/s, peak memory {peak:.3f} "
          f"GB; stem BN variance moved by up to {moved:.4f} from 1")
    require(all(math.isfinite(x) for x in losses),
            "resnet18-cifar: finite losses")
    require(abs(losses[0] - math.log(cfg.num_classes)) < 0.5,
            f"resnet18-cifar: first loss {losses[0]} near ln(classes) = "
            f"{math.log(cfg.num_classes):.3f}")
    require(moved > 0, "resnet18-cifar: the batch statistics are carried")
    del model, opt_state, step_fn, init, data
    torch.cuda.empty_cache()
    print(f"resnet18-cifar phase: {time.perf_counter() - t_phase:.3f} s "
          "wall")
    return dict(step_ms=elapsed / steps * 1e3,
                images_s=batch * steps / elapsed, peak_gb=peak,
                first_loss=losses[0])




# -- the parallel layer: a mesh of one, MoE GPT-2, four ranks on the card ----

# Four ranks on the one card: ring-flash and the einsum ring at
# bench_ring_parity's shape (fp32), Ulysses (bf16), and one MoE layer at
# gpt2-124m's widths over ep = 4 (each rank's tokens, capacity factor 8 so
# that none is dropped).
RING_SHAPE = (1, 2, 8192, 64)
ULYSSES_SHAPE = (1, 8, 4096, 64)
MOE_EP_TOKENS, MOE_EP_CAPACITY = 1024, 8.0
TOL_RING = 1e-4   # ring bodies at sp = 4 against the plain attention (fp32)
TOL_EP = 1e-5     # MoE at ep = 4 against ep = 1 on the same tokens (fp32)
TOL_MOE_CARD = 1e-4  # one MoE layer, the card against the CPU (fp32)
SP4_TIMEOUT_S = 600


def gpt2_124m_config(gpt2, torch, **kw):
    """gpt2-124m's widths at seq 1024, bf16, the flash kernels, no remat
    unless ``kw`` sets a policy."""
    base = gpt2.CONFIGS["gpt2-124m"]
    return gpt2.GPT2Config(**dict(
        dict(vocab_size=base.vocab_size, max_seq=1024,
             num_layers=base.num_layers, num_heads=base.num_heads,
             d_model=base.d_model, dtype=torch.bfloat16,
             attention_impl="flash", remat_policy="none"), **kw))


# Phase 5i's MoE GPT-2, and the K1-K3 launches a layer and a step each
# policy implies: "dots" recomputes attention in the backward (K1 twice).
MOE_124M = dict(num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                moe_aux_weight=0.01)
PER_LAYER = {"none": dict(flash_fwd=1, flash_bwd_dkdv=1, flash_bwd_dq=1),
             "dots": dict(flash_fwd=2, flash_bwd_dkdv=1, flash_bwd_dq=1)}


def mesh_phases(torch, A, sched, data, ref, card="cuda", profile_root=None):
    """Phases 5h and 5i on a world of one: an in-process KV and
    ``Bootstrap(world_size=1)``, ``initialize_torch("nccl")`` and
    ``MeshSpec(dp=1).build()``. 5h trains gpt2-124m through
    ``build_sharded_train`` (the 5b phase's weights, tokens and recipe) and
    holds its 7 losses to ``ref["losses"]`` (``build_train``'s); 5i trains
    MoE GPT-2 at gpt2-124m's widths (8 experts, top-2, capacity 1.25)
    through it and holds one MoE layer on the card to the CPU, then trains
    it again under remat_policy "dots" (the JAX model's default): losses
    within TOL_REMAT_LOSS of the run without remat, a lower peak memory.
    Returns the three runs' records."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import norm
    from ray_tpu_torch.parallel.bootstrap import Bootstrap, InMemoryKV
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import prune_rules_for_mesh
    from ray_tpu_torch.train.optim import adamw_lowmem
    from ray_tpu_torch.train.step import build_sharded_train

    bs = Bootstrap(InMemoryKV(), world_size=1, session="chip_smoke")
    bs.claim_rank()
    bs.coordinator_address()
    bs.initialize_torch("nccl")
    try:
        mesh = MeshSpec(dp=1).build()
        rules = prune_rules_for_mesh(mesh)
        print(f"mesh of one: {dist.get_backend()} world "
              f"{dist.get_world_size()}, DeviceMesh {mesh.mesh_dim_names} "
              f"shape {tuple(mesh.mesh.shape)} on {mesh.device_type}")
        out = {}
        for name, cfg in (
                ("sharded", gpt2_124m_config(gpt2, torch)),
                ("moe", gpt2_124m_config(gpt2, torch, **MOE_124M)),
                ("moe_dots", gpt2_124m_config(gpt2, torch, **MOE_124M,
                                              remat_policy="dots"))):
            t_phase = time.perf_counter()
            init, step_fn, _ = build_sharded_train(
                lambda g, cfg=cfg: gpt2.GPT2(cfg, g),
                lambda m, b: m.loss_fn(b, rules), mesh,
                optimizer=adamw_lowmem(sched), master_fp32=True)
            state = init(0)
            n_params = sum(p.numel() for p in state[0].parameters())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            norm.reset_counts()
            state, losses, norms, elapsed = run_steps(
                torch, step_fn, state, data, 2, 5)
            launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS}
            general = general_launches(A)
            # DTensors take the plain version, the MoE layer's local
            # tensors inside its smap region the kernels: recorded only.
            norm_calls = layer_norm_calls(name, 7)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            rec = mesh_record(torch, gpt2, cfg, name, losses, norms, elapsed,
                              launches, general, peak_gb, n_params,
                              dict(ref, moe=out.get("moe")))
            rec["layer_norm_calls"] = norm_calls
            if name == "moe":
                if profile_root:
                    rec["profile"] = profile_moe_step(
                        torch, step_fn, state, data, profile_root, cfg)
                rec["layer_check"] = moe_layer_check(torch, cfg, state[0],
                                                     card)
            del state
            torch.cuda.empty_cache()
            print(f"phase 5{'h' if name == 'sharded' else 'i'} ({name}): "
                  f"{time.perf_counter() - t_phase:.3f} s wall")
            out[name] = rec
    finally:
        dist.destroy_process_group()
    return out


def mesh_record(torch, gpt2, cfg, name, losses, norms, elapsed, launches,
                general, peak_gb, n_params, ref):
    """Gates and numbers of one mesh-of-one training run."""
    batch, seq = ref["batch"], ref["seq"]
    n = len(losses)
    step_ms = elapsed / (n - 2) * 1e3
    tok_s = batch * seq * (n - 2) / elapsed
    print(f"{name}: {n_params} parameters; losses {losses}")
    print(f"{name}: grad norms {norms}")
    require(all(math.isfinite(x) for x in losses + norms),
            f"{name}: finite losses")
    expect = {k: n * cfg.num_layers * v
              for k, v in PER_LAYER[cfg.remat_policy].items()}
    print(f"{name}: launches over {n} steps {launches} (expect {expect}: "
          f"remat_policy {cfg.remat_policy!r}); general kernels {general}")
    require(launches == expect, f"{name}: launch counts")
    require(general == 0, f"{name}: no general kernel")
    rec = dict(step_ms=step_ms, tokens_s=tok_s, peak_gb=peak_gb,
               losses=losses, launches_per_step={
                   k: v // n for k, v in launches.items()})
    if name == "sharded":
        diffs = [abs(a - b) for a, b in zip(losses, ref["losses"])]
        bit_equal = losses == ref["losses"]
        print(f"sharded gpt2-124m (build_sharded_train, mesh of one): step "
              f"{step_ms:.3f} ms, {tok_s:.1f} tokens/s (build_train: "
              f"{ref['step_ms']:.3f} ms); losses against build_train's: "
              f"largest |difference| {max(diffs):.3e} (tol "
              f"{TOL_REMAT_LOSS}), bit-equal {bit_equal}")
        require(max(diffs) < TOL_REMAT_LOSS,
                "sharded gpt2-124m losses equal build_train's")
        rec.update(max_loss_diff=max(diffs), bit_equal=bit_equal)
        return rec
    # MoE: the first loss near ln(vocab) plus the router term at balance
    # (aux of a layer ~1: experts x sum(1/E x 1/E)).
    first = math.log(cfg.vocab_size) + cfg.moe_aux_weight
    require(abs(losses[0] - first) < 1.0,
            f"moe: first loss {losses[0]} near ln(vocab) + aux weight = "
            f"{first:.3f}")
    d, m, L = cfg.d_model, cfg.mlp_dim, cfg.num_layers
    active = n_params - L * (cfg.num_experts - cfg.moe_top_k) * 2 * d * m
    flops_tok = 6.0 * active + 12 * L * d * seq
    mfu = tok_s * flops_tok / PEAK_BF16_FLOPS
    print(f"moe gpt2 (gpt2-124m widths, {cfg.num_experts} experts, top-"
          f"{cfg.moe_top_k}, capacity {cfg.moe_capacity_factor}): step "
          f"{step_ms:.3f} ms, {tok_s:.1f} tokens/s, MFU {100 * mfu:.3f}% "
          f"on the active parameters ({active} of {n_params}; 6 x active + "
          f"12 L d S a token, the router and the one-hot dispatch/combine "
          f"einsums not counted, against {PEAK_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s), peak memory {peak_gb:.3f} GB")
    rec.update(mfu_pct=100 * mfu, active_params=active, params=n_params)
    if name == "moe_dots":
        plain = ref["moe"]
        diffs = [abs(a - b) for a, b in zip(losses, plain["losses"])]
        print(f"moe gpt2 under remat_policy 'dots': step {step_ms:.3f} ms "
              f"against {plain['step_ms']:.3f} ms without remat; peak "
              f"memory {peak_gb:.3f} GB against {plain['peak_gb']:.3f} GB; "
              f"losses against no remat: largest |difference| "
              f"{max(diffs):.3e} (tol {TOL_REMAT_LOSS})")
        require(max(diffs) < TOL_REMAT_LOSS,
                "moe gpt2 'dots' losses equal the run without remat")
        require(peak_gb < plain["peak_gb"],
                "moe gpt2 'dots' peak memory below the run without remat")
        rec.update(max_loss_diff=max(diffs))
    return rec


def profile_moe_step(torch, step_fn, state, data, root, cfg):
    """One MoE GPT-2 step under torch.profiler, its device time split into
    the one-hot einsums (GEMMs with an operand of experts x capacity
    columns: dispatch, combine, and the combine weights), the expert
    products (batched GEMMs over [experts, capacity, ...]), attention (the
    flash kernels) and the rest; written to
    chiprun_out/chip_smoke_profile_moe.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step_fn(*state, data)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    tokens = data["tokens"].shape[0] * (data["tokens"].shape[1] - 1)
    cap = -(-max(1, int(cfg.moe_capacity_factor * tokens * cfg.moe_top_k
                        / cfg.num_experts)) // 8) * 8
    ec = cfg.num_experts * cap
    split = dict(one_hot=0.0, experts=0.0, attention=0.0, other=0.0)
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type == DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        dims = {d for shape in e.input_shapes for d in shape}
        gemm = e.key in ("aten::mm", "aten::bmm", "aten::addmm")
        if gemm and ec in dims:
            split["one_hot"] += us
        elif gemm and cap in dims and cfg.num_experts in dims:
            split["experts"] += us
        else:
            split["other"] += us
    kernels = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    flash = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "flash" in e.key)
    # The flash kernels are launched through ctypes, outside any aten op:
    # they land in "other" above.
    split["attention"] = flash
    split["other"] = max(0.0, kernels - split["one_hot"] - split["experts"]
                         - flash)
    out = os.path.join(root, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke_profile_moe.txt"), "w") as f:
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=40))
    ms = {k: v / 1e3 for k, v in split.items()}
    print(f"profile of one moe step: {kernels / 1e3:.3f} ms of device time "
          f"in {wall_ms:.3f} ms (profiled); " + ", ".join(
              f"{k} {v:.3f} ms ({100 * v * 1e3 / max(kernels, 1e-9):.1f}%)"
              for k, v in ms.items())
          + "; table in chiprun_out/chip_smoke_profile_moe.txt")
    return dict(device_ms=kernels / 1e3, wall_ms=wall_ms, **ms)


def moe_layer_check(torch, cfg, model, card="cuda"):
    """Layer 0's MoE FFN (fp32, its weights as the model holds them) on
    8 x 1024 tokens of a seeded input, on the card and on the CPU: the
    same expert choices for every token, output and aux within
    TOL_MOE_CARD."""
    from ray_tpu_torch.device import full_fp32
    from ray_tpu_torch.parallel.moe import moe_ffn_local, router_topk

    blk = model.blocks[0]
    ws = [getattr(blk, n).to_local().detach().float()
          for n in ("router_w", "moe_in_w", "moe_out_w")]
    x = torch.randn(8 * 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
              capacity_factor=cfg.moe_capacity_factor, axis_name=None)
    res = {}
    with full_fp32():
        for where, dev in (("card", card), ("cpu", "cpu")):
            w = [t.to(dev) for t in ws]
            xd = x.to(dev)
            _, idx, probs = router_topk(xd @ w[0], cfg.moe_top_k)
            out, aux = moe_ffn_local(xd, *w, **kw)
            res[where] = (idx.cpu(), probs.cpu(), out.cpu(), aux.cpu())
    (ic, pc, oc, ac), (ih, ph, oh, ah) = res["card"], res["cpu"]
    flips = (ic != ih).any(-1)
    e_out, e_aux = rel_err(oc, oh), abs(ac.item() - ah.item()) / abs(
        ah.item())
    print(f"moe layer 0, card vs CPU on {x.shape[0]} tokens: choices "
          f"differ on {int(flips.sum())} tokens; output rel {e_out:.3e}, "
          f"aux rel {e_aux:.3e} (tol {TOL_MOE_CARD})")
    if flips.any():
        top = ph[flips].sort(-1, descending=True).values
        margins = (top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k])
        print(f"moe layer 0: flipped tokens' CPU probability margins "
              f"{margins.tolist()}")
    require(not flips.any(), "moe layer 0 routes every token as the CPU")
    require(e_out < TOL_MOE_CARD and e_aux < TOL_MOE_CARD,
            "moe layer 0 output and aux on the card")
    return dict(max_abs_err=e_out, aux_rel_err=e_aux,
                tokens=int(x.shape[0]))


# Phase 6b: llama-1b at tp = 2 as two ranks on the one card. Traffic: 4
# requests of 128-token prompts, 64 new tokens. A tp2 token must equal
# tp1's up to the first step at which tp1's top-2 logit margin is below
# TP2_MARGIN_FACTOR times the largest |tp2 - tp1| logit difference
# measured on the check rows (the bf16 sums of the row-parallel products
# run in another order, so near ties may break the other way).
TP2_REQUESTS, TP2_NEW = 4, 64
TP2_MARGIN_FACTOR = 4.0
TP2_FAULT_LAYERS = (0, 11, 21)  # the w_down sum skipped on one of these
TP2_TIMEOUT_S = 600


def tp2_reference(torch, llama, model, engine, prompts, check_toks, tables):
    """What phase 6b holds its tp2 runs to, from phase 6's tp1 model and
    engine (same weights): the engine's greedy tokens for ``prompts`` and
    its decode step; tp1's top-2 logit margins at each of those steps (the
    same tokens teacher-forced through the paged functions); and, on the
    128-token check prompt in phase 6's page tables, the paged prefill's
    last row and four chained paged decode steps (tokens chained from the
    fp32 run) in fp32 (the same bf16-valued weights, fp32 activations) and
    in bf16."""
    cfg, dev, ps = model.cfg, check_toks.device, engine.page_size
    pps = cfg.max_seq // ps
    engine.reset_decode_profile()
    handles = [engine.submit(p, max_new=TP2_NEW) for p in prompts]
    drain(engine, handles)
    tokens = [h.result(timeout=0).tokens for h in handles]
    step_ms = engine.decode_profile()["avg_step_ms"]
    engine.clear_prefix_cache()
    n = len(prompts)
    pool = llama.init_paged_kv_cache(cfg, n * pps + 1, ps, dev)
    tab = (1 + torch.arange(n * pps, device=dev)).reshape(n, pps)
    steps = [torch.stack([llama.prefill_chunk_paged(
        model, pool, tab, torch.tensor(p, device=dev), i, 0, len(p), ps)[0]
        for i, p in enumerate(prompts)])]
    toks = torch.tensor(tokens, device=dev)
    for j in range(TP2_NEW - 1):
        pos = torch.full((n,), len(prompts[0]) + j, device=dev)
        steps.append(llama.decode_slots_paged(model, pool, tab, toks[:, j],
                                              pos, ps)[0])
    logits = torch.stack(steps, 1).float()
    top2 = logits.topk(2, dim=-1)
    margins = (top2.values[..., 0] - top2.values[..., 1]).cpu()
    forced_idx = top2.indices[..., 0].cpu()
    forced = int((top2.indices[..., 0] == toks).sum())
    del pool, steps, logits
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = copy.deepcopy(model).float()
    for m in (model32, *model32.blocks):
        m.cfg = cfg32
    rows = {"fp32": [], "bf16": []}
    runs = (("fp32", model32), ("bf16", model))
    pools = {k: llama.init_paged_kv_cache(m.cfg, 2 * pps + 1, ps, dev)
             for k, m in runs}
    for k, m in runs:
        rows[k].append(llama.prefill_chunk_paged(
            m, pools[k], tables, check_toks, 1, 0, len(check_toks),
            ps)[0].float())
    chain = []
    for step in range(4):
        tok = rows["fp32"][-1].argmax()
        chain.append(tok)
        both = torch.stack([torch.zeros_like(tok), tok])
        pos = torch.tensor([cfg.max_seq, len(check_toks) + step], device=dev)
        for k, m in runs:
            rows[k].append(llama.decode_slots_paged(
                m, pools[k], tables, both, pos, ps)[0][1].float())
    del model32, pools
    torch.cuda.empty_cache()
    print(f"tp1 reference for phase 6b: {n} requests x {TP2_NEW} tokens, "
          f"decode step {step_ms} ms; teacher-forced argmax equal to the "
          f"engine's tokens {forced}/{n * TP2_NEW}; top-2 margins: median "
          f"{margins.median().item():.4f}, smallest "
          f"{margins.min().item():.4f}")
    return dict(prompts=prompts, tokens=tokens, tp1_step_ms=step_ms,
                margins=margins, forced=forced_idx, check=check_toks.cpu(),
                tables=tables.cpu(),
                chain=torch.stack(chain).cpu(),
                ref32=torch.stack(rows["fp32"]).cpu(),
                ref16=torch.stack(rows["bf16"]).cpu())


def tp2_phase(torch, ref, device="cuda"):
    """Phase 6b: llama-1b (phase 6's weights) served tp-sharded by two
    spawned ranks on the one card (a gloo group, each rank on cuda:0, as
    phase 5j). Gates: the tp2 paged prefill's last row and four chained
    decode steps within TOL_LLAMA of the fp32 run, with the w_down sum
    skipped on one layer (each of TP2_FAULT_LAYERS in turn) and with each
    rank attending to the other's KV heads reading above it; the engine's
    greedy tokens equal to tp1's up to the first small margin
    (TP2_MARGIN_FACTOR), and tp1's tokens teacher-forced through tp2
    giving tp1's argmax wherever the margin is wide; each rank about half of tp1's parameter bytes
    and exactly half of its KV pool; no CUDA graph captured; LLMServer
    refusing tp=2 on one card; then llama-tiny fp32, tp1 against tp2 on
    the card, greedy and seeded-sampled tokens bit-equal (bench.py's tp2
    check). Prints the decode step at tp2 beside tp1's."""
    t_phase = time.perf_counter()
    world = 2
    recs = run_ranks(_tp2_rank, world, (device, ref), TP2_TIMEOUT_S,
                     "tp2 ranks on the card")
    r0, r1 = recs[0], recs[1]
    for r in range(world):
        print(f"tp2 rank {r}: " + "; ".join(
            f"{k} {v}" for k, v in recs[r].items()
            if k not in ("tokens", "forced")))
    checks = r0["checks"]
    require(all(e < TOL_LLAMA for e in checks["vs_fp32"]),
            f"tp2 paged prefill and decode against fp32 (tol {TOL_LLAMA})")
    require(r0["checks"] == r1["checks"], "both ranks see the same logits")
    for name, e in r0["faults"].items():
        require(e > TOL_LLAMA, f"the tp2 gate sees the fault {name} "
                               f"({e:.3e} against {TOL_LLAMA})")
    delta = max(checks["vs_tp1_bf16_abs"])
    limit = TP2_MARGIN_FACTOR * delta
    checked = equal = 0
    for i, (t1, t2) in enumerate(zip(ref["tokens"], r0["tokens"])):
        small = [j for j, m in enumerate(ref["margins"][i].tolist())
                 if m < limit]
        upto = small[0] if small else len(t1)
        checked += upto
        equal += sum(a == b for a, b in zip(t1, t2))
        require(t1[:upto] == t2[:upto],
                f"tp2 request {i}: tokens equal to tp1's up to step {upto}")
    print(f"tp2 engine tokens: equal to tp1's {equal}/{TP2_REQUESTS * TP2_NEW};"
          f" gated steps {checked} (up to each request's first margin "
          f"below {limit:.4f} = {TP2_MARGIN_FACTOR} x the largest |tp2 - "
          f"tp1| logit difference {delta:.4f})")
    wide = ref["margins"] >= limit
    forced_equal = int((r0["forced"] == ref["forced"])[wide].sum())
    print(f"tp1's tokens teacher-forced through tp2: argmax equal to tp1's "
          f"at {forced_equal} of the {int(wide.sum())} steps whose tp1 "
          f"margin is at least {limit:.4f}, and at "
          f"{int((r0['forced'] == ref['forced']).sum())} of all "
          f"{TP2_REQUESTS * TP2_NEW}")
    require(forced_equal == int(wide.sum()),
            "tp2's argmax equals tp1's wherever tp1's margin is wide")
    for r, rec in recs.items():
        require(0.49 < rec["param_bytes_frac"] < 0.51,
                f"rank {r} holds about half of tp1's parameter bytes")
        require(rec["kv_pool_frac"] == 0.5,
                f"rank {r} holds half of the KV pool")
    require(r0["graphs"] == 0, "no CUDA graph captured at tp2")
    require(r0["server_refused"], "LLMServer(tp=2) refused on one card")
    require(r0["tiny_greedy_equal"] and r0["tiny_sampled_equal"],
            "llama-tiny fp32 on the card: tp2 tokens bit-equal to tp1's")
    print(f"llama-1b tp2 on {smi_line()}: decode step {r0['step_ms']} ms "
          f"(two gloo ranks sharing the card, sums and gathers through "
          f"host memory) against tp1's {ref['tp1_step_ms']} ms (one rank, "
          f"CUDA graphs); phase 6b {time.perf_counter() - t_phase:.3f} s "
          f"wall")


def _tp2_rank(rank, world, store, out, device, ref):
    """One of phase 6b's ranks (a spawned process)."""
    import pickle
    import traceback

    try:
        out.put((rank, pickle.dumps(_tp2_body(rank, world, store, device,
                                              ref)), None))
    except BaseException:  # reported to the parent, which fails the phase
        out.put((rank, None, traceback.format_exc()))


def _tp2_body(rank, world, store, device, ref):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.device import full_fp32
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.llm.serve import LLMServer
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.collective import ppermute
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import use_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    sync = lambda: None
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev, sync = torch.device("cuda", 0), torch.cuda.synchronize
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    rec = {}
    try:
        mesh = MeshSpec(tp=world).build(dev.type)
        cfg = llama.CONFIGS["llama-1b"]
        ps = 16
        pps = cfg.max_seq // ps
        model = llama.Llama(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev).to(cfg.dtype).requires_grad_(False)
        full_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters())
        engine = SlotEngine(model, num_slots=8, chunk=128, page_size=ps,
                            decode_block=4, mesh=mesh, device=dev)
        rules = engine._rules
        local = {p.to_local().untyped_storage().data_ptr():
                 p.to_local().untyped_storage().nbytes()
                 for p in model.parameters()}
        rec["param_bytes_frac"] = sum(local.values()) / full_bytes
        kv = engine._cache["kv"]
        tp1_pool = (cfg.num_layers * 2 * engine.pages_total * ps
                    * cfg.num_kv_heads * cfg.head_dim * 2)
        rec["kv_pool_frac"] = kv.numel() * kv.element_size() / tp1_pool

        check = ref["check"].to(dev)
        tables = ref["tables"].to(dev)
        ref32, ref16 = ref["ref32"].to(dev), ref["ref16"].to(dev)

        def run_check(n_steps):
            """The paged prefill's last row, then ``n_steps`` decode steps
            on the fp32 chain's tokens, on a fresh pool."""
            pool = llama.init_paged_kv_cache(cfg, 2 * pps + 1, ps, dev,
                                             shards=world)
            rows = [llama.prefill_chunk_paged(
                model, pool, tables, check, 1, 0, len(check), ps, rules)[0]]
            for step in range(n_steps):
                tok = ref["chain"][step].to(dev)
                both = torch.stack([torch.zeros_like(tok), tok])
                pos = torch.tensor([cfg.max_seq, len(check) + step],
                                   device=dev)
                rows.append(llama.decode_slots_paged(
                    model, pool, tables, both, pos, ps, rules)[0][1])
            return torch.stack(rows).float()

        got = run_check(4)
        sync()
        rec["checks"] = dict(
            vs_fp32=[rel_err(a, b) for a, b in zip(got, ref32)],
            vs_tp1_bf16=[rel_err(a, b) for a, b in zip(got, ref16)],
            vs_tp1_bf16_abs=[(a - b).abs().max().item()
                             for a, b in zip(got, ref16)],
            argmax_equal_fp32=[int(a.argmax()) == int(b.argmax())
                               for a, b in zip(got, ref32)])
        # Planted faults, on the prefill's last row.
        faults = {}
        tp_sum = llama._tp_sum
        for layer in TP2_FAULT_LAYERS:
            calls = [0]

            def skipping(x, sh, layer=layer, calls=calls):
                calls[0] += 1
                # embedding (call 1), then wo and w_down of every layer
                return x if calls[0] == 3 + 2 * layer else tp_sum(x, sh)
            llama._tp_sum = skipping
            try:
                faults[f"w_down sum skipped on layer {layer}"] = rel_err(
                    run_check(0)[0], ref32[0])
            finally:
                llama._tp_sum = tp_sum
        attend = llama._gqa_paged_attention

        def swapped(q, kv, mask):
            with use_mesh(mesh):
                other = ppermute(kv, "tp", [(0, 1), (1, 0)])
            return attend(q, other, mask)
        llama._gqa_paged_attention = swapped
        try:
            faults["each rank attends to the other's KV heads"] = rel_err(
                run_check(0)[0], ref32[0])
        finally:
            llama._gqa_paged_attention = attend
        rec["faults"] = faults
        # tp1's tokens teacher-forced through the tp2 paged functions.
        n = len(ref["prompts"])
        pool = llama.init_paged_kv_cache(cfg, n * pps + 1, ps, dev,
                                         shards=world)
        tab = (1 + torch.arange(n * pps, device=dev)).reshape(n, pps)
        steps = [torch.stack([llama.prefill_chunk_paged(
            model, pool, tab, torch.tensor(p, device=dev), i, 0, len(p), ps,
            rules)[0].argmax() for i, p in enumerate(ref["prompts"])])]
        toks = torch.tensor(ref["tokens"], device=dev)
        for j in range(TP2_NEW - 1):
            pos = torch.full((n,), len(ref["prompts"][0]) + j, device=dev)
            steps.append(llama.decode_slots_paged(
                model, pool, tab, toks[:, j], pos, ps, rules)[0].argmax(-1))
        rec["forced"] = torch.stack(steps, 1).cpu()
        del pool

        # The engine on 4 requests.
        if rank == 0:
            engine.reset_decode_profile()
            t0 = time.perf_counter()
            handles = [engine.submit(p, max_new=TP2_NEW)
                       for p in ref["prompts"]]
            drain(engine, handles)
            rec["wall_s"] = time.perf_counter() - t0
            res = [h.result(timeout=0) for h in handles]
            rec["tokens"] = [r.tokens for r in res]
            prof = engine.decode_profile()
            rec["step_ms"] = prof["avg_step_ms"]
            rec["decode_profile"] = prof
            rec["graphs"] = len(engine._graphs)
            engine.stop()
            # One card: refused before any collective.
            try:
                LLMServer(model="llama-tiny", tp=world, device=device)
                rec["server_refused"] = False
            except ValueError as e:
                rec["server_refused"] = "devices" in str(e)
        else:
            engine.follow()
        del engine, model
        torch.cuda.empty_cache()

        # bench.py's tp2 check: llama-tiny fp32, tp1 against tp2.
        tiny = llama.CONFIGS["llama-tiny"]
        prompt = [int(t) for t in np.random.default_rng(11).integers(
            1, tiny.vocab_size, size=17)]
        kw = dict(num_slots=2, chunk=8, page_size=8, decode_block=2,
                  device=dev)
        sampled = dict(temperature=0.7, seed=99)

        def tiny_model():
            return llama.Llama(tiny, torch.Generator(device=dev).manual_seed(
                1), dev).requires_grad_(False)

        def tokens(eng, **s):
            h = eng.submit(prompt, max_new=12, **s)
            drain(eng, [h])
            return h.result(timeout=0).tokens

        with full_fp32():
            tp = SlotEngine(tiny_model(), mesh=mesh, **kw)
            if rank == 0:
                one = SlotEngine(tiny_model(), **kw)
                t1, s1 = tokens(one), tokens(one, **sampled)
                t2, s2 = tokens(tp), tokens(tp, **sampled)
                rec.update(tiny_greedy_equal=t1 == t2,
                           tiny_sampled_equal=s1 == s2,
                           tiny_tokens=dict(tp1=t1, tp2=t2, tp1_sampled=s1,
                                            tp2_sampled=s2))
                tp.stop()
            else:
                tp.follow()
    finally:
        dist.destroy_process_group()
    return rec


def run_ranks(target, world, args, timeout_s, what):
    """Spawn ``world`` processes ``target(rank, world, store, out, *args)``
    that join one gloo group over a ``file://`` store and put (rank,
    pickled record, error) on ``out``; returns the records by rank, and
    fails the phase on a rank's error or after ``timeout_s`` without a
    record. Every process is joined or terminated before it returns. A
    record travels as ``pickle.dumps`` bytes: put on the queue as it is,
    its tensors would be shared through file descriptors that the parent
    fetches from the rank while unpickling, and a rank that has already
    exited by then fails the phase (EOFError)."""
    import multiprocessing as mp
    import pickle
    import queue as queue_mod
    import tempfile

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "store")
    procs = [ctx.Process(target=target, args=(r, world, store, out, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    recs, error = {}, None
    try:
        while len(recs) < world and error is None:
            rank, rec, err = out.get(timeout=timeout_s)
            if err is not None:
                error = f"rank {rank}: {err}"
            recs[rank] = None if rec is None else pickle.loads(rec)
    except queue_mod.Empty:
        error = f"ranks gave no result within {timeout_s} s"
    finally:
        for p in procs:
            p.join(timeout=10 if error else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    require(error is None, f"{what}: {error}")
    return recs


SP4_SHAPES = dict(ring=RING_SHAPE, ulysses=ULYSSES_SHAPE,
                  moe=(MOE_EP_TOKENS, 8, 768, 3072))


def sp4_phase(torch, device="cuda", shapes=SP4_SHAPES):
    """Phase 5j: four ranks on the one card (spawned; a gloo group, each
    rank on cuda:0; NCCL refuses two ranks on one device). ``shapes``: the
    ring and Ulysses [B, H, S, D] and the MoE layer's (tokens a rank,
    experts, d, hidden). Returns each rank's record (``_sp4_body``)."""
    t_phase = time.perf_counter()
    world = 4
    recs = run_ranks(_sp4_rank, world, (device, shapes), SP4_TIMEOUT_S,
                     "four ranks on the card")
    for r in range(world):
        rec = recs[r]
        print(f"sp4 rank {r}: " + "; ".join(
            f"{k} {v}" for k, v in rec.items()))
    ring = [recs[r]["ring_flash_causal"] for r in range(world)]
    require(all(x["launches"] == r + 1 for r, x in enumerate(ring)),
            "ring-flash causal: K4 r + 1 times on rank r")
    require(all(recs[r]["ring_flash_full"]["launches"] == world
                for r in range(world)), "ring-flash non-causal: K4 4 times")
    for key in ("ring_flash_causal", "ring_flash_full", "ring_einsum"):
        worst = max(recs[r][key]["max_abs_err"] for r in range(world))
        require(worst < TOL_RING, f"{key}: {worst} against the plain "
                                  f"attention (tol {TOL_RING})")
    require(all(recs[r]["ring_einsum"]["launches"] == 0
                for r in range(world)), "ring einsum: no attention kernel")
    worst = max(recs[r]["ulysses"]["max_abs_err"] for r in range(world))
    require(worst < TOL_VS_FP32, f"ulysses: {worst} against fp32 autograd "
                                 f"of the plain attention on the whole "
                                 f"tensor (tol {TOL_VS_FP32})")
    require(all(recs[r]["ulysses"]["launches"] == {
        "flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
        and recs[r]["ulysses"]["general_launches"] == 0
        for r in range(world)), "ulysses: K1-K3 once a rank, no general "
                                "kernel")
    worst = max(recs[r]["moe_ep"]["max_abs_err"] for r in range(world))
    require(worst < TOL_EP, f"moe ep=4 against ep=1: {worst} (tol {TOL_EP})")
    print(f"phase 5j (four ranks on the card): "
          f"{time.perf_counter() - t_phase:.3f} s wall")
    return [recs[r] for r in range(world)]


def _sp4_rank(rank, world, store, out, device, shapes):
    """One of phase 5j's ranks (a spawned process)."""
    import pickle
    import traceback

    try:
        out.put((rank, pickle.dumps(_sp4_body(rank, world, store, device,
                                              shapes)), None))
    except BaseException:  # reported to the parent, which fails the phase
        out.put((rank, None, traceback.format_exc()))


def _sp4_body(rank, world, store, device, shapes):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.device import full_fp32
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.moe import moe_ffn_local
    from ray_tpu_torch.parallel.ring import (ring_attention_local,
                                             ring_flash_attention_local)
    from ray_tpu_torch.parallel.sharding import use_mesh
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_local

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    rec = {}

    def inputs(shape, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        return [torch.randn(shape, generator=g).to(dev, dtype)
                for _ in range(4)]

    def shard(t, dim=2):
        return t.chunk(world, dim)[rank].contiguous()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t0) * 1e3

    try:
        with full_fp32(), use_mesh(MeshSpec(sp=world).build(dev.type)):
            q, k, v, g_o = inputs(shapes["ring"], torch.float32, 11)
            for causal in (True, False):
                ref = A.mha_reference(q, k, v, causal=causal)
                A.reset_launch_counts()
                o, ms = timed(lambda: ring_flash_attention_local(
                    shard(q), shard(k), shard(v), "sp", causal=causal))
                rec[f"ring_flash_{'causal' if causal else 'full'}"] = dict(
                    launches=A.flash_fwd_general.launches,
                    other_launches=sum(f.launches for f in A.KERNEL_WRAPPERS),
                    max_abs_err=rel_err(o, shard(ref)), ms=ms)
                del ref
            xs = [shard(t).requires_grad_() for t in (q, k, v)]

            def ring_step():
                o = ring_attention_local(*xs, "sp", causal=True)
                o.backward(shard(g_o))
                return o
            A.reset_launch_counts()
            o, ms = timed(ring_step)
            refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ref = A.mha_reference(*refs, causal=True)
            ref.backward(g_o)
            errs = [rel_err(o, shard(ref))] + [
                rel_err(x.grad, shard(r.grad)) for x, r in zip(xs, refs)]
            rec["ring_einsum"] = dict(
                max_abs_err=max(errs), errs_o_dq_dk_dv=errs, ms=ms,
                launches=sum(f.launches for f in A.KERNEL_WRAPPERS
                             + A.GENERAL_WRAPPERS))
            del q, k, v, g_o, xs, refs, ref, o

            q, k, v, g_o = inputs(shapes["ulysses"], torch.bfloat16, 12)
            xs = [shard(t).requires_grad_() for t in (q, k, v)]

            def ulysses_step():
                o = ulysses_attention_local(*xs, "sp", causal=True)
                o.backward(shard(g_o))
                return o
            A.reset_launch_counts()
            o, ms = timed(ulysses_step)
            launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS}
            general = sum(f.launches for f in A.GENERAL_WRAPPERS)
            # The plain attention on the whole tensor in fp32 autograd,
            # as phase 3's autograd check.
            refs = [t.detach().float().requires_grad_() for t in (q, k, v)]
            ref = A.mha_reference(*refs, causal=True)
            ref.backward(g_o.float())
            errs = [rel_err(o, shard(ref))] + [
                rel_err(x.grad, shard(r.grad)) for x, r in zip(xs, refs)]
            rec["ulysses"] = dict(
                launches=launches, general_launches=general,
                max_abs_err=max(errs), errs_o_dq_dk_dv=errs, ms=ms)
            del q, k, v, g_o, xs, refs, ref, o

        with full_fp32(), use_mesh(MeshSpec(ep=world).build(dev.type)):
            tokens, e, d, m = shapes["moe"]
            g = torch.Generator().manual_seed(13)
            x = torch.randn(world * tokens, d, generator=g)
            rw, wi, wo = (torch.randn(s, generator=g) * 0.02 for s in (
                (d, e), (e, d, m), (e, m, d)))
            x, rw, wi, wo = (t.to(dev) for t in (x, rw, wi, wo))
            kw = dict(num_experts=e, top_k=2, capacity_factor=MOE_EP_CAPACITY)
            mine = x.chunk(world)[rank]
            (y4, _), ms = timed(lambda: moe_ffn_local(
                mine, rw, wi.chunk(world)[rank], wo.chunk(world)[rank],
                axis_name="ep", **kw))
            y1, _ = moe_ffn_local(mine, rw, wi, wo, axis_name=None, **kw)
            rec["moe_ep"] = dict(max_abs_err=rel_err(y4, y1), ms=ms)
    finally:
        dist.destroy_process_group()
    return rec


# -- phase 8: the Train library ----------------------------------------------

TRAIN_STEPS = 6            # phase 8b: steps of each fit
TRAIN_CHECKPOINT_AT = (3, 6)
SERVE_8D_NEW = 32          # phase 8d: tokens a request


def dir_gb(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e9


def object_plane_8a(torch, dev, cfg, card):
    """Phase 8a: tensors through a protocol-5 pickler whose dispatch table
    holds the port's reducer (plain pickle: the card's machine may lack
    cloudpickle). Each tensor must come back on the card bit for bit, its
    bytes in one out-of-band buffer, the in-band pickle holding no
    storage. Returns {what: (GB, dumps ms, loads ms)}."""
    import copyreg
    import io
    import pickle

    from ray_tpu_torch.core.serialization import reduce_tensor
    from ray_tpu_torch.models import gpt2

    class TensorPickler(pickle.Pickler):
        dispatch_table = {**copyreg.dispatch_table,
                          torch.Tensor: reduce_tensor}

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    g = torch.Generator(device=dev).manual_seed(8)
    objects = {
        "fp32 10 MB": {"t": torch.randn(10 * 2 ** 20 // 4, generator=g,
                                        device=dev)},
        "bf16 8 MB": {"t": torch.randn(4 * 2 ** 20, generator=g,
                                       device=dev).to(torch.bfloat16)},
        "gpt2-124m state dict": gpt2.GPT2(
            cfg, torch.Generator().manual_seed(0)).to(dev).state_dict()}
    out = {}
    for what, obj in objects.items():
        n = len(obj)
        nbytes = sum(t.numel() * t.element_size() for t in obj.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bufs, f = [], io.BytesIO()
        TensorPickler(f, protocol=5, buffer_callback=bufs.append).dump(obj)
        inband = f.getvalue()
        t1 = time.perf_counter()
        back = pickle.loads(inband, buffers=bufs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        require(len(bufs) == n, f"8a {what}: one out-of-band buffer a "
                                f"tensor ({len(bufs)} for {n})")
        require(sum(b.raw().nbytes for b in bufs) == nbytes
                and len(inband) <= 512 * n + 4096,
                f"8a {what}: no storage in band ({len(inband)} bytes)")
        require(all(back[k].is_cuda and back[k].dtype == t.dtype
                    and torch.equal(bits(back[k]), bits(t))
                    for k, t in obj.items()),
                f"8a {what}: back on the card, bit-equal")
        gb = nbytes / 1e9
        out[what] = dict(gb=gb, tensors=n, inband_bytes=len(inband),
                         dumps_ms=(t1 - t0) * 1e3, loads_ms=(t2 - t1) * 1e3)
        print(f"8a {what} on {card}: {n} tensors, {gb:.6f} GB, in-band "
              f"{len(inband)} bytes; card -> pickle {(t1 - t0) * 1e3:.3f} ms "
              f"({gb / (t1 - t0):.3f} GB/s), pickle -> card "
              f"{(t2 - t1) * 1e3:.3f} ms ({gb / (t2 - t1):.3f} GB/s)")
        del back, bufs, inband
    del objects
    torch.cuda.empty_cache()
    return out


def train_library_phase(torch, A, dev, root):
    """Phase 8: the Train library on the card, on ``InlineRuntime``.

    8a: ``object_plane_8a``. 8b: ``TorchTrainer(...).fit()`` of gpt2-124m
    (batch 8, S 1024, bf16 with an fp32 master, ``default_optimizer``,
    ``default_rng(0)`` tokens), TRAIN_STEPS steps reporting the loss, a
    checkpoint (params and optimizer state, ``CheckpointConfig(num_to_keep=
    2, async_save=True)``) at each of TRAIN_CHECKPOINT_AT: its losses
    bit-equal to the same steps through ``build_train`` directly, K1-K3 12
    launches a step and no general kernel; then ``fit(resume_from_
    checkpoint=<the first checkpoint's directory>)``, whose losses must
    equal the continuous run's. 8c: ``TorchPredictor.from_checkpoint`` of
    the fit's result: logits of one batch bit-equal to the model's forward
    with the same parameters. 8d: ``LLMServer(model="llama-1b",
    checkpoint_path=)`` over a ``save_arrays`` directory of a llama-1b drawn
    from seed 0: the tokens of ``LLMServer(params=the same tree)``.
    Checkpoints go under chiprun_out/train_8 and are removed. Returns the
    launches a step of 8b by kernel and the phase's numbers."""
    import asyncio
    import shutil

    import numpy as np

    from ray_tpu_torch.llm.serve import LLMServer
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.models.convert import llama_tree_to_numpy
    from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                     CheckpointManager, RunConfig,
                                     TorchPredictor, TorchTrainer,
                                     default_optimizer, restore_arrays,
                                     save_arrays, session)
    from ray_tpu_torch.train.checkpoint import as_template
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    card = smi_line()
    work = os.path.join(root, "chiprun_out", "train_8")
    shutil.rmtree(work, ignore_errors=True)
    cfg = gpt2_124m_config(gpt2, torch)
    out = {}
    try:
        out["object_plane"] = object_plane_8a(torch, dev, cfg, card)

        # -- 8b. TorchTrainer.fit of gpt2-124m -------------------------------
        batch, seq = 8, 1024
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, seq + 1)).astype(np.int64)
        data = {"tokens": torch.from_numpy(tokens).to(dev)}

        def build():
            return build_train(lambda g: gpt2.GPT2(cfg, g),
                               lambda m, b: m.loss_fn(b),
                               optimizer=default_optimizer(),
                               master_fp32=True)

        direct, direct_ms = [], []
        init, step_fn = build()
        model, opt, n = init(0)
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            model, opt, n, met = step_fn(model, opt, n, data)
            direct.append(met["loss"].item())
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        del model, opt, met
        torch.cuda.empty_cache()

        report_s = []

        def train_fn(config):
            init, step_fn = build()
            model, opt, n = init(0)
            restore_s = None
            ckpt = session.get_checkpoint()
            if ckpt is not None:
                t0 = time.perf_counter()
                state = ckpt.to_dict()
                params = dict(model.named_parameters())
                arrays = as_template({"params": params, "opt_state": opt},
                                     state["__arrays__"])
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(arrays["params"][name])
                opt, n = arrays["opt_state"], state["step"]
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            while n < TRAIN_STEPS:
                t0 = time.perf_counter()
                model, opt, n, met = step_fn(model, opt, n, data)
                loss = met["loss"].item()
                step_ms = (time.perf_counter() - t0) * 1e3
                ckpt = None
                if n in TRAIN_CHECKPOINT_AT:
                    ckpt = Checkpoint.from_dict({"step": n, "__arrays__": {
                        "params": dict(model.named_parameters()),
                        "opt_state": opt}})
                t0 = time.perf_counter()
                session.report({"step": n, "loss": loss, "step_ms": step_ms,
                                "restore_s": restore_s}, checkpoint=ckpt)
                if ckpt is not None:
                    report_s.append(time.perf_counter() - t0)

        saves = []
        save = CheckpointManager.save

        def timed_save(self, checkpoint, step, metrics=None):
            t0 = time.perf_counter()
            path = save(self, checkpoint, step, metrics)
            saves.append((time.perf_counter() - t0, dir_gb(path)))
            return path

        def fit(name, resume=None):
            trainer = TorchTrainer(
                train_fn, run_config=RunConfig(
                    name=name, storage_path=work,
                    checkpoint_config=CheckpointConfig(num_to_keep=2,
                                                       async_save=True)),
                resume_from_checkpoint=resume, runtime=InlineRuntime())
            A.reset_launch_counts()
            t0 = time.perf_counter()
            result = trainer.fit()
            wall = time.perf_counter() - t0
            launches = {f.__name__: f.launches for f in A.KERNEL_WRAPPERS
                        + A.GENERAL_WRAPPERS}
            require(result.ok, f"8b {name}: {result.error}")
            return result, wall, launches

        CheckpointManager.save = timed_save
        try:
            result, fit_wall, launches = fit("gpt2-124m-fit")
            losses = [m["loss"] for m in result.metrics_history]
            fit_ms = [m["step_ms"] for m in result.metrics_history]
            print(f"8b direct build_train losses {direct}")
            print(f"8b TorchTrainer.fit losses   {losses}")
            require(losses == direct, "8b: TorchTrainer.fit's losses "
                                      "bit-equal to build_train's")
            per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
            print(f"8b launches a step: {per_step}")
            require(all(per_step[f.__name__] == cfg.num_layers
                        for f in A.KERNEL_WRAPPERS),
                    f"8b: K1-K3 {cfg.num_layers} launches a step")
            require(all(launches[f.__name__] == 0
                        for f in A.GENERAL_WRAPPERS),
                    "8b: no general kernel")
            ckpt_dir = os.path.join(work, "gpt2-124m-fit", "checkpoints")
            kept = sorted(os.listdir(ckpt_dir))
            require(kept == ["checkpoint_00000001", "checkpoint_00000002"],
                    f"8b: both checkpoints kept ({kept})")
            first = Checkpoint.from_directory(os.path.join(ckpt_dir, kept[0]))
            resumed, resume_wall, resume_launches = fit(
                "gpt2-124m-resume", resume=first)
        finally:
            CheckpointManager.save = save
        again = [m["loss"] for m in resumed.metrics_history]
        restore_s = resumed.metrics_history[0]["restore_s"]
        print(f"8b resumed at step {TRAIN_CHECKPOINT_AT[0]}: losses {again}")
        require(again == losses[TRAIN_CHECKPOINT_AT[0]:],
                "8b: the resumed run's losses bit-equal to the continuous "
                "run's")
        require(all(resume_launches[f.__name__] == cfg.num_layers * len(again)
                    for f in A.KERNEL_WRAPPERS), "8b resume: K1-K3 launches")
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        plain_steps = [ms for i, ms in enumerate(fit_ms)
                       if i + 1 not in TRAIN_CHECKPOINT_AT]
        print(f"8b on {card}: trainer step ms {[round(x, 3) for x in fit_ms]}"
              f" (median of the steps without a checkpoint "
              f"{med(plain_steps):.3f}) beside build_train's "
              f"{[round(x, 3) for x in direct_ms]} (median "
              f"{med(direct_ms[1:]):.3f}); fit {fit_wall:.3f} s wall, "
              f"build_train's {sum(direct_ms) / 1e3:.3f} s of steps; "
              f"session.report's snapshots to the host (the fit's, then "
              f"the resume's) {[round(x, 3) for x in report_s]} s; saves "
              f"(async, s, GB on disk; the same order) "
              f"{[(round(a, 3), round(b, 3)) for a, b in saves]}; the "
              f"resume's restore {restore_s:.3f} s, its fit "
              f"{resume_wall:.3f} s wall")
        out["train"] = dict(
            losses=losses, direct_losses=direct, step_ms=fit_ms,
            direct_step_ms=direct_ms, fit_wall_s=fit_wall,
            report_s=report_s, saves=saves, restore_s=restore_s,
            resume_wall_s=resume_wall)
        out["launches_per_step"] = per_step

        # -- 8c. TorchPredictor from the fit's checkpoint -------------------
        net = gpt2.GPT2(cfg).to(dev).to(torch.bfloat16)

        def apply_fn(params, batch):
            return {"logits": torch.func.functional_call(
                net, params, (batch["tokens"],))}

        predictor = TorchPredictor.from_checkpoint(result.checkpoint,
                                                   apply_fn=apply_fn)
        inputs = {"tokens": tokens[:, :-1]}
        predictor.predict(inputs)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = predictor.predict(inputs)
        predict_ms = (time.perf_counter() - t0) * 1e3
        params = result.checkpoint.to_dict()["__arrays__"]["params"]
        ref_net = gpt2.GPT2(cfg).to(dev).to(torch.bfloat16)
        ref_net.load_state_dict(params)
        with torch.inference_mode():
            ref = ref_net(torch.from_numpy(tokens[:, :-1]).to(dev))
        ref = ref.float().cpu().numpy()
        require(pred["logits"].shape == ref.shape
                and np.array_equal(pred["logits"], ref),
                "8c: the predictor's logits bit-equal to the model's forward")
        print(f"8c TorchPredictor on {card}: logits {list(ref.shape)} "
              f"bit-equal; predict {predict_ms:.3f} ms (numpy in, fp32 "
              f"numpy out, {ref.nbytes / 1e9:.3f} GB)")
        out["predict_ms"] = predict_ms
        del net, ref_net, predictor, pred, ref, result, resumed, data
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

        # -- 8d. LLMServer(checkpoint_path=) --------------------------------
        lcfg = llama.CONFIGS["llama-1b"]
        m = llama.Llama(lcfg, torch.Generator(device=dev).manual_seed(0),
                        dev).to(lcfg.dtype)
        tree = llama_tree_to_numpy(dict(m.named_parameters()), lcfg)
        del m
        path = os.path.join(work, "llama-1b")
        t0 = time.perf_counter()
        save_arrays(path, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_arrays(path)
        load_s = time.perf_counter() - t0
        gb = dir_gb(path)
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, lcfg.vocab_size, size=n).tolist()
                   for n in (128, 64, 200)]

        def tokens_of(**kw):
            server = LLMServer(model="llama-1b", num_slots=4, chunk=128,
                               page_size=16, **kw)

            async def ask():
                outs = [await server({"prompt": p,
                                      "max_tokens": SERVE_8D_NEW})
                        for p in prompts]
                outs.append(await server({
                    "prompt": prompts[0], "max_tokens": SERVE_8D_NEW,
                    "temperature": 0.8, "seed": 5}))
                return [o["tokens"] for o in outs]

            try:
                t0 = time.perf_counter()
                return asyncio.run(ask()), time.perf_counter() - t0
            finally:
                server.engine.stop()

        t0 = time.perf_counter()
        from_ckpt, ask_s = tokens_of(checkpoint_path=path)
        server_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        from_params, _ = tokens_of(params=tree)
        require(from_ckpt == from_params
                and all(len(t) == SERVE_8D_NEW for t in from_ckpt),
                "8d: LLMServer(checkpoint_path=)'s tokens equal "
                "LLMServer(params=)'s")
        print(f"8d LLMServer(checkpoint_path=) on {card}: llama-1b arrays "
              f"{gb:.3f} GB on disk (bf16 widened to fp32), save_arrays "
              f"{save_s:.3f} s, restore_arrays {load_s:.3f} s; the server "
              f"from the checkpoint {server_s:.3f} s to its last answer "
              f"({ask_s:.3f} s of requests); {len(prompts) + 1} requests' "
              f"tokens equal LLMServer(params=)'s")
        out["llm_checkpoint"] = dict(gb=gb, save_s=save_s, restore_s=load_s,
                                     server_s=server_s)
        del tree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 8 (the Train library): {time.perf_counter() - t_phase:.3f}"
          f" s wall; {card}")
    return out


# -- phase 9: the LLM path's telemetry, and external envs --------------------

TELEMETRY_REQUESTS = 16  # 9a: traced requests, 128-token prompts
TELEMETRY_NEW = 128      # 9a: new tokens a request
TELEMETRY_PAIRS = 2      # 9a: (on, off) timing pairs
TELEMETRY_TIMED = 8      # 9a: requests of each timed run (all 8 slots)
# 9a: a span's duration against the request's timing dict, in seconds.
# Spans hold epoch seconds in float64 (spacing 2.4e-7 s near 1.8e9 s).
SPAN_TOL_S = 1e-6
EXTERNAL_ITERS = 3       # 9b: DQN iterations on ExternalDQNWorker
EXTERNAL_FRAGMENT = 512  # 9b: rows an iteration (= learning_starts)
EXTERNAL_CLIENTS = 2     # 9b: PolicyClient threads
EXTERNAL_EPISODES = 10   # 9b: episodes a client, each at most
EXTERNAL_STEPS = 200     # steps long


def llm_series(registry):
    """The ``rt_llm_*`` series of a metrics registry: counters and gauges
    by tag key, histograms by their observation counts."""
    out = {}
    for name, (kind, data) in registry.collect_all().items():
        if name.startswith("rt_llm_"):
            out[name] = {k: v["count"] if kind == "histogram" else v
                         for k, v in data.items()}
    return out


def telemetry_phase(torch, A, dev):
    """Phase 9a: the LLM path's telemetry at llama-1b's width (phase 6's
    engine, random bf16 weights from seed 0), telemetry on (the default)
    and the port's tracer enabled: 16 traced requests of 128 + 128
    tokens, a prefix hit and a session exported and imported. Gates, all
    exact: the registry's token, prefix hit/miss and tokens-saved
    counters moved as the engine's own counters; the TTFT, stage and
    decode-per-token histograms one observation a request; the page
    gauges the pool's counts after the drain; rt_llm_roofline_frac
    decode_profile()'s; each request one llm.request span parented to its
    context with the four stage children, durations equal to its timing
    within SPAN_TOL_S. Then decode step ms and tokens/s with telemetry on
    and off in alternating pairs (printed, not gated)."""
    import numpy as np

    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.observability import metrics, tracing

    t_phase = time.perf_counter()
    card = smi_line()
    cfg = llama.CONFIGS["llama-1b"]
    model = llama.Llama(cfg, torch.Generator(device=dev).manual_seed(0),
                        dev).to(cfg.dtype).requires_grad_(False)
    require(config().telemetry_enabled, "9a: telemetry is on by default")
    tracer = tracing.get_tracer()
    tracer.clear()
    tracer.enable()
    engine = SlotEngine(model, num_slots=8, chunk=128, page_size=16,
                        decode_block=16, device=dev)
    engine.warmup()
    rng = np.random.default_rng(9)

    def prompt():
        return rng.integers(1, cfg.vocab_size, size=128).tolist()

    def ctx():
        return os.urandom(16).hex(), os.urandom(8).hex()

    before = llm_series(metrics.registry)
    counters = ("tokens_generated", "prefix_hits", "prefix_misses",
                "prefix_tokens_saved")
    start = {c: getattr(engine, c) for c in counters}
    A.reset_launch_counts()
    engine.reset_decode_profile()
    traced = []  # (context, handle)

    def submit(p, **kw):
        c = ctx()
        traced.append((c, engine.submit(p, max_new=TELEMETRY_NEW,
                                        trace_ctx=c, **kw)))
        return traced[-1][1]

    prompts = [prompt() for _ in range(TELEMETRY_REQUESTS)]
    drain(engine, [submit(p) for p in prompts])
    hit = submit(prompts[0])
    drain(engine, [hit])
    drain(engine, [submit(prompt(), session_id="phase9")])
    snap = engine.export_session("phase9")
    engine.clear_prefix_cache()
    imported = engine.import_session(snap)
    prof = engine.decode_profile()
    launches = {f.__name__: f.launches
                for f in A.KERNEL_WRAPPERS + A.GENERAL_WRAPPERS}
    after = llm_series(metrics.registry)

    def moved(name, key=()):
        return after.get(name, {}).get(key, 0) - before.get(name, {}).get(
            key, 0)

    n = len(traced)
    own = {c: getattr(engine, c) - start[c] for c in counters}
    reg = {"tokens_generated": moved("rt_llm_tokens_generated_total"),
           "prefix_hits": moved("rt_llm_prefix_hit", (("result", "hit"),)),
           "prefix_misses": moved("rt_llm_prefix_hit",
                                  (("result", "miss"),)),
           "prefix_tokens_saved": moved("rt_llm_prefix_tokens_saved")}
    hists = {"ttft": moved("rt_llm_ttft_seconds"),
             "decode_per_token": moved("rt_llm_decode_per_token_seconds")}
    hists.update({f"stage {s}": moved("rt_llm_stage_seconds",
                                      (("stage", s),))
                  for s in ("admission", "queue", "prefix_match", "prefill",
                            "decode")})
    gauges = {"pages_used": after["rt_llm_pages_used"][()],
              "pages_free": after["rt_llm_pages_free"][()],
              "roofline_frac": after["rt_llm_roofline_frac"][()]}
    matched = hit.result(timeout=0).timing["matched_tokens"]
    print(f"9a telemetry on llama-1b: {n} traced requests; registry "
          f"{reg} vs the engine's {own}; histogram counts {hists} (expect "
          f"{n} each); page gauges used {gauges['pages_used']} free "
          f"{gauges['pages_free']} vs the pool's {engine.pages_used}, "
          f"{engine.pages_free}; rt_llm_roofline_frac "
          f"{gauges['roofline_frac']} vs decode_profile "
          f"{prof['roofline_frac']}; prefix hit matched {matched}; session "
          f"import {imported}; kernel launches {launches}")
    require(reg == own and own["tokens_generated"] == n * TELEMETRY_NEW,
            "9a: the registry's counters moved as the engine's own")
    require(own["prefix_hits"] == 1 and matched >= 112,
            "9a: one prefix hit of >= 112 tokens")
    require(all(v == n for v in hists.values()),
            "9a: one observation a request in each histogram")
    require(gauges["pages_used"] == engine.pages_used
            and gauges["pages_free"] == engine.pages_free,
            "9a: the page gauges are the pool's counts after the drain")
    require(prof["steps"] > 0
            and gauges["roofline_frac"] == prof["roofline_frac"],
            "9a: rt_llm_roofline_frac is decode_profile()'s")
    require(imported["pages_imported"] > 0, "9a: the session's pages "
            "were imported")

    by_trace = {}
    for s in tracer.spans("llm."):
        by_trace.setdefault(s.trace_id, []).append(s)
    worst = 0.0
    for (trace_id, parent), h in traced:
        mine = by_trace.get(trace_id, [])
        roots = [s for s in mine if s.name == "llm.request"]
        require(len(roots) == 1 and roots[0].parent_id == parent,
                f"9a: one llm.request span under trace {trace_id}'s "
                "context")
        root = roots[0]
        kids = {s.name: s for s in mine if s.parent_id == root.span_id}
        t = h.result(timeout=0).timing
        stages = ("admission", "queue", "prefill", "decode")
        require(all(f"llm.{st}" in kids for st in stages)
                and len(kids) == 4 + (t["prefix_match_s"] > 0),
                f"9a: llm.request's children under trace {trace_id}: "
                f"{sorted(kids)}")
        worst = max([worst, abs(root.end_s - root.start_s - t["total_s"])]
                    + [abs(kids[f"llm.{st}"].end_s - kids[f"llm.{st}"].start_s
                           - t[f"{st}_s"]) for st in stages])
    print(f"9a spans: {n} llm.request trees, worst |span - timing| "
          f"{worst:.3e} s (tol {SPAN_TOL_S})")
    require(worst <= SPAN_TOL_S, "9a: span durations equal timing")

    def timed_run(on):
        config().apply_overrides({"telemetry_enabled": on})
        tracer.enabled = on
        engine.reset_decode_profile()
        t0 = time.perf_counter()
        hs = [engine.submit(prompt(), max_new=TELEMETRY_NEW, trace_ctx=ctx())
              for _ in range(TELEMETRY_TIMED)]
        drain(engine, hs)
        dt = time.perf_counter() - t0
        p = engine.decode_profile()
        engine.clear_prefix_cache()
        return {"step_ms": p["avg_step_ms"],
                "tokens_s": TELEMETRY_TIMED * TELEMETRY_NEW / dt}

    pairs = []
    try:
        for _ in range(TELEMETRY_PAIRS):
            pairs.append({"on": timed_run(True), "off": timed_run(False)})
    finally:
        config().apply_overrides({"telemetry_enabled": True})
        tracer.disable()
        tracer.clear()
    for i, pair in enumerate(pairs):
        print(f"9a pair {i} on {card}: decode step ms telemetry on "
              f"{pair['on']['step_ms']}, off {pair['off']['step_ms']}; "
              f"tokens/s on {pair['on']['tokens_s']}, off "
              f"{pair['off']['tokens_s']} ({TELEMETRY_TIMED} requests of "
              f"128 + {TELEMETRY_NEW} tokens)")
    engine.stop()
    del engine, model
    torch.cuda.empty_cache()
    print(f"phase 9a (LLM telemetry): {time.perf_counter() - t_phase:.3f} s "
          f"wall; {card}")
    return {"launches": launches, "pairs": pairs, "span_worst_s": worst}


def external_phase(torch, A, dev):
    """Phase 9b: external envs feeding a learner on the card. DQN with
    ExternalDQNWorker (``_worker_cls``) for EXTERNAL_ITERS iterations,
    fed by a CartPole simulator thread that owns its loop, one episode
    at a time; then a PolicyServerInput served to EXTERNAL_CLIENTS
    PolicyClient threads over HTTP on localhost, with the learner's
    weights. Gates: the learner's parameters and optimizer state on the
    card and the worker's policy on the CPU; finite losses; within an
    episode next_obs[t] == obs[t+1]; the simulator and every client
    episode end; the server shuts down. Prints env-steps/s, HTTP round
    trips/s and the learner's ms an update (CUDA events)."""
    import threading

    import numpy as np

    from ray_tpu_torch.rllib import DQN, DQNConfig
    from ray_tpu_torch.rllib.env import FastCartPole
    from ray_tpu_torch.rllib.external import (ExternalDQNWorker, ExternalEnv,
                                              PolicyClient,
                                              PolicyServerInput)
    from ray_tpu_torch.rllib.sample_batch import DONES, NEXT_OBS, OBS

    t_phase = time.perf_counter()
    card = smi_line()
    stop = threading.Event()

    class CartPoleSim(ExternalEnv):
        def __init__(self):
            super().__init__(obs_shape=(4,), num_actions=2)
            self._sim = FastCartPole(num_envs=1, seed=7)

        def run(self):
            while not stop.is_set():
                eid = self.start_episode()
                obs = self._sim.vector_reset()[0]
                done = False
                while not done:
                    action = self.get_action(eid, obs)
                    nobs, rew, dones, _ = self._sim.vector_step(
                        np.array([action]))
                    self.log_returns(eid, float(rew[0]))
                    obs, done = nobs[0], bool(dones[0])
                self.end_episode(eid, obs)

    class ExternalDQN(DQN):
        _worker_cls = ExternalDQNWorker

    cfg = (DQNConfig().environment(CartPoleSim)
           .rollouts(rollout_fragment_length=EXTERNAL_FRAGMENT)
           .training(learning_starts=EXTERNAL_FRAGMENT).debugging(seed=0))
    A.reset_launch_counts()
    algo = ExternalDQN(cfg)  # the learner on the card
    worker = algo.workers.local_worker
    sample, batches = worker.sample, []

    def recorded(*args, **kw):
        batches.append(sample(*args, **kw))
        return batches[-1]

    worker.sample = recorded
    _, _, update_ms = rl7c_record(torch, algo)
    results, walls = [], []
    for _ in range(EXTERNAL_ITERS):
        t = time.perf_counter()
        results.append(algo.train())
        walls.append(time.perf_counter() - t)
    worker.sample = sample
    rl7c_on_card("9b ExternalDQN", algo.params, algo.target_params,
                 algo.opt_state)
    rl7c_policy_on_cpu("9b ExternalDQN", worker.policy)
    losses = [r["loss"] for r in results]
    require(all(x is not None and math.isfinite(x) for x in losses),
            f"9b: finite losses every iteration ({losses})")
    rl7c_finite("9b ExternalDQN", results)
    rows = broken = 0
    for b in batches:
        for t in range(len(b[OBS]) - 1):
            if not b[DONES][t]:
                rows += 1
                broken += not np.array_equal(b[NEXT_OBS][t], b[OBS][t + 1])
    require(rows > 0 and broken == 0, f"9b: within an episode next_obs[t] "
            f"== obs[t+1] ({broken} of {rows} rows broken)")
    stop.set()
    deadline = time.perf_counter() + 120
    while worker.env.is_alive() and time.perf_counter() < deadline:
        try:
            worker.sample(rollout_length=8, timeout_s=1.0)
        except TimeoutError:
            pass
    worker.env.join(timeout=5)
    require(not worker.env.is_alive(), "9b: the simulator thread ended")
    steps = sum(r["timesteps_this_iter"] for r in results)
    env_steps_s = steps / sum(walls)
    learner_ms = float(np.median(update_ms))
    print(f"9b ExternalDQN on {card}: {EXTERNAL_ITERS} iterations, losses "
          f"{losses}, {steps} env steps in {sum(walls):.3f} s = "
          f"{env_steps_s:.1f} env-steps/s; learner {len(update_ms)} "
          f"updates, median {learner_ms:.3f} ms an update (CUDA events), "
          f"min {min(update_ms):.3f} max {max(update_ms):.3f}; {rows} "
          "chained rows checked")

    server = PolicyServerInput(obs_shape=(4,), num_actions=2, port=0)
    calls = [0] * EXTERNAL_CLIENTS
    ends = [0] * EXTERNAL_CLIENTS
    failures = []
    try:
        served = ExternalDQNWorker(server)
        served.set_weights(worker.get_weights())
        served.set_epsilon(0.0)

        def client_loop(i):
            client = PolicyClient(server.address, timeout_s=60.0)
            sim = FastCartPole(num_envs=1, seed=100 + i)
            try:
                for _ in range(EXTERNAL_EPISODES):
                    eid = client.start_episode()
                    obs = sim.vector_reset()[0]
                    done, n = False, 0
                    while not done and n < EXTERNAL_STEPS:
                        a = client.get_action(eid, obs)
                        nobs, rew, dones, _ = sim.vector_step(np.array([a]))
                        client.log_returns(eid, float(rew[0]))
                        obs, done = nobs[0], bool(dones[0])
                        n += 1
                    client.end_episode(eid, obs)
                    calls[i] += 2 * n + 2
                    ends[i] += 1
            except Exception as e:  # noqa: BLE001 — gated below
                failures.append(repr(e))

        threads = [threading.Thread(target=client_loop, args=(i,),
                                    daemon=True)
                   for i in range(EXTERNAL_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        served_rows = 0
        deadline = t0 + 300
        while (any(t.is_alive() for t in threads)
               and time.perf_counter() < deadline):
            try:
                served_rows += len(served.sample(rollout_length=64,
                                                 timeout_s=1.0)[OBS])
            except TimeoutError:
                pass
        wall = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=30)
        require(not failures and not any(t.is_alive() for t in threads),
                f"9b: the clients ran to their end ({failures})")
        require(ends == [EXTERNAL_EPISODES] * EXTERNAL_CLIENTS,
                f"9b: every client episode ended ({ends})")
    finally:
        server.shutdown()
    server.join(timeout=30)
    require(not server.is_alive(), "9b: the policy server shut down")
    trips_s = sum(calls) / wall
    launches = {f.__name__: f.launches
                for f in A.KERNEL_WRAPPERS + A.GENERAL_WRAPPERS}
    print(f"9b PolicyServerInput on {card}: {EXTERNAL_CLIENTS} clients x "
          f"{EXTERNAL_EPISODES} episodes, {sum(calls)} HTTP round trips in "
          f"{wall:.3f} s = {trips_s:.1f} round trips/s, {served_rows} rows "
          f"served; attention kernel launches {launches}")
    require(all(n == 0 for n in launches.values()),
            "9b: no attention kernel on the external-env path")
    algo.stop()
    torch.cuda.empty_cache()
    print(f"phase 9b (external envs): {time.perf_counter() - t_phase:.3f} s "
          f"wall; {card}")
    return {"launches": launches, "env_steps_s": env_steps_s,
            "learner_ms": learner_ms, "round_trips_s": trips_s}


# -- phase 10: the Tune library ----------------------------------------------

ASHA_LRS = (3e-3, 1e-3, 3e-4, 1e-4)  # 10a's grid (ASHA judges each trial
ASHA = dict(max_t=8, grace_period=2,  # against those that reached a rung
            reduction_factor=2)       # before it: the likely best first)
ASHA_STEPS = 12    # 10a: the trainable's own length, past ASHA's max_t
PBT_LRS = (3e-3, 1e-4)
PBT_STEPS = 6      # 10b: steps a trial
PBT_INTERVAL = 2   # 10b: the perturbation interval and checkpoint period
TUNER_LRS = (1e-3, 3e-4)
TUNER_STEPS = 3    # 10c: steps of each trial's fit


class TuneRuntime(InlineRuntime):
    """``InlineRuntime`` that notes, when it kills a trial's actor (the
    last step of the runner's stop), whether the trial's thread still runs
    and how many steps the trial had launched (``launched[trial_id]``, kept
    by the trainable): ``killed[trial_id]``, one entry a stop (a PBT
    exploit stops a trial and starts it again)."""

    def __init__(self, launched):
        self.launched, self.killed = launched, {}

    def kill(self, actor):
        obj = actor._obj
        if getattr(obj, "_thread", None) is not None:
            tid = obj._session.ctx.trial_id
            self.killed.setdefault(tid, []).append(
                (obj._thread.is_alive(), self.launched.get(tid, 0)))
        super().kill(actor)


def same_bits(torch, a, b):
    """``a`` and ``b`` hold the same bits (compared on ``a``'s device)."""
    b = b.to(a.device)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(ints[x.element_size()]) for x in (a, b))
    return torch.equal(a, b)


def tensor_leaves(torch, tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tensor_leaves(torch, v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tune_phase(torch, A, dev, root):
    """Phase 10: the Tune library on the card. Trials run as threads of
    this process (``TuneRuntime``), each training gpt2-124m (batch 8, S
    1024, bf16 with an fp32 master, ``default_optimizer(lr)``, bench.py's
    tokens from ``default_rng(0)``) through ``build_train`` from init(0).

    10a: ASHA (``AsyncHyperBandScheduler(**ASHA)``) over ASHA_LRS, two
    trials at a time, a function trainable of ASHA_STEPS steps reporting
    the loss of each: every trial stopped by ASHA, its reported losses
    bit-equal to a direct ``build_train`` run at its lr; when its actor is
    killed its thread has ended, having launched at most one step past
    its last report (a launch count taken after the stop), and K1-K3
    launched 12 times for each step the trials launched; the best trial
    the one with the lowest last loss. 10b: PBT over PBT_LRS, two at a
    time, PBT_STEPS steps with a checkpoint (params and optimizer state)
    every PBT_INTERVAL: at least one exploit, each exploiting trial's
    parameters and optimizer state after its restore bit-equal on the card
    to the source checkpoint's tensors, every thread ended before its
    slot is reused. 10c: ``Tuner(TorchTrainer(...))`` over TUNER_LRS (two
    at a time, each fit on its own InlineRuntime), TUNER_STEPS steps: each
    trial's one result equal to a ``TorchTrainer.fit`` at its config and
    to ``build_train``'s last loss. Every run: no general kernel. Prints
    each trial's wall seconds, a step's ms in a trial beside
    ``build_train``'s outside Tune, the snapshot seconds and GB of each
    checkpoint, peak memory at two concurrent trials, and the phase's
    K1-K3 launches. Returns the launches of the Tune runs by kernel and
    the phase's numbers."""
    import shutil
    import threading

    import numpy as np

    from ray_tpu_torch import tune
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import (Checkpoint, RunConfig, TorchTrainer,
                                     default_optimizer, session)
    from ray_tpu_torch.train.checkpoint import tree_map
    from ray_tpu_torch.train.step import build_train

    t_phase = time.perf_counter()
    card = smi_line()
    work = os.path.join(root, "chiprun_out", "tune_10")
    shutil.rmtree(work, ignore_errors=True)
    cfg = gpt2_124m_config(gpt2, torch)
    batch, seq = 8, 1024
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int64)
    data = {"tokens": torch.from_numpy(tokens).to(dev)}
    wrappers = A.KERNEL_WRAPPERS + A.GENERAL_WRAPPERS
    lock = threading.Lock()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731

    def build(lr):
        return build_train(lambda g: gpt2.GPT2(cfg, g),
                           lambda m, b: m.loss_fn(b),
                           optimizer=default_optimizer(lr), master_fp32=True)

    def launched_by(run):
        """``run()``'s result and the kernel launches it made."""
        A.reset_launch_counts()
        result = run()
        return result, {f.__name__: f.launches for f in wrappers}

    def require_kernels(what, launches, steps):
        require(all(launches[f.__name__] == cfg.num_layers * steps
                    for f in A.KERNEL_WRAPPERS)
                and all(launches[f.__name__] == 0
                        for f in A.GENERAL_WRAPPERS),
                f"{what}: K1-K3 {cfg.num_layers} launches for each of "
                f"{steps} steps, no general kernel ({launches})")

    def direct(lr, n):
        """``n`` steps of ``build_train`` at ``lr`` from init(0), outside
        Tune: (losses, step ms)."""
        init, step_fn = build(lr)
        model, opt, k = init(0)
        losses, ms = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            model, opt, k, met = step_fn(model, opt, k, data)
            losses.append(met["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        del model, opt, met
        return losses, ms

    out = {"launches": {f.__name__: 0 for f in wrappers}}

    def add_launches(launches):
        for k, v in launches.items():
            out["launches"][k] += v

    try:
        # -- 10a. ASHA ------------------------------------------------------
        launched, rec = {}, {}

        def asha_trainable(config):
            tid = session.get_trial_id()
            t0 = time.perf_counter()
            init, step_fn = build(config["lr"])
            model, opt, n = init(0)
            r = rec[tid] = {"step_ms": []}
            for _ in range(ASHA_STEPS):
                with lock:
                    launched[tid] = launched.get(tid, 0) + 1
                ts = time.perf_counter()
                model, opt, n, met = step_fn(model, opt, n, data)
                loss = met["loss"].item()
                r["step_ms"].append((time.perf_counter() - ts) * 1e3)
                r["wall_s"] = time.perf_counter() - t0
                tune.report({"loss": loss})

        rt = TuneRuntime(launched)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grid, launches = launched_by(lambda: tune.Tuner(
            asha_trainable,
            param_space={"lr": tune.grid_search(list(ASHA_LRS))},
            tune_config=tune.TuneConfig(
                scheduler=tune.AsyncHyperBandScheduler(
                    metric="loss", mode="min", **ASHA),
                max_concurrent_trials=2),
            runtime=rt).fit())
        asha_wall = time.perf_counter() - t0
        peak_two = torch.cuda.max_memory_allocated() / 1e9
        add_launches(launches)
        require_kernels("10a", launches, sum(launched.values()))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for t in grid.trials:
            lr, tid = t.config["lr"], t.trial_id
            require(t.status == "STOPPED" and t.error is None,
                    f"10a lr {lr}: stopped by ASHA ({t.status}: {t.error})")
            losses = [r["loss"] for r in t.results]
            kills = rt.killed.get(tid, [])
            require(len(kills) == 1 and not kills[0][0],
                    f"10a lr {lr}: the trial's thread ended before its "
                    f"actor was killed ({kills})")
            require(kills[0][1] == launched[tid] <= len(losses) + 1,
                    f"10a lr {lr}: no step launched after the stop "
                    f"({launched[tid]} launched, {len(losses)} reported, "
                    f"{kills[0][1]} at the kill)")
            ref, ref_ms = direct(lr, len(losses))
            print(f"10a lr {lr}: {t.status} at iteration {t.iteration} "
                  f"(launched {launched[tid]} of {ASHA_STEPS} steps); "
                  f"losses {losses}")
            require(losses == ref, f"10a lr {lr}: the trial's losses "
                                   f"bit-equal to build_train's {ref}")
            rows.append(dict(lr=lr, iteration=t.iteration,
                             launched=launched[tid],
                             last_loss=t.last_result["loss"],
                             wall_s=rec[tid]["wall_s"],
                             step_ms=med(rec[tid]["step_ms"][1:]),
                             direct_step_ms=med(ref_ms[1:])))
        peak_one = torch.cuda.max_memory_allocated() / 1e9
        best = grid.get_best_result("loss", "min")
        lowest = min(grid.trials, key=lambda t: t.last_result["loss"])
        require(best is lowest, "10a: the best trial has the lowest loss")
        early = [r["lr"] for r in rows if r["iteration"] < ASHA["max_t"]]
        print(f"10a ASHA on {card}: {len(rows)} trials, 2 at a time, "
              f"{asha_wall:.3f} s wall; stopped before max_t "
              f"{ASHA['max_t']}: lr {early}; best lr {best.config['lr']} "
              f"(loss {best.last_result['loss']}); per trial (lr, wall s, "
              f"median step ms in the trial beside build_train's alone) "
              + "; ".join(f"{r['lr']}: {r['wall_s']:.3f} s, "
                          f"{r['step_ms']:.3f} / {r['direct_step_ms']:.3f}"
                          f" ms" for r in rows)
              + f"; peak memory {peak_two:.3f} GB with two trials at once, "
              f"{peak_one:.3f} GB for build_train alone; launches {launches}")
        out["asha"] = dict(trials=rows, wall_s=asha_wall,
                           peak_gb_two_trials=peak_two,
                           peak_gb_one_run=peak_one, early_lrs=early,
                           launches=launches)
        del grid, best, lowest
        torch.cuda.empty_cache()

        # -- 10b. PBT -------------------------------------------------------
        launched, restores, snaps = {}, [], []

        def on_card(tree):
            return tree_map(lambda x: x.to(dev)
                            if isinstance(x, torch.Tensor) else x, tree)

        def pbt_trainable(config):
            tid = session.get_trial_id()
            init, step_fn = build(config["lr"])
            model, opt, n = init(0)
            ckpt = session.get_checkpoint()
            if ckpt is not None:
                t0 = time.perf_counter()
                state = ckpt.to_dict()
                params = dict(model.named_parameters())
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(state["params"][name])
                opt, n = on_card(state["opt_state"]), state["step"]
                mine = list(params.values()) + tensor_leaves(torch, opt)
                theirs = (tensor_leaves(torch, state["params"])
                          + tensor_leaves(torch, state["opt_state"]))
                same = len(mine) == len(theirs) and all(
                    a.is_cuda == (dev.type == "cuda")
                    and same_bits(torch, a, b) for a, b in zip(mine, theirs))
                torch.cuda.synchronize()
                restores.append(dict(trial=tid, lr=config["lr"], step=n,
                                     tensors=len(mine), bit_equal=same,
                                     restore_s=time.perf_counter() - t0))
            while n < PBT_STEPS:
                with lock:
                    launched[tid] = launched.get(tid, 0) + 1
                model, opt, n, met = step_fn(model, opt, n, data)
                loss = met["loss"].item()
                ck = None
                if n % PBT_INTERVAL == 0:
                    ck = Checkpoint.from_dict({
                        "step": n, "params": dict(model.named_parameters()),
                        "opt_state": opt})
                t0 = time.perf_counter()
                tune.report({"loss": loss}, checkpoint=ck)
                if ck is not None:
                    gb = sum(x.numel() * x.element_size() for x in
                             tensor_leaves(torch, ck._data)) / 1e9
                    snaps.append((time.perf_counter() - t0, gb))

        rt = TuneRuntime(launched)
        t0 = time.perf_counter()
        grid, launches = launched_by(lambda: tune.Tuner(
            pbt_trainable,
            param_space={"lr": tune.grid_search(list(PBT_LRS))},
            tune_config=tune.TuneConfig(
                scheduler=tune.PopulationBasedTraining(
                    metric="loss", mode="min",
                    perturbation_interval=PBT_INTERVAL,
                    hyperparam_mutations={"lr": list(ASHA_LRS)}, seed=0),
                max_concurrent_trials=2),
            runtime=rt).fit())
        pbt_wall = time.perf_counter() - t0
        add_launches(launches)
        require_kernels("10b", launches, sum(launched.values()))
        for t in grid.trials:
            require(t.status == "TERMINATED" and t.error is None,
                    f"10b {t.trial_id}: {t.status} {t.error}")
        print(f"10b PBT restores {restores}")
        require(restores, "10b: at least one exploit")
        require(all(r["bit_equal"] for r in restores),
                "10b: the exploiting trial's parameters and optimizer state "
                "after its restore bit-equal on the card to the source "
                "checkpoint's")
        kills = [k for ks in rt.killed.values() for k in ks]
        require(not any(alive for alive, _ in kills),
                f"10b: every trial's thread ended before its actor was "
                f"killed and its slot reused ({rt.killed})")
        print(f"10b PBT on {card}: {len(grid.trials)} trials, 2 at a time, "
              f"{pbt_wall:.3f} s wall; configs at the end "
              f"{[t.config for t in grid.trials]}; exploits "
              f"{len(restores)} (restore s "
              f"{[round(r['restore_s'], 3) for r in restores]}); "
              f"checkpoint snapshots to the host at report (s, GB) "
              f"{[(round(s, 3), round(g, 3)) for s, g in snaps]}; launches "
              f"{launches}")
        out["pbt"] = dict(wall_s=pbt_wall, restores=restores, snapshots=snaps,
                          launches=launches,
                          configs=[t.config for t in grid.trials])
        del grid
        torch.cuda.empty_cache()

        # -- 10c. Tuner(TorchTrainer(...)) ----------------------------------
        fit_ms = {}

        def train_fn(config):
            init, step_fn = build(config["lr"])
            model, opt, n = init(0)
            for _ in range(TUNER_STEPS):
                ts = time.perf_counter()
                model, opt, n, met = step_fn(model, opt, n, data)
                loss = met["loss"].item()
                with lock:
                    fit_ms.setdefault(config["lr"], []).append(
                        (time.perf_counter() - ts) * 1e3)
                session.report({"loss": loss, "step": n})

        def trainer(**config):
            return TorchTrainer(train_fn, train_loop_config=config or None,
                                run_config=RunConfig(storage_path=work),
                                runtime=InlineRuntime())

        t0 = time.perf_counter()
        grid, launches = launched_by(lambda: tune.Tuner(
            trainer(),
            param_space={"lr": tune.grid_search(list(TUNER_LRS))},
            tune_config=tune.TuneConfig(max_concurrent_trials=2),
            runtime=TuneRuntime({})).fit())
        tuner_wall = time.perf_counter() - t0
        add_launches(launches)
        require_kernels("10c", launches, TUNER_STEPS * len(TUNER_LRS))
        for t in grid.trials:
            lr = t.config["lr"]
            require(t.status == "TERMINATED" and len(t.results) == 1,
                    f"10c lr {lr}: one result ({t.status}, {t.results}, "
                    f"{t.error})")
            fit = trainer(lr=lr).fit()
            ref, _ = direct(lr, TUNER_STEPS)
            got = dict(t.last_result)
            got.pop("training_iteration")
            print(f"10c lr {lr}: the trial's result {got}, TorchTrainer.fit"
                  f"'s {fit.metrics}, build_train's losses {ref}")
            require(fit.ok and got == fit.metrics
                    and got["loss"] == ref[-1],
                    f"10c lr {lr}: the trial's result equals "
                    f"TorchTrainer.fit's and build_train's last loss")
        print(f"10c Tuner(TorchTrainer) on {card}: {len(grid.trials)} "
              f"trials, 2 at a time, {tuner_wall:.3f} s wall; step ms "
              f"(the trial's fit, then the direct fit) "
              + "; ".join(f"{lr}: {[round(x, 3) for x in ms]}"
                          for lr, ms in fit_ms.items())
              + f"; launches {launches}")
        out["tuner"] = dict(wall_s=tuner_wall, step_ms=fit_ms,
                            launches=launches)
        del grid
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 10 (the Tune library): K1-K3 launches of its Tune runs "
          f"{out['launches']}; {time.perf_counter() - t_phase:.3f} s wall; "
          f"{card}")
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
