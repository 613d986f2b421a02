#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
the port still starts on the card.

    python3 chip_smoke.py             # what CI runs on the H100
    python3 chip_smoke.py --profile   # + a torch.profiler breakdown of one
                                      #   more round of each path (phases 3
                                      #   and 9), and of one prefill and one
                                      #   decode step
    python3 chip_smoke.py --cards 4   # phase 7 alone, across 4 cards

Phases (any failure exits non-zero; nothing is caught and turned into a pass):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and TF32 switched off for cuDNN convolutions and matmuls;
2. kernels: build the CUDA kernels from ``src/repro_torch/csrc`` (and the
   Triton one on first launch), hold each against its plain PyTorch version
   on the card at the main paths' shapes — the four one-step dual-solve
   variants (gamma grid, outage-priced, joint (gamma, bits), joint +
   priced), the four fused dual ascents (phase 4's inputs, 5 warm-started
   rounds, capped and stopped early with dead clients: masks, gammas,
   widths and n_inner equal, lam, mu and the last two residuals that the
   solver's fallback guard reads rtol 1e-5), both kernels of every
   variant past 32 levels (L = 33, 40, 50, 100: gamma-only grids of L even
   steps, joint grids of 11 x 3, 10 x 4, 10 x 5 and 10 x 10 levels; phase
   4's inputs, 2 rounds, capped, early exit and dead clients, the same
   gates; each fused variant timed at L = 40 and 100), the per-row block
   top-k (main-path rows, NaN/Inf/-0.0/tie rows with a 0x7fffffff NaN and
   a row of one value, rows of denormals, which compare as zero (C-16),
   all-full, rows of odd length and inputs off a 16-byte word), the block
   top-k of one vector (the CNN's flat update at
   gamma 0.25 and 0.1, in fp32 and bf16, blocks 256 and 1024, k = block,
   the same NaN/Inf/-0.0/tie lanes in fp32 and bf16, inputs off a word),
   each bit for bit, with the top-k kernels' registers, spills and shared
   bytes; the row norms (also on rows holding NaN, +Inf and rows scaled
   by -1e3: the screen-less defended clip's inputs) and flash attention,
   bf16 on the tensor cores and
   fp32 on the register-tiled SIMT kernel (the serve path's [4, 2048, 32|4, 64] bf16
   causal, a 256 window, fp32, a ragged S = 1000, D = 32 and D = 128 in
   both types, phase 11's [4, 4096, 32|4, 64], and head dims 80 and 96:
   zamba2's [4, 2048, 32|32, 80] and phi-3-vision's D at [2, 2048, 32|32, 96], causal, in both
   types, each timed beside its bound and SDPA, a 512 window at D = 80, a
   ragged S = 1000 at D = 96, and whisper's decoder calls of phase 13 at
   [4, 4096, 6|6, 64], G = 1: the non-causal cross-attention against 1,500
   keys, a ragged last key tile, and the causal self-attention, both types,
   each timed beside its bound and SDPA), each case also launched
   with its log-sum-exp output (out unchanged, lse within 1e-5 in fp32 and
   1e-2 in bf16 of ``flash_fwd_ref``'s), and at phase 11's shape the
   autograd Function's gradients (the kernel forward, ``flash_bwd_ref``
   backward) against the all-plain forward's through the same backward
   (within 1e-5 of their scale in fp32, 2e-2 in bf16; also at whisper's
   non-causal cross shape, 4,096 queries against 1,500 keys, and at one
   D = 256 shape), the kernel's ms with and without lse and
   ``flash_bwd_ref``'s beside its fp32 bound and SDPA's backward; head
   dims 16, 36, 48, 112, 160, 192, 224 and 256 in both types (a causal
   call, windows, ragged S, non-causal calls with Skv != Sq; Gemma-2B's
   [4, 2048, 8|1, 256]), each compiled width's registers and spills, and
   a call at each new width and at Gemma-2B's and Gemma-7B's [2, 2048,
   16|16, 256] timed beside its bound and SDPA; the norms kernel timed in
   five turns with ``vector_norm`` (medians) —
   and time
   both (CUDA events) and the library call computing the same function
   where there is one (a fused ascent also beside the host loop over the
   one-step kernel that it replaced; the top-k rows kernel also at the ks
   of the main path's last round, after phase 3);
3. paths: ``repro_torch.fl.FederatedTrainer.run_scanned(5)`` with the
   paper's full-width FMNIST CNN (D = 1,630,090), N = 50 clients and the
   recipe of ``repro_torch.launch.experiments.build`` (the port of
   ``benchmarks/fl_experiments.build``, weights from its seeded
   ``init_cnn``), on ``cuda``, four
   times: the legacy main path, (a) the ``quantized`` scenario, (b)
   ``bursty-interference`` with ``price_outage``, and (c) (b) with the
   joint grid (8, 16, 32), then (d) and (e): (a) and (c) on the 40-level
   grid of the paper's gammas x (4, 8, 16, 32). Each path's launch counts are zeroed just
   before it and read just after: its own fused dual ascent exactly once
   a round, no other variant and no one-step dual solve, and the top-k
   and the norms must have launched; params,
   energies and accuracy must be finite; (a) and (c) must send some update
   below 32 bits, (b) and (c) must retransmit;
4. card against CPU: ``solve_round`` at the main path's setting (N = 50,
   full-width payload, default solver config) for 5 rounds, for each
   dual-solve variant, and with ``bw_solver="gss"`` for its warm-started
   rounds 0-2 (plain PyTorch, launch-bound: 18-52 s a round on the card,
   by the host; the cut from 5 rounds; energies within 2e-3, ROADMAP
   C-18), whose card and CPU sides run in child processes during phase
   14, then the smoke CNN with N = 8 for
   2 rounds of the legacy trainer, of paths (c), (d) and (e) (the last two
   on the paper's 10 gammas x (4, 8, 16, 32): 40 levels) and of the five other
   strategies (``scoremax``, ``ecorandom``, ``randomfull``,
   ``channelgreedy``, ``tilted``), each on ``cuda`` and on ``cpu`` from
   the same inputs: equal masks (a split is reported with its score gap),
   gammas, widths, ``n_inner`` and retransmission counts, energies to rtol
   1e-5 (solver) and 1e-4 (trainer); the baselines' ``topk_mask`` on
   CUDA tensors against ``np.argsort`` (ties, NaN); and 3 rounds of the
   timed, fault and defense paths (``straggler``, ``harvesting`` with a
   quantile deadline, ``churn``, ``byzantine-lite``, and byzantine-lite
   on the oscillating solver setting with ``solver_fallback``, which must
   take the fallback): ``made``, ``n_late``, ``n_stale``, ``n_faulted``,
   ``n_rejected`` and ``fallback`` equal, energies and ``t_round`` rtol
   1e-5, ``clip_frac`` within 1e-6; and 3 rounds of the population-scale
   paths (the ``mobility`` scenario, the hierarchy with clusters 2 and
   pool_frac 0.5, that with the joint bits grid, and under churn): the
   pool of every round, the cluster assignment, masks and bits equal,
   energies rtol 1e-5;
5. serve: ``repro_torch.launch.serve.generate`` with TinyLlama-1.1B at full
   width (22 layers, d 2048, random weights from a seeded generator on the
   card, bf16): 4 prompts of 2048 ids, 32 new tokens each, once to warm up
   and once timed (prefill ms, decode ms a step, tokens/s, peak memory).
   The timed run must launch the flash kernel 22 times (one per layer of
   the prefill; a lone decode step launches none), give finite logits and
   32 new ids a request, and its first decode step's logits must match
   ``lm_forward`` over prompt + token at that position (the ring cache
   against the flash branch);
5b. prefill in fp32: ``lm_prefill`` of TinyLlama-1.1B at full width in
   fp32 (seeded random weights), 4 prompts of 2048 ids, once to warm up and
   once timed: 22 launches of the fp32 flash kernel and nothing else,
   finite last-position logits within 1e-4 of their scale of the same
   prefill with the attention patched (in this script only) to the plain
   version, and the flash kernel's share of the prefill;
6. serve, card against CPU: the smoke TinyLlama in fp32 from the same
   weights and seed, prompt 2048 (so the card takes the fp32 kernel), 8 tokens
   at batch 2: equal prompt ids, logits to rtol 1e-4, equal sampled ids up
   to the first documented tie; then the same in bf16 (the tensor-core
   kernel), logits within 5% of their scale and ties within that;
7. the multi-rank paths on one rank: a one-rank NCCL process group
   (``file://`` store in a temporary directory). (a) The cross-silo
   aggregation on a ``(pod, data, model) = (1, 1, 1)`` mesh with the
   CNN's flat update at gamma 0.25: ``make_fl_allreduce`` equals
   ``block_topk_sparsify`` bit for bit and launches the block top-k once
   a call; the sparse exchange agrees with it to 1e-6 and the int8 one to
   0.02 relative on the vector padded to whole blocks. (b)
   ``FederatedTrainer(mesh=make_clients_mesh())`` on the main path's
   recipe: equal masks and gammas to phase 3's main path, energies rtol
   1e-5, params atol 1e-6, and the main path's launches of the dual-solve,
   top-k rows and norm kernels (one fused ascent a round). Then C-17's gate
   (``client_step_by_card``): the client step over 13 clients a call (one
   of 4 cards' share) equals the same clients' rows of the step over all
   50, bit for bit, and two calls of one step agree, with the step's time
   at each chunk size beside the client module's CLIENT_CHUNK.

8. the paper's experiment: ``repro_torch.launch.experiments.run_all`` at
   the recipe's own 60 rounds, N = 50, with the extra baselines, seed
   lanes (0, 1) for every strategy and FairEnergy's eta lanes (0.04,
   0.16), each run's launch counts zeroed just before it and read just
   after (FairEnergy's fused ascent once a round of each lane, no
   dual-solve kernel in a baseline run, the top-k rows and the norms in
   every run), the protocol's K, EcoRandom gamma (< 1) and bandwidth in
   range, finite energies and accuracies, and every strategy's seed-0
   lane equal to its ``run_scanned`` run bit for bit; one line a strategy
   (steady rounds/s, sweep rounds/s, energy a round, final accuracy,
   participation) and FairEnergy's energy against each baseline's; the
   results JSON goes to ``build/chip_smoke/``; then
   ``launch.experiments.cli`` at N = 50, 3 rounds, without and with
   ``--shard-clients`` (one NCCL rank here): the two JSONs equal but for
   the wall time;
9. the timed, fault and defense paths at full width (N = 50, the paper's
   CNN, ``experiments.build``): ``straggler`` (its [50, D] stale buffer
   in the carry), ``harvesting``, ``churn``, ``byzantine-lite`` (trim 0.1)
   and byzantine-lite with ``solver_fallback``, 20 rounds each, every
   run's launch counts zeroed before it and asserted after (the fused
   ascent and the top-k rows once a round, the norms once a round plus
   once a clipped round); one line a path (steady round, rounds/s, peak
   memory, late/stale/fault/rejected/clip totals, energy a round against
   the main path's); then the checkpoint on the card: 10 straggler rounds
   with a checkpoint every 5, a fresh trainer restored at round 5
   continuing with equal masks and energies and bit-equal params, and
   ``verify_checkpoint`` rejecting a copy with one flipped byte (under
   ``build/chip_smoke/``, removed after);
10. hierarchy and mobility at full CNN width (``experiments.build``),
   each run's launch counts zeroed before it and asserted after (one fused
   ascent a round, of K_pool clients; the top-k rows once a round; the
   norms once a round plus the calibration), finite params and energies,
   at most K_pool selected: (a) the ``mobility`` scenario at N = 50, 20
   rounds (steady round, energy a round against the main path's); (b)
   clusters 4, pool_frac 0.25 at N = 50 (K_pool 12), 20 rounds
   checkpointed every 5, resumed at 5: pools, masks, energies and params
   bit for bit; (c) N = 1,000 clients over 60,000 images, clusters 4,
   pool_frac 0.25 (K_pool 250), 10 rounds, against the same recipe
   solving the full population: steady round ms, peak memory, every
   k-means cluster in every pool, final accuracy, then one more round
   whose kernels are held against their plain versions on that round's
   own inputs (the fused ascent on the [250] pool or all [1000] clients:
   masks, gammas, widths and n_inner equal, lam, mu, b*, e* and the
   residuals rtol 1e-5; the top-k rows bit for bit and the norms rtol
   1e-6 on the [1000, D] update matrix) and three more for the ascent's
   device ms; (d) the decide alone, full against pooled (pool_size 512,
   clusters 8 at N >= 64) on ``benchmarks/hierarchy_bench.py``'s
   synthetic channel statistics at N = 50, 10,000 and 100,000: ms a
   decide over 10 decides after a warm-up one, the fused ascent's device
   ms a decide, and one more decide's ascent (on 50, 512, 10^4 or 10^5
   clients) held against its plain version as in (c);
11. training: ``launch.steps.build_train_step`` on TinyLlama-1.1B at full
   width (fp32 master weights from a seeded generator on the card, bf16
   activations, remat), AdamW lr 3e-4, batch 8 x 4096 tokens (train_4k's
   sequence; its global batch 256 cut to one card's 8) in 2 microbatches:
   1 warm-up and 6 timed steps with the counts zeroed before them: finite
   losses, the last below the first, the bf16 flash kernel launched with
   lse 2 x 22 x 2 times a step (forward and remat recompute), the plain
   backward called 22 x 2 times, no other kernel; ms a step, tokens/s,
   peak memory, and one more step split by CUDA events (the flash
   forward, ``flash_bwd_ref``, AdamW; ``--profile`` adds the GEMMs' share);
11b. the smoke TinyLlama, 3 AdamW steps at seq 2048, batch 2, on the card
   and the CPU from the same weights: fp32 first-step gradients within
   1e-5 of their scale, losses rtol 1e-5, params within 1e-5 of their
   scale but for at most 0.1% of a leaf (AdamW's near-zero-gradient
   elements), which stay within 3 lr; bf16 losses within 2e-2;
12. the moe, ssm and hybrid LM families served through ``serve.generate``
   at full width, bf16, seeded random weights cast to the serving copy in
   place (``for_compute(..., inplace=True)``: qwen2-moe's fp32 masters and
   copy would not fit together), each freed before the next:
   qwen2-moe-a2.7b (24 layers, 60 experts top-4 + 4 shared), mixtral-8x22b
   at 4 of its 56 layers (1 prompt of 8,192 ids, 16 tokens: its 4,096
   window bites on the flash branch), rwkv6-1.6b and zamba2-2.7b (54
   Mamba2 layers, the shared block every 6, head_dim 80); otherwise 4
   prompts of 2,048 ids and 32 tokens. Each: set-up s, prefill ms, decode
   ms a step, tokens/s, peak memory, launches (the bf16 flash kernel once
   per attention layer of the prefill: 24 / 4 / 0 / 9, none in a decode
   step, no other kernel), ids in the vocabulary, finite logits, and the
   first decode step against ``lm_forward`` (5% of the logits' scale; the
   MoE at capacity 8 with the token's routing pinned to the decode's,
   the ring at mixtral's window); ``--profile`` adds each one's prefill
   and decode-step breakdown and idle share;
12b. each family's smoke model (qwen2-moe, rwkv6, zamba2 at head_dim 80),
   prompt 2,048, card against CPU in fp32 and bf16 as phase 6: equal ids,
   logits within phase 6's gates, and the MoE's experts and dispatch
   slots equal on both devices but for routing ties (fp32: a gap under
   1e-5; bf16: under 5% of the larger probability), whose count is
   printed;
13. the audio and VLM families at full width, bf16, seeded, each run's
   counts zeroed before it and read after: (a) whisper-tiny (4 + 4 layers,
   d 384, vocab 51,865, 1,500 frames) through ``serve.generate``, batch 4,
   32 tokens: no kernel at all (the encoder's 1,500 frames take the direct
   branch, decode is plain), the first decode step against
   ``decode_train`` over that token (5% of the logits' scale), encode and
   decode ms, tokens/s, peak memory; (b) its prefill step at the
   reference's prefill_32k shape, 32 x 32,768 decoder tokens against 32 x
   1,500 frames (the batch cut, and the cut printed, only if it does not
   fit): 8 bf16 flash launches (4 causal self, 4 non-causal cross
   attentions) and no other kernel, then 8 decode steps from its fresh
   cache (ROADMAP C-25); (c) its training, 8 x 4,096 decoder tokens in 2
   microbatches, AdamW lr 3e-4, 1 warm-up and 6 timed steps: 32 launches
   with lse and 16 ``flash_bwd_ref`` calls a step; (d) phi-3-vision-4.2b
   (32 layers, d 3,072, head dim 96) through ``serve.generate``, 4 x 2,048
   ids, 32 tokens (32 launches a prefill, none a decode step, the first
   step against ``lm_forward``), then its vision path: the prefill step
   with 576 vision embeddings + 1,472 ids (32 launches) and 8 serve steps,
   the first against ``lm_forward`` with the same embeddings; (e) its
   training at a cut depth that fits the card with fp32 masters, AdamW
   moments and gradients, 4 x (576 + 3,520) positions, gated as (c); (f)
   the smoke whisper (2,048 decoder ids against 64 frames: both attentions
   on the flash branch) and phi-3-vision (16 + 2,032 positions), card
   against CPU in fp32 and bf16 as phase 6 (a prefill step and 4 greedy
   serve steps: equal ids or a documented tie, logits within phase 6's
   gates), and 3 AdamW steps of each in fp32 as phase 11b;
14. the sharding plan and the other families' training: (a)
   qwen2-moe-a2.7b (3 of its 24 layers: 4 do not fit the card with fp32
   masters, moments and gradients), rwkv6-1.6b and zamba2-2.7b (full
   depth) trained at full width, bf16, 8 x 4,096 tokens in 2
   microbatches, remat, AdamW: 1 warm-up and 2 timed steps (qwen2-moe)
   or 1 (rwkv6, zamba2: 13-26 s a step), each run's counts zeroed before
   them (finite, falling losses; the bf16 flash
   kernel with lse twice and ``flash_bwd_ref`` once a flash-branch
   attention call a microbatch: 12 / 0 / 36 launches a step; no other
   kernel), ms a step, tokens/s, peak memory; then each smoke model's 3
   fp32 AdamW steps card against CPU as phase 13 (f) (first gradients
   within 1e-5 of each leaf's scale, 1e-4 for rwkv6 and zamba2); (b) a
   one-rank NCCL group, ``launch.mesh.make_host_mesh()`` (1 x 1), the
   smoke TinyLlama's fp32 parameters as DTensors laid out by
   ``sharding.param_specs``, and 3 AdamW steps at S = 2,048 under
   ``activation_rules``, against the same steps on plain tensors: the
   flash kernel reached through the DTensors' local shards (12 launches
   with lse, 6 backward calls, as the plain run's), losses and
   parameters bit for bit or within phase 11b's gates; (c) the dry-run
   CLI (``python -m repro_torch.launch.dryrun``) for tinyllama-1.1b
   train_4k on the 16 x 16 mesh and whisper-tiny decode_32k on 2 x 16 x
   16, each in its own process on the CPU while (a) and (b) run, its JSON
   printed on a line of its own. Phase 4's GSS check runs meanwhile
   (its card side a second process on the card), so (a)'s step times
   carry that contention;
15. the smoke TinyLlama with ``head_dim=256`` (``dataclasses.replace``;
   Gemma's head dim) at 2,048 tokens on the flash branch, card against
   CPU under phase 13 (f)'s gates: a prefill and 4 greedy serve steps in
   fp32 and bf16 (one launch of the kernel of the type a layer), and 3
   fp32 AdamW steps (2 lse launches a layer a step).
16. (run after phase 2) (a) both top-k kernels at block widths 1, 100,
   128, 256, 1,000, 1,024, 2,048, 4,096, 8,192, 65,536 and a whole row
   of the CNN (1,630,090: in-register instances up to 4,096 lanes, the
   streaming kernel above) against their plain versions bit for bit:
   ``block_topk_rows`` with and without the all-full skip and the rows
   entry ``block_topk_sparsify_rows`` at literal ks (0, -3, 1, w, w + 7)
   on phase 2's tricky rows and on four tricky rows of the CNN's D, the
   block kernel in fp32 and bf16; each width timed on the device beside
   its bytes bound and ``torch.topk`` + ``scatter_``; (b) ``l2_norm`` on
   the card against ``l2_norm_ref`` and the reference's block rule (fp32
   rtol 1e-6), timed beside ``vector_norm``; (c) ``make_scan_engine`` on
   the golden MLP 12 rounds card against CPU at blocks 4,096 (and against
   the golden file) and 1,024 (a grid without 1.0), each card run's
   launches zeroed before it and asserted after (an ascent, a norms and a
   rows launch a round), and one ``make_round_engine`` round at 1,024.
17. (a) both flash kernels at head dims 264, 288, 300, 320, 384, 512 and
   1,024 (column groups of O, one a CTA; bf16 and fp16 on the tensor
   cores: the wide kernel to 320, a thread-block cluster from 321, and at
   1,792, 1,800 and 3,600 its largest cluster and the split route past it;
   fp32 on the 3xTF32 cluster, and at 2,048, 2,056 and 4,104 its largest
   cluster and the split route past it) against ``attention_ref`` and
   ``flash_fwd_ref``'s lse, causal GQA, windowed and cross (Skv != Sq),
   each call's route counted; each D timed at ``[4, 2048, 32 | 4, D]``
   beside its operations bound, the plain version and SDPA (its backend
   named); the split route also held at that shape in fp32 (D = 2,056)
   and bf16 (1,800), each call in two pieces of its workspace (counted);
   (b) fp16 at D = 64, 80, 128 and 256 the same; (c) the smoke
   TinyLlama at ``head_dim=512``, one of its two layers, card against CPU
   under phase 15's gates
   (prefill and 4 greedy steps in fp32, bf16 and fp16, 3 fp32 AdamW steps
   with 2 lse launches a layer a step; every fp32 launch on the 3xTF32
   cluster, every bf16 and fp16 launch on the 16-bit cluster); (d) TinyLlama-1.1B served in fp16
   at phase 5's shape (22 fp16 launches, each held against the plain
   version; the first decode step within 5% of the forward's scale) and
   the smoke model in fp16 card against CPU, as phase 6; (e) the fp16
   block top-k at widths 256, 4,096 and 65,536 bit for bit on the tricky
   rows and fp16's subnormals and NaNs; (f) a launch with B * H = 65,600;
   (g) the smoke TinyLlama at ``head_dim=2056``, one layer, card against
   CPU (prefill and 4 greedy steps in fp32 and bf16; every launch on the
   split route).

``--only 16`` and ``--only 17`` run that phase alone after the build. ``--cards K`` runs
phase 7 alone across K cards (one NCCL rank a card,
after the build): the exchanges on a (2, K/2, 1) mesh against the pod mean
of the block top-k computed on each card, the main path's recipe sharded
over the K cards against rank 0's one-card run (masks and gammas equal,
energies rtol 1e-5, params atol 1e-6), with C-17's gate on rank 0's card
at K's share of the clients, and (7b) the straggler and byzantine-lite
scenarios sharded the same way (masks, made, stale and rejected counts
equal, params within 1e-6), and (7c) phase 10 (b)'s recipe on the (2,
K/2) ``(clusters, clients)`` hierarchy mesh against rank 0's one-card
run: the pool of every round, the cluster assignment, masks and params
bit for bit, (7d) the experiment CLI with ``--shard-clients`` on the K
ranks at N = 50 against the unsharded CLI on one card (equal JSON), and
(7e) the main path's recipe at N = 800 (the reference's
``sharded_engine_bench`` size; 60,000 images) sharded against one card:
masks, energies and params, and both round times.

Output: one JSON line per kernel check, per round and per path, one with
the elapsed seconds at the end of each phase, a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a visible GPU, or without the rest of the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; 700 W): HBM bytes/s,
# fp32 (non-tensor-core) and bf16 (dense tensor-core) operations/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12          # dense TF32 on the tensor cores
# an fp32 multiply-add in 3xTF32 is three TF32 products: the 3xTF32
# kernel's operations run at a third of the TF32 rate
PEAK_3XTF32_S = PEAK_TF32_S / 3

GRID = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
N_CLIENTS = 50
ROUNDS = 5


def log(*args):
    print(*args, flush=True)


START = time.perf_counter()


def stamp(phase: str) -> None:
    """The script's elapsed seconds at the end of ``phase``."""
    log(json.dumps({"phase_done": phase, "elapsed_s": time.perf_counter() - START}))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; for launch-bound work this is the launch rate)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernels whose name holds
    ``kernel``, over ``iters`` calls of ``fn`` (torch.profiler's CUDA
    activity): the kernel alone, without the host time between launches
    that CUDA events around back-to-back calls also count. The profiler
    has been seen to drop one launch's event from a session: a session that
    does not see exactly ``iters`` launches is run again, three at most."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count == iters:
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    raise AssertionError(f"the profiler saw {count} launches of {kernel} "
                         f"in {iters} calls")


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_S
          ) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-identical float32 tensors (any NaN payload counts as NaN)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32),
                                b[~nan].view(torch.int32)))


def diff_report(got: torch.Tensor, want: torch.Tensor, ks: torch.Tensor) -> str:
    """Per-row summary of the lanes where two [N, D] outputs differ."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    bad = (nan_g != nan_w) | (~nan_g & ~nan_w
                               & (got.view(torch.int32) != want.view(torch.int32)))
    lines = []
    for r in torch.nonzero(bad.any(dim=1)).flatten().tolist()[:8]:
        idx = torch.nonzero(bad[r]).flatten()
        i = idx[:4].tolist()
        lines.append(f"row {r} k={int(ks[r])}: {idx.numel()} lanes differ, "
                     f"first {i}: kernel {got[r, i].tolist()} "
                     f"plain {want[r, i].tolist()}")
    return "\n".join(lines)


# ------------------------------------------------------------ phase 2 ----
DUAL_VARIANTS = {
    # name: (e_scale, joint grid, TPU kernel it replaces)
    "dual_solve": (False, False, "src/repro/kernels/dual_solve/kernel.py:84"),
    "dual_solve_scaled": (True, False, "src/repro/kernels/dual_solve/kernel.py:99"),
    "dual_solve_joint": (False, True, "src/repro/kernels/dual_solve/kernel.py:167"),
    "dual_solve_joint_scaled": (True, True,
                                "src/repro/kernels/dual_solve/kernel.py:183"),
}
BITS = (8.0, 16.0, 32.0)
# the 40-level joint grid's widths: the paper's 10 gammas x 4
# (fl_experiments --bits-grid 4,8,16,32), paths (d) and (e)
BITS40 = (4.0, 8.0, 16.0, 32.0)
# phase 2's grids past the 32 levels of one lane group:
# L -> (the gamma-only grid of L even steps (L = 50: 0.02), the joint grid
# of L levels (gammas, widths))
WIDE_LEVELS = {
    L: (tuple((i + 1) / L for i in range(L)), joint)
    for L, joint in ((33, ((0.05,) + GRID, BITS)), (40, (GRID, BITS40)),
                     (50, (GRID, (2.0, 4.0, 8.0, 16.0, 32.0))),
                     (100, (GRID, (2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 16.0, 20.0,
                                   24.0, 32.0))))}
# each one-step variant -> the fused ascent of the same variant
FUSED = {name: name.replace("dual_solve", "dual_ascent") for name in DUAL_VARIANTS}


def check_dual_solve(dev, name: str) -> dict:
    """One dual-solve variant against the plain version: n in {50, 513},
    the lam sweep, the paper grid (x (8, 16, 32) when joint), e_scale from
    1 to 1000 (the expected attempts up to PRICE_P_CAP) when priced;
    the gamma-grid variant also on e_cmp = 0 from seed 1. gamma* and
    bits* exactly equal, b*/e*/phi* rtol 1e-5."""
    from repro_torch.core.link import expected_attempts
    from repro_torch.kernels.dual_solve import ops, ref
    scaled, joint, replaces = DUAL_VARIANTS[name]
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    kw = dict(gamma_grid=GRID, eta=f(1e-3), b_tot=f(1e7), s_bits=f(32 * 1_630_090.0),
              i_bits=f(1_630_090.0), n0=f(4e-21), b_lo=f(1e-4),
              bits_grid=BITS if joint else None)
    # (generator seed, draw e_cmp and e_scale?): the gamma-grid variant is
    # also held to the gamma-only kernel's own case, seed 1 with e_cmp = 0
    cases = ((1, False), (4, True)) if name == "dual_solve" else ((4, True),)
    err = 0.0
    for seed, drawn in cases:
        gen = torch.Generator().manual_seed(seed)
        for n in (50, 513):
            P = (1e-4 + 2e-4 * torch.rand(n, generator=gen)).to(dev)
            h = (1e-3 * (50 + 450 * torch.rand(n, generator=gen)) ** -3.0
                 * torch.empty(n).exponential_(generator=gen)).to(dev)
            u = (0.1 + 5.0 * torch.rand(n, generator=gen)).to(dev)
            if drawn:
                e_cmp = (1e-5 * torch.rand(n, generator=gen)).to(dev)
                p_out = 0.999 * torch.rand(n, generator=gen)
                p_out[:2] = torch.tensor([0.0, 0.999])
                es = expected_attempts(p_out).to(dev) if scaled else None
            else:
                e_cmp, es = torch.zeros(n, device=dev), None
            for lam in (0.0, 1e-5, 1e-4, 3e-3, 0.2):
                got = ops.dual_solve(P, h, u, f(lam), **kw, e_cmp=e_cmp, e_scale=es)
                want = ref.dual_solve_ref(P, h, u, f(lam), **kw, e_cmp=e_cmp, e_scale=es)
                assert len(got) == len(want) == (5 if joint else 4)
                exact = (0, 4) if joint else (0,)
                for i in exact:
                    if not torch.equal(got[i], want[i]):
                        raise AssertionError(f"{name} {('gamma*', '', '', '', 'bits*')[i]} "
                                             f"differs (seed={seed}, n={n}, lam={lam})")
                for g, w, what in zip(got[1:4], want[1:4], ("b*", "e*", "phi*")):
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-8,
                                               msg=lambda m: f"{name} {what}: {m}")
                    err = max(err, float((g - w).abs().max()))
    n = N_CLIENTS
    P, h, u, e_cmp = P[:n].contiguous(), h[:n].contiguous(), u[:n].contiguous(), e_cmp[:n].contiguous()
    es = es[:n].contiguous() if scaled else None
    lam = f(1e-4)
    ms = cuda_ms(lambda: ops.dual_solve(P, h, u, lam, **kw, e_cmp=e_cmp, e_scale=es), 500)
    plain = cuda_ms(lambda: ref.dual_solve_ref(P, h, u, lam, **kw, e_cmp=e_cmp,
                                               e_scale=es), 100)
    # 4-5 inputs + 7 scalars read, 4-5 outputs written; float32 operations
    # counted from the source (each libm call as one): ~110 per (client,
    # level), plus the level-free head (and ln e_scale)
    levels = len(GRID) * (len(BITS) if joint else 1)
    n_io = (4 + scaled) + (4 + joint)
    b_ms, b_by = bound(n_io * n * 4 + 7 * 4, n * (levels * 110 + 10 + scaled))
    return dict(name=name, route="cuda", source="src/repro_torch/csrc/dual_solve.cu",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# early-exit tolerances for check_dual_ascent: at the main path's setting
# the residual stays above 1 (the price iteration oscillates, ROADMAP C-4),
# and these stop the loop after 1 to ~24 of its 30 iterations
EARLY_TOLS = (3.0, 5.0)


def selection(asc, u, alive, eta, rho):
    """The extraction's benefit test on a dual-ascent result (before the
    greedy repair), as core.fairenergy._solve_round computes it."""
    from repro_torch.kernels.dual_solve.ref import selection_score
    benefit = (eta * selection_score(u, asc.gamma, asc.bits)
               + asc.mu * (1.0 - rho) - asc.e - asc.lam * asc.b)
    return (benefit > 0) & alive


def hold_ascent(args, kw, where: str) -> tuple[float, float, int]:
    """The fused ascent against its plain version (the host loop over the
    plain best response) on one call's inputs, ``args`` and ``kw`` as the
    solver passes them: selection masks, gammas, widths and n_inner
    exactly equal; lam, mu, b*, e* and the last two residuals (res,
    res_prev: +inf equal where no iteration set them) within rtol 1e-5.
    Returns the largest absolute error of lam, mu, b* and e*, the largest
    relative error of the residuals and n_inner."""
    from repro_torch.kernels.dual_solve import ops, ref
    got = ops.dual_ascent(*args, **kw)
    want = ref.dual_ascent_ref(*args, **kw)
    if int(got.n_inner) != int(want.n_inner):
        raise AssertionError(f"{where}: n_inner {int(got.n_inner)} != "
                             f"{int(want.n_inner)}")
    u, alive = args[2], args[6]
    x_got = selection(got, u, alive, kw["eta"], kw["rho"])
    x_want = selection(want, u, alive, kw["eta"], kw["rho"])
    if not (torch.equal(x_got, x_want) and torch.equal(got.gamma, want.gamma)
            and (kw.get("bits_grid") is None
                 or torch.equal(got.bits, want.bits))):
        raise AssertionError(f"{where}: masks, gammas or widths differ")
    err, res_err = 0.0, 0.0
    for what in ("lam", "mu", "b", "e"):
        g, w = getattr(got, what), getattr(want, what)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12,
                                   msg=lambda m: f"{where} {what}: {m}")
        err = max(err, float((g - w).abs().max()))
    # the last two residuals, what the fallback guard reads
    for what in ("res", "res_prev"):
        g, w = float(getattr(got, what)), float(getattr(want, what))
        if math.isinf(w) or math.isinf(g):
            if g != w:
                raise AssertionError(f"{where} {what}: {g} != {w}")
        elif not abs(g - w) <= 1e-5 * abs(w):
            raise AssertionError(f"{where} {what}: {g} vs {w}")
        else:
            res_err = max(res_err, abs(g - w) / max(abs(w), 1e-30))
    return err, res_err, int(want.n_inner)


def wide_grid(name: str, L: int) -> tuple:
    """The variant's (gamma grid, bits grid or None) of ``L`` levels from
    WIDE_LEVELS."""
    gammas, joint_grid = WIDE_LEVELS[L]
    return joint_grid if DUAL_VARIANTS[name][1] else (gammas, None)


def check_dual_ascent(dev, name: str, grid=None, rounds: int = 5,
                      timed: bool = True) -> dict:
    """The fused dual ascent of one variant against its plain version (the
    host loop over the plain best response) on the card, at phase 4's
    inputs: each of ``rounds`` warm-started rounds capped (the default
    dual_tol: 30 iterations) and stopped early (EARLY_TOLS, with every 7th
    client dead). Selection masks, gammas, widths and n_inner exactly
    equal; lam, mu, b*, e* and the last two residuals (res, res_prev: +inf
    equal where no iteration set them) within rtol 1e-5. ``grid`` ((gamma
    grid, bits grid or None)) replaces the paper's grid of the variant.
    Timed (``timed``): one fused launch, the plain host loop, and the host
    loop over the one-step kernel (the design it replaces), at round 0's
    capped setting; else the held numbers alone."""
    import dataclasses

    from repro_torch.core.fairenergy import solve_round, static_of
    from repro_torch.kernels.dual_solve import ops, ref
    scaled, joint, replaces = DUAL_VARIANTS[name]
    ctrl, P, hs, us, ess = solver_setting(name)
    fe = ctrl.fe_cfg
    if grid is not None:
        fe = dataclasses.replace(fe, gamma_grid=grid[0],
                                 bits_grid=grid[1] or (32.0,))
    static = static_of(fe)
    bits_grid = (grid[1] if grid is not None else BITS) if joint else None
    L = len(ops.ascent_levels(static.gamma_grid, bits_grid)) // 5
    state = to_device(ctrl.init(N_CLIENTS), dev)
    P = P.to(dev)
    all_alive = torch.ones(N_CLIENTS, dtype=torch.bool, device=dev)
    some_dead = all_alive.clone()
    some_dead[::7] = False
    err, res_err, n_inner, first = 0.0, 0.0, [], None
    for r in range(rounds):
        h, u = hs[r].to(dev), us[r].to(dev)
        es = ess[r].to(dev) if scaled else None
        p = state.params
        for tol, alive in ((p.dual_tol, all_alive),
                           *((torch.tensor(t, device=dev), some_dead) for t in EARLY_TOLS)):
            args = (P, h, u, state.lam, state.mu, state.q, alive)
            kw = dict(gamma_grid=static.gamma_grid, eta=p.eta, rho=p.rho,
                      pi_min=p.pi_min, alpha_lambda=p.alpha_lambda,
                      alpha_mu=p.alpha_mu, dual_tol=tol, b_tot=p.b_tot,
                      s_bits=p.s_bits, i_bits=p.i_bits, n0=p.n0,
                      b_lo=p.b_min_frac, inner_iters=static.inner_iters,
                      newton_iters=static.newton_iters, e_cmp=state.e_cmp,
                      e_scale=es, bits_grid=bits_grid)
            e_abs, e_res, iters = hold_ascent(
                args, kw, f"{FUSED[name]} L={L} round {r} dual_tol {float(tol)}")
            err, res_err = max(err, e_abs), max(res_err, e_res)
            n_inner.append(iters)
            if first is None:
                first = (args, kw)
        _, state = solve_round(u, h, P, state, fe_cfg=fe, e_scale=es)
    if not timed:
        return dict(max_abs_err=err, res_max_rel_err=res_err, n_inner=n_inner,
                    first=first)
    args, kw = first
    # the kernel's device time (the profiler), and a wrapper call's time
    # between CUDA events (back-to-back calls: the host side of a launch)
    ms = device_ms(lambda: ops.dual_ascent(*args, **kw), "dual_ascent_kernel")
    # one iteration and the extraction: the rest is the loop's latency
    ms_one = device_ms(lambda: ops.dual_ascent(*args, **dict(kw, inner_iters=1)),
                       "dual_ascent_kernel")
    call = cuda_ms(lambda: ops.dual_ascent(*args, **kw), 50)
    plain = cuda_ms(lambda: ref.dual_ascent_ref(*args, **kw), 3, warmup=1)
    host_loop = cuda_ms(lambda: ref.dual_ascent_ref(*args, **kw, solve=ops.dual_solve),
                        5, warmup=1)
    log(json.dumps({"dual_ascent_case": FUSED[name], "n_inner": n_inner,
                    "res_max_rel_err": res_err,
                    "kernel_ms": ms, "kernel_one_iteration_ms": ms_one,
                    "kernel_ms_per_further_iteration":
                        (ms - ms_one) / (static.inner_iters - 1),
                    "call_ms": call, "host_loop_one_step_ms": host_loop,
                    "plain_ms": plain}))
    # the capped run: 31 best responses (30 iterations + the extraction),
    # ~110 float operations a (client, level) and ~20 a client for the
    # selection and the dual steps; 8-9 inputs and 5-6 outputs a client
    levels = len(GRID) * (len(BITS) if joint else 1)
    n = N_CLIENTS
    iters = int(ops.dual_ascent(*args, **kw).n_inner)
    n_ops = (iters + 1) * n * (levels * 110 + 10 + scaled) + iters * n * 20
    b_ms, b_by = bound(((8 + scaled) + (5 + joint)) * n * 4 + 12 * 4 + 8, n_ops)
    return dict(name=FUSED[name], route="cuda", source="src/repro_torch/csrc/dual_solve.cu",
                replaces=f"{replaces} + src/repro/core/fairenergy.py:371",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, call_ms=call,
                host_loop_ms=host_loop, res_max_rel_err=res_err)


def hold_dual_solve_wide(dev, name: str, grid, rounds: int = 2) -> float:
    """The one-step kernel of one variant on ``grid`` at phase 4's inputs
    (``solver_setting``: each of ``rounds`` rounds' observations, the
    initial state's scalars), at the state's price and at 1e-5, 1e-4 and
    3e-3: gamma* and bits* exactly equal, b*, e* and phi* within rtol 1e-5
    (atol 1e-8). Returns the largest absolute error."""
    from repro_torch.kernels.dual_solve import ops, ref
    scaled, joint, _ = DUAL_VARIANTS[name]
    ctrl, P, hs, us, ess = solver_setting(name)
    state = to_device(ctrl.init(N_CLIENTS), dev)
    p, P = state.params, P.to(dev)
    kw = dict(gamma_grid=grid[0], eta=p.eta, b_tot=p.b_tot, s_bits=p.s_bits,
              i_bits=p.i_bits, n0=p.n0, b_lo=p.b_min_frac, e_cmp=state.e_cmp,
              bits_grid=grid[1] if joint else None)
    err = 0.0
    for r in range(rounds):
        h, u = hs[r].to(dev), us[r].to(dev)
        es = ess[r].to(dev) if scaled else None
        for lam in (state.lam, *(torch.tensor(v, device=dev) for v in (1e-5, 1e-4, 3e-3))):
            got = ops.dual_solve(P, h, u, lam, **kw, e_scale=es)
            want = ref.dual_solve_ref(P, h, u, lam, **kw, e_scale=es)
            where = f"{name} L={len(ops.ascent_levels(*grid)) // 5} round {r} lam {float(lam)}"
            for i in ((0, 4) if joint else (0,)):
                if not torch.equal(got[i], want[i]):
                    raise AssertionError(f"{where}: {('gamma*', '', '', '', 'bits*')[i]} differs")
            for g, w, what in zip(got[1:4], want[1:4], ("b*", "e*", "phi*")):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-8,
                                           msg=lambda m: f"{where} {what}: {m}")
                err = max(err, float((g - w).abs().max()))
    return err


def check_dual_wide(dev, name: str) -> dict:
    """Both kernels of one variant past 32 levels (WIDE_LEVELS: L = 33, 40,
    50, 100), each on phase 4's inputs: the one-step kernel
    (``hold_dual_solve_wide``) and the fused ascent (``check_dual_ascent``,
    2 rounds, capped, early exit and dead clients), every launch counted.
    The fused kernel is timed at L = 40 and 100 (its device time, as phase
    2's at the paper's grid). Returns the one-step and the fused results by
    L."""
    from repro_torch.kernels.dual_solve import ops
    one, fused = {}, {}
    for L in WIDE_LEVELS:
        grid = wide_grid(name, L)
        before = (getattr(ops.dual_solve, ops.COUNTERS[DUAL_VARIANTS[name][:2]]),
                  getattr(ops.dual_ascent, ops.COUNTERS[DUAL_VARIANTS[name][:2]]))
        one[L] = {"max_abs_err": hold_dual_solve_wide(dev, name, grid)}
        held = check_dual_ascent(dev, name, grid=grid, rounds=2, timed=False)
        args, kw = held.pop("first")
        if L in (40, 100):
            held["ms"] = device_ms(lambda: ops.dual_ascent(*args, **kw),
                                   "dual_ascent_kernel")
        fused[L] = held
        after = (getattr(ops.dual_solve, ops.COUNTERS[DUAL_VARIANTS[name][:2]]),
                 getattr(ops.dual_ascent, ops.COUNTERS[DUAL_VARIANTS[name][:2]]))
        if not (after[0] > before[0] and after[1] > before[1]):
            raise AssertionError(f"{name} at L = {L}: a kernel did not launch "
                                 f"({before} -> {after})")
        log(json.dumps({"dual_wide": name, "levels": L, "one_step": one[L],
                        "fused": fused[L]}))
    return {"one_step": one, "fused": fused}


def _tricky_rows(dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows with ties, NaN, +-Inf, -0.0, k = 1 and k = block (one of them
    holding NaN and Inf, which the mask at k = block drops and keeps), a NaN
    with every mantissa bit set (0x7fffffff: the reference's max + 1 wraps
    and its bisection keeps every non-NaN lane), a row of one value, and
    denormals (C-16: compared as zero), with a k whose threshold is a
    denormal, with the threshold 0.0 and denormals after zeros, and beside
    the 0x7fffffff NaN and zeros; over a D of odd length (3 x 4096 + 101),
    so the rows start at every offset in a 16-byte word."""
    gen = torch.Generator().manual_seed(2)
    d = 3 * 4096 + 101
    rows = torch.randn(14, d, generator=gen)
    rows[1, ::7] = float("nan")
    rows[2, ::5] = float("inf")
    rows[2, 1::5] = float("-inf")
    rows[3] = torch.round(rows[3] * 2) / 2
    rows[4] = -0.0
    rows[4, ::3] = 1.0
    rows[5] = 0.5
    rows[6, :5000] = float("nan")
    rows[7, ::2] = -0.0
    rows[8, ::3] = float("nan")
    rows[8, 1::7] = float("-inf")
    rows[8, 2::5] = -0.0
    bits = rows.view(torch.int32)
    bits[9, 5] = 0x7FFFFFFF
    bits[9, 4096 + 7] = -1                    # 0xffffffff: |x| is 0x7fffffff
    rows[9, 9::31] = float("nan")
    rows[10] = -0.25

    def denormals(m: int) -> torch.Tensor:
        b = torch.randint(1, 1 << 23, (m,), generator=gen, dtype=torch.int32)
        sign = torch.randint(0, 2, (m,), generator=gen, dtype=torch.int32)
        return (b | (sign << 31)).view(torch.float32)

    rows[11:13] = 0.0
    rows[11, ::40] = torch.randn(len(range(0, d, 40)), generator=gen)
    rows[11, 3::7] = denormals(len(range(3, d, 7)))
    rows[12, :20] = torch.randn(20, generator=gen)
    rows[12, 6000::9] = denormals(len(range(6000, d, 9)))
    rows[13, 3::5] = 0.0
    rows[13, 4::11] = denormals(len(range(4, d, 11)))
    bits[13, 5] = 0x7FFFFFFF
    ks = torch.tensor([1, 2, 409, 4096, 17, 3000, 50, 1, 4096, 100, 1000,
                       500, 3000, 100], dtype=torch.int32)
    return rows.to(dev), ks.to(dev)


def _offset_view(m: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of ``m`` whose data starts ``elems`` elements into
    its storage (so not on a 16-byte word when elems * itemsize % 16)."""
    buf = torch.empty(m.numel() + elems, dtype=m.dtype, device=m.device)
    view = buf[elems:].view(m.shape)
    view.copy_(m)
    return view


def topk_attributes() -> dict:
    """Registers, spill bytes and shared bytes of the built top-k kernels."""
    from repro_torch.kernels.topk_sparsify import ops
    return {"rows": ops.kernel_attributes("rows"),
            "block_f32": ops.kernel_attributes("block", torch.float32),
            "block_bf16": ops.kernel_attributes("block", torch.bfloat16)}


def topk_rows_bound(n: int, d: int, ks: torch.Tensor,
                    block: int = 4096) -> tuple[float, str]:
    """The rows kernel's bound, by the formula of every earlier measurement
    (PERF.md row 5): one read and one write of every element; per sparsified
    block 31 counting passes (compare + add per element) and ~8 operations
    per element for the tests, the tie scan and the product."""
    sparsified = int((ks < block).sum()) * -(-d // block)
    return bound(2 * n * d * 4 + n * 4, sparsified * block * (31 * 2 + 8))


def check_topk(dev, mat: torch.Tensor) -> dict:
    from repro_torch.kernels.topk_sparsify import ops, ref
    gen = torch.Generator().manual_seed(3)
    n, d = mat.shape
    levels = torch.tensor([max(1, min(4096, math.ceil(g * 4096))) for g in GRID]
                          + [1], dtype=torch.int32)
    ks = levels[torch.randint(0, len(levels), (n,), generator=gen)].to(dev)
    ks[0], ks[1] = 4096, 1
    rows, tks = _tricky_rows(dev)
    # why the plain version takes |x| on the bits: the card's abs does not
    # keep a NaN's payload
    nan = torch.tensor([float("nan")], device=dev)
    log(f"torch.abs(nan) bits on the card: "
        f"{int(torch.abs(nan).view(torch.int32)) & 0xFFFFFFFF:#010x} "
        f"(input {int(nan.view(torch.int32)) & 0xFFFFFFFF:#010x})")
    full = torch.full_like(tks, 4096)
    ties = torch.full_like(tks, 1000)
    for m, k, what in ((mat, ks, "main-path rows"), (rows, tks, "tie/NaN/Inf rows"),
                       (rows, full, "all-full rows (copy through)"),
                       (_offset_view(rows, 1), tks,
                        "tie/NaN/Inf rows, input one element off a word"),
                       (_offset_view(rows, 3), full, "all-full rows, 3 off")):
        got = ops.block_topk_rows(m, k)
        want = ref.block_topk_rows(m, k)
        if not same_bits(got, want):
            raise AssertionError(f"top-k kernel differs from the plain version "
                                 f"on the {what}:\n{diff_report(got, want, k)}")
        log(json.dumps({"topk_rows_case": what, "bit_identical": True}))
    # the wrapped bisection keeps every non-NaN lane of row 9's blocks 0 and 1
    kept = ops.block_topk_rows(rows, ties)[9]
    if not torch.equal(torch.isnan(rows[9, :8192]), kept[:8192] == 0):
        raise AssertionError("the 0x7fffffff row did not keep every non-NaN lane")
    ms = cuda_ms(lambda: ops.block_topk_rows(mat, ks), 20)
    plain = cuda_ms(lambda: ref.block_topk_rows(mat, ks), 3, warmup=1)
    # what moving the bytes alone takes here: one read and one write each
    copy = cuda_ms(lambda: mat.clone(), 20)
    nb = -(-d // 4096)
    # the library yardstick: torch.topk of the blocked |x| at the largest k,
    # then scatter_ of each block's first k (its row's k) into zeros. It
    # selects the same set up to ties, but neither fixes the tie order nor
    # drops NaN lanes or writes +0.0 for a dropped -x as the kernel does
    blocks = torch.nn.functional.pad(mat, (0, nb * 4096 - d)).view(n * nb, 4096)
    kb = ks.long().repeat_interleave(nb)
    k_max = int(kb.max())
    first_k = torch.arange(k_max, device=dev)[None, :] < kb[:, None]

    def library():
        idx = torch.topk(blocks.abs(), k_max, dim=1).indices
        vals = torch.where(first_k, torch.gather(blocks, 1, idx), 0.0)
        return torch.zeros_like(blocks).scatter_(1, idx, vals)

    lib = cuda_ms(library, 5, warmup=1)
    del blocks, first_k
    log(json.dumps({"topk_rows_library": {"rows": n * nb, "k_max": k_max,
                                          "ms": lib}}))
    b_ms, b_by = topk_rows_bound(n, d, ks)
    return dict(name="topk_rows", route="cuda",
                source="src/repro_torch/csrc/topk_rows.cu",
                replaces="src/repro/kernels/topk_sparsify/kernel.py:32",
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, copy_ms=copy)


def time_topk_round(dev, entry: dict, lg) -> None:
    """The rows kernel at the ks of one round of the main path (``lg``, its
    RoundLog): the selected clients' gammas, 1 for the others, as
    ``fl/server.py`` hands them to ``batch_block_topk``; on phase 2's
    matrix, beside the plain version. Adds them to ``entry``."""
    from repro_torch.kernels.topk_sparsify import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn(N_CLIENTS, 1_630_090, device=dev, generator=gen) * 1e-3
    gamma = torch.as_tensor(np.where(lg.selected, np.clip(lg.gamma, 1e-6, 1.0),
                                     1.0), dtype=torch.float32, device=dev)
    ks = torch.clamp(torch.ceil(gamma * 4096).to(torch.int32), 1, 4096)
    if not same_bits(ops.block_topk_rows(mat, ks), ref.block_topk_rows(mat, ks)):
        raise AssertionError("top-k kernel differs from the plain version at "
                             "the main path's round ks")
    ms = cuda_ms(lambda: ops.block_topk_rows(mat, ks), 20)
    plain = cuda_ms(lambda: ref.block_topk_rows(mat, ks), 3, warmup=1)
    b_ms, _ = topk_rows_bound(*mat.shape, ks)
    sparsified = int((ks < 4096).sum())
    entry.update(round_ms=ms, round_plain_ms=plain, round_bound_ms=b_ms,
                 round_sparsified_rows=sparsified)
    log(json.dumps({"topk_rows_main_round": {
        "round": lg.round, "sparsified_rows": sparsified,
        "ks": sorted(ks.tolist()), "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms}}))


def check_topk_block(dev, vec: torch.Tensor) -> dict:
    """The block top-k of one vector against its plain version, bit for
    bit: ``vec`` (the CNN's flat update, n = 1,630,090, a ragged last
    block) at gamma 0.25 and 0.1 in fp32 and bf16, blocks 256 and 1024,
    k = block, the tie/NaN/Inf rows flattened (the 0x7fffffff NaN, and in
    bf16 its all-ones NaN 0x7fff), and inputs that start off a 16-byte
    word."""
    from repro_torch.kernels.topk_sparsify import ops, ref
    tricky = _tricky_rows(dev)[0].flatten()
    tricky16 = tricky.bfloat16()
    tricky16.view(torch.int16)[5] = 0x7FFF
    tricky16.view(torch.int16)[4096 + 7] = -1
    cases = [(vec, 0.25, 4096), (vec, 0.1, 4096), (vec.bfloat16(), 0.25, 4096),
             (vec.bfloat16(), 0.1, 4096), (vec, 0.25, 256), (vec, 0.25, 1024),
             (vec, 1.0, 4096), (tricky, 0.1, 4096), (tricky, 0.5, 256),
             (tricky, 1.0, 1024), (tricky16, 0.1, 4096),
             (tricky16, 0.5, 256), (tricky16, 0.25, 1024),
             (tricky[1:], 0.1, 4096), (tricky16[3:], 0.25, 1024),
             (vec[2:], 0.25, 4096)]
    for v, gamma, block in cases:
        got, k = ops.block_topk_sparsify(v, gamma, block=block)
        want, k_ref = ref.block_topk_ref(v, gamma, block=block)
        same = (same_bits(got, want) if v.dtype == torch.float32 else
                torch.equal(got.view(torch.int16), want.view(torch.int16)))
        if k != k_ref or not same:
            raise AssertionError(f"block top-k kernel differs from its plain "
                                 f"version: n={v.numel()} {v.dtype} "
                                 f"gamma={gamma} block={block}")
        log(json.dumps({"topk_block_case": [v.numel(), str(v.dtype), gamma,
                                            block, k, v.data_ptr() % 16],
                        "bit_identical": True}))
    n, block, k = vec.numel(), 4096, 1024
    nb = -(-n // block)
    # the kernel alone (profiler): back-to-back wrapper calls time the host
    # here, as long as the kernel itself
    ms = device_ms(lambda: ops.block_topk_sparsify(vec, 0.25), "topk_block_kernel",
                   50)
    call = cuda_ms(lambda: ops.block_topk_sparsify(vec, 0.25), 200)
    plain = cuda_ms(lambda: ref.block_topk_ref(vec, 0.25), 5, warmup=1)
    rows = torch.nn.functional.pad(vec, (0, nb * block - n)).view(nb, block)

    def library():
        # two calls that select the same set (neither writes a mask nor
        # fixes the tie order), plus the zeroed output they scatter into
        idx = torch.topk(rows.abs(), k, dim=1).indices
        return torch.zeros_like(rows).scatter_(1, idx, torch.gather(rows, 1, idx))

    lib = cuda_ms(library, 50)
    # the formula of every earlier measurement (PERF.md row 6): one read and
    # one write of every element; 31 counting passes (compare + add) and ~8
    # operations per element for the tests and the tie scan
    b_ms, b_by = bound(2 * 4 * n, n * (31 * 2 + 8))
    log(json.dumps({"topk_block_bound": {"n": n, "bytes": 2 * 4 * n,
                                         "bound_ms": b_ms, "by": b_by}}))
    return dict(name="topk_block", route="cuda",
                source="src/repro_torch/csrc/topk_block.cu",
                replaces="src/repro/kernels/topk_sparsify/kernel.py:26",
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, call_ms=call)


# phase 16 (a): the block widths both top-k kernels take, from one lane to
# a whole row of the paper CNN (D = 1,630,090), each timed: widths up to
# 255 run the narrow tier (several blocks a CTA), 256-4,096 a register
# instance (the next larger power of two of 256-lane steps), wider ones the
# staged tier (a block in shared memory) up to 192 KiB and the chunked tier
# above (topk_common.cuh)
TOPK_WIDTHS = (1, 2, 32, 100, 128, 256, 1000, 1024, 2048, 4096, 8192, 65536,
               1_630_090)
# checked bit for bit, not timed: each side of the narrow tier's segment
# widths (16 | 17, 32 | 33) and of every tier's limit (255 | 256,
# 4,096 | 4,097, 49,152 | 49,153 in fp32, 98,304 | 98,305 in 16 bits), and
# +-1 around the chunk (8,192) and its multiples in the chunked tier
TOPK_EDGE_WIDTHS = (3, 16, 17, 31, 33, 255, 257, 4095, 4097, 8191, 8193,
                    49151, 49152, 49153, 57343, 57345, 65535, 65537, 98303,
                    98304, 98305, 106495, 106497)


def _long_tricky(dev) -> torch.Tensor:
    """Four rows of the CNN's D = 1,630,090: normals; ties (values on a
    grid of halves); NaN, +-Inf, -0.0 and denormals; and normals beside a
    NaN with every mantissa bit set (0x7fffffff, the wrapped bisection)."""
    gen = torch.Generator().manual_seed(5)
    d = 1_630_090
    rows = torch.randn(4, d, generator=gen) * 1e-3
    rows[1] = torch.round(rows[1] * 4000) / 2
    rows[2, ::7] = float("nan")
    rows[2, 1::11] = float("inf")
    rows[2, 4::11] = float("-inf")
    rows[2, 2::13] = -0.0
    m = len(range(3, d, 5))
    den = torch.randint(1, 1 << 23, (m,), generator=gen, dtype=torch.int32)
    rows[2, 3::5] = den.view(torch.float32)
    rows.view(torch.int32)[3, 12345] = 0x7FFFFFFF
    return rows.to(dev)


def _width_ks(tks: torch.Tensor, w: int) -> torch.Tensor:
    """The tricky rows' ks (chosen for 4,096-wide blocks) scaled to blocks
    of ``w`` lanes, within [1, w]."""
    return torch.clamp(torch.round(tks.double() * w / 4096), 1, w).to(torch.int32)


def kernel_ms(fn, kernel: str, iters: int, per_call: int = 1) -> tuple[float, str]:
    """The device time of one call of ``fn``: the sum of the device times
    of a call's ``per_call`` launches of the kernels whose name holds
    ``kernel``, from torch.profiler's CUDA activity over ``iters`` calls.
    The profiler has been seen to drop some events of a profile, so the
    sum over the launches it saw is divided by the calls they make up
    (launches seen / per_call); the timer string gives the launches seen
    and a call's. Where it sees none, CUDA events around the ``iters``
    back-to-back calls (which count the host's time between launches
    too)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    if count:
        return (sum(e.self_device_time_total for e in events) / 1e3
                / (count / per_call),
                f"profiler, {count} launches seen of {iters} calls x {per_call}")
    log(json.dumps({"profiler_saw_no_launches": kernel}))
    return cuda_ms(fn, iters), "cuda_events"


def _check_width(dev, w: int, tricky, tks, longr, vecs16) -> None:
    """Both top-k kernels at block width ``w`` against their plain
    versions, bit for bit (see check_topk_widths)."""
    from repro_torch.kernels.topk_sparsify import ops, ref
    sets = []
    if w <= 65536:
        sets.append(("tricky", tricky, _width_ks(tks, w)))
    if w >= 8192:
        sets.append(("long", longr, torch.tensor(
            [max(1, w // 10), max(1, w // 2), w, max(1, w // 4)],
            dtype=torch.int32, device=dev)))
    for what, m, ks in sets:
        for skip in (True, False):
            got = ops.block_topk_rows(m, ks, block=w, skip_full=skip)
            want = ref.block_topk_rows(m, ks, block=w, skip_full=skip)
            if not same_bits(got, want):
                raise AssertionError(
                    f"top-k rows kernel differs from its plain version at "
                    f"block {w} on the {what} rows (skip_full={skip}):\n"
                    f"{diff_report(got, want, ks)}")
        full = torch.full_like(ks, w)
        if not same_bits(ops.block_topk_rows(m, full, block=w), m):
            raise AssertionError(f"all-full rows at block {w} did not copy")
        # the rows entry: [R, w] rows of the same values, literal ks
        n_r = min(m.numel() // w, 96)
        rows = m.reshape(-1)[:n_r * w].view(n_r, w)
        lit = torch.tensor([0, -3, 1, w, w + 7, max(1, w // 3)],
                           dtype=torch.int32, device=dev)
        # shifted so that the rows holding 0x7fffffff take k = 0
        lit = lit[(torch.arange(n_r, device=dev) + 3) % len(lit)]
        got = ops.block_topk_sparsify_rows(rows, lit)
        want = ref.block_topk_sparsify_rows(rows, lit)
        if not same_bits(got, want):
            raise AssertionError(
                f"the rows entry differs from its plain version at block "
                f"{w} on the {what} rows:\n{diff_report(got, want, lit)}")
    vecs = [(tricky.flatten(), (0.1, 0.5, 1.0)), (vecs16[0], (0.1, 0.5)),
            (vecs16[2], (0.1, 0.5))]
    if w >= 8192:
        vecs += [(longr.flatten(), (0.25,)), (vecs16[1], (0.25,)),
                 (vecs16[3], (0.25,))]
    for v, gammas in vecs:
        for gamma in gammas:
            got, k = ops.block_topk_sparsify(v, gamma, block=w)
            want, k_ref = ref.block_topk_ref(v, gamma, block=w)
            same = (same_bits(got, want) if v.dtype == torch.float32 else
                    torch.equal(got.view(torch.int16), want.view(torch.int16)))
            if k != k_ref or not same:
                raise AssertionError(
                    f"block top-k kernel differs from its plain version "
                    f"at block {w}: n={v.numel()} {v.dtype} gamma={gamma}")


def check_topk_widths(dev, mat: torch.Tensor, flat: torch.Tensor) -> dict:
    """Both top-k kernels at every width of ``TOPK_WIDTHS`` and
    ``TOPK_EDGE_WIDTHS`` against their plain versions, bit for bit: the
    rows kernel (``block_topk_rows`` with and without the all-full skip,
    and the rows entry ``block_topk_sparsify_rows`` at literal ks: 0, -3,
    1, w, w + 7) on phase 2's tricky rows (widths up to 65,536) and on four
    tricky rows of the CNN's D (widths from 8,192); the block kernel on the
    tricky rows flattened in fp32, bf16 and fp16, and on the long rows
    flattened (fp16 against the plain version itself, whose integer
    widening keeps every NaN's payload wherever it falls: C-31, closed).
    Then each width of ``TOPK_WIDTHS`` timed on the
    device, a call's launches summed (the profiler), on the main path's
    matrix ``mat`` (rows, ks from the gamma grid) and on ``flat`` (block,
    gamma 0.25), beside its bound and ``torch.topk`` + ``scatter_`` at the
    same width. Launches here are comparisons, not the main path's."""
    from repro_torch.kernels.topk_sparsify import ops
    tricky, tks = _tricky_rows(dev)
    longr = _long_tricky(dev)
    t16 = tricky.flatten().bfloat16()
    t16.view(torch.int16)[5] = 0x7FFF
    t16.view(torch.int16)[4096 + 7] = -1
    h16 = tricky.flatten().half()
    h16.view(torch.int16)[5] = 0x7C01                   # a signalling NaN
    vecs16 = (t16, longr.flatten().bfloat16(), h16, longr[1:3].flatten().half())
    for w in sorted(TOPK_WIDTHS + TOPK_EDGE_WIDTHS):
        _check_width(dev, w, tricky, tks, longr, vecs16)
        log(json.dumps({"topk_width": w, "bit_identical": True,
                        "rows": ops.kernel_attributes("rows", block=w),
                        "block_f32": ops.kernel_attributes("block", block=w),
                        "block_bf16": ops.kernel_attributes(
                            "block", torch.bfloat16, block=w)}))
    del longr, vecs16

    n, d = mat.shape
    gen = torch.Generator().manual_seed(3)
    out = {"rows": {}, "block": {}}
    for w in TOPK_WIDTHS:
        levels = torch.tensor([max(1, min(w, math.ceil(g * w))) for g in GRID]
                              + [1], dtype=torch.int32)
        ks = levels[torch.randint(0, len(levels), (n,), generator=gen)].to(dev)
        calls = ops.launches_per_call(w)
        ms, timer = kernel_ms(lambda: ops.block_topk_rows(mat, ks, block=w),
                              "topk_rows", 5, calls)
        nb = -(-d // w)
        blocks = torch.nn.functional.pad(mat, (0, nb * w - d)).view(n * nb, w)
        kb = ks.long().repeat_interleave(nb)
        k_max = int(kb.max())
        first_k = torch.arange(k_max, device=dev)[None, :] < kb[:, None]

        def library():
            idx = torch.topk(blocks.abs(), k_max, dim=1).indices
            vals = torch.where(first_k, torch.gather(blocks, 1, idx), 0.0)
            return torch.zeros_like(blocks).scatter_(1, idx, vals)

        lib = cuda_ms(library, 2, warmup=1)
        del blocks, kb, first_k
        b_ms, b_by = topk_rows_bound(n, d, ks, w)
        out["rows"][w] = {"ms": ms, "timer": timer, "launches_a_call": calls,
                          "tier": ops.tier(w), "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib}
        # the block kernel on one flat update
        k = max(1, min(w, math.ceil(0.25 * w)))
        nb = -(-flat.numel() // w)
        rows = torch.nn.functional.pad(flat, (0, nb * w - flat.numel())).view(nb, w)
        ms_b, timer_b = kernel_ms(
            lambda: ops.block_topk_sparsify(flat, 0.25, block=w), "topk_block",
            10, calls)

        def library_b():
            idx = torch.topk(rows.abs(), k, dim=1).indices
            return torch.zeros_like(rows).scatter_(1, idx, torch.gather(rows, 1, idx))

        lib_b = cuda_ms(library_b, 5, warmup=1)
        bb_ms, bb_by = bound(2 * 4 * flat.numel(), nb * w * (31 * 2 + 8))
        out["block"][w] = {"ms": ms_b, "timer": timer_b, "launches_a_call": calls,
                           "tier": ops.tier(w), "bound_ms": bb_ms,
                           "bound_by": bb_by, "library_ms": lib_b}
        log(json.dumps({"topk_width_times": w, "rows": out["rows"][w],
                        "block": out["block"][w]}))
    return out


def check_row_norms(dev, mat: torch.Tensor) -> dict:
    """The norms kernel against its plain version on the main path's
    matrix, and on the screen-less defended clip's inputs: rows holding
    NaN (all of a row, and one lane), +Inf and rows scaled by -1e3, which
    must come out NaN, +Inf and scaled."""
    from repro_torch.kernels.score_norm import ops, ref
    got = ops.row_l2_norms(mat)
    want = ref.row_l2_norms_ref(mat, ops.BLOCK)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    err = float((got - want).abs().max())
    bad = mat[:8].clone()
    bad[1] = float("nan")
    bad[2, 12345] = float("nan")
    bad[3, 777] = float("inf")
    bad[4] = float("inf")
    bad[5] *= -1e3
    got_b = ops.row_l2_norms(bad)
    want_b = ref.row_l2_norms_ref(bad, ops.BLOCK)
    torch.testing.assert_close(got_b, want_b, rtol=1e-6, atol=0, equal_nan=True)
    if not (torch.isnan(got_b[1:3]).all() and torch.isposinf(got_b[3:5]).all()
            and torch.isfinite(got_b[[0, 5, 6, 7]]).all()):
        raise AssertionError(f"norms of the NaN/Inf rows: {got_b.tolist()}")
    torch.testing.assert_close(got_b[5], got[5] * 1e3, rtol=1e-6, atol=0)
    log(json.dumps({"row_norms_special_rows": got_b.tolist()}))
    # five alternating (kernel, vector_norm) pairs of 50 calls each: their
    # medians are the entry's ms and library_ms (single timings of the two
    # have come out in either order across calls)
    pairs = [(cuda_ms(lambda: ops.row_l2_norms(mat), 50),
              cuda_ms(lambda: torch.linalg.vector_norm(mat, dim=1), 50))
             for _ in range(5)]
    ms = float(np.median([a for a, _ in pairs]))
    library = float(np.median([b for _, b in pairs]))
    log(json.dumps({"row_norms_pairs_ms": pairs, "median_ms": ms,
                    "median_vector_norm_ms": library}))
    plain = cuda_ms(lambda: ref.row_l2_norms_ref(mat, ops.BLOCK), 10)
    n, d = mat.shape
    b_ms, b_by = bound(n * d * 4 + n * -(-d // ops.BLOCK) * 4, 2 * n * d)
    return dict(name="row_sq_sum", route="triton",
                source="src/repro_torch/kernels/score_norm/kernel.py",
                replaces="src/repro/kernels/score_norm/kernel.py:18",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=library)


# (B, S, H, KV, D, dtype, causal, window, Skv): the serve path's call
# first, then a window, fp32, a ragged S and the other head dims (bf16 goes
# to the tensor-core kernel, fp32 to the SIMT one)
FLASH_CASES = (
    (4, 2048, 32, 4, 64, torch.bfloat16, True, None, None),
    (4, 2048, 32, 4, 64, torch.bfloat16, True, 256, None),
    (4, 2048, 32, 4, 64, torch.float32, True, None, None),
    (2, 1000, 32, 4, 64, torch.bfloat16, True, None, None),
    (2, 1000, 32, 4, 64, torch.float32, True, 100, None),
    (2, 2048, 8, 2, 32, torch.float32, True, None, None),      # phase 6's call
    (2, 2048, 8, 2, 32, torch.bfloat16, True, None, None),
    (2, 2048, 16, 2, 128, torch.bfloat16, True, None, None),
    (1, 300, 8, 2, 128, torch.float32, True, 77, None),
    (1, 300, 8, 2, 128, torch.bfloat16, False, None, 333),
    (1, 130, 4, 4, 64, torch.bfloat16, True, None, None),     # a 2-row tile
    # a window that ends before Skv: rows that see no key are V's mean
    (1, 200, 4, 1, 64, torch.bfloat16, False, 50, 77),
    (1, 200, 4, 1, 64, torch.float32, False, 50, 77),
    # phase 11's call: train_4k's sequence, a microbatch of 4
    (4, 4096, 32, 4, 64, torch.bfloat16, True, None, None),
    (4, 4096, 32, 4, 64, torch.float32, True, None, None),
    # head dims 80 (zamba2's serve call, phase 12 (d)) and 96 (phi-3-vision):
    # D = 80 computes on 96 columns, the padding zero-filled
    (4, 2048, 32, 32, 80, torch.bfloat16, True, None, None),
    (4, 2048, 32, 32, 80, torch.float32, True, None, None),
    (2, 2048, 32, 32, 96, torch.bfloat16, True, None, None),
    (2, 2048, 32, 32, 96, torch.float32, True, None, None),
    (2, 2048, 32, 32, 80, torch.bfloat16, True, 512, None),
    (2, 2048, 32, 32, 80, torch.float32, True, 512, None),
    (2, 1000, 32, 8, 96, torch.bfloat16, True, None, None),
    (2, 1000, 32, 8, 96, torch.float32, True, None, None),
    # the MoE prefills of phase 12 at D = 128 (key tiles of 64 in bf16):
    # qwen2-moe's call, and mixtral's under its 4,096-token window; then a
    # window that ends inside a key tile
    (4, 2048, 16, 16, 128, torch.bfloat16, True, None, None),
    (4, 2048, 16, 16, 128, torch.float32, True, None, None),
    (1, 8192, 48, 8, 128, torch.bfloat16, True, 4096, None),
    (1, 8192, 48, 8, 128, torch.float32, True, 4096, None),
    (1, 300, 8, 2, 128, torch.bfloat16, True, 77, None),
    # whisper's decoder calls of phase 13 (c) at train_4k's sequence, a
    # microbatch of 4, G = 1: the non-causal cross-attention against the
    # encoder's 1,500 frames (a ragged last key tile) and the causal
    # self-attention
    (4, 4096, 6, 6, 64, torch.bfloat16, False, None, 1500),
    (4, 4096, 6, 6, 64, torch.float32, False, None, 1500),
    (4, 4096, 6, 6, 64, torch.bfloat16, True, None, None),
    (4, 4096, 6, 6, 64, torch.float32, True, None, None),
    # head dims 16 to 256, each computed on D rounded up to 32 and,
    # where D's rows are no whole 16-byte copies (36 in bf16), zero-padded
    # by the wrapper: causal calls, windows, ragged S and non-causal calls
    # with Skv != Sq among them; the last is Gemma-2B's call
    *((B, S, H, KV, D, dt, causal, window, Skv)
      for B, S, H, KV, D, causal, window, Skv in (
          (2, 2048, 8, 2, 16, True, None, None),
          (1, 1000, 8, 8, 36, True, 128, None),
          (2, 700, 8, 4, 48, False, None, 333),
          (2, 2048, 8, 1, 112, True, None, None),
          (1, 1000, 8, 2, 160, True, 256, None),
          (1, 1500, 8, 8, 192, False, None, 1000),
          (1, 2048, 8, 1, 224, True, 512, None),
          (4, 2048, 8, 1, 256, True, None, None))
      for dt in (torch.bfloat16, torch.float32)),
)
# the head-dim calls timed (B, S, H, KV, D): zamba2's and phi-3-vision's
# serve calls, a call at each new width, Gemma-2B's and Gemma-7B's
# (arXiv:2403.08295: 8 query heads on 1 KV head, 16 on 16, D = 256)
FLASH_HEAD_DIMS = {"head_dim_80": (4, 2048, 32, 32, 80),
                   "head_dim_96": (2, 2048, 32, 32, 96),
                   "head_dim_36": (2, 2048, 16, 16, 36),
                   "head_dim_160": (2, 2048, 16, 16, 160),
                   "head_dim_192": (2, 2048, 16, 16, 192),
                   "head_dim_224": (2, 2048, 16, 16, 224),
                   "gemma_2b": (4, 2048, 8, 1, 256),
                   "gemma_7b": (2, 2048, 16, 16, 256)}
# the D = 256 shape of the gradient check (B, S, H, KV, D)
FLASH_GRAD_D256 = (1, 2048, 8, 1, 256)
# whisper's decoder calls, timed: (B, Sq, H, KV, D, Skv, causal)
FLASH_WHISPER = {"whisper_cross": (4, 4096, 6, 6, 64, 1500, False),
                 "whisper_self": (4, 4096, 6, 6, 64, 4096, True)}
FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# the kernels' log-sum-exp against flash_fwd_ref's: both take the max of
# the same fp32 scores and the log of an fp32 sum (the bf16 kernel's terms
# from ex2.approx), so fp32 holds 1e-5; bf16 gets 1e-2
FLASH_LSE_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# dq, dk, dv of the Function (kernel forward) against the all-plain
# forward, both through flash_bwd_ref, relative to each gradient's scale:
# fp32 1e-5 (the forwards agree to ~1e-6); bf16 2e-2 (out rounded to bf16,
# P rounded before P V, as the forward's own gate)
FLASH_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TRAIN_FLASH = (4, 4096, 32, 4, 64)      # B (a microbatch), S, H, KV, D


def check_flash(dev) -> list[dict]:
    """The flash kernels against their plain version on FLASH_CASES (fp32
    atol 1e-5; bf16 atol 2e-2, the JAX package's bf16 bound for its own
    kernel), each fp32 case launching the kernel of its head dim's route
    (``ops.f32_route``) twice; each timed at the serve path's call (the
    fp32 kernel on the same values in fp32), beside SDPA on the same inputs.
    Returns the entries of the bf16 (tensor-core), the fp32 (SIMT, head
    dims up to 128) and the 3xTF32 kernel (129 to 256, timed at Gemma-7B's
    call)."""
    from repro_torch.kernels.flash_attention import ops, ref
    # each width's two instances: D == DP (a compile-time D) and D < DP
    attrs = {f"{str(dt)[6:]}/DP{d}{tag}": ops.kernel_attributes(dt, d - less)
             for dt in (torch.bfloat16, torch.float32) for d in ops.COMPILED_WIDTHS
             for tag, less in (("", 0), ("-padded", ops.ROW_MULTIPLE[dt]))}
    log(json.dumps({"flash_instances": attrs}))
    gen = torch.Generator(device=dev).manual_seed(5)
    # the largest errors by kernel: bf16, fp32 on the SIMT kernel, "tf32"
    err = {torch.bfloat16: 0.0, torch.float32: 0.0, "tf32": 0.0}
    lse_err = dict(err)
    timed = None
    for B, S, H, KV, D, dt, causal, window, Skv in FLASH_CASES:
        Skv = Skv or S
        q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
        k = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
        v = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
        kernel, routed = dt, None
        if dt == torch.float32:
            route = ops.f32_route(-(-D // 4) * 4)
            kernel = dt if route == "simt" else "tf32"
            routed = (ops.F32_ROUTE_COUNTERS[route],
                      getattr(ops.flash_attention, ops.F32_ROUTE_COUNTERS[route]))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        del want
        # the same launch writing the log-sum-exp: out unchanged, lse
        # against the chunked plain forward's
        got_l, lse = ops.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window, with_lse=True)
        _, lse_want = ref.flash_fwd_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        e_lse = float((lse - lse_want).abs().max())
        case = [B, S, H, KV, D, str(dt), causal, window, Skv]
        log(json.dumps({"flash_case": case, "max_abs_err": e,
                        "lse_max_abs_err": e_lse,
                        "out_equal_with_lse": bool(torch.equal(got_l, got)),
                        "kernel": str(kernel)}))
        if routed and getattr(ops.flash_attention, routed[0]) - routed[1] != 2:
            raise AssertionError(f"{case} did not launch {routed[0]} twice")
        if not e <= FLASH_ATOL[dt]:
            raise AssertionError(f"flash kernel differs from its plain version by "
                                 f"{e} > {FLASH_ATOL[dt]} at {case}")
        if not torch.equal(got_l, got):
            raise AssertionError(f"the launch with lse changed out at {case}")
        if not e_lse <= FLASH_LSE_ATOL[dt]:
            raise AssertionError(f"flash kernel's lse differs from flash_fwd_ref's "
                                 f"by {e_lse} > {FLASH_LSE_ATOL[dt]} at {case}")
        err[kernel] = max(err[kernel], e)
        lse_err[kernel] = max(lse_err[kernel], e_lse)
        if timed is None:
            timed = (q, k, v)
        del got, got_l, lse, lse_want
    out = []
    for dt, name, source, peak in (
            (torch.bfloat16, "flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
             PEAK_BF16_S),
            (torch.float32, "flash_attention_f32", "src/repro_torch/csrc/flash_attention.cu",
             PEAK_FP32_S)):
        t = time_flash(*(x.to(dt) for x in timed), peak)
        entry = dict(name=name, route="cuda", source=source,
                     replaces="src/repro/kernels/flash_attention/kernel.py:25",
                     max_abs_err=err[dt], ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                     library_ms=t["library_ms"], ms_with_lse=t["ms_with_lse"],
                     lse_max_abs_err=lse_err[dt])
        entry.update(check_flash_grad(dev, dt, peak))
        B, S, H, KV, D = FLASH_GRAD_D256
        held = hold_flash_grad(dev, dt, B, S, H, KV, D, S, True, seed=25)
        del held["inputs"]
        entry["grad_d256"] = held
        for label, (B, S, H, KV, D) in FLASH_HEAD_DIMS.items():
            gen = torch.Generator(device=dev).manual_seed(D)
            entry[label] = time_flash(
                *(torch.randn(B, S, n, D, device=dev, generator=gen).to(dt)
                  for n in (H, KV, KV)), peak)
        entry["instances"] = {k.split("/")[1]: a for k, a in attrs.items()
                              if k.startswith(str(dt)[6:])}
        for label, (B, S, H, KV, D, Skv, causal) in FLASH_WHISPER.items():
            gen = torch.Generator(device=dev).manual_seed(23)
            entry[label] = time_flash(
                *(torch.randn(B, n, h, D, device=dev, generator=gen).to(dt)
                  for n, h in ((S, H), (Skv, KV), (Skv, KV))), peak, causal=causal)
        entry["whisper_cross_grad"] = check_cross_grad(dev, dt)
        out.append(entry)
    # fp32 past a head dim of 128: the 3xTF32 kernel's entry, timed at
    # Gemma-7B's call, its bound the 3xTF32 one (the CUDA cores' beside it)
    f32 = out[1]
    moved = {label: f32.pop(label) for label, dims in FLASH_HEAD_DIMS.items()
             if ops.f32_route(-(-dims[4] // 4) * 4) != "simt"}
    t = moved["gemma_7b"]
    out.append(dict(
        name="flash_attention_f32_tf32", route="cuda",
        source="src/repro_torch/csrc/flash_attention_tf32.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:25",
        max_abs_err=err["tf32"], lse_max_abs_err=lse_err["tf32"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_3xtf32_ms"],
        bound_by=t["bound_3xtf32_by"], bound_fp32_cores_ms=t["bound_ms"],
        library_ms=t["library_ms"], sdpa_backend=t["sdpa_backend"],
        ms_with_lse=t["ms_with_lse"], grad_d256=f32.pop("grad_d256"), **moved,
        instances={d: a for d, a in f32["instances"].items() if a["route"] == "tf32"}))
    f32["instances"] = {d: a for d, a in f32["instances"].items()
                        if a["route"] == "simt"}
    log(json.dumps({"flash_serve_shape_ms": {e["name"]: e["ms"] for e in out},
                    "with_lse_ms": {e["name"]: e["ms_with_lse"] for e in out},
                    "sdpa_ms": {e["name"]: e["library_ms"] for e in out}}))
    return out


def flash_fwd_bound(q: torch.Tensor, k: torch.Tensor, peak: float,
                    causal: bool = True) -> tuple[float, str]:
    """A forward's least time: QK^T and PV over the visible pairs, 2 D
    operations each (the D real columns) — causal (Sq = Skv = S):
    S(S+1)/2 per (batch, head), else Sq Skv; q, k, v read and o written
    once."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
    n_ops = 2 * 2 * B * H * D * pairs
    return bound(q.element_size() * (2 * q.numel() + 2 * k.numel()), n_ops, peak)


# torch's SDPBackend values (the enum of torch.nn.attention)
SDPA_BACKENDS = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}


def sdpa_backend(qt, kt, vt, causal: bool) -> str:
    """The backend SDPA's dispatcher picks for these [B, H, S, D] inputs
    (torch's private chooser: its name may change between versions)."""
    try:
        choice = torch._fused_sdp_choice(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    except (AttributeError, RuntimeError, TypeError) as err:
        return f"unknown ({type(err).__name__})"
    return SDPA_BACKENDS.get(int(choice), str(choice))


def time_flash(q, k, v, peak, causal: bool = True, iters: int = 20) -> dict:
    """The kernel of q's type at one call without a window: its ms with
    and without the lse output (CUDA events, ``iters`` calls), the plain
    version's and SDPA's on the same inputs (and SDPA's backend), and its
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    ms = cuda_ms(lambda: ops.flash_attention_cuda(q, k, v, causal=causal), iters)
    ms_lse = cuda_ms(lambda: ops.flash_attention_cuda(
        q, k, v, causal=causal, with_lse=True), iters)
    plain = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal), 3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
    backend = sdpa_backend(qt, kt, vt, causal)
    b_ms, b_by = flash_fwd_bound(q, k, peak, causal)
    res = {"shape": [*q.shape[:3], k.shape[2], q.shape[3]], "Skv": k.shape[1],
           "causal": causal, "ms": ms,
           "ms_with_lse": ms_lse, "plain_ms": plain, "library_ms": library,
           "sdpa_backend": backend,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms}
    if q.dtype == torch.float32:
        # fp32 past a head dim of 128 runs in 3xTF32: its share is read
        # against that bound (and the CUDA cores' bound_ms beside it)
        t_ms, t_by = flash_fwd_bound(q, k, PEAK_3XTF32_S, causal)
        res.update(route=ops.f32_route(-(-q.shape[3] // 4) * 4),
                   bound_3xtf32_ms=t_ms, bound_3xtf32_by=t_by,
                   share_of_3xtf32_bound=t_ms / ms)
    log(json.dumps({"flash_timed": dict(res, dtype=str(q.dtype))}))
    return res


def flash_bwd_bound(B: int, S: int, H: int, KV: int, D: int, esize: int,
                    Skv: int | None = None) -> tuple[float, str]:
    """The plain backward's least time at fp32 peak: its five fp32 block
    products (S, dP, dV, dQ, dK) over every (query, key) chunk pair it
    computes, masked ones included, against reading q, k, v, out, dout
    and lse once and writing dq, dk, dv once (S queries, Skv keys)."""
    from repro_torch.kernels.flash_attention.ref import KV_CHUNK, Q_CHUNK, chunk_of
    Skv = Skv or S
    qc, kc = chunk_of(S, Q_CHUNK), chunk_of(Skv, KV_CHUNK)
    n_ops = 5 * 2 * B * H * qc * kc * D * (S // qc) * (Skv // kc)
    n_bytes = esize * (2 * 2 * B * S * H * D + 2 * 2 * B * Skv * KV * D) + 4 * B * H * S
    return bound(n_bytes, n_ops)


def hold_flash_grad(dev, dt, B, S, H, KV, D, Skv, causal, seed) -> dict:
    """The wrapper's Function under grad (the kernel with its lse forward,
    ``flash_bwd_ref`` backward) against the all-plain forward
    (``flash_fwd_ref``) through the same backward, at q ``[B, S, H, D]``
    and k, v ``[B, Skv, KV, D]``: within FLASH_GRAD_TOL of each gradient's
    scale. Returns the errors and the inputs (q, k, v, dout)."""
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
    k = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
    v = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
    dout = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    calls, lse_launches = ops.flash_attention.backward_calls, ops.flash_attention.launches_lse
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, dout)
    if (ops.flash_attention.backward_calls - calls,
            ops.flash_attention.launches_lse - lse_launches) != (1, 1):
        raise AssertionError("the Function under grad did not launch the kernel "
                             "with lse once and call flash_bwd_ref once")
    del out, leaves
    out_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=causal)
    want = ref.flash_bwd_ref(q, k, v, out_p, lse_p, dout, causal=causal)
    errs = {n: float((g.float() - w.float()).abs().max() / w.float().abs().max())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    del got, want, out_p, lse_p
    shape = [B, S, H, KV, D, Skv, causal]
    log(json.dumps({"flash_grad": {"dtype": str(dt), "shape": shape,
                                   "err_over_scale": errs}}))
    if not max(errs.values()) <= FLASH_GRAD_TOL[dt]:
        raise AssertionError(f"{dt} flash gradients differ from the all-plain "
                             f"ones by {errs} of their scale > {FLASH_GRAD_TOL[dt]} "
                             f"at {shape}")
    return {"shape": shape, "err_over_scale": errs, "inputs": (q, k, v, dout)}


def sdpa_backward_ms(q, k, v, dout, causal: bool) -> float:
    """Row 9's library yardstick: the backward alone of one SDPA call
    (``enable_gqa=True``) on the same q, k, v and output gradient (CUDA
    events; the forward's graph is built once and kept)."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    gt = dout.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                               retain_graph=True), 5, warmup=1)


def check_cross_grad(dev, dt) -> dict:
    """``hold_flash_grad`` at whisper's cross-attention (non-causal, 4,096
    queries against 1,500 keys, chunks of 1,024 rows and 750 keys in
    ``flash_bwd_ref``), and ``flash_bwd_ref``'s ms there beside its fp32
    bound."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, KV, D, Skv, causal = FLASH_WHISPER["whisper_cross"]
    held = hold_flash_grad(dev, dt, B, S, H, KV, D, Skv, causal, seed=24)
    q, k, v, dout = held.pop("inputs")
    o, lse = ops.flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    held["flash_bwd_ref_ms"] = cuda_ms(lambda: ref.flash_bwd_ref(
        q, k, v, o, lse, dout, causal=causal), 3, warmup=1)
    held["flash_bwd_ref_bound_ms"], held["flash_bwd_ref_bound_by"] = flash_bwd_bound(
        B, S, H, KV, D, q.element_size(), Skv)
    held["sdpa_bwd_ms"] = sdpa_backward_ms(q, k, v, dout, causal)
    log(json.dumps({"flash_cross_grad": dict(held, dtype=str(dt))}))
    return held


def check_flash_grad(dev, dt, peak) -> dict:
    """The training path's flash at phase 11's shape (TRAIN_FLASH, causal):
    ``hold_flash_grad``; then the kernel's ms with and without lse, and
    ``flash_bwd_ref``'s ms beside its fp32 bound (CUDA events)."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, KV, D = TRAIN_FLASH
    held = hold_flash_grad(dev, dt, B, S, H, KV, D, S, True, seed=11)
    q, k, v, dout = held.pop("inputs")
    errs = held["err_over_scale"]
    ms = cuda_ms(lambda: ops.flash_attention_cuda(q, k, v, causal=True), 10)
    ms_lse = cuda_ms(lambda: ops.flash_attention_cuda(q, k, v, causal=True,
                                                      with_lse=True), 10)
    o_k, lse_k = ops.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    bwd_ms = cuda_ms(lambda: ref.flash_bwd_ref(q, k, v, o_k, lse_k, dout,
                                               causal=True), 3, warmup=1)
    sdpa_bwd = sdpa_backward_ms(q, k, v, dout, True)
    fwd_bound = flash_fwd_bound(q, k, peak)
    bwd_bound = flash_bwd_bound(B, S, H, KV, D, q.element_size())
    res = {"train_shape": [B, S, H, KV, D], "train_shape_ms": ms,
           "train_shape_ms_with_lse": ms_lse, "train_shape_bound_ms": fwd_bound[0],
           "grad_err_over_scale": errs, "flash_bwd_ref_ms": bwd_ms,
           "flash_bwd_ref_bound_ms": bwd_bound[0],
           "flash_bwd_ref_bound_by": bwd_bound[1], "sdpa_bwd_ms": sdpa_bwd}
    log(json.dumps({"flash_train_shape": dict(res, dtype=str(dt))}))
    return res


# ------------------------------------------------------------ phase 3 ----
def counters() -> dict:
    """Kernel name -> (wrapper, launch-count attribute)."""
    from repro_torch.kernels.dual_solve.ops import COUNTERS, dual_ascent, dual_solve
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.score_norm.ops import row_l2_norms
    from repro_torch.kernels.topk_sparsify.ops import (block_topk_rows,
                                                       block_topk_sparsify)
    names = {(False, False): "dual_solve", (True, False): "dual_solve_scaled",
             (False, True): "dual_solve_joint", (True, True): "dual_solve_joint_scaled"}
    out = {names[k]: (dual_solve, attr) for k, attr in COUNTERS.items()}
    out.update({FUSED[names[k]]: (dual_ascent, attr) for k, attr in COUNTERS.items()})
    out.update(topk_rows=(block_topk_rows, "launches"),
               topk_block=(block_topk_sparsify, "launches"),
               row_sq_sum=(row_l2_norms, "launches"),
               flash_attention=(flash_attention, "launches_bf16"),
               flash_attention_f32=(flash_attention, "launches_f32"),
               flash_attention_f16=(flash_attention, "launches_f16"),
               # fp32's 3xTF32 kernels (beside launches_f32, which counts
               # every fp32 launch)
               flash_attention_f32_tf32=(flash_attention, "launches_f32_tf32"),
               flash_attention_f32_tf32_cluster=(flash_attention,
                                                 "launches_f32_tf32_cluster"))
    return out


# a model dtype -> the flash wrapper's counter of its route, and the name of
# its kernel in counters() and the kernels line
FLASH_COUNTER = {"float32": "launches_f32", "bfloat16": "launches_bf16",
                 "float16": "launches_f16"}
FLASH_KERNEL = {"float32": "flash_attention_f32", "bfloat16": "flash_attention",
                "float16": "flash_attention_f16"}


def paper_trainer(dev, scenario=None, price_outage=None, bits_grid=None,
                  mesh=None):
    """The paper recipe at N = 50 with the full CNN, from the port's
    ``launch.experiments.build`` (the ``fl_experiments.build`` recipe and
    its seeded ``init_cnn`` weights), with its scenario, price_outage and
    bits_grid arguments; ``mesh`` shards the clients."""
    from repro_torch.launch.experiments import build
    make, _ = build(n_clients=N_CLIENTS, rounds=ROUNDS, seed=0,
                    scenario=scenario, price_outage=price_outage,
                    bits_grid=bits_grid, device=dev)
    return make("fairenergy", mesh=mesh)


# label -> (fl_experiments.build arguments, the fused dual-ascent variant it runs)
PATHS = {
    "main": (dict(), "dual_ascent"),
    "a_quantized": (dict(scenario="quantized"), "dual_ascent_joint"),
    "b_bursty_priced": (dict(scenario="bursty-interference", price_outage=True),
                        "dual_ascent_scaled"),
    "c_bursty_priced_joint": (dict(scenario="bursty-interference",
                                   price_outage=True, bits_grid=BITS),
                              "dual_ascent_joint_scaled"),
    # (a) and (c) on the 40-level joint grid (10 gammas x BITS40)
    "d_quantized_40": (dict(scenario="quantized", bits_grid=BITS40),
                       "dual_ascent_joint"),
    "e_bursty_priced_joint_40": (dict(scenario="bursty-interference",
                                      price_outage=True, bits_grid=BITS40),
                                 "dual_ascent_joint_scaled"),
}


def drive_path(dev, label: str) -> dict:
    """Run one path's 5 rounds with every launch count zeroed just before
    and read just after; check what the path must show."""
    build_kw, own = PATHS[label]
    t0 = time.perf_counter()
    tr = paper_trainer(dev, **build_kw)
    log(f"path {label}: {tr.n_clients} clients, D={tr.n_params}, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    fns = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    tr.run_scanned(ROUNDS, verbose=False)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for lg in tr.history:
        sel = lg.selected
        log(json.dumps({
            "path": label, "round": lg.round, "selected": int(sel.sum()),
            "mean_gamma": float(lg.gamma[sel].mean()) if sel.any() else None,
            "mean_bits": (float(lg.bits[sel].mean()) if lg.bits is not None
                          and sel.any() else None),
            "n_retx": lg.n_retx, "n_outage": lg.n_outage,
            "goodput_frac": lg.goodput_frac, "e_saved": lg.e_saved,
            "energy_J": lg.total_energy, "accuracy": lg.accuracy,
            "wall_ms": lg.wall_s * 1e3}))
    for name in ("topk_rows", "row_sq_sum"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on path {label}")
    # the solver: exactly one fused launch a round, of this path's variant;
    # no other variant and no one-step launch
    if launches[own] != ROUNDS:
        raise AssertionError(f"path {label} launched {own} {launches[own]} "
                             f"times in {ROUNDS} rounds, not once a round")
    others = [n for n in launches if n.startswith("dual_") and n != own
              and launches[n] != 0]
    if others:
        raise AssertionError(f"path {label} launched {others} besides {own}")
    # the main path's top-k launches must have sparsified something: some
    # selected client sent gamma < 1, i.e. k = ceil(gamma * 4096) < 4096
    if label == "main" and not any((lg.gamma[lg.selected] < 1.0).any()
                                   for lg in tr.history):
        raise AssertionError(f"path {label}: no selected client had gamma < 1: "
                             "the top-k kernel copied every row through")
    if not all(bool(torch.isfinite(p).all()) for p in tr.params.values()):
        raise AssertionError(f"non-finite params after path {label}")
    if not all(np.isfinite(lg.energy).all() and np.isfinite(lg.accuracy)
               for lg in tr.history):
        raise AssertionError(f"non-finite energy or accuracy on path {label}")
    if own in ("dual_ascent_joint", "dual_ascent_joint_scaled"):
        if not any((lg.bits[lg.selected] < 32.0).any() for lg in tr.history):
            raise AssertionError(f"path {label}: no selected client sent < 32 bits")
    if own in ("dual_ascent_scaled", "dual_ascent_joint_scaled"):
        if sum(lg.n_retx for lg in tr.history) < 1:
            raise AssertionError(f"path {label}: no retransmission in {ROUNDS} rounds")
    steady = [lg.wall_s for lg in tr.history[1:]]
    log(json.dumps({"path_summary": {
        "path": label, "rounds": ROUNDS, "launches": launches,
        "dual_ascent_launches_per_round": launches[own] / ROUNDS,
        "round_ms_first": tr.history[0].wall_s * 1e3,
        "round_ms_steady_mean": 1e3 * sum(steady) / len(steady),
        "rounds_per_s_steady": len(steady) / sum(steady),
        "peak_mem_GB": peak / 1e9}}))
    return dict(trainer=tr, launches=launches, own=own,
                steady_ms=1e3 * sum(steady) / len(steady))


def profile_round(tr, r: int, label: str):
    """torch.profiler over one more round of a path: device time by kernel
    and the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_round(r)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    log(json.dumps({"profile_path": label, "profile_round": r,
                    "wall_ms": wall * 1e3,
                    "device_busy_ms": busy_us / 1e3,
                    "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
                    "top_kernels": [{"name": e.key[:80], "calls": e.count,
                                     "ms": e.self_device_time_total / 1e3}
                                    for e in top]}))


# ------------------------------------------------------------ phase 4 ----
def solver_setting(variant: str):
    """The main path's solver setting for one variant, on the CPU: N = 50
    on the paper channel, S = 32 D and I = D bits for the full CNN, the
    default FairEnergyConfig (alpha_lambda = 2e-4, where the price
    iteration runs to its cap) with eta from eta_auto, and 5 rounds of
    observations, with the variant's pricing (e_scale = expected_attempts
    of a per-attempt outage between the 6 dB floor and the cap) and grid
    (the paper's gammas x (8, 16, 32)). Returns (controller, P, [h], [u],
    [e_scale or None]) a round."""
    import dataclasses

    from repro_torch.configs import ChannelConfig, FairEnergyConfig
    from repro_torch.core.channel import WirelessNetwork
    from repro_torch.core.controllers import ControllerContext, make_controller
    from repro_torch.core.link import expected_attempts

    scaled, joint, _ = DUAL_VARIANTS[variant]
    ch = ChannelConfig(n_clients=N_CLIENTS)
    d = 1_630_090
    fe = FairEnergyConfig()
    if joint:
        fe = dataclasses.replace(fe, bits_grid=BITS)
    ctx = ControllerContext(n_clients=N_CLIENTS, b_tot=ch.bandwidth_total,
                            s_bits=32.0 * d, i_bits=float(d),
                            n0=ch.noise_density, fe_cfg=fe, device="cpu")
    ctrl = make_controller("fairenergy", ctx)
    net = WirelessNetwork(ch, seed=0)
    P = torch.as_tensor(net.power, dtype=torch.float32)
    hs = [torch.as_tensor(net.gains(r), dtype=torch.float32) for r in range(5)]
    gen = torch.Generator().manual_seed(50)
    us = [0.05 + 0.45 * torch.rand(N_CLIENTS, generator=gen) for _ in range(5)]
    floor = 1.0 - math.exp(-1.0 / 10.0 ** 0.6)
    ess = [expected_attempts(floor + (0.999 - floor)
                             * torch.rand(N_CLIENTS, generator=gen))
           if scaled else None for _ in range(5)]
    ctrl.calibrate(us[0].numpy(), hs[0].numpy(), P.numpy())
    return ctrl, P, hs, us, ess


def to_device(state, dv):
    """A (nested) NamedTuple of tensors moved to ``dv``."""
    return type(state)(*[to_device(v, dv) if isinstance(v, tuple) else v.to(dv)
                         for v in state])


def solver_card_against_cpu(dev, variant: str):
    """solve_round on the card and on the CPU at the main path's setting
    (``solver_setting``), 5 warm-started rounds. Masks, gammas, widths and
    n_inner exactly equal; lam and energies to rtol 1e-5."""
    from repro_torch.core.fairenergy import solve_round

    scaled, joint, _ = DUAL_VARIANTS[variant]
    ctrl, P, hs, us, ess = solver_setting(variant)
    states = {"cpu": ctrl.init(N_CLIENTS)}
    states["cuda"] = to_device(states["cpu"], dev)
    fns = counters()
    before = getattr(*fns[FUSED[variant]])
    for r in range(5):
        dec = {}
        for name in ("cuda", "cpu"):
            dv = dev if name == "cuda" else torch.device("cpu")
            dec[name], states[name] = solve_round(
                us[r].to(dv), hs[r].to(dv), P.to(dv), states[name],
                fe_cfg=ctrl.fe_cfg, e_scale=None if ess[r] is None else ess[r].to(dv))
        a, b = dec["cuda"], dec["cpu"]
        x_a, x_b = a.x.cpu(), b.x
        if not torch.equal(x_a, x_b):
            raise AssertionError(f"{variant} solver round {r}: masks differ, cuda "
                                 f"{x_a.int().tolist()} cpu {x_b.int().tolist()}")
        if not torch.equal(a.gamma.cpu(), b.gamma) or int(a.n_inner) != int(b.n_inner):
            raise AssertionError(f"{variant} solver round {r}: gamma or n_inner differ")
        if joint and not torch.equal(a.bits.cpu(), b.bits):
            raise AssertionError(f"{variant} solver round {r}: widths differ")
        for name in ("lam", "energy", "bandwidth"):
            torch.testing.assert_close(getattr(a, name).cpu(), getattr(b, name),
                                       rtol=1e-5, atol=1e-12)
        log(json.dumps({"solver_card_vs_cpu": variant, "round": r,
                        "n_inner": int(b.n_inner), "selected": int(x_b.sum()),
                        "mean_gamma": float(b.gamma[x_b].mean()) if x_b.any() else None,
                        "mean_bits": float(b.bits[x_b].mean())
                        if joint and x_b.any() else None,
                        "lam_rel_diff": abs(float(a.lam) - float(b.lam))
                        / max(abs(float(b.lam)), 1e-30)}))
    if getattr(*fns[FUSED[variant]]) != before + 5:
        raise AssertionError(f"the card's solver did not launch "
                             f"{FUSED[variant]} once a round")


# the fixed-K knobs of phase 4's baseline runs (N = 8): EcoRandom at a
# gamma below 1, so its rows are sparsified
BASELINE_KW = dict(fixed_k=3, eco_gamma=0.25, eco_bandwidth=2e6)
BASELINES = ("scoremax", "ecorandom", "randomfull", "channelgreedy", "tilted")


def _split_gap(label: str, r: int, a, b, scores) -> str:
    """What a mask split between the card and the CPU looks like: the
    clients that differ and, for a ranking strategy, the relative gap
    between the K-th and the (K+1)-th score on the CPU."""
    who = np.nonzero(a.selected != b.selected)[0].tolist()
    msg = f"{label} round {r}: masks differ at clients {who}"
    if scores is not None:
        k = int(b.selected.sum())
        top = np.sort(scores)[::-1]
        if 0 < k < top.size:
            msg += (f"; K-th/(K+1)-th scores {top[k - 1]:.9g} / {top[k]:.9g}, "
                    f"relative gap {(top[k - 1] - top[k]) / abs(top[k - 1]):.3g}")
    return msg


# the GSS check's warm-started rounds: 0-2 of the solver checks' 5 (the
# card's plain-PyTorch GSS takes 18-52 s a round, launch-bound)
GSS_ROUNDS = 3


def _gss_setting():
    import dataclasses
    ctrl, P, hs, us, _ = solver_setting("dual_solve")
    return ctrl, dataclasses.replace(ctrl.fe_cfg, bw_solver="gss"), P, hs, us


def _gss_rounds(dv) -> list:
    """GSS_ROUNDS warm-started ``solve_round`` calls with
    ``bw_solver="gss"`` at the main path's setting on ``dv``: each round's
    decision as numpy arrays and its seconds."""
    from repro_torch.core.fairenergy import solve_round

    ctrl, fe, P, hs, us = _gss_setting()
    state = to_device(ctrl.init(N_CLIENTS), dv)
    out = []
    for r in range(GSS_ROUNDS):
        t0 = time.perf_counter()
        dec, state = solve_round(us[r].to(dv), hs[r].to(dv), P.to(dv), state,
                                 fe_cfg=fe)
        got = {k: getattr(dec, k).cpu().numpy()
               for k in ("x", "gamma", "lam", "energy", "bandwidth")}
        got["n_inner"] = int(dec.n_inner)
        got["s"] = time.perf_counter() - t0
        out.append(got)
    return out


def gss_side(src: str, device: str) -> tuple:
    """``_gss_rounds`` on ``device`` in a child process (``src``: the
    repository's ``src`` directory): the rounds, and whether a dual-solve
    kernel was launched meanwhile (the GSS path launches none)."""
    if src not in sys.path:
        sys.path.insert(0, src)
    dv = torch.device(device)
    if dv.type == "cuda":
        torch.cuda.set_device(dv)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(2)
    fns = counters()
    count = lambda: {k: getattr(fn, attr) for k, (fn, attr) in fns.items()  # noqa: E731
                     if k.startswith("dual_")}
    before = count()
    rounds = _gss_rounds(dv)
    return rounds, count() != before


def start_gss_check(dev):
    """The GSS check's two sides, each in a spawned child process: they
    run while the script goes on (phase 14), the card's beside its other
    work on the same card. Returns (executor, card future, CPU future)."""
    import concurrent.futures
    import multiprocessing
    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    src = str(HERE / "src")
    return ex, ex.submit(gss_side, src, str(dev)), ex.submit(gss_side, src, "cpu")


def gss_card_against_cpu(check):
    """``solve_round`` with ``bw_solver="gss"`` (plain PyTorch on either
    device) at the main path's setting, GSS_ROUNDS warm-started rounds on
    the card and on the CPU (``check``: ``start_gss_check``'s): masks,
    gammas and n_inner equal; energies, widths and lam to rtol 2e-3, the
    golden-section search's own reach (ROADMAP C-18: it ends on float32
    noise in a flat minimum), measured and logged; no dual-solve kernel
    is launched."""
    ex, card_f, cpu_f = check
    try:
        (card, card_launched), (cpu, _) = card_f.result(), cpu_f.result()
    finally:
        ex.shutdown()
    if card_launched:
        raise AssertionError("the gss solver launched a dual-solve kernel")
    if len(card) != GSS_ROUNDS or len(cpu) != GSS_ROUNDS:
        raise AssertionError(f"gss rounds: card {len(card)}, cpu {len(cpu)}")
    for r, (a, b) in enumerate(zip(card, cpu)):
        if not np.array_equal(a["x"], b["x"]):
            raise AssertionError(f"gss solver round {r}: masks differ, cuda "
                                 f"{a['x'].astype(int).tolist()} cpu "
                                 f"{b['x'].astype(int).tolist()}")
        if not np.array_equal(a["gamma"], b["gamma"]) or a["n_inner"] != b["n_inner"]:
            raise AssertionError(f"gss solver round {r}: gamma or n_inner differ")
        rel = {name: float(np.max(np.abs(a[name] - b[name])
                                  / np.maximum(np.abs(b[name]), 1e-30)))
               for name in ("lam", "energy", "bandwidth")}
        log(json.dumps({"gss_card_vs_cpu": r, "n_inner": b["n_inner"],
                        "selected": int(b["x"].sum()), "max_rel": rel,
                        "card_s": a["s"], "cpu_s": b["s"]}))
        for name in ("lam", "energy", "bandwidth"):
            np.testing.assert_allclose(a[name], b[name], rtol=2e-3, atol=1e-12)


def topk_mask_on_card(dev):
    """The baselines' ``topk_mask`` on CUDA tensors: ties to the lower
    index and NaN last, as ``np.argsort(-scores, kind="stable")``."""
    from repro_torch.core.controllers import topk_mask
    rows = ([3.0, 1.0, 3.0, 5.0, 0.5], [2.0] * 6,
            [1.0, float("nan"), 4.0, float("nan"), -float("inf"), 4.0],
            [float("nan"), float("nan"), 0.0],
            [-float("inf"), -float("inf"), 1.0, float("inf")])
    for row in rows:
        s = np.asarray(row, np.float32)
        for k in range(s.size + 1):
            want = np.zeros(s.size, bool)
            want[np.argsort(-s, kind="stable")[:k]] = True
            got = topk_mask(torch.tensor(s, device=dev), k).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"topk_mask on the card: {row} k={k} "
                                     f"gives {got.astype(int)}, want {want.astype(int)}")
    log(json.dumps({"topk_mask_on_card": len(rows)}))


def card_against_cpu(dev, scenario=None, price_outage=None, bits_grid=None,
                     strategy="fairenergy", async_cfg=None, fe_kw=None,
                     label=None, rounds=2, hierarchy=None):
    """The smoke CNN with N = 8 for ``rounds`` rounds on the card and on the
    CPU; the scenario arguments as in paper_trainer (a scenario's timed,
    fault, defense and mobility configs included; ``async_cfg`` replaces
    its timed one); ``fe_kw`` replaces FairEnergyConfig fields; a baseline
    ``strategy`` runs with ``BASELINE_KW``; ``hierarchy`` (a
    HierarchyConfig) samples the decide path. Masks, gammas, widths,
    retransmissions, and on the timed and fault paths ``made``,
    ``n_late``, ``n_stale``, ``n_faulted``, ``n_rejected`` and ``fallback``
    exactly equal, with a hierarchy the pool of every round and the
    cluster assignment too; energies rtol 1e-4 (1e-5 on the timed, fault,
    mobility and hierarchy paths), ``t_round`` rtol 1e-5 and
    ``clip_frac`` within 1e-6. A mask split is reported with its gap and
    fails the phase."""
    import dataclasses

    from repro_torch.configs import ChannelConfig, FairEnergyConfig, FLConfig
    from repro_torch.configs.fmnist_cnn import SMOKE
    from repro_torch.data import dirichlet_partition, make_fmnist_like
    from repro_torch.fl import FederatedTrainer
    from repro_torch.launch.experiments import DATA_KW
    from repro_torch.models import CNN, cnn_loss
    from repro_torch.scenarios import get_scenario

    n = 8
    imgs, labels = make_fmnist_like(640, seed=1, **DATA_KW)
    ti, tl = make_fmnist_like(256, seed=1000, **dict(DATA_KW, label_noise=0.0))
    parts = dirichlet_partition(labels, n, 0.3, seed=1)
    shards = [{"images": imgs[p], "labels": labels[p]} for p in parts]
    params0 = {k: v.detach().clone() for k, v in
               CNN(SMOKE, torch.Generator().manual_seed(1)).named_parameters()}
    # a grid without 1.0 sparsifies every selected update; the smaller
    # dual step keeps the price iteration from oscillating on this small
    # model (see tests/test_torch_trainer.py)
    fe = FairEnergyConfig(gamma_grid=(0.1, 0.25, 0.5), alpha_lambda=5e-5)
    extra = {}
    if scenario is not None:
        scn = get_scenario(scenario)
        fe = scn.apply_fe(fe)
        extra = dict(device_profile=scn.device_profile(n, seed=1),
                     link_cfg=scn.link_config(price_outage=price_outage),
                     async_cfg=scn.async_config(),
                     fault_cfg=scn.fault_config(),
                     defense=scn.defense_config(),
                     mobility=scn.mobility_config())
    if async_cfg is not None:
        extra["async_cfg"] = async_cfg
    if hierarchy is not None:
        extra["hierarchy"] = hierarchy
    if bits_grid is not None:
        fe = dataclasses.replace(fe, bits_grid=bits_grid)
    if fe_kw:
        fe = dataclasses.replace(fe, **fe_kw)
    robust = any(extra.get(k) is not None
                 for k in ("async_cfg", "fault_cfg", "defense", "mobility",
                           "hierarchy")) or bool(fe_kw)
    if strategy != "fairenergy":
        extra.update(BASELINE_KW)
    hist, pools, assign = {}, {}, {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = CNN(SMOKE).to(d)
        ti_d, tl_d = torch.as_tensor(ti, device=d), torch.as_tensor(tl, device=d).long()

        def eval_fn(p, model=model, ti_d=ti_d, tl_d=tl_d):
            lg = torch.func.functional_call(model, p, (ti_d,))
            return torch.mean((torch.argmax(lg, -1) == tl_d).to(torch.float32))

        tr = FederatedTrainer(
            model_loss=cnn_loss(model), model_params=params0,
            client_datasets=shards, eval_fn=eval_fn,
            fl_cfg=FLConfig(local_steps=2, local_batch=32, lr=0.05),
            fe_cfg=fe, ch_cfg=ChannelConfig(n_clients=n), seed=1, device=d,
            strategy=strategy, **extra)
        pools[name] = record_pools(tr)
        tr.run_scanned(rounds, verbose=False)
        hist[name] = tr.history
        if hierarchy is not None:
            assign[name] = tr.ctrl_state.assign.cpu()
        if name == "cpu":
            net = tr.network
    label = label or scenario or ("legacy" if strategy == "fairenergy"
                                  else strategy)
    if hierarchy is not None:
        if len(pools["cuda"]) != rounds or any(
                not torch.equal(a, b)
                for a, b in zip(pools["cuda"], pools["cpu"])):
            raise AssertionError(f"{label}: the pools differ between the card "
                                 f"and the CPU: {pools}")
        if not torch.equal(assign["cuda"], assign["cpu"]):
            raise AssertionError(f"{label}: the cluster assignment differs")
    for a, b in zip(hist["cuda"], hist["cpu"]):
        if not np.array_equal(a.selected, b.selected):
            # the ranking a fixed-K baseline cut at K (tilted's is random)
            scores = net.gains(a.round) if strategy == "channelgreedy" else None
            raise AssertionError(_split_gap(label, a.round, a, b, scores))
        np.testing.assert_array_equal(a.gamma, b.gamma)
        if b.bits is not None:
            np.testing.assert_array_equal(a.bits, b.bits)
        if (a.n_retx, a.n_outage) != (b.n_retx, b.n_outage):
            raise AssertionError(f"{label} round {a.round}: retransmissions differ")
        counts = ("n_late", "n_stale", "n_faulted", "n_rejected", "fallback")
        if tuple(getattr(a, k) for k in counts) != tuple(getattr(b, k) for k in counts):
            raise AssertionError(
                f"{label} round {a.round}: {counts} differ, cuda "
                f"{[getattr(a, k) for k in counts]} cpu {[getattr(b, k) for k in counts]}")
        if (a.made is None) != (b.made is None) or (
                a.made is not None and not np.array_equal(a.made, b.made)):
            raise AssertionError(f"{label} round {a.round}: made differs")
        if (a.t_round is None) != (b.t_round is None) or (
                a.t_round is not None
                and not abs(a.t_round - b.t_round) <= 1e-5 * abs(b.t_round)):
            raise AssertionError(f"{label} round {a.round}: t_round "
                                 f"{a.t_round} vs {b.t_round}")
        if (a.clip_frac is None) != (b.clip_frac is None) or (
                a.clip_frac is not None and not abs(a.clip_frac - b.clip_frac) <= 1e-6):
            raise AssertionError(f"{label} round {a.round}: clip_frac "
                                 f"{a.clip_frac} vs {b.clip_frac}")
        np.testing.assert_allclose(a.energy, b.energy, rtol=1e-5 if robust else 1e-4,
                                   atol=0)
        log(json.dumps({"card_vs_cpu": label, "strategy": strategy,
                        "price_outage": price_outage,
                        "bits_grid": bits_grid, "round": a.round,
                        "selected": a.selected.astype(int).tolist(),
                        "bits": None if a.bits is None else a.bits.tolist(),
                        "n_retx": a.n_retx, "n_outage": a.n_outage,
                        "made": None if a.made is None else a.made.astype(int).tolist(),
                        "n_stale": a.n_stale, "t_round": a.t_round,
                        "n_faulted": a.n_faulted, "n_rejected": a.n_rejected,
                        "clip_frac": a.clip_frac, "fallback": a.fallback,
                        "energy_max_rel": float(np.max(np.abs(a.energy - b.energy)
                                                       / np.maximum(np.abs(b.energy), 1e-30))),
                        "pool": (pools["cuda"][a.round].tolist()
                                 if hierarchy is not None else None),
                        "accuracy_cuda": a.accuracy, "accuracy_cpu": b.accuracy}))
    return hist["cuda"]


def record_pools(tr) -> list:
    """The candidate pool of each round a sampled trainer decides on (on
    the host), recorded by wrapping the controller's ``pool_for`` on this
    instance; an empty list stays empty for an unwrapped controller."""
    pools = []
    if hasattr(tr.controller, "pool_for"):
        pool_for = tr.controller.pool_for

        def recording(state, round_idx, alive=None):
            idx = pool_for(state, round_idx, alive)
            pools.append(idx.cpu())
            return idx
        tr.controller.pool_for = recording
    return pools


def hierarchy_card_against_cpu(dev) -> None:
    """Phase 4's population-scale runs (N = 8): the mobility scenario, the
    hierarchy (clusters 2, pool_frac 0.5), the hierarchy with the joint
    bits grid (the bits scatter) and the hierarchy under churn (arrivals
    re-clustered): pools, assignment, masks and bits equal on the card and
    the CPU, energies rtol 1e-5."""
    from repro_torch.core.hierarchy import HierarchyConfig
    hier = HierarchyConfig(clusters=2, pool_frac=0.5)
    card_against_cpu(dev, "mobility", rounds=3)
    card_against_cpu(dev, hierarchy=hier, rounds=3, label="hierarchy")
    card_against_cpu(dev, hierarchy=hier, bits_grid=BITS, rounds=3,
                     label="hierarchy_bits")
    card_against_cpu(dev, "churn", hierarchy=hier, rounds=3,
                     label="hierarchy_churn")


# the oscillating solver setting of tests/test_fault_injection.py (the
# bandwidth dual step far too large: the ascent's residual does not shrink
# at its cap), with the fallback guard on
OSCILLATING = dict(eta=1e-2, eta_auto=False, alpha_lambda=1e2, inner_iters=6,
                   dual_tol=1e-3, solver_fallback=True)


def robust_card_against_cpu(dev) -> None:
    """Phase 4's timed, fault and defense runs (N = 8, 3 rounds): the
    straggler, harvesting with a quantile deadline, churn and
    byzantine-lite scenarios, and byzantine-lite on the oscillating solver
    setting with the fallback guard on, which must take the fallback in
    some round on both devices."""
    from repro_torch.core.rounds import AsyncConfig
    card_against_cpu(dev, "straggler", rounds=3)
    card_against_cpu(dev, "harvesting", rounds=3, label="harvesting_deadline",
                     async_cfg=AsyncConfig(deadline_q=0.5, harvest_j=2e-3))
    card_against_cpu(dev, "churn", rounds=3)
    card_against_cpu(dev, "byzantine-lite", rounds=3)
    hist = card_against_cpu(dev, "byzantine-lite", rounds=3, fe_kw=OSCILLATING,
                            label="solver_fallback_oscillating")
    if not any(lg.fallback for lg in hist):
        raise AssertionError("the oscillating setting took no fallback round")


# ------------------------------------------------------------ phase 8 ----
# the paper's experiment: its recipe's own 60 rounds, the extra baselines,
# two seed lanes a strategy, and FairEnergy's config lanes at half and
# twice the eta that eta_auto calibrates on this recipe (0.0807)
EXPERIMENT = dict(n_clients=N_CLIENTS, rounds=60, seed=0, extra_baselines=True,
                  sweep_seeds=(0, 1), config_sweep={"eta": [0.04, 0.16]})
EXPERIMENT_OUT = HERE / "build" / "chip_smoke" / "fl_results_torch.json"


def paper_experiment(dev) -> dict:
    """``launch.experiments.run_all`` at the paper recipe on the card, each
    run with every launch count zeroed just before it and read just after:
    FairEnergy launches its fused ascent once a round (of each lane in a
    sweep), a baseline no dual-solve kernel, every run the top-k and the
    norms. The protocol's K, EcoRandom gamma (< 1: its rows are really
    sparsified) and bandwidth are in range, energies and accuracies
    finite, and each strategy's seed-0 sweep lane equals its
    ``run_scanned`` run bit for bit. Prints a line a strategy and
    FairEnergy's energy a round against each baseline's (recorded, not
    gated); the results JSON goes under ``build/``."""
    from repro_torch.launch.experiments import _json_safe, run_all

    fns = counters()
    rounds, lanes = EXPERIMENT["rounds"], len(EXPERIMENT["sweep_seeds"])
    n_cfg = len(EXPERIMENT["config_sweep"]["eta"])
    seen = {}

    def monitor(event, phase, name, obj):
        if event == "before":
            torch.cuda.synchronize()
            for fn, attr in fns.values():
                setattr(fn, attr, 0)
            seen[(phase, name)] = {"t0": time.perf_counter()}
            return
        torch.cuda.synchronize()
        rec = seen[(phase, name)]
        rec["wall_s"] = time.perf_counter() - rec.pop("t0")
        rec["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in fns.items()}
        if phase == "run":
            rec["history"] = list(obj.history)
        else:
            rec["outs"] = obj

    t0 = time.perf_counter()
    res = run_all(verbose=False, device=dev, monitor=monitor, **EXPERIMENT)
    total_s = time.perf_counter() - t0
    k, g, bw = res["k"], res["eco_gamma"], res["eco_bandwidth"]
    b_tot = 10e6
    if not (1 <= k <= N_CLIENTS and 0.0 < g < 1.0 and 0.0 < bw <= b_tot):
        raise AssertionError(f"protocol constants out of range: K {k}, "
                             f"eco_gamma {g}, eco_bandwidth {bw}")
    fused = "dual_ascent"
    for (phase, name), rec in seen.items():
        n = rec["launches"]
        runs = {"run": 1, "sweep": lanes, "config_sweep": lanes * n_cfg}[phase]
        for kernel in ("topk_rows", "row_sq_sum"):
            if n[kernel] <= 0:
                raise AssertionError(f"{phase} {name} launched no {kernel}")
        duals = {kk: v for kk, v in n.items() if kk.startswith("dual_") and v}
        want = {fused: rounds * runs} if name == "fairenergy" else {}
        if duals != want:
            raise AssertionError(f"{phase} {name}: dual-solve launches {duals}, "
                                 f"want {want}")
    out = {"experiment": {kk: v for kk, v in EXPERIMENT.items()},
           "k": k, "eco_gamma": g, "eco_bandwidth": bw,
           "total_s": total_s, "strategies": {}}
    fe_epr = float(np.mean(res["strategies"]["fairenergy"]["energy_per_round_J"]))
    for name, s in res["strategies"].items():
        hist = seen[("run", name)]["history"]
        sweep = seen[("sweep", name)]["outs"]
        if not (np.isfinite(s["energy_per_round_J"]).all()
                and np.isfinite(s["accuracy"]).all()
                and np.isfinite(sweep["energy"]).all()
                and np.isfinite(sweep["accuracy"]).all()):
            raise AssertionError(f"{name}: non-finite energy or accuracy")
        lane0 = {"x": np.stack([lg.selected for lg in hist]),
                 "energy": np.stack([lg.energy for lg in hist]),
                 "accuracy": np.array([lg.accuracy for lg in hist], np.float32)}
        for key, want in lane0.items():
            if not np.array_equal(sweep[key][0], want):
                diff = int(np.sum(sweep[key][0] != want))
                raise AssertionError(f"{name}: seed lane 0's {key} differs from "
                                     f"its run_scanned run on {diff} entries")
        steady = [lg.wall_s for lg in hist[1:]]
        sw = seen[("sweep", name)]["wall_s"]
        epr = float(np.mean(s["energy_per_round_J"]))
        line = {"strategy": name, "rounds": rounds,
                "round_ms_steady_mean": 1e3 * sum(steady) / len(steady),
                "rounds_per_s_steady": len(steady) / sum(steady),
                "sweep_rounds_per_s": lanes * rounds / sw,
                "energy_per_round_J": epr,
                "final_accuracy": s["accuracy"][-1],
                "participation": s["participation"],
                "mean_selected": s["mean_selected"], "mean_gamma": s["mean_gamma"],
                "sweep_final_acc_mean": res["sweep"]["strategies"][name]["final_acc_mean"],
                "launches_run": {kk: v for kk, v in seen[("run", name)]["launches"].items() if v},
                "launches_sweep": {kk: v for kk, v in seen[("sweep", name)]["launches"].items() if v}}
        if name != "fairenergy":
            line["fairenergy_energy_saving_vs_this"] = 1.0 - fe_epr / epr
        log(json.dumps({"experiment_strategy": line}))
        out["strategies"][name] = line
    cs = seen[("config_sweep", "fairenergy")]
    out["config_sweep"] = {"lanes": res["config_sweep"]["lanes"],
                           "rounds_per_s": lanes * n_cfg * rounds / cs["wall_s"],
                           "launches": {kk: v for kk, v in cs["launches"].items() if v}}
    log(json.dumps({"experiment_config_sweep": out["config_sweep"]}))
    log(json.dumps({"experiment_summary": {
        "k": k, "eco_gamma": g, "eco_bandwidth": bw, "total_s": total_s,
        "fairenergy_energy_per_round_J": fe_epr,
        "saving_vs": {n: s["fairenergy_energy_saving_vs_this"]
                      for n, s in out["strategies"].items() if n != "fairenergy"}}}))
    EXPERIMENT_OUT.parent.mkdir(parents=True, exist_ok=True)
    EXPERIMENT_OUT.write_text(json.dumps(_json_safe({"results": res, "card": out}),
                                         indent=1, default=float))
    return out


# the experiment CLI with and without --shard-clients (A-10b): the paper's
# N = 50 at a few rounds
CLI_ROUNDS = 3
CLI_OUT = HERE / "build" / "chip_smoke"


def _cli_json(path) -> dict:
    res = json.loads(Path(path).read_text())
    res.pop("elapsed_s")
    return res


def sharded_cli_one_card(dev) -> dict:
    """Phase 8, A-10b: ``launch.experiments.cli`` at N = 50, CLI_ROUNDS
    rounds, unsharded and with ``--shard-clients`` (here one NCCL rank, the
    one card): the two JSONs equal but for the wall time."""
    from repro_torch.launch import experiments
    argv = ["--clients", str(N_CLIENTS), "--rounds", str(CLI_ROUNDS),
            "--device", str(dev)]
    walls = {}
    for name, extra in (("plain", []), ("sharded", ["--shard-clients"])):
        t0 = time.perf_counter()
        experiments.cli(argv + ["--out", str(CLI_OUT / f"cli_{name}.json")] + extra)
        walls[name] = time.perf_counter() - t0
    same = _cli_json(CLI_OUT / "cli_plain.json") == _cli_json(CLI_OUT / "cli_sharded.json")
    log(json.dumps({"cli_shard_clients_one_card": {
        "n_clients": N_CLIENTS, "rounds": CLI_ROUNDS, "json_equal": same,
        "wall_s": walls}}))
    if not same:
        raise AssertionError("--shard-clients on one card wrote another JSON "
                             "than the unsharded CLI")
    return {"json_equal": same, "wall_s": walls}


# ------------------------------------------------------------ phase 9 ----
ROBUST_ROUNDS = 20
# label -> (scenario, solver_fallback): the timed, fault and defense paths
# at full width
ROBUST = {"straggler": ("straggler", False),
          "harvesting": ("harvesting", False),
          "churn": ("churn", False),
          "byzantine_lite": ("byzantine-lite", False),
          "byzantine_lite_fallback": ("byzantine-lite", True)}
CKPT_DIR = HERE / "build" / "chip_smoke" / "ckpt"


def robust_trainer(dev, scenario, fallback=False, mesh=None):
    """``paper_trainer`` of a scenario, with the solver's fallback guard on
    when asked (set on the controller's config before its first round)."""
    import dataclasses
    tr = paper_trainer(dev, scenario=scenario, mesh=mesh)
    if fallback:
        tr.fe_cfg = dataclasses.replace(tr.fe_cfg, solver_fallback=True)
        tr.controller.fe_cfg = dataclasses.replace(tr.controller.fe_cfg,
                                                   solver_fallback=True)
    return tr


def robust_path(dev, label: str, main_epr: float, profile: bool = False) -> dict:
    """One scenario's ``ROBUST_ROUNDS`` rounds at full width (N = 50, D =
    1,630,090), its launch counts zeroed just before and read just after:
    the fused ascent once a round and no other dual-solve launch, the top-k
    rows once a round, the norms once a round plus once a round where the
    defended aggregator clips (and once for eta_auto's calibration). Logs the steady round, peak memory, the
    timed and fault totals and the energy a round against the main
    path's."""
    scenario, fallback = ROBUST[label]
    t0 = time.perf_counter()
    tr = robust_trainer(dev, scenario, fallback)
    setup_s = time.perf_counter() - t0
    fns = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    tr.run_scanned(ROBUST_ROUNDS, verbose=False)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    rounds = ROBUST_ROUNDS
    clipped = tr.defense_cfg is not None and tr.defense_cfg.clip_q > 0.0
    # the norms: the round's u_norms, the clip's (defended) and once for
    # the eta_auto calibration's client step before round 0
    want = {"dual_ascent": rounds, "topk_rows": rounds,
            "row_sq_sum": rounds * (2 if clipped else 1) + 1}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"phase 9 {label}: launches {got}, want {want}")
    h = tr.history
    if not all(bool(torch.isfinite(p).all()) for p in tr.params.values()):
        raise AssertionError(f"phase 9 {label}: non-finite params")
    if not all(np.isfinite(lg.energy).all() and np.isfinite(lg.accuracy)
               for lg in h):
        raise AssertionError(f"phase 9 {label}: non-finite energy or accuracy")
    total = lambda k: (None if getattr(h[0], k) is None  # noqa: E731
                       else sum(getattr(lg, k) for lg in h))
    totals = {k: total(k) for k in ("n_late", "n_stale", "n_faulted",
                                    "n_rejected", "clip_frac", "fallback")}
    # what shows the path ran: stragglers, crashes, rejected payloads
    need = {"straggler": "n_late", "churn": "n_faulted",
            "byzantine_lite": "n_rejected"}.get(label)
    if need and not totals[need]:
        raise AssertionError(f"phase 9 {label}: no {need} in {rounds} rounds")
    if label == "harvesting" and not any(
            (b.battery > a.battery).any() for a, b in zip(h, h[1:])):
        raise AssertionError("phase 9 harvesting: no battery recharged")
    steady = [lg.wall_s for lg in h[1:]]
    epr = float(np.mean([lg.total_energy for lg in h]))
    line = {"label": label, "scenario": scenario, "solver_fallback": fallback,
            "rounds": rounds, "n_clients": tr.n_clients, "d": tr.n_params,
            "deadline_s": tr.deadline_s, "setup_s": setup_s,
            "round_ms_first": h[0].wall_s * 1e3,
            "round_ms_steady_mean": 1e3 * sum(steady) / len(steady),
            "rounds_per_s_steady": len(steady) / sum(steady),
            "peak_mem_GB": peak / 1e9,
            "stale_buffer_GB": (None if tr.carry.astate is None else
                                tr.carry.astate.buf.numel() * 4 / 1e9),
            "launches": got, "totals": totals,
            "simulated_time_s": tr.simulated_time(),
            "energy_per_round_J": epr,
            "main_path_energy_per_round_J": main_epr,
            "energy_vs_main_path": epr / main_epr,
            "final_accuracy": h[-1].accuracy}
    log(json.dumps({"robust_path": line}))
    if profile:
        profile_round(tr, rounds, label)
    return line


def checkpoint_on_card(dev) -> dict:
    """The straggler scenario (its stale buffer in the carry) for 10 rounds
    with ``chunk=5`` and a checkpoint after every chunk; a fresh trainer
    restored from the round-5 checkpoint continues: masks, made and
    energies equal, params equal bit for bit; ``verify_checkpoint``
    passes the file and rejects a copy with one flipped byte."""
    import shutil

    from repro_torch.checkpoint import verify_checkpoint
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    a = robust_trainer(dev, "straggler")
    t0 = time.perf_counter()
    a.run_scanned(10, chunk=5, ckpt_dir=str(CKPT_DIR), ckpt_every=1,
                  verbose=False)
    run_s = time.perf_counter() - t0
    mid = CKPT_DIR / "ckpt_00000005.npz"
    b = robust_trainer(dev, "straggler")
    t0 = time.perf_counter()
    nxt = b.restore_checkpoint(str(mid))
    restore_s = time.perf_counter() - t0
    if nxt != 5:
        raise AssertionError(f"the checkpoint resumes at {nxt}, not 5")
    b.run_scanned(10, chunk=5, start_round=5, verbose=False)
    for la, lb in zip(a.history[5:], b.history):
        if not (np.array_equal(la.selected, lb.selected)
                and np.array_equal(la.made, lb.made)
                and np.array_equal(la.energy, lb.energy)
                and la.t_round == lb.t_round and la.n_stale == lb.n_stale):
            raise AssertionError(f"restored round {lb.round} differs")
    differ = [k for k in a.params if not torch.equal(a.params[k], b.params[k])]
    if differ:
        raise AssertionError(f"restored params differ in {differ}")
    raw = bytearray(mid.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    flipped = CKPT_DIR / "flipped.npz"
    flipped.write_bytes(bytes(raw))
    if not verify_checkpoint(str(mid)) or verify_checkpoint(str(flipped)):
        raise AssertionError("verify_checkpoint did not tell the flipped "
                             "copy from the checkpoint")
    res = {"rounds": 10, "resumed_at": nxt, "file_MB": mid.stat().st_size / 1e6,
           "run_with_checkpoints_s": run_s, "restore_s": restore_s,
           "n_stale_after_resume": sum(lg.n_stale for lg in b.history),
           "params_bitwise_equal": True, "flipped_copy_rejected": True}
    log(json.dumps({"checkpoint_on_card": res}))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return res


def robust_rounds(dev, main: dict, profile: bool = False) -> dict:
    """Phase 9: each ``ROBUST`` path at full width (``profile``: and a
    torch.profiler round of each), then the checkpoint on the card.
    Returns the paths' lines by label."""
    main_epr = float(np.mean([lg.total_energy for lg in main["history"]]))
    lines = {label: robust_path(dev, label, main_epr, profile)
             for label in ROBUST}
    checkpoint_on_card(dev)
    return lines


# ----------------------------------------------------------- phase 10 ----
POP_ROUNDS = 20          # (a) and (b)
POP_CKPT_AT = 5
POP_N, POP_TRAIN, POP_POP_ROUNDS = 1000, 60_000, 10      # (c)
DECIDE_N = (50, 10_000, 100_000)                         # (d)
DECIDE_POOL, DECIDE_CLUSTERS, DECIDE_STEPS = 512, 8, 10


def record_ascent_sizes() -> tuple[list, callable]:
    """Wrap the solver's fused dual ascent (``core.fairenergy.dual_ascent``,
    in this script only) to record the client count of each call; returns
    the list and the function that restores the original. The wrapper's
    own launch count is untouched."""
    from repro_torch.core import fairenergy
    orig, sizes = fairenergy.dual_ascent, []

    def recording(P, *args, **kw):
        sizes.append(int(P.shape[0]))
        return orig(P, *args, **kw)
    fairenergy.dual_ascent = recording
    return sizes, lambda: setattr(fairenergy, "dual_ascent", orig)


@contextlib.contextmanager
def captured(module, name: str):
    """``module.name`` wrapped for the block (in this script only): the
    arguments of its last call, tensors cloned, land in the yielded dict
    as ``args`` and ``kw``. The wrapper's own launch count is untouched."""
    orig, got = getattr(module, name), {}
    keep = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731

    def recording(*args, **kw):
        got["args"] = tuple(keep(a) for a in args)
        got["kw"] = {k: keep(v) for k, v in kw.items()}
        return orig(*args, **kw)
    setattr(module, name, recording)
    try:
        yield got
    finally:
        setattr(module, name, orig)


# rows of the [N, D] matrix a call of a plain version takes in
# hold_round_kernels (its temporaries are several times the slice)
PLAIN_ROWS = 100


def hold_round_kernels(dev, tr, r: int, label: str) -> dict:
    """One more round (``r``) of trainer ``tr`` with the inputs of its fused
    ascent, its top-k rows and its norms captured, and each kernel held
    against its plain version on them: the ascent as phase 2 holds it
    (``hold_ascent``), the top-k rows bit for bit and the norms to rtol
    1e-6 on the whole ``[N, D]`` update matrix (each kernel launched once
    on all of it; the plain version, whose rows are independent, on
    ``PLAIN_ROWS`` rows a call)."""
    from repro_torch.core import fairenergy
    from repro_torch.fl import client, compression
    from repro_torch.kernels.score_norm import ops as norm_ops
    from repro_torch.kernels.score_norm import ref as norm_ref
    from repro_torch.kernels.topk_sparsify import ops as topk_ops
    from repro_torch.kernels.topk_sparsify import ref as topk_ref
    with captured(fairenergy, "dual_ascent") as asc, \
            captured(compression, "block_topk_rows") as rows, \
            captured(client, "row_l2_norms") as norms:
        tr.run_round(r)
    a_err, r_err, iters = hold_ascent(asc["args"], asc["kw"],
                                      f"phase 10 {label} round {r} ascent")
    mat, ks = rows["args"]
    got = topk_ops.block_topk_rows(mat, ks)
    for i in range(0, mat.shape[0], PLAIN_ROWS):
        sl = slice(i, i + PLAIN_ROWS)
        want = topk_ref.block_topk_rows(mat[sl], ks[sl])
        if not same_bits(got[sl], want):
            raise AssertionError(
                f"phase 10 {label}: top-k rows differ from the plain version "
                f"in rows {i}-{i + PLAIN_ROWS}:\n"
                f"{diff_report(got[sl], want, ks[sl])}")
    del got, mat
    (upd,) = norms["args"]
    got = norm_ops.row_l2_norms(upd)
    want = torch.cat([norm_ref.row_l2_norms_ref(upd[i:i + PLAIN_ROWS],
                                                norm_ops.BLOCK)
                      for i in range(0, upd.shape[0], PLAIN_ROWS)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                               msg=lambda m: f"phase 10 {label} norms: {m}")
    held = {"ascent_clients": int(asc["args"][0].shape[0]),
            "ascent_n_inner": iters, "ascent_max_abs_err": a_err,
            "ascent_res_max_rel_err": r_err,
            "topk_rows_shape": list(upd.shape), "topk_rows_bit_identical": True,
            "row_norms_max_abs_err": float((got - want).abs().max())}
    log(json.dumps({"phase10_kernels_held": label, **held}))
    return held


def kernel_launch_ms(fn, kernel: str) -> float:
    """Mean device ms of a launch of the kernels whose name holds
    ``kernel`` while ``fn()`` runs (torch.profiler's CUDA activity). The
    profiler has been seen to miss a session's launch of a kernel (see
    device_ms), so the mean is over the launches it saw, of which there
    must be one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in seen)
    if count < 1:
        raise AssertionError(f"the profiler saw no launch of {kernel}")
    return sum(e.self_device_time_total for e in seen) / 1e3 / count


def population_run(dev, label: str, rounds: int, k_pool: int, *,
                   ckpt_dir=None, **build_kw) -> dict:
    """The paper recipe (``experiments.build``) at full CNN width for
    ``rounds`` rounds with its launch counts zeroed just before and read
    just after: one fused ascent a round, of ``k_pool`` clients, the top-k
    rows once a round and the norms once a round plus the calibration;
    finite params and energies, at most ``k_pool`` selected a round.
    Returns the trainer, its launches, pools, steady round ms and peak
    memory."""
    from repro_torch.launch.experiments import build
    t0 = time.perf_counter()
    make, _ = build(rounds=rounds, seed=0, device=dev, **build_kw)
    tr = make("fairenergy")
    setup_s = time.perf_counter() - t0
    pools = record_pools(tr)
    sizes, restore = record_ascent_sizes()
    fns = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    try:
        tr.run_scanned(rounds, verbose=False,
                       **({} if ckpt_dir is None else
                          dict(chunk=POP_CKPT_AT, ckpt_dir=str(ckpt_dir))))
    finally:
        restore()
    launches = {k: v for k, v in ((n, getattr(fn, a)) for n, (fn, a)
                                  in fns.items()) if v}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"dual_ascent": rounds, "topk_rows": rounds,
            "row_sq_sum": rounds + 1}
    if launches != want or sizes != [k_pool] * rounds:
        raise AssertionError(f"phase 10 {label}: launches {launches} (want "
                             f"{want}), ascent sizes {sorted(set(sizes))} "
                             f"(want {k_pool})")
    h = tr.history
    if not all(bool(torch.isfinite(p).all()) for p in tr.params.values()):
        raise AssertionError(f"phase 10 {label}: non-finite params")
    if not all(np.isfinite(lg.energy).all() for lg in h):
        raise AssertionError(f"phase 10 {label}: non-finite energies")
    selected = [lg.n_selected for lg in h]
    if max(selected) > k_pool or not any(selected):
        raise AssertionError(f"phase 10 {label}: selections {selected} for "
                             f"a pool of {k_pool}")
    steady = [lg.wall_s for lg in h[1:]]
    return dict(trainer=tr, pools=pools, launches=launches, setup_s=setup_s,
                steady_ms=1e3 * sum(steady) / len(steady), peak_GB=peak / 1e9,
                energy_per_round_J=float(np.mean([lg.total_energy
                                                  for lg in h])),
                final_accuracy=h[-1].accuracy)


def population_paths(dev, main: dict) -> dict:
    """Phase 10: the hierarchy and mobility at full CNN width. (a) the
    mobility scenario at N = 50; (b) clusters 4, pool_frac 0.25 at N = 50
    (K_pool 12), checkpointed at round 5 and resumed: pools, masks and
    params bit for bit; (c) N = 1,000 over 60,000 images, clusters 4,
    pool_frac 0.25 (K_pool 250), against the same recipe solving the full
    population: round ms, peak memory, the ascent's device ms, every
    cluster in every pool, final accuracy, and each kernel of one round
    held against its plain version (``hold_round_kernels``); (d) the
    decide alone on the hierarchy bench's synthetic channel statistics,
    each arm's ascent held against its plain version."""
    import shutil
    main_epr = float(np.mean([lg.total_energy for lg in main["history"]]))
    out = {}
    # (a) mobility
    a = population_run(dev, "a_mobility", POP_ROUNDS, N_CLIENTS,
                       n_clients=N_CLIENTS, scenario="mobility")
    out["a_mobility"] = {
        "rounds": POP_ROUNDS, "n_clients": N_CLIENTS, "sigma_db":
        a["trainer"].mobility.sigma_db, "launches": a["launches"],
        "round_ms_steady_mean": a["steady_ms"], "peak_mem_GB": a["peak_GB"],
        "energy_per_round_J": a["energy_per_round_J"],
        "main_path_energy_per_round_J": main_epr,
        "energy_vs_main_path": a["energy_per_round_J"] / main_epr,
        "final_accuracy": a["final_accuracy"]}
    log(json.dumps({"population_path": out["a_mobility"]}))
    del a
    # (b) the sampled path at N = 50, checkpointed and resumed
    from repro_torch.core.hierarchy import HierarchyConfig
    ckpt = HERE / "build" / "chip_smoke" / "ckpt_hier"
    shutil.rmtree(ckpt, ignore_errors=True)
    hier = dict(clusters=4, pool_frac=0.25)
    k_b = HierarchyConfig(**hier).resolve_pool(N_CLIENTS)
    hier["n_clients"] = N_CLIENTS
    b = population_run(dev, "b_hierarchy", POP_ROUNDS, k_b, ckpt_dir=ckpt,
                       **hier)
    from repro_torch.launch.experiments import build
    make, _ = build(rounds=POP_ROUNDS, seed=0, device=dev, **hier)
    resumed = make("fairenergy")
    nxt = resumed.restore_checkpoint(str(ckpt / f"ckpt_{POP_CKPT_AT:08d}.npz"))
    rpools = record_pools(resumed)
    resumed.run_scanned(POP_ROUNDS, chunk=POP_CKPT_AT, start_round=nxt,
                        verbose=False)
    tb = b["trainer"]
    same = (nxt == POP_CKPT_AT
            and all(torch.equal(x, y)
                    for x, y in zip(b["pools"][nxt:], rpools))
            and len(rpools) == POP_ROUNDS - nxt
            and all(np.array_equal(x.selected, y.selected)
                    and np.array_equal(x.energy, y.energy)
                    for x, y in zip(tb.history[nxt:], resumed.history))
            and all(torch.equal(tb.params[k], resumed.params[k])
                    for k in tb.params)
            and torch.equal(tb.ctrl_state.assign, resumed.ctrl_state.assign))
    out["b_hierarchy"] = {
        "rounds": POP_ROUNDS, "n_clients": N_CLIENTS, "k_pool": k_b,
        "clusters": 4, "launches": b["launches"],
        "round_ms_steady_mean": b["steady_ms"], "peak_mem_GB": b["peak_GB"],
        "energy_per_round_J": b["energy_per_round_J"],
        "energy_vs_main_path": b["energy_per_round_J"] / main_epr,
        "final_accuracy": b["final_accuracy"], "resumed_at": nxt,
        "resumed_bit_for_bit": same}
    log(json.dumps({"population_path": out["b_hierarchy"]}))
    shutil.rmtree(ckpt, ignore_errors=True)
    if not same:
        raise AssertionError("phase 10 (b): the resumed run differs")
    del b, resumed, tb
    # (c) the population: N = 1,000 sampled against the full solve
    runs = {}
    pooled = dict(clusters=4, pool_frac=0.25)
    for mode, kw, k_pool in (
            ("pooled", pooled, HierarchyConfig(**pooled).resolve_pool(POP_N)),
            ("full", {}, POP_N)):
        run = population_run(dev, f"c_{mode}", POP_POP_ROUNDS, k_pool,
                             n_clients=POP_N, n_train=POP_TRAIN, **kw)
        tr = run.pop("trainer")
        run["kernels_held"] = hold_round_kernels(dev, tr, POP_POP_ROUNDS,
                                                 f"c_{mode}")
        torch.cuda.empty_cache()
        run["ascent_device_ms"] = kernel_launch_ms(
            lambda: [tr.run_round(POP_POP_ROUNDS + 1 + i) for i in range(3)],
            "dual_ascent_kernel")
        if mode == "pooled":
            assign = tr.ctrl_state.assign.cpu()
            covered = [len(set(assign[p].tolist())) for p in run["pools"]]
            if min(covered) != 4:
                raise AssertionError(f"phase 10 (c): a pool missed a cluster: "
                                     f"{covered}")
            run["clusters_in_every_pool"] = True
            run["cluster_sizes"] = torch.bincount(assign.long()).tolist()
        run.pop("pools")
        runs[mode] = run
        del tr
        torch.cuda.empty_cache()
    out["c_population"] = {"n_clients": POP_N, "n_train": POP_TRAIN,
                           "rounds": POP_POP_ROUNDS, **runs,
                           "ascent_pooled_over_full": (
                               runs["pooled"]["ascent_device_ms"]
                               / runs["full"]["ascent_device_ms"]),
                           "round_pooled_over_full": (
                               runs["pooled"]["steady_ms"]
                               / runs["full"]["steady_ms"])}
    log(json.dumps({"population_path": out["c_population"]}))
    # (d) decide latency
    out["d_decide"] = [decide_latency(dev, n) for n in DECIDE_N]
    return out


def decide_latency(dev, n: int) -> dict:
    """ms a decide, full against pooled (``pool_size`` 512, clusters 8 at
    N >= 64, as ``benchmarks/hierarchy_bench.py``'s arms) on its synthetic
    channel statistics, over ``DECIDE_STEPS`` decides after one warm-up
    decide, each decide's state carried into the next, the fused
    ascent's device ms a decide (torch.profiler), and the ascent of one
    more decide held against its plain version (``hold_ascent``)."""
    from repro_torch import random as prng
    from repro_torch.configs import FairEnergyConfig
    from repro_torch.core import fairenergy
    from repro_torch.core.controllers import (
        ControllerContext, RoundObservation, make_controller)
    from repro_torch.core.hierarchy import HierarchyConfig, wrap_controller

    rng = np.random.default_rng(0)
    ctx = ControllerContext(n_clients=n, b_tot=10e6, s_bits=6.4e7, i_bits=2e6,
                            n0=4e-21, device=dev,
                            fe_cfg=FairEnergyConfig(eta=1e-3, eta_auto=False))
    pathloss, power = rng.uniform(1e-9, 1e-7, n), rng.uniform(0.1, 1.0, n)
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.uniform(0.1, 2.0, n), dtype=torch.float32, device=dev)
    h = torch.tensor(pathloss * rng.exponential(1.0, n), dtype=torch.float32,
                     device=dev)
    P = torch.tensor(power, dtype=torch.float32, device=dev)
    base = prng.PRNGKey(3)
    res = {"n_clients": n}
    for mode in ("full", "pooled"):
        ctrl = make_controller("fairenergy", ctx)
        if mode == "pooled":
            cfg = HierarchyConfig(clusters=DECIDE_CLUSTERS if n >= 64 else 1,
                                  pool_size=min(DECIDE_POOL, n))
            ctrl = wrap_controller(ctrl, cfg, ctx, pathloss=pathloss,
                                   power=power, base_key=prng.PRNGKey(17),
                                   seed=0)
        state = ctrl.init(n)

        def decide(r, state):
            obs = RoundObservation(u_norms=u, h=h, P=P, round=r,
                                   key=prng.fold_in(base, r))
            dec, state = ctrl.decide(obs, state)
            return int(dec.x.sum()), state

        _, state = decide(0, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(1, DECIDE_STEPS + 1):
            sel, state = decide(r, state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DECIDE_STEPS
        asc = kernel_launch_ms(
            lambda: [decide(DECIDE_STEPS + 1 + r, state) for r in range(3)],
            "dual_ascent_kernel")
        # the ascent of one more decide held against its plain version
        with captured(fairenergy, "dual_ascent") as got:
            decide(DECIDE_STEPS + 4, state)
        k = int(got["args"][0].shape[0])
        a_err, r_err, iters = hold_ascent(
            got["args"], got["kw"], f"phase 10 (d) N={n} {mode} ascent")
        res[mode] = {"k": k, "ms_per_decide": ms, "ascent_device_ms": asc,
                     "selected_last": sel, "ascent_held": {
                         "n_inner": iters, "max_abs_err": a_err,
                         "res_max_rel_err": r_err}}
    res["pooled_speedup"] = (res["full"]["ms_per_decide"]
                             / res["pooled"]["ms_per_decide"])
    log(json.dumps({"decide_latency": res}))
    return res


# ------------------------------------------------------------ phase 5 ----
SERVE = dict(arch="tinyllama-1.1b", prompt_len=2048, gen=32, batch=4)
# the first decode step's logits against lm_forward at that position: both
# run the bf16 model, one through the flash kernel over 2049 positions, the
# other through the ring cache and the direct decode (bf16 probabilities),
# with GEMMs of other shapes. bf16 keeps 8 significant bits (2^-9 relative
# a rounding); 22 layers round the residual stream twice each, so the final
# hidden state may drift by a few percent of its scale, which the fp32 head
# carries into the logits: the bound is 5% of the largest logit.
SERVE_REL_TOL = 0.05


def serve_path(dev, profile: bool = False, dtype: str | None = None) -> dict:
    """Phase 5: generate() at TinyLlama-1.1B's full width on the card (in
    ``dtype`` instead of the config's bf16 where given: phase 17 (d), whose
    attribution prefill also holds every flash launch against
    ``attention_ref`` on the same inputs, within the 16-bit gate, 2e-2 of
    the output's scale (at least 1))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tfm

    cfg = get_config(SERVE["arch"])
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    kname = FLASH_KERNEL[cfg.dtype]
    t0 = time.perf_counter()
    master = steps.init_for(cfg)(torch.Generator(device=dev).manual_seed(0))
    model = tfm.for_compute(master, cfg)       # the bf16 serving copy, made once
    del master
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {cfg.name} {n_params / 1e9:.3f}B params, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(prompt_len=SERVE["prompt_len"], gen=SERVE["gen"], batch=SERVE["batch"],
              temperature=1.0, seed=0, device=dev)
    serve.generate(cfg, model, **kw)                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fns = counters()
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    out = serve.generate(cfg, model, **kw)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    B, P, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    if launches[kname] != cfg.n_layers:
        raise AssertionError(f"serve launched the flash kernel "
                             f"{launches[kname]} times, not {cfg.n_layers}")
    others = {n: c for n, c in launches.items() if n != kname and c}
    if others:
        raise AssertionError(f"serve launched other kernels: {others}")
    if tuple(out.ids.shape) != (B, 1 + G) or tuple(out.prompt.shape) != (B, P):
        raise AssertionError(f"ids {tuple(out.ids.shape)}, prompt {tuple(out.prompt.shape)}")
    if not (0 <= int(out.ids.min()) and int(out.ids.max()) < cfg.vocab_size):
        raise AssertionError("sampled ids outside the vocabulary")
    logits = [out.first_logits, *out.decode_logits]
    if not all(bool(torch.isfinite(lg).all()) for lg in logits):
        raise AssertionError("non-finite serve logits")

    # attribution: the prefill launches one kernel a layer, a decode step
    # none; each of the prefill's launches against the plain version
    held = []
    launch = ops.flash_attention_cuda

    def holding(q, k, v, **kw):
        got = launch(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, causal=kw.get("causal", True),
                                 window=kw.get("window"))
        err = float(((got[0] if isinstance(got, tuple) else got).float()
                     - want.float()).abs().max())
        held.append(err / max(1.0, float(want.abs().max())))
        return got

    with torch.no_grad():
        flash_attention.launches = 0
        if dtype is not None:
            ops.flash_attention_cuda = holding
        try:
            _, cache = tfm.lm_prefill(model, out.prompt.to(dev), cfg, cache_len=P + G)
        finally:
            ops.flash_attention_cuda = launch
        n_prefill = flash_attention.launches
        if dtype is not None and (len(held) != n_prefill
                                  or not max(held) <= FLASH_ATOL[torch.bfloat16]):
            raise AssertionError(f"serve {cfg.dtype}: {n_prefill} flash launches, "
                                 f"{len(held)} held, errors over scale {held}")
        flash_attention.launches = 0
        tfm.lm_decode(model, out.ids[:, :1].to(dev), cache, P, cfg)
        n_decode = flash_attention.launches
        del cache
        if (n_prefill, n_decode) != (cfg.n_layers, 0):
            raise AssertionError(f"flash launches: prefill {n_prefill}, decode {n_decode}")
        # the first decode step (token ids[:, 0] at position P) against the
        # full forward over prompt + that token
        toks = torch.cat([out.prompt, out.ids[:, :1]], dim=1).to(dev)
        full, _ = tfm.lm_forward(model, toks, cfg)
        want = full[:, P]
        del full
    diff = float((out.decode_logits[0] - want).abs().max())
    scale = float(want.abs().max())
    agree = float((out.decode_logits[0].argmax(-1) == want.argmax(-1)).float().mean())
    if not diff <= SERVE_REL_TOL * scale:
        raise AssertionError(f"first decode logits differ from lm_forward by {diff} "
                             f"> {SERVE_REL_TOL} x {scale}")
    summary = {"serve": cfg.name, "prompt_len": P, "gen": G, "batch": B,
               "dtype": cfg.dtype, "prefill_ms": out.prefill_s * 1e3,
               "decode_ms_per_step": out.decode_s * 1e3 / G,
               "decode_tokens_per_s": G * B / out.decode_s,
               "prefill_tokens_per_s": P * B / out.prefill_s,
               "peak_mem_GB": peak / 1e9, "launches": launches,
               "flash_launches_prefill": n_prefill, "flash_launches_decode_step": n_decode,
               "first_decode_vs_forward_max_abs": diff, "logit_scale": scale,
               "first_decode_vs_forward_argmax_agree": agree,
               "flash_launches_held_err_over_scale": max(held, default=None),
               "ids_first_request": out.ids[0, :16].tolist()}
    log(json.dumps({"serve_summary": summary}))
    if profile:
        profile_serve(model, cfg, dev)
    return summary


def profile_serve(model, cfg, dev, batch=None, prompt_len=None, gen=None):
    """torch.profiler over one more prefill and one decode step at the serve
    shapes (phase 5's unless given): device time by kernel and the device's
    busy share of each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm
    B = batch or SERVE["batch"]
    P, G = prompt_len or SERVE["prompt_len"], gen or SERVE["gen"]
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(9))
    with torch.no_grad():
        _, cache = tfm.lm_prefill(model, prompt, cfg, cache_len=P + G)
        tok = prompt[:, -1:]
        tfm.lm_decode(model, tok, cache, P, cfg)
        for label, fn in (("prefill", lambda: tfm.lm_prefill(model, prompt, cfg,
                                                              cache_len=P + G)),
                          ("decode_step", lambda: tfm.lm_decode(model, tok, cache,
                                                                 P + 1, cfg))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) is not None
                      and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
            busy_us = sum(e.self_device_time_total for e in events)
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
            log(json.dumps({"profile_serve": label, "model": cfg.name,
                            "wall_ms": wall * 1e3,
                            "device_busy_ms": busy_us / 1e3,
                            "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
                            "kernel_launches": sum(e.count for e in events),
                            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                                             "ms": e.self_device_time_total / 1e3}
                                            for e in top]}))


# ----------------------------------------------------------- phase 5b ----
# the fp32 prefill against the same prefill through the plain attention:
# both run fp32 GEMMs of the same shapes, and the two attentions agree to
# ~1e-6 (phase 2), which 22 layers carry into the logits
PREFILL_F32_REL_TOL = 1e-4


def serve_prefill_f32(dev, kernel_ms: float) -> dict:
    """Phase 5b: ``lm_prefill`` of TinyLlama-1.1B at full width in fp32
    (22 layers, d 2048, seeded random weights on the card), 4 prompts of
    2048 ids, once to warm up and once timed: 22 launches of the fp32 flash
    kernel and nothing else, finite last-position logits within
    PREFILL_F32_REL_TOL of their scale of the same prefill with the
    attention patched (here only) to the plain version. ``kernel_ms`` is
    phase 2's time of the fp32 kernel at this call's shape: the flash
    share of the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.launch import steps
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    cfg = get_config(SERVE["arch"]).replace(dtype="float32")
    model = tfm.for_compute(steps.init_for(cfg)(
        torch.Generator(device=dev).manual_seed(0)), cfg)
    B, P = SERVE["batch"], SERVE["prompt_len"]
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    with torch.no_grad():
        tfm.lm_prefill(model, prompt, cfg, cache_len=P)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fns = counters()
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        logits, _ = tfm.lm_prefill(model, prompt, cfg, cache_len=P)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        kernel = attention.flash_attention
        attention.flash_attention = ref.attention_ref
        try:
            t0 = time.perf_counter()
            want, _ = tfm.lm_prefill(model, prompt, cfg, cache_len=P)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        finally:
            attention.flash_attention = kernel
    if launches["flash_attention_f32"] != cfg.n_layers:
        raise AssertionError(f"the fp32 prefill launched the fp32 flash kernel "
                             f"{launches['flash_attention_f32']} times, not "
                             f"{cfg.n_layers}")
    others = {n: c for n, c in launches.items() if n != "flash_attention_f32" and c}
    if others:
        raise AssertionError(f"the fp32 prefill launched other kernels: {others}")
    if tuple(logits.shape) != (B, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"fp32 prefill logits {tuple(logits.shape)}, "
                             "or not finite")
    diff = float((logits - want).abs().max())
    scale = float(want.abs().max())
    if not diff <= PREFILL_F32_REL_TOL * scale:
        raise AssertionError(f"fp32 prefill logits differ from the plain "
                             f"attention's by {diff} > {PREFILL_F32_REL_TOL} x {scale}")
    res = {"prefill_f32": cfg.name, "batch": B, "prompt_len": P,
           "layers": cfg.n_layers, "prefill_ms": prefill_ms,
           "plain_attention_prefill_ms": plain_ms,
           "flash_ms_at_phase2": cfg.n_layers * kernel_ms,
           "flash_share": cfg.n_layers * kernel_ms / prefill_ms,
           "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
           "peak_mem_GB": peak / 1e9, "launches": launches,
           "logits_max_abs": diff, "logit_scale": scale}
    log(json.dumps(res))
    return res


# ------------------------------------------------------------ phase 6 ----
def _first_tie(ids_a, ids_b, steps_logits, gen_seed: int, temperature: float,
               rtol: float = 1e-4, atol: float = 1e-5):
    """The first column where two id matrices differ (None if equal), and
    whether, in every request that differs there, the CPU's top two
    perturbed logits lie within the logits' tolerance (a documented tie)."""
    from repro_torch import random as prng
    cols = torch.nonzero((ids_a != ids_b).any(dim=0)).flatten().tolist()
    if not cols:
        return None, True
    c = cols[0]
    rows = ids_a[:, c] != ids_b[:, c]
    z = steps_logits[c].cpu()
    if c > 0:                         # sampled: the same key chain as generate
        key = prng.PRNGKey(gen_seed)
        for _ in range(c):
            key, sk = prng.split(key)
        z = prng.gumbel(sk, tuple(z.shape)) + z / temperature
    top2 = torch.topk(z, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).abs()
    tie = bool((gap <= rtol * top2[:, 0].abs() + atol)[rows].all())
    return c, tie


def serve_card_against_cpu(dev, dtype: str = "float32") -> dict:
    """Phase 6: the smoke TinyLlama in ``dtype``, prompt 2048, 8 tokens,
    batch 2, on the card and on the CPU from the same weights and seed.
    fp32 takes the card's SIMT flash kernel, bf16 the tensor-core one (C-13).
    Logits agree to rtol 1e-4 in fp32, and in bf16 to phase 5's 5% of the
    logit scale (bf16 rounds at other places on the two devices, C-10); a
    documented tie is a top-two gap within that tolerance."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve, steps

    cfg = get_smoke(SERVE["arch"]).replace(dtype=dtype)
    cpu_model = steps.init_for(cfg)(torch.Generator().manual_seed(1))
    card_model = copy.deepcopy(cpu_model).to(dev)
    kw = dict(prompt_len=2048, gen=8, batch=2, temperature=1.0, seed=3)
    counter = FLASH_COUNTER[dtype]
    flash_attention.launches = 0
    setattr(flash_attention, counter, 0)
    got = serve.generate(cfg, card_model, **kw, device=dev)
    n_kernel = getattr(flash_attention, counter)
    if (flash_attention.launches, n_kernel) != (cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"the card's smoke prefill launched the flash kernels "
                             f"{flash_attention.launches} times, the {dtype} one "
                             f"{n_kernel}")
    want = serve.generate(cfg, cpu_model, **kw, device="cpu")
    if not torch.equal(got.prompt, want.prompt):
        raise AssertionError("prompt ids differ between card and CPU")
    got_l = [got.first_logits.float(), *(lg.float() for lg in got.decode_logits)]
    want_l = [want.first_logits.float(), *(lg.float() for lg in want.decode_logits)]
    if dtype == "float32":
        rtol, atol = 1e-4, 1e-5
    else:
        rtol, atol = 0.0, SERVE_REL_TOL * float(want_l[0].abs().max())
    col, tie = _first_tie(got.ids, want.ids, want_l, kw["seed"], kw["temperature"],
                          rtol, atol)
    if col is not None and not tie:
        raise AssertionError(f"sampled ids differ at step {col} without a tie:\n"
                             f"cuda {got.ids.tolist()}\ncpu {want.ids.tolist()}")
    # logits agree while both runs saw the same tokens
    n_same = len(got_l) if col is None else col + 1
    err = scale = 0.0
    for a, b in zip(got_l[:n_same], want_l[:n_same]):
        torch.testing.assert_close(a.cpu(), b, rtol=rtol, atol=max(atol, 1e-5))
        err = max(err, float((a.cpu() - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    res = {"serve_card_vs_cpu": cfg.name, "dtype": cfg.dtype, "prompt_len": 2048,
           "gen": 8, "batch": 2, "ids_equal": col is None, "first_diff_step": col,
           "tie_at_first_diff": tie if col is not None else None,
           "steps_compared": n_same, "logits_max_abs": err, "logit_scale": scale,
           "logits_atol": atol, "flash_launches": n_kernel,
           "ids_cuda": got.ids.tolist(), "ids_cpu": want.ids.tolist()}
    log(json.dumps(res))
    return res


# ----------------------------------------------------------- phase 12 ----
# arch -> (config cut, batch, prompt, new tokens, flash launches a prefill):
# full width; mixtral's 56 layers (282 GB in bf16) cut to 4 (~20 GB), one
# prompt of 8,192 ids so that its 4,096-token window bites on the flash
# branch
FAMILIES = {
    "qwen2-moe-a2.7b": ({}, 4, 2048, 32, 24),
    "mixtral-8x22b": ({"n_layers": 4}, 1, 8192, 16, 4),
    "rwkv6-1.6b": ({}, 4, 2048, 32, 0),
    "zamba2-2.7b": ({}, 4, 2048, 32, 9),
}


def _chunk_unit(cfg) -> int:
    """The forward's sequence must be a multiple of this: the MoE group,
    RWKV6's chunk (128) or the Mamba2 chunk."""
    return {"moe": cfg.moe_group, "ssm": 128, "hybrid": cfg.ssm_chunk}.get(cfg.family, 1)


def _served_copy(dev, cfg):
    """The seeded fp32 masters cast to the serving copy in place, and the
    set-up seconds."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tfm.for_compute(steps.init_for(cfg)(torch.Generator(device=dev).manual_seed(0)),
                            cfg, inplace=True)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serve_family(dev, arch: str, profile: bool = False) -> dict:
    """Phase 12, one family: ``serve.generate`` at full width (the serving
    copy cast in place from the seeded fp32 masters, so both are never on
    the card together), warmed up, then timed with the counts zeroed: the
    flash kernel once per attention layer of the prefill, never in a
    decode step, no other kernel; ids in the vocabulary, finite logits;
    the first decode step against ``lm_forward`` (SERVE_REL_TOL of its
    scale)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    cut, B, P, G, n_flash = FAMILIES[arch]
    cfg = get_config(arch).replace(**cut)
    model, setup_s = _served_copy(dev, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 12: {cfg.name} ({cfg.family}) {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f}B params, set-up {setup_s:.1f} s")
    kw = dict(prompt_len=P, batch=B, temperature=1.0, seed=0, device=dev)
    serve.generate(cfg, model, gen=2, **kw)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fns = counters()
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    out = serve.generate(cfg, model, gen=G, **kw)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["flash_attention"] != n_flash:
        raise AssertionError(f"phase 12 {arch}: the bf16 flash kernel launched "
                             f"{launches['flash_attention']} times, not {n_flash}")
    others = {n: c for n, c in launches.items() if n != "flash_attention" and c}
    if others:
        raise AssertionError(f"phase 12 {arch}: other kernels launched: {others}")
    if tuple(out.ids.shape) != (B, 1 + G):
        raise AssertionError(f"phase 12 {arch}: ids {tuple(out.ids.shape)}")
    if not (0 <= int(out.ids.min()) and int(out.ids.max()) < cfg.vocab_size):
        raise AssertionError(f"phase 12 {arch}: sampled ids outside the vocabulary")
    if not all(bool(torch.isfinite(lg).all())
               for lg in [out.first_logits, *out.decode_logits]):
        raise AssertionError(f"phase 12 {arch}: non-finite logits")

    # attribution, and the first decode step against the full forward. The
    # MoE's forward routes position P as the decode step did
    # (``pinned_routing``): in bf16 the two attention paths round apart,
    # which moves the router's probabilities by up to ~10% of themselves,
    # and among qwen2-moe's 60 experts the 4th and 5th often lie closer
    # than that, so an unpinned forward routes some layers' token at P to
    # another expert. Each routing the pin changes must be such a tie of
    # the forward's own probabilities, and none may move by PIN_TIE
    # (``routing_apart``). The MoE runs both at capacity 8, the JAX package's own recipe
    # (tests/test_decode.py): at the default capacity the forward's groups
    # of 512 tokens drop tokens that a decode step (a group of one) keeps,
    # so the two differ by design. The forward runs over the prompt, the
    # first sampled token and filler ids up to a whole number of groups or
    # chunks: causal attention and recurrences, and a dispatch that drops
    # nothing, leave position P unchanged by what follows it.
    # A decode step attends to every slot of its ring, so the ring holds a
    # sliding window's keys only when it has the window's size, as
    # steps.cache_len_for sizes it (generate's ring of P + G slots, the
    # reference's serve flow, decodes mixtral over every cached position).
    chk = cfg.replace(capacity_factor=8.0) if cfg.family == "moe" else cfg
    ring = min(P + G, cfg.sliding_window or P + G)
    with torch.no_grad():
        flash_attention.launches = 0
        _, cache = tfm.lm_prefill(model, out.prompt.to(dev), chk, cache_len=ring)
        n_prefill = flash_attention.launches
        flash_attention.launches = 0
        with recorded_routing() as rec_dec:
            step, _ = tfm.lm_decode(model, out.ids[:, :1].to(dev), cache, P, chk)
        n_decode = flash_attention.launches
        del cache
        if (n_prefill, n_decode) != (n_flash, 0):
            raise AssertionError(f"phase 12 {arch}: flash launches prefill "
                                 f"{n_prefill}, decode {n_decode}")
        unit = _chunk_unit(cfg)
        n = -(-(P + 1) // unit) * unit
        toks = torch.cat([out.prompt, out.ids[:, :1],
                          torch.zeros(B, n - P - 1, dtype=out.prompt.dtype)], dim=1)
        with pinned_routing([r["probs"] for r in rec_dec], P) as own:
            full, _ = tfm.lm_forward(model, toks.to(dev), chk)
        want = full[:, P]
        del full
    pinned = None
    if own:
        _, pinned = routing_apart(torch.stack(own), torch.stack(
            [r["probs"][:, -1] for r in rec_dec]), cfg.n_experts_per_tok,
            PIN_TIE, f"phase 12 {arch} decode against the forward")
    diff = float((step[:, -1] - want).abs().max())
    scale = float(want.abs().max())
    per_row = (step[:, -1] - want).abs().amax(-1).tolist()
    if not diff <= SERVE_REL_TOL * scale:
        raise AssertionError(f"phase 12 {arch}: the first decode step differs from "
                             f"lm_forward by {diff} > {SERVE_REL_TOL} x {scale} "
                             f"(rows {per_row})")
    res = {"serve_family": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "params_B": n_params / 1e9, "batch": B, "prompt_len": P, "gen": G,
           "setup_s": setup_s, "prefill_ms": out.prefill_s * 1e3,
           "decode_ms_per_step": out.decode_s * 1e3 / G,
           "decode_tokens_per_s": G * B / out.decode_s,
           "prefill_tokens_per_s": P * B / out.prefill_s,
           "peak_mem_GB": peak / 1e9, "launches": launches,
           "flash_launches_prefill": n_prefill, "flash_launches_decode_step": n_decode,
           "first_decode_vs_forward_max_abs": diff, "logit_scale": scale,
           "first_decode_vs_forward_by_row": per_row,
           "pinned_routing": pinned,
           "forward_len": n, "ids_first_request": out.ids[0, :16].tolist()}
    log(json.dumps({"phase12": res}))
    if profile:
        profile_serve(model, cfg, dev, B, P, G)
    del model, out, step, want
    torch.cuda.empty_cache()
    return res


def serve_families(dev, profile: bool = False) -> dict:
    """Phase 12: each family of FAMILIES served in turn, each model freed
    before the next."""
    return {arch: serve_family(dev, arch, profile) for arch in FAMILIES}


# ---------------------------------------------------------- phase 12b ----
# (absolute gap, share of the larger probability) within which two runs'
# router probabilities may move, and so order a token's experts apart
# (``routing_apart``): an fp tie in fp32 (1e-5; card and CPU moved them by
# at most 1.2e-6); in bf16 the devices round the hidden states apart (the
# card's flash kernel rounds the unnormalized P to bf16, the CPU's plain
# version the normalized one; their GEMMs round apart), which moved the
# smoke qwen2-moe's by at most 2.9% of themselves on an H100, so 5%
# (phase 5's rule)
ROUTING_TIE = {"float32": (1e-5, 0.0), "bfloat16": (0.0, SERVE_REL_TOL)}
# phase 12's decode step against the full forward at full width, bf16: two
# attention paths (the ring cache against the flash kernel) whose rounding
# drifts apart over 24 layers moved qwen2-moe's router probabilities by at
# most 11.1% of themselves on an H100; a fault upstream of a router moves
# them by about their own size (a token whose layer-0 experts differ
# moved a layer-1 probability by 85%)
PIN_TIE = (0.0, 0.2)
# the most of the routings (token x MoE layer) that phase 12b lets two
# devices' runs order apart, and the least of the logit rows it compares
ROUTING_TIE_SHARE = 0.02
LOGIT_ROWS_SHARE = 0.75
# (arch, config cut): one per family; zamba2's smoke at its real head_dim
# 80, so that the kernel's D = 80 path meets the CPU's plain version inside
# a model (prompt 2,048: the flash branch)
FAMILIES_SMOKE = (("qwen2-moe-a2.7b", {}), ("rwkv6-1.6b", {}),
                  ("zamba2-2.7b", {"head_dim": 80}))


@contextlib.contextmanager
def recorded_routing():
    """Each ``moe_forward`` call's fp32 router probabilities [B, S, E] and
    the slot of each (token, expert) in its dispatch (-1: none), on the
    host."""
    from repro_torch.models import moe
    rec = []
    real_probs, real_dispatch = moe.router_probs, moe._dispatch_tensors

    def probs(params, x):
        p = real_probs(params, x)
        rec.append({"probs": p.float().cpu()})
        return p

    def dispatch(pr, k, capacity):
        d, c = real_dispatch(pr, k, capacity)
        slot = torch.where(d.sum(-1) > 0, d.argmax(-1), -1)
        rec[-1]["slot"] = slot.reshape(rec[-1]["probs"].shape).cpu()
        return d, c
    moe.router_probs, moe._dispatch_tensors = probs, dispatch
    try:
        yield rec
    finally:
        moe.router_probs, moe._dispatch_tensors = real_probs, real_dispatch


@contextlib.contextmanager
def pinned_routing(probs_at: list, pos: int):
    """The router probabilities at position ``pos`` replaced, call by
    call, by ``probs_at`` (each ``[B, 1, E]``: a decode step's, layer by
    layer), so that token is routed to the same experts with the same
    weights. Yields the list of the replaced probabilities ``[B, E]``, on
    the host, call by call."""
    from repro_torch.models import moe
    real = moe.router_probs
    calls = iter(probs_at)
    own = []

    def probs(params, x):
        p = real(params, x)
        own.append(p[:, pos].float().cpu())
        p[:, pos] = next(calls).to(p.device)[:, -1]
        return p
    moe.router_probs = probs
    try:
        yield own
    finally:
        moe.router_probs = real


def routing_apart(p_ref: torch.Tensor, p_run: torch.Tensor, k: int, tie: tuple,
                  where: str, skip: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Two runs' routings of the same tokens (fp32 router probabilities
    [..., E] on the host). Returns the tokens whose k experts, in the order
    the dispatch's rounds pick them, differ ([...] bool), and what bounds
    them. Every pair of experts of either top k that the runs order apart
    must be a tie on ``p_ref`` (closer than ``tie``'s absolute gap or its
    share of the larger of the two), and no probability of ``p_ref``'s top
    k + 1 or ``p_run``'s top k may move by as much (its absolute part or
    its share of the probability); raises otherwise.
    Tokens in ``skip`` (routed to other experts in an earlier layer, so no
    longer the same hidden state in both runs) are not held."""
    picks = [torch.topk(p, k, dim=-1).indices for p in (p_ref, p_run)]
    apart = (picks[0] != picks[1]).any(-1)
    sets = [torch.zeros_like(p, dtype=torch.bool).scatter_(-1, i, True)
            for p, i in zip((p_ref, p_run), picks)]
    held = torch.ones_like(apart) if skip is None else ~skip
    near = torch.cat([torch.topk(p_ref, k + 1, dim=-1).indices, picks[1]], -1)[held]
    ref_near, run_near = p_ref[held].gather(-1, near), p_run[held].gather(-1, near)
    moved = (run_near - ref_near).abs()
    over = moved >= torch.clamp(tie[1] * ref_near, min=tie[0])
    # the union of both top k of each held token routed apart: each pair
    # that the two runs order apart, and its gap on p_ref
    sel = apart & held
    u = torch.cat(picks, -1)[sel]                                   # [n, 2k]
    r, o = p_ref[sel].gather(-1, u), p_run[sel].gather(-1, u)
    dr = r[:, :, None] - r[:, None, :]
    swapped = torch.sign(dr) * torch.sign(o[:, :, None] - o[:, None, :]) < 0
    gap = dr.abs()
    hi = torch.maximum(r[:, :, None], r[:, None, :])
    untied = swapped & (gap >= torch.clamp(tie[1] * hi, min=tie[0]))
    set_apart = (sets[0] != sets[1]).any(-1) & held
    top = torch.topk(p_ref[set_apart], k + 1, dim=-1).values
    k_gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
    stats = {"routings": apart.numel(), "apart": int(apart.sum()),
             "sets_apart": int(set_apart.sum()),
             "widest_set_change_k_gap_share": float(k_gap.max()) if k_gap.numel() else 0.0,
             "not_held": int((~held).sum()),
             "moved_max_abs": float(moved.max()) if moved.numel() else 0.0,
             "moved_max_share": float((moved / ref_near.clamp(min=1e-30)).max())
             if moved.numel() else 0.0,
             "widest_tie_abs": float(gap[swapped].max()) if bool(swapped.any()) else 0.0,
             "widest_tie_share": float((gap / hi)[swapped].max())
             if bool(swapped.any()) else 0.0}
    if bool(over.any()):
        i, j = torch.nonzero(over)[0].tolist()
        raise AssertionError(f"{where}: a router probability moved by "
                             f"{float(moved[i, j])} from {float(ref_near[i, j])}, "
                             f"the tie {tie} or more; {stats}")
    if bool(untied.any()):
        n, x, y = torch.nonzero(untied)[0].tolist()
        raise AssertionError(f"{where}: experts {int(u[n, x])} and {int(u[n, y])} of "
                             f"a token ordered apart at a gap of {float(gap[n, x, y])} "
                             f"between {float(r[n, x])} and {float(r[n, y])}, beyond "
                             f"the tie {tie}; {stats}")
    return apart, stats


def routing_flips(card: list, cpu: list, k: int, group: int, tie: tuple,
                  n_moe: int):
    """Card against CPU, call by call (``routing_apart``, the CPU's
    probabilities the reference; ``n_moe`` calls a forward pass, one a
    layer): a token's k experts may differ only by ties, on at most
    ROUTING_TIE_SHARE of the routings, a token whose experts or kept slots
    differ in one layer not held in the pass's later ones; in every group of ``group``
    tokens without one the dispatch slots must be equal (bit-for-bit
    masks; a tie moves the slots of its whole group through the capacity
    counts). Returns ([B, S] bool a call: the tokens whose experts or kept
    slots differ, to leave out of the logits' comparison; the routings'
    statistics summed over the calls)."""
    apart_calls = []
    total = {}
    for n, (a, b) in enumerate(zip(card, cpu)):
        if n % n_moe == 0:
            taken = torch.zeros(b["probs"].shape[:-1], dtype=torch.bool)
        flip, stats = routing_apart(b["probs"], a["probs"], k, tie,
                                    f"phase 12b MoE call {n}", skip=taken)
        for key, val in stats.items():
            total[key] = max(total.get(key, 0), val) if key.startswith(("moved", "widest")) \
                else total.get(key, 0) + val
        Bsz, S = flip.shape
        g = min(group, S)
        tied_group = flip.reshape(Bsz, S // g, g).any(-1, keepdim=True)
        tied_group = tied_group.expand(Bsz, S // g, g).reshape(Bsz, S)
        slots_apart = (a["slot"] != b["slot"]).any(-1)
        if bool((slots_apart & ~tied_group).any()):
            b_, t_ = torch.nonzero(slots_apart & ~tied_group)[0].tolist()
            raise AssertionError(f"dispatch slots differ on card and CPU in a group "
                                 f"without a routing tie: row {b_} position {t_}")
        picks = [torch.topk(r["probs"], k, dim=-1).indices for r in (a, b)]
        sets = [torch.zeros_like(r["probs"], dtype=torch.bool).scatter_(-1, idx, True)
                for r, idx in zip((a, b), picks)]
        kept = [r["slot"] >= 0 for r in (a, b)]
        taken = taken | (sets[0] != sets[1]).any(-1) | (kept[0] != kept[1]).any(-1)
        apart_calls.append(taken)
    if total["apart"] > ROUTING_TIE_SHARE * total["routings"]:
        raise AssertionError(f"card and CPU routed {total['apart']} of "
                             f"{total['routings']} routings apart, more than "
                             f"{ROUTING_TIE_SHARE:.0%}: {total}")
    return apart_calls, total


def family_card_against_cpu(dev, arch: str, cut: dict, dtype: str) -> dict:
    """Phase 12b: a family's smoke model in ``dtype``, prompt 2048, 8
    tokens, batch 2, card against CPU from the same weights and seed, as
    phase 6: equal ids (or a documented tie), logits within phase 6's
    gates while both saw the same tokens. MoE: each token routed alike on
    both devices but for ties (``routing_flips``), their count reported;
    bf16 runs at capacity 8 (no drops, so a flip moves no other token),
    and a position routed apart is left out of the logits' comparison, at
    most 1 - LOGIT_ROWS_SHARE of the rows."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve, steps

    cfg = get_smoke(arch).replace(dtype=dtype, **cut)
    if cfg.family == "moe" and dtype == "bfloat16":
        cfg = cfg.replace(capacity_factor=8.0)
    cpu_model = steps.init_for(cfg)(torch.Generator().manual_seed(1))
    card_model = copy.deepcopy(cpu_model).to(dev)
    P, G, B = 2048, 8, 2
    kw = dict(prompt_len=P, gen=G, batch=B, temperature=1.0, seed=3)
    n_attn = {"moe": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}[cfg.family]
    counter = FLASH_COUNTER[dtype]
    flash_attention.launches = 0
    setattr(flash_attention, counter, 0)
    with recorded_routing() as rec_card:
        got = serve.generate(cfg, card_model, **kw, device=dev)
    n_kernel = getattr(flash_attention, counter)
    if (flash_attention.launches, n_kernel) != (n_attn, n_attn):
        raise AssertionError(f"phase 12b {arch} {dtype}: flash launches "
                             f"{flash_attention.launches}, the {dtype} kernel's "
                             f"{n_kernel}, want {n_attn}")
    with recorded_routing() as rec_cpu:
        want = serve.generate(cfg, cpu_model, **kw, device="cpu")
    if not torch.equal(got.prompt, want.prompt):
        raise AssertionError(f"phase 12b {arch}: prompt ids differ")
    got_l = [got.first_logits.float().cpu(), *(lg.float().cpu() for lg in got.decode_logits)]
    want_l = [want.first_logits.float(), *(lg.float() for lg in want.decode_logits)]
    if dtype == "float32":
        rtol, atol = 1e-4, 1e-5
    else:
        rtol, atol = 0.0, SERVE_REL_TOL * float(want_l[0].abs().max())
    col, tie = _first_tie(got.ids, want.ids, want_l, kw["seed"], kw["temperature"],
                          rtol, atol)
    n_same = len(got_l) if col is None else col + 1
    # the routing of the calls both devices made on the same tokens: the
    # prefill's layers, then one call a layer a decode step
    n_moe = cfg.n_layers if cfg.family == "moe" else 0
    flips, routing = routing_flips(rec_card[:n_moe * n_same], rec_cpu[:n_moe * n_same],
                                   cfg.n_experts_per_tok, cfg.moe_group,
                                   ROUTING_TIE[dtype], n_moe) if n_moe else ([], None)
    # positions routed apart in some layer: the prompt's last, then each
    # decode step's token
    apart = torch.zeros(B, n_same, dtype=torch.bool)
    for i, f in enumerate(flips):
        step = i // n_moe
        apart[:, step] |= f[:, -1]
    if col is not None and not tie:
        rows = got.ids[:, col] != want.ids[:, col]
        if not bool(apart[rows, col].all()):        # nor routed apart there
            raise AssertionError(f"phase 12b {arch} {dtype}: sampled ids differ at "
                                 f"step {col} without a tie:\ncuda {got.ids.tolist()}"
                                 f"\ncpu {want.ids.tolist()}")
    err = scale = 0.0
    compared = 0
    for i, (a, b) in enumerate(zip(got_l[:n_same], want_l[:n_same])):
        rows = ~apart[:, i]
        if bool(rows.any()):
            torch.testing.assert_close(a[rows], b[rows], rtol=rtol, atol=max(atol, 1e-5))
            err = max(err, float((a[rows] - b[rows]).abs().max()))
            scale = max(scale, float(b[rows].abs().max()))
            compared += int(rows.sum())
    if compared < LOGIT_ROWS_SHARE * B * n_same:
        raise AssertionError(f"phase 12b {arch} {dtype}: {compared} of {B * n_same} "
                             f"logit rows compared, fewer than {LOGIT_ROWS_SHARE:.0%}")
    res = {"family_card_vs_cpu": cfg.name, "family": cfg.family, "dtype": dtype,
           "head_dim": cfg.resolved_head_dim, "prompt_len": P, "gen": G, "batch": B,
           "capacity_factor": cfg.capacity_factor if cfg.family == "moe" else None,
           "ids_equal": col is None, "first_diff_step": col,
           "steps_compared": n_same, "logit_rows_compared": compared,
           "logits_max_abs": err, "logit_scale": scale, "logits_atol": atol,
           "routing": routing, "routing_tie": ROUTING_TIE[dtype] if n_moe else None,
           "positions_routed_apart": int(apart.sum()), "flash_launches": n_kernel}
    log(json.dumps(res))
    return res


# ----------------------------------------------------------- phase 13 ----
WHISPER, PHI3V = "whisper-tiny", "phi-3-vision-4.2b"
# (a) whisper-tiny's serve flow (the reference's: frames from the prompt's
# key, decode from token 0; the prompt is drawn, not read)
AUDIO_SERVE = dict(batch=4, prompt_len=32, gen=32)
# (b) the reference's prefill_32k shape (32 x 32,768 decoder tokens
# against 32 x 1,500 frames), then decode steps from its fresh cache
AUDIO_PREFILL = dict(shape="prefill_32k", steps=8)
# (c) train_4k's sequence, its global batch of 256 cut to 8 for one card
AUDIO_TRAIN = dict(batch=8, seq=4096, microbatches=2, lr=3e-4, warmup=1, steps=6)
# (d) phi-3-vision-4.2b served: the dense flow (4 x 2,048 ids), then the
# vision path's prefill step (576 vision embeddings + 1,472 ids)
VLM_SERVE = dict(batch=4, prompt_len=2048, gen=32, steps=8)
# (e) 4 x (576 + 3,520) positions, depth cut to what fits the card with
# fp32 masters, AdamW moments and gradients. The vision embeddings are
# seeded normals, not the reference's zeros: an all-zero row stays zero
# through every layer, and RMSNorm's derivative there is 1/sqrt(eps) ~ 316
# a layer, so the gradient overflows to NaN from about 24 layers on, in
# both packages (ROADMAP C-26)
VLM_TRAIN = dict(layers=32, batch=4, seq=3520, microbatches=2, lr=3e-4,
                 warmup=1, steps=6, vision_embeds="normal")
# (f) the smoke models, card against CPU: whisper's decoder prompt of 2,048
# against 64 frames (both its attentions take the flash branch), the VLM's
# 16 vision + 2,032 text positions; 4 decode steps
FAMILY13_SMOKE = dict(prompt=2048, batch=2, steps=4)


def _zero_counts() -> dict:
    fns = counters()
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    return fns


def _read_counts(fns) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}


def _only_flash(launches: dict, n: int, what: str) -> None:
    """The bf16 flash kernel launched ``n`` times and no other kernel."""
    if launches["flash_attention"] != n:
        raise AssertionError(f"{what}: the bf16 flash kernel launched "
                             f"{launches['flash_attention']} times, not {n}")
    others = {k: c for k, c in launches.items() if k != "flash_attention" and c}
    if others:
        raise AssertionError(f"{what}: other kernels launched: {others}")


def _within_serve_tol(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not diff <= SERVE_REL_TOL * scale:
        raise AssertionError(f"{what}: differs by {diff} > {SERVE_REL_TOL} x {scale}")
    return {"max_abs": diff, "logit_scale": scale}


def _check_ids(ids: torch.Tensor, vocab: int, what: str) -> None:
    if not (0 <= int(ids.min()) and int(ids.max()) < vocab):
        raise AssertionError(f"{what}: ids outside the vocabulary")


def serve_audio(dev):
    """Phase 13 (a): ``serve.generate`` on whisper-tiny at full width (4 +
    4 layers, d 384, 6 heads, vocab 51,865, 1,500 frames, bf16), batch 4,
    32 new tokens, warmed up, then timed with the counts zeroed: no kernel
    at all (the encoder's 1,500 frames take the direct branch by the
    reference's rule, decode is plain PyTorch); ids in the vocabulary,
    finite logits; the first decode step (token 0 at position 0) against
    ``decode_train`` over that token against the same encoder states
    (SERVE_REL_TOL of its scale), which holds the cross cache and the ring
    against the direct path. Returns (summary, model)."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import encdec

    cfg = get_config(WHISPER)
    model, setup_s = _served_copy(dev, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    B, P, G = AUDIO_SERVE["batch"], AUDIO_SERVE["prompt_len"], AUDIO_SERVE["gen"]
    kw = dict(prompt_len=P, batch=B, temperature=1.0, seed=0, device=dev)
    serve.generate(cfg, model, gen=2, **kw)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fns = _zero_counts()
    out = serve.generate(cfg, model, gen=G, **kw)
    launches = _read_counts(fns)
    peak = torch.cuda.max_memory_allocated(dev)
    if any(launches.values()):
        raise AssertionError(f"phase 13 (a): kernels launched: {launches}")
    if out.first_logits is not None or tuple(out.ids.shape) != (B, 1 + G):
        raise AssertionError(f"phase 13 (a): ids {tuple(out.ids.shape)}")
    _check_ids(out.ids, cfg.vocab_size, "phase 13 (a)")
    if not all(bool(torch.isfinite(lg).all()) for lg in out.decode_logits):
        raise AssertionError("phase 13 (a): non-finite logits")
    with torch.no_grad():
        frames = prng.normal(prng.PRNGKey(0), (B, cfg.n_audio_frames, cfg.d_model)).to(dev)
        enc_ms = cuda_ms(lambda: encdec.encode(model, frames, cfg), 5)
        enc = encdec.encode(model, frames, cfg)
        want = encdec.decode_train(model, out.ids[:, :1].to(dev), enc, cfg)[:, 0]
    first = _within_serve_tol(out.decode_logits[0], want,
                              "phase 13 (a) first decode step against decode_train")
    res = {"serve_audio": cfg.name, "params_B": n_params / 1e9, "batch": B,
           "frames": cfg.n_audio_frames, "gen": G, "setup_s": setup_s,
           "encode_ms": enc_ms, "encode_and_cache_ms": out.prefill_s * 1e3,
           "decode_ms_per_step": out.decode_s * 1e3 / G,
           "decode_tokens_per_s": G * B / out.decode_s, "peak_mem_GB": peak / 1e9,
           "launches": launches, "first_decode_vs_decode_train": first,
           "ids_first_request": out.ids[0, :16].tolist()}
    log(json.dumps({"phase13a": res}))
    return res, model


def prefill_audio(dev, model) -> dict:
    """Phase 13 (b): whisper-tiny's prefill step (``steps.
    build_prefill_step``) at the reference's ``prefill_32k`` shape, 32 x
    32,768 decoder tokens against 32 x 1,500 frames (cut to a smaller
    batch only if it does not fit, and the cut printed): exactly 8 bf16
    flash launches (each decoder layer's causal self-attention and
    non-causal cross-attention, q [B, 32768, 6, 64] against k/v [B, 1500,
    6, 64]) and no other kernel, finite last-position logits; then 8
    decode steps (``build_serve_step``) from its cache: no kernel, finite
    logits, ids in the vocabulary. The cache is fresh, as the reference's
    (ROADMAP C-25): these steps are not held against ``decode_train``;
    phase 13 (f) holds them card against CPU."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import steps

    cfg = model.cfg
    shape = SHAPES[AUDIO_PREFILL["shape"]]
    S, n = shape.seq_len, AUDIO_PREFILL["steps"]
    prefill, serve_step = steps.build_prefill_step(cfg, shape), steps.build_serve_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(13)

    def batch_of(B):
        return {"frames": torch.randn(B, cfg.n_audio_frames, cfg.d_model, device=dev,
                                      generator=gen).to(torch.bfloat16),
                "tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                        generator=gen, dtype=torch.int32)}
    with torch.no_grad():
        prefill(model, batch_of(1))                                   # warm-up
        for B in (shape.global_batch, shape.global_batch // 2, shape.global_batch // 4):
            batch = batch_of(B)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fns = _zero_counts()
            try:
                t0 = time.perf_counter()
                logits, cache = prefill(model, batch)
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                log(f"phase 13 (b): batch {B} x {S} does not fit; cutting the batch")
                del batch
                torch.cuda.empty_cache()
                continue
            break
        else:
            raise AssertionError(f"phase 13 (b): no batch of {S} tokens fits")
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts(fns)
        _only_flash(launches, 2 * cfg.n_layers, "phase 13 (b) prefill")
        if tuple(logits.shape) != (B, 1, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"phase 13 (b): prefill logits {tuple(logits.shape)}")
        fns = _zero_counts()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        ids = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            lg, cache = serve_step(model, cache, tok, S + i)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
            ids.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("phase 13 (b): non-finite decode logits")
        ids = torch.cat(ids, dim=1).cpu()
        _check_ids(ids, cfg.vocab_size, "phase 13 (b)")
        if any(_read_counts(fns).values()):
            raise AssertionError(f"phase 13 (b): decode launched {_read_counts(fns)}")
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"prefill_audio": cfg.name, "shape": shape.name, "batch": B,
           "batch_cut_from": shape.global_batch if B != shape.global_batch else None,
           "decoder_tokens": S, "frames": cfg.n_audio_frames, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": B * S / (prefill_ms / 1e3),
           "decode_steps": n, "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_mem_GB": peak / 1e9,
           "launches": launches, "ids_first_request": ids[0].tolist()}
    log(json.dumps({"phase13b": res}))
    del cache, batch
    torch.cuda.empty_cache()
    return res


def serve_vlm(dev) -> dict:
    """Phase 13 (d): phi-3-vision-4.2b at full width (32 layers, d 3,072,
    32|32 heads, head dim 96, bf16, the serving copy cast in place): (i)
    ``serve.generate``, 4 prompts of 2,048 ids and 32 tokens, warmed up,
    then timed with the counts zeroed: 32 bf16 flash launches in the
    prefill, none in a decode step, no other kernel; the first decode step
    against ``lm_forward``; (ii) the vision path, ``steps.
    build_prefill_step`` with 576 vision embeddings and 1,472 ids (32
    launches) and 8 ``build_serve_step`` steps from its cache (no kernel),
    the cache sized by a shape of 2,048 + 8 positions (at 2,048,
    ``cache_len_for`` gives 2,048 slots and the first step would evict
    position 0); the first step against ``lm_forward`` with the same
    ``extra_embeds`` (SERVE_REL_TOL of its scale)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tfm

    cfg = get_config(PHI3V)
    model, setup_s = _served_copy(dev, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    B, P, G, n = (VLM_SERVE[k] for k in ("batch", "prompt_len", "gen", "steps"))
    kw = dict(prompt_len=P, batch=B, temperature=1.0, seed=0, device=dev)
    serve.generate(cfg, model, gen=2, **kw)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fns = _zero_counts()
    out = serve.generate(cfg, model, gen=G, **kw)
    launches = _read_counts(fns)
    peak = torch.cuda.max_memory_allocated(dev)
    _only_flash(launches, cfg.n_layers, "phase 13 (d) generate")
    _check_ids(out.ids, cfg.vocab_size, "phase 13 (d)")
    if not all(bool(torch.isfinite(lg).all())
               for lg in [out.first_logits, *out.decode_logits]):
        raise AssertionError("phase 13 (d): non-finite logits")
    with torch.no_grad():
        flash_attention.launches = 0
        _, cache = tfm.lm_prefill(model, out.prompt.to(dev), cfg, cache_len=P + G)
        n_prefill = flash_attention.launches
        flash_attention.launches = 0
        tfm.lm_decode(model, out.ids[:, :1].to(dev), cache, P, cfg)
        n_decode = flash_attention.launches
        del cache
        if (n_prefill, n_decode) != (cfg.n_layers, 0):
            raise AssertionError(f"phase 13 (d): flash launches prefill {n_prefill}, "
                                 f"decode {n_decode}")
        full, _ = tfm.lm_forward(model, torch.cat([out.prompt, out.ids[:, :1]],
                                                  dim=1).to(dev), cfg)
        want = full[:, P]
        del full
    first = _within_serve_tol(out.decode_logits[0], want,
                              "phase 13 (d) first decode step against lm_forward")

    # (ii) the vision path
    nv = cfg.n_vision_tokens
    shape = ShapeConfig("phase13_vlm", P + n, B, "prefill")
    prefill, serve_step = steps.build_prefill_step(cfg, shape), steps.build_serve_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(14)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P - nv), device=dev,
                                     generator=gen, dtype=torch.int32),
             "extra_embeds": torch.randn(B, nv, cfg.d_model, device=dev,
                                         generator=gen).to(torch.bfloat16)}
    with torch.no_grad():
        prefill(model, batch)                                         # warm-up
        torch.cuda.synchronize()
        fns = _zero_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch)
        torch.cuda.synchronize()
        vis_prefill_ms = (time.perf_counter() - t0) * 1e3
        vis_launches = _read_counts(fns)
        _only_flash(vis_launches, cfg.n_layers, "phase 13 (d) vision prefill step")
        fns = _zero_counts()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        ids, steps_logits = [tok], []
        t0 = time.perf_counter()
        for i in range(n):
            lg, cache = serve_step(model, cache, tok, P + i)
            steps_logits.append(lg[:, -1])
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
            ids.append(tok)
        torch.cuda.synchronize()
        vis_decode_ms = (time.perf_counter() - t0) * 1e3 / n
        if any(_read_counts(fns).values()):
            raise AssertionError(f"phase 13 (d): decode launched {_read_counts(fns)}")
        ids = torch.cat(ids, dim=1).cpu()
        _check_ids(ids, cfg.vocab_size, "phase 13 (d) vision path")
        if not all(bool(torch.isfinite(x).all()) for x in [logits, *steps_logits]):
            raise AssertionError("phase 13 (d): non-finite vision-path logits")
        del cache
        full, _ = tfm.lm_forward(model, torch.cat([batch["tokens"], ids[:, :1].to(dev)],
                                                  dim=1), cfg,
                                 extra_embeds=batch["extra_embeds"])
        want = full[:, P]
        del full
    vis_first = _within_serve_tol(steps_logits[0], want,
                                  "phase 13 (d) vision path's first decode step "
                                  "against lm_forward")
    res = {"serve_vlm": cfg.name, "params_B": n_params / 1e9, "layers": cfg.n_layers,
           "batch": B, "prompt_len": P, "gen": G, "setup_s": setup_s,
           "prefill_ms": out.prefill_s * 1e3, "decode_ms_per_step": out.decode_s * 1e3 / G,
           "decode_tokens_per_s": G * B / out.decode_s,
           "prefill_tokens_per_s": P * B / out.prefill_s, "peak_mem_GB": peak / 1e9,
           "launches": launches, "flash_launches_prefill": n_prefill,
           "flash_launches_decode_step": n_decode, "first_decode_vs_forward": first,
           "vision_tokens": nv, "text_tokens": P - nv,
           "vision_cache_len": steps.cache_len_for(cfg, shape),
           "vision_prefill_ms": vis_prefill_ms, "vision_decode_ms_per_step": vis_decode_ms,
           "vision_launches": vis_launches["flash_attention"],
           "vision_first_decode_vs_forward": vis_first,
           "ids_first_request": out.ids[0, :16].tolist()}
    log(json.dumps({"phase13d": res}))
    del model, out
    torch.cuda.empty_cache()
    return res


def _greedy_apart(ids_card, ids_cpu, cpu_logits, rtol, atol):
    """The first column where the two devices' greedy ids differ (None if
    equal; column c is the argmax of ``cpu_logits[c]``), and whether each
    request that differs there has a tie: the CPU's top two logits within
    the gate."""
    cols = torch.nonzero((ids_card != ids_cpu).any(dim=0)).flatten().tolist()
    if not cols:
        return None, True
    c = cols[0]
    rows = ids_card[:, c] != ids_cpu[:, c]
    top2 = torch.topk(cpu_logits[c], 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).abs()
    return c, bool((gap <= rtol * top2[:, 0].abs() + atol)[rows].all())


def family13_card_against_cpu(dev, arch: str, dtype: str, cfg=None,
                              label: str = "phase 13 (f)") -> dict:
    """Phase 13 (f), serving: ``arch``'s smoke model in ``dtype`` on the
    card and on the CPU from the same weights and inputs: the prefill step
    (whisper: a decoder prompt of 2,048 ids against 64 frames, so both its
    attentions take the flash branch, Skv = 64 on the cross one; the VLM:
    16 vision embeddings + 2,032 ids), then 4 greedy serve steps from its
    cache. The card launches the kernel of ``dtype`` once per flash-branch
    attention call of the prefill; equal ids (or a documented tie: the
    CPU's top two within the gate), logits within phase 6's gates (fp32
    rtol 1e-4, bf16 5% of their scale) while both saw the same tokens.
    ``cfg`` replaces ``arch``'s smoke config (a dense model: 2,048 ids)."""
    import copy

    from repro_torch.configs import ShapeConfig, get_smoke
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import steps

    cfg = (cfg or get_smoke(arch)).replace(dtype=dtype)
    c = FAMILY13_SMOKE
    B, P, n = c["batch"], c["prompt"], c["steps"]
    cpu_model = steps.init_for(cfg)(torch.Generator().manual_seed(1))
    card_model = copy.deepcopy(cpu_model).to(dev)
    shape = ShapeConfig("phase13f", P + n, B, "prefill")
    gen = torch.Generator().manual_seed(7)
    dt = getattr(torch, dtype)
    if cfg.family == "audio":
        batch = {"frames": torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                       generator=gen).to(dt),
                 "tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                         dtype=torch.int32)}
        n_attn = 2 * cfg.n_layers
    elif cfg.family == "dense":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                         dtype=torch.int32)}
        n_attn = cfg.n_layers
    else:
        nv = cfg.n_vision_tokens
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P - nv), generator=gen,
                                         dtype=torch.int32),
                 "extra_embeds": torch.randn(B, nv, cfg.d_model, generator=gen).to(dt)}
        n_attn = cfg.n_layers
    prefill, serve_step = steps.build_prefill_step(cfg, shape), steps.build_serve_step(cfg)
    counter = FLASH_COUNTER[dtype]

    def run(model, where):
        logits, cache = prefill(model, {k: t.to(where) for k, t in batch.items()})
        out = [logits[:, -1].float().cpu()]
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        ids = [tok.cpu()]
        for i in range(n):
            lg, cache = serve_step(model, cache, tok, P + i)
            out.append(lg[:, -1].float().cpu())
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
            ids.append(tok.cpu())
        return torch.cat(ids, dim=1), out

    with torch.no_grad():
        flash_attention.launches = 0
        setattr(flash_attention, counter, 0)
        ids_card, got = run(card_model, dev)
        n_kernel = getattr(flash_attention, counter)
        if (flash_attention.launches, n_kernel) != (n_attn, n_attn):
            raise AssertionError(f"{label} {arch} {dtype}: flash launches "
                                 f"{flash_attention.launches}, the {dtype} kernel's "
                                 f"{n_kernel}, want {n_attn}")
        ids_cpu, want = run(cpu_model, "cpu")
    if dtype == "float32":
        rtol, atol = 1e-4, 1e-5
    else:
        rtol, atol = 0.0, SERVE_REL_TOL * float(want[0].abs().max())
    col, tie = _greedy_apart(ids_card, ids_cpu, want, rtol, atol)
    if col is not None and not tie:
        raise AssertionError(f"{label} {arch} {dtype}: ids differ at step {col} "
                             f"without a tie:\ncuda {ids_card.tolist()}\n"
                             f"cpu {ids_cpu.tolist()}")
    n_same = len(got) if col is None else col + 1     # logits of the same tokens
    err = scale = 0.0
    for a, b in zip(got[:n_same], want[:n_same]):
        torch.testing.assert_close(a, b, rtol=rtol, atol=max(atol, 1e-5))
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    res = {"family13_card_vs_cpu": cfg.name, "family": cfg.family,
           "head_dim": cfg.resolved_head_dim, "dtype": dtype,
           "prompt": P, "batch": B, "steps": n, "ids_equal": col is None,
           "first_diff_step": col, "logits_compared": n_same, "logits_max_abs": err,
           "logit_scale": scale, "logits_atol": atol, "flash_launches": n_kernel}
    log(json.dumps(res))
    return res


def _attention_f64(q, k, v, *, causal=True, window=None):
    """Softmax attention in float64 (no window: phase 13's calls have
    none), autograd's own backward."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KV, H // KV, D), k) / D ** 0.5
    if causal:
        s = torch.where(torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None],
                        s, -1e300)
    out = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v)
    return out.reshape(B, Sq, H, D)


def fp32_grad_floor(model, cfg, batch, g32: dict) -> dict:
    """Each leaf's fp32 gradient ``g32`` (the CPU's) against the same
    weights' gradient in float64 on the CPU (the model cast to float64, the
    attention patched, in this script only, to ``_attention_f64``), as a
    share of the float64 gradient's scale: the rounding noise of fp32 sums
    for this model and batch."""
    import copy

    from repro_torch.launch import steps
    from repro_torch.models import attention, module
    cfg64 = cfg.replace(dtype="float64")
    model64 = copy.deepcopy(model).double()
    batch64 = {k: t.double() if t.is_floating_point() else t for k, t in batch.items()}
    module.DTYPES["float64"] = torch.float64
    orig = attention.flash_attention
    attention.flash_attention = _attention_f64
    try:
        loss, _ = steps.loss_for(cfg64)(model64, batch64)
        g64 = torch.autograd.grad(loss, list(model64.parameters()))
    finally:
        attention.flash_attention = orig
        del module.DTYPES["float64"]
    return {n: float((g32[n].double() - g).abs().max() / g.abs().max().clamp(min=1e-300))
            for (n, _), g in zip(model64.named_parameters(), g64)}


# phase 13 (f)'s gradient gate, a multiple of a leaf's fp32 floor: the
# card's and the CPU's fp32 gradients each carry rounding noise of about
# the CPU's floor against float64 (the card sums in other orders), so they
# may lie up to about twice the floor apart; 4x leaves that much again
GRAD_FLOOR_FACTOR = 4.0


def family13_train_card_against_cpu(dev, arch: str, seq: int, n_attn: int,
                                    label: str = "phase 13 (f)",
                                    flat_gate: float | None = None,
                                    cfg=None) -> dict:
    """Phase 13 (f), training: 3 AdamW steps of ``arch``'s smoke model in
    fp32 (``_train_card_and_cpu``; whisper: 2,048 decoder tokens against
    64 frames, both attentions on the flash branch; the VLM: 16 + 2,032
    positions), card against CPU: the card's kernel launched with lse 2 x
    ``n_attn`` times a step; the first step's gradients within 1e-5 of
    each leaf's scale, or, where the CPU's own fp32 gradient lies further
    than that from float64 (``fp32_grad_floor``; whisper's decoder
    self-attention wq/wk, whose terms cancel), within GRAD_FLOOR_FACTOR
    times that floor; losses rtol 1e-5; every parameter within 3 lr after
    the steps (how far beyond 1e-5 of their scale they lie is printed:
    AdamW amplifies differences on elements with near-zero gradients, as
    phase 11b says). ``cfg`` replaces ``arch``'s smoke config."""
    from repro_torch.configs import get_smoke

    cfg = (cfg or get_smoke(arch)).replace(dtype="float32")
    c = TRAIN_CARD_CPU
    r = _train_card_and_cpu(dev, cfg, seq)
    names = r["names"]
    # ``flat_gate``: that share of each leaf's scale instead of the float64
    # floor (which a model whose scans hold fp32 states cannot give)
    floor = (fp32_grad_floor(r["initial"], cfg, r["batches"][0], r["g_cpu"])
             if flat_gate is None else {n: 0.0 for n in names})
    err = {n: float((r["g_card"][n] - r["g_cpu"][n]).abs().max()
                    / r["g_cpu"][n].abs().max().clamp(min=1e-30)) for n in names}
    gate = {n: max(flat_gate or 1e-5, GRAD_FLOOR_FACTOR * floor[n]) for n in names}
    worst = sorted(names, key=lambda n: -err[n] / gate[n])[:3]
    want = 2 * n_attn * c["steps"]
    res = {"family13_train_card_vs_cpu": cfg.name,
           "head_dim": cfg.resolved_head_dim, "seq": seq, "batch": c["batch"],
           "steps": c["steps"], "losses_cuda": r["losses_cuda"],
           "losses_cpu": r["losses_cpu"], "flash_launches_with_lse": r["launches_cuda"],
           "first_grad_err_over_scale": max(err.values()),
           "first_grad_worst": {n: {"err": err[n], "fp32_floor": floor[n],
                                    "gate": gate[n]} for n in worst},
           **param_spread(r["params_cuda"], r["params_cpu"])}
    log(json.dumps(res))
    if (r["launches_cuda"], r["launches_cpu"]) != (want, 0):
        raise AssertionError(f"{label} {arch}: lse launches card "
                             f"{r['launches_cuda']} (want {want}), CPU {r['launches_cpu']}")
    bad = {n: (err[n], gate[n]) for n in names if not err[n] <= gate[n]}
    if bad:
        raise AssertionError(f"{label} {arch}: first gradients card/CPU: {bad}")
    np.testing.assert_allclose(r["losses_cuda"], r["losses_cpu"], rtol=1e-5)
    if not res["param_moved_max"] <= c["steps"] * c["lr"]:
        raise AssertionError(f"{label} {arch}: params moved apart: {res}")
    return res


def audio_and_vlm_paths(dev) -> dict:
    """Phase 13: (a)-(f), each run's counts zeroed just before it and read
    just after; the models freed between them."""
    from repro_torch.configs import get_config, get_smoke
    out = {}
    out["a"], model = serve_audio(dev)
    out["b"] = prefill_audio(dev, model)
    del model
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER)
    res, _, model, opt, _ = train_steps(dev, cfg, AUDIO_TRAIN, 2 * cfg.n_layers)
    log(json.dumps({"phase13c": res}))
    out["c"] = res
    del model, opt
    torch.cuda.empty_cache()
    out["d"] = serve_vlm(dev)
    cfg = get_config(PHI3V).replace(n_layers=VLM_TRAIN["layers"])
    log(f"phase 13 (e): {cfg.name} at {cfg.n_layers} of 32 layers")
    res, _, model, opt, _ = train_steps(dev, cfg, VLM_TRAIN, cfg.n_layers)
    log(json.dumps({"phase13e": res}))
    out["e"] = res
    del model, opt
    torch.cuda.empty_cache()
    out["f"] = [family13_card_against_cpu(dev, arch, dtype)
                for arch in (WHISPER, PHI3V) for dtype in ("float32", "bfloat16")]
    # 3 AdamW steps of each smoke model in fp32, as phase 11b: whisper's
    # 2,048 decoder tokens against 64 frames (2 flash-branch calls a
    # layer), the VLM's 16 + 2,032 positions
    P = FAMILY13_SMOKE["prompt"]
    out["f_train"] = [
        family13_train_card_against_cpu(dev, WHISPER, P, 2 * get_smoke(WHISPER).n_layers),
        family13_train_card_against_cpu(dev, PHI3V, P - get_smoke(PHI3V).n_vision_tokens,
                                        get_smoke(PHI3V).n_layers)]
    return out


# ----------------------------------------------------------- phase 15 ----
# the smoke TinyLlama at head_dim 256 (Gemma-2B's and Gemma-7B's head dim,
# arXiv:2403.08295), built here with dataclasses.replace: no config of the
# port has it
HEAD_DIM_256 = dict(arch="tinyllama-1.1b", head_dim=256)


def head_dim_256_path(dev) -> dict:
    """Phase 15: the smoke TinyLlama with head_dim 256 on the flash branch,
    card against CPU under phase 13 (f)'s gates: a 2,048-token prefill and
    4 greedy serve steps in fp32 and bf16 (``family13_card_against_cpu``:
    one launch of the kernel of the type a layer), and the fp32 train steps
    (``family13_train_card_against_cpu``: 2 lse launches a layer a step,
    the first gradients within 1e-5 of scale or 4x the fp32 floor)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    arch = HEAD_DIM_256["arch"]
    cfg = dataclasses.replace(get_smoke(arch), head_dim=HEAD_DIM_256["head_dim"])
    zero_routes()
    out = {"prefill": [family13_card_against_cpu(dev, arch, dtype, cfg=cfg,
                                                 label="phase 15")
                       for dtype in ("float32", "bfloat16")],
           "train": family13_train_card_against_cpu(
               dev, arch, FAMILY13_SMOKE["prompt"], cfg.n_layers,
               label="phase 15", cfg=cfg)}
    out["f32_routes"] = read_routes("tf32", "phase 15")
    return out


def zero_routes() -> None:
    """Set the flash routes' counters (fp32's and the 16-bit kernels') to
    0 (the runs between this and ``read_routes`` zero the per-type counters
    themselves)."""
    from repro_torch.kernels.flash_attention import ops
    for name in (*ops.F32_ROUTE_COUNTERS.values(), *ops.SM90_ROUTE_COUNTERS.values()):
        setattr(ops.flash_attention, name, 0)


def read_routes(route: str, what: str, sixteen: bool = False) -> dict:
    """The fp32 routes' counts (``sixteen``: the bf16/fp16 routes') since
    ``zero_routes``: every launch of those kernels on ``route``, and at
    least one."""
    from repro_torch.kernels.flash_attention import ops
    table = ops.SM90_ROUTE_COUNTERS if sixteen else ops.F32_ROUTE_COUNTERS
    counts = {r: getattr(ops.flash_attention, n) for r, n in table.items()}
    if not counts[route] > 0 or sum(counts.values()) != counts[route]:
        kind = "bf16/fp16" if sixteen else "fp32"
        raise AssertionError(f"{what}: {kind} flash launches by route {counts}, "
                             f"want all on {route}")
    return counts


# ----------------------------------------------------------- phase 14 ----
# (a) the moe, ssm and hybrid families trained at full width: phase 11's
# batch (train_4k's 4,096 tokens, its global batch of 256 cut to 8, in 2
# microbatches); rwkv6 and zamba2 at full depth, qwen2-moe at the depth
# one card holds with fp32 masters, AdamW moments and gradients: 3 of 24
# (~9.1 GB of state a layer, ~10 GB for the embedding and the head, and
# the 151,936-wide fp32 logits of a microbatch, ~10 GB each for them,
# their log-softmax and its gradient; 4 layers ran out of memory)
FAMILY_TRAIN = dict(batch=8, seq=4096, microbatches=2, lr=3e-4, warmup=1)
# arch -> (layers, or None for all; timed steps after the warm-up: one
# for the two whose steps take 13-26 s, host-bound on their scans)
FAMILY_TRAIN_RUNS = {"qwen2-moe-a2.7b": (3, 2), "rwkv6-1.6b": (None, 1),
                     "zamba2-2.7b": (None, 1)}
# (a)'s smoke models card against CPU, 3 fp32 AdamW steps as phase 11b
# (seq 2,048: the flash branch of qwen2-moe's and zamba2's attention), the
# first gradients within this share of each leaf's scale: 1e-5 as 11b,
# 1e-4 for the recurrent families, whose decay leaves (RWKV6's u, Mamba2's
# A_log and dt_bias) sum a derivative over every position and head in
# terms that cancel (measured 1.6e-5 and 1.9e-5 card vs CPU; their scans
# hold fp32 states, so the float64 floor of phase 13 (f) cannot be had)
FAMILY_TRAIN_SMOKE = {"qwen2-moe-a2.7b": 1e-5, "rwkv6-1.6b": 1e-4, "zamba2-2.7b": 1e-4}
# (b) one real step through the sharding plan
PLAN_STEP = dict(arch="tinyllama-1.1b", batch=2, seq=2048, steps=3, lr=3e-4)
# (c) the dry-run on this machine's torch: (arch, shape, multi-pod)
DRYRUN_ON_CARD = (("tinyllama-1.1b", "train_4k", False),
                  ("whisper-tiny", "decode_32k", True))
DRYRUN_OUT = HERE / "build" / "chip_smoke" / "dryrun"
DRYRUN_KEYS = {"arch", "shape", "microbatches", "mesh", "n_devices", "kind",
               "compile_s", "flops_per_device", "bytes_accessed_per_device",
               "collectives", "memory"}


def _flash_calls_a_forward(cfg) -> int:
    """The flash-branch attention calls of one forward at 4,096 tokens."""
    if cfg.family == "moe":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0


def family_train_paths(dev) -> dict:
    """Phase 14 (a): ``train_steps`` (phase 11's checks: finite, falling
    losses; the bf16 flash kernel with lse twice and ``flash_bwd_ref`` once
    a flash-branch call a microbatch; no other kernel) on qwen2-moe-a2.7b
    (cut), rwkv6-1.6b and zamba2-2.7b at full width, FAMILY_TRAIN's batch;
    then each smoke model's 3 fp32 AdamW steps card against CPU."""
    from repro_torch.configs import get_config, get_smoke
    out = {}
    for arch, (layers, steps) in FAMILY_TRAIN_RUNS.items():
        cfg = get_config(arch)
        full = cfg.n_layers
        if layers:
            cfg = cfg.replace(n_layers=layers)
        res, _, model, opt, _ = train_steps(dev, cfg, dict(FAMILY_TRAIN, steps=steps),
                                            _flash_calls_a_forward(cfg))
        res["layers_of"] = full
        log(json.dumps({"phase14a": res}))
        out[arch] = res
        del model, opt
        torch.cuda.empty_cache()
    out["smoke"] = [family13_train_card_against_cpu(
        dev, arch, TRAIN_CARD_CPU["seq"], _flash_calls_a_forward(get_smoke(arch)),
        label="phase 14 (a)", flat_gate=gate) for arch, gate in FAMILY_TRAIN_SMOKE.items()]
    return out


def plan_step_on_card(dev) -> dict:
    """Phase 14 (b): the sharding plan on the card. A one-rank NCCL group
    (``file://`` store), ``launch.mesh.make_host_mesh()`` (the (1, 1)
    ``("data", "model")`` mesh), the smoke TinyLlama's fp32 parameters
    replaced by DTensors laid out by ``sharding.param_specs`` (each
    ``Replicate``: no axis of size 1 shards), the batch by ``data_specs``,
    and PLAN_STEP's AdamW steps at S = 2,048 (the flash branch) under
    ``activation_rules`` with the dry-run's logical map; against the same
    steps on plain tensors from the same weights and tokens. The DTensors
    reach the flash kernel through their local shards (``to_local``): the
    kernel's launches with lse and ``flash_bwd_ref``'s calls are those of
    the plain run. Losses and parameters bit for bit, or, where not (the
    embedding's backward adds repeated ids' rows in no fixed order), the
    first step's gradients within 1e-6 of each leaf's scale, losses rtol
    1e-6, and the parameters within 1e-6 of each leaf's scale on all but
    0.1% of its elements, those within 3 lr (phase 11b's AdamW
    amplification); the gaps are printed."""
    import copy
    import tempfile

    import torch.distributed as dist
    from torch import nn
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_lm_batches
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.act import activation_rules
    from repro_torch.sharding.specs import (batch_axes, data_specs, param_specs,
                                            to_placements)

    c = PLAN_STEP
    cfg = get_smoke(c["arch"]).replace(dtype="float32")
    base = steps.init_for(cfg)(torch.Generator(device=dev).manual_seed(3))
    batches = list(make_lm_batches(cfg, c["batch"], c["seq"], c["steps"], seed=5,
                                   device=dev))

    def local(t):
        return (t.to_local() if isinstance(t, DTensor) else t).detach().cpu()

    def run(model, data, scope):
        """(first-step gradients, losses, parameters, (lse launches,
        backward calls) of the steps)."""
        opt = adamw_init(dict(model.named_parameters()))
        step = steps.build_train_step(cfg, lr=c["lr"])
        names = [n for n, _ in model.named_parameters()]
        with scope():
            loss, _ = steps.loss_for(cfg)(model, data[0])
            grads = dict(zip(names, map(local, torch.autograd.grad(
                loss, list(model.parameters())))))
            flash_attention.launches_lse = flash_attention.backward_calls = 0
            losses = [step(model, opt, b)[2] for b in data]
        torch.cuda.synchronize()
        params = {n: local(p) for n, p in model.named_parameters()}
        return (grads, [float(local(x)) for x in losses], params,
                (flash_attention.launches_lse, flash_attention.backward_calls))

    plain = run(copy.deepcopy(base), batches, contextlib.nullcontext)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = make_host_mesh(dev)
            model = copy.deepcopy(base)
            specs = param_specs(dict(model.named_parameters()), mesh)
            placements = {n: to_placements(sp, mesh) for n, sp in specs.items()}
            if any(not p.is_replicate() for pl in placements.values() for p in pl):
                raise AssertionError(f"a (1, 1) mesh sharded a parameter: {placements}")
            for prefix, mod in model.named_modules():
                for name, p in list(mod._parameters.items()):
                    full = f"{prefix}.{name}" if prefix else name
                    mod._parameters[name] = nn.Parameter(DTensor.from_local(
                        p.detach(), mesh, placements[full], run_check=False))
            B = c["batch"]
            data = [{k: DTensor.from_local(t, mesh, to_placements(
                data_specs(t, mesh, B), mesh), run_check=False) for k, t in b.items()}
                for b in batches]

            @contextlib.contextmanager
            def plan_scope():
                with activation_rules(mesh, batch=batch_axes(mesh, B), vocab="model",
                                      heads="model", ff="model", kv_seq="data",
                                      seq_tp="model"), implicit_replication():
                    yield
            planned = run(model, data, plan_scope)
        finally:
            dist.destroy_process_group()
    (g_plain, l_plain, p_plain, n_plain), (g_plan, l_plan, p_plan, n_plan) = \
        plain, planned
    bitwise = l_plain == l_plan and all(torch.equal(p_plain[n], p_plan[n])
                                        for n in p_plain)
    grad_gap = max(float((g_plan[n] - g_plain[n]).abs().max()
                         / g_plain[n].abs().max().clamp(min=1e-30)) for n in g_plain)
    spread = param_spread(p_plan, p_plain)
    off_1e6 = max(float(((p_plan[n] - w).abs() > 1e-6 * w.abs().max()).float().mean())
                  for n, w in p_plain.items())
    want = (2 * cfg.n_layers * c["steps"], cfg.n_layers * c["steps"])
    res = {"plan_step": cfg.name, "mesh": "1x1", "seq": c["seq"], "batch": c["batch"],
           "steps": c["steps"], "losses_plan": l_plan, "losses_plain": l_plain,
           "bitwise": bitwise, "first_grad_gap_over_scale": grad_gap,
           "params_off_1e6_frac_max": off_1e6, **spread,
           "flash_launches_with_lse_plan": n_plan[0],
           "flash_bwd_ref_calls_plan": n_plan[1],
           "flash_launches_with_lse_plain": n_plain[0]}
    log(json.dumps(res))
    if n_plan != want or n_plain != want:
        raise AssertionError(f"phase 14 (b): flash launches with lse / backward "
                             f"calls plan {n_plan}, plain {n_plain}, want {want}")
    # not bit for bit where the embedding's backward sums repeated ids'
    # rows by atomic adds in no fixed order (two plain runs differ alike);
    # AdamW's g / (|g| + eps) then moves elements with near-zero gradients
    # apart by up to ~0.1 lr (phase 11b)
    np.testing.assert_allclose(l_plan, l_plain, rtol=1e-6)
    if not (grad_gap <= 1e-6 and off_1e6 <= 1e-3
            and spread["param_moved_max"] <= c["steps"] * c["lr"]):
        raise AssertionError(f"phase 14 (b): the planned step left the plain one: {res}")
    return res


def start_dryruns() -> list:
    """Phase 14 (c): ``python -m repro_torch.launch.dryrun`` for each of
    DRYRUN_ON_CARD, each in a process of its own (the fake process group
    is process-wide), on the CPU while the card runs (a) and (b)."""
    procs = []
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"), CUDA_VISIBLE_DEVICES="")
    for arch, shape, multi in DRYRUN_ON_CARD:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(DRYRUN_OUT)] + (["--multi-pod"] if multi else [])
        procs.append(((arch, shape, multi), subprocess.Popen(
            cmd, env=env, cwd=str(HERE), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def finish_dryruns(procs: list) -> list:
    """Each dry-run's exit, its JSON (the reference's keys, a positive
    flop count, every memory figure) printed on a line of its own."""
    out = []
    for (arch, shape, multi), proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode:
            raise AssertionError(f"phase 14 (c) dry-run {arch} {shape} multi={multi} "
                                 f"exited {proc.returncode}: {stdout[-2000:]} {stderr[-4000:]}")
        name = f"{arch}__{shape}__{'multi' if multi else 'single'}.json"
        with open(DRYRUN_OUT / name) as f:
            res = json.load(f)
        log(json.dumps({"dryrun_on_card": res}))
        if set(res) != DRYRUN_KEYS or not res["flops_per_device"] > 0 \
                or not res["memory"]["argument_bytes"] > 0:
            raise AssertionError(f"phase 14 (c) dry-run {name}: {res}")
        out.append(res)
    return out


def stop_dryruns(procs: list) -> None:
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------------------ phase 7 ----
SILO_GAMMA = 0.25


def collectives_one_rank(dev, vec: torch.Tensor) -> int:
    """Phase 7 (a): the cross-silo aggregation on a one-rank (1, 1, 1)
    mesh. Returns the block top-k launches of the dense exchanges."""
    from repro_torch.fl import collectives as col
    from repro_torch.kernels.topk_sparsify import ops

    mesh = col.make_silo_mesh(1, 1, 1, device=dev)
    dense = col.make_fl_allreduce(mesh, SILO_GAMMA)
    sparse = col.make_sparse_fl_allreduce(mesh, SILO_GAMMA)
    int8 = col.make_sparse_fl_allreduce(mesh, SILO_GAMMA, quantize=True)
    n, block = vec.numel(), 4096
    padded = torch.nn.functional.pad(vec, (0, -(-n // block) * block - n))
    fns = counters()
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    agg = dense(vec)
    agg_p = dense(padded)
    agg_s, agg_q = sparse(padded), int8(padded)
    norm = col.silo_update_norm(vec, mesh=mesh, axis_names=("data", "model"))
    torch.cuda.synchronize()
    launches = {name: getattr(f, attr) for name, (f, attr) in fns.items()}
    if launches["topk_block"] != 2 or any(
            c for name, c in launches.items() if name != "topk_block"):
        raise AssertionError(f"the dense exchanges launched {launches}, not "
                             "the block top-k twice")
    want = ops.block_topk_sparsify(vec, SILO_GAMMA)[0]
    if not same_bits(agg, want):
        raise AssertionError("make_fl_allreduce on one rank differs from "
                             "block_topk_sparsify")
    err_s = float((agg_s - agg_p).abs().max())
    rel_q = float((agg_q - agg_p).abs().max() / agg_p.abs().max())
    if not (err_s < 1e-6 and rel_q < 0.02):
        raise AssertionError(f"sparse exchange {err_s} (bound 1e-6), int8 "
                             f"{rel_q} (bound 0.02) from the dense one")
    torch.testing.assert_close(norm.double(), torch.linalg.vector_norm(vec.double()),
                               rtol=1e-5, atol=0)
    res = {"collectives_one_rank": {
        "n": n, "gamma": SILO_GAMMA, "launches": launches,
        "sparse_max_abs": err_s, "int8_rel": rel_q,
        "dense_ms": cuda_ms(lambda: dense(vec), 50),
        "sparse_ms": cuda_ms(lambda: sparse(padded), 20),
        "int8_ms": cuda_ms(lambda: int8(padded), 20),
        "dense_bytes": dense.result_bytes, "sparse_bytes": sparse.result_bytes,
        "int8_bytes": int8.result_bytes}}
    log(json.dumps(res))
    return launches["topk_block"]


def sharded_trainer_one_rank(dev, main: dict):
    """Phase 7 (b): the main path's recipe on a one-rank clients mesh,
    against phase 3's main path."""
    from repro_torch.sharding import make_clients_mesh

    tr = paper_trainer(dev, mesh=make_clients_mesh(device=dev))
    fns = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    tr.run_scanned(ROUNDS, verbose=False)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    for name in [n for n in launches if n.startswith("dual_")] + ["topk_rows",
                                                                 "row_sq_sum"]:
        if launches[name] != main["launches"][name]:
            raise AssertionError(f"sharded run launched {name} "
                                 f"{launches[name]} times, the main path "
                                 f"{main['launches'][name]}")
    for a, b in zip(tr.history, main["history"]):
        if not (np.array_equal(a.selected, b.selected)
                and np.array_equal(a.gamma, b.gamma)):
            raise AssertionError(f"sharded round {a.round}: masks or gammas "
                                 "differ from the main path")
        np.testing.assert_allclose(a.energy, b.energy, rtol=1e-5, atol=0)
    p_err = max(float((tr.params[k] - main["params"][k]).abs().max())
                for k in tr.params)
    if not p_err <= 1e-6:
        raise AssertionError(f"sharded params differ from the main path's by "
                             f"{p_err}")
    steady = [lg.wall_s for lg in tr.history[1:]]
    log(json.dumps({"sharded_one_rank": {
        "rounds": ROUNDS, "n_clients": tr.n_clients, "n_local": tr.n_local,
        "launches": launches, "params_max_abs": p_err,
        "round_ms_steady_mean": 1e3 * sum(steady) / len(steady),
        "main_path_round_ms_steady_mean": main["steady_ms"],
        "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}}))
    # C-17 on this card: the step over one of 4 cards' share of the
    # clients (13 a call) against the step over all 50
    client_step_by_card(dev, tr, 4)


def multirank_paths(dev, vec: torch.Tensor, main: dict) -> int:
    """Phase 7 inside a one-rank process group (NCCL on the card)."""
    import tempfile

    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            launches = collectives_one_rank(dev, vec)
            sharded_trainer_one_rank(dev, main)
        finally:
            dist.destroy_process_group()
    return launches


# ----------------------------------------------------------- phase 11 ----
# TinyLlama-1.1B training at full width: train_4k's sequence; its global
# batch of 256 cut to 8 for one card, in 2 microbatches of 4
TRAIN = dict(arch="tinyllama-1.1b", batch=8, seq=4096, microbatches=2,
             lr=3e-4, warmup=1, steps=6)


def _timed(module, name: str, spans: list):
    """Wrap ``module.name`` so that each call records CUDA events around it
    into ``spans`` (this script's attribution only); returns the original."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        spans.append((start, end))
        return out
    setattr(module, name, wrapped)
    return orig


def train_split(step, model, opt, batch, dev) -> dict:
    """One more train step with the flash forward, ``flash_bwd_ref`` and
    AdamW bracketed by CUDA events: each one's device-stream ms and share
    of the step."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import steps
    spans = {"flash_forward": [], "flash_bwd_ref": [], "adamw": []}
    wrapped = [(ops, "flash_attention_cuda", spans["flash_forward"]),
               (ops, "flash_bwd_ref", spans["flash_bwd_ref"]),
               (steps, "adamw_update", spans["adamw"])]
    origs = [_timed(m, n, sp) for m, n, sp in wrapped]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, n, _), orig in zip(wrapped, origs):
            setattr(m, n, orig)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    return {"step_ms": step_ms, "ms": ms,
            "share": {k: v / step_ms for k, v in ms.items()},
            "calls": {k: len(v) for k, v in spans.items()}}


def _device_events(fn):
    """torch.profiler's CUDA kernel events over one call of ``fn``, and
    the call's wall ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    return events, wall * 1e3


def _gemm_ms(events) -> float:
    return sum(e.self_device_time_total for e in events
               if any(t in e.key.lower() for t in ("gemm", "xmma", "cutlass",
                                                    "nvjet"))) / 1e3


def train_profile(step, model, opt, batch, calls: int) -> dict:
    """``--profile``: torch.profiler over one more train step: the GEMM
    kernels' device ms, split into ``flash_bwd_ref``'s (one call profiled
    alone at the step's shape, times its ``calls`` a step) and the rest,
    the dense matmuls (the layers' bf16 GEMMs, the fp32 head); the
    device's busy share and the top kernels."""
    from repro_torch.kernels.flash_attention import ops, ref
    events, wall = _device_events(lambda: step(model, opt, batch))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    gemm = _gemm_ms(events)
    B, S = TRAIN["batch"] // TRAIN["microbatches"], TRAIN["seq"]
    cfg = model.cfg
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=batch["tokens"].device).manual_seed(12)
    q, k, v, dout = (torch.randn(B, S, h, D, device=gen.device, generator=gen)
                     .to(torch.bfloat16) for h in (H, KV, KV, H))
    out, lse = ops.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    bwd_events, _ = _device_events(lambda: ref.flash_bwd_ref(
        q, k, v, out, lse, dout, causal=True))
    bwd_gemm = _gemm_ms(bwd_events) * calls
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "gemm_ms": gemm, "flash_bwd_ref_gemm_ms": bwd_gemm,
            "dense_matmul_ms": gemm - bwd_gemm,
            "dense_matmul_share": (gemm - bwd_gemm) / wall,
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3} for e in top]}


def train_steps(dev, cfg, spec: dict, n_attn: int, extra: int = 0):
    """``launch.steps.build_train_step`` on ``cfg`` (fp32 master weights
    from a seeded generator on the card, ``cfg.dtype`` activations, remat),
    AdamW at ``spec["lr"]``, ``spec["microbatches"]`` microbatches of
    ``launch.train.make_lm_batches``' batches (``spec["batch"]`` x
    ``spec["seq"]`` tokens, and the family's frames or vision
    embeddings): ``spec["warmup"]`` warm-up steps, then ``spec["steps"]``
    timed steps with every count zeroed just before them. Asserts finite
    losses, the last below the first, the bf16 flash kernel launched with
    lse 2 x ``n_attn`` x M times a step (forward and remat recompute of
    the model's ``n_attn`` flash-branch attention calls), ``flash_bwd_ref``
    called ``n_attn`` x M times a step, and no other kernel or flash
    route. Returns (summary, step, model, optimizer state, the ``extra``
    batches after the timed ones)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_lm_batches
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    model = steps.init_for(cfg)(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(dict(model.named_parameters()))
    step = steps.build_train_step(cfg, lr=spec["lr"], microbatches=spec["microbatches"])
    n_steps = spec["warmup"] + spec["steps"] + extra
    batches = list(make_lm_batches(cfg, spec["batch"], spec["seq"], n_steps, device=dev))
    if spec.get("vision_embeds") == "normal":
        # seeded normal vision embeddings where the reference's batches
        # hold zeros: zero rows overflow the gradient at depth (C-26)
        gen = torch.Generator(device=dev).manual_seed(15)
        for b in batches:
            b["extra_embeds"] = torch.randn(b["extra_embeds"].shape, device=dev,
                                            generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train: {cfg.name} {cfg.n_layers} layers, {n_params / 1e9:.3f}B params, "
        f"{cfg.dtype}, remat {cfg.remat}, set-up {time.perf_counter() - t0:.1f} s")
    losses = []
    for b in batches[:spec["warmup"]]:
        losses.append(float(step(model, opt, b)[2]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fns = counters()
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    flash_attention.launches = flash_attention.launches_lse = 0
    flash_attention.backward_calls = 0
    step_ms = []
    for b in batches[spec["warmup"]:spec["warmup"] + spec["steps"]]:
        t1 = time.perf_counter()
        loss = float(step(model, opt, b)[2])        # float() waits for the step
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    routes = {"launches": flash_attention.launches,
              "launches_lse": flash_attention.launches_lse,
              "backward_calls": flash_attention.backward_calls}
    peak = torch.cuda.max_memory_allocated(dev)
    n, M = spec["steps"], spec["microbatches"]
    log(json.dumps({"train_losses": losses, "step_ms": step_ms, "model": cfg.name}))
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg.name}: non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: no learning: {losses[0]} -> {losses[-1]}")
    want = 2 * n_attn * M * n
    if (launches["flash_attention"], routes["launches"], routes["launches_lse"]) \
            != (want, want, want):
        raise AssertionError(f"{cfg.name}: train launched the bf16 flash kernel "
                             f"{launches['flash_attention']} times ({routes}), "
                             f"want {want} with lse")
    if routes["backward_calls"] != n_attn * M * n:
        raise AssertionError(f"{cfg.name}: flash_bwd_ref called "
                             f"{routes['backward_calls']} times, want {n_attn * M * n}")
    others = {k: c for k, c in launches.items() if k != "flash_attention" and c}
    if others:
        raise AssertionError(f"{cfg.name}: train launched other kernels: {others}")
    tokens = spec["batch"] * spec["seq"]
    mean_ms = sum(step_ms) / len(step_ms)
    res = {"train": cfg.name, "layers": cfg.n_layers, "params_B": n_params / 1e9,
           "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": spec["batch"], "seq": spec["seq"],
           "microbatches": M, "lr": spec["lr"], "steps": n,
           "step_ms": step_ms, "step_ms_mean": mean_ms,
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "peak_mem_GB": peak / 1e9, "losses": losses,
           "launches_per_step": {"flash_attention": launches["flash_attention"] / n,
                                 "flash_bwd_ref_calls": routes["backward_calls"] / n}}
    return res, step, model, opt, batches[spec["warmup"] + n:]


def train_path(dev, profile: bool = False) -> dict:
    """Phase 11: ``train_steps`` on TinyLlama-1.1B at full width (22
    layers, d 2048, 32/4 heads, d_ff 5632, vocab 32000; bf16 activations,
    remat on), AdamW at lr 3e-4, microbatches 2, batch 8 x 4096 tokens: 1
    warm-up step, then 6 timed steps, the bf16 flash kernel launched with
    lse 2 x 22 x 2 times a step and ``flash_bwd_ref`` called 22 x 2 times;
    then one more step split by CUDA events (``--profile``: and profiled)."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN["arch"])
    res, step, model, opt, rest = train_steps(dev, cfg, TRAIN, cfg.n_layers,
                                              extra=1 + int(profile))
    res["split"] = train_split(step, model, opt, rest[0], dev)
    if profile:
        res["profile"] = train_profile(step, model, opt, rest[-1],
                                       cfg.n_layers * TRAIN["microbatches"])
    log(json.dumps({"train_summary": res}))
    del model, opt, rest
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------- phase 11b ----
TRAIN_CARD_CPU = dict(batch=2, seq=2048, steps=3, lr=3e-4)


def _train_card_and_cpu(dev, cfg, seq: int) -> dict:
    """``cfg``'s smoke model from seeded weights (generator seed 2) on the
    CPU and a copy on the card, ``make_lm_batches``' batches (seed 4, batch
    2, ``seq`` tokens): each device's first-step gradients, then
    TRAIN_CARD_CPU's AdamW steps on each (the lse launches of each
    counted). Returns the names, gradients, losses, parameters, launches,
    batches and a copy of the initial CPU model."""
    import copy

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_lm_batches
    from repro_torch.optim import adamw_init

    c = TRAIN_CARD_CPU
    loss_fn = steps.loss_for(cfg)
    cpu_model = steps.init_for(cfg)(torch.Generator().manual_seed(2))
    initial = copy.deepcopy(cpu_model)
    card_model = copy.deepcopy(cpu_model).to(dev)
    batches = list(make_lm_batches(cfg, c["batch"], seq, c["steps"],
                                   seed=4, device="cpu"))
    names = [n for n, _ in cpu_model.named_parameters()]

    def on(model, b):
        dv = next(model.parameters()).device
        return {k: t.to(dv) for k, t in b.items()}

    def first_grads(model):
        loss, _ = loss_fn(model, on(model, batches[0]))
        return {n: g.float().cpu() for n, g in zip(
            names, torch.autograd.grad(loss, list(model.parameters())))}

    out = {"names": names, "batches": batches, "initial": initial,
           "g_cpu": first_grads(cpu_model), "g_card": first_grads(card_model)}
    for where, model in (("cuda", card_model), ("cpu", cpu_model)):
        opt = adamw_init(dict(model.named_parameters()))
        step = steps.build_train_step(cfg, lr=c["lr"])
        before = flash_attention.launches_lse
        out[f"losses_{where}"] = [float(step(model, opt, on(model, b))[2])
                                  for b in batches]
        out[f"params_{where}"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        out[f"launches_{where}"] = flash_attention.launches_lse - before
    return out


def train_card_against_cpu(dev, dtype: str) -> dict:
    """Phase 11b: 3 AdamW steps of the smoke TinyLlama in ``dtype`` at
    seq 2048 (the flash branch: the card's kernel of that type with lse,
    ``flash_bwd_ref``), batch 2, on the card and on the CPU from the same
    weights and tokens (``_train_card_and_cpu``). fp32: the first step's
    gradients within 1e-5 of each leaf's scale, losses rtol 1e-5, and the
    parameters after 3 steps within 1e-5 of each leaf's scale but for at
    most 0.1% of a leaf's elements, which stay within 3 lr: AdamW's update
    g / (|g| + 1e-8) turns ~1e-9 gradient differences on elements whose
    gradient is near zero into update differences of up to ~0.1 of lr,
    and the elements they move shift the later steps' gradients. bf16:
    losses within 2e-2."""
    from repro_torch.configs import get_smoke

    cfg = get_smoke(TRAIN["arch"]).replace(dtype=dtype)
    c = TRAIN_CARD_CPU
    r = _train_card_and_cpu(dev, cfg, c["seq"])
    names, g_cpu, g_card = r["names"], r["g_cpu"], r["g_card"]
    grad_err = max(float((g_card[n] - g_cpu[n]).abs().max()
                         / g_cpu[n].abs().max().clamp(min=1e-30)) for n in names)
    l_card, p_card, n_card = r["losses_cuda"], r["params_cuda"], r["launches_cuda"]
    l_cpu, p_cpu, n_cpu = r["losses_cpu"], r["params_cpu"], r["launches_cpu"]
    want_launches = 2 * cfg.n_layers * c["steps"]
    def check_launches():
        if (n_card, n_cpu) != (want_launches, 0):
            raise AssertionError(f"card launched the flash kernel with lse "
                                 f"{n_card} times (want {want_launches}), CPU "
                                 f"{n_cpu}")

    res = {"train_card_vs_cpu": cfg.name, "dtype": dtype, "seq": c["seq"],
           "batch": c["batch"], "steps": c["steps"], "losses_cuda": l_card,
           "losses_cpu": l_cpu, "flash_launches_with_lse": n_card}
    if dtype == "float32":
        res.update(first_grad_err_over_scale=grad_err, **param_spread(p_card, p_cpu))
        log(json.dumps(res))
        check_launches()
        np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
        if not (grad_err <= 1e-5 and res["params_off_1e5_frac_max"] <= 1e-3
                and res["param_moved_max"] <= c["steps"] * c["lr"]):
            raise AssertionError(f"fp32 train params differ card/CPU: {res}")
    else:
        res["loss_max_abs"] = max(abs(a - b) for a, b in zip(l_card, l_cpu))
        log(json.dumps(res))
        check_launches()
        if not res["loss_max_abs"] <= 2e-2:
            raise AssertionError(f"bf16 train losses differ card/CPU by "
                                 f"{res['loss_max_abs']} > 2e-2")
    return res


def param_spread(p_card: dict, p_cpu: dict) -> dict:
    """How far two runs' parameters lie apart: the largest difference over
    each leaf's scale, the largest share (and the count) of a leaf's
    elements beyond 1e-5 of its scale, and the largest difference."""
    off_frac, worst, moved = {}, {}, 0.0
    for k, w in p_cpu.items():
        d = (p_card[k] - w).abs()
        scale = float(w.abs().max())
        off_frac[k] = float((d > 1e-5 * scale).float().mean())
        worst[k] = float(d.max()) / scale
        moved = max(moved, float(d.max()))
    return {"param_err_over_scale_max": max(worst.values()),
            "params_off_1e5_frac_max": max(off_frac.values()),
            "params_off_1e5_count": int(sum(off_frac[k] * p_cpu[k].numel()
                                            for k in p_cpu)),
            "param_moved_max": moved}


# ------------------------------------------- phase 7 across the cards ----
def _card_rank(rank: int, world: int, init: str) -> None:
    """One rank of ``--cards``: card ``rank``, NCCL. (a) the exchanges on a
    (2, world / 2, 1) mesh, each pod's silo update its own seeded draw of
    the CNN's flat update (padded to whole blocks of every shard), against
    the pod mean of ``block_topk_sparsify`` of each pod's shard computed
    on this card; (b) the main path's recipe sharded over every card
    against rank 0's unsharded run."""
    import torch.distributed as dist
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.fl import collectives as col
    from repro_torch.kernels.topk_sparsify import ops
    from repro_torch.sharding import make_clients_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world)
    say = log if rank == 0 else (lambda *a: None)
    try:
        mesh = col.make_silo_mesh(2, world // 2, 1, device=dev)
        n = -(-1_630_090 // (4096 * (world // 2))) * 4096 * (world // 2)
        vecs = [torch.randn(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(100 + p)) * 1e-3 for p in range(2)]
        shards = [col.local_shard(v, mesh) for v in vecs]
        mine = shards[mesh.get_local_rank("pod")]
        fns = counters()
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
        dense = col.make_fl_allreduce(mesh, SILO_GAMMA)
        agg = dense(mine)
        torch.cuda.synchronize()
        launched = fns["topk_block"][0].launches
        want = (ops.block_topk_sparsify(shards[0], SILO_GAMMA)[0]
                + ops.block_topk_sparsify(shards[1], SILO_GAMMA)[0]) / 2
        agg_s = col.make_sparse_fl_allreduce(mesh, SILO_GAMMA)(mine)
        agg_q = col.make_sparse_fl_allreduce(mesh, SILO_GAMMA, quantize=True)(mine)
        err = torch.stack([(agg_s - agg).abs().max(), (agg_q - agg).abs().max(),
                           agg.abs().max()])
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        if launched != 1 or not same_bits(agg, want):
            raise AssertionError(f"rank {rank}: the dense exchange differs from "
                                 f"the pod mean of block_topk_sparsify "
                                 f"(launches {launched})")
        if not (err[0] < 1e-6 and err[1] / err[2] < 0.02):
            raise AssertionError(f"sparse exchanges off: {err.tolist()}")
        say(json.dumps({"cards_collectives": {
            "mesh": [2, world // 2, 1], "n": n, "topk_block_launches": launched,
            "sparse_max_abs": float(err[0]), "int8_rel": float(err[1] / err[2]),
            "dense_ms": cuda_ms(lambda: dense(mine), 20)}}))

        if rank == 0:
            ref = paper_trainer(dev)
            ref.run_scanned(ROUNDS, verbose=False)
        dist.barrier()
        tr = paper_trainer(dev, mesh=make_clients_mesh(device=dev))
        torch.cuda.reset_peak_memory_stats(dev)
        tr.run_scanned(ROUNDS, verbose=False)
        if rank == 0:
            # the numbers first, then the gates, so a failed run still says
            # how far apart the two runs ended
            same = [bool(np.array_equal(a.selected, b.selected)
                         and np.array_equal(a.gamma, b.gamma))
                    for a, b in zip(tr.history, ref.history)]
            e_rel = max(float(np.max(np.abs(a.energy - b.energy)
                                     / np.maximum(b.energy, 1e-30)))
                        for a, b in zip(tr.history, ref.history))
            p_err = max(float((tr.params[k] - ref.params[k]).abs().max())
                        for k in tr.params)
            steady = lambda h: 1e3 * sum(lg.wall_s for lg in h[1:]) / (len(h) - 1)  # noqa: E731
            say(json.dumps({"cards_sharded": {
                "cards": world, "n_padded": tr.n_padded, "n_local": tr.n_local,
                "masks_gammas_equal_by_round": same,
                "sparsified_rows_by_round": [
                    int((b.selected & (b.gamma < 1.0)).sum()) for b in ref.history],
                "params_max_abs": p_err, "energy_max_rel": e_rel,
                "round_ms_steady_mean": steady(tr.history),
                "one_card_round_ms_steady_mean": steady(ref.history),
                "peak_mem_GB_rank0": torch.cuda.max_memory_allocated(dev) / 1e9}}))
            client_step_by_card(dev, ref, world)
            for a, b, eq in zip(tr.history, ref.history, same):
                if not eq:
                    who = np.nonzero((a.selected != b.selected)
                                     | (a.gamma != b.gamma))[0]
                    raise AssertionError(
                        f"{world}-card round {a.round}: masks or gammas differ "
                        f"from one card at clients {who.tolist()}")
                np.testing.assert_allclose(a.energy, b.energy, rtol=1e-5, atol=0)
            if not p_err <= 1e-6:
                raise AssertionError(f"{world}-card params differ by {p_err}")
        dist.barrier()
        del tr
        if rank == 0:
            del ref
        for scenario in ("straggler", "byzantine-lite"):
            robust_sharded(dev, rank, world, scenario, say)
        hierarchy_sharded(dev, rank, world, say)
        cli_sharded_cards(dev, rank, world, say)
        sharded_n800(dev, rank, world, say)
    except BaseException:
        # the other ranks wait in a collective that this one will not reach,
        # and tearing the group down would wait for them: say why and leave,
        # so that spawn ends the others and the run fails
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def robust_sharded(dev, rank: int, world: int, scenario: str, say) -> None:
    """Phase 7b across the cards: a timed or fault scenario's ``ROUNDS``
    rounds sharded over every card (the stale buffer as each rank's rows;
    the clip's norms and the trimmed mean's matrix gathered) against rank
    0's one-card run: masks, made, stale and rejected counts exactly
    equal, params within 1e-6."""
    import torch.distributed as dist
    from repro_torch.sharding import make_clients_mesh
    if rank == 0:
        one = robust_trainer(dev, scenario)
        one.run_scanned(ROUNDS, verbose=False)
    dist.barrier()
    tr = robust_trainer(dev, scenario, mesh=make_clients_mesh(device=dev))
    tr.run_scanned(ROUNDS, verbose=False)
    if rank == 0:
        fields = ("selected", "made", "n_stale", "n_rejected")
        same = {f: [bool(np.array_equal(getattr(a, f), getattr(b, f)))
                    for a, b in zip(tr.history, one.history)] for f in fields}
        p_err = max(float((tr.params[k] - one.params[k]).abs().max())
                    for k in tr.params)
        e_rel = max(float(np.max(np.abs(a.energy - b.energy)
                                 / np.maximum(b.energy, 1e-30)))
                    for a, b in zip(tr.history, one.history))
        steady = lambda h: 1e3 * sum(lg.wall_s for lg in h[1:]) / (len(h) - 1)  # noqa: E731
        say(json.dumps({"cards_robust": {
            "scenario": scenario, "cards": world, "n_local": tr.n_local,
            "equal_by_round": same, "params_max_abs": p_err,
            "energy_max_rel": e_rel,
            "n_stale": [lg.n_stale for lg in one.history],
            "n_rejected": [lg.n_rejected for lg in one.history],
            "round_ms_steady_mean": steady(tr.history),
            "one_card_round_ms_steady_mean": steady(one.history),
            "peak_mem_GB_rank0": torch.cuda.max_memory_allocated(dev) / 1e9}}))
        for f, eq in same.items():
            if not all(eq):
                raise AssertionError(f"{world}-card {scenario}: {f} differs "
                                     f"from one card in rounds "
                                     f"{[i for i, e in enumerate(eq) if not e]}")
        if not p_err <= 1e-6:
            raise AssertionError(f"{world}-card {scenario} params differ by "
                                 f"{p_err}")
    dist.barrier()


HIER_SHARDED = dict(n_clients=N_CLIENTS, clusters=4, pool_frac=0.25)
HIER_SHARDED_ROUNDS = 10


def hierarchy_sharded(dev, rank: int, world: int, say) -> None:
    """7c: phase 10 (b)'s recipe (clusters 4, pool_frac 0.25, K_pool 12)
    on the (2, world / 2) ``(clusters, clients)`` hierarchy mesh, its
    all-reduces in two stages, against rank 0's one-card run: the pool of
    every round, the cluster assignment, masks and params equal bit for
    bit; the round ms of both."""
    import torch.distributed as dist
    from repro_torch.launch.experiments import build
    from repro_torch.sharding import make_hierarchy_mesh
    make, _ = build(rounds=HIER_SHARDED_ROUNDS, seed=0, device=dev,
                    **HIER_SHARDED)
    if rank == 0:
        one = make("fairenergy")
        one_pools = record_pools(one)
        one.run_scanned(HIER_SHARDED_ROUNDS, verbose=False)
    dist.barrier()
    mesh = make_hierarchy_mesh(2, device=dev)
    tr = make("fairenergy", mesh=mesh)
    pools = record_pools(tr)
    tr.run_scanned(HIER_SHARDED_ROUNDS, verbose=False)
    if rank == 0:
        same = {
            "pools": len(pools) == len(one_pools) == HIER_SHARDED_ROUNDS
            and all(torch.equal(a, b) for a, b in zip(pools, one_pools)),
            "assign": torch.equal(tr.ctrl_state.assign, one.ctrl_state.assign),
            "masks": all(np.array_equal(a.selected, b.selected)
                         for a, b in zip(tr.history, one.history)),
            "params": all(torch.equal(tr.params[k], one.params[k])
                          for k in tr.params)}
        steady = lambda h: 1e3 * sum(lg.wall_s for lg in h[1:]) / (len(h) - 1)  # noqa: E731
        say(json.dumps({"cards_hierarchy": {
            "mesh": list(mesh.shape), "mesh_dims": list(mesh.mesh_dim_names),
            "rounds": HIER_SHARDED_ROUNDS, "n_local": tr.n_local,
            "k_pool": tr.controller.k_pool, "equal": same,
            "energy_max_rel": max(float(np.max(np.abs(a.energy - b.energy)
                                               / np.maximum(b.energy, 1e-30)))
                                  for a, b in zip(tr.history, one.history)),
            "round_ms_steady_mean": steady(tr.history),
            "one_card_round_ms_steady_mean": steady(one.history)}}))
        bad = [k for k, v in same.items() if not v]
        if bad:
            raise AssertionError(f"{world}-card hierarchy mesh: {bad} differ "
                                 f"from one card")
    dist.barrier()


def cli_sharded_cards(dev, rank: int, world: int, say) -> None:
    """7d: ``launch.experiments.cli --shard-clients`` inside the cards'
    process group (every rank runs ``run_all`` on a clients mesh, rank 0
    writes the JSON) at the paper's N = 50, CLI_ROUNDS rounds, against
    the unsharded CLI on rank 0's card: the JSONs equal but for the wall
    time (C-17)."""
    import torch.distributed as dist
    from repro_torch.launch import experiments
    argv = ["--clients", str(N_CLIENTS), "--rounds", str(CLI_ROUNDS)]
    t0 = time.perf_counter()
    experiments.cli(argv + ["--out", str(CLI_OUT / "cards_cli_sharded.json"),
                            "--shard-clients"])
    sharded_s = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        experiments.cli(argv + ["--out", str(CLI_OUT / "cards_cli_plain.json"),
                                "--device", str(dev)])
        plain_s = time.perf_counter() - t0
        same = (_cli_json(CLI_OUT / "cards_cli_sharded.json")
                == _cli_json(CLI_OUT / "cards_cli_plain.json"))
        say(json.dumps({"cards_cli_shard_clients": {
            "cards": world, "n_clients": N_CLIENTS, "rounds": CLI_ROUNDS,
            "json_equal": same, "wall_s_sharded": sharded_s,
            "wall_s_one_card": plain_s}}))
        if not same:
            raise AssertionError(f"--shard-clients over {world} cards wrote "
                                 "another JSON than one card")
    dist.barrier()


# the reference's sharded_engine_bench size (ROADMAP A-18): N = 800 over
# Fashion-MNIST's 60,000 training images (12,000 do not partition at
# Dirichlet 0.3 for N >= 1,000; phase 10 (c))
N800 = dict(n_clients=800, n_train=60_000, rounds=5)


def sharded_n800(dev, rank: int, world: int, say) -> None:
    """7e: the main path's recipe at N = 800 sharded over the cards (200
    clients a card) against rank 0's one-card run: masks and gammas equal,
    energies rtol 1e-5, params within 1e-6, and each run's steady round
    ms and peak memory."""
    import torch.distributed as dist
    from repro_torch.launch.experiments import build
    from repro_torch.sharding import make_clients_mesh
    make, _ = build(n_clients=N800["n_clients"], rounds=N800["rounds"],
                    n_train=N800["n_train"], seed=0, device=dev)
    steady = lambda h: 1e3 * sum(lg.wall_s for lg in h[1:]) / (len(h) - 1)  # noqa: E731
    if rank == 0:
        torch.cuda.reset_peak_memory_stats(dev)
        one = make("fairenergy")
        one.run_scanned(N800["rounds"], verbose=False)
        one_peak = torch.cuda.max_memory_allocated(dev)
        one_hist, one_params = one.history, one.params
        del one
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = make("fairenergy", mesh=make_clients_mesh(device=dev))
    tr.run_scanned(N800["rounds"], verbose=False)
    if rank == 0:
        same = [bool(np.array_equal(a.selected, b.selected)
                     and np.array_equal(a.gamma, b.gamma))
                for a, b in zip(tr.history, one_hist)]
        p_err = max(float((tr.params[k] - one_params[k]).abs().max())
                    for k in tr.params)
        say(json.dumps({"cards_n800": {
            "cards": world, "n_clients": tr.n_clients, "n_local": tr.n_local,
            "rounds": N800["rounds"], "masks_gammas_equal_by_round": same,
            "params_max_abs": p_err,
            "round_ms_steady_mean": steady(tr.history),
            "round_ms_by_round": [lg.wall_s * 1e3 for lg in tr.history],
            "one_card_round_ms_steady_mean": steady(one_hist),
            "one_card_round_ms_by_round": [lg.wall_s * 1e3 for lg in one_hist],
            "peak_mem_GB_rank0": torch.cuda.max_memory_allocated(dev) / 1e9,
            "one_card_peak_mem_GB": one_peak / 1e9}}))
        if not all(same):
            raise AssertionError(f"{world}-card N = 800: masks or gammas differ "
                                 f"from one card by round: {same}")
        for a, b in zip(tr.history, one_hist):
            np.testing.assert_allclose(a.energy, b.energy, rtol=1e-5, atol=0)
        if not p_err <= 1e-6:
            raise AssertionError(f"{world}-card N = 800 params differ by {p_err}")
    dist.barrier()


# chunk sizes of the client step timed beside the module's CLIENT_CHUNK
CHUNK_SWEEP = (1, 5, 10, 13, 25, 50)


def _step_apart(tr, batches, n_local: int, dev) -> dict:
    """The client step over ``n_local`` clients a call against the same
    clients' rows of one step over all of them, at the client module's
    current CLIENT_CHUNK, and the top-k lanes that move with it at the main
    path's k for gamma 0.1 (410)."""
    from repro_torch.kernels.topk_sparsify import ops
    whole, norms, losses = tr._client_step(tr.params, batches)
    again = tr._client_step(tr.params, batches)[0]
    parts = [tr._client_step(tr.params, {k: v[i:i + n_local]
                                         for k, v in batches.items()})
             for i in range(0, tr.n_clients, n_local)]
    split, split_norms, split_losses = (torch.cat([p[j] for p in parts])
                                        for j in range(3))
    ks = torch.full((tr.n_clients,), 410, dtype=torch.int32, device=dev)
    moved = (ops.block_topk_rows(whole, ks) != 0) != (
        ops.block_topk_rows(split, ks) != 0)
    return {"update_lanes_differ": int((split != whole).sum()),
            "repeat_lanes_differ": int((again != whole).sum()),
            "update_max_abs": float((split - whole).abs().max()),
            "norms_differ": int((split_norms != norms).sum()),
            "losses_differ": int((split_losses != losses).sum()),
            "topk_lanes_moved_at_k410": int(moved.sum())}


def client_step_by_card(dev, tr, world: int) -> dict:
    """C-17's gate. The client step on one card's share of the clients
    (the sharded trainer's n_local a card when ``world`` cards share them)
    against the same clients' rows of one step over all of them, at
    ``tr``'s params and round 0's batches, on this card (no collective):
    no update lane may differ, none may differ between two calls of the same
    step, no norm or loss may differ, and no top-k lane may move at the
    main path's k for gamma 0.1 (410). The sharded run and the one-card run would differ by this much
    before any collective. Also the step's device time at each chunk size of
    CHUNK_SWEEP (CUDA events, one step over all clients), and whether each
    size would hold the gate: the measurement behind CLIENT_CHUNK."""
    from repro_torch.fl import client
    n_local = -(-tr.n_clients // world)
    chosen = client.CLIENT_CHUNK
    sweep = {}
    with torch.no_grad():
        batches = tr._round_batches(0, tr.keys.sample)
        res = _step_apart(tr, batches, n_local, dev)
        try:
            for c in CHUNK_SWEEP:
                client.CLIENT_CHUNK = c
                apart = _step_apart(tr, batches, n_local, dev)
                sweep[c] = {"step_ms": cuda_ms(lambda: tr._client_step(tr.params, batches),
                                               5, warmup=1),
                            **{k: apart[k] for k in ("update_lanes_differ",
                                                     "repeat_lanes_differ",
                                                     "norms_differ")}}
        finally:
            client.CLIENT_CHUNK = chosen
    res = {"clients": tr.n_clients, "a_call": n_local, "client_chunk": chosen,
           **res, "update_lanes": tr.n_clients * tr.n_params,
           "step_ms_by_chunk": sweep}
    log(json.dumps({"client_step_by_card": res}))
    if any(res[k] for k in ("update_lanes_differ", "repeat_lanes_differ",
                            "norms_differ", "losses_differ",
                            "topk_lanes_moved_at_k410")):
        raise AssertionError(f"the client step depends on the clients a call "
                             f"(C-17): {res}")
    return res


def multicard(world: int) -> None:
    """``--cards K``: phase 7 across K cards (one rank a card) and nothing
    else: the collectives and the sharded trainer, each against its
    one-card result."""
    import tempfile
    if world < 2 or world % 2 or world > torch.cuda.device_count():
        raise SystemExit(f"--cards {world}: need an even count of at least 2 "
                         f"of the {torch.cuda.device_count()} visible cards")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_card_rank, args=(world, f"file://{tmp}/store"),
                                    nprocs=world, join=True)


def check_l2_norm(dev, flat: torch.Tensor) -> dict:
    """Phase 16 (b): ``l2_norm`` (the norms kernel on one vector) on the
    card against ``l2_norm_ref`` and the reference's block rule
    (``l2_norm_blocks``), fp32 rtol 1e-6, on the CNN's flat update and on
    vectors of 1, 100 and 300,001 lanes; on the flat update timed on the
    device beside its bound, the plain version and ``vector_norm``."""
    from repro_torch.kernels.score_norm import ops, ref
    gen = torch.Generator(device=dev).manual_seed(16)
    errs = {}
    for n in (1, 100, 300_001, flat.numel()):
        v = flat if n == flat.numel() else torch.randn(n, device=dev, generator=gen)
        got = ops.l2_norm(v)
        for name, want in (("ref", ref.l2_norm_ref(v)),
                           ("blocks", ref.l2_norm_blocks(v))):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            errs[f"{n}_{name}"] = float(abs(got - want) / want)
    ms, timer = kernel_ms(lambda: ops.l2_norm(flat), "_sq_sum_rows", 20)
    plain = cuda_ms(lambda: ref.l2_norm_blocks(flat), 20)
    lib = cuda_ms(lambda: torch.linalg.vector_norm(flat), 20)
    b_ms, b_by = bound(4 * flat.numel() + 4, 2 * flat.numel())
    out = {"ms": ms, "timer": timer, "plain_ms": plain, "library_ms": lib,
           "bound_ms": b_ms, "bound_by": b_by, "rel_err": errs}
    log(json.dumps({"l2_norm": out}))
    return out


def _golden_mlp_trainer(dev, gamma_grid=None):
    """The golden MLP on ``dev``: the draws of the reference's
    ``tests/test_scan_engine.make_trainer`` (N = 8 clients of 40 + 7 i
    examples, a 16-24-5 tanh MLP, 128 eval examples), whose 12 rounds
    ``tests/golden/fairenergy_main_12round.json`` pins; ``gamma_grid``
    replaces the solver's grid."""
    from repro_torch.configs import ChannelConfig, FairEnergyConfig, FLConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.fl import FederatedTrainer
    rng = np.random.default_rng(7)
    params = {"w1": rng.normal(size=(16, 24)).astype(np.float32) * 0.1,
              "w2": rng.normal(size=(24, 5)).astype(np.float32) * 0.1}
    datasets = [{"x": rng.normal(size=(40 + 7 * i, 16)).astype(np.float32),
                 "y": rng.integers(0, 5, size=40 + 7 * i)} for i in range(8)]
    tx = torch.tensor(rng.normal(size=(128, 16)).astype(np.float32), device=dev)
    ty = torch.tensor(rng.integers(0, 5, size=128), device=dev)

    def loss_fn(p, batch):
        hid = torch.tanh(batch["x"] @ p["w1"])
        ll = torch.log_softmax(hid @ p["w2"], dim=-1)
        return -torch.mean(torch.gather(ll, 1, batch["y"][:, None])), {}

    def eval_fn(p):
        lg = torch.tanh(tx @ p["w1"]) @ p["w2"]
        return torch.mean((torch.argmax(lg, -1) == ty).to(torch.float32))

    fe = (FairEnergyConfig(gamma_grid=gamma_grid) if gamma_grid
          else FairEnergyConfig())
    return FederatedTrainer(
        model_loss=loss_fn, model_params=params_from_numpy(params, device=dev),
        client_datasets=datasets, eval_fn=eval_fn,
        fl_cfg=FLConfig(local_steps=2, local_batch=16, lr=0.05), fe_cfg=fe,
        ch_cfg=ChannelConfig(n_clients=8), device=dev)


def engines_card_against_cpu(dev) -> dict:
    """Phase 16 (c): ``make_scan_engine`` on the golden MLP, 12 rounds on
    the card and on the CPU, at the default block (held to the golden
    file too) and at ``block=1024`` on a grid without 1.0, so that every
    selected update is sparsified: masks and gammas equal, bandwidths and
    energies rtol 1e-4 (the main path's card-against-CPU gate), accuracy
    within one of 128 eval examples. The card run's launch counts are
    zeroed just before it and read after: one fused ascent, one norms and
    one rows launch a round (the all-full skip copies inside the kernel).
    Then one
    ``make_round_engine`` round at ``block=1024`` on both devices from the
    same updates."""
    from repro_torch import random as prng
    from repro_torch.core.channel import round_gains
    from repro_torch.fl.server import make_round_engine, make_scan_engine
    cpu = torch.device("cpu")
    golden = json.loads((HERE / "tests" / "golden"
                         / "fairenergy_main_12round.json").read_text())
    fns = counters()
    report = {}
    for block, grid in ((4096, None), (1024, (0.1, 0.25, 0.5))):
        outs = {}
        for name, d in (("cuda", dev), ("cpu", cpu)):
            tr = _golden_mlp_trainer(d, grid)
            tr._maybe_calibrate(0)
            scan = make_scan_engine(**tr._engine_kwargs(), block=block)
            for fn, attr in fns.values():
                setattr(fn, attr, 0)
            _, *_, o = scan(tr.params, tr.ctrl_state, tr._battery, tr._astate,
                            tr._fstate, tr._lstate, tr._data, tr.keys, 0, 11,
                            1, 12)
            if name == "cuda":
                torch.cuda.synchronize()
                launches = {k: getattr(fn, attr) for k, (fn, attr) in fns.items()}
            outs[name] = {k: v.cpu().numpy() for k, v in o.items()}
        c, h = outs["cuda"], outs["cpu"]
        for k in ("x", "gamma"):
            if not np.array_equal(c[k], h[k]):
                raise AssertionError(f"engine block {block}: {k} differs card "
                                     f"against CPU:\n{c[k]}\n{h[k]}")
        for k in ("bandwidth", "energy"):
            np.testing.assert_allclose(c[k], h[k], rtol=1e-4, atol=0,
                                       err_msg=f"engine block {block} {k}")
        if np.abs(c["accuracy"] - h["accuracy"]).max() > 1 / 128 + 1e-9:
            raise AssertionError(f"engine block {block}: accuracy apart")
        sparsified = int(((c["gamma"] > 0) & (c["gamma"] < 1)).any(1).sum())
        want = {"dual_ascent": 12, "row_sq_sum": 12, "topk_rows": 12}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"engine block {block}: launches {got}, "
                                 f"expected {want}")
        if block == 4096:
            np.testing.assert_array_equal(c["x"].astype(int), golden["selected"])
            np.testing.assert_array_equal(c["gamma"],
                                          np.float32(golden["gamma"]))
            np.testing.assert_allclose(c["energy"], golden["energy"],
                                       rtol=1e-4, atol=0)
        elif sparsified == 0:
            raise AssertionError("the block-1024 engine run sparsified nothing")
        report[block] = {"launches": got, "sparsified_rounds": sparsified,
                         "energy_rel": float(np.max(np.abs(c["energy"] - h["energy"])
                                                    / np.maximum(h["energy"], 1e-30)))}
        log(json.dumps({"engine_card_vs_cpu": block, **report[block]}))
    # one make_round_engine round at block 1024 from the same updates
    rng = np.random.default_rng(16)
    updates = (rng.normal(size=(8, 504)) * 1e-2).astype(np.float32)
    u_norms = np.sqrt((updates.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    res = {}
    for name, d in (("cuda", dev), ("cpu", cpu)):
        tr = _golden_mlp_trainer(d, (0.1, 0.25, 0.5))
        tr._maybe_calibrate(0)
        kw = tr._engine_kwargs()
        core = make_round_engine(block=1024, **{k: kw[k] for k in (
            "controller", "spec", "weights", "server_lr", "fault_rt",
            "aggregator", "physics")})
        h3 = round_gains(tr.keys.fade, tr._pathloss, 3, tr.ch_cfg.rayleigh).to(d)
        p, dec, _, _ = core(tr.params, torch.tensor(updates, device=d),
                            torch.tensor(u_norms, device=d), h3, tr._P, 3,
                            prng.fold_in(tr.keys.ctrl, 3), tr.ctrl_state,
                            tr._battery.clone())
        res[name] = {"dec": dec, "params": p}
    dc, dh = res["cuda"]["dec"], res["cpu"]["dec"]
    if not (torch.equal(dc.x.cpu(), dh.x) and torch.equal(dc.gamma.cpu(), dh.gamma)):
        raise AssertionError(f"round engine at block 1024: decisions differ "
                             f"card against CPU: {dc.x} {dh.x}")
    for k, v in res["cpu"]["params"].items():
        torch.testing.assert_close(res["cuda"]["params"][k].cpu(), v,
                                   rtol=1e-5, atol=1e-7)
    log(json.dumps({"round_engine_card_vs_cpu": 1024,
                    "selected": int(dh.x.sum()),
                    "sparsified": int(((dh.gamma > 0) & (dh.gamma < 1)).sum())}))
    return report


def phase16(dev, kernels) -> None:
    """(a) both top-k kernels at every width of ``TOPK_WIDTHS`` against
    their plain versions, each width timed; (b) ``l2_norm`` against its
    plain versions; (c) the engine factories card against CPU. With
    ``kernels`` (phase 2's entries) the results go into the top-k and
    norms entries."""
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn(N_CLIENTS, 1_630_090, device=dev, generator=gen) * 1e-3
    flat = mat[0].clone()
    widths = check_topk_widths(dev, mat, flat)
    del mat
    norm = check_l2_norm(dev, flat)
    engines = engines_card_against_cpu(dev)
    if kernels is not None:
        for k in kernels:
            if k["name"] == "topk_rows":
                k["widths"] = widths["rows"]
                k["launches_phase16c"] = {b: r["launches"]["topk_rows"]
                                          for b, r in engines.items()}
            elif k["name"] == "topk_block":
                k["widths"] = widths["block"]
            elif k["name"] == "row_sq_sum":
                k["l2_norm"] = norm


# ----------------------------------------------------------- phase 17 ----
# (a) head dims past 256, each at three calls (B, S, H, KV, causal, window,
# Skv): causal GQA, a window, and cross-attention (Skv != Sq, non-causal);
# each D timed at the serve shape [4, 2048, 32 | 4, D]
WIDE_DIMS = (264, 288, 300, 320, 384, 512, 1024)
WIDE_CASES = ((1, 600, 8, 2, True, None, None),
              (1, 700, 8, 4, True, 128, None),
              (1, 400, 8, 2, False, None, 333))
WIDE_TIMED = (4, 2048, 32, 4)
# timed calls a D: fp32 calls take 20-136 ms at the serve shape past 256,
# and SDPA's math backend, beside the 16-bit ones, 22-54 ms
WIDE_TIMED_ITERS = {torch.float32: 5, torch.bfloat16: 10, torch.float16: 10}
# fp32 also at the 3xTF32 kernel's largest cluster (8 groups of 256) and
# past it, on the split route (9 and 17 groups); bf16 and fp16 at the
# tensor-core kernel's largest cluster (8 groups of 224) and past it, on
# the split route; each held as WIDE_DIMS and timed
F32_EDGE_DIMS = (2048, 2056, 4104)
SM90_EDGE_DIMS = (1792, 1800, 3600)
# the split route held at WIDE_TIMED, where its scores (2 GiB) take two
# pieces of its workspace: (dtype, D)
SPLIT_PIECES_CASES = ((torch.float32, 2056), (torch.bfloat16, 1800))
# (b) fp16 at the head dims of the port's models, the same three calls
F16_DIMS = (64, 80, 128, 256)
# (c) the smoke TinyLlama at head_dim 512 (no config of the port has it),
# cut to one of its two layers: its CPU side, train steps at 2 x 2,048
# tokens, took 95 s at both on the card's host
HEAD_DIM_512 = dict(arch="tinyllama-1.1b", head_dim=512, n_layers=1)
# (e) the fp16 block top-k's widths
F16_TOPK_WIDTHS = (256, 4096, 65536)
# (f) B * H = 65,600 on grid x (past 65,535, where the wrapper's old check
# stopped, ROADMAP C-30): B, S, H, KV, D
GRID_X_CASE = (2050, 128, 32, 32, 32)
# (g) the smoke TinyLlama at a head dim past both clusters' reach, one of
# its two layers
HEAD_DIM_SPLIT = dict(arch="tinyllama-1.1b", head_dim=2056, n_layers=1)
PEAK = {torch.float32: PEAK_FP32_S, torch.bfloat16: PEAK_BF16_S,
        torch.float16: PEAK_BF16_S}      # fp16's dense tensor-core rate is bf16's


def hold_flash_cases(dev, dt, dims, seed: int) -> dict:
    """The kernel of ``dt`` at each head dim of ``dims`` on WIDE_CASES
    against ``attention_ref`` (out) and ``flash_fwd_ref`` (lse), under
    FLASH_ATOL / FLASH_LSE_ATOL: each call launches the route of ``dt`` and
    of the head dim (``ops.f32_route``, ``ops.sm90_route``) twice (out; out
    and lse) and nothing else, and out is the same both times. Returns the
    largest errors."""
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    err = lse_err = 0.0
    for D in dims:
        # also the counter of the head dim's route
        route = (ops.F32_ROUTE_COUNTERS[ops.f32_route(-(-D // 4) * 4)]
                 if dt == torch.float32 else
                 ops.SM90_ROUTE_COUNTERS[ops.sm90_route(-(-D // 8) * 8)])
        counters = [ops._ROUTES[dt][2], route]
        for B, S, H, KV, causal, window, Skv in WIDE_CASES:
            Skv = Skv or S
            q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
            k = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
            v = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
            before = [fa.launches] + [getattr(fa, c) for c in counters]
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            got_l, lse = ops.flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window, with_lse=True)
            routed = tuple(n - b for n, b in zip(
                [fa.launches] + [getattr(fa, c) for c in counters], before))
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            _, lse_want = ref.flash_fwd_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            e_lse = float((lse - lse_want).abs().max())
            case = [B, S, H, KV, D, str(dt), causal, window, Skv]
            log(json.dumps({"phase17_flash_case": case, "max_abs_err": e,
                            "lse_max_abs_err": e_lse, "launches": routed}))
            if set(routed) != {2}:
                raise AssertionError(f"phase 17: {case} launched {routed} "
                                     f"(all, {counters}), want 2 each")
            if not (e <= FLASH_ATOL[dt] and e_lse <= FLASH_LSE_ATOL[dt]
                    and torch.equal(got, got_l)):
                raise AssertionError(f"phase 17: the kernel differs from its plain "
                                     f"version at {case}: out {e}, lse {e_lse}")
            err, lse_err = max(err, e), max(lse_err, e_lse)
    return {"max_abs_err": err, "lse_max_abs_err": lse_err}


def time_flash_dims(dev, dt, dims) -> dict:
    """The kernel of ``dt`` at the serve shape ``WIDE_TIMED`` and each D of
    ``dims`` (time_flash: beside its bound, the plain version, SDPA and
    SDPA's backend)."""
    B, S, H, KV = WIDE_TIMED
    out = {}
    for D in dims:
        gen = torch.Generator(device=dev).manual_seed(D)
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(dt)
                   for n in (H, KV, KV))
        out[D] = time_flash(q, k, v, PEAK[dt], iters=WIDE_TIMED_ITERS[dt])
        del q, k, v
    return out


def hold_split_pieces(dev) -> dict:
    """The split route at WIDE_TIMED for each of SPLIT_PIECES_CASES, one
    call with lse, in at least two pieces of its workspace
    (``ops.split_pieces``, each counted on ``flash_attention.split_pieces``),
    against ``attention_ref`` (out) and ``flash_fwd_ref`` (lse) under
    FLASH_ATOL / FLASH_LSE_ATOL."""
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention
    B, S, H, KV = WIDE_TIMED
    out = {}
    for dt, D in SPLIT_PIECES_CASES:
        gen = torch.Generator(device=dev).manual_seed(D + 1)
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(dt)
                   for n in (H, KV, KV))
        pieces = len(ops.split_pieces(B, H, S, S))
        before = (fa.split_pieces, fa.launches)
        got, lse = ops.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        counted = (fa.split_pieces - before[0], fa.launches - before[1])
        want = ref.attention_ref(q, k, v, causal=True)
        e = float((got.float() - want.float()).abs().max())
        del want
        _, lse_want = ref.flash_fwd_ref(q, k, v, causal=True)
        e_lse = float((lse - lse_want).abs().max())
        case = [B, S, H, KV, D, str(dt)]
        log(json.dumps({"phase17_split_pieces": case, "pieces": counted[0],
                        "max_abs_err": e, "lse_max_abs_err": e_lse}))
        if pieces < 2 or counted != (pieces, 1):
            raise AssertionError(f"phase 17: the split route at {case} ran "
                                 f"{counted} (pieces, calls), want ({pieces}, 1)")
        if not (e <= FLASH_ATOL[dt] and e_lse <= FLASH_LSE_ATOL[dt]):
            raise AssertionError(f"phase 17: the split route differs from its plain "
                                 f"version at {case}: out {e}, lse {e_lse}")
        out[str(dt)] = {"D": D, "pieces": counted[0], "max_abs_err": e,
                        "lse_max_abs_err": e_lse}
        del q, k, v, got, lse, lse_want
    return out


def check_topk_block_f16(dev) -> dict:
    """(e) The block top-k in fp16 against its plain version bit for bit at
    F16_TOPK_WIDTHS, on phase 2's tricky rows and two of phase 16's CNN-wide
    tricky rows (NaN, +-Inf, -0.0, ties), in fp16, with fp16's own edge
    lanes: subnormals (normal in fp32, so they compare by value), a
    signalling NaN, the all-ones NaN 0x7fff and one starting off a 16-byte
    word. The plain version runs on the card's copy and on the CPU copy,
    the reference's platform: both widen a NaN quiet with its payload kept
    (``ref.widen_f16``), as the kernel does."""
    from repro_torch.kernels.topk_sparsify import ops, ref
    short = _tricky_rows(dev)[0].flatten().half()
    long = _long_tricky(dev)[1:3].flatten().half()
    gen = torch.Generator().manual_seed(17)
    for vec in (short, long):
        bits = vec.view(torch.int16)
        n = vec.numel()
        sub = torch.randint(1, 1024, (n // 9,), generator=gen, dtype=torch.int16)
        bits[::9][:n // 9] = sub.to(dev)
        bits[5], bits[7], bits[11] = 0x7C01, 0x7FFF, -1023       # sNaN, 0x7fff, 0xfc01
    out = {}
    launches = ops.block_topk_sparsify.launches
    for name, vec in (("tricky", short), ("cnn_tricky", long), ("off_word", short[3:])):
        for w in F16_TOPK_WIDTHS:
            for gamma in (0.1, 0.5):
                got, k = ops.block_topk_sparsify(vec, gamma, block=w)
                want, k_ref = ref.block_topk_ref(vec.cpu(), gamma, block=w)
                on_card = ref.block_topk_ref(vec, gamma, block=w)[0].cpu()
                same = (torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
                        and torch.equal(on_card.view(torch.int16), want.view(torch.int16)))
                log(json.dumps({"topk_block_f16_case": [name, vec.numel(), w, gamma, k],
                                "bit_identical": same}))
                if k != k_ref or not same:
                    raise AssertionError(f"phase 17 (e): the fp16 block top-k differs "
                                         f"from its plain version: {name} w={w} "
                                         f"gamma={gamma}")
        out[name] = vec.numel()
    out["launches"] = ops.block_topk_sparsify.launches - launches
    if out["launches"] != 3 * len(F16_TOPK_WIDTHS) * 2:
        raise AssertionError(f"phase 17 (e): {out['launches']} block top-k launches")
    return out


def check_grid_x(dev) -> dict:
    """(f) One launch with B * H = 65,600 in bf16 and in fp32 against the
    plain version on its last 3 batch rows (all rows run the same code)."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, KV, D = GRID_X_CASE
    gen = torch.Generator(device=dev).manual_seed(29)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(dt)
                   for n in (H, KV, KV))
        before = ops.flash_attention.launches
        got = ops.flash_attention_cuda(q, k, v, causal=True)
        want = ref.attention_ref(q[-3:], k[-3:], v[-3:], causal=True)
        first = ref.attention_ref(q[:2], k[:2], v[:2], causal=True)
        torch.cuda.synchronize()
        e = max(float((got[-3:].float() - want.float()).abs().max()),
                float((got[:2].float() - first.float()).abs().max()))
        res[str(dt)] = e
        if ops.flash_attention.launches - before != 1 or not e <= FLASH_ATOL[dt]:
            raise AssertionError(f"phase 17 (f): B * H = {B * H} in {dt}: err {e}")
        del q, k, v, got
    log(json.dumps({"phase17_grid_x": {"B_times_H": B * H, "max_abs_err": res}}))
    return res


def phase17(dev) -> dict:
    """(a) the flash kernels past head dim 256 (bf16 and fp16 on the
    tensor cores' routes, ``ops.sm90_route``: the wide kernel, the cluster
    kernel, and at SM90_EDGE_DIMS its largest cluster and the split route
    past it; fp32 on the 3xTF32 cluster kernel, and at F32_EDGE_DIMS its
    largest cluster and the split route past it) against their plain
    versions and timed, and the split route in two pieces
    (``hold_split_pieces``);
    (b) fp16 at D = 64, 80, 128, 256, the same; (c) the smoke TinyLlama at
    head_dim 512 (one layer) card against CPU (prefill and 4 serve steps in
    fp32, bf16 and fp16; 3 fp32 train steps with lse; every fp32 launch on
    the 3xTF32 cluster kernel, every bf16 and fp16 launch on the tensor
    cores' cluster kernel); (d) TinyLlama-1.1B served in fp16 at phase 5's
    shape (every prefill launch held) and the smoke model in fp16 card
    against CPU, as phase 6; (e) the fp16 block top-k; (f) a launch past B
    * H = 65,535; (g) the smoke TinyLlama at head_dim 2,056 (one layer)
    card against CPU in fp32 and bf16 (prefill and 4 serve steps), every
    launch on the split route. Each run's counts zeroed just before it and
    read just after. Returns the fp16 kernel's entry, the fp32 cluster
    kernel's, the 16-bit cluster kernel's, the split route's, and the wide
    results."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import ops
    attrs = {f"{str(dt)[6:]}/D{D}": ops.kernel_attributes(dt, D)
             for dt in (torch.bfloat16, torch.float16, torch.float32)
             for D in (320, 384, 512, 1024) + (F32_EDGE_DIMS if dt == torch.float32
                                               else SM90_EDGE_DIMS)}
    attrs.update({f"float16/DP{d}": ops.kernel_attributes(torch.float16, d)
                  for d in ops.COMPILED_WIDTHS})
    log(json.dumps({"phase17_instances": attrs}))
    wide = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        dims = WIDE_DIMS + (() if dt == torch.float32 else SM90_EDGE_DIMS)
        split = tuple(D for D in dims if ops.route_of(dt, D).endswith("split"))
        held = hold_flash_cases(dev, dt, tuple(D for D in dims if D not in split),
                                seed=31)
        wide[str(dt)] = dict(held, timed=time_flash_dims(dev, dt, dims))
        if split:
            wide[str(dt)]["split"] = hold_flash_cases(dev, dt, split, seed=43)
    wide["torch.float32"]["edges"] = {
        D: hold_flash_cases(dev, torch.float32, (D,), seed=41 + i)
        for i, D in enumerate(F32_EDGE_DIMS)}
    wide["torch.float32"]["edges_timed"] = time_flash_dims(dev, torch.float32,
                                                           F32_EDGE_DIMS)
    pieces = hold_split_pieces(dev)
    f16 = dict(hold_flash_cases(dev, torch.float16, F16_DIMS, seed=37),
               timed=time_flash_dims(dev, torch.float16, F16_DIMS))
    stamp("17 (a)-(b)")

    arch = HEAD_DIM_512["arch"]
    cfg = dataclasses.replace(get_smoke(arch), head_dim=HEAD_DIM_512["head_dim"],
                              n_layers=HEAD_DIM_512["n_layers"])
    zero_routes()
    d512 = {"prefill": [family13_card_against_cpu(dev, arch, dtype, cfg=cfg,
                                                  label="phase 17 (c)")
                        for dtype in ("float32", "bfloat16", "float16")],
            # phase 15's first-gradient gate without its float64 floor
            # allowance (that run doubles the phase's time): 1e-5 of scale
            "train": family13_train_card_against_cpu(
                dev, arch, FAMILY13_SMOKE["prompt"], cfg.n_layers,
                label="phase 17 (c)", flat_gate=1e-5, cfg=cfg)}
    d512["f32_routes"] = read_routes("tf32_cluster", "phase 17 (c)")
    d512["sm90_routes"] = read_routes("sm90_cluster", "phase 17 (c)", sixteen=True)
    stamp("17 (c)")

    serve = serve_path(dev, dtype="float16")
    smoke = serve_card_against_cpu(dev, "float16")
    stamp("17 (d)")
    topk = check_topk_block_f16(dev)
    grid = check_grid_x(dev)

    cfg = dataclasses.replace(get_smoke(HEAD_DIM_SPLIT["arch"]),
                              head_dim=HEAD_DIM_SPLIT["head_dim"],
                              n_layers=HEAD_DIM_SPLIT["n_layers"])
    zero_routes()
    d_split = {"prefill": [family13_card_against_cpu(dev, HEAD_DIM_SPLIT["arch"], dtype,
                                                     cfg=cfg, label="phase 17 (g)")
                           for dtype in ("float32", "bfloat16")]}
    d_split["f32_routes"] = read_routes("tf32_split", "phase 17 (g)")
    d_split["sm90_routes"] = read_routes("sm90_split", "phase 17 (g)", sixteen=True)
    stamp("17 (g)")

    t = f16["timed"][64]
    entry = dict(name="flash_attention_f16", route="cuda",
                 source="src/repro_torch/csrc/flash_attention_sm90_f16.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:25",
                 launches=serve["launches"]["flash_attention_f16"],
                 max_abs_err=max(f16["max_abs_err"], wide["torch.float16"]["max_abs_err"]),
                 ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                 bound_by=t["bound_by"], library_ms=t["library_ms"],
                 sdpa_backend=t["sdpa_backend"], ms_with_lse=t["ms_with_lse"],
                 lse_max_abs_err=max(f16["lse_max_abs_err"],
                                     wide["torch.float16"]["lse_max_abs_err"]),
                 head_dims={D: f16["timed"][D] for D in F16_DIMS[1:]},
                 head_dims_past_256=wide["torch.float16"]["timed"],
                 serve_fp16=serve, smoke_card_vs_cpu_launches=smoke["flash_launches"],
                 launches_phase17c={r["dtype"]: r["flash_launches"]
                                    for r in d512["prefill"]},
                 instances={k.split("/")[1]: a for k, a in attrs.items()
                            if k.startswith("float16")})
    # fp32 past 256: the 3xTF32 cluster kernel's entry, timed at D = 1,024
    w32 = wide["torch.float32"]
    t = w32["timed"][1024]
    cluster = dict(
        name="flash_attention_f32_tf32_cluster", route="cuda",
        source="src/repro_torch/csrc/flash_attention_tf32_wide.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:25",
        launches=d512["f32_routes"]["tf32_cluster"],
        max_abs_err=max(w32["max_abs_err"], w32["edges"][2048]["max_abs_err"]),
        lse_max_abs_err=max(w32["lse_max_abs_err"],
                            w32["edges"][2048]["lse_max_abs_err"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_3xtf32_ms"],
        bound_by=t["bound_3xtf32_by"], bound_fp32_cores_ms=t["bound_ms"],
        library_ms=t["library_ms"], sdpa_backend=t["sdpa_backend"],
        ms_with_lse=t["ms_with_lse"], head_dims_past_256=w32["timed"],
        launches_phase17c={"prefill": d512["prefill"][0]["flash_launches"],
                           "train_with_lse": d512["train"]["flash_launches_with_lse"]},
        edge_2048=w32["edges_timed"][2048],
        instances={k.split("/")[1]: a for k, a in attrs.items()
                   if k.startswith("float32")})
    # bf16 and fp16 past 256: the tensor cores' cluster kernel's entry, timed
    # at D = 1,024 in bf16
    w16 = [wide["torch.bfloat16"], wide["torch.float16"]]
    t = w16[0]["timed"][1024]
    sm90_cluster = dict(
        name="flash_attention_sm90_cluster", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90_wide.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:25",
        launches=d512["sm90_routes"]["sm90_cluster"],
        max_abs_err=max(w["max_abs_err"] for w in w16),
        lse_max_abs_err=max(w["lse_max_abs_err"] for w in w16),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        sdpa_backend=t["sdpa_backend"], ms_with_lse=t["ms_with_lse"],
        routes={D: ops.sm90_route(D) for D in WIDE_DIMS + SM90_EDGE_DIMS},
        head_dims_past_256={"bf16": w16[0]["timed"], "fp16": w16[1]["timed"]},
        launches_phase17c={r["dtype"]: r["flash_launches"] for r in d512["prefill"][1:]},
        instances={k: a for k, a in attrs.items()
                   if a["route"] == "sm90_cluster"})
    # the split route's entry, timed at D = 2,056 in fp32 (against its 3xTF32
    # bound), its launches those of (g)
    w16s = [wide["torch.bfloat16"], wide["torch.float16"]]
    t = w32["edges_timed"][2056]
    split_dims = {dt: tuple(D for D in dims if ops.route_of(dt, D).endswith("split"))
                  for dt, dims in ((torch.float32, F32_EDGE_DIMS),
                                   (torch.bfloat16, SM90_EDGE_DIMS))}
    held_split = ([w32["edges"][D] for D in split_dims[torch.float32]]
                  + [w["split"] for w in w16s] + list(pieces.values()))
    split_entry = dict(
        name="flash_attention_split", route="cuda",
        source="src/repro_torch/csrc/flash_attention_split.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:25",
        launches=d_split["f32_routes"]["tf32_split"] + d_split["sm90_routes"]["sm90_split"],
        max_abs_err=max(h["max_abs_err"] for h in held_split),
        lse_max_abs_err=max(h["lse_max_abs_err"] for h in held_split),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_3xtf32_ms"],
        bound_by=t["bound_3xtf32_by"], bound_fp32_cores_ms=t["bound_ms"],
        library_ms=t["library_ms"], sdpa_backend=t["sdpa_backend"],
        ms_with_lse=t["ms_with_lse"],
        head_dims={"fp32": {D: w32["edges_timed"][D] for D in split_dims[torch.float32]},
                   "bf16": {D: w16s[0]["timed"][D] for D in split_dims[torch.bfloat16]},
                   "fp16": {D: w16s[1]["timed"][D] for D in split_dims[torch.bfloat16]}},
        max_abs_err_by_type={"fp32": max(w32["edges"][D]["max_abs_err"]
                                         for D in split_dims[torch.float32]),
                             "bf16": w16s[0]["split"]["max_abs_err"],
                             "fp16": w16s[1]["split"]["max_abs_err"]},
        pieces=pieces,
        launches_phase17g={"fp32": d_split["f32_routes"]["tf32_split"],
                           "bf16": d_split["sm90_routes"]["sm90_split"]},
        instances={k: a for k, a in attrs.items() if a["route"].endswith("split")})
    log(json.dumps({"phase17_summary": {
        "wide_ms": {dt: {D: r["ms"] for D, r in w["timed"].items()}
                    for dt, w in wide.items()},
        "f16_ms": {D: r["ms"] for D, r in f16["timed"].items()},
        "serve_fp16": {k: serve[k] for k in ("prefill_ms", "decode_ms_per_step",
                                             "first_decode_vs_forward_max_abs",
                                             "logit_scale")},
        "topk_f16": topk, "grid_x": grid}}))
    return {"entry": entry, "entry_f32_cluster": cluster,
            "entry_sm90_cluster": sm90_cluster, "entry_split": split_entry,
            "wide": wide, "d512": d512, "d_split": d_split, "topk_f16": topk,
            "grid_x": grid}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import _build

    # ---- phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log(smi)

    # ---- phase 2: build + kernels against their plain versions
    t0 = time.perf_counter()
    _build.library()
    log(f"built {_build.BUILD_DIR / _build.LIB_NAME} in {time.perf_counter() - t0:.1f} s")
    if "--only" in argv and argv[argv.index("--only") + 1] == "16":
        # phase 16 alone (a short check of the slice's kernels and engines)
        phase16(dev, None)
        log(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if "--only" in argv and argv[argv.index("--only") + 1] == "17":
        # phase 17 alone (head dims past 256, fp16, the grid's x limit)
        p17 = phase17(dev)
        log(json.dumps({"kernels": [p17["entry"], p17["entry_f32_cluster"],
                                    p17["entry_sm90_cluster"], p17["entry_split"]]}))
        log(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if "--cards" in argv:
        multicard(int(argv[argv.index("--cards") + 1]))
        log(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    kernels = [check_dual_solve(dev, name) for name in DUAL_VARIANTS]
    kernels += [check_dual_ascent(dev, name) for name in DUAL_VARIANTS]
    # both kernels past 32 levels; the fused one timed at L = 40
    by_name = {k["name"]: k for k in kernels}
    for name in DUAL_VARIANTS:
        wide = check_dual_wide(dev, name)
        by_name[name]["levels_past_32"] = wide["one_step"]
        by_name[FUSED[name]]["levels_past_32"] = wide["fused"]
        by_name[FUSED[name]]["ms_L40"] = wide["fused"][40]["ms"]
        by_name[FUSED[name]]["ms_L100"] = wide["fused"][100]["ms"]
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn(N_CLIENTS, 1_630_090, device=dev, generator=gen) * 1e-3
    flat = mat[0].clone()          # one client's flat CNN update, phase 7's
    kernels += [check_topk(dev, mat), check_topk_block(dev, flat),
                check_row_norms(dev, mat)]
    attrs = topk_attributes()
    log(json.dumps({"topk_instances": attrs}))
    kernels[-3]["attributes"] = attrs["rows"]
    kernels[-2]["attributes"] = {"f32": attrs["block_f32"],
                                 "bf16": attrs["block_bf16"]}
    del mat
    kernels += check_flash(dev)
    for k in kernels:
        log(json.dumps(k))

    stamp("2")

    # ---- phase 16 (run here, beside phase 2's kernel checks): both top-k
    # kernels at every block width, l2_norm, and the engine factories
    # card against CPU, each engine run's counts zeroed before it
    phase16(dev, kernels)
    stamp("16")

    # ---- phase 3: the paths, each with its launch counts zeroed before it
    runs = {}
    for label in PATHS:
        runs[label] = drive_path(dev, label)
        tr = runs[label].pop("trainer")
        if label == "main":            # phase 7 holds its sharded run to it
            runs[label].update(history=list(tr.history),
                               params={k: v.clone() for k, v in tr.params.items()})
        if "--profile" in argv:
            profile_round(tr, ROUNDS, label)
        del tr
    # each kernel's launches on the path that carries it: a fused ascent
    # variant on its own path, the top-k and the norms on the main path. A
    # one-step dual-solve kernel is on no path since the ascent is fused:
    # its count is that of the path of its variant (0), and phase 2 alone
    # launches it
    # the rows kernel at the ks of the main path's last round
    time_topk_round(dev, next(k for k in kernels if k["name"] == "topk_rows"),
                    runs["main"]["history"][-1])
    carrier = {}
    for label, (_, own) in PATHS.items():      # the first path of a variant
        carrier.setdefault(own, label)
    carrier.update({one: carrier[FUSED[one]] for one in DUAL_VARIANTS})
    for k in kernels:
        if k["name"] not in ("flash_attention", "flash_attention_f32",
                             "flash_attention_f16", "flash_attention_f32_tf32",
                             "flash_attention_f32_tf32_cluster", "topk_block"):
            k["launches"] = runs[carrier.get(k["name"], "main")]["launches"][k["name"]]
        if k["name"] in DUAL_VARIANTS:
            k["on_path"] = False
    for label in ("d_quantized_40", "e_bursty_priced_joint_40"):
        own = PATHS[label][1]
        by_name[own][f"launches_{label}"] = runs[label]["launches"][own]

    stamp("3")

    # ---- phase 4: card against CPU (its GSS check runs during phase 14)
    for variant in DUAL_VARIANTS:
        t0 = time.perf_counter()
        solver_card_against_cpu(dev, variant)
        log(json.dumps({"solver_card_vs_cpu_s": variant,
                        "s": time.perf_counter() - t0}))
    stamp("4 solver")
    card_against_cpu(dev)
    card_against_cpu(dev, "bursty-interference", price_outage=True, bits_grid=BITS)
    # paths (d) and (e): the 40-level joint grid (the paper's 10 gammas)
    card_against_cpu(dev, "quantized", bits_grid=BITS40,
                     fe_kw=dict(gamma_grid=GRID), label="d_quantized_40")
    card_against_cpu(dev, "bursty-interference", price_outage=True,
                     bits_grid=BITS40, fe_kw=dict(gamma_grid=GRID),
                     label="e_bursty_priced_joint_40")
    topk_mask_on_card(dev)
    stamp("4 paths")
    for strategy in BASELINES:
        card_against_cpu(dev, strategy=strategy)
    stamp("4 baselines")
    robust_card_against_cpu(dev)
    stamp("4 robust")
    hierarchy_card_against_cpu(dev)
    stamp("4")

    # ---- phase 5: the serve path, its launch counts zeroed before the timed run
    serve = serve_path(dev, profile="--profile" in argv)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["launches"] = serve["launches"]["flash_attention"]

    # ---- phase 5b: the full-width fp32 prefill, its counts zeroed before
    # the timed run
    flash_f32 = next(k for k in kernels if k["name"] == "flash_attention_f32")
    prefill = serve_prefill_f32(dev, flash_f32["ms"])

    # ---- phase 6: serve, card against CPU (the fp32 kernel's launches), and
    # the same in bf16 through the tensor-core kernel (C-13)
    flash_f32["launches"] = (prefill["launches"]["flash_attention_f32"]
                             + serve_card_against_cpu(dev)["flash_launches"])
    serve_card_against_cpu(dev, "bfloat16")

    stamp("5-6")

    # ---- phase 7: the multi-rank paths on one rank
    block = next(k for k in kernels if k["name"] == "topk_block")
    block["launches"] = multirank_paths(dev, flat, runs["main"])

    stamp("7")

    # ---- phase 8: the paper's experiment, each run's counts zeroed before
    # it; then the CLI with and without --shard-clients on this card
    paper_experiment(dev)
    sharded_cli_one_card(dev)

    stamp("8")

    # ---- phase 9: the timed, fault and defense paths at full width, each
    # run's counts zeroed before it, and the checkpoint on the card
    robust = robust_rounds(dev, runs["main"], profile="--profile" in argv)
    norms = next(k for k in kernels if k["name"] == "row_sq_sum")
    norms["launches_defended_clip"] = (
        robust["byzantine_lite"]["launches"]["row_sq_sum"] - ROBUST_ROUNDS - 1)
    norms["second_call_site"] = "src/repro_torch/core/faults/defense.py"

    stamp("9")

    # ---- phase 10: hierarchy and mobility at full width, each run's counts
    # zeroed before it; the launches of each run beside the main path's
    pop = population_paths(dev, runs["main"])
    pop_launches = {"a_mobility": pop["a_mobility"]["launches"],
                    "b_hierarchy": pop["b_hierarchy"]["launches"],
                    **{f"c_{m}": pop["c_population"][m]["launches"]
                       for m in ("pooled", "full")}}
    for k in kernels:
        if k["name"] in ("dual_ascent", "topk_rows", "row_sq_sum"):
            k["launches_phase10"] = {run: got[k["name"]]
                                     for run, got in pop_launches.items()}

    stamp("10")

    # ---- phase 11: TinyLlama-1.1B training at full width, its counts
    # zeroed before the timed steps; 11b: the smoke model's steps card
    # against CPU in fp32 and bf16
    trained = train_path(dev, profile="--profile" in argv)
    flash["launches_phase11"] = trained["launches_per_step"]["flash_attention"] \
        * TRAIN["steps"]
    flash["flash_bwd_ref_calls_phase11"] = \
        trained["launches_per_step"]["flash_bwd_ref_calls"] * TRAIN["steps"]
    for dtype in ("float32", "bfloat16"):
        train_card_against_cpu(dev, dtype)

    stamp("11")

    # ---- phase 12: the moe, ssm and hybrid families served at full width,
    # each run's counts zeroed before it; 12b: each family's smoke model
    # card against CPU in fp32 and bf16
    served = serve_families(dev, profile="--profile" in argv)
    flash["launches_phase12"] = {arch: r["launches"]["flash_attention"]
                                 for arch, r in served.items()}
    smoke = [family_card_against_cpu(dev, arch, cut, dtype)
             for arch, cut in FAMILIES_SMOKE for dtype in ("float32", "bfloat16")]
    flash["launches_phase12b"] = {r["family_card_vs_cpu"]: r["flash_launches"]
                                  for r in smoke if r["dtype"] == "bfloat16"}
    flash_f32["launches_phase12b"] = {r["family_card_vs_cpu"]: r["flash_launches"]
                                      for r in smoke if r["dtype"] == "float32"}
    stamp("12")

    # ---- phase 13: the audio (whisper-tiny) and VLM (phi-3-vision-4.2b)
    # families served and trained at full width, each run's counts zeroed
    # before it; (f) the smoke models card against CPU
    p13 = audio_and_vlm_paths(dev)
    flash["launches_phase13"] = {
        "a_whisper_serve": p13["a"]["launches"]["flash_attention"],
        "b_whisper_prefill_32k": p13["b"]["launches"]["flash_attention"],
        "c_whisper_train": p13["c"]["launches_per_step"]["flash_attention"]
        * AUDIO_TRAIN["steps"],
        "c_whisper_train_flash_bwd_ref_calls":
            p13["c"]["launches_per_step"]["flash_bwd_ref_calls"] * AUDIO_TRAIN["steps"],
        "d_phi3v_serve": p13["d"]["launches"]["flash_attention"],
        "d_phi3v_vision_prefill": p13["d"]["vision_launches"],
        "e_phi3v_train": p13["e"]["launches_per_step"]["flash_attention"]
        * VLM_TRAIN["steps"],
        "f_bf16": {r["family13_card_vs_cpu"]: r["flash_launches"]
                   for r in p13["f"] if r["dtype"] == "bfloat16"}}
    flash_f32["launches_phase13f"] = {r["family13_card_vs_cpu"]: r["flash_launches"]
                                      for r in p13["f"] if r["dtype"] == "float32"}
    flash_f32["launches_phase13f_train"] = {
        r["family13_train_card_vs_cpu"]: r["flash_launches_with_lse"] for r in p13["f_train"]}
    stamp("13")

    # ---- phase 14: (a) the moe, ssm and hybrid families trained at full
    # width, each run's counts zeroed before it, and their smoke models card
    # against CPU; (b) one step through the sharding plan on a (1, 1) mesh;
    # (c) the dry-run, started first, on the CPU meanwhile; and phase 4's
    # GSS check, its card and CPU sides each in a child process meanwhile
    gss = start_gss_check(dev)
    dryruns = start_dryruns()
    try:
        p14 = family_train_paths(dev)
        plan = plan_step_on_card(dev)
        finish_dryruns(dryruns)
    finally:
        stop_dryruns(dryruns)
    gss_card_against_cpu(gss)
    stamp("14 and 4 gss")
    flash["launches_phase14a"] = {
        arch: p14[arch]["launches_per_step"]["flash_attention"] * p14[arch]["steps"]
        for arch in FAMILY_TRAIN_RUNS}
    flash["flash_bwd_ref_calls_phase14a"] = {
        arch: p14[arch]["launches_per_step"]["flash_bwd_ref_calls"] * p14[arch]["steps"]
        for arch in FAMILY_TRAIN_RUNS}
    flash_f32["launches_phase14a_smoke"] = {
        r["family13_train_card_vs_cpu"]: r["flash_launches_with_lse"] for r in p14["smoke"]}
    flash_f32["launches_phase14b_plan"] = plan["flash_launches_with_lse_plan"]
    stamp("14")

    # ---- phase 15: the smoke TinyLlama at head_dim 256, card against CPU,
    # each run's counts zeroed before it
    p15 = head_dim_256_path(dev)
    flash["launches_phase15"] = {"prefill_bf16": p15["prefill"][1]["flash_launches"]}
    # fp32 at head_dim 256 runs the 3xTF32 kernel: its launches are phase 15's
    tf32 = next(k for k in kernels if k["name"] == "flash_attention_f32_tf32")
    tf32["launches"] = p15["f32_routes"]["tf32"]
    tf32["launches_phase15"] = {
        "prefill": p15["prefill"][0]["flash_launches"],
        "train_with_lse": p15["train"]["flash_launches_with_lse"]}
    stamp("15")

    # ---- phase 17: head dims past 256 on both flash kernels, fp16 through
    # the tensor-core kernel (its entry joins the kernels line) and the
    # block top-k, and a launch past B * H = 65,535
    p17 = phase17(dev)
    kernels += [p17["entry"], p17["entry_f32_cluster"], p17["entry_sm90_cluster"],
                p17["entry_split"]]
    w = p17["wide"]["torch.bfloat16"]
    flash["head_dims_past_256"] = dict(w["timed"], max_abs_err=w["max_abs_err"],
                                       lse_max_abs_err=w["lse_max_abs_err"])
    flash["launches_phase17c"] = {"prefill_bf16": p17["d512"]["prefill"][1]["flash_launches"]}
    # fp32 past 2,048 takes the split route (phase 17's edge dims)
    flash_f32["past_2048"] = dict(p17["wide"]["torch.float32"]["edges"][2056],
                                  timed=p17["wide"]["torch.float32"]["edges_timed"][2056])
    block["fp16"] = p17["topk_f16"]
    stamp("17")

    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
