#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --quick    # small shapes: build and check only
                                     # (phase 9: evaluations and kernels;
                                     # phase 11 (b) at n = 4,096 and 8,192;
                                     # phase 17 (b) at train_lm's 20m size;
                                     # phase 18 (b) at 4 layers, 2 x 1,024;
                                     # phase 19 (b) at 4 layers, 2 x 128;
                                     # phase 20 at shorter prompts, llava
                                     # at 2 layers, h2o at 4)
    python3 chip_smoke.py --e2e-ab DIR  # only phases 4, 8.1, 9.1 and 10.1's
                                     # evaluations, the checkout at DIR and
                                     # this one in turns (DIR, this, this, DIR)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. environment: the card (nvidia-smi), torch, CUDA, TF32 flags (off);
  2. build: every CUDA kernel from csrc/, one nvcc per source in parallel,
     with ptxas's registers and spill bytes of each mp_syrk kernel (the
     paper pair's two must not spill) and its DMMA, DFMA and FFMA counts
     in cuobjdump's SASS (the fp64 band: DMMA and no DFMA), and the same
     of all 36 matern_cov instantiations (forward general and symmetric,
     backward) with their MUFU, F2F, DFMA, FFMA and STG counts, and of
     mp_syrk_grad's 22 (the pre-pass, the wgmma, IEEE fp32 and DMMA
     engines) with their HGMMA, DMMA, DFMA and FFMA counts (the 128 x 128
     engines must not spill);
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes, with errors, tolerances and CUDA-event times
     (kernel, plain version, one library call where one computes the same
     function) and the bound: the least time the card could take;
     blocked_potrf at nb in {32, 128, 520, 1000, 1024} (batch 8; 520, 1000
     and 1024 also batch 1), and indefinite tiles at nb = 128 and at
     nb = 1024 with the bad pivot in the last panel; mp_syrk at the
     conformance sweep's shapes and with round_k < kdim, lo bf16 and fp32,
     each U equal to its transpose, and at the main path's step 0 (U = U^T
     slab by slab, bit for bit), timed at m_t in {63, 32, 8} tile rows
     with the device time of each of its kernels at step 0; the same
     checks under the paper pair (hi, lo, accum) = (fp64, fp32, fp32) and
     all-hi fp64, and its step 0 timed beside its yardstick and bound, and
     each of its two kernels (fp64 DMMA band, fp32 off-band) beside its
     half of the yardstick and its own bound;
     matern_cov's symmetric form (the band's diagonal tiles) at every nu
     and output dtype, equal bit for bit to the general form and to its
     transpose, both timed; matern_cov's fp64 forms of phase 4's
     paper-pair request at every nu: fp64 band storage, and the off-band
     computed in fp64 and rounded once to fp32;
     3b. mp_attention (banded-precision flash decode) against its plain
     version on the kernel tests' shapes and h2o-danube-1.8b's (d_head 80,
     G = 4), logit scales, ragged lengths (an empty far segment among them)
     and fp32 / bf16 near K/V, G = 15 and 16 at d_head 80, and at the
     served segment sizes with B*KV = 1 and 32: ragged lengths that end
     mid-chunk, chunks wholly past the end, seg_len = 0; then d_head 80 at
     h2o-danube's served window (16 rows, 1,024 bf16 near and 3,072 int8
     far keys, 24 layers in turn) timed beside its plain version, SDPA and
     its byte bound;
  4. main path: geostat_loglik_step at n = 65536, nb = 1024, band t = 8,
     {fp32 band, bf16 off-band}, three requests (theta), each through the
     kernels and through the plain versions; launch counts, log-likelihoods,
     seconds per evaluation and peak memory; then one request under the
     paper pair paper_cpu(8) (fp64 band, fp32 off-band) on the same field
     in fp64;
  5. small inputs held against the plain path on the CPU: the likelihood,
     and llama3.2-1b's SMOKE model (fp32 compute) through forward_lm,
     prefill, generate and decode_step;
  6. a short Nelder-Mead MLE (fit_mle) through the kernel path;
  7. serving: llama3.2-1b at full width and depth (random weights from a
     seed), batch 4 x 8,192-token prompts, 64 greedy tokens (bf16 compute),
     then every layer's served cache through the banded-precision attention
     (near 1,024 positions bf16, the rest int8 blocks of 128) against its
     plain version and exact attention, with launch counts, times and the
     device time of the segment launches under the profiler;
  8. fidelity: the Algorithm 1 tile engine, likelihood, kriging and batch
     engine at n_obs = 40,960 observed of 45,056 points (every 11th held
     out: 4,096 prediction sites), nb = 1,024 (p = 40): one evaluation per
     policy through the kernels and through the plain versions on a
     medium (theta0 = (1, 0.1, 0.5)) and a weak (1, 0.03, 0.5) field
     (launch counts, log-likelihoods, seconds, peak memory, device busy
     and idle shares); on the weak field, fit_mle_grid + batched
     Nelder-Mead through BatchEngine for DP(100%), DP(10%) and DST,
     kriging with variance and 10-fold PMSE at each theta-hat, and
     BatchEngine.loglik on 8 candidates against loglik_sequential; the
     tile path at n = 2,048 on the card and on the CPU; a general-nu
     haversine covariance against fp64; each kernel at the tile path's
     shapes (Sigma from matern_cov's symmetric form equal to its transpose
     and to the general form's bit for bit, both timed); nb = 96 refused
     on the card;
  9. the paper pair: an fp64 medium field (theta0 = (1, 0.1, 0.5)) at
     n_obs = 40,960 of 45,056, nb = 1,024: full(fp64) dense and through the
     tiles, paper_cpu at DP(10%) and DP(40%), each through the kernels and
     the plain versions (launch counts, kernel vs plain, drift against
     full(fp64), seconds, peak), a profiled DP(10%) evaluation and tpu(2)
     on the same field; fit_mle_grid + batched Nelder-Mead (one candidate
     per chunk) for full(fp64) and DP(10%), theta-hat within 0.25; kriging
     with variance at 4,096 sites, PMSE within 0.2; mp_syrk (fp64, fp32)
     at the tile path's step 0 and matern_cov in fp64 for Sigma and
     Sigma_no against their plain versions (every row slab), timed, Sigma
     in both forms as in phase 8;
 10. the gradient path: matern_cov_grad (the hand-written backward of
     matern_cov) against its plain version, fp32 and fp64 at every nu, on a
     4,096^2 G and on phase 8's (fp32) and phase 9's (fp64) Sigma, in its
     symmetric form (the same bits twice) and its general form, timed
     against its byte bound; one value-and-gradient evaluation of dense
     full(fp32) on phase 8's weak field and full(fp64) on phase 9's field
     (n_obs cut to a multiple of 1,024 if its predicted peak passes 70 GiB)
     through the kernels and the plain versions (launch counts, the
     log-likelihood equal to the no-grad one, gradients kernel vs plain,
     seconds forward and backward, peak, matern_cov_grad once under the
     profiler); fit_mle_adam as tests/test_mle_kriging.py runs it (120
     steps, lr 0.05) at n = 8,192 on phase 6's field against fit_mle, and
     at n_obs for as many steps as fit in 12 s; 10.3 the tile engine's
     gradient: mp_syrk_grad (mp_syrk's hand-written backward) against its
     plain version for the four pairs at 4,096 and 39,936 rows (k =
     1,024, band 2), timed beside its bound and a torch.matmul yardstick
     and each class's device time (pre-pass, off-band, band),
     then with a dU that is zero off the band, where the plain version
     with the band in lo must fail the same check, and the tiles'
     Cholesky backward at B = 1 and 3; one value-and-gradient evaluation
     through the tiles of tpu(2) and full(fp32) on phase 8's weak field
     and paper_cpu(2) on phase 9's fp64 field at n_obs = 40,960, nb =
     1,024 (the pair's n cut to a multiple of 1,024 if its
     predicted peak passes 70 GiB) through the kernels and the plain
     versions (exact launch counts, the log-likelihood equal to the
     no-grad one, gradients kernel vs plain against the scale sum |G|
     dSigma/dtheta, seconds, peak, the profiler's top operations), the
     pair's gradient beside dense full(fp64)'s; fit_mle_adam under the
     pair through the tiles at n = 8,192 against fit_mle;
 11. accuracy (repro_torch.verify, the fp64 oracles and the tolerance
     registry): (a) the conformance sweep through the kernels on the card's
     grid (n in {128, 256, 384} x weak / medium / strong at nb = 64: p in
     {2, 4, 6}, as the CPU grid at nb = 32): the tile engine under five
     policies and the paper pair, the panel engine, DST, kriging and the
     four kernel pairs, 126 records with every kernel launched; then the
     Cholesky and kriging records again through the plain versions: every
     registered bound held or passed by the plain twin as well (at n = 384
     the strong field is harder than the CPU grid's n = 192: three_tier's
     fp8 far field goes NaN and {fp32, bf16} t = 1 passes its loglik_drift
     on both paths), the paper's claims (no deterioration, the pair at
     fp32 scale, coverage, mixed beating DST) and no drift from
     golden/accuracy_cuda.json; (b) the scale leg at n in {10,240, 40,960}
     (nb = 1,024, weak and medium): tiled full(fp32), the paper pair,
     {fp32, bf16} t = 2 and DST t = 2 against the fp64 oracle of the same
     fp32 Sigma, one line per record with its bound, the predicted and
     measured peak; full(fp32) and the pair finite, the pair's drift
     <= 1e-4, DST a magnitude worse than a finite mixed record;
 12. the task runtime (repro_torch.sched: the tile DAG out of order, a
     CUDA stream per worker thread, dependencies as cross-stream events,
     task times from CUDA events): (a) the tile, panel and DST variants
     under tpu(2), full(fp32) and paper_cpu(2) at n = 1,024, nb = 128
     through the kernels: the same bits under fifo W = 1, critical_path
     W = 4 and panel_first W = 3 (seed 7), and the tile variant's
     critical_path W = 4 once more through tile_cholesky(schedule=...),
     exact blocked_potrf launches, a clean happens-before check of the
     W = 4 report on device times (atol 1 us), the factor within the
     registry's factor_rel of the sequential engine and of impl="plain";
     (b) the tile variant at phase 8's and 9's n_obs = 40,960,
     nb = 1,024 under tpu(2) (weak field, fp32 Sigma) and paper_cpu(2)
     (fp64 medium field): fifo W = 1 and critical_path W = 4, each warmed
     up through tile_cholesky(schedule=...) (the same bits as the timed
     scheduled_tile_cholesky), beside the sequential tile_cholesky
     (seconds, device makespan, utilization, overlap, tasks per second,
     peak), the same bits, the log-likelihood within phase 8.1's and
     9.1's limits and the factor within the registry's factor_rel of the
     sequential one (or, where the sequential factor itself is past it,
     no farther from the fp64 oracle than the sequential factor), the
     peak at most 1.25x the sequential one's, a Chrome trace under
     chiprun_out/ validated, and tpu(2)'s critical_path W = 4 warm-up
     under torch.profiler: the device's busy time against the wall time;
 13. the panel engine's gradient and haversine distance in matern_cov:
     (a) matern_cov_grad's tile-stack forms against their plain versions
     at phase 4's storage (the zip form over band sub-diagonals 0 and 1
     with an fp32 / fp64 G, the lower form over the off-band with a bf16 /
     fp32 G), Euclidean and haversine, every nu, timed beside their bound;
     the haversine forward (band sub-diagonals 0 and 1, the bf16 off-band,
     fp64 locations) on phase 4's points mapped onto a lon/lat box against
     fp64 and the plain version, and the dense 40,960^2 haversine Sigma
     and its backward; (b) one value-and-gradient evaluation of
     geostat_loglik_step at phase 4's size (tpu(8), n = 65,536, its field
     and first request) through the kernels and the plain versions: exact
     launch counts, the log-likelihood equal to the no-grad one bit for
     bit, kernel against plain over s_k = sum |G| dSigma/dtheta_k,
     seconds forward and backward, peak against its prediction, device
     busy and idle share; then paper_cpu(8) on the field in fp64 at the
     largest n predicted under 70 GiB; (c) make_loglik with haversine at
     nu = 0.5 on a lon/lat field of 40,960 points, value and gradient,
     dense full(fp32) and through the tiles under tpu(2);
 14. the distributed panel engine (core/distributed.py) on a 1 x 1 NCCL
     grid (torch.distributed, one rank, a HashStore): (a) the bf16 lo
     product against the fp32-upcast one at (b)'s row chunk of U (one bf16
     ulp), then tpu(2), full(fp32) and paper_cpu(2) at n = 1,024, nb = 128
     through masked_full, aligned and fori: the NCCL grid's factor and ll
     the no-group call's bits, masked_full and fori the same bits, aligned
     within phase 8.1's (9.1's) limit, kernels against plain within phase
     4's, exact launch counts, and a CUDA tensor under a 1-rank gloo group
     refused; (b) geostat_65k (phase 4's field and first request) through
     the three versions, kernels after one warm-up and plain: exact
     matern_cov (1 + t) and blocked_potrf (p) launches, kernel against
     plain within 1e-3 |ll|, ll beside the panel engine's (phase 4's;
     reported, the reference's lo-rounded band panel makes them differ),
     seconds, the peak against its prediction, the device's busy and idle
     share of a masked_full evaluation; (c) the pair at DP(10%) on phase
     9's fp64 medium field through aligned and masked_full, kernels and
     plain: within 1e-5 of each other and 1e-4 |ll| of 9.1's full(fp64);
     (d) the gradient in theta and z (DistributedMaternCov,
     DistributedCholesky, DistributedLoglik): (d.1) (a)'s three policies
     through every version, the NCCL grid's ll and gradients the no-group
     call's bits, masked_full and fori the same bits, ll with grad the bits
     without, kernels against plain within DIST_KERNEL_TOL over s_k,
     exact launches (matern_cov_grad 1 + t); (d.2) geostat_65k's
     masked_full, n cut by distributed_grad_peak_gib: one warm-up whose
     backward runs under the profiler, then the kernels timed (forward,
     backward, peak against its prediction), each matern_cov_grad launch
     of that run held to its plain version on the same slab and G within
     DIST_CHECK_TOL of the scale (the plain's seconds taken out of the
     backward's), the gradient beside 13 (b)'s panel gradient (reported:
     C 18); (d.3) the pair at DP(10%) on 9's field through aligned at
     10.1's full(fp64) n, kernels and plain (over s_k), its gradient within
     DIST_PAIR_FP64_TOL over s_k of 10.1's full(fp64) gradient;
 15. telemetry (repro_torch.obs) on the card: (a) the calibrator's task
     times (CUDA events behind a spin) of the tile DAG at p = 6, nb =
     1,024 under tpu(2): exactly the DAG's (kind, tier) keys, one
     blocked_potrf launch per POTRF task of each replay, each key beside
     the committed table (launch/calibration.json) and their ratio,
     written to chiprun_out/ (never over the committed file); (b) the
     demo trace (the eager tile engine, then the runtime, critical_path
     W = 4) at p = 16, nb = 1,024 with telemetry on: the merged trace
     validates, sched.tasks.{kind} and each sched.task.{kind}.{tier}
     histogram count the DAG's tasks and sum the report's times, every
     task inside the sched.execute span widened by the measured skew of
     sched.t0 (the launch latency, printed), the simulated makespan under
     the committed table beside the measured one; (c) phase 4's
     geostat_65k evaluation off and on: one core.panel_loglik_step and
     one core.panel_cholesky span, the span within 10 % of the host
     clock around a sync, ll the same bits, no device synchronization
     with telemetry off, exact launches, both seconds, the summary table
     and the Prometheus text; then BatchEngine.loglik of 4 candidates at
     n_obs = 8,192: batch.candidates = 4 and no engine span inside;
 16. the static and concurrency gate (repro_torch.analysis) on the card:
     (a) in-process, the precision-flow linter, the DAG hazard matrix and
     the scheduler's dispatch-order replay pass, and the lockguard finds
     nothing outside the committed baseline in sched/runtime.py and
     obs/recorder.py; (b) the interleaving model checker's fast matrix
     (7 cells x W = 2, 3; one CUDA stream per logical worker, cross-stream
     operands waited on through their producers' end events) gives the
     same (variant, policy, p, workers, runs, distinct) rows as the same
     call on the CPU, >= 200 distinct interleavings, no violation, every
     run bit for bit the on-card in-order replay, the tile cells within
     the policy's registered factor bound of the on-card tile_cholesky,
     and one blocked_potrf launch per POTRF task of each run and replay;
     (c) `python -m repro_torch.analysis --check --concurrency` in a
     process of its own on the card exits 0; the phase's seconds (at most
     30);
 17. LM training (repro_torch.train, .optim, .runtime, .checkpoint, .data):
     (a) llama3.2-1b's SMOKE in fp32 compute on the card and on the CPU from
     one state and one stream, 3 steps with 2 microbatches and one with
     int8 compression: losses, lr and grad norms per step, the params'
     update and the moments within TRAIN_CPU_TOL; (b) llama3.2-1b at full
     width and depth (16 layers, d 2,048, vocab 128,256, tied, remat on),
     bf16 compute with fp32 masters, train_4k's 4,096 tokens, global batch
     8 in 4 microbatches of 2 (halved while the peak predicted by
     train_peak_bytes passes 70 GiB), from the synthetic source, 6 steps:
     each step's seconds, the median of steps 2-6, tokens/s, the peak
     beside its prediction, model TFLOP/s (train_step_flops: 6 N T, the
     attention's products, remat's recompute) beside the bf16 peak, the
     losses finite and under the first + 1.0, no kernel of the port
     launched; the last step under the profiler (the device's idle share,
     the fp32 score products' share); (c) train_lm's 100m model through
     FaultTolerantLoop, 20 steps of 8 x 512 with a checkpoint every 5 and
     failures injected at steps 7 and 13: 2 restarts, data_step 20, finite
     losses, each save's bytes and seconds, the last checkpoint restored
     bit for bit; the phase's seconds (at most 90);
 18. MoE serving (models.layers.moe through forward_lm, prefill and
     decode_step): (a) qwen3-moe-30b-a3b's and grok-1-314b's SMOKE in fp32
     compute on the card and on the CPU from one set of weights:
     forward_lm, prefill and 4 decode steps within phase 5's 1e-4 of max
     |logit|, the same greedy ids, the same kept (token, expert, slot)
     assignments in every layer, the aux within MOE_AUX_TOL, one train step
     with 2 microbatches within TRAIN_CPU_TOL; (b) qwen3-moe-30b-a3b at full
     width with its depth cut 48 -> 4 layers through serve_full (below) at
     phase 7's traffic, its prefill profiled and checked whole;
 19. recurrent serving (models.ssm: mamba, mLSTM, sLSTM through
     forward_lm, prefill, decode_step and generate): (a) xlstm-1.3b's and
     jamba-v0.1-52b's SMOKE in fp32 compute on the card and on the CPU from
     one set of weights: forward_lm, prefill and 4 decode steps within phase
     5's 1e-4 of max |logit| and the same greedy ids (jamba's prompt not a
     multiple of its mamba_chunk: the scan pads), lm_loss with remat and its
     gradient norm within TRAIN_CPU_TOL; through serve_full, (b) xlstm-1.3b
     at full width with its depth cut 48 -> 24 (4 x 512 prompts and 64
     tokens; a 4-token prefill profiled, whose trace holds ~1,200 launches a
     token, and 128 tokens checked) and (c) jamba-v0.1-52b at full width
     with its depth cut 32 -> 8 (one cycle: 7 mamba layers, 4 with MoE, and one
     attention layer; 4 x 4,096 prompts and 32 tokens; 128 tokens
     profiled, the whole prompt checked);
 20. the rest of the zoo (whisper's encoder and cross-attention, the vision
     stub, qwen3-4b, qwen3-32b, h2o-danube-1.8b): (a) the five SMOKEs in
     fp32 compute on the card and on the CPU from one set of weights and
     stub inputs: forward_lm (whisper over its encoder's output), prefill
     (from frames or patches) and 4 decode steps from the prefill's length
     within 1e-4 and the same greedy ids, lm_loss with frames or patches and
     its gradient norm within TRAIN_CPU_TOL; through serve_full, (b)
     whisper-tiny uncut (4 + 4 layers, 1,500 frames; 16 x 32-token prompts,
     64 tokens), each layer's cross cache through mp_attention at near 256
     (G = 1, d_head 64) and (c) llava-next-34b at full width with its depth
     cut 60 -> 8 (2 x (2,880 patches + 1,216 tokens), 32 tokens; d_head
     128, G = 7) and h2o-danube-1.8b uncut (24 layers; 2 x 8,192 prompts
     past its 4,096 window, 32 tokens; each window's slots in position
     order through the d_head 80 kernel, G = 4); the phase's seconds (at
     most 120);
     serve_full, in 18 (b), 19 (b), (c) and 20 (b), (c): random weights
     from a seed, bf16 compute, fp32 params, through serve_lm.generate (the
     batch halved while serve_peak_bytes predicts more than 70 GiB):
     prefill seconds, ms per decode step, the peak beside its prediction,
     the recurrent state's bytes per sequence, a decode step and a prefill
     under the profiler, a prefill run twice the same bits, with MoE each
     layer's share of its assignments dropped at capacity, then every
     attention layer's served cache through mp_attention (exactly 2
     launches a cache, no other kernel of the port; none in 19 (b)) against
     its plain version and exact attention; each phase's seconds (at most
     90);
 21. the planning layer (repro_torch.launch.dryrun, .roofline, .costmodel),
     rerunning nothing: (a) the whole dry-run in this process (every
     applicable cell on the (16, 16) and (2, 16, 16) meshes at the H100's
     rates, one line a cell, reports under chiprun_out/phase21_dryrun/),
     each cell's fit against 80e9 B and the card's memory; (b) on the 1 x 1
     mesh the runs measured above against their plans: phase 4's three
     evaluations (geostat_cell_cost, square), 12 (b)'s sequential tile
     factorizations (geostat_dag_cost), 14 (b)'s masked_full evaluation
     and 17 (b)'s train step (their dry-run plans), each measured time at
     least its roofline bound, with the measured-to-bound ratio, and the
     peaks of 4, 14 (b), 14 (d.2) (distributed_grad_peak_gib), 17 (b) and
     the served ones of 18-20 within PLAN_PEAK_TOL of their reckonings
     (plus what the process held); (c)
     the phase's seconds (at most 30);
then the card's name and power limit, one JSON line of every kernel's
numbers (the fp64 instantiations in rows of their own), and last the
result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense; NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
FP64_TC_FLOPS = 67e12   # fp64 on the tensor cores (DMMA)
FP64_FLOPS = 34e12      # fp64 FMA outside the tensor cores

# the kernels of one mp_syrk call, as the profiler names them: the fp32
# band and bf16 off-band of the {fp32, bf16} pair, the fp64 DMMA band and
# fp32 off-band of the paper pair, and the two passes that write P in lo
SYRK_KERNELS = ("syrk_band_lower_kernel", "syrk_offband_bf16_wgmma_kernel",
                "to_bf16_kernel", "syrk_band_f64_dmma_kernel",
                "syrk_offband_fp32_pipelined_kernel", "to_fp32_kernel")
# the kernels of one mp_syrk_grad call, as the profiler names them: the
# pre-pass (D + D^T, the packed lo tiles of dU, lo(P)), the {fp32, bf16}
# off-band on wgmma, the IEEE fp32 engine (fp32 band, the paper pair's
# off-band) and the fp64 band on DMMA; keyed with their template's types
SYRK_GRAD_KERNELS = ("mp_syrk_grad_diag_kernel", "mp_syrk_grad_lo_tiles_kernel",
                     "mp_syrk_grad_lo_p_kernel", "mp_syrk_grad_offband_wgmma_kernel",
                     "mp_syrk_grad_fp32_kernel", "mp_syrk_grad_dmma_kernel")
SYRK_GRAD_SASS_OPS = ("HGMMA", "DMMA", "DFMA", "FFMA")
SYRK_GRAD_PREPASS = SYRK_GRAD_KERNELS[:3]
# matern_cov's kernels (forward general and symmetric, backward), keyed with
# their template's types, and the SASS instructions counted in each
MATERN_KERNELS = ("matern_cov_kernel", "matern_cov_sym_kernel",
                  "matern_cov_grad_kernel")
MATERN_SASS_OPS = ("MUFU", "F2F", "DFMA", "FFMA", "STG")
# its instantiations: the forward's 4 (locations, out) dtype pairs x 3 nu x
# 2 metrics, general and symmetric (48); the backward's 4 (locations, G)
# pairs x 3 nu x 2 metrics in the general form (24) and the 2 with G in the
# locations' precision in the symmetric form (12)
MATERN_INSTANTIATIONS = 84
# idle seconds at each end of a profiler trace (device_profile)
PROFILE_PAD_S = 0.3
QUICK = dict(n=8_192, nb=512, t=4, nu=0.5, off_update="square")
# phase 7: batch, prompt length, generated tokens, near window, key block
SERVE = dict(batch=4, prompt=8_192, new=64, near=1_024, blk=128)
SERVE_QUICK = dict(batch=2, prompt=1_024, new=8, near=256, blk=128)
# phase 3b: (b, g, d, sn, sf, blk) of tests/test_kernels.py and the
# conformance sweep, and h2o-danube-1.8b's d_head 80 with its GQA's G = 4;
# its logit scales, and the bound of verify/bounds.py
ATTN_SHAPES = ((2, 4, 64, 128, 256, 128), (1, 8, 128, 256, 128, 64),
               (4, 1, 64, 128, 128, 128), (2, 4, 80, 128, 256, 128))
# phase 3b's timing at d_head 80: h2o-danube-1.8b's served window (phase 20
# (c)): rows (2 x 8 KV heads), G, d, near slots, far keys (4,096 slots cut
# at near 1,024), blk, layers taken in turn
ATTN_D80 = dict(rows=16, g=4, d=80, near=1_024, far=3_072, blk=128, layers=24)
ATTN_SCALES = (0.5, 1.0, 2.0)
ATTN_MAX_ABS = 1e-3
MLE = dict(n=8_192, nb=512, t=4, max_iters=15)
# phase 8: every hold-th of n_all points held out, the first n_obs of the
# rest observed (n_obs = p nb); the fields of 8.1; the estimation's engine
# chunk, grid and Nelder-Mead iterations; k-fold; phase 8.4's candidates.
# --quick leaves out the medium field: at nb = 128 its bf16 likelihood is
# finite but so sensitive that reordering a sum moves it by 2e-3
FIDELITY = dict(n_all=45_056, hold=11, n_obs=40_960, nb=1_024,
                fields=("medium", "weak"), chunk=3, grid=3, refine=2,
                nm_iters=20, kfold=10, batch=8)
FIDELITY_QUICK = dict(n_all=5_632, hold=11, n_obs=5_120, nb=128,
                      fields=("weak",), chunk=3, grid=3, refine=2,
                      nm_iters=3, kfold=10, batch=8)
# phase 8.6: max relative error of the fp32 general-nu covariance against
# fp64, the bound tests/test_torch_covariance.py holds it to on the CPU
GENERAL_NU_MAX_REL = 1e-4
WEAK = (1.0, 0.03, 0.5)
MEDIUM = (1.0, 0.10, 0.5)
# phase 9: the paper pair on an fp64 medium field, split as phase 8's; the
# estimation's grid and Nelder-Mead iterations (8, cut from phase 8.2's 20
# when phase 17 came: both fits start from one grid point and move alike,
# to the same theta-hat at 20 on the H100); --quick runs the evaluations
# and the kernels only
PAPER = dict(n_all=45_056, hold=11, n_obs=40_960, nb=1_024, grid=3, refine=2,
             nm_iters=8, estimate=True)
PAPER_QUICK = dict(n_all=5_632, hold=11, n_obs=5_120, nb=128, grid=3,
                   refine=2, nm_iters=3, estimate=False)
# the paper pair's registered loglik_drift (src/repro/verify/bounds.py),
# measured at n of a few hundred; phase 9 reports against it
PAPER_LOGLIK_DRIFT = 1e-6
# phase 10: matern_cov_grad's check size; the Adam fits (the reference
# test's setting at n = 8,192 on phase 6's field, then n_obs for as many
# steps as fit in adam_seconds) and the Nelder-Mead iterations they are held
# against; the peak an fp64 value-and-gradient evaluation may reach before
# its n_obs is cut; 10.3's tile path: n_obs and nb (phase 8's)
GRAD = dict(check_n=4_096, adam_n=8_192, adam_steps=120, adam_lr=0.05,
            adam_seconds=12.0, nm_iters=60, peak_gib=70.0, tile_n=40_960,
            tile_nb=1_024)
GRAD_QUICK = dict(check_n=1_024, adam_n=2_048, adam_steps=20, adam_lr=0.05,
                  adam_seconds=5.0, nm_iters=20, peak_gib=70.0, tile_n=5_120,
                  tile_nb=128)
# matern_cov_grad against its plain version, of the scale sum |G| dK/dtheta:
# the terms in fp32 differ by the exps' last bits (~2.4e-7 each at most),
# in fp64 by ~1e-16; the sums in fp64 in other orders
GRAD_KERNEL_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-12}
# a value-and-gradient evaluation, kernel path against plain path (max
# gradient error over max |gradient|, and |ll| relative): Sigma differs by
# those last bits, which the Cholesky of an ill-conditioned Sigma amplifies
# in fp32 (phase 8.1 holds the log-likelihood to 1e-3 for the same reason)
GRAD_EVAL_TOL = {"torch.float32": 1e-3, "torch.float64": 1e-8}
# phase 11 (b): the scale leg's sizes (the paper's estimation size and a
# quarter of it), regimes and tile; the peak its predicted reckoning may
# reach before n is cut; the paper pair's loglik_drift limit (phase 9.1's)
SCALE = dict(sizes=(10_240, 40_960), regimes=("weak", "medium"), nb=1_024,
             peak_gib=70.0, pair_drift=1e-4)
SCALE_QUICK = dict(sizes=(4_096, 8_192), regimes=("weak", "medium"), nb=1_024,
                   peak_gib=70.0, pair_drift=1e-4)
# phase 12: (a)'s tile grid and tile, (b)'s tile (its n is phase 8's and 9's
# n_obs); the scheduled path's peak against the sequential engine's
RUNTIME = dict(small_p=8, small_nb=128, nb=1_024, peak_ratio=1.25)
RUNTIME_QUICK = dict(small_p=8, small_nb=128, nb=128, peak_ratio=1.25)
# phase 13: the dense haversine Sigma's n (phase 8's n_obs), (c)'s n_obs and
# nb (phase 8's), and the peak a panel value-and-gradient evaluation may be
# predicted to reach before its n is cut (phase 10's)
PANEL = dict(n_dense=40_960, n_obs=40_960, nb=1_024, peak_gib=70.0)
PANEL_QUICK = dict(n_dense=4_096, n_obs=5_120, nb=128, peak_gib=70.0)
# phase 14: (a)'s n, nb and t; the peak an evaluation may be predicted to
# reach before its n is cut (phase 10's); (b) runs at phase 4's size, (c)
# at phase 9's
DIST = dict(small_n=1_024, small_nb=128, small_t=2, peak_gib=70.0)
# phase 15: (a)'s calibration cell (the committed table's), (b)'s trace
# cell, (c)'s batch of candidates and its n_obs; a span against the host
# clock around a sync, relative; --quick runs p = 6 at nb = 256
OBS = dict(cal_p=6, cal_nb=1_024, cal_reps=3, trace_p=16, trace_nb=1_024,
           workers=4, batch=4, batch_n=8_192, batch_nb=1_024, span_tol=0.1,
           skew_reps=20)
OBS_QUICK = dict(OBS, cal_nb=256, trace_p=6, trace_nb=256, batch_n=2_048,
                 batch_nb=256)
# phase 16: (b)'s random seeds per (cell, workers) (the CLI's), and the
# phase's time limit in seconds; --quick runs fewer seeds in (b), whose
# distinct-interleaving floor (c)'s full matrix then holds
ANALYSIS = dict(seeds=12, limit_s=30.0)
ANALYSIS_QUICK = dict(seeds=4, limit_s=30.0)
# phase 17: (b) llama3.2-1b's full config (with --quick, train_lm's 20m size)
# at train_4k's sequence length: global batch, microbatches, steps, whether
# the last step runs under the profiler, the peak a step may be predicted to
# reach before its microbatch is halved; (c) train_lm's size, batch,
# sequence, steps, checkpoint interval and injected failures; the phase's
# time limit in seconds
TRAIN = dict(arch="llama3.2-1b", size=None, batch=8, microbatches=4, steps=6,
             profile=True, peak_gib=70.0, loop_size="100m", loop_batch=8,
             loop_seq=512, loop_steps=20, ckpt_every=5, fail_at=(7, 13),
             limit_s=90.0)
TRAIN_QUICK = dict(TRAIN, size="20m")
# 17 (a): the SMOKE model's steps, card against CPU (fp32 compute): loss and
# lr relative, grad norm relative, the params' update (||card - cpu|| over
# the CPU's update), each moment's largest difference over its largest
# entry; from the port's measured distance to the JAX package on the CPU
# (tests/test_torch_train.py: 3.1e-7, 9.6e-8, 3.7e-5, 5.0e-4 and, after a
# compressed step, 1.1e-2), a few times over: the card sums in other orders
TRAIN_CPU_TOL = dict(loss=1e-5, lr=1e-6, grad_norm=1e-4, update=2e-3, m=3e-2,
                     v=3e-2)
# phase 18: (b) qwen3-moe-30b-a3b at full width with its depth cut 48 -> 4
# (the fp32 params of all 48 layers are 122 GB; 4 are 12.8 GB; 16 until
# phase 19 came and the script's time neared 1,000 s, 8 until phase 20
# came) at phase 7's traffic
# and banded attention, its weights' seed, the prefill taken under the
# profiler and the one run twice for the same bits (None: the whole
# prompt), the peak the prediction may reach before the batch is halved;
# (a) the SMOKE configs, their prompt and decode steps; the phase's time
# limit in seconds.  --quick: 4 layers at phase 7's --quick traffic
MOE = dict(arch="qwen3-moe-30b-a3b", layers=4, batch=4, prompt=8_192, new=64,
           seed=18, profile_prompt=None, check_prompt=None,
           near=1_024, blk=128, peak_gib=70.0,
           smoke=("qwen3-moe-30b-a3b", "grok-1-314b"), smoke_prompt=(2, 24),
           smoke_steps=4, limit_s=90.0)
MOE_QUICK = dict(MOE, layers=4, batch=2, prompt=1_024, new=8, near=256)
# phase 19: (b) xlstm-1.3b at full width with its depth cut 48 -> 24 (for
# phase 20's time: 48 took 35 s of a full run on a slow host), (c)
# jamba-v0.1-52b at full width with its depth cut 32 -> 8 (one cycle of its
# 8-block pattern: all 32 layers' fp32 params are ~208 GB, 8 are 53.2 GB),
# each with its
# batch, prompt, new tokens, seed, the prefill taken under the profiler
# and the one run twice for the same bits (None: the whole prompt); the
# served attention cache's near window and block; the peak the prediction
# may reach before the batch is halved; (a) the SMOKE configs, their
# prompt (not a multiple of jamba's mamba_chunk of 8), decode steps and the
# lm_loss batch (S = 128: two mLSTM chunks); the phase's time limit in
# seconds.  (b)'s prompt is cut 1,024 -> 512, and phase 18 (b)'s depth
# 16 -> 8, toward a script under 1,000 s; (b) profiles a 4-token prefill
# (it is host-bound, ~1,200 launches a token, and a 128-token trace took
# 72 s to process on one H100) and checks the same bits on 128 tokens.
# --quick: 4 xlstm layers, shorter prompts
SSM = dict(xlstm=dict(arch="xlstm-1.3b", layers=24, batch=4, prompt=512,
                      new=64, seed=19, profile_prompt=4, check_prompt=128),
           jamba=dict(arch="jamba-v0.1-52b", layers=8, batch=4, prompt=4_096,
                      new=32, seed=19, profile_prompt=128, check_prompt=None),
           near=1_024, blk=128, peak_gib=70.0,
           smoke=("xlstm-1.3b", "jamba-v0.1-52b"), smoke_prompt=(2, 20),
           smoke_steps=4, smoke_loss=(2, 128), limit_s=90.0)
SSM_QUICK = dict(SSM, xlstm=dict(SSM["xlstm"], layers=4, batch=2, prompt=128,
                                 new=8),
                 jamba=dict(SSM["jamba"], batch=2, prompt=1_024, new=8),
                 near=256)
# phase 20: (b) whisper-tiny at full width and depth, uncut (d 384, 4 + 4
# layers, 1,500 frames), batch 16 x 32-token prompts and 64 new tokens, its
# cross caches through the banded attention at near 256 so that their far
# segment is not empty (its 95-row self caches have no far block at any
# near window, so they stay out); (c) llava-next-34b at full width with
# its depth cut 60 -> 8 (fp32 params: ~21.7 GB; all 60 ~138 GB), 2 x
# (2,880 patches + 1,216 text tokens) = 4,096 positions, 32 new tokens;
# h2o-danube-1.8b uncut (24 layers, 7.3 GB fp32), 2 x 8,192-token prompts
# past its 4,096 window (the prompt a multiple of it, ROADMAP C 25), 32 new
# tokens, its window through mp_attention at d_head 80; each with its seed,
# the prefill taken under the profiler and the one run twice (None: the
# whole prompt); the near window (whisper's own for its cross caches) and
# block; the peak the prediction may reach before the batch is halved; (a)
# the five SMOKE configs, their prompt, decode steps and lm_loss batch; the
# phase's time limit in seconds.  --quick: shorter prompts, llava at 2
# layers, h2o at 4
ZOO = dict(whisper=dict(arch="whisper-tiny", layers=4, batch=16, prompt=32,
                        new=64, seed=20, profile_prompt=None, check_prompt=None,
                        near=256, banded_self=False),
           llava=dict(arch="llava-next-34b", layers=8, batch=2, prompt=1_216,
                      new=32, seed=20, profile_prompt=None, check_prompt=None),
           h2o=dict(arch="h2o-danube-1.8b", layers=24, batch=2, prompt=8_192,
                    new=32, seed=20, profile_prompt=1_024, check_prompt=None),
           near=1_024, blk=128, peak_gib=70.0,
           smoke=("whisper-tiny", "llava-next-34b", "qwen3-4b", "qwen3-32b",
                  "h2o-danube-1.8b"), smoke_prompt=(2, 20), smoke_steps=4,
           smoke_loss=(2, 32), limit_s=120.0)
ZOO_QUICK = dict(ZOO, whisper=dict(ZOO["whisper"], batch=4, new=8),
                 llava=dict(ZOO["llava"], layers=2, prompt=256, new=8),
                 h2o=dict(ZOO["h2o"], layers=4, prompt=4_096, new=8,
                          profile_prompt=256),
                 near=256)
# 18 (a): the aux loss, card against CPU, relative: an fp32 mean of fp32
# softmax outputs and integer counts, summed in other orders
MOE_AUX_TOL = 1e-6
# CUDA events resolve to about half a microsecond: the happens-before
# check's slack on device times, in microseconds
HB_ATOL_US = 1.0
# phase 12 (b): the scheduled log-likelihood against the sequential one,
# relative (phase 8.1's limit for tpu(2), phase 9.1's for the pair)
RUNTIME_LOGLIK_TOL = {"tpu(2)": 1e-3, "paper_cpu(2)": 1e-5}
# 14 (d.2)'s plain check of each matern_cov_grad launch: G's elements per
# plain call (a 512 MiB |G| chunk in bf16), and the limit over the scale:
# the kernel's fp32 terms are the plain version's at nu = 0.5 and the fp64
# sums come in other orders (read at most 6.6e-19, NVIDIA H100 80GB HBM3,
# 700 W); an exp's last bits (2.4e-7 a term, GRAD_KERNEL_TOL) averaged over
# the 6e7 or more terms of a call stay under 1e-10
GRAD_ELEMS_CHECK = 2 ** 28
DIST_CHECK_TOL = 1e-9
# phase 14 (d.1), (d.3): the distributed gradient, kernels against plain,
# over s_k = sum |G| dSigma/dtheta_k, by the locations' dtype: read at
# n = 1,024 4.6e-9 tpu(2), 6.4e-9 full(fp32) (the factor's kernels and
# bf16 roundings, not matern_cov_grad's: GRAD_KERNEL_TOL), 0 for fp64
# locations, also at 38,912 (NVIDIA H100 80GB HBM3, 700 W); fifteen times
# the largest fp32 reading, and fp64's sums in other orders
DIST_KERNEL_TOL = {"torch.float32": 1e-7, "torch.float64": 1e-12}
# phase 14 (d.3): the pair's distributed gradient against 10.1's dense
# full(fp64) one on the same field, max_k |delta_k| / s_k: read 2.1e-11
# (theta1) and 1.0e-11 (theta2); the gradient is 1.7e-7 and 1.0e-7 of s_k
# there (its terms cancel), so this is 1.0e-4 of its largest component.
# The pair's fp32 off-band storage, not the adjoint: PERF.md, PR 33
DIST_PAIR_FP64_TOL = 5e-11
# phase 21: a measured peak may pass its reckoning by at most this share
# of the reckoning (the runs it holds have come within 0.5 % where the
# reckoning had its terms; one further below is reported)
PLAN_PEAK_TOL = 0.02
PLANNING = dict(limit_s=30.0)
# what phases 4, 12 (b), 14 (b), 14 (d.2), 17 (b) and 18-20 measured, for
# phase 21 (and 10.1's full(fp64) and 13 (b)'s tpu gradients, for 14 (d))
MEASURED: dict = {}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=5, calls=1):
    """Median CUDA-event time of fn() over `reps` runs after one warm-up.
    With calls > 1 each run times that many calls back to back and gives
    the time per call: the device's own time once a call takes longer than
    the host needs to launch the next, where one call alone also holds the
    host's launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    import torch
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def fp32_ulp(x):
    """One fp32 ulp at |x| (24 significant bits), in fp64."""
    import torch
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 24)


def scale_rel(out, ref):
    """max |out - ref| over max |ref| (the conformance sweep's max_rel)."""
    d = (out.double() - ref.double()).abs().max()
    return float(d / ref.double().abs().max().clamp_min(1e-30))


def lower_band_tiles(n_t, t):
    """Tile pairs (i, j) of an n_t x n_t grid with 0 <= i - j < t."""
    return sum(min(i + 1, t) for i in range(n_t))


def syrk_products(n_t, t):
    """(in-band, off-band) tile products a SYRK of n_t tile rows needs: the
    lower triangle with its diagonal, since U = P P^T is symmetric."""
    in_band = lower_band_tiles(n_t, t)
    return in_band, n_t * (n_t + 1) // 2 - in_band


# template arguments in a mangled name: types (typed=True) and integers
_MANGLED_ARG = re.compile(r"13__nv_bfloat16|L[ib]\d+E|[fd]")
_TYPE_NAMES = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}


def _kernel_key(mangled, names, typed=False):
    """"name<template arguments>" of a mangled kernel whose name holds one of
    `names`, else None: its integer arguments, and with typed=True its types
    too (f32, f64, bf16) in their order."""
    name = next((n for n in names if n in mangled), None)
    if name is None:
        return None
    rest = mangled.split(name, 1)[1].split("Ev", 1)[0]
    if typed:
        args = [_TYPE_NAMES.get(a) or a[2:-1]
                for a in _MANGLED_ARG.findall(rest.removeprefix("I"))]
    else:
        args = re.findall(r"L[ib](\d+)E", rest)
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_usage(log_path, names, typed=False):
    """Registers, stack and spill bytes of every kernel instantiation whose
    name holds one of `names`, from ptxas -v's lines in the build's log."""
    usage, key, entry, props = {}, None, None, None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            key = _kernel_key(entry, names, typed)
            if key:
                usage[key] = {}
        elif "Function properties for" in line:
            # a called (out-of-line) function's properties come between
            # its caller's lines: only the entry's own count
            props = line.split("Function properties for", 1)[1].strip()
        elif key and props == entry and "bytes stack frame" in line:
            stack, stores, loads = (int(x) for x in re.findall(r"(\d+) bytes", line))
            usage[key].update(stack=stack, spill_stores=stores, spill_loads=loads)
        elif key and "Used" in line and "registers" in line:
            usage[key]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            key = None
    return usage


def sass_counts(lib, names, ops=("DMMA", "DFMA", "FFMA"), typed=False):
    """SASS instructions of each op in `ops` in every kernel instantiation
    whose name holds one of `names`, from cuobjdump -sass of the library."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = _kernel_key(line.split("Function :", 1)[1].strip(), names,
                              typed)
            if key:
                counts[key] = dict.fromkeys(ops, 0)
        elif key:
            for op in ops:
                counts[key][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def syrk_grad_class(name):
    """The class of an mp_syrk_grad kernel from its name as the profiler
    gives it (demangled), else None: "prepass", "offband" (the wgmma
    kernel, the fp32 engine with OFF = true) or "band" (DMMA, the fp32
    engine with OFF = false)."""
    kernel = next((k for k in SYRK_GRAD_KERNELS if k in name), None)
    if kernel is None:
        return None
    if kernel in SYRK_GRAD_PREPASS:
        return "prepass"
    if kernel == "mp_syrk_grad_fp32_kernel":
        return "offband" if ", true>" in name else "band"
    return "offband" if "wgmma" in kernel else "band"


def syrk_grad_device_ms(rows):
    """({class: ms}, total ms) of mp_syrk_grad's kernels among
    device_profile's rows (name, count, ms); no other kernel counts."""
    out = dict.fromkeys(("prepass", "offband", "band"), 0.0)
    for name, _, ms in rows:
        cls = syrk_grad_class(name)
        if cls:
            out[cls] += ms
    return out, sum(out.values())


def check_syrk_grad_build(lib):
    """mp_syrk_grad's kernels in the build (phase 2): ptxas's registers and
    spills and their SASS counts; 22 instantiations, the main path's 128 x
    128 engines without spills, the fp64 band on DMMA, the bf16 off-band
    on wgmma."""
    from repro_torch.kernels import _build
    usage = ptxas_usage(lib.parent / _build.LOG_NAME, SYRK_GRAD_KERNELS, typed=True)
    sass = sass_counts(lib, SYRK_GRAD_KERNELS, SYRK_GRAD_SASS_OPS, typed=True)
    emit(phase="build", kernel="mp_syrk_grad", ptxas=usage, sass=sass)
    main = [k for k in usage if "<128,128" in k]
    require(len(usage) == len(sass) == 22 and len(main) == 4
            and all(usage[k]["spill_stores"] == 0 for k in main),
            f"mp_syrk_grad kernels: {len(usage)} in ptxas, {len(sass)} in "
            f"SASS; the 128 x 128 engines {main} spill or are missing")
    require(all(v["DMMA"] > 0 and v["DFMA"] == 0 for k, v in sass.items()
                if k.startswith("mp_syrk_grad_dmma_kernel"))
            and all(v["HGMMA"] > 0 for k, v in sass.items()
                    if k.startswith("mp_syrk_grad_offband_wgmma_kernel")),
            f"mp_syrk_grad's engines are off their units: {sass}")


def plan():
    """`repro_torch.launch.costmodel`: the memory plans and FLOP reckonings
    the phases predict with (importable once src/ is on the path)."""
    from repro_torch.launch import costmodel
    return costmodel


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_matern(locs_t, theta, t, nu_main, results):
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    p, nb, _ = locs_t.shape
    worst = 0.0
    # the main path's band launches: sub-diagonals written into the strided
    # (p, t, nb, nb) band storage (tile stride t nb^2); the rest stays zero
    out = torch.zeros((p, t, nb, nb), device=locs_t.device)
    want = torch.zeros_like(out)
    for d in range(t):
        args = (locs_t[d:], locs_t[:p - d], theta)
        ops.matern_cov_tiles(*args, nu=nu_main, out=out[d:, d])
        ref.matern_cov_tiles(*args, nu=nu_main, out=want[d:, d])
    err = (out - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    require(rel <= 1e-5, f"matern band storage: rel {rel}")
    worst = float(err.max())
    emit(phase="kernels", kernel="matern_cov", launch="band storage",
         shape=[p, t, nb, nb], nu=nu_main, max_abs_err=worst, max_rel_err=rel)
    del out, want, err
    # the band launch of sub-diagonal 0 (the diagonal tiles) is the
    # symmetric form: the same bits as the general form (the locations as
    # a copy), each tile its own transpose
    worst = max(worst, check_matern_sym(locs_t, theta, nu_main, "band d=0"))
    # the band launch of sub-diagonal 1 (p - 1 tile pairs), every nu and dtype
    for nu in (0.5, 1.5, 2.5):
        for dt in (torch.float32, torch.bfloat16):
            args = (locs_t[1:], locs_t[:p - 1], theta)
            out = ops.matern_cov_tiles(*args, nu=nu, out_dtype=dt)
            want = ref.matern_cov_tiles(*args, nu=nu, out_dtype=dt)
            err = (out.float() - want.float()).abs()
            if dt == torch.float32:
                # same IEEE operations up to exp: rel 1e-5 per element
                rel = float((err / want.abs().clamp_min(1e-30)).max())
                require(rel <= 1e-5, f"matern fp32 nu={nu}: rel {rel}")
            else:
                # both round one fp32 value to bf16: within 1 bf16 ulp
                ulps = float((err / bf16_ulp(torch.maximum(out.float().abs(),
                                                           want.float().abs()))).max())
                require(ulps <= 1.0, f"matern bf16 nu={nu}: {ulps} ulp")
            worst = max(worst, float(err.max()))
            emit(phase="kernels", kernel="matern_cov", launch="band d=1",
                 tiles=p - 1, nb=nb, nu=nu, dtype=str(dt),
                 max_abs_err=float(err.max()))
    def band_d1():
        return ops.matern_cov_tiles(locs_t[1:], locs_t[:p - 1], theta, nu=nu_main,
                                    out_dtype=torch.float32)
    band_ms = time_ms(band_d1)
    band_device_ms = time_ms(band_d1, calls=10)
    # the full off-band launch of the main path: bf16 tiles with i - j >= t,
    # compared one tile row at a time to keep the fp32 temporaries small
    out = ops.matern_cov_lower(locs_t, theta, nu=nu_main, min_lag=t,
                               out_dtype=torch.bfloat16)
    want = ref.matern_cov_lower(locs_t, theta, nu=nu_main, min_lag=t,
                                out_dtype=torch.bfloat16)
    ulps = 0.0
    for i in range(p):
        o, w = out[i].float(), want[i].float()
        err = (o - w).abs()
        ulps = max(ulps, float((err / bf16_ulp(torch.maximum(o.abs(), w.abs()))).max()))
        worst = max(worst, float(err.max()))
    require(ulps <= 1.0, f"matern off-band launch: {ulps} ulp")
    del out, want, o, w, err
    ms = time_ms(lambda: ops.matern_cov_lower(
        locs_t, theta, nu=nu_main, min_lag=t, out_dtype=torch.bfloat16))
    plain_ms = time_ms(lambda: ref.matern_cov_lower(
        locs_t, theta, nu=nu_main, min_lag=t, out_dtype=torch.bfloat16))
    lower_elems = (p - t) * (p - t + 1) // 2 * nb * nb
    bytes_moved = locs_t.numel() * 4 + p * p * nb * nb * 2
    flops = 9 * lower_elems  # 2 sub, 2 mul, add, sqrt, div, exp, mul
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    band_elems = (p - 1) * nb * nb
    band_bound_ms = 1e3 * max((2 * (p - 1) * nb * 8 + 4 * band_elems) / HBM_BYTES_PER_S,
                              9 * band_elems / FP32_FLOPS)
    emit(phase="kernels", kernel="matern_cov", launch="off-band",
         shape=[p, p, nb, nb], max_bf16_ulps=ulps, ms=ms, plain_ms=plain_ms,
         band_d1_ms=band_ms, band_d1_back_to_back_ms=band_device_ms,
         band_d1_bound_ms=band_bound_ms, bound_ms=bound_ms)
    results["matern_cov"] = dict(
        name="matern_cov", route="cuda", source="src/repro_torch/csrc/matern_cov.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS
        else "operations", library_ms=None)


def check_matern_sym(locs_t, theta, nu_main, what):
    """The symmetric zip form on tiles (B, nb, 2) at every nu and output
    dtype: bit for bit the general form's output (the same locations as a
    copy) and each tile its own transpose, within the phase's tolerance of
    the plain version (fp32 rel 1e-5, bf16 1 ulp, fp64 1e-12 theta1, fp64 ->
    fp32 1 fp32 ulp); both forms timed at nu_main in the first dtype.
    Returns the largest error against the plain version."""
    import torch
    from repro_torch.kernels.matern_cov import matern_cov as mc_kernel
    from repro_torch.kernels.matern_cov import ops, ref
    f32, f64 = torch.float32, torch.float64
    dtypes = (f32, torch.bfloat16) if locs_t.dtype == f32 else (f64, f32)
    copy = locs_t.clone()
    require(mc_kernel.symmetric(locs_t, locs_t) and not mc_kernel.symmetric(locs_t, copy),
            "matern_cov symmetric dispatch")
    worst = 0.0
    for nu in (0.5, 1.5, 2.5):
        for dt in dtypes:
            out = ops.matern_cov_tiles(locs_t, locs_t, theta, nu=nu, out_dtype=dt)
            gen = ops.matern_cov_tiles(locs_t, copy, theta, nu=nu, out_dtype=dt)
            want = ref.matern_cov_tiles(locs_t, locs_t, theta, nu=nu, out_dtype=dt)
            same = bool(torch.equal(out, gen))
            sym = bool(torch.equal(out, out.transpose(1, 2)))
            err = (out.double() - want.double()).abs()
            if dt == torch.bfloat16:
                tol = bf16_ulp(torch.maximum(out.float().abs(), want.float().abs()))
            elif dt == f32 and locs_t.dtype == f64:
                tol = fp32_ulp(torch.maximum(out.double().abs(), want.double().abs()))
            elif dt == f32:
                tol = 1e-5 * want.double().abs()
            else:
                tol = torch.full_like(err, 1e-12 * theta[0])
            ratio = float((err / tol.double().clamp_min(1e-300)).max())
            require(same and sym and ratio <= 1.0,
                    f"matern_cov {what} symmetric {dt} nu={nu}: equal to general "
                    f"{same}, to its transpose {sym}, {ratio} of the tolerance")
            worst = max(worst, float(err.max()))
            line = dict(tiles=list(locs_t.shape[:2]), nu=nu, dtype=str(dt),
                        locs=str(locs_t.dtype), equal_to_general=same,
                        equal_to_transpose=sym, max_abs_err=float(err.max()),
                        err_over_tol=ratio)
            if nu == nu_main and dt == dtypes[0]:
                line["ms"] = time_ms(lambda: ops.matern_cov_tiles(
                    locs_t, locs_t, theta, nu=nu, out_dtype=dt))
                line["ms_general"] = time_ms(lambda: ops.matern_cov_tiles(
                    locs_t, copy, theta, nu=nu, out_dtype=dt))
            emit(phase="kernels", kernel="matern_cov", launch=f"{what} symmetric",
                 **line)
            del out, gen, want, err, tol
    return worst


def check_matern_fp64(locs_t, theta, t, results):
    """matern_cov's two fp64 forms on phase 4's paper_cpu(t) request, at
    every nu, on the main path's locations in fp64: the band storage written
    as fp64 (<= 1e-12 theta1 from the plain version), and the off-band
    lower form computed in fp64 and rounded once to fp32.  That fp32 output
    must equal the plain version's fp64 value rounded once, bit for bit,
    wherever the kernel's own fp64 value (the zip form on the same tile
    pairs) equals the plain one, and be within one fp32 ulp elsewhere; a
    kernel that computed in fp32 would differ on a large share of them.
    Compared one tile row at a time."""
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    f32, f64 = torch.float32, torch.float64
    locs_t = locs_t.double()
    p, nb, _ = locs_t.shape
    tol = 1e-12 * theta[0]
    worst = 0.0
    for nu in (0.5, 1.5, 2.5):
        out = torch.zeros((p, t, nb, nb), dtype=f64, device=locs_t.device)
        want = torch.zeros_like(out)
        for d in range(t):
            args = (locs_t[d:], locs_t[:p - d], theta)
            ops.matern_cov_tiles(*args, nu=nu, out_dtype=f64, out=out[d:, d])
            ref.matern_cov_tiles(*args, nu=nu, out_dtype=f64, out=want[d:, d])
        band_err = float((out - want).abs().max())
        del out, want
        require(band_err <= tol, f"matern fp64 band storage nu={nu}: {band_err}")
        if nu == 0.5:  # the symmetric d = 0 launch, every nu and output dtype
            worst = max(worst, check_matern_sym(locs_t, theta, nu, "band d=0 fp64"))
        low = ops.matern_cov_lower(locs_t, theta, nu=nu, min_lag=t,
                                   out_dtype=f32)
        require(low.dtype == f32, f"matern fp64 -> fp32 lower: {low.dtype}")
        off_err, ulps, differ, split = 0.0, 0.0, 0, 0
        for i in range(p):
            j = max(0, i - t + 1)  # tiles (i, jj) with i - jj >= t
            require(not bool(low[i, j:].any()),
                    f"matern fp64 -> fp32 lower nu={nu}: tile row {i} not zero")
            if j == 0:
                continue
            cols = locs_t[:j].reshape(-1, 2)
            w64 = ref.matern_cov(locs_t[i], cols, theta, nu=nu, out_dtype=f64)
            k64 = ops.matern_cov(locs_t[i], cols, theta, nu=nu, out_dtype=f64)
            o = low[i, :j].transpose(0, 1).reshape(nb, -1)
            w = w64.to(f32)
            ne = o != w
            differ += int(ne.sum())
            split += int((ne & (k64 == w64)).sum())
            d = (o.double() - w.double()).abs()
            off_err = max(off_err, float(d.max()))
            ulps = max(ulps, float((d / fp32_ulp(torch.maximum(
                o.double().abs(), w.double().abs()))).max()))
        del low, w64, k64, o, w, ne, d
        torch.cuda.empty_cache()
        require(split == 0 and ulps <= 1.0,
                f"matern fp64 -> fp32 lower nu={nu}: {split} elements differ "
                f"where the fp64 values agree, {ulps} ulp")
        worst = max(worst, band_err, off_err)
        emit(phase="kernels", kernel="matern_cov", dtype=str(f64),
             launch="band storage fp64, off-band fp64 -> fp32", nu=nu,
             shape=[p, t, nb, nb], band_max_abs_err=band_err, tol=tol,
             offband_min_lag=t, offband_elements_differ=differ,
             offband_differ_where_fp64_agrees=split, offband_max_fp32_ulps=ulps,
             offband_max_abs_err=off_err)
    results.setdefault("matern_cov_fp64", {})["max_abs_err"] = worst


def spd_batch(gen, b, nb, *, indefinite=False):
    """(b, nb, nb) SPD tiles with eigenvalues log-spaced on [1, 100]."""
    import torch
    q, _ = torch.linalg.qr(torch.randn((b, nb, nb), generator=gen,
                                       device="cuda", dtype=torch.float64))
    eigs = torch.logspace(0.0, 2.0, nb, dtype=torch.float64, device="cuda")
    if indefinite:
        eigs = eigs.clone()
        eigs[nb // 2] = -1.0
    return ((q * eigs) @ q.mT).float().contiguous()


def indefinite_at(a, j):
    """a (nb, nb) SPD fp32 tile with a[j, j] lowered so that its (j + 1)-th
    pivot is -1 and the leading j pivots are those of a."""
    import torch
    a = a.clone()
    a64 = a.double()
    lead = torch.linalg.cholesky(a64[:j, :j])
    x = torch.linalg.solve_triangular(lead, a64[:j, j:j + 1], upper=False)
    a[j, j] = float(a64[j, j] - (x * x).sum() - 1.0)  # pivot d_j - d_j - 1
    return a


def check_potrf(gen, nb_main, results):
    import torch
    from repro_torch.kernels.blocked_potrf import ops, ref
    worst = 0.0
    # batch 8 at every size, batch 1 where the grid path's ragged last panel
    # (nb not a multiple of 64) or the main path's single tile is exercised
    cases = [(nb, 8) for nb in sorted({32, 128, 520, 1000, 1024, nb_main})]
    cases += [(520, 1), (1000, 1), (nb_main, 1)]
    for nb, batch in cases:
        a = spd_batch(gen, batch, nb)
        l, info = ops.potrf(a)
        want, info_ref = ref.potrf(a)
        require(int(info.abs().sum()) == 0 and int(info_ref.abs().sum()) == 0,
                f"potrf nb={nb}: SPD tiles flagged")
        # bounds.py ("kernel", "blocked_potrf"): max_rel 1e-3, backward 1e-4
        rel = scale_rel(l, want)
        l64, a64 = l.double(), a.double()
        back = float(((l64 @ l64.mT - a64).norm(dim=(-2, -1))
                      / a64.norm(dim=(-2, -1))).max())
        upper = bool((torch.triu(l, diagonal=1) == 0).all())
        require(rel <= 1e-3 and back <= 1e-4 and upper,
                f"potrf nb={nb} batch={batch}: max_rel {rel}, backward {back}, "
                f"upper zero {upper}")
        worst = max(worst, float((l - want).abs().max()))
        emit(phase="kernels", kernel="blocked_potrf", nb=nb, batch=batch,
             max_rel=rel, backward_rel=back)
    # indefinite tiles: at nb = 128 (one-block path) a negative eigenvalue;
    # at nb = 1024 (grid path) a bad pivot in the last panel, at column
    # 1001, beside an SPD tile: the same info as the plain version, and
    # only the failed tile all NaN
    a = spd_batch(gen, 2, 128, indefinite=True)
    l, info = ops.potrf(a)
    _, info_ref = ref.potrf(a)
    require(bool((info > 0).all()) and bool((info_ref > 0).all()),
            f"potrf indefinite: info {info.tolist()} / {info_ref.tolist()}")
    require(bool(torch.isnan(l).all()), "potrf indefinite: factor not NaN")
    emit(phase="kernels", kernel="blocked_potrf", indefinite=True, nb=128,
         info=info.tolist(), info_plain=info_ref.tolist())
    a = spd_batch(gen, 2, 1024)
    a[1] = indefinite_at(a[1], 1000)
    for batch in (2, 1):
        x = a[2 - batch:].contiguous()
        l, info = ops.potrf(x)
        want, info_ref = ref.potrf(x)
        require(info.tolist() == info_ref.tolist() and info[-1] == 1001,
                f"potrf nb=1024 indefinite: info {info.tolist()} / "
                f"{info_ref.tolist()}")
        require(bool(torch.isnan(l[-1]).all()), "potrf nb=1024: factor not NaN")
        if batch == 2:
            require(bool(torch.isfinite(l[0]).all())
                    and scale_rel(l[0], want[0]) <= 1e-3,
                    "potrf nb=1024: the SPD tile beside a failed one")
        emit(phase="kernels", kernel="blocked_potrf", indefinite=True, nb=1024,
             batch=batch, info=info.tolist(), info_plain=info_ref.tolist())
    # timing at the main path's shape: one tile of nb_main per launch
    a1 = spd_batch(gen, 1, nb_main)[0]
    ms = time_ms(lambda: ops.potrf(a1))
    plain_ms = time_ms(lambda: ref.potrf(a1))
    library_ms = time_ms(lambda: torch.linalg.cholesky(a1))
    flops = nb_main ** 3 / 3
    bytes_moved = 2 * 4 * nb_main ** 2
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    emit(phase="kernels", kernel="blocked_potrf", nb=nb_main, batch=1, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    results["blocked_potrf"] = dict(
        name="blocked_potrf", route="cuda",
        source="src/repro_torch/csrc/blocked_potrf.cu",
        replaces="src/repro/kernels/blocked_potrf/blocked_potrf.py:48",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if flops / FP32_FLOPS >= bytes_moved / HBM_BYTES_PER_S
        else "bytes", library_ms=library_ms)


def _syrk_errors(out, want, p, *, tile, round_k, band):
    """(in-band max_rel, off-band worst |err| / tol, max abs err), row slab
    by row slab.  Off-band tolerance per element: one bf16 ulp of each
    rounded partial sum (two where it sits at a power of two), plus twice
    the fp32 summation bound gamma_k |p_i| |p_j| of each partial, since the
    kernel and cuBLAS sum in different orders."""
    import torch
    m, kdim = p.shape
    gamma = round_k * 2.0 ** -24 / (1 - round_k * 2.0 ** -24)
    p_lo = p.to(torch.bfloat16).float()
    tiles = torch.arange(m, device=p.device) // tile
    band_num = band_den = off_ratio = max_abs = 0.0
    for r0 in range(0, m, tile):
        rows = slice(r0, r0 + tile)
        d = (out[rows].double() - want[rows].double()).abs()
        max_abs = max(max_abs, float(d.max()))
        in_band = (tiles[rows, None] - tiles[None, :]).abs() < band
        band_num = max(band_num, float(d[in_band].max()))
        band_den = max(band_den, float(want[rows][in_band].abs().max()))
        if bool(in_band.all()):
            continue
        tol = torch.zeros((tile, m), dtype=torch.float64, device=p.device)
        for k0 in range(0, kdim, round_k):
            pc = p_lo[:, k0:k0 + round_k]
            part = pc[rows] @ pc.T
            nrm = pc.norm(dim=1)
            tol += 2 * bf16_ulp(part) + 2 * gamma * nrm[rows, None] * nrm[None, :]
        off = ~in_band
        off_ratio = max(off_ratio, float((d[off] / tol[off]).max()))
        if round_k == kdim:  # one rounding: every off-band value is a bf16
            o = out[rows][off]
            require(bool((o == o.to(torch.bfloat16).float()).all()),
                    "mp_syrk: off-band value not bf16-rounded")
    return band_num / max(band_den, 1e-30), off_ratio, max_abs


def syrk_flops(n_t, nb, t):
    """(in-band, off-band) flops of a SYRK of P = (n_t nb, nb), tile = nb:
    2 nb per dot product, nb^2 of them in a lower tile off the diagonal and
    nb (nb + 1) / 2 in a diagonal tile, since U is symmetric."""
    in_band, off_band = syrk_products(n_t, t)
    whole, diag = nb * nb, nb * (nb + 1) // 2
    return (2 * nb * ((in_band - n_t) * whole + n_t * diag),
            2 * nb * off_band * whole)


def syrk_bounds(n_t, nb, t):
    """Least ms of the two SYRK kernels on P = (n_t nb, nb), tile = nb: each
    the larger of its flops at the peak of their type (fp32 in the band,
    bf16 off it) and its bytes: P read once and its part of the fp32 square
    written, each lower tile and its mirror, a diagonal tile once."""
    in_band, off_band = syrk_products(n_t, t)
    band_f, off_f = syrk_flops(n_t, nb, t)
    tile_b, p_b = 4 * nb * nb, 4 * n_t * nb * nb
    band = max(band_f / FP32_FLOPS,
               (p_b + (2 * in_band - n_t) * tile_b) / HBM_BYTES_PER_S)
    off = max(off_f / BF16_FLOPS,
              (p_b + 2 * off_band * tile_b) / HBM_BYTES_PER_S) if off_band else 0.0
    return 1e3 * band, 1e3 * off


def syrk_library_ms(p, m_t, nb, t, lower=True):
    """The yardstick (torch.matmul, P cast to bf16 beforehand): per tile row
    its fp32 band slab and its bf16 slab left of the band, over the lower
    tiles as the kernels compute them; or (lower=False) a bf16 square and
    the fp32 band slabs on both sides."""
    import torch
    pt = p[:m_t * nb]
    pb = pt.to(torch.bfloat16)

    def run():
        if not lower:
            torch.matmul(pb, pb.T)
        for i in range(m_t):
            rows, c0 = slice(i * nb, (i + 1) * nb), max(0, i - t + 1) * nb
            c1 = (i + 1 if lower else min(m_t, i + t)) * nb
            torch.matmul(pt[rows], pt[c0:c1].T)
            if lower and c0:
                torch.matmul(pb[rows], pb[:c0].T)
    return time_ms(run)


def syrk_step_numbers(p, m_t, nb, t):
    """Kernel time, yardsticks and bound of the SYRK of the first m_t tile
    rows of P (tile = round_k = nb, band t)."""
    from repro_torch.kernels.mp_gemm import ops
    pt = p[:m_t * nb]
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    band_ms, off_ms = syrk_bounds(m_t, nb, t)
    band_f, off_f = syrk_flops(m_t, nb, t)
    # fp32 and bf16 run on separate units at once: the larger bounds
    ops_s = max(band_f / FP32_FLOPS, off_f / BF16_FLOPS)
    bytes_s = (pt.numel() + (m_t * nb) ** 2) * 4 / HBM_BYTES_PER_S
    return dict(ms=time_ms(lambda: ops.mp_syrk(pt, **kw)),
                library_ms=syrk_library_ms(p, m_t, nb, t, lower=True),
                library_full_ms=syrk_library_ms(p, m_t, nb, t, lower=False),
                bound_ms=1e3 * max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                band_bound_ms=band_ms, offband_bound_ms=off_ms)


def check_syrk(gen, m_main, nb, t, results):
    import torch
    from repro_torch.kernels.mp_gemm import ops, ref
    # the conformance sweep's small shapes (m, k, bm = tile, bk = round_k)
    # and round_k < kdim at a larger tile, with lo = bf16 and lo = fp32
    # (then every element is in the band); U must equal U^T exactly
    worst = 0.0
    for m, k, bm, bk, bands in ((128, 64, 64, 64, (1, 2, 4)),
                                (256, 128, 64, 64, (1, 2, 4)),
                                (256, 64, 128, 64, (1, 2, 4)),
                                (2048, 512, 512, 128, (1, 2))):
        p = torch.randn((m, k), generator=gen, device="cuda")
        for lo in (torch.bfloat16, torch.float32):
            for band in bands if lo == torch.bfloat16 else bands[:1]:
                kw = dict(tile=bm, round_k=bk, band_blocks=band, lo=lo)
                out, want = ops.mp_syrk(p, **kw), ref.mp_syrk(p, **kw)
                rel, ratio, mx = _syrk_errors(
                    out, want, p, tile=bm, round_k=bk,
                    band=band if lo == torch.bfloat16 else m // bm)
                sym = bool(torch.equal(out, out.T))
                require(rel <= 1e-5 and ratio <= 1.0 and sym,
                        f"mp_syrk m={m} k={k} round_k={bk} band={band} lo={lo}: "
                        f"rel {rel} off {ratio} symmetric {sym}")
                worst = max(worst, mx)
                emit(phase="kernels", kernel="mp_syrk", m=m, k=k, tile=bm,
                     round_k=bk, band=band, lo=str(lo), inband_rel=rel,
                     offband_err_over_tol=ratio, symmetric=sym)
    # step 0 of the main path: P is (m_main, nb), tile = round_k = nb
    p = torch.randn((m_main, nb), generator=gen, device="cuda")
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    out = ops.mp_syrk(p, **kw)
    want = ref.mp_syrk(p, **kw)
    rel, ratio, mx = _syrk_errors(out, want, p, tile=nb, round_k=nb, band=t)
    require(rel <= 1e-5 and ratio <= 1.0,
            f"mp_syrk step-0 shape: rel {rel} off {ratio}")
    worst = max(worst, mx)
    del want
    # U equals U^T bit for bit, one slab of tile rows at a time
    for r0 in range(0, m_main, nb):
        require(torch.equal(out[r0:r0 + nb], out[:, r0:r0 + nb].T),
                f"mp_syrk step-0 shape: U != U^T in rows {r0}..{r0 + nb}")
    del out
    n_t = m_main // nb

    # the kernel and the yardstick at steps of the main path (m_t tile
    # rows; --quick has fewer than 32), the plain version at step 0 only
    steps = {}
    for m_t in dict.fromkeys((n_t, min(32, n_t), min(8, n_t))):
        steps[m_t] = syrk_step_numbers(p, m_t, nb, t)
        emit(phase="kernels", kernel="mp_syrk", m_t=m_t, m=m_t * nb, k=nb,
             tile=nb, round_k=nb, band=t, **steps[m_t])
    plain_ms = time_ms(lambda: ref.mp_syrk(p, **kw))
    # device time of each of the call's kernels at step 0
    _, busy, rows = device_profile(lambda: ops.mp_syrk(p, **kw))
    device = {name: sum(ms_ for k_, _, ms_ in rows if name in k_)
              for name in SYRK_KERNELS}
    s0 = steps[n_t]
    emit(phase="kernels", kernel="mp_syrk", m=m_main, k=nb, tile=nb,
         round_k=nb, band=t, inband_rel=rel, offband_err_over_tol=ratio,
         symmetric=True, ms=s0["ms"], plain_ms=plain_ms,
         library_ms=s0["library_ms"], library_full_ms=s0["library_full_ms"],
         bound_ms=s0["bound_ms"], device_ms=device, device_busy_ms=busy,
         band_bound_ms=s0["band_bound_ms"],
         offband_bound_ms=s0["offband_bound_ms"])
    results["mp_syrk"] = dict(
        name="mp_syrk", route="cuda", source="src/repro_torch/csrc/mp_syrk.cu",
        replaces="src/repro/kernels/mp_gemm/mp_gemm.py:52",
        max_abs_err=worst, ms=s0["ms"], plain_ms=plain_ms,
        bound_ms=s0["bound_ms"], bound_by=s0["bound_by"],
        library_ms=s0["library_ms"])


def _syrk64_errors(out, want, *, tile, band):
    """The fp64 pair's U against its plain version, row slab by row slab:
    (in-band max |err| / max |U|, off-band max |err| / max |U|, max abs
    err, every off-band value an fp32 number)."""
    import torch
    m = out.shape[0]
    tiles = torch.arange(m, device=out.device) // tile
    scale = band_err = off_err = 0.0
    fp32_values = True
    for r0 in range(0, m, tile):
        rows = slice(r0, r0 + tile)
        o, w = out[rows], want[rows]
        d = (o - w).abs()
        in_band = (tiles[rows, None] - tiles[None, :]).abs() < band
        scale = max(scale, float(w.abs().max()))
        band_err = max(band_err, float(d[in_band].max()))
        if not bool(in_band.all()):
            off_err = max(off_err, float(d[~in_band].max()))
            ov = o[~in_band]
            fp32_values &= bool((ov == ov.float().double()).all())
    scale = max(scale, 1e-300)
    return band_err / scale, off_err / scale, max(band_err, off_err), fp32_values


def syrk64_numbers(p, nb, t, per_kernel=True):
    """Kernel time, yardstick and bound of the fp64 pair's SYRK of P =
    (n_t nb, nb), tile = round_k = nb, band t, and the same for each of its
    two kernels.  The yardstick is torch.matmul over the same lower tiles,
    fp64 for each tile row's band slab (its band half) and IEEE fp32 for its
    slab left of the band (its off-band half), each half also timed alone,
    beside the device time of its kernel under the profiler (per_kernel).
    The bounds: the fp64 band's operations at the fp64 tensor-core peak,
    the fp32 off-band's at the fp32 peak; the call's is the larger of the
    two (separate units) or the bytes of P and the fp64 U, whichever is
    larger."""
    import torch
    from repro_torch.kernels.mp_gemm import ops
    n_t = p.shape[0] // nb
    kw = dict(tile=nb, round_k=nb, band_blocks=t, hi=torch.float64,
              lo=torch.float32, accum=torch.float32)
    band_f, off_f = syrk_flops(n_t, nb, t)
    ops_s = max(band_f / FP64_TC_FLOPS, off_f / FP32_FLOPS)
    bytes_s = (p.numel() + p.shape[0] ** 2) * 8 / HBM_BYTES_PER_S
    p32 = p.float()

    def band_half():
        for i in range(n_t):
            rows, c0 = slice(i * nb, (i + 1) * nb), max(0, i - t + 1) * nb
            torch.matmul(p[rows], p[c0:(i + 1) * nb].T)

    def offband_half():
        for i in range(n_t):
            rows, c0 = slice(i * nb, (i + 1) * nb), max(0, i - t + 1) * nb
            if c0:
                torch.matmul(p32[rows], p32[:c0].T)

    def library():
        band_half()
        offband_half()

    call = lambda: ops.mp_syrk(p, **kw)  # noqa: E731
    nums = dict(ms=time_ms(call), library_ms=time_ms(library),
                bound_ms=1e3 * max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                band_library_ms=time_ms(band_half),
                band_bound_ms=1e3 * band_f / FP64_TC_FLOPS,
                offband_library_ms=time_ms(offband_half) if off_f else 0.0,
                offband_bound_ms=1e3 * off_f / FP32_FLOPS,
                band_gflop=band_f / 1e9, offband_gflop=off_f / 1e9)
    if per_kernel:
        _, busy, rows = device_profile(call)
        device = {name: sum(ms_ for k_, _, ms_ in rows if name in k_)
                  for name in SYRK_KERNELS}
        band_ms = device["syrk_band_f64_dmma_kernel"]
        off_ms = device["syrk_offband_fp32_pipelined_kernel"]
        nums.update(band_kernel_ms=band_ms, offband_kernel_ms=off_ms,
                    band_tflops=band_f / band_ms / 1e9 if band_ms else None,
                    offband_tflops=off_f / off_ms / 1e9 if off_ms else None,
                    device_ms=device, device_busy_ms=busy)
    return nums


def check_syrk_fp64(gen, m_main, nb, t, results):
    """mp_syrk under the paper pair (fp64, fp32, fp32) and all-hi fp64:
    the conformance shapes and round_k < kdim, then the panel path's step 0
    (band t); in-band elements within 1e-11 of max |U|, off-band within
    1e-5 and fp32 numbers, U = U^T bit for bit."""
    import torch
    from repro_torch.kernels.mp_gemm import ops, ref
    f32, f64 = torch.float32, torch.float64
    worst = 0.0
    for m, k, bm, bk, bands in ((128, 64, 64, 64, (1, 2, 4)),
                                (256, 128, 64, 64, (1, 2, 4)),
                                (256, 64, 128, 64, (1, 2, 4)),
                                (2048, 512, 512, 128, (1, 2))):
        p = torch.randn((m, k), generator=gen, device="cuda", dtype=f64)
        for lo in (f32, f64):
            for band in bands if lo == f32 else bands[:1]:
                kw = dict(tile=bm, round_k=bk, band_blocks=band, hi=f64, lo=lo,
                          accum=lo)
                out, want = ops.mp_syrk(p, **kw), ref.mp_syrk(p, **kw)
                brel, orel, mx, fp32_off = _syrk64_errors(
                    out, want, tile=bm, band=band if lo == f32 else m // bm)
                sym = bool(torch.equal(out, out.T))
                require(out.dtype == f64 and brel <= 1e-11 and orel <= 1e-5
                        and sym and fp32_off,
                        f"mp_syrk fp64 m={m} k={k} round_k={bk} band={band} "
                        f"lo={lo}: band {brel} off {orel} symmetric {sym} "
                        f"fp32 off-band {fp32_off}")
                worst = max(worst, mx)
                emit(phase="kernels", kernel="mp_syrk", hi=str(f64), lo=str(lo),
                     m=m, k=k, tile=bm, round_k=bk, band=band, inband_rel=brel,
                     offband_rel=orel, symmetric=sym)
    # step 0 of the panel path: P is (m_main, nb) fp64, tile = round_k = nb
    p = torch.randn((m_main, nb), generator=gen, device="cuda", dtype=f64)
    kw = dict(tile=nb, round_k=nb, band_blocks=t, hi=f64, lo=f32, accum=f32)
    out = ops.mp_syrk(p, **kw)
    want = ref.mp_syrk(p, **kw)
    brel, orel, mx, fp32_off = _syrk64_errors(out, want, tile=nb, band=t)
    require(brel <= 1e-11 and orel <= 1e-5 and fp32_off,
            f"mp_syrk fp64 step-0 shape: band {brel} off {orel} fp32 {fp32_off}")
    worst = max(worst, mx)
    del want
    for r0 in range(0, m_main, nb):
        require(torch.equal(out[r0:r0 + nb], out[:, r0:r0 + nb].T),
                f"mp_syrk fp64 step-0 shape: U != U^T in rows {r0}..{r0 + nb}")
    del out
    torch.cuda.empty_cache()
    nums = syrk64_numbers(p, nb, t)
    plain_ms = time_ms(lambda: ref.mp_syrk(p, **kw), reps=3)
    emit(phase="kernels", kernel="mp_syrk", hi=str(f64), lo=str(f32),
         m=m_main, k=nb, tile=nb, round_k=nb, band=t, inband_rel=brel,
         offband_rel=orel, symmetric=True, plain_ms=plain_ms, **nums)
    results.setdefault("mp_syrk_fp64", {}).update(
        name="mp_syrk (fp64, fp32)", route="cuda",
        source="src/repro_torch/csrc/mp_syrk.cu",
        replaces="src/repro/kernels/mp_gemm/mp_gemm.py:52",
        max_abs_err=worst, ms=nums["ms"], plain_ms=plain_ms,
        bound_ms=nums["bound_ms"], bound_by=nums["bound_by"],
        library_ms=nums["library_ms"])


# ---------------------------------------------------------------------------
# phases 4-6: the main path, a small CPU-held input, the MLE
# ---------------------------------------------------------------------------

def main_path(ds, cfg, results):
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    p = n // nb
    policy = PrecisionPolicy.tpu(t)
    expected = {"blocked_potrf": p, "mp_syrk": p - 1, "matern_cov": t + 1,
                "matern_cov_grad": 0, "mp_syrk_grad": 0, "mp_attention": 0}
    th0 = [float(v) for v in ds.theta0.tolist()]
    requests = [th0, [th0[0], th0[1] * 0.8, th0[2]],
                [th0[0], th0[1] * 1.25, th0[2]]]
    total = {k: 0 for k, count in expected.items() if count}
    n_finite, first = 0, None
    torch.cuda.synchronize()
    run = MEASURED["4"] = dict(n=n, nb=nb, t=t, seconds=[], peak_gib=[],
                               held_gib=torch.cuda.memory_allocated() / 2**30)
    for theta in requests:
        lls, secs, peaks, launched = {}, {}, {}, {}
        for impl in ("kernel", "plain"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            ll = geostat_loglik_step(ds.locs, ds.z, theta, nb=nb, policy=policy,
                                     nu_static=cfg["nu"],
                                     off_update=cfg["off_update"], impl=impl)
            lls[impl] = float(ll)  # waits for the device
            secs[impl] = time.perf_counter() - t0
            counts = launched[impl] = launch_counts()
            peaks[impl] = torch.cuda.max_memory_allocated() / 2 ** 30
            if impl == "kernel":
                require(counts == expected,
                        f"launches {counts}, expected {expected} per evaluation")
                for k in total:
                    total[k] += counts[k]
            else:
                require(sum(counts.values()) == 0, f"plain path launched {counts}")
        a, b = lls["kernel"], lls["plain"]
        both_nan = math.isnan(a) and math.isnan(b)
        close = (math.isfinite(a) and math.isfinite(b)
                 and abs(a - b) <= 1e-3 * abs(b))
        require(both_nan or close, f"theta {theta}: kernel {a} vs plain {b}")
        n_finite += close
        first = a if first is None else first
        run["seconds"].append(secs["kernel"])
        run["peak_gib"].append(peaks["kernel"])
        emit(phase="main", n=n, nb=nb, t=t, theta=theta, loglik_kernel=a,
             loglik_plain=b, rel_diff=abs(a - b) / abs(b) if close else None,
             seconds_kernel=secs["kernel"], seconds_plain=secs["plain"],
             peak_gib_kernel=peaks["kernel"], peak_gib_plain=peaks["plain"],
             launches_kernel=launched["kernel"], launches_plain=launched["plain"])
    require(n_finite >= 1, "no request gave a finite log-likelihood")
    for k in total:
        results[k]["launches"] = total[k]
    profile_evaluation(ds, cfg, policy, th0)
    return first


def main_path_paper(ds, cfg, results):
    """Phase 4's paper-pair request: one geostat_loglik_step under
    paper_cpu(t) (fp64 band, fp32 off-band) on the main path's field in
    fp64, through the kernels and through the plain versions.  The fp64
    diagonal tiles go to cuSOLVER by dtype: no blocked_potrf launch."""
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    p = n // nb
    policy = PrecisionPolicy.paper_cpu(t)
    locs, z = ds.locs.double(), ds.z.double()
    theta = [float(v) for v in ds.theta0.tolist()]
    expected = {"blocked_potrf": 0, "mp_syrk": p - 1, "matern_cov": t + 1,
                "matern_cov_grad": 0, "mp_syrk_grad": 0, "mp_attention": 0}
    out = {}
    for impl in ("kernel", "plain"):
        out[impl] = _evaluate(lambda th: geostat_loglik_step(
            locs, z, th, nb=nb, policy=policy, nu_static=cfg["nu"],
            off_update=cfg["off_update"], impl=impl), theta)
    (a, sa, pa, ca), (b, sb, pb, cb) = out["kernel"], out["plain"]
    require(ca == expected, f"paper_cpu({t}): launches {ca}, expected {expected}")
    require(sum(cb.values()) == 0, f"paper_cpu({t}) plain path launched {cb}")
    require(math.isfinite(a) and math.isfinite(b) and abs(a - b) <= 1e-5 * abs(b),
            f"paper_cpu({t}): kernel {a} vs plain {b}")
    emit(phase="main", policy=f"paper_cpu({t})", n=n, nb=nb, t=t, theta=theta,
         loglik_kernel=a, loglik_plain=b, rel_diff=abs(a - b) / abs(b), tol=1e-5,
         seconds_kernel=sa, seconds_plain=sb, peak_gib_kernel=pa,
         peak_gib_plain=pb, launches_kernel=ca, launches_plain=cb)
    results.setdefault("mp_syrk_fp64", {})["launches"] = ca["mp_syrk"]
    results.setdefault("matern_cov_fp64", {})["launches"] = ca["matern_cov"]


def device_profile(fn):
    """fn() under torch.profiler: (wall ms, device busy ms, rows of (name,
    count, ms) by device time).  fn ends in a host read or a sync; one
    stream, so the device events do not overlap.  The trace holds
    PROFILE_PAD_S of idle time before and after fn: on the card, a trace
    that ended right after a short call lost some or all of its device
    events once the process had run for a while, and a padded one did not
    (when the call held a PyTorch op; a trace of this library's launches
    alone still came back empty late in a run).  A trace with no device
    event or with more device time than wall time is taken again, up to
    three times, and then fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        per_kernel = {}  # device-side events only: kernels, copies, sets
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                count, ms = per_kernel.get(e.name, (0, 0.0))
                per_kernel[e.name] = (count + 1, ms + e.time_range.elapsed_us() / 1e3)
        busy = sum(ms for _, ms in per_kernel.values())
        if 0 < busy <= 1e3 * wall:
            break
    rows = sorted(((k, c, ms) for k, (c, ms) in per_kernel.items()),
                  key=lambda r: -r[2])
    require(0 < busy <= 1e3 * wall, f"device busy {busy} ms in {wall} s")
    return 1e3 * wall, busy, rows


def profile_evaluation(ds, cfg, policy, theta):
    """One more kernel-path evaluation under torch.profiler: device time
    by kernel name, and the device's idle share of the evaluation's wall
    time."""
    from repro_torch.core import geostat_loglik_step
    wall_ms, busy, rows = device_profile(lambda: float(geostat_loglik_step(
        ds.locs, ds.z, theta, nb=cfg["nb"], policy=policy, nu_static=cfg["nu"],
        off_update=cfg["off_update"])))
    # the evaluation's SYRK work: lower-triangle tile products in and off
    # the band, summed over the p - 1 steps, each kernel's device time and
    # its bound: the larger of operations at the peak of their type and the
    # bytes of its part of the fp32 square (lower and mirror), per step
    nb = cfg["nb"]
    p, t = cfg["n"] // nb, min(cfg["t"], cfg["n"] // nb)
    products = [syrk_products(m_t, t) for m_t in range(1, p)]
    bounds = [syrk_bounds(m_t, nb, t) for m_t in range(1, p)]
    emit(phase="profile", wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1 - busy / wall_ms,
         syrk_products_in_band=sum(i for i, _ in products),
         syrk_products_off_band=sum(o for _, o in products),
         syrk_in_band_bound_ms=sum(b for b, _ in bounds),
         syrk_off_band_bound_ms=sum(o for _, o in bounds),
         syrk_device_ms={name: sum(ms for k, _, ms in rows if name in k)
                         for name in SYRK_KERNELS},
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:14]])


def small_vs_cpu():
    """A small input through the kernels on the card and through the plain
    versions on the CPU.  fp32 alone agrees to fp32 summation noise; with
    the bf16 off-band a change in the last fp32 bit can flip bf16
    roundings, hence weak correlation and 1e-3 there."""
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    from repro_torch.covariance import make_dataset
    n, nb = 4096, 256
    gen = torch.Generator(device="cuda").manual_seed(3)
    ds = make_dataset(gen, n, WEAK, nu_static=0.5)
    for policy, tol in ((PrecisionPolicy.full(torch.float32), 1e-5),
                        (PrecisionPolicy.tpu(2), 1e-3)):
        kw = dict(nb=nb, policy=policy, nu_static=0.5)
        ll_gpu = float(geostat_loglik_step(ds.locs, ds.z, WEAK, **kw))
        ll_cpu = float(geostat_loglik_step(ds.locs.cpu(), ds.z.cpu(), WEAK, **kw))
        rel = abs(ll_gpu - ll_cpu) / abs(ll_cpu)
        require(math.isfinite(ll_gpu) and rel <= tol,
                f"small input {policy.mode}: card {ll_gpu} vs CPU {ll_cpu}")
        emit(phase="small_vs_cpu", n=n, nb=nb, mode=policy.mode,
             t=min(policy.diag_thick, n // nb), loglik_card=ll_gpu,
             loglik_cpu_plain=ll_cpu, rel_diff=rel, tol=tol)


def mle():
    import torch
    from repro_torch.core import PrecisionPolicy, fit_mle, geostat_loglik_step
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device="cuda").manual_seed(1)
    ds = make_dataset(gen, MLE["n"], MEDIUM, nu_static=0.5)
    policy = PrecisionPolicy.tpu(MLE["t"])

    def loglik(th):
        return geostat_loglik_step(ds.locs, ds.z, [th[0], th[1], 0.5],
                                   nb=MLE["nb"], policy=policy, nu_static=0.5)
    start = [0.8, 0.05]  # off the theta1/theta2 ridge, weaker correlation
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_mle(loglik, start, max_iters=MLE["max_iters"])
    secs = time.perf_counter() - t0
    require(bool(math.isfinite(res.loglik)) and res.loglik >= float(loglik(start)),
            f"MLE did not improve on its start: {res.loglik}")
    emit(phase="mle", n=MLE["n"], nb=MLE["nb"], t=MLE["t"], theta0=MEDIUM[:2],
         start=start, theta_hat=res.theta.tolist(), loglik=res.loglik,
         n_evals=res.n_evals, n_iters=res.n_iters, seconds=secs,
         seconds_per_eval=secs / res.n_evals, launches=launch_counts())


# ---------------------------------------------------------------------------
# phase 3b: mp_attention against its plain version
# ---------------------------------------------------------------------------

def _attn_errors(q, segments, *, blk, sm_scale):
    """Kernel against plain partials and merged outputs, and the merged
    kernel output against the full-softmax oracle.  A partial (acc, m, l)
    is held per query head at rel 1e-4 of max(max |plain| over d, 1): acc
    sums thousands of signed terms at the served shapes, so one element
    can cancel to ~0 while its head's row is O(10).  Returns max |kernel -
    plain|, max |kernel - oracle|, the worst partial rel and the plain
    merged output; fails on a NaN or a wrongly masked segment."""
    import torch
    from repro_torch.kernels.mp_attention import ops, ref
    kn, vn, near_len, kf, vf, scales, far_len = segments
    kw = dict(blk=blk, sm_scale=sm_scale)
    parts, plain, part_rel = [], [], 0.0
    for k, v, sc, n in ((kn, vn, None, near_len), (kf, vf, scales, far_len)):
        got = ops.flash_decode_segment(q, k, v, sc, n, **kw)
        want = ref.flash_decode_segment(q, k, v, sc, n, **kw)
        for name, g, w in zip(("acc", "m", "l"), got, want):
            require(bool(torch.isfinite(g).all()), f"mp_attention {name}: not finite")
            rel = float(((g - w).abs().amax(-1)
                         / w.abs().amax(-1).clamp_min(1.0)).max())
            require(rel <= 1e-4, f"mp_attention partial {name}: rel {rel}")
            part_rel = max(part_rel, rel)
        empty = n <= 0  # no valid key: m = -1e30 and l = S, as the reference
        require(bool((got[1][empty] == -1e30).all())
                and bool((got[2][empty] == k.shape[1]).all()),
                "mp_attention: a fully masked segment is not (m=-1e30, l=S)")
        parts.append(got)
        plain.append(want)
    out = ops.merge_partials(parts)
    want = ops.merge_partials(plain)
    oracle = ref.banded_decode_attention_ref(q, *segments, **kw)
    require(bool(torch.isfinite(out).all()), "mp_attention output not finite")
    return dict(vs_plain=float((out - want).abs().max()),
                vs_oracle=float((out - oracle).abs().max()),
                partials_rel=part_rel, plain=want)


def check_attention(gen, results):
    import torch
    from repro_torch.kernels.mp_attention import ops

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    worst = 0.0
    for shape in ATTN_SHAPES:
        b, g, d, sn, sf, blk = shape
        for scale in ATTN_SCALES:
            for near_dt in (torch.float32, torch.bfloat16):
                for lengths in ("full", "ragged"):
                    q = scale * randn(b, g, d)
                    kn, vn = randn(b, sn, d).to(near_dt), randn(b, sn, d).to(near_dt)
                    kq, vq, sc = ops.quantize_kv(randn(b, sf, d), randn(b, sf, d),
                                                 blk=blk)
                    if lengths == "full":
                        near_len = torch.full((b,), sn, device="cuda")
                        far_len = torch.full((b,), sf, device="cuda")
                    else:  # row 0 has no far key (tests/test_kernels.py)
                        near_len = torch.randint(1, sn + 1, (b,), generator=gen,
                                                 device="cuda")
                        far_len = torch.randint(0, sf + 1, (b,), generator=gen,
                                                device="cuda")
                        far_len[0] = 0
                    segs = (kn, vn, near_len.int(), kq, vq, sc, far_len.int())
                    err = _attn_errors(q, segs, blk=blk, sm_scale=d ** -0.5)
                    vs_plain, vs_oracle = err["vs_plain"], err["vs_oracle"]
                    require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                            f"mp_attention {shape} scale {scale}: {vs_plain}, "
                            f"{vs_oracle} > {ATTN_MAX_ABS}")
                    worst = max(worst, vs_plain)
                    emit(phase="kernels", kernel="mp_attention", shape=shape,
                         logit_scale=scale, near_dtype=str(near_dt),
                         lengths=lengths, max_abs_vs_plain=vs_plain,
                         max_abs_vs_oracle=vs_oracle, bound=ATTN_MAX_ABS,
                         partials_rel=err["partials_rel"])
    # a bf16 query, once per head dim, and the widest G the kernel takes
    # (at d = 80 every thread group's last head and the idle threads)
    for (b, g, d, sn, sf, blk), q_dt in (
            (ATTN_SHAPES[0], torch.bfloat16), (ATTN_SHAPES[1], torch.bfloat16),
            (ATTN_SHAPES[3], torch.bfloat16),
            ((2, 16, 128, 192, 384, 64), torch.float32),
            ((2, 16, 64, 192, 384, 64), torch.bfloat16),
            ((2, 16, 80, 192, 384, 64), torch.float32),
            ((3, 15, 80, 192, 384, 64), torch.bfloat16)):
        q = randn(b, g, d).to(q_dt)
        kv = [randn(b, s_, d) for s_ in (sn, sn, sf, sf)]
        kq, vq, sc = ops.quantize_kv(kv[2], kv[3], blk=blk)
        segs = (kv[0].bfloat16(), kv[1].bfloat16(),
                torch.full((b,), sn, dtype=torch.int32, device="cuda"), kq, vq,
                sc, torch.full((b,), sf, dtype=torch.int32, device="cuda"))
        err = _attn_errors(q, segs, blk=blk, sm_scale=d ** -0.5)
        vs_plain, vs_oracle = err["vs_plain"], err["vs_oracle"]
        require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                f"mp_attention q {q_dt} G={g} d={d}: {vs_plain}, {vs_oracle}")
        worst = max(worst, vs_plain)
        emit(phase="kernels", kernel="mp_attention", shape=(b, g, d, sn, sf, blk),
             q_dtype=str(q_dt), max_abs_vs_plain=vs_plain,
             max_abs_vs_oracle=vs_oracle, bound=ATTN_MAX_ABS,
             partials_rel=err["partials_rel"])
    # the split-KV grid's schedules at the served segment sizes (near 1,152
    # bf16 slots, far 7,168 int8 keys, blk 128): B*KV = 1 (one chunk per
    # key block, the most chunks per row); B*KV = 32 with ragged lengths
    # that end mid-chunk and leave whole chunks past the end, and rows with
    # no valid key (seg_len = 0 over several chunks)
    from repro_torch.kernels.mp_attention.mp_attention import split_plan
    for b, lengths in ((1, "full"), (1, "ragged"), (1, "empty"),
                       (32, "ragged")):
        g, d, sn, sf, blk = 4, 64, 1152, 7168, 128
        q = randn(b, g, d)
        kn, vn = randn(b, sn, d).bfloat16(), randn(b, sn, d).bfloat16()
        kq, vq, sc = ops.quantize_kv(randn(b, sf, d), randn(b, sf, d), blk=blk)
        near_len = torch.full((b,), sn, dtype=torch.int32, device="cuda")
        far_len = torch.full((b,), sf, dtype=torch.int32, device="cuda")
        far_chunk = split_plan(b, sf, blk)[0]
        if lengths == "ragged":  # mid-chunk ends, chunks wholly past them
            near_len = torch.randint(1, sn + 1, (b,), generator=gen,
                                     device="cuda").int()
            far_len = (torch.randint(0, sf // far_chunk, (b,), generator=gen,
                                     device="cuda") * far_chunk
                       + far_chunk // 2 + 3).int()
            far_len[0] = 0 if b > 1 else far_len[0]
            near_len[-1] = 1
        elif lengths == "empty":
            far_len.zero_()
        segs = (kn, vn, near_len, kq, vq, sc, far_len)
        err = _attn_errors(q, segs, blk=blk, sm_scale=d ** -0.5)
        vs_plain, vs_oracle = err["vs_plain"], err["vs_oracle"]
        require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                f"mp_attention split B={b} {lengths}: {vs_plain}, {vs_oracle}")
        worst = max(worst, vs_plain)
        emit(phase="kernels", kernel="mp_attention", shape=(b, g, d, sn, sf, blk),
             lengths=lengths, n_split_near=split_plan(b, sn, blk)[1],
             n_split_far=split_plan(b, sf, blk)[1], max_abs_vs_plain=vs_plain,
             max_abs_vs_oracle=vs_oracle, bound=ATTN_MAX_ABS,
             partials_rel=err["partials_rel"])
    # d_head 80 at h2o-danube-1.8b's served window, its layers in turn
    # (each ~13 MB of K/V; 24 are 6x the 50 MB L2): held to its plain
    # version and timed as phase 7 times d_head 64
    a = ATTN_D80
    q = randn(a["rows"], a["g"], a["d"])
    layer_segs = []
    for _ in range(a["layers"]):
        kq, vq, sc = ops.quantize_kv(randn(a["rows"], a["far"], a["d"]),
                                     randn(a["rows"], a["far"], a["d"]),
                                     blk=a["blk"])
        layer_segs.append((randn(a["rows"], a["near"], a["d"]).bfloat16(),
                           randn(a["rows"], a["near"], a["d"]).bfloat16(),
                           torch.full((a["rows"],), a["near"], dtype=torch.int32,
                                      device="cuda"), kq, vq, sc,
                           torch.full((a["rows"],), a["far"], dtype=torch.int32,
                                      device="cuda")))
    err = _attn_errors(q, layer_segs[0], blk=a["blk"], sm_scale=a["d"] ** -0.5)
    require(err["vs_plain"] <= ATTN_MAX_ABS and err["vs_oracle"] <= ATTN_MAX_ABS,
            f"mp_attention d=80 served window: {err['vs_plain']}, {err['vs_oracle']}")
    worst = max(worst, err["vs_plain"])
    d80 = attn_layer_times(q, layer_segs, blk=a["blk"], sm_scale=a["d"] ** -0.5)
    emit(phase="kernels", kernel="mp_attention", shape=a,
         max_abs_vs_plain=err["vs_plain"], max_abs_vs_oracle=err["vs_oracle"],
         bound=ATTN_MAX_ABS, partials_rel=err["partials_rel"],
         kernel_ms_per_layer=d80["ms"], plain_ms_per_layer=d80["plain_ms"],
         banded_call_ms_per_layer=d80["banded_call_ms"],
         sdpa_ms_per_layer=d80["library_ms"],
         max_abs_sdpa_vs_kernel=d80["max_abs_sdpa_vs_kernel"],
         bound_ms=d80["bound_ms"], bound_by=d80["bound_by"], bytes=d80["bytes"])
    del layer_segs
    results["mp_attention"] = dict(
        name="mp_attention", route="cuda",
        source="src/repro_torch/csrc/mp_attention.cu",
        replaces="src/repro/kernels/mp_attention/mp_attention.py:78",
        max_abs_err=worst, ms_d80=d80["ms"], plain_ms_d80=d80["plain_ms"],
        bound_ms_d80=d80["bound_ms"], library_ms_d80=d80["library_ms"])


# ---------------------------------------------------------------------------
# phase 5b and 7: the LM serving path
# ---------------------------------------------------------------------------

def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def smoke_lm_vs_cpu():
    """llama3.2-1b's SMOKE model in fp32 compute on the card and on the CPU,
    the same weights and prompt: logits within 1e-4 of max |logit|, the same
    greedy ids.  The last decode step runs on both from the card's cache:
    each device rounds its own cache rows to bf16, and a row that rounds the
    other way moves the logits by ~1e-4 of their scale by itself."""
    import torch
    from repro_torch.configs import LM_SMOKE_CONFIGS
    from repro_torch.models import decode_step, forward_lm, init_lm, prefill
    from repro_torch.serve_lm import generate
    cfg = LM_SMOKE_CONFIGS["llama3.2-1b"]
    gen = torch.Generator().manual_seed(5)
    params = {"cpu": init_lm(gen, cfg, device="cpu")}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    n_new = 8
    kw = dict(compute_dtype=torch.float32)
    out, caches = {}, {}
    for dev, p in params.items():
        tp = prompt.to(dev)
        ids, caches[dev] = generate(p, cfg, tp, n_new, **kw)
        out[dev] = dict(forward=forward_lm(p, tp, cfg, **kw)[0].cpu(),
                        prefill=prefill(p, tp, cfg, **kw)[0].cpu(), ids=ids.cpu())
    # the last id was never written: one more step fills the last slot
    last = out["cuda"]["ids"][:, -1:]
    for dev, p in params.items():
        cache = _to_device(caches["cuda"], "cpu")  # a copy: the step writes it
        step = decode_step(p, _to_device(cache, dev), last.to(dev),
                           prompt.shape[1] + n_new - 1, cfg, **kw)[0]
        out[dev]["step"] = step.cpu()
    rels = {}
    for name in ("forward", "prefill", "step"):
        g, w = out["cuda"][name], out["cpu"][name]
        require(bool(torch.isfinite(g).all()), f"SMOKE {name}: not finite")
        rels[name] = float((g - w).abs().max() / w.abs().max())
        require(rels[name] <= 1e-4, f"SMOKE {name}: card vs CPU {rels[name]}")
    same = bool((out["cuda"]["ids"] == out["cpu"]["ids"]).all())
    require(same, "SMOKE: greedy ids differ between the card and the CPU")
    emit(phase="small_vs_cpu", model=cfg.name + " SMOKE", compute="float32",
         prompt=list(prompt.shape), new_tokens=n_new, rel_diff=rels, tol=1e-4,
         same_ids=same, ids_card=out["cuda"]["ids"].tolist())


def window_in_order(entry, c: int, length):
    """One attention layer's served cache entry at cycle c as (k, v,
    length) for `serve_lm.banded_kv_attention`: a full cache as it is, its
    first `length` slots filled; a circular sliding window (it has `pos`)
    with its filled slots gathered in position order, oldest first, so that
    the near window holds the latest positions, and length their count."""
    import torch
    k, v = entry["k"][c], entry["v"][c]
    if "pos" not in entry:
        return k, v, length
    pos = entry["pos"][c]
    order = torch.argsort(pos)
    order = order[pos[order] >= 0]
    return k[:, order], v[:, order], int(order.numel())


def _ids_checksum(ids) -> str:
    import hashlib
    return hashlib.sha256(ids.cpu().numpy().tobytes()).hexdigest()[:16]


def attn_segments_all(fn, q, layer_segs, kw):
    """fn (the launch wrapper or the plain version) on each layer's near
    and far segments in turn."""
    for kn, vn, near_len, kf, vf, sc, far_len in layer_segs:
        fn(q, kn, vn, None, near_len, **kw)
        fn(q, kf, vf, sc, far_len, **kw)


def attn_layer_times(q, layer_segs, *, blk, sm_scale):
    """mp_attention's numbers per layer over `layer_segs` (each layer's
    `fold_banded` segments, taken in turn so that each comes from device
    memory): `ms` the two segment launches alone (the kernel's time),
    `plain_ms` their plain versions, `banded_call_ms` the whole banded call
    with its plain-PyTorch merge, `library_ms` one SDPA call over the
    dequantized K/V (bf16) with the validity mask, G query heads as G
    queries of one KV head, and its distance to the kernel's output; the
    bound: the bytes the two launches need per layer (q for each, the
    filled K/V rows of each segment, the far scales, each (acc, m, l))
    over 3.35 TB/s against 4 G d flops a key over the fp32 peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mp_attention import ops, ref
    from repro_torch.kernels.mp_attention.mp_attention import launch
    kw = dict(blk=blk, sm_scale=sm_scale)
    n_layers = len(layer_segs)
    rows, g, hd = q.shape
    out = dict(
        ms=time_ms(lambda: attn_segments_all(launch, q, layer_segs, kw)) / n_layers,
        plain_ms=time_ms(lambda: attn_segments_all(
            ref.flash_decode_segment, q, layer_segs, kw)) / n_layers,
        banded_call_ms=time_ms(lambda: [ops.banded_decode_attention(q, *sg, **kw)
                                        for sg in layer_segs]) / n_layers)
    sdpa_in = []
    for kn, vn, near_len, kf, vf, sc, far_len in layer_segs:
        nblk = kf.shape[1] // blk
        deq = [(x.float().reshape(x.shape[0], nblk, blk, hd)
                * sc[:, :, i, None, None]).reshape(x.shape).bfloat16()
               for i, x in enumerate((kf, vf))]
        k_all = torch.cat([deq[0], kn], dim=1)[:, None]
        v_all = torch.cat([deq[1], vn], dim=1)[:, None]
        pos = torch.arange(k_all.shape[2], device="cuda")
        mask = ((pos < far_len[0]) | ((pos >= kf.shape[1])
                                      & (pos < kf.shape[1] + near_len[0])))
        sdpa_in.append((k_all, v_all, mask[None, None, None, :].expand(
            k_all.shape[0], 1, 1, -1)))
    q_sdpa = q.bfloat16()[:, None]
    lib_out = F.scaled_dot_product_attention(q_sdpa, *sdpa_in[0][:2],
                                             attn_mask=sdpa_in[0][2])
    out["library_ms"] = time_ms(lambda: [
        F.scaled_dot_product_attention(q_sdpa, k_, v_, attn_mask=m_)
        for k_, v_, m_ in sdpa_in]) / n_layers
    kernel_out = ops.banded_decode_attention(q, *layer_segs[0], **kw)
    out["max_abs_sdpa_vs_kernel"] = float(
        (lib_out[:, 0].float() - kernel_out).abs().max())
    kn, vn, near_len, kf, vf, sc, far_len = layer_segs[0]
    near_n, far_n = int(near_len[0]), int(far_len[0])
    bytes_moved = (2 * q.numel() * 4
                   + 2 * rows * hd * (near_n * kn.element_size()
                                      + far_n * kf.element_size())
                   + sc.numel() * 4 + 2 * (q.numel() + 2 * rows * g) * 4)
    flops = 4 * rows * g * hd * (near_n + far_n)
    out.update(bytes=bytes_moved, flops=flops,
               bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS),
               bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS
               else "operations")
    return out


def serving(scfg, results):
    """Phase 7: generate on llama3.2-1b, then every layer's served cache
    through the banded-precision attention, counted, compared and timed."""
    import torch
    from repro_torch.configs import LM_CONFIGS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mp_attention.mp_attention import launch
    from repro_torch.models import decode_step, init_lm, prefill
    from repro_torch.serve_lm import (banded_kv_attention, cache_bytes_saved,
                                      fold_banded, generate)
    cfg = LM_CONFIGS["llama3.2-1b"]
    b, s, n_new = scfg["batch"], scfg["prompt"], scfg["new"]
    near, blk = scfg["near"], scfg["blk"]
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    params = init_lm(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    q = torch.randn((b * kv, g, hd), generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    length = s + n_new - 1  # the last generated id is never written

    # the main path, counted: generate, then every layer's banded attention
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    ids, cache = generate(params, cfg, prompt, n_new, stats=stats)
    peak_gen = torch.cuda.max_memory_allocated() / 2 ** 30
    layer_k, layer_v = cache["b0"]["k"], cache["b0"]["v"]
    banded = [banded_kv_attention(layer_k[c], layer_v[c], q, length,
                                  near=near, blk=blk)
              for c in range(cfg.n_cycles)]
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {"matern_cov": 0, "matern_cov_grad": 0, "blocked_potrf": 0,
                "mp_syrk": 0, "mp_syrk_grad": 0,
                "mp_attention": 2 * cfg.n_cycles}
    require(counts == expected, f"serving launches {counts}, expected {expected}")
    require(tuple(ids.shape) == (b, n_new) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab, f"generated ids {tuple(ids.shape)}")
    require(tuple(layer_k.shape) == (cfg.n_cycles, b, s + n_new, kv, hd)
            and bool(torch.isfinite(layer_k[:, :, :length]).all())
            and bool(torch.isfinite(layer_v[:, :, :length]).all()),
            "served cache: wrong shape or not finite")

    # each layer: the kernel's partials against the plain version's at rel
    # 1e-4 and the merged outputs at ATTN_MAX_ABS (_attn_errors, at the
    # served shapes), the main path's output against the plain merge and
    # against exact attention
    sm_scale = hd ** -0.5
    kw = dict(blk=blk, sm_scale=sm_scale)
    layer_segs, vs_plain, vs_oracle, vs_exact, plain_vs_exact, plain_max = (
        [], 0.0, 0.0, 0.0, 0.0, 0.0)
    partials_rel = 0.0
    for c, (out, exact) in enumerate(banded):
        segs, _ = fold_banded(layer_k[c], layer_v[c], length, near=near, blk=blk)
        layer_segs.append(segs)
        err = _attn_errors(q, segs, **kw)
        plain = err["plain"]
        require(bool(torch.isfinite(out).all()), f"layer {c}: banded not finite")
        vs_plain = max(vs_plain, err["vs_plain"], float((out - plain).abs().max()))
        vs_oracle = max(vs_oracle, err["vs_oracle"])
        partials_rel = max(partials_rel, err["partials_rel"])
        vs_exact = max(vs_exact, float((out - exact).abs().max()))
        plain_vs_exact = max(plain_vs_exact, float((plain - exact).abs().max()))
        plain_max = max(plain_max, float(plain.abs().max()))
    require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
            f"served cache: kernel vs plain {vs_plain}, vs oracle {vs_oracle} "
            f"> {ATTN_MAX_ABS}")
    # the int8 far blocks' cost against exact attention: ~1e-3 here, ~1e-2
    # on the kernel tests' inputs, which tests/test_kernels.py holds < 0.05
    require(vs_exact < 0.05, f"served cache: banded vs exact {vs_exact}")
    del banded

    # one more step fills the last slot: finite logits of the full vocab
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = decode_step(params, cache, ids[:, -1:], length, cfg)
    torch.cuda.synchronize()
    last_step_ms = 1e3 * (time.perf_counter() - t0)
    require(tuple(logits.shape) == (b, 1, cfg.vocab)
            and bool(torch.isfinite(logits).all()), "decode logits not finite")
    # where the time goes: one decode step (rewriting the last slot) and one
    # prefill under the profiler
    for what, fn in (
            ("decode_step", lambda: decode_step(params, cache, ids[:, -1:],
                                                length, cfg)),
            ("prefill", lambda: prefill(params, prompt, cfg))):
        wall_ms, busy, rows = device_profile(fn)
        emit(phase="serving_profile", what=what, wall_ms=wall_ms,
             device_busy_ms=busy, idle_share=1 - busy / wall_ms,
             kernels=sum(c for _, c, _ in rows),
             top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:10]])
    del cache, layer_k, layer_v, params
    torch.cuda.empty_cache()

    # times: each layer in turn, so that each layer's ~39 MB of K/V come
    # from device memory (16 layers are 12x the 50 MB L2); the segment
    # launches under the profiler: device time by kernel against wall time
    # says how much of the kernel's time is the wrapper's host work
    wall_ms, busy, rows = device_profile(
        lambda: attn_segments_all(launch, q, layer_segs, kw))
    emit(phase="serving_profile", what="mp_attention segments, all layers",
         wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
         top=[{"name": k[:90], "count": c, "ms": ms_} for k, c, ms_ in rows[:6]])
    times = attn_layer_times(q, layer_segs, blk=blk, sm_scale=sm_scale)
    ms, plain_ms, library_ms = times["ms"], times["plain_ms"], times["library_ms"]
    bound_ms, bytes_moved = times["bound_ms"], times["bytes"]
    kn, vn, near_len, kf, vf, sc, far_len = layer_segs[0]
    near_n, far_n, rows = int(near_len[0]), int(far_len[0]), q.shape[0]
    saved = cache_bytes_saved(kn.shape[1], kf.shape[1])
    emit(phase="serving", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         batch=b, prompt=s, new_tokens=n_new, compute="bfloat16",
         init_seconds=init_s, prefill_seconds=stats["prefill_s"],
         decode_ms_per_step=1e3 * stats["decode_s"] / stats["decode_steps"],
         last_step_ms=last_step_ms, peak_gib=peak_gen,
         ids_sha256=_ids_checksum(ids), ids_head=ids[0, :8].tolist(),
         launches=counts)
    emit(phase="serving", banded="every layer's served cache", slots=s + n_new,
         filled=length, near_filled=near_n, near_slots=kn.shape[1],
         far_slots=far_n, far_blocks=far_n // blk, rows=rows, g=g, d=hd,
         max_abs_kernel_vs_plain=vs_plain, max_abs_kernel_vs_oracle=vs_oracle,
         bound=ATTN_MAX_ABS, partials_rel=partials_rel, partials_rel_bound=1e-4,
         max_abs_plain=plain_max,
         max_abs_banded_vs_exact=vs_exact, max_abs_plain_vs_exact=plain_vs_exact,
         max_abs_sdpa_vs_kernel=times["max_abs_sdpa_vs_kernel"],
         cache_bytes_saved=saved, kernel_ms_per_layer=ms,
         plain_ms_per_layer=plain_ms,
         banded_call_ms_per_layer=times["banded_call_ms"],
         sdpa_ms_per_layer=library_ms, bound_ms=bound_ms, bytes=bytes_moved)
    r = results["mp_attention"]
    r.update(launches=counts["mp_attention"], ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, library_ms=library_ms, bound_by=times["bound_by"],
             max_abs_err=max(r["max_abs_err"], vs_plain))


# ---------------------------------------------------------------------------
# phase 8: the fidelity path (Algorithm 1 tile engine, likelihood, kriging)
# ---------------------------------------------------------------------------

def fidelity_policies(p):
    """(label, policy, use_tiles) of phase 8's one-evaluation comparison."""
    import torch
    from repro_torch.core import PrecisionPolicy as P
    full = P.full(torch.float32)
    return [("DP(100%) reference_cholesky", full, None),
            ("DP(100%) tiles", full, True),
            ("DP(10%)", P.from_dp_percent(p, 0.10), None),
            ("DP(40%)", P.from_dp_percent(p, 0.40), None),
            ("three_tier(2,20)", P.three_tier(2, 20), None),
            ("DST DP(70%)", P.dst(P.from_dp_percent(p, 0.70).diag_thick), None)]


def _tiled(policy, use_tiles):
    return policy.mode != "dst" and (
        use_tiles if use_tiles is not None else policy.mode != "full")


def _evaluate(fn, theta):
    """One evaluation from a synced start: (loglik, seconds, peak GiB,
    launch counts)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    ll = float(fn(theta))  # waits for the device
    return (ll, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30, launch_counts())


def fidelity_evaluations(locs, z, theta, fcfg, total, profile=True):
    """8.1: one evaluation per policy at theta through the kernels and
    through the plain versions on the card: launch counts (added to
    `total`), log-likelihoods, seconds, peak memory, and (with `profile`)
    the kernel path's device time under the profiler."""
    from repro_torch.core import make_loglik
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    theta = list(theta)
    for label, pol, use_tiles in fidelity_policies(p):
        tiled = _tiled(pol, use_tiles)
        expected = {"matern_cov": 1, "blocked_potrf": p if tiled else 0,
                    "mp_syrk": p - 1 if tiled else 0, "matern_cov_grad": 0,
                    "mp_syrk_grad": 0, "mp_attention": 0}
        out = {}
        for impl in ("kernel", "plain"):
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             use_tiles=use_tiles, impl=impl)
            out[impl] = _evaluate(fn, theta)
        (a, sa, pa, ca), (b, sb, pb, cb) = out["kernel"], out["plain"]
        require(ca == expected, f"{label}: launches {ca}, expected {expected}")
        require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
        for k in total:
            total[k] += ca[k]
        both_nan = math.isnan(a) and math.isnan(b)
        close = (math.isfinite(a) and math.isfinite(b)
                 and abs(a - b) <= 1e-3 * abs(b))
        require(both_nan or close, f"{label}: kernel {a} vs plain {b}")
        prof = {}
        if profile:
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             use_tiles=use_tiles)
            wall_ms, busy, rows = device_profile(lambda: float(fn(theta)))
            prof = dict(wall_ms=wall_ms, device_busy_ms=busy,
                        idle_share=1 - busy / wall_ms,
                        top=[{"name": k[:90], "count": c, "ms": ms}
                             for k, c, ms in rows[:8]])
        emit(phase="fidelity", step="evaluation", policy=label,
             mode=pol.mode, diag_thick=min(pol.diag_thick, p), tiles=tiled,
             n=locs.shape[0], nb=nb, theta=theta, loglik_kernel=a,
             loglik_plain=b, rel_diff=abs(a - b) / abs(b) if close else None,
             seconds_kernel=sa, seconds_plain=sb, peak_gib_kernel=pa,
             peak_gib_plain=pb, launches_kernel=ca, **prof)


def fidelity_refusals(locs, z, fcfg):
    """What the kernels do not take raises on the card, with no fallback:
    nb not a multiple of 64 (the paper pair's fp64 band runs: phase 9)."""
    from repro_torch.core import PrecisionPolicy, make_loglik
    pol, nb_bad = PrecisionPolicy.tpu(2), 96
    try:
        make_loglik(locs[:4 * nb_bad], z[:4 * nb_bad], pol, nb=nb_bad,
                    nu_static=0.5)(list(MEDIUM))
    except ValueError as e:
        emit(phase="fidelity", step="refused", mode=pol.mode, hi=str(pol.hi),
             nb=nb_bad, error=type(e).__name__, message=str(e)[:120])
    else:
        raise AssertionError(f"{pol.mode} nb={nb_bad}: no error on the card")


def fidelity_estimation(locs, z, fcfg):
    """8.2: fit_mle_grid then batched Nelder-Mead through BatchEngine, for
    DP(100%), DP(10%) and DST; theta-hat, evaluations and seconds.  The
    dense policies go one candidate at a time: cuSOLVER on a batch of
    three 40,960^2 matrices took 2.6x as long per candidate as on one
    (one H100; PERF.md)."""
    import torch
    from repro_torch.core import BatchEngine, BatchPlan, fit_mle, fit_mle_grid
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    pols = {label: pol for label, pol, tiles in fidelity_policies(p)
            if tiles is None and label != "DP(40%)"
            and not label.startswith("three")}
    fits = {}
    for label, pol in pols.items():
        chunk = fcfg["chunk"] if _tiled(pol, None) else 1
        engine = BatchEngine(locs, z, BatchPlan(policy=pol, nb=nb, nu_static=0.5,
                                                chunk_size=chunk))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coarse = fit_mle_grid(engine.loglik, [(0.2, 5.0), (0.02, 0.6)],
                              num=fcfg["grid"], refine=fcfg["refine"])
        res = fit_mle(None, coarse.theta, max_iters=fcfg["nm_iters"],
                      batched_loglik_fn=engine.loglik)
        secs = time.perf_counter() - t0
        evals = coarse.n_evals + res.n_evals
        require(math.isfinite(res.loglik) and res.loglik >= coarse.loglik,
                f"{label}: the polish lost ground ({res.loglik} < {coarse.loglik})")
        fits[label] = res
        emit(phase="fidelity", step="estimation", policy=label,
             chunk_size=chunk, grid=fcfg["grid"],
             refine=fcfg["refine"], nm_iters=res.n_iters,
             theta_grid=coarse.theta.tolist(), theta_hat=res.theta.tolist(),
             loglik=res.loglik, evaluations=evals, seconds=secs,
             seconds_per_evaluation=secs / evals,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    dp, mp = fits["DP(100%) reference_cholesky"].theta, fits["DP(10%)"].theta
    gap = (abs(mp - dp) / abs(dp)).tolist()
    require(max(gap) <= 0.25, f"theta-hat MP {mp} vs DP {dp}: rel {gap} > 0.25")
    emit(phase="fidelity", step="estimation", theta_rel_gap_mp_vs_dp=gap,
         tol=0.25)
    return {label: (pols[label], fits[label].theta) for label in fits}


def fidelity_prediction(locs, z, locs_new, z_new, fits, fcfg):
    """8.3: kriging at the held-out sites with each policy's theta-hat:
    PMSE, the variance's range and k-fold PMSE."""
    from repro_torch.core import kfold_pmse, krige, pmse
    nb = fcfg["nb"]
    scores = {}
    for label, (pol, th) in fits.items():
        theta = [float(th[0]), float(th[1]), 0.5]
        t0 = time.perf_counter()
        mu, var = krige(locs, z, locs_new, theta, pol, nb=nb, nu_static=0.5,
                        return_var=True)
        score = float(pmse(mu, z_new))
        krige_s = time.perf_counter() - t0
        vmin, vmax = float(var.min()), float(var.max())
        require(-1e-4 <= vmin and vmax <= theta[0] + 1e-4 and math.isfinite(score),
                f"{label}: variance in [{vmin}, {vmax}], theta1 {theta[0]}")
        t0 = time.perf_counter()
        kscore, folds = kfold_pmse(locs, z, theta, pol, k=fcfg["kfold"], nb=nb,
                                   nu_static=0.5)
        scores[label] = (score, kscore)
        emit(phase="fidelity", step="prediction", policy=label, theta=theta,
             sites=locs_new.shape[0], pmse=score, var_min=vmin, var_max=vmax,
             krige_seconds=krige_s, kfold=fcfg["kfold"], kfold_pmse=kscore,
             kfold_folds=folds, kfold_seconds=time.perf_counter() - t0)
    dp, mp = scores["DP(100%) reference_cholesky"], scores["DP(10%)"]
    rel = [abs(m - d) / d for m, d in zip(mp, dp)]
    require(max(rel) <= 0.2, f"PMSE MP {mp} vs DP {dp}: rel {rel} > 0.2")
    emit(phase="fidelity", step="prediction", pmse_rel_mp_vs_dp=rel[0],
         kfold_pmse_rel_mp_vs_dp=rel[1], tol=0.2,
         dst_pmse=scores["DST DP(70%)"][0],
         dst_kfold_pmse=scores["DST DP(70%)"][1])


def fidelity_batch(locs, z, fcfg, theta_hat):
    """8.4: BatchEngine.loglik on 8 candidates against loglik_sequential."""
    import numpy as np
    import torch
    from repro_torch.core import BatchEngine, BatchPlan, PrecisionPolicy
    p = locs.shape[0] // fcfg["nb"]
    engine = BatchEngine(locs, z, BatchPlan(
        policy=PrecisionPolicy.from_dp_percent(p, 0.10), nb=fcfg["nb"],
        nu_static=0.5, chunk_size=fcfg["chunk"]))
    scale = np.exp(np.linspace(-0.2, 0.2, fcfg["batch"]))
    thetas = np.stack([theta_hat[0] * scale, theta_hat[1] * scale[::-1]], -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = engine.loglik(thetas).cpu().numpy().astype(np.float64)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = engine.loglik_sequential(thetas)
    seq_s = time.perf_counter() - t0
    rel = np.abs(batched - seq) / np.abs(seq)
    same_nan = np.isnan(batched) == np.isnan(seq)
    require(bool(same_nan.all()) and bool(np.all(rel[~np.isnan(seq)] <= 1e-5)),
            f"batched {batched} vs sequential {seq}")
    emit(phase="fidelity", step="batch_vs_sequential", candidates=len(thetas),
         chunk_size=fcfg["chunk"], max_rel_diff=float(np.nanmax(rel)),
         tol=1e-5, seconds_batched=batched_s, seconds_sequential=seq_s,
         logliks=batched.tolist())


def fidelity_small_vs_cpu():
    """8.5: the tile path at n = 2,048, nb = 256, tpu(2) on the card and on
    the CPU (plain versions there)."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    from repro_torch.covariance import make_dataset
    gen = torch.Generator(device="cuda").manual_seed(4)
    ds = make_dataset(gen, 2048, MEDIUM, nu_static=0.5)
    lls = {}
    for dev in ("cuda", "cpu"):
        fn = make_loglik(ds.locs.to(dev), ds.z.to(dev), PrecisionPolicy.tpu(2),
                         nb=256, nu_static=0.5)
        lls[dev] = float(fn(list(MEDIUM)))
    rel = abs(lls["cuda"] - lls["cpu"]) / abs(lls["cpu"])
    require(math.isfinite(lls["cuda"]) and rel <= 1e-3,
            f"tile path card {lls['cuda']} vs CPU {lls['cpu']}")
    emit(phase="fidelity", step="small_vs_cpu", n=2048, nb=256, mode="mixed",
         t=2, loglik_card=lls["cuda"], loglik_cpu=lls["cpu"], rel_diff=rel,
         tol=1e-3)


def fidelity_general_nu(n=4096, rows=256):
    """8.6: a general-nu (1.27, wind region R2) haversine covariance on the
    card against the CPU in fp64, on `rows` rows of it."""
    import torch
    from repro_torch.covariance import WIND_REGIONS, matern_covariance
    from repro_torch.covariance.generator import WIND_BOXES, random_locations
    gen = torch.Generator(device="cuda").manual_seed(6)
    lon0, lon1, lat0, lat1 = WIND_BOXES["R2"]
    unit = random_locations(gen, n)
    locs = torch.stack([lon0 + unit[:, 0] * (lon1 - lon0),
                        lat0 + unit[:, 1] * (lat1 - lat0)], -1)
    theta = torch.tensor(WIND_REGIONS["R2"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cov = matern_covariance(locs, locs, theta.cuda(), metric="haversine")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    l64 = locs.cpu().double()
    want = matern_covariance(l64[:rows], l64, theta.double(), metric="haversine")
    got = cov[:rows].cpu().double()
    rel = float(((got - want).abs() / want.abs()).max())
    require(bool(torch.isfinite(cov).all()) and rel <= GENERAL_NU_MAX_REL,
            f"general nu on the card: max rel {rel} > {GENERAL_NU_MAX_REL}")
    emit(phase="fidelity", step="general_nu", nu=WIND_REGIONS["R2"][2],
         metric="haversine", n=n, rows_checked=rows, max_rel=rel,
         tol=GENERAL_NU_MAX_REL, seconds_card=card_s)


def fidelity_kernels(locs, locs_new, fcfg, results):
    """8.7: each kernel at the tile path's shapes against its plain version,
    timed beside its yardstick and bound: mp_syrk at step 0 (band of
    DP(10%)), blocked_potrf on a chunk's diagonal tiles, matern_cov for
    Sigma and Sigma_no."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels.blocked_potrf import ops as potrf_ops
    from repro_torch.kernels.blocked_potrf import ref as potrf_ref
    from repro_torch.kernels.matern_cov import ops as mc_ops
    from repro_torch.kernels.matern_cov import ref as mc_ref
    from repro_torch.kernels.mp_gemm import ops as syrk_ops
    from repro_torch.kernels.mp_gemm import ref as syrk_ref
    nb = fcfg["nb"]
    n = locs.shape[0]
    p = n // nb
    t = PrecisionPolicy.from_dp_percent(p, 0.10).diag_thick
    gen = torch.Generator(device="cuda").manual_seed(8)
    # mp_syrk at step 0: P = ((p - 1) nb, nb)
    pm = torch.randn(((p - 1) * nb, nb), generator=gen, device="cuda")
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    out = syrk_ops.mp_syrk(pm, **kw)
    want = syrk_ref.mp_syrk(pm, **kw)
    rel, ratio, mx = _syrk_errors(out, want, pm, tile=nb, round_k=nb, band=t)
    require(rel <= 1e-5 and ratio <= 1.0, f"mp_syrk tile step 0: {rel} {ratio}")
    del out, want
    syrk = syrk_step_numbers(pm, p - 1, nb, t)
    syrk.update(plain_ms=time_ms(lambda: syrk_ref.mp_syrk(pm, **kw)),
                inband_rel=rel, offband_err_over_tol=ratio, max_abs_err=mx)
    emit(phase="fidelity", step="kernel", kernel="mp_syrk",
         m=(p - 1) * nb, k=nb, band=t, **syrk)
    del pm
    # blocked_potrf on a chunk's diagonal tiles
    a = spd_batch(gen, fcfg["chunk"], nb)
    l, info = potrf_ops.potrf(a)
    lw, _ = potrf_ref.potrf(a)
    prel = scale_rel(l, lw)
    require(int(info.abs().sum()) == 0 and prel <= 1e-3, f"potrf batch: {prel}")
    flops = fcfg["chunk"] * nb ** 3 / 3
    bytes_moved = fcfg["chunk"] * 2 * 4 * nb ** 2
    emit(phase="fidelity", step="kernel", kernel="blocked_potrf",
         batch=fcfg["chunk"], nb=nb, max_rel=prel,
         ms=time_ms(lambda: potrf_ops.potrf(a)),
         plain_ms=time_ms(lambda: potrf_ref.potrf(a)),
         library_ms=time_ms(lambda: torch.linalg.cholesky(a)),
         bound_ms=1e3 * max(flops / FP32_FLOPS, bytes_moved / HBM_BYTES_PER_S))
    del a, l, lw
    # matern_cov: Sigma (n x n) and Sigma_no (m x n), one tile each;
    # checked on row slabs (the plain version's temporaries are 4x the tile);
    # Sigma = C(locs, locs) is the symmetric form: equal to its transpose
    # and to the general form's (the locations as a copy) bit for bit, both
    # forms timed
    theta = list(MEDIUM)
    for what, la in (("Sigma", locs), ("Sigma_no", locs_new)):
        out = mc_ops.matern_cov(la, locs, theta, nu=0.5)
        rel = 0.0
        for r0 in (0, max(0, la.shape[0] - 2048)):
            w = mc_ref.matern_cov(la[r0:r0 + 2048], locs, theta, nu=0.5)
            rel = max(rel, float(((out[r0:r0 + 2048] - w).abs()
                                  / w.abs().clamp_min(1e-30)).max()))
        require(rel <= 1e-5, f"matern_cov {what}: rel {rel}")
        del w
        sym = _sigma_forms(out, la, locs, theta, torch.float32) if la is locs else {}
        del out
        elems = la.shape[0] * n
        bytes_moved = (la.shape[0] + n) * 8 + 4 * elems
        emit(phase="fidelity", step="kernel", kernel="matern_cov", what=what,
             shape=[la.shape[0], n], max_rel=rel,
             ms=time_ms(lambda: mc_ops.matern_cov(la, locs, theta, nu=0.5)),
             plain_ms=time_ms(lambda: mc_ref.matern_cov(la, locs, theta, nu=0.5),
                              reps=2),
             bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                                9 * elems / FP32_FLOPS), **sym)
        torch.cuda.empty_cache()


def _sigma_forms(out, la, locs, theta, dtype):
    """Sigma = out from the symmetric form: equal to its transpose and to
    the general form's Sigma (la as a copy) bit for bit; the general form
    timed (ms_general)."""
    import torch
    from repro_torch.kernels.matern_cov import ops as mc_ops
    copy = la.clone()
    sym = bool(torch.equal(out, out.T))
    gen = mc_ops.matern_cov(copy, locs, theta, nu=0.5, out_dtype=dtype)
    same = bool(torch.equal(out, gen))
    del gen
    torch.cuda.empty_cache()
    require(sym and same, f"matern_cov Sigma {dtype}: equal to its transpose "
            f"{sym}, to the general form {same}")
    return dict(equal_to_transpose=sym, equal_to_general=same,
                ms_general=time_ms(lambda: mc_ops.matern_cov(
                    copy, locs, theta, nu=0.5, out_dtype=dtype)))


def _fidelity_data(gen, theta0, fcfg):
    """make_dataset at n_all points; every hold-th held out, the first n_obs
    of the rest observed: (locs, z, locs_new, z_new), contiguous."""
    import torch
    from repro_torch.covariance import make_dataset
    ds = make_dataset(gen, fcfg["n_all"], theta0, nu_static=0.5)
    idx = torch.arange(fcfg["n_all"], device="cuda")
    held = idx % fcfg["hold"] == fcfg["hold"] - 1
    new, obs = idx[held], idx[~held][:fcfg["n_obs"]]
    require(obs.numel() == fcfg["n_obs"], f"{obs.numel()} observations")
    return tuple(x.contiguous() for x in (ds.locs[obs], ds.z[obs],
                                          ds.locs[new], ds.z[new]))


def fidelity(fcfg, results):
    """Phase 8: the fidelity path at n_obs locations in nb-tiles (see the
    module docstring), sub-steps timed into one phase line.

    8.1 evaluates every policy on the medium-correlation field at its
    theta0, as the paper's estimation study sets it.  There the bf16
    off-band makes the covariance indefinite (NaN in both paths on one
    H100; PERF.md), so the estimation, the prediction and the batch check run
    on the weak-correlation field, where every pair's likelihood is
    defined; 8.1 runs there too.
    """
    import torch
    t_all = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    fields = {"medium": MEDIUM, "weak": WEAK}
    data = {name: _fidelity_data(gen, fields[name], fcfg)
            for name in fcfg["fields"]}
    torch.cuda.empty_cache()
    emit(phase="fidelity", step="data", n_all=fcfg["n_all"], n_obs=fcfg["n_obs"],
         sites=int(data["weak"][2].shape[0]), nb=fcfg["nb"],
         p=fcfg["n_obs"] // fcfg["nb"],
         theta0={name: fields[name] for name in fcfg["fields"]},
         seconds=time.perf_counter() - t_all)
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    total = {"matern_cov": 0, "blocked_potrf": 0, "mp_syrk": 0}
    locs, z, locs_new, z_new = data["weak"]
    for name in fcfg["fields"]:  # the profile on the weak field only
        step(f"8.1 evaluations, {name}", fidelity_evaluations,
             *data[name][:2], fields[name], fcfg, total, name == "weak")
    for k, v in total.items():
        results[k]["launches_fidelity"] = v
    step("8.1 refusals", fidelity_refusals, locs, z, fcfg)
    fits = step("8.2 estimation", fidelity_estimation, locs, z, fcfg)
    step("8.3 prediction", fidelity_prediction, locs, z, locs_new, z_new, fits,
         fcfg)
    step("8.4 batch", fidelity_batch, locs, z, fcfg, fits["DP(10%)"][1])
    step("8.5 small vs CPU", fidelity_small_vs_cpu)
    step("8.6 general nu", fidelity_general_nu)
    step("8.7 kernels", fidelity_kernels, locs, locs_new, fcfg, results)
    emit(phase="fidelity", step="seconds", **secs)
    return locs, z


# ---------------------------------------------------------------------------
# phase 9: the paper pair {fp64 band, fp32 off-band} on the fidelity path
# ---------------------------------------------------------------------------

def paper_policies(p):
    """(label, policy, use_tiles) of phase 9: full(fp64) dense and through
    the tiles, and the paper pair at DP(10%) and DP(40%)."""
    import torch
    from repro_torch.core import PrecisionPolicy as P
    full = P.full(torch.float64)
    return [("full(fp64) reference_cholesky", full, None),
            ("full(fp64) tiles", full, True),
            ("paper_cpu DP(10%)", P.from_dp_percent(p, 0.10, "paper_cpu"), None),
            ("paper_cpu DP(40%)", P.from_dp_percent(p, 0.40, "paper_cpu"), None)]


def _paper_data(gen, fcfg):
    """An fp64 field at the medium theta0: fp64 locations, the draw through
    an fp64 Cholesky, Morton order; split as `_fidelity_data`."""
    import torch
    from repro_torch.covariance import (ORDERINGS, apply_ordering,
                                        random_locations, simulate_field)
    locs = random_locations(gen, fcfg["n_all"], dtype=torch.float64)
    z = simulate_field(gen, locs, MEDIUM, nu_static=0.5)
    locs, z = apply_ordering(locs, z, ORDERINGS["morton"](locs))
    idx = torch.arange(fcfg["n_all"], device="cuda")
    held = idx % fcfg["hold"] == fcfg["hold"] - 1
    new, obs = idx[held], idx[~held][:fcfg["n_obs"]]
    require(obs.numel() == fcfg["n_obs"], f"{obs.numel()} observations")
    return tuple(x.contiguous() for x in (locs[obs], z[obs], locs[new], z[new]))


def paper_evaluations(locs, z, fcfg, total):
    """9.1: one evaluation per policy at the medium theta0 through the
    kernels and through the plain versions (exact launch counts, kernel
    against plain within 1e-5 |ll|, each paper pair against dense fp64
    within 1e-4 |ll|), the paper pair's drift beside its registered bound,
    one profiled DP(10%) evaluation, and tpu(2) on the same field."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    theta = list(MEDIUM)
    dense = None
    for label, pol, use_tiles in paper_policies(p):
        tiled = _tiled(pol, use_tiles)
        expected = {"matern_cov": 1, "blocked_potrf": 0,
                    "mp_syrk": p - 1 if tiled else 0, "matern_cov_grad": 0,
                    "mp_syrk_grad": 0, "mp_attention": 0}
        out = {}
        for impl in ("kernel", "plain"):
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             use_tiles=use_tiles, impl=impl)
            out[impl] = _evaluate(fn, theta)
        (a, sa, pa, ca), (b, sb, pb, cb) = out["kernel"], out["plain"]
        require(ca == expected, f"{label}: launches {ca}, expected {expected}")
        require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
        require(math.isfinite(a) and math.isfinite(b)
                and abs(a - b) <= 1e-5 * abs(b), f"{label}: kernel {a} vs plain {b}")
        extra = {}
        if dense is None:
            dense = a
        else:  # fp64 through the tiles: within the fp64 pair's own bound
            drift = abs(a - dense) / abs(dense)
            tol = 1e-4 if pol.mode == "mixed" else PAPER_LOGLIK_DRIFT
            require(drift <= tol, f"{label}: {a} vs full(fp64) {dense}")
            extra = dict(drift_vs_full_fp64=drift, drift_tol=tol,
                         registered_loglik_drift=PAPER_LOGLIK_DRIFT,
                         within_registered=drift <= PAPER_LOGLIK_DRIFT)
        if pol.mode == "mixed":
            for k in total:
                total[k] += ca[k]
        emit(phase="paper", step="evaluation", policy=label, mode=pol.mode,
             diag_thick=min(pol.diag_thick, p), tiles=tiled, n=locs.shape[0],
             nb=nb, theta=theta, loglik_kernel=a, loglik_plain=b,
             rel_diff=abs(a - b) / abs(b), tol=1e-5, seconds_kernel=sa,
             seconds_plain=sb, peak_gib_kernel=pa, peak_gib_plain=pb,
             launches_kernel=ca, **extra)
    pol = PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu")
    fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5)
    wall_ms, busy, rows = device_profile(lambda: float(fn(theta)))
    emit(phase="paper", step="profile", policy="paper_cpu DP(10%)",
         wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:10]])
    # the {fp32, bf16} pair on the same field (its locations and data in
    # fp32): NaN at this theta0, where the paper pair is finite
    pol = PrecisionPolicy.tpu(2)
    ll, secs, peak, counts = _evaluate(make_loglik(
        locs.float(), z.float(), pol, nb=nb, nu_static=0.5), theta)
    require(counts["mp_syrk"] == p - 1 and counts["blocked_potrf"] == p,
            f"tpu(2): launches {counts}")
    emit(phase="paper", step="evaluation", policy="tpu(2) DP(10%)",
         mode=pol.mode, diag_thick=2, tiles=True, theta=theta,
         loglik_kernel=ll, finite=math.isfinite(ll), seconds_kernel=secs,
         peak_gib_kernel=peak, launches_kernel=counts)
    return dense


def paper_estimation(locs, z, fcfg):
    """9.2: fit_mle_grid then batched Nelder-Mead through BatchEngine (one
    candidate per chunk: three fp64 Sigma with their U pass 80 GB) for
    full(fp64) dense and the paper pair at DP(10%), from phase 8.2's grid;
    theta-hat within rel 0.25 per component."""
    import torch
    from repro_torch.core import BatchEngine, BatchPlan, fit_mle, fit_mle_grid
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    pols = {label: pol for label, pol, tiles in paper_policies(p)
            if tiles is None and "40%" not in label}
    fits = {}
    for label, pol in pols.items():
        engine = BatchEngine(locs, z, BatchPlan(policy=pol, nb=nb, nu_static=0.5,
                                                chunk_size=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coarse = fit_mle_grid(engine.loglik, [(0.2, 5.0), (0.02, 0.6)],
                              num=fcfg["grid"], refine=fcfg["refine"])
        res = fit_mle(None, coarse.theta, max_iters=fcfg["nm_iters"],
                      batched_loglik_fn=engine.loglik)
        secs = time.perf_counter() - t0
        evals = coarse.n_evals + res.n_evals
        require(math.isfinite(res.loglik) and res.loglik >= coarse.loglik,
                f"{label}: the polish lost ground ({res.loglik} < {coarse.loglik})")
        fits[label] = (pol, res.theta)
        emit(phase="paper", step="estimation", policy=label, chunk_size=1,
             grid=fcfg["grid"], refine=fcfg["refine"], nm_iters=res.n_iters,
             theta_grid=coarse.theta.tolist(), theta_hat=res.theta.tolist(),
             theta1_over_theta2=float(res.theta[0] / res.theta[1]),
             loglik=res.loglik, evaluations=evals, seconds=secs,
             seconds_per_evaluation=secs / evals,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    dp = fits["full(fp64) reference_cholesky"][1]
    mp = fits["paper_cpu DP(10%)"][1]
    gap = (abs(mp - dp) / abs(dp)).tolist()
    ratio_gap = abs(mp[0] / mp[1] - dp[0] / dp[1]) / (dp[0] / dp[1])
    require(max(gap) <= 0.25, f"theta-hat paper {mp} vs fp64 {dp}: rel {gap} > 0.25")
    emit(phase="paper", step="estimation", theta_rel_gap_vs_fp64=gap, tol=0.25,
         theta1_over_theta2_rel_gap=float(ratio_gap))
    return fits


def paper_prediction(locs, z, locs_new, z_new, fits, fcfg):
    """9.3: kriging with variance at the held-out sites at each theta-hat;
    the paper pair's PMSE within rel 0.2 of full(fp64)'s."""
    from repro_torch.core import krige, pmse
    scores = {}
    for label, (pol, th) in fits.items():
        theta = [float(th[0]), float(th[1]), 0.5]
        t0 = time.perf_counter()
        mu, var = krige(locs, z, locs_new, theta, pol, nb=fcfg["nb"],
                        nu_static=0.5, return_var=True)
        scores[label] = score = float(pmse(mu, z_new))
        vmin, vmax = float(var.min()), float(var.max())
        require(-1e-6 <= vmin and vmax <= theta[0] + 1e-6 and math.isfinite(score),
                f"{label}: variance in [{vmin}, {vmax}], theta1 {theta[0]}")
        emit(phase="paper", step="prediction", policy=label, theta=theta,
             sites=locs_new.shape[0], pmse=score, var_min=vmin, var_max=vmax,
             dtype=str(mu.dtype), seconds=time.perf_counter() - t0)
    dp, mp = scores["full(fp64) reference_cholesky"], scores["paper_cpu DP(10%)"]
    rel = abs(mp - dp) / dp
    require(rel <= 0.2, f"PMSE paper {mp} vs fp64 {dp}: rel {rel} > 0.2")
    emit(phase="paper", step="prediction", pmse_rel_vs_fp64=rel, tol=0.2)


def paper_kernels(locs, locs_new, fcfg, results):
    """9.4: the fp64 kernels at the tile path's shapes: mp_syrk (fp64, fp32)
    at step 0 (band of DP(10%)) and matern_cov in fp64 for Sigma and
    Sigma_no, each against its plain version (compared on row slabs) with
    its time, yardstick and bound."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels.matern_cov import ops as mc_ops
    from repro_torch.kernels.matern_cov import ref as mc_ref
    from repro_torch.kernels.mp_gemm import ops as syrk_ops
    from repro_torch.kernels.mp_gemm import ref as syrk_ref
    f32, f64 = torch.float32, torch.float64
    nb = fcfg["nb"]
    n = locs.shape[0]
    p = n // nb
    t = PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu").diag_thick
    gen = torch.Generator(device="cuda").manual_seed(9)
    pm = torch.randn(((p - 1) * nb, nb), generator=gen, device="cuda", dtype=f64)
    kw = dict(tile=nb, round_k=nb, band_blocks=t, hi=f64, lo=f32, accum=f32)
    out = syrk_ops.mp_syrk(pm, **kw)
    want = syrk_ref.mp_syrk(pm, **kw)
    brel, orel, mx, fp32_off = _syrk64_errors(out, want, tile=nb, band=t)
    sym = bool(torch.equal(out, out.T))
    require(brel <= 1e-11 and orel <= 1e-5 and fp32_off and sym,
            f"mp_syrk fp64 tile step 0: {brel} {orel} {fp32_off} {sym}")
    del out, want
    torch.cuda.empty_cache()
    # no trace of the call here: late in a run, three traces that held
    # only this library's launches came back without device events
    # (device_profile); phase 3 traces the same kernels at the panel's step
    # 0, and 9.1's profiled evaluation at every step of this path
    nums = syrk64_numbers(pm, nb, t, per_kernel=False)
    emit(phase="paper", step="kernel", kernel="mp_syrk", hi=str(f64),
         lo=str(f32), m=(p - 1) * nb, k=nb, band=t, inband_rel=brel,
         offband_rel=orel, max_abs_err=mx, symmetric=sym,
         plain_ms=time_ms(lambda: syrk_ref.mp_syrk(pm, **kw), reps=3), **nums)
    del pm
    theta = list(MEDIUM)
    row = None
    for what, la in (("Sigma", locs), ("Sigma_no", locs_new)):
        out = mc_ops.matern_cov(la, locs, theta, nu=0.5, out_dtype=f64)
        require(out.dtype == f64, f"matern_cov {what}: {out.dtype}")
        err = 0.0
        for r0 in range(0, la.shape[0], 2048):
            w = mc_ref.matern_cov(la[r0:r0 + 2048], locs, theta, nu=0.5,
                                  out_dtype=f64)
            err = max(err, float((out[r0:r0 + 2048] - w).abs().max()))
        require(err <= 1e-12 * theta[0], f"matern_cov fp64 {what}: {err}")
        del w
        sym = _sigma_forms(out, la, locs, theta, f64) if la is locs else {}
        del out
        elems = la.shape[0] * n
        bytes_moved = (la.shape[0] + n) * 16 + 8 * elems
        by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, 9 * elems / FP64_FLOPS
        line = dict(shape=[la.shape[0], n], max_abs_err=err,
                    tol=1e-12 * theta[0],
                    ms=time_ms(lambda: mc_ops.matern_cov(la, locs, theta, nu=0.5,
                                                         out_dtype=f64)),
                    plain_ms=time_ms(lambda: mc_ref.matern_cov(
                        la, locs, theta, nu=0.5, out_dtype=f64), reps=2),
                    bound_ms=1e3 * max(by_bytes, by_ops),
                    bound_by="bytes" if by_bytes >= by_ops else "operations")
        row = row or line  # the row of the kernels line: Sigma
        emit(phase="paper", step="kernel", kernel="matern_cov", what=what,
             dtype=str(f64), **line, **sym)
        torch.cuda.empty_cache()
    res = results.setdefault("matern_cov_fp64", {})
    res.update(
        name="matern_cov (fp64)", route="cuda",
        source="src/repro_torch/csrc/matern_cov.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=max(row["max_abs_err"], res.get("max_abs_err", 0.0)),
        ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None)


def paper(fcfg, results):
    """Phase 9: the paper pair on an fp64 medium field at n_obs locations
    in nb-tiles (see the module docstring), sub-steps timed into one line."""
    import torch
    t_all = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    locs, z, locs_new, z_new = _paper_data(gen, fcfg)
    torch.cuda.empty_cache()
    emit(phase="paper", step="data", n_all=fcfg["n_all"], n_obs=fcfg["n_obs"],
         sites=int(locs_new.shape[0]), nb=fcfg["nb"],
         p=fcfg["n_obs"] // fcfg["nb"], theta0=MEDIUM, dtype=str(locs.dtype),
         seconds=time.perf_counter() - t_all)
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    total = {"matern_cov": 0, "blocked_potrf": 0, "mp_syrk": 0}
    dense = step("9.1 evaluations", paper_evaluations, locs, z, fcfg, total)
    require(total["mp_syrk"] > 0 and total["matern_cov"] > 0,
            f"the paper pair launched {total}")
    results.setdefault("mp_syrk_fp64", {})["launches_paper"] = total["mp_syrk"]
    results.setdefault("matern_cov_fp64", {})["launches_paper"] = total["matern_cov"]
    if fcfg["estimate"]:
        fits = step("9.2 estimation", paper_estimation, locs, z, fcfg)
        step("9.3 prediction", paper_prediction, locs, z, locs_new, z_new,
             fits, fcfg)
    step("9.4 kernels", paper_kernels, locs, locs_new, fcfg, results)
    emit(phase="paper", step="seconds", **secs)
    return (locs, z), dense


# ---------------------------------------------------------------------------
# phase 10: the gradient path (fit_mle_adam through matern_cov's backward)
# ---------------------------------------------------------------------------

def grad_bound(rows, cols, dtype):
    """(bound ms, bound_by) of one matern_cov_grad call on a (rows, cols) G:
    G and the locations read once (bytes), against 16 operations per
    element in the locations' precision (the forward's 9, the derivative's
    at most 5, two conversions) and 4 fp64 flops (two multiply-adds)."""
    import torch
    size = torch.finfo(dtype).bits // 8
    elems = rows * cols
    by_bytes = (elems + 2 * (rows + cols)) * size / HBM_BYTES_PER_S
    peak = FP32_FLOPS if dtype == torch.float32 else FP64_FLOPS
    by_ops = 16 * elems / peak + 4 * elems / FP64_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def check_matern_grad(fields, gcfg, results):
    """10.0: matern_cov_grad against its plain version on the card, fp32 and
    fp64 at every nu, on a (check_n, check_n) G and on the fidelity path's
    Sigma (phase 8's weak field in fp32, phase 9's field in fp64), G drawn
    from a seed.  Each sum's error is held against its scale, sum |G|
    dK/dtheta_k (the plain version on |G|), and a second launch must give
    the same bits; the kernel is timed with CUDA events at every nu on the
    large G, the plain version at nu = 0.5.  The calls pass one location
    tensor twice: the symmetric form.  The general form (the locations as a
    copy) is held to the same tolerance against the plain version and
    against the symmetric form, and timed beside it on the large G."""
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(10)
    for dtype, locs, theta in fields:
        worst, main = 0.0, None
        tol = GRAD_KERNEL_TOL[str(dtype)]
        for n in (gcfg["check_n"], locs.shape[0]):
            la = locs[:n].contiguous()
            copy = la.clone()
            g = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype)
            for nu in (0.5, 1.5, 2.5):
                got = ops.matern_cov_grad(la, la, theta, g, nu=nu)
                # no float atomics: the same bits from run to run
                require(torch.equal(got, ops.matern_cov_grad(la, la, theta, g,
                                                             nu=nu)),
                        f"matern_cov_grad {dtype} n={n} nu={nu}: two runs differ")
                want = ref.matern_cov_grad(la, la, theta, g, nu=nu)
                scale = ref.matern_cov_grad(la, la, theta, g.abs(), nu=nu)
                err = (got.double() - want.double()).abs()
                ratio = float((err / scale.double()).max())
                require(got.dtype == dtype and ratio <= tol,
                        f"matern_cov_grad {dtype} n={n} nu={nu}: {got.tolist()} "
                        f"vs {want.tolist()}, {ratio} of the scale > {tol}")
                general = ops.matern_cov_grad(la, copy, theta, g, nu=nu)
                gen_ratio = float(((general.double() - want.double()).abs()
                                   / scale.double()).max())
                sym_ratio = float(((got.double() - general.double()).abs()
                                   / scale.double()).max())
                require(max(gen_ratio, sym_ratio) <= tol,
                        f"matern_cov_grad {dtype} n={n} nu={nu}: general "
                        f"{general.tolist()}, {gen_ratio} of the scale from the "
                        f"plain version, {sym_ratio} from the symmetric form")
                worst = max(worst, float(err.max()))
                line = dict(n=n, nu=nu, dtype=str(dtype), grad=got.tolist(),
                            grad_plain=want.tolist(), scale=scale.tolist(),
                            max_abs_err=float(err.max()), err_over_scale=ratio,
                            tol=tol, general_err_over_scale=gen_ratio,
                            symmetric_vs_general_over_scale=sym_ratio)
                if n == locs.shape[0]:
                    line["ms"] = time_ms(lambda: ops.matern_cov_grad(
                        la, la, theta, g, nu=nu))
                    line["ms_general"] = time_ms(lambda: ops.matern_cov_grad(
                        la, copy, theta, g, nu=nu))
                    line["bound_ms"], line["bound_by"] = grad_bound(n, n, dtype)
                    if nu == 0.5:
                        line["plain_ms"] = time_ms(lambda: ref.matern_cov_grad(
                            la, la, theta, g, nu=nu), reps=2)
                        main = line
                emit(phase="gradient", step="kernel", kernel="matern_cov_grad",
                     **line)
            del g, copy
            torch.cuda.empty_cache()
        key = "matern_cov_grad" + ("" if dtype == torch.float32 else "_fp64")
        results.setdefault(key, {}).update(
            name="matern_cov_grad" + ("" if dtype == torch.float32 else " (fp64)"),
            route="cuda", source="src/repro_torch/csrc/matern_cov_grad.cu",
            replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
            max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None)


def _value_and_grad(fn, theta, z=None):
    """ll and its gradient in a host fp32 theta, as fit_mle_adam takes them:
    (ll, grad list, forward s, backward s, peak GiB, launch counts); given
    z, ll = fn(theta, z) and z's gradient follows the launch counts."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    args = [torch.tensor(theta, dtype=torch.float32, requires_grad=True)]
    if z is not None:
        args.append(z.detach().clone().requires_grad_())
    t0 = time.perf_counter()
    ll = fn(*args)
    value = float(ll.detach())  # waits for the device
    t1 = time.perf_counter()
    grads = torch.autograd.grad(ll, args)
    g = grads[0].tolist()  # theta's gradient is a host tensor: waits
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (value, g, t1 - t0, t2 - t1,
            torch.cuda.max_memory_allocated() / 2 ** 30, launch_counts(),
            *grads[1:])


def gradient_evaluation(label, locs, z, theta, results, key):
    """10.1: one value-and-gradient evaluation of dense full(locations'
    dtype) at theta through the kernels and through the plain versions:
    launch counts (matern_cov and matern_cov_grad once each), the kernel
    path's log-likelihood equal to the no-grad evaluation's bit for bit,
    gradients kernel against plain, seconds forward and backward, peak, and
    the kernel path under the profiler (matern_cov_grad_kernel once)."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    pol = PrecisionPolicy.full(locs.dtype)
    expected = dense_grad_launches()
    out = {}
    for impl in ("kernel", "plain"):
        fn = make_loglik(locs, z, pol, nu_static=0.5, impl=impl)
        out[impl] = _value_and_grad(fn, theta)
    (a, ga, fa, ba, pa, ca), (b, gb, fb, bb, pb, cb) = out["kernel"], out["plain"]
    require(ca == expected, f"{label}: launches {ca}, expected {expected}")
    require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
    fn = make_loglik(locs, z, pol, nu_static=0.5)
    with torch.no_grad():  # the same fp32 theta, no autograd
        no_grad = float(fn(torch.tensor(theta, dtype=torch.float32)))
    require(a == no_grad, f"{label}: ll {a} with grad, {no_grad} without")
    tol = GRAD_EVAL_TOL[str(locs.dtype)]
    scale = max(abs(v) for v in gb)
    err = max(abs(x - y) for x, y in zip(ga, gb)) / scale
    require(math.isfinite(a) and all(map(math.isfinite, ga)) and ga[2] == 0.0
            and abs(a - b) <= tol * abs(b) and err <= tol,
            f"{label}: kernel {a} {ga} vs plain {b} {gb}")
    wall_ms, busy, rows = device_profile(lambda: _value_and_grad(fn, theta))
    grad_rows = [(k, c, ms) for k, c, ms in rows if "matern_cov_grad_kernel" in k]
    require(sum(c for _, c, _ in grad_rows) == 1,
            f"{label}: matern_cov_grad_kernel launched {grad_rows} in one evaluation")
    emit(phase="gradient", step="evaluation", policy=label, n=locs.shape[0],
         theta=list(theta), loglik_kernel=a, loglik_plain=b,
         loglik_no_grad=no_grad, grad_kernel=ga, grad_plain=gb,
         grad_err_over_max=err, tol=tol, seconds_forward_kernel=fa,
         seconds_backward_kernel=ba, seconds_forward_plain=fb,
         seconds_backward_plain=bb, peak_gib_kernel=pa, peak_gib_plain=pb,
         launches_kernel=ca, wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1 - busy / wall_ms,
         matern_cov_grad_device_ms=sum(ms for _, _, ms in grad_rows),
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:10]])
    results.setdefault(key, {})["launches"] = ca["matern_cov_grad"]
    MEASURED[f"10.1 {label}"] = dict(n=locs.shape[0], grad=ga, loglik=a)
    return fa + ba, pa


def fp64_grad_n(n_obs, peak32, limit):
    """The largest multiple of 1,024, at most n_obs, whose full(fp64)
    value-and-gradient evaluation is predicted to peak under `limit` GiB:
    twice the fp32 evaluation's peak at n_obs (the same tensors in twice the
    bytes), scaled by n^2."""
    if 2 * peak32 <= limit:
        return n_obs
    return int(n_obs * math.sqrt(limit / (2 * peak32)) // 1024 * 1024)


def gradient_adam(gcfg, locs, z, t_eval):
    """10.2: fit_mle_adam on dense full(fp32) as the reference's test runs
    it (120 steps at lr 0.05 from 0.8 theta0) at n = adam_n on phase 6's
    field, against fit_mle on the same likelihood (theta2-hat within rel
    0.1); then Adam at n_obs on phase 8's weak field for as many steps as
    fit in adam_seconds (t_eval: 10.1's seconds per evaluation), with the
    log-likelihood of every step."""
    import torch
    from repro_torch.core import (PrecisionPolicy, fit_mle, fit_mle_adam,
                                  make_loglik)
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    pol = PrecisionPolicy.full(torch.float32)
    nu = torch.tensor([0.5])
    gen = torch.Generator(device="cuda").manual_seed(1)  # phase 6's field
    ds = make_dataset(gen, gcfg["adam_n"], MEDIUM, nu_static=0.5)
    ll = make_loglik(ds.locs, ds.z, pol, nu_static=0.5)
    start = [0.8 * MEDIUM[0], 0.8 * MEDIUM[1]]
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_mle_adam(lambda th: ll(torch.cat([th, nu])), start,
                       steps=gcfg["adam_steps"], lr=gcfg["adam_lr"])
    adam_s = time.perf_counter() - t0
    counts = launch_counts()
    require(counts["matern_cov_grad"] == gcfg["adam_steps"]
            and counts["matern_cov"] == gcfg["adam_steps"] + 1,
            f"Adam launches {counts}")
    t0 = time.perf_counter()
    nm = fit_mle(lambda th: ll([th[0], th[1], 0.5]), start,
                 max_iters=gcfg["nm_iters"])
    nm_s = time.perf_counter() - t0
    rel = abs(float(res.theta[1]) - nm.theta[1]) / nm.theta[1]
    require(math.isfinite(res.loglik) and rel <= 0.1,
            f"Adam theta2 {res.theta[1]} vs Nelder-Mead {nm.theta[1]}: rel {rel}")
    emit(phase="gradient", step="adam", n=gcfg["adam_n"], start=start,
         steps=gcfg["adam_steps"], lr=gcfg["adam_lr"],
         theta_adam=res.theta.tolist(), loglik_adam=res.loglik,
         history=[(h[0].tolist(), h[1]) for h in res.history],
         seconds_adam=adam_s, seconds_per_step=adam_s / gcfg["adam_steps"],
         theta_nm=nm.theta.tolist(), loglik_nm=nm.loglik, nm_evals=nm.n_evals,
         seconds_nm=nm_s, theta2_rel_gap=rel, tol=0.1, launches_adam=counts)
    del ll, ds
    torch.cuda.empty_cache()
    # as many steps at n_obs as fit in adam_seconds: steps are cut, not n
    steps = max(1, int(gcfg["adam_seconds"] // t_eval))
    ll = make_loglik(locs, z, pol, nu_static=0.5)
    values = []

    def traced(th):
        v = ll(torch.cat([th, nu]))
        values.append(float(v.detach()))
        return v
    start = [0.8 * WEAK[0], 0.8 * WEAK[1]]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fit_mle_adam(traced, start, steps=steps, lr=gcfg["adam_lr"])
    secs = time.perf_counter() - t0
    counts = launch_counts()
    # the reference's lr is sized for n = 256: at n_obs Adam's first steps
    # may cross the theta1 / theta2 ridge, so no climb is required here
    require(counts["matern_cov_grad"] == steps and all(map(math.isfinite, values)),
            f"Adam at n_obs: {counts} {values}")
    emit(phase="gradient", step="adam", n=locs.shape[0], start=start,
         steps=steps, lr=gcfg["adam_lr"], loglik_per_step=values[:steps],
         loglik_best=max(values), loglik_final=res.loglik,
         theta=res.theta.tolist(), seconds=secs,
         seconds_per_step=secs / steps,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=counts)


# ---------------------------------------------------------------------------
# phase 10.3: the tile engine's gradient (blocked_potrf and mp_syrk under
# autograd, mp_syrk's backward mp_syrk_grad)
# ---------------------------------------------------------------------------

def dense_grad_launches():
    """Launches of one dense value-and-gradient evaluation: matern_cov and
    matern_cov_grad once each."""
    return {"matern_cov": 1, "matern_cov_grad": 1, "blocked_potrf": 0,
            "mp_syrk": 0, "mp_syrk_grad": 0, "mp_attention": 0}


def tile_grad_launches(p, fp32_band):
    """Launches of one value-and-gradient evaluation through the tile engine
    of p tiles: matern_cov and matern_cov_grad once, blocked_potrf per
    diagonal tile of an fp32 band (an fp64 band goes to cuSOLVER), mp_syrk
    and mp_syrk_grad once per step."""
    return {"matern_cov": 1, "matern_cov_grad": 1,
            "blocked_potrf": p if fp32_band else 0, "mp_syrk": p - 1,
            "mp_syrk_grad": p - 1, "mp_attention": 0}


def syrk_grad_flops(n_t, nb, t):
    """(in-band, off-band) flops of mp_syrk_grad on P = (n_t nb, nb), tile =
    nb: dP = S P, 2 nb flops for each element of the square S; tile row i
    has min(n_t, i + t) - max(0, i - t + 1) tiles in the band."""
    band_tiles = sum(min(n_t, i + t) - max(0, i - t + 1) for i in range(n_t))
    band = 2 * nb * nb * nb * band_tiles
    return band, 2 * nb * (n_t * nb) ** 2 - band


def syrk_grad_bound(n_t, nb, t, pair):
    """(least ms, bound_by) of mp_syrk_grad on P = (n_t nb, nb) under pair
    (hi, lo, accum): the band's operations at hi's peak (fp32 67 TFLOP/s,
    fp64 67 on the tensor cores), the off-band's at lo's (bf16 989 on the
    tensor cores, fp32 67), on separate units: the larger; against the
    bytes of dU's lower tiles and P read and dP written, in hi."""
    import torch
    hi, lo, _ = pair
    if lo == hi:  # all-hi: every tile is in the band
        t = n_t
    peak = {torch.float32: FP32_FLOPS, torch.float64: FP64_TC_FLOPS,
            torch.bfloat16: BF16_FLOPS}
    band_f, off_f = syrk_grad_flops(n_t, nb, t)
    ops_s = max(band_f / peak[hi], off_f / peak[lo])
    size = torch.finfo(hi).bits // 8
    bytes_s = (n_t * (n_t + 1) // 2 * nb * nb + 2 * n_t * nb * nb) * size \
        / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def syrk_grad_library_ms(g, p, nb, t, pair):
    """The yardstick: torch.matmul over the same S and P blocks in the same
    precisions, per tile row its band slab in hi and its two off-band slabs
    in lo (bf16 products summed in fp32 by cuBLAS, or IEEE fp32), S = L(dU)
    + L(dU)^T built beforehand in g's place (g is overwritten)."""
    import torch
    hi, lo, _ = pair
    m = p.shape[0]
    n_t = m // nb
    t = n_t if lo == hi else t
    s = g
    for i in range(n_t):  # S in place: each lower tile row and its mirror
        r0, r1 = i * nb, (i + 1) * nb
        s[r0:r1, r1:] = s[r1:, r0:r1].T
        s[r0:r1, r0:r1] = s[r0:r1, r0:r1] + s[r0:r1, r0:r1].T
    s_lo, p_lo = (s.to(lo), p.to(lo)) if lo != hi else (None, None)

    def run():
        for i in range(n_t):
            rows = slice(i * nb, (i + 1) * nb)
            b0, b1 = max(0, i - t + 1) * nb, min(n_t, i + t) * nb
            torch.matmul(s[rows, b0:b1], p[b0:b1])
            if b0:
                torch.matmul(s_lo[rows, :b0], p_lo[:b0])
            if b1 < m:
                torch.matmul(s_lo[rows, b1:], p_lo[b1:])
    return time_ms(run)


# kernel against plain version, per element of dP, in two parts.  The
# band: its hi sums in other orders, as a fraction of the band's own scale
# |S_band| |P| (fp32 measured 5e-7 at 39,936 all-hi rows; a bf16 or TF32
# band is off by ~1e-4 of it, an fp32 band in place of fp64 by ~1e-7).
# The off-band: its fp32 (all-fp64: fp64) sums in other orders, as a
# fraction of its own scale |lo(S_off)| |lo(P)|, each then rounded once to
# lo, which may round the other way: one lo ulp of the off-band value
SYRK_GRAD_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-13}
# (hi, lo) -> the row of mp_syrk_grad in the kernels line
SYRK_GRAD_ROWS = {("torch.float32", "torch.bfloat16"): "mp_syrk_grad",
                  ("torch.float64", "torch.float32"): "mp_syrk_grad_fp64"}


def _ulp(x, bits):
    """One ulp of x >= 0 at `bits` significant bits (x in fp64)."""
    import torch
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - bits)


def syrk_grad_err(got, want, g, p, nb, t, pair):
    """(max |got - want| / tol, max abs err) over dP = mp_syrk_grad(g, p)
    with tile nb, band t under pair (hi, lo, accum), one tile row at a time
    in fp64.  Per element tol = SYRK_GRAD_TOL[hi] |S_band| |P| for the band
    (with lo = hi every tile: one sum), plus for the off-band e = SYRK_GRAD_
    TOL[accum] |lo(S_off)| |lo(P)| twice and one lo ulp of |off| + e, off
    its exact value, plus one hi ulp of |dP| twice (the two parts' sum)."""
    import torch
    hi, lo, accum = pair
    f64 = torch.float64
    m = p.shape[0]
    n_t = m // nb
    t = n_t if lo == hi else t
    bits = {torch.bfloat16: 8, torch.float32: 24, torch.float64: 53}
    p_hi, p_lo = p.to(f64).abs(), p.to(lo).to(f64)
    ratio, mx = 0.0, 0.0
    for i in range(n_t):
        r0, r1 = i * nb, (i + 1) * nb
        diag = g[r0:r1, r0:r1]
        s = torch.cat([g[r0:r1, :r0], diag + diag.T, g[r1:, r0:r1].T], dim=1)
        b0, b1 = max(0, i - t + 1) * nb, min(n_t, i + t) * nb
        tol = SYRK_GRAD_TOL[str(hi)] * (s[:, b0:b1].to(f64).abs()
                                        @ p_hi[b0:b1])
        if b1 - b0 < m:
            s_off = s.to(lo).to(f64)
            s_off[:, b0:b1] = 0
            e = SYRK_GRAD_TOL[str(accum)] * (s_off.abs() @ p_lo.abs())
            tol += 2 * e + _ulp((s_off @ p_lo).abs() + e, bits[lo])
            del s_off, e
        w = want[r0:r1].to(f64)
        tol += 2 * _ulp(w.abs(), bits[hi])
        d = (got[r0:r1].to(f64) - w).abs()
        ratio = max(ratio, float((d / tol).max()))
        mx = max(mx, float(d.max()))
    return ratio, mx


def band_only(g, nb, t):
    """g with every tile at distance >= t from the diagonal set to zero, in
    place: a dU whose dP is the band's alone."""
    n_t = g.shape[0] // nb
    for i in range(n_t):
        r0, r1 = i * nb, (i + 1) * nb
        g[r0:r1, :max(0, i - t + 1) * nb] = 0
        g[r0:r1, min(n_t, i + t) * nb:] = 0
    return g


# 10.3 (a)'s small shapes: (m, tile, kdim) giving the engines' four block
# shapes (bm, bn) = (64, 64), (128, 64), (64, 128), (128, 128)
SYRK_GRAD_BLOCK_SHAPES = ((768, 64, 192), (1_280, 128, 192), (768, 64, 256),
                          (1_280, 128, 128))


def check_syrk_grad_blocks():
    """mp_syrk_grad at small shapes that take each block shape of its
    engines (the main path takes 128 x 128), the four pairs at band 1 and
    3: within syrk_grad_err's tolerance, the same bits on a second launch
    and with dU's upper tiles zeroed."""
    import torch
    from repro_torch.kernels.mp_gemm import ops, ref
    from repro_torch.kernels.mp_gemm.mp_gemm import PAIRS
    gen = torch.Generator(device="cuda").manual_seed(21)
    for m, tile, kdim in SYRK_GRAD_BLOCK_SHAPES:
        worst = 0.0
        for pair in PAIRS:
            for t in (1, 3):
                kw = dict(tile=tile, band_blocks=t, hi=pair[0], lo=pair[1],
                          accum=pair[2])
                p = torch.randn((m, kdim), generator=gen, device="cuda",
                                dtype=pair[0])
                g = torch.randn((m, m), generator=gen, device="cuda",
                                dtype=pair[0])
                got = ops.mp_syrk_grad(g, p, **kw)
                lower = torch.arange(m, device="cuda") // tile
                g_low = torch.where(lower[:, None] >= lower[None, :], g, 0)
                ratio, _ = syrk_grad_err(got, ref.mp_syrk_grad(g, p, **kw), g,
                                         p, tile, t, pair)
                require(torch.equal(got, ops.mp_syrk_grad(g, p, **kw))
                        and torch.equal(got, ops.mp_syrk_grad(g_low, p, **kw))
                        and ratio <= 1.0,
                        f"mp_syrk_grad {pair} m={m} tile={tile} kdim={kdim} "
                        f"band {t}: {ratio} of the tolerance, or its bits moved")
                worst = max(worst, ratio)
        emit(phase="gradient", step="kernel", kernel="mp_syrk_grad",
             launch="block shape", m=m, tile=tile, kdim=kdim,
             block=[64 if tile % 128 else 128, 64 if kdim % 128 else 128],
             bands=[1, 3], err_over_tol=worst)


def check_syrk_grad(gcfg, results):
    """10.3 (a): mp_syrk_grad against its plain version on the card for the
    forward's four pairs at (4,096, nb) and at the tile path's step 0 ((p -
    1) nb, nb), tile nb, band 2, within syrk_grad_err's tolerance: dU
    random in every tile (its upper tiles must be ignored: the same bits
    with them zeroed), a second launch the same bits; at step 0 the kernel,
    plain version and yardstick timed beside the bound; then a dU that is
    zero off the band, where dP is the band's alone, with a control: the
    plain version with that band in lo (band_blocks = 0) must fail the same
    check; then Potrf's backward (torch ops) at B = 1 and 3.  First the
    engines' other block shapes at small sizes (check_syrk_grad_blocks)."""
    import torch
    from repro_torch.kernels.blocked_potrf import ops as potrf_ops
    from repro_torch.kernels.mp_gemm import ops, ref
    from repro_torch.kernels.mp_gemm.mp_gemm import PAIRS
    check_syrk_grad_blocks()
    nb, n_obs = gcfg["tile_nb"], gcfg["tile_n"]
    gen = torch.Generator(device="cuda").manual_seed(20)
    t = 2
    for pair in PAIRS:
        hi, lo, accum = pair
        kw = dict(tile=nb, band_blocks=t, hi=hi, lo=lo, accum=accum)
        worst, main = 0.0, None
        for m in dict.fromkeys((min(4_096, n_obs - nb), n_obs - nb)):
            p = torch.randn((m, nb), generator=gen, device="cuda", dtype=hi)
            g = torch.randn((m, m), generator=gen, device="cuda", dtype=hi)
            got = ops.mp_syrk_grad(g, p, **kw)
            require(torch.equal(got, ops.mp_syrk_grad(g, p, **kw)),
                    f"mp_syrk_grad {pair} m={m}: two runs differ")
            lower = (torch.arange(m, device="cuda") // nb)
            g_low = torch.where(lower[:, None] >= lower[None, :], g, 0)
            require(torch.equal(got, ops.mp_syrk_grad(g_low, p, **kw)),
                    f"mp_syrk_grad {pair} m={m}: reads dU's upper tiles")
            del g_low
            want = ref.mp_syrk_grad(g, p, **kw)
            ratio, mx = syrk_grad_err(got, want, g, p, nb, t, pair)
            require(got.dtype == hi and ratio <= 1.0,
                    f"mp_syrk_grad {pair} m={m}: {ratio} of the tolerance")
            worst = max(worst, mx)
            line = dict(pair=[str(d) for d in pair], m=m, k=nb, tile=nb,
                        band=t, max_abs_err=mx, err_over_tol=ratio,
                        tol_band=SYRK_GRAD_TOL[str(hi)],
                        tol_offband=SYRK_GRAD_TOL[str(accum)])
            del got, want
            if m == n_obs - nb:
                n_t = m // nb
                band_f, off_f = syrk_grad_flops(n_t, nb, n_t if lo == hi else t)
                line["ms"] = time_ms(lambda: ops.mp_syrk_grad(g, p, **kw))
                # each class's device time, where the profiler gives it: a
                # trace of this library's launches alone can come back
                # empty late in a run (device_profile), so the call ends in
                # a PyTorch reduction, which no class counts
                try:
                    _, _, rows = device_profile(
                        lambda: ops.mp_syrk_grad(g, p, **kw).sum())
                    line["class_ms"], line["device_ms"] = syrk_grad_device_ms(rows)
                except AssertionError:  # no device events: not measured
                    line["class_ms"] = line["device_ms"] = None
                line["plain_ms"] = time_ms(lambda: ref.mp_syrk_grad(g, p, **kw),
                                           reps=2)
                line["bound_ms"], line["bound_by"] = syrk_grad_bound(n_t, nb, t,
                                                                     pair)
                line.update(band_gflop=band_f / 1e9, offband_gflop=off_f / 1e9,
                            tflops=(band_f + off_f) / line["ms"] / 1e9)
                line["library_ms"] = syrk_grad_library_ms(g, p, nb, t, pair)
                main = line
            # the band alone (g is random, or S after the yardstick)
            g = band_only(g, nb, t)
            want = ref.mp_syrk_grad(g, p, **kw)
            ratio, _ = syrk_grad_err(ops.mp_syrk_grad(g, p, **kw), want, g, p,
                                     nb, t, pair)
            require(ratio <= 1.0, f"mp_syrk_grad {pair} m={m}: band alone "
                    f"{ratio} of the tolerance")
            line["band_only_err_over_tol"] = ratio
            if lo != hi:
                lo_band = ref.mp_syrk_grad(g, p, **dict(kw, band_blocks=0))
                ctrl, _ = syrk_grad_err(lo_band, want, g, p, nb, t, pair)
                require(ctrl > 1.0, f"mp_syrk_grad {pair} m={m}: a band in lo "
                        f"passes the check ({ctrl} of the tolerance)")
                line["lo_band_control_err_over_tol"] = ctrl
                del lo_band
            del g, p, want
            torch.cuda.empty_cache()
            emit(phase="gradient", step="kernel", kernel="mp_syrk_grad", **line)
        # the kernels line: the two pairs of the path, (fp32, bf16) and the
        # paper's (fp64, fp32); the all-hi pairs are in the lines above
        key = SYRK_GRAD_ROWS.get((str(hi), str(lo)))
        if key:
            results.setdefault(key, {}).update(
                name=key.replace("_fp64", " (fp64, fp32)"), route="cuda",
                source="src/repro_torch/csrc/mp_syrk.cu",
                replaces="src/repro/kernels/mp_gemm/mp_gemm.py:52",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"])
    # Potrf's backward: torch ops on the factor, no kernel of its own
    for dtype in (torch.float32, torch.float64):
        for batch in (1, 3):
            a = spd_batch(gen, batch, nb).to(dtype)
            l = torch.linalg.cholesky(a)
            gl = torch.randn(l.shape, generator=gen, device="cuda", dtype=dtype)
            ms = time_ms(lambda: potrf_ops.cholesky_backward(gl, l))
            flops = batch * 2 * nb ** 3  # the product and two solves
            emit(phase="gradient", step="kernel", kernel="Potrf backward",
                 dtype=str(dtype), batch=batch, nb=nb, ms=ms,
                 tflops=flops / ms / 1e9)
            del a, l, gl


# a tile-path value-and-gradient evaluation, kernel path against plain
# path, by policy: (|ll| relative, each gradient component's gap over its
# scale s_k = sum |G| dSigma/dtheta_k, G = dl/dSigma, the terms the
# gradient sums; ROADMAP C 13).  The log-likelihood's are phases 8.1's and
# 9.1's; the gradient's were measured 1.6e-6 (tpu(2)) and 2.1e-11
# (paper_cpu(2)) at n_obs = 5,120, nb = 128, and 1.7e-7 (tpu(2)) at 40,960:
# a bf16 rounding that flips between the paths moves tpu(2)'s gradient by
# up to 12 % of its own size there, since it is a small difference of
# terms of size s_k.  full(fp32) through the tiles has no such rounding
# (measured 1.8e-10 and 6.9e-11 at 40,960, ll 1.9e-7): its 1e-8 of s_k,
# 0.26 and 16.4 against a gradient of (-38.4, 873.6), fails a zero or
# wrong-signed gradient through blocked_potrf, Potrf's backward and the
# all-fp32 mp_syrk_grad
TILE_GRAD_TOL = {"tpu(2)": (1e-3, 1e-5), "full(fp32)": (1e-5, 1e-8),
                 "paper_cpu(2)": (1e-5, 1e-8)}


def _grad_scale(locs, z, pol, theta, nb, metric="euclidean"):
    """s_k = sum |G| dSigma/dtheta_k for k = 1, 2, with G = dl/dSigma of the
    kernel path's tile engine at theta (as make_loglik builds Sigma).  G is
    taken by a hook during the backward, which frees Sigma as the
    evaluation does: kept as a leaf for autograd.grad, it added 12.5 GiB to
    the pair's backward at 40,960, and 10.3 run alone ran out of memory.
    The hook is on a view of Sigma: on Sigma itself, whose last op is the
    jitter's in-place add on its diagonal, PyTorch 2.13 (CPU) crashed."""
    import torch
    from repro_torch.core import (build_covariance, loglik_from_factor,
                                  tile_cholesky)
    from repro_torch.kernels.matern_cov import ops
    th = torch.tensor([float(v) for v in theta], requires_grad=True,
                      dtype=torch.promote_types(locs.dtype, torch.float32))
    th_host = th.tolist()
    scale = []
    cov = build_covariance(locs, th, nu_static=0.5, metric=metric,
                           jitter=1e-6, dtype=pol.hi).view(-1, locs.shape[0])
    cov.register_hook(lambda g: scale.append(ops.matern_cov_grad(
        locs, locs, th_host, g.abs(), nu=0.5, metric=metric).tolist()))
    ll = loglik_from_factor(tile_cholesky(cov, nb, pol), z)
    del cov
    torch.autograd.grad(ll, th)
    return scale[0]


def tile_grad_evaluation(label, locs, z, pol, theta, nb, results, key):
    """10.3 (b): one value-and-gradient evaluation through the tile engine at
    theta, through the kernels (after one warm-up) and through the plain
    versions: exact launch counts, the log-likelihood equal to the no-grad
    one bit for bit, gradients finite and kernel against plain within
    TILE_GRAD_TOL, seconds forward and backward, peak, and the kernel path
    under the profiler."""
    import torch
    from repro_torch.core import make_loglik
    p = locs.shape[0] // nb
    expected = tile_grad_launches(p, pol.hi == torch.float32)
    out = {}
    for impl in ("kernel", "plain"):
        fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5, use_tiles=True,
                         impl=impl)
        if impl == "kernel":  # a warm-up: the first maps the allocator's memory
            _value_and_grad(fn, theta)
        out[impl] = _value_and_grad(fn, theta)
    (a, ga, fa, ba, pa, ca), (b, gb, fb, bb, pb, cb) = out["kernel"], out["plain"]
    require(ca == expected, f"{label}: launches {ca}, expected {expected}")
    require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
    fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5, use_tiles=True)
    with torch.no_grad():  # the same fp32 theta, no autograd
        no_grad = float(fn(torch.tensor(theta, dtype=torch.float32)))
    require(a == no_grad, f"{label}: ll {a} with grad, {no_grad} without")
    scale = _grad_scale(locs, z, pol, theta, nb)
    ll_tol, tol = TILE_GRAD_TOL[label]
    gap = [abs(x - y) / s for x, y, s in zip(ga, gb, scale)]
    require(math.isfinite(a) and all(map(math.isfinite, ga)) and ga[2] == 0.0
            and abs(a - b) <= ll_tol * abs(b) and max(gap) <= tol,
            f"{label}: kernel {a} {ga} vs plain {b} {gb}, gap {gap} of {scale}")
    wall_ms, busy, rows = device_profile(lambda: _value_and_grad(fn, theta))
    grad_class_ms, grad_ms = syrk_grad_device_ms(rows)
    emit(phase="gradient", step="tile evaluation", policy=label,
         n=locs.shape[0], nb=nb, theta=list(theta), loglik_kernel=a,
         loglik_plain=b, loglik_no_grad=no_grad, grad_kernel=ga,
         grad_plain=gb, grad_scale=scale, grad_gap_over_scale=gap,
         grad_err_over_max=max(abs(x - y) for x, y in zip(ga, gb))
         / max(abs(v) for v in gb), tol=tol, loglik_tol=ll_tol,
         seconds_forward_kernel=fa,
         seconds_backward_kernel=ba, seconds_forward_plain=fb,
         seconds_backward_plain=bb, peak_gib_kernel=pa, peak_gib_plain=pb,
         launches_kernel=ca, wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1 - busy / wall_ms,
         mp_syrk_grad_device_ms=grad_ms, mp_syrk_grad_class_ms=grad_class_ms,
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:12]])
    if key:
        results.setdefault(key, {})["launches"] = ca["mp_syrk_grad"]
    return dict(ll=a, grad=ga, scale=scale, seconds=fa + ba, peak=pa)


def tile_gradient(gcfg, weak, fp64_field, n64, results):
    """10.3 (b): tpu(2) and tiled full(fp32) on phase 8's weak field (fp32)
    and paper_cpu(2) on phase 9's fp64 field at tile_n, nb = tile_nb; the
    pair's n cut to a multiple of 1,024 if its predicted peak (twice
    tpu(2)'s, scaled by n^2) passes peak_gib; its gradient against dense full(fp64)'s at the same
    theta and n (10.1's fp64 n where that is smaller)."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    nb, n = gcfg["tile_nb"], gcfg["tile_n"]
    (locs, z), (locs64, z64) = weak, fp64_field
    locs, z = locs[:n].contiguous(), z[:n].contiguous()
    tpu = tile_grad_evaluation("tpu(2)", locs, z, PrecisionPolicy.tpu(2), WEAK,
                               nb, results, "mp_syrk_grad")
    torch.cuda.empty_cache()
    tile_grad_evaluation("full(fp32)", locs, z,
                         PrecisionPolicy.full(torch.float32), WEAK, nb,
                         results, None)
    torch.cuda.empty_cache()
    n_pair = fp64_grad_n(n, tpu["peak"], gcfg["peak_gib"])
    emit(phase="gradient", step="paper pair size", n_obs=n, n=n_pair,
         peak_gib_tpu2=tpu["peak"], predicted_peak_gib=2 * tpu["peak"] * (
             n_pair / n) ** 2, limit_gib=gcfg["peak_gib"])
    pol = PrecisionPolicy.paper_cpu(2)
    pair = tile_grad_evaluation("paper_cpu(2)", locs64[:n_pair].contiguous(),
                                z64[:n_pair].contiguous(), pol, MEDIUM, nb,
                                results, "mp_syrk_grad_fp64")
    require(pair["peak"] <= gcfg["peak_gib"] + 1,
            f"paper_cpu(2) peak {pair['peak']} GiB")
    # against dense full(fp64) at the same theta and n
    n_cmp = min(n_pair, n64)
    lc, zc = locs64[:n_cmp].contiguous(), z64[:n_cmp].contiguous()
    if n_cmp != n_pair:
        grad = _value_and_grad(make_loglik(lc, zc, pol, nb=nb, nu_static=0.5),
                               MEDIUM)[1]
    else:
        grad = pair["grad"]
    torch.cuda.empty_cache()
    dense = _value_and_grad(make_loglik(lc, zc, PrecisionPolicy.full(
        torch.float64), nu_static=0.5), MEDIUM)[1]
    torch.cuda.empty_cache()
    emit(phase="gradient", step="paper pair vs full(fp64)", n=n_cmp,
         theta=list(MEDIUM), grad_paper=grad, grad_full_fp64=dense,
         rel_gap=[abs(x - y) / abs(y) for x, y in zip(grad[:2], dense[:2])],
         gap_over_scale=[abs(x - y) / s for x, y, s in zip(
             grad, dense, pair["scale"])] if n_cmp == n_pair else None)
    return tpu["seconds"], pair["seconds"]


def tile_grad_adam(gcfg):
    """10.3 (c): fit_mle_adam through the tiles under the paper pair (120
    steps at lr 0.05 from 0.8 theta0) at n = adam_n, nb = tile_nb, on phase
    6's field in fp64, against fit_mle on the same likelihood: theta2-hat
    within rel 0.1 (tests/test_mle_kriging.py:66)."""
    import torch
    from repro_torch.core import (PrecisionPolicy, fit_mle, fit_mle_adam,
                                  make_loglik)
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nb, steps = gcfg["tile_nb"], gcfg["adam_steps"]
    gen = torch.Generator(device="cuda").manual_seed(1)  # phase 6's field
    ds = make_dataset(gen, gcfg["adam_n"], MEDIUM, nu_static=0.5)
    locs, z = ds.locs.double(), ds.z.double()
    p = locs.shape[0] // nb
    ll = make_loglik(locs, z, PrecisionPolicy.paper_cpu(2), nb=nb,
                     nu_static=0.5)
    nu = torch.tensor([0.5])
    start = [0.8 * MEDIUM[0], 0.8 * MEDIUM[1]]
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_mle_adam(lambda th: ll(torch.cat([th, nu])), start, steps=steps,
                       lr=gcfg["adam_lr"])
    adam_s = time.perf_counter() - t0
    counts = launch_counts()
    # each step one evaluation and its gradient, then one final evaluation
    require(counts["mp_syrk_grad"] == steps * (p - 1)
            and counts["mp_syrk"] == (steps + 1) * (p - 1)
            and counts["matern_cov_grad"] == steps
            and counts["blocked_potrf"] == 0, f"tile Adam launches {counts}")
    t0 = time.perf_counter()
    nm = fit_mle(lambda th: ll([th[0], th[1], 0.5]), start,
                 max_iters=gcfg["nm_iters"])
    nm_s = time.perf_counter() - t0
    rel = abs(float(res.theta[1]) - nm.theta[1]) / nm.theta[1]
    require(math.isfinite(res.loglik) and rel <= 0.1,
            f"tile Adam theta2 {res.theta[1]} vs Nelder-Mead {nm.theta[1]}")
    emit(phase="gradient", step="tile adam", policy="paper_cpu(2)",
         n=locs.shape[0], nb=nb, start=start, steps=steps, lr=gcfg["adam_lr"],
         theta_adam=res.theta.tolist(), loglik_adam=res.loglik,
         history=[(h[0].tolist(), h[1]) for h in res.history],
         seconds_adam=adam_s, seconds_per_step=adam_s / steps,
         theta_nm=nm.theta.tolist(), loglik_nm=nm.loglik, nm_evals=nm.n_evals,
         seconds_nm=nm_s, theta2_rel_gap=rel, tol=0.1, launches_adam=counts)


def gradient(gcfg, weak, fp64_field, results):
    """Phase 10: the gradient path on the card (see the module docstring),
    sub-steps timed into one phase line."""
    import torch
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    (locs, z), (locs64, z64) = weak, fp64_field
    step("10.0 kernel", check_matern_grad,
         [(torch.float32, locs, list(WEAK[:2])),
          (torch.float64, locs64, list(MEDIUM[:2]))], gcfg, results)
    t_eval, peak32 = step("10.1 full(fp32)", gradient_evaluation, "full(fp32)",
                          locs, z, WEAK, results, "matern_cov_grad")
    n64 = fp64_grad_n(locs64.shape[0], peak32, gcfg["peak_gib"])
    emit(phase="gradient", step="fp64 size", n_obs=locs64.shape[0], n=n64,
         peak_gib_fp32=peak32, predicted_peak_gib_fp64=2 * peak32 * (
             n64 / locs64.shape[0]) ** 2, limit_gib=gcfg["peak_gib"])
    _, peak64 = step("10.1 full(fp64)", gradient_evaluation, "full(fp64)",
                     locs64[:n64].contiguous(), z64[:n64].contiguous(), MEDIUM,
                     results, "matern_cov_grad_fp64")
    require(peak64 <= gcfg["peak_gib"] + 1, f"full(fp64) peak {peak64} GiB")
    step("10.2 Adam", gradient_adam, gcfg, locs, z, t_eval)
    step("10.3a mp_syrk_grad", check_syrk_grad, gcfg, results)
    step("10.3b tile gradient", tile_gradient, gcfg, weak, fp64_field, n64,
         results)
    step("10.3c tile Adam", tile_grad_adam, gcfg)
    emit(phase="gradient", step="seconds", **secs)


# ---------------------------------------------------------------------------
# phase 11: the accuracy sweep (repro_torch.verify) on the card
# ---------------------------------------------------------------------------

def scale_n(n, nb, limit_gib):
    """n, or the largest multiple of nb below it whose predicted peak
    (`scale_peak_bytes`) stays under limit_gib."""
    while n > nb and plan().scale_peak_bytes(n, nb) / 2**30 > limit_gib:
        n -= nb
    return n


def _finite(rec, names=("factor_rel", "backward_rel", "loglik_drift")):
    return all(math.isfinite(rec[k]) for k in names)


def scale_failures(records, pair_drift):
    """Phase 11 (b)'s requires over the scale leg's records: full(fp32) and
    the paper pair finite, the pair's loglik_drift <= pair_drift, and DST's
    factor_rel above 10x the mixed record's where that one is finite.  A
    bf16 NaN and a registry bound passed at this n are reported, not
    gated."""
    recs = {r["id"]: r for r in records}
    names = sorted({r["id"].rsplit("/", 1)[1] for r in records})
    out = []
    for name in names:
        full = recs[f"chol/tile/full_f32/{name}"]
        pair = recs[f"chol/tile/paper_f64f32_t2/{name}"]
        mixed = recs[f"chol/tile/mixed_f32bf16_t2/{name}"]
        dst = recs[f"chol/dst/t2/{name}"]
        for rec in (full, pair):
            if not _finite(rec):
                out.append(f"{rec['id']} is not finite: {rec}")
        if not pair["loglik_drift"] <= pair_drift:
            out.append(f"{pair['id']}: loglik_drift {pair['loglik_drift']} "
                       f"> {pair_drift}")
        if _finite(mixed) and not dst["factor_rel"] > 10 * mixed["factor_rel"]:
            out.append(f"{name}: DST factor_rel {dst['factor_rel']} not above "
                       f"10x the mixed record's {mixed['factor_rel']}")
    return out


def _record_line(rec, step):
    """One JSON line of a record: its metrics, its registered bound and
    whether it is within it."""
    import dataclasses
    from repro_torch.verify.conformance import record_bound
    bound = record_bound(rec)
    viol = bound.violations(rec)
    emit(phase="accuracy", step=step, **rec,
         bound={k: v for k, v in dataclasses.asdict(bound).items()
                if v is not None},
         within_registry=not viol, violations=viol)


def unshared_violations(records, plain_records, slack=2.0):
    """The registry violations of the kernel path that its plain twin (the
    same record through the plain versions, on the same problem) does not
    share: (id, metric, value, bound, plain value).  A metric past its
    bound is shared where the plain record's is non-finite too, or, where
    it is finite, where the plain record's is at least bound / slack (the
    golden gate's slack: a rounding flip moves a bf16 metric that far).
    Such a violation is the policy's on that problem, not the kernels'."""
    import dataclasses
    from repro_torch.verify.conformance import record_bound
    plain = {r["id"]: r for r in plain_records}
    out = []
    for rec in records:
        bound = record_bound(rec)
        for f in dataclasses.fields(bound):
            limit, value = getattr(bound, f.name), rec.get(f.name)
            if limit is None or value is None or value <= limit:
                continue
            twin = plain.get(rec["id"], {}).get(f.name)
            shared = twin is not None and (
                not math.isfinite(twin) if not math.isfinite(value)
                else not twin < limit / slack)
            if not shared:
                out.append((rec["id"], f.name, value, limit, twin))
    return out


def accuracy_grid(results):
    """11 (a): the conformance sweep on the card through the kernels, on
    CARD_SIZES at CARD_NB (p in {2, 4, 6}), then its Cholesky and kriging
    records again through the plain versions: every registry violation
    shared by the plain twin (`unshared_violations`), the paper's four
    claims, no drift from golden/accuracy_cuda.json, and each of the four
    kernels launched."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.verify import (check_records, claim_failures,
                                    compare_to_golden, load_golden,
                                    sweep_cholesky, sweep_kernels,
                                    sweep_kriging)
    from repro_torch.verify.golden import device_grid
    reset_launch_counts()
    problems = device_grid("cuda")
    records = sweep_cholesky(problems, device="cuda")
    records += sweep_kriging(problems, device="cuda")
    records += sweep_kernels("cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    plain = (sweep_cholesky(problems, impl="plain", device="cuda")
             + sweep_kriging(problems, impl="plain", device="cuda"))
    for rec in records:
        _record_line(rec, "grid")
    violations = check_records(records)
    unshared = unshared_violations(records, plain)
    claims = claim_failures(records, problems)
    drifts = compare_to_golden(records, load_golden(device="cuda"))
    kernels = ("matern_cov", "blocked_potrf", "mp_syrk", "mp_attention")
    emit(phase="accuracy", step="grid summary", records=len(records),
         problems=[p.name for p in problems], nb=problems[0].nb,
         launches=counts, violations=violations,
         plain_violations=check_records(plain), unshared=unshared,
         claims=claims, drifts=drifts)
    for k in kernels:
        results[k]["launches_accuracy"] = counts[k]
    require(all(counts[k] > 0 for k in kernels),
            f"phase 11 (a) did not launch every kernel: {counts}")
    require(len(records) == 126 and not unshared and not claims and not drifts,
            f"phase 11 (a): {len(records)} records, violations the plain "
            f"path does not share {unshared}, claims {claims}, drifts {drifts}")


def accuracy_scale(scfg):
    """11 (b): tiled full(fp32), the paper pair, {fp32, bf16} t = 2 and DST
    t = 2 against the fp64 oracle of the same fp32 Sigma, on
    matern_problem(n, regime, nb) at the paper's estimation sizes; n cut
    to a multiple of nb if its predicted peak passes peak_gib."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.verify import matern_problem, sweep_cholesky
    policies = {"full_f32": PrecisionPolicy.full(torch.float32),
                "mixed_f32bf16_t2": PrecisionPolicy.tpu(2)}
    nb, records = scfg["nb"], []
    for n in scfg["sizes"]:
        n_run = scale_n(n, nb, scfg["peak_gib"])
        for regime in scfg["regimes"]:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            prob = matern_problem(n_run, regime, nb=nb, device="cuda")
            recs = sweep_cholesky([prob], policies, panel=False, device="cuda")
            torch.cuda.synchronize()
            del prob
            for rec in recs:
                _record_line(rec, "scale")
            emit(phase="accuracy", step="scale problem", n=n, n_run=n_run,
                 regime=regime, nb=nb, seconds=time.perf_counter() - t0,
                 predicted_peak_gib=plan().scale_peak_bytes(n_run, nb) / 2**30,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 limit_gib=scfg["peak_gib"])
            records += recs
    drift = {r["id"]: r["loglik_drift"] for r in records
             if r["id"].startswith("chol/tile/paper_f64f32_t2/")}
    emit(phase="accuracy", step="paper pair drift by n", loglik_drift=drift,
         registered=PAPER_LOGLIK_DRIFT, limit=scfg["pair_drift"])
    failures = scale_failures(records, scfg["pair_drift"])
    require(not failures, f"phase 11 (b): {failures}")


def accuracy(scfg, results):
    """Phase 11: the port's accuracy harness on the card (see the module
    docstring), sub-steps timed into one phase line."""
    import torch
    secs = {}
    for name, fn, args in (("11a grid", accuracy_grid, (results,)),
                           ("11b scale", accuracy_scale, (scfg,))):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    emit(phase="accuracy", step="seconds", **secs)


# ---------------------------------------------------------------------------
# phase 12: the dynamic task runtime (repro_torch.sched) on CUDA streams
# ---------------------------------------------------------------------------

RUNTIME_SCHEDULES = (("fifo W=1", dict(priority="fifo", workers=1)),
                     ("critical_path W=4", dict(priority="critical_path",
                                                workers=4)),
                     ("panel_first W=3 seed 7", dict(priority="panel_first",
                                                     workers=3, seed=7)))


def sequential_factor(variant, a, nb, pol):
    """The port's sequential engine of `variant` on `a`: the dense lower
    factor (in hi) that the runtime's store of the same variant assembles
    to."""
    import torch
    from repro_torch.core import (assemble_from_banded, dst_assemble,
                                  dst_cholesky, panel_cholesky_banded,
                                  tile_cholesky)
    n = a.shape[-1]
    if variant == "tile":
        return tile_cholesky(a, nb, pol)
    if variant == "dst":
        return dst_assemble(dst_cholesky(a, nb, pol.diag_thick, hi=pol.hi), n,
                            pol.hi)
    p = n // nb
    t = min(pol.diag_thick, p)
    lo = pol.lo if pol.mode != "full" else pol.hi
    band = torch.zeros((p, t, nb, nb), dtype=pol.hi, device=a.device)
    off = torch.zeros((p, p, nb, nb), dtype=lo, device=a.device)
    for i in range(p):
        for j in range(i + 1):
            x = a[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            if i - j < t:
                band[i, i - j] = x
            else:
                off[i, j] = x
    band, off, _ = panel_cholesky_banded(band, off, pol)
    return assemble_from_banded(band, off, t)


PROFILE_PAD_S = 0.3   # idle before and after the profiled call


def union_ms(spans) -> float:
    """Total length of the union of (start, end) spans, in ms from us."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def stream_profile(fn, keep_rows=False) -> dict:
    """fn() under torch.profiler's CUDA activity: wall ms, the device's
    busy ms (the union of its kernel and copy intervals over every stream),
    their sum, the host's ms in CUDA runtime calls, the idle share and the
    top kernels by device time (with keep_rows, every kernel's).  Reads
    the profiler's raw events: building its FunctionEvents for ~10^5
    launches takes longer than the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        time.sleep(PROFILE_PAD_S)
    spans, per_kernel, host_ns = [], {}, 0
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            spans.append((start / 1e3, (start + dur) / 1e3))
            count, ms = per_kernel.get(e.name(), (0, 0.0))
            per_kernel[e.name()] = (count + 1, ms + dur / 1e6)
        else:
            host_ns += dur
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    busy = union_ms(spans)
    out = dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
               device_kernel_sum_ms=sum(ms for _, (_, ms) in rows),
               host_cuda_api_ms=host_ns / 1e6, device_events=len(spans),
               top=[{"name": k[:90], "count": c, "ms": ms}
                    for k, (c, ms) in rows[:12]])
    if keep_rows:  # every kernel as device_profile's rows: (name, count, ms)
        out["rows"] = [(k, c, ms) for k, (c, ms) in rows]
    return out


def _same_bits(x, y):
    import torch
    return x.dtype == y.dtype and x.shape == y.shape and bool(
        ((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def runtime_small(rcfg):
    """12 (a): the three variants under tpu(2) (weak field), full(fp32) and
    paper_cpu(2) (medium field) on the accuracy harness's problems
    (`matern_problem`, fp32 Sigma) at n = small_p * small_nb, through the
    kernels: the same bits under the three schedules, the exact
    blocked_potrf launches (one per POTRF task on an fp32 band, none on
    fp64), a clean happens-before check of the W = 4 report on device
    times, and the factor within the policy's registered factor_rel of
    the sequential engine and of the same schedule with impl="plain";
    the tile variant's critical_path W = 4 run once more through the
    entry point, tile_cholesky(schedule=...), the same bits and
    launches."""
    import torch
    from repro_torch.analysis.concurrency import verify_sched_report
    from repro_torch.analysis.dag import check_dag
    from repro_torch.core import PrecisionPolicy, assemble_lower, tile_cholesky
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sched import SchedConfig, build_graph, scheduled_cholesky
    from repro_torch.verify import matern_problem
    from repro_torch.verify.bounds import policy_bound
    from repro_torch.verify.oracles import rel_frobenius
    p, nb = rcfg["small_p"], rcfg["small_nb"]
    n = p * nb
    cases = (("tpu(2)", PrecisionPolicy.tpu(2), "weak"),
             ("full(fp32)", PrecisionPolicy.full(torch.float32), "medium"),
             ("paper_cpu(2)", PrecisionPolicy.paper_cpu(2), "medium"))
    for label, pol, regime in cases:
        a = matern_problem(n, regime, nb=nb, device="cuda").cov
        tol = policy_bound(pol, regime).factor_rel
        for variant in ("tile", "panel", "dst"):
            graph = build_graph(variant, p, pol)
            potrfs = sum(t.kind == "POTRF" for t in graph.tasks)
            want = potrfs if pol.hi == torch.float32 else 0
            a0 = a.clone()
            factors, counts, hb = [], [], None
            for name, kw in RUNTIME_SCHEDULES:
                torch.cuda.synchronize()
                reset_launch_counts()
                store, rep = scheduled_cholesky(a, nb, pol, SchedConfig(**kw),
                                                variant=variant)
                counts.append(launch_counts())
                factors.append(assemble_lower(store, p, nb, pol.hi))
                check_dag([graph.tasks[i] for i in rep.dispatch_order], p,
                          pol, variant)
                if kw["workers"] == 4:
                    hb = verify_sched_report(rep, atol=HB_ATOL_US)
            hook = True
            if variant == "tile":  # the same run through the entry point
                torch.cuda.synchronize()
                reset_launch_counts()
                l_hook = tile_cholesky(a, nb, pol, schedule=SchedConfig(
                    **RUNTIME_SCHEDULES[1][1]))
                counts.append(launch_counts())
                hook = _same_bits(l_hook, factors[1])
            store, _ = scheduled_cholesky(a, nb, pol, SchedConfig(
                **RUNTIME_SCHEDULES[1][1]), variant=variant, impl="plain")
            plain = assemble_lower(store, p, nb, pol.hi)
            seq = sequential_factor(variant, a, nb, pol)
            same = all(_same_bits(f, factors[0]) for f in factors[1:])
            rel_seq = rel_frobenius(factors[0], seq)
            rel_plain = rel_frobenius(factors[0], plain)
            emit(phase="runtime", step="small", policy=label, variant=variant,
                 regime=regime, n=n, nb=nb, tasks=graph.n,
                 bitwise_across_schedules=same, hook_bitwise=hook,
                 blocked_potrf=[c["blocked_potrf"] for c in counts],
                 expected_blocked_potrf=want, hb_ok=hb.ok,
                 hb_dep_edges=hb.n_dep_edges, factor_rel_sequential=rel_seq,
                 factor_rel_plain=rel_plain, tol=tol,
                 a_unmodified=torch.equal(a, a0))
            others = {k: v for c in counts for k, v in c.items()
                      if k != "blocked_potrf" and v}
            require(same and hook and hb.ok and torch.equal(a, a0)
                    and not others
                    and all(c["blocked_potrf"] == want for c in counts)
                    and rel_seq <= tol and rel_plain <= tol,
                    f"12 (a) {label} {variant}: bitwise {same}, through "
                    f"tile_cholesky {hook}, hb "
                    f"{hb.render()[:400]}, launches {counts} (want {want}), "
                    f"factor_rel {rel_seq} / plain {rel_plain} > {tol}")


def runtime_full(label, pol, locs, z, theta, regime, nb, rcfg, trace_path):
    """12 (b) on one field: the tile variant at n = len(locs) through the
    kernels, fifo W = 1 and critical_path W = 4 (each after one warm-up)
    beside the sequential tile_cholesky on the same Sigma: seconds (host
    clock to a device sync), device makespan, utilization, overlap, tasks
    per second and peak (Sigma plus what the call allocates); each
    schedule's warm-up goes through the entry point,
    tile_cholesky(schedule=...), and must give the timed run's bits and
    launches; the two schedules the same bits, the log-likelihood within
    RUNTIME_LOGLIK_TOL and the factor within the registry's factor_rel of
    the sequential one -- or, where it is not, no farther from the fp64
    oracle of the same Sigma than the larger of factor_rel and the
    sequential factor's own distance: no worse than the engine it stands
    in for --, a clean happens-before check of both reports on device
    times, the exact blocked_potrf launches; with trace_path the W = 4
    report as a Chrome trace and the W = 4 warm-up under the profiler
    (`stream_profile`)."""
    import torch
    from repro_torch.analysis.concurrency import verify_sched_report
    from repro_torch.analysis.dag import check_dag
    from repro_torch.core import loglik_from_factor, tile_cholesky
    from repro_torch.core.likelihood import build_covariance
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sched import (SchedConfig, build_graph, load_and_validate,
                                   scheduled_tile_cholesky, write_trace)
    from repro_torch.verify.bounds import policy_bound
    from repro_torch.verify.oracles import exact_factor, rel_frobenius
    n = locs.shape[0]
    p = n // nb
    sigma = build_covariance(locs, list(theta), nu_static=0.5, jitter=1e-6,
                             dtype=pol.hi)
    sigma_gib = sigma.numel() * sigma.element_size() / 2**30
    graph = build_graph("tile", p, pol)
    want = p if pol.hi == torch.float32 else 0

    def run(fn):  # (out, seconds, peak GiB of Sigma + the call, launches)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        extra = torch.cuda.memory_allocated() / 2**30 - sigma_gib
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (out, secs, torch.cuda.max_memory_allocated() / 2**30 - extra,
                launch_counts())

    tile_cholesky(sigma, nb, pol)  # warm-up
    l_seq, s_seq, peak_seq, c_seq = run(lambda: tile_cholesky(sigma, nb, pol))
    MEASURED.setdefault("12b", {})[label] = dict(n=n, nb=nb, policy=pol,
                                                 seconds=s_seq,
                                                 peak_gib=peak_seq)
    ll_seq = float(loglik_from_factor(l_seq, z))
    tol = policy_bound(pol, regime).factor_rel
    out, first, profile = {}, None, None
    for name, kw in RUNTIME_SCHEDULES[:2]:
        cfg = SchedConfig(**kw)

        def hook_run():  # the warm-up, through the entry point
            return tile_cholesky(sigma, nb, pol, schedule=cfg)
        if kw["workers"] == 4 and trace_path is not None:
            held = []
            reset_launch_counts()
            profile = stream_profile(lambda: held.append(hook_run()))
            l_hook, c_hook = held.pop(), launch_counts()
        else:
            l_hook, _, _, c_hook = run(hook_run)
        if first is not None:  # one factor less held through the timed run
            hook, l_hook = _same_bits(l_hook, first), None
        (l, rep), secs, peak, counts = run(
            lambda: scheduled_tile_cholesky(sigma, nb, pol, cfg))
        t0 = time.perf_counter()
        if l_hook is not None:
            hook = _same_bits(l_hook, l)
        del l_hook
        hook = hook and c_hook == counts
        ll = float(loglik_from_factor(l, z))
        hb = verify_sched_report(rep, atol=HB_ATOL_US)
        check_dag([graph.tasks[i] for i in rep.dispatch_order], p, pol, "tile")
        rel = rel_frobenius(l, l_seq)
        if first is None:
            first, same = l, True
        else:
            same = _same_bits(l, first)
        busy = union_ms([(e.start, e.end) for e in rep.events])
        out[name] = dict(
            seconds=secs, tasks=rep.n_tasks, tasks_per_second=rep.n_tasks / secs,
            makespan_ms=rep.makespan / 1e3, utilization=rep.utilization,
            overlap_fraction=rep.overlap_fraction,
            device_task_busy_ms=busy, peak_gib=peak, loglik=ll,
            loglik_rel=abs(ll - ll_seq) / abs(ll_seq), factor_rel=rel,
            bitwise_equal_fifo=same, hook_bitwise=hook, hook_launches=c_hook,
            hb_ok=hb.ok, hb_dep_edges=hb.n_dep_edges,
            hb_write_pairs=hb.n_write_pairs, launches=counts,
            check_seconds=time.perf_counter() - t0)
        require(hb.ok, f"12 (b) {label} {name}: {hb.render()[:600]}")
        if kw["workers"] == 4 and trace_path is not None:
            write_trace(rep, trace_path)
            trace = load_and_validate(trace_path)
            out[name]["trace"] = str(trace_path.relative_to(ROOT))
            out[name]["trace_events"] = sum(e["ph"] == "X"
                                            for e in trace["traceEvents"])
        del l, rep
    oracle = None
    if any(o["factor_rel"] > tol for o in out.values()):
        exact = exact_factor(sigma)
        oracle = dict(sequential=rel_frobenius(l_seq, exact),
                      scheduled=rel_frobenius(first, exact))
        del exact
    del first, l_seq
    ratio = max(o["peak_gib"] for o in out.values()) / peak_seq
    emit(phase="runtime", step="full", policy=label, n=n, nb=nb, p=p,
         tasks=graph.n, sigma_gib=sigma_gib, sequential=dict(
             seconds=s_seq, peak_gib=peak_seq, loglik=ll_seq, launches=c_seq),
         scheduled=out, peak_ratio=ratio, factor_tol=tol,
         factor_rel_oracle=oracle, loglik_tol=RUNTIME_LOGLIK_TOL[label],
         profile_critical_path_w4=profile)
    w1, w4 = out["fifo W=1"], out["critical_path W=4"]
    no_worse = oracle is not None and \
        oracle["scheduled"] <= max(tol, oracle["sequential"])
    require(w4["bitwise_equal_fifo"] and ratio <= rcfg["peak_ratio"]
            and all(o["hook_bitwise"] for o in (w1, w4))
            and all((o["factor_rel"] <= tol or no_worse) and o["loglik_rel"]
                    <= RUNTIME_LOGLIK_TOL[label]
                    and o["launches"]["blocked_potrf"] == want
                    for o in (w1, w4)),
            f"12 (b) {label}: bitwise {w4['bitwise_equal_fifo']}, through "
            f"tile_cholesky {[o['hook_bitwise'] for o in (w1, w4)]}, peak ratio "
            f"{ratio}, against the oracle {oracle}, {out}")
    return w4["launches"]["blocked_potrf"]


def runtime(rcfg, weak, fp64_field, results):
    """Phase 12: the task runtime on the card (see the module docstring):
    (a) small, every variant; (b) the tile variant at phase 8's and 9's
    n_obs under tpu(2) on the weak field (fp32 Sigma) and paper_cpu(2) on
    the fp64 medium field (fp64 Sigma); sub-steps timed into one line."""
    import torch
    from repro_torch.core import PrecisionPolicy
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    step("12a small", runtime_small, rcfg)
    (locs, z), (locs64, z64) = weak, fp64_field
    trace_dir = ROOT / "chiprun_out"
    trace_dir.mkdir(exist_ok=True)
    launches = step("12b tpu(2)", runtime_full, "tpu(2)",
                    PrecisionPolicy.tpu(2), locs, z, WEAK, "weak", rcfg["nb"],
                    rcfg, trace_dir / "phase12_sched_trace.json")
    step("12b paper_cpu(2)", runtime_full, "paper_cpu(2)",
         PrecisionPolicy.paper_cpu(2), locs64, z64, MEDIUM, "medium",
         rcfg["nb"], rcfg, None)
    results["blocked_potrf"]["launches_sched"] = launches
    emit(phase="runtime", step="seconds", **secs)


# ---------------------------------------------------------------------------
# phase 13: the panel engine's gradient and haversine distance in matern_cov
# ---------------------------------------------------------------------------

def panel_grad_launches(p, t, fp32_band):
    """Launches of one value-and-gradient evaluation through the panel engine
    of p tiles and band t: matern_cov once per band sub-diagonal and once
    for the off-band (the forward's t + 1), matern_cov_grad as often (the
    outer form only where a tile lies t or more off the diagonal),
    blocked_potrf per diagonal tile of an fp32 band (an fp64 band goes to
    cuSOLVER), mp_syrk and mp_syrk_grad once per step."""
    return {"matern_cov": t + 1, "matern_cov_grad": t + (p > t),
            "blocked_potrf": p if fp32_band else 0, "mp_syrk": p - 1,
            "mp_syrk_grad": p - 1, "mp_attention": 0}


def held_on_card():
    """What the process holds on the card, allocated and reserved GiB: ~2.7
    GiB at phase 13's start on an NVIDIA H100 80GB HBM3 (700 W), none of it
    in a tensor that Python holds (a scan of the live tensors found none
    over 0.5 MB)."""
    import torch
    return dict(allocated_gib=torch.cuda.memory_allocated() / 2 ** 30,
                reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)


def panel_grad_n(n, nb, t, hi_bytes, lo_bytes, limit):
    """The largest multiple of nb, at most n, whose panel value-and-gradient
    evaluation is predicted (`panel_grad_peak_gib`) to stay under `limit`."""
    while n > nb and plan().panel_grad_peak_gib(n, nb, t, hi_bytes,
                                                lo_bytes) > limit:
        n -= nb
    return n


class _ScaleRecorder:
    """A stand-in for the matern_cov module in `BandedMaternCov`'s backward:
    each tile-stack backward also runs on |G|, whose sums are the scale
    s_k = sum |G| dSigma/dtheta_k of the gradient's terms (ROADMAP C 13);
    dSigma/dtheta_k >= 0 for both k."""

    def __init__(self, impl):
        self.impl, self.sums = impl, []

    def matern_cov_grad_tiles(self, locs_i, locs_j, theta, g, **kw):
        self.sums.append(self.impl.matern_cov_grad_tiles(
            locs_i, locs_j, theta, g.abs(), **kw))
        return self.impl.matern_cov_grad_tiles(locs_i, locs_j, theta, g, **kw)

    def matern_cov_grad_lower(self, locs_t, theta, g, **kw):
        self.sums.append(self.impl.matern_cov_grad_lower(
            locs_t, theta, g.abs(), **kw))
        return self.impl.matern_cov_grad_lower(locs_t, theta, g, **kw)


def panel_grad_scale(locs, z, pol, theta, nb, nu, metric="euclidean",
                     impl="kernel"):
    """s_k = sum |G| dSigma/dtheta_k for k = 1, 2, G = dl/d(band, off) of
    the panel engine at theta (geostat_loglik_step's own pieces, with
    `_ScaleRecorder` in the covariance's backward)."""
    import functools
    import torch
    from repro_torch.core import panel_cholesky as pc
    th = torch.tensor([float(v) for v in theta], requires_grad=True,
                      dtype=torch.promote_types(locs.dtype, torch.float32))
    rec = _ScaleRecorder(pc._impl(impl)[0])
    build = functools.partial(pc.build_banded_covariance, locs, nb=nb,
                              policy=pol, nu_static=nu, metric=metric,
                              jitter=1e-6, impl=impl)
    band, off = pc.matern_ops.BandedMaternCov.apply(locs, th, build, nu,
                                                    metric, rec)
    band, off, failed = pc.PanelCholesky.apply(band, off, pol, "square", impl)
    ll = pc.banded_loglik(band, off, z, band.shape[1], failed)
    del band, off
    torch.autograd.grad(ll, th)
    return [float(v) for v in sum(rec.sums).tolist()]


def _dist_loglik(locs, z, th, pol, nb, matern, nu=0.5, version="masked_full",
                 grid=None, impl="kernel"):
    """geostat_loglik_distributed's graph for a theta that requires grad
    (its three Functions), with `matern` as the build's backward module
    (`_ScaleRecorder`, `_PlainCheck`)."""
    import functools
    from repro_torch.core import distributed as dd
    n = locs.shape[0]
    kw = dict(nb=nb, policy=pol, nu_static=nu, grid=grid, version=version)
    build = functools.partial(dd.build_covariance_distributed, locs,
                              impl=impl, **kw)
    off, band = dd.DistributedMaternCov.apply(locs, th, build,
                                              dict(kw, impl=impl), matern)
    off, band = dd.DistributedCholesky.apply(off, band, pol, version, grid,
                                             n, impl)
    return dd.DistributedLoglik.apply(off, band, z, band.shape[1], grid,
                                      version, n)


def distributed_grad_scale(locs, z, pol, theta, nb, nu=0.5,
                           version="masked_full", grid=None, impl="kernel"):
    """s_k = sum |G| dSigma/dtheta_k for k = 1, 2, G = dl/d(off, band) of the
    distributed engine at theta (its graph with `_ScaleRecorder` as the
    build's backward module), summed over the grid: the same on every
    rank."""
    import torch
    from repro_torch.core import distributed as dd
    from repro_torch.core import panel_cholesky as pc
    th = torch.tensor([float(v) for v in theta], requires_grad=True,
                      dtype=torch.promote_types(locs.dtype, torch.float32))
    rec = _ScaleRecorder(pc._impl(impl)[0])
    ll = _dist_loglik(locs, z, th, pol, nb, rec, nu, version, grid, impl)
    torch.autograd.grad(ll, th)
    scale = sum(rec.sums)
    dd._all_reduce(grid.group if grid is not None else None, scale)
    return [float(v) for v in scale.tolist()]


class _PlainCheck:
    """A stand-in for the matern_cov module in `DistributedMaternCov`'s
    backward on the card: each matern_cov_grad_tiles call launches the
    kernel (the path's launch, counted) and then runs the plain version on
    the same locations and G, and on |G| for the scale, over rows of G
    of GRAD_ELEMS_CHECK elements at a time (the off slab's |G| whole is
    8 GiB at 65,536); `calls` keeps (G's shape, its dtype, kernel, plain,
    scale, the plain pass's seconds) and `seconds` both passes' host
    time."""

    def __init__(self):
        from repro_torch.kernels.matern_cov import ops, ref
        self.ops, self.ref, self.calls, self.seconds = ops, ref, [], 0.0

    def matern_cov_grad_tiles(self, locs_i, locs_j, theta, g, **kw):
        import torch
        got = self.ops.matern_cov_grad_tiles(locs_i, locs_j, theta, g, **kw)
        torch.cuda.synchronize()
        step = max(1, GRAD_ELEMS_CHECK // (g.shape[0] * g.shape[2]))
        sums, secs = [], []
        for fn in (lambda x: x, torch.abs):
            t0 = time.perf_counter()
            acc = 0
            for r0 in range(0, g.shape[1], step):
                acc = acc + self.ref.matern_cov_grad_tiles(
                    locs_i[:, r0:r0 + step], locs_j, theta,
                    fn(g[:, r0:r0 + step]), **kw)
            sums.append(acc.tolist())  # a host list: waits
            secs.append(time.perf_counter() - t0)
        self.calls.append((tuple(g.shape), str(g.dtype), got.tolist(), *sums,
                           secs[0]))
        self.seconds += sum(secs)
        return got


def grad_tiles_bound(n_elems, n_locs, loc_bytes, g_bytes, fp32):
    """(bound ms, bound_by) of a tile-stack matern_cov_grad launch over
    n_elems G entries: G and the locations read once, against grad_bound's
    16 operations per element in the locations' precision and 4 fp64."""
    by_bytes = (n_elems * g_bytes + 2 * n_locs * loc_bytes) / HBM_BYTES_PER_S
    by_ops = 16 * n_elems / (FP32_FLOPS if fp32 else FP64_FLOPS) \
        + 4 * n_elems / FP64_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _grad_ratio(got, want, scale):
    """max_k |got_k - want_k| / scale_k."""
    return max(abs(float(a) - float(b)) / float(s)
               for a, b, s in zip(got, want, scale))


def check_grad_tiles(locs_t, t, results):
    """13 (a): the tile-stack backward forms against their plain versions on
    the card, G drawn from a seed in each storage dtype: the zip form over
    band sub-diagonals 0 (symmetric with G in the locations' precision) and
    1, the lower form over off with min_lag = t, for the four (locations,
    G) pairs, Euclidean and haversine, every nu; within GRAD_KERNEL_TOL of
    the scale (the same sums over |G|), a second launch the same bits;
    at phase 4's p, each pair in the form the engine gives it (hi G: the
    zip form, lo G: the lower form), timed at nu = 0.5 beside its bound
    and the plain version (one call, host clock to the copy of its sums
    that ends it)."""
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    p, nb, _ = locs_t.shape
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    lonlat = hav_locations(locs_t.reshape(-1, 2)).reshape(p, nb, 2)
    out = {}
    for ldt, gdt in ((f32, f32), (f32, bf16), (f64, f64), (f64, f32)):
        for metric, base in (("euclidean", locs_t), ("haversine", lonlat)):
            lt = base.to(ldt).contiguous()
            theta = list(WEAK[:2]) if metric == "euclidean" else list(HAV_THETA[:2])
            tol = GRAD_KERNEL_TOL[str(ldt)]
            # zip: a band's cotangent (p, t, nb, nb) in hi; lower: off's in lo
            zip_form = gdt == ldt
            if zip_form:
                g = torch.randn((p, t, nb, nb), generator=gen, device="cuda",
                                dtype=torch.float32).to(gdt)
                calls = [(f"zip d={d}", (lt[d:], lt[:p - d]), g[d:, d])
                         for d in (0, 1)]
            else:
                g = torch.randn((p, p, nb, nb), generator=gen, device="cuda",
                                dtype=torch.float32).to(gdt)
                calls = [("lower", (lt,), g)]
            for nu in (0.5, 1.5, 2.5):
                for what, locs, gg in calls:
                    fn = "matern_cov_grad_tiles" if what != "lower" else "matern_cov_grad_lower"
                    kw = dict(nu=nu, metric=metric)
                    if what == "lower":
                        kw["min_lag"] = t
                    got = getattr(ops, fn)(*locs, theta, gg, **kw)
                    again = getattr(ops, fn)(*locs, theta, gg, **kw)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    want = getattr(ref, fn)(*locs, theta, gg, **kw)
                    plain_ms = 1e3 * (time.perf_counter() - t0)  # ends in a copy
                    scale = getattr(ops, fn)(*locs, theta, gg.abs(), **kw)
                    ratio = _grad_ratio(got, want, scale)
                    line = dict(form=what, locations=str(ldt), g=str(gdt),
                                metric=metric, nu=nu, tiles=p, nb=nb,
                                grad=got.tolist(), grad_plain=want.tolist(),
                                err_over_scale=ratio, tol=tol,
                                same_bits_twice=torch.equal(got, again))
                    require(torch.equal(got, again) and got.dtype == f64
                            and ratio <= tol,
                            f"13 (a) grad tiles {line}")
                    if nu == 0.5 and what != "zip d=0":
                        elems = gg.shape[0] * nb * nb if what != "lower" else \
                            (p - t) * (p - t + 1) // 2 * nb * nb
                        line["ms"] = time_ms(lambda: getattr(ops, fn)(
                            *locs, theta, gg, **kw))
                        line["plain_ms"] = plain_ms
                        line["bound_ms"], line["bound_by"] = grad_tiles_bound(
                            elems, 2 * p * nb, ldt.itemsize, gdt.itemsize,
                            ldt == f32)
                        line["max_abs_err"] = max(abs(a - b) for a, b in zip(
                            got.tolist(), want.tolist()))
                        out[(str(ldt), metric, what)] = line
                    emit(phase="panel_grad", step="kernel",
                         kernel="matern_cov_grad", **line)
            del g
            torch.cuda.empty_cache()
    return out


HAV_BOX = (45.0, 60.0, 22.5, 35.0)   # lon0, lon1, lat0, lat1: wind region R2's box
# haversine field's theta (theta2 in degrees): as weakly correlated for
# the points' spacing in the box as WEAK is in the unit square at n_obs
HAV_THETA = (1.0, 0.4, 0.5)
# haversine covariance against fp64: the plain fp32 path's bound
# (tests/test_torch_covariance.py holds the general nu to it)
HAV_MAX_REL = 1e-4


def hav_locations(unit):
    """Points of the unit square mapped onto HAV_BOX (lon, lat degrees)."""
    import torch
    lon0, lon1, lat0, lat1 = HAV_BOX
    return torch.stack([lon0 + unit[..., 0] * (lon1 - lon0),
                        lat0 + unit[..., 1] * (lat1 - lat0)], -1)


def _rel_to_fp64(got, want64):
    return float(((got.double() - want64).abs() / want64.abs().clamp_min(
        1e-300)).max())


def check_matern_haversine(locs_t, t, n_dense, results):
    """13 (a): the haversine forward against fp64 and against its plain
    version, every nu, on lon/lat points (phase 4's mapped into HAV_BOX):
    the band's sub-diagonal 1 (general form) and 0 (symmetric form: the
    same bits as the general form and as its transpose), the off-band's
    bf16 outer form (1 bf16 ulp of the plain version's), fp64 locations'
    zip form (1e-12 of the plain version), then the dense Sigma of n_dense
    points (the symmetric form) by row slabs; each fp32 path within
    max(HAV_MAX_REL, the plain path's own distance) of fp64; and the
    one-tile backward on Sigma with G from a seed.  Timed at nu = 0.5."""
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    p, nb, _ = locs_t.shape
    lt = hav_locations(locs_t)
    lt64 = lt.double()
    th = list(HAV_THETA[:2])
    kw = dict(metric="haversine")
    worst, timing = 0.0, {}
    for nu in (0.5, 1.5, 2.5):
        rels = {}
        for d in (1, 0):
            args = (lt[d:], lt[:p - d], th)
            got = ops.matern_cov_tiles(*args, nu=nu, **kw)
            plain = ref.matern_cov_tiles(*args, nu=nu, **kw)
            want = ref.matern_cov_tiles(lt64[d:], lt64[:p - d], th, nu=nu,
                                        out_dtype=torch.float64, **kw)
            rels[d] = (_rel_to_fp64(got, want), _rel_to_fp64(plain, want))
            worst = max(worst, float((got - plain).abs().max()))
            if d == 0:
                general = ops.matern_cov_tiles(lt[:p].clone(), lt[:p], th,
                                               nu=nu, **kw)
                require(torch.equal(got, general)
                        and torch.equal(got, got.mT),
                        f"13 (a) haversine symmetric nu={nu}: not the "
                        "general form's bits or not symmetric")
            del got, plain, want
        off = ops.matern_cov_lower(lt, th, nu=nu, min_lag=t,
                                   out_dtype=torch.bfloat16, **kw)
        off_plain = ref.matern_cov_lower(lt, th, nu=nu, min_lag=t,
                                         out_dtype=torch.bfloat16, **kw)
        ulps = 0.0
        for i in range(p):
            o, w = off[i].float(), off_plain[i].float()
            ulps = max(ulps, float(((o - w).abs() / bf16_ulp(
                torch.maximum(o.abs(), w.abs()))).max()))
        del off, off_plain
        b64 = ops.matern_cov_tiles(lt64[1:], lt64[:p - 1], th, nu=nu,
                                   out_dtype=torch.float64, **kw)
        b64_plain = ref.matern_cov_tiles(lt64[1:], lt64[:p - 1], th, nu=nu,
                                         out_dtype=torch.float64, **kw)
        rel64 = _rel_to_fp64(b64, b64_plain)
        del b64, b64_plain
        ok = all(k <= max(HAV_MAX_REL, pl) for k, pl in rels.values())
        emit(phase="panel_grad", step="haversine forward", nu=nu, tiles=p,
             nb=nb, band_d1_rel_fp64=rels[1], band_d0_rel_fp64=rels[0],
             off_bf16_ulps=ulps, fp64_rel_plain=rel64, tol=HAV_MAX_REL)
        require(ok and ulps <= 1.0 and rel64 <= 1e-12,
                f"13 (a) haversine forward nu={nu}: {rels} {ulps} {rel64}")
        if nu == 0.5:
            def band_d1():
                return ops.matern_cov_tiles(lt[1:], lt[:p - 1], th, nu=nu, **kw)

            def off_lower():
                return ops.matern_cov_lower(lt, th, nu=nu, min_lag=t,
                                            out_dtype=torch.bfloat16, **kw)
            timing = dict(band_d1_ms=time_ms(band_d1),
                          band_d1_euclidean_ms=time_ms(
                              lambda: ops.matern_cov_tiles(
                                  locs_t[1:], locs_t[:p - 1], th, nu=nu)),
                          off_ms=time_ms(off_lower),
                          off_plain_ms=time_ms(lambda: ref.matern_cov_lower(
                              lt, th, nu=nu, min_lag=t,
                              out_dtype=torch.bfloat16, **kw), reps=2))
            torch.cuda.empty_cache()
    # the dense Sigma of n_dense points: symmetric form, by 4,096-row slabs
    flat = lt.reshape(-1, 2)[:n_dense].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(14)
    dense = {}
    for nu in (0.5, 1.5, 2.5):
        sigma = ops.matern_cov(flat, flat, th, nu=nu, **kw)
        rel = plain_rel = 0.0
        for r0 in range(0, n_dense, 4_096):
            rows = slice(r0, r0 + 4_096)
            want = ref.matern_cov(flat[rows].double(), flat.double(), th,
                                  nu=nu, out_dtype=torch.float64, **kw)
            plain = ref.matern_cov(flat[rows], flat, th, nu=nu, **kw)
            rel = max(rel, _rel_to_fp64(sigma[rows], want))
            plain_rel = max(plain_rel, _rel_to_fp64(plain, want))
            del want, plain
        g = torch.randn(sigma.shape, generator=gen, device="cuda")
        got = ops.matern_cov_grad(flat, flat, th, g, nu=nu, **kw)
        want = ref.matern_cov_grad(flat, flat, th, g, nu=nu, **kw)
        scale = ref.matern_cov_grad(flat, flat, th, g.abs(), nu=nu, **kw)
        ratio = _grad_ratio(got, want, scale)
        line = dict(nu=nu, n=n_dense, sigma_rel_fp64=rel,
                    plain_rel_fp64=plain_rel, tol=HAV_MAX_REL,
                    grad=got.tolist(), grad_plain=want.tolist(),
                    grad_err_over_scale=ratio,
                    grad_tol=GRAD_KERNEL_TOL["torch.float32"])
        if nu == 0.5:
            line.update(
                sigma_ms=time_ms(lambda: ops.matern_cov(flat, flat, th, nu=nu,
                                                        **kw)),
                sigma_plain_ms=time_ms(lambda: ref.matern_cov(
                    flat, flat, th, nu=nu, **kw), reps=2),
                grad_ms=time_ms(lambda: ops.matern_cov_grad(
                    flat, flat, th, g, nu=nu, **kw)),
                grad_plain_ms=time_ms(lambda: ref.matern_cov_grad(
                    flat, flat, th, g, nu=nu, **kw), reps=2))
            dense = line
        emit(phase="panel_grad", step="haversine dense", **line)
        require(rel <= max(HAV_MAX_REL, plain_rel)
                and ratio <= GRAD_KERNEL_TOL["torch.float32"],
                f"13 (a) haversine dense nu={nu}: {line}")
        worst = max(worst, float(max(abs(a - b) for a, b in zip(
            got.tolist(), want.tolist()))))
        del sigma, g
        torch.cuda.empty_cache()
    n2 = n_dense * n_dense
    by_bytes = 4 * n2 / HBM_BYTES_PER_S
    # the symmetric form's distinct elements, ~110 fp32 operations each
    # (the two sines, the arcsine, the square root and the Matern's 20)
    by_ops = 110 * (n2 / 2) / FP32_FLOPS
    results["matern_cov_haversine"] = dict(
        name="matern_cov (haversine)", route="cuda",
        source="src/repro_torch/csrc/matern_cov.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=worst, ms=dense["sigma_ms"],
        plain_ms=dense["sigma_plain_ms"],
        bound_ms=1e3 * max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=None)
    gb, gby = grad_bound(n_dense, n_dense, torch.float32)
    results["matern_cov_grad_haversine"] = dict(
        name="matern_cov_grad (haversine)", route="cuda",
        source="src/repro_torch/csrc/matern_cov_grad.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=worst, ms=dense["grad_ms"],
        plain_ms=dense["grad_plain_ms"], bound_ms=gb, bound_by=gby,
        library_ms=None)
    emit(phase="panel_grad", step="haversine timing", nu=0.5, **timing)


# a panel value-and-gradient evaluation, kernel path against plain path:
# (|ll| relative, each gradient component's gap over its scale s_k).  The
# log-likelihood's are phase 4's; the gradient's are phase 10.3 (b)'s for
# the same pairs (TILE_GRAD_TOL): a bf16 rounding that flips between the
# paths moves tpu(t)'s gradient (ROADMAP C 13)
PANEL_GRAD_TOL = {"tpu": (1e-3, 1e-5), "paper_cpu": (1e-5, 1e-8)}


def panel_grad_evaluation(label, locs, z, pol, theta, nb, nu, results,
                          key=None, metric="euclidean", base_gib=0.0):
    """13 (b): one value-and-gradient evaluation of geostat_loglik_step at
    theta through the kernels (after a warm-up) and through the plain
    versions: exact launch counts, the log-likelihood equal to the no-grad
    one bit for bit, kernel against plain within PANEL_GRAD_TOL of s_k,
    seconds forward and backward, peak against its prediction, and the
    kernel path once more under the profiler (the raw events: busy and
    idle share, device time by kernel), where s_k is taken.  base_gib:
    what the process holds on the card before the evaluation, added to
    the prediction."""
    import torch
    from repro_torch.core import geostat_loglik_step
    n = locs.shape[0]
    p, t = n // nb, min(pol.diag_thick, n // nb)
    expected = panel_grad_launches(p, t, pol.hi == torch.float32)
    lo = pol.lo if pol.mode != "full" else pol.hi
    predicted = base_gib + plan().panel_grad_peak_gib(n, nb, t, pol.hi.itemsize,
                                               lo.itemsize)

    def fn_of(impl):
        return lambda th: geostat_loglik_step(locs, z, th, nb=nb, policy=pol,
                                              nu_static=nu, metric=metric,
                                              impl=impl)
    out = {}
    for impl in ("kernel", "plain"):
        out[impl] = _value_and_grad(fn_of(impl), theta)
        torch.cuda.empty_cache()
    (a, ga, fa, ba, pa, ca), (b, gb, fb, bb, pb, cb) = out["kernel"], out["plain"]
    require(ca == expected, f"{label}: launches {ca}, expected {expected}")
    require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
    with torch.no_grad():  # the same fp32 theta, no autograd
        no_grad = float(fn_of("kernel")(torch.tensor(theta,
                                                     dtype=torch.float32)))
    require(a == no_grad, f"{label}: ll {a} with grad, {no_grad} without")
    # the profiled evaluation gives the scale s_k as well: its covariance
    # backward runs once more on |G| (9 launches more, ~1 % of its device
    # time at phase 4's size)
    held = []
    prof = stream_profile(lambda: held.append(panel_grad_scale(
        locs, z, pol, theta, nb, nu, metric)), keep_rows=True)
    scale = held.pop()
    torch.cuda.empty_cache()
    ll_tol, tol = PANEL_GRAD_TOL[label.split("(")[0]]
    gap = [abs(x - y) / s for x, y, s in zip(ga, gb, scale)]
    line = dict(policy=label, n=n, nb=nb, t=t, theta=list(theta),
                metric=metric, loglik_kernel=a, loglik_plain=b,
                loglik_no_grad=no_grad, grad_kernel=ga, grad_plain=gb,
                grad_scale=scale, grad_gap_over_scale=gap, tol=tol,
                loglik_tol=ll_tol, seconds_forward_kernel=fa,
                seconds_backward_kernel=ba, seconds_forward_plain=fb,
                seconds_backward_plain=bb, peak_gib_kernel=pa,
                peak_gib_plain=pb, predicted_peak_gib=predicted,
                launches_kernel=ca)
    require(math.isfinite(a) and all(map(math.isfinite, ga)) and ga[2] == 0.0
            and abs(a - b) <= ll_tol * abs(b) and max(gap) <= tol,
            f"{label}: {line}")
    rows = prof.pop("rows")
    grad_class_ms, grad_ms = syrk_grad_device_ms(rows)
    # the covariance backward's launches on G and on |G| alike: half of
    # them are the evaluation's
    mc_rows = [(c, ms) for k, c, ms in rows if "matern_cov_grad_kernel" in k]
    line.update(profile=prof, mp_syrk_grad_device_ms=grad_ms,
                mp_syrk_grad_class_ms=grad_class_ms,
                matern_cov_grad_profiled=dict(
                    launches=sum(c for c, _ in mc_rows),
                    ms=sum(ms for _, ms in mc_rows)),
                matern_cov_grad_device_ms=sum(ms for _, ms in mc_rows) / 2)
    emit(phase="panel_grad", step="evaluation", **line)
    if key:
        results.setdefault(key, {})["launches"] = ca["matern_cov_grad"]
    return line


def _hav_field(gen, n, theta):
    """n lon/lat points in HAV_BOX (phase 4's perturbed grid, Morton order)
    and a field drawn at theta, nu = 0.5, haversine distance."""
    from repro_torch.covariance import apply_ordering, random_locations
    from repro_torch.covariance.generator import ORDERINGS, simulate_field
    unit = random_locations(gen, n)
    locs = hav_locations(unit)
    z = simulate_field(gen, locs, theta, nu_static=0.5, metric="haversine",
                       jitter=1e-6)
    return apply_ordering(locs, z, ORDERINGS["morton"](unit))


def haversine_loglik(n_obs, nb, results):
    """13 (c): make_loglik(metric="haversine", nu_static=0.5) value and
    gradient at n_obs lon/lat points, dense full(fp32) (10.1's check) and
    through the tiles under tpu(2) (10.3 (b)'s), kernel against plain."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    gen = torch.Generator(device="cuda").manual_seed(17)
    locs, z = _hav_field(gen, n_obs, list(HAV_THETA))
    p = n_obs // nb
    for label, pol, tiles in (("full(fp32)", PrecisionPolicy.full(torch.float32),
                               False),
                              ("tpu(2)", PrecisionPolicy.tpu(2), True)):
        expected = tile_grad_launches(p, True) if tiles else dense_grad_launches()
        out = {}
        for impl in ("kernel", "plain"):
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             metric="haversine", use_tiles=tiles, impl=impl)
            out[impl] = _value_and_grad(fn, HAV_THETA)
            torch.cuda.empty_cache()
        (a, ga, fa, ba, pa, ca), (b, gb, fb, bb, pb, cb) = out["kernel"], out["plain"]
        fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5, metric="haversine",
                         use_tiles=tiles)
        with torch.no_grad():
            no_grad = float(fn(torch.tensor(HAV_THETA, dtype=torch.float32)))
        if tiles:
            scale = _grad_scale(locs, z, pol, HAV_THETA, nb, metric="haversine")
            ll_tol, tol = TILE_GRAD_TOL[label]
            err = max(abs(x - y) / s for x, y, s in zip(ga, gb, scale))
        else:
            ll_tol = tol = GRAD_EVAL_TOL["torch.float32"]
            err = max(abs(x - y) for x, y in zip(ga, gb)) / max(map(abs, gb))
        line = dict(policy=label, metric="haversine", nu=0.5, n=n_obs, nb=nb,
                    theta=list(HAV_THETA), loglik_kernel=a, loglik_plain=b,
                    loglik_no_grad=no_grad, grad_kernel=ga, grad_plain=gb,
                    grad_err=err, tol=tol, loglik_tol=ll_tol,
                    seconds_forward_kernel=fa, seconds_backward_kernel=ba,
                    seconds_forward_plain=fb, seconds_backward_plain=bb,
                    peak_gib_kernel=pa, launches_kernel=ca)
        emit(phase="panel_grad", step="haversine make_loglik", **line)
        require(ca == expected and sum(cb.values()) == 0 and a == no_grad
                and math.isfinite(a) and all(map(math.isfinite, ga))
                and abs(a - b) <= ll_tol * abs(b) and err <= tol,
                f"13 (c) {label}: {line}, launches expected {expected}")
        results.setdefault("matern_cov_haversine", {})[
            "launches" if not tiles else "launches_tiles"] = ca["matern_cov"]
        results.setdefault("matern_cov_grad_haversine", {})[
            "launches" if not tiles else "launches_tiles"] = ca["matern_cov_grad"]


def panel_grad(ds, cfg, hcfg, results):
    """Phase 13: the panel engine's gradient and haversine matern_cov on the
    card (see the module docstring), sub-steps timed into one line."""
    import torch
    from repro_torch.core import PrecisionPolicy
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    p = n // nb
    locs_t = ds.locs.reshape(p, nb, 2)
    base = held_on_card()
    emit(phase="panel_grad", step="held at the start", **base)
    base = base["allocated_gib"]
    lines = step("13a grad tiles", check_grad_tiles, locs_t, t, results)
    step("13a haversine", check_matern_haversine, locs_t, t, hcfg["n_dense"],
         results)
    th0 = [float(v) for v in ds.theta0.tolist()]
    main = step("13b tpu", panel_grad_evaluation, f"tpu({t})", ds.locs, ds.z,
                PrecisionPolicy.tpu(t), th0, nb, cfg["nu"], results,
                "matern_cov_grad_tiles", "euclidean", base)
    MEASURED["13b tpu"] = main["grad_kernel"]
    n_pair = panel_grad_n(n, nb, t, 8, 4, hcfg["peak_gib"] - base)
    emit(phase="panel_grad", step="paper pair size", n=n, n_pair=n_pair,
         held_gib=base,
         predicted_peak_gib=base + plan().panel_grad_peak_gib(n_pair, nb, t, 8, 4),
         predicted_peak_gib_uncut=base + plan().panel_grad_peak_gib(n, nb, t, 8, 4),
         limit_gib=hcfg["peak_gib"])
    pair = step("13b paper_cpu", panel_grad_evaluation, f"paper_cpu({t})",
                ds.locs[:n_pair].double().contiguous(),
                ds.z[:n_pair].double().contiguous(), PrecisionPolicy.paper_cpu(t),
                th0, nb, cfg["nu"], results, "matern_cov_grad_tiles_fp64",
                "euclidean", base)
    require(pair["peak_gib_kernel"] <= hcfg["peak_gib"] + 1,
            f"paper_cpu({t}) peak {pair['peak_gib_kernel']} GiB")
    step("13c haversine", haversine_loglik, hcfg["n_obs"], hcfg["nb"], results)
    for key, dt, ms_key in (("matern_cov_grad_tiles", "torch.float32", main),
                            ("matern_cov_grad_tiles_fp64", "torch.float64", pair)):
        z_line = lines[(dt, "euclidean", "zip d=1")]
        l_line = lines[(dt, "euclidean", "lower")]
        results[key].update(
            name="matern_cov_grad (tile stacks" + (")" if dt.endswith("32")
                                                  else ", fp64)"),
            route="cuda", source="src/repro_torch/csrc/matern_cov_grad.cu",
            replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
            max_abs_err=max(z_line["max_abs_err"], l_line["max_abs_err"]),
            ms=l_line["ms"], plain_ms=l_line["plain_ms"],
            bound_ms=l_line["bound_ms"], bound_by=l_line["bound_by"],
            library_ms=None, zip_ms=z_line["ms"], zip_plain_ms=z_line["plain_ms"],
            zip_bound_ms=z_line["bound_ms"],
            device_ms_per_evaluation=ms_key["matern_cov_grad_device_ms"])
    emit(phase="panel_grad", step="seconds", **secs)


# ---------------------------------------------------------------------------
# phase 14: the distributed panel engine (core/distributed.py) on NCCL
# ---------------------------------------------------------------------------

def distributed_launches(p, t, fp32_band, grad=False):
    """Kernel launches of one distributed evaluation: matern_cov once over
    the off slab and once per band sub-diagonal, blocked_potrf once per step
    for an fp32 band (an fp64 band's diagonal tiles go to cuSOLVER); with
    `grad`, of one value-and-gradient evaluation: its backward's
    matern_cov_grad as often as the forward's matern_cov (the reverse sweeps
    launch no kernel)."""
    return {"matern_cov": 1 + t, "blocked_potrf": p if fp32_band else 0,
            "mp_syrk": 0, "matern_cov_grad": 1 + t if grad else 0,
            "mp_syrk_grad": 0, "mp_attention": 0}


def _close(a, b, tol):
    """Both NaN, or both finite and within tol |b|."""
    return (math.isnan(a) and math.isnan(b)) or (
        math.isfinite(a) and math.isfinite(b) and abs(a - b) <= tol * abs(b))


def check_lo_product(n, nb):
    """The bf16-operand lo product (fp32 sums, rounded once) against the
    fp32-upcast one at the row chunk of U that geostat_65k's evaluation
    computes, on N(0, 1) operands: the two fp32 sums differ only in their
    order, so each element within one bf16 ulp of its value plus twice
    1e-6 of sum |a_i b_i| (phase 10.3's off-band bound, SYRK_GRAD_TOL;
    where the sum cancels, its order moves it by many bf16 ulps of the
    small result); both timed."""
    import torch
    from repro_torch.core import PrecisionPolicy, lo_matmul
    from repro_torch.core import distributed as dd
    rows = min(max(1, dd.U_CHUNK_ELEMS // (nb * nb * (n // nb))), n // nb) * nb
    gen = torch.Generator(device="cuda").manual_seed(15)
    a = torch.randn(rows, nb, generator=gen, device="cuda").bfloat16()
    b = torch.randn(n, nb, generator=gen, device="cuda").bfloat16()
    pol = PrecisionPolicy.tpu(8)
    with dd._fp32_reductions():
        got = dd.lo_product(a, b, pol).float()
        ms = time_ms(lambda: dd.lo_product(a, b, pol))
    want = lo_matmul(a, b.T, pol).float()
    ms_up = time_ms(lambda: lo_matmul(a, b.T, pol))
    scale = a.float().abs() @ b.float().abs().T
    err = (got - want).abs()
    ulp = bf16_ulp(want)
    ratio = float((err / (ulp + 2 * SYRK_GRAD_TOL["torch.float32"] * scale)).max())
    flops = 2 * rows * n * nb
    emit(phase="distributed", step="lo product", m=rows, n=n, k=nb,
         max_err_over_bound=ratio, max_bf16_ulps=float((err / ulp).max()),
         within_one_ulp=float((err <= ulp).float().mean()),
         ms_bf16=ms, ms_fp32_upcast=ms_up,
         tflops_bf16=flops / ms / 1e9, tflops_fp32_upcast=flops / ms_up / 1e9,
         bound_ms=1e3 * flops / BF16_FLOPS)
    require(ratio <= 1.0, f"bf16 lo product {ratio} of its bound from the "
            "upcast one")
    del a, b, got, want, scale, err, ulp


def distributed_small(dcfg, grid):
    """14 (a): tpu(2), full(fp32) and the pair at n = small_n through every
    version: the 1 x 1 NCCL grid gives the no-group call's bits, masked_full
    and fori one factor, aligned within phase 8.1's (9.1's) limit, kernels
    against plain within phase 4's, exact launches; a CUDA tensor under a
    gloo group refused."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import PrecisionPolicy as P
    from repro_torch.core import distributed as dd
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_grid
    n, nb, t = dcfg["small_n"], dcfg["small_nb"], dcfg["small_t"]
    p = n // nb
    gen = torch.Generator(device="cuda").manual_seed(14)
    ds = make_dataset(gen, n, WEAK, nu_static=0.5)
    th = list(WEAK)
    cases = (("tpu(2)", P.tpu(t), ds.locs, ds.z, 1e-3),
             ("full(fp32)", P.full(torch.float32), ds.locs, ds.z, 1e-3),
             ("paper_cpu(2)", P.paper_cpu(t), ds.locs.double(), ds.z.double(),
              1e-5))
    for label, pol, locs, z, tol in cases:
        want = distributed_launches(p, min(pol.diag_thick, p),
                                    pol.hi == torch.float32)
        out = {}
        for version in dd.VERSIONS:
            runs = {}
            for key, g in (("no group", None), ("nccl 1x1", grid)):
                reset_launch_counts()
                off, band = dd.build_covariance_distributed(
                    locs, th, nb=nb, policy=pol, grid=g, version=version)
                off, band = dd.panel_cholesky_distributed(
                    off, band, pol, version=version, grid=g, n=n)
                ll = dd.loglik_distributed(off, band, z, band.shape[1],
                                           grid=g, version=version, n=n)
                counts = launch_counts()
                require(counts == want, f"{label} {version} {key}: launches "
                        f"{counts}, expected {want}")
                runs[key] = (off, band, ll)
            require(all(_same_bits(x, y) for x, y in zip(*runs.values())),
                    f"{label} {version}: the NCCL grid's factor or ll is not "
                    "the no-group call's")
            reset_launch_counts()
            plain = float(dd.geostat_loglik_distributed(
                locs, z, th, nb=nb, policy=pol, version=version, grid=grid,
                impl="plain"))
            require(sum(launch_counts().values()) == 0,
                    f"{label} {version}: the plain path launched")
            a = float(runs["nccl 1x1"][2])
            require(_close(a, plain, tol), f"{label} {version}: kernel {a} "
                    f"vs plain {plain}")
            out[version] = runs["nccl 1x1"]
            emit(phase="distributed", step="small", policy=label, n=n, nb=nb,
                 t=min(pol.diag_thick, p), version=version, loglik_kernel=a,
                 loglik_plain=plain, tol=tol, launches_kernel=want,
                 nccl_equals_no_group=True)
        require(all(_same_bits(x, y) for x, y in zip(out["masked_full"],
                                                    out["fori"])),
                f"{label}: masked_full and fori differ")
        a, b = float(out["aligned"][2]), float(out["masked_full"][2])
        require(_close(a, b, tol), f"{label}: aligned {a} vs masked_full {b}")
        emit(phase="distributed", step="small versions", policy=label,
             masked_full_equals_fori=True, aligned=a, masked_full=b,
             rel=abs(a - b) / abs(b) if math.isfinite(b) else None, tol=tol)
    gloo = dist.new_group([0], backend="gloo")
    try:
        dd.geostat_loglik_distributed(ds.locs, ds.z, th, nb=nb,
                                      policy=P.tpu(t),
                                      grid=make_grid(1, 1, group=gloo))
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None, "a CUDA tensor under a gloo grid ran")
    emit(phase="distributed", step="gloo refusal", refused=refused)


def distributed_cell(ds, cfg, grid, ll_panel, dcfg, results):
    """14 (b): geostat_65k (phase 4's field and first request) through the
    three versions on the 1 x 1 NCCL grid, kernels (after one warm-up) and
    plain: exact launches, kernel against plain within phase 4's limit, ll
    beside the panel engine's, seconds, the peak against its prediction;
    masked_full under the profiler."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.core import distributed as dd
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    base = held_on_card()["allocated_gib"]
    while (base + plan().distributed_peak_gib(n, nb, t, 4, 2, 2)
           > dcfg["peak_gib"]):
        n -= nb
    p = n // nb
    predicted = base + plan().distributed_peak_gib(n, nb, t, 4, 2, 2)
    emit(phase="distributed", step="65k prediction", n=n, held_gib=base,
         predicted_peak_gib=predicted, limit_gib=dcfg["peak_gib"],
         lo_flops_masked_full=(p - 1) * 2 * n * n * nb,
         lo_flops_aligned=sum(2 * n * nb * nb * (p - max(
             min(-(-(k + 1) // 16) * 16, p) - 16, 0)) for k in range(p - 1)),
         band_flops=sum(2 * nb ** 3 * (p - k - 1 - d) for k in range(p - 1)
                        for d in range(min(t, p - k - 1))))
    pol = PrecisionPolicy.tpu(t)
    locs, z = ds.locs[:n], ds.z[:n]
    th0 = [float(v) for v in ds.theta0.tolist()]
    want = distributed_launches(p, t, True)
    for version in dd.VERSIONS:
        def run(th, impl="kernel"):
            return dd.geostat_loglik_distributed(
                locs, z, th, nb=nb, policy=pol, nu_static=cfg["nu"],
                version=version, grid=grid, impl=impl)
        warm = _evaluate(run, th0)
        a, secs, peak, counts = _evaluate(run, th0)
        require(counts == want and warm[3] == want,
                f"{version}: launches {counts}, expected {want}")
        require(a == warm[0] or (math.isnan(a) and math.isnan(warm[0])),
                f"{version}: {a} then {warm[0]}")
        b, sb, pb, cb = _evaluate(lambda th: run(th, "plain"), th0)
        require(sum(cb.values()) == 0, f"{version}: plain path launched {cb}")
        require(_close(a, b, 1e-3), f"{version}: kernel {a} vs plain {b}")
        require(peak <= dcfg["peak_gib"] + 1, f"{version}: peak {peak} GiB")
        if version == "masked_full":
            MEASURED["14b"] = dict(n=n, nb=nb, t=t, seconds=secs,
                                   peak_gib=peak, held_gib=base,
                                   predicted_gib=predicted)
            ll_masked = a
        emit(phase="distributed", step="65k", version=version, n=n, nb=nb,
             t=t, theta=th0, loglik_kernel=a, loglik_plain=b,
             rel_diff=abs(a - b) / abs(b) if math.isfinite(b) else None,
             tol=1e-3, loglik_panel=ll_panel,
             diff_to_panel=a - ll_panel if ll_panel is not None else None,
             seconds_kernel=secs, seconds_kernel_warmup=warm[1],
             seconds_plain=sb, peak_gib_kernel=peak, peak_gib_plain=pb,
             predicted_peak_gib=predicted, launches_kernel=counts)
        torch.cuda.empty_cache()
    prof = stream_profile(lambda: float(dd.geostat_loglik_distributed(
        locs, z, th0, nb=nb, policy=pol, nu_static=cfg["nu"], grid=grid)))
    emit(phase="distributed", step="65k profile", version="masked_full", **prof)
    for k in ("matern_cov", "blocked_potrf"):
        results[k]["launches_distributed"] = want[k]
    return n, ll_masked


def distributed_pair(fp64_field, full64_ll, pcfg, grid, dcfg):
    """14 (c): the pair at DP(10%) on phase 9's fp64 medium field through
    aligned and masked_full, kernels and plain: exact launches, kernel
    against plain within 1e-5 |ll|, ll within 1e-4 |ll| of phase 9.1's
    full(fp64), seconds, peak."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.core import distributed as dd
    locs, z = fp64_field
    nb = pcfg["nb"]
    n = locs.shape[0]
    p = n // nb
    pol = PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu")
    t = min(pol.diag_thick, p)
    base = held_on_card()["allocated_gib"]
    predicted = base + plan().distributed_peak_gib(n, nb, t, 8, 4, 4)
    require(predicted <= dcfg["peak_gib"], f"the pair's predicted {predicted} GiB")
    want = distributed_launches(p, t, False)
    theta = list(MEDIUM)
    for version in ("aligned", "masked_full"):
        def run(th, impl="kernel"):
            return dd.geostat_loglik_distributed(
                locs, z, th, nb=nb, policy=pol, version=version, grid=grid,
                impl=impl)
        a, secs, peak, counts = _evaluate(run, theta)
        b, sb, pb, cb = _evaluate(lambda th: run(th, "plain"), theta)
        require(counts == want, f"the pair {version}: launches {counts}")
        require(sum(cb.values()) == 0, f"the pair {version}: plain launched")
        require(_close(a, b, 1e-5), f"the pair {version}: kernel {a} vs plain {b}")
        drift = abs(a - full64_ll) / abs(full64_ll)
        require(drift <= 1e-4, f"the pair {version}: {a} vs full(fp64) {full64_ll}")
        emit(phase="distributed", step="pair", version=version, n=n, nb=nb,
             t=t, theta=theta, loglik_kernel=a, loglik_plain=b,
             rel_diff=abs(a - b) / abs(b), tol=1e-5, loglik_full_fp64=full64_ll,
             drift_vs_full_fp64=drift, drift_tol=1e-4, seconds_kernel=secs,
             seconds_plain=sb, peak_gib_kernel=peak, peak_gib_plain=pb,
             predicted_peak_gib=predicted, launches_kernel=counts)
        torch.cuda.empty_cache()


def _dist_grad_gap(ga, gb, scale):
    """max_k |ga_k - gb_k| / s_k over theta1, theta2."""
    return max(abs(a - b) / s for a, b, s in zip(ga[:2], gb[:2], scale))


def distributed_grad_small(dcfg, grid):
    """14 (d.1): the gradient of (a)'s three policies at n = small_n through
    every version: the NCCL grid's ll, theta and z gradients the no-group
    call's bits, masked_full and fori the same bits, ll with grad the bits
    without, kernels against plain within DIST_KERNEL_TOL over s_k (the
    kernels' s_k), exact launches."""
    import torch
    from repro_torch.core import PrecisionPolicy as P
    from repro_torch.core import distributed as dd
    from repro_torch.covariance import make_dataset
    n, nb, t = dcfg["small_n"], dcfg["small_nb"], dcfg["small_t"]
    p = n // nb
    gen = torch.Generator(device="cuda").manual_seed(14)
    ds = make_dataset(gen, n, WEAK, nu_static=0.5)
    th = list(WEAK)
    cases = (("tpu(2)", P.tpu(t), ds.locs, ds.z),
             ("full(fp32)", P.full(torch.float32), ds.locs, ds.z),
             ("paper_cpu(2)", P.paper_cpu(t), ds.locs.double(),
              ds.z.double()))
    for label, pol, locs, z in cases:
        want = distributed_launches(p, min(pol.diag_thick, p),
                                    pol.hi == torch.float32, grad=True)
        tol = DIST_KERNEL_TOL[str(locs.dtype)]
        scale = distributed_grad_scale(locs, z, pol, th, nb, grid=grid)
        out = {}
        for version in dd.VERSIONS:
            def fn(g, impl="kernel"):
                return lambda th_, z_: dd.geostat_loglik_distributed(
                    locs, z_, th_, nb=nb, policy=pol, version=version,
                    grid=g, impl=impl)
            runs = {key: _value_and_grad(fn(g), th, z)
                    for key, g in (("no group", None), ("nccl 1x1", grid))}
            for key, r in runs.items():
                require(r[5] == want, f"{label} {version} {key}: launches "
                        f"{r[5]}, expected {want}")
            a, b = runs["no group"], runs["nccl 1x1"]
            require(a[0] == b[0] and a[1] == b[1] and torch.equal(a[6], b[6]),
                    f"{label} {version}: the NCCL grid's gradient is not the "
                    "no-group call's")
            plain = _value_and_grad(fn(grid, "plain"), th, z)
            require(sum(plain[5].values()) == 0,
                    f"{label} {version}: the plain path launched {plain[5]}")
            with torch.no_grad():
                no_grad = float(dd.geostat_loglik_distributed(
                    locs, z, torch.tensor(th, dtype=torch.float32), nb=nb,
                    policy=pol, version=version, grid=grid))
            gap = _dist_grad_gap(b[1], plain[1], scale)
            require(b[0] == no_grad, f"{label} {version}: ll {b[0]} with "
                    f"grad, {no_grad} without")
            require(all(map(math.isfinite, b[1])) and b[1][2] == 0.0
                    and gap <= tol, f"{label} {version}: kernel {b[1]} vs "
                    f"plain {plain[1]}, {gap} of s_k {scale}")
            out[version] = b
            emit(phase="distributed", step="grad small", policy=label, n=n,
                 nb=nb, t=min(pol.diag_thick, p), version=version,
                 loglik=b[0], grad_kernel=b[1], grad_plain=plain[1],
                 grad_scale=scale, grad_gap_over_scale=gap, tol=tol,
                 z_grad_max_abs_diff=float((b[6] - plain[6]).abs().max()),
                 seconds_forward=b[2], seconds_backward=b[3],
                 launches_kernel=want, nccl_equals_no_group=True)
        a, b = out["masked_full"], out["fori"]
        require(a[0] == b[0] and a[1] == b[1] and torch.equal(a[6], b[6]),
                f"{label}: masked_full and fori gradients differ")


def distributed_grad_cell(ds, cfg, grid, dcfg, ll_14b, results):
    """14 (d.2): geostat_65k's value and gradient (theta and z) through
    masked_full on the NCCL grid at the n distributed_grad_peak_gib keeps
    under dcfg's peak: one warm-up through geostat_loglik_distributed whose
    backward runs under the profiler (exact launches), then timed through
    the same Functions with `_PlainCheck` as the build's backward module
    (exact launches, each matern_cov_grad launch within DIST_CHECK_TOL of
    the scale of its plain version on the same slab and G, the plain's
    seconds taken out of the backward's, ll equal to 14 (b)'s no-grad ll
    at the same n, the peak against its prediction); the gradient beside
    13 (b)'s panel gradient (reported, not gated: the reference's
    lo-rounded band panel, C 18)."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.core import distributed as dd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    base = held_on_card()["allocated_gib"]
    while (n > nb and base + plan().distributed_grad_peak_gib(n, nb, t, 4, 2, 2)
           > dcfg["peak_gib"]):
        n -= nb
    p = n // nb
    predicted = base + plan().distributed_grad_peak_gib(n, nb, t, 4, 2, 2)
    emit(phase="distributed", step="grad 65k prediction", n=n, held_gib=base,
         predicted_peak_gib=predicted, limit_gib=dcfg["peak_gib"],
         predicted_forward_gib=base + plan().distributed_peak_gib(
             n, nb, t, 4, 2, 2))
    pol = PrecisionPolicy.tpu(t)
    locs, z = ds.locs[:n], ds.z[:n]
    th0 = [float(v) for v in ds.theta0.tolist()]
    want = distributed_launches(p, t, True, grad=True)
    th = torch.tensor(th0, dtype=torch.float32, requires_grad=True)
    zz = z.clone().requires_grad_()
    reset_launch_counts()
    ll = dd.geostat_loglik_distributed(locs, zz, th, nb=nb, policy=pol,
                                       nu_static=cfg["nu"], grid=grid)
    float(ll.detach())
    prof = stream_profile(lambda: torch.autograd.grad(ll, (th, zz)),
                          keep_rows=True)
    warm = launch_counts()
    require(warm == want, f"grad 65k warm-up: launches {warm}, expected {want}")
    del ll, th, zz
    # the build's backward: matern_cov_grad over the off slab (bf16 G, the
    # general form) and over each band sub-diagonal (fp32 G)
    mc_rows = [(k, c, ms) for k, c, ms in prof.pop("rows")
               if "matern_cov_grad_kernel" in k]
    off_rows = [(c, ms) for k, c, ms in mc_rows if "bf16" in k
                or "bfloat16" in k]
    off_bound, off_by = grad_tiles_bound(n * n, 2 * n, 4, 2, True)
    torch.cuda.empty_cache()
    check = _PlainCheck()
    a, ga, fa, ba, pa, ca, gza = _value_and_grad(
        lambda th_, z_: _dist_loglik(locs, z_, th_, pol, nb, check,
                                     cfg["nu"], grid=grid), th0, z)
    require(ca == want, f"grad 65k: launches {ca}, expected {want}")
    tol = DIST_CHECK_TOL
    checked = [dict(g_shape=shape, g_dtype=gdt, grad=got, grad_plain=plain,
                    err_over_scale=_grad_ratio(got, plain, scale),
                    plain_ms=1e3 * secs)
               for shape, gdt, got, plain, scale, secs in check.calls]
    worst = max(c["err_over_scale"] for c in checked)
    require(len(checked) == want["matern_cov_grad"] and worst <= tol,
            f"grad 65k: matern_cov_grad against plain {checked}, tol {tol}")
    if ll_14b is not None and ll_14b[0] == n:
        no_grad = ll_14b[1]
    else:
        with torch.no_grad():
            no_grad = float(dd.geostat_loglik_distributed(
                locs, z, torch.tensor(th0, dtype=torch.float32), nb=nb,
                policy=pol, nu_static=cfg["nu"], grid=grid))
    require(a == no_grad, f"grad 65k: ll {a} with grad, {no_grad} without")
    require(math.isfinite(a) and all(map(math.isfinite, ga)) and ga[2] == 0.0
            and bool(torch.isfinite(gza).all()), f"grad 65k: {a} {ga}")
    require(pa <= dcfg["peak_gib"] + 1, f"grad 65k: peak {pa} GiB")
    ba_kernels = ba - check.seconds
    MEASURED["14d"] = dict(n=n, nb=nb, t=t, seconds=fa + ba_kernels,
                           peak_gib=pa, held_gib=base, predicted_gib=predicted)
    line = dict(version="masked_full", n=n, nb=nb, t=t, theta=th0,
                loglik=a, loglik_no_grad=no_grad, grad_kernel=ga,
                z_grad_norm=float(gza.double().norm()),
                seconds_forward=fa, seconds_backward=ba_kernels,
                seconds_backward_with_check=ba,
                seconds_plain_check=check.seconds, peak_gib=pa,
                predicted_peak_gib=predicted, launches_kernel=ca,
                matern_cov_grad_vs_plain=checked,
                matern_cov_grad_tol=tol,
                panel_grad_13b=MEASURED.get("13b tpu"),
                profile_backward=prof,
                matern_cov_grad_rows=[{"name": k[:90], "count": c, "ms": ms}
                                      for k, c, ms in mc_rows],
                matern_cov_grad_off_slab=dict(
                    launches=sum(c for c, _ in off_rows),
                    ms=sum(ms for _, ms in off_rows), bound_ms=off_bound,
                    bound_by=off_by))
    del gza
    emit(phase="distributed", step="grad 65k", **line)
    results.setdefault("matern_cov_grad_tiles", {})["launches_distributed"] = (
        want["matern_cov_grad"])


def distributed_grad_pair(fp64_field, pcfg, grid, dcfg):
    """14 (d.3): the pair at DP(10%) on phase 9's fp64 medium field through
    aligned, at the n where 10.1 kept its full(fp64) gradient: kernels and
    plain (which records s_k) within DIST_KERNEL_TOL over s_k, exact
    launches, and the gradient within DIST_PAIR_FP64_TOL over s_k of
    10.1's (max_k |delta_k| / s_k; over max_k |grad_k| reported)."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.core import distributed as dd
    from repro_torch.core import panel_cholesky as pc
    dense = MEASURED.get("10.1 full(fp64)")
    locs, z = fp64_field
    nb = pcfg["nb"]
    n = dense["n"] if dense else locs.shape[0]
    locs, z = locs[:n].contiguous(), z[:n].contiguous()
    p = n // nb
    pol = PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu")
    t = min(pol.diag_thick, p)
    base = held_on_card()["allocated_gib"]
    predicted = base + plan().distributed_grad_peak_gib(n, nb, t, 8, 4, 4)
    require(predicted <= dcfg["peak_gib"], f"the pair's predicted {predicted} GiB")
    want = distributed_launches(p, t, False, grad=True)
    theta = list(MEDIUM)

    a, ga, fa, ba, pa, ca, gza = _value_and_grad(
        lambda th_, z_: dd.geostat_loglik_distributed(
            locs, z_, th_, nb=nb, policy=pol, version="aligned", grid=grid),
        theta, z)
    del gza
    rec = _ScaleRecorder(pc._impl("plain")[0])
    b, gb, fb, bb, pb, cb, gzb = _value_and_grad(
        lambda th_, z_: _dist_loglik(locs, z_, th_, pol, nb, rec,
                                     version="aligned", grid=grid,
                                     impl="plain"), theta, z)
    del gzb
    scale = [float(v) for v in sum(rec.sums).tolist()]
    gap = _dist_grad_gap(ga, gb, scale)
    tol = DIST_KERNEL_TOL[str(locs.dtype)]
    require(ca == want, f"the pair's gradient: launches {ca}, expected {want}")
    require(sum(cb.values()) == 0, f"the pair's gradient: plain launched {cb}")
    require(gap <= tol, f"the pair's gradient: kernel {ga} vs plain {gb}, "
            f"{gap} of s_k {scale}")
    line = dict(version="aligned", n=n, nb=nb, t=t, theta=theta, loglik=a,
                loglik_plain=b, grad_kernel=ga, grad_plain=gb,
                grad_scale=scale, grad_gap_over_scale=gap, tol=tol,
                seconds_forward=fa, seconds_backward=ba,
                seconds_forward_plain=fb, seconds_backward_plain=bb,
                peak_gib=pa, peak_gib_plain=pb, predicted_peak_gib=predicted,
                launches_kernel=ca)
    if dense:
        g64 = dense["grad"]
        rel = max(abs(x - y) for x, y in zip(ga[:2], g64[:2])) / max(
            abs(v) for v in g64[:2])
        gap64 = _dist_grad_gap(ga, g64, scale)
        line.update(grad_full_fp64=g64, loglik_full_fp64=dense["loglik"],
                    gap_to_full_fp64_over_scale=gap64,
                    rel_to_full_fp64=rel, fp64_tol=DIST_PAIR_FP64_TOL)
        require(gap64 <= DIST_PAIR_FP64_TOL, f"the pair's gradient {ga} vs "
                f"full(fp64)'s {g64}: {gap64} of s_k {scale}")
    emit(phase="distributed", step="grad pair", **line)
    torch.cuda.empty_cache()


def distributed(ds, cfg, fp64_field, full64_ll, ll_panel, dcfg, pcfg, results):
    """Phase 14: the distributed panel engine on a 1 x 1 NCCL grid (see the
    module docstring), sub-steps timed into one line; the process group is
    destroyed at the end.  (d) is its gradient."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_grid
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grid = make_grid(1, 1)
        secs["init"] = time.perf_counter() - t0
        step("14a lo product", check_lo_product, cfg["n"], cfg["nb"])
        step("14a small", distributed_small, dcfg, grid)
        ll_14b = step("14b 65k", distributed_cell, ds, cfg, grid, ll_panel,
                      dcfg, results)
        step("14c pair", distributed_pair, fp64_field, full64_ll, pcfg, grid,
             dcfg)
        step("14d.1 grad small", distributed_grad_small, dcfg, grid)
        step("14d.2 grad 65k", distributed_grad_cell, ds, cfg, grid, dcfg,
             ll_14b, results)
        step("14d.3 grad pair", distributed_grad_pair, fp64_field, pcfg, grid,
             dcfg)
    finally:
        dist.destroy_process_group()
    emit(phase="distributed", step="seconds", **secs)


# ---------------------------------------------------------------------------
# phase 15: telemetry (repro_torch.obs) and the card's calibration table
# ---------------------------------------------------------------------------

def dag_pairs(graph):
    """(kind, tier) -> tasks of the DAG, and kind -> tasks."""
    pairs, kinds = {}, {}
    for t in graph.tasks:
        pairs[(t.kind, t.tier)] = pairs.get((t.kind, t.tier), 0) + 1
        kinds[t.kind] = kinds.get(t.kind, 0) + 1
    return pairs, kinds


def task_metric_failures(snap, report, graph):
    """Where the runtime's task metrics in a recorder snapshot miss the DAG
    and the report: sched.tasks.{kind} the DAG's count of the kind; each
    sched.task.{kind}.{tier} histogram the DAG's count of the pair, its
    total the report's durations of the pair summed (within 1e-9 s a
    task)."""
    pairs, kinds = dag_pairs(graph)
    out = []
    counters = {k[len("sched.tasks."):]: v for k, v in snap["counters"].items()
                if k.startswith("sched.tasks.")}
    if counters != kinds:
        out.append(f"sched.tasks: {counters}, the DAG's {kinds}")
    sums = {}
    for ev in report.events:
        sums[(ev.kind, ev.tier)] = sums.get((ev.kind, ev.tier), 0.0) + (
            ev.end - ev.start) * 1e-6
    hists = {tuple(k.split(".")[2:]): h for k, h in snap["histograms"].items()
             if k.startswith("sched.task.")}
    if set(hists) != set(pairs):
        out.append(f"sched.task pairs {sorted(hists)}, the DAG's {sorted(pairs)}")
    for pair, count in pairs.items():
        h = hists.get(pair)
        if h is None:
            continue
        if h["count"] != count:
            out.append(f"sched.task.{'.'.join(pair)}: {h['count']} samples, "
                       f"{count} tasks")
        if abs(h["total"] - sums[pair]) > 1e-9 * count:
            out.append(f"sched.task.{'.'.join(pair)}: total {h['total']} s, "
                       f"the report's {sums[pair]} s")
    return out


def tasks_outside_execute(trace, skew_us):
    """Scheduler tasks (pid 0) of a merged trace that do not lie inside the
    sched.execute span (pid 1) widened by skew_us at each end."""
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    (ex,) = [e for e in xs if e["pid"] == 1 and e["name"] == "sched.execute"]
    lo, hi = ex["ts"] - skew_us, ex["ts"] + ex["dur"] + skew_us
    return [e["name"] for e in xs
            if e["pid"] == 0 and not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi)]


def t0_skew_us(reps):
    """How far the host clock taken just before an event is recorded on an
    idle stream can be from the event's device time: the host's wait from
    taking the clock to that event's completion (the launch latency), in
    us, over `reps` tries (median, max)."""
    import torch
    out = []
    for _ in range(reps):
        ev = torch.cuda.Event(enable_timing=True)
        torch.cuda.current_stream().synchronize()
        h0 = time.perf_counter()
        ev.record()
        ev.synchronize()
        out.append((time.perf_counter() - h0) * 1e6)
    return statistics.median(out), max(out)


def obs_calibration(ocfg, results):
    """15 (a): the calibrator on the card against the committed table."""
    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.costmodel import CALIBRATION_PATH
    from repro_torch.obs.calibrate import (cost_key, measure_kernel_times,
                                           write_calibration)
    from repro_torch.sched.runtime import build_graph
    p, nb, reps = ocfg["cal_p"], ocfg["cal_nb"], ocfg["cal_reps"]
    graph = build_graph("tile", p, PrecisionPolicy.tpu(2))
    keys = {cost_key(t) for t in graph.tasks}
    n_potrf = sum(t.kind == "POTRF" for t in graph.tasks)
    reset_launch_counts()
    t0 = time.perf_counter()
    costs, meta = measure_kernel_times(nb=nb, p=p, reps=reps, device="cuda")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    require(set(costs) == keys, f"calibration keys {sorted(costs)}, the "
            f"DAG's {sorted(keys)}")
    want = {k: 0 for k in counts}
    want["blocked_potrf"] = n_potrf * (reps + 1)      # a warm-up + reps
    require(counts == want, f"calibration launches {counts}, expected {want}")
    require(meta["max_enqueue_us"] < meta["spin_us"],
            f"a task took {meta['max_enqueue_us']} us to enqueue, longer "
            f"than the {meta['spin_us']} us spin it hides behind")
    committed = json.loads(CALIBRATION_PATH.read_text())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = write_calibration(costs, meta, out_dir / "phase15_calibration.json")
    require(path.resolve() != CALIBRATION_PATH.resolve(), "wrote over the "
            "committed table")
    for key in sorted(costs):
        was = committed["costs"].get(key)
        emit(phase="obs", step="calibration", key=key, us=costs[key],
             committed_us=was, ratio=costs[key] / was if was else None)
    emit(phase="obs", step="calibration", p=p, nb=nb, reps=reps,
         seconds=seconds, launches=counts, meta=meta,
         committed_meta=committed["meta"])
    return counts["blocked_potrf"]


def obs_trace(ocfg):
    """15 (b): the demo trace on the card with telemetry on."""
    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs.__main__ import demo_trace
    from repro_torch.obs.export import summary_table
    from repro_torch.sched.config import SchedConfig
    from repro_torch.sched.runtime import build_graph, simulate
    p, nb, workers = ocfg["trace_p"], ocfg["trace_nb"], ocfg["workers"]
    graph = build_graph("tile", p, PrecisionPolicy.tpu(2))
    skew_med, skew_max = t0_skew_us(ocfg["skew_reps"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    rec, report, trace = demo_trace(p=p, nb=nb, workers=workers,
                                    out=out_dir / "phase15_merged_trace.json",
                                    device="cuda")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update(blocked_potrf=2 * p, mp_syrk=p - 1)   # eager, then scheduled
    require(counts == want, f"demo trace launches {counts}, expected {want}")
    snap = rec.snapshot()
    bad = task_metric_failures(snap, report, graph)
    require(not bad, "; ".join(bad))
    outside = tasks_outside_execute(trace, skew_max)
    require(not outside, f"{len(outside)} tasks outside sched.execute, e.g. "
            f"{outside[:3]}")
    names = sorted(s.name for s in snap["spans"])
    require(names == ["core.tile_cholesky", "demo.engine_pass",
                      "demo.scheduled_pass", "sched.execute"],
            f"demo trace spans {names}")
    sim = simulate(graph, SchedConfig(backend="sim", workers=workers,
                                      priority="critical_path",
                                      calibrated=True))
    print(summary_table(rec), flush=True)
    emit(phase="obs", step="trace", p=p, nb=nb, workers=workers,
         tasks=report.n_tasks, seconds=seconds, launches=counts,
         skew_us_median=skew_med, skew_us_max=skew_max,
         measured_makespan_us=report.makespan, simulated_makespan_us=sim.makespan,
         measured_over_simulated=report.makespan / sim.makespan,
         utilization=report.utilization, trace_events=len(trace["traceEvents"]))
    return counts


def _count_syncs():
    """A counter of torch.cuda.synchronize calls; restore with the returned
    function."""
    import torch
    real = torch.cuda.synchronize
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    torch.cuda.synchronize = counted

    def restore():
        torch.cuda.synchronize = real
    return calls, restore


def obs_main_path(ds, cfg, ocfg):
    """15 (c): phase 4's evaluation with telemetry off and on, then one
    batched loglik under recording."""
    import torch
    from repro_torch import obs
    from repro_torch.core import (BatchEngine, BatchPlan, PrecisionPolicy,
                                  geostat_loglik_step)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    p = n // nb
    policy = PrecisionPolicy.tpu(t)
    th0 = [float(v) for v in ds.theta0.tolist()]
    expected = {"blocked_potrf": p, "mp_syrk": p - 1, "matern_cov": t + 1,
                "matern_cov_grad": 0, "mp_syrk_grad": 0, "mp_attention": 0}

    def evaluate():
        return geostat_loglik_step(ds.locs, ds.z, th0, nb=nb, policy=policy,
                                   nu_static=cfg["nu"],
                                   off_update=cfg["off_update"])

    lls, secs, returned, syncs = {}, {}, {}, {}
    total = {k: 0 for k in expected}
    for mode in ("off", "on"):
        torch.cuda.synchronize()
        reset_launch_counts()
        rec = obs.Recorder()
        calls, restore = _count_syncs()
        try:
            with obs.recording(rec) if mode == "on" else contextlib.nullcontext():
                t0 = time.perf_counter()
                ll = evaluate()
                returned[mode] = time.perf_counter() - t0
                torch.cuda.synchronize()
                secs[mode] = time.perf_counter() - t0
        finally:
            restore()
        syncs[mode] = len(calls) - 1        # less the host clock's own
        lls[mode] = ll
        counts = launch_counts()
        require(counts == expected, f"telemetry {mode}: launches {counts}, "
                f"expected {expected}")
        if mode == "on":
            for k in total:
                total[k] += counts[k]
    require(syncs["off"] == 0, f"telemetry off synchronized the device "
            f"{syncs['off']} times")
    require(torch.equal(lls["on"], lls["off"]) or (
        torch.isnan(lls["on"]) and torch.isnan(lls["off"])),
        f"ll with telemetry {lls['on'].item()} != without {lls['off'].item()}")
    names = sorted(s.name for s in rec.spans)
    require(names == ["core.panel_cholesky", "core.panel_loglik_step"],
            f"spans of one evaluation: {names}")
    step = next(s for s in rec.spans if s.name == "core.panel_loglik_step")
    rel = abs(step.duration - secs["on"]) / secs["on"]
    require(rel <= ocfg["span_tol"], f"core.panel_loglik_step {step.duration} "
            f"s against {secs['on']} s on the host clock")
    print(obs.summary_table(rec), flush=True)
    print(obs.prometheus_text(rec), end="", flush=True)
    emit(phase="obs", step="main path", n=n, nb=nb, t=t,
         loglik=lls["on"].item(), seconds_off=secs["off"],
         seconds_on=secs["on"], returned_off=returned["off"],
         returned_on=returned["on"], syncs_on=syncs["on"],
         span_s=step.duration, span_rel_to_host=rel,
         panel_cholesky_s=next(s.duration for s in rec.spans
                               if s.name == "core.panel_cholesky"))

    # the batch engine's evaluation: no engine span inside it (the
    # reference jits it)
    m = ocfg["batch_n"]
    engine = BatchEngine(ds.locs[:m], ds.z[:m],
                         BatchPlan(policy=PrecisionPolicy.tpu(2),
                                   nb=ocfg["batch_nb"], nu_static=cfg["nu"]))
    thetas = [[th0[0], th0[1] * f, th0[2]]
              for f in (1.0, 0.8, 1.25, 1.5)][:ocfg["batch"]]
    reset_launch_counts()
    with obs.recording() as rec:
        t0 = time.perf_counter()
        out = engine.loglik(thetas)
        seconds = time.perf_counter() - t0
    counts = launch_counts()
    names = [s.name for s in rec.spans]
    require(names == ["batch.loglik"], f"batch spans {names}")
    require(rec.counters == {"batch.candidates": ocfg["batch"]},
            f"batch counters {rec.counters}")
    # a bf16 policy may be NaN at a candidate (PERF.md: the medium field's
    # bf16 policies at theta0); the batch must give B values, one finite
    require(out.shape == (ocfg["batch"],) and bool(torch.isfinite(out).any()),
            f"batch logliks {out.tolist()}")
    for k in total:
        total[k] += counts[k]
    emit(phase="obs", step="batch", b=ocfg["batch"], n_obs=m,
         nb=ocfg["batch_nb"], seconds=seconds, span_s=rec.spans[0].duration,
         launches=counts, logliks=out.tolist())
    return total


def observability(ds, cfg, ocfg, results):
    """Phase 15: telemetry and the calibration table (see the module
    docstring), sub-steps timed into one line."""
    import torch
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    potrf_a = step("15a calibration", obs_calibration, ocfg, results)
    trace = step("15b trace", obs_trace, ocfg)
    main = step("15c main path", obs_main_path, ds, cfg, ocfg)
    results["blocked_potrf"]["launches_obs"] = potrf_a + trace["blocked_potrf"]
    results["matern_cov"]["launches_obs"] = main["matern_cov"]
    results["mp_syrk"]["launches_obs"] = main["mp_syrk"]
    emit(phase="obs", step="seconds", **secs)


# ---------------------------------------------------------------------------
# phase 16: the static and concurrency gate (repro_torch.analysis)
# ---------------------------------------------------------------------------

def analysis_static():
    """16 (a): lint, DAG, dispatch-order replay and lockguard in-process."""
    from repro_torch.analysis import cli
    from repro_torch.analysis.baseline import load_baseline, split_baselined
    from repro_torch.analysis.concurrency.lockguard import lockguard_files
    rc = {"lint": cli.run_lint(cli.SRC_ROOT), "dag": cli.run_dag(),
          "sched_replay": cli.run_sched_replay()}
    require(not any(rc.values()), f"analysis layers failed: {rc}")
    found = lockguard_files(cli.SRC_ROOT)
    new, kept, _ = split_baselined(found, load_baseline())
    require(not new, "lockguard: " + "; ".join(f.render() for f in new))
    emit(phase="analysis", step="static", rc=rc, lockguard_findings=len(found),
         lockguard_baselined=len(kept))


def analysis_potrf_launches(cells, seeds, workers):
    """blocked_potrf launches of run_matrix on the card: one per POTRF task
    (all FAST_CELLS policies have an fp32 band) of each run and of each
    cell's in-order replay; the tile engine it is held to runs its plain
    versions at nb = 4."""
    from repro_torch.analysis.concurrency.interleave import SCHEDULES, _policies
    from repro_torch.sched.runtime import build_graph
    runs = len(workers) * (seeds + len(SCHEDULES) - 1)
    total = 0
    for variant, plabel, p in cells:
        graph = build_graph(variant, p, _policies()[plabel])
        total += sum(t.kind == "POTRF" for t in graph.tasks) * (1 + runs)
    return total


def analysis_matrix(acfg):
    """16 (b): the interleaving matrix on the card against the same call on
    the CPU."""
    import torch
    from repro_torch.analysis.cli import INTERLEAVE_DISTINCT_MIN
    from repro_torch.analysis.concurrency.interleave import FAST_CELLS, run_matrix
    from repro_torch.kernels import launch_counts, reset_launch_counts
    workers = (2, 3)
    kw = dict(seeds=acfg["seeds"], workers=workers)
    t0 = time.perf_counter()
    cpu = run_matrix(FAST_CELLS, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    card = run_matrix(FAST_CELLS, device="cuda", **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    print(card.render(), flush=True)
    want = {k: 0 for k in counts}
    want["blocked_potrf"] = analysis_potrf_launches(FAST_CELLS, acfg["seeds"],
                                                    workers)
    require(card.ok, "interleave on the card: " + "; ".join(
        (card.violations + card.mismatches)[:5]))
    require(cpu.ok, "interleave on the CPU: " + "; ".join(
        (cpu.violations + cpu.mismatches)[:5]))
    require(card.rows == cpu.rows, f"card rows {card.rows} != CPU rows {cpu.rows}")
    if acfg["seeds"] >= 12:
        require(card.n_distinct >= INTERLEAVE_DISTINCT_MIN,
                f"{card.n_distinct} distinct interleavings on the card")
    require(counts == want, f"interleave launches {counts}, expected {want}")
    emit(phase="analysis", step="interleave", runs=card.n_runs,
         distinct=card.n_distinct, seconds_cuda=card_s, seconds_cpu=cpu_s,
         launches=counts, engine_rel=list(card.engine_rel),
         engine_rel_cpu=list(cpu.engine_rel))
    return counts["blocked_potrf"]


def analysis_cli():
    """16 (c): the gate's CLI with --concurrency in a process of its own,
    on the card (its default device)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--check", "--concurrency"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    print(out.stdout, end="", flush=True)
    require(out.returncode == 0, f"python -m repro_torch.analysis --check "
            f"--concurrency exited {out.returncode}: {out.stderr[-2000:]}")
    require("static analysis: OK" in out.stdout and " on cuda," in out.stdout,
            "the CLI's matrix did not run on the card")
    emit(phase="analysis", step="cli", rc=out.returncode, seconds=seconds)


def analysis(acfg, results):
    """Phase 16: the static and concurrency gate on the card (see the module
    docstring), sub-steps timed into one line."""
    secs = {}
    t_all = time.perf_counter()

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out

    step("16a static", analysis_static)
    launches = step("16b interleave", analysis_matrix, acfg)
    step("16c cli", analysis_cli)
    results["blocked_potrf"]["launches_analysis"] = launches
    total = time.perf_counter() - t_all
    emit(phase="analysis", step="seconds", total=total, **secs)
    require(total <= acfg["limit_s"], f"phase 16 took {total} s, over its "
            f"{acfg['limit_s']} s")


# ---------------------------------------------------------------------------
# phase 17: LM training (repro_torch.train, .runtime, .checkpoint, .data)
# ---------------------------------------------------------------------------

def train_microbatches(cfg, batch: int, count: int, seq: int,
                       limit_gib: float) -> int:
    """The microbatch count for `batch` sequences: `count`, doubled (the
    microbatch halved) while the predicted peak passes limit_gib; widths
    and depth are never cut.  Raises when one sequence a microbatch does
    not fit."""
    while (plan().train_peak_bytes(cfg, batch // count, seq)
           > limit_gib * 2**30):
        if batch // count == 1:
            raise RuntimeError(f"{cfg.name}: one sequence of {seq} is "
                               f"predicted past {limit_gib} GiB")
        count *= 2
    return count


def _update_rel(got, want, start):
    """||got - want|| over ||want - start||: two updates of the same params
    against the size of the update (Adam moves a near-zero gradient's
    element by about lr either way, so an element-wise bound would have to
    allow 2 lr a step)."""
    num = sum(float(((g.cpu() - w) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float(((w - s) ** 2).sum()) for w, s in zip(want, start))
    return (num / den) ** 0.5


def train_vs_cpu(tcfg, smi):
    """17 (a): llama3.2-1b's SMOKE, fp32 compute, from one state and one
    stream on the card and on the CPU: 3 steps with 2 microbatches, then one
    with int8 compression; losses and grad norms per step, the updated
    params and moments, within TRAIN_CPU_TOL."""
    import dataclasses
    import torch
    from repro_torch.configs import LM_SMOKE_CONFIGS
    from repro_torch.data import DataConfig, SyntheticTokenSource
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import init_residual
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    cfg = LM_SMOKE_CONFIGS["llama3.2-1b"]
    tc = TrainConfig(peak_lr=1e-2, warmup=1, total_steps=10, microbatches=2,
                     compute_dtype="float32")
    steps = {"plain": make_train_step(cfg, tc), "int8": make_train_step(
        cfg, dataclasses.replace(tc, compression="int8"))}
    src = SyntheticTokenSource(cfg, DataConfig(seed=17, global_batch=4,
                                               seq_len=32), device="cpu")
    init, _ = init_train_state(torch.Generator().manual_seed(17), cfg, tc,
                               device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        state, log = _to_device(init, dev), []
        for i in range(4):
            if i == 3:
                state = dict(state, residual=init_residual(state["params"]))
            state, m = steps["int8" if i == 3 else "plain"](
                state, _to_device(src.batch_at(i), dev))
            log.append({k: float(v) for k, v in m.items()})
        out[dev] = state, log
    (s_cpu, log_cpu), (s_card, log_card) = out["cpu"], out["cuda"]
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(log_card, log_cpu))
           for k in ("loss", "grad_norm", "lr")}
    rel["update"] = _update_rel(tree_leaves(s_card["params"]),
                                tree_leaves(s_cpu["params"]),
                                tree_leaves(init["params"]))
    for k in ("m", "v"):
        rel[k] = max(float((a.cpu() - b).abs().max() / b.abs().max())
                     for a, b in zip(tree_leaves(s_card["opt"][k]),
                                     tree_leaves(s_cpu["opt"][k])))
    emit(phase="training", step="card_vs_cpu", model=cfg.name + " SMOKE",
         smi=smi, compute="float32", steps=4, microbatches=2, last_step="int8",
         losses_card=[m["loss"] for m in log_card],
         losses_cpu=[m["loss"] for m in log_cpu], rel=rel, tol=TRAIN_CPU_TOL)
    for k, tol in TRAIN_CPU_TOL.items():
        require(rel[k] <= tol, f"training SMOKE card vs CPU: {k} {rel[k]} > {tol}")
    require(int(s_card["data_step"]) == 4, "training SMOKE: data_step")


def _fp32_gemm(name: str) -> bool:
    """A cuBLAS / CUTLASS IEEE fp32 GEMM (TF32 is off), by kernel name: in
    the training path only the attention's score products are fp32."""
    low = name.lower()
    return "sgemm" in low or "f32f32_f32f32" in low or "nvjet_sss" in low


def train_full(tcfg, smi):
    """17 (b): llama3.2-1b at full width and depth (or --quick's size),
    bf16 compute, fp32 masters, train_4k's sequence length, from the
    synthetic source: each step's seconds (the last under the profiler),
    the median of steps 2 on,
    tokens/s, the peak against its prediction, model TFLOP/s beside the
    bf16 peak; the losses finite and under the first + 1.0; no kernel of
    the port launched (the training path has none)."""
    import torch
    from repro_torch.configs import LM_CONFIGS, SHAPES
    from repro_torch.data import DataConfig, SyntheticTokenSource
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train_lm import size_config
    cfg = LM_CONFIGS[tcfg["arch"]] if tcfg["size"] is None else \
        size_config(tcfg["size"]).scaled(remat=True)
    seq, batch = SHAPES["train_4k"].seq_len, tcfg["batch"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    micro = train_microbatches(cfg, batch, tcfg["microbatches"], seq,
                               tcfg["peak_gib"] - held / 2**30)
    predicted = (plan().train_peak_bytes(cfg, batch // micro, seq)
                 + held) / 2**30
    flops = plan().train_step_flops(cfg, batch, seq, remat=cfg.remat)
    emit(phase="training", step="full_predicted", model=cfg.name, smi=smi,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         tied=cfg.tie_embeddings, remat=cfg.remat,
         params=plan().train_param_count(cfg), seq=seq, global_batch=batch,
         microbatches=micro, tokens_per_step=batch * seq,
         peak_gib_predicted=predicted, held_gib=held / 2**30,
         flops_per_step=flops, flops_total=sum(flops.values()))
    tc = TrainConfig(microbatches=micro)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(170)
    state, _ = init_train_state(gen, cfg, tc, device="cuda")
    step_fn = make_train_step(cfg, tc)
    src = SyntheticTokenSource(cfg, DataConfig(seed=170, global_batch=batch,
                                               seq_len=seq), device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    seconds, losses, profile = [], [], None
    for i in range(tcfg["steps"]):
        batch_i, box = src.batch_at(i), {}

        def one_step():
            box["state"], box["m"] = step_fn(state, batch_i)
            box["loss"] = float(box["m"]["loss"])  # the step's device sync
        torch.cuda.synchronize()
        if tcfg["profile"] and i == tcfg["steps"] - 1:  # the last step
            profile = stream_profile(one_step, keep_rows=True)
            seconds.append(profile["wall_ms"] / 1e3)
        else:
            t0 = time.perf_counter()
            one_step()
            seconds.append(time.perf_counter() - t0)
        state, m = box["state"], box["m"]
        losses.append(box["loss"])
        emit(phase="training", step="full_step", index=i + 1, smi=smi,
             seconds=seconds[-1], loss=losses[-1],
             grad_norm=float(m["grad_norm"]), lr=float(m["lr"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(seconds[1:])
    total = sum(flops.values())
    if profile is not None:
        rows = profile.pop("rows")
        fp32 = sum(ms for name, _, ms in rows if _fp32_gemm(name))
        profile["fp32_gemm_ms"] = fp32
        profile["fp32_gemm_share"] = fp32 / profile["device_busy_ms"]
        profile["fp32_gemm_kernels"] = sorted(
            {name[:80] for name, _, _ in rows if _fp32_gemm(name)})
    MEASURED["17b"] = dict(cfg=cfg, batch=batch, seq=seq, micro=micro,
                           seconds=median, peak_gib=peak,
                           held_gib=held / 2**30, predicted_gib=predicted,
                           flops=flops)
    emit(phase="training", step="full", model=cfg.name, smi=smi,
         step_seconds=seconds, median_s_steps_2_on=median,
         tokens_per_s=batch * seq / median, peak_gib=peak,
         peak_gib_predicted=predicted, model_tflops=total / median / 1e12,
         bf16_peak_tflops=BF16_FLOPS / 1e12,
         model_tflops_without_remat=(total - flops["remat"]) / median / 1e12,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         launches=counts, profile=profile)
    require(all(math.isfinite(x) for x in losses), f"training losses {losses}")
    require(max(losses) < losses[0] + 1.0,
            f"training loss rose past the first + 1.0: {losses}")
    require(not any(counts.values()),
            f"the training path launched a kernel of the port: {counts}")
    require(peak < 80.0, f"training peak {peak} GiB")
    del state
    torch.cuda.empty_cache()


def train_loop(tcfg, smi):
    """17 (c): train_lm's size through FaultTolerantLoop on the card with
    injected failures: the restarts, data_step, finite losses, each save's
    bytes and seconds, and the final checkpoint restored bit for bit."""
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data import DataConfig, SyntheticTokenSource
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import (FaultTolerantLoop, LoopConfig,
                                     make_failure_injector)
    from repro_torch.runtime import fault_tolerance
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train_lm import size_config
    cfg = size_config(tcfg["loop_size"])
    steps = tcfg["loop_steps"]
    tc = TrainConfig(peak_lr=1e-3, warmup=max(10, steps // 20),
                     total_steps=steps)  # train_lm's
    gen = torch.Generator(device="cuda").manual_seed(171)
    state, _ = init_train_state(gen, cfg, tc, device="cuda")
    src = SyntheticTokenSource(cfg, DataConfig(
        seed=171, global_batch=tcfg["loop_batch"], seq_len=tcfg["loop_seq"]),
        device="cuda")
    saves, restores = [], []
    save, restore = ckpt.save, ckpt.restore

    def timed_save(ckpt_dir, step, st, **kw):
        t0 = time.perf_counter()
        fut = save(ckpt_dir, step, st, **kw)
        snap = time.perf_counter() - t0

        def done(f):
            path = f.result()
            saves.append(dict(step=step, snapshot_s=snap,
                              seconds=time.perf_counter() - t0,
                              bytes=sum(os.path.getsize(os.path.join(path, x))
                                        for x in os.listdir(path))))
        fut.add_done_callback(done)
        return fut

    def timed_restore(*args, **kw):
        t0 = time.perf_counter()
        out = restore(*args, **kw)
        torch.cuda.synchronize()
        restores.append(dict(step=args[1], seconds=time.perf_counter() - t0))
        return out

    with tempfile.TemporaryDirectory() as d:
        fault_tolerance.ckpt.save = timed_save
        fault_tolerance.ckpt.restore = timed_restore
        try:
            loop = FaultTolerantLoop(
                LoopConfig(ckpt_dir=d, ckpt_every=tcfg["ckpt_every"],
                           max_steps=steps), make_train_step(cfg, tc), src,
                state, failure_injector=make_failure_injector(tcfg["fail_at"]))
            t0 = time.perf_counter()
            final = loop.run()
            run_s = time.perf_counter() - t0
        finally:
            fault_tolerance.ckpt.save = save
            fault_tolerance.ckpt.restore = restore
        last = ckpt.latest_step(d)
        back = ckpt.restore(d, last, final)
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(final), tree_leaves(back)))
    losses = [m["loss"] for m in loop.metrics_log]
    emit(phase="training", step="loop", model=cfg.name, smi=smi,
         params=plan().train_param_count(cfg), batch=tcfg["loop_batch"],
         seq=tcfg["loop_seq"], steps=steps, fail_at=list(tcfg["fail_at"]),
         restarts=loop.restarts, data_step=int(final["data_step"]),
         steps_run=[m["step"] for m in loop.metrics_log], seconds=run_s,
         step_median_s=statistics.median(m["time"] for m in loop.metrics_log),
         saves=sorted(saves, key=lambda s: s["step"]), restores=restores,
         last_checkpoint=last, restored_same_bits=same,
         first_loss=losses[0], last_loss=losses[-1])
    require(loop.restarts == len(tcfg["fail_at"]), f"restarts {loop.restarts}")
    require(int(final["data_step"]) == steps and last == steps,
            f"data_step {int(final['data_step'])}, last checkpoint {last}")
    require(all(math.isfinite(x) for x in losses), f"loop losses {losses}")
    require(same, "the restored checkpoint differs from the saved state")


def training(tcfg, smi, results):
    """Phase 17: LM training on the card (see the module docstring), its
    sub-steps timed into one line."""
    import torch
    secs = {}
    t_all = time.perf_counter()
    for name, fn in (("17a card vs CPU", train_vs_cpu),
                     ("17b full width", train_full), ("17c loop", train_loop)):
        t0 = time.perf_counter()
        fn(tcfg, smi)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    for r in results.values():
        r["launches_training"] = 0  # train_full requires no launch
    total = time.perf_counter() - t_all
    emit(phase="training", step="seconds", smi=smi, total=total, **secs)
    require(total <= tcfg["limit_s"], f"phase 17 took {total} s, over its "
            f"{tcfg['limit_s']} s")


# ---------------------------------------------------------------------------
# phase 18: MoE serving (models.layers.moe through prefill and decode_step)
# ---------------------------------------------------------------------------

def moe_drop_share(counts, capacity: int) -> float:
    """A layer's share of assignments dropped at capacity: over every group
    and expert, the assignments past the first `capacity`, over all T k of
    them.  counts: (G, E) assignments per expert before the drop."""
    return float((counts - capacity).clamp(min=0).sum() / counts.sum())


@contextlib.contextmanager
def moe_routing():
    """Within: each call of the port's `moe` from forward_lm, prefill or
    decode_step appends its routing (`layers.moe_route`: the top-k experts,
    each assignment's slot or the trash, the counts before the drop, the
    capacity) to the list it yields.  The routing is computed again beside
    the call, which itself is unchanged."""
    import torch
    from repro_torch.models import layers, transformer
    log, orig = [], layers.moe

    def recorded(p, x, spec):
        with torch.no_grad():
            r = layers.moe_route(p, x, spec)
        log.append({key: r[key] for key in ("expert", "slot", "counts",
                                            "capacity")})
        return orig(p, x, spec)
    transformer.moe = recorded  # every FFN goes through transformer._ffn
    try:
        yield log
    finally:
        transformer.moe = orig


def _same_routing(a, b) -> bool:
    """Two routing logs (moe_routing) with the same kept assignments: the
    same experts and slots in every layer (on any devices)."""
    import torch
    return len(a) == len(b) and all(
        x["capacity"] == y["capacity"]
        and torch.equal(x["expert"].cpu(), y["expert"].cpu())
        and torch.equal(x["slot"].cpu(), y["slot"].cpu()) for x, y in zip(a, b))


def moe_smoke_vs_cpu(mcfg, smi):
    """18 (a): each MoE SMOKE config in fp32 compute on the card and on the
    CPU, one set of weights from a seed: forward_lm's and prefill's logits
    within 1e-4 of max |logit|, the aux within MOE_AUX_TOL, the same kept
    (token, expert, slot) assignments in every layer, then `steps` decode
    steps, each run on both devices from a copy of the card's cache (each
    device rounds its own cache rows to bf16, phase 5's reason) with the
    card's greedy id: logits within 1e-4 and the same greedy ids; then one
    train step with 2 microbatches within TRAIN_CPU_TOL."""
    import torch
    from repro_torch.configs import LM_SMOKE_CONFIGS
    from repro_torch.data import DataConfig, SyntheticTokenSource
    from repro_torch.models import decode_step, forward_lm, init_lm, layers, prefill
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve_lm import _grow_cache
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    kw = dict(compute_dtype=torch.float32)
    for name in mcfg["smoke"]:
        cfg = LM_SMOKE_CONFIGS[name]
        gen = torch.Generator().manual_seed(18)
        params = {"cpu": init_lm(gen, cfg, device="cpu")}
        params["cuda"] = _to_device(params["cpu"], "cuda")
        prompt = torch.randint(0, cfg.vocab, mcfg["smoke_prompt"], generator=gen)
        out, routing, caches = {}, {}, {}
        for dev, p in params.items():
            tp = prompt.to(dev)
            with moe_routing() as log:
                logits, aux = forward_lm(p, tp, cfg, **kw)
            routing[dev] = log
            pre, caches[dev] = prefill(p, tp, cfg, **kw)
            out[dev] = dict(forward=logits.cpu(), prefill=pre.cpu(),
                            aux=float(aux))
        rel = {}
        for what in ("forward", "prefill"):
            g, w = out["cuda"][what], out["cpu"][what]
            require(bool(torch.isfinite(g).all()), f"{name} SMOKE {what}: not finite")
            rel[what] = float((g - w).abs().max() / w.abs().max())
        rel["aux"] = abs(out["cuda"]["aux"] - out["cpu"]["aux"]) / abs(out["cpu"]["aux"])
        same_routing = _same_routing(routing["cuda"], routing["cpu"])
        kept = [int((r["slot"] < cfg.moe.n_experts * r["capacity"]).sum())
                for r in routing["cuda"]]
        # exact ties on both devices: integer-valued tokens and a router in
        # quarters with experts 1 and 2 copies of expert 0 give equal logits
        # in any summation order; each device must keep the lower expert
        # first, as lax.top_k does
        tie_x = torch.randint(-1, 2, (2, 24, cfg.d_model), generator=gen).float()
        router = torch.randint(-1, 2, (cfg.d_model, cfg.moe.n_experts),
                               generator=gen).float() / 4
        router[:, 1] = router[:, 2] = router[:, 0]
        ties = {dev: [layers.moe_route({"router": router.to(dev)},
                                       tie_x.to(dev), cfg.moe)]
                for dev in ("cpu", "cuda")}
        chosen = ties["cpu"][0]["expert"]
        straddled = int((((chosen == 0) | (chosen == 1)).sum(-1) == 2)
                        .logical_and(~(chosen == 2).any(-1)).sum())
        same_ties = _same_routing(ties["cuda"], ties["cpu"])

        steps = mcfg["smoke_steps"]
        cache = _grow_cache(caches["cuda"], steps, kv_quant=False)
        tok = torch.argmax(out["cuda"]["prefill"][:, -1], dim=-1)[:, None]
        step_rel, same_ids, ids = 0.0, True, []
        for i in range(steps):
            pos = prompt.shape[1] + i
            cpu_cache = _to_device(cache, "cpu")  # a copy: the step writes it
            lc, cache = decode_step(params["cuda"], cache, tok.cuda(), pos, cfg, **kw)
            lp, _ = decode_step(params["cpu"], cpu_cache, tok, pos, cfg, **kw)
            lc = lc.cpu()
            require(bool(torch.isfinite(lc).all()), f"{name} SMOKE step: not finite")
            step_rel = max(step_rel, float((lc - lp).abs().max() / lp.abs().max()))
            tok = torch.argmax(lc[:, 0], dim=-1)[:, None]
            same_ids &= bool((tok == torch.argmax(lp[:, 0], dim=-1)[:, None]).all())
            ids.append(tok[:, 0].tolist())
        rel["decode"] = step_rel

        tc = TrainConfig(peak_lr=1e-2, warmup=1, total_steps=10, microbatches=2,
                         compute_dtype="float32")
        src = SyntheticTokenSource(cfg, DataConfig(seed=18, global_batch=4,
                                                   seq_len=32), device="cpu")
        init, _ = init_train_state(torch.Generator().manual_seed(18), cfg,
                                   tc, device="cpu")
        step_fn = make_train_step(cfg, tc)
        trained = {dev: step_fn(_to_device(init, dev), _to_device(src.batch_at(0), dev))
                   for dev in ("cpu", "cuda")}
        (s_cpu, m_cpu), (s_card, m_card) = trained["cpu"], trained["cuda"]
        train_rel = {key: abs(float(m_card[key]) - float(m_cpu[key])) / abs(float(m_cpu[key]))
                     for key in ("loss", "grad_norm", "lr")}
        train_rel["update"] = _update_rel(tree_leaves(s_card["params"]),
                                          tree_leaves(s_cpu["params"]),
                                          tree_leaves(init["params"]))
        for key in ("m", "v"):
            train_rel[key] = max(float((a.cpu() - b).abs().max() / b.abs().max())
                                 for a, b in zip(tree_leaves(s_card["opt"][key]),
                                                 tree_leaves(s_cpu["opt"][key])))
        emit(phase="moe_serving", step="card_vs_cpu", model=name + " SMOKE",
             smi=smi, compute="float32", prompt=list(prompt.shape),
             decode_steps=steps, rel=rel, tol=1e-4, aux_tol=MOE_AUX_TOL,
             aux_card=out["cuda"]["aux"], aux_cpu=out["cpu"]["aux"],
             same_routing=same_routing, kept_per_layer=kept,
             same_ties=same_ties, ties_straddling_top_k=straddled,
             assignments_per_layer=prompt.numel() * cfg.moe.top_k,
             same_ids=same_ids, ids_card=ids, train_rel=train_rel,
             train_tol=TRAIN_CPU_TOL)
        for what in ("forward", "prefill", "decode"):
            require(rel[what] <= 1e-4, f"{name} SMOKE {what}: card vs CPU {rel[what]}")
        require(rel["aux"] <= MOE_AUX_TOL, f"{name} SMOKE aux: card vs CPU {rel['aux']}")
        require(same_routing, f"{name} SMOKE: the kept assignments differ")
        require(same_ties and straddled > 0,
                f"{name}: tied experts chosen differently ({straddled} ties "
                f"straddle the top k)")
        require(same_ids, f"{name} SMOKE: greedy ids differ between the card and the CPU")
        for key, tol in TRAIN_CPU_TOL.items():
            require(train_rel[key] <= tol,
                    f"{name} SMOKE train step card vs CPU: {key} {train_rel[key]} > {tol}")


def stub_inputs(cfg, batch: int, gen, device="cuda") -> dict:
    """The stub inputs `generate` and `prefill` take beside the prompt, fp32
    standard normal from `gen`: whisper's frames (B, F, d), the vision
    stub's extra_embeds (B, n_patches, d); none for the other families."""
    import torch
    if cfg.enc_dec:
        return {"frames": torch.randn((batch, cfg.n_enc_frames, cfg.d_model),
                                      generator=gen, device=device)}
    if cfg.frontend == "vision_stub":
        return {"extra_embeds": torch.randn((batch, cfg.n_patches, cfg.d_model),
                                            generator=gen, device=device)}
    return {}


def serve_full(phase, mcfg, pcfg, smi, results):
    """18 (b), 19 (b), (c), 20 (b), (c): one model at full width, depth as
    `mcfg` cuts it (random weights from a seed, bf16 compute, fp32 params,
    the stub frames or patches fp32 standard normal) through
    serve_lm.generate, then every attention layer's served cache through
    the banded-precision attention (a sliding window's slots in position
    order, `window_in_order`; mcfg's `banded_self` False leaves the self
    caches out), and whisper's cross caches too, at mcfg's `near` where it
    has one, else pcfg's: the predicted peak (the batch halved past pcfg's
    peak_gib) beside the measured one, the recurrent state's bytes per
    sequence, prefill seconds, ms per decode step, a decode step and a
    `profile_prompt`-token prefill under the profiler (None: the whole
    prompt), two prefills of `check_prompt` tokens the same bits (the
    profiled one is the first where the prompts agree), with MoE each
    layer's share of that prefill's assignments dropped at capacity;
    exactly 2 mp_attention launches a cache and no other kernel of the
    port, the kernel against its plain version and exact attention.
    Returns the launch counts."""
    import torch
    from repro_torch.configs import LM_CONFIGS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_lm, prefill
    from repro_torch.serve_lm import banded_kv_attention, fold_banded, generate
    full = LM_CONFIGS[mcfg["arch"]]
    cfg = full.scaled(n_layers=mcfg["layers"])
    b, s, n_new = mcfg["batch"], mcfg["prompt"], mcfg["new"]
    near, blk = mcfg.get("near", pcfg["near"]), pcfg["blk"]
    attn_slots = [f"b{i}" for i, bt in enumerate(cfg.block_pattern) if bt == "attn"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    pred = plan().serve_peak_bytes(cfg, b, s, n_new)
    while b > 1 and (pred["total"] + held) / 2**30 > pcfg["peak_gib"]:
        b //= 2
        pred = plan().serve_peak_bytes(cfg, b, s, n_new)
    predicted = (pred["total"] + held) / 2**30
    emit(phase=phase, step="predicted", model=cfg.name, smi=smi,
         layers=cfg.n_layers, layers_of=full.n_layers, d_model=cfg.d_model,
         block_pattern=list(cfg.block_pattern), moe=cfg.moe is not None
         and dict(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                  d_expert=cfg.moe.d_expert), vocab=cfg.vocab,
         params=plan().train_param_count(cfg), batch=b, prompt=s, new_tokens=n_new,
         peak_gib_predicted=predicted, held_gib=held / 2**30,
         terms_gib={key: v / 2**30 for key, v in pred.items()
                    if key not in ("groups", "capacity")},
         prefill_groups=pred["groups"], prefill_capacity=pred["capacity"])
    secs = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return time.perf_counter()

    gen = torch.Generator(device="cuda").manual_seed(mcfg["seed"])
    t0 = time.perf_counter()
    params = init_lm(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    stubs = stub_inputs(cfg, b, gen)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    q = torch.randn((b * kv, g, hd), generator=gen, device="cuda")
    t0 = lap("init", t0)
    s_tot = s + (cfg.n_patches if "extra_embeds" in stubs else 0)
    length = s_tot + n_new - 1  # the last generated id is never written

    # the main path, counted: generate, then each attention layer's banded
    # attention (and each cross cache's)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    ids, cache = generate(params, cfg, prompt, n_new, stats=stats, **stubs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    MEASURED.setdefault("serve", []).append(dict(
        phase=phase, model=cfg.name, layers=cfg.n_layers, batch=b, prompt=s,
        new=n_new, peak_gib=peak, predicted_gib=predicted))
    t0 = lap("generate", t0)
    served = [(key, c, window_in_order(cache[key], c, length))
              for key in attn_slots for c in range(cfg.n_cycles)
              if mcfg.get("banded_self", True)]
    served += [("cross", c, window_in_order(cache["cross"], c, cfg.n_enc_frames))
               for c in range(cfg.n_cycles) if "cross" in cache]
    banded = [(key, c, (k_, v_, n_),
               banded_kv_attention(k_, v_, q, n_, near=near, blk=blk))
              for key, c, (k_, v_, n_) in served]
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {"matern_cov": 0, "matern_cov_grad": 0, "blocked_potrf": 0,
                "mp_syrk": 0, "mp_syrk_grad": 0, "mp_attention": 2 * len(banded)}
    require(counts == expected, f"{cfg.name} serving launches {counts}, "
            f"expected {expected}")
    require(tuple(ids.shape) == (b, n_new) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab, f"generated ids {tuple(ids.shape)}")
    state = {key: e for key, e in cache.items()
             if key not in attn_slots and key != "cross"}
    state_bytes = sum(t.numel() * t.element_size() for e in state.values()
                      for t in e.values())
    # no S in the reckoning
    require(state_bytes == plan().ssm_state_bytes(cfg, b),
            f"{cfg.name}: recurrent state {state_bytes} bytes, reckoned "
            f"{plan().ssm_state_bytes(cfg, b)}")
    require(all(bool(torch.isfinite(t.float()).all()) for e in state.values()
                for t in e.values()), f"{cfg.name}: recurrent state not finite")

    # each served cache's banded attention: the kernel against its plain
    # version (partials and merged, _attn_errors) and the main path's
    # output against exact attention
    vs_plain = vs_oracle = vs_exact = partials_rel = 0.0
    kw = dict(blk=blk, sm_scale=hd ** -0.5)
    for key, c, (layer_k, layer_v, n_), (out, exact) in banded:
        # a window's filled slots, a cross cache's frames, a full cache's
        # prompt and new rows
        rows = (n_ if "pos" in cache.get(key, {}) else cfg.n_enc_frames
                if key == "cross" else s_tot + n_new)
        require(tuple(layer_k.shape) == (b, rows, kv, hd)
                and bool(torch.isfinite(layer_k[:, :n_]).all())
                and bool(torch.isfinite(layer_v[:, :n_]).all()),
                f"{cfg.name} {key}: served cache wrong shape or not finite")
        segs, _ = fold_banded(layer_k, layer_v, n_, near=near, blk=blk)
        err = _attn_errors(q, segs, **kw)
        require(bool(torch.isfinite(out).all()), f"{cfg.name} {key}: banded not finite")
        vs_plain = max(vs_plain, err["vs_plain"], float((out - err["plain"]).abs().max()))
        vs_oracle = max(vs_oracle, err["vs_oracle"])
        partials_rel = max(partials_rel, err["partials_rel"])
        vs_exact = max(vs_exact, float((out - exact).abs().max()))
    far_blocks = {key: max(n_ - near, 0) // blk  # as fold_banded cuts them
                  for key, c, (_, _, n_), _ in banded if c == 0}
    del banded, served
    if attn_slots:
        require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                f"{cfg.name} served cache: kernel vs plain {vs_plain}, vs oracle "
                f"{vs_oracle} > {ATTN_MAX_ABS}")
        require(vs_exact < 0.05, f"{cfg.name} served cache: banded vs exact {vs_exact}")

    # one more step fills the last slot: finite logits over the full vocab
    logits, _ = decode_step(params, cache, ids[:, -1:], length, cfg)
    require(tuple(logits.shape) == (b, 1, cfg.vocab)
            and bool(torch.isfinite(logits).all()), f"{cfg.name} decode logits not finite")
    t0 = lap("checks", t0)
    # where the time goes: one decode step (rewriting the last slot) and
    # one prefill under the profiler, that prefill's logits kept
    short = prompt[:, :mcfg["profile_prompt"]]
    box, profiles = {}, {}
    for what, fn in (
            ("decode_step", lambda: decode_step(params, cache, ids[:, -1:], length, cfg)),
            ("prefill", lambda: box.update(logits=prefill(params, short, cfg,
                                                          **stubs)[0]))):
        wall_ms, busy, rows = device_profile(fn)
        profiles[what] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                              idle_share=1 - busy / wall_ms,
                              kernels=sum(c for _, c, _ in rows),
                              top=[{"name": k_[:90], "count": c, "ms": ms}
                                   for k_, c, ms in rows[:10]])
        emit(phase=phase, step="profile", model=cfg.name, what=what,
             prompt=short.shape[1] if what == "prefill" else None, smi=smi,
             **profiles[what])
        t0 = lap("profile " + what, t0)
    del cache
    torch.cuda.empty_cache()
    # a prefill twice, unprofiled but for a first that shares the profiled
    # one's tokens: the same bits (the MoE combine has no atomic add), the
    # second with each MoE layer's routing recorded
    check = prompt[:, :mcfg["check_prompt"]]
    first = (box.pop("logits") if check.shape == short.shape
             else prefill(params, check, cfg, **stubs)[0])
    with moe_routing() as log:
        again, _ = prefill(params, check, cfg, **stubs)
    same_bits = torch.equal(again, first)
    t0 = lap("second prefill", t0)
    require(bool(torch.isfinite(again).all()), f"{cfg.name} prefill logits not finite")
    shares = [moe_drop_share(r["counts"], r["capacity"]) for r in log]
    n_moe = sum(cfg.layer_is_moe(i % len(cfg.block_pattern))  # _block_init's rule
                and cfg.layer_block_type(i) in ("attn", "mamba")
                for i in range(cfg.n_layers))
    require(len(shares) == n_moe, f"routing of {len(shares)} layers, {n_moe} MoE")
    emit(phase=phase, step="full", model=cfg.name, smi=smi,
         layers=cfg.n_layers, batch=b, prompt=s, positions=s_tot, new_tokens=n_new,
         stub_inputs={key: list(x.shape) for key, x in stubs.items()},
         compute="bfloat16", seconds=secs, prefill_seconds=stats["prefill_s"],
         decode_ms_per_step=1e3 * stats["decode_s"] / stats["decode_steps"],
         peak_gib=peak, peak_gib_predicted=predicted,
         state_bytes_per_sequence=state_bytes // b,
         check_prompt=check.shape[1], second_prefill_same_bits=same_bits,
         dropped_share=shares and {"min": min(shares),
                                   "median": statistics.median(shares),
                                   "max": max(shares)},
         dropped_share_per_layer=shares,
         prefill_capacity=log[0]["capacity"] if log else None,
         ids_sha256=_ids_checksum(ids), ids_head=ids[0, :8].tolist(),
         launches=counts, far_blocks=far_blocks,
         max_abs_kernel_vs_plain=vs_plain if attn_slots else None,
         max_abs_kernel_vs_oracle=vs_oracle if attn_slots else None,
         bound=ATTN_MAX_ABS, partials_rel=partials_rel if attn_slots else None,
         max_abs_banded_vs_exact=vs_exact if attn_slots else None,
         rows=b * kv, g=g, d=hd)
    require(same_bits, f"{cfg.name} prefill: a second prefill gave other bits")
    require(peak < 80.0, f"{cfg.name} serving peak {peak} GiB")
    del params, log
    torch.cuda.empty_cache()
    if attn_slots:
        r = results["mp_attention"]
        r["max_abs_err"] = max(r["max_abs_err"], vs_plain)
    return counts


def moe_serving(mcfg, smi, results):
    """Phase 18: the MoE family on the card (see the module docstring), its
    sub-steps timed into one line."""
    import torch
    secs, counts = {}, {}
    t_all = time.perf_counter()
    for name, fn in (("18a card vs CPU", lambda: moe_smoke_vs_cpu(mcfg, smi)),
                     ("18b full width", lambda: counts.update(serve_full(
                         "moe_serving", mcfg, mcfg, smi, results)))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    for key, row in results.items():
        row["launches_moe"] = counts.get(key, 0)
    total = time.perf_counter() - t_all
    emit(phase="moe_serving", step="seconds", smi=smi, total=total, **secs)
    require(total <= mcfg["limit_s"], f"phase 18 took {total} s, over its "
            f"{mcfg['limit_s']} s")


# ---------------------------------------------------------------------------
# phase 19: recurrent serving (models.ssm through prefill and decode_step)
# ---------------------------------------------------------------------------

def _grad_norm(grads) -> float:
    return math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))


def smoke_vs_cpu(phase, seed, scfg, smi):
    """19 (a), 20 (a): each SMOKE config of scfg["smoke"] in fp32 compute on
    the card and on the CPU, one set of weights and stub inputs
    (`stub_inputs`) from a seed: forward_lm's and prefill's logits within
    1e-4 of max |logit|, then `steps` decode steps from pos = the prefill's
    length, each run on both devices from a copy of the card's cache (phase
    5's reason) with the card's greedy id: logits within 1e-4 and the same
    greedy ids; then lm_loss with remat (the sequence scans' chunk
    checkpoints taken at S = 128 for the SSMs) and its gradient within
    TRAIN_CPU_TOL's loss and grad_norm.  jamba's prompt is not a multiple
    of its mamba_chunk, so its scan pads on the card.  The CPU runs one
    intra-op thread meanwhile: with one a core its thousands of tiny ops
    took 11 s instead of about 1 (an xlstm loss on the card's host)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's tiny ops: one intra-op thread
    try:
        _smoke_vs_cpu(phase, seed, scfg, smi)
    finally:
        torch.set_num_threads(threads)


def _smoke_vs_cpu(phase, seed, scfg, smi):
    import torch
    from repro_torch.configs import LM_SMOKE_CONFIGS
    from repro_torch.models import (decode_step, encode, forward_lm, init_lm,
                                    lm_loss, prefill)
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.serve_lm import _grow_cache
    kw = dict(compute_dtype=torch.float32)
    for name in scfg["smoke"]:
        t_model = time.perf_counter()
        cfg = LM_SMOKE_CONFIGS[name]
        gen = torch.Generator().manual_seed(seed)
        params = {"cpu": init_lm(gen, cfg, device="cpu")}
        params["cuda"] = _to_device(params["cpu"], "cuda")
        prompt = torch.randint(0, cfg.vocab, scfg["smoke_prompt"], generator=gen)
        stubs = stub_inputs(cfg, prompt.shape[0], gen, device="cpu")
        require(prompt.shape[1] % cfg.mamba_chunk != 0 or "mamba" not in cfg.block_pattern,
                f"{name}: the prompt is a multiple of the mamba chunk")
        out, caches = {}, {}
        for dev, p in params.items():
            tp, st = prompt.to(dev), _to_device(stubs, dev)
            fwd = {"extra_embeds": st.get("extra_embeds")}
            if "frames" in st:
                fwd["enc_out"] = encode(p, st["frames"], cfg, **kw)
            logits, _ = forward_lm(p, tp, cfg, **fwd, **kw)
            pre, caches[dev] = prefill(p, tp, cfg, **st, **kw)
            out[dev] = dict(forward=logits.cpu(), prefill=pre.cpu())
        rel = {}
        for what in ("forward", "prefill"):
            g, w = out["cuda"][what], out["cpu"][what]
            require(bool(torch.isfinite(g).all()), f"{name} SMOKE {what}: not finite")
            rel[what] = float((g - w).abs().max() / w.abs().max())
        steps = scfg["smoke_steps"]
        s_tot = out["cpu"]["forward"].shape[1]  # the prompt and any patches
        cache = _grow_cache(caches["cuda"], steps, kv_quant=False)
        tok = torch.argmax(out["cuda"]["prefill"][:, -1], dim=-1)[:, None]
        step_rel, same_ids, ids = 0.0, True, []
        for i in range(steps):
            pos = s_tot + i
            cpu_cache = _to_device(cache, "cpu")  # a copy: the step writes it
            lc, cache = decode_step(params["cuda"], cache, tok.cuda(), pos, cfg, **kw)
            lp, _ = decode_step(params["cpu"], cpu_cache, tok, pos, cfg, **kw)
            lc = lc.cpu()
            require(bool(torch.isfinite(lc).all()), f"{name} SMOKE step: not finite")
            step_rel = max(step_rel, float((lc - lp).abs().max() / lp.abs().max()))
            tok = torch.argmax(lc[:, 0], dim=-1)[:, None]
            same_ids &= bool((tok == torch.argmax(lp[:, 0], dim=-1)[:, None]).all())
            ids.append(tok[:, 0].tolist())
        rel["decode"] = step_rel

        t_loss = time.perf_counter()
        lcfg = cfg.scaled(remat=True)
        tokens = torch.randint(0, cfg.vocab, scfg["smoke_loss"], generator=gen)
        labels = torch.randint(0, cfg.vocab, scfg["smoke_loss"], generator=gen)
        batch = {"tokens": tokens, "labels": labels}
        loss_stubs = stub_inputs(cfg, tokens.shape[0], gen, device="cpu")
        if "frames" in loss_stubs:
            batch["frames"] = loss_stubs["frames"]
        if "extra_embeds" in loss_stubs:
            batch["patches"] = loss_stubs["extra_embeds"]
        loss, norm, loss_s = {}, {}, {}
        for dev, p in params.items():
            t0 = time.perf_counter()
            leaves = tree_map(lambda x: x.clone().requires_grad_(True), p)
            value, _ = lm_loss(leaves, _to_device(batch, dev), lcfg, **kw)
            grads = torch.autograd.grad(value, tree_leaves(leaves))
            loss[dev], norm[dev] = float(value.detach()), _grad_norm(grads)
            loss_s[dev] = time.perf_counter() - t0
        train_rel = {"loss": abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"]),
                     "grad_norm": abs(norm["cuda"] - norm["cpu"]) / norm["cpu"]}
        emit(phase=phase, step="card_vs_cpu", model=name + " SMOKE",
             smi=smi, compute="float32", prompt=list(prompt.shape),
             stub_inputs={k_: list(x.shape) for k_, x in stubs.items()},
             mamba_chunk=cfg.mamba_chunk if "mamba" in cfg.block_pattern else None,
             decode_steps=steps, rel=rel, tol=1e-4, same_ids=same_ids,
             ids_card=ids, loss_tokens=list(tokens.shape), loss_card=loss["cuda"],
             loss_cpu=loss["cpu"], grad_norm_card=norm["cuda"],
             grad_norm_cpu=norm["cpu"], train_rel=train_rel,
             train_tol={k: TRAIN_CPU_TOL[k] for k in train_rel},
             seconds={"serve": t_loss - t_model, "loss": loss_s})
        for what in ("forward", "prefill", "decode"):
            require(rel[what] <= 1e-4, f"{name} SMOKE {what}: card vs CPU {rel[what]}")
        require(same_ids, f"{name} SMOKE: greedy ids differ between the card and the CPU")
        for key, value in train_rel.items():
            require(value <= TRAIN_CPU_TOL[key],
                    f"{name} SMOKE lm_loss card vs CPU: {key} {value} > {TRAIN_CPU_TOL[key]}")


def ssm_serving(scfg, smi, results):
    """Phase 19: the recurrent mixers on the card (see the module
    docstring), its sub-steps timed into one line."""
    import torch
    secs, counts = {}, {}
    t_all = time.perf_counter()
    for name, fn in (("19a card vs CPU", lambda: smoke_vs_cpu("ssm_serving", 19,
                                                              scfg, smi)),
                     ("19b xlstm", lambda: counts.update(
                         xlstm=serve_full("ssm_serving", scfg["xlstm"], scfg, smi,
                                          results))),
                     ("19c jamba", lambda: counts.update(
                         jamba=serve_full("ssm_serving", scfg["jamba"], scfg, smi,
                                          results)))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    for key, row in results.items():
        row["launches_ssm"] = sum(c.get(key, 0) for c in counts.values())
    total = time.perf_counter() - t_all
    emit(phase="ssm_serving", step="seconds", smi=smi, total=total, **secs)
    require(total <= scfg["limit_s"], f"phase 19 took {total} s, over its "
            f"{scfg['limit_s']} s")


# ---------------------------------------------------------------------------
# phase 20: the rest of the zoo (whisper's encoder and cross-attention, the
# vision stub, qwen3-4b, qwen3-32b, h2o-danube-1.8b at d_head 80)
# ---------------------------------------------------------------------------

def zoo_serving(zcfg, smi, results):
    """Phase 20: (a) the five SMOKEs card against CPU (`smoke_vs_cpu`), (b)
    whisper-tiny and (c) llava-next-34b and h2o-danube-1.8b through
    `serve_full` (see the module docstring), its sub-steps timed into one
    line."""
    import torch
    secs, counts = {}, {}
    t_all = time.perf_counter()
    steps = [("20a card vs CPU", lambda: smoke_vs_cpu("zoo_serving", 20, zcfg, smi))]
    for part, key in (("20b", "whisper"), ("20c", "llava"), ("20c", "h2o")):
        steps.append((f"{part} {key}", lambda key=key: counts.update(
            {key: serve_full("zoo_serving", zcfg[key], zcfg, smi, results)})))
    for name, fn in steps:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    for key, row in results.items():
        row["launches_zoo"] = sum(c.get(key, 0) for c in counts.values())
    total = time.perf_counter() - t_all
    emit(phase="zoo_serving", step="seconds", smi=smi, total=total, **secs,
         mp_attention_launches={k: c["mp_attention"] for k, c in counts.items()})
    require(total <= zcfg["limit_s"], f"phase 20 took {total} s, over its "
            f"{zcfg['limit_s']} s")


# ---------------------------------------------------------------------------
# phase 21: the planning layer (repro_torch.launch.dryrun, .roofline,
# .costmodel) held to what phases 4, 12 (b), 14 (b), 17 (b) and 18-20 measured
# ---------------------------------------------------------------------------

def smoke_report(name, cost):
    """A cell cost on the 1 x 1 mesh as a roofline report at the H100's
    rates."""
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import RooflineReport
    return RooflineReport(
        name=name, mesh="smoke", chips=1, flops_per_chip=cost.flops,
        bytes_per_chip=cost.hbm_bytes,
        collective_bytes_per_chip=cost.collective_bytes_per_chip,
        model_flops=cost.model_flops).finalize(H100)


def peak_held(run, got, want, smi, failures, **extra):
    """A measured peak (GiB) against its reckoning: past it by more than
    PLAN_PEAK_TOL of it fails; under it by more is reported (`loose`)."""
    rel = (got - want) / want
    if rel > PLAN_PEAK_TOL:
        failures.append(f"{run}: peak {got} GiB over its reckoning {want} "
                        f"GiB by {rel:.2%}")
    emit(phase="planning", step="peak", run=run, smi=smi, peak_gib=got,
         predicted_gib=want, rel=rel, tol=PLAN_PEAK_TOL,
         loose=rel < -PLAN_PEAK_TOL, **extra)


def bound_held(run, seconds, rep, smi, failures, **extra):
    """Measured seconds against the roofline bound max(t_compute,
    t_memory, t_collective): a bound above the measured time fails."""
    if seconds < rep.t_bound:
        failures.append(f"{run}: {seconds} s under its roofline bound "
                        f"{rep.t_bound} s")
    emit(phase="planning", step="bound", run=run, smi=smi, seconds=seconds,
         bound_s=rep.t_bound, t_compute_s=rep.t_compute,
         t_memory_s=rep.t_memory, t_collective_s=rep.t_collective,
         bottleneck=rep.bottleneck, measured_over_bound=seconds / rep.t_bound,
         **extra)


def planning(pcfg, smi, results):
    """Phase 21, rerunning nothing: (a) the whole dry-run (every applicable
    cell on (16, 16) and (2, 16, 16), in this process, reports under
    chiprun_out/phase21_dryrun/), each cell's fit against the data sheet's
    80e9 B and the card's total memory; (b) on the 1 x 1 mesh each measured
    run against its plan: phase 4's panel evaluations (geostat_cell_cost,
    square; panel_peak_bytes), 12 (b)'s sequential tile factorizations
    (geostat_dag_cost, tile), 14 (b)'s masked_full evaluation
    (plan_geostat_cell) and 17 (b)'s train step (plan_lm_cell; lm_model_flops
    beside train_step_flops): seconds at least the roofline bound, peaks
    within PLAN_PEAK_TOL of the plan (plus what the process held); the
    served peaks of 18-20 against serve_peak_bytes; (c) the phase's seconds
    (at most pcfg's limit_s)."""
    import shutil
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import H100, make_smoke_mesh
    from repro_torch.launch.roofline import lm_model_flops
    t0 = time.perf_counter()
    card = torch.cuda.get_device_properties(0).total_memory
    out_dir = ROOT / "chiprun_out" / "phase21_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    reports, failed = dryrun.run_all(["single", "multi"], str(out_dir))
    require(reports and not failed, f"the dry-run's cells failed: {failed}")
    peaks = [r.extras["peak_bytes_per_chip"] for r in reports]
    emit(phase="planning", step="dryrun", smi=smi, cells=len(reports),
         rates=H100.source, fits_80e9=sum(p <= H100.hbm_bytes for p in peaks),
         fits_card=sum(p <= card for p in peaks), card_bytes=card,
         seconds=time.perf_counter() - t0)

    failures, smoke = [], make_smoke_mesh()
    m = MEASURED.get("4")
    if m:
        rep = smoke_report("4", plan().geostat_cell_cost(
            m["n"], m["nb"], m["t"], chips=1, off_update="square"))
        want = m["held_gib"] + plan().panel_peak_bytes(
            m["n"], m["nb"], m["t"], 4, 2) / 2**30
        for i, (secs, peak) in enumerate(zip(m["seconds"], m["peak_gib"])):
            bound_held(f"4 request {i}", secs, rep, smi, failures, n=m["n"])
            peak_held(f"4 request {i}", peak, want, smi, failures)
    for label, m in MEASURED.get("12b", {}).items():
        rep = smoke_report(f"12 (b) {label}", plan().geostat_dag_cost(
            m["n"], m["nb"], m["policy"], chips=1, variant="tile"))
        bound_held(f"12 (b) {label} tile_cholesky", m["seconds"], rep, smi,
                   failures, n=m["n"])
    m = MEASURED.get("14b")
    if m:
        pl = dryrun.plan_geostat_cell("geostat_65k", smoke, "masked_full",
                                      n=m["n"])
        bound_held("14 (b) masked_full", m["seconds"],
                   dryrun.report(pl, "smoke"), smi, failures, n=m["n"])
        peak_held("14 (b) masked_full", m["peak_gib"], m["held_gib"]
                  + (pl.args["storage"] + pl.work) / 2**30, smi, failures)
    m = MEASURED.get("14d")
    if m:
        peak_held("14 (d.2) masked_full gradient", m["peak_gib"],
                  m["held_gib"] + plan().distributed_grad_peak_gib(
                      m["n"], m["nb"], m["t"], 4, 2, 2), smi, failures)
    m = MEASURED.get("17b")
    if m:
        shape = ShapeSpec("train_4k", "train", m["seq"], m["batch"])
        pl = dryrun.plan_lm_cell(m["cfg"].name, shape, smoke,
                                 microbatches=m["micro"], cfg=m["cfg"])
        bound_held("17 (b) train step", m["seconds"],
                   dryrun.report(pl, "smoke"), smi, failures,
                   lm_model_flops=lm_model_flops(m["cfg"], shape),
                   train_step_flops=sum(m["flops"].values()))
        peak_held("17 (b) train step", m["peak_gib"],
                  m["held_gib"] + pl.peak_bytes / 2**30, smi, failures)
    for m in MEASURED.get("serve", []):
        peak_held(f"{m['phase']} {m['model']}", m["peak_gib"],
                  m["predicted_gib"], smi, failures, layers=m["layers"],
                  batch=m["batch"], prompt=m["prompt"])
    secs = time.perf_counter() - t0
    emit(phase="planning", step="seconds", smi=smi, seconds=secs,
         limit_s=pcfg["limit_s"], held=sorted(MEASURED))
    require(not failures, f"phase 21: {failures}")
    require(secs <= pcfg["limit_s"], f"phase 21 took {secs} s, over its "
            f"{pcfg['limit_s']} s")


# ---------------------------------------------------------------------------
# --e2e-ab: two versions of the port, end to end, in one run on one card
# ---------------------------------------------------------------------------

E2E_REPS = 3  # timed evaluations of each, after one warm-up


def _median_seconds(fn, reps=E2E_REPS):
    """Median host seconds of fn() ending in a device sync, after a warm-up."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out), out


def e2e_times(src):
    """--e2e-src: the main evaluations of phases 4, 8.1, 9.1 and 10.1 through
    the port under `src` (a checkout's src/ directory), each from the same
    seeds and shapes as its phase: geostat_loglik_step at n = 65,536 (tpu(8),
    theta0), DP(10%) on phase 8's weak field, paper_cpu DP(10%) on phase 9's
    fp64 medium field, and dense full(fp32)'s value and gradient on phase
    8's weak field.  One JSON line of median seconds per evaluation."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    import repro_torch
    from repro_torch.configs import GEOSTAT_CONFIGS
    from repro_torch.core import (PrecisionPolicy, geostat_loglik_step,
                                  make_loglik)
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import _build
    _build.library()
    cfg = GEOSTAT_CONFIGS["geostat_65k"]
    secs, runs, peaks = {}, {}, {}

    def timed(key, fn):  # median seconds, runs and peak GiB of fn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs[key], runs[key] = _median_seconds(fn)
        peaks[key] = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = torch.Generator(device="cuda").manual_seed(0)
    ds = make_dataset(gen, cfg.n, WEAK, nu_static=cfg.nu)
    th0 = [float(v) for v in ds.theta0.tolist()]
    pol = PrecisionPolicy.tpu(cfg.diag_thick)
    timed("4", lambda: float(geostat_loglik_step(
        ds.locs, ds.z, th0, nb=cfg.nb, policy=pol, nu_static=cfg.nu,
        off_update=cfg.off_update)))
    del ds
    torch.cuda.empty_cache()
    fcfg = FIDELITY
    gen = torch.Generator(device="cuda").manual_seed(11)
    medium = _fidelity_data(gen, MEDIUM, fcfg)  # drawn first, as in phase 8
    locs, z, _, _ = _fidelity_data(gen, WEAK, fcfg)
    del medium
    torch.cuda.empty_cache()
    p = fcfg["n_obs"] // fcfg["nb"]
    fn = make_loglik(locs, z, PrecisionPolicy.from_dp_percent(p, 0.10),
                     nb=fcfg["nb"], nu_static=0.5)
    timed("8.1", lambda: float(fn(list(WEAK))))
    fn = make_loglik(locs, z, PrecisionPolicy.full(torch.float32), nu_static=0.5)

    def value_and_grad():
        th = torch.tensor(WEAK, dtype=torch.float32, requires_grad=True)
        torch.autograd.grad(fn(th), th)
    timed("10.1", value_and_grad)
    del fn, locs, z
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(16)
    locs, z, _, _ = _paper_data(gen, PAPER)
    p = PAPER["n_obs"] // PAPER["nb"]
    fn = make_loglik(locs, z, PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu"),
                     nb=PAPER["nb"], nu_static=0.5)
    timed("9.1", lambda: float(fn(list(MEDIUM))))
    emit(phase="e2e", src=str(Path(repro_torch.__file__).parents[1]),
         library=str(_build.build()), seconds=secs, runs=runs, peak_gib=peaks)


def e2e_ab(other):
    """--e2e-ab: e2e_times of the checkout at `other` and of this one in
    turns (other, this, this, other), each in a process of its own, on one
    card; each phase's seconds per evaluation beside the spread of each
    version's two processes."""
    order = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    lines = []
    for label, root in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--e2e-src",
             str(Path(root) / "src")], check=True, capture_output=True, text=True,
            timeout=900).stdout
        line = json.loads([x for x in out.splitlines() if '"e2e"' in x][-1])
        line["version"] = label
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {}
    for ph in lines[0]["seconds"]:
        by = {v: [ln["seconds"][ph] for ln in lines if ln["version"] == v]
              for v in ("other", "this")}
        spread = max(abs(a - b) / min(a, b) for a, b in by.values())
        summary[ph] = dict(other=by["other"], this=by["this"],
                           this_over_other=statistics.mean(by["this"])
                           / statistics.mean(by["other"]),
                           spread=spread, peak_gib={
                               v: max(ln["peak_gib"][ph] for ln in lines
                                      if ln["version"] == v)
                               for v in ("other", "this")})
    emit(phase="e2e_ab", other=str(other), summary=summary)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small main-path and serving shapes, no MLE: a "
                    "build-and-check run")
    ap.add_argument("--e2e-ab", metavar="DIR",
                    help="only time phases 4, 8.1, 9.1 and 10.1's evaluations "
                    "through the checkout at DIR and this one, in turns")
    ap.add_argument("--e2e-src", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    if args.e2e_src:
        e2e_times(args.e2e_src)
        return
    if args.e2e_ab:
        print(smi_line(), flush=True)
        e2e_ab(Path(args.e2e_ab).resolve())
        print(smi_line(), flush=True)
        return
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import GEOSTAT_CONFIGS
    from repro_torch.core.precision import require_ieee_fp32
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import _build

    require_ieee_fp32()
    smi = smi_line()
    print(smi, flush=True)
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    usage = ptxas_usage(lib.parent / _build.LOG_NAME, SYRK_KERNELS)
    sass = sass_counts(lib, SYRK_KERNELS)
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(ROOT)), ptxas=usage, sass=sass)
    paper_pair = [k for k in usage if k.startswith(("syrk_band_f64_dmma_kernel",
                                                    "syrk_offband_fp32_pipelined"))]
    require(len(paper_pair) == 4 and all(usage[k]["spill_stores"] == 0
                                         for k in paper_pair),
            f"the paper pair's mp_syrk kernels: {paper_pair} spill or are missing")
    dmma = {k: v for k, v in sass.items() if k.startswith("syrk_band_f64_dmma_kernel")}
    require(len(dmma) == 2 and all(v["DMMA"] > 0 and v["DFMA"] == 0 for v in dmma.values()),
            f"the fp64 band kernel is not on the fp64 tensor cores: {dmma}")
    check_syrk_grad_build(lib)
    musage = ptxas_usage(lib.parent / _build.LOG_NAME, MATERN_KERNELS, typed=True)
    msass = sass_counts(lib, MATERN_KERNELS, MATERN_SASS_OPS, typed=True)
    emit(phase="build", kernel="matern_cov", ptxas=musage, sass=msass)
    require(len(musage) == len(msass) == MATERN_INSTANTIATIONS,
            f"matern_cov kernels: {len(musage)} in ptxas, {len(msass)} in SASS")

    main_cfg = GEOSTAT_CONFIGS["geostat_65k"]  # geostat_500k with n cut
    cfg = QUICK if args.quick else dict(
        n=main_cfg.n, nb=main_cfg.nb, t=main_cfg.diag_thick, nu=main_cfg.nu,
        off_update=main_cfg.off_update)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    ds = make_dataset(gen, cfg["n"], WEAK, nu_static=cfg["nu"])
    torch.cuda.synchronize()
    emit(phase="data", n=cfg["n"], theta0=WEAK, seconds=time.perf_counter() - t0,
         z_finite=bool(torch.isfinite(ds.z).all()))
    require(bool(torch.isfinite(ds.z).all()), "simulated field is not finite")

    results, seconds = {}, {}

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t0
        return out


    p = cfg["n"] // cfg["nb"]
    locs_t = ds.locs.reshape(p, cfg["nb"], 2)
    timed("3 matern_cov", check_matern, locs_t, ds.theta0.tolist(), cfg["t"],
          cfg["nu"], results)
    timed("3 matern_cov fp64", check_matern_fp64, locs_t,
          [float(v) for v in ds.theta0.tolist()], cfg["t"], results)
    torch.cuda.empty_cache()
    timed("3 blocked_potrf", check_potrf, gen, cfg["nb"], results)
    timed("3 mp_syrk", check_syrk, gen, cfg["n"] - cfg["nb"], cfg["nb"],
          cfg["t"], results)
    timed("3 mp_syrk fp64", check_syrk_fp64, gen, cfg["n"] - cfg["nb"],
          cfg["nb"], cfg["t"], results)
    torch.cuda.empty_cache()
    timed("3b mp_attention", check_attention, gen, results)
    torch.cuda.empty_cache()

    ll_panel = timed("4 main path", main_path, ds, cfg, results)
    torch.cuda.empty_cache()
    timed("4 paper pair", main_path_paper, ds, cfg, results)
    del locs_t  # ds stays for phase 13 (its field is 0.8 MB)
    torch.cuda.empty_cache()
    timed("5 likelihood vs CPU", small_vs_cpu)
    timed("5 SMOKE LM vs CPU", smoke_lm_vs_cpu)
    if not args.quick:
        timed("6 MLE", mle)
    timed("7 serving", serving, SERVE_QUICK if args.quick else SERVE, results)
    torch.cuda.empty_cache()
    weak = timed("8 fidelity", fidelity,
                 FIDELITY_QUICK if args.quick else FIDELITY, results)
    torch.cuda.empty_cache()
    fp64_field, full64_ll = timed("9 paper pair", paper,
                       PAPER_QUICK if args.quick else PAPER, results)
    torch.cuda.empty_cache()
    timed("10 gradient", gradient, GRAD_QUICK if args.quick else GRAD, weak,
          fp64_field, results)
    torch.cuda.empty_cache()
    timed("11 accuracy", accuracy, SCALE_QUICK if args.quick else SCALE,
          results)
    torch.cuda.empty_cache()
    timed("12 runtime", runtime, RUNTIME_QUICK if args.quick else RUNTIME,
          weak, fp64_field, results)
    torch.cuda.empty_cache()
    del weak
    timed("13 panel gradient", panel_grad, ds, cfg,
          PANEL_QUICK if args.quick else PANEL, results)
    torch.cuda.empty_cache()
    timed("14 distributed", distributed, ds, cfg, fp64_field, full64_ll,
          ll_panel, DIST, PAPER_QUICK if args.quick else PAPER, results)
    torch.cuda.empty_cache()
    timed("15 telemetry", observability, ds, cfg,
          OBS_QUICK if args.quick else OBS, results)
    torch.cuda.empty_cache()
    timed("16 analysis", analysis, ANALYSIS_QUICK if args.quick else ANALYSIS,
          results)
    torch.cuda.empty_cache()
    timed("17 training", training, TRAIN_QUICK if args.quick else TRAIN, smi,
          results)
    torch.cuda.empty_cache()
    timed("18 MoE serving", moe_serving, MOE_QUICK if args.quick else MOE, smi,
          results)
    torch.cuda.empty_cache()
    timed("19 SSM serving", ssm_serving, SSM_QUICK if args.quick else SSM, smi,
          results)
    torch.cuda.empty_cache()
    timed("20 zoo serving", zoo_serving, ZOO_QUICK if args.quick else ZOO, smi,
          results)
    torch.cuda.empty_cache()
    timed("21 planning", planning, PLANNING, smi, results)
    emit(phase="seconds", **seconds)

    print(smi_line(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("launches_fidelity", "launches_paper",
                                  "launches_accuracy", "launches_sched",
                                  "launches_tiles", "launches_distributed",
                                  "launches_obs", "launches_analysis",
                                  "launches_training", "launches_moe",
                                  "launches_ssm", "launches_zoo", "ms_d80",
                                  "plain_ms_d80", "bound_ms_d80",
                                  "library_ms_d80")
         if k in r}
        for r in results.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
