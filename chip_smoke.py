#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cindm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four 1D paths through the hand-written CUDA kernels:
composed 8-body guided inverse design, training of the 2-body prior that
design composes, the analysis of priors (time composition and
classifier-free multibody composition), and the 1D baselines (forward
surrogates trained, then designed with by CEM and backprop); then path C,
multi-airfoil guided design with closed-loop BDIM scoring, and the 2D
training path and 2D baselines that feed it, which run plain PyTorch (no
TPU kernel lies on them); then the data-parallel paths under a process
group. Twenty phases; each prints one JSON line with its elapsed seconds
after a ``torch.cuda.synchronize()``:

1. device:   the card's name and nvidia-smi's name and power limit; TF32 off.
2. build:    nvcc builds ``cindm_tpu_torch/ops/csrc`` into ``.cuda_build/``;
             ptxas's register/spill lines and the tensor-core instructions
             cuobjdump finds in each kernel (HGMMA: wgmma; HMMA: mma.sync);
             the forward's stage ``conv_gn_mish_stage`` (its sixteen
             instances in each of its two files: N tile 64 or 128, tap
             window 5 or 3, with or without the projection, plain or
             saving), the
             backward's weight-gradient kernel ``wgrad`` and its two
             dgrads (``dgrad_gn_stage``, ``dgrad_x_stage``, every instance)
             must issue wgmma, no mma.sync, and spill nothing; its
             GroupNorm + Mish backward ``gn_mish_bwd`` (its three instances:
             1, 2 or 4 channels a lane's load) and its in-order sum of
             partials ``grad_reduce`` must spill nothing; the linear
             attention kernel ``linear_attention`` (one instance, 128-row
             tiles) and the resampling kernel ``resample`` (four
             instances: N tile 64 or 128, up or down) must issue wgmma, no
             mma.sync, and spill nothing.
3. kernels:  each kernel against its plain PyTorch version at the 17 block
             shapes of the flagship denoiser, folded batch 5,376 (fp32,
             max abs and max relative error <= 1e-4; also at 5,000 and at
             512, untimed), run twice (the same bits), then timed with
             CUDA events beside two bounds on an H100: fp32 on the CUDA
             cores (``bound_ms``) and the kernels' own 3xTF32 on the tensor
             cores (``bound_tc_ms``: 3 x FLOP at 495 TFLOP/s); each row
             also its stage plan (N tile, tiles, persistent CTAs, waves
             over the SMs) and its weights' layout (``stage_weights``,
             one launch for a call's weights, kept per weight version and
             N tile by ``_build.staged``) at its N tile and at the
             training batch's: bit for bit its plain version's, its ms
             and the plain version's, the bytes it moves. At each of the
             three batches, whose stages split their last, partial wave of
             tiles by K chunks over every cluster (a line ``stage_split``
             lists each launch's items, whole and split items, ranges and
             most parts of a tile), the saving instance against its plain
             version (every kept tensor, the same limits) and the autograd
             Function's cotangents against plain autograd (each within
             1e-4 of the plain one's largest entry), both run twice (the
             same bits); the split tiles' counters back at 0 after it all.
             Then the shapes of
             the later paths: the Conv1d+GN+Mish kernel at every distinct
             block of the forward model at horizon 24 and 2 (T down to 1,
             C up to 1,024) at batch 1,000, its Function fwd+bwd against
             plain autograd at batch 32 and x-only at batch 4 (every
             gradient within 1e-4 of the plain one's largest entry), and
             the fused-RTB kernel at the 1-body prior's C=4 block and the
             horizon-70 direct model's T=70 and T=35 blocks. Last the
             linear attention kernel (PreNormResidual(LinearAttentionTemporal))
             at the flagship's 8 blocks at 5,376, timed beside its 3xTF32 and
             fp32 bounds, run twice (the same bits), and within 1e-4 of its
             plain version at 5,376, 5,000 and 512, each row with its plan
             (tiles, persistent CTAs, cluster, laid-out weight bytes read
             from L2); untimed, the horizon-70 direct model's (64, 70),
             (128, 35) and (512, 35) at 512. Then the resampling kernel
             (Upsample1d, Downsample1d) at the flagship's 3 + 3 convs at
             5,376: within 1e-4 of its plain version (the cuDNN path it
             replaces: torch's strided convolution on transposed copies)
             at 5,376, 5,000 and 512, run twice (the same bits), timed
             beside that path (each launch no slower than it), its phase
             form, one cuDNN call on an input already in its layout
             (``library_ms``), its bounds (3xTF32 and fp32) and the host's
             time to issue it; each row with its plan (N tile, tiles, cluster
             items, CTAs, weight bytes) and its instance's registers,
             spills and HGMMA/HMMA; untimed at 512, the later paths' shapes
             (the direct model's T = 70 and 35, the forward model's T = 2
             and 1, a ragged N tile, 1,024 channels).
4. denoiser: the full-width TemporalUnet1D (dim 64, horizon 24) with seeded
             random weights, kernel path against plain path at batch 5,376
             (16 + 1 + 8 + 3 + 3 launches); its ms per sample at folded batches 1,344
             to 10,752 (the measurement behind ``sampling/compose.FOLD_TARGET``);
             a line ``forward_ops``: one forward at 5,376 op by op under
             torch.profiler (``tools/forward_profile.forward_ops``: device ms
             and launches by module and aten op, host issue ms), whose up
             and down groups must run the resampling kernel alone (3
             launches each, no library convolution) and its 16 blocks' time
             projections at most 4 launches (``forward_groups``).
5. design:   ``cindm_tpu_torch.cli.design_1d`` at the flagship geometry
             (B=64, 8 bodies, n_composed=2, standard-recurrence-10) on a
             20-step schedule, from those weights written as a snapshot;
             each weight laid out once per N tile, a stage kernel call's in
             one launch (``staging``: 17 launches for 43 layouts an N tile;
             the attention's 8 blocks add a launch for each wqkv and wout:
             16 launches and 16 layouts; the 3 + 3 resampling convs a
             launch each for their two phase weights' layouts);
             160 + 10 + 80 + 30 + 30 launches a reverse step.
6. grad:     the 16 blocks' autograd Function (``FusedRTB``: the kernel's
             saving forward, the backward kernel on what it saved) and the
             head's against plain autograd at batch 512 (entries beyond
             rtol = atol = 1e-4 counted per cotangent), timed with CUDA
             events beside the card's own time and the host's time to
             issue one; each backward kernel alone against its plain
             closed form on the same saved tensors (every cotangent's max
             |d| <= 1e-4 of its max |plain|), both timed beside the
             backward's bounds (3xTF32 and fp32, twice the forward's
             FLOP), and run twice: every cotangent bit-identical (the
             kernels reduce in fixed orders, the dgrads' cluster partials
             included); then one ``p_losses`` gradient of the full-width
             denoiser at batch 512, kernel path against plain path
             (every parameter's max |dg| / max |g_plain| <= 1e-3), its launch
             counts (the 8 attention blocks and the 3 + 3 resampling
             convs on their plain path under autograd: none of their
             launches), and one whole optimizer step
             timed on each path; then
             one backward pass of the 16 blocks and the head at batch 512
             through ``cindm_tpu_torch.tools.backward_profile``: each of the
             six backward kernels' device ms from torch.profiler beside its
             bound, wgrad's fp32 bound and library yardstick
             (``torch.nn.grad.conv1d_weight``, cuDNN fp32), the dgrads'
             (``torch.nn.grad.conv1d_input``, the convolution only) and
             their launches one by one (shape, grid, cluster size, ms),
             ``gn_mish_bwd``'s launches one by one (each must run at least
             132 CTAs at batch 512) beside aten's GroupNorm backward as its
             yardstick, ``grad_reduce``'s launches one by one (jobs, items,
             CTAs, ms; each at least min(items, 132) CTAs at batch 512)
             beside ``torch.sum`` over the slices as its yardstick, and the
             plan's bytes of weight-gradient partials; then ``grad_reduce``
             alone (``ops.grad_reduce``) at each of that pass's 17 job lists
             on seeded partials: bit-identical to ``grad_reduce_reference``
             (the in-order sum) and to a second run.
7. train:    ``cindm_tpu_torch.cli.train_1d`` at the configuration that
             trained the in-tree prior (batch 512, dim 64, 6,000 simulations
             generated on the card, 30% collision windows), cut only in its
             step count: 40 steps with milestones at 20 and 40, then a resume
             to step 50 with one 25-step DDIM eval; the launch counters (no
             attention or resampling launch in a training step, 8 and 3 + 3
             in each eval step),
             ``grad_reduce``'s inside the backwards among them (17 a step,
             ``_build.launch_backward.reduce_launches``); after each run's
             last optimizer step every block of the trained model, kernel
             against plain on the updated weights (each laid out anew); the
             layouts, one launch a kernel call (17 a step, 43 layouts; the
             resumed run's eval adds the attention's 16 and 16).
8. analysis: ``cindm_tpu_torch.cli.analysis_1d`` twice, on snapshots of
             seeded random weights at full width: the multibody strategies
             (8 bodies, the 2-body prior and a 1-body prior, batch 16, 16
             simulations, cf 1.4, 10 Langevin steps) and the
             time-composition strategies (a conditioned prior, 1 + 23
             frames, n_composed 2, and a horizon-70 direct model), cut only
             in the schedule (100 timesteps, t_switch 40, 25 DDIM steps):
             records finite, seconds per strategy, launches, ULA pair-window
             forwards per second.
9. baselines: ``train_1d`` for forward_model, Unet_rollout_one, GNS,
             GNS_cond_one and GNS_direct (batch 32, dim 64, 64 simulations
             generated on the card, 10-20 steps), then
             ``design_1d_baseline`` for backprop and CEM (N 1,000, Ne 100)
             over Unet, Unet_single_step, GNS_autoregress and GNS_direct,
             10 design steps each: the forward model's loss falls, every
             design objective is finite; seconds per run, CEM's model
             forwards per second; the forward surrogate's resampling convs
             launch the kernel in CEM's rollouts and take the plain path
             under autograd in training and backprop.
10. unet2d:  the full-width Unet2D (dim 64, (1, 2), 21 channels) and
             ForceUnet (dim 64, (1, 2, 4, 8)) with seeded weights on the card
             against the port's CPU run of the same weights and inputs
             (Unet2D at batch 4, ForceUnet at 24 with the input gradient of
             force_objective; 1e-4, the gradient 1e-3 of the CPU's largest
             entry); per reverse step of the design configuration (B*nb =
             48): the Unet2D forward, the ForceUnet forward + input
             gradient at 288 images, one whole guided step with its peak
             memory, host time and device busy share.
11. design2d: ``cindm_tpu_torch.cli.design_2d`` twice on snapshots of those
             weights: (a) batch 16, 3 boundaries, region partition y over
             0.2-0.8, station blobs to t = 30, standard-alpha, coeff 2e-4;
             (b) 2 boundaries, 25 guided DDIM steps, init_sep 1,
             lambda_separation 1; both on a 100-step schedule: raw output
             finite [16, nb, 64, 64, 21], (a)'s mask channel exactly 0
             outside each band, the record's keys the JAX CLI's and finite,
             no 1D kernel launched; reverse steps/s, Unet2D fwds/s, the
             seconds of sampling, post-processing and scoring.
12. bdim:    16 designs x 3 airfoils from ``data/airfoil`` (one per band of
             run (a)): the mask/offset round trip, closed-loop scoring at
             the full protocol (n 64, 60 CG iterations, 300 + 100 steps;
             finite forces, |mean drag| > 1e-3 per design), 2 designs over
             20 steps on the card against the port's CPU solver (every
             field within 1e-3 of its max magnitude), one step's card time,
             host time and launches.
13. datagen: ``data/airfoil.generate_airfoil_sims`` on the card, 16
             simulations at train_2d's test-data protocol (60 warm-up, 40
             recorded steps; the cache the later phases read), design·steps/s;
             2 simulations after 3 + 2 steps against the port's CPU run
             (geometry exact, fields 1e-4 of their max, forces 1e-3); one
             solver step at 16 designs and at ``SIM_CHUNK`` (card ms, host
             ms, design·steps/s).
14. train2d: ``cindm_tpu_torch.cli.train_2d`` at full width (Unet2D dim 64,
             (1, 2), 21 channels, batch 48, on the card's data): 20 steps,
             then a resume to 25 with ``--remat True``; losses finite,
             milestones, snapshots; each run's first step apart from its
             steady ms a step; one step at 48 with and without remat (ms,
             samples/s, peak memory, busy share), the remat gradient within
             1e-5 of the plain one with cuDNN's default algorithms and with
             its deterministic ones (beside a second plain gradient: the
             run-to-run spread), its recompute, its lower peak.
15. train_force: ``cli.train_force`` (ForceUnet dim 64 (1, 2, 4, 8), batch
             32, 50 steps): finite losses, the first step's seconds, steady
             ms a step.
16. closed_loop: ``cli.design_2d`` on what phases 14 and 15 wrote, on a
             25-step schedule: the record's keys the JAX CLI's and finite.
17. baselines2d: ``cli.train_baseline --algo fno`` and ``--algo lepde`` at
             their defaults (the save -> reload check passes, the
             experiment record has the JAX CLI's keys); FNO2d (modes 12,
             width 32) and LE-PDE (latent 160) on the card against the CPU
             (1e-4).
18. design2d_baseline: ``cli.design_2d_baseline`` for GD and CEM over both
             surrogates at 1 and 2 boundaries (5 design iterations, 40 + 10
             scoring steps), and GD over FNO once at the full 300 + 100:
             records with the JAX CLI's keys, finite; seconds of design and
             scoring.
19. multigpu: the card box has one GPU and NCCL refuses two ranks on one
             card, so no scaling is measured. (a) ``train_1d`` (the train
             phase's configuration, 5 steps) and ``design_1d`` (the
             flagship, 5 steps) with ``--n_devices 1``, a one-rank NCCL
             group: the training run equal to the run without
             ``--n_devices`` (losses and final parameters within 1e-6,
             cuDNN deterministic), the design record with the JAX keys and
             finite, 16 + 1 Function forwards and backwards a training step
             and 160 + 10 + 80 + 30 + 30 launches a design step. (b) two ranks of
             ``cindm_tpu_torch.tools.data_parallel`` on the one card over
             gloo, started with torchrun's environment, each building the
             kernels at once into one new root, against one process: the
             train step's gradient at 512 (2 x 256, within 1e-4 per
             parameter), the flagship sampler at B = 64 (2 x 32) and
             ``p_sample_loop_2d`` at 4 designs x 3 boundaries (2 x 2), 5
             steps (within 1e-3); per-rank ms beside one process's.
20. summary: the ``{"kernels": [...]}`` line (launches on the design path,
             and per path in ``launches_train``, ``launches_analysis``,
             ``launches_baselines``, ``launches_design2d``, all 0 one
             ``launches_<phase>`` for each of phases 13-18, and
             ``launches_multigpu`` (phase 19 (a), in this process) and
             ``launches_multigpu_ranks`` (phase 19 (b), per rank)), and an
             entry of its own for ``grad_reduce`` (its launches inside the
             train phase's backwards, its standalone check's numbers) and
             one for ``stage_weights`` (its launches and layouts per path,
             the layout's ms, plain ms and bytes bound at both batches' N
             tiles) and one for ``prenorm_linear_attention`` (its launches
             per path, its autograd-path calls in training, ms, plain ms and
             bounds over the flagship's 8 blocks, its rows) and one each for
             ``upsample1d`` and ``downsample1d`` (the same, over the
             flagship's three convs of the kind, with the cuDNN call's
             ``library_ms``), the nvidia-smi line, and last
             ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no ``ok`` line.
It exits non-zero at once when CUDA is unavailable or when it runs outside a
checkout of the repository. Weights and inputs are drawn from seeded
``torch.Generator``s; nothing is read from or written to ``results/`` or
``dataset/`` (the training and design runs write under ``.cuda_build/``).
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, TF32
# on the tensor cores (dense), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
TF32_PASSES = 3  # the kernels' 3xTF32: every product is three tensor-core products

FOLD_BATCH = 5376  # 3 windows x 28 body pairs x B=64: one composed denoiser call
K = 5
TOL = 1e-4  # kernel vs plain, fp32: max abs error and max error / max |plain|
ODD_BATCH = 5000  # the kernels' shapes are also checked here: an odd count of row tiles at every T
DENOISER_TOL = 1e-3  # full forward, relative to the output's max magnitude
DESIGN_ARGS = [
    "--batch_size", "64", "--compose_n_bodies", "8", "--n_composed", "2",
    "--compose_start_step", "4", "--design_guidance", "standard-recurrence-10",
]
RECURRENCE = 10
N_WINDOWS, N_PAIRS = 3, 28
TRAIN_BATCH = 512  # the batch that trained the in-tree prior
GRAD_TOL = 1e-3  # per parameter: max |g_kernel - g_plain| / max |g_plain|
GN_CTAS_BATCH = 512  # every gn_mish_bwd launch of a backward pass at this batch runs
GN_MIN_CTAS = 132  # at least this many CTAs: one an SM of the H100
# every grad_reduce launch at GN_CTAS_BATCH runs at least min(items, REDUCE_MIN_CTAS) CTAs
REDUCE_MIN_CTAS = 132
# scripts_paper/round3c_train1d.sh, cut only in its step count
TRAIN_ARGS = [
    "--batch_size", "512", "--gradient_accumulate_every", "1", "--Unet_dim", "64",
    "--rollout_steps", "24", "--conditioned_steps", "0", "--collision_frac", "0.3",
    "--n_sims", "6000", "--test_sims", "100", "--timesteps", "1000",
]
TRAIN_STEPS, TRAIN_SAVE_EVERY, RESUME_STEPS, EVAL_SAMPLE_STEPS = 40, 20, 50, 25

# The fold sizes the denoiser phase times (ms per sample) to set
# sampling/compose.FOLD_TARGET: B = 16, 32, 64, 128 of the flagship fold.
FOLD_BATCHES = (1344, 2688, 5376, 10752)
# Path A, analysis_1d at scripts_paper/multibody_analysis.sh's configuration
# (8 bodies, batch 16, 16 simulations, cf 1.4, 10 Langevin steps) and the
# time-composition comparison on a conditioned prior; only the schedule is cut.
ANALYSIS_BATCH, N_BODIES_MULTI, DIRECT_HORIZON = 16, 8, 70  # 70 = 1 + 3 x 23
ANALYSIS_CUTS = ["--timesteps", "100", "--t_switch", "40", "--sample_steps", "25"]
ANALYSIS_MULTI = ["--compose_multibodies", "8", "--batch_size", "16", "--n_sims", "16",
                  "--cf_coefficient", "1.4", "--langevin_steps", "10"]
ANALYSIS_TIME = ["--conditioned_steps", "1", "--rollout_steps", "23", "--n_composed", "2",
                 "--batch_size", "16", "--n_sims", "16"]
# Path B, scripts_paper/1d_baseline.sh: the forward surrogates trained at
# batch 32, dim 64 on the CLI's default 64 simulations, cut in their step
# counts; CEM (N 1000, Ne 100) and backprop (batch 4) design, cut in
# --max_design_steps.
BASELINE_BATCH, DESIGN_BATCH, CEM_N = 32, 4, 1000
BASELINE_TRAIN = ["--dataset", "nbody-2", "--rollout_steps", "24", "--batch_size", "32",
                  "--Unet_dim", "64", "--n_sims", "64"]
BASELINE_STEPS = {"forward_model": 20, "Unet_rollout_one": 10, "GNS": 10, "GNS_cond_one": 10,
                  "GNS_direct": 10}
DESIGN_MODELS = {"Unet": "forward_model", "Unet_single_step": "Unet_rollout_one",
                 "GNS_autoregress": "GNS_cond_one", "GNS_direct": "GNS_direct"}
STEP_MODELS = ("Unet_single_step", "GNS_autoregress")  # rolled out one step a call
DESIGN_STEPS = 10
BASELINE_DESIGN = ["--n_bodies", "2", "--rollout_steps", "23", "--N", "1000", "--Ne", "100",
                   "--Unet_dim", "64", "--max_design_steps", str(DESIGN_STEPS)]

# Path C, design_2d at scripts_paper/round5_queue2.sh:153-173's configuration
# (batch 16, 3 boundaries, region partition y over 0.2-0.8, standard-alpha,
# coeff 2e-4, closed-loop scoring), cut only in its schedule: 100 timesteps
# (from 1,000). Run (a) also holds station blobs to t = 30, so both
# inpaintings and their shared draw run; run (b) is the guided DDIM variant.
DESIGN2D_CUTS = ["--timesteps", "100"]
DESIGN2D_A = ["--batch_size", "16", "--num_boundaries", "3", "--design_guidance", "standard-alpha",
              "--coeff_ratio", "2e-4", "--evaluate", "True", "--region_partition", "y",
              "--region_band", "0.2", "0.8", "--station_until", "30"]
DESIGN2D_B = ["--batch_size", "16", "--num_boundaries", "2", "--design_guidance", "standard-alpha",
              "--coeff_ratio", "2e-4", "--evaluate", "True", "--ddim_steps", "25",
              "--init_sep", "1.0", "--lambda_separation", "1.0"]
DESIGN2D_BATCH, DESIGN2D_NB, DESIGN2D_FRAMES = 16, 3, 6
# the JAX CLI's final record (cindm_tpu/cli/design_2d.py:252-268): these keys,
# plus evaluate_designs' scalar scores when a design is valid
DESIGN2D_RECORD_KEYS = {"valid_designs", "batch_size", "num_boundaries", "lambda_overlap",
                        "lambda_separation", "init_sep", "station_until", "region_partition",
                        "ddim_steps"}
DESIGN2D_SCORE_KEYS = {"drag_min", "lift_max", "obj_min", "lift_over_drag_max", "cd_min", "cl_max"}
UNET2D_TOL = 1e-4  # card vs the port's CPU run: max |d| / max |CPU output|
FORCE_GRAD_TOL = 1e-3  # the same for the input gradient of force_objective
# the parameter counts of results/airfoil_v3/persisted_m60000.npz and
# results/force_v3/persisted_m8000.npz, the widths the repo trained
UNET2D_PARAMS, FORCE_UNET_PARAMS = 3_108_501, 14_594_818
# closed-loop scoring's protocol (cli/design_2d.py): BDIM at n 64, 60 CG
# iterations, 300 warm-up and 100 recorded steps
BDIM_N, BDIM_PROTOCOL = 64, (300, 100)
BDIM_TOL, BDIM_CHECK_STEPS = 1e-3, 20  # card vs the port's CPU solver, 2 designs

# The 2D training path and the 2D baselines, on data the card simulates: 16
# simulations at train_2d's test-data protocol (60 warm-up, 40 recorded
# steps), one solver batch; 2 of them after 3 + 2 steps against the CPU.
DATAGEN_SIMS, DATAGEN_PROTOCOL, DATAGEN_CHECK = 16, (60, 40), (2, 3, 2)
DATAGEN_TOL, DATAGEN_FORCE_TOL = 1e-4, 1e-3  # per field: max |d| / max |CPU|
# scripts_paper/2d_cindm.sh:8-20's prior (Unet2D dim 64 (1, 2), 21 channels,
# cond 2 / pred 4 / ts 4, batch 48) on those 16 simulations (64 windows),
# cut to 20 steps (milestones at 10, 20) and a resume to 25 with --remat True
TRAIN2D_ARGS = ["--cond_frames", "2", "--pred_frames", "4", "--ts", "4", "--batch_size", "48",
                "--n_sims", str(DATAGEN_SIMS), "--is_testdata", "True", "--device_data", "True"]
TRAIN2D_STEPS = (20, 10, 25)  # steps, milestone interval, resumed to
TRAIN2D_BATCH, REMAT_GRAD_TOL = 48, 1e-5  # per parameter: max |d| / max |plain|
# train_force at its architecture (ForceUnet dim 64 (1, 2, 4, 8)), batch 32, 50 steps
FORCE_ARGS = ["--batch_size", "32", "--train_num_steps", "50", "--n_sims", str(DATAGEN_SIMS),
              "--dim", "64", "--dim_mults", "1", "2", "4", "8"]
# design_2d from what train_2d and train_force wrote, on a 25-step schedule
CLOSED_LOOP_ARGS = ["--timesteps", "25", "--batch_size", "4", "--num_boundaries", "1",
                    "--n_warmup", "100", "--n_record", "20"]
# scripts_paper/2d_baseline.sh's surrogates at train_baseline's defaults (on
# the datagen phase's simulations); FNO2d modes 12 width 32 and LE-PDE latent
# 160 on the card against the CPU at batch 4
BASELINES2D_CHECK_BATCH, BASELINES2D_TOL = 4, 1e-4
# design_2d_baseline: GD and CEM (N 128, Ne 16) over both surrogates, 1 and 2
# boundaries, cut to 5 design iterations, test-data init states and 40 + 10
# scoring steps; GD over FNO at 1 boundary also at the full 300 + 100
D2B_CUTS = ["--optim_iter", "5", "--is_testdata", "True", "--n_warmup", "40", "--n_record", "10"]
D2B_FULL = ["--optim_iter", "5", "--is_testdata", "True"]
D2B_RECORD_KEYS = {"GD": {"design_method", "surrogate", "obj_first", "obj_last", "valid_designs",
                          "batch_size", "num_boundaries"},
                   "CEM": {"design_method", "surrogate", "obj_last", "valid_designs", "batch_size",
                           "num_boundaries"}}
EXPERIMENT_RECORD_KEYS = {"args", "history", "final", "time"}

# (C_in, C_out, T) of the 16 ResidualTemporalBlocks of TemporalUnet1D(horizon
# 24, transition_dim 8, dim 64), in call order, and of its head Conv1dBlock.
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)
# (C, T) of the flagship denoiser's 8 linear attentions (PreNormResidual), in call order
ATTN_SHAPES = [(64, 24), (128, 12), (256, 6), (512, 3), (512, 3), (256, 3), (128, 6), (64, 12)]
ATTN_HIDDEN = 128  # heads x dim_head
# (C, T) of the horizon-70 direct model's attention blocks (baselines/unet_forward.py)
ATTN_LONG_SHAPES = [(64, 70), (128, 35), (512, 35)]
# (kind, C, T in) of the flagship's 3 Downsample1d and 3 Upsample1d, in call order
RESAMPLE_SHAPES = [("down", 64, 24), ("down", 128, 12), ("down", 256, 6), ("up", 256, 3), ("up", 128, 6),
                   ("up", 64, 12)]
# untimed, at the training batch: the horizon-70 direct model's (T 70 -> 35 -> 70), the
# forward model's at horizon 2 (T 2 -> 1 -> 2), a ragged N tile, a 1,024-channel one, N
# tiles of 128 at 35 rows a sample
RESAMPLE_ODD_SHAPES = [("down", 64, 70), ("up", 64, 35), ("down", 64, 2), ("up", 64, 1), ("down", 40, 14),
                       ("up", 40, 7), ("down", 1024, 6), ("up", 1024, 3), ("up", 128, 35), ("down", 256, 70)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(torch, plain, kernel, reps: int = 10) -> tuple[float, float]:
    """Mean ms per call of plain and kernel, timed in turns plain, kernel,
    kernel, plain with CUDA events after a warm-up."""
    for fn in (plain, kernel):
        fn()
        fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (event_ms(torch, fn, reps) for fn in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


def host_ms(torch, fn, reps: int = 10) -> float:
    """Host ms to issue one call of ``fn``: the clock stops when the last of
    ``reps`` calls returns, before the card is waited for. Where it nears
    the same call's CUDA-event time, the host bounds the call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bounds(flops: float, nbytes: float) -> dict:
    """The fp32 bound and the 3xTF32 tensor-core bound of one kernel call."""
    fp32_ms, fp32_by = bound(flops, nbytes)
    tc_ms, tc_by = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
    return dict(bound_ms=fp32_ms, bound_by=fp32_by, bound_tc_ms=tc_ms, bound_tc_by=tc_by)


def valid_taps(T: int, k: int) -> int:
    """Taps of a k-wide, k//2-padded conv over T rows that land inside the
    sample: the padding taps multiply zeros and are no work the block needs."""
    return sum(1 for t in range(T) for j in range(k) if 0 <= t + j - k // 2 < T)


def weight_numel(w, T: int) -> int:
    """Entries of a [k, C, O] conv weight that reach the output over T rows:
    only the taps that land inside the sample for some row (at T=1 the
    centre tap alone, at T=2 three), the rest multiply padding zeros."""
    k = w.shape[0]
    live = sum(1 for j in range(k) if any(0 <= t + j - k // 2 < T for t in range(T)))
    return w.numel() // k * live


def errors(torch, got, want) -> tuple[float, float]:
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    d = float((got - want).abs().max())
    return d, d / max(float(want.abs().max()), 1e-30)


def rand_block_params(torch, g, C, O, dev, proj: bool):
    def u(shape, fan_in):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) / math.sqrt(fan_in)

    def n(shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    p = dict(w1=u((K, C, O), K * C), b1=u((O,), K * C), gs1=1 + n((O,), 0.1), gb1=n((O,), 0.1),
             w2=u((K, O, O), K * O), b2=u((O,), K * O), gs2=1 + n((O,), 0.1), gb2=n((O,), 0.1))
    if proj:
        p.update(wres=u((C, O), C), bres=u((O,), C))
    return p


def stage_fields(torch, dev, weights, C: int, O: int, T: int, batch: int, cuda: bool,
                 layout_batches: tuple[int, ...] = ()) -> dict:
    """The plan of a row's stage launches (N tile, tiles, persistent CTAs,
    waves of tiles over the SMs) and its weights' layout (``weights``: its
    [K, C_in, O] weights in launch order; ``layout_fields``) at the plan's N
    tile and, under ``layout_<batch>``, at the N tile of each of
    ``layout_batches``. The wrappers lay a call's weights out once per
    version and N tile, not per call."""
    from cindm_tpu_torch.ops import _build

    sms = _build.num_sms(dev) if cuda else _build.H100_SMS
    plan = _build.plan_stage(batch, T, C, O, 8, num_sms=sms)
    out = dict(n_tile=plan.n_tile, tiles=plan.tiles, ctas=plan.ctas, cluster=plan.cluster,
               waves=plan.items / (sms // plan.cluster), **layout_fields(torch, dev, weights, plan, cuda))
    for b in layout_batches:
        out[f"layout_{b}"] = layout_fields(torch, dev, weights, _build.plan_stage(b, T, C, O, 8, num_sms=sms), cuda)
    return out


def layout_fields(torch, dev, weights, plan, cuda: bool) -> dict:
    """A kernel call's weights laid out for ``plan``'s N tile: the bytes the
    layout must move (w read, its two planes written) and, on CUDA, the one
    launch of the stage_weights kernel that lays them out (``_build.staged``'s
    path; its launches, 1) bit for bit against ``stage_weights_reference``,
    the ms of that launch alone and of the plain version (CUDA events),
    and the launch's device ms (torch.profiler)."""
    from cindm_tpu_torch.ops import _build
    from cindm_tpu_torch.tools.forward_profile import stage_weights_ms

    nt = plan.n_tile
    out = dict(stage_weights_n_tile=nt, stage_weights_ms=None, stage_weights_device_ms=None,
               stage_weights_plain_ms=None,
               stage_weights_bytes=sum(4 * w.numel() + plan.weight_bytes(w.shape[1], w.shape[0]) for w in weights),
               stage_weights_equal=None, stage_weights_launches=None)
    if cuda:
        out["stage_weights_ms"], out["stage_weights_device_ms"] = stage_weights_ms(
            torch, _build, _build.load(), plan, weights, dev, 10)
        out["stage_weights_plain_ms"] = event_ms(
            torch, lambda: [_build.stage_weights_reference(w, nt) for w in weights], 5)
        stage = _build.WeightStage()
        got = stage.many([(w, nt) for w in weights])
        out["stage_weights_launches"] = stage.launches
        out["stage_weights_equal"] = all(
            bool(torch.equal(g, _build.stage_weights_reference(w, nt))) for g, w in zip(got, weights))
    return out


def rtb_row(torch, g, dev, C: int, O: int, T: int, batch: int, cuda: bool,
            layout_batches: tuple[int, ...] = ()) -> dict:
    """One fused-RTB shape: kernel against plain, timed beside its bounds."""
    from cindm_tpu_torch.ops import fused_rtb, fused_rtb_reference

    x = torch.randn((batch, T, C), generator=g, device=dev)
    temb = torch.randn((batch, O), generator=g, device=dev)
    p = rand_block_params(torch, g, C, O, dev, proj=C != O)
    got = fused_rtb(x, temb, **p)
    repeats = bool(torch.equal(got, fused_rtb(x, temb, **p)))
    abs_err, rel_err = errors(torch, got, fused_rtb_reference(x, temb, **p))
    plain_ms, kernel_ms = time_pair(
        torch, lambda: fused_rtb_reference(x, temb, **p), lambda: fused_rtb(x, temb, **p),
    ) if cuda else (None, None)
    taps = valid_taps(T, K)
    macs = batch * (taps * C * O + taps * O * O + (T * C * O if C != O else 0))
    n_par = sum(weight_numel(v, T) if k in ("w1", "w2") else v.numel() for k, v in p.items())
    nbytes = 4 * (x.numel() + temb.numel() + n_par + batch * T * O)
    weights = [p["w1"], p["w2"]] + ([p["wres"].view(1, C, O)] if C != O else [])
    return dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                repeats_bit_for_bit=repeats, kernel_ms=kernel_ms, plain_ms=plain_ms,
                **bounds(2 * macs, nbytes),
                **stage_fields(torch, dev, weights, C, O, T, batch, cuda, layout_batches))


def conv_row(torch, g, dev, C: int, O: int, T: int, batch: int, cuda: bool,
             layout_batches: tuple[int, ...] = ()) -> dict:
    """One Conv1d+GN+Mish shape: kernel against plain, timed beside its bounds."""
    from cindm_tpu_torch.ops import fused_conv1d_gn_mish, fused_conv1d_gn_mish_reference

    x = torch.randn((batch, T, C), generator=g, device=dev)
    p = rand_block_params(torch, g, C, O, dev, proj=False)
    args = (x, p["w1"], p["b1"], p["gs1"], p["gb1"])
    got = fused_conv1d_gn_mish(*args)
    repeats = bool(torch.equal(got, fused_conv1d_gn_mish(*args)))
    abs_err, rel_err = errors(torch, got, fused_conv1d_gn_mish_reference(*args))
    plain_ms, kernel_ms = time_pair(
        torch, lambda: fused_conv1d_gn_mish_reference(*args), lambda: fused_conv1d_gn_mish(*args),
    ) if cuda else (None, None)
    nbytes = 4 * (x.numel() + weight_numel(args[1], T) + sum(a.numel() for a in args[2:])
                  + batch * T * O)
    return dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                repeats_bit_for_bit=repeats, kernel_ms=kernel_ms, plain_ms=plain_ms,
                **bounds(2 * batch * valid_taps(T, K) * C * O, nbytes),
                **stage_fields(torch, dev, [args[1]], C, O, T, batch, cuda, layout_batches))


def conv_grad_row(torch, g, dev, C: int, O: int, T: int, batch: int, x_only: bool,
                  cuda: bool) -> dict:
    """``FusedConv1dGNMish`` fwd+bwd against plain autograd at one shape: the
    output and every gradient within TOL of the plain one's largest entry.
    ``x_only``: the parameters need no gradient (design by backprop), so the
    backward kernel runs its dx stage alone."""
    from cindm_tpu_torch.ops import fused_conv1d_gn_mish_differentiable, fused_conv1d_gn_mish_reference

    p = rand_block_params(torch, g, C, O, dev, proj=False)
    a = dict(x=torch.randn((batch, T, C), generator=g, device=dev), w=p["w1"], b=p["b1"],
             gn_scale=p["gs1"], gn_bias=p["gb1"])
    cot = torch.randn((batch, T, O), generator=g, device=dev)

    def fwd_bwd(fn):
        ts = {k: v.detach().requires_grad_(k == "x" or not x_only) for k, v in a.items()}
        out = fn(**ts)
        wrt = [ts["x"]] if x_only else list(ts.values())
        return [out.detach(), *torch.autograd.grad(out, wrt, cot)]

    got, want = fwd_bwd(fused_conv1d_gn_mish_differentiable), fwd_bwd(fused_conv1d_gn_mish_reference)
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError("Function output or gradient is not finite")
    abs_err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    rel_err = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                  for x, y in zip(got, want))
    plain_ms, kernel_ms = time_pair(
        torch, lambda: fwd_bwd(fused_conv1d_gn_mish_reference),
        lambda: fwd_bwd(fused_conv1d_gn_mish_differentiable)) if cuda else (None, None)
    macs = batch * valid_taps(T, K) * C * O
    # the weight's taps that reach the output are read; dw is written whole
    n_read = sum(weight_numel(v, T) if k == "w" else v.numel() for k, v in a.items())
    n_grad = a["x"].numel() if x_only else sum(v.numel() for v in a.values())
    # forward, dgrad (and wgrad); each input, the cotangent, the output and
    # each gradient moved once
    flops = (2 if x_only else 3) * 2 * macs
    nbytes = 4 * (n_read + 2 * cot.numel() + n_grad)
    return dict(C=C, O=O, T=T, B=batch, x_only=x_only, max_abs_err=abs_err, max_rel_err=rel_err,
                kernel_ms=kernel_ms, plain_ms=plain_ms, **bounds(flops, nbytes))


def odd_batch_errors(torch, g, dev, C: int, O: int, T: int, batch: int, head: bool) -> dict:
    """A kernel against its plain version at a second batch, untimed: its
    errors and the plan's row tiles and cluster size (an odd count of row
    tiles leaves the last cluster's partner without a tile)."""
    from cindm_tpu_torch.ops import (_build, fused_conv1d_gn_mish, fused_conv1d_gn_mish_reference,
                                     fused_rtb, fused_rtb_reference)

    x = torch.randn((batch, T, C), generator=g, device=dev)
    p = rand_block_params(torch, g, C, O, dev, proj=not head and C != O)
    if head:
        args = (x, p["w1"], p["b1"], p["gs1"], p["gb1"])
        abs_err, rel_err = errors(torch, fused_conv1d_gn_mish(*args), fused_conv1d_gn_mish_reference(*args))
    else:
        temb = torch.randn((batch, O), generator=g, device=dev)
        abs_err, rel_err = errors(torch, fused_rtb(x, temb, **p), fused_rtb_reference(x, temb, **p))
    plan = _build.plan_stage(batch, T, C, O, 8)
    return dict(B=batch, max_abs_err=abs_err, max_rel_err=rel_err, row_tiles=plan.grid[0],
                cluster=plan.cluster)


def stage_splits(C: int, O: int, T: int, batch: int, head: bool, sms: int) -> list[dict]:
    """The plan of each stage launch of a block (C -> O, then O -> O) or of
    the head at ``batch`` on ``sms`` SMs: its cluster items, those that run
    whole, those of the split tail (the last, partial wave), the ranges its
    chunks go over (one a cluster) and the most parts of a tile."""
    from cindm_tpu_torch.ops import _build

    out = []
    for c in (C,) if head else (C, O):
        p = _build.plan_stage(batch, T, c, O, 8, num_sms=sms)
        out.append(dict(C=c, O=O, T=T, B=batch, chunks=p.chunks, items=p.items, whole_items=p.whole,
                        split_items=p.tail, ranges=p.tail_clusters, max_parts=p.max_parts, ctas=p.ctas))
    return out


def saving_and_function_errors(torch, g, dev, C: int, O: int, T: int, batch: int, head: bool) -> dict:
    """The saving instance (the autograd Functions' forward: out and every
    tensor it keeps) against its plain version, max abs and max error / max
    |plain| over the tensors; the Function's output and cotangents against
    plain autograd, each within TOL of the plain one's largest entry; both
    run twice (the same bits). Untimed: the split tail's launches at
    ``batch``."""
    from cindm_tpu_torch.ops import (fused_conv1d_gn_mish_differentiable, fused_conv1d_gn_mish_reference,
                                     fused_rtb_differentiable, fused_rtb_reference)
    from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish, fused_conv1d_gn_mish_forward_saving_reference
    from cindm_tpu_torch.ops.fused_rtb import _fused_rtb, fused_rtb_forward_saving_reference

    p = rand_block_params(torch, g, C, O, dev, proj=not head and C != O)
    x = torch.randn((batch, T, C), generator=g, device=dev)
    if head:
        a = dict(x=x, w=p["w1"], b=p["b1"], gn_scale=p["gs1"], gn_bias=p["gb1"])
        save, save_ref = _conv_gn_mish, fused_conv1d_gn_mish_forward_saving_reference
        fn, plain = fused_conv1d_gn_mish_differentiable, fused_conv1d_gn_mish_reference
    else:
        a = dict(x=x, temb=torch.randn((batch, O), generator=g, device=dev), **p)
        save, save_ref = _fused_rtb, fused_rtb_forward_saving_reference
        fn, plain = fused_rtb_differentiable, fused_rtb_reference
    args = list(a.values()) if head else [a.get(n) for n in (
        "x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres")]
    cot = torch.randn((batch, T, O), generator=g, device=dev)

    def fwd_bwd(f):
        ts = {k: v.detach().requires_grad_(True) for k, v in a.items()}
        out = f(**ts)
        return [out.detach(), *torch.autograd.grad(out, list(ts.values()), cot)]

    with torch.no_grad():
        got = save(*args, 8, 1e-5, save=True)
        again = save(*args, 8, 1e-5, save=True)
        want = save_ref(*args, 8, 1e-5)
    errs = [errors(torch, x, y) for x, y in zip(got, want)]
    grads, grads_again, grads_plain = fwd_bwd(fn), fwd_bwd(fn), fwd_bwd(plain)
    grad_rel = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(grads, grads_plain))
    return dict(B=batch, saving_max_abs_err=max(e[0] for e in errs), saving_max_rel_err=max(e[1] for e in errs),
                function_max_rel_err=grad_rel,
                repeats_bit_for_bit=all(bool(torch.equal(u, v)) for u, v in zip(got, again))
                and all(bool(torch.equal(u, v)) for u, v in zip(grads, grads_again)))


def attention_inputs(torch, g, dev, C: int, T: int, batch: int) -> tuple:
    """x [batch, T, C] and the block's g, wqkv, wout, bout, seeded (uniform
    weights in +-1/sqrt(fan_in), the gain near 1)."""
    u = lambda shape, fan_in: (torch.rand(shape, generator=g, device=dev) * 2 - 1) / math.sqrt(fan_in)
    return (torch.randn((batch, T, C), generator=g, device=dev),
            1 + 0.1 * torch.randn((C,), generator=g, device=dev), u((C, 3 * ATTN_HIDDEN), C),
            u((ATTN_HIDDEN, C), ATTN_HIDDEN), 0.1 * torch.randn((C,), generator=g, device=dev))


def attention_row(torch, g, dev, C: int, T: int, batch: int, cuda: bool,
                  more: tuple[int, ...] = ()) -> dict:
    """One linear attention block (PreNormResidual(LinearAttentionTemporal)):
    the kernel against its plain version at ``batch``, run twice (the same
    bits), timed beside its bounds (the qkv and out products and both
    context contractions: 3xTF32 and fp32), and untimed at each of ``more``
    (``at_<batch>``: its errors)."""
    from cindm_tpu_torch.ops import _build, prenorm_linear_attention, prenorm_linear_attention_reference

    a = attention_inputs(torch, g, dev, C, T, batch)
    got = prenorm_linear_attention(*a)
    repeats = bool(torch.equal(got, prenorm_linear_attention(*a)))
    abs_err, rel_err = errors(torch, got, prenorm_linear_attention_reference(*a))
    plain_ms, kernel_ms = time_pair(
        torch, lambda: prenorm_linear_attention_reference(*a), lambda: prenorm_linear_attention(*a),
    ) if cuda else (None, None)
    rows = batch * T
    flops = rows * (2 * C * 4 * ATTN_HIDDEN + 4 * ATTN_HIDDEN * 32)
    nbytes = 4 * (2 * rows * C + C * 4 * ATTN_HIDDEN + 2 * C)
    b = bounds(flops, nbytes)
    row = dict(C=C, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err, repeats_bit_for_bit=repeats,
               kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b["bound_tc_ms"], bound_by=b["bound_tc_by"],
               bound_fp32_ms=b["bound_ms"], library_ms=None, flop=flops, bytes=nbytes,
               **attention_plan(_build, batch, T, C, dev, cuda))
    for other in more:
        x = attention_inputs(torch, g, dev, C, T, other)
        e = errors(torch, prenorm_linear_attention(*x), prenorm_linear_attention_reference(*x))
        row[f"at_{other}"] = dict(zip(("max_abs_err", "max_rel_err"), e), **attention_plan(_build, other, T, C,
                                                                                         dev, cuda))
    return row


def attention_plan(_build, batch: int, T: int, C: int, dev, cuda: bool) -> dict:
    """The attention launch's plan at ``batch`` on this card (the H100's 132
    SMs on the CPU): its row tiles, persistent CTAs, cluster size, the
    laid-out weight bytes it reads from L2 and its shared memory."""
    p = _build.plan_attention(batch, T, C, _build.num_sms(dev) if cuda else _build.H100_SMS)
    return dict(tiles=p.tiles, ctas=p.ctas, cluster=p.cluster, samples_a_tile=p.samples,
                weight_bytes_l2=p.weight_bytes, smem_bytes=p.smem_bytes)


def attention_errors(row: dict) -> list[dict]:
    """An attention row's errors: at its own batch, then at each other."""
    return [row] + [v for k, v in row.items() if k.startswith("at_")]


def check_attention(torch, dev, batch: int, cuda: bool, more: tuple[int, ...] = (ODD_BATCH, TRAIN_BATCH)) -> list:
    """Phase 3, the linear attention kernel at the flagship's 8 blocks: each
    within TOL of its plain version at ``batch`` and at each of ``more``
    (max abs and max error / max |plain|), the same bits twice, timed."""
    g = torch.Generator(device=dev).manual_seed(4321)
    rows = [attention_row(torch, g, dev, C, T, batch, cuda, more if cuda else ()) for C, T in ATTN_SHAPES]
    if cuda:  # the direct model's blocks, untimed: one sample of 70 a tile, three of 35
        rows += [attention_row(torch, g, dev, C, T, TRAIN_BATCH, False) | {"untimed": True}
                 for C, T in ATTN_LONG_SHAPES]
    bad = [r for r in rows if not r["repeats_bit_for_bit"]
           or not all(e["max_abs_err"] <= TOL and e["max_rel_err"] <= TOL for e in attention_errors(r))]
    if bad:
        raise AssertionError(f"attention kernel disagrees with its plain version beyond {TOL}, "
                             f"or a second run differs: {bad}")
    return rows


def resample_inputs(torch, g, dev, kind: str, C: int, T: int, batch: int) -> tuple:
    """x [batch, T, C] and an Upsample1d's (w [C, C, 4]) or a Downsample1d's
    (w [3, C, C]) weight and bias, seeded (uniform in +-1/sqrt(fan_in))."""
    fan = (4 if kind == "up" else 3) * C
    u = lambda shape: (torch.rand(shape, generator=g, device=dev) * 2 - 1) / math.sqrt(fan)
    return (torch.randn((batch, T, C), generator=g, device=dev), u((C, C, 4) if kind == "up" else (3, C, C)),
            u((C,)))


def resample_work(kind: str, C: int, T: int, batch: int) -> tuple[int, int]:
    """FLOP of a resampling conv's valid taps (up: each output phase's two
    taps but the one past its sample's end; down: three but the one before
    its start) and its bytes: x read and y written once, the weights and
    bias once."""
    if kind == "up":
        taps, t_out, wn = 2 * (2 * T - 1), 2 * T, 4 * C * C
    else:
        taps, t_out, wn = 3 * (T // 2) - 1, T // 2, 3 * C * C
    return 2 * batch * taps * C * C, 4 * (batch * (T + t_out) * C + wn + C)


def resample_row(torch, g, dev, kind: str, C: int, T: int, batch: int, cuda: bool,
                 more: tuple[int, ...] = (), timed: bool = True) -> tuple[dict, object]:
    """One resampling conv (Upsample1d or Downsample1d): the kernel against
    its plain version (torch's strided convolution on transposed copies: the
    cuDNN path it replaces) at ``batch``, run twice (the same bits), timed
    beside the plain version, the phase form, one cuDNN call on an input
    already in its layout (``library_ms``) and its bounds (3xTF32 and fp32),
    the host's time to issue it; untimed at each of ``more``; each with
    its plan. Returns the row and the kernel's call on its inputs (whose
    device time ``check_resample`` traces)."""
    import torch.nn.functional as F

    from cindm_tpu_torch.ops import _build
    from cindm_tpu_torch.ops import resample as rs

    up = kind == "up"
    kern, plain = (rs.upsample1d, rs.upsample1d_reference) if up else (rs.downsample1d, rs.downsample1d_reference)
    phase_w, phase = ((rs.upsample_phase_weights, rs.upsample1d_phase) if up
                      else (rs.downsample_phase_weights, rs.downsample1d_phase))
    x, w, b = resample_inputs(torch, g, dev, kind, C, T, batch)
    got = kern(x, w, b)
    repeats = bool(torch.equal(got, kern(x, w, b)))
    abs_err, rel_err = errors(torch, got, plain(x, w, b))
    flops, nbytes = resample_work(kind, C, T, batch)
    bd = bounds(flops, nbytes)
    row = dict(kind=kind, C=C, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
               repeats_bit_for_bit=repeats, bound_ms=bd["bound_tc_ms"], bound_by=bd["bound_tc_by"],
               bound_fp32_ms=bd["bound_ms"], flop=flops, bytes=nbytes,
               **resample_plan(_build, batch, kind, C, T, dev, cuda))
    if cuda and timed:
        xt = x.transpose(1, 2).contiguous()  # the library call's layout, made outside its time
        wt = w if up else w.permute(2, 1, 0).contiguous()
        lib = ((lambda: F.conv_transpose1d(xt, wt, b, stride=2, padding=1)) if up
               else (lambda: F.conv1d(xt, wt, b, stride=2, padding=1)))
        wa, wb = phase_w(w)
        plain_ms, kernel_ms = time_pair(torch, lambda: plain(x, w, b), lambda: kern(x, w, b))
        phase_ms, library_ms = time_pair(torch, lambda: phase(x, wa, wb, b), lib)
        row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, phase_ms=phase_ms, library_ms=library_ms,
                   host_ms=host_ms(torch, lambda: kern(x, w, b), reps=50),
                   no_slower_than_cudnn_path=kernel_ms <= plain_ms)
    call = lambda x=x, w=w, b=b: kern(x, w, b)
    for other in more:
        x, w, b = resample_inputs(torch, g, dev, kind, C, T, other)
        e = errors(torch, kern(x, w, b), plain(x, w, b))
        row[f"at_{other}"] = dict(zip(("max_abs_err", "max_rel_err"), e),
                                  **resample_plan(_build, other, kind, C, T, dev, cuda))
    return row, call


def resample_plan(_build, batch: int, kind: str, C: int, T: int, dev, cuda: bool) -> dict:
    """The resampling launch's plan at ``batch`` on this card (the H100's 132
    SMs on the CPU): its N tile, tiles, cluster items, ring stages of an
    item, split items (the last partial wave's) and the most parts of one,
    persistent CTAs, cluster size, shared memory and laid-out weight bytes."""
    p = _build.plan_resample(batch, T, C, kind == "up", _build.num_sms(dev) if cuda else _build.H100_SMS)
    return dict(n_tile=p.n_tile, tiles=p.tiles, items=p.items, stages=p.stages, split_items=p.tail,
                max_parts=p.max_parts, ctas=p.ctas, cluster=p.cluster, samples_a_tile=p.samples,
                smem_bytes=p.smem_bytes, weight_bytes=p.weight_bytes(C))


def check_resample(torch, dev, batch: int, cuda: bool, build: dict | None = None,
                   more: tuple[int, ...] = (ODD_BATCH, TRAIN_BATCH)) -> list:
    """Phase 3, the resampling kernel at the flagship's 3 Downsample1d and 3
    Upsample1d: each within TOL of its plain version at ``batch`` and at each
    of ``more`` (max abs and max error / max |plain|), the same bits twice,
    timed and no slower than the cuDNN path it replaces, beside each
    launch's own device time from torch.profiler (``device_ms``, the six in
    one trace: where the host takes longer to issue a call than the card to
    run it, back-to-back calls run at the host's pace and ``kernel_ms`` is
    that pace), and at the training batch (``at_512``: device ms in one
    trace beside the bound); each row with its instance's registers, spills and
    tensor-core instructions (``build``: the build phase's record of the
    kernel). Untimed at the later paths' shapes (RESAMPLE_ODD_SHAPES) at the
    training batch."""
    from cindm_tpu_torch.ops import resample as rs
    from cindm_tpu_torch.tools.forward_profile import stage_device_ms

    g = torch.Generator(device=dev).manual_seed(2323)
    rows, calls = zip(*(resample_row(torch, g, dev, *shape, batch, cuda, more if cuda else ())
                        for shape in RESAMPLE_SHAPES))
    rows = list(rows)
    if cuda:
        device_ms = stage_device_ms(torch, lambda: [c() for c in calls], reps=1, name="resample")
        for r, ms in zip(rows, device_ms if isinstance(device_ms, list) else [device_ms] * len(rows)):
            r["device_ms"] = ms
            r["device_x_bound"] = ms / r["bound_ms"] if isinstance(ms, float) else "not measured"
        # the six at the training batch in one trace too (the plan's N tile and split differ there)
        small = []
        for kind, C, T in RESAMPLE_SHAPES:
            kern = rs.upsample1d if kind == "up" else rs.downsample1d
            x, w, b = resample_inputs(torch, g, dev, kind, C, T, TRAIN_BATCH)
            kern(x, w, b)  # its layouts staged outside the trace
            small.append(lambda kern=kern, x=x, w=w, b=b: kern(x, w, b))
        device_ms = stage_device_ms(torch, lambda: [c() for c in small], reps=1, name="resample")
        for r, ms, shape in zip(rows, device_ms if isinstance(device_ms, list) else [device_ms] * len(rows),
                                RESAMPLE_SHAPES):
            bd = bounds(*resample_work(*shape, TRAIN_BATCH))["bound_tc_ms"]
            r.setdefault(f"at_{TRAIN_BATCH}", {}).update(
                device_ms=ms, bound_ms=bd, device_x_bound=ms / bd if isinstance(ms, float) else "not measured")
        rows += [resample_row(torch, g, dev, *shape, TRAIN_BATCH, cuda, timed=False)[0] | {"untimed": True}
                 for shape in RESAMPLE_ODD_SHAPES]
    instances = (build or {}).get("ptxas", {})
    sass = (build or {}).get("sass", {})
    for r in rows:  # its instance: resample<N tile, up>
        name = next((k for k in instances if f"resampleILi{r['n_tile']}ELb{int(r['kind'] == 'up')}E" in k), None)
        if name:
            r["instance"] = {**instances[name], **(sass.get(name, {}) if isinstance(sass, dict) else {})}
    bad = [r for r in rows if not r["repeats_bit_for_bit"] or r.get("no_slower_than_cudnn_path") is False
           or not all(e["max_abs_err"] <= TOL and e["max_rel_err"] <= TOL for e in attention_errors(r))]
    if bad:
        raise AssertionError(f"resampling kernel disagrees with its plain version beyond {TOL}, a second run "
                             f"differs, or it is slower than the cuDNN path it replaces: {bad}")
    return rows


def check_forward_groups(fo: dict) -> dict:
    """The flagship forward op by op (``forward_ops``): the up and down
    groups run the resampling kernel, 3 launches each, and no convolution of
    a library (cuDNN's or aten's); the 16 blocks' time projections take at
    most 4 launches."""
    mods = fo["modules"]
    ops = {kind: [op for k, m in mods.items() if k.split(".")[0] == kind for op in m["ops"]]
           for kind in ("up", "down")}
    out = {f"{kind}_ops": sorted(set(v)) for kind, v in ops.items()}
    out.update(up_launches=fo["groups"]["up"]["launches"], down_launches=fo["groups"]["down"]["launches"],
               rtb_time_projection_launches=fo["groups"]["rtb_time_projection"]["launches"])
    ok = (all(v and all("resample" in op and "conv" not in op.lower() for op in v) for v in ops.values())
          and out["up_launches"] == out["down_launches"] == 3 and out["rtb_time_projection_launches"] <= 4)
    if not ok:
        raise AssertionError(f"the forward's up and down groups should run the resampling kernel alone, and "
                             f"its time projections at most 4 launches: {out}")
    return out


def counters_at_zero() -> bool:
    """The split tiles' arrival counters that the wrappers keep are all 0
    (each launch leaves them so)."""
    from cindm_tpu_torch.ops import _build

    return all(int(c.abs().sum()) == 0 for c in _build.stage_work.counters())


def check_kernels(torch, dev, batch: int, cuda: bool, odd_batch: int | None = ODD_BATCH,
                  train_batch: int | None = TRAIN_BATCH) -> dict:
    """Phase 3: every flagship block shape, kernel against plain, timed on
    CUDA, and run twice (the same bits); each also checked, untimed, at
    ``odd_batch`` (its row ``odd``) and ``train_batch`` (its row
    ``train``); its weights' layout bit for bit the plain version's. At
    each of the three batches, where the stage's last, partial wave of
    tiles is split by K chunks (``split``: each launch's plan), the saving
    instance and the autograd Function too (``split_checks``); the split
    tiles' counters back at 0 after all of it."""
    from cindm_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(1234)
    at = (train_batch,) if train_batch else ()  # the layouts also at the training batch's N tiles
    rtb_rows = [rtb_row(torch, g, dev, C, O, T, batch, cuda, at) for C, O, T in RTB_SHAPES]
    head_rows = [conv_row(torch, g, dev, *HEAD_SHAPE, batch, cuda, at)]
    for key, b in (("odd", odd_batch), ("train", train_batch)):
        if b:
            for (C, O, T), r in zip(RTB_SHAPES + [HEAD_SHAPE], rtb_rows + head_rows):
                r[key] = odd_batch_errors(torch, g, dev, C, O, T, b, r is head_rows[0])
    sms = _build.num_sms(dev) if cuda else _build.H100_SMS
    splits = []
    for (C, O, T), r in zip(RTB_SHAPES + [HEAD_SHAPE], rtb_rows + head_rows):
        head = r is head_rows[0]
        for b in dict.fromkeys(b for b in (batch, odd_batch, train_batch) if b):
            splits += stage_splits(C, O, T, b, head, sms)
        if cuda:
            r["split_checks"] = [saving_and_function_errors(torch, g, dev, C, O, T, b, head)
                                 for b in dict.fromkeys(b for b in (batch, odd_batch, train_batch) if b)]
    bad = [r for r in rtb_rows + head_rows
           if not all(e["max_abs_err"] <= TOL and e["max_rel_err"] <= TOL
                      for e in (r, r.get("odd", r), r.get("train", r)))
           or not all(e["saving_max_abs_err"] <= TOL and e["saving_max_rel_err"] <= TOL
                      and e["function_max_rel_err"] <= TOL for e in r.get("split_checks", []))]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version beyond {TOL}: {bad}")
    bad = [r for r in rtb_rows + head_rows if not r["repeats_bit_for_bit"]
           or any(f["stage_weights_equal"] is False or f["stage_weights_launches"] not in (None, 1)
                  for f in layout_rows(r))
           or not all(e["repeats_bit_for_bit"] for e in r.get("split_checks", []))]
    if bad:
        raise AssertionError(f"a second run differs, or a call's weight layout from its plain version or "
                             f"not in one launch: {bad}")
    if cuda and not counters_at_zero():
        raise AssertionError("the split tiles' counters are not back at 0 after the kernels phase")
    return {"fused_rtb": rtb_rows, "fused_conv1d_gn_mish": head_rows, "stage_split": splits}


def layout_rows(row: dict) -> list[dict]:
    """A kernel row's weight-layout fields: at its batch's N tile, then at each other batch's."""
    return [row] + [v for k, v in row.items() if k.startswith("layout_")]


def conv_block_shapes(torch, model, *inputs) -> list[tuple[int, int, int]]:
    """Distinct (C, O, T) of the Conv1dBlocks one forward of ``model`` runs, in call order."""
    from cindm_tpu_torch.models.blocks import Conv1dBlock

    seen = []

    def hook(mod, args):
        x = args[0]
        shape = (x.shape[-1], mod.conv.weight.shape[-1], x.shape[1])
        if shape not in seen:
            seen.append(shape)

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, Conv1dBlock)]
    with torch.no_grad():
        model(*inputs, use_kernels=False)
    for h in hooks:
        h.remove()
    return seen


def rtb_times(model) -> list[int]:
    """The time length each ResidualTemporalBlock of a TemporalUnet1D sees, in call order."""
    T, out = model.horizon, []
    for ind in range(model.num_res):
        out += [T, T]
        T //= 2 if model.down_flags[ind] else 1
    out += [T, T]
    for ind in range(model.num_res - 1):
        out += [T, T]
        T *= 2 if model.up_flags[ind] else 1
    return out


def check_slice5_kernels(torch, dev, cuda: bool) -> dict:
    """Phase 3, the shapes of the analysis and baseline paths: the
    Conv1d+GN+Mish kernel at every distinct block of the forward model at
    horizon 24 and 2 (batch CEM_N), its Function fwd+bwd against plain
    autograd (batch 32, and x-only at batch 4); the fused-RTB kernel at the
    1-body prior's C=4 block (batch 8 x 16) and the direct model's T=70 and
    T=35 blocks (batch 16). The shapes are listed on any device; the rows
    are made only on CUDA, where the kernels run (on the CPU both sides of
    every row would be the plain version)."""
    from cindm_tpu_torch.baselines import Unet1DForwardModel
    from cindm_tpu_torch.models import TemporalUnet1D

    g = torch.Generator(device=dev).manual_seed(5678)
    shapes = {}
    for h in (24, 2):
        m = Unet1DForwardModel(h, 8, dim=64).to(dev)
        shapes[h] = conv_block_shapes(torch, m, torch.zeros((1, 1, 8), device=dev))
    conv_shapes = list(dict.fromkeys(shapes[24] + shapes[2]))
    direct = TemporalUnet1D(DIRECT_HORIZON, 8, dim=64)
    direct_shapes = [(r.block0.conv.weight.shape[1], r.block0.conv.weight.shape[2], t)
                     for r, t in zip(direct.rtbs, rtb_times(direct))]
    rtb_shapes = [(4, 64, 24, N_BODIES_MULTI * ANALYSIS_BATCH)]
    rtb_shapes += [(C, O, T, ANALYSIS_BATCH) for C, O, T in dict.fromkeys(direct_shapes)]
    listed = {"forward_model_block_shapes": {"h24": shapes[24], "h2": shapes[2]},
              "rtb_analysis_shapes": rtb_shapes}
    if not cuda:
        return {"conv_forward_model": [], "conv_function_forward_model": [], "rtb_analysis": [],
                **listed}
    conv = [conv_row(torch, g, dev, C, O, T, CEM_N, cuda) for C, O, T in conv_shapes]
    grads = [conv_grad_row(torch, g, dev, C, O, T, b, x_only, cuda)
             for C, O, T in conv_shapes
             for b, x_only in ((BASELINE_BATCH, False), (DESIGN_BATCH, True))]
    rtb = [rtb_row(torch, g, dev, C, O, T, b, cuda) for C, O, T, b in rtb_shapes]
    # forward rows: max abs and max relative error; Function rows: every
    # gradient within TOL of the plain one's largest entry (PERF.md section 2)
    bad = [r for r in conv + rtb if not (r["max_abs_err"] <= TOL and r["max_rel_err"] <= TOL)]
    bad += [r for r in grads if not r["max_rel_err"] <= TOL]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version beyond {TOL}: {bad}")
    return {"conv_forward_model": conv, "conv_function_forward_model": grads, "rtb_analysis": rtb,
            **listed}


def reset_counts():
    from cindm_tpu_torch.ops import (FusedConv1dGNMish, FusedRTB, _build, downsample1d,
                                     downsample1d_differentiable, fused_conv1d_gn_mish,
                                     fused_conv1d_gn_mish_backward, fused_rtb, fused_rtb_backward,
                                     prenorm_linear_attention, prenorm_linear_attention_differentiable,
                                     upsample1d, upsample1d_differentiable)

    _build.launch_backward.reduce_launches = 0
    _build.staged.launches = 0
    _build.staged.layouts = 0
    fused_rtb.launches = 0
    fused_conv1d_gn_mish.launches = 0
    fused_rtb_backward.launches = 0
    fused_conv1d_gn_mish_backward.launches = 0
    FusedRTB.launches = 0
    FusedRTB.backwards = 0
    FusedConv1dGNMish.launches = 0
    FusedConv1dGNMish.backwards = 0
    prenorm_linear_attention.launches = 0
    prenorm_linear_attention_differentiable.autograd_calls = 0
    upsample1d.launches = downsample1d.launches = 0
    upsample1d_differentiable.autograd_calls = downsample1d_differentiable.autograd_calls = 0


def read_counts(backwards: bool = False) -> dict:
    """The kernels' launch counters since the last reset_counts; with
    ``backwards`` also the autograd Functions' and backward kernels', and
    the attention blocks and resampling convolutions that took their plain
    path under autograd (on CUDA)."""
    from cindm_tpu_torch.ops import (FusedConv1dGNMish, FusedRTB, downsample1d, downsample1d_differentiable,
                                     fused_conv1d_gn_mish, fused_conv1d_gn_mish_backward, fused_rtb,
                                     fused_rtb_backward, prenorm_linear_attention,
                                     prenorm_linear_attention_differentiable, upsample1d,
                                     upsample1d_differentiable)

    counts = {"fused_rtb": fused_rtb.launches, "fused_conv1d_gn_mish": fused_conv1d_gn_mish.launches,
              "prenorm_linear_attention": prenorm_linear_attention.launches,
              "upsample1d": upsample1d.launches, "downsample1d": downsample1d.launches}
    if backwards:
        counts.update(FusedRTB_launches=FusedRTB.launches,
                      FusedRTB_backward_passes=FusedRTB.backwards,
                      FusedConv1dGNMish_launches=FusedConv1dGNMish.launches,
                      FusedConv1dGNMish_backward_passes=FusedConv1dGNMish.backwards,
                      fused_rtb_backward=fused_rtb_backward.launches,
                      fused_conv1d_gn_mish_backward=fused_conv1d_gn_mish_backward.launches,
                      prenorm_linear_attention_autograd=prenorm_linear_attention_differentiable.autograd_calls,
                      upsample1d_autograd=upsample1d_differentiable.autograd_calls,
                      downsample1d_autograd=downsample1d_differentiable.autograd_calls)
    return counts


def staged_launches() -> int:
    """stage_weights' launches since the last reset_counts (``_build.staged``)."""
    from cindm_tpu_torch.ops import _build

    return _build.staged.launches


def staged_counts() -> dict:
    """stage_weights' launches and the layouts they made since the last
    reset_counts (one launch lays out a kernel call's weights)."""
    from cindm_tpu_torch.ops import _build

    return {"staged_launches": _build.staged.launches, "staged_layouts": _build.staged.layouts}


def check_denoiser(torch, dev, batch: int, model, cuda: bool) -> dict:
    """Phase 4: the full forward, kernel path against plain path."""
    g = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((batch, 24, 8), generator=g, device=dev)
    t = torch.randint(0, 20, (batch,), generator=g, device=dev)
    with torch.no_grad():
        reset_counts()
        got = model(x, t)
        counts = read_counts()
        want = model(x, t, use_kernels=False)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("denoiser output is not finite")
        rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        if rel > DENOISER_TOL:
            raise AssertionError(f"denoiser kernel path vs plain: {rel} > {DENOISER_TOL}")
        if cuda and counts != {"fused_rtb": 16, "fused_conv1d_gn_mish": 1, "prenorm_linear_attention": 8,
                               "upsample1d": 3, "downsample1d": 3}:
            raise AssertionError(f"one forward should launch 16 + 1 + 8 + 3 + 3 kernels, counted {counts}")
        rec = {"max_err_over_max_abs": rel, "launches": counts, "batch": batch}
        if cuda:
            plain_ms, kernel_ms = time_pair(
                torch, lambda: model(x, t, use_kernels=False), lambda: model(x, t), reps=3
            )
            rec.update(forward_kernel_ms=kernel_ms, forward_plain_ms=plain_ms)
    return rec


def time_folds(torch, dev, model, cuda: bool) -> dict | str:
    """ms per sample of the full-width forward (kernel path) at each of
    FOLD_BATCHES, the folded batch of one composed denoiser call."""
    if not cuda:
        return "not measured"
    g = torch.Generator(device=dev).manual_seed(98)
    out = {}
    with torch.no_grad():
        for b in FOLD_BATCHES:
            x = torch.randn((b, 24, 8), generator=g, device=dev)
            t = torch.randint(0, 20, (b,), generator=g, device=dev)
            model(x, t)  # warm-up
            torch.cuda.synchronize()
            out[str(b)] = event_ms(torch, lambda: model(x, t), reps=3) / b
            del x, t
    return out


def write_snapshot(model, directory: str) -> str:
    """``model``'s weights as a persisted_m0.npz snapshot (EMA, the JAX layout)."""
    import numpy as np

    from cindm_tpu_torch.models import flax_from_params

    os.makedirs(directory, exist_ok=True)
    flat = {"['ema_params']['params']" + k: v for k, v in flax_from_params(model).items()}
    flat["['step']"] = np.asarray(0)
    np.savez(os.path.join(directory, "persisted_m0.npz"), **flat)
    return directory


def finite_leaves(obj) -> bool:
    if isinstance(obj, dict):
        return all(finite_leaves(v) for v in obj.values())
    return isinstance(obj, (int, float)) and math.isfinite(obj)


def run_analysis(torch, dev, model, cuda: bool, cuts: list[str] = ANALYSIS_CUTS,
                 multi: list[str] = ANALYSIS_MULTI, timecomp: list[str] = ANALYSIS_TIME) -> dict:
    """Path A: analysis_1d twice, from seeded random weights written as
    snapshots: the multibody strategies (``model`` as the 2-body prior, a
    1-body prior beside it) and the time-composition strategies (``model``
    as the conditioned prior, a horizon-70 direct model)."""
    from cindm_tpu_torch.cli.analysis_1d import main as analysis_main
    from cindm_tpu_torch.models import TemporalUnet1D

    dim = model.dim
    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-analysis-") as tmp:
        pair = write_snapshot(model, os.path.join(tmp, "pair"))
        one = write_snapshot(TemporalUnet1D(24, 4, dim=dim, generator=torch.Generator().manual_seed(1)),
                             os.path.join(tmp, "one"))
        direct = write_snapshot(
            TemporalUnet1D(DIRECT_HORIZON, 8, dim=dim, generator=torch.Generator().manual_seed(2)),
            os.path.join(tmp, "direct"))
        base = ["--model_path", pair, "--Unet_dim", str(dim), "--device", str(dev), *cuts]
        for name, extra in (("multibody", [*multi, "--uncond_model_path", one]),
                            ("time_composition", [*timecomp, "--direct_model_path", direct])):
            reset_counts()
            timings = {}
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                record = analysis_main(base + extra, timings=timings)
            if cuda:
                torch.cuda.synchronize()
            runs[name] = {"record": record, "seconds": time.perf_counter() - t0,
                          "strategy_seconds": timings, "launches": read_counts(backwards=True),
                          **staged_counts()}
    flag = lambda args, k: int(args[args.index(k) + 1])
    T, t_switch = flag(cuts, "--timesteps"), flag(cuts, "--t_switch")
    n, B = flag(multi, "--compose_multibodies"), flag(multi, "--batch_size")
    calls = (T - 1 - t_switch) * flag(multi, "--langevin_steps") + t_switch + 1
    ula_fwds = calls * n * (n - 1) // 2 * B
    checks = {
        "records_finite": all(finite_leaves(r["record"]) for r in runs.values()),
        "strategies": sorted(runs["multibody"]["record"]["multibody_strategies"]) == sorted(
            ["pairwise_compose", "cf_compose_ULA", "cf_compose_UHMC", "SimuSolver"])
        and sorted(runs["time_composition"]["record"]["compose_strategies"]) == sorted(
            ["EBMs_compose", "autoregress", "SimuSolver", "direct"]),
    }
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["multibody"]["launches"]}
    if cuda:
        checks["launches"] = all(r["launches"]["fused_rtb"] > 0 and r["launches"]["fused_conv1d_gn_mish"] > 0
                                 and r["launches"]["prenorm_linear_attention"] > 0
                                 and r["launches"]["upsample1d"] > 0 and r["launches"]["downsample1d"] > 0
                                 for r in runs.values())
    # the samplers take no gradient through the priors: no autograd Function
    # forward, no backward kernel and no attention on its plain path under
    # autograd runs in this phase (nor a resampling conv on its plain path)
    checks["no_gradient"] = all(v == 0 for k, v in launches.items()
                                if k not in ("fused_rtb", "fused_conv1d_gn_mish", "prenorm_linear_attention",
                                             "upsample1d", "downsample1d"))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"analysis phase checks failed: {failed}; runs {runs}")
    return {"runs": runs, "launches": launches, "checks": checks, "cuts": cuts,
            **{k: sum(r[k] for r in runs.values()) for k in ("staged_launches", "staged_layouts")},
            "ula_pair_window_fwds": ula_fwds,
            "ula_pair_window_fwds_per_s": ula_fwds / runs["multibody"]["strategy_seconds"]["cf_compose_ULA"]}


def run_baselines(torch, dev, cuda: bool, train_args: list[str] = BASELINE_TRAIN,
                  steps: dict = BASELINE_STEPS, design_args: list[str] = BASELINE_DESIGN) -> dict:
    """Path B: train_1d for the five baseline method types, then
    design_1d_baseline for backprop and CEM over the four surrogates."""
    import numpy as np

    from cindm_tpu_torch.cli.design_1d_baseline import main as design_main
    from cindm_tpu_torch.cli.train_1d import main as train_main

    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    reset_counts()
    train, design = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-baselines-") as tmp:
        for mt, n in steps.items():
            res = os.path.join(tmp, mt)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                train_main([*train_args, "--method_type", mt, "--device", str(dev),
                            "--train_num_steps", str(n), "--save_and_sample_every", str(n),
                            "--log_every", "1", "--dataset_path", os.path.join(tmp, "data"),
                            "--results_folder", res])
            if cuda:
                torch.cuda.synchronize()
            losses = np.load(os.path.join(res, "loss_curve.npy"))[:, 1]
            train[mt] = {"seconds": time.perf_counter() - t0, "steps": n,
                         "record": json.loads(out.getvalue().strip().splitlines()[-1]),
                         "loss_first3_mean": float(losses[:3].mean()),
                         "loss_last3_mean": float(losses[-3:].mean()),
                         "losses_finite": bool(np.isfinite(losses).all()) and len(losses) == n}
        n_design = int(design_args[design_args.index("--max_design_steps") + 1])
        for method in ("backprop", "CEM"):
            for mt, trained in DESIGN_MODELS.items():
                t0 = time.perf_counter()
                timings = {}
                with contextlib.redirect_stdout(io.StringIO()):
                    record = design_main([*design_args, "--design_method", method, "--method_type", mt,
                                          "--model_path", os.path.join(tmp, trained),
                                          "--device", str(dev)], timings=timings)
                if cuda:
                    torch.cuda.synchronize()
                # the whole run, and the design loop alone (timings["design"],
                # the card synchronized at both ends): the rates are the loop's
                row = {"record": record, "seconds": time.perf_counter() - t0,
                       "part_seconds": timings}
                if method == "CEM":
                    # model calls a rollout: one, or one per step for the step models
                    rollout = int(design_args[design_args.index("--rollout_steps") + 1])
                    n_pop = int(design_args[design_args.index("--N") + 1])
                    fwds = n_design * n_pop * (rollout if mt in STEP_MODELS else 1)
                    row.update(model_fwds=fwds, model_fwds_per_s=fwds / timings["design"])
                else:
                    row["seconds_per_iteration"] = timings["design"] / n_design
                design[f"{method}/{mt}"] = row
    counts = read_counts(backwards=True)
    staged = staged_counts()
    checks = {
        "losses_finite": all(r["losses_finite"] for r in train.values()),
        "forward_model_loss_falls": train["forward_model"]["loss_last3_mean"]
        < train["forward_model"]["loss_first3_mean"],
        "designs_finite": len(design) == 8
        and all(math.isfinite(r["record"]["design_obj_simu"]) for r in design.values()),
    }
    if cuda:
        checks["launches"] = (counts["fused_conv1d_gn_mish"] > 0 and counts["FusedConv1dGNMish_launches"] > 0
                              and counts["fused_conv1d_gn_mish_backward"] > 0
                              # the forward surrogate's resampling: CEM's rollouts on the kernel,
                              # training and backprop on the plain path under autograd
                              and counts["upsample1d"] > 0 and counts["downsample1d"] > 0
                              and counts["upsample1d_autograd"] > 0 and counts["downsample1d_autograd"] > 0)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"baselines phase checks failed: {failed}; train {train}; design {design}")
    cuts = {"train_num_steps": steps, "train_num_steps_script": "100,000-200,000",
            "max_design_steps": n_design, "max_design_steps_script": 1000}
    return {"train": train, "design": design, "launches": counts, **staged, "checks": checks,
            "cuts": cuts, "seconds": time.perf_counter() - t_phase}


@contextlib.contextmanager
def staging_log(_build):
    """The weight layouts the wrappers make meanwhile: one key (storage,
    offset, shape, N tile) a layout."""
    log, stager = [], _build.staged.stager

    def logged(jobs):
        log.extend((w.untyped_storage().data_ptr(), w.storage_offset(), tuple(w.shape), nt) for w, nt in jobs)
        return stager(jobs)

    _build.staged.stager = logged
    try:
        yield log
    finally:
        _build.staged.stager = stager


def kernel_weights(model) -> int:
    """The weight tensors of ``model`` that the stage kernels lay out: each
    Conv1dBlock's conv and each 1x1 residual of a ResidualTemporalBlock."""
    from cindm_tpu_torch.models.blocks import Conv1dBlock, ResidualTemporalBlock

    return sum(isinstance(m, Conv1dBlock) or (isinstance(m, ResidualTemporalBlock) and m.residual is not None)
               for m in model.modules())


def attention_blocks(model) -> int:
    """The linear attention blocks of ``model``: each lays out its wqkv and
    wout for the attention kernel (N tiles of 128 and 64), one launch
    each, once per weight version."""
    from cindm_tpu_torch.models.blocks import LinearAttentionTemporal

    return sum(isinstance(m, LinearAttentionTemporal) for m in model.modules())


def resample_modules(model) -> tuple[int, int]:
    """The Upsample1d and the Downsample1d modules of ``model``: each lays
    out its two phase weights for the resampling kernel in one launch, once
    per weight version."""
    from cindm_tpu_torch.models.blocks import Downsample1d, Upsample1d

    mods = list(model.modules())
    return sum(isinstance(m, Upsample1d) for m in mods), sum(isinstance(m, Downsample1d) for m in mods)


def kernel_calls(model) -> int:
    """The stage kernel calls of one forward of ``model``, each laying its
    stale weights out in one launch: one per ResidualTemporalBlock
    (fused_rtb: w1, w2 and wres) and one per Conv1dBlock outside them
    (fused_conv1d_gn_mish)."""
    from cindm_tpu_torch.models.blocks import Conv1dBlock, ResidualTemporalBlock

    rtbs = [m for m in model.modules() if isinstance(m, ResidualTemporalBlock)]
    inner = {id(c) for r in rtbs for c in r.modules()}
    return len(rtbs) + sum(isinstance(m, Conv1dBlock) and id(m) not in inner for m in model.modules())


def run_design(torch, dev, model, timesteps: int, design_args: list[str], cuda: bool) -> dict:
    """Phase 5: the design CLI on the seeded weights written as a snapshot;
    every weight laid out once per N tile (sampling never changes them)."""
    import numpy as np

    from cindm_tpu_torch.cli.design_1d import main as design_main
    from cindm_tpu_torch.models import flax_from_params
    from cindm_tpu_torch.ops import _build

    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-") as tmp:
        flat = {"['ema_params']['params']" + k: v for k, v in flax_from_params(model).items()}
        flat["['step']"] = np.asarray(0)
        np.savez(os.path.join(tmp, "persisted_m0.npz"), **flat)
        argv = ["--model_path", tmp, "--timesteps", str(timesteps), "--device", str(dev),
                *design_args]
        reset_counts()
        _build.staged.clear()
        t0 = time.perf_counter()
        with staging_log(_build) as log:
            record = design_main(argv)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        staging = {"launches": _build.staged.launches, "layouts": _build.staged.layouts,
                   "logged": len(log), "distinct": len(set(log)), "n_tiles": len({k[-1] for k in log}),
                   "weight_tensors": kernel_weights(model), "kernel_calls": kernel_calls(model),
                   "attention_blocks": attention_blocks(model),
                   # wqkv [C, 384] laid out for N tiles of 128: the attention's alone have 384 outputs
                   "attention_wqkv_layouts": sum(k[2][-1] == 384 and k[3] == 128 for k in log),
                   "resample_modules": resample_modules(model),
                   # the resampling convs' 2-tap phase weights (up: both, down: one of its two);
                   # no other weight has 2 taps
                   "resample_two_tap_layouts": sum(k[2][0] == 2 for k in log)}
    vals = [record[k] for k in ("design_obj", "design_obj_ci95", "MAE", "RMSE")]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"design record is not finite: {record}")
    per_step = {k: v / timesteps for k, v in counts.items()}
    if cuda and per_step != {"fused_rtb": 16.0 * RECURRENCE, "fused_conv1d_gn_mish": 1.0 * RECURRENCE,
                             "prenorm_linear_attention": 8.0 * RECURRENCE,
                             "upsample1d": 3.0 * RECURRENCE, "downsample1d": 3.0 * RECURRENCE}:
        raise AssertionError(f"expected 160, 10, 80, 30 and 30 launches per reverse step, got {per_step}")
    # at most one layout per weight tensor and N tile: none made twice; a
    # stage kernel call's weights in one launch: at most one a call per N
    # tile; each attention block's wqkv and wout once, a launch each; each
    # resampling conv's two phase weights once, in one launch
    n_attn, (n_up, n_down) = staging["attention_blocks"], staging["resample_modules"]
    n_res = n_up + n_down
    if cuda and not (staging["layouts"] == staging["logged"] == staging["distinct"]
                     and staging["attention_wqkv_layouts"] == n_attn
                     and staging["resample_two_tap_layouts"] == 2 * n_up + n_down
                     and 0 < staging["distinct"] <= 2 * staging["weight_tensors"] + 2 * n_attn + 2 * n_res
                     and 0 < staging["launches"]
                     <= staging["kernel_calls"] * staging["n_tiles"] + 2 * n_attn + n_res):
        raise AssertionError(f"design should lay each weight out once per N tile, a call's in one launch: "
                             f"{staging}")
    batch = int(design_args[design_args.index("--batch_size") + 1])
    fwds = timesteps * RECURRENCE * N_WINDOWS * N_PAIRS * batch
    return {"record": record, "reverse_steps": timesteps, "seconds": seconds,
            "launches": counts, "launches_per_step": per_step, "staging": staging,
            "pair_window_fwds": fwds, "pair_window_fwds_per_s": fwds / seconds}


def check_block_grads(torch, dev, batch: int, cuda: bool) -> dict:
    """Phase 6a: the blocks' autograd Functions against plain autograd, and
    each backward kernel alone against its plain closed form."""
    from cindm_tpu_torch.ops import (
        fused_conv1d_gn_mish_backward,
        fused_conv1d_gn_mish_backward_reference,
        fused_conv1d_gn_mish_differentiable,
        fused_conv1d_gn_mish_reference,
        fused_rtb_backward,
        fused_rtb_backward_reference,
        fused_rtb_differentiable,
        fused_rtb_reference,
    )
    from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish
    from cindm_tpu_torch.ops.fused_rtb import _fused_rtb

    g = torch.Generator(device=dev).manual_seed(4321)
    rtb_names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]

    def fwd_bwd(fn, a, cot):
        ts = {k: v.detach().requires_grad_(True) for k, v in a.items()}
        out = fn(**ts)
        return [out.detach(), *torch.autograd.grad(out, list(ts.values()), cot)]

    def one(kernel, plain, a, cot, macs):
        got, want = fwd_bwd(kernel, a, cot), fwd_bwd(plain, a, cot)
        abs_err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        rel_err = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                      for x, y in zip(got, want))
        if not all(bool(torch.isfinite(x).all()) for x in got):
            raise AssertionError("Function output or gradient is not finite")
        # entries beyond rtol = atol = TOL, for the output and each cotangent
        beyond = {n: int(((x - y).abs() > TOL + TOL * y.abs()).sum())
                  for n, x, y in zip(["out", *a], got, want)}
        plain_ms, kernel_ms = time_pair(
            torch, lambda: fwd_bwd(plain, a, cot), lambda: fwd_bwd(kernel, a, cot)
        ) if cuda else (None, None)
        # the card's own time in one fwd+bwd (torch.profiler): what is left
        # of kernel_ms is the host's
        busy = (device_busy(torch, lambda: fwd_bwd(kernel, a, cot), kernel_ms)["busy_ms"]
                if cuda else None)
        device_ms = busy if isinstance(busy, float) else None  # None: the trace saw no device
        host = host_ms(torch, lambda: fwd_bwd(kernel, a, cot)) if cuda else None
        # forward + backward: each input and the cotangent read once, the
        # output and each input's gradient written once; 3x the forward's FLOP
        n_in = sum(v.numel() for v in a.values())
        nbytes = 4 * (2 * n_in + 2 * cot.numel())
        bound_ms, bound_by = bound(3 * 2 * macs, nbytes)
        tc_ms, tc_by = bound(TF32_PASSES * 3 * 2 * macs, nbytes, PEAK_TF32_FLOPS)
        return dict(max_abs_err=abs_err, max_rel_err=rel_err, entries_beyond_tol=beyond,
                    kernel_ms=kernel_ms,
                    plain_ms=plain_ms, device_ms=device_ms, host_ms=host, bound_ms=bound_ms,
                    bound_by=bound_by,
                    bound_tc_ms=tc_ms, bound_tc_by=tc_by)

    def backward_alone(kernel, plain, saved, cot, needs, macs):
        """The backward kernel and its plain closed form on the same saved
        tensors: every cotangent within TOL of the plain one's largest
        entry; both timed; the backward's bounds (twice the forward's FLOP;
        the saved tensors and the cotangent read once, the gradients written
        once)."""
        if not cuda:  # a CPU rehearsal has no backward kernel: the plain version stands in
            kernel = plain
        got, want = kernel(saved, cot, needs), plain(saved, cot, needs)
        again = kernel(saved, cot, needs)  # a second pass: equal bit for bit
        if not all((x is None and y is None) or bool(torch.equal(x, y)) for x, y in zip(got, again)):
            raise AssertionError("two backward passes on the same inputs differ")
        errs = []
        for x, y in zip(got, want):
            if y is None:
                continue
            if not bool(torch.isfinite(x).all()):
                raise AssertionError("backward kernel gradient is not finite")
            d = float((x - y).abs().max())
            errs.append((d, d / max(float(y.abs().max()), 1e-30)))
        plain_ms, kernel_ms = time_pair(
            torch, lambda: plain(saved, cot, needs), lambda: kernel(saved, cot, needs)
        ) if cuda else (None, None)
        nbytes = 4 * (sum(t.numel() for t in saved if t is not None) + cot.numel()
                      + sum(t.numel() for t in want if t is not None))
        bound_ms, bound_by = bound(2 * 2 * macs, nbytes)
        tc_ms, tc_by = bound(TF32_PASSES * 2 * 2 * macs, nbytes, PEAK_TF32_FLOPS)
        return dict(backward_repeats_bit_for_bit=True, backward_max_abs_err=max(e[0] for e in errs),
                    backward_max_rel_err=max(e[1] for e in errs),
                    backward_ms=kernel_ms, backward_plain_ms=plain_ms,
                    backward_bound_ms=tc_ms, backward_bound_by=tc_by,
                    backward_bound_fp32_ms=bound_ms, backward_bound_fp32_by=bound_by)

    rtb_rows = []
    for C, O, T in RTB_SHAPES:
        a = dict(x=torch.randn((batch, T, C), generator=g, device=dev),
                 temb=torch.randn((batch, O), generator=g, device=dev),
                 **rand_block_params(torch, g, C, O, dev, proj=C != O))
        cot = torch.randn((batch, T, O), generator=g, device=dev)
        taps = valid_taps(T, K)
        macs = batch * (taps * C * O + taps * O * O + (T * C * O if C != O else 0))
        row = dict(C=C, O=O, T=T, B=batch, **one(
            fused_rtb_differentiable, fused_rtb_reference, a, cot, macs))
        args = [a.get(n) for n in rtb_names]
        with torch.no_grad():
            saved = args + list(_fused_rtb(*args, 8, 1e-5, save=True)[1:])
            row.update(backward_alone(fused_rtb_backward, fused_rtb_backward_reference, saved, cot,
                                      [True] * 10 + [C != O] * 2, macs))
        rtb_rows.append(row)
        del a, cot, args, saved
    C, O, T = HEAD_SHAPE
    p = rand_block_params(torch, g, C, O, dev, proj=False)
    a = dict(x=torch.randn((batch, T, C), generator=g, device=dev), w=p["w1"], b=p["b1"],
             gn_scale=p["gs1"], gn_bias=p["gb1"])
    cot = torch.randn((batch, T, O), generator=g, device=dev)
    macs = batch * valid_taps(T, K) * C * O
    head = dict(C=C, O=O, T=T, B=batch, **one(
        fused_conv1d_gn_mish_differentiable, fused_conv1d_gn_mish_reference, a, cot, macs))
    with torch.no_grad():
        args = list(a.values())
        saved = args + list(_conv_gn_mish(*args, 8, 1e-5, save=True)[1:])
        head.update(backward_alone(fused_conv1d_gn_mish_backward,
                                   fused_conv1d_gn_mish_backward_reference, saved, cot, [True] * 5,
                                   macs))
    bad = [r for r in rtb_rows + [head]
           if not (r["max_rel_err"] <= TOL and r["backward_max_rel_err"] <= TOL)]
    if bad:
        raise AssertionError(f"gradients disagree with plain autograd or the closed form beyond {TOL}: {bad}")
    return {"fused_rtb_differentiable": rtb_rows, "fused_conv1d_gn_mish_differentiable": [head]}


def reduce_job_lists(torch, dev, batch: int, cuda: bool) -> list[tuple[tuple[int, int, int], object]]:
    """grad_reduce's plan of each of the backward pass's 17 launches (the 16
    blocks and the head at ``batch``), as the backward plans them on this
    device: ((C, O, T), ReducePlan)."""
    from cindm_tpu_torch.ops import _build

    kw = dict(num_sms=_build.num_sms(dev), clusters=_build.cluster_limits(dev)) if cuda else {}
    out = []
    for i, (C, O, T) in enumerate(RTB_SHAPES + [HEAD_SHAPE]):
        rtb = i < len(RTB_SHAPES)
        out.append(((C, O, T), _build.plan_backward(batch, T, C, O, 8, proj=rtb and C != O, rtb=rtb,
                                                    **kw).reduce))
    return out


def check_grad_reduce(torch, dev, batch: int, cuda: bool) -> dict:
    """Phase 6c: grad_reduce alone at each of the backward pass's 17 job
    lists, on seeded random partials of the jobs' sizes: every sum
    bit-identical to grad_reduce_reference (the in-order sum in torch) on
    the card, and again on a second run; every launch at least
    min(items, REDUCE_MIN_CTAS) CTAs. The 17 launches timed beside the plain
    version, the bound (the partials read once, the sums written once, or
    their adds at the fp32 peak) and ``torch.sum`` over the slices (its own
    order) as the yardstick."""
    from cindm_tpu_torch.ops import grad_reduce, grad_reduce_reference

    g = torch.Generator(device=dev).manual_seed(1515)
    lists, rows = [], []
    for shape, plan in reduce_job_lists(torch, dev, batch, cuda):
        srcs = [torch.randn((S * n,), generator=g, device=dev) for n, S in plan.jobs]
        jobs = list(zip(srcs, [S for _, S in plan.jobs]))
        got, again = grad_reduce(jobs), grad_reduce(jobs)
        want = [grad_reduce_reference(src, S) for src, S in jobs]
        if not all(bool(torch.equal(a, w)) for a, w in zip(got, want)):
            raise AssertionError(f"grad_reduce at {shape} differs from the in-order sum")
        if not all(bool(torch.equal(a, b)) for a, b in zip(got, again)):
            raise AssertionError(f"two grad_reduce runs at {shape} differ")
        if plan.grid < min(plan.items, REDUCE_MIN_CTAS):
            raise AssertionError(f"grad_reduce at {shape}: {plan.grid} CTAs for {plan.items} items")
        lists.append(jobs)
        rows.append({"shape": list(shape), "jobs": [list(j) for j in plan.jobs],
                     "widths": list(plan.widths), "items": plan.items, "ctas": plan.grid})
    n_jobs = [(src.numel() // S, S) for jobs in lists for src, S in jobs]
    bound_ms, bound_by = bound(sum(n * S for n, S in n_jobs), sum(4 * n * (S + 1) for n, S in n_jobs))
    rec = {"lists": rows, "bit_identical": True, "repeats_bit_for_bit": True, "max_abs_err": 0.0,
           "bound_ms": bound_ms, "bound_by": bound_by, "launches": grad_reduce.launches}
    if cuda:
        plain_ms, kernel_ms = time_pair(
            torch, lambda: [[grad_reduce_reference(src, S) for src, S in jobs] for jobs in lists],
            lambda: [grad_reduce(jobs) for jobs in lists])
        rec.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=event_ms(
            torch, lambda: [torch.sum(src.view(S, -1), 0) for jobs in lists for src, S in jobs], 10))
    return rec


def check_reduce_ctas(bprof: dict) -> None:
    """Every grad_reduce launch of the backward pass at the training batch
    runs at least min(items, REDUCE_MIN_CTAS) CTAs, 17 launches."""
    launches = bprof["kernels"]["grad_reduce"]["per_launch"]
    small = [l for l in launches if l["ctas"] < min(l["items"], REDUCE_MIN_CTAS)]
    if len(launches) != len(RTB_SHAPES) + 1 or small:
        raise AssertionError(f"grad_reduce launches under min(items, {REDUCE_MIN_CTAS}) CTAs: {small}")


def check_grad(torch, dev, batch: int, model, cuda: bool) -> dict:
    """Phase 6b: one training gradient of the whole denoiser on both paths,
    its launch counts, and one optimizer step timed on each path."""
    import copy

    from cindm_tpu_torch.core import make_schedule
    from cindm_tpu_torch.sampling import Diffusion1DConfig, p_losses
    from cindm_tpu_torch.train import TrainConfig, init_train_state, make_train_step

    g = torch.Generator(device=dev).manual_seed(7)
    H, F = model.horizon, model.transition_dim
    batch_d = {"x": 0.5 * torch.randn((batch, H, F), generator=g, device=dev),
               "t": torch.randint(0, 1000, (batch,), generator=g, device=dev),
               "noise": torch.randn((batch, H, F), generator=g, device=dev)}
    cfg, sched = Diffusion1DConfig(rollout_steps=H), make_schedule(1000, device=dev)
    params = list(model.parameters())

    def grads(use_kernels):
        loss = p_losses(cfg, sched, lambda x, t: model(x, t, use_kernels), batch_d["x"], None,
                        t=batch_d["t"], noise=batch_d["noise"])
        return float(loss.detach()), torch.autograd.grad(loss, params)

    reset_counts()
    loss_k, g_k = grads(True)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    counts = read_counts(backwards=True)
    loss_p, g_p = grads(False)
    worst, worst_name = 0.0, None
    for (name, _), a, b in zip(model.named_parameters(), g_k, g_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel-path gradient of {name} is not finite")
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    if worst > GRAD_TOL:
        raise AssertionError(f"gradient of {worst_name}: {worst} > {GRAD_TOL} of the plain path's")
    want = {"fused_rtb": 16, "fused_conv1d_gn_mish": 1, "FusedRTB_launches": 16,
            "FusedRTB_backward_passes": 16, "FusedConv1dGNMish_launches": 1,
            "FusedConv1dGNMish_backward_passes": 1,
            "fused_rtb_backward": 16, "fused_conv1d_gn_mish_backward": 1,
            # the attention and resampling kernels have no backward: the plain path under autograd
            "prenorm_linear_attention": 0, "prenorm_linear_attention_autograd": 8,
            "upsample1d": 0, "upsample1d_autograd": 3, "downsample1d": 0, "downsample1d_autograd": 3}
    if cuda and counts != want:
        raise AssertionError(f"one training micro-step should count {want}, counted {counts}")
    rec = {"batch": batch, "loss_kernel": loss_k, "loss_plain": loss_p,
           "max_grad_err_over_max_abs": worst, "worst_param": worst_name,
           "tolerance": GRAD_TOL, "launches": counts}
    if cuda:
        # forward, backward, clip, Adam and (every step here) the EMA update
        tcfg = TrainConfig(ema_update_every=1)
        steps = {}
        for use_kernels in (True, False):
            st = init_train_state(copy.deepcopy(model), tcfg)
            fn = make_train_step(cfg, sched, tcfg, use_kernels=use_kernels)
            steps[use_kernels] = (lambda st=st, fn=fn: fn(st, batch_d))
        plain_ms, kernel_ms = time_pair(torch, steps[False], steps[True], reps=5)
        rec.update(step_kernel_ms=kernel_ms, step_plain_ms=plain_ms,
                   samples_per_s_kernel=batch / kernel_ms * 1e3,
                   samples_per_s_plain=batch / plain_ms * 1e3,
                   device_busy_kernel=device_busy(torch, steps[True], kernel_ms),
                   device_busy_plain=device_busy(torch, steps[False], plain_ms))
    return rec


def device_busy(torch, fn, step_ms: float) -> dict:
    """Kernel time on the card in one call of ``fn``, from a torch.profiler
    trace, beside ``step_ms`` (the same call timed with CUDA events, without
    the profiler): the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels:
        return {"busy_ms": "not measured (the trace shows no device activity)"}
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {"busy_ms": busy_ms, "device_launches": len(kernels), "busy_share": busy_ms / step_ms,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:6])}


def check_trained_blocks(torch, dev, model, batch: int) -> dict:
    """After a training run's last optimizer step: every block of the
    trained model, kernel against plain on the updated weights (a layout
    kept from before the step would not match), and the layouts made anew
    meanwhile (each weight's, once; each call's in one launch)."""
    from cindm_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(4321)
    n0, m0 = _build.staged.launches, _build.staged.layouts
    errs = []
    with torch.no_grad():
        for rtb, T in zip(model.rtbs, rtb_times(model)):
            x = torch.randn((batch, T, rtb.block0.conv.weight.shape[1]), generator=g, device=dev)
            temb = torch.randn((batch, rtb.time.weight.shape[0]), generator=g, device=dev)
            errs.append(errors(torch, rtb(x, temb), rtb(x, temb, use_kernels=False)))
        head = model.final_block
        x = torch.randn((batch, model.horizon, head.conv.weight.shape[1]), generator=g, device=dev)
        errs.append(errors(torch, head(x), head(x, use_kernels=False)))
    return {"max_abs_err": max(e[0] for e in errs), "max_rel_err": max(e[1] for e in errs),
            "restaged": _build.staged.layouts - m0, "restaged_launches": _build.staged.launches - n0,
            "weight_tensors": kernel_weights(model), "kernel_calls": kernel_calls(model)}


def run_train(torch, dev, train_args: list[str], steps: tuple[int, int, int, int], cuda: bool) -> dict:
    """Phase 7: the train_1d CLI, then a resume with one eval."""
    import numpy as np

    from cindm_tpu_torch.cli.train_1d import main as train_main
    from cindm_tpu_torch.ops import _build
    from cindm_tpu_torch.train import CheckpointManager

    n_steps, save_every, resume_steps, eval_steps = steps
    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    runs = []
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-train-") as tmp:
        base = [*train_args, "--device", str(dev), "--save_and_sample_every", str(save_every),
                "--dataset_path", os.path.join(tmp, "data"),
                "--results_folder", os.path.join(tmp, "results")]
        for extra in (["--train_num_steps", str(n_steps), "--log_every", "1"],
                      ["--train_num_steps", str(resume_steps), "--resume", "True",
                       "--eval_every", str(resume_steps - n_steps),
                       "--eval_sample_steps", str(eval_steps)]):
            reset_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                state = train_main(base + extra)
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            lines = out.getvalue().strip().splitlines()
            counts, reduce, staged = (read_counts(backwards=True), _build.launch_backward.reduce_launches,
                                      staged_counts())
            fresh = check_trained_blocks(torch, dev, state.model, TRAIN_BATCH) if cuda else None
            runs.append({"seconds": seconds, "launches": counts, **staged,
                         "weight_tensors": kernel_weights(state.model), "kernel_calls": kernel_calls(state.model),
                         "attention_blocks": attention_blocks(state.model),
                         "resample_modules": sum(resample_modules(state.model)),
                         "after_last_step": fresh,
                         "grad_reduce_launches": reduce,
                         "record": json.loads(lines[-1]), "step": state.step,
                         "first_lines": lines[:2], "last_lines": lines[-3:-1]})
        res = os.path.join(tmp, "results")
        milestones = CheckpointManager(res).all_milestones()
        curve = np.load(os.path.join(res, "loss_curve.npy"))
        with open(os.path.join(res, "eval_records.jsonl")) as f:
            evals = [json.loads(line) for line in f]
    losses = curve[:, 1]
    first, second = runs
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()) and len(losses) == n_steps,
        "loss_falls": float(losses[-5:].mean()) < float(losses[:5].mean()),
        "milestones": milestones == [save_every * k for k in range(1, n_steps // save_every + 1)],
        "resumed_at": second["record"]["start_step"] == n_steps and second["step"] == resume_steps,
        "eval_finite": len(evals) == 1 and evals[0]["step"] == resume_steps
        and all(math.isfinite(evals[0][k]) for k in ("sample_mae", "sample_rmse")),
    }
    if cuda:
        n2 = resume_steps - n_steps
        checks["launches"] = (
            first["launches"] == {"fused_rtb": 16 * n_steps, "fused_conv1d_gn_mish": n_steps,
                                  "FusedRTB_launches": 16 * n_steps,
                                  "FusedRTB_backward_passes": 16 * n_steps,
                                  "FusedConv1dGNMish_launches": n_steps,
                                  "FusedConv1dGNMish_backward_passes": n_steps,
                                  "fused_rtb_backward": 16 * n_steps,
                                  "fused_conv1d_gn_mish_backward": n_steps,
                                  "prenorm_linear_attention": 0,
                                  "prenorm_linear_attention_autograd": 8 * n_steps,
                                  "upsample1d": 0, "upsample1d_autograd": 3 * n_steps,
                                  "downsample1d": 0, "downsample1d_autograd": 3 * n_steps}
            and second["launches"] == {"fused_rtb": 16 * (n2 + eval_steps),
                                       "fused_conv1d_gn_mish": n2 + eval_steps,
                                       "FusedRTB_launches": 16 * n2,
                                       "FusedRTB_backward_passes": 16 * n2,
                                       "FusedConv1dGNMish_launches": n2,
                                       "FusedConv1dGNMish_backward_passes": n2,
                                       "fused_rtb_backward": 16 * n2,
                                       "fused_conv1d_gn_mish_backward": n2,
                                       # the eval samples without a gradient: the kernel
                                       "prenorm_linear_attention": 8 * eval_steps,
                                       "prenorm_linear_attention_autograd": 8 * n2,
                                       "upsample1d": 3 * eval_steps, "upsample1d_autograd": 3 * n2,
                                       "downsample1d": 3 * eval_steps, "downsample1d_autograd": 3 * n2}
            # every backward of a training step wants the weights: one grad_reduce each
            and first["grad_reduce_launches"] == 17 * n_steps and second["grad_reduce_launches"] == 17 * n2)
        # the kernels on the weights of the last optimizer step, each laid out
        # anew, a call's weights in one launch
        checks["after_last_step"] = all(
            r["after_last_step"]["max_abs_err"] <= TOL and r["after_last_step"]["max_rel_err"] <= TOL
            and r["after_last_step"]["restaged"] == r["after_last_step"]["weight_tensors"]
            and r["after_last_step"]["restaged_launches"] == r["after_last_step"]["kernel_calls"] for r in runs)
        # each step's first forward lays every weight out anew (the optimizer
        # changed it), one launch a kernel call: 17 launches and 43 layouts a
        # step for the flagship; the steps' attention and resampling run
        # plain, and the resumed run's one eval lays each attention block's
        # wqkv and wout out once, a launch each (16 launches and 16
        # layouts), and each resampling conv's two phase weights in one
        # launch (6 and 12), beside the stage kernels' 17 and 43
        checks["staging"] = (
            first["staged_launches"] == first["kernel_calls"] * n_steps
            and first["staged_layouts"] == first["weight_tensors"] * n_steps
            and all((r["staged_layouts"] - 2 * (r["attention_blocks"] + r["resample_modules"]) * e)
                    * r["kernel_calls"]
                    == (r["staged_launches"] - (2 * r["attention_blocks"] + r["resample_modules"]) * e)
                    * r["weight_tensors"]
                    for r, e in zip(runs, (0, 1))))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train phase checks failed: {failed}; runs {runs}; "
                             f"milestones {milestones}; evals {evals}; losses {losses.tolist()}")
    return {"runs": runs, "milestones": milestones, "eval": evals[0],
            "loss_first5_mean": float(losses[:5].mean()), "loss_last5_mean": float(losses[-5:].mean()),
            "train_samples_per_s": first["record"]["samples_per_s"],
            "data_generation_seconds": first["record"]["data_seconds"], "checks": checks}


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want| of a card result against a CPU one."""
    return errors(torch, got.detach().cpu(), want.detach().cpu())[1]


def flop_count(fn) -> int:
    """FLOP of one call of ``fn`` (matmuls and convolutions, forward and
    backward), counted by ``torch.utils.flop_counter`` from the shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def run_unet2d(torch, dev, cuda: bool, batch: int = DESIGN2D_BATCH, nb: int = DESIGN2D_NB,
               force_designs: tuple[int, int] = (2, 2)):
    """Phase 11: the full-width Unet2D and ForceUnet (seeded weights) on the
    card against the port's own CPU run on the same weights and inputs
    (Unet2D at batch 4; ForceUnet at batch 24, B 2 x nb 2 x 6 frames, with
    the input gradient of force_objective); then, on the card, per reverse
    step of the design configuration (B*nb = 48): the Unet2D forward, the
    ForceUnet forward + input gradient at 288 images, one whole guided
    step with its peak memory and device busy share. Returns (record,
    (unet, force)) with the models on ``dev``."""
    import copy

    from cindm_tpu_torch.models import ForceUnet, Unet2D
    from cindm_tpu_torch.sampling.diffusion2d import Diffusion2DConfig, nhwc_model, p_sample_2d
    from cindm_tpu_torch.sampling.guidance2d import make_design_grad_fn
    from cindm_tpu_torch.sampling.sampler import generator_randn

    unet = Unet2D(dim=64, dim_mults=(1, 2), channels=21, generator=torch.Generator().manual_seed(10))
    force = ForceUnet(dim=64, dim_mults=(1, 2, 4, 8), generator=torch.Generator().manual_seed(11))
    params = {"Unet2D": sum(p.numel() for p in unet.parameters()),
              "ForceUnet": sum(p.numel() for p in force.parameters())}
    if params != {"Unet2D": UNET2D_PARAMS, "ForceUnet": FORCE_UNET_PARAMS}:
        raise AssertionError(f"full-width parameter counts {params}")
    unet_cpu, force_cpu = (copy.deepcopy(m).eval().requires_grad_(False) for m in (unet, force))
    unet, force = (m.to(dev).eval().requires_grad_(False) for m in (unet, force))
    g = torch.Generator().manual_seed(12)
    x4 = torch.rand((4, 64, 64, 21), generator=g) * 2 - 1
    t4 = torch.randint(0, 1000, (4,), generator=g)
    with torch.no_grad():
        unet_err = rel_err(torch, nhwc_model(unet)(x4.to(dev), t4.to(dev)),
                           nhwc_model(unet_cpu)(x4, t4))
    fb, fnb = force_designs
    inp = torch.rand((fb * fnb * DESIGN2D_FRAMES, 4, 64, 64), generator=g) * 2 - 1
    with torch.no_grad():
        force_err = rel_err(torch, force(inp.to(dev)), force_cpu(inp))
    xf = torch.rand((fb * fnb, 64, 64, 21), generator=g) * 2 - 1
    grad = lambda m, d: make_design_grad_fn(m, fb, fnb, DESIGN2D_FRAMES, -1.0, 1.0,
                                            lambda_overlap=0.0)(xf.to(d))
    grad_err = rel_err(torch, grad(force, dev), grad(force_cpu, "cpu"))
    rec = {"params": params, "unet2d_batch": 4, "unet2d_max_err_over_max_abs": unet_err,
           "force_batch": inp.shape[0], "force_max_err_over_max_abs": force_err,
           "force_objective_grad_max_err_over_max_abs": grad_err,
           "tolerance": UNET2D_TOL, "grad_tolerance": FORCE_GRAD_TOL}
    if unet_err > UNET2D_TOL or force_err > UNET2D_TOL or grad_err > FORCE_GRAD_TOL:
        raise AssertionError(f"2D models on {dev} disagree with the CPU: {rec}")
    if cuda:
        Bnb = batch * nb
        xs = (torch.rand((Bnb, 64, 64, 21), generator=g) * 2 - 1).to(dev)
        ts = torch.full((Bnb,), 50, dtype=torch.long, device=dev)
        eps = nhwc_model(unet)
        design_fn = make_design_grad_fn(force, batch, nb, DESIGN2D_FRAMES, -1.0, 1.0)
        cfg = Diffusion2DConfig(timesteps=100, coeff_ratio=2e-4)
        sched = cfg.make_schedule(dev)
        randn = generator_randn(torch.Generator(device=dev).manual_seed(13), dev)

        def unet_fwd():
            with torch.no_grad():
                eps(xs, ts)

        def step():
            with torch.no_grad():
                p_sample_2d(cfg, sched, eps, xs, 50, randn, batch=batch, num_boundaries=nb,
                            design_fn=design_fn)

        for fn in (unet_fwd, lambda: design_fn(xs), step):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = event_ms(torch, step, reps=3)
        unet_ms = event_ms(torch, unet_fwd, reps=5)
        force_ms = event_ms(torch, lambda: design_fn(xs), reps=3)
        unet_flop, force_flop = flop_count(unet_fwd), flop_count(lambda: design_fn(xs))
        rec.update(
            design_batch=Bnb, force_images=Bnb * DESIGN2D_FRAMES,
            unet2d_forward_ms=unet_ms, unet2d_forward_flop=unet_flop,
            unet2d_forward_tflop_per_s=unet_flop / unet_ms / 1e9,
            force_forward_grad_ms=force_ms, force_forward_grad_flop=force_flop,
            force_forward_grad_tflop_per_s=force_flop / force_ms / 1e9,
            guided_step_ms=step_ms,
            guided_step_peak_bytes=torch.cuda.max_memory_allocated(dev),
            guided_step_host_ms=host_ms(torch, step, reps=3),
            guided_step_device=device_busy(torch, step, step_ms))
    return rec, (unet, force)


def run_design2d(torch, dev, cuda: bool, models, cuts: list[str] = DESIGN2D_CUTS) -> dict:
    """Phase 12: path C, ``cindm_tpu_torch.cli.design_2d`` twice on snapshots
    of the unet2d phase's weights: raw output finite and of its shape, run
    (a)'s mask channel exactly 0 outside each region band, the record's keys
    the JAX CLI's, the record finite, TF32 off after the CLI returns (it is
    turned on before each run: the CLI sets its own precision); no kernel of
    the 1D paths launched. ``cuts`` follow each run's flags, so they win."""
    import numpy as np

    from cindm_tpu_torch.cli.design_2d import build_parser, make_region_bands
    from cindm_tpu_torch.cli.design_2d import main as design_main

    unet, force = models
    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    out = {}
    reset_counts()
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-design2d-") as tmp:
        mpath = write_snapshot(unet, os.path.join(tmp, "airfoil"))
        fpath = write_snapshot(force, os.path.join(tmp, "force"))
        for name, args in {"a": DESIGN2D_A, "b": DESIGN2D_B}.items():
            raw = os.path.join(tmp, f"raw_{name}.npy")
            argv = ["--model_path", mpath, "--force_model_path", fpath, "--device", str(dev),
                    "--dump_raw", raw, *args, *cuts]
            flags = vars(build_parser().parse_args(argv))
            timings = {}
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                record = design_main(argv, timings=timings)
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            sample = np.load(raw)
            B, nb = flags["batch_size"], flags["num_boundaries"]
            steps = flags["ddim_steps"] or flags["timesteps"]
            keys = DESIGN2D_RECORD_KEYS | (DESIGN2D_SCORE_KEYS if record["valid_designs"] else set())
            checks = {
                "raw_finite": bool(np.isfinite(sample).all()),
                "raw_shape": sample.shape == (B, nb, 64, 64, 21),
                "record_keys": set(record) == keys,
                "record_finite": all(math.isfinite(v) for v in record.values()
                                     if not isinstance(v, str)),
                "tf32_off": not (torch.backends.cuda.matmul.allow_tf32
                                 or torch.backends.cudnn.allow_tf32),
            }
            if flags["region_partition"] == "y":
                bands = make_region_bands(64, 64, nb, *flags["region_band"]).numpy()
                mask = sample[..., -3]  # [B, nb, H, W]
                checks["mask_zero_outside_bands"] = all(
                    bool((mask[:, k][:, bands[k] == 0] == 0).all()) for k in range(nb))
            failed = [k for k, ok in checks.items() if not ok]
            if failed:
                raise AssertionError(f"design2d run ({name}) checks failed: {failed}; {record}")
            out[name] = {"record": record, "seconds": seconds, "part_seconds": timings,
                         "reverse_steps": steps, "designs": B, "num_boundaries": nb,
                         "reverse_steps_per_s": steps / timings["sampling"],
                         "unet2d_fwds_per_s": steps * B * nb / timings["sampling"],
                         "printed_tail": printed.getvalue().strip().splitlines()[-2:],
                         "checks": checks}
    counts = {**read_counts(backwards=True), "stage_weights": staged_launches()}
    if any(counts.values()):
        raise AssertionError(f"path C launched a kernel of the 1D paths: {counts}")
    return {"runs": out, "launches": counts, "cuts": cuts, "timesteps_script": 1000}


def band_designs(n_designs: int, nb: int, lo: float = 0.2, hi: float = 0.8, grid: int = 64,
                 seed: int = 2024):
    """``n_designs`` designs of ``nb`` airfoils from data/airfoil's sampler,
    airfoil k centred in run (a)'s region band k and redrawn until it lies
    inside that band, so that no two overlap."""
    import numpy as np

    from cindm_tpu_torch.data.airfoil import boundary_coords, sample_boundary_params

    rng = np.random.default_rng(seed)
    span = (hi - lo) * grid / nb
    designs = []
    for _ in range(n_designs):
        polys = []
        for k in range(nb):
            r0 = lo * grid + k * span
            c = (r0 + 0.5 * span) / grid
            while True:
                p = boundary_coords(sample_boundary_params(rng, grid, y_band=(c, c)))
                if r0 <= p[:, 1].min() and p[:, 1].max() < r0 + span:
                    break
            polys.append(p)
        designs.append(polys)
    return designs


def run_bdim(torch, dev, cuda: bool, n_designs: int = DESIGN2D_BATCH, nb: int = DESIGN2D_NB,
             protocol: tuple[int, int] = BDIM_PROTOCOL, check_steps: int = BDIM_CHECK_STEPS) -> dict:
    """Phase 13: closed-loop scoring of real airfoils (``band_designs``):
    the mask/offset round trip (``boundary_mask_offset`` ->
    ``reconstruct_boundary``), ``evaluate_designs`` at the full protocol
    (finite forces, |mean drag| > 1e-3 for every design), 2 designs over
    ``check_steps`` steps on the card against the port's CPU solver, and one
    BDIM step's card time, host time and launches."""
    import numpy as np

    from cindm_tpu_torch.data.airfoil import boundary_mask_offset
    from cindm_tpu_torch.physics import bdim
    from cindm_tpu_torch.utils import evaluate_designs, reconstruct_boundary

    designs = band_designs(n_designs, nb)
    round_trip = sum(len(reconstruct_boundary(*boundary_mask_offset(p))) == 1
                     for polys in designs for p in polys)
    M = max(len(p) for polys in designs for p in polys)
    coords = np.stack([np.stack([np.pad(p, ((0, M - len(p)), (0, 0)), mode="edge") for p in polys])
                       for polys in designs]).astype(np.float32)
    cfg = bdim.BDIMConfig(n=BDIM_N)
    n_warmup, n_record = protocol
    t0 = time.perf_counter()
    scores = evaluate_designs(coords, cfg, n_warmup=n_warmup, n_record=n_record, device=dev)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    forces = scores["forces"]
    drag = forces[..., 0].sum(axis=2).mean(axis=1)

    def steps(device):
        c = torch.as_tensor(coords[:2], device=device)
        consts, state = bdim.make_consts(cfg, c), bdim.init_state(cfg, 2, device)
        with torch.no_grad():
            for _ in range(check_steps):
                state = bdim.bdim_step(cfg, consts, state)
        return state

    card, cpu = steps(dev), steps("cpu")
    field_err = {name: rel_err(torch, a, b) for name, a, b in zip(card._fields, card, cpu)}
    checks = {"forces_finite": bool(np.isfinite(forces).all()),
              "drag_nonzero": bool((np.abs(drag) > 1e-3).all()),
              "card_vs_cpu": all(e <= BDIM_TOL for e in field_err.values())}
    rec = {"designs": n_designs, "boundaries": nb, "n": BDIM_N, "cg_iters": cfg.cg_iters,
           "n_warmup": n_warmup, "n_record": n_record, "seconds": seconds,
           "design_steps_per_s": n_designs * (n_warmup + n_record) / seconds,
           "round_trip_one_polygon": round_trip, "round_trip_of": n_designs * nb,
           "mean_drag": drag.tolist(), "scores": {k: v for k, v in scores.items() if np.ndim(v) == 0},
           "check_steps": check_steps, "card_vs_cpu_max_err_over_max_abs": field_err,
           "tolerance": BDIM_TOL, "checks": checks}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bdim phase checks failed: {failed}; {rec}")
    if cuda:
        c = torch.as_tensor(coords, device=dev)
        consts, state = bdim.make_consts(cfg, c), bdim.init_state(cfg, n_designs, dev)

        def step():
            with torch.no_grad():
                bdim.bdim_step(cfg, consts, state)

        step()
        torch.cuda.synchronize()
        step_ms = event_ms(torch, step, reps=5)
        rec.update(step_ms=step_ms, step_host_ms=host_ms(torch, step, reps=5),
                   step_device=device_busy(torch, step, step_ms))
    return rec


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its printing captured: (result, printed lines)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args, **kw)
    return result, out.getvalue().strip().splitlines()


def zero_launches(phase: str) -> dict:
    """The 1D kernels' counters since the last reset, the weight layouts'
    among them (``stage_weights``); raises unless all 0 (the 2D paths run
    plain PyTorch)."""
    counts = {**read_counts(backwards=True), "stage_weights": staged_launches()}
    if any(counts.values()):
        raise AssertionError(f"the {phase} phase launched a kernel of the 1D paths: {counts}")
    return counts


def run_datagen(torch, dev, cuda: bool, work: str, n_sims: int = DATAGEN_SIMS,
                protocol: tuple[int, int] = DATAGEN_PROTOCOL,
                check: tuple[int, int, int] = DATAGEN_CHECK) -> dict:
    """Phase 13: ``generate_airfoil_sims`` on the card for ``n_sims``
    simulations at train_2d's test-data protocol into ``work/data`` (the
    cache every later 2D phase reads), then 2 simulations after a few steps
    on the card against the port's CPU run (boundary, mask and offset
    exact; each field within 1e-4 of its max magnitude, forces 1e-3)."""
    import numpy as np

    from cindm_tpu_torch.data.airfoil import SIM_CHUNK, AirfoilDatasetConfig, generate_airfoil_sims

    reset_counts()
    n_warmup, n_record = protocol
    cfg = AirfoilDatasetConfig(n_warmup=n_warmup, time_stamps=n_record)
    t0 = time.perf_counter()
    data = generate_airfoil_sims(0, n_sims, cfg, cache_dir=os.path.join(work, "data"), device=dev)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sims, w, r = check
    small = AirfoilDatasetConfig(n_warmup=w, time_stamps=r)
    card, cpu = (generate_airfoil_sims(1, sims, small, device=d) for d in (dev, "cpu"))
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    field_err = {name: rel(card["fields"][..., c], cpu["fields"][..., c])
                 for c, name in enumerate(("vx", "vy", "p"))}
    checks = {
        "shapes": data["fields"].shape == (n_sims, n_record, 62, 62, 3)
        and data["forces"].shape == (n_sims, n_record, 1, 2),
        "finite": all(bool(np.isfinite(v).all()) for v in data.values()),
        "geometry_exact": all(np.array_equal(card[k], cpu[k]) for k in ("boundary", "mask", "offset")),
        "fields_card_vs_cpu": all(e <= DATAGEN_TOL for e in field_err.values()),
        "forces_card_vs_cpu": rel(card["forces"], cpu["forces"]) <= DATAGEN_FORCE_TOL,
    }
    rec = {"sims": n_sims, "n_warmup": n_warmup, "n_record": n_record, "chunk": SIM_CHUNK,
           "seconds": seconds, "design_steps_per_s": n_sims * (n_warmup + n_record) / seconds,
           "check": {"sims": sims, "n_warmup": w, "n_record": r, "field_max_err_over_max_abs": field_err,
                     "forces_max_err_over_max_abs": rel(card["forces"], cpu["forces"]),
                     "tolerance": DATAGEN_TOL, "force_tolerance": DATAGEN_FORCE_TOL},
           "checks": checks}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"datagen phase checks failed: {failed}; {rec}")
    if cuda:
        # the batch generate_airfoil_sims takes beside the JAX package's 16
        rec["chunk_steps"] = [time_sim_chunk(torch, dev, d) for d in (16, SIM_CHUNK)]
    rec["launches"] = zero_launches("datagen")
    return rec


def time_sim_chunk(torch, dev, designs: int) -> dict:
    """One BDIM step of ``designs`` datagen boundaries (one airfoil each)
    on the card: card ms (CUDA events), host ms, design·steps/s."""
    import numpy as np

    from cindm_tpu_torch.data.airfoil import AirfoilDatasetConfig, draw_boundaries
    from cindm_tpu_torch.physics import bdim

    acfg = AirfoilDatasetConfig()
    cfg = bdim.BDIMConfig(n=acfg.grid)
    coords = torch.as_tensor(draw_boundaries(np.random.default_rng(2), designs, acfg), device=dev)
    consts, state = bdim.make_consts(cfg, coords[:, None]), bdim.init_state(cfg, designs, dev)

    def step():
        with torch.no_grad():
            bdim.bdim_step(cfg, consts, state)

    step()
    torch.cuda.synchronize()
    ms = event_ms(torch, step, reps=5)
    return {"designs": designs, "step_ms": ms, "step_host_ms": host_ms(torch, step, reps=5),
            "design_steps_per_s": designs * 1e3 / ms}


def cached_sampler(dev, work: str, batch: int):
    """The device sampler (``make_device_sampler``) over the datagen phase's
    cached simulations, windowed as train_2d windows them."""
    from cindm_tpu_torch.data.airfoil import AirfoilDataset, AirfoilDatasetConfig, generate_airfoil_sims

    cfg = AirfoilDatasetConfig(time_stamps=DATAGEN_PROTOCOL[1], n_warmup=DATAGEN_PROTOCOL[0])
    data = generate_airfoil_sims(0, DATAGEN_SIMS, cfg, cache_dir=os.path.join(work, "data"), device=dev)
    return AirfoilDataset(data, cfg).make_device_sampler(batch, device=dev)


def time_train2d_step(torch, dev, work: str, batch: int, remat: bool) -> dict:
    """One optimizer step of the full-width Unet2D at ``batch`` on the card
    (CUDA events over 5 steps, the garbage collector paused), its peak
    memory and device busy share."""
    from cindm_tpu_torch.models import Unet2D
    from cindm_tpu_torch.sampling.diffusion2d import Diffusion2DConfig
    from cindm_tpu_torch.train import TrainConfig, init_train_state, make_train_step_2d

    draw = cached_sampler(dev, work, batch)
    cfg = Diffusion2DConfig()
    model = Unet2D(64, (1, 2), 21, remat=remat, generator=torch.Generator().manual_seed(20)).to(dev)
    state = init_train_state(model, TrainConfig())
    g = torch.Generator(device=dev).manual_seed(21)
    step = make_train_step_2d(cfg, cfg.make_schedule(dev), TrainConfig(), generator=g)
    b = draw(draw.arrays, g)
    fn = lambda: step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # the first step: cuDNN's plans for these shapes are chosen here
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    # the interpreter's full collections (one costs what ``collect_s`` reads,
    # with the earlier phases' objects alive) stay out of the timed steps,
    # as in timeit
    t0 = time.perf_counter()
    gc.collect()
    collect_s = time.perf_counter() - t0
    gc.disable()
    try:
        ms = event_ms(torch, fn, reps=5)
    finally:
        gc.enable()
    return {"remat": remat, "batch": batch, "first_step_s": first_s, "step_ms": ms,
            "full_collection_s": collect_s, "tracked_objects": len(gc.get_objects()),
            "samples_per_s": batch * 1e3 / ms, "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "device": device_busy(torch, fn, ms)}


def remat_grad_err(torch, dev, work: str, batch: int) -> dict:
    """The p_losses_2d gradient of the full-width Unet2D with remat against
    without, same weights, batch and draws, with cuDNN's default algorithms
    and with its deterministic ones; beside each, a second plain gradient
    against the first (the spread of two identical runs). Each reading is
    the worst parameter's max |d| / max |plain|. Also the forward calls the
    first ResnetBlock2D makes in one remat gradient."""
    import copy

    from cindm_tpu_torch.models import Unet2D
    from cindm_tpu_torch.sampling.diffusion2d import Diffusion2DConfig, nhwc_model, p_losses_2d

    draw = cached_sampler(dev, work, batch)
    g = torch.Generator(device=dev).manual_seed(22)
    b = draw(draw.arrays, g)
    t = torch.randint(0, 1000, (batch,), generator=g, device=dev)
    noise, noise_cond = (torch.randn(b[k].shape, generator=g, device=dev) for k in ("x", "cond"))
    cfg = Diffusion2DConfig()
    sched = cfg.make_schedule(dev)
    plain = Unet2D(64, (1, 2), 21, generator=torch.Generator().manual_seed(23)).to(dev)
    remat = copy.deepcopy(plain)
    remat.remat = True

    def grads(m):
        loss = p_losses_2d(cfg, sched, nhwc_model(m), b["x"], b["cond"], t=t, noise=noise,
                           noise_cond=noise_cond)
        return torch.autograd.grad(loss, list(m.parameters()))

    def err(got, want):
        return max(float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                   for a, c in zip(got, want))

    calls = []
    # a pre-hook: the recompute stops once it has what the backward needs,
    # before a forward hook would fire
    hook = remat.rbs[0].register_forward_pre_hook(lambda *a: calls.append(1))
    gp, gr = grads(plain), grads(remat)
    hook.remove()
    rec = {"max_err_over_max_abs": err(gr, gp), "plain_vs_plain": err(grads(plain), gp),
           "tolerance": REMAT_GRAD_TOL, "first_block_forward_calls": len(calls)}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gp = grads(plain)
        rec["deterministic"] = {"max_err_over_max_abs": err(grads(remat), gp),
                                "plain_vs_plain": err(grads(plain), gp)}
    finally:
        torch.backends.cudnn.deterministic = was
    return rec


def run_train2d(torch, dev, cuda: bool, work: str, train_args: list[str] = TRAIN2D_ARGS,
                steps: tuple[int, int, int] = TRAIN2D_STEPS, batch: int = TRAIN2D_BATCH) -> dict:
    """Phase 14: on the card, one step with and without remat at ``batch``
    (the first step's seconds; then ms, samples/s, peak memory, busy share)
    and the remat gradient against the plain one; then
    ``cindm_tpu_torch.cli.train_2d`` on the datagen phase's data,
    ``steps[0]`` steps without remat (milestones every ``steps[1]``), then
    ``--resume True --remat True`` to ``steps[2]``: finite losses,
    milestones, the resume, snapshots."""
    from cindm_tpu_torch.cli.train_2d import main as train_main
    from cindm_tpu_torch.train import CheckpointManager

    n_steps, every, resumed_to = steps
    results = os.path.join(work, "airfoil")
    base = [*train_args, "--device", str(dev), "--data_cache", os.path.join(work, "data"),
            "--results_folder", results, "--save_and_sample_every", str(every), "--log_every", "1"]
    reset_counts()
    rec = {}
    if cuda:
        rec["step_plain"] = time_train2d_step(torch, dev, work, batch, remat=False)
        rec["step_remat"] = time_train2d_step(torch, dev, work, batch, remat=True)
        rec["remat_grad"] = remat_grad_err(torch, dev, work, batch)
    runs = []
    for extra in (["--train_num_steps", str(n_steps), "--remat", "False"],
                  ["--train_num_steps", str(resumed_to), "--resume", "True", "--remat", "True"]):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, lines = quiet(train_main, base + extra)
        if cuda:
            torch.cuda.synchronize()
        record = json.loads(lines[-1])
        losses = [float(x.split("loss ")[1]) for x in lines if x.startswith("step ")]
        runs.append({"seconds": time.perf_counter() - t0, "record": record, "losses": losses,
                     "first_step_s": record["first_step_seconds"],
                     "steady_ms_per_step": record["steady_ms_per_step"],
                     "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else "not measured"})
    first, second = runs
    snaps = sorted(f for f in os.listdir(results) if f.startswith("persisted_m"))
    checks = {
        "losses_finite": all(math.isfinite(x) for r in runs for x in r["losses"])
        and len(first["losses"]) == n_steps and len(second["losses"]) == resumed_to - n_steps,
        "batch": first["record"]["batch_size"] == batch,
        "milestones": CheckpointManager(results).all_milestones()
        == list(range(every, resumed_to + 1, every)),
        "resumed": second["record"]["start_step"] == n_steps and second["record"]["step"] == resumed_to,
        "snapshots": snaps == [f"persisted_m{n_steps}.npz", f"persisted_m{resumed_to}.npz"],
    }
    rec.update(runs=runs, checks=checks)
    if cuda:
        checks["remat_grad"] = rec["remat_grad"]["max_err_over_max_abs"] <= REMAT_GRAD_TOL
        checks["remat_grad_deterministic"] = (
            rec["remat_grad"]["deterministic"]["max_err_over_max_abs"] <= REMAT_GRAD_TOL)
        # once in the forward, once more when the backward recomputes it
        checks["remat_recomputes"] = rec["remat_grad"]["first_block_forward_calls"] == 2
        checks["remat_peak_lower"] = rec["step_remat"]["peak_bytes"] < rec["step_plain"]["peak_bytes"]
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train2d phase checks failed: {failed}; {rec}")
    rec["launches"] = zero_launches("train2d")
    return rec


def run_train_force(torch, dev, cuda: bool, work: str, force_args: list[str] = FORCE_ARGS) -> dict:
    """Phase 15: ``cindm_tpu_torch.cli.train_force`` on the datagen phase's
    data: finite losses, ms a step, the milestone and snapshot."""
    from cindm_tpu_torch.cli.train_force import main as force_main

    results = os.path.join(work, "force")
    reset_counts()
    t0 = time.perf_counter()
    _, lines = quiet(force_main, [*force_args, "--device", str(dev), "--results_folder", results,
                                  "--data_cache", os.path.join(work, "data")])
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = json.loads(lines[-1])
    losses = [float(x.split("loss ")[1]) for x in lines if x.startswith("step ")]
    checks = {"losses_finite": bool(losses) and all(math.isfinite(x) for x in losses),
              "files": {"model-1.pt", "persisted_m1.npz"} <= set(os.listdir(results))}
    out = {"seconds": seconds, "record": rec, "losses": losses, "ms_per_step": rec["ms_per_step"],
           "first_step_s": rec["first_step_seconds"], "steady_ms_per_step": rec["steady_ms_per_step"],
           "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"train_force phase checks failed: {out}")
    out["launches"] = zero_launches("train_force")
    return out


def run_closed_loop(torch, dev, cuda: bool, work: str, args: list[str] = CLOSED_LOOP_ARGS) -> dict:
    """Phase 16: ``design_2d --model_path <train2d's folder>
    --force_model_path <train_force's folder>``: what the port trains, the
    port loads; the record has the JAX CLI's keys and is finite."""
    from cindm_tpu_torch.cli.design_2d import main as design_main

    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    record, lines = quiet(design_main, ["--model_path", os.path.join(work, "airfoil"),
                                        "--force_model_path", os.path.join(work, "force"),
                                        "--device", str(dev), *args], timings=timings)
    if cuda:
        torch.cuda.synchronize()
    keys = DESIGN2D_RECORD_KEYS | (DESIGN2D_SCORE_KEYS if record["valid_designs"] else set())
    checks = {"record_keys": set(record) == keys,
              "record_finite": all(math.isfinite(v) for v in record.values() if not isinstance(v, str))}
    out = {"seconds": time.perf_counter() - t0, "record": record, "part_seconds": timings,
           "args": args, "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"closed-loop phase checks failed: {out}; {lines[-3:]}")
    out["launches"] = zero_launches("closed_loop")
    return out


def run_baselines2d(torch, dev, cuda: bool, work: str, extra: list[str] | None = None,
                    check_batch: int = BASELINES2D_CHECK_BATCH) -> dict:
    """Phase 17: ``cindm_tpu_torch.cli.train_baseline --algo fno`` and
    ``--algo lepde`` at their defaults on the datagen phase's simulations
    (the save -> reload check passes, the experiment record has the JAX
    CLI's keys and finite losses); then FNO2d (modes 12, width 32) and
    LE-PDE (latent 160) at full width on the card against the port's CPU
    run of the same weights and inputs."""
    import copy

    from cindm_tpu_torch.baselines import FNO2d, LEPDE, LEPDEConfig

    from cindm_tpu_torch.cli.train_baseline import main as base_main

    reset_counts()
    runs = {}
    for algo in ("fno", "lepde"):
        folder = os.path.join(work, algo)
        t0 = time.perf_counter()
        _, lines = quiet(base_main, ["--algo", algo, "--device", str(dev), "--results_folder", folder,
                                     "--data_cache", os.path.join(work, "data"), *(extra or [])])
        if cuda:
            torch.cuda.synchronize()
        rec_file = [f for f in os.listdir(folder) if f.startswith("record_")]
        with open(os.path.join(folder, rec_file[0])) as f:
            record = json.load(f)
        checks = {"unittest_model": any(x.startswith("unittest_model passed") for x in lines),
                  "record_keys": set(record) == EXPERIMENT_RECORD_KEYS,
                  "losses_finite": finite_leaves({k: v for k, v in record["final"].items()
                                                  if v is not None})}
        runs[algo] = {"seconds": time.perf_counter() - t0, "final": record["final"],
                      "history": record["history"], "checks": checks}
        if not all(checks.values()):
            raise AssertionError(f"train_baseline --algo {algo} checks failed: {runs[algo]}; {lines[-3:]}")
    g = torch.Generator().manual_seed(30)
    u = torch.rand((check_batch, 3, 64, 64), generator=g) * 2 - 1
    static = torch.rand((check_batch, 3, 64, 64), generator=g)
    fno = FNO2d(6, 3, modes=12, width=32, generator=torch.Generator().manual_seed(31))
    lepde = LEPDE(LEPDEConfig(latent_size=160), out_hw=64, generator=torch.Generator().manual_seed(32))
    errs = {}
    with torch.no_grad():
        for name, m, fn in (("FNO2d", fno, lambda m, a, s: m(torch.cat([a, s], dim=1))),
                            ("LEPDE", lepde, lambda m, a, s: m(a, s, 2))):
            want = fn(m.eval(), u, static)
            errs[name] = rel_err(torch, fn(copy.deepcopy(m).to(dev), u.to(dev), static.to(dev)), want)
    out = {"runs": runs, "check_batch": check_batch, "card_vs_cpu_max_err_over_max_abs": errs,
           "tolerance": BASELINES2D_TOL}
    if any(e > BASELINES2D_TOL for e in errs.values()):
        raise AssertionError(f"2D surrogates on {dev} disagree with the CPU: {out}")
    out["launches"] = zero_launches("baselines2d")
    return out


def run_design2d_baseline(torch, dev, cuda: bool, work: str, cuts: list[str] = D2B_CUTS,
                          full: list[str] = D2B_FULL) -> dict:
    """Phase 18: ``cindm_tpu_torch.cli.design_2d_baseline``, GD and CEM over
    the baselines2d phase's FNO and LE-PDE and train_force's ForceUnet, with
    1 and 2 boundaries, under ``cuts``; GD over FNO at 1 boundary once more
    under ``full`` (the full scoring protocol): every record has the JAX
    CLI's keys (plus the scores when a design is valid) and is finite."""
    from cindm_tpu_torch.cli.design_2d_baseline import main as d2b_main

    reset_counts()
    runs = []
    plan = [(m, s, k, cuts) for m in ("GD", "CEM") for s in ("fno", "lepde") for k in (1, 2)]
    plan.append(("GD", "fno", 1, full))
    for method, surrogate, k, flags in plan:
        timings = {}
        t0 = time.perf_counter()
        record, lines = quiet(d2b_main, [
            "--design_method", method, "--surrogate", surrogate, "--num_boundaries", str(k),
            "--surrogate_path", os.path.join(work, surrogate),
            "--force_model_path", os.path.join(work, "force"),
            "--data_dir", os.path.join(work, "d2b_data"), "--device", str(dev), *flags],
            timings=timings)
        if cuda:
            torch.cuda.synchronize()
        keys = D2B_RECORD_KEYS[method] | (DESIGN2D_SCORE_KEYS if record["valid_designs"] else set())
        checks = {"record_keys": set(record) == keys,
                  "record_finite": all(math.isfinite(v) for v in record.values()
                                       if not isinstance(v, str))}
        run = {"design_method": method, "surrogate": surrogate, "num_boundaries": k, "flags": flags,
               "seconds": time.perf_counter() - t0, "part_seconds": timings, "record": record,
               "checks": checks}
        if not all(checks.values()):
            raise AssertionError(f"design_2d_baseline run failed its checks: {run}; {lines[-3:]}")
        runs.append(run)
    return {"runs": runs, "launches": zero_launches("design2d_baseline")}


def run_train2d_path(torch, dev, cuda: bool, info: dict, datagen: dict | None = None,
                     train2d: dict | None = None, force: dict | None = None,
                     closed_loop: dict | None = None, baselines2d: dict | None = None,
                     design2d_baseline: dict | None = None) -> dict:
    """Phases 13-18 in one scratch directory (the simulations, the trained
    priors and surrogates pass from phase to phase through it); each prints
    its line. Returns the 1D kernels' counters per phase (all 0)."""
    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    phases = [("datagen", run_datagen, datagen), ("train2d", run_train2d, train2d),
              ("train_force", run_train_force, force), ("closed_loop", run_closed_loop, closed_loop),
              ("baselines2d", run_baselines2d, baselines2d),
              ("design2d_baseline", run_design2d_baseline, design2d_baseline)]
    counts = {}
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-2d-") as work:
        for name, fn, kw in phases:
            t0 = time.perf_counter()
            rec = fn(torch, dev, cuda, work, **(kw or {}))
            if cuda:
                torch.cuda.synchronize()
            emit({"phase": name, "seconds": time.perf_counter() - t0, "device": info["name"],
                  "power_limit_line": info["smi"], **rec})
            counts[name] = rec["launches"]
    return counts


# Phase 19, multigpu. The card box has one GPU, and NCCL refuses two ranks on
# one device: (a) runs the CLIs' --n_devices 1 (a one-rank NCCL group) against
# the same runs without it, (b) two ranks on the one card over gloo against
# one process. Nothing here measures scaling.
MULTIGPU_EXACT_TOL = 1e-6  # (a): losses and parameters, of their largest entry
MULTIGPU_TOL = 1e-4  # (b): the train step's gradient, 2 ranks vs 1 process, per parameter
# (b): the samples, 2 ranks vs 1 process, of the largest entry. A split changes
# the batch of every model call, and with it the fp32 rounding of the library
# matmuls and convolutions (about 1e-6 of the output); the first reverse step
# divides the noise prediction by sqrt(alphas_cumprod[T-1]) (1e-2 at 5 steps),
# which carries that rounding to 1e-4 of the sample: on the CPU one process at
# 2 designs against two calls of 1 read 1.0e-4 with no process group at all.
MULTIGPU_SAMPLE_TOL = 1e-3
# the record design_1d prints, cindm_tpu/cli/design_1d.py:164-175
DESIGN1D_RECORD_KEYS = {"design_obj", "design_obj_ci95", "MAE", "RMSE", "batch_size",
                        "design_guidance", "n_composed", "compose_n_bodies",
                        "normalize_grad_per_body"}


def start_ranks(outdir: str, device: str, sizes: dict, world: int = 2,
                timeout_s: float = 600.0) -> list[dict]:
    """``world`` ranks of ``cindm_tpu_torch.tools.data_parallel``, started
    with torchrun's environment on one free localhost port (more ranks than
    cards: gloo on ``cuda:0``), each building the kernels into one new root
    ``<outdir>/kernels`` at once; each rank's record. Raises, with the tail
    of every rank's log, if a rank fails or outlasts ``timeout_s``; no rank
    outlives the call."""
    import socket

    from cindm_tpu_torch.tools.data_parallel import load_ranks

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    try:
        for r in range(world):
            # torchrun's environment; the ranks share the host's cores
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world),
                       OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)))
            logs.append(open(os.path.join(outdir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cindm_tpu_torch.tools.data_parallel", "--out",
                 os.path.join(outdir, "ranks"), "--device", device, "--sizes", json.dumps(sizes),
                 "--kernel-dir", os.path.join(outdir, "kernels")],
                env=env, cwd=REPO, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + timeout_s
        rcs = [p.wait(timeout=max(deadline - time.perf_counter(), 1.0)) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = ["timeout"] * world
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rc != 0 for rc in rcs):
        tails = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (rc {rcs[r]}):\n" + "".join(f.readlines()[-30:]))
        raise AssertionError("multigpu ranks failed:\n" + "\n".join(tails))
    return load_ranks(os.path.join(outdir, "ranks"))


def run_multigpu(torch, dev, cuda: bool, model, train_args: list[str] = TRAIN_ARGS,
                 design_args: list[str] = DESIGN_ARGS, sizes: dict | None = None) -> dict:
    """Phase 19: (a) ``train_1d`` (the train phase's configuration, 5 steps)
    and ``design_1d`` (the flagship, 5 steps) with ``--n_devices 1``, a
    one-rank NCCL group: the training run against the same run without
    ``--n_devices`` (losses and final parameters within 1e-6 of their
    largest entry, cuDNN deterministic), the design record with the JAX
    keys and finite, their launches; (b) two ranks on the one card over
    gloo against one process (``tools.data_parallel.cases``: the gradient
    within 1e-4, the samples within 1e-3 of the largest entry), and both
    ranks' kernel build into one new root at once."""
    import numpy as np
    import torch.distributed as dist

    from cindm_tpu_torch.cli.design_1d import main as design_main
    from cindm_tpu_torch.cli.train_1d import main as train_main
    from cindm_tpu_torch.tools.data_parallel import SIZES, cases, relative_errors

    sizes = {**SIZES, **(sizes or {})}
    steps = sizes["steps"]  # train_1d steps; design_1d and sampler reverse steps
    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    checks, rec = {}, {"sizes": sizes}
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-multigpu-") as tmp:
        base = [*train_args, "--device", str(dev), "--train_num_steps", str(steps),
                "--save_and_sample_every", str(steps), "--log_every", "1",
                "--dataset_path", os.path.join(tmp, "data")]
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # both runs take the same algorithms
        try:
            quiet(train_main, base + ["--results_folder", os.path.join(tmp, "plain")])
            reset_counts()
            _, lines = quiet(train_main, base + ["--results_folder", os.path.join(tmp, "one"),
                                                 "--n_devices", "1"])
            train_counts = read_counts(backwards=True)
            train_staged = staged_counts()
        finally:
            torch.backends.cudnn.deterministic = was
        runs = {}
        for name in ("plain", "one"):
            res = os.path.join(tmp, name)
            runs[name] = (np.load(os.path.join(res, "loss_curve.npy"))[:, 1],
                          torch.load(os.path.join(res, f"model-{steps}.pt")))
        (lp, mp), (lo, mo) = runs["plain"], runs["one"]
        loss_err = float(np.abs(lo - lp).max() / np.abs(lp).max())
        param_err = max(rel(mo[part][k], mp[part][k]) for part in ("params", "ema_params")
                        for k in mp[part])
        record1 = json.loads(lines[-1])
        rec["a_train"] = {"loss_err": loss_err, "param_err": param_err, "losses": lo.tolist(),
                          "record": record1, "launches": train_counts, **train_staged}
        checks["a_train_equal"] = (len(lo) == len(lp) == steps and loss_err <= MULTIGPU_EXACT_TOL
                                   and param_err <= MULTIGPU_EXACT_TOL)
        checks["a_group_destroyed"] = not dist.is_initialized()
        write_snapshot(model, os.path.join(tmp, "snap"))
        reset_counts()
        record, _ = quiet(design_main, ["--model_path", os.path.join(tmp, "snap"), "--timesteps",
                                        str(steps), "--device", str(dev), *design_args,
                                        "--n_devices", "1"])
        design_counts = read_counts(backwards=True)
        rec["a_design"] = {"record": record, "launches": design_counts, **staged_counts()}
        checks["a_design_record"] = (set(record) == DESIGN1D_RECORD_KEYS and all(
            math.isfinite(record[k]) for k in ("design_obj", "design_obj_ci95", "MAE", "RMSE")))
        if cuda:
            n = steps
            checks["a_launches"] = (
                train_counts == {"fused_rtb": 16 * n, "fused_conv1d_gn_mish": n,
                                 "FusedRTB_launches": 16 * n, "FusedRTB_backward_passes": 16 * n,
                                 "FusedConv1dGNMish_launches": n,
                                 "FusedConv1dGNMish_backward_passes": n,
                                 "fused_rtb_backward": 16 * n, "fused_conv1d_gn_mish_backward": n,
                                 "prenorm_linear_attention": 0, "prenorm_linear_attention_autograd": 8 * n,
                                 "upsample1d": 0, "upsample1d_autograd": 3 * n,
                                 "downsample1d": 0, "downsample1d_autograd": 3 * n}
                and design_counts["fused_rtb"] == 16 * RECURRENCE * n
                and design_counts["fused_conv1d_gn_mish"] == RECURRENCE * n
                and design_counts["prenorm_linear_attention"] == 8 * RECURRENCE * n
                and design_counts["upsample1d"] == design_counts["downsample1d"] == 3 * RECURRENCE * n)
        rec["launches"] = {k: train_counts[k] + design_counts[k] for k in train_counts}

        t0 = time.perf_counter()
        ref = cases(dev, None, sizes)
        rec["one_process_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = start_ranks(tmp, str(dev), sizes)
        rec["ranks_seconds"] = time.perf_counter() - t0
    errs = [relative_errors(r, ref) for r in ranks]
    rec["b"] = {"errors": errs, "ms_one_process": ref["ms"], "ms_per_rank": [r["ms"] for r in ranks],
                "launches_one_process": ref["launches"],
                "launches_per_rank": [r["launches"] for r in ranks],
                "build_seconds_per_rank": [r.get("build_seconds") for r in ranks],
                "library": [r.get("library") for r in ranks]}
    checks["b_equal"] = all(e["grad"] <= MULTIGPU_TOL and e["sample_1d"] <= MULTIGPU_SAMPLE_TOL
                            and e["sample_2d"] <= MULTIGPU_SAMPLE_TOL for e in errs)
    checks["b_shapes"] = all(r["sample_1d"].shape == ref["sample_1d"].shape
                             and r["sample_2d"].shape == ref["sample_2d"].shape for r in ranks)
    if cuda:
        checks["b_one_library"] = (len(set(rec["b"]["library"])) == 1
                                   and all(r["compile_cache"] for r in ranks))
        checks["b_launches"] = all(
            r["launches"]["train_step"]["FusedRTB_launches"] == 16
            and r["launches"]["train_step"]["fused_rtb_backward"] == 16
            and r["launches"]["train_step"]["fused_conv1d_gn_mish_backward"] == 1
            and r["launches"]["sampler_1d"]["fused_rtb"] == 16 * RECURRENCE * steps
            and r["launches"]["sampler_1d"]["fused_conv1d_gn_mish"] == RECURRENCE * steps
            and r["launches"]["train_step"]["prenorm_linear_attention"] == 0
            and r["launches"]["sampler_1d"]["prenorm_linear_attention"] == 8 * RECURRENCE * steps
            and r["launches"]["train_step"]["upsample1d"] == r["launches"]["train_step"]["downsample1d"] == 0
            and r["launches"]["sampler_1d"]["upsample1d"] == 3 * RECURRENCE * steps
            and r["launches"]["sampler_1d"]["downsample1d"] == 3 * RECURRENCE * steps
            and not any(r["launches"]["sampler_2d"].values()) for r in ranks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"multigpu phase checks failed: {failed}; {rec}")
    return {**rec, "checks": checks}


def check_gn_ctas(bprof: dict) -> None:
    """Every gn_mish_bwd launch of the backward pass at the training batch
    runs at least GN_MIN_CTAS CTAs (one an SM of the H100), 17 launches."""
    launches = bprof["kernels"]["gn_mish_bwd"]["per_launch"]
    small = [l for l in launches if l["ctas"] < GN_MIN_CTAS]
    if len(launches) != len(RTB_SHAPES) + 1 or small:
        raise AssertionError(f"gn_mish_bwd launches under {GN_MIN_CTAS} CTAs at {GN_CTAS_BATCH}: {small}")


def check_kernel_build(_build, sass, name: str, instances: int, wgmma: bool = True) -> dict:
    """The registers and spills from ptxas of the kernels whose mangled name
    holds ``name`` and their tensor-core instructions from cuobjdump, each
    of the ``instances``: they must spill nothing and, with ``wgmma``, issue
    wgmma (HGMMA) and no mma.sync (HMMA). ptxas's notes on them (C75xx: a
    serialized wgmma pipeline, C7512; an injected fence, C7519) are kept
    beside."""
    res = _build.ptxas_kernel(name)
    counts = {k: v for k, v in sass.items() if name in k} if isinstance(sass, dict) else sass
    if not isinstance(res, dict) or len(res) != instances:
        raise AssertionError(f"no ptxas report of all {instances} instances of {name}: {res}")
    if any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in res.values()):
        raise AssertionError(f"{name} spills registers: {res}")
    if wgmma and isinstance(counts, dict) and not (len(counts) == instances and all(
            c["HGMMA"] > 0 and c["HMMA"] == 0 for c in counts.values())):
        raise AssertionError(f"{name} should issue wgmma and no mma.sync: {counts}")
    notes = [l.split("ptxas info    : ")[-1] for l in _build.ptxas_report().splitlines()
             if name in l and "(C75" in l]
    return {"ptxas": res, "sass": counts, "notes": notes}


def stage_instances(_build, record: dict, batches) -> dict:
    """The forward stage's instances in the build record, each with its
    template arguments (N tile, tap window KW: 3 = position-major with A by
    descriptor, 5 = row-major with A from registers; proj: with the 1x1
    projection; saving), its registers, spills, tensor-core instructions and
    ptxas notes, and the cluster sizes that the flagship's plans give its
    launches at ``batches``."""
    clusters = {}
    for B in batches:
        for i, (C, O, T) in enumerate(RTB_SHAPES + [HEAD_SHAPE]):
            plan = _build.plan_stage(B, T, C, O, 8)
            for proj in {False, i < len(RTB_SHAPES) and C != O}:  # a block's stages: the second projects
                key = (plan.n_tile, 3 if T == 3 else 5, proj)
                clusters.setdefault(key, set()).add(plan.cluster)
    sass = record["sass"] if isinstance(record["sass"], dict) else {}
    out = {}
    for name, regs in record["ptxas"].items():
        m = re.search(r"conv_gn_mish_stageILi(\d+)ELi(\d)ELb([01])E", name)
        key = (int(m[1]), int(m[2]), m[3] == "1")
        out[name] = {"n_tile": key[0], "kw": key[1], "proj": key[2],
                     "saving": "SaveArgs" in name,
                     **regs, **sass.get(name, {}),
                     "notes": [n for n in record["notes"] if name in n],
                     "clusters": sorted(clusters.get(key, ()))}
    return out


def kernels_line(checks: dict, counts: dict, slice5: dict) -> dict:
    meta = {
        "fused_rtb": ("cindm_tpu_torch/ops/csrc/fused_rtb.cu", "cindm_tpu/ops/fused_rtb.py:179"),
        "fused_conv1d_gn_mish": ("cindm_tpu_torch/ops/csrc/fused_conv_gn.cu",
                                 "cindm_tpu/ops/fused_conv_gn.py:112"),
    }
    extra = {"fused_rtb": ("shapes_analysis", slice5["rtb_analysis"]),
             "fused_conv1d_gn_mish": ("shapes_forward_model", slice5["conv_forward_model"])}
    out = []
    for name, rows in checks.items():
        source, replaces = meta[name]
        by = {r["bound_tc_by"] for r in rows}
        key, more = extra[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows + more),
            "max_rel_err": max(r["max_rel_err"] for r in rows + more),
            # one denoiser forward's worth: the sum over this kernel's shapes
            "ms": sum(r["kernel_ms"] or 0.0 for r in rows),
            "plain_ms": sum(r["plain_ms"] or 0.0 for r in rows),
            # of "ms": the weight layouts' launches alone (stage_weights)
            "stage_weights_ms": sum(r["stage_weights_ms"] or 0.0 for r in rows),
            # the kernels run 3xTF32 on the tensor cores: their operations at
            # TF32's peak; the fp32 bound of the CUDA cores beside it
            "bound_ms": sum(r["bound_tc_ms"] for r in rows),
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "bound_fp32_ms": sum(r["bound_ms"] for r in rows),
            "library_ms": None,
            "shapes": rows,
            # the analysis and baseline paths' shapes, each timed beside its bounds
            key: more,
        })
    return {"kernels": out}


def vjp_entries(blocks: dict, counts: dict, ana_counts: dict, base_counts: dict,
                slice5: dict, bprof: dict | str) -> list[dict]:
    """The autograd Functions' entries: the saving kernel forward plus the
    backward kernel, fwd+bwd over the 16 block shapes (and the head) at the
    training batch. ``launches`` counts the forward calls through
    ``FusedRTB`` in the training phase and ``backward_launches`` the
    backward kernel's calls there; ``backward_ms`` is the backward kernel
    alone, beside its bounds (3xTF32 and fp32); ``backward_kernels`` (the
    blocks' entry) the six kernels of one backward pass of the 16 blocks
    and the head, each beside its bound, wgrad beside its library call."""
    meta = [
        ("fused_rtb_differentiable", "cindm_tpu/ops/fused_rtb.py:267", "cindm_tpu_torch/ops/fused_rtb.py",
         "cindm_tpu_torch/ops/csrc/fused_rtb.cu", "FusedRTB_launches", "fused_rtb_backward"),
        ("fused_conv1d_gn_mish_differentiable",
         "none: the JAX package never differentiates cindm_tpu/ops/fused_conv_gn.py:112",
         "cindm_tpu_torch/ops/fused_conv_gn.py", "cindm_tpu_torch/ops/csrc/fused_conv_gn.cu",
         "FusedConv1dGNMish_launches", "fused_conv1d_gn_mish_backward"),
    ]
    out = []
    for name, replaces, source, fwd_source, fwd_key, bwd_key in meta:
        rows = blocks[name]
        by = {r["bound_tc_by"] for r in rows}
        bwd_by = {r["backward_bound_by"] for r in rows}
        total = lambda k: sum(r[k] or 0.0 for r in rows)
        out.append({
            "name": name, "route": "cuda",
            "route_detail": "cuda forward + cuda backward",
            "source": source, "forward_source": fwd_source,
            "backward_source": ["cindm_tpu_torch/ops/csrc/block_backward.cu",
                                "cindm_tpu_torch/ops/csrc/conv_backward.cuh"],
            "replaces": replaces,
            "launches": counts[fwd_key],
            "backward_launches": counts[bwd_key],
            "max_abs_err": max(max(r["max_abs_err"], r["backward_max_abs_err"]) for r in rows),
            "max_rel_err": max(max(r["max_rel_err"], r["backward_max_rel_err"]) for r in rows),
            # fwd+bwd through the Function, summed over the shapes
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_tc_ms"),
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "bound_fp32_ms": total("bound_ms"),
            # the backward kernel alone, on the forward's saved tensors
            "backward_ms": total("backward_ms"), "backward_plain_ms": total("backward_plain_ms"),
            "backward_bound_ms": total("backward_bound_ms"),
            "backward_bound_by": bwd_by.pop() if len(bwd_by) == 1 else "operations",
            "backward_bound_fp32_ms": total("backward_bound_fp32_ms"),
            "library_ms": None,
            "shapes": rows,
            "launches_analysis": ana_counts[fwd_key],
            "backward_launches_analysis": ana_counts[bwd_key],
            "launches_baselines": base_counts[fwd_key],
            "backward_launches_baselines": base_counts[bwd_key],
        })
    out[0]["backward_kernels"] = bprof
    # the head Function at the forward model's shapes (batch 32; x-only at 4)
    more = slice5["conv_function_forward_model"]
    out[1]["shapes_forward_model"] = more
    for k in ("max_abs_err", "max_rel_err"):
        out[1][k] = max([out[1][k]] + [r[k] for r in more])
    return out


def reduce_entry(alone: dict, train: dict, bprof: dict | str) -> dict:
    """grad_reduce's entry: its launches inside the training phase's
    backwards (every one wants the weight gradients), and its standalone
    check at the backward pass's 17 job lists (bit for bit the in-order sum;
    ms of the 17 launches beside the plain version, the bound and
    ``torch.sum``); ``backward_pass_ms`` its device ms inside one backward
    pass (tools/backward_profile)."""
    first, second = train["runs"]
    return {"name": "grad_reduce", "route": "cuda", "source": "cindm_tpu_torch/ops/csrc/conv_backward.cuh",
            "replaces": "none of its own: part of the port of cindm_tpu/ops/fused_rtb.py:257 "
                        "(_fused_rtb_cv_bwd)",
            "launches": first["grad_reduce_launches"] + second["grad_reduce_launches"],
            "max_abs_err": alone["max_abs_err"], "ms": alone.get("ms"), "plain_ms": alone.get("plain_ms"),
            "bound_ms": alone["bound_ms"], "bound_by": alone["bound_by"],
            "library_ms": alone.get("library_ms"),
            "backward_pass_ms": (bprof["kernels"]["grad_reduce"]["ms"] if isinstance(bprof, dict)
                                 else "not measured"),
            "alone": alone}


def stage_weights_entry(checks: dict, des: dict, train: dict, ana: dict, base: dict, d2d: dict,
                        path2d: dict, multi: dict) -> dict:
    """stage_weights' entry: the weight layout of both stage kernels, one
    launch for a kernel call's weights that changed (``_build.staged``).
    ``launches`` / ``layouts``: the design phase's (each weight once);
    ``launches_train`` / ``layouts_train``: the training runs' (a call's
    weights in one launch, each step, after the optimizer's update); then
    per later path as the other entries count them (the 2D phases: 0,
    checked; the multigpu phase: (a), in the smoke's process). ms, plain ms,
    bytes and bound: one layout of the 16 blocks' and the head's weights at
    the folded batch's N tiles (phase 3), one launch a call, bit for bit the
    plain version's; ``at_train_batch``: the same at the training batch's
    N tiles."""
    rows = checks["fused_rtb"] + checks["fused_conv1d_gn_mish"]
    a = multi.get("a_train", {}), multi.get("a_design", {})

    def at(fields: list[dict]) -> dict:
        nbytes = sum(f["stage_weights_bytes"] for f in fields)
        device = [f["stage_weights_device_ms"] for f in fields]
        return {"ms": sum(f["stage_weights_ms"] or 0.0 for f in fields),
                "device_ms": sum(device) if all(isinstance(v, float) for v in device) else "not measured",
                "plain_ms": sum(f["stage_weights_plain_ms"] or 0.0 for f in fields),
                "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes": nbytes,
                "kernel_launches": sum(f["stage_weights_launches"] or 0 for f in fields),
                "n_tiles": [f["stage_weights_n_tile"] for f in fields]}

    main = at(rows)
    train_key = f"layout_{TRAIN_BATCH}"
    return {"name": "stage_weights", "route": "cuda", "source": "cindm_tpu_torch/ops/csrc/conv_gn_mish.cuh",
            "replaces": "none of its own: the weight layout of the ports of cindm_tpu/ops/fused_rtb.py:179 "
                        "and cindm_tpu/ops/fused_conv_gn.py:112",
            "launches": des["staging"]["launches"], "layouts": des["staging"]["layouts"],
            "launches_train": sum(r["staged_launches"] for r in train["runs"]),
            "layouts_train": sum(r["staged_layouts"] for r in train["runs"]),
            "launches_analysis": ana["staged_launches"], "layouts_analysis": ana["staged_layouts"],
            "launches_baselines": base["staged_launches"], "layouts_baselines": base["staged_layouts"],
            "launches_design2d": d2d["launches"]["stage_weights"],
            **{f"launches_{phase}": counts["stage_weights"] for phase, counts in path2d.items()},
            "launches_multigpu": sum(r.get("staged_launches", 0) for r in a),
            "layouts_multigpu": sum(r.get("staged_layouts", 0) for r in a),
            "max_abs_err": 0.0 if all(f["stage_weights_equal"] for r in rows for f in layout_rows(r))
            else float("inf"),
            "ms": main["ms"], "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "bytes": main["bytes"],
            "at_train_batch": at([r[train_key] for r in rows]) if all(train_key in r for r in rows) else None,
            "design_staging": des["staging"]}


def attention_entry(rows: list[dict], des: dict, train: dict, grad: dict, ana: dict, base: dict,
                    d2d: dict, path2d: dict, multi: dict) -> dict:
    """The attention kernel's entry: its launches on the design path and per
    path as the other entries count them; the training paths' blocks take
    their plain version under autograd (``autograd_calls_*``: 0 kernel
    launches there, checked). ms, plain ms and bounds summed over the
    flagship's 8 blocks (one forward's worth) at the folded batch; the
    errors over those and the direct model's untimed blocks."""
    first, second = train["runs"]
    errs = [e for r in rows for e in attention_errors(r)]
    rows = [r for r in rows if not r.get("untimed")]
    by = {r["bound_by"] for r in rows}
    per_rank = [c["train_step"]["prenorm_linear_attention"] + c["sampler_1d"]["prenorm_linear_attention"]
                for c in multi["b"]["launches_per_rank"]]
    key = "prenorm_linear_attention"
    return {
        "name": key, "route": "cuda", "source": "cindm_tpu_torch/ops/csrc/linear_attention.cu",
        "replaces": "none of its own: what XLA compiles for cindm_tpu/models/blocks.py:251 (PreNormResidual) "
                    "over :167 (LinearAttentionTemporal); no Pallas kernel computes it",
        "launches": des["launches"][key],
        "max_abs_err": max(e["max_abs_err"] for e in errs), "max_rel_err": max(e["max_rel_err"] for e in errs),
        "ms": sum(r["kernel_ms"] or 0.0 for r in rows), "plain_ms": sum(r["plain_ms"] or 0.0 for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": by.pop() if len(by) == 1 else "operations",
        "bound_fp32_ms": sum(r["bound_fp32_ms"] for r in rows), "library_ms": None,
        "shapes": rows,
        "launches_train": first["launches"][key] + second["launches"][key],
        "autograd_calls_train": (first["launches"][key + "_autograd"]
                                 + second["launches"][key + "_autograd"]),
        "launches_grad": grad["launches"][key], "autograd_calls_grad": grad["launches"][key + "_autograd"],
        "launches_analysis": ana["launches"][key], "launches_baselines": base["launches"][key],
        "autograd_calls_baselines": base["launches"][key + "_autograd"],
        "launches_design2d": d2d["launches"][key],
        **{f"launches_{phase}": counts[key] for phase, counts in path2d.items()},
        "launches_multigpu": multi["launches"][key], "launches_multigpu_ranks": per_rank,
    }


def resample_entries(rows: list[dict], des: dict, train: dict, grad: dict, ana: dict, base: dict,
                     d2d: dict, path2d: dict, multi: dict) -> list[dict]:
    """The resampling kernel's two entries, upsample1d and downsample1d: their
    launches on the design path and per path as the other entries count
    them (the training paths take the plain version under autograd:
    ``autograd_calls_*``); ms, plain ms (the cuDNN path they replace), the
    library call's ms (cuDNN alone) and bounds summed over the flagship's
    three convs of the kind (one forward's worth) at the folded batch; the
    errors over those and the untimed shapes."""
    first, second = train["runs"]
    out = []
    for key, kind, line in (("upsample1d", "up", 272), ("downsample1d", "down", 262)):
        mine = [r for r in rows if r["kind"] == kind]
        errs = [e for r in mine for e in attention_errors(r)]
        timed = [r for r in mine if not r.get("untimed")]
        by = {r["bound_by"] for r in timed}
        total = lambda k: sum(r.get(k) or 0.0 for r in timed)
        per_rank = [c["train_step"][key] + c["sampler_1d"][key] for c in multi["b"]["launches_per_rank"]]
        out.append({
            "name": key, "route": "cuda", "source": "cindm_tpu_torch/ops/csrc/resample.cu",
            "replaces": f"none of its own: what XLA compiles for cindm_tpu/models/blocks.py:{line} "
                        f"({'Upsample1d, nn.ConvTranspose' if kind == 'up' else 'Downsample1d, a Conv of stride 2'}); "
                        "no Pallas kernel computes it",
            "launches": des["launches"][key],
            "max_abs_err": max(e["max_abs_err"] for e in errs), "max_rel_err": max(e["max_rel_err"] for e in errs),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "device_ms": (total("device_ms") if all(isinstance(r.get("device_ms"), float) for r in timed)
                          else "not measured"),
            "phase_ms": total("phase_ms"),
            "bound_ms": total("bound_ms"), "bound_by": by.pop() if len(by) == 1 else "operations",
            "bound_fp32_ms": total("bound_fp32_ms"), "library_ms": total("library_ms"),
            "host_ms": total("host_ms"), "shapes": mine,
            "launches_train": first["launches"][key] + second["launches"][key],
            "autograd_calls_train": first["launches"][key + "_autograd"] + second["launches"][key + "_autograd"],
            "launches_grad": grad["launches"][key], "autograd_calls_grad": grad["launches"][key + "_autograd"],
            "launches_analysis": ana["launches"][key], "launches_baselines": base["launches"][key],
            "autograd_calls_baselines": base["launches"][key + "_autograd"],
            "launches_design2d": d2d["launches"][key],
            **{f"launches_{phase}": counts[key] for phase, counts in path2d.items()},
            "launches_multigpu": multi["launches"][key], "launches_multigpu_ranks": per_rank,
        })
    return out


def run(device: str, fold_batch: int, timesteps: int, design_args: list[str],
        train_batch: int = TRAIN_BATCH, train_args: list[str] = TRAIN_ARGS,
        train_steps: tuple[int, int, int, int] = (TRAIN_STEPS, TRAIN_SAVE_EVERY, RESUME_STEPS,
                                                  EVAL_SAMPLE_STEPS),
        analysis_kw: dict | None = None, baselines_kw: dict | None = None,
        unet2d_kw: dict | None = None, design2d_kw: dict | None = None,
        bdim_kw: dict | None = None, train2d_path_kw: dict | None = None,
        multigpu_kw: dict | None = None) -> dict:
    """Every phase; the keyword arguments shrink the later paths for a CPU
    rehearsal (``analysis_kw`` / ``baselines_kw`` / ``unet2d_kw`` /
    ``design2d_kw`` / ``bdim_kw`` / ``multigpu_kw`` go to ``run_analysis`` /
    ``run_baselines`` / ``run_unet2d`` / ``run_design2d`` / ``run_bdim`` /
    ``run_multigpu``; ``train2d_path_kw`` to ``run_train2d_path``)."""
    analysis_kw, baselines_kw = analysis_kw or {}, baselines_kw or {}
    import torch

    from cindm_tpu_torch.models import TemporalUnet1D
    from cindm_tpu_torch.ops import _build
    from cindm_tpu_torch.tools import backward_profile, forward_profile
    from cindm_tpu_torch.utils.device import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device(device)  # also turns TF32 off, as every entry point of the port does
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    info = {}
    info["smi"] = nvidia_smi_line() if cuda else "not measured"
    info["name"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    sync()
    emit({"phase": "device", "seconds": time.perf_counter() - t0, "name": info["name"],
          "nvidia_smi": info["smi"], "count": torch.cuda.device_count() if cuda else 0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    t0 = time.perf_counter()
    if cuda:
        _build.load()
    # "ptxas": the kernels' registers, spills and ptxas's notes (-Xptxas -v);
    # "sass_hgmma": their tensor-core instructions per kernel (HGMMA: wgmma,
    # HMMA: mma.sync), from cuobjdump; wgrad's and the dgrads' beside them, checked
    sass = _build.sass_mma_counts() if cuda else "not measured"
    # the forward's stage (N tiles 64 and 128 x tap windows 5 and 3 x with and
    # without the projection x plain and saving, in each of fused_rtb.cu and
    # fused_conv_gn.cu); the
    # backward's wgmma kernels: wgrad (general and T = 3), dgrad_gn_stage (N
    # tiles 64 and 128 x tap windows 5 and 3), dgrad_x_stage (64 x 5 and 3);
    # gn_mish_bwd (1, 2 or 4 channels a lane) and grad_reduce on the CUDA cores
    tc = {k: check_kernel_build(_build, sass, m, n, w) if cuda else "not measured"
          for k, m, n, w in (("conv_gn_mish_stage", "18conv_gn_mish_stage", 32, True),
                             ("wgrad", "5wgrad", 2, True), ("dgrad_gn_stage", "14dgrad_gn_stage", 4, True),
                             ("dgrad_x_stage", "13dgrad_x_stage", 2, True),
                             ("gn_mish_bwd", "11gn_mish_bwd", 3, False),
                             ("grad_reduce", "11grad_reduce", 1, False))}
    if cuda:  # the attention kernel (one instance, 128-row tiles): wgmma and no mma.sync, no spill
        tc["linear_attention"] = check_kernel_build(_build, sass, "16linear_attentionE", 1)
        # the resampling kernel (N tile 64 or 128 x up or down): the same
        tc["resample"] = check_kernel_build(_build, sass, "8resampleILi", 4)
    if cuda:  # per stage instance: its template arguments and the cluster sizes of its launches
        tc["conv_gn_mish_stage"]["instances"] = stage_instances(
            _build, tc["conv_gn_mish_stage"], (fold_batch, ODD_BATCH, train_batch))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(_build.build()) if cuda else None,
          "ptxas": _build.ptxas_report().splitlines() if cuda else [],
          "sass_hgmma": sass, **tc})

    t0 = time.perf_counter()
    checks = check_kernels(torch, dev, fold_batch, cuda, ODD_BATCH if cuda else None,
                           train_batch if cuda else None)
    # each stage launch's plan at the three batches: items, whole, split, parts
    emit({"stage_split": checks.pop("stage_split")})
    slice5 = check_slice5_kernels(torch, dev, cuda)
    attn = check_attention(torch, dev, fold_batch, cuda)
    res = check_resample(torch, dev, fold_batch, cuda, tc.get("resample") if cuda else None)
    sync()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], "tolerance": TOL, **checks, **slice5,
          "prenorm_linear_attention": attn, "resample": res})

    t0 = time.perf_counter()
    model = TemporalUnet1D(24, 8, dim=64, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    den = check_denoiser(torch, dev, fold_batch, model, cuda)
    den["fold_ms_per_sample"] = time_folds(torch, dev, model, cuda)
    # one flagship forward op by op: device ms and launches by module and aten op
    if cuda:
        fo = forward_profile.forward_ops(torch, dev, model, fold_batch)
        den["forward_groups"] = check_forward_groups(fo)
        emit({"forward_ops": fo, "power_limit_line": info["smi"]})
    sync()
    emit({"phase": "denoiser", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], "tolerance": DENOISER_TOL, **den})

    t0 = time.perf_counter()
    des = run_design(torch, dev, model, timesteps, design_args, cuda)
    sync()
    emit({"phase": "design", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **des})

    t0 = time.perf_counter()
    blocks = check_block_grads(torch, dev, train_batch, cuda)
    grad = check_grad(torch, dev, train_batch, model.train(), cuda)
    # one backward pass of the 16 blocks and the head: each backward kernel's
    # device ms beside its bound, wgrad's library yardstick, the partials
    bprof = backward_profile.profile(torch, dev, train_batch) if cuda else "not measured (CPU)"
    if cuda and train_batch == GN_CTAS_BATCH:
        check_gn_ctas(bprof)
        check_reduce_ctas(bprof)
    # grad_reduce alone at the pass's 17 job lists: bit for bit the in-order sum
    reduce_alone = check_grad_reduce(torch, dev, train_batch, cuda)
    sync()
    emit({"phase": "grad", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], "block_tolerance": TOL, **grad,
          "blocks_fwd_bwd_kernel_ms": sum(r["kernel_ms"] or 0.0 for r in blocks["fused_rtb_differentiable"]),
          "blocks_fwd_bwd_plain_ms": sum(r["plain_ms"] or 0.0 for r in blocks["fused_rtb_differentiable"]),
          "blocks_fwd_bwd_device_ms": (
              sum(r["device_ms"] for r in blocks["fused_rtb_differentiable"])
              if all(r["device_ms"] is not None for r in blocks["fused_rtb_differentiable"])
              else "not measured"),
          "blocks_fwd_bwd_host_ms": sum(r["host_ms"] or 0.0 for r in blocks["fused_rtb_differentiable"]),
          "blocks_backward_kernel_ms": sum(r["backward_ms"] or 0.0 for r in blocks["fused_rtb_differentiable"]),
          "blocks_backward_plain_ms": sum(r["backward_plain_ms"] or 0.0
                                          for r in blocks["fused_rtb_differentiable"]),
          "backward_kernels": bprof, "grad_reduce_alone": reduce_alone, **blocks})

    t0 = time.perf_counter()
    train = run_train(torch, dev, train_args, train_steps, cuda)
    sync()
    emit({"phase": "train", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **train})

    t0 = time.perf_counter()
    ana = run_analysis(torch, dev, model.eval(), cuda, **analysis_kw)
    sync()
    emit({"phase": "analysis", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **ana})

    t0 = time.perf_counter()
    base = run_baselines(torch, dev, cuda, **baselines_kw)
    sync()
    emit({"phase": "baselines", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **base})

    # path C (TF32 is off since the device phase: cuDNN would default to it;
    # the design_2d CLI turns it off itself, which run_design2d checks)
    t0 = time.perf_counter()
    u2d, models2d = run_unet2d(torch, dev, cuda, **(unet2d_kw or {}))
    sync()
    emit({"phase": "unet2d", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **u2d})

    t0 = time.perf_counter()
    d2d = run_design2d(torch, dev, cuda, models2d, **(design2d_kw or {}))
    sync()
    emit({"phase": "design2d", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **d2d})
    del models2d

    t0 = time.perf_counter()
    bd = run_bdim(torch, dev, cuda, **(bdim_kw or {}))
    sync()
    emit({"phase": "bdim", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **bd})

    path2d = run_train2d_path(torch, dev, cuda, info, **(train2d_path_kw or {}))

    t0 = time.perf_counter()
    multi = run_multigpu(torch, dev, cuda, model, **(multigpu_kw or {}))
    sync()
    emit({"phase": "multigpu", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **multi})

    first, second = train["runs"]
    line = kernels_line(checks, des["launches"], slice5)
    for entry in line["kernels"]:
        entry["launches_train"] = first["launches"][entry["name"]] + second["launches"][entry["name"]]
        entry["launches_analysis"] = ana["launches"][entry["name"]]
        entry["launches_baselines"] = base["launches"][entry["name"]]
    train_counts = {k: first["launches"][k] + second["launches"][k] for k in first["launches"]}
    line["kernels"].extend(vjp_entries(blocks, train_counts, ana["launches"], base["launches"], slice5,
                                       bprof))
    # path C runs none of the kernels: the counters read over its two runs
    d2 = d2d["launches"]
    keys = {"fused_rtb": ("fused_rtb", None),
            "fused_conv1d_gn_mish": ("fused_conv1d_gn_mish", None),
            "fused_rtb_differentiable": ("FusedRTB_launches", "fused_rtb_backward"),
            "fused_conv1d_gn_mish_differentiable": ("FusedConv1dGNMish_launches",
                                                    "fused_conv1d_gn_mish_backward")}
    for entry in line["kernels"]:
        fwd, bwd = keys[entry["name"]]
        entry["launches_design2d"] = d2[fwd]
        if bwd:
            entry["backward_launches_design2d"] = d2[bwd]
        # nor any of the 2D training path and 2D baselines (each phase raises otherwise)
        for phase, counts in path2d.items():
            entry[f"launches_{phase}"] = counts[fwd]
            if bwd:
                entry[f"backward_launches_{phase}"] = counts[bwd]
        # phase 19: (a)'s train_1d and design_1d runs under the one-rank NCCL
        # group; (b)'s train step and 1D sampler in each of the two gloo ranks
        entry["launches_multigpu"] = multi["launches"][fwd]
        per_rank = [{k: c["train_step"][k] + c["sampler_1d"][k] for k in c["train_step"]}
                    for c in multi["b"]["launches_per_rank"]]
        entry["launches_multigpu_ranks"] = [c[fwd] for c in per_rank]
        if bwd:
            entry["backward_launches_multigpu"] = multi["launches"][bwd]
            entry["backward_launches_multigpu_ranks"] = [c[bwd] for c in per_rank]
    line["kernels"].append(attention_entry(attn, des, train, grad, ana, base, d2d, path2d, multi))
    line["kernels"].extend(resample_entries(res, des, train, grad, ana, base, d2d, path2d, multi))
    line["kernels"].append(reduce_entry(reduce_alone, train, bprof))
    line["kernels"].append(stage_weights_entry(checks, des, train, ana, base, d2d, path2d, multi))
    info["kernels"] = line
    return info


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "cindm_tpu_torch")):
        print(f"chip_smoke: no cindm_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    info = run("cuda", FOLD_BATCH, 20, DESIGN_ARGS)
    emit(info["kernels"])
    print(info["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
