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
             the backward's weight-gradient kernel ``wgrad`` and its two
             dgrads (``dgrad_gn_stage``, ``dgrad_x_stage``, every instance)
             must issue wgmma, no mma.sync, and spill nothing; its
             GroupNorm + Mish backward ``gn_mish_bwd`` (its three instances:
             1, 2 or 4 channels a lane's load) must spill nothing.
3. kernels:  each kernel against its plain PyTorch version at the 17 block
             shapes of the flagship denoiser, folded batch 5,376 (fp32,
             max abs and max relative error <= 1e-4), then timed with CUDA
             events beside two bounds on an H100: fp32 on the CUDA cores
             (``bound_ms``) and the kernels' own 3xTF32 on the tensor cores
             (``bound_tc_ms``: 3 x FLOP at 495 TFLOP/s). Then the shapes of
             the later paths: the Conv1d+GN+Mish kernel at every distinct
             block of the forward model at horizon 24 and 2 (T down to 1,
             C up to 1,024) at batch 1,000, its Function fwd+bwd against
             plain autograd at batch 32 and x-only at batch 4 (every
             gradient within 1e-4 of the plain one's largest entry), and
             the fused-RTB kernel at the 1-body prior's C=4 block and the
             horizon-70 direct model's T=70 and T=35 blocks.
4. denoiser: the full-width TemporalUnet1D (dim 64, horizon 24) with seeded
             random weights, kernel path against plain path at batch 5,376;
             its ms per sample at folded batches 1,344 to 10,752 (the
             measurement behind ``sampling/compose.FOLD_TARGET``).
5. design:   ``cindm_tpu_torch.cli.design_1d`` at the flagship geometry
             (B=64, 8 bodies, n_composed=2, standard-recurrence-10) on a
             20-step schedule, from those weights written as a snapshot.
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
             counts, and one whole optimizer step timed on each path; then
             one backward pass of the 16 blocks and the head at batch 512
             through ``cindm_tpu_torch.tools.backward_profile``: each of the
             six backward kernels' device ms from torch.profiler beside its
             bound, wgrad's fp32 bound and library yardstick
             (``torch.nn.grad.conv1d_weight``, cuDNN fp32), the dgrads'
             (``torch.nn.grad.conv1d_input``, the convolution only) and
             their launches one by one (shape, grid, cluster size, ms),
             ``gn_mish_bwd``'s launches one by one (each must run at least
             132 CTAs at batch 512) beside aten's GroupNorm backward as its
             yardstick, and the plan's bytes of weight-gradient partials.
7. train:    ``cindm_tpu_torch.cli.train_1d`` at the configuration that
             trained the in-tree prior (batch 512, dim 64, 6,000 simulations
             generated on the card, 30% collision windows), cut only in its
             step count: 40 steps with milestones at 20 and 40, then a resume
             to step 50 with one 25-step DDIM eval.
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
             forwards per second.
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
             and 160 + 10 launches a design step. (b) two ranks of
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
             ``launches_multigpu_ranks`` (phase 19 (b), per rank)), the
             nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

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


def rtb_row(torch, g, dev, C: int, O: int, T: int, batch: int, cuda: bool) -> dict:
    """One fused-RTB shape: kernel against plain, timed beside its bounds."""
    from cindm_tpu_torch.ops import fused_rtb, fused_rtb_reference

    x = torch.randn((batch, T, C), generator=g, device=dev)
    temb = torch.randn((batch, O), generator=g, device=dev)
    p = rand_block_params(torch, g, C, O, dev, proj=C != O)
    abs_err, rel_err = errors(torch, fused_rtb(x, temb, **p), fused_rtb_reference(x, temb, **p))
    plain_ms, kernel_ms = time_pair(
        torch, lambda: fused_rtb_reference(x, temb, **p), lambda: fused_rtb(x, temb, **p),
    ) if cuda else (None, None)
    taps = valid_taps(T, K)
    macs = batch * (taps * C * O + taps * O * O + (T * C * O if C != O else 0))
    n_par = sum(weight_numel(v, T) if k in ("w1", "w2") else v.numel() for k, v in p.items())
    nbytes = 4 * (x.numel() + temb.numel() + n_par + batch * T * O)
    return dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                kernel_ms=kernel_ms, plain_ms=plain_ms, **bounds(2 * macs, nbytes))


def conv_row(torch, g, dev, C: int, O: int, T: int, batch: int, cuda: bool) -> dict:
    """One Conv1d+GN+Mish shape: kernel against plain, timed beside its bounds."""
    from cindm_tpu_torch.ops import fused_conv1d_gn_mish, fused_conv1d_gn_mish_reference

    x = torch.randn((batch, T, C), generator=g, device=dev)
    p = rand_block_params(torch, g, C, O, dev, proj=False)
    args = (x, p["w1"], p["b1"], p["gs1"], p["gb1"])
    abs_err, rel_err = errors(torch, fused_conv1d_gn_mish(*args),
                              fused_conv1d_gn_mish_reference(*args))
    plain_ms, kernel_ms = time_pair(
        torch, lambda: fused_conv1d_gn_mish_reference(*args), lambda: fused_conv1d_gn_mish(*args),
    ) if cuda else (None, None)
    nbytes = 4 * (x.numel() + weight_numel(args[1], T) + sum(a.numel() for a in args[2:])
                  + batch * T * O)
    return dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                **bounds(2 * batch * valid_taps(T, K) * C * O, nbytes))


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


def check_kernels(torch, dev, batch: int, cuda: bool) -> dict:
    """Phase 3: every flagship block shape, kernel against plain, timed on CUDA."""
    g = torch.Generator(device=dev).manual_seed(1234)
    rtb_rows = [rtb_row(torch, g, dev, C, O, T, batch, cuda) for C, O, T in RTB_SHAPES]
    head_rows = [conv_row(torch, g, dev, *HEAD_SHAPE, batch, cuda)]
    bad = [r for r in rtb_rows + head_rows if not (r["max_abs_err"] <= TOL and r["max_rel_err"] <= TOL)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version beyond {TOL}: {bad}")
    return {"fused_rtb": rtb_rows, "fused_conv1d_gn_mish": head_rows}


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
    from cindm_tpu_torch.ops import (FusedConv1dGNMish, FusedRTB, fused_conv1d_gn_mish,
                                     fused_conv1d_gn_mish_backward, fused_rtb, fused_rtb_backward)

    fused_rtb.launches = 0
    fused_conv1d_gn_mish.launches = 0
    fused_rtb_backward.launches = 0
    fused_conv1d_gn_mish_backward.launches = 0
    FusedRTB.launches = 0
    FusedRTB.backwards = 0
    FusedConv1dGNMish.launches = 0
    FusedConv1dGNMish.backwards = 0


def read_counts(backwards: bool = False) -> dict:
    from cindm_tpu_torch.ops import (FusedConv1dGNMish, FusedRTB, fused_conv1d_gn_mish,
                                     fused_conv1d_gn_mish_backward, fused_rtb, fused_rtb_backward)

    counts = {"fused_rtb": fused_rtb.launches, "fused_conv1d_gn_mish": fused_conv1d_gn_mish.launches}
    if backwards:
        counts.update(FusedRTB_launches=FusedRTB.launches,
                      FusedRTB_backward_passes=FusedRTB.backwards,
                      FusedConv1dGNMish_launches=FusedConv1dGNMish.launches,
                      FusedConv1dGNMish_backward_passes=FusedConv1dGNMish.backwards,
                      fused_rtb_backward=fused_rtb_backward.launches,
                      fused_conv1d_gn_mish_backward=fused_conv1d_gn_mish_backward.launches)
    return counts


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
        if cuda and counts != {"fused_rtb": 16, "fused_conv1d_gn_mish": 1}:
            raise AssertionError(f"one forward should launch 16 + 1 kernels, counted {counts}")
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
                          "strategy_seconds": timings, "launches": read_counts(backwards=True)}
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
                                 for r in runs.values())
    # the samplers take no gradient through the priors: no autograd Function
    # forward and no backward kernel runs in this phase
    checks["no_gradient"] = all(v == 0 for k, v in launches.items()
                                if k not in ("fused_rtb", "fused_conv1d_gn_mish"))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"analysis phase checks failed: {failed}; runs {runs}")
    return {"runs": runs, "launches": launches, "checks": checks, "cuts": cuts,
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
    checks = {
        "losses_finite": all(r["losses_finite"] for r in train.values()),
        "forward_model_loss_falls": train["forward_model"]["loss_last3_mean"]
        < train["forward_model"]["loss_first3_mean"],
        "designs_finite": len(design) == 8
        and all(math.isfinite(r["record"]["design_obj_simu"]) for r in design.values()),
    }
    if cuda:
        checks["launches"] = (counts["fused_conv1d_gn_mish"] > 0 and counts["FusedConv1dGNMish_launches"] > 0
                              and counts["fused_conv1d_gn_mish_backward"] > 0)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"baselines phase checks failed: {failed}; train {train}; design {design}")
    cuts = {"train_num_steps": steps, "train_num_steps_script": "100,000-200,000",
            "max_design_steps": n_design, "max_design_steps_script": 1000}
    return {"train": train, "design": design, "launches": counts, "checks": checks,
            "cuts": cuts, "seconds": time.perf_counter() - t_phase}


def run_design(torch, dev, model, timesteps: int, design_args: list[str], cuda: bool) -> dict:
    """Phase 5: the design CLI on the seeded weights written as a snapshot."""
    import numpy as np

    from cindm_tpu_torch.cli.design_1d import main as design_main
    from cindm_tpu_torch.models import flax_from_params

    scratch = os.path.join(REPO, ".cuda_build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="smoke-") as tmp:
        flat = {"['ema_params']['params']" + k: v for k, v in flax_from_params(model).items()}
        flat["['step']"] = np.asarray(0)
        np.savez(os.path.join(tmp, "persisted_m0.npz"), **flat)
        argv = ["--model_path", tmp, "--timesteps", str(timesteps), "--device", str(dev),
                *design_args]
        reset_counts()
        t0 = time.perf_counter()
        record = design_main(argv)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    vals = [record[k] for k in ("design_obj", "design_obj_ci95", "MAE", "RMSE")]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"design record is not finite: {record}")
    per_step = {k: v / timesteps for k, v in counts.items()}
    if cuda and per_step != {"fused_rtb": 16.0 * RECURRENCE, "fused_conv1d_gn_mish": 1.0 * RECURRENCE}:
        raise AssertionError(f"expected 160 and 10 launches per reverse step, got {per_step}")
    batch = int(design_args[design_args.index("--batch_size") + 1])
    fwds = timesteps * RECURRENCE * N_WINDOWS * N_PAIRS * batch
    return {"record": record, "reverse_steps": timesteps, "seconds": seconds,
            "launches": counts, "launches_per_step": per_step,
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
            "fused_rtb_backward": 16, "fused_conv1d_gn_mish_backward": 1}
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


def run_train(torch, dev, train_args: list[str], steps: tuple[int, int, int, int], cuda: bool) -> dict:
    """Phase 7: the train_1d CLI, then a resume with one eval."""
    import numpy as np

    from cindm_tpu_torch.cli.train_1d import main as train_main
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
            runs.append({"seconds": seconds, "launches": read_counts(backwards=True),
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
                                  "fused_conv1d_gn_mish_backward": n_steps}
            and second["launches"] == {"fused_rtb": 16 * (n2 + eval_steps),
                                       "fused_conv1d_gn_mish": n2 + eval_steps,
                                       "FusedRTB_launches": 16 * n2,
                                       "FusedRTB_backward_passes": 16 * n2,
                                       "FusedConv1dGNMish_launches": n2,
                                       "FusedConv1dGNMish_backward_passes": n2,
                                       "fused_rtb_backward": 16 * n2,
                                       "fused_conv1d_gn_mish_backward": n2})
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
    counts = read_counts(backwards=True)
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
    """The 1D kernels' counters since the last reset; raises unless all 0
    (the 2D paths run plain PyTorch)."""
    counts = read_counts(backwards=True)
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
                          "record": record1, "launches": train_counts}
        checks["a_train_equal"] = (len(lo) == len(lp) == steps and loss_err <= MULTIGPU_EXACT_TOL
                                   and param_err <= MULTIGPU_EXACT_TOL)
        checks["a_group_destroyed"] = not dist.is_initialized()
        write_snapshot(model, os.path.join(tmp, "snap"))
        reset_counts()
        record, _ = quiet(design_main, ["--model_path", os.path.join(tmp, "snap"), "--timesteps",
                                        str(steps), "--device", str(dev), *design_args,
                                        "--n_devices", "1"])
        design_counts = read_counts(backwards=True)
        rec["a_design"] = {"record": record, "launches": design_counts}
        checks["a_design_record"] = (set(record) == DESIGN1D_RECORD_KEYS and all(
            math.isfinite(record[k]) for k in ("design_obj", "design_obj_ci95", "MAE", "RMSE")))
        if cuda:
            n = steps
            checks["a_launches"] = (
                train_counts == {"fused_rtb": 16 * n, "fused_conv1d_gn_mish": n,
                                 "FusedRTB_launches": 16 * n, "FusedRTB_backward_passes": 16 * n,
                                 "FusedConv1dGNMish_launches": n,
                                 "FusedConv1dGNMish_backward_passes": n,
                                 "fused_rtb_backward": 16 * n, "fused_conv1d_gn_mish_backward": n}
                and design_counts["fused_rtb"] == 16 * RECURRENCE * n
                and design_counts["fused_conv1d_gn_mish"] == RECURRENCE * n)
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
    wgmma (HGMMA) and no mma.sync (HMMA). ptxas's notes on them (a
    serialized wgmma pipeline, C7512) are kept beside."""
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
             if name in l and "Performance" in l]
    return {"ptxas": res, "sass": counts, "notes": notes}


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
    from cindm_tpu_torch.tools import backward_profile
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
    # the backward's wgmma kernels: wgrad (general and T = 3), dgrad_gn_stage (N
    # tiles 64 and 128 x tap windows 5 and 3), dgrad_x_stage (64 x 5 and 3);
    # gn_mish_bwd (1, 2 or 4 channels a lane) on the CUDA cores
    tc = {k: check_kernel_build(_build, sass, m, n, w) if cuda else "not measured"
          for k, m, n, w in (("wgrad", "5wgrad", 2, True), ("dgrad_gn_stage", "14dgrad_gn_stage", 4, True),
                             ("dgrad_x_stage", "13dgrad_x_stage", 2, True),
                             ("gn_mish_bwd", "11gn_mish_bwd", 3, False))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(_build.build()) if cuda else None,
          "ptxas": _build.ptxas_report().splitlines() if cuda else [],
          "sass_hgmma": sass, **tc})

    t0 = time.perf_counter()
    checks = check_kernels(torch, dev, fold_batch, cuda)
    slice5 = check_slice5_kernels(torch, dev, cuda)
    sync()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], "tolerance": TOL, **checks, **slice5})

    t0 = time.perf_counter()
    model = TemporalUnet1D(24, 8, dim=64, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    den = check_denoiser(torch, dev, fold_batch, model, cuda)
    den["fold_ms_per_sample"] = time_folds(torch, dev, model, cuda)
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
          "backward_kernels": bprof, **blocks})

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
