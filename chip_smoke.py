#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cindm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through the hand-written CUDA kernels: composed
8-body guided inverse design, and training of the 2-body prior that design
composes. Eight phases; each prints one JSON line with its elapsed seconds
after a ``torch.cuda.synchronize()``:

1. device:   the card's name and nvidia-smi's name and power limit; TF32 off.
2. build:    nvcc builds ``cindm_tpu_torch/ops/csrc`` into ``.cuda_build/``;
             ptxas's register/spill lines and the tensor-core (HGMMA)
             instructions cuobjdump finds in each kernel.
3. kernels:  each kernel against its plain PyTorch version at the 17 block
             shapes of the flagship denoiser, folded batch 5,376 (fp32,
             max abs and max relative error <= 1e-4), then timed with CUDA
             events beside two bounds on an H100: fp32 on the CUDA cores
             (``bound_ms``) and the kernels' own 3xTF32 on the tensor cores
             (``bound_tc_ms``: 3 x FLOP at 495 TFLOP/s).
4. denoiser: the full-width TemporalUnet1D (dim 64, horizon 24) with seeded
             random weights, kernel path against plain path at batch 5,376.
5. design:   ``cindm_tpu_torch.cli.design_1d`` at the flagship geometry
             (B=64, 8 bodies, n_composed=2, standard-recurrence-10) on a
             20-step schedule, from those weights written as a snapshot.
6. grad:     the 16 blocks' autograd Function (``FusedRTB``: kernel forward,
             recompute backward) and the head's against plain autograd at
             batch 512, timed; then one ``p_losses`` gradient of the
             full-width denoiser at batch 512, kernel path against plain path
             (every parameter's max |dg| / max |g_plain| <= 1e-3), its launch
             counts, and one whole optimizer step timed on each path.
7. train:    ``cindm_tpu_torch.cli.train_1d`` at the configuration that
             trained the in-tree prior (batch 512, dim 64, 6,000 simulations
             generated on the card, 30% collision windows), cut only in its
             step count: 40 steps with milestones at 20 and 40, then a resume
             to step 50 with one 25-step DDIM eval.
8. summary:  the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
             ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no ``ok`` line.
It exits non-zero at once when CUDA is unavailable or when it runs outside a
checkout of the repository. Weights and inputs are drawn from seeded
``torch.Generator``s; nothing is read from or written to ``results/`` or
``dataset/`` (the training run writes under ``.cuda_build/``).
"""

from __future__ import annotations

import contextlib
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
# scripts_paper/round3c_train1d.sh, cut only in its step count
TRAIN_ARGS = [
    "--batch_size", "512", "--gradient_accumulate_every", "1", "--Unet_dim", "64",
    "--rollout_steps", "24", "--conditioned_steps", "0", "--collision_frac", "0.3",
    "--n_sims", "6000", "--test_sims", "100", "--timesteps", "1000",
]
TRAIN_STEPS, TRAIN_SAVE_EVERY, RESUME_STEPS, EVAL_SAMPLE_STEPS = 40, 20, 50, 25

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


def time_pair(torch, plain, kernel, reps: int = 10) -> tuple[float, float]:
    """Mean ms per call of plain and kernel, timed in turns plain, kernel,
    kernel, plain with CUDA events after a warm-up."""
    def one(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for fn in (plain, kernel):
        fn()
        fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = one(plain), one(kernel), one(kernel), one(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


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


def check_kernels(torch, dev, batch: int, cuda: bool) -> dict:
    """Phase 3: every flagship block shape, kernel against plain, timed on CUDA."""
    from cindm_tpu_torch.ops import (
        fused_conv1d_gn_mish,
        fused_conv1d_gn_mish_reference,
        fused_rtb,
        fused_rtb_reference,
    )

    g = torch.Generator(device=dev).manual_seed(1234)
    rtb_rows, head_rows = [], []
    for C, O, T in RTB_SHAPES:
        x = torch.randn((batch, T, C), generator=g, device=dev)
        temb = torch.randn((batch, O), generator=g, device=dev)
        p = rand_block_params(torch, g, C, O, dev, proj=C != O)
        got = fused_rtb(x, temb, **p)
        want = fused_rtb_reference(x, temb, **p)
        abs_err, rel_err = errors(torch, got, want)
        plain_ms, kernel_ms = time_pair(
            torch, lambda: fused_rtb_reference(x, temb, **p),
            lambda: fused_rtb(x, temb, **p),
        ) if cuda else (None, None)
        taps = valid_taps(T, K)
        macs = batch * (taps * C * O + taps * O * O + (T * C * O if C != O else 0))
        nbytes = 4 * (x.numel() + temb.numel() + sum(v.numel() for v in p.values()) + batch * T * O)
        rtb_rows.append(dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                             kernel_ms=kernel_ms, plain_ms=plain_ms, **bounds(2 * macs, nbytes)))
        del x, temb, p, got, want
    C, O, T = HEAD_SHAPE
    x = torch.randn((batch, T, C), generator=g, device=dev)
    p = rand_block_params(torch, g, C, O, dev, proj=False)
    args = (x, p["w1"], p["b1"], p["gs1"], p["gb1"])
    got = fused_conv1d_gn_mish(*args)
    want = fused_conv1d_gn_mish_reference(*args)
    abs_err, rel_err = errors(torch, got, want)
    plain_ms, kernel_ms = time_pair(
        torch, lambda: fused_conv1d_gn_mish_reference(*args),
        lambda: fused_conv1d_gn_mish(*args),
    ) if cuda else (None, None)
    nbytes = 4 * (x.numel() + sum(a.numel() for a in args[1:]) + batch * T * O)
    head_rows.append(dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                          kernel_ms=kernel_ms, plain_ms=plain_ms,
                          **bounds(2 * batch * valid_taps(T, K) * C * O, nbytes)))
    bad = [r for r in rtb_rows + head_rows if not (r["max_abs_err"] <= TOL and r["max_rel_err"] <= TOL)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version beyond {TOL}: {bad}")
    return {"fused_rtb": rtb_rows, "fused_conv1d_gn_mish": head_rows}


def reset_counts():
    from cindm_tpu_torch.ops import FusedConv1dGNMish, FusedRTB, fused_conv1d_gn_mish, fused_rtb

    fused_rtb.launches = 0
    fused_conv1d_gn_mish.launches = 0
    FusedRTB.launches = 0
    FusedRTB.backwards = 0
    FusedConv1dGNMish.backwards = 0


def read_counts(backwards: bool = False) -> dict:
    from cindm_tpu_torch.ops import FusedConv1dGNMish, FusedRTB, fused_conv1d_gn_mish, fused_rtb

    counts = {"fused_rtb": fused_rtb.launches, "fused_conv1d_gn_mish": fused_conv1d_gn_mish.launches}
    if backwards:
        counts.update(FusedRTB_launches=FusedRTB.launches,
                      FusedRTB_backward_passes=FusedRTB.backwards,
                      FusedConv1dGNMish_backward_passes=FusedConv1dGNMish.backwards)
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
    """Phase 6a: the blocks' autograd Functions against plain autograd."""
    from cindm_tpu_torch.ops import (
        fused_conv1d_gn_mish_differentiable,
        fused_conv1d_gn_mish_reference,
        fused_rtb_differentiable,
        fused_rtb_reference,
    )

    g = torch.Generator(device=dev).manual_seed(4321)

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
        plain_ms, kernel_ms = time_pair(
            torch, lambda: fwd_bwd(plain, a, cot), lambda: fwd_bwd(kernel, a, cot)
        ) if cuda else (None, None)
        # forward + backward: each input and the cotangent read once, the
        # output and each input's gradient written once; 3x the forward's FLOP
        n_in = sum(v.numel() for v in a.values())
        bound_ms, bound_by = bound(3 * 2 * macs, 4 * (2 * n_in + 2 * cot.numel()))
        return dict(max_abs_err=abs_err, max_rel_err=rel_err, kernel_ms=kernel_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    rtb_rows = []
    for C, O, T in RTB_SHAPES:
        a = dict(x=torch.randn((batch, T, C), generator=g, device=dev),
                 temb=torch.randn((batch, O), generator=g, device=dev),
                 **rand_block_params(torch, g, C, O, dev, proj=C != O))
        cot = torch.randn((batch, T, O), generator=g, device=dev)
        taps = valid_taps(T, K)
        macs = batch * (taps * C * O + taps * O * O + (T * C * O if C != O else 0))
        rtb_rows.append(dict(C=C, O=O, T=T, B=batch, **one(
            fused_rtb_differentiable, fused_rtb_reference, a, cot, macs)))
    C, O, T = HEAD_SHAPE
    p = rand_block_params(torch, g, C, O, dev, proj=False)
    a = dict(x=torch.randn((batch, T, C), generator=g, device=dev), w=p["w1"], b=p["b1"],
             gn_scale=p["gs1"], gn_bias=p["gb1"])
    cot = torch.randn((batch, T, O), generator=g, device=dev)
    head = [dict(C=C, O=O, T=T, B=batch, **one(
        fused_conv1d_gn_mish_differentiable, fused_conv1d_gn_mish_reference, a, cot,
        batch * valid_taps(T, K) * C * O))]
    bad = [r for r in rtb_rows + head if not r["max_rel_err"] <= TOL]
    if bad:
        raise AssertionError(f"Function gradients disagree with plain autograd beyond {TOL}: {bad}")
    return {"fused_rtb_differentiable": rtb_rows, "fused_conv1d_gn_mish_differentiable": head}


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
            "FusedRTB_backward_passes": 16, "FusedConv1dGNMish_backward_passes": 1}
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
                                  "FusedConv1dGNMish_backward_passes": n_steps}
            and second["launches"] == {"fused_rtb": 16 * (n2 + eval_steps),
                                       "fused_conv1d_gn_mish": n2 + eval_steps,
                                       "FusedRTB_launches": 16 * n2,
                                       "FusedRTB_backward_passes": 16 * n2,
                                       "FusedConv1dGNMish_backward_passes": n2})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train phase checks failed: {failed}; runs {runs}; "
                             f"milestones {milestones}; evals {evals}; losses {losses.tolist()}")
    return {"runs": runs, "milestones": milestones, "eval": evals[0],
            "loss_first5_mean": float(losses[:5].mean()), "loss_last5_mean": float(losses[-5:].mean()),
            "train_samples_per_s": first["record"]["samples_per_s"],
            "data_generation_seconds": first["record"]["data_seconds"], "checks": checks}


def kernels_line(checks: dict, counts: dict) -> dict:
    meta = {
        "fused_rtb": ("cindm_tpu_torch/ops/csrc/fused_rtb.cu", "cindm_tpu/ops/fused_rtb.py:179"),
        "fused_conv1d_gn_mish": ("cindm_tpu_torch/ops/csrc/fused_conv_gn.cu",
                                 "cindm_tpu/ops/fused_conv_gn.py:112"),
    }
    out = []
    for name, rows in checks.items():
        source, replaces = meta[name]
        by = {r["bound_tc_by"] for r in rows}
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
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
        })
    return {"kernels": out}


def vjp_entry(rows: list[dict], launches: int, backward_passes: int) -> dict:
    """The fused-RTB VJP's entry: kernel forward plus recompute backward over
    the 16 block shapes at the training batch. Only the forward is a
    hand-written kernel: ``launches`` counts its launches through ``FusedRTB``
    in the training phase; the backward is plain PyTorch (autograd through
    ``fused_rtb_reference``), counted apart as ``backward_passes``."""
    by = {r["bound_by"] for r in rows}
    return {
        "name": "fused_rtb_differentiable", "route": "cuda",
        "route_detail": "cuda forward + torch backward",
        "source": "cindm_tpu_torch/ops/fused_rtb.py",
        "forward_source": "cindm_tpu_torch/ops/csrc/fused_rtb.cu",
        "backward": "recompute of fused_rtb_reference under torch.autograd (no hand-written kernel)",
        "replaces": "cindm_tpu/ops/fused_rtb.py:267",
        "launches": launches,
        "backward_passes": backward_passes,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows),
        "ms": sum(r["kernel_ms"] or 0.0 for r in rows),
        "plain_ms": sum(r["plain_ms"] or 0.0 for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": by.pop() if len(by) == 1 else "operations",
        "library_ms": None,
        "shapes": rows,
    }


def run(device: str, fold_batch: int, timesteps: int, design_args: list[str],
        train_batch: int = TRAIN_BATCH, train_args: list[str] = TRAIN_ARGS,
        train_steps: tuple[int, int, int, int] = (TRAIN_STEPS, TRAIN_SAVE_EVERY, RESUME_STEPS,
                                                  EVAL_SAMPLE_STEPS)) -> dict:
    import torch

    from cindm_tpu_torch.models import TemporalUnet1D
    from cindm_tpu_torch.ops import _build

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    info = {}

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info["smi"] = nvidia_smi_line() if cuda else "not measured"
    info["name"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    sync()
    emit({"phase": "device", "seconds": time.perf_counter() - t0, "name": info["name"],
          "nvidia_smi": info["smi"], "count": torch.cuda.device_count() if cuda else 0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": False, "cudnn": False}})

    t0 = time.perf_counter()
    if cuda:
        _build.load()
    # "ptxas": the stage kernel's registers, spills and ptxas's notes (-Xptxas -v);
    # "sass_hgmma": its tensor-core (wgmma) instructions per kernel, from cuobjdump
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(_build.build()) if cuda else None,
          "ptxas": _build.ptxas_report().splitlines() if cuda else [],
          "sass_hgmma": _build.sass_mma_counts() if cuda else "not measured"})

    t0 = time.perf_counter()
    checks = check_kernels(torch, dev, fold_batch, cuda)
    sync()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "device": info["name"],
          "tolerance": TOL, **checks})

    t0 = time.perf_counter()
    model = TemporalUnet1D(24, 8, dim=64, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    den = check_denoiser(torch, dev, fold_batch, model, cuda)
    sync()
    emit({"phase": "denoiser", "seconds": time.perf_counter() - t0, "device": info["name"],
          "tolerance": DENOISER_TOL, **den})

    t0 = time.perf_counter()
    des = run_design(torch, dev, model, timesteps, design_args, cuda)
    sync()
    emit({"phase": "design", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **des})

    t0 = time.perf_counter()
    blocks = check_block_grads(torch, dev, train_batch, cuda)
    grad = check_grad(torch, dev, train_batch, model.train(), cuda)
    sync()
    emit({"phase": "grad", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], "block_tolerance": TOL, **grad,
          "blocks_fwd_bwd_kernel_ms": sum(r["kernel_ms"] or 0.0 for r in blocks["fused_rtb_differentiable"]),
          "blocks_fwd_bwd_plain_ms": sum(r["plain_ms"] or 0.0 for r in blocks["fused_rtb_differentiable"]),
          **blocks})

    t0 = time.perf_counter()
    train = run_train(torch, dev, train_args, train_steps, cuda)
    sync()
    emit({"phase": "train", "seconds": time.perf_counter() - t0, "device": info["name"],
          "power_limit_line": info["smi"], **train})
    first, second = train["runs"]
    line = kernels_line(checks, des["launches"])
    for entry in line["kernels"]:
        entry["launches_train"] = first["launches"][entry["name"]] + second["launches"][entry["name"]]
    line["kernels"].append(vjp_entry(
        blocks["fused_rtb_differentiable"],
        *(first["launches"][k] + second["launches"][k]
          for k in ("FusedRTB_launches", "FusedRTB_backward_passes"))))
    info["kernels"] = line
    return info


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "cindm_tpu_torch")):
        print(f"chip_smoke: no cindm_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    info = run("cuda", FOLD_BATCH, 20, DESIGN_ARGS)
    emit(info["kernels"])
    print(info["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
