#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cindm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, composed 8-body guided inverse design, through
the hand-written CUDA kernels, in six phases. Each phase prints one JSON line
with its elapsed seconds after a ``torch.cuda.synchronize()``:

1. device:   the card's name and nvidia-smi's name and power limit; TF32 off.
2. build:    nvcc builds ``cindm_tpu_torch/ops/csrc`` into ``.cuda_build/``.
3. kernels:  each kernel against its plain PyTorch version at the 17 block
             shapes of the flagship denoiser, folded batch 5,376 (fp32,
             max abs and max relative error <= 1e-4), then timed with CUDA
             events beside its bound on an H100.
4. denoiser: the full-width TemporalUnet1D (dim 64, horizon 24) with seeded
             random weights, kernel path against plain path at batch 5,376.
5. design:   ``cindm_tpu_torch.cli.design_1d`` at the flagship geometry
             (B=64, 8 bodies, n_composed=2, standard-recurrence-10) on a
             20-step schedule, from those weights written as a snapshot.
6. summary:  the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
             ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits non-zero and prints no ``ok`` line.
It exits non-zero at once when CUDA is unavailable or when it runs outside a
checkout of the repository. Weights and inputs are drawn from seeded
``torch.Generator``s; nothing is read from ``results/`` or ``dataset/``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
        bound_ms, bound_by = bound(2 * macs, nbytes)
        rtb_rows.append(dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                             kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
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
    bound_ms, bound_by = bound(2 * batch * valid_taps(T, K) * C * O, nbytes)
    head_rows.append(dict(C=C, O=O, T=T, B=batch, max_abs_err=abs_err, max_rel_err=rel_err,
                          kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by))
    bad = [r for r in rtb_rows + head_rows if not (r["max_abs_err"] <= TOL and r["max_rel_err"] <= TOL)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version beyond {TOL}: {bad}")
    return {"fused_rtb": rtb_rows, "fused_conv1d_gn_mish": head_rows}


def reset_counts():
    from cindm_tpu_torch.ops import fused_conv1d_gn_mish, fused_rtb

    fused_rtb.launches = 0
    fused_conv1d_gn_mish.launches = 0


def read_counts() -> dict:
    from cindm_tpu_torch.ops import fused_conv1d_gn_mish, fused_rtb

    return {"fused_rtb": fused_rtb.launches, "fused_conv1d_gn_mish": fused_conv1d_gn_mish.launches}


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


def kernels_line(checks: dict, counts: dict) -> dict:
    meta = {
        "fused_rtb": ("cindm_tpu_torch/ops/csrc/fused_rtb.cu", "cindm_tpu/ops/fused_rtb.py:179"),
        "fused_conv1d_gn_mish": ("cindm_tpu_torch/ops/csrc/fused_conv_gn.cu",
                                 "cindm_tpu/ops/fused_conv_gn.py:112"),
    }
    out = []
    for name, rows in checks.items():
        source, replaces = meta[name]
        bound_ms = sum(r["bound_ms"] for r in rows)
        by = {r["bound_by"] for r in rows}
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            # one denoiser forward's worth: the sum over this kernel's shapes
            "ms": sum(r["kernel_ms"] or 0.0 for r in rows),
            "plain_ms": sum(r["plain_ms"] or 0.0 for r in rows),
            "bound_ms": bound_ms,
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "library_ms": None,
            "shapes": rows,
        })
    return {"kernels": out}


def run(device: str, fold_batch: int, timesteps: int, design_args: list[str]) -> dict:
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(_build.build()) if cuda else None,
          "ptxas": _build.ptxas_report().splitlines() if cuda else []})

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
    info["kernels"] = kernels_line(checks, des["launches"])
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
