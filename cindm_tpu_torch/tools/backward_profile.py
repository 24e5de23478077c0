"""Where the time of the backward kernels goes, kernel by kernel.

    python3 -m cindm_tpu_torch.tools.backward_profile [--batch 512] [--reps 10]

Runs the backward kernels of the denoiser's 16 fused ResidualTemporalBlocks
and of its head Conv1d+GN+Mish (TemporalUnet1D(24, 8, dim 64)) at one batch
on what the forward's saving instance kept (seeded random weights, inputs
and cotangents), and prints one JSON line:

- ``kernels``: per kernel of the backward (stage_weights_t, gn_mish_bwd,
  dgrad_gn_stage, dgrad_x_stage, wgrad, grad_reduce) its device ms in one
  backward pass of the 17 blocks, from torch.profiler (the median of
  ``reps`` traced passes), its launches in a pass, and its bound on an H100
  (3xTF32 operations at 495 TFLOP/s or bytes at 3.35 TB/s, the larger);
  wgrad also its fp32 bound (67 TFLOP/s) and ``library_ms``, the time of
  ``torch.nn.grad.conv1d_weight`` (cuDNN, fp32, TF32 off) on the same
  convolutions, a yardstick that the port never calls; the two dgrads
  their ``library_ms`` from ``torch.nn.grad.conv1d_input`` on their
  convolutions (the convolution only: dgrad_gn_stage also runs the first
  GroupNorm's backward, dgrad_x_stage the 1x1 product) and ``per_launch``:
  each launch's shape, grid, cluster size and device ms (median pass);
  gn_mish_bwd its ``per_launch`` (shape, grid, CTAs, threads, ms) and its
  ``library_ms``, ``torch.ops.aten.native_group_norm_backward`` on the
  same shapes (the GroupNorm's backward only: no Mish, no operand layout;
  the port never calls it). The bytes of gn_mish_bwd's bound count g and z
  read, dz written and wgrad's two-plane operand layouts it writes (dz, and
  g on a projection block), dgrad_gn_stage's its dz1 layout;
- ``backward_ms`` (the 16 blocks' backward kernels alone, CUDA events),
  ``backward_host_ms`` (the host's time to issue them: when it exceeds the
  kernels' device time, ``backward_ms`` reads the host), ``head_backward_ms``, ``fwd_bwd_ms`` (the 16 blocks' forward and backward
  through the autograd Functions);
- ``wgrad_partial_bytes``: the plan's partials of the weight gradients.

Then the nvidia-smi name and power limit line. It runs against the
package it is imported from, so a copy of this file in another checkout
measures that checkout's kernels. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# (C_in, C_out, T) of the 16 blocks in call order, and of the head
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)
K = 5
KERNELS = ("stage_weights_t", "gn_mish_bwd", "dgrad_gn_stage", "dgrad_x_stage", "wgrad",
           "grad_reduce")
PER_LAUNCH = ("gn_mish_bwd", "dgrad_gn_stage", "dgrad_x_stage")  # each launch timed on its own
PEAK_TF32 = 495e12  # H100 SXM dense TF32, FLOP/s
PEAK_FP32 = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
TF32_PASSES = 3  # 3xTF32: each product issued three times


def valid_taps(T: int, k: int = K) -> int:
    """Taps of a k-wide, k//2-padded conv over T rows that land inside the sample."""
    return sum(1 for t in range(T) for j in range(k) if 0 <= t + j - k // 2 < T)


def kernel_of(name: str) -> str | None:
    """The backward kernel a profiler event's (demangled) name belongs to."""
    for k in KERNELS:  # stage_weights_t before the forward's stage_weights
        if f"{k}(" in name or f"{k}<" in name:
            return k
    return None


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_TF32) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def events_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """The host's time to issue ``fn``'s work, without waiting for the card
    (it waits only before starting the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def block_inputs(torch, g, C: int, O: int, T: int, batch: int, dev, head: bool):
    """Seeded weights and inputs of one block (the head: its one conv) as
    the denoiser's initialisers scale them, and a cotangent of its output."""
    def u(shape, fan_in):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) / fan_in ** 0.5

    def n(shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    x = torch.randn((batch, T, C), generator=g, device=dev)
    p = dict(w1=u((K, C, O), K * C), b1=u((O,), K * C), gs1=1 + n((O,), 0.1), gb1=n((O,), 0.1))
    if not head:
        p.update(temb=torch.randn((batch, O), generator=g, device=dev), w2=u((K, O, O), K * O),
                 b2=u((O,), K * O), gs2=1 + n((O,), 0.1), gb2=n((O,), 0.1))
        if C != O:
            p.update(wres=u((C, O), C), bres=u((O,), C))
    return x, p, torch.randn((batch, T, O), generator=g, device=dev)


def timed_launches(_build, plan, C: int, O: int, head: bool) -> list[tuple[str, tuple, int]]:
    """(kernel, grid, cluster size or threads) of the plan's gn_mish_bwd and
    dgrad launches, in launch order; a plan without clusters (an older
    checkout) launches one CTA a tile, one without gn_mish_bwd's own tiles
    384 threads on the dgrads' row tiles."""
    rt = plan.row_tiles
    out = [("gn_mish_bwd", getattr(plan, "grid_gn", (rt, -(-O // plan.nt_gn))),
            getattr(plan, "gn_threads", 384))]
    if not head:
        cs = getattr(plan, "cs_d2", 1)
        out.append(("dgrad_gn_stage", getattr(plan, "grid_d2", (rt, -(-O // plan.nt_d2))), cs))
    cs = getattr(plan, "cs_d1", 1)
    out.append(("dgrad_x_stage", getattr(plan, "grid_d1", (rt, -(-C // plan.nt_d1))), cs))
    return out


def profile(torch, dev, batch: int = 512, reps: int = 10) -> dict:
    """The measurements this module's docstring lists, as a dict."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from cindm_tpu_torch.ops import _build, fused_rtb_differentiable
    from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish, fused_conv1d_gn_mish_backward
    from cindm_tpu_torch.ops.fused_rtb import _fused_rtb, fused_rtb_backward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(2024)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    calls, rtb_calls, fwd_bwd, lib = [], [], [], []
    dlib = {"dgrad_gn_stage": [], "dgrad_x_stage": []}  # the dgrads' convolutions for cuDNN
    gnlib = []  # the last GroupNorm of each block: aten's GroupNorm backward on its shapes
    launches = []  # (kernel, shape, grid, cluster or threads) of every launch timed one by one
    plan_kw = {}
    if hasattr(_build, "cluster_limits"):  # the card's limits, as the launches plan with them
        plan_kw["clusters"] = _build.cluster_limits(dev)
    work = {k: dict(flops=0.0, nbytes=0.0) for k in KERNELS}
    wgrad_fp32_flops, partial_bytes, weight_bytes = 0.0, 0, 0
    with torch.no_grad():
        for C, O, T in RTB_SHAPES + [HEAD_SHAPE]:
            head = (C, O, T) == HEAD_SHAPE and len(calls) == len(RTB_SHAPES)
            x, p, cot = block_inputs(torch, g, C, O, T, batch, dev, head)
            proj = "wres" in p
            taps = valid_taps(T)
            rows = batch * T
            if head:
                args = [x, p["w1"], p["b1"], p["gs1"], p["gb1"]]
                saved = args + list(_conv_gn_mish(*args, 8, 1e-5, save=True)[1:])
                calls.append(lambda s=saved, c=cot: fused_conv1d_gn_mish_backward(s, c, [True] * 5))
                w_macs, d_macs, d2_macs = taps * C * O, taps * C * O, 0
                wts = [p["w1"]]
                plan = _build.plan_backward(batch, T, C, O, 8, proj=False, rtb=False, **plan_kw)
            else:
                args = [x if n == "x" else p.get(n) for n in names]
                saved = args + list(_fused_rtb(*args, 8, 1e-5, save=True)[1:])
                call = lambda s=saved, c=cot, pr=proj: fused_rtb_backward(s, c, [True] * 10 + [pr] * 2)
                calls.append(call)
                rtb_calls.append(call)
                w_macs = taps * C * O + taps * O * O + (T * C * O if proj else 0)
                d2_macs = taps * O * O
                d_macs = taps * C * O + (T * C * O if proj else 0)
                wts = [p["w1"], p["w2"]] + ([p["wres"]] if proj else [])
                plan = _build.plan_backward(batch, T, C, O, 8, proj=proj, **plan_kw)
                fa = dict(zip(names, args))
                fwd_bwd.append((fa, cot))
            launches += [(k, (C, O, T), grid, x) for k, grid, x in timed_launches(_build, plan, C, O, head)]
            # the dgrads' yardstick: cuDNN's input gradients of the same convolutions
            # (weights [out, in, K]; the cotangents random, of the convs' output shapes)
            if not head:
                dlib["dgrad_gn_stage"].append(((batch, O, T), p["w2"].permute(2, 1, 0).contiguous(),
                                               torch.randn((batch, O, T), generator=g, device=dev)))
            dlib["dgrad_x_stage"].append(((batch, C, T), p["w1"].permute(2, 1, 0).contiguous(),
                                          torch.randn((batch, O, T), generator=g, device=dev)))
            # gn_mish_bwd's yardstick: the GroupNorm's backward alone, [B, O, T] layout
            zc = torch.randn((batch, O, T), generator=g, device=dev)
            gw_ = p["gs1"] if head else p["gs2"]
            _, mean_, rstd_ = torch.ops.aten.native_group_norm(zc, gw_, None, batch, O, T, 8, 1e-5)
            gnlib.append((torch.randn((batch, O, T), generator=g, device=dev), zc, mean_, rstd_, gw_,
                          batch, O, T))
            # wgrad's library yardstick: the same convolutions as cuDNN computes their weight grads
            xc = x.transpose(1, 2).contiguous()
            dz = cot.transpose(1, 2).contiguous()
            lib.append((xc, (O, C, K), dz, K // 2))
            if not head:
                h = torch.randn((batch, O, T), generator=g, device=dev)
                lib.append((h, (O, O, K), dz, K // 2))
                if proj:
                    lib.append((xc, (O, C, 1), dz, 0))
            wbytes = 4 * sum(w.numel() for w in wts)
            weight_bytes += wbytes
            act = 4 * rows * (C + (0 if head else O))  # x (and h), each read once
            work["wgrad"]["flops"] += TF32_PASSES * 2 * batch * w_macs
            work["wgrad"]["nbytes"] += act + 4 * rows * O * (1 if head else 2) + wbytes
            wgrad_fp32_flops += 2 * batch * w_macs
            work["stage_weights_t"]["nbytes"] += 3 * wbytes  # read once, two tf32 planes written
            # g and z read, dz written; dz (and g on a projection block) in
            # wgrad's operand layout, two tf32 planes of 4 bytes
            work["gn_mish_bwd"]["nbytes"] += 4 * 3 * rows * O + 8 * rows * O * (2 if proj else 1)
            work["dgrad_gn_stage"]["flops"] += TF32_PASSES * 2 * batch * d2_macs
            # dz2, z1 read; dz1 written and in the operand layout, dtemb
            work["dgrad_gn_stage"]["nbytes"] += 0 if head else 4 * 4 * rows * O + 8 * rows * O
            work["dgrad_x_stage"]["flops"] += TF32_PASSES * 2 * batch * d_macs
            work["dgrad_x_stage"]["nbytes"] += 4 * rows * (O + C + (O if not head else 0))
            colparts = plan.colpart_bytes
            work["grad_reduce"]["nbytes"] += plan.wpart_bytes + colparts
            partial_bytes += plan.wpart_bytes
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    # per traced pass, each kernel's summed device time and launches; a pass
    # whose trace lost events (seen on a process's first trace) reads low,
    # so the median pass gives the time and the fullest one the launches
    passes, each = [], []
    for _ in range(reps):
        ms = {k: 0.0 for k in KERNELS}
        counts = {k: 0 for k in KERNELS}
        seq = {k: [] for k in PER_LAUNCH}  # per launch, in launch order
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        for e in sorted(prof.events(), key=lambda e: e.time_range.start):
            k = kernel_of(e.name) if e.device_type == torch.autograd.DeviceType.CUDA else None
            if k is not None:
                ms[k] += e.time_range.elapsed_us() / 1e3
                counts[k] += 1
                if k in seq:
                    seq[k].append(e.time_range.elapsed_us() / 1e3)
        passes.append((ms, counts))
        each.append(seq)
    kernels = {}
    for k in KERNELS:
        b, by = bound_ms(work[k]["flops"], work[k]["nbytes"])
        n = max(c[k] for _, c in passes)
        kernels[k] = dict(ms=statistics.median(m[k] for m, _ in passes) if n else
                          "not measured (no device events)", launches=n, bound_ms=b, bound_by=by)
    kernels["wgrad"]["bound_fp32_ms"] = bound_ms(wgrad_fp32_flops, work["wgrad"]["nbytes"],
                                                 PEAK_FP32)[0]
    kernels["wgrad"]["gflop"] = wgrad_fp32_flops / 1e9
    kernels["wgrad"]["library_ms"] = events_ms(torch, lambda: [
        torch.nn.grad.conv1d_weight(i, w, o, padding=pad) for i, w, o, pad in lib], reps)
    kernels["wgrad"]["library"] = "torch.nn.grad.conv1d_weight, fp32, cuDNN TF32 off"
    kernels["stage_weights_t"]["weight_bytes"] = weight_bytes
    for k, convs in dlib.items():
        kernels[k]["library_ms"] = events_ms(torch, lambda c=convs: [
            torch.nn.grad.conv1d_input(size, w, d, padding=K // 2) for size, w, d in c], reps)
        kernels[k]["library"] = ("torch.nn.grad.conv1d_input, fp32, cuDNN TF32 off; the convolution "
                                 "only" + (" (the kernel also runs the first GroupNorm's backward)"
                                           if k == "dgrad_gn_stage" else " (the kernel also adds the "
                                           "1x1 product or the identity)"))
    kernels["gn_mish_bwd"]["library_ms"] = events_ms(torch, lambda: [
        torch.ops.aten.native_group_norm_backward(d, z, m, r, w, n, c, hw, 8, [True, True, True])
        for d, z, m, r, w, n, c, hw in gnlib], reps)
    kernels["gn_mish_bwd"]["library"] = (
        "torch.ops.aten.native_group_norm_backward, fp32, [B, O, T]: the GroupNorm's backward only "
        "(the kernel also runs Mish's and writes wgrad's operand layouts)")
    for k in PER_LAUNCH:
        mine = [(shape, grid, x) for kk, shape, grid, x in launches if kk == k]
        full = [s[k] for s in each if len(s[k]) == len(mine)]  # passes that traced every launch
        kernels[k]["per_launch"] = [
            {"shape": list(shape), "grid": list(grid), "ctas": grid[0] * grid[1],
             ("threads" if k == "gn_mish_bwd" else "cluster"): x,
             "ms": statistics.median(f[i] for f in full) if full else "not measured"}
            for i, (shape, grid, x) in enumerate(mine)]

    def fwd_bwd_all():
        for a, c in fwd_bwd:
            ts = {n: (None if v is None else v.detach().requires_grad_(True)) for n, v in a.items()}
            out = fused_rtb_differentiable(**ts)
            torch.autograd.grad(out, [v for v in ts.values() if v is not None], c)

    complete = sum(all(c[k] == kernels[k]["launches"] for k in KERNELS) for _, c in passes)
    return {"batch": batch, "kernels": kernels, "traced_passes_complete": f"{complete}/{reps}",
            "backward_ms": events_ms(torch, lambda: [f() for f in rtb_calls], reps),
            "backward_host_ms": host_ms(torch, lambda: [f() for f in rtb_calls], reps),
            "head_backward_ms": events_ms(torch, calls[-1], reps),
            "fwd_bwd_ms": events_ms(torch, fwd_bwd_all, reps),
            "wgrad_partial_bytes": partial_bytes,
            "cluster_limits": plan_kw.get("clusters", "none: one CTA a tile"),
            "device": torch.cuda.get_device_name(dev)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("backward_profile: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(json.dumps(profile(torch, dev, args.batch, args.reps)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
