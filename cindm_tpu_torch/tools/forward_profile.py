"""Where the time of the forward kernels goes, shape by shape.

    python3 -m cindm_tpu_torch.tools.forward_profile [--batch 5376] [--reps 20] [--design]
        [--saving-batch 512] [--train-step-batch 512] [--ops] [--projections]

Times, with CUDA events after a warm-up, the fused-RTB kernel at each of the
16 block shapes of the flagship denoiser (TemporalUnet1D(24, 8, dim 64)) and
the head's Conv1d+GN+Mish kernel, at one batch (the flagship's folded 5,376
by default) on seeded random inputs, and beside each its stage plan (N tile,
tiles, persistent CTAs; ``split``: each stage launch's items, split items
and most parts of a tile, 0 and 1 in a checkout without the split;
``stage_device_ms``: each stage launch's device ms from torch.profiler)
and,
where the checkout's library has the C entry
``cindm_stage_weights``, the ms of its weight-layout launch alone (a
call's weights in one launch; ``stage_weights_ms`` beside the rows: the
16 blocks' and the head's; ``stage_weights_device_ms`` their device time
from torch.profiler). Where the checkout keeps the staged layouts
(``_build.staged``), ``ms`` is a call on kept layouts (as sampling calls
it), ``ms_restaged`` a call that lays its weights out anew (as the first
call after an optimizer step does), and ``staged_launches`` the layout
launches the timed ``ms`` calls made (0 when the cache holds); a checkout
without the cache lays them out inside every call, so its ``ms`` includes
them and ``ms_restaged`` is null. Then one forward of the full-width
denoiser on the kernel path at that batch.
With ``--design`` it also runs ``cli.design_1d`` once at the flagship
geometry (B 64, 8 bodies, n_composed 2, standard-recurrence-10) on a 20-step
schedule from those weights and gives pair-window denoiser forwards per
second (reverse steps x 10 x 3 windows x 28 pairs x B over its seconds).

With ``--train-step-batch`` it also times one training step of that
denoiser at that batch (``train_step``: ms, the device's busy share, and
the weight layout's launches and device ms in the step).

With ``--ops`` it profiles one forward of that denoiser on the kernel path
at that batch under torch.profiler instead (``forward_ops``): device ms and
launches per aten op (or hand-written kernel), grouped by the denoiser
module that issued it (each attention block, down- and upsampling, the
time MLP, the RTBs' time projections, ``fused_rtb``, the head, the final
conv, the rest: the skip concatenations and copies), with the forward's
host issue ms beside its device ms, and for each resampling launch in
call order its device ms beside the next kernel's (``resample_readers``:
the first to read its output, the next block's stage after a
Downsample1d, the skip concatenation or the final conv after an
Upsample1d).

With ``--projections`` it counts instead the launches of the 16 blocks'
time projections at that batch (``projection_launches``): batched (one
product) and per block, without a gradient and forward + backward under
autograd.

With ``--saving-batch`` it also times the autograd Functions' forward (the
kernels' saving instance) of the 16 blocks and of the head at that batch
(the training batch, 512, where a stage runs 16 or 32 cluster items):
device ms a pass from torch.profiler (the stage kernels' summed time, the
median of ``reps`` traced passes) beside CUDA-event ms.

Prints one JSON line, then the nvidia-smi name and power limit line. It
runs against the package it is imported from, so a copy of this file in
another checkout measures that checkout's kernels. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

from cindm_tpu_torch.tools.backward_profile import HEAD_SHAPE, K, RTB_SHAPES, block_inputs

DESIGN_ARGS = ["--batch_size", "64", "--compose_n_bodies", "8", "--n_composed", "2",
               "--compose_start_step", "4", "--design_guidance", "standard-recurrence-10"]
DESIGN_STEPS = 20
RECURRENCE, N_WINDOWS, N_PAIRS = 10, 3, 28


def events_ms(torch, fn, reps: int) -> float:
    """Mean ms a call of ``fn`` over ``reps`` calls, CUDA events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def block_params(torch, g, C: int, O: int, dev, head: bool) -> dict:
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    p = dict(w1=r(K, C, O, scale=(K * C) ** -0.5), b1=r(O, scale=0.1), gs1=1 + r(O, scale=0.1),
             gb1=r(O, scale=0.1))
    if not head:
        p.update(w2=r(K, O, O, scale=(K * O) ** -0.5), b2=r(O, scale=0.1), gs2=1 + r(O, scale=0.1),
                 gb2=r(O, scale=0.1))
        if C != O:
            p.update(wres=r(C, O, scale=C ** -0.5), bres=r(O, scale=0.1))
    return p


def stage_weights_call(torch, _build, lib, plan, weights, dev):
    """The weight-layout launches of one call as a function (its weights laid
    out for the plan's N tile as the wrappers do: in one launch, or one a
    tensor in a checkout without ``_build.layout_args``), or None where the
    library has no ``cindm_stage_weights``."""
    fn = getattr(lib, "cindm_stage_weights", None)
    if fn is None:
        return None
    outs = [_build.scratch(plan.weight_bytes(w.shape[1], w.shape[0]), dev) for w in weights]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if hasattr(_build, "layout_args"):
        calls = [_build.layout_args([(w, plan.n_tile) for w in weights], outs)]
    else:
        calls = [(w.data_ptr(), *w.shape, plan.n_tile, o.data_ptr()) for w, o in zip(weights, outs)]
    return lambda: [_build.raise_on_error("stage_weights", fn(*a, stream)) for a in calls]


def stage_weights_ms(torch, _build, lib, plan, weights, dev, reps: int):
    """(CUDA-event ms of the weight-layout launches of one call, issued back
    to back, and their device ms from torch.profiler), or (None, None)
    where the library has no ``cindm_stage_weights``."""
    call = stage_weights_call(torch, _build, lib, plan, weights, dev)
    if call is None:
        return None, None
    device = stage_device_ms(torch, call, reps=3, name="stage_weights")
    return events_ms(torch, call, reps), (sum(device) if isinstance(device, list) else device)


def design_rate(torch, dev, model) -> dict:
    """One design_1d run on ``model``'s weights written as a snapshot."""
    import numpy as np

    from cindm_tpu_torch.cli.design_1d import main as design_main
    from cindm_tpu_torch.models import flax_from_params
    from cindm_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT, prefix="forward-profile-") as tmp:
        flat = {"['ema_params']['params']" + k: v for k, v in flax_from_params(model).items()}
        flat["['step']"] = np.asarray(0)
        np.savez(os.path.join(tmp, "persisted_m0.npz"), **flat)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the CLI's record: stdout is this tool's line
            design_main(["--model_path", tmp, "--timesteps", str(DESIGN_STEPS), "--device", str(dev),
                         *DESIGN_ARGS])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    fwds = DESIGN_STEPS * RECURRENCE * N_WINDOWS * N_PAIRS * int(DESIGN_ARGS[1])
    return {"design_seconds": seconds, "pair_window_fwds_per_s": fwds / seconds}


def stage_device_ms(torch, fn, reps: int = 5, name: str = "conv_gn_mish_stage") -> list[float] | str:
    """Device ms of each launch of the kernel ``name`` (the stage by default)
    that one call of ``fn`` makes, in launch order (torch.profiler, median
    over ``reps`` traced calls)."""
    import statistics

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    per = []
    for _ in range(reps):
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and name in e.name), key=lambda e: e.time_range.start)
        per.append([e.time_range.elapsed_us() / 1e3 for e in ev])
    n = max(len(p) for p in per)
    if n == 0:
        return "not measured (no device events)"
    return [statistics.median(p[i] for p in per if len(p) == n) for i in range(n)]


def saving_forward(torch, dev, batch: int = 512, reps: int = 20) -> dict:
    """The saving instance's forward of the 16 blocks (and of the head) at
    ``batch``: device ms a pass of the stage kernels (torch.profiler,
    median pass) and CUDA-event ms."""
    import statistics

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish
    from cindm_tpu_torch.ops.fused_rtb import _fused_rtb

    g = torch.Generator(device=dev).manual_seed(512)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    blocks, head = [], None
    for i, (C, O, T) in enumerate(RTB_SHAPES + [HEAD_SHAPE]):
        x, p, _ = block_inputs(torch, g, C, O, T, batch, dev, i == len(RTB_SHAPES))
        if i == len(RTB_SHAPES):
            head = [x, p["w1"], p["b1"], p["gs1"], p["gb1"]]
        else:
            blocks.append([x if n == "x" else p.get(n) for n in names])
    out = {"batch": batch}
    with torch.no_grad():
        for key, fn in (("blocks", lambda: [_fused_rtb(*a, 8, 1e-5, save=True) for a in blocks]),
                        ("head", lambda: _conv_gn_mish(*head, 8, 1e-5, save=True))):
            fn()
            torch.cuda.synchronize()
            passes, launches = [], 0
            for _ in range(reps):
                with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and "conv_gn_mish_stage" in e.name]
                passes.append(sum(e.time_range.elapsed_us() for e in ev) / 1e3)
                launches = max(launches, len(ev))
            out[f"{key}_device_ms"] = statistics.median(passes) if launches else "not measured (no device events)"
            out[f"{key}_stage_launches"] = launches
            out[f"{key}_events_ms"] = events_ms(torch, fn, reps)
    return out


def train_step(torch, dev, batch: int = 512, reps: int = 10) -> dict:
    """One training step of the full-width denoiser on the kernel path at
    ``batch`` (forward, backward, clip, Adam, the EMA update; every weight
    changed, so each step lays them all out anew): ms a step with CUDA
    events, and from one torch.profiler trace of a step the device's busy
    ms and share and the weight layout's launches and device ms
    (``stage_weights``, not the backward's ``stage_weights_t``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from cindm_tpu_torch.core import make_schedule
    from cindm_tpu_torch.models import TemporalUnet1D
    from cindm_tpu_torch.sampling import Diffusion1DConfig
    from cindm_tpu_torch.train import TrainConfig, init_train_state, make_train_step

    g = torch.Generator(device=dev).manual_seed(7)
    model = TemporalUnet1D(24, 8, dim=64, generator=torch.Generator().manual_seed(0)).to(dev).train()
    data = {"x": 0.5 * torch.randn((batch, 24, 8), generator=g, device=dev),
            "t": torch.randint(0, 1000, (batch,), generator=g, device=dev),
            "noise": torch.randn((batch, 24, 8), generator=g, device=dev)}
    cfg, tcfg = Diffusion1DConfig(rollout_steps=24), TrainConfig(ema_update_every=1)
    state = init_train_state(model, tcfg)
    fn = make_train_step(cfg, make_schedule(1000, device=dev), tcfg, use_kernels=True)
    step_ms = events_ms(torch, lambda: fn(state, data), reps)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(state, data)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    layout = [e for e in ev if "stage_weights" in e.name and "stage_weights_t" not in e.name]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    return {"batch": batch, "step_ms": step_ms, "busy_ms": busy if ev else "not measured (no device events)",
            "busy_share": busy / step_ms if ev else None, "stage_weights_launches": len(layout),
            "stage_weights_device_ms": sum(e.time_range.elapsed_us() for e in layout) / 1e3}


GROUPS = ("attention", "down", "up", "time_mlp", "rtb_time_projection", "fused_rtb", "head",
          "final_conv", "other")
STAGE_KERNELS = ("conv_gn_mish_stage", "stage_weights")  # fused_rtb's launches inside an RTB


def module_ranges(model) -> tuple[list, dict, set]:
    """Forward hooks that put one torch.profiler range around each part of
    a TemporalUnet1D forward: ``denoiser`` (the whole), ``time_mlp`` (the
    time embedding, from ``time_pos`` to ``time_mlp[1]``),
    ``rtb_time_projection`` (the 16 blocks' projections in one product,
    ``time_proj``), ``rtb.<k>``,
    ``attention.<k>``, ``down.<k>``, ``up.<k>``, ``head`` and
    ``final_conv``. Returns (the hook handles, {label: (C, T) seen by the
    module, filled during the forward}, the labels)."""
    from torch.autograd.profiler import record_function

    open_ranges, shapes, handles = {}, {}, []

    def opener(label):
        def pre(mod, args):
            if args and hasattr(args[0], "shape") and args[0].dim() == 3:
                shapes[label] = (int(args[0].shape[2]), int(args[0].shape[1]))
            open_ranges[label] = record_function(label)
            open_ranges[label].__enter__()
        return pre

    def closer(label):
        def post(mod, args, out):
            open_ranges.pop(label).__exit__(None, None, None)
        return post

    parts = [(model, model, "denoiser"), (model.time_pos, model.time_mlp[1], "time_mlp"),
             (model.time_proj, model.time_proj, "rtb_time_projection"),
             (model.final_block, model.final_block, "head"), (model.final_conv, model.final_conv, "final_conv")]
    for name, kind in (("rtbs", "rtb"), ("attns", "attention"), ("downs", "down"), ("ups", "up")):
        parts += [(m, m, f"{kind}.{k}") for k, m in enumerate(getattr(model, name))]
    for first, last, label in parts:
        handles.append(first.register_forward_pre_hook(opener(label)))
        handles.append(last.register_forward_hook(closer(label)))
    return handles, shapes, {label for _, _, label in parts}


def _group(label: str, op: str, cuda: bool) -> str:
    """The kind of module a (module range, op) belongs to. The blocks' time
    projections are ``rtb_time_projection`` (their one product, and inside
    an RTB what is not a stage kernel, as where a block projects its own);
    inside an RTB the hand-written stage kernels are ``fused_rtb``, and on
    the CPU, where the RTB runs plain, all of it is."""
    kind = label.split(".")[0]
    if kind == "rtb":
        return "fused_rtb" if not cuda or any(k in op for k in STAGE_KERNELS) else "rtb_time_projection"
    return "other" if kind == "denoiser" else kind


def forward_ops(torch, dev, model, batch: int = 5376, seed: int = 5376) -> dict:
    """One forward of ``model`` (a TemporalUnet1D) on the kernel path at
    ``batch`` under torch.profiler, op by op: each device kernel's ms (or,
    on the CPU, each top-level op's CPU ms), by the innermost module range
    of ``module_ranges`` around the op that launched it and by op
    (``aten::mm``, or the kernel's own name for a hand-written one);
    ``groups`` sums them per kind of module, largest first. Beside it the
    forward's ms by CUDA events (``forward_ms``), the host's time to issue
    it (``host_issue_ms``: the clock stops when the forward returns) and
    the traced device ms; ``unattributed_ms`` is device time the profiler
    linked to no op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, model.horizon, model.transition_dim), generator=g, device=dev)
    t = torch.randint(0, 20, (batch,), generator=g, device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"batch": batch, "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    with torch.no_grad():
        model(x, t)
        model(x, t)
        sync()
        if cuda:
            out["forward_ms"] = events_ms(torch, lambda: model(x, t), 3)
        t0 = time.perf_counter()
        model(x, t)
        out["host_issue_ms"] = (time.perf_counter() - t0) * 1e3
        sync()
        handles, shapes, labels = module_ranges(model)
        try:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with trace(activities=acts) as prof:
                model(x, t)
                sync()
        finally:
            for h in handles:
                h.remove()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def owner(e):
        while e is not None and e.name not in labels:
            e = e.cpu_parent
        return e.name if e is not None else None

    per = {}  # (label, op) -> [ms, launches]

    def add(label, op, ms):
        cell = per.setdefault((label, op), [0.0, 0])
        cell[0] += ms
        cell[1] += 1

    for e in events:  # device kernels the profiler linked to the op that launched them
        label = owner(e)
        if label is not None and e.name not in labels:
            if cuda:
                for k in e.kernels:
                    add(label, e.name, k.duration / 1e3)
            elif e.cpu_parent is not None and e.cpu_parent.name in labels:
                add(label, e.name, e.cpu_time_total / 1e3)  # the CPU: each op directly in a range
    if cuda:
        # kernels launched outside any op (the hand-written ones, through
        # ctypes): by the module range around their runtime launch call
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in labels]
        device_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
        spans = [(e.time_range.start, e.time_range.end, e.name) for e in events if e.name in labels]
        runtime = {e.id: e for e in events if e.name.startswith("cu")}
        for d in dev_events:
            r = runtime.get(d.id)
            if r is None or (r.cpu_parent is not None and r.cpu_parent.name not in labels):
                continue  # no launch call seen, or one inside an op (linked above)
            inside = [sp for sp in spans if sp[0] <= r.time_range.start <= sp[1]]
            if inside:  # the innermost range: the latest to start
                add(max(inside)[2], d.name, d.time_range.elapsed_us() / 1e3)
    modules, ops, groups = {}, {}, {k: {"ms": 0.0, "launches": 0, "modules": 0} for k in GROUPS}
    for (label, op), (ms, n) in sorted(per.items()):
        mod = modules.setdefault(label, {"ms": 0.0, "launches": 0, "shape_C_T": shapes.get(label), "ops": {}})
        mod["ms"] += ms
        mod["launches"] += n
        mod["ops"][op] = {"ms": ms, "launches": n}
        o = ops.setdefault(op, {"ms": 0.0, "launches": 0})
        o["ms"] += ms
        o["launches"] += n
        grp = groups[_group(label, op, cuda)]
        grp["ms"] += ms
        grp["launches"] += n
    for label in modules:
        if not label.startswith("rtb."):
            groups[_group(label, "", cuda)]["modules"] += 1
    groups["fused_rtb"]["modules"] = groups["rtb_time_projection"]["modules"] = len(model.rtbs)
    attributed = sum(m["ms"] for m in modules.values())
    if cuda:
        out["device_ms"] = device_ms
        out["unattributed_ms"] = device_ms - attributed
        seq = sorted(dev_events, key=lambda e: e.time_range.start)
        out["resample_readers"] = [
            {"resample_ms": e.time_range.elapsed_us() / 1e3, "reader": n.name,
             "reader_ms": n.time_range.elapsed_us() / 1e3} for e, n in zip(seq, seq[1:]) if "resample" in e.name]
    else:
        out["cpu_ms"] = attributed
    out["groups"] = dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"]))
    out["ops"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]["ms"]))
    out["modules"] = modules
    return out


def projection_launches(torch, dev, model, batch: int = 512, seed: int = 512) -> dict:
    """The 16 blocks' time projections of ``model`` (a TemporalUnet1D) at
    ``batch``, in the two forms, without a gradient (as sampling runs them)
    and forward + backward under autograd (as training does): ``batched``
    (``TimeProjections``: one product, each block's a column view) and
    ``per_block`` (each block's Dense(mish(t)), as before). Each count is
    the device kernels that torch.profiler sees (on the CPU: the aten ops
    that ran), the gradients reaching every Dense weight and bias."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from cindm_tpu_torch.models.blocks import mish

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn((batch, model.dim), generator=g, device=dev)
    denses = [r.time for r in model.rtbs]
    params = [p for d in denses for p in (d.weight, d.bias)]
    forms = {"batched": lambda: model.time_proj(t, denses), "per_block": lambda: [d(mish(t)) for d in denses]}

    def count(fn) -> int:
        fn()  # warm-up: the kept concatenation, the libraries' handles
        sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with trace(activities=acts) as prof:
            fn()
            sync()
        if cuda:
            return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        # the CPU: the ops that did the work (no op of theirs inside them)
        return sum(1 for e in prof.events() if e.name.startswith("aten::") and not e.cpu_children)

    out = {"batch": batch, "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "counts": "device kernels" if cuda else "CPU aten ops without an op inside"}
    for name, form in forms.items():
        with torch.no_grad():
            sampling = count(form)

        def train(form=form):
            loss = sum(y.square().mean() for y in form())
            return torch.autograd.grad(loss, params)

        out[name] = {"sampling": sampling, "training": count(train)}
    return out


def profile(torch, dev, batch: int = 5376, reps: int = 20, design: bool = False,
            saving_batch: int | None = None, train_batch: int | None = None) -> dict:
    from cindm_tpu_torch.models import TemporalUnet1D
    from cindm_tpu_torch.ops import _build, fused_conv1d_gn_mish, fused_rtb

    lib = _build.load()
    sms = _build.num_sms(dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    with torch.no_grad():
        for C, O, T in RTB_SHAPES + [HEAD_SHAPE]:
            head = len(rows) == len(RTB_SHAPES)
            x = torch.randn((batch, T, C), generator=g, device=dev)
            p = block_params(torch, g, C, O, dev, head)
            if head:
                call = lambda x=x, p=p: fused_conv1d_gn_mish(x, p["w1"], p["b1"], p["gs1"], p["gb1"])
                weights = [p["w1"]]
            else:
                temb = torch.randn((batch, O), generator=g, device=dev)
                call = lambda x=x, p=p, temb=temb: fused_rtb(x, temb, **p)
                weights = [p["w1"], p["w2"]] + ([p["wres"].view(1, C, O)] if "wres" in p else [])
            plan = _build.plan_stage(batch, T, C, O, 8, num_sms=sms)
            cache = getattr(_build, "staged", None)
            staged0 = cache.launches if cache is not None else 0
            ms = events_ms(torch, call, reps)
            restaged = None
            if cache is not None:
                # past the warm-up's first call: one launch, or one a tensor before the batched layout
                staged0 = cache.launches - staged0 - (1 if hasattr(_build, "layout_args") else len(weights))
                restaged = events_ms(torch, lambda: (cache.clear(), call()), reps)
            rows.append({"C": C, "O": O, "T": T, "kernel": "fused_conv1d_gn_mish" if head else "fused_rtb",
                         "ms": ms, "ms_restaged": restaged,
                         "staged_launches": staged0 if cache is not None else None, "n_tile": plan.n_tile,
                         "tiles": plan.grid[0] * plan.grid[1], "ctas": getattr(plan, "ctas", None),
                         "cluster": getattr(plan, "cluster", None),
                         # each stage launch's (items, split items, most parts of a tile)
                         "split": [[p.items, getattr(p, "tail", 0), getattr(p, "max_parts", 1)]
                                   for p in ([plan] if head else
                                             [plan, _build.plan_stage(batch, T, O, O, 8, num_sms=sms)])],
                         **dict(zip(("stage_weights_ms", "stage_weights_device_ms"),
                                    stage_weights_ms(torch, _build, lib, plan, weights, dev, reps))),
                         "stage_device_ms": stage_device_ms(torch, call)})
            del x, p
        model = TemporalUnet1D(24, 8, dim=64, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        xd = torch.randn((batch, 24, 8), generator=g, device=dev)
        td = torch.randint(0, 20, (batch,), generator=g, device=dev)
        den_ms = events_ms(torch, lambda: model(xd, td), max(3, reps // 4))
    rtb = [r for r in rows if r["kernel"] == "fused_rtb"]
    restaged = [r["ms_restaged"] for r in rtb]
    out = {"batch": batch, "shapes": rows, "fused_rtb_ms": sum(r["ms"] for r in rtb),
           "fused_rtb_restaged_ms": None if None in restaged else sum(restaged),
           "head_ms": rows[-1]["ms"], "denoiser_forward_ms": den_ms,
           "device": torch.cuda.get_device_name(dev)}
    sw = [r["stage_weights_ms"] for r in rtb]
    out["fused_rtb_stage_weights_ms"] = None if None in sw else sum(sw)
    # the 16 blocks' and the head's layouts: one launch a call
    out["stage_weights_ms"] = None if None in sw else sum(sw) + rows[-1]["stage_weights_ms"]
    dw = [r["stage_weights_device_ms"] for r in rows]
    out["stage_weights_device_ms"] = sum(dw) if all(isinstance(v, float) for v in dw) else "not measured"
    if design:
        out.update(design_rate(torch, dev, model))
    if saving_batch:
        out["saving_forward"] = saving_forward(torch, dev, saving_batch, reps)
    if train_batch:
        out["train_step"] = train_step(torch, dev, train_batch, max(3, reps // 2))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=5376)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--design", action="store_true", help="also time one flagship design run")
    ap.add_argument("--saving-batch", type=int, default=None,
                    help="also time the saving forward of the 16 blocks and the head at this batch")
    ap.add_argument("--train-step-batch", type=int, default=None,
                    help="also time one training step of the denoiser at this batch")
    ap.add_argument("--ops", action="store_true",
                    help="profile one denoiser forward op by op at --batch instead")
    ap.add_argument("--projections", action="store_true",
                    help="count the time projections' launches, batched and per block, at --batch instead")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("forward_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from cindm_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # TF32 off, as every entry point of the port sets it
    if args.ops or args.projections:
        from cindm_tpu_torch.models import TemporalUnet1D

        model = TemporalUnet1D(24, 8, dim=64, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        fn = forward_ops if args.ops else projection_launches
        print(json.dumps(fn(torch, dev, model, args.batch)), flush=True)
    else:
        print(json.dumps(profile(torch, dev, args.batch, args.reps, args.design, args.saving_batch,
                                 args.train_step_batch)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
