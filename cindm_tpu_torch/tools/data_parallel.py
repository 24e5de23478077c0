"""The data-parallel paths at W ranks against one process, with per-rank times.

    torchrun --standalone --nproc_per_node 1 -m cindm_tpu_torch.tools.data_parallel --out one
    torchrun --standalone --nproc_per_node 4 -m cindm_tpu_torch.tools.data_parallel --out four
    python3 -m cindm_tpu_torch.tools.data_parallel --compare one four

Each rank joins the process group that torchrun describes (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL with one card per
rank (``cuda:LOCAL_RANK``), or gloo on ``cuda:0`` when there are more ranks
than cards (gloo on the CPU with ``--device cpu``). It then runs ``cases``
over the data mesh: the train step's gradient of the seeded full-width
TemporalUnet1D at batch 512 (kernels on, draws injected), the flagship
guided sampler (8 bodies, n_composed 2, standard-recurrence-10, B = 64)
through ``make_sharded_sampler``, and ``p_sample_loop_2d`` with the seeded
Unet2D and ForceUnet at 4 designs x 3 boundaries, 5 reverse steps each,
timed per rank. Every rank writes ``<out>/rank<r>.pt`` (its results, ms and
kernel launches); rank 0 prints one JSON line of the times and the
nvidia-smi name and power limit. ``--compare A B`` prints, for every rank of
B, the largest error of each result against rank 0 of A, relative to its
largest entry (the gradient per parameter). ``--kernel-dir`` builds the
kernels there (``utils.cache.enable_compile_cache``) and ``--sizes`` (JSON)
overrides ``SIZES``: smaller for a CPU rehearsal, or N times the batches
for weak scaling (``--sizes '{"train_batch": 2048, "sample_batch": 256,
"designs": 16}'`` at 4 ranks gives each rank one process's work).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# The train phase's batch and width, the flagship design batch, the design2d
# phase's widths at 4 designs x 3 boundaries; 5 steps of each.
SIZES = {"train_batch": 512, "dim": 64, "sample_batch": 64, "designs": 4, "nb": 3,
         "dim2d": 64, "force_mults": [1, 2, 4, 8], "steps": 5, "timed_steps": 3}
RECURRENCE = 10


def launches() -> dict:
    """The kernel counters of ``cindm_tpu_torch.ops``."""
    from ..ops import (FusedConv1dGNMish, FusedRTB, downsample1d, fused_conv1d_gn_mish,
                       fused_conv1d_gn_mish_backward, fused_rtb, fused_rtb_backward,
                       prenorm_linear_attention, upsample1d)

    return {"fused_rtb": fused_rtb.launches, "fused_conv1d_gn_mish": fused_conv1d_gn_mish.launches,
            "FusedRTB_launches": FusedRTB.launches, "FusedRTB_backward_passes": FusedRTB.backwards,
            "FusedConv1dGNMish_launches": FusedConv1dGNMish.launches,
            "FusedConv1dGNMish_backward_passes": FusedConv1dGNMish.backwards,
            "fused_rtb_backward": fused_rtb_backward.launches,
            "fused_conv1d_gn_mish_backward": fused_conv1d_gn_mish_backward.launches,
            "prenorm_linear_attention": prenorm_linear_attention.launches,
            "upsample1d": upsample1d.launches, "downsample1d": downsample1d.launches}


def cases(dev: torch.device, mesh, sizes: dict) -> dict:
    """The three computations, on this rank's rows under ``mesh`` or on the
    whole batch without one: (1) the p_losses gradient through the train
    step (the optimizer replaced by a recorder, so the weights stay put),
    (2) the flagship sampler, (3) the guided 2D loop. Each part's kernel
    launches (counter differences) and ms (a train step; a reverse step)."""
    from ..core import make_schedule
    from ..models import ForceUnet, TemporalUnet1D, Unet2D
    from ..parallel import make_sharded_sampler, shard_batch
    from ..sampling import Diffusion1DConfig, get_design_fn, sample
    from ..sampling.diffusion2d import Diffusion2DConfig, nhwc_model, p_sample_loop_2d
    from ..sampling.guidance2d import make_design_grad_fn
    from ..sampling.sampler import generator_randn
    from ..train import TrainConfig, init_train_state, make_train_step

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    W = 1 if mesh is None else mesh.size()
    steps, B = sizes["steps"], sizes["train_batch"]
    out = {"launches": {}, "ms": {}}

    def since(before):
        return {k: v - before[k] for k, v in launches().items()}

    model = TemporalUnet1D(24, 8, dim=sizes["dim"], generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    batch = {"x": torch.randn((B, 24, 8), generator=g, device=dev),
             "t": torch.randint(0, 1000, (B,), generator=g, device=dev),
             "noise": torch.randn((B, 24, 8), generator=g, device=dev)}
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    state = init_train_state(model.train(), TrainConfig())
    grads = []

    def record(params, gs):  # the step's (all-reduced) gradients; no update
        grads.append([x.detach().clone() for x in gs])
        return False

    state.opt_state.update = record
    step = make_train_step(Diffusion1DConfig(rollout_steps=24, timesteps=1000),
                           make_schedule(1000, device=dev), TrainConfig(), mesh=mesh)
    before = launches()
    step(state, batch)
    sync()
    out["launches"]["train_step"] = since(before)
    out["grads"] = [x.cpu() for x in grads[0]]
    t0 = time.perf_counter()
    for _ in range(sizes["timed_steps"]):
        step(state, batch)
    sync()
    out["ms"]["train_step"] = 1e3 * (time.perf_counter() - t0) / sizes["timed_steps"]

    model.eval()
    dcfg = Diffusion1DConfig(rollout_steps=24, timesteps=steps)
    sched = make_schedule(steps, device=dev)
    design_fn = get_design_fn(torch.tensor([0.5, 0.5], device=dev), last_n_step=1, coef=0.2,
                              time_consistency_coef=0.2)
    sample_fn = lambda randn, **kw: sample(dcfg, sched, model, randn, **kw)
    if mesh is not None:
        sample_fn = make_sharded_sampler(sample_fn, mesh)
    randn = generator_randn(torch.Generator(device=dev).manual_seed(11), dev)
    before = launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        x = sample_fn(randn, batch_size=sizes["sample_batch"], feature_size=32, design_fn=design_fn,
                      design_guidance=f"standard-recurrence-{RECURRENCE}", n_composed=2,
                      compose_start_step=4, compose_n_bodies=8)
    sync()
    out["ms"]["reverse_step_1d"] = 1e3 * (time.perf_counter() - t0) / steps
    out["launches"]["sampler_1d"] = since(before)
    out["sample_1d"] = x.cpu()

    nb, designs = sizes["nb"], sizes["designs"]
    cfg = Diffusion2DConfig(timesteps=steps, coeff_ratio=2e-4)
    unet = Unet2D(dim=sizes["dim2d"], dim_mults=(1, 2), channels=cfg.channels,
                  generator=torch.Generator().manual_seed(0)).to(dev).eval().requires_grad_(False)
    fm = ForceUnet(dim=sizes["dim2d"], dim_mults=tuple(sizes["force_mults"]),
                   generator=torch.Generator().manual_seed(1)).to(dev).eval().requires_grad_(False)
    # the design function sees this rank's designs
    design2d = make_design_grad_fn(fm, designs // W, nb, cfg.frames, -1.0, 1.0)
    randn = generator_randn(torch.Generator(device=dev).manual_seed(5), dev)
    before = launches()
    t0 = time.perf_counter()
    x = p_sample_loop_2d(cfg, cfg.make_schedule(device=dev), nhwc_model(unet), randn, batch=designs,
                         num_boundaries=nb, design_fn=design2d, design_guidance="standard-alpha",
                         mesh=mesh)
    sync()
    out["ms"]["reverse_step_2d"] = 1e3 * (time.perf_counter() - t0) / steps
    out["launches"]["sampler_2d"] = since(before)
    out["sample_2d"] = x.cpu()
    return out


def rank_device(device: str) -> tuple[torch.device, str]:
    """This rank's device and backend: ``cuda:LOCAL_RANK`` over NCCL when
    every rank has a card of its own, else ``cuda:0`` over gloo (NCCL
    refuses two ranks on one card); the CPU over gloo."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if int(os.environ["LOCAL_WORLD_SIZE"]) <= torch.cuda.device_count():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"])), "nccl"
    return torch.device("cuda", 0), "gloo"


def run_rank(out_dir: str, device: str, sizes: dict, kernel_dir: str | None) -> dict:
    """One rank: join the group, build the kernels, run ``cases`` over the
    mesh; writes and returns the rank's record."""
    import torch.distributed as dist

    from ..ops import _build
    from ..parallel import initialize_multihost, make_mesh
    from ..utils.cache import enable_compile_cache

    dev, backend = rank_device(device)
    rank = int(os.environ["RANK"])
    rec = {"rank": rank, "world": int(os.environ["WORLD_SIZE"]), "backend": backend,
           "device": str(dev)}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        rec["compile_cache"] = enable_compile_cache(kernel_dir) if kernel_dir else False
        t0 = time.perf_counter()
        rec["library"] = str(_build.build())
        _build.load()
        rec["build_seconds"] = time.perf_counter() - t0
    initialize_multihost(backend=backend, device=dev)
    try:
        rec.update(cases(dev, make_mesh(rec["world"]), sizes))
    finally:
        dist.destroy_process_group()
    os.makedirs(out_dir, exist_ok=True)
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    return rec


def relative_errors(got: dict, want: dict) -> dict:
    """Largest |got - want| over the largest |want|: the gradient's worst
    parameter, each sample batch."""
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return {"grad": max(rel(a, b) for a, b in zip(got["grads"], want["grads"])),
            "sample_1d": rel(got["sample_1d"], want["sample_1d"]),
            "sample_2d": rel(got["sample_2d"], want["sample_2d"])}


def load_ranks(out_dir: str) -> list[dict]:
    files = sorted(f for f in os.listdir(out_dir) if f.startswith("rank") and f.endswith(".pt"))
    return [torch.load(os.path.join(out_dir, f)) for f in files]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="directory for each rank's rank<r>.pt")
    p.add_argument("--device", default="cuda")
    p.add_argument("--sizes", default=None, help="JSON overriding entries of SIZES")
    p.add_argument("--kernel-dir", default=None, help="build the kernels in this directory")
    p.add_argument("--compare", nargs=2, metavar=("ONE", "MANY"),
                   help="two --out directories: errors of MANY's ranks against ONE's rank 0")
    args = p.parse_args(argv)
    if args.compare:
        want = load_ranks(args.compare[0])[0]
        got = load_ranks(args.compare[1])
        print(json.dumps({"world": [r["world"] for r in (want, got[0])],
                          "errors": [relative_errors(r, want) for r in got]}), flush=True)
        return 0
    sizes = {**SIZES, **json.loads(args.sizes or "{}")}
    rec = run_rank(args.out, args.device, sizes, args.kernel_dir)
    if rec["rank"] == 0:
        print(json.dumps({k: rec[k] for k in ("world", "backend", "device", "ms", "launches")}),
              flush=True)
        if rec["device"].startswith("cuda"):
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
