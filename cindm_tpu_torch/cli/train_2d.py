"""train_2d: airfoil diffusion training, PyTorch port.

Port of ``cindm_tpu/cli/train_2d.py`` with the same flags, plus ``--device``
(default ``cuda``). It trains the 2D prior that ``design_2d`` samples:
``Unet2D(dim 64, dim_mults (1, 2))`` over [cond frames | pred frames | mask,
offx, offy] (21 channels at 2 + 4 frames), on airfoil flows that the
port's batched BDIM solver simulates on the device:

    python -m cindm_tpu_torch.cli.train_2d --batch_size 48 --n_sims 384 \\
        --is_testdata False --train_num_steps 60000 --save_and_sample_every 5000 \\
        --data_cache ./dataset/airfoil_384 --results_folder ./results/airfoil_torch

``--is_testdata True`` (the default) records 40 frames after 60 warm-up
steps a simulation, else 100 after 300. The batch is ``min(batch_size,
windows)``: the default 4 simulations give 16 windows. ``--device_data
True`` keeps the normalized frames on the device and draws each batch there
(``AirfoilDataset.make_device_sampler``); ``False`` iterates the numpy
batches, which are the JAX package's batches. ``--remat True`` recomputes
each ResnetBlock2D and attention residual in the backward pass.

Outputs in ``--results_folder``: milestones ``model-<step>.pt`` every
``--save_and_sample_every`` steps (``--resume True`` continues from the
newest, or from the newest ``persisted_m*.npz``), and two the JAX CLI does
not write: ``persisted_m<step>.npz`` at the end of a run (EMA weights in
bfloat16, the layout ``design_2d`` of either package reads) and one line per
run in ``train_records.jsonl`` (steps, last loss, samples/s, the first
step's seconds apart from the steady ms a step, data seconds), which is
also printed last.

Departures from the JAX CLI: the batch draws and the loss's draws come from
one ``torch.Generator`` seeded with ``--seed``; ``--steps_per_launch`` is
accepted and has no effect (one micro-step a call); ``--n_devices > 0``
raises (multi-GPU is not ported).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train airfoil diffusion, PyTorch port")
    p.add_argument("--cond_frames", type=int, default=2)
    p.add_argument("--pred_frames", type=int, default=4)
    p.add_argument("--ts", type=int, default=4, help="time interval")
    p.add_argument("--batch_size", type=int, default=48)
    p.add_argument("--train_num_steps", type=int, default=6)
    p.add_argument("--save_and_sample_every", type=int, default=2)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--is_testdata", type=lambda s: s == "True", default=True)
    p.add_argument("--n_sims", type=int, default=4)
    p.add_argument("--results_folder", default="./results/airfoil")
    p.add_argument("--data_cache", default=None)
    p.add_argument("--x_band", type=float, nargs=2, default=[0.25, 0.45],
                   help="boundary placement x band (fraction of grid)")
    p.add_argument("--y_band", type=float, nargs=2, default=[0.4, 0.6],
                   help="boundary placement y band; widen (e.g. 0.2 0.8) to "
                        "support multi-boundary region-partition designs")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--steps_per_launch", type=int, default=1,
                   help="accepted for the JAX CLI's scripts and has no effect: "
                        "the port's host loop runs one micro-step per call")
    p.add_argument("--device_data", type=lambda s: s == "True", default=True,
                   help="keep the dataset on the device and gather batches there")
    p.add_argument("--resume", type=lambda s: s == "True", default=False)
    p.add_argument("--remat", type=lambda s: s == "True", default=False,
                   help="recompute each ResnetBlock2D / attention residual in the "
                        "backward pass instead of storing its interior")
    p.add_argument("--n_devices", type=int, default=0,
                   help="multi-GPU training is not ported yet; only 0 is accepted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def main(argv=None):
    from ..core import make_schedule
    from ..data.airfoil import AirfoilDataset, AirfoilDatasetConfig, generate_airfoil_sims
    from ..models import Unet2D
    from ..physics.bdim import BDIMConfig
    from ..sampling.diffusion2d import Diffusion2DConfig
    from ..train import CheckpointManager, TrainConfig, init_train_state, make_train_step_2d
    from ..utils.device import resolve_device
    from ..utils.persist import save_npz

    args = build_parser().parse_args(argv)
    if args.n_devices > 0:
        raise SystemExit("--n_devices > 0: multi-GPU training is not ported yet (roadmap slice 7)")
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    acfg = AirfoilDatasetConfig(
        input_steps=args.cond_frames, output_steps=args.pred_frames, time_interval=args.ts,
        time_stamps=40 if args.is_testdata else 100,
        n_warmup=60 if args.is_testdata else 300,
        x_band=tuple(args.x_band), y_band=tuple(args.y_band),
    )
    t0 = time.perf_counter()
    data = generate_airfoil_sims(args.seed, args.n_sims, acfg, BDIMConfig(),
                                 cache_dir=args.data_cache, device=dev)
    data_seconds = time.perf_counter() - t0
    ds = AirfoilDataset(data, acfg)

    cfg = Diffusion2DConfig(frames=args.cond_frames + args.pred_frames,
                            cond_frames=args.cond_frames, pred_frames=args.pred_frames,
                            timesteps=args.timesteps)
    model = Unet2D(dim=64, dim_mults=(1, 2), channels=cfg.channels, remat=args.remat,
                   generator=torch.Generator().manual_seed(args.seed)).to(dev)
    print(f"Number of parameter: {sum(p.numel() for p in model.parameters())/1e6:.2f}M")

    sched = make_schedule(cfg.timesteps, cfg.beta_schedule, device=dev)
    tcfg = TrainConfig()
    state = init_train_state(model, tcfg)
    draws = torch.Generator(device=dev).manual_seed(args.seed)
    step = make_train_step_2d(cfg, sched, tcfg, generator=draws)
    batch_size = min(args.batch_size, len(ds))
    if args.device_data:
        prep = os.path.join(args.data_cache, "flatrows_v1.npy") if args.data_cache else None
        draw = ds.make_device_sampler(batch_size, device=dev, prep_cache=prep)
        next_batch = lambda: draw(draw.arrays, draws)
    else:
        it = ds.iterate_batches(batch_size, seed=args.seed)
        next_batch = lambda: {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}

    mngr = CheckpointManager(args.results_folder)
    if args.resume and mngr.latest_milestone() is not None:
        state = mngr.load(template=state)
        print(f"resumed from step {state.step}")
    start = step_no = last_saved = last_logged = state.step
    loss_f = float("nan")
    paused = 0.0  # seconds spent in milestone saves, not training
    first_seconds = None  # the run's first step, cuDNN's plan choice included
    sync()
    t_loop = time.perf_counter()
    while step_no < args.train_num_steps:
        _, loss = step(state, next_batch())
        step_no += 1
        if first_seconds is None:
            sync()
            first_seconds = time.perf_counter() - t_loop
        milestone = step_no - last_saved >= args.save_and_sample_every
        if not (milestone or step_no - last_logged >= args.log_every
                or step_no >= args.train_num_steps):
            continue
        last_logged = step_no
        loss_f = float(loss)  # the only host read of the loss: at log points
        if not np.isfinite(loss_f):
            raise FloatingPointError(f"non-finite loss at step {step_no}")
        print(f"step {step_no}: loss {loss_f:.6f}", flush=True)
        if milestone:
            t_pause = time.perf_counter()
            mngr.save(step_no, state)
            last_saved = step_no
            paused += time.perf_counter() - t_pause
    sync()
    train_seconds = time.perf_counter() - t_loop - paused
    if step_no > start:
        save_npz(state, os.path.join(args.results_folder, f"persisted_m{step_no}.npz"),
                 ema_only=True, dtype="bfloat16")
    steps = step_no - start
    record = {
        "start_step": start, "step": step_no, "loss": loss_f, "batch_size": batch_size,
        "train_seconds": train_seconds,
        "samples_per_s": steps * batch_size / train_seconds if steps else None,
        "first_step_seconds": first_seconds,
        "steady_ms_per_step": 1e3 * (train_seconds - first_seconds) / (steps - 1)
        if steps > 1 else None,
        "data_seconds": data_seconds, "remat": args.remat, "device_data": args.device_data,
        "device": str(dev),
    }
    with open(os.path.join(args.results_folder, "train_records.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return state


if __name__ == "__main__":
    main()
