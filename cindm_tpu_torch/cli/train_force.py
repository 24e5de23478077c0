"""train_force: ForceUnet lift/drag surrogate training, PyTorch port.

Port of ``cindm_tpu/cli/train_force.py`` with the same flags, plus
``--device`` (default ``cuda``). The surrogate maps [pressure, mask, offx,
offy] on the padded 64 x 64 grid to the polygon's pressure force (drag,
lift), trained on every recorded frame of BDIM simulations that the port's
solver runs on the device:

    python -m cindm_tpu_torch.cli.train_force --n_sims 64 --train_num_steps 8000 \\
        --data_cache ./dataset/airfoil_64 --results_folder ./results/force_torch

The (frame -> force) pairs are gathered per batch from the simulation
arrays, and the batch indices come from ``np.random.default_rng(seed)``, so
a batch is the JAX package's batch. MSE loss; Adam at ``--lr`` with the EMA
updated every step.

Outputs in ``--results_folder``: the milestone ``model-1.pt`` (the JAX CLI
saves milestone 1) and ``persisted_m1.npz`` (EMA weights in bfloat16, the
layout ``design_2d --force_model_path`` of either package reads), and one
line in ``train_records.jsonl`` (steps, last loss, ms a step over the run
and, apart, the first step's seconds and the steady ms a step), also
printed last.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train ForceUnet on BDIM data, PyTorch port")
    p.add_argument("--n_sims", type=int, default=8)
    p.add_argument("--train_num_steps", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--dim_mults", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--results_folder", default="./results/force_surrogate")
    p.add_argument("--is_testdata", type=lambda s: s == "True", default=True)
    p.add_argument("--data_cache", default=None,
                   help="generate_airfoil_sims cache dir shared across CLIs")
    p.add_argument("--x_band", type=float, nargs=2, default=[0.25, 0.45])
    p.add_argument("--y_band", type=float, nargs=2, default=[0.4, 0.6])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def force_batches(data: dict, batch_size: int, seed: int):
    """Endless (x [B, 64, 64, 4] channel-last, forces [B, 2]) numpy batches:
    random (simulation, frame) pairs from ``np.random.default_rng(seed)``,
    gathered from the arrays only when drawn."""
    S, T = data["fields"].shape[:2]
    press = data["fields"][..., 2]  # [S, T, 62, 62]
    aux = np.concatenate([data["mask"][..., None], data["offset"]], axis=-1)  # [S, 62, 62, 3]
    targets = data["forces"][..., 0, :]  # [S, T, 2] (Fx = drag, Fy = lift)
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, S * T, batch_size)
        s, t = idx // T, idx % T
        x = np.concatenate([press[s, t][..., None], aux[s]], axis=-1)
        yield np.pad(x, ((0, 0), (0, 2), (0, 2), (0, 0))), targets[s, t]


def main(argv=None):
    from ..data.airfoil import AirfoilDatasetConfig, generate_airfoil_sims
    from ..models import ForceUnet
    from ..physics.bdim import BDIMConfig
    from ..train import CheckpointManager, TrainConfig, init_train_state, make_train_step_from_loss
    from ..utils.device import resolve_device
    from ..utils.persist import save_npz

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    acfg = AirfoilDatasetConfig(
        time_stamps=40 if args.is_testdata else 100,
        n_warmup=60 if args.is_testdata else 300,
        x_band=tuple(args.x_band), y_band=tuple(args.y_band),
    )
    t0 = time.perf_counter()
    data = generate_airfoil_sims(args.seed, args.n_sims, acfg, BDIMConfig(),
                                 cache_dir=args.data_cache, device=dev)
    data_seconds = time.perf_counter() - t0

    model = ForceUnet(dim=args.dim, dim_mults=tuple(args.dim_mults),
                      generator=torch.Generator().manual_seed(args.seed)).to(dev)
    print(f"Number of parameter: {sum(p.numel() for p in model.parameters())/1e6:.2f}M")

    def loss_fn(model, batch):
        x, y = batch
        return (model(x) - y).square().mean()

    tcfg = TrainConfig(lr=args.lr, ema_update_every=1)
    state = init_train_state(model, tcfg)
    step = make_train_step_from_loss(loss_fn, tcfg)
    mngr = CheckpointManager(args.results_folder)
    batches = force_batches(data, args.batch_size, args.seed)
    loss_f = float("nan")
    first_seconds = None  # the first step, cuDNN's plan choice included
    sync()
    t_loop = time.perf_counter()
    for i in range(args.train_num_steps):
        x, y = next(batches)
        batch = (torch.from_numpy(x).to(dev).permute(0, 3, 1, 2), torch.from_numpy(y).to(dev))
        _, loss = step(state, batch)
        if i == 0:
            sync()
            first_seconds = time.perf_counter() - t_loop
        if i % 10 == 0 or i == args.train_num_steps - 1:
            loss_f = float(loss)
            print(f"step {i}: loss {loss_f:.6f}", flush=True)
    sync()
    train_seconds = time.perf_counter() - t_loop
    mngr.save(1, state)
    save_npz(state, os.path.join(args.results_folder, "persisted_m1.npz"), ema_only=True,
             dtype="bfloat16")
    record = {"step": state.step, "loss": loss_f, "batch_size": args.batch_size,
              "train_seconds": train_seconds,
              "ms_per_step": 1e3 * train_seconds / max(args.train_num_steps, 1),
              "first_step_seconds": first_seconds,
              "steady_ms_per_step": 1e3 * (train_seconds - first_seconds)
              / (args.train_num_steps - 1) if args.train_num_steps > 1 else None,
              "data_seconds": data_seconds, "device": str(dev)}
    with open(os.path.join(args.results_folder, "train_records.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return state


if __name__ == "__main__":
    main()
