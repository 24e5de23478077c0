"""train_1d: n-body trajectory diffusion training, PyTorch port.

Port of ``cindm_tpu/cli/train_1d.py`` with the same flags, plus ``--device``
(default ``cuda``). It trains the 2-body TemporalUnet1D prior that every
design run composes:

    python -m cindm_tpu_torch.cli.train_1d --batch_size 512 \\
        --gradient_accumulate_every 1 --Unet_dim 64 --n_sims 6000 \\
        --test_sims 100 --collision_frac 0.3 --train_num_steps 200000 \\
        --save_and_sample_every 5000 --results_folder ./results/nbody2_coll_torch

Trajectories are simulated on the device by the port's simulator and cached
as ``<dataset_path>/nbody-<n>/traj_<n_sims>.npy`` (the JAX package's cache
name and layout: either package reads the other's cache). The denoiser's
forward runs through the CUDA kernels and its gradient through their
autograd Functions (``ops.FusedRTB``, ``ops.FusedConv1dGNMish``).

Outputs in ``--results_folder``: milestones ``model-<step>.pt`` at optimizer
steps (``--resume True`` continues from the newest, or from the newest
``persisted_m*.npz`` when there is none), ``loss_curve.npy`` and
``eval_records.jsonl`` as in the JAX package, and two the JAX CLI does not
write: ``persisted_m<step>.npz`` at the end of a run (EMA weights in
bfloat16, the layout ``design_1d`` of either package reads) and one line per
run in ``train_records.jsonl`` (steps, last loss, training samples/s, data
seconds), which is also printed last.

Every ``--method_type`` of the JAX CLI is ported: ``Diffusion`` (the prior),
``forward_model`` (``Unet1DForwardModel`` over the whole window, L1 against
it), ``Unet_rollout_one`` (a horizon-2 forward model trained through its own
rollout), and the GNS family ``GNS`` (a real 4-frame history),
``GNS_cond_one`` (one (pos, vel) frame) and ``GNS_direct`` (every
acceleration from one call). The forward models' Conv1dBlocks run the
Conv1d+GN+Mish kernel through ``ops.FusedConv1dGNMish``; GNS is plain
PyTorch. The periodic eval (``--eval_every``) samples the Diffusion prior
only, as in the JAX CLI.

Multi-GPU (``--n_devices``) comes with the multi-GPU slice. The JAX CLI's TPU
heartbeat thread and XLA compile cache have no counterpart here, and
``--steps_per_launch`` (several micro-steps in one TPU launch) is accepted
but has no effect.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

METHOD_TYPES = [
    "Diffusion",
    "forward_model",
    "Unet_rollout_one",
    "GNS",
    "GNS_cond_one",
    "GNS_direct",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train n-body models, PyTorch port")
    p.add_argument("--dataset", default="nbody-2")
    p.add_argument("--n_bodies", type=int, default=2)
    p.add_argument("--conditioned_steps", type=int, default=0)
    p.add_argument("--rollout_steps", type=int, default=24)
    p.add_argument("--time_interval", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--Unet_dim", type=int, default=64)
    p.add_argument("--method_type", default="Diffusion", choices=METHOD_TYPES)
    p.add_argument("--train_num_steps", type=int, default=6)
    p.add_argument("--save_and_sample_every", type=int, default=2)
    p.add_argument("--loss_weight_discount", type=float, default=0.95)
    p.add_argument("--beta_schedule", default="cosine")
    p.add_argument("--loss_type", default="l1")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--n_sims", type=int, default=64, help="simulations to generate")
    p.add_argument("--test_sims", type=int, default=0,
                   help="held-out sims (the last ones) for the periodic eval")
    p.add_argument("--dataset_path", default="./dataset/nbody_dataset")
    p.add_argument("--results_folder", default="./results/nbody")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4, help="Adam learning rate")
    p.add_argument("--gradient_accumulate_every", type=int, default=2)
    p.add_argument("--collision_frac", type=float, default=0.0,
                   help="fraction of each batch drawn from collision-rich windows")
    p.add_argument("--gns_noise_std", type=float, default=6.7e-7,
                   help="random-walk training noise of the GNS baselines")
    p.add_argument("--steps_per_launch", type=int, default=1,
                   help="accepted for the JAX CLI's scripts and has no effect: "
                        "the port's host loop runs one micro-step per call")
    p.add_argument("--n_devices", type=int, default=0,
                   help="multi-GPU training is not ported yet; only 0 is accepted")
    p.add_argument("--eval_every", type=int, default=0,
                   help="run the EMA-sampling eval every this many optimizer steps (0 = off)")
    p.add_argument("--eval_batch", type=int, default=64)
    p.add_argument("--eval_sample_steps", type=int, default=250)
    p.add_argument("--log_every", type=int, default=50,
                   help="loss print / NaN-check interval in optimizer steps")
    p.add_argument("--is_testdata", type=lambda s: s == "True", default=True)
    p.add_argument("--resume", type=lambda s: s == "True", default=False,
                   help="resume from the latest milestone in results_folder")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def build_model_and_loss(args, n_bodies: int, horizon: int, generator: torch.Generator):
    """(model, loss_fn(model, batch)) of ``args.method_type``; loss_fn is
    None for Diffusion, whose step ``make_train_step`` builds. Weights are
    drawn from a CPU generator seeded with ``args.seed``; the losses' draws
    (the forward model's input noise, the GNS history noise) come from
    ``generator``. A batch may carry the draw as ``batch['noise']``."""
    feat = n_bodies * 4
    init = torch.Generator().manual_seed(args.seed)
    mt = args.method_type
    if mt == "Diffusion":
        from ..models import TemporalUnet1D

        return TemporalUnet1D(horizon=horizon, transition_dim=feat, dim=args.Unet_dim,
                              attention=True, generator=init), None
    if mt == "forward_model":
        from ..baselines import Unet1DForwardModel

        model = Unet1DForwardModel(horizon=horizon, transition_dim=feat, dim=args.Unet_dim,
                                   generator=init)

        def loss_fn(model, batch):
            # pred = model(first frame, noise), L1 against the whole window
            x = batch["x"]
            noise = batch.get("noise")
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, device=x.device)
            return (model(x[:, :1], noise) - x).abs().mean()

        return model, loss_fn
    if mt == "Unet_rollout_one":
        from ..baselines import Unet1DForwardModel

        # horizon 1 + 1, trained through its own autoregressive rollout
        model = Unet1DForwardModel(horizon=2, transition_dim=feat, dim=args.Unet_dim,
                                   generator=init)

        def loss_fn(model, batch):
            x = batch["x"]
            c, preds = x[:, :1], []
            for _ in range(x.shape[1] - 1):
                c = model(c)[:, -1:]
                preds.append(c)
            return (torch.cat(preds, dim=1) - x[:, 1:]).abs().mean()

        return model, loss_fn
    from ..baselines import GNSConfig, GNSNet, make_gns_loss

    if mt == "GNS":
        gcfg, mode = GNSConfig(n_his=4, out_size=2), "autoregress"
    elif mt == "GNS_cond_one":
        gcfg, mode = GNSConfig(n_his=2, out_size=2), "cond_one"
    elif mt == "GNS_direct":  # every rollout acceleration from one call
        gcfg, mode = GNSConfig(n_his=2, out_size=2 * (horizon - 1)), "direct"
    else:
        raise ValueError(mt)
    return GNSNet(gcfg, generator=init), make_gns_loss(
        gcfg, n_bodies, mode, time_interval=args.time_interval, noise_std=args.gns_noise_std,
        generator=generator)


def main(argv=None):
    from ..core import make_schedule
    from ..data.nbody import NBodyDataset, NBodyDatasetConfig
    from ..sampling import Diffusion1DConfig
    from ..sampling.sampler import generator_randn
    from ..train import (
        CheckpointManager,
        TrainConfig,
        init_train_state,
        make_train_step,
        make_train_step_from_loss,
        sampling_eval_1d,
    )
    from ..utils.device import resolve_device
    from ..utils.persist import save_npz

    args = build_parser().parse_args(argv)
    if args.n_devices > 0:
        raise SystemExit("--n_devices > 0: multi-GPU training is not ported yet (roadmap slice 7)")
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n_bodies = int(args.dataset.split("-")[1]) if "-" in args.dataset else args.n_bodies
    accum = max(args.gradient_accumulate_every, 1)

    dcfg_data = NBodyDatasetConfig(
        n_bodies=n_bodies,
        input_steps=args.conditioned_steps,
        output_steps=args.rollout_steps,
        time_interval=args.time_interval,
    )
    t0 = time.perf_counter()
    ds = NBodyDataset(
        dcfg_data, n_sims=args.n_sims, seed=args.seed, device=dev,
        cache_path=os.path.join(args.dataset_path, f"nbody-{n_bodies}", f"traj_{args.n_sims}.npy"),
    )
    data_seconds = time.perf_counter() - t0
    ds_test = None
    if args.test_sims > 0:
        # split by simulation: the last test_sims are held out
        ds_test = NBodyDataset(dcfg_data, data=ds.data[-args.test_sims:])
        ds = NBodyDataset(dcfg_data, data=ds.data[: -args.test_sims])

    horizon = args.conditioned_steps + args.rollout_steps
    sched = make_schedule(args.timesteps, args.beta_schedule, device=dev)
    dcfg = Diffusion1DConfig(
        rollout_steps=args.rollout_steps,
        conditioned_steps=args.conditioned_steps,
        timesteps=args.timesteps,
        loss_type=args.loss_type,
        beta_schedule=args.beta_schedule,
        loss_weight_discount=args.loss_weight_discount,
    )
    tcfg = TrainConfig(lr=args.lr, gradient_accumulate_every=args.gradient_accumulate_every)
    draws = torch.Generator(device=dev).manual_seed(args.seed)
    model, loss_fn = build_model_and_loss(args, n_bodies, horizon, draws)
    model = model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of parameter: {n_params/1e6:.2f}M")

    state = init_train_state(model, tcfg)
    mngr = CheckpointManager(args.results_folder)
    if args.resume and mngr.latest_milestone() is not None:
        state = mngr.load(template=state)
        print(f"resumed from step {state.step} (milestone {mngr.latest_milestone()})")
    if loss_fn is None:
        step = make_train_step(dcfg, sched, tcfg, generator=draws)
    else:
        step = make_train_step_from_loss(loss_fn, tcfg)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def run_eval(opt_step):
        eb = ds_test.get_batch(np.arange(min(args.eval_batch, len(ds_test))))
        g = torch.Generator(device=dev).manual_seed(args.seed + 10_000 + opt_step)
        rec = sampling_eval_1d(dcfg, sched, state.ema, to_device(eb), generator_randn(g, dev),
                               sample_steps=args.eval_sample_steps)
        rec["step"] = opt_step
        with open(os.path.join(args.results_folder, "eval_records.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"eval @ {opt_step}: {rec}")

    it = ds.iterate_batches(args.batch_size, seed=args.seed, collision_frac=args.collision_frac)

    loss_hist: list[tuple[int, float]] = []
    micro = 0
    start_step = state.step
    opt_step = last_saved = last_logged = last_evaled = start_step
    loss_f = float("nan")
    paused = 0.0  # seconds spent in milestone saves and evals, not training
    sync()
    t_loop = time.perf_counter()
    # the optimizer applies an update every `accum`-th micro-batch, so the
    # step is known on the host: the loss is read back only at log points
    while opt_step < args.train_num_steps:
        _, loss = step(state, to_device(next(it)))
        micro += 1
        if micro % accum:
            continue  # accumulation micro-batch, no optimizer update
        opt_step = start_step + micro // accum
        milestone = (opt_step - last_saved >= args.save_and_sample_every
                     and opt_step != last_saved)
        log = (opt_step - last_logged >= args.log_every or milestone
               or opt_step >= args.train_num_steps)
        if not log:
            continue
        last_logged = opt_step
        loss_f = float(loss)
        if not np.isfinite(loss_f):
            # NaN guard: stop before poisoning checkpoints
            raise FloatingPointError(f"non-finite loss at step {opt_step}: {loss_f}")
        loss_hist.append((opt_step, loss_f))
        t_pause = time.perf_counter()
        if milestone:
            # milestone id = global optimizer step: monotonic across resumed runs
            mngr.save(opt_step, state)
            last_saved = opt_step
            np.save(os.path.join(args.results_folder, "loss_curve.npy"),
                    np.asarray(loss_hist, dtype=np.float64))
            print(f"step {opt_step}: loss {loss_f:.6f} (saved milestone {opt_step})", flush=True)
        else:
            print(f"step {opt_step}: loss {loss_f:.6f}", flush=True)
        if (ds_test is not None and args.method_type == "Diffusion" and args.eval_every > 0
                and opt_step - last_evaled >= args.eval_every):
            last_evaled = opt_step
            run_eval(opt_step)
        sync()
        paused += time.perf_counter() - t_pause
    sync()
    train_seconds = time.perf_counter() - t_loop - paused
    if opt_step > start_step:
        save_npz(state, os.path.join(args.results_folder, f"persisted_m{opt_step}.npz"),
                 ema_only=True, dtype="bfloat16")
    record = {
        "start_step": start_step, "step": opt_step, "loss": loss_f, "micro_steps": micro,
        "batch_size": args.batch_size, "train_seconds": train_seconds,
        "samples_per_s": micro * args.batch_size / train_seconds if micro else None,
        "data_seconds": data_seconds, "device": str(dev),
    }
    with open(os.path.join(args.results_folder, "train_records.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return state


if __name__ == "__main__":
    main()
