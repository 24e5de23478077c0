"""train_baseline: FNO / LE-PDE surrogate training, PyTorch port.

Port of ``cindm_tpu/cli/train_baseline.py`` with the same flags, plus
``--device`` (default ``cuda``). It trains the one-step evolution
surrogates of the paper's 2D baselines, ``FNO2d`` or ``LEPDE``, on airfoil
flows that the port's BDIM solver simulates on the device, with the weighted
multi-step loss (``--multi_step``, single-step before
``--multi_step_start_epoch``), input noise, the clip + Adam or clip + AdamW
(``--weight_decay``, ``--lr_scheduler_type cos``) optimizer, a held-out
validation split, the save -> reload self-check (``--is_unittest``: the
reloaded model's outputs within 8e-5 of the trained one's) and a hash-named
experiment record:

    python -m cindm_tpu_torch.cli.train_baseline --algo fno --n_sims 64 \\
        --epochs 50 --steps_per_epoch 200 --batch_size 32 --results_folder ./results/fno

Batches come from numpy with ``np.random.default_rng(seed)``, so they are
the JAX package's batches. Milestones are ``model-<epoch>.pt`` (the port's
``CheckpointManager``), which ``design_2d_baseline --surrogate_path`` loads.
Departures: the input noise comes from a ``torch.Generator``; ``--n_devices
> 0`` raises (multi-GPU is not ported).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

UNITTEST_TOL = 8e-5  # save -> reload: max |output difference|


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train FNO/LE-PDE surrogates, PyTorch port")
    p.add_argument("--algo", default="fno", help="fno | lepde (reference: fno-m20-w32, contrastive)")
    p.add_argument("--dataset", default="naca_ellipse_lepde")
    p.add_argument("--n_sims", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--latent_size", type=int, default=160)
    p.add_argument("--fno_modes", type=int, default=12)
    p.add_argument("--fno_width", type=int, default=32)
    p.add_argument("--multi_step", default="1",
                   help="weighted multi-step loss spec: '1^2:1e-2^4:1e-3' rolls the "
                        "surrogate to step 4 and weights losses at steps 1/2/4; a bare "
                        "int trains single/uniform")
    p.add_argument("--multi_step_start_epoch", type=int, default=0,
                   help="epochs before this use the single-step loss")
    p.add_argument("--loss_type", default="mse", choices=["mse", "l1", "huber"])
    p.add_argument("--data_noise_amp", type=float, default=0.0,
                   help="gaussian noise added to the input state during training")
    p.add_argument("--lr_scheduler_type", default="none", choices=["none", "cos"],
                   help="'cos' = cosine decay over the full run")
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="adamw decoupled weight decay")
    p.add_argument("--val_fraction", type=float, default=0.1,
                   help="held-out window fraction; per-epoch val loss goes into the record")
    p.add_argument("--results_folder", default="./results/baseline")
    p.add_argument("--is_unittest", type=lambda s: s == "True", default=True)
    p.add_argument("--data_cache", default=None,
                   help="generate_airfoil_sims cache dir shared across CLIs")
    p.add_argument("--x_band", type=float, nargs=2, default=[0.25, 0.45])
    p.add_argument("--y_band", type=float, nargs=2, default=[0.4, 0.6])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--is_testdata", type=lambda s: s == "True", default=True)
    p.add_argument("--n_devices", type=int, default=0,
                   help="multi-GPU training is not ported yet; only 0 is accepted")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def build_surrogate(algo: str, generator: torch.Generator, fno_modes: int = 12, fno_width: int = 32,
                    latent_size: int = 160) -> torch.nn.Module:
    """FNO2d over [state 3 | static 3] channels, or LEPDE."""
    from ..baselines import FNO2d, LEPDE, LEPDEConfig

    if algo.startswith("fno"):
        return FNO2d(6, 3, modes=fno_modes, width=fno_width, generator=generator)
    if algo.startswith("lepde") or algo.startswith("contrastive"):
        return LEPDE(LEPDEConfig(latent_size=latent_size), out_hw=64, generator=generator)
    raise ValueError(algo)


def main(argv=None):
    from ..baselines.harness import experiment_record, multi_step_loss, parse_multi_step
    from ..baselines.lepde import lepde_loss
    from ..data.airfoil import AirfoilDataset, AirfoilDatasetConfig, generate_airfoil_sims
    from ..physics.bdim import BDIMConfig
    from ..train import (CheckpointManager, TrainConfig, cosine_decay_schedule, init_train_state,
                         make_train_step_from_loss)
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.n_devices > 0:
        raise SystemExit("--n_devices > 0: multi-GPU training is not ported yet (roadmap slice 7)")
    dev = resolve_device(args.device)
    ms_dict = parse_multi_step(args.multi_step)
    acfg = AirfoilDatasetConfig(
        input_steps=1, output_steps=max(ms_dict), time_interval=1,
        time_stamps=40 if args.is_testdata else 100,
        n_warmup=60 if args.is_testdata else 300,
        x_band=tuple(args.x_band), y_band=tuple(args.y_band),
    )
    data = generate_airfoil_sims(args.seed, args.n_sims, acfg, BDIMConfig(),
                                 cache_dir=args.data_cache, device=dev)
    ds = AirfoilDataset(data, acfg)
    K = acfg.output_steps

    def make_batch(indices):
        """u_t [B, 3, 64, 64], static [B, 3, 64, 64], targets [B, K, 3, 64, 64]."""
        b = {k: torch.from_numpy(v).to(dev) for k, v in ds.get_batch(indices).items()}
        x = b["x"].permute(0, 3, 1, 2)  # [pred frames * 3 | mask, offx, offy]
        targets = x[:, :3 * K].reshape(x.shape[0], K, 3, 64, 64)
        return b["cond"][..., :3].permute(0, 3, 1, 2), x[:, 3 * K:], targets

    noise_gen = torch.Generator(device=dev).manual_seed(args.seed)

    def noised(u):
        if args.data_noise_amp <= 0:
            return u
        return u + args.data_noise_amp * torch.randn(u.shape, generator=noise_gen, device=dev)

    surrogate = lambda seed: build_surrogate(args.algo, torch.Generator().manual_seed(seed),
                                             args.fno_modes, args.fno_width, args.latent_size)
    model = surrogate(args.seed).to(dev)
    fno = args.algo.startswith("fno")

    def make_loss(ms, noise):
        def loss_fn(model, batch):
            u, static, targets = batch
            if noise:
                u = noised(u)
            if fno:  # autoregressive stepper, weighted at the listed steps
                step = lambda cur: model(torch.cat([cur, static], dim=1))
                return multi_step_loss(step, u, targets, ms, args.loss_type)
            return lepde_loss(model, u, static, targets, multi_step_dict=ms,
                              loss_type=args.loss_type)

        return loss_fn

    print(f"Number of parameter: {sum(p.numel() for p in model.parameters())/1e6:.2f}M")
    tcfg = TrainConfig(lr=args.lr, ema_update_every=1)
    opt_kw = {}
    if args.weight_decay > 0 or args.lr_scheduler_type != "none":
        total = max(args.epochs * args.steps_per_epoch, 1)
        opt_kw = {"weight_decay": args.weight_decay,
                  "schedule": (cosine_decay_schedule(args.lr, total) if args.lr_scheduler_type == "cos"
                               else (lambda count: args.lr))}
    state = init_train_state(model, tcfg, **opt_kw)
    step = make_train_step_from_loss(make_loss(ms_dict, noise=True), tcfg)
    step_single = (make_train_step_from_loss(make_loss({1: 1.0}, noise=True), tcfg)
                   if args.multi_step_start_epoch > 0 else step)
    val_loss_fn = make_loss(ms_dict, noise=False)
    mngr = CheckpointManager(args.results_folder)

    # held-out validation windows: the last val_fraction of them
    n_val = int(len(ds) * args.val_fraction)
    val_idx = np.arange(len(ds) - n_val, len(ds)) if n_val else None
    n_train = len(ds) - n_val

    def eval_val():
        if val_idx is None:
            return None
        with torch.no_grad():
            return float(val_loss_fn(state.model, make_batch(val_idx[:64])))

    history = []
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        use = step_single if epoch < args.multi_step_start_epoch else step
        ep_losses = []
        for i in range(args.steps_per_epoch):
            _, loss = use(state, make_batch(rng.integers(0, n_train, args.batch_size)))
            ep_losses.append(float(loss))
            print(f"epoch {epoch} step {i}: loss {ep_losses[-1]:.6f}")
        vl = eval_val()
        history.append({"epoch": epoch, "train_loss": float(np.mean(ep_losses)), "val_loss": vl})
        if vl is not None:
            print(f"epoch {epoch}: val_loss {vl:.6f}")
        mngr.save(epoch + 1, state)

    if args.is_unittest:
        # save -> reload self-check, into a freshly built model
        restored = mngr.load(args.epochs,
                             template=init_train_state(surrogate(args.seed + 1).to(dev), tcfg, **opt_kw))
        u, static, _ = make_batch(rng.integers(0, len(ds), 2))
        with torch.no_grad():
            if fno:
                a = state.model(torch.cat([u, static], dim=1))
                bb = restored.model(torch.cat([u, static], dim=1))
            else:
                a, bb = state.model(u, static, 1), restored.model(u, static, 1)
        maxdiff = float((a - bb).abs().max())
        if not maxdiff < UNITTEST_TOL:
            raise AssertionError(f"unittest_model failed: {maxdiff}")
        print(f"unittest_model passed (max diff {maxdiff:.2e})")

    rec_path = experiment_record(
        args.results_folder, vars(args), history,
        final={"val_loss": history[-1]["val_loss"] if history else None,
               "train_loss": history[-1]["train_loss"] if history else None},
    )
    print(f"experiment record -> {rec_path}")
    return state


if __name__ == "__main__":
    main()
