"""design_1d_baseline: CEM and backprop design over forward surrogates, PyTorch port.

Port of ``cindm_tpu/cli/design_1d_baseline.py`` with the same flags and the
same final JSON line, plus ``--device`` (default ``cuda``):
``--design_method`` backprop or CEM over ``--method_type`` Unet (one
``Unet1DForwardModel`` call for the whole rollout), Unet_single_step (a
horizon-2 model chained ``--rollout_steps`` times), GNS_direct or
GNS_autoregress (``GNSNet`` on a 2-frame history back-extrapolated from the
designed (pos, vel) frame). The designed initial state is scored by
re-simulation.

    python -m cindm_tpu_torch.cli.design_1d_baseline --design_method CEM \\
        --method_type Unet --model_path results/nbody_forward --N 1000 --Ne 100

Weights are the EMA weights that ``cindm_tpu_torch.cli.train_1d`` writes for
the matching ``--method_type`` (forward_model, Unet_rollout_one,
GNS_direct, GNS_cond_one): its newest milestone ``model-<k>.pt``, or else its
newest ``persisted_m*.npz`` snapshot, which may come from either package. A
``--model_path`` without either raises unless ``--allow_random_init True``.
The JAX CLI's orbax checkpoints are not read.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Baseline inverse design (1D), PyTorch port")
    p.add_argument("--design_method", default="backprop", choices=["backprop", "CEM"])
    p.add_argument("--method_type", default="Unet",
                   choices=["Unet", "Unet_single_step", "GNS_direct", "GNS_autoregress"])
    p.add_argument("--model_path", default="./results/nbody_forward")
    p.add_argument("--milestone", type=int, default=None)
    p.add_argument("--n_bodies", type=int, default=2)
    p.add_argument("--rollout_steps", type=int, default=23)
    p.add_argument("--Unet_dim", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_design_steps", type=int, default=100)
    p.add_argument("--N", type=int, default=1000, help="CEM population")
    p.add_argument("--Ne", type=int, default=100, help="CEM elites")
    p.add_argument("--coef", type=float, default=1.0, help="design coef")
    p.add_argument("--coef_max_noise", type=float, default=0.0)
    p.add_argument("--target", type=float, nargs=2, default=[0.5, 0.5])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--allow_random_init", type=lambda s: s == "True", default=False,
                   help="proceed with random weights when no checkpoint exists "
                        "(off by default: a mistyped --model_path must fail loudly)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def load_ema(args, model: torch.nn.Module):
    """(model with the EMA weights under --model_path, loaded milestone).
    The weights of step --milestone, or else of the newest step, from a
    milestone file model-<k>.pt or a persisted_m<k>.npz (train_1d writes the
    latter at the end of a run). Raises FileNotFoundError when there is
    none, unless --allow_random_init True."""
    from ..models import params_from_flax
    from ..train import CheckpointManager
    from ..utils.persist import _PERSIST_RE, find_persisted, load_flax_npz, select_subtree

    path, want = args.model_path, args.milestone
    if os.path.isdir(path):
        have = CheckpointManager(path).all_milestones()
        npz = find_persisted(path, want)
        npz_step = int(_PERSIST_RE.search(npz).group(1)) if npz else None
        pt_step = want if want in have else (None if want is not None or not have else have[-1])
        if pt_step is not None and (npz_step is None or pt_step >= npz_step):
            model.load_state_dict(CheckpointManager(path).load(pt_step)["ema_params"])
            return model, pt_step
        if npz is not None:
            flat = load_flax_npz(npz)
            tree = select_subtree(flat, "ema_params") or select_subtree(flat, "params")
            model.load_state_dict(params_from_flax(tree, model))
            return model, npz_step
    if not args.allow_random_init:
        raise FileNotFoundError(
            f"no checkpoint under {path!r} (milestone={want}); pass "
            "--allow_random_init True to run with random weights anyway")
    print("warning: no checkpoint found, using random init")
    return model, None


def make_rollout(args, dev: torch.device):
    """(rollout_fn(cond [N, 1, F]) -> predicted trajectory [N, steps, F],
    loaded milestone); "Unet" returns its whole horizon, the first frame
    included, as the JAX CLI does (the objective reads the last frame)."""
    from ..baselines import GNSConfig, GNSNet, Unet1DForwardModel, gns_direct_rollout, gns_rollout

    feat = args.n_bodies * 4
    init = torch.Generator().manual_seed(args.seed)
    if args.method_type in ("Unet", "Unet_single_step"):
        horizon = 1 + args.rollout_steps if args.method_type == "Unet" else 2
        model = Unet1DForwardModel(horizon=horizon, transition_dim=feat, dim=args.Unet_dim,
                                   generator=init)
        model, milestone = load_ema(args, model)
        model = model.to(dev).eval().requires_grad_(False)
        if args.method_type == "Unet":
            return (lambda cond: model(cond.reshape(-1, 1, feat))), milestone

        def rollout(cond):
            c, out = cond.reshape(-1, 1, feat), []
            for _ in range(args.rollout_steps):
                c = model(c)[:, -1:]
                out.append(c)
            return torch.cat(out, dim=1)

        return rollout, milestone

    # Net_cond_one semantics: one (pos, vel) frame, a 2-frame history
    gcfg = GNSConfig(n_his=2, out_size=2 if args.method_type == "GNS_autoregress"
                     else 2 * args.rollout_steps)
    model, milestone = load_ema(args, GNSNet(gcfg, generator=init))
    model = model.to(dev).eval().requires_grad_(False)
    integrate = gns_direct_rollout if args.method_type == "GNS_direct" else gns_rollout

    def rollout(cond):
        c = cond.reshape(-1, args.n_bodies, 4)
        pos, vel = c[..., :2], c[..., 2:] * (4.0 / 60.0)
        hist = torch.stack([pos - k * vel for k in range(gcfg.n_his - 1, -1, -1)], dim=2)
        ptype = torch.zeros(hist.shape[:2], dtype=torch.long, device=hist.device)
        traj = integrate(model, hist, ptype, args.rollout_steps)  # [N, n, T, 2]
        # velocities from the position differences, back in units / 200
        vel_out = torch.cat([traj[:, :, :1] - hist[:, :, -1:], traj.diff(dim=2)], dim=2)
        out = torch.cat([traj, vel_out * (60.0 / 4.0)], dim=-1)
        return out.permute(0, 2, 1, 3).reshape(c.shape[0], args.rollout_steps, feat)

    return rollout, milestone


def main(argv=None, timings: Optional[dict] = None):
    """Run the design and return the record. ``timings``, when given, is
    filled with the seconds of each part, the card synchronized first:
    ``load`` (the surrogate built and its weights read), ``design`` (the
    CEM or backprop loop alone) and ``eval`` (re-simulation)."""
    from ..baselines import BackpropConfig, CEMConfig, backprop_design, cem_design
    from ..physics import eval_simu
    from ..sampling import get_design_fn, get_eval_fn
    from ..sampling.sampler import generator_randn
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    timings = {} if timings is None else timings
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    clock = [time.perf_counter()]

    def lap(name):
        sync()
        now = time.perf_counter()
        timings[name] = now - clock[0]
        clock[0] = now

    feat = args.n_bodies * 4
    rollout_fn, loaded_milestone = make_rollout(args, dev)
    target = torch.tensor(args.target, dtype=torch.float32, device=dev)
    design_fn = get_design_fn(target, last_n_step=1, coef=args.coef)
    eval_fn = get_eval_fn(target, last_n_step=1)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    randn = generator_randn(generator, dev)

    cond_shape = (args.batch_size, 1, feat)
    lap("load")
    if args.design_method == "CEM":
        ccfg = CEMConfig(n_samples=args.N, n_elites=args.Ne, n_iterations=args.max_design_steps)
        best, _ = cem_design(ccfg, rollout_fn, design_fn, (1, feat), randn)
        cond_design = best[None].expand(cond_shape)
    else:
        bcfg = BackpropConfig(n_iterations=args.max_design_steps,
                              coef_max_noise=args.coef_max_noise)
        cond0 = 0.1 + 0.8 * torch.rand(cond_shape, generator=generator, device=dev)
        cond_design, _ = backprop_design(bcfg, rollout_fn, design_fn, cond0, randn)
    lap("design")

    with torch.no_grad():
        _, design_obj = eval_simu(cond_design, eval_fn, n_bodies=args.n_bodies,
                                  rollout_steps=args.rollout_steps)
    lap("eval")
    record = {
        "design_method": args.design_method,
        "method_type": args.method_type,
        "design_obj_simu": float(design_obj),
        "loaded_milestone": loaded_milestone,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
