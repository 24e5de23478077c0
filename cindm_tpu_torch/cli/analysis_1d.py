"""analysis_1d: model-quality analysis of a trained n-body prior, PyTorch port.

Port of ``cindm_tpu/cli/analysis_1d.py`` with the same flags and the same
final JSON record, plus ``--device`` (default ``cuda``). Given a trained
TemporalUnet1D it reports:

- the DDIM-sampled trajectories' MAE/RMSE against ground truth;
- with ``--n_composed > 0`` and a conditioned prior, ``compose_strategies``:
  the parallel chained windows (``EBMs_compose``), sequential windows
  (``autoregress``), the simulator itself (``SimuSolver``) and, with
  ``--direct_model_path``, one model trained at the long horizon
  (``direct``), each scored on one long ground-truth window;
- with ``--compose_multibodies N > 2``, ``multibody_strategies``: the
  pairwise composition of the 2-body prior (``pairwise_compose``), the
  classifier-free composition with a 1-body prior sampled by ULA and UHMC
  (``cf_compose_ULA``, ``cf_compose_UHMC``, with ``--uncond_model_path``)
  and ``SimuSolver``, on an N-body forecast.

    python -m cindm_tpu_torch.cli.analysis_1d --model_path results/nbody2 \\
        --compose_multibodies 8 --uncond_model_path results/nbody1 \\
        --batch_size 16 --n_sims 16 --cf_coefficient 1.4 --langevin_steps 10

Every prior (``--model_path``, ``--direct_model_path``,
``--uncond_model_path``) is read from its newest ``persisted_m*.npz``
snapshot (``--milestone`` picks the main one's), written by either
package; the JAX CLI's orbax checkpoints are not read. Every denoiser
forward runs the fused-RTB and Conv1d+GN+Mish kernels on CUDA. Datasets are
simulated on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="1D analysis, PyTorch port")
    p.add_argument("--dataset", default="nbody-2")
    p.add_argument("--model_path", default="./results/nbody")
    p.add_argument("--milestone", type=int, default=None)
    p.add_argument("--conditioned_steps", type=int, default=0)
    p.add_argument("--rollout_steps", type=int, default=24)
    p.add_argument("--Unet_dim", type=int, default=64)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--sample_steps", type=int, default=250)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_sims", type=int, default=8)
    p.add_argument("--n_composed", type=int, default=0,
                   help=">0 also compares time-composition strategies")
    p.add_argument("--direct_model_path", default=None,
                   help="snapshot directory of a model trained directly at the long horizon "
                        "cond+(n_composed+1)*rollout; adds the 'direct' strategy")
    p.add_argument("--compose_multibodies", type=int, default=0,
                   help="total bodies N > 2: compare multibody composition strategies on "
                        "N-body forecast MAE")
    p.add_argument("--uncond_model_path", default=None,
                   help="snapshot directory of a 1-body (unconditional) model; enables the "
                        "classifier-free compose strategies")
    p.add_argument("--cf_coefficient", type=float, default=1.4,
                   help="classifier-free compose coefficient")
    p.add_argument("--langevin_steps", type=int, default=10,
                   help="ULA steps per reverse step above t_switch (L)")
    p.add_argument("--t_switch", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON record to this path")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def main(argv=None, timings: Optional[dict] = None):
    """Run the analysis and return the record. ``timings``, when given, is
    filled with the seconds each part took (the card synchronized first)."""
    from ..core import make_schedule
    from ..data.nbody import NBodyDataset, NBodyDatasetConfig
    from ..physics.nbody import simulate
    from ..sampling import Diffusion1DConfig, sample
    from ..sampling.compose_time import (
        autoregress_time_compose_sample,
        composing_time_sample,
        make_classifier_free_compose_eps,
        sample_compose_multibodies,
        sample_compose_multibodies_uhmc,
    )
    from ..sampling.sampler import ddim_sample_loop, generator_randn
    from ..train import sampling_eval_1d
    from ..utils.device import resolve_device
    from .design_1d import load_model

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

    def randn(seed):
        return generator_randn(torch.Generator(device=dev).manual_seed(seed), dev)

    n_bodies = int(args.dataset.split("-")[1])
    feat = n_bodies * 4
    cs = args.conditioned_steps
    horizon = cs + args.rollout_steps
    model = load_model(args.model_path, args.milestone, horizon, feat, args.Unet_dim, dev)
    dcfg = Diffusion1DConfig(rollout_steps=args.rollout_steps, conditioned_steps=cs,
                             timesteps=args.timesteps)
    sched = make_schedule(args.timesteps, device=dev)

    def dataset(n, steps, seed=None, data=None):
        cfg = NBodyDatasetConfig(n_bodies=n, input_steps=cs, output_steps=steps)
        if data is not None:
            return NBodyDataset(cfg, data=data)
        return NBodyDataset(cfg, n_sims=args.n_sims, seed=seed, device=dev)

    def batch_of(ds):
        b = ds.get_batch(np.arange(args.batch_size))
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def score(pred, gt):
        err = (pred - gt[:, :pred.shape[1]]).abs()
        return {"mae": float(err.mean()), "rmse": float(err.square().mean().sqrt())}

    ds = dataset(n_bodies, args.rollout_steps, seed=args.seed + 1)
    lap("load")
    with torch.no_grad():
        record = sampling_eval_1d(dcfg, sched, model, batch_of(ds), randn(args.seed),
                                  sample_steps=args.sample_steps)
        lap("sampling_eval")

        if args.n_composed > 0 and cs > 0:
            # every strategy scored on one long window that continues the cond frames
            L = (args.n_composed + 1) * args.rollout_steps
            lb = batch_of(dataset(n_bodies, L, data=ds.data))
            cond, gt = lb["cond"], lb["x"]
            B = gt.shape[0]
            strategies = {}
            img0, stitched = composing_time_sample(
                sched, model, B, args.rollout_steps, cs, feat, cond, randn(args.seed + 1),
                n_composed=args.n_composed, sampling_timesteps=args.sample_steps)
            strategies["EBMs_compose"] = score(torch.cat([img0, stitched], dim=1), gt)
            lap("EBMs_compose")
            auto = autoregress_time_compose_sample(
                sched, model, B, args.rollout_steps, cs, feat, cond, randn(args.seed + 2),
                n_composed=args.n_composed, sampling_timesteps=args.sample_steps)
            strategies["autoregress"] = score(auto, gt)
            lap("autoregress")
            # the ground-truth integrator rolled from the last cond frame
            state = (cond[:, -1] * 200.0).reshape(B, n_bodies, 4)
            traj = simulate(state, L * 4)[:, 3::4]
            strategies["SimuSolver"] = score(traj.reshape(B, L, feat) / 200.0, gt)
            lap("SimuSolver")
            if args.direct_model_path:
                model_d = load_model(args.direct_model_path, None, cs + L, feat, args.Unet_dim,
                                     dev)

                def cond_eps(x, t):
                    return model_d(torch.cat([cond, x], dim=1), t)[:, cs:]

                direct = ddim_sample_loop(sched, cond_eps, (B, L, feat), randn(args.seed + 3),
                                          sampling_timesteps=args.sample_steps)
                strategies["direct"] = score(direct, gt)
                lap("direct")
            record["compose_strategies"] = strategies

        if args.compose_multibodies > 2:
            N = args.compose_multibodies
            nb = batch_of(dataset(N, args.rollout_steps, seed=args.seed + 2))
            gt_n, cond_n = nb["x"], nb.get("cond")
            # with cs > 0 gt_n holds the forecast frames only; with cs == 0 it is
            # the whole window, whose frame 0 is inpainted, so scoring starts at 1
            k_cond = cs if cs > 0 else 1
            fc_start = 0 if cs > 0 else 1
            cond_frames = cond_n if cs > 0 else gt_n[:, :1]

            def score_n(pred_fc):
                L = min(pred_fc.shape[1], gt_n.shape[1] - fc_start)
                return score(pred_fc[:, :L], gt_n[:, fc_start:fc_start + L])

            multi = {}
            pairwise = sample(dcfg, sched, model, randn(args.seed + 5), args.batch_size, N * 4,
                              cond=cond_frames, compose_n_bodies=N, n_composed=0,
                              sample_steps=args.timesteps)
            multi["pairwise_compose"] = score_n(pairwise[:, 1:] if cs == 0 else pairwise)
            lap("pairwise_compose")
            if args.uncond_model_path:
                model_u = load_model(args.uncond_model_path, None, horizon, 4, args.Unet_dim,
                                     dev)
                ceps = make_classifier_free_compose_eps(model, model_u, N,
                                                        coefficient=args.cf_coefficient)
                # cond frames + forecast frames fill the prior's horizon
                fc_steps = horizon - k_cond
                ula = sample_compose_multibodies(
                    sched, ceps, cond_frames, fc_steps, randn(args.seed + 6),
                    langevin_steps=args.langevin_steps, t_switch=args.t_switch,
                    conditioned_steps=k_cond)
                multi["cf_compose_ULA"] = score_n(ula)
                lap("cf_compose_ULA")
                uhmc = sample_compose_multibodies_uhmc(
                    sched, ceps, cond_frames, fc_steps, randn(args.seed + 7),
                    t_switch=args.t_switch, conditioned_steps=k_cond)
                multi["cf_compose_UHMC"] = score_n(uhmc)
                lap("cf_compose_UHMC")
            # the last grounded frame, rolled forward; frame j lines up with
            # gt frame fc_start + j (the eval_simu recording convention)
            state0 = (gt_n[:, 0] if cs == 0 else cond_n[:, -1]) * 200.0
            n_fc = gt_n.shape[1] - fc_start
            traj_n = simulate(state0.reshape(args.batch_size, N, 4), n_fc * 4)[:, 3::4]
            multi["SimuSolver"] = score_n(traj_n.reshape(args.batch_size, n_fc, N * 4) / 200.0)
            lap("multibody_SimuSolver")
            record["multibody_strategies"] = multi

    print(json.dumps(record))
    if args.out:
        import os

        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
