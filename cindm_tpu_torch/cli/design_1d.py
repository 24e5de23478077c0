"""design_1d: compositional guided inverse design (the flagship), PyTorch port.

Port of ``cindm_tpu/cli/design_1d.py`` with the same flags and the same final
JSON line, plus ``--device`` (default ``cuda``). It loads the EMA weights of a
trained 2-body TemporalUnet1D from a ``persisted_m*.npz`` snapshot under
``--model_path``, runs guided (optionally composed) sampling toward the
target point, re-simulates the designed initial state and reports
design_obj / MAE / RMSE with 95% confidence intervals.

    python -m cindm_tpu_torch.cli.design_1d --model_path results/nbody2_coll \
        --compose_n_bodies 8 --n_composed 2 --batch_size 64

Not supported in this port yet: orbax checkpoint directories (only npz
snapshots are read) and ``--n_devices > 0`` (multi-GPU). ``--host_chunks``
is accepted and has no effect: the sampling loop is eager.
"""

from __future__ import annotations

import argparse
import json

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compositional inverse design (1D), PyTorch port")
    p.add_argument("--dataset", default="nbody-2")
    p.add_argument("--model_path", default="./results/nbody")
    p.add_argument("--milestone", type=int, default=None)
    p.add_argument("--conditioned_steps", type=int, default=0)
    p.add_argument("--rollout_steps", type=int, default=24)
    p.add_argument("--Unet_dim", type=int, default=64)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--sample_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--design_guidance", default="standard-recurrence-10")
    p.add_argument("--design_coef", type=float, default=0.2)
    p.add_argument("--consistency_coef", type=float, default=0.2)
    p.add_argument("--design_fn_mode", default="L2")
    p.add_argument("--normalize_grad_per_body", action="store_true",
                   help="scale the design objective by 2/compose_n_bodies so "
                        "the per-body guidance gradient accumulated across "
                        "overlapping pair windows matches the 2-body tuning")
    p.add_argument("--compose_n_bodies", type=int, default=2)
    p.add_argument("--n_composed", type=int, default=0)
    p.add_argument("--compose_mode", default="mean-inside")
    p.add_argument("--compose_start_step", type=int, default=4)
    p.add_argument("--target", type=float, nargs=2, default=[0.5, 0.5])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fold_chunks", type=int, default=1,
                   help="split the folded (window, pair, batch) axis into "
                        "this many sequential denoiser calls per step")
    p.add_argument("--host_chunks", type=int, default=10,
                   help="accepted for compatibility; no effect (the loop is eager)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="multi-GPU sampling is not ported yet; only 0 is accepted")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def load_model(model_path: str, milestone, horizon: int, transition_dim: int, dim: int,
               device: torch.device):
    """TemporalUnet1D with the EMA weights of the snapshot under ``model_path``."""
    from ..models import TemporalUnet1D, params_from_flax
    from ..utils.persist import find_persisted, load_flax_npz, select_subtree

    path = find_persisted(model_path, milestone)
    if path is None:
        want = "latest" if milestone is None else f"milestone {milestone}"
        raise FileNotFoundError(f"no persisted_m*.npz snapshot ({want}) in {model_path}")
    flat = load_flax_npz(path)
    tree = select_subtree(flat, "ema_params") or select_subtree(flat, "params")
    model = TemporalUnet1D(horizon=horizon, transition_dim=transition_dim, dim=dim, attention=True)
    model.load_state_dict(params_from_flax(tree, model))
    return model.to(device).eval()


def main(argv=None):
    from ..core import make_schedule
    from ..physics import eval_simu
    from ..sampling import (
        Diffusion1DConfig,
        confidence_interval_95,
        get_design_fn,
        get_eval_fn,
        get_eval_fn_per_sample,
        sample,
    )
    from ..sampling.sampler import generator_randn
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.n_devices > 0:
        raise SystemExit("--n_devices > 0: multi-GPU sampling is not ported yet")
    dev = resolve_device(args.device)
    model_n_bodies = int(args.dataset.split("-")[1])
    horizon = args.conditioned_steps + args.rollout_steps
    model = load_model(args.model_path, args.milestone, horizon, model_n_bodies * 4,
                       args.Unet_dim, dev)

    dcfg = Diffusion1DConfig(
        rollout_steps=args.rollout_steps,
        conditioned_steps=args.conditioned_steps,
        timesteps=args.timesteps,
    )
    sched = make_schedule(args.timesteps, device=dev)
    target = torch.tensor(args.target, dtype=torch.float32, device=dev)
    norm_factor = 2.0 / args.compose_n_bodies if args.normalize_grad_per_body else 1.0
    design_fn = get_design_fn(
        target, last_n_step=1, coef=args.design_coef,
        time_consistency_coef=args.consistency_coef, design_fn_mode=args.design_fn_mode,
        norm_factor=norm_factor,
    )
    eval_fn = get_eval_fn(target, last_n_step=1)
    eval_each = get_eval_fn_per_sample(target, last_n_step=1)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    with torch.no_grad():
        out = sample(
            dcfg, sched, model, generator_randn(generator, dev),
            batch_size=args.batch_size, feature_size=args.compose_n_bodies * 4,
            design_fn=design_fn, design_guidance=args.design_guidance,
            n_composed=args.n_composed, compose_start_step=args.compose_start_step,
            compose_n_bodies=args.compose_n_bodies, compose_mode=args.compose_mode,
            sample_steps=args.sample_steps, fold_chunks=args.fold_chunks,
        )
        total_rollout = out.shape[1] - 1
        pred_simu, _ = eval_simu(
            out[:, :1], eval_fn, n_bodies=args.compose_n_bodies, rollout_steps=total_rollout
        )
        per_sample = eval_each(pred_simu)
        record = {
            "design_obj": float(per_sample.mean()),
            "design_obj_ci95": float(confidence_interval_95(per_sample)),
            "MAE": float((out[:, 1:] - pred_simu).abs().mean()),
            "RMSE": float((out[:, 1:] - pred_simu).square().mean().sqrt()),
            "batch_size": args.batch_size,
            "design_guidance": args.design_guidance,
            "n_composed": args.n_composed,
            "compose_n_bodies": args.compose_n_bodies,
            "normalize_grad_per_body": bool(args.normalize_grad_per_body),
        }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
