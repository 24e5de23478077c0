"""design_2d_baseline: GD / CEM airfoil design over FNO / LE-PDE surrogates,
PyTorch port.

Port of ``cindm_tpu/cli/design_2d_baseline.py`` with the same flags and the
same final JSON record, plus ``--device`` (default ``cuda``):

- the design starts from dataset samples: the state frame and the boundary
  mask/offset of a window (K > 1 boundaries: K dataset boundaries rolled to
  distinct vertical stations and summed);
- the objective rolls the surrogate ``--rollout`` steps and scores
  lambda * |sum Fx| - sum Fy (the ForceUnet on the unnormalized pressure)
  averaged over the frames, plus out-of-distribution hinges
  relu(|u - mean| - range / 2) on the state and the boundary;
- GD is Adam (optax's defaults: b2 0.999) on the mask and offset tensors;
  CEM is ``baselines.design_opt.cem_design`` over them, flattened;
- the optimized mask is thresholded, reconstructed to polygons and scored
  closed-loop by the batched BDIM solver.

    python -m cindm_tpu_torch.cli.design_2d_baseline --design_method GD --surrogate fno \\
        --surrogate_path ./results/fno --force_model_path ./results/force_torch

The surrogate and the ForceUnet load from the port's milestones or
``persisted_m*.npz`` snapshots (``train.CheckpointManager``): the surrogate's
online weights, the ForceUnet's EMA weights, as the JAX CLI loads them.
Without a path each is seeded from a ``torch.Generator`` (surrogate: seed
``--seed``; ForceUnet: 1). CEM's draws come from a ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="2D baseline design (GD/CEM over surrogates), PyTorch port")
    p.add_argument("--design_method", default="GD", choices=["GD", "CEM"])
    p.add_argument("--surrogate", default="fno", choices=["fno", "lepde"])
    p.add_argument("--surrogate_path", default=None)
    p.add_argument("--force_model_path", default=None)
    p.add_argument("--data_dir", default=None,
                   help="cache dir of generate_airfoil_sims for init states "
                        "and OOD statistics (generated if absent)")
    p.add_argument("--x_band", type=float, nargs=2, default=[0.25, 0.45])
    p.add_argument("--y_band", type=float, nargs=2, default=[0.4, 0.6])
    p.add_argument("--n_sims", type=int, default=4)
    p.add_argument("--num_boundaries", type=int, default=1)
    p.add_argument("--optim_iter", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4, help="Adam lr")
    p.add_argument("--rollout", type=int, default=4)
    p.add_argument("--lambda_force", type=float, default=1.0)
    p.add_argument("--is_bdloss", type=lambda s: s == "True", default=True,
                   help="add the OOD hinge losses")
    p.add_argument("--N", type=int, default=128, help="CEM population")
    p.add_argument("--Ne", type=int, default=16, help="CEM elites")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--evaluate", type=lambda s: s == "True", default=True)
    p.add_argument("--n_warmup", type=int, default=300)
    p.add_argument("--n_record", type=int, default=100)
    p.add_argument("--is_testdata", type=lambda s: s == "True", default=False,
                   help="tiny BDIM datagen for smoke runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose gradient at a tie is 1/2 (a
    dataset mask sits exactly on 0 and 1, where ``torch.clamp`` gives 1)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def main(argv=None, timings: dict | None = None):
    """Run the CLI; ``timings`` (if given) receives the seconds of ``design``
    (the GD or CEM loop) and ``scoring``, each ended by a synchronisation."""
    from ..baselines import CEMConfig, cem_design
    from ..cli.train_baseline import build_surrogate
    from ..data.airfoil import AirfoilDataset, AirfoilDatasetConfig, generate_airfoil_sims
    from ..models import ForceUnet
    from ..sampling.guidance2d import mask_denoise, unnormalize_state
    from ..sampling.sampler import generator_randn
    from ..train import CheckpointManager, TrainConfig, init_train_state
    from ..utils import evaluate_designs, reconstruct_boundary
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    timings = {} if timings is None else timings
    B, K = args.batch_size, args.num_boundaries

    # dataset: init states and OOD statistics
    acfg = AirfoilDatasetConfig(
        input_steps=1, output_steps=1, time_interval=1,
        time_stamps=10 if args.is_testdata else 100,
        n_warmup=20 if args.is_testdata else 300,
        x_band=tuple(args.x_band), y_band=tuple(args.y_band),
    )
    data = generate_airfoil_sims(args.seed + 7, args.n_sims, acfg, cache_dir=args.data_dir, device=dev)
    ds = AirfoilDataset(data, acfg)
    rng = np.random.default_rng(args.seed)
    idx = rng.integers(0, len(ds), B)
    batch = ds.get_batch(idx)
    u0 = torch.from_numpy(batch["cond"][..., :3]).permute(0, 3, 1, 2).contiguous().to(dev)
    pad = ((0, 2), (0, 2), (0, 0))

    def synth_composite(window_ids):
        """Sum K dataset boundaries rolled to distinct vertical stations ->
        (mask [62, 62, 1], offset [62, 62, 2])."""
        m_sum = np.zeros((62, 62, 1), np.float32)
        o_sum = np.zeros((62, 62, 2), np.float32)
        for k, j in enumerate(window_ids):
            w = ds.get_window(int(j))
            m = w["mask"].astype(np.float32)
            o = w["offset"].astype(np.float32)
            if K > 1:
                rows = np.nonzero(m.sum(axis=1))[0]
                centroid = float(rows.mean()) if len(rows) else 31.0
                shift = int(round(62.0 * (k + 1) / (K + 1) - centroid))
                m = np.roll(m, shift, axis=0)
                o = np.roll(o, shift, axis=0)
            m_sum += m[..., None]
            o_sum += o
        return np.clip(m_sum, 0, 1), o_sum

    mask0_l, off0_l = [], []
    for b in range(B):
        ids = [idx[b]] if K == 1 else rng.integers(0, len(ds), K)
        m0, o0 = synth_composite(ids)
        mask0_l.append(np.pad(m0, pad))
        off0_l.append(np.pad(o0, pad))
    nchw = lambda a: torch.from_numpy(np.stack(a)).permute(0, 3, 1, 2).contiguous().to(dev)
    design0 = {"mask": nchw(mask0_l), "offset": nchw(off0_l)}  # [B, 1|2, 64, 64]

    # OOD hinge statistics: a ball of half the data's range around its mean
    all_states = ds._norm(data["fields"].reshape(-1, 62, 62, 3))
    mean_state = all_states.mean(0)  # [62, 62, 3]
    range_state = float(np.max(np.linalg.norm(
        (all_states - mean_state).reshape(all_states.shape[0], -1), axis=1)))
    if K == 1:
        all_bd = np.concatenate([data["mask"][..., None], data["offset"]], -1)
    else:  # around K-boundary composites
        comp = [synth_composite(rng.integers(0, len(ds), K)) for _ in range(64)]
        all_bd = np.stack([np.concatenate([m, o], -1) for m, o in comp])
    mean_bd = all_bd.mean(0)  # [62, 62, 3]
    range_bd = float(np.max(np.linalg.norm((all_bd - mean_bd).reshape(all_bd.shape[0], -1), axis=1)))
    chw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1), np.float32)).to(dev)
    mean_state, mean_bd = chw(mean_state), chw(mean_bd)

    # surrogate u_{t+1} = f(u_t, static) over 64^2 grids (3 state + 3 static channels)
    smodel = build_surrogate(args.surrogate, torch.Generator().manual_seed(args.seed))
    if args.surrogate_path:
        smodel = CheckpointManager(args.surrogate_path).load(
            template=init_train_state(smodel, TrainConfig())).model
    smodel = smodel.to(dev).eval().requires_grad_(False)
    if args.surrogate == "fno":
        step_fn = lambda u, static: smodel(torch.cat([u, static], dim=1))
    else:
        step_fn = lambda u, static: smodel(u, static, 1)[:, 0]
    # train_force's architecture, so that its milestones load
    fmodel = ForceUnet(dim=64, dim_mults=(1, 2, 4, 8), generator=torch.Generator().manual_seed(1))
    if args.force_model_path:
        fmodel = CheckpointManager(args.force_model_path).load(
            template=init_train_state(fmodel, TrainConfig())).ema
    fmodel = fmodel.to(dev).eval().requires_grad_(False)

    def hinge(a, mean, radius, n):
        d = torch.linalg.vector_norm((a[:, :, :62, :62] - mean).reshape(a.shape[0], -1), dim=1)
        return torch.relu(d - 0.5 * radius).reshape(n, B).sum(dim=1)

    def objective(design, u, n=1):
        """design tensors [n*B, C, 64, 64] (n candidates of B designs), u
        [n*B, 3, 64, 64]: roll the surrogate; lambda |sum Fx| - sum Fy over
        the frames + OOD hinges, per candidate [n]."""
        static = torch.cat([clip(design["mask"], 0, 1), clip(design["offset"], -0.5, 0.5)], dim=1)
        fx = fy = bd_loss = 0.0
        for _ in range(args.rollout):
            u = step_fn(u, static)
            press = unnormalize_state(u[:, 2:3], ds.p_min, ds.p_max)
            ld = fmodel(torch.cat([press, static], dim=1)).reshape(n, B, 2)
            fx = fx + ld[..., 0].sum(dim=1)
            fy = fy + ld[..., 1].sum(dim=1)
            if args.is_bdloss:
                bd_loss = bd_loss + hinge(u, mean_state, range_state, n)
        if args.is_bdloss:
            bd_loss = bd_loss + hinge(static, mean_bd, range_bd, n)
        return args.lambda_force * torch.abs(fx / args.rollout) - fy / args.rollout + bd_loss

    sync()
    t0 = time.perf_counter()
    if args.design_method == "GD":
        design = {k: v.clone().requires_grad_(True) for k, v in design0.items()}
        opt = torch.optim.Adam(list(design.values()), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
        vals = []
        for _ in range(args.optim_iter):
            opt.zero_grad()
            val = objective(design, u0)[0]
            val.backward()
            opt.step()
            vals.append(val.detach())
        design = {k: v.detach() for k, v in design.items()}
        record = {"design_method": "GD", "surrogate": args.surrogate,
                  "obj_first": float(vals[0]), "obj_last": float(vals[-1])}
    else:
        flat0 = torch.cat([design0["mask"].reshape(B, -1), design0["offset"].reshape(B, -1)], -1)

        def unflatten(flat):  # [..., B, 64*64*3] -> tensors [n*B, C, 64, 64]
            return {"mask": flat[..., :64 * 64].reshape(-1, 1, 64, 64),
                    "offset": flat[..., 64 * 64:].reshape(-1, 2, 64, 64)}

        def score(pop):  # the population [n, B, 64*64*3] at once -> [n]
            n = pop.shape[0]
            return objective(unflatten(pop), u0.repeat(n, 1, 1, 1), n)

        cfg = CEMConfig(n_samples=args.N, n_elites=args.Ne, n_iterations=args.optim_iter)
        randn = generator_randn(torch.Generator(device=dev).manual_seed(args.seed), dev)
        best, obj = cem_design(cfg, rollout_fn=lambda f: f, design_fn=score,
                               cond_shape=tuple(flat0.shape), randn=randn, init_mean=flat0,
                               clamp_fn=lambda f: f, batched=True)
        design = unflatten(best)
        record = {"design_method": "CEM", "surrogate": args.surrogate, "obj_last": float(obj)}
    sync()
    timings["design"] = time.perf_counter() - t0

    # closed-loop scoring: mask -> polygons -> BDIM lift/drag; a design is
    # valid when its mask reconstructs to exactly K polygons
    t0 = time.perf_counter()
    masks = mask_denoise(design["mask"][:, 0, :62, :62]).cpu().numpy()
    offs = design["offset"][:, :, :62, :62].permute(0, 2, 3, 1).cpu().numpy()
    poly_sets = []
    for b in range(B):
        ps = reconstruct_boundary(masks[b], offs[b])
        if len(ps) == K:
            poly_sets.append(ps)
    record["valid_designs"] = len(poly_sets)
    record["batch_size"] = B
    record["num_boundaries"] = K
    if args.evaluate and poly_sets:
        M = max(len(p) for ps in poly_sets for p in ps)
        batchpolys = np.stack([
            np.stack([np.pad(p, ((0, M - len(p)), (0, 0)), mode="edge") for p in ps])
            for ps in poly_sets
        ])  # [valid, K, M, 2]
        scores = evaluate_designs(batchpolys, n_warmup=args.n_warmup, n_record=args.n_record,
                                  device=dev)
        record.update({k: float(v) for k, v in scores.items() if np.ndim(v) == 0})
    sync()
    timings["scoring"] = time.perf_counter() - t0
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
