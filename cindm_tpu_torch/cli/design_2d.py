"""design_2d: multi-airfoil guided inverse design, PyTorch port.

Port of ``cindm_tpu/cli/design_2d.py`` with the same flags and the same
final JSON record, plus ``--device`` (default ``cuda``). It loads the
airfoil prior (``Unet2D``) and the ForceUnet surrogate from
``persisted_m*.npz`` snapshots of either package, samples num_boundaries
designs with guidance, turns masks into polygons, rejects overlaps, and
scores lift/drag by re-simulating the designs with the batched BDIM solver.

    python -m cindm_tpu_torch.cli.design_2d --model_path results/airfoil_v3 \
        --force_model_path results/force_v3 --batch_size 16 --num_boundaries 3 \
        --region_partition y --region_band 0.2 0.8

Departures from the JAX CLI: only npz snapshots are read (no orbax);
without ``--force_model_path`` the ForceUnet is seeded from a
``torch.Generator`` (seed 1), not from ``PRNGKey(1)``, so the two packages
differ there; ``--n_devices > 0`` raises (multi-GPU is not ported);
``--host_chunks`` only sets how often the loop prints progress.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def make_region_bands(H: int, W: int, nb: int, lo_frac: float = 0.0, hi_frac: float = 1.0,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """[nb, H, W] per-boundary horizontal bands with 2-cell gaps inside the
    [lo_frac, hi_frac) range of rows: boundary k may only place mask inside
    its band."""
    rows = torch.arange(H, dtype=torch.float32, device=device)[:, None] * torch.ones(
        (1, W), device=device)
    r_lo, r_hi = lo_frac * H, hi_frac * H
    span = (r_hi - r_lo) / nb
    bands = []
    for k in range(nb):
        lo, hi = r_lo + k * span + 2, r_lo + (k + 1) * span - 2
        bands.append(((rows >= lo) & (rows < hi)).to(torch.float32))
    return torch.stack(bands)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-airfoil inverse design, PyTorch port")
    p.add_argument("--model_path", default="./results/airfoil")
    p.add_argument("--force_model_path", default=None)
    p.add_argument("--milestone", type=int, default=None)
    p.add_argument("--num_boundaries", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--design_guidance", default="standard-alpha")
    p.add_argument("--coeff_ratio", type=float, default=2e-4)
    p.add_argument("--lambda_force", type=float, default=1.0)
    p.add_argument("--lambda_overlap", type=float, default=1.0)
    p.add_argument("--lambda_separation", type=float, default=0.0,
                   help="weight of the pairwise mask-centroid separation term")
    p.add_argument("--region_band", type=float, nargs=2, default=[0.0, 1.0],
                   help="fractional y-range [lo, hi) that --region_partition splits "
                        "into per-boundary bands")
    p.add_argument("--region_partition", default="none", choices=["none", "y"],
                   help="'y' gives each boundary a horizontal band and inpaints its "
                        "mask to zero outside it at every step")
    p.add_argument("--station_until", type=int, default=0,
                   help="q-sample-inpaint per-boundary proto-mask blobs into the mask "
                        "channel while t >= this value; 0 = off")
    p.add_argument("--init_sep", type=float, default=0.0,
                   help="amplitude of per-boundary Gaussian bumps added to the mask "
                        "channel of x_T (0 = off)")
    p.add_argument("--share_noise", type=lambda s: s == "True", default=True)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--ddim_steps", type=int, default=0,
                   help="> 0: guided DDIM with this many reverse steps")
    p.add_argument("--p_min", type=float, default=-1.0)
    p.add_argument("--p_max", type=float, default=1.0)
    p.add_argument("--evaluate", type=lambda s: s == "True", default=True)
    p.add_argument("--n_warmup", type=int, default=300,
                   help="BDIM warm-up steps before force recording")
    p.add_argument("--n_record", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--host_chunks", type=int, default=10,
                   help="accepted for compatibility; sets how often progress is printed")
    p.add_argument("--n_devices", type=int, default=0,
                   help="multi-GPU sampling is not ported yet; only 0 is accepted")
    p.add_argument("--dump_raw", default=None,
                   help="save the raw sampled tensor [B, nb, 64, 64, 21] to this .npy")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    return p


def load_snapshot(model: torch.nn.Module, path: str, milestone=None) -> torch.nn.Module:
    """Fill ``model`` with the EMA weights (else the raw ones) of the
    snapshot under ``path``."""
    from ..models import params_from_flax
    from ..utils.persist import find_persisted, load_flax_npz, select_subtree

    snap = find_persisted(path, milestone)
    if snap is None:
        want = "latest" if milestone is None else f"milestone {milestone}"
        raise FileNotFoundError(f"no persisted_m*.npz snapshot ({want}) in {path}")
    flat = load_flax_npz(snap)
    tree = select_subtree(flat, "ema_params") or select_subtree(flat, "params")
    model.load_state_dict(params_from_flax(tree, model))
    return model


def _stations(args, H: int, W: int, channels: int, device):
    """(init_bias, station_pattern): per-boundary Gaussian bumps in the mask
    channel, centres at 0.35 W and staggered in y (at the region-band
    centres under --region_partition y)."""
    nb, B = args.num_boundaries, args.batch_size
    yy, xx = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    cx = 0.35 * W
    if args.region_partition == "y":
        lo, hi = args.region_band
        span = (hi - lo) / nb
        centers_y = torch.tensor([(lo + (k + 0.5) * span) * H for k in range(nb)], device=device)
        sy = max(2.0, 0.3 * span * H)
    else:
        centers_y = torch.linspace(0.4 * H, 0.6 * H, nb, device=device)
        sy = 0.35 * float(centers_y[1] - centers_y[0])
    sx = 2.5 * sy
    bumps = torch.exp(-((xx[None] - cx) ** 2) / (2 * sx * sx)
                      - ((yy[None] - centers_y[:, None, None]) ** 2) / (2 * sy * sy))  # [nb, H, W]
    init_bias = station_pattern = None
    if args.init_sep > 0.0:
        bias = torch.zeros((B, nb, H, W, channels), device=device)
        bias[..., -3] = args.init_sep * bumps[None]
        init_bias = bias.reshape(B * nb, H, W, channels)
    if args.station_until > 0:
        blobs = (bumps > float(np.exp(-0.5))).to(torch.float32)
        station_pattern = blobs[None].expand(B, nb, H, W).reshape(B * nb, H, W)
    return init_bias, station_pattern


def main(argv=None, timings: dict | None = None):
    """Run the CLI; ``timings`` (if given) receives the seconds of
    ``sampling``, ``postprocess`` and ``scoring``, each ended by a device
    synchronisation."""
    from ..models import ForceUnet, Unet2D
    from ..physics.bdim import BDIMConfig
    from ..sampling.diffusion2d import (Diffusion2DConfig, ddim_sample_loop_2d, nhwc_model,
                                        p_sample_loop_2d)
    from ..sampling.guidance2d import make_design_grad_fn, mask_denoise
    from ..sampling.sampler import generator_randn
    from ..utils import evaluate_designs, polygons_overlap, reconstruct_boundary
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.n_devices > 0:
        raise SystemExit("--n_devices > 0: multi-GPU sampling is not ported yet")
    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    timings = {} if timings is None else timings
    cfg = Diffusion2DConfig(timesteps=args.timesteps, coeff_ratio=args.coeff_ratio,
                            share_noise=args.share_noise)
    model = load_snapshot(Unet2D(dim=64, dim_mults=(1, 2), channels=cfg.channels),
                          args.model_path, args.milestone).to(dev).eval()
    fm = ForceUnet(dim=64, dim_mults=(1, 2, 4, 8), generator=torch.Generator().manual_seed(1))
    if args.force_model_path:
        load_snapshot(fm, args.force_model_path)
    fm = fm.to(dev).eval().requires_grad_(False)
    model.requires_grad_(False)

    design_fn = make_design_grad_fn(
        fm, args.batch_size, args.num_boundaries, cfg.frames, args.p_min, args.p_max,
        args.lambda_force, args.lambda_overlap, lambda_separation=args.lambda_separation,
    )
    H = W = cfg.image_size
    nb = args.num_boundaries
    init_bias = station_pattern = region_mask = None
    if (args.init_sep > 0.0 or args.station_until > 0) and nb > 1:
        init_bias, station_pattern = _stations(args, H, W, cfg.channels, dev)
    if args.region_partition == "y" and nb > 1:
        region_mask = make_region_bands(H, W, nb, *args.region_band, device=dev)[None].expand(
            args.batch_size, nb, H, W).reshape(args.batch_size * nb, H, W)
    sched = cfg.make_schedule(device=dev)
    eps = nhwc_model(model)
    randn = generator_randn(torch.Generator(device=dev).manual_seed(args.seed), dev)

    t0 = time.perf_counter()
    if args.ddim_steps > 0:
        out = ddim_sample_loop_2d(
            cfg, sched, eps, randn, batch=args.batch_size, num_boundaries=nb,
            sampling_timesteps=args.ddim_steps, design_fn=design_fn,
            design_guidance=args.design_guidance, init_bias=init_bias,
        )
    else:
        out = p_sample_loop_2d(
            cfg, sched, eps, randn, batch=args.batch_size, num_boundaries=nb,
            design_fn=design_fn, design_guidance=args.design_guidance,
            host_chunks=args.host_chunks, init_bias=init_bias, station_pattern=station_pattern,
            station_until=args.station_until, region_mask=region_mask, progress=True,
        )
    sync()
    timings["sampling"] = time.perf_counter() - t0

    # post-process: mask -> polygons, reject overlapping designs
    t0 = time.perf_counter()
    masks_all = mask_denoise(out[:, :, :62, :62, -3]).cpu().numpy()
    out_np = out.cpu().numpy()
    if args.dump_raw:
        np.save(args.dump_raw, out_np)
    results = []
    fail = {"overlap": 0, "n_polys": 0}
    for b in range(args.batch_size):
        masks = masks_all[b]
        if nb > 1 and polygons_overlap(masks):
            fail["overlap"] += 1
            continue
        polys = []
        for k in range(nb):
            ps = reconstruct_boundary(masks[k], out_np[b, k, :62, :62, -2:])
            if len(ps) != 1:
                print(f"sample {b} boundary {k}: {len(ps)} polygons "
                      f"(mask px {int(masks[k].sum())})")
                fail["n_polys"] += 1
                break
            polys.append(ps[0])
        if len(polys) == nb:
            results.append(polys)
    print(f"valid designs: {len(results)}/{args.batch_size} (rejected: {fail})")
    timings["postprocess"] = time.perf_counter() - t0

    record = {"valid_designs": len(results), "batch_size": args.batch_size,
              "num_boundaries": nb,
              "lambda_overlap": args.lambda_overlap,
              "lambda_separation": args.lambda_separation,
              "init_sep": args.init_sep, "station_until": args.station_until,
              "region_partition": args.region_partition,
              "ddim_steps": args.ddim_steps}
    t0 = time.perf_counter()
    if args.evaluate and results:
        # pad polygons to a fixed point count for batching
        M = max(len(p) for polys in results for p in polys)
        batchpolys = np.stack([
            np.stack([np.pad(p, ((0, M - len(p)), (0, 0)), mode="edge") for p in polys])
            for polys in results
        ])
        scores = evaluate_designs(batchpolys, BDIMConfig(), n_warmup=args.n_warmup,
                                  n_record=args.n_record, device=dev)
        record.update({k: v for k, v in scores.items() if np.ndim(v) == 0})
    sync()
    timings["scoring"] = time.perf_counter() - t0
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
