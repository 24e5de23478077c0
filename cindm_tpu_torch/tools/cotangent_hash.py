"""Hashes of every cotangent of one backward pass, to compare two checkouts bit for bit.

    python3 -m cindm_tpu_torch.tools.cotangent_hash [--batch 512] > hashes.json
    python3 -m cindm_tpu_torch.tools.cotangent_hash --forward [--batch 512 5376] [--tiles] > fwd.json
    python3 -m cindm_tpu_torch.tools.cotangent_hash --compare a.json b.json
    python3 -m cindm_tpu_torch.tools.cotangent_hash --compare-whole a.json b.json
    python3 -m cindm_tpu_torch.tools.cotangent_hash --plain [--batch 512]

Runs the backward kernels of the denoiser's 16 fused ResidualTemporalBlocks
and of its head once, at the shapes and on the seeded inputs of
``tools/backward_profile`` (what the forward's saving instance kept, every
gradient wanted), and prints one JSON object: per block, the sha256 (16 hex
digits) of each cotangent's bytes, null where a block has none. Two
checkouts whose backwards agree bit for bit print equal objects;
``--compare`` prints whether two files do and the blocks that differ, and
exits 1 when they differ. ``--forward`` hashes the forward kernels instead:
per block and batch (512 and 5,376 unless ``--batch`` names others), out
of the plain instance and out, h, z1, z2, mean1, rstd1, mean2, rstd2 of
the saving instance (the head: out, then out, z, mean, rstd); with
``--tiles`` also, per block and batch, each saved z's hash tile by tile
(its plan's row tiles of whole samples x N tiles, row-major).
``--compare-whole`` compares two such files tile by tile and splits the
count by this checkout's plans: the tiles that a launch runs whole, and
those of its split tail (the last, partial wave, whose parts are summed in
another order); it exits 1 when a whole tile differs. ``--plain``
prints, per block and cotangent, the largest |kernel - plain| over the
plain largest entry of the backward kernel against its closed form on the
same saved tensors (what the saving forward kept: a change of the forward's
sum orders moves mean and rstd, and through them the cotangents' last
bits), and beside it, ``chain``, the same against the whole plain path
(``*_forward_saving_reference``, then the closed form), which also carries
the forward's 3xTF32 rounding; run it in two checkouts to compare them
(``chip_smoke.py``'s grad phase holds the same errors to 1e-4 on its own
inputs). It runs
against the package it is imported from,
so a copy of this file in another checkout hashes that checkout's kernels.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys


def hashes(torch, dev, batch: int = 512, seed: int = 77) -> dict:
    from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish, fused_conv1d_gn_mish_backward
    from cindm_tpu_torch.ops.fused_rtb import _fused_rtb, fused_rtb_backward
    from cindm_tpu_torch.tools.backward_profile import HEAD_SHAPE, RTB_SHAPES, block_inputs

    g = torch.Generator(device=dev).manual_seed(seed)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    out = {}
    with torch.no_grad():
        for i, (C, O, T) in enumerate(RTB_SHAPES + [HEAD_SHAPE]):
            head = i == len(RTB_SHAPES)
            x, p, cot = block_inputs(torch, g, C, O, T, batch, dev, head)
            if head:
                args = [x, p["w1"], p["b1"], p["gs1"], p["gb1"]]
                saved = args + list(_conv_gn_mish(*args, 8, 1e-5, save=True)[1:])
                grads = fused_conv1d_gn_mish_backward(saved, cot, [True] * 5)
            else:
                args = [x if n == "x" else p.get(n) for n in names]
                saved = args + list(_fused_rtb(*args, 8, 1e-5, save=True)[1:])
                grads = fused_rtb_backward(saved, cot, [True] * 10 + ["wres" in p] * 2)
            out[f"{i}:{C},{O},{T}"] = [
                None if t is None else hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                for t in grads]
    return out


def against_plain(torch, dev, batch: int = 512, seed: int = 77) -> tuple[dict, dict]:
    """Per block, each cotangent's max |kernel - plain| / max |plain|: the
    closed form on the kernel's saved tensors, and the whole plain path."""
    from cindm_tpu_torch.ops.fused_conv_gn import (_conv_gn_mish, fused_conv1d_gn_mish_backward,
                                                   fused_conv1d_gn_mish_backward_reference,
                                                   fused_conv1d_gn_mish_forward_saving_reference)
    from cindm_tpu_torch.ops.fused_rtb import (_fused_rtb, fused_rtb_backward, fused_rtb_backward_reference,
                                               fused_rtb_forward_saving_reference)
    from cindm_tpu_torch.tools.backward_profile import HEAD_SHAPE, RTB_SHAPES, block_inputs

    g = torch.Generator(device=dev).manual_seed(seed)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    out, chain = {}, {}

    def rel(got, want):
        return [None if w is None else float((k - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for k, w in zip(got, want)]

    with torch.no_grad():
        for i, (C, O, T) in enumerate(RTB_SHAPES + [HEAD_SHAPE]):
            head = i == len(RTB_SHAPES)
            x, p, cot = block_inputs(torch, g, C, O, T, batch, dev, head)
            if head:
                args, needs = [x, p["w1"], p["b1"], p["gs1"], p["gb1"]], [True] * 5
                fwd, bwd, bwd_ref = _conv_gn_mish, fused_conv1d_gn_mish_backward, fused_conv1d_gn_mish_backward_reference
                fwd_ref = fused_conv1d_gn_mish_forward_saving_reference
            else:
                args, needs = [x if n == "x" else p.get(n) for n in names], [True] * 10 + ["wres" in p] * 2
                fwd, bwd, bwd_ref = _fused_rtb, fused_rtb_backward, fused_rtb_backward_reference
                fwd_ref = fused_rtb_forward_saving_reference
            saved = args + list(fwd(*args, 8, 1e-5, save=True)[1:])
            got = bwd(saved, cot, needs)
            out[f"{i}:{C},{O},{T}"] = rel(got, bwd_ref(saved, cot, needs))
            chain[f"{i}:{C},{O},{T}"] = rel(got, bwd_ref(args + list(fwd_ref(*args, 8, 1e-5)[1:]), cot, needs))
    return out, chain


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def tile_hashes(z, samples: int, n_tile: int) -> list[str]:
    """z [B, T, O]'s hash per tile: row tile rt (samples rt S .. rt S + S -
    1) x N tile n (channels n nt ..), row-major."""
    B, _, O = z.shape
    z = z.cpu()
    return [_digest(z[r:r + samples, :, n:n + n_tile]) for r in range(0, B, samples) for n in range(0, O, n_tile)]


def stage_shapes(key: str) -> list[tuple[int, int, int, int]]:
    """(B, T, C, O) of the stage launches whose z a ``--tiles`` entry holds,
    in its order: a block's two (C -> O, then O -> O), the head's one."""
    shape, batch = key.split("@")
    i, dims = shape.split(":")
    C, O, T = map(int, dims.split(","))
    from cindm_tpu_torch.tools.backward_profile import RTB_SHAPES

    return [(int(batch), T, C, O)] + ([(int(batch), T, O, O)] if int(i) < len(RTB_SHAPES) else [])


def compare_whole(a: dict, b: dict) -> dict:
    """Two ``--tiles`` files' z, tile by tile: equal and differing tiles
    among those that this checkout's plans (for the card the hashes were
    taken on) run whole, and among the split tail's."""
    from cindm_tpu_torch.ops import _build

    count = {"whole_equal": 0, "whole_differ": 0, "split_equal": 0, "split_differ": 0}
    differ = []
    for key in sorted(k for k in a if k.endswith(":tiles") and k in b):
        block = key[:-len(":tiles")]
        for j, (B, T, C, O) in enumerate(stage_shapes(block)):
            plan = _build.plan_stage(B, T, C, O, 8, num_sms=b[key]["sms"])
            assert a[key]["n_tile"] == b[key]["n_tile"] == plan.n_tile and a[key]["samples"] == plan.samples
            for t, (x, y) in enumerate(zip(a[key]["z"][j], b[key]["z"][j])):
                rt, nti = divmod(t, plan.grid[1])
                item = rt // plan.cluster * plan.grid[1] + nti
                kind = "whole" if len(plan.item_parts(item)) == 1 else "split"
                count[f"{kind}_{'equal' if x == y else 'differ'}"] += 1
                if kind == "whole" and x != y:
                    differ.append(f"{block} z{j + 1} tile {t}")
    return {"whole_bit_identical": not differ, **count, "whole_tiles_that_differ": differ[:20]}


def forward_hashes(torch, dev, batches=(512, 5376), seed: int = 77, tiles: bool = False) -> dict:
    from cindm_tpu_torch.ops import _build
    from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish
    from cindm_tpu_torch.ops.fused_rtb import _fused_rtb
    from cindm_tpu_torch.tools.backward_profile import HEAD_SHAPE, RTB_SHAPES, block_inputs

    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    out = {}
    with torch.no_grad():
        for batch in batches:
            g = torch.Generator(device=dev).manual_seed(seed)
            for i, (C, O, T) in enumerate(RTB_SHAPES + [HEAD_SHAPE]):
                head = i == len(RTB_SHAPES)
                x, p, _ = block_inputs(torch, g, C, O, T, batch, dev, head)
                if head:
                    args = [x, p["w1"], p["b1"], p["gs1"], p["gb1"]]
                    got = list(_conv_gn_mish(*args, 8, 1e-5, save=False))
                    got += list(_conv_gn_mish(*args, 8, 1e-5, save=True))
                else:
                    args = [x if n == "x" else p.get(n) for n in names]
                    got = list(_fused_rtb(*args, 8, 1e-5, save=False))
                    got += list(_fused_rtb(*args, 8, 1e-5, save=True))
                out[f"{i}:{C},{O},{T}@{batch}"] = [_digest(t) for t in got]
                if tiles:  # the saving instance's z (z1, z2; the head's z) tile by tile
                    plan = _build.plan_stage(batch, T, C, O, 8, num_sms=_build.num_sms(dev))
                    zs = [got[2]] if head else [got[3], got[4]]
                    out[f"{i}:{C},{O},{T}@{batch}:tiles"] = {
                        "samples": plan.samples, "n_tile": plan.n_tile, "sms": _build.num_sms(dev),
                        "z": [tile_hashes(z, plan.samples, plan.n_tile) for z in zs]}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=None)
    ap.add_argument("--forward", action="store_true",
                    help="hash the forward kernels' outputs and saved tensors instead")
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    ap.add_argument("--compare-whole", nargs=2, metavar="FILE",
                    help="two --forward --tiles files' z tile by tile, whole and split tiles apart")
    ap.add_argument("--tiles", action="store_true", help="with --forward: each saved z's hash per tile")
    ap.add_argument("--plain", action="store_true",
                    help="each cotangent's error against the closed form and the plain path")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.load(open(f)) for f in args.compare)
        differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(json.dumps({"bit_identical": not differ, "blocks": len(a), "differ": differ}))
        return 1 if differ else 0
    if args.compare_whole:
        a, b = (json.load(open(f)) for f in args.compare_whole)
        res = compare_whole(a, b)
        print(json.dumps(res))
        return 0 if res["whole_bit_identical"] else 1
    import torch

    if not torch.cuda.is_available():
        print("cotangent_hash: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.plain:
        errs, chain = against_plain(torch, dev, (args.batch or [512])[0])
        worst = max(e for v in errs.values() for e in v if e is not None)
        print(json.dumps({"max_rel_err": worst, "blocks": errs,
                          "chain_max_rel_err": max(e for v in chain.values() for e in v if e is not None),
                          "chain": chain}), flush=True)
        return 0
    if args.forward:
        print(json.dumps(forward_hashes(torch, dev, tuple(args.batch or (512, 5376)), tiles=args.tiles)), flush=True)
    else:
        print(json.dumps(hashes(torch, dev, (args.batch or [512])[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
