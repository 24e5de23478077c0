"""The computations of tests/test_torch_parallel.py, at world size 1 (called
in the test's process with ``mesh=None``) or as one rank of a gloo group:

    python tests/torch_parallel_worker.py <rank> <port> <workdir>

A rank joins the group over tcp://127.0.0.1:<port> with
``initialize_multihost``, reads ``<workdir>/inputs.npz`` and writes what it
computed to ``<workdir>/rank<rank>.pt``."""

import os
import sys

import numpy as np
import torch

from cindm_tpu_torch.core import make_schedule
from cindm_tpu_torch.models import ForceUnet, Unet2D
from cindm_tpu_torch.parallel import make_sharded_sampler
from cindm_tpu_torch.parallel.mesh import shard_batch
from cindm_tpu_torch.sampling import Diffusion1DConfig, get_design_fn, sample
from cindm_tpu_torch.sampling.diffusion2d import Diffusion2DConfig, nhwc_model, p_sample_loop_2d
from cindm_tpu_torch.sampling.guidance2d import make_design_grad_fn
from cindm_tpu_torch.sampling.sampler import generator_randn
from cindm_tpu_torch.train import TrainConfig, init_train_state, make_train_step
from torch_port_helpers import port_model

TRAIN_CFG = dict(gradient_accumulate_every=1, ema_update_every=1)
NB, DESIGNS, STEPS_2D = 2, 2, 3


def _train(mesh, inputs: dict, injected: bool) -> dict:
    """Two steps of the 1D diffusion train step from port_model(16, seed 3):
    the draws injected from ``inputs`` (the JAX package's), or drawn from a
    seeded generator. Returns the parameters and each step's gradients."""
    model = port_model(dim=16, seed=3, dim_mults=(1,))
    state = init_train_state(model, TrainConfig(**TRAIN_CFG))
    grads = []
    update = state.opt_state.update

    def record(params, gs):
        grads.append([g.clone() for g in gs])
        return update(params, gs)

    state.opt_state.update = record
    step = make_train_step(Diffusion1DConfig(rollout_steps=24, timesteps=100),
                           make_schedule(100, device="cpu"), TrainConfig(**TRAIN_CFG),
                           generator=torch.Generator().manual_seed(9), mesh=mesh)
    losses = []
    for i in range(2):
        batch = {"x": torch.from_numpy(inputs[f"x{i}"])}
        if injected:
            batch.update(t=torch.from_numpy(inputs[f"t{i}"]).long(),
                         noise=torch.from_numpy(inputs[f"noise{i}"]))
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        _, loss = step(state, batch)
        losses.append(float(loss))
    return {"params": {k: v.clone() for k, v in model.state_dict().items()}, "grads": grads,
            "losses": losses, "step": state.step}


def _sample_1d(mesh) -> torch.Tensor:
    """A guided, composed (3 bodies from the 2-body model) sampler run, 4
    samples, split over the ranks by ``make_sharded_sampler``."""
    model = port_model(dim=16, seed=4, dim_mults=(1,)).eval()
    dcfg = Diffusion1DConfig(rollout_steps=24, timesteps=4)
    sched = make_schedule(4, device="cpu")
    fn = lambda randn, **kw: sample(dcfg, sched, model, randn, **kw)
    if mesh is not None:
        fn = make_sharded_sampler(fn, mesh)
    design_fn = get_design_fn(torch.tensor([0.5, 0.5]), last_n_step=1, coef=0.2,
                              time_consistency_coef=0.2)
    with torch.no_grad():
        return fn(generator_randn(torch.Generator().manual_seed(5), torch.device("cpu")),
                  batch_size=4, feature_size=12, design_fn=design_fn,
                  design_guidance="standard-recurrence-2", compose_n_bodies=3)


def _sample_2d(mesh) -> torch.Tensor:
    """The guided 2D loop over 2 designs of 2 boundaries with a region mask,
    split over the ranks by whole designs."""
    cfg = Diffusion2DConfig(timesteps=STEPS_2D, coeff_ratio=2e-4)
    unet = Unet2D(dim=8, dim_mults=(1, 2), channels=cfg.channels,
                  generator=torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    fm = ForceUnet(dim=8, dim_mults=(1, 2),
                   generator=torch.Generator().manual_seed(1)).eval().requires_grad_(False)
    W = 1 if mesh is None else mesh.size()
    design_fn = make_design_grad_fn(fm, DESIGNS // W, NB, cfg.frames, -1.0, 1.0)
    band = torch.zeros(NB, 64, 64)
    band[0, :32], band[1, 32:] = 1.0, 1.0
    region = band[None].expand(DESIGNS, NB, 64, 64).reshape(DESIGNS * NB, 64, 64)
    return p_sample_loop_2d(cfg, cfg.make_schedule(device="cpu"), nhwc_model(unet),
                            generator_randn(torch.Generator().manual_seed(6), torch.device("cpu")),
                            batch=DESIGNS, num_boundaries=NB, design_fn=design_fn,
                            design_guidance="standard-alpha", region_mask=region, mesh=mesh)


def compute(mesh, inputs: dict) -> dict:
    return {"train_injected": _train(mesh, inputs, injected=True),
            "train_drawn": _train(mesh, inputs, injected=False),
            "sample_1d": _sample_1d(mesh), "sample_2d": _sample_2d(mesh)}


def main(rank: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from cindm_tpu_torch.ops import _build
    from cindm_tpu_torch.parallel import initialize_multihost, make_mesh, replicate
    from cindm_tpu_torch.parallel.mesh import rank_rows

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        out = {"backend": dist.get_backend()}
        t = torch.full((1, 4), float(rank + 1))
        dist.all_reduce(t)
        out["all_reduce_sum"] = float(t.sum())
        mesh = make_mesh(2)
        out["mesh"] = (tuple(mesh.mesh_dim_names), mesh.size())
        out["shard"] = shard_batch(mesh, {"x": torch.arange(8).reshape(4, 2), "n": 3})
        try:
            rank_rows(mesh, 3)
        except ValueError as e:
            out["odd_rows"] = str(e)
        try:
            make_mesh(3)
        except ValueError as e:
            out["too_many"] = str(e)
        mine = port_model(dim=8, seed=rank, dim_mults=(1,))
        state = init_train_state(mine, TrainConfig())
        state.step, state.opt_state.count = 10 + rank, 20 + rank
        # the conv weights' staged layouts (the plain stager on the CPU), as a
        # forward leaves them, before and after the broadcast
        convs = [p for p in mine.parameters() if p.dim() == 3]
        before = [_build.staged(w, 64) for w in convs]
        replicate(mesh, state)
        after = [_build.staged(w, 64) for w in convs]
        out["staged"] = {"changed": [not torch.equal(a, b) for a, b in zip(before, after)],
                         "fresh": [torch.equal(a, _build.stage_weights_reference(w, 64))
                                   for a, w in zip(after, convs)]}
        out["replicated"] = {"params": mine.state_dict(), "step": state.step,
                             "count": state.opt_state.count}
        out["replicated_tensor"] = replicate(mesh, torch.full((3,), float(rank)))
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            inputs = dict(f)
        out.update(compute(mesh, inputs))
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
