"""Process groups, the data mesh, and the row split of a data-parallel run.

Port of ``cindm_tpu/parallel/mesh.py``. In JAX one process drives every
chip and a step under a ``data`` mesh computes the same function as on one
device. Here each GPU has its own process, started by ``torchrun``
(``python -m torch.distributed.run``), and ``torch.distributed`` joins
them. The port keeps the JAX meaning, so a run at world size W computes
what the same run computes at world size 1:

- every rank draws the whole global batch from the same generator and keeps
  rows ``[r*B/W, (r+1)*B/W)`` (``draw_rows``, ``shard_batch``);
- gradients are averaged over the ranks before the optimizer
  (``all_reduce_mean``), which then runs identically on every rank;
- parameters start identical: rank 0 broadcasts them (``replicate``);
- results are gathered into the global batch (``gather_rows``) and only
  rank 0 writes files (``is_rank0``).

``data_sharding`` and ``replicated`` of the JAX module return
``NamedSharding`` placements, which have no meaning in torch: a tensor
lives on one rank's device, and the row split above takes their place.
They are left out.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join the process group: ``dist.init_process_group`` over
    ``tcp://<coordinator_address>`` with the given world size and rank, or
    over torchrun's ``env://`` (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``)
    when they are None. The backend is ``nccl`` for a CUDA ``device`` and
    ``gloo`` for the CPU unless ``backend`` names one (gloo also takes CUDA
    tensors for the broadcasts and all-reduces this package makes)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    # NCCL binds its communicator to this rank's card when it is named
    kw = {"device_id": device} if backend == "nccl" and device.index is not None else {}
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, **kw)


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",)) -> DeviceMesh:
    """A one-dimensional ``DeviceMesh`` over the whole process group, its dim
    named ``axis_names[0]`` ("data"). Raises if there is no group, or if
    ``n_devices`` is not the group's size (a mesh over part of the group has
    no use in the port)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_multihost first "
                           "(or start the program under torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"make_mesh: {n} devices asked for, but the process group has "
                         f"{world} ranks")
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for; the mesh spans the whole group "
                         f"of {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_names[0],))


def _group(mesh: DeviceMesh):
    return mesh.get_group(mesh.mesh_dim_names[0])


def mesh_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's index along the data dim (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(mesh.mesh_dim_names[0])


def is_rank0(mesh: Optional[DeviceMesh]) -> bool:
    """True on the rank that writes files (and without a mesh)."""
    return mesh_rank(mesh) == 0


def rank_rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of ``n`` global rows; raises unless W divides n."""
    W = mesh.size()
    if n % W:
        raise ValueError(f"{n} rows do not split over {W} ranks")
    r = mesh_rank(mesh)
    return slice(r * n // W, (r + 1) * n // W)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, batch: Any) -> Any:
    """This rank's rows of every [B, ...] tensor or array in a dict, list or
    tuple (the global batch B must split over the ranks); other leaves pass
    through."""
    def cut(x):
        return x[rank_rows(mesh, x.shape[0])] if hasattr(x, "shape") and x.ndim else x

    return _tree_map(cut, batch)


def draw_rows(mesh: Optional[DeviceMesh], draw: Callable[[tuple], torch.Tensor]
              ) -> Callable[[tuple], torch.Tensor]:
    """``draw(shape)`` for a shape whose leading dim is this rank's rows: it
    draws the global shape (leading dim times W) and keeps this rank's rows,
    so every rank consumes the generator as one process at world size 1
    does. ``draw`` itself without a mesh."""
    if mesh is None:
        return draw
    W, r = mesh.size(), mesh_rank(mesh)

    def local(shape):
        n = shape[0]
        return draw((n * W, *shape[1:]))[r * n:(r + 1) * n]

    return local


def all_reduce_mean(mesh: DeviceMesh, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor, through one all-reduce of one
    flat float32 buffer (every tensor on one device)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=_group(mesh))
    flat /= mesh.size()
    return [v.view(t.shape).to(t.dtype)
            for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def gather_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x in rank order, the global [W*n, ...] tensor, on
    every rank. Made as an all-reduce of zero-padded rows: gloo takes CUDA
    tensors for all-reduce and broadcast only, and adding zeros is exact."""
    n = x.shape[0]
    r = mesh_rank(mesh)
    full = x.new_zeros((n * mesh.size(), *x.shape[1:]))
    full[r * n:(r + 1) * n] = x
    dist.all_reduce(full, group=_group(mesh))
    return full


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def replicate(mesh: DeviceMesh, tree: Any) -> Any:
    """Rank 0's values on every rank, in place: the tensors of a tensor,
    module, dict, list or tuple, or the whole of a ``TrainState`` (model,
    EMA, optimizer moments and counts, step). Drops the kernels' staged
    weight layouts (``ops._build.staged``), which the broadcast made stale.
    Returns ``tree``."""
    from ..ops import _build
    from ..train.trainer import TrainState

    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    if isinstance(tree, TrainState):
        opt = tree.opt_state
        leaves = _leaves([tree.model, tree.ema, opt.mu, opt.nu, opt.acc or []])
    else:
        leaves = _leaves(tree)
    for t in leaves:
        dist.broadcast(t.data, src=src, group=group)
    # .data has a version counter of its own: the weights changed without
    # their _version moving, so the kernels' staged layouts of them are stale
    _build.staged.clear()
    if isinstance(tree, TrainState):
        dev = next(tree.model.parameters()).device
        counts = torch.tensor([tree.step, opt.count, opt.schedule_count, opt.mini_step],
                              dtype=torch.int64, device=dev)
        dist.broadcast(counts, src=src, group=group)
        tree.step, opt.count, opt.schedule_count, opt.mini_step = map(int, counts.tolist())
    return tree


def rank0_first(mesh: Optional[DeviceMesh], fn: Callable[[], Any]) -> Any:
    """``fn()`` on rank 0, then on the other ranks: rank 0 writes a cache that
    the others then read instead of writing it too."""
    if mesh is None:
        return fn()
    if is_rank0(mesh):
        out = fn()
        dist.barrier(group=_group(mesh))
        return out
    dist.barrier(group=_group(mesh))
    return fn()


@contextlib.contextmanager
def data_parallel(n_devices: int, device: str = "cuda"
                  ) -> Iterator[tuple[Optional[DeviceMesh], torch.device]]:
    """The mesh and device of a CLI's ``--n_devices``: ``(None, device)``
    for 0. For N > 0 the world must have N ranks: under torchrun the
    process joins its group (``env://``), started plainly with N = 1 it
    forms a one-rank group itself; any other N raises ``SystemExit`` naming
    both numbers. With ``--device cuda`` each rank takes
    ``cuda:LOCAL_RANK`` and NCCL, on the CPU gloo. A group formed here is
    destroyed on exit."""
    from ..utils.device import resolve_device

    if n_devices <= 0:
        yield None, resolve_device(device)
        return
    formed = not dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", "1")) if formed else dist.get_world_size()
    if n_devices != world:
        how = (f"start it with torchrun --nproc_per_node {n_devices}" if n_devices > world
               else f"pass --n_devices {world}")
        raise SystemExit(f"--n_devices {n_devices} does not match the world of {world} "
                         f"rank(s): {how}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if formed:
        if "WORLD_SIZE" in os.environ:
            initialize_multihost(device=dev)
        elif dev.type == "cuda":
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                    device_id=dev)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(n_devices), dev
    finally:
        if formed:
            dist.destroy_process_group()
