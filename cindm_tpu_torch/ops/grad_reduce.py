"""The backward's in-order sum of partials, alone.

``grad_reduce`` runs the kernel that the hand-written backward
(``csrc/block_backward.cu``) launches last: for each job, dst[i] = sum over
s of src[s * n + i], v = 0 and then s = 0, 1, .., S - 1 one float32 add at a
time, so that a gradient summed from row splits or per-tile partials repeats
bit for bit. On CUDA tensors it launches ``grad_reduce`` of
``csrc/conv_backward.cuh`` (C entry ``cindm_grad_reduce``) on the items of
``_build.plan_reduce`` and counts the launch in ``grad_reduce.launches``; on
CPU tensors it takes the plain version ``grad_reduce_reference``. The
backward's own launch goes through the same checks; this entry exists so
that the kernel can be held to its plain version on its own.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build


def grad_reduce_reference(src: torch.Tensor, slices: int) -> torch.Tensor:
    """Plain version: ``src`` holds ``slices`` partials of n values, slice
    after slice; returns their sum [n], added in slice order."""
    parts = src.reshape(slices, -1)
    v = torch.zeros_like(parts[0])
    for s in range(slices):
        v = v + parts[s]
    return v


def grad_reduce(jobs: Sequence[tuple[torch.Tensor, int]]) -> list[torch.Tensor]:
    """Sum each job's partials in slice order: ``jobs`` is [(src, slices),
    ...], ``src`` float32 and contiguous with slices x n values (n a
    multiple of 4 on CUDA); returns each job's sum [n]. CUDA tensors go
    through the kernel, in one launch of at most ``_build.REDUCE_JOBS``
    jobs; CPU tensors through ``grad_reduce_reference``."""
    dev = jobs[0][0].device
    if any(src.device != dev for src, _ in jobs):
        raise ValueError("grad_reduce: every job's partials must lie on one device")
    for src, slices in jobs:
        if slices <= 0 or src.numel() % slices:
            raise ValueError(f"grad_reduce: {src.numel()} values are not {slices} slices of equal length")
    if dev.type != "cuda":
        return [grad_reduce_reference(src, slices) for src, slices in jobs]
    for src, _ in jobs:
        if src.dtype != torch.float32 or not src.is_contiguous():
            raise ValueError("grad_reduce: partials must be contiguous float32")
        if src.data_ptr() % 16:
            raise ValueError("grad_reduce: partials must start on a 16-byte boundary")
    plan = _build.plan_reduce([(src.numel() // slices, slices) for src, slices in jobs],
                              _build.num_sms(dev))
    outs = _build.carve(dev, *[(n,) for n, _ in plan.jobs])
    args = _build.ReduceArgs(njobs=len(plan.jobs), nitems=plan.items)
    for j, ((src, _), out, (n, slices)) in enumerate(zip(jobs, outs, plan.jobs)):
        args.job[j] = _build.ReduceJob(src.data_ptr(), out.data_ptr(), n, slices, plan.widths[j],
                                       plan.item0[j])
    lib = _build.load()
    err = _build.call_on(dev, lib.cindm_grad_reduce, ctypes.byref(args), plan.grid)
    _build.raise_on_error("grad_reduce", err)
    grad_reduce.launches += 1
    return outs


grad_reduce.launches = 0  # kernel launches (one a call on CUDA); not on CPU
