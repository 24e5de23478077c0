"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them with ctypes.

The sources have a plain C interface and include no PyTorch header, so each
compiles in seconds. Every ``.cu`` file is compiled by its own nvcc process,
all started together, and the objects are linked into one shared library:

    <repo>/.cuda_build/<hash of sources and flags>/libcindm_kernels.so

The directory is made on first use and a changed source gets a new hash, so
a stale library is never loaded. Each process compiles into a private
temporary directory and moves the finished library into place with one
atomic rename: no lock file exists that a cut-off build could leave behind.

Nothing here runs at import: ``load()`` is called by the wrappers on their
first CUDA launch, so CPU-only hosts import every module. ``plan_stage``
chooses the tile of each launch of the stage kernel in Python, where the
CPU tests reach it, ``plan_backward`` the tiles and scratch of the
backward kernels (``csrc/conv_backward.cuh``), whose C entries take their
arguments as one ``BackwardArgs`` structure, and ``plan_attention`` and
``plan_resample`` those of the attention and resampling kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
import time
import weakref
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".cuda_build"
LIB_NAME = "libcindm_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: (argtypes). Every entry returns the cudaError_t of its launch.
SIGNATURES = {
    # x, temb, w1 staged, b1, gs1, gb1, w2 staged, b2, gs2, gb2, wres staged, bres, h, out,
    # B, T, C, O, K, G, temb's row stride, eps, StageLaunch* of the first stage, of the second, stream
    "cindm_fused_rtb": [_P] * 14 + [_I] * 7 + [_F] + [_P] * 3,
    # x, w staged, b, gs, gb, out, B, T, C, O, K, G, eps, StageLaunch*, stream
    "cindm_fused_conv1d_gn_mish": [_P] * 6 + [_I] * 6 + [_F] + [_P] * 2,
    # the saving instances: as above with z1, z2, mean1, rstd1, mean2, rstd2
    # (the head: z, mean, rstd) after out
    "cindm_fused_rtb_saving": [_P] * 20 + [_I] * 7 + [_F] + [_P] * 3,
    "cindm_fused_conv1d_gn_mish_saving": [_P] * 9 + [_I] * 6 + [_F] + [_P] * 2,
    "cindm_stage_launch_size": [],
    # w[], out[], (K, C, O, n_tile)[], jobs, stream: the stage's weight layout
    # of up to LAYOUT_JOBS tensors of one N tile in one launch (``staged``,
    # ``layout_args``)
    "cindm_stage_weights": [_P, _P, _P, _I, _P],
    # the same arguments: the dgrads' layout (w [K, O, C] flipped) alone
    "cindm_stage_weights_t": [_P, _P, _P, _I, _P],
    # BackwardArgs*, stream
    "cindm_fused_rtb_backward": [_P, _P],
    # cluster size, int* out: the dgrads' clusters the device runs at once
    "cindm_dgrad_cluster_limit": [_I, _P],
    "cindm_fused_conv1d_gn_mish_backward": [_P, _P],
    "cindm_block_backward_args_size": [],
    # ReduceArgs*, grid, stream: grad_reduce alone
    "cindm_grad_reduce": [_P, _I, _P],
    "cindm_reduce_args_size": [],
    # x, g, wqkv staged, wout staged, bout, out, B, T, C, CTAs, eps, stream:
    # PreNormResidual(LinearAttentionTemporal) (``plan_attention``)
    "cindm_linear_attention": [_P] * 6 + [_I] * 4 + [_F, _P],
    # x, w0 staged, w1 staged, b, out, ResampleLaunch*, stream: Upsample1d or
    # Downsample1d (``plan_resample``, ``resample_launch``)
    "cindm_resample": [_P] * 7,
    "cindm_resample_launch_size": [],
}

# The tile and ring of the implicit-GEMM stage (csrc/conv_gn_mish.cuh on
# csrc/stage_ring.cuh's main loop); these mirror its constants and
# stage_smem_bytes(), and the launch refuses a plan whose shared-memory bytes,
# CTAs, cluster size or split differ from its own count.
TILE_ROWS = 192  # M: three warpgroups x 64 rows, whole samples only
CONV_K = 5  # the stage's conv width (the projection is its K = 1 case)
CHUNK = 8  # input channels of one k8 wgmma step
SBO_BYTES = 256  # bytes between n8 blocks of a staged weight plane
SMEM_MAX = 232448  # the H100's dynamic shared memory per block
H100_SMS = 132


def _align1024(n: int) -> int:
    return -(-n // 1024) * 1024


def stage_ring(nt: int) -> tuple[int, int, int]:
    """The dgrads' ring for an N tile of ``nt`` (StageRing's defaults):
    (chunks of 8 input channels a stage, stages, bytes). A stage holds the
    tile's 192 input rows of the stage's channels (one TMA box) and their
    weight blocks of five taps (one bulk copy), each part on 1,024-byte
    boundaries."""
    ch = 2 if nt == 64 else 1
    stages = 3 if nt == 64 else 2
    stage = _align1024(_align1024(TILE_ROWS * 4 * CHUNK * ch)
                       + ch * 2 * CONV_K * (nt // 8) * SBO_BYTES)
    return ch, stages, stages * stage


def _tile_bytes(nt: int) -> int:
    return TILE_ROWS * (nt + 4) * 4


WIDE_STAGES = 4  # the forward's ring at nt = 128
NARROW_STAGES = 6  # and at nt = 64
PROJ_CHUNKS = 2  # the projection's chunks a ring slot (ProjRing)
STAGE_CLUSTER = 2  # CTAs of a cluster that share an N tile's weight blocks (multicast)
# The split of a stage launch's last, partial wave of cluster items (its
# tail) over all clusters by K chunks (stage_split in stage_ring.cuh).
# A part is at least SPLIT_MIN_CHUNKS chunks: one ring stage. The forward's
# ring runs on across a cluster's parts, its producer filling the next
# part's slots while the consumers store a part's partial sums, so a part
# of one stage leaves it as fed as a whole tile's epilogue does; a longer
# minimum would leave a launch's busiest cluster more than a chunk above
# the mean (at batch 5,376 a 64-channel T = 24 stage's tail is 48 chunks
# for 66 clusters). What bounds a split instead is its finisher, which
# reads the other parts' partial tiles: the tail is cut into ranges of at
# least a tile's chunks / SPLIT_PARTS, so that a tile has about
# SPLIT_PARTS parts at most.
SPLIT_MIN_CHUNKS = 1
SPLIT_PARTS = 8


def fwd_ring(nt: int) -> tuple[int, int]:
    """The forward stage's ring (ConvRing): (stages, bytes of a slot). A
    slot holds one chunk of 8 input channels: the tile's 192 rows of 32
    bytes by TMA, the split's small plane beside them (the big plane
    replaces the box in place), then the chunk's weight blocks of five taps,
    each part on 1,024-byte boundaries; 6 slots at nt = 64, 4 at nt = 128."""
    box = _align1024(TILE_ROWS * 4 * CHUNK)
    slot = _align1024(2 * box + 2 * CONV_K * (nt // 8) * SBO_BYTES)
    return (NARROW_STAGES if nt == 64 else WIDE_STAGES), slot


def stage_cluster(row_tiles: int) -> int:
    """The cluster of a stage launch (stage_cluster in conv_gn_mish.cuh): two
    CTAs that take row tiles 2q and 2q + 1 of one N tile and share its weight
    blocks, where there are two row tiles or more."""
    return STAGE_CLUSTER if row_tiles > 1 else 1


def stage_smem_bytes(nt: int, samples: int, groups: int) -> int:
    """Shared memory of a stage launch: 1,024 bytes to align the ring; the
    ring (``fwd_ring``); the rows' sums of each of the tile's ``groups``
    GroupNorm groups, 192 x groups floats; mean and rstd of ``samples`` x
    ``groups`` (sample, group) pairs; a full, an empty and an A-box barrier
    a ring slot; 16 bytes for a split tile's word that tells its consumers
    whether they finish it (the C side's stage_smem_bytes)."""
    stages, slot = fwd_ring(nt)
    return 1024 + stages * slot + 4 * TILE_ROWS * groups + 8 * samples * groups + 24 * stages + 16


def stage_split(items: int, chunks: int, clusters: int, split: bool = True) -> tuple[int, int, int]:
    """How a stage launch of ``items`` cluster items of ``chunks`` K chunks
    each goes over ``clusters`` clusters (stage_split in stage_ring.cuh):
    (tail, tail_clusters, max_parts). The first items - tail items run whole,
    round robin (as many full waves as there are); the last ``tail`` (the
    partial wave, or every item of a launch of fewer items than clusters)
    are cut, as one sequence of tail x chunks chunks, into
    ``tail_clusters`` contiguous ranges that differ by one chunk at most,
    one a cluster: a range's part of each item it meets is a part of that
    tile. ``max_parts``: the most parts of any item. No split (0, 0, 1)
    where a tile has one chunk, where no partial wave is left or without
    ``split``."""
    tail = items % clusters
    if not split or chunks < 2 * SPLIT_MIN_CHUNKS or tail == 0:
        return 0, 0, 1
    total = tail * chunks
    qt = min(clusters, tail * SPLIT_PARTS, total // SPLIT_MIN_CHUNKS)
    owner = lambda j: ((j + 1) * qt - 1) // total  # the range that holds chunk j
    parts = max(owner((i + 1) * chunks - 1) - owner(i * chunks) + 1 for i in range(tail))
    return tail, qt, parts


@dataclass(frozen=True)
class StagePlan:
    """The tiles of one stage launch: ``samples`` whole samples (``samples *
    T`` of the 192 rows) by ``n_tile`` output channels, which hold whole
    GroupNorm groups; ``smem_bytes`` of dynamic shared memory (the ring's
    slots: ``stage_smem_bytes``); ``grid`` = (row tiles, channel tiles);
    ``ctas`` persistent CTAs (at most one an SM) in clusters of ``cluster``.
    A cluster item is a row-tile pair i // grid[1] (rank r of the cluster
    takes row tile ``cluster`` * (i // grid[1]) + r, none past the last: the
    partner of an odd last row tile runs the item's ring and stores
    nothing) by channel tile i % grid[1], ``chunks`` K chunks of 8 input
    channels deep. Cluster q runs items q, q + clusters, .. below ``whole``
    whole, then its range of the split tail (``stage_split``:
    ``tail`` items, ``tail_clusters`` ranges, ``max_parts``); each part of a
    split tile stores its partial sums to a workspace slot and counts itself
    in, and the last to arrive sums the parts in part order and finishes the
    tile. The 1x1 projection runs whole in a tile's first part."""

    samples: int
    n_tile: int
    smem_bytes: int
    grid: tuple[int, int]
    ctas: int
    cluster: int = 1
    chunks: int = 1
    tail: int = 0
    tail_clusters: int = 0
    max_parts: int = 1

    @property
    def tiles(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def items(self) -> int:
        """Cluster items: row-tile groups of ``cluster`` x channel tiles."""
        return -(-self.grid[0] // self.cluster) * self.grid[1]

    @property
    def whole(self) -> int:
        """The items that run whole (all but the split tail)."""
        return self.items - self.tail

    @property
    def work_bytes(self) -> int:
        """The split tiles' workspace: a slot of 192 x n_tile partial sums per
        tail item, part and rank (the C side's stage_work_bytes)."""
        return self.tail * self.max_parts * self.cluster * TILE_ROWS * self.n_tile * 4

    @property
    def counters(self) -> int:
        """The split tiles' arrival counters: one per tail item and rank."""
        return self.tail * self.cluster

    def _owner(self, j: int) -> int:
        return ((j + 1) * self.tail_clusters - 1) // (self.tail * self.chunks)

    def item_parts(self, item: int) -> list[tuple[int, int]]:
        """The chunk ranges [c0, c1) of item ``item``'s parts, in part order
        (one range, all of K, for a whole item)."""
        if item < self.whole:
            return [(0, self.chunks)]
        i, total = item - self.whole, self.tail * self.chunks
        lo, hi = self._owner(i * self.chunks), self._owner((i + 1) * self.chunks - 1)
        return [(max(k * total // self.tail_clusters, i * self.chunks) - i * self.chunks,
                 min((k + 1) * total // self.tail_clusters, (i + 1) * self.chunks) - i * self.chunks)
                for k in range(lo, hi + 1)]

    def walk(self, cta: int, proj: bool = False) -> list[tuple[int, int, int, int, int, int]]:
        """The parts CTA ``cta`` runs, in order: (row tile, channel tile, c0,
        c1, part, parts), row tiles past the last included. Its whole items,
        then its range of the tail: the last item it meets first, or with
        the 1x1 projection (``proj``) in range order, so that part 0, which
        runs it, goes last (cluster_part in conv_gn_mish.cuh)."""
        cs, clusters = self.cluster, self.ctas // self.cluster
        q, r = divmod(cta, cs)
        tile = lambda i: (i // self.grid[1] * cs + r, i % self.grid[1])
        out = [(*tile(i), 0, self.chunks, 0, 1) for i in range(q, self.whole, clusters)]
        if q < self.tail_clusters:
            total = self.tail * self.chunks
            lo, hi = q * total // self.tail_clusters, (q + 1) * total // self.tail_clusters
            items = range(lo // self.chunks, (hi - 1) // self.chunks + 1)
            for i in (items if proj else reversed(items)):
                parts, k = self.item_parts(self.whole + i), q - self._owner(i * self.chunks)
                out.append((*tile(self.whole + i), *parts[k], k, len(parts)))
        return out

    def weight_bytes(self, C: int, K: int = CONV_K) -> int:
        """Bytes of weights [K, C, O] laid out for this tile: per N tile and
        chunk of input channels, the K taps' tf32 big and small planes."""
        return self.grid[1] * -(-C // CHUNK) * 2 * K * (self.n_tile // 8) * SBO_BYTES


@functools.lru_cache(maxsize=None)
def plan_stage(B: int, T: int, C: int, O: int, G: int, K: int = CONV_K,
               num_sms: int = H100_SMS, split: bool = True, cluster: int | None = None) -> StagePlan:
    """Tile plan for a Conv1d+GN+Mish stage over x [B, T, C] -> [B, T, O].

    Row tiles pair into clusters of ``stage_cluster`` CTAs (``cluster``
    overrides it) that share each N tile's weight blocks. The N tile is 64
    or 128 channels of whole groups (or all of O), whichever takes the
    fewer waves of cluster items over the ``num_sms`` SMs' clusters times a
    tile's width (a tile's work), the wide one on a tie; a tile whose launch
    would not fit the shared memory is not taken. The items of full waves
    run whole, the rest split by K chunks over every cluster (``split``;
    ``stage_split``), so the plan depends on C: a block's two stages are
    planned apart (the second's 1x1 projection runs whole in a tile's first
    part, on the same ring); they share the N tile, which does not depend on C."""
    if K != CONV_K:
        raise ValueError(f"the CUDA stage kernel takes K={CONV_K}, got K={K}")
    if T > TILE_ROWS:
        raise ValueError(f"the CUDA stage kernel takes T <= {TILE_ROWS}, got T={T}")
    if O % G:
        raise ValueError(f"O={O} not divisible by groups={G}")
    og = O // G
    samples = TILE_ROWS // T
    row_tiles = -(-B // samples)
    cs = cluster or stage_cluster(row_tiles)
    clusters = num_sms // cs
    smem = {nt: stage_smem_bytes(nt, samples, min(O, nt) // og) for nt in (64, 128)}
    fits = [nt for nt in (128, 64) if (O <= nt or nt % og == 0) and smem[nt] <= SMEM_MAX]
    if not fits:
        raise ValueError(f"no N tile of 64 or 128 channels holds whole groups of {og} channels "
                         f"within the shared memory at T={T}")
    items = {nt: -(-row_tiles // cs) * -(-O // nt) for nt in fits}
    n_tile = min(fits, key=lambda nt: -(-items[nt] // clusters) * nt)  # 128 first: it wins a tie
    chunks = -(-C // CHUNK)
    if clusters > 255 or clusters * clusters * chunks >= 2 ** 31:  # the C side's int walk
        raise ValueError(f"the CUDA stage kernel takes at most 255 clusters and C < {2 ** 34 // clusters ** 2}")
    tail, qt, parts = stage_split(items[n_tile], chunks, clusters, split)
    used = min(clusters, max(items[n_tile] - tail, qt))  # clusters with work
    plan = StagePlan(samples, n_tile, smem[n_tile], (row_tiles, -(-O // n_tile)), cs * used, cs,
                     chunks, tail, qt, parts)
    assert samples >= 1 and samples * T <= TILE_ROWS, plan
    assert O <= n_tile or n_tile % og == 0, plan
    return plan

class StageLaunch(ctypes.Structure):
    """One stage launch's plan as the C entries take it; mirrors
    ``cindm::StageLaunch`` in ``csrc/conv_gn_mish.cuh`` field for field
    (``load()`` checks its size): the plan's fields, then the split tiles'
    workspace and counters with their sizes."""

    _fields_ = ([(n, _I) for n in ("samples", "n_tile", "cluster", "smem_bytes", "ctas", "tail",
                                   "tail_clusters", "max_parts")]
                + [("work", _P), ("counters", _P), ("work_bytes", _L), ("n_counters", _I)])


def stage_launch(plan: StagePlan, work: torch.Tensor | None = None,
                 counters: torch.Tensor | None = None) -> StageLaunch:
    """``plan`` as a C entry takes it, with the workspace and counters of its
    split (``stage_work``; None where the plan splits nothing)."""
    return StageLaunch(plan.samples, plan.n_tile, plan.cluster, plan.smem_bytes, plan.ctas, plan.tail,
                       plan.tail_clusters, plan.max_parts, ptr(work), ptr(counters),
                       0 if work is None else 4 * work.numel(), 0 if counters is None else counters.numel())


class StageWork:
    """The split tiles' workspace and arrival counters, kept per device and
    stream and grown to the largest launch's (``StagePlan.work_bytes``,
    ``.counters``): the wrappers allocate them once, not per call. The
    counters are made zero once; every launch leaves them at 0 (the part
    that finishes a tile resets its counter), so no launch clears them.
    Launches on one stream run in order, so they share one set."""

    def __init__(self):
        self._kept: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, device: torch.device, *plans: StagePlan) -> tuple:
        """(workspace, counters) for a call whose launches run ``plans`` on
        ``device``'s current stream; (None, None) where none splits."""
        nbytes = max(p.work_bytes for p in plans)
        n = max(p.counters for p in plans)
        if n == 0:
            return None, None
        key = (device.index, torch.cuda.current_stream(device).cuda_stream)
        work, counters = self._kept.get(key, (None, None))
        if work is None or 4 * work.numel() < nbytes:
            work = torch.empty(-(-nbytes // 16) * 4, dtype=torch.float32, device=device)
        if counters is None or counters.numel() < n:
            counters = torch.zeros(n, dtype=torch.int32, device=device)
        self._kept[key] = (work, counters)
        return work, counters

    def counters(self) -> list[torch.Tensor]:
        """Every kept set of counters (all 0 between launches)."""
        return [c for _, c in self._kept.values()]


stage_work = StageWork()  # the forward wrappers' workspace and counters


# The backward's tiles (csrc/conv_backward.cuh); they mirror its constants.
WG_TILE = 64  # input and output channels of a wgrad work item
WG_ROWS = 64  # rows of one wgrad ring stage
WG_ROWS_T3 = 48  # at T = 3: 16 whole samples, in position-major order
WG_STAGES = 4  # stages in wgrad's ring
WG_HALO = CONV_K // 2  # activation rows either side of a stage that its taps reach
WG_MIN_STAGES = 4  # a split of a job's rows runs at least this many ring stages
# ... and at most this many rows: the error of a weight gradient grows with
# the rows one accumulator sums (on an H100, dwres of 256 -> 128 at T = 12
# in one run: 6,144 rows at batch 512 ended 5.3e-5 of its largest entry
# from the float64 plain path, 64,512 at batch 5,376 4.7e-4, where fp32
# plain is 7e-7 off). Runs of 4,096 rows leave no split at batch 512 but
# that dwres's (2 runs of 3,072); grad_reduce adds a job's runs in order.
WG_MAX_RUN_ROWS = 4096
COL_PARTS = 7  # kinds of column partials of the block: dgs2, dgb2, db2, dbres, dgs1, dgb1, db1
# The dgrads run the stage's main loop (stage_ring), K split over a cluster
# of one of CLUSTER_SIZES CTAs.
CLUSTER_SIZES = (1, 2, 3, 4)
DG_MIN_STAGES = 2  # each rank of a cluster runs at least this many ring stages
# gn_mish_bwd (csrc/conv_backward.cuh): at most GN_PAIRS (sample, group)
# pairs a CTA, GN_WARP_PAIRS a warp; an N tile at least GN_LINE channels (a
# 128-byte line) wide where the groups allow; GN_KINDS kinds of column partials.
GN_PAIRS = 16
GN_WARP_PAIRS = 2
GN_LINE = 32
GN_KINDS = 4
# grad_reduce (csrc/conv_backward.cuh): REDUCE_THREADS threads a CTA, each
# REDUCE_VEC float4 columns of an item; a ring of REDUCE_STAGES stages of
# REDUCE_STAGE_BYTES, filled by TMA boxes of at most REDUCE_BOX columns and
# slices; a launch cut into at least REDUCE_ITEMS items (one an SM of the
# H100) where its bytes allow, walked by at most 2 CTAs an SM.
REDUCE_JOBS = 10
REDUCE_THREADS = 256
REDUCE_VEC = 2
REDUCE_STAGES = 2
REDUCE_STAGE_BYTES = 49152
REDUCE_ITEMS = H100_SMS
REDUCE_BOX = 256
REDUCE_MAX_WIDTH = 4 * REDUCE_VEC * REDUCE_THREADS


def wgrad_smem_bytes() -> int:
    """wgrad's ring, per stage two boxes of activation rows (the stage's 64
    rows and a halo of 2 either side, 32 channels of 128 bytes a row, each
    box in a slot of whole 1,024-byte swizzle periods) and the cotangent's
    big and small planes of 64 channels per k8 step; 1,024 bytes to align
    the ring; the full and empty barriers."""
    box = -(-(WG_ROWS + 2 * WG_HALO) * 128 // 1024) * 1024
    b_bytes = WG_ROWS // 8 * 2 * WG_TILE * 8 * 4
    return 1024 + WG_STAGES * (2 * box + b_bytes) + 2 * WG_STAGES * 8


def wgrad_stage_rows(T: int) -> int:
    """Rows of one wgrad ring stage at sample length T."""
    return WG_ROWS_T3 if T == 3 else WG_ROWS


def wgrad_operand_bytes(R: int, O: int, T: int) -> int:
    """Bytes of a cotangent [R, O] in wgrad's operand layout: per tile of 64
    channels and group of 8 K positions a tf32 big and a small block of 512
    words; at T = 3 the groups fill whole stages of 48 rows."""
    groups = -(-R // WG_ROWS_T3) * (WG_ROWS_T3 // 8) if T == 3 else -(-R // 8)
    return -(-O // WG_TILE) * groups * 2 * 512 * 4


def gn_stride(nt: int) -> int:
    """Floats between the rows of gn_mish_bwd's staged tiles of ``nt``
    channels: 16 modulo 32, so that the operand writer's reads fall on
    distinct banks."""
    return (nt + 15) // 32 * 32 + 16


def gn_bwd_smem_bytes(nt: int, samples: int, T: int, planes: int) -> int:
    """gn_mish_bwd: ``planes`` staged tiles of ``samples`` x T rows (dz for
    wgrad's operand, and g where the block writes gw), then the pairs'
    column sums, GN_KINDS x samples x nt."""
    return 4 * (planes * samples * T * gn_stride(nt) + GN_KINDS * samples * nt)


def gn_lane_floats(og: int) -> int:
    """The channels a lane of gn_mish_bwd loads at once for groups of
    ``og``: 2 for an even og up to 64 (a pair of the training shapes then
    fills every lane), else 1 up to 32, else 4 up to 128 (0: none fits)."""
    return next((v for v in (2, 1, 4) if og % v == 0 and og <= 32 * v), 0)


def gn_tile(B: int, T: int, O: int, G: int, planes: int,
            num_sms: int = H100_SMS) -> tuple[int, int, int]:
    """gn_mish_bwd's tile: (channels nt, groups a tile gpt, samples a tile).
    nt holds whole groups, at least GN_LINE channels where G allows, and is a
    multiple of 8 (whole n8 blocks of wgrad's operand layout) unless it
    spans O; GN_PAIRS // gpt samples, fewer where the shared memory would
    keep two CTAs off one SM or the grid would leave an SM without one."""
    og = O // G
    if not gn_lane_floats(og):
        raise ValueError(f"gn_mish_bwd takes groups of at most 32 channels, 64 of an even count or "
                         f"128 of a multiple of 4, got {og}")
    m = 8 // math.gcd(og, 8)  # groups whose channels make a multiple of 8
    gpt = min(-(-GN_LINE // (m * og)) * m, GN_PAIRS, G)
    nt = gpt * og
    ctiles = -(-O // nt)
    samples = max(1, GN_PAIRS // gpt)
    while samples > 1 and (gn_bwd_smem_bytes(nt, samples, T, planes) > SMEM_MAX // 2
                           or -(-B // samples) * ctiles < num_sms):
        samples -= 1
    return nt, gpt, samples


def dgrad_gn_smem_bytes(nt: int, samples: int, cs: int) -> int:
    """dgrad_gn_stage: 1,024 bytes to align the ring; region 0, the ring,
    which after the main loop holds the CTA's partial tile, then the column
    sums of its GroupNorm backward (3 kinds x a rank's samples, of
    ``samples`` over a cluster of ``cs``, x nt); the rank's summed share of
    the tile; two barriers a stage."""
    _, stages, ring = stage_ring(nt)
    return (1024 + max(ring, _tile_bytes(nt), 12 * -(-samples // cs) * nt) + _tile_bytes(nt)
            + 16 * stages)


def dgrad_x_smem_bytes() -> int:
    """dgrad_x_stage (N tile 64): the aligned ring, which then holds the
    partial tile, and the barriers."""
    _, stages, ring = stage_ring(64)
    return 1024 + max(ring, _tile_bytes(64)) + 16 * stages


def default_cluster_limits(num_sms: int = H100_SMS) -> tuple[int, ...]:
    """Clusters of each of CLUSTER_SIZES that a card of ``num_sms`` SMs runs
    at once, one CTA an SM, where the card has not been asked
    (``cluster_limits`` asks it)."""
    return tuple(num_sms // cs for cs in CLUSTER_SIZES)


def dgrad_cluster(grid: int, stages: int, limits: tuple[int, ...]) -> int:
    """The cluster size of a dgrad launch of ``grid`` tiles whose K is
    ``stages`` ring stages: the largest whose clusters all run at once
    (``limits``: at most one wave) and leave every rank DG_MIN_STAGES
    stages; 1 when the tiles alone fill a wave or more."""
    cs = 1
    for size, limit in zip(CLUSTER_SIZES, limits):
        if grid <= limit and stages >= DG_MIN_STAGES * size:
            cs = size
    return cs


def staged_weight_bytes(nt: int, C: int, O: int, K: int = CONV_K) -> int:
    """Bytes of a conv C -> O's weights laid out for N tiles of ``nt``."""
    return -(-O // nt) * -(-C // CHUNK) * 2 * K * (nt // 8) * SBO_BYTES


def reduce_width(total: int, n: int, slices: int) -> int:
    """grad_reduce's columns an item for a job of ``n`` columns over
    ``slices`` in a launch whose jobs read ``total`` bytes: at most total /
    REDUCE_ITEMS bytes an item (the launch then has at least REDUCE_ITEMS
    items, one an SM, wherever its bytes allow) in whole float4 columns, at
    most REDUCE_MAX_WIDTH, what a ring stage holds of all the slices and n,
    at least 4; past one TMA box, whole boxes (the C side's reduce_width)."""
    target = total // REDUCE_ITEMS // (16 * slices) * 4
    fit = REDUCE_STAGE_BYTES // (16 * slices) * 4
    w = max(4, min(target, fit, REDUCE_MAX_WIDTH, n))
    return w // REDUCE_BOX * REDUCE_BOX if w > REDUCE_BOX else w


def reduce_run(slices: int, width: int) -> int:
    """Slices of an item of ``width`` columns that one ring stage, and one
    TMA box, holds."""
    return min(slices, REDUCE_STAGE_BYTES // (4 * width), REDUCE_BOX)


def reduce_box(width: int) -> int:
    """Columns of one TMA box of an item of ``width`` columns."""
    return min(width, REDUCE_BOX)


@dataclass(frozen=True)
class ReducePlan:
    """grad_reduce's launch: ``jobs`` (n, slices) in launch order, each cut
    into items of ``widths`` columns over all its slices (the last item of
    a job ragged), the job's first item in ``item0``; ``items`` in all,
    walked round-robin by ``grid`` CTAs."""

    jobs: tuple[tuple[int, int], ...]
    widths: tuple[int, ...]
    item0: tuple[int, ...]
    items: int
    grid: int


def plan_reduce(jobs, num_sms: int = H100_SMS) -> ReducePlan:
    """grad_reduce's plan for ``jobs`` [(n, slices), ...]: dst[i] = sum over
    s of src[s n + i] for each. Each job is cut into items of whole float4
    columns over all its slices, at least REDUCE_ITEMS in all where the
    bytes allow (every SM gets an item), each item's slab within a ring
    stage; at most 2 CTAs an SM walk them (the training shapes' narrow
    launches in one round)."""
    jobs = tuple((int(n), int(s)) for n, s in jobs)
    if not 1 <= len(jobs) <= REDUCE_JOBS:
        raise ValueError(f"grad_reduce takes 1 to {REDUCE_JOBS} jobs, got {len(jobs)}")
    if any(n <= 0 or n % 4 or s <= 0 for n, s in jobs):
        raise ValueError(f"grad_reduce takes jobs of a multiple of 4 columns over 1 or more slices: {jobs}")
    total = sum(4 * n * s for n, s in jobs)
    widths = tuple(reduce_width(total, n, s) for n, s in jobs)
    item0, items = [], 0
    for (n, _), w in zip(jobs, widths):
        item0.append(items)
        items += -(-n // w)
    return ReducePlan(jobs, widths, tuple(item0), items, min(items, 2 * num_sms))


@dataclass(frozen=True)
class BackwardPlan:
    """The launches of one block's backward (``rtb``) or the head's.

    ``samples`` whole samples per row tile (``row_tiles`` of them), as in the
    forward, for the dgrads; ``gn_mish_bwd`` tiles its own rows:
    ``gn_samples`` whole samples (``gn_tiles`` row tiles) x ``nt_gn``
    channels on ``gn_threads`` threads (a warp GN_WARP_PAIRS (sample, group)
    pairs), a grid
    of ``grid_gn`` CTAs and ``smem_gn`` bytes; ``nt_d2``/``smem_d2``
    the dgrad of conv2 with the first GroupNorm's backward (the block only),
    its K split over clusters of ``cs_d2`` CTAs on a grid of ``grid_d2``
    CTAs; ``nt_d1``/``smem_d1``/``cs_d1``/``grid_d1`` the dgrad to x.
    wgrad's work items are 64 x 64
    channel tiles of a job (dw1, dw2, dwres) over a run of rows:
    ``splits``/``sps`` cut each job's rows into ``splits`` runs of ``sps``
    ring stages of ``wgrad_stage_rows(T)`` rows (1: one run over every row,
    written to the gradient itself); ``wgrad_items`` items walked by a
    persistent grid of ``wgrad_grid`` blocks. ``reduce``: grad_reduce's
    plan over the split jobs' partials and the column partials (None
    without weight gradients). The byte counts size the scratch the wrapper
    allocates: the staged weights, the split jobs' partials, the column
    partials, and each cotangent in wgrad's operand layout (``wop_bytes``;
    dz1, and dz2 and g for the block)."""

    samples: int
    row_tiles: int
    gn_samples: int
    gn_tiles: int
    gn_threads: int
    grid_gn: tuple[int, int]
    nt_gn: int
    smem_gn: int
    nt_d2: int
    smem_d2: int
    nt_d1: int
    smem_d1: int
    cs_d2: int
    cs_d1: int
    grid_d2: tuple[int, int]
    grid_d1: tuple[int, int]
    wgrad_jobs: tuple[tuple[int, int, int], ...]  # (input channels, taps, tiles) per job
    splits: tuple[int, ...]
    sps: tuple[int, ...]
    wgrad_smem: int
    wgrad_items: int
    wgrad_grid: int
    wstage_bytes: int
    wpart_bytes: int
    colpart_bytes: int
    wop_bytes: int
    reduce: ReducePlan | None


def plan_backward(B: int, T: int, C: int, O: int, G: int, proj: bool, rtb: bool = True,
                  want_dx: bool = True, num_sms: int = H100_SMS,
                  want_w: bool = True, clusters: tuple[int, ...] | None = None) -> BackwardPlan:
    """Tile plan of the backward of a block C -> O (``rtb``: the fused RTB,
    with a 1x1 projection if ``proj``; else the head Conv1d+GN+Mish).
    Without ``want_w`` wgrad does not run and its partials take no bytes.
    ``clusters``: how many clusters of each of CLUSTER_SIZES the card runs
    at once (default: ``default_cluster_limits(num_sms)``)."""
    clusters = clusters or default_cluster_limits(num_sms)
    if T > TILE_ROWS:
        raise ValueError(f"the CUDA backward takes T <= {TILE_ROWS}, got T={T}")
    if O % G:
        raise ValueError(f"O={O} not divisible by groups={G}")
    og = O // G
    samples = TILE_ROWS // T
    row_tiles = -(-B // samples)

    def whole(nt: int) -> bool:
        return O <= nt or nt % og == 0

    # gn_mish_bwd: memory-bound, a warp two (sample, group) pairs, tiles small
    # enough that every SM gets a CTA; dz (and g on a projection block)
    # staged for wgrad's operand layout
    planes = (2 if rtb and proj else 1) if want_w else 0
    nt_gn, gpt_gn, gn_samples = gn_tile(B, T, O, G, planes, num_sms)
    gn_tiles = -(-B // gn_samples)
    smem_gn = gn_bwd_smem_bytes(nt_gn, gn_samples, T, planes)
    # the dgrads: an N tile of 64 (of whole groups for dgrad_gn_stage, else
    # 128), K split over the largest cluster whose clusters run in one wave
    nt_d2 = smem_d2 = cs_d2 = 0
    grid_d2 = (0, 0)
    if rtb:
        if not (whole(64) or whole(128)):
            raise ValueError(f"no N tile of 64 or 128 channels holds whole groups of {og} channels")
        nt_d2 = 64 if whole(64) else 128
        ch = stage_ring(nt_d2)[0]
        cs_d2 = dgrad_cluster(row_tiles * -(-O // nt_d2), -(-O // (CHUNK * ch)), clusters)
        smem_d2 = dgrad_gn_smem_bytes(nt_d2, samples, cs_d2)
        grid_d2 = (row_tiles * cs_d2, -(-O // nt_d2))
    nt_d1, smem_d1 = 64, dgrad_x_smem_bytes()
    cs_d1 = dgrad_cluster(row_tiles * -(-C // 64), -(-O // (CHUNK * stage_ring(64)[0])), clusters)
    grid_d1 = (row_tiles * cs_d1, -(-C // 64))
    jobs = [(C, CONV_K)] + ([(O, CONV_K)] if rtb else []) + ([(C, 1)] if rtb and proj else [])
    wgrad_jobs = [(Ca, taps, -(-Ca // WG_TILE) * -(-O // WG_TILE)) for Ca, taps in jobs]
    # Split a job's rows where the items would leave SMs idle: with each
    # SM's fair share of the work (tiles x taps x stages), a job is cut into
    # as many splits as its item holds shares, none shorter than
    # WG_MIN_STAGES stages; and where a run would pass WG_MAX_RUN_ROWS rows.
    stages = -(-B * T // wgrad_stage_rows(T))
    share = sum(tiles * taps for _, taps, tiles in wgrad_jobs) * stages / num_sms
    splits, sps, items, wpart = [], [], 0, 0
    for Ca, taps, tiles in wgrad_jobs:
        n = max(1, min(int(taps * stages / share), stages // WG_MIN_STAGES),
                -(-stages // (WG_MAX_RUN_ROWS // wgrad_stage_rows(T))))
        per = -(-stages // n)
        n = -(-stages // per)
        splits.append(n)
        sps.append(per)
        items += tiles * n
        wpart += n * taps * Ca * O * 4 if want_w and n > 1 else 0
    wstage = ((staged_weight_bytes(nt_d2, O, O) if rtb else 0)
              + (staged_weight_bytes(nt_d1, O, C) if want_dx else 0)
              + (staged_weight_bytes(nt_d1, O, C, K=1) if want_dx and rtb and proj else 0))
    # column partials: per gn_mish_bwd row tile 4 kinds of the last GroupNorm
    # (3 for the head), then per row tile and rank 3 kinds of dgrad_gn_stage's
    colpart = ((4 * gn_tiles + 3 * cs_d2 * row_tiles) if rtb else 3 * gn_tiles) * O * 4
    # grad_reduce's jobs in the launch's order: the split gradients, then the
    # column kinds (dgs, dgb, db, dbres of the last GroupNorm; dgs, dgb, db of
    # the first)
    kinds = [gn_tiles] * (4 if rtb and proj else 3) + ([cs_d2 * row_tiles] * 3 if rtb else [])
    reduce = plan_reduce([(taps * Ca * O, n) for (Ca, taps, _), n in zip(wgrad_jobs, splits) if n > 1]
                         + [(O, s) for s in kinds], num_sms) if want_w else None
    plan = BackwardPlan(
        samples, row_tiles, gn_samples, gn_tiles, 32 * -(-gn_samples * gpt_gn // GN_WARP_PAIRS),
        (gn_tiles, -(-O // nt_gn)), nt_gn, smem_gn, nt_d2, smem_d2, nt_d1, smem_d1, cs_d2, cs_d1, grid_d2,
        grid_d1, tuple(wgrad_jobs), tuple(splits), tuple(sps), wgrad_smem_bytes(), items,
        min(items, num_sms), wstage, wpart, colpart,
        wgrad_operand_bytes(B * T, O, T) if want_w else 0, reduce)
    if max(plan.smem_gn, plan.smem_d2, plan.smem_d1, plan.wgrad_smem) > SMEM_MAX:
        raise ValueError(f"a backward tile of T={T} does not fit the shared memory of one block: {plan}")
    return plan


class BackwardArgs(ctypes.Structure):
    """The backward entries' argument block; mirrors ``BlockBwdArgs`` in
    ``csrc/block_backward.cu`` field for field (``load()`` checks its size)."""

    _fields_ = (
        [(n, _P) for n in (
            "x", "w1", "gs1", "gb1", "w2", "gs2", "gb2", "wres", "g", "h", "z1", "mean1",
            "rstd1", "z2", "mean2", "rstd2",
            "dx", "dtemb", "dw1", "db1", "dgs1", "dgb1", "dw2", "db2", "dgs2", "dgb2", "dwres",
            "dbres",
            "dz1", "dz2", "dz1w", "dz2w", "gw", "wstage", "wpart", "colpart")]
        + [(n, _L) for n in ("wstage_bytes", "wpart_bytes", "colpart_bytes", "wop_bytes")]
        + [(n, _I) for n in ("B", "T", "C", "O", "G", "samples", "gn_samples", "gn_tiles", "nt_gn",
                             "smem_gn", "nt_d2", "smem_d2", "nt_d1", "smem_d1", "cs_d2", "cs_d1",
                             "wg_grid")]
        + [("splits", _I * 3), ("sps", _I * 3), ("rd_width", _I * REDUCE_JOBS), ("rd_items", _I),
           ("rd_grid", _I)]
    )


class ReduceJob(ctypes.Structure):
    """One job of ``ReduceArgs``; mirrors ``cindm::ReduceJob``."""

    _fields_ = [("src", _P), ("dst", _P), ("n", _I), ("slices", _I), ("width", _I), ("item0", _I)]


class ReduceArgs(ctypes.Structure):
    """grad_reduce's argument block; mirrors ``cindm::ReduceArgs`` in
    ``csrc/conv_backward.cuh`` (``load()`` checks its size)."""

    _fields_ = [("job", ReduceJob * REDUCE_JOBS), ("njobs", _I), ("nitems", _I)]


_lib = None
build_seconds = None  # wall time of the build done by this process, None if cached


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _cuda_tool(name: str) -> str | None:
    """A CUDA toolkit program on PATH or under $CUDA_HOME/bin (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which(name), os.path.join(cuda_home, "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = _cuda_tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin (default /usr/local/cuda)")
    return nvcc


def build() -> Path:
    """Compile and link the kernels unless this source hash is already built."""
    global build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="tmp-") as tmp:
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [Path(tmp) / (p.stem + ".o") for p in cus]
        procs = [
            subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cus, objs)
        ]
        logs = []
        for src, p in zip(cus, procs):
            try:
                out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                raise
            logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if lib.cindm_block_backward_args_size() != ctypes.sizeof(BackwardArgs):
            raise RuntimeError("BackwardArgs does not match the C structure BlockBwdArgs")
        if lib.cindm_reduce_args_size() != ctypes.sizeof(ReduceArgs):
            raise RuntimeError("ReduceArgs does not match the C structure cindm::ReduceArgs")
        if lib.cindm_stage_launch_size() != ctypes.sizeof(StageLaunch):
            raise RuntimeError("StageLaunch does not match the C structure cindm::StageLaunch")
        if lib.cindm_resample_launch_size() != ctypes.sizeof(ResampleLaunch):
            raise RuntimeError("ResampleLaunch does not match the C structure cindm::ResampleLaunch")
        _lib = lib
    return _lib


def ptxas_report() -> str:
    """Register / shared-memory / spill lines (and ptxas's notes: C75xx, a
    serialized or fenced wgmma pipeline) from the last build's log."""
    log = BUILD_ROOT / source_hash() / "build.log"
    if not log.exists():
        return ""
    keep = ("Compiling entry", "registers", "spill", "Performance", "(C75")
    return "\n".join(l for l in log.read_text().splitlines() if any(k in l for k in keep))


def ptxas_kernel(name: str) -> dict | str:
    """Registers and spill bytes of the kernels whose mangled name holds
    ``name`` (e.g. ``5wgrad``), from the last build's ptxas report."""
    out, fn = {}, None
    for line in ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if name in m.group(1) else None
            if fn:
                out[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[fn]["registers"] = int(m.group(1))
    return out or "not measured: no ptxas report"


def sass_mma_counts() -> dict[str, dict[str, int]] | str:
    """Tensor-core instructions per kernel in the built library's SASS, as
    ``cuobjdump -sass`` lists them: HGMMA (wgmma) and HMMA (mma.sync)."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return "not measured: no cuobjdump"
    out = subprocess.run([tool, "-sass", str(build())], capture_output=True, text=True,
                         timeout=300)
    if out.returncode:
        return f"not measured: cuobjdump failed ({out.stderr.strip()[:200]})"
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    return counts


def check_inputs(kernel: str, device: torch.device, **tensors) -> None:
    """Raise unless every (tensor, shape) pair is float32, contiguous, on ``device``."""
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, x is on {device}")
        if t.shape != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def check_rows(kernel: str, device: torch.device, name: str, t: torch.Tensor, shape: tuple) -> int:
    """Raise unless ``t`` is a float32 [rows, n] matrix of ``shape`` on
    ``device`` whose rows are contiguous and a multiple of 4 floats apart (a
    view of columns of a wider matrix, read by 16-byte pieces); returns the
    floats between its rows."""
    if t.dtype != torch.float32:
        raise TypeError(f"{kernel}: {name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, x is on {device}")
    if t.shape != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    ld = t.stride(0) if t.shape[0] > 1 else shape[1]
    if t.stride(1) != 1 or ld < shape[1]:
        raise ValueError(f"{kernel}: {name} must have contiguous rows, got strides {t.stride()}")
    if device.type == "cuda" and ld % 4:
        raise ValueError(f"{kernel}: {name}'s rows must lie a multiple of 4 floats apart, got {ld}")
    return ld


def check_channels(kernel: str, **channels: int) -> None:
    """Raise unless every channel count is a multiple of 4: the kernels read
    rows of their inputs and weights in 16-byte pieces."""
    for name, n in channels.items():
        if n % 4:
            raise ValueError(f"{kernel}: {name}={n} must be a multiple of 4 on CUDA")


def check_aligned(kernel: str, **tensors: torch.Tensor | None) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (16-byte reads)."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


# The attention kernel's plan (csrc/linear_attention.cu mirrors these)
ATTN_ROWS = 128  # rows of a row tile (two consumer warpgroups x 64): ATTN_ROWS // T whole samples
ATTN_MAX_T = 96  # the longest sample the kernel takes
ATTN_C_MULTIPLE = 16  # C in multiples of this: the out product's column pairs
ATTN_HIDDEN = 128  # heads x dim_head
ATTN_QKV_NT = 128  # the N tile of wqkv's layout (stage_weights, K = 1): q, k, v one each
ATTN_OUT_NT = 64  # and of wout's
ATTN_STAGES = 6  # the weight ring's slots
ATTN_SLOT_BYTES = 32768  # a slot: both warpgroups' xn planes and wqkv's chunk, or 6 wout chunks
ATTN_HEAD_COLS = 36  # columns of a head's q, k or v in the q | k | v tile (32 + 4: distinct banks)
ATTN_QKV_STRIDE = 3 * 4 * ATTN_HEAD_COLS + 4  # floats a row of that tile (436), in the ring's bytes
ATTN_BARRIERS = 2 * ATTN_STAGES + 5  # full and empty a slot, two each for the statistics, rfree


def attention_smem_bytes() -> int:
    """Dynamic shared memory of the attention kernel, the same at every C and
    T: the weight ring (ATTN_STAGES slots), whose bytes the q | k | v tile
    [128][436] takes between the products, two buffers of LayerNorm
    statistics [128] (mean, rstd) and the mbarriers."""
    region = max(ATTN_STAGES * ATTN_SLOT_BYTES, 4 * ATTN_ROWS * ATTN_QKV_STRIDE)
    return region + 2 * ATTN_ROWS * 8 + 8 * ATTN_BARRIERS


def attention_weight_bytes(C: int) -> int:
    """Bytes of one block's laid-out weights, wqkv [C, 384] and wout [128,
    C] (both planes): what a row tile reads from L2."""
    return (staged_weight_bytes(ATTN_QKV_NT, C, 3 * ATTN_HIDDEN, K=1)
            + staged_weight_bytes(ATTN_OUT_NT, ATTN_HIDDEN, C, K=1))


@dataclass(frozen=True)
class AttentionPlan:
    """One attention launch: row tiles of ``samples`` whole samples
    (``rows`` of ATTN_ROWS used), walked by ``ctas`` persistent CTAs (one an
    SM at most) in clusters of ``cluster`` (1: every CTA loads its own
    weights); ``weight_bytes``: the laid-out weights read from L2 over the
    launch, once a tile."""

    samples: int
    rows: int
    tiles: int
    ctas: int
    cluster: int
    smem_bytes: int
    weight_bytes: int


@functools.lru_cache(maxsize=None)
def plan_attention(B: int, T: int, C: int, num_sms: int = H100_SMS) -> AttentionPlan:
    """The attention kernel's launch at batch B (the C entry recomputes the
    tiles and checks the CTAs)."""
    check_attention(C, T)
    samples = ATTN_ROWS // T
    tiles = -(-B // samples)
    return AttentionPlan(samples=samples, rows=samples * T, tiles=tiles, ctas=max(1, min(tiles, num_sms)),
                         cluster=1, smem_bytes=attention_smem_bytes(),
                         weight_bytes=tiles * attention_weight_bytes(C))


def check_attention(C: int, T: int) -> None:
    """Raise unless the attention kernel takes C channels over T steps."""
    if C % ATTN_C_MULTIPLE or C <= 0:
        raise ValueError(f"prenorm_linear_attention: C={C} must be a positive multiple of "
                         f"{ATTN_C_MULTIPLE} on CUDA")
    if not 0 < T <= ATTN_MAX_T:
        raise ValueError(f"prenorm_linear_attention: T={T} must lie in 1..{ATTN_MAX_T} on CUDA")
    if attention_smem_bytes() > SMEM_MAX:
        raise ValueError(f"prenorm_linear_attention: the kernel needs {attention_smem_bytes()} bytes "
                         f"of shared memory, over {SMEM_MAX}")


# The resampling kernel's ring (csrc/resample.cu mirrors these): a slot of
# one chunk's box in two tf32 planes and its weight blocks of RES_TAPS taps.
# The last partial wave is split where an item has RES_SPLIT_MIN_CHUNKS
# chunks or more.
RES_TAPS = 2
RES_SPLIT_MIN_CHUNKS = 32


def resample_ring(nt: int) -> tuple[int, int]:
    """The resampling kernel's ring at N tile ``nt`` (ResRing): (slots,
    bytes of a slot). A slot is the box's 192 rows of one chunk in two tf32
    planes, then the chunk's weight blocks; as many slots as the shared
    memory holds beside a full, an empty and an A-box barrier each and the
    split's word."""
    plane = _align1024(TILE_ROWS * 4 * CHUNK)
    slot = _align1024(2 * plane + 2 * RES_TAPS * (nt // 8) * SBO_BYTES)
    return (SMEM_MAX - 1024 - 16) // (slot + 24), slot


def resample_smem_bytes(nt: int) -> int:
    """Dynamic shared memory of a resampling launch at N tile ``nt``: 1,024
    bytes to align the ring, its slots, a full, an empty and an A-box
    barrier a slot, 16 bytes for the split tiles' word."""
    stages, slot = resample_ring(nt)
    return 1024 + stages * (slot + 24) + 16


@dataclass(frozen=True)
class ResamplePlan:
    """One resampling launch: the GEMM's rows are ``rows`` a sample (up: x's
    T; down: T / 2, x read as [B, T / 2, 2C]), tiles of ``samples`` whole
    samples (``row_tiles`` of them) by ``n_tile`` output channels (``n_tiles``:
    up's even then odd halves, 2 ceil(C / n_tile); down's ceil(C /
    n_tile)); cluster items of ``cluster`` row tiles by an N tile, each
    ``stages`` ring stages of one chunk deep (up: C's; down: x2's first C,
    then its last), walked by ``ctas`` persistent CTAs (one an SM at most)
    of a device of ``num_sms`` SMs. The last ``tail`` items (the partial
    wave) are split by K stages into ``tail_clusters`` ranges, one a cluster
    (``stage_split``; ``max_parts`` the most parts of an item)."""

    up: bool
    rows: int
    samples: int
    row_tiles: int
    n_tile: int
    n_tiles: int
    cluster: int
    items: int
    ctas: int
    smem_bytes: int
    stages: int
    num_sms: int
    tail: int
    tail_clusters: int
    max_parts: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.n_tiles

    @property
    def work_bytes(self) -> int:
        """The split tiles' workspace: a slot of 192 x n_tile partial sums per
        tail item, part and rank."""
        return self.tail * self.max_parts * self.cluster * TILE_ROWS * self.n_tile * 4

    @property
    def counters(self) -> int:
        """The split tiles' arrival counters: one per tail item and rank."""
        return self.tail * self.cluster

    def _walk(self) -> StagePlan:
        """The walk as the stage's plan has it (K in ring stages)."""
        return StagePlan(self.samples, self.n_tile, self.smem_bytes, (self.row_tiles, self.n_tiles), self.ctas,
                         self.cluster, self.stages, self.tail, self.tail_clusters, self.max_parts)

    def item_parts(self, item: int) -> list[tuple[int, int]]:
        """The ring-stage ranges [k0, k1) of item ``item``'s parts, in part order."""
        return self._walk().item_parts(item)

    def walk(self, cta: int) -> list[tuple[int, int, int, int, int, int]]:
        """The parts CTA ``cta`` runs, in order: (row tile, N tile, k0, k1,
        part, parts); its range of the tail the last item first (walk_part)."""
        return self._walk().walk(cta)

    def weight_bytes(self, C: int) -> int:
        """Bytes of the laid-out weights: up two blocks of 2 taps, down one of
        2 taps and one of 1, each C x C in N tiles of ``n_tile``."""
        taps = 2 * RES_TAPS if self.up else RES_TAPS + 1
        return -(-C // self.n_tile) * -(-C // CHUNK) * 2 * taps * (self.n_tile // 8) * SBO_BYTES


def resample_plan_at(B: int, T: int, C: int, up: bool, nt: int, num_sms: int = H100_SMS) -> ResamplePlan:
    """The resampling kernel's launch for x [B, T, C] at N tile ``nt`` (64 or
    128; the C entry recomputes the rest from B, T, C, up, the N tile and
    ``num_sms`` and refuses a plan that differs): row tiles pair into
    clusters of 2 that share an N tile's weight blocks; the last partial
    wave is split by K (``stage_split``) where an item has
    RES_SPLIT_MIN_CHUNKS chunks of 8 channels or more (kResSplitMinChunks).
    Raises on what the kernel does not take: C not a multiple of 4, an odd
    T for down, more than 192 rows a sample."""
    kind = "upsample1d" if up else "downsample1d"
    if B <= 0 or C <= 0 or C % 4:
        raise ValueError(f"{kind}: the CUDA kernel takes B > 0 and C a positive multiple of 4, got B={B}, C={C}")
    if not up and T % 2:
        raise ValueError(f"downsample1d: the CUDA kernel takes an even T, got T={T}")
    rows = T if up else T // 2
    if not 0 < rows <= TILE_ROWS:
        raise ValueError(f"{kind}: the CUDA kernel takes 1 to {TILE_ROWS} rows a sample, got T={T}")
    if B * rows * 2 * C >= 2 ** 31:
        raise ValueError(f"{kind}: the CUDA kernel takes fewer than 2^31 elements, got {B} x {rows} x {2 * C}")
    samples = TILE_ROWS // rows
    row_tiles = -(-B // samples)
    cs = stage_cluster(row_tiles)
    clusters = num_sms // cs
    halves = 2 if up else 1
    items = -(-row_tiles // cs) * halves * -(-C // nt)
    stages = -(-C // CHUNK) * (1 if up else 2)  # a chunk a ring stage; down: x2's first C, then its last
    if not 0 < clusters <= 255 or clusters * clusters * stages >= 2 ** 31:  # the C side's int walk
        raise ValueError(f"{kind}: the CUDA kernel takes 1 to 255 clusters and fewer than "
                         f"{2 ** 31 // clusters ** 2} ring stages an item, got {stages}")
    tail, qt, parts = stage_split(items, stages, clusters, stages >= RES_SPLIT_MIN_CHUNKS)
    used = min(clusters, max(items - tail, qt))  # clusters with work
    return ResamplePlan(up, rows, samples, row_tiles, nt, halves * -(-C // nt), cs, items, cs * used,
                        resample_smem_bytes(nt), stages, num_sms, tail, qt, parts)


@functools.lru_cache(maxsize=None)
def plan_resample(B: int, T: int, C: int, up: bool, num_sms: int = H100_SMS) -> ResamplePlan:
    """The resampling kernel's launch for x [B, T, C] (``resample_plan_at``)
    at an N tile of 64 or 128 channels. Where full waves of items run at N
    tile 128 and the last wave is split (items of RES_SPLIT_MIN_CHUNKS
    chunks or more), the one that pads C less: a wide tile reads and splits
    A half as often (N tile 64 took the six flagship launches at batch
    5,376 29% longer on an H100, PERF.md). Elsewhere the fewer waves of
    cluster items over the clusters times the tile's width (as
    ``plan_stage`` chooses): where every item is in the split tail, a
    narrow tile's parts run twice the chunks for half a tile's fixup (at
    batch 512, N tile 64 took 11% less); where items run whole, up 128 at
    T 6 at batch 512 has 16 items of N tile 128 for 66 clusters, 32 of 64.
    128 on a tie."""
    plans = {nt: resample_plan_at(B, T, C, up, nt, num_sms) for nt in (128, 64)}
    wide = plans[128]
    clusters = num_sms // wide.cluster
    if wide.stages >= RES_SPLIT_MIN_CHUNKS and wide.items >= clusters:
        width = lambda nt: -(-C // nt) * nt
    else:
        width = lambda nt: -(-plans[nt].items // clusters) * nt
    return plans[min(plans, key=width)]  # 128 first: it wins a tie


class ResampleLaunch(ctypes.Structure):
    """One resampling launch's plan as the C entry takes it; mirrors
    ``cindm::ResampleLaunch`` in ``csrc/resample.cu`` field for field
    (``load()`` checks its size): x's shape and the plan's fields, then the
    split tiles' workspace and counters with their sizes."""

    _fields_ = ([(n, _I) for n in ("B", "T", "C", "up", "n_tile", "num_sms", "samples", "cluster", "items",
                                   "stages", "ctas", "smem_bytes", "tail", "tail_clusters", "max_parts")]
                + [("work", _P), ("counters", _P), ("work_bytes", _L), ("n_counters", _I)])


def resample_launch(plan: ResamplePlan, B: int, T: int, C: int, work: torch.Tensor | None = None,
                    counters: torch.Tensor | None = None) -> ResampleLaunch:
    """``plan`` for x [B, T, C] as the C entry takes it, with the workspace and
    counters of its split (``stage_work``; None where it splits nothing):
    made once per plan, shape and workspace, then kept."""
    return _resample_launch(plan, B, T, C, ptr(work), 0 if work is None else 4 * work.numel(), ptr(counters),
                            0 if counters is None else counters.numel())


@functools.lru_cache(maxsize=256)
def _resample_launch(plan: ResamplePlan, B: int, T: int, C: int, work: int | None, work_bytes: int,
                     counters: int | None, n_counters: int) -> ResampleLaunch:
    return ResampleLaunch(B, T, C, int(plan.up), plan.n_tile, plan.num_sms, plan.samples, plan.cluster,
                          plan.items, plan.stages, plan.ctas, plan.smem_bytes, plan.tail, plan.tail_clusters,
                          plan.max_parts, work, counters, work_bytes, n_counters)


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def cluster_limits(device: torch.device) -> tuple[int, ...]:
    """How many clusters of each of CLUSTER_SIZES of a dgrad kernel the card
    runs at once (cudaOccupancyMaxActiveClusters): the planner's limit."""
    lib, out = load(), []
    with torch.cuda.device(device):
        for cs in CLUSTER_SIZES:
            n = ctypes.c_int(0)
            raise_on_error("cindm_dgrad_cluster_limit", lib.cindm_dgrad_cluster_limit(cs, ctypes.byref(n)))
            out.append(n.value)
    return tuple(out)


def scratch(nbytes: int, device: torch.device) -> torch.Tensor:
    """Device scratch of ``nbytes`` (a multiple of 16) for a tool's own launches."""
    return torch.empty(nbytes // 4, dtype=torch.int32, device=device)


def _tf32_rna(bits: torch.Tensor) -> torch.Tensor:
    """tf32_rna of stage_ring.cuh on fp32 bit patterns (int64, 0 .. 2^32 - 1):
    round to nearest, ties away from zero, the low 13 bits zero; a NaN
    becomes 0x7FFFFFFF."""
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan, torch.full_like(bits, 0x7FFFFFFF), ((bits + 0x1000) & 0xFFFFE000))


def stage_weights_reference(w: torch.Tensor, nt: int) -> torch.Tensor:
    """Plain version of ``cindm_stage_weights``: w [K, C, O] (or [C, O], K =
    1) laid out as the stage reads it, int32 words of
    ``staged_weight_bytes(nt, C, O, K)`` bytes: per N tile of ``nt`` and
    chunk of 8 input channels one block of the K taps' tf32 big and small
    planes (split_tf32: both halves rounded to nearest), in wgmma's K-major
    layout: word q of n8 block n8 is channel n8 * 8 + (q % 32) // 4 of input
    q // 32 * 4 + q % 4. Channels past C or O are zero."""
    w3 = w.reshape(1, *w.shape) if w.dim() == 2 else w
    K, C, O = w3.shape
    nch, ntiles = -(-C // CHUNK), -(-O // nt)
    wp = torch.zeros((K, nch * CHUNK, ntiles * nt), dtype=torch.float32, device=w.device)
    wp[:, :C, :O] = w3
    bits = wp.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    big = _tf32_rna(bits)
    rest = wp - (big - (big >= 2 ** 31).long() * 2 ** 32).to(torch.int32).view(torch.float32)
    small = _tf32_rna(rest.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    planes = torch.stack([big, small], 1)  # [K, 2, nch * 8, ntiles * nt]
    # [K, split, chunk, K half, input of 4, N tile, n8, channel of 8] -> the block order
    planes = planes.view(K, 2, nch, 2, 4, ntiles, nt // 8, 8).permute(5, 2, 0, 1, 6, 3, 7, 4)
    words = planes.reshape(-1)
    return (words - (words >= 2 ** 31).long() * 2 ** 32).to(torch.int32)


LAYOUT_JOBS = 3  # weight tensors of one stage_weights launch (kLayoutJobs): a block's w1, w2, wres


def layout_args(jobs: list[tuple[torch.Tensor, int]], outs: list[torch.Tensor]) -> tuple:
    """The arguments but the stream of ``cindm_stage_weights`` for jobs
    [(w [K, C, O], n_tile)] (at most LAYOUT_JOBS) laid out into ``outs``:
    the arrays of w's and out's pointers and of (K, C, O, n_tile), and the
    count."""
    n = len(jobs)
    return ((ctypes.c_void_p * n)(*(w.data_ptr() for w, _ in jobs)),
            (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
            (ctypes.c_int * (4 * n))(*(d for w, nt in jobs for d in (*w.shape, nt))), n)


class WeightStage:
    """The stage kernels' weights laid out by ``cindm_stage_weights`` (tf32
    big and small planes, ``stage_weights_reference`` on the CPU), kept
    per weight version: ``many([(w, n_tile), ...])`` returns the planes of a
    kernel call's weights, laying out those it has not seen (on their first
    use, or after they changed) together, in one ``stager`` call for each N
    tile among them, and taking the others from the cache; ``staged(w,
    n_tile)`` is its one-weight form. Sampling never changes the weights,
    so a design run stages each once per N tile; training restages once a
    step, after the optimizer's in-place update: one launch a block (w1, w2
    and wres) and one for the head.

    An entry is keyed by the tensor that owns w's view chain (its identity),
    w's storage pointer, offset, version counter (``_version``, which every
    in-place write bumps: ``add_``, ``_foreach_add_``, ``copy_`` in
    ``load_state_dict``), shape and strides, and the N tile. A new version or
    storage drops the owner's older planes; ``weakref.finalize`` drops all
    of them when the owner is freed (an ``id`` key: a ``WeakKeyDictionary``
    would call ``Tensor.__eq__``). A write that bypasses the version counter
    (through ``.data``) must be followed by ``clear()``, as
    ``parallel.mesh.replicate`` does. ``launches`` counts the layout
    kernel's launches on CUDA tensors, ``layouts`` the layouts they made;
    ``stager`` (jobs [(w [K, C, O], n_tile)] -> their planes) may be
    replaced, as the CPU tests do."""

    def __init__(self, stager=None):
        self.launches = 0
        self.layouts = 0
        self.generation = 0  # clear()s so far: what caches kept elsewhere key on
        self.stager = stager or self.stage
        self._owners: dict[int, dict] = {}

    def __call__(self, w: torch.Tensor, nt: int) -> torch.Tensor:
        return self.many([(w, nt)])[0]

    def many(self, pairs: list[tuple[torch.Tensor, int]]) -> list[torch.Tensor]:
        """The planes of each (w, n_tile) of ``pairs`` (a kernel call's
        weights): the kept ones, and the others laid out together, one
        ``stager`` call for those of each N tile (a weight asked for twice,
        once)."""
        keys, stale = [], {}
        for w, nt in pairs:
            entries, key = self._entry(w, nt)
            keys.append((entries, key))
            if key not in entries:
                stale[id(entries), key] = (entries, key, w.reshape(1, *w.shape) if w.dim() == 2 else w, nt)
        for nt in dict.fromkeys(nt for *_, nt in stale.values()):  # one stager call an N tile
            jobs = [j for j in stale.values() if j[3] == nt]
            for (entries, key, _, _), planes in zip(jobs, self.stager([(w, t) for *_, w, t in jobs])):
                entries[key] = planes
        return [entries[key] for entries, key in keys]

    def derived(self, w: torch.Tensor, fn):
        """``fn(w)``, tensors derived from w that a kernel's layouts are made
        from (a rearrangement of its taps), kept as w's layouts are: per w's
        version, dropped by ``clear()``. A derived tensor keeps its own
        layouts (``many``) while it is kept."""
        entries, key = self._entry(w, fn)
        if key not in entries:
            entries[key] = fn(w)
        return entries[key]

    def _entry(self, w: torch.Tensor, nt) -> tuple[dict, tuple]:
        """The entries of w's owner and w's key in them; where the key is new,
        the owner's planes of older versions go (never asked for again)."""
        owner = w if w._base is None else w._base
        base = (w.untyped_storage().data_ptr(), w._version)
        key = (*base, w.storage_offset(), tuple(w.shape), tuple(w.stride()), nt)
        entries = self._owners.get(id(owner))
        if entries is None:
            entries = self._owners[id(owner)] = {}
            weakref.finalize(owner, self._owners.pop, id(owner), None)
        if key not in entries:
            for k in [k for k in entries if k[:2] != base]:
                del entries[k]
        return entries, key

    def stage(self, jobs: list[tuple[torch.Tensor, int]]) -> list[torch.Tensor]:
        """jobs [(w [K, C, O], n_tile)] laid out: on CUDA tensors one launch of
        ``cindm_stage_weights`` (up to LAYOUT_JOBS weights of one N tile, as
        a kernel call hands them in; counted in ``launches``, its layouts in
        ``layouts``), each layout a view of one allocation; the plain
        version on CPU tensors."""
        device = jobs[0][0].device
        if device.type == "cpu":
            return [stage_weights_reference(w, nt) for w, nt in jobs]
        if device.type != "cuda":
            raise ValueError(f"stage_weights: unsupported device {device}")
        if len(jobs) > LAYOUT_JOBS or len({nt for _, nt in jobs}) != 1:
            raise ValueError(f"stage_weights: one launch lays out up to {LAYOUT_JOBS} weights of one N tile")
        for w, _ in jobs:
            check_inputs("stage_weights", device, w=(w, w.shape))
        sizes = [staged_weight_bytes(nt, w.shape[1], w.shape[2], w.shape[0]) // 4 for w, nt in jobs]
        outs = torch.empty(sum(sizes), dtype=torch.int32, device=device).split(sizes)
        raise_on_error("stage_weights", call_on(device, load().cindm_stage_weights, *layout_args(jobs, outs)))
        self.launches += 1
        self.layouts += len(jobs)
        return list(outs)

    def clear(self) -> None:
        """Drop every kept layout and derived tensor (their weights then
        restage on next use), and count a generation."""
        for entries in list(self._owners.values()):  # a derived tensor freed here drops its own entries
            entries.clear()
        self.generation += 1

    def __len__(self) -> int:
        """The layouts kept (not the derived tensors)."""
        return sum(isinstance(k[-1], int) for e in self._owners.values() for k in e)


staged = WeightStage()  # the wrappers' cache; ``staged.clear()`` empties it


def carve(device: torch.device, *shapes: tuple[int, ...] | None) -> list[torch.Tensor | None]:
    """float32 tensors of the given shapes (None for None) as views of one
    allocation, each starting on a 16-byte boundary: one call of the
    allocator where a launch needs several buffers."""
    floats, views = _carve_layout(shapes)
    buf = torch.empty(floats, device=device, dtype=torch.float32)
    return [None if v is None else buf.as_strided(*v) for v in views]


@functools.lru_cache(maxsize=None)
def _carve_layout(shapes: tuple) -> tuple[int, list]:
    """``carve``'s allocation size in floats and (shape, strides, offset) per view."""
    views, off = [], 0
    for sh in shapes:
        if sh is None:
            views.append(None)
            continue
        strides, n = [], 1
        for d in reversed(sh):
            strides.insert(0, n)
            n *= d
        views.append((tuple(sh), tuple(strides), off))
        off += -(-n // 4) * 4
    return off, views


def call_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current (switched to only when
    it is not) and its current stream as the last argument."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with cudaError_t {err}")


@dataclass(frozen=True)
class _BackwardLayout:
    shapes: dict  # expected shape of each input field
    grads: dict  # gradient field -> shape, views of one allocation
    work: dict  # scratch field -> offset in floats into another allocation
    work_floats: int
    args: BackwardArgs  # the size and int fields filled in; copied per call


@functools.lru_cache(maxsize=None)
def _backward_layout(B, T, C, O, K, G, proj, rtb, want_dx, want_dtemb, want_w,
                     sms, clusters) -> _BackwardLayout:
    plan = plan_backward(B, T, C, O, G, proj, rtb, want_dx, num_sms=sms, want_w=want_w,
                         clusters=clusters)
    rows, vec, stats = (B, T, O), (O,), (B, G)
    shapes = dict(x=(B, T, C), w1=(K, C, O), gs1=vec, gb1=vec, g=rows, z1=rows, mean1=stats,
                  rstd1=stats, w2=(K, O, O), gs2=vec, gb2=vec, h=rows, z2=rows, mean2=stats,
                  rstd2=stats, wres=(C, O))
    grads = dict(dw1=(K, C, O), db1=vec, dgs1=vec, dgb1=vec) if want_w else {}
    if want_dx:
        grads["dx"] = (B, T, C)
    if rtb:
        if want_w:
            grads.update(dw2=(K, O, O), db2=vec, dgs2=vec, dgb2=vec)
        if want_dtemb:
            grads["dtemb"] = (B, O)
        if proj and want_w:
            grads.update(dwres=(C, O), dbres=vec)
    wop = plan.wop_bytes // 4
    sizes = dict(dz1=B * T * O, dz2=B * T * O if rtb else 0, dz1w=wop, dz2w=wop if rtb else 0,
                 gw=wop if rtb and proj else 0, wstage=plan.wstage_bytes // 4,
                 wpart=plan.wpart_bytes // 4, colpart=plan.colpart_bytes // 4)
    work, off = {}, 0
    for name, n in sizes.items():
        if n:
            work[name] = off
            off += -(-n // 4) * 4  # 16-byte boundaries
    rd = plan.reduce
    args = BackwardArgs(
        wstage_bytes=plan.wstage_bytes, wpart_bytes=plan.wpart_bytes,
        colpart_bytes=plan.colpart_bytes, wop_bytes=plan.wop_bytes, B=B, T=T, C=C, O=O, G=G,
        samples=plan.samples, gn_samples=plan.gn_samples, gn_tiles=plan.gn_tiles,
        nt_gn=plan.nt_gn, smem_gn=plan.smem_gn, nt_d2=plan.nt_d2,
        smem_d2=plan.smem_d2, nt_d1=plan.nt_d1, smem_d1=plan.smem_d1, cs_d2=plan.cs_d2 or 1,
        cs_d1=plan.cs_d1, wg_grid=plan.wgrad_grid,
        splits=(ctypes.c_int * 3)(*plan.splits), sps=(ctypes.c_int * 3)(*plan.sps),
        rd_width=(ctypes.c_int * REDUCE_JOBS)(*(rd.widths if rd else ())),
        rd_items=rd.items if rd else 0, rd_grid=rd.grid if rd else 0)
    return _BackwardLayout(shapes, grads, work, off, args)


def launch_backward(kernel: str, rtb: bool, inputs: dict, B: int, T: int, C: int, O: int,
                    K: int, G: int, want_dx: bool, want_dtemb: bool,
                    want_w: bool = True) -> dict:
    """Run one backward entry (``cindm_<kernel>``) on CUDA tensors.

    ``inputs`` names the saved tensors and g as the fields of
    ``BackwardArgs`` (the head passes its conv as w1, z1, mean1, rstd1);
    returns the gradients it computed, by field name (dx only with
    ``want_dx``, dtemb only with ``want_dtemb``, the weight, bias and
    GroupNorm gradients only with ``want_w``: without it wgrad does not
    run, nor grad_reduce, whose launches ``launch_backward.reduce_launches``
    counts). Checks every tensor and allocates the gradients and the
    scratch; raises unless it is on CUDA."""
    g = inputs["g"]
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: the backward kernel takes CUDA tensors, got {dev}")
    if K != CONV_K:
        raise ValueError(f"{kernel}: the CUDA backward takes K={CONV_K}, got K={K}")
    proj = inputs.get("wres") is not None
    if not (want_w or want_dx or (rtb and want_dtemb)):
        raise ValueError(f"{kernel}: no gradient wanted")
    lay = _backward_layout(B, T, C, O, K, G, proj, rtb, want_dx, want_dtemb, want_w,
                           num_sms(dev), cluster_limits(dev))
    check_inputs(kernel, dev, **{n: (t, lay.shapes[n]) for n, t in inputs.items() if t is not None})
    check_channels(kernel, C=C, O=O)
    lib = load()
    args = BackwardArgs.from_buffer_copy(lay.args)
    for name, t in inputs.items():
        if t is not None:
            p = t.data_ptr()
            if p % 16:
                raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")
            setattr(args, name, p)
    # the gradients in one allocation (views), the scratch in another (pointers)
    grads = dict(zip(lay.grads, carve(dev, *lay.grads.values())))
    for name, t in grads.items():
        setattr(args, name, t.data_ptr())
    work = torch.empty(lay.work_floats, device=dev, dtype=torch.float32)
    base = work.data_ptr()
    for name, off in lay.work.items():
        setattr(args, name, base + 4 * off)
    err = call_on(dev, getattr(lib, f"cindm_{kernel}"), ctypes.byref(args))
    raise_on_error(kernel, err)
    if want_w:
        launch_backward.reduce_launches += 1
    return grads


launch_backward.reduce_launches = 0  # grad_reduce launches inside the backward (with want_w)
