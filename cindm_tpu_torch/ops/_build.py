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
CPU tests reach it, and ``plan_backward`` the tiles and scratch of the
backward kernels (``csrc/conv_backward.cuh``), whose C entries take their
arguments as one ``BackwardArgs`` structure.
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
    # x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, h, out, scratch,
    # scratch_bytes, B, T, C, O, K, G, eps, samples, n_tile, smem_conv1, smem_conv2, stream
    "cindm_fused_rtb": [_P] * 15 + [_L] + [_I] * 6 + [_F] + [_I] * 4 + [_P],
    # x, w, b, gs, gb, out, scratch, scratch_bytes, B, T, C, O, K, G, eps, samples,
    # n_tile, smem, stream
    "cindm_fused_conv1d_gn_mish": [_P] * 7 + [_L] + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    # the saving instances: as above with z1, z2, mean1, rstd1, mean2, rstd2
    # (the head: z, mean, rstd) after out
    "cindm_fused_rtb_saving": [_P] * 21 + [_L] + [_I] * 6 + [_F] + [_I] * 4 + [_P],
    "cindm_fused_conv1d_gn_mish_saving": [_P] * 10 + [_L] + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    # BackwardArgs*, stream
    "cindm_fused_rtb_backward": [_P, _P],
    # cluster size, int* out: the dgrads' clusters the device runs at once
    "cindm_dgrad_cluster_limit": [_I, _P],
    "cindm_fused_conv1d_gn_mish_backward": [_P, _P],
    "cindm_block_backward_args_size": [],
}

# The tile of the implicit-GEMM stage (csrc/conv_gn_mish.cuh); these mirror
# its constants and stage_smem_bytes(), and the launch refuses a plan whose
# shared-memory bytes differ from its own count.
TILE_ROWS = 192  # M: three warpgroups x 64 rows, whole samples only
CONV_K = 5  # the stage's conv width (the projection is its K = 1 case)
CHUNK = 8  # input channels per ring stage
X_STRIDE = CHUNK + 4  # floats per staged input row
X_STAGES = 4  # input stages in the ring, beside two weight stages
SBO_BYTES = 256  # bytes between n8 blocks of a staged weight plane
SMEM_MAX = 232448  # the H100's dynamic shared memory per block
H100_SMS = 132


@dataclass(frozen=True)
class StagePlan:
    """The tile of one stage launch: ``samples`` whole samples (``samples * T``
    of the 192 rows) by ``n_tile`` output channels, which hold whole
    GroupNorm groups; ``smem_bytes`` of dynamic shared memory (a ring of
    X_STAGES input and two weight stages, the tile, the statistics);
    ``grid`` = (row tiles, channel tiles)."""

    samples: int
    n_tile: int
    smem_bytes: int
    grid: tuple[int, int]

    def weight_bytes(self, C: int, K: int = CONV_K) -> int:
        """Bytes of weights [K, C, O] laid out for this tile: per N tile and
        chunk of input channels, the K taps' tf32 big and small planes."""
        return self.grid[1] * -(-C // CHUNK) * 2 * K * (self.n_tile // 8) * SBO_BYTES


@functools.lru_cache(maxsize=None)
def plan_stage(B: int, T: int, C: int, O: int, G: int, K: int = CONV_K, proj: bool = False,
               num_sms: int = H100_SMS) -> StagePlan:
    """Tile plan for a Conv1d+GN+Mish stage over x [B, T, C] -> [B, T, O].

    The N tile is 64 channels for O <= 64, else 128 when 128 holds whole
    groups, falling back to 64 when 128 leaves SMs without a block or does
    not hold whole groups. ``proj`` adds the tile that the 1x1 residual
    projection needs while it reuses the ring."""
    if K != CONV_K:
        raise ValueError(f"the CUDA stage kernel takes K={CONV_K}, got K={K}")
    if T > TILE_ROWS:
        raise ValueError(f"the CUDA stage kernel takes T <= {TILE_ROWS}, got T={T}")
    if O % G:
        raise ValueError(f"O={O} not divisible by groups={G}")
    og = O // G
    fits = [nt for nt in (64, 128) if O <= nt or nt % og == 0]
    if not fits:
        raise ValueError(f"no N tile of 64 or 128 channels holds whole groups of {og} channels")
    samples = TILE_ROWS // T
    rows_tiles = -(-B // samples)

    def smem(nt: int) -> int:
        ring = X_STAGES * TILE_ROWS * X_STRIDE * 4 + 2 * 2 * CONV_K * (nt // 8) * SBO_BYTES
        tile = TILE_ROWS * (nt + 4) * 4
        stats = 2 * samples * (min(O, nt) // og) * 4
        return max(ring, tile) + (tile if proj else 0) + stats + 16  # + two mbarriers

    n_tile = 64 if O <= 64 or 128 not in fits else 128
    if n_tile == 128 and 64 in fits and (rows_tiles * -(-O // 128) < num_sms
                                         or smem(128) > SMEM_MAX):
        n_tile = 64
    plan = StagePlan(samples, n_tile, smem(n_tile), (rows_tiles, -(-O // n_tile)))
    if plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"no tile of T={T} fits the shared memory of one block: {plan}")
    assert samples >= 1 and samples * T <= TILE_ROWS, plan
    assert O <= n_tile or n_tile % og == 0, plan
    return plan

# The backward's tiles (csrc/conv_backward.cuh); they mirror its constants.
WG_TILE = 64  # input and output channels of a wgrad work item
WG_ROWS = 64  # rows of one wgrad ring stage
WG_ROWS_T3 = 48  # at T = 3: 16 whole samples, in position-major order
WG_STAGES = 4  # stages in wgrad's ring
WG_HALO = CONV_K // 2  # activation rows either side of a stage that its taps reach
WG_MIN_STAGES = 4  # a split of a job's rows runs at least this many ring stages
COL_PARTS = 7  # kinds of column partials of the block: dgs2, dgb2, db2, dbres, dgs1, dgb1, db1
# The dgrads' main loop (csrc/conv_backward.cuh, DgRing): a ring of stages of
# 16 input channels (8 at an N tile of 128) fed by a producer warp, K split
# over a cluster of one of CLUSTER_SIZES CTAs.
CLUSTER_SIZES = (1, 2, 3, 4)
DG_MIN_STAGES = 2  # each rank of a cluster runs at least this many ring stages
# gn_mish_bwd (csrc/conv_backward.cuh): at most GN_PAIRS (sample, group)
# pairs a CTA, GN_WARP_PAIRS a warp; an N tile at least GN_LINE channels (a
# 128-byte line) wide where the groups allow; GN_KINDS kinds of column partials.
GN_PAIRS = 16
GN_WARP_PAIRS = 2
GN_LINE = 32
GN_KINDS = 4


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


def _tile_bytes(nt: int) -> int:
    return TILE_ROWS * (nt + 4) * 4


def _align1024(n: int) -> int:
    return -(-n // 1024) * 1024


def dgrad_ring(nt: int) -> tuple[int, int, int]:
    """A dgrad ring for an N tile of ``nt``: (chunks of 8 input channels a
    stage, stages, bytes). A stage holds the tile's 192 cotangent rows of
    the stage's channels and their weight blocks of five taps, each part on
    1,024-byte boundaries."""
    ch = 2 if nt == 64 else 1
    stages = 3 if nt == 64 else 2
    stage = _align1024(_align1024(TILE_ROWS * 4 * CHUNK * ch)
                       + ch * 2 * CONV_K * (nt // 8) * SBO_BYTES)
    return ch, stages, stages * stage


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
    _, stages, ring = dgrad_ring(nt)
    return (1024 + max(ring, _tile_bytes(nt), 12 * -(-samples // cs) * nt) + _tile_bytes(nt)
            + 16 * stages)


def dgrad_x_smem_bytes() -> int:
    """dgrad_x_stage (N tile 64): the aligned ring, which then holds the
    partial tile, and the barriers."""
    _, stages, ring = dgrad_ring(64)
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
    persistent grid of ``wgrad_grid`` blocks. The byte counts size the scratch the wrapper
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
        ch = dgrad_ring(nt_d2)[0]
        cs_d2 = dgrad_cluster(row_tiles * -(-O // nt_d2), -(-O // (CHUNK * ch)), clusters)
        smem_d2 = dgrad_gn_smem_bytes(nt_d2, samples, cs_d2)
        grid_d2 = (row_tiles * cs_d2, -(-O // nt_d2))
    nt_d1, smem_d1 = 64, dgrad_x_smem_bytes()
    cs_d1 = dgrad_cluster(row_tiles * -(-C // 64), -(-O // (CHUNK * dgrad_ring(64)[0])), clusters)
    grid_d1 = (row_tiles * cs_d1, -(-C // 64))
    jobs = [(C, CONV_K)] + ([(O, CONV_K)] if rtb else []) + ([(C, 1)] if rtb and proj else [])
    wgrad_jobs = [(Ca, taps, -(-Ca // WG_TILE) * -(-O // WG_TILE)) for Ca, taps in jobs]
    # Split a job's rows only where the items would leave SMs idle: with
    # each SM's fair share of the work (tiles x taps x stages), a job is cut
    # into as many splits as its item holds shares, none shorter than
    # WG_MIN_STAGES stages.
    stages = -(-B * T // wgrad_stage_rows(T))
    share = sum(tiles * taps for _, taps, tiles in wgrad_jobs) * stages / num_sms
    splits, sps, items, wpart = [], [], 0, 0
    for Ca, taps, tiles in wgrad_jobs:
        n = max(1, min(int(taps * stages / share), stages // WG_MIN_STAGES))
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
    plan = BackwardPlan(
        samples, row_tiles, gn_samples, gn_tiles, 32 * -(-gn_samples * gpt_gn // GN_WARP_PAIRS),
        (gn_tiles, -(-O // nt_gn)), nt_gn, smem_gn, nt_d2, smem_d2, nt_d1, smem_d1, cs_d2, cs_d1, grid_d2,
        grid_d1, tuple(wgrad_jobs), tuple(splits), tuple(sps), wgrad_smem_bytes(), items,
        min(items, num_sms), wstage, wpart, colpart,
        wgrad_operand_bytes(B * T, O, T) if want_w else 0)
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
        + [("splits", _I * 3), ("sps", _I * 3)]
    )


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
        _lib = lib
    return _lib


def ptxas_report() -> str:
    """Register / shared-memory / spill lines (and ptxas's performance notes)
    from the last build's log."""
    log = BUILD_ROOT / source_hash() / "build.log"
    if not log.exists():
        return ""
    keep = ("Compiling entry", "registers", "spill", "Performance")
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
    """Device scratch for the weights a launch lays out (``nbytes``, a multiple of 16)."""
    return torch.empty(nbytes // 4, dtype=torch.int32, device=device)


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
    args = BackwardArgs(
        wstage_bytes=plan.wstage_bytes, wpart_bytes=plan.wpart_bytes,
        colpart_bytes=plan.colpart_bytes, wop_bytes=plan.wop_bytes, B=B, T=T, C=C, O=O, G=G,
        samples=plan.samples, gn_samples=plan.gn_samples, gn_tiles=plan.gn_tiles,
        nt_gn=plan.nt_gn, smem_gn=plan.smem_gn, nt_d2=plan.nt_d2,
        smem_d2=plan.smem_d2, nt_d1=plan.nt_d1, smem_d1=plan.smem_d1, cs_d2=plan.cs_d2 or 1,
        cs_d1=plan.cs_d1, wg_grid=plan.wgrad_grid,
        splits=(ctypes.c_int * 3)(*plan.splits), sps=(ctypes.c_int * 3)(*plan.sps))
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
    run). Checks every tensor and allocates the gradients and the scratch;
    raises unless it is on CUDA."""
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
    return grads
