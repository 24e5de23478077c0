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
import os
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
WG_TILE = 64  # input and output channels of a wgrad block
WG_STRIDE = WG_TILE + 8  # floats per staged wgrad row
WG_BLOCKS_PER_JOB = 2 * H100_SMS  # wgrad splits its rows until a job has about this many blocks
COL_PARTS = 7  # column partials of the block: dgs2, dgb2, db2, dbres, dgs1, dgb1, db1


def _tile_bytes(nt: int) -> int:
    return TILE_ROWS * (nt + 4) * 4


def _ring_bytes(nt: int) -> int:
    return X_STAGES * TILE_ROWS * X_STRIDE * 4 + 2 * 2 * CONV_K * (nt // 8) * SBO_BYTES


def staged_weight_bytes(nt: int, C: int, O: int, K: int = CONV_K) -> int:
    """Bytes of a conv C -> O's weights laid out for N tiles of ``nt``."""
    return -(-O // nt) * -(-C // CHUNK) * 2 * K * (nt // 8) * SBO_BYTES


@dataclass(frozen=True)
class BackwardPlan:
    """The launches of one block's backward (``rtb``) or the head's.

    ``samples`` whole samples per row tile (``row_tiles`` of them), as in the
    forward; ``nt_gn``/``smem_gn`` tile ``gn_mish_bwd``; ``nt_d2``/``smem_d2``
    the dgrad of conv2 with the first GroupNorm's backward (the block only);
    ``nt_d1``/``smem_d1`` the dgrad to x; ``splits``/``cps`` split wgrad's
    rows per job (dw1, dw2, dwres) into ``splits`` runs of ``cps`` row
    tiles. The byte counts size the scratch the wrapper allocates."""

    samples: int
    row_tiles: int
    nt_gn: int
    smem_gn: int
    nt_d2: int
    smem_d2: int
    nt_d1: int
    smem_d1: int
    wgrad_jobs: tuple[tuple[int, int, int], ...]  # (input channels, taps, tiles) per job
    splits: tuple[int, ...]
    cps: tuple[int, ...]
    wgrad_smem: int
    wgrad_blocks: int
    wstage_bytes: int
    wpart_bytes: int
    colpart_bytes: int


def plan_backward(B: int, T: int, C: int, O: int, G: int, proj: bool, rtb: bool = True,
                  want_dx: bool = True, num_sms: int = H100_SMS,
                  want_w: bool = True) -> BackwardPlan:
    """Tile plan of the backward of a block C -> O (``rtb``: the fused RTB,
    with a 1x1 projection if ``proj``; else the head Conv1d+GN+Mish).
    Without ``want_w`` wgrad does not run and its partials take no bytes."""
    if T > TILE_ROWS:
        raise ValueError(f"the CUDA backward takes T <= {TILE_ROWS}, got T={T}")
    if O % G:
        raise ValueError(f"O={O} not divisible by groups={G}")
    og = O // G
    samples = TILE_ROWS // T
    row_tiles = -(-B // samples)

    def whole(nt: int) -> bool:
        return O <= nt or nt % og == 0

    def stats(nt: int) -> int:
        return 4 * samples * (min(O, nt) // og) * 4

    # gn_mish_bwd: memory-bound, so the narrower tile (more blocks) where it holds whole groups
    nt_gn = next((nt for nt in (64, 128) if whole(nt)), None)
    if nt_gn is None:
        raise ValueError(f"no N tile of 64 or 128 channels holds whole groups of {og} channels")
    smem_gn = 2 * _tile_bytes(nt_gn) + stats(nt_gn) + 16
    nt_d2 = smem_d2 = 0
    if rtb:
        # the forward's second stage tile; 64 channels where 128 does not fit
        nt_d2 = plan_stage(B, T, O, O, G, num_sms=num_sms).n_tile
        d2 = lambda nt: max(_ring_bytes(nt), _tile_bytes(nt)) + _tile_bytes(nt) + stats(nt) + 16
        if d2(nt_d2) > SMEM_MAX and nt_d2 == 128 and whole(64):
            nt_d2 = 64
        smem_d2 = d2(nt_d2)
    nt_d1 = 128 if C > 64 and row_tiles * -(-C // 128) >= num_sms else 64
    smem_d1 = _ring_bytes(nt_d1) + 16
    jobs = [(C, CONV_K)] + ([(O, CONV_K)] if rtb else []) + ([(C, 1)] if rtb and proj else [])
    wgrad_jobs, splits, cps, blocks, wpart = [], [], [], 0, 0
    for Ca, taps in jobs:
        tiles = -(-Ca // WG_TILE) * -(-O // WG_TILE)
        n = max(1, min(row_tiles, -(-WG_BLOCKS_PER_JOB // tiles)))
        per = -(-row_tiles // n)
        n = -(-row_tiles // per)
        wgrad_jobs.append((Ca, taps, tiles))
        splits.append(n)
        cps.append(per)
        blocks += tiles * n
        wpart += n * taps * Ca * O * 4 if want_w else 0
    wstage = ((staged_weight_bytes(nt_d2, O, O) if rtb else 0)
              + (staged_weight_bytes(nt_d1, O, C) if want_dx else 0)
              + (staged_weight_bytes(nt_d1, O, C, K=1) if want_dx and rtb and proj else 0))
    plan = BackwardPlan(
        samples, row_tiles, nt_gn, smem_gn, nt_d2, smem_d2, nt_d1, smem_d1, tuple(wgrad_jobs),
        tuple(splits), tuple(cps), 3 * TILE_ROWS * WG_STRIDE * 4, blocks, wstage, wpart,
        (COL_PARTS if rtb else 3) * row_tiles * O * 4)
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
            "dz1", "dz2", "wstage", "wpart", "colpart")]
        + [(n, _L) for n in ("wstage_bytes", "wpart_bytes", "colpart_bytes")]
        + [(n, _I) for n in ("B", "T", "C", "O", "G", "samples", "nt_gn", "smem_gn", "nt_d2",
                             "smem_d2", "nt_d1", "smem_d1")]
        + [("splits", _I * 3), ("cps", _I * 3)]
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


def sass_mma_counts() -> dict[str, int] | str:
    """Tensor-core instructions (HGMMA: wgmma) per kernel in the built
    library's SASS, as ``cuobjdump -sass`` lists them."""
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
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
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
                     sms) -> _BackwardLayout:
    plan = plan_backward(B, T, C, O, G, proj, rtb, want_dx, num_sms=sms, want_w=want_w)
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
    sizes = dict(dz1=B * T * O, dz2=B * T * O if rtb else 0, wstage=plan.wstage_bytes // 4,
                 wpart=plan.wpart_bytes // 4, colpart=plan.colpart_bytes // 4)
    work, off = {}, 0
    for name, n in sizes.items():
        if n:
            work[name] = off
            off += -(-n // 4) * 4  # 16-byte boundaries
    args = BackwardArgs(
        wstage_bytes=plan.wstage_bytes, wpart_bytes=plan.wpart_bytes,
        colpart_bytes=plan.colpart_bytes, B=B, T=T, C=C, O=O, G=G, samples=plan.samples,
        nt_gn=plan.nt_gn, smem_gn=plan.smem_gn, nt_d2=plan.nt_d2, smem_d2=plan.smem_d2,
        nt_d1=plan.nt_d1, smem_d1=plan.smem_d1, splits=(ctypes.c_int * 3)(*plan.splits),
        cps=(ctypes.c_int * 3)(*plan.cps))
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
                           num_sms(dev))
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
