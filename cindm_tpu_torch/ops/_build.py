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
CPU tests reach it.
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
        if tuple(t.shape) != tuple(shape):
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


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with cudaError_t {err}")
