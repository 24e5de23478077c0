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
first CUDA launch, so CPU-only hosts import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".cuda_build"
LIB_NAME = "libcindm_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (argtypes). Every entry returns the cudaError_t of its launch.
SIGNATURES = {
    # x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, out,
    # B, T, C, O, K, G, eps, stream
    "cindm_fused_rtb": [_P] * 13 + [_I] * 6 + [_F, _P],
    # x, w, b, gs, gb, out, B, T, C, O, K, G, eps, stream
    "cindm_fused_conv1d_gn_mish": [_P] * 6 + [_I] * 6 + [_F, _P],
}

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


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin (default /usr/local/cuda)")


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
    """Register / shared-memory / spill lines from the last build's log."""
    log = BUILD_ROOT / source_hash() / "build.log"
    if not log.exists():
        return ""
    keep = ("Compiling entry", "registers", "spill")
    return "\n".join(l for l in log.read_text().splitlines() if any(k in l for k in keep))


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
    rows of their inputs as float4."""
    for name, n in channels.items():
        if n % 4:
            raise ValueError(f"{kernel}: {name}={n} must be a multiple of 4 on CUDA")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with cudaError_t {err}")
