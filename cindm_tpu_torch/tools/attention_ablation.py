"""Where the time of the linear attention kernel goes, by ablation.

    python3 -m cindm_tpu_torch.tools.attention_ablation [variant,...]

Builds copies of ``ops/csrc/linear_attention.cu`` in which one part of the
kernel is cut out, and times each copy's ``cindm_linear_attention`` at
batch 5,376 on the flagship's 8 attention blocks with CUDA events. The cut
copies compute wrong results: only their times mean something. Each cut
patches one place, whose pattern must occur exactly once in the source
(``patched``). Variants:

    base     the kernel as it is
    noattn   no CUDA-core attention (softmax, k^T v, q (k^T v)): the hidden
             tile keeps what lies there
    noqkv    no q | k | v product (the tile stores zero accumulators)
    noout    no out product (the epilogue stores bias and residual only)
    nol2     the products' B fragments constants: no weight read from L2

Prints one JSON line per block with ms per variant, then the nvidia-smi
name and power limit line. Needs nvcc and one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cindm_tpu_torch.ops import _build
from cindm_tpu_torch.tools.stage_ablation import ms_per_call

SOURCE = "linear_attention.cu"
VARIANTS = {
    "base": [],
    "noattn": [("for (int item = warp; item < samples * kHeads; item += kWarps)",
                "for (int item = warp; item < 0; item += kWarps)")],
    "noqkv": [("    warp_product<MB, 3>(xs, xstride, wqkv, kQkvCols, bcol, C, acc);\n", "    (void)bcol;\n")],
    "noout": [("    warp_product<MB, 2>(hid, kHidStride, wout, C, bcol, kHidden, acc);\n", "    (void)bcol;\n")],
    "nol2": [("bn[s][n][0] = in ? __ldg(r0 + bcol[n]) : 0.f;", "bn[s][n][0] = in ? 0.5f : 0.f;"),
             ("bn[s][n][1] = in ? __ldg(r0 + 4 * ldb + bcol[n]) : 0.f;", "bn[s][n][1] = in ? 0.25f : 0.f;")],
}
# (C, T) of the flagship's 8 attention blocks, in call order
SHAPES = [(64, 24), (128, 12), (256, 6), (512, 3), (512, 3), (256, 3), (128, 6), (64, 12)]
BATCH = 5376


def patched(name: str) -> str:
    """The source of variant ``name``, every pattern replaced; raises where
    a pattern does not occur exactly once."""
    src = (_build.CSRC / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {SOURCE} holds {src.count(old)} copies of {old!r}")
        src = src.replace(old, new)
    return src


def build(name: str, out: Path) -> subprocess.Popen:
    d = out / name
    d.mkdir()
    (d / SOURCE).write_text(patched(name))
    return subprocess.Popen([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                             "-shared", f"-I{_build.CSRC}", str(d / SOURCE), "-o", str(d / "lib.so")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv: list[str]) -> int:
    names = argv[0].split(",") if argv else list(VARIANTS)
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT, prefix="attention-ablation-") as tmp:
        procs = {n: build(n, Path(tmp)) for n in names}
        fns = {}
        for n, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {n}:\n{log}")
            fn = ctypes.CDLL(str(Path(tmp) / n / "lib.so")).cindm_linear_attention
            fn.argtypes, fn.restype = _build.SIGNATURES["cindm_linear_attention"], ctypes.c_int
            fns[n] = fn
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for C, T in SHAPES:
            x = torch.randn((BATCH, T, C), generator=g, device=dev)
            gain = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
            wqkv = torch.randn((C, 384), generator=g, device=dev) / C ** 0.5
            wout = torch.randn((128, C), generator=g, device=dev) / 128 ** 0.5
            bout = 0.1 * torch.randn(C, generator=g, device=dev)
            out = torch.empty_like(x)
            row = {"C": C, "T": T, "B": BATCH}
            for n, fn in fns.items():
                def call(fn=fn, n=n):
                    err = fn(*(t.data_ptr() for t in (x, gain, wqkv, wout, bout, out)), BATCH, T, C, 1e-5, stream)
                    if err:
                        raise RuntimeError(f"{n}: cudaError_t {err}")
                row[n + "_ms"] = ms_per_call(call)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
