"""Where the time of the tensor-core stage kernel goes, by ablation.

    python3 -m cindm_tpu_torch.tools.stage_ablation [variant,...]

Builds copies of ``ops/csrc/fused_conv_gn.cu`` in which one part of the
stage kernel (``ops/csrc/conv_gn_mish.cuh``) is cut out, and times each
copy's ``cindm_fused_conv1d_gn_mish`` at batch 5,376 on the flagship's
stage shapes with CUDA events. The cut copies compute wrong results: only
their times mean something. Variants:

    base      the kernel as it is
    nomma     no wgmma (the A fragments are still loaded and split)
    noepi     returns after the accumulator tile is stored (no GroupNorm
              statistics, no Mish, no output)
    nostats   no GroupNorm statistics
    nofinal   no normalise/Mish/store pass
    nocopy    weights copied in for the first chunk only (no bulk copies after)
    noa       no A fragments loaded from shared memory (constants instead)

Prints one JSON line per shape with ms per variant, then the nvidia-smi
name and power limit line. Needs nvcc and one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cindm_tpu_torch.ops import _build

_MMA = """      wgmma_tf32(acc, asmall[kk], weight_desc(big));
      wgmma_tf32(acc, abig[kk], weight_desc(big + kPlaneBytes));
      wgmma_tf32(acc, abig[kk], weight_desc(big));"""
VARIANTS = {
    "base": [],
    "nomma": [(_MMA, "      acc[0] += __uint_as_float(asmall[kk][0] ^ abig[kk][1] ^ asmall[kk][2]"
                     " ^ abig[kk][3] ^ big);")],
    "noepi": [("  __syncthreads();\n  tile_stats<NT>(",
               "  __syncthreads();\n  if (a.eps > 0.f) return;\n  tile_stats<NT>(")],
    "nostats": [("  tile_stats<NT>(tile, ns, a.T, gpt, og, a.eps, mean, rstd);", "")],
    "nofinal": [("  if (c >= ncols) return;", "  if (c >= ncols || a.eps > 0.f) return;")],
    "nocopy": [("    if (threadIdx.x == 0 && chunk + 1 < nchunks) stage_w(chunk + 1);\n", ""),
               ("    mbar_wait(bars + 8 * (q & 1), (q >> 1) & 1);",
                "    if (q == 0) mbar_wait(bars, 0);")],
    "noa": [("xs[(tr.r[i] + k - kPad) * kXStride + q4 + 4 * (v >> 1)]",
             "__uint_as_float(threadIdx.x * 7u + k)")],
}
# (C, O, T) of the flagship's stages: T = 3, 6, 12, 24 and the head
SHAPES = [(512, 512, 3), (1024, 512, 3), (256, 256, 6), (128, 128, 12), (64, 64, 24)]
BATCH = 5376


def build(name: str, cuts: list[tuple[str, str]], out: Path) -> subprocess.Popen:
    hdr = (_build.CSRC / "conv_gn_mish.cuh").read_text()
    for old, new in cuts:
        if old not in hdr:
            raise RuntimeError(f"variant {name}: the kernel no longer holds {old!r}")
        hdr = hdr.replace(old, new)
    d = out / name
    d.mkdir()
    (d / "conv_gn_mish.cuh").write_text(hdr)
    shutil.copy(_build.CSRC / "fused_conv_gn.cu", d)
    return subprocess.Popen([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
                             "-fPIC", "-shared", str(d / "fused_conv_gn.cu"), "-o", str(d / "lib.so")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ms_per_call(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str]) -> int:
    names = argv[0].split(",") if argv else list(VARIANTS)
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT, prefix="ablation-") as tmp:
        procs = {n: build(n, VARIANTS[n], Path(tmp)) for n in names}
        fns = {}
        for n, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {n}:\n{log}")
            fn = ctypes.CDLL(str(Path(tmp) / n / "lib.so")).cindm_fused_conv1d_gn_mish
            fn.argtypes, fn.restype = _build.SIGNATURES["cindm_fused_conv1d_gn_mish"], ctypes.c_int
            fns[n] = fn
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for C, O, T in SHAPES:
            x = torch.randn((BATCH, T, C), generator=g, device=dev)
            w = torch.randn((5, C, O), generator=g, device=dev) / (5 * C) ** 0.5
            b, gs, gb = (torch.randn(O, generator=g, device=dev) for _ in range(3))
            out = torch.empty((BATCH, T, O), device=dev)
            plan = _build.plan_stage(BATCH, T, C, O, 8, num_sms=_build.num_sms(dev))
            scratch = _build.scratch(plan.weight_bytes(C), dev)
            row = {"C": C, "O": O, "T": T, "B": BATCH, "n_tile": plan.n_tile}
            for n, fn in fns.items():
                def call(fn=fn):
                    err = fn(*(t.data_ptr() for t in (x, w, b, gs, gb, out, scratch)),
                             scratch.numel() * 4, BATCH, T, C, O, 5, 8, 1e-5, plan.samples,
                             plan.n_tile, plan.smem_bytes, stream)
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
