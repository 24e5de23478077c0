"""Where the time of the tensor-core stage kernel goes, by ablation.

    python3 -m cindm_tpu_torch.tools.stage_ablation [variant,...]

Builds copies of ``ops/csrc/fused_conv_gn.cu`` in which one part of the
stage kernel (``ops/csrc/conv_gn_mish.cuh`` on the main loop of
``ops/csrc/stage_ring.cuh``) is cut out, and times each copy's
``cindm_fused_conv1d_gn_mish`` at batch 5,376 on the flagship's stage
shapes with CUDA events. The cut copies compute wrong results: only their
times mean something. Each cut patches one or two places, each of whose
patterns must occur exactly once in its source (``patched``). Variants:

    base      the kernel as it is
    nomma     no wgmma (the A fragments are still loaded and split)
    noepi     a tile's consumers stop after its accumulator tile is stored
              (no GroupNorm statistics, no Mish, no output)
    nostats   no GroupNorm statistics
    nofinal   no normalise/Mish/store pass
    nocopy    weight blocks copied into the ring's first stages only (no
              bulk copies after; the TMA boxes of the input still run)
    noa       no A fragments loaded from shared memory (constants instead)

(The cp.async loop's own parts, its per-chunk barrier and its input ring,
went with it; the persistent walk has no part to cut out alone.) The
projection never runs here (the head's stage has none), so a variant that
skips part of a tile's epilogue cannot leave ring stages unconsumed; noepi
still tells a deep launch's producer that the tile is free.
Prints one JSON line per shape with ms per variant, then the nvidia-smi
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

_MMA = """    wgmma_tf32(acc, as, weight_desc(big));
    wgmma_tf32(acc, ab, weight_desc(big + kPlane));
    wgmma_tf32(acc, ab, weight_desc(big));"""
_COPY = """      mbar_expect_tx(full + 8 * slot, kTileRows * R::kPitch + wbytes);
      tma_load_2d(st, map, c * kChunk, row0, full + 8 * slot);
      bulk_load(st + R::kABytes, p.w + size_t(c) * block, wbytes, full + 8 * slot);"""
RING, STAGE = "stage_ring.cuh", "conv_gn_mish.cuh"
# variant: [(source, pattern, replacement)]
VARIANTS = {
    "base": [],
    "nomma": [(RING, _MMA, "    acc[0] += __uint_as_float(as[0] ^ ab[1] ^ as[2] ^ ab[3] ^ big);")],
    "noepi": [(STAGE, "  consumer_sync();\n  tile_stats<NT>(",
               "  consumer_sync();\n  if (a.eps > 0.f) {\n    if (kDeep && lane == 0) mbar_arrive(epi);\n"
               "    return;\n  }\n  tile_stats<NT>(")],
    "nostats": [(STAGE, "  tile_stats<NT>(tile, ns, a.T, gpt, og, a.eps, mean, rstd);\n", "")],
    "nofinal": [(STAGE, "  if (c < ncols) {\n    const float4 scale",
                 "  if (c < ncols && a.eps < 0.f) {\n    const float4 scale")],
    "nocopy": [(RING, _COPY, """      const bool w = it < R::kStages;
      mbar_expect_tx(full + 8 * slot, kTileRows * R::kPitch + (w ? wbytes : 0u));
      tma_load_2d(st, map, c * kChunk, row0, full + 8 * slot);
      if (w) bulk_load(st + R::kABytes, p.w + size_t(c) * block, wbytes, full + 8 * slot);""")],
    "noa": [(RING, "xs[swizzled<R::kPitch>(ok ? tr.r[h] + k - kPad : 0, 2 * ch + (v >> 1), q4)]",
             "__uint_as_float(threadIdx.x * 7u + k)")],
}
# (C, O, T) of the flagship's stages: T = 3, 6, 12, 24 and the head
SHAPES = [(512, 512, 3), (1024, 512, 3), (512, 256, 3), (256, 256, 6), (128, 128, 12), (64, 64, 24)]
BATCH = 5376


def patched(name: str) -> dict[str, str]:
    """The sources of variant ``name``: file name -> text, every pattern
    replaced; raises where a pattern does not occur exactly once."""
    srcs = {f: (_build.CSRC / f).read_text() for f in (RING, STAGE)}
    for f, old, new in VARIANTS[name]:
        if srcs[f].count(old) != 1:
            raise RuntimeError(f"variant {name}: {f} holds {srcs[f].count(old)} copies of {old!r}")
        srcs[f] = srcs[f].replace(old, new)
    return srcs


def build(name: str, out: Path) -> subprocess.Popen:
    d = out / name
    d.mkdir()
    for f, text in patched(name).items():
        (d / f).write_text(text)
    (d / "fused_conv_gn.cu").write_text((_build.CSRC / "fused_conv_gn.cu").read_text())
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
        procs = {n: build(n, Path(tmp)) for n in names}
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
            row = {"C": C, "O": O, "T": T, "B": BATCH, "n_tile": plan.n_tile, "tiles": plan.tiles,
                   "ctas": plan.ctas}
            for n, fn in fns.items():
                def call(fn=fn):
                    err = fn(*(t.data_ptr() for t in (x, w, b, gs, gb, out, scratch)),
                             scratch.numel() * 4, BATCH, T, C, O, 5, 8, 1e-5, plan.samples,
                             plan.n_tile, plan.ctas, plan.smem_bytes, stream)
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
