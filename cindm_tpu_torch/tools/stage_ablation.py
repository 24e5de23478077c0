"""Where the time of the tensor-core stage kernel goes, by ablation.

    python3 -m cindm_tpu_torch.tools.stage_ablation [variant,...]

Builds copies of ``ops/csrc/fused_conv_gn.cu`` in which one part of the
stage kernel (``ops/csrc/conv_gn_mish.cuh`` on the main loop of
``ops/csrc/stage_ring.cuh``) is cut out, and times each copy's
``cindm_fused_conv1d_gn_mish`` at batch 5,376 on the flagship's stage
shapes with CUDA events, on weights that the copy's own
``cindm_stage_weights`` laid out once per shape (as the wrappers keep
them). The cut copies compute wrong results: only their times mean
something. Each cut patches one or two places, each of whose patterns must
occur exactly once in its source (``patched``). Variants:

    base      the kernel as it is
    nomma     no wgmma (A by descriptor at T = 3; elsewhere the fragments
              are still loaded from the split planes)
    nosplit   the producer warpgroup's split cut: A left as loaded (the
              planes are not written; the consumers read what lies there)
    nomcast   clusters of one CTA: each CTA copies its own weight blocks
              (the plan's cluster 1, as the C side then recomputes it)
    wholetiles  not a cut: no split tail, every item whole, round robin
              over the clusters (the walk before the split; its time and
              result are real)
    noepi     a tile's consumers stop once its accumulator is final (no
              bias, GroupNorm statistics, Mish or output; a split tile's
              parts still store, count in and sum)
    nofixup   a split tile's parts neither store, count in nor sum: part 0
              runs the epilogue on its own partial sums, the others stop
              (what the split's walk gives without its fixup)
    nostats   no GroupNorm statistics (the rows' and the pairs' sums and
              their four barriers)
    nofinal   no normalise/Mish/store pass
    nocopy    weight blocks copied into the ring's first slots only (no
              bulk copies after; the TMA boxes of the input still run)
    noa       no A fragments loaded from the split planes (constants
              instead): cuts a part only where T != 3 (at T = 3 A comes
              by descriptor)
    rega64    not a cut: at T = 3 and N tile 64, A's fragments from the
              split planes into registers instead of by descriptor (the
              choice kDescA did not take; its time and result are real)

The projection never runs here (the head's stage has none), so a variant
that skips part of a tile's epilogue cannot leave ring stages unconsumed.
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
_MMA_SS = """          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a + R::kABytes), weight_desc(b));
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a), weight_desc(b + kPlane));
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a), weight_desc(b));"""
_COPY = """      mbar_expect_tx(f.full + 8 * slot, wbytes);
      if (f.cs == 1) {"""
_SPLIT = """#pragma unroll 2
    for (int i = t; i < kUnits; i += 32 * kSplitWarps) {"""
_STATS = """    row_group_sums<NT, false>(acc, tr, sb, og, gpt, stats, psum);
    consumer_sync();  // psum is whole (and the previous tile's readers of stats are done)
    pair_stats<false>(psum, ns, a.T, gpt, a.G, n, a.eps, stats, mean_out, out0);
    consumer_sync();  // the means are in
    row_group_sums<NT, true>(acc, tr, sb, og, gpt, stats, psum);
    consumer_sync();
    pair_stats<true>(psum, ns, a.T, gpt, a.G, n, a.eps, stats, rstd_out, out0);
    consumer_sync();  // rstd is in
"""
_FINISH = """  if (parts_of(p.tag) > 1 &&
      !finish_split<NT>(a.work, a.counters, a.split.max_parts, a.cs, p.tag, f.rank, a.B > rt * a.samples, flag, acc))
    return;
"""
_STORED = "  consumer_sync();  // every consumer's partial sums are stored\n"
RING, STAGE = "stage_ring.cuh", "conv_gn_mish.cuh"
# variant: [(source, pattern, replacement)]
VARIANTS = {
    "base": [],
    "nomma": [(RING, _MMA, "    acc[0] += __uint_as_float(as[0] ^ ab[1] ^ as[2] ^ ab[3] ^ big);"),
              (RING, _MMA_SS, "          acc[0] += __uint_as_float(uint32_t(a ^ b));")],
    "nosplit": [(RING, _SPLIT, "    for (int i = kUnits + t; i < kUnits; ++i) {")],
    "nomcast": [(STAGE, "stage_cluster(int row_tiles) { return row_tiles > 1 ? 2 : 1; }",
                 "stage_cluster(int row_tiles) { return row_tiles > 0 ? 1 : 1; }")],
    "wholetiles": [(STAGE, "constexpr bool kSplitTail = true;", "constexpr bool kSplitTail = false;")],
    "noepi": [(STAGE, _FINISH, _FINISH + "  if (a.eps > 0.f) return;\n")],
    "nofixup": [(RING, _STORED, "  if (max_parts > 0) return part == 0;\n" + _STORED),
                (RING, "#pragma unroll\n  for (int u = 0; u < kUnits; ++u)\n    __stcg(",
                 "#pragma unroll\n  for (int u = 0; u < kUnits && max_parts < 0; ++u)\n    __stcg(")],
    "nostats": [(STAGE, _STATS, "")],
    "nofinal": [(STAGE, "  for (int j = 0; j < NT / 8; j += 2) {\n    float2 v[2][2];",
                 "  for (int j = 0; j < NT / 8 && a.eps < 0.f; j += 2) {\n    float2 v[2][2];")],
    "nocopy": [(RING, _COPY, """      const bool first = it < R::kStages;
      mbar_expect_tx(f.full + 8 * slot, first ? wbytes : 0u);
      if (!first) {
      } else if (f.cs == 1) {""")],
    "noa": [(RING, "const uint32_t b = planes[i], s = planes[i + R::kABytes / 4];",
             "const uint32_t b = threadIdx.x * 7u + k + i, s = b ^ 1u;")],
    "rega64": [(STAGE, "constexpr bool kDescA = KW == 3;", "constexpr bool kDescA = KW == 3 && NT == 128;"),
               (STAGE, "if (a.T == 3) {  // kDescA", "if (a.T == 3 && nt == 128) {  // kDescA")],
}
# the plan's arguments where a variant changes them: its cluster size, no split
PLAN = {"nomcast": dict(cluster=1), "wholetiles": dict(split=False)}
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
            lib = ctypes.CDLL(str(Path(tmp) / n / "lib.so"))
            for name in ("cindm_fused_conv1d_gn_mish", "cindm_stage_weights"):
                getattr(lib, name).argtypes = _build.SIGNATURES[name]
                getattr(lib, name).restype = ctypes.c_int
            fns[n] = lib
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for C, O, T in SHAPES:
            x = torch.randn((BATCH, T, C), generator=g, device=dev)
            w = torch.randn((5, C, O), generator=g, device=dev) / (5 * C) ** 0.5
            b, gs, gb = (torch.randn(O, generator=g, device=dev) for _ in range(3))
            out = torch.empty((BATCH, T, O), device=dev)
            plan = _build.plan_stage(BATCH, T, C, O, 8, num_sms=_build.num_sms(dev))
            row = {"C": C, "O": O, "T": T, "B": BATCH, "n_tile": plan.n_tile, "tiles": plan.tiles,
                   "ctas": plan.ctas, "cluster": plan.cluster, "items": plan.items, "split_items": plan.tail,
                   "max_parts": plan.max_parts}
            for n, lib in fns.items():
                vplan = _build.plan_stage(BATCH, T, C, O, 8, num_sms=_build.num_sms(dev), **PLAN.get(n, {}))
                ws = _build.scratch(plan.weight_bytes(C), dev)  # w as this copy lays it out
                err = lib.cindm_stage_weights(*_build.layout_args([(w, plan.n_tile)], [ws]), stream)
                if err:
                    raise RuntimeError(f"{n}: stage_weights: cudaError_t {err}")
                work = _build.scratch(max(vplan.work_bytes, 16), dev)
                counters = torch.zeros(max(vplan.counters, 1), dtype=torch.int32, device=dev)
                launch = _build.stage_launch(vplan, work, counters)

                def call(fn=lib.cindm_fused_conv1d_gn_mish, launch=launch, ws=ws):
                    err = fn(*(t.data_ptr() for t in (x, ws, b, gs, gb, out)), BATCH, T, C, O, 5, 8, 1e-5,
                             ctypes.byref(launch), stream)
                    if err:
                        raise RuntimeError(f"{n}: cudaError_t {err}")
                row[n + "_ms"] = ms_per_call(call)
                if int(counters.abs().sum()):
                    raise RuntimeError(f"{n}: the split tiles' counters are not back at 0")
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
