"""Where the time of the resampling kernel goes, by ablation.

    python3 -m cindm_tpu_torch.tools.resample_ablation [variant,...] [--parent CSRC] [--batch N]
    python3 -m cindm_tpu_torch.tools.resample_ablation --wrappers [--batch N]

Builds copies of ``ops/csrc/resample.cu`` (with ``stage_ring.cuh`` beside
it) in which one part of the kernel is cut out or changed, and times each
copy's ``cindm_resample`` at batch N (5,376 by default) on the flagship's
3 Downsample1d and 3 Upsample1d, in call order: CUDA events over 20
launches, and each launch's device time from torch.profiler (median of 3
traced launches). The weights are laid out beforehand
(``_build.stage_weights_reference``). The cut copies compute wrong
results: only their times mean something. Each variant patches one place
or a few, whose patterns must each occur exactly once in their file
(``patched``), and runs on the plan its C side recomputes
(``variant_plan``). Variants of this tree's kernel:

    base      the kernel as it is
    nomma     no wgmma: the ring's handshake, the producer's feed and split,
              the epilogue (the fragment loads go with the wgmmas they fed)
    nosplit   the producer warpgroup's split cut: the planes are not written
    noepi     no output: no bias and no stores (a split tile's parts still
              store, count in and sum)
    whole     not a cut: no split tail, every item whole, round robin over
              the clusters (its time and result are real)
    splitall  not a cut: the split tail at every item of two chunks or
              more, not of 32 or more (time and result real)
    trim      items trimmed to whole waves, no split tail: the full waves
              alone (base - trim is what the last wave costs)
    trimnoepi trim and noepi together: the full waves' main loops alone
    nostream  not a cut: y stored without the streaming hint
    nt64      not a cut: N tiles of 64 channels at every shape (time and
              result real)

With ``--parent CSRC`` the copies are made of the resampling kernel of PR
23 in that directory (a parent checkout's ``ops/csrc``), one chunk a slot
and no split, with its own C entry and plan, and the variants are base,
nomma, nosplit, noepi, and trim (its items trimmed to whole waves).

With ``--wrappers`` it builds nothing and times instead the package's own
wrappers (``ops.upsample1d``, ``ops.downsample1d``) at the six shapes:
CUDA events, device ms, and the host's ms to issue a call (the clock
stops when the last of 50 calls returns). It runs against the package it
is imported from, so a copy of this file in another checkout (PR 23's
included) measures that checkout's wrappers.

Prints one JSON line per launch with ms per variant (``<variant>_ms``
events, ``<variant>_device_ms``) beside its bound (3xTF32 valid taps at
495 TFLOP/s, or x's and y's bytes at 3.35 TB/s), then the nvidia-smi name
and power limit line. Needs nvcc (but for ``--wrappers``) and one CUDA
device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from cindm_tpu_torch.ops import _build
from cindm_tpu_torch.ops.resample import downsample_phase_weights, upsample_phase_weights
from cindm_tpu_torch.tools.forward_profile import stage_device_ms
from cindm_tpu_torch.tools.stage_ablation import ms_per_call

SOURCE, RING = "resample.cu", "stage_ring.cuh"
_MMA = """    wgmma_tf32(acc, as, weight_desc(big));
    wgmma_tf32(acc, ab, weight_desc(big + kPlane));
    wgmma_tf32(acc, ab, weight_desc(big));"""
_MMA_SS = """          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a + R::kABytes), weight_desc(b));
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a), weight_desc(b + kPlane));
          wgmma_tf32_ss(acc, box_desc<R::kPitch>(a), weight_desc(b));"""
_SPLIT = "    for (int i = t; i < kUnits; i += 32 * kSplitWarps) {"
_COMMON = {
    "nomma": [(RING, _MMA, "    (void)big;"), (RING, _MMA_SS, "          (void)a, (void)b;")],
    "nosplit": [(RING, _SPLIT, "    for (int i = t; i < 0; i += 32 * kSplitWarps) {")],
}
_STORE = "      __stcs(reinterpret_cast<float4*>(out + (row0 + tr.r[i]) * ld + c4), o);"
_PLAIN_STORE = "      *reinterpret_cast<float4*>(out + (row0 + tr.r[i]) * ld + c4) = o;"  # PR 23's
_NOEPI = [(SOURCE, _STORE, "      (void)o;")]
_WHOLE = [(SOURCE, "a.stages >= kResSplitMinChunks, &a.split, &ctas", "false, &a.split, &ctas")]
_TRIM = _WHOLE + [(SOURCE, "  a.work = s.work;",
                   "  if (a.items > ctas / a.cs) a.items -= a.items % (ctas / a.cs);\n  a.work = s.work;")]
# (file, old, new) patches of this tree's kernel
VARIANTS = {
    "base": [],
    **_COMMON,
    "noepi": _NOEPI,
    "whole": _WHOLE,
    "splitall": [(SOURCE, "constexpr int kResSplitMinChunks = 32;", "constexpr int kResSplitMinChunks = 2;")],
    "trim": _TRIM,
    "trimnoepi": _TRIM + _NOEPI,
    "nostream": [(SOURCE, _STORE, _PLAIN_STORE)],
    "nt64": [],
}
# the variants whose C side splits no item, and the one that splits at two chunks or more
NO_SPLIT = ("whole", "trim", "trimnoepi")
SPLIT_ALL_MIN = 2


def variant_plan(name: str, B: int, T: int, C: int, up: bool, sms: int) -> _build.ResamplePlan:
    """The plan that variant ``name``'s C side recomputes and takes: the
    kernel's own (``plan_resample``), at N tile 64 (``nt64``), or with the
    split tail that its patched rule makes."""
    if name == "nt64":
        return _build.resample_plan_at(B, T, C, up, 64, sms)
    p = _build.plan_resample(B, T, C, up, sms)
    if name not in NO_SPLIT and name != "splitall":
        return p
    clusters = sms // p.cluster
    tail, qt, parts = _build.stage_split(p.items, p.stages, clusters,
                                         name == "splitall" and p.stages >= SPLIT_ALL_MIN)
    return dataclasses.replace(p, tail=tail, tail_clusters=qt, max_parts=parts,
                               ctas=p.cluster * min(clusters, max(p.items - tail, qt)))


# (file, old, new) patches of PR 23's kernel (--parent)
PARENT_VARIANTS = {
    "base": [],
    **_COMMON,
    "noepi": [(SOURCE, _PLAIN_STORE, "      (void)o;")],
    "trim": [(SOURCE, "  const int clusters = sms / a.cs;",
              "  const int clusters = sms / a.cs;\n  if (a.items > clusters) a.items -= a.items % clusters;")],
}
# (kind, C, T in) of the flagship's 3 Downsample1d and 3 Upsample1d, in call order
SHAPES = [("down", 64, 24), ("down", 128, 12), ("down", 256, 6), ("up", 256, 3), ("up", 128, 6), ("up", 64, 12)]


def patched(name: str, csrc: Path, table: dict) -> dict[str, str]:
    """The sources (resample.cu, stage_ring.cuh) of variant ``name`` of
    ``table``, read from ``csrc``, every pattern replaced; raises where a
    pattern does not occur exactly once in its file."""
    src = {f: (csrc / f).read_text() for f in (SOURCE, RING)}
    for f, old, new in table[name]:
        if src[f].count(old) != 1:
            raise RuntimeError(f"variant {name}: {f} holds {src[f].count(old)} copies of {old!r}")
        src[f] = src[f].replace(old, new)
    return src


def build(name: str, csrc: Path, table: dict, out: Path) -> subprocess.Popen:
    d = out / name
    d.mkdir()
    for f, text in patched(name, csrc, table).items():
        (d / f).write_text(text)
    return subprocess.Popen([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                             "-shared", str(d / SOURCE), "-o", str(d / "lib.so")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bound_ms(kind: str, C: int, T: int, batch: int) -> tuple[float, str]:
    """The launch's least time: 3 x the valid taps' FLOP at 495 TFLOP/s, or
    x's and y's bytes at 3.35 TB/s if those take longer (PERF.md section 2)."""
    if kind == "up":
        taps, t_out = 2 * (2 * T - 1), 2 * T
    else:
        taps, t_out = 3 * (T // 2) - 1, T // 2
    ops = 3 * 2 * batch * taps * C * C / 495e12 * 1e3
    nbytes = 4 * batch * (T + t_out) * C / 3.35e12 * 1e3
    return (ops, "operations") if ops >= nbytes else (nbytes, "bytes")


def parent_plan(B: int, T: int, C: int, up: bool, sms: int) -> tuple[int, int]:
    """PR 23's plan: (N tile, CTAs): the fewer waves of cluster items times
    the tile's width, 128 on a tie; no split."""
    row_tiles = -(-B // (_build.TILE_ROWS // (T if up else T // 2)))
    pairs = -(-row_tiles // 2)
    clusters = sms // 2
    items = {nt: pairs * (2 if up else 1) * -(-C // nt) for nt in (128, 64)}
    nt = min(items, key=lambda n: -(-items[n] // clusters) * n)
    return nt, 2 * min(items[nt], clusters)


def inputs(g, dev, kind: str, C: int, T: int, batch: int):
    """Seeded x, w (the port's layout: up [C, C, 4], down [3, C, C]), b."""
    x = torch.randn((batch, T, C), generator=g, device=dev)
    w = torch.randn((C, C, 4) if kind == "up" else (3, C, C), generator=g, device=dev) / (3 * C) ** 0.5
    return x, w, 0.1 * torch.randn(C, generator=g, device=dev)


def host_ms(fn, reps: int = 50) -> float:
    """Host ms to issue one call of ``fn``: the clock stops when the last of
    ``reps`` calls returns, before the card is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def wrappers(batch: int, dev) -> None:
    """The package's wrappers at the six shapes: events, device and host ms."""
    from cindm_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(0)
    for kind, C, T in SHAPES:
        x, w, b = inputs(g, dev, kind, C, T, batch)
        kern = ops.upsample1d if kind == "up" else ops.downsample1d
        call = lambda kern=kern, x=x, w=w, b=b: kern(x, w, b)
        ms, by = bound_ms(kind, C, T, batch)
        dms = stage_device_ms(torch, call, reps=3, name="resample")
        print(json.dumps({"kind": kind, "C": C, "T": T, "B": batch, "bound_ms": ms, "bound_by": by,
                          "ms": ms_per_call(call),
                          "device_ms": dms[0] if isinstance(dms, list) and len(dms) == 1 else dms,
                          "host_ms": host_ms(call)}), flush=True)


def ablation(names: list[str], csrc: Path, parent: bool, batch: int, dev) -> None:
    """Builds variants ``names`` of the kernel in ``csrc`` (PR 23's where
    ``parent``) and times each at the six shapes."""
    table = PARENT_VARIANTS if parent else VARIANTS
    sms = _build.num_sms(dev)
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT, prefix="resample-ablation-") as tmp:
        procs = {n: build(n, csrc, table, Path(tmp)) for n in names}
        fns = {}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {n}:\n{log}")
            fn = ctypes.CDLL(str(Path(tmp) / n / "lib.so")).cindm_resample
            fn.argtypes = [_build._P] * 5 + [_build._I] * 6 + [_build._P] if parent else \
                _build.SIGNATURES["cindm_resample"]
            fn.restype = ctypes.c_int
            fns[n] = fn
        g = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for kind, C, T in SHAPES:
            up = kind == "up"
            x, w, b = inputs(g, dev, kind, C, T, batch)
            out = torch.empty((batch, 2 * T if up else T // 2, C), device=dev)
            parts = (upsample_phase_weights if up else downsample_phase_weights)(w)
            ms, by = bound_ms(kind, C, T, batch)
            row = {"kind": kind, "C": C, "T": T, "B": batch, "bound_ms": ms, "bound_by": by}
            for n, fn in fns.items():
                if parent:
                    nt, ctas = parent_plan(batch, T, C, up, sms)
                    args = (batch, T, C, int(up), nt, ctas)
                else:
                    plan = variant_plan(n, batch, T, C, up, sms)
                    nt = plan.n_tile
                    work = _build.scratch(max(plan.work_bytes, 16), dev)
                    counters = torch.zeros(max(plan.counters, 1), dtype=torch.int32, device=dev)
                    launch = _build.resample_launch(plan, batch, T, C, work, counters)
                    args = (ctypes.byref(launch),)
                    row[n + "_plan"] = dict(n_tile=nt, items=plan.items, stages=plan.stages, ctas=plan.ctas,
                                            split_items=plan.tail, max_parts=plan.max_parts)
                pa, pb = (_build.stage_weights_reference(t, nt) for t in parts)

                def call(fn=fn, n=n, pa=pa, pb=pb, args=args):
                    err = fn(*(t.data_ptr() for t in (x, pa, pb, b, out)), *args, stream)
                    if err:
                        raise RuntimeError(f"{n}: cudaError_t {err}")
                row[n + "_ms"] = ms_per_call(call)
                dms = stage_device_ms(torch, call, reps=3, name="resample")
                row[n + "_device_ms"] = dms[0] if isinstance(dms, list) and len(dms) == 1 else dms
                if not parent and int(counters.abs().sum()):
                    raise RuntimeError(f"{n}: the split tiles' counters are not back at 0")
            print(json.dumps(row), flush=True)


def main(argv: list[str]) -> int:
    opts = {}
    for flag in ("--parent", "--batch"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    batch = int(opts.get("--batch", 5376))
    dev = torch.device("cuda")
    if "--wrappers" in argv:
        wrappers(batch, dev)
    else:
        parent = Path(opts["--parent"]).resolve() if "--parent" in opts else None
        names = argv[0].split(",") if argv else list(PARENT_VARIANTS if parent else VARIANTS)
        ablation(names, parent or _build.CSRC, parent is not None, batch, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
