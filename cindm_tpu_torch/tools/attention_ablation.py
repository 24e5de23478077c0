"""Where the time of the linear attention kernel goes, by ablation.

    python3 -m cindm_tpu_torch.tools.attention_ablation [variant,...]

Builds copies of ``ops/csrc/linear_attention.cu`` in which one part of the
kernel is cut out, and times each copy's ``cindm_linear_attention`` at
batch 5,376 on the flagship's 8 attention blocks with CUDA events (the
weights laid out beforehand, ``_build.stage_weights_reference``; the
CTAs from ``_build.plan_attention``). The cut copies compute wrong
results: only their times mean something. Each cut patches one place or
a few, whose patterns must each occur exactly once in the source
(``patched``). Variants:

    base     the kernel as it is
    noattn   no CUDA-core attention (softmax, k^T v, q (k^T v)): q's
             columns stay where the hidden tile would be
    noqkv    no q | k | v product: its wgmmas, and with them the xn
             fragments they read (the loads and splits), go
    noout    no out product (the epilogue stores bias and residual only)
    nol2     no weight feed: the ring's slots complete without their bulk
             copies (no weight read from L2)
    noload   no tile load: the consumers' x fragments and residual and the
             statistics warps' reads of x are constants

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
    "noattn": [("for (int smp = warp; smp < a.samples; smp += kConsumerWarps)",
                "for (int smp = warp; smp < 0; smp += kConsumerWarps)")],
    "noqkv": [("""          cindm::wgmma_tf32_ss(acc[t], cindm::weight_desc(abig + kAPlane), cindm::weight_desc(big));
          cindm::wgmma_tf32_ss(acc[t], cindm::weight_desc(abig), cindm::weight_desc(big + kQkvBlock / 2));
          cindm::wgmma_tf32_ss(acc[t], cindm::weight_desc(abig), cindm::weight_desc(big));
""", "          (void)big;\n")],
    "noout": [("""            cindm::wgmma_tf32(o, hsmall[k], cindm::weight_desc(big));
            cindm::wgmma_tf32(o, hbig[k], cindm::weight_desc(big + kOutBlock / 2));
            cindm::wgmma_tf32(o, hbig[k], cindm::weight_desc(big));
""", "            (void)big;\n")],
    "nol2": [("    cindm::mbar_expect_tx(full + 8 * slot, bytes);", "    cindm::mbar_expect_tx(full + 8 * slot, 0 * bytes);"),
             ("        cindm::bulk_load(ring + slot * kSlotBytes + kAOff + t * kQkvBlock,",
              "        if (0) cindm::bulk_load(ring + slot * kSlotBytes + kAOff + t * kQkvBlock,"),
             ("        cindm::bulk_load(ring + slot * kSlotBytes, a.wo",
              "        if (0) cindm::bulk_load(ring + slot * kSlotBytes, a.wo")],
    "noload": [("""        xv[u][0] = live0 ? __ldg(x0 + k) : 0.f;
        xv[u][1] = live1 ? __ldg(x0 + 8 * a.C + k) : 0.f;
        xv[u][2] = live0 ? __ldg(x0 + k + 4) : 0.f;
        xv[u][3] = live1 ? __ldg(x0 + 8 * a.C + k + 4) : 0.f;
""", """        xv[u][0] = live0 ? 0.5f : 0.f;
        xv[u][1] = live1 ? 0.25f : 0.f;
        xv[u][2] = live0 ? 0.125f : 0.f;
        xv[u][3] = live1 ? 0.75f : 0.f;
"""),
               ("xres[jn][0] = in && live0 ? __ldg(reinterpret_cast<const float2*>(x0 + col))",
                "xres[jn][0] = in && live0 ? make_float2(0.5f, 0.25f)"),
               ("xres[jn][1] = in && live1 ? __ldg(reinterpret_cast<const float2*>(x0 + 8 * a.C + col))",
                "xres[jn][1] = in && live1 ? make_float2(0.125f, 0.75f)"),
               ("const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));",
                "const float4 v = make_float4(0.5f, 0.25f, 0.125f, 0.75f);"),
               ("const float4 w = __ldg(reinterpret_cast<const float4*>(xr + c));",
                "const float4 w = make_float4(0.5f, 0.25f, 0.125f, 0.75f);")],
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
            wq = _build.stage_weights_reference(wqkv, _build.ATTN_QKV_NT)
            wo = _build.stage_weights_reference(wout, _build.ATTN_OUT_NT)
            out = torch.empty_like(x)
            ctas = _build.plan_attention(BATCH, T, C, _build.num_sms(dev)).ctas
            row = {"C": C, "T": T, "B": BATCH}
            for n, fn in fns.items():
                def call(fn=fn, n=n):
                    err = fn(*(t.data_ptr() for t in (x, gain, wq, wo, bout, out)), BATCH, T, C, ctas, 1e-5,
                             stream)
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
