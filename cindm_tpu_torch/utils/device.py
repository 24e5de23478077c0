"""Device selection and arithmetic precision shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if CUDA was asked for and is absent.

    The port never carries on silently on the CPU: a caller that wants the
    CPU asks for it.

    Every entry point passes through here, so this is also where the port
    fixes its precision: fp32, as the JAX package computes on the CPU. It
    turns TF32 off for the process, for matmuls and for cuDNN (whose
    default is on, which would run every convolution of the 2D models in
    TF32).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
