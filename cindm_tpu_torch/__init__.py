"""PyTorch/CUDA port of ``cindm_tpu`` for NVIDIA Hopper (H100).

The JAX package ``cindm_tpu`` stays the reference; this package mirrors its
layout (``core/``, ``models/``, ``ops/``, ``sampling/``, ``physics/``,
``utils/``, ``cli/``) so each module has an obvious counterpart. Public
functions keep the JAX package's channel-last ``[B, T, C]`` layout.

On CUDA the denoiser's ResidualTemporalBlocks and its head Conv1dBlock run
through hand-written CUDA kernels (``ops/csrc``); on CPU tensors the same
entry points use their plain PyTorch versions. Entry points default to
``device="cuda"`` and raise when CUDA was asked for and is absent.
"""
