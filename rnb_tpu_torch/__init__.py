"""rnb_tpu_torch — the PyTorch/CUDA port of rnb_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``rnb_tpu``), with its
layout and names: the same pipeline of client -> fused decode loader ->
R(2+1)D network runner, driven by the repo's own JSON configs. Plain
tensor code is PyTorch; every TPU kernel on a ported path is a kernel
written by hand for ``sm_90a`` (``csrc/``), launched for CUDA tensors,
with its plain PyTorch version beside it for CPU tensors.

This package imports neither ``jax`` nor anything of ``rnb_tpu``.
Entry points run on ``cuda:0`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
