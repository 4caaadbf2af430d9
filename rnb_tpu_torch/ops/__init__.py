"""Hand-written CUDA ops of the port, each beside its plain version.

The network body is stock PyTorch (cuDNN convolutions, as the JAX
package left its convolutions to XLA). The ops package holds what the
JAX package wrote as Pallas kernels, or what XLA fused and nothing on
the GPU fuses: the yuv420 ingest. Each op has one public entry point
that launches its kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor — never one in place of the other.
"""

from rnb_tpu_torch.ops.preprocess import normalize_u8  # noqa: F401
