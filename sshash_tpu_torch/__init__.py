"""sshash_tpu_torch — the k-mer dictionary's lookup on PyTorch and CUDA.

A port of sshash_tpu's device engine to one NVIDIA H100 (sm_90a). It
serves batched lookup (kmer -> id, orientation and string fields) from the
same Index files and gives the JAX engine's answers in every lane and
field. Two hand-written CUDA kernels carry the path (csrc/minimizer.cu and
csrc/probe.cu, built with nvcc at first use); every kernel has a plain
PyTorch version beside it, which CPU tensors run.

Host work (index build, the NumPy oracle) comes from sshash_tpu's host
modules; nothing here imports JAX.
"""

from .dictionary import to_device
from .engine import TorchEngine

__all__ = ["TorchEngine", "to_device"]
