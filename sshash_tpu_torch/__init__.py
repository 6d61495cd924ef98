"""sshash_tpu_torch — the k-mer dictionary on PyTorch and CUDA.

A port of sshash_tpu to one NVIDIA H100 (sm_90a). It builds and loads the
same Index files and serves, batched, what the JAX package serves: lookup
(kmer -> id, orientation and string fields), membership, access, weight,
navigation, full iteration and streaming membership over FASTA/FASTQ reads,
with the JAX engine's answers in every lane and field and the same
streaming report. Hand-written CUDA kernels (csrc/*.cu, built with nvcc at
first use) carry the device paths; every kernel has a plain PyTorch
version beside it, which CPU tensors run.

The host side (index build, on-disk format, the NumPy oracle, the read
parsers and the native encoder) is the package's own copy of sshash_tpu's
host modules, under the same names. Nothing here imports JAX or sshash_tpu.
"""

from .builder.build import BuildConfig, build
from .dictionary import Dictionary, to_device
from .index import Index

__all__ = ["BuildConfig", "build", "Dictionary", "Index", "TorchEngine", "to_device"]


def __getattr__(name):
    # the device engine imports torch on first use: the host-only paths
    # (build, permute, the builders' scan workers) never load it
    if name == "TorchEngine":
        from .engine import TorchEngine

        return TorchEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
