"""Dictionary hook: the counterpart of sshash_tpu.Dictionary.to_device."""

from .engine import TorchEngine


def to_device(dictionary_or_index, device):
    """TorchEngine for a sshash_tpu Dictionary or Index on `device`."""
    index = getattr(dictionary_or_index, "index", dictionary_or_index)
    return TorchEngine(index, device)
