"""Sanitizer mode: the counterpart of sshash_tpu/debug.py (the reference's
sanitizer build, `-D SSHASH_USE_SANITIZERS=On`).

Three layers surface wrong answers at run time instead of passing them on:

  1. ``debug_mode()``: synchronous launches (kernels.sync_launches). Every
     kernel launch waits for its kernel and raises on any CUDA error, so a
     fault shows at the launch that caused it. The JAX package's
     debug_mode flips jax_debug_nans, a trap for NaN-producing operations;
     the port's kernels compute on integers only, where the trap that
     matters is a device fault;
  2. ``checkified_lookup(engine)``: the engine's lookup, then the check
     kernel (csrc/check.cu, K13) over its result: every found lane must
     carry kmer_id < num_kmers, kmer_offset < num_chars, orientation +-1
     and string_begin <= kmer_offset. A violation raises SanitizerError
     with the JAX package's message. A lookup of rebased (v2) rows returns
     no offset fields, and there the id and orientation are checked (the
     JAX version reads kmer_offset there and fails with a KeyError);
  3. ``assert_matches_oracle(dictionary, kmers64)``: the engine's lookup
     against the NumPy oracle.

Set ``SSHASH_DEBUG=1`` to engage layers 1 and 2 on every TorchEngine
lookup (engine.py reads it at construction).
"""

import contextlib

import numpy as np
import torch

from . import kernels, oracle
from .ops import u64 as u

# the four postconditions, in the order they are checked and reported
MESSAGES = ("sanitizer: found lane with kmer_id >= num_kmers",
            "sanitizer: found lane with kmer_offset >= num_chars",
            "sanitizer: orientation not in {+1, -1}",
            "sanitizer: kmer_offset before its string_begin")


class SanitizerError(RuntimeError):
    """A found lane of a checked lookup violates a postcondition."""


def check_plain(found, kmer_id, orientation, kmer_offset, string_begin, num_kmers, num_chars):
    """Plain version of the check kernel: (4,) int32 flags, 1 where some
    found lane violates predicate p of MESSAGES. The offset fields are
    None for a lookup of rebased (v2) rows; predicates 1 and 3 then hold."""
    kid = u.u32(kmer_id)
    no = torch.zeros_like(found)
    off = no if kmer_offset is None else found & (u.u32(kmer_offset) >= num_chars)
    beg = no if kmer_offset is None else found & (u.u32(string_begin) > u.u32(kmer_offset))
    preds = (found & (kid >= num_kmers), off,
             found & (orientation != 1) & (orientation != -1), beg)
    return torch.stack([p.any() for p in preds]).to(torch.int32)


check = kernels.by_device(kernels.check_kernel, check_plain, "check")


@contextlib.contextmanager
def debug_mode():
    """Synchronous launches for the dynamic extent of the block."""
    prev = kernels.sync_launches
    kernels.sync_launches = True
    try:
        yield
    finally:
        kernels.sync_launches = prev


def checkified_lookup(engine, num_kmers_bound=None, num_chars_bound=None):
    """Return ``run(kmers32) -> result dict``: the engine's full lookup
    under debug_mode, then the check kernel over its result, read back
    once; raises SanitizerError when a found lane violates a
    postcondition. The bound overrides exist for tests (force a violation
    without corrupting device tables)."""
    nk = int(num_kmers_bound if num_kmers_bound is not None else engine.index.num_kmers)
    nc = int(num_chars_bound if num_chars_bound is not None else engine.index.num_chars)

    def run(kmers32):
        with debug_mode():
            res = engine._lookup(engine.tables, kmers32)
            flags = check(res["found"], res["kmer_id"], res["kmer_orientation"],
                          res.get("kmer_offset"), res.get("string_begin"), nk, nc)
            flags = flags.cpu().tolist()
        for msg, bad in zip(MESSAGES, flags):
            if bad:
                raise SanitizerError(msg)
        return res

    return run


def assert_matches_oracle(dictionary, kmers64, device="cuda"):
    """The lookup of the dictionary's engine on `device` against the NumPy
    oracle on the same batch; raises AssertionError naming the first
    mismatching field."""
    kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=np.uint64))
    dev = dictionary.to_device(device).lookup(kmers64)
    ref = oracle.lookup(dictionary.index, kmers64)
    for key in ("kmer_id", "kmer_orientation", "string_id", "kmer_offset"):
        if key in dev and key in ref:
            d, r = np.asarray(dev[key]), np.asarray(ref[key])
            bad = np.nonzero(d != r)[0]
            assert bad.size == 0, (
                f"device/oracle mismatch on {key} at lanes {bad[:8]}: "
                f"device={d[bad[:8]]} oracle={r[bad[:8]]}")
