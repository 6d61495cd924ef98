"""User-facing dictionary façade (reference include/dictionary.hpp:10-183).

Wraps an Index with batched query methods. Two engines share the same index
arrays: the NumPy host engine (`oracle`, always available, also the semantic
reference) and the PyTorch device engine (`TorchEngine`, on the card by
default). Batched inputs are either lists of ASCII kmers or packed uint64
arrays.
"""

import numpy as np

from . import kmer as K
from . import oracle
from .constants import INVALID_UINT64
from .engine import TorchEngine
from .index import Index

INVALID = np.uint64(INVALID_UINT64)


def to_device(dictionary_or_index, device="cuda"):
    """TorchEngine for a Dictionary or Index on `device` (the card unless
    the caller names another)."""
    index = getattr(dictionary_or_index, "index", dictionary_or_index)
    return TorchEngine(index, device)


class Dictionary:
    def __init__(self, index: Index, device=None):
        self.index = index
        self._engines = {}
        if device:
            self.to_device(device)

    # ------------------------------------------------------------- build/load

    @classmethod
    def build(cls, input_path, config):
        from .builder.build import build as _build

        return cls(_build(input_path, config))

    @classmethod
    def load(cls, path):
        return cls(Index.load(path))

    def save(self, path):
        self.index.save(path)

    def to_device(self, device="cuda"):
        """The TorchEngine on `device`, built once per device."""
        key = str(device)
        if key not in self._engines:
            self._engines[key] = TorchEngine(self.index, device)
        return self._engines[key]

    # ------------------------------------------------------------- properties

    @property
    def k(self):
        return self.index.k

    @property
    def m(self):
        return self.index.m

    def num_kmers(self):
        return self.index.num_kmers

    def num_strings(self):
        return self.index.num_strings

    def canonical(self):
        return self.index.canonical

    def weighted(self):
        return self.index.weights is not None

    def string_size(self, string_id):
        return self.index.string_size(string_id)

    def string_offsets(self, string_id):
        ep = self.index.string_endpoints
        return int(ep[string_id]), int(ep[string_id + 1])

    # ------------------------------------------------------------- queries

    def _to_packed(self, kmers):
        if isinstance(kmers, (list, tuple)):
            return np.stack([K.string_to_kmer(s, self.k) for s in kmers])
        if isinstance(kmers, str):
            return K.string_to_kmer(kmers, self.k)[None, :]
        return np.atleast_2d(np.asarray(kmers, dtype=np.uint64))

    def lookup(self, kmers, check_reverse_complement=True):
        """Batched lookup -> dict of arrays (kmer_id, kmer_id_in_string,
        kmer_offset, kmer_orientation, string_id, string_begin, string_end,
        minimizer_found)."""
        return oracle.lookup(self.index, self._to_packed(kmers), check_reverse_complement)

    def is_member(self, kmers, check_reverse_complement=True):
        return self.lookup(kmers, check_reverse_complement)["kmer_id"] != INVALID

    def access(self, kmer_ids, as_strings=False):
        kmers = oracle.access(self.index, kmer_ids)
        if as_strings:
            return [K.kmer_to_string(km, self.k) for km in kmers]
        return kmers

    def weight(self, kmer_ids):
        if self.index.weights is None:
            raise RuntimeError("dictionary is not weighted")
        return self.index.weights.weight(kmer_ids)

    # ------------------------------------------------------------- navigation

    def kmer_forward_neighbours(self, kmers, check_reverse_complement=True):
        """For each kmer, lookup of the 4 forward neighbours (drop first char,
        append each nucleotide; src/dictionary.cpp:112-119). Returns a dict of
        (N, 4) arrays."""
        packed = self._to_packed(kmers)
        return self._neighbours(packed, forward=True, rc=check_reverse_complement)

    def kmer_backward_neighbours(self, kmers, check_reverse_complement=True):
        packed = self._to_packed(kmers)
        return self._neighbours(packed, forward=False, rc=check_reverse_complement)

    def kmer_neighbours(self, kmers, check_reverse_complement=True):
        packed = self._to_packed(kmers)
        return {
            "forward": self._neighbours(packed, True, check_reverse_complement),
            "backward": self._neighbours(packed, False, check_reverse_complement),
        }

    def string_neighbours(self, string_id, check_reverse_complement=True):
        """Neighbours of a string: forward of its last kmer, backward of its
        first kmer (src/dictionary.cpp:190-201)."""
        b, e = self.string_offsets(string_id)
        k = self.k
        suffix = K.read_kmers_at(self.index.strings64, np.array([e - k + 1]), k - 1)
        prefix = K.read_kmers_at(self.index.strings64, np.array([b]), k - 1)
        # suffix occupies char positions 0..k-2; forward nbrs set char k-1
        # prefix shifted up one char; backward nbrs set char 0
        pw = K.num_words64(k)
        suf = np.zeros((1, pw), dtype=np.uint64)
        suf[:, : suffix.shape[1]] = suffix
        pre_padded = np.zeros((1, pw), dtype=np.uint64)
        pre_padded[:, : prefix.shape[1]] = prefix
        pre = _shift_up_one_char(pre_padded, k)
        return {
            "forward": self._neighbours(suf, True, check_reverse_complement, pre_shifted=True),
            "backward": self._neighbours(pre, False, check_reverse_complement, pre_shifted=True),
        }

    def _neighbours(self, packed, forward, rc, pre_shifted=False):
        k = self.k
        n = len(packed)
        if forward:
            base = packed if pre_shifted else _drop_one_char(packed, k)
            variants = [_set_char(base, k - 1, c, k) for c in range(4)]
        else:
            base = packed if pre_shifted else _shift_up_one_char(packed, k)
            variants = [_set_char(base, 0, c, k) for c in range(4)]
        allk = np.concatenate(variants)  # (4N, W) grouped by nucleotide code
        res = oracle.lookup(self.index, allk, rc)
        # reorder to (N, 4) in alphabet order A,C,T,G (code order == alphabet
        # order of the reference's nucleotides[] = "ACTG", kmer.hpp:118)
        return {key: val.reshape(4, n).T for key, val in res.items()}

    # ------------------------------------------------------------- iteration

    def __iter__(self):
        return self.at_kmer_id(0)

    def at_kmer_id(self, begin, end=None, batch=65536):
        """Yield (kmer_id, packed kmer) in id order (reference spss::iterator)."""
        end = self.num_kmers() if end is None else end
        for lo in range(begin, end, batch):
            hi = min(lo + batch, end)
            ids = np.arange(lo, hi)
            kms = oracle.access(self.index, ids)
            for i, km in zip(ids, kms):
                yield int(i), km

    def at_string_id(self, string_id):
        b, e = self.string_offsets(string_id)
        k = self.k
        begin_kmer_id = b - string_id * (k - 1)
        return self.at_kmer_id(begin_kmer_id, begin_kmer_id + (e - b) - k + 1)

    # ------------------------------------------------------------- streaming

    def streaming_query_from_file(self, path, multiline=False, device="cuda"):
        from .streaming import streaming_query_from_file

        return streaming_query_from_file(self, path, multiline=multiline, device=device)

    # ------------------------------------------------------------- info

    def num_bits(self):
        return self.index.num_bits()


def _drop_one_char(packed, k):
    """Multiword right-shift by one char (2 bits)."""
    out = packed >> np.uint64(2)
    if packed.shape[1] > 1:
        out[:, :-1] |= packed[:, 1:] << np.uint64(62)
    return out


def _shift_up_one_char(packed, k):
    """Multiword left-shift by one char, then mask to k chars
    (reference get_prefix, src/dictionary.cpp:158-164)."""
    out = (packed << np.uint64(2)).astype(np.uint64)
    if packed.shape[1] > 1:
        out[:, 1:] |= packed[:, :-1] >> np.uint64(62)
    return _mask_k(out, k)


def _mask_k(packed, k):
    W = packed.shape[1]
    rem = 2 * k - 64 * (W - 1)
    mask = np.uint64(0xFFFFFFFFFFFFFFFF) if rem == 64 else np.uint64((1 << rem) - 1)
    packed = packed.copy()
    packed[:, W - 1] &= mask
    return packed


def _set_char(packed, i, code, k):
    """Set char i (assumed clear) to code (reference kmer.hpp:80)."""
    out = packed.copy()
    w, b = divmod(2 * i, 64)
    out[:, w] |= np.uint64(code) << np.uint64(b)
    return out
