"""Vectorized minimizer / super-kmer tuple computation (host, NumPy).

Replaces the reference's threaded rolling-iterator scan
(src/builder/compute_minimizer_tuples.cpp:7-118) with whole-array sliding
windows. Semantics are pinned by util::compute_minimizer (reference
util.hpp:262-283): the minimizer of a kmer is the LEFTMOST m-mer with minimal
mixer hash. For the reverse-complement strand (canonical mode) the rolling
iterator keeps the leftmost minimal m-mer *of the RC kmer* (rightmost in
forward coordinates; reference minimizer_iterator.hpp:117-168); the RC
minimizer replaces the forward one iff its VALUE is strictly smaller
(compute_minimizer_tuples.cpp:82-85).

A "minimizer tuple" is (minimizer_value, pos_in_seq, pos_in_kmer, count):
  pos_in_seq  = absolute char offset (into the concatenated strings) where the
                minimizer m-mer occurrence starts (forward coordinates even
                for RC-selected minimizers);
  pos_in_kmer = offset of that occurrence within the FIRST kmer of the run;
  count       = number of consecutive kmers sharing this occurrence
                (the super-kmer length in kmers).
"""

from dataclasses import dataclass

import numpy as np

from .. import hashing as H
from .. import kmer as K

U64 = np.uint64


@dataclass
class MinimizerTuples:
    minimizer: np.ndarray  # uint64[T]
    pos_in_seq: np.ndarray  # uint64[T] absolute char offsets
    pos_in_kmer: np.ndarray  # uint8[T]
    count: np.ndarray  # uint8[T] (k - m + 1 <= 255 enforced by caller)

    def __len__(self):
        return len(self.minimizer)


def rolling_mmer_values(codes, m):
    """m-mer value starting at every char position (garbage within m-1 of the
    end). codes: uint8[N]. Returns uint64[N]. No gathers: m shifted-slice ORs."""
    n = len(codes)
    acc = np.zeros(n, dtype=U64)
    c64 = codes.astype(U64)
    for j in range(m):
        acc[: n - j] |= c64[j:] << U64(2 * j)
    return acc


def _sliding_argext(h, w, rightmost):
    """For every window start p: index j in [0, w) of the minimal h[p+j].
    Leftmost tie if rightmost=False (strict <, ascending j scan), else
    rightmost (<=). Contiguous slices only. Returns (best_j int8[L], L)."""
    L = len(h) - w + 1
    best = h[:L].copy()
    best_j = np.zeros(L, dtype=np.int8)
    for j in range(1, w):
        cand = h[j : j + L]
        upd = (cand <= best) if rightmost else (cand < best)
        np.copyto(best, cand, where=upd)
        np.copyto(best_j, np.int8(j), where=upd)
    return best_j


def per_position_minimizers(words64, endpoints, k, m, magic, canonical, codes=None):
    """For every kmer position p, the selected (minimizer value, absolute
    occurrence offset). Returns (vals uint64[P], occ_pos int64[P], kmer_pos
    int64[P]) for all valid kmer positions across all sequences."""
    n_chars = int(endpoints[-1])
    w = k - m + 1

    if codes is None:
        codes = K.read_kmers_at(words64, np.arange(n_chars, dtype=np.int64), 1)[:, 0].astype(np.uint8)
    mvals = rolling_mmer_values(codes, m)
    fh = H.mixer64(mvals, magic)

    # valid kmer start positions (within-sequence)
    seq_lens = np.diff(endpoints.astype(np.int64))
    starts = endpoints[:-1].astype(np.int64)
    kmer_counts = seq_lens - k + 1
    kmer_pos = _ranges(starts, kmer_counts)

    j_f_all = _sliding_argext(fh, w, rightmost=False)
    j_f = np.take(j_f_all, kmer_pos).astype(np.int64)
    occ_f = kmer_pos + j_f
    val_f = np.take(mvals, occ_f)

    if not canonical:
        return val_f, occ_f, kmer_pos

    rvals = K.revcomp_mmers(mvals, m)
    rh = H.mixer64(rvals, magic)
    # leftmost minimal in RC coordinates == rightmost in forward coordinates:
    # ties resolved toward LARGER forward j (minimizer_iterator.hpp:127,160)
    j_r_all = _sliding_argext(rh, w, rightmost=True)
    j_r = np.take(j_r_all, kmer_pos).astype(np.int64)
    occ_r = kmer_pos + j_r
    val_r = np.take(rvals, occ_r)

    use_rc = val_r < val_f  # strict: compute_minimizer_tuples.cpp:82
    return np.where(use_rc, val_r, val_f), np.where(use_rc, occ_r, occ_f), kmer_pos


def _ranges(starts, counts):
    """Concatenation of ranges [starts[i], starts[i] + counts[i])."""
    total = int(counts.sum())
    out = np.ones(total, dtype=np.int64)
    heads = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out[heads] = starts - np.concatenate([[0], starts[:-1] + counts[:-1] - 1])
    return np.cumsum(out)


def compute_tuples(words64, endpoints, k, m, magic, canonical, codes=None):
    """Run-length encode per-kmer minimizer picks into super-kmer tuples,
    sorted by (minimizer, pos_in_seq). Uses the native single-pass C++
    scanner when available (one memory pass vs ~30 vectorized ones)."""
    assert k - m + 1 <= 255, "super-kmer length must fit in uint8"

    from .. import native

    if codes is not None and native.available():
        mn, ps, pik, cnt = native.tuple_scan(
            codes, endpoints.astype(np.int64), k, m, magic, canonical)
        order = np.lexsort((ps, mn))
        return MinimizerTuples(
            minimizer=mn[order], pos_in_seq=ps[order],
            pos_in_kmer=pik[order], count=cnt[order])

    vals, occ, kpos = per_position_minimizers(words64, endpoints, k, m, magic, canonical, codes)

    # run breaks: new sequence OR minimizer value change OR occurrence change
    # (consecutive kmer positions within a sequence differ by 1)
    new_seq = np.ones(len(kpos), dtype=bool)
    new_seq[1:] = kpos[1:] != kpos[:-1] + 1
    brk = new_seq.copy()
    brk[1:] |= (vals[1:] != vals[:-1]) | (occ[1:] != occ[:-1])
    heads = np.flatnonzero(brk)
    run_len = np.diff(np.concatenate([heads, [len(kpos)]]))
    assert run_len.max() <= k - m + 1

    minimizer = vals[heads]
    pos_in_seq = occ[heads].astype(U64)
    pos_in_kmer = (occ[heads] - kpos[heads]).astype(np.uint8)
    count = run_len.astype(np.uint8)

    order = np.lexsort((pos_in_seq, minimizer))
    return MinimizerTuples(
        minimizer=minimizer[order],
        pos_in_seq=pos_in_seq[order],
        pos_in_kmer=pos_in_kmer[order],
        count=count[order],
    )
