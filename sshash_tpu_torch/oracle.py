"""Host (NumPy) query engine — the semantic oracle for the JAX device path.

Vectorized, bit-faithful implementation of the reference query logic:
  * lookup_regular / lookup_canonical: src/dictionary.cpp:7-78 and
    include/spectrum_preserving_string_set.hpp:29-112, 213-275
  * sparse+skew probe: include/sparse_and_skew_index.hpp:34-44, 112-137
  * access: include/offsets.hpp:41-65 + util::read_kmer_at

All results use INVALID (= 2**64 - 1) for "not found" ids, matching
constants::invalid_uint64.
"""

import numpy as np

from . import compact as cv

from . import hashing as H
from . import kmer as K
from .constants import (
    BACKWARD_ORIENTATION,
    FORWARD_ORIENTATION,
    INVALID_UINT64,
    MIN_L,
)

U64 = np.uint64
INVALID = U64(INVALID_UINT64)


def extract_mmers(kmers64, k, m):
    """(N, W) packed kmers -> (N, k-m+1) uint64 m-mer values per window."""
    kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=U64))
    n, W = kmers64.shape
    nw = k - m + 1
    out = np.empty((n, nw), dtype=U64)
    mask = U64((1 << (2 * m)) - 1) if 2 * m < 64 else U64(0xFFFFFFFFFFFFFFFF)
    for j in range(nw):
        w, b = divmod(2 * j, 64)
        v = kmers64[:, w] >> U64(b)
        if b and w + 1 < W:
            v = v | (kmers64[:, w + 1] << U64(64 - b))
        out[:, j] = v & mask
    return out


def compute_minimizer(kmers64, k, m, magic):
    """Leftmost minimal-hash m-mer (reference util.hpp:262-283).
    Returns (value uint64[N], pos_in_kmer int64[N])."""
    mm = extract_mmers(kmers64, k, m)
    h = H.mixer64(mm, magic)
    pos = np.argmin(h, axis=1)  # first occurrence = leftmost
    ar = np.arange(len(mm))
    return mm[ar, pos], pos.astype(np.int64)


def _empty_result(n, minimizer_found=True):
    return {
        "kmer_id": np.full(n, INVALID, dtype=U64),
        "kmer_id_in_string": np.full(n, INVALID, dtype=U64),
        "kmer_offset": np.full(n, INVALID, dtype=U64),
        "kmer_orientation": np.full(n, FORWARD_ORIENTATION, dtype=np.int64),
        "string_id": np.full(n, INVALID, dtype=U64),
        "string_begin": np.full(n, INVALID, dtype=U64),
        "string_end": np.full(n, INVALID, dtype=U64),
        "minimizer_found": np.full(n, minimizer_found, dtype=bool),
    }


def _decode_codewords(index, minvals):
    """minimizer values -> (status, begin, size, partition_id) arrays.

    status: 0 singleton / 1 midload / 2 heavy.
    begin: candidate start — singleton: the offset itself; midload: start
    index into mid_load_buckets; heavy: start index into heavy_load_buckets.
    """
    ids = index.minimizer_mphf(minvals)
    code = cv.take(index.codewords, ids, dtype=np.uint64)
    singleton = (code & U64(1)) == 0
    midload = (code & U64(3)) == U64(1)
    status = np.where(singleton, 0, np.where(midload, 1, 2)).astype(np.int64)

    size = np.ones(len(code), dtype=np.int64)
    begin = (code >> U64(1)).astype(np.int64)  # singleton: offset

    msize = (((code >> U64(2)) & U64((1 << MIN_L) - 1)) + U64(2)).astype(np.int64)
    mlist = (code >> U64(2 + MIN_L)).astype(np.int64)
    mbegin = np.take(index.begin_buckets_of_size, np.clip(msize, 0, (1 << MIN_L))).astype(np.int64) + mlist * msize
    size = np.where(midload, msize, size)
    begin = np.where(midload, mbegin, begin)

    heavy = status == 2
    hbegin = (code >> U64(5)).astype(np.int64)
    hpid = ((code >> U64(2)) & U64(7)).astype(np.int64)
    begin = np.where(heavy, hbegin, begin)
    return status, begin, size, np.where(heavy, hpid, 0)


def _skew_offsets(index, kmers_canon32, begin, pid, heavy_mask):
    """Resolve HEAVYLOAD candidate offsets via the skew index
    (reference sparse_and_skew_index.hpp:34-44)."""
    out = np.zeros(len(begin), dtype=np.int64)
    for p, part in enumerate(index.skew_partitions):
        sel = heavy_mask & (pid == p)
        if not sel.any() or part.mphf.n == 0:
            continue
        mp = part.mphf.eval_words(kmers_canon32[sel])
        pos_in_bucket = np.take(part.positions, mp).astype(np.int64)
        out[sel] = cv.take(index.heavy_load_buckets, begin[sel] + pos_in_bucket)
    return out


def _resolve_ids(index, res, match, kmer_offset):
    """Fill string/id fields for matched lanes; returns accept mask
    (kmer fully inside its string)."""
    k = index.k
    ep = index.string_endpoints.astype(np.int64)
    off = np.where(match, kmer_offset, 0)
    sid = np.searchsorted(ep, off, side="right") - 1
    begin = np.take(ep, sid)
    end = np.take(ep, np.minimum(sid + 1, len(ep) - 1))
    accept = match & (off < end - k + 1)
    res["kmer_offset"] = np.where(accept, off.astype(U64), res["kmer_offset"])
    res["string_id"] = np.where(accept, sid.astype(U64), res["string_id"])
    res["string_begin"] = np.where(accept, begin.astype(U64), res["string_begin"])
    res["string_end"] = np.where(accept, end.astype(U64), res["string_end"])
    res["kmer_id"] = np.where(accept, (off - sid * (k - 1)).astype(U64), res["kmer_id"])
    res["kmer_id_in_string"] = np.where(accept, (off - begin).astype(U64), res["kmer_id_in_string"])
    return accept


def lookup_regular(index, kmers64, mini=None):
    """Batched regular lookup. kmers64: (N, W) packed. Returns result dict."""
    k, m = index.k, index.m
    kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=U64))
    n = len(kmers64)
    magic = H.mixer_magic(index.seed)
    if mini is None:
        minval, minpos = compute_minimizer(kmers64, k, m, magic)
    else:
        minval, minpos = mini
    status, begin, size, pid = _decode_codewords(index, minval)

    kmers32 = K.kmers_to_u32(kmers64, k)
    heavy = status == 2
    skew_off = _skew_offsets(index, kmers32, begin, pid, heavy)

    res = _empty_result(n)
    found = np.zeros(n, dtype=bool)

    max_size = int(size.max()) if n else 1
    for j in range(max_size):
        active = ~found & (j < size)
        if not active.any():
            break
        mid_cand = (
            cv.take(index.mid_load_buckets,
                    np.clip(begin + j, 0, len(index.mid_load_buckets) - 1))
            if len(index.mid_load_buckets) else 0
        )
        cand = np.where(status == 0, begin, np.where(heavy, skew_off, mid_cand))
        cand = np.where(active, cand, 0)
        if j == 0:
            # minimizer guard (spss:47-65): read m chars at first candidate
            read_m = K.read_kmers_at(index.strings64, cand, m)[:, 0]
            guard_fail = active & (read_m != minval)
            res["minimizer_found"] = np.where(guard_fail & ~heavy, False, res["minimizer_found"])
        ko = cand - minpos
        match = active & (cand >= minpos)
        read = K.read_kmers_at(index.strings64, np.where(match, ko, 0), k)
        match &= (read == kmers64).all(axis=1)
        accept = _resolve_ids(index, res, match, ko)
        found |= accept
    res["kmer_orientation"] = np.full(n, FORWARD_ORIENTATION, dtype=np.int64)
    return res


def lookup_canonical_with_info(index, kmers64, kmers_rc64, minval, minpos):
    """Canonical candidate verification for a given minimizer info
    (spss::lookup_canonical + _lookup_canonical, spss:75-112, 237-275)."""
    k, m = index.k, index.m
    kmers64 = np.atleast_2d(kmers64)
    kmers_rc64 = np.atleast_2d(kmers_rc64)
    n = len(kmers64)
    status, begin, size, pid = _decode_codewords(index, minval)
    heavy = status == 2

    canon = np.where(_kmer_less_mask(kmers_rc64, kmers64)[:, None], kmers_rc64, kmers64)
    canon32 = K.kmers_to_u32(canon, k)
    skew_off = _skew_offsets(index, canon32, begin, pid, heavy)

    res = _empty_result(n)
    found = np.zeros(n, dtype=bool)
    minval_rc = K.revcomp_mmers(minval, m)

    max_size = int(size.max()) if n else 1
    for j in range(max_size):
        active = ~found & (j < size)
        if not active.any():
            break
        mid_cand = (
            cv.take(index.mid_load_buckets,
                    np.clip(begin + j, 0, len(index.mid_load_buckets) - 1))
            if len(index.mid_load_buckets) else 0
        )
        cand = np.where(status == 0, begin, np.where(heavy, skew_off, mid_cand))
        cand = np.where(active, cand, 0)
        if j == 0:
            read_m = K.read_kmers_at(index.strings64, cand, m)[:, 0]
            guard_fail = active & (read_m != minval) & (read_m != minval_rc)
            res["minimizer_found"] = np.where(guard_fail & ~heavy, False, res["minimizer_found"])
        # two pos_in_kmer attempts: pos, then k - m - pos (spss:237-247)
        for pos_try in (minpos, (k - m) - minpos):
            ko = cand - pos_try
            match = active & ~found & (cand >= pos_try)
            read = K.read_kmers_at(index.strings64, np.where(match, ko, 0), k)
            eq_f = (read == kmers64).all(axis=1)
            eq_r = (read == kmers_rc64).all(axis=1)
            match &= eq_f | eq_r
            orient = np.where(eq_r & ~eq_f, BACKWARD_ORIENTATION, FORWARD_ORIENTATION)
            accept = _resolve_ids(index, res, match, ko)
            res["kmer_orientation"] = np.where(accept, orient, res["kmer_orientation"])
            found |= accept
    return res


def _kmer_less_mask(a, b):
    less = np.zeros(len(a), dtype=bool)
    decided = np.zeros(len(a), dtype=bool)
    for w in range(a.shape[1] - 1, -1, -1):
        lt = a[:, w] < b[:, w]
        gt = a[:, w] > b[:, w]
        less |= (~decided) & lt
        decided |= lt | gt
    return less


def _merge_results(res_a, res_b, use_b):
    out = {}
    for key in res_a:
        va, vb = res_a[key], res_b[key]
        out[key] = np.where(use_b, vb, va)
    return out


def lookup_canonical(index, kmers64):
    """Full canonical lookup (src/dictionary.cpp:25-42): compute both strand
    minimizers, probe the smaller value first, tie probes both."""
    k, m = index.k, index.m
    kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=U64))
    kmers_rc64 = K.revcomp_kmers(kmers64, k)
    magic = H.mixer_magic(index.seed)
    mv_f, mp_f = compute_minimizer(kmers64, k, m, magic)
    mv_r, mp_r = compute_minimizer(kmers_rc64, k, m, magic)

    use_rc_first = mv_r < mv_f
    tie = mv_r == mv_f
    mv1 = np.where(use_rc_first, mv_r, mv_f)
    mp1 = np.where(use_rc_first, mp_r, mp_f)
    res = lookup_canonical_with_info(index, kmers64, kmers_rc64, mv1, mp1)
    # ties retry with the other info on miss
    retry = tie & (res["kmer_id"] == INVALID)
    if retry.any():
        res2 = lookup_canonical_with_info(index, kmers64, kmers_rc64, mv_r, mp_r)
        res = _merge_results(res, res2, retry)
    return res


def lookup(index, kmers64, check_reverse_complement=True):
    """Top-level lookup (src/dictionary.cpp:64-78)."""
    if index.canonical:
        return lookup_canonical(index, kmers64)
    kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=U64))
    res = lookup_regular(index, kmers64)
    if check_reverse_complement:
        miss = res["kmer_id"] == INVALID
        if miss.any():
            rc = K.revcomp_kmers(kmers64, index.k)
            res_rc = lookup_regular(index, rc)
            res_rc["kmer_orientation"] = np.full(len(kmers64), BACKWARD_ORIENTATION, dtype=np.int64)
            # combined flag (what streaming needs, streaming_query.hpp:172-178)
            res_rc["minimizer_found"] = res_rc["minimizer_found"] | res["minimizer_found"]
            res = _merge_results(res, res_rc, miss)
    return res


def access(index, kmer_ids):
    """kmer ids -> packed kmers (src/dictionary.cpp:90-94, offsets.hpp:41-65)."""
    k = index.k
    ids = np.asarray(kmer_ids, dtype=np.int64)
    ep = index.string_endpoints.astype(np.int64)
    # cumulative kmer count before string j is ep[j] - j*(k-1)
    kmer_cum = ep - np.arange(len(ep)) * (k - 1)
    sid = np.searchsorted(kmer_cum, ids, side="right") - 1
    off = ids + sid * (k - 1)
    return K.read_kmers_at(index.strings64, off, k)


def is_member(index, kmers64, check_reverse_complement=True):
    return lookup(index, kmers64, check_reverse_complement)["kmer_id"] != INVALID
