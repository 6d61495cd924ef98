"""Self-consistency check suite (reference test/check.hpp + sshash check).

Everything is batched NumPy instead of the reference's thread-sharded id
loops (test/check.hpp:7-76): the id space is swept in large batches. The
host oracle is the reference; an `engine` (a TorchEngine, on the card or
the CPU) answers the lookups and navigations held to it.
"""

import numpy as np

from . import kmer as K
from . import oracle
from .constants import BACKWARD_ORIENTATION, FORWARD_ORIENTATION, INVALID_UINT64

INVALID = np.uint64(INVALID_UINT64)


def check_dictionary(index, batch=1 << 16, verbose=False, engine=None):
    """access(id) -> lookup must round-trip for EVERY id (check.hpp:7-76)."""
    n = index.num_kmers
    for lo in range(0, n, batch):
        ids = np.arange(lo, min(lo + batch, n))
        kmers = oracle.access(index, ids)
        # 50% reverse-complemented, like check_correctness_lookup
        half = len(ids) // 2
        kmers[:half] = K.revcomp_kmers(kmers[:half], index.k)
        if engine is not None:
            res = engine.lookup(kmers)
        else:
            res = oracle.lookup(index, kmers)
        got = res["kmer_id"]
        if not (got == ids.astype(np.uint64)).all():
            bad = np.flatnonzero(got != ids)[0]
            raise AssertionError(
                f"check_dictionary failed at id {ids[bad]}: lookup returned {got[bad]}")
        orient = res["kmer_orientation"]
        want_orient = np.where(np.arange(len(ids)) < half,
                               BACKWARD_ORIENTATION, FORWARD_ORIENTATION)
        # palindromic kmers may legitimately report forward
        mism = (orient != want_orient) & (kmers != K.revcomp_kmers(kmers, index.k)).any(axis=1)
        if mism.any():
            bad = np.flatnonzero(mism)[0]
            raise AssertionError(f"orientation mismatch at id {ids[bad]}")
        if verbose:
            print(f"checked ids [{lo}, {lo + len(ids)})")
    return True


def check_negative_lookups(index, num=1 << 16, seed=0, engine=None):
    """Random kmers should (overwhelmingly) not be found (check.hpp:79-96).
    Returns the number of (legitimately possible) hits."""
    rng = np.random.default_rng(seed)
    W = index.kmer_words64
    kmers = rng.integers(0, 1 << 62, (num, W), dtype=np.uint64)
    rem = 2 * index.k - 64 * (W - 1)
    mask = np.uint64(0xFFFFFFFFFFFFFFFF) if rem == 64 else np.uint64((1 << rem) - 1)
    kmers[:, W - 1] &= mask
    if engine is not None:
        res = engine.lookup(kmers)
    else:
        res = oracle.lookup(index, kmers)
    hits = int((res["kmer_id"] != INVALID).sum())
    # verify every reported hit is a true member (id round-trips)
    if hits:
        hit = res["kmer_id"] != INVALID
        back = oracle.access(index, res["kmer_id"][hit].astype(np.int64))
        fwd_eq = (back == kmers[hit]).all(axis=1)
        rc_eq = (back == K.revcomp_kmers(kmers[hit], index.k)).all(axis=1)
        assert (fwd_eq | rc_eq).all(), "negative lookup returned a non-member id"
    return hits


def check_iterator(index, batch=1 << 16):
    """Iteration must equal access for sequential ids (check.hpp:177-231)."""
    n = index.num_kmers
    ep = index.string_endpoints.astype(np.int64)
    k = index.k
    for lo in range(0, n, batch):
        ids = np.arange(lo, min(lo + batch, n))
        kmers = oracle.access(index, ids)
        # string-piece-aware re-read: offsets must lie inside strings
        kmer_cum = ep - np.arange(len(ep)) * (k - 1)
        sid = np.searchsorted(kmer_cum, ids, side="right") - 1
        off = ids + sid * (k - 1)
        assert (off >= ep[sid]).all() and (off + k <= ep[sid + 1]).all()
        re_read = K.read_kmers_at(index.strings64, off, k)
        assert (re_read == kmers).all()
    return True


def check_string_iterator(index):
    """Per-string windows partition the id space (check.hpp:234-295)."""
    ep = index.string_endpoints.astype(np.int64)
    k = index.k
    total = 0
    for s in range(index.num_strings):
        size = int(ep[s + 1] - ep[s]) - k + 1
        assert size >= 1
        total += size
    assert total == index.num_kmers, (total, index.num_kmers)
    return True


def check_navigation(index, dictionary, num=None, seed=1, batch=1 << 15,
                     engine=None, verbose=False):
    """Navigational query check (check_from_file.hpp:174-226 style): the true
    next/prev kmers in each string must appear in the neighbourhood. Sweeps
    EVERY id when num is None (default), batched; pass num for a sample."""
    ep = index.string_endpoints.astype(np.int64)
    k = index.k
    kmer_cum = ep - np.arange(len(ep)) * (k - 1)
    if num is None:
        ids_all = np.arange(index.num_kmers, dtype=np.int64)
    else:
        ids_all = np.random.default_rng(seed).integers(0, index.num_kmers, num)
    for lo in range(0, len(ids_all), batch):
        ids = ids_all[lo : lo + batch]
        sid = np.searchsorted(kmer_cum, ids, side="right") - 1
        off = ids + sid * (k - 1)
        kmers = K.read_kmers_at(index.strings64, off, k)
        if engine is not None:
            nb = engine.kmer_neighbours(kmers)
            fwd_ids = nb["kmer_id"][:, :4]
            bwd_ids = nb["kmer_id"][:, 4:]
        else:
            fwd_ids = dictionary.kmer_forward_neighbours(kmers)["kmer_id"]
            bwd_ids = dictionary.kmer_backward_neighbours(kmers)["kmer_id"]
        want = ids.astype(np.uint64)
        has_next = off + k < ep[sid + 1]
        found_next = (fwd_ids == (want + 1)[:, None]).any(axis=1)
        assert found_next[has_next].all(), "forward neighbour missing"
        has_prev = off > ep[sid]
        found_prev = (bwd_ids == (want - 1)[:, None]).any(axis=1)
        assert found_prev[has_prev].all(), "backward neighbour missing"
        if verbose:
            print(f"checked navigation for ids [{lo}, {lo + len(ids)})")
    return True


def check_navigational_string_queries(index, dictionary, batch=4096,
                                      verbose=False):
    """EVERY string: string-level neighbours (prefix/suffix construction)
    must equal kmer-level neighbours at the string's first/last kmer, on all
    result fields incl. orientation (check.hpp:99-174, equal_lookup_result).
    Batched over strings instead of the reference's thread shards."""
    from .dictionary import _shift_up_one_char

    ep = index.string_endpoints.astype(np.int64)
    k = index.k
    ns = index.num_strings
    pw = K.num_words64(k)
    fields = ("kmer_id", "kmer_id_in_string", "kmer_offset", "string_id",
              "string_begin", "string_end", "kmer_orientation")
    for lo in range(0, ns, batch):
        sids = np.arange(lo, min(lo + batch, ns))
        b, e = ep[sids], ep[sids + 1]
        # kmer-level path: full first/last kmers
        first = K.read_kmers_at(index.strings64, b, k)
        last = K.read_kmers_at(index.strings64, e - k, k)
        bwd = dictionary.kmer_backward_neighbours(first)
        fwd = dictionary.kmer_forward_neighbours(last)
        # string-level path: k-1-char suffix/prefix like string_neighbours
        suffix = K.read_kmers_at(index.strings64, e - (k - 1), k - 1)
        prefix = K.read_kmers_at(index.strings64, b, k - 1)
        suf = np.zeros((len(sids), pw), dtype=np.uint64)
        suf[:, : suffix.shape[1]] = suffix
        prep = np.zeros((len(sids), pw), dtype=np.uint64)
        prep[:, : prefix.shape[1]] = prefix
        pre = _shift_up_one_char(prep, k)
        sfwd = dictionary._neighbours(suf, True, True, pre_shifted=True)
        sbwd = dictionary._neighbours(pre, False, True, pre_shifted=True)
        for key in fields:
            if not np.array_equal(sfwd[key], fwd[key]):
                bad = int(np.argwhere(sfwd[key] != fwd[key])[0][0])
                raise AssertionError(
                    f"string {sids[bad]}: forward {key} string-level != kmer-level")
            if not np.array_equal(sbwd[key], bwd[key]):
                bad = int(np.argwhere(sbwd[key] != bwd[key])[0][0])
                raise AssertionError(
                    f"string {sids[bad]}: backward {key} string-level != kmer-level")
        if verbose:
            print(f"checked strings [{lo}, {lo + len(sids)})")
    return True


def check_weights(index, parsed_weights):
    """Every header weight equals dict.weight(kmer_id)
    (check_from_file.hpp:229-278)."""
    vals, lens = parsed_weights
    expanded = np.repeat(vals, np.diff(lens.astype(np.int64)))
    assert len(expanded) == index.num_kmers
    got = index.weights.weight(np.arange(index.num_kmers))
    assert (got == expanded).all()
    return True


def check_all(dictionary, verbose=False, engine=None, navigation_sample="auto"):
    """Full suite: every id round-trips, every id's neighbourhood is
    navigable, every string's string-level vs kmer-level neighbours agree
    (reference sshash check, tools/sshash.cpp:20-37). Navigation sweeps ALL
    ids when a device engine is provided (or navigation_sample=None); the
    oracle-only path samples by default (8 host lookups per id)."""
    index = dictionary.index
    check_dictionary(index, verbose=verbose, engine=engine)
    hits = check_negative_lookups(index, engine=engine)
    check_iterator(index)
    check_string_iterator(index)
    if navigation_sample == "auto":
        navigation_sample = None if engine is not None else 8192
    check_navigation(index, dictionary, num=navigation_sample, engine=engine,
                     verbose=verbose)
    check_navigational_string_queries(index, dictionary, verbose=verbose)
    if verbose:
        print(f"check_all OK (negative probe hits: {hits})")
    return True
