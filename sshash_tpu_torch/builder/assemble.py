"""Sparse-and-skew index assembly (host, NumPy).

Vectorized equivalent of the reference's two-pass assembly
(src/builder/build_sparse_and_skew_index.cpp:5-488):

  * buckets (one per distinct minimizer, keyed by its MPHF id) are sized by
    DISTINCT minimizer positions (canonical builds can emit 2 super-kmers per
    position, builder/util.hpp:95-107);
  * size == 1          -> SINGLETON codeword  |offset|0|
  * 2 <= size <= 2^l   -> MIDLOAD: positions grouped by size class in
                          mid_load_buckets, codeword |list_id|size-2|01|
  * size > 2^l         -> HEAVYLOAD: positions in heavy_load_buckets, plus a
                          per-size-class kmer-keyed MPHF mapping each member
                          kmer to its bucket position, codeword |begin|pid|11|

Bucket layout order differs from the reference only in the (unobservable)
tie-order of equal-size buckets: we sort by (size, mphf_id) stable.
"""

import numpy as np

from .. import kmer as K
from ..constants import MAX_L, MIN_L, SKEW_LAMBDA_BOOST, LAMBDA
from ..index import Index, SkewPartition, Weights
from ..mphf import MPHF

U64 = np.uint64
U32 = np.uint32


def assemble(parsed, tuples, words64, k, m, seed, canonical, verbose=False,
             on_step=None, avg_partition_size=None, threads=1, lmbda=None):
    """tuples: MinimizerTuples sorted by (minimizer_value, pos_in_seq)."""
    from ..constants import AVG_PARTITION_SIZE
    from ..mphf import PartitionedMPHF

    min_size = 1 << MIN_L
    avg_part = avg_partition_size or AVG_PARTITION_SIZE
    lmb = lmbda if lmbda is not None else LAMBDA

    def step(name):
        if on_step:
            on_step(name)

    # ---- step 4: minimizer MPHF over distinct minimizer values; key sets
    # beyond one partition build the PTHash-style partitioned layout
    # (reference minimizers_control_map.hpp:12-19)
    distinct_vals = np.unique(tuples.minimizer)  # sorted unique
    num_minimizers = len(distinct_vals)
    if num_minimizers > avg_part:
        f = PartitionedMPHF.build_u64(distinct_vals, seed=seed, lmbda=lmb,
                                      avg_partition_size=avg_part,
                                      threads=threads)
    else:
        f = MPHF.build_u64(distinct_vals, seed=seed, lmbda=lmb)
    step("build mphf")

    # ---- step 5+6: re-key tuples by MPHF id and re-sort
    ids_of_distinct = f(distinct_vals).astype(np.int64)
    # tuples.minimizer is sorted; map via searchsorted into distinct_vals
    tid = ids_of_distinct[np.searchsorted(distinct_vals, tuples.minimizer)]
    order = np.lexsort((tuples.pos_in_seq, tid))
    bid = tid[order]  # bucket id per tuple (sorted)
    pos = tuples.pos_in_seq[order].astype(np.int64)
    pik = tuples.pos_in_kmer[order].astype(np.int64)
    cnt = tuples.count[order].astype(np.int64)
    step("hash minimizers")

    # ---- bucket statistics over DISTINCT (bucket, pos) entries
    T = len(bid)
    distinct = np.ones(T, dtype=bool)
    distinct[1:] = (bid[1:] != bid[:-1]) | (pos[1:] != pos[:-1])
    dbid = bid[distinct]
    dpos = pos[distinct]
    sizes = np.bincount(dbid, minlength=num_minimizers)  # distinct positions per bucket
    assert sizes.min() >= 1
    max_bucket_size = int(sizes.max())

    # entry index of each bucket's first distinct entry
    dstarts = np.zeros(num_minimizers, dtype=np.int64)
    np.cumsum(sizes[:-1], out=dstarts[1:])

    codewords = np.zeros(num_minimizers, dtype=U64)

    # ---- singletons
    singleton = sizes == 1
    codewords[singleton] = (dpos[dstarts[singleton]].astype(U64) << U64(1))

    # ---- order big buckets by (size, id)
    big_ids = np.flatnonzero(sizes >= 2)
    big_order = big_ids[np.lexsort((big_ids, sizes[big_ids]))]
    bucket_rank = np.full(num_minimizers, -1, dtype=np.int64)
    bucket_rank[big_order] = np.arange(len(big_order))

    # per-distinct-entry rank of its bucket (entries within a bucket stay in pos order)
    is_big_entry = sizes[dbid] >= 2
    e_ids = np.flatnonzero(is_big_entry)
    e_rank = bucket_rank[dbid[e_ids]]
    e_sorted = e_ids[np.lexsort((e_ids, e_rank))]  # layout order

    big_sizes = sizes[big_order]
    mid_mask_b = big_sizes <= min_size  # over big_order
    heavy_mask_b = ~mid_mask_b
    num_mid = int(mid_mask_b.sum())

    # split laid-out entries: first all mid buckets (smaller sizes sort first)
    n_mid_entries = int(big_sizes[mid_mask_b].sum())
    mid_entries = e_sorted[:n_mid_entries]
    heavy_entries = e_sorted[n_mid_entries:]

    mid_load_buckets = dpos[mid_entries].astype(U64)
    heavy_load_buckets = dpos[heavy_entries].astype(U64)

    # ---- MIDLOAD codewords + begin_buckets_of_size
    begin_buckets_of_size = np.zeros(min_size + 1, dtype=U32)
    max_list_id = 0
    if num_mid:
        mid_ids = big_order[:num_mid]
        msizes = big_sizes[:num_mid]
        # cumulative start of each mid bucket in mid_load_buckets
        mb_start = np.zeros(num_mid, dtype=np.int64)
        np.cumsum(msizes[:-1], out=mb_start[1:])
        # first bucket of each size class
        new_size = np.ones(num_mid, dtype=bool)
        new_size[1:] = msizes[1:] != msizes[:-1]
        class_start = mb_start[new_size]
        class_sizes = msizes[new_size]
        begin_buckets_of_size[class_sizes] = class_start.astype(U32)
        # list_id = index within size class
        class_first_idx = np.flatnonzero(new_size)
        list_id = np.arange(num_mid) - np.repeat(class_first_idx, np.diff(np.concatenate([class_first_idx, [num_mid]])))
        max_list_id = int(list_id.max())
        codewords[mid_ids] = (
            ((list_id.astype(U64) << U64(MIN_L)) | (msizes.astype(U64) - U64(2))) << U64(2)
        ) | U64(1)

    # ---- HEAVYLOAD codewords + skew index
    skew_partitions = []
    num_partitions = 0
    if heavy_mask_b.any():
        heavy_ids = big_order[num_mid:]
        hsizes = big_sizes[num_mid:]
        if max_bucket_size < (1 << MAX_L):
            num_partitions = int(np.ceil(np.log2(max_bucket_size))) - MIN_L
        else:
            num_partitions = MAX_L - MIN_L + 1
        # partition id per heavy bucket: sizes in (2^(MIN_L+p), 2^(MIN_L+p+1)],
        # last partition absorbs everything larger
        pid = np.ceil(np.log2(hsizes)).astype(np.int64) - (MIN_L + 1)
        pid = np.clip(pid, 0, num_partitions - 1)
        hb_start = np.zeros(len(heavy_ids), dtype=np.int64)
        np.cumsum(hsizes[:-1], out=hb_start[1:])
        codewords[heavy_ids] = (
            ((hb_start.astype(U64) << U64(3)) | pid.astype(U64)) << U64(2)
        ) | U64(3)

        # --- gather member kmers of each heavy bucket
        heavy_set = np.zeros(num_minimizers, dtype=bool)
        heavy_set[heavy_ids] = True
        ht = np.flatnonzero(heavy_set[bid])  # tuple indices in heavy buckets
        # pos_in_bucket: rank of the tuple's distinct position within its bucket
        within = np.cumsum(distinct) - 1  # global distinct index per tuple
        pos_in_bucket = within[ht] - dstarts[bid[ht]]
        starts = pos[ht] - pik[ht]
        counts = cnt[ht]
        total = int(counts.sum())
        # expand: kmer offsets start+t for t < count
        base = np.repeat(starts, counts)
        t_in_run = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        koffs = base + t_in_run
        kpib = np.repeat(pos_in_bucket, counts).astype(U32)
        pid_of_bucket = np.zeros(num_minimizers, dtype=np.int64)
        pid_of_bucket[heavy_ids] = pid
        kpid = np.repeat(pid_of_bucket[bid[ht]], counts)
        # global heavy_load_buckets index per kmer (= bucket begin + pos)
        hb_begin_global = np.zeros(num_minimizers, dtype=np.int64)
        hb_begin_global[heavy_ids] = hb_start
        kbeg = np.repeat(hb_begin_global[bid[ht]], counts)

        kmers = K.read_kmers_at(words64, koffs, k)
        if canonical:
            rc = K.revcomp_kmers(kmers, k)
            use_rc = _kmer_less(rc, kmers)
            kmers = np.where(use_rc[:, None], rc, kmers)
        kwords32 = K.kmers_to_u32(kmers, k)

        for p in range(num_partitions):
            sel = kpid == p
            n_p = int(sel.sum())
            if n_p == 0:
                skew_partitions.append(
                    SkewPartition(
                        mphf=MPHF(0, 0, 1, seed, np.zeros(1, dtype=U32), np.zeros(0, dtype=U32)),
                        positions=np.zeros(0, dtype=U32),
                        hindex=np.zeros(0, dtype=U32),
                    )
                )
                continue
            pk = kwords32[sel]
            # PartitionedMPHF for every size class (P=1 when small): uniform
            # partitioned eval on device, and human-scale heavy classes
            # build partition-at-a-time like the reference's PTHash
            fp = PartitionedMPHF.build_words(pk, seed=seed + 1000 + p,
                                             lmbda=lmb + SKEW_LAMBDA_BOOST,
                                             avg_partition_size=avg_part,
                                             threads=threads)
            slots = fp.eval_words(pk)
            positions = np.zeros(n_p, dtype=U32)
            positions[slots] = kpib[sel]
            hindex = np.zeros(n_p, dtype=U32)
            hindex[slots] = (kbeg[sel] + kpib[sel]).astype(U32)
            skew_partitions.append(SkewPartition(mphf=fp, positions=positions,
                                                 hindex=hindex))
    step("build skew index")

    # ---- stats for reference-format space accounting
    total_chars = int(parsed.endpoints[-1])
    nbo = max(1, int(np.ceil(np.log2(max(2, total_chars)))))
    bfl = int(np.ceil(np.log2(max_list_id + 2)))
    nbc = max(nbo + 1, 2 + MIN_L + bfl)

    weights = build_weights(parsed) if parsed.weight_interval_values is not None else None

    from ..compact import CompactVector

    return Index(
        k=k,
        m=m,
        canonical=canonical,
        seed=seed,
        num_kmers=parsed.num_kmers,
        num_strings=len(parsed.endpoints) - 1,
        strings64=words64,
        num_chars=total_chars,
        string_endpoints=parsed.endpoints.astype(U64),
        minimizer_mphf=f,
        # at-rest compact (actual-footprint parity with the reference's
        # compact_vector formats); the engine expands at load
        codewords=CompactVector.from_array(codewords),
        begin_buckets_of_size=begin_buckets_of_size,
        mid_load_buckets=CompactVector.from_array(mid_load_buckets),
        heavy_load_buckets=CompactVector.from_array(heavy_load_buckets),
        skew_partitions=skew_partitions,
        weights=weights,
        stats={
            "num_minimizers": num_minimizers,
            "num_minimizer_positions": int(sizes.sum()),
            "num_super_kmers": T,
            "max_bucket_size": max_bucket_size,
            "num_bits_per_offset": nbo,
            "num_bits_for_control": nbc,
            "num_partitions": num_partitions,
            "bucket_size_histogram": _histogram(sizes, verbose),
        },
    )


def _histogram(sizes, verbose, cap=4096):
    """Bucket-size distribution (reference include/buckets_statistics.hpp:
    62-137): {size: count} up to `cap`, printed cumulatively when verbose."""
    hist = np.bincount(np.minimum(sizes, cap))
    out = {int(s): int(c) for s, c in enumerate(hist) if c}
    if verbose:
        total = int(hist.sum())
        cum = 0
        print("bucket size distribution:")
        for s, c in sorted(out.items()):
            cum += c
            print(f"  num_buckets of size {s}: {c} ({100.0 * cum / total:.3f}% cumulative)")
    return out


def _kmer_less(a, b):
    """Lexicographic < on (N, W) uint64 kmers, word W-1 most significant
    (matches uint_kmer_t::operator<, reference kmer.hpp:36)."""
    less = np.zeros(len(a), dtype=bool)
    decided = np.zeros(len(a), dtype=bool)
    for w in range(a.shape[1] - 1, -1, -1):
        lt = a[:, w] < b[:, w]
        gt = a[:, w] > b[:, w]
        less |= (~decided) & lt
        decided |= lt | gt
    return less


def build_weights(parsed):
    """Freq-sorted distinct-weight dictionary + interval arrays
    (reference include/weights.hpp:33-111)."""
    counts = parsed.weight_counts
    # sort by (freq desc, value asc) — reference weights.hpp:64-67
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    dictionary = np.array([v for v, _ in items], dtype=U64)
    id_of = {v: i for i, (v, _) in enumerate(items)}
    vals = parsed.weight_interval_values
    if len(vals) > 1 and (vals[1:] == vals[:-1]).any():
        raise ValueError("weight intervals are malformed (equal consecutive values)")
    value_ids = np.array([id_of[int(v)] for v in vals], dtype=U32)
    return Weights(
        interval_value_ids=value_ids,
        interval_endpoints=parsed.weight_interval_lengths.astype(U64),
        dictionary=dictionary,
    )
