"""Out-of-core (RAM-bounded) build.

The reference bounds build RAM by spilling sorted tuple runs to tmp files
and k-way merging them (reference: include/builder/util.hpp:157-300,
include/builder/file_merging_iterator.hpp:16-151). Here the same job is
done with a structure that also IS the multi-host shard unit: minimizer
tuples spill to R = 2^r HASH-RANGE files during the streaming scan, and
assembly processes one partitioned-MPHF partition (= R/P consecutive
ranges) at a time — no global sort or merge ever materializes. Because the
global bucket layout orders equal-size buckets by MPHF id (partition-major),
per-partition assembly concatenates into EXACTLY the arrays the in-RAM
build produces (tests/test_external_build.py pins bit-equality).

Mid-load positions accumulate into per-size-class segments (the global
layout groups buckets by size); heavy buckets are rare and stay in RAM.
"""

import os
import shutil
import tempfile

import numpy as np

from .. import hashing as H
from .. import kmer as K
from ..constants import MAX_L, MIN_L, SKEW_LAMBDA_BOOST, LAMBDA
from ..compact import CompactVector
from ..index import Index, SkewPartition
from ..mphf import MPHFBuildError, PartitionedMPHF
from ..pool import ordered_map
from .assemble import _kmer_less, build_weights
from .parse import SequenceReader

U64 = np.uint64
U32 = np.uint32

TUPLE_DT = np.dtype([("mn", "<u8"), ("pos", "<u4"), ("pik", "u1"), ("cnt", "u1")])
R_RANGES = 1024


class _SpillRouter:
    """Route tuple blocks to hash-range spill files, flushing at a RAM cap."""

    def __init__(self, tmpdir, seed, ram_limit_bytes, R=R_RANGES, tag=""):
        self.dir = tmpdir
        self.seed = np.uint64(seed)
        self.R = R
        self.limit = ram_limit_bytes
        self.buf = [[] for _ in range(R)]
        self.buffered = 0
        self.total = 0
        self.flushes = 0  # flushes that wrote tuples
        # multi-host builds tag each worker's spill files so they share one
        # directory without contention (builder/distributed.py)
        self.tag = tag

    def path(self, rid):
        return os.path.join(self.dir, f"range_{rid:05d}{self.tag}.bin")

    def add(self, mn, pos, pik, cnt):
        h = H.hash64_u64(mn, self.seed)
        rid = H.mulhi32((h >> U64(32)).astype(U32), U32(self.R)).astype(np.int64)
        order = np.argsort(rid, kind="stable")
        rec = np.empty(len(mn), dtype=TUPLE_DT)
        rec["mn"] = mn[order]
        rec["pos"] = pos[order].astype(np.uint32)
        rec["pik"] = pik[order]
        rec["cnt"] = cnt[order]
        rs = rid[order]
        ub, starts = np.unique(rs, return_index=True)
        ends = np.concatenate([starts[1:], [len(rs)]])
        for r, s, e in zip(ub, starts, ends):
            self.buf[r].append(rec[s:e])
        self.buffered += rec.nbytes
        self.total += len(rec)
        if self.buffered > self.limit:
            self.flush()

    def flush(self):
        self.flushes += self.buffered > 0
        for r, lst in enumerate(self.buf):
            if lst:
                with open(self.path(r), "ab") as f:
                    np.concatenate(lst).tofile(f)
                self.buf[r] = []
        self.buffered = 0

    def load(self, rid):
        parts = []
        if os.path.exists(self.path(rid)):
            parts.append(np.fromfile(self.path(rid), dtype=TUPLE_DT))
        if self.buf[rid]:
            parts.append(np.concatenate(self.buf[rid]))
        return np.concatenate(parts) if parts else np.zeros(0, dtype=TUPLE_DT)

    def reroute(self, new_seed):
        """Global MPHF re-seed changes the hash ranges: re-route every spill
        file under the new seed (rare: full 64-bit hash collision)."""
        self.flush()
        self._reroute_files([self.path(r) for r in range(self.R)], new_seed)

    def _reroute_files(self, olds, new_seed):
        """Rename `olds` aside, re-add their records under `new_seed`, and
        delete them. File-local record order is preserved, which is all the
        assembly's bit-equality needs (equal-(slot,pos) ties are always
        in-file adjacent; builder/distributed.py docstring)."""
        tmp = [p + ".old" for p in olds if os.path.exists(p)]
        for t in tmp:
            os.rename(t[: -len(".old")], t)
        self.seed = np.uint64(new_seed)
        for t in tmp:
            rec = np.fromfile(t, dtype=TUPLE_DT)
            self.add(rec["mn"].astype(U64), rec["pos"].astype(np.int64),
                     rec["pik"], rec["cnt"])
            os.remove(t)
        self.flush()


def build_external(input_path, config, stats, timed):
    """RAM-bounded counterpart of builder.build. Returns an Index whose
    arrays are bit-identical to the in-RAM path's (same avg_partition_size)."""
    from .. import native
    from ..hashing import mixer_magic

    if not native.available():
        raise RuntimeError("external build requires the native scanner")
    k, m = config.k, config.m
    magic = mixer_magic(config.seed)
    ram_bytes = (config.ram_limit_mb or 1024) * (1 << 20)
    tmpdir = tempfile.mkdtemp(prefix="sshash_build_", dir=config.tmp_dir)
    try:
        return _build_external(input_path, config, stats, timed, k, m, magic,
                               ram_bytes, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _build_external(input_path, config, stats, timed, k, m, magic, ram_bytes,
                    tmpdir):
    from .. import native

    seed0 = config.seed
    seed = int(H.splitmix64(U64(seed0)))  # attempt 0 of build_from_hashes
    router = _SpillRouter(tmpdir, seed, ram_bytes // 2)

    # ---- phase A: streaming scan -> packed strings + routed tuple spills
    # the scan buffer follows the RAM budget as the scan workers' does
    # (builder/distributed.py), so the router flushes during the scan
    flush_chars = min(1 << 26, max(ram_bytes // 8, 1 << 20))

    def scan():
        reader = SequenceReader(input_path, k, config.weighted)
        words_parts = []
        carry = np.zeros(0, dtype=np.uint8)
        buf, buf_lens, buf_chars, base = [], [], 0, 0

        def flush():
            nonlocal carry, base, buf, buf_lens, buf_chars
            if not buf:
                return
            codes = np.concatenate(buf)
            ep = np.zeros(len(buf_lens) + 1, dtype=np.int64)
            np.cumsum(buf_lens, out=ep[1:])
            mn, ps, pik, cnt = native.tuple_scan(codes, ep, k, m, magic,
                                                 config.canonical)
            router.add(mn, ps.astype(np.int64) + base, pik, cnt)
            allc = np.concatenate([carry, codes]) if len(carry) else codes
            n32 = (len(allc) // 32) * 32
            if n32:
                words_parts.append(K.pack_codes(allc[:n32]))
            carry = allc[n32:]
            base += len(codes)
            buf, buf_lens, buf_chars = [], [], 0

        for codes in reader:
            buf.append(codes)
            buf_lens.append(len(codes))
            buf_chars += len(codes)
            if buf_chars >= flush_chars:
                flush()
        flush()
        words_parts.append(K.pack_codes(carry, pad_words=K.num_words64(k) + 1))
        router.flush()
        return reader.finish(codes=None), np.concatenate(words_parts)

    parsed, words64 = timed("steps 1-3 (stream parse + pack + scan + spill)", scan)
    # at most one of these is the scan's end: two or more mean the budget
    # made the router spill while the scan ran
    stats["spill_flushes"] = router.flushes

    # ---- phases B-D with global re-seed retry (full hash collisions)
    for attempt in range(16):
        try:
            return timed("steps 4-7 (ranged mphf + assembly)",
                         lambda: _assemble_ranged(parsed, router, words64, k, m,
                                                  seed0, router.seed, config, stats))
        except MPHFBuildError:
            seed = int(H.splitmix64(U64(seed0) + U64((attempt + 1) * 0x9E3779B9)))
            router.reroute(seed)
    raise MPHFBuildError("external build failed after 16 global seeds")


def _partition(p, router, c, pb, seed, base, codewords, min_size):
    """Phase C for MPHF partition p (hash ranges [p*c, (p+1)*c)): its MPHF
    solution, its singleton codewords (written into codewords[base:], the
    partition's own slice), and what the caller places in partition order:
    its mid buckets (ids, sizes, rank within their size, position
    segments), heavy buckets and counts. None for an empty partition."""
    rec = np.concatenate([router.load(r) for r in range(p * c, (p + 1) * c)])
    if not len(rec):
        return None
    mn = rec["mn"].astype(U64)
    distinct_vals = np.unique(mn)
    sol = pb.solve_partition(p, H.hash64_u64(distinct_vals, U64(seed)))
    local = sol[4]
    tid = local[np.searchsorted(distinct_vals, mn)]
    pos_all = rec["pos"].astype(np.int64)
    order = np.lexsort((pos_all, tid))
    bid = tid[order]
    pos = pos_all[order]
    pik = rec["pik"][order].astype(np.int64)
    cnt = rec["cnt"][order].astype(np.int64)
    del rec, mn, tid, pos_all, order
    n_p = len(distinct_vals)

    distinct = np.ones(len(bid), dtype=bool)
    distinct[1:] = (bid[1:] != bid[:-1]) | (pos[1:] != pos[:-1])
    dbid = bid[distinct]
    dpos = pos[distinct]
    sizes = np.bincount(dbid, minlength=n_p)
    out = {"sol": sol, "tuples": len(bid), "max_size": int(sizes.max()),
           "positions": int(sizes.sum()),
           "hist": np.bincount(np.minimum(sizes, 4096), minlength=4097),
           "mid_ids": None, "heavy": {}}
    dstarts = np.zeros(n_p, dtype=np.int64)
    np.cumsum(sizes[:-1], out=dstarts[1:])

    singleton = sizes == 1
    codewords[base + np.flatnonzero(singleton)] = (
        dpos[dstarts[singleton]].astype(U64) << U64(1))

    big_ids = np.flatnonzero(sizes >= 2)
    big_order = big_ids[np.lexsort((big_ids, sizes[big_ids]))]
    bucket_rank = np.full(n_p, -1, dtype=np.int64)
    bucket_rank[big_order] = np.arange(len(big_order))
    is_big_entry = sizes[dbid] >= 2
    e_ids = np.flatnonzero(is_big_entry)
    e_rank = bucket_rank[dbid[e_ids]]
    e_sorted = e_ids[np.lexsort((e_ids, e_rank))]
    big_sizes = sizes[big_order]
    mid_mask_b = big_sizes <= min_size
    num_mid = int(mid_mask_b.sum())
    n_mid_entries = int(big_sizes[mid_mask_b].sum())
    mid_entries = e_sorted[:n_mid_entries]
    heavy_entries = e_sorted[n_mid_entries:]

    if num_mid:
        msizes = big_sizes[:num_mid]
        mb_start = np.zeros(num_mid, dtype=np.int64)
        np.cumsum(msizes[:-1], out=mb_start[1:])
        new_size = np.ones(num_mid, dtype=bool)
        new_size[1:] = msizes[1:] != msizes[:-1]
        class_first_idx = np.flatnonzero(new_size)
        out["mid_ids"] = base + big_order[:num_mid]
        out["msizes"] = msizes
        out["local_rank"] = np.arange(num_mid) - np.repeat(
            class_first_idx, np.diff(np.concatenate([class_first_idx, [num_mid]])))
        mpos = dpos[mid_entries].astype(U64)
        segs = []
        for i in class_first_idx:
            s = int(msizes[i])
            cnt_s = int((msizes == s).sum())
            segs.append((s, cnt_s, mpos[mb_start[i]: mb_start[i] + cnt_s * s]))
        out["mid_segs"] = segs

    if len(heavy_entries):
        heavy = out["heavy"] = {"gid": [], "size": [], "dpos": [], "koffs": [], "kpib": []}
        heavy_ids = big_order[num_mid:]
        hsizes = big_sizes[num_mid:]
        hb_start = np.zeros(len(heavy_ids), dtype=np.int64)
        np.cumsum(hsizes[:-1], out=hb_start[1:])
        hpos = dpos[heavy_entries]
        heavy_set = np.zeros(n_p, dtype=bool)
        heavy_set[heavy_ids] = True
        ht = np.flatnonzero(heavy_set[bid])
        within = np.cumsum(distinct) - 1
        pos_in_bucket = within[ht] - dstarts[bid[ht]]
        starts_h = pos[ht] - pik[ht]
        counts_h = cnt[ht]
        total_h = int(counts_h.sum())
        kbase = np.repeat(starts_h, counts_h)
        t_in_run = np.arange(total_h) - np.repeat(
            np.concatenate([[0], np.cumsum(counts_h)[:-1]]), counts_h)
        koffs_all = kbase + t_in_run
        kpib_all = np.repeat(pos_in_bucket, counts_h)
        kbid_all = np.repeat(bid[ht], counts_h)
        # split per heavy bucket: kbid_all is non-decreasing, so each
        # bucket's member kmers are one contiguous segment
        lo_h = np.searchsorted(kbid_all, heavy_ids, side="left")
        hi_h = np.searchsorted(kbid_all, heavy_ids, side="right")
        for j, hid in enumerate(heavy_ids):
            heavy["gid"].append(base + int(hid))
            heavy["size"].append(int(hsizes[j]))
            heavy["dpos"].append(hpos[hb_start[j]: hb_start[j] + hsizes[j]].astype(U64))
            heavy["koffs"].append(koffs_all[lo_h[j]: hi_h[j]])
            heavy["kpib"].append(kpib_all[lo_h[j]: hi_h[j]].astype(U32))
    return out


def _assemble_ranged(parsed, router, words64, k, m, seed0, seed, config, stats):
    from ..constants import AVG_PARTITION_SIZE

    seed = int(seed)
    min_size = 1 << MIN_L
    R = router.R
    avg = config.avg_partition_size or AVG_PARTITION_SIZE
    threads = max(1, int(config.threads or 1))

    # ---- phase B: distinct minimizers per range
    def range_counts(r):
        rec = router.load(r)
        return len(np.unique(rec["mn"])) if len(rec) else 0

    range_n = np.fromiter(ordered_map(range_counts, range(R), threads), dtype=np.int64,
                          count=R)
    n = int(range_n.sum())
    if n == 0:
        raise ValueError("empty input (no minimizers)")

    P = min(PartitionedMPHF.num_partitions_for(n, avg), R)
    c = R // P
    part_n = range_n.reshape(P, c).sum(axis=1)
    bases = np.concatenate([[0], np.cumsum(part_n)])
    nmax = int(part_n.max())
    lmb = config.lmbda if getattr(config, "lmbda", None) is not None else LAMBDA
    pb = PartitionedMPHF.incremental(n, seed, P, nmax, lmbda=lmb)

    # ---- phase C: per-partition sort + MPHF + bucket layout. Partitions
    # run concurrently (_partition); what depends on the partitions before
    # (MPHF commits, mid list ids, heavy order) is done here in order.
    codewords = np.zeros(n, dtype=U64)
    mid_chunks = {}          # size -> [position arrays], in partition order
    mid_counts = np.zeros(min_size + 1, dtype=np.int64)
    heavy = {"gid": [], "size": [], "dpos": [], "koffs": [], "kpib": []}
    max_bucket_size = 0
    total_positions = 0
    total_tuples = 0
    hist = np.zeros(4097, dtype=np.int64)

    def partition(p):
        return _partition(p, router, c, pb, seed, int(bases[p]), codewords, min_size)

    for p, part in enumerate(ordered_map(partition, range(P), threads)):
        if part is None:
            pb.add_partition(p, np.zeros(0, dtype=U64))
            continue
        pb.commit_partition(p, part["sol"])
        total_tuples += part["tuples"]
        max_bucket_size = max(max_bucket_size, part["max_size"])
        total_positions += part["positions"]
        hist += part["hist"]
        if part["mid_ids"] is not None:
            msizes = part["msizes"]
            list_id = mid_counts[msizes] + part["local_rank"]
            codewords[part["mid_ids"]] = (
                ((list_id.astype(U64) << U64(MIN_L)) | (msizes.astype(U64) - U64(2)))
                << U64(2)) | U64(1)
            for s, cnt_s, seg in part["mid_segs"]:
                mid_chunks.setdefault(s, []).append(seg)
                mid_counts[s] += cnt_s
        for key, vals in part["heavy"].items():
            heavy[key].extend(vals)

    f = pb.finish()

    # ---- phase D: stitch global layouts
    begin_buckets_of_size = np.zeros(min_size + 1, dtype=U32)
    mid_parts = []
    off = 0
    max_list_id = 0
    for s in range(2, min_size + 1):
        if mid_counts[s]:
            begin_buckets_of_size[s] = off
            seg = np.concatenate(mid_chunks[s])
            mid_parts.append(seg)
            off += len(seg)
            max_list_id = max(max_list_id, int(mid_counts[s]) - 1)
    mid_load_buckets = (np.concatenate(mid_parts) if mid_parts
                        else np.zeros(0, dtype=U64))

    skew_partitions = []
    num_partitions = 0
    heavy_load_buckets = np.zeros(0, dtype=U64)
    if heavy["gid"]:
        hg = np.array(heavy["gid"], dtype=np.int64)
        hs = np.array(heavy["size"], dtype=np.int64)
        horder = np.lexsort((hg, hs))  # global (size, mphf_id) layout
        if max_bucket_size < (1 << MAX_L):
            num_partitions = int(np.ceil(np.log2(max_bucket_size))) - MIN_L
        else:
            num_partitions = MAX_L - MIN_L + 1
        pid = np.clip(np.ceil(np.log2(hs[horder])).astype(np.int64) - (MIN_L + 1),
                      0, num_partitions - 1)
        hb_start = np.zeros(len(horder), dtype=np.int64)
        np.cumsum(hs[horder][:-1], out=hb_start[1:])
        codewords[hg[horder]] = (
            ((hb_start.astype(U64) << U64(3)) | pid.astype(U64)) << U64(2)) | U64(3)
        heavy_load_buckets = np.concatenate([heavy["dpos"][i] for i in horder])

        koffs = np.concatenate([heavy["koffs"][i] for i in horder])
        kpib = np.concatenate([heavy["kpib"][i] for i in horder])
        kcounts = [len(heavy["koffs"][i]) for i in horder]
        kpid = np.repeat(pid, kcounts)
        kbeg = np.repeat(hb_start, kcounts)  # global bucket begin per kmer
        kmers = K.read_kmers_at(words64, koffs, k)
        if config.canonical:
            rc = K.revcomp_kmers(kmers, k)
            use_rc = _kmer_less(rc, kmers)
            kmers = np.where(use_rc[:, None], rc, kmers)
        kwords32 = K.kmers_to_u32(kmers, k)
        from ..mphf import MPHF

        for sp in range(num_partitions):
            sel = kpid == sp
            n_sp = int(sel.sum())
            if n_sp == 0:
                skew_partitions.append(SkewPartition(
                    mphf=MPHF(0, 0, 1, seed0, np.zeros(1, dtype=U32),
                              np.zeros(0, dtype=U32)),
                    positions=np.zeros(0, dtype=U32),
                    hindex=np.zeros(0, dtype=U32)))
                continue
            pk = kwords32[sel]
            fp = PartitionedMPHF.build_words(pk, seed=seed0 + 1000 + sp,
                                             lmbda=lmb + SKEW_LAMBDA_BOOST,
                                             avg_partition_size=avg)
            slots = fp.eval_words(pk)
            positions = np.zeros(n_sp, dtype=U32)
            positions[slots] = kpib[sel]
            hindex = np.zeros(n_sp, dtype=U32)
            hindex[slots] = (kbeg[sel] + kpib[sel]).astype(U32)
            skew_partitions.append(SkewPartition(mphf=fp, positions=positions,
                                                 hindex=hindex))

    total_chars = int(parsed.endpoints[-1])
    nbo = max(1, int(np.ceil(np.log2(max(2, total_chars)))))
    bfl = int(np.ceil(np.log2(max_list_id + 2)))
    nbc = max(nbo + 1, 2 + MIN_L + bfl)
    weights = build_weights(parsed) if parsed.weight_interval_values is not None else None
    hist_dict = {int(s): int(cc) for s, cc in enumerate(hist) if cc}

    return Index(
        k=k, m=m, canonical=config.canonical, seed=seed0,
        num_kmers=parsed.num_kmers,
        num_strings=len(parsed.endpoints) - 1,
        strings64=words64,
        num_chars=total_chars,
        string_endpoints=parsed.endpoints.astype(U64),
        minimizer_mphf=f,
        codewords=CompactVector.from_array(codewords),
        begin_buckets_of_size=begin_buckets_of_size,
        mid_load_buckets=CompactVector.from_array(mid_load_buckets),
        heavy_load_buckets=CompactVector.from_array(heavy_load_buckets),
        skew_partitions=skew_partitions,
        weights=weights,
        stats={
            "num_minimizers": n,
            "num_minimizer_positions": total_positions,
            "num_super_kmers": total_tuples,
            "max_bucket_size": max_bucket_size,
            "num_bits_per_offset": nbo,
            "num_bits_for_control": nbc,
            "num_partitions": num_partitions,
            "bucket_size_histogram": hist_dict,
        },
    )
