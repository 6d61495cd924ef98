"""Minimal perfect hash function, TPU-evaluable.

Functional equivalent of the reference's PTHash layer (reference:
include/hash_util.hpp:39-45, external/pthash) but designed for branch-free
batched evaluation on TPU with 32-bit integer ops only:

    h          = splitmix64(key ^ splitmix64(seed))            (64-bit)
    bucket     = mulhi32(hi32(h), num_buckets)                 (fair map, no mod)
    pilot      = pilots[bucket]                                (1 gather)
    slot       = mulhi32(fmix32(lo32(h) ^ fmix32(pilot)), table_size)
    position   = slot if slot < n else remap[slot - n]         (<=1 gather)

Construction is the classic pilot search (sort buckets by size descending,
find the smallest pilot mapping every key of the bucket to distinct free
slots). Evaluation cost: ~2 gathers + a handful of VPU integer ops, fully
vectorizable. `remap` is stored dense (one uint32 per slot in [n, table_size))
— ~2 bits/key at alpha=0.94; the compact on-disk form can narrow this later.

Multi-word keys (kmers) hash through hashing.hash64_words.
"""

import numpy as np

from . import hashing as H
from .compact import CompactVector
from .constants import ALPHA, LAMBDA
from .pool import ordered_map

U64 = np.uint64
U32 = np.uint32


def _get(vec, idx):
    """Vectorized access on a CompactVector or a plain uint32 array."""
    if isinstance(vec, CompactVector):
        return vec.get(idx)
    return np.take(vec, idx).astype(np.int64)


def _vec_bits(vec):
    return vec.num_bits() if isinstance(vec, CompactVector) else 8 * vec.nbytes

_MAX_PILOT = 1 << 22
_PILOT_BATCH = 64


class MPHFBuildError(RuntimeError):
    pass


class MPHF:
    """num_keys == 0 is allowed (empty function)."""

    __slots__ = ("n", "table_size", "num_buckets", "seed", "pilots", "remap")

    def __init__(self, n, table_size, num_buckets, seed, pilots, remap):
        self.n = int(n)
        self.table_size = int(table_size)
        self.num_buckets = int(num_buckets)
        self.seed = int(seed)
        self.pilots = pilots
        self.remap = remap

    # ---------------------------------------------------------- evaluation

    def _hash(self, keys):
        return H.hash64_u64(keys, U64(self.seed))

    def eval_hashes(self, h):
        hi = (h >> U64(32)).astype(U32)
        lo = (h & U64(0xFFFFFFFF)).astype(U32)
        bucket = H.mulhi32(hi, U32(self.num_buckets))
        pilot = _get(self.pilots, bucket).astype(U32)
        slot = H.mulhi32(H.fmix32(lo ^ H.fmix32(pilot)), U32(self.table_size)).astype(np.int64)
        if self.table_size > self.n:
            over = slot >= self.n
            slot = np.where(over, _get(self.remap, np.where(over, slot - self.n, 0)), slot)
        return slot

    def __call__(self, keys):
        """uint64 scalar keys -> positions in [0, n)."""
        return self.eval_hashes(self._hash(np.asarray(keys, dtype=U64)))

    def eval_words(self, words):
        """(N, W) uint32 multi-word keys -> positions in [0, n)."""
        return self.eval_hashes(H.hash64_words(words, U64(self.seed)))

    # ---------------------------------------------------------- num_bits (space accounting)

    def num_bits(self):
        return _vec_bits(self.pilots) + _vec_bits(self.remap) + 5 * 64

    # ---------------------------------------------------------- construction

    @classmethod
    def build_from_hashes(cls, make_hashes, n, seed0, lmbda=LAMBDA, alpha=ALPHA):
        """make_hashes(seed) -> uint64[n] of key hashes under that seed."""
        if n == 0:
            return cls(0, 0, 1, seed0, np.zeros(1, dtype=U32), np.zeros(0, dtype=U32))
        for attempt in range(64):
            seed = int(H.splitmix64(U64(seed0) + U64(attempt * 0x9E3779B9)))
            h = make_hashes(U64(seed))
            try:
                return cls._search(h, n, seed, lmbda, alpha)
            except MPHFBuildError:
                continue
        raise MPHFBuildError(f"MPHF build failed after 64 seeds for n={n}")

    @classmethod
    def build_u64(cls, keys, seed, lmbda=LAMBDA, alpha=ALPHA):
        keys = np.asarray(keys, dtype=U64)
        return cls.build_from_hashes(lambda s: H.hash64_u64(keys, s), len(keys), seed, lmbda, alpha)

    @classmethod
    def build_words(cls, words, seed, lmbda=LAMBDA, alpha=ALPHA):
        words = np.asarray(words, dtype=U32)
        return cls.build_from_hashes(
            lambda s: H.hash64_words(words, s), len(words), seed, lmbda, alpha
        )

    @classmethod
    def _search(cls, h, n, seed, lmbda, alpha):
        table_size = max(n, int(np.ceil(n / alpha)))
        if table_size % 2 == 0:
            table_size += 1
        num_buckets = max(1, int(np.ceil(n / lmbda)))
        pilots, taken = _pilot_table(h, table_size, num_buckets)
        return cls._finish(n, table_size, num_buckets, seed, pilots, taken)

    @classmethod
    def _finish(cls, n, table_size, num_buckets, seed, pilots, taken):
        return cls(n, table_size, num_buckets, seed,
                   CompactVector.from_array(pilots),
                   CompactVector.from_array(_minimal_remap(n, table_size, taken)))


def _minimal_remap(n, table_size, taken):
    """Taken slots >= n -> free slots < n (minimal-ization)."""
    if table_size <= n:
        return np.zeros(0, dtype=U32)
    free_lt = np.flatnonzero(~taken[:n])
    taken_ge = np.flatnonzero(taken[n:])
    assert len(free_lt) == len(taken_ge)
    remap = np.zeros(table_size - n, dtype=U32)
    remap[taken_ge] = free_lt.astype(U32)
    return remap


class PartitionedMPHF:
    """Hash-range-partitioned MPHF (the PTHash partitioned layout,
    reference: include/minimizers_control_map.hpp:12-19, avg partition 3M).

    Keys are split by the top hash bits into P partitions of UNIFORM
    geometry (T slots, NB pilot buckets each) so the device eval needs no
    per-partition offset tables — global raw slot = pid*T + local, pilot
    index = pid*NB + local_bucket. Each partition builds independently with
    its own sub-seed (a failed partition re-seeds locally: no whole-table
    re-seed storms, and partitions are the natural multi-host shard unit).

        h    = splitmix64(key ^ splitmix64(seed))        (global, 64-bit)
        pid  = mulhi32(hi32(h), P)                       (hash-range partition)
        h2   = splitmix64(h ^ seedmix[pid])              (1 tiny gather)
        b    = pid*NB + mulhi32(hi32(h2), NB)
        slot = pid*T  + mulhi32(fmix32(lo32(h2) ^ fmix32(pilots[b])), T)

    Minimal position = cum_n[pid] + local minimal position. In-bucket
    placement still uses 32 bits, but per PARTITION (<= a few M keys) the
    collision odds are ~1e-3 and a collision re-seeds only that partition.
    """

    __slots__ = ("n", "seed", "num_partitions", "part_table", "part_buckets",
                 "seeds", "pilots", "part_n", "cum_n", "remap", "remap_off")

    def __init__(self, n, seed, num_partitions, part_table, part_buckets,
                 seeds, pilots, part_n, cum_n, remap, remap_off):
        self.n = int(n)
        self.seed = int(seed)
        self.num_partitions = int(num_partitions)
        self.part_table = int(part_table)
        self.part_buckets = int(part_buckets)
        self.seeds = seeds          # uint64[P] raw per-partition seeds
        self.pilots = pilots        # uint32[P*NB]
        self.part_n = part_n        # uint32[P]
        self.cum_n = cum_n          # uint64[P+1] prefix sums of part_n
        self.remap = remap          # uint32[sum(T - n_p)] concat minimal remaps
        self.remap_off = remap_off  # uint64[P+1]

    # engine-facing geometry (raw slot space covers all partitions)
    @property
    def table_size(self):
        return self.num_partitions * self.part_table

    @property
    def num_buckets(self):
        return self.num_partitions * self.part_buckets

    # ---------------------------------------------------------- evaluation

    def seedmixes(self):
        """splitmix64(seed_p) per partition (what the device eval gathers)."""
        return H.splitmix64(self.seeds)

    def eval_hashes(self, h):
        P, T, NB = self.num_partitions, self.part_table, self.part_buckets
        hi = (h >> U64(32)).astype(U32)
        pid = H.mulhi32(hi, U32(P)).astype(np.int64)
        h2 = H.splitmix64(h ^ self.seedmixes()[pid])
        hi2 = (h2 >> U64(32)).astype(U32)
        lo2 = (h2 & U64(0xFFFFFFFF)).astype(U32)
        b = pid * NB + H.mulhi32(hi2, U32(NB)).astype(np.int64)
        pilot = _get(self.pilots, b).astype(U32)
        local = H.mulhi32(H.fmix32(lo2 ^ H.fmix32(pilot)), U32(T)).astype(np.int64)
        npid = self.part_n[pid].astype(np.int64)
        over = local >= npid
        ridx = self.remap_off[pid].astype(np.int64) + np.where(over, local - npid, 0)
        local = np.where(over, _get(self.remap, ridx), local)
        return self.cum_n[pid].astype(np.int64) + local

    def raw_slots(self, h):
        """Raw (non-minimal) global slots in [0, P*T) — for slot-expanded
        device tables (no remap gather at eval)."""
        P, T, NB = self.num_partitions, self.part_table, self.part_buckets
        hi = (h >> U64(32)).astype(U32)
        pid = H.mulhi32(hi, U32(P)).astype(np.int64)
        h2 = H.splitmix64(h ^ self.seedmixes()[pid])
        hi2 = (h2 >> U64(32)).astype(U32)
        lo2 = (h2 & U64(0xFFFFFFFF)).astype(U32)
        b = pid * NB + H.mulhi32(hi2, U32(NB)).astype(np.int64)
        pilot = _get(self.pilots, b).astype(U32)
        local = H.mulhi32(H.fmix32(lo2 ^ H.fmix32(pilot)), U32(T)).astype(np.int64)
        return pid * T + local

    def expand_to_slots(self, arr):
        """Re-index an array keyed by minimal position into raw-slot keying
        (device layout; see engine._expand_to_slots for the single-table
        version). Untaken slots alias entry 0's value via remap=0."""
        P, T = self.num_partitions, self.part_table
        out = np.zeros(P * T, dtype=arr.dtype)
        for p in range(P):
            npid = int(self.part_n[p])
            base = int(self.cum_n[p])
            sl = out[p * T : (p + 1) * T]
            sl[:npid] = arr[base : base + npid]
            ro = int(self.remap_off[p])
            rmp = _get(self.remap, np.arange(ro, ro + (T - npid)))
            sl[npid:] = arr[np.clip(base + rmp, 0, max(0, len(arr) - 1))]
        return out

    def __call__(self, keys):
        return self.eval_hashes(H.hash64_u64(np.asarray(keys, dtype=U64), U64(self.seed)))

    def eval_words(self, words):
        return self.eval_hashes(H.hash64_words(np.asarray(words, dtype=U32), U64(self.seed)))

    def num_bits(self):
        return (_vec_bits(self.pilots) + _vec_bits(self.remap)
                + 8 * (self.seeds.nbytes + self.part_n.nbytes) + 8 * 64)

    # ---------------------------------------------------------- construction

    @staticmethod
    def num_partitions_for(n, avg_partition_size=None):
        """Power-of-two partition count (so out-of-core spill ranges, a
        finer power-of-two hash split, nest exactly: pid = rid // c)."""
        from .constants import AVG_PARTITION_SIZE

        avg = avg_partition_size or AVG_PARTITION_SIZE
        need = max(1, -(-n // avg))
        return 1 << (need - 1).bit_length()

    @classmethod
    def build_from_hashes(cls, make_hashes, n, seed0, lmbda=LAMBDA, alpha=ALPHA,
                          avg_partition_size=None, threads=1):
        P = cls.num_partitions_for(n, avg_partition_size)
        for attempt in range(16):
            seed = int(H.splitmix64(U64(seed0) + U64(attempt * 0x9E3779B9)))
            h = make_hashes(U64(seed))
            try:
                return cls._build(h, n, seed, P, lmbda, alpha, threads)
            except MPHFBuildError:
                continue
        raise MPHFBuildError(f"partitioned MPHF build failed for n={n}")

    @classmethod
    def build_u64(cls, keys, seed, lmbda=LAMBDA, alpha=ALPHA,
                  avg_partition_size=None, threads=1):
        keys = np.asarray(keys, dtype=U64)
        return cls.build_from_hashes(lambda s: H.hash64_u64(keys, s), len(keys),
                                     seed, lmbda, alpha, avg_partition_size,
                                     threads)

    @classmethod
    def build_words(cls, words, seed, lmbda=LAMBDA, alpha=ALPHA,
                    avg_partition_size=None, threads=1):
        """Multi-word (kmer) keys — used by the skew index so human-scale
        heavy size classes partition like the reference's per-partition
        PTHash builds (build_sparse_and_skew_index.cpp:312-478). Small key
        sets get P=1 (same partitioned eval shape, trivially)."""
        words = np.asarray(words, dtype=U32)
        return cls.build_from_hashes(
            lambda s: H.hash64_words(words, s), len(words), seed, lmbda,
            alpha, avg_partition_size, threads)

    @classmethod
    def incremental(cls, n, seed, P, nmax, lmbda=LAMBDA, alpha=ALPHA):
        """Builder for partition-at-a-time construction (the out-of-core
        build feeds partitions from spilled hash ranges). n = total keys,
        nmax = largest partition's key count (known from range counts)."""
        return _PartitionedBuilder(cls, n, seed, P, nmax, lmbda, alpha)

    @classmethod
    def _build(cls, h, n, seed, P, lmbda, alpha, threads=1):
        hi = (h >> U64(32)).astype(U32)
        pid = H.mulhi32(hi, U32(P)).astype(np.int64)
        order = np.argsort(pid, kind="stable")
        h_sorted = h[order]
        part_n = np.bincount(pid, minlength=P).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(part_n)])
        nmax = int(part_n.max()) if P else 0
        b = cls.incremental(n, seed, P, nmax, lmbda, alpha)
        parts = [h_sorted[starts[p] : starts[p + 1]] for p in range(P)]
        # partitions solve independently (reference builds PTHash partitions
        # multi-threaded); commits stay ordered, and the results are
        # bit-identical to the serial build: per-partition sub-seeds don't
        # depend on execution order. The pool's bounded window commits (and
        # frees) solutions as they complete: peak memory stays ~serial
        # + window
        sols = ordered_map(lambda p: b.solve_partition(p, parts[p]), range(P), threads)
        for p, sol in enumerate(sols):
            b.commit_partition(p, sol)
        return b.finish()


class _PartitionedBuilder:
    def __init__(self, cls, n, seed, P, nmax, lmbda, alpha):
        self.cls = cls
        self.n, self.seed, self.P = int(n), int(seed), int(P)
        T = max(nmax, int(np.ceil(nmax / alpha)))
        if T % 2 == 0:
            T += 1
        self.T = T
        self.NB = max(1, int(np.ceil(nmax / lmbda)))
        self.seeds = np.zeros(P, dtype=U64)
        self.pilots = np.zeros(P * self.NB, dtype=U32)
        self.remap = np.zeros(P * T - n, dtype=U32)
        self.remap_off = np.zeros(P + 1, dtype=U64)
        self.part_n = np.zeros(P, dtype=np.int64)

    def add_partition(self, p, hp):
        """hp: uint64 key hashes of partition p (must be called for
        p = 0..P-1 in order). Returns each key's minimal LOCAL position."""
        return self.commit_partition(p, self.solve_partition(p, hp))

    def solve_partition(self, p, hp):
        """Pure pilot search for partition p — no shared-state writes, so
        partitions solve CONCURRENTLY on a thread pool (the native pilot
        search releases the GIL; reference builds partitions multi-threaded,
        minimizers_control_map.hpp:16). Returns a solution for
        commit_partition."""
        T, NB = self.T, self.NB
        np_p = len(hp)
        if np_p > 1 and len(np.unique(hp)) != np_p:
            raise MPHFBuildError("full 64-bit hash collision (global re-seed)")
        if np_p > T:
            raise MPHFBuildError(f"partition {p} larger than table ({np_p} > {T})")
        for sub in range(16):
            sp = H.splitmix64(U64(
                self.seed ^ ((p * 0x9E3779B97F4A7C15 + sub) & 0xFFFFFFFFFFFFFFFF)))
            h2 = H.splitmix64(hp ^ H.splitmix64(sp))
            try:
                pl, taken = _pilot_table(h2, T, NB)
            except MPHFBuildError:
                continue
            rseg = _minimal_remap(np_p, T, taken)
            hi2 = (h2 >> U64(32)).astype(U32)
            lo2 = (h2 & U64(0xFFFFFFFF)).astype(U32)
            bucket = H.mulhi32(hi2, U32(NB)).astype(np.int64)
            local = H.mulhi32(H.fmix32(lo2 ^ H.fmix32(pl[bucket])),
                              U32(T)).astype(np.int64)
            over = local >= np_p
            if over.any():
                local = np.where(over, rseg[np.where(over, local - np_p, 0)].astype(np.int64),
                                 local)
            return (sp, pl, rseg, np_p, local)
        raise MPHFBuildError(f"partition {p} exhausted sub-seeds")

    def commit_partition(self, p, sol):
        """Ordered bookkeeping (remap offsets are cumulative): call for
        p = 0..P-1 in order. Returns each key's minimal LOCAL position."""
        sp, pl, rseg, np_p, local = sol
        T, NB = self.T, self.NB
        self.seeds[p] = sp
        self.pilots[p * NB : (p + 1) * NB] = pl
        ro = int(self.remap_off[p])
        self.remap[ro : ro + (T - np_p)] = rseg
        self.remap_off[p + 1] = ro + (T - np_p)
        self.part_n[p] = np_p
        return local

    def finish(self):
        cum_n = np.concatenate([[0], np.cumsum(self.part_n)]).astype(U64)
        return self.cls(self.n, self.seed, self.P, self.T, self.NB, self.seeds,
                        CompactVector.from_array(self.pilots),
                        self.part_n.astype(U32), cum_n,
                        CompactVector.from_array(self.remap), self.remap_off)


def _pilot_table(h, table_size, num_buckets):
    """Core pilot search over 64-bit key hashes: bucket by hi32, place by
    lo32. Returns (pilots uint32[num_buckets], taken bool[table_size]);
    raises MPHFBuildError on unresolvable collisions (caller re-seeds)."""
    hi = (h >> U64(32)).astype(U32)
    lo = (h & U64(0xFFFFFFFF)).astype(U32)
    bucket = H.mulhi32(hi, U32(num_buckets)).astype(np.int64)

    # group keys by bucket, order buckets by size descending
    order = np.argsort(bucket, kind="stable")
    bsorted = bucket[order]
    lo_sorted = lo[order]
    ub, starts, counts = np.unique(bsorted, return_index=True, return_counts=True)
    bucket_order = np.argsort(-counts, kind="stable")

    from . import native

    if native.available():
        out = native.pilot_search(lo_sorted, starts, counts, bucket_order,
                                  ub, table_size, _MAX_PILOT, num_buckets)
        if out is None:
            raise MPHFBuildError("native pilot search failed (re-seed)")
        return out

    taken = np.zeros(table_size, dtype=bool)
    pilots = np.zeros(num_buckets, dtype=U32)
    ts32 = U32(table_size)

    pilot_batch = H.fmix32(np.arange(_PILOT_BATCH, dtype=U32))

    for bi in bucket_order:
        s, c = starts[bi], counts[bi]
        blo = lo_sorted[s : s + c]
        if c > 1 and len(np.unique(blo)) != c:
            raise MPHFBuildError("in-bucket hash collision")
        placed = False
        for p0 in range(0, _MAX_PILOT, _PILOT_BATCH):
            if p0 == 0:
                fm = pilot_batch
            else:
                fm = H.fmix32(np.arange(p0, p0 + _PILOT_BATCH, dtype=U32))
            slots = H.mulhi32(H.fmix32(blo[None, :] ^ fm[:, None]), ts32).astype(np.int64)
            free = ~taken[slots]
            ok = free.all(axis=1)
            if c > 1:
                ss = np.sort(slots, axis=1)
                ok &= (ss[:, 1:] != ss[:, :-1]).all(axis=1)
            hit = np.flatnonzero(ok)
            if hit.size:
                r = hit[0]
                pilots[ub[bi]] = U32(p0 + r)
                taken[slots[r]] = True
                placed = True
                break
        if not placed:
            raise MPHFBuildError("pilot search exhausted")

    return pilots, taken
