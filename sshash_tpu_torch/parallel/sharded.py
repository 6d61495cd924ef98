"""The bucket-sharded engine: lookup, access, weight, navigation and
streaming over a (data x bucket) mesh of shards.

Counterpart of sshash_tpu/parallel/sharded.py (ShardedEngine,
_branchfree_lookup, make_sharded_*, ShardedStream). The index splits over
the bucket axis by contiguous ranges, exactly as the JAX engine splits it
(`shard_tables`): the fused codeword rows by MPHF slot, with each shard's
mid-bucket rows re-keyed to local offsets; the heavy rows (sk_hrows, by
the skew classes' hindex, a pre-v1.2 index's derived) by row; strings32
by word, with a halo of W + 1 words; the access rows by id block; the
weight runs by run. The query
batch splits over the data axis by rows. Each shard answers the lanes it
owns through the kernels given its range (kernel 2's slot and heavy-row
owners, the access kernel's block and word owners, the weight kernel's
run owner, the stream window read).

A lookup needs no combine on a LocalMesh: a lane's MPHF slot has one
owner among the bucket shards, so kernel 2's shard form stores each lane
once, from its owner, into result tensors the data row's shards share
(their launches run in stream order). Kernel 1 runs once over the row's
lanes; a canonical lookup folds the tie retry into one probe (a tie
probes the same bucket, hence the same owner); a regular one runs a
forward round, then an RC round whose owners merge in place into the
lanes the forward round left unfound (BACKWARD, minimizer_found ORed).
In an index with skew classes, only the owner of a heavy lane's slot
knows its sk_hrows row: it writes the row into the row's shared hand-off
tensor, and the shard that holds the row stores the hit.
On a DistMesh each rank's kernel 2 writes every lane into one packed
buffer in the combine's order (the identity where another rank owns the
lane), the hand-off's row and the buffer each take one all_reduce MIN,
and the regular mode's two rounds merge as engine._merge does.

ShardedStream's lookups (its anchors' and both rounds over its missed
lanes) run in rank space, up to a count on the device, as the unsharded
stream's do: kernel 1's rank form, then kernel 2's rank form in the same
owned or packed form: a list pass a round and hand-off pass
(engine.rank_lists: each active rank's slot evaluated once, the rank
listed), then the list probe (engine.probe_ranks), on a LocalMesh one list
and one launch for the data row (a launch for each layout.MAX_ROW_SHARDS
of its shards), each rank probed on its owner shard's tables; on a
DistMesh both on the rank's own shard.

The other answers combine over the bucket axis (mesh.py; on a LocalMesh
one launch of the combine kernel): the access's kmers, the weights and
the string windows by unsigned max, the two-round access's char offsets
by unsigned min, the per-row counters by sum.
"""

import functools
import time

import numpy as np
import torch

from .. import kmer as K
from ..engine import (_neighbours_to_host, _to_host_result, access, access_read,
                      canonical_fold, make_lookup, make_neighbours, merge_rc, probe,
                      probe_ranks, rank_lists, rc_misses, unpack_result, weight)
from ..kernels import result_dtypes
from ..layout import (AccessShard, ProbeShard, StaticCfg, device_arrays, packed_rows,
                      port_tables, tables_from_host, with_access_tables)
from ..ops import packed as P
from ..streaming import (KERNEL_OPS, _bits, _DeviceStream, check_streamable, make_stream_step,
                         stream_count, stream_swin)
from .mesh import LocalMesh

REPORT_KEYS = ("num_kmers", "num_positive_kmers", "num_extensions", "num_searches",
               "num_invalid_kmers", "num_negative_kmers")


def _ranges(sizes):
    """[3,2] -> [0,1,2,0,1] (per-group aranges)."""
    if not len(sizes):
        return np.zeros(0, dtype=np.int64)
    total = int(sizes.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.cumsum(sizes) - sizes
    return out - np.repeat(starts, sizes)


def _split_rekeyed(rows, status, cw_a, sizes, per_shard, nb):
    """Each shard's rows of the mid buckets in its slot range, at local
    offsets: returns (per-shard row arrays, cw_a with those buckets'
    begins rewritten in place)."""
    out = []
    for j in range(nb):
        sl = slice(j * per_shard, (j + 1) * per_shard)
        sel = status[sl] == 1
        sz = np.where(sel, sizes[sl], 0).astype(np.int64)
        local_begin = np.cumsum(sz) - sz
        idx = np.repeat(cw_a[sl][sel].astype(np.int64), sz[sel]) + _ranges(sz[sel])
        out.append(rows[idx] if len(idx) else np.zeros((0, rows.shape[1]), rows.dtype))
        cw_a[sl] = np.where(sel, local_begin.astype(cw_a.dtype), cw_a[sl])
    return out


def _stack_padded(parts):
    """Per-shard row arrays padded to one length (at least 1), stacked."""
    n = max(1, max(len(p) for p in parts))
    return np.concatenate([np.pad(p, ((0, n - len(p)), (0, 0))) for p in parts])


def shard_tables(host, cfg, nb, index=None):
    """The table dict of layout.device_arrays (or of the JAX package's
    _device_arrays, converted by layout.port_tables first: a legacy heavy
    path's through `index`) split over nb bucket shards, as the JAX
    ShardedEngine splits an index whose skew classes carry hindex
    (sharded.py:548-664 of the JAX package). Returns (one dict
    per shard, geometry): a sharded table holds the shard's slice, a
    replicated one the whole array (the same object in every dict);
    sidk32 and kmer_cum are dropped. geometry: per_shard (slots),
    per_shard_hrows (sk_hrows rows, None without skew classes),
    per_shard_swords (strings32 words) and per_shard_blocks (access
    rows)."""
    host = {key: v for key, v in port_tables(cfg, host, index).items()
            if key not in ("sidk32", "kmer_cum")}
    sharded = {}
    n_cw = len(host["cw_row"])
    per_shard = -(-n_cw // nb)
    cw_row = np.zeros((per_shard * nb, host["cw_row"].shape[1]), dtype=host["cw_row"].dtype)
    cw_row[:n_cw] = host["cw_row"]

    # mid rows go with their codeword's slot range, cw_a rewritten local
    status = cw_row[:, 0] & 3
    cw_a = cw_row[:, 1].copy()
    cw_b = cw_row[:, 0] >> 2
    sharded["mid_rows"] = _stack_padded(
        _split_rekeyed(host["mid_rows"], status, cw_a, cw_b, per_shard, nb))
    cw_row[:, 1] = cw_a
    sharded["cw_row"] = cw_row

    # heavy lanes resolve through sk_hrows, split by row
    per_hr = None
    if cfg.has_skew and "sk_hrows" in host:
        hr = host["sk_hrows"]
        per_hr = max(1, -(-len(hr) // nb))
        sk = np.zeros((per_hr * nb, hr.shape[1]), hr.dtype)
        sk[: len(hr)] = hr
        sharded["sk_hrows"] = sk

    # strings by word range with a halo (a k-char read spans <= W+1 words),
    # access rows by id block, weight runs by run
    s32 = host["strings32"]
    halo = cfg.W + 1
    per_sw = max(1, -(-len(s32) // nb))
    sw = np.zeros((nb, per_sw + halo), s32.dtype)
    for j in range(nb):
        seg = s32[j * per_sw: j * per_sw + per_sw + halo]
        sw[j, : len(seg)] = seg
    sharded["strings32"] = sw.reshape(-1)
    acc = host["acc_rows"]
    per_blk = max(1, -(-len(acc) // nb))
    acc_pad = np.zeros((per_blk * nb, acc.shape[1]), acc.dtype)
    acc_pad[: len(acc)] = acc
    sharded["acc_rows"] = acc_pad
    if "w_endpoints" in host:
        sharded["w_endpoints"], sharded["w_value_ids"] = split_weight_runs(
            host["w_endpoints"], host["w_value_ids"], nb)

    shards = []
    for j in range(nb):
        d = dict(host)
        for key, v in sharded.items():
            n = len(v) // nb
            d[key] = v[j * n: (j + 1) * n]
        shards.append(d)
    geometry = {"per_shard": per_shard, "per_shard_hrows": per_hr, "per_shard_swords": per_sw,
                "per_shard_blocks": per_blk}
    return shards, geometry


def split_weight_runs(ep, value_ids, nb):
    """The weight runs split by run into nb equal parts, as the JAX
    ShardedEngine splits them: (endpoints, value ids), each nb parts end
    to end. Part j holds its runs' endpoints (one more than its runs),
    padded with the last endpoint, so an id outside [first, last) of the
    part is not its own; an empty part is the last endpoint alone."""
    n_iv = len(ep) - 1
    per_iv = max(1, -(-n_iv // nb))
    eps, vids = [], []
    for j in range(nb):
        lo, hi = j * per_iv, min(n_iv, (j + 1) * per_iv)
        e = ep[lo: hi + 1] if hi > lo else np.array([ep[-1]], ep.dtype)
        eps.append(np.pad(e, (0, per_iv + 1 - len(e)), constant_values=ep[-1]))
        v = value_ids[lo:hi]
        vids.append(np.pad(v, (0, per_iv - len(v))))
    return np.concatenate(eps), np.concatenate(vids)


class ShardedEngine:
    """An index split over the bucket axis of a mesh (mesh.LocalMesh or
    mesh.DistMesh; LocalMesh((1, 2)) on the card by default), and the
    batched point queries and streaming over it: lookup, access, weight,
    navigation, a per-position stream report and ShardedStream.

    host_arrs: a precomputed table dict (layout.device_arrays, or the JAX
    package's _device_arrays) for large indexes; row_format as TorchEngine's
    (a v2 engine serves the id fields only). On a DistMesh a rank uploads
    its own column's tables only. Entry points that take tensors take the
    rows of the batch this process answers (every row on a LocalMesh), a
    multiple of the mesh's local row count."""

    def __init__(self, index, mesh=None, host_arrs=None, row_format=None):
        self.index = index
        self.mesh = mesh if mesh is not None else LocalMesh((1, 2))
        self.device = self.mesh.device
        self.cfg = StaticCfg(index, row_format)
        nb = self.mesh.shape[1]
        if host_arrs is None:
            host_arrs = device_arrays(index, row_format)
        else:
            host_arrs = with_access_tables(index, self.cfg, host_arrs)
        t0 = time.perf_counter()
        shards, geo = shard_tables(host_arrs, self.cfg, nb, index)
        self.shard_seconds = time.perf_counter() - t0  # the host transform
        self.geometry = geo
        self.shard_bytes = [sum(v.nbytes for v in d.values()) for d in shards]
        self.tables = {j: tables_from_host(shards[j], self.device, self.cfg)
                       for j in self.mesh.columns}
        del shards
        self.handoff = geo["per_shard_hrows"] is not None
        per, phr = geo["per_shard"], geo["per_shard_hrows"] or 0
        pblk, psw = geo["per_shard_blocks"], geo["per_shard_swords"]
        self.probe_shards = [ProbeShard(j * per, (j + 1) * per, j * phr, (j + 1) * phr)
                             for j in range(nb)]
        self.access_shards = [AccessShard(j * pblk, (j + 1) * pblk, j * psw, (j + 1) * psw)
                              for j in range(nb)]
        self.fields = "ids" if self.cfg.row_v2 else "full"
        self._lookups = {}
        self._neighbours = {}
        self._counts = {}

    # ---------------------------------------------------------------- helpers

    def per_device_bytes(self):
        """Index bytes one device holds: the host tables of this process's
        first bucket column (shard 0 on a LocalMesh, the rank's own column
        on a DistMesh), as the JAX ShardedEngine counts them (sharded
        tables their slice, replicated ones whole)."""
        return self.shard_bytes[self.mesh.columns[0]]

    def table_bytes(self):
        """Device bytes of each bucket column's tables this process holds (a
        DistMesh rank: its own column only)."""
        return {j: sum(t.numel() * t.element_size() for t in tab.values())
                for j, tab in self.tables.items()}

    def _row_shards(self, row):
        return [s for s in self.mesh.local if s[0] == row]

    def _split(self, x):
        """This process's rows of a batch tensor -> {row: slice}."""
        rows = self.mesh.rows
        if x.shape[0] % len(rows):
            raise ValueError(f"batch of {x.shape[0]} does not split over {len(rows)} rows")
        n = x.shape[0] // len(rows)
        return {i: x[r * n: (r + 1) * n] for r, i in enumerate(rows)}

    def _probe_row(self, row, cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2=None,
                   active=None, fields="full"):
        """Kernel 2 on this rank's shard of data row `row` (a DistMesh),
        combined over the bucket axis (engine.probe's contract; `tables` is
        unused): every lane into one packed buffer, the hand-off's rows and
        the buffer each one all_reduce MIN."""
        (s,) = self._row_shards(row)
        B = kmers32.shape[0]
        args = (cfg, self.tables[s[1]], kmers32, kmers_rc32, minval, minpos, minpos2)
        shard = self.probe_shards[s[1]]
        out = {"packed": torch.empty((packed_rows(fields), B), dtype=torch.int32,
                                     device=self.device)}
        if self.handoff:
            out["hrow"] = torch.empty(B, dtype=torch.int32, device=self.device)
        probe(*args, active, fields, shard, out=out)
        if self.handoff:
            hrow = self.mesh.pmin({s: out.pop("hrow")}, "bucket", unsigned=True)[s]
            probe(*args, active, fields, shard, hrows=hrow, out=out)
        return unpack_result(self.mesh.pmin({s: out["packed"]}, "bucket")[s], fields)

    def _probe_pass(self, row, out, call, rc_round=False):
        """One lookup round on a LocalMesh: kernel 2's shard form on every
        shard of data row `row`, call(j, **kw) on shard j, each storing into
        out the lanes it owns (the first shard also the inactive lanes, in
        the first round; it stores each lane's MPHF slot, which the others
        read), then in an index with skew classes the hand-off's second
        pass."""
        shards = self._row_shards(row)
        for n, s in enumerate(shards):
            call(s[1], out=out, fill=n == 0 and not rc_round, rc_round=rc_round,
                 slots=None if len(shards) == 1 else "read" if n else "store")
        if self.handoff:
            for s in shards:
                call(s[1], hrows=out["hrow"], out=out, rc_round=rc_round)

    def _result_tensors(self, B, fields):
        """A LocalMesh lookup's result tensors, uninitialised: every lane is
        stored by its owner (and "hrow", the hand-off's rows in an index
        with skew classes; "slot", the lanes' MPHF slots, with more than one shard)."""
        out = {name: torch.empty(B, dtype=dt, device=self.device)
               for name, dt in result_dtypes(fields).items()}
        for name in ("hrow",) * self.handoff + ("slot",) * (self.mesh.shape[1] > 1):
            out[name] = torch.empty(B, dtype=torch.int32, device=self.device)
        return out

    def _owned_lookup(self, row, fields):
        """make_lookup's fn(tables, kmers32, active=None) for data row `row`
        of a LocalMesh: kernel 1 over the row's lanes, the canonical fold or
        the regular mode's two rounds, each lane's fields stored once by its
        owner into one set of result tensors."""
        cfg = self.cfg

        def fn(tables, kmers32, active=None):
            mv_f, mp_f, rc, mv_r, mp_r = P.minimizer(kmers32, cfg.k, cfg.m, cfg.magic, both=True)
            out = self._result_tensors(kmers32.shape[0], fields)

            def shard_probe(args):
                return lambda j, **kw: probe(cfg, self.tables[j], *args, active, fields,
                                             self.probe_shards[j], **kw)

            if cfg.canonical:
                self._probe_pass(row, out, shard_probe(
                    (kmers32, rc, *canonical_fold(mv_f, mp_f, mv_r, mp_r))))
            else:
                self._probe_pass(row, out, shard_probe((kmers32, None, mv_f, mp_f, None)))
                self._probe_pass(row, out, shard_probe((rc, None, mv_r, mp_r, None)),
                                 rc_round=True)
            out.pop("hrow", None)
            out.pop("slot", None)
            return out

        return fn

    def _owned_ranks(self, row, fields):
        """The rank-space lookup of data row `row` on a LocalMesh: the owned
        stores of _owned_lookup over the ranks below the count. Each round
        (and hand-off pass) takes two launches: one list pass for the row,
        which evaluates each active rank's slot once and lists it (and fills
        the inactive ranks, in the first round), then kernel 2's rank form
        over the list, each rank probed on its owner shard's tables."""
        shards = [self.probe_shards[s[1]] for s in self._row_shards(row)]
        tables = [self.tables[s[1]] for s in self._row_shards(row)]
        # the row's keys, all in one list
        whole = ProbeShard(shards[0].slot_lo, shards[-1].slot_hi, shards[0].hrow_lo,
                           shards[-1].hrow_hi)

        def fn(cfg, tables_, kmers32, mins, active, count):
            out = self._result_tensors(kmers32.shape[0], fields)
            out.pop("slot", None)  # the list pass evaluates each slot once, for every shard
            args = (kmers32, mins, active, count, fields)
            for rc_round in (False,) if cfg.canonical else (False, True):
                for hrows in (None, "hrow") if self.handoff else (None,):
                    kw = dict(rc_round=rc_round, hrows=out[hrows] if hrows else None)
                    lists = rank_lists(cfg, tables[0], *args, whole, out,
                                       fill=not (rc_round or hrows), **kw)
                    probe_ranks(cfg, tables, *args, shards, out, lists=lists, **kw)
            out.pop("hrow", None)
            return out

        return fn

    def _packed_ranks(self, row, fields):
        """The rank-space lookup of data row `row` on a DistMesh: kernel
        2's rank form on this rank's shard into one packed (F, P) buffer
        (its list pass, the combine's identity on the ranks the shard does
        not own, then its list probe);
        the hand-off's rows and the buffer each take one all_reduce MIN,
        whose sizes stay P's whatever the count (the ranks at or past it
        are left unwritten, so they combine to values that nothing after
        the combine reads); in regular mode the RC round follows, merged as
        engine.merge_rc. No host read of the count."""
        (s,) = self._row_shards(row)
        tables, shard = self.tables[s[1]], self.probe_shards[s[1]]

        def one_round(kmers32, mins, active, count, rc_round):
            B = kmers32.shape[0]
            out = {"packed": torch.empty((packed_rows("full"), B), dtype=torch.int32,
                                         device=self.device)}
            if self.handoff:
                out["hrow"] = torch.empty(B, dtype=torch.int32, device=self.device)
            args = (self.cfg, tables, kmers32, mins, active, count, "full")

            def call(**kw):  # the list pass on this shard alone, then its list probe
                lists = rank_lists(*args, shard, out, rc_round=rc_round, **kw)
                probe_ranks(*args, shard, out, lists=lists, rc_round=rc_round, **kw)

            call()
            if self.handoff:
                call(hrows=self.mesh.pmin({s: out.pop("hrow")}, "bucket", unsigned=True)[s])
            return unpack_result(self.mesh.pmin({s: out["packed"]}, "bucket")[s], "full")

        def fn(cfg, tables_, kmers32, mins, active, count):
            res = one_round(kmers32, mins, active, count, False)
            if not cfg.canonical:
                miss = rc_misses(res, active)
                res = merge_rc(res, one_round(kmers32, mins, miss, count, True), miss)
            return {key: res[key] for key in result_dtypes(fields)}

        return fn

    def _ranks_fn(self, row, fields):
        """engine.lookup_ranks's fn(cfg, tables, kmers32, mins, active,
        count) for data row `row` (tables unused): kernel 2's rank form on
        its shards, the ranks below the device count looked up where active
        (every rank with active None) from kernel 1's rank-form minimizers,
        the others below it not found; fields "stream" (the stream's five)
        or "full". The ranks at or past the count are left unwritten."""
        key = ("ranks", row, fields)
        if key not in self._lookups:
            make = self._owned_ranks if isinstance(self.mesh, LocalMesh) else self._packed_ranks
            self._lookups[key] = make(row, fields)
        return self._lookups[key]

    def _count(self, n):
        """A device count of n (int32 (1,)), made once for each n."""
        if n not in self._counts:
            self._counts[n] = torch.full((1,), n, dtype=torch.int32, device=self.device)
        return self._counts[n]

    def _anchor_lookup(self, row):
        """fn(tables, kmers32), the full lookup of every lane of data row
        `row` in rank space (ShardedStream's anchors): kernel 1's rank form
        and kernel 2's rank form up to a device count of every lane."""
        cfg, ranks = self.cfg, self._ranks_fn(row, "full")

        def fn(tables, kmers32):
            count = self._count(kmers32.shape[0])
            mins = P.minimizer_ranks(kmers32, count, cfg.k, cfg.m, cfg.magic)
            return ranks(cfg, tables, kmers32, mins, None, count)

        return fn

    def _lookup_fn(self, row, fields):
        key = (row, fields)
        if key not in self._lookups:
            if isinstance(self.mesh, LocalMesh):
                self._lookups[key] = self._owned_lookup(row, fields)
            else:
                self._lookups[key] = make_lookup(self.cfg, fields,
                                                 probe=functools.partial(self._probe_row, row))
        return self._lookups[key]

    def _row_values(self, per_row):
        """{row: value} -> the row-level value dict of mesh.row_shards."""
        return {s: per_row[s[0]] for s in self.mesh.row_shards}

    def _psum_rows(self, per_row):
        """Sum of a per-row value over the data axis (the same everywhere)."""
        red = self.mesh.psum(self._row_values(per_row), "data")
        return red[self.mesh.row_shards[0]]

    def _psum_local(self, value):
        """Sum over the processes of a value each computed over all its
        rows."""
        rows = self.mesh.rows
        return self._psum_rows({i: value if i == rows[0] else torch.zeros_like(value)
                                for i in rows})

    def _gather(self, per_row):
        """{row: (n, ...) tensor} -> the concatenation in row order of every
        row this process answers."""
        return torch.cat([per_row[i] for i in self.mesh.rows])

    def kmers32(self, kmers64):
        """(B, W64) uint64 packed kmers -> (B, W) int32 tensor on the mesh's
        device."""
        k32 = np.ascontiguousarray(K.kmers_to_u32(np.atleast_2d(
            np.asarray(kmers64, dtype=np.uint64)), self.cfg.k))
        return torch.from_numpy(k32.view(np.int32)).to(self.device)

    def _ids(self, ids):
        ids = np.ascontiguousarray(np.asarray(ids, dtype=np.uint32))
        return torch.from_numpy(ids.view(np.int32)).to(self.device)

    def _local_rows(self, arr):
        """This process's rows of a global host batch (a multiple of D), and
        their [lo, hi)."""
        D = self.mesh.shape[0]
        n = len(arr) // D
        lo, hi = self.mesh.rows[0] * n, (self.mesh.rows[-1] + 1) * n
        return arr[lo:hi], (lo, hi)

    def _host_rows(self, arr):
        """A host batch padded to the data-axis size with its last row ->
        (this process's rows, their lo, how many of them are not padding)."""
        n = len(arr)
        pad = (-n) % self.mesh.shape[0]
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
        local, (lo, _) = self._local_rows(arr)
        return local, lo, max(0, n - lo)

    # ----------------------------------------------------------------- lookup

    def lookup_device(self, kmers32, fields=None):
        """(B, W) int32 kmers of this process's rows -> (dict of result
        tensors for them, report {num_kmers, num_positive} as int64 tensors
        summed over the data axis)."""
        fields = fields or self.fields
        res = {i: self._lookup_fn(i, fields)(None, km) for i, km in self._split(kmers32).items()}
        report = {"num_kmers": self._psum_rows(
                      {i: torch.tensor(len(r["found"]), device=self.device)
                       for i, r in res.items()}),
                  "num_positive": self._psum_rows({i: r["found"].sum() for i, r in res.items()})}
        return {key: self._gather({i: r[key] for i, r in res.items()}) for key in res[
            self.mesh.rows[0]]}, report

    def lookup_ids_device(self, kmers32):
        return self.lookup_device(kmers32, "ids")[0]

    def lookup_multiprocess(self, kmers64):
        """Every process passes the same global batch (a multiple of the
        data-axis size); returns (res, report, (lo, hi)): the host results
        of this process's rows [lo, hi) and the global report."""
        kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=np.uint64))
        if len(kmers64) % self.mesh.shape[0]:
            raise ValueError(f"multiprocess batch length must be a multiple of the data-axis "
                             f"size {self.mesh.shape[0]}")
        local, lohi = self._local_rows(kmers64)
        res, report = self.lookup_device(self.kmers32(local))
        return _to_host_result(res), {key: int(v) for key, v in report.items()}, lohi

    def lookup(self, kmers64):
        """(B, W64) uint64 packed kmers -> (numpy results as oracle.lookup,
        report). Pads the batch to the data-axis size and corrects the
        report for the padded lanes. On a DistMesh whose rows span
        processes, the results of this process's rows (the report is
        global)."""
        kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=np.uint64))
        local, lo, keep = self._host_rows(kmers64)
        res, report = self.lookup_device(self.kmers32(local))
        report = {key: int(v) for key, v in report.items()}
        pad = (-len(kmers64)) % self.mesh.shape[0]
        if pad:  # the device report counted the padded lanes
            report["num_kmers"] -= pad
            report["num_positive"] -= int(self._psum_local(res["found"][keep:].sum()))
        return _to_host_result({key: v[:keep] for key, v in res.items()}), report

    def is_member(self, kmers64):
        return self.lookup(kmers64)[0]["kmer_id"] != np.uint64(2 ** 64 - 1)

    # ------------------------------------------------- access, weight, navigation

    def access_device(self, ids):
        """(B,) int32 kmer ids of this process's rows -> (B, W) int32 kmers:
        the id block's owner reads its access row; in the windowed form it
        decodes the kmer and one unsigned max combines, else the char
        offset's unsigned min goes to the owner of the char's word, which
        reads from its strings slice, and an unsigned max combines."""
        out = {}
        for row, part in self._split(ids).items():
            shards = self._row_shards(row)
            got = {s: access(self.cfg, self.tables[s[1]], part, self.access_shards[s[1]])
                   for s in shards}
            if got[shards[0]].dim() == 1:  # two-round form: char offsets
                off = self.mesh.pmin(got, "bucket", unsigned=True)
                got = {s: access_read(self.cfg, self.tables[s[1]], off[s],
                                      self.access_shards[s[1]]) for s in shards}
            out[row] = self.mesh.pmax(got, "bucket", unsigned=True)[shards[0]]
        return self._gather(out)

    def access(self, ids):
        """kmer ids -> (B, W64) uint64 packed kmers, as oracle.access (on a
        DistMesh, this process's rows, as lookup)."""
        local, _, keep = self._host_rows(np.asarray(ids, dtype=np.uint32))
        out = self.access_device(self._ids(local))
        return K.u32_to_kmers64(out.cpu().numpy().view(np.uint32), self.cfg.k)[:keep]

    def weight_device(self, ids):
        """(B,) int32 kmer ids of this process's rows -> (B,) int32 weights:
        the run's owner searches its runs, an unsigned max combines."""
        if not self.cfg.weighted:
            raise RuntimeError("dictionary is not weighted")
        out = {}
        for row, part in self._split(ids).items():
            shards = self._row_shards(row)
            got = {s: weight(self.tables[s[1]], part, owned=True) for s in shards}
            out[row] = self.mesh.pmax(got, "bucket", unsigned=True)[shards[0]]
        return self._gather(out)

    def weight(self, ids):
        """kmer ids -> uint64 weights, as index.weights.weight."""
        local, _, keep = self._host_rows(np.asarray(ids, dtype=np.uint32))
        out = self.weight_device(self._ids(local))
        return out.cpu().numpy().view(np.uint32).astype(np.uint64)[:keep]

    def kmer_neighbours_device(self, kmers32):
        """(B, W) int32 kmers of this process's rows -> dict of (B, 8)
        tensors: the 8 one-char variants (neighbours kernel) through one
        sharded lookup."""
        out = {}
        for row, part in self._split(kmers32).items():
            if row not in self._neighbours:
                self._neighbours[row] = make_neighbours(
                    self.cfg, self.fields, lookup=self._lookup_fn(row, self.fields))
            out[row] = self._neighbours[row](None, part)
        return {key: self._gather({i: r[key] for i, r in out.items()})
                for key in out[self.mesh.rows[0]]}

    def kmer_neighbours(self, kmers64):
        """(B, W64) uint64 packed kmers -> dict of (B, 8) numpy arrays, as
        TorchEngine.kmer_neighbours."""
        local, _, keep = self._host_rows(np.atleast_2d(np.asarray(kmers64, dtype=np.uint64)))
        res = self.kmer_neighbours_device(self.kmers32(local))
        return {key: v[:keep] for key, v in _neighbours_to_host(res).items()}

    # ---------------------------------------------------------------- streaming

    def stream_report_device(self, kmers32, valid, first):
        """One per-position streaming step over this process's rows: (B, W)
        int32 kmers, bool valid and first (a read starts at the lane).
        Per data row the lookup, then the adjacency rules on the device (the
        stream's count kernel), the boundary stitch with data row i-1's last
        lane (ppermute), and the counters summed over the data axis.
        Returns the report's counters as int64 tensors."""
        check_streamable(self.cfg)
        kms, vs, fs = self._split(kmers32), self._split(valid), self._split(first)
        rows, lanes0 = {}, {}
        for row, km in kms.items():
            res = self._lookup_fn(row, "full")(None, km)
            n = km.shape[0]
            nwords = n // 32 + 1
            state = {"found": res["found"].to(torch.uint8), "string_id": res["string_id"],
                     "kmer_id": res["kmer_id"], "kmer_orientation": res["kmer_orientation"]}
            cnt = torch.full((1,), n, dtype=torch.int32, device=self.device)
            out = stream_count(state, _bits(vs[row], nwords), _bits(fs[row], nwords), cnt)
            rows[row] = out.to(torch.int64) & 0xFFFFFFFF
            lanes0[row] = fs[row][0]
        prev = self.mesh.ppermute(self._row_values({i: r[2] for i, r in rows.items()}))
        totals = {}
        for s in self.mesh.row_shards:
            r, p = rows[s[0]], prev[s]
            lane0 = r[1]
            ext0 = ((lane0[0] != 0) & ~lanes0[s[0]] & (p[0] != 0) & (lane0[1] == p[1])
                    & (lane0[3] == p[3]) & (lane0[2] == ((p[2] + p[3]) & 0xFFFFFFFF)))
            totals[s[0]] = torch.stack([r[0, 0], r[0, 1], r[0, 2] + ext0.to(torch.int64),
                                        r[0, 3]])
        n_all, n_pos, n_ext, n_inv = self._psum_rows(totals)
        return {"num_kmers": n_all, "num_positive_kmers": n_pos, "num_extensions": n_ext,
                "num_searches": n_pos - n_ext, "num_invalid_kmers": n_inv,
                "num_negative_kmers": n_all - n_pos - n_inv}

    def stream_report(self, kmers64, valid, first):
        """The streaming report of per-position kmers (B a multiple of the
        data-axis size; every process passes the whole batch). Reads may
        straddle data rows: the chain stitches across them."""
        kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=np.uint64))
        if len(kmers64) % self.mesh.shape[0]:
            raise ValueError(f"stream batch length must be a multiple of the data-axis "
                             f"size {self.mesh.shape[0]}")
        km, _ = self._local_rows(kmers64)
        flags = [torch.from_numpy(self._local_rows(np.asarray(x, dtype=bool))[0]).to(self.device)
                 for x in (valid, first)]
        rep = self.stream_report_device(self.kmers32(km), *flags)
        return {key: int(n) for key, n in rep.items()}


class ShardedStream(_DeviceStream):
    """Packed streaming over a ShardedEngine: streaming._DeviceStream's
    host side (chunking, long-read splits, counter folds and the chunk
    stitch, in stream order) with one step per data row, whose lookups are
    the engine's bucket-sharded ones and whose chain reads its string
    windows from their owners (stream_swin, then an unsigned max over the
    bucket axis). On a LocalMesh chunks go to the data rows in turn; on a
    DistMesh every rank streams its own row's reads (the bucket ranks of a
    row feed it the same reads) and finalize sums the rows' reports over
    the data axis. A row's step combines only within its row, so the rows
    need not run the same number of steps."""

    def __init__(self, engine, pmax=1 << 18, rmax_shift=4, runskip=None):
        super().__init__(engine, engine.index.k, pmax=pmax, rmax_shift=rmax_shift,
                         runskip=runskip)

    def step(self, row, all_valid, runskip=None, ops=KERNEL_OPS):
        """Data row `row`'s step (streaming.make_stream_step): the anchors
        and both rounds over the missed lanes in rank space on the row's
        shards, the string windows from their owners."""
        eng = self.engine
        return make_stream_step(eng.cfg, self.P, self.R, self.CW, eng._anchor_lookup(row),
                                all_valid=all_valid, ops=ops, runskip=runskip,
                                swin=functools.partial(self._swin, row),
                                lookup_ranks=eng._ranks_fn(row, "stream"))

    def _make_steps(self, runskip):
        return {(row, av): self.step(row, av, runskip)
                for row in self.engine.mesh.rows for av in (False, True)}

    def _swin(self, row, tables, ares):
        eng = self.engine
        shards = eng._row_shards(row)
        got = {s: stream_swin(ares["kmer_offset"], ares["kmer_orientation"],
                              eng.tables[s[1]]["strings32"], eng.cfg.k, eng.access_shards[s[1]])
               for s in shards}
        return eng.mesh.pmax(got, "bucket", unsigned=True)[shards[0]]

    def _run(self, all_valid, packed):
        rows = self.engine.mesh.rows
        return self._steps[(rows[self.chunks % len(rows)], all_valid)](None, packed)

    def finalize(self):
        rep = super().finalize()
        mesh = self.engine.mesh
        if len(mesh.rows) == mesh.shape[0]:
            return rep
        t = torch.tensor([rep[key] for key in REPORT_KEYS], dtype=torch.int64,
                         device=self.engine.device)
        tot = self.engine._psum_local(t)
        return dict(zip(REPORT_KEYS, (int(x) for x in tot)))
