#!/usr/bin/env python3
"""One rank of a DistMesh run of the bucket-sharded engine on the card:
chip_smoke.py's phase 16 starts up to eight of these processes, which share
one card and combine over gloo (NCCL refuses two ranks of a group on one
device), runs their legs, and holds each rank's rows to the LocalMesh
results it saved.

    python3 rank_run.py PLAN RANK

PLAN is a JSON file: {"out": a directory for the results, "device": the
ranks' device ("cuda:0" on the card; "cpu" runs the plain versions, a
rehearsal), "legs": [...]};
a leg is {"name", "shape": [D, NB], "port", "index": an Index.save
directory, "tables": a directory of layout.write_tables-style .npy tables
or null, "ref": the directory of its inputs and LocalMesh results, "ops":
the entry points to run, "fields": the lookup's fields, "reads": one read
file per data row or null, "pmax", "want": the reports the LocalMesh
gave}. Rank r joins every leg whose world D * NB exceeds r, each through
a gloo group of its own (multihost.initialize at the leg's port), on
DistMesh((D, NB), device), and writes <out>/<leg number>_<r>.json: its
checks, kernel launches (kernels.counts), each kernel's device ms (CUDA
events around every launch), its collectives' ms and calls (a synchronise
on each side: gloo stages them through host memory), its tables' bytes and
peak device memory, and on a card the launches of kernel 2's rank form
(its list pass and list probe) each held to its plain version on a copy
of its output (their count and max |err|). Every comparison is exact; the first that fails raises
and the process exits non-zero. The last line of a rank that finished is
RANK_OK <r>. Inputs in <ref>: q.npy (the lookup batch, (B, W64) uint64),
qids.npy (each lane's kmer id, -1 for a random kmer), mp.npy (the
multi-process batch), ids.npy (access and weight ids), nav.npy,
skm/sv/sf.npy (a per-position stream); results: lookup_<field>.npy,
mp_<field>.npy, member.npy, access.npy, weight.npy, nav_<field>.npy.
"""

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kernels
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.engine import canonical_fold, probe
from sshash_tpu_torch.index import Index
from sshash_tpu_torch.layout import load_tables, packed_rows
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import DistMesh, ShardedEngine, ShardedStream, multihost

M32 = 0xFFFFFFFF
TIMED_CALLS = 10  # calls a window, for the alone / together timing


def require(cond, what):
    if not cond:
        raise AssertionError(what)


class Timers:
    """CUDA events around every kernel launch (each by_device entry's
    wrapper), and the host clock around each collective of a mesh with a
    synchronise before and after it, so that neither takes in the other."""

    def __init__(self, dev):
        self.events = []
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
        if dev.type == "cuda":
            for entry in kernels.ENTRY_POINTS:
                entry.kernel = self._timed(entry.kernel)
        self.coll_s, self.coll_n = 0.0, 0

    def _timed(self, fn):
        def run(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.events.append((fn.__name__, e0, e1))
            return out
        run.__name__ = fn.__name__
        return run

    def watch(self, mesh):
        for name in ("_reduce", "ppermute"):
            setattr(mesh, name, self._collective(getattr(mesh, name)))

    def _collective(self, fn):
        def run(*args):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args)
            self.sync()
            self.coll_s += time.perf_counter() - t0
            self.coll_n += 1
            return out
        return run

    def reset(self):
        self.events, self.coll_s, self.coll_n = [], 0.0, 0
        kernels.reset_counts()

    def read(self):
        self.sync()
        ms = {}
        for name, e0, e1 in self.events:
            ms[name] = ms.get(name, 0.0) + e0.elapsed_time(e1)
        return {"launches": {n: c for n, c in kernels.counts().items() if c},
                "kernel_ms": ms, "collective_ms": self.coll_s * 1e3,
                "collectives": self.coll_n}


def list_by_rank(lists):
    """A list pass's list (engine.rank_lists) as int64 (rank, key) rows in
    rank order."""
    e = lists["entries"][:int(lists["count"][0])].to(torch.int64)
    return e[torch.argsort(e[:, 0])]


def rank_form_err(got, want, got_lists=None, want_lists=None):
    """Max |err| between two outputs of kernel 2's rank form: every tensor
    of its out dict, and a list pass's list compared by rank (a list of
    another length: inf)."""
    err = max((int((g.to(torch.int64) - want[key].to(torch.int64)).abs().max())
               for key, g in got.items() if g.numel()), default=0)
    if got_lists is not None:
        g, w = list_by_rank(got_lists), list_by_rank(want_lists)
        err = max(err, float("inf") if g.shape != w.shape
                  else int((g - w).abs().max()) if g.numel() else 0)
    return err


def held_to_plain(entry, check):
    """Set entry.kernel (engine.rank_lists or engine.probe_ranks) to its
    launch held to entry.plain, which runs on a copy of the output taken
    before the launch; check(err, args, kw, before) sees each launch (args:
    the first eight, out in kw). Returns the launch it wraps."""
    launch, lists = entry.kernel, entry is E.rank_lists

    def run(*a, **kw):
        a, kw = a[:8], dict(kw, **({"out": a[8]} if len(a) > 8 else {}))
        before = {key: v.clone() for key, v in kw["out"].items()}
        got = launch(*a, **kw)
        want_out = {key: v.clone() for key, v in before.items()}
        want = entry.plain(*a, **dict(kw, out=want_out))
        check(rank_form_err(kw["out"], want_out, got if lists else None,
                            want if lists else None), a, kw, before)
        return got

    entry.kernel = run
    return launch


class RankFormChecks:
    """On a card, every launch of kernel 2's rank form held to its plain
    version (held_to_plain): the launches checked and their max |err|."""

    def __init__(self):
        self.n, self.err = 0, 0
        for entry in (E.rank_lists, E.probe_ranks):
            held_to_plain(entry, self._seen)

    def _seen(self, err, *_):
        self.n += 1
        self.err = max(self.err, err)

    def read(self):
        out, self.n, self.err = {"rank_form_checked": self.n, "rank_form_err": self.err}, 0, 0
        return out


def npy(leg, name):
    return np.load(os.path.join(leg["ref"], name + ".npy"))


def rows_of(mesh, arr):
    """This rank's rows of a global host batch, and their [lo, hi)."""
    lo, hi = multihost.local_row_range(mesh, len(arr))
    return multihost.host_local_batch(arr, mesh), (lo, hi)


def same(got, want, what):
    require(got.shape == want.shape and np.array_equal(got, want), f"{what} differs")


def handoff_counter(mesh, shard, seen):
    """mesh.pmin, appending to seen the lanes of each hand-off combine (the
    one unsigned pmin over the bucket axis in a lookup) whose heavy row
    this rank found and another rank's shard holds."""
    pmin = mesh.pmin

    def counted(values, axis, unsigned=False):
        if unsigned and axis == "bucket":
            (v,) = values.values()
            h = v.to(torch.int64) & M32
            seen.append(int(((h != M32) & ((h < shard.hrow_lo) | (h >= shard.hrow_hi))).sum()))
        return pmin(values, axis, unsigned)

    return counted


def rank_kernels(eng, kt, j, minimizer=P.minimizer, probe=probe):
    """The kernels of bucket column j's rank in a lookup (ids), no
    collective: kernel 1 over its row's lanes, the fold or the forward
    round's arguments, kernel 2's packed form on its shard (minimizer and
    probe: the entries, or their plain versions)."""
    cfg = eng.cfg
    mv, mp, rc, mv_r, mp_r = minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    args = ((kt, rc, *canonical_fold(mv, mp, mv_r, mp_r)) if cfg.canonical
            else (kt, None, mv, mp, None))
    out = {"packed": torch.empty((packed_rows("ids"), kt.shape[0]), dtype=torch.int32,
                                 device=kt.device)}
    if eng.handoff:
        out["hrow"] = torch.empty(kt.shape[0], dtype=torch.int32, device=kt.device)
    return probe(cfg, eng.tables[j], *args, None, "ids", eng.probe_shards[j], out=out)


def window_ms(fn, dev):
    """Device ms a call over a window of TIMED_CALLS calls, after a warm-up
    (host ms on the CPU)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            fn()
        return (time.perf_counter() - t0) * 1e3 / TIMED_CALLS
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(TIMED_CALLS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / TIMED_CALLS


def alone_and_together(eng, kt, world, rank):
    """This rank's kernels timed with the card to itself (the other ranks
    wait at a barrier), then with every rank's at once."""
    j = eng.mesh.local[0][1]
    alone = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            alone = window_ms(lambda: rank_kernels(eng, kt, j), kt.device)
        dist.barrier()
    dist.barrier()
    together = window_ms(lambda: rank_kernels(eng, kt, j), kt.device)
    dist.barrier()
    return {"alone_ms": alone, "together_ms": together}


def run_leg(leg, rank, timers, dev, checks=None):
    D, NB = leg["shape"]
    world = D * NB
    t0 = time.perf_counter()
    multihost.initialize(f"localhost:{leg['port']}", world, rank, backend="gloo")
    mesh = DistMesh((D, NB), dev)
    require(mesh.device == dev and mesh.local == [(rank // NB, rank % NB)],
            f"rank {rank} holds {mesh.local} on {mesh.device}")
    idx = Index.load(leg["index"])
    host = load_tables(leg["tables"]) if leg["tables"] else None
    t1 = time.perf_counter()
    eng = ShardedEngine(idx, mesh, host_arrs=host)
    timers.sync()
    rec = {"leg": leg["name"], "rank": rank, "shard": list(mesh.local[0]),
           "setup_s": t1 - t0, "engine_s": time.perf_counter() - t1,
           "shard_s": eng.shard_seconds, "table_bytes": eng.table_bytes(),
           "per_device_bytes": eng.per_device_bytes(), "handoff": eng.handoff, "checks": []}
    require(list(rec["table_bytes"]) == [rank % NB], f"rank {rank} holds columns "
            f"{list(rec['table_bytes'])}")
    del host
    timers.watch(mesh)
    fields, ops, want = leg["fields"], leg["ops"], leg["want"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timers.reset()
    seen = []
    if "lookup" in ops:
        q = npy(leg, "q")
        mine, (lo, hi) = rows_of(mesh, q)
        kt = multihost.make_global_batch(K.kmers_to_u32(mine, idx.k), mesh, (len(q), eng.cfg.W))
        if eng.handoff:
            mesh.pmin = handoff_counter(mesh, eng.probe_shards[rank % NB], seen)
        res, rep = eng.lookup_device(kt, fields)
        if eng.handoff:
            del mesh.pmin
        require({key: int(v) for key, v in rep.items()} == want["lookup_report"],
                f"lookup report {rep} != {want['lookup_report']}")
        for key, v in res.items():
            same(v.cpu().numpy(), npy(leg, f"lookup_{key}")[lo:hi], f"lookup {key}")
        qids = npy(leg, "qids")[lo:hi]
        kid = res["kmer_id"].cpu().numpy().view(np.uint32).astype(np.int64)
        found = res["found"].cpu().numpy()
        pos = qids >= 0
        require(np.array_equal(kid[pos], qids[pos]) and found[pos].all(),
                "a positive did not round-trip")
        require(not found[~pos].any(), "a random kmer was found")
        rec["checks"].append(f"lookup ({fields}) of {hi - lo} lanes == LocalMesh in "
                             f"{len(res)} fields and the report; {int(pos.sum())} positives "
                             f"round-trip, {int((~pos).sum())} random kmers not found")
        rec["handoff_lanes"] = sum(seen)
    if "multiprocess" in ops:
        mp = npy(leg, "mp")
        res, rep, (lo, hi) = eng.lookup_multiprocess(mp)
        require(rep == want["mp_report"], f"multiprocess report {rep} != {want['mp_report']}")
        for key, v in res.items():
            same(v, npy(leg, f"mp_{key}")[lo:hi], f"lookup_multiprocess {key}")
        rec["checks"].append(f"lookup_multiprocess of rows [{lo}, {hi}) == LocalMesh")
    if "member" in ops:
        mp = npy(leg, "mp")
        lo, hi = multihost.local_row_range(mesh, len(mp))
        same(eng.is_member(mp), npy(leg, "member")[lo:hi], "is_member")
        rec["checks"].append("is_member == LocalMesh")
    if "access" in ops or "weight" in ops:
        ids = npy(leg, "ids")
        mine, (lo, hi) = rows_of(mesh, ids)
        it = multihost.make_global_batch(mine.astype(np.uint32), mesh, ids.shape)
        if "access" in ops:
            acc = eng.access_device(it)
            same(acc.cpu().numpy(), npy(leg, "access")[lo:hi], "access")
            back = eng.lookup_ids_device(acc)["kmer_id"].cpu().numpy().view(np.uint32)
            require(np.array_equal(back.astype(np.int64), mine.astype(np.int64)),
                    "an accessed kmer did not look up to its id")
            rec["checks"].append(f"access of {hi - lo} ids == LocalMesh, each looks up to its id")
        if "weight" in ops:
            same(eng.weight_device(it).cpu().numpy(), npy(leg, "weight")[lo:hi], "weight")
            rec["checks"].append(f"weight of {hi - lo} ids == LocalMesh")
    if "navigation" in ops:
        nav = npy(leg, "nav")
        mine, (lo, hi) = rows_of(mesh, nav)
        got = eng.kmer_neighbours_device(eng.kmers32(mine))
        for key, v in got.items():
            same(v.cpu().numpy(), npy(leg, f"nav_{key}")[lo:hi], f"navigation {key}")
        rec["checks"].append(f"navigation of {hi - lo} kmers == LocalMesh in {len(got)} fields")
    if "stream_report" in ops:
        got = eng.stream_report(npy(leg, "skm"), npy(leg, "sv"), npy(leg, "sf"))
        require(got == want["stream_report"], f"stream report {got} != "
                f"{want['stream_report']}")
        rec["checks"].append(f"stream_report == LocalMesh {got}")
    if "stream" in ops:
        st = ShardedStream(eng, pmax=leg["pmax"])
        for seq in ST.parse_reads(leg["reads"][mesh.rows[0]]):
            st.add_read(seq)
        got = st.finalize()
        require(got == want["stream"], f"packed stream {got} != {want['stream']}")
        rec["checks"].append(f"packed ShardedStream over row {mesh.rows[0]}'s reads ({st.chunks} "
                             f"chunks), summed == LocalMesh {got}")
    rec.update(timers.read())
    if checks is not None:
        rec.update(checks.read())
    if dev.type == "cuda":
        rec["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    if "timing" in ops:
        q = npy(leg, "q")
        mine, _ = rows_of(mesh, q)
        rec.update(alone_and_together(eng, eng.kmers32(mine), world, rank))
    dist.barrier()
    dist.destroy_process_group()
    rec["leg_s"] = time.perf_counter() - t0
    return rec


def main(plan_path, rank):
    with open(plan_path) as f:
        plan = json.load(f)
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        require(kernels.library_path().exists(), "the kernel library is not built: the parent "
                "builds it before it starts the ranks")
        torch.cuda.set_device(dev)
        kernels.library()
    else:
        torch.set_num_threads(1)
    timers = Timers(dev)
    checks = RankFormChecks() if dev.type == "cuda" else None
    for n, leg in enumerate(plan["legs"]):
        if rank >= leg["shape"][0] * leg["shape"][1]:
            continue
        rec = run_leg(leg, rank, timers, dev, checks)
        with open(os.path.join(plan["out"], f"{n}_{rank}.json"), "w") as f:
            json.dump(rec, f)
        print(f"rank {rank} {leg['name']}: {len(rec['checks'])} checks in {rec['leg_s']:.1f} s",
              flush=True)
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
