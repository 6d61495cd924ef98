#!/usr/bin/env python3
"""The capacity path on one NVIDIA card: an index past 2^31 k-mers, built
out of core by the port's own builder and served whole through one
TorchEngine, every answer held to ground truth that does not come from the
index.

    python3 capacity_run.py [--kmers 2200000000] [--workdir build/capacity]
                            [--stages generate,build,tables,serve]
                            [--ram-mb 4096] [--scan-procs 4] [--threads N]
                            [--chunk 16777216]

The configuration is the JAX package's capacity artifact's: 2.2B requested
k-mers of the out-of-core soak's strings (synthetic.soak_strings: 100,000
random ACGT chars a string from seed 7), k31 m17, regular. Stages, each
printing one JSON line with its seconds and peak RSS:

  generate  the soak's FASTA, written one string at a time
  build     Dictionary.build out of core (--ram-mb, --scan-procs scan
            workers, --threads for the ranged assembly), Index.save in the
            mmap directory format; the router's flushes and the MPHF's
            partitions recorded
  tables    the device tables of the automatic row format (v1 below 2^32
            chars) written straight into .npy files (layout.write_tables),
            a chunk of rows at a time
  serve     Index.load and the cached tables with mmap_mode="r", then
            TorchEngine(index, "cuda", host_arrs=...) over them, and then
            over forced v2 rows (their tables built in memory on threads),
            the first engine freed in between; each runs serve_checks: positives
            (2^24 lanes, half reverse-complemented, drawn as (string,
            position) and read from the regenerated strings: id = string *
            (100,000 - k + 1) + position, the file order), negatives,
            is_member, access, navigation, iteration, streaming (v1), ids at
            and above 2^31 counted on every entry point, each entry point
            timed, table bytes and peak device memory. Then a ShardedEngine
            on LocalMesh((1, 4)) over the same index, held to the first
            engine's answers (or the bytes that did not fit).

generate, build and tables each run in a child process (its own peak RSS)
and keep their output under the work directory, keyed by k-mers, k, m and
the row format (and a v2 table's layout version, layout.LAYOUT_VERSION): a
second run reuses each finished stage and starts where the last one
stopped. The last line is one JSON summary (the fields of the
JAX package's CAPACITY_r05.json, the card's name and power limit); the exit
status is non-zero on any mismatch or without a CUDA card. Nothing here
imports JAX or the JAX package, and nothing is written outside the work
directory.
"""

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sshash_tpu_torch import kmer as K  # noqa: E402
from sshash_tpu_torch.pool import ordered_map  # noqa: E402

M32 = 0xFFFFFFFF
ABOVE = 1 << 31
# the JAX artifact's index shape and the sizes its acceptance fixes: 2^24
# positive and as many negative lanes, 2^20 navigation lanes held to the
# oracle on a 2^12 sample, 2^16 cut reads and as many random ones, drawn
# from SEED
KMER_LEN, MINIMIZER_LEN = 31, 17
LANES = 1 << 24
NAV_LANES = 1 << 20
NAV_SAMPLE = 1 << 12
READS = 1 << 16
SEED = 0x2031
# the automatic row format (its tables cached on disk), then forced v2
# rows (built in memory, not cached: at 2.2B k-mers both formats' tables
# would add 56 GB of disk writes to the input's, the spills' and the
# index's)
FORMATS = (None, "v2")
SHARD_SHAPE = (1, 4)
# the checks whose lanes must reach ids at or above 2^31 at capacity
ABOVE_CHECKS = ("positives", "positives_full_fields", "access", "navigation", "iteration",
                "streaming")
# a stage's child starts from this small interpreter, so that its peak RSS
# is its own (a child keeps its parent's high-water mark through exec)
SPAWN = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"


def peak_rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_now_mb():
    """This process's resident memory now in MB, from /proc/self/status:
    VmRSS, and its anonymous and file-backed (mapped tables) parts where
    the kernel reports them."""
    with open("/proc/self/status") as f:
        return {ln.split(":")[0]: int(ln.split()[1]) / 1024 for ln in f
                if ln.startswith(("VmRSS", "RssAnon", "RssFile"))}


def host_record(workdir):
    """The host the run has: cores, RAM and the work directory's free disk."""
    with open("/proc/meminfo") as f:
        mem_kb = next(int(ln.split()[1]) for ln in f if ln.startswith("MemTotal"))
    return {"stage": "host", "cores": os.cpu_count(), "mem_total_gib": mem_kb / 2 ** 20,
            "disk_free_gb": shutil.disk_usage(workdir).free / 1e9}


def emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


class CapacityError(AssertionError):
    """A served answer differs from the ground truth."""


# ------------------------------------------------------------ ground truth


class Strings:
    """Equal-length strings in file order, the ground truth of an index
    built from them: batches() yields (first string id, (n, length) uint8
    codes in the index's 2-bit map); k-mer id = string * (length - k + 1)
    + position."""

    def __init__(self, n, length, batches):
        self.n, self.length, self.batches = n, length, batches

    @classmethod
    def soak(cls, num_kmers, k):
        from sshash_tpu_torch import synthetic

        def batches():
            for i, seq in enumerate(synthetic.soak_strings(num_kmers, k)):
                yield i, K.encode_chars(seq)[0][None]
        return cls(synthetic.soak_count(num_kmers, k), synthetic.SOAK_STRING_LEN, batches)


def _string_sum(words):
    """Sum of each k-mer's u32 words XORed together (the iterator's
    checksum terms), as a Python int."""
    x = np.bitwise_xor.reduce((words & np.uint64(M32)) ^ (words >> np.uint64(32)), axis=1)
    return int(x.sum())


def ground_truth(src, k, lanes, reads, read_len=150, seed=SEED, threads=1):
    """One pass over the strings: the iteration checksum, the forward k-mers
    of `lanes` (string, position) draws and `reads` reads of read_len cut at
    random (half reverse-complemented), plus as many random reads and
    `lanes` random k-mers. The first half of the lanes is
    reverse-complemented."""
    from sshash_tpu_torch import synthetic

    rng = np.random.default_rng(seed)
    per = src.length - k + 1
    sid = rng.integers(0, src.n, lanes)
    pos = rng.integers(0, per, lanes)
    r_sid = rng.integers(0, src.n, reads)
    r_off = rng.integers(0, src.length - read_len + 1, reads)
    r_rc = rng.random(reads) < 0.5
    negatives = synthetic.random_kmers(k, rng, lanes)
    random_reads = synthetic.random_reads(reads, read_len, rng)
    fwd = np.zeros((lanes, K.num_words64(k)), dtype=np.uint64)
    cut = [b""] * reads
    lane_of = np.argsort(sid, kind="stable")
    lane_at = np.searchsorted(sid[lane_of], np.arange(src.n + 1))
    read_of = np.argsort(r_sid, kind="stable")
    read_at = np.searchsorted(r_sid[read_of], np.arange(src.n + 1))

    def strings(batch):
        first, codes = batch
        total = 0
        for j, c in enumerate(codes):
            i = first + j
            words = synthetic.window_words(c, k)
            total += _string_sum(words)
            ln = lane_of[lane_at[i]: lane_at[i + 1]]
            fwd[ln] = words[pos[ln]]
            for r in read_of[read_at[i]: read_at[i + 1]]:
                s = K.decode_codes(c[r_off[r]: r_off[r] + read_len])
                cut[r] = synthetic.revcomp_bytes(s) if r_rc[r] else s
        return total

    checksum = sum(ordered_map(strings, src.batches(), threads)) & M32
    rc = np.zeros(lanes, dtype=bool)
    rc[: lanes // 2] = True
    query = fwd.copy()
    query[rc] = K.revcomp_kmers(fwd[rc], k)
    return {"k": k, "per": per, "n_strings": src.n, "length": src.length,
            "ids": sid * per + pos, "sid": sid, "pos": pos, "fwd": fwd, "query": query,
            "orientation": np.where(rc, -1, 1), "negatives": negatives,
            "checksum": checksum, "num_kmers": src.n * per,
            "reads": cut + random_reads, "read_first_ids": r_sid * per + r_off}


def kmers_at(src, k, ids, threads=1):
    """The forward k-mers of `ids`, from a second pass over the strings
    (for the rare lane whose answer needs it: a k-mer present twice, or a
    random k-mer that is in the strings)."""
    from sshash_tpu_torch import synthetic

    per = src.length - k + 1
    ids = np.asarray(ids, dtype=np.int64)
    out = np.zeros((len(ids), K.num_words64(k)), dtype=np.uint64)
    if not len(ids):
        return out
    sid, pos = ids // per, ids % per

    def strings(batch):
        first, codes = batch
        for j, c in enumerate(codes):
            ln = np.flatnonzero(sid == first + j)
            if len(ln):
                out[ln] = synthetic.window_words(c, k)[pos[ln]]

    for _ in ordered_map(strings, src.batches(), threads):
        pass
    return out


# ----------------------------------------------------------------- checks


class Checks:
    """Collects each check's record and its failures; raise_any raises a
    CapacityError naming every failed check."""

    def __init__(self, tag, log=emit, above=()):
        self.tag, self.log, self.failures, self.above = tag, log, [], set(above)

    def record(self, what, ok, **kw):
        # a check named in `above` also needs lanes whose ids are >= 2^31
        n_above = kw.get("ids_at_or_above_2_31", kw.get("cut_reads_at_or_above_2_31"))
        ok = bool(ok) and (what not in self.above or bool(n_above))
        rec = {"check": what, "engine": self.tag, "ok": ok, **kw}
        if not ok:
            self.failures.append(rec)
        self.log(rec)
        return rec

    def raise_any(self):
        if self.failures:
            raise CapacityError(f"{self.tag}: {len(self.failures)} checks failed: "
                                f"{[f['check'] for f in self.failures]}")


def _u32(t):
    return t.cpu().numpy().view(np.uint32).astype(np.int64)


def _verify_claims(src, gt, query, got_ids, got_ori, id_base, threads):
    """Lanes whose found id is not the drawn one: each is accepted only if
    the strings hold the query at the returned id in the returned
    orientation (a k-mer present twice). Returns the accepted mask."""
    k = gt["k"]
    true_ids = (got_ids - id_base) & M32
    ok = true_ids < gt["num_kmers"]
    at = kmers_at(src, k, np.where(ok, true_ids, 0), threads)
    rc = K.revcomp_kmers(query, k)
    want = np.where((got_ori == 1)[:, None], query, rc)
    return ok & (at == want).all(axis=1)


def serve_checks(eng, gt, src, id_base=0, nav_lanes=NAV_LANES, nav_sample=NAV_SAMPLE, workdir=None,
                 threads=1, tag="v1", above=(), log=emit):
    """Every entry point of `eng` (a TorchEngine) held to the ground truth
    gt (ground_truth over src). id_base: the engine's tables were rebased by
    synthetic.rebase_ids, so its lookups answer id + id_base mod 2^32 (its
    access and iteration read the true ids). above: the checks that must have
    lanes whose ids are at or above 2^31. Returns (summary, checks,
    answers); answers hold the engine's id answers for a second engine."""
    import torch

    from sshash_tpu_torch import streaming as ST
    from sshash_tpu_torch import synthetic
    from sshash_tpu_torch.dictionary import Dictionary
    from sshash_tpu_torch.engine import _neighbours_to_host

    idx, cfg, dev = eng.index, eng.cfg, eng.device
    c = Checks(tag, log, above)
    B = len(gt["ids"])
    want_ids = (gt["ids"] + id_base) & M32
    kt = eng.kmers32(gt["query"])
    # positives: ids and orientations through the ids lookup, and every
    # field through the full lookup on v1
    res = eng.lookup_ids_device(kt)
    got_ids, got_ori = _u32(res["kmer_id"]), res["kmer_orientation"].cpu().numpy()
    exact = got_ids == want_ids
    ori_exact = got_ori == gt["orientation"]
    bad = ~(exact & ori_exact)
    dup = np.zeros(B, dtype=bool)
    found = res["found"].cpu().numpy()
    if bad.any():
        dup[bad] = found[bad] & _verify_claims(src, gt, gt["query"][bad], got_ids[bad],
                                               got_ori[bad], id_base, threads)
    n_above = int((want_ids >= ABOVE).sum())
    c.record("positives", bool((exact & ori_exact | dup).all()), lanes=B,
             ids_exact=int(exact.sum()), orientations_exact=int(ori_exact.sum()),
             present_twice=int(dup.sum()), ids_at_or_above_2_31=n_above)
    answers = {"kt": kt, "ids": res["kmer_id"].cpu(), "ori": res["kmer_orientation"].cpu()}
    del res
    if not cfg.row_v2:
        full = eng.lookup_device(kt)
        sid, pos, L = gt["sid"], gt["pos"], gt["length"]
        want = {"kmer_id": want_ids, "kmer_orientation": gt["orientation"],
                "string_id": sid, "kmer_id_in_string": pos, "kmer_offset": sid * L + pos,
                "string_begin": sid * L, "string_end": (sid + 1) * L}
        # every field exact, but on a lane whose k-mer is present twice
        same = {key: ((full[key].cpu().numpy() == v) if key == "kmer_orientation"
                      else (_u32(full[key]) == v & M32)) | dup
                for key, v in want.items()}
        c.record("positives_full_fields", all(x.all() for x in same.values()), lanes=B,
                 exact={key: int(x.sum()) for key, x in same.items()},
                 ids_at_or_above_2_31=n_above)
        del full

    # negatives: random k-mers; one found is a false positive unless the
    # strings hold it at the returned id
    nt = eng.kmers32(gt["negatives"])
    nres = eng.lookup_ids_device(nt)
    n_found = nres["found"].cpu().numpy()
    present = np.zeros(B, dtype=bool)
    if n_found.any():
        present[n_found] = _verify_claims(src, gt, gt["negatives"][n_found],
                                          _u32(nres["kmer_id"])[n_found],
                                          nres["kmer_orientation"].cpu().numpy()[n_found],
                                          id_base, threads)
    c.record("negatives", not (n_found & ~present).any(), lanes=B, found=int(n_found.sum()),
             present_in_strings=int(present.sum()))
    del nres, nt

    # membership through the host entry point, both sets
    mem_pos = eng.is_member(gt["query"])
    mem_neg = eng.is_member(gt["negatives"])
    c.record("is_member", bool(mem_pos.all()) and not (mem_neg & ~present).any(),
             positives=int(mem_pos.sum()), negatives=int(mem_neg.sum()))

    # access: the drawn ids give back their forward k-mers
    it = torch.from_numpy(gt["ids"].astype(np.uint32).view(np.int32)).to(dev)
    acc = eng.access_device(it)
    got_km = K.u32_to_kmers64(acc.cpu().numpy().view(np.uint32), idx.k)
    c.record("access", bool((got_km == gt["fwd"]).all()), lanes=B,
             exact=int((got_km == gt["fwd"]).all(axis=1).sum()),
             ids_at_or_above_2_31=int((gt["ids"] >= ABOVE).sum()))
    del acc, it

    # navigation: nav_lanes of the positives; a sample equal to the host
    # oracle (ids shifted by id_base where the tables were rebased)
    nav_lanes = min(nav_lanes, B)
    ktn = kt[:nav_lanes]
    nav = eng.kmer_neighbours_device(ktn)
    rng = np.random.default_rng(0x3131)
    lanes = np.sort(rng.choice(nav_lanes, min(nav_sample, nav_lanes), replace=False))
    got = _neighbours_to_host({key: v[torch.from_numpy(lanes).to(dev)] for key, v in nav.items()})
    ref = Dictionary(idx).kmer_neighbours(gt["query"][lanes])
    mism = 0
    for side, cols in (("forward", slice(0, 4)), ("backward", slice(4, 8))):
        for key in got:
            want = ref[side][key]
            if key == "kmer_id":
                hit = want != np.uint64(2 ** 64 - 1)
                want = np.where(hit, (want.astype(np.int64) + id_base) & M32,
                                want.astype(np.int64)).astype(np.uint64)
            mism += int((got[key][:, cols] != want).sum())
    nav_ids = _u32(nav["kmer_id"])
    nav_found = nav["found"].cpu().numpy() if "found" in nav else nav_ids != M32
    c.record("navigation", mism == 0, lanes=nav_lanes, sample=len(lanes), mismatches=mism,
             neighbours_found=int(nav_found.sum()),
             ids_at_or_above_2_31=int((nav_found & (nav_ids >= ABOVE)).sum()))
    answers.update(nav_ids=nav["kmer_id"].cpu(), nav_lanes=nav_lanes)
    del nav, ktn

    # iteration: every k-mer counted, the checksum of the strings' k-mers
    count, checksum = (int(x) for x in eng.iterator())
    c.record("iteration", count == (gt["num_kmers"] & M32) and checksum == gt["checksum"],
             count=count, num_kmers=int(gt["num_kmers"]), checksum=checksum,
             truth_checksum=int(gt["checksum"]),
             ids_at_or_above_2_31=max(0, int(gt["num_kmers"]) - ABOVE))

    # streaming: the v1 engine's report equals the host _Batcher's; v2
    # rows refuse it
    if cfg.row_v2:
        try:
            ST.streaming_query_from_file(eng, os.devnull)
            refused = False
        except ValueError:
            refused = True
        c.record("streaming_refused", refused)
    else:
        path = os.path.join(workdir, f"reads_{tag}.fq")
        synthetic.write_reads(path, gt["reads"])
        rep = ST.streaming_query_from_file(eng, path)
        t0 = time.perf_counter()
        host = ST.host_report(idx, path)
        host_s = time.perf_counter() - t0
        n_cut = len(gt["read_first_ids"])
        wall_ms = rep["elapsed_millisec"]
        c.record("streaming", all(rep[key] == host[key] for key in host), reads=len(gt["reads"]),
                 report={key: v for key, v in rep.items()}, host_report_sec=host_s,
                 cut_reads_at_or_above_2_31=int(
                     (gt["read_first_ids"] + id_base >= ABOVE).sum()),
                 cut_reads=n_cut)

    tb = eng.table_bytes()
    summary = {"row_format": "v2_rebased" if cfg.row_v2 else "v1",
               "positives_checked": B, "positive_ids_exact": int(exact.sum()),
               "positive_orientations_exact": int(ori_exact.sum()),
               "positives_present_twice": int(dup.sum()),
               "negatives_checked": B, "negatives_found": int(n_found.sum()),
               "negatives_present_in_strings": int(present.sum()),
               "table_bytes": tb,
               "bytes_per_kmer": {g: n / idx.num_kmers for g, n in tb.items()}}
    if not cfg.row_v2:
        summary["streaming_wall_ms"] = wall_ms
    if dev.type == "cuda":
        summary["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    log({"engine": tag, **summary})
    return summary, c, answers


def time_entry_points(eng, gt, timer, nav_lanes=NAV_LANES):
    """Device ms of each entry point at serve_checks' shapes, as
    chip_smoke.py times them: timer = (median_ms, graph_ms), CUDA events
    around windows of calls, the iteration replayed from a CUDA graph."""
    import torch

    med, graph = timer
    kt, nt = eng.kmers32(gt["query"]), eng.kmers32(gt["negatives"])
    it = torch.from_numpy(gt["ids"].astype(np.uint32).view(np.int32)).to(eng.device)
    ktn = kt[:nav_lanes]
    ms = {"lookup_ids": med(lambda: eng.lookup_ids_device(kt)),
          "lookup_negatives": med(lambda: eng.lookup_ids_device(nt)),
          "access": med(lambda: eng.access_device(it)),
          "navigation": med(lambda: eng.kmer_neighbours_device(ktn)),
          "iteration": graph(eng.iterator_device)}
    if not eng.cfg.row_v2:
        ms["lookup_full"] = med(lambda: eng.lookup_device(kt))
    return ms


def lookup_bound(eng, gt):
    """The lookup's least ms over the positives (sshash_tpu_torch.bounds):
    the larger of kernel 1's operations and the bytes probe_bytes counts
    (each lane's kmer in and fields out, each distinct table row once; in
    regular mode the forward strand's rows, not the RC retry's, so the
    bound is below the work), and its bytes alone."""
    from sshash_tpu_torch.bounds import lookup_bounds, probe_args, probe_bytes
    from sshash_tpu_torch.ops import packed as P

    kt = eng.kmers32(gt["query"])
    args = probe_args(eng.cfg, kt, P.minimizer)
    nbytes = probe_bytes(eng.cfg, eng.tables, kt, args, fused=True)
    b = lookup_bounds(eng.cfg, kt.shape[0], nbytes, nbytes)
    return {"lookup_ids_ms": b["lookup"][0], "by": b["lookup"][1],
            "bytes_ms": b["lookup_bytes"][0], "bytes": nbytes}


def sharded_checks(index, host_arrs, answers, gt, device, timer=None, log=emit):
    """A ShardedEngine on LocalMesh(SHARD_SHAPE) over the same tables: its
    ids lookup of the positives, access and navigation equal the single
    engine's answers. Returns (summary, checks); summary["fits"] False with
    the bytes when the card cannot hold the shards."""
    import torch

    from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine

    c = Checks("sharded", log)
    try:
        seng = ShardedEngine(index, LocalMesh(SHARD_SHAPE, device), host_arrs=host_arrs)
    except torch.cuda.OutOfMemoryError as e:
        free, total = torch.cuda.mem_get_info(device)
        summary = {"fits": False, "free_bytes": int(free), "total_bytes": int(total),
                   "error": str(e).splitlines()[0]}
        log({"engine": "sharded", **summary})
        return summary, c
    kt = answers["kt"].to(device)
    res = seng.lookup_ids_device(kt)
    same = bool(torch.equal(res["kmer_id"].cpu(), answers["ids"])
                and torch.equal(res["kmer_orientation"].cpu(), answers["ori"]))
    c.record("sharded_lookup", same, lanes=kt.shape[0])
    del res
    it = torch.from_numpy(gt["ids"].astype(np.uint32).view(np.int32)).to(device)
    acc = K.u32_to_kmers64(seng.access_device(it).cpu().numpy().view(np.uint32), index.k)
    c.record("sharded_access", bool((acc == gt["fwd"]).all()), lanes=len(acc))
    ktn = kt[: answers["nav_lanes"]]
    nav = seng.kmer_neighbours_device(ktn)
    c.record("sharded_navigation", bool(torch.equal(nav["kmer_id"].cpu(), answers["nav_ids"])),
             lanes=ktn.shape[0])
    ms = {}
    if timer is not None:
        ms = {"lookup_ids": timer[0](lambda: seng.lookup_ids_device(kt)),
              "access": timer[0](lambda: seng.access_device(it))}
    summary = {"fits": True, "mesh": list(SHARD_SHAPE),
               "per_device_bytes": int(seng.per_device_bytes()),
               "shard_bytes": [int(b) for b in seng.shard_bytes],
               "shard_seconds": seng.shard_seconds, "ms": ms,
               "peak_device_bytes": int(torch.cuda.max_memory_allocated(device))
               if torch.device(device).type == "cuda" else None}
    log({"engine": "sharded", **summary})
    del seng
    return summary, c


# ----------------------------------------------------------------- stages


def _paths(a):
    """The stages' outputs under the work directory; a v2 table's key names
    its layout (layout.LAYOUT_VERSION: an earlier tree's v2 cache, whose
    blocks hold sid0, is rebuilt, not served); v1 rows never changed, and
    their key is the format alone."""
    from sshash_tpu_torch.layout import LAYOUT_VERSION

    tag = f"{a.kmers}_k{KMER_LEN}"

    def tables(rf):
        v = LAYOUT_VERSION[rf]
        return os.path.join(a.workdir, f"tables_{tag}_m{MINIMIZER_LEN}_{rf}"
                            + (f"_layout{v}" if v > 1 else ""))

    return {"fasta": os.path.join(a.workdir, f"soak_{tag}.fa"),
            "index": os.path.join(a.workdir, f"index_{tag}_m{MINIMIZER_LEN}"),
            "tables": tables}


def _finish(tmp, final, rec):
    """Record the stage's line beside its output and move the output into
    place: a path that exists is a finished stage."""
    if os.path.isdir(tmp):
        with open(os.path.join(tmp, "capacity_stage.json"), "w") as f:
            json.dump(rec, f)
    else:
        with open(tmp + ".json", "w") as f:
            json.dump(rec, f)
        os.replace(tmp + ".json", final + ".json")
    os.replace(tmp, final)
    return emit(rec)


def tables_stage(index, directory, row_format=None, chunk=1 << 24, threads=1):
    """The tables of one row format under directory, built a chunk of rows
    at a time (layout.write_tables), with meta.json; returns them loaded
    with mmap_mode="r"."""
    from sshash_tpu_torch import layout

    arrs = layout.write_tables(index, directory, row_format, chunk, threads)
    meta = {"k": index.k, "m": index.m, "canonical": bool(index.canonical),
            "num_kmers": int(index.num_kmers),
            "row_v2": layout.use_row_v2(index, row_format),
            "cw_cols": int(arrs["cw_row"].shape[1])}
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)
    return arrs


def run_stage(a, stage):
    """One stage in this process (the child of main)."""
    from sshash_tpu_torch import synthetic

    p = _paths(a)
    t0 = time.perf_counter()
    if stage == "generate":
        tmp = p["fasta"] + ".tmp"
        n = synthetic.write_soak(tmp, a.kmers, KMER_LEN)
        return _finish(tmp, p["fasta"], {
            "stage": "generate", "sec": time.perf_counter() - t0, "peak_rss_mb": peak_rss_mb(),
            "kmers": n, "strings": synthetic.soak_count(a.kmers, KMER_LEN),
            "bytes": os.path.getsize(tmp)})
    from sshash_tpu_torch import BuildConfig, Dictionary, Index

    if stage == "build":
        tmp = p["index"] + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        cfg = BuildConfig(k=KMER_LEN, m=MINIMIZER_LEN, canonical=False, verbose=False,
                          ram_limit_mb=a.ram_mb, tmp_dir=a.workdir, scan_procs=a.scan_procs,
                          threads=a.threads)
        d = Dictionary.build(p["fasta"], cfg)
        build_s = time.perf_counter() - t0
        d.save(tmp)
        st = d.index.stats
        f = d.index.minimizer_mphf
        return _finish(tmp, p["index"], {
            "stage": "build", "sec": time.perf_counter() - t0, "build_sec": build_s,
            "peak_rss_mb": peak_rss_mb(), "num_kmers": int(d.index.num_kmers),
            "num_chars": int(d.index.num_chars), "num_strings": int(d.index.num_strings),
            "num_minimizers": st["num_minimizers"],
            "mphf_partitions": int(getattr(f, "num_partitions", 1)),
            "spill_flushes": st.get("spill_flushes"), "ram_limit_mb": a.ram_mb,
            "scan_procs": a.scan_procs, "threads": a.threads,
            "index_bytes": sum(e.stat().st_size for e in os.scandir(tmp) if e.is_file()),
            "steps_sec": {key: v / 1e6 for key, v in st.items() if key.startswith("step")}})
    if stage == "tables":
        from sshash_tpu_torch import layout

        index = Index.load(p["index"])
        rf = "v2" if layout.use_row_v2(index) else "v1"
        final = p["tables"](rf)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        arrs = tables_stage(index, tmp, None, a.chunk, a.threads)
        return _finish(tmp, final, {
            "stage": "tables", "row_format": rf, "sec": time.perf_counter() - t0,
            "peak_rss_mb": peak_rss_mb(), "chunk_chars": a.chunk, "threads": a.threads,
            "bytes": {name: int(v.nbytes) for name, v in arrs.items()}})
    raise ValueError(f"unknown stage {stage!r}")


def _stage(a, stage, out):
    """Run a stage in a child process unless its output exists (then print
    its recorded line, marked reused)."""
    if os.path.exists(out):
        rec_path = (os.path.join(out, "capacity_stage.json") if os.path.isdir(out)
                    else out + ".json")
        with open(rec_path) as f:
            return emit({**json.load(f), "reused": True})
    argv = [sys.executable, "-c", SPAWN, sys.executable, os.path.abspath(__file__), "--stage",
            stage] + a.argv
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run(argv, check=True, env=env)
    with open(os.path.join(out, "capacity_stage.json") if os.path.isdir(out)
              else out + ".json") as f:
        return json.load(f)


def card():
    """The card's nvidia-smi name and power limit; exits without a card.
    torch is asked in a child, so that this process stays small while it
    starts the stages' processes."""
    probe = "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"
    if subprocess.run([sys.executable, "-c", probe]).returncode:
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def serve(a, smi):
    import torch

    from chip_smoke import graph_ms, median_ms
    from sshash_tpu_torch import Index, kernels, layout
    from sshash_tpu_torch.engine import TorchEngine

    p = _paths(a)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    kernels.library()
    emit({"stage": "kernels", "sec": time.perf_counter() - t0})
    index = Index.load(p["index"])
    src = Strings.soak(a.kmers, KMER_LEN)
    t0 = time.perf_counter()
    gt = ground_truth(src, KMER_LEN, LANES, READS, threads=a.threads)
    emit({"stage": "ground_truth", "sec": time.perf_counter() - t0, "peak_rss_mb": peak_rss_mb(),
          "lanes": LANES, "reads": len(gt["reads"]), "checksum": gt["checksum"]})
    if gt["num_kmers"] != index.num_kmers:
        raise CapacityError(f"the strings hold {gt['num_kmers']} k-mers, the index "
                            f"{index.num_kmers}")
    timer = (median_ms, graph_ms)
    runs, checks, sharded = {}, [], None
    for rf in FORMATS:
        name = "v2" if layout.use_row_v2(index, rf) else "v1"
        if rf is None:
            arrs = layout.load_tables(p["tables"](name))
        else:
            t0 = time.perf_counter()
            arrs = layout.device_arrays(index, rf, a.chunk, a.threads)
            emit({"stage": "tables", "row_format": name, "in_memory": True,
                  "sec": time.perf_counter() - t0, "peak_rss_mb": peak_rss_mb(),
                  "bytes": int(sum(v.nbytes for v in arrs.values()))})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = TorchEngine(index, dev, host_arrs=arrs, row_format=rf)
        torch.cuda.synchronize(dev)
        up = time.perf_counter() - t0
        emit({"stage": "upload", "engine": name, "sec": up, "peak_rss_mb": peak_rss_mb(),
              "rss_now_mb": rss_now_mb(),
              "bytes": int(sum(t.numel() * 4 for t in eng.tables.values()))})
        t0 = time.perf_counter()
        summary, c, answers = serve_checks(eng, gt, src, workdir=a.workdir, threads=a.threads,
                                           tag=name, above=ABOVE_CHECKS)
        summary.update(upload_sec=up, checks_sec=time.perf_counter() - t0,
                       ms=time_entry_points(eng, gt, timer), bound=lookup_bound(eng, gt),
                       row_words=layout.row_width(eng.cfg),
                       lookup_bytes=int(eng.table_bytes()["lookup"]))
        emit({"engine": name, "ms": summary["ms"], "bound": summary["bound"],
              "row_words": summary["row_words"], "lookup_bytes": summary["lookup_bytes"],
              "lookup_bytes_per_kmer": summary["lookup_bytes"] / index.num_kmers})
        runs[name], checks = summary, checks + [c]
        del eng
        torch.cuda.empty_cache()
        if rf is None:
            sharded, cs = sharded_checks(index, arrs, answers, gt, dev, timer)
            checks.append(cs)
            torch.cuda.empty_cache()
        del arrs, answers
    return index, gt, runs, sharded, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kmers", type=int, default=2_200_000_000)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "capacity"))
    ap.add_argument("--stages", default="generate,build,tables,serve")
    ap.add_argument("--ram-mb", type=int, default=4096)
    ap.add_argument("--scan-procs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--chunk", type=int, default=1 << 24, help="chars of rows a table piece")
    ap.add_argument("--stage", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    a = ap.parse_args(argv)
    a.argv = [x for i, x in enumerate(argv)
              if x != "--stage" and (i == 0 or argv[i - 1] != "--stage")]
    a.workdir = os.path.abspath(a.workdir)
    os.makedirs(a.workdir, exist_ok=True)
    if a.stage:
        run_stage(a, a.stage)
        return 0
    stages = a.stages.split(",")
    smi = card() if "serve" in stages else None
    p = _paths(a)
    recs = {"host": emit(host_record(a.workdir))}
    t_all = time.perf_counter()
    if "generate" in stages:
        recs["generate"] = _stage(a, "generate", p["fasta"])
    if "build" in stages:
        recs["build"] = _stage(a, "build", p["index"])
    if "tables" in stages:
        from sshash_tpu_torch import Index, layout

        index = Index.load(p["index"])
        name = "v2" if layout.use_row_v2(index) else "v1"
        recs["tables"] = _stage(a, "tables", p["tables"](name))
        del index
    if "serve" not in stages:
        return 0
    index, gt, runs, sharded, checks = serve(a, smi)
    name, limit = (x.strip() for x in smi.split(",", 1))
    worst = {"positive_ids_exact": min(r["positive_ids_exact"] for r in runs.values()),
             "positive_orientations_exact": min(r["positive_orientations_exact"]
                                                for r in runs.values()),
             "negatives_found": max(r["negatives_found"] for r in runs.values())}
    failures = [f for c in checks for f in c.failures]
    summary = {"metric": "capacity_over_2_31_kmers", "num_kmers": int(index.num_kmers),
               "num_chars": int(index.num_chars), "k": index.k, "m": index.m,
               "canonical": bool(index.canonical), "row_formats": list(runs),
               "positives_checked": LANES, **worst, "negatives_checked": LANES,
               "over_2_31": bool(index.num_kmers >= ABOVE),
               "host": recs["host"], "build": recs.get("build"), "engines": runs,
               "sharded": sharded,
               "failed_checks": [f"{f['engine']}:{f['check']}" for f in failures],
               "total_sec": time.perf_counter() - t_all,
               "device": {"name": name, "power_limit": limit}}
    emit(summary)
    for c in checks:
        c.raise_any()
    if index.num_kmers < ABOVE:
        raise CapacityError(f"{index.num_kmers} k-mers: the capacity path needs 2^31 or more")
    return 0


if __name__ == "__main__":
    sys.exit(main())
