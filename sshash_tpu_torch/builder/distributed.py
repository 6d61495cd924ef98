"""Multi-host (multi-process) build: the scan stage sharded across workers.

The reference parallelizes its heaviest build stage — the minimizer-tuple
scan — across threads of one machine (src/builder/compute_minimizer_tuples.cpp:19-117).
Here the same stage shards across PROCESSES that need share nothing but a
filesystem directory, which is exactly the multi-host build unit promised by
SURVEY §2.5/§7.6: each worker streams the input, scans only its assigned
sequence blocks, and spills minimizer tuples (with GLOBAL char positions)
to the hash-range files of builder/external.py, tagged by worker rank.
Assembly then runs on one coordinator, reading every range's worker files
in rank order — bit-identical to the single-process build because:

  * a tuple's spill range is a pure function of its minimizer hash, so the
    sharding never splits a bucket across files;
  * per-partition assembly totally orders tuples by (MPHF slot, global
    position) (external.py `np.lexsort((pos_all, tid))`); the only order
    the spill files must preserve is between tuples with EQUAL (slot,
    position) — canonical-mode forward/RC super-kmers at one position —
    and those are always emitted by one scan call into one range file,
    whose append order is preserved.

On a real multi-host deployment each host runs `scan_shard` with its rank
over a shared filesystem (or rsyncs its tag's files to the coordinator —
they are disjoint by name); this module's `build_distributed` demonstrates
the same protocol with local worker processes.
"""

import json
import os

import numpy as np

from .. import hashing as H
from .. import kmer as K
from ..mphf import MPHFBuildError
from .external import R_RANGES, TUPLE_DT, _SpillRouter, _assemble_ranged
from .parse import SequenceReader

U64 = np.uint64

# sequences are grouped into ~BLOCK_CHARS blocks assigned round-robin to
# workers; every worker derives the same assignment from the file alone
BLOCK_CHARS = 1 << 22


class _UnionRouter(_SpillRouter):
    """Coordinator read-view over every worker's tagged spill files."""

    def __init__(self, tmpdir, seed, ram_limit_bytes, tags, R=R_RANGES):
        super().__init__(tmpdir, seed, ram_limit_bytes, R=R)
        self.tags = list(tags)

    def _tagged(self, rid, tag):
        return os.path.join(self.dir, f"range_{rid:05d}{tag}.bin")

    def load(self, rid):
        parts = []
        for t in self.tags + [""]:
            p = self._tagged(rid, t)
            if os.path.exists(p):
                parts.append(np.fromfile(p, dtype=TUPLE_DT))
        if self.buf[rid]:
            parts.append(np.concatenate(self.buf[rid]))
        return np.concatenate(parts) if parts else np.zeros(0, dtype=TUPLE_DT)

    def reroute(self, new_seed):
        # merge worker files (rank order within each range) into this
        # router's own untagged files under the new seed (the shared
        # rename/re-add protocol of _SpillRouter._reroute_files)
        self.flush()
        paths = [self._tagged(rid, t)
                 for rid in range(self.R) for t in self.tags + [""]]
        self.tags = []
        self._reroute_files(paths, new_seed)


def scan_shard(input_path, k, m, seed, canonical, wid, nworkers, shared_dir,
               ram_bytes=1 << 29, block_chars=BLOCK_CHARS):
    """Worker `wid` of `nworkers`: stream the input, tuple-scan ONLY the
    sequence blocks assigned to this rank, spill to `shared_dir` with tag
    `_w{wid}`. Stateless apart from the spill files — safe to run in any
    process/host that sees the directory. Returns the tuple count."""
    from .. import native
    from ..hashing import mixer_magic

    if not native.available():
        raise RuntimeError("distributed build requires the native scanner")
    magic = mixer_magic(seed)
    scan_seed = int(H.splitmix64(U64(seed)))
    router = _SpillRouter(shared_dir, scan_seed, ram_bytes // 2,
                          tag=f"_w{wid}")
    # raw mode: non-owned sequences contribute only their LENGTH (to place
    # blocks); only owned blocks pay the 2-bit encode. Every block is owned
    # by exactly one rank, so the union still validates all input chars.
    reader = SequenceReader(input_path, k, weighted=False, raw=True)

    # the scan buffer honours the worker's share of the RAM budget (1 B/char
    # codes + ~2 B/char tuple-scan outputs); the router buffers the other
    # ram_bytes // 2
    flush_chars = min(1 << 26, max(ram_bytes // 8, 1 << 20))
    cbuf, lens, gstarts, owned_chars = [], [], [], 0

    def flush():
        nonlocal cbuf, lens, gstarts, owned_chars
        if not cbuf:
            return
        codes = np.concatenate(cbuf)
        ep = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=ep[1:])
        mn, ps, pik, cnt = native.tuple_scan(codes, ep, k, m, magic, canonical)
        ps = ps.astype(np.int64)
        seg = np.searchsorted(ep, ps, side="right") - 1
        gpos = ps - ep[seg] + np.asarray(gstarts, dtype=np.int64)[seg]
        router.add(mn, gpos, pik, cnt)
        cbuf, lens, gstarts, owned_chars = [], [], [], 0

    base = 0
    for seq in reader:
        if (base // block_chars) % nworkers == wid:
            codes, ok = K.encode_chars(seq)
            if not ok.all():
                bad = int(np.flatnonzero(~ok)[0])
                raise ValueError(
                    f"invalid character {chr(seq[bad])!r} in build input")
            cbuf.append(codes)
            lens.append(len(codes))
            gstarts.append(base)
            owned_chars += len(codes)
            if owned_chars >= flush_chars:
                flush()
        base += len(seq)
    flush()
    router.flush()
    # the full scan parameter set rides the meta file so the coordinator can
    # reject a rank that scanned with different parameters (same chars_seen,
    # different minimizers) or a different rank count (missing blocks)
    meta = {"wid": wid, "nworkers": int(nworkers), "k": int(k), "m": int(m),
            "seed": int(seed), "canonical": bool(canonical),
            "block_chars": int(block_chars),
            "tuples": int(router.total), "flushes": int(router.flushes),
            "chars_seen": int(base)}
    with open(os.path.join(shared_dir, f"meta_w{wid}.json"), "w") as f:
        json.dump(meta, f)
    return router.total


def _worker_argv(input_path, k, m, seed, canonical, wid, nworkers, shared_dir,
                 ram_bytes, block_chars):
    import sys

    return [sys.executable, "-m", "sshash_tpu_torch.builder.distributed",
            "--input", str(input_path), "-k", str(k), "-m", str(m),
            "--seed", str(seed), "--wid", str(wid),
            "--nworkers", str(nworkers), "--dir", str(shared_dir),
            "--ram-bytes", str(ram_bytes), "--block-chars", str(block_chars)] \
        + (["--canonical"] if canonical else [])


def build_distributed(input_path, config, stats, timed, nprocs,
                      block_chars=BLOCK_CHARS):
    """RAM-bounded build whose scan stage runs on `nprocs` worker processes
    (multi-host analog; see module docstring). Index arrays are bit-identical
    to the in-RAM and out-of-core single-process builds.

    With config.scan_dir set, the scan stage is assumed ALREADY DONE by
    `nprocs` ranks of the worker CLI (each host ran
    `python -m sshash_tpu_torch.builder.distributed --wid w --nworkers N --dir D`)
    and assembly reads that directory directly — every rank's meta file is
    checked against the coordinator's own parse before assembling. The
    directory is operator-owned and not deleted (though a re-seed retry
    merges its tagged files in place)."""
    import shutil
    import tempfile

    from .. import native

    if not native.available():
        raise RuntimeError("distributed build requires the native scanner")
    k, m = config.k, config.m
    ram_bytes = (config.ram_limit_mb or 1024) * (1 << 20)
    scan_dir = getattr(config, "scan_dir", None)
    if scan_dir is not None:
        return _build_distributed(input_path, config, stats, timed, k, m,
                                  ram_bytes, str(scan_dir), nprocs,
                                  block_chars, pre_spilled=True)
    tmpdir = tempfile.mkdtemp(prefix="sshash_dbuild_", dir=config.tmp_dir)
    try:
        return _build_distributed(input_path, config, stats, timed, k, m,
                                  ram_bytes, tmpdir, nprocs, block_chars)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _build_distributed(input_path, config, stats, timed, k, m, ram_bytes,
                       tmpdir, nprocs, block_chars, pre_spilled=False):
    import subprocess

    seed0 = config.seed

    if not pre_spilled:
        # workers may share THIS machine (the local demo mode), so the
        # --ram-mb budget splits across them; on a real multi-host
        # deployment each host runs the worker CLI with its own full budget
        worker_ram = max(ram_bytes // nprocs, 32 << 20)

        def scan_procs():
            # plain CLI subprocesses, no pickled state: the same command a
            # real multi-host deployment runs per host rank. `-m
            # sshash_tpu_torch.builder.distributed` must resolve without a pip
            # install and from any cwd, so the repo root rides PYTHONPATH.
            repo = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
            procs = [subprocess.Popen(_worker_argv(
                input_path, k, m, seed0, config.canonical, w, nprocs,
                tmpdir, worker_ram, block_chars), env=env)
                for w in range(nprocs)]
            for p in procs:
                p.wait()
            bad = [p.returncode for p in procs if p.returncode != 0]
            if bad:
                raise RuntimeError(f"scan worker(s) failed: exit codes {bad}")

        timed(f"steps 2-3 ({nprocs}-process sharded scan + spill)", scan_procs)

    # the coordinator's own pass: packed strings + parse metadata (weights,
    # endpoints) — the cheap stage after the SWAR encoder; tuple scanning
    # happened in the workers
    def pack_strings():
        reader = SequenceReader(input_path, k, config.weighted)
        words_parts = []
        carry = np.zeros(0, dtype=np.uint8)
        for codes in reader:
            allc = np.concatenate([carry, codes]) if len(carry) else codes
            n32 = (len(allc) // 32) * 32
            if n32:
                words_parts.append(K.pack_codes(allc[:n32]))
            carry = allc[n32:]
        words_parts.append(K.pack_codes(carry, pad_words=K.num_words64(k) + 1))
        return reader.finish(codes=None), np.concatenate(words_parts)

    parsed, words64 = timed("step 1 (parse + pack strings)", pack_strings)

    # integrity cross-check: every rank must have spilled, against the SAME
    # input the coordinator just parsed AND with the same scan parameters/
    # rank count (a rank run with different -m/--seed/--nworkers would
    # otherwise assemble a silently wrong or incomplete index)
    total_chars = int(parsed.endpoints[-1])
    want = {"nworkers": nprocs, "k": k, "m": m, "seed": seed0,
            "canonical": bool(config.canonical), "block_chars": block_chars,
            "chars_seen": total_chars}
    # the ranks' routers' flushes that wrote tuples, summed
    stats["spill_flushes"] = 0
    for w in range(nprocs):
        mpath = os.path.join(tmpdir, f"meta_w{w}.json")
        if not os.path.exists(mpath):
            raise RuntimeError(
                f"scan rank {w}/{nprocs} left no meta file in {tmpdir!r} — "
                f"did every rank run the worker CLI with --nworkers {nprocs}?")
        with open(mpath) as fh:
            meta = json.load(fh)
        if meta.get("wid") != w or meta.get("chars_seen") != total_chars:
            raise RuntimeError(
                f"scan rank {w} saw {meta.get('chars_seen')} input chars but "
                f"the coordinator parsed {total_chars} — ranks must scan the "
                f"exact same input file")
        bad = {kk: (meta.get(kk), vv) for kk, vv in want.items()
               if meta.get(kk) != vv and kk != "chars_seen"}
        if bad:
            raise RuntimeError(
                f"scan rank {w} ran with different parameters than this "
                f"assembly: {bad} (got, want)")
        stats["spill_flushes"] += meta.get("flushes", 0)
    extra = sorted(p for p in os.listdir(tmpdir)
                   if p.startswith("meta_w") and p.endswith(".json")
                   and not any(p == f"meta_w{w}.json" for w in range(nprocs)))
    if extra:
        raise RuntimeError(
            f"spill dir has meta files beyond rank {nprocs - 1}: {extra} — "
            f"scan_procs must equal the worker count that spilled")

    scan_seed = int(H.splitmix64(U64(seed0)))
    router = _UnionRouter(tmpdir, scan_seed, ram_bytes // 2,
                          tags=[f"_w{w}" for w in range(nprocs)])
    for attempt in range(16):
        try:
            return timed("steps 4-7 (ranged mphf + assembly)",
                         lambda: _assemble_ranged(parsed, router, words64, k,
                                                  m, seed0, router.seed,
                                                  config, stats))
        except MPHFBuildError:
            seed = int(H.splitmix64(U64(seed0) + U64((attempt + 1) * 0x9E3779B9)))
            router.reroute(seed)
    raise MPHFBuildError("distributed build failed after 16 global seeds")


def _main(argv=None):
    """Worker CLI — the command a real multi-host deployment runs on each
    host (rank `--wid` of `--nworkers`, spilling to the shared `--dir`):

        python -m sshash_tpu_torch.builder.distributed --input u.fa.gz -k 31 -m 21 \
            --seed 1 --wid 0 --nworkers 4 --dir /shared/spills

    After all ranks finish, any one host assembles from the shared
    directory with

        BuildConfig(scan_procs=4, scan_dir="/shared/spills")

    (meta files of every rank are verified against the coordinator's own
    parse). Without scan_dir, build_distributed spawns local workers with
    this same CLI."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m sshash_tpu_torch.builder.distributed")
    ap.add_argument("--input", required=True)
    ap.add_argument("-k", type=int, required=True)
    ap.add_argument("-m", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--wid", type=int, required=True)
    ap.add_argument("--nworkers", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--ram-bytes", type=int, default=1 << 29)
    ap.add_argument("--block-chars", type=int, default=BLOCK_CHARS)
    a = ap.parse_args(argv)
    scan_shard(a.input, a.k, a.m, a.seed, a.canonical, a.wid, a.nworkers,
               a.dir, ram_bytes=a.ram_bytes, block_chars=a.block_chars)


if __name__ == "__main__":
    _main()
