#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card, batched k-mer
lookup first, then access, iteration, weight and navigation, and check
them end to end.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the last
line):
  1. card: nvidia-smi name and power limit; no CUDA card -> exit 1
  2. build: one nvcc per csrc/ source, in parallel, for sm_90a (timed,
     registers per kernel, any spills)
  3. kernel == plain on the card, exactly: kernel 1 at B = 2^20 for
     (k, m) in (31, 17), (31, 21), (63, 25); on every small configuration
     of synthetic.SMALL_CONFIGS kernel 2 (full and ids fields), access
     (both row forms across the configurations), iteration, weight (the
     weighted configuration) and the neighbour variants
  4. main path, 5M kmers k31 m17 (the repo's salmonella bench config on
     synthetic unitigs), regular and canonical: 2^23 lanes, 50% reverse
     complemented, through TorchEngine; every id round-trips; a 2^20-lane
     sample of positives and negatives equals sshash_tpu.oracle in every
     field; launch counters of both kernels; lookup time through the
     kernels and through the plain versions
  5. heavy and sweep paths at 1M kmers k31 m13 with planted m-mers: lane
     counts per path, oracle equality
  6. scale, 200M kmers k31 m21 canonical (the repo's human-config scale
     bench): 2^24 lanes round-trip, 2^20-lane oracle sample, ns/kmer of the
     lookup and of each kernel, against the plain versions on the card,
     device bytes per kmer, peak device memory
  7. access, iteration, weight and navigation at 5M kmers, on phase 4's
     indexes: 2^23 random ids; access equals the oracle in every lane and
     each accessed kmer looks up to its id on the card; iteration count
     equals num_kmers and its checksum the oracle's; navigation of 2^20
     kmers equals the oracle's Dictionary.kmer_neighbours on a 2^14 sample;
     weight of 2^23 ids on a weighted 5M build (weight runs as long as in
     the reference's E. coli Sakai example) equals index.weights; each
     kernel equals its plain version on all lanes; times
  8. access and iteration at 200M kmers, on phase 6's index: 2^24 ids,
     access/lookup round trip on every lane, a 2^20 oracle sample, count
     equals num_kmers, kernel == plain; times
  Times are device times from CUDA events around windows of back-to-back
  calls, median of 7 windows after a warm-up; kernel and plain run in turns.
  Each path's launch counts are set to 0 just before it and read just
  after; every kernel of the path must have launched.
  9. one JSON line of per-kernel results, then the ok line.

Data is random, drawn from fixed seeds. Nothing here imports JAX.
"""

import importlib.abc
import json
import subprocess
import sys
import time


class _NoJax(importlib.abc.MetaPathFinder):
    """Keep JAX out of this process, so the run shows that the port needs
    none. (sshash_tpu/__init__.py imports jax for its compile cache when jax
    is installed, and goes on without it.)"""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked: the port runs without JAX")
        return None


sys.meta_path.insert(0, _NoJax())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sshash_tpu import Dictionary  # noqa: E402
from sshash_tpu import kmer as K  # noqa: E402
from sshash_tpu import oracle  # noqa: E402
from sshash_tpu.index import decode_codeword  # noqa: E402
from sshash_tpu_torch import TorchEngine, kernels, synthetic  # noqa: E402
from sshash_tpu_torch import engine as E  # noqa: E402
from sshash_tpu_torch.engine import (_neighbours_to_host, canonical_fold, make_lookup,  # noqa: E402
                                     make_neighbours, probe, probe_plain)
from sshash_tpu_torch.layout import acc_windowed, device_arrays  # noqa: E402
from sshash_tpu_torch.ops import packed as P  # noqa: E402

INVALID = np.uint64(2 ** 64 - 1)
REPS = 7
MAIN_B = 1 << 23
SCALE_B = 1 << 24
SAMPLE = 1 << 20
NAV_B = 1 << 20
NAV_SAMPLE = 1 << 14
STRING_LEN = 100_030  # 100,000 k31 kmers per string
MAIN_STRINGS, PATH_STRINGS, SCALE_STRINGS = 50, 10, 2000  # 5M, 1M, 200M kmers


def log(*args):
    print(*args, flush=True)


def median_ms(fn, reps=REPS, window_ms=20.0):
    """Device ms of one fn() call: CUDA events around a window of
    back-to-back calls (as many as fill about window_ms, at least one),
    divided by their number; the median over reps windows, after a warm-up.
    Queued launches keep the host's launch overhead out of the window."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(1, min(100, int(window_ms / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def time_turns(tag, what, n, kernel, plain, unit="kmer"):
    """Device ms of kernel() and plain() (n items per call), in turns plain,
    kernel, kernel, plain. Logs both and returns {side: median ms}."""
    fns = {"kernel": kernel, "plain": plain}
    runs = {}
    for side in ("plain", "kernel", "kernel", "plain"):
        runs.setdefault(side, []).append(median_ms(fns[side]))
    out = {}
    for side, v in runs.items():
        out[side] = ms = float(np.median(v))
        log(f"  {tag}: {what} with {side} versions: {ms:.4f} ms per {n} = "
            f"{ms * 1e6 / n:.4f} ns/{unit}, {n / ms * 1e3:.4g} {unit}s/s "
            f"(runs {['%.4f' % x for x in v]})")
    return out


def time_lookup(eng, kt, tag):
    """lookup (ids) of the (B, W) kmers kt through the kernels and through
    the plain versions on the card. Returns {side: median ms}."""
    plain = make_lookup(eng.cfg, "ids", minimizer=P.minimizer_plain, probe=probe_plain)
    return time_turns(tag, "lookup (ids)", kt.shape[0], lambda: eng.lookup_ids_device(kt),
                      lambda: plain(eng.tables, kt))


def max_abs_err(got, want):
    """Largest |kernel - plain| over matching tensors (0 when exact)."""
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def id_tensor(ids, dev):
    """Kmer ids -> (B,) int32 tensor of their u32 bits on dev."""
    return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.uint32).view(np.int32)).to(dev)


def kmer_tensor(km64, k, dev):
    return torch.from_numpy(np.ascontiguousarray(K.kmers_to_u32(km64, k)).view(np.int32)).to(dev)


def path_counts(tag, need):
    """The launch counts of the path just driven; every kernel in need
    must have launched."""
    c = kernels.counts()
    require(all(c[name] > 0 for name in need), f"{tag}: a kernel of the path never launched {c}")
    log(f"  {tag}: launches {c}")
    return c


def oracle_checksum(idx):
    """Iteration checksum from the oracle's kmers in id order: the sum mod
    2^32 of the XOR of each kmer's u32 words."""
    words = K.kmers_to_u32(oracle.access(idx, np.arange(idx.num_kmers)), idx.k)
    return int(np.bitwise_xor.reduce(words, axis=1).astype(np.uint64).sum()) & 0xFFFFFFFF


def positives(idx, rng, B):
    """B random ids and their kmers, the first half reverse-complemented."""
    ids = rng.integers(0, idx.num_kmers, B)
    km = oracle.access(idx, ids)
    km[: B // 2] = K.revcomp_kmers(km[: B // 2], idx.k)
    return ids, km


def check_oracle(eng, idx, km_pos, rng, tag):
    """The engine's host lookup equals the oracle in every field on a
    sample of positives and random negatives."""
    q = np.concatenate([km_pos, synthetic.random_kmers(idx.k, rng, len(km_pos))])
    t0 = time.perf_counter()
    got = eng.lookup(q)
    want = oracle.lookup(idx, q)
    for key in want:
        require(np.array_equal(got[key], want[key]), f"{tag}: {key} differs from the oracle")
    n_pos = int((got["kmer_id"][: len(km_pos)] != INVALID).sum())
    n_neg = int((got["kmer_id"][len(km_pos):] != INVALID).sum())
    log(f"  {tag}: oracle equal on {len(q)} lanes in all {len(want)} fields "
        f"(positives found {n_pos}/{len(km_pos)}, negatives found {n_neg}, "
        f"{time.perf_counter() - t0:.1f} s)")
    return q


def round_trip(eng, ids, km, tag):
    kt = eng.kmers32(km)
    res = eng.lookup_ids_device(kt)
    want = torch.from_numpy(ids.astype(np.int32)).to(kt.device)
    ok = bool((res["kmer_id"] == want).all())
    require(ok, f"{tag}: an id did not round-trip")
    log(f"  {tag}: all {len(ids)} ids round-trip")
    return kt


def table_line(eng, idx):
    tb = eng.table_bytes()
    return ", ".join(f"{group} {n} bytes = {n / idx.num_kmers:.3f} B/kmer"
                     for group, n in tb.items() if n)


def build(tag, **kw):
    t0 = time.perf_counter()
    idx = synthetic.build_index(**kw)
    t1 = time.perf_counter()
    host = device_arrays(idx)
    t2 = time.perf_counter()
    status = np.bincount(decode_codeword(idx.codewords)[0], minlength=3)
    log(f"  {tag}: {idx.num_kmers} kmers, build {t1 - t0:.1f} s, tables {t2 - t1:.1f} s, "
        f"buckets singleton/mid/heavy {status.tolist()}")
    return idx, host


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] card: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    path, secs, out = kernels.build()
    kernels.library()
    lines = out.splitlines()
    log(f"[2] build: nvcc sm_90a, {len(kernels.SOURCES)} sources in parallel -> {path.name} "
        f"in {secs:.1f} s")
    for i, ln in enumerate(lines):
        if "registers" in ln:
            entry = next((x for x in reversed(lines[:i]) if "entry function" in x), "")
            log(f"  ptxas: {entry.split(chr(39))[1] if chr(39) in entry else ''}: {ln.strip()}")
    spills = [ln.strip() for ln in lines if "spill" in ln and " 0 bytes spill stores" not in ln]
    log(f"  spills: {spills or 'none'}")


def point_queries_equal_plain(eng, idx, rng, errs):
    """Access, iteration, weight and neighbour variants, kernel == plain and
    == the oracle, on a small index. Returns the access row form."""
    cfg, t, dev = eng.cfg, eng.tables, eng.device
    n = idx.num_kmers
    ids = np.concatenate([np.arange(n), rng.integers(0, 1 << 32, 4096)])
    it = id_tensor(ids, dev)
    pairs = {"access_kernel": (E.access(cfg, t, it), E.access_plain(cfg, t, it)),
             "iterate_kernel": (E.iterate(cfg.k, t["strings32"], t["vstart32"]),
                                E.iterate_plain(cfg.k, t["strings32"], t["vstart32"]))}
    km = oracle.access(idx, ids[:n])
    kt = kmer_tensor(km, cfg.k, dev)
    pairs["neighbours_kernel"] = (P.neighbour_variants(kt, cfg.k),
                                  P.neighbour_variants_plain(kt, cfg.k))
    if cfg.weighted:
        pairs["weight_kernel"] = (E.weight(t, it), E.weight_plain(t, it))
        require(np.array_equal(eng.weight(ids[:n]), idx.weights.weight(ids[:n])),
                "weight != index.weights")
    for name, (got, want) in pairs.items():
        err = max_abs_err([got], [want])
        errs[name] = max(errs[name], err)
        require(err == 0, f"{name}: kernel != plain")
    require(torch.equal(pairs["access_kernel"][0][:n], kmer_tensor(km, cfg.k, dev)),
            "access != oracle")
    require(int(pairs["iterate_kernel"][0][0]) == n, "iteration count != num_kmers")
    return "windowed" if acc_windowed(cfg.k, cfg.access_C) else "two-round"


def phase_kernels_equal_plain(dev, errs):
    log("[3] kernel == plain on the card")
    forms = set()
    rng = np.random.default_rng(3)
    for k, m in ((31, 17), (31, 21), (63, 25)):
        km = synthetic.random_kmers(k, rng, SAMPLE)
        kt = torch.from_numpy(K.kmers_to_u32(km, k).view(np.int32)).to(dev)
        magic = int(rng.integers(0, 1 << 63))
        for both in (False, True):
            got = P.minimizer(kt, k, m, magic, both)
            want = P.minimizer_plain(kt, k, m, magic, both)
            err = max_abs_err(got, want)
            errs["minimizer_kernel"] = max(errs["minimizer_kernel"], err)
            require(err == 0, f"minimizer k{k} m{m} both={both}: kernel != plain")
        log(f"  minimizer_kernel k{k} m{m} B={SAMPLE}: equal (both strands and forward)")
    for name in sorted(synthetic.SMALL_CONFIGS):
        idx = synthetic.small_index(name)
        eng = TorchEngine(idx, dev)
        cfg = eng.cfg
        q, _ = synthetic.query_batch(idx)
        kt = eng.kmers32(q)
        mv, mp, rc, mv_r, mp_r = P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True)
        args = (rc, *canonical_fold(mv, mp, mv_r, mp_r)) if cfg.canonical else (None, mv, mp, None)
        active = torch.from_numpy(rng.random(len(q)) < 0.9).to(dev)
        for fields in ("full", "ids"):
            got = probe(cfg, eng.tables, kt, *args, active, fields)
            want = probe_plain(cfg, eng.tables, kt, *args, active, fields)
            require(got.keys() == want.keys(), f"probe {name}: fields differ")
            err = max_abs_err([got[key] for key in want], list(want.values()))
            errs["probe_kernel"] = max(errs["probe_kernel"], err)
            require(err == 0, f"probe {name} {fields}: kernel != plain")
        want = oracle.lookup(idx, q)
        got = eng.lookup(q)
        for key in want:
            require(np.array_equal(got[key], want[key]), f"{name}: {key} != oracle")
        log(f"  probe_kernel {name} (B={len(q)}, c1={cfg.c1_in_row}, skew={cfg.has_skew}, "
            f"partitioned={cfg.mphf_partitioned}): equal to plain (full, ids) and oracle")
        form = point_queries_equal_plain(eng, idx, rng, errs)
        forms.add(form)
        log(f"  access ({form}, C={cfg.access_C}), iterate, "
            f"{'weight, ' if cfg.weighted else ''}neighbours {name}: equal to plain and oracle")
    require(forms == {"windowed", "two-round"}, f"access forms run: {forms}")


def phase_main(dev):
    log("[4] main path: 5M kmers k31 m17, B=2^23, 50% RC")
    rng = np.random.default_rng(4)
    built = {}
    for mode in ("regular", "canonical"):
        idx, host = build(mode, k=31, m=17, canonical=mode == "canonical",
                          num_strings=MAIN_STRINGS, string_len=STRING_LEN, seed=40,
                          threads=8)
        eng = TorchEngine(idx, dev, host_arrs=host)
        ids, km = positives(idx, rng, MAIN_B)
        built[mode] = (idx, eng, ids, km)
    kernels.reset_counts()
    for mode, (idx, eng, ids, km) in built.items():
        round_trip(eng, ids, km, mode)
        check_oracle(eng, idx, km[MAIN_B // 2 - SAMPLE // 4: MAIN_B // 2 + SAMPLE // 4], rng,
                     mode)
    launches = path_counts("main path (lookup)", ("minimizer_kernel", "probe_kernel"))
    for mode, (idx, eng, ids, km) in built.items():
        log(f"  {mode}: tables on the card: {table_line(eng, idx)}")
        time_lookup(eng, eng.kmers32(km), mode)
    return launches, built


def phase_paths(dev):
    log("[5] heavy and sweep paths: 1M kmers k31 m13, planted m-mers")
    rng = np.random.default_rng(5)
    # 4 heavy buckets (> 2^MIN_L = 64 super-kmers) and 64 mid buckets of 3..40
    planted = [100, 150, 200, 300] + [3, 4, 5, 8, 10, 20, 30, 40] * 8
    for mode in ("regular", "canonical"):
        idx, host = build(mode, k=31, m=13, canonical=mode == "canonical",
                          num_strings=PATH_STRINGS, string_len=STRING_LEN, seed=50,
                          planted=planted)
        eng = TorchEngine(idx, dev, host_arrs=host)
        ids = np.concatenate([rng.integers(0, idx.num_kmers, SAMPLE // 4),
                              synthetic.path_kmer_ids(idx, rng, SAMPLE // 4)])
        km = oracle.access(idx, ids)
        # the bucket each positive probes: its (canonical) minimizer's
        mv, _ = oracle.compute_minimizer(km, idx.k, idx.m, np.uint64(eng.cfg.magic))
        if idx.canonical:
            mr, _ = oracle.compute_minimizer(K.revcomp_kmers(km, idx.k), idx.k, idx.m,
                                             np.uint64(eng.cfg.magic))
            mv = np.minimum(mv, mr)
        status, _, size, _ = oracle._decode_codewords(idx, mv)
        jmin = 2 if eng.cfg.c1_in_row else 1
        lanes = {"singleton": int((status == 0).sum()),
                 "in_row_candidate_1": int(((status == 1) & (size == 2)).sum()) if jmin == 2 else 0,
                 "mid_sweep": int(((status == 1) & (size > jmin)).sum()),
                 "heavy_skew": int((status == 2).sum())}
        log(f"  {mode}: lanes per path {lanes} (c1_in_row={eng.cfg.c1_in_row})")
        require(lanes["heavy_skew"] > 0 and lanes["mid_sweep"] > 0, "a path got no lanes")
        km[::2] = K.revcomp_kmers(km[::2], idx.k)
        round_trip(eng, ids, km, mode)
        check_oracle(eng, idx, km, rng, mode)


def phase_scale(dev):
    log("[6] scale: 200M kmers k31 m21 canonical, B=2^24, 50% RC")
    rng = np.random.default_rng(6)
    torch.cuda.reset_peak_memory_stats()
    idx, host = build("canonical", k=31, m=21, canonical=True, num_strings=SCALE_STRINGS,
                      string_len=STRING_LEN, seed=60, threads=8)
    t0 = time.perf_counter()
    eng = TorchEngine(idx, dev, host_arrs=host)
    torch.cuda.synchronize()
    del host
    log(f"  tables on the card: {table_line(eng, idx)} "
        f"(upload {time.perf_counter() - t0:.1f} s), c1_in_row={eng.cfg.c1_in_row}")
    ids, km = positives(idx, rng, SCALE_B)
    kt = round_trip(eng, ids, km, "canonical")
    check_oracle(eng, idx, km[SCALE_B // 2 - SAMPLE // 4: SCALE_B // 2 + SAMPLE // 4], rng,
                 "canonical")
    del km
    cfg = eng.cfg
    lookup = time_lookup(eng, kt, "canonical")
    mv, mp, rc, mv_r, mp_r = P.minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    mv1, mp1, mp2 = canonical_fold(mv, mp, mv_r, mp_r)
    got_p = probe(cfg, eng.tables, kt, rc, mv1, mp1, mp2, None, "ids")
    want_p = probe_plain(cfg, eng.tables, kt, rc, mv1, mp1, mp2, None, "ids")
    got_m = P.minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    want_m = P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True)
    errs = {"minimizer_kernel": max_abs_err(got_m, want_m),
            "probe_kernel": max_abs_err([got_p[key] for key in want_p], list(want_p.values()))}
    require(max(errs.values()) == 0, f"scale: kernel != plain {errs}")
    del got_p, want_p, got_m, want_m
    per_kernel = {
        "minimizer_kernel": (
            median_ms(lambda: P.minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)),
            median_ms(lambda: P.minimizer_plain(kt, cfg.k, cfg.m, cfg.magic, both=True))),
        "probe_kernel": (
            median_ms(lambda: probe(cfg, eng.tables, kt, rc, mv1, mp1, mp2, None, "ids")),
            median_ms(lambda: probe_plain(cfg, eng.tables, kt, rc, mv1, mp1, mp2, None, "ids"))),
    }
    for name, (ms, pms) in per_kernel.items():
        log(f"  {name} at B={SCALE_B}: {ms:.4f} ms, plain {pms:.4f} ms")
    glue = lookup["kernel"] - sum(ms for ms, _ in per_kernel.values())
    log(f"  lookup (ids) {lookup['kernel']:.4f} ms = kernels "
        f"{lookup['kernel'] - glue:.4f} ms + fold glue and gaps {glue:.4f} ms (by difference)")
    log(f"  peak device memory: {torch.cuda.max_memory_allocated()} bytes")
    return per_kernel, errs, idx, eng


def drive_access(eng, idx, ids, tag, errs, sample=None):
    """The access path on ids: kernel launches counted, every lane equal to
    the oracle (or a sample of them), every kmer looks up to its id, and
    kernel == plain on every lane. Returns the path's counts."""
    dev = eng.device
    it = id_tensor(ids, dev)
    kernels.reset_counts()
    acc = eng.access_device(it)
    round_trip = bool((eng.lookup_ids_device(acc)["kmer_id"] == it).all())
    c = path_counts(f"{tag} access path", ("access_kernel", "minimizer_kernel", "probe_kernel"))
    require(round_trip, f"{tag}: an accessed kmer did not look up to its id")
    lanes = np.arange(len(ids)) if sample is None else sample
    want = kmer_tensor(oracle.access(idx, ids[lanes]), idx.k, dev)
    require(torch.equal(acc[torch.from_numpy(lanes).to(dev)], want), f"{tag}: access != oracle")
    err = max_abs_err([acc], [E.access_plain(eng.cfg, eng.tables, it)])
    errs["access_kernel"] = max(errs["access_kernel"], err)
    require(err == 0, f"{tag}: access kernel != plain")
    form = "windowed" if acc_windowed(idx.k, eng.cfg.access_C) else "two-round"
    log(f"  {tag}: access ({form}, C={eng.cfg.access_C}) of {len(ids)} ids equals the oracle on "
        f"{len(lanes)} lanes and round-trips through lookup on all; kernel == plain")
    return c


def drive_iterator(eng, idx, tag, errs, checksum=None):
    """The iteration path: count == num_kmers (checksum == the oracle's when
    given), kernel == plain. Returns the path's counts."""
    kernels.reset_counts()
    count, chk = eng.iterator()
    c = path_counts(f"{tag} iteration path", ("iterate_kernel",))
    require(count == idx.num_kmers, f"{tag}: iteration count {count} != {idx.num_kmers}")
    if checksum is not None:
        require(chk == checksum, f"{tag}: iteration checksum {chk} != oracle {checksum}")
    t = eng.tables
    err = max_abs_err([eng.iterator_device()],
                      [E.iterate_plain(eng.cfg.k, t["strings32"], t["vstart32"])])
    errs["iterate_kernel"] = max(errs["iterate_kernel"], err)
    require(err == 0, f"{tag}: iterate kernel != plain")
    log(f"  {tag}: iteration count {count} = num_kmers, checksum {chk}"
        f"{' = oracle' if checksum is not None else ''}; kernel == plain")
    return c


def time_access_iteration(eng, idx, ids, tag):
    it, t, k = id_tensor(ids, eng.device), eng.tables, eng.cfg.k
    acc = time_turns(tag, "access", len(ids), lambda: eng.access_device(it),
                     lambda: E.access_plain(eng.cfg, t, it))
    itr = time_turns(tag, "iteration", idx.num_kmers, eng.iterator_device,
                     lambda: E.iterate_plain(k, t["strings32"], t["vstart32"]))
    return acc, itr


def add_counts(total, c):
    for name, v in c.items():
        total[name] = total.get(name, 0) + v


def phase_point_queries(dev, built, errs):
    log("[7] access, iteration, weight, navigation: 5M kmers k31 m17, B=2^23 "
        "(navigation 2^20 kmers)")
    rng = np.random.default_rng(7)
    launches, per_kernel = {}, {}
    for mode, (idx, eng, _, _) in built.items():
        ids = rng.integers(0, idx.num_kmers, MAIN_B)
        add_counts(launches, drive_access(eng, idx, ids, mode, errs))
        add_counts(launches, drive_iterator(eng, idx, mode, errs, oracle_checksum(idx)))
        # navigation: 2^20 kmers, half reverse-complemented
        km = oracle.access(idx, ids[:NAV_B])
        km[::2] = K.revcomp_kmers(km[::2], idx.k)
        kt = eng.kmers32(km)
        kernels.reset_counts()
        res = eng.kmer_neighbours_device(kt)
        add_counts(launches, path_counts(f"{mode} navigation path",
                                         ("neighbours_kernel", "minimizer_kernel",
                                          "probe_kernel")))
        lanes = np.sort(rng.choice(NAV_B, NAV_SAMPLE, replace=False))
        sel = torch.from_numpy(lanes).to(dev)
        got = _neighbours_to_host({key: v[sel] for key, v in res.items()})
        ref = Dictionary(idx).kmer_neighbours(km[lanes])
        for side, cols in (("forward", slice(0, 4)), ("backward", slice(4, 8))):
            for key, v in ref[side].items():
                require(np.array_equal(got[key][:, cols], v), f"{mode}: neighbours {side} {key}")
        err = max_abs_err([P.neighbour_variants(kt, idx.k)], [P.neighbour_variants_plain(kt, idx.k)])
        errs["neighbours_kernel"] = max(errs["neighbours_kernel"], err)
        require(err == 0, f"{mode}: neighbours kernel != plain")
        found = int((got["kmer_id"] != INVALID).sum())
        log(f"  {mode}: navigation of {NAV_B} kmers equals Dictionary.kmer_neighbours on "
            f"{NAV_SAMPLE} of them in all {len(got)} fields ({found} of {8 * NAV_SAMPLE} "
            f"neighbours found); variants kernel == plain")
        time_access_iteration(eng, idx, ids, mode)
        plain_nav = make_neighbours(eng.cfg, "full", variants=P.neighbour_variants_plain,
                                    minimizer=P.minimizer_plain, probe=probe_plain)
        time_turns(mode, "navigation (8 lookups)", NAV_B,
                   lambda: eng.kmer_neighbours_device(kt), lambda: plain_nav(eng.tables, kt))
        per_kernel["neighbours_kernel"] = time_turns(
            mode, "neighbour variants alone", NAV_B, lambda: P.neighbour_variants(kt, idx.k),
            lambda: P.neighbour_variants_plain(kt, idx.k))
    idx, host = build("weighted regular", k=31, m=17, canonical=False, num_strings=MAIN_STRINGS,
                      string_len=STRING_LEN, seed=41, threads=8,
                      weights=synthetic.ECOLI_SAKAI_MEAN_RUN)
    eng = TorchEngine(idx, dev, host_arrs=host)
    log(f"  weighted: {len(idx.weights.interval_value_ids)} weight runs (mean "
        f"{synthetic.ECOLI_SAKAI_MEAN_RUN} kmers), {len(idx.weights.dictionary)} distinct "
        f"weights; tables on the card: {table_line(eng, idx)}")
    ids = rng.integers(0, idx.num_kmers, MAIN_B)
    it = id_tensor(ids, dev)
    kernels.reset_counts()
    w = eng.weight_device(it)
    add_counts(launches, path_counts("weighted weight path", ("weight_kernel",)))
    want = idx.weights.weight(ids)
    require(torch.equal(w, id_tensor(want, dev)), "weight != index.weights")
    require(np.array_equal(eng.weight(ids[:SAMPLE]), want[:SAMPLE]),
            "TorchEngine.weight != index.weights")
    err = max_abs_err([w], [E.weight_plain(eng.tables, it)])
    errs["weight_kernel"] = max(errs["weight_kernel"], err)
    require(err == 0, "weight kernel != plain")
    log(f"  weighted: weight of {MAIN_B} ids equals index.weights on every lane "
        f"(uint64 through TorchEngine.weight on {SAMPLE}); kernel == plain")
    per_kernel["weight_kernel"] = time_turns("weighted", "weight", MAIN_B,
                                             lambda: eng.weight_device(it),
                                             lambda: E.weight_plain(eng.tables, it))
    return launches, per_kernel


def phase_scale_point_queries(idx, eng, errs):
    log("[8] access and iteration at scale: 200M kmers k31 m21 canonical, B=2^24")
    rng = np.random.default_rng(8)
    ids = rng.integers(0, idx.num_kmers, SCALE_B)
    launches = {}
    add_counts(launches, drive_access(eng, idx, ids, "canonical", errs,
                                      sample=np.sort(rng.choice(SCALE_B, SAMPLE, replace=False))))
    add_counts(launches, drive_iterator(eng, idx, "canonical", errs))
    acc, itr = time_access_iteration(eng, idx, ids, "canonical")
    log(f"  peak device memory: {torch.cuda.max_memory_allocated()} bytes")
    return launches, {"access_kernel": acc, "iterate_kernel": itr}


def main():
    smi = phase_card()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    errs = {name: 0 for name in kernels.counts()}
    phase_kernels_equal_plain(dev, errs)
    launches, built = phase_main(dev)
    phase_paths(dev)
    per_kernel, scale_errs, idx, eng = phase_scale(dev)
    times = {name: {"kernel": ms, "plain": pms} for name, (ms, pms) in per_kernel.items()}
    for name, err in scale_errs.items():
        errs[name] = max(errs[name], err)
    point_launches, point_times = phase_point_queries(dev, built, errs)
    del built
    scale_launches, scale_times = phase_scale_point_queries(idx, eng, errs)
    del idx, eng
    for name in ("access_kernel", "iterate_kernel", "weight_kernel", "neighbours_kernel"):
        launches[name] = point_launches.get(name, 0) + scale_launches.get(name, 0)
    times.update(point_times)
    times.update(scale_times)
    csrc = "sshash_tpu_torch/csrc/"
    sources = {"minimizer_kernel": ("minimizer.cu", "sshash_tpu/ops/packed.py:263"),
               "probe_kernel": ("probe.cu", "sshash_tpu/engine.py:739"),
               "access_kernel": ("access.cu", "sshash_tpu/engine.py:1304"),
               "iterate_kernel": ("iterator.cu", "sshash_tpu/engine.py:1338"),
               "weight_kernel": ("weight.cu", "sshash_tpu/engine.py:1404"),
               "neighbours_kernel": ("neighbours.cu", "sshash_tpu/engine.py:1412")}
    require(all(launches[name] > 0 for name in sources), f"launches {launches}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                    or m.startswith(("sshash_tpu.engine", "sshash_tpu.ops")))
    require(not loaded, f"JAX modules were imported: {loaded}")
    log(f"[9] done in {time.perf_counter() - t0:.0f} s; card: {smi}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["kernel"], "plain_ms": times[name]["plain"]}
        for name, (src, rep) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
