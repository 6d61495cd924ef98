#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path, batched k-mer lookup, on one
NVIDIA card, and check it end to end.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the last
line):
  1. card: nvidia-smi name and power limit; no CUDA card -> exit 1
  2. build: nvcc builds csrc/ for sm_90a (timed, registers per kernel)
  3. kernel == plain on the card, exactly: kernel 1 at B = 2^20 for
     (k, m) in (31, 17), (31, 21), (63, 25); kernel 2 on every small
     configuration of synthetic.SMALL_CONFIGS, full and ids fields
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
  Times are device times from CUDA events around windows of back-to-back
  calls, median of 7 windows after a warm-up; kernel and plain run in turns.
  7. one JSON line of per-kernel results, then the ok line.

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

from sshash_tpu import kmer as K  # noqa: E402
from sshash_tpu import oracle  # noqa: E402
from sshash_tpu.index import decode_codeword  # noqa: E402
from sshash_tpu_torch import TorchEngine, kernels, synthetic  # noqa: E402
from sshash_tpu_torch.engine import canonical_fold, make_lookup, probe, probe_plain  # noqa: E402
from sshash_tpu_torch.layout import device_arrays  # noqa: E402
from sshash_tpu_torch.ops import packed as P  # noqa: E402

INVALID = np.uint64(2 ** 64 - 1)
REPS = 7
MAIN_B = 1 << 23
SCALE_B = 1 << 24
SAMPLE = 1 << 20
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


def time_lookup(eng, kt, tag):
    """lookup (ids) of the (B, W) kmers kt through the kernels and through
    the plain versions on the card, in turns plain, kernel, kernel, plain.
    Returns {side: median ms}."""
    plain = make_lookup(eng.cfg, "ids", minimizer=P.minimizer_plain, probe=probe_plain)
    fns = {"kernel": lambda: eng.lookup_ids_device(kt), "plain": lambda: plain(eng.tables, kt)}
    runs = {}
    for side in ("plain", "kernel", "kernel", "plain"):
        runs.setdefault(side, []).append(median_ms(fns[side]))
    B = kt.shape[0]
    out = {}
    for side, v in runs.items():
        out[side] = ms = float(np.median(v))
        log(f"  {tag}: lookup (ids) with {side} versions: {ms:.4f} ms per {B} lanes = "
            f"{ms * 1e6 / B:.4f} ns/kmer, {B / ms * 1e3:.4g} lookups/s "
            f"(runs {['%.4f' % x for x in v]})")
    return out


def max_abs_err(got, want):
    """Largest |kernel - plain| over matching tensors (0 when exact)."""
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def require(cond, what):
    if not cond:
        raise AssertionError(what)


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
    regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
    log(f"[2] build: nvcc sm_90a -> {path.name} in {secs:.1f} s")
    for ln in regs:
        log(f"  ptxas: {ln}")


def phase_kernels_equal_plain(dev, errs):
    log("[3] kernel == plain on the card")
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
    launches = kernels.counts()
    log(f"  launches in the main path: {launches}")
    require(all(n > 0 for n in launches.values()), "a kernel of the path never launched")
    for mode, (idx, eng, ids, km) in built.items():
        log(f"  {mode}: tables on the card {eng.table_bytes()} bytes = "
            f"{eng.table_bytes() / idx.num_kmers:.3f} B/kmer")
        time_lookup(eng, eng.kmers32(km), mode)
    return launches


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
    tb = eng.table_bytes()
    log(f"  tables on the card: {tb} bytes = {tb / idx.num_kmers:.3f} B/kmer "
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
    return per_kernel, errs


def main():
    smi = phase_card()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    errs = {"minimizer_kernel": 0, "probe_kernel": 0}
    phase_kernels_equal_plain(dev, errs)
    launches = phase_main(dev)
    phase_paths(dev)
    per_kernel, scale_errs = phase_scale(dev)
    sources = {"minimizer_kernel": ("sshash_tpu_torch/csrc/minimizer.cu",
                                    "sshash_tpu/ops/packed.py:263"),
               "probe_kernel": ("sshash_tpu_torch/csrc/probe.cu", "sshash_tpu/engine.py:739")}
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                    or m.startswith(("sshash_tpu.engine", "sshash_tpu.ops")))
    require(not loaded, f"JAX modules were imported: {loaded}")
    log(f"[7] done in {time.perf_counter() - t0:.0f} s; card: {smi}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": max(errs[name], scale_errs[name]),
         "ms": per_kernel[name][0], "plain_ms": per_kernel[name][1]}
        for name, (src, rep) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
