"""CLI multiplexer: build | query | check | bench | permute
(reference tools/sshash.cpp:76-105 and tools/{build,query,permute}.cpp).

Usage: python -m sshash_tpu_torch <subcommand> [flags]

query, check and bench run on the card unless --device cpu (the plain
PyTorch versions) or --host (the NumPy host engine) is given.
"""

import argparse
import json
import time

import numpy as np


def _add_build(sub):
    p = sub.add_parser("build", help="build an index from FASTA/cf_seg (tools/build.cpp)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-k", type=int, required=True)
    p.add_argument("-m", type=int, required=True)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output", default=None,
                   help="serialize index here: *.npz = compressed single file;"
                        " any other path = directory of raw .npy arrays,"
                        " loaded zero-copy via mmap (the reference's --mmap)")
    p.add_argument("--canonical", action="store_true")
    p.add_argument("--weighted", action="store_true")
    p.add_argument("--check", action="store_true", help="run the full check suite after building")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("-g", "--ram-mb", type=int, default=None,
                   help="RAM budget (MB) -> out-of-core build with tuple "
                        "spills (the reference's -g GiB flag)")
    p.add_argument("-d", "--tmp-dir", default=None,
                   help="spill directory for the out-of-core build "
                        "(the reference's -d flag)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="builder worker threads (the reference's -t flag); "
                        "results are bit-identical at any count")
    p.add_argument("-a", "--lmbda", type=float, default=None,
                   help="pilot-search lambda = avg bucket load (the "
                        "reference's -a flag; default constants.LAMBDA)")
    p.add_argument("--scan-procs", type=int, default=1,
                   help="shard the minimizer-tuple scan over N worker "
                        "PROCESSES spilling to a shared dir (multi-host "
                        "analog; bit-identical at any count)")
    p.add_argument("--scan-dir", default=None,
                   help="assemble from a directory ALREADY spilled by "
                        "--scan-procs ranks of the worker CLI "
                        "(python -m sshash_tpu_torch.builder.distributed)")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default: the card; cpu runs the "
                        "kernels' plain PyTorch versions)")


def _add_query(sub):
    p = sub.add_parser("query", help="streaming membership queries (tools/query.cpp)")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-q", "--query", required=True, help="FASTA/FASTQ file, optionally .gz")
    p.add_argument("--multiline", action="store_true")
    p.add_argument("--host", action="store_true",
                   help="use the NumPy host engine instead of the device engine")
    _add_device(p)


def _add_check(sub):
    p = sub.add_parser("check", help="exhaustive self-consistency checks (test/check.hpp)")
    p.add_argument("-i", "--index", required=True)
    _add_device(p)


def _add_bench(sub):
    p = sub.add_parser("bench", help="perf test lookup/access/iterator (tools/perf.hpp)")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("--batch", type=int, default=1 << 20)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--host", action="store_true", help="bench the NumPy host engine instead")
    _add_device(p)


def _add_permute(sub):
    p = sub.add_parser("permute", help="weight-run minimizing permutation (tools/permute.cpp)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-k", type=int, required=True)
    p.add_argument("-o", "--output", required=True, help="permuted FASTA output path")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sshash-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for add in (_add_build, _add_query, _add_check, _add_bench, _add_permute):
        add(sub)
    args = ap.parse_args(argv)
    return {
        "build": _build,
        "query": _query,
        "check": _check,
        "bench": _bench,
        "permute": _permute,
    }[args.cmd](args)


def _build(args):
    from ..builder.build import BuildConfig
    from ..constants import SEED
    from ..dictionary import Dictionary

    cfg = BuildConfig(k=args.k, m=args.m, seed=args.seed if args.seed is not None else SEED,
                      canonical=args.canonical, weighted=args.weighted, verbose=args.verbose,
                      ram_limit_mb=args.ram_mb, tmp_dir=args.tmp_dir,
                      threads=args.threads, lmbda=args.lmbda,
                      scan_procs=args.scan_procs, scan_dir=args.scan_dir)
    d = Dictionary.build(args.input, cfg)
    d.print_info()
    if args.check:
        from ..check import check_all

        check_all(d, verbose=args.verbose)
        print("check: OK")
    if args.output:
        d.save(args.output)
        print(f"saved index to {args.output}")
    return 0


def _query(args):
    from ..dictionary import Dictionary
    from ..streaming import host_report, streaming_query_from_file

    d = Dictionary.load(args.index)
    if args.host:
        t0 = time.perf_counter()
        rep = host_report(d.index, args.query, multiline=args.multiline)
        rep["elapsed_millisec"] = (time.perf_counter() - t0) * 1e3
    else:
        rep = streaming_query_from_file(d, args.query, multiline=args.multiline,
                                        device=args.device)
    pos, tot = rep["num_positive_kmers"], max(1, rep["num_kmers"])
    print(f"num_kmers = {rep['num_kmers']}")
    print(f"num_positive_kmers = {pos} ({100.0 * pos / tot:.4g}%)")
    print(f"num_searches = {rep['num_searches']}/{pos}")
    print(f"num_extensions = {rep['num_extensions']}/{pos}")
    print(json.dumps(rep))
    return 0


def _check(args):
    from ..check import check_all
    from ..dictionary import Dictionary

    d = Dictionary.load(args.index)
    check_all(d, verbose=True, engine=d.to_device(args.device))
    print("check: OK")
    return 0


def _bench(args):
    """perf_test_lookup_access analog (tools/perf.hpp:9-157): random ids ->
    access -> 50% RC -> timed lookups (positive + negative) + access."""
    from .. import kmer as K
    from .. import oracle
    from ..dictionary import Dictionary

    d = Dictionary.load(args.index)
    index = d.index
    rng = np.random.default_rng(17)
    B = min(args.batch, index.num_kmers)
    ids = rng.integers(0, index.num_kmers, B)
    kmers = oracle.access(index, ids)
    kmers[: B // 2] = K.revcomp_kmers(kmers[: B // 2], index.k)
    neg = rng.integers(0, 1 << 62, (B, index.kmer_words64), dtype=np.uint64)
    rem = 2 * index.k - 64 * (index.kmer_words64 - 1)
    neg[:, -1] &= np.uint64(0xFFFFFFFFFFFFFFFF) if rem == 64 else np.uint64((1 << rem) - 1)

    rows = {}
    if args.host:
        run_l = lambda x: oracle.lookup(index, x)
        run_a = lambda i: oracle.access(index, i)
        sync = lambda r: r
        # host engines iterate by sequential-id access
        run_it, it_arg, it_n = run_a, np.arange(B), B
    else:
        import torch

        eng = d.to_device(args.device)
        kmers, neg, ids = eng.kmers32(kmers), eng.kmers32(neg), eng._ids(ids)
        run_l = eng.lookup_device
        run_a = eng.access_device

        def sync(r):
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            return r

        # iterator = the sequential-decode kernel over the WHOLE index (one
        # linear strings32 pass, reference perf_test_iterator tools/perf.hpp:
        # 10-24)
        run_it, it_arg, it_n = (lambda _: eng.iterator_device()), None, index.num_kmers

    axes = [("positive_lookup", run_l, kmers, B),
            ("negative_lookup", run_l, neg, B),
            ("access", run_a, ids, B),
            ("iterator", run_it, it_arg, it_n)]
    # lookup+weight (reference perf_test_lookup_weight, perf.hpp:110-155)
    if index.weights is not None:
        if args.host:
            def run_lw(x):
                r = oracle.lookup(index, x)
                kid = r["kmer_id"]
                ok = kid != np.uint64(0xFFFFFFFFFFFFFFFF)
                w = np.zeros(len(kid), dtype=np.uint64)
                w[ok] = index.weights.weight(kid[ok])
                return w
        else:
            run_lw = lambda x: eng.weight_device(eng.lookup_ids_device(x)["kmer_id"])
        axes.append(("positive_lookup_weight", run_lw, kmers, B))

    for name, fn, arg, n in axes:
        sync(fn(arg))  # warmup (the kernels' build on a card's first call)
        best = float("inf")
        for _ in range(args.runs):
            t0 = time.perf_counter()
            sync(fn(arg))
            best = min(best, time.perf_counter() - t0)
        rows[f"{name} (avg_nanosec_per_kmer)"] = best * 1e9 / n
    rows["batch"] = B
    print(json.dumps(rows))
    return 0


def _permute(args):
    from ..cover import permute_file

    stats = permute_file(args.input, args.k, args.output)
    print(json.dumps(stats))
    return 0
