"""Sweep the minimizer length m and report space/time trade-offs
(reference script/sweep-m.py + plot-trade-off-m.py, as json lines): one
build per m, each row's space from info.space_breakdown. Host-only: it
never loads torch.

Usage: python -m sshash_tpu_torch.tools.sweep_m -i input.fa.gz -k 31 [--m-values 13,15,17,19]
"""

import argparse
import json
import time


def rows(input_path, k, ms, canonical):
    """Yield one row a value of m, in order."""
    from ..builder.build import BuildConfig
    from ..dictionary import Dictionary
    from ..info import space_breakdown

    for m in ms:
        t0 = time.perf_counter()
        d = Dictionary.build(input_path, BuildConfig(k=k, m=m, canonical=canonical,
                                                     verbose=False))
        build_s = time.perf_counter() - t0
        n = d.num_kmers()
        yield {
            "k": k, "m": m, "canonical": canonical,
            "num_kmers": n,
            "num_minimizers": d.index.num_minimizers,
            "max_bucket_size": d.index.stats.get("max_bucket_size"),
            "bits_per_kmer": round(sum(space_breakdown(d.index).values()) / n, 4),
            "build_sec": round(build_s, 2),
        }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sshash_tpu_torch.tools.sweep_m")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("--m-values", default=None,
                    help="comma-separated; default k-18..k-8 step 2, clipped >= 7")
    ap.add_argument("--canonical", action="store_true")
    args = ap.parse_args(argv)

    if args.m_values:
        ms = [int(x) for x in args.m_values.split(",")]
    else:
        ms = list(range(max(7, args.k - 18), args.k - 7, 2))
    for row in rows(args.input, args.k, ms, args.canonical):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
