"""Sweep the skew-index threshold MIN_L and report space/time trade-offs
(reference script/sweep-min-l.py:34-70, which edits constants.hpp and
recompiles). Here constants.py reads SSHASH_MIN_L and SSHASH_MAX_L once,
at import, so each l runs in a fresh child process with MIN_L = l and
MAX_L = l + 7. The children import only this package and never torch.

Usage: python -m sshash_tpu_torch.tools.sweep_min_l -i input.fa.gz -k 31 -m 15 [--l-values 4,6,8]
Prints one json line per l; a child that fails prints
{"min_l": l, "error": the end of its stderr}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the directory that holds the package, for the children's import path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = ("import json, sys\n"
          "from sshash_tpu_torch.tools.sweep_min_l import measure\n"
          "print(json.dumps(measure(*json.loads(sys.argv[1]))))\n")


def measure(input_path, k, m, canonical):
    """One row at the MIN_L and MAX_L this process read at import."""
    from ..builder.build import BuildConfig
    from ..constants import MAX_L, MIN_L
    from ..dictionary import Dictionary
    from ..info import space_breakdown

    t0 = time.perf_counter()
    d = Dictionary.build(input_path, BuildConfig(k=k, m=m, canonical=canonical, verbose=False))
    build_s = time.perf_counter() - t0
    parts = space_breakdown(d.index)
    n = d.num_kmers()
    return {
        "min_l": MIN_L, "max_l": MAX_L, "k": k, "m": m,
        "num_kmers": n,
        "num_heavy_partitions": d.index.stats.get("num_partitions", 0),
        "num_heavy_positions": int(len(d.index.heavy_load_buckets)),
        "bits_per_kmer": round(sum(parts.values()) / n, 4),
        "skew_bits_per_kmer": round(parts.get("skew_index", 0) / n, 4),
        "build_sec": round(build_s, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sshash_tpu_torch.tools.sweep_min_l")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-m", type=int, default=15)
    ap.add_argument("--l-values", default="4,6,8,10")
    ap.add_argument("--canonical", action="store_true")
    args = ap.parse_args(argv)

    spec = json.dumps([args.input, args.k, args.m, args.canonical])
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    for l in (int(x) for x in args.l_values.split(",")):
        env = dict(os.environ, SSHASH_MIN_L=str(l), SSHASH_MAX_L=str(l + 7), PYTHONPATH=path)
        out = subprocess.run([sys.executable, "-c", _CHILD, spec], env=env,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(json.dumps({"min_l": l, "error": out.stderr.strip()[-500:]}), flush=True)
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
