"""End-to-end walkthrough of the reference README's examples (jermp/sshash,
§"Examples": build, query, check, permute) through the port's entry
points, with the steps and printed lines of scripts/demo.py. Every query
runs on `--device` through TorchEngine: the card by default, the kernels'
plain versions with --device cpu. With --device cuda and no card it
raises; no step falls back to the CPU.

Usage: python -m sshash_tpu_torch.tools.demo [--data DIR] [--device cuda|cpu] [--json PATH]

DIR holds the reference's data layout (INPUTS below, relative to DIR).
Each input absent there is replaced by a stand-in of its shape (STAND_INS),
written from a fixed seed into a temporary directory, and a line says so;
without --data every input is a stand-in. --json writes each step's values
(run's return) to PATH.
"""

import argparse
import gzip
import json
import os
import shutil
import tempfile
import time

import numpy as np

from .. import synthetic

INPUTS = {"unitigs": "unitigs_stitched/salmonella_enterica_k31_ust.fa.gz",
          "reads": "queries/SRR5833294.10K.fastq.gz",
          "weighted": "unitigs_stitched/with_weights/ecoli_sakai.ust.k31.fa.gz"}
STREAM_FIELDS = ("num_kmers", "num_positive_kmers", "num_searches", "num_extensions")


# The stand-ins' shapes: the unitigs, 5M k31 kmers in 50 strings (the JAX
# bench's salmonella configuration, bench.py:166-171); the reads, 10,000 of
# 76 chars (460,000 k31 kmers, as SRR5833294.10K: BASELINE.md:29), random,
# an N in 1% of them; the weighted unitigs, E. coli O157:H7 Sakai's shape
# (2,115 strings of 2,630 chars, weight runs of mean 945)
STAND_INS = {"unitigs": dict(num_strings=50, string_len=100_030, seed=41),
             "reads": dict(num_reads=10_000, read_len=76, n_frac=0.01, seed=42),
             "weighted": dict(num_strings=2115, string_len=2630, seed=43,
                              weights=synthetic.ECOLI_SAKAI_MEAN_RUN)}


def write_stand_in(name, path, shape):
    """Write input `name`'s stand-in of `shape` to path (gzipped); returns
    a line that describes it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plain = path[: -len(".gz")]
    if name == "reads":
        rng = np.random.default_rng(shape["seed"])
        reads = synthetic.with_n(synthetic.random_reads(shape["num_reads"], shape["read_len"],
                                                        rng), shape["n_frac"], rng)
        synthetic.write_reads(plain, reads)
        what = (f"{shape['num_reads']} random reads of {shape['read_len']} chars, an N in "
                f"{shape['n_frac']:.0%}")
    else:
        weights = shape.get("weights")
        synthetic.write_input(plain, k=31, m=13, canonical=False,
                              num_strings=shape["num_strings"], string_len=shape["string_len"],
                              seed=shape["seed"], weights=weights)
        what = (f"{shape['num_strings']} random strings of {shape['string_len']} chars"
                + (f", weight runs of mean {weights}" if weights else ""))
    with open(plain, "rb") as f, gzip.open(path, "wb", compresslevel=1) as g:
        shutil.copyfileobj(f, g)
    os.remove(plain)
    return f"stand-in for {INPUTS[name]}: {what} (seed {shape['seed']})"


def _require_device(device):
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA card (--device cpu runs the plain "
                           f"versions)")
    return device


def run(data=None, device="cuda", stand_ins=STAND_INS):
    """Run the walkthrough, printing scripts/demo.py's lines; returns each
    step's values and seconds."""
    from .. import kmer as K
    from ..builder.build import BuildConfig
    from ..check import check_all
    from ..cover import permute_file
    from ..dictionary import Dictionary
    from ..streaming import streaming_query_from_file

    device = _require_device(device)
    values, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, rel in INPUTS.items():
            paths[name] = os.path.join(data, rel) if data else None
            if paths[name] is None or not os.path.exists(paths[name]):
                paths[name] = os.path.join(tmp, rel)
                print(write_stand_in(name, paths[name], stand_ins[name]))

        t0 = time.perf_counter()
        print("== Example 1: build (salmonella k31 m13) ==")
        d = Dictionary.build(paths["unitigs"], BuildConfig(k=31, m=13, verbose=False))
        d.print_info()
        eng = d.to_device(device)
        values["num_kmers"] = d.num_kmers()
        secs["build"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        print("\n== Lookup / Access / Membership / Navigation ==")
        ids = np.array([0, 1, 12345, d.num_kmers() - 1])
        kmers = [K.kmer_to_string(km, d.k) for km in eng.access(ids)]
        print("access:", ids.tolist(), "->", kmers)
        packed = np.stack([K.string_to_kmer(s, d.k) for s in kmers])
        lookup_ids = eng.lookup(packed)["kmer_id"].tolist()
        print("lookup round-trip ids:", lookup_ids)
        member = eng.is_member(packed).tolist()
        print("is_member:", member)
        forward = eng.kmer_neighbours(packed[:1])["kmer_id"][0, :4].tolist()
        print("neighbours of kmer 0 (fwd ids):", forward)
        values.update(ids=ids.tolist(), kmers=kmers, lookup_ids=lookup_ids, is_member=member,
                      forward_neighbours=forward)
        secs["queries"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        print("\n== Example 2: streaming queries (SRR5833294.10K.fastq.gz) ==")
        rep = streaming_query_from_file(d, paths["reads"], device=device)
        print({key: rep[key] for key in STREAM_FIELDS})
        values["stream"] = {key: v for key, v in rep.items() if key != "elapsed_millisec"}
        secs["stream"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        print("\n== check (exhaustive self-consistency) ==")
        check_all(d, verbose=False, engine=eng)
        print("check: OK")
        values["check"] = True
        secs["check"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        print("\n== Example 4: permute (ecoli_sakai weighted) ==")
        out = os.path.join(tmp, "permuted.fa")
        stats = permute_file(paths["weighted"], 31, out)
        print(stats, "(reference README reports 5820 -> 3723)")
        values["permute"] = stats
        secs["permute"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        print("\n== weighted build on the permuted collection ==")
        dw = Dictionary.build(out, BuildConfig(k=31, m=13, weighted=True, verbose=False))
        weights = dw.to_device(device).weight(np.arange(8)).tolist()
        print("weights of first 8 kmers:", weights)
        values["weights"] = weights
        secs["weighted"] = time.perf_counter() - t0
        print("\nall good.")
    values["seconds"] = secs
    return values


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sshash_tpu_torch.tools.demo")
    ap.add_argument("--data", default=None,
                    help="directory in the reference's data layout (absent inputs: stand-ins)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default: the card; cpu runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--json", default=None, help="write each step's values here")
    args = ap.parse_args(argv)
    values = run(args.data, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(values, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
