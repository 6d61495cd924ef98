#!/usr/bin/env python3
"""Time an earlier tree's weight, neighbours and K7 read kernels
(csrc/weight.cu, csrc/neighbours.cu, csrc/read_at2.cu) against this
tree's, in turns on one card
(chip_smoke.py's timing: CUDA events around windows of calls, median of
7, sides run backwards then forwards; every side replays from a CUDA
graph, as its calls take tens of microseconds).

    python3 point_ab.py --baseline DIR

DIR is an unpacked earlier tree (`git archive <commit> | tar -x -C DIR`),
for instance under .chip_scratch/ (gitignored). Sides:

  tree         this tree's kernel library (kernels.build)
  no_table     this tree's weight.cu with its bucket table built but not
               read: the steps span the whole sample (a plain branchless
               binary search over it)
  buckets2048  ... with a bucket table of at most 2,048 buckets (the
               tree's 8,192): a smaller table, more steps
  sample32768  ... with a sample of fewer than 32,768 entries (the tree's
               16,384): fewer steps in global memory past the stage
  one_blocks2  ... with launch bounds for 2 blocks of 512 an SM in the
               one-level form (the tree's 3: at most 64 registers, not 40)
  one_ids4     ... with 4 ids a thread in flight in the one-level form
               (the tree's 3)
  two_ids4     ... with 4 ids a thread in flight in the two-level form
               (the tree's 1)
  two_blocks3  ... with launch bounds for 3 blocks an SM in the two-level
               form (the tree's 2)
  words1       this tree's neighbours.cu with its 16-byte vector kernel off:
               one word a thread at every size (the tree takes four
               consecutive words a thread where B * W is a multiple of 4)
  at2_row_stores  this tree's read_at2.cu with each kmer row stored a
               thread a row, word by word, W words at a stride of 4W bytes
               (packed.cuh's store_rows patched; the tree stores rows of 1,
               2, 4 and 8 words as vectors and stages the others in shared
               memory)
  at2_column_reads  this tree's read_at2.cu reading the table's word
               column at a stride of 8 bytes and each offset's bits apart
               (the tree reads the first row as one 8-byte pair, word and
               bits together, and the next rows' words from their pairs)
  baseline     DIR's own package, loaded under another name, with its own
               kernel library built from its csrc

Each variant is built from its one source (nvcc for sm_90a into
build/point_ab/) and serves that source's entries; every other entry
runs from this tree's library, so the weight variants appear in the
weight cases, words1 in the neighbour cases and the at2_ sides in K7's.
Cases, all on synthetic tables and kmers (no index build):

  weight at 4,307 runs over ids [0, 5M) (the count of chip_smoke's
  weighted 5M build; Zipf values), 2^23 random ids; at 2^20 runs over
  [0, 2^31 - 1) (past the stage: both levels of the search); one shard
  of 4 of the 4,307-run tables (the JAX ShardedEngine's split) on the
  random ids and on them sorted, beside the unsharded weight of the tree
  and of DIR on the same ids; the neighbour variants at k31, k65 and
  k129 on 2^20 random kmers; K7 at k31, k65 and k129 over a random
  interleaved table of the 100M k31 index's 6,251,875 words (k31) or
  the 60M k65 index's 3,752,400 (k65, k129), 2^23 random offsets. Each
  side's output equals the tree's (and the tree's its plain version)
  before it is timed. Prints the card, each side's registers and spills
  (ptxas) and the ms of each side.
"""

import argparse
import ctypes
import importlib
import importlib.util
import re
import subprocess
import sys
import threading
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import torch
from stream_ab import ROW_STORES, STAGED, sub

from sshash_tpu_torch import engine as E
from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch import kmer as K
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel.sharded import split_weight_runs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "sshash_tpu_torch" / "csrc"
OUT = ROOT / "build" / "point_ab"
# read_at2.cu's reads of a lane's table rows: the first row's word and
# bits as one 8-byte pair and the next rows' words from their pairs (the
# tree), and the word column read at a stride of 8 bytes, the bits apart
AT2_COLUMN_READS = """    uint32_t g[W + 1];
#pragma unroll
    for (int j = 0; j <= W; ++j)
      g[j] = j <= nw ? table[2 * (w0 + j < last ? w0 + j : last)] : 0u;
    const uint32_t bits = table[2 * (w0 < last ? w0 : last) + 1];
"""
AT2_PAIR_READ = """    const uint2* pairs = reinterpret_cast<const uint2*>(table);
    const uint2 first = pairs[w0 < last ? w0 : last];
    uint32_t g[W + 1];
    g[0] = first.x;
#pragma unroll
    for (int j = 1; j <= W; ++j) g[j] = j <= nw ? pairs[w0 + j < last ? w0 + j : last].x : 0u;
    const uint32_t bits = first.y;
"""

# a source's variants: side -> (source, [(the tree's text, the side's)])
VARIANTS = {
    "no_table": ("weight.cu", [("  const int steps = 32 - __clz(fullest);",
                                "  const int steps = 32 - __clz(ns);"),
                               ("      c[q] = lut[x];\n      end[q] = lut[x + 1];",
                                "      c[q] = 0;\n      end[q] = ns;")]),
    "buckets2048": ("weight.cu", [("constexpr int kWeightBuckets = 8192;",
                                   "constexpr int kWeightBuckets = 2048;")]),
    "sample32768": ("weight.cu", [("constexpr int kWeightSample = 16384;",
                                   "constexpr int kWeightSample = 32768;")]),
    "one_blocks2": ("weight.cu", [("kWeightBlocksOne = 3;", "kWeightBlocksOne = 2;")]),
    "one_ids4": ("weight.cu", [("kWeightIdsOne = 3,", "kWeightIdsOne = 4,")]),
    "two_ids4": ("weight.cu", [("kWeightIdsTwo = 1,", "kWeightIdsTwo = 4,")]),
    "two_blocks3": ("weight.cu", [("kWeightBlocksTwo = 2;", "kWeightBlocksTwo = 3;")]),
    "words1": ("neighbours.cu", [("  if (n % 4 == 0 &&", "  if (false &&")]),
    "at2_row_stores": ("read_at2.cu", []),
    "at2_column_reads": ("read_at2.cu", [(AT2_PAIR_READ, AT2_COLUMN_READS)]),
}
# variants that also patch a header, written beside their source
HEADER_VARIANTS = {"at2_row_stores": ("packed.cuh", STAGED, ROW_STORES)}
ENTRIES = {"weight.cu": ("sshash_weight", "sshash_weight_plan"),
           "neighbours.cu": ("sshash_neighbours",), "read_at2.cu": ("sshash_read_at2",)}
WEIGHT_RUNS, WEIGHT_KMERS = 4307, 5_000_000
PAST_RUNS, PAST_SPAN = 1 << 20, (1 << 31) - 1
NAV_KS = (31, 65, 129)
# K7's tables: the strings32 words of chip_smoke's 100M k31 build (1,000
# strings of 100,030 chars) and of its 60M k65 build (600 of 100,064)
AT2_ROWS = {31: 6_251_875, 65: 3_752_400, 129: 3_752_400}


def ptxas_lines(side, log):
    """Registers and spills of the weight, neighbours and K7 kernels in nvcc's
    -Xptxas -v log (empty when the library was built earlier); <0> and <1>
    are the weight kernel's one- and two-level forms."""
    lines, out = log.splitlines(), []
    for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
        m = re.search(r"Function properties for _ZN6sshash\d+(weight_kernel|neighbours_kernel|"
                      r"neighbours_vec4_kernel|read_at2_kernel)(?:IL[bi](\d+)E)?", ln)
        if m and re.search(r"Used \d+ registers", reg):
            out.append(f"{side} {m.group(1)}{'<' + m.group(2) + '>' if m.group(2) else ''}: "
                       f"{re.search(r'Used \d+ registers', reg).group(0)}, {nxt.strip()}")
    return out


def load_baseline(root):
    """DIR's sshash_tpu_torch as the package `baseline_sshash_tpu_torch`
    (its modules import each other relatively): its kernels module."""
    name, pkg = "baseline_sshash_tpu_torch", Path(root) / "sshash_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".kernels")


class Mixed:
    """A kernel library whose entries of one source come from a variant and
    every other entry from the tree's."""

    def __init__(self, tree, variant, entries):
        self.tree, self.variant, self.entries = tree, variant, entries
        for name in entries:
            fn, ref = getattr(variant, name), getattr(tree, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype

    def __getattr__(self, name):
        return getattr(self.variant if name in self.entries else self.tree, name)


def build(baseline_kernels):
    """The tree's library, DIR's and each variant's source, all nvcc
    processes started together. Returns ({side: library}, ptxas lines)."""
    nvcc = kernels._nvcc()
    jobs = {}
    for side, (name, patches) in VARIANTS.items():
        src = (CSRC / name).read_text()
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"{side}: not found in {name}: {old}")
            src = src.replace(old, new)
        d = OUT / side
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_text(src)
        if side in HEADER_VARIANTS:
            header, old, new = HEADER_VARIANTS[side]
            (d / header).write_text(sub(old, new, (CSRC / header).read_text()))
        obj = OUT / f"{side}.o"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
               str(d / name), "-o", str(obj)]
        jobs[(side, obj)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)
    base = {}
    t = threading.Thread(target=lambda: base.setdefault("log", baseline_kernels.build()[2]))
    t.start()
    tree_log = kernels.build()[2]
    t.join()
    if "log" not in base:
        raise RuntimeError("the baseline's kernels did not build")
    libs = {"tree": kernels.library(), "baseline": baseline_kernels.library()}
    regs = ptxas_lines("tree", tree_log) + ptxas_lines("baseline", base["log"])
    for (side, obj), proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{side}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
        regs += ptxas_lines(side, out)
        so = OUT / f"lib{side}.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(obj)],
                       check=True)
        libs[side] = Mixed(libs["tree"], ctypes.CDLL(str(so)), ENTRIES[VARIANTS[side][0]])
    return libs, regs


def through(lib, fn):
    """fn with the tree's kernel wrappers launching through lib."""
    def run():
        saved, kernels._lib = kernels._lib, lib
        try:
            return fn()
        finally:
            kernels._lib = saved
    return run


def checked(fns, want, tag):
    """The sides of fns whose output equals want; a side that raises is
    logged and left out (the others still run)."""
    out = {}
    for side, fn in fns.items():
        try:
            got = fn()
        except RuntimeError as e:
            S.log(f"  {tag}: {side} raised, left out: {e}")
            continue
        S.require(all(torch.equal(g, w) for g, w in zip(_tuple(got), _tuple(want))),
                  f"{tag}: {side} != the tree")
        out[side] = fn
    return out


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare(tag, n, fns):
    """Every side's output equals the tree's; then the sides in turns, and
    each side's median over the baseline's."""
    fns = checked(fns, fns["tree"](), tag)
    S.log(f"  {tag}: every side equals the tree ({', '.join(fns)})")
    ms = S.time_sides(tag, "", n, fns, unit="item", graph=tuple(fns))
    for side in fns:
        if side != "baseline":
            S.log(f"  {tag}: {side} / baseline = {ms[side] / ms['baseline']:.4f}")
    return ms


def on_card(host, dev):
    return {key: S.id_tensor(v, dev) for key, v in host.items()}


def variant_sides(libs, source, tree):
    """{side: tree through the side's library} for the variants of source."""
    return {side: through(libs[side], tree) for side, (name, _) in VARIANTS.items()
            if name == source}


def weight_sides(libs, base, tables, ids, owned=False, variants=True):
    fns = {"tree": lambda: kernels.weight_kernel(tables, ids, owned)}
    if variants:
        fns.update(variant_sides(libs, "weight.cu", fns["tree"]))
    fns["baseline"] = lambda: base.weight_kernel(tables, ids, owned)
    return fns


def weight_cases(libs, base, dev, rng):
    host = synthetic.weight_tables(WEIGHT_RUNS, WEIGHT_KMERS, rng)
    t = on_card(host, dev)
    ids = S.id_tensor(rng.integers(0, WEIGHT_KMERS, S.MAIN_B), dev)
    S.require(torch.equal(kernels.weight_kernel(t, ids), E.weight_plain(t, ids)),
              "weight kernel != plain")
    compare(f"weight, {WEIGHT_RUNS} runs", S.MAIN_B, weight_sides(libs, base, t, ids))
    past = on_card(synthetic.weight_tables(PAST_RUNS, PAST_SPAN, rng), dev)
    pids = S.id_tensor(rng.integers(0, PAST_SPAN, S.MAIN_B), dev)
    S.require(torch.equal(kernels.weight_kernel(past, pids), E.weight_plain(past, pids)),
              "weight kernel != plain past the stage")
    compare(f"weight, {PAST_RUNS} runs", S.MAIN_B, weight_sides(libs, base, past, pids))
    del past, pids
    # one shard of 4 against the unsharded weight, on random and sorted ids
    eps, vids = split_weight_runs(host["w_endpoints"], host["w_value_ids"], 4)
    n_ep, n_iv = len(eps) // 4, len(vids) // 4
    shard = on_card({"w_endpoints": eps[n_ep: 2 * n_ep], "w_value_ids": vids[n_iv: 2 * n_iv],
                     "w_dictionary": host["w_dictionary"]}, dev)
    for order, ids_ in (("random", ids), ("sorted", ids.sort().values)):
        tag = f"weight, shard 1 of 4, {order} ids"
        fns = checked(weight_sides(libs, base, shard, ids_, owned=True),
                      E.weight_plain(shard, ids_, owned=True), tag)
        whole = checked(weight_sides(libs, base, t, ids_, variants=False),
                        E.weight_plain(t, ids_), tag + ", unsharded")
        # the shard and the unsharded weight in the same turns
        fns.update({f"{side}, unsharded": fn for side, fn in whole.items()})
        ms = S.time_sides(tag, "", S.MAIN_B, fns, unit="item", graph=tuple(fns))
        for side in fns:
            if side != "baseline" and "unsharded" not in side:
                S.log(f"  {tag}: {side} / baseline = {ms[side] / ms['baseline']:.4f}")
        for side in ("tree", "baseline"):
            S.log(f"  {tag}: {side} one shard / unsharded "
                  f"{ms[side] / ms[side + ', unsharded']:.4f}")


def neighbour_cases(libs, base, dev, rng):
    for k in NAV_KS:
        km = synthetic.random_kmers(k, rng, S.NAV_B)
        kt = torch.from_numpy(np.ascontiguousarray(K.kmers_to_u32(km, k)).view(np.int32)).to(dev)
        S.require(torch.equal(kernels.neighbours_kernel(kt, k), P.neighbour_variants_plain(kt, k)),
                  f"k{k}: neighbours kernel != plain")
        fns = {"tree": lambda: kernels.neighbours_kernel(kt, k)}
        fns.update(variant_sides(libs, "neighbours.cu", fns["tree"]))
        fns["baseline"] = lambda: base.neighbours_kernel(kt, k)
        compare(f"variants, k{k} (W={kt.shape[1]})", S.NAV_B, fns)


def read_at2_cases(libs, base, dev, rng):
    for k, n in AT2_ROWS.items():
        table = S.id_tensor(rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64), dev)
        ot = S.id_tensor(rng.integers(0, 16 * n, S.MAIN_B), dev)
        got, want = kernels.read_at2_kernel(table, ot, k), P.read_kmers_at2_plain(table, ot, k)
        S.require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"k{k}: read_at2 kernel != plain")
        fns = {"tree": lambda: kernels.read_at2_kernel(table, ot, k)}
        fns.update(variant_sides(libs, "read_at2.cu", fns["tree"]))
        fns["baseline"] = lambda: base.read_at2_kernel(table, ot, k)
        compare(f"read_kmers_at2, k{k} (W={P.num_words32(k)}), {n} rows", S.MAIN_B, fns)
        del table, ot, got, want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="an unpacked earlier tree")
    a = ap.parse_args()
    S.phase_card()
    dev = torch.device("cuda", 0)
    base = load_baseline(a.baseline)
    libs, regs = build(base)
    for ln in regs:
        S.log(f"  ptxas {ln}")
    rng = np.random.default_rng(10)
    weight_cases(libs, base, dev, rng)
    neighbour_cases(libs, base, dev, rng)
    read_at2_cases(libs, base, dev, rng)
    S.log(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    sys.exit(main())
