#!/usr/bin/env python3
"""Time an earlier tree's scan and stream-derivation kernels
(csrc/scan.cu, csrc/stream_derive.cu) and its whole stream step against
this tree's, in turns on one card (chip_smoke.py's timing: CUDA events
around windows of calls, median of 7, sides run backwards then forwards;
every side's calls replay from a CUDA graph, as they take microseconds).

    python3 stream_ab.py --baseline DIR [--strings 1000] [--chunks high-hit,low-hit]
                         [--stages]

DIR is an unpacked earlier tree (`git archive <commit> | tar -x -C DIR`),
for instance under .chip_scratch/ (gitignored). Sides:

  tree         this tree's kernel library (kernels.build)
  fill_memset  this tree's scan.cu with the compaction's zero fill as a
               memset of its output before the kernel (the tree writes the
               zeros from the kernel, once the last tile has its total)
  rank_stores  this tree's scan.cu with each lane storing the ranks of its
               own vector's flags (the tree ranks a warp's 512 flags in 16
               ballot rounds, so set lanes store side by side)
  scan_vecs2   this tree's scan.cu at 2 vectors of 16 bytes a thread (tiles
               of 2048 int32 and 8192 flags; the tree's 4)
  round2_vecs4 this tree's stream_derive.cu with round 2 at 4 vectors of 16
               ranks a thread (tiles of 16384 ranks; the tree's 2)
  count16      this tree's stream_derive.cu with the count kernel at 16
               lanes a thread a pass (the tree's 8)
  baseline     DIR's own package, loaded under another name, with its own
               kernel library built from its csrc: its step and its stages

The variants are built from their two sources alone (nvcc for sm_90a
into build/stream_ab/) and serve those entries; every other entry of the
step runs from this tree's library. Chunks: the first 2^22-position chunk
of a 168-string high-hit genome against phase 7's 100M k31 m21 canonical
build (--strings strings of 100,030 chars; few misses), and the first
chunk of phase 10's low-hit reads (100,000 of 76 chars, 10 cut from the
index, 1% with an N) on phase 4's 5M k31 m17 regular build (the run-skip
on, misses near P). On each chunk every side's step equals the tree's
and its stages' outputs equal the tree's stage by stage, checked before
timing; then, in turns, each side's scan.cu calls, its stream_derive.cu
calls (each source's calls of one step replayed together) and its whole
step, and with --stages each stage of the tree's step (the baseline's
stage of the same name and rank beside it), STAGE_CALLS calls of it
replayed from one graph. Prints the card, each side's
registers and spills (ptxas) and the ms of each side.
"""

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import torch

from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch import streaming as ST

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "sshash_tpu_torch" / "csrc"
OUT = ROOT / "build" / "stream_ab"
# the stages of the two sources, and the C entries they serve
SOURCE_OF = {"scan": "scan.cu", "compact": "scan.cu", "heads": "stream_derive.cu",
             "round2": "stream_derive.cu", "merge": "stream_derive.cu",
             "count": "stream_derive.cu"}
# a stage's calls back to back in one graph when timed alone: one call
# replayed alone costs about as much in graph launch as on the card
STAGE_CALLS = 10
ENTRIES = ("sshash_scan", "sshash_scan_scratch", "sshash_compact", "sshash_stream_heads",
           "sshash_stream_round2", "sshash_round2_scratch", "sshash_stream_merge",
           "sshash_stream_count")


# the compaction's first design: each lane stores the ranks of its own
# vector's flags (a warp's store instruction touches 32 lines)
RANK_STORES = r'''        uint32_t rank = ex[i];
        const uint32_t w[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          for (uint32_t m = nonzero_bytes(w[q]); m; m &= m - 1)
            out[rank++] = (int32_t)(e0 + 4 * q + (__ffs(m) >> 3) - 1);
        }
'''


def patch(src, old, new):
    if old not in src:
        raise RuntimeError(f"not found in the source: {old}")
    return src.replace(old, new)


def variant_sources():
    """{side: directory of its patched sources}."""
    scan, derive = ((CSRC / n).read_text() for n in ("scan.cu", "stream_derive.cu"))
    sides = {
        "fill_memset": {
            "scan.cu": patch(patch(scan, "  if (!COMPACT) return;\n", "  return;\n"),
                             "  if (err != cudaSuccess) return err;\n  if (blocks > ntiles)",
                             "  if (err == cudaSuccess && COMPACT)\n"
                             "    err = cudaMemsetAsync(out, 0, 4 * n, stream);\n"
                             "  if (err != cudaSuccess) return err;\n  if (blocks > ntiles)"),
            "stream_derive.cu": derive},
        "rank_stores": {"scan.cu": patch(scan, "        compact_row(x[i], ex[i], e0, out);\n",
                                         RANK_STORES),
                        "stream_derive.cu": derive},
        "scan_vecs2": {"scan.cu": patch(scan, "constexpr int kScanVecs = 4;",
                                        "constexpr int kScanVecs = 2;"),
                       "stream_derive.cu": derive},
        "round2_vecs4": {"scan.cu": scan,
                         "stream_derive.cu": patch(derive, "constexpr int kRound2Vecs = 2;",
                                                   "constexpr int kRound2Vecs = 4;")},
        "count16": {"scan.cu": scan,
                    "stream_derive.cu": patch(derive, "constexpr int kCountLanes = 8;",
                                              "constexpr int kCountLanes = 16;")},
    }
    dirs = {}
    for side, files in sides.items():
        d = OUT / side
        d.mkdir(parents=True, exist_ok=True)
        for name, text in files.items():
            (d / name).write_text(text)
        dirs[side] = d
    return dirs


def ptxas_lines(side, log):
    """Registers and spills of the scan and derive kernels in nvcc's
    -Xptxas -v log (empty when the library was built earlier)."""
    lines, out = log.splitlines(), []
    for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
        m = re.search(r"Function properties for _ZN6sshash\d+(scan_kernel|heads_kernel|"
                      r"round2_kernel|merge_kernel|count_kernel)(?:ILb([01])E)?", ln)
        if m and re.search(r"Used \d+ registers", reg):
            out.append(f"{side} {m.group(1)}{'<' + m.group(2) + '>' if m.group(2) else ''}: "
                       f"{re.search(r'Used \d+ registers', reg).group(0)}, {nxt.strip()}")
    return out


def load_baseline(root):
    """DIR's sshash_tpu_torch as the package `baseline_sshash_tpu_torch`
    (its modules import each other relatively): (streaming, kernels)."""
    name, pkg = "baseline_sshash_tpu_torch", Path(root) / "sshash_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".streaming"),
            importlib.import_module(name + ".kernels"))


class Mixed:
    """A kernel library whose scan and derive entries come from a variant
    and every other entry from the tree's."""

    def __init__(self, tree, variant):
        self.tree, self.variant = tree, variant
        for name in ENTRIES:
            fn, ref = getattr(variant, name), getattr(tree, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRIES else self.tree, name)


def build(baseline_kernels):
    """The tree's library, DIR's and each variant's two sources, all nvcc
    processes started together. Returns ({side: library}, ptxas lines)."""
    nvcc = kernels._nvcc()
    jobs = {}
    for side, d in variant_sources().items():
        for src in ("scan.cu", "stream_derive.cu"):
            obj = OUT / f"{side}_{src}.o"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                   str(d / src), "-o", str(obj)]
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
    objs = {}
    for (side, obj), proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{side}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
        regs += ptxas_lines(side, out)
        objs.setdefault(side, []).append(str(obj))
    for side, o in objs.items():
        so = OUT / f"lib{side}.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), *o], check=True)
        libs[side] = Mixed(libs["tree"], ctypes.CDLL(str(so)))
    return libs, regs


@contextlib.contextmanager
def using(lib):
    """The tree's kernel wrappers launch through lib while inside."""
    saved, kernels._lib = kernels._lib, lib
    try:
        yield
    finally:
        kernels._lib = saved


def recorded_step(st, cfg, P, R, CW, av):
    """st's step (st: a streaming module) with its stage calls recorded:
    (step, calls); calls gets (stage, args, output) on each run."""
    calls = []

    def wrap(name, fn):
        def f(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, a, out))
            return out
        return f

    ops = st.KERNEL_OPS
    ops = ops._replace(**{n: wrap(n, getattr(ops, n)) for n in ops._fields})
    lookup = st.make_lookup(cfg, "full")
    return st.make_stream_step(cfg, P, R, CW, lookup, all_valid=av, ops=ops), calls


def _values(x):
    """A stage's output as a list of int64 tensors (flags as 0/1)."""
    if isinstance(x, dict):
        return [x[key].to(torch.int64) for key in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [t.to(torch.int64) for t in x]
    return [(x != 0).to(torch.int64) if x.dtype in (torch.bool, torch.uint8)
            else x.to(torch.int64)]


def stage_outputs(calls):
    """{(stage, its k-th call): values} of the two sources' stages."""
    out, seen = {}, {}
    for name, _, o in calls:
        if name in SOURCE_OF:
            i = seen[name] = seen.get(name, -1) + 1
            out[(name, i)] = _values(o)
    return out


def compare_chunk(tag, sides, eng, packed, P, R, CW, av, stages=False):
    """Every side's step and stages on one chunk equal the tree's; then the
    two sources, each stage when `stages`, and the whole step in turns."""
    runs = {}
    for side, (st, lib) in sides.items():
        with using(lib):
            step, calls = recorded_step(st, eng.cfg, P, R, CW, av)
            out = step(eng.tables, packed)
        runs[side] = (step, calls, out)
    _, calls, ref = runs["tree"]
    want = stage_outputs(calls)
    for side, (_, calls, out) in runs.items():
        S.require(S.rows_equal(out, ref), f"{tag}: the {side} step != the tree's")
        got = stage_outputs(calls)
        for key, v in want.items():
            S.require(key in got and all(torch.equal(a, b) for a, b in zip(got[key], v)),
                      f"{tag}: {side} stage {key} != the tree's")
    counts = {side: {src: sum(SOURCE_OF.get(n) == src for n, _, _ in r[1])
                     for src in ("scan.cu", "stream_derive.cu")} for side, r in runs.items()}
    n_need = [int(o[1][0]) for n, _, o in runs["tree"][1] if n == "compact"][0]
    S.log(f"  {tag}: every side's step and stages equal the tree's ({', '.join(sides)}); "
          f"misses {n_need} of P {P}; calls a step {counts}")

    def source_fn(side, src):
        st, lib = sides[side]
        sel = [(getattr(st.KERNEL_OPS, n), a) for n, a, _ in runs[side][1]
               if SOURCE_OF.get(n) == src]

        def run():
            with using(lib):
                for fn, a in sel:
                    fn(*a)
        return run

    def step_fn(side):
        step, lib = runs[side][0], sides[side][1]

        def run():
            with using(lib):
                runs[side][1].clear()
                step(eng.tables, packed)
        return run

    def stage_fn(side, key):
        st, lib = sides[side]
        name, k = key
        fn = getattr(st.KERNEL_OPS, name)
        a = [a for n, a, _ in runs[side][1] if n == name][k]

        def run():
            with using(lib):
                for _ in range(STAGE_CALLS):
                    fn(*a)
        return run

    graph = tuple(sides)
    for src in ("scan.cu", "stream_derive.cu"):
        S.time_sides(tag, src, P, {side: source_fn(side, src) for side in sides}, unit="lane",
                     graph=graph)
    if stages:
        for key in want:
            fns = {side: stage_fn(side, key) for side in sides}
            S.time_sides(tag, f"stage {key[0]} #{key[1]}, {STAGE_CALLS} calls", P * STAGE_CALLS,
                         fns, unit="lane", graph=graph)
    S.time_sides(tag, "the step", P, {side: step_fn(side) for side in sides}, unit="lane",
                 graph=graph)


def first_chunk(eng, path, multiline):
    st = ST._DeviceStream(eng, eng.cfg.k, pmax=1 << 22, rmax_shift=12 if multiline else 4)
    st.capture = []
    for seq in ST.parse_reads(path, multiline=multiline):
        st.add_read(seq)
    st.finalize()
    av, packed = st.capture[0]
    return packed, st.P, st.R, st.CW, av


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="an unpacked earlier tree")
    ap.add_argument("--strings", type=int, default=S.SCALE_STRINGS)
    ap.add_argument("--chunks", default="high-hit,low-hit",
                    help="the chunks to run, of high-hit and low-hit")
    ap.add_argument("--stages", action="store_true", help="also time each stage in turns")
    a = ap.parse_args()
    chunks = a.chunks.split(",")
    S.phase_card()
    dev = torch.device("cuda", 0)
    base_st, base_kernels = load_baseline(a.baseline)
    libs, regs = build(base_kernels)
    for ln in regs:
        S.log(f"  ptxas {ln}")
    # the baseline's wrappers launch through its own library (its side swaps
    # nothing in this tree's)
    sides = {name: (ST, lib) for name, lib in libs.items() if name != "baseline"}
    sides["baseline"] = (base_st, libs["tree"])
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as tmp:
        if "high-hit" in chunks:
            high_hit(a, sides, dev, rng, tmp)
        if "low-hit" in chunks:
            low_hit(a, sides, dev, rng, tmp)
    S.log(f"card: {torch.cuda.get_device_name(0)}")


def high_hit(a, sides, dev, rng, tmp):
    """The first chunk of a 168-string genome against the 100M build."""
    idx, host = S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                        string_len=S.STRING_LEN, seed=60, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    del host
    strings = synthetic.index_strings(idx, rng.choice(idx.num_strings, S.SCALE_STREAM_STRINGS,
                                                      replace=False))
    path = os.path.join(tmp, "genome.fa")
    synthetic.write_genome(path, strings, rng)
    chunk = first_chunk(eng, path, True)
    compare_chunk(f"100M high-hit chunk (P={chunk[1]})", sides, eng, *chunk, stages=a.stages)
    del eng, idx, chunk
    torch.cuda.empty_cache()


def low_hit(a, sides, dev, rng, tmp):
    """The first chunk of phase 10's low-hit reads on the 5M regular build."""
    idx, host = S.build("regular", k=31, m=17, canonical=False, num_strings=S.MAIN_STRINGS,
                        string_len=S.STRING_LEN, seed=40, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    strings = synthetic.index_strings(idx)
    reads = synthetic.cut_reads(strings, S.LOWHIT_TRUE, S.LOWHIT_LEN, rng)
    reads += synthetic.random_reads(S.LOWHIT_READS - S.LOWHIT_TRUE, S.LOWHIT_LEN, rng)
    reads = synthetic.with_n([reads[i] for i in rng.permutation(len(reads))], 0.01, rng)
    path = os.path.join(tmp, "lowhit.fq")
    synthetic.write_reads(path, reads)
    chunk = first_chunk(eng, path, False)
    compare_chunk(f"low-hit 5M chunk (P={chunk[1]})", sides, eng, *chunk, stages=a.stages)


if __name__ == "__main__":
    sys.exit(main())
