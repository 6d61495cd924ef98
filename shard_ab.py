#!/usr/bin/env python3
"""Time an earlier tree's bucket-sharded lookup against this tree's, and
this tree's kernel 2 shard form against its losing designs, in turns on
one card (chip_smoke.py's timing: CUDA events around windows of calls,
median of 7, sides run backwards then forwards; calls under a millisecond
replay from a CUDA graph).

    python3 shard_ab.py --baseline DIR [--strings 1000]
                        [--cells lookup100m,regular5m,handoff,lowhit,highhit100m,
                                 handoffstream]

DIR is an unpacked earlier tree (`git archive <commit> | tar -x -C DIR`),
for instance under .chip_scratch/ (gitignored). Sides:

  tree      this tree: on a LocalMesh, kernel 1 once a data row, then
            kernel 2's shard form on each shard, storing only the lanes it
            owns into the row's one set of result tensors (its warps queue
            their owned lanes and probe 32 together; the first shard stores
            each lane's MPHF slot, the others read it), the regular mode's
            RC round merged in place; no combine
  baseline  DIR's own package, loaded under another name, with its own
            kernel library built from its csrc: before this tree every
            shard stored every lane, and the mesh stacked the shards'
            packed results and took their min
  exit      this tree with kernel 2's shard form a thread a lane over a
            grid-stride loop on the same card-sized grid, each owned lane
            probed where it falls, the others exiting after their slot
            (probe.cu patched: the queue's loop replaced)
  simple    kernel 2's shard form in the shape of the whole-table kernel:
            one thread a lane on a grid of B threads, no launch bounds, no
            queue; a lane that the shard does not own returns after its
            slot test (probe.cu patched: its own kernel and launch)
  blocks4   this tree with kernel 2's shard form asking registers for 4
            blocks of 256 threads an SM (64 registers), not 3 (probe.cu
            patched)
  lane      (lookup100m only: canonical, no hand-off) no kernel 1: each
            shard runs the lookup kernel (kernel 1's walk, the fold and the
            probe in the thread, probe.cuh lookup_lane) over every lane and
            stores the lanes whose slot it owns (probe.cu and probe.cuh
            patched)
  list3     (the stream cells) the tree's rank form with its list probe at
            3 blocks of 256 an SM at every width (shard.cuh patched; the
            tree asks the lookup kernel's 4 where they fit)
  warpatomic (the stream cells) the tree's rank form with its list pass
            taking each warp's places in the list with one atomicAdd on the
            list's device count (shard.cuh patched; the tree sums a block's
            warps first, one atomicAdd a tile)

On the stream cells the baseline is the rank form's earlier design when DIR
is PR 17's tree (084b58f): no list pass, each shard's launch walking every
rank below the count with the shard form's warp queue.

A variant is built from its patched sources alone (probe.cu, or
lookup_ranks.cu for the list sides, with probe.cuh and shard.cuh; nvcc for sm_90a
into build/shard_ab/) and serves their entries; every other entry runs from
this tree's library. Cells, each on the sides that have it, every side's
result equal to the tree's before timing:
  lookup100m  phase 7's 100M k31 m21 canonical build in (1, 4): the lookup
              (ids) of 2^24 positives, half reverse-complemented; kernel 2
              on each shard (tree, exit, blocks4, baseline); the unsharded
              lookup, tree against DIR
  regular5m   phase 4's 5M k31 m17 regular build in (1, 4): the lookup (all
              fields) of 2^23 positives, half reverse-complemented, so the
              RC round runs on half the lanes
  handoff     phase 5's 1M k31 m13 regular build with planted m-mers, whose
              heavy buckets' rows are handed between shards, in (1, 4): the
              lookup (all fields) of 2^20 lanes, half of them drawn from
              the heavy and mid paths, half reverse-complemented
  lowhit      phase 10's low-hit reads on phase 4's 5M regular build: the
              (1, 4) ShardedStream's step on its first chunk, tree against
              DIR (this tree's stream runs kernel 2's rank form, which the
              exit and simple sides do not change)
  highhit100m phase 10's high-hit genome of 168 of the 100M build's strings
              (phase 7's build): the (1, 4) ShardedStream's step on its
              first chunk, tree against DIR
  handoffstream the handoff cell's index and reads cut from it (half RC,
              1% substitutions) and random reads: the (1, 4)
              ShardedStream's step on its first chunk, whose heavy misses
              take the hand-off's second pass, tree against DIR
  (the stream cells also run the list3 and warpatomic sides, and time the
  tree's first round launch by launch)
Prints the card, each side's registers and spills (ptxas), the ms of each
side and, for the stream cells, each side's launches in one step, the
chunk's misses and, for the tree, each round's list pass and list probes
timed alone from CUDA graphs beside the round's bound.
"""

import argparse
import ctypes
import functools
import os
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import stream_ab as SA
import torch

from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "sshash_tpu_torch" / "csrc"
OUT = ROOT / "build" / "shard_ab"
CELLS = ("lookup100m", "regular5m", "handoff", "lowhit", "highhit100m", "handoffstream")
# the stream cells' sides that run the tree's engine through their own library
LIB_SIDES = ("list3", "warpatomic")
# the stream cells' sides with engines of their own
ENGINE_SIDES = ("tree", "baseline")
# the 1M planted build's heavy and mid buckets (chip_smoke phase 5)
PLANTED = [100, 150, 200, 300] + [3, 4, 5, 8, 10, 20, 30, 40] * 8

QUEUED = ("  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);\n"
          "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n")
# side "exit": the grid-stride loop, a thread a lane, before the queue (the
# queue's code follows unreached)
GRID_STRIDE = """\
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p.B; i += 32 * warps) {
    uint32_t key[1];
    if (shard_owns<CANON, V2, 1>(t, p, io, i, 0, key))
      shard_lane<W, CANON, V2, false>(t, p, io, slot, i, key[0]);
  }
  return;
"""
# side "simple": the whole-table kernel's shape, its launch in launch_shard
LAUNCH = """\
  const int threads = shard_threads(p);
  const size_t smem = shard_smem(p, threads);
  int64_t blocks = 0;
  const cudaError_t err =
      pass_blocks(shard_probe_kernel<W, CANON, V2>, threads, per_sm, p.B, &blocks, smem);
  if (err != cudaSuccess) return err;
  shard_probe_kernel<W, CANON, V2><<<(unsigned)blocks, threads, smem, stream>>>(t, p, io);
"""
SIMPLE_LAUNCH = """\
  const int threads = stage_threads(p);
  const size_t smem = (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4;
  const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
  shard_simple_kernel<W, CANON, V2><<<blocks, threads, smem, stream>>>(t, p, io);
"""
BEFORE_LAUNCH = "// static: the occupancy cache passed in stays this library's\n"
SIMPLE_KERNEL = """\
template <int W, bool CANON, bool V2>
__global__ void shard_simple_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  uint32_t key[1];
  if (shard_owns<CANON, V2, 1>(t, p, io, i, 0, key))
    shard_lane<W, CANON, V2, false>(t, p, io, thread_slot(stage, p), i, key[0]);
}

"""
BOUNDS = ("__launch_bounds__(256, W > kMaxFixedW ? 1 : !CANON && W == 8 ? 2 : 3)\n"
          "    shard_probe_kernel")
# the lookup kernel on one shard: a lane of another shard's slot marks its
# result (orientation 0) and is not stored
UNOWNED = ("  if (s < p.slot_lo || s >= p.slot_hi) return Lane{false, true, Hit{false, 0, "
           "kForward, 0, 0, 0}};")
STORE = "  write_result<V2>(io, p, i, L, orient);\n}\n"
WHOLE = "p->store != kStoreAll || p->slot_lo != 0 || p->slot_hi != (1ll << 32))"
# side "list3": the list probe's launch bounds
LIST_BLOCKS = "canon && W >= 3 ? 3"
# side "warpatomic": each warp's places taken on the list's device count,
# no sum over the block's warps first
WARP_COUNT = "    if (lane == 0) warp_at[warp] = held;\n"
TILE_PLACE = re.compile(r"    if \(threadIdx\.x == 0\) \{  // the warps' places.*?\n    \}\n", re.S)


def variant_sources():
    """{side: (directory of its patched sources, its entries)}: each
    directory holds probe.cu, probe.cuh and shard.cuh (kernel 2's shard
    form), patched as the side asks, so that every include resolves to the
    side's own copy."""
    names = ("probe.cu", "probe.cuh", "shard.cuh", "lookup_ranks.cu")
    cu, cuh, sh, ranks = ((CSRC / n).read_text() for n in names)
    sides = {
        "exit": ({"shard.cuh": SA.patch(sh, QUEUED, QUEUED + GRID_STRIDE)}, ("sshash_probe",)),
        "simple": ({"shard.cuh": SA.patch(SA.patch(sh, LAUNCH, SIMPLE_LAUNCH), BEFORE_LAUNCH,
                                          SIMPLE_KERNEL + BEFORE_LAUNCH)}, ("sshash_probe",)),
        "blocks4": ({"shard.cuh": SA.patch(sh, BOUNDS, BOUNDS.replace(": 3)", ": 4)"))},
                    ("sshash_probe",)),
        "lane": ({"probe.cu": SA.patch(SA.patch(cu, STORE, "  if (L.res.orient != 0) "
                                                "write_result<V2>(io, p, i, L, orient);\n}\n"),
                                       WHOLE, "p->store != kStoreAll)"),
                  "probe.cuh": SA.patch(cuh, UNOWNED, UNOWNED.replace("kForward", "0"))},
                 ("sshash_lookup",)),
        "list3": ({"shard.cuh": SA.patch(sh, LIST_BLOCKS, "true ? 3"), "lookup_ranks.cu": ranks},
                  ("sshash_rank_lists", "sshash_probe_ranks")),
        "warpatomic": ({"shard.cuh": SA.sub(TILE_PLACE, "    if (threadIdx.x == 0) tile_at = 0;\n",
                                            SA.patch(sh, WARP_COUNT, WARP_COUNT.replace(
                                                "held;", "held ? atomicAdd(io.list_count, held) "
                                                ": 0;"))),
                        "lookup_ranks.cu": ranks},
                       ("sshash_rank_lists", "sshash_probe_ranks")),
    }
    dirs = {}
    for side, (files, entries) in sides.items():
        d = OUT / side
        d.mkdir(parents=True, exist_ok=True)
        for name, text in zip(names, (cu, cuh, sh, ranks)):
            (d / name).write_text(files.get(name, text))
        dirs[side] = (d, "lookup_ranks.cu" if "lookup_ranks.cu" in files else "probe.cu",
                      entries)
    return dirs


def ptxas_lines(side, log):
    """Registers and spills of kernel 2's shard form and the lookup kernel
    in nvcc's -Xptxas -v log."""
    lines, out = log.splitlines(), []
    for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
        if re.search(r"shard_(simple|probe|list)_kernel|13lookup_kernel|rank_list_kernel", ln) \
                and "Function properties" in ln and "Used" in reg \
                and re.search(r"ILi[1-8]E|ILb", ln):
            out.append(f"{side} {ln.split('for ')[-1].strip()[:60]}: {reg.strip()[:60]}, "
                       f"{nxt.strip()}")
    return out


def build(baseline_kernels):
    """The tree's library, DIR's and each variant's, all nvcc processes
    started together. Returns ({side: library}, ptxas lines)."""
    nvcc = kernels._nvcc()
    jobs = {}
    # each library's C++ names in a namespace of its own: one process loads
    # four libraries whose kernels would otherwise share their names
    baseline_kernels.NVCC_FLAGS = (*baseline_kernels.NVCC_FLAGS, "-Dsshash=sshash_baseline")
    for side, (d, src, entries) in variant_sources().items():
        obj = OUT / f"{side}_probe.o"
        cmd = [nvcc, *kernels.NVCC_FLAGS, f"-Dsshash=sshash_{side}", "-Xptxas", "-v", "-I",
               str(d), "-I", str(CSRC), "-c", str(d / src), "-o", str(obj)]
        jobs[side] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), obj, entries)
    base = {}
    t = threading.Thread(target=lambda: base.setdefault("log", baseline_kernels.build()[2]))
    t.start()
    tree_log = kernels.build()[2]
    t.join()
    if "log" not in base:
        raise RuntimeError("the baseline's kernels did not build")
    libs = {"tree": kernels.library(), "baseline": baseline_kernels.library()}
    regs = ptxas_lines("tree", tree_log) + ptxas_lines("baseline", base["log"])
    for side, (proc, obj, entries) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{side}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
        regs += ptxas_lines(side, out)
        so = OUT / f"lib{side}.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(obj)],
                       check=True)
        libs[side] = SA.Mixed(libs["tree"], ctypes.CDLL(str(so)), entries)
    return libs, regs


def diff(got, want):
    """The fields of got that differ from want's: {field: (lanes that
    differ, the first three as (lane, got, want))}."""
    out = {}
    for k in want:
        if k not in got or got[k].shape != want[k].shape:
            out[k] = ("missing or reshaped", None)
            continue
        bad = (got[k] != want[k]).nonzero()[:, 0]
        if len(bad):
            out[k] = (len(bad), [(int(i), int(got[k][i]), int(want[k][i])) for i in bad[:3]])
    return out


def same(got, want, tag):
    d = diff(got, want)
    S.require(got.keys() == want.keys() and not d,
              f"{tag}: a side's result differs from the tree's: {d}")


def lane_lookup(lib, seng, kt):
    """The lookup (ids) with no kernel 1: on each shard the patched lookup
    kernel over every lane, storing the lanes whose slot the shard owns."""
    cfg = seng.cfg
    out = seng._result_tensors(kt.shape[0], "ids")
    names = ("kmer_id", "kmer_orientation", "minimizer_found", "found")
    for j, sh in enumerate(seng.probe_shards):
        B, dev, tab, _, _ = kernels._probe_launch(cfg, seng.tables[j], kt, None, "ids", sh,
                                                  kernels.STORE_OWNED)
        prm = kernels.probe_params(cfg, B, "ids", sh)
        io = kernels.ProbeIO(kmers=kt.data_ptr(), **{n: out[n].data_ptr() for n in names})
        err = lib.sshash_lookup(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                                kernels._stream(dev))
        S.require(err == 0, f"lane side: CUDA error {err}")
    out.pop("slot", None)
    return out


def lookup_sides(tag, n, libs, seng, bseng, kt, fields, graph=(), extra=None, ref=None):
    """The sharded lookup of every side on kt (its device path, the row's
    lookup function: no report), equal to the tree's, then in turns."""
    tree, blookup = seng._lookup_fn(0, fields), bseng._lookup_fn(0, fields)
    fns = {"tree": lambda: tree(None, kt), "baseline": lambda: blookup(None, kt)}

    def under(side):
        def run():
            with SA.using(libs[side]):
                return tree(None, kt)
        return run

    for side in ("exit", "simple", "blocks4"):
        fns[side] = under(side)
    fns.update(extra or {})
    want = fns["tree"]()
    if ref is not None:
        same(want, ref, f"{tag} tree against the unsharded engine")
    for side, fn in fns.items():
        same(fn(), want, f"{tag} {side}")
    S.log(f"  {tag}: every side's lookup equals the tree's ({', '.join(fns)}); "
          f"{int(want['found'].sum())} of {n} found")
    return S.time_sides(tag, f"the (1, 4) sharded lookup ({fields})", n, fns, graph=graph)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="an unpacked earlier tree")
    ap.add_argument("--strings", type=int, default=S.SCALE_STRINGS)
    ap.add_argument("--cells", default=",".join(CELLS), help=f"the cells to run, of {CELLS}")
    a = ap.parse_args()
    S.phase_card()
    dev = torch.device("cuda", 0)
    base = SA.load_baseline(a.baseline)
    libs, regs = build(base.kernels)
    for ln in regs:
        S.log(f"  ptxas {ln}")
    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory() as tmp:
        for cell in CELLS:
            if cell in a.cells.split(","):
                globals()[cell](a, libs, base, dev, rng, tmp)
    S.log(f"card: {torch.cuda.get_device_name(0)}")


def engines(idx, host, base, dev):
    """The (1, 4) engines of this tree and DIR on one index and table dict.
    DIR's engine takes this tree's StaticCfg: DIR's reads the index's MPHF
    forms by its own classes, which this tree's Index does not hold (a
    partitioned MPHF would read as plain)."""
    seng = ShardedEngine(idx, LocalMesh((1, 4), dev), host_arrs=host)
    bseng = base.parallel.ShardedEngine(idx, base.parallel.LocalMesh((1, 4), dev), host_arrs=host)
    bseng.cfg = seng.cfg
    for j in range(4):
        S.require(all(torch.equal(seng.tables[j][k], bseng.tables[j][k]) for k in seng.tables[j]),
                  f"shard {j}: DIR's tables differ from the tree's")
    return seng, bseng


def lookup100m(a, libs, base, dev, rng, tmp):
    idx, host = S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                        string_len=S.STRING_LEN, seed=60, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    seng, bseng = engines(idx, host, base, dev)
    del host
    S.require(not seng.handoff, "100M: a hand-off index")
    _, km = S.positives(idx, rng, S.SCALE_B)
    kt = eng.kmers32(km)
    del km
    tag = "100M canonical (1, 4)"
    cfg = seng.cfg
    ref = E.lookup(cfg, eng.tables, kt, None, "ids")
    args = S.probe_args(cfg, kt, S.P.minimizer)
    lookup_sides(tag, S.SCALE_B, libs, seng, bseng, kt, "ids", ref=ref,
                 extra={"lane": functools.partial(lane_lookup, libs["lane"], seng, kt)})
    # kernel 2 on each shard: the tree's owned stores (queued, a thread a
    # lane on either grid, 4 blocks an SM) against the baseline's every-lane
    # stores
    out = seng._result_tensors(S.SCALE_B, "ids")
    bout = bseng._result_tensors(S.SCALE_B, "ids")
    for j, sh in enumerate(seng.probe_shards):
        def tree(lib=libs["tree"]):  # as the lookup launches it: shard 0 stores the slots
            with SA.using(lib):
                return E.probe(cfg, seng.tables[j], kt, *args, None, "ids", sh, out=out,
                               slots="read" if j else "store")

        def baseline():  # DIR's owner-written contract, as its lookup launches it
            return base.engine.probe(bseng.cfg, bseng.tables[j], kt, *args, None, "ids",
                                     bseng.probe_shards[j], out=bout,
                                     slots="read" if j else "store")
        S.time_sides(tag, f"kernel 2 on shard {j} (ids)", S.SCALE_B,
                     {"tree": tree, "exit": functools.partial(tree, libs["exit"]),
                      "simple": functools.partial(tree, libs["simple"]),
                      "blocks4": functools.partial(tree, libs["blocks4"]),
                      "baseline": baseline})
    got = E.lookup(cfg, eng.tables, kt, None, "ids")
    want = base.engine.lookup(cfg, eng.tables, kt, None, "ids")
    same(got, want, "100M unsharded lookup")
    S.time_sides("100M canonical", "the engine's unsharded lookup (ids)", S.SCALE_B,
                 {"tree": lambda: E.lookup(cfg, eng.tables, kt, None, "ids"),
                  "baseline": lambda: base.engine.lookup(cfg, eng.tables, kt, None, "ids")})
    del eng, seng, bseng, kt, got, want, out, args
    torch.cuda.empty_cache()


def regular5m(a, libs, base, dev, rng, tmp):
    idx, host = S.build("regular", k=31, m=17, canonical=False, num_strings=S.MAIN_STRINGS,
                        string_len=S.STRING_LEN, seed=40, threads=8)
    seng, bseng = engines(idx, host, base, dev)
    _, km = S.positives(idx, rng, S.MAIN_B)
    kt = seng.kmers32(km)
    lookup_sides("5M regular (1, 4)", S.MAIN_B, libs, seng, bseng, kt, "full")
    del seng, bseng, kt
    torch.cuda.empty_cache()


def handoff(a, libs, base, dev, rng, tmp):
    idx, host = S.build("regular planted", k=31, m=13, canonical=False,
                        num_strings=S.PATH_STRINGS, string_len=S.STRING_LEN, seed=50,
                        planted=PLANTED)
    seng, bseng = engines(idx, host, base, dev)
    S.require(seng.handoff, "1M planted: no hand-off")
    n = S.HEAVY_B
    ids = np.concatenate([rng.integers(0, idx.num_kmers, n // 2),
                          synthetic.path_kmer_ids(idx, rng, n - n // 2)])
    km = S.oracle.access(idx, ids)
    km[::2] = S.K.revcomp_kmers(km[::2], idx.k)
    kt = seng.kmers32(km)
    lookup_sides("1M regular planted (1, 4), hand-off", n, libs, seng, bseng, kt, "full",
                 graph=("tree", "baseline", "exit", "simple", "blocks4"))
    del seng, bseng, kt
    torch.cuda.empty_cache()


def recorded_rounds(seng, calls):
    """Set seng's rank-space lookup of the misses (data row 0) to record
    its calls (a step's two rounds) into calls, before a stream makes its
    steps; returns the lookup itself."""
    fn = seng._ranks_fn(0, "stream")

    def recorded(*a):
        calls.append(a)
        return fn(*a)

    seng._lookups[("ranks", 0, "stream")] = recorded
    return fn


def stream_sides(tag, base, libs, sides_engines, path, multiline):
    """The (1, 4) ShardedStream's step on the first chunk of path, this
    tree's against DIR's and the sides' (ENGINE_SIDES, LIB_SIDES): equal
    counters, each side's launches in one step, then in turns from CUDA
    graphs; the tree's first round launch by launch against its bound
    (chip_smoke.time_rank_round); then each round of the misses' lookup
    alone (the tree's list passes and list probes, the sides' forms, DIR's
    walks), in turns from CUDA graphs."""
    steps, rounds, lookups = {}, {}, {}
    for side, stream_cls, seng in zip(ENGINE_SIDES, (ShardedStream, base.parallel.ShardedStream),
                                      sides_engines):
        packed, *_, av = SA.first_chunk(lambda e, **kw: stream_cls(e, **kw), seng, path,
                                        multiline)
        rounds[side] = []
        lookups[side] = recorded_rounds(seng, rounds[side])
        st = stream_cls(seng, pmax=1 << 22, rmax_shift=12 if multiline else 4)
        steps[side] = functools.partial(st._steps[(0, av)], None, packed)
    stats = {}
    want = steps["tree"](stats)
    S.require(S.rows_equal(steps["baseline"](), want), f"{tag}: DIR's step != the tree's")
    for side in LIB_SIDES:  # the tree's engine and step through a variant's library
        steps[side], rounds[side], lookups[side] = steps["tree"], rounds["tree"], lookups["tree"]
    for side in LIB_SIDES:
        with SA.using(libs[side]):
            S.require(S.rows_equal(steps[side](), want), f"{tag}: the {side} step != the tree's")
    for side, kern in (("tree", kernels), ("baseline", base.kernels),
                       *((side, kernels) for side in LIB_SIDES)):
        torch.cuda.synchronize()
        kern.reset_counts()
        with SA.using(libs.get(side, libs["tree"]) if side != "baseline" else libs["tree"]):
            steps[side]()
        torch.cuda.synchronize()
        got = {n: c for n, c in kern.counts().items() if c}
        S.log(f"  {tag}: {side} launches in one step {got}")
        if side not in LIB_SIDES:
            rounds[side] = rounds[side][-2:]  # this eager step's two rounds
    S.log(f"  {tag}: chunk 0 misses {int(stats['need'])}, lookup heads {int(stats['heads'])}, "
          f"round-2 ranks {int(stats['round2'])}; the steps' counters equal")

    for side in LIB_SIDES:
        rounds[side] = rounds["tree"]

    def under(side, fn):
        def run():
            with SA.using(libs.get(side, libs["tree"]) if side != "baseline" else libs["tree"]):
                return fn()
        return run

    S.time_sides(tag, "the step", 1 << 22, {side: under(side, fn) for side, fn in steps.items()},
                 unit="lane", graph=tuple(steps))
    # the tree's first round launch by launch (its list passes and list
    # probes, each held to its plain version first), against its bound
    keep, errs = [], {"probe_ranks": 0}
    seng = sides_engines[0]
    passes = (1 if seng.cfg.canonical else 2) * (2 if seng.handoff else 1)
    with S.ranks_checked(errs, keep, 2 * passes):
        lookups["tree"](*rounds["tree"][0])
    S.time_rank_round(keep, tag)
    for r in range(2):
        fns = {}
        for side, calls in rounds.items():
            fns[side] = under(side, functools.partial(lookups[side], *calls[r]))
        got = {side: fn() for side, fn in fns.items()}
        n = int(rounds["tree"][r][5][0])
        act = int(rounds["tree"][r][4][:n].sum())
        for side, res in got.items():
            S.require(all(torch.equal(res[key][:n], got["tree"][key][:n]) for key in res),
                      f"{tag}: the {side} round {r + 1} != the tree's")
        S.time_sides(tag, f"the misses' round {r + 1} ({n} ranks, {act} active)", max(n, 1),
                     fns, unit="rank", graph=tuple(fns))


def lowhit(a, libs, base, dev, rng, tmp):
    idx, host = S.build("regular", k=31, m=17, canonical=False, num_strings=S.MAIN_STRINGS,
                        string_len=S.STRING_LEN, seed=40, threads=8)
    path = SA._lowhit_path(idx, rng, tmp)
    stream_sides("low-hit 5M (1, 4) sharded", base, libs, engines(idx, host, base, dev), path,
                 False)
    torch.cuda.empty_cache()


def highhit100m(a, libs, base, dev, rng, tmp):
    idx, host = S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                        string_len=S.STRING_LEN, seed=60, threads=8)
    strings = synthetic.index_strings(idx, rng.choice(idx.num_strings, S.SCALE_STREAM_STRINGS,
                                                      replace=False))
    path = os.path.join(tmp, "genome100m.fa")
    synthetic.write_genome(path, strings, rng)
    del strings
    stream_sides("high-hit 100M (1, 4) sharded", base, libs, engines(idx, host, base, dev),
                 path, True)
    torch.cuda.empty_cache()


def handoffstream(a, libs, base, dev, rng, tmp):
    idx, host = S.build("regular planted", k=31, m=13, canonical=False,
                        num_strings=S.PATH_STRINGS, string_len=S.STRING_LEN, seed=50,
                        planted=PLANTED)
    strings = synthetic.index_strings(idx)
    reads = synthetic.cut_reads(strings, 20000, S.MIXED_LEN, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(20000, S.MIXED_LEN, rng)
    path = os.path.join(tmp, "handoff.fq")
    synthetic.write_reads(path, [reads[i] for i in rng.permutation(len(reads))])
    del strings, reads
    seng, bseng = engines(idx, host, base, dev)
    S.require(seng.handoff, "1M planted: no hand-off")
    stream_sides("1M planted (1, 4) sharded, hand-off", base, libs, (seng, bseng), path, False)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
