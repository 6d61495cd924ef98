#!/usr/bin/env python3
"""Time build variants of the lookup's CUDA kernels against each other,
and an earlier tree's kernels 1-2 against this tree's, in turns on one
card (chip_smoke.py's timing: CUDA events around windows of calls, median
of 7, sides run backwards then forwards).

    python3 lookup_ab.py [--baseline DIR] [--strings 1000]
                         [--cells variants,v1,v2,capacity,pad,legacy] [--orders v2-first]
                         [--wide-strings 600] [--capacity-index DIR]

Cells (default: variants):
  variants  the build variants below, and DIR's kernels 1-2 on this tree's
            tables
  v1        the 100M index's v1 rows alone: this tree's lookup kernel and
            kernel 2 against DIR's kernels on the same tables, three rounds
            of turns, no v2 side run before them (needs --baseline)
  v2        rebased (v2) rows at 100M: this tree's v2 rows (blocks of kid0
            and rel_ep1) against DIR's own v2 rows (its package, loaded
            under another name, with its own kernel library and its own
            tables: kid0, sid0, rel_ep1), and this tree's v1 rows against
            DIR's kernels on them: kernel 2 alone and the lookup kernel
            (ids), the (1, 4) LocalMesh lookup in v2, each side's bound,
            table bytes per kmer, and the ptxas lines of the V2 = false
            instantiations of both builds compared (needs --baseline);
            its turns run once for each order of --orders (a comma list of
            ORDERS: v2-first is v2, DIR v2, v1, DIR v1; v1-first is v1,
            DIR v1, v2, DIR v2, where this tree's v1 side never follows
            DIR's v2 side), each backwards, then forwards
  capacity  the v2 cell's sides and turns on capacity_run.py's index
            (--capacity-index; by default its 300M k31 m17 regular build
            under build/capacity: `capacity_run.py --kmers 300000000
            --stages generate,build` first), its (1, 4) LocalMesh too
  pad       k65 m25 canonical (chip_smoke phase 13's 60M without its tie
            pairs, --wide-strings strings of 100,064 chars) in v2 rows, where
            layout.row_pad pads the row from 15 words to 16: kernel 2 alone
            and the lookup kernel on the padded rows against the same rows
            unpadded, both through one build of this tree's probe.cu whose
            bad_row_w also takes the unpadded width (probe.cuh patched), and
            DIR's v2 rows with --baseline
  legacy    pre-v1.2 skew forms (synthetic.legacy_skew: hindex dropped, and
            plain class MPHFs) of chip_smoke phase 5's 1M k31 m13 canonical
            planted index and of a 100M k31 m21 canonical index (--strings)
            whose planted heavy buckets (LEGACY_PLANTED, every skew class)
            take over 100 MB in the two-hop form, twice the L2: this tree's
            one-hop form (each heavy lane's sk_hrows row at the derived
            hindex) against DIR's two-hop form (sk_positions, then
            heavy_rows; DIR's package, its own tables) and DIR's kernels on
            this tree's one-hop tables; kernel 2 on 2^20 heavy lanes only,
            kernel 2 and the lookup kernel on 2^24 lanes of 50%-RC
            positives, the (1, 4) LocalMesh lookup; each form's heavy share,
            skew table bytes per kmer, bounds, and the conversion's seconds
            (layout.class_hindex alone, and write_tables with it, on
            THREADS host threads; the 100M index and its one-hop tables are
            cached under build/lookup_ab/, keyed by strings, seed and layout
            version, and a run finding them loads them); needs --baseline

Index: chip_smoke.py phase 7's 100M k31 m21 canonical build (--strings
strings of 100,030 chars), 2^24 lanes of 50%-RC positives. Each variant
compiles this tree's csrc/probe.cu (patched as named) with nvcc for
sm_90a into build/lookup_ab/:

  tree        the sources as they are
  no_bounds   the lookup kernel without its __launch_bounds__ minimum of
              resident blocks
  in_place    both probe entries read the row head in place, word by word
              (no staging in shared memory)
  two_lanes   a canonical lookup kernel taking two lanes a thread: both
              lanes' minimizers, then both pilot reads, then both rows
              staged, then both verified
  DIR         (with --baseline) DIR/sshash_tpu_torch/csrc/{minimizer,
              probe}.cu: kernel 1 and kernel 2 of an earlier tree, e.g.
              `git archive <commit> | tar -x -C DIR`

Prints the card, each variant's registers (ptxas), the card's SM clock,
power draw and throttle reasons after each timing of the v1 and v2
cells, and the ms of: the
lookup kernel (ids) per variant; kernel 2 alone (ids, kernel 1's folded
outputs given) per variant and DIR's; kernel 1 (both strands) at k31 m21
on the positives and at k65 m25 on 2^23 random kmers, this tree's against
DIR's. Every variant's output equals the tree's, checked before timing.
"""

import argparse
import contextlib
import ctypes
import importlib
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import torch

import stream_ab as SA  # load_baseline
from sshash_tpu_torch import bounds, kernels, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import layout as L
from sshash_tpu_torch.engine import canonical_fold
from sshash_tpu_torch.ops import packed as P
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "sshash_tpu_torch" / "csrc"
OUT = ROOT / "build" / "lookup_ab"
LANES2 = r'''
namespace sshash {
// two lanes a thread, canonical mode, the whole table: lanes base + l *
// blockDim.x for l = 0, 1
template <int W, bool V2>
__global__ void __launch_bounds__(256, 2) lookup2_kernel(ProbeTables t, ProbeParams p,
                                                         ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int64_t base = (int64_t)blockIdx.x * blockDim.x * 2 + threadIdx.x;
  const int stride = stage_stride(2 + (int)p.blk_w);
  const int k = (int)p.k, nw = used_words<W>(p.W);
  const uint32_t kmw = (uint32_t)(p.k - p.m);
  uint32_t km[2][W], kr[2][W], tries[2][kMaxTries], s[2];
  uint64_t minval[2];
  int ntries[2];
  bool on[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int64_t i = base + l * blockDim.x;
    on[l] = i < p.B && (!io.active || io.active[i]);
    load_kmer(io.kmers, on[l] ? i : 0, nw, km[l]);
    const Minimizers mz = kmer_minimizers<W, true>(km[l], k, (int)p.m, p.magic);
    revcomp_words(km[l], k, nw, kr[l]);
    const bool rc_first = mz.mv_r < mz.mv_f;
    const uint32_t mp1 = (uint32_t)(rc_first ? mz.mp_r : mz.mp_f);
    const uint32_t mp2 = mz.mv_r == mz.mv_f ? (uint32_t)mz.mp_r : mp1;
    tries[l][0] = mp1;
    tries[l][1] = kmw - mp1;
    tries[l][2] = mp2;
    tries[l][3] = kmw - mp2;
    ntries[l] = mp2 == mp1 ? 2 : 4;
    minval[l] = rc_first ? mz.mv_r : mz.mv_f;
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) s[l] = mphf_slot(t, p, minval[l]);
  const uint32_t* grow[2];
  const uint32_t* row[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    grow[l] = slot_row(t, p, s[l]);
    row[l] = stage_head<head_segments(W)>(grow[l], 2 + (int)p.blk_w,
                                          stage + (2 * threadIdx.x + l) * stride);
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int64_t i = base + l * blockDim.x;
    if (i >= p.B) break;
    Lane L{false, true, Hit{false, 0, kForward, 0, 0, 0}};
    if (on[l])
      L = probe_row<W, true, V2>(t, p, grow[l], row[l], km[l], kr[l], minval[l], tries[l],
                                 ntries[l], nullptr);
    write_result<V2>(io, p, i, L, L.found ? L.res.orient : kForward);
  }
}
}  // namespace sshash

extern "C" int sshash_lookup2(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                              const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  if (!p->canonical || p->W > kMaxFixedW || bad_params(*t, *p, *io))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const size_t smem = (size_t)threads * 2 * stage_stride(2 + (int)p->blk_w) * 4;
  const unsigned blocks = (unsigned)((p->B + 2 * threads - 1) / (2 * threads));
  auto s = (cudaStream_t)stream;
  return (int)dispatch_width(p->W, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (W > kMaxFixedW) return (cudaError_t)cudaErrorInvalidValue;
    constexpr int WW = W > kMaxFixedW ? 1 : W;
    if (p->row_v2)
      lookup2_kernel<WW, true><<<blocks, threads, smem, s>>>(*t, *p, *io);
    else
      lookup2_kernel<WW, false><<<blocks, threads, smem, s>>>(*t, *p, *io);
    return cudaGetLastError();
  });
}
'''


def patch(src, old_re, new):
    out, n = re.subn(old_re, new, src)
    if n == 0:
        raise RuntimeError(f"pattern not found: {old_re}")
    return out


def variant_sources(baseline):
    """{variant: (directory of its sources, include directory)}: each
    directory holds the probe.cu (and for DIR minimizer.cu) it builds."""
    probe = (CSRC / "probe.cu").read_text()
    texts = {
        "tree": probe,
        "no_bounds": patch(probe, r"__launch_bounds__\(256, [^\n]*\)\n", "__launch_bounds__(256)\n"),
        "in_place": patch(probe, r"stage_head<head_segments\(W\)>\(grow, 2 \+ \(int\)p\.blk_w, "
                                 r"slot\)", "grow"),
        "two_lanes": probe + LANES2,
    }
    out = {}
    for name, text in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "probe.cu").write_text(text)
        (d / "minimizer.cu").write_text((CSRC / "minimizer.cu").read_text())
        out[name] = (d, CSRC)
    if baseline:
        bsrc = Path(baseline) / "sshash_tpu_torch" / "csrc"
        out["baseline"] = (bsrc, bsrc)
    return out


def build(variants):
    """Compile every variant's sources in parallel; returns ({variant:
    ctypes library}, the ptxas lines of its kernels). A variant that does
    not compile is left out, its error printed."""
    nvcc = kernels._nvcc()
    jobs = {}
    for name, (d, inc) in variants.items():
        for src in ("probe.cu", "minimizer.cu"):
            obj = OUT / f"{name}_{src}.o"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-c",
                   str(d / src), "-o", str(obj)]
            jobs[(name, obj)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)
    regs, objs, failed = [], {}, set()
    for (name, obj), proc in jobs.items():
        out = proc.communicate()[0]
        lines = out.splitlines()
        for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
            m = re.search(r"Function properties for _ZN6sshash\d+(lookup2?_kernel|probe_kernel)"
                          r"ILi(\d+)ELb(\d)E(?:Lb(\d)E)?", ln)
            if m and m.group(2) in ("2", "5"):
                regs.append(f"{name} {m.group(1)} W{m.group(2)} {m.group(3)}{m.group(4) or ''}: "
                            f"{re.search(r'Used \d+ registers', reg).group(0)}, {nxt.strip()}")
        if proc.returncode:
            failed.add(name)
            S.log(f"  {name}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
        objs.setdefault(name, []).append(str(obj))
    libs = {}
    for name, o in objs.items():
        if name in failed:
            continue
        so = OUT / f"lib{name}.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), *o], check=True)
        lib = ctypes.CDLL(str(so))
        p = ctypes.c_void_p
        sig = [ctypes.POINTER(kernels.ProbeTables), ctypes.POINTER(kernels.ProbeParams),
               ctypes.POINTER(kernels.ProbeIO), p]
        for fn in ("sshash_probe", "sshash_lookup", "sshash_lookup2"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        lib.sshash_minimizer.argtypes = [p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_uint64, p, p, p, p, p, p]
        lib.sshash_minimizer.restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def call(lib, fn, cfg, tables, kt, args=None):
    """One launch of a probe entry of lib on this tree's structs; returns
    the ids fields."""
    B, dev, tab, prm, out = kernels._probe_launch(cfg, tables, kt, None, "ids")
    ptr = kernels._ptr
    if args is None:
        io = kernels.ProbeIO(kt.data_ptr(), None, None, None, None, None,
                             *(ptr(out.get(n)) for n in kernels._IO_NAMES[6:-1]), None)
    else:
        rc, mv, mp, mp2 = args
        io = kernels.ProbeIO(kt.data_ptr(), ptr(rc), mv.data_ptr(), mp.data_ptr(), ptr(mp2),
                             None, *(ptr(out.get(n)) for n in kernels._IO_NAMES[6:-1]), None)
    err = getattr(lib, fn)(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                           kernels._stream(dev))
    if err:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")
    return out


def minimizer(lib, kt, k, m, magic):
    B = kt.shape[0]
    mv = torch.empty(B, dtype=torch.int64, device=kt.device)
    mp = torch.empty(B, dtype=torch.int32, device=kt.device)
    rc, mv_r, mp_r = torch.empty_like(kt), torch.empty_like(mv), torch.empty_like(mp)
    err = lib.sshash_minimizer(kt.data_ptr(), B, kt.shape[1], k, m, magic & (2 ** 64 - 1),
                               mv.data_ptr(), mp.data_ptr(), rc.data_ptr(), mv_r.data_ptr(),
                               mp_r.data_ptr(), kernels._stream(kt.device))
    if err:
        raise RuntimeError(f"sshash_minimizer failed: CUDA error {err}")
    return mv, mp, rc, mv_r, mp_r


def equal(a, b):
    return all(torch.equal(a[key], b[key]) for key in b)


def scale_index(a):
    return S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                   string_len=S.STRING_LEN, seed=60, threads=8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an unpacked earlier tree: its kernels 1-2 are timed too")
    ap.add_argument("--strings", type=int, default=S.SCALE_STRINGS)
    ap.add_argument("--cells", default="variants")
    ap.add_argument("--orders", default="v2-first",
                    help="the orders of the v2 and capacity cells' turns, of " + ", ".join(ORDERS))
    ap.add_argument("--wide-strings", type=int, default=S.WIDE_STRINGS["canonical"])
    ap.add_argument("--capacity-index", default=str(ROOT / "build" / "capacity"
                                                    / "index_300000000_k31_m17"))
    a = ap.parse_args()
    cells = a.cells.split(",")
    S.phase_card()
    dev = torch.device("cuda", 0)
    base = None
    if {"v1", "v2", "pad", "capacity", "legacy"} & set(cells):
        if {"v1", "v2", "capacity", "legacy"} & set(cells) and not a.baseline:
            raise SystemExit("the v1, v2, capacity and legacy cells need --baseline")
        base = build_pair(a.baseline)
    built = scale_index(a) if {"variants", "v1", "v2"} & set(cells) else None
    if "variants" in cells:
        variants_cell(a, dev, *built)
    if "v1" in cells:
        v1_cell(dev, base, *built)
    if "v2" in cells:
        v2_cell(dev, base, *built, orders=a.orders.split(","))
    del built
    if "capacity" in cells:
        from sshash_tpu_torch.index import Index

        v2_cell(dev, base, Index.load(a.capacity_index), None,
                f"capacity_run.py's index ({a.capacity_index})", "capacity",
                a.orders.split(","))
    if "pad" in cells:
        pad_cell(a, dev, base)
    if "legacy" in cells:
        legacy_cell(a, dev, base)
    S.log(f"card: {torch.cuda.get_device_name(0)}")


def variants_cell(a, dev, idx, host):
    libs, regs = build(variant_sources(a.baseline))
    for ln in regs:
        S.log(f"  ptxas {ln}")
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    rng = np.random.default_rng(6)
    _, km = S.positives(idx, rng, S.SCALE_B)
    kt = eng.kmers32(km)
    cfg, t = eng.cfg, eng.tables
    B = kt.shape[0]
    mv, mp, rc, mv_r, mp_r = P.minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    args = (rc, *canonical_fold(mv, mp, mv_r, mp_r))
    ref = call(libs["tree"], "sshash_lookup", cfg, t, kt)
    S.require(equal(ref, S.lookup_plain(cfg, t, kt, None, "ids")), "tree != lookup_plain")
    one = {name: (lambda lib=lib, fn="sshash_lookup2" if name == "two_lanes" else "sshash_lookup":
                  call(lib, fn, cfg, t, kt))
           for name, lib in libs.items() if name != "baseline"}
    two = {name: (lambda lib=lib: call(lib, "sshash_probe", cfg, t, kt, args))
           for name, lib in libs.items() if name in ("tree", "in_place", "baseline")}
    for name, fn in {**one, **{f"{n} kernel 2": f for n, f in two.items()}}.items():
        S.require(equal(fn(), ref), f"{name} != the tree's lookup kernel")
    S.log(f"  every variant's lookup and kernel 2 equal the tree's lookup kernel on {B} lanes")
    S.time_sides("100M k31 m21 canonical", "lookup kernel (ids)", B, one)
    S.time_sides("100M k31 m21 canonical", "kernel 2 alone (ids)", B, two)
    if "baseline" in libs:
        mins = {name: (lambda lib=libs[name], x=kt, c=cfg: minimizer(lib, x, c.k, c.m, c.magic))
                for name in ("tree", "baseline")}
        S.require(all(torch.equal(x, y) for x, y in zip(mins["tree"](), mins["baseline"]())),
                  "kernel 1: tree != baseline")
        S.time_sides("100M k31 m21", "kernel 1 (both strands)", B, mins)
        k65 = S.kmer_tensor(synthetic.random_kmers(65, rng, 1 << 23), 65, dev)
        magic = int(rng.integers(0, 1 << 63))
        mins = {name: (lambda lib=libs[name]: minimizer(lib, k65, 65, 25, magic))
                for name in ("tree", "baseline")}
        S.require(all(torch.equal(x, y) for x, y in zip(mins["tree"](), mins["baseline"]())),
                  "kernel 1 k65: tree != baseline")
        S.time_sides("k65 m25 random", "kernel 1 (both strands)", 1 << 23, mins)


# --------------------------------------------------------- v2 rows: tree and DIR

# the lookup kernel's and kernel 2's mangled names, V2 their last template
# argument
V2_KERNELS = re.compile(r"\d+(?:lookup_kernel|probe_kernel|shard_probe_kernel)"
                        r"ILi\d+ELb[01]ELb([01])E")


def build_pair(baseline):
    """This tree's kernel library and, with baseline, DIR's package (its own
    library built from its csrc with its C++ names in a namespace of their
    own, both nvcc runs at once). Logs the ptxas lines of the V2 = false
    instantiations of the lookup kernel and kernel 2 that differ between
    the two builds. Returns DIR's package as a namespace (layout and index
    too), or None."""
    if not baseline:
        kernels.library()
        return None
    base = SA.load_baseline(baseline)
    for mod in ("layout", "index", "bounds"):
        setattr(base, mod, importlib.import_module(f"baseline_sshash_tpu_torch.{mod}"))
    base.kernels.NVCC_FLAGS = (*base.kernels.NVCC_FLAGS, "-Dsshash=sshash_baseline")
    logs = {}
    t = threading.Thread(target=lambda: logs.setdefault("baseline", base.kernels.build()[2]))
    t.start()
    logs["tree"] = kernels.build()[2]
    t.join()
    if "baseline" not in logs:
        raise RuntimeError("the baseline's kernels did not build")
    kernels.library()
    base.kernels.library()
    props = {}
    for side, log in logs.items():
        lines = log.splitlines()
        for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
            m = V2_KERNELS.search(ln)
            if m and "Function properties" in ln:
                props.setdefault(side, {})[m.group(0)] = (m.group(1),
                                                          f"{reg.strip()}; {nxt.strip()}")
    tree, dir_ = props.get("tree", {}), props.get("baseline", {})
    v1 = [key for key, (v2, _) in tree.items() if v2 == "0"]
    diff = [f"{key}: tree {tree[key][1]} | DIR {dir_.get(key, ('', 'none'))[1]}"
            for key in v1 if tree[key][1] != dir_.get(key, ("", ""))[1]]
    S.log(f"  ptxas, V2 = false: {len(v1)} instantiations of the lookup kernel and kernel 2 "
          f"(whole table, shard form); {len(diff)} differ from DIR's"
          + "".join(f"\n    {d}" for d in diff))
    for key, (v2, line) in sorted(tree.items()):
        if v2 == "1" and re.search(r"ILi[25]E", key):
            S.log(f"  ptxas tree {key}: {line} | DIR {dir_.get(key, ('', 'none'))[1]}")
    return base


def base_index(base, idx, name):
    """idx as DIR's Index class (saved, then loaded by DIR's package), so that
    its layout's isinstance tests see its own classes."""
    path = str(OUT / f"{name}_index")
    idx.save(path)
    return base.index.Index.load(path)


@contextlib.contextmanager
def patched(mod, **names):
    saved = {n: getattr(mod, n) for n in names}
    for n, v in names.items():
        setattr(mod, n, v)
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(mod, n, v)


def probe_bounds(cfg, tables, kt, args, lay=L):
    """lookup_bounds for cfg's rows, counting rows with lay's widths (DIR's
    layout module for DIR's rows)."""
    with patched(bounds, row_width=lay.row_width, cand_block_width=lay.cand_block_width):
        return bounds.lookup_bounds(cfg, kt.shape[0], bounds.probe_bytes(cfg, tables, kt, args),
                                    bounds.probe_bytes(cfg, tables, kt, args, fused=True))


def clocks(tag):
    """Logs the card's SM clock, power draw, temperature and active throttle
    reasons (nvidia-smi) after a timing."""
    q = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    S.log(f"  {tag}: after the timing, {q}: {out}")


def v1_cell(dev, base, idx, host, tag="100M k31 m21 canonical"):
    """The index's v1 rows alone: this tree's lookup kernel and kernel 2
    against DIR's on the same tables, each held to the oracle's ids, then
    three rounds of turns (six runs a side)."""
    rng = np.random.default_rng(19)
    eng1 = S.TorchEngine(idx, dev, host_arrs=host)
    bcfg1 = base.layout.StaticCfg(base_index(base, idx, "v1"))
    ids, km = S.positives(idx, rng, S.SCALE_B)
    kt = eng1.kmers32(km)
    ref = E.lookup(eng1.cfg, eng1.tables, kt, None, "ids")
    S.require(torch.equal(ref["kmer_id"], S.id_tensor(ids, dev)), "v1: an id did not round-trip")
    args = bounds.probe_args(eng1.cfg, kt, P.minimizer)
    lookups = {"v1": lambda: E.lookup(eng1.cfg, eng1.tables, kt, None, "ids"),
               "DIR v1": lambda: base.engine.lookup(bcfg1, eng1.tables, kt, None, "ids")}
    probes = {"v1": lambda: E.probe(eng1.cfg, eng1.tables, kt, *args, None, "ids"),
              "DIR v1": lambda: base.engine.probe(bcfg1, eng1.tables, kt, *args, None, "ids")}
    ref2 = probes["v1"]()
    for side in lookups:
        ids_equal(lookups[side](), ref, f"v1 cell lookup kernel {side}")
        ids_equal(probes[side](), ref2, f"v1 cell kernel 2 {side}")
    S.log(f"  {tag} v1 alone: both sides' lookup kernel equals the positives' ids on "
          f"{S.SCALE_B} lanes")
    for r in range(3):
        S.time_sides(f"{tag} v1 alone, round {r + 1}", "lookup kernel (ids)", S.SCALE_B, lookups)
        clocks(f"{tag} v1 alone, round {r + 1}, lookup kernel")
        S.time_sides(f"{tag} v1 alone, round {r + 1}", "kernel 2 alone (ids)", S.SCALE_B, probes)
        clocks(f"{tag} v1 alone, round {r + 1}, kernel 2")


def ids_equal(got, want, tag):
    for key in ("kmer_id", "kmer_orientation", "minimizer_found", "found"):
        S.require(torch.equal(got[key], want[key]), f"{tag}: {key} differs")


ORDERS = {"v2-first": ("v2", "DIR v2", "v1", "DIR v1"),
          "v1-first": ("v1", "DIR v1", "v2", "DIR v2")}


def v2_cell(dev, base, idx, host, tag="100M k31 m21 canonical", name="scale",
            orders=("v2-first",)):
    """An index (the 100M canonical one; the capacity cell's 300M regular)
    in this tree's v2 rows, DIR's v2 rows and v1 rows: every side held to
    the oracle on a sample and to the v1 engine's ids on all lanes (kernel
    2 alone to v1's kernel 2), then timed in turns, once in each of
    orders (ORDERS' keys)."""
    rng = np.random.default_rng(19)
    bidx = base_index(base, idx, name)
    eng1 = S.TorchEngine(idx, dev, host_arrs=host)
    host2 = L.device_arrays(idx, "v2")
    eng2 = S.TorchEngine(idx, dev, host_arrs=host2, row_format="v2")
    bhost2 = base.layout.device_arrays(bidx, "v2")
    beng2 = base.engine.TorchEngine(bidx, dev, host_arrs=bhost2, row_format="v2")
    bcfg1 = base.layout.StaticCfg(bidx)
    S.log(f"  {tag}: rows (words) v1 {L.row_width(eng1.cfg)}, v2 {L.row_width(eng2.cfg)} "
          f"(pad {L.row_pad(eng2.cfg)}), DIR's v2 {base.layout.row_width(beng2.cfg)}; "
          f"c1_in_row {eng2.cfg.c1_in_row}")
    ids, km = S.positives(idx, rng, S.SCALE_B)
    kt = eng1.kmers32(km)
    sample = np.concatenate([km[: S.SAMPLE // 8], synthetic.random_kmers(idx.k, rng,
                                                                         S.SAMPLE // 8)])
    want = S.oracle.lookup(idx, sample)
    for name, e in (("v1", eng1), ("v2", eng2), ("DIR v2", beng2)):
        got = e.lookup(sample)
        for key in got:
            S.require(np.array_equal(got[key], want[key]), f"{name}: {key} != the oracle")
    ref = E.lookup(eng1.cfg, eng1.tables, kt, None, "ids")
    S.require(torch.equal(ref["kmer_id"], S.id_tensor(ids, dev)), "v1: an id did not round-trip")
    args = bounds.probe_args(eng1.cfg, kt, P.minimizer)
    lookups = {"v2": lambda: E.lookup(eng2.cfg, eng2.tables, kt, None, "ids"),
               "DIR v2": lambda: base.engine.lookup(beng2.cfg, beng2.tables, kt, None, "ids"),
               "v1": lambda: E.lookup(eng1.cfg, eng1.tables, kt, None, "ids"),
               "DIR v1": lambda: base.engine.lookup(bcfg1, eng1.tables, kt, None, "ids")}
    probes = {"v2": lambda: E.probe(eng2.cfg, eng2.tables, kt, *args, None, "ids"),
              "DIR v2": lambda: base.engine.probe(beng2.cfg, beng2.tables, kt, *args, None,
                                                  "ids"),
              "v1": lambda: E.probe(eng1.cfg, eng1.tables, kt, *args, None, "ids"),
              "DIR v1": lambda: base.engine.probe(bcfg1, eng1.tables, kt, *args, None, "ids")}
    ref2 = probes["v1"]()
    for side in lookups:
        ids_equal(lookups[side](), ref, f"lookup kernel {side}")
        ids_equal(probes[side](), ref2, f"kernel 2 {side}")
    S.log(f"  {tag}: the lookup kernel of every side equals the v1 lookup's ids on {S.SCALE_B} "
          f"lanes, kernel 2 v1's kernel 2; each side's host lookup equals the oracle on "
          f"{len(sample)}")
    for order in orders:
        S.log(f"  {tag}: {order}, the sides {list(ORDERS[order])} backwards, then forwards")
        S.time_sides(f"{tag} {order}", "lookup kernel (ids)", S.SCALE_B,
                     {side: lookups[side] for side in ORDERS[order]})
        clocks(f"{tag} {order}, lookup kernel")
        S.time_sides(f"{tag} {order}", "kernel 2 alone (ids)", S.SCALE_B,
                     {side: probes[side] for side in ORDERS[order]})
        clocks(f"{tag} {order}, kernel 2")
    for side, cfg, t, lay in (("v2", eng2.cfg, eng2.tables, L),
                              ("DIR v2", beng2.cfg, beng2.tables, base.layout),
                              ("v1", eng1.cfg, eng1.tables, L)):
        b = probe_bounds(cfg, t, kt, args, lay)
        nb = sum(t[n].numel() * 4 for n in L.TABLE_GROUPS["lookup"] if n in t)
        S.log(f"  {tag} {side}: kernel 2 bound {b['probe.cu'][0]:.4f} ms ({b['probe.cu'][1]}), "
              f"lookup kernel bound {b['lookup'][0]:.4f} ({b['lookup'][1]}; bytes "
              f"{b['lookup_bytes'][0]:.4f}); lookup tables {nb} bytes = "
              f"{nb / idx.num_kmers:.4f} B/kmer")
    del eng1
    torch.cuda.empty_cache()
    seng = ShardedEngine(idx, LocalMesh((1, 4), dev), host_arrs=host2, row_format="v2")
    bseng = base.parallel.ShardedEngine(bidx, base.parallel.LocalMesh((1, 4), dev),
                                        host_arrs=bhost2, row_format="v2")
    del host2, bhost2
    sharded = {"v2 (1, 4)": lambda: seng.lookup_ids_device(kt),
               "DIR v2 (1, 4)": lambda: bseng.lookup_ids_device(kt)}
    for side, fn in sharded.items():
        ids_equal(fn(), ref, side)
    S.time_sides(tag, "LocalMesh (1, 4) lookup (ids)", S.SCALE_B, sharded)


# --------------------------------------------- v2 rows at k65: padded or not

ROW_W_CHECK = "  return p.row_w != R + (padded ? pad : 0);\n"


def unpadded_library():
    """This tree's probe.cu and minimizer.cu built with a bad_row_w that
    takes a v2 row unpadded as well as padded (probe.cuh patched; every
    header copied beside it, so that each include resolves to the copies)."""
    d = OUT / "unpadded"
    d.mkdir(parents=True, exist_ok=True)
    for f in CSRC.iterdir():
        if f.suffix in (".cuh", ".h") or f.name in ("probe.cu", "minimizer.cu"):
            (d / f.name).write_text(f.read_text())
    (d / "probe.cuh").write_text(patch((CSRC / "probe.cuh").read_text(), re.escape(ROW_W_CHECK),
                                       "  return p.row_w != R && p.row_w != R + pad;\n"))
    libs, _ = build({"unpadded": (d, d)})
    S.require("unpadded" in libs, "the unpadded side's library did not build")
    return libs["unpadded"]


def unpadded(cfg):
    """Within: this tree's wrappers pass v2 rows without row_pad's zeros."""
    return patched(kernels, row_width=lambda c: L.row_width(c) - L.row_pad(c))


def pad_cell(a, dev, base):
    """k65 m25 canonical v2 rows, padded to 16 words (the layout's choice)
    and the same rows unpadded (15 words), both through unpadded_library,
    and DIR's 16-word rows: every side's lookup equal to the v1 lookup's
    ids, then kernel 2 alone and the lookup kernel in turns."""
    lib = unpadded_library()
    tag = f"k65 m25 canonical ({a.wide_strings} strings)"
    # without phase 13's planted tie pairs, whose buckets would put candidate 1
    # in the row (28 words, unpadded) at small sizes
    kw = dict(S.PREBUILT["wide"], num_strings=a.wide_strings, seed=130 + a.wide_strings,
              ties=None)
    idx, host = S.build(tag, **kw)
    rng = np.random.default_rng(65)
    eng1 = S.TorchEngine(idx, dev, host_arrs=host)
    del host
    eng2 = S.TorchEngine(idx, dev, row_format="v2")
    cfg, t = eng2.cfg, eng2.tables
    R = L.row_width(cfg) - L.row_pad(cfg)
    S.require(L.row_pad(cfg) > 0, f"{tag}: row_pad {L.row_pad(cfg)}: no padded row to time")
    t15 = dict(t, cw_row=t["cw_row"][:, :R].contiguous())
    n = 2 + L.cand_block_width(cfg)
    S.log(f"  {tag}: v2 head {n} words; padded rows {L.row_width(cfg)} words "
          f"({L.head_loads(n, L.row_width(cfg)):.2f} loads, "
          f"{L.head_sectors(n, L.row_width(cfg)):.2f} sectors a head), unpadded {R} "
          f"({L.head_loads(n, R):.2f}, {L.head_sectors(n, R):.2f}); v1 {L.row_width(eng1.cfg)}")
    _, km = S.positives(idx, rng, 1 << 23)
    kt = eng1.kmers32(km)
    ref = E.lookup(eng1.cfg, eng1.tables, kt, None, "ids")
    mv, mp, rc, mv_r, mp_r = P.minimizer(kt, idx.k, idx.m, eng1.cfg.magic, both=True)
    args = (rc, *canonical_fold(mv, mp, mv_r, mp_r))

    def on_unpadded(fn, *xs):
        def run():
            with unpadded(cfg):
                return call(lib, fn, cfg, t15, kt, *xs)
        return run

    lookups = {"padded": lambda: call(lib, "sshash_lookup", cfg, t, kt),
               "unpadded": on_unpadded("sshash_lookup")}
    probes = {"padded": lambda: call(lib, "sshash_probe", cfg, t, kt, args),
              "unpadded": on_unpadded("sshash_probe", args)}
    S.require(equal(lookups["padded"](), E.lookup(cfg, t, kt, None, "ids")),
              f"{tag}: the patched build's lookup kernel != the tree's")
    if base is not None:
        bidx = base_index(base, idx, "k65")
        beng2 = base.engine.TorchEngine(bidx, dev, row_format="v2")
        lookups["DIR v2"] = lambda: base.engine.lookup(beng2.cfg, beng2.tables, kt, None, "ids")
        probes["DIR v2"] = lambda: base.engine.probe(beng2.cfg, beng2.tables, kt, *args, None,
                                                     "ids")
    for name in lookups:
        ids_equal(lookups[name](), ref, f"{tag} lookup kernel {name}")
        ids_equal(probes[name](), ref, f"{tag} kernel 2 {name}")
    S.log(f"  {tag}: every side's lookup kernel and kernel 2 equal the v1 lookup's ids on "
          f"{kt.shape[0]} lanes")
    S.time_sides(tag, "lookup kernel (ids)", kt.shape[0], lookups)
    S.time_sides(tag, "kernel 2 alone (ids)", kt.shape[0], probes)


# ------------------------------------ legacy skew forms: one hop or two

# the legacy cell's 100M index: chip_smoke phase 7's k31 m21 canonical
# shape with heavy buckets planted in every skew class, (m-mers, sites
# each) with sizes in class c's range (2^(6+c), 2^(7+c)], 1,398,860 sites of
# about 11 kmers each (of the 1,613 a string holds 2k apart); every site's
# k - m context chars its own (synthetic.plant), so no heavy kmer repeats
LEGACY_PLANTED = [(20, 100), (30, 150), (40, 300), (50, 700), (60, 1500), (80, 3000),
                  (60, 6000), (40, 16384)]
LEGACY_SEED = 62
THREADS = 8  # host threads of the legacy cell's builds: the card host's cores
FORMS = {"no hindex": False, "plain class MPHFs": True}


def legacy_index(a):
    """The 100M planted index, built once and kept under build/lookup_ab/
    (Index.save), keyed by --strings and the seed."""
    from sshash_tpu_torch.index import Index

    path = OUT / f"legacy_{a.strings}_k31_m21_seed{LEGACY_SEED}" / "index"
    if (path / "meta.json").exists():  # Index.save writes it last
        S.log(f"  legacy: the planted index loaded from {path}")
        return Index.load(str(path))
    planted = [c for n, c in LEGACY_PLANTED for _ in range(n)]
    t0 = time.perf_counter()
    idx = synthetic.build_index(k=31, m=21, canonical=True, num_strings=a.strings,
                                string_len=S.STRING_LEN, seed=LEGACY_SEED, threads=THREADS,
                                planted=planted, context=10)
    S.log(f"  legacy: {idx.num_kmers} kmers, {len(planted)} m-mers planted "
          f"{sum(planted)} times, built in {time.perf_counter() - t0:.1f} s")
    idx.save(str(path))
    return idx


def legacy_tables(a, lidx, name):
    """This tree's tables of a legacy form (the one-hop form: the hindex
    derived inside), cached under build/lookup_ab/ for the 100M index
    (write_tables on THREADS threads), built in memory for the small
    one. Returns (tables, seconds of the build, or None when loaded)."""
    if name is None:
        t0 = time.perf_counter()
        host = L.device_arrays(lidx, None, 1 << 24, THREADS)
        return host, time.perf_counter() - t0
    d = OUT / f"{name}_layout{L.LAYOUT_VERSION['v1']}"
    if (d / "done").exists():
        return L.load_tables(str(d)), None
    t0 = time.perf_counter()
    host = L.write_tables(lidx, str(d), None, 1 << 24, THREADS)
    (d / "done").write_text("")
    return host, time.perf_counter() - t0


def heavy_lanes(cfg, tables, kt, args):
    """Mask of the lanes whose bucket is heavy (their fused row's status)."""
    from sshash_tpu_torch.ops import u64 as u

    slot = E.mphf_eval_minimizer(cfg, tables, u.from_i64(args[1]))
    return (L.take_rows(tables["cw_row"][:, :1], slot)[:, 0] & 3) == 2


def legacy_cell(a, dev, base):
    """The 1M planted cell and the 100M one, each in both legacy forms:
    this tree's one-hop form against DIR's two-hop form and DIR's kernels on
    the one-hop tables, every side's ids equal to the one-hop form's (and
    the positives' own ids) before timing, each engine's host lookup equal
    to the oracle on a sample with heavy misses."""
    import copy

    small = S.build("legacy 1M k31 m13 canonical planted", k=31, m=13, canonical=True,
                    num_strings=S.PATH_STRINGS, string_len=S.STRING_LEN, seed=50,
                    planted=S.PATH_PLANTED)[0]
    cells = [("1M k31 m13 canonical planted", small, None),
             (f"{a.strings // 10}M k31 m21 canonical planted", legacy_index(a),
              f"legacy_{a.strings}_k31_m21_seed{LEGACY_SEED}")]
    for tag, idx, key in cells:
        rng = np.random.default_rng(20)
        n_heavy = sum(p.mphf.n for p in idx.skew_partitions)
        S.log(f"  {tag}: {idx.num_kmers} kmers, {n_heavy} heavy ({n_heavy / idx.num_kmers:.4%}), "
              f"skew classes {[p.mphf.n for p in idx.skew_partitions]}, "
              f"{len(np.asarray(idx.heavy_load_buckets))} heavy positions")
        ids, km = S.positives(idx, rng, S.SCALE_B)
        for form, plain in FORMS.items():
            ftag = f"{tag}, {form}"
            t0 = time.perf_counter()
            lidx = synthetic.legacy_skew(idx, plain_mphf=plain)
            t1 = time.perf_counter()
            L.class_hindex(lidx, THREADS)
            t2 = time.perf_counter()
            host, tsec = legacy_tables(a, lidx, key and f"{key}_{'plain' if plain else 'part'}")
            S.log(f"  {ftag}: legacy_skew {t1 - t0:.1f} s; the conversion (class_hindex, "
                  f"{THREADS} threads) {t2 - t1:.2f} s; this tree's tables with it "
                  + (f"{tsec:.1f} s" if tsec is not None else "loaded from the cache"))
            eng = S.TorchEngine(lidx, dev, host_arrs=host)
            bidx = base_index(base, lidx, "legacy")
            bhost = base.layout.device_arrays(bidx, None, 1 << 24, THREADS)
            beng = base.engine.TorchEngine(bidx, dev, host_arrs=bhost)
            S.require(not beng.cfg.skew_hrows,
                      f"{ftag}: DIR's engine did not take the two-hop form")
            # DIR's kernels on this tree's one-hop tables: its v1.2 path
            bcfg1 = copy.copy(beng.cfg)
            bcfg1.skew_hrows = True
            R1 = L.cand_block_width(eng.cfg)
            btab1 = dict(eng.tables,
                         heavy_rows=torch.zeros((1, R1), dtype=torch.int32, device=dev),
                         sk_positions=torch.zeros(1, dtype=torch.int32, device=dev))
            n = idx.num_kmers
            two = {name: bhost[name].nbytes for name in ("heavy_rows", "sk_positions")}
            one = host["sk_hrows"].nbytes
            tb = {side: sum(t[name].numel() * 4 for name in L.TABLE_GROUPS["lookup"] if name in t)
                  for side, t in (("one-hop", eng.tables), ("two-hop", beng.tables))}
            S.log(f"  {ftag}: heavy tables, two-hop {two} = {sum(two.values())} bytes "
                  f"({sum(two.values()) / n:.4f} B/kmer, {sum(two.values()) / S.L2_BYTES:.2f}x "
                  f"the L2); one-hop sk_hrows {one} bytes ({one / n:.4f} B/kmer, "
                  f"{one / S.L2_BYTES:.2f}x the L2); lookup tables one-hop {tb['one-hop']} "
                  f"({tb['one-hop'] / n:.4f} B/kmer), two-hop {tb['two-hop']} "
                  f"({tb['two-hop'] / n:.4f} B/kmer)")
            kt = eng.kmers32(km)
            args = bounds.probe_args(eng.cfg, kt, P.minimizer)
            heavy = heavy_lanes(eng.cfg, eng.tables, kt, args)
            hl = heavy.nonzero()[:, 0]
            S.require(hl.numel() > 0, f"{ftag}: no heavy lane")
            # the oracle on a sample: positives, heavy positives with their
            # first char changed (mostly heavy misses) and random kmers
            hk = km[hl[: S.SAMPLE // 16].cpu().numpy()]
            hk[:, 0] ^= np.uint64(1)
            sample = np.concatenate([km[: S.SAMPLE // 16], hk,
                                     synthetic.random_kmers(idx.k, rng, S.SAMPLE // 64)])
            want = S.oracle.lookup(lidx, sample)
            for name, e in (("one-hop", eng), ("DIR two-hop", beng)):
                got = e.lookup(sample)
                for k_ in want:
                    S.require(np.array_equal(got[k_], want[k_]), f"{ftag} {name}: {k_} != oracle")
            kth = kt[hl.repeat((S.HEAVY_B + hl.numel() - 1) // hl.numel())[:S.HEAVY_B]]
            args_h = bounds.probe_args(eng.cfg, kth, P.minimizer)
            ref = E.lookup(eng.cfg, eng.tables, kt, None, "ids")
            S.require(torch.equal(ref["kmer_id"], S.id_tensor(ids, dev)),
                      f"{ftag}: an id did not round-trip")
            sides = {"one-hop": (E, eng.cfg, eng.tables), "DIR two-hop": (base.engine, beng.cfg,
                                                                          beng.tables),
                     "DIR one-hop": (base.engine, bcfg1, btab1)}
            lookups = {side: (lambda m=m, c=c, t=t: m.lookup(c, t, kt, None, "ids"))
                       for side, (m, c, t) in sides.items()}
            probes = {side: (lambda m=m, c=c, t=t: m.probe(c, t, kt, *args, None, "ids"))
                      for side, (m, c, t) in sides.items()}
            heavies = {side: (lambda m=m, c=c, t=t: m.probe(c, t, kth, *args_h, None, "ids"))
                       for side, (m, c, t) in sides.items()}
            ref2, ref_h = probes["one-hop"](), heavies["one-hop"]()
            for side in sides:
                ids_equal(lookups[side](), ref, f"{ftag} lookup kernel {side}")
                ids_equal(probes[side](), ref2, f"{ftag} kernel 2 {side}")
                ids_equal(heavies[side](), ref_h, f"{ftag} kernel 2, heavy lanes, {side}")
            S.log(f"  {ftag}: every side's lookup kernel and kernel 2 equal the one-hop form's "
                  f"ids on {S.SCALE_B} lanes ({int(heavy.sum())} heavy) and on {S.HEAVY_B} heavy "
                  f"lanes ({int(ref_h['found'].sum())} found); the host lookups equal the oracle "
                  f"on {len(sample)}")
            S.time_sides(ftag, "kernel 2 alone (ids), heavy lanes only", S.HEAVY_B, heavies,
                         graph=tuple(sides))
            clocks(f"{ftag}, kernel 2 on heavy lanes")
            S.time_sides(ftag, "kernel 2 alone (ids)", S.SCALE_B, probes)
            S.time_sides(ftag, "lookup kernel (ids)", S.SCALE_B, lookups)
            clocks(f"{ftag}, the mixed batch")
            for side, b in (("one-hop", bounds.probe_bytes(eng.cfg, eng.tables, kth, args_h)),
                            ("two-hop", base.bounds.probe_bytes(beng.cfg, beng.tables, kth,
                                                                args_h))):
                ms, by = bounds.bound(b)
                S.log(f"  {ftag}: kernel 2's bound on the heavy lanes, {side}: {ms:.4f} ms "
                      f"({by}, {b} bytes)")
            b = probe_bounds(eng.cfg, eng.tables, kt, args)
            S.log(f"  {ftag}: the mixed batch's bounds, one-hop: kernel 2 "
                  f"{b['probe.cu'][0]:.4f} ms ({b['probe.cu'][1]}), lookup kernel "
                  f"{b['lookup'][0]:.4f} ({b['lookup'][1]})")
            del eng, beng, btab1, sides, lookups, probes, heavies
            torch.cuda.empty_cache()
            seng = ShardedEngine(lidx, LocalMesh((1, 4), dev), host_arrs=host)
            bseng = base.parallel.ShardedEngine(bidx, base.parallel.LocalMesh((1, 4), dev),
                                                host_arrs=bhost)
            sharded = {"one-hop (1, 4)": lambda: seng.lookup_ids_device(kt),
                       "DIR two-hop (1, 4)": lambda: bseng.lookup_ids_device(kt)}
            for side, fn in sharded.items():
                ids_equal(fn(), ref, f"{ftag} {side}")
            S.time_sides(ftag, "LocalMesh (1, 4) lookup (ids)", S.SCALE_B, sharded)
            del seng, bseng, sharded, host, bhost
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
