#!/usr/bin/env python3
"""Time build variants of the lookup's CUDA kernels against each other,
and an earlier tree's kernels 1-2 against this tree's, in turns on one
card (chip_smoke.py's timing: CUDA events around windows of calls, median
of 7, sides run backwards then forwards).

    python3 lookup_ab.py [--baseline DIR] [--strings 1000]

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

Prints the card, each variant's registers (ptxas), and the ms of: the
lookup kernel (ids) per variant; kernel 2 alone (ids, kernel 1's folded
outputs given) per variant and DIR's; kernel 1 (both strands) at k31 m21
on the positives and at k65 m25 on 2^23 random kmers, this tree's against
DIR's. Every variant's output equals the tree's, checked before timing.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import torch

from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch.engine import canonical_fold
from sshash_tpu_torch.ops import packed as P

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an unpacked earlier tree: its kernels 1-2 are timed too")
    ap.add_argument("--strings", type=int, default=S.SCALE_STRINGS)
    a = ap.parse_args()
    S.phase_card()
    dev = torch.device("cuda", 0)
    libs, regs = build(variant_sources(a.baseline))
    for ln in regs:
        S.log(f"  ptxas {ln}")
    idx, host = S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                        string_len=S.STRING_LEN, seed=60, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    del host
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
    S.log(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    sys.exit(main())
