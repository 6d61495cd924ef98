#!/usr/bin/env python3
"""Time an earlier tree's access and stream-chain kernels (and its lookup
kernel) against this tree's, in turns on one card (chip_smoke.py's
timing: CUDA events around windows of calls, median of 7, sides run
backwards then forwards; the chain's calls, tens of microseconds, replay
from a CUDA graph).

    python3 access_chain_ab.py --baseline DIR [--strings 1000]

DIR is an unpacked earlier tree (`git archive <commit> | tar -x -C DIR`);
its sshash_tpu_torch/csrc/{access,stream_chain,probe}.cu build with DIR's
headers. Sides, each compiled with nvcc for sm_90a into build/access_ab/:

  tree        this tree's kernel library (kernels.build)
  chain_shfl  this tree's stream_chain.cu with each half-warp's anchor read
              by its lane 0 and passed on with __shfl_sync (the other
              lanes read nothing), in place of 16 broadcast loads
  staged      this tree's access.cu staging its rows at every width
              (kStagedW 1; the tree stages at 5 or more words)
  in_place    this tree's access.cu reading its rows in place at every
              width (kStagedW 17)
  scalar_out  this tree's access.cu storing each kmer word by word (the
              tree stores kmers of 2 and 4 words as one vector)
  baseline    DIR's sources

Shapes (chip_smoke.py's): access of 2^24 random ids on phase 7's 100M
k31 m21 canonical build (--strings strings of 100,030 chars) and of 2^23
on phase 4's 5M k31 m17 canonical build, unsharded and on one bucket
shard of (1, 4); both rounds of the two-round form on one shard of
phase 12's 5M short strings (C = 7); access at W = 5 on phase 13's 5M
k65 m25 regular build; the lookup kernel (ids) on 2^24 positives of the
100M index, 50% RC; the chain on the first 2^22-position chunk of a
168-string high-hit genome against the 100M index; the chain given
string windows on the first chunk of mixed reads (2^16 of 150 chars,
half cut with RC and 1% substitutions) through a (1, 4) ShardedStream on
the 5M index. Every side's output equals the tree's (and the tree's
chain its plain version), checked before timing. Prints the card, each
side's registers and spills (ptxas) and the ms of each side.
"""

import argparse
import contextlib
import ctypes
import functools
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import torch

from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.engine import make_lookup
from sshash_tpu_torch.layout import acc_windowed
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "sshash_tpu_torch" / "csrc"
OUT = ROOT / "build" / "access_ab"
SHFL = r'''
// lane 0 of each half-warp holds its anchor; the other lanes take it from
// there
__device__ __forceinline__ Anchor shfl_anchor(Anchor a) {
  const unsigned full = 0xFFFFFFFFu;
  a.vh = __shfl_sync(full, a.vh, 0, 16);
  a.fh = __shfl_sync(full, a.fh, 0, 16);
  a.sh = __shfl_sync(full, a.sh, 0, 16);
  a.aoff = __shfl_sync(full, a.aoff, 0, 16);
  a.asid = __shfl_sync(full, a.asid, 0, 16);
  a.akid = __shfl_sync(full, a.akid, 0, 16);
  a.abeg = __shfl_sync(full, a.abeg, 0, 16);
  a.aend = __shfl_sync(full, a.aend, 0, 16);
  a.saw = __shfl_sync(full, a.saw, 0, 16);
  a.raw = __shfl_sync(full, a.raw, 0, 16);
  a.aori = __shfl_sync(full, a.aori, 0, 16);
  a.afound = __shfl_sync(full, (int)a.afound, 0, 16) != 0;
  return a;
}

'''


def patch(src, old, new):
    if old not in src:
        raise RuntimeError(f"not found in the source: {old}")
    return src.replace(old, new)


def side_sources(baseline):
    """{side: (its sources, include directory)}."""
    chain = (CSRC / "stream_chain.cu").read_text()
    chain = patch(chain, "// Launched with a multiple of 32 threads a block",
                  SHFL + "// Launched with a multiple of 32 threads a block")
    chain = patch(chain, "  const Anchor a = in ? load_anchor(io, g, k) : Anchor{};\n",
                  "  const Anchor a = shfl_anchor(in && t == 0 ? load_anchor(io, g, k) : Anchor{});\n")
    d = OUT / "chain_shfl"
    d.mkdir(parents=True, exist_ok=True)
    (d / "stream_chain.cu").write_text(chain)
    sides = {"chain_shfl": ([d / "stream_chain.cu"], CSRC)}
    for name, first in (("staged", 1), ("in_place", 17)):
        acc = patch((CSRC / "access.cu").read_text(), "constexpr int kStagedW = 5;",
                    f"constexpr int kStagedW = {first};")
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "access.cu").write_text(acc)
        sides[name] = ([d / "access.cu"], CSRC)
    acc = patch((CSRC / "access.cu").read_text(), "  store_row(out, i, nw, km);\n}",
                "  store_kmer(out, i, nw, km);\n}")
    d = OUT / "scalar_out"
    d.mkdir(parents=True, exist_ok=True)
    (d / "access.cu").write_text(acc)
    sides["scalar_out"] = ([d / "access.cu"], CSRC)
    bsrc = Path(baseline) / "sshash_tpu_torch" / "csrc"
    sides["baseline"] = ([bsrc / n for n in ("access.cu", "stream_chain.cu", "probe.cu")], bsrc)
    return sides


def bind(lib):
    """The argument types of the entries the sides are timed through."""
    p = ctypes.c_void_p
    for name, args in (("sshash_access", [p, p, ctypes.POINTER(kernels.AccessParams),
                                          p, p, p, p, p]),
                       ("sshash_stream_chain", [ctypes.POINTER(kernels.ChainIO), ctypes.c_int64,
                                                ctypes.c_int64, p]),
                       ("sshash_lookup", [ctypes.POINTER(kernels.ProbeTables),
                                          ctypes.POINTER(kernels.ProbeParams),
                                          ctypes.POINTER(kernels.ProbeIO), p])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    return lib


def ptxas_lines(side, log):
    """Registers and spills of the access and chain kernels in nvcc's
    -Xptxas -v log (empty when the library was built earlier)."""
    lines, out = log.splitlines(), []
    for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
        m = re.search(r"Function properties for _ZN6sshash\d+(access_kernel|access_staged_kernel|"
                      r"chain_kernel)(?:ILi(\d+)E)?", ln)
        if m:
            out.append(f"{side} {m.group(1)} W{m.group(2) or '-'}: "
                       f"{re.search(r'Used \d+ registers', reg).group(0)}, {nxt.strip()}")
    return out


def build(sides):
    """This tree's library, then every side's sources, all nvcc processes
    started together. Returns ({side: ctypes library}, ptxas lines)."""
    nvcc = kernels._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (srcs, inc) in sides.items():
        for src in srcs:
            obj = OUT / f"{name}_{src.name}.o"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-c", str(src),
                   "-o", str(obj)]
            jobs[(name, obj)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)
    tree_log = kernels.build()[2]
    libs = {"tree": kernels.library()}
    regs, objs = ptxas_lines("tree", tree_log), {}
    for (name, obj), proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
        regs += ptxas_lines(name, out)
        objs.setdefault(name, []).append(str(obj))
    for name, o in objs.items():
        so = OUT / f"lib{name}.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), *o], check=True)
        libs[name] = bind(ctypes.CDLL(str(so)))
    return libs, regs


@contextlib.contextmanager
def using(lib):
    """The kernel wrappers launch through lib while inside."""
    saved, kernels._lib = kernels._lib, lib
    try:
        yield
    finally:
        kernels._lib = saved


def through(lib, fn, *a, **kw):
    with using(lib):
        return fn(*a, **kw)


def equal(a, b):
    if isinstance(b, dict):
        return all(torch.equal(a[key], b[key]) for key in b)
    return torch.equal(a, b)


def chain_call(eng, tables, packed, av, P, R, CW, lookup, swin=None):
    """The chain's arguments on one resident chunk: the step runs with its
    chain call recorded."""
    calls = []

    def chain(*a, **kw):
        calls.append((a, kw))
        return ST.stream_chain(*a, **kw)

    ST.make_stream_step(eng.cfg, P, R, CW, lookup, all_valid=av,
                        ops=ST.KERNEL_OPS._replace(chain=chain), swin=swin)(tables, packed)
    return calls[0]


def compare(tag, what, n, libs, fn, graph):
    """fn on every side equals the tree's; then every side timed in turns."""
    ref = through(libs["tree"], fn)
    for name, lib in libs.items():
        S.require(equal(through(lib, fn), ref), f"{tag}: {what}, {name} != tree")
    S.log(f"  {tag}: {what}: every side equals the tree's ({', '.join(libs)})")
    fns = {name: functools.partial(through, lib, fn) for name, lib in libs.items()}
    return S.time_sides(tag, what, n, fns, graph=tuple(fns) if graph else ())


def time_access(tag, n, libs, cfg, t, ids, shard=None, graph=False, seng=None):
    """Access on every side; on one shard of the two-round form (seng: its
    ShardedEngine) also the second round, after the shards' first rounds
    combined. Returns the tree's ms of the first."""
    ms = compare(tag, "access" if shard is None else "access, one shard", n, libs,
                 functools.partial(kernels.access_kernel, cfg, t, ids, shard), graph)
    if seng is not None:
        off = seng.mesh.pmin({(0, j): kernels.access_kernel(cfg, seng.tables[j], ids, sh)
                              for j, sh in enumerate(seng.access_shards)}, "bucket",
                             unsigned=True)[(0, 0)]
        compare(tag, "access second round, one shard", n, libs,
                functools.partial(kernels.access_read_kernel, cfg, t, off, shard), graph)
    return ms["tree"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="an unpacked earlier tree")
    ap.add_argument("--strings", type=int, default=S.SCALE_STRINGS)
    a = ap.parse_args()
    S.phase_card()
    dev = torch.device("cuda", 0)
    libs, regs = build(side_sources(a.baseline))
    for ln in regs:
        S.log(f"  ptxas {ln}")
    acc_libs = {n: libs[n] for n in ("tree", "staged", "in_place", "scalar_out", "baseline")}
    chain_libs = {n: libs[n] for n in ("tree", "chain_shfl", "baseline")}
    rng = np.random.default_rng(6)
    idx, host = S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                        string_len=S.STRING_LEN, seed=60, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    del host
    cfg, t = eng.cfg, eng.tables
    it = S.id_tensor(rng.integers(0, idx.num_kmers, S.SCALE_B), dev)
    S.log_access_sectors(cfg, t, it, time_access("100M k31 m21 canonical", S.SCALE_B, acc_libs,
                                                 cfg, t, it))
    _, km = S.positives(idx, rng, S.SCALE_B)
    kt = eng.kmers32(km)
    del km
    compare("100M k31 m21 canonical", "lookup kernel (ids)", S.SCALE_B,
            {n: libs[n] for n in ("tree", "baseline")},
            functools.partial(kernels.lookup_kernel, cfg, t, kt, None, "ids"), graph=False)
    del kt
    with tempfile.TemporaryDirectory() as tmp:
        strings = synthetic.index_strings(idx, rng.choice(idx.num_strings,
                                                          S.SCALE_STREAM_STRINGS, replace=False))
        path = os.path.join(tmp, "genome.fa")
        synthetic.write_genome(path, strings, rng)
        st = ST._DeviceStream(eng, idx.k, pmax=1 << 22, rmax_shift=12)
        st.capture = []
        for seq in ST.parse_reads(path, multiline=True):
            st.add_read(seq)
        st.finalize()
    av, packed = st.capture[0]
    ca, ckw = chain_call(eng, t, packed, av, st.P, st.R, st.CW, make_lookup(cfg, "full"))
    S.require(equal(ST.stream_chain(*ca, **ckw), ST.stream_chain_plain(*ca, **ckw)),
              "100M chunk: the tree's chain != plain")
    compare(f"100M high-hit chunk (P={st.P}, {ca[0]['found'].shape[0]} anchors)", "chain",
            st.P, chain_libs, functools.partial(ST.stream_chain, *ca, **ckw), graph=True)
    del st, packed, ca, eng, t, idx, it
    torch.cuda.empty_cache()
    idx, host = S.build("canonical", k=31, m=17, canonical=True, num_strings=S.MAIN_STRINGS,
                        string_len=S.STRING_LEN, seed=40, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    seng = ShardedEngine(idx, LocalMesh((1, 4), dev), host_arrs=host)
    it = S.id_tensor(rng.integers(0, idx.num_kmers, S.MAIN_B), dev)
    time_access("5M k31 m17 canonical", S.MAIN_B, acc_libs, eng.cfg, eng.tables, it)
    time_access("5M k31 m17 canonical (1, 4), shard 3", S.MAIN_B, acc_libs, seng.cfg,
                seng.tables[3], it, seng.access_shards[3], graph=True)
    strings = synthetic.index_strings(idx)
    half = S.MIXED_READS // 2
    reads = synthetic.cut_reads(strings, half, S.MIXED_LEN, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(half, S.MIXED_LEN, rng)
    ss = ShardedStream(seng, pmax=1 << 22, rmax_shift=4)
    ss.capture = []
    for seq in reads:
        ss.add_read(seq)
    ss.finalize()
    av, packed = ss.capture[0]
    ca, ckw = chain_call(seng, None, packed, av, ss.P, ss.R, ss.CW, seng._lookup_fn(0, "full"),
                         swin=functools.partial(ss._swin, 0))
    S.require("swin" in ckw and equal(ST.stream_chain(*ca, **ckw),
                                      ST.stream_chain_plain(*ca, **ckw)),
              "mixed (1, 4) chunk: the tree's chain given windows != plain")
    compare(f"mixed 5M canonical (1, 4) chunk (P={ss.P}, {ca[0]['found'].shape[0]} anchors)",
            "chain given windows", ss.P, chain_libs,
            functools.partial(ST.stream_chain, *ca, **ckw), graph=True)
    del ss, packed, ca, ckw, seng, eng, idx, host
    torch.cuda.empty_cache()
    idx, host = S.build("short strings regular", k=31, m=17, canonical=False,
                        num_strings=S.SHORT_STRINGS, string_len=S.SHORT_LEN, seed=43, threads=8)
    seng = ShardedEngine(idx, LocalMesh((1, 4), dev), host_arrs=host)
    S.require(not acc_windowed(seng.cfg.k, seng.cfg.access_C), "short strings: windowed rows")
    it = S.id_tensor(rng.integers(0, idx.num_kmers, S.MAIN_B), dev)
    time_access(f"5M short strings (C={seng.cfg.access_C}) (1, 4), shard 3", S.MAIN_B, acc_libs,
                seng.cfg, seng.tables[3], it, seng.access_shards[3], graph=True, seng=seng)
    del seng, idx, host
    idx, host = S.build(f"k{S.WIDE_K} regular", k=S.WIDE_K, m=S.WIDE_M, canonical=False,
                        num_strings=S.WIDE_STRINGS["regular"], string_len=S.WIDE_STRING_LEN,
                        seed=130 + S.WIDE_STRINGS["regular"], threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    it = S.id_tensor(rng.integers(0, idx.num_kmers, S.MAIN_B), dev)
    time_access(f"5M k{S.WIDE_K} m{S.WIDE_M} regular (W={eng.cfg.W})", S.MAIN_B, acc_libs,
                eng.cfg, eng.tables, it)
    S.log(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    sys.exit(main())
