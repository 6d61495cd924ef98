"""Build and bind the port's CUDA kernels (csrc/), with launch counters.

Fourteen CUDA sources: probe carries lookup, as one launch of the lookup
kernel (kernel 1's minimizers, the canonical fold or the RC retry, and the
probe, per thread) and kernel 2 alone, over the whole table or in its
shard form, which the bucket-sharded engine calls after minimizer (kernel
1); lookup_ranks the lookup kernel's lane over the stream's missed lanes
in rank space, up to their count on the device, after minimizer's rank
form, and kernel 2's rank form (a list pass that lists the active ranks
with their keys, then its shard form's probe over the list, each rank on
its owner shard, shared with probe in shard.cuh), which the bucket-sharded
stream calls; access,
iterator, weight and neighbours the other point queries; scan, stream_anchor, stream_chain and stream_derive
the stream step; check the sanitizer's postconditions (debug.py);
read_at2 the read over the interleaved (NW, 2) table
(ops/packed.read_kmers_at2); combine the elementwise reductions of a
LocalMesh (parallel/mesh.py). A source may hold several wrappers, each
with its own count; SOURCE_KERNELS maps them. The sources that hold a
kmer a thread are templates on the kmer's width in u32 words: 1..8 one by
one, and one runtime-width form for 9..16 (k <= 255, layout.MAX_K); the
neighbours kernels take four output words a thread (one where B*W is not
a multiple of 4) and have none. Kernel 2, access, weight and the chain
also serve the shards of the bucket-sharded engine (parallel/): each
takes its shard's range (kernel 2's shard form stores only the lanes the
shard owns), and access_read and stream_swin are the second round and
the window read that its split tables need.

The sources compile with nvcc for sm_90a, one nvcc process per source, all
started together, and link into one shared library with a plain C
interface, loaded with ctypes. The library lands in
build/sshash_tpu_torch/ at the repo root, named by a hash of the sources,
and is built at first use, so a fresh checkout builds it on its first
CUDA lookup. Nothing builds or loads at import: machines without nvcc
import this module and run the plain versions.

Each launch wrapper checks its tensors, allocates its outputs with
torch.empty, launches on the current stream of its tensors' card without
synchronising, raises if the launch returned a CUDA error, and adds one to
its `launches` count. The wrappers take CUDA tensors only; each entry
point (ops/packed.minimizer, .minimizer_ranks, .neighbour_variants,
.scan_ex, .compact and .read_kmers_at2; engine.lookup, .lookup_ranks,
.probe, .rank_lists, .probe_ranks, .access, .access_read, .iterate and
.weight;
streaming.stream_anchors, .stream_kmers, .stream_chain, .stream_swin,
.stream_heads, .stream_round2, .stream_merge and .stream_count;
debug.check; parallel.mesh.combine) is made by `by_device`, which
chooses between a wrapper and its plain version by the device of one
argument and runs the wrapper with that card current (the C entries
launch on the current card, and cache their occupancy per card).

Synchronous launches (`sync_launches`, on inside debug.debug_mode): every
wrapper then waits for its kernel and raises on any CUDA error, so a fault
shows at the launch that caused it (the counterpart of the JAX package's
jax_debug_nans trap, debug.py).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from .layout import (MAX_ROW_SHARDS, WHOLE_TABLE, AccessShard, acc_width, acc_win_words,
                     acc_windowed, cand_block_width, check_access, check_fields,
                     check_probe_shard, check_rank_probe, packed_rows, rank_probe_shards,
                     row_width)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("minimizer.cu", "probe.cu", "lookup_ranks.cu", "access.cu", "iterator.cu",
           "weight.cu", "neighbours.cu", "scan.cu", "stream_anchor.cu", "stream_chain.cu",
           "stream_derive.cu", "check.cu", "read_at2.cu", "combine.cu")
HEADERS = ("grid.cuh", "minimizer.cuh", "packed.cuh", "probe.cuh", "scan.cuh", "shard.cuh",
           "stage.cuh", "tables.cuh", "u64.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sshash_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# an unsharded access: every id block and string word
WHOLE_ACCESS = AccessShard(0, 1 << 32, 0, 1 << 32)
# the single-pass scans' tiles (csrc/scan.cu, stream_derive.cu): int32
# elements of a scan tile, flags of a compaction tile, ranks of a round-2
# tile
SCAN_TILE, COMPACT_TILE, ROUND2_TILE = 4096, 16384, 8192
# the weight kernel's staged sample (csrc/weight.cu kWeightSample): its
# stride s is the smallest power of two that leaves fewer entries
WEIGHT_SAMPLE = 16384

_lib = None
# debug.debug_mode: wait for every launch and raise on any CUDA error
sync_launches = False


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsshash_tpu_torch_{h.hexdigest()[:16]}.so"


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(cmds):
    """Run the commands concurrently; raise if any failed. Returns their
    stderr and their seconds, in order."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs, secs = [None] * len(procs), [0.0] * len(procs)

    def wait(i):  # drains the pipes as the process writes; notes its end
        outs[i] = procs[i].communicate()
        secs[i] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for t in waits:
        t.start()
    for t in waits:
        t.join()
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return [err for _, err in outs], secs


def build():
    """Compile the kernels unless the library for these sources exists.
    Returns (path, seconds spent compiling, nvcc's output, {source: seconds
    of its nvcc})."""
    path = library_path()
    if path.exists():
        return path, 0.0, "", {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        log, secs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                               str(CSRC / src), "-o", obj] for src, obj in zip(SOURCES, objs)])
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])[0]
        os.replace(lib, path)
    return path, time.perf_counter() - t0, "".join(log), dict(zip(SOURCES, secs))


# ctypes mirrors of the structs in csrc/probe.cu (8-byte fields only)
_TABLE_NAMES = ("cw_row", "mid_rows", "sk_hrows", "pilots", "mphf_seedrows",
                "sk_pilots", "sk_seedrows")


class ProbeTables(ctypes.Structure):
    _fields_ = [f for name in _TABLE_NAMES
                for f in ((name, ctypes.c_void_p), (name + "_n", ctypes.c_int64))] \
        + [("sk_params", ctypes.c_void_p)]


_PARAM_NAMES = ("B", "W", "k", "m", "canonical", "full", "win_words",
                "vbits_words", "max_start_word", "row_w", "blk_w", "c1_in_row",
                "has_skew", "row_v2", "skew_partitioned",
                "mphf_partitioned", "mphf_P", "mphf_part_table", "mphf_part_buckets",
                "mphf_nbuckets", "mphf_table", "pilot_w", "sk_pilot_w",
                "slot_lo", "slot_hi", "hrow_lo", "hrow_hi", "store", "fill", "rc_round")


class ProbeParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in _PARAM_NAMES] \
        + [("mphf_seedmix", ctypes.c_uint64), ("magic", ctypes.c_uint64)]


_IO_NAMES = ("kmers", "kmers_rc", "minval", "minpos", "minpos2", "active",
             "kmer_id", "kmer_orientation", "minimizer_found", "found",
             "kmer_id_in_string", "kmer_offset", "string_id", "string_begin",
             "string_end", "hrow", "hrow_in", "count", "minval_r", "minpos_r", "packed",
             "slot_out", "slot_in", "list", "list_count")
# the result fields of ProbeIO, in order (the hand-off's "hrow" out last)
_OUT_NAMES = _IO_NAMES[6:16]


class ProbeIO(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _IO_NAMES]


class AccessParams(ctypes.Structure):
    """Mirror of csrc/access.cu AccessParams."""
    _fields_ = [(n, ctypes.c_int64) for n in ("B", "W", "k", "C", "windowed", "win_words",
                                               "row_w", "rows_n", "strings_n", "blk_lo",
                                               "blk_hi", "word_lo", "word_hi")]


def library():
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        path = build()[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.sshash_minimizer.argtypes = [p, i64, i64, i64, i64, ctypes.c_uint64,
                                         p, p, p, p, p, p]
        lib.sshash_minimizer.restype = ctypes.c_int
        lib.sshash_minimizer_ranks.argtypes = [p, i64, i64, i64, i64, ctypes.c_uint64,
                                               p, p, p, p, p, p]
        lib.sshash_minimizer_ranks.restype = ctypes.c_int
        lib.sshash_probe.argtypes = [ctypes.POINTER(ProbeTables),
                                     ctypes.POINTER(ProbeParams),
                                     ctypes.POINTER(ProbeIO), p]
        lib.sshash_probe.restype = ctypes.c_int
        lib.sshash_lookup.argtypes = lib.sshash_probe.argtypes
        lib.sshash_lookup.restype = ctypes.c_int
        lib.sshash_lookup_ranks.argtypes = lib.sshash_probe.argtypes
        lib.sshash_lookup_ranks.restype = ctypes.c_int
        lib.sshash_probe_ranks.argtypes = [ctypes.POINTER(ProbeTables), i64, i64, i64,
                                           ctypes.POINTER(ProbeParams),
                                           ctypes.POINTER(ProbeIO), p]
        lib.sshash_probe_ranks.restype = ctypes.c_int
        lib.sshash_rank_lists.argtypes = lib.sshash_probe.argtypes
        lib.sshash_rank_lists.restype = ctypes.c_int
        lib.sshash_probe_occupancy.argtypes = [ctypes.POINTER(ProbeParams), i64,
                                               ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_int)]
        lib.sshash_probe_occupancy.restype = ctypes.c_int
        lib.sshash_access.argtypes = [p, p, ctypes.POINTER(AccessParams), p, p, p, p, p]
        lib.sshash_access_occupancy.argtypes = [ctypes.POINTER(AccessParams),
                                                ctypes.POINTER(ctypes.c_int),
                                                ctypes.POINTER(ctypes.c_int)]
        lib.sshash_chain_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_int)]
        lib.sshash_iterate.argtypes = [p, i64, p, i64, i64, p, p]
        lib.sshash_weight.argtypes = [p, i64, p, i64, p, i64, p, i64, i64, p, p]
        lib.sshash_weight_plan.argtypes = [i64, i64, ctypes.POINTER(ctypes.c_int64)]
        lib.sshash_neighbours.argtypes = [p, i64, i64, i64, p, p]
        lib.sshash_scan_scratch.argtypes = [i64, i64]
        lib.sshash_scan_scratch.restype = i64
        lib.sshash_round2_scratch.argtypes = [i64]
        lib.sshash_round2_scratch.restype = i64
        lib.sshash_scan.argtypes = [p, i64, p, p, p]
        lib.sshash_compact.argtypes = [p, i64, p, p, p, p]
        lib.sshash_stream_anchors.argtypes = [p, p, p, i64, i64, p, i64, i64, p, p, p, p, p]
        lib.sshash_stream_kmers.argtypes = [p, i64, p, p, p, p, i64, i64, p, p]
        lib.sshash_stream_chain.argtypes = [ctypes.POINTER(ChainIO), i64, i64, p]
        lib.sshash_stream_swin.argtypes = [p, p, i64, p, i64, i64, i64, i64, p, p]
        lib.sshash_stream_heads.argtypes = [p, p, p, p, p, i64, i64, p, p]
        lib.sshash_stream_round2.argtypes = [p, p, p, p, i64, p, p, p]
        lib.sshash_stream_merge.argtypes = [ctypes.POINTER(MergeIO), i64, p]
        lib.sshash_stream_count.argtypes = [p, p, p, p, p, p, p, i64, p, p]
        lib.sshash_check.argtypes = [p, p, p, p, p, i64, i64, i64, p, p]
        lib.sshash_read_at2.argtypes = [p, i64, p, i64, i64, p, p, p]
        lib.sshash_combine.argtypes = [ctypes.POINTER(ctypes.c_void_p), i64, i64, i64, i64, i64,
                                       p, p]
        lib.sshash_last_error.argtypes = []
        for name in ("sshash_access", "sshash_access_occupancy", "sshash_chain_occupancy",
                     "sshash_iterate", "sshash_weight", "sshash_weight_plan", "sshash_neighbours",
                     "sshash_scan", "sshash_compact", "sshash_stream_anchors",
                     "sshash_stream_kmers", "sshash_stream_chain", "sshash_stream_swin",
                     "sshash_stream_heads", "sshash_stream_round2", "sshash_stream_merge",
                     "sshash_stream_count", "sshash_check", "sshash_read_at2",
                     "sshash_combine", "sshash_last_error"):
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


# every entry point by_device made, for the tests: each has .kernel,
# .plain and .arg
ENTRY_POINTS = []


def by_device(kernel, plain, what, arg=0):
    """The entry point of one kernel: a call runs `kernel` (a wrapper
    below) when positional argument `arg` is a CUDA tensor, inside
    torch.cuda.device(its card) so that the C entry launches there, `plain`
    when it is a CPU tensor, and raises on any other device. Both take the
    entry's arguments. The entry keeps kernel and plain as its attributes
    and calls them from there."""

    def entry(*args, **kw):
        dev = args[arg].device
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return entry.kernel(*args, **kw)
        if dev.type == "cpu":
            return entry.plain(*args, **kw)
        raise ValueError(f"no {what} kernel for device {dev}")

    entry.kernel, entry.plain, entry.arg = kernel, plain, arg
    entry.__doc__ = (f"{what} entry: {kernel.__name__} on a CUDA tensor, {plain.__name__} "
                     f"on a CPU tensor; any other device raises.")
    ENTRY_POINTS.append(entry)
    return entry


def _check(t, name, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    if sync_launches:
        torch.cuda.synchronize()
        err = library().sshash_last_error()
        if err != 0:
            raise RuntimeError(f"{what} failed on the device: CUDA error {err}")


def _check_table(t, name, dev, cols=None):
    _check(t, name, torch.int32)
    if t.device != dev:
        raise ValueError(f"table {name} is on {t.device}, queries on {dev}")
    if t.shape[0] < 1 or (cols is not None and tuple(t.shape[1:]) != (cols,)):
        raise ValueError(f"table {name} has shape {tuple(t.shape)}")


def _check_staged(t, name):
    """A table the access kernel stages (kmers of 5 or more words) with
    16-byte loads of the aligned segments that cover a row: such a segment
    lies in the table's allocation only if its storage starts 16-byte
    aligned (a slice of a PyTorch allocation does)."""
    if t.untyped_storage().data_ptr() % 16:
        raise ValueError(f"table {name}: its storage must start 16-byte aligned")


def _ids(ids):
    if ids.dim() != 1:
        raise ValueError(f"ids must be (B,), got {tuple(ids.shape)}")
    _check(ids, "ids", torch.int32)
    return ids.shape[0]


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def minimizer_kernel(kmers32, k, m, magic, both=False):
    """Kernel 1 on (B, W) int32 kmers (u32 bits) -> (mv int64, mp int32),
    plus (kmers_rc32, mv_r, mp_r) when both=True. Same contract as
    ops.packed.minimizer_plain."""
    W = (2 * k + 31) // 32
    if kmers32.dim() != 2:
        raise ValueError(f"kmers32 must be (B, {W}), got {tuple(kmers32.shape)}")
    B = kmers32.shape[0]
    _check(kmers32, "kmers32", torch.int32, (B, W))
    lib = library()
    dev = kmers32.device
    mv = torch.empty(B, dtype=torch.int64, device=dev)
    mp = torch.empty(B, dtype=torch.int32, device=dev)
    rc = mv_r = mp_r = None
    if both:
        rc = torch.empty_like(kmers32)
        mv_r, mp_r = torch.empty_like(mv), torch.empty_like(mp)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.sshash_minimizer(kmers32.data_ptr(), B, W, k, m, magic & (2 ** 64 - 1),
                               mv.data_ptr(), mp.data_ptr(), ptr(rc), ptr(mv_r),
                               ptr(mp_r), _stream(dev))
    _raise_on(err, "minimizer_kernel")
    minimizer_kernel.launches += 1
    return (mv, mp, rc, mv_r, mp_r) if both else (mv, mp)


minimizer_kernel.launches = 0


# kernel 1's rank form's outputs: mv_f, mp_f, mv_r, mp_r
_RANK_MINS = (torch.int64, torch.int32, torch.int64, torch.int32)


def minimizer_ranks_kernel(kmers32, count, k, m, magic):
    """Kernel 1's rank form on (P, W) int32 kmers (u32 bits) compacted in
    rank order, up to the int32 (1,) device count: (mv_f int64, mp_f int32,
    mv_r int64, mp_r int32), each (P,), both strands' minimizers at the
    rows below the count; the rows past it are not written. Same contract
    as ops.packed.minimizer_ranks_plain."""
    W = (2 * k + 31) // 32
    if kmers32.dim() != 2:
        raise ValueError(f"kmers32 must be (P, {W}), got {tuple(kmers32.shape)}")
    Pn = kmers32.shape[0]
    _check(kmers32, "kmers32", torch.int32, (Pn, W))
    _scalar(count, "count")
    dev = kmers32.device
    out = [torch.empty(Pn, dtype=dt, device=dev) for dt in _RANK_MINS]
    err = library().sshash_minimizer_ranks(kmers32.data_ptr(), Pn, W, k, m, magic & (2 ** 64 - 1),
                                           count.data_ptr(), *(t.data_ptr() for t in out),
                                           _stream(dev))
    _raise_on(err, "minimizer_ranks_kernel")
    minimizer_ranks_kernel.launches += 1
    return tuple(out)


minimizer_ranks_kernel.launches = 0


def _probe_launch(cfg, tables, kmers32, active, fields, shard=None, store=0, fill=False,
                  rc_round=False):
    """What both probe entries check and pass: the kmers' and tables'
    shapes, types and device; returns (B, device, ProbeTables, ProbeParams,
    the result tensors, new unless store is the shard form's)."""
    check_fields(cfg, fields)
    if kmers32.dim() != 2:
        raise ValueError(f"kmers32 must be (B, {cfg.W}), got {tuple(kmers32.shape)}")
    B = kmers32.shape[0]
    _check(kmers32, "kmers32", torch.int32, (B, cfg.W))
    if active is not None:
        _check(active, "active", torch.bool, (B,))
    dev = kmers32.device
    t = {}
    for name in _TABLE_NAMES + ("sk_params",):
        _check(tables[name], name, torch.int32)
        if tables[name].device != dev:
            raise ValueError(f"table {name} is on {tables[name].device}, queries on {dev}")
        t[name] = tables[name]
    blk_w, row_w = cand_block_width(cfg), row_width(cfg)
    if tuple(t["cw_row"].shape[1:]) != (row_w,):
        raise ValueError(f"cw_row must have {row_w} columns, got {tuple(t['cw_row'].shape)}")
    for name in ("mid_rows", "sk_hrows"):
        if tuple(t[name].shape[1:]) != (blk_w,):
            raise ValueError(f"{name} must have {blk_w} columns")
    if tuple(t["sk_params"].shape) != (8, 8):
        raise ValueError("sk_params must be (8, 8)")

    out = None if store else {name: torch.empty(B, dtype=dt, device=dev)
                              for name, dt in result_dtypes(fields).items()}
    tab = ProbeTables(*(v for n in _TABLE_NAMES
                        for v in (t[n].data_ptr(), t[n].shape[0])),
                      t["sk_params"].data_ptr())
    return B, dev, tab, probe_params(cfg, B, fields, shard, store, fill, rc_round), out


def result_dtypes(fields):
    """Kernel 2's and the lookup kernel's result fields and their dtypes
    ("full" or "ids"; "stream": the stream's fields, STREAM_FIELDS, of the
    rank forms)."""
    out = {"kmer_id": torch.int32, "kmer_orientation": torch.int32,
           "minimizer_found": torch.bool, "found": torch.bool}
    if fields == "stream":
        out["string_id"] = torch.int32
    if fields == "full":
        out.update((name, torch.int32) for name in ("kmer_id_in_string", "kmer_offset",
                                                     "string_id", "string_begin", "string_end"))
    return out


# csrc/probe.cuh StoreMode
STORE_ALL, STORE_OWNED, STORE_PACKED = 0, 1, 2


def probe_params(cfg, B, fields="ids", shard=None, store=STORE_ALL, fill=False, rc_round=False):
    """The ProbeParams of csrc/probe.cu for B lanes of cfg's layout."""
    sh = shard or WHOLE_TABLE
    return ProbeParams(
        B=B, W=cfg.W, k=cfg.k, m=cfg.m, canonical=int(cfg.canonical),
        full=int(fields == "full"), win_words=cfg.win_words, vbits_words=cfg.vbits_words,
        max_start_word=cfg.max_start_word, row_w=row_width(cfg), blk_w=cand_block_width(cfg),
        c1_in_row=int(cfg.c1_in_row), has_skew=int(cfg.has_skew), row_v2=int(cfg.row_v2),
        skew_partitioned=int(cfg.skew_partitioned),
        mphf_partitioned=int(cfg.mphf_partitioned), mphf_P=cfg.mphf_P,
        mphf_part_table=cfg.mphf_part_table, mphf_part_buckets=cfg.mphf_part_buckets,
        mphf_nbuckets=cfg.mphf_nbuckets, mphf_table=cfg.mphf_table,
        pilot_w=cfg.pilot_w, sk_pilot_w=cfg.sk_pilot_w, slot_lo=sh.slot_lo,
        slot_hi=sh.slot_hi, hrow_lo=sh.hrow_lo, hrow_hi=sh.hrow_hi, store=store,
        fill=int(fill), rc_round=int(rc_round),
        mphf_seedmix=cfg.mphf_seedmix, magic=cfg.magic & (2 ** 64 - 1))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _shard_io(res, fields, B, dev, handoff, packed, hrows, slots):
    """Kernel 2's output checks, in every form (the result tensors of
    fields, or the packed buffer; the hand-off's rows out or hrows in; the
    lanes' slots), and the ProbeIO fields that point at them."""
    if packed:
        _check(res["packed"], "packed", torch.int32, (packed_rows(fields), B))
    else:
        for name, dt in result_dtypes(fields).items():
            _check(res[name], name, dt, (B,))
    if hrows is not None:
        _check(hrows, "hrows", torch.int32, (B,))
    elif handoff:
        _check(res["hrow"], "hrow", torch.int32, (B,))
    if slots:
        _check(res["slot"], "slot", torch.int32, (B,))
    for name, t in res.items():
        if t.device != dev:
            raise ValueError(f"out[{name!r}] is on {t.device}, queries on {dev}")
    io = {} if packed else {n: res[n].data_ptr() for n in result_dtypes(fields)}
    io.update(hrow=_ptr(res.get("hrow")) if handoff and hrows is None else None,
              hrow_in=_ptr(hrows), packed=_ptr(res.get("packed")),
              slot_out=_ptr(res["slot"]) if slots == "store" else None,
              slot_in=_ptr(res["slot"]) if slots == "read" else None)
    return io


def probe_kernel(cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2=None,
                 active=None, fields="full", shard=None, hrows=None, out=None, fill=False,
                 rc_round=False, slots=None):
    """Kernel 2: the fused-row probe, in either row format and either skew
    form. Over the whole table it returns new result tensors: kmer_id /
    kmer_orientation / minimizer_found / found and, with fields="full" (v1
    rows only), the string fields (u32 fields as int32 bits). Its shard
    form (shard: a layout.ProbeShard, tables the shard's) stores into out
    and returns it: the lanes the shard owns into the result tensors a
    mesh row's shards share, or every lane into {"packed": (F, B) int32}
    (layout.check_probe_shard has the forms; slots="store" / "read": the
    lanes' MPHF slots into / from out["slot"]). Same contract as
    engine.probe_plain."""
    handoff, packed = check_probe_shard(cfg, shard, hrows, out, fill, rc_round, slots)
    store = STORE_ALL if shard is None else STORE_PACKED if packed else STORE_OWNED
    B, dev, tab, prm, new = _probe_launch(cfg, tables, kmers32, active, fields, shard, store,
                                          fill, rc_round)
    if B >= 1 << 32:
        raise ValueError(f"kernel 2 takes fewer than 2^32 lanes, got {B}")
    if (kmers_rc32 is not None) != cfg.canonical:
        raise ValueError("kmers_rc32 is required in canonical mode and only there")
    if kmers_rc32 is not None:
        _check(kmers_rc32, "kmers_rc32", torch.int32, (B, cfg.W))
    _check(minval, "minval", torch.int64, (B,))
    _check(minpos, "minpos", torch.int32, (B,))
    if minpos2 is not None:
        _check(minpos2, "minpos2", torch.int32, (B,))
    res = new if out is None else out
    io = ProbeIO(kmers=kmers32.data_ptr(), kmers_rc=_ptr(kmers_rc32), minval=minval.data_ptr(),
                 minpos=minpos.data_ptr(), minpos2=_ptr(minpos2), active=_ptr(active),
                 **_shard_io(res, fields, B, dev, handoff, packed, hrows, slots))
    err = library().sshash_probe(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                                 _stream(dev))
    _raise_on(err, "probe_kernel")
    probe_kernel.launches += 1
    return res


probe_kernel.launches = 0


def lookup_kernel(cfg, tables, kmers32, active=None, fields="full"):
    """The lookup kernel: the whole batched lookup of (B, W) int32 kmers in
    one launch (both strands' minimizers, the canonical fold or the
    regular mode's RC retry, and the probe, per thread), in either row
    format and either skew form. Same contract as engine.lookup_plain:
    kmer_id / kmer_orientation / minimizer_found / found and, with
    fields="full" (v1 rows only), the string fields; active (bool) limits
    the lookup to those lanes, the others report not found."""
    B, dev, tab, prm, out = _probe_launch(cfg, tables, kmers32, active, fields)
    io = ProbeIO(kmers32.data_ptr(), None, None, None, None, _ptr(active),
                 *(_ptr(out.get(n)) for n in _OUT_NAMES))
    err = library().sshash_lookup(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                                  _stream(dev))
    _raise_on(err, "lookup_kernel")
    lookup_kernel.launches += 1
    return out


lookup_kernel.launches = 0

# the rank-space lookup's result fields: those the stream reads
STREAM_FIELDS = ("found", "minimizer_found", "string_id", "kmer_id", "kmer_orientation")


def lookup_ranks_kernel(cfg, tables, kmers32, mins, active, count):
    """The lookup kernel's lane over the ranks below the int32 (1,) device
    count of (P, W) int32 kmers (the stream's missed lanes, compacted),
    from their minimizers mins = (mv_f, mp_f, mv_r, mp_r) (kernel 1's rank
    form): STREAM_FIELDS, each (P,) (u32 fields as int32 bits; found and
    minimizer_found bool). An active rank below the count is looked up; an
    inactive one reports not found (found and minimizer_found False, ids
    0xFFFFFFFF, orientation FORWARD); ranks past the count are not written.
    v1 rows only (streaming needs them). Same contract as
    engine.lookup_ranks_plain."""
    if cfg.row_v2:
        raise ValueError("the rank-space lookup serves v1 rows (streaming) only")
    if active is None:
        raise ValueError("the rank-space lookup takes an active mask")
    B, dev, tab, prm, out = _probe_launch(cfg, tables, kmers32, active, "ids")
    _scalar(count, "count")
    for t, name, dt in zip(mins, ("mv_f", "mp_f", "mv_r", "mp_r"), _RANK_MINS):
        _check(t, name, dt, (B,))
    out["string_id"] = torch.empty(B, dtype=torch.int32, device=dev)
    io = ProbeIO(kmers=kmers32.data_ptr(), active=active.data_ptr(), count=count.data_ptr(),
                 **dict(zip(("minval", "minpos", "minval_r", "minpos_r"),
                            (t.data_ptr() for t in mins))),
                 **{n: out[n].data_ptr() for n in STREAM_FIELDS})
    err = library().sshash_lookup_ranks(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                                        _stream(dev))
    _raise_on(err, "lookup_ranks_kernel")
    lookup_ranks_kernel.launches += 1
    return {n: out[n] for n in STREAM_FIELDS}


lookup_ranks_kernel.launches = 0


def _rank_io(cfg, tables, kmers32, mins, active, count, shard, store, fill, rc_round, fields):
    """What both entries of kernel 2's rank form check and pass: (B,
    device, ProbeTables, ProbeParams, the ProbeIO fields of the kmers,
    minimizers, active and count)."""
    B, dev, tab, prm, _ = _probe_launch(cfg, tables, kmers32, active, "ids", shard, store, fill,
                                        rc_round)
    prm.full = int(fields == "full")
    if B >= 1 << 31:
        raise ValueError(f"kernel 2's rank form takes fewer than 2^31 ranks, got {B}")
    _scalar(count, "count")
    for t, name, dt in zip(mins, ("mv_f", "mp_f", "mv_r", "mp_r"), _RANK_MINS):
        _check(t, name, dt, (B,))
    io = dict(kmers=kmers32.data_ptr(), active=_ptr(active), count=count.data_ptr(),
              **dict(zip(("minval", "minpos", "minval_r", "minpos_r"),
                         (t.data_ptr() for t in mins))))
    return B, dev, tab, prm, io


def _rank_list(lists, B, dev):
    """The ProbeIO fields of a list pass's list ({"entries": (B, 2),
    "count": (1,)} int32 on dev)."""
    entries, count = lists["entries"], lists["count"]
    _check(entries, "lists['entries']", torch.int32)
    _check(count, "lists['count']", torch.int32)
    if entries.shape != (B, 2) or count.shape != (1,) or entries.device != dev \
            or count.device != dev:
        raise ValueError(f"lists must hold ({B}, 2) entries and a (1,) count on {dev}")
    return dict(list=entries.data_ptr(), list_count=count.data_ptr())


def rank_lists_kernel(cfg, tables, kmers32, mins, active, count, fields, shard, out, fill=False,
                      rc_round=False, hrows=None):
    """The list pass of kernel 2's rank form (csrc/lookup_ranks.cu
    sshash_rank_lists, the kernel in csrc/shard.cuh): over the ranks below
    the int32 (1,) device count of (P, W) int32 kmers, each active rank
    (not found yet, in the owned form's RC round and hand-off passes) whose
    key, the MPHF slot of its minimizer (kernel 1's rank-form mins, as
    probe_ranks_kernel folds them) or its handed sk_hrows row with hrows,
    is in the range of `shard` (a layout.ProbeShard: a mesh row's keys, or
    in the packed form the rank's shard's) goes to one list; the ranks it
    does not take are stored into out at once (with fill the inactive ones
    as not found; in the packed form the combine's identity). tables: any
    shard's of the row (the MPHF is whole on each). Returns {"entries": (P,
    2) int32 (rank, key) pairs, the first "count"[0] in no set order,
    "count": (1,) int32}. Same contract as engine.rank_lists_plain (which
    orders the list by rank)."""
    handoff, packed = check_rank_probe(cfg, fields, shard, hrows, out, fill, rc_round)
    store = STORE_PACKED if packed else STORE_OWNED
    B, dev, tab, prm, io = _rank_io(cfg, tables, kmers32, mins, active, count, shard, store, fill,
                                    rc_round, fields)
    lists = {"entries": torch.empty((B, 2), dtype=torch.int32, device=dev),
             "count": torch.empty(1, dtype=torch.int32, device=dev)}
    io = ProbeIO(**io, **_rank_list(lists, B, dev),
                 **_shard_io(out, fields, B, dev, handoff, packed, hrows, None))
    err = library().sshash_rank_lists(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                                      _stream(dev))
    _raise_on(err, "rank_lists_kernel")
    rank_lists_kernel.launches += 1
    return lists


rank_lists_kernel.launches = 0


def probe_ranks_kernel(cfg, tables, kmers32, mins, active, count, fields, shard, out, *, lists,
                       rc_round=False, hrows=None):
    """Kernel 2's rank form (csrc/lookup_ranks.cu sshash_probe_ranks, the
    list probe in csrc/shard.cuh): its shard
    form over the ranks below the int32 (1,) device count of (P, W) int32
    kmers compacted in rank order (the bucket-sharded stream's missed lanes,
    or its anchors), from kernel 1's rank-form minimizers mins = (mv_f,
    mp_f, mv_r, mp_r): the canonical fold, or in regular mode the forward
    strand, or with rc_round the RC strand (the RC kmer formed in the
    thread). active: bool (P,) or None (every rank below the count). Stores
    into out as the shard form does (layout.check_rank_probe has the forms):
    the owned form's result tensors (fields "full", or "stream", the
    stream's five), or {"packed": (packed_rows("full"), P)}, where rc_round
    probes the RC strand and the merge follows the combine. lists: the
    list pass's result (rank_lists_kernel), which made the stores of the
    ranks it did not list; its entries are probed here. shard: one
    layout.ProbeShard (tables its dict), or a mesh row's consecutive shards
    (tables a dict each), every listed rank probed on its owner shard's
    tables, one launch for each layout.MAX_ROW_SHARDS shards. Ranks at or
    past the count are not written, nor hrows read there. v1 rows only.
    Same contract as engine.probe_ranks_plain."""
    shards, tabs, handoff, packed, lo, per = rank_probe_shards(cfg, fields, shard, tables, hrows,
                                                               out, rc_round)
    store = STORE_PACKED if packed else STORE_OWNED
    B, dev, tab, prm, io = _rank_io(cfg, tabs[0], kmers32, mins, active, count, shards[0], store,
                                    False, rc_round, fields)
    row = [tab] + [_probe_launch(cfg, t, kmers32, active, "ids", None, store)[2]
                   for t in tabs[1:]]
    io = ProbeIO(**io, **_rank_list(lists, B, dev),
                 **_shard_io(out, fields, B, dev, handoff, packed, hrows, None))
    for g in range(0, len(row), MAX_ROW_SHARDS):
        group = row[g:g + MAX_ROW_SHARDS]
        err = library().sshash_probe_ranks((ProbeTables * len(group))(*group), len(group),
                                           lo + g * per, per, ctypes.byref(prm),
                                           ctypes.byref(io), _stream(dev))
        _raise_on(err, "probe_ranks_kernel")
        probe_ranks_kernel.launches += 1
    return out


probe_ranks_kernel.launches = 0


def probe_occupancy(cfg, lookup=True):
    """(resident blocks an SM, threads a block) of the lookup kernel (or of
    kernel 2) on the current card for cfg's layout."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = library().sshash_probe_occupancy(ctypes.byref(probe_params(cfg, 1)), int(lookup),
                                           ctypes.byref(blocks), ctypes.byref(threads))
    _raise_on(err, "probe_occupancy")
    return blocks.value, threads.value


def access_kernel(cfg, tables, ids, blocks=None):
    """Access: (B,) int32 ids -> (B, W) int32 kmers, over the whole table or
    one bucket shard's (blocks: a layout.AccessShard). Same contract as
    engine.access_plain: a shard's lanes of other shards' blocks read zeros,
    and in the two-round form a sharded call returns the char offsets."""
    check_access(cfg)
    B = _ids(ids)
    dev = ids.device
    windowed = acc_windowed(cfg.k, cfg.access_C)
    rows, s32 = tables["acc_rows"], tables["strings32"]
    _check_table(rows, "acc_rows", dev, acc_width(cfg))
    _check_table(s32, "strings32", dev)
    _check_staged(rows, "acc_rows")
    _check_staged(s32, "strings32")
    offsets = blocks is not None and not windowed
    out = torch.empty((B,) if offsets else (B, cfg.W), dtype=torch.int32, device=dev)
    sh = blocks or WHOLE_ACCESS
    prm = access_params(cfg, B, rows, s32, sh)
    err = library().sshash_access(rows.data_ptr(), s32.data_ptr(), ctypes.byref(prm),
                                  ids.data_ptr(), None, None if offsets else out.data_ptr(),
                                  out.data_ptr() if offsets else None, _stream(dev))
    _raise_on(err, "access_kernel")
    access_kernel.launches += 1
    return out


access_kernel.launches = 0


def access_params(cfg, B, rows, s32, shard):
    """The access kernel's parameters (AccessParams) for B lanes over the
    tables rows and s32 and one layout.AccessShard."""
    C = cfg.access_C
    return AccessParams(B=B, W=cfg.W, k=cfg.k, C=C, windowed=int(acc_windowed(cfg.k, C)),
                        win_words=acc_win_words(cfg.k, C), row_w=rows.shape[1],
                        rows_n=rows.shape[0], strings_n=s32.shape[0], blk_lo=shard.blk_lo,
                        blk_hi=shard.blk_hi, word_lo=shard.word_lo, word_hi=shard.word_hi)


def access_occupancy(cfg, tables):
    """(resident blocks an SM, threads a block) of the access kernel on the
    current card for cfg's rows."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    prm = access_params(cfg, 1, tables["acc_rows"], tables["strings32"], WHOLE_ACCESS)
    err = library().sshash_access_occupancy(ctypes.byref(prm), ctypes.byref(blocks),
                                            ctypes.byref(threads))
    _raise_on(err, "access_occupancy")
    return blocks.value, threads.value


def access_read_kernel(cfg, tables, offsets, words):
    """The sharded two-round access form's second round: (B,) int32 char
    offsets (0xFFFFFFFF: none) -> (B, W) int32 kmers read from this shard's
    strings32 slice (words: a layout.AccessShard), zeros where the offset's
    word is another shard's. Same contract as engine.access_read_plain."""
    B = _ids(offsets)
    dev = offsets.device
    rows, s32 = tables["acc_rows"], tables["strings32"]
    _check_table(rows, "acc_rows", dev, acc_width(cfg))
    _check_table(s32, "strings32", dev)
    _check_staged(s32, "strings32")
    if acc_windowed(cfg.k, cfg.access_C):
        raise ValueError("the windowed access form has no second round")
    out = torch.empty((B, cfg.W), dtype=torch.int32, device=dev)
    prm = access_params(cfg, B, rows, s32, words)
    err = library().sshash_access(rows.data_ptr(), s32.data_ptr(), ctypes.byref(prm), None,
                                  offsets.data_ptr(), out.data_ptr(), None, _stream(dev))
    _raise_on(err, "access_read_kernel")
    access_read_kernel.launches += 1
    return out


access_read_kernel.launches = 0


def iterate_kernel(k, strings32, vstart32):
    """Iteration: (2,) int32 (count, checksum) u32 bits, left on the
    device. Same contract as engine.iterate_plain."""
    dev = strings32.device
    _check_table(strings32, "strings32", dev)
    _check_table(vstart32, "vstart32", dev)
    if strings32.dim() != 1 or vstart32.dim() != 1 or 2 * vstart32.shape[0] < strings32.shape[0]:
        raise ValueError("strings32 and vstart32 must be 1-D, vstart32 covering every word")
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    err = library().sshash_iterate(strings32.data_ptr(), strings32.shape[0],
                                   vstart32.data_ptr(), vstart32.shape[0], k,
                                   out.data_ptr(), _stream(dev))
    _raise_on(err, "iterate_kernel")
    iterate_kernel.launches += 1
    return out


iterate_kernel.launches = 0


def weight_kernel(tables, ids, owned=False):
    """Weight: (B,) int32 ids -> (B,) int32 weights (u32 bits); owned: a
    bucket shard's runs, ids outside them weigh 0. Same contract as
    engine.weight_plain."""
    B = _ids(ids)
    dev = ids.device
    names = ("w_endpoints", "w_value_ids", "w_dictionary")
    for name in names:
        _check_table(tables[name], name, dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    err = library().sshash_weight(*(v for n in names
                                    for v in (tables[n].data_ptr(), tables[n].shape[0])),
                                  ids.data_ptr(), B, int(owned), out.data_ptr(), _stream(dev))
    _raise_on(err, "weight_kernel")
    weight_kernel.launches += 1
    return out


weight_kernel.launches = 0


def weight_plan(n_ep, n_runs):
    """The weight kernel's search on a table of n_ep endpoints and n_runs
    runs: {s: the sample's stride, ns: its entries, nb: its buckets,
    stage_vids: the value ids staged too, smem: shared memory a block
    (bytes), per_sm: blocks resident on one SM}. Needs the card."""
    out = (ctypes.c_int64 * 6)()
    _raise_on(library().sshash_weight_plan(n_ep, n_runs, out), "weight_plan")
    return dict(zip(("s", "ns", "nb", "stage_vids", "smem", "per_sm"), out))


def neighbours_kernel(kmers32, k):
    """The 8 one-char variants: (B, W) int32 kmers -> (8, B, W) int32. Same
    contract as ops.packed.neighbour_variants_plain."""
    W = (2 * k + 31) // 32
    if kmers32.dim() != 2:
        raise ValueError(f"kmers32 must be (B, {W}), got {tuple(kmers32.shape)}")
    B = kmers32.shape[0]
    _check(kmers32, "kmers32", torch.int32, (B, W))
    out = torch.empty((8, B, W), dtype=torch.int32, device=kmers32.device)
    err = library().sshash_neighbours(kmers32.data_ptr(), B, W, k, out.data_ptr(),
                                      _stream(kmers32.device))
    _raise_on(err, "neighbours_kernel")
    neighbours_kernel.launches += 1
    return out


neighbours_kernel.launches = 0


def _scan_scratch(n, compact, dev):
    """The single-pass scan's tile counter and status words (u64), zeroed by
    the C entry."""
    return torch.empty(library().sshash_scan_scratch(n, int(compact)), dtype=torch.int64,
                       device=dev)


def _vec(t, name, dtype):
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    _check(t, name, dtype)
    return t.shape[0]


def scan_kernel(v):
    """Exclusive scan of (B,) int32 (u32 sums, wrapping) -> (B,) int32. Same
    contract as ops.packed.prefix_sum_ex."""
    n = _vec(v, "v", torch.int32)
    out = torch.empty(n, dtype=torch.int32, device=v.device)
    if n == 0:
        return out
    err = library().sshash_scan(v.data_ptr(), n, _scan_scratch(n, False, v.device).data_ptr(),
                                out.data_ptr(), _stream(v.device))
    _raise_on(err, "scan_kernel")
    scan_kernel.launches += 1
    return out


scan_kernel.launches = 0


def compact_kernel(flags):
    """Compaction of (B,) uint8 flags -> (idx int32 (B,), n int32 (1,)):
    idx[:n] the flagged lanes in order, zeros after. Same contract as
    ops.packed.compact_plain."""
    n = _vec(flags, "flags", torch.uint8)
    dev = flags.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    # the kernel writes every position: the lanes, the zeros past them, the count
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = library().sshash_compact(flags.data_ptr(), n, _scan_scratch(n, True, dev).data_ptr(),
                                   idx.data_ptr(), count.data_ptr(), _stream(dev))
    _raise_on(err, "compact_kernel")
    compact_kernel.launches += 1
    return idx, count


compact_kernel.launches = 0


def _scalar(t, name):
    _check(t, name, torch.int32, (1,))


def stream_anchors_kernel(pstart, rfirst, nreads, words32, P, k):
    """The anchor stage of a chunk: segment / read-start bits, the group
    scan and the anchors' kmers, in one launch. Needs pstart[:nreads]
    strictly rising (rnpos[:nreads] >= 1, as the packer writes it). Same
    contract as streaming.stream_anchors_plain."""
    R = _vec(pstart, "pstart", torch.int32)
    dev = pstart.device
    _check(rfirst, "rfirst", torch.int32, (R // 32 + 1,))
    _scalar(nreads, "nreads")
    nw = _vec(words32, "words32", torch.int32)
    if P % 32 or P <= 0:
        raise ValueError(f"P={P} must be a positive multiple of 32")
    # every word of the bit arrays and every row is written by the kernel
    sbits = torch.empty(P // 32 + 1, dtype=torch.int32, device=dev)
    fbits = torch.empty_like(sbits)
    cum_g = torch.empty(P // 16, dtype=torch.int32, device=dev)
    out = torch.empty((P // 16, (2 * k + 31) // 32), dtype=torch.int32, device=dev)
    err = library().sshash_stream_anchors(pstart.data_ptr(), rfirst.data_ptr(),
                                          nreads.data_ptr(), R, P, words32.data_ptr(), nw, k,
                                          sbits.data_ptr(), fbits.data_ptr(), cum_g.data_ptr(),
                                          out.data_ptr(), _stream(dev))
    _raise_on(err, "stream_anchors_kernel")
    stream_anchors_kernel.launches += 1
    return sbits, fbits, cum_g, out


stream_anchors_kernel.launches = 0


def stream_kmers_kernel(words32, sbits, cum_g, k, lanes, count):
    """The kmer at each listed lane of a chunk -> (P, W) int32, rows below
    the count only. Same contract as streaming.stream_kmers_plain."""
    nw = _vec(words32, "words32", torch.int32)
    dev = words32.device
    _check(sbits, "sbits", torch.int32)
    _check(cum_g, "cum_g", torch.int32)
    P = (sbits.shape[0] - 1) * 32
    if cum_g.shape != (P // 16,):
        raise ValueError(f"cum_g must be ({P // 16},), got {tuple(cum_g.shape)}")
    n_out = _vec(lanes, "lanes", torch.int32)
    _scalar(count, "count")
    out = torch.empty((n_out, (2 * k + 31) // 32), dtype=torch.int32, device=dev)
    err = library().sshash_stream_kmers(words32.data_ptr(), nw, sbits.data_ptr(),
                                        cum_g.data_ptr(), lanes.data_ptr(), count.data_ptr(),
                                        n_out, k, out.data_ptr(), _stream(dev))
    _raise_on(err, "stream_kmers_kernel")
    stream_kmers_kernel.launches += 1
    return out


stream_kmers_kernel.launches = 0


class ChainIO(ctypes.Structure):
    """Mirror of csrc/stream_chain.cu ChainIO."""
    _fields_ = [(n, ctypes.c_int64 if n.endswith("_n") else ctypes.c_void_p) for n in (
        "afound", "aoff", "asid", "akid", "aori", "abeg", "aend", "words", "words_n",
        "strings", "strings_n", "valid", "sbits", "fbits", "cum_g", "found", "sid", "kid",
        "ori", "need", "swin")]


def stream_chain_kernel(ares, words32, strings32, valid_bits, sbits, fbits, cum_g, k, swin=None):
    """Chain extension of every anchor -> per-lane state dict; swin: the
    anchors' string windows (a bucket-sharded stream), read in place of
    strings32. Same contract as streaming.stream_chain_plain."""
    A = _vec(ares["found"], "found", torch.bool)
    dev = words32.device
    for name in ("kmer_offset", "string_id", "kmer_id", "kmer_orientation", "string_begin",
                 "string_end"):
        _check(ares[name], name, torch.int32, (A,))
    nbits = A * 16 // 32 + 1
    for t, name in ((valid_bits, "valid_bits"), (sbits, "sbits"), (fbits, "fbits")):
        _check(t, name, torch.int32, (nbits,))
    _check(cum_g, "cum_g", torch.int32, (A,))
    _vec(words32, "words32", torch.int32)
    if swin is None:
        _check_table(strings32, "strings32", dev)
    else:
        _check(swin, "swin", torch.int32, (A,))
        strings32 = None
    P = 16 * A
    out = {"found": torch.empty(P, dtype=torch.uint8, device=dev),
           "string_id": torch.empty(P, dtype=torch.int32, device=dev),
           "kmer_id": torch.empty(P, dtype=torch.int32, device=dev),
           "kmer_orientation": torch.empty(P, dtype=torch.int32, device=dev),
           "need": torch.empty(P, dtype=torch.uint8, device=dev)}
    io = ChainIO(ares["found"].data_ptr(), ares["kmer_offset"].data_ptr(),
                 ares["string_id"].data_ptr(), ares["kmer_id"].data_ptr(),
                 ares["kmer_orientation"].data_ptr(), ares["string_begin"].data_ptr(),
                 ares["string_end"].data_ptr(), words32.data_ptr(), words32.shape[0],
                 None if strings32 is None else strings32.data_ptr(),
                 0 if strings32 is None else strings32.shape[0], valid_bits.data_ptr(),
                 sbits.data_ptr(), fbits.data_ptr(), cum_g.data_ptr(), out["found"].data_ptr(),
                 out["string_id"].data_ptr(), out["kmer_id"].data_ptr(),
                 out["kmer_orientation"].data_ptr(), out["need"].data_ptr(),
                 None if swin is None else swin.data_ptr())
    err = library().sshash_stream_chain(ctypes.byref(io), A, k, _stream(dev))
    _raise_on(err, "stream_chain_kernel")
    stream_chain_kernel.launches += 1
    return out


stream_chain_kernel.launches = 0


def chain_occupancy():
    """(resident blocks an SM, threads a block) of the chain kernel on the
    current card."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = library().sshash_chain_occupancy(ctypes.byref(blocks), ctypes.byref(threads))
    _raise_on(err, "chain_occupancy")
    return blocks.value, threads.value


def stream_swin_kernel(aoff, aori, strings32, k, words):
    """Each anchor's 16 string chars on one bucket shard (words: a
    layout.AccessShard), 0 where another shard holds the window's first
    word -> (A,) int32. Same contract as streaming.stream_swin_plain."""
    A = _vec(aoff, "aoff", torch.int32)
    dev = aoff.device
    _check(aori, "aori", torch.int32, (A,))
    _check_table(strings32, "strings32", dev)
    out = torch.empty(A, dtype=torch.int32, device=dev)
    err = library().sshash_stream_swin(aoff.data_ptr(), aori.data_ptr(), A, strings32.data_ptr(),
                                       strings32.shape[0], k, words.word_lo, words.word_hi,
                                       out.data_ptr(), _stream(dev))
    _raise_on(err, "stream_swin_kernel")
    stream_swin_kernel.launches += 1
    return out


stream_swin_kernel.launches = 0


def _rank_space(P):
    """The rank-space stages take P a multiple of 32 (the step's chunk)."""
    if P % 32 or P <= 0 or P >= 1 << 30:
        raise ValueError(f"P={P} must be a positive multiple of 32 below 2^30")


def _aligned(t, name):
    """A flag array read or written with 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned")


def stream_heads_kernel(mv_f, mv_r, lanes, count, fbits, gate):
    """Run-skip heads in rank space -> (P,) bool. Same contract as
    streaming.stream_heads_plain."""
    P = _vec(lanes, "lanes", torch.int32)
    dev = lanes.device
    _check(mv_f, "mv_f", torch.int64, (P,))
    _check(mv_r, "mv_r", torch.int64, (P,))
    _scalar(count, "count")
    _check(fbits, "fbits", torch.int32, (P // 32 + 1,))
    _rank_space(P)
    head = torch.empty(P, dtype=torch.bool, device=dev)
    err = library().sshash_stream_heads(mv_f.data_ptr(), mv_r.data_ptr(), lanes.data_ptr(),
                                        count.data_ptr(), fbits.data_ptr(), P, int(gate),
                                        head.data_ptr(), _stream(dev))
    _raise_on(err, "stream_heads_kernel")
    stream_heads_kernel.launches += 1
    return head


stream_heads_kernel.launches = 0


def stream_round2_kernel(head, found, minimizer_found, count):
    """Second-round lanes in rank space -> (P,) bool, from the heads and
    the first round's found and minimizer_found (bool (P,)). Same contract
    as streaming.stream_round2_plain."""
    P = _vec(head, "head", torch.bool)
    dev = head.device
    _check(found, "found", torch.bool, (P,))
    _check(minimizer_found, "minimizer_found", torch.bool, (P,))
    _scalar(count, "count")
    _rank_space(P)
    for t, name in ((head, "head"), (found, "found"), (minimizer_found, "minimizer_found")):
        _aligned(t, name)
    lib = library()
    scratch = torch.empty(lib.sshash_round2_scratch(P), dtype=torch.int64, device=dev)
    out = torch.empty(P, dtype=torch.bool, device=dev)
    err = lib.sshash_stream_round2(head.data_ptr(), found.data_ptr(), minimizer_found.data_ptr(),
                                   count.data_ptr(), P, scratch.data_ptr(), out.data_ptr(),
                                   _stream(dev))
    _raise_on(err, "stream_round2_kernel")
    stream_round2_kernel.launches += 1
    return out


stream_round2_kernel.launches = 0


class MergeIO(ctypes.Structure):
    """Mirror of csrc/stream_derive.cu MergeIO."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "lanes", "count", "f1", "sid1", "kid1", "ori1", "f2", "sid2", "kid2", "ori2", "found",
        "sid", "kid", "ori")]


def stream_merge_kernel(lanes, count, r1, r2, state):
    """Write the found results of both rounds to their lanes, in place in
    `state`. Same contract as streaming.stream_merge_plain."""
    P = _vec(lanes, "lanes", torch.int32)
    _scalar(count, "count")
    fields = ("string_id", "kmer_id", "kmer_orientation")
    for r in (r1, r2):
        _check(r["found"], "found", torch.bool, (P,))
        _aligned(r["found"], "found")
        for name in fields:
            _check(r[name], name, torch.int32, (P,))
    _check(state["found"], "found", torch.uint8, (P,))
    for name in fields:
        _check(state[name], name, torch.int32, (P,))
    io = MergeIO(lanes.data_ptr(), count.data_ptr(),
                 *(r[n].data_ptr() for r in (r1, r2) for n in ("found",) + fields),
                 *(state[n].data_ptr() for n in ("found",) + fields))
    err = library().sshash_stream_merge(ctypes.byref(io), P, _stream(lanes.device))
    _raise_on(err, "stream_merge_kernel")
    stream_merge_kernel.launches += 1
    return state


stream_merge_kernel.launches = 0


def stream_count_kernel(state, valid_bits, fbits, count):
    """Counters, lane 0 and the last lane -> (3, 4) int32 (u32 bits). Same
    contract as streaming.stream_count_plain."""
    P = _vec(state["found"], "found", torch.uint8)
    dev = valid_bits.device
    for name in ("string_id", "kmer_id", "kmer_orientation"):
        _check(state[name], name, torch.int32, (P,))
    _check(valid_bits, "valid_bits", torch.int32, (P // 32 + 1,))
    _check(fbits, "fbits", torch.int32, (P // 32 + 1,))
    _scalar(count, "count")
    out = torch.empty((3, 4), dtype=torch.int32, device=dev)  # zeroed by the C entry
    err = library().sshash_stream_count(
        state["found"].data_ptr(), state["string_id"].data_ptr(), state["kmer_id"].data_ptr(),
        state["kmer_orientation"].data_ptr(), valid_bits.data_ptr(), fbits.data_ptr(),
        count.data_ptr(), P, out.data_ptr(), _stream(dev))
    _raise_on(err, "stream_count_kernel")
    stream_count_kernel.launches += 1
    return out


stream_count_kernel.launches = 0


def check_kernel(found, kmer_id, orientation, kmer_offset, string_begin, num_kmers, num_chars):
    """The sanitizer's four postconditions over a lookup's result -> (4,)
    int32 flags, 1 where some found lane violates the predicate; the offset
    fields are None on rebased (v2) rows. Same contract as
    debug.check_plain."""
    B = _vec(found, "found", torch.bool)
    dev = found.device
    _check(kmer_id, "kmer_id", torch.int32, (B,))
    _check(orientation, "kmer_orientation", torch.int32, (B,))
    if (kmer_offset is None) != (string_begin is None):
        raise ValueError("kmer_offset and string_begin go together")
    if kmer_offset is not None:
        _check(kmer_offset, "kmer_offset", torch.int32, (B,))
        _check(string_begin, "string_begin", torch.int32, (B,))
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = library().sshash_check(found.data_ptr(), kmer_id.data_ptr(), orientation.data_ptr(),
                                 ptr(kmer_offset), ptr(string_begin), B, int(num_kmers),
                                 int(num_chars), flags.data_ptr(), _stream(dev))
    _raise_on(err, "check_kernel")
    check_kernel.launches += 1
    return flags


check_kernel.launches = 0


def read_at2_kernel(table, offsets, k):
    """The kmer and valid-start bit at each char offset of the interleaved
    (NW, 2) int32 table: (B,) int32 offsets (u32 bits) -> ((B, W) int32,
    (B,) bool). Same contract as ops.packed.read_kmers_at2_plain."""
    B = _vec(offsets, "offsets", torch.int32)
    dev = offsets.device
    _check_table(table, "table", dev, 2)
    if table.dim() != 2:
        raise ValueError(f"table must be (NW, 2), got {tuple(table.shape)}")
    if table.data_ptr() % 8:
        raise ValueError("table: its rows are read as 8-byte pairs; it must start 8-byte aligned")
    out = torch.empty((B, (2 * k + 31) // 32), dtype=torch.int32, device=dev)
    vbit = torch.empty(B, dtype=torch.bool, device=dev)
    err = library().sshash_read_at2(table.data_ptr(), table.shape[0], offsets.data_ptr(), B, k,
                                    out.data_ptr(), vbit.data_ptr(), _stream(dev))
    _raise_on(err, "read_at2_kernel")
    read_at2_kernel.launches += 1
    return out, vbit


read_at2_kernel.launches = 0

# csrc/combine.cu: the most tensors one launch takes, and its ops
MAX_COMBINE = 8
COMBINE_OPS = ("min", "max", "sum")


def combine_kernel(op, unsigned, *ts):
    """The elementwise min, max or sum (op) of the CUDA tensors ts (one
    shape, int32 or int64, one card), min and max ordered as unsigned with
    unsigned=True (u32 bits in int32), sums wrapping: one launch a group of
    up to MAX_COMBINE tensors, folded in groups past that. Returns a new
    tensor. Same contract as parallel.mesh.combine_plain."""
    if op not in COMBINE_OPS:
        raise ValueError(f"op must be one of {COMBINE_OPS}, got {op!r}")
    if not ts:
        raise ValueError("combine takes at least one tensor")
    t0 = ts[0]
    if t0.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"combine takes int32 or int64 tensors, got {t0.dtype}")
    if unsigned and t0.dtype != torch.int32:
        raise ValueError("the unsigned order is that of u32 bits in int32 tensors")
    for t in ts:
        _check(t, "a combined tensor", t0.dtype, t0.shape)
        if t.device != t0.device:
            raise ValueError(f"combined tensors on {t.device} and {t0.device}")
    lib, dev = library(), t0.device
    acc, rest = None, list(ts)
    while rest:
        group = ([acc] if acc is not None else []) + rest[:MAX_COMBINE - (acc is not None)]
        rest = rest[len(group) - (acc is not None):]
        out = torch.empty_like(t0)
        ptrs = (ctypes.c_void_p * len(group))(*(t.data_ptr() for t in group))
        err = lib.sshash_combine(ptrs, len(group), t0.numel(), t0.element_size(),
                                 COMBINE_OPS.index(op), int(unsigned), out.data_ptr(),
                                 _stream(dev))
        _raise_on(err, "combine_kernel")
        combine_kernel.launches += 1
        acc = out
    return acc


combine_kernel.launches = 0


KERNELS = (minimizer_kernel, minimizer_ranks_kernel, probe_kernel, lookup_kernel,
           rank_lists_kernel, probe_ranks_kernel, lookup_ranks_kernel, access_kernel,
           access_read_kernel,
           iterate_kernel, weight_kernel, neighbours_kernel, scan_kernel, compact_kernel,
           stream_anchors_kernel, stream_kmers_kernel, stream_chain_kernel, stream_swin_kernel,
           stream_heads_kernel, stream_round2_kernel, stream_merge_kernel, stream_count_kernel,
           check_kernel, read_at2_kernel, combine_kernel)
# the wrappers of each CUDA source
SOURCE_KERNELS = {"minimizer.cu": ("minimizer_kernel", "minimizer_ranks_kernel"),
                  "probe.cu": ("probe_kernel", "lookup_kernel"),
                  "lookup_ranks.cu": ("lookup_ranks_kernel", "rank_lists_kernel",
                                      "probe_ranks_kernel"),
                  "access.cu": ("access_kernel", "access_read_kernel"),
                  "iterator.cu": ("iterate_kernel",),
                  "weight.cu": ("weight_kernel",), "neighbours.cu": ("neighbours_kernel",),
                  "scan.cu": ("scan_kernel", "compact_kernel"),
                  "stream_anchor.cu": ("stream_anchors_kernel", "stream_kmers_kernel"),
                  "stream_chain.cu": ("stream_chain_kernel", "stream_swin_kernel"),
                  "stream_derive.cu": ("stream_heads_kernel", "stream_round2_kernel",
                                       "stream_merge_kernel", "stream_count_kernel"),
                  "check.cu": ("check_kernel",), "read_at2.cu": ("read_at2_kernel",),
                  "combine.cu": ("combine_kernel",)}


def reset_counts():
    for kern in KERNELS:
        kern.launches = 0


def counts():
    return {kern.__name__: kern.launches for kern in KERNELS}
