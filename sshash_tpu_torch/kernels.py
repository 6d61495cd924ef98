"""Build and bind the port's CUDA kernels (csrc/), with launch counters.

Six kernels: minimizer (kernel 1) and probe (kernel 2) carry lookup;
access, iterate, weight and neighbours carry the other point queries.

The sources compile with nvcc for sm_90a, one nvcc process per source, all
started together, and link into one shared library with a plain C
interface, loaded with ctypes. The library lands in
build/sshash_tpu_torch/ at the repo root, named by a hash of the sources,
and is built at first use, so a fresh checkout builds it on its first
CUDA lookup. Nothing builds or loads at import: machines without nvcc
import this module and run the plain versions.

Each launch wrapper checks its tensors, allocates its outputs with
torch.empty, launches on the current stream without synchronising, raises
if the launch returned a CUDA error, and adds one to its `launches` count.
The wrappers take CUDA tensors only; the entry points (ops/packed.minimizer
and .neighbour_variants; engine.probe, .access, .iterate and
.weight) choose between a wrapper and its plain version by device.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .layout import acc_width, acc_win_words, acc_windowed, cand_block_width, row_width

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("minimizer.cu", "probe.cu", "access.cu", "iterator.cu", "weight.cu",
           "neighbours.cu")
HEADERS = ("packed.cuh", "tables.cuh", "u64.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sshash_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None


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
    stderr, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


def build():
    """Compile the kernels unless the library for these sources exists.
    Returns (path, seconds spent compiling, nvcc's output)."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                         str(CSRC / src), "-o", obj] for src, obj in zip(SOURCES, objs)])
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
    return path, time.perf_counter() - t0, "".join(log)


# ctypes mirrors of the structs in csrc/probe.cu (8-byte fields only)
_TABLE_NAMES = ("cw_row", "mid_rows", "sk_hrows", "pilots", "mphf_seedrows",
                "sk_pilots", "sk_seedrows")


class ProbeTables(ctypes.Structure):
    _fields_ = [f for name in _TABLE_NAMES
                for f in ((name, ctypes.c_void_p), (name + "_n", ctypes.c_int64))] \
        + [("sk_params", ctypes.c_void_p)]


_PARAM_NAMES = ("B", "W", "k", "m", "canonical", "full", "win_words",
                "vbits_words", "max_start_word", "row_w", "blk_w", "c1_in_row",
                "has_skew", "mphf_partitioned", "mphf_P", "mphf_part_table",
                "mphf_part_buckets", "mphf_nbuckets", "mphf_table", "pilot_w",
                "sk_pilot_w")


class ProbeParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in _PARAM_NAMES] \
        + [("mphf_seedmix", ctypes.c_uint64)]


_IO_NAMES = ("kmers", "kmers_rc", "minval", "minpos", "minpos2", "active",
             "kmer_id", "kmer_orientation", "minimizer_found", "found",
             "kmer_id_in_string", "kmer_offset", "string_id", "string_begin",
             "string_end")


class ProbeIO(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _IO_NAMES]


class AccessParams(ctypes.Structure):
    """Mirror of csrc/access.cu AccessParams."""
    _fields_ = [(n, ctypes.c_int64) for n in ("B", "W", "k", "C", "windowed", "win_words",
                                               "row_w", "rows_n", "strings_n")]


def library():
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.sshash_minimizer.argtypes = [p, i64, i64, i64, i64, ctypes.c_uint64,
                                         p, p, p, p, p, p]
        lib.sshash_minimizer.restype = ctypes.c_int
        lib.sshash_probe.argtypes = [ctypes.POINTER(ProbeTables),
                                     ctypes.POINTER(ProbeParams),
                                     ctypes.POINTER(ProbeIO), p]
        lib.sshash_probe.restype = ctypes.c_int
        lib.sshash_access.argtypes = [p, p, ctypes.POINTER(AccessParams), p, p, p]
        lib.sshash_iterate.argtypes = [p, i64, p, i64, i64, p, p]
        lib.sshash_weight.argtypes = [p, i64, p, i64, p, i64, p, i64, p, p]
        lib.sshash_neighbours.argtypes = [p, i64, i64, i64, p, p]
        for name in ("sshash_access", "sshash_iterate", "sshash_weight", "sshash_neighbours"):
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _check_table(t, name, dev, cols=None):
    _check(t, name, torch.int32)
    if t.device != dev:
        raise ValueError(f"table {name} is on {t.device}, queries on {dev}")
    if t.shape[0] < 1 or (cols is not None and tuple(t.shape[1:]) != (cols,)):
        raise ValueError(f"table {name} has shape {tuple(t.shape)}")


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


def probe_kernel(cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2=None,
                 active=None, fields="full"):
    """Kernel 2: the fused-row probe. Same contract as engine.probe_plain:
    returns kmer_id / kmer_orientation / minimizer_found / found and, with
    fields="full", the string fields (u32 fields as int32 bits)."""
    if kmers32.dim() != 2:
        raise ValueError(f"kmers32 must be (B, {cfg.W}), got {tuple(kmers32.shape)}")
    B = kmers32.shape[0]
    _check(kmers32, "kmers32", torch.int32, (B, cfg.W))
    if (kmers_rc32 is not None) != cfg.canonical:
        raise ValueError("kmers_rc32 is required in canonical mode and only there")
    if kmers_rc32 is not None:
        _check(kmers_rc32, "kmers_rc32", torch.int32, (B, cfg.W))
    _check(minval, "minval", torch.int64, (B,))
    _check(minpos, "minpos", torch.int32, (B,))
    if minpos2 is not None:
        _check(minpos2, "minpos2", torch.int32, (B,))
    if active is not None:
        _check(active, "active", torch.bool, (B,))
    if fields not in ("full", "ids"):
        raise ValueError(f"fields must be 'full' or 'ids', got {fields!r}")
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
    lib = library()

    full = fields == "full"
    u32_out = lambda: torch.empty(B, dtype=torch.int32, device=dev)  # noqa: E731
    out = {"kmer_id": u32_out(),
           "kmer_orientation": torch.empty(B, dtype=torch.int32, device=dev),
           "minimizer_found": torch.empty(B, dtype=torch.bool, device=dev),
           "found": torch.empty(B, dtype=torch.bool, device=dev)}
    if full:
        for name in ("kmer_id_in_string", "kmer_offset", "string_id",
                     "string_begin", "string_end"):
            out[name] = u32_out()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    tab = ProbeTables(*(v for n in _TABLE_NAMES
                        for v in (t[n].data_ptr(), t[n].shape[0])),
                      t["sk_params"].data_ptr())
    prm = ProbeParams(
        B=B, W=cfg.W, k=cfg.k, m=cfg.m, canonical=int(cfg.canonical), full=int(full),
        win_words=cfg.win_words, vbits_words=cfg.vbits_words,
        max_start_word=cfg.max_start_word, row_w=row_w, blk_w=blk_w,
        c1_in_row=int(cfg.c1_in_row), has_skew=int(cfg.has_skew),
        mphf_partitioned=int(cfg.mphf_partitioned), mphf_P=cfg.mphf_P,
        mphf_part_table=cfg.mphf_part_table, mphf_part_buckets=cfg.mphf_part_buckets,
        mphf_nbuckets=cfg.mphf_nbuckets, mphf_table=cfg.mphf_table,
        pilot_w=cfg.pilot_w, sk_pilot_w=cfg.sk_pilot_w, mphf_seedmix=cfg.mphf_seedmix)
    io = ProbeIO(kmers32.data_ptr(), ptr(kmers_rc32), minval.data_ptr(),
                 minpos.data_ptr(), ptr(minpos2), ptr(active),
                 *(ptr(out.get(n)) for n in _IO_NAMES[6:]))
    err = lib.sshash_probe(ctypes.byref(tab), ctypes.byref(prm), ctypes.byref(io),
                           _stream(dev))
    _raise_on(err, "probe_kernel")
    probe_kernel.launches += 1
    return out


probe_kernel.launches = 0


def access_kernel(cfg, tables, ids):
    """Access: (B,) int32 ids -> (B, W) int32 kmers. Same contract as
    engine.access_plain."""
    B = _ids(ids)
    dev = ids.device
    C = cfg.access_C
    windowed = acc_windowed(cfg.k, C)
    rows, s32 = tables["acc_rows"], tables["strings32"]
    _check_table(rows, "acc_rows", dev, acc_width(cfg))
    _check_table(s32, "strings32", dev)
    out = torch.empty((B, cfg.W), dtype=torch.int32, device=dev)
    prm = AccessParams(B=B, W=cfg.W, k=cfg.k, C=C, windowed=int(windowed),
                       win_words=acc_win_words(cfg.k, C), row_w=rows.shape[1],
                       rows_n=rows.shape[0], strings_n=s32.shape[0])
    err = library().sshash_access(rows.data_ptr(), s32.data_ptr(), ctypes.byref(prm),
                                  ids.data_ptr(), out.data_ptr(), _stream(dev))
    _raise_on(err, "access_kernel")
    access_kernel.launches += 1
    return out


access_kernel.launches = 0


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


def weight_kernel(tables, ids):
    """Weight: (B,) int32 ids -> (B,) int32 weights (u32 bits). Same
    contract as engine.weight_plain."""
    B = _ids(ids)
    dev = ids.device
    names = ("w_endpoints", "w_value_ids", "w_dictionary")
    for name in names:
        _check_table(tables[name], name, dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    err = library().sshash_weight(*(v for n in names
                                    for v in (tables[n].data_ptr(), tables[n].shape[0])),
                                  ids.data_ptr(), B, out.data_ptr(), _stream(dev))
    _raise_on(err, "weight_kernel")
    weight_kernel.launches += 1
    return out


weight_kernel.launches = 0


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


KERNELS = (minimizer_kernel, probe_kernel, access_kernel, iterate_kernel, weight_kernel,
           neighbours_kernel)


def reset_counts():
    for kern in KERNELS:
        kern.launches = 0


def counts():
    return {kern.__name__: kern.launches for kern in KERNELS}
