"""Build and bind the port's CUDA kernels (csrc/), with launch counters.

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The library lands in
build/sshash_tpu_torch/ at the repo root, named by a hash of the sources,
and is built at first use, so a fresh checkout builds it on its first
CUDA lookup. Nothing builds or loads at import: machines without nvcc
import this module and run the plain versions.

Each launch wrapper checks its tensors, allocates its outputs with
torch.empty, launches on the current stream without synchronising, raises
if the launch returned a CUDA error, and adds one to its `launches` count.
The wrappers take CUDA tensors only; ops/packed.minimizer and
engine.probe choose between a wrapper and its plain version by device.
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

from .layout import cand_block_width, row_width

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("minimizer.cu", "probe.cu")
HEADERS = ("packed.cuh", "u64.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sshash_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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


def build():
    """Compile the kernels unless the library for these sources exists.
    Returns (path, seconds spent compiling, nvcc's output)."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stderr


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


def reset_counts():
    minimizer_kernel.launches = 0
    probe_kernel.launches = 0


def counts():
    return {"minimizer_kernel": minimizer_kernel.launches,
            "probe_kernel": probe_kernel.launches}
