"""ctypes loader for the native builder hot loops (csrc/host_native.cpp).

Compiles on demand with g++ (pybind11 is not assumed, hence ctypes) into
build/sshash_tpu_torch/ at the repo root, named by a hash of the source.
Every native entry point has a NumPy fallback, so the package works
without a toolchain — the native path exists for build-time throughput
parity with the reference's C++ builder (PTHash + AVX2 encode).
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "host_native.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                      "sshash_tpu_torch")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib = None
_tried = False


def library_path():
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(" ".join(CXXFLAGS).encode() + f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libhost_native_{h}.so")


def _compile(path):
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, _SRC],
                   check=True, capture_output=True)
    os.replace(tmp, path)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        so = library_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        i64 = ctypes.c_int64
        u64 = ctypes.c_uint64
        p = ctypes.POINTER
        lib.pilot_search.restype = i64
        lib.pilot_search.argtypes = [
            p(ctypes.c_uint32), p(i64), p(i64), p(i64), p(i64),
            i64, i64, i64, p(ctypes.c_uint32), p(ctypes.c_uint8),
        ]
        lib.minimizer_scan.restype = None
        lib.minimizer_scan.argtypes = [
            p(u64), i64, i64, i64, u64, p(u64), p(ctypes.c_int32),
        ]
        lib.tuple_scan.restype = i64
        lib.tuple_scan.argtypes = [
            p(ctypes.c_uint8), i64, p(i64), i64, i64, i64, u64, ctypes.c_int,
            p(u64), p(u64), p(ctypes.c_uint8), p(ctypes.c_uint8), i64,
        ]
        lib.encode_stream.restype = i64
        lib.encode_stream.argtypes = [
            p(ctypes.c_uint8), p(i64), p(i64), i64, i64,
            p(ctypes.c_uint32), p(ctypes.c_uint32),
        ]
        lib.sort_tuples.restype = i64
        lib.sort_tuples.argtypes = [p(u64), p(u64), p(i64), i64, i64]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available():
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pilot_search(lo_sorted, starts, counts, order, bucket_ids, table_size,
                 max_pilot, num_buckets):
    """Returns (pilots uint32[num_buckets], taken bool[table_size]) or None
    if the search failed (caller re-seeds)."""
    lib = _load()
    assert lib is not None
    lo_sorted = np.ascontiguousarray(lo_sorted, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    bucket_ids = np.ascontiguousarray(bucket_ids, dtype=np.int64)
    pilots = np.zeros(num_buckets, dtype=np.uint32)
    taken = np.zeros(table_size, dtype=np.uint8)
    rc = lib.pilot_search(
        _ptr(lo_sorted, ctypes.c_uint32), _ptr(starts, ctypes.c_int64),
        _ptr(counts, ctypes.c_int64), _ptr(order, ctypes.c_int64),
        _ptr(bucket_ids, ctypes.c_int64), len(starts),
        int(table_size), int(max_pilot),
        _ptr(pilots, ctypes.c_uint32), _ptr(taken, ctypes.c_uint8),
    )
    if rc != -1:
        return None
    return pilots, taken.astype(bool)


def minimizer_scan(words64, n_chars, k, m, magic):
    """Per-kmer leftmost min-hash m-mer over one packed sequence.
    Returns (values uint64[n-k+1], pos int32[n-k+1])."""
    lib = _load()
    assert lib is not None
    words64 = np.ascontiguousarray(words64, dtype=np.uint64)
    nk = n_chars - k + 1
    out_val = np.empty(nk, dtype=np.uint64)
    out_pos = np.empty(nk, dtype=np.int32)
    lib.minimizer_scan(
        _ptr(words64, ctypes.c_uint64), int(n_chars), int(k), int(m),
        ctypes.c_uint64(int(magic)), _ptr(out_val, ctypes.c_uint64),
        _ptr(out_pos, ctypes.c_int32),
    )
    return out_val, out_pos


def tuple_scan(codes, endpoints, k, m, magic, canonical):
    """Single-pass minimizer/super-kmer tuple scan (C++). Returns
    (minimizer u64[T], pos_in_seq u64[T], pos_in_kmer u8[T], count u8[T])."""
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    endpoints = np.ascontiguousarray(endpoints, dtype=np.int64)
    num_seqs = len(endpoints) - 1
    cap = int(endpoints[-1])  # tuples <= kmers <= chars
    out_min = np.empty(cap, dtype=np.uint64)
    out_pos = np.empty(cap, dtype=np.uint64)
    out_pik = np.empty(cap, dtype=np.uint8)
    out_cnt = np.empty(cap, dtype=np.uint8)
    t = lib.tuple_scan(
        _ptr(codes, ctypes.c_uint8), len(codes),
        _ptr(endpoints, ctypes.c_int64), num_seqs,
        int(k), int(m), ctypes.c_uint64(int(magic)), int(bool(canonical)),
        _ptr(out_min, ctypes.c_uint64), _ptr(out_pos, ctypes.c_uint64),
        _ptr(out_pik, ctypes.c_uint8), _ptr(out_cnt, ctypes.c_uint8), cap,
    )
    assert t >= 0
    return out_min[:t], out_pos[:t], out_pik[:t], out_cnt[:t]


def sort_tuples(minimizer, pos_in_seq, nthreads):
    """Thread-parallel stable sort permutation by (minimizer, pos_in_seq) —
    bit-identical to np.lexsort((pos_in_seq, minimizer)) (the reference's
    parallel_sort analog). Returns int64 index array."""
    lib = _load()
    assert lib is not None
    minimizer = np.ascontiguousarray(minimizer, dtype=np.uint64)
    pos_in_seq = np.ascontiguousarray(pos_in_seq, dtype=np.uint64)
    idx = np.empty(len(minimizer), dtype=np.int64)
    lib.sort_tuples(
        _ptr(minimizer, ctypes.c_uint64), _ptr(pos_in_seq, ctypes.c_uint64),
        _ptr(idx, ctypes.c_int64), len(minimizer), int(nthreads),
    )
    return idx


def encode_stream(seq_bytes, cstarts, lens, k, words32, valid_bits):
    """Single-pass read-batch encode (C++): fills `words32` (2-bit packed,
    invalid chars as 0) and `valid_bits` (one bit per kmer position in
    segment order). Both must be zeroed. Returns total positions."""
    lib = _load()
    assert lib is not None
    seq = np.frombuffer(seq_bytes, dtype=np.uint8)
    cstarts = np.ascontiguousarray(cstarts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    return lib.encode_stream(
        _ptr(seq, ctypes.c_uint8), _ptr(cstarts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), len(lens), int(k),
        _ptr(words32, ctypes.c_uint32), _ptr(valid_bits, ctypes.c_uint32),
    )
