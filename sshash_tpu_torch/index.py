"""The SSHash-TPU index container (host side).

Holds the dense arrays that the JAX query engine consumes. The layout keeps
the reference's sparse-and-skew semantics exactly (reference:
include/sparse_and_skew_index.hpp, include/spectrum_preserving_string_set.hpp)
but stores everything as NumPy arrays that map 1:1 onto device uint32 buffers.

Control codewords keep the reference bit format (uint64 here):
  SINGLETON:  offset << 1 | 0                    (build_sparse_and_skew_index.cpp:119)
  MIDLOAD:    ((list_id << 6 | size-2) << 2) | 1 (":208-211)
  HEAVYLOAD:  ((begin << 3 | partition) << 2) | 3 (":225-227)
"""

import json
from dataclasses import dataclass, field

import numpy as np

from . import kmer as K
from .constants import MIN_L, VERSION
from .compact import CompactVector
from .mphf import MPHF, PartitionedMPHF

U64 = np.uint64
U32 = np.uint32


@dataclass
class Weights:
    """Run-length weight store (reference include/weights.hpp)."""

    interval_value_ids: np.ndarray  # uint32[I] distinct-weight ids per interval
    interval_endpoints: np.ndarray  # uint64[I+1] cumulative interval lengths, [0]=0
    dictionary: np.ndarray  # uint64[D] distinct weights, freq-desc then value-asc

    def weight(self, kmer_ids):
        kmer_ids = np.asarray(kmer_ids, dtype=np.int64)
        i = np.searchsorted(self.interval_endpoints, kmer_ids, side="right") - 1
        return np.take(self.dictionary, np.take(self.interval_value_ids, i))

    def num_bits(self):
        # reference-format accounting: compact widths
        d = len(self.dictionary)
        wv = max(1, int(np.ceil(np.log2(max(2, int(self.dictionary.max()) + 1)))))
        wid = max(1, int(np.ceil(np.log2(max(2, d)))))
        n = int(self.interval_endpoints[-1])
        ef = len(self.interval_endpoints) * (2 + max(1, int(np.ceil(np.log2(max(2, n))))))
        return len(self.interval_value_ids) * wid + ef + d * wv


@dataclass
class SkewPartition:
    mphf: MPHF  # kmer-keyed
    positions: np.ndarray  # uint32[mphf.n] pos-in-bucket per kmer
    # GLOBAL index into heavy_load_buckets per kmer (= bucket begin +
    # positions); lets the engine resolve a heavy kmer with one row gather
    # (slot -> fused row) instead of positions -> heavy_rows. Optional:
    # pre-1.2 files lack it and fall back to the two-gather path.
    hindex: np.ndarray | None = None


@dataclass
class Index:
    k: int
    m: int
    canonical: bool
    seed: int
    num_kmers: int
    num_strings: int

    # spectrum-preserving string set
    strings64: np.ndarray  # uint64[NW] 2-bit packed, sentinel-padded
    num_chars: int  # valid chars (= string_endpoints[-1])
    string_endpoints: np.ndarray  # uint64[S+1]

    # sparse + skew index
    minimizer_mphf: MPHF
    codewords: np.ndarray  # uint64[num_minimizers]
    begin_buckets_of_size: np.ndarray  # uint32[2**MIN_L + 1]
    mid_load_buckets: np.ndarray  # uint64[...] absolute char offsets
    heavy_load_buckets: np.ndarray  # uint64[...]
    skew_partitions: list  # list[SkewPartition], <= 8

    weights: Weights | None = None

    # build stats (space accounting in reference-format bits)
    stats: dict = field(default_factory=dict)

    # ------------------------------------------------------------ properties

    @property
    def num_minimizers(self):
        return len(self.codewords)

    @property
    def kmer_words64(self):
        return K.num_words64(self.k)

    @property
    def kmer_words32(self):
        return (2 * self.k + 31) // 32

    def string_size(self, string_id):
        b, e = int(self.string_endpoints[string_id]), int(self.string_endpoints[string_id + 1])
        return e - b - self.k + 1

    # ------------------------------------------------------------ num_bits

    def num_bits(self):
        """Reference-FORMAT space accounting (hypothetical compact widths,
        for parity with src/info.cpp / the published build logs). Two named
        approximations: string offsets use an Elias-Fano ESTIMATE
        (2 + ceil(log2(avg gap)) bits/endpoint) and skew positions assume
        32-bit entries. For the honest single number — the bits actually
        held in host RAM — use :meth:`num_bits_actual`;
        info.print_space_breakdown prints both columns side by side."""
        nbo = self.stats.get("num_bits_per_offset", 64)
        nbc = self.stats.get("num_bits_for_control", 64)
        bits = 0
        bits += self.minimizer_mphf.num_bits()
        bits += len(self.codewords) * nbc
        bits += len(self.mid_load_buckets) * nbo
        bits += len(self.heavy_load_buckets) * nbo
        bits += len(self.begin_buckets_of_size) * 32
        # strings: 2 bits/char; offsets: Elias-Fano-ish estimate
        bits += 2 * self.num_chars
        s = len(self.string_endpoints)
        bits += s * (2 + max(1, int(np.ceil(np.log2(max(2, self.num_chars / max(1, s)))))))
        for p in self.skew_partitions:
            bits += p.mphf.num_bits() + len(p.positions) * 32
        if self.weights is not None:
            bits += self.weights.num_bits()
        return bits

    # ------------------------------------------------------------ save / load

    def save(self, path):
        """Serialize. Two at-rest formats:

        * ``*.npz`` (default): one deflate-compressed npz — smallest on disk
          (reaches succinct-structure sizes, see BENCH_NOTES), but every load
          pays a full decompress.
        * directory (path without ``.npz``): one raw ``.npy`` per array +
          ``meta.json``, loaded with ``np.load(mmap_mode='r')`` — the analog
          of the reference's ``--mmap`` zero-copy load
          (reference: tools/common.hpp:19-29): load time is O(metadata) and
          pages fault in on first touch.
        """
        arrays, meta = self._arrays_and_meta()
        if not str(path).endswith(".npz"):
            import os

            os.makedirs(path, exist_ok=True)
            for name, arr in arrays.items():
                np.save(os.path.join(path, name + ".npy"), arr)
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)
            return
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    def _arrays_and_meta(self):
        from .compact import ef_encode

        arrays = {
            "strings64": self.strings64,
            "begin_buckets_of_size": self.begin_buckets_of_size,
        }
        # monotone endpoint sequences go to disk Elias-Fano-coded
        # (reference offsets.hpp:115-155); loaded back into plain arrays
        ef_meta = {}
        lo, hi, em = ef_encode(self.string_endpoints)
        arrays["string_endpoints_ef_low"] = lo
        arrays["string_endpoints_ef_high"] = hi
        ef_meta["string_endpoints"] = em
        for name in ("codewords", "mid_load_buckets", "heavy_load_buckets"):
            arrays.update(_cv_arrays(getattr(self, name), name))
        arrays.update(_mphf_arrays(self.minimizer_mphf, "mphf"))
        meta = {
            "version": list(VERSION),
            "k": self.k,
            "m": self.m,
            "min_l": MIN_L,
            "canonical": self.canonical,
            "seed": self.seed,
            "num_kmers": self.num_kmers,
            "num_strings": self.num_strings,
            "num_chars": self.num_chars,
            "mphf": _mphf_meta(self.minimizer_mphf),
            "cv": {name: _cv_meta(getattr(self, name)) for name in
                   ("codewords", "mid_load_buckets", "heavy_load_buckets")},
            "num_skew_partitions": len(self.skew_partitions),
            "weighted": self.weights is not None,
            "stats": self.stats,
        }
        skew_meta = []
        for i, p in enumerate(self.skew_partitions):
            arrays.update(_mphf_arrays(p.mphf, f"skew_{i}"))
            arrays[f"skew_positions_{i}"] = p.positions
            sm = _mphf_meta(p.mphf)
            if p.hindex is not None:
                arrays[f"skew_hindex_{i}"] = p.hindex
                sm["has_hindex"] = True
            skew_meta.append(sm)
        meta["skew_mphfs"] = skew_meta
        if self.weights is not None:
            arrays["weights_value_ids"] = self.weights.interval_value_ids
            lo, hi, em = ef_encode(self.weights.interval_endpoints)
            arrays["weights_endpoints_ef_low"] = lo
            arrays["weights_endpoints_ef_high"] = hi
            ef_meta["weights_endpoints"] = em
            arrays["weights_dictionary"] = self.weights.dictionary
        meta["ef"] = ef_meta
        return arrays, meta

    @classmethod
    def load(cls, path):
        """Load either at-rest format (see save). Directory indexes are
        memory-mapped: O(metadata) load, zero-copy until first touch."""
        import os

        if os.path.isdir(path):
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)

            class _Dir:
                def __getitem__(self, name):
                    return np.load(os.path.join(path, name + ".npy"),
                                   mmap_mode="r")

            z = _Dir()
        else:
            z = np.load(path)
            meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["version"][0] != VERSION[0]:
            raise RuntimeError("MAJOR index version mismatch: index needs rebuilding")
        if meta.get("min_l", 6) != MIN_L:
            raise RuntimeError(
                f"index was built with MIN_L={meta.get('min_l', 6)} but this "
                f"process uses MIN_L={MIN_L} (codeword formats differ): "
                f"rebuild, or set SSHASH_MIN_L={meta.get('min_l', 6)}")
        skew = []
        for i, sm in enumerate(meta["skew_mphfs"]):
            # version-1.0.0 files stored the skew arrays as skew_pilots_{i}/
            # skew_remap_{i}; they pass the major-version gate, so map the
            # new-style names onto them (advisor r2)
            zi = _KeyAlias(z, {f"skew_{i}_pilots": f"skew_pilots_{i}",
                               f"skew_{i}_remap": f"skew_remap_{i}"})
            skew.append(
                SkewPartition(
                    mphf=_mphf_from(sm, zi, f"skew_{i}"),
                    positions=z[f"skew_positions_{i}"],
                    hindex=z[f"skew_hindex_{i}"] if sm.get("has_hindex") else None,
                )
            )
        weights = None
        if meta["weighted"]:
            weights = Weights(
                interval_value_ids=z["weights_value_ids"],
                interval_endpoints=_ef_or_raw(z, meta, "weights_endpoints"),
                dictionary=z["weights_dictionary"],
            )
        return cls(
            k=meta["k"],
            m=meta["m"],
            canonical=meta["canonical"],
            seed=meta["seed"],
            num_kmers=meta["num_kmers"],
            num_strings=meta["num_strings"],
            strings64=z["strings64"],
            num_chars=meta["num_chars"],
            string_endpoints=_ef_or_raw(z, meta, "string_endpoints"),
            minimizer_mphf=_mphf_from(meta["mphf"], z, "mphf"),
            codewords=_cv_from(meta.get("cv", {}).get("codewords"), z, "codewords"),
            begin_buckets_of_size=z["begin_buckets_of_size"],
            mid_load_buckets=_cv_from(meta.get("cv", {}).get("mid_load_buckets"),
                                      z, "mid_load_buckets"),
            heavy_load_buckets=_cv_from(meta.get("cv", {}).get("heavy_load_buckets"),
                                        z, "heavy_load_buckets"),
            skew_partitions=skew,
            weights=weights,
            stats=meta.get("stats", {}),
        )


def _ef_or_raw(z, meta, name):
    """Endpoint arrays: EF-coded on disk since v1.3 (meta['ef']); earlier
    minor versions stored the raw uint64 array under the bare name."""
    em = meta.get("ef", {}).get(name)
    if em is None:
        return z[name]
    from .compact import ef_decode

    return ef_decode(z[name + "_ef_low"], z[name + "_ef_high"], em)


class _KeyAlias:
    """Read-through adapter: try the primary array name, then its legacy
    alias (npz raises KeyError, the mmap directory loader FileNotFoundError)."""

    def __init__(self, z, aliases):
        self._z, self._aliases = z, aliases

    def __getitem__(self, name):
        try:
            return self._z[name]
        except (KeyError, FileNotFoundError):
            alias = self._aliases.get(name)
            if alias is None:
                raise
            return self._z[alias]


def _mphf_meta(f):
    base = {"pilots_cv": _cv_meta(f.pilots), "remap_cv": _cv_meta(f.remap)}
    if isinstance(f, PartitionedMPHF):
        base.update({"type": "partitioned", "n": f.n, "seed": f.seed,
                     "num_partitions": f.num_partitions,
                     "part_table": f.part_table,
                     "part_buckets": f.part_buckets})
        return base
    base.update({"n": f.n, "table_size": f.table_size,
                 "num_buckets": f.num_buckets, "seed": f.seed})
    return base


def _cv_meta(v):
    if isinstance(v, CompactVector):
        return {"n": v.n, "width": v.width, "dict": v.dictionary is not None}
    return None


def _cv_arrays(v, name):
    if isinstance(v, CompactVector):
        out = {f"{name}_words": v.words}
        if v.dictionary is not None:
            out[f"{name}_dict"] = v.dictionary
        return out
    return {name: v}


def _cv_from(meta_cv, z, name):
    if meta_cv is None:
        return z[name]
    return CompactVector(meta_cv["n"], meta_cv["width"], z[f"{name}_words"],
                         z[f"{name}_dict"] if meta_cv["dict"] else None)


def _mphf_arrays(f, prefix):
    arrays = {}
    arrays.update(_cv_arrays(f.pilots, f"{prefix}_pilots"))
    arrays.update(_cv_arrays(f.remap, f"{prefix}_remap"))
    if isinstance(f, PartitionedMPHF):
        arrays[f"{prefix}_seeds"] = f.seeds
        arrays[f"{prefix}_part_n"] = f.part_n
        arrays[f"{prefix}_cum_n"] = f.cum_n
        arrays[f"{prefix}_remap_off"] = f.remap_off
    return arrays


def _mphf_from(meta, z, prefix):
    pilots = _cv_from(meta.get("pilots_cv"), z, f"{prefix}_pilots")
    remap = _cv_from(meta.get("remap_cv"), z, f"{prefix}_remap")
    if meta.get("type") == "partitioned":
        return PartitionedMPHF(
            meta["n"], meta["seed"], meta["num_partitions"], meta["part_table"],
            meta["part_buckets"], z[f"{prefix}_seeds"], pilots,
            z[f"{prefix}_part_n"], z[f"{prefix}_cum_n"], remap,
            z[f"{prefix}_remap_off"])
    return MPHF(meta["n"], meta["table_size"], meta["num_buckets"], meta["seed"],
                pilots, remap)


def decode_codeword(code):
    """uint64 codeword -> (status, a, b) with the friendly decode:
    SINGLETON: a=offset; MIDLOAD: a=(list_id, size) packed fields; HEAVY: a=begin, b=partition.
    (vectorized; used when expanding to device arrays)"""
    code = np.asarray(code, dtype=U64)
    singleton = (code & U64(1)) == 0
    midload = (code & U64(3)) == U64(1)
    status = np.where(singleton, 0, np.where(midload, 1, 2)).astype(np.uint8)
    # singleton
    a = (code >> U64(1)).astype(U64)
    b = np.zeros_like(code, dtype=U64)
    # midload: size then list_id
    mid_size = ((code >> U64(2)) & U64((1 << MIN_L) - 1)) + U64(2)
    mid_list = code >> U64(2 + MIN_L)
    a = np.where(midload, mid_list, a)
    b = np.where(midload, mid_size, b)
    # heavy: partition id + begin
    heavy = status == 2
    a = np.where(heavy, code >> U64(5), a)
    b = np.where(heavy, (code >> U64(2)) & U64(7), b)
    return status, a, b
