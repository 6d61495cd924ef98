"""Table layout: host Index -> the tables the kernels read.

JAX-free counterpart of sshash_tpu.engine._device_arrays and of the
geometry of sshash_tpu.engine.StaticCfg. The tables are the same arrays,
bit for bit, but for the v2 blocks below (tests/test_torch_layout.py and
tests/test_torch_capacity.py hold them against the JAX package; a JAX v2
dict is converted by port_tables):

  cw_row[slot]   one fused row per raw minimizer-MPHF slot:
                 [status | b<<2, a, candidate-0 block, (candidate-1 block)]
  mid_rows[i]    candidate block of mid_load_buckets[i]
  sk_hrows[i]    candidate block of the heavy kmer with skew slot i, by the
                 skew classes' hindex: a v1.2+ index's own, a pre-v1.2
                 index's derived from its positions (class_hindex), so
                 every index reads one row a heavy lane (the JAX package's
                 legacy path reads slot -> position in the bucket ->
                 heavy_rows[bucket begin + position]; port_tables converts
                 such a dict)
  pilots, mphf_seedrows, sk_pilots, sk_seedrows, sk_*   MPHF parameters

A candidate block is [col0, valid-start bits (Wv words), packed string
window (Ww words), resolve words]: verifying a candidate and resolving its
id needs no further gather. Two row formats:

  v1  col0 = the candidate's char offset, resolve quad (sid0, ep0, ep1,
      ep2);
  v2  ("rebased" rows) col0 = the candidate's offset inside its window,
      resolve words (kid0, rel_ep1) in kmer-id space: no char offset
      anywhere, so an index of >= 2^32 chars serves as long as its ids fit
      u32. v2 rows serve the id fields of lookup only, which never read
      sid0, so v2 blocks leave out the JAX package's third word (kid0,
      sid0, rel_ep1): 10 words at k31 m21 (40 bytes, 2 sectors and 3
      16-byte staging loads a row head wherever it starts). A v2 cw_row is
      padded to a multiple of 4 words where that stages its head in fewer
      loads or touches fewer 32-byte sectors (row_pad: at k63 and k65 m25
      without candidate 1, 16 words, not 15).

  acc_rows[b]    one row per 32-id block b: [sid hint, kmer_cum of the next
                 C strings, and, when 1+C+Wa <= 16, the Wa packed-string
                 words that every access in the block reads]
  vstart32       valid-start bits, bit o of word o//32: a kmer starts at
                 char offset o (the iterator's mask)
  sidk32, kmer_cum   host-side sources of acc_rows (not uploaded)
  w_value_ids, w_endpoints, w_dictionary   the weight runs (weighted only)

The port serves every index with k <= 255 (MAX_K: at most 16 u32 words
per kmer) and fewer than 2^32 - 1 kmers
(ids are u32, 0xFFFFFFFF the not-found sentinel) and weights below 2^32:
v1 rows below 2^32 chars, v2 rows at or above it (or when asked for), skew
classes with or without hindex (served alike), partitioned or plain class
MPHFs. Char offsets stay int64 until they become a u32 field, so a v2 row
past 2^32 chars holds exact values (the JAX package casts candidate
offsets to uint32 first, which wraps there).
"""

import mmap
import os
from typing import NamedTuple

import numpy as np

from . import hashing as H
from .compact import CompactVector
from .index import decode_codeword
from .mphf import PartitionedMPHF, _get
from .pool import ordered_map

NUM_SKEW = 8
SKEW_PARAMS = ("table", "nbuckets", "seedmix_hi", "seedmix_lo", "pilot_off",
               "pos_off", "np2", "seed_off")
ROW_FORMATS = (None, "v1", "v2")
# tables the probe reads; the optional ones get a placeholder row when the
# index has no such structure
LOOKUP_KEYS = ("strings32", "cw_row", "mid_rows", "pilots", "sk_pilots")
OPTIONAL_KEYS = ("mphf_seedrows", "sk_seedrows", "sk_hrows")
# the JAX package's legacy heavy path, converted by port_tables
LEGACY_KEYS = ("heavy_rows", "sk_positions")
# tables of access and iteration, and of weight (uploaded for a weighted
# index only)
ACCESS_KEYS = ("acc_rows", "vstart32")
WEIGHT_KEYS = ("w_value_ids", "w_endpoints", "w_dictionary")
TABLE_GROUPS = {"lookup": LOOKUP_KEYS + OPTIONAL_KEYS + ("sk_params",),
                "access": ACCESS_KEYS, "weight": WEIGHT_KEYS}


class ProbeShard(NamedTuple):
    """One bucket shard's part of the probe's tables (parallel/sharded.py):
    the fused rows of MPHF slots [slot_lo, slot_hi) and, in an index with
    skew classes, the sk_hrows rows [hrow_lo, hrow_hi)."""

    slot_lo: int
    slot_hi: int
    hrow_lo: int = 0
    hrow_hi: int = 0


WHOLE_TABLE = ProbeShard(0, 1 << 32)  # an unsharded probe: every slot


def packed_rows(fields):
    """Rows of kernel 2's packed combine buffer (its shard form on a
    DistMesh): the u32 result fields of `fields`, then kmer_orientation,
    minimizer_found and -found."""
    return (6 if fields == "full" else 1) + 3


def check_probe_shard(cfg, shard, hrows, out=None, fill=False, rc_round=False, slots=None):
    """Kernel 2's call form; returns (handoff, packed). Unsharded (shard
    None) it stores every lane in new tensors. Its shard form stores into
    `out`: the result tensors a mesh row's shards share (the lanes the
    shard owns; fill: the inactive lanes too; rc_round: the regular mode's
    RC round, merged in place) or {"packed": the (F, B) combine buffer},
    every lane. handoff: a shard of an index with skew classes, where only
    the slot's owner knows a heavy lane's sk_hrows row, so the first pass
    writes it to out["hrow"] and a second pass given hrows verifies the
    rows the shard holds. slots (owned form, first
    passes): "store" the lanes' MPHF slots the call evaluates into
    out["slot"] (a mesh row's first shard), or "read" them from there (the
    others), so that a row's shards evaluate each lane's slot once."""
    if shard is None:
        if hrows is not None or out is not None or fill or rc_round or slots:
            raise ValueError("hrows, out, fill, rc_round and slots belong to kernel 2's shard "
                             "form: pass a shard")
        return False, False
    if out is None:
        raise ValueError("kernel 2's shard form stores into out: the mesh row's result tensors "
                         "or {'packed': its combine buffer}")
    handoff = bool(cfg.has_skew)
    if hrows is not None and not handoff:
        raise ValueError("hrows (the heavy-row hand-off's second pass) needs a shard of an "
                         "index with skew classes")
    packed = "packed" in out
    if packed and (fill or rc_round):
        raise ValueError("fill and rc_round belong to the owned stores, not the packed buffer")
    if rc_round and cfg.canonical:
        raise ValueError("rc_round is the regular mode's RC round")
    if handoff and hrows is None and "hrow" not in out:
        raise ValueError("the hand-off's first pass writes out['hrow']")
    if slots not in (None, "store", "read"):
        raise ValueError(f"slots must be None, 'store' or 'read', got {slots!r}")
    if slots and (packed or hrows is not None or "slot" not in out):
        raise ValueError("slots belong to the owned form's first passes, with out['slot']")
    return handoff, packed


def check_rank_probe(cfg, fields, shard, hrows, out, fill=False, rc_round=False):
    """Kernel 2's rank form (the bucket-sharded stream's): its shard form's
    call forms (check_probe_shard) on v1 rows, with fields "full" (the
    anchors' lookup) or "stream" (the misses': kmer_id, kmer_orientation,
    minimizer_found, found and string_id), "full" in the packed form, where
    rc_round (regular mode) probes the RC strand and the merge follows the
    combine. Returns (handoff, packed)."""
    if cfg.row_v2:
        raise ValueError("kernel 2's rank form serves v1 rows (streaming) only")
    if fields not in ("full", "stream"):
        raise ValueError(f"the rank form's fields are 'full' or 'stream', got {fields!r}")
    if shard is None:
        raise ValueError("kernel 2's rank form is its shard form: pass a shard")
    packed = out is not None and "packed" in out
    if packed and fields != "full":
        raise ValueError("the rank form's packed buffer carries the full fields")
    if rc_round and cfg.canonical:
        raise ValueError("rc_round is the regular mode's RC round")
    return check_probe_shard(cfg, shard, hrows, out, fill, rc_round and not packed)


# the most shards one launch of kernel 2's rank form's list probe serves
# (csrc/shard.cuh kMaxRowShards): a longer mesh row takes a launch for each
# MAX_ROW_SHARDS of its shards
MAX_ROW_SHARDS = 8


def rank_probe_shards(cfg, fields, shard, tables, hrows, out, rc_round=False):
    """The list probe of kernel 2's rank form: `shard` one ProbeShard with
    its table dict, or a mesh row's ProbeShards with theirs, consecutive
    key ranges of one width (their slots, or in the hand-off's second pass,
    hrows given, their sk_hrows rows); one shard in the packed form.
    Returns (shards, tables, handoff, packed, the first key, the width of a
    shard's keys), as lists."""
    row = shard is not None and not isinstance(shard, ProbeShard)
    shards, tabs = (list(shard), list(tables)) if row else ([shard], [tables])
    if not shards or len(tabs) != len(shards):
        raise ValueError("a row of shards takes a table dict each")
    for sh in shards:
        handoff, packed = check_rank_probe(cfg, fields, sh, hrows, out, False, rc_round)
    if packed and len(shards) != 1:
        raise ValueError("the packed form's list probe serves its own shard only")
    ranges = [(sh.hrow_lo, sh.hrow_hi) if hrows is not None else (sh.slot_lo, sh.slot_hi)
              for sh in shards]
    lo, per = ranges[0][0], ranges[0][1] - ranges[0][0]
    if per < 1 or any(r != (lo + j * per, lo + (j + 1) * per) for j, r in enumerate(ranges)):
        raise ValueError(f"the shards' key ranges must be consecutive and of one width: {ranges}")
    return shards, tabs, handoff, packed, lo, per


class AccessShard(NamedTuple):
    """One bucket shard's part of the access tables: the acc_rows rows of
    id blocks [blk_lo, blk_hi) and the strings32 words [word_lo, word_hi)
    (plus a halo of W + 1 words)."""

    blk_lo: int
    blk_hi: int
    word_lo: int
    word_hi: int


# widest kmer the kernels take: 16 u32 words (csrc/packed.cuh kWideW)
MAX_K = 255


def check_supported(index):
    """Raise on index formats the port does not serve."""
    if index.k > MAX_K:
        raise ValueError(f"k={index.k}: the port serves k <= {MAX_K} (at most 16 u32 "
                         f"words per kmer, the kernels' widest form)")
    if index.num_kmers >= (1 << 32) - 1:
        raise ValueError(f"ids are u32 with 0xFFFFFFFF as the not-found sentinel, so "
                         f"an index holds fewer than 2^32-1 kmers; this one has "
                         f"{index.num_kmers}")
    w = index.weights
    if w is not None and len(w.dictionary) and int(np.max(w.dictionary)) >= 1 << 32:
        raise ValueError(f"weight {int(np.max(w.dictionary))} does not fit the "
                         f"u32 weight table (weights < 2^32)")


def use_c1(index):
    """Carry candidate 1 in the fused row when >= 0.1% of buckets hold 2+
    positions (the JAX package's default gate, without its env overrides);
    indexes without a histogram keep it."""
    hist = index.stats.get("bucket_size_histogram") or {}
    nmini = int(index.stats.get("num_minimizers", 0))
    singles = int(hist.get("1", hist.get(1, 0)))
    if not (nmini and hist):
        return True
    return (1.0 - singles / nmini) >= 0.001


def use_row_v2(index, row_format=None):
    """Rebased (v2) rows: automatic at >= 2^32 chars, where a v1 row's u32
    char offsets would wrap; row_format "v2" forces them on a smaller
    index, "v1" refuses an index that needs them."""
    if row_format not in ROW_FORMATS:
        raise ValueError(f"row_format must be one of {ROW_FORMATS}, got {row_format!r}")
    big = index.num_chars >= 1 << 32
    if big and row_format == "v1":
        raise ValueError(f"row_format='v1' at {index.num_chars} chars: v1 rows hold u32 "
                         f"char offsets (< 2^32 chars); this index needs v2 rows")
    return big or row_format == "v2"


def check_fields(cfg, fields):
    """Lookup fields "full" or "ids"; v2 rows serve "ids" only."""
    if fields not in ("full", "ids"):
        raise ValueError(f"fields must be 'full' or 'ids', got {fields!r}")
    if cfg.row_v2 and fields == "full":
        raise ValueError("rebased (v2) rows carry no char-offset resolve quad: serve "
                         "fields='ids' (the reference's plain lookup(), dictionary.hpp:34); "
                         "string bounds need a v1-format index (< 2^32 chars)")


def pilot_width(mphf):
    """Smallest divisor of 32 in {4, 8, 16, 32} that fits every pilot."""
    p = mphf.pilots
    if isinstance(p, CompactVector):
        b = p.width
    else:
        b = int(np.max(p, initial=0)).bit_length() if len(p) else 1
    for w in (4, 8, 16):
        if b <= w:
            return w
    return 32


class StaticCfg:
    """Lookup geometry of an index (the JAX StaticCfg's lookup fields).
    row_format: None (v2 rows at >= 2^32 chars, else v1), "v1" or "v2"."""

    def __init__(self, index, row_format=None):
        check_supported(index)
        self.k, self.m = index.k, index.m
        self.canonical = index.canonical
        self.W = (2 * index.k + 31) // 32
        self.num_chars = int(index.num_chars)
        self.row_v2 = use_row_v2(index, row_format)
        # the resolve words: v1's quad, v2's (kid0, rel_ep1)
        self.quad_w = 2 if self.row_v2 else 4
        self.c1_in_row = use_c1(index)
        self.kmw = index.k - index.m
        self.win_words = win_words(index.k, index.m)
        self.vbits_words = vbits_words(index.k, index.m)
        # windows start word-aligned at max(0, cand-(k-m)), so the in-window
        # bit offset of any candidate kmer starts at word <= max_start_word
        self.max_start_word = (2 * (15 + self.kmw)) >> 5
        self.magic = int(H.mixer_magic(index.seed))
        f = index.minimizer_mphf
        self.mphf_partitioned = isinstance(f, PartitionedMPHF)
        self.mphf_table = max(1, f.table_size)
        self.mphf_nbuckets = f.num_buckets
        self.mphf_seedmix = int(H.splitmix64(np.uint64(f.seed)))
        self.pilot_w = pilot_width(f)
        self.sk_pilot_w = max([pilot_width(p.mphf)
                               for p in index.skew_partitions[:NUM_SKEW]],
                              default=32)
        self.mphf_P = self.mphf_part_table = self.mphf_part_buckets = 1
        if self.mphf_partitioned:
            self.mphf_P = f.num_partitions
            self.mphf_part_table = max(1, f.part_table)
            self.mphf_part_buckets = f.part_buckets
        self.has_skew = any(p.mphf.n > 0 for p in index.skew_partitions)
        # v1.2+ builds: every skew class is a PartitionedMPHF; older ones
        # may hold plain class MPHFs (with or without hindex, the tables
        # read one sk_hrows row a heavy lane)
        self.skew_partitioned = self.has_skew and all(
            isinstance(p.mphf, PartitionedMPHF) for p in index.skew_partitions if p.mphf.n > 0)
        self.access_C = access_C(index)
        self.weighted = index.weights is not None


def win_words(k, m):
    """Ww: the packed string words a candidate block's window holds."""
    return ((4 * k - 2 * m + 29) >> 5) + 1


def vbits_words(k, m):
    """Wv: the words of a candidate's k-m+1 valid-start bits."""
    return (k - m + 1 + 31) // 32


def row_geometry(k, m, row_v2, c1_in_row):
    """The StaticCfg fields that size a fused row (cand_block_width,
    row_pad, row_width) for a (k, m) without an index."""
    from types import SimpleNamespace

    return SimpleNamespace(vbits_words=vbits_words(k, m), win_words=win_words(k, m),
                           quad_w=2 if row_v2 else 4, row_v2=row_v2, c1_in_row=c1_in_row)


def access_C(index):
    """Most string starts inside any 32-id block: the crossings an access
    row carries (engine._access_C). A string may hold a single kmer, so
    up to 31 strings can start inside one block."""
    ep = index.string_endpoints.astype(np.int64)
    kmer_cum = ep - np.arange(len(ep)) * (index.k - 1)
    nk = int(index.num_kmers)
    if nk == 0:
        return 1
    blk = np.arange((nk + 31) // 32, dtype=np.int64) * 32
    lo = np.searchsorted(kmer_cum, blk, side="right")
    hi = np.searchsorted(kmer_cum, np.minimum(blk + 31, nk - 1), side="right")
    return max(1, int((hi - lo).max()))


def acc_win_words(k, C):
    """Packed-string words covering every char a 32-id block's accesses
    read: offsets span [o_min, o_min + 31 + C*(k-1)], each read takes k
    chars, from word floor(o_min/16)."""
    return (31 + C * (k - 1) + k - 1 + 15) // 16 + 1


def acc_windowed(k, C):
    """The access row carries its char window while it stays within 16
    words; wider geometries read strings32 in a second round."""
    return 1 + C + acc_win_words(k, C) <= 16


def acc_width(cfg):
    C = cfg.access_C
    return 1 + C + (acc_win_words(cfg.k, C) if acc_windowed(cfg.k, C) else 0)


def check_access(cfg):
    """The two-round access form reads strings32 at a u32 char offset,
    which wraps at >= 2^32 chars: raise there (the windowed form resolves
    its offset against row-resident data and stays exact through u32
    wrap-around)."""
    if cfg.num_chars >= 1 << 32 and not acc_windowed(cfg.k, cfg.access_C):
        raise ValueError(f"access at {cfg.num_chars} chars needs the windowed row form, but "
                         f"k={cfg.k}, C={cfg.access_C} exceeds its width gate; shard into "
                         f"< 2^32-char sub-indexes")


def acc_rows(sidk32, kmer_cum, C, s32, k, first=0):
    """Per-32-id-block access rows [sid hint, kmer_cum[hint+1..hint+C],
    (window)] (engine._acc_rows): the string of an id is the hint plus
    the row entries <= the id, and in the windowed form the row also
    holds the Wa words from floor(o_min/16), o_min = 32*b + hint*(k-1).
    Reads clip to the ends of kmer_cum and s32. sidk32 holds the hints of
    blocks first, first + 1, ..."""
    hint = sidk32.astype(np.int64)
    kidx = np.clip(hint[:, None] + np.arange(1, C + 1, dtype=np.int64)[None, :],
                   0, len(kmer_cum) - 1)
    cols = [sidk32[:, None], kmer_cum[kidx].astype(np.uint32)]
    if acc_windowed(k, C):
        Wa = acc_win_words(k, C)
        blk = np.arange(first, first + len(sidk32), dtype=np.int64)
        ws = (blk * 32 + hint * (k - 1)) >> 4
        widx = np.clip(ws[:, None] + np.arange(Wa, dtype=np.int64)[None, :],
                       0, len(s32) - 1)
        cols.append(s32[widx])
    return np.concatenate(cols, axis=1)


def vstart32_from_index(index):
    """vstart32 alone, for a table cache written without it."""
    n = -(-16 * 2 * len(index.strings64) // 32)
    return _vstart_fill(index, int(index.num_chars))(0, n)


def with_access_tables(index, cfg, host_arrs):
    """A table dict from the JAX package (or its .npy cache) with vstart32
    and acc_rows rebuilt where the cache predates them or holds acc_rows of
    another width, as DeviceEngine.__init__ does."""
    host_arrs = dict(host_arrs)
    if "vstart32" not in host_arrs:
        host_arrs["vstart32"] = vstart32_from_index(index)
    acc = host_arrs.get("acc_rows")
    if acc is None or acc.shape[1] != acc_width(cfg):
        host_arrs["acc_rows"] = acc_rows(host_arrs["sidk32"], host_arrs["kmer_cum"],
                                         cfg.access_C, host_arrs["strings32"], cfg.k)
    return host_arrs


def cand_block_width(cfg):
    return 1 + cfg.vbits_words + cfg.win_words + cfg.quad_w


def head_loads(n, R):
    """16-byte loads that stage a row head of n words (csrc/stage.cuh: the
    aligned segments that cover it), the mean over the rows of a table of
    R-word rows, whose heads start at word o = r*R mod 4 of a segment."""
    return sum((r * R % 4 + n + 3) >> 2 for r in range(8)) / 8


def head_sectors(n, R):
    """32-byte sectors a row head of n words touches, the mean over the
    rows of a table of R-word rows (the table starts on a sector)."""
    return sum((4 * r * R % 32 + 4 * n + 31) >> 5 for r in range(8)) / 8


def row_pad(cfg):
    """Zero words at the end of a v2 cw_row that make it a multiple of 4
    words, where that stages its head (status, cw_a, candidate 0) in fewer
    16-byte loads or touches fewer 32-byte sectors than the unpadded row;
    else 0. v1 rows are never padded."""
    n = 2 + cand_block_width(cfg)
    R = 2 + (2 if cfg.c1_in_row else 1) * cand_block_width(cfg)
    pad = -R % 4
    if not cfg.row_v2 or not pad:
        return 0
    fewer = (head_loads(n, R + pad) < head_loads(n, R)
             or head_sectors(n, R + pad) < head_sectors(n, R))
    return pad if fewer else 0


def row_width(cfg):
    """cw_row width in u32 words: [status|b, a] + 1 or 2 candidate blocks
    (+ row_pad)."""
    return 2 + (2 if cfg.c1_in_row else 1) * cand_block_width(cfg) + row_pad(cfg)


def port_tables(cfg, host_arrs, index=None):
    """host_arrs in this module's layout for cfg. A JAX package dict of the
    legacy heavy path (heavy_rows, sk_positions: an index whose skew
    classes lack hindex; or an earlier tree's cache of it) gets sk_hrows
    in their place, heavy_rows' rows at the index's class_hindex, so it
    needs the index. A JAX package v2 dict (its blocks' resolve words kid0,
    sid0, rel_ep1; sshash_tpu.engine._device_arrays) loses sid0 from every
    block of cw_row, mid_rows and sk_hrows, and its cw_row gains row_pad's
    zero words; tables already in this layout pass as they are. A cw_row
    of any other width is refused, naming both widths. The blocks' width
    tells the two apart (a padded cw_row may be as wide as JAX's; mid_rows
    is never padded). Conversion copies a piece of rows at a time, so a
    memory-mapped cache is read once."""
    if any(key in host_arrs for key in LEGACY_KEYS):
        host_arrs = _one_hop(cfg, host_arrs, index)
    have, want = host_arrs["cw_row"].shape[1], row_width(cfg)
    R1 = cand_block_width(cfg)
    blk = host_arrs["mid_rows"].shape[1]
    if have == want and blk == R1:
        return host_arrs
    nblk = 2 if cfg.c1_in_row else 1
    if not (cfg.row_v2 and have == 2 + nblk * (R1 + 1) and blk == R1 + 1):
        raise ValueError(
            f"stale host_arrs: cw_row has {have} words a row and mid_rows {blk}, this "
            f"engine expects {want} and {R1} "
            f"({'v2' if cfg.row_v2 else 'v1'} rows of {R1}-word candidate blocks"
            + (f"; the JAX package's v2 rows, {2 + nblk * (R1 + 1)} words, are converted"
               if cfg.row_v2 else "")
            + "); recompute with layout.device_arrays(index, row_format)")
    sid0 = 1 + cfg.vbits_words + cfg.win_words + 1  # between kid0 and rel_ep1
    keep = np.delete(np.arange(R1 + 1), sid0)
    cols = np.concatenate([[0, 1]] + [2 + j * (R1 + 1) + keep for j in range(nblk)])
    out = dict(host_arrs)
    out["cw_row"] = _take_columns(host_arrs["cw_row"], cols, want)
    for name in ("mid_rows", "sk_hrows"):
        if name in out:
            out[name] = _take_columns(out[name], keep, R1)
    return out


def _one_hop(cfg, host_arrs, index):
    """A legacy heavy path's dict (heavy_rows, sk_positions) with sk_hrows
    in their place: the heavy_rows row of each skew slot's class_hindex,
    keyed as the slots of sk_positions are (the same pos_off). Without
    skew classes (or beside the JAX package's sk_hrows: its heavy_rows of
    zeros) nothing reads them, and they go."""
    out = {key: v for key, v in host_arrs.items() if key not in LEGACY_KEYS}
    if cfg.has_skew and "sk_positions" in host_arrs:
        if index is None:
            raise ValueError("tables of the legacy heavy path (heavy_rows, sk_positions) are "
                             "converted to sk_hrows from the index: pass it")
        parts = index.skew_partitions[:NUM_SKEW]
        slots = np.concatenate([_expand_to_slots(h, p.mphf)
                                for h, p in zip(class_hindex(index), parts)])
        heavy = host_arrs["heavy_rows"]
        out["sk_hrows"] = np.asarray(heavy[np.clip(slots.astype(np.int64), 0, len(heavy) - 1)])
    return out


def _take_columns(arr, cols, width, piece=1 << 22):
    """(n, width) uint32: arr's columns cols, then zeros, piece rows at a
    time."""
    out = np.zeros((len(arr), width), np.uint32)
    for lo in range(0, len(arr), piece):
        out[lo: lo + piece, :len(cols)] = arr[lo: lo + piece][:, cols]
    return out


def _expand_to_slots(arr, mphf):
    """Re-key an array by raw MPHF slot in [0, table_size): slot < n reads
    arr[slot], overflow slots read through the remap (evaluation then needs
    no remap gather; untaken slots alias arr[remap=0])."""
    if isinstance(mphf, PartitionedMPHF):
        return mphf.expand_to_slots(arr)
    ts = max(1, mphf.table_size)
    out = np.zeros(ts, dtype=arr.dtype)
    n = min(mphf.n, len(arr))
    out[:n] = arr[:n]
    if ts > mphf.n and len(arr):
        rmp = _get(mphf.remap, np.arange(ts - mphf.n))
        out[mphf.n:] = arr[np.clip(rmp, 0, len(arr) - 1)]
    return out


def _pilots_u32(mphf):
    p = mphf.pilots
    return p.to_array(np.uint32) if isinstance(p, CompactVector) else p


def _pack_pilots(vals, w):
    """Pack u32 pilots (< 2^w) into u32 words, 32//w per word, little end
    first; pads to a whole word."""
    if w == 32:
        return vals.astype(np.uint32)
    ppw = 32 // w
    v = np.pad(vals, (0, (-len(vals)) % ppw)).astype(np.uint32)
    v = v.reshape(-1, ppw) << (np.arange(ppw, dtype=np.uint32) * w)
    return np.bitwise_or.reduce(v, axis=1)


def _nz(x):
    """Never ship a zero-length table (clipped reads land in row 0)."""
    return x if len(x) else np.zeros(1, dtype=x.dtype)


def _seedrows(seedmixes):
    return np.stack([(seedmixes >> np.uint64(32)).astype(np.uint32),
                     (seedmixes & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=1)


def fused_rows(dpos, s32, ep, k, m, row_v2):
    """(n,) candidate char offsets -> (n, R1) u32 candidate blocks
    [col0, valid-start bits, packed string window, resolve words]
    (engine._device_arrays.fused_rows). The candidate's possible kmer
    starts span [dpos-(k-m), dpos], shorter than any string, so at most one
    string boundary falls inside: the resolve words resolve either side.

      v1: col0 = dpos, quad [sid0, ep0, ep1, ep2];
      v2: col0 = dpos - 16 * (max(0, dpos-(k-m)) >> 4), the offset inside
          the window, and [kid0, rel_ep1] with kid0 = dpos - sid0*(k-1)
          and rel_ep1 = clip(ep1 - (dpos-(k-m)), 0, k-m+1): a match at
          position try p has id kid0 - p - over*(k-1), over = (k-m-p) >=
          rel_ep1 (the JAX package's sid0 between them is never read).

    Every offset stays int64 until its u32 field. A start o is valid iff
    o + k <= the end of o's string. s32 is read with int64 word indices
    only, so any array-like that takes them serves (a view of a larger
    string set). Chunked to bound the (n, Ww) window intermediates."""
    CH = 16 << 20
    if len(dpos) > CH:
        return np.concatenate([fused_rows(dpos[i: i + CH], s32, ep, k, m, row_v2)
                               for i in range(0, len(dpos), CH)])
    kmw = k - m
    Ww, Wv = win_words(k, m), vbits_words(k, m)
    last = len(ep) - 1
    c0 = np.asarray(dpos, dtype=np.int64)
    lo = np.maximum(c0 - kmw, 0)
    wlo = lo >> 4
    win = np.asarray(s32[np.clip(wlo[:, None] + np.arange(Ww)[None, :], 0, len(s32) - 1)],
                     dtype=np.uint32)
    sid0 = np.searchsorted(ep, lo, side="right") - 1
    ep1, ep2 = (ep[np.clip(sid0 + j, 0, last)] for j in (1, 2))
    # start j of the span (char offset base + j) is valid in [0, ep1-k] of
    # sid0's string or in [ep1, ep2-k] of the next: two bit ranges
    base = c0 - kmw
    # one u32 word of the span's kmw + 1 bits at a time
    vbp = np.empty((len(c0), Wv), np.uint32)
    for w in range(Wv):
        b0, n = base + 32 * w, min(32, kmw + 1 - 32 * w)
        vbp[:, w] = _bit_range(-b0, ep1 - k - b0, n) | _bit_range(ep1 - b0, ep2 - k - b0, n)
    if row_v2:
        rsv = np.stack([(c0 - sid0 * (k - 1)).astype(np.uint32),
                        np.clip(ep1 - (c0 - kmw), 0, kmw + 1).astype(np.uint32)], axis=1)
        col0 = (c0 - (wlo << 4)).astype(np.uint32)
    else:
        rsv = np.stack([sid0, ep[np.clip(sid0, 0, last)], ep1, ep2], axis=1).astype(np.uint32)
        col0 = c0.astype(np.uint32)
    return np.concatenate([col0[:, None], vbp, win, rsv], axis=1)


def _bit_range(lo, hi, n):
    """uint64 masks with bits lo..hi (int64 arrays, inclusive) set, cut to
    bits 0..n-1 (n <= 32 here)."""
    a = np.clip(lo, 0, n)
    b = np.maximum(np.clip(hi + 1, 0, n), a)
    one = np.uint64(1)
    return (one << b.astype(np.uint64)) - (one << a.astype(np.uint64))


class _Spec(NamedTuple):
    """A table to build: its shape and dtype, and fill(lo, hi) -> its rows
    [lo, hi). whole: built in one call, whatever the chunk size."""

    shape: tuple
    dtype: type
    fill: object
    whole: bool = False


def _small(arr):
    return _Spec(arr.shape, arr.dtype, lambda lo, hi: arr[lo:hi], True)


def _cw_rows(index, cfg, rows, ids, mid_arr):
    """cw_row rows of the minimizers `ids` (int64): [status | b<<2, a, the
    candidate-0 block, (the candidate-1 block), (row_pad zeros)]. A heavy
    codeword's a is its bucket's begin in heavy_load_buckets."""
    status, a, b = decode_codeword(index.codewords.get(ids))
    mid = status == 1
    msize = b.astype(np.int64)
    a = a.astype(np.int64)
    a = np.where(mid, index.begin_buckets_of_size[np.where(mid, msize, 0)].astype(np.int64)
                 + a * msize, a)
    cand0 = a
    if len(mid_arr):
        cand0 = np.where(mid, mid_arr[np.clip(a, 0, len(mid_arr) - 1)], cand0)
    R1 = cand_block_width(cfg)
    out = np.empty((len(ids), row_width(cfg)), np.uint32)
    out[:, 0] = status.astype(np.uint32) | (b.astype(np.uint32) << 2)
    out[:, 1] = (a & 0xFFFFFFFF).astype(np.uint32)
    heavym = status == 2
    c0rows = rows(np.where(heavym, 0, cand0))
    c0rows[heavym, 1:] = 0
    c0rows[heavym, 0] = cand0[heavym]
    out[:, 2: 2 + R1] = c0rows
    del c0rows
    if cfg.c1_in_row:
        has2 = mid & (b >= 2)
        cand1 = np.zeros_like(cand0)
        if len(mid_arr):
            cand1 = np.where(has2, mid_arr[np.clip(a + 1, 0, len(mid_arr) - 1)], 0)
        c1rows = rows(cand1)
        c1rows[~has2, :] = 0
        out[:, 2 + R1: 2 + 2 * R1] = c1rows
    out[:, 2 + (2 if cfg.c1_in_row else 1) * R1:] = 0
    return out


def heavy_kmers(index, chunk=1 << 16, threads=1):
    """Every kmer of the index's heavy buckets, found from the buckets'
    positions alone: (keys, cls, begin, offset), keys the (n, W) uint32
    kmers the skew classes hash (the smaller strand in a canonical
    index), cls their skew class, begin their bucket's begin in
    heavy_load_buckets and offset their char offset, each offset once. A
    kmer whose minimizer sits at char p starts in [p - (k - m), p] of p's
    string, so each heavy position's k - m + 1 starts there are read, a
    chunk of positions at a time on `threads` threads, and kept where the
    kmer's bucket minimizer has a heavy codeword of the position's own
    bucket: a kmer of another bucket never comes back."""
    from . import kmer as K
    from . import oracle

    k, m = index.k, index.m
    heavy_arr = np.asarray(index.heavy_load_buckets).astype(np.int64)
    status, a, _ = decode_codeword(np.asarray(index.codewords))
    begins = np.unique(a[status == 2].astype(np.int64))
    ep = index.string_endpoints.astype(np.int64)
    magic = H.mixer_magic(index.seed)
    W = -(-2 * k // 32)

    def scan(lo):
        p = heavy_arr[lo: lo + chunk]
        beg = begins[np.searchsorted(begins, np.arange(lo, lo + len(p)), side="right") - 1]
        sid = np.searchsorted(ep, p, side="right") - 1
        o = p[:, None] - np.arange(k - m + 1)[None, :]
        ok = (o >= ep[sid][:, None]) & (o + k <= ep[sid + 1][:, None])
        o, beg = o[ok], np.broadcast_to(beg[:, None], ok.shape)[ok]
        km = K.read_kmers_at(index.strings64, o, k)
        mv, _ = oracle.compute_minimizer(km, k, m, magic)
        if index.canonical:
            rc = K.revcomp_kmers(km, k)
            mv = np.minimum(mv, oracle.compute_minimizer(rc, k, m, magic)[0])
            km = np.where(oracle._kmer_less_mask(rc, km)[:, None], rc, km)
        st, ca, cb = decode_codeword(index.codewords.get(index.minimizer_mphf(mv)))
        keep = (st == 2) & (ca.astype(np.int64) == beg)
        return (K.kmers_to_u32(km[keep], k), cb[keep].astype(np.int64), beg[keep], o[keep])

    parts = list(ordered_map(scan, range(0, len(heavy_arr), chunk), threads))
    if not parts:
        return (np.zeros((0, W), np.uint32), *(np.zeros(0, np.int64) for _ in range(3)))
    keys, cls, beg, off = (np.concatenate(x) for x in zip(*parts))
    _, first = np.unique(off, return_index=True)
    return keys[first], cls[first], beg[first], off[first]


def class_hindex(index, threads=1):
    """Each skew class's hindex (uint32[n], by class MPHF position: the
    kmer's row in heavy_load_buckets). A class that carries one (v1.2+
    builds) keeps it; a pre-v1.2 class's is derived by the index build's
    own formula (builder/assemble.py: hindex[slot] = bucket begin +
    position in the bucket): hindex[slot_c(x)] = begin(x) + positions_c[slot_c(x)]
    for every kmer x of heavy_kmers, with the class's own MPHF, partitioned
    or plain. Raises if a class's slots are not all reached."""
    parts = index.skew_partitions[:NUM_SKEW]
    if all(p.hindex is not None for p in parts):
        return [p.hindex for p in parts]
    keys, cls, beg, _ = heavy_kmers(index, threads=threads)
    out = []
    for i, p in enumerate(parts):
        if p.hindex is not None or p.mphf.n == 0:
            out.append(p.hindex if p.hindex is not None else np.zeros(0, np.uint32))
            continue
        sel = cls == i
        slot = p.mphf.eval_words(keys[sel])
        if len(np.unique(slot)) != p.mphf.n:
            raise ValueError(f"skew class {i}: {len(np.unique(slot))} of its {p.mphf.n} slots "
                             f"reached from the heavy buckets")
        h = np.zeros(p.mphf.n, np.uint32)
        h[slot] = (beg[sel] + p.positions[slot].astype(np.int64)).astype(np.uint32)
        out.append(h)
    return out


def _lookup_specs(index, cfg, rows, threads=1):
    """The probe's tables (cw_row, mid_rows, pilots, mphf_seedrows and the
    skew tables) from the index's codewords, as _Spec's, with rows(dpos)
    -> candidate blocks for int64 candidate char offsets (fused_rows bound
    to the index's strings). cw_row is keyed by raw MPHF slot: slot s
    holds minimizer src[s]'s row (_expand_to_slots of the minimizer ids).
    A pre-v1.2 index's hindex is derived here, on `threads` threads."""
    mid_arr = np.asarray(index.mid_load_buckets).astype(np.int64)
    heavy_arr = np.asarray(index.heavy_load_buckets).astype(np.int64)
    R1 = cand_block_width(cfg)
    f = index.minimizer_mphf
    src = _expand_to_slots(np.arange(len(index.codewords), dtype=np.int64), f)
    specs = {"cw_row": _Spec((len(src), row_width(cfg)), np.uint32,
                             lambda lo, hi: _cw_rows(index, cfg, rows, src[lo:hi], mid_arr))}
    if len(mid_arr):
        specs["mid_rows"] = _Spec((len(mid_arr), R1), np.uint32,
                                  lambda lo, hi: rows(mid_arr[lo:hi]))
    else:
        specs["mid_rows"] = _small(np.zeros((1, R1), np.uint32))
    specs["pilots"] = _small(_nz(_pack_pilots(_pilots_u32(f), pilot_width(f))))
    if isinstance(f, PartitionedMPHF):
        specs["mphf_seedrows"] = _small(_seedrows(f.seedmixes()))

    # skew size classes: concatenated pilots, 8 per-class parameter slots,
    # and per slot the hindex-keyed heavy row (sk_hrows): a pre-v1.2
    # class's hindex is derived (class_hindex), so every form reads one row
    # (without skew only the classes' slot counts matter: pos_off)
    parts = index.skew_partitions[:NUM_SKEW]
    keyed = class_hindex(index, threads) if cfg.has_skew else [p.positions for p in parts]
    params = {name: np.zeros(NUM_SKEW, dtype=np.uint32) for name in SKEW_PARAMS}
    params["nbuckets"][:] = 1
    params["table"][:] = 1
    params["np2"][:] = 1
    sk_pilots, sk_aux, sk_seedrows = [], [], []
    for i, part in enumerate(parts):
        fp = part.mphf
        smix = int(H.splitmix64(np.uint64(fp.seed)))
        params["seedmix_hi"][i] = smix >> 32
        params["seedmix_lo"][i] = smix & 0xFFFFFFFF
        params["pilot_off"][i] = sum(len(x) for x in sk_pilots)
        params["pos_off"][i] = sum(len(x) for x in sk_aux)
        if cfg.skew_partitioned:
            params["seed_off"][i] = sum(len(x) for x in sk_seedrows)
            if isinstance(fp, PartitionedMPHF):
                params["table"][i] = max(1, fp.part_table)
                params["nbuckets"][i] = fp.part_buckets
                params["np2"][i] = fp.num_partitions
                sk_seedrows.append(_seedrows(fp.seedmixes()))
            else:  # empty size class
                sk_seedrows.append(np.zeros((1, 2), np.uint32))
        else:
            params["table"][i] = max(1, fp.table_size)
            params["nbuckets"][i] = fp.num_buckets
        sk_pilots.append(_pack_pilots(_pilots_u32(fp), cfg.sk_pilot_w))
        sk_aux.append(_expand_to_slots(keyed[i], fp))
    if cfg.skew_partitioned:
        specs["sk_seedrows"] = _small(np.concatenate(sk_seedrows) if sk_seedrows
                                      else np.zeros((1, 2), np.uint32))
    specs["sk_pilots"] = _small(_nz(np.concatenate(sk_pilots) if sk_pilots
                                    else np.zeros(0, np.uint32)))
    if cfg.has_skew:
        gidx = np.clip(np.concatenate(sk_aux).astype(np.int64), 0, len(heavy_arr) - 1)
        specs["sk_hrows"] = _Spec((len(gidx), R1), np.uint32,
                                  lambda lo, hi: rows(heavy_arr[gidx[lo:hi]]))
    for name, v in params.items():
        specs[f"sk_{name}"] = _small(v)
    return specs


def _vstart_fill(index, nchars):
    """fill(lo, hi) of vstart32: the valid-start bits of chars [32 lo,
    32 hi), a kmer starting at char o iff o + k <= the end of o's string,
    counted as (string starts <= o) - (string ends - (k-1) <= o) > 0
    (zero past num_chars)."""
    ep = index.string_endpoints.astype(np.int64)
    starts, ends = ep[:-1], ep[1:] - (index.k - 1)

    def fill(lo, hi):
        c0, c1 = 32 * lo, min(32 * hi, nchars)
        v = np.zeros(32 * (hi - lo), dtype=bool)
        if c1 > c0:
            n = c1 - c0
            acc = np.zeros(n, dtype=np.int64)
            acc[0] = np.searchsorted(starts, c0) - np.searchsorted(ends, c0)
            for pos, d in ((starts, 1), (ends, -1)):
                sel = pos[(pos >= c0) & (pos < c1)] - c0
                acc += d * np.bincount(sel, minlength=n)
            v[:n] = np.cumsum(acc) > 0
        return np.packbits(v, bitorder="little").view(np.uint32)

    return fill


def table_specs(index, row_format=None, threads=1):
    """Every table of device_arrays as a _Spec, in the row format
    StaticCfg(index, row_format) picks (a pre-v1.2 index's hindex derived
    on `threads` threads)."""
    cfg = StaticCfg(index, row_format)
    k, m = index.k, index.m
    ep = index.string_endpoints.astype(np.int64)
    kmer_cum64 = ep - np.arange(len(ep)) * (k - 1)
    kmer_cum32 = kmer_cum64.astype(np.uint32)
    nkb = (index.num_kmers + 31) // 32 + 1
    # the packed strings as u32 words, little word first: the u64 words'
    # own bytes (kmer.pack_words_to_u32 without the copy)
    s32 = np.ascontiguousarray(index.strings64, dtype=np.uint64).view(np.uint32)

    def sidk(lo, hi):
        return (np.searchsorted(kmer_cum64, np.arange(lo, hi, dtype=np.int64) * 32,
                                side="right") - 1).astype(np.uint32)

    specs = {
        "strings32": _Spec(s32.shape, np.uint32, lambda lo, hi: s32[lo:hi]),
        "vstart32": _Spec((-(-16 * len(s32) // 32),), np.uint32,
                          _vstart_fill(index, int(index.num_chars))),
        "sidk32": _Spec((nkb,), np.uint32, sidk),
        "kmer_cum": _small(kmer_cum32),
        "acc_rows": _Spec((nkb, acc_width(cfg)), np.uint32,
                          lambda lo, hi: acc_rows(sidk(lo, hi), kmer_cum32, cfg.access_C, s32,
                                                  k, first=lo)),
    }
    specs.update(_lookup_specs(index, cfg,
                               lambda dpos: fused_rows(dpos, s32, ep, k, m, cfg.row_v2),
                               threads))
    w = index.weights
    if w is not None:  # check_supported refuses weights that u32 would wrap
        specs["w_value_ids"] = _small(w.interval_value_ids.astype(np.uint32))
        specs["w_endpoints"] = _small(w.interval_endpoints.astype(np.uint32))
        specs["w_dictionary"] = _small(w.dictionary.astype(np.uint32))
    # the kernels address rows with int32
    for name, spec in specs.items():
        if spec.shape[0] >= 1 << 31:
            raise ValueError(f"table {name!r} has {spec.shape[0]} rows (>= 2^31); "
                             f"rows are int32-addressed")
    return specs


def fill_tables(specs, out, nchars=None, chunk=None, threads=1):
    """Write every spec's rows into out[name] (anything that takes
    out[name][lo:hi] = rows), a range of rows at a time: each table in
    pieces of about chunk / nchars of its rows (chunk None: whole), on a
    pool of `threads` threads (pool.ordered_map: 2 * threads pieces in
    flight). Returns out."""
    jobs = []
    for name, spec in specs.items():
        n = spec.shape[0]
        step = max(1, n if spec.whole or chunk is None else -(-n * chunk // max(1, nchars)))
        jobs += [(name, lo, min(n, lo + step)) for lo in range(0, max(n, 1), step)]

    def run(job):
        name, lo, hi = job
        out[name][lo:hi] = specs[name].fill(lo, hi)

    for _ in ordered_map(run, jobs, threads):
        pass
    return out


def device_arrays(index, row_format=None, chunk=None, threads=1):
    """Host Index -> dict of numpy uint32 tables (see module doc), in the
    row format StaticCfg(index, row_format) picks. chunk: build each table
    about chunk chars' worth of rows at a time (None: at once), on
    `threads` threads; the arrays are the same at any chunk and thread
    count. write_tables writes them to .npy files instead."""
    specs = table_specs(index, row_format, threads)
    out = {name: np.empty(spec.shape, spec.dtype) for name, spec in specs.items()}
    return fill_tables(specs, out, int(index.num_chars), chunk, threads)


def lookup_tables(index, cfg, rows):
    """The probe's tables alone from the index's codewords, with rows(dpos)
    -> candidate blocks for int64 candidate char offsets: a caller's own
    rows over device_arrays' probe tables (the tests' tables past 2^32
    chars, on views)."""
    specs = _lookup_specs(index, cfg, rows)
    out = {name: np.empty(spec.shape, spec.dtype) for name, spec in specs.items()}
    return fill_tables(specs, out)


class _NpyRows:
    """Rows of a .npy file made by np.lib.format.open_memmap, written in
    place with positional writes (no mapping held, so the writer's
    resident memory stays that of one piece)."""

    def __init__(self, path, shape, dtype):
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)
        self.offset = mm.offset
        self.row_bytes = mm.dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
        del mm
        self.fd = os.open(path, os.O_WRONLY)

    def __setitem__(self, sl, rows):
        buf = memoryview(np.ascontiguousarray(rows)).cast("B")
        pos = self.offset + sl.start * self.row_bytes
        while len(buf):
            n = os.pwrite(self.fd, buf, pos)
            buf, pos = buf[n:], pos + n

    def close(self):
        os.close(self.fd)


def write_tables(index, directory, row_format=None, chunk=1 << 24, threads=1):
    """device_arrays' tables written to directory/<name>.npy, each built
    and written chunk chars' worth of rows at a time on `threads`
    threads, so that the host holds pieces of them, not the tables.
    Returns the tables loaded with mmap_mode="r"."""
    specs = table_specs(index, row_format, threads)
    os.makedirs(directory, exist_ok=True)
    out = {name: _NpyRows(os.path.join(directory, name + ".npy"), spec.shape, spec.dtype)
           for name, spec in specs.items()}
    try:
        fill_tables(specs, out, int(index.num_chars), chunk, threads)
    finally:
        for w in out.values():
            w.close()
    _record_layout(directory, StaticCfg(index, row_format))
    return load_tables(directory)


# the version of each row format's layout, recorded beside a table cache
# (LAYOUT_FILE) and in capacity_run.py's cache keys: v2 is at 2 since its
# blocks dropped sid0 (resolve words kid0, rel_ep1); v1 rows never changed
LAYOUT_VERSION = {"v1": 1, "v2": 2}
LAYOUT_FILE = "layout.json"


def _record_layout(directory, cfg):
    import json

    fmt = "v2" if cfg.row_v2 else "v1"
    with open(os.path.join(directory, LAYOUT_FILE), "w") as f:
        json.dump({"layout_version": LAYOUT_VERSION[fmt], "row_format": fmt,
                   "row_width": row_width(cfg), "block_width": cand_block_width(cfg)}, f)


def save_tables(host_arrs, directory, cfg):
    """A table dict of cfg's layout (device_arrays) written to
    directory/<name>.npy whole, with the layout record load_tables
    checks."""
    os.makedirs(directory, exist_ok=True)
    for name, v in host_arrs.items():
        np.save(os.path.join(directory, name + ".npy"), v)
    _record_layout(directory, cfg)


def load_tables(directory):
    """Every directory/<name>.npy (write_tables' or save_tables' output, or
    the JAX package's .npy cache), loaded with mmap_mode="r": a host_arrs
    dict whose tables stay on disk until read. A cache without a layout
    record (the JAX package's, or an earlier tree's, whose v2 blocks still
    hold sid0) loads as it is: tables_from_host converts it through
    port_tables, which refuses any width it cannot convert. A cache whose
    record names other widths than its files hold is refused."""
    import json

    arrs = {f[:-4]: np.load(os.path.join(directory, f), mmap_mode="r")
            for f in sorted(os.listdir(directory)) if f.endswith(".npy")}
    path = os.path.join(directory, LAYOUT_FILE)
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        have = (arrs["cw_row"].shape[1], arrs["mid_rows"].shape[1])
        if have != (rec["row_width"], rec["block_width"]):
            raise ValueError(
                f"{directory}: cw_row {have[0]} words a row and mid_rows {have[1]}, its layout "
                f"record {rec['row_width']} and {rec['block_width']} "
                f"({rec['row_format']} layout version {rec['layout_version']}): rebuild it "
                f"with layout.write_tables")
    return arrs


def take_rows(table, idx):
    """table[idx] as u32 values in int64 (idx: int64 u32 values), clipping
    idx the way the JAX package's jnp.take(..., idx.astype(int32),
    mode="clip") does: an index >= 2^31 turns negative there and clips to
    row 0."""
    import torch

    n = table.shape[0]
    i = torch.where(idx >= 1 << 31, torch.zeros_like(idx), idx.clamp(max=n - 1))
    return table.index_select(0, i).to(torch.int64) & 0xFFFFFFFF


def tables_from_host(host_arrs, device, cfg, index=None):
    """The kernels' tables of cfg's layout as int32 tensors (the u32 bits)
    on `device`, from this module's device_arrays or the JAX package's
    _device_arrays dict (or its .npy cache, completed by
    with_access_tables), in either row format and either skew form: the
    dict goes through port_tables first (a JAX v2 dict's blocks lose sid0;
    a legacy heavy path becomes sk_hrows through `index`, which it then
    needs; a width of neither layout is refused). Optional lookup tables missing
    from the dict get one zero row, the eight sk_* parameter vectors
    become one (8, 8) `sk_params` table in SKEW_PARAMS order, and the
    weight tables come along when the dict has them."""
    import torch

    host_arrs = port_tables(cfg, host_arrs, index)
    R1 = host_arrs["mid_rows"].shape[1]
    fill = {"mphf_seedrows": np.zeros((1, 2), np.uint32),
            "sk_seedrows": np.zeros((1, 2), np.uint32),
            "sk_hrows": np.zeros((1, R1), np.uint32)}
    host = {name: host_arrs.get(name, fill.get(name))
            for name in LOOKUP_KEYS + OPTIONAL_KEYS}
    host["sk_params"] = np.stack([host_arrs[f"sk_{p}"] for p in SKEW_PARAMS])
    host.update({name: host_arrs[name] for name in ACCESS_KEYS})
    host.update({name: host_arrs[name] for name in WEIGHT_KEYS if name in host_arrs})
    out = {}
    device = torch.device(device)
    stage = None
    if device.type == "cuda":
        # one pinned piece for every table's copies
        stage = torch.empty(UPLOAD_PIECE // 4, dtype=torch.int32, pin_memory=True)
    for name, arr in host.items():
        if arr.dtype != np.uint32:
            raise ValueError(f"table {name!r} is {arr.dtype}, expected uint32")
        out[name] = upload(arr, device, stage)
    return out


UPLOAD_PIECE = 1 << 28  # bytes a piece


def upload(arr, device, stage=None):
    """A uint32 table as an int32 tensor of its bits on `device`. To a card
    it goes a piece at a time through `stage` (a pinned int32 buffer of at
    least one row; tables_from_host's holds UPLOAD_PIECE bytes); the
    pieces of a table loaded with mmap_mode are released from this
    process as they land (madvise DONTNEED on their pages, which stay in
    the page cache), so the host holds the file once, not a copy beside
    it. On the CPU an array the tensor may share is shared; a read-only
    one (a memory map) is copied."""
    import torch

    if device.type != "cuda":
        arr = np.ascontiguousarray(arr) if arr.flags.writeable else np.array(arr)
        return torch.from_numpy(arr.view(np.int32))
    out = torch.empty(arr.shape, dtype=torch.int32, device=device)
    if not arr.size:
        return out
    row_bytes = arr.nbytes // len(arr)
    rows = max(1, stage.numel() * 4 // row_bytes)
    buf = stage.numpy()
    mm = getattr(arr, "_mmap", None)
    head = arr.offset % mmap.ALLOCATIONGRANULARITY if mm is not None else 0
    done = 0
    for lo in range(0, len(arr), rows):
        part = arr[lo: lo + rows]
        n = part.size
        np.copyto(buf[:n].reshape(part.shape), part.view(np.int32), casting="no")
        out[lo: lo + len(part)].copy_(stage[:n].view(out[lo: lo + len(part)].shape))
        if mm is not None:
            end = (head + (lo + len(part)) * row_bytes) // mmap.PAGESIZE * mmap.PAGESIZE
            if end > done:
                mm.madvise(mmap.MADV_DONTNEED, done, end - done)
                done = end
    return out
