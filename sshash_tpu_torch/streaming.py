"""Streaming FASTA/FASTQ membership queries on PyTorch tensors.

Counterpart of sshash_tpu/streaming.py. The reference resolves reads
sequentially with O(1) per-step state (reference:
include/streaming_query.hpp:56-109). Here every position of every read is
one lane of a chunk of P lanes, and the report counters
(streaming_query_report, util.hpp:29-36) are a pure function of the
per-lane fresh-lookup results:

  * ``num_searches`` counts only POSITIVE non-extension lookups
    (streaming_query.hpp:182-188);
  * an extension happens iff the previous position was found and the
    current result is the adjacent kmer in the same string in the previous
    orientation (streaming_query.hpp:86-100);
  * the negative-minimizer cache only skips work; skipped positions count
    negative exactly like failed searches (streaming_query.hpp:150-157).

The host parts (file parsing, `derive_report`, the oracle-backed
`_Batcher` and the chunk-boundary stitch in `_DeviceStream._fold`) are
copies of the JAX package's. The device step (`make_stream_step`) takes
the same packed chunk buffer and returns the same (3, 4) counters as
sshash_tpu's step_packed / step_packed_av. It is held to the same
function, not to the same schedule: JAX picks derive_fast, derive_corr or
derive_full by miss counts for the TPU's sake; here one path runs:

  1. segments: one exclusive scan of the per-read position counts over R
     (csrc/scan.cu) gives each read's first lane;
  2. anchors: one launch (csrc/stream_anchor.cu) gives the segment-start
     and read-start bits, each group of 16 lanes' segment count before it
     (the group scan) and the kmer at every 16th lane, which one launch
     of the lookup kernel looks up;
  3. chains: per anchor, its 15 followers resolve with one string-char
     compare each (prefix-AND), giving per-lane (found, string_id,
     kmer_id, orientation) and the lanes that still need a lookup;
  4. misses: the needing lanes compacted in rank order (csrc/scan.cu), their
     kmers read (on a grid sized to the card, up to the count) and run
     through kernel 1's rank form once (both strands' minimizers of the
     ranks below the misses' count, which stays on the device); the
     negative-minimizer run-skip (JAX's gate: more than P/64 misses)
     marks run heads from kernel 1's (mv_f, mv_r) pairs; the heads
     are looked up, then the run members whose head found its minimizer
     (each rank's run head carried forward in one pass), each round one
     launch of the rank-space lookup (csrc/lookup_ranks.cu: the lookup
     kernel's lane over the ranks below the count, the five fields the
     stream reads); results scatter back. These kernels run grids sized to
     the card that stride up to the count, so their work is the misses'
     (JAX's run_windows loops windows up to it). The bucket-sharded stream
     runs the same rank-space rounds through its engine's sharded lookup
     (kernel 2's rank form on each shard, csrc/shard.cuh), and its anchors
     through kernel 1's and kernel 2's rank forms too;
  5. count: one P-wide adjacency pass gives the counters, lane 0 and the
     last lane.

Each stage is one kernel entry (csrc/stream_anchor.cu, stream_chain.cu,
stream_derive.cu; minimizer.cu and lookup_ranks.cu for the misses) with a
plain PyTorch version beside it; a CPU
tensor runs the plain version, a CUDA tensor the kernel. The plain
versions hold u32 values in int64 (or their bits in int32 tensors), as the
rest of the port does.
"""

import gzip
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from . import kmer as K
from . import native, oracle
from .constants import INVALID_UINT64
from .engine import TorchEngine, lookup_ranks, lookup_ranks_plain, make_lookup
from .ops import packed as Pk
from .ops import u64 as u
from .ops.u64 import M32

INVALID = np.uint64(INVALID_UINT64)
S = 16  # anchor stride: one full lookup per S positions on hit-dense data


# --------------------------------------------------------------- file parsing


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def parse_reads(path, fmt=None, multiline=False):
    """Yield read sequences (bytes) from a FASTA/FASTQ file (optionally .gz).

    fmt: 'fasta' | 'fastq' | None (sniff by extension like tools/query.cpp).
    multiline FASTA concatenates sequence lines per record; the reference's
    k-1 overlap carry (src/query.cpp:28-37) makes its kmer stream identical
    to processing whole records.
    """
    name = str(path)
    if fmt is None:
        base = name[:-3] if name.endswith(".gz") else name
        if base.endswith((".fq", ".fastq")):
            fmt = "fastq"
        elif base.endswith((".fa", ".fasta")):
            fmt = "fasta"
        else:
            raise ValueError(f"cannot sniff format of {name}")

    with _open(path) as f:
        if fmt == "fastq":
            # block-bulk read + one C-speed split per block (per-record
            # readline() cost ~225ms for 10K records of the bundled SRR
            # file on the throttled host — more than the whole device
            # budget of the low-hit streaming row). Line phase carries
            # across blocks so records never split.
            yield from _grouped_lines(f, group=4, seq_line=1)
        elif multiline:
            # block-bulk read + C-speed translate: the per-line Python loop
            # cost ~90ms on the 4.9MB salmonella genome (throttled host), a
            # visible slice of the streaming end-to-end budget. Records are
            # split on line-initial '>'; newlines strip in one pass. Blocks
            # carry the trailing partial record, so resident memory is one
            # block + one record — never the whole file.
            for rec, first in _ml_records(f):
                if first and not rec.startswith(b">"):
                    seq = rec.translate(None, b"\r\n")  # headerless lines
                else:
                    nl = rec.find(b"\n")
                    seq = rec[nl + 1:].translate(None, b"\r\n") if nl >= 0 else b""
                if seq:
                    yield seq
        else:  # 2-line fasta
            yield from _grouped_lines(f, group=2, seq_line=1)


def _ml_records(f, block=1 << 25):
    """Yield (record_bytes, is_first_record) from a multiline FASTA, reading
    in bulk blocks: records split on the line-initial '>' separator; the
    trailing partial record carries into the next block, so a record is
    always yielded whole and resident memory stays ~block + one record.
    The carry is a LIST of chunks joined only when a separator appears, so
    a record spanning many blocks costs one join, not one per block."""
    carry = []  # chunks of the current (unterminated) record
    first = True
    while True:
        data = f.read(block)
        if not data:
            break
        # the separator may live inside `data` or straddle the boundary
        # (carry ends with '\n', data starts with '>')
        straddle = carry and carry[-1].endswith(b"\n") and data.startswith(b">")
        if b"\n>" not in data and not straddle:
            carry.append(data)
            continue
        parts = (b"".join(carry) + data).split(b"\n>")
        carry = [parts.pop()]
        for rec in parts:
            yield rec, first
            first = False
    if carry:
        rec = b"".join(carry)
        if rec:
            yield rec, first


def _grouped_lines(f, group, seq_line, block=1 << 25):
    """Yield line `seq_line` of every `group`-line record, reading in
    C-speed bulk blocks with a line-phase carry (so a record spanning a
    block boundary is never split). Tolerates a truncated final record the
    way the readline drivers did: the sequence line is yielded if present."""
    pending = []
    tail = b""
    while True:
        data = f.read(block)
        if not data:
            break
        if b"\r" in data:
            data = data.replace(b"\r", b"")
        lines = (tail + data).split(b"\n")
        tail = lines.pop()  # possibly-incomplete last line
        pending.extend(lines)
        ngroups = len(pending) // group
        for i in range(ngroups):
            yield pending[i * group + seq_line]
        del pending[: ngroups * group]
    if tail:
        pending.append(tail)
    if len(pending) > seq_line:
        yield pending[seq_line]


# ------------------------------------------------------------- report derive


def derive_report(found, string_id, kmer_id, orientation, valid, first_pos):
    """streaming_query_report counters from per-position fresh results.

    first_pos: bool mask, True at each read's first kmer position (breaks
    extension chains across reads; reference reset(), src/query.cpp:58).
    """
    found = np.asarray(found, dtype=bool) & valid
    prev = np.roll(found, 1)
    prev[0] = False
    same_read = ~first_pos

    ext = (
        found
        & prev
        & same_read
        & (string_id == np.roll(string_id, 1))
        & (orientation == np.roll(orientation, 1))
        & (kmer_id.astype(np.int64) == np.roll(kmer_id.astype(np.int64), 1) + np.roll(orientation, 1))
    )
    num_kmers = int(len(found))
    num_positive = int(found.sum())
    num_extensions = int(ext.sum())
    num_invalid = int((~valid).sum())
    return {
        "num_kmers": num_kmers,
        "num_positive_kmers": num_positive,
        "num_negative_kmers": num_kmers - num_positive - num_invalid,
        "num_invalid_kmers": num_invalid,
        "num_searches": num_positive - num_extensions,
        "num_extensions": num_extensions,
    }


# ------------------------------------------------------------- batched query


class _Batcher:
    """Accumulates reads, encodes/extracts per-position kmers fully
    vectorized at flush time, runs the batched lookup, folds counters."""

    def __init__(self, index, lookup_fn, k, chunk=1 << 18):
        self.index = index
        self.lookup_fn = lookup_fn
        self.k = k
        self.chunk = chunk
        self._seqs = []
        self._pending = 0
        # adjacency state carried across chunk boundaries
        self._carry = None
        self.report = {
            "num_kmers": 0,
            "num_positive_kmers": 0,
            "num_negative_kmers": 0,
            "num_invalid_kmers": 0,
            "num_searches": 0,
            "num_extensions": 0,
        }

    def add_read(self, seq):
        n = len(seq)
        if n < self.k:
            return
        self._seqs.append(bytes(seq))
        self._pending += n - self.k + 1
        if self._pending >= self.chunk:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        k = self.k
        lens = np.array([len(s) for s in self._seqs], dtype=np.int64)
        codes, ok = K.encode_chars(b"".join(self._seqs))
        self._seqs = []
        self._pending = 0

        ends = np.cumsum(lens)
        starts = ends - lens
        npos = lens - k + 1
        total = int(npos.sum())
        # per-read position lists, vectorized
        pstart = np.cumsum(npos) - npos
        pos = np.repeat(starts, npos) + (np.arange(total) - np.repeat(pstart, npos))
        first = np.zeros(total, dtype=bool)
        first[pstart] = True
        okc = np.zeros(len(ok) + 1, dtype=np.int64)
        np.cumsum(ok, out=okc[1:])
        valid = (okc[pos + k] - okc[pos]) == k
        words = K.pack_codes(np.where(ok, codes, 0), pad_words=K.num_words64(k) + 1)
        kmers = K.read_kmers_at(words, pos, k)

        res = self.lookup_fn(kmers, valid)
        found = (res["kmer_id"] != INVALID) & valid
        sid = np.asarray(res["string_id"], dtype=np.uint64)
        kid = np.asarray(res["kmer_id"], dtype=np.uint64)
        orient = np.asarray(res["kmer_orientation"], dtype=np.int64)

        # stitch adjacency across the previous chunk boundary
        if self._carry is not None and not first[0]:
            c_found, c_sid, c_kid, c_orient = self._carry
            if (
                c_found
                and found[0]
                and sid[0] == c_sid
                and orient[0] == c_orient
                and np.int64(kid[0]) == np.int64(c_kid) + c_orient
            ):
                # counted as a search by derive_report's roll (prev unknown
                # there); reclassify as extension
                self.report["num_searches"] -= 1
                self.report["num_extensions"] += 1

        rep = derive_report(found, sid, kid, orient, valid, first)
        for key, v in rep.items():
            self.report[key] += v
        self._carry = (bool(found[-1]), sid[-1], kid[-1], orient[-1])

    def finalize(self):
        self.flush()
        r = self.report
        assert r["num_kmers"] == (
            r["num_positive_kmers"] + r["num_negative_kmers"] + r["num_invalid_kmers"]
        )
        return dict(r)


def _host_lookup(index):
    def fn(kmers, valid):
        return oracle.lookup(index, kmers)

    return fn


def host_report(index, path, multiline=False, fmt=None, chunk=1 << 18):
    """The report of the oracle-backed _Batcher (fresh host lookups at every
    position): the reference path the device stream is held to."""
    batcher = _Batcher(index, _host_lookup(index), index.k, chunk=chunk)
    for seq in parse_reads(path, fmt=fmt, multiline=multiline):
        batcher.add_read(seq)
    return batcher.finalize()


# ------------------------------------------------------------- device step
#
# Stage contracts (plain version and kernel alike). u32 values travel as
# the bits of int32 tensors; flags as uint8; device scalars (the chunk's
# count and nreads, a compaction's size) as int32 tensors of shape (1,), so
# no stage needs the host to read them.


def _bits(flags, nwords):
    """bool (n,) -> int32 (nwords,) bit array, bit i of word i // 32."""
    pad = torch.zeros(nwords * 32, dtype=torch.int64, device=flags.device)
    pad[: flags.shape[0]] = flags.to(torch.int64)
    words = (pad.view(nwords, 32) << torch.arange(32, device=flags.device)).sum(dim=1)
    return u.to_i32(words)


def _bit(bits32, i):
    """Bit i (int64 tensor) of an int32 bit array, as bool."""
    return ((u.u32(bits32)[i >> 5] >> (i & 31)) & 1) != 0


def _halves(bits32, A):
    """The 16-bit half of a bit array for each group of 16 lanes, (A,)."""
    g = torch.arange(A, device=bits32.device)
    return (u.u32(bits32)[g >> 1] >> ((g & 1) * 16)) & 0xFFFF


def stream_masks_plain(pstart, rfirst, nreads, P):
    """Segment starts from the reads' first positions. pstart int32 (R,)
    (exclusive scan of the per-read position counts), rfirst int32 bits
    (R//32+1,), nreads int32 (1,). Returns (sbits, fbits) int32
    (P//32+1,): a segment / a read starts at lane p, and gcnt int32
    (P//16,): segment starts per group of 16 lanes. A start whose word is
    past the bit array is dropped, as JAX's scatter drops it."""
    n = int(u.u32(nreads)[0])
    nwords = P // 32 + 1
    ps = u.u32(pstart[:n])
    r = torch.arange(n, device=pstart.device)
    keep = (ps >> 5) < nwords
    first = _bit(rfirst, r)
    sb = torch.zeros(nwords * 32, dtype=torch.bool, device=pstart.device)
    fb = torch.zeros_like(sb)
    sb[ps[keep]] = True
    fb[ps[keep & first]] = True
    gcnt = sb[:P].view(P // 16, 16).sum(dim=1).to(torch.int32)
    return _bits(sb, nwords), _bits(fb, nwords), gcnt


def lane_positions(lanes, sbits, cum_g, k):
    """Char position of each lane (int64 of u32): lane + r*(k-1), r the
    lane's segment, counted by the group scan cum_g and the group's
    segment-start bits up to the lane."""
    g, t = lanes >> 4, lanes & 15
    half = (u.u32(sbits)[g >> 1] >> ((g & 1) * 16)) & ((2 << t) - 1)
    r = cum_g.to(torch.int64)[g] + _popcount16(half) - 1
    return (lanes + r * (k - 1)) & M32


def _popcount16(v):
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def stream_kmers_plain(words32, sbits, cum_g, k, lanes, count):
    """The read's kmer at each listed lane: row j < count (int32 (1,),
    clamped to [0, n_out]) reads at lane lanes[j] (int32 (n_out,)).
    Returns (n_out, W) int32. Rows at or past count are not part of the
    result: nothing downstream reads them (the kernel leaves them
    unwritten; they are zero here)."""
    dev = words32.device
    n_out = lanes.shape[0]
    n = min(max(int(count[0]), 0), n_out)
    out = torch.zeros((n_out, Pk.num_words32(k)), dtype=torch.int32, device=dev)
    pos = lane_positions(lanes[:n].to(torch.int64), sbits, cum_g, k)
    out[:n] = u.to_i32(Pk.read_kmers_at(u.u32(words32), pos, k))
    return out


stream_kmers = kernels.by_device(kernels.stream_kmers_kernel, stream_kmers_plain, "kmer-read")


def stream_anchors_plain(pstart, rfirst, nreads, words32, P, k):
    """The anchor stage of a chunk of P lanes: (sbits, fbits, cum_g,
    anchors). sbits, fbits and the group counts are stream_masks_plain's;
    cum_g int32 (P//16,) is the exclusive scan of the group counts (the
    segment starts before each group of 16 lanes); anchors (P//16, W) int32
    the kmer at each group's first lane (stream_kmers_plain at lanes 16g).
    The kernel takes pstart[:nreads] strictly rising (rnpos[:nreads] >= 1,
    as _DeviceStream's packer writes every read); this version does not
    need it."""
    sbits, fbits, gcnt = stream_masks_plain(pstart, rfirst, nreads, P)
    cum_g = Pk.prefix_sum_ex(gcnt)
    A = P // S
    lanes = torch.arange(A, dtype=torch.int32, device=pstart.device) * S
    count = torch.tensor([A], dtype=torch.int32, device=pstart.device)
    return sbits, fbits, cum_g, stream_kmers_plain(words32, sbits, cum_g, k, lanes, count)


stream_anchors = kernels.by_device(kernels.stream_anchors_kernel, stream_anchors_plain,
                                   "anchors")


def _win16(words, base):
    """chars [base, base+16) as one u32 per lane (word reads clip)."""
    n = words.shape[0]
    w0i = (base >> 4).clamp(max=n - 1)
    w1i = ((base >> 4) + 1).clamp(max=n - 1)
    sh = (base & 15) * 2
    hi = torch.where(sh != 0, (words[w1i] << (32 - sh)) & M32, torch.zeros_like(base))
    return (words[w0i] >> sh) | hi


def _window_base(aoff, fwd, k):
    """First string char of an anchor's followers' window: after the
    anchor's kmer forward, up to S-1 chars before it backward."""
    return torch.where(fwd, (aoff + k - 1) & M32, aoff - aoff.clamp(max=S - 1))


CHAIN_FIELDS = ("found", "kmer_offset", "string_id", "kmer_id", "kmer_orientation",
                "string_begin", "string_end")


def stream_chain_plain(ares, words32, strings32, valid_bits, sbits, fbits, cum_g, k, swin=None):
    """Chain extension (streaming.py:390-435 of the JAX package): anchor g
    covers lanes 16g..16g+15; follower t is found iff every lane 1..t of
    the group is valid, starts no read or segment, its string char equals
    the read char (complemented on the backward strand) and stays inside
    the anchor's string. ares: the anchors' lookup (CHAIN_FIELDS); swin:
    the anchors' 16-char string windows (a bucket-sharded stream's
    stream_swin, combined), read in place of strings32. Returns per lane
    found (uint8), string_id, kmer_id (kid = akid +- t mod 2^32),
    orientation (int32) and need = valid & ~found (uint8)."""
    A = ares["found"].shape[0]
    dev = words32.device
    g = torch.arange(A, device=dev)
    t = torch.arange(S, device=dev)[:, None]  # (S, 1)
    vh, fh, sh = (_halves(b, A) for b in (valid_bits, fbits, sbits))
    vg, fg, sg = (((h[None, :] >> t) & 1) != 0 for h in (vh, fh, sh))
    apos = lane_positions(g * S, sbits, cum_g, k)
    aoff, asid, akid, abeg, aend = (u.u32(ares[f]) for f in (
        "kmer_offset", "string_id", "kmer_id", "string_begin", "string_end"))
    aori = ares["kmer_orientation"].to(torch.int64)
    afound = ares["found"] & vg[0]
    fwd = aori == 1
    k1 = k - 1
    base_s = _window_base(aoff, fwd, k)
    saw = _win16(u.u32(strings32), base_s) if swin is None else u.u32(swin)
    raw = _win16(u.u32(words32), (apos + k1) & M32)
    og = torch.where(fwd, aoff + t, aoff - t) & M32
    under = ~fwd & (aoff < t)
    idx_s = torch.where(fwd, t.expand(S, A), (og - base_s) & M32)
    schar = (saw >> ((idx_s & 15) * 2)) & 3
    rchar = (raw >> (t * 2)) & 3
    charok = torch.where(fwd, schar == rchar, schar == (rchar ^ 2))
    instr = (og >= abeg) & (((og + k) & M32) <= aend)
    cond = vg & ~fg & ~sg & charok & instr & ~under
    cond[0] = afound
    matched = torch.cumprod(cond.to(torch.int32), dim=0) > 0  # (S, A)
    kid = torch.where(fwd, akid + t, akid - t) & M32

    def by_lane(x):  # (S, A) -> (P,) in lane order
        return x.t().reshape(-1)

    return {"found": by_lane(matched).to(torch.uint8),
            "string_id": u.to_i32(asid).repeat_interleave(S),
            "kmer_id": u.to_i32(by_lane(kid)),
            "kmer_orientation": aori.to(torch.int32).repeat_interleave(S),
            "need": by_lane(vg & ~matched).to(torch.uint8)}


stream_chain = kernels.by_device(kernels.stream_chain_kernel, stream_chain_plain, "chain", arg=1)


def stream_swin_plain(aoff, aori, strings32, k, words):
    """The anchors' string windows on one bucket shard (ShardedStream's
    swin, sharded.py:431-438 of the JAX package): chars [base, base+16) of
    each anchor (_window_base of its kmer_offset and orientation) where
    this shard's strings32 slice (words: a layout.AccessShard) holds the
    window's first word, 0 elsewhere. Returns (A,) int32."""
    base = _window_base(u.u32(aoff), aori == 1, k)
    w0 = base >> 4
    own = (w0 >= words.word_lo) & (w0 < words.word_hi)
    win = _win16(u.u32(strings32), torch.where(own, base - 16 * words.word_lo, 0))
    return u.to_i32(torch.where(own, win, 0))


stream_swin = kernels.by_device(kernels.stream_swin_kernel, stream_swin_plain, "window", arg=0)


def stream_heads_plain(mv_f, mv_r, lanes, count, fbits, gate):
    """Negative-minimizer run-skip heads (streaming.py:515-539 of the JAX
    package, reference streaming_query.hpp:150-157) in rank space: rank j <
    count (lane lanes[j]) is a head unless the skip is on, the previous
    rank is the previous lane, neither strand's minimizer changed and the
    lane starts no read. gate: 1 on, 0 off, -1 JAX's gate (on iff count >
    P/64). mv_f / mv_r int64 (P,) from kernel 1. Returns bool (P,), the
    lookup's active lanes."""
    P = lanes.shape[0]
    n = int(count[0])
    head = torch.zeros(P, dtype=torch.bool, device=lanes.device)
    on = n > P // 64 if gate < 0 else bool(gate)
    ln = lanes[:n].to(torch.int64)
    h = torch.ones(n, dtype=torch.bool, device=lanes.device)
    if on and n > 1:
        same = ((ln[1:] == ln[:-1] + 1) & (mv_f[1:n] == mv_f[: n - 1])
                & (mv_r[1:n] == mv_r[: n - 1]) & ~_bit(fbits, ln[1:]))
        h[1:] = ~same
    head[:n] = h
    return head


stream_heads = kernels.by_device(kernels.stream_heads_kernel, stream_heads_plain, "run-skip",
                                 arg=2)


def stream_round2_plain(head, found, minimizer_found, count):
    """Second-round lanes (streaming.py:541-545, 598-601 of the JAX package:
    round2 = need & ~head & head_mf[seg]): rank j < count that is no head
    and whose run head, the last head at or before j, found its kmer or
    its minimizer in the first round (found, minimizer_found: bool (P,)).
    Rank 0 is a head whenever count > 0 (stream_heads makes it one); a rank
    before every head is not a round-2 lane. Returns bool (P,)."""
    P = head.shape[0]
    n = int(count[0])
    hd = head[:n]
    mf = found[:n] | minimizer_found[:n]
    ranks = torch.arange(n, device=head.device)
    run = torch.where(hd, ranks, -1).cummax(0).values
    out = torch.zeros(P, dtype=torch.bool, device=head.device)
    out[:n] = ~hd & (run >= 0) & mf[run.clamp(min=0)]
    return out


stream_round2 = kernels.by_device(kernels.stream_round2_kernel, stream_round2_plain, "round-2")


MERGE_FIELDS = ("found", "string_id", "kmer_id", "kmer_orientation")


def stream_merge_plain(lanes, count, r1, r2, state):
    """Scatter the found results of the two lookup rounds (rank space) back
    to their lanes, in place in `state` (chain outputs, lane space)."""
    n = int(count[0])
    f1, f2 = r1["found"][:n], r2["found"][:n]
    hit = f1 | f2
    ln = lanes[:n].to(torch.int64)[hit]
    state["found"][ln] = 1
    for key in MERGE_FIELDS[1:]:
        v = torch.where(f1, r1[key][:n], r2[key][:n])
        state[key][ln] = v[hit].to(state[key].dtype)
    return state


stream_merge = kernels.by_device(kernels.stream_merge_kernel, stream_merge_plain, "merge")


def stream_count_plain(state, valid_bits, fbits, count):
    """Per-lane counter derivation (streaming.py:612-629 of the JAX
    package): found = found & valid; a lane extends its predecessor iff
    both are found, it starts no read, and string, orientation and kmer id
    + orientation follow. Returns (3, 4) int32 (u32 bits): [count,
    positives, extensions, invalids], lane 0's and the last lane's
    [found, string_id, kmer_id, orientation]."""
    P = state["found"].shape[0]
    dev = valid_bits.device
    lane = torch.arange(P, device=dev)
    valid = _bit(valid_bits, lane)
    found = (state["found"] != 0) & valid
    sid, kid = u.u32(state["string_id"]), u.u32(state["kmer_id"])
    ori = state["kmer_orientation"].to(torch.int64)
    ext = (found[1:] & found[:-1] & ~_bit(fbits, lane[1:]) & (sid[1:] == sid[:-1])
           & (ori[1:] == ori[:-1]) & (kid[1:] == ((kid[:-1] + ori[:-1]) & M32)))
    cnt = int(u.u32(count)[0])
    last = min(max(cnt - 1, 0), P - 1)
    n_valid = int(valid.sum())
    rows = [[cnt, int(found.sum()), int(ext.sum()), (cnt - n_valid) & M32]]
    for i in (0, last):
        rows.append([int(found[i]), int(sid[i]), int(kid[i]), int(ori[i]) & M32])
    return u.to_i32(torch.tensor(rows, dtype=torch.int64, device=dev))


stream_count = kernels.by_device(kernels.stream_count_kernel, stream_count_plain, "count",
                                 arg=1)


class StepOps(NamedTuple):
    """The stages of the stream step: kernel entries or plain versions."""

    scan: object
    compact: object
    anchors: object
    kmers: object
    chain: object
    heads: object
    round2: object
    merge: object
    count: object
    minimizer_ranks: object
    lookup_ranks: object


KERNEL_OPS = StepOps(Pk.scan_ex, Pk.compact, stream_anchors, stream_kmers, stream_chain,
                     stream_heads, stream_round2, stream_merge, stream_count,
                     Pk.minimizer_ranks, lookup_ranks)
PLAIN_OPS = StepOps(Pk.prefix_sum_ex, Pk.compact_plain, stream_anchors_plain,
                    stream_kmers_plain, stream_chain_plain, stream_heads_plain,
                    stream_round2_plain, stream_merge_plain, stream_count_plain,
                    Pk.minimizer_ranks_plain, lookup_ranks_plain)


def packed_offsets(P, R):
    """Offsets of the packed chunk buffer [count, nreads, rnpos (R), rfirst
    bits (R//32+1), valid bits (P//32+1), words32 (CW)]; the all-valid form
    leaves out the valid bits."""
    o1 = 2 + R
    o2 = o1 + R // 32 + 1
    return 2, o1, o2, o2 + P // 32 + 1


def check_streamable(cfg):
    """Streaming reads string bounds (the chain's in-string test) and char
    offsets, which rebased (v2) rows do not carry: raise on a v2 engine, as
    the JAX package does."""
    if cfg.row_v2:
        raise ValueError("streaming needs full lookup fields (string bounds for the "
                         "chain-extension in-string test) and char-offset cursors; rebased "
                         "v2-row indexes (>= 2^32 chars) serve point queries only - shard the "
                         "input into < 2^32-char sub-indexes to stream")


def check_read_positions(rnpos, nreads):
    """Raise unless every packed read has a position (rnpos[:nreads] >= 1,
    so that pstart[:nreads] rises strictly): the anchors kernel's
    precondition, which _DeviceStream's packer meets by dropping reads
    under k chars. Reads the buffer on the host."""
    n = min(max(int(nreads[0]), 0), rnpos.shape[0])
    if n and bool((rnpos[:n] == 0).any()):
        raise ValueError("packed chunk: a read below nreads has no position (rnpos 0); the "
                         "anchor stage needs rnpos[:nreads] >= 1")


def make_stream_step(cfg, P, R, CW, lookup, all_valid=False, ops=KERNEL_OPS, runskip=None,
                     swin=None, lookup_ranks=None):
    """The per-chunk step on one packed int32 buffer (u32 bits) at the
    offsets of the JAX package's step_packed (step_packed_av when
    all_valid: no valid bits; lanes < count are valid). Returns
    fn(tables, packed) -> (3, 4) int32 of u32 counters, lane 0 and the last
    lane, computed on the buffer's device without a host round trip.

    lookup: make_lookup(cfg, "full", ...) fn(tables, kmers32), the
    anchors' lookup; ops: KERNEL_OPS (entry points: kernels on the card,
    plain versions on the CPU) or PLAIN_OPS (plain versions on any device;
    pass a plain lookup with them). runskip: None for JAX's gate (on when
    more than P/64 lanes miss their chain), True / False to force it.

    The missed lanes run in rank space up to their device count:
    ops.minimizer_ranks, then both lookup rounds through lookup_ranks(cfg,
    tables, kmers32, mins, active, count) (STREAM_FIELDS, as
    engine.lookup_ranks) from its minimizers; None: ops.lookup_ranks, on
    the whole tables. swin: None (the chain reads tables["strings32"]) or
    fn(tables, ares) -> the anchors' string windows, for tables split by
    string range. The bucket-sharded stream passes both, with its anchors'
    lookup: kernel 1's rank form and kernel 2's rank form on each shard
    (parallel/sharded.py ShardedStream).

    fn(tables, packed, stats=None): a dict passed as stats receives, as
    device tensors, the lanes that missed their chain ("need"), the lookup
    heads ("heads") and the round-2 lanes ("round2").

    The packed buffer must give every read below nreads at least one
    position (rnpos >= 1), as _DeviceStream's packer does: the anchors
    kernel relies on it (the plain version does not). With SSHASH_DEBUG=1
    in the environment when the step is made, each call checks it on the
    host (check_read_positions) and raises on a buffer that breaks it."""
    check_streamable(cfg)
    debug = os.environ.get("SSHASH_DEBUG", "") not in ("", "0")
    if P % 32 or P < 32:
        raise ValueError(f"P={P} must be a positive multiple of 32")
    o0, o1, o2, o3 = packed_offsets(P, R)
    gate = -1 if runskip is None else int(bool(runskip))
    k = cfg.k
    ranks = lookup_ranks or ops.lookup_ranks

    def fn(tables, packed, stats=None):
        dev = packed.device
        count, nreads = packed[0:1], packed[1:2]
        rnpos, rfirst = packed[o0:o1], packed[o1:o2]
        if debug:
            check_read_positions(rnpos, nreads)
        if all_valid:
            words32 = packed[o2:o2 + CW]
            w = torch.arange(P // 32 + 1, device=dev)
            cnt = u.u32(count)
            full, rem = cnt >> 5, cnt & 31
            valid_bits = u.to_i32(torch.where(w < full, M32, torch.where(
                w == full, (1 << rem) - 1, 0)))
        else:
            valid_bits, words32 = packed[o2:o3], packed[o3:o3 + CW]
        pstart = ops.scan(rnpos)
        sbits, fbits, cum_g, akm = ops.anchors(pstart, rfirst, nreads, words32, P, k)
        ares = lookup(tables, akm)
        if swin is None:
            state = ops.chain(ares, words32, tables["strings32"], valid_bits, sbits, fbits,
                              cum_g, k)
        else:
            state = ops.chain(ares, words32, None, valid_bits, sbits, fbits, cum_g, k,
                              swin=swin(tables, ares))
        lanes, n_need = ops.compact(state["need"])
        km = ops.kmers(words32, sbits, cum_g, k, lanes, n_need)
        mins = ops.minimizer_ranks(km, n_need, k, cfg.m, cfg.magic)
        head = ops.heads(mins[0], mins[2], lanes, n_need, fbits, gate)
        r1 = ranks(cfg, tables, km, mins, head, n_need)
        round2 = ops.round2(head, r1["found"], r1["minimizer_found"], n_need)
        r2 = ranks(cfg, tables, km, mins, round2, n_need)
        state = ops.merge(lanes, n_need, r1, r2, state)
        if stats is not None:
            stats.update(need=n_need[0], heads=head.sum(), round2=round2.sum())
        return ops.count(state, valid_bits, fbits, count)

    return fn


class _DeviceStream:
    """Chunked streaming on one device. Per chunk, the host encodes the 2-bit
    packed read chars and the per-read metadata into ONE pinned buffer
    (sshash_tpu's packed layout), copies it to the device without blocking
    and queues the step; every chunk's (3, 4) comes back in one transfer at
    finalize. Chunk budgets are JAX's: P positions, R = max(16, P >>
    rmax_shift) segments, CW char words (_cw_words), and long reads split
    into exact-P segments with a k-1 overlap."""

    def __init__(self, engine, k, pmax=1 << 22, rmax_shift=4, runskip=None):
        check_streamable(engine.cfg)
        self.engine = engine
        self.k = k
        self.P = pmax
        self.rmax_shift = rmax_shift
        self.R = max(16, pmax >> rmax_shift)
        self.CW = self._cw_words(pmax, self.R, k)
        _, self._o1, self._o2, self._o3 = packed_offsets(self.P, self.R)
        self._steps = self._make_steps(runskip)
        pin = engine.device.type == "cuda"
        self._buf = torch.empty(self._o3 + self.CW, dtype=torch.int32, pin_memory=pin)
        self._buf_np = self._buf.numpy().view(np.uint32)
        self._copied = None  # event after the last copy out of _buf
        self._seqs = []  # (bytes, is_read_start)
        self._pending = 0
        self._chars = 0
        self._carry = None
        self._inflight = []  # (device (3, 4), starts_fresh) per chunk
        self.chunks = 0
        # when a list: every chunk's (all_valid, device buffer) is kept, so a
        # caller can rerun or time the steps on resident chunks
        self.capture = None
        self.report = dict.fromkeys(
            ["num_kmers", "num_positive_kmers", "num_negative_kmers",
             "num_invalid_kmers", "num_searches", "num_extensions"], 0)

    def _make_steps(self, runskip):
        """The step of each chunk form (all-valid or not)."""
        lookup = make_lookup(self.engine.cfg, "full")
        return {av: make_stream_step(self.engine.cfg, self.P, self.R, self.CW, lookup,
                                     all_valid=av, runskip=runskip)
                for av in (False, True)}

    def _run(self, all_valid, packed):
        """Queue the step of one resident chunk; returns its (3, 4)."""
        return self._steps[all_valid](self.engine.tables, packed)

    @staticmethod
    def _cw_words(pmax, rmax, k):
        # capacity must fit ONE full-P single segment (long reads /
        # multiline genomes); beyond that, budget half the all-R worst case
        chars = max((pmax + rmax * (k - 1) + 1) // 2, pmax + k - 1 + 16)
        return (chars + 15) // 16 + 2

    def add_read(self, seq):
        k = self.k
        n = len(seq)
        if n < k:
            return
        # split long reads into segments with k-1 char overlap (the
        # reference's multiline buffer carry, src/query.cpp:28-37)
        seg = min(self.P, self.CW * 16 - (k - 1))
        # the counter derivation assumes a non-read-start segment only
        # STARTS a chunk (lane 0), which holds for exact-P splits
        if seg != self.P:
            raise ValueError(
                f"char budget allows segments of only {seg} < P={self.P} "
                f"positions (CW={self.CW}); the counter derivation requires "
                f"exact-P long-read splits — widen _cw_words")
        for off in range(0, n - k + 1, seg):
            chunk = seq[off: off + seg + k - 1]
            self._add_segment(bytes(chunk), off == 0)

    def _add_segment(self, seq, is_start):
        npos = len(seq) - self.k + 1
        if (self._pending + npos > self.P
                or len(self._seqs) + 1 > self.R
                or self._chars + len(seq) > self.CW * 16):
            self.flush()
        self._seqs.append((seq, is_start))
        self._pending += npos
        self._chars += len(seq)

    def flush(self):
        if not self._pending:
            return
        k = self.k
        seqs = [s for s, _ in self._seqs]
        starts_flag = np.array([f for _, f in self._seqs], dtype=bool)
        self._seqs = []
        count = self._pending
        self._pending = 0
        self._chars = 0
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        ends = np.cumsum(lens)
        cstarts = ends - lens
        npos = lens - k + 1
        total = int(npos.sum())
        if total != count:
            raise RuntimeError(f"chunk holds {total} positions, counted {count}")
        joined = b"".join(seqs)
        # the native encoder writes len(joined) chars with no bounds checks;
        # the budget holds by construction
        if len(joined) > self.CW * 16:
            raise RuntimeError(f"{len(joined)} chars exceed the chunk's {self.CW * 16}")
        if self._copied is not None:
            self._copied.synchronize()  # the last copy out of the buffer is done
        buf = self._buf_np
        buf[:] = 0
        words32 = buf[self._o3:]
        valid_bits = buf[self._o2:self._o3]
        if native.available():
            t = native.encode_stream(joined, cstarts, lens, k, words32, valid_bits)
            if t != count:
                raise RuntimeError(f"encoder wrote {t} positions, expected {count}")
        else:
            codes, ok = K.encode_chars(joined)
            words = K.pack_codes(np.where(ok, codes, 0))
            w32 = K.pack_words_to_u32(words)
            words32[: len(w32)] = w32
            pstart = np.cumsum(npos) - npos
            pos_all = np.repeat(cstarts, npos) + (np.arange(total) - np.repeat(pstart, npos))
            okc = np.zeros(len(ok) + 1, dtype=np.int64)
            np.cumsum(ok, out=okc[1:])
            valid = (okc[pos_all + k] - okc[pos_all]) == k
            vb = np.packbits(valid, bitorder="little")
            valid_bits[: (len(vb) + 3) // 4] = np.pad(vb, (0, (-len(vb)) % 4)).view(np.uint32)
        buf[0] = count
        buf[1] = len(lens)
        buf[2: 2 + len(lens)] = npos.astype(np.uint32)
        fb = np.packbits(starts_flag, bitorder="little")
        rfirst = buf[self._o1:self._o2]
        rfirst[: (len(fb) + 3) // 4] = np.pad(fb, (0, (-len(fb)) % 4)).view(np.uint32)
        # clean chunks leave out the valid bits: the step derives them
        all_valid = int(np.bitwise_count(valid_bits).sum()) == count
        if all_valid:
            buf[self._o2: self._o2 + self.CW] = buf[self._o3:]  # numpy copies overlaps safely
            n = self._o2 + self.CW
        else:
            n = self._o3 + self.CW
        self._inflight.append((self._dispatch(self._buf[:n], all_valid),
                               bool(starts_flag[0])))
        self.chunks += 1

    def _dispatch(self, host_buf, all_valid):
        """Copy the chunk to the device and queue its step. (A copy on the
        CPU too: the staging buffer is refilled by the next chunk.)"""
        dev = self.engine.device
        packed = host_buf.to(dev, non_blocking=True, copy=True)
        if dev.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(dev))
        if self.capture is not None:
            self.capture.append((all_valid, packed))
        return self._run(all_valid, packed)

    def _fold(self, out, chunk_starts_fresh):
        out = np.asarray(out).view(np.uint32)  # (3, 4) u32
        counters, lane0, lastv = out[0], out[1], out[2]
        counters = counters.astype(np.int64)
        n_kmers, n_pos, n_ext, n_inv = counters
        # stitch adjacency across the previous chunk boundary (the first
        # segment of this chunk may continue a split read)
        if self._carry is not None and not chunk_starts_fresh:
            c_found, c_sid, c_kid, c_orient = self._carry
            co = np.int64(np.int32(lane0[3]))
            if (c_found and lane0[0]
                    and lane0[1] == c_sid and co == c_orient
                    and int(lane0[2]) == (int(c_kid) + c_orient) & 0xFFFFFFFF):
                n_ext += 1
        self.report["num_kmers"] += int(n_kmers)
        self.report["num_positive_kmers"] += int(n_pos)
        self.report["num_extensions"] += int(n_ext)
        self.report["num_invalid_kmers"] += int(n_inv)
        self.report["num_negative_kmers"] += int(n_kmers - n_pos - n_inv)
        self.report["num_searches"] += int(n_pos - n_ext)
        self._carry = (bool(lastv[0]), np.uint64(lastv[1]), np.uint64(lastv[2]),
                       int(np.int32(lastv[3])))

    def finalize(self):
        self.flush()
        if self._inflight:
            # ONE device-to-host transfer for every queued chunk's (3, 4)
            outs = torch.stack([o for o, _ in self._inflight]).cpu().numpy()
            for out, (_, fresh) in zip(outs, self._inflight):
                self._fold(out, fresh)
        self._inflight = []
        r = self.report
        if r["num_kmers"] != r["num_positive_kmers"] + r["num_negative_kmers"] + r["num_invalid_kmers"]:
            raise RuntimeError(f"inconsistent report {r}")
        return dict(r)


def streaming_query_from_file(dictionary, path, multiline=False, fmt=None, device="cuda",
                              chunk=None, rmax_shift=None):
    """Streaming membership queries over a FASTA/FASTQ file on `device`;
    returns the report of streaming_query_report (reference util.hpp:29-36)
    plus elapsed_millisec. dictionary: a Dictionary (its engine on `device`
    is built once) or a TorchEngine. chunk: positions per chunk (default
    2^22, at least 2^16). rmax_shift: log2(P/R) segment budget, 12 for
    multiline (few long records) and 4 otherwise (short reads) by
    default."""
    t0 = time.perf_counter()
    engine = dictionary if isinstance(dictionary, TorchEngine) else dictionary.to_device(device)
    if rmax_shift is None:
        rmax_shift = 12 if multiline else 4
    stream = _DeviceStream(engine, engine.index.k, pmax=max(chunk or (1 << 22), 1 << 16),
                           rmax_shift=rmax_shift)
    for seq in parse_reads(path, fmt=fmt, multiline=multiline):
        stream.add_read(seq)
    report = stream.finalize()
    report["elapsed_millisec"] = (time.perf_counter() - t0) * 1e3
    return report
