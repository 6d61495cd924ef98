"""Least device times of the lookup's kernels on an NVIDIA H100 SXM, for
the measurement scripts (chip_smoke.py, capacity_run.py, lookup_ab.py):
the larger of the bytes a kernel must move (each input read once, each
output written once) over the card's memory rate and the integer
operations it does over the card's peak integer rate. The byte counts
come from the lanes and tables of a run, so they count the rows that run's
data reads.

    b = lookup_bounds(cfg, B, probe_bytes(cfg, tables, kt, args),
                      probe_bytes(cfg, tables, kt, args, fused=True))
    ms, by = b["lookup"]      # by: "bytes" or "operations"
"""

import torch

from . import engine as E
from .engine import canonical_fold
from .layout import cand_block_width, row_width, take_rows
from .ops import packed as P
from .ops import u64 as u

HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s (NVIDIA's H100 data sheet)
# integer ALU: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper)
INT32_OPS = 132 * 64 * 1.98e9
# kernel 1, per window of both strands: two 64-bit mixer multiplies (3
# IMADs and an XOR each), the m-mer's reverse complement (~10), the 128-bit
# window shift and mask (~4), two compare-and-selects (~4 each)
MINIMIZER_OPS_PER_WINDOW = 32

# canonical_fold reads both strands' (minimizer, position), 24 bytes a
# lane, and writes (minval, minpos, minpos2), 16
FOLD_BYTES = 40


def bound(nbytes, int_ops=0):
    """(least ms, what bounds it) for nbytes of device memory traffic and
    int_ops integer operations."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, int_ops / INT32_OPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def probe_args(cfg, kt, minimizer=P.minimizer_plain):
    """Kernel 2's inputs after kernel 1 (or its plain version): (kmers_rc,
    minval, minpos, minpos2), canonically folded in a canonical index."""
    mv, mp, rc, mv_r, mp_r = minimizer(kt, cfg.k, cfg.m, cfg.magic, both=True)
    return (rc, *canonical_fold(mv, mp, mv_r, mp_r)) if cfg.canonical else (None, mv, mp, None)


def probe_bytes(cfg, tables, kt, args, fields="ids", shard=None, fused=False, slots=None):
    """Bytes kernel 2 must move on these lanes (kt and probe_args' args),
    each input read once: per lane its kmer (and reverse complement),
    minimizer and position tries in (fused: the lookup kernel's work, the
    kmer alone) and the result fields out; of the tables, the distinct rows
    the lanes read: fused rows by MPHF slot and, for heavy lanes, sk_hrows
    blocks by skew slot; pilot and seed words one a lane, capped at their
    table's size. Rows of mid buckets past the fused row (a few lanes) are
    not counted: a lower bound. With shard (a ProbeShard, tables the
    shard's: kernel 2's owned shard form), every lane's minimizer is read
    (its slot decides the owner), and only the lanes whose slot the shard
    holds read the rest of their inputs, a fused row and write their
    result; their heavy lanes write their sk_hrows row instead of reading
    it (the hand-off's first pass). slots as kernel 2's shard
    form takes it: "store" (the row's first shard) also writes every lane's
    slot; "read" (the others) reads every lane's slot in place of its
    minimizer and the MPHF's pilot and seed words, and only the lanes it
    owns read their minimizer."""
    B, canon = kt.shape[0], 2 if cfg.canonical else 1
    nb = lambda name: tables[name].numel() * tables[name].element_size()  # noqa: E731

    def distinct(idx, name):  # rows of tables[name] read at idx, clipped as take_rows does
        return int(torch.unique(idx.clamp(max=tables[name].shape[0] - 1)).numel())

    lane_in = 4 * cfg.W if fused else 4 * cfg.W * canon + 8 + 4 * canon
    lane_out = 10 + (20 if fields == "full" else 0)
    total = 0
    if slots != "read":  # the MPHF's evaluation
        total += min(4 * B, nb("pilots"))
        total += min(8 * B, nb("mphf_seedrows")) if cfg.mphf_partitioned else 0
    slot = E.mphf_eval_minimizer(cfg, tables, u.from_i64(args[1]))
    sel = torch.arange(B, device=kt.device)
    if shard is not None:
        sel = ((slot >= shard.slot_lo) & (slot < shard.slot_hi)).nonzero()[:, 0]
        slot = slot[sel] - shard.slot_lo
        if slots == "read":
            total += 4 * B  # every lane's slot; the owned lanes' minimizers below
        else:
            total += 8 * B + (4 * B if slots == "store" else 0)  # every lane's minimizer (slot)
            lane_in -= 8
    total += sel.numel() * (lane_in + lane_out) + distinct(slot, "cw_row") * 4 * row_width(cfg)
    if not cfg.has_skew:
        return total
    head = take_rows(tables["cw_row"][:, :2], slot)  # (status | class << 2, cw_a)
    heavy = (head[:, 0] & 3) == 2
    lanes = sel[heavy]
    nh = lanes.numel()
    km = u.u32(kt[lanes])
    if args[0] is not None:
        kr = u.u32(args[0][lanes])
        km = torch.where(P.kmer_less(kr, km)[:, None], kr, km)
    cls = head[heavy, 0] >> 2
    hidx = (E._skew_param(tables, "pos_off", cls) + E.skew_slot(cfg, tables, km, cls)) & u.M32
    total += nb("sk_params") + min(4 * nh, nb("sk_pilots"))
    total += min(8 * nh, nb("sk_seedrows")) if cfg.skew_partitioned else 0
    if shard is not None:
        return total + 4 * sel.numel()  # the rows handed on
    return total + distinct(hidx, "sk_hrows") * 4 * cand_block_width(cfg)


def lookup_bounds(cfg, B, probe_nbytes, lookup_nbytes=None):
    """Least ms of a canonical lookup's parts for B lanes in the two-kernel
    form: kernel 1 (bytes or its mixer operations), kernel 2 (probe_nbytes,
    from probe_bytes) and the fold's glue; and of the lookup kernel: the
    larger of kernel 1's operations and lookup_nbytes (probe_bytes(...,
    fused=True): kmers in, result fields out, pilot and seed words and
    distinct rows; no intermediate reaches device memory)."""
    ops = B * MINIMIZER_OPS_PER_WINDOW * (cfg.k - cfg.m + 1)
    b = {"minimizer.cu": bound(B * (4 * cfg.W + 32), ops), "probe.cu": bound(probe_nbytes),
         "fold": bound(B * FOLD_BYTES)}
    if lookup_nbytes is not None:
        b["lookup"], b["lookup_bytes"] = bound(lookup_nbytes, ops), bound(lookup_nbytes)
    return b
