"""Batched point queries on PyTorch tensors: lookup, navigation, access,
iteration and weight, and the engine that serves them.

Counterpart of sshash_tpu/engine.py's query paths (mphf_eval_minimizer,
_pilot_read, skew_slot, lookup_with_info, make_lookup, _merge,
make_neighbours, make_access with _acc_resolve and _acc_read_window,
make_iterator, make_weight, DeviceEngine) for indexes of k <= 255
(layout.MAX_K), in either row format (layout.py) and either skew form. A
lookup is the work of two kernels:

  1. kernel 1 (ops.packed.minimizer): both strands' minimizers, and the
     reverse-complemented kmers, in one launch;
  2. kernel 2 (`probe`): MPHF slot, fused codeword row, minimizer guard,
     candidate verification and id resolution, one thread per lane. Heavy
     lanes resolve through the skew index: slot -> sk_hrows row, on a
     pre-v1.2 index too (the JAX package's skew_eval walks slot ->
     position in the bucket -> heavy row; layout.class_hindex derives
     the rows on the host).

Canonical mode folds the tie retry into two extra position tries of one
probe (the minimizer VALUES tie, so both strands probe the same bucket).
Regular mode probes forward, then probes the reverse complement of the
lanes that missed; a lane that missed forward reports BACKWARD orientation
whether or not the RC probe finds it, and ORs minimizer_found over both
strands (src/dictionary.cpp:71-76).

On the card the engine's lookup, lookup_ids and navigation run all of it
in one launch of the lookup kernel (`lookup`: both strands' minimizers,
the fold or the RC retry, and the probe, per thread, in csrc/probe.cu),
whose plain version `lookup_plain` is the two-kernel form over the plain
versions. The stream's missed lanes run the lookup kernel's lane in rank
space, up to their count on the device (`lookup_ranks`,
csrc/lookup_ranks.cu). The bucket-sharded engine keeps kernel 1 and
kernel 2 as separate launches: on a LocalMesh kernel 1 once a data row,
then kernel 2's shard form on each shard, storing the lanes it owns into
the row's shared result tensors (`probe` given a shard and `out`;
parallel/sharded.py), on a DistMesh the two-kernel form (make_lookup)
over kernel 2's packed form and a collective. Its stream's anchors and
missed lanes run kernel 1's rank form and the shard form's rank form
(`probe_ranks`), up to a count on the device.

The plain versions here (`probe_plain` and its helpers) hold u32 values in
int64 tensors and run on any device; `probe` sends CPU tensors to them and
CUDA tensors to the kernel. Results carry u32 fields as int32 tensors of
the same bits: kmer ids up to 2^32 - 2, char offsets below 2^32 (v1 rows;
v2 rows return ids only). Nothing reads an id's top bit as a sign.

Navigation builds the 8 one-char variants of each kmer in one launch of
the neighbours kernel (ops.packed.neighbour_variants) and looks them all
up at once. The id-side queries are one kernel each:

  access     csrc/access.cu: id -> packed kmer from one acc_rows row, and
             in the two-round form a strings32 read;
  iterate    csrc/iterator.cu: (count, checksum) of every valid kmer in one
             pass over strings32 and vstart32;
  weight     csrc/weight.cu: id -> weight by an upper-bound search over the
             weight runs, then two gathers.

Ids at or past num_kmers: the windowed access form reads what the JAX
program reads, bit for bit. The two-round form (and read_kmers_at) clips
its strings32 reads to the last word, where JAX's unclipped gather fills;
such lanes read in bounds and their kmer is meaningless in both.
"""

import os

import numpy as np
import torch

from . import debug, kernels
from . import kmer as K
from .constants import BACKWARD_ORIENTATION, FORWARD_ORIENTATION, INVALID_UINT64
from .layout import (SKEW_PARAMS, TABLE_GROUPS, StaticCfg, acc_windowed, cand_block_width,
                     check_access, check_fields, check_probe_shard, check_rank_probe,
                     device_arrays, rank_probe_shards, tables_from_host,
                     take_rows, with_access_tables)
from .ops import packed as P
from .ops import u64 as u
from .ops.u64 import M32

INVALID32 = 0xFFFFFFFF
_SKP = {name: i for i, name in enumerate(SKEW_PARAMS)}


def _skew_param(tables, name, cls):
    return take_rows(tables["sk_params"][_SKP[name]], cls)


def _pilot_read(w, words, bucket, word_off=None):
    """pilot = packed_words[word_off + bucket] at field width w."""
    if w == 32:
        return take_rows(words, bucket if word_off is None else (word_off + bucket) & M32)
    ppw = 32 // w
    widx = bucket >> (ppw.bit_length() - 1)
    if word_off is not None:
        widx = (word_off + widx) & M32
    word = take_rows(words, widx)
    return (word >> ((bucket & (ppw - 1)) * w)) & ((1 << w) - 1)


def mphf_eval_minimizer(cfg, tables, minval):
    """Minimizer (u64 pair) -> raw MPHF slot (u32 in int64)."""
    mh = u.splitmix64(u.xor(minval, u.const64(cfg.mphf_seedmix, minval.lo)))
    if cfg.mphf_partitioned:
        pid = u.mulhi32(mh.hi, cfg.mphf_P)
        row = take_rows(tables["mphf_seedrows"], pid)
        h2 = u.splitmix64(u.xor(mh, u.u64(row[:, 0], row[:, 1])))
        nb, T = cfg.mphf_part_buckets, cfg.mphf_part_table
        bucket = (pid * nb + u.mulhi32(h2.hi, nb)) & M32
        pilot = _pilot_read(cfg.pilot_w, tables["pilots"], bucket)
        local = u.mulhi32(u.fmix32(h2.lo ^ u.fmix32(pilot)), T)
        return (pid * T + local) & M32
    bucket = u.mulhi32(mh.hi, cfg.mphf_nbuckets)
    pilot = _pilot_read(cfg.pilot_w, tables["pilots"], bucket)
    return u.mulhi32(u.fmix32(mh.lo ^ u.fmix32(pilot)), cfg.mphf_table)


def skew_slot(cfg, tables, kmers, cls):
    """Slot of each (canonical) kmer in its heavy bucket's size class:
    partitioned class MPHFs (v1.2+), or plain ones (one pilot read)."""
    seedmix = u.u64(_skew_param(tables, "seedmix_hi", cls),
                    _skew_param(tables, "seedmix_lo", cls))
    h = u.hash64_words(kmers, seedmix)
    nb = _skew_param(tables, "nbuckets", cls)
    table = _skew_param(tables, "table", cls)
    pilot_off = _skew_param(tables, "pilot_off", cls)
    if not cfg.skew_partitioned:
        bucket = u.mulhi32(h.hi, nb)
        pilot = _pilot_read(cfg.sk_pilot_w, tables["sk_pilots"], bucket, word_off=pilot_off)
        return u.mulhi32(u.fmix32(h.lo ^ u.fmix32(pilot)), table)
    pid2 = u.mulhi32(h.hi, _skew_param(tables, "np2", cls))
    row = take_rows(tables["sk_seedrows"],
                    (_skew_param(tables, "seed_off", cls) + pid2) & M32)
    h2 = u.splitmix64(u.xor(h, u.u64(row[:, 0], row[:, 1])))
    bucket = (pid2 * nb + u.mulhi32(h2.hi, nb)) & M32
    pilot = _pilot_read(cfg.sk_pilot_w, tables["sk_pilots"], bucket, word_off=pilot_off)
    local = u.mulhi32(u.fmix32(h2.lo ^ u.fmix32(pilot)), table)
    return (pid2 * table + local) & M32


def _ext0(cfg, col0):
    """In-window char offset of a block's candidate: v2 rows store it, v1
    rows store the candidate's char offset (the window starts at word
    max(0, cand-(k-m)) >> 4)."""
    if cfg.row_v2:
        return col0
    return col0 - (((col0 - col0.clamp(max=cfg.kmw)) >> 4) << 4)


def _verify(cfg, blk, active, km, kr, tries):
    """Verify and resolve one candidate block per lane
    ([col0, vbits, window, resolve words] rows, u32 values in int64) at
    each position try, in order. Returns (match, off, orient, sid, begin,
    end); in v2 rows (resolve words kid0, rel_ep1) off is the kmer id
    itself and sid, begin and end stay 0."""
    Wv, Ww, k = cfg.vbits_words, cfg.win_words, cfg.k
    kmw = cfg.kmw
    cand = blk[:, 0]
    vbw, win = blk[:, 1: 1 + Wv], blk[:, 1 + Wv: 1 + Wv + Ww]
    rsv = blk[:, 1 + Wv + Ww:]
    ext0 = _ext0(cfg, cand)
    zero = torch.zeros_like(cand)
    match = torch.zeros_like(active)
    off = zero.clone()
    orient = torch.full_like(cand, FORWARD_ORIENTATION)
    sid, beg, end = zero.clone(), zero.clone(), zero.clone()
    for pos in tries:
        can = active & ~match & (ext0 >= pos)
        j = kmw - pos
        vword = vbw[:, 0] if Wv == 1 else torch.gather(
            torch.cat([vbw, torch.zeros_like(vbw[:, :1])], dim=1), 1,
            (j >> 5).clamp(max=Wv)[:, None])[:, 0]
        vbit = ((vword >> (j & 31)) & 1) != 0
        read = P.extract_kmer_dyn(win, ((ext0 - pos) * 2) & M32, k, cfg.max_start_word)
        eq_f = P.kmer_equal(read, km)
        if kr is not None:
            eq_r = P.kmer_equal(read, kr)
            hit = can & vbit & (eq_f | eq_r)
            orient = torch.where(hit & eq_r & ~eq_f, BACKWARD_ORIENTATION, orient)
        else:
            hit = can & vbit & eq_f
        match = match | hit
        if cfg.row_v2:
            # kid = kid0 - pos - over*(k-1), over = j >= rel_ep1
            kid = (rsv[:, 0] - pos - (j >= rsv[:, 1]) * (k - 1)) & M32
            off = torch.where(hit, kid, off)
            continue
        o = torch.where(can, cand - pos, zero)
        ep1 = rsv[:, 2]
        over = o >= ep1
        off = torch.where(hit, o, off)
        sid = torch.where(hit, rsv[:, 0] + over, sid)
        beg = torch.where(hit, torch.where(over, ep1, rsv[:, 1]), beg)
        end = torch.where(hit, torch.where(over, rsv[:, 3], ep1), end)
    return match, off, orient, sid, beg, end


def probe_plain(cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2=None,
                active=None, fields="full", shard=None, hrows=None, out=None, fill=False,
                rc_round=False, slots=None):
    """Plain version of kernel 2 (csrc/probe.cu), same contract as
    kernels.probe_kernel: kmers32 / kmers_rc32 (canonical only) (B, W)
    int32, minval int64, minpos / minpos2 int32, active bool or None (every
    lane). Returns int32 kmer_id / kmer_orientation (and the string fields
    when fields="full", v1 rows only), bool minimizer_found and found.

    Mirrors engine.lookup_with_info: candidate 0 rides the codeword row,
    a failed minimizer guard stops the lane after it, heavy lanes go
    through the skew index, candidate 1 rides the row when c1_in_row, and
    the remaining mid-bucket candidates are tried in a masked loop.

    The shard form (shard: a layout.ProbeShard, the tables one bucket
    shard's; engine.py:778-784 and :904-911 of the JAX package) probes the
    lanes whose MPHF slot the shard owns and stores into out, which it
    returns (layout.check_probe_shard):
      - the owned form (the result tensors a mesh row's shards share)
        stores those lanes and, with fill, the inactive lanes as not
        found; with rc_round (the regular mode's RC round) only the lanes
        out does not hold as found, merged as _merge merges: BACKWARD,
        minimizer_found ORed with out's, the hit's fields where found;
      - the packed form ({"packed": (F, B) int32}) stores every lane in the
        mesh combine's order (pack_result), the combine's identity on the
        lanes the shard does not own.
    In an index with skew classes the owner's heavy lanes verify nothing:
    out["hrow"] gets their global sk_hrows row (0xFFFFFFFF on the other
    lanes it stores), and a second call given hrows stores the hits of the
    rows this shard holds (of the lanes out does not hold as found, in the
    owned form), without minimizer_found. slots="store": the probed lanes'
    MPHF slots go to out["slot"] (a mesh row's first shard); "read": they
    are taken from there."""
    check_fields(cfg, fields)
    handoff, packed = check_probe_shard(cfg, shard, hrows, out, fill, rc_round, slots)
    B, dev = kmers32.shape[0], kmers32.device
    active = torch.ones(B, dtype=torch.bool, device=dev) if active is None else active
    if shard is None:
        return _probe_lanes(cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2, active,
                            fields)[0]
    act = active & ~out["found"] if not packed and (rc_round or hrows is not None) else active
    res, own = _probe_lanes(cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2, act,
                            fields, shard, hrows, handoff,
                            out["slot"] if slots == "read" else None)
    slot = res.pop("slot", None)
    if slots == "store":
        _store(out, {"slot": slot}, act)
    if packed:
        pk = pack_result(res)
        if hrows is None:
            _store(out, {"packed": pk, "hrow": res.get("hrow")}, None)
        else:  # the hits over the first pass's rows, minimizer_found kept
            rows = torch.arange(pk.shape[0], device=dev) != pk.shape[0] - 2
            _store(out, {"packed": pk}, (own & res["found"])[None] & rows[:, None])
        return out
    hit = own & res["found"]
    if rc_round:
        res["kmer_orientation"] = torch.full_like(res["kmer_orientation"], BACKWARD_ORIENTATION)
    if hrows is not None:
        res.pop("minimizer_found")
        _store(out, res, hit)
    elif rc_round:
        res["minimizer_found"] = res["minimizer_found"] | out["minimizer_found"]
        _store(out, {key: res.pop(key) for key in ("kmer_orientation", "minimizer_found", "hrow")
                     if key in res}, own)
        _store(out, res, hit)
    else:
        _store(out, res, own | (~active & fill))
    return out


def _store(out, res, mask):
    """out[key] = res[key] where mask (every element when mask is None), in
    place, for the keys both hold."""
    for key, v in res.items():
        if v is not None and key in out:
            out[key].copy_(v if mask is None else torch.where(mask, v, out[key]))


def _probe_lanes(cfg, tables, kmers32, kmers_rc32, minval, minpos, minpos2, active, fields,
                 shard=None, hrows=None, handoff=False, slot=None):
    """probe_plain's probe of the active lanes, on a shard of those whose
    slot (given hrows: whose handed row) it owns: (the result fields, not
    found on every lane not probed, and on a shard "slot", each lane's MPHF
    slot (int32 bits); the lanes probed). slot: the lanes' slots, given."""
    B, dev = kmers32.shape[0], kmers32.device
    km = u.u32(kmers32)
    kr = u.u32(kmers_rc32) if kmers_rc32 is not None else None
    mv = u.from_i64(minval)
    mp = minpos.to(torch.int64)
    tries = [mp]
    if kr is not None:
        tries.append(cfg.kmw - mp)
        if minpos2 is not None:
            mp2 = minpos2.to(torch.int64)
            tries += [mp2, cfg.kmw - mp2]

    if hrows is not None:  # the hand-off's second pass
        r = u.u32(hrows)
        own = active & (r >= shard.hrow_lo) & (r < shard.hrow_hi)
        blk = take_rows(tables["sk_hrows"], torch.where(own, r - shard.hrow_lo, 0))
        return _result(cfg, fields, _verify(cfg, blk, own, km, kr, tries),
                       torch.ones_like(active)), own
    slot = mphf_eval_minimizer(cfg, tables, mv) if slot is None else u.u32(slot)
    slots = u.to_i32(slot)
    if shard is not None:
        in_range = (slot >= shard.slot_lo) & (slot < shard.slot_hi)
        active = active & in_range
        slot = torch.where(in_range, slot - shard.slot_lo, 0)
    own = active
    row = take_rows(tables["cw_row"], slot)
    sb, cw_a = row[:, 0], row[:, 1]
    status, cw_b = sb & 3, sb >> 2
    heavy, midload = status == 2, status == 1
    size = torch.where(midload, cw_b, torch.ones_like(cw_b))
    R1 = cand_block_width(cfg)
    c0 = row[:, 2: 2 + R1]

    gext0 = _ext0(cfg, c0[:, 0])
    gv = P.extract_window_dyn(c0[:, 1 + cfg.vbits_words: 1 + cfg.vbits_words + cfg.win_words],
                              (gext0 * 2) & M32, 2 * cfg.m, cfg.max_start_word)
    guard_ok = u.equal(gv, mv)
    if kr is not None:
        guard_ok = guard_ok | u.equal(gv, P.revcomp_mmer64(mv, cfg.m))

    found, off, orient, sid, beg, end = _verify(cfg, c0, active & ~heavy, km, kr, tries)
    state = [found, off, orient, sid, beg, end]

    def take(new):
        hit = new[0]
        for i in range(1, 6):
            state[i] = torch.where(hit, new[i], state[i])
        state[0] = state[0] | hit

    hrow = None
    if cfg.has_skew:
        canon = km
        if kr is not None:
            canon = torch.where(P.kmer_less(kr, km)[:, None], kr, km)
        cls = torch.where(heavy, cw_b, torch.zeros_like(cw_b))
        hidx = (_skew_param(tables, "pos_off", cls) + skew_slot(cfg, tables, canon, cls)) & M32
        if handoff:  # verified by the shard holding the row
            hrow = torch.where(active & heavy, hidx, INVALID32)
        else:
            take(_verify(cfg, take_rows(tables["sk_hrows"], hidx), active & heavy, km, kr,
                         tries))

    minimizer_found = ~(active & ~guard_ok & ~heavy)
    active = active & (guard_ok | heavy)
    if cfg.c1_in_row:
        take(_verify(cfg, row[:, 2 + R1: 2 + 2 * R1],
                     active & midload & (size >= 2) & ~state[0], km, kr, tries))
    jmin = 2 if cfg.c1_in_row else 1
    need = active & midload & ~state[0] & (size > jmin)
    lanes = need.nonzero()[:, 0]
    if len(lanes):
        sub = [s[lanes] for s in state]
        lsize, la, lkm = size[lanes], cw_a[lanes], km[lanes]
        lkr = kr[lanes] if kr is not None else None
        ltries = [t[lanes] for t in tries]
        for j in range(jmin, int(lsize.max())):
            mrow = take_rows(tables["mid_rows"], (la + j) & M32)
            new = _verify(cfg, mrow, (j < lsize) & ~sub[0], lkm, lkr, ltries)
            for i in range(1, 6):
                sub[i] = torch.where(new[0], new[i], sub[i])
            sub[0] = sub[0] | new[0]
        for i in range(6):
            state[i] = state[i].index_put((lanes,), sub[i])

    res = _result(cfg, fields, state, minimizer_found)
    if hrow is not None:
        res["hrow"] = u.to_i32(hrow)
    if shard is not None:
        res["slot"] = slots
    return res, own


def _result(cfg, fields, hit, minimizer_found):
    """The probe's result fields from the winning candidate's (found, off,
    orient, sid, begin, end)."""
    found, off, orient, sid, beg, end = hit
    off = torch.where(found, off, torch.zeros_like(off))
    invalid = torch.full_like(off, INVALID32)
    kid = off if cfg.row_v2 else (off - sid * (cfg.k - 1)) & M32
    res = {"kmer_id": u.to_i32(torch.where(found, kid, invalid)),
           "kmer_orientation": torch.where(found, orient, FORWARD_ORIENTATION).to(torch.int32),
           "minimizer_found": minimizer_found,
           "found": found}
    if fields == "full":
        for name, v in (("kmer_offset", off), ("string_id", sid), ("string_begin", beg),
                        ("string_end", end), ("kmer_id_in_string", (off - beg) & M32)):
            res[name] = u.to_i32(torch.where(found, v, invalid))
    return res


probe = kernels.by_device(kernels.probe_kernel, probe_plain, "probe", arg=2)

# kernel 2's packed combine buffer (its shard form on a DistMesh): the u32
# fields with the top bit flipped, so that a signed min orders them as
# unsigned, then kmer_orientation (FORWARD, 1, is the identity),
# minimizer_found and -found; its elementwise signed min over the shards
# is their combine
PACKED_U32 = ("kmer_id", "kmer_id_in_string", "kmer_offset", "string_id", "string_begin",
              "string_end")
_TOP = -(1 << 31)


def pack_result(res):
    """A probe result as kernel 2's packed (F, B) int32 buffer."""
    rows = [res[f] ^ _TOP for f in PACKED_U32 if f in res]
    rows += [res["kmer_orientation"], res["minimizer_found"].to(torch.int32),
             -res["found"].to(torch.int32)]
    return torch.stack(rows)


def unpack_result(packed, fields):
    """The result fields of a packed (F, B) buffer (pack_result's)."""
    names = [f for f in PACKED_U32 if fields == "full" or f == "kmer_id"]
    out = {f: packed[n] ^ _TOP for n, f in enumerate(names)}
    n = len(names)
    out["kmer_orientation"] = packed[n]
    out["minimizer_found"] = packed[n + 1] != 0
    out["found"] = packed[n + 2] != 0
    return out
_probe_entry = probe  # make_lookup's default; its parameter `probe` hides the name


def _merge(res_a, res_b, use_b, use_b_flags):
    out = {}
    for key in res_a:
        if key == "minimizer_found":
            out[key] = torch.where(use_b_flags, res_b[key], res_a[key])
        elif key == "found":
            out[key] = res_a[key] | (use_b & res_b[key])
        else:
            out[key] = torch.where(use_b, res_b[key], res_a[key])
    return out


def canonical_fold(mv_f, mp_f, mv_r, mp_r):
    """Canonical probe inputs from both strands' minimizers: the smaller
    minimizer VALUE and its position, plus the other strand's position
    where the values tie (a tie probes the same bucket, so the reference's
    retry with the other strand, src/dictionary.cpp:34-41, becomes two more
    position tries). Returns (minval, minpos, minpos2)."""
    rc_first = mv_r < mv_f
    mp1 = torch.where(rc_first, mp_r, mp_f)
    return (torch.where(rc_first, mv_r, mv_f), mp1,
            torch.where(mv_r == mv_f, mp_r, mp1))


def rc_misses(res, active):
    """The lanes the regular mode's RC round probes: the active ones the
    forward round left unfound."""
    return ~res["found"] if active is None else active & ~res["found"]


def merge_rc(res, res2, miss):
    """The regular mode's forward round res and RC round res2 (over the
    lanes miss) merged as engine._merge of the JAX package: a lane of miss
    reports BACKWARD whether or not the RC probe finds it, ORs
    minimizer_found over both probes and takes the RC hit's fields."""
    merged = _merge(res, res2, miss & res2["found"], miss)
    merged["minimizer_found"] = torch.where(
        miss, res["minimizer_found"] | res2["minimizer_found"], res["minimizer_found"])
    merged["kmer_orientation"] = torch.where(
        miss, BACKWARD_ORIENTATION, merged["kmer_orientation"]).to(torch.int32)
    return merged


def _lookup_two_kernels(cfg, tables, kmers32, mins, active, fields, minimizer, probe):
    """Kernel 1 (or mins, its five outputs), the canonical fold or the
    regular mode's RC retry with _merge, and kernel 2, as separate calls."""
    if mins is None:
        mins = minimizer(kmers32, cfg.k, cfg.m, cfg.magic, both=True)
    mv_f, mp_f, kmers_rc32, mv_r, mp_r = mins
    if cfg.canonical:
        mv1, mp1, mp2 = canonical_fold(mv_f, mp_f, mv_r, mp_r)
        return probe(cfg, tables, kmers32, kmers_rc32, mv1, mp1, mp2, active, fields)
    res = probe(cfg, tables, kmers32, None, mv_f, mp_f, None, active, fields)
    miss = rc_misses(res, active)
    return merge_rc(res, probe(cfg, tables, kmers_rc32, None, mv_r, mp_r, None, miss, fields),
                    miss)


def lookup_plain(cfg, tables, kmers32, active=None, fields="full"):
    """Plain version of the lookup kernel (csrc/probe.cu sshash_lookup):
    the batched lookup of (B, W) int32 kmers through the plain versions of
    kernel 1, the fold (or the RC retry and _merge) and kernel 2. Same
    contract as kernels.lookup_kernel."""
    check_fields(cfg, fields)
    return _lookup_two_kernels(cfg, tables, kmers32, None, active, fields, P.minimizer_plain,
                               probe_plain)


lookup = kernels.by_device(kernels.lookup_kernel, lookup_plain, "lookup", arg=2)


def lookup_ranks_plain(cfg, tables, kmers32, mins, active, count):
    """Plain version of the rank-space lookup (csrc/lookup_ranks.cu): the
    ranks below count (int32 (1,), read on the host here) of the (P, W)
    int32 kmers, looked up where active (bool (P,)) from their minimizers
    mins = (mv_f, mp_f, mv_r, mp_r) (kernel 1's rank form) through the
    plain two-kernel form (the fold or the RC retry, then probe_plain); the
    others below the count report not found (found and minimizer_found
    False, ids 0xFFFFFFFF, orientation FORWARD). Returns
    kernels.STREAM_FIELDS, each (P,); ranks at or past the count are not
    part of the result (the kernel leaves them unwritten; they read not
    found here)."""
    Pn, dev = kmers32.shape[0], kmers32.device
    n = min(max(int(count[0]), 0), Pn)
    km = kmers32[:n]
    mv_f, mp_f, mv_r, mp_r = (t[:n] for t in mins)
    rc = u.to_i32(P.revcomp_kmers(u.u32(km), cfg.k))
    on = active[:n]
    res = _lookup_two_kernels(cfg, tables, km, (mv_f, mp_f, rc, mv_r, mp_r), on, "full",
                              P.minimizer_plain, probe_plain)
    out = {"found": torch.zeros(Pn, dtype=torch.bool, device=dev),
           "minimizer_found": torch.zeros(Pn, dtype=torch.bool, device=dev),
           "string_id": torch.full((Pn,), -1, dtype=torch.int32, device=dev),
           "kmer_id": torch.full((Pn,), -1, dtype=torch.int32, device=dev),
           "kmer_orientation": torch.full((Pn,), FORWARD_ORIENTATION, dtype=torch.int32,
                                          device=dev)}
    for name, v in out.items():
        v[:n] = torch.where(on, res[name], v[:n])
    return out


lookup_ranks = kernels.by_device(kernels.lookup_ranks_kernel, lookup_ranks_plain,
                                 "lookup-ranks", arg=2)


def probe_ranks_plain(cfg, tables, kmers32, mins, active, count, fields, shard, out, *, lists,
                      rc_round=False, hrows=None):
    """Plain version of kernel 2's rank form (csrc/shard.cuh, entry
    sshash_probe_ranks), same contract as kernels.probe_ranks_kernel: the
    shard form's masked owned (or packed) lookup through probe_plain,
    limited to the ranks below count (int32 (1,), read on the host here) of
    the (P, W) int32 kmers, from kernel 1's rank-form minimizers mins =
    (mv_f, mp_f, mv_r, mp_r): the canonical fold with the RC kmers, or the
    forward strand, or with rc_round the RC kmers and strand. Stores into
    out (views of its first count ranks) and returns it; the ranks past the
    count are left as they are. shard: one ProbeShard, or a mesh row's
    (tables a dict each), each probed in turn. lists (the kernel's list
    pass) is not read: each shard's active ranks are found from their slots
    here, and the packed form's identity stores repeat the list pass's."""
    shards, tabs, _, _, _, _ = rank_probe_shards(cfg, fields, shard, tables, hrows, out,
                                                 rc_round)
    if len(shards) > 1 or shards[0] is not shard:
        for t, sh in zip(tabs, shards):
            probe_ranks_plain(cfg, t, kmers32, mins, active, count, fields, sh, out, lists=lists,
                              rc_round=rc_round, hrows=hrows)
        return out
    handoff, packed = check_rank_probe(cfg, fields, shard, hrows, out, False, rc_round)
    n = min(max(int(count[0]), 0), kmers32.shape[0])
    km = kmers32[:n]
    mv_f, mp_f, mv_r, mp_r = (t[:n] for t in mins)
    if cfg.canonical:
        args = (km, u.to_i32(P.revcomp_kmers(u.u32(km), cfg.k)),
                *canonical_fold(mv_f, mp_f, mv_r, mp_r))
    elif rc_round:
        args = (u.to_i32(P.revcomp_kmers(u.u32(km), cfg.k)), None, mv_r, mp_r, None)
    else:
        args = (km, None, mv_f, mp_f, None)
    view = {key: v[:, :n] if key == "packed" else v[:n] for key, v in out.items()}
    probe_plain(cfg, tables, *args, None if active is None else active[:n], "full", shard,
                None if hrows is None else hrows[:n], view, False, rc_round and not packed)
    return out


probe_ranks = kernels.by_device(kernels.probe_ranks_kernel, probe_ranks_plain, "probe-ranks",
                                arg=2)


def rank_lists_plain(cfg, tables, kmers32, mins, active, count, fields, shard, out, fill=False,
                     rc_round=False, hrows=None):
    """Plain version of the list pass of kernel 2's rank form (csrc/shard.cuh
    rank_list_kernel, entry sshash_rank_lists), same contract as
    kernels.rank_lists_kernel, count read on the host here: each active
    rank below the count (not found yet in the owned form's RC round and
    hand-off passes) whose key (its minimizer's MPHF slot,
    mphf_eval_minimizer, of the canonical fold or the round's strand; or
    its handed row) is in the range of `shard`, with that key, in the list
    in rank order, the rows past its count zero; the other ranks below the
    count stored as not found with fill (the combine's identity in the
    packed form; hrow 0xFFFFFFFF), none in the hand-off's second pass."""
    handoff, packed = check_rank_probe(cfg, fields, shard, hrows, out, fill, rc_round)
    Pn, dev = kmers32.shape[0], kmers32.device
    n = min(max(int(count[0]), 0), Pn)
    view = {key: v[:, :n] if key == "packed" else v[:n] for key, v in out.items()}
    act = torch.ones(n, dtype=torch.bool, device=dev) if active is None else active[:n]
    if not packed and (rc_round or hrows is not None):
        act = act & ~view["found"]
    if hrows is not None:
        key, lo, hi = u.u32(hrows[:n]), shard.hrow_lo, shard.hrow_hi
    else:
        mv_f, mv_r = mins[0][:n], mins[2][:n]
        mv = torch.where(mv_r < mv_f, mv_r, mv_f) if cfg.canonical else mv_r if rc_round else mv_f
        key, lo, hi = mphf_eval_minimizer(cfg, tables, u.from_i64(mv)), shard.slot_lo, shard.slot_hi
    listed = act & (key >= lo) & (key < hi)
    if hrows is None:
        rest = ~listed & (packed | (~act & fill))
        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        nf = _result(cfg, "full", (torch.zeros(n, dtype=torch.bool, device=dev), *[zero] * 5),
                     torch.ones(n, dtype=torch.bool, device=dev))
        nf["hrow"] = torch.full((n,), -1, dtype=torch.int32, device=dev)
        _store(view, {"packed": pack_result(nf), "hrow": nf.pop("hrow")} if packed else nf, rest)
    r = listed.nonzero()[:, 0]
    entries = torch.zeros((Pn, 2), dtype=torch.int32, device=dev)
    entries[:len(r), 0] = r.to(torch.int32)
    entries[:len(r), 1] = u.to_i32(key[r])
    return {"entries": entries, "count": torch.tensor([len(r)], dtype=torch.int32, device=dev)}


rank_lists = kernels.by_device(kernels.rank_lists_kernel, rank_lists_plain, "rank-lists", arg=2)


def make_lookup(cfg, fields="full", minimizer=None, probe=None):
    """Batched lookup over (B, W) int32 kmers (src/dictionary.cpp:58-78
    semantics). fields="ids" returns only kmer_id / kmer_orientation /
    minimizer_found (the reference's plain lookup()). v2 rows serve
    fields="ids" only.

    fn(tables, kmers32, active=None): active (bool) limits the probes to
    those lanes, the others report not found.

    With minimizer and probe left None, a call is one `lookup` (one launch
    of the lookup kernel on a CUDA tensor, lookup_plain on a CPU one).
    Otherwise it is the two-kernel form: `minimizer` (default the kernel 1
    entry), the fold or the RC retry, and `probe` (default the kernel 2
    entry): the sharded engine passes its own probe, and passing the plain
    versions runs the same lookup without kernels on any device."""
    check_fields(cfg, fields)
    one_launch = minimizer is None and probe is None
    minimizer = minimizer or P.minimizer
    probe = probe or _probe_entry

    def fn(tables, kmers32, active=None):
        if one_launch:
            return lookup(cfg, tables, kmers32, active, fields)
        return _lookup_two_kernels(cfg, tables, kmers32, None, active, fields, minimizer, probe)

    return fn


def make_neighbours(cfg, fields="full", variants=P.neighbour_variants, lookup=None,
                    **lookup_kw):
    """Batched navigation (src/dictionary.cpp:112-128): one lookup over the
    8 one-char variants of each kmer, 4 forward then 4 backward; result
    fields are (B, 8). `variants` defaults to the kernel entry point;
    `lookup` (a make_lookup fn, the bucket-sharded engine's own) to
    make_lookup(cfg, fields, **lookup_kw) (its `minimizer` and `probe`;
    the one-launch lookup by default)."""
    lookup = lookup or make_lookup(cfg, fields, **lookup_kw)

    def fn(tables, kmers32):
        B = kmers32.shape[0]
        res = lookup(tables, variants(kmers32, cfg.k).view(8 * B, cfg.W))
        return {key: v.reshape(8, B).t() for key, v in res.items()}

    return fn


def acc_offset(cfg, row, ids):
    """Char offset per lane from its access row (_acc_resolve): the string
    id is the row's sid hint plus the row's string starts <= the id."""
    sid = row[:, 0] + (ids[:, None] >= row[:, 1: 1 + cfg.access_C]).sum(dim=1)
    return (ids + sid * (cfg.k - 1)) & M32


def acc_read_window(cfg, row, ids, off):
    """The kmer from the row's own packed-string words: the window starts
    at word floor(o_min/16), o_min = (id & ~31) + hint*(k-1)."""
    o_min = ((ids & ~31) + row[:, 0] * (cfg.k - 1)) & M32
    local = (off - (o_min & ~15)) & M32
    return P.extract_kmer_dyn(row[:, 1 + cfg.access_C:], 2 * local, cfg.k)


def access_plain(cfg, tables, ids, blocks=None):
    """Plain version of the access kernel: (B,) int32 ids -> (B, W) int32
    kmers. blocks (a layout.AccessShard): the tables are one bucket shard's
    (acc_rows of id blocks [blk_lo, blk_hi)) and a lane of another shard's
    block reads zeros; in the two-round form such a call returns the first
    round's (B,) char offsets instead, 0xFFFFFFFF on those lanes
    (parallel/sharded.py make_sharded_access of the JAX package)."""
    check_access(cfg)
    i = u.u32(ids)
    blk = i >> 5
    own = None
    if blocks is not None:
        own = (blk >= blocks.blk_lo) & (blk < blocks.blk_hi)
        blk = torch.where(own, blk - blocks.blk_lo, 0)
    row = take_rows(tables["acc_rows"], blk)
    off = acc_offset(cfg, row, i)
    if acc_windowed(cfg.k, cfg.access_C):
        out = acc_read_window(cfg, row, i, off)
    elif own is not None:
        return u.to_i32(torch.where(own, off, INVALID32))
    else:
        out = P.read_kmers_at(u.u32(tables["strings32"]), off, cfg.k)
    if own is not None:
        out = torch.where(own[:, None], out, 0)
    return u.to_i32(out)


def access_read_plain(cfg, tables, offsets, words):
    """Plain version of the sharded two-round access form's second round:
    (B,) int32 char offsets (0xFFFFFFFF: none) -> (B, W) int32 kmers read
    from this shard's strings32 words [word_lo, word_hi) and their halo
    (words: a layout.AccessShard); zeros where the offset's word is
    another shard's."""
    o = u.u32(offsets)
    w0 = o >> 4
    own = (o != INVALID32) & (w0 >= words.word_lo) & (w0 < words.word_hi)
    local = torch.where(own, o - 16 * words.word_lo, 0)
    out = P.read_kmers_at(u.u32(tables["strings32"]), local, cfg.k)
    return u.to_i32(torch.where(own[:, None], out, 0))


access = kernels.by_device(kernels.access_kernel, access_plain, "access", arg=2)
access_read = kernels.by_device(kernels.access_read_kernel, access_read_plain, "access-read",
                                arg=2)


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def iterate_plain(k, strings32, vstart32):
    """Plain version of the iterator kernel: (2,) int32 tensor of u32
    (count, checksum). count is the popcount of vstart32; checksum the
    sum mod 2^32, over every valid start, of the XOR of its kmer's W
    words (make_iterator's reduce form)."""
    s, v = u.u32(strings32), u.u32(vstart32)
    W, NW = P.num_words32(k), s.shape[0]
    sp = torch.cat([s, s.new_zeros(W)])
    srcs = [sp[j: j + NW] for j in range(W + 1)]
    last_mask = (1 << (2 * k - 32 * (W - 1))) - 1
    # word w's 16 valid bits sit in half (w & 1) of vstart32[w >> 1]
    vv = v.repeat_interleave(2)[:NW] >> ((torch.arange(NW, device=s.device) & 1) * 16)
    acc = torch.zeros_like(s)
    for c in range(16):
        fold = torch.zeros_like(s)
        for j in range(W):
            xj = srcs[j] if c == 0 else (srcs[j] >> (2 * c)) | ((srcs[j + 1] << (32 - 2 * c)) & M32)
            fold ^= xj & last_mask if j == W - 1 else xj
        acc = (acc + fold * ((vv >> c) & 1)) & M32
    out = torch.stack([_popcount32(v).sum() & M32, acc.sum() & M32])
    return u.to_i32(out)


def iterate_kmers_plain(k, strings32, vstart32):
    """make_iterator(materialize=True): (valid bool (16*NW,), kmers int32
    (16*NW, W)) for every char offset, in offset order (= id order over
    the valid ones)."""
    kmers = P.iterate_kmers(u.u32(strings32), k)
    bits = (u.u32(vstart32)[:, None] >> torch.arange(32, device=strings32.device)) & 1
    return bits.reshape(-1)[: kmers.shape[0]] != 0, u.to_i32(kmers)


iterate = kernels.by_device(kernels.iterate_kernel, iterate_plain, "iterator", arg=1)


def weight_plain(tables, ids, owned=False):
    """Plain version of the weight kernel: (B,) int32 ids -> (B,) int32
    weights. The run index is searchsorted(right) - 1 over w_endpoints,
    clipped to the runs (-1 reads run 0, as JAX's clipped take does).
    owned: the tables are one bucket shard's runs (endpoints padded with
    the last), and an id outside [endpoints[0], endpoints[-1]) weighs 0."""
    ep, i = u.u32(tables["w_endpoints"]), u.u32(ids)
    run = torch.searchsorted(ep, i, right=True) - 1
    vid = take_rows(tables["w_value_ids"], run.clamp(min=0))
    w = take_rows(tables["w_dictionary"], vid)
    if owned:
        w = torch.where((i >= ep[0]) & (i < ep[-1]), w, 0)
    return u.to_i32(w)


weight = kernels.by_device(kernels.weight_kernel, weight_plain, "weight", arg=1)


def _to_host_result(res):
    """Device result -> the oracle's numpy contract: u32 fields as uint64
    with INVALID on misses, orientation int64, minimizer_found bool."""
    res = {key: v.cpu().numpy() for key, v in res.items()}
    found = res.pop("found")
    out = {}
    for key, v in res.items():
        if key == "kmer_orientation":
            out[key] = v.astype(np.int64)
        elif v.dtype == np.int32:
            v64 = v.view(np.uint32).astype(np.uint64)
            v64[~found] = np.uint64(INVALID_UINT64)
            out[key] = v64
        else:
            out[key] = v
    return out


def _neighbours_to_host(res):
    """Navigation result -> DeviceEngine.kmer_neighbours' contract: as
    _to_host_result, but orientation stays int32."""
    out = _to_host_result(res)
    out["kmer_orientation"] = out["kmer_orientation"].astype(np.int32)
    return out


class TorchEngine:
    """Device-resident tables + the batched point-query entry points
    (counterpart of sshash_tpu.engine.DeviceEngine): lookup, membership,
    access, weight, navigation and full iteration.

    host_arrs: a precomputed table dict (layout.device_arrays, or the JAX
    package's _device_arrays / its .npy cache, whose v2 blocks and legacy
    heavy path layout.tables_from_host converts) for large indexes.
    row_format: None (rebased v2 rows at >= 2^32 chars, else v1), "v1" or
    "v2". A v2 engine's lookup and navigation return the id fields only,
    as the JAX package's DeviceEngine does.

    SSHASH_DEBUG=1 in the environment at construction: lookups run the
    sanitizer's checked lookup (debug.checkified_lookup: synchronous
    launches, then the postcondition check over the result), as the JAX
    package's DeviceEngine does."""

    def __init__(self, index, device="cuda", host_arrs=None, row_format=None):
        self.index = index
        self.device = torch.device(device)
        self.cfg = StaticCfg(index, row_format)
        if host_arrs is None:
            host_arrs = device_arrays(index, row_format)
        else:
            host_arrs = with_access_tables(index, self.cfg, host_arrs)
        self.tables = tables_from_host(host_arrs, self.device, self.cfg, index)
        fields = "ids" if self.cfg.row_v2 else "full"
        self._lookup = make_lookup(self.cfg, fields)
        self._lookup_ids = make_lookup(self.cfg, "ids")
        self._neighbours = make_neighbours(self.cfg, fields)
        self._debug = os.environ.get("SSHASH_DEBUG", "") not in ("", "0")
        self._ck_lookup = debug.checkified_lookup(self) if self._debug else None

    def table_bytes(self):
        """Device bytes of the tables by group (layout.TABLE_GROUPS):
        "lookup" (the probe's tables and strings32), "access" (acc_rows,
        vstart32) and "weight"."""
        return {group: sum(self.tables[n].numel() * self.tables[n].element_size()
                           for n in names if n in self.tables)
                for group, names in TABLE_GROUPS.items()}

    def kmers32(self, kmers64):
        """(B, W64) uint64 packed kmers -> (B, W) int32 tensor on the device."""
        kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=np.uint64))
        k32 = np.ascontiguousarray(K.kmers_to_u32(kmers64, self.cfg.k))
        return torch.from_numpy(k32.view(np.int32)).to(self.device)

    def lookup_device(self, kmers32):
        """(B, W) int32 kmers on the device -> dict of result tensors
        (checked with SSHASH_DEBUG)."""
        if self._debug:
            return self._ck_lookup(kmers32)
        return self._lookup(self.tables, kmers32)

    def lookup_ids_device(self, kmers32):
        return self._lookup_ids(self.tables, kmers32)

    def lookup(self, kmers64):
        """(B, W64) uint64 packed kmers -> numpy results, as oracle.lookup."""
        return _to_host_result(self.lookup_device(self.kmers32(kmers64)))

    def is_member(self, kmers64):
        return self.lookup(kmers64)["kmer_id"] != np.uint64(INVALID_UINT64)

    def access_device(self, ids):
        """(B,) int32 kmer ids (u32 bits) on the device -> (B, W) int32
        kmers."""
        return access(self.cfg, self.tables, ids)

    def _ids(self, ids):
        """kmer ids -> (B,) int32 tensor of their u32 bits on the device."""
        ids = np.ascontiguousarray(np.asarray(ids, dtype=np.uint32))
        return torch.from_numpy(ids.view(np.int32)).to(self.device)

    def access(self, ids):
        """kmer ids -> (B, W64) uint64 packed kmers, as oracle.access."""
        out = self.access_device(self._ids(ids))
        return K.u32_to_kmers64(out.cpu().numpy().view(np.uint32), self.cfg.k)

    def weight_device(self, ids):
        """(B,) int32 kmer ids (u32 bits) on the device -> (B,) int32
        weights (u32 bits). Raises on an unweighted index."""
        if not self.cfg.weighted:
            raise RuntimeError("dictionary is not weighted")
        return weight(self.tables, ids)

    def weight(self, ids):
        """kmer ids -> uint64 weights, as index.weights.weight."""
        out = self.weight_device(self._ids(ids))
        return out.cpu().numpy().view(np.uint32).astype(np.uint64)

    def kmer_neighbours_device(self, kmers32):
        """(B, W) int32 kmers on the device -> dict of (B, 8) result
        tensors: columns 0-3 forward A, C, T, G, then 4-7 backward."""
        return self._neighbours(self.tables, kmers32)

    def kmer_neighbours(self, kmers64):
        """(B, W64) uint64 packed kmers -> dict of (B, 8) numpy arrays, as
        DeviceEngine.kmer_neighbours."""
        return _neighbours_to_host(self.kmer_neighbours_device(self.kmers32(kmers64)))

    def iterator_device(self):
        """(count, checksum) of a full iteration as a (2,) int32 tensor of
        u32 bits, left on the device."""
        return iterate(self.cfg.k, self.tables["strings32"], self.tables["vstart32"])

    def iterator(self):
        """(count, checksum) as numpy uint32 scalars, as DeviceEngine's
        iterator returns them."""
        count, checksum = self.iterator_device().cpu().numpy().view(np.uint32)
        return count, checksum
