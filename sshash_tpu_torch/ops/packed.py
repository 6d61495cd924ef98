"""Packed 2-bit string algebra on u32 words held in int64 tensors.

Plain PyTorch counterpart of sshash_tpu/ops/packed.py (same layout: char j
of a kmer lives in word j // 16 at bit 2 * (j % 16), words little-end
first). Kmers are (B, W) int64 tensors of u32 values; 64-bit values are
ops.u64 pairs.

`minimizer` is the entry point of kernel 1 (csrc/minimizer.cu),
`neighbour_variants` of the neighbours kernel (csrc/neighbours.cu) and
`read_kmers_at2` of the read kernel (csrc/read_at2.cu): a CPU tensor runs
the plain version, a CUDA tensor runs the kernel. Every function here
takes kmers of any width (k <= 255 in the kernels).
"""

import torch

from .. import kernels
from . import u64 as u
from .u64 import M32


def num_words32(k):
    return (2 * k + 31) // 32


def mask_last_word(words, k):
    rem = 2 * k - 32 * (num_words32(k) - 1)
    if rem == 32:
        return words
    out = words.clone()
    out[:, -1] &= (1 << rem) - 1
    return out


def crc32_word(x):
    """Reverse-complement 16 chars packed in a u32 (host analog:
    kmer.crc64)."""
    c = x ^ 0xAAAAAAAA
    r = ((c & 0x0000FFFF) << 16) | ((c & 0xFFFF0000) >> 16)
    r = ((r & 0x00FF00FF) << 8) | ((r & 0xFF00FF00) >> 8)
    r = ((r & 0x0F0F0F0F) << 4) | ((r & 0xF0F0F0F0) >> 4)
    return ((r & 0x33333333) << 2) | ((r & 0xCCCCCCCC) >> 2)


def revcomp_kmers(kmers, k):
    """(B, W) -> reverse complement, same layout."""
    W = kmers.shape[1]
    rev = crc32_word(kmers).flip(1)
    s = W * 32 - 2 * k
    if s == 0:
        return rev
    out = rev >> s
    out[:, :-1] |= (rev[:, 1:] << (32 - s)) & M32
    return out


def revcomp_mmer64(val, m):
    """RC of u64-packed m-mers (m <= 31)."""
    return u.shr(u.u64(crc32_word(val.lo), crc32_word(val.hi)), 64 - 2 * m)


def _word(words, i):
    return words[:, i] if i < words.shape[1] else torch.zeros_like(words[:, 0])


def extract_window(kmers, bit, width_bits):
    """Up to 64 bits at constant bit offset `bit` of (B, W) kmers -> u64
    masked to width_bits."""
    w, b = divmod(bit, 32)
    if b == 0:
        lo, hi = _word(kmers, w), _word(kmers, w + 1)
    else:
        lo = (_word(kmers, w) >> b) | ((_word(kmers, w + 1) << (32 - b)) & M32)
        hi = (_word(kmers, w + 1) >> b) | ((_word(kmers, w + 2) << (32 - b)) & M32)
    if width_bits < 64:
        hi = hi & (((1 << width_bits) - 1) >> 32)
        lo = lo & (((1 << width_bits) - 1) & M32)
    return u.u64(hi, lo)


def _funnel(win, bitpos, nout, max_start_word):
    """nout words starting at a per-lane bit offset of the (B, Ww) window.
    A start word past max_start_word reads from word 0, as the JAX select
    chain does (it only has variants for start words 0..max_start_word)."""
    B, Ww = win.shape
    nvar = Ww if max_start_word is None else min(Ww, max_start_word + 1)
    w0 = bitpos >> 5
    w0 = torch.where(w0 < nvar, w0, torch.zeros_like(w0))
    b = (bitpos & 31)[:, None]
    pad = torch.cat([win, win.new_zeros(B, nout + 1)], dim=1)
    idx = w0[:, None] + torch.arange(nout + 1, device=win.device)[None, :]
    g = torch.gather(pad, 1, idx)
    hi = torch.where(b != 0, (g[:, 1:] << (32 - b)) & M32, torch.zeros_like(b))
    return (g[:, :-1] >> b) | hi


def extract_window_dyn(win, bitpos, width_bits, max_start_word=None):
    """Up to 64 bits at a per-lane bit offset (int64 (B,), u32 values) of a
    (B, Ww) window -> u64 masked to width_bits."""
    lo_hi = _funnel(win, bitpos, 2, max_start_word)
    lo, hi = lo_hi[:, 0], lo_hi[:, 1]
    if width_bits < 64:
        hi = hi & (((1 << width_bits) - 1) >> 32)
        lo = lo & (((1 << width_bits) - 1) & M32)
    return u.u64(hi, lo)


def extract_kmer_dyn(win, bitpos, k, max_start_word=None):
    """k-char kmer at a per-lane bit offset of a (B, Ww) window -> (B, W)."""
    return mask_last_word(_funnel(win, bitpos, num_words32(k), max_start_word), k)


def read_kmers_at(strings32, offsets, k):
    """k-char kmers at char offsets (int64 (B,)) of the packed strings
    (int64 (NW,)) -> (B, W). Word reads clip to the last word, so every
    offset reads in bounds."""
    idx = (offsets >> 4)[:, None] + torch.arange(num_words32(k) + 1, device=offsets.device)
    g = strings32[idx.clamp(max=strings32.shape[0] - 1)]
    return extract_kmer_dyn(g, 2 * (offsets & 15), k)


def interleave_valid_starts(strings32, vstart32):
    """The interleaved (NW, 2) int32 table of read_kmers_at2 from the
    packed strings and the valid-start bits (int32 u32 bits): row w holds
    word w and the 16 valid-start bits of its char offsets, which sit in
    half (w & 1) of vstart32[w >> 1]."""
    w = torch.arange(strings32.shape[0], device=strings32.device)
    bits = (u.u32(vstart32)[w >> 1] >> ((w & 1) * 16)) & 0xFFFF
    return torch.stack([strings32, bits.to(torch.int32)], dim=1)


def read_kmers_at2_plain(table, offsets, k):
    """Plain version of the read kernel (csrc/read_at2.cu): the k-char kmer
    and the valid-start bit at each char offset of the interleaved (NW, 2)
    table (interleave_valid_starts). (B,) int32 offsets (u32 bits) ->
    ((B, W) int32 kmers, (B,) bool); row reads clip to the last row, as
    the JAX package's take(..., mode="clip") does."""
    o = u.u32(offsets)
    idx = (o >> 4)[:, None] + torch.arange(num_words32(k) + 1, device=o.device)
    rows = u.u32(table)[idx.clamp(max=table.shape[0] - 1)]
    kmers = extract_kmer_dyn(rows[:, :, 0], 2 * (o & 15), k)
    return u.to_i32(kmers), ((rows[:, 0, 1] >> (o & 15)) & 1) != 0


read_kmers_at2 = kernels.by_device(kernels.read_at2_kernel, read_kmers_at2_plain, "read-at2",
                                   arg=1)


def iterate_kmers(strings32, k):
    """The kmer at every char offset of the packed strings (int64 (NW,)):
    (16 * NW, W), offset order; offsets past the end read zero words.
    Callers mask with the valid-start bits."""
    W = num_words32(k)
    NW = strings32.shape[0]
    sp = torch.cat([strings32, strings32.new_zeros(W + 1)])
    cols = []
    for j in range(W):
        lo, hi = sp[j: j + NW], sp[j + 1: j + 1 + NW]
        phases = [lo] + [(lo >> (2 * p)) | ((hi << (32 - 2 * p)) & M32) for p in range(1, 16)]
        cols.append(torch.stack(phases, dim=1).reshape(-1))
    return mask_last_word(torch.stack(cols, dim=1), k)


def char_mmer_hashes(words32, n_chars, m, magic):
    """Per-char m-mer mixer hashes over a packed buffer (int64 (NW,), u32
    values): h_f[c] = mixer64(m-mer at char c), h_r[c] = mixer64 of its
    reverse complement; chars past the buffer read zero. Returns (h_f, h_r)
    u64 pairs of (n_chars,)."""
    nw = (n_chars + 15) // 16
    pad = torch.cat([words32, words32.new_zeros(2)])
    w0, w1, w2 = pad[:nw], pad[1: nw + 1], pad[2: nw + 2]
    los = [w0] + [((w0 >> (2 * p)) | (w1 << (32 - 2 * p))) & M32 for p in range(1, 16)]
    his = [w1] + [((w1 >> (2 * p)) | (w2 << (32 - 2 * p))) & M32 for p in range(1, 16)]
    lo = torch.stack(los, dim=1).reshape(-1)[:n_chars]
    hi = torch.stack(his, dim=1).reshape(-1)[:n_chars]
    mask = (1 << (2 * m)) - 1
    v = u.u64(hi & (mask >> 32), lo & (mask & M32))
    return u.mixer64(v, magic), u.mixer64(revcomp_mmer64(v, m), magic)


def sliding_min_u64(h, w):
    """min over the windows [c, c+w) of a u64 pair of (C,); past the end
    reads 2^64-1 (log-steps of shifted minimums)."""
    cur, span = h, 1
    while span < w:
        s = min(span, w - span)
        fill = torch.full((s,), M32, dtype=torch.int64, device=h.hi.device)
        sh = u.u64(torch.cat([cur.hi[s:], fill]), torch.cat([cur.lo[s:], fill]))
        cur = u.select(u.less(sh, cur), sh, cur)
        span += s
    return cur


def prefix_sum_ex(v):
    """Exclusive prefix sum over axis 0 (int32 (B,) or (B, C)), wrapping
    mod 2^32 as the JAX int32 scan does. Plain version of the scan kernel
    (csrc/scan.cu)."""
    s = torch.cumsum(v, 0, dtype=torch.int64) - v
    return u.to_i32(s & M32)


scan_ex = kernels.by_device(kernels.scan_kernel, prefix_sum_ex, "scan")


def compact_plain(flags):
    """Compaction (the rank scatter of streaming.py:557-559 of the JAX
    package): flags uint8 (B,) -> (idx int32 (B,), n int32 (1,)) with
    idx[:n] the flagged lanes in order and zeros after."""
    lanes = torch.nonzero(flags).reshape(-1)
    idx = torch.zeros(flags.shape[0], dtype=torch.int32, device=flags.device)
    idx[: lanes.shape[0]] = lanes.to(torch.int32)
    return idx, torch.tensor([lanes.shape[0]], dtype=torch.int32, device=flags.device)


compact = kernels.by_device(kernels.compact_kernel, compact_plain, "compaction")


def drop_one_char(kmers):
    out = kmers >> 2
    out[:, :-1] |= (kmers[:, 1:] << 30) & M32
    return out


def shift_up_one_char(kmers, k):
    out = (kmers << 2) & M32
    out[:, 1:] |= kmers[:, :-1] >> 30
    return mask_last_word(out, k)


def set_char(kmers, i, code):
    """OR code into char i (the char is zero in the callers' kmers)."""
    w, b = divmod(2 * i, 32)
    out = kmers.clone()
    out[:, w] |= code << b
    return out


def neighbour_variants_plain(kmers32, k):
    """Plain version of the neighbours kernel: (B, W) int32 kmers -> the
    8 one-char variants as one (8, B, W) int32 tensor, variant-major:
    drop the first char and append A, C, T, G (codes 0-3), then shift up
    one char and prepend A, C, T, G (engine.make_neighbours)."""
    km = u.u32(kmers32)
    fwd, bwd = drop_one_char(km), shift_up_one_char(km, k)
    variants = [set_char(fwd, k - 1, c) for c in range(4)] + [set_char(bwd, 0, c) for c in range(4)]
    return u.to_i32(torch.stack(variants))


neighbour_variants = kernels.by_device(kernels.neighbours_kernel, neighbour_variants_plain,
                                       "neighbours")


def kmer_less(a, b):
    """Integer compare, word W-1 most significant."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(less)
    for w in range(a.shape[1] - 1, -1, -1):
        lt, gt = a[:, w] < b[:, w], a[:, w] > b[:, w]
        less = less | (~decided & lt)
        decided = decided | lt | gt
    return less


def kmer_equal(a, b):
    return (a == b).all(dim=1)


def compute_minimizer(kmers, k, m, magic):
    """Leftmost minimal mixer-hash m-mer per kmer (strict < keeps the
    leftmost). Returns (value u64, pos int64 (B,)). Also stands in for the
    JAX tournament tree `_tree_min`, which computes the same function."""
    best_h = best_v = None
    best_p = torch.zeros(kmers.shape[0], dtype=torch.int64, device=kmers.device)
    for j in range(k - m + 1):
        v = extract_window(kmers, 2 * j, 2 * m)
        h = u.mixer64(v, magic)
        if best_h is None:
            best_h, best_v = h, v
            continue
        upd = u.less(h, best_h)
        best_h, best_v = u.select(upd, h, best_h), u.select(upd, v, best_v)
        best_p = torch.where(upd, j, best_p)
    return best_v, best_p


def compute_minimizer_two_strand(kmers, k, m, magic):
    """Both-strand minimizers from one window scan: the RC kmer's window at
    RC position l is the RC of the forward window at j = k-m-l. The RC scan
    keeps the LEFTMOST minimum in RC coordinates, i.e. the rightmost j (<=).
    Returns (mv_f, mp_f, mv_r, mp_r), equal to compute_minimizer on kmers
    and on revcomp_kmers(kmers)."""
    B = kmers.shape[0]
    bf_h = bf_v = br_h = br_v = None
    bf_p = torch.zeros(B, dtype=torch.int64, device=kmers.device)
    br_j = torch.zeros_like(bf_p)
    for j in range(k - m + 1):
        v = extract_window(kmers, 2 * j, 2 * m)
        h = u.mixer64(v, magic)
        vr = revcomp_mmer64(v, m)
        hr = u.mixer64(vr, magic)
        if bf_h is None:
            bf_h, bf_v, br_h, br_v = h, v, hr, vr
            continue
        upd = u.less(h, bf_h)
        bf_h, bf_v = u.select(upd, h, bf_h), u.select(upd, v, bf_v)
        bf_p = torch.where(upd, j, bf_p)
        updr = ~u.less(br_h, hr)
        br_h, br_v = u.select(updr, hr, br_h), u.select(updr, vr, br_v)
        br_j = torch.where(updr, j, br_j)
    return bf_v, bf_p, br_v, (k - m) - br_j


def minimizer_plain(kmers32, k, m, magic, both=False):
    """Plain version of kernel 1, same signature and dtypes: kmers32 (B, W)
    int32 (u32 bits) -> (mv int64, mp int32) and, with both=True, also
    (kmers_rc32 int32 (B, W), mv_r int64, mp_r int32). Minimizer values
    are < 2^62, so int64 holds them exactly."""
    km = u.u32(kmers32)
    if not both:
        mv, mp = compute_minimizer(km, k, m, magic)
        return u.to_i64(mv), mp.to(torch.int32)
    mv, mp, mv_r, mp_r = compute_minimizer_two_strand(km, k, m, magic)
    return (u.to_i64(mv), mp.to(torch.int32), u.to_i32(revcomp_kmers(km, k)),
            u.to_i64(mv_r), mp_r.to(torch.int32))


minimizer = kernels.by_device(kernels.minimizer_kernel, minimizer_plain, "minimizer")


def minimizer_ranks_plain(kmers32, count, k, m, magic):
    """Plain version of kernel 1's rank form: both strands' minimizers of
    the (P, W) int32 kmers' rows below count (int32 (1,), read on the host
    here) -> (mv_f int64, mp_f int32, mv_r int64, mp_r int32), each (P,).
    Rows at or past the count are not part of the result (the kernel leaves
    them unwritten; they are zero here)."""
    Pn = kmers32.shape[0]
    n = min(max(int(count[0]), 0), Pn)
    mv_f, mp_f, _, mv_r, mp_r = minimizer_plain(kmers32[:n], k, m, magic, both=True)
    out = []
    for t in (mv_f, mp_f, mv_r, mp_r):
        full = torch.zeros(Pn, dtype=t.dtype, device=kmers32.device)
        full[:n] = t
        out.append(full)
    return tuple(out)


minimizer_ranks = kernels.by_device(kernels.minimizer_ranks_kernel, minimizer_ranks_plain,
                                    "minimizer-ranks")
