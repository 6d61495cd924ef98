"""Synthetic unitig sets, and the small index configurations that the CPU
tests and chip_smoke.py both check the port on.

Random strings stand in for the reference's bundled unitigs (absent from
the build machines). `planted` overwrites random sites with m-mers whose
minimizer hash is among the smallest of a large sample, so each planted
m-mer is the minimizer of nearly every kmer around it: planting it c times
makes a bucket of about c super-kmers, and c > 2^MIN_L makes it heavy.
`weights` writes per-kmer weights into the FASTA headers, in runs of equal
weight that cross string ends, as a weighted build input. Its mean run
length at scale is the reference's own weighted example's,
ECOLI_SAKAI_MEAN_RUN; the small weighted configuration uses short runs so
that its tests cross many run edges.
"""

import dataclasses
import os
import tempfile

import numpy as np

from . import hashing as H
from . import kmer as K
from . import oracle
from .builder.build import BuildConfig, build
from .mphf import MPHF

# code -> char under the index's 2-bit map (kmer.NUCLEOTIDES)
_CHARS = np.frombuffer(b"ACTG", dtype=np.uint8)

# E. coli O157:H7 Sakai, k31: the reference's weighted example (its README
# Example 4, lines 236-251; BASELINE.md) has 5,820 weight runs over 2,115
# unitigs (tests/test_permute.py) of a 5.5 Mbp genome, so about 5.5M kmers
# and a mean run of about 945 kmers. The source gives no count of distinct
# weights.
ECOLI_SAKAI_MEAN_RUN = 945

# name -> build parameters; each exercises a path of the probe
SMALL_CONFIGS = {
    # singleton-rich: no candidate 1 in the row, size-2 buckets on the sweep
    "m13_regular": dict(k=31, m=13, canonical=False, num_strings=128, string_len=1001, seed=1),
    "m13_canonical": dict(k=31, m=13, canonical=True, num_strings=64, string_len=1001, seed=2),
    # >= 0.1% multi buckets: candidate 1 in the row
    "m9_c1": dict(k=31, m=9, canonical=False, num_strings=64, string_len=101, seed=3),
    # tiny m: heavy (skew) buckets and long mid buckets
    "m3_skew": dict(k=31, m=3, canonical=False, num_strings=64, string_len=101, seed=4),
    "m3_skew_canonical": dict(k=31, m=3, canonical=True, num_strings=64, string_len=101, seed=5),
    # partitioned minimizer MPHF
    "partitioned": dict(k=31, m=13, canonical=False, num_strings=64, string_len=101, seed=6,
                        avg_partition_size=128),
    # one, three and four u32 words per kmer
    "k15": dict(k=15, m=7, canonical=False, num_strings=64, string_len=101, seed=8),
    "k47": dict(k=47, m=17, canonical=True, num_strings=32, string_len=201, seed=9),
    "k63": dict(k=63, m=25, canonical=True, num_strings=32, string_len=201, seed=7),
    # weighted build: weight runs of random length (mean 16), skewed values
    "weighted": dict(k=31, m=13, canonical=False, num_strings=64, string_len=101, seed=10,
                     weights=16),
    # 5 kmers per string: 7+ string starts per 32-id block, so the access
    # rows are too wide for their char window (the two-round access form)
    "short_strings": dict(k=31, m=13, canonical=False, num_strings=400, string_len=35,
                          seed=11),
}

# k > 63 (five or more u32 words per kmer): the kernels' fixed widths W = 5
# and 8 and their runtime-width form (W = 9). planted adds mid and heavy
# buckets (m >= 21 leaves random strings all singletons); ties plants
# pairs of a low-hash m-mer and its reverse complement, so that both
# strands of the kmers spanning a pair share their minimizer value (the
# canonical tie, tie_batch)
WIDE_CONFIGS = {
    # test_fuzz.py case 10's k and m; 26 kmers per string, so up to two
    # strings start in a 32-id block and the access rows take the
    # two-round form; weighted
    "k65": dict(k=65, m=21, canonical=False, num_strings=200, string_len=90, seed=12,
                weights=8),
    # test_fuzz.py case 11's k and m; windowed access rows (C = 1)
    "k65_canonical": dict(k=65, m=23, canonical=True, num_strings=96, string_len=400, seed=13,
                          planted=[120, 3, 5, 10], ties=[12, 12]),
    "k127_canonical": dict(k=127, m=27, canonical=True, num_strings=48, string_len=500,
                           seed=14, planted=[3, 5, 8], ties=[10]),
    "k129_canonical": dict(k=129, m=31, canonical=True, num_strings=80, string_len=700,
                           seed=15, planted=[100, 3, 5], ties=[12, 12]),
}


# Access rows of every width residue: strings of n kmers put up to
# floor(31 / n) + 1 string starts in a 32-id block, so C = 2 at 20 kmers a
# string, 3 at 11-12, 4 at 9. The windowed rows (1 + C + Wa words, C >= 2)
# are 12, 13, 14, 15 and 16 words wide, so a row starts at every word of a
# 16-byte segment and takes up to 5 segments; k31 gives only 12 and 15 at C
# >= 2, hence k29, k35 (W = 3) and k51 (W = 4, the widest windowed row).
# Beside them the two-round form at C = 4 and a windowed W = 5 row. Each
# num_kmers leaves a partial last block.
ACCESS_CONFIGS = {
    "acc_k31_c2": dict(k=31, m=13, canonical=False, num_strings=61, string_len=50, seed=21),
    "acc_k35_c2": dict(k=35, m=13, canonical=True, num_strings=47, string_len=54, seed=22),
    "acc_k29_c3": dict(k=29, m=13, canonical=False, num_strings=83, string_len=40, seed=23),
    "acc_k31_c3": dict(k=31, m=13, canonical=True, num_strings=90, string_len=41, seed=24),
    "acc_k51_c2": dict(k=51, m=17, canonical=False, num_strings=53, string_len=70, seed=27),
    "acc_k31_two_round": dict(k=31, m=13, canonical=False, num_strings=111, string_len=39,
                              seed=25),
    "acc_k65_w5": dict(k=65, m=23, canonical=False, num_strings=25, string_len=104, seed=26),
}

def low_hash_mmers(n, m, seed, sample=1 << 20, rng=None):
    """The n m-mers (as 2-bit code arrays) of smallest minimizer hash among
    `sample` random ones, for an index built with `seed`."""
    rng = rng or np.random.default_rng(0)
    vals = rng.integers(0, 1 << (2 * m), sample, dtype=np.uint64)
    h = H.mixer64(vals, H.mixer_magic(seed))
    best = vals[np.argsort(h)[:n]]
    shifts = np.arange(m, dtype=np.uint64) * np.uint64(2)
    return ((best[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)


def plant(codes, mmers, counts, k, rng, leads=None, context=0):
    """Write mmers[i] (code arrays) counts[i] times at distinct random sites
    of `codes`, sites 2k chars apart, leads[i] chars (0 by default) into
    its site; a unit and its lead take at most 2k chars. context c > 0
    writes c chars on each side of every unit (its lead then c), the same
    c chars before and after it and different at each of a unit's sites:
    an m-mer unit's kmers of k = m + c then never repeat, where random
    chars around a unit planted thousands of times would repeat some (two
    sites share a kmer when the kmer's c other chars agree)."""
    S, L = codes.shape
    if context:
        leads = [context] * len(mmers)
    leads = leads or [0] * len(mmers)
    m = max(len(x) + d for x, d in zip(mmers, leads)) + context
    per = (L - m) // (2 * k)
    need = int(sum(counts))
    if need > S * per:
        raise ValueError(f"{need} plants do not fit {S} strings of {L} chars")
    sites = rng.choice(S * per, need, replace=False)
    owner = np.repeat(np.arange(len(counts)), counts)
    rows, cols = sites // per, (sites % per) * 2 * k
    for j, x in enumerate(mmers):
        sel = owner == j
        for i in range(len(x)):
            codes[rows[sel], cols[sel] + leads[j] + i] = x[i]
        if context:
            if counts[j] > 4 ** context:
                raise ValueError(f"{counts[j]} sites of a unit need more than {context} "
                                 f"context chars")
            ctx = rng.choice(4 ** context, counts[j], replace=False)
            for i in range(context):
                digit = ((ctx >> (2 * i)) & 3).astype(np.uint8)
                codes[rows[sel], cols[sel] + i] = digit
                codes[rows[sel], cols[sel] + context + len(x) + i] = digit
    return codes


def weight_runs(n, rng, mean_run):
    """n per-kmer weights in runs of equal weight: run lengths geometric
    (mean mean_run), run values Zipf-distributed (many small, a few large,
    as k-mer abundances fall; at most 2^32 - 1)."""
    lens = rng.geometric(1.0 / mean_run, n // mean_run + 64)
    while lens.sum() < n:
        lens = np.concatenate([lens, rng.geometric(1.0 / mean_run, n // mean_run + 64)])
    vals = np.minimum(rng.zipf(1.5, len(lens)), (1 << 32) - 1).astype(np.uint64)
    return np.repeat(vals, lens)[:n]


def weight_tables(n_runs, span, rng):
    """The three weight tables of an index whose n_runs weight runs cover
    ids [0, span), without building one: endpoints 0, n_runs - 1 distinct
    random cuts and span (uint32[n_runs + 1]); Zipf(1.5) run values as
    weight_runs draws them, kept as index.Weights keeps them (the sorted
    distinct values, and each run's index into them). Returns a host dict
    of uint32 arrays under the layout's names."""
    if not 1 <= n_runs <= span < 1 << 32:
        raise ValueError(f"{n_runs} runs cannot cover [0, {span})")
    cuts = np.zeros(0, np.int64)
    while len(cuts) < n_runs - 1:
        cuts = np.unique(np.concatenate([cuts, rng.integers(1, span, n_runs + 16)]))
    cuts = np.sort(rng.choice(cuts, n_runs - 1, replace=False))
    ep = np.concatenate([[0], cuts, [span]]).astype(np.uint32)
    vals = np.minimum(rng.zipf(1.5, n_runs), (1 << 32) - 1).astype(np.uint64)
    dictionary, vids = np.unique(vals, return_inverse=True)
    return {"w_endpoints": ep, "w_value_ids": vids.astype(np.uint32),
            "w_dictionary": dictionary.astype(np.uint32)}


# The out-of-core soak's synthetic collection (the JAX package's
# scripts/soak_external.py generate): strings of SOAK_STRING_LEN random
# ACGT chars from SOAK_SEED, each record '>i'. The capacity run's input.
SOAK_STRING_LEN = 100_000
SOAK_SEED = 7
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def soak_count(num_kmers, k):
    """Strings the soak writes for num_kmers k-mers: as many as cover them."""
    return -(-num_kmers // (SOAK_STRING_LEN - k + 1))


def soak_strings(num_kmers, k, seed=SOAK_SEED):
    """The soak's strings in file order, one at a time, as ACGT bytes
    (uint8 arrays): the same draws as soak_external.generate."""
    rng = np.random.default_rng(seed)
    for _ in range(soak_count(num_kmers, k)):
        yield _ACGT[rng.integers(0, 4, SOAK_STRING_LEN, dtype=np.uint8)]


def write_soak(path, num_kmers, k, seed=SOAK_SEED):
    """Write the soak's FASTA to path, byte for byte as
    soak_external.generate does, one string at a time. Returns its k-mer
    count."""
    n = 0
    with open(path, "wb") as f:
        for i, seq in enumerate(soak_strings(num_kmers, k, seed)):
            f.write(b">" + str(i).encode() + b"\n")
            f.write(seq.tobytes() + b"\n")
            n += len(seq) - k + 1
    return n


def window_words(codes, k):
    """(N, W64) uint64 packed k-mers at every offset of one string's codes
    (N = len - k + 1), in the index's packing (char j at bits 2j of word
    j // 32): each word is a window of up to 32 chars, built by doubling
    windows of 1, 2, 4, ... chars."""
    c = np.asarray(codes, dtype=np.uint64)
    n = len(c) - k + 1
    wins = {1: c}
    span = 1
    while span < min(k, 32):
        w = wins[span]
        wins[2 * span] = w[: len(w) - span] | (w[span:] << np.uint64(2 * span))
        span *= 2
    out = np.empty((n, K.num_words64(k)), dtype=np.uint64)
    for j in range(out.shape[1]):
        length, start, acc, shift = min(32, k - 32 * j), 32 * j, None, 0
        for p in sorted(wins, reverse=True):  # length in binary, high part first
            if length & p:
                part = wins[p][start + shift: start + shift + n] << np.uint64(2 * shift)
                acc = part if acc is None else acc | part
                shift += p
        out[:, j] = acc
    return out


def write_fasta(path, codes, k=None, weights=None):
    """One record per row of codes; with weights (one per kmer, string by
    string), weighted headers '>i LN:i:len ab:Z:w0 w1 ...'."""
    chars = _CHARS[codes]
    L = codes.shape[1]
    with open(path, "wb") as f:
        for i in range(len(chars)):
            if weights is None:
                f.write(b">%d\n" % i)
            else:
                w = weights[i * (L - k + 1): (i + 1) * (L - k + 1)]
                f.write(b">%d LN:i:%d ab:Z:%s\n" % (i, L, " ".join(map(str, w.tolist())).encode()))
            f.write(chars[i].tobytes())
            f.write(b"\n")


def tie_pair(mmer, rng):
    """Codes of a low-hash m-mer, 3 random chars and the m-mer's reverse
    complement: both strands of every kmer that holds the whole pair have
    the m-mer as their minimizer (a tie, as its hash is the lowest)."""
    return np.concatenate([mmer, rng.integers(0, 4, 3, dtype=np.uint8), (mmer ^ 2)[::-1]])


def string_codes(num_strings, string_len, seed):
    """(rng, codes): write_input's random strings, as (num_strings,
    string_len) codes in the index's 2-bit map, before any planting, and
    the generator that draws the rest of its input."""
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, 4, (num_strings, string_len), dtype=np.uint8)


def write_input(path, k, m, canonical, num_strings, string_len, seed,
                avg_partition_size=None, planted=None, threads=1, weights=None, ties=None,
                context=0):
    """Write the FASTA of random strings drawn from `seed` to path and
    return its BuildConfig. planted: list of plant counts, one low-hash
    m-mer per entry (with context, plant's distinct contexts around each:
    k - m chars keeps every heavy kmer distinct). ties: list of plant
    counts of tie_pair units, one low-hash m-mer per entry. weights: the
    mean run length of a weighted build, with weight_runs drawn from the
    same seed."""
    rng, codes = string_codes(num_strings, string_len, seed)
    cfg = BuildConfig(k=k, m=m, canonical=canonical, verbose=False, threads=threads,
                      avg_partition_size=avg_partition_size, weighted=bool(weights))
    if planted or ties:
        low = low_hash_mmers(len(planted or []) + len(ties or []), m, cfg.seed, rng=rng)
        units = list(low[: len(planted or [])])
        units += [tie_pair(x, rng) for x in low[len(planted or []):]]
        # a tie pair sits k - 2m - 3 chars into its site, so that each of
        # the k - 2m - 2 kmers holding it starts inside the string
        leads = [0] * len(planted or []) + [k - 2 * m - 3] * len(ties or [])
        if context:
            if ties:
                raise ValueError("context plants planted m-mers alone, without tie pairs")
            plant(codes, units, list(planted), k, rng, context=context)
        else:
            plant(codes, units, list(planted or []) + list(ties or []), k, rng, leads)
    w = weight_runs(num_strings * (string_len - k + 1), rng, weights) if weights else None
    write_fasta(path, codes, k, w)
    return cfg


def build_index(**kw):
    """Index over write_input's FASTA (same keywords)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "unitigs.fa")
        return build(path, write_input(path, **kw))


def small_index(name):
    return build_index(**(SMALL_CONFIGS.get(name) or WIDE_CONFIGS.get(name)
                          or ACCESS_CONFIGS[name]))


def path_kmer_ids(idx, rng, n):
    """Up to n ids of kmers whose minimizer bucket holds 2+ positions or is
    heavy (the lanes that reach candidate 1, the sweep or the skew index)."""
    ids = np.arange(idx.num_kmers)
    status, _, size, _ = oracle._decode_codewords(
        idx, bucket_minimizers(idx, oracle.access(idx, ids)))
    sel = ids[(status == 2) | (size >= 2)]
    return rng.choice(sel, min(n, len(sel)), replace=False)


def bucket_minimizers(idx, km):
    """The minimizer whose bucket each kmer's lookup probes (the smaller of
    both strands' in a canonical index)."""
    magic = H.mixer_magic(idx.seed)
    mv, _ = oracle.compute_minimizer(km, idx.k, idx.m, magic)
    if idx.canonical:
        mr, _ = oracle.compute_minimizer(K.revcomp_kmers(km, idx.k), idx.k, idx.m, magic)
        mv = np.minimum(mv, mr)
    return mv


def legacy_skew(idx, plain_mphf=False):
    """A copy of a v1.2+ index in a pre-v1.2 skew form: every skew class
    loses hindex (the JAX package's heavy lanes then resolve slot ->
    position in the bucket -> heavy row; the port derives the hindex
    again, layout.class_hindex). With plain_mphf each non-empty class is
    also rebuilt as a plain MPHF over its heavy kmers (the canonical ones
    in a canonical index, found by layout.heavy_kmers from the heavy
    buckets' positions), its positions re-keyed so that
    new[new_slot(kmer)] = old[old_slot(kmer)]."""
    from .layout import heavy_kmers

    parts = [dataclasses.replace(p, hindex=None) for p in idx.skew_partitions]
    if plain_mphf and any(p.mphf.n for p in parts):
        words, cls, _, _ = heavy_kmers(idx)
        for i, p in enumerate(parts):
            if p.mphf.n == 0:
                continue
            keys = words[cls == i]
            old, first = np.unique(p.mphf.eval_words(keys), return_index=True)
            keys = keys[first]  # one a slot: a kmer found at two offsets counts once
            if len(keys) != p.mphf.n:
                raise ValueError(f"skew class {i}: {len(keys)} heavy kmers found for "
                                 f"{p.mphf.n} keys")
            f = MPHF.build_words(keys, seed=idx.seed + 1000 + i)
            positions = np.zeros(p.mphf.n, dtype=np.uint32)
            positions[f.eval_words(keys)] = p.positions[old]
            parts[i] = dataclasses.replace(p, mphf=f, positions=positions)
    return dataclasses.replace(idx, skew_partitions=parts)


def rebase_ids(cfg, tables, base):
    """A copy of a v2 engine's tables (layout.tables_from_host) with `base`
    added, mod 2^32, to every candidate block's kid0: each kmer the tables
    find then comes back as its id + base mod 2^32, so ids at and above
    2^31 run through the probe without an index of that size. Tensors not
    changed are shared."""
    from .layout import cand_block_width
    from .ops import u64 as u

    if not cfg.row_v2:
        raise ValueError("kid0 exists in v2 rows only")
    R1 = cand_block_width(cfg)
    kid0 = 1 + cfg.vbits_words + cfg.win_words

    def shifted(t, cols):
        t = t.clone()
        for c in cols:
            t[:, c] = u.to_i32((u.u32(t[:, c]) + base) & u.M32)
        return t

    out = dict(tables)
    out["cw_row"] = shifted(tables["cw_row"],
                            [2 + kid0 + j * R1 for j in range(2 if cfg.c1_in_row else 1)])
    for name in ("mid_rows", "sk_hrows"):
        out[name] = shifted(tables[name], [kid0])
    return out


_RC = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp_bytes(seq):
    return seq[::-1].translate(_RC)


def index_strings(idx, ids=None):
    """The index's strings (or those of `ids`) as ACGT bytes."""
    ep = idx.string_endpoints.astype(np.int64)
    ids = range(idx.num_strings) if ids is None else ids
    shifts = np.arange(32, dtype=np.uint64) * np.uint64(2)
    out = []
    for s in ids:
        b, e = int(ep[s]), int(ep[s + 1])
        w = idx.strings64[b // 32: (e + 31) // 32 + 1]
        codes = ((w[:, None] >> shifts) & np.uint64(3)).astype(np.uint8).reshape(-1)
        out.append(_CHARS[codes[b % 32: b % 32 + e - b]].tobytes())
    return out


def write_genome(path, strings, rng, line=80):
    """One FASTA record: the strings joined in a random order, every other
    one reverse-complemented, in lines of `line` chars (a genome streamed
    against its own index)."""
    order = rng.permutation(len(strings))
    seq = b"".join(revcomp_bytes(strings[j]) if i % 2 else strings[j]
                   for i, j in enumerate(order))
    with open(path, "wb") as f:
        f.write(b">genome\n")
        for i in range(0, len(seq), line):
            f.write(seq[i: i + line] + b"\n")
    return len(seq)


def write_reads(path, reads):
    """FASTQ of the reads (bytes)."""
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))


def cut_reads(strings, n, length, rng, rc=0.0, subst=0.0):
    """n reads of `length` chars cut at random from the strings (at least
    that long), a fraction rc of them reverse-complemented, each char
    substituted at random with probability subst."""
    pool = [s for s in strings if len(s) >= length]
    reads = []
    for i in range(n):
        s = pool[rng.integers(len(pool))]
        o = rng.integers(0, len(s) - length + 1)
        r = bytearray(s[o: o + length])
        hits = np.nonzero(rng.random(length) < subst)[0]
        for j in hits:
            r[j] = _CHARS[rng.integers(4)]
        r = bytes(r)
        reads.append(revcomp_bytes(r) if rng.random() < rc else r)
    return reads


def random_reads(n, length, rng):
    return [_CHARS[c].tobytes() for c in rng.integers(0, 4, (n, length), dtype=np.uint8)]


def with_n(reads, frac, rng):
    """One N at a random place in a fraction `frac` of the reads."""
    out = list(reads)
    for i in np.nonzero(rng.random(len(out)) < frac)[0]:
        r = bytearray(out[i])
        r[rng.integers(len(r))] = ord("N")
        out[i] = bytes(r)
    return out


# the stream anchor stage's edge cases (stream_chunk)
STREAM_CHUNK_CASES = ("exact_k", "split", "last_lane", "last_group", "n0", "nR", "random")


def stream_chunk(case, k, rng, P, R):
    """The anchor stage's inputs of a synthetic chunk of P lanes and R read
    slots: (pstart, rfirst, nreads, words32) as int32 tensors of u32 bits,
    pstart the exclusive scan of rnpos. rnpos[:nreads] >= 1 sums to at most
    P, as the stream's packer writes it; past nreads it holds garbage.
    case: "exact_k" (R reads of one position each), "split" (a long read's
    middle segment, then its last), "last_lane" (a read starting at lane
    P - 1), "last_group" (the first segment runs into the last group of 16
    lanes), "n0" (no reads), "nR" (R reads) or "random"."""
    import torch

    rnpos = rng.integers(0, 1 << 20, R)
    if case == "exact_k":
        n = R
        rnpos[:n] = 1
    elif case == "split":
        n = 2
        rnpos[:n] = (P - 40, 40)
    elif case == "last_lane":
        n = R // 2
        cut = np.sort(rng.choice(np.arange(1, P - 1), n - 2, replace=False))
        rnpos[:n] = np.diff(np.concatenate([[0], cut, [P - 1, P]]))
    elif case == "last_group":
        n = 4
        rnpos[:n] = (P - 10, 3, 3, 4)
    elif case == "n0":
        n = 0
    else:
        n = R if case == "nR" else int(rng.integers(1, R))
        cut = np.sort(rng.choice(np.arange(1, P), n - 1, replace=False))
        total = int(rng.integers(cut[-1] + 1 if n > 1 else 1, P + 1))
        rnpos[:n] = np.diff(np.concatenate([[0], cut, [total]]))
    if not ((rnpos[:n] >= 1).all() and rnpos[:n].sum() <= P):
        raise ValueError(f"{case}: P={P}, R={R} too small for the case")
    pstart = (np.cumsum(rnpos) - rnpos).astype(np.uint32)
    rfirst = rng.integers(0, 1 << 32, R // 32 + 1, dtype=np.uint64).astype(np.uint32)
    # the chars of P positions in R segments of k - 1 overlap, 16 a word
    words = rng.integers(0, 1 << 32, (P + R * (k - 1)) // 16 + 2, dtype=np.uint64)
    t = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))  # noqa: E731
    return t(pstart), t(rfirst), torch.tensor([n], dtype=torch.int32), t(words)


def miss_lanes(rng, P, m):
    """A compacted lane list of a chunk of P lanes, as the stream's
    compaction leaves it: m distinct lanes of [0, P), rising, in runs of 1
    to 33 adjacent lanes with random gaps between, and zeros past m. int32
    (P,)."""
    import torch

    lens = []
    while sum(lens) < m:
        lens.append(min(int(rng.integers(1, 34)), m - sum(lens)))
    # the free lanes before each run, rising: the runs never touch back
    free = np.sort(rng.integers(0, P - m + 1, len(lens)))
    starts = free + np.cumsum([0] + lens[:-1])
    out = np.zeros(P, np.int32)
    if lens:
        out[:m] = np.concatenate([s + np.arange(n) for s, n in zip(starts, lens)])
    return torch.from_numpy(out)


def random_kmers(k, rng, n):
    """n random packed k-mers (almost surely absent from an index)."""
    W64 = K.num_words64(k)
    km = rng.integers(0, 1 << 64, (n, W64), dtype=np.uint64)
    rem = 2 * k - 64 * (W64 - 1)
    if rem < 64:
        km[:, -1] &= np.uint64((1 << rem) - 1)
    return km


def query_batch(idx, seed=0):
    """An odd-sized batch of packed kmers: 50%-RC positives (uniform ids
    plus path_kmer_ids), random negatives, and a shuffled mix. Returns
    (kmers64, number of leading positives)."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, idx.num_kmers, 600), path_kmer_ids(idx, rng, 300)])
    pos = oracle.access(idx, ids)
    pos[::2] = K.revcomp_kmers(pos[::2], idx.k)
    mixed = np.concatenate([oracle.access(idx, rng.integers(0, idx.num_kmers, 300)),
                            random_kmers(idx.k, rng, 300)])
    mixed[::3] = K.revcomp_kmers(mixed[::3], idx.k)
    q = np.concatenate([pos, random_kmers(idx.k, rng, 500), mixed[rng.permutation(len(mixed))]])
    return q[: len(q) - 1 + len(q) % 2], len(pos)


def tie_kmers(idx, km):
    """Mask of the packed kmers whose two strands' minimizer values are
    equal (the canonical lookup's tie)."""
    magic = H.mixer_magic(idx.seed)
    mv, _ = oracle.compute_minimizer(km, idx.k, idx.m, magic)
    mr, _ = oracle.compute_minimizer(K.revcomp_kmers(km, idx.k), idx.k, idx.m, magic)
    return mv == mr


def tie_lanes(engine, kmers32):
    """Mask of the (B, W) int32 kmers on a TorchEngine's device whose two
    strands' minimizer values are equal: kernel 1 on a CUDA tensor, its
    plain version on a CPU one."""
    from .ops import packed as P

    cfg = engine.cfg
    mv, _, _, mv_r, _ = P.minimizer(kmers32, cfg.k, cfg.m, cfg.magic, both=True)
    return mv == mv_r


def tie_batch(idx, rng, n, engine=None, chunk=1 << 23):
    """Up to n kmers of the index whose strands tie (WIDE_CONFIGS' ties)
    and, from them, misses that still tie: each hit with the first
    one-char change (lowest char) that keeps the tie and leaves the kmer
    absent from the index. Returns (hits, misses), packed. The kmers are
    read, tested for the tie and looked up through the oracle or, given a
    TorchEngine over idx, through its access (chunk ids at a time),
    tie_lanes and lookup on its device."""
    import torch

    if engine is None:
        km = oracle.access(idx, np.arange(idx.num_kmers))
        hits = km[tie_kmers(idx, km)]

        def tied_miss(x):
            return tie_kmers(idx, x) & (oracle.lookup(idx, x)["kmer_id"] == oracle.INVALID)
    else:
        found = []
        for lo in range(0, idx.num_kmers, chunk):
            ids = torch.arange(lo, min(lo + chunk, idx.num_kmers), device=engine.device)
            km = engine.access_device(ids.to(torch.int32))
            found.append(km[tie_lanes(engine, km)].cpu().numpy().view(np.uint32))
        hits = K.u32_to_kmers64(np.concatenate(found), idx.k)

        def tied_miss(x):
            kt = engine.kmers32(x)
            return (tie_lanes(engine, kt) & ~engine.lookup_ids_device(kt)["found"]).cpu().numpy()
    hits = hits[rng.permutation(len(hits))[:n]]
    miss = hits.copy()
    done = np.zeros(len(hits), dtype=bool)
    for j in range(idx.k):
        w, b = divmod(2 * j, 64)
        flip = miss.copy()
        flip[:, w] ^= np.uint64(1 << b)
        take = ~done & tied_miss(flip)
        miss[take], done = flip[take], done | take
    return hits, miss[done]
