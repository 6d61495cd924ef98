// Native host-side hot loops for the sshash-tpu builder.
//
// The reference delegates minimal-perfect-hash construction to PTHash
// (C++ submodule, reference: include/minimizers_control_map.hpp:7-34) and
// runs its builder hot loops in C++/AVX2 (src/builder/encode_strings.cpp).
// This file provides the equivalents for the host build: the MPHF pilot
// search (bit-identical to mphf.py::_search) and a batched minimizer
// scanner. native.py compiles it with g++ at first use into
// build/sshash_tpu_torch/ and loads it via ctypes; everything has a NumPy
// fallback so the package runs without it.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <thread>

static inline uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

static inline uint32_t mulhi32(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * (uint64_t)b) >> 32);
}

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

extern "C" {

// Pilot search over size-desc-ordered buckets. Returns -1 on success, or
// the index (into `order`) of the bucket that failed (in-bucket collision
// or pilot space exhausted) — the caller re-seeds, mirroring
// mphf.py::build_from_hashes.
int64_t pilot_search(const uint32_t* lo,         // bucket-sorted lo32 hashes
                     const int64_t* starts,      // per unique bucket
                     const int64_t* counts,
                     const int64_t* order,       // visit order (size desc)
                     const int64_t* bucket_ids,  // unique bucket id per group
                     int64_t nb,                 // number of unique buckets
                     int64_t table_size,
                     int64_t max_pilot,
                     uint32_t* pilots,           // out, size num_buckets
                     uint8_t* taken)             // scratch, size table_size
{
    const uint32_t ts = (uint32_t)table_size;
    std::vector<uint32_t> slots;
    for (int64_t oi = 0; oi < nb; ++oi) {
        const int64_t bi = order[oi];
        const int64_t s = starts[bi];
        const int64_t c = counts[bi];
        const uint32_t* blo = lo + s;
        slots.resize(c);
        if (c > 1) {  // identical lo32 hashes can never split: re-seed
            std::vector<uint32_t> tmp(blo, blo + c);
            std::sort(tmp.begin(), tmp.end());
            if (std::adjacent_find(tmp.begin(), tmp.end()) != tmp.end()) return oi;
        }
        bool placed = false;
        for (int64_t p = 0; p < max_pilot; ++p) {
            const uint32_t fp = fmix32((uint32_t)p);
            bool ok = true;
            int64_t placed_upto = 0;
            for (int64_t i = 0; i < c; ++i) {
                const uint32_t slot = mulhi32(fmix32(blo[i] ^ fp), ts);
                if (taken[slot]) { ok = false; break; }
                taken[slot] = 1;  // also catches in-pilot duplicate slots
                slots[i] = slot;
                placed_upto = i + 1;
            }
            if (ok) {
                pilots[bucket_ids[bi]] = (uint32_t)p;
                placed = true;
                break;
            }
            for (int64_t i = 0; i < placed_upto; ++i) taken[slots[i]] = 0;
        }
        if (!placed) return oi;
    }
    return -1;
}

// splitmix64 over an array (hash of uint64 keys with pre-mixed seed).
void hash64_u64(const uint64_t* keys, int64_t n, uint64_t seed_mix,
                uint64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = splitmix64(keys[i] ^ seed_mix);
}

// Rolling minimizer scan over one 2-bit packed sequence.
// seq: packed uint64 words (char j at word j/32, bits 2*(j%32)), length n
// chars. For each of the n-k+1 kmers, writes the leftmost minimal
// mixer-hash m-mer value and its position in the kmer
// (bit-identical to util::compute_minimizer, reference util.hpp:262-283,
// evaluated per window like minimizer_iterator's rescan).
void minimizer_scan(const uint64_t* words, int64_t n, int64_t k, int64_t m,
                    uint64_t magic, uint64_t* out_val, int32_t* out_pos) {
    const int64_t num_kmers = n - k + 1;
    const int64_t num_mmers = n - m + 1;
    const uint64_t mask = (2 * m >= 64) ? ~0ull : ((1ull << (2 * m)) - 1);
    std::vector<uint64_t> mm(num_mmers), mh(num_mmers);
    for (int64_t j = 0; j < num_mmers; ++j) {
        const int64_t bit = 2 * j;
        const int64_t w = bit >> 6, b = bit & 63;
        uint64_t v = words[w] >> b;
        if (b) v |= words[w + 1] << (64 - b);
        v &= mask;
        mm[j] = v;
        mh[j] = v * 0x517CC1B727220A95ull ^ magic;
    }
    // per-kmer leftmost argmin over windows [i, i+k-m]: O(n) amortized via
    // monotone deque
    std::vector<int64_t> dq(num_mmers);
    int64_t head = 0, tail = 0;
    const int64_t win = k - m + 1;
    for (int64_t j = 0; j < num_mmers; ++j) {
        // strict '<' keeps the leftmost occurrence on ties
        while (tail > head && mh[j] < mh[dq[tail - 1]]) --tail;
        dq[tail++] = j;
        const int64_t i = j - win + 1;  // kmer index whose window ends at j
        if (i >= 0) {
            while (dq[head] < i) ++head;
            out_val[i] = mm[dq[head]];
            out_pos[i] = (int32_t)(dq[head] - i);
        }
    }
}

static inline uint64_t crc64(uint64_t x) {
    // complement + byteswap + in-byte char swap (reference kmer.hpp:141-157)
    uint64_t c = x ^ 0xAAAAAAAAAAAAAAAAull;
    c = __builtin_bswap64(c);
    c = ((c & 0x0F0F0F0F0F0F0F0Full) << 4) | ((c & 0xF0F0F0F0F0F0F0F0ull) >> 4);
    c = ((c & 0x3333333333333333ull) << 2) | ((c & 0xCCCCCCCCCCCCCCCCull) >> 2);
    return c;
}

// Full minimizer-tuple scan over concatenated 2-bit codes: one cache-friendly
// pass replacing the vectorized NumPy pipeline (builder/minimizers.py), which
// needs ~30 full-array passes. Semantics pinned by util::compute_minimizer +
// minimizer_iterator (reference util.hpp:262-283, minimizer_iterator.hpp:
// 10-169): forward = leftmost strictly-minimal m-mer hash; RC strand =
// rightmost (ties <=); canonical picks RC iff its VALUE is strictly smaller
// (compute_minimizer_tuples.cpp:82-85). Emits super-kmer runs
// (minimizer, pos_in_seq=absolute occurrence offset, pos_in_kmer, count).
// Returns the tuple count, or -1 if cap is exceeded.
int64_t tuple_scan(const uint8_t* codes, int64_t n_chars,
                   const int64_t* endpoints, int64_t num_seqs,
                   int64_t k, int64_t m, uint64_t magic, int canonical,
                   uint64_t* out_min, uint64_t* out_pos,
                   uint8_t* out_pik, uint8_t* out_cnt, int64_t cap) {
    (void)n_chars;
    const int64_t w = k - m + 1;
    const uint64_t mmask = (2 * m >= 64) ? ~0ull : ((1ull << (2 * m)) - 1);
    const int rcs = (int)(64 - 2 * m);
    const int64_t DQ = w + 1;  // deque capacity; head/tail indices are
    std::vector<int64_t> dqf(DQ), dqr(DQ);  // monotone, slots are modular
    std::vector<uint64_t> vbuf(w), hf(w), hr(w), vrbuf(w);
    auto F = [&](int64_t i) -> int64_t& { return dqf[i % DQ]; };
    auto Rq = [&](int64_t i) -> int64_t& { return dqr[i % DQ]; };

    int64_t t = 0;
    for (int64_t s = 0; s < num_seqs; ++s) {
        const int64_t b = endpoints[s], e = endpoints[s + 1];
        const int64_t nk = e - b - k + 1;
        if (nk <= 0) continue;
        const int64_t nm = e - b - m + 1;
        // pre-load chars [0, m-1) one slot up so the first >>2 in the loop
        // lands them at [0, m-2] and appends char m-1
        uint64_t mv = 0;
        for (int64_t j = 0; j < m - 1; ++j) mv |= (uint64_t)codes[b + j] << (2 * (j + 1));
        int64_t fh = 0, ft = 0, rh = 0, rt = 0;  // deque head/tail
        uint64_t prev_val = ~0ull;
        int64_t prev_occ = -1, run_head = -1;

        for (int64_t j = 0; j < nm; ++j) {
            mv = (mv >> 2) | ((uint64_t)codes[b + j + m - 1] << (2 * (m - 1)));
            // circular buffers indexed by j % w
            const int64_t slot = j % w;
            const uint64_t h = mv * 0x517CC1B727220A95ull ^ magic;
            vbuf[slot] = mv;
            hf[slot] = h;
            // forward deque: strict '<' keeps leftmost on ties
            while (ft > fh && h < hf[F(ft - 1) % w]) --ft;
            F(ft++) = j;
            uint64_t vr = 0, hrj = 0;
            if (canonical) {
                vr = crc64(mv) >> rcs;
                hrj = vr * 0x517CC1B727220A95ull ^ magic;
                vrbuf[slot] = vr;
                hr[slot] = hrj;
                // RC keeps the RIGHTMOST minimal: '<=' pops equals
                while (rt > rh && hrj <= hr[Rq(rt - 1) % w]) --rt;
                Rq(rt++) = j;
            }
            const int64_t p = j - w + 1;  // kmer index whose window ends at j
            if (p < 0) continue;
            while (F(fh) < p) ++fh;
            int64_t occ = F(fh);
            uint64_t val = vbuf[occ % w];
            if (canonical) {
                while (Rq(rh) < p) ++rh;
                const int64_t occr = Rq(rh);
                const uint64_t valr = vrbuf[occr % w];
                if (valr < val) { val = valr; occ = occr; }
            }
            if (val != prev_val || occ != prev_occ) {
                if (run_head >= 0) {
                    if (t >= cap) return -1;
                    out_min[t] = prev_val;
                    out_pos[t] = (uint64_t)(b + prev_occ);
                    out_pik[t] = (uint8_t)(prev_occ - run_head);
                    out_cnt[t] = (uint8_t)(p - run_head);
                    ++t;
                }
                run_head = p;
                prev_val = val;
                prev_occ = occ;
            }
        }
        if (run_head >= 0) {
            if (t >= cap) return -1;
            out_min[t] = prev_val;
            out_pos[t] = (uint64_t)(b + prev_occ);
            out_pik[t] = (uint8_t)(prev_occ - run_head);
            out_cnt[t] = (uint8_t)(nk - run_head);
            ++t;
        }
    }
    return t;
}

// Single-pass read-batch encoder for the streaming query pipeline
// (sshash_tpu/streaming.py flush): packs 2-bit codes into uint32 device
// words (invalid chars as 0, layout = char o in word o/16 at bit 2*(o%16))
// and emits per-POSITION validity bits in segment order (a position is
// valid iff its k chars are all ACGT/acgt). Replaces a multi-pass NumPy
// encode that dominated warm streaming time on slow hosts. Both output
// buffers must be zeroed by the caller. Returns the total position count.
//
// Hot path: 16 chars per iteration via SWAR. The 2-bit sshash code of an
// ACGT/acgt byte c is exactly (c >> 1) & 3 (A->00 C->01 T->10 G->11, the
// same table the scalar switch encodes), so a block packs with two
// multiply-gathers per 8 bytes; validity is a 4-constant zero-byte test.
// (The reference packs 32 bases/iter with AVX2 movemask+pdep,
// encode_strings.cpp:13-40 — this is the portable equivalent.)

static inline uint64_t load_u64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;  // little-endian hosts only (same assumption NumPy relies on)
}

// 0x80-mask of the bytes of y equal to the repeated byte q.
static inline uint64_t eq_bytes(uint64_t y, uint64_t q) {
    const uint64_t z = y ^ q;
    return (z - 0x0101010101010101ull) & ~z & 0x8080808080808080ull;
}

// 16 bits of packed 2-bit codes for 8 chars (char j -> bits 2j).
static inline uint32_t pack8(uint64_t v) {
    const uint64_t x = (v >> 1) & 0x0303030303030303ull;
    // b0..b3 (at bits 8i) gather to bits 24..31: terms land at 24+2i and
    // cross terms stay out of [24,32) with no carries (fields are 2 bits,
    // 2 apart)
    const uint64_t M = 0x01041040ull;
    const uint32_t lo = (uint32_t)((((x & 0xFFFFFFFFull) * M) >> 24) & 0xFF);
    const uint32_t hi = (uint32_t)(((x >> 32) * M >> 24) & 0xFF);
    return lo | (hi << 8);
}

int64_t encode_stream(const uint8_t* seq,
                      const int64_t* starts,  // per-segment char start
                      const int64_t* lens,    // per-segment char length
                      int64_t nseg, int64_t k,
                      uint32_t* words32,
                      uint32_t* valid_bits)
{
    const uint64_t ALL = 0x8080808080808080ull;
    int64_t t = 0;
    for (int64_t s = 0; s < nseg; ++s) {
        const int64_t b = starts[s], L = lens[s];
        int64_t run = 0;
        int64_t i = 0;
        while (i < L) {
            const int64_t g = b + i;
            // block path: one whole 16-aligned words32 word, every position
            // in it exists (i >= k-1) and — given 16 valid chars — is valid
            // (entering run >= k-1 makes run(i) >= k throughout the block)
            if ((g & 15) == 0 && i + 16 <= L && i >= k - 1 && run >= k - 1) {
                const uint64_t v0 = load_u64(seq + g), v1 = load_u64(seq + g + 8);
                const uint64_t y0 = v0 | 0x2020202020202020ull;
                const uint64_t y1 = v1 | 0x2020202020202020ull;
                const uint64_t ok0 =
                    eq_bytes(y0, 0x6161616161616161ull) |  // a
                    eq_bytes(y0, 0x6363636363636363ull) |  // c
                    eq_bytes(y0, 0x6767676767676767ull) |  // g
                    eq_bytes(y0, 0x7474747474747474ull);   // t
                const uint64_t ok1 =
                    eq_bytes(y1, 0x6161616161616161ull) |
                    eq_bytes(y1, 0x6363636363636363ull) |
                    eq_bytes(y1, 0x6767676767676767ull) |
                    eq_bytes(y1, 0x7474747474747474ull);
                if (ok0 == ALL && ok1 == ALL) {
                    words32[g >> 4] |= pack8(v0) | ((uint32_t)pack8(v1) << 16);
                    const uint32_t sh = (uint32_t)(t & 31);
                    valid_bits[t >> 5] |= 0xFFFFu << sh;
                    if (sh > 16) valid_bits[(t >> 5) + 1] |= 0xFFFFu >> (32 - sh);
                    t += 16;
                    run += 16;
                    i += 16;
                    continue;
                }
            }
            const uint8_t ch = seq[g];
            uint32_t code = 0;
            bool okc = true;
            switch (ch) {
                case 'A': case 'a': code = 0; break;
                case 'C': case 'c': code = 1; break;
                case 'T': case 't': code = 2; break;
                case 'G': case 'g': code = 3; break;
                default: okc = false; break;
            }
            run = okc ? run + 1 : 0;
            words32[g >> 4] |= code << ((g & 15) * 2);
            if (i >= k - 1) {
                if (run >= k) valid_bits[t >> 5] |= 1u << (t & 31);
                ++t;
            }
            ++i;
        }
    }
    return t;
}

// Thread-parallel STABLE sort of minimizer tuples by (minimizer, pos):
// fills idx with the sorting permutation, ties broken by original index —
// bit-identical to np.lexsort((pos, minimizer)). Chunked std::sort +
// pairwise inplace_merge rounds, the reference's parallel_sort shape
// (reference include/builder/parallel_sort.hpp:57-125).
int64_t sort_tuples(const uint64_t* mn, const uint64_t* pos, int64_t* idx,
                    int64_t n, int64_t nthreads)
{
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    auto cmp = [mn, pos](int64_t a, int64_t b) {
        if (mn[a] != mn[b]) return mn[a] < mn[b];
        if (pos[a] != pos[b]) return pos[a] < pos[b];
        return a < b;
    };
    int64_t nt = nthreads < 1 ? 1 : nthreads;
    if (nt == 1 || n < (1 << 16)) {
        std::sort(idx, idx + n, cmp);
        return 0;
    }
    // largest power of two <= nt: -t is the user's oversubscription bound,
    // so never launch MORE sort threads than asked (the merge rounds use
    // progressively fewer)
    int64_t chunks = 1;
    while (chunks * 2 <= nt) chunks <<= 1;
    std::vector<int64_t> bounds(chunks + 1);
    for (int64_t c = 0; c <= chunks; ++c) bounds[c] = n * c / chunks;
    {
        std::vector<std::thread> ts;
        for (int64_t c = 0; c < chunks; ++c)
            ts.emplace_back([&, c] {
                std::sort(idx + bounds[c], idx + bounds[c + 1], cmp);
            });
        for (auto& t : ts) t.join();
    }
    for (int64_t span = 1; span < chunks; span <<= 1) {
        std::vector<std::thread> ts;
        for (int64_t c = 0; c + span < chunks; c += 2 * span) {
            const int64_t hi = std::min(c + 2 * span, chunks);
            ts.emplace_back([&, c, hi] {
                std::inplace_merge(idx + bounds[c], idx + bounds[c + span],
                                   idx + bounds[hi], cmp);
            });
        }
        for (auto& t : ts) t.join();
    }
    return 0;
}

}  // extern "C"
