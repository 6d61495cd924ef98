// Kernel 2: the fused-row probe, one thread per query lane.
//
// Replaces sshash_tpu/engine.py mphf_eval_minimizer (:663), _pilot_read
// (:531), skew_slot (:687, both branches), skew_eval (:713, the legacy
// heavy path) and lookup_with_info (:739) with its verify_fused (:812, v1
// and v2 rows) and pair_window (:982) sweep; ops/u64.py splitmix64,
// fmix32, mulhi32, hash64_words; ops/packed.py extract_window_dyn,
// extract_kmer_dyn, kmer_equal, kmer_less. Plain version:
// sshash_tpu_torch/engine.py probe_plain.
//
// Per lane: minimizer -> raw MPHF slot (one pilot read, one seed-row read
// when partitioned) -> one cw_row read carrying the candidate-0 block (and
// candidate 1 when c1_in_row) -> minimizer guard -> candidate tries; heavy
// lanes hash the canonical kmer into their skew class (a partitioned or a
// plain class MPHF) and read one sk_hrows block, or on a pre-v1.2 index
// (no hindex) its position in the bucket from sk_positions and then the
// heavy_rows block at the bucket's begin plus that position; mid buckets
// past the row's candidates loop over mid_rows in the lane itself (the TPU
// compacted them into pair windows).
//
// Row formats: v1 blocks resolve a match to a char offset and its string
// (sid0, ep0, ep1, ep2); v2 ("rebased") blocks carry the in-window offset
// and (kid0, sid0, rel_ep1), so a match resolves straight to its kmer id
// and no char offset is read or formed (indexes of >= 2^32 chars). v2
// serves the id fields only.
//
// Bound: dependent random reads of device memory, three to four rounds per
// lane (pilot, row, then heavy or mid rows for a few lanes; the legacy
// heavy path one round more), each a row of 11..34 words at k <= 63 and up
// to 52 at k = 255; the arithmetic is a few 64-bit multiplies. The design
// reads each row in place through L1 and keeps every intermediate in
// registers; nothing but the result fields is written. Kmers of 1..8 words
// are templates whose word arrays (the kmer, its RC, the candidate read)
// stay in registers; 9..16 words (k <= 255) run the wide form of
// packed.cuh, whose arrays may spill to local memory.
//
// Every table read clamps its index as jnp.take(..., mode="clip") does
// after the JAX package's int32 cast, so a lane reads exactly the entries
// the JAX program reads, for absent and inactive lanes too.
//
// Bucket shards (sshash_tpu/parallel/sharded.py _branchfree_lookup, the
// owner masks of engine.py:778-784 and :904-911): a shard holds the rows of
// MPHF slots [slot_lo, slot_hi), its own mid and legacy heavy rows (cw_a
// local), and in hindex indexes the sk_hrows rows [hrow_lo, hrow_hi). A
// lane whose slot is not the shard's is inactive there. Only the slot's
// owner knows a heavy lane's global sk_hrows row, so an hindex probe splits
// there: with hrow_out the heavy lanes write that row (0xFFFFFFFF
// elsewhere) and verify nothing; the caller takes the unsigned min over the
// shards; with hrow_in each shard verifies the rows it holds and reads no
// minimizer table. An unsharded call passes the whole slot range.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"
#include "tables.cuh"
#include "u64.cuh"

namespace sshash {

constexpr uint32_t kInvalid32 = 0xFFFFFFFFu;
constexpr int32_t kForward = 1;
constexpr int32_t kBackward = -1;
constexpr int kMaxTries = 4;
// sk_params rows (sshash_tpu_torch/layout.py SKEW_PARAMS), 8 classes each
enum SkewParam { kTable, kNBuckets, kSeedmixHi, kSeedmixLo, kPilotOff, kPosOff, kNp2, kSeedOff };

// Layouts mirrored by ctypes Structures in sshash_tpu_torch/kernels.py:
// every field is 8 bytes, so neither side pads.
struct ProbeTables {
  const uint32_t* cw_row;
  int64_t cw_rows;
  const uint32_t* mid_rows;
  int64_t mid_n;
  const uint32_t* sk_hrows;
  int64_t sk_hrows_n;
  const uint32_t* pilots;
  int64_t pilots_n;
  const uint32_t* mphf_seedrows;
  int64_t mphf_seedrows_n;
  const uint32_t* sk_pilots;
  int64_t sk_pilots_n;
  const uint32_t* sk_seedrows;
  int64_t sk_seedrows_n;
  const uint32_t* heavy_rows;  // legacy heavy path (skew_hrows == 0)
  int64_t heavy_rows_n;
  const uint32_t* sk_positions;
  int64_t sk_positions_n;
  const uint32_t* sk_params;  // (8 params, 8 classes)
};

struct ProbeParams {
  int64_t B, W, k, m, canonical, full;
  int64_t win_words, vbits_words, max_start_word, row_w, blk_w;
  int64_t c1_in_row, has_skew, row_v2, skew_hrows, skew_partitioned;
  int64_t mphf_partitioned, mphf_P, mphf_part_table, mphf_part_buckets;
  int64_t mphf_nbuckets, mphf_table, pilot_w, sk_pilot_w;
  int64_t slot_lo, slot_hi, hrow_lo, hrow_hi;  // this shard's slots and sk_hrows rows
  uint64_t mphf_seedmix;
};

struct ProbeIO {
  const uint32_t* kmers;     // (B, W)
  const uint32_t* kmers_rc;  // (B, W), canonical only
  const uint64_t* minval;    // (B,)
  const int32_t* minpos;     // (B,)
  const int32_t* minpos2;    // (B,) or null: the tie fold's extra tries
  const uint8_t* active;     // (B,) or null: every lane
  uint32_t* kmer_id;
  int32_t* kmer_orientation;
  uint8_t* minimizer_found;
  uint8_t* found;
  uint32_t* kmer_id_in_string;  // full fields, null in ids mode
  uint32_t* kmer_offset;
  uint32_t* string_id;
  uint32_t* string_begin;
  uint32_t* string_end;
  uint32_t* hrow_out;       // (B,) or null: hand the heavy lanes' rows on
  const uint32_t* hrow_in;  // (B,) or null: verify the handed rows held here
};

// engine._pilot_read: field `bucket` of a table packed at width w (4..32)
__device__ __forceinline__ uint32_t pilot_read(int w, const uint32_t* words, int64_t n,
                                               uint32_t bucket, uint32_t word_off) {
  if (w == 32) return words[clip_row(word_off + bucket, n)];
  const uint32_t ppw = 32u / w;
  const uint32_t shift = 31 - __clz(ppw);
  const uint32_t word = words[clip_row(word_off + (bucket >> shift), n)];
  return (word >> ((bucket & (ppw - 1)) * w)) & ((1u << w) - 1);
}

__device__ __forceinline__ uint32_t skp(const ProbeTables& t, int p, uint32_t cls) {
  return t.sk_params[p * 8 + clip_row(cls, 8)];
}

// engine.mphf_eval_minimizer: minimizer -> raw slot in [0, table_size)
__device__ __forceinline__ uint32_t mphf_slot(const ProbeTables& t, const ProbeParams& p,
                                              uint64_t minval) {
  const uint64_t mh = splitmix64(minval ^ p.mphf_seedmix);
  if (p.mphf_partitioned) {
    const uint32_t pid = mulhi32(hi32(mh), (uint32_t)p.mphf_P);
    const uint32_t* row = t.mphf_seedrows + 2 * clip_row(pid, t.mphf_seedrows_n);
    const uint64_t h2 = splitmix64(mh ^ (((uint64_t)row[0] << 32) | row[1]));
    const uint32_t nb = (uint32_t)p.mphf_part_buckets, T = (uint32_t)p.mphf_part_table;
    const uint32_t bucket = pid * nb + mulhi32(hi32(h2), nb);
    const uint32_t pilot = pilot_read((int)p.pilot_w, t.pilots, t.pilots_n, bucket, 0);
    return pid * T + mulhi32(fmix32(lo32(h2) ^ fmix32(pilot)), T);
  }
  const uint32_t bucket = mulhi32(hi32(mh), (uint32_t)p.mphf_nbuckets);
  const uint32_t pilot = pilot_read((int)p.pilot_w, t.pilots, t.pilots_n, bucket, 0);
  return mulhi32(fmix32(lo32(mh) ^ fmix32(pilot)), (uint32_t)p.mphf_table);
}

// engine.skew_slot: the kmer's slot in its size class's MPHF, partitioned
// (v1.2+ builds) or plain (older ones)
template <int W>
__device__ __forceinline__ uint32_t skew_slot(const ProbeTables& t, const ProbeParams& p,
                                              const uint32_t (&canon)[W], uint32_t cls) {
  const uint64_t seedmix = ((uint64_t)skp(t, kSeedmixHi, cls) << 32) | skp(t, kSeedmixLo, cls);
  const uint64_t h = hash64_words(canon, used_words<W>(p.W), seedmix);
  const uint32_t nb = skp(t, kNBuckets, cls), table = skp(t, kTable, cls);
  if (!p.skew_partitioned) {
    const uint32_t bucket = mulhi32(hi32(h), nb);
    const uint32_t pilot = pilot_read((int)p.sk_pilot_w, t.sk_pilots, t.sk_pilots_n, bucket,
                                      skp(t, kPilotOff, cls));
    return mulhi32(fmix32(lo32(h) ^ fmix32(pilot)), table);
  }
  const uint32_t pid2 = mulhi32(hi32(h), skp(t, kNp2, cls));
  const uint32_t* row =
      t.sk_seedrows + 2 * clip_row(skp(t, kSeedOff, cls) + pid2, t.sk_seedrows_n);
  const uint64_t h2 = splitmix64(h ^ (((uint64_t)row[0] << 32) | row[1]));
  const uint32_t bucket = pid2 * nb + mulhi32(hi32(h2), nb);
  const uint32_t pilot = pilot_read((int)p.sk_pilot_w, t.sk_pilots, t.sk_pilots_n, bucket,
                                    skp(t, kPilotOff, cls));
  return pid2 * table + mulhi32(fmix32(lo32(h2) ^ fmix32(pilot)), table);
}

struct Hit {
  bool match;
  uint32_t off;  // matching char offset (v1 rows) or the kmer id (v2 rows)
  int32_t orient;
  uint32_t sid, begin, end;  // v1 rows only
};

// In-window char offset of a block's candidate: v2 rows store it, v1 rows
// store the candidate's char offset (the window starts at word
// max(0, cand-(k-m)) >> 4).
template <bool V2>
__device__ __forceinline__ uint32_t ext_off(uint32_t col0, uint32_t kmw) {
  return V2 ? col0 : col0 - (((col0 - min(col0, kmw)) >> 4) << 4);
}

// engine.lookup_with_info.verify_fused: verify and resolve one candidate
// block [col0, vbits (Wv), window (Ww), quad] at each position try, in
// order; the first hit wins. v1 quad (sid0, ep0, ep1, ep2); v2 quad (kid0,
// sid0, rel_ep1): the id is kid0 - pos - over*(k-1), over = (k-m-pos) >=
// rel_ep1.
template <int W, bool CANON, bool V2>
__device__ __forceinline__ Hit verify_block(const uint32_t* blk, const ProbeParams& p,
                                            const uint32_t (&km)[W], const uint32_t (&kr)[W],
                                            const uint32_t (&tries)[kMaxTries], int ntries) {
  Hit h{false, 0, kForward, 0, 0, 0};
  const int Wv = (int)p.vbits_words, Ww = (int)p.win_words;
  const uint32_t kmw = (uint32_t)(p.k - p.m);
  const uint32_t cand = blk[0];
  const uint32_t* vbw = blk + 1;
  const uint32_t* win = blk + 1 + Wv;
  const uint32_t* rsv = blk + 1 + Wv + Ww;
  const uint32_t ext0 = ext_off<V2>(cand, kmw);
  for (int t = 0; t < ntries; ++t) {
    const uint32_t pos = tries[t];
    if (ext0 < pos) continue;
    const uint32_t j = kmw - pos;
    uint32_t vword = 0;
    for (int w = 0; w < Wv; ++w)
      if ((j >> 5) == (uint32_t)w) vword = vbw[w];
    if (!((vword >> (j & 31u)) & 1u)) continue;
    uint32_t read[W];
    extract_kmer_dyn(win, Ww, (ext0 - pos) * 2u, (int)p.k, (int)p.max_start_word,
                     used_words<W>(p.W), read);
    const bool eq_f = kmer_equal(read, km);
    const bool eq_r = CANON && kmer_equal(read, kr);
    if (!(eq_f || eq_r)) continue;
    h.match = true;
    h.orient = (eq_r && !eq_f) ? kBackward : kForward;
    if (V2) {
      h.off = rsv[0] - pos - (j >= rsv[2] ? (uint32_t)(p.k - 1) : 0u);
      break;
    }
    const uint32_t off = cand - pos;
    const uint32_t ep1 = rsv[2];
    const bool over = off >= ep1;  // at most one string boundary in the span
    h.off = off;
    h.sid = rsv[0] + (over ? 1u : 0u);
    h.begin = over ? ep1 : rsv[1];
    h.end = over ? rsv[3] : ep1;
    break;
  }
  return h;
}

// V2: rebased rows (ids only); v1 rows write the string fields too when
// p.full (a uniform branch at the end, so the two field forms share one
// instantiation and the build stays short)
template <int W, bool CANON, bool V2>
__global__ void probe_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  const bool FULL = !V2 && p.full;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  bool found = false, mfound = true;
  uint32_t hrow = kInvalid32;
  Hit res{false, 0, kForward, 0, 0, 0};
  if (!io.active || io.active[i]) {
    const int nw = used_words<W>(p.W);
    uint32_t km[W], kr[W];
    load_kmer(io.kmers, i, nw, km);
#pragma unroll
    for (int w = 0; w < W; ++w) kr[w] = 0u;
    if (CANON) load_kmer(io.kmers_rc, i, nw, kr);
    const uint64_t minval = io.minval[i];
    const uint32_t kmw = (uint32_t)(p.k - p.m);
    uint32_t tries[kMaxTries];
    int ntries = 1;
    tries[0] = (uint32_t)io.minpos[i];
    if (CANON) {
      tries[1] = kmw - tries[0];
      ntries = 2;
      if (io.minpos2) {
        tries[2] = (uint32_t)io.minpos2[i];
        tries[3] = kmw - tries[2];
        ntries = 4;
      }
    }
    if (io.hrow_in) {
      // the hand-off's second pass: the heavy rows this shard holds
      const uint32_t r = io.hrow_in[i];
      if (r >= p.hrow_lo && r < p.hrow_hi) {
        const uint32_t* blk =
            t.sk_hrows + clip_row(r - (uint32_t)p.hrow_lo, t.sk_hrows_n) * p.blk_w;
        res = verify_block<W, CANON, V2>(blk, p, km, kr, tries, ntries);
        found = res.match;
      }
    } else {
      const uint32_t slot = mphf_slot(t, p, minval);
      if (slot >= p.slot_lo && slot < p.slot_hi) {
        const uint32_t* row = t.cw_row + clip_row(slot - (uint32_t)p.slot_lo, t.cw_rows) * p.row_w;
        const uint32_t sb = row[0], cw_a = row[1];
        const uint32_t status = sb & 3u, cw_b = sb >> 2;
        const bool heavy = status == 2, midload = status == 1;
        const uint32_t size = midload ? cw_b : 1u;
        const uint32_t* c0 = row + 2;

        // minimizer guard on the candidate-0 window (spss:47-65)
        const int Wv = (int)p.vbits_words, Ww = (int)p.win_words;
        const uint32_t cand0 = c0[0];
        const uint32_t gext0 = ext_off<V2>(cand0, kmw);
        const uint64_t gv = extract_window_dyn(c0 + 1 + Wv, Ww, gext0 * 2u, (int)(2 * p.m),
                                               (int)p.max_start_word);
        bool guard_ok = gv == minval;
        if (CANON) guard_ok |= gv == revcomp_mmer64(minval, (int)p.m);

        if (!heavy) {
          res = verify_block<W, CANON, V2>(c0, p, km, kr, tries, ntries);
          found = res.match;
        } else if (p.has_skew) {
          uint32_t canon[W];
          const bool use_rc = CANON && kmer_less(kr, km);
#pragma unroll
          for (int w = 0; w < W; ++w) canon[w] = use_rc ? kr[w] : km[w];
          const uint32_t hidx = skp(t, kPosOff, cw_b) + skew_slot(t, p, canon, cw_b);
          if (io.hrow_out) {
            hrow = hidx;  // verified by the shard holding that row
          } else {
            const uint32_t* blk;
            if (p.skew_hrows) {
              blk = t.sk_hrows + clip_row(hidx, t.sk_hrows_n) * p.blk_w;
            } else {
              // engine.skew_eval: slot -> position in the bucket -> heavy row
              const uint32_t pos = t.sk_positions[clip_row(hidx, t.sk_positions_n)];
              blk = t.heavy_rows + clip_row(cw_a + pos, t.heavy_rows_n) * p.blk_w;
            }
            res = verify_block<W, CANON, V2>(blk, p, km, kr, tries, ntries);
            found = res.match;
          }
        }
        mfound = guard_ok || heavy;
        // a failed guard proves the bucket belongs to another minimizer: no
        // further candidate can match
        if (mfound && midload && !found) {
          if (p.c1_in_row && size >= 2) {
            res = verify_block<W, CANON, V2>(c0 + p.blk_w, p, km, kr, tries, ntries);
            found = res.match;
          }
          for (uint32_t j = p.c1_in_row ? 2u : 1u; !found && j < size; ++j) {
            const uint32_t* mrow = t.mid_rows + clip_row(cw_a + j, t.mid_n) * p.blk_w;
            res = verify_block<W, CANON, V2>(mrow, p, km, kr, tries, ntries);
            found = res.match;
          }
        }
      }
    }
  }
  const uint32_t off = found ? res.off : 0u;
  io.kmer_id[i] = !found ? kInvalid32 : V2 ? off : off - res.sid * (uint32_t)(p.k - 1);
  io.kmer_orientation[i] = found ? res.orient : kForward;
  io.minimizer_found[i] = mfound;
  io.found[i] = found;
  if (FULL) {
    io.kmer_offset[i] = found ? off : kInvalid32;
    io.string_id[i] = found ? res.sid : kInvalid32;
    io.string_begin[i] = found ? res.begin : kInvalid32;
    io.string_end[i] = found ? res.end : kInvalid32;
    io.kmer_id_in_string[i] = found ? off - res.begin : kInvalid32;
  }
  if (io.hrow_out) io.hrow_out[i] = hrow;
}

template <int W, bool CANON>
cudaError_t launch_probe(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                         cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
  if (p.row_v2)
    probe_kernel<W, CANON, true><<<blocks, threads, 0, stream>>>(t, p, io);
  else
    probe_kernel<W, CANON, false><<<blocks, threads, 0, stream>>>(t, p, io);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes. Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_probe(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                            const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  if (p->B <= 0) return (int)cudaGetLastError();
  if (p->k > kMaxK || p->m < 1 || p->m > 31 || p->W != (2 * p->k + 31) / 32 ||
      (p->canonical && !io->kmers_rc) || (p->full && !io->kmer_offset) ||
      (p->full && p->row_v2) ||
      p->blk_w != 1 + p->vbits_words + p->win_words + (p->row_v2 ? 3 : 4) ||
      p->row_w != 2 + (p->c1_in_row ? 2 : 1) * p->blk_w ||
      (p->has_skew && (p->skew_hrows ? !t->sk_hrows : !t->heavy_rows || !t->sk_positions)) ||
      (p->has_skew && p->skew_partitioned && !t->sk_seedrows) ||
      ((io->hrow_out || io->hrow_in) && !(p->has_skew && p->skew_hrows)) ||
      (io->hrow_out && io->hrow_in) || p->slot_lo < 0 || p->slot_hi > (1ll << 32) ||
      p->hrow_lo < 0 || p->hrow_hi > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const bool c = p->canonical != 0;
  return (int)dispatch_width(p->W, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return c ? launch_probe<W, true>(*t, *p, *io, s) : launch_probe<W, false>(*t, *p, *io, s);
  });
}

