#!/usr/bin/env python3
"""Time an earlier tree's stream step against this tree's, and this tree's
stream kernels against their losing designs, in turns on one card
(chip_smoke.py's timing: CUDA events around windows of calls, median of 7,
sides run backwards then forwards; every side's calls replay from a CUDA
graph, as they take microseconds).

    python3 stream_ab.py --baseline DIR [--strings 1000]
                         [--chunks high-hit,low-hit,mixed,k65-mixed] [--stages]

DIR is an unpacked earlier tree (`git archive <commit> | tar -x -C DIR`),
for instance under .chip_scratch/ (gitignored). Sides:

  tree         this tree's kernel library (kernels.build)
  baseline     DIR's own package, loaded under another name, with its own
               kernel library built from its csrc: its step, and its
               misses' kernels where it has them in rank space (a DIR
               before that ran kernel 1 over all P lanes and kernel 2
               twice, given kernel 1's outputs)
  walk         this tree with the rank-space lookup walking its active
               ranks' windows again (kernel 1's, minimizer.cuh) at every
               k (lookup_ranks.cu patched; the tree walks at most 24
               windows and reads kernel 1's rank-form minimizers past that)
  read         the same, reading kernel 1's minimizers at every k
  (the rank-space lookup's designs; the tree's: each warp queueing its
  active ranks in shared memory from one 32-rank group to the next and
  looking them up 32 at a time, 3 blocks an SM; lookup_ranks.cu patched,
  its kernel and launch)
  tiles        a block's tile of 4 x 256 ranks (fewer where the count spread
               over the grid leaves fewer), its active ones compacted in
               shared memory with one block-wide prefix, then a thread an
               entry, nothing carried from tile to tile; the lookup kernel's
               launch bounds but 3 blocks an SM at the widths where the
               tile's state spilled at 4
  tiles4       the tiles at the lookup kernel's launch bounds at every width
  warptile     a warp's tile of 4 x 32 ranks, its active ones compacted by a
               ballot into the warp's part of shared memory and looked up a
               lane an entry, no block barrier and nothing carried from tile
               to tile
  lists        two launches: a list pass (the tiles' compaction, one
               atomicAdd a tile on a device count) writing the active ranks
               to a list, then a thread an entry of the list
  queued4      the tree's queue at the lookup kernel's launch bounds (4
               blocks an SM where it asks them)
  strided      a thread a rank over a grid-stride loop, the active ranks
               looked up where they fall
  k1_grid_p    this tree with kernel 1's rank form on a grid of P lanes
               whose threads past the count exit (minimizer.cu patched;
               the tree's grid fits the card and strides up to the count)
  fill_memset, rank_stores, scan_vecs2, round2_vecs4, count16
               the losing designs of scan.cu and stream_derive.cu (PR 9):
               the compaction's zero fill as a memset; each lane storing
               its own vector's ranks; 2 vectors a thread in the scans; 4
               in round 2; the count at 16 lanes a thread
  kmers_grid_p this tree with the misses' kmer read on a grid of P lanes
               whose blocks past the count exit (stream_anchor.cu
               patched; the tree's grid fits the card and strides up to
               the count)
  row_stores   this tree with every kmer row stored a thread a row, word
               by word, W words at a stride of 4W bytes (packed.cuh's
               store_rows patched; the tree stores rows of 1, 2, 4 and 8
               words as vectors and stages the other widths in shared
               memory, a warp's rows written as 16-byte vectors)
  warp_search  this tree with the anchor stage's search in two levels: a
               warp finds the reads before its first lane by a 32-ary
               search, a probe a lane and a ballot, then each thread
               searches its warp's run (stream_anchor.cu patched; in the
               tree each thread searches all of pstart[:nreads],
               log2(nreads) + 1 dependent steps from L2)
  masks_atomic (the anchor stage only, where DIR predates the one-launch
               anchor stage) DIR's masks kernel (a zero fill, atomicOr a
               read, then a group popcount launch), the tree's scan of the
               group counts and the tree's kmer read at the anchors' lanes

A variant is built from its patched sources alone (nvcc for sm_90a into
build/stream_ab/) and serves their entries; every other entry runs from
this tree's library. Chunks, each the first 2^22-position chunk of:
  high-hit  a 168-string genome against phase 7's 100M k31 m21 canonical
            build (--strings strings of 100,030 chars; few misses)
  low-hit   phase 10's low-hit reads (100,000 of 76 chars, 10 cut from
            the index, 1% with an N) on phase 4's 5M k31 m17 regular build
            (the run-skip on, misses near P)
  mixed     phase 10's mixed reads (2^16 of 150 chars, half cut with RC and
            1% substitutions, half random) on phase 4's 5M canonical build
  k65-mixed phase 13's mixed reads (2^12 of 150) on a k65 m25 canonical
            build of 5M kmers (phase 13 streams them over 60M: cut to 5M
            for the run's time)
On each chunk every side's step equals the tree's and its stages' outputs
equal the tree's (the baseline's in the stages both trees have), checked
before timing; then, in turns, the whole step, the misses' kernels (kernel
1's rank form and both rounds of the rank-space lookup) of the sides that
have them, the scan.cu and stream_derive.cu calls, the anchor stage (the
tree's one launch; the baseline's masks, scan of the group counts and
anchors' read; masks_atomic) and the misses' kmer read, and with
--stages each stage. Beside the high-hit chunk: the engine's lookup of 2^24 positives
(ids) at 100M, tree against DIR; beside the k65 chunk, that of 2^23
positives on its 5M index; beside the low-hit chunk: the
bucket-sharded stream's step, (1, 4) LocalMesh, tree against DIR. Prints
the card, each side's registers and spills (ptxas) and the ms of each
side.
"""

import argparse
import contextlib
import ctypes
import functools
import importlib
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
import threading
import types
from pathlib import Path

import chip_smoke as S  # its import finder keeps JAX out; its build and timing helpers
import numpy as np
import torch

from sshash_tpu_torch import kernels, synthetic
from sshash_tpu_torch import engine as E
from sshash_tpu_torch import streaming as ST
from sshash_tpu_torch.parallel import LocalMesh, ShardedEngine, ShardedStream

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "sshash_tpu_torch" / "csrc"
OUT = ROOT / "build" / "stream_ab"
# the stages compared and timed by source, and the C entries each source serves
SOURCE_OF = {"scan": "scan.cu", "compact": "scan.cu", "heads": "stream_derive.cu",
             "round2": "stream_derive.cu", "merge": "stream_derive.cu",
             "count": "stream_derive.cu", "minimizer_ranks": "misses",
             "lookup_ranks": "misses", "anchors": "stream_anchor.cu",
             "kmers": "stream_anchor.cu"}
ENTRIES = {"scan.cu": ("sshash_scan", "sshash_scan_scratch", "sshash_compact"),
           "stream_derive.cu": ("sshash_stream_heads", "sshash_stream_round2",
                                "sshash_round2_scratch", "sshash_stream_merge",
                                "sshash_stream_count"),
           "minimizer.cu": ("sshash_minimizer", "sshash_minimizer_ranks"),
           "lookup_ranks.cu": ("sshash_lookup_ranks",),
           "stream_anchor.cu": ("sshash_stream_anchors", "sshash_stream_kmers")}
# the anchor stage and the misses' kmer read, as (stage, its k-th call) of
# the tree's step and of the baseline's (masks, the group scan, the anchors'
# read; the misses' read its second kmer read)
ANCHOR_CALLS = {"tree": [("anchors", 0)], "baseline": [("masks", 0), ("scan", 1), ("kmers", 0)]}
MISS_CALLS = {"tree": [("kmers", 0)], "baseline": [("kmers", 1)]}
# a stage's calls back to back in one graph when timed alone: one call
# replayed alone costs about as much in graph launch as on the card
STAGE_CALLS = 10
MIXED_K65_STRINGS = 50


# the compaction's first design: each lane stores the ranks of its own
# vector's flags (a warp's store instruction touches 32 lines)
RANK_STORES = r'''        uint32_t rank = ex[i];
        const uint32_t w[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          for (uint32_t m = nonzero_bytes(w[q]); m; m &= m - 1)
            out[rank++] = (int32_t)(e0 + 4 * q + (__ffs(m) >> 3) - 1);
        }
'''
# the rank-space lookup's cut between walking an active rank's windows and
# reading kernel 1's minimizers, and the widest kernel that walks
WALK_CUT = "constexpr int kWalkWindows = 24;"
WALK_W = "constexpr int kWalkMaxW = 4;"
# the rank-space lookup's kernel and its launch, which the designs that
# lost replace
RANKS_KERNEL = re.compile(r"// 3 blocks of 256 threads an SM \(80 registers a thread\).*?"
                          r"(?=}  // namespace sshash)", re.S)
QUEUE_BOUNDS = ("__launch_bounds__(256, W > kMaxFixedW ? 1 : !CANON && W >= 6 ? 2 : 3)\n"
                "    lookup_ranks_kernel")
RANKS_LAUNCH = """template <int W, bool CANON, bool WALK>
static cudaError_t launch_ranks(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                                PerDevice& per_sm, cudaStream_t stream) {
  const int threads = 256 * stage_stride(2 + (int)p.blk_w) * 4 + SIDE_SMEM(256) <= 48 * 1024
                          ? 256 : 128;
  const size_t smem = (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4 + SIDE_SMEM(threads);
  int64_t blocks = 0;
  const cudaError_t err =
      pass_blocks(lookup_ranks_kernel<W, CANON, WALK>, threads, per_sm, p.B, &blocks, smem);
  if (err != cudaSuccess) return err;
  lookup_ranks_kernel<W, CANON, WALK><<<(unsigned)blocks, threads, smem, stream>>>(t, p, io);
  return cudaGetLastError();
}

"""
# ... a block's tile of ranks, compacted with one block-wide prefix
TILE_RANKS = """constexpr int kTileRanks = 4;  // ranks a thread takes a tile

// Blocks of 256 threads an SM that the launch bounds ask registers for:
// the lookup kernel's (lookup_min_blocks), but 3 at the widths where the
// tile's state beside the lookup spilled at 4 (regular 2-3 words,
// canonical 4-5).
__host__ __device__ constexpr int ranks_min_blocks(int W, bool canon) {
  return W > kMaxFixedW ? 1
         : (canon ? W == 4 || W == 5 : W == 2 || W == 3) ? 3
                                                          : lookup_min_blocks(W, canon);
}

// Tile tb: the span ranks from tb x span on, each warp's 32 at a time
// contiguous. span is kTileRanks x blockDim, or less where the count spread
// over the grid leaves less (a multiple of 32), so that a small count
// reaches as many blocks as it can fill. Across the lookups only the
// tile's number, the entry's index and the tile's length stay live: the
// count is read again for the next tile and the list holds the ranks
// themselves.
template <int W, bool CANON, bool WALK>
__global__ void __launch_bounds__(256, ranks_min_blocks(W, CANON))
    lookup_ranks_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  __shared__ int warp_n[256 / 32];
  const int64_t per_block = (misses(io.count, p.B) + gridDim.x - 1) / gridDim.x;
  const int span = per_block < kTileRanks * (int64_t)blockDim.x
                       ? (int)((per_block + 31) & ~31ll)
                       : kTileRanks * (int)blockDim.x;
  for (uint32_t tb = blockIdx.x; (int64_t)tb * span < misses(io.count, p.B); tb += gridDim.x) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int64_t n = misses(io.count, p.B), t0 = (int64_t)tb * span;
    uint32_t* tile = stage + blockDim.x * stage_stride(2 + (int)p.blk_w);
    unsigned on[kTileRanks];
    int mine = 0;  // the warp's active ranks in the tile
#pragma unroll
    for (int g = 0; g < kTileRanks; ++g) {
      const int q = (g * nwarps + warp) * 32;  // the group's first rank in the tile
      const int64_t i = t0 + q + lane;
      const bool in = q < span && i < n, act = in && io.active[i];
      if (in && !act) write_not_found(io, i);
      on[g] = __ballot_sync(0xFFFFFFFFu, act);
      mine += __popc(on[g]);
    }
    if (lane == 0) warp_n[warp] = mine;
    __syncthreads();
    int at = 0, total = 0;  // the warp's first place in the tile's list; its length
    for (int w = 0; w < nwarps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
#pragma unroll
    for (int g = 0; g < kTileRanks; ++g) {
      if ((on[g] >> lane) & 1u)
        tile[at + __popc(on[g] & ((1u << lane) - 1u))] =
            (uint32_t)(t0 + (g * nwarps + warp) * 32 + lane);
      at += __popc(on[g]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < total; e += blockDim.x)
      lookup_rank<W, CANON, WALK>(t, p, io, thread_slot(stage, p),
                                  stage[blockDim.x * stage_stride(2 + (int)p.blk_w) + e]);
    __syncthreads();  // warp_n and the tile are refilled next
  }
}

// Shared memory of a block: the lookup kernel's staging slots and the
// tile's list.
inline size_t ranks_smem(const ProbeParams& p, int threads) {
  return (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4 +
         (size_t)threads * kTileRanks * 4;
}

// Threads a block: 256 while the block's shared memory fits the 48 KB a
// launch takes without an attribute, else 128 (the widest row heads).
inline int ranks_threads(const ProbeParams& p) {
  return ranks_smem(p, 256) <= 48 * 1024 ? 256 : 128;
}

// A grid sized to the card, or fewer blocks where P's tiles (p.B, the
// most ranks the count can reach) need fewer. static: the occupancy cache
// passed in stays this library's
template <int W, bool CANON, bool WALK>
static cudaError_t launch_ranks(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                                PerDevice& per_sm, cudaStream_t stream) {
  const int threads = ranks_threads(p);
  const size_t smem = ranks_smem(p, threads);
  int64_t blocks = 0;
  const cudaError_t err = pass_blocks(lookup_ranks_kernel<W, CANON, WALK>, threads, per_sm,
                                      (p.B + kTileRanks - 1) / kTileRanks, &blocks, smem);
  if (err != cudaSuccess) return err;
  lookup_ranks_kernel<W, CANON, WALK><<<(unsigned)blocks, threads, smem, stream>>>(t, p, io);
  return cudaGetLastError();
}

"""
# ... the widths the tiles' launch bounds give 3 blocks an SM, not the
# lookup kernel's
RANKS_SPILLED = "(canon ? W == 4 || W == 5 : W == 2 || W == 3) ? 3"
# ... a warp's tile, no block barrier
WARP_TILE_RANKS = """constexpr int kTileRanks = 4;
#define SIDE_SMEM(threads) ((size_t)(threads) * kTileRanks * 4)
template <int W, bool CANON, bool WALK>
__global__ void __launch_bounds__(256, lookup_min_blocks(W, CANON))
    lookup_ranks_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* tile = stage + blockDim.x * stage_stride(2 + (int)p.blk_w) + warp * 32 * kTileRanks;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t w0 = ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp) * 32 * kTileRanks;
       w0 < misses(io.count, p.B); w0 += warps * 32 * kTileRanks) {
    const int64_t n = misses(io.count, p.B);
    int total = 0;
#pragma unroll
    for (int g = 0; g < kTileRanks; ++g) {
      const int64_t i = w0 + 32 * g + lane;
      const bool in = i < n, act = in && io.active[i];
      if (in && !act) write_not_found(io, i);
      const unsigned m = __ballot_sync(0xFFFFFFFFu, act);
      if (act) tile[total + __popc(m & ((1u << lane) - 1u))] = (uint32_t)i;
      total += __popc(m);
    }
    __syncwarp();
    for (int e = lane; e < total; e += 32)
      lookup_rank<W, CANON, WALK>(t, p, io, thread_slot(stage, p), tile[e]);
    __syncwarp();
  }
}

""" + RANKS_LAUNCH
# ... a thread a rank, the active ranks looked up where they fall
STRIDED_RANKS = """#define SIDE_SMEM(threads) ((size_t)0)
template <int W, bool CANON, bool WALK>
__global__ void __launch_bounds__(256, lookup_min_blocks(W, CANON))
    lookup_ranks_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int64_t n = misses(io.count, p.B);
  uint32_t* slot = thread_slot(stage, p);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (io.active[i])
      lookup_rank<W, CANON, WALK>(t, p, io, slot, i);
    else
      write_not_found(io, i);
  }
}

""" + RANKS_LAUNCH
# ... a list pass into a device list and count, then a lookup launch over it
# (its list and count allocated at a first call, before any capture)
LISTED_RANKS = """// the active ranks' list: tiles of 4 x 256 ranks compacted as the tree's
// kernel compacts them, each tile's place taken with one atomicAdd
__global__ void __launch_bounds__(256)
    rank_list_side(ProbeParams p, ProbeIO io, uint32_t* list, int32_t* cnt) {
  __shared__ int warp_n[8], tile_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int64_t n = misses(io.count, p.B), span = 4 * (int64_t)blockDim.x;
  for (int64_t t0 = (int64_t)blockIdx.x * span; t0 < n; t0 += (int64_t)gridDim.x * span) {
    unsigned on[4];
    int mine = 0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int64_t i = t0 + (int64_t)(g * nwarps + warp) * 32 + lane;
      const bool in = i < n, act = in && io.active[i];
      if (in && !act) write_not_found(io, i);
      on[g] = __ballot_sync(0xFFFFFFFFu, act);
      mine += __popc(on[g]);
    }
    if (lane == 0) warp_n[warp] = mine;
    __syncthreads();
    int at = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (threadIdx.x == 0) tile_at = total ? atomicAdd(cnt, total) : 0;
    __syncthreads();
    at += tile_at;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if ((on[g] >> lane) & 1u)
        list[at + __popc(on[g] & ((1u << lane) - 1u))] =
            (uint32_t)(t0 + (int64_t)(g * nwarps + warp) * 32 + lane);
      at += __popc(on[g]);
    }
    __syncthreads();
  }
}

template <int W, bool CANON, bool WALK>
__global__ void __launch_bounds__(256, lookup_min_blocks(W, CANON))
    lookup_ranks_kernel(ProbeTables t, ProbeParams p, ProbeIO io, const uint32_t* list,
                        const int32_t* cnt) {
  extern __shared__ uint32_t stage[];
  const int64_t n = misses(cnt, p.B);
  uint32_t* slot = thread_slot(stage, p);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x)
    lookup_rank<W, CANON, WALK>(t, p, io, slot, list[e]);
}

template <int W, bool CANON, bool WALK>
static cudaError_t launch_ranks(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                                PerDevice& per_sm, cudaStream_t stream) {
  static uint32_t* list = nullptr;
  static int32_t* cnt = nullptr;
  static int64_t cap = 0;
  static PerDevice list_sm;
  cudaError_t err = cudaSuccess;
  if (p.B > cap) {
    if (list) cudaFree(list);
    if (!cnt) err = cudaMalloc(&cnt, 4);
    if (err == cudaSuccess) err = cudaMalloc(&list, 4 * p.B);
    if (err != cudaSuccess) return err;
    cap = p.B;
  }
  err = cudaMemsetAsync(cnt, 0, 4, stream);
  int64_t blocks = 0;
  if (err == cudaSuccess) err = pass_blocks(rank_list_side, 256, list_sm, (p.B + 3) / 4, &blocks);
  if (err != cudaSuccess) return err;
  rank_list_side<<<(unsigned)blocks, 256, 0, stream>>>(p, io, list, cnt);
  const int threads = stage_threads(p);
  const size_t smem = (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4;
  err = pass_blocks(lookup_ranks_kernel<W, CANON, WALK>, threads, per_sm, p.B, &blocks, smem);
  if (err != cudaSuccess) return err;
  lookup_ranks_kernel<W, CANON, WALK><<<(unsigned)blocks, threads, smem, stream>>>(t, p, io, list,
                                                                                  cnt);
  return cudaGetLastError();
}

"""
GRID = """    const cudaError_t err = pass_blocks(minimizer_ranks_kernel<WW>, kRankThreads,
                                        per_sm[WW <= kMaxFixedW ? WW - 1 : kMaxFixedW], P,
                                        &blocks);
    if (err != cudaSuccess) return err;
"""
KMERS_GRID = """    const cudaError_t err = pass_blocks(kmers_kernel<WW>, kRowThreads,
                                        per_sm[WW <= kMaxFixedW ? WW - 1 : kMaxFixedW], P,
                                        &blocks);
    if (err != cudaSuccess) return err;
"""
# the anchor stage's search of pstart: each thread's binary search of all
# of it, and the two-level search that lost to it (a warp's 32-ary search
# for its first lane, then each thread's search of its warp's run)
THREAD_SEARCH = re.compile(r"  const int lane = threadIdx.x & 31;\n  // a: the reads that start "
                           r"before lane v.*?(?=  uint32_t sh = 0, fh = 0;)", re.S)
WARP_SEARCH = """  // lo: the reads that start before the warp's first lane v0 (pstart[:nr]
  // rises strictly): 32 probes a step; the first that is not below v0
  // bounds the next step's range
  const int lane = threadIdx.x & 31;
  const uint32_t v0 = v - 16u * lane;
  int64_t lo = 0, hi = nr;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5, idx = lo + step * (lane + 1) - 1;
    const bool less = idx < hi && pstart[idx] < v0;
    lo += (int64_t)__popc(__ballot_sync(0xFFFFFFFFu, less)) * step;
    hi = lo + step - 1 < hi ? lo + step - 1 : hi;
  }
  // a: the reads that start before lane v, at most v - v0 past lo
  int64_t a = lo;
  const int64_t span = nr - lo < 16 * lane ? nr - lo : 16 * lane;
  if (live) {
    for (int64_t step = span ? (int64_t)1 << (63 - __clzll(span)) : 0; step; step >>= 1)
      if (a - lo + step <= span && pstart[a + step - 1] < v) a += step;
  }
"""
# store_rows' body, and a thread a row storing its own words one by one
STAGED = re.compile(r"  const int lane = threadIdx.x & 31;\n"
                    r"  if constexpr \(kVectorRow<W>\).*?\n}\n", re.S)
ROW_STORES = """  (void)n;
  (void)stage;
  if (have) store_kmer(rows, row0 + (threadIdx.x & 31), nw, x);
}
"""


def patch(src, old, new):
    if old not in src:
        raise RuntimeError(f"not found in the source: {old}")
    return src.replace(old, new)


def sub(pattern, new, src):
    """src with the one match of pattern replaced by new."""
    out, n = pattern.subn(lambda _: new, src, count=1)
    if not n:
        raise RuntimeError(f"not found in the source: {pattern.pattern}")
    return out


def variant_sources():
    """{side: (directory of its patched sources, the sources it builds)}."""
    text = {n: (CSRC / n).read_text()
            for n in ("scan.cu", "stream_derive.cu", "minimizer.cu", "lookup_ranks.cu",
                      "stream_anchor.cu", "packed.cuh")}
    scan, derive = text["scan.cu"], text["stream_derive.cu"]
    sides = {
        "walk": {"lookup_ranks.cu": patch(patch(text["lookup_ranks.cu"], WALK_CUT,
                                                "constexpr int kWalkWindows = 1 << 30;"),
                                          WALK_W, "constexpr int kWalkMaxW = kWideW;")},
        "read": {"lookup_ranks.cu": patch(text["lookup_ranks.cu"], WALK_CUT,
                                          "constexpr int kWalkWindows = 0;")},
        "tiles": {"lookup_ranks.cu": sub(RANKS_KERNEL, TILE_RANKS, text["lookup_ranks.cu"])},
        "tiles4": {"lookup_ranks.cu": sub(RANKS_KERNEL, TILE_RANKS.replace(RANKS_SPILLED,
                                                                            "false ? 3"),
                                          text["lookup_ranks.cu"])},
        "strided": {"lookup_ranks.cu": sub(RANKS_KERNEL, STRIDED_RANKS,
                                           text["lookup_ranks.cu"])},
        "lists": {"lookup_ranks.cu": sub(RANKS_KERNEL, LISTED_RANKS, text["lookup_ranks.cu"])},
        "queued4": {"lookup_ranks.cu": patch(text["lookup_ranks.cu"], QUEUE_BOUNDS,
                                             QUEUE_BOUNDS.replace(
                                                 "W > kMaxFixedW ? 1 : !CANON && W >= 6 ? 2 : 3",
                                                 "lookup_min_blocks(W, CANON)"))},
        "warptile": {"lookup_ranks.cu": sub(RANKS_KERNEL, WARP_TILE_RANKS,
                                            text["lookup_ranks.cu"])},
        "k1_grid_p": {"minimizer.cu": patch(
            text["minimizer.cu"], GRID,
            "    (void)per_sm;\n    blocks = (P + kRankThreads - 1) / kRankThreads;\n")},
        "fill_memset": {"scan.cu": patch(patch(scan, "  if (!COMPACT) return;\n", "  return;\n"),
                                         "  if (err != cudaSuccess) return err;\n  if (blocks > "
                                         "ntiles)",
                                         "  if (err == cudaSuccess && COMPACT)\n"
                                         "    err = cudaMemsetAsync(out, 0, 4 * n, stream);\n"
                                         "  if (err != cudaSuccess) return err;\n  if (blocks > "
                                         "ntiles)")},
        "rank_stores": {"scan.cu": patch(scan, "        compact_row(x[i], ex[i], e0, out);\n",
                                         RANK_STORES)},
        "scan_vecs2": {"scan.cu": patch(scan, "constexpr int kScanVecs = 4;",
                                        "constexpr int kScanVecs = 2;")},
        "round2_vecs4": {"stream_derive.cu": patch(derive, "constexpr int kRound2Vecs = 2;",
                                                   "constexpr int kRound2Vecs = 4;")},
        "count16": {"stream_derive.cu": patch(derive, "constexpr int kCountLanes = 8;",
                                              "constexpr int kCountLanes = 16;")},
        "kmers_grid_p": {"stream_anchor.cu": patch(
            text["stream_anchor.cu"], KMERS_GRID,
            "    (void)per_sm;\n    blocks = (P + kRowThreads - 1) / kRowThreads;\n")},
        "warp_search": {"stream_anchor.cu": sub(THREAD_SEARCH, WARP_SEARCH,
                                                text["stream_anchor.cu"])},
        "row_stores": {"stream_anchor.cu": text["stream_anchor.cu"],
                       "packed.cuh": sub(STAGED, ROW_STORES, text["packed.cuh"])},
    }
    dirs = {}
    for side, files in sides.items():
        d = OUT / side
        d.mkdir(parents=True, exist_ok=True)
        for name, t in files.items():
            (d / name).write_text(t)
        dirs[side] = (d, tuple(n for n in files if n.endswith(".cu")))  # headers beside them
    return dirs


def ptxas_lines(side, log):
    """Registers and spills of the stream's kernels in nvcc's -Xptxas -v
    log (empty when the library was built earlier)."""
    lines, out = log.splitlines(), []
    for ln, nxt, reg in zip(lines, lines[1:], lines[2:]):
        m = re.search(r"Function properties for _ZN6sshash\d+(scan_kernel|heads_kernel|"
                      r"round2_kernel|merge_kernel|count_kernel|minimizer_ranks_kernel|"
                      r"lookup_ranks_kernel|anchors_kernel|kmers_kernel)"
                      r"(?:IL[ib](\d+)E(?:Lb([01])E)?)?", ln)
        if m and re.search(r"Used \d+ registers", reg):
            args = ",".join(x for x in m.groups()[1:] if x)
            out.append(f"{side} {m.group(1)}{'<' + args + '>' if args else ''}: "
                       f"{re.search(r'Used \d+ registers', reg).group(0)}, {nxt.strip()}")
    return out


def load_baseline(root):
    """DIR's sshash_tpu_torch as the package `baseline_sshash_tpu_torch`
    (its modules import each other relatively): a namespace of its
    streaming, kernels, engine and parallel modules."""
    name, pkg = "baseline_sshash_tpu_torch", Path(root) / "sshash_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(**{m: importlib.import_module(f"{name}.{m}")
                                    for m in ("streaming", "kernels", "engine", "parallel")})


class Mixed:
    """A kernel library whose named entries come from a variant and every
    other entry from the tree's."""

    def __init__(self, tree, variant, entries):
        self.tree, self.variant, self.entries = tree, variant, entries
        for name in entries:
            fn, ref = getattr(variant, name), getattr(tree, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype

    def __getattr__(self, name):
        return getattr(self.variant if name in self.entries else self.tree, name)


def build(baseline_kernels):
    """The tree's library, DIR's and each variant's sources, all nvcc
    processes started together. Returns ({side: library}, ptxas lines)."""
    nvcc = kernels._nvcc()
    jobs = {}
    for side, (d, srcs) in variant_sources().items():
        for src in srcs:
            obj = OUT / f"{side}_{src}.o"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(d), "-I", str(CSRC),
                   "-c", str(d / src), "-o", str(obj)]
            jobs[(side, src, obj)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)
    base = {}
    t = threading.Thread(target=lambda: base.setdefault("log", baseline_kernels.build()[2]))
    t.start()
    tree_log = kernels.build()[2]
    t.join()
    if "log" not in base:
        raise RuntimeError("the baseline's kernels did not build")
    libs = {"tree": kernels.library(), "baseline": baseline_kernels.library()}
    regs = ptxas_lines("tree", tree_log) + ptxas_lines("baseline", base["log"])
    objs, entries = {}, {}
    for (side, src, obj), proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{side}: nvcc failed ({proc.returncode}):\n{out[-3000:]}")
        regs += ptxas_lines(side, out)
        objs.setdefault(side, []).append(str(obj))
        entries.setdefault(side, []).extend(ENTRIES[src])
    for side, o in objs.items():
        so = OUT / f"lib{side}.so"
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), *o], check=True)
        libs[side] = Mixed(libs["tree"], ctypes.CDLL(str(so)), entries[side])
    return libs, regs


@contextlib.contextmanager
def using(lib):
    """The tree's kernel wrappers launch through lib while inside."""
    saved, kernels._lib = kernels._lib, lib
    try:
        yield
    finally:
        kernels._lib = saved


def recorded_step(st, cfg, P, R, CW, av):
    """st's step (st: a streaming module) with its stage calls recorded:
    (step, calls); calls gets (stage, args, output) on each run."""
    calls = []

    def wrap(name, fn):
        def f(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, a, out))
            return out
        return f

    ops = st.KERNEL_OPS
    ops = ops._replace(**{n: wrap(n, getattr(ops, n)) for n in ops._fields})
    lookup = st.make_lookup(cfg, "full")
    return st.make_stream_step(cfg, P, R, CW, lookup, all_valid=av, ops=ops), calls


def _values(name, args, x):
    """A stage's output as a list of int64 tensors (flags as 0/1), the
    rank-space stages' and the misses' read's rows below their count
    only."""
    n = {"minimizer_ranks": lambda: int(args[1][0]), "lookup_ranks": lambda: int(args[4][0]),
         "kmers": lambda: int(args[5][0])}.get(name, lambda: None)()
    if isinstance(x, dict):
        x = [x[key] for key in sorted(x)]
    elif not isinstance(x, (tuple, list)):
        x = [(x != 0) if x.dtype in (torch.bool, torch.uint8) else x]
    return [t[:n].to(torch.int64) for t in x]


def stage_outputs(calls, skip=()):
    """{(stage, its k-th call): values} of the compared stages, but those
    of the sources in skip."""
    out, seen = {}, {}
    for name, a, o in calls:
        if name in SOURCE_OF and SOURCE_OF[name] not in skip:
            i = seen[name] = seen.get(name, -1) + 1
            out[(name, i)] = _values(name, a, o)
    return out


def masks_atomic(base_st, calls, want):
    """The parent's anchor stage feeding this tree's read: DIR's masks
    kernel (base_st: DIR's streaming module), this tree's scan of the group
    counts and its kmer read at the anchors' lanes, on the tree's
    recorded anchor-stage inputs (calls); checked equal to want, the
    tree's stage. Returns the stage as a function."""
    (pstart, rfirst, nreads, words32, Pn, k), = [a for n, a, _ in calls if n == "anchors"]
    A = Pn // ST.S
    lanes = torch.arange(A, dtype=torch.int32, device=pstart.device) * ST.S
    count = torch.tensor([A], dtype=torch.int32, device=pstart.device)

    def run():
        sbits, fbits, gcnt = base_st.stream_masks(pstart, rfirst, nreads, Pn)
        cum_g = ST.KERNEL_OPS.scan(gcnt)
        return sbits, fbits, cum_g, ST.stream_kmers(words32, sbits, cum_g, k, lanes, count)

    S.require(all(torch.equal(g, w) for g, w in zip(run(), want)),
              "masks_atomic: the anchor stage != the tree's")
    return run


def compare_chunk(tag, sides, eng, packed, P, R, CW, av, stages=False):
    """Every side's step and stages on one chunk equal the tree's; then the
    whole step, the misses' kernels, the two sources and, with `stages`,
    each stage in turns."""
    runs = {}
    for side, (st, lib) in sides.items():
        with using(lib):
            step, calls = recorded_step(st, eng.cfg, P, R, CW, av)
            out = step(eng.tables, packed)
        runs[side] = (step, calls, out)
    _, calls, ref = runs["tree"]
    want = stage_outputs(calls)
    # a baseline before the one-launch anchor stage: its anchor stage and
    # reads are other stages (masks, kmers of the anchors and of the
    # misses), held to the tree's below; before the rank space it ran its
    # misses over all P lanes
    base_names = {n for n, _, _ in runs["baseline"][1]}
    old_anchors = "anchors" not in base_names
    base_skip = ("stream_anchor.cu",) * old_anchors + ("misses",) * (
        "lookup_ranks" not in base_names)
    anchor_calls, miss_calls = dict(ANCHOR_CALLS), dict(MISS_CALLS)
    if not old_anchors:
        anchor_calls["baseline"], miss_calls["baseline"] = ANCHOR_CALLS["tree"], MISS_CALLS["tree"]
    for side, (_, calls, out) in runs.items():
        S.require(S.rows_equal(out, ref), f"{tag}: the {side} step != the tree's")
        got = stage_outputs(calls, base_skip if side == "baseline" else ())
        for key, v in want.items():
            if side == "baseline" and SOURCE_OF[key[0]] in base_skip:
                continue
            S.require(key in got and all(torch.equal(a, b) for a, b in zip(got[key], v)),
                      f"{tag}: {side} stage {key} != the tree's")
    n_need = [int(o[1][0]) for n, _, o in runs["tree"][1] if n == "compact"][0]
    active = [int(a[4][:n_need].sum()) for n, a, _ in runs["tree"][1] if n == "lookup_ranks"]
    S.log(f"  {tag}: every side's step and stages equal the tree's ({', '.join(sides)}); "
          f"misses {n_need} of P {P}; active ranks in the two lookup rounds {active}")

    def calls_fn(side, src):
        st, lib = sides[side]
        sel = [(getattr(st.KERNEL_OPS, n), a) for n, a, _ in runs[side][1]
               if SOURCE_OF.get(n) == src]

        def run():
            with using(lib):
                for fn, a in sel:
                    fn(*a)
        return run

    def picked(side, keys):
        """The side's calls of keys ((stage, k-th call)), as one function,
        and their outputs."""
        st, lib = sides[side]
        seen, sel, outs = {}, [], []
        for n, a, o in runs[side][1]:
            i = seen[n] = seen.get(n, -1) + 1
            if (n, i) in keys:
                sel.append((getattr(st.KERNEL_OPS, n), a))
                outs.append(o)

        def run():
            with using(lib):
                for fn, a in sel:
                    fn(*a)
        return run, outs

    # the anchor stage: every side's (sbits, fbits, cum_g, anchors) equal the
    # tree's (the baseline's from its masks, group scan and anchors' read),
    # then the sides in turns
    tree_anchor = picked("tree", anchor_calls["tree"])[1][0]
    anchor_fns = {}
    for side in sides:
        fn, outs = picked(side, anchor_calls.get(side, anchor_calls["tree"]))
        got = outs[0] if side != "baseline" or not old_anchors else (*outs[0][:2], outs[1],
                                                                      outs[2])
        S.require(all(torch.equal(g, w) for g, w in zip(got, tree_anchor)),
                  f"{tag}: the {side} anchor stage != the tree's")
        anchor_fns[side] = fn
    if old_anchors:
        anchor_fns["masks_atomic"] = masks_atomic(sides["baseline"][0], runs["tree"][1],
                                                  tree_anchor)
    S.time_sides(tag, "the anchor stage", P, anchor_fns, unit="lane", graph=tuple(anchor_fns))
    # the misses' kmer read: rows below the count equal the tree's
    n_miss = int([a for n, a, _ in runs["tree"][1] if n == "kmers"][0][5][0])
    tree_miss = picked("tree", miss_calls["tree"])[1][0][:n_miss]
    miss_fns = {}
    for side in sides:
        fn, outs = picked(side, miss_calls.get(side, miss_calls["tree"]))
        S.require(torch.equal(outs[0][:n_miss], tree_miss),
                  f"{tag}: the {side} misses' read != the tree's")
        miss_fns[side] = fn
    S.time_sides(tag, f"the misses' kmer read (n {n_miss})", P, miss_fns, unit="lane",
                 graph=tuple(miss_fns))

    def step_fn(side):
        step, lib = runs[side][0], sides[side][1]

        def run():
            with using(lib):
                runs[side][1].clear()
                step(eng.tables, packed)
        return run

    def stage_fn(side, key):
        st, lib = sides[side]
        name, k = key
        fn = getattr(st.KERNEL_OPS, name)
        a = [a for n, a, _ in runs[side][1] if n == name][k]

        def run():
            with using(lib):
                for _ in range(STAGE_CALLS):
                    fn(*a)
        return run

    graph = tuple(sides)
    S.time_sides(tag, "the step", P, {side: step_fn(side) for side in sides}, unit="lane",
                 graph=graph)
    ranked = [side for side in sides if side != "baseline" or "misses" not in base_skip]
    S.time_sides(tag, "the misses' kernels (kernel 1's rank form, both lookup rounds)", P,
                 {side: calls_fn(side, "misses") for side in ranked}, unit="lane", graph=ranked)
    for src in ("scan.cu", "stream_derive.cu"):
        S.time_sides(tag, src, P, {side: calls_fn(side, src) for side in sides}, unit="lane",
                     graph=graph)
    if stages:
        for key in want:
            fns = {side: stage_fn(side, key) for side in sides
                   if not (side == "baseline" and SOURCE_OF[key[0]] in base_skip)}
            S.time_sides(tag, f"stage {key[0]} #{key[1]}, {STAGE_CALLS} calls", P * STAGE_CALLS,
                         fns, unit="lane", graph=tuple(fns))


def first_chunk(stream_cls, eng, path, multiline, **kw):
    st = stream_cls(eng, pmax=1 << 22, rmax_shift=12 if multiline else 4, **kw)
    st.capture = []
    for seq in ST.parse_reads(path, multiline=multiline):
        st.add_read(seq)
    st.finalize()
    av, packed = st.capture[0]
    return packed, st.P, st.R, st.CW, av


def unsharded_chunk(eng, path, multiline):
    return first_chunk(lambda e, **kw: ST._DeviceStream(e, e.cfg.k, **kw), eng, path, multiline)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="an unpacked earlier tree")
    ap.add_argument("--strings", type=int, default=S.SCALE_STRINGS)
    ap.add_argument("--chunks", default="high-hit,low-hit,mixed,k65-mixed",
                    help="the chunks to run, of high-hit, low-hit, mixed and k65-mixed")
    ap.add_argument("--stages", action="store_true", help="also time each stage in turns")
    a = ap.parse_args()
    chunks = a.chunks.split(",")
    S.phase_card()
    dev = torch.device("cuda", 0)
    base = load_baseline(a.baseline)
    libs, regs = build(base.kernels)
    for ln in regs:
        S.log(f"  ptxas {ln}")
    # the baseline's wrappers launch through its own library (its side swaps
    # nothing in this tree's)
    sides = {name: (ST, lib) for name, lib in libs.items() if name != "baseline"}
    sides["baseline"] = (base.streaming, libs["tree"])
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("high-hit", "low-hit", "mixed", "k65-mixed"):
            if name in chunks:
                globals()[name.replace("-", "_")](a, sides, base, dev, rng, tmp)
    S.log(f"card: {torch.cuda.get_device_name(0)}")


def high_hit(a, sides, base, dev, rng, tmp):
    """The first chunk of a 168-string genome against the 100M build, and
    the engine's lookup there against DIR's."""
    idx, host = S.build("canonical", k=31, m=21, canonical=True, num_strings=a.strings,
                        string_len=S.STRING_LEN, seed=60, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    del host
    strings = synthetic.index_strings(idx, rng.choice(idx.num_strings, S.SCALE_STREAM_STRINGS,
                                                      replace=False))
    path = os.path.join(tmp, "genome.fa")
    synthetic.write_genome(path, strings, rng)
    chunk = unsharded_chunk(eng, path, True)
    compare_chunk(f"100M high-hit chunk (P={chunk[1]})", sides, eng, *chunk, stages=a.stages)
    del chunk
    _, km = S.positives(idx, rng, S.SCALE_B)
    kt = eng.kmers32(km)
    del km
    got = E.lookup(eng.cfg, eng.tables, kt, None, "ids")
    want = base.engine.lookup(eng.cfg, eng.tables, kt, None, "ids")
    S.require(all(torch.equal(got[key], want[key]) for key in want), "100M lookup: tree != DIR")
    S.time_sides("100M canonical", "the engine's lookup (ids)", S.SCALE_B,
                 {"tree": lambda: E.lookup(eng.cfg, eng.tables, kt, None, "ids"),
                  "baseline": lambda: base.engine.lookup(eng.cfg, eng.tables, kt, None, "ids")})
    del eng, idx, kt, got, want
    torch.cuda.empty_cache()


def _lowhit_path(idx, rng, tmp):
    strings = synthetic.index_strings(idx)
    reads = synthetic.cut_reads(strings, S.LOWHIT_TRUE, S.LOWHIT_LEN, rng)
    reads += synthetic.random_reads(S.LOWHIT_READS - S.LOWHIT_TRUE, S.LOWHIT_LEN, rng)
    reads = synthetic.with_n([reads[i] for i in rng.permutation(len(reads))], 0.01, rng)
    path = os.path.join(tmp, "lowhit.fq")
    synthetic.write_reads(path, reads)
    return path


def low_hit(a, sides, base, dev, rng, tmp):
    """The first chunk of phase 10's low-hit reads on the 5M regular
    build, and the (1, 4) sharded stream's step there against DIR's."""
    idx, host = S.build("regular", k=31, m=17, canonical=False, num_strings=S.MAIN_STRINGS,
                        string_len=S.STRING_LEN, seed=40, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    path = _lowhit_path(idx, rng, tmp)
    chunk = unsharded_chunk(eng, path, False)
    compare_chunk(f"low-hit 5M chunk (P={chunk[1]})", sides, eng, *chunk, stages=a.stages)
    steps = {}
    for side, (par, stream_cls) in {"tree": (ShardedEngine, ShardedStream),
                                    "baseline": (base.parallel.ShardedEngine,
                                                 base.parallel.ShardedStream)}.items():
        seng = par(idx, LocalMesh((1, 4), dev) if side == "tree"
                   else base.parallel.LocalMesh((1, 4), dev), host_arrs=host)
        packed, *_, av = first_chunk(lambda e, **kw: stream_cls(e, **kw), seng, path, False)
        st = stream_cls(seng, pmax=1 << 22, rmax_shift=4)
        steps[side] = functools.partial(st._steps[(0, av)], None, packed)
    S.require(S.rows_equal(steps["tree"](), steps["baseline"]()),
              "sharded low-hit step: tree != DIR")
    S.time_sides("low-hit 5M (1, 4) sharded", "the step", 1 << 22, steps, unit="lane",
                 graph=tuple(steps))
    del eng, idx, host, steps
    torch.cuda.empty_cache()


def mixed(a, sides, base, dev, rng, tmp):
    """The first chunk of phase 10's mixed reads on the 5M canonical build."""
    idx, host = S.build("canonical", k=31, m=17, canonical=True, num_strings=S.MAIN_STRINGS,
                        string_len=S.STRING_LEN, seed=40, threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    strings = synthetic.index_strings(idx)
    half = S.MIXED_READS // 2
    reads = synthetic.cut_reads(strings, half, S.MIXED_LEN, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(half, S.MIXED_LEN, rng)
    path = os.path.join(tmp, "mixed.fq")
    synthetic.write_reads(path, [reads[i] for i in rng.permutation(len(reads))])
    chunk = unsharded_chunk(eng, path, False)
    compare_chunk(f"mixed 5M canonical chunk (P={chunk[1]})", sides, eng, *chunk,
                  stages=a.stages)
    del eng, idx, host, chunk
    torch.cuda.empty_cache()


def k65_mixed(a, sides, base, dev, rng, tmp):
    """The first chunk of phase 13's mixed reads on a k65 m25 canonical
    build of 5M kmers."""
    idx, host = S.build("k65 canonical", k=S.WIDE_K, m=S.WIDE_M, canonical=True,
                        num_strings=MIXED_K65_STRINGS, string_len=S.WIDE_STRING_LEN, seed=65,
                        threads=8)
    eng = S.TorchEngine(idx, dev, host_arrs=host)
    strings = synthetic.index_strings(idx)
    half = S.WIDE_READS // 2
    reads = synthetic.cut_reads(strings, half, S.MIXED_LEN, rng, rc=0.5, subst=0.01)
    reads += synthetic.random_reads(half, S.MIXED_LEN, rng)
    path = os.path.join(tmp, "k65_mixed.fq")
    synthetic.write_reads(path, [reads[i] for i in rng.permutation(len(reads))])
    chunk = unsharded_chunk(eng, path, False)
    compare_chunk(f"k65 mixed canonical chunk (P={chunk[1]})", sides, eng, *chunk,
                  stages=a.stages)
    del chunk
    _, km = S.positives(idx, rng, S.MAIN_B)
    kt = eng.kmers32(km)
    got = E.lookup(eng.cfg, eng.tables, kt, None, "ids")
    want = base.engine.lookup(eng.cfg, eng.tables, kt, None, "ids")
    S.require(all(torch.equal(got[key], want[key]) for key in want), "k65 lookup: tree != DIR")
    S.time_sides("k65 5M canonical", "the engine's lookup (ids)", S.MAIN_B,
                 {"tree": lambda: E.lookup(eng.cfg, eng.tables, kt, None, "ids"),
                  "baseline": lambda: base.engine.lookup(eng.cfg, eng.tables, kt, None, "ids")})
    del eng, idx, host, kt, got, want
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
