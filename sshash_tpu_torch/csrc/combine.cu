// The bucket-sharded engine's combine on one card: the elementwise min,
// max or sum of a mesh group's NB tensors (parallel/mesh.py LocalMesh,
// the combines that remain after kernel 2's shard form stores each lane
// once: the sharded access's unsigned max of kmers and its two-round
// form's unsigned min of offsets, the weight's and the stream window
// read's unsigned max, the per-row sums).
//
// Replaces sshash_tpu/parallel/sharded.py _combine_bucket (:103-117) and
// the access, weight and window combines (:254-264, 281, 438): lax.pmin,
// pmax and psum over ICI, each TPU chip holding one shard. On one card the
// shards' answers sit side by side in device memory, and the plain
// version (mesh.combine_plain) stacks them into one (NB, ...) tensor and
// reduces it: a copy of every input, then a second pass. Here one pass
// reads the NB inputs through pointers passed by value (up to
// kMaxCombine; the wrapper folds more in groups) with 16-byte loads, all
// NB issued before the first operation, and writes the output once.
//
// Elements are int32 or int64, ordered signed or as unsigned (u32 bits in
// int32: 0xFFFFFFFF is the largest); sums wrap. Where any pointer is not
// 16-byte aligned every element goes through the scalar loop.
//
// Bound: bytes, (NB + 1) x n x the element size.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "grid.cuh"

namespace sshash {

constexpr int kMaxCombine = 8;
constexpr int kCombineThreads = 256;
enum CombineOp { kMin = 0, kMax = 1, kSum = 2 };

struct CombineIn {
  const void* p[kMaxCombine];
};

template <int OP, typename T>
__device__ __forceinline__ T comb(T a, T b) {
  if constexpr (OP == kMin) return b < a ? b : a;
  if constexpr (OP == kMax) return b > a ? b : a;
  return a + b;  // unsigned T: wraps
}

template <int OP, typename T>
__device__ __forceinline__ uint4 comb_vec(uint4 a, uint4 b) {
  constexpr int L = 16 / sizeof(T);
  T x[L], y[L];
  memcpy(x, &a, 16);
  memcpy(y, &b, 16);
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = comb<OP>(x[l], y[l]);
  memcpy(&a, x, 16);
  return a;
}

template <int OP, typename T>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(CombineIn in, int nb, int64_t n, bool vec, T* __restrict__ out) {
  constexpr int L = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nv = vec ? n / L : 0;
  for (int64_t v = t0; v < nv; v += stride) {
    uint4 x[kMaxCombine];
#pragma unroll
    for (int j = 0; j < kMaxCombine; ++j)
      if (j < nb) x[j] = __ldg(reinterpret_cast<const uint4*>(in.p[j]) + v);
#pragma unroll
    for (int j = 1; j < kMaxCombine; ++j)
      if (j < nb) x[0] = comb_vec<OP, T>(x[0], x[j]);
    reinterpret_cast<uint4*>(out)[v] = x[0];
  }
  for (int64_t e = nv * L + t0; e < n; e += stride) {
    T a = reinterpret_cast<const T*>(in.p[0])[e];
    for (int j = 1; j < nb; ++j) a = comb<OP>(a, reinterpret_cast<const T*>(in.p[j])[e]);
    out[e] = a;
  }
}

// static: the occupancy cache stays this library's
template <int OP, typename T>
static cudaError_t launch_combine(const CombineIn& in, int nb, int64_t n, bool vec, void* out,
                                  cudaStream_t stream) {
  static PerDevice per_sm;
  const int64_t work = vec ? n / (16 / sizeof(T)) + 16 / sizeof(T) : n;
  int64_t blocks = 0;
  const cudaError_t err =
      pass_blocks(combine_kernel<OP, T>, kCombineThreads, per_sm, work, &blocks);
  if (err != cudaSuccess) return err;
  combine_kernel<OP, T><<<(unsigned)blocks, kCombineThreads, 0, stream>>>(
      in, nb, n, vec, reinterpret_cast<T*>(out));
  return cudaGetLastError();
}

template <typename S, typename U>
static cudaError_t combine_typed(const CombineIn& in, int nb, int64_t n, int64_t op,
                                 bool is_unsigned, bool vec, void* out, cudaStream_t s) {
  if (op == kSum) return launch_combine<kSum, U>(in, nb, n, vec, out, s);
  if (op == kMin)
    return is_unsigned ? launch_combine<kMin, U>(in, nb, n, vec, out, s)
                       : launch_combine<kMin, S>(in, nb, n, vec, out, s);
  return is_unsigned ? launch_combine<kMax, U>(in, nb, n, vec, out, s)
                     : launch_combine<kMax, S>(in, nb, n, vec, out, s);
}

}  // namespace sshash

// C entry for ctypes: out[e] = op over j < nb of in[j][e], e < n, for nb
// (1..8) device arrays of n elements of elem (4 or 8) bytes; op 0 min, 1
// max, 2 sum; is_unsigned orders min and max as unsigned. Returns the
// launch's cudaError_t (0 on success).
extern "C" int sshash_combine(const void* const* in, int64_t nb, int64_t n, int64_t elem,
                              int64_t op, int64_t is_unsigned, void* out, void* stream) {
  using namespace sshash;
  if (nb < 1 || nb > kMaxCombine || n < 0 || (elem != 4 && elem != 8) || op < kMin ||
      op > kSum || !out)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  CombineIn args{};
  bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int j = 0; j < nb; ++j) {
    if (!in[j]) return (int)cudaErrorInvalidValue;
    args.p[j] = in[j];
    vec = vec && reinterpret_cast<uintptr_t>(in[j]) % 16 == 0;
  }
  auto s = (cudaStream_t)stream;
  return elem == 4
             ? (int)combine_typed<int32_t, uint32_t>(args, (int)nb, n, op, is_unsigned != 0, vec,
                                                     out, s)
             : (int)combine_typed<int64_t, uint64_t>(args, (int)nb, n, op, is_unsigned != 0, vec,
                                                     out, s);
}
