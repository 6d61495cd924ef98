// 64-bit hash mixers with native 64-bit integer arithmetic.
//
// Device counterparts of sshash_tpu/ops/u64.py (which emulates them on
// (hi, lo) uint32 pairs for the TPU) and of the plain PyTorch versions in
// sshash_tpu_torch/ops/u64.py. All of them are bit-identical to the host
// index build's sshash_tpu/hashing.py: products wrap mod 2^64 (or 2^32), as
// NumPy's unsigned arithmetic does.
#pragma once
#include <cstdint>

namespace sshash {

constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMixerMult = 0x517CC1B727220A95ull;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += kGolden;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ uint64_t mixer64(uint64_t x, uint64_t magic) {
  return (x * kMixerMult) ^ magic;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mulhi32(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}

__device__ __forceinline__ uint32_t hi32(uint64_t x) { return (uint32_t)(x >> 32); }
__device__ __forceinline__ uint32_t lo32(uint64_t x) { return (uint32_t)x; }

__device__ __forceinline__ uint64_t hash64_u64(uint64_t key, uint64_t seed_mix) {
  return splitmix64(key ^ seed_mix);
}

// hashing.hash64_words over the first nw words of w: h = seed_mix;
// h = splitmix64(h ^ (w[i] + i*GOLDEN))
template <int W>
__device__ __forceinline__ uint64_t hash64_words(const uint32_t (&w)[W], int nw,
                                                 uint64_t seed_mix) {
  uint64_t h = seed_mix;
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < nw) h = splitmix64(h ^ ((uint64_t)w[i] + (uint64_t)i * kGolden));
  return h;
}

}  // namespace sshash
