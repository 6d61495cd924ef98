// Grids sized to the card, and the device counts that rank-space stages
// stride up to.
//
// A kernel launched on a grid sized to the card (SMs x the blocks of it
// that fit on one SM) strides over its work, so a stage whose work is a
// count read on the device (the stream's misses) takes a fixed launch
// whatever the count, and the step stays one sequence of launches that a
// CUDA graph replays. The occupancy is asked once for each card: a
// process may hold tensors on several cards, and each launch goes to the
// current device, which the Python wrappers set to their tensors' card.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace sshash {

// Cards a process may use (CUDA device ordinals below this).
constexpr int kMaxDevices = 64;

// A per-card cache of one kernel's resident blocks an SM (0 until asked)
// and the dynamic shared memory they were asked for.
struct PerDevice {
  int v[kMaxDevices] = {};
  size_t smem[kMaxDevices] = {};
};

// The current device's ordinal; cudaErrorInvalidDevice past kMaxDevices.
inline cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) return cudaErrorInvalidDevice;
  return err;
}

// Blocks of `threads` (and smem bytes of dynamic shared memory) that fill
// the current card: SMs x resident blocks an SM, the latter asked once a
// card and shared-memory size and kept in per_sm (a call captured in a
// CUDA graph after a first call then asks nothing).
template <class K>
inline cudaError_t card_blocks(K kernel, int threads, PerDevice& per_sm, int64_t* blocks,
                               size_t smem = 0) {
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm.v[dev] == 0 || per_sm.smem[dev] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm.v[dev], kernel, threads, smem);
    per_sm.smem[dev] = smem;
  }
  *blocks = (int64_t)sms * (per_sm.v[dev] > 0 ? per_sm.v[dev] : 1);
  return err;
}

// card_blocks, or fewer where `work` elements, one a thread, need fewer.
template <class K>
inline cudaError_t pass_blocks(K kernel, int threads, PerDevice& per_sm, int64_t work,
                               int64_t* blocks, size_t smem = 0) {
  const cudaError_t err = card_blocks(kernel, threads, per_sm, blocks, smem);
  const int64_t need = (work + threads - 1) / threads;
  if (*blocks > need) *blocks = need > 0 ? need : 1;
  return err;
}

// The device count *count clamped to [0, P]: the ranks a rank-space stage
// serves (the stream's misses, compacted in rank order). A block reads it
// once.
__device__ __forceinline__ int64_t misses(const int32_t* count, int64_t P) {
  const int64_t n = *count;
  return n < 0 ? 0 : (n > P ? P : n);
}

}  // namespace sshash
