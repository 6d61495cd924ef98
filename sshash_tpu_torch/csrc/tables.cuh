// Table reads with the JAX package's gather semantics.
#pragma once
#include <cstdint>

namespace sshash {

// jnp.take(table, idx.astype(int32), mode="clip") on a table of n rows: an
// index >= 2^31 turns negative and reads row 0, one past the end reads the
// last row.
__device__ __forceinline__ int64_t clip_row(uint32_t idx, int64_t n) {
  const int32_t s = (int32_t)idx;
  if (s < 0) return 0;
  return s < n ? s : n - 1;
}

}  // namespace sshash
