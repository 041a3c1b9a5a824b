// The dropout keep-mask of the attention kernels: a stateless hash of the
// seed, the grid cell b*H + h and the element (row, col), the _keep_mask of
// mit_tpu/ops/pallas_dropout_attention.py bit for bit. Included by
// flash_attention_dropout.cu and attention_any_shape.cu; internal linkage.

#pragma once

#include <stdint.h>

namespace {

// the part of the hash that depends on the cell and the seed only
__device__ __forceinline__ uint32_t cell_base(uint32_t seed, uint32_t cell) {
  return (seed * 2654435761u) ^ (cell * 0x9E3779B9u);
}

// murmur3's finalizer over idx = row*S + col, all uint32 with wrapping
// products; kept where the hash reaches the threshold
__device__ __forceinline__ bool keep_at(uint32_t row, uint32_t col,
                                        uint32_t S, uint32_t base,
                                        uint32_t threshold) {
  uint32_t x = (row * S + col) ^ base;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

}  // namespace
