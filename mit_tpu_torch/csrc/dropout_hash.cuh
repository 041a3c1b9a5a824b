// The dropout keep-mask of the attention kernels: a stateless hash of the
// seed, the grid cell b*H + h and the element (row, col), the _keep_mask of
// mit_tpu/ops/pallas_dropout_attention.py bit for bit. Included by
// flash_attention_dropout.cu and attention_any_shape.cu; internal linkage.
//
// Under a device mesh a launch holds rows b_offset.. of the global batch and
// heads h_offset.. of h_total: its local cell c = b*H + h hashes as the
// global cell (b_offset + c / H) * h_total + h_offset + c % H, so that a
// rank's mask is its slice of the single-device mask. (0, H, 0) is the
// local cell itself.

#pragma once

#include <stdint.h>

namespace {

struct CellMap {
  int b_offset, h_total, h_offset;
};

// the global cell of local cell `cell` of a launch over H heads
__device__ __forceinline__ uint32_t global_cell(int cell, int H, CellMap cm) {
  return (uint32_t)(cm.b_offset + cell / H) * (uint32_t)cm.h_total +
         (uint32_t)(cm.h_offset + cell % H);
}

// a map that holds H heads, with offsets at or above 0
inline bool bad_map(int H, CellMap cm) {
  return cm.b_offset < 0 || cm.h_offset < 0 || cm.h_offset + H > cm.h_total;
}

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
