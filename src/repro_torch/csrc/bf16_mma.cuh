// bfloat16 tensor-core helpers shared by the attention kernels (K2's and
// K3's bf16 paths): swizzled 16-byte chunks for ldmatrix, mma.sync
// m16n8k16 bf16 -> f32, and the two-term bf16 split of an f32 P.
// kernels/build.py hashes it with the sources that include it.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Index of 16-byte chunk c of row r in a tile whose rows hold C chunks;
// XOR-swizzled so the 8 rows one ldmatrix phase reads fall in distinct
// bank groups.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (C >= 8) return r * C + (c ^ (r & 7));
  else if constexpr (C == 4) return r * C + (c ^ ((r >> 1) & 3));
  else return r * C + (c ^ ((r >> 2) & 1));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (p0, p1) as two bf16 pairs: hi rounds them, lo rounds what hi missed,
// so hi + lo holds ~16 significant bits of each
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      p0 - __bfloat162float(h.x), p1 - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace
