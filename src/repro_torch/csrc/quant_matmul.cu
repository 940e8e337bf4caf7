// K1: int8 x bit-packed int8 matmul with fused per-channel dequant.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py
// (_qmm_kernel, launched by quant_matmul_fwd, unpacking with _unpack):
//
//     Y[m, n] = float(sum_k Xq[m, k] * Wq[n, k]) * sw[n] * sx
//
// Xq is int8 (M, K) row-major; Wq holds signed 8/4/2-bit values packed
// little-endian into int8 words (N, Kp), Kp = ceil(K * bits / 8), and is
// sign-extended here exactly like _unpack; sw is (N,) f32 and sx one f32
// on the device.  Y is (M, N) f32.
//
// What bounds it on the H100: the product does 2*M*N*K integer operations
// over N*Kp weight bytes, i.e. 2*M*8/bits operations per weight byte,
// against the ~590 int8 operations per byte at which the tensor cores,
// not HBM, become the limit.  Decode (M = the batch, 8) is far below the
// line and bound by the bytes of the packed weight; a prefill (M = 512 or
// 2048) is above it and bound by the tensor cores' int8 rate, which only
// wgmma reaches in full.
//
// Two layouts, chosen per call from the shapes:
// * tiles (prefill and every ragged shape): wgmma s8 with the operands
//   swapped, Y^T = W X^T, so that the packed operand is the one wgmma takes
//   from registers.  A block of WG warpgroups covers 64 WG rows of W x BMX
//   rows of X (BMX = 128, or 64 when M <= 64); each warpgroup multiplies its
//   64 rows of W by the block's X tile with wgmma.m64n{BMX}k32.  WG = 4 (one
//   block an SM) when that grid fills between half a wave and a wave, since
//   it reads each X tile half as often as WG = 2 (two blocks an SM), which
//   takes the rest.  A ring of cp.async copies brings the X tile (in the
//   128-byte swizzle that wgmma reads through its descriptor) and the
//   *packed* W bytes (a 4-bit layer moves half the bytes of an int8 one) into
//   shared memory, two steps of 128 values of K ahead.  The weights are never
//   unpacked in shared memory: each thread loads its packed bytes and unpacks
//   them into its A fragment in registers, a shift and a mask putting each
//   value in the top bits of its byte (the value times 2^(8 - bits), signed
//   for free; the int32 sum is shifted back, exactly, in the epilogue) and
//   byte permutes putting them in order.  W rows are swizzled so that those
//   loads hit distinct banks, and the fragment of the next 32 values of K is
//   built while the current wgmma runs.  A grid of tiles for under half the
//   SMs (a plan's narrow precision groups) would be a chain of K steps, so
//   its K steps are split over up to one block an SM: each adds its int32
//   sums into the tile's workspace with atomics, and the tile's last block
//   (an atomic count) takes the total and stores -- one launch, still
//   exact.  Ragged M, N and K are zero-filled by the copies themselves
//   (cp.async's source size), never padded by the caller.  Rows whose stride
//   or address is not a multiple of 16 bytes take 4-byte copies, or byte
//   loads below that.
// * decode (M <= 8, whole 16-byte weight vectors, 16-byte aligned
//   operands): bound by the bytes of the packed weight, so the design keeps
//   many of them in flight and spends few instructions on each.
//   mma.sync.m16n8k32 s8 with the operands swapped, n = 8 being the batch:
//   a warp takes 16 W rows, each lane loading whole 16-byte vectors of its
//   two rows into a register ring four groups deep (K permuted alike for W
//   and X within a group so that a vector is a lane's A fragments of two to
//   eight k32 steps, unpacked like the tiles'), X staged once per block in
//   shared memory; narrow N splits K over the warps of a block, whose int32
//   sums meet in shared memory.
// Both accumulate in int32, which is exact: the result equals the int32
// plain version bit for bit (the TPU kernel's f32 partial sums are exact
// only below 2^24, which K = 8192 exceeds).  A product of two scaled
// values is at most 2^14, so K must stay below 2^17.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int BK = 128;            // K values per step: one 128-byte X row
constexpr int AHEAD = 2;           // steps of loads in flight
constexpr int MAX_K = 1 << 17;     // int32 sums of scaled products stay exact
constexpr int SMS = 132;           // H100 SXM
// split K: a grid of fewer than SMS / 2 tiles splits its K steps over up
// to SMS blocks, MAX_SPLITS a tile; each of those tiles sums into its
// int32 workspace of at most 256 x 128 sums
constexpr int MAX_SPLITS = 8;
constexpr int COUNT_INTS = SMS / 2;
constexpr long long PART_INTS = (long long)COUNT_INTS * 256 * 128;

// cp.async ring depth of a block of WG warpgroups: as deep as leaves room
// for two blocks an SM at WG = 2 (8-bit then takes three slots and drains
// the wgmma pipe each step, see the K loop), four at WG = 4
__host__ __device__ constexpr int stages(int bits, int wg) {
  return wg == 2 && bits == 8 ? 3 : 4;
}

// Byte b of row r of the X tile: 128-byte rows, 16-byte chunk c stored at
// chunk c ^ (r % 8) -- the 128-byte swizzle wgmma reads (tile 1024-aligned)
__device__ __forceinline__ int swz_x(int r, int b) {
  return r * BK + (b ^ ((r & 7) << 4));
}

// Byte b of row r of a packed W tile of RB-byte rows (RB / 16 chunks):
// chunk c stored at c ^ ((r / (128 / RB)) % (RB / 16)), so the eight rows
// a warp's fragment loads read fall in distinct banks
template <int RB>
__device__ __forceinline__ int swz_w(int r, int b) {
  return r * RB + (b ^ (((r / (128 / RB)) % (RB / 16)) << 4));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// n (0..16) bytes of a global row at `src` into shared memory at `dst`,
// the rest of the 16 zero-filled.  `vec` is the widest copy the row's
// address and stride allow: 16 or 4 bytes go through cp.async (src-size
// zero-fills), 1 through plain loads.  `base` is a valid address handed
// to a copy that reads nothing.
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src, int n,
                                       int vec, const int8_t* base) {
  if (vec == 16) {
    cp_async16(smem_addr(dst), n > 0 ? src : base, n);
  } else if (vec == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ni = min(max(n - 4 * i, 0), 4);
      cp_async4(smem_addr(dst + 4 * i), ni > 0 ? src + 4 * i : base, ni);
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < n; ++i)
      w[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching r across an asynchronous wgmma
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D (64 x n, s32) += A (64 x 32 s8, registers) * B (32 x n s8, shared
// memory through `desc`); each thread holds n / 2 sums
__device__ __forceinline__ void wgmma_n64(int (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Eight signed 4-bit values packed little-endian in w (byte i holds values
// 2i, low nibble, and 2i + 1) as two int8x4 words, each value in the top
// four bits of its byte (value * 16, signed for free): lo = values 0..3,
// hi = values 4..7.
__device__ __forceinline__ void unpack_top4(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t l = (w << 4) & 0xF0F0F0F0u;   // even values
  const uint32_t u = w & 0xF0F0F0F0u;          // odd values
  lo = __byte_perm(l, u, 0x5140);
  hi = __byte_perm(l, u, 0x7362);
}

// Eight signed 2-bit values packed in the low 16 bits of w (field f of
// byte i holds value 4i + f) likewise, each value * 64: lo = values 0..3,
// hi = values 4..7.
__device__ __forceinline__ void unpack_top2(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t f0 = (w << 6) & 0xC0C0u, f1 = (w << 4) & 0xC0C0u;
  const uint32_t f2 = (w << 2) & 0xC0C0u, f3 = w & 0xC0C0u;
  const uint32_t t0 = __byte_perm(f0, f1, 0x5140);
  const uint32_t t2 = __byte_perm(f2, f3, 0x5140);
  lo = __byte_perm(t0, t2, 0x5410);
  hi = __byte_perm(t0, t2, 0x7632);
}

// One thread's A fragment of one wgmma (32 values of K): W rows r and
// r + 8 of the tile, values 4t..4t+3 and 16+4t..16+4t+3 of the 32 at
// `kk`, each value in the top BITS bits of its byte (value * 2^(8-BITS)).
template <int BITS>
__device__ __forceinline__ void load_a(const int8_t* wt, int r, int kk,
                                       int t, uint32_t (&a)[4]) {
  constexpr int RB = BK * BITS / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {          // rows r and r + 8
    const int row = r + 8 * h;
    uint32_t lo, hi;                     // values 4t.. and 16+4t..
    if constexpr (BITS == 8) {
      lo = *reinterpret_cast<const uint32_t*>(
          wt + swz_w<RB>(row, 32 * kk + 4 * t));
      hi = *reinterpret_cast<const uint32_t*>(
          wt + swz_w<RB>(row, 32 * kk + 16 + 4 * t));
    } else if constexpr (BITS == 4) {
      unpack_top4(__byte_perm(*reinterpret_cast<const uint16_t*>(
                                  wt + swz_w<RB>(row, 16 * kk + 2 * t)),
                              *reinterpret_cast<const uint16_t*>(
                                  wt + swz_w<RB>(row, 16 * kk + 8 + 2 * t)),
                              0x5410),
                  lo, hi);
    } else {
      unpack_top2((uint32_t)*reinterpret_cast<const uint8_t*>(
                      wt + swz_w<RB>(row, 8 * kk + t)) |
                      ((uint32_t)*reinterpret_cast<const uint8_t*>(
                           wt + swz_w<RB>(row, 8 * kk + 4 + t))
                       << 8),
                  lo, hi);
    }
    a[h] = lo;
    a[2 + h] = hi;
  }
}

template <int BMX>
__device__ __forceinline__ void wgmma_x(int (&d)[BMX / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  if constexpr (BMX == 64) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
}

// A block of WG warpgroups: W rows [n0, n0 + 64 WG) x X rows
// [m0, m0 + BMX)
template <int BITS, int BMX, int WG>
__global__ void __launch_bounds__(128 * WG, WG == 2 ? 2 : 1)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sw, const float* __restrict__ sx,
           float* __restrict__ y, int M, int N, int K, int Kp, int xvec,
           int wvec, int splits, int* __restrict__ part,
           int* __restrict__ count) {
  constexpr int NT = 128 * WG, BN = 64 * WG;
  constexpr int STAGES = stages(BITS, WG);
  constexpr int RB = BK * BITS / 8;      // packed bytes per W row and step
  constexpr int XS = BMX * BK;           // bytes of one X stage
  constexpr int WS = BN * RB;            // bytes of one packed W stage
  constexpr int ACC = BMX / 2;           // int32 sums a thread holds
  extern __shared__ int8_t smem_raw[];
  int8_t* xs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int8_t* ws = xs + STAGES * XS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;          // W rows r0, r0 + 8 of the tile
  const int m0 = blockIdx.y * BMX, n0 = blockIdx.x * BN;
  // split z of `splits` takes the K steps [k_begin, k_begin + KT)
  const int steps = (K + BK - 1) / BK, z = blockIdx.z;
  const int k_begin = steps * z / splits;
  const int KT = steps * (z + 1) / splits - k_begin;

  // This thread's copies of a step: 16-byte chunk cx of the X rows
  // rx + j NT / 8, chunk cw of the W rows rw + j NT / WCH.  Those row steps
  // keep the swizzles' phase, so a copy's shared offset is the first
  // one's plus a constant.
  constexpr int WCH = RB / 16;                   // 16-byte chunks a W row
  constexpr int XC = BMX * 8 / NT, WC = BN * WCH / NT;
  static_assert(XC * NT == BMX * 8 && WC * NT == BN * WCH,
                "copies must tile the stage");
  const int cx = tid % 8, rx = tid / 8, cw = tid % WCH, rw = tid / WCH;
  const int8_t* xg = x + (size_t)(m0 + rx) * K + cx * 16;
  const int8_t* wg = w + (size_t)(n0 + rw) * Kp + cw * 16;
  const int xo = swz_x(rx, cx * 16), wo = swz_w<RB>(rw, cw * 16);

  auto load = [&](int s) {
    int8_t* d = xs + (s % STAGES) * XS + xo;
    int ko = (k_begin + s) * BK;
    int n = min(max(K - ko - cx * 16, 0), 16);   // bytes within K
#pragma unroll
    for (int j = 0; j < XC; ++j) {
      const int r = j * (NT / 8);
      copy16(d + r * BK, xg + (size_t)r * K + ko,
             m0 + rx + r < M ? n : 0, xvec, x);
    }
    d = ws + (s % STAGES) * WS + wo;
    ko = (k_begin + s) * RB;
    n = min(max(Kp - ko - cw * 16, 0), 16);
#pragma unroll
    for (int j = 0; j < WC; ++j) {
      const int r = j * (NT / WCH);
      copy16(d + r * RB, wg + (size_t)r * Kp + ko,
             n0 + rw + r < N ? n : 0, wvec, w);
    }
  };

  int acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < KT) load(s);
    cp_commit();
  }

  uint32_t a[2][4];
  for (int kt = 0; kt < KT; ++kt) {
    // step kt has landed; make it visible to wgmma (the async proxy).
    // Every warpgroup is done with step kt - STAGES + AHEAD (one wgmma of
    // step kt - 1 may still run unless drained here), so its ring slot
    // takes step kt + AHEAD.
    if constexpr (AHEAD == STAGES - 1) wgmma_wait<0>();
    cp_wait<AHEAD - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + AHEAD < KT) load(kt + AHEAD);
    cp_commit();

    const int8_t* wt = ws + (kt % STAGES) * WS;
    const uint32_t xa = smem_addr(xs + (kt % STAGES) * XS);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // the fragment buffer of the wgmma before last, which has finished
      load_a<BITS>(wt, r0, kk, t, a[kk & 1]);
      wgmma_fence();
      wgmma_x<BMX>(acc, a[kk & 1], desc_sw128(xa + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < ACC; ++i) fence_reg(acc[i]);
  cp_wait<0>();

  if (splits > 1) {
    // every block adds its int32 sums into the tile's workspace (exact in
    // any order); the tile's last block to finish takes the total, leaves
    // the workspace and the count at zero for the next launch, and stores
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* sum = part + (size_t)tile * ACC * NT + tid;
#pragma unroll
    for (int i = 0; i < ACC; ++i) atomicAdd(sum + (size_t)i * NT, acc[i]);
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) last = atomicAdd(count + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = atomicExch(sum + (size_t)i * NT, 0);
    if (tid == 0) count[tile] = 0;
  }

  // sum 4j + 2h + e: W row r0 + 8h, X row 8j + 2t + e
  const float s = sx[0];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r0 + 8 * h;
    if (n >= N) continue;
    const float sn = sw[n];
#pragma unroll
    for (int j = 0; j < BMX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        // the sums carry 2^(8 - BITS): shift it out (exact), then
        // float(acc) * sw[n] * sx, in that order (two roundings, no FMA)
        if (m < M)
          y[(size_t)m * N + n] =
              ((float)(acc[4 * j + 2 * h + e] >> (8 - BITS)) * sn) * s;
      }
  }
}

// Decode layout (M <= 8): mma.sync.m16n8k32 s8 with the operands swapped,
// Y^T = W X^T, so n = 8 is the decode batch.  A warp owns 16 W rows (a
// row tile) and one of `ks` slices of K; a block of MV_WARPS warps holds
// MV_WARPS / ks row tiles, and its slices add their int32 sums in shared
// memory (exact, no atomics, one launch).  K is walked in groups of GK
// values, 64 packed bytes of a row: lane (g, t) loads bytes [16t, 16t + 16)
// of rows g and g + 8 -- whole 16-byte vectors, every byte used, four lanes
// covering 64 contiguous bytes of a row -- and uses them as its A fragments
// of the group's MPG k32 steps: within a group K is permuted alike for W
// and X, so that lane t's VPL consecutive values are the positions 4t..4t+3
// and 16+4t..16+4t+3 of each step.  The values are unpacked in registers
// into the top bits of their bytes (unpack_top4 / unpack_top2, shared with
// the tiles); the int32 sum is shifted back, exactly, in the epilogue.  X
// is staged once per block (at most MV_XCHUNK values of K at a time) in
// shared memory by cp.async, in order, so that a warp's copies coalesce,
// with rows padded so that the B fragments (lane t's VPL bytes) load
// without bank conflicts; rows M..7 are zero-filled.  Each lane keeps MV_RING groups of weight vectors
// in flight in a register ring, refilled as each group is consumed.
constexpr int MV_ROWS = 8;        // max M of the decode layout: mma's n
constexpr int MV_WARPS = 8;       // warps a block
constexpr int MV_RING = 4;        // groups of weight vectors a lane has in flight
constexpr int MV_XCHUNK = 8192;   // values of K staged at once (a multiple of GK)
constexpr int MV_RED = MV_WARPS * 32 * 16;   // bytes of split-K sums

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// X row stride in shared memory for a staged chunk of kc values: past a
// multiple of 128 bytes by as much as puts the two X rows a quarter-warp
// reads (lanes t = 0..3 of rows g and g + 1, VPL bytes each) in disjoint
// banks -- 64 at 8-bit, 16 at 4-bit; at 2-bit lanes t and t + 2 of a row
// share banks whatever the stride, and 32 keeps it to that 2-way conflict
template <int BITS>
__host__ __device__ constexpr int mv_stride(int kc) {
  return (kc + 127) / 128 * 128 + (BITS == 8 ? 64 : BITS == 4 ? 16 : 32);
}

template <int BITS>
__global__ void __launch_bounds__(32 * MV_WARPS)
qmv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sw, const float* __restrict__ sx,
           float* __restrict__ y, int M, int N, int K, int Kp, int ks) {
  constexpr int VPL = 128 / BITS;  // values in a lane's 16-byte W vector
  constexpr int GK = 4 * VPL;      // values of a group
  constexpr int CPL = VPL / 16;    // 16-byte X chunks a lane reads a group
  constexpr int MPG = VPL / 8;     // k32 steps a group
  extern __shared__ __align__(16) int8_t xs[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nw = MV_WARPS / ks;              // row tiles a block
  const int slice = warp / nw;
  const int n0 = (blockIdx.x * nw + warp % nw) * 16;
  const int KR = (K + GK - 1) / GK * GK;     // K in whole groups
  const int KC = min(KR, MV_XCHUNK);
  const int RS = mv_stride<BITS>(KC);
  const bool ok_lo = n0 + g < N, ok_hi = n0 + g + 8 < N;
  const int8_t* w_lo = w + (size_t)(ok_lo ? n0 + g : 0) * Kp + 16 * t;
  const int8_t* w_hi = w + (size_t)(ok_hi ? n0 + g + 8 : 0) * Kp + 16 * t;
  const int8_t* x_lane = xs + g * RS + VPL * t;

  int acc[4] = {0, 0, 0, 0};
  uint4 ring[MV_RING][2];
  for (int k0 = 0; k0 < KR; k0 += KC) {
    const int kc = min(KC, KR - k0);
    if (k0 > 0) __syncthreads();   // every warp is done with the last chunk
    // X[:, k0 : k0 + kc), rows in order (contiguous copies coalesce)
    const int nch = kc / 16;
    for (int i = tid; i < MV_ROWS * nch; i += 32 * MV_WARPS) {
      const int m = i / nch, c = i % nch;
      const int k = k0 + 16 * c;
      const int nb = m < M && k < K ? 16 : 0;
      cp_async16(smem_addr(xs + m * RS + 16 * c),
                 nb ? x + (size_t)m * K + k : x, nb);
    }
    cp_commit();

    // this warp's groups of the chunk, the first MV_RING in flight before
    // X has landed
    const int ng = kc / GK, gbase = k0 / GK;
    const int q0 = ng * slice / ks, q1 = ng * (slice + 1) / ks;
    auto fetch = [&](int q, uint4 (&v)[2]) {
      const int off = (gbase + q) * 64;
      const bool in = off + 16 * t < Kp;     // whole vectors: in or out
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      v[0] = ok_lo && in ? __ldg(reinterpret_cast<const uint4*>(w_lo + off))
                         : z;
      v[1] = ok_hi && in ? __ldg(reinterpret_cast<const uint4*>(w_hi + off))
                         : z;
    };
#pragma unroll
    for (int i = 0; i < MV_RING; ++i)
      if (q0 + i < q1) fetch(q0 + i, ring[i]);
    cp_wait<0>();
    __syncthreads();

    for (int q = q0; q < q1; q += MV_RING) {
#pragma unroll
      for (int i = 0; i < MV_RING; ++i) {
        if (q + i >= q1) break;
        uint4 xc[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          xc[c] = *reinterpret_cast<const uint4*>(x_lane + (q + i) * GK +
                                                  16 * c);
#pragma unroll
        for (int j = 0; j < MPG; ++j) {
          uint32_t a[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {      // rows g and g + 8
            uint32_t lo, hi;
            if constexpr (BITS == 8) {
              lo = word(ring[i][h], 2 * j);
              hi = word(ring[i][h], 2 * j + 1);
            } else if constexpr (BITS == 4) {
              unpack_top4(word(ring[i][h], j), lo, hi);
            } else {
              unpack_top2(word(ring[i][h], j / 2) >> (16 * (j % 2)), lo, hi);
            }
            a[h] = lo;
            a[2 + h] = hi;
          }
          mma_s8(acc, a, word(xc[j / 2], 2 * (j % 2)),
                 word(xc[j / 2], 2 * (j % 2) + 1));
        }
        if (q + i + MV_RING < q1) fetch(q + i + MV_RING, ring[i]);
      }
    }
  }

  if (ks > 1) {
    // slices 1.. hand their sums to slice 0 of the same row tile
    int4* red = reinterpret_cast<int4*>(xs + MV_ROWS * RS);
    if (slice > 0)
      red[warp * 32 + lane] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (slice > 0) return;
    for (int sl = 1; sl < ks; ++sl) {
      const int4 v = red[(sl * nw + warp) * 32 + lane];
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
  }

  // sum 2h + e: W row n0 + g + 8h, X row 2t + e
  const float s = sx[0];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + g + 8 * h;
    if (n >= N) continue;
    const float sn = sw[n];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * t + e;
      // the sums carry 2^(8 - BITS): shift it out (exact), then
      // float(acc) * sw[n] * sx, in that order (two roundings, no FMA)
      if (m < M)
        y[(size_t)m * N + n] =
            ((float)(acc[2 * h + e] >> (8 - BITS)) * sn) * s;
    }
  }
}

template <int BITS>
int launch_mv(const int8_t* x, const int8_t* w, const float* sw,
              const float* sx, float* y, int M, int N, int K, int Kp,
              cudaStream_t st) {
  constexpr int GK = 512 / BITS;
  constexpr int SMEM_MAX = MV_ROWS * mv_stride<BITS>(MV_XCHUNK) + MV_RED;
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmv_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int KR = (K + GK - 1) / GK * GK;
  const int smem =
      MV_ROWS * mv_stride<BITS>(KR < MV_XCHUNK ? KR : MV_XCHUNK) + MV_RED;
  // as many row tiles a block as still leave a block for every SM; the
  // rest of the block's warps split K
  const int tiles = (N + 15) / 16;
  int nw = MV_WARPS;
  while (nw > 1 && (tiles + nw - 1) / nw < SMS) nw /= 2;
  qmv_kernel<BITS><<<(tiles + nw - 1) / nw, 32 * MV_WARPS, smem, st>>>(
      x, w, sw, sx, y, M, N, K, Kp, MV_WARPS / nw);
  return (int)cudaGetLastError();
}

// widest copy (16, 4 or 1 bytes) that every row of a matrix at `p` with
// row stride `stride` bytes allows
int copy_width(const void* p, int stride) {
  const uintptr_t a = (uintptr_t)p;
  if (stride % 16 == 0 && a % 16 == 0) return 16;
  if (stride % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

template <int BITS, int BMX, int WG>
int launch_tiles(const int8_t* x, const int8_t* w, const float* sw,
                 const float* sx, float* y, int M, int N, int K, int Kp,
                 int* part, int* count, cudaStream_t st) {
  constexpr int BN = 64 * WG;
  static_assert((long long)COUNT_INTS * BN * BMX <= PART_INTS,
                "split-K scratch too small");
  constexpr int smem =
      stages(BITS, WG) * (BMX * BK + BN * BK * BITS / 8) + 1024;
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<BITS, BMX, WG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // a grid of tiles for under half the SMs is a chain of K steps on a
  // few SMs: split its K steps, keeping two or more a block
  const int gx = (N + BN - 1) / BN, gy = (M + BMX - 1) / BMX;
  const int steps = (K + BK - 1) / BK;
  int splits = 1;
  if (2 * gx * gy <= SMS)
    splits = max(1, min(min(SMS / (gx * gy), steps / 2), MAX_SPLITS));
  qmm_kernel<BITS, BMX, WG><<<dim3(gx, gy, splits), 128 * WG, smem, st>>>(
      x, w, sw, sx, y, M, N, K, Kp, copy_width(x, K), copy_width(w, Kp),
      splits, part, count);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_tiles(const int8_t* x, const int8_t* w, const float* sw,
                 const float* sx, float* y, int M, int N, int K, int Kp,
                 int* part, int* count, cudaStream_t st) {
  if (M <= 64)
    return launch_tiles<BITS, 64, 2>(x, w, sw, sx, y, M, N, K, Kp, part,
                                     count, st);
  // 256 W rows a block (four warpgroups, one block an SM) read the X
  // tiles half as often as 128 (two warpgroups, two blocks an SM), but a
  // grid of more than a wave of them leaves a long last wave, and one for
  // under half the SMs splits K over twice the sums a block
  const long long wide = (long long)((N + 255) / 256) * ((M + 127) / 128);
  if (2 * wide > SMS && wide <= SMS)
    return launch_tiles<BITS, 128, 4>(x, w, sw, sx, y, M, N, K, Kp, part,
                                      count, st);
  return launch_tiles<BITS, 128, 2>(x, w, sw, sx, y, M, N, K, Kp, part,
                                    count, st);
}

}  // namespace

// int32 elements of the split-K scratch a launch needs, all zeros and left
// zero by every launch: which = 0 for the tiles' sums, 1 for the arrival
// counts
extern "C" long long qmm_scratch_ints(int which) {
  return which == 0 ? PART_INTS : COUNT_INTS;
}

extern "C" int qmm_launch(const void* x, const void* w, const void* sw,
                          const void* sx, void* y, int M, int N, int K,
                          int Kp, int bits, void* part, long long part_len,
                          void* count, long long count_len, void* stream) {
  if (K >= MAX_K || part_len < PART_INTS || count_len < COUNT_INTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  const float* swp = (const float*)sw;
  const float* sxp = (const float*)sx;
  float* yp = (float*)y;
  int* pp = (int*)part;
  int* cp = (int*)count;
  // decode shapes (a few rows, whole 16-byte weight vectors, no padded
  // values, 16-byte aligned operands) take the mma.sync decode layout; the
  // rest the tiles
  const bool decode = M <= MV_ROWS && K % 4 == 0 && Kp % 16 == 0 &&
                      K == Kp * (8 / bits) && (uintptr_t)x % 16 == 0 &&
                      (uintptr_t)w % 16 == 0;
  if (decode) {
    switch (bits) {
      case 8: return launch_mv<8>(xp, wp, swp, sxp, yp, M, N, K, Kp, st);
      case 4: return launch_mv<4>(xp, wp, swp, sxp, yp, M, N, K, Kp, st);
      case 2: return launch_mv<2>(xp, wp, swp, sxp, yp, M, N, K, Kp, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    case 8: return launch_tiles<8>(xp, wp, swp, sxp, yp, M, N, K, Kp, pp, cp, st);
    case 4: return launch_tiles<4>(xp, wp, swp, sxp, yp, M, N, K, Kp, pp, cp, st);
    case 2: return launch_tiles<2>(xp, wp, swp, sxp, yp, M, N, K, Kp, pp, cp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
