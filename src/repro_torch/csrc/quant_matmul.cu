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
// over N*Kp weight bytes, i.e. 2*M*8/bits operations per weight byte.  At
// decode (M = the batch, 8) that is far below the ~590 int8 operations per
// byte at which the tensor cores, not HBM, become the limit: decode is
// bound by the bytes of the packed weight.  A 512-row prefill is above the
// line and bound by operations; __dp4a runs on the CUDA cores, far below
// the tensor-core peak, so that case is where wgmma pays off later.  The
// design keeps the weight packed in device memory
// (a 4-bit layer moves half the bytes of an int8 one), unpacks into shared
// memory, and accumulates in int32 with __dp4a, which is exact: the
// result equals the int32 plain version bit for bit (the TPU kernel's f32
// partial sums are exact only below 2^24, which K = 8192 exceeds).
//
// Two layouts, chosen per call from the shapes:
// * tiles (prefill, ragged shapes): one 256-thread block per BM x BN
//   output tile, looping over K in BK steps; ragged M, N and K are masked,
//   never padded.  Each thread owns a 2 x 4 micro-tile.  Shared-memory
//   rows are padded by one word so the 16 weight rows a warp reads fall
//   in distinct banks.
// * decode (M <= 8, whole 16-byte weight vectors): one warp per output
//   column streams its packed weight row in coalesced 16-byte loads, so
//   N/8 blocks keep the card busy where the tiles gave only N/64.
// No tensor-core MMA, TMA or pipelining yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int KW = BK / 4 + 1;     // int32 words per shared row (+1 pad)
constexpr int ROWB = KW * 4;       // bytes per shared row

__device__ __forceinline__ int8_t sign_extend(unsigned v, int bits) {
  return (int8_t)((int)(v << (32 - bits)) >> (32 - bits));
}

template <int BITS>
__global__ void __launch_bounds__(NT)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sw, const float* __restrict__ sx,
           float* __restrict__ y, int M, int N, int K, int Kp) {
  constexpr int PER = 8 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int BKP = BK / PER;    // packed bytes per tile row
  __shared__ int xs[BM * KW];
  __shared__ int ws[BN * KW];
  int8_t* xb = reinterpret_cast<int8_t*>(xs);
  int8_t* wb = reinterpret_cast<int8_t*>(ws);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xb[r * ROWB + c] = (m < M && k < K) ? x[(size_t)m * K + k] : 0;
    }
    for (int i = tid; i < BN * BKP; i += NT) {
      const int r = i / BKP, j = i % BKP;
      const int n = n0 + r, kf = k0 + j * PER;
      const unsigned byte =
          (n < N && kf < K) ? (unsigned)(uint8_t)w[(size_t)n * Kp + kf / PER]
                            : 0u;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        wb[r * ROWB + j * PER + e] =
            (kf + e < K) ? sign_extend((byte >> (BITS * e)) & MASK, BITS) : 0;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = xs[(ty + 16 * i) * KW + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[(tx + 16 * j) * KW + kw];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = sx[0];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      // float(acc) * sw[n] * sx, in that order (two roundings, no FMA)
      if (m < M && n < N) y[(size_t)m * N + n] = ((float)acc[i][j] * sw[n]) * s;
    }
  }
}

// Decode-shaped variant (M <= 8): one warp per output column n; lanes
// stream the packed weight row in 16-byte vectors (coalesced, each byte
// read once), unpack in registers and __dp4a against x read through the
// read-only cache; warp-shuffle reduction of the M int32 sums.
constexpr int MV_ROWS = 8;        // max M of the decode variant
constexpr int MV_WARPS = 8;       // columns per block

template <int BITS>
__device__ __forceinline__ int unpack4(unsigned w, int t) {
  // int8x4 of the values 4t..4t+3 packed in the 32-bit word w
  if (BITS == 8) return (int)w;
  int out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int idx = 4 * t + e;
    const int v = (int)(w << (32 - BITS * (idx + 1))) >> (32 - BITS);
    out |= (v & 0xff) << (8 * e);
  }
  return out;
}

template <int BITS>
__global__ void __launch_bounds__(32 * MV_WARPS)
qmv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sw, const float* __restrict__ sx,
           float* __restrict__ y, int M, int N, int K, int Kp) {
  constexpr int PER = 8 / BITS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * MV_WARPS + warp;
  if (n >= N) return;
  const int kw = K / 4;                       // int32 words per x row
  const int* xw = reinterpret_cast<const int*>(x);
  const uint4* wr = reinterpret_cast<const uint4*>(w + (size_t)n * Kp);
  int acc[MV_ROWS];
#pragma unroll
  for (int m = 0; m < MV_ROWS; ++m) acc[m] = 0;
  for (int v = lane; v < Kp / 16; v += 32) {
    const uint4 pk = __ldg(wr + v);
    const unsigned words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int base = (v * 4 + q) * PER;      // x word of this packed word
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int wv = unpack4<BITS>(words[q], t);
#pragma unroll
        for (int m = 0; m < MV_ROWS; ++m)
          if (m < M) acc[m] = __dp4a(__ldg(xw + (size_t)m * kw + base + t), wv, acc[m]);
      }
    }
  }
  const float s = sx[0], scale = sw[n];
#pragma unroll
  for (int m = 0; m < MV_ROWS; ++m) {
    int a = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0 && m < M) y[(size_t)m * N + n] = ((float)a * scale) * s;
  }
}

}  // namespace

extern "C" int qmm_launch(const void* x, const void* w, const void* sw,
                          const void* sx, void* y, int M, int N, int K,
                          int Kp, int bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  const float* swp = (const float*)sw;
  const float* sxp = (const float*)sx;
  float* yp = (float*)y;
  // decode shapes (a few rows, whole 16-byte weight vectors, no padded
  // values) take the one-warp-per-column variant; the rest the tiles
  const bool decode = M <= MV_ROWS && K % 4 == 0 && Kp % 16 == 0 &&
                      K == Kp * (8 / bits) && (uintptr_t)x % 4 == 0 &&
                      (uintptr_t)w % 16 == 0;
  if (decode) {
    const dim3 grid_v((N + MV_WARPS - 1) / MV_WARPS);
    switch (bits) {
      case 8: qmv_kernel<8><<<grid_v, 32 * MV_WARPS, 0, st>>>(xp, wp, swp, sxp, yp, M, N, K, Kp); break;
      case 4: qmv_kernel<4><<<grid_v, 32 * MV_WARPS, 0, st>>>(xp, wp, swp, sxp, yp, M, N, K, Kp); break;
      case 2: qmv_kernel<2><<<grid_v, 32 * MV_WARPS, 0, st>>>(xp, wp, swp, sxp, yp, M, N, K, Kp); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  switch (bits) {
    case 8: qmm_kernel<8><<<grid, NT, 0, st>>>(xp, wp, swp, sxp, yp, M, N, K, Kp); break;
    case 4: qmm_kernel<4><<<grid, NT, 0, st>>>(xp, wp, swp, sxp, yp, M, N, K, Kp); break;
    case 2: qmm_kernel<2><<<grid, NT, 0, st>>>(xp, wp, swp, sxp, yp, M, N, K, Kp); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
