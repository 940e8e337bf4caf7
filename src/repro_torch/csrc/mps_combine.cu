// K4: fused multi-precision fake-quant + convex combine (paper Eq. 5).
//
// Replaces the TPU kernel src/repro/kernels/mps_combine/kernel.py
// (_combine_kernel, launched by mps_combine_fwd):
//
//     out[m, k] = sum_p probs[m, p] * clip(round(W[m, k] / s_p), +-qmax_p) * s_p
//     s_p       = max(absmax_m, 1e-8) * (1 / qmax_p),   qmax_p = 2^(bits_p - 1) - 1
//
// (the reference runs under jax.jit, where XLA turns the division by the
// constant qmax into a multiplication by its float32 reciprocal; so do the
// plain version and this kernel)
//
// W is f32 (M, K) row-major (a conv weight (C_out, C_in, kh, kw) viewed as
// (C_out, C_in * kh * kw): the row absmax over the flattened rest is the
// per-output-channel absmax), probs f32 (M, P), out f32 (M, K).  The
// 0-bit precision contributes nothing and is skipped.
//
// What bounds it on the H100: per element it does P divisions, roundings
// and multiply-adds on one f32 read and one f32 write, a few tens of
// operations per 8 bytes -- far below the ~20 f32 operations per byte at
// which the CUDA cores, not HBM, become the limit.  It is bound by bytes.
// The TPU kernel took the row absmax as a second input (an extra pass of W
// in XLA); here one block owns whole rows: it reads its row once with
// 16-byte loads into shared memory while reducing the absmax, then
// combines from shared memory and writes the row once -- one read and one
// write of W.  Rows too long for shared memory re-read W (an L2 hit).
//
// Bit equality with the plain version (kernels/mps_combine/ref.py): every
// step is one IEEE-rounded operation in the plain version's order --
// __fmul_rn by the reciprocal for the scale, __fdiv_rn for the ratio,
// rintf (half to even, like torch.round), __fmul_rn and __fadd_rn
// accumulating in precision order from 0.  nvcc would otherwise contract
// acc + p * q into an FMA.
// No tensor-core, TMA or multi-row tiling yet: one 256-thread block a row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAXP = 8;
constexpr int STAGE_MAX_BYTES = 200 * 1024;

__device__ __forceinline__ float combine(float x, int P, const float* qmax,
                                         const float* scale,
                                         const float* prob) {
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) {
    if (qmax[p] < 0.0f) continue;              // 0-bit: pruned, adds zero
    float r = rintf(__fdiv_rn(x, scale[p]));
    r = fminf(fmaxf(r, -qmax[p]), qmax[p]);
    acc = __fadd_rn(acc, __fmul_rn(prob[p], __fmul_rn(r, scale[p])));
  }
  return acc;
}

template <bool VEC, bool STAGE>
__global__ void __launch_bounds__(NT)
mps_combine_kernel(const float* __restrict__ w, const float* __restrict__ probs,
                   float* __restrict__ out, int K, int P,
                   unsigned long long packed_bits) {
  extern __shared__ float4 srow4[];
  float* srow = reinterpret_cast<float*>(srow4);
  __shared__ float red[NT / 32];
  __shared__ float s_qmax[MAXP], s_scale[MAXP], s_prob[MAXP];
  const size_t row = blockIdx.x;
  const float* wr = w + row * (size_t)K;
  float* orow = out + row * (size_t)K;
  const int tid = threadIdx.x;

  // pass 1: stage the row and reduce its absmax
  float m = 0.0f;
  if (VEC) {
    const float4* w4 = reinterpret_cast<const float4*>(wr);
    for (int i = tid; i < K / 4; i += NT) {
      float4 v = w4[i];
      if (STAGE) srow4[i] = v;
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = tid; i < K; i += NT) {
      float v = wr[i];
      if (STAGE) srow[i] = v;
      m = fmaxf(m, fabsf(v));
    }
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    float v = tid < NT / 32 ? red[tid] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (tid == 0) red[0] = v;
  }
  __syncthreads();
  if (tid < P) {
    const int bits = (int)((packed_bits >> (8 * tid)) & 0xffu);
    const float qmax = bits ? (float)((1 << (bits - 1)) - 1) : -1.0f;
    s_qmax[tid] = qmax;
    s_scale[tid] = bits ? __fmul_rn(fmaxf(red[0], 1e-8f), __fdiv_rn(1.0f, qmax))
                        : 0.0f;
    s_prob[tid] = probs[row * (size_t)P + tid];
  }
  __syncthreads();

  // pass 2: combine and write the row once
  const float* src = STAGE ? srow : wr;
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = tid; i < K / 4; i += NT) {
      float4 v = s4[i];
      v.x = combine(v.x, P, s_qmax, s_scale, s_prob);
      v.y = combine(v.y, P, s_qmax, s_scale, s_prob);
      v.z = combine(v.z, P, s_qmax, s_scale, s_prob);
      v.w = combine(v.w, P, s_qmax, s_scale, s_prob);
      o4[i] = v;
    }
  } else {
    for (int i = tid; i < K; i += NT)
      orow[i] = combine(src[i], P, s_qmax, s_scale, s_prob);
  }
}

template <bool VEC, bool STAGE>
int launch(const float* w, const float* probs, float* out, int M, int K,
           int P, unsigned long long packed, cudaStream_t st) {
  const size_t smem = STAGE ? (size_t)K * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mps_combine_kernel<VEC, STAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mps_combine_kernel<VEC, STAGE><<<M, NT, smem, st>>>(w, probs, out, K, P,
                                                       packed);
  return (int)cudaGetLastError();
}

}  // namespace

// packed_bits holds the P precisions, one byte each, precision p in byte p.
extern "C" int mps_combine_launch(const void* w, const void* probs, void* out,
                                  int M, int K, int P,
                                  unsigned long long packed_bits,
                                  void* stream) {
  if (P < 1 || P > MAXP || M < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* wp = (const float*)w;
  const float* pp = (const float*)probs;
  float* op = (float*)out;
  const bool vec = K % 4 == 0 && (uintptr_t)w % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const bool stage = (size_t)K * sizeof(float) <= STAGE_MAX_BYTES;
  if (vec && stage) return launch<true, true>(wp, pp, op, M, K, P, packed_bits, st);
  if (vec) return launch<true, false>(wp, pp, op, M, K, P, packed_bits, st);
  if (stage) return launch<false, true>(wp, pp, op, M, K, P, packed_bits, st);
  return launch<false, false>(wp, pp, op, M, K, P, packed_bits, st);
}
