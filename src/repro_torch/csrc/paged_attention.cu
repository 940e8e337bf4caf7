// K2: one-token decode attention read in place from a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_attn_kernel, launched by paged_attention_fwd; its math is in
// page_update, page_mask and page_live).
//
//   q (B, H, D); k_pool / v_pool (n_pages + 1, page_size, Hkv, D), physical
//   page 0 the null page; tables (B, *) int32 with row stride tstride, of
//   which the first P entries are read; pos (B,) int32 -> out (B, H, D).
//   q, pools and out share one type: float32 or bfloat16.
//
// What bounds it on the H100: every live K/V byte is read once and used
// for 2*G multiply-adds per element (G = H / Hkv query heads share a KV
// head), a few operations per byte -- bound by the bytes of the live pages.
// The design reads only those: one block per (slot, KV head) walks the
// slot's table row, reads tables[b, p] and pos[b] itself and skips a dead
// page (null, past pos, or wholly below the window) BEFORE loading it, so
// a NaN-poisoned null page is never touched and traffic scales with the
// tokens held, not with max_len.  The G query heads of the group are
// served from one shared K/V page (no head repeat).  Softmax is online in
// f32 (running max m, denominator l, accumulator acc in shared memory);
// masked scores are -1e30 like the reference; the output is
// acc / max(l, 1e-30), so an all-null row gives zeros.  No split over
// pages yet (flash-decoding), so B * Hkv blocks is all the parallelism.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out, int H,
                    int Hkv, int D, int PS, int P, int tstride, int window,
                    int chunked, float cap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int G = H / Hkv;
  const int DP = D + 1;            // padded row: conflict-free K reads
  float* qs = sm;                  // G x DP
  float* ks = qs + G * DP;         // PS x DP
  float* vs = ks + PS * DP;        // PS x D
  float* ss = vs + PS * D;         // G x PS scores, then probabilities
  float* acc = ss + G * PS;        // G x D
  float* mr = acc + G * D;         // G running max
  float* lr = mr + G;              // G running denominator
  float* cr = lr + G;              // G rescale factor of this page
  const int tid = threadIdx.x;
  const int posn = pos[b];

  for (int i = tid; i < G * D; i += NT) {
    const int gi = i / D, d = i % D;
    qs[gi * DP + d] = to_f(q[((size_t)b * H + g * G + gi) * D + d]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += NT) {
    mr[i] = NEG;
    lr[i] = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int phys = tables[(size_t)b * tstride + p];
    const int p0 = p * PS;
    const int pe = p0 + PS - 1;
    bool live = phys != 0 && p0 <= posn;
    if (window > 0 && !chunked) live = live && pe > posn - window;
    if (window > 0 && chunked) live = live && pe >= (posn / window) * window;
    if (!live) continue;           // the same for every thread of the block

    for (int i = tid; i < PS * D; i += NT) {
      const int t = i / D, d = i % D;
      const size_t off = (((size_t)phys * PS + t) * Hkv + g) * D + d;
      ks[t * DP + d] = to_f(kp[off]);
      vs[i] = to_f(vp[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * PS; i += NT) {
      const int gi = i / PS, t = i % PS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[gi * DP + d], ks[t * DP + d], s);
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int pk = p0 + t;
      bool ok = pk <= posn;
      if (window > 0 && !chunked) ok = ok && pk > posn - window;
      if (window > 0 && chunked) ok = ok && (pk / window) == (posn / window);
      ss[i] = ok ? s : NEG;
    }
    __syncthreads();
    for (int gi = tid; gi < G; gi += NT) {
      float mx = mr[gi];
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, ss[gi * PS + t]);
      float sum = 0.f;
      for (int t = 0; t < PS; ++t) {
        const float e = expf(ss[gi * PS + t] - mx);
        ss[gi * PS + t] = e;
        sum += e;
      }
      const float c = expf(mr[gi] - mx);
      lr[gi] = lr[gi] * c + sum;
      mr[gi] = mx;
      cr[gi] = c;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int gi = i / D, d = i % D;
      float a = 0.f;
      for (int t = 0; t < PS; ++t) a = fmaf(ss[gi * PS + t], vs[t * D + d], a);
      acc[i] = acc[i] * cr[gi] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += NT) {
    const int gi = i / D, d = i % D;
    out[((size_t)b * H + g * G + gi) * D + d] =
        from_f<T>(acc[i] / fmaxf(lr[gi], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* pos, void* out, int B, int H, int Hkv, int D, int PS,
           int P, int tstride, int window, int chunked, float cap,
           float scale, cudaStream_t st) {
  const int G = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * (D + 1) + (size_t)PS * (D + 1) +
                       (size_t)PS * D + (size_t)G * PS + (size_t)G * D + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<dim3(B, Hkv), NT, smem, st>>>(
      (const T*)q, (const T*)kp, (const T*)vp, tables, pos, (T*)out, H, Hkv,
      D, PS, P, tstride, window, chunked, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* pos, void* out, int B, int H,
                                   int Hkv, int D, int PS, int P, int tstride,
                                   int window, int chunked, float cap,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* ps = (const int*)pos;
  if (dtype == 0)
    return launch<float>(q, kp, vp, tb, ps, out, B, H, Hkv, D, PS, P, tstride,
                         window, chunked, cap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tb, ps, out, B, H, Hkv, D, PS, P,
                                 tstride, window, chunked, cap, scale, st);
  return (int)cudaErrorInvalidValue;
}
