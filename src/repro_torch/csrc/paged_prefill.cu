// K3: causal prompt attention read in place from a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/prefill.py
// (_paged_prefill_kernel, launched by paged_prefill_fwd; its math is in
// prefill_page_update, prefill_page_mask and prefill_page_live).
//
//   q (B, S, H, D) with S a multiple of QC; k_pool / v_pool
//   (n_pages + 1, page_size, Hkv, D), physical page 0 the null page;
//   tables (B, *) int32 with row stride tstride, of which the first P
//   entries are read -> out (B, S, H, D).  Masking is by position
//   (pos_k <= pos_q plus the window variants); the prompt lengths are not
//   needed, and padded query rows give finite garbage the caller drops.
//   q, pools and out share one type: float32 or bfloat16.
//
// What bounds it on the H100: each block re-reads the live pages of its
// slot for its own QC queries, doing 4*QC*G*D operations per K/V pair of
// rows; at QC = 16, G = 4 that is ~32 f32 operations per byte, well under
// the f32 line, so the kernel is bound by the bytes it reads -- and, being
// written with CUDA-core FMAs rather than wgmma, by the f32 rate of the
// CUDA cores once the pages sit in L2.  The design bounds the traffic: one
// block per (slot, q chunk, KV head) walks the table and skips, before any
// load, a page that is null, wholly above the chunk's last query or wholly
// below its window, and serves the G query heads of the group from one
// shared K/V page.  Every (query, head) row keeps its own f32 online
// softmax, so the result does not depend on the chunk width QC.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ tables,
                     T* __restrict__ out, int S, int H, int Hkv, int D,
                     int PS, int P, int tstride, int QC, int window,
                     int chunked, float cap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, c = blockIdx.y, g = blockIdx.z;
  const int G = H / Hkv;
  const int R = QC * G;            // rows: (query in chunk, head in group)
  const int DP = D + 1;
  float* qs = sm;                  // R x DP
  float* ks = qs + R * DP;         // PS x DP
  float* vs = ks + PS * DP;        // PS x D
  float* ss = vs + PS * D;         // R x PS
  float* acc = ss + R * PS;        // R x D
  float* mr = acc + R * D;         // R
  float* lr = mr + R;              // R
  float* cr = lr + R;              // R
  const int tid = threadIdx.x;
  const int q0 = c * QC;           // position of the chunk's first query
  const int q1 = q0 + QC - 1;      // ... and of its last

  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qi = r / G, gi = r % G;
    qs[r * DP + d] =
        to_f(q[(((size_t)b * S + q0 + qi) * H + g * G + gi) * D + d]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < R; i += NT) {
    mr[i] = NEG;
    lr[i] = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int phys = tables[(size_t)b * tstride + p];
    const int p0 = p * PS;
    const int pe = p0 + PS - 1;
    bool live = phys != 0 && p0 <= q1;
    if (window > 0 && !chunked) live = live && pe > q0 - window;
    if (window > 0 && chunked) live = live && pe >= (q0 / window) * window;
    if (!live) continue;           // the same for every thread of the block

    for (int i = tid; i < PS * D; i += NT) {
      const int t = i / D, d = i % D;
      const size_t off = (((size_t)phys * PS + t) * Hkv + g) * D + d;
      ks[t * DP + d] = to_f(kp[off]);
      vs[i] = to_f(vp[off]);
    }
    __syncthreads();
    for (int i = tid; i < R * PS; i += NT) {
      const int r = i / PS, t = i % PS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[r * DP + d], ks[t * DP + d], s);
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int pq = q0 + r / G, pk = p0 + t;
      bool ok = pk <= pq;
      if (window > 0 && !chunked) ok = ok && pk > pq - window;
      if (window > 0 && chunked) ok = ok && (pk / window) == (pq / window);
      ss[i] = ok ? s : NEG;
    }
    __syncthreads();
    for (int r = tid; r < R; r += NT) {
      float mx = mr[r];
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, ss[r * PS + t]);
      float sum = 0.f;
      for (int t = 0; t < PS; ++t) {
        const float e = expf(ss[r * PS + t] - mx);
        ss[r * PS + t] = e;
        sum += e;
      }
      const float cf = expf(mr[r] - mx);
      lr[r] = lr[r] * cf + sum;
      mr[r] = mx;
      cr[r] = cf;
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, d = i % D;
      float a = 0.f;
      for (int t = 0; t < PS; ++t) a = fmaf(ss[r * PS + t], vs[t * D + d], a);
      acc[i] = acc[i] * cr[r] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qi = r / G, gi = r % G;
    out[(((size_t)b * S + q0 + qi) * H + g * G + gi) * D + d] =
        from_f<T>(acc[i] / fmaxf(lr[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           void* out, int B, int S, int H, int Hkv, int D, int PS, int P,
           int tstride, int QC, int window, int chunked, float cap,
           float scale, cudaStream_t st) {
  const int R = QC * (H / Hkv);
  const size_t smem =
      sizeof(float) * ((size_t)R * (D + 1) + (size_t)PS * (D + 1) +
                       (size_t)PS * D + (size_t)R * PS + (size_t)R * D + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_prefill_kernel<T><<<dim3(B, S / QC, Hkv), NT, smem, st>>>(
      (const T*)q, (const T*)kp, (const T*)vp, tables, (T*)out, S, H, Hkv, D,
      PS, P, tstride, QC, window, chunked, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int paged_prefill_launch(const void* q, const void* kp,
                                    const void* vp, const void* tables,
                                    void* out, int B, int S, int H, int Hkv,
                                    int D, int PS, int P, int tstride, int QC,
                                    int window, int chunked, float cap,
                                    float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  if (dtype == 0)
    return launch<float>(q, kp, vp, tb, out, B, S, H, Hkv, D, PS, P, tstride,
                         QC, window, chunked, cap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tb, out, B, S, H, Hkv, D, PS, P,
                                 tstride, QC, window, chunked, cap, scale, st);
  return (int)cudaErrorInvalidValue;
}
