// K5: the Mamba-2 SSD inter-chunk state recurrence, and its reverse.
//
// Forward, replacing the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_fwd):
//
//     prefix[c] = state                            (the state before chunk c)
//     state     = decay[c, h] * state + s_in[c]    from state = s0
//     final     = state after the last chunk
//
// decay is f32 (C, H); s_in and prefix f32 (C, H, P, N); s0 and final
// f32 (H, P, N); all row-major.  The Mamba-2 prefill runs it over
// (C, B * heads, head_dim, state) between its batched intra-chunk passes.
//
// Backward (ssd_scan_bwd_kernel), replacing the gradient JAX takes of the
// reference's inline scan (src/repro/nn/blocks.py, mamba2_layer's
// lax.scan over chunks), which has no TPU kernel of its own: from
// G = dfinal (or 0), for c = C-1 .. 0,
//
//     ds_in[c]     = G
//     ddecay[c, h] = sum over (p, n) of G * prefix[c]
//     G            = dprefix[c] + decay[c, h] * G
//
// and ds0 = G.  It reads prefix and dprefix and writes ds_in: 12 bytes an
// element and chunk against two multiplies and two adds, bound by bytes
// as the forward is.
//
// What bounds the forward on the H100: one multiply and one add per
// element and chunk against 8 bytes moved (s_in read, prefix written) --
// far below the ~20 f32 operations per byte at which the CUDA cores, not
// HBM, would limit.  It is bound by bytes.  The TPU kernel carried the
// state in its output block across a sequential grid axis over C.  Here
// the state elements are independent, so one thread owns four
// neighbouring state elements (one float4, n fastest) for the whole scan:
// it keeps them in registers, walks the C chunks in order, and moves each
// s_in and prefix element once, in 16-byte accesses.  The loads of U
// chunks' s_in do not depend on the state and are issued before the U
// updates that use them, so each thread keeps several loads in flight.
// Every thread of a warp reads the same decay[c, h] (P * N elements share
// one head): a broadcast.  The backward keeps that layout and walks the
// chunks from the last, U chunks' prefix and dprefix loads in flight.
// Its ddecay is a sum over a whole head, which spans several blocks: each
// block reduces its products for each chunk in a fixed tree (a thread's
// four, then the warp by shuffles, then the warps in shared memory) into a
// (C, H, blocks a head) scratch, and a second kernel adds a head's block
// sums in block order.  No float atomics, so ddecay is the same from run
// to run.
//
// Bit equality with the plain versions (kernels/ssd_scan/ref.py): each
// update is __fadd_rn(__fmul_rn(decay, state), x), the plain version's
// separate multiply and add; nvcc would otherwise contract it into an FMA.
// So prefix, final, ds_in and ds0 are bitwise.  ddecay sums in another
// order than torch's, within 2 * P * N * 2^-24 * sum |G * prefix|.
// Shapes whose P * N is not a multiple of 4, or misaligned views, take the
// same loops one float at a time.  No TMA or cross-block split of C yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int U = 4;      // chunks whose s_in loads are in flight at once

__device__ __forceinline__ float step(float d, float s, float x) {
  return __fadd_rn(__fmul_rn(d, s), x);
}

__device__ __forceinline__ float4 step(float d, float4 s, float4 x) {
  return make_float4(step(d, s.x, x.x), step(d, s.y, x.y),
                     step(d, s.z, x.z), step(d, s.w, x.w));
}

template <typename V>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ dec, const V* __restrict__ s_in,
                const V* __restrict__ s0, V* __restrict__ prefix,
                V* __restrict__ final_state, int C, int H, int PN) {
  constexpr int W = sizeof(V) / sizeof(float);
  const size_t n_vec = (size_t)H * PN / W;
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n_vec) return;
  const int h = (int)(i * W / PN);
  V st = s0[i];
  for (int c0 = 0; c0 < C; c0 += U) {
    V in[U];
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < C) {
        in[u] = s_in[(size_t)(c0 + u) * n_vec + i];
        d[u] = dec[(size_t)(c0 + u) * H + h];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < C) {
        prefix[(size_t)(c0 + u) * n_vec + i] = st;
        st = step(d[u], st, in[u]);
      }
    }
  }
  final_state[i] = st;
}

// The backward's products of a thread for one chunk: its W products
// G * prefix, summed in a fixed order.
__device__ __forceinline__ float dot(float g, float p) {
  return __fmul_rn(g, p);
}

__device__ __forceinline__ float dot(float4 g, float4 p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g.x, p.x), __fmul_rn(g.y, p.y)),
                   __fadd_rn(__fmul_rn(g.z, p.z), __fmul_rn(g.w, p.w)));
}

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// grid (blocks a head, H): block (b, h) owns vectors b * NT .. b * NT +
// NT - 1 of head h.  partial[(c * H + h) * gridDim.x + b] gets the block's
// sum of G * prefix[c] over its elements.  dfinal may be null (zeros).
template <typename V>
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_kernel(const float* __restrict__ dec,
                    const V* __restrict__ prefix,
                    const V* __restrict__ dprefix,
                    const V* __restrict__ dfinal, V* __restrict__ ds_in,
                    V* __restrict__ ds0, float* __restrict__ partial, int C,
                    int H, int PN) {
  constexpr int W = sizeof(V) / sizeof(float);
  constexpr int WARPS = NT / 32;
  __shared__ float red[U][WARPS];
  const int per_head = PN / W;
  const int h = blockIdx.y;
  const int j = blockIdx.x * NT + threadIdx.x;
  const bool live = j < per_head;
  const size_t n_vec = (size_t)H * per_head;
  const size_t i = (size_t)h * per_head + j;
  V g = zero<V>();
  if (live && dfinal != nullptr) g = dfinal[i];
  for (int c1 = C; c1 > 0; c1 -= U) {     // chunks c1 - 1 down to c1 - U
    V pre[U], dp[U];
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c1 - 1 - u;
      if (live && c >= 0) {
        pre[u] = prefix[(size_t)c * n_vec + i];
        dp[u] = dprefix[(size_t)c * n_vec + i];
        d[u] = dec[(size_t)c * H + h];
      }
    }
    float part[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c1 - 1 - u;
      part[u] = 0.f;
      if (live && c >= 0) {
        ds_in[(size_t)c * n_vec + i] = g;
        part[u] = dot(g, pre[u]);
        g = step(d[u], g, dp[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = part[u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if ((threadIdx.x & 31) == 0) red[u][threadIdx.x >> 5] = v;
    }
    __syncthreads();
    if (threadIdx.x < U && c1 - 1 - (int)threadIdx.x >= 0) {
      const int c = c1 - 1 - threadIdx.x;
      float v = red[threadIdx.x][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v = __fadd_rn(v, red[threadIdx.x][w]);
      partial[((size_t)c * H + h) * gridDim.x + blockIdx.x] = v;
    }
    __syncthreads();
  }
  if (live) ds0[i] = g;
}

// ddecay[r] = the nb block sums of row r (= c * H + h), added in order.
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_sum_kernel(const float* __restrict__ partial,
                        float* __restrict__ ddecay, int rows, int nb) {
  const int r = blockIdx.x * NT + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + (size_t)r * nb;
  float v = p[0];
  for (int b = 1; b < nb; ++b) v = __fadd_rn(v, p[b]);
  ddecay[r] = v;
}

template <typename V>
int launch(const float* dec, const void* s_in, const void* s0, void* prefix,
           void* final_state, int C, int H, int PN, cudaStream_t st) {
  const size_t n_vec = (size_t)H * PN / (sizeof(V) / sizeof(float));
  const unsigned blocks = (unsigned)((n_vec + NT - 1) / NT);
  ssd_scan_kernel<V><<<blocks, NT, 0, st>>>(
      dec, (const V*)s_in, (const V*)s0, (V*)prefix, (V*)final_state, C, H,
      PN);
  return (int)cudaGetLastError();
}

int bwd_blocks(int PN, int W) { return (PN / W + NT - 1) / NT; }

template <typename V>
int launch_bwd(const float* dec, const void* prefix, const void* dprefix,
               const void* dfinal, void* ds_in, void* ds0, float* ddecay,
               float* partial, int C, int H, int PN, cudaStream_t st) {
  const int nb = bwd_blocks(PN, sizeof(V) / sizeof(float));
  ssd_scan_bwd_kernel<V><<<dim3(nb, H), NT, 0, st>>>(
      dec, (const V*)prefix, (const V*)dprefix, (const V*)dfinal, (V*)ds_in,
      (V*)ds0, partial, C, H, PN);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || C == 0) return rc;
  const int rows = C * H;
  ssd_scan_bwd_sum_kernel<<<(rows + NT - 1) / NT, NT, 0, st>>>(
      partial, ddecay, rows, nb);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" int ssd_scan_launch(const void* dec, const void* s_in,
                               const void* s0, void* prefix,
                               void* final_state, int C, int H, int PN,
                               void* stream) {
  if (C < 0 || H < 0 || PN < 0) return (int)cudaErrorInvalidValue;
  if (H == 0 || PN == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)dec;
  if (PN % 4 == 0 && aligned16(s_in) && aligned16(s0) && aligned16(prefix) &&
      aligned16(final_state))
    return launch<float4>(d, s_in, s0, prefix, final_state, C, H, PN, st);
  return launch<float>(d, s_in, s0, prefix, final_state, C, H, PN, st);
}

// Floats of the scratch ssd_scan_bwd_launch needs: C * H * the blocks a
// head of the one-float-a-thread path (the most either path takes).
extern "C" long long ssd_scan_bwd_scratch(int C, int H, int PN) {
  if (C <= 0 || H <= 0 || PN <= 0) return 0;
  return (long long)C * H * bwd_blocks(PN, 1);
}

// dfinal may be null (final unused: G starts at zero).  partial holds at
// least ssd_scan_bwd_scratch(C, H, PN) floats.
extern "C" int ssd_scan_bwd_launch(const void* dec, const void* prefix,
                                   const void* dprefix, const void* dfinal,
                                   void* ds_in, void* ds0, void* ddecay,
                                   void* partial, int C, int H, int PN,
                                   void* stream) {
  if (C < 0 || H < 0 || PN < 0 || H > 65535) return (int)cudaErrorInvalidValue;
  if (H == 0 || PN == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)dec;
  float* dd = (float*)ddecay;
  float* part = (float*)partial;
  if (PN % 4 == 0 && aligned16(prefix) && aligned16(dprefix) &&
      aligned16(dfinal) && aligned16(ds_in) && aligned16(ds0))
    return launch_bwd<float4>(d, prefix, dprefix, dfinal, ds_in, ds0, dd,
                              part, C, H, PN, st);
  return launch_bwd<float>(d, prefix, dprefix, dfinal, ds_in, ds0, dd, part,
                           C, H, PN, st);
}
