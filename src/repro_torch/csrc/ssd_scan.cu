// K5: the Mamba-2 SSD inter-chunk state recurrence.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
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
// What bounds it on the H100: one multiply and one add per element and
// chunk against 8 bytes moved (s_in read, prefix written) -- far below
// the ~20 f32 operations per byte at which the CUDA cores, not HBM, would
// limit.  It is bound by bytes.  The TPU kernel carried the state in its
// output block across a sequential grid axis over C.  Here the state
// elements are independent, so one thread owns four neighbouring state
// elements (one float4, n fastest) for the whole scan: it keeps them in
// registers, walks the C chunks in order, and moves each s_in and prefix
// element once, in 16-byte accesses.  The loads of U chunks' s_in do not
// depend on the state and are issued before the U updates that use them,
// so each thread keeps several loads in flight.  Every thread of a warp
// reads the same decay[c, h] (P * N elements share one head): a broadcast.
//
// Bit equality with the plain version (kernels/ssd_scan/ref.py): the
// update is __fadd_rn(__fmul_rn(decay, state), s_in), the plain version's
// separate multiply and add; nvcc would otherwise contract it into an FMA.
// Shapes whose P * N is not a multiple of 4, or misaligned views, take the
// same loop one float at a time.  No TMA or cross-block split of C yet.
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
