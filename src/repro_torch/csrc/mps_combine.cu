// K4: fused multi-precision fake-quant + convex combine (paper Eq. 5), and
// its straight-through backward.
//
// The forward replaces the TPU kernel src/repro/kernels/mps_combine/kernel.py
// (_combine_kernel, launched by mps_combine_fwd); the backward computes the
// reference's custom-VJP backward, src/repro/kernels/mps_combine/ops.py
// (_vjp_bwd, jnp code that XLA compiles into the search step):
//
//   out[m, k]    = sum_p probs[m, p] * Q_p(W)[m, k]
//   Q_p(W)       = clip(rint(W / s_p), +-qmax_p) * s_p
//   absmax[m]    = max_k |W[m, k]|   (or given: see below)
//   dW[m, k]     = sum_p (probs[m, p] * inside_p) * g[m, k]
//   inside_p     = 1{|r| < qmax_p} + 0.5 * 1{|r| = qmax_p},  r = W / s_p
//   dprobs[m, p] = sum_k g[m, k] * Q_p(W)[m, k]     (0 for a 0-bit p)
//   s_p          = max(absmax[m], 1e-8) * (1 / qmax_p)
//   qmax_p       = 2^(bits_p - 1) - 1
//
// (the reference runs under jax.jit, where XLA turns the division by the
// constant qmax into a multiplication by its float32 reciprocal; so do the
// plain versions and these kernels)
//
// W, g, out and dW are f32 (M, K) row-major (a conv weight (C_out, C_in,
// kh, kw) viewed as (C_out, C_in * kh * kw): the row absmax over the
// flattened rest is the per-output-channel absmax), probs and dprobs f32
// (M, P).  0-bit precisions contribute nothing and are skipped.
//
// What bounds it on the H100: bytes -- one read and one write of W forward
// (2 M K 4 bytes), reads of W and g and a write of dW backward (3 M K 4) --
// but not by much: done as the plain version does it, an element at pw
// (0, 2, 4, 8) costs some forty instructions, close to what 132 SMs issue
// in the time HBM takes for its 8 or 12 bytes.  So the design keeps the
// loads streaming while the SMs compute, and cuts the instructions to about
// seven a precision:
//
// * Ring kernel (mps_ring_kernel).  Persistent blocks, grid = SMs x blocks
//   an SM fits (not M).  A tile is R consecutive rows -- contiguous in
//   memory -- and each row is G = 8 / R consumer warps' (G = 1: a warp a
//   row, whose absmax is a warp shuffle alone; short rows fill the block
//   that way).  A ninth warp produces: for each of the block's tiles its
//   lane 0 issues one bulk copy (cp.async.bulk, TMA) per input into a ring
//   of S stages in shared memory, completion counted on the stage's full
//   mbarrier, while its lanes copy the tile's probs rows (and backward the
//   absmax) beside it.  The consumers combine a stage in place, each row
//   group's leader stores its row back with one bulk copy and releases the
//   previous tile's stage (empty mbarrier) once that copy has read it, so
//   the next rows land while this one is computed and stored.
// * The precision loop is unrolled at compile time (template NP, the count
//   of nonzero precisions); a row's scales, their reciprocals, probs and
//   limits sit in registers.
// * The division.  t = x * RN(1/s) lies within |t| 2^-22 of RN(x / s) (two
//   roundings of 2^-24 on x / s, one on RN(x / s)), and |x| <= absmax keeps
//   |t| under qmax + m, m = (qmax + 1) 2^-20, so the clip never binds.
//   rint(t) is rint(RN(x / s)) unless a half-integer lies within m of t,
//   and |RN(x / s)| < qmax (the STE mask is 1) unless |t| >= qmax - m.  The
//   fast path tests that for four elements at once without a branch; where
//   it holds -- some 3 in 10^4 elements at pw (0, 2, 4, 8), and each row's
//   absmax element backward -- it redoes the four with the plain version's
//   arithmetic (IEEE division, clip, mask).
// * Simple kernels (block a row, scalar loads, the same arithmetic) for
//   rows no bulk copy can take -- K % 4 != 0, a base off a 16-byte
//   boundary, a row too long for two stages -- and for problems too small
//   for the ring.  A ring block takes its tiles in turn behind a ~3 us
//   start (barriers, the first tile's round trip, the last store's drain);
//   a block a row puts every row in flight at once.  On the H100 the
//   simple forward was the faster at every resnet18 shape below 512 x
//   4608 (a tie there), the simple backward below 256 x 2304, so the ring
//   takes a problem of at least RING_MIN_FWD (RING_MIN_BWD) elements an
//   SM.
//
// Bit equality with the plain versions (kernels/mps_combine/ref.py and
// ops._vjp_bwd): every step is one IEEE-rounded operation in their order --
// __fmul_rn by the reciprocal for the scale, the correctly rounded quotient
// wherever it could decide, rintf (half to even, like torch.round),
// __fmul_rn and __fadd_rn accumulating in precision order from 0; dW
// likewise.  nvcc would otherwise contract acc + p * q into an FMA.  dprobs
// sums in another order (FMAs, a fixed shuffle tree, then the row's warps
// in order).
//
// A given absmax (mps_combine_given_launch): both forward kernels read each
// row's absmax from absmax_in instead of reducing the row, as the TPU kernel
// takes it (mps_combine_fwd(w, absmax, probs, ...)).  An expert bank split
// over ranks passes the all-reduced maximum over every rank's rows; any
// absmax >= the row's own max |W| keeps the fast path's bound above.
//
// mps_combine_probe is the forward ring kernel with clock64 stamps per tile
// (load issued, landed, combined, stored), for chip_smoke.py's phase split.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int MAXP = 8;
constexpr int NC = 8;                        // consumer warps of a ring block
constexpr int RING_THREADS = (NC + 1) * 32;  // and one producer warp
constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 128;               // mbarriers, before the stages
// dynamic shared memory a ring block may take when two (one) share an SM:
// the SM's 228 KB less each block's 1 KB reserve and its static arrays
constexpr int RING_SMEM_2 = 111 * 1024;
constexpr int RING_SMEM_1 = 222 * 1024;
constexpr int SIMPLE_THREADS = 256;
// the least M K an SM for which the ring kernel runs (see the note at the
// top): 2.16 M elements forward and 0.54 M backward on 132 SMs
constexpr long long RING_MIN_FWD = 16384;
constexpr long long RING_MIN_BWD = 4096;

template <int NP>
struct Quant {  // one row's quantizers, its NP nonzero precisions
  static constexpr int N = NP > 0 ? NP : 1;
  float qmax[N], s[N], inv[N], prob[N];
  // the fast path's limits (see the note at the top): |t - rint(t)| at or
  // above half, or |t| at or above edge, is within m of a decision
  float half[N], edge[N];
};

// nz_bits / nz_cols: byte p holds the bits / the probs column of the p-th
// nonzero precision
template <int NP>
__device__ __forceinline__ void row_quant(Quant<NP>& q, float absmax,
                                          const float* prow,
                                          unsigned long long nz_bits,
                                          unsigned long long nz_cols) {
  const float a = fmaxf(absmax, 1e-8f);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int bits = (int)((nz_bits >> (8 * p)) & 0xffu);
    const float qmax = (float)((1 << (bits - 1)) - 1);
    const float m = (qmax + 1.0f) * 0x1p-20f;
    q.qmax[p] = qmax;
    q.s[p] = __fmul_rn(a, __fdiv_rn(1.0f, qmax));
    q.inv[p] = __frcp_rn(q.s[p]);
    q.prob[p] = prow[(nz_cols >> (8 * p)) & 0xffu];
    q.half[p] = 0.5f - m;
    q.edge[p] = qmax - m;
  }
}

// The fast path: t = x * (1 / s) stands in for RN(x / s); `near` is set
// where it might not decide alike.  The clip never binds: |t| < qmax + m.
template <int NP>
__device__ __forceinline__ float combine_fast(float x, const Quant<NP>& q,
                                              bool& near) {
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float t = __fmul_rn(x, q.inv[p]);
    const float n = rintf(t);
    near |= fabsf(__fsub_rn(t, n)) >= q.half[p];
    acc = __fadd_rn(acc, __fmul_rn(q.prob[p], __fmul_rn(n, q.s[p])));
  }
  return acc;
}

// the plain version's arithmetic, step by step
template <int NP>
__device__ __forceinline__ float combine_exact(float x, const Quant<NP>& q) {
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float n = rintf(__fdiv_rn(x, q.s[p]));
    n = fminf(fmaxf(n, -q.qmax[p]), q.qmax[p]);
    acc = __fadd_rn(acc, __fmul_rn(q.prob[p], __fmul_rn(n, q.s[p])));
  }
  return acc;
}

// the combine of four elements: fast, and exact where any needs it
template <int NP>
__device__ __forceinline__ float4 combine4(float4 v, const Quant<NP>& q) {
  bool near = false;
  float4 o;
  o.x = combine_fast<NP>(v.x, q, near);
  o.y = combine_fast<NP>(v.y, q, near);
  o.z = combine_fast<NP>(v.z, q, near);
  o.w = combine_fast<NP>(v.w, q, near);
  if (near) {
    o.x = combine_exact<NP>(v.x, q);
    o.y = combine_exact<NP>(v.y, q);
    o.z = combine_exact<NP>(v.z, q);
    o.w = combine_exact<NP>(v.w, q);
  }
  return o;
}

template <int NP>
__device__ __forceinline__ float combine(float x, const Quant<NP>& q) {
  bool near = false;
  const float o = combine_fast<NP>(x, q, near);
  return near ? combine_exact<NP>(x, q) : o;
}

// Backward fast path: away from +-qmax the STE mask is 1.  dW of one
// element; adds g * Q_p(x) to c[p].
template <int NP>
__device__ __forceinline__ float ste_fast(float x, float g, const Quant<NP>& q,
                                          float (&c)[Quant<NP>::N],
                                          bool& near) {
  float dw = 0.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float t = __fmul_rn(x, q.inv[p]);
    const float n = rintf(t);
    near |= fabsf(__fsub_rn(t, n)) >= q.half[p] || fabsf(t) >= q.edge[p];
    dw = __fadd_rn(dw, __fmul_rn(q.prob[p], g));
    c[p] = __fmaf_rn(g, __fmul_rn(n, q.s[p]), c[p]);
  }
  return dw;
}

template <int NP>
__device__ __forceinline__ float ste_exact(float x, float g, const Quant<NP>& q,
                                           float (&c)[Quant<NP>::N]) {
  float dw = 0.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float r = __fdiv_rn(x, q.s[p]);
    const float ar = fabsf(r);
    const float inside =
        ar < q.qmax[p] ? 1.0f : (ar == q.qmax[p] ? 0.5f : 0.0f);
    const float n = fminf(fmaxf(rintf(r), -q.qmax[p]), q.qmax[p]);
    dw = __fadd_rn(dw, __fmul_rn(__fmul_rn(q.prob[p], inside), g));
    c[p] = __fmaf_rn(g, __fmul_rn(n, q.s[p]), c[p]);
  }
  return dw;
}

// dW of one element (fast, and exact where it needs it); adds its
// g * Q_p(x) to part[p]
template <int NP>
__device__ __forceinline__ float ste(float x, float g, const Quant<NP>& q,
                                     float (&part)[Quant<NP>::N]) {
  float c[Quant<NP>::N];
#pragma unroll
  for (int p = 0; p < Quant<NP>::N; ++p) c[p] = 0.0f;
  bool near = false;
  float d = ste_fast<NP>(x, g, q, c, near);
  if (near) {
#pragma unroll
    for (int p = 0; p < Quant<NP>::N; ++p) c[p] = 0.0f;
    d = ste_exact<NP>(x, g, q, c);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) part[p] = __fadd_rn(part[p], c[p]);
  return d;
}

// dW of four elements (fast, and exact where any needs it); adds their
// g * Q_p(x) to part[p]
template <int NP>
__device__ __forceinline__ float4 ste4(float4 v, float4 g, const Quant<NP>& q,
                                       float (&part)[Quant<NP>::N]) {
  float c[Quant<NP>::N];
#pragma unroll
  for (int p = 0; p < Quant<NP>::N; ++p) c[p] = 0.0f;
  bool near = false;
  float4 d;
  d.x = ste_fast<NP>(v.x, g.x, q, c, near);
  d.y = ste_fast<NP>(v.y, g.y, q, c, near);
  d.z = ste_fast<NP>(v.z, g.z, q, c, near);
  d.w = ste_fast<NP>(v.w, g.w, q, c, near);
  if (near) {
#pragma unroll
    for (int p = 0; p < Quant<NP>::N; ++p) c[p] = 0.0f;
    d.x = ste_exact<NP>(v.x, g.x, q, c);
    d.y = ste_exact<NP>(v.y, g.y, q, c);
    d.z = ste_exact<NP>(v.z, g.z, q, c);
    d.w = ste_exact<NP>(v.w, g.w, q, c);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) part[p] = __fadd_rn(part[p], c[p]);
  return d;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max_abs4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                        fmaxf(fabsf(v.z), fabsf(v.w))));
}

struct RingArgs {
  const float* w;          // (M, K)
  const float* g;          // (M, K), backward
  const float* probs;      // (M, P)
  const float* absmax_in;  // (M,): backward, or a forward's given absmax
  float* out;              // (M, K): the effective weight, or dW
  float* absmax_out;       // (M,) or null, forward
  float* dprobs;           // (M, P), backward
  long long* stamps;       // probe: 4 header ints, then 4 stamps a tile
  int M, K, P, G, R, S, tiles;
  unsigned long long nz_bits, nz_cols;
  unsigned zero_cols;      // bit c: probs column c is 0-bit
};

// the G warps of a row group meet (G = 1: the warp)
__device__ __forceinline__ void group_sync(int group, int G) {
  if (G == 1)
    __syncwarp();
  else
    named_bar_sync(1 + group, G * 32);
}

// two blocks an SM cap a thread at 96 registers; the backward at 7 and 8
// precisions needs more
constexpr int ring_blocks_per_sm(bool bwd, int np) {
  return bwd && np > 6 ? 1 : 2;
}

template <bool BWD, int NP, bool STAMP>
__global__ void __launch_bounds__(RING_THREADS, ring_blocks_per_sm(BWD, NP))
mps_ring_kernel(const RingArgs a) {
  constexpr int NIN = BWD ? 2 : 1;  // inputs streamed a stage
  extern __shared__ __align__(128) unsigned char smem[];
  // each stage's probs rows, then (backward) its rows' absmax
  __shared__ float sprm[MAX_STAGES][NC * MAXP + NC];
  // per warp: its absmax (forward) or dprobs partials (backward), by
  // tile parity
  __shared__ float sred[2][NC][MAXP];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  float* stages = reinterpret_cast<float*>(smem + BAR_BYTES);
  const size_t tile_f = (size_t)a.R * a.K;  // floats of one input a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.S; ++s) {
      mbar_init(smem_addr(&full[s]), 2);  // the copies' arrival + the probs'
      mbar_init(smem_addr(&empty[s]), a.R);  // each row group's leader
    }
    mbar_init_fence();
    if (STAMP && blockIdx.x == 0) {
      a.stamps[0] = gridDim.x;
      a.stamps[1] = a.R;
      a.stamps[2] = a.S;
      a.stamps[3] = a.G;
    }
  }
  __syncthreads();

  if (warp == NC) {  // producer
    int j = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
      const int s = j % a.S;
      const uint32_t ph = (j / a.S) & 1;
      mbar_wait(smem_addr(&empty[s]), ph ^ 1);
      const int row0 = tile * a.R;
      const int rows = min(a.R, a.M - row0);
      const uint32_t bytes = (uint32_t)rows * a.K * 4;
      float* dst = stages + (size_t)s * NIN * tile_f;
      const uint32_t bar = smem_addr(&full[s]);
      if (lane == 0) {
        if (STAMP) a.stamps[4 + 4 * tile] = clock64();
        mbar_arrive_expect_tx(bar, NIN * bytes);
        bulk_g2s(smem_addr(dst), a.w + (size_t)row0 * a.K, bytes, bar);
        if (BWD)
          bulk_g2s(smem_addr(dst + tile_f), a.g + (size_t)row0 * a.K, bytes,
                   bar);
      }
      for (int c = lane; c < rows * a.P; c += 32)
        sprm[s][c] = a.probs[(size_t)row0 * a.P + c];
      if ((BWD || a.absmax_in) && lane < rows)
        sprm[s][NC * MAXP + lane] = a.absmax_in[row0 + lane];
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    }
    return;
  }

  // consumers: row group `group` of G warps takes row tile * R + group
  const int G = a.G;
  const int group = warp / G;
  const int gl = (warp % G) * 32 + lane;  // thread within the group
  const int nv = a.K >> 2;
  int j = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
    const int s = j % a.S;
    const int row = tile * a.R + group;
    const bool has = row < a.M;
    mbar_wait(smem_addr(&full[s]), (j / a.S) & 1);
    if (STAMP && threadIdx.x == 0) a.stamps[4 + 4 * tile + 1] = clock64();
    float* sw = stages + (size_t)s * NIN * tile_f + (size_t)group * a.K;
    float* so = BWD ? sw + tile_f : sw;  // dW over g; the forward over W
    float m = 0.0f;
    float part[Quant<NP>::N];
    if (has) {
      const float4* w4 = reinterpret_cast<const float4*>(sw);
      if (BWD || a.absmax_in) {
        m = sprm[s][NC * MAXP + group];
      } else {
        for (int i = gl; i < nv; i += G * 32) m = max_abs4(m, w4[i]);
        m = warp_max(m);
        if (G > 1) {
          if (lane == 0) sred[j & 1][warp][0] = m;
          group_sync(group, G);
          for (int v = 0; v < G; ++v)
            m = fmaxf(m, sred[j & 1][group * G + v][0]);
        }
      }
      Quant<NP> q;
      row_quant<NP>(q, m, &sprm[s][group * a.P], a.nz_bits, a.nz_cols);
      float4* o4 = reinterpret_cast<float4*>(so);
      if (!BWD) {
        for (int i = gl; i < nv; i += G * 32)
          o4[i] = combine4<NP>(w4[i], q);
      } else {
#pragma unroll
        for (int p = 0; p < Quant<NP>::N; ++p) part[p] = 0.0f;
        for (int i = gl; i < nv; i += G * 32)
          o4[i] = ste4<NP>(w4[i], o4[i], q, part);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          part[p] = warp_sum(part[p]);
          if (G > 1 && lane == 0) sred[j & 1][warp][p] = part[p];
        }
      }
      fence_proxy_async();
    }
    group_sync(group, G);
    if (STAMP && threadIdx.x == 0) a.stamps[4 + 4 * tile + 2] = clock64();
    if (gl == 0) {  // the row group's leader
      if (has) {
        bulk_s2g(a.out + (size_t)row * a.K, smem_addr(so),
                 (uint32_t)a.K * 4);
        if (!BWD) {
          if (a.absmax_out) a.absmax_out[row] = m;
        } else {
          float* drow = a.dprobs + (size_t)row * a.P;
          for (int c = 0; c < a.P; ++c)
            if ((a.zero_cols >> c) & 1u) drow[c] = 0.0f;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            float v = part[p];
            if (G > 1) {
              v = 0.0f;
              for (int u = 0; u < G; ++u) v += sred[j & 1][group * G + u][p];
            }
            drow[(a.nz_cols >> (8 * p)) & 0xffu] = v;
          }
        }
      }
      bulk_commit();
      if (STAMP) {
        bulk_wait<0>();
        if (threadIdx.x == 0) a.stamps[4 + 4 * tile + 3] = clock64();
      }
      bulk_wait_read<1>();  // the previous tile's store has read its stage
      if (j > 0) mbar_arrive(smem_addr(&empty[(j - 1) % a.S]));
    }
  }
  if (gl == 0) bulk_wait<0>();
}

// -- simple kernels: one 256-thread block a row, scalar loads -------------

__device__ __forceinline__ float block_max(float m, float* red) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  for (int v = 0; v < SIMPLE_THREADS / 32; ++v) m = fmaxf(m, red[v]);
  return m;
}

template <int NP>
__global__ void __launch_bounds__(SIMPLE_THREADS)
mps_simple_kernel(const float* __restrict__ w, const float* __restrict__ probs,
                  const float* __restrict__ absmax_in,
                  float* __restrict__ out, float* __restrict__ absmax_out,
                  int K, int P, unsigned long long nz_bits,
                  unsigned long long nz_cols) {
  __shared__ float red[SIMPLE_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* wr = w + row * K;
  float m = 0.0f;
  if (absmax_in) {
    m = absmax_in[row];
  } else {
    for (int k = threadIdx.x; k < K; k += SIMPLE_THREADS)
      m = fmaxf(m, fabsf(wr[k]));
    m = block_max(m, red);
  }
  Quant<NP> q;
  row_quant<NP>(q, m, probs + row * P, nz_bits, nz_cols);
  for (int k = threadIdx.x; k < K; k += SIMPLE_THREADS)
    out[row * K + k] = combine<NP>(wr[k], q);
  if (threadIdx.x == 0 && absmax_out) absmax_out[row] = m;
}

template <int NP>
__global__ void __launch_bounds__(SIMPLE_THREADS)
mps_bwd_simple_kernel(const float* __restrict__ w, const float* __restrict__ g,
                      const float* __restrict__ probs,
                      const float* __restrict__ absmax, float* __restrict__ dw,
                      float* __restrict__ dprobs, int K, int P,
                      unsigned long long nz_bits, unsigned long long nz_cols,
                      unsigned zero_cols) {
  __shared__ float red[SIMPLE_THREADS / 32][MAXP];
  const size_t row = blockIdx.x;
  Quant<NP> q;
  row_quant<NP>(q, absmax[row], probs + row * P, nz_bits, nz_cols);
  float part[Quant<NP>::N];
#pragma unroll
  for (int p = 0; p < Quant<NP>::N; ++p) part[p] = 0.0f;
  for (int k = threadIdx.x; k < K; k += SIMPLE_THREADS)
    dw[row * K + k] = ste<NP>(w[row * K + k], g[row * K + k], q, part);
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    part[p] = warp_sum(part[p]);
    if ((threadIdx.x & 31) == 0) red[warp][p] = part[p];
  }
  __syncthreads();
  if (threadIdx.x < P && ((zero_cols >> threadIdx.x) & 1u))
    dprobs[row * P + threadIdx.x] = 0.0f;
  if (threadIdx.x < NP) {
    float v = 0.0f;
    for (int u = 0; u < SIMPLE_THREADS / 32; ++u) v += red[u][threadIdx.x];
    dprobs[row * P + ((nz_cols >> (8 * threadIdx.x)) & 0xffu)] = v;
  }
}

// -- host side -------------------------------------------------------------

struct Plan {
  int G, R, S, grid, tiles;
  size_t smem;
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// The ring kernel's layout for an aligned (M, K) problem streaming
// `inputs` arrays (1 forward, 2 backward): G warps a row, the fewest that
// leave each lane at most one float4 of its row.  False when the problem
// is below the ring's size (RING_MIN_*) or two stages do not fit in shared
// memory: the simple kernels take it.
bool ring_plan(int M, int K, int inputs, Plan* pl) {
  const long long least = inputs == 1 ? RING_MIN_FWD : RING_MIN_BWD;
  if (K % 4 != 0 || (long long)M * K < least * sm_count()) return false;
  int G = 1;
  while (G < NC && K / 4 > G * 32) G *= 2;
  pl->G = G;
  pl->R = NC / G;
  const size_t stage = (size_t)pl->R * K * 4 * inputs;
  int per_sm = 2;
  for (const int budget : {RING_SMEM_2, RING_SMEM_1}) {
    const size_t s = (budget - BAR_BYTES) / stage;
    pl->S = (int)(s < MAX_STAGES ? s : MAX_STAGES);
    if (pl->S >= 2) break;
    per_sm = 1;
  }
  if (pl->S < 2) return false;
  pl->tiles = (M + pl->R - 1) / pl->R;
  pl->grid = pl->tiles < sm_count() * per_sm ? pl->tiles : sm_count() * per_sm;
  pl->smem = BAR_BYTES + pl->S * stage;
  return true;
}

// the nonzero precisions of packed_bits (byte c: bits of probs column c)
int nonzero(int P, unsigned long long packed, unsigned long long* nz_bits,
            unsigned long long* nz_cols, unsigned* zero_cols) {
  int np = 0;
  *nz_bits = *nz_cols = 0;
  *zero_cols = 0;
  for (int c = 0; c < P; ++c) {
    const unsigned long long b = (packed >> (8 * c)) & 0xffu;
    if (b == 0) {
      *zero_cols |= 1u << c;
      continue;
    }
    *nz_bits |= b << (8 * np);
    *nz_cols |= (unsigned long long)c << (8 * np);
    ++np;
  }
  return np;
}

template <typename F>
int with_np(int np, F f) {
  switch (np) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BWD, int NP, bool STAMP>
int launch_ring(const RingArgs& a, const Plan& pl, cudaStream_t st) {
  static size_t opted = 48 * 1024;  // dynamic shared memory allowed so far
  auto kern = mps_ring_kernel<BWD, NP, STAMP>;
  if (pl.smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
    opted = pl.smem;
  }
  kern<<<pl.grid, RING_THREADS, pl.smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

bool bad_args(int M, int K, int P) {
  return P < 1 || P > MAXP || M < 0 || K < 0;
}

int forward(const void* w, const void* probs, const void* absmax_in,
            void* out, void* absmax, int M, int K, int P,
            unsigned long long packed, void* stamps, void* stream) {
  if (bad_args(M, K, P)) return (int)cudaErrorInvalidValue;
  if (M == 0 || K == 0) return 0;
  RingArgs a = {};
  a.w = (const float*)w;
  a.probs = (const float*)probs;
  a.absmax_in = (const float*)absmax_in;
  a.out = (float*)out;
  a.absmax_out = (float*)absmax;
  a.stamps = (long long*)stamps;
  a.M = M, a.K = K, a.P = P;
  const int np = nonzero(P, packed, &a.nz_bits, &a.nz_cols, &a.zero_cols);
  cudaStream_t st = (cudaStream_t)stream;
  Plan pl;
  if (aligned(w) && aligned(out) && ring_plan(M, K, 1, &pl)) {
    a.G = pl.G, a.R = pl.R, a.S = pl.S, a.tiles = pl.tiles;
    return with_np(np, [&](auto n) {
      return stamps ? launch_ring<false, decltype(n)::value, true>(a, pl, st)
                    : launch_ring<false, decltype(n)::value, false>(a, pl, st);
    });
  }
  if (stamps) return (int)cudaErrorInvalidValue;  // the probe needs the ring
  return with_np(np, [&](auto n) {
    mps_simple_kernel<decltype(n)::value><<<M, SIMPLE_THREADS, 0, st>>>(
        a.w, a.probs, a.absmax_in, a.out, a.absmax_out, K, P, a.nz_bits,
        a.nz_cols);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// packed_bits holds the P precisions, one byte each, precision p in byte p.
// absmax (M,) may be null.
extern "C" int mps_combine_launch(const void* w, const void* probs, void* out,
                                  void* absmax, int M, int K, int P,
                                  unsigned long long packed_bits,
                                  void* stream) {
  return forward(w, probs, nullptr, out, absmax, M, K, P, packed_bits,
                 nullptr, stream);
}

// The forward with a given absmax_in (M,): each row's scales come from it
// and the row is not reduced.
extern "C" int mps_combine_given_launch(const void* w, const void* probs,
                                        const void* absmax_in, void* out,
                                        int M, int K, int P,
                                        unsigned long long packed_bits,
                                        void* stream) {
  if (absmax_in == nullptr) return (int)cudaErrorInvalidValue;
  return forward(w, probs, absmax_in, out, nullptr, M, K, P, packed_bits,
                 nullptr, stream);
}

// The forward ring kernel with clock64 stamps: stamps (int64, 4 + 4 M) gets
// the grid, rows a tile, stages and warps a row, then for tile t at
// 4 + 4 t: load issued, landed, combined, stored (the stamped kernel waits
// for each store to complete).  Fails for problems the ring kernel does
// not take.
extern "C" int mps_combine_probe(const void* w, const void* probs, void* out,
                                 void* absmax, int M, int K, int P,
                                 unsigned long long packed_bits, void* stamps,
                                 void* stream) {
  if (stamps == nullptr) return (int)cudaErrorInvalidValue;
  return forward(w, probs, nullptr, out, absmax, M, K, P, packed_bits, stamps,
                 stream);
}

// The straight-through backward: dw (M, K) and dprobs (M, P) from w, g
// (M, K), probs (M, P) and the forward's absmax (M,).
extern "C" int mps_combine_bwd_launch(const void* w, const void* g,
                                      const void* probs, const void* absmax,
                                      void* dw, void* dprobs, int M, int K,
                                      int P, unsigned long long packed_bits,
                                      void* stream) {
  if (bad_args(M, K, P)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  RingArgs a = {};
  a.w = (const float*)w;
  a.g = (const float*)g;
  a.probs = (const float*)probs;
  a.absmax_in = (const float*)absmax;
  a.out = (float*)dw;
  a.dprobs = (float*)dprobs;
  a.M = M, a.K = K, a.P = P;
  const int np = nonzero(P, packed_bits, &a.nz_bits, &a.nz_cols, &a.zero_cols);
  cudaStream_t st = (cudaStream_t)stream;
  Plan pl;
  if (aligned(w) && aligned(g) && aligned(dw) && ring_plan(M, K, 2, &pl)) {
    a.G = pl.G, a.R = pl.R, a.S = pl.S, a.tiles = pl.tiles;
    return with_np(np, [&](auto n) {
      return launch_ring<true, decltype(n)::value, false>(a, pl, st);
    });
  }
  return with_np(np, [&](auto n) {
    mps_bwd_simple_kernel<decltype(n)::value><<<M, SIMPLE_THREADS, 0, st>>>(
        a.w, a.g, a.probs, a.absmax_in, a.out, a.dprobs, K, P, a.nz_bits,
        a.nz_cols, a.zero_cols);
    return (int)cudaGetLastError();
  });
}
