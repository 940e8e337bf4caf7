// K3: causal prompt attention read in place from a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/prefill.py
// (_paged_prefill_kernel, launched by paged_prefill_fwd; its math is in
// prefill_page_update, prefill_page_mask and prefill_page_live).
//
//   q (B, S, H, D); k_pool / v_pool (n_pages + 1, page_size, Hkv, D),
//   physical page 0 the null page; tables (B, *) int32 with row stride
//   tstride, of which the first P entries are read -> out (B, S, H, D).
//   Masking is by position (pos_k <= pos_q plus the window variants); the
//   prompt lengths are not needed, and padded query rows give finite
//   garbage the caller drops.  q, pools and out share one type.
//
// The type picks the kernel; neither is a fallback for the other:
//
// * bfloat16 (the serving path): tensor cores, FlashAttention-2 shaped.
//   What bounds it on the H100: 4*S*S/2*H*D operations over the prompt's
//   K/V bytes -- at S = 512, D = 64 far above the bf16 line in operations
//   per byte, so what limits it is the latency of each block's walk over
//   its keys (the causal work is uneven: the last query tile walks every
//   key) and how well the tensor cores are fed.  One 128-thread block per
//   (slot, KV head, query tile); a tile is 64 (query, head) rows, the G
//   heads of the group side by side, 16 rows a warp, so one K/V tile
//   serves the whole group.  The latest query tiles launch first.  Q
//   fragments stay in registers (D <= 128).  K and V are gathered token by
//   token through the block table (each thread looks up its key's page a
//   tile ahead) into shared tiles of 64 keys (32 at D = 128, 16 at
//   D = 256) by a three-stage cp.async ring, one barrier a tile, so the
//   page size shapes nothing.  S = QK^T and O += PV run on
//   mma.sync.m16n8k16 bf16 with f32 accumulation, operands read by
//   ldmatrix (V transposed) from XOR-swizzled rows.  Scale and softcap
//   apply in registers, and masks only on tiles that meet the diagonal,
//   the window's edge or a null key (a block vote says which).  The f32
//   online softmax keeps its row max and sum with quad shuffles.  P enters
//   the PV product as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi),
//   so the weights keep ~16 bits and the result stays within f32
//   rounding of the plain version (one bf16 term alone moves outputs by
//   up to 2^-9 relative).  Skips keep the page rules at token grain: a
//   key that is null, past the tile's last query or below its first
//   query's window is never loaded (zero-filled, so a NaN null page cannot
//   reach an MMA) and masked to p = 0; a row whose first tile is all
//   masked carries finite garbage that the first live tile's rescale
//   (exp(-1e30 - m) = 0) wipes.  Rows past S are masked on load and
//   store.  The query tiling is the kernel's own, so the result does not
//   depend on the caller's q chunk.
// * float32: the CUDA-core kernel, by design -- a TF32 MMA would break the
//   2e-5 bound of the f32 path.  One 256-thread block per (slot, q chunk,
//   KV head) walks the table and skips, before any load, a page that is
//   null, wholly above the chunk's last query or wholly below its window,
//   and serves the G query heads of the group from one shared K/V page;
//   every (query, head) row keeps its own f32 online softmax, so the
//   result does not depend on the chunk width QC.  It is bound by the
//   CUDA cores' f32 rate once the pages sit in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "ptx.cuh"

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
paged_prefill_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                     const float* __restrict__ vp,
                     const int* __restrict__ tables, float* __restrict__ out,
                     int S, int H, int Hkv, int D, int PS, int P, int tstride,
                     int QC, int window, int chunked, float cap, float scale) {
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
    qs[r * DP + d] = q[(((size_t)b * S + q0 + qi) * H + g * G + gi) * D + d];
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
      ks[t * DP + d] = kp[off];
      vs[i] = vp[off];
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
        acc[i] / fmaxf(lr[r], 1e-30f);
  }
}

int launch_f32(const void* q, const void* kp, const void* vp,
               const int* tables, void* out, int B, int S, int H, int Hkv,
               int D, int PS, int P, int tstride, int QC, int window,
               int chunked, float cap, float scale, cudaStream_t st) {
  const int R = QC * (H / Hkv);
  const size_t smem =
      sizeof(float) * ((size_t)R * (D + 1) + (size_t)PS * (D + 1) +
                       (size_t)PS * D + (size_t)R * PS + (size_t)R * D + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_prefill_kernel<<<dim3(B, S / QC, Hkv), NT, smem, st>>>(
      (const float*)q, (const float*)kp, (const float*)vp, tables,
      (float*)out, S, H, Hkv, D, PS, P, tstride, QC, window, chunked, cap,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------

constexpr int ROWS = 64;           // (query, head) rows per block
constexpr int WARPS = ROWS / 16;   // 16 rows a warp
constexpr int NTB = 32 * WARPS;

// keys per shared K/V tile, by head dim: three stages of K and V fit
// beside the Q tile with two or more blocks an SM
template <int D>
constexpr int KV_TILE = D <= 64 ? 64 : D == 128 ? 32 : 16;

constexpr int KVS = 3;             // K/V ring stages

// bytes of dynamic shared memory: Q, KVS stages of K and V, key flags
template <int D>
constexpr int PREFILL_SMEM =
    2 * (ROWS * D + 2 * KVS * KV_TILE<D> * D) + KVS * KV_TILE<D> * 4;

// D: head dim; CAP: softcap on (a template flag, so that tanhf is not
// predicated into every score when it is off)
template <int D, bool CAP>
__global__ void __launch_bounds__(NTB)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kp,
                         const __nv_bfloat16* __restrict__ vp,
                         const int* __restrict__ tables,
                         __nv_bfloat16* __restrict__ out, int S, int H,
                         int Hkv, int PS, int P, int tstride, int window,
                         int chunked, float cap, float scale) {
  constexpr int BKV = KV_TILE<D>;
  constexpr int C = D / 8;               // 16-byte chunks per row
  constexpr int KD = D / 16;             // k16 steps over D
  constexpr int NS = BKV / 8;            // n8 score tiles per warp
  constexpr int NO = D / 8;              // n8 output tiles per warp
  constexpr int TPK = NTB / BKV;         // loading threads per key
  constexpr int CPT = C / TPK;           // chunks each of them copies
  constexpr bool QREG = D <= 128;        // Q fragments kept in registers
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // ROWS x D
  __nv_bfloat16* ks = qs + ROWS * D;     // KVS x BKV x D
  __nv_bfloat16* vs = ks + KVS * BKV * D;  // KVS x BKV x D
  int* kvalid = reinterpret_cast<int*>(vs + KVS * BKV * D);  // KVS x BKV

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / Hkv;
  const int nrows = S * G;               // rows (query, head in group)
  const int tile = gridDim.x - 1 - blockIdx.x;   // latest tiles first
  const int g = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * ROWS;
  const int q_first = r0 / G;
  const int q_last = min((r0 + ROWS - 1) / G, S - 1);
  int kv_lo = 0;                         // first key any row may attend
  if (window > 0)
    kv_lo = chunked ? (q_first / window) * window
                    : max(q_first - window + 1, 0);
  const int kv_hi = min(q_last, P * PS - 1);     // ... and the last
  const int j_begin = (kv_lo / BKV) * BKV;
  const int n_kv = kv_hi >= kv_lo ? (kv_hi - j_begin) / BKV + 1 : 0;

  // Q rows of the tile; rows past S zero-filled
  for (int i = tid; i < ROWS * C; i += NTB) {
    const int r = i / C, c = i % C, rr = r0 + r;
    const __nv_bfloat16* src = q;
    if (rr < nrows)
      src = q + (((size_t)b * S + rr / G) * H + g * G + rr % G) * D + c * 8;
    cp_async16(smem_addr(qs + swz<C>(r, c) * 8), src, rr < nrows ? 16 : 0);
  }

  // Each thread gathers CPT chunks of key `kt` of every K/V tile; its
  // table entry is looked up a tile ahead of the copy.
  const int kt = tid / TPK, part = tid % TPK;
  auto lookup = [&](int i) -> int {
    const int j = j_begin + i * BKV + kt;
    return i < n_kv && j >= kv_lo && j <= kv_hi
               ? __ldg(tables + (size_t)b * tstride + j / PS)
               : 0;
  };
  auto fetch = [&](int i, int phys) {
    const int st = i % KVS, j = j_begin + i * BKV + kt;
    const size_t off = (((size_t)phys * PS + j % PS) * Hkv + g) * D;
    const int n = phys != 0 ? 16 : 0;    // null: zero-filled, never read
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int c = part * CPT + e;
      const int dst = st * BKV * D + swz<C>(kt, c) * 8;
      cp_async16(smem_addr(ks + dst), n ? kp + off + c * 8 : kp, n);
      cp_async16(smem_addr(vs + dst), n ? vp + off + c * 8 : vp, n);
    }
    if (part == 0) kvalid[st * BKV + kt] = phys != 0;
  };

  // tiles 0 and 1 in flight; a block vote says whether every key of a
  // tile is backed
  int ph = lookup(0);
  if (n_kv > 0) fetch(0, ph);
  cp_commit();
  bool all_cur = __syncthreads_and(ph != 0);
  ph = lookup(1);
  if (n_kv > 1) fetch(1, ph);
  cp_commit();
  int live_next = ph != 0;               // my key of tile it + 1
  int ph_next = lookup(2);               // ... and its entry of tile it + 2

  // this thread's two rows: lane / 4 and lane / 4 + 8 of its warp's 16
  const int ra = r0 + warp * 16 + (lane >> 2);
  const int qa = ra / G, qb = (ra + 8) / G;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  uint32_t qf[QREG ? KD : 1][4];
  const uint32_t q_addr = smem_addr(qs);

  for (int it = 0; it < n_kv; ++it) {
    const int st = it % KVS, j0 = j_begin + it * BKV;
    cp_wait<1>();                        // Q and tile it have landed
    // every warp is done with tile it - 1, whose stage tile it + 2 takes
    const bool all_next = __syncthreads_and(live_next);
    if (it + 2 < n_kv) fetch(it + 2, ph_next);
    cp_commit();
    live_next = ph_next != 0;
    ph_next = lookup(it + 3);
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldsm_x4(qf[kd], q_addr + swz<C>(warp * 16 + (lane & 15),
                                          2 * kd + (lane >> 4)) * 16);
      }
    }

    // S = Q K^T for the warp's 16 rows x BKV keys
    const uint32_t k_addr = smem_addr(ks + st * BKV * D);
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        ldsm_x4(a, q_addr + swz<C>(warp * 16 + (lane & 15),
                                   2 * kd + (lane >> 4)) * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        const int t = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(kb, k_addr + swz<C>(t, 2 * kd + ((lane >> 3) & 1)) * 16);
        mma_bf16(s[2 * np], a, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }

    // scale and softcap; masks only where a tile meets the diagonal, the
    // window's edge or a null key (elsewhere every pair is attendable).
    // Every branch here is uniform and sits outside the element loops, so
    // none of them is predicated into every element.
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= scale;
        if constexpr (CAP) s[nt][e] = cap * tanhf(s[nt][e] / cap);
      }
    bool interior = all_cur && j0 + BKV - 1 <= q_first;
    if (window > 0)
      interior = interior && (chunked ? j0 / window == q_last / window
                                      : j0 > q_last - window);
    all_cur = all_next;
    if (!interior) {
      const int* kv_ok = kvalid + st * BKV;
      const int jt = j0 + (lane & 3) * 2;  // this thread's first key
      if (window <= 0) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = nt * 8 + (lane & 3) * 2 + (e & 1);
            const int j = jt + nt * 8 + (e & 1), pq = e < 2 ? qa : qb;
            const bool ok = kv_ok[t] && j <= pq;
            s[nt][e] = ok ? s[nt][e] : NEG;
          }
      } else if (!chunked) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = nt * 8 + (lane & 3) * 2 + (e & 1);
            const int j = jt + nt * 8 + (e & 1), pq = e < 2 ? qa : qb;
            const bool ok = kv_ok[t] && j <= pq && j > pq - window;
            s[nt][e] = ok ? s[nt][e] : NEG;
          }
      } else {
        const int ca = qa / window, cb = qb / window;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = nt * 8 + (lane & 3) * 2 + (e & 1);
            const int j = jt + nt * 8 + (e & 1), pq = e < 2 ? qa : qb;
            const bool ok = kv_ok[t] && j <= pq &&
                            j / window == (e < 2 ? ca : cb);
            s[nt][e] = ok ? s[nt][e] : NEG;
          }
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);

    // online softmax: row max and sum across the quad holding the row
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = __expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V with P = hi + lo, two bf16 terms (16 bits of P kept)
    const uint32_t v_addr = smem_addr(vs + st * BKV * D);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pp = &s[2 * kk + (e >> 1)][(e & 1) * 2];
        split_bf16(pp[0], pp[1], hi[e], lo[e]);
      }
      const int t = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, v_addr + swz<C>(t, 2 * dp + (lane >> 4)) * 16);
        mma_bf16(o[2 * dp], hi, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], hi, vb[2], vb[3]);
        mma_bf16(o[2 * dp], lo, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], lo, vb[2], vb[3]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    l_run[h] = fmaxf(l_run[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = ra + 8 * h;
    if (rr >= nrows) continue;
    __nv_bfloat16* dst =
        out + (((size_t)b * S + rr / G) * H + g * G + rr % G) * D +
        (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8) =
          __floats2bfloat162_rn(o[i][2 * h] / l_run[h],
                                o[i][2 * h + 1] / l_run[h]);
  }
}

template <int D, bool CAP>
int launch_mma(const void* q, const void* kp, const void* vp,
               const int* tables, void* out, int B, int S, int H, int Hkv,
               int PS, int P, int tstride, int window, int chunked, float cap,
               float scale, cudaStream_t st) {
  constexpr int smem = PREFILL_SMEM<D>;
  static bool attr_set = false;          // once per instantiation
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_mma_kernel<D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int tiles = (S * (H / Hkv) + ROWS - 1) / ROWS;
  paged_prefill_mma_kernel<D, CAP><<<dim3(tiles, Hkv, B), NTB, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, tables, (__nv_bfloat16*)out, S, H, Hkv, PS,
      P, tstride, window, chunked, cap, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* kp, const void* vp,
               const int* tables, void* out, int B, int S, int H, int Hkv,
               int PS, int P, int tstride, int window, int chunked, float cap,
               float scale, cudaStream_t st) {
  return cap > 0.f
             ? launch_mma<D, true>(q, kp, vp, tables, out, B, S, H, Hkv, PS,
                                   P, tstride, window, chunked, cap, scale, st)
             : launch_mma<D, false>(q, kp, vp, tables, out, B, S, H, Hkv, PS,
                                    P, tstride, window, chunked, cap, scale,
                                    st);
}

// the head dims the bfloat16 kernel is built for
#define BF16_DIMS(X) X(16) X(32) X(64) X(128) X(256)

}  // namespace

// Writes the head dims the bfloat16 kernel takes to out[0 .. 8) and
// returns their number.
extern "C" int paged_prefill_bf16_dims(int* out) {
  int n = 0;
#define DIM(d) out[n++] = d;
  BF16_DIMS(DIM)
#undef DIM
  return n;
}

// dtype: 0 = float32 (CUDA cores, q chunk QC), 1 = bfloat16 (tensor
// cores, D one of BF16_DIMS; QC unused)
extern "C" int paged_prefill_launch(const void* q, const void* kp,
                                    const void* vp, const void* tables,
                                    void* out, int B, int S, int H, int Hkv,
                                    int D, int PS, int P, int tstride, int QC,
                                    int window, int chunked, float cap,
                                    float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  if (dtype == 0)
    return launch_f32(q, kp, vp, tb, out, B, S, H, Hkv, D, PS, P, tstride,
                      QC, window, chunked, cap, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
#define CASE(d)                                                           \
  case d:                                                                 \
    return launch_mma<d>(q, kp, vp, tb, out, B, S, H, Hkv, PS, P, tstride, \
                         window, chunked, cap, scale, st);
    BF16_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
