// K2: one-token decode attention read in place from a paged KV pool,
// as flash-decoding: each slot's key range is split over blocks, whose
// partial softmax states a second kernel merges.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_attn_kernel, launched by paged_attention_fwd; its math is in
// page_update, page_mask and page_live).
//
//   q (B, H, D); k_pool / v_pool (n_pages + 1, page_size, Hkv, D), physical
//   page 0 the null page; tables (B, *) int32 with row stride tstride, of
//   which the first P entries are read; pos (B,) int32 -> out (B, H, D).
//   q, pools and out share one type: float32 or bfloat16; D is one of
//   DECODE_DIMS; q and the pools start on a 16-byte boundary.
//
// What bounds it on the H100: every live K/V byte is read once and used
// for 2*G multiply-adds per element (G = H / Hkv query heads share a KV
// head), a few operations per byte -- the bytes of the live tokens, a few
// MB at decode sizes, so in practice the latency of one block's chain of
// table lookups, loads, scores, softmax and PV, and the instructions the
// SM must issue for it.  The design cuts that chain short, runs many of
// them at once, and puts the bf16 products on the tensor cores:
//
// * split kernels, grid (NS, Hkv * head chunks, B).  Split s covers the
//   logical tokens [s * ST, (s + 1) * ST) of its slot (ST = 128 at D <= 64
//   in bf16), so NS = ceil(P * page_size / ST) comes from the table width
//   alone and nothing reads pos back to the host.  A block reads pos[b]
//   itself and keeps only the tokens that may be attended: at or below
//   pos, not below the window.  Each of those looks up its own page (token
//   grain, so the page size shapes nothing); a split with no backed token
//   (null pages, past pos, or wholly below the window -- the page_live
//   rule) writes the neutral partial m = -1e30, l = 0 and exits.  The
//   others issue every K/V row of the split as 16-byte cp.async copies
//   before consuming any; a null token is zero-filled, never read (so a
//   NaN null page is unreachable) and masked to -1e30.  Each writes, for
//   each of its query heads, (m, l) and the unnormalised f32 accumulator.
//   - bfloat16, paged_decode_mma_kernel (the serving path): the block's
//     query heads (up to 16) are the rows of one mma A tile, each warp
//     takes a quarter of the split's keys, S = Q K^T and O = P V run on
//     mma.sync.m16n8k16 bf16 with f32 sums (operands by ldmatrix from
//     XOR-swizzled rows; P as two bf16 terms, ~16 bits), and the four
//     warps' (m, l, O) merge in shared memory.
//   - float32, paged_decode_split_kernel, on the CUDA cores (a TF32 mma
//     would break the f32 path's 2e-5 bound): a token's row is split over
//     D * 4 / 16 lanes, each dotting its 16 bytes with the group's query
//     heads held in registers, then a shuffle reduction; a warp per head
//     takes the split's max and sum; PV runs a lane per D / 32 columns, a
//     quarter of the tokens a warp, the warps' sums added in a fixed order.
//     It is bound by the instructions it issues, not by its bytes.
// * paged_decode_merge_kernel: a warp per (slot, head) merges the NS
//   partials: M = max m_s over the splits with l_s > 0, l = sum l_s
//   e^(m_s - M), out = sum acc_s e^(m_s - M) / max(l, 1e-30), eight
//   splits' loads in flight at once and merged online.  A dead
//   split weighs nothing (its acc is never read, which equals acc = 0),
//   and an all-dead row -- a freed slot -- gives exact zeros.  This is
//   the one rounding to the output type.
//
// The partials live in f32 scratch the wrapper allocates (B * H * NS *
// (D + 2) floats).  Softmax and sums are f32, like the reference's online
// softmax; only the summation order differs.  The longest chain is one
// split of ST tokens, whatever the slot's length.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "ptx.cuh"

namespace {

constexpr int NT = 128;            // threads of a split block: four warps
constexpr int NW = NT / 32;
constexpr float NEG = -1e30f;
constexpr int TILE_BYTES = 16384;  // bytes of the K tile (and the V tile)
constexpr int MAX_SPLIT = 128;     // tokens a split covers at most

// tokens a float32 split covers: one K tile of TILE_BYTES
template <int D>
__host__ __device__ constexpr int split_tokens() {
  return TILE_BYTES / (D * 4) < MAX_SPLIT ? TILE_BYTES / (D * 4) : MAX_SPLIT;
}

// query heads a split block serves: their four warps' PV sums (NW x HPB x
// D floats) fit in the K tile, which they overwrite
template <int D>
__host__ __device__ constexpr int heads_per_block() {
  return 1024 / D < 8 ? 1024 / D : 8;
}

template <int D>
constexpr int split_smem() {
  return 2 * split_tokens<D>() * D * 4 +
         heads_per_block<D>() * split_tokens<D>() * 4 + split_tokens<D>() * 4;
}

// N consecutive floats at p (aligned to 8 bytes for N = 2, else to 16)
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&out)[N]) {
  if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    static_assert(N % 4 == 0, "2 or a multiple of 4 floats");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype
}

// ml: (B, H, NS, 2) f32 (m, l); part: (B, H, NS, D) f32 accumulators
template <int D>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const float* __restrict__ q,
                          const float* __restrict__ kp,
                          const float* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos, float* __restrict__ ml,
                          float* __restrict__ part, int H, int Hkv, int PS,
                          int P, int tstride, int window, int chunked,
                          float cap, float scale) {
  constexpr int ST = split_tokens<D>();
  constexpr int HPB = heads_per_block<D>();
  constexpr int EPC = 4;                     // values in a 16-byte chunk
  constexpr int CH = D / EPC;                // chunks in a row
  constexpr int LPT = CH < 32 ? CH : 32;     // scores: lanes a token
  constexpr int CPL = CH / LPT;              // ... chunks a lane
  constexpr int TPW = 32 / LPT;              // ... tokens a warp pass
  constexpr int EV = D / 32 > 2 ? D / 32 : 2;  // PV: columns a lane
  constexpr int LV = D / EV;                 // ... lanes a token
  constexpr int TV = 32 / LV;                // ... tokens a warp pass
  static_assert(NW * HPB * D <= ST * D, "PV sums must fit in the K tile");
  static_assert(ST <= NT && ST % TPW == 0 && ST % TV == 0, "split shape");
  extern __shared__ __align__(128) uint8_t smem[];
  float* ks = reinterpret_cast<float*>(smem);            // ST x D
  float* vs = ks + ST * D;                               // ST x D
  float* ss = reinterpret_cast<float*>(vs + ST * D);     // HPB x ST
  int* phys = reinterpret_cast<int*>(ss + HPB * ST);     // ST
  float* red = reinterpret_cast<float*>(smem);           // NW x HPB x D

  const int s = blockIdx.x, NS = gridDim.x, b = blockIdx.z;
  const int G = H / Hkv, chunks = (G + HPB - 1) / HPB;
  const int g = blockIdx.y / chunks, hc = blockIdx.y % chunks;
  const int gn = min(HPB, G - hc * HPB);     // heads of this block
  const int h0 = g * G + hc * HPB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int posn = pos[b];

  // the split's tokens that may be attended: [a0, a0 + n)
  int lo = 0;
  if (window > 0)
    lo = chunked ? (posn / window) * window : max(posn - window + 1, 0);
  const int a0 = max(s * ST, lo);
  const int n = min(min(s * ST + ST, P * PS) - 1, posn) - a0 + 1;
  float* mlh = ml + (((size_t)b * H + h0) * NS + s) * 2;   // head stride 2 NS

  bool backed = false;
  if (tid < n) {
    const int j = a0 + tid;
    const int ph = __ldg(tables + (size_t)b * tstride + j / PS);
    phys[tid] = ph;
    backed = ph != 0;
  }
  if (!__syncthreads_or(backed)) {           // dead split: neutral partial
    if (tid < gn) {
      mlh[(size_t)tid * NS * 2] = NEG;
      mlh[(size_t)tid * NS * 2 + 1] = 0.f;
    }
    return;
  }

  // every K/V row of the split in flight before any is consumed
  for (int i = tid; i < n * CH; i += NT) {
    const int r = i / CH, c = i % CH, ph = phys[r], j = a0 + r;
    const size_t off = (((size_t)ph * PS + j % PS) * Hkv + g) * D + c * EPC;
    const int nb = ph != 0 ? 16 : 0;         // null: zero-filled, never read
    cp_async16(smem_addr(ks + r * D + c * EPC), nb ? kp + off : kp, nb);
    cp_async16(smem_addr(vs + r * D + c * EPC), nb ? vp + off : vp, nb);
  }
  cp_commit();

  // this lane's chunks of the block's query heads, while the copies fly
  float qf[HPB][CPL * EPC];
#pragma unroll
  for (int hi = 0; hi < HPB; ++hi)
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      float v[EPC];
      if (hi < gn) {
        load_f<EPC>(q + ((size_t)b * H + h0 + hi) * D +
                           ((lane % LPT) + LPT * k) * EPC, v);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) qf[hi][k * EPC + e] = v[e];
    }
  cp_wait<0>();
  __syncthreads();

  // scores: LPT lanes a token, shuffle-reduced; rows past n are never kept
  for (int base = warp * TPW; base < n; base += NW * TPW) {
    const int r = base + lane / LPT;
    float dot[HPB];
#pragma unroll
    for (int hi = 0; hi < HPB; ++hi) dot[hi] = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      float kv[EPC];
      load_f<EPC>(ks + r * D + ((lane % LPT) + LPT * k) * EPC, kv);
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          dot[hi] = fmaf(qf[hi][k * EPC + e], kv[e], dot[hi]);
    }
#pragma unroll
    for (int off = LPT / 2; off > 0; off /= 2)
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi)
        dot[hi] += __shfl_xor_sync(0xffffffffu, dot[hi], off);
    if (lane % LPT == 0 && r < n) {
      const bool ok = phys[r] != 0;
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi) {
        if (hi >= gn) break;
        float sc = dot[hi] * scale;
        if (cap > 0.f) sc = cap * tanhf(sc / cap);
        ss[hi * ST + r] = ok ? sc : NEG;
      }
    }
  }
  __syncthreads();

  // the split's softmax, a warp per head; (m, l) go straight out
  for (int hi = warp; hi < gn; hi += NW) {
    float* row = ss + hi * ST;
    float mx = NEG;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(row[r] - mx);     // a masked score gives 0
      row[r] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      mlh[(size_t)hi * NS * 2] = mx;
      mlh[(size_t)hi * NS * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // PV: a lane per EV columns, TV tokens a warp pass, warps over tokens
  const int dv = (lane % LV) * EV;
  float acc[HPB][EV];
#pragma unroll
  for (int hi = 0; hi < HPB; ++hi)
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[hi][e] = 0.f;
  for (int base = warp * TV; base < n; base += NW * TV) {
    const int r = base + lane / LV;
    if (r < n) {
      float v[EV];
      load_f<EV>(vs + r * D + dv, v);
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi) {
        if (hi >= gn) break;
        const float p = ss[hi * ST + r];
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[hi][e] = fmaf(p, v[e], acc[hi][e]);
      }
    }
  }
#pragma unroll
  for (int off = LV; off < 32; off *= 2)
#pragma unroll
    for (int hi = 0; hi < HPB; ++hi)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        acc[hi][e] += __shfl_xor_sync(0xffffffffu, acc[hi][e], off);
  if (lane < LV) {                           // K is dead: its tile takes the sums
#pragma unroll
    for (int hi = 0; hi < HPB; ++hi) {
      if (hi >= gn) break;
#pragma unroll
      for (int e = 0; e < EV; ++e)
        red[(warp * HPB + hi) * D + dv + e] = acc[hi][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += NT) {
    const int hi = i / D, d = i % D;
    float a = red[hi * D + d];
#pragma unroll
    for (int w = 1; w < NW; ++w) a += red[(w * HPB + hi) * D + d];
    part[(((size_t)b * H + h0 + hi) * NS + s) * D + d] = a;
  }
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------

// tokens a bf16 split covers: four warps of 32 keys (16 above D = 64)
template <int D>
__host__ __device__ constexpr int mma_split_tokens() {
  return D <= 64 ? 128 : 64;
}

// query heads a bf16 split block serves: the 16 rows of an mma A tile,
// fewer where the four warps' output sums would not fit in the K tile
template <int D>
__host__ __device__ constexpr int mma_heads() {
  return 1024 / D < 16 ? 1024 / D : 16;
}

template <int D>
constexpr int mma_smem() {
  return 2 * (16 * D + 2 * mma_split_tokens<D>() * D) +
         mma_split_tokens<D>() * 4 + NW * mma_heads<D>() * 8;
}

// The same split as paged_decode_split_kernel, on the tensor cores: the
// block's query heads are the rows of one 16-row A tile (rows past the
// group zero), each warp takes a quarter of the split's keys, S = Q K^T
// and O = P V run on mma.sync.m16n8k16 bf16 with f32 sums (P as two bf16
// terms, ~16 bits), and the warps' (m, l, O) are merged in shared memory
// into the block's partial.  CAP: softcap on (a template flag, so that
// tanhf is not predicated into every score when it is off).
template <int D, bool CAP>
__global__ void __launch_bounds__(NT)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kp,
                        const __nv_bfloat16* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, float* __restrict__ ml,
                        float* __restrict__ part, int H, int Hkv, int PS,
                        int P, int tstride, int window, int chunked,
                        float cap, float scale) {
  constexpr int ST = mma_split_tokens<D>(), HPB = mma_heads<D>();
  constexpr int KW = ST / NW;              // keys a warp
  constexpr int C = D / 8;                 // 16-byte chunks a row
  constexpr int KD = D / 16;               // k16 steps over D
  constexpr int NSC = KW / 8;              // n8 score tiles a warp
  constexpr int NO = D / 8;                // n8 output tiles
  constexpr bool QREG = D <= 128;          // Q fragments kept in registers
  static_assert(NW * HPB * D * 4 <= ST * D * 2, "O sums must fit in K");
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // 16 x D
  __nv_bfloat16* ks = qs + 16 * D;                             // ST x D
  __nv_bfloat16* vs = ks + ST * D;                             // ST x D
  int* phys = reinterpret_cast<int*>(vs + ST * D);             // ST
  float* mlw = reinterpret_cast<float*>(phys + ST);       // NW x HPB x 2
  float* red = reinterpret_cast<float*>(ks);              // NW x HPB x D

  const int s = blockIdx.x, NS = gridDim.x, b = blockIdx.z;
  const int G = H / Hkv, chunks = (G + HPB - 1) / HPB;
  const int g = blockIdx.y / chunks, hc = blockIdx.y % chunks;
  const int gn = min(HPB, G - hc * HPB);
  const int h0 = g * G + hc * HPB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int posn = pos[b];

  int lo = 0;
  if (window > 0)
    lo = chunked ? (posn / window) * window : max(posn - window + 1, 0);
  const int a0 = max(s * ST, lo);
  const int n = min(min(s * ST + ST, P * PS) - 1, posn) - a0 + 1;
  float* mlh = ml + (((size_t)b * H + h0) * NS + s) * 2;

  bool backed = false;
  if (tid < n) {
    const int j = a0 + tid;
    const int ph = __ldg(tables + (size_t)b * tstride + j / PS);
    phys[tid] = ph;
    backed = ph != 0;
  }
  if (!__syncthreads_or(backed)) {
    if (tid < gn) {
      mlh[(size_t)tid * NS * 2] = NEG;
      mlh[(size_t)tid * NS * 2 + 1] = 0.f;
    }
    return;
  }

  // Q rows (zero past the block's heads), then every K/V row of the split;
  // rows that are null or past n are zero-filled and never read
  for (int i = tid; i < 16 * C; i += NT) {
    const int r = i / C, c = i % C;
    const int nb = r < gn ? 16 : 0;
    cp_async16(smem_addr(qs + swz<C>(r, c) * 8),
               nb ? q + ((size_t)b * H + h0 + r) * D + c * 8 : q, nb);
  }
  for (int i = tid; i < ST * C; i += NT) {
    const int r = i / C, c = i % C;
    const int ph = r < n ? phys[r] : 0, j = a0 + r;
    const size_t off = (((size_t)ph * PS + j % PS) * Hkv + g) * D + c * 8;
    const int nb = ph != 0 ? 16 : 0;
    const int dst = swz<C>(r, c) * 8;
    cp_async16(smem_addr(ks + dst), nb ? kp + off : kp, nb);
    cp_async16(smem_addr(vs + dst), nb ? vp + off : vp, nb);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // this warp's keys [k0, k0 + KW) of the split; a warp with none of the
  // attendable ones stays neutral
  const int k0 = warp * KW;
  const uint32_t q_addr = smem_addr(qs), k_addr = smem_addr(ks),
                 v_addr = smem_addr(vs);
  float m_w[2] = {NEG, NEG}, l_w[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  if (k0 < n) {
    float sc[NSC][4];
#pragma unroll
    for (int i = 0; i < NSC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
    uint32_t qf[QREG ? KD : 1][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + swz<C>(lane & 15, 2 * kd + (lane >> 4)) * 16);
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kd][e] = a[e];
      } else {
#pragma unroll
        for (int np = 0; np < NSC / 2; ++np) {
          uint32_t kb[4];
          const int t = k0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(kb, k_addr + swz<C>(t, 2 * kd + ((lane >> 3) & 1)) * 16);
          mma_bf16(sc[2 * np], a, kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], a, kb[2], kb[3]);
        }
      }
    }
    if constexpr (QREG) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int np = 0; np < NSC / 2; ++np) {
          uint32_t kb[4];
          const int t = k0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(kb, k_addr + swz<C>(t, 2 * kd + ((lane >> 3) & 1)) * 16);
          mma_bf16(sc[2 * np], qf[kd], kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qf[kd], kb[2], kb[3]);
        }
    }
    // scale, softcap and mask (a key past n or null); row max over the quad
#pragma unroll
    for (int nt = 0; nt < NSC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        float v = sc[nt][e] * scale;
        if constexpr (CAP) v = cap * tanhf(v / cap);
        const bool ok = r < n && phys[r] != 0;
        sc[nt][e] = ok ? v : NEG;
        m_w[e >> 1] = fmaxf(m_w[e >> 1], sc[nt][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_w[h] = fmaxf(m_w[h], __shfl_xor_sync(0xffffffffu, m_w[h], 1));
      m_w[h] = fmaxf(m_w[h], __shfl_xor_sync(0xffffffffu, m_w[h], 2));
    }
    // all of this warp's keys masked: p = 0, so the warp stays neutral
    const bool dead = m_w[0] <= NEG;
#pragma unroll
    for (int nt = 0; nt < NSC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = dead ? 0.f : expf(sc[nt][e] - m_w[e >> 1]);
        sc[nt][e] = p;
        l_w[e >> 1] += p;
      }
    // O = P V with P = hi + lo
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t hi[4], lo4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pp = &sc[2 * kk + (e >> 1)][(e & 1) * 2];
        split_bf16(pp[0], pp[1], hi[e], lo4[e]);
      }
      const int t = k0 + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, v_addr + swz<C>(t, 2 * dp + (lane >> 4)) * 16);
        mma_bf16(o[2 * dp], hi, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], hi, vb[2], vb[3]);
        mma_bf16(o[2 * dp], lo4, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], lo4, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_w[h] += __shfl_xor_sync(0xffffffffu, l_w[h], 1);
      l_w[h] += __shfl_xor_sync(0xffffffffu, l_w[h], 2);
    }
  }
  __syncthreads();                           // K and V are dead from here

  // the warps' (m, l, O) of the block's heads, then their merge
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (lane >> 2) + 8 * h;
    if (row >= gn) continue;
    if ((lane & 3) == 0) {
      mlw[(warp * HPB + row) * 2] = m_w[h];
      mlw[(warp * HPB + row) * 2 + 1] = l_w[h];
    }
    float* dst = red + (warp * HPB + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      dst[i * 8] = o[i][2 * h];
      dst[i * 8 + 1] = o[i][2 * h + 1];
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += NT) {
    const int row = i / D, d = i % D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (mlw[(w * HPB + row) * 2 + 1] > 0.f)
        M = fmaxf(M, mlw[(w * HPB + row) * 2]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float lw = mlw[(w * HPB + row) * 2 + 1];
      if (lw > 0.f) {                        // a neutral warp weighs nothing
        const float c = expf(mlw[(w * HPB + row) * 2] - M);
        a += red[(w * HPB + row) * D + d] * c;
        l += lw * c;
      }
    }
    part[(((size_t)b * H + h0 + row) * NS + s) * D + d] = a;
    if (d == 0) {
      mlh[(size_t)row * NS * 2] = M;
      mlh[(size_t)row * NS * 2 + 1] = l;
    }
  }
}

constexpr int MERGE_ROWS = 4;      // (slot, head) rows a merge block: a warp each
constexpr int MERGE_BATCH = 8;     // splits whose partials a lane loads at once

template <typename T, int D>
__global__ void __launch_bounds__(32 * MERGE_ROWS)
paged_decode_merge_kernel(const float* __restrict__ ml,
                          const float* __restrict__ part, T* __restrict__ out,
                          int rows, int NS) {
  constexpr int EM = D >= 32 ? D / 32 : 1;   // columns a lane
  const int row = blockIdx.x * MERGE_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows || lane * EM >= D) return;
  const float2* mr = reinterpret_cast<const float2*>(ml) + (size_t)row * NS;
  const float* pr = part + (size_t)row * NS * D + lane * EM;
  // batches of MERGE_BATCH splits, every load of a batch in flight at
  // once, merged online into (M, l, acc); a dead split (l_s = 0) weighs
  // nothing, and its accumulator, never written, is selected away
  float M = NEG, l = 0.f, acc[EM];
#pragma unroll
  for (int e = 0; e < EM; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < NS; s0 += MERGE_BATCH) {
    float2 v[MERGE_BATCH];
    float a[MERGE_BATCH][EM];
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const bool in = s0 + i < NS;
      v[i] = in ? mr[s0 + i] : make_float2(NEG, 0.f);
#pragma unroll
      for (int e = 0; e < EM; ++e)
        a[i][e] = in ? pr[(size_t)(s0 + i) * D + e] : 0.f;
    }
    float mb = M;
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i)
      mb = v[i].y > 0.f ? fmaxf(mb, v[i].x) : mb;
    const float c = expf(M - mb);          // 0, or 1 while nothing is live
    l *= c;
#pragma unroll
    for (int e = 0; e < EM; ++e) acc[e] *= c;
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const bool live = v[i].y > 0.f;
      const float w = live ? expf(v[i].x - mb) : 0.f;
      l += v[i].y * w;
#pragma unroll
      for (int e = 0; e < EM; ++e) acc[e] += live ? a[i][e] * w : 0.f;
    }
    M = mb;
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < EM; ++e)
    out[(size_t)row * D + lane * EM + e] = from_f<T>(acc[e] / den);
}

template <int D, bool CAP>
cudaError_t launch_mma(dim3 grid, const void* q, const void* kp,
                       const void* vp, const int* tables, const int* pos,
                       float* ml, float* part, int H, int Hkv, int PS, int P,
                       int tstride, int window, int chunked, float cap,
                       float scale, cudaStream_t st) {
  constexpr int smem = mma_smem<D>();
  static bool attr_set = false;          // once per instantiation
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_mma_kernel<D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  paged_decode_mma_kernel<D, CAP><<<grid, NT, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, tables, pos, ml, part, H, Hkv, PS, P,
      tstride, window, chunked, cap, scale);
  return cudaGetLastError();
}

// float32 splits run on the CUDA cores (a TF32 mma would break the f32
// path's 2e-5 bound), bfloat16 ones on the tensor cores
template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* pos, void* out, float* scratch, long long scratch_len,
           int B, int H, int Hkv, int PS, int P, int tstride, int window,
           int chunked, float cap, float scale, cudaStream_t st) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int ST = BF16 ? mma_split_tokens<D>() : split_tokens<D>();
  constexpr int HPB = BF16 ? mma_heads<D>() : heads_per_block<D>();
  const long long toks = (long long)P * PS;
  const int NS = toks > 0 ? (int)((toks + ST - 1) / ST) : 1;
  const long long rows = (long long)B * H;
  if (scratch_len < rows * NS * (D + 2)) return (int)cudaErrorInvalidValue;
  float* ml = scratch;
  float* part = scratch + rows * NS * 2;
  const dim3 grid(NS, Hkv * ((H / Hkv + HPB - 1) / HPB), B);
  cudaError_t e;
  if constexpr (BF16) {
    e = cap > 0.f ? launch_mma<D, true>(grid, q, kp, vp, tables, pos, ml,
                                        part, H, Hkv, PS, P, tstride, window,
                                        chunked, cap, scale, st)
                  : launch_mma<D, false>(grid, q, kp, vp, tables, pos, ml,
                                         part, H, Hkv, PS, P, tstride,
                                         window, chunked, cap, scale, st);
  } else {
    paged_decode_split_kernel<D><<<grid, NT, split_smem<D>(), st>>>(
        (const float*)q, (const float*)kp, (const float*)vp, tables, pos, ml,
        part, H, Hkv, PS, P, tstride, window, chunked, cap, scale);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  paged_decode_merge_kernel<T, D>
      <<<(unsigned)((rows + MERGE_ROWS - 1) / MERGE_ROWS), 32 * MERGE_ROWS, 0,
         st>>>(ml, part, (T*)out, (int)rows, NS);
  return (int)cudaGetLastError();
}

// the head dims the kernels are built for
#define DECODE_DIMS(X) X(16) X(32) X(64) X(128) X(256)

}  // namespace

// Writes the head dims the kernels take to out[0 .. 8) and returns their
// number.
extern "C" int paged_decode_dims(int* out) {
  int n = 0;
#define DIM(d) out[n++] = d;
  DECODE_DIMS(DIM)
#undef DIM
  return n;
}

// Tokens one split covers at head dim D (dtype: 0 = float32, 1 =
// bfloat16); 0 when D is not one of DECODE_DIMS.  The wrapper sizes the
// scratch from it: NS = max(1, ceil(P * page_size / split)) splits.
extern "C" int paged_decode_split_tokens(int D, int dtype) {
  switch (D) {
#define CASE(d)                                                \
  case d:                                                      \
    return dtype == 0 ? split_tokens<d>()                      \
                      : mma_split_tokens<d>();
    DECODE_DIMS(CASE)
#undef CASE
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  scratch: B * H * NS * (D + 2)
// floats, NS as paged_decode_split_tokens gives it.
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* pos, void* out, void* scratch,
                                   long long scratch_len, int B, int H,
                                   int Hkv, int D, int PS, int P, int tstride,
                                   int window, int chunked, float cap,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* ps = (const int*)pos;
  float* sc = (float*)scratch;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
#define CASE(d)                                                              \
  case d:                                                                    \
    return dtype == 0                                                        \
               ? launch<float, d>(q, kp, vp, tb, ps, out, sc, scratch_len, B, \
                                  H, Hkv, PS, P, tstride, window, chunked,   \
                                  cap, scale, st)                            \
               : launch<__nv_bfloat16, d>(q, kp, vp, tb, ps, out, sc,        \
                                          scratch_len, B, H, Hkv, PS, P,     \
                                          tstride, window, chunked, cap,     \
                                          scale, st);
    DECODE_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
