// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// These replace the three Pallas kernels of the JAX package
// (pyrecover_tpu/ops/flash_attention.py) and compute what those compute:
// causal (start-aligned, qpos >= kpos) GQA attention with an online softmax
// in fp32, masks for the ragged kv / q tails and for packed-sequence segment
// ids, and the logsumexp the backward recomputes probabilities from.
//
//   TPU kernel (def / pallas_call)   bf16, d 64 and 128         d above 256           otherwise
//   _fwd_kernel     :107 / :212      fwd_wgmma_kernel (sm90)   fwd_chunked_kernel    fwd_kernel (FMA)
//   _bwd_dq_kernel  :238 / :414      dq_wgmma_kernel (sm90)    dq_chunked_kernel     dq_kernel (FMA)
//   _bwd_dkv_kernel :301 / :457      dkv_wgmma_kernel (sm90)   dkv_chunked_kernel    dkv_kernel (FMA)
//
// `dispatch` chooses by dtype and head dim alone (uses_wgmma); nothing falls
// back at run time. The tensor-core kernels, their tiles, their TMA maps and
// their bf16 hi/lo pair for P and dS are in flash_attention_sm90.cuh, with
// their own note; the FMA kernels follow here.
//
// Layouts (row-major, contiguous): q, out, dout, dq (b, s, hq, d);
// k, v, dk, dv (b, sk, hkv, d); lse (b, hq, s) fp32; seg (b, s) int32 or null,
// the queries' segment ids; seg_k (b, sk) int32, the keys' (null: the same as
// seg, which then needs s == sk). A ring block pairs one chunk's queries with
// another chunk's keys, so its two differ.
//
// Bound on the card. Per (batch, q head) a causal pass touches s(s+1)/2
// score positions; the forward does 4*d FLOPs per position (q.k and p.v),
// dq 6*d (s, dp, ds.k) and dk/dv 8*d (s, dp, p.dO, ds.q). At the llama-1b
// shape (b 2, s 2048, hq 16, d 128) that is 34, 52 and 69 GFLOP: 0.035,
// 0.052 and 0.070 ms at the 989 TFLOP/s bf16 tensor-core peak, well above
// the time to move the 25-60 MB of operands at 3.35 TB/s. So all three are
// bound by operations. (The tensor-core kernels issue more, 6*d, 8*d and
// 12*d a position, for the hi/lo pair: see the sm90 note.)
//
// The FMA kernels, the first simple design, kept for fp32 and for bf16 at
// d 16, 32 and 256 (head dims 129-255 are zero-padded to 256 by the
// wrapper; a d 256 tensor-core instance is later work; head dims above 256
// run the chunked variant further down): each block stages fp32 tiles in shared memory and runs
// the two products of each tile as register-tiled fp32 FMA loops (8 rows per
// warp, 2 columns per lane, float4 shared loads on rows padded by 4 floats
// so a warp's loads hit distinct banks) on the 67 TFLOP/s fp32 pipes. Work
// above the causal diagonal is skipped tile by tile, scores never reach
// device memory, and dk/dv are reduced over the GQA group inside one block
// (no atomics, no q-head-width intermediate), as on the TPU. Grid: on the
// TPU the kv axis ran in order with the sums in scratch; here blocks run in
// parallel, so a loop inside the block takes its place:
//   fwd, dq: one block per (q tile of 32 rows, q head, batch), looping over
//            kv tiles of 64 rows up to the diagonal;
//   dkv:     one block per (kv tile of 32 rows, kv head, batch), looping over
//            (q tile of 64 rows x GQA group member) from the diagonal on.
//
// Parts. The library is this file compiled once a part, every part by its
// own nvcc at once, then linked (ops/flash_attention.py::_build): part 0
// holds the C interface and `dispatch`; part k of 1-7 compiles one family's
// instances and exports them as `pyrecover_flash_part<k>`, which `dispatch`
// calls: 1-3 the tensor-core forward, dq and dk/dv, 4-6 the FMA ones, 7 the
// chunked ones. Without FLASH_PART one object holds every part.

#ifdef FLASH_PART
#define IN_PART(k) (FLASH_PART == (k))
#else
#define IN_PART(k) 1
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // rows a block owns: 32
constexpr int kColTile = 64;                     // rows a block sweeps: 2 per lane
constexpr float kNegInf = -1e30f;                // the JAX package's mask fill

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage `rows` rows of D elements into shared memory (leading dimension
// D + 4), converting to fp32. Row r comes from src + (row0 + r) * stride;
// rows at or past n_valid are zero, so ragged tails add nothing to any
// product (the TPU kernel's _zero_oob_rows).
template <typename T, int D>
__device__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                          int rows, int n_valid, long long stride) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, g = row0 + r;
    dst[r * LD + c] = g < n_valid ? to_f(src[(long long)g * stride + c]) : 0.f;
  }
}

// acc[r][c] += <A[warp row r], B[lane + 32 c]> over D, for this warp's
// rows. A: kRowTile x LD, B: kColTile x LD, both in shared memory.
template <int D>
__device__ __forceinline__ void dot_tile_add(float (&acc)[kRowsPerWarp][2],
                                             const float* A, const float* B) {
  constexpr int LD = D + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* a = A + warp * kRowsPerWarp * LD;
  const float* b0 = B + lane * LD;
  const float* b1 = B + (lane + 32) * LD;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(b0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(b1 + k);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(a + r * LD + k);
      acc[r][0] += y.x * x0.x + y.y * x0.y + y.z * x0.z + y.w * x0.w;
      acc[r][1] += y.x * x1.x + y.y * x1.y + y.z * x1.z + y.w * x1.w;
    }
  }
}

// acc[r][c] = <A[warp row r], B[lane + 32 c]> over D.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[kRowsPerWarp][2],
                                         const float* A, const float* B) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
  dot_tile_add<D>(acc, A, B);
}

// out[r][t] += sum_c W[r][c] * M[c][lane + 32 t]: W is this warp's
// kRowsPerWarp x kColTile slab, M is kColTile x LD in shared memory.
template <int D>
__device__ __forceinline__ void accum_rows(float (&out)[kRowsPerWarp][(D + 31) / 32],
                                           const float* W, const float* M) {
  constexpr int LD = D + 4, DT = (D + 31) / 32;
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < kColTile; ++c) {
    float m[DT];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int dd = lane + 32 * t;
      m[t] = dd < D ? M[c * LD + dd] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float w = W[r * kColTile + c];
#pragma unroll
      for (int t = 0; t < DT; ++t) out[r][t] += w * m[t];
    }
  }
}

// ------------------------------ forward ----------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
           T* __restrict__ out, float* __restrict__ lse, int s, int sk,
           int hq, int hkv, int causal, float scale) {
  constexpr int LD = D + 4, DT = (D + 31) / 32, R = kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // kRowTile x LD
  float* sK = sQ + kRowTile * LD;        // kColTile x LD
  float* sV = sK + kColTile * LD;        // kColTile x LD
  float* sP = sV + kColTile * LD;        // kRowTile x kColTile
  int* sSeg = reinterpret_cast<int*>(sP + kRowTile * kColTile);  // kColTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long q_stride = (long long)hq * D, kv_stride = (long long)hkv * D;
  const T* qb = q + ((long long)b * s * hq + h) * D;
  const T* kb = k + ((long long)b * sk * hkv + hk) * D;
  const T* vb = v + ((long long)b * sk * hkv + hk) * D;

  load_rows<T, D>(sQ, qb, q0, kRowTile, s, q_stride);
  int seg_q[R];
  float m[R], l[R], acc[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    seg_q[r] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  int n_tiles = (sk + kColTile - 1) / kColTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kRowTile - 1) / kColTile + 1);
  float* P = sP + warp * R * kColTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kColTile;
    __syncthreads();  // the previous tile is consumed
    load_rows<T, D>(sK, kb, k0, kColTile, sk, kv_stride);
    load_rows<T, D>(sV, vb, k0, kColTile, sk, kv_stride);
    if (seg != nullptr) {
      for (int c = threadIdx.x; c < kColTile; c += kThreads)
        sSeg[c] = k0 + c < sk ? seg_k[(long long)b * sk + k0 + c] : 0;
    }
    __syncthreads();

    float sc[R][2];
    dot_tile<D>(sc, sQ, sK);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + warp * R + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c, kj = k0 + j;
        const bool ok = kj < sk && (!causal || qi >= kj) &&
                        (seg == nullptr || seg_q[r] == sSeg[j]);
        sc[r][c] = ok ? sc[r][c] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sc[r][0], sc[r][1])));
      const float p0 = expf(sc[r][0] - m_new), p1 = expf(sc[r][1] - m_new);
      P[r * kColTile + lane] = p0;
      P[r * kColTile + lane + 32] = p1;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[r][t] *= corr;
      m[r] = m_new;
    }
    __syncwarp();
    accum_rows<D>(acc, P, sV);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= s) continue;
    const float l_safe = l[r] > 0.f ? l[r] : 1.f;
    T* ob = out + (((long long)b * s + qi) * hq + h) * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int dd = lane + 32 * t;
      if (dd < D) ob[dd] = from_f<T>(acc[r][t] / l_safe);
    }
    if (lane == 0) lse[((long long)b * hq + h) * s + qi] = m[r] + logf(l_safe);
  }
}

// -------------------------------- dq -------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
          const T* __restrict__ out, const float* __restrict__ lse,
          const T* __restrict__ dout, T* __restrict__ dq, int s, int sk,
          int hq, int hkv, int causal, float scale) {
  constexpr int LD = D + 4, DT = (D + 31) / 32, R = kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // kRowTile x LD
  float* sDO = sQ + kRowTile * LD;       // kRowTile x LD
  float* sK = sDO + kRowTile * LD;       // kColTile x LD
  float* sV = sK + kColTile * LD;        // kColTile x LD
  float* sP = sV + kColTile * LD;        // kRowTile x kColTile
  int* sSeg = reinterpret_cast<int*>(sP + kRowTile * kColTile);  // kColTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long q_stride = (long long)hq * D, kv_stride = (long long)hkv * D;
  const long long q_base = ((long long)b * s * hq + h) * D;
  const T* kb = k + ((long long)b * sk * hkv + hk) * D;
  const T* vb = v + ((long long)b * sk * hkv + hk) * D;

  load_rows<T, D>(sQ, q + q_base, q0, kRowTile, s, q_stride);
  load_rows<T, D>(sDO, dout + q_base, q0, kRowTile, s, q_stride);
  int seg_q[R];
  float lse_r[R], delta[R], acc[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    // delta = rowsum(dO * O), once per q row
    float part = 0.f;
    if (qi < s) {
      const long long row = q_base + (long long)qi * q_stride;
      for (int dd = lane; dd < D; dd += 32)
        part += to_f(dout[row + dd]) * to_f(out[row + dd]);
    }
    delta[r] = warp_sum(part);
    lse_r[r] = qi < s ? lse[((long long)b * hq + h) * s + qi] : 0.f;
    seg_q[r] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  int n_tiles = (sk + kColTile - 1) / kColTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kRowTile - 1) / kColTile + 1);
  float* P = sP + warp * R * kColTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kColTile;
    __syncthreads();
    load_rows<T, D>(sK, kb, k0, kColTile, sk, kv_stride);
    load_rows<T, D>(sV, vb, k0, kColTile, sk, kv_stride);
    if (seg != nullptr) {
      for (int c = threadIdx.x; c < kColTile; c += kThreads)
        sSeg[c] = k0 + c < sk ? seg_k[(long long)b * sk + k0 + c] : 0;
    }
    __syncthreads();

    float sc[R][2], dp[R][2];
    dot_tile<D>(sc, sQ, sK);
    dot_tile<D>(dp, sDO, sV);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + warp * R + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c, kj = k0 + j;
        const bool ok = kj < sk && (!causal || qi >= kj) &&
                        (seg == nullptr || seg_q[r] == sSeg[j]);
        const float p = expf((ok ? sc[r][c] * scale : kNegInf) - lse_r[r]);
        P[r * kColTile + j] = p * (dp[r][c] - delta[r]) * scale;
      }
    }
    __syncwarp();
    accum_rows<D>(acc, P, sK);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= s) continue;
    T* g = dq + q_base + (long long)qi * q_stride;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int dd = lane + 32 * t;
      if (dd < D) g[dd] = from_f<T>(acc[r][t]);
    }
  }
}

// ------------------------------- dk, dv ----------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
           const T* __restrict__ out, const float* __restrict__ lse,
           const T* __restrict__ dout, T* __restrict__ dk,
           T* __restrict__ dv, int s, int sk, int hq, int hkv, int causal,
           float scale) {
  constexpr int LD = D + 4, DT = (D + 31) / 32, R = kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                      // kRowTile x LD
  float* sV = sK + kRowTile * LD;        // kRowTile x LD
  float* sQ = sV + kRowTile * LD;        // kColTile x LD
  float* sDO = sQ + kColTile * LD;       // kColTile x LD
  float* sP = sDO + kColTile * LD;       // kRowTile x kColTile
  float* sLse = sP + kRowTile * kColTile;  // kColTile
  float* sDelta = sLse + kColTile;         // kColTile
  int* sSeg = reinterpret_cast<int*>(sDelta + kColTile);  // kColTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv0 = blockIdx.x * kRowTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const long long q_stride = (long long)hq * D, kv_stride = (long long)hkv * D;
  const long long kv_base = ((long long)b * sk * hkv + hk) * D;

  load_rows<T, D>(sK, k + kv_base, kv0, kRowTile, sk, kv_stride);
  load_rows<T, D>(sV, v + kv_base, kv0, kRowTile, sk, kv_stride);
  int kseg[R];
  float acc_k[R][DT], acc_v[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = kv0 + warp * R + r;
    kseg[r] = (seg != nullptr && kj < sk) ? seg_k[(long long)b * sk + kj] : 0;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc_k[r][t] = acc_v[r][t] = 0.f;
  }

  const int n_q_tiles = (s + kColTile - 1) / kColTile;
  // causal: q tiles wholly before this kv tile see none of it
  const int first_q_tile = causal ? kv0 / kColTile : 0;
  float* P = sP + warp * R * kColTile;
  for (int iq = first_q_tile; iq < n_q_tiles; ++iq) {
    const int q0 = iq * kColTile;
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const long long q_base = ((long long)b * s * hq + h) * D;
      __syncthreads();
      load_rows<T, D>(sQ, q + q_base, q0, kColTile, s, q_stride);
      load_rows<T, D>(sDO, dout + q_base, q0, kColTile, s, q_stride);
      for (int i = warp; i < kColTile; i += kWarps) {
        const int qi = q0 + i;
        float part = 0.f;
        if (qi < s) {
          const long long row = q_base + (long long)qi * q_stride;
          for (int dd = lane; dd < D; dd += 32)
            part += to_f(dout[row + dd]) * to_f(out[row + dd]);
        }
        part = warp_sum(part);
        if (lane == 0) {
          sDelta[i] = part;
          sLse[i] = qi < s ? lse[((long long)b * hq + h) * s + qi] : 0.f;
          sSeg[i] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
        }
      }
      __syncthreads();

      float sc[R][2], dp[R][2];
      dot_tile<D>(sc, sK, sQ);
      dot_tile<D>(dp, sV, sDO);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kj = kv0 + warp * R + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = lane + 32 * c, qi = q0 + i;
          // q bound, kv tail, causal and segments; p and ds are zeroed
          // outright, not through a -inf score (the TPU kernel's `where`)
          const bool ok = qi < s && kj < sk && (!causal || qi >= kj) &&
                          (seg == nullptr || sSeg[i] == kseg[r]);
          const float p = ok ? expf(sc[r][c] * scale - sLse[i]) : 0.f;
          dp[r][c] = ok ? p * (dp[r][c] - sDelta[i]) * scale : 0.f;
          P[r * kColTile + i] = p;
        }
      }
      __syncwarp();
      accum_rows<D>(acc_v, P, sDO);  // dv += p^T dO
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        P[r * kColTile + lane] = dp[r][0];
        P[r * kColTile + lane + 32] = dp[r][1];
      }
      __syncwarp();
      accum_rows<D>(acc_k, P, sQ);  // dk += ds^T q
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = kv0 + warp * R + r;
    if (kj >= sk) continue;
    const long long row = kv_base + (long long)kj * kv_stride;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int dd = lane + 32 * t;
      if (dd < D) {
        dk[row + dd] = from_f<T>(acc_k[r][t]);
        dv[row + dd] = from_f<T>(acc_v[r][t]);
      }
    }
  }
}

// ------------------------- head dims above 256 ----------------------------
//
// A head dim above 256 is zero-padded by the wrapper to a multiple of
// kChunk (128) and runs these instances. Holding a whole row of the output
// in registers would take 2-4x the d 256 instance's accumulators (dk/dv
// there already uses 238 registers), so the grid gains an axis over output
// chunks of kChunk columns (blockIdx.z = batch * chunks + chunk) and every
// block keeps the d 128 instance's register budget:
//   * the scores S = Q K^T (and dP = dO V^T in the backward) are built by
//     looping over d in chunks of kChunk staged through shared memory, summed
//     in the same order in every block;
//   * each block then accumulates only its own output chunk: the forward's
//     P V, dq's dS K, and dk/dv's dS^T Q and P^T dO.
// Every chunk block of a q tile computes the same scores, so the row max and
// sum of the online softmax agree bit for bit across chunks; the chunk-0
// block writes lse. delta = rowsum(dO * O) is read over the whole row from
// device memory. S is recomputed once per chunk (chunks x the score work of
// an unchunked kernel): the price of a first, simple kernel.
constexpr int kChunk = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
                   T* __restrict__ out, float* __restrict__ lse, int s, int sk,
                   int hq, int hkv, int d, int causal, float scale) {
  constexpr int C = kChunk, LD = C + 4, DT = C / 32, R = kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // kRowTile x LD: a chunk of q
  float* sK = sQ + kRowTile * LD;        // kColTile x LD: a chunk of k
  float* sV = sK + kColTile * LD;        // kColTile x LD: this block's chunk of v
  float* sP = sV + kColTile * LD;        // kRowTile x kColTile
  int* sSeg = reinterpret_cast<int*>(sP + kRowTile * kColTile);  // kColTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = d / C;
  const int q0 = blockIdx.x * kRowTile, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int hk = h / (hq / hkv);
  const long long q_stride = (long long)hq * d, kv_stride = (long long)hkv * d;
  const T* qb = q + ((long long)b * s * hq + h) * d;
  const T* kb = k + ((long long)b * sk * hkv + hk) * d;
  const T* vb = v + ((long long)b * sk * hkv + hk) * d;

  int seg_q[R];
  float m[R], l[R], acc[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    seg_q[r] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  int n_tiles = (sk + kColTile - 1) / kColTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kRowTile - 1) / kColTile + 1);
  float* P = sP + warp * R * kColTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kColTile;
    float sc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r][0] = sc[r][1] = 0.f;
    for (int j = 0; j < nc; ++j) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      load_rows<T, C>(sQ, qb + j * C, q0, kRowTile, s, q_stride);
      load_rows<T, C>(sK, kb + j * C, k0, kColTile, sk, kv_stride);
      if (j == 0 && seg != nullptr) {
        for (int cc = threadIdx.x; cc < kColTile; cc += kThreads)
          sSeg[cc] = k0 + cc < sk ? seg_k[(long long)b * sk + k0 + cc] : 0;
      }
      __syncthreads();
      dot_tile_add<C>(sc, sQ, sK);
    }
    load_rows<T, C>(sV, vb + c * C, k0, kColTile, sk, kv_stride);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + warp * R + r;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jj = lane + 32 * cc, kj = k0 + jj;
        const bool ok = kj < sk && (!causal || qi >= kj) &&
                        (seg == nullptr || seg_q[r] == sSeg[jj]);
        sc[r][cc] = ok ? sc[r][cc] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sc[r][0], sc[r][1])));
      const float p0 = expf(sc[r][0] - m_new), p1 = expf(sc[r][1] - m_new);
      P[r * kColTile + lane] = p0;
      P[r * kColTile + lane + 32] = p1;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[r][t] *= corr;
      m[r] = m_new;
    }
    __syncwarp();
    accum_rows<C>(acc, P, sV);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= s) continue;
    const float l_safe = l[r] > 0.f ? l[r] : 1.f;
    T* ob = out + (((long long)b * s + qi) * hq + h) * d + c * C;
#pragma unroll
    for (int t = 0; t < DT; ++t) ob[lane + 32 * t] = from_f<T>(acc[r][t] / l_safe);
    if (c == 0 && lane == 0) lse[((long long)b * hq + h) * s + qi] = m[r] + logf(l_safe);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
                  const T* __restrict__ out, const float* __restrict__ lse,
                  const T* __restrict__ dout, T* __restrict__ dq, int s, int sk,
                  int hq, int hkv, int d, int causal, float scale) {
  constexpr int C = kChunk, LD = C + 4, DT = C / 32, R = kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // kRowTile x LD
  float* sDO = sQ + kRowTile * LD;       // kRowTile x LD
  float* sK = sDO + kRowTile * LD;       // kColTile x LD
  float* sV = sK + kColTile * LD;        // kColTile x LD
  float* sP = sV + kColTile * LD;        // kRowTile x kColTile
  int* sSeg = reinterpret_cast<int*>(sP + kRowTile * kColTile);  // kColTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = d / C;
  const int q0 = blockIdx.x * kRowTile, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int hk = h / (hq / hkv);
  const long long q_stride = (long long)hq * d, kv_stride = (long long)hkv * d;
  const long long q_base = ((long long)b * s * hq + h) * d;
  const T* kb = k + ((long long)b * sk * hkv + hk) * d;
  const T* vb = v + ((long long)b * sk * hkv + hk) * d;

  int seg_q[R];
  float lse_r[R], delta[R], acc[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    float part = 0.f;  // delta = rowsum(dO * O) over the whole row
    if (qi < s) {
      const long long row = q_base + (long long)qi * q_stride;
      for (int dd = lane; dd < d; dd += 32)
        part += to_f(dout[row + dd]) * to_f(out[row + dd]);
    }
    delta[r] = warp_sum(part);
    lse_r[r] = qi < s ? lse[((long long)b * hq + h) * s + qi] : 0.f;
    seg_q[r] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  int n_tiles = (sk + kColTile - 1) / kColTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kRowTile - 1) / kColTile + 1);
  float* P = sP + warp * R * kColTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kColTile;
    float sc[R][2], dp[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int j = 0; j < nc; ++j) {
      __syncthreads();
      load_rows<T, C>(sQ, q + q_base + j * C, q0, kRowTile, s, q_stride);
      load_rows<T, C>(sDO, dout + q_base + j * C, q0, kRowTile, s, q_stride);
      load_rows<T, C>(sK, kb + j * C, k0, kColTile, sk, kv_stride);
      load_rows<T, C>(sV, vb + j * C, k0, kColTile, sk, kv_stride);
      if (j == 0 && seg != nullptr) {
        for (int cc = threadIdx.x; cc < kColTile; cc += kThreads)
          sSeg[cc] = k0 + cc < sk ? seg_k[(long long)b * sk + k0 + cc] : 0;
      }
      __syncthreads();
      dot_tile_add<C>(sc, sQ, sK);
      dot_tile_add<C>(dp, sDO, sV);
    }
    if (c != nc - 1) {  // the last chunk of k is this block's own when c is last
      __syncthreads();
      load_rows<T, C>(sK, kb + c * C, k0, kColTile, sk, kv_stride);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + warp * R + r;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jj = lane + 32 * cc, kj = k0 + jj;
        const bool ok = kj < sk && (!causal || qi >= kj) &&
                        (seg == nullptr || seg_q[r] == sSeg[jj]);
        const float p = expf((ok ? sc[r][cc] * scale : kNegInf) - lse_r[r]);
        P[r * kColTile + jj] = p * (dp[r][cc] - delta[r]) * scale;
      }
    }
    __syncwarp();
    accum_rows<C>(acc, P, sK);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= s) continue;
    T* g = dq + q_base + (long long)qi * q_stride + c * C;
#pragma unroll
    for (int t = 0; t < DT; ++t) g[lane + 32 * t] = from_f<T>(acc[r][t]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dkv_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
                   const T* __restrict__ out, const float* __restrict__ lse,
                   const T* __restrict__ dout, T* __restrict__ dk,
                   T* __restrict__ dv, int s, int sk, int hq, int hkv, int d,
                   int causal, float scale) {
  constexpr int C = kChunk, LD = C + 4, DT = C / 32, R = kRowsPerWarp;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                        // kRowTile x LD
  float* sV = sK + kRowTile * LD;          // kRowTile x LD
  float* sQ = sV + kRowTile * LD;          // kColTile x LD
  float* sDO = sQ + kColTile * LD;         // kColTile x LD
  float* sP = sDO + kColTile * LD;         // kRowTile x kColTile
  float* sLse = sP + kRowTile * kColTile;  // kColTile
  float* sDelta = sLse + kColTile;         // kColTile
  int* sSeg = reinterpret_cast<int*>(sDelta + kColTile);  // kColTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = d / C;
  const int kv0 = blockIdx.x * kRowTile, hk = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int group = hq / hkv;
  const long long q_stride = (long long)hq * d, kv_stride = (long long)hkv * d;
  const long long kv_base = ((long long)b * sk * hkv + hk) * d;

  int kseg[R];
  float acc_k[R][DT], acc_v[R][DT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = kv0 + warp * R + r;
    kseg[r] = (seg != nullptr && kj < sk) ? seg_k[(long long)b * sk + kj] : 0;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc_k[r][t] = acc_v[r][t] = 0.f;
  }

  const int n_q_tiles = (s + kColTile - 1) / kColTile;
  const int first_q_tile = causal ? kv0 / kColTile : 0;
  float* P = sP + warp * R * kColTile;
  for (int iq = first_q_tile; iq < n_q_tiles; ++iq) {
    const int q0 = iq * kColTile;
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const long long q_base = ((long long)b * s * hq + h) * d;
      __syncthreads();
      for (int i = warp; i < kColTile; i += kWarps) {
        const int qi = q0 + i;
        float part = 0.f;
        if (qi < s) {
          const long long row = q_base + (long long)qi * q_stride;
          for (int dd = lane; dd < d; dd += 32)
            part += to_f(dout[row + dd]) * to_f(out[row + dd]);
        }
        part = warp_sum(part);
        if (lane == 0) {
          sDelta[i] = part;
          sLse[i] = qi < s ? lse[((long long)b * hq + h) * s + qi] : 0.f;
          sSeg[i] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
        }
      }
      float sc[R][2], dp[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.f;
      for (int j = 0; j < nc; ++j) {
        __syncthreads();
        load_rows<T, C>(sK, k + kv_base + j * C, kv0, kRowTile, sk, kv_stride);
        load_rows<T, C>(sV, v + kv_base + j * C, kv0, kRowTile, sk, kv_stride);
        load_rows<T, C>(sQ, q + q_base + j * C, q0, kColTile, s, q_stride);
        load_rows<T, C>(sDO, dout + q_base + j * C, q0, kColTile, s, q_stride);
        __syncthreads();
        dot_tile_add<C>(sc, sK, sQ);
        dot_tile_add<C>(dp, sV, sDO);
      }
      if (c != nc - 1) {  // this block's chunk of q and dO
        __syncthreads();
        load_rows<T, C>(sQ, q + q_base + c * C, q0, kColTile, s, q_stride);
        load_rows<T, C>(sDO, dout + q_base + c * C, q0, kColTile, s, q_stride);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kj = kv0 + warp * R + r;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = lane + 32 * cc, qi = q0 + i;
          const bool ok = qi < s && kj < sk && (!causal || qi >= kj) &&
                          (seg == nullptr || sSeg[i] == kseg[r]);
          const float p = ok ? expf(sc[r][cc] * scale - sLse[i]) : 0.f;
          dp[r][cc] = ok ? p * (dp[r][cc] - sDelta[i]) * scale : 0.f;
          P[r * kColTile + i] = p;
        }
      }
      __syncwarp();
      accum_rows<C>(acc_v, P, sDO);  // dv += p^T dO
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        P[r * kColTile + lane] = dp[r][0];
        P[r * kColTile + lane + 32] = dp[r][1];
      }
      __syncwarp();
      accum_rows<C>(acc_k, P, sQ);  // dk += ds^T q
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = kv0 + warp * R + r;
    if (kj >= sk) continue;
    const long long row = kv_base + (long long)kj * kv_stride + c * C;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      dk[row + lane + 32 * t] = from_f<T>(acc_k[r][t]);
      dv[row + lane + 32 * t] = from_f<T>(acc_v[r][t]);
    }
  }
}

// ------------------------------ launchers --------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)kRowTile * (D + 4) + 2 * kColTile * (D + 4) +
                          kRowTile * kColTile) + sizeof(int) * kColTile;
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (size_t)kRowTile * (D + 4) + 2 * kColTile * (D + 4) +
                          kRowTile * kColTile) + sizeof(int) * kColTile;
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (size_t)kRowTile * (D + 4) + 2 * kColTile * (D + 4) +
                          kRowTile * kColTile + 2 * kColTile) + sizeof(int) * kColTile;
}

struct Args {
  const void *q, *k, *v, *seg, *seg_k, *out, *lse, *dout;
  void *res0, *res1;
  int b, s, sk, hq, hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  auto kern = fwd_kernel<T, D>;
  const size_t smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s + kRowTile - 1) / kRowTile, a.hq, a.b);
  kern<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.seg, (const int*)a.seg_k,
      (T*)a.res0, (float*)a.res1, a.s, a.sk, a.hq, a.hkv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  auto kern = dq_kernel<T, D>;
  const size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s + kRowTile - 1) / kRowTile, a.hq, a.b);
  kern<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.seg, (const int*)a.seg_k,
      (const T*)a.out, (const float*)a.lse, (const T*)a.dout, (T*)a.res0,
      a.s, a.sk, a.hq, a.hkv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  auto kern = dkv_kernel<T, D>;
  const size_t smem = dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sk + kRowTile - 1) / kRowTile, a.hkv, a.b);
  kern<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.seg, (const int*)a.seg_k,
      (const T*)a.out, (const float*)a.lse, (const T*)a.dout, (T*)a.res0,
      (T*)a.res1, a.s, a.sk, a.hq, a.hkv, a.causal, a.scale);
  return cudaGetLastError();
}

constexpr size_t chunked_smem(int which) {
  constexpr size_t LD = kChunk + 4;
  return which == 0
      ? sizeof(float) * (kRowTile * LD + 2 * kColTile * LD + kRowTile * kColTile) +
            sizeof(int) * kColTile
      : sizeof(float) * (2 * kRowTile * LD + 2 * kColTile * LD + kRowTile * kColTile +
                         (which == 2 ? 2 * kColTile : 0)) +
            sizeof(int) * kColTile;
}

// Head dims above 256, a multiple of kChunk: grid (row tiles, heads,
// batch x chunks). Shared memory fwd 92,928 B, dq 109,824 B, dk/dv
// 110,592 B whatever d is.
template <typename T>
cudaError_t launch_chunked(int which, int d, const Args& a) {
  if (d % kChunk != 0) return cudaErrorInvalidValue;
  const int nc = d / kChunk;
  const size_t smem = chunked_smem(which);
  const int rows = which == 2 ? a.sk : a.s;
  const dim3 grid((rows + kRowTile - 1) / kRowTile, which == 2 ? a.hkv : a.hq, a.b * nc);
  cudaError_t e = cudaSuccess;
  switch (which) {
    case 0:
      e = cudaFuncSetAttribute(fwd_chunked_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      fwd_chunked_kernel<T><<<grid, kThreads, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.seg, (const int*)a.seg_k, (T*)a.res0,
          (float*)a.res1, a.s, a.sk, a.hq, a.hkv, d, a.causal, a.scale);
      break;
    case 1:
      e = cudaFuncSetAttribute(dq_chunked_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      dq_chunked_kernel<T><<<grid, kThreads, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.seg, (const int*)a.seg_k, (const T*)a.out,
          (const float*)a.lse, (const T*)a.dout, (T*)a.res0, a.s, a.sk, a.hq, a.hkv, d,
          a.causal, a.scale);
      break;
    case 2:
      e = cudaFuncSetAttribute(dkv_chunked_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      dkv_chunked_kernel<T><<<grid, kThreads, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.seg, (const int*)a.seg_k, (const T*)a.out,
          (const float*)a.lse, (const T*)a.dout, (T*)a.res0, (T*)a.res1, a.s, a.sk, a.hq,
          a.hkv, d, a.causal, a.scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// W: 0 forward, 1 dq, 2 dk/dv. bf16 at d 64/128 goes to the tensor-core
// kernels (uses_wgmma), so its FMA instances are not built.
template <int W, typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr bool tensor_core = std::is_same<T, __nv_bfloat16>::value && (D == 64 || D == 128);
  if constexpr (!tensor_core) {
    if constexpr (W == 0) return launch_fwd<T, D>(a);
    if constexpr (W == 1) return launch_dq<T, D>(a);
    if constexpr (W == 2) return launch_dkv<T, D>(a);
  }
  return cudaErrorInvalidValue;
}

template <int W, typename T>
cudaError_t dispatch_dim(int d, const Args& a) {
  switch (d) {
    case 16: return launch<W, T, 16>(a);
    case 32: return launch<W, T, 32>(a);
    case 64: return launch<W, T, 64>(a);
    case 128: return launch<W, T, 128>(a);
    // Gemma's head dim: the FMA instances only. Shared memory at D = 256 is
    // fwd 174,848 B, dq 208,128 B and dk/dv 208,640 B, under the 227 KB
    // opt-in each launcher asks for with cudaFuncSetAttribute.
    case 256: return launch<W, T, 256>(a);
  }
  return cudaErrorInvalidValue;
}

// One FMA family (W) at either dtype (0 fp32, 1 bf16).
template <int W>
cudaError_t dispatch_fma(int dtype, int d, const Args& a) {
  return dtype == 0 ? dispatch_dim<W, float>(d, a) : dispatch_dim<W, __nv_bfloat16>(d, a);
}

}  // namespace

// ------------------------------- the parts --------------------------------

// A part's entry: `which` (0 forward, 1 dq, 2 dk/dv), dtype (0 fp32, 1 bf16)
// and head dim checked by `dispatch`; `args` an Args.
extern "C" {
int pyrecover_flash_part1(int which, int dtype, int d, const void* args);
int pyrecover_flash_part2(int which, int dtype, int d, const void* args);
int pyrecover_flash_part3(int which, int dtype, int d, const void* args);
int pyrecover_flash_part4(int which, int dtype, int d, const void* args);
int pyrecover_flash_part5(int which, int dtype, int d, const void* args);
int pyrecover_flash_part6(int which, int dtype, int d, const void* args);
int pyrecover_flash_part7(int which, int dtype, int d, const void* args);
}

#if IN_PART(1)
int pyrecover_flash_part1(int, int, int d, const void* args) {
  return (int)sm90::launch_fwd(d, *static_cast<const Args*>(args));
}
#endif
#if IN_PART(2)
int pyrecover_flash_part2(int, int, int d, const void* args) {
  return (int)sm90::launch_dq(d, *static_cast<const Args*>(args));
}
#endif
#if IN_PART(3)
int pyrecover_flash_part3(int, int, int d, const void* args) {
  return (int)sm90::launch_dkv(d, *static_cast<const Args*>(args));
}
#endif
#if IN_PART(4)
int pyrecover_flash_part4(int, int dtype, int d, const void* args) {
  return (int)dispatch_fma<0>(dtype, d, *static_cast<const Args*>(args));
}
#endif
#if IN_PART(5)
int pyrecover_flash_part5(int, int dtype, int d, const void* args) {
  return (int)dispatch_fma<1>(dtype, d, *static_cast<const Args*>(args));
}
#endif
#if IN_PART(6)
int pyrecover_flash_part6(int, int dtype, int d, const void* args) {
  return (int)dispatch_fma<2>(dtype, d, *static_cast<const Args*>(args));
}
#endif
#if IN_PART(7)
int pyrecover_flash_part7(int which, int dtype, int d, const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  return (int)(dtype == 0 ? launch_chunked<float>(which, d, a)
                          : launch_chunked<__nv_bfloat16>(which, d, a));
}
#endif

#if IN_PART(0)
namespace {

// The dispatch rule: bf16 at head dim 64 or 128, all three kernels.
bool uses_wgmma(int which, int dtype, int d) {
  return dtype == 1 && (d == 64 || d == 128) && (which == 0 || which == 1 || which == 2);
}

using PartFn = int (*)(int, int, int, const void*);
const PartFn kTensorCoreParts[3] = {pyrecover_flash_part1, pyrecover_flash_part2,
                                    pyrecover_flash_part3};
const PartFn kFmaParts[3] = {pyrecover_flash_part4, pyrecover_flash_part5,
                             pyrecover_flash_part6};

cudaError_t dispatch(int which, int dtype, int d, const Args& a) {
  if (a.b == 0 || a.s == 0 || a.sk == 0 || a.hq == 0) return cudaSuccess;
  if (a.hkv <= 0 || a.hq % a.hkv != 0) return cudaErrorInvalidValue;
  if (which < 0 || which > 2 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const PartFn part = uses_wgmma(which, dtype, d) ? kTensorCoreParts[which]
                      : d > 256                   ? pyrecover_flash_part7
                                                  : kFmaParts[which];
  return (cudaError_t)part(which, dtype, d, &a);
}

}  // namespace

// Plain C interface, bound with ctypes. dtype: 0 fp32, 1 bf16. Each call
// launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" {

int pyrecover_flash_fwd(const void* q, const void* k, const void* v,
                        const void* seg, const void* seg_k, void* out,
                        void* lse, int b, int s, int sk, int hq, int hkv,
                        int d, int causal, float scale, int dtype,
                        void* stream) {
  Args a{q, k, v, seg, seg_k ? seg_k : seg, nullptr, nullptr, nullptr, out, lse,
         b, s, sk, hq, hkv, causal, scale, (cudaStream_t)stream};
  return (int)dispatch(0, dtype, d, a);
}

int pyrecover_flash_bwd_dq(const void* q, const void* k, const void* v,
                           const void* seg, const void* seg_k,
                           const void* out, const void* lse,
                           const void* dout, void* dq, int b, int s, int sk,
                           int hq, int hkv, int d, int causal, float scale,
                           int dtype, void* stream) {
  Args a{q, k, v, seg, seg_k ? seg_k : seg, out, lse, dout, dq, nullptr,
         b, s, sk, hq, hkv, causal, scale, (cudaStream_t)stream};
  return (int)dispatch(1, dtype, d, a);
}

int pyrecover_flash_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* seg, const void* seg_k,
                            const void* out, const void* lse,
                            const void* dout, void* dk, void* dv, int b,
                            int s, int sk, int hq, int hkv, int d,
                            int causal, float scale, int dtype,
                            void* stream) {
  Args a{q, k, v, seg, seg_k ? seg_k : seg, out, lse, dout, dk, dv,
         b, s, sk, hq, hkv, causal, scale, (cudaStream_t)stream};
  return (int)dispatch(2, dtype, d, a);
}

// Which instance `which` (0 forward, 1 dq, 2 dk/dv) runs for this dtype and
// head dim: 1 a tensor-core kernel, 2 the head-dim-chunked FMA kernels
// (d above 256), 0 an FMA kernel.
int pyrecover_flash_route(int which, int dtype, int d) {
  return uses_wgmma(which, dtype, d) ? 1 : (d > 256 ? 2 : 0);
}

const char* pyrecover_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
#endif  // IN_PART(0)
