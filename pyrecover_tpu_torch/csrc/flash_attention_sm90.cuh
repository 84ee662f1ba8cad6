// Tensor-core flash attention for Hopper (sm_90a): the forward (K1), dq (K2)
// and dk/dv (K3) kernels for bf16 at head_dim 64 and 128. Included by
// flash_attention.cu, whose dispatch sends those instances here; fp32 and
// bf16 at d 16/32 stay on the FMA kernels there.
//
//   fwd_wgmma_kernel <- _fwd_kernel     (pyrecover_tpu/ops/flash_attention.py:107)
//   dq_wgmma_kernel  <- _bwd_dq_kernel  (pyrecover_tpu/ops/flash_attention.py:238)
//   dkv_wgmma_kernel <- _bwd_dkv_kernel (pyrecover_tpu/ops/flash_attention.py:301)
//
// They compute what the FMA kernels and the plain versions compute, with one
// precision rule carried over from the JAX kernels: the probabilities P (and
// dS in the backward) stay fp32 for the second product of each tile. The
// tensor cores take bf16 operands, so P enters as a pair, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), in two products summed in the fp32 accumulator.
// Rounding P or dS to bf16 alone (what FA2/FA3 do) misses the kernels' bf16
// limits by 58-111x at s 1024-2048 (tests/test_torch_flash_attention.py pins
// this for out, dq, dk and dv).
//
// Bound on the card. A causal pass touches s(s+1)/2 score positions per
// (batch, q head). The function costs 4*d FLOPs a position in the forward
// (q.k, p.v), 6*d in dq (s, dp, ds.k) and 8*d in dk/dv (s, dp, p^T.dO,
// ds^T.q); the hi/lo pair makes the second products twice as long, so the
// tensor cores do 6*d, 8*d and 12*d. At the llama-1b shape (b 2, s 2048,
// hq 16, hkv 8, d 128) that is 34, 52 and 69 GFLOP of function (0.035,
// 0.052 and 0.070 ms at 989 TFLOP/s), 52, 69 and 103 GFLOP issued; the
// operands (25-60 MB) move in 0.01-0.02 ms. All three are bound by
// operations.
//
// Design. One warpgroup (128 threads) per block owns 64 rows, wgmma's M:
//   fwd, dq: one block per (64-row q tile, q head, batch), looping over
//        64-row kv tiles up to the diagonal;
//   dkv: one block per (64-row kv tile, kv head, batch), looping over
//        (64-row q tile x GQA group member) from the diagonal on, so dk and
//        dv are summed over the group in registers, with no atomics.
// Tiles arrive by TMA from a 4-D tensor map (d, heads, s, b) per tensor,
// through a ring of 2 stages, in bf16, 128-byte swizzled: a 64-column box per
// 64 bf16 of the head dim. Rows past s (or sk) come back zero, which is the
// TPU kernel's _zero_oob_rows, and never the next batch's rows. The block's
// own thread 0 issues the copies: the copy of tile i+2 starts when tile i is
// consumed, so it runs under the compute of tile i+1.
//   S = Q K^T (fwd, dq), dP = dO V^T (dq) and S^T = K Q^T, dP^T = V dO^T
//     (dkv): wgmma m64n64k16, both operands K-major from shared memory.
//   O += P V (fwd), dQ += dS K (dq), dV += P^T dO and dK += dS^T Q (dkv):
//     wgmma m64n{64,d}k16 with A from registers (the accumulator layout of
//     the first product is the A-fragment layout of the second) and B read
//     MN-major (trans-b).
// The online softmax runs on the accumulator fragment: each row lives on the
// 4 lanes of a quad; so do lse and delta = rowsum(dO * O) in the backward,
// staged per q tile through shared memory. Masks (causal, kv tail, q tail,
// segments) are applied only on tiles that need them. Blocks with the most
// tiles launch first.
//
// Tiles: 64 x 64 score tiles keep the forward at 82 KB of shared memory
// (d 128), dq at 98 KB and dk/dv at 99 KB, so two blocks share an SM and
// one's elementwise work runs under the other's products. dq and dk/dv sum
// each tile's second products (dS K; dV and dK) in a fresh accumulator, a
// 64-column slab at a time, and add them to the running sums in fp32
// (add_pair_product says why). At d 128 dk/dv holds 128 fp32 sums, the two
// bf16 pairs and a 32-register slab, near the 255 registers that two
// 128-thread blocks per SM allow; dq holds 64 sums, S, dP, one pair and the
// slab.
// ptxas (-Xptxas -v, CUDA 12.9): fwd 167 registers at d 128, 130 at
// d 64; dq 198 at d 128, 165 at d 64, neither with spill; dk/dv 255 at
// d 128 with 208 bytes of spill stores and 156 of spill loads, 219 at d 64
// with none.
// Times on the card, beside these bounds: PERF.md §6 (chip_smoke.py).

#include <cuda.h>  // CUtensorMap and its enums; the driver entry is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;             // one warpgroup
constexpr int kRows = 64;                 // rows of every tile: wgmma's M
constexpr int kBoxBytes = kRows * 128;    // one 64-row x 64-column bf16 box
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;         // the JAX package's mask fill

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------ barriers, TMA -----------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-row tile of head `head` from row `row`, all D columns: D / 64 boxes
// of 64 columns, each 8 KB of shared memory, completing on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row, int batch) {
#pragma unroll
  for (int box = 0; box < D / 64; ++box) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst + box * kBoxBytes),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(box * 64), "r"(head), "r"(row), "r"(batch),
        "r"(bar)
        : "memory");
  }
}

// --------------------------------- wgmma ----------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers a wgmma reads or writes asynchronously: pin them after the wait,
// so the compiler neither reads an accumulator early nor reuses a fragment's
// register while the tensor cores still read it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptors for 128-byte swizzled tiles (rows of 128
// bytes, 8-row groups 1024 bytes apart, so SBO = 1024).
// K-major: the contraction runs along the row; LBO is unused.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// MN-major: N runs along the row, 64 columns a box; the next 64 columns are
// in the next box, kBoxBytes on (LBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}
// k-step kk (16 columns) of a K-major 64-row tile, and of an MN-major one
// (16 rows).
__device__ __forceinline__ uint32_t kstep_k(uint32_t tile, int kk) {
  return tile + (kk / 4) * kBoxBytes + (kk % 4) * 32;
}
__device__ __forceinline__ uint32_t kstep_mn(uint32_t tile, int kk) { return tile + kk * 16 * 128; }

// D (64 x 64, fp32) (+)= A (64 x 16) * B (16 x 64); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64);
// B MN-major (N contiguous) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 128);
// B MN-major (N contiguous) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc (64 x 64 fp32, 32 a thread) = A (64 x D) B^T (64 x D); both K-major tiles.
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(acc, desc_k(kstep_k(a, kk)), desc_k(kstep_k(b, kk)), kk > 0);
}

// Split columns 16c..16c+15 of a 64 x 64 fp32 accumulator into the bf16
// A fragments of the hi/lo pair: x = hi + lo + O(2^-16 x).
__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}
__device__ __forceinline__ void split_hi_lo(const float (&acc)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = acc[8 * c + 2 * r], x1 = acc[8 * c + 2 * r + 1];
      const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
      hi[c][r] = pack2(h0, h1);
      lo[c][r] = pack2(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                       __float2bfloat16_rn(x1 - __bfloat162float(h1)));
    }
}

// acc (64 x D) += (hi + lo) (64 x 64) * B (64 x D), B an MN-major tile.
template <int N>
__device__ __forceinline__ void issue_pair(float (&acc)[N], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], uint32_t b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    wgmma_rs(acc, hi[c], desc_mn(kstep_mn(b, c)));
    wgmma_rs(acc, lo[c], desc_mn(kstep_mn(b, c)));
  }
}

// acc (64 x D) += (hi + lo) (64 x 64) * B (64 x D), B an MN-major tile, in
// 64-column slabs: each slab's product goes to a fresh accumulator and is
// then added to acc by an ordinary fp32 add. The tensor cores' accumulator
// does not round to nearest, so a sum carried through a whole q loop inside
// it shrinks by a fraction of an ulp at every step: dk/dv drifted to a
// relative norm of 4.1e-4 at llama-8b's shape (group 4, s 2048) that way,
// against 5e-4 allowed and 1e-4 for the FMA kernel.
template <int D>
__device__ __forceinline__ void add_pair_product(float (&acc)[D / 2], const uint32_t (&hi)[4][4],
                                                 const uint32_t (&lo)[4][4], uint32_t b) {
#pragma unroll
  for (int slab = 0; slab < D / 64; ++slab) {
    float part[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) part[j] = 0.f;
    wg_fence();
    issue_pair(part, hi, lo, b + slab * kBoxBytes);
    wg_commit();
    wg_wait();
    pin(part);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[32 * slab + j] += part[j];
  }
}

// Accumulator element i of a thread: row 16*warp + g + 8*((i >> 1) & 1),
// column 8*(i >> 2) + 2*t + (i & 1), with g = lane / 4, t = lane % 4.
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + (i & 1); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The dynamic shared memory, moved up to the 1024-byte alignment that the
// 128-byte swizzle needs (launchers ask for 1 KB more than they use).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ------------------------------ forward (K1) -------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
    const int* __restrict__ seg_k,
                 bf16* __restrict__ out, float* __restrict__ lse, int s, int sk, int hq,
                 int hkv, int causal, float scale) {
  constexpr int kTile = (D / 64) * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // Q | K stage 0, 1 | V stage 0, 1 | barriers (Q, kv 0, kv 1) | kv tile's segment ids
  const uint32_t sQ = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 5 * kTile);
  int* sSeg = reinterpret_cast<int*>(bars + 4);
  const uint32_t bar_q = smem_u32(bars);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (hq / hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // the longest q tiles first
  int n_tiles = (sk + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kRows + 1);

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTile);
    tma_tile<D>(sQ, &tm_q, bar_q, h, q0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st) {
      const uint32_t bar = smem_u32(bars + 1 + st);
      mbar_expect_tx(bar, 2 * kTile);
      tma_tile<D>(sQ + (1 + st) * kTile, &tm_k, bar, hk, st * kRows, b);
      tma_tile<D>(sQ + (3 + st) * kTile, &tm_v, bar, hk, st * kRows, b);
    }
  }
  __syncwarp();

  const int t2 = 2 * (lane % 4);
  int row[2], seg_q[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + 16 * warp + lane / 4 + 8 * r;
    seg_q[r] = (seg != nullptr && row[r] < s) ? seg[(long long)b * s + row[r]] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float o[D / 2], sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t p_hi[4][4], p_lo[4][4];

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, k0 = it * kRows;
    const uint32_t sK = sQ + (1 + st) * kTile, sV = sQ + (3 + st) * kTile;
    // masks on the diagonal tiles, the ragged last tile, and with segments
    const bool masked = (causal && k0 + kRows - 1 > q0) || k0 + kRows > sk || seg != nullptr;
    if (seg != nullptr) {
      if (tid < kRows) sSeg[tid] = k0 + tid < sk ? seg_k[(long long)b * sk + k0 + tid] : 0;
      __syncthreads();
    }
    mbar_wait(smem_u32(bars + 1 + st), (it / kStages) & 1);

    wg_fence();
    issue_scores<D>(sc, sQ, sK);
    wg_commit();
    wg_wait();
    pin(sc);

    // online softmax on the fragment, in the plain version's arithmetic
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (masked) {
        const int kj = k0 + acc_col(i) + t2;
        const bool ok = kj < sk && (!causal || row[r] >= kj) &&
                        (seg == nullptr || seg_q[r] == sSeg[kj - k0]);
        x = ok ? x : kNegInf;
      }
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = expf(sc[i] - m[(i >> 1) & 1]);
      rsum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rsum[r]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V with P as the bf16 pair
    split_hi_lo(sc, p_hi, p_lo);
    pin(o);
    wg_fence();
    issue_pair(o, p_hi, p_lo, sV);
    wg_commit();
    wg_wait();
    pin(o);
    pin(p_hi);
    pin(p_lo);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + kStages < n_tiles) {
      const uint32_t bar = smem_u32(bars + 1 + st);
      mbar_expect_tx(bar, 2 * kTile);
      tma_tile<D>(sK, &tm_k, bar, hk, k0 + kStages * kRows, b);
      tma_tile<D>(sV, &tm_v, bar, hk, k0 + kStages * kRows, b);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s) continue;
    const float l_safe = l[r] > 0.f ? l[r] : 1.f;
    bf16* ob = out + (((long long)b * s + row[r]) * hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + t2) =
          __floats2bfloat162_rn(o[i] / l_safe, o[i + 1] / l_safe);
    }
    if (t2 == 0) lse[((long long)b * hq + h) * s + row[r]] = m[r] + logf(l_safe);
  }
}

// ---------------------------------- dq (K2) ----------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const int* __restrict__ seg,
    const int* __restrict__ seg_k, const bf16* __restrict__ out,
                const float* __restrict__ lse, const bf16* __restrict__ dout,
                bf16* __restrict__ dq, int s, int sk, int hq, int hkv, int causal, float scale) {
  constexpr int kTile = (D / 64) * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // Q | dO | K stage 0, 1 | V stage 0, 1 | barriers (Q and dO, kv 0, kv 1) |
  // the q tile's lse and delta | the kv tile's segment ids
  const uint32_t sQ = smem_u32(smem), sDO = sQ + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 6 * kTile);
  float* sLse = reinterpret_cast<float*>(bars + 4);
  float* sDelta = sLse + kRows;
  int* sSeg = reinterpret_cast<int*>(sDelta + kRows);
  const uint32_t bar_q = smem_u32(bars);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (hq / hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // the longest q tiles first
  int n_tiles = (sk + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kRows + 1);

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * kTile);
    tma_tile<D>(sQ, &tm_q, bar_q, h, q0, b);
    tma_tile<D>(sDO, &tm_do, bar_q, h, q0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st) {
      const uint32_t bar = smem_u32(bars + 1 + st);
      mbar_expect_tx(bar, 2 * kTile);
      tma_tile<D>(sQ + (2 + st) * kTile, &tm_k, bar, hk, st * kRows, b);
      tma_tile<D>(sQ + (4 + st) * kTile, &tm_v, bar, hk, st * kRows, b);
    }
  }
  __syncwarp();
  // the q tile's lse and delta = rowsum(dO * O), as dk/dv's prefetch stages
  // them (that copy stays inline: moving it into a shared helper raised dk/dv's
  // spill at d 128 from 208 to 328 bytes)
  if (tid < kRows) sLse[tid] = q0 + tid < s ? lse[((long long)b * hq + h) * s + q0 + tid] : 0.f;
  {  // two threads a row, D / 2 columns each, 8 bf16 a load
    const int qi = q0 + tid / 2;
    float part = 0.f;
    if (qi < s) {
      const long long base = (((long long)b * s + qi) * hq + h) * D + (tid % 2) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + base + c);
        const uint4 y = *reinterpret_cast<const uint4*>(out + base + c);
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(xs[e]), o2 = __bfloat1622float2(ys[e]);
          part += a.x * o2.x + a.y * o2.y;
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (tid % 2 == 0) sDelta[tid / 2] = part;
  }
  __syncthreads();

  const int t2 = 2 * (lane % 4);
  int row[2], seg_q[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 16 * warp + lane / 4 + 8 * r;
    row[r] = q0 + i;
    lse_r[r] = sLse[i];
    delta_r[r] = sDelta[i];
    seg_q[r] = (seg != nullptr && row[r] < s) ? seg[(long long)b * s + row[r]] : 0;
  }
  float acc[D / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t ds_hi[4][4], ds_lo[4][4];

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, k0 = it * kRows;
    const uint32_t sK = sQ + (2 + st) * kTile, sV = sQ + (4 + st) * kTile;
    // masks on the diagonal tiles, the ragged last tile, and with segments;
    // q rows past s are never written, so they need none
    const bool masked = (causal && k0 + kRows - 1 > q0) || k0 + kRows > sk || seg != nullptr;
    if (seg != nullptr) {
      if (tid < kRows) sSeg[tid] = k0 + tid < sk ? seg_k[(long long)b * sk + k0 + tid] : 0;
      __syncthreads();
    }
    mbar_wait(smem_u32(bars + 1 + st), (it / kStages) & 1);

    // S = Q K^T and dP = dO V^T
    wg_fence();
    issue_scores<D>(sc, sQ, sK);
    issue_scores<D>(dp, sDO, sV);
    wg_commit();
    wg_wait();
    pin(sc);
    pin(dp);

    // dS = P (dP - delta) scale, P = exp(S scale - lse) with masked scores
    // at -1e30 before the exp (the plain version's arithmetic)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (masked) {
        const int kj = k0 + acc_col(i) + t2;
        const bool ok = kj < sk && (!causal || row[r] >= kj) &&
                        (seg == nullptr || seg_q[r] == sSeg[kj - k0]);
        x = ok ? x : kNegInf;
      }
      dp[i] = expf(x - lse_r[r]) * (dp[i] - delta_r[r]) * scale;
    }

    // dQ += dS K with dS as the bf16 pair, this kv tile's product summed
    // apart and then added in fp32; K is read MN-major, as the forward reads V
    split_hi_lo(dp, ds_hi, ds_lo);
    add_pair_product<D>(acc, ds_hi, ds_lo, sK);
    pin(ds_hi);
    pin(ds_lo);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + kStages < n_tiles) {
      const uint32_t bar = smem_u32(bars + 1 + st);
      mbar_expect_tx(bar, 2 * kTile);
      tma_tile<D>(sK, &tm_k, bar, hk, k0 + kStages * kRows, b);
      tma_tile<D>(sV, &tm_v, bar, hk, k0 + kStages * kRows, b);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s) continue;
    bf16* g = dq + (((long long)b * s + row[r]) * hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(g + 8 * j + t2) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// ------------------------------- dk, dv (K3) -------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const int* __restrict__ seg,
    const int* __restrict__ seg_k, const bf16* __restrict__ out,
                 const float* __restrict__ lse, const bf16* __restrict__ dout,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int sk, int hq, int hkv,
                 int causal, float scale) {
  constexpr int kTile = (D / 64) * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  // K | V | Q stage 0, 1 | dO stage 0, 1 | barriers (kv, stage 0, 1) |
  // per stage: the q tile's lse, delta and segment ids
  const uint32_t sK = smem_u32(smem), sV = sK + kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 6 * kTile);
  float* sLse = reinterpret_cast<float*>(bars + 4);  // [kStages][kRows]
  float* sDelta = sLse + kStages * kRows;
  int* sSeg = reinterpret_cast<int*>(sDelta + kStages * kRows);
  const uint32_t bar_kv = smem_u32(bars);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y, kv0 = blockIdx.z * kRows;  // longest first
  const int group = hq / hkv;
  const int n_q_tiles = (s + kRows - 1) / kRows;
  // causal: q tiles wholly before this kv tile see none of it
  const int first = causal ? kv0 / kRows : 0;
  const int n_it = max(n_q_tiles - first, 0) * group;
  const int t2 = 2 * (lane % 4);
  int kv_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kv_row[r] = kv0 + 16 * warp + lane / 4 + 8 * r;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  // Stage iteration n (q tile, group member) into stage n % kStages: lse,
  // delta = rowsum(dO * O) and segment ids by all threads, Q and dO by TMA.
  auto prefetch = [&](int n) {
    const int st = n % kStages, q0 = (first + n / group) * kRows;
    const int h = hk * group + n % group;
    if (tid < kRows) {
      const int qi = q0 + tid;
      sLse[st * kRows + tid] = qi < s ? lse[((long long)b * hq + h) * s + qi] : 0.f;
      sSeg[st * kRows + tid] = (seg != nullptr && qi < s) ? seg[(long long)b * s + qi] : 0;
    }
    {  // two threads a row, D / 2 columns each, 8 bf16 a load
      const int qi = q0 + tid / 2;
      float part = 0.f;
      if (qi < s) {
        const long long base = (((long long)b * s + qi) * hq + h) * D + (tid % 2) * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; c += 8) {
          const uint4 x = *reinterpret_cast<const uint4*>(dout + base + c);
          const uint4 y = *reinterpret_cast<const uint4*>(out + base + c);
          const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(xs[e]), o2 = __bfloat1622float2(ys[e]);
            part += a.x * o2.x + a.y * o2.y;
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (tid % 2 == 0) sDelta[st * kRows + tid / 2] = part;
    }
    if (tid == 0) {
      const uint32_t bar = smem_u32(bars + 1 + st);
      mbar_expect_tx(bar, 2 * kTile);
      tma_tile<D>(sK + (2 + st) * kTile, &tm_q, bar, h, q0, b);
      tma_tile<D>(sK + (4 + st) * kTile, &tm_do, bar, h, q0, b);
    }
    __syncwarp();
  };

  if (n_it > 0) {
    if (tid == 0) {
      for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(bars + i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 2 * kTile);
      tma_tile<D>(sK, &tm_k, bar_kv, hk, kv0, b);
      tma_tile<D>(sV, &tm_v, bar_kv, hk, kv0, b);
    }
    for (int n = 0; n < kStages && n < n_it; ++n) prefetch(n);
    int kseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kseg[r] = (seg != nullptr && kv_row[r] < sk) ? seg_k[(long long)b * sk + kv_row[r]] : 0;
    __syncthreads();  // the first stages' lse, delta and segment ids
    mbar_wait(bar_kv, 0);

    float st_acc[32], dp_acc[32];
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    for (int n = 0; n < n_it; ++n) {
      const int st = n % kStages, q0 = (first + n / group) * kRows;
      const uint32_t sQ = sK + (2 + st) * kTile, sDO = sK + (4 + st) * kTile;
      const float* lse_t = sLse + st * kRows;
      const float* delta_t = sDelta + st * kRows;
      const int* seg_t = sSeg + st * kRows;
      mbar_wait(smem_u32(bars + 1 + st), (n / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T
      wg_fence();
      issue_scores<D>(st_acc, sK, sQ);
      issue_scores<D>(dp_acc, sV, sDO);
      wg_commit();
      wg_wait();
      pin(st_acc);
      pin(dp_acc);

      // P^T and dS^T, zeroed outright where masked (the TPU kernel's `where`)
      const bool masked =
          (causal && q0 < kv0 + kRows - 1) || q0 + kRows > s || kv0 + kRows > sk || seg != nullptr;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1, c = acc_col(i) + t2, qi = q0 + c;
        float p = expf(st_acc[i] * scale - lse_t[c]);
        float ds = p * (dp_acc[i] - delta_t[c]) * scale;
        if (masked) {
          const bool ok = qi < s && kv_row[r] < sk && (!causal || qi >= kv_row[r]) &&
                          (seg == nullptr || seg_t[c] == kseg[r]);
          p = ok ? p : 0.f;
          ds = ok ? ds : 0.f;
        }
        st_acc[i] = p;
        dp_acc[i] = ds;
      }

      // dV += P^T dO and dK += dS^T Q, each with its operand as the bf16 pair,
      // each summed over this q tile apart and then added in fp32
      split_hi_lo(st_acc, p_hi, p_lo);
      split_hi_lo(dp_acc, ds_hi, ds_lo);
      add_pair_product<D>(acc_v, p_hi, p_lo, sDO);
      add_pair_product<D>(acc_k, ds_hi, ds_lo, sQ);
      pin(p_hi);
      pin(p_lo);
      pin(ds_hi);
      pin(ds_lo);

      __syncthreads();  // every warp is done with this stage
      if (n + kStages < n_it) prefetch(n + kStages);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kv_row[r] >= sk) continue;
    const long long base = (((long long)b * sk + kv_row[r]) * hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j + t2) =
          __floats2bfloat162_rn(acc_k[i], acc_k[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j + t2) =
          __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
    }
  }
}

// -------------------------------- launchers --------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (d, heads, rows, b) map of a contiguous bf16 (b, rows, heads, d) tensor,
// read in 64 x 64 boxes of one head, 128-byte swizzled; rows past `rows` read
// as zero.
inline bool make_map(CUtensorMap* map, const void* base, int d, int heads, int rows, int b) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)rows * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
constexpr size_t fwd_smem() {
  return 1024 + 5 * (D / 64) * kBoxBytes + 4 * sizeof(uint64_t) + kRows * sizeof(int);
}

template <int D>
constexpr size_t dq_smem() {
  return 1024 + 6 * (D / 64) * kBoxBytes + 4 * sizeof(uint64_t) +
         kRows * (2 * sizeof(float) + sizeof(int));
}

template <int D>
constexpr size_t dkv_smem() {
  return 1024 + 6 * (D / 64) * kBoxBytes + 4 * sizeof(uint64_t) +
         kStages * kRows * (2 * sizeof(float) + sizeof(int));
}

// The backward's maps: q, k, v and dout.
template <typename Args>
bool make_bwd_maps(int d, const Args& a, CUtensorMap (&m)[4]) {
  return make_map(&m[0], a.q, d, a.hq, a.s, a.b) && make_map(&m[1], a.k, d, a.hkv, a.sk, a.b) &&
         make_map(&m[2], a.v, d, a.hkv, a.sk, a.b) && make_map(&m[3], a.dout, d, a.hq, a.s, a.b);
}

template <typename Args>
cudaError_t launch_fwd(int d, const Args& a) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, d, a.hq, a.s, a.b) || !make_map(&tk, a.k, d, a.hkv, a.sk, a.b) ||
      !make_map(&tv, a.v, d, a.hkv, a.sk, a.b))
    return cudaErrorInvalidValue;
  auto kern = d == 64 ? fwd_wgmma_kernel<64> : fwd_wgmma_kernel<128>;
  const size_t smem = d == 64 ? fwd_smem<64>() : fwd_smem<128>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.hq, a.b, (a.s + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(tq, tk, tv, (const int*)a.seg, (const int*)a.seg_k, (bf16*)a.res0,
                                           (float*)a.res1, a.s, a.sk, a.hq, a.hkv, a.causal,
                                           a.scale);
  return cudaGetLastError();
}

template <typename Args>
cudaError_t launch_dq(int d, const Args& a) {
  CUtensorMap m[4];
  if (!make_bwd_maps(d, a, m)) return cudaErrorInvalidValue;
  auto kern = d == 64 ? dq_wgmma_kernel<64> : dq_wgmma_kernel<128>;
  const size_t smem = d == 64 ? dq_smem<64>() : dq_smem<128>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.hq, a.b, (a.s + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], (const int*)a.seg, (const int*)a.seg_k, (const bf16*)a.out, (const float*)a.lse,
      (const bf16*)a.dout, (bf16*)a.res0, a.s, a.sk, a.hq, a.hkv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename Args>
cudaError_t launch_dkv(int d, const Args& a) {
  CUtensorMap m[4];
  if (!make_bwd_maps(d, a, m)) return cudaErrorInvalidValue;
  auto kern = d == 64 ? dkv_wgmma_kernel<64> : dkv_wgmma_kernel<128>;
  const size_t smem = d == 64 ? dkv_smem<64>() : dkv_smem<128>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.hkv, a.b, (a.sk + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], (const int*)a.seg, (const int*)a.seg_k, (const bf16*)a.out, (const float*)a.lse,
      (const bf16*)a.dout, (bf16*)a.res0, (bf16*)a.res1, a.s, a.sk, a.hq, a.hkv, a.causal,
      a.scale);
  return cudaGetLastError();
}

}  // namespace sm90
