// Flash attention with GQA for sm_90a: the forward (with an optional row
// logsumexp), and the backward's dQ and dK/dV kernels, each in a bf16
// version on the tensor cores and an f32 version on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (B8, the
// Pallas TPU kernel _flash_kernel) and
// src/repro/kernels/flash_attention_bwd.py (B9): flash_attention_fwd
// (_fwd_kernel), and flash_attention_bwd's _dq_kernel and _dkv_kernel. The
// forward kernels serve both B8 (lse == nullptr) and B9's forward.
//
// Layout: q, dout, out, dq, dk_h, dv_h are (B, H, S, D) row-major; k, v are
// (B, KH, S, D); lse and dsum are (B, H, S) f32. q-head h reads kv head
// h / (H / KH). Every sum runs in f32; outputs are written in the input
// type (bf16 through round to nearest even, as JAX's astype).
//
// Bound on the H100: operations. A causal forward does 2 B H S^2 D flops
// (half of the 4 B H S^2 D of Q K^T and P V), the backward 2.5 times that;
// at smollm-135m's attention (B 4, H 9, KH 3, S 4096, D 64) that is 77
// GFLOP forward (0.078 ms at the 989 TFLOP/s of bf16 tensor cores) and
// 193 GFLOP backward (0.195 ms) on 50 MB of q, k, v and out in bf16, far
// above the card's ridge point.
//
// bf16, on the tensor cores (flash_mma.cuh has the building blocks: tiles
// kept in bf16 in shared memory under the hardware's XOR swizzle, TMA
// copies completing on mbarriers, and wgmma in inline PTX). Each kernel is
// one block of two consumer warpgroups and one producer warp. The producer
// loads the block's own tiles once and keeps a two-stage ring of the other
// side's tiles in flight with TMA (tensor maps made per call; rows past S
// arrive as zeros); each stage is signalled full by its mbarrier and freed
// by the consumers through another. Each consumer warpgroup owns 64 rows
// of the block, holds its accumulators in f32 registers, and runs every
// product as wgmma: products with both operands in shared memory read them
// K-major, products with a left operand computed in registers (P, dS)
// round it to bf16 as the A operand and read the right one through the
// transposed-B (MN-major) descriptor.
//  * flash_fwd_wgmma_kernel: (128 q rows, q-head, batch) blocks, longest
//    causal rows first; ring of 128-key k/v tiles. S = Q K^T (m64n128),
//    the online softmax (running max, denominator, rescale) in registers,
//    O += P V.
//  * flash_dq_wgmma_kernel: (128 q rows, q-head, batch), longest rows
//    first; q and dO fixed, ring of 64-key k/v tiles. S = Q K^T and
//    dP = dO V^T (m64n64), P = exp(S - lse), dS = P (dP - dsum) in f32,
//    dQ += dS K.
//  * flash_dkv_wgmma_kernel: (128 keys, q-head, batch), the first keys
//    (the most causal rows) first; k and v fixed, ring of 64-row q/dO
//    tiles with their lse and dsum, which the producer warp stages in
//    shared memory. S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//    dK += dS^T Q: per q-head dK and dV, group-summed by the caller as in
//    the reference.
// The causal loop stops at the diagonal tile and only tiles that cross the
// diagonal (or the ragged end of S) are masked. Every row starts at tile
// 0, whose key 0 it sees, so the running max is finite after the first
// tile and a masked score (-inf) contributes exp(-inf) = 0: no -1e30
// sentinel is needed.
//
// f32, on the CUDA cores: the f32 FMAs hold the 2e-5 gate against the
// plain version, which TF32 tensor cores would not. The bound is the f32
// FMA rate (67 TFLOP/s).
//  * flash_fwd_kernel, flash_dq_kernel and flash_dkv_kernel: register
//    tiles fed by 128-bit shared loads. Tiles sit in shared memory
//    row-major with row stride D + 4 (q, k, v, dO, as they are in device
//    memory: no transpose) and score tiles (P, dS, P^T, dS^T) with stride
//    72. In a group of 128 threads, thread (rg, cg) of 16 x 8 owns rows
//    rg + 16 i (i < TM) and score columns cg + 8 j (j < 8), and head-dim
//    columns in groups of 4 (2 at D 16); both products read rows along
//    their inner dimension, 4 floats a load: per 4 steps of it, S = Q K^T
//    issues TM + 8 loads for 32 TM FMAs and O += P V TM + D / 8 for
//    TM D / 2. At TM 8 (D 64) that is 16 FMAs a load: one byte of shared
//    memory a lane's FMA, which at the f32 peak is the 128 bytes a clock
//    an SM's shared memory delivers, so the two pipes share the time (the
//    kernels run near 58 % of the f32 peak; at TM 4, 10.7 FMAs a load, the
//    shared memory alone caps them at 2/3 of it). A row's max is a shuffle
//    among the 8 lanes of an octet; the octet that writes a row of a score
//    tile is the one that reads it (a __syncwarp). Tiles arrive by 16-byte
//    cp.async while other work runs; rows past S are stored as zeros and
//    not written back.
//    Forward: two groups own 128 q rows each (one group of 64 rows at D
//    128), a two-stage ring of 64-key k/v tiles, one block barrier a tile;
//    a group skips the tiles past its last causal row. dK/dV: 128 keys (32
//    at D 128) and a two-stage ring of 64-row q/dO tiles; group 0 computes
//    S^T, P^T and dV += P^T dO, group 1 dP^T, dS^T and dK += dS^T Q, so a
//    thread holds one TM x D / 8 accumulator. dQ keeps q and dO fixed, so
//    the forward's 256 rows a block would not fit: 128 q rows, computed
//    whole (TM 8) by each of two groups that split the 64-key tiles (group
//    0 the even ones, group 1 the odd), each with its own k/v buffers and
//    a named barrier of its own; a group computes S, writes P to its score
//    tile, computes dP, forms dS over P and adds dS K, every product at 16
//    FMAs a load; at the end group 1's partial dQ joins group 0's through
//    shared memory, always in that order. At D 64 a group's buffers hold
//    one stage (while a group waits for a tile the other computes), at D
//    16 and 32 two; at D 128 one group of 64 rows walks a two-stage ring.
//    Each is one block an SM (212,992 bytes of shared memory at D 64 for
//    the forward and dK/dV, 214,016 for dQ).
// More than 48 KB of dynamic shared memory is opted into per kernel with
// cudaFuncSetAttribute.
//
// Measured at (4, 4096, 9/3, 64), causal, on an NVIDIA H100 80GB HBM3 at
// a 700.00 W power limit. chip_smoke.py (phase flash, medians of 20
// CUDA-event samples in turns with SDPA): bf16 forward 0.247 ms (313
// TFLOP/s, 3.2x its bound; SDPA 0.234 ms), dQ 0.607 ms and dK/dV 0.586 ms
// (191 and 264 TFLOP/s; SDPA's whole backward 0.69 ms); SDPA in f32 12.5
// ms forward, 12.6 ms backward. tools/compare_trees.py --flash (medians
// of 20 samples, the kernels before this design and after in turns): f32
// forward 3.74 -> 2.01 ms (57 % of its 1.15 ms bound), dK/dV 7.13 -> 4.02
// ms (57 % of 2.31 ms), and f32 dQ 5.40 -> 3.02 ms (57 % of its 1.73 ms
// bound). tools/flash_variants.py (medians of 16 samples in turns) chose
// the dQ layout: the key split 2.84 ms (as measured before its last
// clean-up), two groups owning 64 rows each at TM 4 with one shared ring
// 3.24 ms, one group of 128 rows 3.47 ms, the earlier kernel 5.36 ms.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <math.h>

#include "async_copy.cuh"
#include "flash_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// f32 forward, dQ and dK/dV: register tiles fed by 128-bit shared loads
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;       // 16 row groups x 8 column groups
constexpr int kF32Cols = 64;           // score columns of a tile
constexpr int kPadS = kF32Cols + 8;    // row stride of a score tile

// A thread's D / 8 head-dim columns: NG groups of VW adjacent ones,
// VW cg + 8 VW g + e for column group cg.
template <int D>
struct HeadCols {
  static constexpr int VW = D >= 32 ? 4 : 2;
  static constexpr int NG = D / 8 / VW;
};

// Forward: a block of GROUPS groups of kF32Threads owns 16 TM q rows a
// group (ROWS in all) and walks 64-key tiles through a two-stage ring.
template <int D>
struct F32Fwd {
  static constexpr int TM = D == 128 ? 4 : 8;
  static constexpr int GROUPS = D == 128 ? 1 : 2;
  static constexpr int ROWS = 16 * TM * GROUPS;
  static constexpr int kThreads = kF32Threads * GROUPS;
  // the q tile, two stages of k and v tiles (row stride D + 4) and P
  static constexpr size_t kBytes =
      sizeof(float) * ((ROWS + 4 * kF32Cols) * (D + 4) + ROWS * kPadS);
};

// dK/dV: a block of two groups of kF32Threads owns KEYS = 16 TM keys and
// walks 64-row q/dO tiles through a two-stage ring.
template <int D>
struct F32Dkv {
  static constexpr int TM = D == 128 ? 2 : 8;
  static constexpr int KEYS = 16 * TM;
  static constexpr int kThreads = 2 * kF32Threads;
  // the k and v tiles, two stages of q and dO tiles, P^T and dS^T
  static constexpr size_t kBytes =
      sizeof(float) * ((2 * KEYS + 4 * kF32Cols) * (D + 4) + 2 * KEYS * kPadS);
};

// dQ: a block of GROUPS groups of kF32Threads owns ROWS = 16 TM q rows and
// keeps them (q, dO, lse, dsum) in shared memory. Every group computes all
// the rows; the groups split the 64-key tiles (group g takes g, g +
// GROUPS, ...), each through a ring of STAGES stages of its own, and
// their partial dQ are summed at the end.
template <int D>
struct F32Dq {
  static constexpr int TM = D == 128 ? 4 : 8;
  static constexpr int GROUPS = D == 128 ? 1 : 2;
  static constexpr int STAGES = D == 64 ? 1 : 2;
  static constexpr int ROWS = 16 * TM;
  static constexpr int kThreads = kF32Threads * GROUPS;
  // q and dO, the rings' k and v tiles (row stride D + 4), each group's
  // score tile, the rows' lse (log2 domain) and dsum
  static constexpr size_t kBytes =
      sizeof(float) * ((2 * ROWS + 2 * GROUPS * STAGES * kF32Cols) * (D + 4) +
                       GROUPS * ROWS * kPadS + 2 * ROWS);
  static_assert(GROUPS <= 2, "the partial sums pair two groups");
};

template <int VW>
__device__ __forceinline__ void load_vec(float (&x)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Rows [row0, row0 + ROWS) of the (s, D) matrix at src into dst (row
// stride D + 4) by 16-byte cp.async from the NT threads of the block, in
// the caller's next commit group; rows at or past s are stored as zeros.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int s, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % NT == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / NT; ++n) {
    const int e = tid + n * NT;
    const int r = e / kChunks, c = e % kChunks;
    float* d = dst + r * (D + 4) + 4 * c;
    if (row0 + r < s) {
      async_copy::cp_async<16>(d, src + static_cast<size_t>(row0 + r) * D +
                                      4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The same, thread threadIdx.x of NT.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int s) {
  copy_rows<D, ROWS, NT>(dst, src, row0, s, threadIdx.x);
}

// acc[i][j] += sum_k a[rg + 16 i][k] b[cg + 8 j][k] over the head dim, a
// and b (row stride D + 4) read 4 columns at a time: per 4 columns, TM + 8
// 128-bit loads feed 32 TM FMAs. The loop over the columns is unrolled U
// times.
template <int D, int TM, int U>
__device__ __forceinline__ void tile_abt(float (&acc)[TM][8], const float* a,
                                         const float* b, int rg, int cg) {
  a += rg * (D + 4);
  b += cg * (D + 4);
#pragma unroll(U)
  for (int k = 0; k < D; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + 16 * i * (D + 4) + k);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b + 8 * j * (D + 4) +
                                                         k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// acc[i][g][e] += sum_r p[rg + 16 i][r] x[r][VW cg + 8 VW g + e] over the
// 64 columns of the score tile p (row stride kPadS) and the rows of x (row
// stride D + 4): per 4 rows, TM + 4 NG loads feed 4 TM D / 8 FMAs.
template <int D, int TM>
__device__ __forceinline__ void tile_px(
    float (&acc)[TM][HeadCols<D>::NG][HeadCols<D>::VW], const float* p,
    const float* x, int rg, int cg) {
  constexpr int NG = HeadCols<D>::NG, VW = HeadCols<D>::VW;
  p += rg * kPadS;
  x += VW * cg;
#pragma unroll 2
  for (int r = 0; r < kF32Cols; r += 4) {
    float4 pv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(p + 16 * i * kPadS + r);
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float xv[VW];
        load_vec<VW>(xv, x + (r + rr) * (D + 4) + 8 * VW * g);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            acc[i][g][e] = fmaf(part(pv[i], rr), xv[e], acc[i][g][e]);
          }
        }
      }
    }
  }
}

// Max over the 8 lanes of a column-group octet (the lanes that share rows).
__device__ __forceinline__ float octet_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float octet_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// B8 and B9's forward: block (batch x q-head, q tile), the longest causal
// rows first. The q tile is loaded once; k/v tile kt + 1 is copied while
// tile kt is computed. A row of P is written and read by the 8 lanes of
// one octet, so one block barrier a tile (for the k/v ring) suffices; a
// group skips the key tiles past its last causal row.
template <int D>
__global__ void __launch_bounds__(F32Fwd<D>::kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int s, int h, int group,
                 int causal, float scale) {
  using G = F32Fwd<D>;
  constexpr int TM = G::TM, NG = HeadCols<D>::NG, VW = HeadCols<D>::VW;
  constexpr int kTileFloats = kF32Cols * (D + 4);
  extern __shared__ __align__(16) float tiles[];
  float* s_q = tiles;
  float* s_k = s_q + G::ROWS * (D + 4);   // stage st at s_k + st * tile
  float* s_v = s_k + 2 * kTileFloats;     // the same
  float* s_p = s_v + 2 * kTileFloats;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, hi = bh % h;
  const int kvh = (bh / h) * (h / group) + hi / group;
  const float* kb = k + static_cast<size_t>(kvh) * s * D;
  const float* vb = v + static_cast<size_t>(kvh) * s * D;
  const int q0 = qt * G::ROWS;
  const int n_tiles = (s + kF32Cols - 1) / kF32Cols;
  const int nk = causal ? min(n_tiles, (q0 + G::ROWS + kF32Cols - 1) / kF32Cols)
                        : n_tiles;
  // this thread: rows r0 + rg + 16 i of the group's, key columns cg + 8 j
  const int t = threadIdx.x % kF32Threads;
  const int rg = t / 8, cg = t % 8;
  const int r0 = threadIdx.x / kF32Threads * 16 * TM;   // warp-uniform
  const int last_row = q0 + r0 + 16 * TM - 1;           // the group's
  const float scale_log2 = scale * kLog2e;

  copy_rows<D, G::ROWS, G::kThreads>(s_q, q + static_cast<size_t>(bh) * s * D,
                                     q0, s);
  copy_rows<D, kF32Cols, G::kThreads>(s_k, kb, 0, s);
  copy_rows<D, kF32Cols, G::kThreads>(s_v, vb, 0, s);
  async_copy::cp_async_commit();
  float o[TM][NG][VW] = {};
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) m[i] = -INFINITY, l[i] = 0.0f;
  float* p_rows = s_p + r0 * kPadS;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kF32Cols, st = kt % 2;
    async_copy::cp_async_wait<0>();
    __syncthreads();   // k/v tile kt in; every thread is done with kt - 1
    if (kt + 1 < nk) {
      const int nx = (st ^ 1) * kTileFloats;
      copy_rows<D, kF32Cols, G::kThreads>(s_k + nx, kb, k0 + kF32Cols, s);
      copy_rows<D, kF32Cols, G::kThreads>(s_v + nx, vb, k0 + kF32Cols, s);
    }
    async_copy::cp_async_commit();
    if (causal && k0 > last_row) continue;   // every key of the tile masked

    float sc[TM][8] = {};
    tile_abt<D, TM, 1>(sc, s_q + r0 * (D + 4), s_k + st * kTileFloats, rg,
                       cg);
    const bool edge =
        (causal && k0 + kF32Cols - 1 > q0 + r0) || k0 + kF32Cols > s;
    // online softmax in the log2 domain; l sums this thread's columns
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + r0 + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = sc[i][j] * scale_log2;
        if (edge && (kpos >= s || (causal && kpos > qpos))) x = -INFINITY;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], octet_max(mx));
      const float alpha = exp2f(m[i] - m_new);   // 0 at the first tile
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        p_rows[(rg + 16 * i) * kPadS + cg + 8 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int e = 0; e < VW; ++e) o[i][g][e] *= alpha;
      }
    }
    __syncwarp();   // the octet's rows of P in
    tile_px<D, TM>(o, p_rows, s_v + st * kTileFloats, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float denom = fmaxf(octet_sum(l[i]), 1e-30f);
    const float inv = 1.0f / denom;
    const int row = q0 + r0 + rg + 16 * i;
    if (row >= s) continue;
    float* dst = out + (static_cast<size_t>(bh) * s + row) * D + VW * cg;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float* at = dst + 8 * VW * g;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(at) =
            make_float4(o[i][g][0] * inv, o[i][g][1] * inv, o[i][g][2] * inv,
                        o[i][g][3] * inv);
      } else {
        *reinterpret_cast<float2*>(at) =
            make_float2(o[i][g][0] * inv, o[i][g][1] * inv);
      }
    }
    if (lse != nullptr && cg == 0) {
      lse[static_cast<size_t>(bh) * s + row] = (m[i] + log2f(denom)) * kLn2;
    }
  }
}

// B9's per-q-head dK and dV: block (batch x q-head, key block), the first
// keys (the most causal rows) first; k and v loaded once, q/dO tile t + 1
// copied while tile t is computed. Group 0 computes S^T = K Q^T, P^T
// (through shared memory) and dV += P^T dO; group 1 dP^T = V dO^T, dS^T
// = P^T (dP^T - dsum) (through shared memory) and dK += dS^T Q, so that
// each thread keeps one accumulator of TM x D / 8 and one score tile of
// TM x 8. A row of P^T or dS^T is written and read by the 8 lanes of one
// octet.
template <int D>
__global__ void __launch_bounds__(F32Dkv<D>::kThreads, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dk,
                 float* __restrict__ dv, int s, int h, int group, int causal,
                 float scale) {
  using G = F32Dkv<D>;
  constexpr int TM = G::TM, NG = HeadCols<D>::NG, VW = HeadCols<D>::VW;
  constexpr int kTileFloats = kF32Cols * (D + 4);
  extern __shared__ __align__(16) float tiles[];
  float* s_k = tiles;
  float* s_v = s_k + G::KEYS * (D + 4);
  float* s_q = s_v + G::KEYS * (D + 4);   // stage st at s_q + st * tile
  float* s_do = s_q + 2 * kTileFloats;    // the same
  float* s_pt = s_do + 2 * kTileFloats;   // P^T: [key][query]
  float* s_dst = s_pt + G::KEYS * kPadS;  // dS^T
  const int kt = blockIdx.y;
  const int bh = blockIdx.x, hi = bh % h;
  const int kvh = (bh / h) * (h / group) + hi / group;
  const size_t row_base = static_cast<size_t>(bh) * s;
  const float* qb = q + row_base * D;
  const float* dob = dout + row_base * D;
  const int k0 = kt * G::KEYS;
  const int nq = (s + kF32Cols - 1) / kF32Cols;
  const int q_first = causal ? k0 / kF32Cols : 0;
  // this thread: keys rg + 16 i, q columns cg + 8 j of each tile
  const int role = threadIdx.x / kF32Threads;   // group, warp-uniform
  const int rg = threadIdx.x % kF32Threads / 8, cg = threadIdx.x % 8;
  const float scale_log2 = scale * kLog2e;

  copy_rows<D, G::KEYS, G::kThreads>(
      s_k, k + static_cast<size_t>(kvh) * s * D, k0, s);
  copy_rows<D, G::KEYS, G::kThreads>(
      s_v, v + static_cast<size_t>(kvh) * s * D, k0, s);
  copy_rows<D, kF32Cols, G::kThreads>(s_q, qb, q_first * kF32Cols, s);
  copy_rows<D, kF32Cols, G::kThreads>(s_do, dob, q_first * kF32Cols, s);
  async_copy::cp_async_commit();
  float acc[TM][NG][VW] = {};   // dV (group 0) or dK / scale (group 1)
  for (int qt = q_first; qt < nq; ++qt) {
    const int q0 = qt * kF32Cols;
    const int st = (qt - q_first) % 2;
    const float* tq = s_q + st * kTileFloats;
    const float* tdo = s_do + st * kTileFloats;
    async_copy::cp_async_wait<0>();
    __syncthreads();   // tile qt in; every thread is done with tile qt - 1
    if (qt + 1 < nq) {
      const int nx = (st ^ 1) * kTileFloats;
      copy_rows<D, kF32Cols, G::kThreads>(s_q + nx, qb, q0 + kF32Cols, s);
      copy_rows<D, kF32Cols, G::kThreads>(s_do + nx, dob, q0 + kF32Cols, s);
    }
    async_copy::cp_async_commit();
    float rows[8];   // lse (log2 domain) or dsum of the 8 q columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qpos = q0 + cg + 8 * j;
      rows[j] = qpos >= s ? 0.0f
                          : role == 0 ? lse[row_base + qpos] * kLog2e
                                      : dsum[row_base + qpos];
    }
    float sc[TM][8] = {};
    if (role == 0) {
      tile_abt<D, TM, 2>(sc, s_k, tq, rg, cg);   // S^T = K Q^T
      const bool edge = (causal && q0 < k0 + G::KEYS - 1) ||
                        q0 + kF32Cols > s || k0 + G::KEYS > s;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int kpos = k0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qpos = q0 + cg + 8 * j;
          float p = exp2f(sc[i][j] * scale_log2 - rows[j]);
          if (edge && (qpos >= s || kpos >= s || (causal && kpos > qpos))) {
            p = 0.0f;
          }
          s_pt[(rg + 16 * i) * kPadS + cg + 8 * j] = p;
        }
      }
    } else {
      tile_abt<D, TM, 2>(sc, s_v, tdo, rg, cg);  // dP^T = V dO^T
    }
    __syncthreads();   // P^T in
    if (role == 0) {
      tile_px<D, TM>(acc, s_pt, tdo, rg, cg);    // dV += P^T dO
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int at = (rg + 16 * i) * kPadS + cg + 8 * j;
          s_dst[at] = s_pt[at] * (sc[i][j] - rows[j]);
        }
      }
      __syncwarp();   // the octet's rows of dS^T in
      tile_px<D, TM>(acc, s_dst, tq, rg, cg);    // dK += dS^T Q
    }
  }
  float* dst = role == 0 ? dv : dk;
  const float mul = role == 0 ? 1.0f : scale;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = k0 + rg + 16 * i;
    if (row >= s) continue;
    float* at = dst + (row_base + row) * D + VW * cg;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < VW; ++e) at[8 * VW * g + e] = acc[i][g][e] * mul;
    }
  }
}

// The kF32Threads threads of group g meet (named barrier g + 1).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kF32Threads) : "memory");
}

// B9's dQ: block (batch x q-head, q tile), the longest causal rows first.
// q and dO are loaded once; each group's k/v tiles come by cp.async (with
// two stages, tile n + 1 is copied while tile n is computed; with one, the
// other group computes while a group waits). Per tile a group computes S =
// Q K^T, writes P = exp2(S scale log2e - lse log2e) to its score tile,
// computes dP = dO V^T, turns P into dS = P (dP - dsum) in place and adds
// dS K to its dQ. A row of the score tile is written and read by the 8
// lanes of one octet; dP and S are never live at once.
template <int D>
__global__ void __launch_bounds__(F32Dq<D>::kThreads, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dq, int s, int h, int group, int causal,
                float scale) {
  using G = F32Dq<D>;
  constexpr int TM = G::TM, NG = HeadCols<D>::NG, VW = HeadCols<D>::VW;
  constexpr int kTileFloats = kF32Cols * (D + 4);
  constexpr int kRingFloats = 2 * G::STAGES * kTileFloats;
  extern __shared__ __align__(16) float tiles[];
  float* s_q = tiles;
  float* s_do = s_q + G::ROWS * (D + 4);
  float* s_rings = s_do + G::ROWS * (D + 4);   // stage st: k, then v
  float* s_p = s_rings + G::GROUPS * kRingFloats;
  float* s_lse = s_p + G::GROUPS * G::ROWS * kPadS;
  float* s_dsum = s_lse + G::ROWS;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, hi = bh % h;
  const int kvh = (bh / h) * (h / group) + hi / group;
  const float* kb = k + static_cast<size_t>(kvh) * s * D;
  const float* vb = v + static_cast<size_t>(kvh) * s * D;
  const size_t row_base = static_cast<size_t>(bh) * s;
  const int q0 = qt * G::ROWS;
  const int n_tiles = (s + kF32Cols - 1) / kF32Cols;
  const int nk = causal ? min(n_tiles, (q0 + G::ROWS + kF32Cols - 1) / kF32Cols)
                        : n_tiles;
  // this thread: rows rg + 16 i of the block's, key columns cg + 8 j
  const int g = threadIdx.x / kF32Threads;   // group, warp-uniform
  const int t = threadIdx.x % kF32Threads;
  const int rg = t / 8, cg = t % 8;
  float* ring = s_rings + g * kRingFloats;
  float* p_rows = s_p + g * G::ROWS * kPadS;   // the group's score tile
  const float scale_log2 = scale * kLog2e;

  copy_rows<D, G::ROWS, G::kThreads>(s_q, q + row_base * D, q0, s);
  copy_rows<D, G::ROWS, G::kThreads>(s_do, dout + row_base * D, q0, s);
  if (g < nk) {
    copy_rows<D, kF32Cols, kF32Threads>(ring, kb, g * kF32Cols, s, t);
    copy_rows<D, kF32Cols, kF32Threads>(ring + kTileFloats, vb,
                                        g * kF32Cols, s, t);
  }
  async_copy::cp_async_commit();
  for (int r = threadIdx.x; r < G::ROWS; r += G::kThreads) {
    const int row = q0 + r;
    s_lse[r] = row < s ? lse[row_base + row] * kLog2e : 0.0f;
    s_dsum[r] = row < s ? dsum[row_base + row] : 0.0f;
  }
  async_copy::cp_async_wait<0>();
  __syncthreads();   // q, dO, the rows and each group's first tile in

  float acc[TM][NG][VW] = {};   // dQ / scale of the thread's rows
  for (int n = 0;; ++n) {
    const int kt = g + n * G::GROUPS;
    if (kt >= nk) break;   // group-uniform
    const int k0 = kt * kF32Cols;
    const int next = k0 + G::GROUPS * kF32Cols;   // the group's next tile
    const float* tk = ring + (n % G::STAGES) * 2 * kTileFloats;
    const float* tv = tk + kTileFloats;
    if (n > 0) {
      async_copy::cp_async_wait<0>();
      group_sync(g);   // tile kt in; the group is done with the last
    }
    if constexpr (G::STAGES == 2) {
      if (next < nk * kF32Cols) {
        float* nx = ring + ((n + 1) % 2) * 2 * kTileFloats;
        copy_rows<D, kF32Cols, kF32Threads>(nx, kb, next, s, t);
        copy_rows<D, kF32Cols, kF32Threads>(nx + kTileFloats, vb, next, s,
                                            t);
      }
      async_copy::cp_async_commit();
    }
    float sc[TM][8] = {};
    tile_abt<D, TM, 1>(sc, s_q, tk, rg, cg);   // Q K^T
    const bool edge = (causal && k0 + kF32Cols - 1 > q0) || k0 + kF32Cols > s;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = rg + 16 * i;
      const float l2 = s_lse[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float p = exp2f(sc[i][j] * scale_log2 - l2);
        if (edge && (kpos >= s || (causal && kpos > q0 + row))) p = 0.0f;
        p_rows[row * kPadS + cg + 8 * j] = p;
      }
    }
    float dp[TM][8] = {};
    tile_abt<D, TM, 1>(dp, s_do, tv, rg, cg);   // dO V^T
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = rg + 16 * i;
      const float ds = s_dsum[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* at = p_rows + row * kPadS + cg + 8 * j;
        *at = *at * (dp[i][j] - ds);   // dS over P
      }
    }
    __syncwarp();   // the octet's rows of dS in
    tile_px<D, TM>(acc, p_rows, tk, rg, cg);   // dQ += dS K
    if constexpr (G::STAGES == 1) {
      group_sync(g);   // the group is done with the stage
      if (next < nk * kF32Cols) {
        copy_rows<D, kF32Cols, kF32Threads>(ring, kb, next, s, t);
        copy_rows<D, kF32Cols, kF32Threads>(ring + kTileFloats, vb, next, s,
                                            t);
      }
      async_copy::cp_async_commit();
    }
  }

  if constexpr (G::GROUPS == 2) {
    // group 1's partial sums join group 0's through the score tiles, free
    // once both groups are done: dQ = (even tiles) + (odd tiles), an order
    // that does not change from run to run
    float* partial = s_p + (rg * D + VW * cg);
    __syncthreads();
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            partial[16 * i * D + 8 * VW * gg + e] = acc[i][gg][e];
          }
        }
      }
    }
    __syncthreads();
    if (g == 1) return;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc[i][gg][e] += partial[16 * i * D + 8 * VW * gg + e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= s) continue;
    float* dst = dq + (row_base + row) * D + VW * cg;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      float* at = dst + 8 * VW * gg;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(at) =
            make_float4(acc[i][gg][0] * scale, acc[i][gg][1] * scale,
                        acc[i][gg][2] * scale, acc[i][gg][3] * scale);
      } else {
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[i][gg][0] * scale, acc[i][gg][1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kThreadsTC = 384;     // two consumer warpgroups, a producer
constexpr int kConsumerRegs = 232;  // registers of a consumer thread
constexpr int kProducerRegs = 40;   // and of a producer thread
constexpr int kStages = 2;          // ring stages in flight
constexpr int kFwdRows = 128;       // forward: q rows of a block
constexpr int kFwdKeys = 128;       //   keys of a k/v tile
constexpr int kDqRows = 128;        // dQ: q rows of a block
constexpr int kDqKeys = 64;         //   keys of a k/v tile
constexpr int kDkvKeys = 128;       // dK/dV: keys of a block
constexpr int kDkvRows = 64;        //   q rows of a q/dO tile

// bf16 bytes of a tile of `rows` rows
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// n of a wgmma product over the head dim (D 128 takes two of 64)
template <int D>
__host__ __device__ constexpr int head_n() {
  return D < 64 ? D : 64;
}

// Shared memory of a bf16 kernel, from a 1024-byte boundary (the
// swizzle's period): NFIXED tiles of FIXED_ROWS rows loaded once, a ring
// of kStages stages of two tiles of RING_ROWS rows, with ROWS the lse and
// dsum of each stage's rows, and the mbarriers: one for the fixed tiles,
// a full and an empty one per stage.
template <int D, int NFIXED, int FIXED_ROWS, int RING_ROWS, bool ROWS>
struct Layout {
  static constexpr uint32_t kFixed = tile_bytes<D>(FIXED_ROWS);
  static constexpr uint32_t kRing = tile_bytes<D>(RING_ROWS);
  static constexpr uint32_t kRingAt = NFIXED * kFixed;
  static constexpr uint32_t kRowsAt = kRingAt + 2 * kStages * kRing;
  static constexpr uint32_t kBarsAt =
      kRowsAt + (ROWS ? kStages * 2 * RING_ROWS * 4 : 0);
  // bytes to ask for: the layout, its alignment slack and the barriers
  static constexpr size_t kBytes = 1024 + kBarsAt + 8 * (1 + 2 * kStages);
  uint32_t base;
  __device__ uint32_t fixed(int i) const { return base + i * kFixed; }
  __device__ uint32_t ring(int st, int i) const {
    return base + kRingAt + (2 * st + i) * kRing;
  }
  __device__ uint32_t rows(int st) const {
    return base + kRowsAt + st * 2 * RING_ROWS * 4;
  }
  __device__ uint32_t fixed_full() const { return base + kBarsAt; }
  __device__ uint32_t full(int st) const {
    return base + kBarsAt + 8 * (1 + st);
  }
  __device__ uint32_t empty(int st) const {
    return base + kBarsAt + 8 * (1 + kStages + st);
  }
};

template <int D>
using FwdLayout = Layout<D, 1, kFwdRows, kFwdKeys, false>;
template <int D>
using DqLayout = Layout<D, 2, kDqRows, kDqKeys, false>;
template <int D>
using DkvLayout = Layout<D, 2, kDkvKeys, kDkvRows, true>;

// The layout at the first 1024-byte boundary of the dynamic shared memory;
// thread 0 initialises its barriers (the empty ones wait for lane 0 of
// each of the 8 consumer warps).
template <class L>
__device__ __forceinline__ L start_layout(const void* smem_raw) {
  using namespace flash_mma;
  const L sm{(smem_addr(smem_raw) + 1023u) & ~1023u};
  if (threadIdx.x == 0) {
    mbar_init(sm.fixed_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// Hand the producer warpgroup's registers to the consumers (every warp of
// a warpgroup runs the same one; the two paths never meet again).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// The `rows`-row tile of rows [row0, row0 + rows) of (batch x head) bh,
// by TMA into dst, completing `bar` (two boxes of 64 columns at D 128).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int bh,
                                         int rows) {
#pragma unroll
  for (int half = 0; half < (D == 128 ? 2 : 1); ++half) {
    flash_mma::tma_load_3d(dst + half * rows * 128, map, bar, half * 64, row0,
                           bh);
  }
}

// Tiles of ROWS rows from maps a and b (same rows, same bh) into dst and
// the tile after it, both completing `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_pair(uint32_t dst, const CUtensorMap* a,
                                         const CUtensorMap* b, uint32_t bar,
                                         int row0, int bh) {
  flash_mma::mbar_expect_tx(bar, 2 * tile_bytes<D>(ROWS));
  tma_tile<D>(dst, a, bar, row0, bh, ROWS);
  tma_tile<D>(dst + tile_bytes<D>(ROWS), b, bar, row0, bh, ROWS);
}

// Byte offset of k-step kk (16 columns of the head dim) within a tile of
// `rows` rows: a K-major wgmma descriptor starts there.
template <int D>
__device__ __forceinline__ uint32_t kstep_offset(int kk, int rows) {
  if constexpr (D == 128) return (kk / 4) * rows * 128 + (kk % 4) * 32;
  return kk * 32;
}

// Issue acc (m64nN) += A B^T over the head dim: A the 64 rows at `a` of a
// tile of a_rows rows, B the N-row tile at b, both K-major.
template <int D, int N>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], uint32_t a,
                                          int a_rows, uint32_t b) {
  using namespace flash_mma;
  constexpr uint32_t kSbo = 8 * swizzle_bytes<D>();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        wgmma_desc<D>(a + kstep_offset<D>(kk, a_rows), 16, kSbo);
    const uint64_t db = wgmma_desc<D>(b + kstep_offset<D>(kk, N), 16, kSbo);
    if constexpr (N == 64) {
      wgmma_ss_m64n64k16(acc, da, db);
    } else {
      wgmma_ss_m64n128k16(acc, da, db);
    }
  }
}

// Issue acc[hf] (m64n head_n) += A B: A the bf16 fragments of KS blocks of
// 16 along K from registers, B the MN-major tile of `rows` rows at b (K
// along its rows from row 0; head-dim half hf at column 64 hf).
template <int D, int KS>
__device__ __forceinline__ void issue_ab(
    float (&acc)[D / head_n<D>()][head_n<D>() / 2],
    const uint32_t (&a)[KS][4], uint32_t b, int rows) {
  using namespace flash_mma;
  constexpr int W = swizzle_bytes<D>();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int hf = 0; hf < D / head_n<D>(); ++hf) {
      const uint64_t db =
          wgmma_desc<D>(b + hf * rows * 128 + kk * 16 * W, 8 * W, 8 * W);
      if constexpr (head_n<D>() == 16) {
        wgmma_rs_m64n16k16(acc[hf], a[kk], db);
      } else if constexpr (head_n<D>() == 32) {
        wgmma_rs_m64n32k16(acc[hf], a[kk], db);
      } else {
        wgmma_rs_m64n64k16(acc[hf], a[kk], db);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void fence_acc(
    float (&acc)[D / head_n<D>()][head_n<D>() / 2]) {
#pragma unroll
  for (int hf = 0; hf < D / head_n<D>(); ++hf) flash_mma::fence_regs(acc[hf]);
}

// Rows row0 and row0 + 8 of acc (this thread's columns 8 j + 2 t, + 1 of
// each head-dim half) times `mul` (row r: mul[r]) as bf16 into the (s, D)
// matrix at dst; rows at or past s are not written.
template <int D>
__device__ __forceinline__ void store_rows(
    bf16* dst, const float (&acc)[D / head_n<D>()][head_n<D>() / 2],
    int row0, int t, int s, const float (&mul)[2]) {
  constexpr int DN = head_n<D>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s) continue;
    bf16* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int hf = 0; hf < D / DN; ++hf) {
#pragma unroll
      for (int j = 0; j < DN / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + hf * 64 + 8 * j + 2 * t) =
            flash_mma::pack_bf16(acc[hf][4 * j + 2 * r] * mul[r],
                                 acc[hf][4 * j + 2 * r + 1] * mul[r]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int s, int h, int group, int causal, float scale) {
  using namespace flash_mma;
  constexpr int W = swizzle_bytes<D>();
  constexpr int DN = head_n<D>();
  extern __shared__ uint8_t smem_raw[];
  const auto sm = start_layout<FwdLayout<D>>(smem_raw);
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int bh = blockIdx.x, hi = bh % h;
  const int kvh = (bh / h) * (h / group) + hi / group;
  const int q0 = qt * kFwdRows;
  const int nk = causal ? qt + 1 : (s + kFwdKeys - 1) / kFwdKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {   // the producer warpgroup: one thread issues
    producer_regs();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(sm.fixed_full(), tile_bytes<D>(kFwdRows));
      tma_tile<D>(sm.fixed(0), &tm_q, sm.fixed_full(), q0, bh, kFwdRows);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        mbar_wait(sm.empty(st), ((kt / kStages) & 1) ^ 1);
        tma_pair<D, kFwdKeys>(sm.ring(st, 0), &tm_k, &tm_v, sm.full(st),
                              kt * kFwdKeys, kvh);
      }
    }
    return;
  }

  consumer_regs();
  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block;
  // this thread rows wr and wr + 8 of them, key columns 8 j + 2 t, + 1
  const int wg = warp / 4;
  const int wr = (warp % 4) * 16 + lane / 4, t = lane % 4;
  const int row0 = q0 + wg * 64 + wr;
  const float scale_log2 = scale * kLog2e;
  float o[D / DN][DN / 2] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  mbar_wait(sm.fixed_full(), 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    mbar_wait(sm.full(st), (kt / kStages) & 1);

    float sc[kFwdKeys / 2] = {};
    fence_regs(sc);
    wgmma_fence();
    issue_abt<D, kFwdKeys>(sc, sm.fixed(0) + wg * 64 * W, kFwdRows,
                           sm.ring(st, 0));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = kt * kFwdKeys;
    if ((causal && kt == nk - 1) || k0 + kFwdKeys > s) {
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = row0 + 8 * (e >> 1);
          if (kpos >= s || (causal && kpos > qpos)) sc[4 * j + e] = -INFINITY;
        }
      }
    }
    // online softmax in the log2 domain: rows wr (e = 0, 1), wr + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float alpha = exp2f(m[r] - m_new);   // 0 at the first tile
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * r + e] * scale_log2 - m_new);
          sc[4 * j + 2 * r + e] = p;
          sum += p;
        }
      }
      l[r] = alpha * l[r] + sum;   // this thread's columns; summed at the end
      m[r] = m_new;
#pragma unroll
      for (int hf = 0; hf < D / DN; ++hf) {
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          o[hf][4 * j + 2 * r] *= alpha;
          o[hf][4 * j + 2 * r + 1] *= alpha;
        }
      }
    }
    uint32_t pa[kFwdKeys / 16][4];
    wgmma_acc_to_a(pa, sc);
    fence_acc<D>(o);
    fence_regs(pa);
    wgmma_fence();
    issue_ab<D, kFwdKeys / 16>(o, pa, sm.ring(st, 1), kFwdKeys);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<D>(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(sm.empty(st));
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    inv[r] = 1.0f / denom;
    const int row = row0 + 8 * r;
    if (lse != nullptr && t == 0 && row < s) {
      lse[static_cast<size_t>(bh) * s + row] = (m[r] + log2f(denom)) * kLn2;
    }
  }
  store_rows<D>(out + static_cast<size_t>(bh) * s * D, o, row0, t, s, inv);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, bf16* __restrict__ dq,
                      int s, int h, int group, int causal, float scale) {
  using namespace flash_mma;
  constexpr int W = swizzle_bytes<D>();
  constexpr int DN = head_n<D>();
  extern __shared__ uint8_t smem_raw[];
  const auto sm = start_layout<DqLayout<D>>(smem_raw);
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int bh = blockIdx.x, hi = bh % h;
  const int kvh = (bh / h) * (h / group) + hi / group;
  const int q0 = qt * kDqRows;
  const int n_tiles = (s + kDqKeys - 1) / kDqKeys;
  const int nk =
      causal ? min(n_tiles, (q0 + kDqRows + kDqKeys - 1) / kDqKeys) : n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {   // the producer: q and dO once, then k/v tiles
    producer_regs();
    if (warp == 8 && lane == 0) {
      tma_pair<D, kDqRows>(sm.fixed(0), &tm_q, &tm_do, sm.fixed_full(), q0,
                           bh);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        mbar_wait(sm.empty(st), ((kt / kStages) & 1) ^ 1);
        tma_pair<D, kDqKeys>(sm.ring(st, 0), &tm_k, &tm_v, sm.full(st),
                             kt * kDqKeys, kvh);
      }
    }
    return;
  }

  consumer_regs();
  // the consumers: rows as in the forward, key columns 8 j + 2 t, + 1
  const int wg = warp / 4;
  const int wr = (warp % 4) * 16 + lane / 4, t = lane % 4;
  const int row0 = q0 + wg * 64 + wr;
  const float scale_log2 = scale * kLog2e;
  float row_lse[2], row_dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t at = static_cast<size_t>(bh) * s + row;
    row_lse[r] = row < s ? lse[at] * kLog2e : 0.0f;
    row_dsum[r] = row < s ? dsum[at] : 0.0f;
  }
  float acc[D / DN][DN / 2] = {};
  mbar_wait(sm.fixed_full(), 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    mbar_wait(sm.full(st), (kt / kStages) & 1);
    float sc[kDqKeys / 2] = {}, dp[kDqKeys / 2] = {};
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_abt<D, kDqKeys>(sc, sm.fixed(0) + wg * 64 * W, kDqRows,
                          sm.ring(st, 0));   // Q K^T
    issue_abt<D, kDqKeys>(dp, sm.fixed(1) + wg * 64 * W, kDqRows,
                          sm.ring(st, 1));   // dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = kt * kDqKeys;
    const bool edge = (causal && k0 + kDqKeys > q0 + 1) || k0 + kDqKeys > s;
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        float p = exp2f(sc[4 * j + e] * scale_log2 - row_lse[e >> 1]);
        if (edge && (kpos >= s || (causal && kpos > row))) p = 0.0f;
        sc[4 * j + e] = p * (dp[4 * j + e] - row_dsum[e >> 1]);   // dS
      }
    }
    uint32_t dsa[kDqKeys / 16][4];
    wgmma_acc_to_a(dsa, sc);
    fence_acc<D>(acc);
    fence_regs(dsa);
    wgmma_fence();
    issue_ab<D, kDqKeys / 16>(acc, dsa, sm.ring(st, 0), kDqKeys);   // dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<D>(acc);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(sm.empty(st));
  }
  const float mul[2] = {scale, scale};
  store_rows<D>(dq + static_cast<size_t>(bh) * s * D, acc, row0, t, s, mul);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int s, int h, int group,
                       int causal, float scale) {
  using namespace flash_mma;
  constexpr int W = swizzle_bytes<D>();
  constexpr int DN = head_n<D>();
  extern __shared__ uint8_t smem_raw[];
  const auto sm = start_layout<DkvLayout<D>>(smem_raw);
  // the staged lse and dsum of stage st, read and written with plain
  // loads and stores
  auto rows_of = [&](int st) {
    return reinterpret_cast<float*>(smem_raw +
                                    (sm.rows(st) - smem_addr(smem_raw)));
  };
  const int kt = blockIdx.y;   // causal: the first keys see the most rows
  const int bh = blockIdx.x, hi = bh % h;
  const int kvh = (bh / h) * (h / group) + hi / group;
  const int k0 = kt * kDkvKeys;
  const int nq = (s + kDkvRows - 1) / kDkvRows;
  const int q_first = causal ? k0 / kDkvRows : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {   // the producer: k and v once, then q/dO tiles
    producer_regs();
    if (warp > 8) return;
    if (lane == 0) {
      tma_pair<D, kDkvKeys>(sm.fixed(0), &tm_k, &tm_v, sm.fixed_full(), k0,
                            kvh);
    }
    for (int qt = q_first; qt < nq; ++qt) {
      const int i = qt - q_first, st = i % kStages;
      mbar_wait(sm.empty(st), ((i / kStages) & 1) ^ 1);
      float* rows = rows_of(st);
      for (int r = lane; r < kDkvRows; r += 32) {
        const int row = qt * kDkvRows + r;
        const size_t at = static_cast<size_t>(bh) * s + row;
        rows[r] = row < s ? lse[at] * kLog2e : 0.0f;
        rows[kDkvRows + r] = row < s ? dsum[at] : 0.0f;
      }
      __syncwarp();
      if (lane == 0) {   // its arrive releases the lanes' stores too
        tma_pair<D, kDkvRows>(sm.ring(st, 0), &tm_q, &tm_do, sm.full(st),
                              qt * kDkvRows, bh);
      }
    }
    return;
  }

  consumer_regs();
  // the consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of the block;
  // this thread keys wr and wr + 8 of them, q columns 8 j + 2 t, + 1
  const int wg = warp / 4;
  const int wr = (warp % 4) * 16 + lane / 4, t = lane % 4;
  const int key0 = k0 + wg * 64 + wr;
  const float scale_log2 = scale * kLog2e;
  float acc_k[D / DN][DN / 2] = {}, acc_v[D / DN][DN / 2] = {};
  mbar_wait(sm.fixed_full(), 0);
  for (int qt = q_first; qt < nq; ++qt) {
    const int i = qt - q_first, st = i % kStages;
    mbar_wait(sm.full(st), (i / kStages) & 1);
    float pt[kDkvRows / 2] = {}, dpt[kDkvRows / 2] = {};
    fence_regs(pt);
    fence_regs(dpt);
    wgmma_fence();
    issue_abt<D, kDkvRows>(pt, sm.fixed(0) + wg * 64 * W, kDkvKeys,
                           sm.ring(st, 0));   // K Q^T
    issue_abt<D, kDkvRows>(dpt, sm.fixed(1) + wg * 64 * W, kDkvKeys,
                           sm.ring(st, 1));   // V dO^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pt);
    fence_regs(dpt);

    const float* s_lse = rows_of(st);
    const float* s_dsum = s_lse + kDkvRows;
    const int q0 = qt * kDkvRows;
    const bool edge =
        (causal && q0 < k0 + kDkvKeys - 1) || q0 + kDkvRows > s;
#pragma unroll
    for (int j = 0; j < kDkvRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int kpos = key0 + 8 * (e >> 1);
        float p = exp2f(pt[4 * j + e] * scale_log2 - s_lse[col]);
        if (edge && (q0 + col >= s || (causal && kpos > q0 + col))) p = 0.0f;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - s_dsum[col]);   // dS^T
        pt[4 * j + e] = p;                                     // P^T
      }
    }
    uint32_t pa[kDkvRows / 16][4], dsa[kDkvRows / 16][4];
    wgmma_acc_to_a(pa, pt);
    wgmma_acc_to_a(dsa, dpt);
    fence_acc<D>(acc_k);
    fence_acc<D>(acc_v);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    issue_ab<D, kDkvRows / 16>(acc_v, pa, sm.ring(st, 1), kDkvRows);  // P^T dO
    issue_ab<D, kDkvRows / 16>(acc_k, dsa, sm.ring(st, 0), kDkvRows); // dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<D>(acc_k);
    fence_acc<D>(acc_v);
    fence_regs(pa);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(sm.empty(st));
  }
  const size_t base = static_cast<size_t>(bh) * s * D;
  const float k_mul[2] = {scale, scale}, v_mul[2] = {1.0f, 1.0f};
  store_rows<D>(dk + base, acc_k, key0, t, s, k_mul);
  store_rows<D>(dv + base, acc_v, key0, t, s, v_mul);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
// Opt the kernel into `bytes` of dynamic shared memory, launch `threads`
// threads a block on the (batch x q-head, tile of `rows` rows) grid, so
// that every head's first tile is scheduled before any head's second, and
// return cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, size_t bytes, int threads, int rows, int s,
                int h, int b, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b * h, (s + rows - 1) / rows);
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver library the process has loaded
// (the runtime links no driver symbols).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map of the bf16 (n_bh, s, D) array at ptr whose box is `rows`
// rows of min(D, 64) columns, swizzled as flash_mma.cuh lays tiles out;
// rows past s read as zeros. False if the driver refuses it.
template <int D>
bool tile_map(CUtensorMap* map, const void* ptr, int s, int n_bh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {D < 64 ? D : 64, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  constexpr int kW = flash_mma::swizzle_bytes<D>();
  const CUtensorMapSwizzle swizzle =
      kW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (kW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  int b, h, kh, s, causal;
  float scale;
};

template <int D>
int fwd(const Problem& p, bool bf16_in, void* out, float* lse,
        cudaStream_t stream) {
  if (!bf16_in) {
    return launch_rows(flash_fwd_kernel<D>, F32Fwd<D>::kBytes,
                       F32Fwd<D>::kThreads, F32Fwd<D>::ROWS, p.s, p.h, p.b,
                       stream, static_cast<const float*>(p.q),
                       static_cast<const float*>(p.k),
                       static_cast<const float*>(p.v),
                       static_cast<float*>(out), lse, p.s, p.h, p.h / p.kh,
                       p.causal, p.scale);
  }
  CUtensorMap mq, mk, mv;
  if (!tile_map<D>(&mq, p.q, p.s, p.b * p.h, kFwdRows) ||
      !tile_map<D>(&mk, p.k, p.s, p.b * p.kh, kFwdKeys) ||
      !tile_map<D>(&mv, p.v, p.s, p.b * p.kh, kFwdKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(flash_fwd_wgmma_kernel<D>, FwdLayout<D>::kBytes,
                     kThreadsTC, kFwdRows, p.s, p.h, p.b, stream, mq, mk, mv,
                     static_cast<bf16*>(out), lse, p.s, p.h, p.h / p.kh,
                     p.causal, p.scale);
}

// Tensor maps of q and dO with `q_rows`-row boxes and of k and v with
// `kv_rows`-row boxes, for a backward kernel; false if one is refused.
template <int D>
bool bwd_maps(const Problem& p, const void* dout, int q_rows, int kv_rows,
              CUtensorMap (&maps)[4]) {
  return tile_map<D>(&maps[0], p.q, p.s, p.b * p.h, q_rows) &&
         tile_map<D>(&maps[1], p.k, p.s, p.b * p.kh, kv_rows) &&
         tile_map<D>(&maps[2], p.v, p.s, p.b * p.kh, kv_rows) &&
         tile_map<D>(&maps[3], dout, p.s, p.b * p.h, q_rows);
}

template <int D>
int dq(const Problem& p, bool bf16_in, const void* dout, const float* lse,
       const float* dsum, void* dq_out, cudaStream_t stream) {
  if (!bf16_in) {
    return launch_rows(flash_dq_kernel<D>, F32Dq<D>::kBytes,
                       F32Dq<D>::kThreads, F32Dq<D>::ROWS, p.s, p.h, p.b,
                       stream, static_cast<const float*>(p.q),
                       static_cast<const float*>(p.k),
                       static_cast<const float*>(p.v),
                       static_cast<const float*>(dout), lse, dsum,
                       static_cast<float*>(dq_out), p.s, p.h, p.h / p.kh,
                       p.causal, p.scale);
  }
  CUtensorMap maps[4];
  if (!bwd_maps<D>(p, dout, kDqRows, kDqKeys, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(flash_dq_wgmma_kernel<D>, DqLayout<D>::kBytes,
                     kThreadsTC, kDqRows, p.s, p.h, p.b, stream, maps[0],
                     maps[1], maps[2], maps[3], lse, dsum,
                     static_cast<bf16*>(dq_out), p.s, p.h, p.h / p.kh,
                     p.causal, p.scale);
}

template <int D>
int dkv(const Problem& p, bool bf16_in, const void* dout, const float* lse,
        const float* dsum, void* dk, void* dv, cudaStream_t stream) {
  if (!bf16_in) {
    return launch_rows(flash_dkv_kernel<D>, F32Dkv<D>::kBytes,
                       F32Dkv<D>::kThreads, F32Dkv<D>::KEYS, p.s, p.h, p.b,
                       stream, static_cast<const float*>(p.q),
                       static_cast<const float*>(p.k),
                       static_cast<const float*>(p.v),
                       static_cast<const float*>(dout), lse, dsum,
                       static_cast<float*>(dk), static_cast<float*>(dv), p.s,
                       p.h, p.h / p.kh, p.causal, p.scale);
  }
  CUtensorMap maps[4];
  if (!bwd_maps<D>(p, dout, kDkvRows, kDkvKeys, maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(flash_dkv_wgmma_kernel<D>, DkvLayout<D>::kBytes,
                     kThreadsTC, kDkvKeys, p.s, p.h, p.b, stream, maps[0],
                     maps[1], maps[2], maps[3], lse, dsum,
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), p.s, p.h,
                     p.h / p.kh, p.causal, p.scale);
}

// Dynamic shared memory of the bf16 kernel `which` (0 forward, 1 dQ,
// 2 dK/dV) at head dim D.
template <int D>
int bf16_smem(int which) {
  const size_t bytes = which == 0   ? FwdLayout<D>::kBytes
                       : which == 1 ? DqLayout<D>::kBytes
                                    : DkvLayout<D>::kBytes;
  return static_cast<int>(bytes);
}

// The same of the f32 kernel `which`.
template <int D>
int f32_smem(int which) {
  const size_t bytes = which == 0   ? F32Fwd<D>::kBytes
                       : which == 1 ? F32Dq<D>::kBytes
                                    : F32Dkv<D>::kBytes;
  return static_cast<int>(bytes);
}

// Run OP<D>(args...) for the head dim of the call.
#define FLASH_DISPATCH(OP, D_, ...)                    \
  switch (D_) {                                        \
    case 16:                                           \
      return OP<16>(__VA_ARGS__);                      \
    case 32:                                           \
      return OP<32>(__VA_ARGS__);                      \
    case 64:                                           \
      return OP<64>(__VA_ARGS__);                      \
    case 128:                                          \
      return OP<128>(__VA_ARGS__);                     \
    default:                                           \
      return static_cast<int>(cudaErrorInvalidValue);  \
  }

bool bad_shape(int b, int h, int kh, int s) {
  return b < 1 || h < 1 || kh < 1 || s < 1 || h % kh != 0 || h > 65535 ||
         b > 65535;
}

}  // namespace

// out (and lse, unless it is null) from q, k, v.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int b, int h, int kh,
                                int s, int d, int bf16, int causal,
                                float scale, cudaStream_t stream) {
  if (bad_shape(b, h, kh, s)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{q, k, v, b, h, kh, s, causal, scale};
  FLASH_DISPATCH(fwd, d, p, bf16 != 0, out, lse, stream)
}

// dq from q, k, v, dout, the forward's lse and dsum = rowsum(dout * out).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* dsum, void* dq_out, int b, int h,
                               int kh, int s, int d, int bf16, int causal,
                               float scale, cudaStream_t stream) {
  if (bad_shape(b, h, kh, s)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{q, k, v, b, h, kh, s, causal, scale};
  FLASH_DISPATCH(dq, d, p, bf16 != 0, dout, lse, dsum, dq_out, stream)
}

// Per-q-head dk_h and dv_h (B, H, S, D) from the same inputs.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* dsum, void* dk, void* dv, int b,
                                int h, int kh, int s, int d, int bf16,
                                int causal, float scale,
                                cudaStream_t stream) {
  if (bad_shape(b, h, kh, s)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{q, k, v, b, h, kh, s, causal, scale};
  FLASH_DISPATCH(dkv, d, p, bf16 != 0, dout, lse, dsum, dk, dv, stream)
}

// Bytes of dynamic shared memory the bf16 kernel `which` (0 forward, 1 dQ,
// 2 dK/dV) is launched with at head dim d, one of 16, 32, 64, 128.
extern "C" int flash_bf16_smem_bytes(int which, int d) {
  FLASH_DISPATCH(bf16_smem, d, which)
}

// The same for the f32 kernel `which` (0 forward, 1 dQ, 2 dK/dV).
extern "C" int flash_f32_smem_bytes(int which, int d) {
  FLASH_DISPATCH(f32_smem, d, which)
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
