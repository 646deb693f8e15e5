// Blocked triangular solve L X = B (forward) or L^T X = B (backward) through
// explicit inverses of the diagonal tiles, for sm_90a.
//
// Replaces: src/repro/kernels/cholesky.py::tri_solve_blocked, the Pallas TPU
// kernels _diag_inv_kernel, _solve_fwd_kernel and _solve_bwd_kernel. The
// archive-scale inducing fit (explore/bigfit.py::fit_inducing) solves
// L_m A = K_mn with it: L (512, 512), B (512, 50,000).
//
// Bound on the H100: operations. The solve does about n^2 m / 2
// multiply-adds (n^2 m flops, plus n * 64 * m for the products with the tile
// inverses) on (n^2 + 2 n m) * 4 bytes: at n = 512, m = 50,176 that is
// ~1.3e10 flops, ~0.2 ms at the 67 TFLOP/s of f32 outside the tensor cores,
// against ~0.06 ms of bytes. No TF32 and no tensor cores here: the kernel is
// held to its plain f32 version within a stated tolerance.
//
// Design. The TPU kernel runs the row-block axis in sequence on one core and
// keeps the solved X panel in VMEM. Here two launches:
//  * trisolve_pack_kernel lays out every 64 x 64 operand the solve will read
//    from L, in the order it reads them, each transposed into the layout of
//    the product (A^T, row-major), one block per tile, all at once: the
//    blocks of L below the diagonal, and the inverses of the diagonal tiles.
//    A diagonal tile is inverted by forward substitution on the identity,
//    its columns spread over 4 blocks of 8 warps: lane l holds rows l and
//    l + 32 of 2 columns in registers and takes row k's value by a shuffle,
//    so the steps run without a barrier.
//  * trisolve_kernel: one block of 256 threads owns a strip of W columns of
//    B (W = 64 or 16, chosen by the caller so that the strips fill the SMs
//    and the panel fits) and walks the row blocks in order:
//    acc = sum_j L_rj X_j (or L_jr^T X_j), T = B_r - acc, then
//    X_r = Linv_r T (or Linv_r^T T). The packed operands stream through a
//    ring of three 16 KB stages by cp.async.bulk into mbarriers, two tiles
//    ahead of the product, across row blocks (they do not depend on X); B_r
//    arrives by cp.async while the products of its row block run. The
//    solved blocks X_j stay in shared memory (the panel) as they are solved;
//    where n is too large for the whole panel, the blocks past the first
//    `resident` are read back from X (written by this block, after a
//    barrier). Each product runs from shared memory into a TM x TN register
//    tile per thread (8 x 4 at W 64), loading the next k's fragments while
//    the current ones multiply; the block's k groups each take a share of
//    the k of every product, so that each SM scheduler has two warps to
//    issue from, and their sums meet in shared memory twice per row block.
#include "async_copy.cuh"

namespace {

using namespace async_copy;

constexpr int kTile = 64;
constexpr int kTileFloats = kTile * kTile;
constexpr int kTileBytes = kTileFloats * 4;
constexpr int kStages = 3;            // packed tiles in the ring
constexpr int kSolveThreads = 256;
constexpr int kPackThreads = 256;
constexpr int kPadT = kTile + 1;      // the pack kernel's tile stride
constexpr int kInvSplit = 4;          // blocks that invert one diagonal tile
constexpr int kInvCols = kTile / kInvSplit;   // 2 columns a warp
constexpr int kBarBytes = 128;        // the ring's mbarriers, ahead of it

// Per strip width W: TM rows x TN columns per thread, NX threads along the
// strip's columns; (64 / TM) x NX threads make one k group, and the
// block's G groups each take 64 / G of the k of every product.
template <int W>
struct Strip {
  static constexpr int TM = 8;
  static constexpr int TN = W == 16 ? 2 : 4;
  static constexpr int NX = W / TN;
  static constexpr int kGroupThreads = (kTile / TM) * NX;
  static constexpr int G = kSolveThreads / kGroupThreads;
  static constexpr int KG = kTile / G;
  static_assert(G * kGroupThreads == kSolveThreads && TN % 2 == 0, "shape");
};

// Packed tile q(s, t) = s (s + 1) / 2 + t (t <= s) is the A operand of the
// t-th product of step s, which solves row block r(s) = trans ? nb-1-s : s:
// for t < s the block coupling it to row block r(t) (forward L_{r(s) r(t)},
// backward L_{r(t) r(s)}^T), for t = s the inverse of L_{r(s) r(s)}
// (transposed backward); stored as A^T, As[k][i] = A[i][k], 64 x 64.
// Grid (nb, nb, kInvSplit): block (t, s, 0) packs tile q(s, t); a diagonal
// tile is inverted by kInvSplit blocks, block z taking kInvCols columns.
__global__ void __launch_bounds__(kPackThreads)
trisolve_pack_kernel(const float* __restrict__ l, int n, int trans,
                     float* __restrict__ pack) {
  __shared__ float s_l[kTile * kPadT];
  __shared__ float s_rinv[kTile];
  const int t = blockIdx.x, s = blockIdx.y, part = blockIdx.z;
  if (t > s || (t < s && part > 0)) return;
  const int tid = threadIdx.x;
  const int nb = n / kTile;
  const int rs = trans ? nb - 1 - s : s;
  const int rt = trans ? nb - 1 - t : t;
  // the block of L read: rows of block br, columns of block bc
  const int br = trans ? rt : rs;
  const int bc = trans ? rs : rt;
  const float* src = l + static_cast<size_t>(br) * kTile * n + bc * kTile;
  for (int e = tid; e < kTileFloats; e += kPackThreads) {
    const int i = e / kTile, k = e % kTile;
    s_l[i * kPadT + k] = src[static_cast<size_t>(i) * n + k];
  }
  float* dst = pack + (static_cast<size_t>(s) * (s + 1) / 2 + t) * kTileFloats;
  __syncthreads();
  if (t < s) {
    // s_l holds M = the block, M[i][k] at s_l[i][k]. The forward operand
    // is M (As[k][i] = M[i][k]); the backward one M^T (As[k][i] = M[k][i]).
    for (int e = tid; e < kTileFloats; e += kPackThreads) {
      const int k = e / kTile, i = e % kTile;
      dst[e] = trans ? s_l[k * kPadT + i] : s_l[i * kPadT + k];
    }
    return;
  }
  // Columns col0 .. col0 + kInvCols - 1 of the inverse of the lower-
  // triangular tile, by forward substitution on the identity: warp w holds
  // columns col0 + 2w and col0 + 2w + 1, lane l their rows l and l + 32
  // (x[c][0], x[c][1]). Row k of every column is final at step k, and the
  // rows below it take -L[row][k] x[k] (k ascending). Rows above col0 stay
  // zero, so the steps start there.
  if (tid < kTile) s_rinv[tid] = 1.0f / s_l[tid * kPadT + tid];
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = part * kInvCols;
  float x[2][2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = col0 + 2 * warp + c;
    x[c][0] = lane == col ? 1.0f : 0.0f;
    x[c][1] = lane + 32 == col ? 1.0f : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk0 = max(0, min(32, col0 - 32 * h));
    for (int kk = kk0; kk < 32; ++kk) {
      const int k = 32 * h + kk;
      const float lo = s_l[lane * kPadT + k];
      const float hi = s_l[(lane + 32) * kPadT + k];
      const float rk = s_rinv[k];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float xk = __shfl_sync(0xffffffffu, x[c][h], kk) * rk;
        if (h == 0) {
          x[c][0] = lane > kk ? fmaf(-lo, xk, x[c][0])
                              : (lane == kk ? xk : x[c][0]);
          x[c][1] = fmaf(-hi, xk, x[c][1]);
        } else {
          x[c][1] = lane > kk ? fmaf(-hi, xk, x[c][1])
                              : (lane == kk ? xk : x[c][1]);
        }
      }
    }
  }
  __syncthreads();   // every warp has read its columns of L
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    s_l[lane * kPadT + col0 + 2 * warp + c] = x[c][0];
    s_l[(lane + 32) * kPadT + col0 + 2 * warp + c] = x[c][1];
  }
  __syncthreads();
  // this block's columns of M = the inverse: forward rows k = col of As,
  // backward columns i = col
  for (int e = tid; e < kTile * kInvCols; e += kPackThreads) {
    if (trans) {
      const int k = e / kInvCols, i = col0 + e % kInvCols;
      dst[k * kTile + i] = s_l[k * kPadT + i];
    } else {
      const int k = col0 + e / kTile, i = e % kTile;
      dst[k * kTile + i] = s_l[i * kPadT + k];
    }
  }
}

// Loads n (even) floats from 8- or 16-byte aligned shared memory.
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
#pragma unroll
  for (int u = 0; u < N; u += (N % 4 == 0 ? 4 : 2)) {
    if constexpr (N % 4 == 0) {
      const float4 f = *reinterpret_cast<const float4*>(p + u);
      v[u] = f.x;
      v[u + 1] = f.y;
      v[u + 2] = f.z;
      v[u + 3] = f.w;
    } else {
      const float2 f = *reinterpret_cast<const float2*>(p + u);
      v[u] = f.x;
      v[u + 1] = f.y;
    }
  }
}

// Stores n (even) floats to 8- or 16-byte aligned memory.
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
#pragma unroll
  for (int u = 0; u < N; u += (N % 4 == 0 ? 4 : 2)) {
    if constexpr (N % 4 == 0) {
      *reinterpret_cast<float4*>(p + u) =
          make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
    } else {
      *reinterpret_cast<float2*>(p + u) = make_float2(v[u], v[u + 1]);
    }
  }
}

// acc[a][b] += sum_k A[ty TM + a][k] B[k][tx TN + b] over the KG k of
// group g of the tile, with As[k][i] = A[i][k] (64 x 64) and Bs[k][c]
// (64 x W); the next k's fragments load while the current ones multiply.
template <int W>
__device__ __forceinline__ void tile_product(
    float (&acc)[Strip<W>::TM][Strip<W>::TN], const float* As,
    const float* Bs, int ty, int tx, int g) {
  constexpr int TM = Strip<W>::TM, TN = Strip<W>::TN, KG = Strip<W>::KG;
  As += g * KG * kTile + ty * TM;
  Bs += g * KG * W + tx * TN;
  float a[2][TM], b[2][TN];
  load_row(a[0], As);
  load_row(b[0], Bs);
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    if (k + 1 < KG) {
      load_row(a[(k + 1) & 1], As + (k + 1) * kTile);
      load_row(b[(k + 1) & 1], Bs + (k + 1) * W);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(a[k & 1][i], b[k & 1][j], acc[i][j]);
      }
    }
  }
}

// Dynamic shared memory of the solve kernel (kernels/cholesky.py's
// solve_smem_bytes computes the same).
template <int W>
constexpr size_t solve_smem_bytes(int resident) {
  return kBarBytes + 4 * (static_cast<size_t>(kStages) * kTileFloats +
                          static_cast<size_t>(2 + resident) * kTile * W);
}

template <int W>
__global__ void __launch_bounds__(kSolveThreads)
trisolve_kernel(const float* __restrict__ pack, const float* __restrict__ b,
                int n, int m, int trans, int resident, float* x) {
  using St = Strip<W>;
  constexpr int TM = St::TM, TN = St::TN, NX = St::NX, G = St::G;
  constexpr int kStripFloats = kTile * W;
  unsigned char* smem = dynamic_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  float* tbuf = ring + kStages * kTileFloats;   // B_r - acc, 64 x W
  // a block read back from x; after the products of a step, the other k
  // groups' partial sums
  float* back = tbuf + kStripFloats;
  float* panel = back + kStripFloats;           // X of the first steps
  const int tid = threadIdx.x;
  const int grp = tid / St::kGroupThreads;      // the k group of each product
  const int gt = tid % St::kGroupThreads;
  const int ty = gt / NX, tx = gt % NX;
  const int nb = n / kTile;
  const int c0 = blockIdx.x * W;
  const int total = nb * (nb + 1) / 2;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int q = 0; q < kStages && q < total; ++q) {
      mbar_expect_tx(&full[q], kTileBytes);
      bulk_load(ring + q * kTileFloats, pack + static_cast<size_t>(q) *
                kTileFloats, kTileBytes, &full[q]);
    }
  }
  // after every thread has read tile q's stage: load tile q + kStages there
  auto refill = [&](int q) {
    if (tid == 0 && q + kStages < total) {
      const int slot = q % kStages;
      mbar_expect_tx(&full[slot], kTileBytes);
      bulk_load(ring + slot * kTileFloats,
                pack + static_cast<size_t>(q + kStages) * kTileFloats,
                kTileBytes, &full[slot]);
    }
  };
  auto stage = [&](int q) {
    const int slot = q % kStages;
    mbar_wait(&full[slot], (q / kStages) & 1);
    return ring + slot * kTileFloats;
  };
  // row i of the thread's TM x TN piece of a 64 x W strip tile
  auto at = [&](float* tile, int i) {
    return tile + (ty * TM + i) * W + tx * TN;
  };
  // the sum of groups 1 .. G-1's acc into `back`, one group after another;
  // ends with a barrier
  auto gather = [&](float (&acc)[TM][TN]) {
#pragma unroll
    for (int g = G - 1; g >= 1; --g) {
      if (grp == g) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v[TN];
          if (g == G - 1) {
#pragma unroll
            for (int j = 0; j < TN; ++j) v[j] = acc[i][j];
          } else {
            load_row(v, at(back, i));
#pragma unroll
            for (int j = 0; j < TN; ++j) v[j] += acc[i][j];
          }
          store_row(at(back, i), v);
        }
      }
      __syncthreads();
    }
  };

  int q = 0;
  for (int s = 0; s < nb; ++s) {
    const int r = trans ? nb - 1 - s : s;
    // B_r of this strip into tbuf: group 0's threads, each the elements it
    // will own
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float* src = b + static_cast<size_t>(r * kTile + ty * TM + i) *
                                   m + c0 + tx * TN;
#pragma unroll
        for (int u = 0; u < TN; u += (TN % 4 == 0 ? 4 : 2)) {
          cp_async<(TN % 4 == 0 ? 16 : 8)>(at(tbuf, i) + u, src + u);
        }
      }
      cp_async_commit();
    }

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    for (int t = 0; t < s; ++t) {
      const float* xs = panel + t * kStripFloats;
      if (t >= resident) {
        const int rt = trans ? nb - 1 - t : t;
        for (int e = tid; e < kStripFloats / 4; e += kSolveThreads) {
          const int row = e / (W / 4), c4 = e % (W / 4);
          reinterpret_cast<float4*>(back)[e] = *reinterpret_cast<const float4*>(
              x + static_cast<size_t>(rt * kTile + row) * m + c0 + 4 * c4);
        }
        __syncthreads();
        xs = back;
      }
      tile_product<W>(acc, stage(q), xs, ty, tx, grp);
      __syncthreads();   // the stage (and `back`) read by every thread
      refill(q);
      ++q;
    }
    // T = (B_r - group 0's sum) - the other groups' sum
    gather(acc);
    if (grp == 0) {
      cp_async_wait<0>();
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float t[TN], o[TN];
        load_row(t, at(tbuf, i));
        load_row(o, at(back, i));
#pragma unroll
        for (int j = 0; j < TN; ++j) t[j] = (t[j] - acc[i][j]) - o[j];
        store_row(at(tbuf, i), t);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    __syncthreads();   // T complete; `back` free
    tile_product<W>(acc, stage(q), tbuf, ty, tx, grp);
    __syncthreads();   // the stage and T read by every thread
    refill(q);
    ++q;
    gather(acc);
    // X_r = the groups' sums: to x, and to the panel while it has room
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v[TN];
        load_row(v, at(back, i));
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = acc[i][j] + v[j];
        store_row(x + static_cast<size_t>(r * kTile + ty * TM + i) * m + c0 +
                      tx * TN, v);
        if (s < resident) store_row(at(panel + s * kStripFloats, i), v);
      }
    }
    __syncthreads();   // X_r visible to the block; tbuf and back free
  }
}

template <int W>
int launch_solve(const float* pack, const float* b, int n, int m, int trans,
                 int resident, float* x, cudaStream_t stream) {
  const size_t smem = solve_smem_bytes<W>(resident);
  cudaError_t e = cudaFuncSetAttribute(
      trisolve_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  trisolve_kernel<W><<<m / W, kSolveThreads, smem, stream>>>(
      pack, b, n, m, trans, resident, x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (n, n) and B (n, m) row-major, n and m multiples of 64; pack: scratch
// of n/64 (n/64 + 1) / 2 tiles of 64 x 64 floats; strip: 64 or 16 columns
// a block; resident: the solved row blocks kept in shared memory
// (1 .. n/64); B and X 16-byte aligned.
extern "C" int tri_solve_launch(const float* l, const float* b, int n, int m,
                                int trans, int strip, int resident,
                                float* pack, float* x, cudaStream_t stream) {
  if (n == 0 || m == 0) return 0;
  const int nb = n / kTile;
  if (n % kTile != 0 || m % kTile != 0 || resident < 1 || resident > nb
      || reinterpret_cast<uintptr_t>(b) % 16 != 0
      || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || reinterpret_cast<uintptr_t>(pack) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trisolve_pack_kernel<<<dim3(nb, nb, kInvSplit), kPackThreads, 0, stream>>>(
      l, n, trans != 0, pack);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (strip) {
    case 64:
      return launch_solve<64>(pack, b, n, m, trans, resident, x, stream);
    case 16:
      return launch_solve<16>(pack, b, n, m, trans, resident, x, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
