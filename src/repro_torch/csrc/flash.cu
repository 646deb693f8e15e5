// Flash attention with GQA for sm_90a: the forward (with an optional row
// logsumexp), and the backward's dQ and dK/dV kernels.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (B8, the
// Pallas TPU kernel _flash_kernel) and
// src/repro/kernels/flash_attention_bwd.py (B9): flash_attention_fwd
// (_fwd_kernel), and flash_attention_bwd's _dq_kernel and _dkv_kernel. The
// forward kernel serves both B8 (lse == nullptr) and B9's forward.
//
// Layout: q, dout, out, dq, dk_h, dv_h are (B, H, S, D) row-major; k, v are
// (B, KH, S, D); lse and dsum are (B, H, S) f32. q-head h reads kv head
// h / (H / KH). Inputs are f32 or bf16 (read through __bfloat162float);
// every sum runs in f32; outputs are written in the input type (bf16
// through __float2bfloat16_rn, round to nearest even, as JAX's astype).
//
// Bound on the H100: operations. A causal forward does 2 B H S^2 D flops
// (half of the 4 B H S^2 D of Q K^T and P V), the backward 2.5 times that;
// at smollm-135m's attention (B 4, H 9, KH 3, S 4096, D 64) that is 77
// GFLOP forward on 50 MB of q, k, v and out in bf16 (101 MB in f32), far
// above the card's ridge point either way. These kernels do plain
// f32 FMAs on the CUDA cores (67 TFLOP/s of f32 at the most), no tensor
// cores, no TMA: a simple kernel that is right comes first, and it is held
// to its plain PyTorch version (repro_torch/kernels/ref.py) within a
// stated tolerance.
//
// Design. The TPU kernels run a sequential k-block (or q-block) grid axis
// with the running state in VMEM scratch. Here one block of 256 threads
// owns one 64-row tile and loops over the other axis itself:
//  * flash_fwd_kernel: one block per (q-tile, q-head, batch); it streams
//    the 64-row k/v tiles of its kv head through shared memory and keeps
//    the running max, denominator and accumulator of its rows in
//    registers. The causal loop stops at the diagonal tile: tiles wholly
//    above it are never visited. Every row starts at tile 0, whose key 0
//    is visible to every row, so the running max is finite after the first
//    tile and a masked score (-inf) contributes exp(-inf) = 0; no -1e30
//    sentinel is needed.
//  * flash_dq_kernel: one block per (q-tile, q-head, batch), looping over
//    k-tiles: P = exp(S - lse), dS = P (dO V^T - dsum), dQ += dS K.
//  * flash_dkv_kernel: one block per (k-tile, q-head, batch), looping over
//    q-tiles: dV += P^T dO, dK += dS^T Q; per q-head dK and dV, group-summed
//    by the caller as in the reference.
// Thread (tx, ty) of 16 x 16 owns rows ty + 16 a (a < 4) and columns
// tx + 16 c of every 64 x 64 score tile and of the 64 x D accumulators, so
// a row's max and sum are shuffles among the 16 lanes of one half-warp.
// Tiles of q, k, v, dO sit in shared memory with row stride D + 1 (no bank
// conflicts when 16 lanes read one column of 16 rows); S is not a multiple
// of 64 in general, so loads zero the rows past S, key columns past S are
// masked and rows past S are not written. More than 48 KB of dynamic shared
// memory (up to 162 KB for dK/dV at D 128) is opted into per kernel with
// cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kTile = 64;            // rows of a q tile and of a k tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kPadP = kTile + 1;     // row stride of a 64 x 64 score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + 64) of the (S, D) matrix at src into dst (row stride
// D + 1), in f32; rows at or past S are zero.
template <int D, typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                          int s) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < s ? to_f(src[static_cast<size_t>(row) * D + c]) : 0.0f;
  }
}

// acc[i][j] += sum_k a[ty + 16 i][k] * b[tx + 16 j][k]: a 64 x 64 tile of
// A B^T from two (64, D) tiles of row stride D + 1.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[4][4],
                                            const float* a, const float* b,
                                            int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][c] += sum_r p[ty + 16 i][r] * x[r][tx + 16 c]: a 64 x 64 tile
// (stride kPadP) times a (64, D) tile (stride D + 1).
template <int D>
__device__ __forceinline__ void product_px(float (&acc)[4][D / 16],
                                           const float* p, const float* x,
                                           int tx, int ty) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[4], xv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPadP + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[r * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
      }
    }
  }
}

// Max and sum over the 16 lanes of a half-warp (the 16 threads that share
// a row); every lane gets the same value.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int s, int h, int group,
                 int causal, float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + kTile * (D + 1);
  float* s_v = s_k + kTile * (D + 1);
  float* s_p = s_v + kTile * (D + 1);
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kh = h / group;
  const size_t q_base = (static_cast<size_t>(bi) * h + hi) * s * D;
  const size_t kv_base =
      (static_cast<size_t>(bi) * kh + hi / group) * s * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  load_tile<D>(s_q, q + q_base, q0, s);

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int nk = causal ? qt + 1 : (s + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the last tile's reads of s_k, s_v, s_p are done
    load_tile<D>(s_k, k + kv_base, k0, s);
    load_tile<D>(s_v, v + kv_base, k0, s);
    __syncthreads();
    float sc[4][4] = {};
    product_abt<D>(sc, s_q, s_k, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < s && (!causal || kpos <= qpos);
        sc[i][j] = keep ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);   // 0 at the first tile
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        s_p[(ty + 16 * i) * kPadP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    product_px<D>(acc, s_p, s_v, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + q_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) put(o + tx + 16 * c, acc[i][c] / denom);
    if (lse != nullptr && tx == 0) {
      lse[(static_cast<size_t>(bi) * h + hi) * s + row] = m[i] + logf(denom);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                T* __restrict__ dq, int s, int h, int group, int causal,
                float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kTile * (D + 1);
  float* s_k = s_do + kTile * (D + 1);
  float* s_v = s_k + kTile * (D + 1);
  float* s_ds = s_v + kTile * (D + 1);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kh = h / group;
  const size_t row_base = (static_cast<size_t>(bi) * h + hi) * s;
  const size_t q_base = row_base * D;
  const size_t kv_base =
      (static_cast<size_t>(bi) * kh + hi / group) * s * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  load_tile<D>(s_q, q + q_base, q0, s);
  load_tile<D>(s_do, dout + q_base, q0, s);
  float row_lse[4], row_dsum[4];
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < s ? lse[row_base + row] : 0.0f;
    row_dsum[i] = row < s ? dsum[row_base + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int nk = causal ? qt + 1 : (s + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(s_k, k + kv_base, k0, s);
    load_tile<D>(s_v, v + kv_base, k0, s);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    product_abt<D>(sc, s_q, s_k, tx, ty);
    product_abt<D>(dp, s_do, s_v, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < s && (!causal || kpos <= qpos);
        const float p = keep ? expf(sc[i][j] * scale - row_lse[i]) : 0.0f;
        s_ds[(ty + 16 * i) * kPadP + tx + 16 * j] =
            p * (dp[i][j] - row_dsum[i]);
      }
    }
    __syncthreads();
    product_px<D>(acc, s_ds, s_k, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    T* o = dq + q_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) put(o + tx + 16 * c, acc[i][c] * scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, T* __restrict__ dk,
                 T* __restrict__ dv, int s, int h, int group, int causal,
                 float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTile * (D + 1);
  float* s_q = s_v + kTile * (D + 1);
  float* s_do = s_q + kTile * (D + 1);
  float* s_pt = s_do + kTile * (D + 1);   // P^T tile: [key][query]
  float* s_dst = s_pt + kTile * kPadP;    // dS^T tile
  float* s_lse = s_dst + kTile * kPadP;
  float* s_dsum = s_lse + kTile;
  const int kt = blockIdx.x;   // causal: the first k-tiles see the most rows
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kh = h / group;
  const size_t row_base = (static_cast<size_t>(bi) * h + hi) * s;
  const size_t q_base = row_base * D;
  const size_t kv_base =
      (static_cast<size_t>(bi) * kh + hi / group) * s * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * kTile;
  load_tile<D>(s_k, k + kv_base, k0, s);
  load_tile<D>(s_v, v + kv_base, k0, s);
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;
  }
  const int nq = (s + kTile - 1) / kTile;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(s_q, q + q_base, q0, s);
    load_tile<D>(s_do, dout + q_base, q0, s);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      s_lse[threadIdx.x] = row < s ? lse[row_base + row] : 0.0f;
      s_dsum[threadIdx.x] = row < s ? dsum[row_base + row] : 0.0f;
    }
    __syncthreads();
    // rows: keys ty + 16 i of this k-tile; columns: queries tx + 16 j
    float st[4][4] = {}, dpt[4][4] = {};
    product_abt<D>(st, s_k, s_q, tx, ty);
    product_abt<D>(dpt, s_v, s_do, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int qpos = q0 + col;
        const bool keep = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = keep ? expf(st[i][j] * scale - s_lse[col]) : 0.0f;
        s_pt[(ty + 16 * i) * kPadP + col] = p;
        s_dst[(ty + 16 * i) * kPadP + col] = p * (dpt[i][j] - s_dsum[col]);
      }
    }
    __syncthreads();
    product_px<D>(acc_v, s_pt, s_do, tx, ty);
    product_px<D>(acc_k, s_dst, s_q, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s) continue;
    T* ok = dk + q_base + static_cast<size_t>(row) * D;
    T* ov = dv + q_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      put(ok + tx + 16 * c, acc_k[i][c] * scale);
      put(ov + tx + 16 * c, acc_v[i][c]);
    }
  }
}

template <int D>
constexpr size_t tiles_bytes(int n_tiles) {
  return static_cast<size_t>(n_tiles) * kTile * (D + 1) * sizeof(float);
}

// Opt the kernel into `bytes` of dynamic shared memory, launch it on the
// (q- or k-tile, q-head, batch) grid, and return cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t bytes, int s, int h, int b,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s + kTile - 1) / kTile, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  int b, h, kh, s, causal;
  float scale;
};

template <int D, typename T>
int fwd(const Problem& p, void* out, float* lse, cudaStream_t stream) {
  return launch(flash_fwd_kernel<D, T>,
                tiles_bytes<D>(3) + kTile * kPadP * sizeof(float), p.s, p.h,
                p.b, stream, static_cast<const T*>(p.q),
                static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                static_cast<T*>(out), lse, p.s, p.h, p.h / p.kh, p.causal,
                p.scale);
}

template <int D, typename T>
int dq(const Problem& p, const void* dout, const float* lse,
       const float* dsum, void* dq_out, cudaStream_t stream) {
  return launch(flash_dq_kernel<D, T>,
                tiles_bytes<D>(4) + kTile * kPadP * sizeof(float), p.s, p.h,
                p.b, stream, static_cast<const T*>(p.q),
                static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                static_cast<const T*>(dout), lse, dsum,
                static_cast<T*>(dq_out), p.s, p.h, p.h / p.kh, p.causal,
                p.scale);
}

template <int D, typename T>
int dkv(const Problem& p, const void* dout, const float* lse,
        const float* dsum, void* dk, void* dv, cudaStream_t stream) {
  return launch(flash_dkv_kernel<D, T>,
                tiles_bytes<D>(4) + 2 * kTile * kPadP * sizeof(float)
                    + 2 * kTile * sizeof(float),
                p.s, p.h, p.b, stream, static_cast<const T*>(p.q),
                static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dk),
                static_cast<T*>(dv), p.s, p.h, p.h / p.kh, p.causal,
                p.scale);
}

// Run Op<D, T>(args...) for the head dim and input type of the call.
#define FLASH_DISPATCH(OP, D_, BF16, ...)                                  \
  switch (D_) {                                                            \
    case 16:                                                               \
      return BF16 ? OP<16, __nv_bfloat16>(__VA_ARGS__)                     \
                  : OP<16, float>(__VA_ARGS__);                            \
    case 32:                                                               \
      return BF16 ? OP<32, __nv_bfloat16>(__VA_ARGS__)                     \
                  : OP<32, float>(__VA_ARGS__);                            \
    case 64:                                                               \
      return BF16 ? OP<64, __nv_bfloat16>(__VA_ARGS__)                     \
                  : OP<64, float>(__VA_ARGS__);                            \
    case 128:                                                              \
      return BF16 ? OP<128, __nv_bfloat16>(__VA_ARGS__)                    \
                  : OP<128, float>(__VA_ARGS__);                           \
    default:                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
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
  FLASH_DISPATCH(fwd, d, bf16, p, out, lse, stream)
}

// dq from q, k, v, dout, the forward's lse and dsum = rowsum(dout * out).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* dsum, void* dq_out, int b, int h,
                               int kh, int s, int d, int bf16, int causal,
                               float scale, cudaStream_t stream) {
  if (bad_shape(b, h, kh, s)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{q, k, v, b, h, kh, s, causal, scale};
  FLASH_DISPATCH(dq, d, bf16, p, dout, lse, dsum, dq_out, stream)
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
  FLASH_DISPATCH(dkv, d, bf16, p, dout, lse, dsum, dk, dv, stream)
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
