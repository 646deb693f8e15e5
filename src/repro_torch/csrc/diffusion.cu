// Fused NetLogo diffuse + evaporate on a bounded world, for sm_90a.
//
// Replaces: src/repro/kernels/diffusion.py::diffuse_evaporate, the Pallas
// TPU kernel (body _diffuse_kernel) that the ants model runs once per tick
// on its whole (N, W, W) stack of chemical fields.
//
// Bound on the H100: memory. A call reads N*W*W*4 B of field and writes as
// many (plus 8 B of rates per lane). The stencil does about 30 float
// operations per patch, ~4 per byte moved, while the card does 20 f32
// operations (67 TFLOP/s) per byte its HBM delivers (3.35 TB/s): the bytes
// bound it.
//
// Design: persistent blocks, each walking the lanes blockIdx.x,
// blockIdx.x + gridDim.x, ... through a ring of two lane worlds in shared
// memory, so that the next lane's field arrives while the current one
// computes. The caller (repro_torch/kernels/diffusion.py) picks the grid
// (SMs x the blocks one SM holds) and the route:
//  * bulk: when each lane's world is a multiple of 16 bytes (W even) and
//    the field is 16-byte aligned, one thread moves a whole world with one
//    cp.async.bulk into an mbarrier, and the result leaves the same way: it
//    is written over the lane's world in shared memory and a bulk store
//    copies it out, while the block goes on to the next lane;
//  * cp_async: otherwise every thread copies 4-byte words with cp.async
//    (commit groups), and writes its results with plain coalesced stores.
// Per lane, each patch's share (chem*rate)*(1/8) is computed once into a
// share buffer; then each thread walks one column of one band of rows,
// keeping the 3 x 3 window of shares in registers (three new shares a
// patch). Off-world shares are zeros that are added all the same, so
// interior and edge patches sum the same eight terms in the same order;
// interior patches take a path without bounds checks and with ncount 8.
// A world too large for two worlds and a share buffer (W > 139) is held
// once, and each patch computes its three new shares from the field.
//
// The float order is the TPU kernel's, operation by operation:
//   share = chem*rate*(1/8); acc = sum of the 8 neighbour shares
//   share[i-di][j-dj] from 0 in (di, dj) row-major order (off-world terms
//   add 0); kept = chem - share*ncount; out = (kept + acc)*(1 - evap).
// The __f*_rn intrinsics keep nvcc from contracting a multiply and an add
// into an FMA, so the result is bitwise equal to the plain PyTorch version
// (repro_torch/kernels/ref.py::diffuse_evaporate_ref) on the card.
#include "async_copy.cuh"

namespace {

using namespace async_copy;

constexpr int kMaxThreads = 512;
constexpr int kBarBytes = 128;    // the ring's mbarriers, ahead of the worlds

constexpr int kRouteBulk = 0;
constexpr int kRouteCpAsync = 1;

// One patch from its window of shares (u: row i-1, m: row i, d: row i+1;
// l, c, r: columns j-1, j, j+1), its field value and its neighbour count.
__device__ __forceinline__ float patch(float ul, float uc, float ur, float ml,
                                       float mc, float mr, float dl, float dc,
                                       float dr, float chem, float cnt,
                                       float keep) {
  // (di, dj) = (-1,-1), (-1,0), (-1,1), (0,-1), (0,1), (1,-1), (1,0), (1,1)
  // take share[i-di][j-dj]
  float acc = 0.0f;
  acc = __fadd_rn(acc, dr);
  acc = __fadd_rn(acc, dc);
  acc = __fadd_rn(acc, dl);
  acc = __fadd_rn(acc, mr);
  acc = __fadd_rn(acc, ml);
  acc = __fadd_rn(acc, ur);
  acc = __fadd_rn(acc, uc);
  acc = __fadd_rn(acc, ul);
  const float kept = __fsub_rn(chem, __fmul_rn(mc, cnt));
  return __fmul_rn(__fadd_rn(kept, acc), keep);
}

// kBulk: the bulk route. kRing: two worlds and a share buffer (one lane
// loads while the other computes), else one world, the shares computed
// from the field.
template <bool kBulk, bool kRing>
__global__ void __launch_bounds__(kMaxThreads)
diffuse_evaporate_kernel(const float* __restrict__ chem,
                         const float* __restrict__ rate,
                         const float* __restrict__ evap,
                         float* __restrict__ out, int n, int w, int bands) {
  constexpr int S = kRing ? 2 : 1;       // worlds in shared memory
  // results go back over the world and out by bulk store
  constexpr bool kBulkStore = kBulk && kRing;

  unsigned char* smem = dynamic_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* slots = reinterpret_cast<float*>(smem + kBarBytes);
  const int cells = w * w;
  float* share = slots + S * cells;
  const int tid = threadIdx.x;
  const int lanes = (n - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  // Start loading this block's lane i into slot i % S (nothing past the
  // last lane; the cp_async route still commits a group, so that each
  // iteration waits on the same group count).
  auto fill = [&](int i) {
    float* dst = slots + (i % S) * cells;
    const float* src =
        chem + static_cast<size_t>(blockIdx.x + i * gridDim.x) * cells;
    if constexpr (kBulk) {
      if (tid == 0 && i < lanes) {
        mbar_expect_tx(&full[i % S], cells * 4);
        bulk_load(dst, src, cells * 4, &full[i % S]);
      }
    } else {
      if (i < lanes) {
        for (int k = tid; k < cells; k += blockDim.x) {
          cp_async<4>(dst + k, src + k);
        }
      }
      cp_async_commit();
    }
  };

  if constexpr (kBulk) {
    if (tid == 0) {
      for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  if constexpr (kRing) fill(0);

  // The stencil's threads: column j of band g of rows [i0, i1)
  const bool walker = tid < w * bands;
  const int j = tid % w;
  const int band = tid / w;
  const int i0 = band * w / bands;
  const int i1 = (band + 1) * w / bands;
  const bool has_l = j > 0;
  const bool has_r = j + 1 < w;
  const bool inner_col = has_l && has_r;
  const int ncols = 1 + has_l + has_r;

  for (int i = 0; i < lanes; ++i) {
    const int s = i % S;
    float* world = slots + s * cells;
    if constexpr (!kRing) fill(i);   // the one slot is free again
    if constexpr (kBulk) {
      mbar_wait(&full[s], (i / S) & 1);
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }
    const int lane = blockIdx.x + i * gridDim.x;
    const float r = rate[lane];
    const float keep = __fsub_rn(1.0f, evap[lane]);
    float* lane_out = out + static_cast<size_t>(lane) * cells;

    if constexpr (kRing) {
      if (cells % 4 == 0) {
        const float4* src = reinterpret_cast<const float4*>(world);
        float4* dst = reinterpret_cast<float4*>(share);
        for (int k = tid; k < cells / 4; k += blockDim.x) {
          const float4 c = src[k];
          dst[k] = make_float4(__fmul_rn(__fmul_rn(c.x, r), 0.125f),
                               __fmul_rn(__fmul_rn(c.y, r), 0.125f),
                               __fmul_rn(__fmul_rn(c.z, r), 0.125f),
                               __fmul_rn(__fmul_rn(c.w, r), 0.125f));
        }
      } else {
        for (int k = tid; k < cells; k += blockDim.x) {
          share[k] = __fmul_rn(__fmul_rn(world[k], r), 0.125f);
        }
      }
      __syncthreads();
      // the other slot, lane i - 1's, is free once its store has read it:
      // load lane i + 1 there
      if constexpr (kBulkStore) {
        if (tid == 0) bulk_wait_read<0>();
      }
      fill(i + 1);
    }

    // share of patch k: from the buffer, or from the field
    auto sh = [&](int k) {
      if constexpr (kRing) {
        return share[k];
      } else {
        return __fmul_rn(__fmul_rn(world[k], r), 0.125f);
      }
    };
    if (walker) {
      // window rows up (i-1), mid (i), down (i+1): shares of columns
      // j-1, j, j+1, zero off the world
      float ul = 0.0f, uc = 0.0f, ur = 0.0f;
      float ml, mc, mr;
      if (i0 > 0) {
        const int k = (i0 - 1) * w + j;
        ul = has_l ? sh(k - 1) : 0.0f;
        uc = sh(k);
        ur = has_r ? sh(k + 1) : 0.0f;
      }
      {
        const int k = i0 * w + j;
        ml = has_l ? sh(k - 1) : 0.0f;
        mc = sh(k);
        mr = has_r ? sh(k + 1) : 0.0f;
      }
      for (int row = i0; row < i1; ++row) {
        const int k = row * w + j;
        float dl = 0.0f, dc = 0.0f, dr = 0.0f;
        float v;
        if (inner_col && row > 0 && row + 1 < w) {
          // interior patch: eight neighbours in the world
          dl = sh(k + w - 1);
          dc = sh(k + w);
          dr = sh(k + w + 1);
          v = patch(ul, uc, ur, ml, mc, mr, dl, dc, dr, world[k], 8.0f, keep);
        } else {
          if (row + 1 < w) {
            dl = has_l ? sh(k + w - 1) : 0.0f;
            dc = sh(k + w);
            dr = has_r ? sh(k + w + 1) : 0.0f;
          }
          const int nrows = 1 + (row > 0) + (row + 1 < w);
          v = patch(ul, uc, ur, ml, mc, mr, dl, dc, dr, world[k],
                    static_cast<float>(nrows * ncols - 1), keep);
        }
        if constexpr (kBulkStore) {
          world[k] = v;   // only this thread reads world[k]
        } else {
          lane_out[k] = v;
        }
        ul = ml;
        uc = mc;
        ur = mr;
        ml = dl;
        mc = dc;
        mr = dr;
      }
    }

    if constexpr (kBulkStore) {
      fence_async_shared();
      __syncthreads();
      if (tid == 0) {
        bulk_store(lane_out, world, cells * 4);
        bulk_commit();
      }
    } else {
      __syncthreads();
    }
  }
  if constexpr (kBulkStore) {
    if (tid == 0) bulk_wait_all();
  }
}

template <bool kBulk, bool kRing>
int launch(const float* chem, const float* rate, const float* evap,
           float* out, int n, int w, int bands, int threads, int grid,
           cudaStream_t stream) {
  const size_t smem =
      kBarBytes + static_cast<size_t>(kRing ? 3 : 1) * w * w * 4;
  auto kernel = diffuse_evaporate_kernel<kBulk, kRing>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(chem, rate, evap, out, n, w, bands);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBulk>
int launch_route(const float* chem, const float* rate, const float* evap,
                 float* out, int n, int w, int ring, int bands, int threads,
                 int grid, cudaStream_t stream) {
  return ring ? launch<kBulk, true>(chem, rate, evap, out, n, w, bands,
                                    threads, grid, stream)
              : launch<kBulk, false>(chem, rate, evap, out, n, w, bands,
                                     threads, grid, stream);
}

}  // namespace

// route: 0 bulk, 1 cp_async; ring: two worlds and a share buffer (else
// one world); bands x w of the `threads` walk the stencil; grid:
// persistent blocks (at most n).
extern "C" int diffuse_evaporate_launch(const float* chem, const float* rate,
                                        const float* evap, float* out, int n,
                                        int w, int route, int ring, int bands,
                                        int threads, int grid,
                                        cudaStream_t stream) {
  if (n == 0 || w == 0) return 0;
  if (grid < 1 || grid > n || bands < 1 || bands > w || threads > kMaxThreads
      || threads < w * bands || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kRouteBulk) {
    if ((w * w) % 4 != 0 || reinterpret_cast<uintptr_t>(chem) % 16 != 0
        || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_route<true>(chem, rate, evap, out, n, w, ring, bands,
                              threads, grid, stream);
  }
  if (route == kRouteCpAsync) {
    return launch_route<false>(chem, rate, evap, out, n, w, ring, bands,
                               threads, grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
