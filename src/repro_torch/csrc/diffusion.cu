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
// Design: one block per lane. The block copies its lane's world into shared
// memory once (coalesced; 72x72 f32 = 20.7 KB at the paper's size), then each
// thread computes output patches from shared memory, so each input byte
// leaves device memory once and each output byte is written once, coalesced.
// The float order is the TPU kernel's, operation by operation:
//   share = chem*rate*(1/8); acc = sum of the 8 neighbour shares
//   share[i-di][j-dj] from 0 in (di, dj) row-major order (off-world terms
//   add 0); kept = chem - share*ncount; out = (kept + acc)*(1 - evap).
// The __f*_rn intrinsics keep nvcc from contracting a multiply and an add
// into an FMA, so the result is bitwise equal to the plain PyTorch version
// (repro_torch/kernels/ref.py::diffuse_evaporate_ref) on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void diffuse_evaporate_kernel(const float* __restrict__ chem,
                                         const float* __restrict__ rate,
                                         const float* __restrict__ evap,
                                         float* __restrict__ out, int w) {
  extern __shared__ float world[];
  const int cells = w * w;
  const size_t base = static_cast<size_t>(blockIdx.x) * cells;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) world[k] = chem[base + k];
  __syncthreads();

  const float r = rate[blockIdx.x];
  const float keep = __fsub_rn(1.0f, evap[blockIdx.x]);
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int i = k / w;
    const int j = k - i * w;
    float acc = 0.0f;
    int ncount = 0;
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
        if (di == 0 && dj == 0) continue;
        const int si = i - di;
        const int sj = j - dj;
        float s = 0.0f;
        if (si >= 0 && si < w && sj >= 0 && sj < w) {
          s = __fmul_rn(__fmul_rn(world[si * w + sj], r), 0.125f);
          ++ncount;
        }
        acc = __fadd_rn(acc, s);
      }
    }
    const float c = world[k];
    const float share = __fmul_rn(__fmul_rn(c, r), 0.125f);
    const float kept = __fsub_rn(c, __fmul_rn(share, static_cast<float>(ncount)));
    out[base + k] = __fmul_rn(__fadd_rn(kept, acc), keep);
  }
}

}  // namespace

extern "C" int diffuse_evaporate_launch(const float* chem, const float* rate,
                                        const float* evap, float* out, int n,
                                        int w, cudaStream_t stream) {
  if (n == 0 || w == 0) return 0;
  const size_t smem = static_cast<size_t>(w) * w * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        diffuse_evaporate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  diffuse_evaporate_kernel<<<n, kThreads, smem, stream>>>(chem, rate, evap, out, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
