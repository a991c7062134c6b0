// PGD L-inf perturbation update, one pass over the pixel buffer.
//
// Replaces the TPU kernel vqattack_tpu/ops/pgd_update.py::pgd_linf_update
// (Pallas body _update_kernel).  Elementwise, in float32:
//
//   stepped = clamp(adv + eps_iter * sign(grad), cmin, cmax)
//   eta     = clamp(stepped - ori, -eps, eps)
//   out     = clamp(ori + eta, cmin, cmax)
//
// Bound on the H100: bytes.  Three reads and one write of 4 bytes per
// element and about ten flops: a 480 px sample is 691,200 elements, so
// 11.06 MB moved, 3.3 us at 3.35 TB/s.  Design: one grid-stride pass over
// the contiguous buffer; the TPU's (rows, 128) lane tiling has no meaning
// here and is not carried over.
//
// Exactness: the result equals the plain PyTorch chain bit for bit.
// eps_iter * sign(grad) is exactly +-eps_iter or 0, so if the compiler
// contracts adv + eps_iter * sign(grad) into one FMA the rounded sum is the
// same as the two-step product-then-add.  Every other operation is a single
// IEEE add, subtract or min/max, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void pgd_linf_update_kernel(const float* __restrict__ adv,
                                       const float* __restrict__ grad,
                                       const float* __restrict__ ori,
                                       float* __restrict__ out, int64_t n,
                                       float eps, float eps_iter, float cmin,
                                       float cmax) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g = grad[i];
    // torch.sign: (0 < g) - (g < 0), so sign(+-0) = +0
    const float sgn = (float)((0.f < g) - (g < 0.f));
    const float o = ori[i];
    const float stepped = clampf(adv[i] + eps_iter * sgn, cmin, cmax);
    const float eta = clampf(stepped - o, -eps, eps);
    out[i] = clampf(o + eta, cmin, cmax);
  }
}

}  // namespace

extern "C" int vq_pgd_linf_update(const void* adv, const void* grad,
                                  const void* ori, void* out, long long n,
                                  float eps, float eps_iter, float cmin,
                                  float cmax, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  pgd_linf_update_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)adv, (const float*)grad, (const float*)ori, (float*)out,
      (int64_t)n, eps, eps_iter, cmin, cmax);
  return (int)cudaGetLastError();
}
