// Fused residual add + LayerNorm, forward and backward.
//
// Replaces the TPU kernels of vqattack_tpu/ops/fused_ln.py: the forward
// _pallas_fwd (body _fwd_kernel) and the backward _pallas_bwd (body
// _bwd_kernel), reached through residual_layernorm and its custom VJP.
//
// Forward, per row of D features:
//   s = x + delta                      (in the stream dtype, float32 or bf16)
//   mean, var of s in float32
//   h = (s - mean) * rsqrt(var + eps) * gamma + beta, cast to the stream dtype
// Backward, per row, from s (the statistics are recomputed, not stored):
//   xhat = (s - mean) * rstd,  dxhat = gh * gamma
//   dx   = gs + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dgamma = sum_rows gh * xhat,  dbeta = sum_rows gh
// dx serves as the gradient of both x and delta.
//
// Bound on the H100: bytes.  At the main path's shape (901 rows x 768,
// float32, batch 1) the forward reads x and delta and writes s and h:
// 11.07 MB, 3.3 us at 3.35 TB/s; the backward reads s, gs and gh and
// writes dx: 11.07 MB, 3.3 us.  A few flops per byte, far below the
// card's ratio of operations to bandwidth.
//
// Design:
// - one block of 256 threads per row; a thread keeps its D/256 values in
//   registers, so each input is read from device memory once;
// - row sums by warp shuffles, then across the 8 warps through shared memory;
// - the TPU kernel carried dgamma/dbeta across its sequential grid.  Blocks
//   on Hopper run in no order, so each backward block writes the partial
//   sums of its rows to a [n_row_blocks, D] float32 scratch, and a second
//   kernel reduces the scratch over row blocks in a fixed order: the result
//   is the same on every run (no atomics).  Both are skipped when the
//   caller needs no parameter gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// values per thread held in registers: D <= kThreads * kMaxPerThread
constexpr int kMaxPerThread = 4;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// The sum of v over the block, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* shm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with shm
  if (lane == 0) shm[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? shm[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ s_out,
                           T* __restrict__ h_out, int d, float eps) {
  __shared__ float shm[32];
  const size_t base = (size_t)blockIdx.x * d;
  float v[kMaxPerThread];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    v[k] = 0.f;
    if (c < d) {
      // the add happens in the stream dtype, as the JAX kernel's does
      const T s = from_f<T>(to_f<T>(x[base + c]) + to_f<T>(delta[base + c]));
      s_out[base + c] = s;
      v[k] = to_f<T>(s);
      sum += v[k];
    }
  }
  const float mean = block_sum(sum, shm) / d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < d) {
      const float t = v[k] - mean;
      sq += t * t;
    }
  }
  const float rstd = rsqrtf(block_sum(sq, shm) / d + eps);
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < d) h_out[base + c] = from_f<T>((v[k] - mean) * rstd * gamma[c] + beta[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_ln_bwd_kernel(const T* __restrict__ s, const T* __restrict__ gs,
                           const T* __restrict__ gh,
                           const float* __restrict__ gamma, T* __restrict__ dx,
                           float* __restrict__ part, int rows, int d,
                           int rows_per_block, int n_row_blocks, float eps) {
  __shared__ float shm[32];
  float acc_g[kMaxPerThread], acc_b[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) acc_g[k] = acc_b[k] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * d;
    float v[kMaxPerThread], g[kMaxPerThread];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = threadIdx.x + k * kThreads;
      v[k] = g[k] = 0.f;
      if (c < d) {
        v[k] = to_f<T>(s[base + c]);
        g[k] = to_f<T>(gh[base + c]);
        sum += v[k];
      }
    }
    const float mean = block_sum(sum, shm) / d;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < d) {
        const float t = v[k] - mean;
        sq += t * t;
      }
    }
    const float rstd = rsqrtf(block_sum(sq, shm) / d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < d) {
        v[k] = (v[k] - mean) * rstd;  // xhat from here on
        const float dxh = g[k] * gamma[c];
        s1 += dxh;
        s2 += dxh * v[k];
      }
    }
    const float c1 = block_sum(s1, shm) / d;
    const float c2 = block_sum(s2, shm) / d;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < d) {
        const float dxh = g[k] * gamma[c];
        const float pass = gs != nullptr ? to_f<T>(gs[base + c]) : 0.f;
        dx[base + c] = from_f<T>(pass + rstd * (dxh - c1 - v[k] * c2));
        acc_g[k] += g[k] * v[k];
        acc_b[k] += g[k];
      }
    }
  }
  if (part != nullptr) {
    // part: [2, n_row_blocks, d] -- dgamma partials, then dbeta partials
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < d) {
        part[(size_t)blockIdx.x * d + c] = acc_g[k];
        part[((size_t)n_row_blocks + blockIdx.x) * d + c] = acc_b[k];
      }
    }
  }
}

// out[y, c] = sum over b of part[y, b, c], b ascending: a fixed order.
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n_row_blocks,
                                  int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const float* p = part + (size_t)blockIdx.y * n_row_blocks * d;
  float acc = 0.f;
  for (int b = 0; b < n_row_blocks; ++b) acc += p[(size_t)b * d + c];
  out[(size_t)blockIdx.y * d + c] = acc;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int vq_residual_layernorm_fwd(int dtype, const void* x,
                                         const void* delta, const void* gamma,
                                         const void* beta, void* s, void* h,
                                         int rows, int d, float eps,
                                         void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    residual_ln_fwd_kernel<float><<<rows, kThreads, 0, st>>>(
        (const float*)x, (const float*)delta, (const float*)gamma,
        (const float*)beta, (float*)s, (float*)h, d, eps);
  } else if (dtype == 1) {
    residual_ln_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)delta,
        (const float*)gamma, (const float*)beta, (__nv_bfloat16*)s,
        (__nv_bfloat16*)h, d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// gs may be null (no gradient reached s).  part and dgdb may be null (no
// parameter gradient wanted); otherwise part is [2, n_row_blocks, d] and
// dgdb is [2, d] float32 scratch and output.
extern "C" int vq_residual_layernorm_bwd(int dtype, const void* s,
                                         const void* gs, const void* gh,
                                         const void* gamma, void* dx,
                                         void* part, void* dgdb, int rows,
                                         int d, int rows_per_block, float eps,
                                         void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kThreads * kMaxPerThread || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  if ((part == nullptr) != (dgdb == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_row_blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (dtype == 0) {
    residual_ln_bwd_kernel<float><<<n_row_blocks, kThreads, 0, st>>>(
        (const float*)s, (const float*)gs, (const float*)gh,
        (const float*)gamma, (float*)dx, (float*)part, rows, d, rows_per_block,
        n_row_blocks, eps);
  } else if (dtype == 1) {
    residual_ln_bwd_kernel<__nv_bfloat16><<<n_row_blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)s, (const __nv_bfloat16*)gs,
        (const __nv_bfloat16*)gh, (const float*)gamma, (__nv_bfloat16*)dx,
        (float*)part, rows, d, rows_per_block, n_row_blocks, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  dim3 grid((d + kThreads - 1) / kThreads, 2);
  column_sum_kernel<<<grid, kThreads, 0, st>>>((const float*)part,
                                               (float*)dgdb, n_row_blocks, d);
  return (int)cudaGetLastError();
}
