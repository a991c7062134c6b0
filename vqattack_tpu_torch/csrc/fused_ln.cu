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
// dx serves as the gradient of both x and delta; it is summed in float32
// and rounded once to the stream dtype.
//
// Bound on the H100: bytes.  At the batched path's chunk of 8 images (7208
// rows x 768) the backward reads s, gs and gh and writes dx: 88.58 MB,
// 26.44 us at 3.35 TB/s on a float32 stream, 44.29 MB, 13.22 us on a bf16
// one; the forward reads x and delta and writes s and h, the same bytes.
// A few flops per byte, far below the card's ratio of operations to
// bandwidth.
//
// Forward design:
// - one block of 256 threads per row; a thread keeps its D/256 values in
//   registers, so each input is read from device memory once;
// - row sums by warp shuffles, then across the 8 warps through shared memory.
//
// Backward design.  A block of 256 threads walking 4 rows, as the forward
// walks one, made each row a chain of latencies: one scalar load a value,
// four block-wide sums of two barriers each, gs read only after them, and
// the next row's loads waiting on all of it.  Halving the bytes (a bf16
// stream for a float32 one) took it only from 41.3 to 37.8 us at
// [7208, 768] (NVIDIA H100 80GB HBM3, 700 W).  So:
// - one warp a row, the row in registers: a lane holds D/32 values of s, gh
//   and gs, loaded as 16-byte vectors (neighbouring lanes on neighbouring
//   addresses), all three before the first sum.  The statistics are
//   two-pass from registers (the mean, then the sum of (s - mean)^2), and
//   mean(dxhat) and mean(dxhat * xhat) share one shuffle tree: three trees
//   a row and no barrier on the dx path;
// - a warp walks a contiguous run of rows and issues the next row's loads
//   before this row's sums (a register double buffer), so its bytes are in
//   flight while it reduces;
// - one wave over the card: a run of rows a warp, up to 8 warps a block, at
//   most 132 blocks, from the row count alone (ops/fused_ln.py::
//   bwd_partition; never from the device, so the sums below add in the same
//   order on every card);
// - a row that is not a whole number of 16-byte vectors, or a tensor that
//   does not start on a 16-byte boundary, takes the scalar instance of the
//   same kernel (lane l holds columns l, l + 32, ...);
// - dgamma/dbeta: each lane adds gh * xhat and gh of its own columns over
//   its warp's rows in registers; a block adds its warps' sums in shared
//   memory in warp order and writes one row of a [2, n_blocks, D] float32
//   partial, and a second kernel adds the blocks in order.  No atomics: the
//   result repeats bit for bit.  All of it is skipped when the caller needs
//   no parameter gradient (the attack's frozen LayerNorms).

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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// 8 warps a block, one row at a time each; one block an SM (the grid is one
// wave of at most 132 blocks), so a thread may hold up to 255 registers
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
// The next row is loaded while this one reduces where s, gh and gs of a row
// fit in kMaxPrefetchWords 32-bit registers a lane (36 at D = 768 on a bf16
// stream, 72 on a float32 one); a wider row loads in its turn.  Two rows
// ahead on a bf16 stream measured slower than one, and none slower still
// (scripts/k2_bwd_variants.py).
constexpr int kMaxPrefetchWords = 72;

// How a chunk of kVec stream values loads, converts to float32 and stores:
// one 16-byte vector (4 float32 or 8 bfloat16 values), or one value.
template <typename T, int kVec>
struct Chunk;

template <>
struct Chunk<float, 4> {
  using type = uint4;
  static __device__ __forceinline__ void unpack(type c, float* v) {
    v[0] = __uint_as_float(c.x);
    v[1] = __uint_as_float(c.y);
    v[2] = __uint_as_float(c.z);
    v[3] = __uint_as_float(c.w);
  }
  static __device__ __forceinline__ type pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// two bf16 values in a 32-bit word, the lower column in the low half;
// a bf16 value is the top half of the float32 with its bits
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <>
struct Chunk<__nv_bfloat16, 8> {
  using type = uint4;
  static __device__ __forceinline__ void unpack(type c, float* v) {
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ type pack(const float* v) {
    return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                      pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
};

template <>
struct Chunk<float, 1> {
  using type = float;
  static __device__ __forceinline__ void unpack(type c, float* v) { v[0] = c; }
  static __device__ __forceinline__ type pack(const float* v) { return v[0]; }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using type = unsigned short;
  static __device__ __forceinline__ void unpack(type c, float* v) {
    v[0] = __uint_as_float((unsigned)c << 16);
  }
  static __device__ __forceinline__ type pack(const float* v) {
    return __bfloat16_as_ushort(__float2bfloat16(v[0]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two sums over the warp in one shuffle tree.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// One warp a row.  A row is d / kVec chunks; lane l holds chunks l, l + 32,
// ..., kNV of them (columns past d masked).  Warp w of the grid takes rows
// [w * rows_per_warp, (w + 1) * rows_per_warp).  With kParams each block
// writes part[0][blockIdx.x] (dgamma) and part[1][blockIdx.x] (dbeta), the
// sums over its rows; part is [2, gridDim.x, d].
template <typename T, int kVec, int kNV, bool kParams>
__global__ void __launch_bounds__(kBwdThreads, 1)
    residual_ln_bwd_kernel(const T* __restrict__ s, const T* __restrict__ gs,
                           const T* __restrict__ gh,
                           const float* __restrict__ gamma, T* __restrict__ dx,
                           float* __restrict__ part, int rows, int d,
                           int rows_per_warp, float eps) {
  using Ch = Chunk<T, kVec>;
  using C = typename Ch::type;
  constexpr int kV = kVec * kNV;  // values a lane
  // a row's s, gh and gs in 32-bit registers a lane, and the rows (0 or 1)
  // loaded ahead of the one being reduced
  constexpr int kWords = 3 * kNV * (((int)sizeof(C) + 3) / 4);
  constexpr int kAhead = kWords <= kMaxPrefetchWords ? 1 : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = d / kVec;  // chunks a row
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + warp) * rows_per_warp;
  const int r1 = min(r0 + rows_per_warp, rows);
  const C* s_c = reinterpret_cast<const C*>(s);
  const C* gs_c = reinterpret_cast<const C*>(gs);
  const C* gh_c = reinterpret_cast<const C*>(gh);
  C* dx_c = reinterpret_cast<C*>(dx);

  bool ok[kNV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) ok[k] = lane + 32 * k < nc;
  // gamma of the lane's columns: in registers, or, where the parameter
  // sums take those registers, read from L1 at each use
  float gam[kParams ? 1 : kV];
  if constexpr (!kParams) {
#pragma unroll
    for (int k = 0; k < kNV; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        gam[k * kVec + e] = ok[k] ? __ldg(gamma + (lane + 32 * k) * kVec + e) : 0.f;
  }
  float acc_g[kParams ? kV : 1], acc_b[kParams ? kV : 1];
#pragma unroll
  for (int i = 0; i < (kParams ? kV : 1); ++i) acc_g[i] = acc_b[i] = 0.f;

  // s, gh and gs of one row; streamed (read once), so loaded evict-first
  auto load_row = [&](int row, C* vs, C* vg, C* vp) {
    const size_t base = (size_t)row * nc;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (ok[k]) {
        const size_t i = base + lane + 32 * k;
        vs[k] = __ldcs(s_c + i);
        vg[k] = __ldcs(gh_c + i);
        if (gs != nullptr) vp[k] = __ldcs(gs_c + i);
      }
    }
  };

  // slot 0 holds the row being reduced, slot a the row a ahead of it
  C bs[kAhead + 1][kNV], bg[kAhead + 1][kNV], bp[kAhead + 1][kNV];
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    if (r0 + a < r1) load_row(r0 + a, bs[a], bg[a], bp[a]);
  for (int row = r0; row < r1; ++row) {
    // in flight while this row reduces
    if (row + kAhead < r1) load_row(row + kAhead, bs[kAhead], bg[kAhead], bp[kAhead]);
    float x[kV], g[kV];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (ok[k]) {
        Ch::unpack(bs[0][k], x + k * kVec);
        Ch::unpack(bg[0][k], g + k * kVec);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += x[k * kVec + e];
      }
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (ok[k]) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float t = x[k * kVec + e] - mean;
          sq += t * t;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (ok[k]) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int i = k * kVec + e;
          x[i] = (x[i] - mean) * rstd;  // xhat from here on
          if constexpr (kParams) {
            acc_g[i] += g[i] * x[i];
            acc_b[i] += g[i];
            g[i] *= __ldg(gamma + (lane + 32 * k) * kVec + e);  // dxhat from here on
          } else {
            g[i] *= gam[i];
          }
          s1 += g[i];
          s2 += g[i] * x[i];
        }
      }
    }
    warp_sum2(s1, s2);
    const float c1 = s1 / d, c2 = s2 / d;
    const size_t base = (size_t)row * nc;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (ok[k]) {
        float out[kVec];
        if (gs != nullptr) {
          Ch::unpack(bp[0][k], out);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) out[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int i = k * kVec + e;
          out[e] = out[e] + rstd * (g[i] - c1 - x[i] * c2);
        }
        dx_c[base + lane + 32 * k] = Ch::pack(out);
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        bs[a][k] = bs[a + 1][k];
        bg[a][k] = bg[a + 1][k];
        bp[a][k] = bp[a + 1][k];
      }
    }
  }

  if constexpr (kParams) {
    // the block's warps added in warp order, one group of 32 chunks (the
    // columns of one k) at a time
    __shared__ float red[kBwdWarps][2][32 * kVec];
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (32 * k >= nc) break;  // the same for the whole block
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        red[warp][0][lane * kVec + e] = acc_g[k * kVec + e];
        red[warp][1][lane * kVec + e] = acc_b[k * kVec + e];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * 32 * kVec; i += blockDim.x) {
        const int which = i / (32 * kVec), at = i % (32 * kVec);
        const int col = 32 * k * kVec + at;
        float t = 0.f;
        for (int w = 0; w < n_warps; ++w) t += red[w][which][at];
        if (col < d) part[((size_t)which * gridDim.x + blockIdx.x) * d + col] = t;
      }
      __syncthreads();
    }
  }
}

// out[y, c] = sum over b of part[y, b, c] in a fixed order: thread row r
// of a block of 32 x 8 threads adds b = r, r + 8, ... in turn, and then the
// 8 sums are added in the order of r.
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n_row_blocks,
                                  int d) {
  __shared__ float red[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + (size_t)blockIdx.y * n_row_blocks * d;
  float acc = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = threadIdx.y; b < n_row_blocks; b += 8) acc += p[(size_t)b * d + c];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += red[r][threadIdx.x];
    out[(size_t)blockIdx.y * d + c] = t;
  }
}

struct BwdArgs {
  const void *s, *gs, *gh, *gamma;
  void* dx;
  float* part;
  int rows, d, rows_per_warp;
  float eps;
};

template <typename T, int kVec, int kNV>
void launch_bwd(const BwdArgs& a, int blocks, int threads, cudaStream_t st) {
  const T* s = (const T*)a.s;
  const T* gs = (const T*)a.gs;
  const T* gh = (const T*)a.gh;
  const float* gamma = (const float*)a.gamma;
  if (a.part != nullptr) {
    residual_ln_bwd_kernel<T, kVec, kNV, true><<<blocks, threads, 0, st>>>(
        s, gs, gh, gamma, (T*)a.dx, a.part, a.rows, a.d, a.rows_per_warp, a.eps);
  } else {
    residual_ln_bwd_kernel<T, kVec, kNV, false><<<blocks, threads, 0, st>>>(
        s, gs, gh, gamma, (T*)a.dx, nullptr, a.rows, a.d, a.rows_per_warp, a.eps);
  }
}

// The instance whose kNV (chunks a lane) is the least that holds the row:
// 16-byte chunks of float32 (kVec 4, D <= 1024: up to 8) or of bf16 (kVec 8:
// up to 4), or single values (kVec 1: 8, 16 or 32 a lane).
template <typename T, int kVec>
void dispatch_bwd(const BwdArgs& a, int blocks, int threads, cudaStream_t st) {
  const int nv = (a.d / kVec + 31) / 32;
  if constexpr (kVec == 1) {
    if (nv <= 8) return launch_bwd<T, 1, 8>(a, blocks, threads, st);
    if (nv <= 16) return launch_bwd<T, 1, 16>(a, blocks, threads, st);
    return launch_bwd<T, 1, 32>(a, blocks, threads, st);
  } else {
    if (nv <= 1) return launch_bwd<T, kVec, 1>(a, blocks, threads, st);
    if (nv <= 2) return launch_bwd<T, kVec, 2>(a, blocks, threads, st);
    if (nv <= 3) return launch_bwd<T, kVec, 3>(a, blocks, threads, st);
    if constexpr (kVec == 4) {
      if (nv <= 4) return launch_bwd<T, kVec, 4>(a, blocks, threads, st);
      if (nv <= 6) return launch_bwd<T, kVec, 6>(a, blocks, threads, st);
      return launch_bwd<T, kVec, 8>(a, blocks, threads, st);
    } else {
      return launch_bwd<T, kVec, 4>(a, blocks, threads, st);
    }
  }
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

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 for the 16-byte instance (D a
// whole number of 16-byte vectors; s, gs, gh and dx on 16-byte boundaries),
// 0 for the scalar one.  gs may be null (no gradient reached s).  part and
// dgdb may be null (no parameter gradient wanted); otherwise part is
// [2, n_blocks, d] and dgdb is [2, d] float32 scratch and output, with
// n_blocks = ceil(ceil(rows / rows_per_warp) / warps_per_block).
extern "C" int vq_residual_layernorm_bwd(int dtype, int vec, const void* s,
                                         const void* gs, const void* gh,
                                         const void* gamma, void* dx,
                                         void* part, void* dgdb, int rows,
                                         int d, int rows_per_warp,
                                         int warps_per_block, float eps,
                                         void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kThreads * kMaxPerThread || rows_per_warp <= 0 ||
      warps_per_block <= 0 || warps_per_block > kBwdWarps)
    return (int)cudaErrorInvalidValue;
  if ((part == nullptr) != (dgdb == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (vec) {
    const int per_vec = dtype == 0 ? 4 : 8;
    const uintptr_t addr =
        (uintptr_t)s | (uintptr_t)gs | (uintptr_t)gh | (uintptr_t)dx;
    if (d % per_vec != 0 || addr % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const int blocks = (warps + warps_per_block - 1) / warps_per_block;
  const int threads = 32 * warps_per_block;
  const BwdArgs a{s, gs, gh, gamma, dx, (float*)part, rows, d, rows_per_warp, eps};
  if (dtype == 0) {
    if (vec)
      dispatch_bwd<float, 4>(a, blocks, threads, st);
    else
      dispatch_bwd<float, 1>(a, blocks, threads, st);
  } else {
    if (vec)
      dispatch_bwd<__nv_bfloat16, 8>(a, blocks, threads, st);
    else
      dispatch_bwd<__nv_bfloat16, 1>(a, blocks, threads, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  column_sum_kernel<<<dim3((d + 31) / 32, 2), dim3(32, 8), 0, st>>>(
      (const float*)part, (float*)dgdb, blocks, d);
  return (int)cudaGetLastError();
}
