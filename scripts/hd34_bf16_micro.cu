// Micro-kernels for K3-bf16 at head dim 34 (scripts/hd34_bf16_micro.py):
// the folded map's 64-column bf16 box in the 128-byte swizzle from column
// 34 h - (2 h mod 8), and wgmma m64nNk16 bf16 with its B operand read
// MN-major from a 128-byte-swizzled tile at N = 40, 48 and 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
}

// The 64 x 64 box at (34 h - shift, 0, 0) into swizzled shared memory, read
// back unswizzled into out [64, 64].
__global__ void box_kernel(const __grid_constant__ CUtensorMap map, __nv_bfloat16* out, int h) {
  const uint32_t base = smem_base(), bar = base + 8192;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8192;\n" ::"r"(bar)
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(base),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(34 * h - ((2 * h) & 7)), "r"(0),
        "r"(0)
        : "memory");
  }
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar) : "memory");
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
    const int r = i / 64, c = i % 64;
    unsigned short v;
    asm volatile("ld.shared.u16 %0, [%1];\n"
                 : "=h"(v) : "r"(base + r * 128 + (((c / 8) ^ (r % 8)) << 4) + 2 * (c % 8)));
    out[i] = __ushort_as_bfloat16(v);
  }
}

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
              "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int N>
struct W;
template <>
struct W<40> {
  static __device__ void run(float (&d)[20], const uint32_t (&a)[4], uint64_t x) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
        : F8(0), F8(8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(0));
  }
};
template <>
struct W<48> {
  static __device__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t x) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(0));
  }
};
template <>
struct W<64> {
  static __device__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t x) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(0));
  }
};

// One warpgroup: out (64 x N) = A (64 x 16, row-major) X (16 x 64, row-major,
// stored as 16 rows of 128 bytes in the 128-byte swizzle and read MN-major).
template <int N>
__global__ void mn_kernel(const __nv_bfloat16* a, const __nv_bfloat16* x, float* out) {
  const uint32_t base = smem_base();
  const int tid = threadIdx.x;
  for (int i = tid; i < 16 * 64; i += 128) {
    const int r = i / 64, c = i % 64;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(base + r * 128 + (((c / 8) ^ (r % 8)) << 4) +
                                                   2 * (c % 8)),
                 "h"(__bfloat16_as_ushort(x[i]))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  uint32_t af[4];
  for (int r = 0; r < 4; ++r) {
    const int row = 16 * w + g + 8 * (r & 1), col = 2 * t + 8 * (r >> 1);
    af[r] = (uint32_t)__bfloat16_as_ushort(a[row * 16 + col]) |
            ((uint32_t)__bfloat16_as_ushort(a[row * 16 + col + 1]) << 16);
  }
  const uint64_t desc =
      (uint64_t)((base & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  W<N>::run(d, af, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
    out[row * N + col] = d[i];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

}  // namespace

// x [B, S, row] bf16 with H heads of 34 in each row of ``row`` elements.
extern "C" int micro_box(const void* x, void* out, int B, int S, int H, int row, int h) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
      cudaSuccess)
    return -1;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)H * 34, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)row * 2, (cuuint64_t)S * row * 2};
  const cuuint32_t box[3] = {64u, 64u, 1u}, unit[3] = {1u, 1u, 1u};
  const CUresult r = reinterpret_cast<EncodeTiled>(ptr)(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -1000 - (int)r;
  cudaFuncSetAttribute(box_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 12288);
  box_kernel<<<1, 128, 12288>>>(map, (__nv_bfloat16*)out, h);
  return (int)cudaGetLastError();
}

extern "C" int micro_mn(const void* a, const void* x, float* out, int n) {
  const auto* A = (const __nv_bfloat16*)a;
  const auto* X = (const __nv_bfloat16*)x;
  if (n == 40) {
    cudaFuncSetAttribute(mn_kernel<40>, cudaFuncAttributeMaxDynamicSharedMemorySize, 8192);
    mn_kernel<40><<<1, 128, 8192>>>(A, X, out);
  } else if (n == 48) {
    cudaFuncSetAttribute(mn_kernel<48>, cudaFuncAttributeMaxDynamicSharedMemorySize, 8192);
    mn_kernel<48><<<1, 128, 8192>>>(A, X, out);
  } else {
    cudaFuncSetAttribute(mn_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, 8192);
    mn_kernel<64><<<1, 128, 8192>>>(A, X, out);
  }
  return (int)cudaGetLastError();
}
