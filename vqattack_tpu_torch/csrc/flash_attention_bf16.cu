// Flash attention, forward and backward, bfloat16 q/k/v, head dim 64 or 34,
// on Hopper's warpgroup tensor-core instructions (wgmma) with tiles brought
// in by the Tensor Memory Accelerator (TMA): one bf16 pass a product,
// float32 accumulation.
//
// Replaces the TPU kernel behind vqattack_tpu/ops/attention.py::flash_attention
// when the surrogate trunk computes in bfloat16 (--dtype bfloat16): the JAX
// wrapper hands the library kernel (jax.experimental.pallas.ops.tpu.
// flash_attention: forward, dq and dkv pallas_calls) bf16 q/k/v and a float32
// bias, and the library multiplies bf16 operands with float32 accumulation.
// This kernel computes the same function, rounding where the library rounds:
//
//   forward   S = Q K^T * scale + (bias + key_bias)  (float32 from bf16 Q, K),
//             O = bf16( (bf16(P~) V) / l )
//             with P~ = exp(S - running max m), l its float32 row sum
//             (m and log l saved for the backward)
//   backward  D_i = sum_d dO_id O_id  (float32 from bf16 dO, O),
//             P = exp((S - m) - log l),  dV = bf16(P)^T dO,  dP = dO V^T,
//             dS = P o (dP - D),  dQ = scale * bf16(dS) K,
//             dK = scale * bf16(dS)^T Q
//
// (P cast before P V and P^T dO, dS before dS K and dS^T Q, as the library's
// forward, dkv and dq kernels cast them; scale is 1/8 for head dim 64, a
// power of two, so scaling dS before or after its rounding gives the same
// bits.  The two terms are summed before they join the scores, as the JAX
// caller sums them into its one bias.)  O, dQ, dK, dV come back bf16, m
// and log l float32.  The layout contract: q/k/v through their [B, S, H, D]
// element strides (multiples of 8, rows on 16 bytes: the wrapper checks; at
// head dim 34 packed heads, below), dQ/dK/dV contiguous [B, S, H, D], O and
// dO [B, Sq, H, D] in rows of H * D rounded up to 8 elements (16 bytes),
// m and log l [2, B, H, Sq], D [B, H, Sq], the bias through broadcast
// strides and the key bias ([1|B, Sk]) as a vector, both float32 and both
// optional; ragged lengths masked inside; scale > 0.
//
// Bound on the H100: operations.  At ALBEF's batched chunk [8, 901, 12, 64]
// the forward needs 4 B*H*S^2*Dh = 20.0 GFLOP, 20 us at the dense bf16 rate
// (989 TFLOP/s), against 44 MB of bf16 q, k, v and o (13 us at 3.35 TB/s);
// the backward, recomputing P, 10x (49.9 GFLOP, 50 us).
//
// Head dim 34 (VLMo-base+: 544 over 16 heads; the instances' kDh = 34).  A
// head of a [B, S, 544] projection starts 68 bytes after the last, off the
// 16-byte strides a TMA map takes, so the heads are folded into the
// columns: one 3-D map (H * 34, S, B) over the tensor's own row and batch
// strides, read in place (the wrapper copies a tensor whose heads are not
// packed, or whose rows or base are off 16 bytes:
// ops/attention.py::fits_folded_box).  A head's rows come as the same
// 64-column, 128-byte-swizzled box as at head dim 64, so the tiles, the
// swizzle, the ldmatrix reads and the descriptors are unchanged; but a box
// must start on 16 bytes (TMA traps otherwise), and 68 h bytes is 4 h mod 16
// off it, so head h's box starts at column 34 h - shift(h), shift(h) = 2 h
// mod 8, and the head is box columns shift .. shift + 33 (at most 39): the
// columns around it are the neighbours', or past column H * 34 (the last
// head's box) TMA's zeros.  Then:
// - every product over the head dim (S = Q K^T; dP = dO V^T; S^T = K Q^T,
//   dP^T = V dO^T) has as its register A operand one that a warpgroup
//   holds for the whole walk (Q; Q and dO; K and V): those fragments are
//   zeroed outside [shift, shift + 34) once a tile, after their ldmatrix,
//   so the neighbours' columns in the B tiles add nothing (their values
//   must be finite: 0 x inf is NaN) and K, V, Q and dO in shared memory
//   need no zeroing.  Such a product takes 3 k16 steps (columns 0-47), not
//   4.  D = rowsum(dO o O) comes from the zeroed dO fragments, so is exact;
// - the products whose output is the head dim (P V, dS K, P^T dO, dS^T Q)
//   run at wgmma N = 40 over box columns 0-39 (the MN-major 128-byte
//   swizzle takes it: a row of B is read in 16-byte chunks), their
//   accumulators 20 floats a thread, not 32; the neighbours' columns land
//   in accumulator columns that are never stored;
// - a store writes accumulator column j to column 34 h + j - shift, only
//   for j in [shift, shift + 34): shift is even, so the bf16x2 stores stay
//   on 4 bytes.
// So the products execute 48 (over the head dim) or 40 columns where the
// bound counts 34, and no pad copy precedes them.

// Design (what held the mma.sync version back, and the answer to each):
// - tensor-core instructions: every product is wgmma.mma_async m64nNk16
//   bf16 -> f32, issued by a warpgroup (4 warps, 64 rows), its A operand in
//   registers and its B operand read from shared memory through a
//   descriptor.  The operand a warpgroup keeps for the whole walk (Q in the
//   forward; K and V in dK/dV; Q and dO in dQ) is read once from its TMA
//   tile by ldmatrix; P and dS are packed from the float32 accumulator by
//   cvt.rn.bf16x2.f32 (the wgmma accumulator and register-A layouts are,
//   warp by warp, those of mma.m16n8k16).  B is read K-major for the
//   products over the head dim (K, Q, V, dO tiles) and transposed (MN-major)
//   for the products over keys or queries (V, dO, Q, K), which bf16 allows;
// - block size and latency hiding: a block is three warpgroups, two that
//   compute (64 rows each: a 128-row query tile in the forward and dQ, a
//   128-row key tile in dK/dV) and one that loads; setmaxnreg moves
//   registers from the loader (40) to the two computing ones (232).  One
//   block an SM (384 threads at 168 registers at launch; 113 KB of shared
//   memory in the forward and dQ, 99 KB in dK/dV), in a persistent
//   grid: block i walks tiles i, i + 132, ... (head-major, the batch
//   inside), and the loader fetches a tile's fixed operands (Q; K and V; Q,
//   dO and O) as soon as the computing warpgroups hold the last tile's in
//   registers, so that a tile's start (the first tiles' TMA latency)
//   overlaps the previous tile's end.  At [8, 901, 12, 64] each kernel
//   walks 8 x 96 = 768 tiles, 6 on 108 blocks and 5 on 24.  Each
//   warpgroup issues the next products before it waits for the last ones
//   (forward: S_j with P_{j-1} V_{j-1}; dK/dV: dV while dS is computed, dK
//   across steps; dQ: dQ across steps), and the two warpgroups take turns
//   to issue (named barriers), so that one's softmax (exp on the
//   multi-function units) runs under the other's products;
// - a copy warp: one warp of the loading warpgroup keeps TMA loads of the
//   streamed tiles (K/V in the forward and dQ, Q/dO in dK/dV) in flight
//   through a ring of 3 (forward, 32 KB) or 4 (backward, 16 KB) stages, each
//   with a "full" mbarrier (the TMA's bytes) and an "empty" one (every
//   computing thread arrives when its wgmmas have read the stage); in dK/dV
//   it also stages each query tile's L and D in shared memory.  No thread
//   that multiplies issues a copy;
// - layout: tiles of 64-element (128-byte) rows in the 128-byte swizzle that
//   both TMA and the wgmma descriptors take (8-row groups 1024 bytes apart);
//   the TMA maps are 4-D (64, S, H, B) over the tensors' own strides with
//   64-row boxes, so rows past Sq or Sk of each (batch, head) arrive as
//   zeros, and scores of keys past Sk are masked to -inf;
// - ragged lengths: the forward walks 128-key tiles, the ragged one first
//   (128, 64 or 16 wide: 901 = 7 x 128 + 5 takes a 16-wide tile, 941 = 7 x
//   128 + 45 a 64-wide one), so that only its step masks; dQ walks 64-key
//   and dK/dV 64-query tiles, the last 64 or 16 wide.  Both warpgroups walk
//   every tile: rows past Sq (Sk) are computed from the zeros TMA fills in
//   and are not written.  A row whose first key tile is all -inf
//   exponentiates against 0;
// - the two terms: read from device memory (L2) into registers, in the
//   forward and dQ before the tile's full barrier is waited on, so that the
//   loads overlap the wait and the other warpgroup's products (in dK/dV,
//   whose registers are fuller, once S^T is done); the tiles are numbered
//   head-major with the batch inside, so one head's slice of a [1, H, S, S]
//   table is reused from L2 by the batch;
// - backward, deterministic: dQ over query tiles (S, dP; it also computes D
//   = rowsum(dO o O) from its O tile and writes it), then dK/dV over key
//   tiles (S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out as its A
//   operands), no atomics: every sum runs in a fixed order, so the result
//   is the same bit for bit on every run.  dQ recomputes S and dP: 7
//   products where the bound counts 5 (14 units of B*H*S^2*Dh against 10).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                         // columns of a tile: one 128-byte row
constexpr int kBox = 64;                       // rows of a TMA box and of a warpgroup
constexpr uint32_t kBoxBytes = kBox * kD * 2;  // 8 KB
constexpr int kThreads = 3 * 128;              // two computing warpgroups and a loader
constexpr int kFwdStages = 3;                  // the forward's ring (32 KB a stage)
constexpr int kBwdStages = 4;                  // the backward's rings (16 KB a stage)
constexpr float kLog2e = 1.4426950408889634f;

// What an instance of head dim kDh (64, or 34 through the folded map)
// executes: kSteps 16-deep steps in a product over the head dim, and kN
// columns (kAcc floats a thread) in a product whose output is the head dim.
template <int kDh>
struct Head {
  static_assert(kDh == 64 || kDh == 34, "the kernels take head dims 64 and 34");
  static constexpr int kSteps = kDh == 64 ? 4 : 3;
  static constexpr int kN = kDh == 64 ? 64 : 40;
  static constexpr int kAcc = kN / 2;
};

// The box column at which head h starts: at head dim 34 its box starts
// 2 h mod 8 columns early, on 16 bytes; 0 at head dim 64.
template <int kDh>
__device__ __forceinline__ int head_shift(int h) {
  return kDh == 34 ? (2 * h) & 7 : 0;
}

// The elements from one row of O (and dO) to the next: H heads of D,
// rounded up to 8 (16 bytes, a TMA stride).
__host__ __device__ __forceinline__ long long o_row(int H, int D) {
  return ((long long)H * D + 7) / 8 * 8;
}

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;      // nullptr: no bias
  const float* key_bias;  // nullptr: no key bias; [1|B, Sk]
  const bf16* o;          // backward: forward output, [B, Sq, H, D] in rows of o_row
  const float* lse;       // backward: the forward's out_lse
  const bf16* dout;       // backward: as o
  bf16* out;              // forward: O (as o); backward: dQ (contiguous [B, Sq, H, D])
  float* out_lse;         // forward: m, then log l ([2, B, H, Sq])
  bf16* dk;               // contiguous [B, Sk, H, D]
  bf16* dv;               // contiguous [B, Sk, H, D]
  float* delta;           // backward: D [B, H, Sq]
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long bsb, bsh, bsq, bsk;
  long long kbsb;  // the key bias's batch stride (0: broadcast)
  int B, H, Sq, Sk;
  float scale;
};

// TMA maps of the [B, S, H, D] tensors the tiles come from, passed to the
// kernels by value (__grid_constant__), where TMA reads them: (64, S, H, B)
// at head dim 64, (H * 34, S, B) at 34.
struct Maps {
  CUtensorMap q, k, v, o, dout;
};

// ---------------------------------------------------------------------------
// barriers, TMA and shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also adds ``bytes`` of TMA transfers to the phase.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity ``parity`` has completed.  A phase that
// has not completed after four seconds (a copy that never arrives) stops
// the kernel with a trap, which the next CUDA call reports, instead of
// holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (++tries % 1024 == 0) {
      if (t0 == 0) {
        t0 = now_ns();
      } else if (now_ns() - t0 > 4000000000ull) {
        __trap();
      }
    }
  }
}

// Rows [row, row + 64) of (batch b, head h) into a 128-byte-swizzled 8 KB
// tile at ``dst``: from a (64, S, H, B) map at head dim 64, from an (H *
// 34, S, B) map at 34 the box of 64 columns from column 34 h - shift(h);
// rows past S, and columns past H * 34, arrive as zeros.  The bytes count
// toward ``bar``'s phase.
template <int kDh>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int h, int b) {
  if constexpr (kDh == 64) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(h), "r"(b)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(kDh * h - head_shift<kDh>(h)),
        "r"(row), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// The loader's ring of kS stages: tile j sits in stage j % kS, whose "full"
// barrier completes its (j / kS)-th phase when the tile has arrived and
// whose "empty" barrier completes it when every computing thread is done
// with it.
template <int kS>
struct Ring {
  uint32_t full0, empty0;
  __device__ __forceinline__ uint32_t full(int j) const { return full0 + 8 * (j % kS); }
  __device__ __forceinline__ uint32_t empty(int j) const { return empty0 + 8 * (j % kS); }
  __device__ __forceinline__ void wait_full(int j) const { bar_wait(full(j), (j / kS) & 1); }
  // the loader's wait before it reloads tile j's stage
  __device__ __forceinline__ void wait_empty(int j) const {
    if (j >= kS) bar_wait(empty(j), ((j / kS) - 1) & 1);
  }
  __device__ __forceinline__ void init(uint32_t full_count, uint32_t empty_count) const {
    for (int s = 0; s < kS; ++s) {
      bar_init(full(s), full_count);
      bar_init(empty(s), empty_count);
    }
  }
};

// Shared memory: ``n_tiles`` 8 KB tiles from a 1024-byte boundary, then
// ``extra`` bytes and the barriers (two for a tile's fixed operands, two a
// stage); the launch asks for 1 KB more to align.
constexpr size_t smem_bytes(int n_tiles, int extra, int stages) {
  return 1024 + (size_t)n_tiles * kBoxBytes + extra + 8 * (2 * stages + 2);
}

__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return (smem_u32(smem_raw) + 1023) & ~1023u;
}

__device__ __forceinline__ void loader_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void compute_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
//
// The accumulator of an m64nN product: thread t of the warpgroup (warp w =
// t / 32, g = lane / 4, c = lane % 4) holds d[i], i < N / 2, at row 16 w + g
// + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 c + i % 2.  The register A
// operand of a 16-deep step holds, in four registers of two bf16 (the lower
// column low), rows 16 w + g and + 8 at depth 2 c, 2 c + 1 and 2 c + 8, 2 c
// + 9: the accumulator's columns 16 kk .. 16 kk + 15 packed in order.
// ---------------------------------------------------------------------------

// Descriptor of a tile of 128-byte rows in the 128-byte swizzle (layout type
// 1), whose 8-row groups lie 1024 bytes apart (stride byte offset 64 x 16).
// Read K-major (depth along a row: a 16-deep step is 32 bytes further) or
// MN-major (depth down the rows: a step is 16 rows, 2048 bytes, further;
// the 64 columns are one swizzle atom wide, so the leading offset is unused).
// Every tile starts on 1024 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most ``kPending`` of the committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Registers that an asynchronous wgmma reads or writes: touch them only
// after the wg_wait that completes it, and keep them live until then.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The first M elements of a register array, as an array of M.
template <int M, int N>
__device__ __forceinline__ float (&head(float (&a)[N]))[M] {
  static_assert(M <= N, "head longer than the array");
  return *reinterpret_cast<float(*)[M]>(&a[0]);
}

#define VQ_F8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (=|+=) A X, A a 64 x 16 bf16 register operand and X a 16 x N slice of
// shared memory, read MN-major (``kTrans`` 1: X stored [depth][N]) or K-major
// (``kTrans`` 0: X stored [N][depth]); ``acc`` 0 overwrites d.
template <int N, int kTrans>
struct Rs;

template <int kTrans>
struct Rs<128, kTrans> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : VQ_F8(0), VQ_F8(8), VQ_F8(16), VQ_F8(24), VQ_F8(32), VQ_F8(40), VQ_F8(48), VQ_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc), "n"(kTrans));
  }
};

template <int kTrans>
struct Rs<64, kTrans> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : VQ_F8(0), VQ_F8(8), VQ_F8(16), VQ_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc), "n"(kTrans));
  }
};

template <int kTrans>
struct Rs<40, kTrans> {
  static __device__ __forceinline__ void run(float (&d)[20], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
        : VQ_F8(0), VQ_F8(8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc), "n"(kTrans));
  }
};

template <int kTrans>
struct Rs<16, kTrans> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : VQ_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc), "n"(kTrans));
  }
};

#undef VQ_F8

// Issue d += C X as one group: C a 64 x N operand in registers (N deep, its
// first N / 16 steps), X the tile at ``x`` (its first N rows, MN-major), d
// the first kN columns (64, or 40 at head dim 34).
template <int N, int kN, int R>
__device__ __forceinline__ void issue_rs(float (&d)[kN / 2], const uint32_t (&c)[R][4],
                                         uint32_t x) {
  static_assert(N / 16 <= R, "operand too short");
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) Rs<kN, 1>::run(d, c[kk], desc(x + 2048 * kk), 1);
  wg_commit();
}

// Issue d = A B^T over the head dim as one group: A 64 rows held as
// register operands (``a``, kSteps 16-deep steps: 4 over the 64 columns, 3
// over columns 0-47 at head dim 34), B the tile at ``b`` (its first N
// rows, K-major).
template <int N, int kSteps>
__device__ __forceinline__ void issue_rs_k(float (&d)[N / 2], const uint32_t (&a)[kSteps][4],
                                           uint32_t b) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) Rs<N, 0>::run(d, a[kk], desc(b + 32 * kk), kk);
  wg_commit();
}

// The register A operand of this warp's 16 rows of a 64-row tile at ``tile``
// over its first kSteps 16-deep steps, by ldmatrix from the 128-byte
// swizzle: lanes 0-15 give rows 0-15 at the step's first 8 columns, lanes
// 16-31 at its second 8; 16-byte chunk k of row r sits at chunk k ^ (r % 8).
template <int kSteps>
__device__ __forceinline__ void load_a(uint32_t (&a)[kSteps][4], uint32_t tile) {
  const int lane = threadIdx.x & 31, row = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t addr = tile + row * 128 + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

// load_a, and at head dim 34 the columns outside the head's [shift, shift +
// 34) set to 0: register r of step kk holds the pair of columns 16 kk + 8 (r
// / 2) + 2 (lane % 4) and + 1, both in the head or both out (shift is even).
template <int kDh>
__device__ __forceinline__ void load_head(uint32_t (&a)[Head<kDh>::kSteps][4], uint32_t tile,
                                          int shift) {
  load_a(a, tile);
  if constexpr (kDh == 34) {
    const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int kk = 0; kk < Head<kDh>::kSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = 16 * kk + 8 * (r >> 1) + c2;
        if (col < shift || col >= shift + kDh) a[kk][r] = 0u;
      }
  }
}

// Two floats rounded to bf16 (to nearest even), ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// The register A operand of a 64 x N float32 accumulator, rounded to bf16.
template <int N, int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[R][4], const float (&c)[N / 2]) {
  static_assert(N / 16 <= R, "operand too short");
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// 2^x in one instruction (denormal results flush to 0, a weight that does
// not count next to the row's largest, which is 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// scores
//
// A thread's elements of a 64 x N accumulator tile: d[i] at row r + 8 ((i /
// 2) % 2) and column c + 8 (i / 4) + i % 2, with r the warp's first row + g
// and c the tile's first column + 2 (lane % 4).  Rows are queries and columns
// keys, or the other way round (``kKeyRows``, dK/dV).
// ---------------------------------------------------------------------------

// bias + key_bias at this thread's elements.  Rows are clamped (rows past Sq
// or Sk are never written), and with ``kClamp`` columns too (the ragged
// tile, whose columns past Sq or Sk are masked), so that every read is in
// bounds.
template <int N, bool kBias, bool kKeyBias, bool kKeyRows, bool kClamp>
__device__ __forceinline__ void load_terms(float (&t)[N / 2], const Params& p,
                                           const float* bias_bh, const float* kbb, int r, int c) {
  const float* row_ptr[2];
  float row_kb[2] = {0.f, 0.f};
  const long long col_stride = kKeyRows ? p.bsq : p.bsk;
  const int n_cols = kKeyRows ? p.Sq : p.Sk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(r + 8 * h, (kKeyRows ? p.Sk : p.Sq) - 1);
    row_ptr[h] = kBias ? bias_bh + row * (kKeyRows ? p.bsk : p.bsq) : nullptr;
    if (kKeyBias && kKeyRows) row_kb[h] = __ldg(kbb + row);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    int col = c + 8 * (i >> 2) + (i & 1);
    if (kClamp) col = min(col, n_cols - 1);
    float x = kBias ? __ldg(row_ptr[(i >> 1) & 1] + col * col_stride) : 0.f;
    if (kKeyBias) x += kKeyRows ? row_kb[(i >> 1) & 1] : __ldg(kbb + col);
    t[i] = x;
  }
}

// s = s * scale + t (with ``kTerms``), and -inf in the columns at or past
// ``n_valid`` (with ``kMask``).
template <int N, bool kTerms, bool kMask>
__device__ __forceinline__ void prep(float (&s)[N / 2], const float (&t)[N / 2], float scale,
                                     int c, int n_valid) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float x = s[i] * scale;
    if (kTerms) x += t[i];
    if (kMask && c + 8 * (i >> 2) + (i & 1) >= n_valid) x = -INFINITY;
    s[i] = x;
  }
}

// Store rows r and r + 8 of a 64 x kN accumulator tile (this thread's part)
// times ``mul0`` / ``mul1``, as bf16, to a [B, S, H, kDh] tensor (``base``
// at row 0 of this batch and head, ``row_stride`` elements a row):
// accumulator column j to column j - shift, for j in [shift, shift + kDh)
// (every column at head dim 64); rows at or past ``nrows`` are not written.
template <int kDh>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int r, int nrows,
                                           const float (&acc)[Head<kDh>::kAcc], float mul0,
                                           float mul1, int c, int shift) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r + 8 * i;
    if (rr >= nrows) continue;
    const float mul = i == 0 ? mul0 : mul1;
    bf16* dst = base + rr * row_stride - shift;
#pragma unroll
    for (int j = 0; j < Head<kDh>::kN / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (kDh == 64 || (col >= shift && col < shift + kDh))
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

// The width of the last tile of a walk over ``n`` rows in tiles of ``w``:
// 16, 64 or w, whichever is the narrowest that holds what is left.
__device__ __forceinline__ int last_width(int n, int w) {
  const int left = n - (n - 1) / w * w;
  return left > 64 ? w : left > 16 ? 64 : 16;
}

// The two computing warpgroups of a block take turns to issue their products
// (named barriers 1 and 2), so that one's softmax runs on the multi-function
// and floating-point units while the other's products run on the tensor
// cores.  Every step of a warpgroup issues its products between wait() and
// pass(); warpgroup 0 goes first.
struct Turns {
  int wg;
  __device__ __forceinline__ void wait() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  }
  __device__ __forceinline__ void pass() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  }
  __device__ __forceinline__ void start() const {
    if (wg == 1) pass();
  }
  // warpgroup 0 takes warpgroup 1's last pass, so that both barriers end
  // with every arrival matched
  __device__ __forceinline__ void finish() const {
    if (wg == 0) wait();
  }
};

// The work of a kernel: 128-row tiles of ``n_rows`` rows (queries, or keys in
// dK/dV) of every (batch, head), numbered head-major with the batch inside
// and the tiles innermost.  The grid is persistent, one block an SM: block i
// takes tiles i, i + gridDim.x, ..., so that the blocks running together
// share heads, and the loader fetches a tile's fixed operands while the
// previous tile is still computing.
struct Work {
  int row0, b, h;
  __device__ __forceinline__ Work(int t, int n_row_tiles, int B)
      : row0((t % n_row_tiles) * 128), b((t / n_row_tiles) % B), h(t / n_row_tiles / B) {}
};

// ---------------------------------------------------------------------------
// forward
//
// A warpgroup walks the key tiles with the ragged one first (masked, 16, 64
// or 128 wide), then the 128-key tiles in order.  In step j it issues S_j =
// Q K_j^T (Q held as register operands), then O += P_{j-1} V_{j-1}, and
// computes the softmax of S_j while the second product runs; O is rescaled
// once that product is done.
// ---------------------------------------------------------------------------

constexpr int kFwdTiles = 2 + 4 * kFwdStages;  // Q (128 rows); K and V (128 rows) a stage

template <int kAcc>
struct FwdRows {  // one warpgroup's running softmax state and output
  float o[kAcc];
  float m[2], l[2];  // l: this thread's part of the row sums
};

// Row maxima of S (raw, or already scaled: ``kScaled``), the new running
// maxima, alpha = exp(m_old - m_new), and S replaced by exp(S - m_new) with
// its row sums in ``rs``.  ``kTerms``: a bias or key bias was added, so a
// row's maximum may be near -1e9 (every key so far masked by a finite
// term): then S - m_new is formed first and scaled by log2 e after, as the
// float32 kernel does, since m_new log2 e, rounded, would be off by ~64.
// Without a term the maximum is a product's, and one fma of S with m_new
// log2 e is exact enough (and keeps the no-terms kernels' wgmmas unserialized:
// the two instructions cost them registers, ptxas's C7511).
template <int N, bool kScaled, bool kTerms>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m)[2],
                                               float (&alpha)[2], float (&rs)[2], float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ref[2], ref2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // scale > 0, so the maximum of the raw scores, scaled, is the maximum
    const float m_new = fmaxf(m[r], kScaled ? quad_max(mx[r]) : quad_max(mx[r]) * scale);
    // -inf while every key so far is masked (a -inf term): exponentiate
    // against 0 instead, so that alpha and every p come out 0, not NaN
    ref[r] = m_new == -INFINITY ? 0.f : m_new;
    ref2[r] = ref[r] * kLog2e;
    alpha[r] = exp2_approx((m[r] - ref[r]) * kLog2e);  // 0 on the first tile
    m[r] = m_new;
    rs[r] = 0.f;
  }
  const float mul = kScaled ? kLog2e : scale * kLog2e;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = kTerms ? exp2_approx((s[i] - ref[(i >> 1) & 1]) * kLog2e)
                  : exp2_approx(fmaf(s[i], mul, -ref2[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];  // 0 for a masked key
  }
}

// Step j of a warpgroup: S_j of key tile j's N keys at k0, issued with the
// previous tile's P V (``issue_prev``, none in step 0), through the softmax.
// Returns with P_j packed into ``pa`` and the state rescaled.
template <int N, bool kBias, bool kKeyBias, bool kMask, int kAcc, int kSteps,
          typename IssuePrev>
__device__ __forceinline__ void fwd_step(const Params& p, FwdRows<kAcc>& st, float (&s)[N / 2],
                                         uint32_t (&pa)[8][4], const uint32_t (&qa)[kSteps][4],
                                         uint32_t k_tile, const Ring<kFwdStages>& ring, const Turns& turns,
                                         int j, const float* bias_bh, const float* kbb, int row,
                                         int k0, int c, IssuePrev issue_prev, bool has_prev) {
  constexpr bool kTerms = kBias || kKeyBias;
  float t[N / 2];
  if (kTerms) load_terms<N, kBias, kKeyBias, false, kMask>(t, p, bias_bh, kbb, row, k0 + 2 * c);
  ring.wait_full(j);
  turns.wait();
  issue_rs_k<N>(s, qa, k_tile);
  if (has_prev) issue_prev();
  turns.pass();
  if (has_prev) {
    wg_wait<1>();  // S_j done; the previous P V runs on
  } else {
    wg_wait<0>();
  }
  keep(s);
  if (kTerms || kMask) prep<N, kTerms, kMask>(s, t, p.scale, k0 + 2 * c, p.Sk);
  float alpha[2], rs[2];
  online_softmax<N, kTerms || kMask, kTerms>(s, st.m, alpha, rs, p.scale);
  wg_wait<0>();
  keep(st.o);
  keep(pa);
  if (has_prev) bar_arrive(ring.empty(j - 1));
#pragma unroll
  for (int i = 0; i < kAcc; ++i) st.o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + rs[r];
  pack_a<N>(pa, s);
}

// O += P V for a key tile of width w (128, 64 or 16) as one group.
template <int kAcc>
__device__ __forceinline__ void issue_pv(float (&o)[kAcc], const uint32_t (&pa)[8][4],
                                         uint32_t v, int w) {
  if (w == 128)
    issue_rs<128, 2 * kAcc>(o, pa, v);
  else if (w == 64)
    issue_rs<64, 2 * kAcc>(o, pa, v);
  else
    issue_rs<16, 2 * kAcc>(o, pa, v);
}

template <int kDh, bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ Maps maps) {
  using Hd = Head<kDh>;
  const uint32_t base = smem_base();
  const uint32_t q_s = base, k_s = q_s + 2 * kBoxBytes, v_s = k_s + 2 * kFwdStages * kBoxBytes;
  // Q's barriers: full when it has arrived, empty when every computing
  // thread holds it as register operands
  const uint32_t q_full = base + kFwdTiles * kBoxBytes, q_empty = q_full + 8;
  const Ring<kFwdStages> ring = {q_full + 16, q_full + 16 + 8 * kFwdStages};
  const int n_qt = (p.Sq + 127) / 128, n_work = n_qt * p.B * p.H;
  const int wg = threadIdx.x / 128;
  const int n_steps = (p.Sk + 127) / 128;
  // step s of a tile reads key tile kt(s): the ragged last one first, then the others
  const auto kt = [n_steps](int s) { return s == 0 ? n_steps - 1 : s - 1; };
  const auto stage = [](int j) { return (uint32_t)(j % kFwdStages) * 2 * kBoxBytes; };
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    bar_init(q_empty, 256);
    ring.init(1, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    loader_regs();
    if (threadIdx.x == 256) {
      int j = 0, it = 0;  // ring steps and tiles so far
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++it) {
        const Work w(t, n_qt, p.B);
        if (it > 0) bar_wait(q_empty, (it - 1) & 1);
        bar_expect(q_full, 2 * kBoxBytes);
        tma_rows<kDh>(q_s, &maps.q, q_full, w.row0, w.h, w.b);
        tma_rows<kDh>(q_s + kBoxBytes, &maps.q, q_full, w.row0 + kBox, w.h, w.b);
        for (int s = 0; s < n_steps; ++s, ++j) {
          const uint32_t st = stage(j), full = ring.full(j);
          const int k0 = 128 * kt(s);
          ring.wait_empty(j);
          bar_expect(full, 4 * kBoxBytes);
          tma_rows<kDh>(k_s + st, &maps.k, full, k0, w.h, w.b);
          tma_rows<kDh>(k_s + st + kBoxBytes, &maps.k, full, k0 + kBox, w.h, w.b);
          tma_rows<kDh>(v_s + st, &maps.v, full, k0, w.h, w.b);
          tma_rows<kDh>(v_s + st + kBoxBytes, &maps.v, full, k0 + kBox, w.h, w.b);
        }
      }
    }
  } else {
    compute_regs();
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    const Turns turns = {wg};
    turns.start();
    const int w0 = last_width(p.Sk, 128), k_last = 128 * (n_steps - 1);
    const auto none = [] {};
    int j = 0, it = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++it, j += n_steps) {
      const Work w(t, n_qt, p.B);
      // d[0]'s row; rows past Sq are computed from zero rows and not written
      const int row = w.row0 + kBox * wg + 16 * ((threadIdx.x >> 5) & 3) + g;
      const float* bias_bh = kBias ? p.bias + w.b * p.bsb + w.h * p.bsh : nullptr;
      const float* kbb = kKeyBias ? p.key_bias + w.b * p.kbsb : nullptr;
      const int shift = head_shift<kDh>(w.h);
      FwdRows<Hd::kAcc> st;
#pragma unroll
      for (int i = 0; i < Hd::kAcc; ++i) st.o[i] = 0.f;
      st.m[0] = st.m[1] = -INFINITY;
      st.l[0] = st.l[1] = 0.f;
      float s[64];
      uint32_t pa[8][4], qa[Hd::kSteps][4];
      bar_wait(q_full, it & 1);
      load_head<kDh>(qa, q_s + wg * kBoxBytes, shift);
      bar_arrive(q_empty);
      if (w0 == 128)
        fwd_step<128, kBias, kKeyBias, true>(p, st, head<64>(s), pa, qa, k_s + stage(j), ring,
                                             turns, j, bias_bh, kbb, row, k_last, c, none, false);
      else if (w0 == 64)
        fwd_step<64, kBias, kKeyBias, true>(p, st, head<32>(s), pa, qa, k_s + stage(j), ring,
                                            turns, j, bias_bh, kbb, row, k_last, c, none, false);
      else
        fwd_step<16, kBias, kKeyBias, true>(p, st, head<8>(s), pa, qa, k_s + stage(j), ring,
                                            turns, j, bias_bh, kbb, row, k_last, c, none, false);
      for (int i = 1; i < n_steps; ++i) {
        const uint32_t v_prev = v_s + stage(j + i - 1);
        const int w_prev = i > 1 ? 128 : w0;
        const auto prev = [&] { issue_pv(st.o, pa, v_prev, w_prev); };
        fwd_step<128, kBias, kKeyBias, false>(p, st, s, pa, qa, k_s + stage(j + i), ring, turns,
                                              j + i, bias_bh, kbb, row, 128 * (i - 1), c, prev,
                                              true);
      }
      turns.wait();
      issue_pv(st.o, pa, v_s + stage(j + n_steps - 1), n_steps > 1 ? 128 : w0);
      turns.pass();
      wg_wait<0>();
      keep(st.o);
      keep(pa);
      bar_arrive(ring.empty(j + n_steps - 1));

      // the same row at head dim 64, written as the product: computed from
      // o_row there, ptxas serialized the head-dim-64 forwards' wgmmas (C7511)
      const long long oss = kDh == 64 ? (long long)p.H * kDh : o_row(p.H, kDh);
      const long long osb = (long long)p.Sq * oss;
      const float l0 = quad_sum(st.l[0]), l1 = quad_sum(st.l[1]);
      store_rows<kDh>(p.out + w.b * osb + (long long)w.h * kDh, oss, row, p.Sq, st.o, 1.f / l0,
                      1.f / l1, c, shift);
      if (c == 0) {
        // m and log l apart: m may be near -1e9 (a row whose every key is
        // masked by a finite term), where m + log l rounds back to m
        const float l[2] = {l0, l1};
        const long long n_rows = (long long)p.B * p.H * p.Sq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row + 8 * r < p.Sq) {
            const long long idx = ((long long)w.b * p.H + w.h) * p.Sq + row + 8 * r;
            p.out_lse[idx] = st.m[r];
            p.out_lse[n_rows + idx] = logf(l[r]);
          }
      }
    }
    turns.finish();
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dK/dV: K and V (128 rows); Q and dO (64 rows) a stage; then a stage's 64
// values of L = m + log l (with a term: m), of D and (with a term) of log l
constexpr int kDkvTiles = 4 + 2 * kBwdStages;
constexpr uint32_t kLdStageBytes = 3 * kBox * 4;
constexpr int kDkvExtra = kBwdStages * kLdStageBytes;
// dQ: Q, dO and O (128 rows); K and V (64 rows) a stage
constexpr int kDqTiles = 6 + 2 * kBwdStages;
using BwdRing = Ring<kBwdStages>;

// Register operands of the products still in flight from the previous step.
struct Pending {
  uint32_t a[4][4], b[4][4];
};

// Step i of a dK/dV warpgroup (64 keys) over query tile i (N queries), ring
// step j: S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T - L), then dV +=
// bf16(P^T) dO is issued while dS^T = P^T o (dP^T - D) is computed, and dK
// += bf16(dS^T) Q is left in flight: the next step (or the caller) waits
// for both and releases this step's stage.
template <int N, bool kBias, bool kKeyBias, bool kMask, int kAcc, int kSteps>
__device__ __forceinline__ void dkv_step(const Params& p, float (&dk)[kAcc], float (&dv)[kAcc],
                                         Pending& pend, const uint32_t (&ka)[kSteps][4],
                                         const uint32_t (&va)[kSteps][4], uint32_t q_s, uint32_t do_s,
                                         uint32_t ld_s, const BwdRing& ring, const Turns& turns,
                                         int i, int j, const float* bias_bh, const float* kbb,
                                         int key, int c) {
  constexpr bool kTerms = kBias || kKeyBias;
  const int q0 = kBox * i;
  const uint32_t stage = (j % kBwdStages) * kBoxBytes;
  const uint32_t q_tile = q_s + stage, do_tile = do_s + stage;
  const uint32_t l_tile = ld_s + (j % kBwdStages) * kLdStageBytes;
  float st[N / 2], dpt[N / 2];
  ring.wait_full(j);
  turns.wait();
  issue_rs_k<N>(st, ka, q_tile);
  issue_rs_k<N>(dpt, va, do_tile);
  turns.pass();
  wg_wait<2>();  // the previous step's dV and dK
  keep(dk);
  keep(dv);
  keep(pend.a);
  keep(pend.b);
  if (i > 0) bar_arrive(ring.empty(j - 1));
  wg_wait<1>();  // S^T
  keep(st);
  // the terms are read here, not before the wait as in the forward and dQ:
  // held across the four products in flight they cost registers, and ptxas
  // then serializes the wgmmas (C7515)
  float t[N / 2];
  if (kTerms) load_terms<N, kBias, kKeyBias, true, kMask>(t, p, bias_bh, kbb, key, q0 + 2 * c);
  if (kTerms || kMask) prep<N, kTerms, kMask>(st, t, p.scale, q0 + 2 * c, p.Sq);
  const float mul = kTerms || kMask ? kLog2e : p.scale * kLog2e;
  // P^T = exp(S^T - L): 0 for a masked query; L of this thread's query
  // columns q0 + 8 jj + 2 c + e.  With a term the row's m and log l come
  // apart (m may be near -1e9, where m + log l rounds to m): (S^T - m) -
  // log l first, then log2 e (as online_softmax, whose comment says why)
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const float2 l = ld_shared2(l_tile + 4 * (8 * jj + 2 * c));
    const float2 lg = kTerms ? ld_shared2(l_tile + 4 * (2 * kBox + 8 * jj + 2 * c))
                             : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float li = e & 1 ? l.y : l.x;
      st[4 * jj + e] = kTerms ? exp2_approx(((st[4 * jj + e] - li) - (e & 1 ? lg.y : lg.x)) *
                                            kLog2e)
                              : exp2_approx(fmaf(st[4 * jj + e], mul, -li * kLog2e));
    }
  }
  pack_a<N>(pend.a, st);
  issue_rs<N, 2 * kAcc>(dv, pend.a, do_tile);  // dV += bf16(P^T) dO
  wg_wait<1>();                      // dP^T
  keep(dpt);
  // dS^T = P^T o (dP^T - D)
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const float2 d = ld_shared2(l_tile + 4 * (kBox + 8 * jj + 2 * c));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - (e & 1 ? d.y : d.x));
  }
  pack_a<N>(pend.b, dpt);
  issue_rs<N, 2 * kAcc>(dk, pend.b, q_tile);  // dK += bf16(dS^T) Q
}

template <int kDh, bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const Params p, const __grid_constant__ Maps maps) {
  using Hd = Head<kDh>;
  constexpr bool kTerms = kBias || kKeyBias;
  const uint32_t base = smem_base();
  const uint32_t k_s = base, v_s = k_s + 2 * kBoxBytes, q_s = v_s + 2 * kBoxBytes,
                 do_s = q_s + kBwdStages * kBoxBytes;
  // a stage: 64 L = m + log l (with a term m), then 64 D, then (with a
  // term) 64 log l
  const uint32_t ld_s = base + kDkvTiles * kBoxBytes;
  // K and V's barriers: full when they have arrived, empty when every
  // computing thread holds them as register operands
  const uint32_t kv_full = ld_s + kDkvExtra, kv_empty = kv_full + 8;
  const BwdRing ring = {kv_full + 16, kv_full + 16 + 8 * kBwdStages};
  const int n_kt = (p.Sk + 127) / 128, n_work = n_kt * p.B * p.H;
  const int wg = threadIdx.x / 128;
  const int n_steps = (p.Sq + kBox - 1) / kBox;
  const auto stage_ld = [ld_s](int j) { return ld_s + (uint32_t)(j % kBwdStages) * kLdStageBytes; };
  const float* lgl = p.lse + (long long)p.B * p.H * p.Sq;  // log l
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    bar_init(kv_empty, 256);
    ring.init(1 + 32, 256);  // the TMA's arrival, and the loader warp's L and D
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    loader_regs();
    if (threadIdx.x < 256 + 32) {  // the loader warp
      const int lane = threadIdx.x & 31;
      int j = 0, it = 0;  // ring steps and tiles so far
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++it) {
        const Work w(t, n_kt, p.B);
        const long long rows_bh = ((long long)w.b * p.H + w.h) * p.Sq;
        if (lane == 0) {
          if (it > 0) bar_wait(kv_empty, (it - 1) & 1);
          bar_expect(kv_full, 4 * kBoxBytes);
          tma_rows<kDh>(k_s, &maps.k, kv_full, w.row0, w.h, w.b);
          tma_rows<kDh>(k_s + kBoxBytes, &maps.k, kv_full, w.row0 + kBox, w.h, w.b);
          tma_rows<kDh>(v_s, &maps.v, kv_full, w.row0, w.h, w.b);
          tma_rows<kDh>(v_s + kBoxBytes, &maps.v, kv_full, w.row0 + kBox, w.h, w.b);
        }
        for (int i = 0; i < n_steps; ++i, ++j) {
          const uint32_t st = (j % kBwdStages) * kBoxBytes, full = ring.full(j);
          ring.wait_empty(j);
          if (lane == 0) {
            bar_expect(full, 2 * kBoxBytes);
            tma_rows<kDh>(q_s + st, &maps.q, full, kBox * i, w.h, w.b);
            tma_rows<kDh>(do_s + st, &maps.dout, full, kBox * i, w.h, w.b);
          }
          for (int r = lane; r < kBox; r += 32) {
            const int qi = kBox * i + r;
            const bool ok = qi < p.Sq;
            const float m = ok ? p.lse[rows_bh + qi] : 0.f, lg = ok ? lgl[rows_bh + qi] : 0.f;
            st_shared(stage_ld(j) + 4 * r, kTerms ? m : m + lg);
            st_shared(stage_ld(j) + 4 * (kBox + r), ok ? p.delta[rows_bh + qi] : 0.f);
            if (kTerms) st_shared(stage_ld(j) + 4 * (2 * kBox + r), lg);
          }
          bar_arrive(full);
        }
      }
    }
  } else {
    compute_regs();
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    const Turns turns = {wg};
    turns.start();
    const bool full_last = last_width(p.Sq, kBox) == kBox;
    int j = 0, it = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++it, j += n_steps) {
      const Work w(t, n_kt, p.B);
      // d[0]'s key; keys past Sk are computed from zero rows and not written
      const int key = w.row0 + kBox * wg + 16 * ((threadIdx.x >> 5) & 3) + g;
      const float* bias_bh = kBias ? p.bias + w.b * p.bsb + w.h * p.bsh : nullptr;
      const float* kbb = kKeyBias ? p.key_bias + w.b * p.kbsb : nullptr;
      const int shift = head_shift<kDh>(w.h);
      float dk[Hd::kAcc], dv[Hd::kAcc];
#pragma unroll
      for (int i = 0; i < Hd::kAcc; ++i) dk[i] = dv[i] = 0.f;
      Pending pend;
      uint32_t ka[Hd::kSteps][4], va[Hd::kSteps][4];
      bar_wait(kv_full, it & 1);
      load_head<kDh>(ka, k_s + wg * kBoxBytes, shift);
      load_head<kDh>(va, v_s + wg * kBoxBytes, shift);
      bar_arrive(kv_empty);
      for (int i = 0; i < n_steps - 1; ++i)
        dkv_step<kBox, kBias, kKeyBias, false>(p, dk, dv, pend, ka, va, q_s, do_s, ld_s,
                                               ring, turns, i, j + i, bias_bh, kbb, key, c);
      const int i = n_steps - 1;
      if (full_last)
        dkv_step<kBox, kBias, kKeyBias, true>(p, dk, dv, pend, ka, va, q_s, do_s, ld_s,
                                              ring, turns, i, j + i, bias_bh, kbb, key, c);
      else
        dkv_step<16, kBias, kKeyBias, true>(p, dk, dv, pend, ka, va, q_s, do_s, ld_s,
                                            ring, turns, i, j + i, bias_bh, kbb, key, c);
      wg_wait<0>();
      keep(dk);
      keep(dv);
      keep(pend.a);
      keep(pend.b);
      bar_arrive(ring.empty(j + i));
      const long long kss = (long long)p.H * kDh, ksb = (long long)p.Sk * kss;
      const long long off = w.b * ksb + (long long)w.h * kDh;
      store_rows<kDh>(p.dk + off, kss, key, p.Sk, dk, p.scale, p.scale, c, shift);
      store_rows<kDh>(p.dv + off, kss, key, p.Sk, dv, 1.f, 1.f, c, shift);
    }
    turns.finish();
  }
}

// Step i of a dQ warpgroup (64 queries, Q and dO held as register operands)
// over key tile i (N keys), ring step j: S = Q K^T and dP = dO V^T, dS =
// exp(S - L) o (dP - D), then dQ += bf16(dS) K, left in flight: the next
// step (or the caller) waits for it and releases this step's stage.
template <int N, bool kBias, bool kKeyBias, bool kMask, int kAcc, int kSteps>
__device__ __forceinline__ void dq_step(const Params& p, float (&dq)[kAcc], Pending& pend,
                                        const uint32_t (&qa)[kSteps][4],
                                        const uint32_t (&doa)[kSteps][4],
                                        uint32_t k_s, uint32_t v_s, const BwdRing& ring,
                                        const Turns& turns, int i, int j, const float* bias_bh,
                                        const float* kbb, const float (&lse)[2],
                                        const float (&lgl)[2], const float (&dlt)[2], int row,
                                        int c) {
  constexpr bool kTerms = kBias || kKeyBias;
  const int k0 = kBox * i;
  const uint32_t stage = (j % kBwdStages) * kBoxBytes;
  const uint32_t k_tile = k_s + stage, v_tile = v_s + stage;
  float t[N / 2];
  if (kTerms) load_terms<N, kBias, kKeyBias, false, kMask>(t, p, bias_bh, kbb, row, k0 + 2 * c);
  float s[N / 2], dp[N / 2];
  ring.wait_full(j);
  turns.wait();
  issue_rs_k<N>(s, qa, k_tile);
  issue_rs_k<N>(dp, doa, v_tile);
  turns.pass();
  wg_wait<2>();  // the previous step's dQ
  keep(dq);
  keep(pend.a);
  if (i > 0) bar_arrive(ring.empty(j - 1));
  wg_wait<1>();  // S
  keep(s);
  if (kTerms || kMask) prep<N, kTerms, kMask>(s, t, p.scale, k0 + 2 * c, p.Sk);
  const float mul = kTerms || kMask ? kLog2e : p.scale * kLog2e;
  // P = exp(S - L); with a term exp((S - m) - log l), subtracting first,
  // then log2 e (online_softmax)
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    s[i] = kTerms ? exp2_approx(((s[i] - lse[(i >> 1) & 1]) - lgl[(i >> 1) & 1]) * kLog2e)
                  : exp2_approx(fmaf(s[i], mul, -lse[(i >> 1) & 1] * kLog2e));
  wg_wait<0>();  // dP
  keep(dp);
  // dS = P o (dP - D): 0 for a masked key
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] *= dp[i] - dlt[(i >> 1) & 1];
  pack_a<N>(pend.a, s);
  issue_rs<N, 2 * kAcc>(dq, pend.a, k_tile);  // dQ += bf16(dS) K
}

template <int kDh, bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const Params p, const __grid_constant__ Maps maps) {
  using Hd = Head<kDh>;
  const uint32_t base = smem_base();
  const uint32_t q_s = base, do_s = q_s + 2 * kBoxBytes, o_s = do_s + 2 * kBoxBytes,
                 k_s = o_s + 2 * kBoxBytes, v_s = k_s + kBwdStages * kBoxBytes;
  // Q, dO and O's barriers: full when they have arrived, empty when every
  // computing thread holds them as register operands
  const uint32_t q_full = base + kDqTiles * kBoxBytes, q_empty = q_full + 8;
  const BwdRing ring = {q_full + 16, q_full + 16 + 8 * kBwdStages};
  const int n_qt = (p.Sq + 127) / 128, n_work = n_qt * p.B * p.H;
  const int wg = threadIdx.x / 128;
  const int n_steps = (p.Sk + kBox - 1) / kBox;
  const auto stage = [](int j) { return (uint32_t)(j % kBwdStages) * kBoxBytes; };
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    bar_init(q_empty, 256);
    ring.init(1, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    loader_regs();
    if (threadIdx.x == 256) {
      int j = 0, it = 0;  // ring steps and tiles so far
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++it) {
        const Work w(t, n_qt, p.B);
        if (it > 0) bar_wait(q_empty, (it - 1) & 1);
        bar_expect(q_full, 6 * kBoxBytes);
        tma_rows<kDh>(q_s, &maps.q, q_full, w.row0, w.h, w.b);
        tma_rows<kDh>(q_s + kBoxBytes, &maps.q, q_full, w.row0 + kBox, w.h, w.b);
        tma_rows<kDh>(do_s, &maps.dout, q_full, w.row0, w.h, w.b);
        tma_rows<kDh>(do_s + kBoxBytes, &maps.dout, q_full, w.row0 + kBox, w.h, w.b);
        tma_rows<kDh>(o_s, &maps.o, q_full, w.row0, w.h, w.b);
        tma_rows<kDh>(o_s + kBoxBytes, &maps.o, q_full, w.row0 + kBox, w.h, w.b);
        for (int i = 0; i < n_steps; ++i, ++j) {
          const uint32_t full = ring.full(j);
          ring.wait_empty(j);
          bar_expect(full, 2 * kBoxBytes);
          tma_rows<kDh>(k_s + stage(j), &maps.k, full, kBox * i, w.h, w.b);
          tma_rows<kDh>(v_s + stage(j), &maps.v, full, kBox * i, w.h, w.b);
        }
      }
    }
  } else {
    compute_regs();
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    const Turns turns = {wg};
    turns.start();
    const bool full_last = last_width(p.Sk, kBox) == kBox;
    int j = 0, it = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++it, j += n_steps) {
      const Work w(t, n_qt, p.B);
      // d[0]'s row; rows past Sq are computed from zero rows and not written
      const int row = w.row0 + kBox * wg + 16 * ((threadIdx.x >> 5) & 3) + g;
      const float* bias_bh = kBias ? p.bias + w.b * p.bsb + w.h * p.bsh : nullptr;
      const float* kbb = kKeyBias ? p.key_bias + w.b * p.kbsb : nullptr;
      const long long rows_bh = ((long long)w.b * p.H + w.h) * p.Sq;
      // L = m + log l for the fused exponent, or with a term m and log l
      // (``lgl``) apart
      float lse[2], lgl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = row + 8 * r < p.Sq;
        const float m = ok ? p.lse[rows_bh + row + 8 * r] : 0.f;
        lgl[r] = ok ? p.lse[(long long)p.B * p.H * p.Sq + rows_bh + row + 8 * r] : 0.f;
        lse[r] = kBias || kKeyBias ? m : m + lgl[r];
      }
      const int shift = head_shift<kDh>(w.h);
      float dq[Hd::kAcc];
#pragma unroll
      for (int i = 0; i < Hd::kAcc; ++i) dq[i] = 0.f;
      Pending pend;
      uint32_t qa[Hd::kSteps][4], doa[Hd::kSteps][4], oa[Hd::kSteps][4];
      bar_wait(q_full, it & 1);
      load_head<kDh>(qa, q_s + wg * kBoxBytes, shift);
      load_head<kDh>(doa, do_s + wg * kBoxBytes, shift);
      load_a(oa, o_s + wg * kBoxBytes);
      bar_arrive(q_empty);
      // D = rowsum(dO o O) in float32, from this thread's columns of rows
      // row and row + 8 (the register operands' layout) summed over the
      // quad (at head dim 34 dO is 0 outside the head); written for the
      // dK/dV kernel, which runs next
      float dlt[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < Hd::kSteps; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 d = bf16x2_to_float2(doa[kk][r]), o = bf16x2_to_float2(oa[kk][r]);
          dlt[r & 1] += d.x * o.x + d.y * o.y;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dlt[r] = quad_sum(dlt[r]);
        if (c == 0 && row + 8 * r < p.Sq) p.delta[rows_bh + row + 8 * r] = dlt[r];
      }
      for (int i = 0; i < n_steps - 1; ++i)
        dq_step<kBox, kBias, kKeyBias, false>(p, dq, pend, qa, doa, k_s, v_s, ring, turns, i,
                                              j + i, bias_bh, kbb, lse, lgl, dlt, row, c);
      const int i = n_steps - 1;
      if (full_last)
        dq_step<kBox, kBias, kKeyBias, true>(p, dq, pend, qa, doa, k_s, v_s, ring, turns, i,
                                             j + i, bias_bh, kbb, lse, lgl, dlt, row, c);
      else
        dq_step<16, kBias, kKeyBias, true>(p, dq, pend, qa, doa, k_s, v_s, ring, turns, i, j + i,
                                           bias_bh, kbb, lse, lgl, dlt, row, c);
      wg_wait<0>();
      keep(dq);
      keep(pend.a);
      bar_arrive(ring.empty(j + i));
      const long long oss = (long long)p.H * kDh, osb = (long long)p.Sq * oss;
      store_rows<kDh>(p.out + w.b * osb + (long long)w.h * kDh, oss, row, p.Sq, dq, p.scale,
                      p.scale, c, shift);
    }
    turns.finish();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr size_t kFwdSmem = smem_bytes(kFwdTiles, 0, kFwdStages);
constexpr size_t kDkvSmem = smem_bytes(kDkvTiles, kDkvExtra, kBwdStages);
constexpr size_t kDqSmem = smem_bytes(kDqTiles, 0, kBwdStages);

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library needs no link against the driver library.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A map over a [B, S, H, D] bf16 tensor with element strides (sb, ss,
// sh), 64 x 64 boxes in the 128-byte swizzle, zeros out of bounds.  Head
// dim 64: (64, S, H, B).  Head dim 34: the heads folded into the columns,
// (H * 34, S, B) over the row and batch strides (sh is 34: packed heads,
// which the wrapper checks), zeros past column H * 34.  A dimension of
// extent 1 is never stepped, so its stride is set to one any encoding
// accepts.
cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int D, int B, int S, int H,
                        long long sb, long long ss, long long sh) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t box[4] = {(cuuint32_t)kD, (cuuint32_t)kBox, 1u, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  CUresult r;
  if (D == 64) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)ss * 2 : 128u,
                                   H > 1 ? (cuuint64_t)sh * 2 : 128u,
                                   B > 1 ? (cuuint64_t)sb * 2 : 128u};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
           unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    // a row of H heads, on 16 bytes, where a stride is never stepped
    const cuuint64_t row = (cuuint64_t)o_row(H, D) * 2;
    const cuuint64_t row_stride = S > 1 ? (cuuint64_t)ss * 2 : row;
    const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {row_stride,
                                   B > 1 ? (cuuint64_t)sb * 2 : row_stride * (cuuint64_t)S};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
           unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of a call at head dim D; O and dO in rows of o_row(H, D).
cudaError_t make_maps(const Params& p, int D, Maps* m, bool backward) {
  cudaError_t err = encode_rows(&m->q, p.q, D, p.B, p.Sq, p.H, p.qsb, p.qss, p.qsh);
  if (err == cudaSuccess) err = encode_rows(&m->k, p.k, D, p.B, p.Sk, p.H, p.ksb, p.kss, p.ksh);
  if (err == cudaSuccess) err = encode_rows(&m->v, p.v, D, p.B, p.Sk, p.H, p.vsb, p.vss, p.vsh);
  if (err == cudaSuccess && backward) {
    const long long oss = o_row(p.H, D);
    err = encode_rows(&m->dout, p.dout, D, p.B, p.Sq, p.H, p.Sq * oss, oss, D);
    if (err == cudaSuccess) err = encode_rows(&m->o, p.o, D, p.B, p.Sq, p.H, p.Sq * oss, oss, D);
  }
  return err;
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const void* key_bias, int B, int H, int Sq, int Sk, long long qsb,
                   long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
                   long long bsq, long long bsk, long long kbsb, float scale) {
  Params p = {};
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.bias = (const float*)bias;
  p.key_bias = (const float*)key_bias;
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.bsb = bsb; p.bsh = bsh; p.bsq = bsq; p.bsk = bsk;
  p.kbsb = kbsb;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.scale = scale;
  return p;
}

// Launch ``kernel`` with ``smem`` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p,
                   const Maps& maps) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

// The instance of a kernel at head dim kDh and the terms present:
// ``L::run<kDh, kBias, kKeyBias>``.
template <int kDh, typename L>
cudaError_t dispatch_terms(const Params& p, const Maps& maps, dim3 grid, cudaStream_t stream) {
  if (p.bias != nullptr)
    return p.key_bias != nullptr ? L::template run<kDh, true, true>(p, maps, grid, stream)
                                 : L::template run<kDh, true, false>(p, maps, grid, stream);
  return p.key_bias != nullptr ? L::template run<kDh, false, true>(p, maps, grid, stream)
                               : L::template run<kDh, false, false>(p, maps, grid, stream);
}

template <typename L>
cudaError_t dispatch(const Params& p, const Maps& maps, int D, dim3 grid, cudaStream_t stream) {
  if (D == 64) return dispatch_terms<64, L>(p, maps, grid, stream);
  if (D == 34) return dispatch_terms<34, L>(p, maps, grid, stream);
  return cudaErrorInvalidValue;
}

struct Fwd {
  template <int kDh, bool kB, bool kKB>
  static cudaError_t run(const Params& p, const Maps& m, dim3 grid, cudaStream_t s) {
    return launch(flash_fwd_kernel<kDh, kB, kKB>, grid, kFwdSmem, s, p, m);
  }
};
struct Dkv {
  template <int kDh, bool kB, bool kKB>
  static cudaError_t run(const Params& p, const Maps& m, dim3 grid, cudaStream_t s) {
    return launch(flash_bwd_dkv_kernel<kDh, kB, kKB>, grid, kDkvSmem, s, p, m);
  }
};
struct Dq {
  template <int kDh, bool kB, bool kKB>
  static cudaError_t run(const Params& p, const Maps& m, dim3 grid, cudaStream_t s) {
    return launch(flash_bwd_dq_kernel<kDh, kB, kKB>, grid, kDqSmem, s, p, m);
  }
};

// The persistent grid of a kernel over 128-row tiles of ``n`` rows of every
// (batch, head): one block an SM, or one a tile when there are fewer tiles.
dim3 grid_of(int n, const Params& p) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((n + 127) / 128) * p.B * p.H;
  return dim3((unsigned)(tiles < sms ? tiles : sms));
}

}  // namespace

// O [B, Sq, H, D] bf16 in rows of o_row(H, D) elements, m and log l [2, B,
// H, Sq] float32; D, the head dim, is 64 or 34.  q, k and v (bf16, [B, S,
// H, D]) start every row on 16 bytes, with b, s (and at 64 h) strides that
// are multiples of 8, at 34 packed heads (the wrapper checks).  bias and
// key_bias (float32) may be null.
extern "C" int vq_flash_attention_bf16_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* key_bias,
    void* out, void* lse, int B, int H, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long bsb, long long bsh, long long bsq,
    long long bsk, long long kbsb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (D != 64 && D != 34) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, bias, key_bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, kbsb, scale);
  p.out = (bf16*)out;
  p.out_lse = (float*)lse;
  Maps maps;
  cudaError_t err = make_maps(p, D, &maps, false);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<Fwd>(p, maps, D, grid_of(Sq, p), (cudaStream_t)stream);
}

// dQ [B, Sq, H, D], dK and dV [B, Sk, H, D], all bf16 and contiguous; o and
// dout bf16 [B, Sq, H, D] in rows of o_row(H, D) elements, on 16 bytes (TMA
// reads both: a map over a tensor off 16 bytes does not encode, and the
// call returns its error); delta a float32 [B, H, Sq] scratch.
extern "C" int vq_flash_attention_bf16_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* key_bias,
    const void* o, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int B, int H, int Sq, int Sk, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
    long long bsq, long long bsk, long long kbsb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (D != 64 && D != 34) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, bias, key_bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, kbsb, scale);
  p.o = (const bf16*)o;
  p.lse = (const float*)lse;
  p.dout = (const bf16*)dout;
  p.out = (bf16*)dq;
  p.dk = (bf16*)dk;
  p.dv = (bf16*)dv;
  p.delta = (float*)delta;
  cudaStream_t s = (cudaStream_t)stream;
  Maps maps;
  cudaError_t err = make_maps(p, D, &maps, true);
  if (err != cudaSuccess) return (int)err;

  // dQ first: it computes D and writes it for dK/dV
  err = dispatch<Dq>(p, maps, D, grid_of(Sq, p), s);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<Dkv>(p, maps, D, grid_of(Sk, p), s);
}
