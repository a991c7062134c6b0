// Flash attention, forward and backward, float32, head dim 64 or 34, on
// the tensor cores with a 3xTF32 split: the C entry points, the D pass, and
// the mma.sync kernel that gives the bias its gradient (dbias) with dQ, at
// both head dims.  The entry points launch the Hopper kernels of
// flash_attention_tf32.cu (wgmma and TMA; the same function, layout and
// arithmetic) for the forward, dK/dV and, without dbias, dQ;
// ops/attention.py::k3_route names the instance a call takes.
//
// Replaces the TPU kernel behind vqattack_tpu/ops/attention.py::flash_attention,
// which wraps jax.experimental.pallas.ops.tpu.flash_attention (its forward,
// dq-backward and dkv-backward pallas_calls) after padding the sequence to a
// multiple of 128 (_prepare) and, with a bias, materializing a dense
// [B, H, Sq_p, Sk_p] bias.  This kernel computes the same function, not the
// TPU kernel's blocks:
//
//   forward   S = Q K^T * scale + bias + key_bias,  m = max_rows(S),
//             l = sum_rows(exp(S - m)),  O = softmax(S) V
//             (m and log l saved for the backward)
//   backward  D_i = sum_d dO_id O_id,    P = exp((S - m) - log l),
//             dV = P^T dO,  dS = P o (dO V^T - D),
//             dQ = scale * dS K,  dK = scale * dS^T Q
//
// for every (batch, head), with q/k/v read through their [B, S, H, Dh]
// strides, O/dQ/dK/dV written as contiguous [B, S, H, Dh], m and log l as
// [2, B, H, Sq] and D as [B, H, Sq].  Two additive terms, each optional,
// follow the scale: the bias, read through broadcast strides (0 along a
// broadcast dimension), so a
// [1, H, S, S] table or a [B, 1, 1, Sk] key mask is never materialized at
// [B, H, Sq, Sk]; and the key bias, one value a key ([1|B, Sk], contiguous
// along Sk), which carries a key mask beside a table: VLMo's relative-position
// table plus its padded-text mask, whose sum would be [B, H, S, S].  Ragged
// lengths need no padding: keys j >= Sk are masked inside the kernel and rows
// i >= Sq are never written.  m and log l stay apart: a row whose every key
// is masked by a finite term (-1e9) has m near -1e9, where m + log l rounds
// back to m (the float32 ulp there is 64).
//
// Bound on the H100: operations.  At the main path's shape (B=16, H=12,
// S=901, Dh=64) B*H*S^2*Dh = 9.98e9; the forward needs 4x that (39.9
// GFLOP) and the backward, recomputing P, 10x (99.8 GFLOP), against
// 177 MB of q, k, v and o (53 us at 3.35 TB/s).  The main path runs float32,
// and one TF32 pass keeps 11 significant bits, too few for its tolerances,
// so every product is three TF32 passes: x = hi + lo with hi = tf32(x) and
// lo = x - hi (read by the tensor cores to TF32), and a b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi (lo lo dropped), accumulated in float32.  At the
// dense TF32 rate (495 TFLOP/s) three passes bound the forward at 0.242 ms
// and the backward at 0.605 ms.
//
// The dbias kernel (mma.sync; the Hopper kernels have no dbias instance):
// - every product runs as mma.sync.m16n8k8 tf32 (inline PTX); one block of
//   4 warps per 64-row query tile, 16 rows a warp, walking every 64-key
//   tile (S = Q K^T and dP = dO V^T recomputed, dQ += dS K);
// - the m16n8k8 accumulator does not have the A operand's layout (a thread
//   holds columns 2t, 2t+1 of a row, the A operand wants t and t+4).  The
//   product that consumes dS sums over its depth in the permuted order
//   t -> 2t, t + 4 -> 2t + 1, and reads the matching rows of its B operand,
//   so the accumulator feeds the next product as it is;
// - tiles in shared memory with rows padded to 68 floats (44 at head dim
//   34, whose 34 columns a tile holds as 40, the last 6 zero-filled by the
//   copies): the fragments read a tile at rows g, columns t, or in the
//   permuted order at rows 2t or 2t + 1, columns g, 32 distinct banks both
//   ways;
// - tiles arrive by cp.async (16 bytes, or 8 at head dim 34, whose heads
//   start 136 bytes apart; zero-filled past Sq or Sk), double buffered; a
//   key tile's 64 key-bias values arrive with its K tile;
// - no atomics: every sum runs in a fixed order, so the result is the same
//   on every run.
//
// The bias gradient (dbias; the library's dQ kernel returns its ds as the
// gradient of its bias ``ab``, flash_attention.py:1287, :1477) comes from
// this file's dQ kernel, launched only when the bias needs a gradient.
// dS, which the kernel forms anyway, is the gradient of the post-scale
// score and so of the post-scale bias; the bias's gradient is dS summed
// over the dimensions along which the bias broadcasts.  VLMo's table is
// [1, H, S, S], so the sum runs over the batch, and it runs inside the
// kernel, in a fixed order, with no atomics and no [B, H, Sq, Sk] buffer:
// - a thread-block cluster of C = min(B, 8) blocks along the grid's z (8
//   is the portable maximum) shares a (query tile, head), rank r taking
//   batch row b = g C + r of cluster g; the grid's z is B rounded up to a
//   multiple of C, and a block past B loads and computes nothing, stages
//   zeros and joins every cluster barrier;
// - at each key tile j a block stages its 64 x 64 dS tile in its own shared
//   memory, in one of two buffers by the parity of j: at head dim 64 in
//   V_j's buffer, which tile j is done with once dP = dO V_j^T is formed (a
//   seventh 17,408-byte tile would cost the second block an SM), V_{j+1}
//   arriving in the other one only once tile j - 1's dS there is summed,
//   behind S = Q K^T; at head dim 34, whose tiles are 44 floats wide, in two
//   64 x 68 tiles of their own (2 blocks an SM still fit);
// - one cluster barrier a tile: a block arrives (release) once it has
//   staged tile j and read its peers' tile j - 1, computes dQ += dS K_j
//   while the others arrive, and waits (acquire); then every peer's tile j
//   is staged and every tile j - 1 read, so its buffer is free again;
// - rank r then sums rows [64 r / C, 64 (r + 1) / C) of the tile over the
//   C staged tiles, read through distributed shared memory (mapa,
//   ld.shared::cluster) and added in rank order 0..C-1, and stores them
//   with a warp's 32 lanes on 32 consecutive keys (a row of Sk = 941 floats
//   does not start on 16 bytes); a last barrier keeps every block until no
//   peer reads its shared memory.
// With B <= 8 the one cluster of a tile writes the [1, H, Sq, Sk] gradient
// itself.  With B > 8 the G = ceil(B / 8) clusters of a tile write G
// partial planes of a [G, H, Sq, Sk] buffer, and a pass adds them in the
// order g = 0..G-1 into plane 0.  A bias with a batch dimension (read with
// a batch stride other than 0) takes C = 1 and writes its own [B, H, Sq,
// Sk] gradient.  A broadcast over H or Sq is summed by the wrapper.  Bound
// on the H100: the products (the backward's 0.33 ms at VLMo's [8, 12, 941,
// 941]); dbias adds one [1, H, Sq, Sk] write, 42.5 MB there, 12.7 us at
// 3.35 TB/s.  The sum's order is fixed, so the result repeats bit for bit.

// With both terms, at VLMo's [16, 941, 12, 64] (a [1, 12, 941, 941] table,
// 42.5 MB, and the padded-text mask), each (batch, head) reads its head's
// 3.5 MB slice of the table, 680 MB in all when L2 keeps none of it; the
// products still set the pace (PERF.md times the kernels with both terms,
// with the table alone and with neither).
//
// What bounds the dbias kernel (PERF.md): instruction issue, as it bounded
// the mma.sync forward and dK/dV that flash_attention_tf32.cu replaced: the
// 4 warps of a block split the same K and V values (3 instructions a value)
// and load every fragment themselves, and 2 blocks an SM leave 2 warps a
// scheduler; the cluster's barrier and its sum through distributed shared
// memory add their own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kWarps = 4;       // 16 rows of a tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kKeySteps = kTile / 8;  // m16n8k8 steps over a tile's 64 keys (or queries)
constexpr float kLog2e = 1.4426950408889634f;

// The layout of head dim kDh (64 or 34) in shared memory.
template <int kDh>
struct Width {
  static constexpr int kD = (kDh + 7) / 8 * 8;  // columns of a tile: m16n8k8 steps of 8
  static constexpr int kLd = kD + 4;            // shared-memory row, in floats (16-byte aligned)
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr int kSteps = kD / 8;         // m16n8k8 steps over the columns
  // floats a cp.async copies: 16 bytes, or 8 where a row starts off 16 bytes
  static constexpr int kChunk = kDh % 4 == 0 ? 4 : 2;
};

using Params = vqflash::Params;

// ---------------------------------------------------------------------------
// shared-memory tiles and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the one just committed) is in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until at most the two groups committed last are in flight.
__device__ __forceinline__ void cp_async_wait_prev2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a tile by 16-byte
// (or, at head dim 34, 8-byte) copies; rows past ``nrows`` and columns past
// kDh are zero-filled.  ``base`` points at row 0, aligned to the copy, as is
// every row (the wrapper checks).
template <int kDh>
__device__ __forceinline__ void load_tile(float* sm, const float* base, long long row_stride,
                                          int row0, int nrows) {
  using W = Width<kDh>;
  constexpr int kPerRow = W::kD / W::kChunk;
  for (unsigned idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = idx % kPerRow * W::kChunk;  // a shift and a mask at 64
    const int row = row0 + r;
    const bool ok = row < nrows && (kDh == W::kD || c < kDh);
    const float* src = ok ? base + row * row_stride + c : base;
    if (W::kChunk == 4)
      cp_async16(sm + r * W::kLd + c, src, ok);
    else
      cp_async8(sm + r * W::kLd + c, src, ok);
  }
}

// Key-bias values of keys [k0, k0 + 64) (0 past Sk, where the keys are
// masked) into ``dst``; ``kb`` is (b)'s key 0.
__device__ __forceinline__ void load_key_bias(float* dst, const float* kb, int k0, int Sk) {
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    const bool ok = key < Sk;
    cp_async4(dst + threadIdx.x, ok ? kb + key : kb, ok);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 fragments and products
//
// A thread (lane) holds, with g = lane / 4 and t = lane % 4,
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A tile is read through a per-thread base: ``rows`` = X + g * kLd + t for
// rows g and columns t (an A operand, or B = X^T), ``cols`` = X + 2t * kLd + g
// for rows 2t, 2t + 1 and columns g (B = X in the permuted depth order).
// ---------------------------------------------------------------------------

// x = hi + lo.  hi is x rounded to TF32 (10 mantissa bits) to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding, bit for bit on finite
// values, in two integer operations (add half of the dropped 13 bits' unit
// to the magnitude, clear them), because the conversion instruction issues
// on a narrower pipe.  lo = x - hi is exact and goes to the tensor cores as
// it is: they read a TF32 operand's top 19 bits, so lo is truncated to TF32
// (as CUTLASS's FastF32 does it).  A warp splits 320 values per key tile of
// the forward, and these 3 instructions a value, not 5 with lo rounded too,
// cut K3's time by 10% (PERF.md).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x in one instruction (denormal results flush to 0, a weight that does
// not count next to the row's largest, which is 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b: the two cross terms first, then hi hi.
__device__ __forceinline__ void mma_3xtf32(float c[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A = rows [r0, r0 + 16), columns [k0, k0 + 8) of a tile of kLd-float rows.
template <int kLd>
__device__ __forceinline__ void load_a(FragA& f, const float* rows, int r0, int k0) {
  split(rows[r0 * kLd + k0], f.hi[0], f.lo[0]);
  split(rows[(r0 + 8) * kLd + k0], f.hi[1], f.lo[1]);
  split(rows[r0 * kLd + k0 + 4], f.hi[2], f.lo[2]);
  split(rows[(r0 + 8) * kLd + k0 + 4], f.hi[3], f.lo[3]);
}

// B = X^T for X's rows [n0, n0 + 8) and columns [k0, k0 + 8).
template <int kLd>
__device__ __forceinline__ void load_bt(FragB& f, const float* rows, int n0, int k0) {
  split(rows[n0 * kLd + k0], f.hi[0], f.lo[0]);
  split(rows[n0 * kLd + k0 + 4], f.hi[1], f.lo[1]);
}

// B = X for X's rows [k0, k0 + 8) in the permuted depth order (t -> 2t,
// t + 4 -> 2t + 1) and columns [n0, n0 + 8).
template <int kLd>
__device__ __forceinline__ void load_b_perm(FragB& f, const float* cols, int k0, int n0) {
  split(cols[k0 * kLd + n0], f.hi[0], f.lo[0]);
  split(cols[(k0 + 1) * kLd + n0], f.hi[1], f.lo[1]);
}

// A from an accumulator tile c (its 8 columns as the depth, in the permuted
// order that load_b_perm reads).
__device__ __forceinline__ void acc_to_a(FragA& f, const float c[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// acc[n] (16 x 8 each, n < 8) = rows [r0, r0 + 16) of A times X^T, A and X
// tiles of head dim kDh: a 16 x 64 product over the tiles' kD columns.
// ``a_rows`` and ``x_rows`` are the tiles' per-thread row bases.
template <int kDh>
__device__ __forceinline__ void product_abt(float acc[kKeySteps][4], const float* a_rows, int r0,
                                            const float* x_rows) {
  using W = Width<kDh>;
#pragma unroll
  for (int n = 0; n < kKeySteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W::kD; kk += 8) {
    FragA a;
    load_a<W::kLd>(a, a_rows, r0, kk);
#pragma unroll
    for (int n = 0; n < kKeySteps; ++n) {
      FragB b;
      load_bt<W::kLd>(b, x_rows, 8 * n, kk);
      mma_3xtf32(acc[n], a, b);
    }
  }
}

// acc[n] += C X, C a 16 x 64 accumulator tile (c[j] its columns 8j..8j+7)
// and X a 64-row tile of head dim kDh given by its per-thread column base:
// a 16 x kD product.
template <int kDh>
__device__ __forceinline__ void product_cx(float acc[Width<kDh>::kSteps][4],
                                           const float c[kKeySteps][4], const float* x_cols) {
  using W = Width<kDh>;
#pragma unroll
  for (int j = 0; j < kKeySteps; ++j) {
    FragA a;
    acc_to_a(a, c[j]);
#pragma unroll
    for (int n = 0; n < W::kSteps; ++n) {
      FragB b;
      load_b_perm<W::kLd>(b, x_cols, 8 * j, 8 * n);
      mma_3xtf32(acc[n], a, b);
    }
  }
}

// ---------------------------------------------------------------------------
// scores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s = (s * scale + bias) + key_bias over a 16 x 64 accumulator tile whose
// element (n, e) sits at query row r + 8 (e / 2) and key column c + 8 n + (e
// % 2) (r = its first row + g, c = its first column + 2t).  The bias index
// is clamped, so that rows and columns past Sq and Sk (never written or
// masked) read in bounds.  ``kbs`` is the key-bias tile in shared memory,
// offset to this thread's first key (+ 2t).
template <bool kKeyBias>
__device__ __forceinline__ void scale_bias(float s[kKeySteps][4], const Params& p,
                                           const float* bias_bh, const float* kbs, int r,
                                           int c) {
#pragma unroll
  for (int n = 0; n < kKeySteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = min(r + 8 * (e >> 1), p.Sq - 1), kj = min(c + 8 * n + (e & 1), p.Sk - 1);
      float x = s[n][e] * p.scale + bias_bh[qi * p.bsq + kj * p.bsk];
      if (kKeyBias) x += kbs[8 * n + (e & 1)];
      s[n][e] = x;
    }
}

// s = -inf in the columns c + 8 n + (e % 2) at or past ``n_valid``.
__device__ __forceinline__ void mask_cols(float s[kKeySteps][4], int c, int n_valid) {
#pragma unroll
  for (int n = 0; n < kKeySteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + 8 * n + (e & 1) >= n_valid) s[n][e] = -INFINITY;
}

// Store rows r and r + 8 of a 16 x kD accumulator tile times ``mul`` as two
// rows of a contiguous [B, S, H, kDh] tensor; rows at or past ``nrows``, and
// columns past kDh, are not written.  kDh is even, so a thread's column
// pair is written whole or not at all.
template <int kDh>
__device__ __forceinline__ void store_rows(float* base, long long row_stride, int row, int nrows,
                                           const float acc[Width<kDh>::kSteps][4], float mul0,
                                           float mul1, int t) {
  using W = Width<kDh>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= nrows) continue;
    const float mul = i == 0 ? mul0 : mul1;
    float* dst = base + r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < W::kSteps; ++n)
      if (kDh == W::kD || 8 * n + 2 * t < kDh)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// dbias: dS summed over a cluster's batch rows
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable maximum of blocks a cluster
constexpr int kStageLd = 68;    // a staged dS row, in floats: V's row at head dim 64

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The two halves of a cluster barrier, which every thread of every block
// of the cluster passes: arrive (release by default: this thread's writes
// made visible to the cluster), then wait (acquire by default: every
// thread's arrival, and its writes, seen).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ``*local`` (shared memory) as it lies in the block of cluster rank
// ``rank``, read through distributed shared memory.
__device__ __forceinline__ float ld_peer(const float* local, unsigned rank) {
  uint32_t addr;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// dS of rows ``row`` (e < 2) and ``row`` + 8 (e >= 2), columns ``col`` + 8 n
// + (e % 2), of a 64 x 64 tile into ``stage`` (rows of kStageLd floats).
__device__ __forceinline__ void stage_ds(float* stage, const float ds[kKeySteps][4], int row,
                                         int col) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* dst = stage + (row + 8 * i) * kStageLd + col;
#pragma unroll
    for (int n = 0; n < kKeySteps; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(ds[n][2 * i], ds[n][2 * i + 1]);
  }
}

// This block's share of its cluster's sum of the staged dS tiles of query
// rows [q0, q0 + 64) and keys [k0, k0 + 64): rank r's rows [64 r / C,
// 64 (r + 1) / C), each value the sum over the blocks of ranks 0..C-1 in
// that order, stored into plane ``plane`` of the [planes, H, Sq, Sk]
// gradient.  Warps take rows in turn, a warp's lanes 32 consecutive keys;
// rows past Sq and keys past Sk are not written.  A row's 2 C loads are in
// flight together: one round trip through distributed shared memory a row
// (2 rows a warp at C = 8).
__device__ __forceinline__ void reduce_ds(const Params& p, const float* stage, int plane, int h,
                                          int q0, int k0) {
  const int C = p.cluster;
  const int rank = (int)cluster_rank(), lane = threadIdx.x & 31;
  float* out = p.dbias + ((long long)plane * p.H + h) * p.Sq * p.Sk + k0;
  const int end = min((rank + 1) * kTile / C, p.Sq - q0);
  for (int r = rank * kTile / C + (int)(threadIdx.x >> 5); r < end; r += kWarps) {
    const float* src = stage + r * kStageLd + lane;
    float v[2][kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C) {
        v[0][c] = ld_peer(src, c);
        v[1][c] = ld_peer(src + 32, c);
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc = v[half][0];
#pragma unroll
      for (int c = 1; c < kMaxCluster; ++c)
        if (c < C) acc += v[half][c];
      if (k0 + 32 * half + lane < p.Sk) out[(long long)(q0 + r) * p.Sk + 32 * half + lane] = acc;
    }
  }
}

// Plane 0 of ``planes`` contiguous planes of n floats = the sum of all of
// them, in the order 0..planes-1: the clusters' partial dbias sums at B > 8.
__global__ void dbias_plane_sum_kernel(float* buf, long long n, int planes) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float acc = buf[i];
    for (int g = 1; g < planes; ++g) acc += buf[g * n + i];
    buf[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row.
template <int kDh>
__global__ void flash_bwd_delta_kernel(const Params p) {
  const long long n_rows = (long long)p.B * p.H * p.Sq;
  const int lane = threadIdx.x & 31;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < n_rows;
       w += n_warps) {
    const int i = (int)(w % p.Sq);
    const long long bh = w / p.Sq;
    const int h = (int)(bh % p.H), b = (int)(bh / p.H);
    const long long off = (((long long)b * p.Sq + i) * p.H + h) * kDh;
    float s = 0.f;
#pragma unroll
    for (int d = lane; d < kDh; d += 32) s += p.dout[off + d] * p.o[off + d];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) p.delta[w] = s;
  }
}

// dQ and the bias's gradient (dbias: a bias is given): a block walks the
// 64-key tiles for 64 query rows, and its cluster sums each tile's dS over
// its batch rows.
template <int kDh, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_dbias_kernel(const Params p) {
  using W = Width<kDh>;
  constexpr int kTileFloats = W::kTileFloats;
  // tile j's dS is staged in V_j's buffer where its rows are kStageLd
  // floats (head dim 64), else in two tiles of its own, by parity of j.
  // In V_j's buffer V_{j+1} arrives late (kLateV): the buffer holds tile
  // j - 1's dS until every peer has summed it, and S = Q K^T is formed
  // before V_j is waited for
  constexpr bool kOwnStage = W::kLd != kStageLd;
  constexpr bool kLateV = !kOwnStage;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;     // two buffers
  float* Vs = Ks + 2 * kTileFloats;  // two buffers
  float* KBs = Vs + 2 * kTileFloats; // two buffers of 64 (with a key bias)
  float* DSs = KBs + (kKeyBias ? 2 * kTile : 0);  // two tiles of 64 rows of kStageLd (kOwnStage)

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  // a block of the last cluster past B only stages zeros and sums
  const bool live = b < p.B;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's rows of the tile
  const int rows_off = g * W::kLd + t, cols_off = 2 * t * W::kLd + g;
  const long long oss = (long long)p.H * kDh, osb = (long long)p.Sq * oss;
  const float* kb = p.k + b * p.ksb + h * p.ksh;
  const float* vb = p.v + b * p.vsb + h * p.vsh;
  const float* bias_bh = p.bias + b * p.bsb + h * p.bsh;
  const float* kbb = kKeyBias ? p.key_bias + b * p.kbsb : nullptr;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  if (live) {
    load_tile<kDh>(Qs, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.Sq);
    load_tile<kDh>(dOs, p.dout + b * osb + (long long)h * kDh, oss, q0, p.Sq);
    load_tile<kDh>(Ks, kb, p.kss, 0, p.Sk);
    if (!kLateV) load_tile<kDh>(Vs, vb, p.vss, 0, p.Sk);
    if (kKeyBias) load_key_bias(KBs, kbb, 0, p.Sk);
  }
  cp_async_commit();
  if constexpr (kLateV) {  // V's copies in groups of their own
    if (live) load_tile<kDh>(Vs, vb, p.vss, 0, p.Sk);
    cp_async_commit();
  }
  if (!live) {  // zeros in every buffer this block stages in
    float* z = kOwnStage ? DSs : Vs;
    for (int i = threadIdx.x; i < (kOwnStage ? 2 * kTile * kStageLd : 2 * kTileFloats);
         i += kThreads)
      z[i] = 0.f;
  }

  // rows q0 + r0 + g (c0, c1) and q0 + r0 + g + 8 (c2, c3); rows past Sq
  // are never written, so only keys are masked
  const int row = q0 + r0 + g;
  float mx[2], lgl[2], dlt[2];  // m, log l, D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = live && row + 8 * i < p.Sq;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row + 8 * i;
    mx[i] = ok ? p.lse[idx] : 0.f;
    lgl[i] = ok ? p.lse[(long long)p.B * p.H * p.Sq + idx] : 0.f;
    dlt[i] = ok ? p.delta[idx] : 0.f;
  }
  float dq[W::kSteps][4];
#pragma unroll
  for (int n = 0; n < W::kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile, nxt = (j + 1) & 1;
    const float* Kt = Ks + (j & 1) * kTileFloats;
    const float* Vt = Vs + (j & 1) * kTileFloats;
    if (live && j + 1 < n_tiles) {  // into the buffers that tile j - 1 used
      load_tile<kDh>(Ks + nxt * kTileFloats, kb, p.kss, k0 + kTile, p.Sk);
      if (!kLateV) load_tile<kDh>(Vs + nxt * kTileFloats, vb, p.vss, k0 + kTile, p.Sk);
      if (kKeyBias) load_key_bias(KBs + nxt * kTile, kbb, k0 + kTile, p.Sk);
    }
    cp_async_commit();
    // tile j's copies: all groups but the one just committed (and V_j's
    // before it, kLateV)
    if (kLateV) cp_async_wait_prev2();
    else cp_async_wait_prev();
    __syncthreads();

    float s[kKeySteps][4];
    if (live) {
      // S = Q K^T and dP = dO V^T over this warp's 16 rows
      float dp[kKeySteps][4];
      product_abt<kDh>(s, Qs + rows_off, r0, Kt + rows_off);
      if constexpr (kLateV) {
        cp_async_wait_prev();  // V_j's group too
        __syncthreads();
      }
      product_abt<kDh>(dp, dOs + rows_off, r0, Vt + rows_off);
      scale_bias<kKeyBias>(s, p, bias_bh, KBs + (j & 1) * kTile + 2 * t, row, k0 + 2 * t);
      if (k0 + kTile > p.Sk) mask_cols(s, k0 + 2 * t, p.Sk);
      // dS = P o (dP - D), P = exp((S - m) - log l): 0 for a masked key
#pragma unroll
      for (int n = 0; n < kKeySteps; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2_approx(((s[n][e] - mx[e >> 1]) - lgl[e >> 1]) * kLog2e) *
                    (dp[n][e] - dlt[e >> 1]);
    }
    float* stage = kOwnStage ? DSs + (j & 1) * kTile * kStageLd : Vs + (j & 1) * kTileFloats;
    if (live) {
      if (!kOwnStage) __syncthreads();  // every warp is past its last read of V_j
      stage_ds(stage, s, r0 + g, 2 * t);
    }
    // One cluster barrier a tile: arriving, a block has staged tile j and
    // read its peers' tile j - 1 (staged in the other buffer), so once
    // every peer has arrived that buffer is free to stage (or refill) again
    cluster_arrive();
    if (live) product_cx<kDh>(dq, s, Kt + cols_off);  // dQ += dS K
    cluster_wait();
    if constexpr (kLateV) {  // V_{j+1} into tile j - 1's staged buffer
      if (live && j + 1 < n_tiles)
        load_tile<kDh>(Vs + nxt * kTileFloats, vb, p.vss, k0 + kTile, p.Sk);
      cp_async_commit();
    }
    reduce_ds(p, stage, b / p.cluster, h, q0, k0);
    __syncthreads();  // every warp is done with tile j's buffers
  }

  if (live)
    store_rows<kDh>(p.out + b * osb + (long long)h * kDh, oss, row, p.Sq, dq, p.scale, p.scale,
                    t);
  // no peer reads this block's staged tiles once it exits
  cluster_arrive();
  cluster_wait();
}

// dynamic shared memory of the dbias kernel, without and with a key bias:
// Q, dO, two K and two V tiles, two key-bias tiles, and two staging tiles
// of their own where V's rows are not kStageLd floats
template <int kDh>
struct Smem {
  static constexpr size_t kTileBytes = Width<kDh>::kTileFloats * sizeof(float);
  static constexpr size_t kStage =
      Width<kDh>::kLd == kStageLd ? 0 : 2 * kTile * kStageLd * sizeof(float);
  static constexpr size_t kDqDbias = 6 * kTileBytes + kStage;
  static constexpr size_t kDqDbiasKb = kDqDbias + 2 * kTile * sizeof(float);
};

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const void* key_bias, int B, int H, int Sq, int Sk, long long qsb,
                   long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
                   long long bsq, long long bsk, long long kbsb, float scale) {
  Params p = {};
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
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

// The dQ kernel's dbias instance (a bias and its gradient only), for the
// occupancy query and the launch.
template <int kDh, bool kKB>
struct DbiasInstance {
  static constexpr size_t smem = kKB ? Smem<kDh>::kDqDbiasKb : Smem<kDh>::kDqDbias;

  // ``cfg`` launches ``grid`` in clusters of ``cluster`` blocks along z.
  static void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, dim3 grid, int cluster,
                     cudaStream_t stream) {
    attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = (unsigned)cluster;
    cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }

  // cudaOccupancyMaxActiveClusters for clusters of ``cluster`` blocks.
  static cudaError_t max_clusters(int cluster, int* n) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_dbias_kernel<kDh, kKB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(cfg, attr, dim3(1, 1, cluster), cluster, nullptr);
    return cudaOccupancyMaxActiveClusters(n, flash_bwd_dq_dbias_kernel<kDh, kKB>, &cfg);
  }

  // Refused (cudaErrorInvalidConfiguration) where the card holds no such
  // cluster at once: its blocks must run together.
  static cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
    int n = 0;
    cudaError_t err = max_clusters(p.cluster, &n);
    if (err != cudaSuccess) return err;
    if (n == 0) return cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(cfg, attr, grid, p.cluster, stream);
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dq_dbias_kernel<kDh, kKB>, p);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

// The dbias kernel at head dim kDh, with a key bias or not
template <int kDh>
cudaError_t launch_dbias(const Params& p, dim3 grid, cudaStream_t stream) {
  return p.key_bias != nullptr ? DbiasInstance<kDh, true>::launch(p, grid, stream)
                               : DbiasInstance<kDh, false>::launch(p, grid, stream);
}

}  // namespace

// O [B, Sq, H, Dh] and m, log l [2, B, H, Sq], both contiguous; Dh is 64
// or 34.  q, k and v start every row on 16 bytes at head dim 64; at head dim
// 34 their heads are packed (head stride 34), their row and batch strides
// are multiples of 4 floats and their base is on 16 bytes (the wrapper
// checks, and copies what is not).  bias and key_bias may be null.
extern "C" int vq_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* key_bias,
    void* out, void* lse, int B, int H, int Sq, int Sk, int Dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long bsb, long long bsh, long long bsq,
    long long bsk, long long kbsb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  Params p = make_params(q, k, v, bias, key_bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, kbsb, scale);
  p.out = (float*)out;
  p.out_lse = (float*)lse;
  return (int)vqflash::tf32_fwd(p, Dh, (cudaStream_t)stream);
}

// dQ [B, Sq, H, Dh], dK and dV [B, Sk, H, Dh], all contiguous; o and dout
// contiguous [B, Sq, H, Dh], dout on 16 bytes (and H * 34 a multiple of 4 at
// head dim 34: TMA reads its rows); delta a [B, H, Sq] scratch.
// dbias, when not null, receives the bias's gradient (a bias must be given),
// contiguous [planes, H, Sq, Sk]: for a bias read with batch stride 0 and
// B > 1 (broadcast over B), dS summed over B by clusters of C = min(B, 8)
// blocks, one plane at B <= 8, else G = ceil(B / 8) planes of partial sums
// whose plane 0 then receives their sum; for any other bias dS itself, B
// planes.
extern "C" int vq_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* key_bias,
    const void* o, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, void* dbias, int B, int H, int Sq, int Sk, int Dh, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
    long long bsq, long long bsk, long long kbsb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Dh != 64 && Dh != 34) return (int)cudaErrorInvalidValue;
  if (dbias != nullptr && bias == nullptr) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, bias, key_bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, kbsb, scale);
  p.o = (const float*)o;
  p.lse = (const float*)lse;
  p.dout = (const float*)dout;
  p.out = (float*)dq;
  p.dk = (float*)dk;
  p.dv = (float*)dv;
  p.delta = (float*)delta;
  p.dbias = (float*)dbias;
  const bool over_b = dbias != nullptr && B > 1 && bsb == 0;  // dbias sums over B
  p.cluster = over_b ? (B < kMaxCluster ? B : kMaxCluster) : 1;
  const int groups = (B + p.cluster - 1) / p.cluster;
  cudaStream_t s = (cudaStream_t)stream;

  const long long rows = (long long)B * H * Sq;
  long long blocks = (rows + 7) / 8;  // 8 warps of 256 threads, a row each
  if (blocks > 65535) blocks = 65535;
  if (Dh == 64)
    flash_bwd_delta_kernel<64><<<(unsigned)blocks, 256, 0, s>>>(p);
  else
    flash_bwd_delta_kernel<34><<<(unsigned)blocks, 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the Hopper kernels (flash_attention_tf32.cu) but, with dbias, this
  // file's dbias kernel for dQ
  err = vqflash::tf32_dkv(p, Dh, s);
  if (err != cudaSuccess) return (int)err;
  if (dbias == nullptr) return (int)vqflash::tf32_dq(p, Dh, s);
  // 64-row query tiles, B rounded up to whole clusters
  const dim3 dbias_grid((Sq + kTile - 1) / kTile, H, groups * p.cluster);
  err = Dh == 64 ? launch_dbias<64>(p, dbias_grid, s) : launch_dbias<34>(p, dbias_grid, s);
  if (err != cudaSuccess || !over_b || groups == 1) return (int)err;
  const long long n = (long long)H * Sq * Sk;
  long long sum_blocks = (n + 255) / 256;
  if (sum_blocks > 65535) sum_blocks = 65535;
  dbias_plane_sum_kernel<<<(unsigned)sum_blocks, 256, 0, s>>>(p.dbias, n, groups);
  return (int)cudaGetLastError();
}

// The most clusters of ``cluster`` blocks of the dbias instance at head dim
// Dh, with a key bias or not, that the card holds at once
// (cudaOccupancyMaxActiveClusters); minus the CUDA error where the query
// fails.
extern "C" int vq_flash_attention_dbias_clusters(int Dh, int key_bias, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || (Dh != 64 && Dh != 34))
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t err;
  if (Dh == 64)
    err = key_bias ? DbiasInstance<64, true>::max_clusters(cluster, &n)
                   : DbiasInstance<64, false>::max_clusters(cluster, &n);
  else
    err = key_bias ? DbiasInstance<34, true>::max_clusters(cluster, &n)
                   : DbiasInstance<34, false>::max_clusters(cluster, &n);
  return err == cudaSuccess ? n : -(int)err;
}
