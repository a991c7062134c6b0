// Flash attention, forward and backward, bfloat16 q/k/v, head dim 64, on the
// tensor cores: one bf16 mma.sync pass per product, float32 accumulation.
//
// Replaces the TPU kernel behind vqattack_tpu/ops/attention.py::flash_attention
// when the surrogate trunk computes in bfloat16 (--dtype bfloat16): the JAX
// wrapper hands the library kernel (jax.experimental.pallas.ops.tpu.
// flash_attention: forward, dq and dkv pallas_calls) bf16 q/k/v and a float32
// bias, and the library multiplies bf16 operands with float32 accumulation.
// This kernel computes the same function, rounding where the library rounds:
//
//   forward   S = Q K^T * scale + bias + key_bias  (float32 from bf16 Q, K),
//             L = logsumexp_rows(S),  O = bf16( (bf16(P~) V) / l )
//             with P~ = exp(S - running max), l its float32 row sum
//   backward  D_i = sum_d dO_id O_id  (float32 from bf16 dO, O),
//             P = exp(S - L),  dV = bf16(P)^T dO,  dP = dO V^T,
//             dS = P o (dP - D),  dQ = scale * bf16(dS) K,
//             dK = scale * bf16(dS)^T Q
//
// (P cast before P V and P^T dO, dS before dS K and dS^T Q, as the library's
// forward, dkv and dq kernels cast them; scale is 1/8 for head dim 64, a
// power of two, so scaling dS before or after its rounding gives the same
// bits.)  O, dQ, dK, dV come back bf16, L float32.  The layout contract is
// that of flash_attention.cu: q/k/v through their [B, S, H, 64] element
// strides, O/dQ/dK/dV contiguous [B, S, H, 64], L and D [B, H, Sq], the bias
// through broadcast strides and the key bias ([1|B, Sk]) as a vector, both
// float32 and both optional; ragged lengths masked inside the kernel.
//
// Bound on the H100: operations.  At ALBEF's batched chunk [8, 901, 12, 64]
// the forward needs 4 B*H*S^2*Dh = 20.0 GFLOP, 20 us at the dense bf16 rate
// (989 TFLOP/s), against 44 MB of bf16 q, k, v and o (13 us at 3.35 TB/s);
// the backward, recomputing P from L, 10x (50 GFLOP, 50 us).
//
// Design (simple first; wgmma and TMA are a later step):
// - every product is mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32; one block
//   of 4 warps per 64-row query tile (forward, dQ) or key tile (dK/dV), 16
//   rows a warp; the block's own 64 rows of Q (forward, dQ: and dO) or of K
//   and V (dK/dV) are read into A fragments once and held in registers;
// - fragments come from shared memory by ldmatrix, with .trans for the
//   operands whose depth runs down the tile's rows (V in P V, dO in P^T dO,
//   Q in dS^T Q, K in dS K), which bf16 allows and TF32 did not;
// - the m16n8k16 accumulator of two neighbouring 8-column tiles is, element
//   for element, the A fragment of a 16-deep step: P and dS go from the
//   score accumulators to the next product's A operand in registers, by one
//   float -> bf16x2 conversion a pair (the rounding above);
// - 64 x 64 tiles with rows padded to 72 bf16 (144 bytes): the 8 rows an
//   ldmatrix phase reads start 4 banks apart, 32 distinct banks;
// - tiles arrive by 16-byte cp.async (zero-filled past Sq or Sk), double
//   buffered; the bias, read from device memory, and the key bias, 64
//   float32 a key tile in shared memory, are template parameters as in the
//   float32 kernel;
// - the backward has the float32 kernel's structure (a D pass, dK/dV over
//   key tiles, dQ over query tiles, no atomics): every sum runs in a fixed
//   order, so the result is the same bit for bit on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kLd = kD + 8;     // shared-memory row, in bf16 (144 bytes)
constexpr int kWarps = 4;       // 16 rows of a tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kTileElems = kTile * kLd;
constexpr int kKSteps = kD / 16;  // 16-deep mma steps over 64 columns (or keys)
constexpr int kNTiles = kD / 8;   // 8-wide accumulator tiles over 64 columns
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;      // nullptr: no bias
  const float* key_bias;  // nullptr: no key bias; [1|B, Sk]
  const bf16* o;          // backward: forward output, contiguous [B, Sq, H, 64]
  const float* lse;       // backward: [B, H, Sq]
  const bf16* dout;       // backward: contiguous [B, Sq, H, 64]
  bf16* out;              // forward: O; backward: dQ   (contiguous [B, Sq, H, 64])
  float* out_lse;         // forward: L [B, H, Sq]
  bf16* dk;               // contiguous [B, Sk, H, 64]
  bf16* dv;               // contiguous [B, Sk, H, 64]
  float* delta;           // backward: D [B, H, Sq]
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long bsb, bsh, bsq, bsk;
  long long kbsb;  // the key bias's batch stride (0: broadcast)
  int B, H, Sq, Sk;
  float scale;
};

// ---------------------------------------------------------------------------
// shared-memory tiles and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the one just committed) is in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a tile by 16-byte
// copies (8 bf16); rows past ``nrows`` are zero-filled.  ``base`` points at
// row 0, 16-byte aligned, as is every row (the wrapper checks).
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* base, long long row_stride,
                                          int row0, int nrows) {
  for (int idx = threadIdx.x; idx < kTile * kD / 8; idx += kThreads) {
    const int r = idx >> 3, c = (idx & 7) << 3;
    const int row = row0 + r;
    const bool ok = row < nrows;
    cp_async16(sm + r * kLd + c, ok ? base + row * row_stride + c : base, ok);
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

// L and D of query rows [q0, q0 + 64) (0 past Sq); ``off`` is (b, h)'s row 0.
__device__ __forceinline__ void load_rows(const Params& p, float* Ls, float* Ds,
                                          long long off, int q0) {
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < p.Sq;
    cp_async4(Ls + threadIdx.x, ok ? p.lse + off + row : p.lse, ok);
    cp_async4(Ds + threadIdx.x, ok ? p.delta + off + row : p.delta, ok);
  }
}

// ---------------------------------------------------------------------------
// bf16 fragments and products
//
// A thread (lane) holds, with g = lane / 4 and t = lane % 4 (two bf16 a
// register, the lower column in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..);
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)   (rows are the depth);
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// ldmatrix.x4 takes one row address from each lane: lanes 8m..8m+7 give the
// 8 rows of matrix m, and register m of every lane receives matrix m.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// 2^x in one instruction (denormal results flush to 0, a weight that does
// not count next to the row's largest, which is 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Per-lane element offsets of the ldmatrix row addresses:
// - A from a row-major tile (rows r.., columns k..): matrices (rows 0-7,
//   cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) = a0..a3;
// - B = X^T from X stored [n][k] (no transpose): matrices (n 0-7, k 0-7),
//   (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) = b0, b1 of the
//   8-column tile n0 and b0, b1 of the tile n0 + 8;
// - B = X from X stored [k][n] (.trans): matrices (k 0-7, n 0-7), (k 8-15,
//   n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15), the same four registers.
struct LaneOffsets {
  int a, b, bt;
  __device__ __forceinline__ LaneOffsets(int lane)
      : a((lane & 15) * kLd + (lane >> 4) * 8),
        b(((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8),
        bt(((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + ((lane >> 4) << 3)) {}
};

// The A fragments of rows [r0, r0 + 16) of a tile over its 64 columns.
__device__ __forceinline__ void load_a_rows(uint32_t a[kKSteps][4], const bf16* tile, int r0,
                                            const LaneOffsets& lo) {
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) ldsm_x4(a[kk], tile + r0 * kLd + lo.a + 16 * kk);
}

// acc = A X^T: A held as fragments (16 rows x 64), X a 64 x 64 tile stored
// [n][k]; a 16 x 64 product over 64 columns.
__device__ __forceinline__ void product_abt(float acc[kNTiles][4], const uint32_t a[kKSteps][4],
                                            const bf16* x, const LaneOffsets& lo) {
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int np = 0; np < kNTiles / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, x + lo.b + 16 * np * kLd + 16 * kk);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// acc += bf16(C) X, C a 16 x 64 float32 accumulator tile (c[j] its columns
// 8j..8j+7), rounded to bf16 as it becomes the A operand, and X a 64 x 64
// tile stored [k][n].
__device__ __forceinline__ void product_cx(float acc[kNTiles][4], const float c[kNTiles][4],
                                           const bf16* x, const LaneOffsets& lo) {
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const uint32_t a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < kNTiles / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, x + lo.bt + 16 * kk * kLd + 16 * np);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
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
// element (n, e) sits at row r + 8 (e / 2) and column c + 8 n + (e % 2)
// (r = its first row + g, c = its first column + 2t).  Rows are queries and
// columns keys, or the other way round (``kKeyRows``).  The bias index is
// clamped, so that rows and columns past Sq and Sk (masked or never written)
// read in bounds.  ``kbs`` is the key-bias tile in shared memory, offset to
// this thread's first key: + 2t for key columns, + the warp's first row + g
// for key rows.
template <bool kBias, bool kKeyBias, bool kKeyRows>
__device__ __forceinline__ void scale_bias(float s[kNTiles][4], const Params& p,
                                           const float* bias_bh, const float* kbs, int r,
                                           int c) {
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * p.scale;
      if (kBias) {
        const int row = r + 8 * (e >> 1), col = c + 8 * n + (e & 1);
        const int qi = min(kKeyRows ? col : row, p.Sq - 1);
        const int kj = min(kKeyRows ? row : col, p.Sk - 1);
        x += bias_bh[qi * p.bsq + kj * p.bsk];
      }
      if (kKeyBias) x += kKeyRows ? kbs[8 * (e >> 1)] : kbs[8 * n + (e & 1)];
      s[n][e] = x;
    }
}

// s = -inf in the columns c + 8 n + (e % 2) at or past ``n_valid``.
__device__ __forceinline__ void mask_cols(float s[kNTiles][4], int c, int n_valid) {
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + 8 * n + (e & 1) >= n_valid) s[n][e] = -INFINITY;
}

// Store rows r and r + 8 of a 16 x 64 accumulator tile times ``mul``, as
// bf16, to two rows of a contiguous [B, S, H, 64] tensor; rows at or past
// ``nrows`` are not written.
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row, int nrows,
                                           const float acc[kNTiles][4], float mul0, float mul1,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= nrows) continue;
    const float mul = i == 0 ? mul0 : mul1;
    bf16* dst = base + r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTileElems;      // two buffers
  bf16* Vs = Ks + 2 * kTileElems;  // two buffers
  float* KBs = reinterpret_cast<float*>(Vs + 2 * kTileElems);  // two buffers of 64

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's rows of the tile
  const LaneOffsets lo(lane);
  const bf16* kb = p.k + b * p.ksb + h * p.ksh;
  const bf16* vb = p.v + b * p.vsb + h * p.vsh;
  const float* bias_bh = kBias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const float* kbb = kKeyBias ? p.key_bias + b * p.kbsb : nullptr;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  load_tile(Qs, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.Sq);
  load_tile(Ks, kb, p.kss, 0, p.Sk);
  load_tile(Vs, vb, p.vss, 0, p.Sk);
  if (kKeyBias) load_key_bias(KBs, kbb, 0, p.Sk);
  cp_async_commit();

  // rows q0 + r0 + g (i = 0: c0, c1) and q0 + r0 + g + 8 (i = 1: c2, c3)
  const int row = q0 + r0 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qa[kKSteps][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    const bf16* Kt = Ks + (j & 1) * kTileElems;
    const bf16* Vt = Vs + (j & 1) * kTileElems;
    if (j + 1 < n_tiles) {  // into the buffers that tile j - 1 used
      load_tile(Ks + ((j + 1) & 1) * kTileElems, kb, p.kss, k0 + kTile, p.Sk);
      load_tile(Vs + ((j + 1) & 1) * kTileElems, vb, p.vss, k0 + kTile, p.Sk);
      if (kKeyBias) load_key_bias(KBs + ((j + 1) & 1) * kTile, kbb, k0 + kTile, p.Sk);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (j == 0) load_a_rows(qa, Qs, r0, lo);

    float s[kNTiles][4];
    product_abt(s, qa, Kt, lo);
    scale_bias<kBias, kKeyBias, false>(s, p, bias_bh, KBs + (j & 1) * kTile + 2 * t, row,
                                       k0 + 2 * t);
    if (k0 + kTile > p.Sk) mask_cols(s, k0 + 2 * t, p.Sk);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float m_ref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      // -inf while every key so far is masked (a -inf bias): exponentiate
      // against 0 instead, so that alpha and every p come out 0, not NaN
      m_ref[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2_approx((m[i] - m_ref[i]) * kLog2e);  // 0 on the first tile
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx((s[n][e] - m_ref[e >> 1]) * kLog2e);  // 0 for a masked key
        rs[e >> 1] += s[n][e];
        acc[n][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);

    product_cx(acc, s, Vt, lo);  // O += bf16(P) V
    __syncthreads();  // every warp is done with tile j's buffers
  }

  const long long oss = (long long)p.H * kD, osb = (long long)p.Sq * oss;
  store_rows(p.out + b * osb + (long long)h * kD, oss, row, p.Sq, acc, 1.f / l[0], 1.f / l[1], t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + 8 * i < p.Sq)
        p.out_lse[((long long)b * p.H + h) * p.Sq + row + 8 * i] = m[i] + logf(l[i]);
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in float32: one warp per
// row, two bf16 a lane.
__global__ void flash_bwd_delta_kernel(const Params p) {
  const long long n_rows = (long long)p.B * p.H * p.Sq;
  const int lane = threadIdx.x & 31;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < n_rows;
       w += n_warps) {
    const int i = (int)(w % p.Sq);
    const long long bh = w / p.Sq;
    const int h = (int)(bh % p.H), b = (int)(bh / p.H);
    const long long off = (((long long)b * p.Sq + i) * p.H + h) * kD + 2 * lane;
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.dout + off));
    const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.o + off));
    float s = d.x * o.x + d.y * o.y;
    for (int sh = 16; sh > 0; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
    if (lane == 0) p.delta[w] = s;
  }
}

template <bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileElems;
  bf16* Qs = Vs + kTileElems;        // two buffers
  bf16* dOs = Qs + 2 * kTileElems;   // two buffers
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kTileElems);  // two buffers of 64
  float* Ds = Ls + 2 * kTile;        // two buffers of 64
  float* KBs = Ds + 2 * kTile;       // 64, the block's keys (with a key bias)

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's keys of the tile
  const LaneOffsets lo(lane);
  const long long oss = (long long)p.H * kD, osb = (long long)p.Sq * oss;
  const bf16* qb = p.q + b * p.qsb + h * p.qsh;
  const bf16* dob = p.dout + b * osb + (long long)h * kD;
  const long long rows_bh = ((long long)b * p.H + h) * p.Sq;
  const float* bias_bh = kBias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const int n_tiles = (p.Sq + kTile - 1) / kTile;

  load_tile(Ks, p.k + b * p.ksb + h * p.ksh, p.kss, k0, p.Sk);
  load_tile(Vs, p.v + b * p.vsb + h * p.vsh, p.vss, k0, p.Sk);
  if (kKeyBias) load_key_bias(KBs, p.key_bias + b * p.kbsb, k0, p.Sk);
  load_tile(Qs, qb, p.qss, 0, p.Sq);
  load_tile(dOs, dob, oss, 0, p.Sq);
  load_rows(p, Ls, Ds, rows_bh, 0);
  cp_async_commit();

  // keys k0 + r0 + g (c0, c1) and k0 + r0 + g + 8 (c2, c3); columns are
  // queries.  Keys past Sk are never written, so only queries are masked.
  const int key = k0 + r0 + g;
  float dk[kNTiles][4], dv[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  uint32_t ka[kKSteps][4], va[kKSteps][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * kTile, buf = j & 1, nxt = (j + 1) & 1;
    const bf16* Qt = Qs + buf * kTileElems;
    const bf16* dOt = dOs + buf * kTileElems;
    const float* Lt = Ls + buf * kTile + 2 * t;
    const float* Dt = Ds + buf * kTile + 2 * t;
    if (j + 1 < n_tiles) {  // into the buffers that tile j - 1 used
      load_tile(Qs + nxt * kTileElems, qb, p.qss, q0 + kTile, p.Sq);
      load_tile(dOs + nxt * kTileElems, dob, oss, q0 + kTile, p.Sq);
      load_rows(p, Ls + nxt * kTile, Ds + nxt * kTile, rows_bh, q0 + kTile);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (j == 0) {
      load_a_rows(ka, Ks, r0, lo);
      load_a_rows(va, Vs, r0, lo);
    }

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys
    float pt[kNTiles][4], dst[kNTiles][4];
    product_abt(pt, ka, Qt, lo);
    product_abt(dst, va, dOt, lo);
    scale_bias<kBias, kKeyBias, true>(pt, p, bias_bh, KBs + r0 + g, key, q0 + 2 * t);
    if (q0 + kTile > p.Sq) mask_cols(pt, q0 + 2 * t, p.Sq);
    // P^T = exp(S^T - L) and dS^T = P^T o (dP^T - D): 0 for a masked query
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + (e & 1);
        pt[n][e] = exp2_approx((pt[n][e] - Lt[i]) * kLog2e);
        dst[n][e] = pt[n][e] * (dst[n][e] - Dt[i]);
      }
    product_cx(dv, pt, dOt, lo);  // dV += bf16(P^T) dO
    product_cx(dk, dst, Qt, lo);  // dK += bf16(dS^T) Q
    __syncthreads();  // every warp is done with tile j's buffers
  }

  const long long kss = (long long)p.H * kD, ksb = (long long)p.Sk * kss;
  const long long off = b * ksb + (long long)h * kD;
  store_rows(p.dk + off, kss, key, p.Sk, dk, p.scale, p.scale, t);
  store_rows(p.dv + off, kss, key, p.Sk, dv, 1.f, 1.f, t);
}

template <bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTileElems;
  bf16* Ks = dOs + kTileElems;     // two buffers
  bf16* Vs = Ks + 2 * kTileElems;  // two buffers
  float* KBs = reinterpret_cast<float*>(Vs + 2 * kTileElems);  // two buffers of 64

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's rows of the tile
  const LaneOffsets lo(lane);
  const long long oss = (long long)p.H * kD, osb = (long long)p.Sq * oss;
  const bf16* kb = p.k + b * p.ksb + h * p.ksh;
  const bf16* vb = p.v + b * p.vsb + h * p.vsh;
  const float* bias_bh = kBias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const float* kbb = kKeyBias ? p.key_bias + b * p.kbsb : nullptr;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  load_tile(Qs, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.Sq);
  load_tile(dOs, p.dout + b * osb + (long long)h * kD, oss, q0, p.Sq);
  load_tile(Ks, kb, p.kss, 0, p.Sk);
  load_tile(Vs, vb, p.vss, 0, p.Sk);
  if (kKeyBias) load_key_bias(KBs, kbb, 0, p.Sk);
  cp_async_commit();

  // rows q0 + r0 + g (c0, c1) and q0 + r0 + g + 8 (c2, c3); rows past Sq
  // are never written, so only keys are masked
  const int row = q0 + r0 + g;
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row + 8 * i < p.Sq;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row + 8 * i;
    lse[i] = ok ? p.lse[idx] : 0.f;
    dlt[i] = ok ? p.delta[idx] : 0.f;
  }
  float dq[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  uint32_t qa[kKSteps][4], doa[kKSteps][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    const bf16* Kt = Ks + (j & 1) * kTileElems;
    const bf16* Vt = Vs + (j & 1) * kTileElems;
    if (j + 1 < n_tiles) {  // into the buffers that tile j - 1 used
      load_tile(Ks + ((j + 1) & 1) * kTileElems, kb, p.kss, k0 + kTile, p.Sk);
      load_tile(Vs + ((j + 1) & 1) * kTileElems, vb, p.vss, k0 + kTile, p.Sk);
      if (kKeyBias) load_key_bias(KBs + ((j + 1) & 1) * kTile, kbb, k0 + kTile, p.Sk);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (j == 0) {
      load_a_rows(qa, Qs, r0, lo);
      load_a_rows(doa, dOs, r0, lo);
    }

    // S = Q K^T and dP = dO V^T over this warp's 16 rows
    float s[kNTiles][4], dp[kNTiles][4];
    product_abt(s, qa, Kt, lo);
    product_abt(dp, doa, Vt, lo);
    scale_bias<kBias, kKeyBias, false>(s, p, bias_bh, KBs + (j & 1) * kTile + 2 * t, row,
                                       k0 + 2 * t);
    if (k0 + kTile > p.Sk) mask_cols(s, k0 + 2 * t, p.Sk);
    // dS = P o (dP - D), P = exp(S - L): 0 for a masked key
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = exp2_approx((s[n][e] - lse[e >> 1]) * kLog2e) * (dp[n][e] - dlt[e >> 1]);
    product_cx(dq, s, Kt, lo);  // dQ += bf16(dS) K
    __syncthreads();  // every warp is done with tile j's buffers
  }

  store_rows(p.out + b * osb + (long long)h * kD, oss, row, p.Sq, dq, p.scale, p.scale, t);
}

// dynamic shared memory of each kernel, without and with a key bias
constexpr size_t kTileBytes = kTileElems * sizeof(bf16);
constexpr size_t kFwdSmem = 5 * kTileBytes;
constexpr size_t kDkvSmem = 6 * kTileBytes + 4 * kTile * sizeof(float);
constexpr size_t kDqSmem = 6 * kTileBytes;
constexpr size_t kFwdSmemKb = kFwdSmem + 2 * kTile * sizeof(float);
constexpr size_t kDkvSmemKb = kDkvSmem + kTile * sizeof(float);
constexpr size_t kDqSmemKb = kDqSmem + 2 * kTile * sizeof(float);

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
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instance of a kernel for the terms present: ``L::run<kBias, kKeyBias>``.
template <typename L>
cudaError_t dispatch(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.bias != nullptr)
    return p.key_bias != nullptr ? L::template run<true, true>(p, grid, stream)
                                 : L::template run<true, false>(p, grid, stream);
  return p.key_bias != nullptr ? L::template run<false, true>(p, grid, stream)
                               : L::template run<false, false>(p, grid, stream);
}

struct Fwd {
  template <bool kB, bool kKB>
  static cudaError_t run(const Params& p, dim3 grid, cudaStream_t s) {
    return launch(flash_fwd_kernel<kB, kKB>, grid, kKB ? kFwdSmemKb : kFwdSmem, s, p);
  }
};
struct Dkv {
  template <bool kB, bool kKB>
  static cudaError_t run(const Params& p, dim3 grid, cudaStream_t s) {
    return launch(flash_bwd_dkv_kernel<kB, kKB>, grid, kKB ? kDkvSmemKb : kDkvSmem, s, p);
  }
};
struct Dq {
  template <bool kB, bool kKB>
  static cudaError_t run(const Params& p, dim3 grid, cudaStream_t s) {
    return launch(flash_bwd_dq_kernel<kB, kKB>, grid, kKB ? kDqSmemKb : kDqSmem, s, p);
  }
};

}  // namespace

// O [B, Sq, H, 64] bf16 and L [B, H, Sq] float32, both contiguous.  q, k and
// v (bf16) start every row on 16 bytes (the wrapper checks).  bias and
// key_bias (float32) may be null.
extern "C" int vq_flash_attention_bf16_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* key_bias,
    void* out, void* lse, int B, int H, int Sq, int Sk, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long bsb, long long bsh, long long bsq,
    long long bsk, long long kbsb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  Params p = make_params(q, k, v, bias, key_bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, kbsb, scale);
  p.out = (bf16*)out;
  p.out_lse = (float*)lse;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  return (int)dispatch<Fwd>(p, grid, (cudaStream_t)stream);
}

// dQ [B, Sq, H, 64], dK and dV [B, Sk, H, 64], all bf16 and contiguous; o and
// dout contiguous bf16 [B, Sq, H, 64], dout 16-byte aligned; delta a float32
// [B, H, Sq] scratch.
extern "C" int vq_flash_attention_bf16_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* key_bias,
    const void* o, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int B, int H, int Sq, int Sk, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
    long long bsq, long long bsk, long long kbsb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
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

  const long long rows = (long long)B * H * Sq;
  long long blocks = (rows + 7) / 8;  // 8 warps of 256 threads, a row each
  if (blocks > 65535) blocks = 65535;
  flash_bwd_delta_kernel<<<(unsigned)blocks, 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((Sk + kTile - 1) / kTile, H, B), q_grid((Sq + kTile - 1) / kTile, H, B);
  err = dispatch<Dkv>(p, kv_grid, s);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<Dq>(p, q_grid, s);
}
