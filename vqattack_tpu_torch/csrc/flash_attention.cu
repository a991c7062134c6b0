// Flash attention, forward and backward, float32, head dim 64.
//
// Replaces the TPU kernel behind vqattack_tpu/ops/attention.py::flash_attention,
// which wraps jax.experimental.pallas.ops.tpu.flash_attention (its forward,
// dq-backward and dkv-backward pallas_calls) after padding the sequence to a
// multiple of 128 (_prepare) and, with a bias, materializing a dense
// [B, H, Sq_p, Sk_p] bias.  This kernel computes the same function, not the
// TPU kernel's blocks:
//
//   forward   S = Q K^T * scale + bias,  L = logsumexp_rows(S),
//             O = softmax(S) V           (L saved for the backward)
//   backward  D_i = sum_d dO_id O_id,    P = exp(S - L),
//             dV = P^T dO,  dS = P o (dO V^T - D),
//             dQ = scale * dS K,  dK = scale * dS^T Q
//
// for every (batch, head), with q/k/v read through their [B, S, H, 64]
// strides, O/dQ/dK/dV written as contiguous [B, S, H, 64] and L, D as
// [B, H, Sq].  The bias is optional, additive after the scale, and read
// through broadcast strides (0 along a broadcast dimension), so a
// [1, H, S, S] table or a [B, 1, 1, Sk] key mask is never materialized at
// [B, H, Sq, Sk].  Ragged lengths need no padding: keys j >= Sk are masked
// inside the kernel and rows i >= Sq are never written.
//
// Bound on the H100: operations.  At the main path's shape (B=16, H=12,
// S=901, Dh=64) B*H*S^2*Dh = 9.98e9; the forward needs 4x that (39.9
// GFLOP) and the backward, recomputing P from L, 10x (99.8 GFLOP), against
// 177 MB of q, k, v and o (53 us at 3.35 TB/s).  On CUDA cores at the
// 67 TFLOP/s float32 peak that is 0.60 ms forward and 1.49 ms backward.
// The main path runs float32 with TF32 off, so tensor cores would change
// the numbers; the products run as FMAs on CUDA cores.
//
// Design (right and simple; wgmma/TMA/bf16 are later work):
// - one block of 256 threads per (64-row tile, head, batch); the 16 x 16
//   threads each own a 4 x 4 sub-tile whose rows and columns are strided by
//   16, so that a half-warp shares its rows (broadcast shared-memory reads)
//   and its columns hit 16 distinct banks;
// - 64 x 64 float32 tiles in shared memory with rows padded to 65 floats;
// - forward: online softmax (running max and sum per row) in registers, row
//   reductions by shuffles inside the half-warp that owns a row;
// - backward: a pass for D, one kernel over key tiles that accumulates dK
//   and dV in registers while it walks every query tile, and one over query
//   tiles that accumulates dQ while it walks every key tile.  No atomics:
//   every sum runs in a fixed order, so the result is the same on every run.
//   The dQ kernel recomputes S and dO V^T, so the backward performs 14x
//   B*H*S^2*Dh where the bound counts 10x.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kTile = 64;     // rows of a query or key tile
constexpr int kLd = kD + 1;   // padded shared-memory row, in floats
constexpr int kThreads = 256;
constexpr int kTileFloats = kTile * kLd;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // nullptr: no bias
  const float* o;     // backward: forward output, contiguous [B, Sq, H, 64]
  const float* lse;   // backward: [B, H, Sq]
  const float* dout;  // backward: contiguous [B, Sq, H, 64]
  float* out;         // forward: O; backward: dQ   (contiguous [B, Sq, H, 64])
  float* out_lse;     // forward: L [B, H, Sq]
  float* dk;          // contiguous [B, Sk, H, 64]
  float* dv;          // contiguous [B, Sk, H, 64]
  float* delta;       // backward: D [B, H, Sq]
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long bsb, bsh, bsq, bsk;
  int B, H, Sq, Sk;
  float scale;
};

// Rows [row0, row0 + 64) of one (batch, head) slice into a padded shared
// tile; rows past ``nrows`` read as zero.  ``base`` points at row 0.
__device__ __forceinline__ void load_tile(float* __restrict__ sm,
                                          const float* __restrict__ base,
                                          long long row_stride, int row0,
                                          int nrows) {
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    const int row = row0 + r;
    sm[r * kLd + c] = row < nrows ? base[(long long)row * row_stride + c] : 0.f;
  }
}

// Reductions over the 16 lanes of a half-warp (the threads sharing a row).
__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over padded tiles.
__device__ __forceinline__ void tile_abt(const float* __restrict__ A,
                                         const float* __restrict__ Bt, int ty,
                                         int tx, float acc[4][4]) {
#pragma unroll 16
  for (int d = 0; d < kD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The scaled, biased score of (row, col), or -inf for a key past Sk.
__device__ __forceinline__ float score(const Params& p, const float* bias_bh,
                                       float s, int row, int col) {
  if (col >= p.Sk) return -INFINITY;
  float x = s * p.scale;
  if (bias_bh != nullptr && row < p.Sq) x += bias_bh[row * p.bsq + col * p.bsk];
  return x;
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = p.q + b * p.qsb + h * p.qsh;
  const float* kb = p.k + b * p.ksb + h * p.ksh;
  const float* vb = p.v + b * p.vsb + h * p.vsh;
  const float* bias_bh =
      p.bias == nullptr ? nullptr : p.bias + b * p.bsb + h * p.bsh;

  load_tile(Qs, qb, p.qss, q0, p.Sq);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.Sk; k0 += kTile) {
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_tile(Ks, kb, p.kss, k0, p.Sk);
    load_tile(Vs, vb, p.vss, k0, p.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt(Qs, Ks, ty, tx, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(p, bias_bh, s[i][j], row, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      // -inf while every key so far is masked (a -inf bias): exponentiate
      // against 0 instead, so that alpha and every pr come out 0, not NaN
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_ref);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s[i][j] - m_ref);  // 0 for a masked key
        Ps[(ty + 16 * i) * kLd + tx + 16 * j] = pr;
        rs += pr;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][d] += sum_k P[i][k] V[k][d], d = tx + 16 j
#pragma unroll 16
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  const long long oss = (long long)p.H * kD, osb = (long long)p.Sq * oss;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / l[i];
    float* orow = p.out + b * osb + row * oss + (long long)h * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) p.out_lse[((long long)b * p.H + h) * p.Sq + row] = m[i] + logf(l[i]);
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row.
__global__ void flash_bwd_delta_kernel(const Params p) {
  const long long n_rows = (long long)p.B * p.H * p.Sq;
  const int lane = threadIdx.x & 31;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       w < n_rows; w += n_warps) {
    const int i = (int)(w % p.Sq);
    const long long bh = w / p.Sq;
    const int h = (int)(bh % p.H), b = (int)(bh / p.H);
    const long long off = (((long long)b * p.Sq + i) * p.H + h) * kD;
    float s = p.dout[off + lane] * p.o[off + lane] +
              p.dout[off + lane + 32] * p.o[off + lane + 32];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) p.delta[w] = s;
  }
}

// For query rows i = q0 + ty + 16 a and keys j = k0 + tx + 16 c of the
// staged tiles: P and dS = P o (dO V^T - D), zero outside Sq x Sk.
__device__ __forceinline__ void probs_and_dscores(
    const Params& p, const float* bias_bh, const float* Qs, const float* dOs,
    const float* Ks, const float* Vs, const float* Ls, const float* Ds, int q0,
    int k0, int ty, int tx, float pr[4][4], float ds[4][4]) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
  tile_abt(Qs, Ks, ty, tx, s);
  tile_abt(dOs, Vs, ty, tx, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, row = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = k0 + tx + 16 * c;
      if (row < p.Sq && col < p.Sk) {
        pr[a][c] = expf(score(p, bias_bh, s[a][c], row, col) - Ls[r]);
        ds[a][c] = pr[a][c] * (dp[a][c] - Ds[r]);
      } else {
        pr[a][c] = ds[a][c] = 0.f;
      }
    }
  }
}

// L and D of query rows [q0, q0 + 64) into shared memory (0 past Sq).
__device__ __forceinline__ void load_rows(const Params& p, float* Ls, float* Ds,
                                          int b, int h, int q0) {
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row;
    Ls[threadIdx.x] = row < p.Sq ? p.lse[idx] : 0.f;
    Ds[threadIdx.x] = row < p.Sq ? p.delta[idx] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTileFloats;
  float* Qs = Vs + kTileFloats;
  float* dOs = Qs + kTileFloats;
  float* Ps = dOs + kTileFloats;
  float* dSs = Ps + kTileFloats;
  float* Ls = dSs + kTileFloats;
  float* Ds = Ls + kTile;

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long oss = (long long)p.H * kD, osb = (long long)p.Sq * oss;
  const float* qb = p.q + b * p.qsb + h * p.qsh;
  const float* dob = p.dout + b * osb + (long long)h * kD;
  const float* bias_bh =
      p.bias == nullptr ? nullptr : p.bias + b * p.bsb + h * p.bsh;

  load_tile(Ks, p.k + b * p.ksb + h * p.ksh, p.kss, k0, p.Sk);
  load_tile(Vs, p.v + b * p.vsb + h * p.vsh, p.vss, k0, p.Sk);

  // this thread's key rows ty + 16 c and dims tx + 16 e
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Qs, qb, p.qss, q0, p.Sq);
    load_tile(dOs, dob, oss, q0, p.Sq);
    load_rows(p, Ls, Ds, b, h, q0);
    __syncthreads();

    float pr[4][4], ds[4][4];
    probs_and_dscores(p, bias_bh, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, ty, tx, pr, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty + 16 * a) * kLd + tx + 16 * c] = pr[a][c];
        dSs[(ty + 16 * a) * kLd + tx + 16 * c] = ds[a][c];
      }
    __syncthreads();

    // dV[j][d] += sum_i P[i][j] dO[i][d],  dK[j][d] += sum_i dS[i][j] Q[i][d]
#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      float pj[4], sj[4], dov[4], qv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pj[c] = Ps[i * kLd + ty + 16 * c];
        sj[c] = dSs[i * kLd + ty + 16 * c];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dov[e] = dOs[i * kLd + tx + 16 * e];
        qv[e] = Qs[i * kLd + tx + 16 * e];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[c][e] = fmaf(pj[c], dov[e], dv[c][e]);
          dk[c][e] = fmaf(sj[c], qv[e], dk[c][e]);
        }
    }
  }

  const long long kss = (long long)p.H * kD, ksb = (long long)p.Sk * kss;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = k0 + ty + 16 * c;
    if (row >= p.Sk) continue;
    const long long off = b * ksb + row * kss + (long long)h * kD;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p.dk[off + tx + 16 * e] = dk[c][e] * p.scale;
      p.dv[off + tx + 16 * e] = dv[c][e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* dSs = Vs + kTileFloats;
  float* Ls = dSs + kTileFloats;
  float* Ds = Ls + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long oss = (long long)p.H * kD, osb = (long long)p.Sq * oss;
  const float* kb = p.k + b * p.ksb + h * p.ksh;
  const float* vb = p.v + b * p.vsb + h * p.vsh;
  const float* bias_bh =
      p.bias == nullptr ? nullptr : p.bias + b * p.bsb + h * p.bsh;

  load_tile(Qs, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.Sq);
  load_tile(dOs, p.dout + b * osb + (long long)h * kD, oss, q0, p.Sq);
  load_rows(p, Ls, Ds, b, h, q0);

  // this thread's query rows ty + 16 a and dims tx + 16 e
  float dq[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[a][e] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, kb, p.kss, k0, p.Sk);
    load_tile(Vs, vb, p.vss, k0, p.Sk);
    __syncthreads();

    float pr[4][4], ds[4][4];
    probs_and_dscores(p, bias_bh, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, ty, tx, pr, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dSs[(ty + 16 * a) * kLd + tx + 16 * c] = ds[a][c];
    __syncthreads();

    // dQ[i][d] += sum_j dS[i][j] K[j][d]
#pragma unroll 16
    for (int j = 0; j < kTile; ++j) {
      float sv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = dSs[(ty + 16 * a) * kLd + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = Ks[j * kLd + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[a][e] = fmaf(sv[a], kv[e], dq[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.Sq) continue;
    float* orow = p.out + b * osb + row * oss + (long long)h * kD;
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[tx + 16 * e] = dq[a][e] * p.scale;
  }
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDkvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);

Params make_params(const void* q, const void* k, const void* v,
                   const void* bias, int B, int H, int Sq, int Sk,
                   long long qsb, long long qss, long long qsh, long long ksb,
                   long long kss, long long ksh, long long vsb, long long vss,
                   long long vsh, long long bsb, long long bsh, long long bsq,
                   long long bsk, float scale) {
  Params p = {};
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.bias = (const float*)bias;
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.bsb = bsb; p.bsh = bsh; p.bsq = bsq; p.bsk = bsk;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.scale = scale;
  return p;
}

}  // namespace

// O [B, Sq, H, 64] and L [B, H, Sq], both contiguous.
extern "C" int vq_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int B, int H, int Sq, int Sk, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long bsb, long long bsh, long long bsq,
    long long bsk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  Params p = make_params(q, k, v, bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, scale);
  p.out = (float*)out;
  p.out_lse = (float*)lse;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<<<grid, kThreads, kFwdSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dQ [B, Sq, H, 64], dK and dV [B, Sk, H, 64], all contiguous; o and dout
// contiguous [B, Sq, H, 64]; delta a [B, H, Sq] scratch.
extern "C" int vq_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int B, int H, int Sq, int Sk, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
    long long bsq, long long bsk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  Params p = make_params(q, k, v, bias, B, H, Sq, Sk, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, scale);
  p.o = (const float*)o;
  p.lse = (const float*)lse;
  p.dout = (const float*)dout;
  p.out = (float*)dq;
  p.dk = (float*)dk;
  p.dv = (float*)dv;
  p.delta = (float*)delta;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * H * Sq;
  long long blocks = (rows + 7) / 8;  // 8 warps of 256 threads, a row each
  if (blocks > 65535) blocks = 65535;
  flash_bwd_delta_kernel<<<(unsigned)blocks, 256, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<<<dim3((Sk + kTile - 1) / kTile, H, B), kThreads, kDkvSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<<<dim3((Sq + kTile - 1) / kTile, H, B), kThreads, kDqSmem, s>>>(p);
  return (int)cudaGetLastError();
}
