// Flash attention in float32 at head dims 64 and 34, forward and backward,
// on Hopper's warpgroup tensor-core instructions (wgmma.mma_async, tf32
// operands) with tiles brought in by the Tensor Memory Accelerator (TMA),
// every product in three TF32 passes.
//
// Replaces the TPU kernel behind vqattack_tpu/ops/attention.py:134
// (flash_attention, which calls jax.experimental.pallas.ops.tpu.
// flash_attention: its forward, dq and dkv pallas_calls) for the float32
// trunk at head dim 64 (ALBEF, VLMo-base, ViLT) and 34 (VLMo-base+: 544
// over 16 heads).  The function, the layout and the arithmetic are those of
// flash_attention.cu, whose entry points (vq_flash_attention_fwd,
// vq_flash_attention_bwd) launch these kernels; the bias gradient's dQ pass
// (dbias) keeps that file's mma.sync kernel:
//
//   forward   S = Q K^T * scale + (bias + key_bias),  m = max_rows(S),
//             l = sum_rows(exp(S - m)),  O = softmax(S) V  (m, log l saved)
//   backward  P = exp((S - m) - log l),  dV = P^T dO,
//             dS = P o (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q
//
// with D = rowsum(dO o O) from flash_attention.cu's D pass.  Every product
// splits each operand x into hi = tf32(x) (to nearest, ties away) and lo =
// x - hi (read by the tensor cores truncated to TF32) and sums, k-step by
// k-step, a_lo b_hi + a_hi b_lo, then a_hi b_hi, in float32 (lo lo
// dropped): ops/attention.py::mm_3xtf32 describes it.
//
// Bound on the H100: operations.  At ALBEF's batched chunk [8, 901, 12, 64]
// the forward needs 4 B*H*S^2*Dh = 20.0 GFLOP and the backward, recomputing
// P, 10x: three TF32 passes at the dense 495 TFLOP/s bound them at 0.121
// and 0.302 ms, against 0.018 and 0.036 ms for their bytes.  At VLMo-base+'s
// [16, 941, 16, 34] 0.187 and 0.467 ms, counted at 34 columns; the kernels
// execute 40 (below), so 85% of that bound is their ceiling.
//
// What held the mma.sync kernels back (instruction issue: each of a
// block's 4 warps split every K and V value again, 3 instructions a value,
// and loaded every fragment itself; 2 warps a scheduler), and what this
// design does:
// - split once a block: a block is three warpgroups.  Warpgroups 0 and 1
//   compute, 64 rows each (128 queries in the forward and dQ, 128 keys in
//   dK/dV); warpgroup 2 splits.  Its thread 0 brings each streamed tile's
//   raw float32 rows by TMA into a ring of raw stages; its 128 threads split
//   each tile once into hi and lo tiles in shared memory, laid out as wgmma
//   reads them, into a ring of split buffers (mbarriers: full when split,
//   empty when both computing warpgroups are done with it), and both
//   computing warpgroups read them through descriptors.  setmaxnreg moves
//   registers from the splitters (40) to the computing warpgroups (232).
//   The operand a computing warpgroup keeps for its whole walk is split once
//   into registers (Q in the forward and dQ; K in dK/dV) or, split by the
//   splitters, into shared memory (dO in dQ; V in dK/dV, where registers
//   would not hold it beside four accumulators);
// - the two computing warpgroups take turns to issue their products (named
//   barriers), so that one's softmax runs while the other's products run;
//   the forward and dK/dV issue the product with P (dS) in a second turn,
//   dQ issues dQ += dS_{j-1} K_{j-1} in the turn of S_j and dP_j and forms
//   dS_j while it runs (three split buffers);
// - tf32 wgmma reads both operands K-major (the transpose immediates exist
//   for 16-bit types only), so the splitters write the four operands that a
//   product needs transposed (V in P V, dO in P^T dO, Q in dS^T Q, K in dS
//   K) transposed as they split them, from 4-byte reads of the raw rows (a
//   warp reads 32 consecutive floats of one row: no bank conflict); S = Q
//   K^T, dP = dO V^T, S^T = K Q^T and dP^T = V dO^T read their B as TMA
//   brought it;
// - the accumulator is not the register A fragment: a thread holds columns
//   2t, 2t + 1 of a row where A wants depth t and t + 4.  The product that
//   consumes P or dS sums its depth in the permuted order (slot t <- column
//   2t, slot t + 4 <- column 2t + 1), as flash_attention.cu does, and the
//   splitters write the transposed tiles in that order (within each 8
//   columns, 16-byte chunk 0 holds columns 0, 2, 4, 6, chunk 1 columns 1,
//   3, 5, 7), so P and dS go from the accumulator to A in registers;
// - layout: a split tile whose depth is keys or queries (the transposed
//   tiles) is 128-byte swizzled panels of 32 floats, 16-byte chunk c of row
//   r at chunk c ^ (r % 8), 8-row groups 1024 bytes apart; one whose depth
//   is the head dim is the same at head dim 64 (a 64-float row is two
//   panels) and five 32-byte swizzled panels of 8 floats at head dim 34
//   (below).  The splitters' 16-byte writes hit 8 distinct chunks a quarter
//   warp (no bank conflict).  The raw tiles are unswizzled rows of one TMA
//   box (256 or 160 bytes), which both kinds of split read without
//   conflict;
// - registers: the backward walks 32-column tiles, so dK/dV's four
//   accumulators (dK, dV, S^T, dP^T), K's fragments and P^T's and dS^T's fit
//   in the computing warpgroups' 232 without spills (ptxas's report, printed
//   by chip_smoke.py); the forward's terms are read before the turn that
//   needs them, where P's fragments are not live;
// - ragged lengths: TMA fills rows past Sq or Sk with zeros; keys past Sk
//   (forward, dQ) and queries past Sq (dK/dV) are masked to -inf before the
//   exponential on the last tile; rows past Sq (Sk in dK/dV) are computed
//   from zeros and not written.  A row whose first key tile is all -inf
//   exponentiates against 0 (alpha and p come out 0, not NaN);
// - the two terms are template parameters, read from device memory (L2)
//   through broadcast strides into registers before the scores are waited
//   for (after, in dK/dV, whose registers are fuller), summed and then added
//   to the scaled scores; m and log l stay apart ([2, B, H, Sq]);
// - deterministic: no atomics, every sum in a fixed order (dQ over query
//   tiles, dK/dV over key tiles), the same bits on every run.
//
// Head dim 34 (the kernels' kDh = 34, read as kD = 40 columns).  A head of
// a [B, S, 544] projection starts 136 bytes after the last, off the 16-byte
// strides a TMA map takes, so q, k, v and dO are not mapped head by head:
// the heads are folded into the columns, a 3-D map (H * 34, S, B) over the
// tensor's own row and batch strides, and a head's rows come as a box of 40
// columns.  A box must start on 16 bytes (TMA stops the kernel with an
// illegal instruction otherwise, measured), and 34 h floats is 8 bytes off
// 16 for an odd head, so an even head's box starts at column 34 h (its 34
// columns, then the next head's first 6) and an odd head's at 34 h - 2 (the
// last 2 of the head before, its 34 at box columns 2-35, then 4 of the
// next); past column H * 34 (the last head's) TMA brings zeros.  So the
// tensors are read in place, with no pad copy, where the heads are packed
// (head stride 34), the row and batch strides are multiples of 4 floats
// and the base is on 16 bytes (ops/attention.py::fits_folded_box; the
// wrapper copies what is not).  Then:
// - every read of a raw tile starts at the head's first column (0 or 2:
//   head_shift) and reads columns 0-33 of the head only: the splitters
//   write columns 34-39 of every split tile whose depth is the head dim (K
//   in S = Q K^T, V in dP = dO V^T, Q and dO in S^T = K Q^T and dP^T = V
//   dO^T, dO and V as shared-memory A operands) as zeros, and the register
//   A operands (Q, K) are zeroed there as they are loaded: with the next
//   head's columns there, its products would add into S and dP.  The
//   transposed tiles' rows 34-39, which reach only the output columns
//   34-39 (not written), are zeros too;
// - a 40-float row is not a whole number of 128-byte panels, so a split
//   tile whose depth is the head dim is five 32-byte swizzled panels of 8
//   floats (chunk c of row r at chunk c ^ (r / 4 % 2) of its panel, 8-row
//   groups 256 bytes apart): one panel a k8 step, 5 steps where head dim 64
//   takes 8; a quarter warp splits 4 rows of one panel, reading 4 rows of
//   160 bytes and writing 128 contiguous bytes (no bank conflict).  The
//   products whose outputs are head-dim columns (P V, P^T dO, dS K, dS^T Q)
//   run at wgmma N = 40, their transposed tiles 40 rows of 128-byte panels;
// - O, dQ, dK and dV are contiguous [B, S, H, 34]: 136-byte head rows,
//   written as float2 over columns 0-33 only (writing 40 would overwrite
//   the next head's);
// - the accumulators over the head dim take 20 floats a thread, not 32.
//
// One block an SM (384 threads; 192 KB of shared memory in the forward, 224
// KB in dQ, 225 KB in dK/dV at head dim 64; 121, 141 and 142 KB at 34), a
// grid of 128-row tiles of every (batch, head).  What bounds it now
// (PERF.md): the tensor cores run a little over half of the time at head
// dim 64 (chip_smoke.py's executed TFLOP/s against 495): the softmax, the
// splitters and the turns' hand-overs overlap the products only in part,
// the block's first tile (Q's load and split, then tile 0's) overlaps
// nothing, and 128-row tiles of 901 rows waste 12% of the last block,
// 64-key tiles of 901 keys 6% of every row's walk.  At head dim 34 the
// products shrink to 40/64 of those and the softmax does not.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace vqflash {
namespace {

constexpr int kThreads = 384;     // two warpgroups that multiply, one that loads and splits
constexpr int kSplitters = 128;   // the third warpgroup
constexpr int kRows = 128;        // rows of a block's tile: 64 a warpgroup
constexpr int kFwdCols = 64;      // keys a forward step
constexpr int kBwdCols = 32;      // keys (dQ) or queries (dK/dV) a backward step
constexpr float kLog2e = 1.4426950408889634f;

// A head dim kDh (64, or 34) as the kernels read it: kD columns a raw row
// (one TMA box), the depth of a product over the head dim in k8 steps.
template <int kDh>
struct Head {
  static_assert(kDh == 64 || kDh == 34, "the kernels take head dims 64 and 34");
  static constexpr int kD = kDh == 64 ? 64 : 40;
  static constexpr int kSteps = kD / 8;
};

// TMA maps of q, k, v and dO, with boxes of 64 rows (the block's own rows,
// and the forward's keys) and of 32 rows (the backward's steps), passed by
// value (__grid_constant__), where TMA reads them: (64, S, H, B) maps at
// head dim 64, (H * 34, S, B) ones at 34.
struct Maps {
  CUtensorMap q64, k64, v64, do64, q32, k32, v32, do32;
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

// Rows [row, row + box) of (batch b, head h) into unswizzled rows of kD
// floats at ``dst``: from a (64, S, H, B) map at head dim 64, from an (H *
// 34, S, B) map at 34, the box's 40 columns from column 34 h - head_shift(h)
// (a box starts on 16 bytes); rows past S, and columns past H * 34, arrive
// as zeros.  The bytes count toward ``bar``'s phase.
// The column at which head h's rows start in its raw tile: at head dim 34
// the box of an odd head starts 2 columns early, on 16 bytes (34 h floats is
// 8 bytes off 16 there, and TMA traps on a box whose first column is not on
// 16 bytes), so its columns are 2-35 of the box; 0 otherwise.
template <int kDh>
__device__ __forceinline__ int head_shift(int h) {
  return kDh == 34 ? 2 * (h & 1) : 0;
}

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

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x[0]), "r"(x[1]),
               "r"(x[2]), "r"(x[3])
               : "memory");
}

// This thread's shared-memory writes made visible to the async proxy (the
// wgmma reads that follow the next barrier).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return (smem_u32(smem_raw) + 1023) & ~1023u;
}

// The splitting warpgroup's own barrier (named barrier 3, its 128 threads).
__device__ __forceinline__ void splitters_sync() {
  asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

// Registers move from the splitters to the computing warpgroups: at launch
// 168 a thread (384 threads), then 40 and 232, (168 - 40) x 128 = (232 -
// 168) x 256, so that the increase finds the registers the decrease freed.
__device__ __forceinline__ void splitter_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void compute_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// The two computing warpgroups take turns to issue their products (named
// barriers 1 and 2), so that one's softmax runs on the multi-function and
// floating-point units while the other's products run on the tensor cores.
// Every product of a warpgroup is issued between wait() and pass();
// warpgroup 0 goes first.
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

// ---------------------------------------------------------------------------
// the 3xTF32 split and the split tiles
// ---------------------------------------------------------------------------

// x = hi + lo.  hi is x rounded to TF32 (10 mantissa bits) to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding on finite values, in two
// integer operations.  lo = x - hi is exact and goes to the tensor cores as
// it is: they read a TF32 operand's top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Byte offset of 16-byte chunk ``c`` (4 floats) of row ``r`` in a K-major
// tile of ``rows`` rows in 128-byte swizzled panels of 32 floats, panel c /
// 8 after ``rows`` x 128 bytes of each panel before it.
__device__ __forceinline__ uint32_t chunk_off(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// The same for a K-major tile of ``rows`` rows whose depth is the head dim
// (kD columns): 128-byte panels at kD = 64; at kD = 40 five 32-byte
// swizzled panels of 8 floats, chunk c of row r in panel c / 2 after rows x
// 32 bytes of each panel before it, at chunk (c ^ (r / 4)) % 2.
template <int kD>
__device__ __forceinline__ uint32_t head_chunk_off(int r, int c, int rows) {
  if constexpr (kD == 64) {
    return chunk_off(r, c, rows);
  } else {
    return (uint32_t)((c >> 1) * rows * 32 + r * 32 + (((c ^ (r >> 2)) & 1) << 4));
  }
}

// A tile of ``kR`` raw rows at ``raw`` (rows of kD floats, the head's
// columns from column ``shift``) split as it is into the K-major tiles
// ``hi`` and ``lo`` of kR rows and kD columns: the B operand of a product
// over the head dim (or a shared-memory A operand).  The splitters take the
// 16-byte chunks in turn: at kD = 64 a row's 16 in order; at kD = 40 a
// quarter warp takes 4 rows of one 8-column panel (reads of 4 160-byte
// rows, in 8-byte halves: ``shift`` may be 2; a write of 128 contiguous
// bytes).  Columns 34-39 of a 40-column tile (the next head's, or zeros)
// are split as zeros, and not read.  A thread's read and write move by
// constants from step to step, so the splitters' 40 registers hold one
// base of each.
template <int kD, int kR>
__device__ __forceinline__ void split_rows(uint32_t raw, uint32_t hi, uint32_t lo, int tid,
                                           int shift) {
  static_assert(kR == 32 || kR == 64, "tiles of 32 or 64 rows");
  constexpr int kSteps = (kR * kD / 4 + kSplitters - 1) / kSplitters;
  constexpr uint32_t kRowBytes = kD * 4;
  const uint32_t t = (uint32_t)tid;
  // row r, chunk c (4 columns) at step 0; each step kRowStep rows and
  // kChunkStep chunks further, the write kDstStep bytes further: at kD = 64
  // a row's 16 chunks in order, 8 rows a step; at kD = 40, 16 quarter
  // warps a step, kR / 4 of them a panel (2 chunks)
  constexpr uint32_t kQuads = kR / 4;
  constexpr uint32_t kRowStep = kD == 64 ? 8 : 0, kChunkStep = kD == 64 ? 0 : 32 / kQuads;
  constexpr uint32_t kDstStep = kD == 64 ? 1024 : (16 / kQuads) * kR * 32;
  const uint32_t r = kD == 64 ? t >> 4 : 4 * ((t >> 3) % kQuads) + ((t >> 1) & 3);
  const uint32_t c = kD == 64 ? t & 15 : 2 * ((t >> 3) / kQuads) + (t & 1);
  const uint32_t src = raw + r * kRowBytes + (c * 4 + shift) * 4;
  const uint32_t dst = head_chunk_off<kD>(r, c, kR);
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const uint32_t at = src + it * (kRowStep * kRowBytes + kChunkStep * 16);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kD == 64) {
      x = ld_shared4(at);
    } else {
      const uint32_t chunk = c + it * kChunkStep;
      if (chunk >= kD / 4) break;  // kR = 32's last step: half of the splitters
      if (chunk < 9) {  // chunk 8: columns 32-35, of which 32 and 33 are read; chunk 9: none
        const float2 a = ld_shared2(at);
        x.x = a.x;
        x.y = a.y;
        if (chunk < 8) {
          const float2 b = ld_shared2(at + 8);
          x.z = b.x;
          x.w = b.y;
        }
      }
    }
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    st_shared4(hi + dst + it * kDstStep, h);
    st_shared4(lo + dst + it * kDstStep, l);
  }
}

// A tile of ``kL`` raw rows (keys or queries) at ``raw`` (the head's
// columns from column ``shift``) split transposed into the K-major tiles
// ``hi`` and ``lo`` of kD rows (the head dim) and kL columns, in the
// permuted depth order of a product that takes P or dS from the
// accumulator: chunk 2 s + e of a row holds raw rows 8 s + e + {0, 2, 4,
// 6}.  A warp's lanes take 32 consecutive head-dim columns, so each of its
// four reads is 32 consecutive floats of one raw row.  A thread's reads and
// writes move by constants (or an XOR of one) from step to step, so the
// splitters' 40 registers hold one base of each.
template <int kD, int kL>
__device__ __forceinline__ void split_cols(uint32_t raw, uint32_t hi, uint32_t lo, int tid,
                                           int shift) {
  constexpr uint32_t kRowBytes = kD * 4;
  if constexpr (kD == 64) {
    // column d = tid % 64 of chunks tid / 64 + 2 it: the read 8 raw rows
    // further a step, the write's chunk c ^ (d % 8) moved by 2 (it % 4)
    const uint32_t t = (uint32_t)tid, d = t & 63, c0 = t >> 6;
    const uint32_t src = raw + c0 * kRowBytes + d * 4, row = d * 128, x0 = c0 ^ (d & 7);
#pragma unroll
    for (int it = 0; it < kL / 8; ++it) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(ld_shared(src + (8 * it + 2 * e) * kRowBytes), h[e], l[e]);
      const uint32_t off = (it >> 2) * kD * 128 + row + ((x0 ^ (2 * (it & 3))) << 4);
      st_shared4(hi + off, h);
      st_shared4(lo + off, l);
    }
  } else {
    // rows 0-31 as at kD = 64, 4 chunks a step: column d = tid % 32 of
    // chunks tid / 32 + 4 it, the read 16 raw rows further a step, the
    // write's chunk c ^ (d % 8) moved by 4 (it % 2)
    const uint32_t t = (uint32_t)tid, d = t & 31, c0 = t >> 5;
    const uint32_t src = raw + (8 * (c0 >> 1) + (c0 & 1)) * kRowBytes + (d + shift) * 4;
    const uint32_t row = d * 128, x0 = c0 ^ (d & 7);
#pragma unroll
    for (int it = 0; it < kL / 16; ++it) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(ld_shared(src + (16 * it + 2 * e) * kRowBytes), h[e], l[e]);
      const uint32_t off = (it >> 1) * kD * 128 + row + ((x0 ^ (4 * (it & 1))) << 4);
      st_shared4(hi + off, h);
      st_shared4(lo + off, l);
    }
    // rows 32-39, one step: column 32 + tid % 8 of chunk tid / 8; rows
    // 34-39 as zeros (they reach only the output columns not written)
    const uint32_t d8 = 32 + (t & 7), c = t >> 3;
    if (c < kL / 4) {
      uint32_t h[4] = {0u, 0u, 0u, 0u}, l[4] = {0u, 0u, 0u, 0u};
      if (d8 < 34) {
        const uint32_t at = raw + (8 * (c >> 1) + (c & 1)) * kRowBytes + (d8 + shift) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) split(ld_shared(at + 2 * e * kRowBytes), h[e], l[e]);
      }
      const uint32_t off = chunk_off(d8, c, kD);
      st_shared4(hi + off, h);
      st_shared4(lo + off, l);
    }
  }
}

// The register A operand of this thread's rows 16 w + g and + 8 of a
// warpgroup's 64 raw rows at ``raw`` (the head's columns from column
// ``shift``), split, over the kD columns: k-step kk holds columns 8 kk + t
// and 8 kk + t + 4 (w the warp in its warpgroup, g = lane / 4, t = lane %
// 4); columns 34-39 of a 40-column row as zeros, not read.  Once a tile, so
// the 8 rows a load hits one bank for are not worth a swizzle.
template <int kD>
__device__ __forceinline__ void load_a(uint32_t (&hi)[kD / 8][4], uint32_t (&lo)[kD / 8][4],
                                       uint32_t raw, int shift) {
  constexpr uint32_t kRowBytes = kD * 4;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, t = lane & 3;
  const uint32_t r0 = raw + (16 * w + (lane >> 2)) * kRowBytes + (t + shift) * 4;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    // at kD = 40, k-step 4 holds columns 32 + t (read for t < 2) and 36 + t (zeros)
    const bool lo_cols = kD == 64 || kk < 4 || t < 2, hi_cols = kD == 64 || kk < 4;
    const float x[4] = {lo_cols ? ld_shared(r0 + 32 * kk) : 0.f,
                        lo_cols ? ld_shared(r0 + 8 * kRowBytes + 32 * kk) : 0.f,
                        hi_cols ? ld_shared(r0 + 32 * kk + 16) : 0.f,
                        hi_cols ? ld_shared(r0 + 8 * kRowBytes + 32 * kk + 16) : 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], hi[kk][e], lo[kk][e]);
  }
}

// Columns 8 j .. 8 j + 7 of an accumulator tile (``c`` = d + 4 j) as the
// register A operand of a k-step in the permuted depth order: slot t holds
// column 2 t, slot t + 4 column 2 t + 1.
__device__ __forceinline__ void acc_to_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* c) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// wgmma
//
// The accumulator of an m64nN product: thread t of the warpgroup (warp w, g
// = lane / 4, c = lane % 4) holds d[i], i < N / 2, at row 16 w + g + 8 ((i
// / 2) % 2) and column 8 (i / 4) + 2 c + i % 2.  The register A operand of
// a k-step (8 deep) holds rows 16 w + g and + 8 at depth c and c + 4, as
// mma.m16n8k8's A.
// ---------------------------------------------------------------------------

// Descriptor of a K-major tile in the 128-byte swizzle (layout type 1),
// 8-row groups 1024 bytes apart (stride byte offset 64 x 16); a k-step of 8
// floats is 32 bytes further within a panel.  Every panel starts on 1024
// bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The byte offset of k-step kk in a K-major tile of ``rows`` rows in
// 128-byte panels.
__device__ __forceinline__ uint32_t kstep_off(int kk, int rows) {
  return (uint32_t)((kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// The descriptor and the k-step offset of a tile whose depth is the head
// dim (head_chunk_off): at kD = 40 a k-step is a 32-byte panel in the
// 32-byte swizzle (layout type 3), 8-row groups 256 bytes apart (stride
// byte offset 16 x 16); every panel starts on 256 bytes.
template <int kD>
__device__ __forceinline__ uint64_t head_desc(uint32_t addr) {
  if constexpr (kD == 64) {
    return desc(addr);
  } else {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
  }
}
template <int kD>
__device__ __forceinline__ uint32_t head_kstep_off(int kk, int rows) {
  if constexpr (kD == 64) {
    return kstep_off(kk, rows);
  } else {
    return (uint32_t)(kk * rows * 32);
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

#define VQ_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VQ_F8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (=|+=) A X^T for one k-step: A a 64 x 8 tf32 operand in registers
// (``Rs``) or shared memory (``Ss``, a descriptor), X^T 8 x N from the
// K-major tile at descriptor ``x``; ``acc`` 0 overwrites d.
template <int N>
struct Rs;
template <int N>
struct Ss;

template <>
struct Rs<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : VQ_F8(0), VQ_F8(8), VQ_F8(16), VQ_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc));
  }
};

template <>
struct Rs<40> {
  static __device__ __forceinline__ void run(float (&d)[20], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : VQ_F8(0), VQ_F8(8), VQ_F4(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc));
  }
};

template <>
struct Rs<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t x,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : VQ_F8(0), VQ_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(x), "r"(acc));
  }
};

template <>
struct Ss<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t x, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : VQ_F8(0), VQ_F8(8)
        : "l"(a), "l"(x), "r"(acc));
  }
};

#undef VQ_F8
#undef VQ_F4

// Issue d = A X^T over the kD head-dim columns: A held as register
// fragments, X the split K-major tiles of N rows at ``x_hi``, ``x_lo``.
// Each k-step adds a_lo x_hi and a_hi x_lo, then a_hi x_hi.
template <int kD, int N>
__device__ __forceinline__ void product_rs(float (&d)[N / 2], const uint32_t (&a_hi)[kD / 8][4],
                                           const uint32_t (&a_lo)[kD / 8][4], uint32_t x_hi,
                                           uint32_t x_lo) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t off = head_kstep_off<kD>(kk, N);
    Rs<N>::run(d, a_lo[kk], head_desc<kD>(x_hi + off), kk > 0);
    Rs<N>::run(d, a_hi[kk], head_desc<kD>(x_lo + off), 1);
    Rs<N>::run(d, a_hi[kk], head_desc<kD>(x_hi + off), 1);
  }
}

// Issue d = A X^T over the kD head-dim columns, A the split K-major tiles
// of a warpgroup's 64 rows at ``a_hi``, ``a_lo`` in shared memory.
template <int kD, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                           uint32_t x_hi, uint32_t x_lo) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t ao = head_kstep_off<kD>(kk, 64), xo = head_kstep_off<kD>(kk, N);
    Ss<N>::run(d, head_desc<kD>(a_lo + ao), head_desc<kD>(x_hi + xo), kk > 0);
    Ss<N>::run(d, head_desc<kD>(a_hi + ao), head_desc<kD>(x_lo + xo), 1);
    Ss<N>::run(d, head_desc<kD>(a_hi + ao), head_desc<kD>(x_hi + xo), 1);
  }
}

// Issue d += C X over the L columns of an accumulator tile C (its k-steps
// split into ``c_hi``, ``c_lo`` by acc_to_a), X the transposed split tiles
// (kD rows, the head dim; L permuted columns) at ``x_hi``, ``x_lo``.
template <int kD, int L>
__device__ __forceinline__ void product_acc(float (&d)[kD / 2], const uint32_t (&c_hi)[L / 8][4],
                                            const uint32_t (&c_lo)[L / 8][4], uint32_t x_hi,
                                            uint32_t x_lo) {
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
    const uint32_t off = kstep_off(j, kD);
    Rs<kD>::run(d, c_lo[j], desc(x_hi + off), 1);
    Rs<kD>::run(d, c_hi[j], desc(x_lo + off), 1);
    Rs<kD>::run(d, c_hi[j], desc(x_hi + off), 1);
  }
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
// 2) % 2) and column c + 8 (i / 4) + i % 2, r the warp's first row + g and c
// the tile's first column + 2 (lane % 4).  Rows are queries and columns
// keys, or the other way round (``kKeyRows``, dK/dV).
// ---------------------------------------------------------------------------

// bias + key_bias at this thread's elements, rows and columns clamped (rows
// past Sq or Sk are never written, columns past them are masked), so that
// every read is in bounds.
template <int N, bool kBias, bool kKeyBias, bool kKeyRows>
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
    const int col = min(c + 8 * (i >> 2) + (i & 1), n_cols - 1);
    float x = kBias ? __ldg(row_ptr[(i >> 1) & 1] + col * col_stride) : 0.f;
    if (kKeyBias) x += kKeyRows ? row_kb[(i >> 1) & 1] : __ldg(kbb + col);
    t[i] = x;
  }
}

// s = s * scale + t (with ``kTerms``), and -inf in the columns at or past
// ``n_valid`` where ``ragged``.
template <int N, bool kTerms>
__device__ __forceinline__ void prep(float (&s)[N / 2], const float (&t)[N / 2], float scale,
                                     int c, int n_valid, bool ragged) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float x = s[i] * scale;
    if (kTerms) x += t[i];
    if (ragged && c + 8 * (i >> 2) + (i & 1) >= n_valid) x = -INFINITY;
    s[i] = x;
  }
}

// Store rows r and r + 8 of a 64 x kD accumulator tile (this thread's part)
// times ``mul0`` / ``mul1`` to a contiguous [B, S, H, kDh] tensor (``base``
// at row 0 of this batch and head) as float2, columns past kDh not
// written; rows at or past ``nrows`` are not written.
template <int kDh>
__device__ __forceinline__ void store_rows(float* base, long long row_stride, int r, int nrows,
                                           const float (&acc)[Head<kDh>::kD / 2], float mul0,
                                           float mul1, int c) {
  constexpr int kD = Head<kDh>::kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r + 8 * i;
    if (rr >= nrows) continue;
    const float mul = i == 0 ? mul0 : mul1;
    float* dst = base + rr * row_stride + 2 * c;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      if (kDh == kD || 8 * j + 2 * c < kDh)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward: a block walks the 64-key tiles for 128 query rows
// ---------------------------------------------------------------------------

template <int kD>
struct FwdSmem {
  static constexpr uint32_t kRaw = 64 * kD * 4;    // a 64-row raw tile: 16 KB (10 KB at kD 40)
  static constexpr uint32_t kRawStage = 2 * kRaw;  // K, V
  static constexpr uint32_t kSplit = 64 * kD * 4;  // a 64 x kD split tile (hi or lo)
  static constexpr uint32_t kBuf = 4 * kSplit;     // K hi, K lo, V^T hi, V^T lo
  static constexpr uint32_t kBars = 2 * kRawStage + 2 * kBuf;
  // Q's two, and a full barrier a raw stage, a full and an empty one a buffer
  static constexpr size_t kSmem = 1024 + kBars + 8 * 8;
};

// Warpgroups 0 and 1 hold 64 query rows each; warpgroup 2 splits.  The
// splitters take tile j from raw stage j % 2 (TMA, issued by their thread
// 0 two tiles ahead) into buffer j % 2 once both computing warpgroups have
// released it, and arrive on its full barrier.  A computing warpgroup's
// step j: S = Q K_j^T in its turn, the softmax, O += P_j V_j in its next
// turn, then it releases buffer j % 2.
template <int kDh, bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_fwd_kernel(const Params p, const __grid_constant__ Maps maps) {
  constexpr int kD = Head<kDh>::kD;
  using S = FwdSmem<kD>;
  constexpr uint32_t kRaw = S::kRaw, kRawStage = S::kRawStage, kSplit = S::kSplit;
  constexpr uint32_t kBuf = S::kBuf, kBars = S::kBars;
  constexpr bool kTerms = kBias || kKeyBias;
  const uint32_t base = smem_base();
  const uint32_t raw = base, bufs = base + 2 * kRawStage;
  const uint32_t q_full = base + kBars, q_read = q_full + 8, raw_full = q_full + 16;
  const uint32_t split_full = raw_full + 16, split_empty = split_full + 16;
  const uint32_t q_raw = bufs + kBuf;  // Q's raw rows, in buffer 1 until it is read
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x >> 7, shift = head_shift<kDh>(h);
  const int n_tiles = (p.Sk + kFwdCols - 1) / kFwdCols;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    bar_init(q_read, 256);
    for (int s = 0; s < 2; ++s) {
      bar_init(raw_full + 8 * s, 1);
      bar_init(split_full + 8 * s, kSplitters);
      bar_init(split_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    splitter_regs();
    const int tid = threadIdx.x - 256;
    const auto load_kv = [&](int j) {  // key tile j into raw stage j % 2
      const uint32_t st = raw + (j & 1) * kRawStage, bar = raw_full + 8 * (j & 1);
      bar_expect(bar, kRawStage);
      tma_rows<kDh>(st, &maps.k64, bar, kFwdCols * j, h, b);
      tma_rows<kDh>(st + kRaw, &maps.v64, bar, kFwdCols * j, h, b);
    };
    if (tid == 0) {
      bar_expect(q_full, 2 * kRaw);
      tma_rows<kDh>(q_raw, &maps.q64, q_full, q0, h, b);
      tma_rows<kDh>(q_raw + kRaw, &maps.q64, q_full, q0 + 64, h, b);
      load_kv(0);
      if (n_tiles > 1) load_kv(1);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j & 1;
      const uint32_t st = raw + s * kRawStage, buf = bufs + s * kBuf;
      if (j == 1) bar_wait(q_read, 0);  // buffer 1 held Q's raw rows
      if (j >= 2) bar_wait(split_empty + 8 * s, ((j >> 1) - 1) & 1);
      bar_wait(raw_full + 8 * s, (j >> 1) & 1);
      split_rows<kD, 64>(st, buf, buf + kSplit, tid, shift);
      split_cols<kD, 64>(st + kRaw, buf + 2 * kSplit, buf + 3 * kSplit, tid, shift);
      fence_async_smem();
      bar_arrive(split_full + 8 * s);
      splitters_sync();  // every splitter is done with raw stage s
      if (tid == 0 && j + 2 < n_tiles) load_kv(j + 2);
    }
    return;
  }

  compute_regs();
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Turns turns = {wg};
  turns.start();
  // d[0]'s row; rows past Sq are computed from zero rows and not written
  const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const float* bias_bh = kBias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const float* kbb = kKeyBias ? p.key_bias + b * p.kbsb : nullptr;
  uint32_t q_hi[kD / 8][4], q_lo[kD / 8][4];
  bar_wait(q_full, 0);
  load_a<kD>(q_hi, q_lo, q_raw + wg * kRaw, shift);
  bar_arrive(q_read);
  float o[kD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's part
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const uint32_t buf = bufs + s * kBuf;
    const int k0 = kFwdCols * j;
    float t[32];
    if (kTerms) load_terms<64, kBias, kKeyBias, false>(t, p, bias_bh, kbb, row, k0 + 2 * c);
    float sc[32];
    bar_wait(split_full + 8 * s, (j >> 1) & 1);
    turns.wait();
    wg_fence();
    product_rs<kD, 64>(sc, q_hi, q_lo, buf, buf + kSplit);  // S = Q K^T
    wg_commit();
    turns.pass();
    wg_wait();
    keep(sc);
    prep<64, kTerms>(sc, t, p.scale, k0 + 2 * c, p.Sk, k0 + kFwdCols > p.Sk);
    // online softmax: the running maxima, alpha = exp(m_old - m_new), and
    // S replaced by exp(S - m_new)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float ref[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // -inf while every key so far is masked (a -inf term): exponentiate
      // against 0 instead, so that alpha and every p come out 0, not NaN
      ref[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2_approx((m[r] - ref[r]) * kLog2e);  // 0 on the first tile
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2_approx((sc[i] - ref[(i >> 1) & 1]) * kLog2e);  // 0 for a masked key
      rs[(i >> 1) & 1] += sc[i];
      if (i < kD / 2) o[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_a(p_hi[kk], p_lo[kk], sc + 4 * kk);
    turns.wait();
    wg_fence();
    product_acc<kD, kFwdCols>(o, p_hi, p_lo, buf + 2 * kSplit, buf + 3 * kSplit);  // O += P V
    wg_commit();
    turns.pass();
    wg_wait();
    keep(o);
    keep(p_hi);
    keep(p_lo);
    bar_arrive(split_empty + 8 * s);
  }
  turns.finish();

  const long long oss = (long long)p.H * kDh, osb = (long long)p.Sq * oss;
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  store_rows<kDh>(p.out + b * osb + (long long)h * kDh, oss, row, p.Sq, o, 1.f / l0, 1.f / l1,
                  c);
  if (c == 0) {
    // m and log l apart: m may be near -1e9 (a row whose every key is masked
    // by a finite term), where m + log l rounds back to m
    const float ls[2] = {l0, l1};
    const long long n_rows = (long long)p.B * p.H * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < p.Sq) {
        const long long idx = ((long long)b * p.H + h) * p.Sq + row + 8 * r;
        p.out_lse[idx] = m[r];
        p.out_lse[n_rows + idx] = logf(ls[r]);
      }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block walks the 32-key tiles for 128 query rows
// ---------------------------------------------------------------------------

template <int kD>
struct DqSmem {
  static constexpr uint32_t kRaw64 = 64 * kD * 4;        // 16 KB (10 KB at kD 40)
  static constexpr uint32_t kRaw = kBwdCols * kD * 4;    // a 32-row raw tile
  static constexpr uint32_t kRawStage = 2 * kRaw;        // K, V
  static constexpr uint32_t kA = 64 * kD * 4;            // a warpgroup's split dO (hi or lo)
  static constexpr uint32_t kSplit = kBwdCols * kD * 4;  // a 32 x kD or kD x 32 split tile
  static constexpr uint32_t kBuf = 6 * kSplit;           // K hi, lo; V hi, lo; K^T hi, lo
  static constexpr int kBufs = 3;
  static constexpr uint32_t kDo = 0, kRaws = 4 * kA, kBufs0 = kRaws + kRawStage;
  static constexpr uint32_t kBars = kBufs0 + kBufs * kBuf;
  static constexpr size_t kSmem = 1024 + kBars + 9 * 8;
  static_assert(4 * kRaw64 <= kBufs * kBuf, "Q's and dO's raw rows fit in the buffers");
};

// As the forward: warpgroup 2 splits dO once (the computing warpgroups'
// shared-memory A operand) and then the 32-key tiles (K, V, and K
// transposed); a computing warpgroup's step j, in its turn: S_j = Q K_j^T
// and dP_j = dO V_j^T, then dQ += dS_{j-1} K_{j-1}; dS_j while the last
// runs.
template <int kDh, bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_dq_kernel(const Params p, const __grid_constant__ Maps maps) {
  constexpr int kD = Head<kDh>::kD;
  using S = DqSmem<kD>;
  constexpr uint32_t kRaw64 = S::kRaw64, kRaw = S::kRaw, kRawStage = S::kRawStage;
  constexpr uint32_t kA = S::kA, kSplit = S::kSplit, kBuf = S::kBuf;
  constexpr int kBufs = S::kBufs;
  constexpr uint32_t kDo = S::kDo, kRaws = S::kRaws, kBufs0 = S::kBufs0, kBars = S::kBars;
  constexpr bool kTerms = kBias || kKeyBias;
  const uint32_t base = smem_base();
  const uint32_t raw = base + kRaws, bufs = base + kBufs0;
  const uint32_t qd_full = base + kBars, q_read = qd_full + 8, raw_full = qd_full + 16;
  const uint32_t split_full = raw_full + 8, split_empty = split_full + 8 * kBufs;
  // Q's and dO's raw rows, in the buffers until they are read
  const uint32_t q_raw = bufs, do_raw = bufs + 2 * kRaw64;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x >> 7, shift = head_shift<kDh>(h);
  const int n_tiles = (p.Sk + kBwdCols - 1) / kBwdCols;
  const auto buf = [bufs](int j) { return bufs + (uint32_t)(j % kBufs) * kBuf; };
  if (threadIdx.x == 0) {
    bar_init(qd_full, 1);
    bar_init(q_read, 256);
    bar_init(raw_full, 1);
    for (int s = 0; s < kBufs; ++s) {
      bar_init(split_full + 8 * s, kSplitters);
      bar_init(split_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    splitter_regs();
    const int tid = threadIdx.x - 256;
    const auto load_kv = [&](int j) {
      bar_expect(raw_full, kRawStage);
      tma_rows<kDh>(raw, &maps.k32, raw_full, kBwdCols * j, h, b);
      tma_rows<kDh>(raw + kRaw, &maps.v32, raw_full, kBwdCols * j, h, b);
    };
    if (tid == 0) {
      bar_expect(qd_full, 4 * kRaw64);
      tma_rows<kDh>(q_raw, &maps.q64, qd_full, q0, h, b);
      tma_rows<kDh>(q_raw + kRaw64, &maps.q64, qd_full, q0 + 64, h, b);
      tma_rows<kDh>(do_raw, &maps.do64, qd_full, q0, h, b);
      tma_rows<kDh>(do_raw + kRaw64, &maps.do64, qd_full, q0 + 64, h, b);
      load_kv(0);
    }
    bar_wait(qd_full, 0);
    split_rows<kD, 64>(do_raw, base + kDo, base + kDo + kA, tid, shift);  // warpgroup 0's rows
    split_rows<kD, 64>(do_raw + kRaw64, base + kDo + 2 * kA, base + kDo + 3 * kA, tid, shift);
    bar_wait(q_read, 0);  // Q's raw rows read: the buffers are free
    splitters_sync();     // and dO's, by every splitter
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kBufs;
      const uint32_t bj = buf(j);
      if (j >= kBufs) bar_wait(split_empty + 8 * s, (j / kBufs - 1) & 1);
      bar_wait(raw_full, j & 1);
      split_rows<kD, kBwdCols>(raw, bj, bj + kSplit, tid, shift);
      split_rows<kD, kBwdCols>(raw + kRaw, bj + 2 * kSplit, bj + 3 * kSplit, tid, shift);
      split_cols<kD, kBwdCols>(raw, bj + 4 * kSplit, bj + 5 * kSplit, tid, shift);
      fence_async_smem();
      bar_arrive(split_full + 8 * s);
      splitters_sync();  // every splitter is done with the raw stage
      if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);
    }
    return;
  }

  compute_regs();
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Turns turns = {wg};
  turns.start();
  const uint32_t do_hi = base + kDo + wg * 2 * kA, do_lo = do_hi + kA;
  // d[0]'s row; rows past Sq are computed from zero rows and not written
  const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float mx[2], lgl[2], dlt[2];  // m, log l, D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row + 8 * r < p.Sq;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row + 8 * r;
    mx[r] = ok ? p.lse[idx] : 0.f;
    lgl[r] = ok ? p.lse[(long long)p.B * p.H * p.Sq + idx] : 0.f;
    dlt[r] = ok ? p.delta[idx] : 0.f;
  }
  uint32_t q_hi[kD / 8][4], q_lo[kD / 8][4];
  bar_wait(qd_full, 0);
  load_a<kD>(q_hi, q_lo, q_raw + wg * kRaw64, shift);
  bar_arrive(q_read);
  const float* bias_bh = kBias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const float* kbb = kKeyBias ? p.key_bias + b * p.kbsb : nullptr;
  float dqa[kD / 2], sc[16], dp[16], t[16];
  uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dqa[i] = 0.f;
  // dS_j = P o (dP - D), P = exp((S - m) - log l): 0 for a masked key
  const auto form_ds = [&](int k0) {
    prep<kBwdCols, kTerms>(sc, t, p.scale, k0 + 2 * c, p.Sk, k0 + kBwdCols > p.Sk);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2_approx(((sc[i] - mx[r]) - lgl[r]) * kLog2e) * (dp[i] - dlt[r]);
    }
  };

  // step 0: S_0 and dP_0 alone
  if (kTerms) load_terms<kBwdCols, kBias, kKeyBias, false>(t, p, bias_bh, kbb, row, 2 * c);
  bar_wait(split_full, 0);
  turns.wait();
  wg_fence();
  product_rs<kD, kBwdCols>(sc, q_hi, q_lo, buf(0), buf(0) + kSplit);
  product_ss<kD, kBwdCols>(dp, do_hi, do_lo, buf(0) + 2 * kSplit, buf(0) + 3 * kSplit);
  wg_commit();
  turns.pass();
  wg_wait();
  keep(sc);
  keep(dp);
  form_ds(0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(ds_hi[kk], ds_lo[kk], sc + 4 * kk);

  for (int j = 1; j < n_tiles; ++j) {
    const int k0 = kBwdCols * j;
    if (kTerms) load_terms<kBwdCols, kBias, kKeyBias, false>(t, p, bias_bh, kbb, row, k0 + 2 * c);
    bar_wait(split_full + 8 * (j % kBufs), (j / kBufs) & 1);
    turns.wait();
    wg_fence();
    product_rs<kD, kBwdCols>(sc, q_hi, q_lo, buf(j), buf(j) + kSplit);                     // S = Q K^T
    product_ss<kD, kBwdCols>(dp, do_hi, do_lo, buf(j) + 2 * kSplit, buf(j) + 3 * kSplit);  // dP = dO V^T
    wg_commit();
    product_acc<kD, kBwdCols>(dqa, ds_hi, ds_lo, buf(j - 1) + 4 * kSplit,
                              buf(j - 1) + 5 * kSplit);  // dQ += dS_{j-1} K_{j-1}
    wg_commit();
    turns.pass();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S, dP
    keep(sc);
    keep(dp);
    form_ds(k0);
    wg_wait();  // dS_{j-1} K_{j-1}
    keep(dqa);
    keep(ds_hi);
    keep(ds_lo);
    bar_arrive(split_empty + 8 * ((j - 1) % kBufs));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(ds_hi[kk], ds_lo[kk], sc + 4 * kk);
  }
  turns.wait();
  wg_fence();
  product_acc<kD, kBwdCols>(dqa, ds_hi, ds_lo, buf(n_tiles - 1) + 4 * kSplit,
                            buf(n_tiles - 1) + 5 * kSplit);  // the last dS K
  wg_commit();
  turns.pass();
  wg_wait();
  keep(dqa);
  keep(ds_hi);
  keep(ds_lo);
  turns.finish();

  const long long oss = (long long)p.H * kDh, osb = (long long)p.Sq * oss;
  store_rows<kDh>(p.out + b * osb + (long long)h * kDh, oss, row, p.Sq, dqa, p.scale, p.scale,
                  c);
}

// ---------------------------------------------------------------------------
// dK/dV: a block walks the 32-query tiles for 128 keys
// ---------------------------------------------------------------------------

template <int kD>
struct DkvSmem {
  static constexpr uint32_t kRaw64 = 64 * kD * 4;         // 16 KB (10 KB at kD 40)
  static constexpr uint32_t kRaw = kBwdCols * kD * 4;     // a 32-row raw tile
  static constexpr uint32_t kRawStage = 2 * kRaw;         // Q, dO
  static constexpr uint32_t kA = 64 * kD * 4;             // a warpgroup's split V (hi or lo)
  static constexpr uint32_t kSplit = kBwdCols * kD * 4;
  static constexpr uint32_t kLd = 3 * kBwdCols * 4;       // a step's m, log l and D: 384 bytes
  static constexpr uint32_t kBuf = 8 * kSplit;  // Q hi, lo; dO hi, lo; Q^T hi, lo; dO^T hi, lo
  // V; the raw ring; the two buffers; each buffer's m, log l and D
  static constexpr uint32_t kV = 0, kRing = 4 * kA, kBufs = kRing + 2 * kRawStage;
  static constexpr uint32_t kLds = kBufs + 2 * kBuf, kBars = kLds + 2 * kLd;
  static constexpr size_t kSmem = 1024 + kBars + 8 * 8;
  static_assert(4 * kRaw64 <= kBuf, "K's and V's raw rows fit in buffer 0");
};

// As the forward: warpgroup 2 splits V once (the computing warpgroups'
// shared-memory A operand) and then the 32-query tiles (Q and dO, both
// also transposed, with their rows' m, log l and D); a computing
// warpgroup's step: S^T = K Q^T and dP^T = V dO^T in its turn, P^T and
// dS^T, dV += P^T dO and dK += dS^T Q in its next turn.
template <int kDh, bool kBias, bool kKeyBias>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_dkv_kernel(const Params p, const __grid_constant__ Maps maps) {
  constexpr int kD = Head<kDh>::kD;
  using S = DkvSmem<kD>;
  constexpr uint32_t kRaw64 = S::kRaw64, kRaw = S::kRaw, kRawStage = S::kRawStage;
  constexpr uint32_t kA = S::kA, kSplit = S::kSplit, kLd = S::kLd, kBuf = S::kBuf;
  constexpr uint32_t kV = S::kV, kRing = S::kRing, kBufs = S::kBufs, kLds = S::kLds;
  constexpr uint32_t kBars = S::kBars;
  constexpr bool kTerms = kBias || kKeyBias;
  const uint32_t base = smem_base();
  const uint32_t raw = base + kRing, bufs = base + kBufs;
  const uint32_t kv_full = base + kBars, k_read = kv_full + 8, raw_full = kv_full + 16;
  const uint32_t split_full = raw_full + 16, split_empty = split_full + 16;
  // K's and V's raw rows, in buffer 0 until they are read
  const uint32_t k_raw = bufs, v_raw = bufs + 2 * kRaw64;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x >> 7, shift = head_shift<kDh>(h);
  const int n_tiles = (p.Sq + kBwdCols - 1) / kBwdCols;
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    bar_init(k_read, 256);
    for (int s = 0; s < 2; ++s) {
      bar_init(raw_full + 8 * s, 1);
      bar_init(split_full + 8 * s, kSplitters);
      bar_init(split_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    splitter_regs();
    const int tid = threadIdx.x - 256;
    const long long rows_bh = ((long long)b * p.H + h) * p.Sq;
    const float* lgl = p.lse + (long long)p.B * p.H * p.Sq;  // log l
    const auto load_qd = [&](int i) {
      const uint32_t st = raw + (i & 1) * kRawStage, bar = raw_full + 8 * (i & 1);
      bar_expect(bar, kRawStage);
      tma_rows<kDh>(st, &maps.q32, bar, kBwdCols * i, h, b);
      tma_rows<kDh>(st + kRaw, &maps.do32, bar, kBwdCols * i, h, b);
    };
    if (tid == 0) {
      bar_expect(kv_full, 4 * kRaw64);
      tma_rows<kDh>(k_raw, &maps.k64, kv_full, k0, h, b);
      tma_rows<kDh>(k_raw + kRaw64, &maps.k64, kv_full, k0 + 64, h, b);
      tma_rows<kDh>(v_raw, &maps.v64, kv_full, k0, h, b);
      tma_rows<kDh>(v_raw + kRaw64, &maps.v64, kv_full, k0 + 64, h, b);
      load_qd(0);
      if (n_tiles > 1) load_qd(1);
    }
    bar_wait(kv_full, 0);
    split_rows<kD, 64>(v_raw, base + kV, base + kV + kA, tid, shift);  // warpgroup 0's keys
    split_rows<kD, 64>(v_raw + kRaw64, base + kV + 2 * kA, base + kV + 3 * kA, tid, shift);
    bar_wait(k_read, 0);  // K's raw rows read: buffer 0 is free
    splitters_sync();     // and V's, by every splitter
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i & 1;
      const uint32_t st = raw + s * kRawStage, buf = bufs + s * kBuf;
      if (i >= 2) bar_wait(split_empty + 8 * s, ((i >> 1) - 1) & 1);
      if (tid < kBwdCols) {  // the step's m, log l and D (0 past Sq, where queries are masked)
        const int qi = kBwdCols * i + tid;
        const bool ok = qi < p.Sq;
        const uint32_t ld = base + kLds + s * kLd + 4 * tid;
        st_shared(ld, ok ? p.lse[rows_bh + qi] : 0.f);
        st_shared(ld + 4 * kBwdCols, ok ? lgl[rows_bh + qi] : 0.f);
        st_shared(ld + 8 * kBwdCols, ok ? p.delta[rows_bh + qi] : 0.f);
      }
      bar_wait(raw_full + 8 * s, (i >> 1) & 1);
      split_rows<kD, kBwdCols>(st, buf, buf + kSplit, tid, shift);
      split_rows<kD, kBwdCols>(st + kRaw, buf + 2 * kSplit, buf + 3 * kSplit, tid, shift);
      split_cols<kD, kBwdCols>(st, buf + 4 * kSplit, buf + 5 * kSplit, tid, shift);
      split_cols<kD, kBwdCols>(st + kRaw, buf + 6 * kSplit, buf + 7 * kSplit, tid, shift);
      fence_async_smem();
      bar_arrive(split_full + 8 * s);
      splitters_sync();  // every splitter is done with raw stage s
      if (tid == 0 && i + 2 < n_tiles) load_qd(i + 2);
    }
    return;
  }

  compute_regs();
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Turns turns = {wg};
  turns.start();
  const uint32_t v_hi = base + kV + wg * 2 * kA, v_lo = v_hi + kA;
  // d[0]'s key; keys past Sk are computed from zero rows and not written
  const int key = k0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const float* bias_bh = kBias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const float* kbb = kKeyBias ? p.key_bias + b * p.kbsb : nullptr;
  uint32_t k_hi[kD / 8][4], k_lo[kD / 8][4];
  bar_wait(kv_full, 0);
  load_a<kD>(k_hi, k_lo, k_raw + wg * kRaw64, shift);
  bar_arrive(k_read);
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    const uint32_t buf = bufs + s * kBuf, ld = base + kLds + s * kLd;
    const int q0 = kBwdCols * i;
    float st[16], dpt[16];
    bar_wait(split_full + 8 * s, (i >> 1) & 1);
    turns.wait();
    wg_fence();
    product_rs<kD, kBwdCols>(st, k_hi, k_lo, buf, buf + kSplit);                    // S^T = K Q^T
    product_ss<kD, kBwdCols>(dpt, v_hi, v_lo, buf + 2 * kSplit, buf + 3 * kSplit);  // dP^T = V dO^T
    wg_commit();
    turns.pass();
    wg_wait();
    keep(st);
    keep(dpt);
    float t[16];
    if (kTerms) load_terms<kBwdCols, kBias, kKeyBias, true>(t, p, bias_bh, kbb, key, q0 + 2 * c);
    prep<kBwdCols, kTerms>(st, t, p.scale, q0 + 2 * c, p.Sq, q0 + kBwdCols > p.Sq);
    // P^T = exp((S^T - m) - log l): 0 for a masked query; dS^T = P^T o
    // (dP^T - D); m, log l and D of this thread's query columns 8 jj + 2 c + e
#pragma unroll
    for (int jj = 0; jj < kBwdCols / 8; ++jj) {
      const uint32_t col = 4 * (8 * jj + 2 * c);
      const float2 m = ld_shared2(ld + col), lg = ld_shared2(ld + 4 * kBwdCols + col),
                   dl = ld_shared2(ld + 8 * kBwdCols + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * jj + e;
        st[x] = exp2_approx(((st[x] - (e & 1 ? m.y : m.x)) - (e & 1 ? lg.y : lg.x)) * kLog2e);
        dpt[x] = st[x] * (dpt[x] - (e & 1 ? dl.y : dl.x));
      }
    }
    uint32_t a_hi[4][4], a_lo[4][4], b_hi[4][4], b_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(a_hi[kk], a_lo[kk], st + 4 * kk);
      acc_to_a(b_hi[kk], b_lo[kk], dpt + 4 * kk);
    }
    turns.wait();
    wg_fence();
    product_acc<kD, kBwdCols>(dv, a_hi, a_lo, buf + 6 * kSplit, buf + 7 * kSplit);  // dV += P^T dO
    product_acc<kD, kBwdCols>(dk, b_hi, b_lo, buf + 4 * kSplit, buf + 5 * kSplit);  // dK += dS^T Q
    wg_commit();
    turns.pass();
    wg_wait();
    keep(dk);
    keep(dv);
    keep(a_hi);
    keep(a_lo);
    keep(b_hi);
    keep(b_lo);
    bar_arrive(split_empty + 8 * s);
  }
  turns.finish();

  const long long kss = (long long)p.H * kDh, ksb = (long long)p.Sk * kss;
  const long long off = b * ksb + (long long)h * kDh;
  store_rows<kDh>(p.dk + off, kss, key, p.Sk, dk, p.scale, p.scale, c);
  store_rows<kDh>(p.dv + off, kss, key, p.Sk, dv, 1.f, 1.f, c);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// A map over a [B, S, H, kDh] float32 tensor with element strides (sb, ss,
// sh), boxes of ``box`` rows, unswizzled, zeros out of bounds.  Head dim
// 64: (64, S, H, B), boxes of 64 columns.  Head dim 34: the heads folded
// into the columns, (H * 34, S, B) with the row and batch strides (sh is
// 34: packed heads, which the wrapper checks), boxes of 40 columns at
// column 34 h (zeros past column H * 34).  A dimension of extent 1 is
// never stepped, so its stride is set to one any encoding accepts.
template <int kDh>
cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int B, int S, int H, long long sb,
                        long long ss, long long sh, int box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  CUresult r;
  if constexpr (kDh == 64) {
    const cuuint64_t row = (cuuint64_t)kDh * 4;
    const cuuint64_t dims[4] = {(cuuint64_t)kDh, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)ss * 4 : row,
                                   H > 1 ? (cuuint64_t)sh * 4 : row,
                                   B > 1 ? (cuuint64_t)sb * 4 : row};
    const cuuint32_t boxes[4] = {(cuuint32_t)kDh, (cuuint32_t)box, 1u, 1u};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, boxes,
           unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    (void)sh;
    // a row of H heads, on 16 bytes, where a stride is never stepped
    const cuuint64_t row = ((cuuint64_t)H * kDh * 4 + 15) / 16 * 16;
    const cuuint64_t row_stride = S > 1 ? (cuuint64_t)ss * 4 : row;
    const cuuint64_t dims[3] = {(cuuint64_t)H * kDh, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {row_stride,
                                   B > 1 ? (cuuint64_t)sb * 4 : row_stride * (cuuint64_t)S};
    const cuuint32_t boxes[3] = {(cuuint32_t)Head<kDh>::kD, (cuuint32_t)box, 1u};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, boxes,
           unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps a kernel reads: q, k, v with 64-row boxes (and, with
// ``backward``, dO with 64-row ones and all four with 32-row ones).
template <int kDh>
cudaError_t make_maps(const Params& p, Maps* m, bool backward) {
  const long long oss = (long long)p.H * kDh, osb = (long long)p.Sq * oss;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < (backward ? 2 : 1); ++i) {
    const int box = i == 0 ? 64 : 32;
    CUtensorMap* q = box == 64 ? &m->q64 : &m->q32;
    CUtensorMap* k = box == 64 ? &m->k64 : &m->k32;
    CUtensorMap* v = box == 64 ? &m->v64 : &m->v32;
    CUtensorMap* d = box == 64 ? &m->do64 : &m->do32;
    if (err == cudaSuccess)
      err = encode_rows<kDh>(q, p.q, p.B, p.Sq, p.H, p.qsb, p.qss, p.qsh, box);
    if (err == cudaSuccess)
      err = encode_rows<kDh>(k, p.k, p.B, p.Sk, p.H, p.ksb, p.kss, p.ksh, box);
    if (err == cudaSuccess)
      err = encode_rows<kDh>(v, p.v, p.B, p.Sk, p.H, p.vsb, p.vss, p.vsh, box);
    if (err == cudaSuccess && backward)
      err = encode_rows<kDh>(d, p.dout, p.B, p.Sq, p.H, osb, oss, kDh, box);
  }
  return err;
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

// The instance of a kernel at head dim kDh for the terms present:
// ``L::run<kDh, kBias, kKeyBias>``.
template <typename L, int kDh>
cudaError_t dispatch(const Params& p, bool backward, dim3 grid, cudaStream_t stream) {
  Maps maps;
  const cudaError_t err = make_maps<kDh>(p, &maps, backward);
  if (err != cudaSuccess) return err;
  if (p.bias != nullptr)
    return p.key_bias != nullptr ? L::template run<kDh, true, true>(p, maps, grid, stream)
                                 : L::template run<kDh, true, false>(p, maps, grid, stream);
  return p.key_bias != nullptr ? L::template run<kDh, false, true>(p, maps, grid, stream)
                               : L::template run<kDh, false, false>(p, maps, grid, stream);
}

// ``L`` at head dim 64 or 34
template <typename L>
cudaError_t dispatch_head(const Params& p, int head_dim, bool backward, dim3 grid,
                          cudaStream_t stream) {
  if (head_dim == 64) return dispatch<L, 64>(p, backward, grid, stream);
  if (head_dim == 34) return dispatch<L, 34>(p, backward, grid, stream);
  return cudaErrorInvalidValue;
}

struct Fwd {
  template <int kDh, bool kB, bool kKB>
  static cudaError_t run(const Params& p, const Maps& m, dim3 grid, cudaStream_t s) {
    return launch(wgmma_fwd_kernel<kDh, kB, kKB>, grid, FwdSmem<Head<kDh>::kD>::kSmem, s, p, m);
  }
};
struct Dq {
  template <int kDh, bool kB, bool kKB>
  static cudaError_t run(const Params& p, const Maps& m, dim3 grid, cudaStream_t s) {
    return launch(wgmma_dq_kernel<kDh, kB, kKB>, grid, DqSmem<Head<kDh>::kD>::kSmem, s, p, m);
  }
};
struct Dkv {
  template <int kDh, bool kB, bool kKB>
  static cudaError_t run(const Params& p, const Maps& m, dim3 grid, cudaStream_t s) {
    return launch(wgmma_dkv_kernel<kDh, kB, kKB>, grid, DkvSmem<Head<kDh>::kD>::kSmem, s, p, m);
  }
};

static_assert(FwdSmem<64>::kSmem <= 232448 && DqSmem<64>::kSmem <= 232448 &&
                  DkvSmem<64>::kSmem <= 232448,
              "over the 227 KB of shared memory a block can have");

}  // namespace

cudaError_t tf32_fwd(const Params& p, int head_dim, cudaStream_t stream) {
  return dispatch_head<Fwd>(p, head_dim, false, dim3((p.Sq + kRows - 1) / kRows, p.H, p.B),
                            stream);
}

cudaError_t tf32_dq(const Params& p, int head_dim, cudaStream_t stream) {
  return dispatch_head<Dq>(p, head_dim, true, dim3((p.Sq + kRows - 1) / kRows, p.H, p.B),
                           stream);
}

cudaError_t tf32_dkv(const Params& p, int head_dim, cudaStream_t stream) {
  return dispatch_head<Dkv>(p, head_dim, true, dim3((p.Sk + kRows - 1) / kRows, p.H, p.B),
                            stream);
}

}  // namespace vqflash
