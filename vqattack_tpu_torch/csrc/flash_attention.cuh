// The float32 flash-attention kernels' call contract, shared by the entry
// points in flash_attention.cu and the Hopper kernels of
// flash_attention_tf32.cu (one library: both are linked together).
#pragma once

#include <cuda_runtime.h>

namespace vqflash {

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // nullptr: no bias
  const float* key_bias;  // nullptr: no key bias; [1|B, Sk]
  const float* o;     // backward: forward output, contiguous [B, Sq, H, Dh]
  const float* lse;   // backward: the forward's out_lse
  const float* dout;  // backward: contiguous [B, Sq, H, Dh]
  float* out;         // forward: O; backward: dQ   (contiguous [B, Sq, H, Dh])
  float* out_lse;     // forward: m, then log l ([2, B, H, Sq])
  float* dk;          // contiguous [B, Sk, H, Dh]
  float* dv;          // contiguous [B, Sk, H, Dh]
  float* delta;       // backward: D [B, H, Sq]
  float* dbias;       // backward: the bias's gradient (dbias planes, [planes, H, Sq, Sk]);
                      // nullptr: not asked for
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long bsb, bsh, bsq, bsk;
  long long kbsb;  // the key bias's batch stride (0: broadcast)
  int B, H, Sq, Sk;
  int cluster;  // dbias: blocks a cluster, along z (batch rows summed together)
  float scale;
};

// The Hopper kernels (flash_attention_tf32.cu) at head dim 64 or 34: the
// forward (O and m, log l), and the backward's dK/dV and dQ passes, which
// read D from p.delta.  At head dim 34 q, k and v have packed heads (head
// stride 34), row and batch strides of multiples of 4 floats and a base on
// 16 bytes, and H * 34 is a multiple of 4 (dO's rows).  Each returns the
// launch's error (cudaErrorInvalidValue for another head dim, or for a
// tensor its TMA map cannot take).
cudaError_t tf32_fwd(const Params& p, int head_dim, cudaStream_t stream);
cudaError_t tf32_dkv(const Params& p, int head_dim, cudaStream_t stream);
cudaError_t tf32_dq(const Params& p, int head_dim, cudaStream_t stream);

}  // namespace vqflash
