// Philox4x32-10 counter-based generator (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC'11), the dropout bits of the MC head.
//
// It replaces the TPU kernels' hardware PRNG (`_uniform` in
// montecarlo_gated_mil_tpu/ops/gated_attention.py), which a GPU does not
// have.  A draw is a pure function of (key, counter), so any block can make
// any element's bit in any order, and the pooling pass regenerates the
// feature-dropout mask instead of storing it.  ops/gated_attention.py holds
// the bit-exact PyTorch twin (`philox4x32_10`), pinned by Random123's
// known-answer vectors.
#pragma once
#include <stdint.h>

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, ctr.x), lo0 = PHILOX_M0 * ctr.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, ctr.z), lo1 = PHILOX_M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// U[0,1) for element `index` of draw `draw` (0 = feature mask, 1 = attention
// mask) of sample key `key` (= seed + t): the top 24 bits of output word 0
// of counter (index, 0, 0, 0) under key (key, draw), as `_uniform` does.
__device__ __forceinline__ float dropout_uniform(uint32_t key, uint32_t draw, uint32_t index) {
  const uint4 out = philox4x32_10(make_uint4(index, 0u, 0u, 0u), key, draw);
  return (float)(out.x >> 8) * 5.9604644775390625e-08f;  // 2^-24
}
