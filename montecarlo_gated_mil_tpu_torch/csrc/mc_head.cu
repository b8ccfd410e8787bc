// Monte Carlo gated-attention head, forward: all T dropout samples of
//
//   Hd = feature_dropout(H)                                  (N, L)
//   logit[n, c] = sum_d tanh(Hd Wv[g] + bv[g])_d * sigmoid(Hd Wu[g] + bu[g])_d
//                 * wa_full[c, g, d] + ba[c]                 (N, C)
//   logit = attention_dropout(logit)
//   A = masked_softmax over N                                (C, N)
//   M = A Hd                                                 (C, L)
//
// Replaces the TPU kernels `_mc_kernel_sep` (G = C separate gates, K1) and
// `_mc_kernel` (G = 1 shared gate, K2) of
// montecarlo_gated_mil_tpu/ops/gated_attention.py.  wa_full is (C, G, D):
// for separate gates it is zero off the class's own gate, so class c's logit
// needs gate c alone; for a shared gate it is Wa transposed.
//
// What bounds it: the gate product, 2*N*L*(2*G*D) FLOP per sample, 98 % of
// the work.  The JAX kernel is exact f32, so it runs as 3xTF32 on the tensor
// cores (mc_tile.cuh): three TF32 products, 3 * 63 GFLOP at N = 3072 (2400
// valid), L = 512, D = 128, G = 2, T = 50, 0.39 ms at 495 TFLOP/s, against
// 0.94 ms for one f32 product on the FP32 cores.  Next come the dropout bits
// (one Philox4x32-10 call gives four elements, and each (t, n, l) is drawn
// once per call of this kernel) and the weights, 0.5 MB per gate, read from
// L2 by every block.  On the H100 the mma.sync pass below runs the product
// at about a fifth of the tensor-core peak: the split done in registers,
// eight warps per SM, bound by the latency of each 16-row weight stage; the
// wgmma pass (further below) takes the shapes where it is faster (PERF.md).
//
// Design.  Two launches, every sum in a fixed order (no float atomics: one
// seed gives bitwise the same output on every call):
//   1. mc_fwd_tile_kernel, one block per (row tile, gate group, t).  It
//      stages its rows of Hd in shared memory, dropout applied, and keeps
//      them there: the gate product streams the weights through a cp.async
//      ring against the resident tile (mma.sync, 3xTF32, each stage's
//      partial added on the FP32 cores: mc_tile.cuh), the epilogue forms
//      tanh * sigmoid, the wa dot, ba and the attention dropout, and then the
//      same tile gives the tile's softmax partials: its max m_j, its sum
//      s_j = sum exp(logit - m_j) and P_j = sum exp(logit - m_j) Hd (C, L).
//      So H is read once and each dropout bit drawn once per sample.  A tile
//      with no valid row does no product.  The row tile is 64, 32 or 16 rows
//      (mc_tile.cuh, plan_rows): as large as shared memory allows (16 at
//      r50's L = 2048) and small enough to give a block per SM at T = 1.
//      There separate gates also take one block each (class c needs only
//      gate c), which draws the tile's bits once per gate, and the 16- and
//      32-row tiles split L over two warp groups, so that each warp waits on
//      half as many weight stages.
//      Where forward_plan picks it, mc_fwd_wgmma_kernel does this pass
//      instead, for two samples of a 64-row tile per block.
//   2. mc_fwd_finalize_kernel, one block per (128 outputs, c, t): the global
//      max m and sum s = sum_j s_j exp(m_j - m), each folded over the tiles
//      by one warp in a fixed order, then A = exp(logit - m) / s and
//      M = sum_j exp(m_j - m) P_j / s.
// Rows are split across blocks in every pass; no ceiling is tied to N.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mc_tile.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace mch;

constexpr int FIN_THREADS = 128;

// Workspace layout, in floats: logits (T, C, N), tile max/sum (T, ntiles, C, 2),
// tile pools P (T, ntiles, C, L).
struct FwdWork {
  float *logits, *part_ms, *part_p;
};

inline FwdWork carve(float* work, int N, int L, int C, int T, int ntiles) {
  FwdWork w;
  w.logits = work;
  w.part_ms = w.logits + (size_t)T * C * N;
  w.part_p = w.part_ms + (size_t)T * ntiles * C * 2;
  return w;
}

template <int MT, int RW, int KS>
__global__ void __launch_bounds__(256) mc_fwd_tile_kernel(
    const float* __restrict__ H, const float* __restrict__ mask, int N, int L, int D, int C, int G,
    int gpb, const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ wu, const float* __restrict__ bu, const float* __restrict__ wa_full,
    const float* __restrict__ ba, uint32_t seed, float p_feat, float scale_f, float p_att,
    float scale_a, float* __restrict__ logits, float* __restrict__ part_ms,
    float* __restrict__ part_p) {
  constexpr int BM = 16 * MT * RW;
  extern __shared__ float4 smem4[];
  const int ldh = L + 4, DW = D / 32;
  float* Hs = reinterpret_cast<float*>(smem4);                // [BM][L + 4]
  float* stages = Hs + BM * ldh;                             // NSTAGE x [KS*BK][2D + 8]
  float* red = stages + NSTAGE * KS * BK * (2 * D + 8);      // [kMaxC][BM][DW]
  float* lg = red + kMaxC * BM * 4;                          // [kMaxC][BM]
  int* ok = reinterpret_cast<int*>(lg + kMaxC * BM);         // [BM] row valid
  const int tile = blockIdx.x, t = blockIdx.z, ntiles = gridDim.x;
  const int n0 = tile * BM;
  const int g0 = blockIdx.y * gpb;
  // The classes this block completes: every class when it holds every gate
  // (or the one shared gate), else class g0 of separate gates.
  const bool all_cls = G == 1 || gpb == G;
  const int c0 = all_cls ? 0 : g0, ncls = all_cls ? C : 1;
  const uint32_t key = seed + (uint32_t)t;
  const size_t pbase = ((size_t)t * ntiles + tile) * C;
  const int tid = threadIdx.x, nthr = blockDim.x;

  if (!set_row_flags(ok, BM, n0 + tid < N && mask[n0 + tid] > 0.f)) {
    for (int cc = tid; cc < ncls; cc += nthr) {
      part_ms[(pbase + c0 + cc) * 2] = kMaskFill;
      part_ms[(pbase + c0 + cc) * 2 + 1] = 0.f;
    }
    return;
  }
  load_hd_tile(Hs, ldh, H, ok, L, n0, BM, key, p_feat, scale_f, nullptr);
  for (int e = tid; e < ncls * BM; e += nthr) lg[e] = 0.f;

  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int rw = warp % RW, dj = (warp / RW) % DW, ks = warp / (RW * DW);
  float acc[MT][8][4];
  for (int g = g0; g < g0 + gpb; ++g) {
    gate_product<MT, KS>(Hs, ldh, stages, wv, wu, g, L, D, rw * MT * 16, dj * 32, ks, acc);
    // This thread's share of each class logit, per row it holds (warp
    // group 0 holds the sums).
#pragma unroll
    for (int mt = 0; mt < MT && ks == 0; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[kMaxC];
#pragma unroll
        for (int cc = 0; cc < kMaxC; ++cc) s[cc] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = dj * 32 + j * 8 + 2 * q + e;
            const float v = tanhf(acc[mt][j][2 * h + e] + bv[g * D + d]);
            const float u = sigmoidf_(acc[mt][j + 4][2 * h + e] + bu[g * D + d]);
            const float gate = v * u;
#pragma unroll
            for (int cc = 0; cc < kMaxC; ++cc)
              if (cc < ncls) s[cc] = fmaf(gate, wa_full[((size_t)(c0 + cc) * G + g) * D + d], s[cc]);
          }
        }
        const int row = rw * MT * 16 + mt * 16 + h * 8 + gq;
#pragma unroll
        for (int cc = 0; cc < kMaxC; ++cc) {
          if (cc < ncls) {
            float v = s[cc];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (q == 0) red[(cc * BM + row) * DW + dj] = v;
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < ncls * BM; e += nthr) {
      float v = lg[e];
      for (int w = 0; w < DW; ++w) v += red[e * DW + w];
      lg[e] = v;
    }
    __syncthreads();
  }

  // Logits: bias, attention dropout; masked rows leave the softmax.
  for (int e = tid; e < ncls * BM; e += nthr) {
    const int cc = e / BM, r = e - cc * BM, c = c0 + cc, n = n0 + r;
    float logit = lg[e] + ba[c];
    if (p_att > 0.f && n < N)
      logit = dropout_uniform(key, 1u, (uint32_t)(n * C + c)) >= p_att ? logit * scale_a : 0.f;
    if (n < N) logits[((size_t)t * C + c) * N + n] = logit;
    lg[e] = ok[r] ? logit : kMaskFill;
  }
  __syncthreads();
  // Tile max and sum per class; lg becomes the rows' softmax weights.
  if (tid < ncls) {
    float* w = lg + tid * BM;
    float m = kMaskFill;
    for (int r = 0; r < BM; ++r) m = fmaxf(m, w[r]);
    float s = 0.f;
    for (int r = 0; r < BM; ++r) {
      const float x = w[r] > kMaskFill ? expf(w[r] - m) : 0.f;
      w[r] = x;
      s += x;
    }
    part_ms[(pbase + c0 + tid) * 2] = m;
    part_ms[(pbase + c0 + tid) * 2 + 1] = s;
  }
  __syncthreads();
  // The tile's pool P_j[c, l] = sum_r weight[c, r] Hd[r, l], rows in order.
  for (int e = tid; e < ncls * L; e += nthr) {
    const int cc = e / L, l = e - cc * L;
    const float* w = lg + cc * BM;
    float p = 0.f;
    for (int r = 0; r < BM; ++r) p = fmaf(w[r], Hs[r * ldh + l], p);
    part_p[(pbase + c0 + cc) * L + l] = p;
  }
}

// ---------------------------------------------------- the wgmma tile pass
//
// mc_fwd_wgmma_kernel replaces mc_fwd_tile_kernel where the tile fits and
// fills the card (forward_plan): T >= 2, D % 64 == 0, L <= 512 (a 64-row H
// tile in shared memory beside the weight ring) and at least a block per
// SM over the tiles and sample pairs.  One block per
// (64-row tile, pair of samples t0 = 2 y, t0 + 1): the gate product runs on
// wgmma.m64n128k8 in 3xTF32, fed by TMA.
// - The gate weights come pre-split once per weight set (the wrapper's
//   `gate_split`, the same rounding as split_tf32): hi and lo planes of
//   (G, D / 64, 128, L), each 128-row block being 64 columns of Wv and the
//   same 64 of Wu, K-major as TF32 wgmma takes B.  A stage is 16 rows of L
//   of one block, both planes (16 KB, 64-byte swizzle), loaded by one
//   producer warp through a ring of full / empty mbarriers.
// - The raw H tile stays in shared memory, beside each sample's keep bits
//   (Philox, as load_hd_tile draws them).  Consumer warpgroup w takes sample
//   t0 + w: both read every weight stage, so one fetch from L2 feeds two
//   samples' 64 rows.  A (the dropped-out rows) is formed in registers from
//   H and the bits and split there; each stage's 16 rows go to a zeroed
//   partial as lo*hi, hi*lo, hi*hi per 8 rows (mma_3xtf32's order), which
//   is added to the accumulator on the FP32 cores (the promotion of
//   mc_tile.cuh).  Passes over 64 columns of D keep the registers to two
//   64 x 128 tiles, and each pass's tanh * sigmoid and wa dot complete in
//   the thread that holds both pre-activations.
// - The epilogue (bias, attention dropout, the tile's softmax partials and
//   pool) is mc_fwd_tile_kernel's, per warpgroup; sums run in a fixed order.
constexpr int G_ROWS = 64;                    // rows of a tile: one wgmma M
constexpr int G_N = 128;                      // gate columns per pass: 64 of Wv, the same 64 of Wu
constexpr int G_BK = 16;                      // rows of L per weight stage (64 bytes of f32)
constexpr int G_STAGE = 2 * G_N * G_BK * 4;   // bytes of a stage: the hi and lo planes
constexpr int G_THREADS = 384;                // two consumer warpgroups and a producer warpgroup
constexpr int G_MAX_STAGES = 8;
constexpr int G_MAX_L = 512;                  // the longest H row the pass takes

// Shared memory: the weight ring (1024-byte aligned, for the swizzle), the
// H tile [64][L + 4], the keep bits [2][64][L / 32], the logits [2][kMaxC][64],
// the row flags [64], the barriers.
inline size_t wgmma_smem(int L, int stages) {
  return 1024 + (size_t)stages * G_STAGE +
         4 * ((size_t)G_ROWS * (L + 4) + 2 * G_ROWS * (L / 32) + 2 * kMaxC * G_ROWS + G_ROWS) +
         2 * G_MAX_STAGES * 8;
}

// As many weight stages as fit, at least three; 0 where three do not fit.
inline int wgmma_stages(int L) {
  for (int s = G_MAX_STAGES; s >= 3; --s)
    if (wgmma_smem(L, s) <= (size_t)kSmemMax) return s;
  return 0;
}

__global__ void __launch_bounds__(G_THREADS, 1) mc_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ H,
    const float* __restrict__ mask, int N, int L, int D, int C, int G, int T, int stages,
    const float* __restrict__ bv, const float* __restrict__ bu, const float* __restrict__ wa_full,
    const float* __restrict__ ba, uint32_t seed, float p_feat, float scale_f, float p_att,
    float scale_a, float* __restrict__ logits, float* __restrict__ part_ms,
    float* __restrict__ part_p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int ldh = L + 4, words = L / 32, passes = D / 64, ksteps = L / G_BK;
  float* Hs = reinterpret_cast<float*>(ring + (size_t)stages * G_STAGE);
  uint32_t* kbits = reinterpret_cast<uint32_t*>(Hs + G_ROWS * ldh);
  float* lgs = reinterpret_cast<float*>(kbits + 2 * G_ROWS * words);
  int* ok = reinterpret_cast<int*>(lgs + 2 * kMaxC * G_ROWS);
  uint64_t* full = reinterpret_cast<uint64_t*>(ok + G_ROWS);
  uint64_t* empty = full + G_MAX_STAGES;
  const int tile = blockIdx.x, ntiles = gridDim.x, n0 = tile * G_ROWS;
  const int t0 = 2 * blockIdx.y, nact = t0 + 1 < T ? 2 : 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nact);  // every warp of the active consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!set_row_flags(ok, G_ROWS, n0 + tid < N && mask[n0 + tid] > 0.f)) {
    for (int e = tid; e < nact * C; e += blockDim.x) {
      const size_t i = (((size_t)(t0 + e / C) * ntiles + tile) * C + e % C) * 2;
      part_ms[i] = kMaskFill;
      part_ms[i + 1] = 0.f;
    }
    return;
  }
  if (warp < 8) {
    // The raw H tile (rows without a valid instance are zeros), then each
    // warpgroup's keep bits: bit l % 32 of word (r, l / 32), all ones
    // without dropout.  Eight neighbouring lanes hold one word's columns.
    const int l4 = L / 4;
    for (int e = tid; e < G_ROWS * l4; e += 256) {
      const int r = e / l4, l = (e - r * l4) * 4;
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok[r]) h = *reinterpret_cast<const float4*>(H + (size_t)(n0 + r) * L + l);
      *reinterpret_cast<float4*>(Hs + r * ldh + l) = h;
    }
    const int wg = warp / 4, wt = tid % 128;
    if (wg < nact) {
      const uint32_t key = seed + (uint32_t)(t0 + wg);
      uint32_t* kb = kbits + wg * G_ROWS * words;
      for (int e = wt; e < G_ROWS * l4; e += 128) {
        const int r = e / l4, l = (e - r * l4) * 4;
        uint32_t nib = 0xFu;
        if (p_feat > 0.f) {
          nib = 0u;
          if (ok[r]) {
            const uint4 w = dropout_words4(key, 0u, (uint32_t)((n0 + r) * L + l) >> 2);
            nib = (uint32_t)(word_uniform(w.x) >= p_feat) |
                  ((uint32_t)(word_uniform(w.y) >= p_feat) << 1) |
                  ((uint32_t)(word_uniform(w.z) >= p_feat) << 2) |
                  ((uint32_t)(word_uniform(w.w) >= p_feat) << 3);
          }
        }
        uint32_t word = nib << (4 * (lane & 7));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        if ((lane & 7) == 0) kb[r * words + (l >> 5)] = word;
      }
    }
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: every stage of every gate and pass, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int g = 0; g < G; ++g)
        for (int p = 0; p < passes; ++p)
          for (int kc = 0; kc < ksteps; ++kc, ++it) {
            const int s = it % stages;
            mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
            mbar_expect_tx(&full[s], G_STAGE);
            const int row = (g * passes + p) * G_N;
            tma_load_3d(ring + s * G_STAGE, &wmap, kc * G_BK, row, 0, &full[s]);
            tma_load_3d(ring + s * G_STAGE + G_STAGE / 2, &wmap, kc * G_BK, row, 1, &full[s]);
          }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4;
  if (wg >= nact) return;
  const int wt = tid % 128, gq = lane / 4, q = lane % 4;
  const int t = t0 + wg;
  const uint32_t key = seed + (uint32_t)t;
  const uint32_t* kb = kbits + wg * G_ROWS * words;
  const int r0 = (warp % 4) * 16 + gq;  // this thread's rows r0 and r0 + 8
  const float* h0 = Hs + r0 * ldh;
  const uint32_t* b0 = kb + r0 * words;

  // Each pass adds its share of every class logit into lg, row by row, in
  // pass order; the accumulators keep the registers meanwhile.
  float* lg = lgs + wg * kMaxC * G_ROWS;
  if (q == 0)  // the lane that adds rows r0 and r0 + 8
    for (int cc = 0; cc < C; ++cc) lg[cc * G_ROWS + r0] = lg[cc * G_ROWS + r0 + 8] = 0.f;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int it = 0;
  for (int g = 0; g < G; ++g) {
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < ksteps; ++kc, ++it) {
        // A: Hd at rows r0 (+8), columns k + q (+4) of each 8-row step.
        const int k = kc * G_BK;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k + kk * 8 + q + (i >> 1) * 4;
            const int row8 = (i & 1) * 8;  // rows r0, r0 + 8
            const float h = h0[row8 * ldh + col];
            const float hd = (b0[row8 * words + (col >> 5)] >> (col & 31)) & 1u ? h * scale_f : 0.f;
            split_tf32(hd, ah[kk][i], al[kk][i]);
          }
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint64_t dh = desc_sw64(smem_u32(ring + s * G_STAGE));
        const uint64_t dl = desc_sw64(smem_u32(ring + s * G_STAGE + G_STAGE / 2));
        fence_operands(part);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        // The next 8 rows of L: 32 bytes further along each weight row.
        wgmma_m64n128k8_tf32(part, al[0], dh, 0);
        wgmma_m64n128k8_tf32(part, ah[0], dl, 1);
        wgmma_m64n128k8_tf32(part, ah[0], dh, 1);
        wgmma_m64n128k8_tf32(part, al[1], dh + 2, 1);
        wgmma_m64n128k8_tf32(part, ah[1], dl + 2, 1);
        wgmma_m64n128k8_tf32(part, ah[1], dh + 2, 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(part);
        fence_operands(ah[0]);
        fence_operands(ah[1]);
        fence_operands(al[0]);
        fence_operands(al[1]);
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      // Columns 8 j + 2 q + e of the pass: Wv's column d = 64 p + 8 j + 2 q
      // + e at j < 8, Wu's same d at j + 8; registers 4 j + {0, 1} row r0,
      // 4 j + {2, 3} row r0 + 8.  The row sums over the four lanes of a row
      // go into lg.
      float s0[kMaxC], s1[kMaxC];
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) s0[cc] = s1[cc] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 64 * p + 8 * j + 2 * q + e;
          const float bvd = bv[g * D + d], bud = bu[g * D + d];
          const float g0 = tanhf(acc[4 * j + e] + bvd) * sigmoidf_(acc[4 * (j + 8) + e] + bud);
          const float g1 =
              tanhf(acc[4 * j + 2 + e] + bvd) * sigmoidf_(acc[4 * (j + 8) + 2 + e] + bud);
#pragma unroll
          for (int cc = 0; cc < kMaxC; ++cc)
            if (cc < C) {
              const float w = wa_full[((size_t)cc * G + g) * D + d];
              s0[cc] = fmaf(g0, w, s0[cc]);
              s1[cc] = fmaf(g1, w, s1[cc]);
            }
        }
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc)
        if (cc < C) {
          float a = s0[cc], b = s1[cc];
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          b += __shfl_xor_sync(0xffffffffu, b, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          b += __shfl_xor_sync(0xffffffffu, b, 2);
          if (q == 0) {
            lg[cc * G_ROWS + r0] += a;
            lg[cc * G_ROWS + r0 + 8] += b;
          }
        }
    }
  }

  // The tile's epilogue for sample t, in this warpgroup alone.
  named_sync(1 + wg, 128);
  const size_t pbase = ((size_t)t * ntiles + tile) * C;
  for (int e = wt; e < C * G_ROWS; e += 128) {
    const int c = e / G_ROWS, r = e - c * G_ROWS, n = n0 + r;
    float logit = lg[e] + ba[c];
    if (p_att > 0.f && n < N)
      logit = dropout_uniform(key, 1u, (uint32_t)(n * C + c)) >= p_att ? logit * scale_a : 0.f;
    if (n < N) logits[((size_t)t * C + c) * N + n] = logit;
    lg[e] = ok[r] ? logit : kMaskFill;
  }
  named_sync(1 + wg, 128);
  if (wt < C) {
    float* w = lg + wt * G_ROWS;
    float m = kMaskFill;
    for (int r = 0; r < G_ROWS; ++r) m = fmaxf(m, w[r]);
    float sum = 0.f;
    for (int r = 0; r < G_ROWS; ++r) {
      const float x = w[r] > kMaskFill ? expf(w[r] - m) : 0.f;
      w[r] = x;
      sum += x;
    }
    part_ms[(pbase + wt) * 2] = m;
    part_ms[(pbase + wt) * 2 + 1] = sum;
  }
  named_sync(1 + wg, 128);
  // The tile's pool P_j[c, l] = sum_r weight[c, r] Hd[r, l], rows in order.
  for (int e = wt; e < C * L; e += 128) {
    const int c = e / L, l = e - c * L;
    const float* w = lg + c * G_ROWS;
    float acc_p = 0.f;
    for (int r = 0; r < G_ROWS; ++r) {
      const float hd = (kb[r * words + (l >> 5)] >> (l & 31)) & 1u ? Hs[r * ldh + l] * scale_f : 0.f;
      acc_p = fmaf(w[r], hd, acc_p);
    }
    part_p[(pbase + c) * L + l] = acc_p;
  }
}

// Fixed-order sum or max over one warp: lanes fold in a butterfly.
template <bool MAX>
__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  return v;
}

__global__ void __launch_bounds__(FIN_THREADS) mc_fwd_finalize_kernel(
    const float* __restrict__ mask, int N, int L, int C, int ntiles,
    const float* __restrict__ logits, const float* __restrict__ part_ms,
    const float* __restrict__ part_p, float* __restrict__ A, float* __restrict__ M) {
  extern __shared__ float4 smem4[];
  float* wj = reinterpret_cast<float*>(smem4);  // [ntiles]: exp(m_j - m), 0 for empty tiles
  __shared__ float ms[2];
  const int c = blockIdx.y, t = blockIdx.z, tid = threadIdx.x, lane = tid & 31;
  const int e = blockIdx.x * blockDim.x + tid;
  const float* pm = part_ms + ((size_t)t * ntiles * C + c) * 2;  // tile j at pm[j * 2C]
  if (tid < 32) {
    float m = kMaskFill;
    for (int j = lane; j < ntiles; j += 32) m = fmaxf(m, pm[(size_t)j * 2 * C]);
    m = warp_fold<true>(m);
    if (lane == 0) ms[0] = m;
  }
  __syncthreads();
  const float m = ms[0];
  for (int j = tid; j < ntiles; j += blockDim.x)
    wj[j] = pm[(size_t)j * 2 * C + 1] > 0.f ? expf(pm[(size_t)j * 2 * C] - m) : 0.f;
  __syncthreads();
  if (tid < 32) {
    float s = 0.f;
    for (int j = lane; j < ntiles; j += 32) s = fmaf(pm[(size_t)j * 2 * C + 1], wj[j], s);
    s = warp_fold<false>(s);
    if (lane == 0) ms[1] = s;
  }
  __syncthreads();
  const float s = ms[1];
  if (e < N) {
    const size_t i = ((size_t)t * C + c) * N + e;
    A[i] = (s > 0.f && mask[e] > 0.f) ? expf(logits[i] - m) / s : 0.f;
  } else if (e < N + L) {
    const int l = e - N;
    const float* p = part_p + ((size_t)t * ntiles * C + c) * L + l;  // tile j at p[j * C * L]
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < ntiles; ++j) {
      const float w = wj[j];
      if (w > 0.f) acc = fmaf(w, p[(size_t)j * C * L], acc);
    }
    M[((size_t)t * C + c) * L + l] = s > 0.f ? acc / s : 0.f;
  }
}

template <int MT, int RW, int KS>
cudaError_t launch_tile(const RowPlan& plan, int D, cudaStream_t s, const float* H,
                        const float* mask, int N, int L, int C, int G, int T, const float* wv,
                        const float* bv, const float* wu, const float* bu, const float* wa_full,
                        const float* ba, uint32_t seed, float p_feat, float scale_f, float p_att,
                        float scale_a, const FwdWork& w) {
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(mc_fwd_tile_kernel<MT, RW, KS>, plan.smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(plan.ntiles, G / plan.gpb, T);
  mc_fwd_tile_kernel<MT, RW, KS><<<grid, gate_block_threads(plan, D), plan.smem, s>>>(
      H, mask, N, L, D, C, G, plan.gpb, wv, bv, wu, bu, wa_full, ba, seed, p_feat, scale_f,
      p_att, scale_a, w.logits, w.part_ms, w.part_p);
  return cudaGetLastError();
}

// Which tile pass runs and over how many row tiles: the wgmma pass where
// it fits (see mc_fwd_wgmma_kernel), else mc_fwd_tile_kernel on plan_rows's
// tiles.  ntiles = 0: no pass takes the shapes.
struct ForwardPlan {
  bool wgmma;
  int ntiles, stages;
  RowPlan rows;
};

inline ForwardPlan forward_plan(int N, int L, int D, int G, int T) {
  ForwardPlan f = {false, 0, 0, plan_rows(N, L, D, G, T)};
  f.stages = wgmma_stages(L);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long blocks = (long)((N + G_ROWS - 1) / G_ROWS) * ((T + 1) / 2);
  f.wgmma = T >= 2 && D % 64 == 0 && L <= G_MAX_L && f.stages > 0 && blocks >= sms;
  f.ntiles = f.wgmma ? (N + G_ROWS - 1) / G_ROWS : f.rows.ntiles;
  return f;
}

cudaError_t launch_wgmma(const ForwardPlan& f, cudaStream_t s, const float* H, const float* mask,
                         int N, int L, int D, int C, int G, int T, const float* wsplit,
                         const float* bv, const float* bu, const float* wa_full, const float* ba,
                         uint32_t seed, float p_feat, float scale_f, float p_att, float scale_a,
                         const FwdWork& w) {
  if (wsplit == nullptr) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // wsplit (2, G, D / 64, 128, L) as (L, G * 2 D, 2): boxes of 16 x 128 x 1.
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)L, (cuuint64_t)G * 2 * D, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)L * 4, (cuuint64_t)G * 2 * D * L * 4};
  const cuuint32_t box[3] = {G_BK, G_N, 1}, ones[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(wsplit), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem(L, f.stages);
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(mc_fwd_wgmma_kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(f.ntiles, (T + 1) / 2);
  mc_fwd_wgmma_kernel<<<grid, G_THREADS, smem, s>>>(map, H, mask, N, L, D, C, G, T, f.stages, bv,
                                                    bu, wa_full, ba, seed, p_feat, scale_f, p_att,
                                                    scale_a, w.logits, w.part_ms, w.part_p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch mc_head_forward needs, or -1 for shapes it cannot take.
long mc_head_forward_workspace(int N, int L, int D, int C, int G, int T) {
  if (!shapes_ok(N, L, D, C, G, T)) return -1;
  const ForwardPlan f = forward_plan(N, L, D, G, T);
  if (!f.wgmma && f.rows.bm == 0) return -1;
  return (long)T * C * N + (long)T * f.ntiles * C * (2 + (long)L);
}

// Shapes: H (N, L); mask (N,) 1.0/0.0; wv, wu (G, L, D); bv, bu (G, D);
// wa_full (C, G, D); ba (C,); wsplit (2, G, D / 64, 128, L), the gate
// weights' TF32 hi and lo planes, each 128-row block 64 columns of Wv then
// the same 64 of Wu, K-major (null where D % 64 != 0); work:
// mc_head_forward_workspace(...) floats; A out (T, C, N); M out (T, C, L).
// All float32, contiguous, on the device of `stream`.  Returns the
// cudaError_t of the launches (0 = success).
int mc_head_forward(const float* H, const float* mask, int N, int L, int D, int C, int G, int T,
                    const float* wv, const float* bv, const float* wu, const float* bu,
                    const float* wa_full, const float* ba, const float* wsplit, unsigned int seed,
                    float p_feat, float scale_f, float p_att, float scale_a, float* work, float* A,
                    float* M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(N, L, D, C, G, T)) return (int)cudaErrorInvalidValue;
  const ForwardPlan f = forward_plan(N, L, D, G, T);
  if (!f.wgmma && f.rows.bm == 0) return (int)cudaErrorInvalidValue;
  const FwdWork w = carve(work, N, L, C, T, f.ntiles);
  cudaError_t err;
  if (f.wgmma) {
    err = launch_wgmma(f, s, H, mask, N, L, D, C, G, T, wsplit, bv, bu, wa_full, ba, seed, p_feat,
                       scale_f, p_att, scale_a, w);
  } else {
    const RowPlan& plan = f.rows;
#define MCH_LAUNCH_TILE(MT, RW, KS)                                                       \
  launch_tile<MT, RW, KS>(plan, D, s, H, mask, N, L, C, G, T, wv, bv, wu, bu, wa_full, ba, seed, \
                          p_feat, scale_f, p_att, scale_a, w)
    err = MCH_DISPATCH_ROWS(plan, MCH_LAUNCH_TILE);
#undef MCH_LAUNCH_TILE
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + L + FIN_THREADS - 1) / FIN_THREADS, C, T);
  mc_fwd_finalize_kernel<<<grid, FIN_THREADS, f.ntiles * sizeof(float), s>>>(
      mask, N, L, C, f.ntiles, w.logits, w.part_ms, w.part_p, A, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
