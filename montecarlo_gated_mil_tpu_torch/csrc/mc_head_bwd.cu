// Monte Carlo gated-attention head, backward: the gradients of the T-sample
// forward in mc_head.cu with respect to H and every head weight, summed over
// the T samples,
//
//   dA'   = dA + Hd dM^T                         (T, C, N)  softmax input cot.
//   dlgt  = A (dA' - sum_n A dA') * keep_a/(1-p_att)
//   dG_g  = sum_c dlgt[c] wa_full[c, g]          (N, D) per gate
//   dzv   = dG U (1 - V^2),  dzu = dG V U (1 - U)
//   dH    = sum_t keep_f/(1-p_feat) * (A^T dM + dzv Wv^T + dzu Wu^T)
//   dWv   = sum_t Hd^T dzv,  dWu = sum_t Hd^T dzu,  dbv/dbu = sum dz
//   dwa   = sum dlgt G (each class's own gate only),  dba = sum dlgt
//
// Replaces the TPU kernels `_mc_bwd_kernel` (shared gate, G = 1, K4) and
// `_mc_bwd_kernel_sep` (separate gates, G = C, K5) of
// montecarlo_gated_mil_tpu/ops/gated_attention.py.
//
// What bounds it: three products of 2*N*L*(2*G*D) FLOP per sample (the gate
// recompute, dH = dz W^T and dW = Hd^T dz), run as 3xTF32 on the tensor
// cores with partial sums promoted to the FP32 cores (mc_tile.cuh), since
// the JAX kernel is exact f32.  At training's
// N = 1024 (650 valid), L = 512, D = 128, G = 2, T = 1 that is 3 x 1.0 GFLOP,
// 6 us at 495 TFLOP/s; the bytes (H, dH, the weights and their gradients)
// are about 6 MB, 2 us.  So at T = 1 what bounds it in practice is filling
// 132 SMs with work that is small, in few launches.
//
// Design.  Five launches, keyed so that N = 1024 at T = 1 gives from 64
// (41 with work) to 512 blocks each, every sum taken
// in a fixed order (no float atomics: one seed gives the same bits on every
// call, as the forward does):
//   1. bwd_gate_kernel, per (row tile, gate group, t), the forward's tiling
//      (plan_rows): the dropout-masked Hd tile in shared memory, the gate
//      recompute on it (mma.sync, 3xTF32), whose epilogue stores the gate
//      G = V U and the derivative factors U (1 - V^2) and V U (1 - U); the
//      first gate group also forms dA' = dA + Hd dM^T for its rows (dM[t]
//      staged in shared memory), the tile's partial of sum_n A dA', and the
//      feature-keep bits (one bit per (t, n, l)), so that later passes never
//      draw them again.
//   2. bwd_dz_kernel, per 8 rows, looping over t in order: sum_n A dA' from
//      the tiles' partials (one warp per class, a fixed fold), dlgt, and
//      dz = dG * the stored factors, written once to (T, N, 2GD); per-block
//      partials of dbv, dbu, dwa and dba.
//   3. bwd_dh_kernel, per (16 rows, 64 columns of L), looping over t in
//      order: dH = dz W^T (mma.sync, 3xTF32, dz arriving by cp.async) plus
//      A^T dM, times the keep bits.  The block walks the depth K = 2 G D in
//      chunks of whole gates, as many as its shared memory holds beside the
//      rows' dz (dh_chunk): where the whole depth fits (every shape at
//      D <= 64, and G <= 2 at D = 128) the W^T columns stay resident across
//      t; otherwise each chunk's W^T columns and dz rows are staged in turn
//      for every t.  The accumulator carries across chunks in registers and
//      the k order is the same, so both give the same bits.
//   4. bwd_dw_kernel, per (64 of L, 64 of 2GD, slice of the T*N rows): split
//      K partials of Hd^T dz.  Neither operand is K-major here (Hd^T is
//      [n][l], dz is [n][2GD]); mma.sync takes them as they are, since its
//      fragments are loaded from shared memory in either orientation, so dz
//      keeps the layout pass 2 writes and nothing is transposed.
//   5. bwd_reduce_kernel: every partial summed in a fixed order into the
//      outputs.
// A row takes part in sample t iff some A[t, c, n] != 0: padded rows (A is
// exactly 0 there) and rows whose weight underflowed contribute exactly 0 to
// every gradient, so the kernel needs no mask, does no product for a tile
// without such a row, and writes dH = 0 there.  Both dropout masks are
// regenerated from the forward's Philox keying (seed + t; draw 0 at element
// n*L + l, draw 1 at n*C + c; element e is word e % 4 of counter e / 4).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_tile.cuh"

namespace {

using namespace mch;

constexpr int BM2 = 16;     // rows per dH block
constexpr int DZ_ROWS = 8;  // rows per dz block
constexpr int DW_TILE = 64; // output tile edge of the dW blocks
constexpr int DW_LD = DW_TILE + 8;
constexpr int DW_ROWS = 32;  // rows of T*N per step of a dW block
constexpr int RED_THREADS = 256;

inline size_t a4(size_t x) { return (x + 3) & ~(size_t)3; }

// Workspace layout, in floats (each part 16-byte aligned).
struct BwdWork {
  float *dap, *part_s;
  uint32_t* bits;
  float *phi, *gate, *dz, *part_b, *part_wa, *part_ba, *part_w;
  size_t total;
};

inline BwdWork carve(float* work, int N, int L, int D, int C, int G, int T, int ntiles1,
                     int ntiles_z, int slices) {
  const size_t K = 2 * (size_t)G * D;
  BwdWork w;
  size_t off = 0;
  auto take = [&](size_t n) { float* p = work + off; off += a4(n); return p; };
  w.dap = take((size_t)T * C * N);
  w.part_s = take((size_t)T * ntiles1 * C);
  w.bits = reinterpret_cast<uint32_t*>(take((size_t)T * N * (L / 32)));
  w.phi = take((size_t)T * N * K);
  w.gate = take((size_t)T * N * G * D);
  w.dz = take((size_t)T * N * K);
  w.part_b = take((size_t)ntiles_z * K);
  w.part_wa = take((size_t)ntiles_z * C * D);
  w.part_ba = take((size_t)ntiles_z * C);
  w.part_w = take((size_t)slices * L * K);
  w.total = off;
  return w;
}

// Whether row n takes part in sample t: some A[t, c, n] != 0.
__device__ __forceinline__ bool row_active(const float* __restrict__ A, int N, int C, int t,
                                           int n) {
  if (n >= N) return false;
  bool on = false;
  for (int c = 0; c < C; ++c) on = on || A[((size_t)t * C + c) * N + n] != 0.f;
  return on;
}

// Fixed-order sum over one warp: lanes fold in a butterfly.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 1. Gate recompute, dA' and its tile partials, keep bits.
template <int MT, int RW, int KS>
__global__ void __launch_bounds__(256) bwd_gate_kernel(
    const float* __restrict__ H, int N, int L, int D, int C, int G, int gpb,
    const float* __restrict__ wv, const float* __restrict__ bv, const float* __restrict__ wu,
    const float* __restrict__ bu, const float* __restrict__ A, const float* __restrict__ dM,
    const float* __restrict__ dA, uint32_t seed, float p_feat, float scale_f,
    float* __restrict__ dap, float* __restrict__ part_s, uint32_t* __restrict__ bits,
    float* __restrict__ phi, float* __restrict__ gate_out) {
  constexpr int BM = 16 * MT * RW;
  extern __shared__ float4 smem4[];
  const int ldh = L + 4;
  float* Hs = reinterpret_cast<float*>(smem4);       // [BM][L + 4]
  float* stages = Hs + BM * ldh;                          // NSTAGE x [KS*BK][2D + 8]
  float* sdap = stages + NSTAGE * KS * BK * (2 * D + 8);  // [kMaxC][BM]
  int* ok = reinterpret_cast<int*>(sdap + kMaxC * BM);
  const int tile = blockIdx.x, t = blockIdx.z, ntiles = gridDim.x;
  const int n0 = tile * BM, g0 = blockIdx.y * gpb;
  const bool first = blockIdx.y == 0;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const uint32_t key = seed + (uint32_t)t;
  const int K = 2 * G * D;

  if (!set_row_flags(ok, BM, row_active(A, N, C, t, n0 + tid))) {
    if (first && tid < C) part_s[((size_t)t * ntiles + tile) * C + tid] = 0.f;
    return;
  }
  load_hd_tile(Hs, ldh, H, ok, L, n0, BM, key, p_feat, scale_f,
               first ? bits + (size_t)t * N * (L / 32) : nullptr);
  if (first) {
    // dA' = dA + Hd . dM[t, c]: one warp per (class, row), dM[t] staged in
    // the (not yet used) weight stages when it fits.
    const float* dm = dM + (size_t)t * C * L;
    const bool staged = C * L <= NSTAGE * KS * BK * (2 * D + 8);
    if (staged) {
      for (int e = tid; e < C * L / 4; e += nthr)
        reinterpret_cast<float4*>(stages)[e] = reinterpret_cast<const float4*>(dm)[e];
      dm = stages;
    }
    __syncthreads();
    for (int pr = warp; pr < C * BM; pr += nwarps) {
      const int c = pr / BM, r = pr - c * BM;
      if (!ok[r]) continue;
      float v = 0.f;
#pragma unroll 4
      for (int l = lane; l < L; l += 32) v = fmaf(Hs[r * ldh + l], dm[c * L + l], v);
      v = warp_sum(v);
      if (lane == 0) {
        const size_t i = ((size_t)t * C + c) * N + n0 + r;
        v += dA[i];
        dap[i] = v;
        sdap[c * BM + r] = v;
      }
    }
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r)
        if (ok[r]) s = fmaf(A[((size_t)t * C + tid) * N + n0 + r], sdap[tid * BM + r], s);
      part_s[((size_t)t * ntiles + tile) * C + tid] = s;
    }
  }
  __syncthreads();  // Hs complete; the stages are free again

  const int gq = lane >> 2, q = lane & 3;
  const int DW = D / 32;
  const int rw = warp % RW, dj = (warp / RW) % DW, ks = warp / (RW * DW);
  float acc[MT][8][4];
  for (int g = g0; g < g0 + gpb; ++g) {
    gate_product<MT, KS>(Hs, ldh, stages, wv, wu, g, L, D, rw * MT * 16, dj * 32, ks, acc);
#pragma unroll
    for (int mt = 0; mt < MT && ks == 0; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rw * MT * 16 + mt * 16 + gq + (i >> 1) * 8;
        if (!ok[r]) continue;
        const size_t row = (size_t)t * N + n0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dj * 32 + j * 8 + 2 * q + (i & 1);
          const float v = tanhf(acc[mt][j][i] + bv[g * D + d]);
          const float u = sigmoidf_(acc[mt][j + 4][i] + bu[g * D + d]);
          phi[row * K + g * 2 * D + d] = u * (1.f - v * v);
          phi[row * K + g * 2 * D + D + d] = v * u * (1.f - u);
          gate_out[(row * G + g) * D + d] = v * u;
        }
      }
    }
  }
}

// 2. dz = dG * [U (1 - V^2) | V U (1 - U)] for 8 rows, every t in order,
// written to (T, N, 2GD) (0 on rows that take no part), with this block's
// partials of dbv, dbu, dwa and dba.  The values the loops need (the
// tiles' partial sums, A of the rows, wa_full) are staged in shared memory
// first, so that no thread walks a chain of global loads.
__global__ void __launch_bounds__(256) bwd_dz_kernel(
    int N, int D, int C, int G, int T, int ntiles1, const float* __restrict__ wa_full,
    const float* __restrict__ A, const float* __restrict__ dap, const float* __restrict__ part_s,
    const float* __restrict__ phi, const float* __restrict__ gate, uint32_t seed, float p_att,
    float scale_a, float* __restrict__ dz, float* __restrict__ part_b,
    float* __restrict__ part_wa, float* __restrict__ part_ba) {
  extern __shared__ float4 smem4[];
  const int K = 2 * G * D, ld = K + 4;
  float* Zs = reinterpret_cast<float*>(smem4);  // [DZ_ROWS][K + 4]
  float* pb = Zs + DZ_ROWS * ld;                    // [K]
  float* pwa = pb + K;                          // [C][D]
  float* was = pwa + C * D;                     // [C][G][D] wa_full
  float* ps = was + C * G * D;                  // [ntiles1][C] this sample's tile partials
  float* As = ps + ntiles1 * C;                 // [C][DZ_ROWS]
  float* dl = As + C * DZ_ROWS;                     // [C][DZ_ROWS]
  float* pba = dl + C * DZ_ROWS;                    // [C]
  float* sc = pba + kMaxC;                      // [C]: sum_n A dA'
  int* ok = reinterpret_cast<int*>(sc + kMaxC);  // [DZ_ROWS]
  const int tile = blockIdx.x, n0 = tile * DZ_ROWS;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int rows = N - n0 < DZ_ROWS ? N - n0 : DZ_ROWS;

  for (int e = tid; e < K; e += nthr) pb[e] = 0.f;
  for (int e = tid; e < C * D; e += nthr) pwa[e] = 0.f;
  if (tid < C) pba[tid] = 0.f;
  for (int e = tid; e < C * G * D; e += nthr) was[e] = wa_full[e];
  for (int t = 0; t < T; ++t) {
    const uint32_t key = seed + (uint32_t)t;
    for (int e = tid; e < ntiles1 * C; e += nthr) ps[e] = part_s[(size_t)t * ntiles1 * C + e];
    for (int e = tid; e < C * DZ_ROWS; e += nthr) {
      const int c = e / DZ_ROWS, n = n0 + e - c * DZ_ROWS;
      As[e] = n < N ? A[((size_t)t * C + c) * N + n] : 0.f;
    }
    __syncthreads();
    if (warp < C) {  // sum_n A dA' of class `warp`, over the tiles in a fixed order
      float s = 0.f;
      for (int j = lane; j < ntiles1; j += 32) s += ps[j * C + warp];
      s = warp_sum(s);
      if (lane == 0) sc[warp] = s;
    }
    bool active = false;
    for (int c = 0; c < C && tid < DZ_ROWS; ++c) active = active || As[c * DZ_ROWS + tid] != 0.f;
    float* dzt = dz + ((size_t)t * N + n0) * K;
    if (!set_row_flags(ok, DZ_ROWS, active)) {
      for (int e = tid; e < rows * K; e += nthr) dzt[e] = 0.f;
      continue;
    }
    for (int e = tid; e < C * DZ_ROWS; e += nthr) {
      const int c = e / DZ_ROWS, r = e - c * DZ_ROWS, n = n0 + r;
      float v = 0.f;
      if (ok[r]) {
        v = As[e] * (dap[((size_t)t * C + c) * N + n] - sc[c]);
        if (p_att > 0.f)
          v = dropout_uniform(key, 1u, (uint32_t)(n * C + c)) >= p_att ? v * scale_a : 0.f;
      }
      dl[e] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < DZ_ROWS * K; e += nthr) {
      const int r = e / K, j = e - r * K;
      float z = 0.f;
      if (ok[r]) {
        const int g = j / (2 * D), rem = j - g * 2 * D, d = rem < D ? rem : rem - D;
        float dG = 0.f;
        for (int c = 0; c < C; ++c) dG = fmaf(dl[c * DZ_ROWS + r], was[(c * G + g) * D + d], dG);
        z = dG * phi[((size_t)t * N + n0 + r) * K + j];
      }
      Zs[r * ld + j] = z;
      if (r < rows) dzt[e] = z;
    }
    __syncthreads();
    for (int j = tid; j < K; j += nthr) {
      float s = pb[j];
      for (int r = 0; r < DZ_ROWS; ++r) s += Zs[r * ld + j];
      pb[j] = s;
    }
    for (int e = tid; e < C * D; e += nthr) {
      const int c = e / D, d = e - c * D, gc = G == 1 ? 0 : c;
      const float* gt = gate + (((size_t)t * N + n0) * G + gc) * D + d;  // row r at gt[r*G*D]
      float gv[DZ_ROWS];
#pragma unroll
      for (int r = 0; r < DZ_ROWS; ++r) gv[r] = ok[r] ? gt[(size_t)r * G * D] : 0.f;
      float s = pwa[e];
#pragma unroll
      for (int r = 0; r < DZ_ROWS; ++r) s = fmaf(dl[c * DZ_ROWS + r], gv[r], s);
      pwa[e] = s;
    }
    if (tid < C) {
      float s = pba[tid];
      for (int r = 0; r < DZ_ROWS; ++r) s += dl[tid * DZ_ROWS + r];
      pba[tid] = s;
    }
    __syncthreads();  // the staged values are rewritten for the next sample
  }
  __syncthreads();
  for (int e = tid; e < K; e += nthr) part_b[(size_t)tile * K + e] = pb[e];
  for (int e = tid; e < C * D; e += nthr) part_wa[(size_t)tile * C * D + e] = pwa[e];
  if (tid < C) part_ba[(size_t)tile * C + tid] = pba[tid];
}

// 3. dH for (16 rows, 64 columns of L), summed over t in order:
// keep_f / (1 - p_feat) * (dz W^T + A^T dM).  RESIDENT (KC = K): the W^T
// columns are staged once and stay in shared memory across t.  Otherwise
// the depth K walks in chunks of KC columns (whole gates; the last may be
// shorter), each chunk's W^T columns and dz rows staged by cp.async for
// every t.  8 warps, one 8-column slice each, the product split over two
// accumulators and promoted every 64 of K (mc_tile.cuh) across the chunks.
template <bool RESIDENT>
__global__ void __launch_bounds__(256) bwd_dh_kernel(
    int N, int L, int D, int C, int G, int T, int KC, const float* __restrict__ wv,
    const float* __restrict__ wu, const float* __restrict__ A, const float* __restrict__ dM,
    const uint32_t* __restrict__ bits, const float* __restrict__ dz, float p_feat, float scale_f,
    float* __restrict__ dH) {
  extern __shared__ float4 smem4[];
  constexpr int BN = 64;
  const int K = 2 * G * D, kc = RESIDENT ? K : KC, ld = kc + 4;
  float* Ws = reinterpret_cast<float*>(smem4);  // [BN][KC + 4]: W^T columns l0 .. l0+BN-1
  float* Zs = Ws + BN * ld;                     // [BM2][KC + 4]: dz of the rows
  float* dMs = Zs + BM2 * ld;                   // [C][BN]
  float* As = dMs + C * BN;                     // [C][BM2]
  int* ok = reinterpret_cast<int*>(As + C * BM2);  // [BM2]
  const int tile = blockIdx.x, n0 = tile * BM2, l0 = blockIdx.y * BN;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;

  // W^T columns k0 .. k0 + kl - 1 of rows l0 .. l0 + BN - 1 into Ws.
  auto stage_w = [&](int k0, int kl) {
    for (int e = tid; e < BN * (kl / 4); e += nthr) {
      const int rr = e / (kl / 4), j = (e - rr * (kl / 4)) * 4, k = k0 + j;
      const int g = k / (2 * D), rem = k - g * 2 * D;
      const size_t src = ((size_t)g * L + l0 + rr) * D + (rem < D ? rem : rem - D);
      cp_async16(Ws + rr * ld + j, (rem < D ? wv : wu) + src);
    }
  };

  bool mine = false;
  for (int t = 0; t < T && tid < BM2; ++t) mine = mine || row_active(A, N, C, t, n0 + tid);
  float dh[4] = {0.f, 0.f, 0.f, 0.f};
  if (__syncthreads_or(mine)) {
    if (RESIDENT) {
      stage_w(0, K);
      cp_async_commit();
    }
    for (int t = 0; t < T; ++t) {
      for (int e = tid; e < C * BM2; e += nthr) {
        const int c = e / BM2, n = n0 + e - c * BM2;
        As[e] = n < N ? A[((size_t)t * C + c) * N + n] : 0.f;
      }
      for (int e = tid; e < C * BN; e += nthr) {
        const int c = e / BN;
        dMs[e] = dM[((size_t)t * C + c) * L + l0 + e - c * BN];
      }
      __syncthreads();
      bool active = false;
      for (int c = 0; c < C && tid < BM2; ++c) active = active || As[c * BM2 + tid] != 0.f;
      if (!set_row_flags(ok, BM2, active)) continue;
      // dz W^T for this warp's 8 columns, 3xTF32, even and odd k-steps
      // apart, promoted every 64 of K (mc_tile.cuh).
      float acc[1][2][4], part[1][2][4];
      zero_acc(acc);
      for (int k0 = 0; k0 < K; k0 += kc) {
        const int kl = K - k0 < kc ? K - k0 : kc;
        if (!RESIDENT) stage_w(k0, kl);
        for (int e = tid; e < BM2 * (kl / 4); e += nthr) {
          const int r = e / (kl / 4), j = (e - r * (kl / 4)) * 4;
          if (ok[r])
            cp_async16(Zs + r * ld + j, dz + ((size_t)t * N + n0 + r) * K + k0 + j);
          else
            *reinterpret_cast<float4*>(Zs + r * ld + j) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int k1 = 0; k1 < kl; k1 += 64) {
          zero_acc(part);
#pragma unroll
          for (int kk = k1; kk < k1 + 64; kk += 16) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t ah[4], al[4], bh[2], bl[2];
              load_a<false>(Zs, ld, 0, kk + 8 * h, ah, al);
              load_b<true>(Ws, ld, kk + 8 * h, warp * 8, bh, bl);
              mma_3xtf32(part[0][h], ah, al, bh, bl);
            }
          }
          add_acc(acc, part);
        }
        if (!RESIDENT) __syncthreads();  // the chunk's stages are rewritten next
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gq + (i >> 1) * 8, n = n0 + r;
        if (!ok[r]) continue;
        const int lc = warp * 8 + 2 * q + (i & 1), l = l0 + lc;
        float v = acc[0][0][i] + acc[0][1][i];
        for (int c = 0; c < C; ++c) v = fmaf(As[c * BM2 + r], dMs[c * BN + lc], v);
        if (p_feat > 0.f) {
          const uint32_t w = bits[((size_t)t * N + n) * (L / 32) + l / 32];
          v = (w >> (l & 31)) & 1u ? v * scale_f : 0.f;
        }
        dh[i] += v;
      }
      __syncthreads();  // the staged values are rewritten for the next sample
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + gq + (i >> 1) * 8;
    const int l = l0 + warp * 8 + 2 * q + (i & 1);
    if (n < N) dH[(size_t)n * L + l] = dh[i];
  }
}

// 4. Split-K partials of dW[l, k] = sum_{t,n} Hd[t, n, l] dz[t, n, k] over
// the rows r = t*N + n of slice blockIdx.z; 4 warps of 32 x 32.
__global__ void __launch_bounds__(128) bwd_dw_kernel(
    const float* __restrict__ H, int N, int L, int D, int C, int G, int T,
    const float* __restrict__ A, const float* __restrict__ dz, const uint32_t* __restrict__ bits,
    int rows_per_slice, float p_feat, float scale_f, float* __restrict__ part_w) {
  __shared__ __align__(16) float As[DW_ROWS][DW_LD];  // [k = row][m = l]
  __shared__ __align__(16) float Bs[DW_ROWS][DW_LD];  // [k = row][n = column of dz]
  __shared__ int ok[DW_ROWS];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int l0 = blockIdx.x * DW_TILE, k0 = blockIdx.y * DW_TILE;
  const int K = 2 * G * D;
  const long total = (long)T * N;
  const long r_begin = (long)blockIdx.z * rows_per_slice;
  const long r_end = r_begin + rows_per_slice < total ? r_begin + rows_per_slice : total;
  float acc[2][4][4], part[2][4][4];  // promoted once per step of rows (mc_tile.cuh)
  zero_acc(acc);
  for (long r0 = r_begin; r0 < r_end; r0 += DW_ROWS) {
    const long rr = r0 + tid;
    const bool mine = tid < DW_ROWS && rr < r_end && row_active(A, N, C, (int)(rr / N), (int)(rr % N));
    if (!set_row_flags(ok, DW_ROWS, mine)) continue;
    for (int e = tid; e < DW_ROWS * DW_TILE / 4; e += blockDim.x) {
      const int k = e / (DW_TILE / 4), m = (e - k * (DW_TILE / 4)) * 4;
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f), z = h;
      if (ok[k]) {
        const long r = r0 + k;
        const int t = (int)(r / N), n = (int)(r - (long)t * N);
        h = *reinterpret_cast<const float4*>(H + (size_t)n * L + l0 + m);
        if (p_feat > 0.f) {
          const int l = l0 + m;
          const uint32_t w = bits[((size_t)t * N + n) * (L / 32) + l / 32] >> (l & 31);
          h.x = w & 1u ? h.x * scale_f : 0.f;
          h.y = w & 2u ? h.y * scale_f : 0.f;
          h.z = w & 4u ? h.z * scale_f : 0.f;
          h.w = w & 8u ? h.w * scale_f : 0.f;
        }
        z = *reinterpret_cast<const float4*>(dz + (size_t)r * K + k0 + m);
      }
      *reinterpret_cast<float4*>(&As[k][m]) = h;
      *reinterpret_cast<float4*>(&Bs[k][m]) = z;
    }
    __syncthreads();
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < DW_ROWS; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a<true>(&As[0][0], DW_LD, wm * 32 + mt * 16, kk, ah[mt], al[mt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh[2], bl[2];
        load_b<false>(&Bs[0][0], DW_LD, kk, wn * 32 + nt * 8, bh, bl);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
    add_acc(acc, part);
    __syncthreads();
  }
  const int lane = tid & 31, gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + wm * 32 + mt * 16 + gq + (i >> 1) * 8;
        const int k = k0 + wn * 32 + nt * 8 + 2 * q + (i & 1);
        part_w[((size_t)blockIdx.z * L + l) * K + k] = acc[mt][nt][i];
      }
}

// 5. Every partial summed in a fixed order into the outputs.
__global__ void bwd_reduce_kernel(int L, int D, int C, int G, int ntiles_z, int slices,
                                  const float* __restrict__ part_w,
                                  const float* __restrict__ part_b,
                                  const float* __restrict__ part_wa,
                                  const float* __restrict__ part_ba, float* __restrict__ dwv,
                                  float* __restrict__ dwu, float* __restrict__ dbv,
                                  float* __restrict__ dbu, float* __restrict__ dwa,
                                  float* __restrict__ dba) {
  const int K = 2 * G * D;
  const long nw = (long)L * K;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nw) {
    const int l = (int)(i / K), k = (int)(i % K);
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += part_w[((size_t)q * L + l) * K + k];
    const int g = k / (2 * D), rem = k % (2 * D);
    (rem < D ? dwv : dwu)[((size_t)g * L + l) * D + (rem % D)] = s;
    return;
  }
  i -= nw;
  if (i < K) {
    float s = 0.f;
    for (int b = 0; b < ntiles_z; ++b) s += part_b[(size_t)b * K + i];
    const int g = (int)i / (2 * D), rem = (int)i % (2 * D);
    (rem < D ? dbv : dbu)[g * D + (rem % D)] = s;
    return;
  }
  i -= K;
  if (i < (long)C * D) {
    float s = 0.f;
    for (int b = 0; b < ntiles_z; ++b) s += part_wa[(size_t)b * C * D + i];
    dwa[i] = s;
    return;
  }
  i -= (long)C * D;
  if (i < C) {
    float s = 0.f;
    for (int b = 0; b < ntiles_z; ++b) s += part_ba[(size_t)b * C + i];
    dba[i] = s;
  }
}

// Shared memory of a dz block, or 0 where it does not fit; of a dH block
// (64 columns) at a chunk of KC columns of the depth.
inline size_t dz_smem(int D, int C, int G, int ntiles1) {
  const size_t K = 2 * (size_t)G * D;
  const size_t s = 4 * (DZ_ROWS * (K + 4) + K + (size_t)C * D + (size_t)C * G * D +
                        (size_t)ntiles1 * C + 2 * (size_t)C * DZ_ROWS + 2 * kMaxC + DZ_ROWS);
  return s <= (size_t)kSmemMax ? s : 0;
}

inline size_t dh_smem(int KC, int C) {
  return 4 * ((64 + BM2) * ((size_t)KC + 4) + (size_t)C * 64 + (size_t)C * BM2 + BM2);
}

// The dH block's chunk of the depth: the most whole gates (2 D columns
// each) whose W^T columns and dz rows fit in shared memory, all G where
// they fit; 0 where not even one gate does.
inline int dh_chunk(int D, int C, int G) {
  for (int gc = G; gc >= 1; --gc)
    if (dh_smem(2 * gc * D, C) <= (size_t)kSmemMax) return 2 * gc * D;
  return 0;
}

template <int MT, int RW, int KS>
cudaError_t launch_gate(const RowPlan& plan, cudaStream_t s, const float* H, int N, int L, int D,
                        int C, int G, int T, const float* wv, const float* bv, const float* wu,
                        const float* bu, const float* A, const float* dM, const float* dA,
                        uint32_t seed, float p_feat, float scale_f, const BwdWork& w) {
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(bwd_gate_kernel<MT, RW, KS>, plan.smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(plan.ntiles, G / plan.gpb, T);
  bwd_gate_kernel<MT, RW, KS><<<grid, gate_block_threads(plan, D), plan.smem, s>>>(
      H, N, L, D, C, G, plan.gpb, wv, bv, wu, bu, A, dM, dA, seed, p_feat, scale_f, w.dap,
      w.part_s, w.bits, w.phi, w.gate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch mc_head_backward needs, or -1 for shapes it cannot take.
long mc_head_backward_workspace(int N, int L, int D, int C, int G, int T, int slices) {
  if (!shapes_ok(N, L, D, C, G, T) || slices < 1) return -1;
  const RowPlan plan = plan_rows(N, L, D, G, T);
  if (plan.bm == 0 || dz_smem(D, C, G, plan.ntiles) == 0 || dh_chunk(D, C, G) == 0) return -1;
  return (long)carve(nullptr, N, L, D, C, G, T, plan.ntiles, (N + DZ_ROWS - 1) / DZ_ROWS, slices)
      .total;
}

// Shapes: H (N, L); wv, wu (G, L, D); bv, bu (G, D); wa_full (C, G, D);
// A, dA (T, C, N); dM (T, C, L).  Outputs dH (N, L); dwv, dwu (G, L, D);
// dbv, dbu (G, D); dwa (C, D) (each class against its own gate); dba (C,).
// `work` holds mc_head_backward_workspace(...) floats.  All float32,
// contiguous, on the device of `stream`.  Returns the cudaError_t of the
// launches (0 = success).
int mc_head_backward(const float* H, int N, int L, int D, int C, int G, int T, const float* wv,
                     const float* bv, const float* wu, const float* bu, const float* wa_full,
                     const float* A, const float* dM, const float* dA, unsigned int seed,
                     float p_feat, float scale_f, float p_att, float scale_a, int slices,
                     float* work, float* dH, float* dwv, float* dbv, float* dwu, float* dbu,
                     float* dwa, float* dba, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(N, L, D, C, G, T) || slices < 1) return (int)cudaErrorInvalidValue;
  const RowPlan plan = plan_rows(N, L, D, G, T);
  const size_t smem_z = plan.bm == 0 ? 0 : dz_smem(D, C, G, plan.ntiles);
  const int KC = dh_chunk(D, C, G);
  if (smem_z == 0 || KC == 0) return (int)cudaErrorInvalidValue;
  const size_t smem_h = dh_smem(KC, C);
  const int ntiles_z = (N + DZ_ROWS - 1) / DZ_ROWS, ntiles_h = (N + BM2 - 1) / BM2;
  const BwdWork w = carve(work, N, L, D, C, G, T, plan.ntiles, ntiles_z, slices);
  const int K = 2 * G * D;

#define MCH_LAUNCH_GATE(MT, RW, KS)                                                          \
  launch_gate<MT, RW, KS>(plan, s, H, N, L, D, C, G, T, wv, bv, wu, bu, A, dM, dA, seed, p_feat, \
                          scale_f, w)
  cudaError_t err = MCH_DISPATCH_ROWS(plan, MCH_LAUNCH_GATE);
#undef MCH_LAUNCH_GATE
  if (err != cudaSuccess) return (int)err;

  static size_t allowed_z[kMaxDevices] = {}, allowed_h[kMaxDevices] = {},
                allowed_hc[kMaxDevices] = {};
  err = allow_smem(bwd_dz_kernel, smem_z, allowed_z);
  if (err != cudaSuccess) return (int)err;
  bwd_dz_kernel<<<ntiles_z, 256, smem_z, s>>>(N, D, C, G, T, plan.ntiles, wa_full, A, w.dap,
                                             w.part_s, w.phi, w.gate, seed, p_att, scale_a, w.dz,
                                             w.part_b, w.part_wa, w.part_ba);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 g2(ntiles_h, L / 64);
  if (KC == K) {
    err = allow_smem(bwd_dh_kernel<true>, smem_h, allowed_h);
    if (err != cudaSuccess) return (int)err;
    bwd_dh_kernel<true><<<g2, 256, smem_h, s>>>(N, L, D, C, G, T, KC, wv, wu, A, dM, w.bits,
                                                w.dz, p_feat, scale_f, dH);
  } else {
    err = allow_smem(bwd_dh_kernel<false>, smem_h, allowed_hc);
    if (err != cudaSuccess) return (int)err;
    bwd_dh_kernel<false><<<g2, 256, smem_h, s>>>(N, L, D, C, G, T, KC, wv, wu, A, dM, w.bits,
                                                 w.dz, p_feat, scale_f, dH);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long total = (long)T * N;
  int rows_per_slice = (int)((total + slices - 1) / slices);
  rows_per_slice = (rows_per_slice + DW_ROWS - 1) / DW_ROWS * DW_ROWS;
  dim3 g3(L / DW_TILE, K / DW_TILE, slices);
  bwd_dw_kernel<<<g3, 128, 0, s>>>(H, N, L, D, C, G, T, A, w.dz, w.bits, rows_per_slice, p_feat,
                                   scale_f, w.part_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long outs = (long)L * K + K + (long)C * D + C;
  bwd_reduce_kernel<<<(unsigned)((outs + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0, s>>>(
      L, D, C, G, ntiles_z, slices, w.part_w, w.part_b, w.part_wa, w.part_ba, dwv, dwu, dbv, dbu,
      dwa, dba);
  return (int)cudaGetLastError();
}

}  // extern "C"
