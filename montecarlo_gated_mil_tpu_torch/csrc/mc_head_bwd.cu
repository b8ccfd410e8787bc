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
// recompute, dH, dW) in plain FP32 FMA (no TF32: the JAX kernel is exact
// f32).  At training's N=1024, L=512, D=128, G=2, T=1 that is 1.6 GFLOP,
// 24 us at 67 TFLOP/s; the bytes (H read twice, dH, the weights) are ~6 MB.
//
// Design.  The TPU kernel keeps H in VMEM and walks T in order, adding each
// sample's gradients into its outputs.  On the card blocks run in no order
// and training calls it with T = 1, so the work is split into passes keyed by
// (t, tile), every sum taken in a fixed order (no float atomics: one seed
// gives the same bits on every call, as the forward does):
//   1. rowdot:   per (8 rows, t): dA' = dA + Hd dM^T, one warp per row;
//   2. softbwd:  per t: s = sum_n A dA' by a fixed-order tree, dlgt written
//                over dA', per-sample dba partial;
//   3. gate:     per (32 rows, t): the forward's register-tiled SGEMM
//                recomputes V and U; the epilogue forms dz (T, N, 2GD) and
//                per-block partials of dbv, dbu and dwa;
//   4. dh:       per (64 rows, 64 columns of L): dz W^T as an SGEMM per t,
//                plus A^T dM, times the regenerated feature mask, summed
//                over t in order inside the block;
//   5. dw:       per (64 of L, 64 of 2GD, slice of the T*N rows): split-K
//                partials of Hd^T dz;
//   6. reduce:   every partial summed in a fixed order into the outputs.
// Both dropout masks are regenerated from the forward's Philox keying
// (seed + t, draw 0 at n*L + l, draw 1 at n*C + c), never stored.  A is the
// forward's saved output.  Padded rows have A = 0, hence dlgt = dz = 0 and
// dH = 0 exactly.  No ceiling is tied to N.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int BM = 32;      // rows per gate block (as the forward)
constexpr int BK = 16;      // reduction chunk staged per step
constexpr int AS = BM + 4;  // padded row stride of the staged H tile
constexpr int TILE = 64;    // output tile edge of the dh and dw SGEMMs
constexpr int ROWS_B1 = 8;  // rows (warps) per rowdot block
constexpr int MAX_C = 8;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float feature_keep(uint32_t key, int n, int L, int l, float p_feat,
                                              float scale_f) {
  return dropout_uniform(key, 0u, (uint32_t)(n * L + l)) >= p_feat ? scale_f : 0.f;
}

// Fixed-order tree reduction over one block; `buf` holds blockDim.x floats.
__device__ float block_sum(float v, float* buf) {
  const int tid = threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] += buf[tid + s];
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

// 1. dlg[t, c, n] = dA[t, c, n] + sum_l Hd[n, l] dM[t, c, l].
__global__ void bwd_rowdot_kernel(const float* __restrict__ H, int N, int L, int C,
                                  const float* __restrict__ dM, const float* __restrict__ dA,
                                  uint32_t seed, float p_feat, float scale_f,
                                  float* __restrict__ dlg) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * ROWS_B1 + threadIdx.x / 32;
  if (n >= N) return;
  const uint32_t key = seed + (uint32_t)t;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;
  for (int l = lane; l < L; l += 32) {
    float h = H[(size_t)n * L + l];
    if (p_feat > 0.f) h *= feature_keep(key, n, L, l, p_feat, scale_f);
    for (int c = 0; c < C; ++c) acc[c] = fmaf(h, dM[((size_t)t * C + c) * L + l], acc[c]);
  }
  for (int c = 0; c < C; ++c) {
    float v = acc[c];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) {
      const size_t i = ((size_t)t * C + c) * N + n;
      dlg[i] = dA[i] + v;
    }
  }
}

// 2. Masked-softmax backward per sample, in place over dlg; dba partials.
__global__ void bwd_softmax_kernel(const float* __restrict__ A, int N, int C, uint32_t seed,
                                   float p_att, float scale_a, float* __restrict__ dlg,
                                   float* __restrict__ part_ba) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x;
  const uint32_t key = seed + (uint32_t)t;
  for (int c = 0; c < C; ++c) {
    const float* a = A + ((size_t)t * C + c) * N;
    float* g = dlg + ((size_t)t * C + c) * N;
    float s = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) s = fmaf(a[n], g[n], s);
    s = block_sum(s, buf);
    float db = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float d = a[n] * (g[n] - s);
      if (p_att > 0.f)
        d *= dropout_uniform(key, 1u, (uint32_t)(n * C + c)) >= p_att ? scale_a : 0.f;
      g[n] = d;
      db += d;
    }
    db = block_sum(db, buf);
    if (threadIdx.x == 0) part_ba[t * C + c] = db;
  }
}

// 3. Gate recompute and gate gradients.  Block = (32-row tile, t), G*D
// threads; thread (rg, cg) owns rows rg*8..rg*8+7 and the 4 columns d0..d0+3
// of gate grp, for V and U, exactly as the forward's logits kernel.
__global__ void bwd_gate_kernel(const float* __restrict__ H, int N, int L, int D, int C, int G,
                                const float* __restrict__ wv, const float* __restrict__ bv,
                                const float* __restrict__ wu, const float* __restrict__ bu,
                                const float* __restrict__ wa_full, const float* __restrict__ dlg,
                                uint32_t seed, float p_feat, float scale_f,
                                float* __restrict__ dz, float* __restrict__ part_b,
                                float* __restrict__ part_wa) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.y;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int n0 = tile * BM;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // G * D
  const int cols = 2 * G * D;   // [g][V|U][d]
  const int cgs = G * D / 4;
  const int rg = tid / cgs, cg = tid % cgs;
  const int grp = cg / (D / 4), d0 = (cg % (D / 4)) * 4;
  const uint32_t key = seed + (uint32_t)t;
  float* As = smem;            // [BK][AS]
  float* Bs = smem + BK * AS;  // [BK][cols]

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int l0 = 0; l0 < L; l0 += BK) {
    for (int e = tid; e < BM * BK; e += nthr) {
      const int r = e / BK, k = e % BK;
      const int n = n0 + r, l = l0 + k;
      float h = 0.f;
      if (n < N && l < L) {
        h = H[(size_t)n * L + l];
        if (p_feat > 0.f) h *= feature_keep(key, n, L, l, p_feat, scale_f);
      }
      As[k * AS + r] = h;
    }
    for (int e = tid; e < BK * cols / 4; e += nthr) {
      const int k = e / (cols / 4), c4 = (e % (cols / 4)) * 4;
      const int g = c4 / (2 * D), rem = c4 % (2 * D);
      const int l = l0 + k;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l < L) {
        const float* src = (rem < D ? wv : wu) + ((size_t)g * L + l) * D + (rem % D);
        w = *reinterpret_cast<const float4*>(src);
      }
      *reinterpret_cast<float4*>(&Bs[k * cols + c4]) = w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k * AS + rg * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k * AS + rg * 8 + 4]);
      const float4 v4 = *reinterpret_cast<const float4*>(&Bs[k * cols + grp * 2 * D + d0]);
      const float4 u4 = *reinterpret_cast<const float4*>(&Bs[k * cols + grp * 2 * D + D + d0]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {v4.x, v4.y, v4.z, v4.w, u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue.  Per thread: 8 bias partials (dzv, dzu for its 4 d) and, for
  // every class whose gate this is, 4 dwa partials, summed over its 8 rows.
  float pb[8], pwa[MAX_C][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) pb[j] = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) pwa[c][j] = 0.f;
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + rg * 8 + i;
    if (n >= N) break;
    float dl[MAX_C];
    for (int c = 0; c < C; ++c) dl[c] = dlg[((size_t)t * C + c) * N + n];
    float* out = dz + ((size_t)t * N + n) * cols + grp * 2 * D + d0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = tanhf(acc[i][j] + bv[grp * D + d0 + j]);
      const float u = sigmoidf_(acc[i][4 + j] + bu[grp * D + d0 + j]);
      float dG = 0.f;
      for (int c = 0; c < C; ++c) dG = fmaf(dl[c], wa_full[((size_t)c * G + grp) * D + d0 + j], dG);
      const float dzv = dG * u * (1.f - v * v);
      const float dzu = dG * v * u * (1.f - u);
      out[j] = dzv;
      out[D + j] = dzu;
      pb[j] += dzv;
      pb[4 + j] += dzu;
      const float gate = v * u;
      for (int c = 0; c < C; ++c)
        if (G == 1 || c == grp) pwa[c][j] = fmaf(dl[c], gate, pwa[c][j]);
    }
  }
  // Sum the 4 row groups in order through shared memory.
  const int per = 8 + 4 * C;
  float* red = smem;  // [rg][cgs][per], reuses the staging buffers
  float* mine = red + ((size_t)rg * cgs + cg) * per;
  for (int j = 0; j < 8; ++j) mine[j] = pb[j];
  for (int c = 0; c < C; ++c)
    for (int j = 0; j < 4; ++j) mine[8 + c * 4 + j] = pwa[c][j];
  __syncthreads();
  if (rg == 0) {
    float tot[8 + 4 * MAX_C];
    for (int q = 0; q < per; ++q) tot[q] = red[(size_t)cg * per + q];
    for (int r = 1; r < nthr / cgs; ++r)
      for (int q = 0; q < per; ++q) tot[q] += red[((size_t)r * cgs + cg) * per + q];
    const size_t blk = (size_t)t * ntiles + tile;
    for (int j = 0; j < 4; ++j) {
      part_b[blk * cols + grp * 2 * D + d0 + j] = tot[j];
      part_b[blk * cols + grp * 2 * D + D + d0 + j] = tot[4 + j];
    }
    for (int c = 0; c < C; ++c)
      if (G == 1 || c == grp)
        for (int j = 0; j < 4; ++j) part_wa[(blk * C + c) * D + d0 + j] = tot[8 + c * 4 + j];
  }
}

// 4. dH: per (64 rows, 64 columns), sum over t of the masked
// keep_f * (dz W^T + A^T dM).  256 threads, 4x4 outputs each.
__global__ void bwd_dh_kernel(const float* __restrict__ H, int N, int L, int D, int C, int G,
                              int T, const float* __restrict__ wv, const float* __restrict__ wu,
                              const float* __restrict__ A, const float* __restrict__ dM,
                              const float* __restrict__ dz, uint32_t seed, float p_feat,
                              float scale_f, float* __restrict__ dH) {
  __shared__ __align__(16) float As[BK][TILE];
  __shared__ __align__(16) float Bs[BK][TILE];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE, l0 = blockIdx.y * TILE;
  const int cols = 2 * G * D;
  float tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.f;

  for (int t = 0; t < T; ++t) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < cols; k0 += BK) {
      for (int e = tid; e < BK * TILE; e += blockDim.x) {
        const int kk = e % BK, r = e / BK;
        const int n = n0 + r;
        As[kk][r] = n < N ? dz[((size_t)t * N + n) * cols + k0 + kk] : 0.f;
        const int k = k0 + kk, l = l0 + r;
        const int g = k / (2 * D), rem = k % (2 * D);
        Bs[kk][r] = l < L ? (rem < D ? wv : wu)[((size_t)g * L + l) * D + (rem % D)] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
    const uint32_t key = seed + (uint32_t)t;
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty * 4 + i;
      if (n >= N) continue;
      for (int j = 0; j < 4; ++j) {
        const int l = l0 + tx * 4 + j;
        if (l >= L) continue;
        float v = acc[i][j];
        for (int c = 0; c < C; ++c)
          v = fmaf(A[((size_t)t * C + c) * N + n], dM[((size_t)t * C + c) * L + l], v);
        if (p_feat > 0.f) v *= feature_keep(key, n, L, l, p_feat, scale_f);
        tot[i][j] += v;
      }
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + tx * 4 + j;
      if (l < L) dH[(size_t)n * L + l] = tot[i][j];
    }
  }
}

// 5. Split-K partials of dW[l, k] = sum_{t,n} Hd[t, n, l] dz[t, n, k] over
// the rows r = t*N + n of slice blockIdx.z.
__global__ void bwd_dw_kernel(const float* __restrict__ H, int N, int L, int D, int G, int T,
                              const float* __restrict__ dz, int rows_per_slice, uint32_t seed,
                              float p_feat, float scale_f, float* __restrict__ part_w) {
  __shared__ __align__(16) float As[BK][TILE];
  __shared__ __align__(16) float Bs[BK][TILE];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int l0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const int cols = 2 * G * D;
  const long total = (long)T * N;
  const long r_begin = (long)blockIdx.z * rows_per_slice;
  const long r_end = r_begin + rows_per_slice < total ? r_begin + rows_per_slice : total;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long r0 = r_begin; r0 < r_end; r0 += BK) {
    for (int e = tid; e < BK * TILE; e += blockDim.x) {
      const int i = e % TILE, kk = e / TILE;
      const long r = r0 + kk;
      float h = 0.f, z = 0.f;
      if (r < r_end) {
        const int t = (int)(r / N), n = (int)(r % N);
        const int l = l0 + i;
        if (l < L) {
          h = H[(size_t)n * L + l];
          if (p_feat > 0.f) h *= feature_keep(seed + (uint32_t)t, n, L, l, p_feat, scale_f);
        }
        z = dz[(size_t)r * cols + k0 + i];
      }
      As[kk][i] = h;
      Bs[kk][i] = z;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= L) continue;
    for (int j = 0; j < 4; ++j)
      part_w[((size_t)blockIdx.z * L + l) * cols + k0 + tx * 4 + j] = acc[i][j];
  }
}

// 6. Every partial summed in a fixed order into the outputs.
__global__ void bwd_reduce_kernel(int L, int D, int C, int G, int T, int ntiles, int slices,
                                  const float* __restrict__ part_w,
                                  const float* __restrict__ part_b,
                                  const float* __restrict__ part_wa,
                                  const float* __restrict__ part_ba, float* __restrict__ dwv,
                                  float* __restrict__ dwu, float* __restrict__ dbv,
                                  float* __restrict__ dbu, float* __restrict__ dwa,
                                  float* __restrict__ dba) {
  const int cols = 2 * G * D;
  const long nw = (long)L * cols;
  const long nblk = (long)T * ntiles;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nw) {
    const int l = (int)(i / cols), k = (int)(i % cols);
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += part_w[((size_t)q * L + l) * cols + k];
    const int g = k / (2 * D), rem = k % (2 * D);
    (rem < D ? dwv : dwu)[((size_t)g * L + l) * D + (rem % D)] = s;
    return;
  }
  i -= nw;
  if (i < cols) {
    float s = 0.f;
    for (long b = 0; b < nblk; ++b) s += part_b[b * cols + i];
    const int g = (int)i / (2 * D), rem = (int)i % (2 * D);
    (rem < D ? dbv : dbu)[g * D + (rem % D)] = s;
    return;
  }
  i -= cols;
  if (i < (long)C * D) {
    const int c = (int)i / D, d = (int)i % D;
    float s = 0.f;
    for (long b = 0; b < nblk; ++b) s += part_wa[(b * C + c) * D + d];
    dwa[c * D + d] = s;
    return;
  }
  i -= (long)C * D;
  if (i < C) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += part_ba[t * C + i];
    dba[i] = s;
  }
}

}  // namespace

extern "C" {

// Scratch sizes, in floats, for mc_head_backward's `work` buffer.
long mc_head_backward_workspace(int N, int L, int D, int C, int G, int T, int slices) {
  const long cols = 2L * G * D;
  const long ntiles = (N + BM - 1) / BM;
  return (long)T * C * N          // dlg
         + (long)T * N * cols     // dz
         + (long)T * ntiles * cols    // part_b
         + (long)T * ntiles * C * D   // part_wa
         + (long)T * C                // part_ba
         + (long)slices * L * cols;   // part_w
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
  if (D % 4 != 0 || G * D > 1024 || G * D < 32 || (G * D) % 32 != 0 || C > MAX_C || C < 1 ||
      slices < 1 || T < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int cols = 2 * G * D;
  const int ntiles = (N + BM - 1) / BM;
  float* dlg = work;
  float* dz = dlg + (size_t)T * C * N;
  float* part_b = dz + (size_t)T * N * cols;
  float* part_wa = part_b + (size_t)T * ntiles * cols;
  float* part_ba = part_wa + (size_t)T * ntiles * C * D;
  float* part_w = part_ba + (size_t)T * C;

  dim3 g1((N + ROWS_B1 - 1) / ROWS_B1, T);
  bwd_rowdot_kernel<<<g1, 32 * ROWS_B1, 0, s>>>(H, N, L, C, dM, dA, seed, p_feat, scale_f, dlg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int sthr = 512;
  bwd_softmax_kernel<<<T, sthr, sthr * sizeof(float), s>>>(A, N, C, seed, p_att, scale_a, dlg,
                                                           part_ba);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nthr = G * D;
  const size_t stage = (size_t)BK * AS + (size_t)BK * cols;
  const size_t reduce = (size_t)4 * (G * D / 4) * (8 + 4 * C);
  const size_t smem = 4 * (stage > reduce ? stage : reduce);
  err = cudaFuncSetAttribute(bwd_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g3(ntiles, T);
  bwd_gate_kernel<<<g3, nthr, smem, s>>>(H, N, L, D, C, G, wv, bv, wu, bu, wa_full, dlg, seed,
                                         p_feat, scale_f, dz, part_b, part_wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 g4((N + TILE - 1) / TILE, (L + TILE - 1) / TILE);
  bwd_dh_kernel<<<g4, 256, 0, s>>>(H, N, L, D, C, G, T, wv, wu, A, dM, dz, seed, p_feat, scale_f,
                                   dH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long total = (long)T * N;
  int rows_per_slice = (int)((total + slices - 1) / slices);
  rows_per_slice = (rows_per_slice + BK - 1) / BK * BK;
  dim3 g5((L + TILE - 1) / TILE, cols / TILE, slices);
  bwd_dw_kernel<<<g5, 256, 0, s>>>(H, N, L, D, G, T, dz, rows_per_slice, seed, p_feat, scale_f,
                                   part_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long outs = (long)L * cols + cols + (long)C * D + C;
  bwd_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      L, D, C, G, T, ntiles, slices, part_w, part_b, part_wa, part_ba, dwv, dwu, dbv, dbu, dwa,
      dba);
  return (int)cudaGetLastError();
}

}  // extern "C"
