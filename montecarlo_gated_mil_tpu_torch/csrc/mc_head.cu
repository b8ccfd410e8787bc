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
// for separate gates it is zero off the class's own gate, for a shared gate
// it is Wa transposed.
//
// What bounds it: the gate product, 2*N*L*(2*G*D) FLOP per sample, in plain
// FP32 FMA (no TF32: the JAX kernel is exact f32).  At N=3072, L=512,
// D=128, G=2, T=50 that is 80.5 GFLOP against 67 TFLOP/s, 1.2 ms.  Bytes
// are small: H (6.3 MB) is read from L2 by every sample.
//
// Design.  The TPU kernel keeps the whole (N, L) bag in VMEM across a
// sequential T grid.  A block has at most 227 KB of shared memory and blocks
// run in no order, so the work is split into three passes, each keyed by
// (t, tile) alone:
//   1. mc_logits_kernel: one block per (32-row tile of N, t).  A register-
//      tiled SGEMM over L in chunks of 16 computes the V and U columns of all
//      G gates for its rows (each thread owns 8 rows x 4 d of V and the same
//      4 d of U, so the gate product never leaves registers); the feature
//      mask is drawn as the H tile is staged in shared memory.  The per-row
//      logit sums reduce through shared memory in a fixed order.
//   2. mc_softmax_kernel: one block per t; masked max and sum over N by
//      fixed-order tree reductions, A written in (T, C, N) layout.
//   3. mc_pool_kernel: one block per (t, 64 columns of L); regenerates the
//      feature mask from its counter rather than storing Hd.
// No float atomics anywhere, so a seed gives bitwise the same output on
// every call, as the TPU kernel does.  No ceiling is tied to N.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kMaskFill = -1e30f;
constexpr int BM = 32;          // rows of H per logits block
constexpr int BK = 16;          // L chunk staged per step
constexpr int AS = BM + 4;      // padded row stride of the staged H tile
constexpr int POOL_COLS = 64;   // L columns per pool block
constexpr int POOL_SLICES = 4;  // row slices per pool block
constexpr int MAX_C = 8;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void mc_logits_kernel(
    const float* __restrict__ H, int N, int L, int D, int C, int G,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ wu, const float* __restrict__ bu,
    const float* __restrict__ wa_full, const float* __restrict__ ba,
    uint32_t seed, float p_feat, float scale_f, float p_att, float scale_a,
    float* __restrict__ logits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.y;
  const int n0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;           // G * D
  const int cols = 2 * G * D;            // [g][V|U][d]
  const int cgs = G * D / 4;             // column groups (4 d each)
  const int rg = tid / cgs, cg = tid % cgs;
  const int grp = cg / (D / 4), d0 = (cg % (D / 4)) * 4;
  const uint32_t key = seed + (uint32_t)t;
  float* As = smem;                      // [BK][AS]
  float* Bs = smem + BK * AS;            // [BK][cols]

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
        if (p_feat > 0.f) {
          const float keep = dropout_uniform(key, 0u, (uint32_t)(n * L + l)) >= p_feat ? 1.f : 0.f;
          h = h * keep * scale_f;
        }
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

  // Epilogue: gate product and this thread's share of each class logit.
  float* red = smem;  // [BM][C][cgs], reuses the staging buffers
  for (int i = 0; i < 8; ++i) {
    float gate[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = tanhf(acc[i][j] + bv[grp * D + d0 + j]);
      const float u = sigmoidf_(acc[i][4 + j] + bu[grp * D + d0 + j]);
      gate[j] = v * u;
    }
    const int r = rg * 8 + i;
    for (int c = 0; c < C; ++c) {
      const float* w = wa_full + ((size_t)c * G + grp) * D + d0;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s = fmaf(gate[j], w[j], s);
      red[(r * C + c) * cgs + cg] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * C; e += nthr) {
    const int r = e / C, c = e % C, n = n0 + r;
    if (n >= N) continue;
    float s = 0.f;
    for (int q = 0; q < cgs; ++q) s += red[(r * C + c) * cgs + q];
    float logit = s + ba[c];
    if (p_att > 0.f) {
      const float keep = dropout_uniform(key, 1u, (uint32_t)(n * C + c)) >= p_att ? 1.f : 0.f;
      logit = logit * keep * scale_a;
    }
    logits[((size_t)t * C + c) * N + n] = logit;
  }
}

// Fixed-order tree reduction over one block; `buf` holds blockDim.x floats.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* buf) {
  const int tid = threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] = IS_MAX ? fmaxf(buf[tid], buf[tid + s]) : buf[tid] + buf[tid + s];
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

__global__ void mc_softmax_kernel(const float* __restrict__ logits, const float* __restrict__ mask,
                                  int N, int C, float* __restrict__ A) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x;
  for (int c = 0; c < C; ++c) {
    const float* lg = logits + ((size_t)t * C + c) * N;
    float mx = kMaskFill;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      mx = fmaxf(mx, mask[n] > 0.f ? lg[n] : kMaskFill);
    mx = block_reduce<true>(mx, buf);
    if (mx <= kMaskFill) mx = 0.f;
    float sum = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      sum += mask[n] > 0.f ? expf(lg[n] - mx) : 0.f;
    float denom = block_reduce<false>(sum, buf);
    if (!(denom > 0.f)) denom = 1.f;
    float* a = A + ((size_t)t * C + c) * N;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      a[n] = (mask[n] > 0.f ? expf(lg[n] - mx) : 0.f) / denom;
  }
}

__global__ void mc_pool_kernel(const float* __restrict__ H, const float* __restrict__ mask,
                               const float* __restrict__ A, int N, int L, int C,
                               uint32_t seed, float p_feat, float scale_f,
                               float* __restrict__ M) {
  __shared__ float red[POOL_SLICES][MAX_C][POOL_COLS];
  const int t = blockIdx.x;
  const int col = threadIdx.x % POOL_COLS, slice = threadIdx.x / POOL_COLS;
  const int l = blockIdx.y * POOL_COLS + col;
  const uint32_t key = seed + (uint32_t)t;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;
  if (l < L) {
    for (int n = slice; n < N; n += POOL_SLICES) {
      if (!(mask[n] > 0.f)) continue;  // A is exactly 0 there
      float h = H[(size_t)n * L + l];
      if (p_feat > 0.f) {
        const float keep = dropout_uniform(key, 0u, (uint32_t)(n * L + l)) >= p_feat ? 1.f : 0.f;
        h = h * keep * scale_f;
      }
      for (int c = 0; c < C; ++c) acc[c] = fmaf(A[((size_t)t * C + c) * N + n], h, acc[c]);
    }
  }
  for (int c = 0; c < C; ++c) red[slice][c][col] = acc[c];
  __syncthreads();
  if (slice == 0 && l < L) {
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
      for (int q = 0; q < POOL_SLICES; ++q) s += red[q][c][col];
      M[((size_t)t * C + c) * L + l] = s;
    }
  }
}

}  // namespace

extern "C" {

// Shapes: H (N, L); mask (N,) 1.0/0.0; wv, wu (G, L, D); bv, bu (G, D);
// wa_full (C, G, D); ba (C,); logits scratch (T, C, N); A out (T, C, N);
// M out (T, C, L).  All float32, contiguous, on the device of `stream`.
// Returns the cudaError_t of the launches (0 = success).
int mc_head_forward(const float* H, const float* mask, int N, int L, int D, int C, int G, int T,
                    const float* wv, const float* bv, const float* wu, const float* bu,
                    const float* wa_full, const float* ba, unsigned int seed, float p_feat,
                    float scale_f, float p_att, float scale_a, float* logits, float* A, float* M,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || G * D > 1024 || G * D < 32 || (G * D) % 32 != 0 || C > MAX_C || C < 1)
    return (int)cudaErrorInvalidValue;
  const int nthr = G * D;
  const size_t stage = (size_t)BK * AS + (size_t)BK * 2 * G * D;
  const size_t reduce = (size_t)BM * C * (G * D / 4);
  const size_t smem = 4 * (stage > reduce ? stage : reduce);
  cudaError_t err = cudaFuncSetAttribute(mc_logits_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((N + BM - 1) / BM, T);
  mc_logits_kernel<<<grid1, nthr, smem, s>>>(H, N, L, D, C, G, wv, bv, wu, bu, wa_full, ba,
                                             seed, p_feat, scale_f, p_att, scale_a, logits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int sthr = 512;
  mc_softmax_kernel<<<T, sthr, sthr * sizeof(float), s>>>(logits, mask, N, C, A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid3(T, (L + POOL_COLS - 1) / POOL_COLS);
  mc_pool_kernel<<<grid3, POOL_COLS * POOL_SLICES, 0, s>>>(H, mask, A, N, L, C, seed, p_feat,
                                                           scale_f, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
