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
// L2 by every block.  On the H100 the product runs at about a fifth of the
// tensor-core peak: mma.sync with the split done in registers, eight warps
// per SM, is bound by the latency of each 16-row weight stage (PERF.md).
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
//   2. mc_fwd_finalize_kernel, one block per (128 outputs, c, t): the global
//      max m and sum s = sum_j s_j exp(m_j - m), each folded over the tiles
//      by one warp in a fixed order, then A = exp(logit - m) / s and
//      M = sum_j exp(m_j - m) P_j / s.
// Rows are split across blocks in every pass; no ceiling is tied to N.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_tile.cuh"

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

}  // namespace

extern "C" {

// Floats of scratch mc_head_forward needs, or -1 for shapes it cannot take.
long mc_head_forward_workspace(int N, int L, int D, int C, int G, int T) {
  if (!shapes_ok(N, L, D, C, G, T)) return -1;
  const RowPlan plan = plan_rows(N, L, D, G, T);
  if (plan.bm == 0) return -1;
  return (long)T * C * N + (long)T * plan.ntiles * C * (2 + (long)L);
}

// Shapes: H (N, L); mask (N,) 1.0/0.0; wv, wu (G, L, D); bv, bu (G, D);
// wa_full (C, G, D); ba (C,); work: mc_head_forward_workspace(...) floats;
// A out (T, C, N); M out (T, C, L).  All float32, contiguous, on the device
// of `stream`.  Returns the cudaError_t of the launches (0 = success).
int mc_head_forward(const float* H, const float* mask, int N, int L, int D, int C, int G, int T,
                    const float* wv, const float* bv, const float* wu, const float* bu,
                    const float* wa_full, const float* ba, unsigned int seed, float p_feat,
                    float scale_f, float p_att, float scale_a, float* work, float* A, float* M,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(N, L, D, C, G, T)) return (int)cudaErrorInvalidValue;
  const RowPlan plan = plan_rows(N, L, D, G, T);
  if (plan.bm == 0) return (int)cudaErrorInvalidValue;
  const FwdWork w = carve(work, N, L, C, T, plan.ntiles);
#define MCH_LAUNCH_TILE(MT, RW, KS)                                                       \
  launch_tile<MT, RW, KS>(plan, D, s, H, mask, N, L, C, G, T, wv, bv, wu, bu, wa_full, ba, seed, \
                          p_feat, scale_f, p_att, scale_a, w)
  const cudaError_t err = MCH_DISPATCH_ROWS(plan, MCH_LAUNCH_TILE);
#undef MCH_LAUNCH_TILE
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + L + FIN_THREADS - 1) / FIN_THREADS, C, T);
  mc_fwd_finalize_kernel<<<grid, FIN_THREADS, plan.ntiles * sizeof(float), s>>>(
      mask, N, L, C, plan.ntiles, w.logits, w.part_ms, w.part_p, A, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
