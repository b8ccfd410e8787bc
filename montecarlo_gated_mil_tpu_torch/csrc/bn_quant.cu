// K7 and K8: the batch-statistics BN epilogues of the int8 embed.
//
// Replace the loops that XLA fused for the JAX package's quantized embed in
// montecarlo_gated_mil_tpu/ops/quantized.py (no Pallas kernel there):
// - K7 `bn_stats`: the per-instance sums of `_bn_affine` (:409), sum and sum
//   of squares over (h, w) of a stored conv output, per (instance, channel);
// - K8 `bn_relu_quant`: `norm_relu_quant` (:497), the residual add, ReLU
//   and requantize or the last block's mean pool (:531-550), and the stem's
//   normalize, ReLU and pool-first max-pool before quantizing (:473-493).
// The masked reduction over instances and the (C,) affines stay in torch:
// a few (N, C) operations.
//
// What bounds them on an H100: bytes.  Each reads its inputs once (1-2 bytes
// an element) and writes 1 byte (K8) or an (N, C) f32 row (K7), at 3.35 TB/s;
// the arithmetic is a few operations an element.
//
// Design: every thread owns 8 consecutive channels of one pixel (one 16-byte
// bf16 load, 8 bytes for f8 and int8), so a warp reads contiguous memory.
// K7 gives one block to an instance; its threads stride over the pixels and
// keep float64 sums, which the block combines in a fixed order: no atomics,
// the same bits every run, and no f32 drift over the stem's 12544 pixels.
// K8 writes each output element from its own inputs; the affine is one
// rounded multiply and one rounded add (`__fmul_rn`, `__fadd_rn`: no fused
// multiply-add), the order of the torch version's operations, so that both
// give the same codes.  Offsets are 64-bit: the stem's input passes 2^31
// elements at bucket 3072.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// 8 consecutive stored values as f32; an int8 conv store is scaled by its tq.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8_e4m3* h = reinterpret_cast<const __nv_fp8_e4m3*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(h[i]);
}
__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* h = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(h[i]);
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, const float* tq, int c, float (&v)[8]) {
  load8(p, v);
  if (tq != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], tq[c + i]);
  }
}

__device__ __forceinline__ int8_t quant(float a) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(a), -127.f), 127.f)));
}

__device__ __forceinline__ void store8(int8_t* p, const float (&a)[8]) {
  uint2 u;
  int8_t* q = reinterpret_cast<int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = quant(a[i]);
  *reinterpret_cast<uint2*>(p) = u;
}

// K7.  One block per instance n; thread (row, cg) sums channels 8 cg .. 8 cg
// + 7 over pixels row, row + rows, ...
template <typename T>
__global__ void __launch_bounds__(256) bn_stats_kernel(const T* __restrict__ t,
                                                       const float* __restrict__ tq, int64_t HW,
                                                       int C, float* __restrict__ s1,
                                                       float* __restrict__ s2) {
  __shared__ double red[2][THREADS * 8];
  const int n = blockIdx.x, G = C / 8;
  const int cg = threadIdx.x % G, row = threadIdx.x / G, rows = THREADS / G;
  double a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.0;
  if (row < rows) {
    const T* base = t + static_cast<int64_t>(n) * HW * C + cg * 8;
    for (int64_t p = row; p < HW; p += rows) {
      float v[8];
      load8(base + p * C, tq, cg * 8, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] += v[i];
        b[i] += static_cast<double>(v[i]) * v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[0][row * C + cg * 8 + i] = a[i];
      red[1][row * C + cg * 8 + i] = b[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    double x = 0.0, y = 0.0;
    for (int r = 0; r < rows; ++r) {
      x += red[0][r * C + c];
      y += red[1][r * C + c];
    }
    s1[static_cast<int64_t>(n) * C + c] = static_cast<float>(x);
    s2[static_cast<int64_t>(n) * C + c] = static_cast<float>(y);
  }
}

// relu(v * A + B [+ residual]) for 8 channels of one pixel.  RES 0: none;
// 1: the int8 identity, x * rs; 2: the downsample, load(x) * rs + rb.
template <typename T, int RES>
__device__ __forceinline__ void block_out(const T* t, const float* tq, const float* A,
                                          const float* B, const void* x, const float* xtq,
                                          const float* rs, const float* rb, int64_t off, int c,
                                          float (&y)[8]) {
  float v[8], r[8];
  load8(t + off, tq, c, v);
  if (RES == 1) load8(static_cast<const int8_t*>(x) + off, nullptr, c, r);
  if (RES == 2) load8(static_cast<const T*>(x) + off, xtq, c, r);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float a = __fadd_rn(__fmul_rn(v[i], A[c + i]), B[c + i]);
    if (RES == 1) a = __fadd_rn(a, __fmul_rn(r[i], rs[c + i]));
    if (RES == 2) a = __fadd_rn(a, __fadd_rn(__fmul_rn(r[i], rs[c + i]), rb[c + i]));
    y[i] = fmaxf(a, 0.f);
  }
}

// K8, int8 out: one thread per 8 channels of one pixel, P = N * HW pixels.
template <typename T, int RES>
__global__ void __launch_bounds__(256) bn_relu_quant_kernel(
    const T* __restrict__ t, const float* __restrict__ tq, const float* __restrict__ A,
    const float* __restrict__ B, const void* __restrict__ x, const float* __restrict__ xtq,
    const float* __restrict__ rs, const float* __restrict__ rb, int8_t* __restrict__ out,
    int64_t P, int C) {
  const int G = C / 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= P * G) return;
  const int c = static_cast<int>(i % G) * 8;
  const int64_t off = (i / G) * C + c;
  float y[8];
  block_out<T, RES>(t, tq, A, B, x, xtq, rs, rb, off, c, y);
  store8(out + off, y);
}

// K8, the last block: the f32 mean over the HW pixels of instance n.
template <typename T, int RES>
__global__ void __launch_bounds__(256) bn_relu_mean_kernel(
    const T* __restrict__ t, const float* __restrict__ tq, const float* __restrict__ A,
    const float* __restrict__ B, const void* __restrict__ x, const float* __restrict__ xtq,
    const float* __restrict__ rs, const float* __restrict__ rb, float* __restrict__ out, int N,
    int64_t HW, int C) {
  const int G = C / 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(N) * G) return;
  const int n = static_cast<int>(i / G), c = static_cast<int>(i % G) * 8;
  double s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0;
  for (int64_t p = 0; p < HW; ++p) {
    float y[8];
    block_out<T, RES>(t, tq, A, B, x, xtq, rs, rb, (n * HW + p) * C + c, c, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += y[k];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[static_cast<int64_t>(n) * C + c + k] = static_cast<float>(s[k] / HW);
}

// K8, the stem: relu(t * A + B), 3x3 stride-2 max-pool padded with -inf, then
// round and clip; the full-resolution activation is never written.
__global__ void __launch_bounds__(256) stem_pool_quant_kernel(
    const __nv_bfloat16* __restrict__ t, const float* __restrict__ A, const float* __restrict__ B,
    int8_t* __restrict__ out, int N, int H, int W, int OH, int OW, int C) {
  const int G = C / 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(N) * OH * OW * G) return;
  const int c = static_cast<int>(i % G) * 8;
  const int64_t pix = i / G;
  const int ox = static_cast<int>(pix % OW), oy = static_cast<int>((pix / OW) % OH);
  const int64_t n = pix / (static_cast<int64_t>(OW) * OH);
  float m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = -__int_as_float(0x7f800000);  // -inf
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= W) continue;
      float v[8];
      load8(t + ((n * H + iy) * W + ix) * C + c, nullptr, c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m[k] = fmaxf(m[k], fmaxf(__fadd_rn(__fmul_rn(v[k], A[c + k]), B[c + k]), 0.f));
    }
  }
  store8(out + pix * C + c, m);
}

unsigned blocks_for(int64_t work) { return static_cast<unsigned>((work + THREADS - 1) / THREADS); }

template <typename T>
cudaError_t stats_launch(const void* t, const float* tq, int N, int64_t HW, int C, float* s1,
                         float* s2, cudaStream_t s) {
  bn_stats_kernel<T><<<N, THREADS, 0, s>>>(static_cast<const T*>(t), tq, HW, C, s1, s2);
  return cudaGetLastError();
}

template <typename T, int RES>
cudaError_t quant_launch(const void* t, const float* tq, const float* A, const float* B,
                         const void* x, const float* xtq, const float* rs, const float* rb,
                         int mean, void* out, int N, int64_t HW, int C, cudaStream_t s) {
  const T* tt = static_cast<const T*>(t);
  if (mean)
    bn_relu_mean_kernel<T, RES><<<blocks_for(static_cast<int64_t>(N) * (C / 8)), THREADS, 0, s>>>(
        tt, tq, A, B, x, xtq, rs, rb, static_cast<float*>(out), N, HW, C);
  else
    bn_relu_quant_kernel<T, RES><<<blocks_for(N * HW * (C / 8)), THREADS, 0, s>>>(
        tt, tq, A, B, x, xtq, rs, rb, static_cast<int8_t*>(out), N * HW, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quant_res(int res, const void* t, const float* tq, const float* A, const float* B,
                      const void* x, const float* xtq, const float* rs, const float* rb, int mean,
                      void* out, int N, int64_t HW, int C, cudaStream_t s) {
  if (res == 0) return quant_launch<T, 0>(t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, s);
  if (res == 1) return quant_launch<T, 1>(t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, s);
  return quant_launch<T, 2>(t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, s);
}

bool channels_ok(int C) { return C > 0 && C % 8 == 0 && C <= 8 * THREADS; }

}  // namespace

extern "C" {

// dtype codes: 0 bf16, 1 float8_e4m3fn, 2 int8 (then tq (C,) scales it).
// t (N, HW, C); s1, s2 (N, C) f32.  Returns the cudaError_t of the launch.
int bn_stats(const void* t, int dtype, const float* tq, int N, long long HW, int C, float* s1,
             float* s2, void* stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  if (!channels_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = stats_launch<__nv_bfloat16>(t, tq, N, HW, C, s1, s2, s);
  else if (dtype == 1)
    err = stats_launch<__nv_fp8_e4m3>(t, tq, N, HW, C, s1, s2, s);
  else
    err = stats_launch<int8_t>(t, tq, N, HW, C, s1, s2, s);
  return static_cast<int>(err);
}

// relu(load(t) * A + B [+ residual]) -> int8 (N, HW, C), or with mean = 1
// its f32 mean over HW, (N, C).  res 0: none; 1: x int8 (N, HW, C) times
// rs; 2: x stored as t, load(x, xtq) * rs + rb.
int bn_relu_quant(const void* t, int dtype, const float* tq, const float* A, const float* B,
                  int res, const void* x, const float* xtq, const float* rs, const float* rb,
                  int mean, void* out, int N, long long HW, int C, void* stream) {
  if (static_cast<int64_t>(N) * HW == 0) return static_cast<int>(cudaSuccess);
  if (!channels_ok(C) || res < 0 || res > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = quant_res<__nv_bfloat16>(res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, s);
  else if (dtype == 1)
    err = quant_res<__nv_fp8_e4m3>(res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, s);
  else
    err = quant_res<int8_t>(res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, s);
  return static_cast<int>(err);
}

// The stem: t (N, H, W, C) bf16 -> out (N, OH, OW, C) int8.
int stem_pool_quant(const void* t, const float* A, const float* B, int8_t* out, int N, int H,
                    int W, int OH, int OW, int C, void* stream) {
  const int64_t work = static_cast<int64_t>(N) * OH * OW * (C / 8);
  if (work == 0) return static_cast<int>(cudaSuccess);
  if (!channels_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
  stem_pool_quant_kernel<<<blocks_for(work), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), A, B, out, N, H, W, OH, OW, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
