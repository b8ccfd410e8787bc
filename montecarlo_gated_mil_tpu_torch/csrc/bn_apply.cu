// K9: the float embed's masked BN, normalized in one pass with its epilogue.
//
// Replaces no Pallas kernel.  It replaces the JAX package's BatchNorm of
// the float embed (montecarlo_gated_mil_tpu/models/resnet.py:43,
// `MaskedBatchStatsNorm`, and the ReLU, residual add and stem max-pool
// after it), which XLA fused there; eagerly in PyTorch that chain read and
// wrote every activation about sixteen times a BN.  K7 (bn_quant.cu) takes
// the per-instance sums in one read, the (N, C) moments stay in torch, and
// K9 reads the conv output once more and writes the result once.
//
// What bounds it on an H100: bytes, a few operations an element against 4
// (f32) or 2 (bf16) bytes read and written, at 3.35 TB/s.
//
// The arithmetic is the plain chain's, in its order, one rounding per
// operation (`__fmul_rn`, `__fsub_rn`, `__fadd_rn`: no fused multiply-add):
// y = ((x * scale - mean) * inv) * w + b in the statistics' type (f32 for
// f32 and bf16, f64 for f64), rounded once to the stored type; so given the
// same moments every output equals the chain's bit for bit.  The epilogues
// follow the chain's ops on the stored type: ReLU (NaN kept, as PyTorch's
// clamp_min keeps it); a block end's residual add and ReLU, the residual
// either the identity or the downsample conv's raw output under its own
// BN's affine, computed as above and rounded before the add.
//
// The elementwise mode is channel-stationary (as K8's): a thread owns the
// channels of one 16-byte load, keeps their moments and affine in
// registers, and walks pixels with a grid-wide stride, UNROLL loads in
// flight; the grid is what stays resident on the card at once.  It may write over its input (serving does): each element is
// read and then written by the same thread, so t and out carry no
// __restrict__.
//
// The stem's mode pools first.  The affine is monotone in x: scale >= 0
// and inv > 0, so it is non-decreasing where w >= 0 and non-increasing
// where w < 0, and every rounding and the ReLU are non-decreasing; so the
// 3x3/2 max (padding 1) over taps of relu(f(x)) is relu(f(max x)), or
// relu(f(min x)), bit for bit (with scale 0 or w 0, f is constant).  A
// thread owns one output column and one 16-byte channel group of one
// instance and walks the output rows; the extreme of input row 2 oy + 1
// over its three columns is carried in registers to output row oy + 1, so
// each input row is read once, and neighbouring columns share loads in L1.
// Only the pooled tensor, a quarter of the input, is written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // every K9 block
constexpr int UNROLL = 4;     // packets in flight per thread in the elementwise mode

// The statistics' type of a stored type.
template <typename T>
using Stat = std::conditional_t<std::is_same_v<T, double>, double, float>;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T>
__device__ __forceinline__ T narrow(Stat<T> v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// PyTorch's relu (clamp_min(0)): NaN passes, else the larger of v and 0.
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }
__device__ __forceinline__ double relu(double v) { return isnan(v) ? v : fmax(v, 0.0); }

// VEC = 16 / sizeof(T) stored values, one 16-byte load or store.
template <typename T>
struct Packet {
  static constexpr int VEC = 16 / sizeof(T);
  uint4 w;
  __device__ __forceinline__ void load(const T* p) { w = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<uint4*>(p) = w; }
  __device__ __forceinline__ T get(int i) const { return reinterpret_cast<const T*>(&w)[i]; }
  __device__ __forceinline__ void set(int i, T v) { reinterpret_cast<T*>(&w)[i] = v; }
};

// One BN's moments and affine for a thread's VEC channels, in registers.
template <typename T>
struct Norm {
  using S = Stat<T>;
  static constexpr int VEC = Packet<T>::VEC;
  S mean[VEC], inv[VEC], w[VEC], b[VEC];

  __device__ __forceinline__ void load(int c, const S* mean_, const S* inv_, const S* w_,
                                       const S* b_) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = mean_[c + i];
      inv[i] = inv_[c + i];
      w[i] = w_[c + i];
      b[i] = b_[c + i];
    }
  }

  // The chain's ((v [* scale] - mean) * inv) * w + b, rounded to T.
  __device__ __forceinline__ T apply(int i, S v, bool scaled, S scale) const {
    if (scaled) v = mul(v, scale);
    return narrow<T>(add(mul(mul(sub(v, mean[i]), inv[i]), w[i]), b[i]));
  }
};

// Epilogues: 0 none, 1 ReLU, 2 + the identity residual then ReLU, 3 + the
// downsample's raw output under its own BN then ReLU.
template <typename T, int EPI>
__device__ __forceinline__ void finish(const Norm<T>& nm, const Norm<T>& rn, bool scaled,
                                       Stat<T> scale, const Packet<T>& t, const Packet<T>& x,
                                       Packet<T>& y) {
  using S = Stat<T>;
#pragma unroll
  for (int i = 0; i < Packet<T>::VEC; ++i) {
    const T v = nm.apply(i, widen(t.get(i)), scaled, scale);
    S s = widen(v);
    if constexpr (EPI == 2) s = widen(narrow<T>(add(s, widen(x.get(i)))));
    if constexpr (EPI == 3) {
      const T r = rn.apply(i, widen(x.get(i)), scaled, scale);
      s = widen(narrow<T>(add(s, widen(r))));
    }
    y.set(i, EPI == 0 ? v : narrow<T>(relu(s)));
  }
}

// K9 elementwise, P = N * HW pixels of C channels.  Thread (r, lane) owns
// channel groups lane, lane + tpr, ... (one for C up to VEC * THREADS) and
// pixels blockIdx.x * rows + r + k * step.
template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS) bn_apply_kernel(
    const T* t, T* out, const Stat<T>* __restrict__ scale, const Stat<T>* __restrict__ mean,
    const Stat<T>* __restrict__ inv, const Stat<T>* __restrict__ w, const Stat<T>* __restrict__ b,
    const T* __restrict__ x, const Stat<T>* __restrict__ rmean, const Stat<T>* __restrict__ rinv,
    const Stat<T>* __restrict__ rw, const Stat<T>* __restrict__ rb, int64_t P, int C) {
  using S = Stat<T>;
  constexpr int VEC = Packet<T>::VEC;
  const int G = C / VEC, tpr = min(G, THREADS), rows = THREADS / tpr;
  const int lane = threadIdx.x % tpr, r = threadIdx.x / tpr;
  if (r >= rows) return;
  const bool scaled = scale != nullptr;
  const S sc = scaled ? *scale : S(1);
  const int64_t step = static_cast<int64_t>(gridDim.x) * rows;
  for (int g = lane; g < G; g += tpr) {
    const int c = g * VEC;
    Norm<T> nm, rn;
    nm.load(c, mean, inv, w, b);
    if constexpr (EPI == 3) rn.load(c, rmean, rinv, rw, rb);
    int64_t p = static_cast<int64_t>(blockIdx.x) * rows + r;
    for (; p + (UNROLL - 1) * step < P; p += UNROLL * step) {
      Packet<T> pt[UNROLL], px[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t off = (p + u * step) * C + c;
        pt[u].load(t + off);
        if constexpr (EPI >= 2) px[u].load(x + off);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        Packet<T> y;
        finish<T, EPI>(nm, rn, scaled, sc, pt[u], px[u], y);
        y.store(out + (p + u * step) * C + c);
      }
    }
    for (; p < P; p += step) {
      const int64_t off = p * C + c;
      Packet<T> pt, px, y;
      pt.load(t + off);
      if constexpr (EPI >= 2) px.load(x + off);
      finish<T, EPI>(nm, rn, scaled, sc, pt, px, y);
      y.store(out + off);
    }
  }
}

// The extreme that the stem pools: max where the channel's w >= 0, min
// where w < 0, NaN kept (as max_pool2d keeps it).
template <typename S>
__device__ __forceinline__ S pick(S m, S v, bool lo) {
  return (lo ? v < m : v > m) || isnan(v) ? v : m;
}

// The extreme of input row `row` over columns x0 .. x1 of a thread's VEC channels.
template <typename T>
__device__ __forceinline__ void row_extreme(const T* row, int x0, int x1, int C,
                                            const bool (&lo)[Packet<T>::VEC],
                                            Stat<T> (&m)[Packet<T>::VEC]) {
  constexpr int VEC = Packet<T>::VEC;
  Packet<T> v[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (x0 + d <= x1) v[d].load(row + static_cast<int64_t>(x0 + d) * C);
#pragma unroll
  for (int i = 0; i < VEC; ++i) m[i] = widen(v[0].get(i));
#pragma unroll
  for (int d = 1; d < 3; ++d)
    if (x0 + d <= x1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = pick(m[i], widen(v[d].get(i)), lo[i]);
    }
}

// K9, the stem: t (N, H, W, C) -> out (N, OH, OW, C), the 3x3/2 max-pool
// (padding 1) of relu(BN(t)).  Block b owns output columns [c0, c0 + cols)
// of instance b / chunks; thread (col, lane) one column and VEC channels.
template <typename T>
__global__ void __launch_bounds__(THREADS) bn_apply_pool_kernel(
    const T* __restrict__ t, T* __restrict__ out, const Stat<T>* __restrict__ scale,
    const Stat<T>* __restrict__ mean, const Stat<T>* __restrict__ inv,
    const Stat<T>* __restrict__ w, const Stat<T>* __restrict__ b, int H, int W, int OH, int OW,
    int C) {
  using S = Stat<T>;
  constexpr int VEC = Packet<T>::VEC;
  const int G = C / VEC, cols = THREADS / G, chunks = (OW + cols - 1) / cols;
  const int n = blockIdx.x / chunks, chunk = blockIdx.x - n * chunks;
  const int lane = threadIdx.x % G, ox = chunk * cols + threadIdx.x / G;
  if (threadIdx.x / G >= cols || ox >= OW) return;
  const int c = lane * VEC;
  const bool scaled = scale != nullptr;
  const S sc = scaled ? *scale : S(1);
  Norm<T> nm;
  nm.load(c, mean, inv, w, b);
  bool lo[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) lo[i] = nm.w[i] < S(0);
  const int64_t row_elems = static_cast<int64_t>(W) * C;
  const T* src = t + static_cast<int64_t>(n) * H * row_elems + c;
  T* dst = out + static_cast<int64_t>(n) * OH * OW * C + static_cast<int64_t>(ox) * C + c;
  const int x0 = max(2 * ox - 1, 0), x1 = min(2 * ox + 1, W - 1);
  S carry[VEC];  // the extreme of input row 2 oy - 1, from the row before
  for (int oy = 0; oy < OH; ++oy) {
    S m[VEC], e[VEC];
    row_extreme<T>(src + 2 * oy * row_elems, x0, x1, C, lo, m);
    if (oy > 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = pick(m[i], carry[i], lo[i]);
    }
    if (2 * oy + 1 < H) {
      row_extreme<T>(src + (2 * oy + 1) * row_elems, x0, x1, C, lo, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        carry[i] = e[i];
        m[i] = pick(m[i], e[i], lo[i]);
      }
    }
    Packet<T> y;
#pragma unroll
    for (int i = 0; i < VEC; ++i) y.set(i, narrow<T>(relu(widen(nm.apply(i, m[i], scaled, sc)))));
    y.store(dst + static_cast<int64_t>(oy) * OW * C);
  }
}

// The elementwise grid: as many blocks as stay resident on the card at once
// (the register count differs by type and epilogue), each striding over
// the pixels, or fewer where the pixels run out.
template <typename T, int EPI>
cudaError_t apply_launch(const void* t, void* out, const void* scale, const void* const* nm,
                         const void* x, const void* const* rn, int64_t P, int C,
                         cudaStream_t s) {
  using S = Stat<T>;
  auto v = [](const void* p) { return static_cast<const S*>(p); };
  const int rows = THREADS / std::min(C / Packet<T>::VEC, THREADS);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_apply_kernel<T, EPI>,
                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      std::min<int64_t>((P + rows - 1) / rows, static_cast<int64_t>(sms) * std::max(per_sm, 1));
  bn_apply_kernel<T, EPI><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(t), static_cast<T*>(out), v(scale), v(nm[0]), v(nm[1]), v(nm[2]),
      v(nm[3]), static_cast<const T*>(x), v(rn[0]), v(rn[1]), v(rn[2]), v(rn[3]), P, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_epi(int epi, const void* t, void* out, const void* scale,
                      const void* const* nm, const void* x, const void* const* rn, int64_t P,
                      int C, cudaStream_t s) {
  switch (epi) {
    case 0: return apply_launch<T, 0>(t, out, scale, nm, x, rn, P, C, s);
    case 1: return apply_launch<T, 1>(t, out, scale, nm, x, rn, P, C, s);
    case 2: return apply_launch<T, 2>(t, out, scale, nm, x, rn, P, C, s);
    default: return apply_launch<T, 3>(t, out, scale, nm, x, rn, P, C, s);
  }
}

template <typename T>
cudaError_t pool_launch(const void* t, void* out, const void* scale, const void* const* nm,
                        int N, int H, int W, int OH, int OW, int C, cudaStream_t s) {
  using S = Stat<T>;
  auto v = [](const void* p) { return static_cast<const S*>(p); };
  const int cols = THREADS / (C / Packet<T>::VEC);
  const int64_t blocks = static_cast<int64_t>(N) * ((OW + cols - 1) / cols);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  bn_apply_pool_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(t), static_cast<T*>(out), v(scale), v(nm[0]), v(nm[1]), v(nm[2]),
      v(nm[3]), H, W, OH, OW, C);
  return cudaGetLastError();
}

int vec_of(int dtype) { return dtype == 1 ? 8 : dtype == 2 ? 2 : 4; }

}  // namespace

extern "C" {

// dtype codes: 0 f32, 1 bf16, 2 f64 (the statistics f32, f32, f64).
// t, out (N, HW, C), out may be t; scale a scalar or null (no mask); nm the
// BN's (mean, inv, w, b), each (C,) in the statistics' type.  epi 0 none,
// 1 ReLU, 2 + x (N, HW, C) then ReLU, 3 + BN(x) under rn's (mean, inv, w,
// b) then ReLU.  Returns the launch's cudaError_t.
int bn_apply(const void* t, void* out, int dtype, const void* scale, const void* const* nm,
             int epi, const void* x, const void* const* rn, long long P, int C, void* stream) {
  static const void* const none[4] = {nullptr, nullptr, nullptr, nullptr};
  if (P == 0) return static_cast<int>(cudaSuccess);
  if (dtype < 0 || dtype > 2 || C <= 0 || C % vec_of(dtype) != 0 || epi < 0 || epi > 3 ||
      nm == nullptr || (epi >= 2 && x == nullptr) || (epi == 3 && rn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rn == nullptr) rn = none;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = apply_epi<float>(epi, t, out, scale, nm, x, rn, P, C, s);
  else if (dtype == 1)
    err = apply_epi<__nv_bfloat16>(epi, t, out, scale, nm, x, rn, P, C, s);
  else
    err = apply_epi<double>(epi, t, out, scale, nm, x, rn, P, C, s);
  return static_cast<int>(err);
}

// The stem: t (N, H, W, C) -> out (N, OH, OW, C), relu(BN(t)) max-pooled
// 3x3/2 with padding 1; C / VEC channel groups at most THREADS.
int bn_apply_pool(const void* t, void* out, int dtype, const void* scale, const void* const* nm,
                  int N, int H, int W, int OH, int OW, int C, void* stream) {
  if (static_cast<int64_t>(N) * OH * OW == 0) return static_cast<int>(cudaSuccess);
  if (dtype < 0 || dtype > 2 || C <= 0 || C % vec_of(dtype) != 0 || nm == nullptr ||
      C / vec_of(dtype) > THREADS || OH != (H - 1) / 2 + 1 || OW != (W - 1) / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = pool_launch<float>(t, out, scale, nm, N, H, W, OH, OW, C, s);
  else if (dtype == 1)
    err = pool_launch<__nv_bfloat16>(t, out, scale, nm, N, H, W, OH, OW, C, s);
  else
    err = pool_launch<double>(t, out, scale, nm, N, H, W, OH, OW, C, s);
  return static_cast<int>(err);
}

}  // extern "C"
