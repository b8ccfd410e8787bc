// K7 and K8: the batch-statistics BN epilogues of the int8 embed.
//
// Replace the loops that XLA fused for the JAX package's quantized embed in
// montecarlo_gated_mil_tpu/ops/quantized.py (no Pallas kernel there):
// - K7 `bn_stats`: the per-instance sums of `_bn_affine` (:409), sum and sum
//   of squares over (h, w) of a stored conv output, per (instance, channel);
//   the float embed's masked BN takes its sums from it too, in f32 and f64
//   (then K9, bn_apply.cu, normalizes);
// - K8 `bn_relu_quant`: `norm_relu_quant` (:497), the residual add, ReLU
//   and requantize or the last block's mean pool (:531-550), and the stem's
//   normalize, ReLU and pool-first max-pool before quantizing (:473-493).
// The masked reduction over instances and the (C,) affines stay in torch:
// a few (N, C) operations.
//
// What bounds them on an H100: bytes.  Each reads its inputs once (1-8 bytes
// an element) and writes 1 byte (K8) or an (N, C) f32 row (K7), at 3.35 TB/s;
// the arithmetic is a few operations an element.
//
// K7 gives one block to an instance; its threads stride over the pixels and
// keep float64 sums, which the block combines in a fixed order: no atomics,
// the same bits every run, and no f32 drift over the stem's 12544 pixels.
// It runs where no kernel held the output before it was stored: after the
// stem's cuDNN conv (one launch a request) and the s2d stem's gather conv.
// After every other conv K6 takes the sums in its epilogue, per 8 x 8 tile
// (qconv.cu, `qconv_i8_stats`), and `bn_stats_fold_kernel` here folds the
// runs of tiles of each instance in tile order, in float64: a thread per
// (instance, channel), whose 16-byte reads of consecutive channels make
// each warp's loads contiguous.  Bound by its bytes, the partials read once.
//
// K8 writes each output element from its own inputs; the affine is one
// rounded multiply and one rounded add (`__fmul_rn`, `__fadd_rn`: no fused
// multiply-add), the order of the torch version's operations, so that both
// give the same codes.  Offsets are 64-bit: the stem's input passes 2^31
// elements at bucket 3072.  Its design, for the memory system:
// - The elementwise modes are channel-stationary.  A thread owns the VEC
//   consecutive channels of one 16-byte load of t (8 bf16; 16 f8 or int8
//   where C % 16 == 0, else 8), keeps their affine, residual scales and
//   int8 read-back scales in registers, and walks the pixels with a
//   grid-wide stride, UNROLL pixels at a time: UNROLL independent loads of
//   t (and of x) in flight, then one VEC-byte int8 store each; a warp's
//   loads and stores cover contiguous memory.  No division inside the loop.
//   The grid is sized by the host (`quant_kernels.bn_relu_quant_geometry`)
//   to three blocks an SM.  (16 bf16 channels a thread, two loads 32 bytes
//   apart and a 16-byte store, measured slower on the H100.)
// - The mean mode (the last block) gives a thread one instance and VEC
//   channels and sums its HW pixels in order in float64, as before (the
//   same bits), with the same registers and UNROLL pixels' loads in flight.
// - The stem pools before the affine.  For a channel with A > 0 every step
//   after the load (the rounded multiply, the rounded add, ReLU, rounding
//   and the clip) is non-decreasing in the stored value, and for A < 0
//   non-increasing, so the 3x3/2 max over taps of f(v) is f(max v), or
//   f(min v), bit for bit (a window with padding 1 always holds a tap; with
//   A = 0 f is constant).  The kernel takes max or min on the raw bf16 pairs
//   (`__hmax2` after flipping the sign of the channels with A < 0), then one
//   affine, ReLU, rounding and clip per output: no activation is computed at
//   a tap.  A block owns a channel slab of one instance and walks its output
//   rows; the input rows stream through a ring of 3 + 2 * lookahead rows in
//   shared memory by TMA bulk copies (one copy per row where the slab is all
//   of C), completed on mbarriers, so each input byte leaves device memory
//   once and the taps read shared memory.  Slab and lookahead come from the
//   host (`quant_kernels.stem_pool_geometry`).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // every K7 and K8 block
constexpr int UNROLL = 4;     // pixels in flight per thread in K8's elementwise and mean modes
constexpr int STEM_MAX_LOOKAHEAD = 3;
constexpr int STEM_BARRIER_BYTES = 128;  // the ring's mbarriers, ahead of its rows
constexpr int MAX_SMEM = 232448;         // shared memory a block may use

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
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const double* p, double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 d = reinterpret_cast<const double2*>(p)[i];
    v[2 * i] = d.x;
    v[2 * i + 1] = d.y;
  }
}
template <typename T, typename V>
__device__ __forceinline__ void load8(const T* p, const float* tq, int c, V (&v)[8]) {
  load8(p, v);
  if constexpr (std::is_same_v<V, float>) {
    if (tq != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], tq[c + i]);
    }
  }
}

// K7's value and sum type: f64 for an f64 input, f32 for the rest.
template <typename T>
using SumT = std::conditional_t<std::is_same_v<T, double>, double, float>;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ int8_t quant(float a) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(a), -127.f), 127.f)));
}

// The raw bytes of VEC stored values of one pixel, one 16- or 8-byte load,
// so that a thread's loads are independent of its arithmetic.
template <typename T, int VEC>
struct Packet {
  static constexpr bool WIDE = VEC * sizeof(T) == 16;
  std::conditional_t<WIDE, uint4, uint2> w;

  __device__ __forceinline__ void load(const T* p) {
    w = __ldg(reinterpret_cast<const decltype(w)*>(p));
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_float(reinterpret_cast<const T*>(&w)[i]);
  }
};

template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&y)[VEC]) {
  alignas(16) int8_t q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) q[i] = quant(y[i]);
  if constexpr (VEC == 16)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(q);
  else
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(q);
}

// The residual's stored type: RES 1 is the int8 identity, RES 2 the
// downsample, stored as t is.
template <typename T, int RES>
using ResT = std::conditional_t<RES == 1, int8_t, T>;

// One thread's channels: their affine, residual scales and int8 read-back
// scales, in registers for the whole launch.  RES 0: none; 1: the int8
// identity, x * rs; 2: the downsample, load(x) * rs + rb.
template <typename T, int RES, int VEC>
struct Channels {
  static constexpr bool TQ = std::is_same_v<T, int8_t>;  // an int8 store carries tq
  float a[VEC], b[VEC], rs[VEC], rb[VEC], tq[VEC], xtq[VEC];

  __device__ __forceinline__ void load(int c, const float* A, const float* B, const float* tq_,
                                       const float* xtq_, const float* rs_, const float* rb_) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a[i] = A[c + i];
      b[i] = B[c + i];
      if constexpr (TQ) tq[i] = tq_[c + i];
      if constexpr (RES >= 1) rs[i] = rs_[c + i];
      if constexpr (RES == 2) rb[i] = rb_[c + i];
      if constexpr (RES == 2 && TQ) xtq[i] = xtq_[c + i];
    }
  }

  // relu(load(t) * A + B [+ residual]), one rounding per operation.
  __device__ __forceinline__ void apply(const Packet<T, VEC>& t,
                                        const Packet<ResT<T, RES>, VEC>& x,
                                        float (&y)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = t[i];
      if constexpr (TQ) v = __fmul_rn(v, tq[i]);
      float s = __fadd_rn(__fmul_rn(v, a[i]), b[i]);
      if constexpr (RES == 1) s = __fadd_rn(s, __fmul_rn(x[i], rs[i]));
      if constexpr (RES == 2) {
        float r = x[i];
        if constexpr (TQ) r = __fmul_rn(r, xtq[i]);
        s = __fadd_rn(s, __fadd_rn(__fmul_rn(r, rs[i]), rb[i]));
      }
      y[i] = fmaxf(s, 0.f);
    }
  }
};

// K7.  One block per instance n; thread (row, cg) sums channels 8 cg .. 8 cg
// + 7 over pixels row, row + rows, ...
template <typename T>
__global__ void __launch_bounds__(256) bn_stats_kernel(const T* __restrict__ t,
                                                       const float* __restrict__ tq, int64_t HW,
                                                       int C, SumT<T>* __restrict__ s1,
                                                       SumT<T>* __restrict__ s2) {
  using V = SumT<T>;
  __shared__ double red[2][THREADS * 8];
  const int n = blockIdx.x, G = C / 8;
  const int cg = threadIdx.x % G, row = threadIdx.x / G, rows = THREADS / G;
  double a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.0;
  if (row < rows) {
    const T* base = t + static_cast<int64_t>(n) * HW * C + cg * 8;
    for (int64_t p = row; p < HW; p += rows) {
      V v[8];
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
    s1[static_cast<int64_t>(n) * C + c] = static_cast<V>(x);
    s2[static_cast<int64_t>(n) * C + c] = static_cast<V>(y);
  }
}

// K7's fold: part (N, tiles, C) pairs (sum, sum of squares), of which the
// slots that end a run (see qconv_i8_stats) hold the run's sums -> s1, s2
// (N, C) f32, run by run in order.
__global__ void __launch_bounds__(THREADS) bn_stats_fold_kernel(const double2* __restrict__ part,
                                                                int N, int tiles, int C, int run,
                                                                float* __restrict__ s1,
                                                                float* __restrict__ s2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(N) * C) return;
  const int64_t n = i / C, c = i - n * C, first = n * tiles;
  const double2* p = part + first * C + c;
  double a = 0.0, b = 0.0;
  // Slots k with (first + k + 1) % run == 0, then the last if it ends no such run.
#pragma unroll 4
  for (int k = static_cast<int>((run - 1 - first % run) % run); k < tiles; k += run) {
    const double2 v = __ldg(p + static_cast<int64_t>(k) * C);
    a += v.x;
    b += v.y;
  }
  if ((first + tiles) % run != 0) {
    const double2 v = __ldg(p + static_cast<int64_t>(tiles - 1) * C);
    a += v.x;
    b += v.y;
  }
  s1[i] = static_cast<float>(a);
  s2[i] = static_cast<float>(b);
}

// K8, int8 out, P = N * HW pixels.  Thread (r, cg) of a block owns channels
// VEC cg .. VEC cg + VEC - 1 and pixels blockIdx.x * rows + r + k * step.
template <typename T, int RES, int VEC>
__global__ void __launch_bounds__(THREADS) bn_relu_quant_kernel(
    const T* __restrict__ t, const float* __restrict__ tq, const float* __restrict__ A,
    const float* __restrict__ B, const void* __restrict__ x, const float* __restrict__ xtq,
    const float* __restrict__ rs, const float* __restrict__ rb, int8_t* __restrict__ out,
    int64_t P, int C) {
  using X = ResT<T, RES>;
  const int G = C / VEC, rows = THREADS / G;
  const int cg = threadIdx.x % G, r = threadIdx.x / G;
  if (r >= rows) return;
  const int c = cg * VEC;
  Channels<T, RES, VEC> ch;
  ch.load(c, A, B, tq, xtq, rs, rb);
  const T* tp = t + c;
  const X* xp = static_cast<const X*>(x) + c;
  int8_t* op = out + c;
  const int64_t step = static_cast<int64_t>(gridDim.x) * rows;
  int64_t p = static_cast<int64_t>(blockIdx.x) * rows + r;
  for (; p + (UNROLL - 1) * step < P; p += UNROLL * step) {
    Packet<T, VEC> pt[UNROLL];
    Packet<X, VEC> px[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t off = (p + u * step) * C;
      pt[u].load(tp + off);
      if constexpr (RES != 0) px[u].load(xp + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float y[VEC];
      ch.apply(pt[u], px[u], y);
      store_codes<VEC>(op + (p + u * step) * C, y);
    }
  }
  for (; p < P; p += step) {
    Packet<T, VEC> pt;
    Packet<X, VEC> px;
    pt.load(tp + p * C);
    if constexpr (RES != 0) px.load(xp + p * C);
    float y[VEC];
    ch.apply(pt, px, y);
    store_codes<VEC>(op + p * C, y);
  }
}

// K8, the last block: the f32 mean over the HW pixels of instance n, one
// thread per (n, VEC channels), summed in pixel order in float64.
template <typename T, int RES, int VEC>
__global__ void __launch_bounds__(THREADS) bn_relu_mean_kernel(
    const T* __restrict__ t, const float* __restrict__ tq, const float* __restrict__ A,
    const float* __restrict__ B, const void* __restrict__ x, const float* __restrict__ xtq,
    const float* __restrict__ rs, const float* __restrict__ rb, float* __restrict__ out, int N,
    int64_t HW, int C) {
  using X = ResT<T, RES>;
  const int G = C / VEC;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(N) * G) return;
  const int n = static_cast<int>(i / G), c = static_cast<int>(i % G) * VEC;
  Channels<T, RES, VEC> ch;
  ch.load(c, A, B, tq, xtq, rs, rb);
  const int64_t base = static_cast<int64_t>(n) * HW * C + c;
  const T* tp = t + base;
  const X* xp = static_cast<const X*>(x) + base;
  double s[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = 0.0;
  for (int64_t p = 0; p < HW; p += UNROLL) {
    Packet<T, VEC> pt[UNROLL];
    Packet<X, VEC> px[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u < HW) {
        pt[u].load(tp + (p + u) * C);
        if constexpr (RES != 0) px[u].load(xp + (p + u) * C);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u < HW) {
        float y[VEC];
        ch.apply(pt[u], px[u], y);
#pragma unroll
        for (int k = 0; k < VEC; ++k) s[k] += y[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    out[static_cast<int64_t>(n) * C + c + k] = static_cast<float>(s[k] / HW);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`.  A wait of more
// than about 10 s traps, so that a pipeline fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000ll) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A TMA bulk copy of `bytes` (a multiple of 16) from device to shared
// memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t hmax2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// K8, the stem: t (N, H, W, C) bf16 -> (N, OH, OW, C) int8, the 3x3/2
// max-pool (padding 1) of relu(t * A + B), rounded and clipped.  Block b
// owns channels [c0, c0 + CB) of instance b / (C / CB) and walks its OH
// output rows.  Input rows 2k and 2k + 1 (pair k) land in ring slots
// (2k) % NS and (2k + 1) % NS, NS = 3 + 2 * look, on barrier k % (look + 1);
// while output row oy reads rows 2oy - 1 .. 2oy + 1, pairs oy + 1 ..
// oy + look are in flight.
__global__ void __launch_bounds__(THREADS) stem_pool_quant_kernel(
    const __nv_bfloat16* __restrict__ t, const float* __restrict__ A, const float* __restrict__ B,
    int8_t* __restrict__ out, int H, int W, int OH, int OW, int C, int CB, int look) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + STEM_BARRIER_BYTES);
  const int slabs = C / CB, NS = 3 + 2 * look, stages = look + 1;
  const int n = blockIdx.x / slabs, c0 = (blockIdx.x - n * slabs) * CB;
  const int64_t row_elems = static_cast<int64_t>(W) * C;
  const __nv_bfloat16* src = t + static_cast<int64_t>(n) * H * row_elems + c0;
  const int slot_elems = W * CB;
  const bool whole = CB == C;  // a row of the slab is one contiguous run
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0 issues pair k: one copy per row, or per pixel of a narrower slab.
  auto issue = [&](int k) {
    const int r0 = 2 * k, nrows = min(2, H - r0);
    uint64_t* bar = &bars[k % stages];
    if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(nrows) * slot_elems * 2);
    __syncwarp();
    const int segs = whole ? nrows : nrows * W;
    for (int s = lane; s < segs; s += 32) {
      const int r = whole ? s : s / W, px = whole ? 0 : s - r * W;
      const int iy = r0 + r;
      bulk_load(ring + (iy % NS) * slot_elems + px * CB, src + iy * row_elems + px * C,
                whole ? slot_elems * 2 : CB * 2, bar);
    }
  };
  if (warp == 0)
    for (int k = 0; k < stages && k < OH; ++k) issue(k);

  // Thread (ox0, g) pools channels c0 + 8 g .. + 7 of columns ox0, ox0 + oxs, ...
  const int GB = CB / 8, oxs = THREADS / GB;
  const int g = threadIdx.x % GB, ox0 = threadIdx.x / GB;
  const bool active = ox0 < oxs;
  const int c = c0 + g * 8;
  float a[8], b[8];
  uint32_t flip[4];  // the sign bit of each bf16 of a pair whose channel has A < 0
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = A[c + i];
    b[i] = B[c + i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    flip[j] = (a[2 * j] < 0.f ? 0x8000u : 0u) | (a[2 * j + 1] < 0.f ? 0x80000000u : 0u);

  for (int oy = 0; oy < OH; ++oy) {
    mbar_wait(&bars[oy % stages], (oy / stages) & 1);
    const int y0 = max(2 * oy - 1, 0), y1 = min(2 * oy + 1, H - 1);
    const __nv_bfloat16* rows[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) rows[d] = ring + ((y0 + d) % NS) * slot_elems + g * 8;
    int8_t* orow = out + (static_cast<int64_t>(n) * OH + oy) * OW * C + c;
    for (int ox = ox0; active && ox < OW; ox += oxs) {
      const int x0 = max(2 * ox - 1, 0), x1 = min(2 * ox + 1, W - 1);
      uint32_t m[4] = {0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u};  // bf16 -inf pairs
      for (int d = 0; d <= y1 - y0; ++d) {
        for (int ix = x0; ix <= x1; ++ix) {
          const uint4 v = *reinterpret_cast<const uint4*>(rows[d] + ix * CB);
          m[0] = hmax2(m[0], v.x ^ flip[0]);
          m[1] = hmax2(m[1], v.y ^ flip[1]);
          m[2] = hmax2(m[2], v.z ^ flip[2]);
          m[3] = hmax2(m[3], v.w ^ flip[3]);
        }
      }
      float y[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u = m[j] ^ flip[j];
        y[2 * j] = __uint_as_float(u << 16);
        y[2 * j + 1] = __uint_as_float(u & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = fmaxf(__fadd_rn(__fmul_rn(y[i], a[i]), b[i]), 0.f);
      store_codes<8>(orow + static_cast<int64_t>(ox) * C, y);
    }
    __syncthreads();  // rows 2oy - 1 and 2oy are free
    if (warp == 0 && oy + stages < OH) issue(oy + stages);
  }
}

template <typename T>
cudaError_t stats_launch(const void* t, const float* tq, int N, int64_t HW, int C, void* s1,
                         void* s2, cudaStream_t s) {
  bn_stats_kernel<T><<<N, THREADS, 0, s>>>(static_cast<const T*>(t), tq, HW, C,
                                           static_cast<SumT<T>*>(s1), static_cast<SumT<T>*>(s2));
  return cudaGetLastError();
}

template <typename T, int RES, int VEC>
cudaError_t quant_launch(const void* t, const float* tq, const float* A, const float* B,
                         const void* x, const float* xtq, const float* rs, const float* rb,
                         int mean, void* out, int N, int64_t HW, int C, int blocks,
                         cudaStream_t s) {
  const T* tt = static_cast<const T*>(t);
  if (mean)
    bn_relu_mean_kernel<T, RES, VEC><<<blocks, THREADS, 0, s>>>(
        tt, tq, A, B, x, xtq, rs, rb, static_cast<float*>(out), N, HW, C);
  else
    bn_relu_quant_kernel<T, RES, VEC><<<blocks, THREADS, 0, s>>>(
        tt, tq, A, B, x, xtq, rs, rb, static_cast<int8_t*>(out), N * HW, C);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t quant_res(int res, const void* t, const float* tq, const float* A, const float* B,
                      const void* x, const float* xtq, const float* rs, const float* rb, int mean,
                      void* out, int N, int64_t HW, int C, int blocks, cudaStream_t s) {
  if (res == 0)
    return quant_launch<T, 0, VEC>(t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, blocks, s);
  if (res == 1)
    return quant_launch<T, 1, VEC>(t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, blocks, s);
  return quant_launch<T, 2, VEC>(t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, blocks, s);
}

// VEC: the channels of one 16-byte load of t, or 8 one-byte values.
template <typename T>
cudaError_t quant_vec(int vec, int res, const void* t, const float* tq, const float* A,
                      const float* B, const void* x, const float* xtq, const float* rs,
                      const float* rb, int mean, void* out, int N, int64_t HW, int C, int blocks,
                      cudaStream_t s) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE)
    return quant_res<T, WIDE>(res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, blocks, s);
  if (vec != 8) return cudaErrorInvalidValue;
  return quant_res<T, 8>(res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, blocks, s);
}

bool channels_ok(int C) { return C > 0 && C % 8 == 0 && C <= 8 * THREADS; }

}  // namespace

extern "C" {

// dtype codes: 0 bf16, 1 float8_e4m3fn, 2 int8 (then tq (C,) scales it),
// 3 f32, 4 f64.  t (N, HW, C); s1, s2 (N, C) f64 for f64, else f32.
// Returns the cudaError_t of the launch.
int bn_stats(const void* t, int dtype, const float* tq, int N, long long HW, int C, void* s1,
             void* s2, void* stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  if (!channels_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = stats_launch<__nv_bfloat16>(t, tq, N, HW, C, s1, s2, s);
  else if (dtype == 1)
    err = stats_launch<__nv_fp8_e4m3>(t, tq, N, HW, C, s1, s2, s);
  else if (dtype == 2)
    err = stats_launch<int8_t>(t, tq, N, HW, C, s1, s2, s);
  else if (dtype == 3)
    err = stats_launch<float>(t, tq, N, HW, C, s1, s2, s);
  else if (dtype == 4)
    err = stats_launch<double>(t, tq, N, HW, C, s1, s2, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// part (N, tiles, C) float64 pairs and the run, as qconv_i8_stats writes
// them; s1, s2 (N, C) f32.  Returns the cudaError_t of the launch.
int bn_stats_fold(const double* part, int N, int tiles, int C, int run, float* s1, float* s2,
                  void* stream) {
  const int64_t n = static_cast<int64_t>(N) * C;
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (tiles < 1 || C < 1 || run < 1 || (n + THREADS - 1) / THREADS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  bn_stats_fold_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const double2*>(part), N, tiles, C, run, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

// relu(load(t) * A + B [+ residual]) -> int8 (N, HW, C), or with mean = 1
// its f32 mean over HW, (N, C).  res 0: none; 1: x int8 (N, HW, C) times
// rs; 2: x stored as t, load(x, xtq) * rs + rb.  vec (the channels of a
// thread: 8 bf16, or 16 or 8 one-byte values, dividing C) and blocks come
// from the host's geometry.
int bn_relu_quant(const void* t, int dtype, const float* tq, const float* A, const float* B,
                  int res, const void* x, const float* xtq, const float* rs, const float* rb,
                  int mean, void* out, int N, long long HW, int C, int vec, int blocks,
                  void* stream) {
  if (static_cast<int64_t>(N) * HW == 0) return static_cast<int>(cudaSuccess);
  if (!channels_ok(C) || res < 0 || res > 2 || (vec != 8 && vec != 16) || C % vec != 0 ||
      blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = quant_vec<__nv_bfloat16>(vec, res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C,
                                   blocks, s);
  else if (dtype == 1)
    err = quant_vec<__nv_fp8_e4m3>(vec, res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C,
                                   blocks, s);
  else
    err = quant_vec<int8_t>(vec, res, t, tq, A, B, x, xtq, rs, rb, mean, out, N, HW, C, blocks,
                            s);
  return static_cast<int>(err);
}

// The stem: t (N, H, W, C) bf16 -> out (N, OH, OW, C) int8.  slab (a
// multiple of 8 dividing C) and lookahead (1 to 3) come from the host's
// geometry; the ring's shared memory follows from them.
int stem_pool_quant(const void* t, const float* A, const float* B, int8_t* out, int N, int H,
                    int W, int OH, int OW, int C, int slab, int lookahead, void* stream) {
  if (static_cast<int64_t>(N) * OH * OW == 0) return static_cast<int>(cudaSuccess);
  const int64_t smem =
      STEM_BARRIER_BYTES + (3 + 2 * static_cast<int64_t>(lookahead)) * W * slab * 2;
  const int64_t blocks = static_cast<int64_t>(N) * (C / (slab > 0 ? slab : 1));
  if (!channels_ok(C) || slab < 8 || slab % 8 != 0 || C % slab != 0 || lookahead < 1 ||
      lookahead > STEM_MAX_LOOKAHEAD || smem > MAX_SMEM || blocks > 0x7fffffff ||
      OH != (H - 1) / 2 + 1 || OW != (W - 1) / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stem_pool_quant_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_pool_quant_kernel<<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), A, B, out, H, W, OH, OW, C, slab, lookahead);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
