// K6: int8 convolution, NHWC int8 activations x (Cout, KH, KW, Cin) int8
// weights -> int32 accumulators -> a dequantized store (bf16, f8 e4m3 or int8).
//
// Replaces the int8 convs that XLA compiled for the JAX package's quantized
// embed, `_qconv_stored` and `_qconv_static` of
// montecarlo_gated_mil_tpu/ops/quantized.py (no Pallas kernel there; PyTorch
// has no int8 convolution on CUDA at all).
//
// What bounds it on an H100: at the r18 embed's shapes the products need
// 2 * M * Cout * K int8 operations (1,979 TOP/s dense) against reading the
// activations and weights once and writing the store once (3.35 TB/s); the
// 3x3 convs of layers 1-2 sit near the balance point, the 1x1 downsamples
// and the bf16 stores are byte-bound.
//
// Design, simple first: an implicit GEMM.  Rows are output pixels
// (M = N * OH * OW), columns output channels, the depth K = KH * KW * Cin in
// (ky, kx, ci) order, which is the weight layout, so a weight row is
// contiguous.  Each block computes a 128 x BN tile with eight warps of
// `mma.sync.m16n8k32` s8 x s8 -> s32, over K tiles of 64 double-buffered in
// shared memory by cp.async.  With Cin % 64 == 0 a K tile lies inside one tap:
// each row of it is 64 contiguous bytes of one input pixel, fetched in 16-byte
// copies, zero-filled where the tap falls in the padding (the scheme is
// symmetric, so a zero code is an exact zero).  Otherwise (Cin = 12 at the
// space-to-depth stem) the tile is gathered in 4-byte groups, each inside one
// tap because Cin % 4 == 0.  Shared-memory rows are 80 bytes apart, which
// makes the fragment reads free of bank conflicts.  The accumulators never
// leave registers: the epilogue converts each with round-to-nearest
// (`__int2float_rn`, as torch's `.to(float32)`; |acc| can pass 2^24), scales
// it with one rounded multiply, and stores it.  Offsets into the activations
// and the output are 64-bit: the stem's output passes 2^31 elements.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output pixels per block
constexpr int BK = 64;           // depth per shared-memory stage
constexpr int LDS = BK + 16;     // bytes between shared-memory rows
constexpr int THREADS = 256;

enum Store { kBf16 = 0, kF8 = 1, kI8 = 2 };

struct Shape {
  int N, H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, OH, OW;
  int M, K;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output element pair (columns c, c + 1 of row m) from its accumulators.
template <int STORE>
__device__ __forceinline__ void store_pair(void* out, int64_t off, int a0, int a1, float s0,
                                           float s1) {
  const float y0 = __fmul_rn(__int2float_rn(a0), s0);
  const float y1 = __fmul_rn(__int2float_rn(a1), s1);
  if (STORE == kBf16) {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(y0);
    v.y = __float2bfloat16_rn(y1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off) = v;
  } else if (STORE == kF8) {
    const __nv_fp8_storage_t q0 =
        __nv_cvt_float_to_fp8(fminf(fmaxf(y0, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
    const __nv_fp8_storage_t q1 =
        __nv_cvt_float_to_fp8(fminf(fmaxf(y1, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
    *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(out) + off) =
        static_cast<uint16_t>(q0) | (static_cast<uint16_t>(q1) << 8);
  } else {
    const int q0 = static_cast<int>(fminf(fmaxf(rintf(y0), -127.f), 127.f));
    const int q1 = static_cast<int>(fminf(fmaxf(rintf(y1), -127.f), 127.f));
    *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + off) =
        static_cast<uint16_t>(q0 & 0xff) | static_cast<uint16_t>((q1 & 0xff) << 8);
  }
}

// BN: output channels per block (64 or 128).  VEC: Cin % 64 == 0, so a K tile
// lies inside one tap and is fetched in 16-byte copies.
template <int BN, bool VEC, int STORE>
__global__ void __launch_bounds__(256) qconv_kernel(const int8_t* __restrict__ act,
                                                    const int8_t* __restrict__ wgt,
                                                    const float* __restrict__ scale,
                                                    void* __restrict__ out, Shape sh) {
  constexpr int WARPS_N = BN / 32;            // warps along the channels
  constexpr int WARPS_M = 8 / WARPS_N;        // warps along the pixels
  constexpr int WM = BM / WARPS_M;            // pixels per warp
  constexpr int MI = WM / 16;                 // m16 tiles per warp
  constexpr int NI = 4;                       // n8 tiles per warp (32 channels)
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];

  const int tiles_n = (sh.Cout + BN - 1) / BN;
  const int tile_m = blockIdx.x / tiles_n, tile_n = blockIdx.x % tiles_n;
  const int m0 = tile_m * BM, n0 = tile_n * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane / 4, t4 = lane % 4;
  const int KT = (sh.K + BK - 1) / BK;
  const int64_t HWC = static_cast<int64_t>(sh.H) * sh.W * sh.Cin;

  // VEC: this thread's two rows (tid / 4 and tid / 4 + 64) and 16-byte chunk.
  int row_n[2], row_iy[2], row_ix[2];
  bool row_ok[2];
  if (VEC) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + tid / 4 + 64 * j;
      row_ok[j] = m < sh.M;
      const int mm = row_ok[j] ? m : 0;
      const int n = mm / (sh.OH * sh.OW), r = mm % (sh.OH * sh.OW);
      row_n[j] = n;
      row_iy[j] = (r / sh.OW) * sh.stride - sh.pad_top;
      row_ix[j] = (r % sh.OW) * sh.stride - sh.pad_left;
    }
  }

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    if (VEC) {
      const int tap = k0 / sh.Cin, ci0 = k0 - tap * sh.Cin;
      const int ky = tap / sh.KW, kx = tap % sh.KW;
      const int chunk = tid % 4;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int iy = row_iy[j] + ky, ix = row_ix[j] + kx;
        const bool ok = row_ok[j] && iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W;
        const int8_t* src =
            ok ? act + row_n[j] * HWC + (static_cast<int64_t>(iy) * sh.W + ix) * sh.Cin + ci0 +
                     chunk * 16
               : act;
        cp_async16(&As[stage][tid / 4 + 64 * j][chunk * 16], src, ok);
      }
    } else {
      // 4-byte groups: row tid / 16 + 16 j, group tid % 16.
      const int grp = tid % 16;
      const int k = k0 + grp * 4;
      const int tap = k / sh.Cin, ci = k - tap * sh.Cin;
      const int ky = tap / sh.KW, kx = tap % sh.KW;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = tid / 16 + 16 * j;
        const int m = m0 + row;
        bool ok = m < sh.M && k < sh.K;
        const int mm = ok ? m : 0;
        const int n = mm / (sh.OH * sh.OW), r = mm % (sh.OH * sh.OW);
        const int iy = (r / sh.OW) * sh.stride - sh.pad_top + ky;
        const int ix = (r % sh.OW) * sh.stride - sh.pad_left + kx;
        ok = ok && iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W;
        const int8_t* src =
            ok ? act + n * HWC + (static_cast<int64_t>(iy) * sh.W + ix) * sh.Cin + ci : act;
        cp_async4(&As[stage][row][grp * 4], src, ok);
      }
    }
    // Weights: BN rows of 4 chunks of 16 bytes.
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      const int q = tid + THREADS * j;
      const int row = q / 4, chunk = q % 4;
      const int co = n0 + row, k = k0 + chunk * 16;
      const bool ok = co < sh.Cout && k < sh.K;
      const int8_t* src = ok ? wgt + static_cast<int64_t>(co) * sh.K + k : wgt;
      cp_async16(&Bs[stage][row][chunk * 16], src, ok);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = warp_m * WM + i * 16 + g;
        a[i][0] = *reinterpret_cast<const unsigned*>(&As[s][r][ks + 4 * t4]);
        a[i][1] = *reinterpret_cast<const unsigned*>(&As[s][r + 8][ks + 4 * t4]);
        a[i][2] = *reinterpret_cast<const unsigned*>(&As[s][r][ks + 16 + 4 * t4]);
        a[i][3] = *reinterpret_cast<const unsigned*>(&As[s][r + 8][ks + 16 + 4 * t4]);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = warp_n * 32 + j * 8 + g;
        b[j][0] = *reinterpret_cast<const unsigned*>(&Bs[s][c][ks + 4 * t4]);
        b[j][1] = *reinterpret_cast<const unsigned*>(&Bs[s][c][ks + 16 + 4 * t4]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // Epilogue: c0, c1 at row g, columns 2 t4 and 2 t4 + 1; c2, c3 at row g + 8.
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int co = n0 + warp_n * 32 + j * 8 + 2 * t4;
    if (co >= sh.Cout) continue;
    const float s0 = scale[co], s1 = scale[co + 1];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * WM + i * 16 + g + 8 * h;
        if (m < sh.M)
          store_pair<STORE>(out, static_cast<int64_t>(m) * sh.Cout + co, acc[i][j][2 * h],
                            acc[i][j][2 * h + 1], s0, s1);
      }
    }
  }
}

template <int BN, bool VEC>
cudaError_t launch_store(const int8_t* a, const int8_t* w, const float* scale, void* out,
                         const Shape& sh, int store, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>((sh.M + BM - 1) / BM) * ((sh.Cout + BN - 1) / BN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (store == kBf16)
    qconv_kernel<BN, VEC, kBf16><<<grid, THREADS, 0, stream>>>(a, w, scale, out, sh);
  else if (store == kF8)
    qconv_kernel<BN, VEC, kF8><<<grid, THREADS, 0, stream>>>(a, w, scale, out, sh);
  else
    qconv_kernel<BN, VEC, kI8><<<grid, THREADS, 0, stream>>>(a, w, scale, out, sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// act (N, H, W, Cin) int8; wgt (Cout, KH, KW, Cin) int8; scale (Cout,) f32
// (the dequant scale s, or s / t for the int8 store); out (N, OH, OW, Cout)
// in the store's dtype (0 bf16, 1 float8_e4m3fn, 2 int8).  Padding is given
// at the top and left; the bottom and right follow from OH and OW.  Needs
// Cin % 4 == 0, Cout % 64 == 0 and KH * KW * Cin % 16 == 0.
// Returns the cudaError_t of the launch (0 = success).
int qconv_i8(const int8_t* act, const int8_t* wgt, const float* scale, void* out, int N, int H,
             int W, int Cin, int Cout, int KH, int KW, int stride, int pad_top, int pad_left,
             int OH, int OW, int store, void* stream) {
  const int64_t M = static_cast<int64_t>(N) * OH * OW;
  if (M == 0 || Cout == 0) return static_cast<int>(cudaSuccess);
  if (M > 0x7fffffff || Cin % 4 || Cout % 64 || (KH * KW * Cin) % 16 || store < 0 || store > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{N, H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, OH, OW,
                 static_cast<int>(M), KH * KW * Cin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = Cin % BK == 0;
  cudaError_t err;
  if (Cout % 128 == 0)
    err = vec ? launch_store<128, true>(act, wgt, scale, out, sh, store, s)
              : launch_store<128, false>(act, wgt, scale, out, sh, store, s);
  else
    err = vec ? launch_store<64, true>(act, wgt, scale, out, sh, store, s)
              : launch_store<64, false>(act, wgt, scale, out, sh, store, s);
  return static_cast<int>(err);
}

}  // extern "C"
