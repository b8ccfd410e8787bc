// Building blocks shared by the MC head's forward (mc_head.cu) and backward
// (mc_head_bwd.cu) kernels: f32-accurate products on Hopper's tensor cores
// (3xTF32 through mma.sync), the dropout-masked H tile, the gate product
// and the row-tile plan.
//
// 3xTF32.  A TF32 value keeps 11 significant bits.  Each f32 operand x is
// split as hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in f32), and
// a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 accumulation:
// the dropped a_lo*b_lo and the rounding of lo leave about 2^-22 of each
// product, as f32 does, where plain TF32 leaves 2^-11.  The rounding is done
// in integer arithmetic (round to nearest, ties away, as cvt.rna.tf32.f32),
// so tests/test_torch_tf32_split.py can emulate it bit for bit on the CPU.
//
// mma.sync m16n8k8 (not wgmma): its fragments come from registers, so the
// split happens in registers after an ordinary shared-memory load, and an
// operand may sit in shared memory in either orientation; a padded row
// stride keeps every fragment load free of bank conflicts.  wgmma takes
// 32-bit operands only K-major from swizzled descriptor layouts, which would
// need every operand, including the transposed ones of the backward, in a
// second layout.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mch {

constexpr int kMaxC = 8;
constexpr int kSmemMax = 232448;  // bytes of shared memory a block may use (sm_90)
constexpr float kMaskFill = -1e30f;
constexpr int BK = 16;      // weight rows (L) per pipeline stage of the gate product

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(__float_as_uint(x));
  lo = tf32_round(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a b for one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The A fragment (16 x 8) at rows m0.., columns k0.. of a shared-memory
// matrix, split hi/lo.  KM: stored [k][m] (row stride ld = 8 mod 32 for no
// bank conflicts), else [m][k] (ld = 4 mod 32).  Thread (g = lane/4,
// q = lane%4) holds (g, q), (g+8, q), (g, q+4), (g+8, q+4).
template <bool KM>
__device__ __forceinline__ void load_a(const float* s, int ld, int m0, int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + (i & 1) * 8, k = k0 + q + (i >> 1) * 4;
    split_tf32(KM ? s[k * ld + m] : s[m * ld + k], hi[i], lo[i]);
  }
}

// The B fragment (8 x 8) at rows k0.., columns n0...  NK: stored [n][k]
// (ld = 4 mod 32), else [k][n] (ld = 8 mod 32).  Thread (g, q) holds
// (k = q, n = g) and (q + 4, g).
template <bool NK>
__device__ __forceinline__ void load_b(const float* s, int ld, int k0, int n0, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + q + i * 4, n = n0 + g;
    split_tf32(NK ? s[n * ld + k] : s[k * ld + n], hi[i], lo[i]);
  }
}

// Accumulator element i of an m16n8 tile lies at row (lane/4) + 8*(i/2),
// column 2*(lane%4) + i%2.
//
// Promotion.  The tensor cores add into their f32 accumulator with
// truncation, not round-to-nearest, so a long chain of mma into one
// accumulator drifts towards zero by about an ulp of the running sum per
// step: unpromoted, the logits ended ten times further from the exact
// product than an f32 product's at L = 512, and thirty times at L = 2048
// (PERF.md).  So each product sums a short run of k-steps into a zeroed
// partial on the tensor cores and adds the partial into the accumulator on
// the FP32 cores (add_acc), round to nearest.
template <int A, int B>
__device__ __forceinline__ void zero_acc(float (&acc)[A][B][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][b][i] = 0.f;
}

template <int A, int B>
__device__ __forceinline__ void add_acc(float (&acc)[A][B][4], const float (&part)[A][B][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][b][i] += part[a][b][i];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sets ok[r] for rows r < rows (thread r writes it) and returns, in every
// thread, whether any is set; needs blockDim.x >= rows.  A block-wide
// barrier, after which ok is visible.
__device__ __forceinline__ bool set_row_flags(int* ok, int rows, bool mine) {
  const bool v = threadIdx.x < rows && mine;
  if (threadIdx.x < rows) ok[threadIdx.x] = v;
  return __syncthreads_or(v) != 0;
}

// Stages rows n0 .. n0+rows-1 of Hd = H * keep_f / (1 - p_feat) in shared
// memory (row stride ldh); rows whose flag ok[r] is 0 are zeros.  Each
// thread takes four neighbouring columns, one Philox call.  With `bits`
// (and dropout on) it also stores the keep bits of the flagged rows: bit
// l % 32 of word (n, l / 32) of an (N, L / 32) array.  L % 32 == 0.
__device__ void load_hd_tile(float* Hs, int ldh, const float* __restrict__ H, const int* ok,
                             int L, int n0, int rows, uint32_t key, float p_feat, float scale_f,
                             uint32_t* __restrict__ bits) {
  const int l4 = L >> 2, total = rows * l4;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int base = 0; base < total; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const bool in = e < total;
    const int r = in ? e / l4 : 0, l = in ? (e - r * l4) * 4 : 0;
    const int n = n0 + r;
    const bool valid = in && ok[r];
    float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t nib = 0;
    if (valid) {
      h = *reinterpret_cast<const float4*>(H + (size_t)n * L + l);
      if (p_feat > 0.f) {
        const uint4 w = dropout_words4(key, 0u, (uint32_t)(n * L + l) >> 2);
        const bool k0 = word_uniform(w.x) >= p_feat, k1 = word_uniform(w.y) >= p_feat;
        const bool k2 = word_uniform(w.z) >= p_feat, k3 = word_uniform(w.w) >= p_feat;
        h.x = k0 ? h.x * scale_f : 0.f;
        h.y = k1 ? h.y * scale_f : 0.f;
        h.z = k2 ? h.z * scale_f : 0.f;
        h.w = k3 ? h.w * scale_f : 0.f;
        nib = (uint32_t)k0 | ((uint32_t)k1 << 1) | ((uint32_t)k2 << 2) | ((uint32_t)k3 << 3);
      }
    }
    if (in) *reinterpret_cast<float4*>(Hs + r * ldh + l) = h;
    if (bits != nullptr && p_feat > 0.f) {
      // Eight neighbouring lanes hold the 32 columns of one word.
      uint32_t word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      if (valid && (lane & 7) == 0) bits[(size_t)n * (L >> 5) + (l >> 5)] = word;
    }
  }
}

// Rows l0 .. l0+rows-1 of [Wv[g] | Wu[g]] into one stage, stored
// [k][2D + 8] (the B operand, [k][n]).
__device__ __forceinline__ void load_w_stage(float* st, const float* __restrict__ wv,
                                             const float* __restrict__ wu, int g, int L, int D,
                                             int l0, int rows) {
  const int cols4 = D / 2;  // float4 chunks in a row of 2D
  const int ld = 2 * D + 8;
  for (int e = threadIdx.x; e < rows * cols4; e += blockDim.x) {
    const int k = e / cols4, c = (e - k * cols4) * 4;
    const size_t row = ((size_t)g * L + l0 + k) * D;
    cp_async16(st + k * ld + c, c < D ? wv + row + c : wu + row + (c - D));
  }
}

// cp.async stages of the gate product: two in flight while one is used.
constexpr int NSTAGE = 3;

// The gate pre-activations of gate g for one warp: rows m_base .. m_base +
// 16*MT - 1 of the staged Hd tile against columns d_base .. d_base + 31 of
// Wv[g] (acc[..][0..3]) and of Wu[g] (acc[..][4..7]), in 3xTF32 over all L.
// The weights stream through NSTAGE cp.async stages of KS * BK rows; warp
// group ks (of KS) takes rows ks*BK .. ks*BK + BK - 1 of every stage, and
// the groups' sums are added in order at the end, into group 0 (the other
// groups' acc is then undefined).  Each k-step runs its 3 * MT * 8
// products as three passes of independent tiles.  Every thread of the
// block calls it; the Hd tile must be staged and visible.
template <int MT, int KS>
__device__ __forceinline__ void gate_product(const float* Hs, int ldh, float* stages,
                                             const float* __restrict__ wv,
                                             const float* __restrict__ wu, int g, int L, int D,
                                             int m_base, int d_base, int ks,
                                             float (&acc)[MT][8][4]) {
  zero_acc(acc);
  constexpr int SK = KS * BK;
  const int ldw = 2 * D + 8, stage = SK * ldw;
  const int nk = L / SK;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_w_stage(stages + s * stage, wv, wu, g, L, D, s * SK, SK);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage `it` landed everywhere; stage it-1 is free
    const int nxt = it + NSTAGE - 1;
    if (nxt < nk) load_w_stage(stages + (nxt % NSTAGE) * stage, wv, wu, g, L, D, nxt * SK, SK);
    cp_async_commit();
    const float* st = stages + (it % NSTAGE) * stage;
    float part[MT][8][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const int k = ks * BK + kk;
      uint32_t ah[MT][4], al[MT][4], bh[8][2], bl[8][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<false>(Hs, ldh, m_base + mt * 16, it * SK + k, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < 8; ++j) load_b<false>(st, ldw, k, (j < 4 ? 0 : D) + d_base + (j & 3) * 8, bh[j], bl[j]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(part[mt][j], al[mt], bh[j]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(part[mt][j], ah[mt], bl[j]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(part[mt][j], ah[mt], bh[j]);
    }
    add_acc(acc, part);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free
  if (KS > 1) {
    const int gthr = blockDim.x / KS, gt = threadIdx.x - ks * gthr;
    if (ks > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            stages[((size_t)((ks - 1) * MT + mt) * 32 + j * 4 + i) * gthr + gt] = acc[mt][j][i];
    }
    __syncthreads();
    if (ks == 0) {
      for (int q = 1; q < KS; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mt][j][i] += stages[((size_t)((q - 1) * MT + mt) * 32 + j * 4 + i) * gthr + gt];
    }
    __syncthreads();  // the stages may be refilled by the next call
  }
}

// Shared memory of a gate-product block: the Hd tile, NSTAGE weight stages
// of ks * BK rows and 6 * kMaxC * bm floats of epilogue scratch.
inline size_t gate_block_smem(int bm, int ks, int L, int D) {
  return 4 * ((size_t)bm * (L + 4) + (size_t)NSTAGE * ks * BK * (2 * D + 8) +
              (size_t)6 * kMaxC * bm);
}

// How the gate-product kernels tile the rows: the largest row tile (64, 32
// or 16 rows, each a 16-row warp tile times MT times RW) whose shared memory
// fits and that still gives one block per SM over all T samples.  If none
// does, the smallest tile that fits, with one gate per block (gpb = 1) so
// that separate gates double the blocks.  Tiles of 32 and 16 rows split L
// over two warp groups (ks = 2) where the larger stages fit, so that a
// block has 8 warps, as the 64-row tile has; a 32-row tile is only taken
// with that split (without it, 16 rows).  bm = 0: nothing fits.
struct RowPlan {
  int bm, ks, gpb, ntiles;
  size_t smem;
};

inline RowPlan plan_rows(int N, int L, int D, int G, int T) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  RowPlan last = {0, 1, 1, 0, 0};
  for (int bm = 64; bm >= 16; bm /= 2) {
    const int ks = bm <= 32 && gate_block_smem(bm, 2, L, D) <= (size_t)kSmemMax ? 2 : 1;
    if (bm == 32 && ks == 1) continue;
    const size_t smem = gate_block_smem(bm, ks, L, D);
    if (smem > (size_t)kSmemMax) continue;
    const int ntiles = (N + bm - 1) / bm;
    if ((long)ntiles * T >= sms) return {bm, ks, G, ntiles, smem};
    last = {bm, ks, 1, ntiles, smem};
  }
  return last;
}

// Threads of a gate-product block: RW * (D / 32) * KS warps.
inline int gate_block_threads(const RowPlan& plan, int D) {
  return (plan.bm == 64 ? 2 : 1) * (D / 32) * plan.ks * 32;
}

// Calls LAUNCH(MT, RW, KS) for the row plan's tile (64 rows: 2 x 2 warp
// rows of 16; 32: 2 x 1, L split in two; 16: 1 x 1) and its split of L.
#define MCH_DISPATCH_ROWS(plan, LAUNCH)                                                  \
  ((plan).bm == 64   ? LAUNCH(2, 2, 1)                                                   \
   : (plan).bm == 32 ? LAUNCH(2, 1, 2)                                                   \
                     : ((plan).ks == 2 ? LAUNCH(1, 1, 2) : LAUNCH(1, 1, 1)))

constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared-memory limit on the current device to
// `bytes` the first time a launch there needs more than allowed[device]
// (the caller's own static for that kernel), instead of on every launch.
// The attribute holds per device, so each device keeps its own entry; the
// wrappers make the input's device current.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && known) allowed[dev] = bytes;
  return err;
}

// The shapes these kernels take (checked again by the Python wrapper).
inline bool shapes_ok(int N, int L, int D, int C, int G, int T) {
  return N >= 1 && T >= 1 && L % 64 == 0 && L >= 64 && D % 32 == 0 && D >= 32 && D <= 128 &&
         C >= 1 && C <= kMaxC && (G == 1 || G == C);
}

}  // namespace mch
