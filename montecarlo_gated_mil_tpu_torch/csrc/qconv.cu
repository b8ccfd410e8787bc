// K6: int8 convolution, NHWC int8 activations x (Cout, KH, KW, Cin) int8
// weights -> int32 accumulators -> a dequantized store (bf16, f8 e4m3 or int8).
//
// Replaces the int8 convs that XLA compiled for the JAX package's quantized
// embed, `_qconv_stored` and `_qconv_static` of
// montecarlo_gated_mil_tpu/ops/quantized.py (no Pallas kernel there; PyTorch
// has no int8 convolution on CUDA at all).
//
// What bounds it on an H100: the products need 2 * M * Cout * K int8
// operations (1,979 TOP/s dense, reached only through `wgmma`) against
// reading the activations and weights once and writing the store once
// (3.35 TB/s).  The r18 embed's 3x3 convs of layers 2-4 are bound by
// operations, layer 1's 3x3 and the 1x1 downsamples by bytes, most of them
// the bf16 store.  Between the two sits the traffic from L2 into the SMs:
// an implicit GEMM that fetches its A operand per tap reads every input
// pixel KH * KW times, and every tile needs the weights of its columns.
//
// Design (`qconv_wgmma_kernel`; every conv with Cin % 64 == 0, at most 64
// taps and stride 1 or 2, which is every int8 conv of r18, r34 and r50): an
// implicit GEMM.  Rows are output pixels, columns output channels, the
// depth K = KH * KW * Cin in (ky, kx, ci) order, the weight layout; `wgmma`
// takes 8-bit A and B only K-major, which is the layout both already have.
// - A tile is 8 x 8 output pixels of one instance, one `wgmma` M of 64 rows.
//   For each 64 input channels the producer loads a tile's input halo once,
//   (8 + KW - 1) x (8 + KH - 1) pixels at stride 1, by TMA, and every tap's
//   A operand is an offset into that halo (from a per-tap table in shared
//   memory), with no second fetch.  This needs the unswizzled K-major
//   layout: each 16-channel slice of the halo is its own plane of 16-byte
//   pixel rows (one 4-D TMA box over (C, W, H, N) of 16 channels), so an
//   8-pixel row segment is one 8 x 16-byte core matrix at any pixel offset,
//   the next output row is one halo row further (the stride byte offset)
//   and the next 16 channels one plane further (the leading byte offset).
// - Out-of-range box coordinates fill with zeros; under the symmetric scheme
//   a zero code is an exact zero, so that is the padding, at every edge.
//   Stride 2 uses one tensor map per parity of (y, x) that a tap reads, each
//   a plain tiled view with doubled strides, so a stride-2 tap is again an
//   offset into a dense halo (TMA's element strides would not let the taps
//   of one parity share a box; im2col mode fetches per tap).
// - Two consumer warpgroups work independently, each on its own stream of
//   work items (MT tiles at one column tile of BN = 64, 128 or 256 output
//   channels, MT = 256 / BN where the rings fit, so 128 accumulator
//   registers), fed by its own producer warp through its own halo and
//   weight rings with full / empty `mbarrier`s; one warpgroup's epilogue
//   overlaps the other's products.  `setmaxnreg` gives the consumers 232
//   registers and the producers 40.
// - The weights stay resident in shared memory where the conv has one column
//   tile and they fit beside the rings (r18's layer-1 3x3 at 37 KB, its
//   layer-2 3x3/2 at 74 KB and the 1x1/2 downsamples of layers 2-3), loaded
//   once per block.  Otherwise a (tap,
//   64-channel) slice of BN rows streams through the weight ring (64-byte
//   swizzle, matched by its descriptor), and neighbouring blocks share it in
//   L2 (the column tile varies fastest).
// - `wgmma.m64nNk32` s8 x s8 -> s32 keeps one group in flight while the
//   next is issued.  Blocks are persistent, one per SM, walking the items.
// - The rings are as deep as shared memory allows (`plan_stages`): weight
//   stages first, then halo stages, from two.  At the bf16 store the halo
//   ring of r18's shapes has 3 stages at layer 1's 3x3 and layer 4's 1x1/2,
//   8 at the 1x1/2 of layers 2-3, and 2 at every 3x3/2 and at the 3x3 of
//   layers 2-4, where a third does not fit beside the resident weights or
//   the weight ring (2-4 stages).  One halo stage serves all taps of its
//   64 channels.
// - The epilogue converts each accumulator exactly as before
//   (`__int2float_rn`, as torch's `.to(float32)`; |acc| can pass 2^24), scales
//   it with one rounded multiply and rounds it to the store, stages a tile in
//   shared memory (in two passes of 32 rows where that lets the weights
//   stay resident) and writes each output row in 16-byte stores.  The int32
//   sums are exact in any order, so the result is bit-exact.
// Offsets into the activations and the output are 64-bit: at an extended
// bucket of 6144 instances layer 1's bf16 output passes 2^31 bytes.
//
// K7's sums in the epilogue (`qconv_i8_stats`, the redesign of K7 for the
// card).  Batch-statistics BN needs, per (instance, channel), the sum and
// the sum of squares over (h, w) of the stored output's f32 view; K7
// (bn_quant.cu) read every stored output back for them.  Both wgmma
// kernels hold each tile in shared memory, converted, before they store
// it, so they take the sums there: each thread of the warpgroup owns a
// channel pair of the column tile over a group of the tile's pixel rows
// (TileSums) and walks them in row order, leaving out pixels past the
// output (a 7x7 map fills 49 of a tile's 64) and tiles past the last
// instance, with K7's arithmetic (the stored value's f32 view, an int8
// code times its tq in one rounded multiply, added and squared into
// float64).  Sums from the staged tile, not the accumulator fragments,
// whose channels are spread over the lanes of four warps.  They lengthen
// the consumers' epilogue, and their code alone slows the products at
// layers 1-2 (PERF.md, section 6): per request the sums tie K7's re-read
// rather than saving it.  A warpgroup's item of MT tiles keeps
// summing over its tiles of one instance (a run), and the run's pair of
// sums per channel (16 bytes) goes to a partial indexed by its last spatial
// tile, which bn_quant.cu's bn_stats_fold_kernel folds per instance in
// tile order; where an instance is one tile (7x7 maps) the kernel writes
// the f32 sums itself and nothing is folded.  No atomics: the same bits
// every run.  At layer 1 and 3072 instances (runs of 4 tiles) the partials
// are about 43 MB written and read once, against the 1.23 GB of bf16 output
// K7 read back.
//
// Where the column tile is 256 channels (r18's layers 3-4), that design
// gives each 64-row item its whole weight slice from L2: the traffic that
// bounded the 3x3 and 3x3/2 there.  Those convs run
// `qconv_wgmma_pair_kernel` (below): both warpgroups share one weight ring,
// and at the 3x3/2 two blocks of a cluster share each weight stage by TMA
// multicast, with the same halos, products and epilogue.
//
// The s2d stem (Cin = 12, the `stem="s2d_i8"` option, off by default) and
// any conv outside those shapes run `qconv_gather_kernel`, the first design
// kept for them: 128-pixel tiles, eight warps of `mma.sync.m16n8k32`, the
// A tile gathered in 4-byte `cp.async` groups (each inside one tap because
// Cin % 4 == 0) and double-buffered with the weights.  `qconv_i8` alone
// picks the path by shape; which device function ran is read from the
// profiler's kernel names (chip_smoke.py phase 4q, the card-only tests).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_s8.cuh"

namespace {

enum Store { kBf16 = 0, kF8 = 1, kI8 = 2 };

template <int STORE>
__host__ __device__ constexpr int store_bytes() {
  return STORE == kBf16 ? 2 : 1;
}

// One output element pair (columns c, c + 1 of one row) from its
// accumulators, in the store's bits: a bf16 pair in 32 bits, an 8-bit pair
// in the low 16.
template <int STORE>
__device__ __forceinline__ uint32_t pack_pair(int a0, int a1, float s0, float s1) {
  const float y0 = __fmul_rn(__int2float_rn(a0), s0);
  const float y1 = __fmul_rn(__int2float_rn(a1), s1);
  if (STORE == kBf16) {
    const uint32_t b0 = __bfloat16_as_ushort(__float2bfloat16_rn(y0));
    const uint32_t b1 = __bfloat16_as_ushort(__float2bfloat16_rn(y1));
    return b0 | (b1 << 16);
  } else if (STORE == kF8) {
    const __nv_fp8_storage_t q0 =
        __nv_cvt_float_to_fp8(fminf(fmaxf(y0, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
    const __nv_fp8_storage_t q1 =
        __nv_cvt_float_to_fp8(fminf(fmaxf(y1, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
    return static_cast<uint32_t>(q0) | (static_cast<uint32_t>(q1) << 8);
  } else {
    const int q0 = static_cast<int>(fminf(fmaxf(rintf(y0), -127.f), 127.f));
    const int q1 = static_cast<int>(fminf(fmaxf(rintf(y1), -127.f), 127.f));
    return static_cast<uint32_t>(q0 & 0xff) | (static_cast<uint32_t>(q1 & 0xff) << 8);
  }
}

// Where a launch puts K7's sums (all null: no sums).
struct Sums {
  double2* part;    // (spatial tiles, Cout): a run's (sum, sum of squares) at its last tile
  float* s1;        // (N, Cout), written here where an instance is one tile
  float* s2;
  const float* tq;  // (Cout,): the int8 store's read-back scale; null for bf16 and f8
  int* run;         // host only: the launch writes its run of tiles there

  __host__ __device__ bool on() const { return part != nullptr || s1 != nullptr; }
};

// Two neighbouring channels of one staged row (shared-memory address
// `addr`) as K7 views them (bn_quant.cu load8): bf16 and e4m3 widened, an
// int8 code times its tq in one rounded multiply.
template <int STORE>
__device__ __forceinline__ void stored_pair(uint32_t addr, const float (&tq)[2], float& v0,
                                            float& v1) {
  if constexpr (STORE == kBf16) {
    uint32_t w;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w) : "r"(addr));
    v0 = __uint_as_float(w << 16);
    v1 = __uint_as_float(w & 0xffff0000u);
  } else {
    unsigned short w;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(w) : "r"(addr));
    if constexpr (STORE == kF8) {
      __nv_fp8_e4m3 f0, f1;
      f0.__x = static_cast<__nv_fp8_storage_t>(w & 0xff);
      f1.__x = static_cast<__nv_fp8_storage_t>(w >> 8);
      v0 = static_cast<float>(f0);
      v1 = static_cast<float>(f1);
    } else {
      v0 = __fmul_rn(static_cast<float>(static_cast<int8_t>(w & 0xff)), tq[0]);
      v1 = __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 8)), tq[1]);
    }
  }
}

// ------------------------------------------------------------ the wgmma path

constexpr int W_T = 8;           // a warpgroup's tile: 8 x 8 output pixels
constexpr int W_BK = 64;         // input channels per halo stage
constexpr int W_THREADS = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int W_MAX_STAGES = 8;
constexpr int W_SMEM = 232448;   // shared memory a block may use
constexpr int W_MAX_TAPS = 64;   // KH * KW

struct ActMaps {
  CUtensorMap m[4];  // one tiled view per input parity (y, x) a tap reads
};

// The geometry the kernel walks, fixed per launch.
struct Tiling {
  int N, OH, OW, Cout;
  int KH, KW, stride, pad_top, pad_left, cin_chunks;
  int q0y, q0x;         // the halo's first row and column, relative to the tile, per parity view
  int BH, BW;           // halo rows and columns
  int par_y, par_x;     // input parities read along y and x: bit p set if parity p is read
  int n_par;            // parity views loaded per stage (1, 2 or 4)
  int plane;            // bytes of one 16-channel halo plane, rounded up to 128
  int tiles_x, tiles_y, col_tiles, spatial, items;
  int a_stages, b_stages;
};

// Descriptor of the A operand in the unswizzled K-major layout: core
// matrices of 8 rows x 16 bytes, `lbo` bytes apart along K (the halo's
// 16-channel planes) and `sbo` bytes apart along M (one halo row).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 64)
    wgmma_m64n64k32(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_m64n128k32(d, a, b, scale_d);
  else
    wgmma_m64n256k32(d, a, b, scale_d);
}

// The warpgroup tile `st`: instance and top-left pixel.
struct TileAt {
  int n, oy0, ox0;
};

__device__ __forceinline__ TileAt tile_at(const Tiling& t, int st) {
  TileAt r;
  r.ox0 = (st % t.tiles_x) * W_T;
  const int rest = st / t.tiles_x;
  r.oy0 = (rest % t.tiles_y) * W_T;
  r.n = rest / t.tiles_y;
  return r;
}

// A tap offset o = k - pad along one axis: the parity p of the input it
// reads and the halo index of output 0, (o - p) / s - q0.
__device__ __forceinline__ void tap_axis(int o, int s, int q0, int& p, int& h) {
  p = ((o % s) + s) % s;
  h = (o - p) / s - q0;
}

// Index of parity (py, px) among the views loaded per stage.
__device__ __forceinline__ int parity_index(const Tiling& t, int py, int px) {
  const int nx = __popc(t.par_x);
  return __popc(t.par_y & ((1 << py) - 1)) * nx + __popc(t.par_x & ((1 << px) - 1));
}

template <int BN, int STORE>
__host__ __device__ constexpr int staging_row() {
  return BN * store_bytes<STORE>() + 16;
}

// One warpgroup's sums of one 64 x BN tile.  Thread i (of 128) owns the
// channel pair 2 (i % (BN / 2)) + {0, 1} of the column tile, so that a
// warp's loads of a staged row are one contiguous read, and the pixel rows
// of its row group i / (BN / 2): at BN = 256 all 8, at 128 four, at 64 two
// (one warp a group).  It adds its pixels in row order into float64 sums;
// the groups' sums are then added in group order (through the staging
// rows, once every thread has read them) and the first group writes them.
template <int BN, int STORE>
struct TileSums {
  static constexpr int PAIRS = BN / 2;    // channel pairs of a staged row
  static constexpr int RG = 128 / PAIRS;  // row groups: 4, 2 or 1
  static constexpr int YR = W_T / RG;     // pixel rows of a group
  double a[2], b[2];
  float tq[2];

  __device__ __forceinline__ int pair() const { return static_cast<int>(threadIdx.x % 128) % PAIRS; }
  __device__ __forceinline__ int group() const { return static_cast<int>(threadIdx.x % 128) / PAIRS; }

  __device__ __forceinline__ void start(const Sums& s, int col0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      a[k] = b[k] = 0.0;
      tq[k] = STORE == kI8 ? __ldg(s.tq + col0 + 2 * pair() + k) : 0.f;
    }
  }

  // This thread's pixel rows if pass `pass` of HALVES staged them (tile
  // rows 8 / HALVES * pass .., from staging row 0); a group's rows are
  // staged in one pass.
  template <int HALVES>
  __device__ __forceinline__ void add_pass(const uint8_t* staging, int pass, const Tiling& t,
                                           const TileAt& at) {
    constexpr int R = W_T / HALVES;
    static_assert(YR <= R, "a row group spans two passes");
    const int y0 = group() * YR;
    if (at.n >= t.N || y0 / R != pass) return;
    const uint32_t addr = smem_u32(staging) +
                          (y0 - pass * R) * W_T * staging_row<BN, STORE>() +
                          2 * pair() * store_bytes<STORE>();
    if (t.OH - at.oy0 >= y0 + YR && t.OW - at.ox0 >= W_T)
      add_rows<true>(addr, 0, 0);
    else
      add_rows<false>(addr, t.OH - at.oy0 - y0, t.OW - at.ox0);
  }

  // Pixel rows y0 .. y0 + YR - 1 of the tile, staged from `addr`, in row
  // order; a partial tile leaves out pixels at or past (y_end, x_end) by
  // adding +0.0 for them, which leaves a sum that starts at +0.0 bit for
  // bit as it was (it never becomes -0.0), so the loop has no branch (two
  // rows unrolled measured a little faster than one or all).
  template <bool FULL>
  __device__ __forceinline__ void add_rows(uint32_t addr, int y_end, int x_end) {
    constexpr int SROW = staging_row<BN, STORE>();
#pragma unroll 2
    for (int y = 0; y < YR; ++y)
#pragma unroll
      for (int x = 0; x < W_T; ++x) {
        float v[2];
        stored_pair<STORE>(addr + (y * W_T + x) * SROW, tq, v[0], v[1]);
        const bool in = FULL || (y < y_end && x < x_end);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const double d = in ? static_cast<double>(v[k]) : 0.0;
          a[k] += d;
          b[k] += d * d;
        }
      }
  }

  // Spatial tile st's partial, or the instance's f32 sums where it is one
  // tile.  Every thread of the warpgroup calls it, after its last pass;
  // the groups' sums pass through the warpgroup's STAGE_BYTES of staging
  // rows, as many groups at a time as fit.
  template <int STAGE_BYTES>
  __device__ __forceinline__ void finish(const Sums& s, const Tiling& t, const TileAt& at, int st,
                                         int col0, uint8_t* staging, int wg) {
    if constexpr (RG > 1) {
      constexpr int PER = STAGE_BYTES / (PAIRS * 32);  // groups a round passes
      static_assert(PER >= 1, "the staging rows cannot hold a row group's sums");
      double2* slots = reinterpret_cast<double2*>(staging);  // [PER][PAIRS][2]
      for (int r0 = 1; r0 < RG; r0 += PER) {
        named_sync(1 + wg, 128);  // the staging rows, or the last round's slots, are read
        const int slot = group() - r0;
        if (slot >= 0 && slot < PER) {
          slots[(slot * PAIRS + pair()) * 2] = make_double2(a[0], b[0]);
          slots[(slot * PAIRS + pair()) * 2 + 1] = make_double2(a[1], b[1]);
        }
        named_sync(1 + wg, 128);
        if (group() == 0)
          for (int j = 0; j < PER && r0 + j < RG; ++j) {
            const double2 q0 = slots[(j * PAIRS + pair()) * 2];
            const double2 q1 = slots[(j * PAIRS + pair()) * 2 + 1];
            a[0] += q0.x;
            b[0] += q0.y;
            a[1] += q1.x;
            b[1] += q1.y;
          }
      }
      if (group() != 0) return;
    }
    if (at.n >= t.N) return;
    const int c = col0 + 2 * pair();
    if (t.tiles_x * t.tiles_y == 1) {
      const int64_t o = static_cast<int64_t>(at.n) * t.Cout + c;
      *reinterpret_cast<float2*>(s.s1 + o) =
          make_float2(static_cast<float>(a[0]), static_cast<float>(a[1]));
      *reinterpret_cast<float2*>(s.s2 + o) =
          make_float2(static_cast<float>(b[0]), static_cast<float>(b[1]));
    } else {
      double2* p = s.part + static_cast<int64_t>(st) * t.Cout + c;
      p[0] = make_double2(a[0], b[0]);
      p[1] = make_double2(a[1], b[1]);
    }
  }
};

// The paired kernel's epilogue: one warpgroup's 64 x BN accumulator tile
// (spatial tile `at`, output channels col0 ..) converted as the kernel above
// converts it, staged in the warpgroup's 64 staging rows and written out in
// 16-byte stores, rows outside the output left out.  The accumulator
// fragment of wgmma m64nN: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8; registers 4 j + {0, 1} are columns 8 j + 2 q + {0, 1} of
// the first row, 4 j + {2, 3} of the second.  Row r is pixel (r / 8, r % 8)
// of the tile.  With `sums` on, the staged tile's K7 sums too, as spatial
// tile st.
template <int BN, int STORE>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], const Tiling& t,
                                           const TileAt& at, int st, int col0,
                                           const float* __restrict__ scale, void* __restrict__ out,
                                           const Sums& sums, uint8_t* my_staging, int wg) {
  constexpr int ES = store_bytes<STORE>();
  constexpr int SROW = staging_row<BN, STORE>();
  const int tid = threadIdx.x % 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, row_w = (warp % 4) * 16;
  named_sync(1 + wg, 128);  // the last stores have read the staging rows
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cc = 8 * j + 2 * q;
    const float s0 = __ldg(scale + col0 + cc), s1 = __ldg(scale + col0 + cc + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = pack_pair<STORE>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], s0, s1);
      uint8_t* dst = my_staging + (row_w + g + 8 * h) * SROW + cc * ES;
      if (ES == 2)
        *reinterpret_cast<uint32_t*>(dst) = v;
      else
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v);
    }
  }
  named_sync(1 + wg, 128);
  constexpr int CHUNKS = BN * ES / 16;  // 16-byte pieces of one output row
  for (int i = tid; i < 64 * CHUNKS; i += 128) {
    const int row = i / CHUNKS, ch = i % CHUNKS;
    const int oy = at.oy0 + row / W_T, ox = at.ox0 + row % W_T;
    if (at.n < t.N && oy < t.OH && ox < t.OW) {
      const int64_t pix = (static_cast<int64_t>(at.n) * t.OH + oy) * t.OW + ox;
      uint8_t* dst = static_cast<uint8_t*>(out) + (pix * t.Cout + col0) * ES + ch * 16;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(my_staging + row * SROW + ch * 16);
    }
  }
  if (sums.on()) {
    TileSums<BN, STORE> ts;
    ts.start(sums, col0);
    ts.template add_pass<1>(my_staging, 0, t, at);
    ts.template finish<64 * SROW>(sums, t, at, st, col0, my_staging, wg);
  }
}

// One warpgroup's halos for one stage: MT tiles, each n_par parity views of
// four 16-channel planes.
template <int MT>
__host__ __device__ inline int a_stage_bytes(const Tiling& t) {
  return (MT * t.n_par * 4 * t.plane + 1023) / 1024 * 1024;
}

// Shared memory, from a 1024-byte aligned base: for each consumer
// warpgroup its halo ring (a_stages) and, unless the weights are resident,
// its weight ring (b_stages x BN x 64 bytes); the resident weights (KT x BN
// x 64 bytes); each warpgroup's output staging (64 / HALVES rows of BN stores plus
// 16 bytes of padding); then the barriers and the tap table.
template <int BN, int STORE, int MT, bool WRES, int HALVES>
__host__ __device__ inline int smem_bytes(const Tiling& t) {
  const int ring = t.a_stages * a_stage_bytes<MT>(t) + (WRES ? 0 : t.b_stages * BN * W_BK);
  const int wres = WRES ? t.KH * t.KW * t.cin_chunks * BN * W_BK : 0;
  return 1024 + 2 * ring + wres + 2 * (64 / HALVES) * staging_row<BN, STORE>() +
         (8 * W_MAX_STAGES + 1) * 8 +
         W_MAX_TAPS * 4;
}

template <int BN, int STORE, int MT, bool WRES, int HALVES>
__global__ void __launch_bounds__(W_THREADS, 1)
    qconv_wgmma_kernel(const __grid_constant__ ActMaps act, const __grid_constant__ CUtensorMap wgt,
                       const float* __restrict__ scale, void* __restrict__ out, Tiling t,
                       Sums sums) {
  constexpr int B_BYTES = BN * W_BK;
  constexpr int ES = store_bytes<STORE>();
  constexpr int SROW = staging_row<BN, STORE>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int A_BYTES = a_stage_bytes<MT>(t);
  const int KT = t.KH * t.KW * t.cin_chunks;
  const int taps = t.KH * t.KW;
  const int tile_bytes = t.n_par * 4 * t.plane;  // one tile's halo in a stage
  const int ring = t.a_stages * A_BYTES + (WRES ? 0 : t.b_stages * B_BYTES);
  uint8_t* wres = base + 2 * ring;
  uint8_t* staging = wres + (WRES ? KT * B_BYTES : 0);
  constexpr int stage_rows = 64 / HALVES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(staging + 2 * stage_rows * SROW);
  uint64_t* w_full = bars + 8 * W_MAX_STAGES;
  uint32_t* tap_offset = reinterpret_cast<uint32_t*>(w_full + 1);  // in a stage's halos

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      for (int s = 0; s < W_MAX_STAGES; ++s) {
        uint64_t* b = bars + i * 4 * W_MAX_STAGES;
        mbar_init(&b[s], 1);                     // halo full
        mbar_init(&b[W_MAX_STAGES + s], 4);      // halo empty: one arrival per consumer warp
        mbar_init(&b[2 * W_MAX_STAGES + s], 1);  // weights full
        mbar_init(&b[3 * W_MAX_STAGES + s], 4);  // weights empty
      }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < taps) {  // where each tap's A operand starts in a tile's halos
    const int ky = threadIdx.x / t.KW, kx = threadIdx.x - ky * t.KW;
    int py, hy, px, hx;
    tap_axis(ky - t.pad_top, t.stride, t.q0y, py, hy);
    tap_axis(kx - t.pad_left, t.stride, t.q0x, px, hx);
    tap_offset[threadIdx.x] = parity_index(t, py, px) * 4 * t.plane + (hy * t.BW + hx) * 16;
  }
  __syncthreads();

  // Consumer warpgroup wg (warps 4 wg .. 4 wg + 3) takes the work items
  // 2 block + wg, stepping by twice the grid; item i is MT spatial tiles
  // (i / col_tiles) MT + m, all at column tile i % col_tiles.  Producer warp
  // 8 + wg feeds it through its own rings.
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp < 10 && lane == 0) {
      const int wg = warp - 8;
      uint8_t* ring_a = base + wg * ring;
      uint8_t* ring_b = ring_a + t.a_stages * A_BYTES;
      uint64_t* a_full = bars + wg * 4 * W_MAX_STAGES;
      uint64_t* a_empty = a_full + W_MAX_STAGES;
      uint64_t* b_full = a_empty + W_MAX_STAGES;
      uint64_t* b_empty = b_full + W_MAX_STAGES;
      if (WRES && wg == 0) {
        mbar_expect_tx(w_full, static_cast<uint32_t>(KT * B_BYTES));
        for (int kt = 0; kt < KT; ++kt) tma_load_2d(wres + kt * B_BYTES, &wgt, kt * W_BK, 0, w_full);
      }
      const uint32_t a_tx = MT * t.n_par * 4 * t.BH * t.BW * 16;
      int a_it = 0, b_it = 0;
      for (int item = 2 * blockIdx.x + wg; item < t.items; item += 2 * gridDim.x) {
        const int col = item % t.col_tiles, grp = item / t.col_tiles;
        for (int c = 0; c < t.cin_chunks; ++c) {
          const int s = a_it % t.a_stages;
          mbar_wait(&a_empty[s], ((a_it / t.a_stages) & 1) ^ 1);
          mbar_expect_tx(&a_full[s], a_tx);
          for (int m = 0; m < MT; ++m) {
            const TileAt at = tile_at(t, grp * MT + m);
            uint8_t* dst = ring_a + s * A_BYTES + m * tile_bytes;
            for (int py = 0; py < 2; ++py) {
              if (!((t.par_y >> py) & 1)) continue;
              for (int px = 0; px < 2; ++px) {
                if (!((t.par_x >> px) & 1)) continue;
                const CUtensorMap* map = &act.m[py * 2 + px];
                uint8_t* pdst = dst + parity_index(t, py, px) * 4 * t.plane;
                for (int j = 0; j < 4; ++j)
                  tma_load_4d(pdst + j * t.plane, map, c * W_BK + 16 * j, at.ox0 + t.q0x,
                              at.oy0 + t.q0y, at.n, &a_full[s]);
              }
            }
          }
          ++a_it;
          if (!WRES)
            for (int tap = 0; tap < taps; ++tap) {
              const int sb = b_it % t.b_stages;
              mbar_wait(&b_empty[sb], ((b_it / t.b_stages) & 1) ^ 1);
              mbar_expect_tx(&b_full[sb], B_BYTES);
              tma_load_2d(ring_b + sb * B_BYTES, &wgt, (tap * t.cin_chunks + c) * W_BK, col * BN,
                          &b_full[sb]);
              ++b_it;
            }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4, tid = threadIdx.x % 128;
    const int g = lane / 4, q = lane % 4, row_w = (warp % 4) * 16;
    uint8_t* ring_a = base + wg * ring;
    uint8_t* ring_b = ring_a + t.a_stages * A_BYTES;
    uint64_t* a_full = bars + wg * 4 * W_MAX_STAGES;
    uint64_t* a_empty = a_full + W_MAX_STAGES;
    uint64_t* b_full = a_empty + W_MAX_STAGES;
    uint64_t* b_empty = b_full + W_MAX_STAGES;
    uint8_t* my_staging = staging + wg * stage_rows * SROW;
    const uint32_t lbo = t.plane, sbo = t.BW * 16;
    if (WRES) mbar_wait(w_full, 0);
    int acc[MT][BN / 2];
    int a_it = 0, b_it = 0;
    for (int item = 2 * blockIdx.x + wg; item < t.items; item += 2 * gridDim.x) {
      const int col = item % t.col_tiles, grp = item / t.col_tiles;
      int prev_a = -1, prev_b = -1;  // stages the group in flight still reads
      for (int c = 0; c < t.cin_chunks; ++c) {
        const int sa = a_it % t.a_stages;
        mbar_wait(&a_full[sa], (a_it / t.a_stages) & 1);
        ++a_it;
        const uint32_t halo = smem_u32(ring_a + sa * A_BYTES);
        for (int tap = 0; tap < taps; ++tap) {
          const uint32_t a_addr = halo + tap_offset[tap];
          int sb = 0;
          uint32_t b_addr;
          if (WRES) {
            b_addr = smem_u32(wres + (tap * t.cin_chunks + c) * B_BYTES);
          } else {
            sb = b_it % t.b_stages;
            mbar_wait(&b_full[sb], (b_it / t.b_stages) & 1);
            ++b_it;
            b_addr = smem_u32(ring_b + sb * B_BYTES);
          }
          const uint64_t db = desc_sw64(b_addr);
          const int first = c == 0 && tap == 0;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint64_t da = desc_plain(a_addr + m * tile_bytes, lbo, sbo);
            wgmma_k32<BN>(acc[m], da, db, !first);
            // The next 32 channels: two planes further in A, 32 bytes in B.
            wgmma_k32<BN>(acc[m], da + ((2 * lbo) >> 4), db + 2, 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          // The previous group is done: release what only it still read.
          if (lane == 0) {
            if (prev_b >= 0) mbar_arrive(&b_empty[prev_b]);
            if (prev_a >= 0) mbar_arrive(&a_empty[prev_a]);
          }
          prev_b = WRES ? -1 : sb;
          prev_a = tap == taps - 1 ? sa : -1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) {
        if (prev_b >= 0) mbar_arrive(&b_empty[prev_b]);
        if (prev_a >= 0) mbar_arrive(&a_empty[prev_a]);
      }

      // Epilogue, one tile at a time, in passes of stage_rows rows through
      // this warpgroup's staging rows.  The accumulator fragment of wgmma m64nN:
      // warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8;
      // registers 4 j + {0, 1} are columns 8 j + 2 q + {0, 1} of the first
      // row, 4 j + {2, 3} of the second.  Row r is pixel (r / 8, r % 8) of
      // the tile.
      const int col0 = col * BN;
      const int inst_tiles = t.tiles_x * t.tiles_y;
      TileSums<BN, STORE> ts;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int st = grp * MT + m;
        const TileAt at = tile_at(t, st);
        // K7's sums run over the item's tiles of one instance.
        if (sums.on() && (m == 0 || st % inst_tiles == 0)) ts.start(sums, col0);
#pragma unroll
        for (int pass = 0; pass < HALVES; ++pass) {
          named_sync(1 + wg, 128);  // the last stores have read the staging rows
          if ((warp % 4) * 16 / stage_rows == pass) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int cc = 8 * j + 2 * q;
              const float s0 = __ldg(scale + col0 + cc), s1 = __ldg(scale + col0 + cc + 1);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t v =
                    pack_pair<STORE>(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1], s0, s1);
                uint8_t* dst =
                    my_staging + (row_w - stage_rows * pass + g + 8 * h) * SROW + cc * ES;
                if (ES == 2)
                  *reinterpret_cast<uint32_t*>(dst) = v;
                else
                  *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v);
              }
            }
          }
          named_sync(1 + wg, 128);
          constexpr int CHUNKS = BN * ES / 16;  // 16-byte pieces of one output row
          for (int i = tid; i < stage_rows * CHUNKS; i += 128) {
            const int srow = i / CHUNKS, ch = i % CHUNKS, row = stage_rows * pass + srow;
            const int oy = at.oy0 + row / W_T, ox = at.ox0 + row % W_T;
            if (at.n < t.N && oy < t.OH && ox < t.OW) {
              const int64_t pix = (static_cast<int64_t>(at.n) * t.OH + oy) * t.OW + ox;
              uint8_t* dst = static_cast<uint8_t*>(out) + (pix * t.Cout + col0) * ES + ch * 16;
              *reinterpret_cast<uint4*>(dst) =
                  *reinterpret_cast<const uint4*>(my_staging + srow * SROW + ch * 16);
            }
          }
          if (sums.on()) ts.template add_pass<HALVES>(my_staging, pass, t, at);
        }
        if (sums.on() && (m == MT - 1 || (st + 1) % inst_tiles == 0))
          ts.template finish<stage_rows * SROW>(sums, t, at, st, col0, my_staging, wg);
      }
    }
  }
}

// ------------------------------------------------- the paired path (BN = 256)
//
// Where the column tile is 256 channels wide, the path above gives each
// warpgroup one 8 x 8 tile per work item, so every 64 rows fetch their
// whole weight slice (K x 256 bytes) from L2 into shared memory: 7.25 GB a
// conv at the 3x3 of layers 3-4 at 3072 instances, the traffic that bounds
// it there.  This kernel shares the weights: both consumer warpgroups of a
// block take the same column tile and neighbouring spatial tiles, fed from
// one weight ring whose empty barrier counts all eight consumer warps, and
// with CL = 2 the two blocks of a cluster walk the same items in lockstep,
// each loading half of every weight stage by TMA multicast into both.  So
// one fetch from L2 feeds 128 rows, or 256 with the cluster.  Each block's
// empty barrier then counts the consumer warps of both blocks, which
// release a stage in each other's barrier as well as their own.  A halo
// stage holds the block's two tiles (one producer warp), the weights have
// their own producer warp, and the shared memory freed deepens the halo
// ring.  A cluster's last item may have tiles past the last instance: their
// halos are not loaded and their rows not stored, while their block still
// loads its half of every weight stage.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrives on the barrier at the same offset in block `cta` of the cluster,
// with the default (CTA-scoped) release: what it orders is the consumer's
// reads of a stage, which its wgmma wait has already completed.
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// A 2-D box into the same offset of every block in `mask`, each block's
// barrier at `bar`'s offset counting its bytes.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, int c0,
                                                      int c1, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

constexpr int P_BN = 256;

// Shared memory of the paired kernel, from a 1024-byte aligned base: the
// halo ring (a_stages x two tiles), the weight ring (b_stages x 256 x 64
// bytes), each warpgroup's 64 staging rows, the barriers and the tap table.
template <int STORE>
__host__ __device__ inline int pair_smem_bytes(const Tiling& t) {
  return 1024 + t.a_stages * a_stage_bytes<2>(t) + t.b_stages * P_BN * W_BK +
         2 * 64 * staging_row<P_BN, STORE>() + (4 * W_MAX_STAGES) * 8 + W_MAX_TAPS * 4;
}

// Work item i (of t.items, walked by clusters): column tile i % col_tiles;
// block r of the cluster takes spatial tiles 2 (CL (i / col_tiles) + r) + wg.
template <int STORE, int CL>
__global__ void __launch_bounds__(W_THREADS, 1)
    qconv_wgmma_pair_kernel(const __grid_constant__ ActMaps act,
                            const __grid_constant__ CUtensorMap wgt,
                            const float* __restrict__ scale, void* __restrict__ out, Tiling t,
                            Sums sums) {
  constexpr int BN = P_BN;
  constexpr int B_BYTES = BN * W_BK;
  constexpr int B_PART = B_BYTES / CL;  // the rows of a stage this block loads
  constexpr int SROW = staging_row<BN, STORE>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int A_BYTES = a_stage_bytes<2>(t);
  const int taps = t.KH * t.KW;
  const int tile_bytes = t.n_par * 4 * t.plane;
  uint8_t* ring_a = base;
  uint8_t* ring_b = ring_a + t.a_stages * A_BYTES;
  uint8_t* staging = ring_b + t.b_stages * B_BYTES;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(staging + 2 * 64 * SROW);
  uint64_t* a_empty = a_full + W_MAX_STAGES;
  uint64_t* b_full = a_empty + W_MAX_STAGES;
  uint64_t* b_empty = b_full + W_MAX_STAGES;
  uint32_t* tap_offset = reinterpret_cast<uint32_t*>(b_empty + W_MAX_STAGES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_MAX_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 8);        // every consumer warp of the block
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 8 * CL);   // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < taps) {
    const int ky = threadIdx.x / t.KW, kx = threadIdx.x - ky * t.KW;
    int py, hy, px, hx;
    tap_axis(ky - t.pad_top, t.stride, t.q0y, py, hy);
    tap_axis(kx - t.pad_left, t.stride, t.q0x, px, hx);
    tap_offset[threadIdx.x] = parity_index(t, py, px) * 4 * t.plane + (hy * t.BW + hx) * 16;
  }
  __syncthreads();
  if (CL > 1) cluster_sync();  // the peer's barriers are initialised

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {  // the halos
      const uint32_t tile_tx = t.n_par * 4 * t.BH * t.BW * 16;
      int it = 0;
      for (int item = cluster; item < t.items; item += clusters) {
        const int st0 = 2 * (CL * (item / t.col_tiles) + static_cast<int>(rank));
        const int valid = min(2, max(0, t.spatial - st0));
        for (int c = 0; c < t.cin_chunks; ++c, ++it) {
          const int s = it % t.a_stages;
          mbar_wait(&a_empty[s], ((it / t.a_stages) & 1) ^ 1);
          mbar_expect_tx(&a_full[s], valid * tile_tx);
          for (int m = 0; m < valid; ++m) {
            const TileAt at = tile_at(t, st0 + m);
            uint8_t* dst = ring_a + s * A_BYTES + m * tile_bytes;
            for (int py = 0; py < 2; ++py) {
              if (!((t.par_y >> py) & 1)) continue;
              for (int px = 0; px < 2; ++px) {
                if (!((t.par_x >> px) & 1)) continue;
                const CUtensorMap* map = &act.m[py * 2 + px];
                uint8_t* pdst = dst + parity_index(t, py, px) * 4 * t.plane;
                for (int j = 0; j < 4; ++j)
                  tma_load_4d(pdst + j * t.plane, map, c * W_BK + 16 * j, at.ox0 + t.q0x,
                              at.oy0 + t.q0y, at.n, &a_full[s]);
              }
            }
          }
        }
      }
    } else if (warp == 9 && lane == 0) {  // the weights
      int it = 0;
      for (int item = cluster; item < t.items; item += clusters) {
        const int col = item % t.col_tiles;
        for (int c = 0; c < t.cin_chunks; ++c)
          for (int tap = 0; tap < taps; ++tap, ++it) {
            const int s = it % t.b_stages;
            mbar_wait(&b_empty[s], ((it / t.b_stages) & 1) ^ 1);
            mbar_expect_tx(&b_full[s], B_BYTES);
            const int k = (tap * t.cin_chunks + c) * W_BK;
            if (CL == 1)
              tma_load_2d(ring_b + s * B_BYTES, &wgt, k, col * BN, &b_full[s]);
            else
              tma_load_2d_multicast(ring_b + s * B_BYTES + rank * B_PART, &wgt, k,
                                    col * BN + static_cast<int>(rank) * (BN / CL), &b_full[s],
                                    static_cast<uint16_t>((1 << CL) - 1));
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;
    uint8_t* my_staging = staging + wg * 64 * SROW;
    const uint32_t lbo = t.plane, sbo = t.BW * 16;
    int acc[BN / 2];
    int a_it = 0, b_it = 0;
    // Releases weight stage s in every block of the cluster: lane r of
    // each consumer warp arrives in block r.
    auto release_b = [&](int s) {
      if (CL == 1)
        mbar_arrive(&b_empty[s]);
      else
        mbar_arrive_cta(&b_empty[s], lane);
    };
    for (int item = cluster; item < t.items; item += clusters) {
      const int col = item % t.col_tiles;
      const int st = 2 * (CL * (item / t.col_tiles) + static_cast<int>(rank)) + wg;
      int prev_a = -1, prev_b = -1;  // stages the group in flight still reads
      for (int c = 0; c < t.cin_chunks; ++c) {
        const int sa = a_it % t.a_stages;
        mbar_wait(&a_full[sa], (a_it / t.a_stages) & 1);
        ++a_it;
        const uint32_t halo = smem_u32(ring_a + sa * A_BYTES + wg * tile_bytes);
        for (int tap = 0; tap < taps; ++tap) {
          const int sb = b_it % t.b_stages;
          mbar_wait(&b_full[sb], (b_it / t.b_stages) & 1);
          ++b_it;
          const uint64_t da = desc_plain(halo + tap_offset[tap], lbo, sbo);
          const uint64_t db = desc_sw64(smem_u32(ring_b + sb * B_BYTES));
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          wgmma_k32<BN>(acc, da, db, !(c == 0 && tap == 0));
          wgmma_k32<BN>(acc, da + ((2 * lbo) >> 4), db + 2, 1);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (prev_b >= 0 && lane < CL) release_b(prev_b);
          if (prev_a >= 0 && lane == 0) mbar_arrive(&a_empty[prev_a]);
          prev_b = sb;
          prev_a = tap == taps - 1 ? sa : -1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane < CL) release_b(prev_b);
      if (prev_a >= 0 && lane == 0) mbar_arrive(&a_empty[prev_a]);
      store_tile<BN, STORE>(acc, t, tile_at(t, st), st, col * BN, scale, out, sums, my_staging,
                            wg);
    }
  }
  if (CL > 1) {  // no block leaves while its peer may still arrive on its barriers
    __syncwarp();
    cluster_sync();
  }
}

// ---------------------------------------------------------- the gather path

constexpr int BM = 128;          // output pixels per block
constexpr int BK = 64;           // depth per shared-memory stage
constexpr int LDS = BK + 16;     // bytes between shared-memory rows
constexpr int THREADS = 256;

struct Shape {
  int N, H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, OH, OW;
  int M, K;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
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

// BN: output channels per block (64 or 128).  The A tile is gathered in
// 4-byte groups, each inside one tap because Cin % 4 == 0.
template <int BN, int STORE>
__global__ void __launch_bounds__(256) qconv_gather_kernel(const int8_t* __restrict__ act,
                                                           const int8_t* __restrict__ wgt,
                                                           const float* __restrict__ scale,
                                                           void* __restrict__ out, Shape sh) {
  constexpr int WARPS_N = BN / 32;            // warps along the channels
  constexpr int WARPS_M = 8 / WARPS_N;        // warps along the pixels
  constexpr int WM = BM / WARPS_M;            // pixels per warp
  constexpr int MI = WM / 16;                 // m16 tiles per warp
  constexpr int NI = 4;                       // n8 tiles per warp (32 channels)
  constexpr int ES = store_bytes<STORE>();
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

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
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
    // Weights: BN rows of 4 chunks of 16 bytes.
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      const int q = tid + THREADS * j;
      const int row = q / 4, chunk = q % 4;
      const int co = n0 + row, kk = k0 + chunk * 16;
      const bool ok = co < sh.Cout && kk < sh.K;
      const int8_t* src = ok ? wgt + static_cast<int64_t>(co) * sh.K + kk : wgt;
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
        if (m >= sh.M) continue;
        const uint32_t v = pack_pair<STORE>(acc[i][j][2 * h], acc[i][j][2 * h + 1], s0, s1);
        uint8_t* dst = static_cast<uint8_t*>(out) + (static_cast<int64_t>(m) * sh.Cout + co) * ES;
        if (ES == 2)
          *reinterpret_cast<uint32_t*>(dst) = v;
        else
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v);
      }
    }
  }
}

template <int BN>
cudaError_t launch_gather(const int8_t* a, const int8_t* w, const float* scale, void* out,
                          const Shape& sh, int store, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>((sh.M + BM - 1) / BM) * ((sh.Cout + BN - 1) / BN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (store == kBf16)
    qconv_gather_kernel<BN, kBf16><<<grid, THREADS, 0, stream>>>(a, w, scale, out, sh);
  else if (store == kF8)
    qconv_gather_kernel<BN, kF8><<<grid, THREADS, 0, stream>>>(a, w, scale, out, sh);
  else
    qconv_gather_kernel<BN, kI8><<<grid, THREADS, 0, stream>>>(a, w, scale, out, sh);
  return cudaGetLastError();
}

// ------------------------------------------------------------- host side

bool encode(EncodeTiled fn, CUtensorMap* map, cuuint32_t rank, const void* base,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// Ring depths for one launch, or false if two halo stages (and min_b
// weight stages) per warpgroup do not fit.
template <int BN, int STORE, int MT, bool WRES, int HALVES>
bool plan_stages(Tiling& t, int min_b) {
  // A halo stage serves every tap of its 64 channels, a weight stage one
  // tap: deepen the weight ring first, then the halo ring.
  t.a_stages = 2;
  t.b_stages = WRES ? 0 : min_b;
  if (smem_bytes<BN, STORE, MT, WRES, HALVES>(t) > W_SMEM) return false;
  auto deepen = [&t](int& depth) {
    while (depth < W_MAX_STAGES) {
      ++depth;
      if (smem_bytes<BN, STORE, MT, WRES, HALVES>(t) > W_SMEM) {
        --depth;
        break;
      }
    }
  };
  if (!WRES) deepen(t.b_stages);
  deepen(t.a_stages);
  return true;
}

// `t` comes with its rings planned by plan_stages.
template <int BN, int STORE, int MT, bool WRES, int HALVES>
cudaError_t launch_wgmma_kernel(const ActMaps& maps, const CUtensorMap& wmap, const float* scale,
                                void* out, Tiling t, const Sums& sums, cudaStream_t stream) {
  const int smem = smem_bytes<BN, STORE, MT, WRES, HALVES>(t);
  const int64_t items = (static_cast<int64_t>(t.spatial) + MT - 1) / MT * t.col_tiles;
  if (items > 0x7ffffffe) return cudaErrorInvalidConfiguration;
  t.items = static_cast<int>(items);
  auto kernel = qconv_wgmma_kernel<BN, STORE, MT, WRES, HALVES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (t.items + 1) / 2;
  const int grid = blocks < sm_count() ? blocks : sm_count();
  kernel<<<grid, W_THREADS, smem, stream>>>(maps, wmap, scale, out, t, sums);
  if (sums.run != nullptr) *sums.run = MT;
  return cudaGetLastError();
}

// The configuration, first that fits: MT = 256 / BN tiles per warpgroup (as
// many as 128 accumulator registers hold) with the weights resident, the
// epilogue in one pass, then in two (a smaller staging tile); MT tiles with
// at least four weight stages; one tile with the weights resident; one tile
// with the weights streamed (the four parity halos of a stride-2 tap are
// large).  Resident weights need the conv to have one column tile.
template <int BN, int STORE>
cudaError_t launch_wgmma_plan(const ActMaps& maps, const CUtensorMap& wmap, const float* scale,
                              void* out, const Tiling& t, const Sums& sums, cudaStream_t stream) {
  constexpr int MT = 256 / BN;
  Tiling p = t;
  const bool one_col = t.col_tiles == 1;
  if constexpr (MT > 1) {
    if (one_col && plan_stages<BN, STORE, MT, true, 1>(p, 0))
      return launch_wgmma_kernel<BN, STORE, MT, true, 1>(maps, wmap, scale, out, p, sums, stream);
    if (one_col && plan_stages<BN, STORE, MT, true, 2>(p, 0))
      return launch_wgmma_kernel<BN, STORE, MT, true, 2>(maps, wmap, scale, out, p, sums, stream);
    if (plan_stages<BN, STORE, MT, false, 1>(p, 4))
      return launch_wgmma_kernel<BN, STORE, MT, false, 1>(maps, wmap, scale, out, p, sums, stream);
  }
  if (one_col && plan_stages<BN, STORE, 1, true, 1>(p, 0))
    return launch_wgmma_kernel<BN, STORE, 1, true, 1>(maps, wmap, scale, out, p, sums, stream);
  if (plan_stages<BN, STORE, 1, false, 1>(p, 2))
    return launch_wgmma_kernel<BN, STORE, 1, false, 1>(maps, wmap, scale, out, p, sums, stream);
  return cudaErrorInvalidConfiguration;
}

// Ring depths of the paired kernel, or false if two halo and four weight
// stages do not fit: a third halo stage first, then weight stages, then
// more halo stages.
template <int STORE>
bool plan_pair_stages(Tiling& t) {
  t.a_stages = 2;
  t.b_stages = 4;
  if (pair_smem_bytes<STORE>(t) > W_SMEM) return false;
  auto deepen = [&t](int& depth, int limit) {
    while (depth < limit) {
      ++depth;
      if (pair_smem_bytes<STORE>(t) > W_SMEM) {
        --depth;
        break;
      }
    }
  };
  deepen(t.a_stages, 3);
  deepen(t.b_stages, W_MAX_STAGES);
  deepen(t.a_stages, W_MAX_STAGES);
  return true;
}

// `wmap`'s box is 256 / CL rows of the weights.  The grid is as many
// clusters as the card holds at once, or fewer where there are fewer items.
template <int STORE, int CL>
cudaError_t launch_pair(const ActMaps& maps, const CUtensorMap& wmap, const float* scale,
                        void* out, Tiling t, const Sums& sums, cudaStream_t stream) {
  if (!plan_pair_stages<STORE>(t)) return cudaErrorInvalidConfiguration;
  const int smem = pair_smem_bytes<STORE>(t);
  const int64_t items = (static_cast<int64_t>(t.spatial) + 2 * CL - 1) / (2 * CL) * t.col_tiles;
  if (items > 0x7ffffffe) return cudaErrorInvalidConfiguration;
  t.items = static_cast<int>(items);
  auto kernel = qconv_wgmma_pair_kernel<STORE, CL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = sm_count() / CL;
  if (CL > 1) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  if (clusters > t.items) clusters = t.items;
  cfg.gridDim = dim3(CL * clusters);
  err = cudaLaunchKernelEx(&cfg, kernel, maps, wmap, scale, out, t, sums);
  if (err != cudaSuccess) return err;
  if (sums.run != nullptr) *sums.run = 1;
  return cudaGetLastError();
}

// Which path runs a conv.  Where the column tile is 256 channels and the
// conv's weights do not stay resident in one block (one column tile that
// fits beside the rings, as at layer 3's 1x1/2), the paired kernel: with
// 2-block clusters at the stride-2 3x3 convs, whose four parity halos leave
// the shallowest rings, in single blocks elsewhere (each measured the faster
// there on r18's shapes; PERF.md).  Elsewhere the plan above.  `wmap_half`
// is the weights' map with boxes of 128 rows.
template <int BN, int STORE>
cudaError_t launch_wgmma_store(const ActMaps& maps, const CUtensorMap& wmap,
                               const CUtensorMap& wmap_half, const float* scale, void* out,
                               const Tiling& t, const Sums& sums, cudaStream_t stream) {
  if constexpr (BN == P_BN) {
    Tiling p = t;
    if (!(t.col_tiles == 1 && plan_stages<BN, STORE, 1, true, 1>(p, 0))) {
      if (t.stride == 2 && t.KH > 1)
        return launch_pair<STORE, 2>(maps, wmap_half, scale, out, t, sums, stream);
      return launch_pair<STORE, 1>(maps, wmap, scale, out, t, sums, stream);
    }
  }
  return launch_wgmma_plan<BN, STORE>(maps, wmap, scale, out, t, sums, stream);
}

template <int BN>
cudaError_t launch_wgmma_bn(const ActMaps& maps, const CUtensorMap& wmap,
                            const CUtensorMap& wmap_half, const float* scale, void* out,
                            const Tiling& t, int store, const Sums& sums, cudaStream_t stream) {
  if (store == kBf16)
    return launch_wgmma_store<BN, kBf16>(maps, wmap, wmap_half, scale, out, t, sums, stream);
  if (store == kF8)
    return launch_wgmma_store<BN, kF8>(maps, wmap, wmap_half, scale, out, t, sums, stream);
  return launch_wgmma_store<BN, kI8>(maps, wmap, wmap_half, scale, out, t, sums, stream);
}

// The halo along one axis: the first and last index (relative to the
// tile's first output) that a tap reads in a parity view, and the parities
// read.
void halo_axis(int k, int pad, int s, int* q0, int* extent, int* parities) {
  int lo = 0, hi = 0;
  *parities = 0;
  for (int i = 0; i < k; ++i) {
    const int o = i - pad, p = ((o % s) + s) % s, qq = floor_div(o - p, s);
    if (i == 0 || qq < lo) lo = qq;
    if (i == 0 || qq > hi) hi = qq;
    *parities |= 1 << p;
  }
  *q0 = lo;
  *extent = W_T + hi - lo;
}

// The wgmma path: tensor maps over the activations (one per parity read)
// and the weights, the tiling, then the launch.
cudaError_t launch_wgmma(const int8_t* act, const int8_t* wgt, const float* scale, void* out,
                         const Shape& sh, int store, const Sums& sums, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  Tiling t;
  t.N = sh.N, t.OH = sh.OH, t.OW = sh.OW, t.Cout = sh.Cout;
  t.KH = sh.KH, t.KW = sh.KW, t.stride = sh.stride, t.pad_top = sh.pad_top,
  t.pad_left = sh.pad_left, t.cin_chunks = sh.Cin / W_BK;
  halo_axis(sh.KH, sh.pad_top, sh.stride, &t.q0y, &t.BH, &t.par_y);
  halo_axis(sh.KW, sh.pad_left, sh.stride, &t.q0x, &t.BW, &t.par_x);
  t.n_par = __builtin_popcount(t.par_y) * __builtin_popcount(t.par_x);
  t.plane = (t.BH * t.BW * 16 + 127) / 128 * 128;
  t.tiles_x = ceil_div(sh.OW, W_T);
  t.tiles_y = ceil_div(sh.OH, W_T);
  const int BN = sh.Cout % 256 == 0 ? 256 : (sh.Cout % 128 == 0 ? 128 : 64);
  t.col_tiles = sh.Cout / BN;
  const int64_t spatial = static_cast<int64_t>(sh.N) * t.tiles_y * t.tiles_x;
  if (spatial * t.col_tiles > 0x7ffffffe || t.BH > 256 || t.BW > 256)
    return cudaErrorInvalidConfiguration;
  t.spatial = static_cast<int>(spatial);
  t.items = t.a_stages = t.b_stages = 0;

  ActMaps maps = {};
  const int s = sh.stride;
  const cuuint32_t abox[4] = {16, static_cast<cuuint32_t>(t.BW), static_cast<cuuint32_t>(t.BH), 1};
  for (int py = 0; py < s; ++py)
    for (int px = 0; px < s; ++px) {
      if (!((t.par_y >> py) & 1) || !((t.par_x >> px) & 1)) continue;
      const cuuint64_t dims[4] = {static_cast<cuuint64_t>(sh.Cin),
                                  static_cast<cuuint64_t>(ceil_div(sh.W - px, s)),
                                  static_cast<cuuint64_t>(ceil_div(sh.H - py, s)),
                                  static_cast<cuuint64_t>(sh.N)};
      const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s) * sh.Cin,
                                     static_cast<cuuint64_t>(s) * sh.W * sh.Cin,
                                     static_cast<cuuint64_t>(sh.H) * sh.W * sh.Cin};
      const int8_t* origin = act + (static_cast<int64_t>(py) * sh.W + px) * sh.Cin;
      if (!encode(fn, &maps.m[py * 2 + px], 4, origin, dims, strides, abox,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorInvalidValue;
    }
  CUtensorMap wmap, wmap_half;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(sh.K), static_cast<cuuint64_t>(sh.Cout)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(sh.K)};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(W_BK), static_cast<cuuint32_t>(BN)};
  const cuuint32_t wbox_half[2] = {static_cast<cuuint32_t>(W_BK), static_cast<cuuint32_t>(BN / 2)};
  if (!encode(fn, &wmap, 2, wgt, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(fn, &wmap_half, 2, wgt, wdims, wstrides, wbox_half, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;

  if (BN == 256)
    return launch_wgmma_bn<256>(maps, wmap, wmap_half, scale, out, t, store, sums, stream);
  if (BN == 128)
    return launch_wgmma_bn<128>(maps, wmap, wmap_half, scale, out, t, store, sums, stream);
  return launch_wgmma_bn<64>(maps, wmap, wmap_half, scale, out, t, store, sums, stream);
}

// Whether a conv takes the wgmma path.
bool wgmma_takes(int Cin, int KH, int KW, int stride, int H, int W) {
  return Cin % W_BK == 0 && KH * KW <= W_MAX_TAPS &&
         (stride == 1 || (stride == 2 && H >= 2 && W >= 2));
}

}  // namespace

extern "C" {

// act (N, H, W, Cin) int8; wgt (Cout, KH, KW, Cin) int8; scale (Cout,) f32
// (the dequant scale s, or s / t for the int8 store); out (N, OH, OW, Cout)
// in the store's dtype (0 bf16, 1 float8_e4m3fn, 2 int8).  Padding is given
// at the top and left; the bottom and right follow from OH and OW.  Needs
// Cin % 4 == 0, Cout % 64 == 0 and KH * KW * Cin % 16 == 0.  Convs with
// Cin % 64 == 0, stride 1 or 2 (and H, W >= 2 at stride 2) take the wgmma
// path, the rest the gather path.  Returns the cudaError_t of the launch
// (0 = success).
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
  const Sums none = {nullptr, nullptr, nullptr, nullptr, nullptr};
  cudaError_t err;
  if (wgmma_takes(Cin, KH, KW, stride, H, W))
    err = launch_wgmma(act, wgt, scale, out, sh, store, none, s);
  else if (Cout % 128 == 0)
    err = launch_gather<128>(act, wgt, scale, out, sh, store, s);
  else
    err = launch_gather<64>(act, wgt, scale, out, sh, store, s);
  return static_cast<int>(err);
}

// qconv_i8 on the wgmma path (refused elsewhere) with K7's sums of the
// stored output: part (N * ceil(OH / 8) * ceil(OW / 8), Cout) pairs of
// float64 for bn_stats_fold, one slot per 8 x 8 tile in (n, tile row, tile
// column) order, of which those that end a run hold the run's sums: *run
// (written here) consecutive tiles of one instance are summed together, a
// run ending at tile t where (t + 1) % *run == 0 or t is the instance's
// last.  Where the map is one tile (OH, OW <= 8), s1 and s2 (N, Cout) f32
// instead, and part may be null.  tq (Cout,) is the int8 store's read-back
// scale (null for bf16 and f8).
int qconv_i8_stats(const int8_t* act, const int8_t* wgt, const float* scale, void* out, int N,
                   int H, int W, int Cin, int Cout, int KH, int KW, int stride, int pad_top,
                   int pad_left, int OH, int OW, int store, const float* tq, double* part,
                   float* s1, float* s2, int* run, void* stream) {
  const int64_t M = static_cast<int64_t>(N) * OH * OW;
  if (M == 0 || Cout == 0) return static_cast<int>(cudaSuccess);
  const bool one_tile = OH <= W_T && OW <= W_T;
  if (M > 0x7fffffff || Cout % 64 || store < 0 || store > 2 || (store == kI8) != (tq != nullptr) ||
      !wgmma_takes(Cin, KH, KW, stride, H, W) ||
      (one_tile ? s1 == nullptr || s2 == nullptr : part == nullptr) || run == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{N, H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, OH, OW,
                 static_cast<int>(M), KH * KW * Cin};
  const Sums sums = {one_tile ? nullptr : reinterpret_cast<double2*>(part),
                     one_tile ? s1 : nullptr, one_tile ? s2 : nullptr, tq, run};
  return static_cast<int>(
      launch_wgmma(act, wgt, scale, out, sh, store, sums, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
