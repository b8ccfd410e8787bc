// Single-channel tile gather: image (H, W) + starts (K, 2) -> tiles (K, p, p).
//
// Replaces the TPU kernel `gather_tiles_dma` of
// montecarlo_gated_mil_tpu/ops/patching.py (a DMA ring whose aligned bounce
// windows and static phase branches exist only because Mosaic refuses
// unaligned dynamic offsets; `pad_for_dma_gather` pads the image for them).
// A GPU has no such rule, so this kernel reads the unpadded image directly.
//
// What bounds it: bytes.  Each tile is read once and written once,
// 2 * K * p * p * 4 B (1.23 GB at K=3072, p=224), against 3.35 TB/s.
//
// Design: one block per tile; each warp copies whole rows, neighbouring
// threads on neighbouring pixels, so every load and store is coalesced.  A
// start whose window leaves the image writes a zero tile, as the TPU kernel
// does for a start it cannot serve.  The copy is bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_tiles_kernel(const float* __restrict__ image, int H, int W,
                                    const int64_t* __restrict__ starts, int p,
                                    float* __restrict__ out) {
  const int k = blockIdx.x;
  const int64_t y = starts[2 * k], x = starts[2 * k + 1];
  const bool inside = y >= 0 && x >= 0 && y + p <= H && x + p <= W;
  float* dst = out + (size_t)k * p * p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  if (!inside) {
    for (int i = threadIdx.x; i < p * p; i += blockDim.x) dst[i] = 0.f;
    return;
  }
  for (int r = warp; r < p; r += warps) {
    const float* src = image + (size_t)(y + r) * W + x;
    for (int c = lane; c < p; c += 32) dst[r * p + c] = src[c];
  }
}

}  // namespace

extern "C" {

// image (H, W) float32; starts (K, 2) int64 (y, x); out (K, p, p) float32.
// Returns the cudaError_t of the launch (0 = success).
int gather_tiles(const float* image, int H, int W, const int64_t* starts, int K, int p,
                 float* out, void* stream) {
  if (K == 0) return (int)cudaSuccess;
  gather_tiles_kernel<<<K, 256, 0, static_cast<cudaStream_t>(stream)>>>(image, H, W, starts, p,
                                                                         out);
  return (int)cudaGetLastError();
}

}  // extern "C"
