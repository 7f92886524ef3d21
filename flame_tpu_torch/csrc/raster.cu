// Tile rasterizer: max-combine of barycentric values over each tile's
// candidate triangles, for one view (raster_tiles) or for B views of one
// triangle set (raster_tiles_batch).
//
// Replaces: flame_tpu/ops/pallas_raster.py::_kernel, driven by rasterize
// (grid (nty, ntx)) and by rasterize_batch (grid (B, nty, ntx), the
// per-frame dense maps of pipeline.batch_step). Setup and bbox binning
// stay plain torch (ops/rasterize.py::tile_candidates and
// tile_candidates_batch, the latter one shared binning pass over the
// union of each triangle's per-view bboxes), as they were XLA outside
// the TPU kernel. Binning on the device is queued.
//
// Input: per tile, K1 candidate rows of 16 floats
// [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | v0 v1 v2 | inv_area | valid | 0 0]
// with c in image coordinates; dead slots are all zero (valid 0).
// Output: the (nty*tile_h, ntx*128) grid, -3e38 where no triangle covers
// the pixel (the wrapper crops and writes NaN there).
//
// Edge function k at pixel (x, y) is a_k*x + b_k*y + c_k, evaluated in
// that form. Vertex coordinates were truncated to integers, so a, b, c
// and every product and sum here are integers below 2^24 for images
// under 2048 px: the inside test (all three >= 0) is exact in fp32 and
// agrees with the plain version bit for bit.
//
// What bounds it on an H100: VGA has 15x5 tiles of 32x128 pixels with
// K1 <= 160 candidates each, about 49M edge-function evaluations per
// map -- microseconds of arithmetic, so launch latency and the 75 CTAs
// (fewer than the 132 SMs) bound it. The design: one CTA per tile, the
// tile's K1x16 rows staged once in shared memory (10 KB at K1=160, read
// as broadcasts), one thread per pixel column keeping the 32 running
// maxima of its column in registers, and stores coalesced along x.
// The batched form is the same kernel with the view on blockIdx.z and
// per-view strides into cdata and out: 8 x 75 = 600 CTAs at K1 <= 192,
// each bound by its 192-row candidate loop per pixel row (a thread walks
// every candidate for each of its 32 pixels). Next step: binning on the
// device in the same launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;
constexpr int kMaxTileH = 32;
constexpr float kNeg = -3.0e38f;

__global__ void raster_tiles_kernel(const float* __restrict__ cdata,
                                    float* __restrict__ out, int ntx,
                                    int k1, int tile_h) {
  extern __shared__ float rows[];  // k1 * 16
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int W = ntx * kTileW;
  // View blockIdx.z: its candidates follow the previous views' nty*ntx
  // tiles, its map the previous views' (nty*tile_h) x W grids.
  const size_t view = blockIdx.z;
  const size_t nty = gridDim.x / ntx;
  const float* src = cdata + (view * gridDim.x + tile) * k1 * 16;
  out += view * nty * tile_h * W;
  for (int i = threadIdx.x; i < k1 * 16; i += blockDim.x) rows[i] = src[i];
  __syncthreads();

  const float x = static_cast<float>(tx * kTileW + threadIdx.x);
  const float oy = static_cast<float>(ty * tile_h);
  float best[kMaxTileH];
#pragma unroll
  for (int y = 0; y < kMaxTileH; ++y) best[y] = kNeg;

  for (int k = 0; k < k1; ++k) {
    const float* r = rows + k * 16;
    if (!(r[13] > 0.0f)) continue;
    const float inv_area = r[12];
    const float vv0 = r[9] * inv_area, vv1 = r[10] * inv_area,
                vv2 = r[11] * inv_area;
#pragma unroll
    for (int y = 0; y < kMaxTileH; ++y) {
      if (y < tile_h) {
        const float yy = oy + static_cast<float>(y);
        const float w0 = r[0] * x + r[3] * yy + r[6];
        const float w1 = r[1] * x + r[4] * yy + r[7];
        const float w2 = r[2] * x + r[5] * yy + r[8];
        if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
          best[y] = fmaxf(best[y], w0 * vv0 + w1 * vv1 + w2 * vv2);
        }
      }
    }
  }

  float* dst = out + static_cast<size_t>(ty * tile_h) * W + tx * kTileW +
               threadIdx.x;
#pragma unroll
  for (int y = 0; y < kMaxTileH; ++y) {
    if (y < tile_h) dst[static_cast<size_t>(y) * W] = best[y];
  }
}

int launch(const float* cdata, float* out, int nviews, int nty, int ntx,
           int k1, int tile_h, void* stream) {
  if (tile_h < 1 || tile_h > kMaxTileH || k1 < 1 || nviews < 1 ||
      nviews > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(k1) * 16 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(nty * ntx, 1, nviews);
  raster_tiles_kernel<<<grid, kTileW, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      cdata, out, ntx, k1, tile_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cdata (nty, ntx, k1, 16) -> out (nty*tile_h, ntx*128).
extern "C" int raster_tiles(const float* cdata, float* out, int nty,
                            int ntx, int k1, int tile_h, void* stream) {
  return launch(cdata, out, 1, nty, ntx, k1, tile_h, stream);
}

// cdata (nviews, nty, ntx, k1, 16) -> out (nviews, nty*tile_h, ntx*128).
extern "C" int raster_tiles_batch(const float* cdata, float* out,
                                  int nviews, int nty, int ntx, int k1,
                                  int tile_h, void* stream) {
  return launch(cdata, out, nviews, nty, ntx, k1, tile_h, stream);
}
