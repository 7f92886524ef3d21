// Tile rasterizer: max-combine of barycentric values over each tile's
// candidate triangles, for one view with the binning on the device
// (raster_mesh) or for B views of one triangle set after a binning in
// torch (raster_tiles_batch).
//
// Replaces: flame_tpu/ops/pallas_raster.py::_kernel, driven by rasterize
// (grid (nty, ntx)) and by rasterize_batch (grid (B, nty, ntx), the
// per-frame dense maps of pipeline.batch_step). The wrappers are
// flame_tpu_torch/ops/raster_kernel.py; the plain versions
// (ops/rasterize.py: bin_rows + eval_tiles, tile_candidates_batch +
// eval_tiles_batch) are the references these kernels are checked against.
// Triangle setup stays plain torch (rasterize._packed_rows), as it was XLA
// outside the TPU kernel.
//
// Triangle rows are 16 floats
// [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | v0 v1 v2 | inv_area | valid | 0 0]
// with c in image coordinates. Output: the (nty*tile_h, ntx*128) grid,
// -3e38 where no triangle covers the pixel (the wrapper crops and writes
// NaN there).
//
// Edge function k at pixel (x, y) is a_k*x + b_k*y + c_k, evaluated in
// that form. Vertex coordinates were truncated to integers, so a, b, c
// and every product and sum here are integers below 2^24 for images
// under 2048 px: the inside test (all three >= 0) is exact in fp32 and
// agrees with the plain version bit for bit.
//
// raster_mesh, one CTA of 512 threads per 32x128 tile, in one launch:
//   1. binning: the CTA scans the triangles from T-1 down, 8 per thread in
//      flight, tests bbox overlap with the tile and `valid`, and compacts
//      the hits with a warp ballot and a block prefix sum; the first K1
//      hits (the K1 highest overlapping indices, the set the TPU kernel's
//      top_k keeps) go to shared memory, and the count goes on past K1 to
//      the largest per-tile count (atomicMax);
//   2. staging: the kept rows' coefficients, inv_area-scaled values and
//      bboxes into shared memory;
//   3. the tile pass: 128 columns x 4 row groups of 8 rows; each warp
//      keeps, with a ballot over 32 candidates at a time, only those whose
//      bbox (widened by a pixel) meets its 32 columns and 8 rows, and
//      evaluates them only on the rows inside their bbox. A pixel that
//      passes the inside test lies in the triangle's bbox, and max-combine
//      does not depend on candidate order, so the map is the plain
//      version's.
// What bounds it on an H100: at VGA (75 tiles, T ~ 8,200, K1 = 160) the
// work is a few MFLOP and 2 MB, microseconds of either; the latency of the
// scan (T bboxes per CTA from L2) and of the candidate loop bound it, on
// 75 of the 132 SMs. The design keeps every intermediate in shared memory
// and registers (no candidate tensor in device memory, no torch launches
// for the binning) and clips each candidate to its bbox.
//
// raster_tiles_batch (K2b) takes per-tile candidates already binned in
// torch, (B, nty, ntx, K1, 16): one CTA of 128 threads per tile and view
// (view on blockIdx.z), the tile's rows staged in shared memory, one
// thread per pixel column keeping its 32 running maxima in registers and
// evaluating every candidate at every row. Next step: K2's device binning
// and bbox clipping.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;
constexpr int kMaxTileH = 32;
constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// raster_mesh's shape.
constexpr int kMeshThreads = 512;
constexpr int kMeshWarps = kMeshThreads / 32;
constexpr int kRowGroups = kMeshThreads / kTileW;  // 4
constexpr int kMaxGroupRows = kMaxTileH / kRowGroups;  // 8
constexpr int kScanBatch = 8;  // triangles per thread per scan step
constexpr int kCoef = 12;      // staged a0..c2 and the three scaled values

// Shared memory of raster_mesh for k1 candidates: 12 coefficients, the
// bbox as four arrays, and the triangle index.
size_t mesh_smem(int k1) {
  return static_cast<size_t>(k1) * (kCoef + 4 + 1) * sizeof(float);
}

__global__ void __launch_bounds__(kMeshThreads)
    raster_mesh_kernel(const float* __restrict__ packed,
                       const float4* __restrict__ bbox, int T,
                       float* __restrict__ out, int* __restrict__ max_count,
                       int ntx, int k1, int tile_h) {
  extern __shared__ float smem[];
  float* coef = smem;                 // (k1, 12)
  float* bx0 = coef + k1 * kCoef;     // (k1,) xmin
  float* bx1 = bx0 + k1;              // xmax
  float* by0 = bx1 + k1;              // ymin
  float* by1 = by0 + k1;              // ymax
  int* idx = reinterpret_cast<int*>(by1 + k1);  // (k1,) triangle index
  __shared__ int wcount[2][kMeshWarps];

  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The tile's pixel range, in floats as the plain binning compares.
  const float ox = static_cast<float>(tx * kTileW);
  const float oy = static_cast<float>(ty * tile_h);
  const float ox1 = ox + static_cast<float>(kTileW - 1);
  const float oy1 = oy + static_cast<float>(tile_h - 1);

  // 1. Binning, from the highest triangle index down.
  int total = 0, round = 0;
  for (int base = 0; base < T; base += kScanBatch * kMeshThreads) {
    bool hit[kScanBatch];
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) {
      const int t = T - 1 - (base + m * kMeshThreads + threadIdx.x);
      hit[m] = false;
      if (t >= 0) {
        const float4 b = bbox[t];  // xmin xmax ymin ymax
        hit[m] = b.x <= ox1 && b.y >= ox && b.z <= oy1 && b.w >= oy;
      }
    }
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) {
      const int t = T - 1 - (base + m * kMeshThreads + threadIdx.x);
      if (hit[m]) hit[m] = packed[static_cast<size_t>(t) * 16 + 13] > 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m, ++round) {
      const int t = T - 1 - (base + m * kMeshThreads + threadIdx.x);
      const unsigned ballot = __ballot_sync(kFull, hit[m]);
      int* wc = wcount[round & 1];  // two buffers: one barrier per round
      if (lane == 0) wc[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, all = 0;
#pragma unroll
      for (int w = 0; w < kMeshWarps; ++w) {
        const int c = wc[w];
        before += w < warp ? c : 0;
        all += c;
      }
      const int rank =
          total + before + __popc(ballot & ((1u << lane) - 1u));
      if (hit[m] && rank < k1) idx[rank] = t;
      total += all;
    }
  }
  if (threadIdx.x == 0) atomicMax(max_count, total);
  const int n = total < k1 ? total : k1;
  __syncthreads();

  // 2. Stage the kept rows.
  for (int k = threadIdx.x; k < n; k += kMeshThreads) {
    const int t = idx[k];
    const float4* row = reinterpret_cast<const float4*>(packed) +
                        static_cast<size_t>(t) * 4;
    const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
    float* c = coef + k * kCoef;
    c[0] = r0.x;  // a0 a1 a2
    c[1] = r0.y;
    c[2] = r0.z;
    c[3] = r0.w;  // b0 b1 b2
    c[4] = r1.x;
    c[5] = r1.y;
    c[6] = r1.z;  // c0 c1 c2
    c[7] = r1.w;
    c[8] = r2.x;
    c[9] = r2.y * r3.x;  // v_k * inv_area
    c[10] = r2.z * r3.x;
    c[11] = r2.w * r3.x;
    const float4 b = bbox[t];
    bx0[k] = b.x;
    bx1[k] = b.y;
    by0[k] = b.z;
    by1[k] = b.w;
  }
  __syncthreads();

  // 3. The tile pass: my column, my row group of rpg rows.
  const int col = threadIdx.x % kTileW;
  const int rg = threadIdx.x / kTileW;
  const int rpg = (tile_h + kRowGroups - 1) / kRowGroups;
  const float x = ox + static_cast<float>(col);
  const float gy0 = oy + static_cast<float>(rg * rpg);
  const float gy1 = gy0 + static_cast<float>(rpg - 1);
  const float wx0 = ox + static_cast<float>(col & ~31);  // the warp's columns
  const float wx1 = wx0 + 31.0f;
  float best[kMaxGroupRows];
#pragma unroll
  for (int i = 0; i < kMaxGroupRows; ++i) best[i] = kNeg;

  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const bool mine = k < n && bx0[k] - 1.0f <= wx1 && bx1[k] + 1.0f >= wx0 &&
                      by0[k] - 1.0f <= gy1 && by1[k] + 1.0f >= gy0;
    unsigned todo = __ballot_sync(kFull, mine);
    while (todo != 0u) {  // the same candidates for the whole warp
      const int kk = base + __ffs(todo) - 1;
      todo &= todo - 1u;
      const float* r = coef + kk * kCoef;
      const float ylo = by0[kk] - 1.0f, yhi = by1[kk] + 1.0f;
#pragma unroll
      for (int i = 0; i < kMaxGroupRows; ++i) {
        const float yy = gy0 + static_cast<float>(i);
        if (i < rpg && yy >= ylo && yy <= yhi) {
          const float w0 = r[0] * x + r[3] * yy + r[6];
          const float w1 = r[1] * x + r[4] * yy + r[7];
          const float w2 = r[2] * x + r[5] * yy + r[8];
          if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
            best[i] = fmaxf(best[i], w0 * r[9] + w1 * r[10] + w2 * r[11]);
          }
        }
      }
    }
  }

  const int W = ntx * kTileW;
  float* dst = out + static_cast<size_t>(ty * tile_h + rg * rpg) * W +
               tx * kTileW + col;
#pragma unroll
  for (int i = 0; i < kMaxGroupRows; ++i) {
    if (i < rpg && rg * rpg + i < tile_h) {
      dst[static_cast<size_t>(i) * W] = best[i];
    }
  }
}

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

}  // namespace

// packed (T, 16) triangle rows and bbox (T, 4) [xmin xmax ymin ymax] ->
// out (nty*tile_h, ntx*128); *max_count (zeroed here) the largest number of
// valid triangles overlapping one tile. k1 = min(max_per_tile, T). Both
// inputs 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int raster_mesh(const float* packed, const float* bbox, int T,
                           float* out, int* max_count, int nty, int ntx,
                           int k1, int tile_h, void* stream) {
  if (tile_h < 1 || tile_h > kMaxTileH || T < 0 || k1 < 0 || k1 > T ||
      nty < 1 || ntx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = mesh_smem(k1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_mesh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(max_count, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  raster_mesh_kernel<<<nty * ntx, kMeshThreads, smem, s>>>(
      packed, reinterpret_cast<const float4*>(bbox), T, out, max_count, ntx,
      k1, tile_h);
  return static_cast<int>(cudaGetLastError());
}

// cdata (nviews, nty, ntx, k1, 16) -> out (nviews, nty*tile_h, ntx*128).
extern "C" int raster_tiles_batch(const float* cdata, float* out,
                                  int nviews, int nty, int ntx, int k1,
                                  int tile_h, void* stream) {
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
