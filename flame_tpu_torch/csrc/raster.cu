// Tile rasterizer: max-combine of barycentric values over each tile's
// candidate triangles, with the binning on the device, for one view
// (raster_mesh) or for B views of one triangle set (raster_mesh_batch).
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
// with c in image coordinates. Output: the (nty*tile_h, ntx*128) grid per
// view, -3e38 where no triangle covers the pixel (the wrapper crops and
// writes NaN there).
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
// raster_mesh_batch (K2b), B views of one triangle set in one launch: one
// CTA per (tile, view), view on blockIdx.z, the views of a tile in a
// thread-block cluster of C CTAs (C the largest divisor of B up to 8;
// B > 8 takes several clusters per tile, each binning once).
//   1. binning, once per cluster for all its views: each triangle's bbox
//      is the union of its bboxes over the views where it is valid, formed
//      in the scan from the B rows' valid flags and bboxes (measured
//      cheaper than four torch reductions before the launch; a triangle
//      valid in no view has an empty union and meets no tile); the
//      cluster splits [0, T) into C shares from the top, CTA c scans share
//      c with raster_mesh's scan (scan_hits), keeping its first K1 hits
//      and counting on; after a cluster barrier every CTA reads the
//      shares' counts and lists through distributed shared memory: the
//      first K1 of their concatenation in share order are the K1 highest
//      overlapping indices, the set the TPU kernel's top_k keeps, and
//      their sum is the tile's union count;
//   2. staging: each CTA stages its own view's rows of those candidates;
//      a candidate invalid in that view gets an empty bbox (the plain
//      version drops it through its `valid` field); a second cluster
//      barrier keeps every list alive until all CTAs have read it;
//   3. raster_mesh's tile pass (tile_pass), clipped to each candidate's
//      bbox in that view, into that view's grid.
// No (B, nty, ntx, K1, 16) candidate tensor exists: at B = 8, VGA and
// K1 = 192 the simple form wrote and read back 7.4 MB of it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileW = 128;
constexpr int kMaxTileH = 32;
constexpr float kNeg = -3.0e38f;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMeshThreads = 512;
constexpr int kMeshWarps = kMeshThreads / 32;
constexpr int kRowGroups = kMeshThreads / kTileW;  // 4
constexpr int kMaxGroupRows = kMaxTileH / kRowGroups;  // 8
constexpr int kScanBatch = 8;  // triangles per thread per scan step
constexpr int kCoef = 12;      // staged a0..c2 and the three scaled values
constexpr int kMaxViewCluster = 8;  // views of a tile in one cluster

// Shared memory of either kernel for k1 candidates: 12 coefficients, the
// bbox as four arrays, and the triangle index.
size_t mesh_smem(int k1) {
  return static_cast<size_t>(k1) * (kCoef + 4 + 1) * sizeof(float);
}

struct Staging {
  float* coef;  // (k1, 12)
  float* bx0;   // (k1,) xmin
  float* bx1;   // xmax
  float* by0;   // ymin
  float* by1;   // ymax
  int* idx;     // (k1,) triangle index
};

__device__ __forceinline__ Staging staging(float* smem, int k1) {
  Staging st;
  st.coef = smem;
  st.bx0 = st.coef + k1 * kCoef;
  st.bx1 = st.bx0 + k1;
  st.by0 = st.bx1 + k1;
  st.by1 = st.by0 + k1;
  st.idx = reinterpret_cast<int*>(st.by1 + k1);
  return st;
}

// Binning of triangles top-1 down to top-len by the whole CTA: box(t) is
// the bbox test (its loads for 8 triangles per thread issued together),
// keep(t) a second test of the hits. The first k1 hits in descending
// index go to idx; returns the number of hits.
template <class Box, class Keep>
__device__ __forceinline__ int scan_hits(int top, int len, int k1, int* idx,
                                         int (*wcount)[kMeshWarps], Box box,
                                         Keep keep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0, round = 0;
  for (int base = 0; base < len; base += kScanBatch * kMeshThreads) {
    bool hit[kScanBatch];
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) {
      const int i = base + m * kMeshThreads + threadIdx.x;
      hit[m] = i < len && box(top - 1 - i);
    }
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) {
      if (hit[m]) {
        hit[m] = keep(top - 1 - (base + m * kMeshThreads + threadIdx.x));
      }
    }
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) {
      if (base + m * kMeshThreads >= len) break;  // the same for the block
      const int t = top - 1 - (base + m * kMeshThreads + threadIdx.x);
      const unsigned ballot = __ballot_sync(kFull, hit[m]);
      int* wc = wcount[round++ & 1];  // two buffers: one barrier per round
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
  return total;
}

// Stage a triangle's row and bbox as candidate k; a row that says invalid
// gets an empty bbox, which no warp's clip meets.
__device__ __forceinline__ void stage(const Staging& st, int k,
                                      const float4* row, float4 b) {
  const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
  float* c = st.coef + k * kCoef;
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
  if (!(r3.y > 0.0f)) b = make_float4(kBig, -kBig, kBig, -kBig);
  st.bx0[k] = b.x;
  st.bx1[k] = b.y;
  st.by0[k] = b.z;
  st.by1[k] = b.w;
}

// The tile pass over n staged candidates into the tile at (ox, oy) of the
// W-wide grid out: my column, my row group of rpg rows.
__device__ __forceinline__ void tile_pass(const Staging& st, int n, int ox,
                                          int oy, int tile_h, float* out,
                                          int W) {
  const int lane = threadIdx.x & 31;
  const int col = threadIdx.x % kTileW;
  const int rg = threadIdx.x / kTileW;
  const int rpg = (tile_h + kRowGroups - 1) / kRowGroups;
  const float x = static_cast<float>(ox + col);
  const float gy0 = static_cast<float>(oy + rg * rpg);
  const float gy1 = gy0 + static_cast<float>(rpg - 1);
  const float wx0 = static_cast<float>(ox + (col & ~31));  // warp's columns
  const float wx1 = wx0 + 31.0f;
  float best[kMaxGroupRows];
#pragma unroll
  for (int i = 0; i < kMaxGroupRows; ++i) best[i] = kNeg;

  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const bool mine = k < n && st.bx0[k] - 1.0f <= wx1 &&
                      st.bx1[k] + 1.0f >= wx0 && st.by0[k] - 1.0f <= gy1 &&
                      st.by1[k] + 1.0f >= gy0;
    unsigned todo = __ballot_sync(kFull, mine);
    while (todo != 0u) {  // the same candidates for the whole warp
      const int kk = base + __ffs(todo) - 1;
      todo &= todo - 1u;
      const float* r = st.coef + kk * kCoef;
      const float ylo = st.by0[kk] - 1.0f, yhi = st.by1[kk] + 1.0f;
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

  float* dst = out + static_cast<size_t>(oy + rg * rpg) * W + ox + col;
#pragma unroll
  for (int i = 0; i < kMaxGroupRows; ++i) {
    if (i < rpg && rg * rpg + i < tile_h) {
      dst[static_cast<size_t>(i) * W] = best[i];
    }
  }
}

// K2's scan and tile pass are written out here, not through scan_hits and
// tile_pass: built from those functions, raster_mesh_kernel got 40
// registers and a stack frame from ptxas and ran slower on an H100.
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

// Three CTAs per SM (at most 40 registers): B x 75 CTAs at VGA take two
// waves of the 132 SMs at B = 8, not three.
__global__ void __launch_bounds__(kMeshThreads, 3)
    raster_mesh_batch_kernel(const float* __restrict__ packed,
                             const float4* __restrict__ bbox, int T,
                             float* __restrict__ out,
                             int* __restrict__ max_count, int ntx, int k1,
                             int tile_h) {
  extern __shared__ float smem[];
  const Staging st = staging(smem, k1);
  __shared__ int wcount[2][kMeshWarps];
  __shared__ int found;                  // hits in my share
  __shared__ int kept[kMaxViewCluster];  // hits each share kept
  __shared__ int total;                  // the tile's union count
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tile = blockIdx.x;
  const size_t view = blockIdx.z;
  const int ox = tile % ntx * kTileW, oy = tile / ntx * tile_h;
  const float fx0 = static_cast<float>(ox), fy0 = static_cast<float>(oy);
  const float fx1 = static_cast<float>(ox + kTileW - 1);
  const float fy1 = static_cast<float>(oy + tile_h - 1);

  // 1. Binning of my share of the triangles by their union bboxes:
  // indices [top - len, top).
  const int chunk = (T + C - 1) / C;
  const int top = T - rank * chunk;
  const int len = top < chunk ? (top > 0 ? top : 0) : chunk;
  const int mine = scan_hits(
      top, len, k1, st.idx, wcount,
      [&](int t) {  // the union of t's bboxes over its valid views
        float4 b = make_float4(kBig, -kBig, kBig, -kBig);
        for (int v = 0; v < static_cast<int>(gridDim.z); ++v) {
          const size_t k = static_cast<size_t>(v) * T + t;
          if (packed[k * 16 + 13] > 0.0f) {
            const float4 c = bbox[k];
            b = make_float4(fminf(b.x, c.x), fmaxf(b.y, c.y),
                            fminf(b.z, c.z), fmaxf(b.w, c.w));
          }
        }
        return b.x <= fx1 && b.y >= fx0 && b.z <= fy1 && b.w >= fy0;
      },
      [](int) { return true; });
  if (threadIdx.x == 0) found = mine;
  cluster.sync();  // every share's list and count are in place
  if (threadIdx.x < C) {
    const int c = *cluster.map_shared_rank(&found, threadIdx.x);
    kept[threadIdx.x] = c < k1 ? c : k1;
  }
  if (threadIdx.x == kMeshThreads - 1) {
    int sum = 0;
    for (int q = 0; q < C; ++q) sum += *cluster.map_shared_rank(&found, q);
    total = sum;
    if (rank == 0) atomicMax(max_count, sum);
  }
  __syncthreads();
  const int n = total < k1 ? total : k1;

  // 2. Stage my view's rows of the first n candidates in share order.
  const float4* vrows = reinterpret_cast<const float4*>(packed) + view * T * 4;
  const float4* vbox = bbox + view * T;
  for (int k = threadIdx.x; k < n; k += kMeshThreads) {
    int q = 0, off = k;
    while (off >= kept[q]) off -= kept[q++];
    const int t = cluster.map_shared_rank(st.idx, q)[off];
    stage(st, k, vrows + static_cast<size_t>(t) * 4, vbox[t]);
  }
  cluster.sync();  // no CTA leaves while another reads its list

  // 3. The tile pass into my view's grid.
  const int W = ntx * kTileW;
  const size_t grid_px = static_cast<size_t>(gridDim.x / ntx) * tile_h * W;
  tile_pass(st, n, ox, oy, tile_h, out + view * grid_px, W);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(raster_mesh_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(max_count, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  raster_mesh_kernel<<<nty * ntx, kMeshThreads, smem, s>>>(
      packed, reinterpret_cast<const float4*>(bbox), T, out, max_count, ntx,
      k1, tile_h);
  return static_cast<int>(cudaGetLastError());
}

// B views of one triangle set: packed (B, T, 16) rows and bbox (B, T, 4)
// per view -> out (B, nty*tile_h, ntx*128); *max_count (zeroed here) the
// largest number of union bboxes (each triangle's bboxes over the views
// where it is valid) overlapping one tile. k1 = min(max_per_tile, T).
// Inputs 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int raster_mesh_batch(const float* packed, const float* bbox,
                                 int B, int T, float* out,
                                 int* max_count, int nty, int ntx, int k1,
                                 int tile_h, void* stream) {
  if (tile_h < 1 || tile_h > kMaxTileH || T < 0 || k1 < 0 || k1 > T ||
      nty < 1 || ntx < 1 || B < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int c = kMaxViewCluster < B ? kMaxViewCluster : B;
  while (B % c) --c;  // the largest divisor of B up to 8
  const void* k = reinterpret_cast<const void*>(raster_mesh_batch_kernel);
  const size_t smem = mesh_smem(k1);
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(max_count, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nty * ntx, 1, B);
  cfg.blockDim = dim3(kMeshThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float4* b4 = reinterpret_cast<const float4*>(bbox);
  void* params[] = {&packed, &b4, &T, &out, &max_count, &ntx, &k1, &tile_h};
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
