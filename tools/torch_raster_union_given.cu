// K2b with the union bboxes given: raster_mesh_batch of
// flame_tpu_torch/csrc/raster.cu, except that each triangle's union bbox
// over its valid views is an input (T, 4), formed in torch before the
// launch (rasterize.union_boxes), instead of being formed in the kernel's
// scan from the B views' rows. Built and timed beside the tree's own
// entry by tools/torch_halo_raster_times.py --union-given: the
// measurement behind forming the union in the scan. Not part of the port.

#include "../flame_tpu_torch/csrc/raster.cu"

namespace {

__global__ void __launch_bounds__(kMeshThreads, 3)
    raster_union_given_kernel(const float* __restrict__ packed,
                              const float4* __restrict__ bbox,
                              const float4* __restrict__ ubox, int T,
                              float* __restrict__ out,
                              int* __restrict__ max_count, int ntx, int k1,
                              int tile_h) {
  extern __shared__ float smem[];
  const Staging st = staging(smem, k1);
  __shared__ int wcount[2][kMeshWarps];
  __shared__ int found;
  __shared__ int kept[kMaxViewCluster];
  __shared__ int total;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tile = blockIdx.x;
  const size_t view = blockIdx.z;
  const int ox = tile % ntx * kTileW, oy = tile / ntx * tile_h;
  const float fx0 = static_cast<float>(ox), fy0 = static_cast<float>(oy);
  const float fx1 = static_cast<float>(ox + kTileW - 1);
  const float fy1 = static_cast<float>(oy + tile_h - 1);

  const int chunk = (T + C - 1) / C;
  const int top = T - rank * chunk;
  const int len = top < chunk ? (top > 0 ? top : 0) : chunk;
  const int mine = scan_hits(
      top, len, k1, st.idx, wcount,
      [&](int t) {  // the given union bbox
        const float4 b = ubox[t];
        return b.x <= fx1 && b.y >= fx0 && b.z <= fy1 && b.w >= fy0;
      },
      [](int) { return true; });
  if (threadIdx.x == 0) found = mine;
  cluster.sync();
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

  const float4* vrows = reinterpret_cast<const float4*>(packed) + view * T * 4;
  const float4* vbox = bbox + view * T;
  for (int k = threadIdx.x; k < n; k += kMeshThreads) {
    int q = 0, off = k;
    while (off >= kept[q]) off -= kept[q++];
    const int t = cluster.map_shared_rank(st.idx, q)[off];
    stage(st, k, vrows + static_cast<size_t>(t) * 4, vbox[t]);
  }
  cluster.sync();

  const int W = ntx * kTileW;
  const size_t grid_px = static_cast<size_t>(gridDim.x / ntx) * tile_h * W;
  tile_pass(st, n, ox, oy, tile_h, out + view * grid_px, W);
}

}  // namespace

// raster_mesh_batch's contract, with ubox (T, 4) the union bboxes.
extern "C" int raster_union_given(const float* packed, const float* bbox,
                                  const float* ubox, int B, int T, float* out,
                                  int* max_count, int nty, int ntx, int k1,
                                  int tile_h, void* stream) {
  if (tile_h < 1 || tile_h > kMaxTileH || T < 0 || k1 < 0 || k1 > T ||
      nty < 1 || ntx < 1 || B < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int c = kMaxViewCluster < B ? kMaxViewCluster : B;
  while (B % c) --c;
  const void* k = reinterpret_cast<const void*>(raster_union_given_kernel);
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
  const float4* u4 = reinterpret_cast<const float4*>(ubox);
  void* params[] = {&packed, &b4, &u4, &T, &out, &max_count, &ntx, &k1,
                    &tile_h};
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
