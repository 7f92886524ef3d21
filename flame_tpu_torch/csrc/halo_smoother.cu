// All NLTGV2-L1 Chambolle-Pock iterations of a row-partitioned, RCM-banded
// graph in one launch, the partitions swapping boundary strips every
// iteration.
//
// Replaces: flame_tpu/parallel/pallas_halo.py::_halo_kernel (pallas_call
// in _block_call, driven by smooth_sharded), the TPU kernel that runs the
// K-iteration loop on each chip of a 1-D mesh with the state in VMEM and
// exchanges `reach` boundary rows of (x_bar, w1_bar, w2_bar) with both
// ring neighbours by remote DMA into parity double-buffered receive slots.
// Here the mesh is n partitions of one card: one CTA per partition, its
// receive slots and flags in global memory. The wrapper is
// flame_tpu_torch/parallel/halo_kernel.py; its plain version
// (iterate_plain) is the reference this kernel is checked against.
//
// Layout (smoother_kernel.build_layout): vertex rank u at row u / 128,
// lane u % 128 of (R, 128) tables; its slot d at row (u / 128) * D + d of
// (R * D, 128) tables, so a warp reads one slot row coalesced. A slot
// holds its neighbour's lane (nbr) and row offset + reach (rowflag), so
// the neighbour's bar state sits at extended row (own row + rowflag) of
// the partition's (3, Rb + 2 * reach, 128) extended state, kept in shared
// memory. Partition p owns rows [p * Rb, (p + 1) * Rb).
//
// Per iteration, in the TPU kernel's order:
//   1. store my top `reach` own rows into my left neighbour's "from
//      right" receive slot [it % 2], my bottom rows into my right
//      neighbour's "from left" slot;
//   2. __syncthreads, __threadfence, then one thread release-stores it + 1
//      into both neighbours' flags;
//   3. that thread spins (acquire loads) until both of my flags reach
//      it + 1, then __syncthreads;
//   4. install the two received strips as my halo rows;
//   5. every vertex's step into registers (the duals, x and w are private
//      to the vertex and written at once), __syncthreads, then the new
//      bars into shared memory.
// A partition runs at most one iteration ahead of a neighbour (its sends
// of iteration k + 1 wait for the neighbour's sends of k + 1, which follow
// the neighbour's install of k), so the parity slots are never
// overwritten before they are read. Flags only grow within a call and are
// zeroed on the stream before it. At n = 1 the ring wraps onto the
// partition itself: the wrapped halo rows are garbage that no edge reads,
// because the band keeps every live edge within `reach` rows of real
// ranks. A spin that lasts seconds traps instead of hanging the card.
//
// Arithmetic: the TPU kernel's, with every product and sum rounded on its
// own (__fmul_rn, __fadd_rn: no FMA contraction), q / max(|q|, 1) as a
// division, the D slot contributions summed in slot order and the vertex
// mask as a select. So the two copies of an edge's duals (one in each
// endpoint's slots) stay bit-equal, and the result does not depend on n.
//
// What bounds it on an H100: at V = 4096, D = 20 an iteration reads and
// writes about 14 slot words x 81,920 slots x 4 B = 4.6 MB, all of it
// L2-resident (50 MB), plus the 3 KB of strips per partition; n CTAs use
// n of the 132 SMs, so the slot traffic of one SM per partition bounds it,
// not the card's bandwidth. The design runs every iteration in one launch
// (no per-iteration launch as in nltgv2_smoother.cu), keeps the bar state
// in shared memory and reads the slot tables coalesced. Later steps: a
// thread-block cluster per partition with its halos in distributed shared
// memory and the slot tables resident on chip, and receive slots in peer
// memory of other cards for a mesh across cards (the slot and flag
// addresses are per partition already).

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxThreads = 1024;
constexpr long long kSpinLimitCycles = 1LL << 33;  // seconds at SM clocks

struct Args {
  // (R, 128) per-vertex state, updated in place: x w1 w2 and the bars.
  float* x;
  float* w1;
  float* w2;
  float* xb;
  float* w1b;
  float* w2b;
  const float* data;
  const float* weight;  // data_weight; the kernel multiplies data_factor
  const float* vmask;
  // (R * D, 128) slot tables; the duals updated in place.
  const int* nbr;
  const int* rowflag;
  const float* sdx;
  const float* sdy;
  const float* sal;
  const float* sbe;
  const float* sgn;
  const float* srcf;
  float* q1;
  float* q2;
  float* q3;
  // Receive slots (n, parity 2, side 2, 3, reach, 128), side 0 from the
  // left neighbour, 1 from the right; flags (n, 2) by the same side.
  float* rx;
  int* flags;
  int n, rb, d, reach, n_iters;
  float step_x, step_q, theta, x_min, x_max, data_factor;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float unit_ball(float q) {
  return __fdiv_rn(q, fmaxf(fabsf(q), 1.0f));
}

using flag_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

template <int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    halo_smoother_kernel(const Args a) {
  extern __shared__ float be[];  // (3, rb + 2 * reach, 128)
  const int p = blockIdx.x;
  const int n = a.n, rb = a.rb, r = a.reach, D = a.d;
  const int ext = rb + 2 * r;
  const int fstride = ext * kLanes;  // one field of the extended state
  const int left = (p + n - 1) % n, right = (p + 1) % n;
  const int nv = rb * kLanes;
  const size_t v0 = static_cast<size_t>(p) * nv;
  const size_t s0 = static_cast<size_t>(p) * rb * D * kLanes;
  const int strip = 3 * r * kLanes;
  auto slot = [&](int part, int par, int side) {
    return a.rx + ((static_cast<size_t>(part) * 2 + par) * 2 + side) * strip;
  };

  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int e = r * kLanes + i;  // own row i / 128 at extended row + r
    be[e] = a.xb[v0 + i];
    be[fstride + e] = a.w1b[v0 + i];
    be[2 * fstride + e] = a.w2b[v0 + i];
  }
  __syncthreads();

  for (int it = 0; it < a.n_iters; ++it) {
    const int par = it & 1;
    // 1. Send my boundary rows.
    float* to_left = slot(left, par, 1);
    float* to_right = slot(right, par, 0);
    for (int i = threadIdx.x; i < strip; i += blockDim.x) {
      const int f = i / (r * kLanes), rem = i % (r * kLanes);
      const float* bf = be + f * fstride;
      __stcg(to_left + i, bf[r * kLanes + rem]);    // own rows [0, r)
      __stcg(to_right + i, bf[rb * kLanes + rem]);  // own rows [rb - r, rb)
    }
    // 2.-3. Publish, then wait for both neighbours' strips.
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      flag_ref(a.flags[2 * left + 1])
          .store(it + 1, cuda::std::memory_order_release);
      flag_ref(a.flags[2 * right + 0])
          .store(it + 1, cuda::std::memory_order_release);
      flag_ref from_left(a.flags[2 * p + 0]);
      flag_ref from_right(a.flags[2 * p + 1]);
      const long long t0 = clock64();
      while (from_left.load(cuda::std::memory_order_acquire) < it + 1 ||
             from_right.load(cuda::std::memory_order_acquire) < it + 1) {
        __nanosleep(32);
        if (clock64() - t0 > kSpinLimitCycles) __trap();
      }
      __threadfence();
    }
    __syncthreads();
    // 4. Install the halo rows.
    const float* from_l = slot(p, par, 0);
    const float* from_r = slot(p, par, 1);
    for (int i = threadIdx.x; i < strip; i += blockDim.x) {
      const int f = i / (r * kLanes), rem = i % (r * kLanes);
      float* bf = be + f * fstride;
      bf[rem] = __ldcg(from_l + i);
      bf[(rb + r) * kLanes + rem] = __ldcg(from_r + i);
    }
    __syncthreads();

    // 5. Each vertex's step; the new bars wait in registers.
    float nb0[VPT], nb1[VPT], nb2[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i >= nv) continue;
      const int row = i / kLanes, lane = i % kLanes;
      const int own = (row + r) * kLanes + lane;
      const float xb_s = be[own];
      const float w1b_s = be[fstride + own];
      const float w2b_s = be[2 * fstride + own];
      float sum_x = 0.0f, sum_w1 = 0.0f, sum_w2 = 0.0f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const size_t s = s0 + (static_cast<size_t>(row) * D + dd) * kLanes +
                         lane;
        const int e = (row + a.rowflag[s]) * kLanes + a.nbr[s];
        const float xb_n = be[e];
        const float w1b_n = be[fstride + e];
        const float w2b_n = be[2 * fstride + e];
        const bool is_src = a.srcf[s] > 0.0f;
        const float xb_i = is_src ? xb_s : xb_n;
        const float xb_j = is_src ? xb_n : xb_s;
        const float w1b_i = is_src ? w1b_s : w1b_n;
        const float w1b_j = is_src ? w1b_n : w1b_s;
        const float w2b_i = is_src ? w2b_s : w2b_n;
        const float w2b_j = is_src ? w2b_n : w2b_s;

        const float sal = a.sal[s], sbe = a.sbe[s];
        const float dx = a.sdx[s], dy = a.sdy[s];
        const float qa = mul(a.step_q, sal), qb = mul(a.step_q, sbe);
        const float K1 =
            sub(sub(sub(xb_i, xb_j), mul(dx, w1b_i)), mul(dy, w2b_i));
        const float nq1 = unit_ball(add(a.q1[s], mul(qa, K1)));
        const float nq2 = unit_ball(add(a.q2[s], mul(qb, sub(w1b_i, w1b_j))));
        const float nq3 = unit_ball(add(a.q3[s], mul(qb, sub(w2b_i, w2b_j))));
        a.q1[s] = nq1;
        a.q2[s] = nq2;
        a.q3[s] = nq3;

        const float sg = a.sgn[s];
        const float sxa = mul(a.step_x, sal), sxb = mul(a.step_x, sbe);
        const float d_x = mul(mul(-sg, nq1), sxa);
        const float d_w1 = sub(is_src ? mul(mul(nq1, sxa), dx) : 0.0f,
                               mul(mul(sg, nq2), sxb));
        const float d_w2 = sub(is_src ? mul(mul(nq1, sxa), dy) : 0.0f,
                               mul(mul(sg, nq3), sxb));
        sum_x = add(sum_x, d_x);
        sum_w1 = add(sum_w1, d_w1);
        sum_w2 = add(sum_w2, d_w2);
      }

      const size_t v = v0 + i;
      const float x = a.x[v], w1 = a.w1[v], w2 = a.w2[v];
      float nx = add(x, sum_x);
      float nw1 = add(w1, sum_w1);
      float nw2 = add(w2, sum_w2);
      // proxL1 toward the data term (reference .h:179-197).
      const float dat = a.data[v];
      const float thr = mul(a.step_x, mul(a.data_factor, a.weight[v]));
      const float diff = sub(nx, dat);
      nx = diff > thr ? sub(nx, thr) : (diff < -thr ? add(nx, thr) : dat);
      nx = fminf(fmaxf(nx, a.x_min), a.x_max);
      if (!(a.vmask[v] > 0.0f)) {
        nx = x;
        nw1 = w1;
        nw2 = w2;
      }
      a.x[v] = nx;
      a.w1[v] = nw1;
      a.w2[v] = nw2;
      // Extragradient (reference .cc:156-174): x_bar clipped, w bars not.
      nb0[k] = fminf(fmaxf(add(nx, mul(a.theta, sub(nx, x))), a.x_min),
                     a.x_max);
      nb1[k] = add(nw1, mul(a.theta, sub(nw1, w1)));
      nb2[k] = add(nw2, mul(a.theta, sub(nw2, w2)));
    }
    __syncthreads();  // every neighbour read of this iteration is done
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i >= nv) continue;
      const int e = r * kLanes + i;
      be[e] = nb0[k];
      be[fstride + e] = nb1[k];
      be[2 * fstride + e] = nb2[k];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int e = r * kLanes + i;
    a.xb[v0 + i] = be[e];
    a.w1b[v0 + i] = be[fstride + e];
    a.w2b[v0 + i] = be[2 * fstride + e];
  }
}

template <int VPT>
cudaError_t launch(const Args& a, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = halo_smoother_kernel<VPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // A cooperative launch refuses a grid whose CTAs cannot all be resident
  // at once: a partition spinning on one that never got an SM would hang.
  void* params[] = {const_cast<Args*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(a.n), dim3(threads), params, smem,
                                     stream);
}

}  // namespace

// State (R, 128) with R = n * rb: x w1 w2 xb w1b w2b in/out, data weight
// vmask in; slots (R * D, 128): nbr rowflag (int32) sdx sdy sal sbe sgn
// srcf in, q1 q2 q3 in/out; rx (n, 2, 2, 3, reach, 128) and flags (n, 2)
// scratch. Returns the cudaError_t of the launch.
extern "C" int halo_smoother(
    float* x, float* w1, float* w2, float* xb, float* w1b, float* w2b,
    const float* data, const float* weight, const float* vmask,
    const int* nbr, const int* rowflag, const float* sdx, const float* sdy,
    const float* sal, const float* sbe, const float* sgn, const float* srcf,
    float* q1, float* q2, float* q3, float* rx, int* flags, int n, int rb,
    int d, int reach, int n_iters, float step_x, float step_q, float theta,
    float x_min, float x_max, float data_factor, void* stream) {
  if (n < 1 || rb < 1 || d < 1 || reach < 1 || rb < reach || n_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x,    w1,   w2,    xb,      w1b,    w2b,    data,   weight,
               vmask, nbr, rowflag, sdx,   sdy,    sal,    sbe,    sgn,
               srcf, q1,   q2,    q3,      rx,     flags,  n,      rb,
               d,    reach, n_iters, step_x, step_q, theta, x_min, x_max,
               data_factor};
  const int nv = rb * kLanes;
  const int threads = nv < kMaxThreads ? nv : kMaxThreads;
  const int vpt = (nv + threads - 1) / threads;
  const size_t smem =
      static_cast<size_t>(3) * (rb + 2 * reach) * kLanes * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags, 0, sizeof(int) * 2 * n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vpt <= 1) {
    e = launch<1>(a, threads, smem, s);
  } else if (vpt <= 2) {
    e = launch<2>(a, threads, smem, s);
  } else if (vpt <= 4) {
    e = launch<4>(a, threads, smem, s);
  } else if (vpt <= 8) {
    e = launch<8>(a, threads, smem, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
