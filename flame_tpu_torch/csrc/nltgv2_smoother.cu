// One NLTGV2-L1 Chambolle-Pock iteration on the vertex-centric [V, D]
// incidence layout.
//
// Replaces: flame_tpu/optimize/pallas_smoother.py::_kernel (driven by
// run_kernel/smooth), the TPU kernel that runs all iterations with the
// graph state resident in VMEM over an RCM-banded 128-lane layout. The
// banding exists because Mosaic cannot gather across lanes; a GPU thread
// reads any address, so this kernel works directly on the vertex-centric
// tables of nltgv2._smooth_vertex_centric (the math the Pallas kernel is
// tested against).
//
// Math (per vertex v, for each of its D slots): read the neighbour's
// (x_bar, w1_bar, w2_bar), put the edge in canonical (src, dst)
// orientation, dual ascent on the slot's private copy of (q1, q2, q3)
// with the projection q / max(|q|, 1), and the slot's primal
// contribution to v. Then sum the D contributions, proxL1 toward the
// data term clipped to [x_min, x_max], the vertex mask, and the theta
// extragradient step.
//
// Both endpoints of an edge hold a copy of its duals. They compute the
// update from the same operands (values of the previous iteration) with
// the same instruction sequence, so the copies stay bit-equal with or
// without FMA contraction and no scatter is ever needed.
//
// What bounds it on an H100: at V=4096, D=20 one iteration touches about
// 4 MB (ten (D, V) float tables plus per-vertex state), all of which
// stays in the 50 MB L2, and 4096 threads fill only a fraction of the
// 132 SMs. A launch does a few microseconds of work, so launch latency
// bounds it. The design keeps one launch per iteration (the grid-wide
// dependency on every neighbour's x_bar of the previous iteration),
// ping-pongs the (x_bar, w1_bar, w2_bar) buffers between launches, and
// updates the slot duals in place (private to their vertex). Slot tables
// are (D, V) so that a warp reads consecutive vertices of one slot
// (coalesced). Next steps: capture the n_iters launches in a CUDA graph,
// or one persistent launch with a grid-wide sync between iterations.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float unit_ball(float q) {
  return q / fmaxf(fabsf(q), 1.0f);
}

__global__ void nltgv2_iterate_kernel(
    const float* __restrict__ xb_in, const float* __restrict__ w1b_in,
    const float* __restrict__ w2b_in, float* __restrict__ xb_out,
    float* __restrict__ w1b_out, float* __restrict__ w2b_out,
    float* __restrict__ x, float* __restrict__ w1, float* __restrict__ w2,
    float* __restrict__ q1, float* __restrict__ q2, float* __restrict__ q3,
    const int* __restrict__ nbr, const float* __restrict__ sdx,
    const float* __restrict__ sdy, const float* __restrict__ sal,
    const float* __restrict__ sbe, const float* __restrict__ sgn,
    const float* __restrict__ srcf, const float* __restrict__ data,
    const float* __restrict__ weight, const float* __restrict__ vmask,
    int V, int D, float step_x, float step_q, float theta, float x_min,
    float x_max) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;

  const float xb_s = xb_in[v];
  const float w1b_s = w1b_in[v];
  const float w2b_s = w2b_in[v];
  float sum_x = 0.0f, sum_w1 = 0.0f, sum_w2 = 0.0f;

  for (int d = 0; d < D; ++d) {
    const int k = d * V + v;
    const int n = nbr[k];
    const float xb_n = xb_in[n];
    const float w1b_n = w1b_in[n];
    const float w2b_n = w2b_in[n];
    const bool is_src = srcf[k] > 0.0f;
    const float xb_i = is_src ? xb_s : xb_n;
    const float xb_j = is_src ? xb_n : xb_s;
    const float w1b_i = is_src ? w1b_s : w1b_n;
    const float w1b_j = is_src ? w1b_n : w1b_s;
    const float w2b_i = is_src ? w2b_s : w2b_n;
    const float w2b_j = is_src ? w2b_n : w2b_s;

    const float a = sal[k], b = sbe[k], dx = sdx[k], dy = sdy[k];
    const float K1 = (xb_i - xb_j) - dx * w1b_i - dy * w2b_i;
    const float nq1 = unit_ball(q1[k] + (step_q * a) * K1);
    const float nq2 = unit_ball(q2[k] + (step_q * b) * (w1b_i - w1b_j));
    const float nq3 = unit_ball(q3[k] + (step_q * b) * (w2b_i - w2b_j));
    q1[k] = nq1;
    q2[k] = nq2;
    q3[k] = nq3;

    const float s = sgn[k], sf = srcf[k];
    const float sxa = step_x * a, sxb = step_x * b;
    sum_x += -s * nq1 * sxa;
    sum_w1 += sf * nq1 * sxa * dx - s * nq2 * sxb;
    sum_w2 += sf * nq1 * sxa * dy - s * nq3 * sxb;
  }

  const float x_prev = x[v], w1_prev = w1[v], w2_prev = w2[v];
  float nx = x_prev + sum_x;
  float nw1 = w1_prev + sum_w1;
  float nw2 = w2_prev + sum_w2;

  // proxL1 toward the data term (reference .h:179-197).
  const float dat = data[v];
  const float thr = step_x * weight[v];
  const float diff = nx - dat;
  nx = diff > thr ? nx - thr : (diff < -thr ? nx + thr : dat);
  nx = fminf(fmaxf(nx, x_min), x_max);
  if (!(vmask[v] > 0.0f)) {
    nx = x_prev;
    nw1 = w1_prev;
    nw2 = w2_prev;
  }
  x[v] = nx;
  w1[v] = nw1;
  w2[v] = nw2;

  // Extragradient (reference .cc:156-174): x_bar clipped, w bars not.
  xb_out[v] = fminf(fmaxf(nx + theta * (nx - x_prev), x_min), x_max);
  w1b_out[v] = nw1 + theta * (nw1 - w1_prev);
  w2b_out[v] = nw2 + theta * (nw2 - w2_prev);
}

}  // namespace

extern "C" int nltgv2_iterate(
    const float* xb_in, const float* w1b_in, const float* w2b_in,
    float* xb_out, float* w1b_out, float* w2b_out, float* x, float* w1,
    float* w2, float* q1, float* q2, float* q3, const int* nbr,
    const float* sdx, const float* sdy, const float* sal, const float* sbe,
    const float* sgn, const float* srcf, const float* data,
    const float* weight, const float* vmask, int V, int D, float step_x,
    float step_q, float theta, float x_min, float x_max, void* stream) {
  const int threads = 128;
  const int blocks = (V + threads - 1) / threads;
  nltgv2_iterate_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      xb_in, w1b_in, w2b_in, xb_out, w1b_out, w2b_out, x, w1, w2, q1, q2,
      q3, nbr, sdx, sdy, sal, sbe, sgn, srcf, data, weight, vmask, V, D,
      step_x, step_q, theta, x_min, x_max);
  return static_cast<int>(cudaGetLastError());
}
