// All NLTGV2-L1 Chambolle-Pock iterations of the vertex-centric [V, D]
// incidence layout in one persistent launch.
//
// Replaces: flame_tpu/optimize/pallas_smoother.py::_kernel (driven by
// run_kernel/smooth), the TPU kernel that runs all iterations with the
// graph state resident in VMEM over an RCM-banded 128-lane layout. The
// banding exists because Mosaic cannot gather across lanes; a GPU lane
// reads any address, so this kernel works directly on the [V, D] tables
// of nltgv2.slot_prologue (the math the Pallas kernel is tested against).
// The wrapper is flame_tpu_torch/optimize/smoother_kernel.py; its plain
// version (nltgv2.iterate_plain) is the reference this kernel is checked
// against.
//
// Math (per vertex v, for each of its D slots): read the neighbour's
// (x_bar, w1_bar, w2_bar), put the edge in canonical (src, dst)
// orientation, dual ascent on the slot's private copy of (q1, q2, q3)
// with the projection q / max(|q|, 1), and the slot's primal
// contribution to v. Then sum the D contributions, proxL1 toward the
// data term clipped to [x_min, x_max], the vertex mask, and the theta
// extragradient step.
//
// What bounds it on an H100: at V=4096, D=20 a call reads the ten (V, D)
// tables once (4.5 MB) and does about 30 MFLOP over 40 iterations, a
// microsecond of either; every iteration waits for every neighbour's new
// bars, so the latency of one iteration (a scattered gather from L2, the
// vertex's sum in slot order, one grid-wide barrier) bounds it. The design:
//   * one cooperative launch runs every iteration, a hand-written grid
//     barrier (a growing arrival count and a generation flag on separate
//     lines, acquire-release) between them; the launch is refused, never
//     left to hang, if the grid cannot be resident at once;
//   * a warp per vertex and a lane per slot (slots lane, lane + 32 for
//     D <= 64): a lane loads its slot's invariants and duals once, keeps
//     them in registers for every iteration and stores the duals once at
//     the end, so an iteration reads only the neighbours' bars, and the
//     gathers of a vertex are in flight together;
//   * the gathers are the traffic: each reads the neighbour's three bars
//     as one 16-byte word of an interleaved ping-pong buffer (one L2
//     sector, not three), and an empty slot (alpha = beta = 0, whose
//     neighbour value is multiplied by zero) reads nothing;
//   * when V warps do not fit the card, a warp takes VPW vertices; a lane
//     keeps its first kRegGroups (vertex, slot) groups in registers and
//     the rest in shared memory;
//   * the lanes write their contributions to shared memory; lanes 3j,
//     3j + 1 and 3j + 2 sum those of x, w1 and w2 of the warp's j-th
//     vertex in slot order, apply the vertex step to the value they keep
//     in registers (the three are independent) and write the new bar.
//     Bars cross SMs through L2 (__stcg / __ldcg): L1 is not coherent
//     across SMs.
//
// Both endpoints of an edge hold a copy of its duals. They compute the
// update from the same operands (values of the previous iteration) with
// the same instruction sequence, every product and sum rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), so the copies stay bit-equal
// and no scatter is ever needed.

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;  // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kRegGroups = 2;  // groups a lane keeps in registers
constexpr int kMaxGroups = 8;  // slots per lane x vertices per warp
constexpr int kWords = 8;      // a spilled group: nf dx dy al be q1 q2 q3
constexpr int kLive = 1 << 30;  // nf bits: the lane holds a table entry,
constexpr int kSrc = 1 << 29;   // the vertex is the edge's source,
constexpr int kSgnNZ = 1 << 28;   // sgn is +-1 (else +-0),
constexpr int kSgnNeg = 1 << 27;  // sgn's sign bit,
constexpr int kEdge = 1 << 26;    // alpha or beta is not zero,
constexpr int kNbr = kEdge - 1;   // the neighbour vertex
constexpr int kGenWord = 32;  // barrier generation, a line past the count
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSpinLimitCycles = 1LL << 33;  // seconds at SM clocks

struct Args {
  const float* xb_in;  // (V,) bars and primal state in
  const float* w1b_in;
  const float* w2b_in;
  const float* x_in;
  const float* w1_in;
  const float* w2_in;
  const float* q1_in;  // (V, D) dual copies in
  const float* q2_in;
  const float* q3_in;
  const int* nbr;  // (V, D) slot tables
  const float* sdx;
  const float* sdy;
  const float* sal;
  const float* sbe;
  const float* sgn;
  const float* srcf;
  const float* data;    // (V,)
  const float* weight;  // data_factor * data_weight
  const bool* vmask;
  float* x_out;  // (V,)
  float* w1_out;
  float* w2_out;
  float* xb_out;
  float* w1b_out;
  float* w2b_out;
  float* q1_out;  // (V, D)
  float* q2_out;
  float* q3_out;
  float4* scratch;  // (2, V) ping-pong [x_bar w1_bar w2_bar -]
  unsigned* barrier;  // (64,): [0] arrival count, [32] generation; zeroed
  int v, d, n_iters;
  float step_x, step_q, theta, x_min, x_max;
};

struct Slot {
  int nf;  // kNbr | kEdge | kSgnNeg | kSgnNZ | kSrc | kLive
  float dx, dy, al, be, q1, q2, q3;
};

// The slot's sgn (+1, -1 or a signed zero) from its nf bits.
__device__ __forceinline__ float slot_sign(int nf) {
  return copysignf((nf & kSgnNZ) ? 1.0f : 0.0f,
                   (nf & kSgnNeg) ? -1.0f : 1.0f);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// q / max(|q|, 1) as IEEE division gives it, without dividing where the
// quotient is exact: q itself for |q| <= 1, and +-1 for finite |q| > 1.
__device__ __forceinline__ float unit_ball(float q) {
  const float a = fabsf(q);
  if (a <= 1.0f) return q;
  if (a < INFINITY) return copysignf(1.0f, q);
  return __fdiv_rn(q, fmaxf(a, 1.0f));  // inf / inf and NaN
}

// Word w of this thread's spilled group m: (m, word, thread), so a warp
// reads 32 consecutive words.
__device__ __forceinline__ float& spilled(float* sm, int m, int w) {
  return sm[(m * kWords + w) * kThreads + threadIdx.x];
}

__device__ __forceinline__ Slot load_spilled(float* sm, int m) {
  Slot s;
  s.nf = __float_as_int(spilled(sm, m, 0));
  s.dx = spilled(sm, m, 1);
  s.dy = spilled(sm, m, 2);
  s.al = spilled(sm, m, 3);
  s.be = spilled(sm, m, 4);
  s.q1 = spilled(sm, m, 5);
  s.q2 = spilled(sm, m, 6);
  s.q3 = spilled(sm, m, 7);
  return s;
}

using uref = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

// Barrier number gen (1, 2, ...) of the launch: every CTA arrives before
// any leaves. The count only grows, so the CTA that brings it to
// gen * gridDim.x publishes gen; the others spin on it. Arrival is
// acquire-release (it releases the CTA's stores, ordered before it by
// __syncthreads, and the last arrival acquires everyone's), the spin an
// acquire. Count and generation sit on separate lines, so the spinning
// does not slow the arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    uref count(bar[0]), flag(bar[kGenWord]);
    if (count.fetch_add(1, cuda::std::memory_order_acq_rel) ==
        gen * gridDim.x - 1) {
      flag.store(gen, cuda::std::memory_order_release);
    } else {
      const long long t0 = clock64();
      while (flag.load(cuda::std::memory_order_acquire) < gen) {
        if (clock64() - t0 > kSpinLimitCycles) __trap();
      }
    }
  }
  __syncthreads();
}

// SPL slots per lane (D <= 32 * SPL), VPW vertices per warp. Group
// g = j * SPL + c of a lane is slot c * 32 + lane of the warp's j-th vertex.
template <int SPL, int VPW>
__global__ void __launch_bounds__(kThreads, 1)
    nltgv2_smoother_kernel(const Args a) {
  constexpr int NS = SPL * VPW;
  constexpr int NR = NS < kRegGroups ? NS : kRegGroups;
  // (NS - NR, kWords, kThreads) spilled groups, then per warp its slots'
  // three contributions (3, 32 * SPL) for the sums.
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int V = a.v, D = a.d;
  const int v0 = (blockIdx.x * kWarps + warp) * VPW;
  float* red = sm + (NS - NR) * kWords * kThreads + warp * 3 * 32 * SPL;

  Slot reg[NR];
#pragma unroll
  for (int g = 0; g < NS; ++g) {
    const int v = v0 + g / SPL, d = (g % SPL) * 32 + lane;
    Slot s{};
    if (v < V && d < D) {
      const size_t k = static_cast<size_t>(v) * D + d;
      const float sg = a.sgn[k];
      s.dx = a.sdx[k];
      s.dy = a.sdy[k];
      s.al = a.sal[k];
      s.be = a.sbe[k];
      s.q1 = a.q1_in[k];
      s.q2 = a.q2_in[k];
      s.q3 = a.q3_in[k];
      s.nf = a.nbr[k] | kLive | (a.srcf[k] > 0.0f ? kSrc : 0) |
             (sg != 0.0f ? kSgnNZ : 0) | (signbit(sg) ? kSgnNeg : 0) |
             (s.al != 0.0f || s.be != 0.0f ? kEdge : 0);
    }
    if (g < NR) {
      reg[g < NR ? g : 0] = s;
    } else {
      const int m = g - NR;
      spilled(sm, m, 0) = __int_as_float(s.nf);
      spilled(sm, m, 1) = s.dx;
      spilled(sm, m, 2) = s.dy;
      spilled(sm, m, 3) = s.al;
      spilled(sm, m, 4) = s.be;
      spilled(sm, m, 5) = s.q1;
      spilled(sm, m, 6) = s.q2;
      spilled(sm, m, 7) = s.q3;
    }
  }

  // Lane 3j + k keeps component k (x, w1, w2) of the warp's j-th vertex
  // and its bar in registers.
  const int oj = lane / 3, ok = lane % 3;
  const int vo = v0 + oj;
  const bool owner = lane < 3 * VPW && vo < V;
  float val = 0.0f, bar = 0.0f, dat = 0.0f, thr = 0.0f;
  bool on = false;
  float* scr = reinterpret_cast<float*>(a.scratch);
  if (owner) {
    val = ok == 0 ? a.x_in[vo] : ok == 1 ? a.w1_in[vo] : a.w2_in[vo];
    bar = ok == 0 ? a.xb_in[vo] : ok == 1 ? a.w1b_in[vo] : a.w2b_in[vo];
    dat = a.data[vo];
    thr = mul(a.step_x, a.weight[vo]);
    on = a.vmask[vo];
    __stcg(scr + (static_cast<size_t>(V) + vo) * 4 + ok, bar);
  }
  grid_barrier(a.barrier, 1);  // every start bar is in scratch[1]

  for (int it = 0; it < a.n_iters; ++it) {
    const float4* cur = a.scratch + static_cast<size_t>((it + 1) & 1) * V;
    float* nxt = scr + static_cast<size_t>(it & 1) * V * 4;
    float sum = 0.0f;  // of this lane's component
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      const float xb_s = __shfl_sync(kFull, bar, 3 * j);
      const float w1b_s = __shfl_sync(kFull, bar, 3 * j + 1);
      const float w2b_s = __shfl_sync(kFull, bar, 3 * j + 2);
#pragma unroll
      for (int c = 0; c < SPL; ++c) {
        const int g = j * SPL + c;
        Slot s = g < NR ? reg[g < NR ? g : 0] : load_spilled(sm, g - NR);
        float4 nb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (s.nf & kEdge) nb = __ldcg(cur + (s.nf & kNbr));
        const bool is_src = (s.nf & kSrc) != 0;
        const float xb_i = is_src ? xb_s : nb.x;
        const float xb_j = is_src ? nb.x : xb_s;
        const float w1b_i = is_src ? w1b_s : nb.y;
        const float w1b_j = is_src ? nb.y : w1b_s;
        const float w2b_i = is_src ? w2b_s : nb.z;
        const float w2b_j = is_src ? nb.z : w2b_s;

        const float qa = mul(a.step_q, s.al), qb = mul(a.step_q, s.be);
        const float K1 =
            sub(sub(sub(xb_i, xb_j), mul(s.dx, w1b_i)), mul(s.dy, w2b_i));
        s.q1 = unit_ball(add(s.q1, mul(qa, K1)));
        s.q2 = unit_ball(add(s.q2, mul(qb, sub(w1b_i, w1b_j))));
        s.q3 = unit_ball(add(s.q3, mul(qb, sub(w2b_i, w2b_j))));

        const float sg = slot_sign(s.nf);
        const float sxa = mul(a.step_x, s.al), sxb = mul(a.step_x, s.be);
        const int d = c * 32 + lane;
        red[d] = mul(mul(-sg, s.q1), sxa);
        red[32 * SPL + d] = sub(is_src ? mul(mul(s.q1, sxa), s.dx) : 0.0f,
                                mul(mul(sg, s.q2), sxb));
        red[64 * SPL + d] = sub(is_src ? mul(mul(s.q1, sxa), s.dy) : 0.0f,
                                mul(mul(sg, s.q3), sxb));
        if (g < NR) {
          reg[g < NR ? g : 0] = s;
        } else {
          spilled(sm, g - NR, 5) = s.q1;
          spilled(sm, g - NR, 6) = s.q2;
          spilled(sm, g - NR, 7) = s.q3;
        }
      }
      __syncwarp();
      if (oj == j) {  // lanes 3j .. 3j + 2: slot order d = 0 .. D - 1
        const float* r = red + ok * 32 * SPL;
        float t = 0.0f;
        for (int d = 0; d < D; d += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(r + d);
          t = add(t, c4.x);
          if (d + 1 < D) t = add(t, c4.y);
          if (d + 2 < D) t = add(t, c4.z);
          if (d + 3 < D) t = add(t, c4.w);
        }
        sum = t;
      }
      __syncwarp();  // the sums are read before the next vertex's writes
    }

    if (owner) {
      float nv = add(val, sum);
      if (ok == 0) {
        // proxL1 toward the data term (reference .h:179-197).
        const float diff = sub(nv, dat);
        nv = diff > thr ? sub(nv, thr) : (diff < -thr ? add(nv, thr) : dat);
        nv = fminf(fmaxf(nv, a.x_min), a.x_max);
      }
      if (!on) nv = val;
      // Extragradient (reference .cc:156-174): x_bar clipped, w bars not.
      bar = add(nv, mul(a.theta, sub(nv, val)));
      if (ok == 0) bar = fminf(fmaxf(bar, a.x_min), a.x_max);
      val = nv;
      __stcg(nxt + static_cast<size_t>(vo) * 4 + ok, bar);
    }
    if (it + 1 < a.n_iters) grid_barrier(a.barrier, it + 2);
  }

  if (owner) {
    (ok == 0 ? a.x_out : ok == 1 ? a.w1_out : a.w2_out)[vo] = val;
    (ok == 0 ? a.xb_out : ok == 1 ? a.w1b_out : a.w2b_out)[vo] = bar;
  }
#pragma unroll
  for (int g = 0; g < NS; ++g) {
    const Slot s = g < NR ? reg[g < NR ? g : 0] : load_spilled(sm, g - NR);
    if (s.nf & kLive) {
      const size_t k =
          static_cast<size_t>(v0 + g / SPL) * D + (g % SPL) * 32 + lane;
      a.q1_out[k] = s.q1;
      a.q2_out[k] = s.q2;
      a.q3_out[k] = s.q3;
    }
  }
}

size_t smem_bytes(int spl, int vpw) {
  const int spill = spl * vpw - kRegGroups;
  return (static_cast<size_t>(spill > 0 ? spill : 0) * kWords * kThreads +
          static_cast<size_t>(kWarps) * 3 * 32 * spl) * sizeof(float);
}

template <int SPL, int VPW>
const void* entry() {
  return reinterpret_cast<const void*>(nltgv2_smoother_kernel<SPL, VPW>);
}

// The instantiation for (spl, vpw) with its dynamic shared memory allowed,
// or nullptr for a combination the kernel does not hold.
const void* kernel_for(int spl, int vpw) {
  const void* k = nullptr;
  if (spl == 1) {
    k = vpw == 1 ? entry<1, 1>() : vpw == 2 ? entry<1, 2>()
        : vpw == 4 ? entry<1, 4>() : vpw == 8 ? entry<1, 8>() : nullptr;
  } else if (spl == 2) {
    k = vpw == 1 ? entry<2, 1>() : vpw == 2 ? entry<2, 2>()
        : vpw == 4 ? entry<2, 4>() : nullptr;
  }
  if (k != nullptr && spl * vpw <= kMaxGroups &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(spl, vpw))) !=
          cudaSuccess) {
    return nullptr;
  }
  return k;
}

}  // namespace

// CTAs of kThreads threads that one SM holds at once for the instantiation
// with spl slots per lane and vpw vertices per warp (0 for a combination
// the kernel does not hold). Returns the cudaError_t.
extern "C" int nltgv2_smoother_occupancy(int spl, int vpw, int* blocks) {
  *blocks = 0;
  const void* k = kernel_for(spl, vpw);
  if (k == nullptr) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, kThreads, smem_bytes(spl, vpw)));
}

// n_iters >= 1 iterations over V vertices of degree D <= 64, vpw vertices
// per warp: ceil(ceil(V / vpw) / 32) CTAs of 1024 threads in one
// cooperative launch (refused if they cannot all be resident). Inputs are
// left as they are. sgn holds +1, -1 or a signed zero; vmask is bool.
// scratch is (2, V, 4) floats, barrier 64 words (zeroed here). Returns the
// cudaError_t.
extern "C" int nltgv2_smoother(
    const float* xb_in, const float* w1b_in, const float* w2b_in,
    const float* x_in, const float* w1_in, const float* w2_in,
    const float* q1_in, const float* q2_in, const float* q3_in,
    const int* nbr, const float* sdx, const float* sdy, const float* sal,
    const float* sbe, const float* sgn, const float* srcf, const float* data,
    const float* weight, const bool* vmask, float* x_out, float* w1_out,
    float* w2_out, float* xb_out, float* w1b_out, float* w2b_out,
    float* q1_out, float* q2_out, float* q3_out, float* scratch,
    unsigned* barrier, int V, int D, int n_iters, int vpw, float step_x,
    float step_q, float theta, float x_min, float x_max, void* stream) {
  if (V < 1 || V > kNbr || D < 1 || D > 64 || n_iters < 1 || vpw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spl = (D + 31) / 32;
  const void* k = kernel_for(spl, vpw);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xb_in,   w1b_in,  w2b_in, x_in,    w1_in,   w2_in,
               q1_in,   q2_in,   q3_in,  nbr,     sdx,     sdy,
               sal,     sbe,     sgn,    srcf,    data,    weight,
               vmask,   x_out,   w1_out, w2_out,  xb_out,  w1b_out,
               w2b_out, q1_out,  q2_out, q3_out,
               reinterpret_cast<float4*>(scratch), barrier, V, D, n_iters,
               step_x,  step_q,  theta,  x_min,   x_max};
  const int warps = (V + vpw - 1) / vpw;
  const int grid = (warps + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaMemsetAsync(barrier, 0, 2 * kGenWord * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), params,
                                  smem_bytes(spl, vpw), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
