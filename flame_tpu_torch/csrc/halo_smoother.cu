// All NLTGV2-L1 Chambolle-Pock iterations of a row-partitioned, RCM-banded
// graph in one launch, the partitions swapping boundary strips every
// iteration.
//
// Replaces: flame_tpu/parallel/pallas_halo.py::_halo_kernel (pallas_call
// in _block_call, driven by smooth_sharded), the TPU kernel that runs the
// K-iteration loop on each chip of a 1-D mesh with the state in VMEM and
// exchanges `reach` boundary rows of (x_bar, w1_bar, w2_bar) with both
// ring neighbours by remote DMA into parity double-buffered receive slots.
// Here a launch runs n partitions, each a thread-block cluster of C CTAs,
// its receive slots and flags in global memory. On a mesh of one process
// the n partitions are the whole ring. Over a process group each rank
// launches the kernel over its own block of rows (split into n clusters),
// and the ring crosses ranks at its ends: partition 0's left neighbour is
// the previous rank's last partition, partition n - 1's right neighbour
// the next rank's first one. Their receive slots and flags live in memory
// each rank allocates itself (cudaMalloc, halo_peer_alloc) and its
// neighbours map through CUDA IPC (halo_peer_open), so the kernel takes
// the two end neighbours' slot and flag pointers as arguments (rx_lo,
// flags_lo, rx_hi, flags_hi): peer pointers across ranks, this launch's
// own at the ends of a one-process ring. Where the ends are a peer's
// (peer_ends), the two end partitions fence their strip stores and take
// their flags at system scope, so the same code is right across NVLink
// between cards; every other partition, and every partition of a
// one-process ring, at device scope. The wrapper is flame_tpu_torch/parallel/halo_kernel.py
// (launch_plan picks C and the vertices per warp); its plain version
// (iterate_plain) is the reference this kernel is checked against.
//
// Layout (smoother_kernel.build_layout): vertex rank u at row u / 128,
// lane u % 128 of (R, 128) tables; its slot d at row (u / 128) * D + d of
// (R * D, 128) tables. A slot holds its neighbour's lane (nbr) and row
// offset + reach (rowflag). Partition p owns rows [p * rb, (p + 1) * rb):
// local vertex lv = u - p * rb * 128.
//
// The cluster of a partition: CTA c owns local vertices [c * VPC,
// (c + 1) * VPC), VPC = 32 warps x VPW vertices per warp; a warp takes
// VPW vertices, a lane a slot (D <= 32). A lane reads its slots' tables
// once per call and keeps the slot constants, the duals and the
// neighbour's address in registers across all iterations (past two
// vertices per warp, in shared memory), and writes the duals back once.
// Each CTA keeps its own vertices' bars (x_bar, w1_bar, w2_bar) in shared
// memory as one 16-byte word per vertex, in a ping-pong pair of buffers;
// CTA 0 also holds the `reach` halo rows received from the left
// neighbour, CTA C - 1 those from the right one. A neighbour's bars are
// read from the CTA that holds them through distributed shared memory
// (cluster.map_shared_rank), one 16-byte load; an empty slot (alpha =
// beta = 0, whose neighbour value is multiplied by zero) reads nothing.
//
// Iteration it reads bars buffer it % 2 and the halo rows and writes the
// new bars into buffer (it + 1) % 2; a vertex of the top (bottom) `reach`
// rows also stores its new bars into the left (right) neighbour's
// receive slot (parity (it + 1) % 2, then a fence). Then:
//   A. cluster barrier: every read of this iteration and every strip store
//      of the cluster is done;
//   B. CTA 0 release-stores epoch + it + 2 into the left neighbour's "from
//      right" flag, CTA C - 1 into the right neighbour's "from left" flag;
//      each spins (acquire) until its own flag from that side reaches
//      epoch + it + 2, then installs the received strip as its halo rows;
//   C. cluster barrier: the halo rows are in place for the next iteration.
// The start bars go the same way before iteration 0 (exchange 0). A
// partition runs at most one exchange ahead of a neighbour (its strip
// stores of exchange e + 2 follow its install of e + 1, which waits for
// the neighbour's flag of e + 1, which the neighbour raises after its
// install of e), so the parity slots are never overwritten before they
// are read. At n = 1 on one process the ring wraps onto the partition
// itself: the wrapped halo rows are never read, because the band keeps
// every live edge within `reach` rows of real ranks. A spin that lasts
// seconds (the card's global timer) traps instead of hanging the card.
//
// Flags are epoch-counted, never zeroed between calls: across processes a
// fast neighbour could raise exchange 0 of its next call before a reset
// on this side, and the signal would be lost. A call runs the exchanges
// e = 0 .. n_iters - 1 and, where the ring's ends are a peer's, one more,
// e = n_iters, that moves no strip: after barrier A (no CTA leaves while
// another reads its shared memory) the edge CTAs raise epoch + n_iters + 1
// and wait for their neighbours' flags to reach it. The wrapper passes
// epoch = the sum of n_iters + 1 over the earlier calls on these flags, so
// the values of a call lie above every value of the calls before it and
// each call's exchange e waits for exactly the neighbour's exchange e of
// the same call. The end exchange extends the one-exchange-ahead argument
// over the call boundary: a partition leaves call c only after its
// neighbours have raised their end flags, which each raises after
// installing its last strip, so the strip stores of exchange 0 of call
// c + 1 (parity 0) cannot overwrite a slot that a neighbour has still to
// read in call c; inside call c + 1 the argument above holds as before. A
// ring that is all this launch's needs no end exchange: the next launch on
// the stream starts after this one has ended. The outputs are written from
// registers after barrier A.
//
// Co-residency: every partition spins on its neighbours, so all clusters
// must be resident at once. The launch is cooperative with the cluster
// dimension, after cudaOccupancyMaxActiveClusters has shown that the card
// holds them all; a grid past that, or a launch the runtime refuses, is
// an error.
//
// Arithmetic: the TPU kernel's, with every product and sum rounded on its
// own (__fmul_rn, __fadd_rn: no FMA contraction), q / max(|q|, 1) as IEEE
// division gives it (q for |q| <= 1, +-1 past it: the quotient is exact
// there), the D slot contributions summed in slot order (three lanes sum
// x, w1 and w2 of a vertex from shared memory) and the vertex mask as a
// select. So the two copies of an edge's duals (one in each endpoint's
// slots) stay bit-equal, and the result does not depend on the number of
// partitions or on the launch plan.
//
// What bounds it on an H100: at V = 4096, D = 20 a call reads the 11 slot
// tables once (3.6 MB) and does about 30 MFLOP over 40 iterations, a
// microsecond of either; every iteration waits for every neighbour's new
// bars, so one iteration's latency bounds it: the DSMEM gathers and the
// slot sums of the VPW vertices of a warp, two cluster barriers and, at
// n > 1, one flag handshake through L2 with each ring neighbour. Later
// steps: the banded layout and the write-back built inside the launch.

#include <cooperative_groups.h>
#include <cstring>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 32;  // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 16;  // non-portable past 8
constexpr int kMaxDegree = 32;   // a lane per slot
constexpr int kRegGroups = 2;    // vertices whose slot stays in registers
constexpr int kWords = 8;        // a spilled slot: nf dx dy al be q1 q2 q3
constexpr int kLive = 1 << 30;   // nf bits: the lane holds a table entry,
constexpr int kSrc = 1 << 29;    // the vertex is the edge's source,
constexpr int kSgnNZ = 1 << 28;  // sgn is +-1 (else +-0),
constexpr int kSgnNeg = 1 << 27;  // sgn's sign bit,
constexpr int kEdge = 1 << 26;    // alpha or beta is not zero,
constexpr int kPing = 1 << 25;    // the neighbour's bars are ping-ponged
                                  // (a vertex of the partition, not a halo
                                  // row),
constexpr int kRankShift = 16;    // bits 16-19: the CTA that holds them,
constexpr int kOffMask = (1 << kRankShift) - 1;  // their 16-byte word there
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSpinLimitNs = 20000000000ull;  // 20 s

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
  // left neighbour, 1 from the right; flags (n, 2) by the same side. The
  // slots and flags of partition 0's left neighbour (rx_lo, flags_lo) and
  // of partition n - 1's right one (rx_hi, flags_hi): a peer's, mapped
  // through CUDA IPC, where the ring crosses ranks.
  float* rx;
  int* flags;
  float* rx_lo;
  int* flags_lo;
  float* rx_hi;
  int* flags_hi;
  int n, rb, d, reach, n_iters, epoch;
  int peer_ends;  // the ends are not this launch's own buffers
  float step_x, step_q, theta, x_min, x_max, data_factor;
};

struct Slot {
  int nf;  // where | kPing | kEdge | kSgnNeg | kSgnNZ | kSrc | kLive
  float dx, dy, al, be, q1, q2, q3;
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
// q / max(|q|, 1) as IEEE division gives it, without dividing where the
// quotient is exact: q itself for |q| <= 1, and +-1 for finite |q| > 1.
__device__ __forceinline__ float unit_ball(float q) {
  const float a = fabsf(q);
  if (a <= 1.0f) return q;
  if (a < INFINITY) return copysignf(1.0f, q);
  return __fdiv_rn(q, fmaxf(a, 1.0f));  // inf / inf and NaN
}
// The slot's sgn (+1, -1 or a signed zero) from its nf bits.
__device__ __forceinline__ float slot_sign(int nf) {
  return copysignf((nf & kSgnNZ) ? 1.0f : 0.0f,
                   (nf & kSgnNeg) ? -1.0f : 1.0f);
}

// Word w of this thread's spilled slot m: (m, word, thread), so a warp
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One flag handshake at scope S (thread 0 of an edge CTA): release-store v
// into the neighbours' flags to_left / to_right (null: not this CTA's
// side), then spin (acquire) until this partition's flags from_left /
// from_right (null: not waited on) reach v; a spin past kSpinLimitNs
// traps. The global timer (slow to read, but right across a preemption
// that moves the CTA to another SM) is read once per 1024 polls.
template <cuda::thread_scope S>
__device__ __forceinline__ void handshake_at(int* to_left, int* to_right,
                                          int* from_left, int* from_right,
                                          int v) {
  using ref = cuda::atomic_ref<int, S>;
  if (to_left != nullptr) {
    ref(*to_left).store(v, cuda::std::memory_order_release);
  }
  if (to_right != nullptr) {
    ref(*to_right).store(v, cuda::std::memory_order_release);
  }
  unsigned long long t0 = 0;
  for (unsigned spins = 0;
       (from_left != nullptr &&
        ref(*from_left).load(cuda::std::memory_order_acquire) < v) ||
       (from_right != nullptr &&
        ref(*from_right).load(cuda::std::memory_order_acquire) < v);
       ++spins) {
    __nanosleep(32);
    if ((spins & 1023) == 0) {
      const unsigned long long t = global_ns();
      if (spins == 0) {
        t0 = t;
      } else if (t - t0 > kSpinLimitNs) {
        __trap();
      }
    }
  }
  if (S == cuda::thread_scope_system) {
    __threadfence_system();
  } else {
    __threadfence();
  }
}

// Shared memory of one CTA: 16-byte words [bars buffer 0 (VPC) | bars
// buffer 1 (VPC) | left halo (reach * 128) | right halo (reach * 128)],
// then floats: the spilled slots and each warp's (3, 32) contributions.
size_t smem_bytes(int vpw, int reach) {
  const int vpc = kWarps * vpw;
  const int spill = vpw > kRegGroups ? vpw - kRegGroups : 0;
  return static_cast<size_t>(2 * vpc + 2 * reach * kLanes) * sizeof(float4) +
         (static_cast<size_t>(spill) * kWords * kThreads + kWarps * 3 * 32) *
             sizeof(float);
}

template <int VPW>
__global__ void __launch_bounds__(kThreads, 1)
    halo_smoother_kernel(const Args a) {
  constexpr int NR = VPW < kRegGroups ? VPW : kRegGroups;
  constexpr int VPC = kWarps * VPW;
  extern __shared__ __align__(16) float4 sm4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int part = blockIdx.x / C;
  const int n = a.n, rb = a.rb, r = a.reach, D = a.d;
  const int nv = rb * kLanes, rl = r * kLanes;
  const int left = part - 1, right = part + 1;  // -1 and n: rx_lo, rx_hi
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hl = 2 * VPC, hr = 2 * VPC + rl;  // the halo rows' words
  float* bars = reinterpret_cast<float*>(sm4);  // (2, VPC, 4)
  float* smf = reinterpret_cast<float*>(sm4 + 2 * VPC + 2 * rl);
  float* red = smf + (VPW - NR) * kWords * kThreads + warp * 3 * 32;
  const int lv0 = rank * VPC + warp * VPW;  // the warp's first vertex
  const size_t u0 = static_cast<size_t>(part) * nv;
  const int strip = 3 * rl;
  auto rx_slot = [&](int p, int par, int side) {
    float* base = p < 0    ? a.rx_lo
                  : p >= n ? a.rx_hi
                           : a.rx + static_cast<size_t>(p) * 4 * strip;
    return base + (par * 2 + side) * strip;
  };
  auto flag = [&](int p, int side) {
    int* base = p < 0 ? a.flags_lo : p >= n ? a.flags_hi : a.flags + 2 * p;
    return base + side;
  };
  // The end partitions of a ring whose ends are a peer's: system scope.
  const bool sys = a.peer_ends != 0 && (part == 0 || part == n - 1);

  // The slots of the warp's vertices, a lane each, with where their
  // neighbour's bars live.
  Slot reg[NR];
#pragma unroll
  for (int j = 0; j < VPW; ++j) {
    const int lv = lv0 + j;
    Slot s{};
    if (lv < nv && lane < D) {
      const size_t u = u0 + lv;
      const size_t k = ((u / kLanes) * D + lane) * kLanes + u % kLanes;
      const float sg = a.sgn[k];
      s.dx = a.sdx[k];
      s.dy = a.sdy[k];
      s.al = a.sal[k];
      s.be = a.sbe[k];
      s.q1 = a.q1[k];
      s.q2 = a.q2[k];
      s.q3 = a.q3[k];
      const int er = lv / kLanes + a.rowflag[k];  // extended row
      const int nb = a.nbr[k];
      int where;
      if (er < r) {
        where = hl + er * kLanes + nb;  // CTA 0's left halo
      } else if (er >= rb + r) {
        where = ((C - 1) << kRankShift) | (hr + (er - rb - r) * kLanes + nb);
      } else {
        const int ln = (er - r) * kLanes + nb;
        where = kPing | ((ln / VPC) << kRankShift) | (ln % VPC);
      }
      s.nf = where | kLive | (a.srcf[k] > 0.0f ? kSrc : 0) |
             (sg != 0.0f ? kSgnNZ : 0) | (signbit(sg) ? kSgnNeg : 0) |
             (s.al != 0.0f || s.be != 0.0f ? kEdge : 0);
    }
    if (j < NR) {
      reg[j < NR ? j : 0] = s;
    } else {
      const int m = j - NR;
      spilled(smf, m, 0) = __int_as_float(s.nf);
      spilled(smf, m, 1) = s.dx;
      spilled(smf, m, 2) = s.dy;
      spilled(smf, m, 3) = s.al;
      spilled(smf, m, 4) = s.be;
      spilled(smf, m, 5) = s.q1;
      spilled(smf, m, 6) = s.q2;
      spilled(smf, m, 7) = s.q3;
    }
  }

  // Lane 3j + k keeps component k (x, w1, w2) of the warp's j-th vertex
  // and its bar in registers.
  const int oj = lane / 3, ok = lane % 3;
  const int lvo = lv0 + oj;
  const int wo = warp * VPW + oj;  // its word in this CTA's bars
  const bool owner = lane < 3 * VPW && lvo < nv;
  float val = 0.0f, bar = 0.0f, dat = 0.0f, thr = 0.0f;
  bool on = false;
  // Store this lane's new bar into the ring neighbours' receive slots of
  // parity par where its vertex lies in the partition's top or bottom
  // `reach` rows; true if it stored.
  auto send = [&](int par, float b) {
    bool sent = false;
    if (lvo < rl) {
      __stcg(rx_slot(left, par, 1) + ok * rl + lvo, b);
      sent = true;
    }
    if (lvo >= nv - rl) {
      __stcg(rx_slot(right, par, 0) + ok * rl + lvo - (nv - rl), b);
      sent = true;
    }
    return sent;
  };
  // Thread 0 of an edge CTA: raise this partition's flag of exchange e
  // on the neighbours' side and wait for theirs.
  auto handshake = [&](int e) {
    int* to_left = rank == 0 ? flag(left, 1) : nullptr;
    int* to_right = rank == C - 1 ? flag(right, 0) : nullptr;
    int* from_left = rank == 0 ? flag(part, 0) : nullptr;
    int* from_right = rank == C - 1 ? flag(part, 1) : nullptr;
    const int v = a.epoch + e + 1;
    if (sys) {
      handshake_at<cuda::thread_scope_system>(to_left, to_right, from_left,
                                              from_right, v);
    } else {
      handshake_at<cuda::thread_scope_device>(to_left, to_right, from_left,
                                              from_right, v);
    }
  };
  // Exchange e (the bars iteration e reads), after this lane's strip
  // stores: barriers A and C and the edge CTAs' handshake between them.
  auto exchange = [&](int e, bool sent) {
    if (sent) {
      if (sys) {
        __threadfence_system();
      } else {
        __threadfence();
      }
    }
    cluster.sync();  // A
    if (rank == 0 || rank == C - 1) {
      if (threadIdx.x == 0) handshake(e);
      __syncthreads();
      const int par = e & 1;
      if (rank == 0) {
        const float* src = rx_slot(part, par, 0);
        for (int i = threadIdx.x; i < rl; i += kThreads) {
          sm4[hl + i] = make_float4(__ldcg(src + i), __ldcg(src + rl + i),
                                    __ldcg(src + 2 * rl + i), 0.0f);
        }
      }
      if (rank == C - 1) {
        const float* src = rx_slot(part, par, 1);
        for (int i = threadIdx.x; i < rl; i += kThreads) {
          sm4[hr + i] = make_float4(__ldcg(src + i), __ldcg(src + rl + i),
                                    __ldcg(src + 2 * rl + i), 0.0f);
        }
      }
    }
    cluster.sync();  // C
  };

  bool sent = false;
  if (owner) {
    const size_t v = u0 + lvo;
    val = ok == 0 ? a.x[v] : ok == 1 ? a.w1[v] : a.w2[v];
    bar = ok == 0 ? a.xb[v] : ok == 1 ? a.w1b[v] : a.w2b[v];
    dat = a.data[v];
    thr = mul(a.step_x, mul(a.data_factor, a.weight[v]));
    on = a.vmask[v] > 0.0f;
    bars[wo * 4 + ok] = bar;  // buffer 0
    if (a.n_iters > 0) sent = send(0, bar);
  }
  if (a.n_iters > 0) exchange(0, sent);

  for (int it = 0; it < a.n_iters; ++it) {
    const int cur = it & 1;
    float sum = 0.0f;  // of this lane's component
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      const float xb_s = __shfl_sync(kFull, bar, 3 * j);
      const float w1b_s = __shfl_sync(kFull, bar, 3 * j + 1);
      const float w2b_s = __shfl_sync(kFull, bar, 3 * j + 2);
      Slot s = j < NR ? reg[j < NR ? j : 0] : load_spilled(smf, j - NR);
      float4 nb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s.nf & kEdge) {
        const int off =
            (s.nf & kOffMask) + ((s.nf & kPing) ? cur * VPC : 0);
        nb = cluster.map_shared_rank(sm4, (s.nf >> kRankShift) & 15)[off];
      }
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
      red[lane] = mul(mul(-sg, s.q1), sxa);
      red[32 + lane] = sub(is_src ? mul(mul(s.q1, sxa), s.dx) : 0.0f,
                           mul(mul(sg, s.q2), sxb));
      red[64 + lane] = sub(is_src ? mul(mul(s.q1, sxa), s.dy) : 0.0f,
                           mul(mul(sg, s.q3), sxb));
      if (j < NR) {
        reg[j < NR ? j : 0] = s;
      } else {
        spilled(smf, j - NR, 5) = s.q1;
        spilled(smf, j - NR, 6) = s.q2;
        spilled(smf, j - NR, 7) = s.q3;
      }
      __syncwarp();
      if (oj == j) {  // lanes 3j .. 3j + 2: slot order d = 0 .. D - 1
        const float* rr = red + ok * 32;
        float t = 0.0f;
        for (int d = 0; d < D; d += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(rr + d);
          t = add(t, c4.x);
          if (d + 1 < D) t = add(t, c4.y);
          if (d + 2 < D) t = add(t, c4.z);
          if (d + 3 < D) t = add(t, c4.w);
        }
        sum = t;
      }
      __syncwarp();  // the sums are read before the next vertex's writes
    }

    const bool more = it + 1 < a.n_iters;
    sent = false;
    if (owner) {
      float nx = add(val, sum);
      if (ok == 0) {
        // proxL1 toward the data term (reference .h:179-197).
        const float diff = sub(nx, dat);
        nx = diff > thr ? sub(nx, thr) : (diff < -thr ? add(nx, thr) : dat);
        nx = fminf(fmaxf(nx, a.x_min), a.x_max);
      }
      if (!on) nx = val;
      // Extragradient (reference .cc:156-174): x_bar clipped, w bars not.
      bar = add(nx, mul(a.theta, sub(nx, val)));
      if (ok == 0) bar = fminf(fmaxf(bar, a.x_min), a.x_max);
      val = nx;
      bars[((cur ^ 1) * VPC + wo) * 4 + ok] = bar;
      if (more) sent = send((it + 1) & 1, bar);
    }
    if (more) exchange(it + 1, sent);
  }
  cluster.sync();  // A: no CTA leaves while another reads its bars
  // The end exchange of a ring that crosses processes: the flags of
  // e = n_iters, no strips.
  if (a.peer_ends != 0 && (rank == 0 || rank == C - 1) && threadIdx.x == 0) {
    handshake(a.n_iters);
  }

  if (owner) {
    const size_t v = u0 + lvo;
    (ok == 0 ? a.x : ok == 1 ? a.w1 : a.w2)[v] = val;
    (ok == 0 ? a.xb : ok == 1 ? a.w1b : a.w2b)[v] = bar;
  }
#pragma unroll
  for (int j = 0; j < VPW; ++j) {
    const Slot s = j < NR ? reg[j < NR ? j : 0] : load_spilled(smf, j - NR);
    if (s.nf & kLive) {
      const size_t u = u0 + lv0 + j;
      const size_t k = ((u / kLanes) * D + lane) * kLanes + u % kLanes;
      a.q1[k] = s.q1;
      a.q2[k] = s.q2;
      a.q3[k] = s.q3;
    }
  }
}

template <int VPW>
const void* entry() {
  return reinterpret_cast<const void*>(halo_smoother_kernel<VPW>);
}

// The instantiation for vpw vertices per warp with `smem` bytes of dynamic
// shared memory and cluster sizes past 8 allowed, or nullptr for a vpw the
// kernel does not hold or shared memory past what a CTA may have.
const void* kernel_for(int vpw, size_t smem) {
  const void* k = vpw == 1   ? entry<1>()
                  : vpw == 2 ? entry<2>()
                  : vpw == 4 ? entry<4>()
                  : vpw == 8 ? entry<8>()
                             : nullptr;
  if (k == nullptr) return nullptr;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it
    return nullptr;
  }
  return k;
}

cudaLaunchConfig_t config(int grid, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attrs, int n_attrs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = n_attrs;
  return cfg;
}

void set_cluster(cudaLaunchAttribute* attr, int cluster) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
}

// Clusters of `cluster` CTAs of the vpw instantiation that the card holds
// resident at once (0 where the shape does not fit a CTA).
cudaError_t max_clusters(int cluster, int vpw, int reach, int* clusters) {
  *clusters = 0;
  const size_t smem = smem_bytes(vpw, reach);
  const void* k = kernel_for(vpw, smem);
  if (k == nullptr) return cudaSuccess;
  cudaLaunchAttribute attr[1];
  set_cluster(attr, cluster);
  const cudaLaunchConfig_t cfg = config(cluster, smem, nullptr, attr, 1);
  return cudaOccupancyMaxActiveClusters(clusters, k, &cfg);
}

}  // namespace

// Clusters of `cluster` CTAs (1024 threads each, vpw vertices per warp,
// halo of `reach` rows) that the card holds resident at once, for the
// wrapper's launch plan; 0 for a shape that does not fit. Returns the
// cudaError_t.
extern "C" int halo_smoother_occupancy(int cluster, int vpw, int reach,
                                       int* clusters) {
  *clusters = 0;
  if (cluster < 1 || cluster > kMaxCluster || reach < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(max_clusters(cluster, vpw, reach, clusters));
}

// State (R, 128) with R = n * rb: x w1 w2 xb w1b w2b in/out, data weight
// vmask in; slots (R * D, 128): nbr rowflag (int32) sdx sdy sal sbe sgn
// srcf in, q1 q2 q3 in/out; rx (n, 2, 2, 3, reach, 128) and flags (n, 2)
// the partitions' receive slots and epoch-counted flags; rx_lo / flags_lo
// and rx_hi / flags_hi those of partition 0's left and partition n - 1's
// right neighbour (all four null: the ring wraps onto this launch, rx and
// flags as its ends). epoch: the sum of n_iters + 1 over the earlier
// calls on these flags (0 on flags zeroed for this call). n clusters of
// `cluster` CTAs, vpw vertices per warp, cover the n partitions of rb
// rows, in one cooperative cluster launch. Returns the cudaError_t of the
// launch.
extern "C" int halo_smoother(
    float* x, float* w1, float* w2, float* xb, float* w1b, float* w2b,
    const float* data, const float* weight, const float* vmask,
    const int* nbr, const int* rowflag, const float* sdx, const float* sdy,
    const float* sal, const float* sbe, const float* sgn, const float* srcf,
    float* q1, float* q2, float* q3, float* rx, int* flags, float* rx_lo,
    int* flags_lo, float* rx_hi, int* flags_hi, int n, int rb, int d,
    int reach, int n_iters, int epoch, int cluster, int vpw, float step_x,
    float step_q, float theta, float x_min, float x_max, float data_factor,
    void* stream) {
  const int nv = rb * kLanes, vpc = kWarps * vpw;
  const bool wrap = rx_lo == nullptr && flags_lo == nullptr &&
                    rx_hi == nullptr && flags_hi == nullptr;
  if (!wrap && (rx_lo == nullptr || flags_lo == nullptr ||
                rx_hi == nullptr || flags_hi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* own_lo = rx + static_cast<size_t>(n - 1) * 4 * 3 * reach * kLanes;
  if (wrap) {
    rx_lo = own_lo;
    flags_lo = flags + 2 * (n - 1);
    rx_hi = rx;
    flags_hi = flags;
  }
  // A one-rank group passes its own buffers as the ends.
  const bool own_ends = rx_lo == own_lo && flags_lo == flags + 2 * (n - 1) &&
                        rx_hi == rx && flags_hi == flags;
  if (n < 1 || rb < 1 || d < 1 || d > kMaxDegree || reach < 1 ||
      rb < reach || n_iters < 0 || epoch < 0 || cluster < 1 ||
      cluster > kMaxCluster ||
      cluster * vpc < nv || (cluster - 1) * vpc >= nv ||
      2 * vpc + 2 * reach * kLanes > kOffMask + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(vpw, reach);
  const void* k = kernel_for(vpw, smem);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Every partition spins on its neighbours: refuse a grid whose clusters
  // the card cannot hold at once.
  int held = 0;
  cudaError_t e = max_clusters(cluster, vpw, reach, &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > held) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  const Args a{x,       w1,       w2,     xb,     w1b,     w2b,   data,
               weight,  vmask,    nbr,    rowflag, sdx,    sdy,   sal,
               sbe,     sgn,      srcf,   q1,     q2,      q3,    rx,
               flags,   rx_lo,    flags_lo, rx_hi, flags_hi, n,   rb,
               d,       reach,    n_iters, epoch, own_ends ? 0 : 1, step_x,
               step_q,  theta,    x_min,  x_max,   data_factor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* params[] = {const_cast<Args*>(&a)};
  cudaLaunchAttribute attrs[2];
  set_cluster(&attrs[0], cluster);
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = config(n * cluster, smem, s, attrs, 2);
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Receive slots and flags that ring neighbours in other processes map:
// device memory of this process's current card outside any caching
// allocator (a caching allocator's segment would export the handle of the
// whole segment and lose the offset), zeroed before it is shared.
extern "C" int halo_peer_alloc(size_t bytes, void** ptr) {
  *ptr = nullptr;
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(*ptr, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(e);
}

// The IPC handle (CUDA_IPC_HANDLE_SIZE = 64 bytes) of an allocation of
// halo_peer_alloc.
extern "C" int halo_peer_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(e);
}

// Map another process's allocation from its handle (refused for one of
// this process's own).
extern "C" int halo_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int halo_peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int halo_peer_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

extern "C" int halo_peer_handle_size() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}
