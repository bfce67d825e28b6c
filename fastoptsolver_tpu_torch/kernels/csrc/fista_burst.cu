// fista_burst — n_steps FISTA iterations of the Gram-form batched lasso, one launch,
// each lane's full Q held in shared memory for the burst.
//
// Replaces the TPU kernel fastoptsolver_tpu/kernels/fista_vmem.py:_fista_tile_kernel
// (launched by _burst; the host loop of fista_vmem.fista_gram_vmem runs one launch
// per burst of check_every iterations). Semantics follow the reference's kernel and
// kernels/_common.py (fista_fixed_chunk, fista_general_chunk, fista_armijo_chunk,
// gram_rel_gap); the plain twin is fastoptsolver_tpu_torch/kernels/fista_vmem.py:
// _burst_reference. Modes: fixed momentum (beta from a global table at the absolute
// iteration k0 + i: nesterov or delta), nesterov with adaptive restart (per-lane t
// and previous step norm), greedy (per-lane tau and first-step norm, floor taumin),
// and the masked per-lane Armijo search (per-lane accepted tau, with fixed or
// restart momentum). With with_gap the per-lane relative duality gap of the final X
// is written too.
//
// Layout: Q (n, n, B), c, X, Y (n, B), per-lane rows (B,), lanes on the contiguous
// last axis. A CTA owns G lanes (a group; fista_burst_group below) and gives each
// nt = round_up(n, 32) threads, one feature each, as csrc/resident.cu does. At the
// start of the launch the group's full Grams come into shared memory once, as
// [g][k][i] with a lane stride of qs = round_up(n^2, 4) floats (36,864 bytes at n = 96,
// where G = 3; see Grouping below), by one of two routes:
// - Gather (a solve's first burst, and every launch given no slab): each thread issues
//   4-byte cp.async copies from Q, every one in flight before the first wait. A CTA's
//   lanes are G * 4 bytes of each of the n^2 planes, B * 4 bytes apart.
// - Slab (every later burst of a solve): the slab S holds lane l's Gram as the row
//   S[l][k][i] = Q[k][i][l], qs floats a lane, ceil(B / G) * G lanes, so a CTA's Grams
//   are one contiguous 16-byte-aligned block of G * qs floats, laid out as in shared
//   memory. One thread brings it in by cp.async.bulk completed on an mbarrier (as
//   csrc/qstream.cu's cluster kernel does), while the others load the rows, x, y and c.
// The first burst of a solve that has a later one writes S: once its gather has landed
// (each thread fences its writes for the async proxy before the block's barrier), one
// thread stores the CTA's block with one cp.async.bulk, which overlaps the burst's steps
// (they only read Q) and is waited for before the CTA exits. No separate pass re-lays Q.
// Every matvec of the burst (the n_steps steps, each Armijo trial, the gap)
//   out[i] = sum_k Q[k][i] * v[k]   (k ascending, over the true n, from 0)
// then reads Q from shared memory: the 32 threads of a warp read 32 consecutive
// words per k, and y or the trial point, staged per lane, is broadcast 4 floats at a
// time. Per-lane sums over features (norms, the Armijo values, the gap's terms) keep
// the order of the kernel this one replaced: for each row group r = 0..7 a partial
// over the features r, r+8, ... ascending from 0, then the eight partials in order
// from 0. Each thread stages its term in shared memory (kStage sums at a time), and
// thread 8s + r of the lane's first warp adds row group r of sum s; shuffles add the
// eight partials. So X, Y, t, ps, tau and the gap equal the per-step-streaming
// kernel's bit for bit, on either route.
//
// Bound: device memory carries each lane's Q once a launch (n^2 * B * 4 bytes: 2.0 GB at
// n = 96, B = 54144), read by the gather at a fraction of the card's rate (24-byte
// pieces of each plane) and by the slab's bulk copy as whole blocks; the first burst
// writes the slab once more. The steps read Q from shared memory, n^2 words a lane and
// a matvec, about one 128-byte wavefront a clock per SM, plus the broadcasts of v.
// A CTA fetches its Grams, then steps: its own copy-in overlaps nothing, so the SM holds
// two CTAs where it can, and one CTA's fetch runs under the other's steps (Grouping).
// The TPU kernel holds a tile's Q in VMEM for a burst in the same way. Armijo adds one
// matvec per trial round, the gap one per burst.
//
// Grouping (fista_burst_group): a block's limits give G0 lanes, as many as 232,448 bytes of
// shared memory less the mbarrier and 1024 threads hold. The launch bounds allow 64
// registers a thread (ptxas gives 63), at which an SM's 65,536 registers hold 1024
// threads; a CTA of G0 lanes has more than 512 at every n of the window, so it is alone on
// its SM. Where G0 is even and two CTAs of G0 / 2 lanes fit one SM (233,472 bytes of shared
// memory, 1,024 of them reserved a block, and 1024 threads), G = G0 / 2: the SM holds the
// same lanes as two CTAs. Where G0 is odd, two CTAs would hold fewer lanes an SM, and
// G = G0. The kernel asks for the largest shared-memory carveout, so that the card places
// both CTAs. At each n (lanes an SM: CTAs an SM times G):
//   n        1-32  33-58  59-60  61-62  63-64  65-74  75-78  79-83  84-89  90-96  97-104
//   G0         32     16     15     14     13     10      9      8      7      6       5
//   G          16      8     15      7     13      5      9      4      7      3       5
//   CTAs an SM  2      2      1      2      1      2      1      2      1      2       1
// fista_burst_ctas_per_sm(n) asks the card for the CTAs of G lanes an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the wrapper counts each launch at a
// width where it is two or more in the counter burst_paired_launches.
//
// No lane depends on its neighbours: the trial rounds of a CTA run while any of its
// lanes is unaccepted, and an accepted lane is left untouched, so the result equals
// a per-lane trial loop and the twin's batch-wide lockstep rounds at any grouping.
// Lanes >= B load zeros (the gather's, which the slab keeps), start accepted and store
// nothing; threads of features >= n compute zeros; both reach every __syncthreads.
// Offsets are 64-bit (Q holds 5.0e8 elements at full width). Built with --fmad=false
// and without --use_fast_math, so each product and sum rounds separately, as in the
// twin, and divisions and square roots are IEEE.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxN = 104;       // the burst window (fista_vmem.plan_gram_solve)
constexpr int kRows = 8;         // row groups of the per-lane sums
constexpr int kStage = 2;        // sums a lane stages in shared memory at once
constexpr int kResults = 5;      // a lane's result slots (the gap's five sums)
constexpr long long kSmemLimit = 232448;  // the shared memory a Hopper block may use
constexpr long long kSmSmem = 233472;     // a Hopper SM's shared memory
constexpr int kBlockReserve = 1024;       // the shared memory the card reserves a block
constexpr int kSmThreads = 1024;  // an SM's 65,536 registers at the launch bounds' 64 a thread
constexpr int kBarrierBytes = 16;  // the slab read's mbarrier (static shared memory)
constexpr unsigned kCopyChunk = 32768;    // bytes of one bulk copy of the slab read
constexpr int kMaxDevices = 64;
// a CTA's slab, at most a block's shared memory, fits an mbarrier's transaction count
static_assert(kSmemLimit < (1 << 20), "the slab read needs more than one mbarrier phase");

enum Mode { kFixed = 0, kRestart = 1, kGreedy = 2 };
// How the launch brings the group's Grams in: the gather from Q alone, the gather and a
// store of them to the slab, or the slab's bulk copy.
enum Slab { kGather = 0, kGatherStore = 1, kSlabRead = 2 };

struct Params {
  const float* Q;
  float* S;
  const float* c;
  const float* tau;
  const float* thr;
  const float* a2;
  const float* a1;
  const float* btb;
  const float* X;
  const float* Y;
  const float* t;
  const float* ps;
  const float* taumin;
  const float* tauv;
  const float* betas;
  float* Xo;
  float* Yo;
  float* to;
  float* pso;
  float* tauvo;
  float* gap;
  int n;
  int64_t B;
  int n_steps;
  int k0;
  int mode;
  int armijo;
  int with_gap;
  int slab;
  float restart_threshold;
  float greedy_S;
  float greedy_shrink;
  float armijo_c;
  float armijo_eta;
  int max_bt;
};

__host__ __device__ __forceinline__ int lane_threads(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ __forceinline__ int vec_floats(int n) { return (n + 3) / 4 * 4; }

// A lane's Gram stride in shared memory and in the slab: n^2 rounded up to 4 floats, so
// that a CTA's Grams are one 16-byte-aligned block a multiple of 16 bytes long.
__host__ __device__ __forceinline__ long long q_floats(int n) {
  return (static_cast<long long>(n) * n + 3) / 4 * 4;
}

// Shared floats of one lane: y and the trial point (vec_floats(n) each, so every
// lane's vectors are 16-byte aligned), the full Q (q_floats(n)), kStage staged sums of
// n terms and kResults results.
__host__ __device__ __forceinline__ long long lane_floats(int n) {
  return 2LL * vec_floats(n) + q_floats(n) + kStage * n + kResults;
}

__device__ __forceinline__ float soft_threshold(float v, float thr) {
  // sign(v) * max(|v| - thr, 0), NaN propagated as the twin's torch ops do
  const float mag = fabsf(v) - thr;
  if (mag > 0.f) return copysignf(mag, v);
  return isnan(mag) ? mag : 0.f;
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v < lo) ? lo : v;  // NaN passes through, as torch.clamp_min
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || isnan(b)) ? b : a;  // NaN wins, as torch.amax
}

// A thread's lane and feature, and the lane's shared memory.
struct Lane {
  int n, i;
  const float* Q;  // [k][i]
  float* y;        // y, the point of the gradient
  float* v;        // the trial point, then the final x
  float* T;        // [kStage][n] staged terms
  float* R;        // [kResults]
};

// Per-lane totals (or, with kMax, NaN-winning maxima) of K values over the lane's
// features f < n, in the order of the kernel this one replaced: row group r's partial
// over f = r, r+8, ... from 0, then partials r = 0..7 in order (from 0 for a sum,
// from partial 0 for a max). Every thread of the lane gets the totals.
template <int K, bool kMax = false>
__device__ __forceinline__ void lane_reduce(float (&val)[K], const Lane& L) {
  static_assert(K <= kResults, "too many sums");
#pragma unroll
  for (int q0 = 0; q0 < K; q0 += kStage) {
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (q0 + s < K && L.i < L.n) L.T[s * L.n + L.i] = val[q0 + s];
    __syncthreads();
    if (L.i < 32) {  // the lane's first warp, whole: thread 8s + r adds row group r of q0 + s
      const int s = L.i / kRows, r = L.i % kRows;
      const bool mine = s < kStage && q0 + s < K;
      float part = 0.f;
      if (mine) {
        const float* t = L.T + s * L.n;
        for (int f = r; f < L.n; f += kRows) part = kMax ? max_nan(part, t[f]) : part + t[f];
      }
      const int base = L.i - r;
      float tot = kMax ? __shfl_sync(0xffffffffu, part, base) : 0.f;
#pragma unroll
      for (int rr = kMax ? 1 : 0; rr < kRows; ++rr) {
        const float x = __shfl_sync(0xffffffffu, part, base + rr);
        tot = kMax ? max_nan(tot, x) : tot + x;
      }
      if (mine && r == 0) L.R[q0 + s] = tot;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < K; ++q) val[q] = L.R[q];
}

// out[i] = sum_k Q[k][i] * v[k] for this thread's feature i < n, k ascending; v is
// the lane's staged vector, read 4 floats at a time. The caller syncs before and after.
__device__ __forceinline__ float matvec(const Lane& L, const float* v) {
  const int n = L.n;
  const float* q = L.Q + L.i;
  float acc = 0.f;
  int k = 0;
  for (; k + 4 <= n; k += 4, q += 4 * n) {
    const float4 v4 = *reinterpret_cast<const float4*>(v + k);
    acc = acc + q[0] * v4.x;
    acc = acc + q[n] * v4.y;
    acc = acc + q[2 * n] * v4.z;
    acc = acc + q[3 * n] * v4.w;
  }
  for (; k < n; ++k, q += n) acc = acc + q[0] * v[k];
  return acc;
}

// One 4-byte asynchronous copy into shared memory; src-size 0 (valid false) reads
// nothing and fills the destination with +0.
__device__ __forceinline__ void copy_async(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kMaxThreads) fista_burst_kernel(Params p, int G) {
  __shared__ uint64_t bar;  // completes the slab read
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n;
  const int64_t B = p.B;
  const int nt = lane_threads(n), nv = vec_floats(n);
  const int tid = threadIdx.x;
  const int g = tid / nt;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * G;
  const int64_t lane = lane0 + g;
  const bool valid = lane < B;
  const int64_t qs = q_floats(n);
  float* Qs = smem + 2LL * G * nv;  // [G][qs], after the G lanes' two vectors
  Lane L;
  L.n = n;
  L.i = tid - g * nt;
  L.y = smem + 2LL * g * nv;
  L.v = L.y + nv;
  L.Q = Qs + g * qs;
  L.T = Qs + G * qs + static_cast<int64_t>(g) * kStage * n;
  L.R = Qs + G * (qs + kStage * n) + g * kResults;
  const int i = L.i;
  const bool feat = i < n;
  const bool in = valid && feat;
  // the CTA's block of the slab, and its bytes (at most a block's shared memory)
  float* const slab = p.S ? p.S + lane0 * qs : nullptr;
  const unsigned slab_bytes = static_cast<unsigned>(4 * G * qs);

  if (p.slab == kSlabRead) {
    // the group's Grams, one contiguous block, by bulk copies completed on the mbarrier
    if (tid == 0) {
      const uint32_t b = smem_addr(&bar);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(slab_bytes) : "memory");
      const char* src = reinterpret_cast<const char*>(slab);
      const uint32_t dst = smem_addr(Qs);
      for (unsigned off = 0; off < slab_bytes; off += kCopyChunk) {
        const unsigned len = slab_bytes - off < kCopyChunk ? slab_bytes - off : kCopyChunk;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(dst + off), "l"(src + off), "r"(len), "r"(b)
            : "memory");
      }
    }
  } else {
    // The group's Grams, read from device memory once: thread tid copies lane tid % G of
    // planes tid / G, tid / G + nt, ... (G divides the block, so its lane is fixed), and
    // consecutive threads read consecutive lanes of a plane.
    const int gg = tid % G;
    const int64_t ln = lane0 + gg;
    const bool ok = ln < B;
    const uint32_t dst = smem_addr(Qs + gg * qs);
    for (int pl = tid / G; pl < n * n; pl += nt)
      copy_async(dst + 4u * pl, ok ? p.Q + static_cast<int64_t>(pl) * B + ln : p.Q, ok);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // the stride's padding, stored with the Grams, is zero
    const int pad = static_cast<int>(qs) - n * n;
    if (p.slab == kGatherStore && tid < G * pad)
      Qs[(tid / pad) * qs + n * n + tid % pad] = 0.f;
  }

  auto row = [&](const float* r) { return (valid && r) ? __ldg(r + lane) : 0.f; };
  const float tau = row(p.tau), thr = row(p.thr), a2 = row(p.a2), a1 = row(p.a1);
  const float btb = row(p.btb), taumin = row(p.taumin);
  float t = row(p.t), ps = row(p.ps), tauv = row(p.tauv);
  const int64_t off = static_cast<int64_t>(i) * B + lane;
  float x = in ? __ldg(p.X + off) : 0.f;
  float y = in ? __ldg(p.Y + off) : 0.f;
  const float cf = in ? __ldg(p.c + off) : 0.f;
  if (feat) L.y[i] = y;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // this thread's gathered Grams, visible to the slab store's async proxy
  if (p.slab == kGatherStore) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (p.slab == kGatherStore && tid == 0) {
    // the group's Grams to the slab, while the steps read them
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(slab),
                 "r"(smem_addr(Qs)), "r"(slab_bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  if (p.slab == kSlabRead) {
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
          "selp.u32 %0, 1, 0, P;\n}\n"
          : "=r"(done) : "r"(smem_addr(&bar)), "r"(0u) : "memory");
    } while (!done);
  }

  for (int s = 0; s < p.n_steps; ++s) {
    const float qy = feat ? matvec(L, L.y) : 0.f;
    const float grad = qy + a2 * y - cf;
    float xn;

    if (p.armijo) {
      // g(y) = 1/2 y.Qy - c.y + 1/2 btb + 1/2 a2 |y|^2
      float sy[3] = {y * qy, cf * y, y * y};
      lane_reduce<3>(sy, L);
      const float g_y = 0.5f * sy[0] - sy[1] + 0.5f * btb + 0.5f * a2 * sy[2];
      // one trial at step tv: xt = prox(y - tv grad); ok = g(xt) <= g_y + C grad.(xt - y)
      auto trial = [&](float tv, float& xt) -> bool {
        const float th = tv * a1;
        xt = soft_threshold(y - tv * grad, th);
        if (feat) L.v[i] = xt;
        __syncthreads();
        const float qx = feat ? matvec(L, L.v) : 0.f;
        float u[4] = {xt * qx, cf * xt, xt * xt, grad * (xt - y)};
        lane_reduce<4>(u, L);  // its first sync also ends the matvec's reads of v
        const float g_x = 0.5f * u[0] - u[1] + 0.5f * btb + 0.5f * a2 * u[2];
        return g_x <= g_y + p.armijo_c * u[3];
      };
      bool acc = trial(tauv, xn) || !valid;
      int kbt = 0;
      while (__syncthreads_or(!acc) && kbt < p.max_bt) {
        const float tv = acc ? tauv : p.armijo_eta * tauv;
        float xt;
        const bool ok = trial(tv, xt);
        if (!acc) xn = xt;
        acc = acc || ok;
        tauv = tv;
        ++kbt;
      }
    } else if (p.mode == kGreedy) {
      xn = soft_threshold(y - t * grad, t * a1);
    } else {
      xn = soft_threshold(y - tau * grad, thr);
    }

    float yn;
    if (p.mode == kFixed) {
      const float beta = __ldg(p.betas + p.k0 + s);
      yn = xn + beta * (xn - x);
    } else if (p.mode == kRestart) {
      const float d = xn - x;
      float sd[1] = {d * d};
      lane_reduce<1>(sd, L);
      const float step = sqrtf(sd[0]);
      float t_next = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
      const float beta = (t - 1.f) / t_next;
      const float ratio = (ps > 0.f) ? step / clamp_min(ps, 1e-30f) : INFINITY;
      const bool restart = ratio > p.restart_threshold;
      if (restart) t_next = 1.f;
      yn = restart ? xn : xn + beta * (xn - x);
      t = t_next;
      ps = step;
    } else {  // greedy: unit momentum, gradient-mapping restart, tau safeguard
      const float d = xn - x;
      float sd[2] = {d * d, (y - xn) * d};
      lane_reduce<2>(sd, L);
      const float step = sqrtf(sd[0]);
      const bool restart = sd[1] >= 0.f;
      yn = restart ? xn : xn + (xn - x);
      if (ps == 0.f) ps = step;
      const bool grow = step > p.greedy_S * ps;
      if (grow || restart) {
        const float sh = p.greedy_shrink * t;
        t = (sh > taumin || isnan(sh)) ? sh : taumin;  // torch.maximum
      }
    }

    __syncthreads();  // every thread is done reading y
    x = xn;
    y = yn;
    if (feat) L.y[i] = y;
    __syncthreads();
  }

  float gap = 0.f;
  if (p.with_gap) {
    if (feat) L.v[i] = x;
    __syncthreads();
    const float qx = feat ? matvec(L, L.v) : 0.f;
    const float u = qx - cf + a2 * x;
    float sg[5] = {x * qx, cf * x, x * x, fabsf(x), u * u};  // xQx, cx, xx, l1, uu
    lane_reduce<5>(sg, L);
    float um[1] = {fabsf(u)};
    lane_reduce<1, true>(um, L);
    const float u_inf = um[0];
    const float rr = clamp_min(sg[0] - 2.f * sg[1] + btb, 0.f);
    const float rb = sg[1] - btb;
    const float f = 0.5f * rr + 0.5f * a2 * sg[2] + a1 * sg[3];
    const float sc = (u_inf > a1) ? a1 / clamp_min(u_inf, 1e-30f) : 1.f;
    const float dual_neg = 0.5f * (sc * sc) * rr + sc * rb + 0.5f * a2 * (sc * sc) * sg[2];
    const float l1_gap = clamp_min(f + dual_neg, 0.f);
    const float smooth_gap = sg[4] / ((a2 > 0.f) ? 2.f * a2 : 1.f);
    gap = ((a1 > 0.f) ? l1_gap : smooth_gap) / clamp_min(f, 1.f);
  }

  // the slab store has read shared memory before the CTA leaves it
  if (p.slab == kGatherStore && tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  if (!valid) return;
  if (feat) {
    p.Xo[off] = x;
    p.Yo[off] = y;
  }
  if (i == 0) {
    p.to[lane] = t;
    p.pso[lane] = ps;
    p.tauvo[lane] = tauv;
    p.gap[lane] = gap;
  }
}

// Lanes a CTA by a block's limits alone: as many as fit its shared memory less the mbarrier
// (lane_floats(n) floats each) and 1024 threads (round_up(n, 32) each).
int block_group(int n) {
  const long long by_smem = (kSmemLimit - kBarrierBytes) / (4 * lane_floats(n));
  const int by_threads = kMaxThreads / lane_threads(n);
  return by_smem < by_threads ? static_cast<int>(by_smem) : by_threads;
}

// CTAs of G lanes at n that one SM holds by its shared memory and its registers.
int sm_ctas(int n, int G) {
  const long long by_smem = kSmSmem / (4 * lane_floats(n) * G + kBarrierBytes + kBlockReserve);
  const int by_threads = kSmThreads / (G * lane_threads(n));
  return by_smem < by_threads ? static_cast<int>(by_smem) : by_threads;
}

// The dynamic shared memory a block of the kernel may take on the current device: the
// opt-in limit less the mbarrier, set on the kernel with the largest carveout at its first
// use on each device. 0 with err set where the device or an attribute call refuses.
int kernel_optin(cudaError_t& err) {
  static int optin_set[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  if (dev >= kMaxDevices) {
    err = cudaErrorInvalidValue;
    return 0;
  }
  if (optin_set[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return 0;
    if (optin > kSmemLimit) optin = static_cast<int>(kSmemLimit);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fista_burst_kernel);
    if (err != cudaSuccess) return 0;
    optin -= static_cast<int>(attr.sharedSizeBytes);  // the mbarrier
    err = cudaFuncSetAttribute(fista_burst_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return 0;
    err = cudaFuncSetAttribute(fista_burst_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return 0;
    optin_set[dev] = optin;
  }
  err = cudaSuccess;
  return optin_set[dev];
}

}  // namespace

// The burst kernel's lanes per CTA at feature count n (Grouping, in the note above): half
// of a block's lanes where they are even and two such CTAs fit an SM, else all of them;
// 16 at n <= 32, 3 at n = 96, 5 at n = 104. 0 for n outside 1..104. A launch takes
// min(this, B).
extern "C" int fista_burst_group(int n) {
  if (n < 1 || n > kMaxN) return 0;
  const int G = block_group(n);
  return G % 2 == 0 && sm_ctas(n, G) < 2 && sm_ctas(n, G / 2) >= 2 ? G / 2 : G;
}

// The dynamic shared memory, in bytes, of a CTA of fista_burst_group(n) lanes.
extern "C" long long fista_burst_smem_bytes(int n) {
  return 4 * lane_floats(n) * fista_burst_group(n);
}

// The CTAs of fista_burst_group(n) lanes that one SM of the current device holds, as the
// card reports them (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// cudaError_t of the query. 0 for n outside 1..104.
extern "C" int fista_burst_ctas_per_sm(int n) {
  if (n < 1 || n > kMaxN) return 0;
  cudaError_t err = cudaSuccess;
  if (kernel_optin(err) == 0) return -static_cast<int>(err);
  const int G = fista_burst_group(n);
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &count, fista_burst_kernel, G * lane_threads(n),
      static_cast<size_t>(fista_burst_smem_bytes(n)));
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// The floats of the slab of a solve at (n, B): ceil(B / G) * G lanes of q_floats(n),
// with G = min(fista_burst_group(n), B). 0 for n outside 1..104 or B < 1.
extern "C" long long fista_burst_slab_floats(int n, long long B) {
  const long long group = fista_burst_group(n);
  if (group == 0 || B < 1) return 0;
  const long long G = group < B ? group : B;
  return (B + G - 1) / G * G * q_floats(n);
}

// One burst. mode: 0 fixed (table beta), 1 nesterov + adaptive restart, 2 greedy;
// armijo != 0 adds the per-lane Armijo search (mode 0 or 1). Rows tau, thr, a2, a1,
// btb, t, ps, tauv are (B,); taumin may be null (greedy only); betas needs k0 +
// n_steps entries in mode 0. Outputs Xo, Yo (n, B), to, pso, tauvo, gap (B,); gap is
// 0 unless with_gap. slab: 0 gathers from Q and S is unused; 1 gathers from Q and
// stores the Grams to S; 2 reads them from S, which a launch with 1 on the same Q and
// B wrote (S holds fista_burst_slab_floats(n, B) floats, 16-byte aligned). Returns a
// cudaError_t as int: cudaErrorInvalidValue for n outside 1..104, an unknown mode or
// slab, greedy with armijo, an empty batch, a slab route without S, or a card whose
// blocks hold less shared memory than the group needs, else the first error of the
// device query, the shared-memory opt-in (made once per device) or the launch.
extern "C" int fista_burst(const float* Q, float* S, const float* c, const float* tau,
                           const float* thr, const float* a2, const float* a1,
                           const float* btb, const float* X, const float* Y, const float* t,
                           const float* ps, const float* taumin, const float* tauv,
                           const float* betas, float* Xo, float* Yo, float* to, float* pso,
                           float* tauvo, float* gap, int n, long long B, int n_steps, int k0,
                           int mode, int armijo, int with_gap, int slab,
                           float restart_threshold, float greedy_S, float greedy_shrink,
                           float armijo_c, float armijo_eta, int max_backtracks,
                           void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || n_steps < 0 || mode < kFixed || mode > kGreedy ||
      (armijo && mode == kGreedy) || (mode == kGreedy && !taumin) || slab < kGather ||
      slab > kSlabRead || (slab != kGather && !S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const int optin = kernel_optin(err);
  if (optin == 0) return static_cast<int>(err);
  const int G = fista_burst_group(n) < B ? fista_burst_group(n) : static_cast<int>(B);
  const long long smem = 4 * lane_floats(n) * G;
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Q, S, c, tau, thr, a2, a1, btb, X, Y, t, ps, taumin, tauv, betas, Xo, Yo,
                 to, pso, tauvo, gap, n, B, n_steps, k0, mode, armijo, with_gap, slab,
                 restart_threshold, greedy_S, greedy_shrink, armijo_c, armijo_eta,
                 max_backtracks};
  const unsigned grid = static_cast<unsigned>((B + G - 1) / G);
  fista_burst_kernel<<<grid, G * lane_threads(n), static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(p, G);
  return static_cast<int>(cudaGetLastError());
}
