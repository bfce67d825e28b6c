// qstream_burst — n_steps FISTA iterations of the Gram-form batched lasso, one launch; the
// wide-n engine past the resident window.
//
// Replaces the TPU kernel fastoptsolver_tpu/kernels/qstream.py:_qstream_tile_kernel
// (launched by qstream_burst; the host loop of fista_vmem._solve_on_device runs one launch
// per burst of check_every iterations). Semantics follow the reference's kernel and
// kernels/_common.py (fista_general_chunk, gram_rel_gap_from_qx); the plain twin is
// fastoptsolver_tpu_torch/kernels/qstream.py:_qstream_burst_reference. Modes: fixed
// momentum (beta from a global table at the absolute iteration k0 + i: nesterov or delta),
// nesterov with adaptive restart (per-lane t and previous step norm), greedy (per-lane tau
// and first-step norm, floor taumin). No Armijo (the reference refuses it: each trial round
// is one more matvec, a data-dependent number of them). With with_gap one more matvec gives
// Q.X and the per-lane relative duality gap of the final X is written.
//
// Two kernels, one result bit for bit.
//
// qstream_cluster_kernel (n <= ~660, where qstream_cluster_size(n) = C > 0): one lane on a
// thread-block cluster of C CTAs (C a power of two, 1..8; the portable sizes), each lane's
// Q held in shared memory for the whole launch. The TPU kernel streamed Q through VMEM
// because a lane tile's Q does not fit 16 MiB past n = 168; here one lane's Q (256 KB at
// n = 256) does not fit a block's 227 KB, so it is split over the cluster by output feature:
// CTA rank r owns features f in [r F, (r + 1) F), F = round_up(ceil(n / C), 4), one thread
// each (round_up(F, 32) threads), and holds the slab Q[k][f] of all k and its own f.
// - Copy-in: the host re-lays Q once a solve (qstream.py:relayout) as Qt[l][r][k][j] =
//   Q[k][r F + j][l], zero past n, so a CTA's slab is one contiguous 16-byte-aligned block;
//   one thread brings it in by cp.async.bulk (no tensor map) completed on an mbarrier while
//   the others load the rows, c, x and the whole y.
// - Matvec: out[f] = out[f] + Q[k][f] * y[k], k ascending from 0 over the true n, a separate
//   multiply and add (this file is built with --fmad=false): the streaming kernel's chain.
//   Every CTA holds the lane's whole y, double-buffered by step parity.
// - Exchange: after a step each CTA writes its F new y values into the next parity's buffer
//   of every CTA of the cluster (distributed shared memory), then one cluster barrier
//   (barrier.cluster arrive.release / wait.acquire). The double buffer makes a second
//   barrier needless: a buffer is rewritten only after the barrier that ends its readers'
//   step. The gap's matvec needs the whole X: each CTA writes its X values to every peer once.
// - Per-lane sums (restart's step norm, greedy's two sums, the gap's five sums and its
//   max) keep the streaming kernel's order at R = 16 row groups: row group r's partial over
//   features r, r+16, ... ascending from 0, then the 16 partials in order from 0 (the max
//   NaN-aware from row group 0's partial). Each CTA stages its terms by feature in rank 0's
//   shared memory (kStage sums at a time), a cluster barrier, 16 threads of rank 0 a sum add
//   them in that order, rank 0 writes the totals to every rank, a second barrier. Fixed
//   momentum needs no sum in a step: one barrier a step.
// So X, Y, t, ps and the gap equal qstream_kernel's bit for bit.
// Bound: device memory carries Q once a launch (n^2 B 4 bytes: 1.98 GB at n = 256,
// B = 7552, >= 0.59 ms at 3.35 TB/s); each matvec reads the slab from shared memory, n F
// words a CTA, one 128-byte wavefront a warp and a k, about one wavefront a clock an SM,
// plus the broadcasts of y. Smaller slabs let several CTAs share an SM, so one CTA's
// copy-in overlaps another's steps.
//
// qstream_kernel (past the cluster window, to n = 1016): Q streamed from device memory
// every step. A CTA owns LT lanes (threadIdx.x) and R row groups (threadIdx.y), 512
// threads: (LT, R) = (32, 16) while X and Y of 32 lanes fit in shared memory (n <= 868),
// else (16, 32). Thread (lane, r) accumulates the matvec of features r, r+R, ... (J of
// them, a template constant, J >= n/R) in registers with the chain above, so each k issues
// J independent loads, and a warp's loads of one (k, f) are one 128-byte line (LT = 32) or
// two 64-byte pieces (LT = 16). X and Y of the CTA's lanes live in shared memory, the
// matvec reads Y there, and c is re-read from device memory (n B floats a step, served by
// L2). Bound: n^2 B 4 bytes of Q a step and one more pass for the gap. Per-lane sums over
// features add each thread's partials, then the R row groups in order, through shared memory.
//
// No lane depends on its neighbours. Lanes >= B (the streaming kernel's ragged CTA) load
// zeros and store nothing; threads of features >= n compute nothing; both reach every
// barrier. Offsets are 64-bit. Built without --use_fast_math: the divisions and square
// roots are IEEE.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kSums = 5;
constexpr int kMaxN = 1016;  // the reference's auto_tiles_qstream window (n_pad <= 1016)

enum Mode { kFixed = 0, kRestart = 1, kGreedy = 2 };

struct Params {
  const float* Q;
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
  const float* betas;
  float* Xo;
  float* Yo;
  float* to;
  float* pso;
  float* gap;
  int n;
  int64_t B;
  int n_steps;
  int k0;
  int mode;
  int with_gap;
  float restart_threshold;
  float greedy_S;
  float greedy_shrink;
};

__device__ __forceinline__ float soft_threshold(float v, float thr) {
  // sign(v) * max(|v| - thr, 0), NaN propagated as the twin's torch ops do
  const float mag = fabsf(v) - thr;
  if (mag > 0.f) return copysignf(mag, v);
  return isnan(mag) ? mag : 0.f;
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v < lo) ? lo : v;  // NaN passes through, as torch.clamp_min
}

// Per-lane totals of K partial sums over the R row groups, added in order; every thread
// of the lane gets them. red holds kSums * R * LT floats.
template <int K, int LT, int R>
__device__ __forceinline__ void lane_sums(float (&v)[K], float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int q = 0; q < K; ++q) red[(q * R + ty) * LT + tx] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += red[(q * R + r) * LT + tx];
    v[q] = s;
  }
  __syncthreads();
}

template <int LT, int R>
__device__ __forceinline__ float lane_max(float v, float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  red[ty * LT + tx] = v;
  __syncthreads();
  float m = red[tx];
  for (int r = 1; r < R; ++r) {
    const float x = red[r * LT + tx];
    m = (x > m || isnan(x)) ? x : m;  // NaN wins, as torch.amax
  }
  __syncthreads();
  return m;
}

// out[j] = sum_k Q[k][f_j] * vs[k] for this thread's features f_j = ty + R j, streamed from
// device memory. vs is [n][LT] in shared memory; the caller syncs before and after.
template <int J, int LT, int R>
__device__ __forceinline__ void matvec(const float* __restrict__ Q, const float* vs, int n,
                                       int64_t B, int64_t lane, bool valid, float (&out)[J]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < J; ++j) out[j] = 0.f;
  if (!valid) return;
  for (int k = 0; k < n; ++k) {
    const float vk = vs[k * LT + tx];
    const float* Qk = Q + static_cast<int64_t>(k) * n * B + lane;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = ty + j * R;
      if (f < n) out[j] = out[j] + __ldg(Qk + static_cast<int64_t>(f) * B) * vk;
    }
  }
}

template <int J, int LT, int R>
__global__ void __launch_bounds__(kThreads) qstream_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n;
  const int64_t B = p.B;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * LT + tx;
  const bool valid = lane < B;
  float* Ys = smem;             // [n][LT]: Y, the point of the gradient
  float* Xs = Ys + n * LT;      // [n][LT]: X
  float* red = Xs + n * LT;     // [kSums][R][LT]

  auto row = [&](const float* r) { return (valid && r) ? __ldg(r + lane) : 0.f; };
  const float tau = row(p.tau), thr = row(p.thr), a2 = row(p.a2), a1 = row(p.a1);
  const float btb = row(p.btb), taumin = row(p.taumin);
  float t = row(p.t), ps = row(p.ps);

  for (int f = ty; f < n; f += R) {
    const int64_t off = static_cast<int64_t>(f) * B + lane;
    Xs[f * LT + tx] = valid ? __ldg(p.X + off) : 0.f;
    Ys[f * LT + tx] = valid ? __ldg(p.Y + off) : 0.f;
  }
  __syncthreads();

  float acc[J];
  for (int s = 0; s < p.n_steps; ++s) {
    matvec<J, LT, R>(p.Q, Ys, n, B, lane, valid, acc);
    // acc[j] becomes the new x of feature f_j; the sums the momentum needs ride along
    float sd[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = ty + j * R;
      if (f >= n) continue;
      const float y = Ys[f * LT + tx];
      const float x = Xs[f * LT + tx];
      const float cf = valid ? __ldg(p.c + static_cast<int64_t>(f) * B + lane) : 0.f;
      const float grad = acc[j] + a2 * y - cf;
      const float xn = (p.mode == kGreedy) ? soft_threshold(y - t * grad, t * a1)
                                           : soft_threshold(y - tau * grad, thr);
      const float d = xn - x;
      sd[0] += d * d;
      sd[1] += (y - xn) * d;
      acc[j] = xn;
    }
    float beta = 0.f;
    bool restart = false;
    if (p.mode == kFixed) {
      beta = __ldg(p.betas + p.k0 + s);
      __syncthreads();  // every thread is done reading Ys
    } else if (p.mode == kRestart) {
      float s1[1] = {sd[0]};
      lane_sums<1, LT, R>(s1, red);
      const float step = sqrtf(s1[0]);
      float t_next = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
      beta = (t - 1.f) / t_next;
      const float ratio = (ps > 0.f) ? step / clamp_min(ps, 1e-30f) : INFINITY;
      restart = ratio > p.restart_threshold;
      if (restart) t_next = 1.f;
      t = t_next;
      ps = step;
    } else {  // greedy: unit momentum, gradient-mapping restart, tau safeguard
      lane_sums<2, LT, R>(sd, red);
      const float step = sqrtf(sd[0]);
      restart = sd[1] >= 0.f;
      beta = 1.f;
      if (ps == 0.f) ps = step;
      const bool grow = step > p.greedy_S * ps;
      if (grow || restart) {
        const float sh = p.greedy_shrink * t;
        t = (sh > taumin || isnan(sh)) ? sh : taumin;  // torch.maximum
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = ty + j * R;
      if (f >= n) continue;
      const float xn = acc[j];
      const float x = Xs[f * LT + tx];
      // greedy's unit momentum is xn + (xn - x), which beta = 1 multiplies exactly
      Ys[f * LT + tx] = restart ? xn : xn + beta * (xn - x);
      Xs[f * LT + tx] = xn;
    }
    __syncthreads();
  }

  float gap = 0.f;
  if (p.with_gap) {
    matvec<J, LT, R>(p.Q, Xs, n, B, lane, valid, acc);
    float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};  // xQx, cx, xx, l1, uu
    float u_inf = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = ty + j * R;
      if (f >= n) continue;
      const float x = Xs[f * LT + tx];
      const float cf = valid ? __ldg(p.c + static_cast<int64_t>(f) * B + lane) : 0.f;
      s[0] += x * acc[j];
      s[1] += cf * x;
      s[2] += x * x;
      s[3] += fabsf(x);
      const float u = acc[j] - cf + a2 * x;
      s[4] += u * u;
      const float au = fabsf(u);
      u_inf = (au > u_inf || isnan(au)) ? au : u_inf;
    }
    lane_sums<kSums, LT, R>(s, red);
    u_inf = lane_max<LT, R>(u_inf, red);
    const float rr = clamp_min(s[0] - 2.f * s[1] + btb, 0.f);
    const float rb = s[1] - btb;
    const float f = 0.5f * rr + 0.5f * a2 * s[2] + a1 * s[3];
    const float sc = (u_inf > a1) ? a1 / clamp_min(u_inf, 1e-30f) : 1.f;
    const float dual_neg = 0.5f * (sc * sc) * rr + sc * rb + 0.5f * a2 * (sc * sc) * s[2];
    const float l1_gap = clamp_min(f + dual_neg, 0.f);
    const float smooth_gap = s[4] / ((a2 > 0.f) ? 2.f * a2 : 1.f);
    gap = ((a1 > 0.f) ? l1_gap : smooth_gap) / clamp_min(f, 1.f);
  }

  if (!valid) return;
  for (int f = ty; f < n; f += R) {
    const int64_t off = static_cast<int64_t>(f) * B + lane;
    p.Xo[off] = Xs[f * LT + tx];
    p.Yo[off] = Ys[f * LT + tx];
  }
  if (ty == 0) {
    p.to[lane] = t;
    p.pso[lane] = ps;
    p.gap[lane] = gap;
  }
}

template <int LT, int R>
size_t smem_bytes(int n) {
  return (2 * static_cast<size_t>(n) + kSums * R) * LT * sizeof(float);
}

template <int J, int LT, int R>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<LT, R>(p.n);
  cudaError_t err = cudaFuncSetAttribute(
      qstream_kernel<J, LT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((p.B + LT - 1) / LT);
  qstream_kernel<J, LT, R><<<grid, dim3(LT, R), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// (LT, R) = (32, 16): J = ceil(n / 16) rounded up to a power of two. (16, 32) serves
// only 868 < n <= 1016, where J = 32.
int launch_j(const Params& p, cudaStream_t stream) {
  const int need = (p.n + 15) / 16;  // features per thread at R = 16
  if (need <= 1) return launch<1, 32, 16>(p, stream);
  if (need <= 2) return launch<2, 32, 16>(p, stream);
  if (need <= 4) return launch<4, 32, 16>(p, stream);
  if (need <= 8) return launch<8, 32, 16>(p, stream);
  if (need <= 16) return launch<16, 32, 16>(p, stream);
  if (need <= 32) return launch<32, 32, 16>(p, stream);
  return launch<64, 32, 16>(p, stream);
}

// Lanes per CTA at feature count n: 32 while X and Y of 32 lanes fit the card's opt-in
// shared memory per block (227 KB on the H100: n <= 868), else 16.
int lanes_per_cta(int n, int optin) {
  return smem_bytes<32, 16>(n) <= static_cast<size_t>(optin) ? 32 : 16;
}


// ---- the cluster kernel ----

namespace cg = cooperative_groups;

constexpr int kRowGroups = 16;     // the streaming kernel's R at n <= 868: the sums' order
constexpr int kStage = 2;          // sums staged in rank 0's shared memory at once
constexpr int kHeader = 8;         // floats before the slab: the mbarrier (2) and kStage totals
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kTargetF = 64;       // features a CTA the size rule aims at
constexpr int kClusterThreads = 256;
constexpr long long kSmemLimit = 232448;  // the shared memory a Hopper block may use
constexpr unsigned kCopyChunk = 32768;     // bytes of one bulk copy
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int vec_floats(int n) { return (n + 3) / 4 * 4; }

// F: the features of a CTA of a C-CTA cluster, a multiple of 4 so that every slab row and
// every slab is 16-byte aligned (qstream.py:slab_features is the same formula).
__host__ __device__ __forceinline__ int slab_features(int n, int C) {
  return ((n + C - 1) / C + 3) / 4 * 4;
}

// A CTA's shared floats: the header, the slab (n F), the two y buffers and kStage staged
// sums (vec_floats(n) each).
__host__ __device__ __forceinline__ long long cta_floats(int n, int C) {
  return kHeader + static_cast<long long>(n) * slab_features(n, C) +
         static_cast<long long>(2 + kStage) * vec_floats(n);
}

__host__ __device__ __forceinline__ int cta_threads(int n, int C) {
  return (slab_features(n, C) + 31) / 32 * 32;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || isnan(b)) ? b : a;  // NaN wins, as torch.amax
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A thread's place in its cluster and the CTA's shared memory.
struct Cta {
  int n, F, C, nv, rank, f;
  bool feat;      // f < n: this thread owns a feature
  const float* Q;  // [k][j] the slab
  float* y;        // [2][nv] the whole y (or X before the gap), by parity
  float* T;        // [kStage][nv] staged terms, read on rank 0
  float* R;        // [kStage] totals
};

// Per-lane totals (or, with kMax, NaN-winning maxima) of K values over the lane's
// features f < n in the streaming kernel's order: row group r's partial over f = r, r+16,
// ... from 0, then partials r = 0..15 in order (from 0 for a sum, from partial 0 for a
// max). Every thread of the cluster gets the totals.
template <int K, bool kMax = false>
__device__ __forceinline__ void cluster_reduce(float (&val)[K], const Cta& c) {
#pragma unroll
  for (int q0 = 0; q0 < K; q0 += kStage) {
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (q0 + s < K && c.feat)
        *cg::this_cluster().map_shared_rank(c.T + s * c.nv + c.f, 0) = val[q0 + s];
    cg::this_cluster().sync();
    if (c.rank == 0 && threadIdx.x < kStage * kRowGroups) {  // warp 0: 16 threads a sum
      const int s = threadIdx.x / kRowGroups, r = threadIdx.x % kRowGroups;
      const bool mine = q0 + s < K;
      float part = 0.f;
      if (mine) {
        const float* t = c.T + s * c.nv;
        for (int f = r; f < c.n; f += kRowGroups) part = kMax ? max_nan(part, t[f]) : part + t[f];
      }
      const int base = threadIdx.x - r;
      float tot = kMax ? __shfl_sync(0xffffffffu, part, base) : 0.f;
#pragma unroll
      for (int rr = kMax ? 1 : 0; rr < kRowGroups; ++rr) {
        const float x = __shfl_sync(0xffffffffu, part, base + rr);
        tot = kMax ? max_nan(tot, x) : tot + x;
      }
      if (mine && r == 0)
        for (int d = 0; d < c.C; ++d) *cg::this_cluster().map_shared_rank(c.R + s, d) = tot;
    }
    cg::this_cluster().sync();
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (q0 + s < K) val[q0 + s] = c.R[s];
  }
}

// out = sum_k Q[k][j] * v[k] for this thread's slab column j, k ascending from 0; v is the
// whole vector in this CTA's shared memory, read 4 floats at a time. Eight k a body,
// unrolled twice, so the next body's slab loads are in flight while the add chain runs
// (a body of 4 or 16 k, or deeper unrolling, ran slower on the H100: PERF.md section 6).
__device__ __forceinline__ float slab_matvec(const Cta& c, const float* v) {
  const int n = c.n, F = c.F;
  const float* q = c.Q + threadIdx.x;
  float acc = 0.f;
  int k = 0;
#pragma unroll 2
  for (; k + 8 <= n; k += 8, q += 8 * F) {
    const float4 va = *reinterpret_cast<const float4*>(v + k);
    const float4 vb = *reinterpret_cast<const float4*>(v + k + 4);
    const float q0 = q[0], q1 = q[F], q2 = q[2 * F], q3 = q[3 * F];
    const float q4 = q[4 * F], q5 = q[5 * F], q6 = q[6 * F], q7 = q[7 * F];
    acc = acc + q0 * va.x;
    acc = acc + q1 * va.y;
    acc = acc + q2 * va.z;
    acc = acc + q3 * va.w;
    acc = acc + q4 * vb.x;
    acc = acc + q5 * vb.y;
    acc = acc + q6 * vb.z;
    acc = acc + q7 * vb.w;
  }
  for (; k + 4 <= n; k += 4, q += 4 * F) {
    const float4 v4 = *reinterpret_cast<const float4*>(v + k);
    acc = acc + q[0] * v4.x;
    acc = acc + q[F] * v4.y;
    acc = acc + q[2 * F] * v4.z;
    acc = acc + q[3 * F] * v4.w;
  }
  for (; k < n; ++k, q += F) acc = acc + q[0] * v[k];
  return acc;
}

// Write this thread's value of feature f into buf[f] of every CTA of the cluster.
__device__ __forceinline__ void share(const Cta& c, float* buf, float v) {
  if (!c.feat) return;
  for (int d = 0; d < c.C; ++d) *cg::this_cluster().map_shared_rank(buf + c.f, d) = v;
}

__global__ void __launch_bounds__(kClusterThreads)
    qstream_cluster_kernel(Params p, const float* __restrict__ Qt, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n;
  const int64_t B = p.B;
  Cta c;
  c.n = n;
  c.C = C;
  c.F = slab_features(n, C);
  c.nv = vec_floats(n);
  c.rank = static_cast<int>(cg::this_cluster().block_rank());
  c.f = c.rank * c.F + threadIdx.x;
  c.feat = static_cast<int>(threadIdx.x) < c.F && c.f < n;
  c.R = smem + 2;
  float* slab = smem + kHeader;
  c.Q = slab;
  c.y = slab + static_cast<int64_t>(n) * c.F;
  c.T = c.y + 2 * c.nv;
  const int64_t lane = blockIdx.x / C;  // 1-D clusters of C consecutive CTAs
  const uint32_t bar = smem_addr(smem);

  // the slab, one contiguous block, by bulk copies completed on the mbarrier
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned bytes = 4u * static_cast<unsigned>(n) * static_cast<unsigned>(c.F);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes) : "memory");
    const char* src = reinterpret_cast<const char*>(
        Qt + (lane * C + c.rank) * static_cast<int64_t>(n) * c.F);
    const uint32_t dst = smem_addr(slab);
    for (unsigned off = 0; off < bytes; off += kCopyChunk) {
      const unsigned len = bytes - off < kCopyChunk ? bytes - off : kCopyChunk;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst + off), "l"(src + off), "r"(len), "r"(bar)
          : "memory");
    }
  }

  const float tau = __ldg(p.tau + lane), thr = __ldg(p.thr + lane);
  const float a2 = __ldg(p.a2 + lane), a1 = __ldg(p.a1 + lane), btb = __ldg(p.btb + lane);
  const float taumin = p.taumin ? __ldg(p.taumin + lane) : 0.f;
  float t = __ldg(p.t + lane), ps = __ldg(p.ps + lane);
  const int64_t off = static_cast<int64_t>(c.f) * B + lane;
  float x = c.feat ? __ldg(p.X + off) : 0.f;
  float y = c.feat ? __ldg(p.Y + off) : 0.f;
  const float cf = c.feat ? __ldg(p.c + off) : 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    c.y[k] = __ldg(p.Y + static_cast<int64_t>(k) * B + lane);
  {
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
          "selp.u32 %0, 1, 0, P;\n}\n"
          : "=r"(done) : "r"(bar), "r"(0u) : "memory");
    } while (!done);
  }
  cg::this_cluster().sync();  // every CTA has started (before any remote write) and holds y

  for (int s = 0; s < p.n_steps; ++s) {
    const float qy = c.feat ? slab_matvec(c, c.y + (s & 1) * c.nv) : 0.f;
    const float grad = qy + a2 * y - cf;
    const float xn = (p.mode == kGreedy) ? soft_threshold(y - t * grad, t * a1)
                                         : soft_threshold(y - tau * grad, thr);
    const float d = xn - x;
    float beta = 0.f;
    bool restart = false;
    if (p.mode == kFixed) {
      beta = __ldg(p.betas + p.k0 + s);
    } else if (p.mode == kRestart) {
      float s1[1] = {d * d};
      cluster_reduce<1>(s1, c);
      const float step = sqrtf(s1[0]);
      float t_next = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
      beta = (t - 1.f) / t_next;
      const float ratio = (ps > 0.f) ? step / clamp_min(ps, 1e-30f) : INFINITY;
      restart = ratio > p.restart_threshold;
      if (restart) t_next = 1.f;
      t = t_next;
      ps = step;
    } else {  // greedy: unit momentum, gradient-mapping restart, tau safeguard
      float sd[2] = {d * d, (y - xn) * d};
      cluster_reduce<2>(sd, c);
      const float step = sqrtf(sd[0]);
      restart = sd[1] >= 0.f;
      beta = 1.f;
      if (ps == 0.f) ps = step;
      const bool grow = step > p.greedy_S * ps;
      if (grow || restart) {
        const float sh = p.greedy_shrink * t;
        t = (sh > taumin || isnan(sh)) ? sh : taumin;  // torch.maximum
      }
    }
    // greedy's unit momentum is xn + (xn - x), which beta = 1 multiplies exactly
    y = restart ? xn : xn + beta * (xn - x);
    x = xn;
    share(c, c.y + ((s + 1) & 1) * c.nv, y);
    cg::this_cluster().sync();
  }

  float gap = 0.f;
  if (p.with_gap) {
    // the buffer the last step read: every CTA passed the barrier after reading it
    float* xs = c.y + ((p.n_steps + 1) & 1) * c.nv;
    share(c, xs, x);
    cg::this_cluster().sync();
    const float qx = c.feat ? slab_matvec(c, xs) : 0.f;
    const float u = qx - cf + a2 * x;
    float sg[kSums] = {x * qx, cf * x, x * x, fabsf(x), u * u};  // xQx, cx, xx, l1, uu
    cluster_reduce<kSums>(sg, c);
    float um[1] = {fabsf(u)};
    cluster_reduce<1, true>(um, c);
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

  if (c.feat) {
    p.Xo[off] = x;
    p.Yo[off] = y;
  }
  if (c.rank == 0 && threadIdx.x == 0) {
    p.to[lane] = t;
    p.pso[lane] = ps;
    p.gap[lane] = gap;
  }
  cg::this_cluster().sync();  // no CTA leaves while a peer may still touch its shared memory
}

bool valid_cluster(int C) { return C == 1 || C == 2 || C == 4 || C == 8; }

// The opt-in shared-memory limit of the current device, set on the cluster kernel at its
// first use there; 0 after an error (err says which).
int cluster_optin(cudaError_t& err) {
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
    err = cudaFuncSetAttribute(qstream_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return 0;
    optin_set[dev] = optin;
  }
  return optin_set[dev];
}

// The launch configuration of a cluster launch at (n, C) over `clusters` lanes.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int n, int C, long long clusters, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * C));
    cfg.blockDim = dim3(static_cast<unsigned>(cta_threads(n, C)));
    cfg.dynamicSmemBytes = static_cast<size_t>(4 * cta_floats(n, C));
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(C);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of size C at width n the current device can hold at once (> 0), or the
// cudaError_t that refuses the launch.
cudaError_t active_clusters(int n, int C, int& count) {
  count = 0;
  if (n < 1 || n > kMaxN || !valid_cluster(C)) return cudaErrorInvalidValue;
  cudaError_t err;
  const int optin = cluster_optin(err);
  if (optin == 0) return err;
  if (4 * cta_floats(n, C) > optin) return cudaErrorInvalidValue;
  ClusterLaunch L(n, C, 1, nullptr);
  err = cudaOccupancyMaxActiveClusters(&count, qstream_cluster_kernel, &L.cfg);
  if (err != cudaSuccess) return err;
  return count > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// The cluster size of the Q-streaming engine at feature count n: the smallest power of two
// C <= 8 with ceil(n / C) <= 64 features a CTA (8 past n = 512), or 0 where a lane's Q does
// not fit the shared memory of 8 CTAs (232,448 bytes each: n > 660) or n is outside
// 1..1016. There the streaming kernel serves.
extern "C" int qstream_cluster_size(int n) {
  if (n < 1 || n > kMaxN) return 0;
  int C = 1;
  while (C < kMaxCluster && (n + C - 1) / C > kTargetF) C *= 2;
  return 4 * cta_floats(n, C) <= kSmemLimit ? C : 0;
}

// The dynamic shared memory, in bytes, of one CTA of the cluster kernel at n with cluster
// size C; 0 where C is not a cluster size (0: the streaming kernel).
extern "C" long long qstream_smem_bytes(int n, int C) {
  if (n < 1 || n > kMaxN || !valid_cluster(C)) return 0;
  return 4 * cta_floats(n, C);
}

// The clusters of size C at width n the current device holds at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t that refuses such a launch.
extern "C" int qstream_active_clusters(int n, int C) {
  int count = 0;
  const cudaError_t err = active_clusters(n, C, count);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// One burst. cluster: 0 launches the streaming kernel on Q; 1, 2, 4 or 8 the cluster
// kernel of that size on Qt (qstream.py:relayout of Q at that size; Q is not read). The
// wrapper passes qstream_cluster_size(n). mode: 0 fixed (table beta), 1 nesterov +
// adaptive restart, 2 greedy. Rows tau, thr, a2, a1, btb, t, ps are (B,); taumin may be
// null (greedy only); betas needs k0 + n_steps entries in mode 0. Outputs Xo, Yo (n, B),
// to, pso, gap (B,); gap is 0 unless with_gap. Returns a cudaError_t as int:
// cudaErrorInvalidValue for n outside 1..1016, an unknown mode or cluster size, greedy
// without taumin, an empty batch, a missing or unaligned Qt, too many CTAs for one grid,
// or shared memory past the card's block limit; cudaErrorInvalidConfiguration where the
// card holds no cluster of that size; else cudaGetLastError() after the launch.
extern "C" int qstream_burst(const float* Q, const float* Qt, const float* c, const float* tau,
                             const float* thr, const float* a2, const float* a1,
                             const float* btb, const float* X, const float* Y, const float* t,
                             const float* ps, const float* taumin, const float* betas,
                             float* Xo, float* Yo, float* to, float* pso, float* gap, int n,
                             long long B, int n_steps, int k0, int mode, int with_gap,
                             int cluster, float restart_threshold, float greedy_S,
                             float greedy_shrink, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || n_steps < 0 || mode < kFixed || mode > kGreedy ||
      (mode == kGreedy && !taumin))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Q,  c,   tau, thr, a2,  a1,  btb, X,       Y,       t,
                 ps, taumin, betas, Xo, Yo, to, pso, gap, n, B, n_steps, k0, mode,
                 with_gap, restart_threshold, greedy_S, greedy_shrink};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster != 0) {
    if (!valid_cluster(cluster) || !Qt || reinterpret_cast<uintptr_t>(Qt) % 16 != 0 ||
        B * cluster > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    int count = 0;
    cudaError_t err = active_clusters(n, cluster, count);
    if (err != cudaSuccess) return static_cast<int>(err);
    ClusterLaunch L(n, cluster, B, s);
    err = cudaLaunchKernelEx(&L.cfg, qstream_cluster_kernel, p, Qt, cluster);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lt = lanes_per_cta(n, optin);
  const size_t smem = lt == 32 ? smem_bytes<32, 16>(n) : smem_bytes<16, 32>(n);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  return lt == 32 ? launch_j(p, s) : launch<32, 16, 32>(p, s);
}
