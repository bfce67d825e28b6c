// resident_solve — the whole certified solve of the Gram-form batched lasso, one launch,
// each group's Gram held in shared memory for the whole solve.
//
// Replaces the TPU kernel fastoptsolver_tpu/kernels/resident.py:_resident_tile_kernel
// (launched by _run_resident), and through the entry fista_vmem.fista_gram_vmem_adaptive
// also fastoptsolver_tpu/kernels/fista_vmem.py:_fista_tile_kernel_adaptive (the same
// certified loop against a given L, no Armijo, no state). Semantics follow the reference's
// kernels/_common.py (certified_solve_body, fista_general_chunk, fista_armijo_chunk,
// power_lambda_max, gram_rel_gap); the plain twin is
// fastoptsolver_tpu_torch/kernels/resident.py:fista_gram_resident_reference.
//
// Per CTA, G lanes (a group; resident_group below, whose rule resident.group_lanes repeats
// for the twin on the CPU): the upper triangles of their Grams are copied into shared
// memory once (n(n+1)/2 floats a lane: 33 KB at n = 128, 56.8 KB at
// n = 168, so G = 6 and 3 there), then optionally est_l_iters power steps from c estimate
// L (L = 1.02*lambda, 1 where lambda = 0, + a2; tau = t_init/L), then the certified loop
// runs: bursts of `chunk` FISTA steps in any mode (fixed table beta at the absolute
// iteration, nesterov with adaptive restart, greedy, or the masked per-lane Armijo search
// with fixed or restart momentum), the per-lane relative duality gap, the non-finite
// quarantine, the greedy stuck-lane shrink, and the exit once every lane of the group is
// done or k reaches k_end. Certified lanes keep iterating until their group exits, so x
// depends on G; the twin takes the grouping as b_tile.
//
// Layout: features on threads, lanes of the group on thread blocks of nt = round_up(n, 32)
// threads (whole warps, so a lane's sums over features are warp shuffles and then a sum
// over its nt/32 warps in order). Thread (g, i) holds x, y, c of feature i of lane g in
// registers. Shared memory holds first the vectors, y (the power iterate) and the trial
// point, round_up(n, 4) floats each and 16-byte aligned, then the lanes' triangles, then
// the reduction scratch. The matvec out[i] = sum_k Q[k][i] v[k] is tri_matvec.cuh's, shared
// with gram_build.cu's gram_power: k ascending over the true n with a separate multiply and
// add (this file is built with --fmad=false, as the twin's make_matvec rounds), v read as
// 16-byte broadcasts, the triangle walked in warp-uniform segments with a per-term select
// only inside each warp's diagonal block. The upper triangle is authoritative: Q[k][i] for k > i is read as Q[i][k], where the
// reference reads the full Q. The two agree on a bit-symmetric Gram, which the port's
// builds give; the twin reads the same triangle, so kernel and twin agree on any Q.
//
// Bound: the matvec's shared-memory reads. A matvec reads n^2 words a lane of the
// triangle (5.0e8 words a step at n = 128, B = 30464): ~2.4e7 lane-matvecs at that
// shape (96 power steps, the steps each group runs, a gap every 25) are ~1.6 TB, 48-60 ms
// at 128 B a clock on 132 SMs. Counted from the kernel's addresses, a warp's triangle read
// costs 1.23 wavefronts on average at n = 128 (1.30 at 96, 1.63 at 112, never more than 3),
// so bank conflicts are not the main cost; the v load a term (one more wavefront, the same
// word for every thread) and the select's instructions were, and the walk removes the load
// and, outside each warp's diagonal block, the select. Measured on an H100 80GB HBM3 at
// 700 W, in turns with the select-every-term walk: the solve at that shape 135.1 ms
// against 180.4, 4.3 us a CTA-step against 5.7 (~12 TB/s of Q from shared memory), still
// about twice the floor; ptxas spills 36 bytes at the 64-register cap of 1024 threads.
// Device memory is read once: the copy-in, 2.0 GB at that shape, a strided gather (Q is
// lane-last, so a group's G lanes are G*4 bytes of a 32-byte sector; neighbouring groups
// share the sector through L2). That is the TPU design (Q read once per solve) in a
// smaller tile: the TPU held 128 lanes' full Q in 15 MiB of VMEM, a Hopper block holds a
// few lanes' triangles in 227 KB.
//
// Lanes >= B load zeros, start done and store nothing; threads of features >= n compute
// zeros; both reach every __syncthreads. The group's k is uniform (the wrapper checks a
// resumed state) and is read from its first lane. Offsets are 64-bit. Built without
// --use_fast_math: the divisions and square roots are IEEE.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tri_matvec.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxGroup = 32;  // resident.MAX_GROUP
constexpr int kSums = 6;       // resident.N_SUMS
constexpr int kMaxN = 168;     // resident.MAX_N
constexpr int kMatvecUnroll = 4;  // terms a body of tri_matvec.cuh's walk: the faster here

enum Mode { kFixed = 0, kRestart = 1, kGreedy = 2 };

struct Params {
  const float* Q;
  const float* c;
  const float* tau;
  const float* thr;
  const float* a2;
  const float* a1;
  const float* btb;
  const float* taumin;
  const float* betas;
  const float* X0;
  const float* Y0;
  const float* t0;
  const float* ps0;
  const float* tv0;
  const int* k0;
  const int* done0;
  const int* iters0;
  const float* gap0;
  float* X;
  float* Y;
  float* t;
  float* ps;
  float* tv;
  int* k;
  int* done;
  int* iters;
  float* gap;
  int n;
  int64_t B;
  int G;
  int chunk;
  int k_end;
  float tol;
  int mode;
  int armijo;
  float restart_threshold;
  float greedy_S;
  float greedy_shrink;
  float armijo_c;
  float armijo_eta;
  int max_bt;
  int est_l_iters;
  float l_safety;
  float t_init;
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

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || isnan(b)) ? b : a;  // NaN wins, as torch.maximum / amax
}

// The thread's place: lane g of the group, feature i of the lane, warp wl of the lane.
struct Place {
  int g, i, W, wl;
  float* red;  // [G][W][kSums]
};

// Per-lane totals of K partial sums over the lane's features: a butterfly inside each warp
// (every thread ends with the same value), then the lane's W warps in order. Every thread
// of the lane gets the totals.
template <int K>
__device__ __forceinline__ void lane_sums(float (&v)[K], const Place& pl) {
#pragma unroll
  for (int q = 0; q < K; ++q)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
  float* r = pl.red + static_cast<int64_t>(pl.g) * pl.W * kSums;
  if ((pl.i & 31) == 0)
#pragma unroll
    for (int q = 0; q < K; ++q) r[pl.wl * kSums + q] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float s = 0.f;
    for (int w = 0; w < pl.W; ++w) s += r[w * kSums + q];
    v[q] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float lane_max(float v, const Place& pl) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  float* r = pl.red + static_cast<int64_t>(pl.g) * pl.W * kSums;
  if ((pl.i & 31) == 0) r[pl.wl * kSums] = v;
  __syncthreads();
  float m = r[0];
  for (int w = 1; w < pl.W; ++w) m = max_nan(m, r[w * kSums]);
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kMaxThreads) resident_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n;
  const int nt = (n + 31) / 32 * 32;
  const int G = p.G;
  const int npairs = tri::npairs(n);
  const int n4 = tri::vec_stride(n);
  const int64_t B = p.B;
  const int tid = threadIdx.x;
  Place pl;
  pl.g = tid / nt;
  pl.i = tid % nt;
  pl.W = nt / 32;
  pl.wl = pl.i / 32;
  pl.red = smem + static_cast<int64_t>(G) * (2 * n4 + npairs);
  const int g = pl.g, i = pl.i;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * G;
  const int64_t lane = lane0 + g;
  const bool valid = lane < B;
  const bool feat = i < n;
  const bool in = valid && feat;
  const int64_t off = static_cast<int64_t>(i) * B + lane;
  // [G][2][n4] vectors (16-byte aligned), then [G][npairs] triangles, then red
  float* vy = smem + 2 * g * n4;  // y, the power iterate
  float* vx = vy + n4;            // trial point, x
  float* T0 = smem + 2 * G * n4;
  const float* T = T0 + static_cast<int64_t>(g) * npairs;

  // the upper triangles of the group's Grams, read from device memory once
  tri::copy_in(T0, p.Q, n, B, lane0, G);
  auto row = [&](const float* rr) { return valid ? __ldg(rr + lane) : 0.f; };
  const float a1 = row(p.a1), a2 = row(p.a2), btb = row(p.btb);
  float tau = row(p.tau), thr = row(p.thr), taumin = row(p.taumin);
  const float cf = in ? __ldg(p.c + off) : 0.f;
  __syncthreads();

  if (p.est_l_iters > 0) {
    // power steps from v0 = c / max(|c|, 1e-30): w = Qv, lam = |w|, v = w / max(lam, 1e-30)
    float s[1] = {cf * cf};
    lane_sums<1>(s, pl);
    const float cn = clamp_min(sqrtf(s[0]), 1e-30f);
    if (feat) vy[i] = cf / cn;
    __syncthreads();
    float lam = 0.f;
    for (int it = 0; it < p.est_l_iters; ++it) {
      const float w = feat ? tri::matvec<kMatvecUnroll>(T, vy, n, i) : 0.f;
      float u[1] = {w * w};
      lane_sums<1>(u, pl);  // its first sync ends every read of vy
      lam = sqrtf(u[0]);
      const float d = clamp_min(lam, 1e-30f);
      if (feat) vy[i] = w / d;
      __syncthreads();
    }
    const float L = ((lam > 0.f) ? p.l_safety * lam : 1.f) + a2;
    tau = p.t_init / L;
    thr = tau * a1;
    taumin = 1.f / L;
  }

  float x, y, t, ps, tauv, gap;
  int k, iters;
  bool done;
  if (p.X0) {
    x = in ? __ldg(p.X0 + off) : 0.f;
    y = in ? __ldg(p.Y0 + off) : 0.f;
    t = valid ? __ldg(p.t0 + lane) : 1.f;
    ps = row(p.ps0);
    tauv = valid ? __ldg(p.tv0 + lane) : 1.f;
    k = __ldg(p.k0 + lane0);  // uniform within the group
    done = valid ? (__ldg(p.done0 + lane) != 0) : true;
    iters = valid ? __ldg(p.iters0 + lane) : 0;
    gap = row(p.gap0);
  } else {
    x = 0.f;
    y = 0.f;
    t = (p.mode == kGreedy) ? tau : 1.f;
    ps = 0.f;
    tauv = tau;
    k = 0;
    done = !valid;
    iters = 0;
    gap = INFINITY;
  }
  if (feat) vy[i] = y;
  __syncthreads();

  while (k < p.k_end && !__syncthreads_and(done)) {
    for (int s = 0; s < p.chunk; ++s) {
      const float qy = feat ? tri::matvec<kMatvecUnroll>(T, vy, n, i) : 0.f;
      const float grad = qy + a2 * y - cf;
      float xn;
      if (p.armijo) {
        // g(y) = 1/2 y.Qy - c.y + 1/2 btb + 1/2 a2 |y|^2
        float sy[3] = {y * qy, cf * y, y * y};
        lane_sums<3>(sy, pl);
        const float g_y = 0.5f * sy[0] - sy[1] + 0.5f * btb + 0.5f * a2 * sy[2];
        // one trial at step tv: xt = prox(y - tv grad); ok = g(xt) <= g_y + C grad.(xt - y)
        auto trial = [&](float tvv, float& xt) -> bool {
          xt = soft_threshold(y - tvv * grad, tvv * a1);
          if (feat) vx[i] = xt;
          __syncthreads();
          const float qx = feat ? tri::matvec<kMatvecUnroll>(T, vx, n, i) : 0.f;
          float u[4] = {xt * qx, cf * xt, xt * xt, grad * (xt - y)};
          lane_sums<4>(u, pl);  // its first sync also ends the matvec's reads of vx
          const float g_x = 0.5f * u[0] - u[1] + 0.5f * btb + 0.5f * a2 * u[2];
          return g_x <= g_y + p.armijo_c * u[3];
        };
        bool acc = trial(tauv, xn) || !valid;
        int kbt = 0;
        while (__syncthreads_or(!acc) && kbt < p.max_bt) {
          const float tvv = acc ? tauv : p.armijo_eta * tauv;
          float xt;
          const bool ok = trial(tvv, xt);
          if (!acc) xn = xt;
          acc = acc || ok;
          tauv = tvv;
          ++kbt;
        }
      } else if (p.mode == kGreedy) {
        xn = soft_threshold(y - t * grad, t * a1);
      } else {
        xn = soft_threshold(y - tau * grad, thr);
      }

      float yn;
      if (p.mode == kFixed) {
        const float beta = __ldg(p.betas + k + s);
        yn = xn + beta * (xn - x);
      } else if (p.mode == kRestart) {
        const float d = xn - x;
        float sd[1] = {d * d};
        lane_sums<1>(sd, pl);
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
        lane_sums<2>(sd, pl);
        const float step = sqrtf(sd[0]);
        const bool restart = sd[1] >= 0.f;
        yn = restart ? xn : xn + (xn - x);
        if (ps == 0.f) ps = step;
        const bool grow = step > p.greedy_S * ps;
        if (grow || restart) t = max_nan(p.greedy_shrink * t, taumin);
      }
      __syncthreads();  // every thread is done reading vy
      x = xn;
      y = yn;
      if (feat) vy[i] = y;
      __syncthreads();
    }
    k += p.chunk;

    // the per-lane relative duality gap of x, and the certification record
    if (feat) vx[i] = x;
    __syncthreads();
    const float qx = feat ? tri::matvec<kMatvecUnroll>(T, vx, n, i) : 0.f;
    const float u = qx - cf + a2 * x;
    float sg[kSums] = {x * qx, cf * x, x * x, fabsf(x), u * u,
                       (feat && !isfinite(x)) ? 1.f : 0.f};
    lane_sums<kSums>(sg, pl);
    const float u_inf = lane_max(feat ? fabsf(u) : 0.f, pl);
    const float rr = clamp_min(sg[0] - 2.f * sg[1] + btb, 0.f);
    const float rb = sg[1] - btb;
    const float f = 0.5f * rr + 0.5f * a2 * sg[2] + a1 * sg[3];
    const float sc = (u_inf > a1) ? a1 / clamp_min(u_inf, 1e-30f) : 1.f;
    const float dual_neg = 0.5f * (sc * sc) * rr + sc * rb + 0.5f * a2 * (sc * sc) * sg[2];
    const float l1_gap = clamp_min(f + dual_neg, 0.f);
    const float smooth_gap = sg[4] / ((a2 > 0.f) ? 2.f * a2 : 1.f);
    const bool finite = sg[5] == 0.f;
    const float gp = finite ? ((a1 > 0.f) ? l1_gap : smooth_gap) / clamp_min(f, 1.f) : INFINITY;
    if (!done) {
      const bool newly = (gp <= p.tol) || !finite;
      if (p.mode == kGreedy && !newly && gp > 0.9f * gap) t = max_nan(0.5f * t, taumin);
      iters = k;
      gap = gp;
      done = newly;
    }
  }

  if (!valid) return;
  if (feat) {
    p.X[off] = x;
    p.Y[off] = y;
  }
  if (i == 0) {
    p.t[lane] = t;
    p.ps[lane] = ps;
    p.tv[lane] = tauv;
    p.k[lane] = k;
    p.done[lane] = done ? 1 : 0;
    p.iters[lane] = iters;
    p.gap[lane] = gap;
  }
}

size_t smem_bytes(int n, int G) {
  const int nt = (n + 31) / 32 * 32;
  return (2 * static_cast<size_t>(tri::vec_stride(n)) + tri::npairs(n) +
          static_cast<size_t>(nt / 32) * kSums) *
         G * sizeof(float);
}

int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

}  // namespace

// The kernel's group at feature count n on the current device: as many lanes as the card's
// opt-in shared memory per block and 1024 threads (round_up(n, 32) per lane) hold, at most
// kMaxGroup. 0 for n outside 1..168, minus a cudaError_t if the device query fails.
extern "C" int resident_group(int n) {
  if (n < 1 || n > kMaxN) return 0;
  int optin = 0;
  const int err = optin_smem(&optin);
  if (err) return -err;
  const int nt = (n + 31) / 32 * 32;
  const size_t by_smem = static_cast<size_t>(optin) / smem_bytes(n, 1);
  const int by_threads = kMaxThreads / nt < kMaxGroup ? kMaxThreads / nt : kMaxGroup;
  return by_smem < static_cast<size_t>(by_threads) ? static_cast<int>(by_smem) : by_threads;
}

// The whole certified solve. mode: 0 fixed (table beta), 1 nesterov + adaptive restart,
// 2 greedy; armijo != 0 adds the per-lane Armijo search (mode 0 or 1). Rows tau, thr, a2,
// a1, btb, taumin are (B,), betas needs k_end + chunk entries; X0 ... gap0 are the resumed
// state (all null for a fresh start; k0, done0, iters0 int32). Outputs X, Y (n, B) and t,
// ps, tv, k, done, iters, gap (B,). G lanes per CTA, G * round_up(n, 32) <= 1024 threads.
// est_l_iters > 0 estimates L in-kernel and ignores tau, thr, taumin. Returns a cudaError_t
// as int: cudaErrorInvalidValue for n outside 1..168, a bad G or mode, greedy with armijo,
// an empty batch, or shared memory past the card's block limit, else cudaGetLastError().
extern "C" int resident_solve(const float* Q, const float* c, const float* tau, const float* thr,
                              const float* a2, const float* a1, const float* btb,
                              const float* taumin, const float* betas, const float* X0,
                              const float* Y0, const float* t0, const float* ps0,
                              const float* tv0, const int* k0, const int* done0,
                              const int* iters0, const float* gap0, float* X, float* Y,
                              float* t, float* ps, float* tv, int* k, int* done, int* iters,
                              float* gap, int n, long long B, int G, int chunk, int k_end,
                              float tol, int mode, int armijo, float restart_threshold,
                              float greedy_S, float greedy_shrink, float armijo_c,
                              float armijo_eta, int max_backtracks, int est_l_iters,
                              float l_safety, float t_init, void* stream) {
  const int nt = (n + 31) / 32 * 32;
  if (n < 1 || n > kMaxN || B < 1 || G < 1 || G > kMaxGroup || G * nt > kMaxThreads ||
      chunk < 1 || mode < kFixed || mode > kGreedy || (armijo && mode == kGreedy) ||
      (X0 && !(Y0 && t0 && ps0 && tv0 && k0 && done0 && iters0 && gap0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, G);
  int optin = 0;
  cudaError_t err = static_cast<cudaError_t>(optin_smem(&optin));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{Q,     c,     tau,    thr,     a2,  a1,    btb,   taumin,
                 betas, X0,    Y0,     t0,      ps0, tv0,   k0,    done0,
                 iters0, gap0, X,      Y,       t,   ps,    tv,    k,
                 done,  iters, gap,    n,       B,   G,     chunk, k_end,
                 tol,   mode,  armijo, restart_threshold, greedy_S, greedy_shrink,
                 armijo_c, armijo_eta, max_backtracks, est_l_iters, l_safety, t_init};
  const unsigned grid = static_cast<unsigned>((B + G - 1) / G);
  resident_kernel<<<grid, G * nt, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
