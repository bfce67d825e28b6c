// fista_burst — n_steps FISTA iterations of the Gram-form batched lasso, one launch.
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
// last axis. A CTA owns 32 lanes (threadIdx.x) and spreads the features over 8 row
// groups (threadIdx.y): thread (lane, g) keeps features g, g+8, ... of its lane in
// registers (F of them, a template constant). Y and the trial point live in shared
// memory because every thread of a lane reads all of them in the matvec
//   out[f] = sum_k Q[k][f] * v[k]   (k ascending, over the true n, no padding),
// whose Q reads coalesce across the 32 lanes into one 128-byte line per (k, f).
// Per-lane sums over features (norms, the Armijo values, the gap's terms) add each
// thread's partials, then the 8 row groups in order, through shared memory.
//
// Bound: each iteration reads the CTA's Q slice once through L2 (n^2 * 32 * 4 bytes;
// 2.0 GB per iteration for the whole batch at n=96, B=54144), against 2*n^2 flops per
// lane: ~0.25 flop/byte, so the kernel is bound by device-memory reads, about 0.6 ms
// per iteration at the 3.35 TB/s data-sheet peak (measured on an H100 80GB HBM3 at
// 700 W: 1.13 ms, Q read at ~1760 GB/s against ~3090 GB/s for a plain read of Q:
// the 13 loads a thread has in flight per k do not cover the latency). The TPU
// kernel holds a tile's Q in VMEM for a whole burst and reads it once per
// check_every iterations; holding Q
// on-chip across a burst (it does not fit one block's 227 KB at n=96 for more than
// ~1.5 lanes) is later work. Armijo adds one matvec per trial round, the gap one per
// burst.
//
// No lane depends on its neighbours: the trial rounds of a CTA run while any of its
// lanes is unaccepted, and an accepted lane is left untouched, so the result equals
// a per-lane trial loop and the twin's batch-wide lockstep rounds at any tiling.
// Lanes >= B load zeros, start accepted and store nothing; they still reach every
// __syncthreads. Offsets are 64-bit (Q holds 5.0e8 elements at full width). Built
// with --fmad=false and without --use_fast_math, so each product and sum rounds
// separately, as in the twin, and divisions and square roots are IEEE.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kLanes = 32;  // lanes per CTA (threadIdx.x)
constexpr int kRows = 8;    // feature row groups (threadIdx.y)
constexpr int kThreads = kLanes * kRows;
constexpr int kMaxN = 104;  // the burst window (fista_vmem.plan_gram_solve)
constexpr int kMaxSums = 5;

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
  float restart_threshold;
  float greedy_S;
  float greedy_shrink;
  float armijo_c;
  float armijo_eta;
  int max_bt;
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

// Per-lane totals of K partial sums over the 8 row groups, added in order; every
// thread of the lane gets them. red holds kMaxSums * kRows * kLanes floats.
template <int K>
__device__ __forceinline__ void lane_sums(float (&v)[K], float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int q = 0; q < K; ++q) red[(q * kRows + ty) * kLanes + tx] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += red[(q * kRows + r) * kLanes + tx];
    v[q] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float lane_max(float v, float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  red[ty * kLanes + tx] = v;
  __syncthreads();
  float m = red[tx];
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    const float x = red[r * kLanes + tx];
    m = (x > m || isnan(x)) ? x : m;  // NaN wins, as torch.amax
  }
  __syncthreads();
  return m;
}

// out[j] = sum_k Q[k][f_j] * vs[k] for this thread's features f_j = ty + 8j.
// vs is [n][32] in shared memory; the caller syncs before and after.
template <int F>
__device__ __forceinline__ void matvec(const float* __restrict__ Q, const float* vs, int n,
                                       int64_t B, int64_t lane, bool valid, float (&out)[F]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < F; ++j) out[j] = 0.f;
  if (!valid) return;
  for (int k = 0; k < n; ++k) {
    const float vk = vs[k * kLanes + tx];
    const float* Qk = Q + static_cast<int64_t>(k) * n * B + lane;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const int f = ty + j * kRows;
      if (f < n) out[j] = out[j] + __ldg(Qk + static_cast<int64_t>(f) * B) * vk;
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads) fista_burst_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n;
  const int64_t B = p.B;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanes + tx;
  const bool valid = lane < B;
  float* Ys = smem;                  // [n][32]: Y, the point of the gradient
  float* Vs = Ys + n * kLanes;       // [n][32]: trial point / final X
  float* red = Vs + n * kLanes;      // [kMaxSums][8][32]

  auto row = [&](const float* r) { return (valid && r) ? __ldg(r + lane) : 0.f; };
  const float tau = row(p.tau), thr = row(p.thr), a2 = row(p.a2), a1 = row(p.a1);
  const float btb = row(p.btb), taumin = row(p.taumin);
  float t = row(p.t), ps = row(p.ps), tauv = row(p.tauv);

  float x[F], y[F], cf[F];
#pragma unroll
  for (int j = 0; j < F; ++j) {
    const int f = ty + j * kRows;
    const bool in = valid && f < n;
    const int64_t off = static_cast<int64_t>(f) * B + lane;
    x[j] = in ? __ldg(p.X + off) : 0.f;
    y[j] = in ? __ldg(p.Y + off) : 0.f;
    cf[j] = in ? __ldg(p.c + off) : 0.f;
    if (f < n) Ys[f * kLanes + tx] = y[j];
  }
  __syncthreads();

  for (int i = 0; i < p.n_steps; ++i) {
    float qy[F], grad[F], xn[F];
    matvec<F>(p.Q, Ys, n, B, lane, valid, qy);
#pragma unroll
    for (int j = 0; j < F; ++j) grad[j] = qy[j] + a2 * y[j] - cf[j];

    if (p.armijo) {
      // g(y) = 1/2 y.Qy - c.y + 1/2 btb + 1/2 a2 |y|^2
      float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < F; ++j) {
        s[0] += y[j] * qy[j];
        s[1] += cf[j] * y[j];
        s[2] += y[j] * y[j];
      }
      lane_sums<3>(s, red);
      const float g_y = 0.5f * s[0] - s[1] + 0.5f * btb + 0.5f * a2 * s[2];
      // one trial at step tv: xt = prox(y - tv grad); ok = g(xt) <= g_y + C grad.(xt - y)
      auto trial = [&](float tv, float (&xt)[F]) -> bool {
        const float th = tv * a1;
#pragma unroll
        for (int j = 0; j < F; ++j) {
          const int f = ty + j * kRows;
          xt[j] = soft_threshold(y[j] - tv * grad[j], th);
          if (f < n) Vs[f * kLanes + tx] = xt[j];
        }
        __syncthreads();
        float qx[F];
        matvec<F>(p.Q, Vs, n, B, lane, valid, qx);
        float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < F; ++j) {
          u[0] += xt[j] * qx[j];
          u[1] += cf[j] * xt[j];
          u[2] += xt[j] * xt[j];
          u[3] += grad[j] * (xt[j] - y[j]);
        }
        lane_sums<4>(u, red);  // its first sync also ends the matvec's reads of Vs
        const float g_x = 0.5f * u[0] - u[1] + 0.5f * btb + 0.5f * a2 * u[2];
        return g_x <= g_y + p.armijo_c * u[3];
      };
      bool acc = trial(tauv, xn) || !valid;
      int kbt = 0;
      while (__syncthreads_or(!acc) && kbt < p.max_bt) {
        const float tv = acc ? tauv : p.armijo_eta * tauv;
        float xt[F];
        const bool ok = trial(tv, xt);
        if (!acc) {
#pragma unroll
          for (int j = 0; j < F; ++j) xn[j] = xt[j];
        }
        acc = acc || ok;
        tauv = tv;
        ++kbt;
      }
    } else if (p.mode == kGreedy) {
#pragma unroll
      for (int j = 0; j < F; ++j) xn[j] = soft_threshold(y[j] - t * grad[j], t * a1);
    } else {
#pragma unroll
      for (int j = 0; j < F; ++j) xn[j] = soft_threshold(y[j] - tau * grad[j], thr);
    }

    float yn[F];
    if (p.mode == kFixed) {
      const float beta = __ldg(p.betas + p.k0 + i);
#pragma unroll
      for (int j = 0; j < F; ++j) yn[j] = xn[j] + beta * (xn[j] - x[j]);
    } else if (p.mode == kRestart) {
      float s[1] = {0.f};
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const float d = xn[j] - x[j];
        s[0] += d * d;
      }
      lane_sums<1>(s, red);
      const float step = sqrtf(s[0]);
      float t_next = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
      const float beta = (t - 1.f) / t_next;
      const float ratio = (ps > 0.f) ? step / clamp_min(ps, 1e-30f) : INFINITY;
      const bool restart = ratio > p.restart_threshold;
      if (restart) t_next = 1.f;
#pragma unroll
      for (int j = 0; j < F; ++j) yn[j] = restart ? xn[j] : xn[j] + beta * (xn[j] - x[j]);
      t = t_next;
      ps = step;
    } else {  // greedy: unit momentum, gradient-mapping restart, tau safeguard
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const float d = xn[j] - x[j];
        s[0] += d * d;
        s[1] += (y[j] - xn[j]) * d;
      }
      lane_sums<2>(s, red);
      const float step = sqrtf(s[0]);
      const bool restart = s[1] >= 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) yn[j] = restart ? xn[j] : xn[j] + (xn[j] - x[j]);
      if (ps == 0.f) ps = step;
      const bool grow = step > p.greedy_S * ps;
      if (grow || restart) {
        const float sh = p.greedy_shrink * t;
        t = (sh > taumin || isnan(sh)) ? sh : taumin;  // torch.maximum
      }
    }

    __syncthreads();  // every thread is done reading Ys
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const int f = ty + j * kRows;
      x[j] = xn[j];
      y[j] = yn[j];
      if (f < n) Ys[f * kLanes + tx] = y[j];
    }
    __syncthreads();
  }

  float gap = 0.f;
  if (p.with_gap) {
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const int f = ty + j * kRows;
      if (f < n) Vs[f * kLanes + tx] = x[j];
    }
    __syncthreads();
    float qx[F];
    matvec<F>(p.Q, Vs, n, B, lane, valid, qx);
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // xQx, cx, xx, l1, uu
    float u_inf = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      s[0] += x[j] * qx[j];
      s[1] += cf[j] * x[j];
      s[2] += x[j] * x[j];
      s[3] += fabsf(x[j]);
      const float u = qx[j] - cf[j] + a2 * x[j];
      s[4] += u * u;
      const float au = fabsf(u);
      if ((ty + j * kRows) < n) u_inf = (au > u_inf || isnan(au)) ? au : u_inf;
    }
    lane_sums<5>(s, red);
    u_inf = lane_max(u_inf, red);
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
#pragma unroll
  for (int j = 0; j < F; ++j) {
    const int f = ty + j * kRows;
    if (f < n) {
      const int64_t off = static_cast<int64_t>(f) * B + lane;
      p.Xo[off] = x[j];
      p.Yo[off] = y[j];
    }
  }
  if (ty == 0) {
    p.to[lane] = t;
    p.pso[lane] = ps;
    p.tauvo[lane] = tauv;
    p.gap[lane] = gap;
  }
}

template <int F>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(p.n) + kMaxSums * kRows) * kLanes * sizeof(float);
  const unsigned grid = static_cast<unsigned>((p.B + kLanes - 1) / kLanes);
  fista_burst_kernel<F><<<grid, dim3(kLanes, kRows), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One burst. mode: 0 fixed (table beta), 1 nesterov + adaptive restart, 2 greedy;
// armijo != 0 adds the per-lane Armijo search (mode 0 or 1). Rows tau, thr, a2, a1,
// btb, t, ps, tauv are (B,); taumin may be null (greedy only); betas needs k0 +
// n_steps entries in mode 0. Outputs Xo, Yo (n, B), to, pso, tauvo, gap (B,); gap is
// 0 unless with_gap. Returns a cudaError_t as int: cudaErrorInvalidValue for n
// outside 1..104, an unknown mode, greedy with armijo, or an empty batch, else
// cudaGetLastError() after the launch.
extern "C" int fista_burst(const float* Q, const float* c, const float* tau, const float* thr,
                           const float* a2, const float* a1, const float* btb, const float* X,
                           const float* Y, const float* t, const float* ps,
                           const float* taumin, const float* tauv, const float* betas,
                           float* Xo, float* Yo, float* to, float* pso, float* tauvo,
                           float* gap, int n, long long B, int n_steps, int k0, int mode,
                           int armijo, int with_gap, float restart_threshold,
                           float greedy_S, float greedy_shrink, float armijo_c,
                           float armijo_eta, int max_backtracks, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || n_steps < 0 || mode < kFixed || mode > kGreedy ||
      (armijo && mode == kGreedy) || (mode == kGreedy && !taumin))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Q,  c,   tau, thr,   a2,  a1,       btb,    X,        Y,
                 t,  ps,  taumin, tauv, betas, Xo,   Yo,     to,       pso,
                 tauvo, gap, n, B, n_steps, k0, mode, armijo, with_gap, restart_threshold,
                 greedy_S, greedy_shrink, armijo_c, armijo_eta, max_backtracks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8) return launch<1>(p, s);
  if (n <= 16) return launch<2>(p, s);
  if (n <= 32) return launch<4>(p, s);
  if (n <= 64) return launch<8>(p, s);
  return launch<13>(p, s);
}
