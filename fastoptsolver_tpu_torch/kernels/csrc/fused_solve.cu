// fused_lasso_solve — the whole certified batched-lasso pipeline in one launch.
//
// Replaces the TPU kernels fastoptsolver_tpu/kernels/fused_solve.py:_fused_kernel
// (every mode: fixed table beta, nesterov with adaptive restart, greedy, and the masked
// per-lane Armijo search with fixed or restart momentum; resume in and state out) and
// :_overlap_kernel (its software-pipelined variant, fixed mode, same math). Semantics
// follow fastoptsolver_tpu/kernels/_common.py: power_lambda_max, gram_rel_gap_from_qx,
// fista_general_chunk, fista_armijo_chunk and certified_solve_body; the plain PyTorch
// twin is fastoptsolver_tpu_torch/kernels/_common.py:certified_solve_body.
//
// Layout: A (n, m, B) and b (m, B) feature-leading, instances (lanes) on the
// contiguous last axis; one thread per lane, one CTA per tile of blockDim.x lanes
// (the port's b_tile). Per lane:
//   build  — walk the m rows once, accumulating the (n+1)(n+2)/2 distinct sums of
//            the augmented Gram [A|b]^T[A|b] in registers (a warp's loads of one
//            (feature, row) coalesce into one 128-byte line);
//   setup  — assemble Q, c, b^T b in registers; pl_iters power steps from
//            v0 = c/max(|c|, 1e-30); L = (lam > 0 ? l_safety*lam : 1) + a2,
//            tau = t_init/L, thr = tau*a1, taumin = 1/L;
//   solve  — bursts of `chunk` FISTA steps in the mode of the instantiation, then
//            the relative duality gap, the non-finite quarantine, the greedy
//            stuck-lane shrink and the done/iters/gap updates;
//   exit   — the CTA leaves the loop when __syncthreads_or(!done) is false or k
//            reaches k_end. Certified lanes keep iterating until their CTA exits,
//            exactly as the TPU tile does, so x depends on the lane grouping.
//
// Modes are template parameters <N, MODE, ARMIJO>, the pairs resident.cu takes:
//   MODE 0, fixed   — beta from a global table at the absolute iteration (a resumed
//                     CTA continues the table from its k);
//   MODE 1, restart — per-lane Nesterov scalar t and previous step norm ps, the
//                     restart when |x+ - x| / ps exceeds restart_threshold;
//   MODE 2, greedy  — t is the lane's step (start greedy_xi/L), ps its first step
//                     norm; unit momentum, the gradient-mapping restart, t shrunk
//                     toward 1/L when a step grows or restarts, and halved at a burst
//                     end where the gap did not fall below 0.9 of the last one;
//   ARMIJO          — (MODE 0 or 1) the lane's step tau persists and never grows:
//                     each thread runs its own trial loop, at most max_bt shrinks by
//                     eta per step, which equals the reference's lockstep rounds
//                     (an accepted lane is never touched again).
// The fixed instantiations keep the loop they had before the other modes existed
// (t, ps and tau are not carried through it).
//
// Resume: nine optional per-lane inputs X0, Y0 (n, B), t0, ps0, tv0, k0, done0,
// iters0, gap0; k is read once per CTA from its first lane (the wrapper refuses a
// state whose k is not uniform within each CTA), so CTAs resume at their own
// iterations and stop at k_end. State out: five optional outputs Y, t, ps, tv, k.
// No atomics and the Gram rebuilt from the same data in the same order, so a
// resumed run equals a straight one bit for bit.
//
// Bound: at the bench configuration (n=5, m=1000, B=262144) the kernel reads
// 6.29 GB of A and b and writes O(n*B) results, about 1.9 ms at the H100 SXM's
// 3.35 TB/s data-sheet peak; the solve is ~60 flops per lane per iteration (~2.5x that
// with an Armijo trial). So the kernel is memory-bound, and it relies on many resident
// CTAs per SM to hide one CTA's solve phase behind the others' loads (the TPU needed
// the _overlap_kernel for that). Sums are taken in blocks of kRowBlock rows to
// keep the sequential f32 accumulation error near the pairwise sums of the twin.
// Registers: Q (the n(n+1)/2 distinct entries), c, X, Y and the pair sums live in
// one thread's registers; chip_smoke.py prints ptxas's count for each instantiation.
// On sm_90a: 126 at n = 8 and 128 at n = 7 in every mode (the build's pair sums set
// the peak there); at n = 5, 63 fixed, restart and greedy, 66 Armijo and 80 Armijo
// with restart (the gradient, the trial point and its Q product); no spills.
//
// Out-of-range threads of the ragged last CTA start done and still reach every
// __syncthreads_or; they never load or store. Offsets into A are 64-bit
// (n*m*B is 61% of 2^31 at the bench size). Built without --use_fast_math:
// the divisions and square roots are IEEE and denormals are kept.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;  // largest CTA (b_tile) the launch bounds allow
constexpr int kRowBlock = 32;

enum Mode { kFixed = 0, kRestart = 1, kGreedy = 2 };

struct Params {
  const float* A;
  const float* b;
  const float* alpha1;
  const float* alpha2;
  const float* betas;
  // the resumed state: all null for a fresh start
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
  int* iters;
  float* gap;
  int* done;
  // the state out: all null unless asked for
  float* Y;
  float* t;
  float* ps;
  float* tv;
  int* k;
  int64_t m;
  int64_t B;
  int pl_iters;
  float l_safety;
  float t_init;
  int chunk;
  int k_end;
  float tol;
  float restart_threshold;
  float greedy_S;
  float greedy_shrink;
  float armijo_c;
  float armijo_eta;
  int max_bt;
};

__host__ __device__ constexpr int pair_index(int i, int k, int na) {
  // row of upper-triangle pair (i, k), i <= k, in row-major order
  return i * na - (i * (i - 1)) / 2 + (k - i);
}

template <int N>
__device__ __forceinline__ void gram_matvec(const float (&Q)[N][N], const float (&v)[N],
                                            float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] += Q[k][i] * v[k];
  }
}

__device__ __forceinline__ float soft_threshold(float v, float thr) {
  // sign(v) * max(|v| - thr, 0), with NaN propagated as jnp.maximum does
  const float mag = fabsf(v) - thr;
  if (mag > 0.f) return copysignf(mag, v);
  return isnan(mag) ? mag : 0.f;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || isnan(b)) ? b : a;  // NaN wins, as torch.maximum / jnp.maximum
}

template <int N>
__device__ float rel_gap(const float (&Q)[N][N], const float (&c)[N], const float (&X)[N],
                         float a1, float a2, float btb) {
  float QX[N];
  gram_matvec<N>(Q, X, QX);
  float xQx = 0.f, cx = 0.f, xx = 0.f, l1 = 0.f, u_inf = 0.f, uu = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    xQx += X[i] * QX[i];
    cx += c[i] * X[i];
    xx += X[i] * X[i];
    l1 += fabsf(X[i]);
    const float u = QX[i] - c[i] + a2 * X[i];
    u_inf = fmaxf(u_inf, fabsf(u));
    uu += u * u;
  }
  const float rr = fmaxf(xQx - 2.f * cx + btb, 0.f);
  const float rb = cx - btb;
  const float f = 0.5f * rr + 0.5f * a2 * xx + a1 * l1;
  const float s = (u_inf > a1) ? a1 / fmaxf(u_inf, 1e-30f) : 1.f;
  const float dual_neg = 0.5f * (s * s) * rr + s * rb + 0.5f * a2 * (s * s) * xx;
  const float l1_gap = fmaxf(f + dual_neg, 0.f);
  const float smooth_gap = uu / (a2 > 0.f ? 2.f * a2 : 1.f);
  const float gap = (a1 > 0.f) ? l1_gap : smooth_gap;
  return gap / fmaxf(f, 1.f);
}

// The smooth part g(z) = 1/2 z.Qz - c.z + 1/2 btb + 1/2 a2 |z|^2, from Qz.
template <int N>
__device__ __forceinline__ float smooth(const float (&z)[N], const float (&Qz)[N],
                                        const float (&c)[N], float a2, float btb) {
  float zqz = 0.f, cz = 0.f, zz = 0.f;
#pragma unroll
  for (int f = 0; f < N; ++f) {
    zqz += z[f] * Qz[f];
    cz += c[f] * z[f];
    zz += z[f] * z[f];
  }
  return 0.5f * zqz - cz + 0.5f * btb + 0.5f * a2 * zz;
}

// One Armijo trial at step tv: xt = prox(y - tv grad, tv a1); true when
// g(xt) <= g(y) + C grad.(xt - y).
template <int N>
__device__ __forceinline__ bool armijo_trial(const float (&Q)[N][N], const float (&c)[N],
                                             const float (&Y)[N], const float (&grad)[N],
                                             float tv, float a1, float a2, float btb,
                                             float g_y, float C, float (&xt)[N]) {
#pragma unroll
  for (int f = 0; f < N; ++f) xt[f] = soft_threshold(Y[f] - tv * grad[f], tv * a1);
  float QX[N];
  gram_matvec<N>(Q, xt, QX);
  float gd = 0.f;
#pragma unroll
  for (int f = 0; f < N; ++f) gd += grad[f] * (xt[f] - Y[f]);
  return smooth<N>(xt, QX, c, a2, btb) <= g_y + C * gd;
}

template <int N, int MODE, bool ARMIJO>
__global__ void __launch_bounds__(kMaxThreads) fused_lasso_solve_kernel(const Params p) {
  static_assert(!(ARMIJO && MODE == kGreedy), "greedy momentum controls tau itself");
  constexpr int NA = N + 1;
  constexpr int NP = NA * (NA + 1) / 2;
  const int64_t B = p.B;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t lane = lane0 + threadIdx.x;
  const bool valid = lane < B;

  // ---- build: one pass over this lane's rows of [A|b] ----
  float acc[NP];
#pragma unroll
  for (int p_ = 0; p_ < NP; ++p_) acc[p_] = 0.f;
  if (valid) {
    const int64_t m = p.m;
    const int64_t plane = m * B;
    for (int64_t r0 = 0; r0 < m; r0 += kRowBlock) {
      const int64_t r1 = (r0 + kRowBlock < m) ? r0 + kRowBlock : m;
      float part[NP];
#pragma unroll
      for (int p_ = 0; p_ < NP; ++p_) part[p_] = 0.f;
#pragma unroll 4
      for (int64_t r = r0; r < r1; ++r) {
        const int64_t off = r * B + lane;
        float col[NA];
#pragma unroll
        for (int k = 0; k < N; ++k) col[k] = __ldg(p.A + k * plane + off);
        col[N] = __ldg(p.b + off);
#pragma unroll
        for (int i = 0; i < NA; ++i) {
#pragma unroll
          for (int k = i; k < NA; ++k) part[pair_index(i, k, NA)] += col[i] * col[k];
        }
      }
#pragma unroll
      for (int p_ = 0; p_ < NP; ++p_) acc[p_] += part[p_];
    }
  }

  // ---- setup: Q, c, b^T b; power iteration; step and threshold ----
  float Q[N][N], c[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) Q[i][k] = acc[i <= k ? pair_index(i, k, NA) : pair_index(k, i, NA)];
    c[i] = acc[pair_index(i, N, NA)];
  }
  const float btb = acc[pair_index(N, N, NA)];

  float v[N];
  float cn = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) cn += c[i] * c[i];
  const float c_norm = fmaxf(sqrtf(cn), 1e-30f);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = c[i] / c_norm;
  float lam = 0.f;
  for (int it = 0; it < p.pl_iters; ++it) {
    float w[N];
    gram_matvec<N>(Q, v, w);
    float ww = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) ww += w[i] * w[i];
    lam = sqrtf(ww);
    const float d = fmaxf(lam, 1e-30f);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = w[i] / d;
  }
  const float a1 = valid ? p.alpha1[lane] : 0.f;
  const float a2 = valid ? p.alpha2[lane] : 0.f;
  const float L = (lam > 0.f ? p.l_safety * lam : 1.f) + a2;
  const float tau = p.t_init / L;
  const float thr = tau * a1;

  // ---- the state: fresh, or the resumed rows (padded lanes start done) ----
  constexpr bool kCarryT = MODE != kFixed;  // t and ps change only in these modes
  float X[N], Y[N];
  float t = 1.f, ps = 0.f, tauv = tau, gap = INFINITY;
  int k = 0, iters = 0;
  bool done = !valid;
  if (p.X0 != nullptr) {
#pragma unroll
    for (int f = 0; f < N; ++f) {
      X[f] = valid ? __ldg(p.X0 + f * B + lane) : 0.f;
      Y[f] = valid ? __ldg(p.Y0 + f * B + lane) : 0.f;
    }
    if (kCarryT) {
      t = valid ? __ldg(p.t0 + lane) : 1.f;
      ps = valid ? __ldg(p.ps0 + lane) : 0.f;
    }
    if (ARMIJO) tauv = valid ? __ldg(p.tv0 + lane) : 1.f;
    k = __ldg(p.k0 + lane0);  // uniform within the CTA
    done = valid ? (__ldg(p.done0 + lane) != 0) : true;
    iters = valid ? __ldg(p.iters0 + lane) : 0;
    gap = valid ? __ldg(p.gap0 + lane) : 0.f;
  } else {
#pragma unroll
    for (int f = 0; f < N; ++f) X[f] = Y[f] = 0.f;
    if (MODE == kGreedy) t = tau;
  }
  const float taumin = 1.f / L;

  // ---- certified solve ----
  while (k < p.k_end) {
    if (!__syncthreads_or(!done)) break;
    for (int i = 0; i < p.chunk; ++i) {
      if constexpr (MODE == kFixed && !ARMIJO) {
        const float beta = __ldg(p.betas + k + i);
        float QY[N];
        gram_matvec<N>(Q, Y, QY);
#pragma unroll
        for (int f = 0; f < N; ++f) {
          const float grad = QY[f] + a2 * Y[f] - c[f];
          const float xn = soft_threshold(Y[f] - tau * grad, thr);
          Y[f] = xn + beta * (xn - X[f]);
          X[f] = xn;
        }
      } else {
        float QY[N], grad[N], Xn[N];
        gram_matvec<N>(Q, Y, QY);
#pragma unroll
        for (int f = 0; f < N; ++f) grad[f] = QY[f] + a2 * Y[f] - c[f];
        if constexpr (ARMIJO) {
          const float g_y = smooth<N>(Y, QY, c, a2, btb);
          bool ok = armijo_trial<N>(Q, c, Y, grad, tauv, a1, a2, btb, g_y, p.armijo_c, Xn);
          for (int kbt = 0; !ok && kbt < p.max_bt; ++kbt) {
            tauv = p.armijo_eta * tauv;
            ok = armijo_trial<N>(Q, c, Y, grad, tauv, a1, a2, btb, g_y, p.armijo_c, Xn);
          }
        } else if constexpr (MODE == kGreedy) {
#pragma unroll
          for (int f = 0; f < N; ++f) Xn[f] = soft_threshold(Y[f] - t * grad[f], t * a1);
        } else {
#pragma unroll
          for (int f = 0; f < N; ++f) Xn[f] = soft_threshold(Y[f] - tau * grad[f], thr);
        }

        if constexpr (MODE == kFixed) {
          const float beta = __ldg(p.betas + k + i);
#pragma unroll
          for (int f = 0; f < N; ++f) {
            Y[f] = Xn[f] + beta * (Xn[f] - X[f]);
            X[f] = Xn[f];
          }
        } else if constexpr (MODE == kRestart) {
          float ss = 0.f;
#pragma unroll
          for (int f = 0; f < N; ++f) {
            const float d = Xn[f] - X[f];
            ss += d * d;
          }
          const float step = sqrtf(ss);
          float t_next = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
          const float beta = (t - 1.f) / t_next;
          const float ratio = (ps > 0.f) ? step / fmaxf(ps, 1e-30f) : INFINITY;
          const bool restart = ratio > p.restart_threshold;
          if (restart) t_next = 1.f;
#pragma unroll
          for (int f = 0; f < N; ++f) {
            Y[f] = restart ? Xn[f] : Xn[f] + beta * (Xn[f] - X[f]);
            X[f] = Xn[f];
          }
          t = t_next;
          ps = step;
        } else {  // greedy: unit momentum, gradient-mapping restart, tau safeguard
          float ss = 0.f, gm = 0.f;
#pragma unroll
          for (int f = 0; f < N; ++f) {
            const float d = Xn[f] - X[f];
            ss += d * d;
            gm += (Y[f] - Xn[f]) * d;
          }
          const float step = sqrtf(ss);
          const bool restart = gm >= 0.f;
#pragma unroll
          for (int f = 0; f < N; ++f) {
            Y[f] = restart ? Xn[f] : Xn[f] + (Xn[f] - X[f]);
            X[f] = Xn[f];
          }
          if (ps == 0.f) ps = step;
          if (step > p.greedy_S * ps || restart) t = max_nan(p.greedy_shrink * t, taumin);
        }
      }
    }
    k += p.chunk;
    bool finite = true;
#pragma unroll
    for (int f = 0; f < N; ++f) finite = finite && isfinite(X[f]);
    const float gp = finite ? rel_gap<N>(Q, c, X, a1, a2, btb) : INFINITY;
    if (!done) {
      const bool newly = (gp <= p.tol) || !finite;
      // a lane whose gap did not improve over a whole burst gets its step halved
      if (MODE == kGreedy && !newly && gp > 0.9f * gap) t = max_nan(0.5f * t, taumin);
      iters = k;
      gap = gp;
      done = newly;
    }
  }

  if (valid) {
#pragma unroll
    for (int f = 0; f < N; ++f) p.X[f * B + lane] = X[f];
    p.iters[lane] = iters;
    p.gap[lane] = gap;
    p.done[lane] = done ? 1 : 0;
    if (p.Y != nullptr) {
#pragma unroll
      for (int f = 0; f < N; ++f) p.Y[f * B + lane] = Y[f];
      // rows a mode does not change pass through: re-read, not carried
      const bool resumed = p.X0 != nullptr;
      p.t[lane] = kCarryT ? t : (resumed ? p.t0[lane] : 1.f);
      p.ps[lane] = kCarryT ? ps : (resumed ? p.ps0[lane] : 0.f);
      p.tv[lane] = ARMIJO ? tauv : (resumed ? p.tv0[lane] : tau);
      p.k[lane] = k;
    }
  }
}

template <int N, int MODE, bool ARMIJO>
void launch(const Params& p, int b_tile, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((p.B + b_tile - 1) / b_tile);
  fused_lasso_solve_kernel<N, MODE, ARMIJO><<<grid, b_tile, 0, stream>>>(p);
}

// The instantiation of (mode, armijo) at feature count N; false for a pair the
// kernel does not take (greedy with Armijo, or an unknown mode).
template <int N>
bool launch_mode(const Params& p, int mode, bool armijo, int b_tile, cudaStream_t stream) {
  if (mode == kFixed && !armijo) {
    launch<N, kFixed, false>(p, b_tile, stream);
  } else if (mode == kRestart && !armijo) {
    launch<N, kRestart, false>(p, b_tile, stream);
  } else if (mode == kGreedy && !armijo) {
    launch<N, kGreedy, false>(p, b_tile, stream);
  } else if (mode == kFixed) {
    launch<N, kFixed, true>(p, b_tile, stream);
  } else if (mode == kRestart) {
    launch<N, kRestart, true>(p, b_tile, stream);
  } else {
    return false;
  }
  return true;
}

}  // namespace

// The whole certified solve from raw data. mode: 0 fixed (table beta; betas needs
// k_end + chunk entries), 1 nesterov + adaptive restart, 2 greedy; armijo != 0 adds the
// per-lane Armijo search (mode 0 or 1). X0 ... gap0 are the resumed state (all null for
// a fresh start; k0, done0, iters0 int32); Y, t, ps, tv, k the state out (all null, or
// none). Outputs X (n, B), iters, gap, done (B,). Returns a cudaError_t as int:
// cudaErrorInvalidValue for a feature count outside 1..8, a b_tile that is not a
// multiple of 32 in 32..256, an empty batch, a bad mode, greedy with armijo, or a
// partial state, else cudaGetLastError() after the launch.
extern "C" int fused_lasso_solve(
    const float* A, const float* b, const float* alpha1, const float* alpha2,
    const float* betas, const float* X0, const float* Y0, const float* t0, const float* ps0,
    const float* tv0, const int* k0, const int* done0, const int* iters0, const float* gap0,
    float* X, int* iters, float* gap, int* done, float* Y, float* t, float* ps, float* tv,
    int* k, int n, long long m, long long B, int b_tile, int pl_iters, float l_safety,
    float t_init, int chunk, int k_end, float tol, int mode, int armijo,
    float restart_threshold, float greedy_S, float greedy_shrink, float armijo_c,
    float armijo_eta, int max_backtracks, void* stream) {
  if (b_tile < 32 || b_tile > kMaxThreads || b_tile % 32 != 0 || B <= 0 || m <= 0 ||
      chunk <= 0 || (X0 && !(Y0 && t0 && ps0 && tv0 && k0 && done0 && iters0 && gap0)) ||
      (Y && !(t && ps && tv && k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{A,     b,     alpha1, alpha2, betas,    X0,       Y0,
                 t0,    ps0,   tv0,    k0,     done0,    iters0,   gap0,
                 X,     iters, gap,    done,   Y,        t,        ps,
                 tv,    k,     m,      B,      pl_iters, l_safety, t_init,
                 chunk, k_end, tol,    restart_threshold, greedy_S, greedy_shrink,
                 armijo_c, armijo_eta, max_backtracks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (n) {
    case 1: ok = launch_mode<1>(p, mode, armijo != 0, b_tile, s); break;
    case 2: ok = launch_mode<2>(p, mode, armijo != 0, b_tile, s); break;
    case 3: ok = launch_mode<3>(p, mode, armijo != 0, b_tile, s); break;
    case 4: ok = launch_mode<4>(p, mode, armijo != 0, b_tile, s); break;
    case 5: ok = launch_mode<5>(p, mode, armijo != 0, b_tile, s); break;
    case 6: ok = launch_mode<6>(p, mode, armijo != 0, b_tile, s); break;
    case 7: ok = launch_mode<7>(p, mode, armijo != 0, b_tile, s); break;
    case 8: ok = launch_mode<8>(p, mode, armijo != 0, b_tile, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Name of a cudaError_t, for the Python wrappers' error messages.
extern "C" const char* fos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
