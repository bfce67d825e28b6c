// fused_lasso_solve — the whole certified batched-lasso pipeline in one launch.
//
// Replaces the TPU kernels fastoptsolver_tpu/kernels/fused_solve.py:_fused_kernel
// (fixed-momentum, table-beta mode) and :_overlap_kernel (its software-pipelined
// variant, same math). Semantics follow fastoptsolver_tpu/kernels/_common.py:
// power_lambda_max, gram_rel_gap_from_qx, fista_fixed_chunk and the fixed branch of
// certified_solve_body; the plain PyTorch twin is
// fastoptsolver_tpu_torch/kernels/_common.py.
//
// Layout: A (n, m, B) and b (m, B) feature-leading, instances (lanes) on the
// contiguous last axis; one thread per lane, one CTA per tile of blockDim.x lanes
// (the port's b_tile). Per lane:
//   build  — walk the m rows once, accumulating the (n+1)(n+2)/2 distinct sums of
//            the augmented Gram [A|b]^T[A|b] in registers (a warp's loads of one
//            (feature, row) coalesce into one 128-byte line);
//   setup  — assemble Q, c, b^T b in registers; pl_iters power steps from
//            v0 = c/max(|c|, 1e-30); L = (lam > 0 ? l_safety*lam : 1) + a2,
//            tau = t_init/L, thr = tau*a1;
//   solve  — bursts of `chunk` fixed-beta FISTA steps (beta from a global table
//            indexed by the absolute iteration, which can exceed constant memory),
//            then the relative duality gap, the non-finite quarantine and the
//            done/iters/gap updates;
//   exit   — the CTA leaves the loop when __syncthreads_or(!done) is false or k
//            reaches k_end. Certified lanes keep iterating until their CTA exits,
//            exactly as the TPU tile does, so x depends on the lane grouping.
//
// Bound: at the bench configuration (n=5, m=1000, B=262144) the kernel reads
// 6.29 GB of A and b and writes O(n*B) results, about 1.9 ms at the H100 SXM's
// 3.35 TB/s data-sheet peak; the solve is ~60 flops per lane per iteration. So
// the kernel is memory-bound, and this first design relies on many resident CTAs
// per SM to hide one CTA's solve phase behind the others' loads (the TPU needed
// the _overlap_kernel for that). Sums are taken in blocks of kRowBlock rows to
// keep the sequential f32 accumulation error near the pairwise sums of the twin.
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

template <int N>
__global__ void __launch_bounds__(kMaxThreads)
    fused_lasso_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                             const float* __restrict__ alpha1,
                             const float* __restrict__ alpha2,
                             const float* __restrict__ betas, float* __restrict__ X_out,
                             int* __restrict__ iters_out, float* __restrict__ gap_out,
                             int* __restrict__ done_out, int64_t m, int64_t B, int pl_iters,
                             float l_safety, float t_init, int chunk, int k_end, float tol) {
  constexpr int NA = N + 1;
  constexpr int NP = NA * (NA + 1) / 2;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = lane < B;

  // ---- build: one pass over this lane's rows of [A|b] ----
  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.f;
  if (valid) {
    const int64_t plane = m * B;
    for (int64_t r0 = 0; r0 < m; r0 += kRowBlock) {
      const int64_t r1 = (r0 + kRowBlock < m) ? r0 + kRowBlock : m;
      float part[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) part[p] = 0.f;
#pragma unroll 4
      for (int64_t r = r0; r < r1; ++r) {
        const int64_t off = r * B + lane;
        float col[NA];
#pragma unroll
        for (int k = 0; k < N; ++k) col[k] = __ldg(A + k * plane + off);
        col[N] = __ldg(b + off);
#pragma unroll
        for (int i = 0; i < NA; ++i) {
#pragma unroll
          for (int k = i; k < NA; ++k) part[pair_index(i, k, NA)] += col[i] * col[k];
        }
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[p] += part[p];
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
  for (int it = 0; it < pl_iters; ++it) {
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
  const float a1 = valid ? alpha1[lane] : 0.f;
  const float a2 = valid ? alpha2[lane] : 0.f;
  const float L = (lam > 0.f ? l_safety * lam : 1.f) + a2;
  const float tau = t_init / L;
  const float thr = tau * a1;

  // ---- certified solve ----
  float X[N], Y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) X[i] = Y[i] = 0.f;
  bool done = !valid;
  int iters = 0;
  float gap = INFINITY;
  for (int k = 0; k < k_end;) {
    if (!__syncthreads_or(!done)) break;
    for (int i = 0; i < chunk; ++i) {
      const float beta = __ldg(betas + k + i);
      float QY[N];
      gram_matvec<N>(Q, Y, QY);
#pragma unroll
      for (int f = 0; f < N; ++f) {
        const float grad = QY[f] + a2 * Y[f] - c[f];
        const float xn = soft_threshold(Y[f] - tau * grad, thr);
        Y[f] = xn + beta * (xn - X[f]);
        X[f] = xn;
      }
    }
    k += chunk;
    bool finite = true;
#pragma unroll
    for (int f = 0; f < N; ++f) finite = finite && isfinite(X[f]);
    const float gp = finite ? rel_gap<N>(Q, c, X, a1, a2, btb) : INFINITY;
    if (!done) {
      iters = k;
      gap = gp;
      done = (gp <= tol) || !finite;
    }
  }

  if (valid) {
#pragma unroll
    for (int f = 0; f < N; ++f) X_out[f * B + lane] = X[f];
    iters_out[lane] = iters;
    gap_out[lane] = gap;
    done_out[lane] = done ? 1 : 0;
  }
}

template <int N>
void launch(const float* A, const float* b, const float* a1, const float* a2,
            const float* betas, float* X, int* iters, float* gap, int* done, int64_t m,
            int64_t B, int b_tile, int pl_iters, float l_safety, float t_init, int chunk,
            int k_end, float tol, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((B + b_tile - 1) / b_tile);
  fused_lasso_solve_kernel<N><<<grid, b_tile, 0, stream>>>(
      A, b, a1, a2, betas, X, iters, gap, done, m, B, pl_iters, l_safety, t_init, chunk,
      k_end, tol);
}

}  // namespace

// Returns a cudaError_t as int: cudaErrorInvalidValue for a feature count
// outside 1..8 or a b_tile that is not a multiple of 32 in 32..256, else
// cudaGetLastError() after the launch.
extern "C" int fused_lasso_solve(const float* A, const float* b, const float* alpha1,
                                 const float* alpha2, const float* betas, float* X,
                                 int* iters, float* gap, int* done, int n, long long m,
                                 long long B, int b_tile, int pl_iters, float l_safety,
                                 float t_init, int chunk, int k_end, float tol,
                                 void* stream) {
  if (b_tile < 32 || b_tile > kMaxThreads || b_tile % 32 != 0 || B <= 0 || m <= 0 ||
      chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FOS_CASE(NN)                                                                   \
  case NN:                                                                             \
    launch<NN>(A, b, alpha1, alpha2, betas, X, iters, gap, done, m, B, b_tile, pl_iters, \
               l_safety, t_init, chunk, k_end, tol, s);                                \
    break;
  switch (n) {
    FOS_CASE(1)
    FOS_CASE(2)
    FOS_CASE(3)
    FOS_CASE(4)
    FOS_CASE(5)
    FOS_CASE(6)
    FOS_CASE(7)
    FOS_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOS_CASE
  return static_cast<int>(cudaGetLastError());
}

// Name of a cudaError_t, for the Python wrappers' error messages.
extern "C" const char* fos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
