// qstream_burst — n_steps FISTA iterations of the Gram-form batched lasso with Q streamed
// from device memory at every step, one launch; the wide-n engine past the resident window.
//
// Replaces the TPU kernel fastoptsolver_tpu/kernels/qstream.py:_qstream_tile_kernel
// (launched by qstream_burst; the host loop of fista_vmem._solve_on_device runs one launch
// per burst of check_every iterations). Semantics follow the reference's kernel and
// kernels/_common.py (fista_general_chunk, gram_rel_gap_from_qx); the plain twin is
// fastoptsolver_tpu_torch/kernels/qstream.py:_qstream_burst_reference. Modes: fixed
// momentum (beta from a global table at the absolute iteration k0 + i: nesterov or delta),
// nesterov with adaptive restart (per-lane t and previous step norm), greedy (per-lane tau
// and first-step norm, floor taumin). No Armijo: each trial round would be one more pass
// over Q, a data-dependent number of them (the reference refuses it too). With with_gap one
// more pass over Q accumulates Q.X and the per-lane relative duality gap of the final X is
// written.
//
// Layout: Q (n, n, B), c, X, Y (n, B), per-lane rows (B,), lanes on the contiguous last
// axis. A CTA owns LT lanes (threadIdx.x) and R row groups (threadIdx.y), 512 threads:
// (LT, R) = (32, 16) while X and Y of 32 lanes fit in shared memory (n <= 868), else
// (16, 32). Thread (lane, r) accumulates the matvec of features r, r+R, ... (J of them,
// a template constant, J >= n/R) in registers:
//   out[f] = sum_k Q[k][f] * Y[k]   (k ascending over the true n, a separate multiply and
// add: this file is built with --fmad=false, as the twin's plane loop rounds),
// so each k issues J independent loads, and a warp's loads of one (k, f) are one 128-byte
// line (LT = 32) or two 64-byte pieces (LT = 16). X and Y of the CTA's lanes live in
// shared memory (2 n LT floats: 64 KB at n = 256), the matvec reads Y there, and c is
// re-read from device memory (n B floats a step, 1/n of Q's traffic, served by L2).
//
// Bound: device-memory reads of Q, n^2 B 4 bytes per step and one more pass for the gap:
// 1.98 GB a step at n = 256, B = 7552, so >= 0.59 ms a step at the 3.35 TB/s data sheet.
// Nothing is held across steps but X and Y: the TPU kernel streamed Q in plane groups
// through VMEM for the same reason (a lane tile's Q does not fit on chip past n = 168).
// Per-lane sums over features add each thread's partials, then the R row groups in order,
// through shared memory.
//
// No lane depends on its neighbours. Lanes >= B load zeros and store nothing; they still
// reach every __syncthreads. Offsets are 64-bit. Built without --use_fast_math: the
// divisions and square roots are IEEE.
#include <cuda_runtime.h>

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

}  // namespace

// One burst. mode: 0 fixed (table beta), 1 nesterov + adaptive restart, 2 greedy. Rows
// tau, thr, a2, a1, btb, t, ps are (B,); taumin may be null (greedy only); betas needs
// k0 + n_steps entries in mode 0. Outputs Xo, Yo (n, B), to, pso, gap (B,); gap is 0
// unless with_gap. Returns a cudaError_t as int: cudaErrorInvalidValue for n outside
// 1..1016, an unknown mode, greedy without taumin, an empty batch, or shared memory past
// the card's block limit, else cudaGetLastError() after the launch.
extern "C" int qstream_burst(const float* Q, const float* c, const float* tau, const float* thr,
                             const float* a2, const float* a1, const float* btb,
                             const float* X, const float* Y, const float* t, const float* ps,
                             const float* taumin, const float* betas, float* Xo, float* Yo,
                             float* to, float* pso, float* gap, int n, long long B,
                             int n_steps, int k0, int mode, int with_gap,
                             float restart_threshold, float greedy_S, float greedy_shrink,
                             void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || n_steps < 0 || mode < kFixed || mode > kGreedy ||
      (mode == kGreedy && !taumin))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lt = lanes_per_cta(n, optin);
  const size_t smem = lt == 32 ? smem_bytes<32, 16>(n) : smem_bytes<16, 32>(n);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Q,  c,   tau, thr, a2,  a1,  btb, X,       Y,       t,
                 ps, taumin, betas, Xo, Yo, to, pso, gap, n, B, n_steps, k0, mode,
                 with_gap, restart_threshold, greedy_S, greedy_shrink};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lt == 32 ? launch_j(p, s) : launch<32, 16, 32>(p, s);
}
