// lipschitz_power — the per-lane power iteration of the torch Gram precompute: an estimate of
// lambda_max(Q) for every lane of an (n, n, B) Gram batch, all n_iter steps in one launch, each
// lane's Gram held in shared memory for all of its steps.
//
// Replaces no TPU kernel. The reference estimates L with an XLA while-loop
// (fastoptsolver_tpu/batch/fista_gram.py:_batched_power_L), which "re-reads the (n, n, B) Gram
// from HBM every step" (its make_gram_batch note); the port's torch loop
// (batch/fista_gram.py:_power_loop) does the same, one batched gemv over the whole Gram a step,
// with a host read of its stop before each step. This kernel runs every step and writes each
// step's estimate to a history (n_iter, B); kernels/lipschitz.py:power_L picks the step the loop
// stops at from that history on the device, so a call reads the host once. The plain twin is
// kernels/lipschitz.py:power_history_reference.
//
// Recipe (the loop's): v = v0 / max(|v0|, 1e-30); each step w = Q v (w[i] = sum_j Q[i][j] v[j]),
// L = |w|, v = w / max(L, 1e-30); hist[s] = L of step s + 1. Float32 summed in this kernel's own
// order with fused multiply-adds (L has no bit bar with the loop); the square roots and the
// divisions are IEEE (no --use_fast_math); NaN passes through max() as through torch.clamp_min.
//
// Design: one lane on a thread-block cluster of C CTAs (1, 2, 4 or 8: lipschitz_cluster_size,
// the smallest with at most 64 features a CTA, where this kernel's shared memory fits a block:
// n <= 664). CTA rank r owns the output features [r F, (r + 1) F), F = round_up(ceil(n / C), 4),
// and holds their rows of the lane's Q, n F floats, transposed to slab[j][f] (row stride P).
// - Copy-in, once: 4-byte cp.async through Q's own strides, consecutive threads on consecutive
//   j, so the reads are coalesced where j is Q's unit-stride axis (the einsum of
//   make_gram_batch leaves each lane's Gram contiguous, lanes outermost). P = F + 4 where F / 4
//   is even, so the transposed writes spread over 8 banks.
// - A step: every warp sums the squares of the lane's w (the whole vector sits in each CTA) in
//   one order, so every CTA gets the same |w|, and the CTA writes v = w / max(|w|, 1e-30) to its
//   shared memory. Thread (quad, segment) accumulates 4 features (one float4 of a slab row) over
//   one of 16 column segments of v; a warp holds 8 quads x 4 segments and adds its segments by 3
//   shuffles, the 4 warps of a quad group add theirs through shared memory. Each feature's owner
//   writes its new w into every CTA of the cluster (distributed shared memory), double-buffered
//   by step parity, and one cluster barrier ends the step: a buffer is rewritten only after the
//   barrier that ends its readers' step. (Remote mbarrier arrivals of each owner warp in the
//   barrier's place ran slower on the H100: PERF.md section 6.)
// Bound: device memory carries Q once (n^2 B 4 bytes: 1.98 GB at n = 256, B = 7552, 0.59 ms at
// 3.35 TB/s); each step reads every lane's slab from shared memory once (n^2 4 bytes a lane):
// 198 GB over 100 steps at n = 256, ~6 ms at 128 bytes a clock on 132 SMs at 1.98 GHz. Three
// CTAs an SM at n = 256 (72 KB each), so one CTA's copy-in runs under the others' steps.
//
// No lane depends on its neighbours. Features >= n and columns >= n are zero in the slab; every
// thread reaches every barrier. Offsets into Q and the history are 64-bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kTargetF = 64;         // features a CTA the size rule aims at
constexpr int kSegments = 16;        // column segments of v a quad group splits
constexpr int kSegWarps = 4;         // warps of a quad group, 4 segments each
constexpr int kMaxThreads = 512;     // F <= 128: 4 quad groups of 4 warps
constexpr long long kSmemLimit = 232448;  // the shared memory a Hopper block may use
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* Q;
  const float* v0;
  float* hist;
  long long si, sj, sb;  // Q's strides in elements: output feature, input feature, lane
  long long B;
  int n;
  int n_iter;
};

__host__ __device__ __forceinline__ int vec4(int n) { return (n + 3) / 4 * 4; }

// F: the features of a CTA of a C-CTA cluster, a multiple of 4 (a float4 of a slab row).
__host__ __device__ __forceinline__ int features(int n, int C) { return vec4((n + C - 1) / C); }

// P: the slab's row stride, F or F + 4, so that P / 4 is odd.
__host__ __device__ __forceinline__ int slab_stride(int F) { return (F / 4) % 2 ? F : F + 4; }

__host__ __device__ __forceinline__ int cta_threads(int n, int C) {
  return 32 * kSegWarps * ((features(n, C) + 31) / 32);
}

// A CTA's shared floats: the slab (nv rows of P), v, the two w buffers (nv each) and the
// quad groups' partial sums (kSegWarps F).
__host__ __device__ __forceinline__ long long cta_floats(int n, int C) {
  const int F = features(n, C), nv = vec4(n);
  return static_cast<long long>(nv) * slab_stride(F) + 3LL * nv +
         static_cast<long long>(kSegWarps) * F;
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v < lo) ? lo : v;  // NaN passes through, as torch.clamp_min
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// sum_j w[j]^2 over j < n in one order: lane l sums j = l, l + 32, ... ascending, then a
// butterfly; every lane of every warp that calls it on the same w gets the same bits.
__device__ __forceinline__ float sum_squares(const float* w, int n) {
  float s = 0.f;
  for (int j = threadIdx.x & 31; j < n; j += 32) s = fmaf(w[j], w[j], s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  return s;
}

__global__ void __launch_bounds__(kMaxThreads) lipschitz_cluster_kernel(Args a, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, nv = vec4(n), F = features(n, C), P = slab_stride(F);
  const int rank = static_cast<int>(cluster.block_rank());
  const int f0 = rank * F;
  const int tid = threadIdx.x, T = blockDim.x;
  const int64_t lane = blockIdx.x / C;  // 1-D clusters of C consecutive CTAs
  float* slab = smem;                                   // [nv][P]
  float* V = slab + static_cast<int64_t>(nv) * P;       // [nv]  v of this step
  float* W = V + nv;                                    // [2][nv] w, by step parity
  float* red = W + 2 * nv;                              // [kSegWarps][F]

  // copy-in: slab[j][i] = Q[f0 + i][j] of this lane, zero past n
  const float* Ql = a.Q + lane * a.sb;
  for (int e = tid; e < nv * F; e += T) {
    const int j = e % nv, i = e / nv;
    float* dst = slab + j * P + i;
    if (j < n && f0 + i < n) {
      const float* src = Ql + (f0 + i) * a.si + j * a.sj;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                   : "memory");
    } else {
      *dst = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = n + tid; j < nv; j += T) V[j] = 0.f;  // the float4 loads' tail
  cluster.sync();  // every CTA has started before any remote write
  if (tid < F && f0 + tid < n) {
    const float v = __ldg(a.v0 + (f0 + tid) * a.B + lane);
    for (int d = 0; d < C; ++d) *cluster.map_shared_rank(W + f0 + tid, d) = v;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();  // v0 whole in every CTA, the slab in place

  const int warp = tid >> 5, ln = tid & 31;
  const int qd = 8 * (warp / kSegWarps) + (ln & 7);  // the quad of features f0 + 4 qd ..
  const int sw = warp % kSegWarps;
  const int seg = 4 * sw + (ln >> 3);
  const bool active = 4 * qd < F;
  const int Ls = vec4((nv + kSegments - 1) / kSegments);
  const int j0 = seg * Ls, j1 = min(j0 + Ls, nv);
  const float* col = slab + 4 * qd;
  const bool hi = ln & 16, lo = ln & 8;

  for (int s = 0; s < a.n_iter; ++s) {
    const float* w = W + (s & 1) * nv;
    const float nrm = sqrtf(sum_squares(w, n));
    if (s > 0 && rank == 0 && tid == 0) a.hist[(s - 1) * a.B + lane] = nrm;
    const float den = clamp_min(nrm, 1e-30f);
    for (int j = tid; j < n; j += T) V[j] = w[j] / den;
    __syncthreads();

    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    if (active) {
#pragma unroll 2
      for (int j = j0; j < j1; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(V + j);
        const float4 q0 = *reinterpret_cast<const float4*>(col + j * P);
        const float4 q1 = *reinterpret_cast<const float4*>(col + (j + 1) * P);
        const float4 q2 = *reinterpret_cast<const float4*>(col + (j + 2) * P);
        const float4 q3 = *reinterpret_cast<const float4*>(col + (j + 3) * P);
        acc0 = fmaf(q0.x, v.x, acc0);
        acc1 = fmaf(q0.y, v.x, acc1);
        acc2 = fmaf(q0.z, v.x, acc2);
        acc3 = fmaf(q0.w, v.x, acc3);
        acc0 = fmaf(q1.x, v.y, acc0);
        acc1 = fmaf(q1.y, v.y, acc1);
        acc2 = fmaf(q1.z, v.y, acc2);
        acc3 = fmaf(q1.w, v.y, acc3);
        acc0 = fmaf(q2.x, v.z, acc0);
        acc1 = fmaf(q2.y, v.z, acc1);
        acc2 = fmaf(q2.z, v.z, acc2);
        acc3 = fmaf(q2.w, v.z, acc3);
        acc0 = fmaf(q3.x, v.w, acc0);
        acc1 = fmaf(q3.y, v.w, acc1);
        acc2 = fmaf(q3.z, v.w, acc2);
        acc3 = fmaf(q3.w, v.w, acc3);
      }
    }
    // the warp's 4 segments (lane bits 3-4): features 2 hi + {0, 1}, then feature 2 hi + lo
    float k0 = hi ? acc2 : acc0, k1 = hi ? acc3 : acc1;
    k0 += __shfl_xor_sync(kFull, hi ? acc0 : acc2, 16);
    k1 += __shfl_xor_sync(kFull, hi ? acc1 : acc3, 16);
    float k = lo ? k1 : k0;
    k += __shfl_xor_sync(kFull, lo ? k0 : k1, 8);
    if (active) red[sw * F + 4 * qd + (ln >> 3)] = k;
    __syncthreads();

    if (tid < F && f0 + tid < n) {
      float wn = red[tid];
      for (int r = 1; r < kSegWarps; ++r) wn += red[r * F + tid];
      float* dst = W + ((s + 1) & 1) * nv + f0 + tid;
      for (int d = 0; d < C; ++d) *cluster.map_shared_rank(dst, d) = wn;
    }
    cluster.sync();
  }
  // the last step's estimate; no CTA touches a peer's shared memory after the last barrier
  if (a.n_iter > 0 && rank == 0 && warp == 0) {
    const float nrm = sqrtf(sum_squares(W + (a.n_iter & 1) * nv, n));
    if (tid == 0) a.hist[(a.n_iter - 1) * a.B + lane] = nrm;
  }
}

bool valid_cluster(int C) { return C == 1 || C == 2 || C == 4 || C == 8; }

// The opt-in shared-memory limit of the current device, set on the kernel at its first use
// there; 0 after an error (err says which).
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
    err = cudaFuncSetAttribute(lipschitz_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return 0;
    optin_set[dev] = optin;
  }
  return optin_set[dev];
}

// The launch configuration of a launch at (n, C) over `clusters` lanes.
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

}  // namespace

// The cluster size of the kernel at feature count n: the smallest power of two C <= 8 with
// ceil(n / C) <= 64 features a CTA (8 past n = 512), or 0 where a CTA's shared memory at that
// size passes a Hopper block's 232,448 bytes (n > 664) or n < 1. There the torch loop serves.
extern "C" int lipschitz_cluster_size(int n) {
  if (n < 1) return 0;
  int C = 1;
  while (C < kMaxCluster && (n + C - 1) / C > kTargetF) C *= 2;
  return 4 * cta_floats(n, C) <= kSmemLimit ? C : 0;
}

// All n_iter power steps of every lane. Q: the (n, n, B) Gram at element strides (si, sj, sb)
// of its output-feature, input-feature and lane axes; v0 (n, B) contiguous, the start; hist
// (n_iter, B) contiguous, hist[s][l] = the estimate of lane l after step s + 1. cluster: 0
// takes lipschitz_cluster_size(n), else 1, 2, 4 or 8 (timings force a size). Returns a
// cudaError_t as int: cudaErrorInvalidValue for n, B or n_iter below 1, a null pointer, a
// negative stride, an unknown cluster size, more than 512 threads a CTA, too many CTAs for one
// grid, or shared memory past the card's block limit; cudaErrorInvalidConfiguration where the
// card holds no cluster of that size; else cudaGetLastError() after the launch.
extern "C" int lipschitz_power(const float* Q, const float* v0, float* hist, int n, long long B,
                               int n_iter, long long si, long long sj, long long sb, int cluster,
                               void* stream) {
  if (n < 1 || B < 1 || n_iter < 1 || !Q || !v0 || !hist || si < 0 || sj < 0 || sb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = cluster != 0 ? cluster : lipschitz_cluster_size(n);
  if (!valid_cluster(C) || B * C > INT_MAX || cta_threads(n, C) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int optin = cluster_optin(err);
  if (optin == 0) return static_cast<int>(err);
  if (4 * cta_floats(n, C) > optin) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ClusterLaunch L(n, C, B, s);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, lipschitz_cluster_kernel, &L.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{Q, v0, hist, si, sj, sb, B, n, n_iter};
  err = cudaLaunchKernelEx(&L.cfg, lipschitz_cluster_kernel, a, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
