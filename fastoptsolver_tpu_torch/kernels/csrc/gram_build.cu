// gram_pairs + gram_power — the Gram build of the two-kernel path, two launches.
//
// Replaces the TPU kernel fastoptsolver_tpu/kernels/gram_build.py:_gram_tile_kernel
// (launched by _build): one pass over A (n, m, B) and b (m, B), feature-leading,
// instances (lanes) on the contiguous last axis, writing Q = A^T A (n, n, B) with
// both triangles, c = A^T b (n, B), b^T b (B,) and the power-iteration estimate of
// lambda_max(Q) (B,). The plain twin is gram_build.gram_build_reference
// (kernels/_common.py: augmented_gram, make_matvec, power_lambda_max).
//
// A TPU grid runs in order and carries the pair sums across its row steps in VMEM;
// Hopper's blocks run in no order, so the row loop lives inside the block and the
// work is split in two launches:
//
// gram_pairs — grid (block of the augmented upper triangle, tile of 32 lanes). The
//   augmented matrix [A|b] has na = n+1 columns, cut into blocks of 16 features; a
//   CTA owns one pair of feature blocks (I <= K) of one lane tile and walks all m
//   rows, staging 8 rows x 32 features x 32 lanes of [A|b] in shared memory (one
//   128-byte line per feature and row) and keeping a 4 x 8 tile of pair sums per
//   thread in registers, summed in blocks of 32 rows (like fused_solve.cu) so the
//   f32 error stays near the twin's blocked sums. A lane tile's data is read once
//   per feature-block row of the triangle (nb = ceil(na/16) times per block of I);
//   the CTAs of one lane tile run side by side (the pair index is the fast grid
//   axis), so most of those reads are served by the 50 MB L2.
//   Bound at the full-width shape (n=96, m=192, B=54144): 4753 pair sums per lane,
//   4.9e10 FMAs, computed as 28 blocks of 256 (7168 per lane, 1.5x the triangle):
//   ~7.4e10 FMAs, ~2.2 ms at the card's 67 TFLOP/s f32 peak, against 4.0 GB of A read
//   once (~1.2 ms at 3.35 TB/s) plus 2.0 GB of Q written. Measured on an H100 80GB
//   HBM3 (700 W) it takes ~48 ms with the Q copy-in of gram_power: neither bound is
//   reached, because a stage is loaded and then computed with only 2 CTAs per SM
//   (128 registers) to hide the load latency. Double-buffered stages (cp.async)
//   are the next step; TF32 tensor cores are ruled out (the certificate needs f32).
//
// gram_power — grid (tile of 8 lanes). pl_iters power steps per lane from
//   v0 = c/max(|c|, 1e-30): w = Qv, lam = |w|, v = w/max(lam, 1e-30). Reading Q
//   from device memory every step would read the Gram pl_iters times (~192 GB at
//   full width), the cost the TPU kernel exists to avoid. So each CTA copies the
//   upper triangles of its 8 lanes into shared memory once (8 lanes x n(n+1)/2
//   floats: 149 KB at n = 96, one 32-byte sector per pair) and iterates there; Q
//   is read from device memory once. The shared-memory block of 227 KB bounds the
//   feature count (n <= 118, gram_build._auto_tiles). One CTA fits per SM at n=96,
//   so the matvec's instruction stream bounds this launch: 96 steps x 9216
//   shared-memory reads per lane, each behind the triangle's index arithmetic
//   (~39 ms at full width, measured as above). The matvec sums over k in order
//   with a separate multiply and add (this file is built with --fmad=false),
//   exactly as the twin's make_matvec does, so only the norm's summation order
//   differs from the twin.
//
// Ragged edges are masked in-kernel: lanes >= B and features >= na load 0 and store
// nothing. Offsets are 64-bit (n*m*B is 1.0e9 at full width). Built without
// --use_fast_math: the divisions and square roots are IEEE.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---- gram_pairs ----
constexpr int kLanes = 32;       // lanes per CTA (threadIdx.x)
constexpr int kFB = 16;          // features per block of the augmented triangle
constexpr int kStageRows = 8;    // rows staged in shared memory at a time
constexpr int kBlockRows = 32;   // rows per partial sum
constexpr int kTI = 4, kTK = 8;  // a thread's tile of pair sums
constexpr int kPairThreads = kLanes * (kFB / kTI) * (kFB / kTK);  // 256

__global__ void __launch_bounds__(kPairThreads)
    gram_pairs_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ Q, float* __restrict__ c, float* __restrict__ btb,
                      int n, int64_t m, int64_t B, int nb) {
  __shared__ float stage[kStageRows][2 * kFB][kLanes];
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;   // lane within the tile
  const int ty = tid / kLanes;   // 0..7: which 4 x 8 tile of the 16 x 16 block
  const int i0 = (ty / 2) * kTI;
  const int k0 = (ty % 2) * kTK;
  // block pair p -> (I, K), I <= K, row-major over the upper triangle of blocks
  int I = 0, p = blockIdx.x;
  while (p >= nb - I) {
    p -= nb - I;
    ++I;
  }
  const int K = I + p;
  const int na = n + 1;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.y) * kLanes;
  const int64_t plane = m * B;

  float acc[kTI][kTK], part[kTI][kTK];
#pragma unroll
  for (int a = 0; a < kTI; ++a)
#pragma unroll
    for (int q = 0; q < kTK; ++q) acc[a][q] = part[a][q] = 0.f;

  for (int64_t r0 = 0; r0 < m; r0 += kStageRows) {
    __syncthreads();  // the previous stage is consumed
    // load kStageRows x 32 features x 32 lanes: 8 elements per thread
    for (int e = tid; e < kStageRows * 2 * kFB * kLanes; e += kPairThreads) {
      const int l = e % kLanes;
      const int f = (e / kLanes) % (2 * kFB);
      const int r = e / (kLanes * 2 * kFB);
      const int g = (f < kFB) ? I * kFB + f : K * kFB + (f - kFB);
      const int64_t row = r0 + r;
      const int64_t lane = lane0 + l;
      float v = 0.f;
      if (row < m && lane < B && g < na)
        v = (g < n) ? __ldg(A + g * plane + row * B + lane) : __ldg(b + row * B + lane);
      stage[r][f][l] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStageRows; ++r) {
      float ai[kTI], ak[kTK];
#pragma unroll
      for (int a = 0; a < kTI; ++a) ai[a] = stage[r][i0 + a][tx];
#pragma unroll
      for (int q = 0; q < kTK; ++q) ak[q] = stage[r][kFB + k0 + q][tx];
#pragma unroll
      for (int a = 0; a < kTI; ++a)
#pragma unroll
        for (int q = 0; q < kTK; ++q) part[a][q] = fmaf(ai[a], ak[q], part[a][q]);
    }
    if ((r0 + kStageRows) % kBlockRows == 0 || r0 + kStageRows >= m) {
#pragma unroll
      for (int a = 0; a < kTI; ++a)
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
          acc[a][q] += part[a][q];
          part[a][q] = 0.f;
        }
    }
  }

  const int64_t lane = lane0 + tx;
  if (lane >= B) return;
#pragma unroll
  for (int a = 0; a < kTI; ++a) {
#pragma unroll
    for (int q = 0; q < kTK; ++q) {
      const int gi = I * kFB + i0 + a;
      const int gk = K * kFB + k0 + q;
      if (gi >= na || gk >= na) continue;
      const float v = acc[a][q];
      if (gi < n && gk < n) {
        // a diagonal block computes both triangles itself; an off-diagonal one
        // holds only gi < gk and writes the mirror too
        Q[(static_cast<int64_t>(gi) * n + gk) * B + lane] = v;
        if (I != K) Q[(static_cast<int64_t>(gk) * n + gi) * B + lane] = v;
      } else if (gi < n && gk == n) {
        c[static_cast<int64_t>(gi) * B + lane] = v;
      } else if (gi == n && gk == n) {
        btb[lane] = v;
      }
    }
  }
}

// ---- gram_power ----
constexpr int kPLanes = 8;                    // lanes per CTA: one 32-byte sector
constexpr int kPThreads = 256;
constexpr int kPRows = kPThreads / kPLanes;   // 32 row groups
constexpr int kPMaxRows = 4;                  // rows per thread: n <= 128
constexpr int kPWarps = kPThreads / 32;

__device__ __forceinline__ int tri(int i, int k, int n) {
  // upper-triangle pair (i, k), i <= k, row-major
  return i * n - (i * (i - 1)) / 2 + (k - i);
}

// Sum of one lane's values over the 32 row groups, in a fixed order; every thread
// of the lane gets the total. Thread t holds lane t % 8, row group t / 8, so a warp
// holds 4 row groups of all 8 lanes.
__device__ __forceinline__ float lane_total(float part, float* red, int tid) {
  part += __shfl_xor_sync(0xffffffffu, part, 8);
  part += __shfl_xor_sync(0xffffffffu, part, 16);
  const int warp = tid / 32, l = tid % kPLanes;
  if ((tid % 32) < kPLanes) red[warp * kPLanes + l] = part;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kPWarps; ++w) s += red[w * kPLanes + l];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kPThreads)
    gram_power_kernel(const float* __restrict__ Q, const float* __restrict__ c,
                      float* __restrict__ lam, int n, int64_t B, int pl_iters) {
  extern __shared__ float smem[];
  const int npairs = n * (n + 1) / 2;
  float* T = smem;                        // [npairs][8]
  float* v = T + npairs * kPLanes;        // [n][8]
  float* red = v + n * kPLanes;           // [8 warps][8]
  const int tid = threadIdx.x;
  const int l = tid % kPLanes;
  const int rg = tid / kPLanes;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * kPLanes;
  const int64_t lane = lane0 + l;
  const bool valid = lane < B;

  // Q's upper triangles of the 8 lanes, read from device memory once
  for (int i = 0; i < n; ++i) {
    const int base = tri(i, i, n);
    for (int q = tid; q < (n - i) * kPLanes; q += kPThreads) {
      const int k = i + q / kPLanes;
      const int ql = q % kPLanes;
      const int64_t ln = lane0 + ql;
      T[(base + q / kPLanes) * kPLanes + ql] =
          (ln < B) ? __ldg(Q + (static_cast<int64_t>(i) * n + k) * B + ln) : 0.f;
    }
  }
  // v0 = c / max(|c|, 1e-30)
  float w[kPMaxRows];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < kPMaxRows; ++j) {
    const int i = rg + j * kPRows;
    w[j] = (valid && i < n) ? __ldg(c + static_cast<int64_t>(i) * B + lane) : 0.f;
    part += w[j] * w[j];
  }
  const float c_norm = fmaxf(sqrtf(lane_total(part, red, tid)), 1e-30f);
#pragma unroll
  for (int j = 0; j < kPMaxRows; ++j) {
    const int i = rg + j * kPRows;
    if (i < n) v[i * kPLanes + l] = w[j] / c_norm;
  }
  __syncthreads();

  float L = 0.f;
  for (int it = 0; it < pl_iters; ++it) {
    part = 0.f;
#pragma unroll
    for (int j = 0; j < kPMaxRows; ++j) {
      const int i = rg + j * kPRows;
      float acc = 0.f;
      if (i < n) {
        // out[i] = sum_k Q[k][i] v[k], k ascending, as the twin's make_matvec
        for (int k = 0; k < n; ++k) {
          const int p = (k <= i) ? tri(k, i, n) : tri(i, k, n);
          acc = acc + T[p * kPLanes + l] * v[k * kPLanes + l];
        }
      }
      w[j] = acc;
      part += acc * acc;
    }
    L = sqrtf(lane_total(part, red, tid));  // its syncs end every read of v
    const float d = fmaxf(L, 1e-30f);
#pragma unroll
    for (int j = 0; j < kPMaxRows; ++j) {
      const int i = rg + j * kPRows;
      if (i < n) v[i * kPLanes + l] = w[j] / d;
    }
    __syncthreads();
  }
  if (valid && rg == 0) lam[lane] = L;
}

}  // namespace

// Shared memory of gram_power at feature count n, in bytes.
extern "C" long long gram_power_smem_bytes(int n) {
  return (static_cast<long long>(n) * (n + 1) / 2 + n + kPWarps) * kPLanes * 4;
}

// Q (n, n, B), c (n, B), btb (B,) from A (n, m, B) and b (m, B). Returns a
// cudaError_t as int: cudaErrorInvalidValue for an empty shape, else
// cudaGetLastError() after the launch.
extern "C" int gram_pairs(const float* A, const float* b, float* Q, float* c, float* btb,
                          int n, long long m, long long B, void* stream) {
  if (n < 1 || m < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + 1 + kFB - 1) / kFB;
  const dim3 grid(nb * (nb + 1) / 2, static_cast<unsigned>((B + kLanes - 1) / kLanes));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  gram_pairs_kernel<<<grid, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, b, Q, c, btb, n, m, B, nb);
  return static_cast<int>(cudaGetLastError());
}

// lam (B,) = pl_iters power steps on Q (n, n, B) from v0 = c (n, B). Returns
// cudaErrorInvalidValue when n is outside 1..128 or the triangle block exceeds the
// card's shared memory per block, else cudaGetLastError() after the launch.
extern "C" int gram_power(const float* Q, const float* c, float* lam, int n, long long B,
                          int pl_iters, void* stream) {
  if (n < 1 || n > kPRows * kPMaxRows || B < 1 || pl_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = gram_power_smem_bytes(n);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(gram_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + kPLanes - 1) / kPLanes);
  gram_power_kernel<<<grid, kPThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(Q, c, lam, n, B, pl_iters);
  return static_cast<int>(cudaGetLastError());
}
