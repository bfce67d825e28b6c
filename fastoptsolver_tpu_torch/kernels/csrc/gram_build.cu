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
//   rows in stages of 8 rows x 32 features x 32 lanes (one 128-byte line per feature
//   and row, 32 KB), keeping a 4 x 8 tile of pair sums per thread in registers,
//   summed in blocks of 32 rows (like fused_solve.cu) so the f32 error stays near
//   the twin's blocked sums. A lane tile's data is read once per feature-block row
//   of the triangle (nb = ceil(na/16) times per block of I); the CTAs of one lane
//   tile run side by side (the pair index is the fast grid axis), so most of those
//   reads are served by the 50 MB L2.
//   The stages go through a ring of kStages = 3 slots of dynamic shared memory (96
//   KB, so 2 CTAs of 256 threads share an SM) filled by cp.async: while stage s is
//   summed, the copies of s+1 and s+2 are in flight, and one __syncthreads() per
//   stage guards a slot's reuse. Copies are 16 bytes (cp.async.cg, 8 per line) when
//   B % 4 == 0 and A, b are 16-byte aligned, else 4 bytes (cp.async.ca); the
//   ragged edges (rows >= m, features >= na, lanes >= B) are zero-filled by a
//   src-size of 0. The per-pair arithmetic (thread -> tile map, row order, fmaf
//   chain, 32-row partial sums) is that of the one-stage kernel it replaces, so Q,
//   c and b^T b are bit-identical to it at every copy width.
//   Bounds at the full-width shape (n=96, m=192, B=54144): 6.05 GB of device
//   traffic (A and b read once, Q, c and b^T b written once; 1.81 ms at 3.35 TB/s);
//   4753 pair sums per lane, computed as 28 blocks of 256 (1.5x the triangle),
//   ~7.4e10 FMAs (~2.2 ms at 67 TFLOP/s); and 32.3 GB copied from L2 (each of the
//   nb = 7 feature blocks is staged nb + 1 = 8 times a lane tile: 8 x 97 features x
//   192 rows x 128 B x 1692 tiles; the copies of the 15 padded features of block 6
//   read nothing). Measured by chip_smoke.py phase 6 on an H100 80GB HBM3 (700 W):
//   ~6.5 ms, so ~5.0 TB/s of L2 -> SM reads, against 42.9 ms for the one-stage
//   kernel (loads, then sums, 24 times a CTA with nothing in flight) and ~37 ms for
//   one torch.einsum of the same pair sums; ptxas: 124 registers (16-byte copies),
//   120 (4-byte), no spill. What bounds it now is not yet profiled: the L2 reads and
//   the shared-memory pipe (12 reads a row per thread, ~112 GB, plus the ring's
//   writes) are both near the measured time. Larger feature blocks (fewer
//   re-reads) and no padded pairs in diagonal blocks are the next steps; TF32
//   tensor cores are ruled out (the certificate needs f32).
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
constexpr int kStageRows = 8;    // rows per stage of the ring
constexpr int kStages = 3;       // stages in the ring: copies of two ahead in flight
constexpr int kBlockRows = 32;   // rows per partial sum
constexpr int kTI = 4, kTK = 8;  // a thread's tile of pair sums
constexpr int kPairThreads = kLanes * (kFB / kTI) * (kFB / kTK);  // 256
constexpr int kStageFloats = kStageRows * 2 * kFB * kLanes;       // 8192: 32 KB

// One asynchronous copy of kVec floats (4 or 16 bytes) into shared memory;
// src-size 0 (valid false) reads nothing and fills the destination with +0.
template <int kVec>
__device__ __forceinline__ void copy_async(uint32_t dst, const float* src, bool valid) {
  const int bytes = valid ? 4 * kVec : 0;
  if constexpr (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kVec: floats per copy, 4 (B % 4 == 0 and 16-byte aligned bases) or 1.
template <int kVec>
__global__ void __launch_bounds__(kPairThreads, 2)
    gram_pairs_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ Q, float* __restrict__ c, float* __restrict__ btb,
                      int n, int64_t m, int64_t B, int nb) {
  // kStages x [kStageRows][2 * kFB][kLanes]: one 128-byte line per feature and row
  extern __shared__ __align__(16) float ring[];
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

  // This thread's copies: kCopyF features, one chunk of kVec lanes each, in
  // every row of a stage. kChunks neighbouring threads copy one 128-byte line.
  constexpr int kChunks = kLanes / kVec;
  constexpr int kFStride = kPairThreads / kChunks;
  constexpr int kCopyF = 2 * kFB / kFStride;  // 1 at 16 bytes, 4 at 4 bytes
  const int cl = (tid % kChunks) * kVec;      // the chunk's first lane
  const bool lane_ok = lane0 + cl < B;        // B % 4 == 0: all kVec lanes or none
  const float* src[kCopyF];
  bool feat_ok[kCopyF];
  uint32_t dst[kCopyF];
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
#pragma unroll
  for (int q = 0; q < kCopyF; ++q) {
    const int f = tid / kChunks + q * kFStride;
    const int g = (f < kFB) ? I * kFB + f : K * kFB + (f - kFB);
    feat_ok[q] = lane_ok && g < na;
    src[q] = feat_ok[q] ? ((g < n) ? A + g * plane : b) + lane0 + cl : A;
    dst[q] = ring_s + static_cast<uint32_t>((f * kLanes + cl) * 4);
  }
  // stage st -> slot st % kStages; rows past m, features past na and lanes
  // past B are zero-filled, as the loads of the one-stage kernel were
  auto issue = [&](int64_t st, int slot) {
#pragma unroll
    for (int r = 0; r < kStageRows; ++r) {
      const int64_t row = st * kStageRows + r;
      const uint32_t off =
          static_cast<uint32_t>((slot * kStageFloats + r * 2 * kFB * kLanes) * 4);
#pragma unroll
      for (int q = 0; q < kCopyF; ++q) {
        const bool ok = feat_ok[q] && row < m;
        copy_async<kVec>(dst[q] + off, ok ? src[q] + row * B : A, ok);
      }
    }
  };

  float acc[kTI][kTK], part[kTI][kTK];
#pragma unroll
  for (int a = 0; a < kTI; ++a)
#pragma unroll
    for (int q = 0; q < kTK; ++q) acc[a][q] = part[a][q] = 0.f;

  const int64_t n_stages = (m + kStageRows - 1) / kStageRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) issue(s, s);
    commit_copies();  // one group per stage, empty past the last
  }
  int slot = 0;
  for (int64_t st = 0; st < n_stages; ++st) {
    wait_copies<kStages - 2>();  // this thread's copies of stage st have landed
    __syncthreads();  // everyone's have, and stage st-1's slot is consumed
    const int next = (slot + kStages - 1) % kStages;
    if (st + kStages - 1 < n_stages) issue(st + kStages - 1, next);
    commit_copies();
    const float* stage = ring + slot * kStageFloats;
#pragma unroll
    for (int r = 0; r < kStageRows; ++r) {
      float ai[kTI], ak[kTK];
#pragma unroll
      for (int a = 0; a < kTI; ++a) ai[a] = stage[(r * 2 * kFB + i0 + a) * kLanes + tx];
#pragma unroll
      for (int q = 0; q < kTK; ++q) ak[q] = stage[(r * 2 * kFB + kFB + k0 + q) * kLanes + tx];
#pragma unroll
      for (int a = 0; a < kTI; ++a)
#pragma unroll
        for (int q = 0; q < kTK; ++q) part[a][q] = fmaf(ai[a], ak[q], part[a][q]);
    }
    const int64_t r1 = (st + 1) * kStageRows;
    if (r1 % kBlockRows == 0 || r1 >= m) {
#pragma unroll
      for (int a = 0; a < kTI; ++a)
#pragma unroll
        for (int q = 0; q < kTK; ++q) {
          acc[a][q] += part[a][q];
          part[a][q] = 0.f;
        }
    }
    slot = (slot + 1) % kStages;
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

// Shared memory of gram_pairs' ring, in bytes: 96 KB, two CTAs per SM.
extern "C" long long gram_pairs_smem_bytes() {
  return static_cast<long long>(kStages) * kStageFloats * 4;
}

// Shared memory of gram_power at feature count n, in bytes.
extern "C" long long gram_power_smem_bytes(int n) {
  return (static_cast<long long>(n) * (n + 1) / 2 + n + kPWarps) * kPLanes * 4;
}

namespace {

template <int kVec>
int launch_pairs(const float* A, const float* b, float* Q, float* c, float* btb, int n,
                 long long m, long long B, int nb, dim3 grid, cudaStream_t stream) {
  const int smem = static_cast<int>(gram_pairs_smem_bytes());
  const cudaError_t err = cudaFuncSetAttribute(
      gram_pairs_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_pairs_kernel<kVec><<<grid, kPairThreads, smem, stream>>>(A, b, Q, c, btb, n, m, B, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The width in bytes of gram_pairs' copies from A and b: 16 when B % 4 == 0 and
// both bases are 16-byte aligned (then each 16-byte piece of a lane tile's line
// lies wholly inside B or wholly past it), else 4.
extern "C" int gram_pairs_copy_bytes(long long B, const void* A, const void* b) {
  const bool wide = B % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return wide ? 16 : 4;
}

// Q (n, n, B), c (n, B), btb (B,) from A (n, m, B) and b (m, B), with the copies
// gram_pairs_copy_bytes picks. Returns a cudaError_t as int: cudaErrorInvalidValue
// for an empty shape, else the attribute call's error or cudaGetLastError() after
// the launch.
extern "C" int gram_pairs(const float* A, const float* b, float* Q, float* c, float* btb,
                          int n, long long m, long long B, void* stream) {
  if (n < 1 || m < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + 1 + kFB - 1) / kFB;
  const dim3 grid(nb * (nb + 1) / 2, static_cast<unsigned>((B + kLanes - 1) / kLanes));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gram_pairs_copy_bytes(B, A, b) == 16
             ? launch_pairs<4>(A, b, Q, c, btb, n, m, B, nb, grid, st)
             : launch_pairs<1>(A, b, Q, c, btb, n, m, B, nb, grid, st);
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
