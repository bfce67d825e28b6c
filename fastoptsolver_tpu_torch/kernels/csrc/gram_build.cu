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
//   Launched alone, with no power steps, it builds the resident engine's Gram at every
//   width of that window (n <= 168): neither its ring nor its grid depends on n. At n =
//   128, m = 256, B = 30464 it copies 40.2 GB from L2 in 7.85 ms (5.1 TB/s), and 48.1 GB
//   in 8.42 ms at n = 168, m = 336, B = 17664 (H100 80GB HBM3, 700 W), in place of ~50 ms
//   of einsum and layout copies.
//
// gram_power — the resident kernel's layout (csrc/resident.cu): features on threads,
//   round_up(n, 32) threads a lane and G = gram_power_group(n) lanes a CTA (10 at n = 96,
//   8 at 118). pl_iters power steps per lane from v0 = c/max(|c|, 1e-30): w = Qv,
//   lam = |w|, v = w/max(lam, 1e-30). Reading Q from device memory every step would read
//   the Gram pl_iters times (~192 GB at full width), the cost the TPU kernel exists to
//   avoid. So each CTA copies its lanes' upper triangles into shared memory once (the
//   resident kernel's copy-in) and iterates there: the matvec is tri_matvec.cuh's, v read
//   as 16-byte broadcasts and the triangle walked in warp-uniform segments, k ascending
//   with a separate multiply and add (this file is built with --fmad=false), exactly as
//   the twin's make_matvec. The norm |w| is summed in lane_norm2's fixed order (that of
//   the earlier 8-lane layout, so lam is its bits); only the norm's order differs from
//   the twin. Bound: the matvec's shared-memory reads, 96 steps x n^2 words a lane,
//   191.6 GB at n = 96, B = 54144 (~6-7 ms at 128 B a clock on 132 SMs). Measured there on
//   an H100 80GB HBM3 at 700 W, in turns with the 8-lane layout (256 threads, 8 warps an
//   SM, a select and a 4-byte load of v a term): 18.5 ms against 43.2, with 30 warps an
//   SM. The window of the build with power steps stays n <= 118 (gram_build.MAX_N): this
//   block would hold lanes past it, but the window routes the build and is kept where it
//   was.
//
// Ragged edges are masked in-kernel: lanes >= B and features >= na load 0 and store
// nothing. Offsets are 64-bit (n*m*B is 1.0e9 at full width). Built without
// --use_fast_math: the divisions and square roots are IEEE.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tri_matvec.cuh"

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
constexpr int kPMaxThreads = 1024;
constexpr int kPMaxGroup = 32;  // lanes per CTA at most
constexpr int kPMaxN = 128;     // a lane's norm: one warp, rows r, r+32, r+64, r+96
constexpr int kPowerUnroll = 8;  // terms a body of tri_matvec.cuh's walk: the faster here

__host__ __device__ constexpr int power_lane_threads(int n) { return (n + 31) / 32 * 32; }

// Shared floats of one lane: its iterate and its squares (vec_stride each), its triangle.
__host__ __device__ constexpr long long power_lane_floats(int n) {
  return 2LL * tri::vec_stride(n) + tri::npairs(n);
}

// The lane's sum of sq[0 .. n-1] in a fixed order: row group r (one thread of the warp)
// adds rows r, r+32, r+64, r+96 from 0; groups pair as (p0 + p1) + (p2 + p3) within each
// 4; the 8 sums of 4 are added in order from 0. That is the order of the build's earlier
// 8-lanes-a-CTA layout, so lam did not move with the layout. Every thread of the warp gets
// the total, so each warp of the lane computes it alone, with no barrier.
__device__ __forceinline__ float lane_norm2(const float* sq, int n) {
  const int r = threadIdx.x & 31;
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < kPMaxN / 32; ++j)
    if (r + 32 * j < n) part += sq[r + 32 * j];
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) s += __shfl_sync(0xffffffffu, part, 4 * q);
  return s;
}

// The resident kernel's layout: features on threads (thread (g, i): feature i of lane g),
// G lanes a CTA; shared memory [G][2][vec_stride] (the iterate v, the squares sq) then
// [G][npairs] triangles.
__global__ void __launch_bounds__(kPMaxThreads)
    gram_power_kernel(const float* __restrict__ Q, const float* __restrict__ c,
                      float* __restrict__ lam, int n, int64_t B, int G, int pl_iters) {
  extern __shared__ __align__(16) float smem[];
  const int nt = power_lane_threads(n);
  const int n4 = tri::vec_stride(n);
  const int g = threadIdx.x / nt, i = threadIdx.x % nt;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * G;
  const int64_t lane = lane0 + g;
  const bool valid = lane < B, feat = i < n;
  float* v = smem + 2 * g * n4;
  float* sq = v + n4;
  float* T0 = smem + 2 * G * n4;
  const float* T = T0 + static_cast<int64_t>(g) * tri::npairs(n);

  // Q's upper triangles of the G lanes, read from device memory once
  tri::copy_in(T0, Q, n, B, lane0, G);
  // v0 = c / max(|c|, 1e-30)
  const float cf = (valid && feat) ? __ldg(c + static_cast<int64_t>(i) * B + lane) : 0.f;
  if (feat) sq[i] = cf * cf;
  __syncthreads();
  const float c_norm = fmaxf(sqrtf(lane_norm2(sq, n)), 1e-30f);
  if (feat) v[i] = cf / c_norm;
  __syncthreads();

  float L = 0.f;
  for (int it = 0; it < pl_iters; ++it) {
    const float w = feat ? tri::matvec<kPowerUnroll>(T, v, n, i) : 0.f;
    if (feat) sq[i] = w * w;
    __syncthreads();  // every read of v is done and sq is whole
    L = sqrtf(lane_norm2(sq, n));
    const float d = fmaxf(L, 1e-30f);
    if (feat) v[i] = w / d;
    __syncthreads();  // v is whole and every read of sq is done
  }
  if (valid && i == 0) lam[lane] = L;
}

int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

}  // namespace

// Shared memory of gram_pairs' ring, in bytes: 96 KB, two CTAs per SM.
extern "C" long long gram_pairs_smem_bytes() {
  return static_cast<long long>(kStages) * kStageFloats * 4;
}

// gram_power's lanes per CTA at feature count n on the current device: as many as the
// card's opt-in shared memory per block and 1024 threads (round_up(n, 32) a lane) hold, at
// most 32, the rule of resident.cu's resident_group on gram_power's own bytes. 0 for n
// outside 1..128, minus a cudaError_t if the device query fails.
extern "C" int gram_power_group(int n) {
  if (n < 1 || n > kPMaxN) return 0;
  int optin = 0;
  const int err = optin_smem(&optin);
  if (err) return -err;
  const long long by_smem = optin / (4 * power_lane_floats(n));
  const int by_threads = kPMaxThreads / power_lane_threads(n) < kPMaxGroup
                             ? kPMaxThreads / power_lane_threads(n)
                             : kPMaxGroup;
  return by_smem < by_threads ? static_cast<int>(by_smem) : by_threads;
}

// The dynamic shared memory, in bytes, of a gram_power CTA of gram_power_group(n) lanes
// (0 where that is not positive).
extern "C" long long gram_power_smem_bytes(int n) {
  const int G = gram_power_group(n);
  return G > 0 ? 4 * power_lane_floats(n) * G : 0;
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

// lam (B,) = pl_iters power steps on Q (n, n, B) from v0 = c (n, B), gram_power_group(n)
// lanes a CTA. Returns cudaErrorInvalidValue when n is outside 1..128, B or pl_iters is
// out of range, or the group's block exceeds the card's shared memory per block, else the
// device query's or the attribute call's error or cudaGetLastError() after the launch.
extern "C" int gram_power(const float* Q, const float* c, float* lam, int n, long long B,
                          int pl_iters, void* stream) {
  if (n < 1 || n > kPMaxN || B < 1 || pl_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = gram_power_group(n);
  if (G < 0) return -G;
  if (G == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = gram_power_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      gram_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + G - 1) / G);
  gram_power_kernel<<<grid, G * power_lane_threads(n), static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(Q, c, lam, n, B, G, pl_iters);
  return static_cast<int>(cudaGetLastError());
}
