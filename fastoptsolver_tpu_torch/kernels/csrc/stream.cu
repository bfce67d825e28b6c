// stream_ceiling — the no-math read ceiling of the fused kernel's inputs.
//
// Replaces the TPU kernel fastoptsolver_tpu/bench/stream.py:_stream_kernel. It reads
// every element of A (n, m, B) and b (m, B) once and writes each lane's full sum. Its
// GB/s is the denominator of pct_of_achievable.
//
// Unlike the TPU, where a DMA moves whole bricks even if the body touches one row,
// the GPU never fetches an element no instruction reads. So this kernel must use
// every element: it writes the full per-lane sum of A and b, not the TPU kernel's
// sampled rows, and the plain twin (bench/stream.py:stream_pass_reference)
// computes the same full sum. Bound: pure reads, (n+1)*m*B*4 bytes. Instantiated
// for n = 1..8, the fused kernel's range.
//
// Access pattern: each thread owns kVec adjacent lanes and reads them with one load
// per row and plane: 16-byte float4 loads (kVec = 4) when B % 4 == 0 and A, b are
// 16-byte aligned (stream_copy_bytes), else 4-byte loads (kVec = 1). A CTA is b_tile
// threads, so it covers b_tile * kVec lanes. The row loop is unrolled so that a
// thread may have several rows of N+1 loads in flight: 4 rows of 16-byte loads (4x
// the bytes of the one-lane, 4-row kernel this replaces) or 8 rows of 4-byte loads
// (twice its loads). Each lane's sum keeps
// one order whatever the width: rows in blocks of 32, each row b first and then A's
// planes k ascending, the row added to the block's partial, the partial to the total.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowBlock = 32;

// kVec floats of adjacent lanes from p: one float4 load or one float load.
template <int kVec>
__device__ __forceinline__ void load(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// N is compile-time, as in fused_lasso_solve, so a thread issues one row's N+1
// loads together and the unrolled row loop keeps several rows in flight; with a
// runtime feature loop the loads serialise and the "ceiling" falls below the
// fused kernel it is meant to bound.
template <int N, int kVec>
__global__ void stream_ceiling_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                      float* __restrict__ out, int64_t m, int64_t B) {
  const int64_t lane = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (lane >= B) return;  // no barrier in this kernel, so the ragged edge may leave
  const int64_t plane = m * B;
  float total[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) total[j] = 0.f;
  for (int64_t r0 = 0; r0 < m; r0 += kRowBlock) {
    const int64_t r1 = (r0 + kRowBlock < m) ? r0 + kRowBlock : m;
    float part[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) part[j] = 0.f;
#pragma unroll (kVec == 4 ? 4 : 8)
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t off = r * B + lane;
      float row[kVec], a[N][kVec];
      load<kVec>(b + off, row);
#pragma unroll
      for (int k = 0; k < N; ++k) load<kVec>(A + k * plane + off, a[k]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
#pragma unroll
        for (int k = 0; k < N; ++k) row[j] += a[k][j];
        part[j] += row[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) total[j] += part[j];
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) out[lane + j] = total[j];
}

template <int kVec>
int launch(const float* A, const float* b, float* out, int n, long long m, long long B,
           int b_tile, cudaStream_t s) {
  const long long per_cta = static_cast<long long>(b_tile) * kVec;
  const unsigned grid = static_cast<unsigned>((B + per_cta - 1) / per_cta);
#define FOS_CASE(NN)                                                                \
  case NN:                                                                          \
    stream_ceiling_kernel<NN, kVec><<<grid, b_tile, 0, s>>>(A, b, out, m, B);       \
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

}  // namespace

// The width in bytes of the stream kernel's loads: 16 when B % 4 == 0 and both
// bases are 16-byte aligned (then every float4 of a row lies wholly inside B), else 4.
extern "C" int stream_copy_bytes(long long B, const void* A, const void* b) {
  const bool wide = B % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return wide ? 16 : 4;
}

// out (B,) = each lane's sum of A (n, m, B) and b (m, B), with the loads
// stream_copy_bytes picks; b_tile is the CTA's threads. Returns a cudaError_t as int
// (cudaErrorInvalidValue for a bad shape, a feature count outside 1..8, or a bad
// b_tile).
extern "C" int stream_ceiling(const float* A, const float* b, float* out, int n, long long m,
                              long long B, int b_tile, void* stream) {
  if (b_tile < 32 || b_tile > 1024 || b_tile % 32 != 0 || m <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stream_copy_bytes(B, A, b) == 16 ? launch<4>(A, b, out, n, m, B, b_tile, s)
                                          : launch<1>(A, b, out, n, m, B, b_tile, s);
}
