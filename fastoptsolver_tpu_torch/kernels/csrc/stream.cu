// stream_ceiling — the no-math read ceiling of the fused kernel's access pattern.
//
// Replaces the TPU kernel fastoptsolver_tpu/bench/stream.py:_stream_kernel. Same
// launch shape as fused_lasso_solve (one thread per lane, one CTA per b_tile lanes,
// each thread walking its lane's m rows of A (n, m, B) and b (m, B)), with the math
// reduced to one add per element. Its GB/s is the denominator of
// pct_of_achievable.
//
// Unlike the TPU, where a DMA moves whole bricks even if the body touches one row,
// the GPU never fetches an element no instruction reads. So this kernel must use
// every element: it writes the full per-lane sum of A and b, not the TPU kernel's
// sampled rows, and the plain twin (bench/stream.py:stream_pass_reference)
// computes the same full sum. Bound: pure reads, (n+1)*m*B*4 bytes. Instantiated
// for n = 1..8, the fused kernel's range.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowBlock = 32;

// N is compile-time, as in fused_lasso_solve, so a thread issues one row's
// N+1 loads together and the unrolled row loop keeps several rows in flight;
// with a runtime feature loop the loads serialise and the "ceiling" falls
// below the fused kernel it is meant to bound.
template <int N>
__global__ void stream_ceiling_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                      float* __restrict__ out, int64_t m, int64_t B) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= B) return;  // no barrier in this kernel, so the ragged edge may leave
  const int64_t plane = m * B;
  float total = 0.f;
  for (int64_t r0 = 0; r0 < m; r0 += kRowBlock) {
    const int64_t r1 = (r0 + kRowBlock < m) ? r0 + kRowBlock : m;
    float part = 0.f;
#pragma unroll 4
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t off = r * B + lane;
      float row = __ldg(b + off);
#pragma unroll
      for (int k = 0; k < N; ++k) row += __ldg(A + k * plane + off);
      part += row;
    }
    total += part;
  }
  out[lane] = total;
}

}  // namespace

// Returns a cudaError_t as int (cudaErrorInvalidValue for a bad shape, a feature
// count outside 1..8, or a bad b_tile).
extern "C" int stream_ceiling(const float* A, const float* b, float* out, int n, long long m,
                              long long B, int b_tile, void* stream) {
  if (b_tile < 32 || b_tile > 1024 || b_tile % 32 != 0 || m <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((B + b_tile - 1) / b_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FOS_CASE(NN)                                                          \
  case NN:                                                                    \
    stream_ceiling_kernel<NN><<<grid, b_tile, 0, s>>>(A, b, out, m, B);       \
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
