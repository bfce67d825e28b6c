// tri_matvec.cuh — the Gram-resident matvec shared by resident.cu (resident_kernel) and
// gram_build.cu (gram_power_kernel).
//
// Both kernels hold, for each of the G lanes of a CTA, the upper triangle of the lane's
// Gram in shared memory (row-major pairs (r, c), r <= c: n(n+1)/2 floats) and run
//   out[i] = sum_k Q[k][i] v[k]
// over it with features on threads (round_up(n, 32) threads a lane, whole warps), k
// ascending over the true n, each term a separate multiply and add: both sources are built
// with --fmad=false, so the sum rounds as the plain twins' make_matvec does. Q[k][i] for
// k > i is read as Q[i][k]: the upper triangle is authoritative.
//
// The walk. Write base_r = r(n-1) - r(r-1)/2, so that pair (r, c) lies at base_r + c. Warp w
// of a lane owns features [32w, 32w + 32), and its k fall in three segments:
//   k <  32w        entry (k, i) at base_k + i: base_k is the same for the whole warp and
//                   advances by n-1-k; the 32 threads read 32 consecutive words;
//   32w <= k < 32w+32  the warp's diagonal block: (k, i) while k < i, then (i, k), a
//                   select and an index update a term;
//   k >= 32w + 32   entry (i, k) at base_i + k, stride 1 for each thread: after unrolling,
//                   immediate offsets from one pointer.
// Every term reads pair (min(k, i), max(k, i)), whatever the segment, so the sums do not
// depend on the split; a warp's triangle read costs 1.23 wavefronts on average at n = 128
// and never more than 3 (tools/tri_banks.py counts them). The vector is read as 16-byte
// broadcasts: every
// thread of a warp reads the same v[k..k+3], one wavefront for four terms where a 4-byte
// load a term cost one wavefront each. So v must be 16-byte aligned with room for
// round_up(n, 4) floats (vec_stride); the tail of the last float4 (k >= n) is loaded and
// never added.
//
// kUnroll (4 or 8) is the walk's terms a loop body, one or two float4 loads; it changes no
// bit. Measured in turns on an H100 80GB HBM3 at 700 W: the resident kernel at n = 128,
// B = 30464 took 135.1 ms at 4 and 136.5 at 8; gram_power at n = 96, B = 54144 took 18.9
// ms at 4 and 18.5 at 8. Each kernel takes its faster one.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tri {

// Floats between a lane's vectors: round_up(n, 4), so each starts 16-byte aligned.
__host__ __device__ constexpr int vec_stride(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ constexpr int npairs(int n) { return n * (n + 1) / 2; }

// The upper triangles of lanes lane0 .. lane0+G-1 of Q (n, n, B), read from device memory
// once, into T0 (lane g's triangle at T0 + g * npairs(n)). Consecutive threads read
// consecutive lanes of one pair; lanes >= B load zeros. The caller syncs before reading.
__device__ __forceinline__ void copy_in(float* T0, const float* __restrict__ Q, int n,
                                        int64_t B, int64_t lane0, int G) {
  const int np = npairs(n);
  int base = 0;
  for (int r = 0; r < n; ++r) {
    const int cnt = (n - r) * G;
    for (int q = threadIdx.x; q < cnt; q += blockDim.x) {
      const int kk = r + q / G;
      const int gg = q % G;
      const int64_t ln = lane0 + gg;
      T0[static_cast<int64_t>(gg) * np + base + q / G] =
          (ln < B) ? __ldg(Q + (static_cast<int64_t>(r) * n + kk) * B + ln) : 0.f;
    }
    base += n - r;
  }
}

// term(k, v[k]) for k in [k0, k1), ascending; k0 % 4 == 0 and v readable to round_up(k1, 4).
template <int kUnroll, class Term>
__device__ __forceinline__ void walk(const float* v, int k0, int k1, Term term) {
  static_assert(kUnroll == 4 || kUnroll == 8, "the walk reads v four terms a load");
  int k = k0;
  for (; k + kUnroll <= k1; k += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(v + k + j);
      term(k + j, q.x);
      term(k + j + 1, q.y);
      term(k + j + 2, q.z);
      term(k + j + 3, q.w);
    }
  }
  for (; k < k1; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + k);
    term(k, q.x);
    if (k + 1 < k1) term(k + 1, q.y);
    if (k + 2 < k1) term(k + 2, q.z);
    if (k + 3 < k1) term(k + 3, q.w);
  }
}

// out[i] = sum_k Q[k][i] v[k] for feature i < n of one lane, from its triangle T; every
// thread of the calling warp is on the same lane.
template <int kUnroll>
__device__ __forceinline__ float matvec(const float* __restrict__ T, const float* v, int n,
                                        int i) {
  const int d0 = i & ~31;  // the warp's diagonal block [d0, d1)
  const int d1 = (d0 + 32 < n) ? d0 + 32 : n;
  float acc = 0.f;
  const float* Ti = T + i;
  int off = 0;  // base_k
  walk<kUnroll>(v, 0, d0, [&](int k, float vk) {
    acc = acc + Ti[off] * vk;
    off += n - 1 - k;
  });
  int p = off + i;  // (d0, i)
  walk<kUnroll>(v, d0, d1, [&](int k, float vk) {
    acc = acc + T[p] * vk;
    p += (k < i) ? (n - 1 - k) : 1;
  });
  const float* Tr = T + (i * (n - 1) - i * (i - 1) / 2);  // base_i
  walk<kUnroll>(v, d1, n, [&](int k, float vk) { acc = acc + Tr[k] * vk; });
  return acc;
}

}  // namespace tri
