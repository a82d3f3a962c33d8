// Exact k nearest neighbours of every point of an (N, 3) float32 cloud
// within the same cloud, excluding the point itself, for GDC. Output is
// (N, k) int32, each row sorted by (squared distance, index): ties break
// toward the lower index, as lax.top_k does in gdc.knn_brute.
//
// Replaces the TPU kernel fusiondepth_tpu/gdc/pallas_knn.py::knn_pallas
// (_knn_kernel, pallas_call at :106). The TPU kernel computes 256 x 2048
// distance tiles on the MXU and extracts the k smallest with k rounds of
// vector min-reductions. On Hopper one thread owns one query and keeps
// its running top-k in registers, sorted by (d^2, index); a block of 128
// queries stages tiles of 1024 points (x, y, z, |c|^2) in shared memory.
// One pass over N points per query gives N / 128 blocks, too few to fill
// 132 SMs at GDC's N = 40960, so the points are cut into S ranges
// (blockIdx.y), each range keeps its own top-k, and a second kernel merges
// the S sorted lists of each query.
//
// d^2 = |q|^2 - 2 q.c + |c|^2 in float32, the expansion of gdc.py:102-103
// and pallas_knn.py:78, each step rounded as XLA's CPU code rounds it in
// the jitted gdc.knn_brute: |p|^2 = fma(z, z, fma(y, y, x*x)),
// q.c = fma(q2, c2, fma(q1, c1, q0*c0)), then (|q|^2 - 2 q.c) + |c|^2. The
// plain version in kernels/knn.py rounds alike, so the two rank near-ties
// alike, and as the JAX package does on a CPU.
// The expansion cancels at GDC's 1e8 sentinel coordinates: padded rows'
// neighbours are arbitrary here as in JAX, and GDC masks them.
//
// Bound: operations. 9 float32 operations per (query, point) pair:
// 15.1 GFLOP at N = 40960, 0.23 ms at 67 TFLOP/s; the cloud itself is
// 0.5 MB. The top-k update is a compare against the k-th distance, taken
// rarely once the list has filled.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int QUERIES = 128;  // threads (queries) per block
constexpr int TILE = 1024;    // points staged per tile

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// Insert (d, j) into the sorted top-K (strictly smaller d moves ahead, so
// an equal d stays behind the entries already held, which have lower
// indices). The caller has checked d < bd[K - 1].
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int j) {
  bd[K - 1] = d;
  bi[K - 1] = j;
#pragma unroll
  for (int k = K - 1; k > 0; --k) {
    const bool sw = bd[k] < bd[k - 1];
    const float td = sw ? bd[k - 1] : bd[k];
    const int ti = sw ? bi[k - 1] : bi[k];
    bd[k - 1] = sw ? bd[k] : bd[k - 1];
    bi[k - 1] = sw ? bi[k] : bi[k - 1];
    bd[k] = td;
    bi[k] = ti;
  }
}

// Top-K of each query over the points [s * chunk, (s + 1) * chunk).
template <int K>
__global__ void __launch_bounds__(QUERIES)
    knn_partial_kernel(const float* __restrict__ pts, int N, int chunk,
                       float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[TILE];
  const int q = blockIdx.x * QUERIES + threadIdx.x;
  const int s = blockIdx.y;
  const int lo = s * chunk;
  const int hi = min(N, lo + chunk);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < N) {
    qx = __ldg(pts + 3LL * q);
    qy = __ldg(pts + 3LL * q + 1);
    qz = __ldg(pts + 3LL * q + 2);
  }
  const float qsq = sqnorm(qx, qy, qz);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bd[k] = INFINITY;
    bi[k] = INT_MAX;
  }
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += QUERIES) {
      const long long o = 3LL * (t0 + j);
      const float x = __ldg(pts + o), y = __ldg(pts + o + 1),
                  z = __ldg(pts + o + 2);
      tile[j] = make_float4(x, y, z, sqnorm(x, y, z));
    }
    __syncthreads();
    if (q < N) {
      for (int j = 0; j < n; ++j) {
        const float4 c = tile[j];
        const float qc =
            __fmaf_rn(qz, c.z, __fmaf_rn(qy, c.y, __fmul_rn(qx, c.x)));
        const float d = __fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, qc)), c.w);
        if (d < bd[K - 1] && t0 + j != q) insert<K>(bd, bi, d, t0 + j);
      }
    }
  }
  if (q < N) {
    const long long o = ((long long)s * N + q) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part_d[o + k] = bd[k];
      part_i[o + k] = bi[k];
    }
  }
}

// Merge the S sorted partial lists of each query, ranges in index order.
template <int K>
__global__ void knn_merge_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i, int N,
                                 int S, int* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= N) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bd[k] = INFINITY;
    bi[k] = INT_MAX;
  }
  for (int s = 0; s < S; ++s) {
    const long long o = ((long long)s * N + q) * K;
    for (int k = 0; k < K; ++k) {
      const float d = part_d[o + k];
      if (!(d < bd[K - 1])) break;  // the rest of this list is no better
      insert<K>(bd, bi, d, part_i[o + k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[(long long)q * K + k] = bi[k];
}

template <int K>
int launch(const float* pts, int N, int S, int chunk, float* part_d,
           int* part_i, int* out, cudaStream_t stream) {
  const dim3 grid((N + QUERIES - 1) / QUERIES, S);
  knn_partial_kernel<K><<<grid, QUERIES, 0, stream>>>(pts, N, chunk, part_d,
                                                      part_i);
  int err = (int)cudaGetLastError();
  if (err) return err;
  knn_merge_kernel<K><<<(N + 255) / 256, 256, 0, stream>>>(part_d, part_i,
                                                           N, S, out);
  return (int)cudaGetLastError();
}

constexpr int TARGET_THREADS = 132 * 2048;  // every SM full once

}  // namespace

// Number of point ranges S for N points: enough (query, range) threads to
// fill the card once, at most 32, at least one.
extern "C" int fd_knn_splits(int N) {
  const long long s = (TARGET_THREADS + (long long)N - 1) / N;
  return (int)(s < 1 ? 1 : (s > 32 ? 32 : s));
}

// pts (N, 3) -> out (N, k) int32; part_d, part_i scratch of
// fd_knn_splits(N) * N * k entries each. 1 <= k <= 16, k < N.
extern "C" int fd_knn(const void* pts, int N, int k, void* part_d,
                      void* part_i, void* out, void* stream) {
  const int S = fd_knn_splits(N);
  const int chunk = (N + S - 1) / S;
  const float* p = (const float*)pts;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
#define FD_KNN_CASE(KK) \
  case KK:              \
    return launch<KK>(p, N, S, chunk, pd, pi, o, st);
    FD_KNN_CASE(1) FD_KNN_CASE(2) FD_KNN_CASE(3) FD_KNN_CASE(4)
    FD_KNN_CASE(5) FD_KNN_CASE(6) FD_KNN_CASE(7) FD_KNN_CASE(8)
    FD_KNN_CASE(9) FD_KNN_CASE(10) FD_KNN_CASE(11) FD_KNN_CASE(12)
    FD_KNN_CASE(13) FD_KNN_CASE(14) FD_KNN_CASE(15) FD_KNN_CASE(16)
#undef FD_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
