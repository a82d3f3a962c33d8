// Exact k nearest neighbours of every point of an (N, 3) float32 cloud
// within the same cloud, excluding the point itself, for GDC. Output is
// (N, k) int32, each row sorted by (squared distance, index): ties break
// toward the lower index, as lax.top_k does in gdc.knn_brute.
//
// Replaces the TPU kernel fusiondepth_tpu/gdc/pallas_knn.py::knn_pallas
// (_knn_kernel, pallas_call at :106). The TPU kernel computes 256 x 2048
// distance tiles on the MXU and extracts the k smallest with k rounds of
// vector min-reductions.
//
// d^2 = |q|^2 - 2 q.c + |c|^2 in float32, the expansion of gdc.py:102-103
// and pallas_knn.py:78, each step rounded as XLA's CPU code rounds it in
// the jitted gdc.knn_brute: |p|^2 = fma(z, z, fma(y, y, x*x)),
// q.c = fma(q2, c2, fma(q1, c1, q0*c0)), then (|q|^2 - 2 q.c) + |c|^2. The
// plain version in kernels/knn.py rounds alike, so the two rank near-ties
// alike, and as the JAX package does on a CPU. The kernel takes the
// products with 2q: scaling by 2 is exact, so fma(2q2, c2, fma(2q1, c1,
// 2q0*c0)) is 2 (q.c) bit for bit (no overflow at the 1e8 sentinels, no
// subnormals at metre scale) and the separate doubling goes away.
// The expansion cancels at GDC's 1e8 sentinel coordinates: padded rows'
// neighbours are arbitrary here as in JAX, and GDC masks them.
//
// Bound: operations, and on this card the issue of instructions. The
// table's bound counts 9 float32 operations per (query, point) pair: 15.1
// GFLOP at N = 40960, 0.23 ms at 67 TFLOP/s; the cloud itself is 0.5 MB.
// As issued the function needs at least 6 lane instructions a pair, 5
// arithmetic (a multiply, two fmas, two adds) and the compare with the
// k-th distance: about 0.30 ms at N = 40960.
//
// Design. A thread owns one query: its 2q, |q|^2 and sorted top-K list
// sit in registers; a block of 128 queries walks tiles of TILE points
// (x, y, z, |c|^2) staged in shared memory, each point one broadcast
// float4 load. The loop as compiled issues about 35 instructions for
// UNROLL = 4 points: the 4 loads, 20 arithmetic, 4 compares with the k-th
// distance and one branch into the insert path for the 4 points together
// (taken when any lane has a distance below its k-th; the points are then
// inserted in index order, and the self test sits there: a point's
// distance to itself is exactly 0 with this rounding). Q queries a
// thread would load each point once for Q pairs, but a warp then takes
// the insert path whenever any of its 32 Q queries improves, and on GDC's
// clouds that costs more than the loads save (measured with Q = 2, 3 and
// 4: 1.3-1.8x slower at N = 40960, PERF.md).
// Each query starts from a bound on its k-th distance, so the insert path
// stays rare: the K-th smallest d^2 to its 4K neighbours in index (GDC's
// points come in raster order, so these are near in space), with the same
// rounding. K other points lie within it, so no point beyond it can be
// among the K nearest, and the list starts full of placeholders just above
// it (d <= bound enters, ties included).
// Tiles are padded with NaN points to a multiple of UNROLL (NaN never
// compares less), so the loop has no tail.
// The points are cut into S ranges (blockIdx.y) so that the grid makes
// MIN_WAVES waves of the card's resident blocks (fd_knn_splits): the
// queries whose bound is loose (GDC's LiDAR points, which follow the
// pseudo-LiDAR points in index) make some blocks several times slower
// than the rest, and in a grid of one wave the slowest block sets the
// time. Each range keeps its own sorted lists and a second kernel merges
// the S lists of each query in range order. Strict-less insertion keeps an
// equal d^2 behind the lower indices already held, in a range and in the
// merge.
// It stays off the tensor cores on purpose: a 3xTF32 or wgmma product
// does not round q.c as the fma chain does, so it would reorder near-ties
// and break the bit-equal GDC check against the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int THREADS = 128;      // threads (queries) per block
constexpr int TILE = 1024;        // points staged per tile
constexpr int UNROLL = 4;         // points per step (one branch) of the loop
constexpr int MIN_WAVES = 5;      // waves of blocks the split aims at
constexpr int SEED_PER_K = 4;     // index neighbours a start bound looks at
constexpr int MAX_SPLITS = 32;

// blocks an SM keeps, from the registers a thread needs (its K-list, 2q,
// |q|^2, the step's distances and ~32 more): this caps the registers at
// 65536 / (THREADS * blocks) without spilling
template <int K>
constexpr int blocks_per_sm() {
  constexpr int regs = 2 * K + 4 + UNROLL + 32;
  constexpr int by_regs = 65536 / (THREADS * regs);
  constexpr int by_threads = 2048 / THREADS;
  return by_regs < by_threads ? by_regs : by_threads;
}

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// (|q|^2 - 2 q.c) + |c|^2 with q2 = 2q; see the header
__device__ __forceinline__ float dist2(float qx2, float qy2, float qz2,
                                       float qsq, float4 c) {
  const float qc2 =
      __fmaf_rn(qz2, c.z, __fmaf_rn(qy2, c.y, __fmul_rn(qx2, c.x)));
  return __fadd_rn(__fsub_rn(qsq, qc2), c.w);
}

__device__ __forceinline__ float4 point(const float* __restrict__ pts,
                                        int j) {
  const long long o = 3LL * j;
  const float x = __ldg(pts + o), y = __ldg(pts + o + 1),
              z = __ldg(pts + o + 2);
  return make_float4(x, y, z, sqnorm(x, y, z));
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

// Insert d into the sorted K smallest distances v (values only). The
// caller has checked d < v[K - 1].
template <int K>
__device__ __forceinline__ void insert_value(float (&v)[K], float d) {
  v[K - 1] = d;
#pragma unroll
  for (int k = K - 1; k > 0; --k) {
    const float a = v[k - 1], b = v[k];
    v[k - 1] = fminf(a, b);
    v[k] = fmaxf(a, b);
  }
}

// The starting bound of query q: just above the K-th smallest d^2 to its
// SEED_PER_K * K (at most N - 1) neighbours in index, or +inf where fewer
// than K of those distances are numbers.
template <int K>
__device__ float seed_bound(const float* __restrict__ pts, int N, int q,
                            float qx2, float qy2, float qz2, float qsq) {
  const int m = min(SEED_PER_K * K, N - 1);
  const int lo = min(max(q - m / 2, 0), N - 1 - m);
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = INFINITY;
  for (int j = lo; j <= lo + m; ++j) {
    const float d = dist2(qx2, qy2, qz2, qsq, point(pts, j));
    if (d < v[K - 1] && j != q) insert_value<K>(v, d);
  }
  return nextafterf(v[K - 1], INFINITY);
}

// Top-K of query q (one a thread) over the points [s * chunk,
// (s + 1) * chunk), s = blockIdx.y.
template <int K>
__global__ void __launch_bounds__(THREADS, (blocks_per_sm<K>()))
    knn_partial_kernel(const float* __restrict__ pts, int N, int chunk,
                       float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[TILE];
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const int lo = blockIdx.y * chunk;
  const int hi = min(N, lo + chunk);
  // a query past N is NaN: its d^2 never compares less
  float4 p = make_float4(NAN, NAN, NAN, NAN);
  if (q < N) p = point(pts, q);
  const float qx2 = 2.f * p.x, qy2 = 2.f * p.y, qz2 = 2.f * p.z, qsq = p.w;
  const float b =
      q < N ? seed_bound<K>(pts, N, q, qx2, qy2, qz2, qsq) : INFINITY;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bd[k] = b;
    bi[k] = INT_MAX;
  }
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    const int nr = (n + UNROLL - 1) / UNROLL * UNROLL;
    __syncthreads();
    for (int j = threadIdx.x; j < nr; j += THREADS)
      tile[j] = j < n ? point(pts, t0 + j) : make_float4(NAN, NAN, NAN, NAN);
    __syncthreads();
    for (int j = 0; j < nr; j += UNROLL) {
      // the step's UNROLL distances, compared with the k-th distance as it
      // stands before the step (never below it after the step)
      float d[UNROLL];
      bool hit = false;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        d[u] = dist2(qx2, qy2, qz2, qsq, tile[j + u]);
        hit |= d[u] < bd[K - 1];
      }
      if (hit) {  // the rare path: the points in index order
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (d[u] < bd[K - 1] && t0 + j + u != q)
            insert<K>(bd, bi, d[u], t0 + j + u);
      }
    }
  }
  if (q >= N) return;
  const long long o = ((long long)blockIdx.y * N + q) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    part_d[o + k] = bd[k];
    part_i[o + k] = bi[k];
  }
}

// Merge the S sorted partial lists of each query, ranges in index order.
// Each range's list may end in placeholders (its start bound, index
// INT_MAX); K real points lie at or below every bound, so none is kept.
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

// Ranges S for N points: the smallest S (at most MAX_SPLITS) whose grid
// makes at least MIN_WAVES waves of the card's resident blocks and fills
// at least 85% of its last wave, else the fullest.
template <int K>
int splits(int N) {
  static int slots = 0;  // resident blocks of the card
  if (!slots) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, knn_partial_kernel<K>, THREADS, 0))
      return -1;
    slots = sms * per_sm;
  }
  if (slots <= 0) return -1;
  const long long bx = (N + THREADS - 1) / THREADS;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= MAX_SPLITS; ++s) {
    const long long blocks = bx * s;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (waves >= MIN_WAVES && fill >= 0.85) return s;
    if (fill > best_fill) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

template <int K>
int launch(const float* pts, int N, float* part_d, int* part_i, int* out,
           cudaStream_t stream) {
  const int S = splits<K>(N);
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int chunk = (N + S - 1) / S;
  const dim3 grid((N + THREADS - 1) / THREADS, S);
  knn_partial_kernel<K><<<grid, THREADS, 0, stream>>>(pts, N, chunk,
                                                         part_d, part_i);
  int err = (int)cudaGetLastError();
  if (err) return err;
  knn_merge_kernel<K><<<(N + 255) / 256, 256, 0, stream>>>(part_d, part_i,
                                                           N, S, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define FD_KNN_CASES(F)                                                      \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) \
      F(15) F(16)

// Number of point ranges S fd_knn uses for N points and k neighbours (the
// scratch holds S * N * k entries), or -1 on a CUDA error or a bad k.
extern "C" int fd_knn_splits(int N, int k) {
  switch (k) {
#define FD_KNN_SPLITS(KK) \
  case KK:                \
    return splits<KK>(N);
    FD_KNN_CASES(FD_KNN_SPLITS)
#undef FD_KNN_SPLITS
    default:
      return -1;
  }
}

// pts (N, 3) -> out (N, k) int32; part_d, part_i scratch of
// fd_knn_splits(N, k) * N * k entries each. 1 <= k <= 16, k < N.
extern "C" int fd_knn(const void* pts, int N, int k, void* part_d,
                      void* part_i, void* out, void* stream) {
  const float* p = (const float*)pts;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
#define FD_KNN_CASE(KK) \
  case KK:              \
    return launch<KK>(p, N, pd, pi, o, st);
    FD_KNN_CASES(FD_KNN_CASE)
#undef FD_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
