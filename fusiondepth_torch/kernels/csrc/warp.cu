// Bilinear warp of the photometric loss: every source frame sampled at
// every scale's reprojection coordinates, border padding, align_corners
// False (torch F.grid_sample), NCHW float32, with the coordinate VJP.
//
// Replaces the TPU kernels fusiondepth_tpu/ops/pallas_warp.py::_warp
// (_warp_fwd, pallas_call at :421; _warp_bwd, pallas_call at :443) and the
// gather backend fusiondepth_tpu/ops/pallas_warp_gather.py::_warp_gather
// (pallas_call at :196 and :215), which compute the same function. The TPU
// has no fast per-element gather, so those kernels rebuild the sample as
// one-hot matmuls (or lane crossbars) over a band of +-128 source columns
// and a 16-row window, and clamp outside it. On Hopper a gather is an
// address: each thread reads its pixels' four taps directly, so this
// kernel is exact for any displacement.
//
// Inputs are pixel coordinates ix, iy (n_src, n_scales, B, H, W), already
// clamped to [0, W-1] x [0, H-1] (ops/warp.py), and sources
// (n_src, B, C, H, W). The taps and weights are built as in
// fusiondepth_tpu/ops/warp.py::warp_planes_xla: x0 = floor(ix),
// x1 = min(x0 + 1, W - 1), wx = ix - x0, likewise in y.
//
// Backward: d/dix and d/diy, summed over C in the order c = 0 ... C - 1.
// The source cotangent is zero by design (the sources are input frames);
// the wrapper refuses sources that need a gradient.
//
// Bound: bytes. At 640x192, batch 12, 2 sources x 4 scales (11.8M output
// pixels), the forward reads 2 x 47 MB of coordinates and 35 MB of frames
// and writes 142 MB (271 MB, 81 us at 3.35 TB/s); the backward reads the
// coordinates, the frames and the 142 MB cotangent and writes 2 x 47 MB
// (366 MB, 109 us). It does 8 multiply-adds per pixel and channel, far
// below the compute roof.
//
// Design. A block owns one (n, b) (blockIdx.z = n B + b), WARP_ROWS rows
// (a warp each) and 32 WARP_COLS columns of the output plane, and runs the
// K scales one after another: the scales' taps of a tile lie close
// together, so the source neighbourhood comes from device memory once and
// the other scales find it in L1 or L2. (A grid over (n, k, b, pixel) would
// come back to a 1.47 MB source plane only after the other batch elements'
// planes and 142 MB of output had streamed through the 50 MB L2.) Offsets
// are 32-bit products of block and thread indices within a plane, plus
// 64-bit plane bases computed once; nothing divides by a run-time value.
// A thread owns WARP_COLS columns 32 apart, each with its own bounds check,
// so a warp's every access of the coordinates, the cotangent and the
// outputs is 128 contiguous bytes whatever W and the pointers' alignment;
// the taps stay scalar loads, since each tap is anywhere. The next scale's
// coordinates are loaded before this scale's channels; the outputs are
// stored evict-first. At most 64 registers, no spills.
//
// The grid takes N B <= 65535, H <= 65535 WARP_ROWS and H W < 2^31 (the
// one-dimensional grid before it took any shape); a larger call returns
// cudaErrorInvalidValue, so the wrapper raises.
//
// Variants measured on the card (scripts/ab_kernels.py, the b12 and b4
// calls; PERF.md section 6): 2 or 4 adjacent columns a thread with 8- or
// 16-byte accesses (which need an even W and aligned pointers, so a
// second, scalar path for the rest) were no faster than 2 columns 32
// apart, and 4 adjacent columns need 105 registers (or spill at 64);
// 4 columns 32 apart lose the backward; 1 column a thread loses both;
// 16 rows match 8 where the taps lie near the output and win by up to
// 10% where they scatter; the prefetch gains 2-5%.
//
// bfloat16 (compute_dtype="bfloat16"; the _bf16 entry points): the same
// kernels with bf16 sources, output and cotangent, as pallas_warp.py
// takes them. The coordinates stay float32: the JAX wrapper casts the
// grids to float32 before the kernel (pallas_warp.py:485-486), and so
// does ops/warp.py here. Each tap is widened to float32, the sample is
// taken in float32 and rounded once to bf16 where it is stored; the
// coordinate backward widens the cotangent and sums over C in float32
// (pallas_warp.py:312-316). The Pallas forward builds its horizontal tent
// weights in bf16 (:191-212) because the MXU takes bf16 operands; here the
// weights are registers, so they keep float32, as the JAX package's XLA
// warp (ops/warp.py::warp_planes_xla) does: one rounding, at the output.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int WARP_ROWS = 16;  // rows of a block's tile, one warp each
constexpr int WARP_COLS = 2;   // columns a thread, 32 apart
// at least 1024 resident threads an SM: at most 64 registers a thread
constexpr int WARP_MIN_BLOCKS = 1024 / (32 * WARP_ROWS);

struct Taps {
  int i00, i01, i10, i11;  // offsets into one (H, W) source plane
  float wx, wy;
};

__device__ __forceinline__ Taps taps(float ix, float iy, int H, int W) {
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  Taps t;
  t.i00 = y0 * W + x0;
  t.i01 = y0 * W + x1;
  t.i10 = y1 * W + x0;
  t.i11 = y1 * W + x1;
  t.wx = ix - x0f;
  t.wy = iy - y0f;
  return t;
}

// A thread's place: (n, b) from blockIdx.z = n B + b (n < N, the 2 or 3
// source frames, so a few subtractions stand in for the division), its
// first column's offset in the (H, W) plane, and the columns left in its
// row from there (column j of the thread is inside iff 32 j < room).
struct Place {
  int n, b, pix, room;
  bool inside;
};

__device__ __forceinline__ Place place(int B, int H, int W) {
  Place p;
  const int h = blockIdx.y * WARP_ROWS + threadIdx.y;
  const int w = blockIdx.x * 32 * WARP_COLS + threadIdx.x;
  p.inside = h < H && w < W;
  p.room = W - w;
  p.pix = h * W + w;
  p.b = blockIdx.z;
  p.n = 0;
  while (p.b >= B) {
    p.b -= B;
    ++p.n;
  }
  return p;
}

// The thread's WARP_COLS values of a plane read once (coordinates,
// cotangent), evict-first, so that they do not push the source taps out of
// L1. A column outside the row reads the first column's value instead (a
// selected address, not a predicated load: 10% faster in the backward), so
// its taps stay in the plane; it is not stored.
template <typename T>
__device__ __forceinline__ void load_once(const T* q, const Place& p,
                                          float (&v)[WARP_COLS]) {
#pragma unroll
  for (int j = 0; j < WARP_COLS; ++j)
    v[j] = ldcs_f(q + (32 * j < p.room ? 32 * j : 0));
}

// The thread's WARP_COLS outputs of a plane, written once, evict-first.
template <typename T>
__device__ __forceinline__ void store_once(T* q, const Place& p,
                                           const float (&v)[WARP_COLS]) {
#pragma unroll
  for (int j = 0; j < WARP_COLS; ++j)
    if (32 * j < p.room) stcs_f(q + 32 * j, v[j]);
}

template <typename T>
__global__ void __launch_bounds__(32 * WARP_ROWS, WARP_MIN_BLOCKS)
    warp_fwd_kernel(const float* __restrict__ ix, const float* __restrict__ iy,
                    const T* __restrict__ src, T* __restrict__ out,
                    int K, int B, int C, int H, int W) {
  const Place p = place(B, H, W);
  if (!p.inside) return;
  const size_t HW = (size_t)H * W;
  const T* s = src + (size_t)blockIdx.z * C * HW;  // plane (n, b, 0)
  size_t nkb = (size_t)p.n * K * B + p.b;              // (n, k, b) at k = 0
  float x[WARP_COLS], y[WARP_COLS];
  load_once(ix + nkb * HW + p.pix, p, x);
  load_once(iy + nkb * HW + p.pix, p, y);
  for (int k = 0; k < K; ++k, nkb += B) {
    Taps t[WARP_COLS];
#pragma unroll
    for (int j = 0; j < WARP_COLS; ++j) t[j] = taps(x[j], y[j], H, W);
    if (k + 1 < K) {
      load_once(ix + (nkb + B) * HW + p.pix, p, x);
      load_once(iy + (nkb + B) * HW + p.pix, p, y);
    }
    T* o = out + nkb * C * HW + p.pix;
    const T* sc = s;
    for (int c = 0; c < C; ++c, sc += HW, o += HW) {
      float r[WARP_COLS];
#pragma unroll
      for (int j = 0; j < WARP_COLS; ++j) {
        const float v00 = ldg_f(sc + t[j].i00), v01 = ldg_f(sc + t[j].i01);
        const float v10 = ldg_f(sc + t[j].i10), v11 = ldg_f(sc + t[j].i11);
        const float wx = t[j].wx, wy = t[j].wy;
        r[j] = v00 * (1.f - wx) * (1.f - wy) + v01 * wx * (1.f - wy) +
               v10 * (1.f - wx) * wy + v11 * wx * wy;
      }
      store_once(o, p, r);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * WARP_ROWS, WARP_MIN_BLOCKS)
    warp_bwd_kernel(const float* __restrict__ ix, const float* __restrict__ iy,
                    const T* __restrict__ src, const T* __restrict__ g,
                    float* __restrict__ gix, float* __restrict__ giy, int K,
                    int B, int C, int H, int W) {
  const Place p = place(B, H, W);
  if (!p.inside) return;
  const size_t HW = (size_t)H * W;
  const T* s = src + (size_t)blockIdx.z * C * HW;
  size_t nkb = (size_t)p.n * K * B + p.b;
  float x[WARP_COLS], y[WARP_COLS];
  load_once(ix + nkb * HW + p.pix, p, x);
  load_once(iy + nkb * HW + p.pix, p, y);
  for (int k = 0; k < K; ++k, nkb += B) {
    Taps t[WARP_COLS];
#pragma unroll
    for (int j = 0; j < WARP_COLS; ++j) t[j] = taps(x[j], y[j], H, W);
    if (k + 1 < K) {
      load_once(ix + (nkb + B) * HW + p.pix, p, x);
      load_once(iy + (nkb + B) * HW + p.pix, p, y);
    }
    const T* gp = g + nkb * C * HW + p.pix;
    const T* sc = s;
    float ax[WARP_COLS], ay[WARP_COLS];
#pragma unroll
    for (int j = 0; j < WARP_COLS; ++j) ax[j] = ay[j] = 0.f;
    for (int c = 0; c < C; ++c, sc += HW, gp += HW) {
      float gc[WARP_COLS];
      load_once(gp, p, gc);
#pragma unroll
      for (int j = 0; j < WARP_COLS; ++j) {
        const float v00 = ldg_f(sc + t[j].i00), v01 = ldg_f(sc + t[j].i01);
        const float v10 = ldg_f(sc + t[j].i10), v11 = ldg_f(sc + t[j].i11);
        const float wx = t[j].wx, wy = t[j].wy;
        ax[j] += gc[j] * ((v01 - v00) * (1.f - wy) + (v11 - v10) * wy);
        ay[j] += gc[j] * ((v10 - v00) * (1.f - wx) + (v11 - v01) * wx);
      }
    }
    store_once(gix + nkb * HW + p.pix, p, ax);
    store_once(giy + nkb * HW + p.pix, p, ay);
  }
}

// The grid of a launch, or false where it does not fit: N B blocks in z,
// H / WARP_ROWS in y (each at most 65535), and 32-bit offsets in a plane.
bool grid_of(int N, int B, int H, int W, dim3* grid) {
  const long long rows = (H + WARP_ROWS - 1) / WARP_ROWS;
  if ((long long)N * B > 65535 || rows > 65535 ||
      (long long)H * W >= (1LL << 31))
    return false;
  *grid = dim3((W + 32 * WARP_COLS - 1) / (32 * WARP_COLS), (unsigned)rows,
               N * B);
  return true;
}

template <typename T>
int launch_fwd(const void* ix, const void* iy, const void* src, void* out,
               int N, int K, int B, int C, int H, int W, void* stream) {
  dim3 grid;
  if (!grid_of(N, B, H, W, &grid)) return (int)cudaErrorInvalidValue;
  warp_fwd_kernel<T><<<grid, dim3(32, WARP_ROWS), 0, (cudaStream_t)stream>>>(
      (const float*)ix, (const float*)iy, (const T*)src, (T*)out, K, B, C, H,
      W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* ix, const void* iy, const void* src,
               const void* g, void* gix, void* giy, int N, int K, int B,
               int C, int H, int W, void* stream) {
  dim3 grid;
  if (!grid_of(N, B, H, W, &grid)) return (int)cudaErrorInvalidValue;
  warp_bwd_kernel<T><<<grid, dim3(32, WARP_ROWS), 0, (cudaStream_t)stream>>>(
      (const float*)ix, (const float*)iy, (const T*)src, (const T*)g,
      (float*)gix, (float*)giy, K, B, C, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// ix, iy (N, K, B, H, W); src (N, B, C, H, W); out (N, K, B, C, H, W).
// Any alignment. Launches on `stream`, which belongs to the current
// device. Returns cudaGetLastError(), or cudaErrorInvalidValue for a grid
// that does not fit (N B > 65535, H > 65535 WARP_ROWS, H W >= 2^31).
extern "C" int fd_warp_fwd(const void* ix, const void* iy, const void* src,
                           void* out, int N, int K, int B, int C, int H,
                           int W, void* stream) {
  return launch_fwd<float>(ix, iy, src, out, N, K, B, C, H, W, stream);
}

// g (N, K, B, C, H, W) -> gix, giy (N, K, B, H, W). As fd_warp_fwd.
extern "C" int fd_warp_bwd(const void* ix, const void* iy, const void* src,
                           const void* g, void* gix, void* giy, int N, int K,
                           int B, int C, int H, int W, void* stream) {
  return launch_bwd<float>(ix, iy, src, g, gix, giy, N, K, B, C, H, W,
                           stream);
}

// The same with bf16 src, out and g; ix, iy, gix and giy stay float32.
extern "C" int fd_warp_fwd_bf16(const void* ix, const void* iy,
                                const void* src, void* out, int N, int K,
                                int B, int C, int H, int W, void* stream) {
  return launch_fwd<bf16>(ix, iy, src, out, N, K, B, C, H, W, stream);
}

extern "C" int fd_warp_bwd_bf16(const void* ix, const void* iy,
                                const void* src, const void* g, void* gix,
                                void* giy, int N, int K, int B, int C, int H,
                                int W, void* stream) {
  return launch_bwd<bf16>(ix, iy, src, g, gix, giy, N, K, B, C, H, W,
                          stream);
}
