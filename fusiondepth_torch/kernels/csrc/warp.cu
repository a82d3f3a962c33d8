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
// address: one thread per output pixel reads its four taps directly, so
// this kernel is exact for any displacement.
//
// Inputs are pixel coordinates ix, iy (n_src, n_scales, B, H, W), already
// clamped to [0, W-1] x [0, H-1] (ops/warp.py), and sources
// (n_src, B, C, H, W). The taps and weights are built as in
// fusiondepth_tpu/ops/warp.py::warp_planes_xla: x0 = floor(ix),
// x1 = min(x0 + 1, W - 1), wx = ix - x0, likewise in y.
//
// Backward: d/dix and d/diy, summed over C. The source cotangent is zero
// by design (the sources are input frames); the wrapper refuses sources
// that need a gradient.
//
// Bound: bytes. At 640x192, batch 12, 2 sources x 4 scales (11.8M output
// pixels), the forward reads 2 x 47 MB of coordinates and 35 MB of frames
// and writes 142 MB (271 MB, 81 us at 3.35 TB/s); the backward reads the
// coordinates, the frames and the 142 MB cotangent and writes 2 x 47 MB
// (366 MB, 109 us). It does 8 multiply-adds per pixel and channel, far
// below the compute roof. Adjacent threads own adjacent output columns, so
// coordinate, output and (near-identity) tap accesses coalesce; the four
// scales of one frame read the same source plane again, from L2 when it
// is still there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Taps {
  long long i00, i01, i10, i11;  // offsets into one (H, W) source plane
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
  t.i00 = (long long)y0 * W + x0;
  t.i01 = (long long)y0 * W + x1;
  t.i10 = (long long)y1 * W + x0;
  t.i11 = (long long)y1 * W + x1;
  t.wx = ix - x0f;
  t.wy = iy - y0f;
  return t;
}

// One thread per (n, k, b, h, w) output pixel: C channels each.
__global__ void warp_fwd_kernel(const float* __restrict__ ix,
                                const float* __restrict__ iy,
                                const float* __restrict__ src,
                                float* __restrict__ out, int K, int B, int C,
                                int H, int W, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long HW = (long long)H * W;
  const long long pix = i % HW;
  const long long nkb = i / HW;  // (n * K + k) * B + b
  const long long b = nkb % B;
  const long long n = nkb / ((long long)K * B);
  const Taps t = taps(__ldg(ix + i), __ldg(iy + i), H, W);
  const float* s = src + (n * B + b) * C * HW;
  float* o = out + nkb * C * HW + pix;
  for (int c = 0; c < C; ++c, s += HW, o += HW) {
    const float v00 = __ldg(s + t.i00), v01 = __ldg(s + t.i01);
    const float v10 = __ldg(s + t.i10), v11 = __ldg(s + t.i11);
    *o = v00 * (1.f - t.wx) * (1.f - t.wy) + v01 * t.wx * (1.f - t.wy) +
         v10 * (1.f - t.wx) * t.wy + v11 * t.wx * t.wy;
  }
}

__global__ void warp_bwd_kernel(const float* __restrict__ ix,
                                const float* __restrict__ iy,
                                const float* __restrict__ src,
                                const float* __restrict__ g,
                                float* __restrict__ gix,
                                float* __restrict__ giy, int K, int B, int C,
                                int H, int W, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long HW = (long long)H * W;
  const long long pix = i % HW;
  const long long nkb = i / HW;
  const long long b = nkb % B;
  const long long n = nkb / ((long long)K * B);
  const Taps t = taps(__ldg(ix + i), __ldg(iy + i), H, W);
  const float* s = src + (n * B + b) * C * HW;
  const float* gp = g + nkb * C * HW + pix;
  float ax = 0.f, ay = 0.f;
  for (int c = 0; c < C; ++c, s += HW, gp += HW) {
    const float v00 = __ldg(s + t.i00), v01 = __ldg(s + t.i01);
    const float v10 = __ldg(s + t.i10), v11 = __ldg(s + t.i11);
    const float gc = __ldg(gp);
    ax += gc * ((v01 - v00) * (1.f - t.wy) + (v11 - v10) * t.wy);
    ay += gc * ((v10 - v00) * (1.f - t.wx) + (v11 - v01) * t.wx);
  }
  gix[i] = ax;
  giy[i] = ay;
}

constexpr int THREADS = 256;

}  // namespace

// ix, iy (N, K, B, H, W); src (N, B, C, H, W); out (N, K, B, C, H, W).
// Launches on `stream`, which belongs to the current device. Returns
// cudaGetLastError().
extern "C" int fd_warp_fwd(const void* ix, const void* iy, const void* src,
                           void* out, int N, int K, int B, int C, int H,
                           int W, void* stream) {
  const long long total = (long long)N * K * B * H * W;
  const long long blocks = (total + THREADS - 1) / THREADS;
  warp_fwd_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ix, (const float*)iy, (const float*)src, (float*)out, K,
      B, C, H, W, total);
  return (int)cudaGetLastError();
}

// g (N, K, B, C, H, W) -> gix, giy (N, K, B, H, W).
extern "C" int fd_warp_bwd(const void* ix, const void* iy, const void* src,
                           const void* g, void* gix, void* giy, int N, int K,
                           int B, int C, int H, int W, void* stream) {
  const long long total = (long long)N * K * B * H * W;
  const long long blocks = (total + THREADS - 1) / THREADS;
  warp_bwd_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ix, (const float*)iy, (const float*)src, (const float*)g,
      (float*)gix, (float*)giy, K, B, C, H, W, total);
  return (int)cudaGetLastError();
}
