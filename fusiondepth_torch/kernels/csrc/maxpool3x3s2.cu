// Stem max-pool: torch MaxPool2d(kernel 3, stride 2, padding 1) on an NCHW
// float32 tensor, forward and its tie-splitting backward.
//
// Forward: replaces the TPU kernel fusiondepth_tpu/ops/pallas_pool.py::
// _pool_fwd (pallas_call at :186), one thread per output element. The TPU
// version regroups (W, C) -> (W/2, 2C) outside the kernel so that the
// stride-2 column taps become lane halves in VMEM; on Hopper a strided
// read is just an address, so each thread reads its 3x3 window directly.
//
// Bound: bytes. The pool reads the input once (9 taps per output, 4x
// overlap served from L1/L2) and writes a quarter-size output; at the
// flagship stem (1, 64, 96, 320) that is 7.9 MB read + 2.0 MB written, a
// few microseconds of HBM time, so the launch itself dominates. Adjacent
// threads own adjacent output columns, so their reads fall on the same
// cache lines.
//
// Semantics: pad taps are skipped, which is the same as padding with -inf.
// The max is taken by comparison, keeping the first of equal values, and a
// NaN tap wins (as jnp.maximum and torch's max_pool2d propagate NaN); fmaxf
// would drop it. The result is bit-identical to F.max_pool2d.
//
// Backward: replaces fusiondepth_tpu/ops/pallas_pool.py::_pool_bwd
// (pallas_call at :208). Every input pixel receives g / count from each
// window (at most 2x2) in which it equals the window's max, count being
// the number of the window's 9 taps equal to the max, pad taps counted as
// -inf (pallas_pool.py:24-28, ops/pooling.py:107-158). torch's own
// max_pool2d backward would route a tie to one argmax instead; ties are
// common here, since the pool's input is a ReLU output and all-zero
// windows are frequent. A NaN window passes no gradient. One thread per
// input pixel visits its windows in the order of the plain version's
// scatter (kernels/pool.py), so the two agree bit for bit. Bound: bytes,
// reading x, y and g once and writing dx (at the depth encoder's stem at
// batch 12, x of (12, 64, 96, 320): 94 + 24 + 24 MB read, 94 MB written,
// 70 us at 3.35 TB/s); the window re-reads hit L1/L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void maxpool3x3s2_fwd_kernel(const float* __restrict__ x,
                                        float* __restrict__ y, int H, int W,
                                        int Ho, int Wo, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ow = (int)(i % Wo);
  const long long t = i / Wo;
  const int oh = (int)(t % Ho);
  const long long plane = t / Ho;  // b * C + c
  const float* xp = x + plane * H * W;
  float m = -INFINITY;
  for (int dy = 0; dy < 3; ++dy) {
    const int h = 2 * oh - 1 + dy;
    if (h < 0 || h >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int w = 2 * ow - 1 + dx;
      if (w < 0 || w >= W) continue;
      const float v = __ldg(xp + (long long)h * W + w);
      if (v > m || isnan(v)) m = v;
    }
  }
  y[i] = m;
}

// How many of the 9 taps of the window of output (oh, ow) equal m, pad
// taps being -inf.
__device__ __forceinline__ float window_count(const float* xp, int H, int W,
                                              int oh, int ow, float m) {
  float n = 0.f;
  for (int dy = 0; dy < 3; ++dy) {
    const int h = 2 * oh - 1 + dy;
    for (int dx = 0; dx < 3; ++dx) {
      const int w = 2 * ow - 1 + dx;
      const float v = (h < 0 || h >= H || w < 0 || w >= W)
                          ? -INFINITY
                          : __ldg(xp + (long long)h * W + w);
      n += (v == m) ? 1.f : 0.f;
    }
  }
  return n;
}

__global__ void maxpool3x3s2_bwd_kernel(const float* __restrict__ x,
                                        const float* __restrict__ y,
                                        const float* __restrict__ g,
                                        float* __restrict__ dx, int H, int W,
                                        int Ho, int Wo, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int w = (int)(i % W);
  const long long t = i / W;
  const int h = (int)(t % H);
  const long long plane = t / H;  // b * C + c
  const float* xp = x + plane * H * W;
  const float* yp = y + plane * Ho * Wo;
  const float* gp = g + plane * Ho * Wo;
  const float v = __ldg(x + i);
  float acc = 0.f;
  // tap (dy, dc) of window (oh, ow) reads input (2 oh - 1 + dy,
  // 2 ow - 1 + dc); taps in the plain version's order
  for (int dy = 0; dy < 3; ++dy) {
    const int r = h + 1 - dy;
    if (r < 0 || (r & 1)) continue;
    const int oh = r >> 1;
    if (oh >= Ho) continue;
    for (int dc = 0; dc < 3; ++dc) {
      const int q = w + 1 - dc;
      if (q < 0 || (q & 1)) continue;
      const int ow = q >> 1;
      if (ow >= Wo) continue;
      const long long o = (long long)oh * Wo + ow;
      const float m = __ldg(yp + o);
      if (v == m) {
        const float n = window_count(xp, H, W, oh, ow, m);
        acc += __ldg(gp + o) / fmaxf(n, 1.f);
      }
    }
  }
  dx[i] = acc;
}

}  // namespace

// Output is (B, C, (H - 1) / 2 + 1, (W - 1) / 2 + 1), the floor size of
// MaxPool2d(3, 2, 1) for odd and even inputs. Launches on `stream`, which
// belongs to the current device. Returns cudaGetLastError().
extern "C" int fd_maxpool3x3s2_fwd(const void* x, void* y, int B, int C,
                                   int H, int W, void* stream) {
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const long long total = (long long)B * C * Ho * Wo;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  maxpool3x3s2_fwd_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, H, W, Ho, Wo, total);
  return (int)cudaGetLastError();
}

// x (B, C, H, W) with H and W even, y and g (B, C, H/2, W/2) -> dx
// (B, C, H, W).
extern "C" int fd_maxpool3x3s2_bwd(const void* x, const void* y,
                                   const void* g, void* dx, int B, int C,
                                   int H, int W, void* stream) {
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const long long total = (long long)B * C * H * W;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  maxpool3x3s2_bwd_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)g, (float*)dx, H, W,
      Ho, Wo, total);
  return (int)cudaGetLastError();
}

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
