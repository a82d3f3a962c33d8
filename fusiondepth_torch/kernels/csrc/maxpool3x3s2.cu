// Stem max-pool forward: torch MaxPool2d(kernel 3, stride 2, padding 1) on
// an NCHW float32 tensor, one thread per output element.
//
// Replaces the TPU kernel fusiondepth_tpu/ops/pallas_pool.py::_pool_fwd
// (pallas_call at :186). The TPU version regroups (W, C) -> (W/2, 2C)
// outside the kernel so that the stride-2 column taps become lane halves
// in VMEM; on Hopper a strided read is just an address, so each thread
// reads its 3x3 window directly.
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

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
