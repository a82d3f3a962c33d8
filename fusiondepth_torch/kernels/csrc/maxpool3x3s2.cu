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
// (pallas_call at :208, _bwd_kernel at :92). Every input pixel receives
// g / count from each window (at most 2x2) in which it equals the window's
// max, count being the number of the window's 9 taps equal to the max, pad
// taps counted as -inf (pallas_pool.py:24-28, ops/pooling.py:107-158).
// torch's own max_pool2d backward would route a tie to one argmax instead;
// ties are common here, since the pool's input is a ReLU output and
// all-zero windows are frequent. A NaN window passes no gradient.
//
// Bound: bytes. x, y and g are read once and dx written once: at a batch-12
// train step's four stems, x of (12, 64, 96, 320) twice and (24, 64, 96,
// 320) twice, 1416 MB in all, 0.423 ms at 3.35 TB/s.
//
// Design: one kernel, shared-memory tiled. A block owns a tile of
// PB_TH x PB_TW windows of one (b, c) plane and the 2 PB_TH x 2 PB_TW input
// pixels they own (rows 2 oh, 2 oh + 1 and columns 2 ow, 2 ow + 1 of each
// window (oh, ow)). Those pixels reach one window past the tile in H and
// in W, so the block stages, with coalesced loads, the x rows
// 2 oh0 - 1 ... 2 (oh0 + PB_TH) + 1 and the matching columns (pad taps as
// -inf), and y and g of (PB_TH + 1) x (PB_TW + 1) windows (y as NaN past
// the image, so that no pixel matches a window that does not exist). Pass 1
// counts each window's ties over its 9 staged taps once and keeps
// gc = g / max(count, 1) (IEEE division; the library is built without fast
// math). Pass 2: each thread owns one 2 x 2 quad of input pixels, so every
// thread has the same parity and no warp splits on it; each pixel adds the
// gc of its windows where x == y in the order of the plain version's
// scatter over the taps (dy, dx) (kernels/pool.py), so the two agree bit
// for bit, and the quad's two rows are written as float2. Nothing is
// recounted from global memory. Shared memory: (2 PB_TH + 3) x
// (2 PB_TW + 3) + 2 (PB_TH + 1) x (PB_TW + 1) floats, 7.3 KB a block of 256
// threads, and 32 registers, so an SM keeps 8 blocks; the x halo is 19/16
// x 67/64 of the tile and is served mostly from L2, where the
// neighbouring tile reads it too. (Staging x's interior columns as float4
// measured slower on the card than these coalesced scalar loads.)
//
// bfloat16 (compute_dtype="bfloat16"; the _bf16 entry points): the same
// kernels on bf16 x, y, g and dx, as pallas_pool.py:100-155 takes them.
// The forward's max is exact in any type, so it stores the bf16 tap it
// picked. The backward widens every value to float32 as it stages it,
// compares ties exactly there, divides and sums g / count in float32
// (pooling.py:123-158 upcasts g the same way) and rounds each dx once, as
// it is stored. Half the bytes of the float32 kernels, so half their
// bounds.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

template <typename T>
__global__ void maxpool3x3s2_fwd_kernel(const T* __restrict__ x,
                                        T* __restrict__ y, int H, int W,
                                        int Ho, int Wo, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ow = (int)(i % Wo);
  const long long t = i / Wo;
  const int oh = (int)(t % Ho);
  const long long plane = t / Ho;  // b * C + c
  const T* xp = x + plane * H * W;
  float m = -INFINITY;
  for (int dy = 0; dy < 3; ++dy) {
    const int h = 2 * oh - 1 + dy;
    if (h < 0 || h >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int w = 2 * ow - 1 + dx;
      if (w < 0 || w >= W) continue;
      const float v = ldg_f(xp + (long long)h * W + w);
      if (v > m || isnan(v)) m = v;
    }
  }
  st_f(y + i, m);  // one of the taps: exact in T
}

// The backward's tile: PB_TH x PB_TW windows, 256 threads, one 2 x 2 quad
// of input pixels a thread.
constexpr int PB_TH = 8;
constexpr int PB_TW = 32;
constexpr int PB_THREADS = PB_TH * PB_TW;
constexpr int PB_XR = 2 * PB_TH + 3;  // staged x rows, 2 oh0 - 1 ...
constexpr int PB_XC = 2 * PB_TW + 3;  // staged x columns, 2 ow0 - 1 ...
constexpr int PB_WR = PB_TH + 1;      // windows oh0 ... oh0 + PB_TH
constexpr int PB_WC = PB_TW + 1;      // windows ow0 ... ow0 + PB_TW

template <typename T>
__global__ void __launch_bounds__(PB_THREADS)
    maxpool3x3s2_bwd_kernel(const T* __restrict__ x,
                            const T* __restrict__ y,
                            const T* __restrict__ g,
                            T* __restrict__ dx, int H, int W, int Ho,
                            int Wo, int tiles_h, int tiles_w) {
  __shared__ float xs[PB_XR][PB_XC];
  __shared__ float ys[PB_WR][PB_WC];
  __shared__ float gcs[PB_WR][PB_WC];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int tw = (int)(tile % tiles_w);
  const long long t = tile / tiles_w;
  const int th = (int)(t % tiles_h);
  const long long plane = t / tiles_h;  // b * C + c
  const int oh0 = th * PB_TH, ow0 = tw * PB_TW;
  const T* xp = x + plane * H * W;
  const T* yp = y + plane * Ho * Wo;
  const T* gp = g + plane * Ho * Wo;

  for (int i = tid; i < PB_XR * PB_XC; i += PB_THREADS) {
    const int r = i / PB_XC, c = i % PB_XC;
    const int h = 2 * oh0 - 1 + r, w = 2 * ow0 - 1 + c;
    xs[r][c] = (h >= 0 && h < H && w >= 0 && w < W)
                   ? ldg_f(xp + (long long)h * W + w)
                   : -INFINITY;
  }
  for (int i = tid; i < PB_WR * PB_WC; i += PB_THREADS) {
    const int r = i / PB_WC, c = i % PB_WC;
    const int oh = oh0 + r, ow = ow0 + c;
    const bool in = oh < Ho && ow < Wo;
    const long long o = (long long)oh * Wo + ow;
    ys[r][c] = in ? ldg_f(yp + o) : NAN;
    gcs[r][c] = in ? ldg_f(gp + o) : 0.f;
  }
  __syncthreads();

  // pass 1: gc = g / max(count, 1); the window (r, c)'s tap (dy, dx) is
  // staged at (2 r + dy, 2 c + dx). Each element is read and written by the
  // same thread as in the loop above.
  for (int i = tid; i < PB_WR * PB_WC; i += PB_THREADS) {
    const int r = i / PB_WC, c = i % PB_WC;
    const float m = ys[r][c];
    float n = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        n += (xs[2 * r + dy][2 * c + dc] == m) ? 1.f : 0.f;
    gcs[r][c] = gcs[r][c] / fmaxf(n, 1.f);
  }
  __syncthreads();

  // pass 2: the quad of window (ty, tx), input pixels (2 oh + a, 2 ow + b)
  // staged at (2 ty + 1 + a, 2 tx + 1 + b). A pixel on an even row or
  // column sits at tap 1 of its one window there; on an odd one at tap 0
  // of the next window and tap 2 of its own, taken in that order.
  const int ty = tid / PB_TW, tx = tid % PB_TW;
  const int oh = oh0 + ty, ow = ow0 + tx;
  if (oh >= Ho || ow >= Wo) return;
  const float y00 = ys[ty][tx], y01 = ys[ty][tx + 1];
  const float y10 = ys[ty + 1][tx], y11 = ys[ty + 1][tx + 1];
  const float g00 = gcs[ty][tx], g01 = gcs[ty][tx + 1];
  const float g10 = gcs[ty + 1][tx], g11 = gcs[ty + 1][tx + 1];
  const int sr = 2 * ty + 1, sc = 2 * tx + 1;
  const float x00 = xs[sr][sc], x01 = xs[sr][sc + 1];
  const float x10 = xs[sr + 1][sc], x11 = xs[sr + 1][sc + 1];
  float2 top, bot;
  top.x = 0.f;  // (even, even): window (oh, ow)
  if (x00 == y00) top.x += g00;
  top.y = 0.f;  // (even, odd): windows (oh, ow + 1), (oh, ow)
  if (x01 == y01) top.y += g01;
  if (x01 == y00) top.y += g00;
  bot.x = 0.f;  // (odd, even): windows (oh + 1, ow), (oh, ow)
  if (x10 == y10) bot.x += g10;
  if (x10 == y00) bot.x += g00;
  bot.y = 0.f;  // (odd, odd): (oh + 1, ow + 1), (oh + 1, ow), (oh, ow + 1),
                // (oh, ow)
  if (x11 == y11) bot.y += g11;
  if (x11 == y10) bot.y += g10;
  if (x11 == y01) bot.y += g01;
  if (x11 == y00) bot.y += g00;
  T* dp = dx + plane * H * W + (long long)(2 * oh) * W + 2 * ow;
  st2_f(dp, top);
  st2_f(dp + W, bot);
}

template <typename T>
int launch_fwd(const void* x, void* y, int B, int C, int H, int W,
               void* stream) {
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const long long total = (long long)B * C * Ho * Wo;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  maxpool3x3s2_fwd_kernel<T><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, H, W, Ho, Wo, total);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, void* dx, int B,
               int C, int H, int W, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_h = (Ho + PB_TH - 1) / PB_TH;
  const int tiles_w = (Wo + PB_TW - 1) / PB_TW;
  const long long blocks = (long long)B * C * tiles_h * tiles_w;
  maxpool3x3s2_bwd_kernel<T><<<(unsigned)blocks, PB_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, (const T*)g, (T*)dx, H, W, Ho, Wo, tiles_h,
      tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Output is (B, C, (H - 1) / 2 + 1, (W - 1) / 2 + 1), the floor size of
// MaxPool2d(3, 2, 1) for odd and even inputs. Launches on `stream`, which
// belongs to the current device. Returns cudaGetLastError().
extern "C" int fd_maxpool3x3s2_fwd(const void* x, void* y, int B, int C,
                                   int H, int W, void* stream) {
  return launch_fwd<float>(x, y, B, C, H, W, stream);
}

// x (B, C, H, W) with H and W even, y and g (B, C, H/2, W/2) -> dx
// (B, C, H, W). One block per tile of PB_TH x PB_TW windows of a plane.
extern "C" int fd_maxpool3x3s2_bwd(const void* x, const void* y,
                                   const void* g, void* dx, int B, int C,
                                   int H, int W, void* stream) {
  return launch_bwd<float>(x, y, g, dx, B, C, H, W, stream);
}

// The same on bfloat16 tensors.
extern "C" int fd_maxpool3x3s2_fwd_bf16(const void* x, void* y, int B, int C,
                                        int H, int W, void* stream) {
  return launch_fwd<bf16>(x, y, B, C, H, W, stream);
}

extern "C" int fd_maxpool3x3s2_bwd_bf16(const void* x, const void* y,
                                        const void* g, void* dx, int B,
                                        int C, int H, int W, void* stream) {
  return launch_bwd<bf16>(x, y, g, dx, B, C, H, W, stream);
}

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
