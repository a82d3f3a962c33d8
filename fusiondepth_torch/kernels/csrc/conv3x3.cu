// 3x3 stride-1 convolutions of the depth path, NCHW float32, direct form.
//
// Two entry points share one kernel:
//
// fd_conv3x3_reflect_fwd: the depth decoder's ConvBlock (ReflectionPad2d(1),
//   3x3 conv, bias, ELU) and its Conv3x3 disparity head (no ELU). Replaces
//   the TPU kernel fusiondepth_tpu/ops/pallas_fold_conv.py::_run_conv as
//   driven by fold_conv3x3_pallas._fwd (pallas_call at :370). Its input is
//   the virtual concat of x0 (C0 channels) and an optional x1 (C1
//   channels): the skip concat [upsampled, skip] is read from the two
//   tensors and never materialised, as the TPU kernel's sum over inputs
//   keeps it out of HBM. The reflect pad is addressed, not built: col -1
//   reads col 1 and col W reads col W-2, rows likewise
//   (pallas_fold_conv.py:28-31).
//
// fd_conv3x3_zero_act_fwd: the encoder basic-block conv, zero pad, no bias,
//   with the preceding BatchNorm affine + ReLU optionally applied to the
//   input as it is staged: relu(x * s[c] + t[c]). Replaces _run_conv as
//   driven by fold_conv3x3_zero_pallas._zfwd (:601). The transform applies
//   to in-bounds taps only; pad taps stay 0 after it, as the TPU kernel's
//   structural-zero masks do (pallas_fold_conv.py:99-108, _act_transform).
//   Feeding relu(t) at the border would be wrong.
//
// Design: a block owns an 8 x 32 tile of output pixels (one warp per row)
// of one image and CO_T output channels. Per step it stages CI_T input
// channels of the tile plus a one-pixel halo, and their CO_T x CI_T x 9
// weights, in shared memory; each thread then accumulates its pixel's CO_T
// outputs in fp32 registers. The TPU version's W-fold (lane density) and
// H-window stacking have no purpose here and are not carried over.
//
// Bound: the fp32 CUDA-core issue rate. The decoder at 640x192 is about
// 7.1 GFLOP a frame (67 TFLOP/s peak fp32: ~0.11 ms at best) while its
// convs read and write some 69 MB (~20 us at 3.35 TB/s). Every FMA needs
// one shared-memory operand (the weight, broadcast to the warp), so it runs
// below the fp32 peak; tensor cores (TF32/bf16 implicit GEMM) are the next
// step and are not taken in this first, plain version. CO_T is chosen per
// call so that the small, deep decoder stages still give the card more
// than a handful of blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block: one warp per row
constexpr int CI_T = 8;  // input channels staged per step
constexpr int THREADS = TH * TW;

template <int CO_T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x0, int C0,
               const float* __restrict__ x1, int C1,
               const float* __restrict__ w,      // (Co, C0 + C1, 3, 3)
               const float* __restrict__ bias,   // (Co,) or null
               const float* __restrict__ scale,  // (C0,) or null
               const float* __restrict__ shift,  // (C0,) or null
               float* __restrict__ y,            // (B, Co, H, W)
               int H, int W, int Co, int tiles_w, int reflect, int elu) {
  __shared__ float xs[CI_T][TH + 2][TW + 2];
  __shared__ float ws[CI_T][9][CO_T];

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO_T;
  const long long b = blockIdx.z;
  const int Ci = C0 + C1;
  const long long HW = (long long)H * W;
  const float* x0b = x0 + b * C0 * HW;
  const float* x1b = x1 ? x1 + b * C1 * HW : nullptr;

  float acc[CO_T];
#pragma unroll
  for (int k = 0; k < CO_T; ++k) acc[k] = 0.f;

  for (int cb = 0; cb < Ci; cb += CI_T) {
    for (int e = threadIdx.x; e < CI_T * (TH + 2) * (TW + 2); e += THREADS) {
      const int ci = e / ((TH + 2) * (TW + 2));
      const int r = (e / (TW + 2)) % (TH + 2);
      const int q = e % (TW + 2);
      const int c = cb + ci;
      int h = oh0 - 1 + r;
      int x = ow0 - 1 + q;
      if (reflect) {
        h = h < 0 ? -h : (h >= H ? 2 * H - 2 - h : h);
        x = x < 0 ? -x : (x >= W ? 2 * W - 2 - x : x);
      }
      float v = 0.f;
      // Out-of-range positions are zero padding, or (reflect) halo of a
      // tile that overhangs the image and feeds no stored output.
      if (c < Ci && h >= 0 && h < H && x >= 0 && x < W) {
        const float* src = c < C0 ? x0b + c * HW : x1b + (c - C0) * HW;
        v = __ldg(src + (long long)h * W + x);
        if (scale) {
          v = v * __ldg(scale + c) + __ldg(shift + c);
          v = v < 0.f ? 0.f : v;
        }
      }
      xs[ci][r][q] = v;
    }
    for (int e = threadIdx.x; e < CI_T * 9 * CO_T; e += THREADS) {
      const int k = e % CO_T;
      const int t = (e / CO_T) % 9;
      const int ci = e / (9 * CO_T);
      const int co = co0 + k;
      const int c = cb + ci;
      ws[ci][t][k] = (co < Co && c < Ci)
                         ? __ldg(w + ((long long)co * Ci + c) * 9 + t)
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < CI_T; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = xs[ci][ty + ky][tx + kx];
#pragma unroll
          for (int k = 0; k < CO_T; ++k)
            acc[k] = fmaf(v, ws[ci][ky * 3 + kx][k], acc[k]);
        }
      }
    }
    __syncthreads();
  }

  const int oh = oh0 + ty;
  const int ow = ow0 + tx;
  if (oh >= H || ow >= W) return;
#pragma unroll
  for (int k = 0; k < CO_T; ++k) {
    const int co = co0 + k;
    if (co < Co) {
      float v = acc[k];
      if (bias) v += __ldg(bias + co);
      if (elu) v = v > 0.f ? v : expm1f(v);
      y[(b * Co + co) * HW + (long long)oh * W + ow] = v;
    }
  }
}

template <int CO_T>
void launch(const float* x0, int C0, const float* x1, int C1, const float* w,
            const float* bias, const float* scale, const float* shift,
            float* y, int B, int H, int W, int Co, int reflect, int elu,
            cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_w * ((H + TH - 1) / TH);
  const dim3 grid(tiles, (Co + CO_T - 1) / CO_T, B);
  conv3x3_kernel<CO_T><<<grid, THREADS, 0, stream>>>(
      x0, C0, x1, C1, w, bias, scale, shift, y, H, W, Co, tiles_w, reflect,
      elu);
}

// Output channels per block: 16 when that still gives at least two blocks
// per SM of the H100's 132, else 4; 1 for the single-channel heads.
int co_tile(int B, int H, int W, int Co) {
  if (Co == 1) return 1;
  const long long tiles =
      (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  if (Co >= 16 && tiles * ((Co + 15) / 16) >= 264) return 16;
  return 4;
}

int run(const float* x0, int C0, const float* x1, int C1, const float* w,
        const float* bias, const float* scale, const float* shift, float* y,
        int B, int H, int W, int Co, int reflect, int elu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (co_tile(B, H, W, Co)) {
    case 1:
      launch<1>(x0, C0, x1, C1, w, bias, scale, shift, y, B, H, W, Co,
                reflect, elu, s);
      break;
    case 4:
      launch<4>(x0, C0, x1, C1, w, bias, scale, shift, y, B, H, W, Co,
                reflect, elu, s);
      break;
    default:
      launch<16>(x0, C0, x1, C1, w, bias, scale, shift, y, B, H, W, Co,
                 reflect, elu, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream`, which belongs to the current device,
// and return cudaGetLastError().

// x0 (B, C0, H, W), x1 (B, C1, H, W) or null, w (Co, C0 + C1, 3, 3),
// bias (Co,), y (B, Co, H, W).
extern "C" int fd_conv3x3_reflect_fwd(const void* x0, int C0, const void* x1,
                                      int C1, const void* w, const void* bias,
                                      void* y, int B, int H, int W, int Co,
                                      int elu, void* stream) {
  return run((const float*)x0, C0, (const float*)x1, C1, (const float*)w,
             (const float*)bias, nullptr, nullptr, (float*)y, B, H, W, Co,
             /*reflect=*/1, elu, stream);
}

// x (B, C, H, W), w (Co, C, 3, 3), scale/shift (C,) or both null (no input
// transform), y (B, Co, H, W).
extern "C" int fd_conv3x3_zero_act_fwd(const void* x, int C, const void* w,
                                       const void* scale, const void* shift,
                                       void* y, int B, int H, int W, int Co,
                                       void* stream) {
  return run((const float*)x, C, nullptr, 0, (const float*)w, nullptr,
             (const float*)scale, (const float*)shift, (float*)y, B, H, W, Co,
             /*reflect=*/0, /*elu=*/0, stream);
}
