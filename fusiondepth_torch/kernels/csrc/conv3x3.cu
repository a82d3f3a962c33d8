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
// fd_conv3x3_dgrad: d(input) of either, from the cotangent g (B, Co, H, W)
//   and the weight. Replaces the dgrad use of _run_conv in
//   pallas_fold_conv.py::_bwd (:511) and ::_zbwd (:615). It is the same
//   kernel run on g with the flipped, transposed weight (the wrapper
//   passes w.flip(2, 3).transpose(0, 1)). Zero pad: that correlation is
//   d(input) itself (d of the activated input in the act case; the act
//   backward stays in tensor ops, as in _zbwd). Reflect pad: the
//   correlation runs over the padded domain, rows and columns -1..H and
//   -1..W, into a scratch tensor, and a second kernel applies the adjoint
//   of ReflectionPad2d(1): padded row -1 adds into row 1, padded row H
//   into row H-2, the same for columns, corners folding twice (see _bwd's
//   docstring). That kernel also splits the channels into dx0 and dx1, so
//   the concat never exists in the backward either.
//
// fd_conv3x3_wgrad: dW[co, ci, ky, kx] = sum over b, h, w of
//   g[b, co, h, w] * xt[b, ci, h + ky - 1, w + kx - 1], xt the reflect- or
//   zero-padded input (the virtual concat of x0 and x1; in the act case
//   relu(x * s + t) on in-bounds taps, the pad staying 0). Replaces
//   pallas_fold_conv.py::_run_wgrad (pallas_call at :466). The TPU kernel
//   carries the sum across its sequential grid; here blocks run in
//   parallel, so each block sums a contiguous run of 8 x 32 pixel tiles
//   for a 16 x 16 (co, ci) tile into a partial (split, Co, Ci, 9), and a
//   second kernel adds the partials in a fixed order: deterministic, no
//   atomics. The sums reach ~1.5M products at the decoder's full-res stage
//   at batch 12.
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
               float* __restrict__ y,            // (B, Co, Ho, Wo)
               int H, int W,    // input size
               int Ho, int Wo,  // output size
               int off,  // output (oh, ow) is input (oh - off, ow - off)
               int Co, int tiles_w, int reflect, int elu) {
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
      int h = oh0 - 1 - off + r;
      int x = ow0 - 1 - off + q;
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
  if (oh >= Ho || ow >= Wo) return;
  const long long HWo = (long long)Ho * Wo;
#pragma unroll
  for (int k = 0; k < CO_T; ++k) {
    const int co = co0 + k;
    if (co < Co) {
      float v = acc[k];
      if (bias) v += __ldg(bias + co);
      if (elu) v = v > 0.f ? v : expm1f(v);
      y[(b * Co + co) * HWo + (long long)oh * Wo + ow] = v;
    }
  }
}

template <int CO_T>
void launch(const float* x0, int C0, const float* x1, int C1, const float* w,
            const float* bias, const float* scale, const float* shift,
            float* y, int B, int H, int W, int off, int Co, int reflect,
            int elu, cudaStream_t stream) {
  const int Ho = H + 2 * off;
  const int Wo = W + 2 * off;
  const int tiles_w = (Wo + TW - 1) / TW;
  const int tiles = tiles_w * ((Ho + TH - 1) / TH);
  const dim3 grid(tiles, (Co + CO_T - 1) / CO_T, B);
  conv3x3_kernel<CO_T><<<grid, THREADS, 0, stream>>>(
      x0, C0, x1, C1, w, bias, scale, shift, y, H, W, Ho, Wo, off, Co,
      tiles_w, reflect, elu);
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

// Output (B, Co, H + 2 off, W + 2 off); off = 1 only with zero pad.
int run(const float* x0, int C0, const float* x1, int C1, const float* w,
        const float* bias, const float* scale, const float* shift, float* y,
        int B, int H, int W, int off, int Co, int reflect, int elu,
        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (co_tile(B, H + 2 * off, W + 2 * off, Co)) {
    case 1:
      launch<1>(x0, C0, x1, C1, w, bias, scale, shift, y, B, H, W, off, Co,
                reflect, elu, s);
      break;
    case 4:
      launch<4>(x0, C0, x1, C1, w, bias, scale, shift, y, B, H, W, off, Co,
                reflect, elu, s);
      break;
    default:
      launch<16>(x0, C0, x1, C1, w, bias, scale, shift, y, B, H, W, off, Co,
                 reflect, elu, s);
  }
  return (int)cudaGetLastError();
}

// Adjoint of ReflectionPad2d(1) with the channel split: dxp (B, C0 + C1,
// H + 2, W + 2) over padded positions -1..H, -1..W -> dx0 (B, C0, H, W),
// dx1 (B, C1, H, W). Additions in the order of the plain version
// (kernels/conv3x3.py::reflect_pad_adjoint): rows, then columns.
__global__ void reflect_fold_kernel(const float* __restrict__ dxp,
                                    float* __restrict__ dx0, int C0,
                                    float* __restrict__ dx1, int C1, int H,
                                    int W, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int Ci = C0 + C1;
  const int w = (int)(i % W);
  const long long t = i / W;
  const int h = (int)(t % H);
  const long long bc = t / H;
  const int c = (int)(bc % Ci);
  const long long b = bc / Ci;
  const int Wp = W + 2;
  const float* p = dxp + bc * (long long)(H + 2) * Wp;
  // padded index of position k is k + 1
  auto row = [&](int q) {
    float v = __ldg(p + (long long)(h + 1) * Wp + q);
    if (h == 1) v += __ldg(p + q);
    if (h == H - 2) v += __ldg(p + (long long)(H + 1) * Wp + q);
    return v;
  };
  float v = row(w + 1);
  if (w == 1) v += row(0);
  if (w == W - 2) v += row(W + 1);
  const long long HW = (long long)H * W;
  if (c < C0)
    dx0[(b * C0 + c) * HW + (long long)h * W + w] = v;
  else
    dx1[(b * C1 + (c - C0)) * HW + (long long)h * W + w] = v;
}

constexpr int WG_CO = 16;  // wgrad output channels per block
constexpr int WG_CI = 16;  // wgrad input channels per block
constexpr int XS_STRIDE = (TH + 2) * (TW + 2) + 1;  // odd: no bank clash
constexpr int WG_BLOCKS = 528;  // 4 blocks per SM of the H100's 132

// Partial weight gradient of one (co, ci) tile over a run of pixel tiles.
// Thread (co_l, ci_l) keeps the 9 taps of its pair in registers; per
// output row it slides a 3 x 3 window of the staged input along the row,
// so each new column costs 3 input loads and 1 cotangent load for 9 FMAs.
__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_kernel(const float* __restrict__ x0, int C0,
                     const float* __restrict__ x1, int C1,
                     const float* __restrict__ scale,  // (C0,) or null
                     const float* __restrict__ shift,  // (C0,) or null
                     const float* __restrict__ g,      // (B, Co, H, W)
                     float* __restrict__ part,         // (splits, Co, Ci, 9)
                     int H, int W, int Co, int tiles_w, int tiles_img,
                     int n_tiles, int per_split, int reflect) {
  __shared__ float gs[WG_CO][TH * TW];
  __shared__ float xs[WG_CI * XS_STRIDE];

  const int Ci = C0 + C1;
  const int ci_tiles = (Ci + WG_CI - 1) / WG_CI;
  const int co0 = (blockIdx.x / ci_tiles) * WG_CO;
  const int ci0 = (blockIdx.x % ci_tiles) * WG_CI;
  const int co_l = threadIdx.x / WG_CI;
  const int ci_l = threadIdx.x % WG_CI;
  const long long HW = (long long)H * W;

  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;

  const int split = (int)blockIdx.y;
  const int t_end = min(n_tiles, (split + 1) * per_split);
  for (int tile = split * per_split; tile < t_end; ++tile) {
    const long long b = tile / tiles_img;
    const int rem = tile % tiles_img;
    const int oh0 = (rem / tiles_w) * TH;
    const int ow0 = (rem % tiles_w) * TW;
    for (int e = threadIdx.x; e < WG_CO * TH * TW; e += THREADS) {
      const int k = e / (TH * TW);
      const int r = (e / TW) % TH;
      const int q = e % TW;
      const int co = co0 + k;
      const int h = oh0 + r;
      const int x = ow0 + q;
      gs[k][r * TW + q] =
          (co < Co && h < H && x < W)
              ? __ldg(g + (b * Co + co) * HW + (long long)h * W + x)
              : 0.f;
    }
    for (int e = threadIdx.x; e < WG_CI * (TH + 2) * (TW + 2);
         e += THREADS) {
      const int ci = e / ((TH + 2) * (TW + 2));
      const int r = (e / (TW + 2)) % (TH + 2);
      const int q = e % (TW + 2);
      const int c = ci0 + ci;
      int h = oh0 - 1 + r;
      int x = ow0 - 1 + q;
      if (reflect) {
        h = h < 0 ? -h : (h >= H ? 2 * H - 2 - h : h);
        x = x < 0 ? -x : (x >= W ? 2 * W - 2 - x : x);
      }
      float v = 0.f;
      if (c < Ci && h >= 0 && h < H && x >= 0 && x < W) {
        const float* src = c < C0 ? x0 + (b * C0 + c) * HW
                                  : x1 + (b * C1 + (c - C0)) * HW;
        v = __ldg(src + (long long)h * W + x);
        if (scale) {
          v = v * __ldg(scale + c) + __ldg(shift + c);
          v = v < 0.f ? 0.f : v;
        }
      }
      xs[ci * XS_STRIDE + r * (TW + 2) + q] = v;
    }
    __syncthreads();
    const float* xc = xs + ci_l * XS_STRIDE;
#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
      const float* gr = gs[co_l] + r * TW;
      const float* r0 = xc + r * (TW + 2);
      const float* r1 = r0 + (TW + 2);
      const float* r2 = r1 + (TW + 2);
      float a0 = r0[0], a1 = r0[1], b0 = r1[0], b1 = r1[1], c0 = r2[0],
            c1 = r2[1];
#pragma unroll
      for (int q = 0; q < TW; ++q) {
        const float a2 = r0[q + 2], b2 = r1[q + 2], c2 = r2[q + 2];
        const float gv = gr[q];
        acc[0] = fmaf(gv, a0, acc[0]);
        acc[1] = fmaf(gv, a1, acc[1]);
        acc[2] = fmaf(gv, a2, acc[2]);
        acc[3] = fmaf(gv, b0, acc[3]);
        acc[4] = fmaf(gv, b1, acc[4]);
        acc[5] = fmaf(gv, b2, acc[5]);
        acc[6] = fmaf(gv, c0, acc[6]);
        acc[7] = fmaf(gv, c1, acc[7]);
        acc[8] = fmaf(gv, c2, acc[8]);
        a0 = a1; a1 = a2; b0 = b1; b1 = b2; c0 = c1; c1 = c2;
      }
    }
    __syncthreads();
  }
  const int co = co0 + co_l;
  const int ci = ci0 + ci_l;
  if (co < Co && ci < Ci) {
    float* out = part + (((long long)split * Co + co) * Ci + ci) * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = acc[k];
  }
}

// dw[i] = sum over splits s, in order, of part[s][i].
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, int splits,
                                  long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += __ldg(part + s * n + i);
  dw[i] = v;
}

struct WgradGrid {
  int tiles_w, tiles_img, n_tiles, per_split, splits;
};

WgradGrid wgrad_grid(int B, int H, int W, int Co, int Ci) {
  WgradGrid gd;
  gd.tiles_w = (W + TW - 1) / TW;
  gd.tiles_img = gd.tiles_w * ((H + TH - 1) / TH);
  gd.n_tiles = gd.tiles_img * B;
  const int pairs = ((Co + WG_CO - 1) / WG_CO) * ((Ci + WG_CI - 1) / WG_CI);
  int want = (WG_BLOCKS + pairs - 1) / pairs;
  want = want < 1 ? 1 : (want > gd.n_tiles ? gd.n_tiles : want);
  gd.per_split = (gd.n_tiles + want - 1) / want;
  gd.splits = (gd.n_tiles + gd.per_split - 1) / gd.per_split;
  return gd;
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
             (const float*)bias, nullptr, nullptr, (float*)y, B, H, W,
             /*off=*/0, Co, /*reflect=*/1, elu, stream);
}

// x (B, C, H, W), w (Co, C, 3, 3), scale/shift (C,) or both null (no input
// transform), y (B, Co, H, W).
extern "C" int fd_conv3x3_zero_act_fwd(const void* x, int C, const void* w,
                                       const void* scale, const void* shift,
                                       void* y, int B, int H, int W, int Co,
                                       void* stream) {
  return run((const float*)x, C, nullptr, 0, (const float*)w, nullptr,
             (const float*)scale, (const float*)shift, (float*)y, B, H, W,
             /*off=*/0, Co, /*reflect=*/0, /*elu=*/0, stream);
}

// g (B, Co, H, W), wt (C0 + C1, Co, 3, 3) the flipped, transposed weight.
// Zero pad (reflect 0): writes dx0 (B, C0, H, W); C1 must be 0 and dxp is
// unused. Reflect pad: dxp (B, C0 + C1, H + 2, W + 2) is scratch, and the
// result goes to dx0 and dx1 (B, C1, H, W; null when C1 is 0).
extern "C" int fd_conv3x3_dgrad(const void* g, int Co, const void* wt,
                                void* dxp, void* dx0, int C0, void* dx1,
                                int C1, int B, int H, int W, int reflect,
                                void* stream) {
  const int Ci = C0 + C1;
  if (!reflect)
    return run((const float*)g, Co, nullptr, 0, (const float*)wt, nullptr,
               nullptr, nullptr, (float*)dx0, B, H, W, /*off=*/0, Ci,
               /*reflect=*/0, /*elu=*/0, stream);
  int err = run((const float*)g, Co, nullptr, 0, (const float*)wt, nullptr,
                nullptr, nullptr, (float*)dxp, B, H, W, /*off=*/1, Ci,
                /*reflect=*/0, /*elu=*/0, stream);
  if (err) return err;
  const long long total = (long long)B * Ci * H * W;
  const long long blocks = (total + THREADS - 1) / THREADS;
  reflect_fold_kernel<<<(unsigned)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const float*)dxp, (float*)dx0, C0, (float*)dx1, C1, H, W, total);
  return (int)cudaGetLastError();
}

// How many partial sums fd_conv3x3_wgrad writes: its `part` scratch is
// (splits, Co, C0 + C1, 9).
extern "C" int fd_conv3x3_wgrad_splits(int B, int H, int W, int Co, int Ci) {
  return wgrad_grid(B, H, W, Co, Ci).splits;
}

// g (B, Co, H, W); x0 (B, C0, H, W), x1 (B, C1, H, W) or null; scale and
// shift (C0,) or both null (zero pad only); part scratch; dw (Co, C0 + C1,
// 3, 3).
extern "C" int fd_conv3x3_wgrad(const void* g, int Co, const void* x0,
                                int C0, const void* x1, int C1,
                                const void* scale, const void* shift,
                                void* part, void* dw, int B, int H, int W,
                                int reflect, void* stream) {
  const int Ci = C0 + C1;
  const WgradGrid gd = wgrad_grid(B, H, W, Co, Ci);
  const dim3 grid(((Co + WG_CO - 1) / WG_CO) * ((Ci + WG_CI - 1) / WG_CI),
                  gd.splits);
  conv3x3_wgrad_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x0, C0, (const float*)x1, C1, (const float*)scale,
      (const float*)shift, (const float*)g, (float*)part, H, W, Co,
      gd.tiles_w, gd.tiles_img, gd.n_tiles, gd.per_split, reflect);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)Co * Ci * 9;
  sum_splits_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>((const float*)part,
                                              (float*)dw, gd.splits, n);
  return (int)cudaGetLastError();
}
