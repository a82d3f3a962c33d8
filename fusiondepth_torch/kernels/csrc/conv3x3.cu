// 3x3 stride-1 convolutions of the depth path, NCHW float32, as implicit
// GEMMs on the tensor cores with fp32-accurate 3xTF32 products.
//
// Entry points:
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
//   pallas_fold_conv.py::_bwd (:511) and ::_zbwd (:615). It is the forward
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
//   parallel, so each block sums a contiguous run of pixel tiles into a
//   partial (split, Co, Ci, 9), and a second kernel adds the partials in a
//   fixed order: deterministic, no atomics. The sums reach ~1.5M products
//   at the decoder's full-res stage at batch 12.
//
// Design. Both conv kernels are implicit GEMMs on the tensor cores, with
// mma.sync.aligned.m16n8k8 TF32 products made fp32-accurate by the 3xTF32
// split: every operand x becomes big = tf32(x) (cvt.rna.tf32.f32, round to
// nearest, ties away) and small = tf32(x - big), and a * b is taken as
// a_s b_b + a_b b_s + a_b b_b, small products first; the dropped a_s b_s
// is ~2^-22 of the product. One TF32 product keeps 10 mantissa bits and
// would miss the 1e-4 tolerances of the fp32 plain versions. wgmma would
// need K-major operands in shared memory, and the shifted halo views
// below are not K-major, so the fragments are loaded by each warp from
// shared memory for mma.sync.
// - conv3x3_fwd_kernel<NT> (forward and dgrad): M = 256 output pixels of
//   one image (8 rows x 32 columns, one warp per row, two m16 tiles per
//   warp), N = NT output channels (8, 16, 32 or 64, chosen per call by
//   kernels/conv3x3.py::conv_tiles), K = Ci x 9. Per chunk of CI_T = 8
//   input channels one halo tile (8, 10, 34) and the chunk's (NT, 8, 9)
//   weights are staged in shared memory, and the 9 shifted views of the
//   halo are the 9 taps' A fragments: no im2col in HBM, each staged value
//   read for 9 taps. The halo is split into big and small planes once, as
//   it is staged; the weights are split where a warp loads them (a
//   second pair of weight planes cost occupancy and time on the card).
//   Epilogue: bias, ELU, NCHW stores (each 8 lanes of a warp write 8
//   neighbouring columns: whole 32-byte sectors).
// - conv3x3_wgrad_kernel<MW> (wgrad): M = output channels, N = input
//   channels x 9 taps, K = pixels. A warp owns one or two m16 tiles of
//   output channels and 8 input channels with their 9 taps (9 n8 tiles);
//   a block of 4 warps covers 16 MW output channels (MW = 1, 2, 4) and
//   32, 32 or 16 input channels, and sums a contiguous run of 2 x 32 pixel
//   tiles. A is the cotangent tile (co, pixel) in shared memory, split
//   where it is loaded; B the 9 shifted views of the input halo, staged
//   and split as in the forward. MW and the split count come from
//   conv_tiles, so that narrow Co wastes few rows and every grid fills
//   the 132 SMs.
// - Accumulation. The tensor core truncates the sum it adds into, so an
//   accumulator that took all of a deep conv's products would drift: at
//   Ci = 512 (1728 products into each) by ~1e-4 of its value, beyond
//   CONV_TOL on the card. The forward sums each tap's three products of a
//   tile from 0 and adds them to the fp32 accumulator with a rounded add;
//   the wgrad sums each pixel tile from 0 the same way. The sum of an
//   output is then as exact as a rounded fp32 sum, in a fixed order.
// - Staging is double-buffered with cp.async (zero fill for pad taps,
//   tails of Ci and Co, and ragged tiles): the copies of the next chunk or
//   tile are in flight while this one's MMAs run. The weights and the
//   cotangent go in 16-byte copies where their rows are aligned (Ci % 4 ==
//   0, W % 4 == 0), the halo in 4-byte copies, whose source address does
//   the reflect addressing and the skip concat. The act prologue is the
//   one transform: each thread applies relu(x * s + t) to the in-bounds
//   values it copied itself, after its copies land, as it splits them.
// - Shared memory is laid out so that fragment loads have no bank
//   conflicts: a forward halo plane is 360 floats (= 8 mod 32: lanes (g, t)
//   read t * 360 + g), a wgrad halo plane 164 (= 4 mod 32: lanes read
//   g * 164 + t), a cotangent row 68, a weight row of 72 taps 76 floats
//   (lanes read g * 76 + 9 t). The forward holds <= 85 KB a block (NT =
//   64) and the wgrad <= 101 KB: two blocks fit on an SM.
//
// Bound. An fp32-accurate conv on this card takes no less than the larger
// of its bytes over 3.35 TB/s and 3 x its operations over the 495 TFLOP/s
// dense TF32 rate (165 TFLOP/s of fp32-accurate products), whatever
// implements it; on the CUDA cores the bound would be 67 TFLOP/s. The
// layer1 conv at batch 12 is 6.8 GFLOP: 0.041 ms at that rate, its 2 x
// 23.6 MB of activations 0.014 ms at the HBM rate. mma.sync does not reach
// the TF32 rate that wgmma does (scripts/mma_tf32_rate.cu measures its
// ceiling), and the splits, the staging's address arithmetic and the
// flushed sums take issue slots beside the MMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;       // columns of a pixel tile
constexpr int HALO_W = TW + 2;
constexpr int FWD_TH = 8;    // forward pixel tile rows: one warp per row
constexpr int FWD_THREADS = 32 * FWD_TH;
constexpr int CI_T = 8;      // forward: input channels per K chunk (one k8)
constexpr int FWD_HALO_H = FWD_TH + 2;
constexpr int FWD_CS = 360;  // forward halo plane: >= 10 x 34, = 8 mod 32
constexpr int WG_THREADS = 128;  // wgrad block: 4 warps
constexpr int WG_TH = 2;     // wgrad pixel tile: 2 rows x 32 columns
constexpr int WG_HALO_H = WG_TH + 2;
constexpr int WG_CS = 164;   // wgrad halo plane: >= 4 x 34, = 4 mod 32
constexpr int WG_GS = WG_TH * TW + 4;  // wgrad cotangent row: = 4 mod 32

// big = tf32(x) with cvt.rna (round to nearest, ties away from zero; the
// low 13 bits cleared), small = tf32(x - big).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split3(float x, uint32_t& big,
                                       uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d = a * b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, fp32 out.
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c += a * b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, fp32 accumulate.
// Not volatile: a pure function of its operands, which the compiler may
// schedule between independent products.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4-byte asynchronous copy global -> shared; zero fill when !valid (no
// byte is read then, and src need only be a valid pointer).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// The 16-byte copy: dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The input of a conv as the kernels read it: the virtual concat of x0
// (C0 channels) and x1 (C1), reflect- or zero-padded, optionally through
// relu(x * scale + shift) (x0 only; the wrapper refuses it with x1).
struct Input {
  const float* x0;
  const float* x1;
  const float* scale;
  const float* shift;
  int C0, C1, H, W;
  int reflect;
};

// Address of the padded input's (c, h, w) in image b; null when that tap
// is padding (zero pad, channel tail, or beyond a reflected edge, which
// only feeds outputs that are not stored).
__device__ __forceinline__ const float* halo_src(const Input& in, long long b,
                                                 int c, int h, int w) {
  if (in.reflect) {
    h = h < 0 ? -h : (h >= in.H ? 2 * in.H - 2 - h : h);
    w = w < 0 ? -w : (w >= in.W ? 2 * in.W - 2 - w : w);
  }
  if (c >= in.C0 + in.C1 || h < 0 || h >= in.H || w < 0 || w >= in.W)
    return nullptr;
  const long long HW = (long long)in.H * in.W;
  const float* plane = c < in.C0 ? in.x0 + (b * in.C0 + c) * HW
                                 : in.x1 + (b * in.C1 + (c - in.C0)) * HW;
  return plane + (long long)h * in.W + w;
}

// Issue the copies of the (NCH, HH, HALO_W) halo of channels c0.. into
// xs (channel planes CS floats apart); halo row 0 is input row h0, column
// 0 input column w0.
template <int NCH, int CS, int HH, int NTHR>
__device__ __forceinline__ void stage_halo(float* xs, const Input& in,
                                           long long b, int c0, int h0,
                                           int w0) {
  for (int e = threadIdx.x; e < NCH * HH * HALO_W; e += NTHR) {
    const int ci = e / (HH * HALO_W);
    const int pos = e - ci * (HH * HALO_W);
    const int r = pos / HALO_W;
    const int q = pos - r * HALO_W;
    const float* src = halo_src(in, b, c0 + ci, h0 + r, w0 + q);
    cp_async4(xs + ci * CS + pos, src ? src : in.x0, src != nullptr);
  }
}

// Once this thread's copies of stage_halo have landed: the act prologue on
// the values it copied, relu(x * s + t) on in-bounds taps (rounded as the
// plain version rounds it, a product, then a sum; padding stays 0), then
// the split, big in place, small into the plane `small`. Each value is
// split once here, not at each of its 9 uses.
template <int NCH, int CS, int HH, int NTHR>
__device__ __forceinline__ void split_halo(float* big, float* small,
                                           const Input& in, long long b,
                                           int c0, int h0, int w0) {
  for (int e = threadIdx.x; e < NCH * HH * HALO_W; e += NTHR) {
    const int ci = e / (HH * HALO_W);
    const int pos = e - ci * (HH * HALO_W);
    float v = big[ci * CS + pos];
    if (in.scale) {
      const int r = pos / HALO_W;
      const int c = c0 + ci;
      if (halo_src(in, b, c, h0 + r, w0 + pos - r * HALO_W)) {
        v = __fadd_rn(__fmul_rn(v, __ldg(in.scale + c)), __ldg(in.shift + c));
        v = v > 0.f ? v : 0.f;
      }
    }
    uint32_t hi, lo;
    split3(v, hi, lo);
    big[ci * CS + pos] = __uint_as_float(hi);
    small[ci * CS + pos] = __uint_as_float(lo);
  }
}

// ---- forward and dgrad: M = pixels, N = output channels, K = Ci x 9 ----

// A chunk's weights in shared memory: ws[n][ci * 9 + tap], rows of
// FWD_WS floats (= 12 mod 32: lanes (g, t) read g * 76 + 9 t + const, 32
// banks), so that the copy from w[co][c][tap] is linear on both sides.
constexpr int FWD_WS = 76;

template <int NT>
struct FwdTile {
  static constexpr int XS = 2 * CI_T * FWD_CS;  // big, small planes
  static constexpr int WS = NT * FWD_WS;
  static constexpr int BYTES = 2 * (XS + WS) * (int)sizeof(float);
};

// Output (b, co, oh, ow) of the (B, Co, Ho, Wo) result is the conv at
// input position (oh - off, ow - off). Block: 8 x 32 output pixels of one
// image (warp w owns row w) and NT output channels.
template <int NT>
__global__ void __launch_bounds__(FWD_THREADS, 2)
conv3x3_fwd_kernel(Input in, const float* __restrict__ w,  // (Co, Ci, 3, 3)
                   const float* __restrict__ bias,         // (Co,) or null
                   float* __restrict__ y, int Ho, int Wo, int off, int Co,
                   int tiles_w, int elu, int wvec) {
  using T = FwdTile<NT>;
  extern __shared__ float smem[];
  float* const xs0 = smem;            // + buf * XS
  float* const ws0 = smem + 2 * T::XS;  // + buf * WS

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;  // mma group: fragment row / column
  const int t = lane & 3;    // thread in group
  const int oh0 = (blockIdx.x / tiles_w) * FWD_TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * NT;
  const long long b = blockIdx.z;
  const int Ci = in.C0 + in.C1;
  const int h0 = oh0 - 1 - off;  // input row of halo row 0
  const int w0 = ow0 - 1 - off;
  const int chunks = (Ci + CI_T - 1) / CI_T;

  auto stage = [&](int k, int buf) {
    stage_halo<CI_T, FWD_CS, FWD_HALO_H, FWD_THREADS>(xs0 + buf * T::XS, in,
                                                      b, k * CI_T, h0, w0);
    // w[co][c][tap] of the chunk, 72 contiguous floats per co ->
    // ws[n][ci * 9 + tap]
    float* ws = ws0 + buf * T::WS;
    if (wvec) {  // 16-byte copies: Ci % 4 == 0, so a group is in or out
      for (int e = threadIdx.x; e < NT * CI_T * 9 / 4; e += FWD_THREADS) {
        const int n = e / (CI_T * 9 / 4);
        const int rem = (e - n * (CI_T * 9 / 4)) * 4;
        const int co = co0 + n;
        const bool ok = co < Co && k * CI_T + rem / 9 < Ci;
        cp_async16(ws + n * FWD_WS + rem,
                   ok ? w + ((long long)co * Ci + k * CI_T) * 9 + rem : w, ok);
      }
    } else {
      for (int e = threadIdx.x; e < NT * CI_T * 9; e += FWD_THREADS) {
        const int n = e / (CI_T * 9);
        const int rem = e - n * (CI_T * 9);
        const int co = co0 + n;
        const bool ok = co < Co && k * CI_T + rem / 9 < Ci;
        cp_async4(ws + n * FWD_WS + rem,
                  ok ? w + ((long long)co * Ci + k * CI_T) * 9 + rem : w, ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][NT / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  stage(0, 0);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    if (k + 1 < chunks) {
      stage(k + 1, buf ^ 1);  // in flight during this chunk's MMAs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float* const xs = xs0 + buf * T::XS;
    split_halo<CI_T, FWD_CS, FWD_HALO_H, FWD_THREADS>(xs, xs + CI_T * FWD_CS,
                                                      in, b, k * CI_T, h0, w0);
    __syncthreads();

    const float* xw = xs + warp * HALO_W + gq;  // big; small CI_T planes on
    const float* wsb = ws0 + buf * T::WS + gq * FWD_WS + t * 9;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // A (16 pixels x 8 channels): rows gq, gq + 8; columns t, t + 4
        const float* p = xw + ky * HALO_W + kx + m * 16 + t * FWD_CS;
        const float* ps = p + CI_T * FWD_CS;
        ab[m][0] = __float_as_uint(p[0]);
        ab[m][1] = __float_as_uint(p[8]);
        ab[m][2] = __float_as_uint(p[4 * FWD_CS]);
        ab[m][3] = __float_as_uint(p[4 * FWD_CS + 8]);
        as[m][0] = __float_as_uint(ps[0]);
        as[m][1] = __float_as_uint(ps[8]);
        as[m][2] = __float_as_uint(ps[4 * FWD_CS]);
        as[m][3] = __float_as_uint(ps[4 * FWD_CS + 8]);
      }
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) {
        // B (8 channels x 8 outputs): rows t, t + 4; column gq
        uint32_t bb[2], bs[2];
        const float* p = wsb + n * 8 * FWD_WS + tap;
        split3(p[0], bb[0], bs[0]);
        split3(p[4 * 9], bb[1], bs[1]);
        // the tap's three products of a tile start from 0 and join acc by
        // an fp32 add: the tensor core truncates the sum it adds into, so
        // an accumulator that took all Ci * 27 / 8 products of a deep conv
        // would drift (by ~1e-4 of it at Ci = 512)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float d[4];
          mma_tf32_zero(d, as[m], bb);
          mma_tf32(d, ab[m], bs);
          mma_tf32(d, ab[m], bb);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] += d[i];
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  // C (16 x 8): c0, c1 at row gq, columns 2t, 2t + 1; c2, c3 at row gq + 8
  const int oh = oh0 + warp;
  if (oh >= Ho) return;
  const long long HWo = (long long)Ho * Wo;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ow = ow0 + m * 16 + gq + (i >= 2 ? 8 : 0);
        const int co = co0 + n * 8 + 2 * t + (i & 1);
        if (ow < Wo && co < Co) {
          float v = acc[m][n][i];
          if (bias) v += __ldg(bias + co);
          if (elu) v = v > 0.f ? v : expm1f(v);
          y[(b * Co + co) * HWo + (long long)oh * Wo + ow] = v;
        }
      }
}

template <int NT>
int launch_fwd(const Input& in, const float* w, const float* bias, float* y,
               int B, int off, int Co, int elu, cudaStream_t s) {
  const int Ho = in.H + 2 * off;
  const int Wo = in.W + 2 * off;
  const int tiles_w = (Wo + TW - 1) / TW;
  const int tiles = tiles_w * ((Ho + FWD_TH - 1) / FWD_TH);
  constexpr int bytes = FwdTile<NT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, (Co + NT - 1) / NT, B);
  // 16-byte copies of the weights when every row of 9 Ci floats is
  // 16-byte aligned
  const int wvec = (in.C0 + in.C1) % 4 == 0 && (uintptr_t)w % 16 == 0;
  conv3x3_fwd_kernel<NT><<<grid, FWD_THREADS, bytes, s>>>(
      in, w, bias, y, Ho, Wo, off, Co, tiles_w, elu, wvec);
  return (int)cudaGetLastError();
}

// Output (B, Co, H + 2 off, W + 2 off); off = 1 only with zero pad. nt: the
// N tile, from kernels/conv3x3.py::conv_tiles.
int run_fwd(const Input& in, const float* w, const float* bias, float* y,
            int B, int off, int Co, int elu, int nt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nt) {
    case 8: return launch_fwd<8>(in, w, bias, y, B, off, Co, elu, s);
    case 16: return launch_fwd<16>(in, w, bias, y, B, off, Co, elu, s);
    case 32: return launch_fwd<32>(in, w, bias, y, B, off, Co, elu, s);
    case 64: return launch_fwd<64>(in, w, bias, y, B, off, Co, elu, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// ---- wgrad: M = output channels, N = input channels x 9 taps, K = pixels

// MW (the block's output channel tile is 16 MW): 1 for Co <= 16, 2 for
// Co <= 32, else 4. A warp owns WMT m16 tiles of output channels and 8
// input channels with their 9 taps (9 n8 tiles); the block's 4 warps are
// MWB along the output and NWB along the input channels.
template <int MW>
struct WgTile {
  static constexpr int WMT = MW == 1 ? 1 : 2;
  static constexpr int MWB = MW == 4 ? 2 : 1;
  static constexpr int NWB = 4 / MWB;
  static constexpr int CO_T = 16 * WMT * MWB;  // 16, 32, 64
  static constexpr int CI_TW = 8 * NWB;        // 32, 32, 16
  static constexpr int GS = CO_T * WG_GS;      // floats per stage
  static constexpr int XS = 2 * CI_TW * WG_CS;  // big, small planes
  static constexpr int BYTES = 2 * (GS + XS) * (int)sizeof(float);
};

// Partial weight gradient of one (CO_T, CI_TW) tile over the run of pixel
// tiles (2 x 32) of split blockIdx.y.
template <int MW>
__global__ void __launch_bounds__(WG_THREADS)
conv3x3_wgrad_kernel(Input in, const float* __restrict__ g,  // (B, Co, H, W)
                     float* __restrict__ part,  // (splits, Co, Ci, 9)
                     int Co, int ci_tiles, int tiles_w, int tiles_img,
                     int n_tiles, int per_split, int vec) {
  using T = WgTile<MW>;
  constexpr int PX = WG_TH * TW;  // pixels per tile
  extern __shared__ float smem[];
  float* const gs0 = smem;              // + buf * GS
  float* const xs0 = smem + 2 * T::GS;  // + buf * XS

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / T::NWB;
  const int wn = warp % T::NWB;
  const int co0 = (blockIdx.x / ci_tiles) * T::CO_T;
  const int ci0 = (blockIdx.x % ci_tiles) * T::CI_TW;
  const int Ci = in.C0 + in.C1;
  const int H = in.H, W = in.W;
  const int split = (int)blockIdx.y;
  const int t_begin = split * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);

  auto origin = [&](int tile, long long& b, int& oh0, int& ow0) {
    b = tile / tiles_img;
    const int rem = tile % tiles_img;
    oh0 = (rem / tiles_w) * WG_TH;
    ow0 = (rem % tiles_w) * TW;
  };
  auto stage = [&](int tile, int buf) {
    long long b;
    int oh0, ow0;
    origin(tile, b, oh0, ow0);
    float* gs = gs0 + buf * T::GS;
    if (vec) {  // 16-byte copies: W % 4 == 0, so a group is in or out
      for (int e = threadIdx.x; e < T::CO_T * PX / 4; e += WG_THREADS) {
        const int k = e / (PX / 4);
        const int p = (e - k * (PX / 4)) * 4;
        const int r = p / TW;
        const int co = co0 + k;
        const int h = oh0 + r;
        const int x = ow0 + p - r * TW;
        const bool ok = co < Co && h < H && x < W;
        cp_async16(gs + k * WG_GS + p,
                   ok ? g + ((b * Co + co) * H + h) * (long long)W + x : g,
                   ok);
      }
    } else {
      for (int e = threadIdx.x; e < T::CO_T * PX; e += WG_THREADS) {
        const int k = e / PX;
        const int p = e - k * PX;
        const int r = p / TW;
        const int co = co0 + k;
        const int h = oh0 + r;
        const int x = ow0 + p - r * TW;
        const bool ok = co < Co && h < H && x < W;
        cp_async4(gs + k * WG_GS + p,
                  ok ? g + ((b * Co + co) * H + h) * (long long)W + x : g, ok);
      }
    }
    stage_halo<T::CI_TW, WG_CS, WG_HALO_H, WG_THREADS>(
        xs0 + buf * T::XS, in, b, ci0, oh0 - 1, ow0 - 1);
    cp_async_commit();
  };

  float acc[T::WMT][9][4];
#pragma unroll
  for (int m = 0; m < T::WMT; ++m)
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][k][i] = 0.f;

  if (t_begin < t_end) stage(t_begin, 0);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage(tile + 1, buf ^ 1);  // in flight during this tile's MMAs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float* const xs = xs0 + buf * T::XS;
    {
      long long b;
      int oh0, ow0;
      origin(tile, b, oh0, ow0);
      split_halo<T::CI_TW, WG_CS, WG_HALO_H, WG_THREADS>(
          xs, xs + T::CI_TW * WG_CS, in, b, ci0, oh0 - 1, ow0 - 1);
    }
    __syncthreads();

    // this tile's sums start from 0 and join acc by an fp32 add (see the
    // forward)
    float part[T::WMT][9][4];
#pragma unroll
    for (int m = 0; m < T::WMT; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[m][k][i] = 0.f;
    // A (16 channels x 8 pixels): rows gq, gq + 8; columns t, t + 4
    const float* ga =
        gs0 + buf * T::GS + (wm * T::WMT * 16 + gq) * WG_GS + t;
    // B (8 pixels x 8 channels): rows t, t + 4; column gq; split at staging
    const float* xb = xs + (wn * 8 + gq) * WG_CS + t;
#pragma unroll 2
    for (int j = 0; j < PX / 8; ++j) {
      const int r = j / (TW / 8);
      const int q0 = (j % (TW / 8)) * 8;
      uint32_t ab[T::WMT][4], as[T::WMT][4], bb[9][2], bs[9][2];
#pragma unroll
      for (int m = 0; m < T::WMT; ++m) {
        const float* p = ga + m * 16 * WG_GS + j * 8;
        split3(p[0], ab[m][0], as[m][0]);
        split3(p[8 * WG_GS], ab[m][1], as[m][1]);
        split3(p[4], ab[m][2], as[m][2]);
        split3(p[8 * WG_GS + 4], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* p = xb + (r + tap / 3) * HALO_W + q0 + tap % 3;
        const float* ps = p + T::CI_TW * WG_CS;
        bb[tap][0] = __float_as_uint(p[0]);
        bb[tap][1] = __float_as_uint(p[4]);
        bs[tap][0] = __float_as_uint(ps[0]);
        bs[tap][1] = __float_as_uint(ps[4]);
      }
      // pass by pass: no product waits on the one before it
#pragma unroll
      for (int m = 0; m < T::WMT; ++m)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tf32(part[m][tap], as[m], bb[tap]);
#pragma unroll
      for (int m = 0; m < T::WMT; ++m)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tf32(part[m][tap], ab[m], bs[tap]);
#pragma unroll
      for (int m = 0; m < T::WMT; ++m)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tf32(part[m][tap], ab[m], bb[tap]);
    }
#pragma unroll
    for (int m = 0; m < T::WMT; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][k][i] += part[m][k][i];
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  // C (16 x 8): c0, c1 at row gq, columns 2t, 2t + 1; c2, c3 at row gq + 8
#pragma unroll
  for (int m = 0; m < T::WMT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + (wm * T::WMT + m) * 16 + gq + (i >= 2 ? 8 : 0);
      const int ci = ci0 + wn * 8 + 2 * t + (i & 1);
      if (co < Co && ci < Ci) {
        float* out = part + (((long long)split * Co + co) * Ci + ci) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) out[tap] = acc[m][tap][i];
      }
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

template <int MW>
int launch_wgrad(const Input& in, const float* g, float* part, int B,
                 int Co, int splits, cudaStream_t s) {
  using T = WgTile<MW>;
  const int tiles_w = (in.W + TW - 1) / TW;
  const int tiles_img = tiles_w * ((in.H + WG_TH - 1) / WG_TH);
  const int n_tiles = tiles_img * B;
  const int per_split = (n_tiles + splits - 1) / splits;
  // every split must own at least one tile: conv_tiles picks splits so
  if (splits < 1 || (n_tiles + per_split - 1) / per_split != splits)
    return (int)cudaErrorInvalidValue;
  const int ci_tiles = (in.C0 + in.C1 + T::CI_TW - 1) / T::CI_TW;
  const int co_tiles = (Co + T::CO_T - 1) / T::CO_T;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgrad_kernel<MW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(co_tiles * ci_tiles, splits);
  // 16-byte copies of the cotangent when its rows are 16-byte aligned
  const int vec = in.W % 4 == 0 && (uintptr_t)g % 16 == 0;
  conv3x3_wgrad_kernel<MW><<<grid, WG_THREADS, T::BYTES, s>>>(
      in, g, part, Co, ci_tiles, tiles_w, tiles_img, n_tiles, per_split,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, which belongs to the current
// device, and returns cudaGetLastError() (cudaErrorInvalidValue for a tile
// choice it does not take). nt, mw and splits come from
// kernels/conv3x3.py::conv_tiles.

// x0 (B, C0, H, W), x1 (B, C1, H, W) or null, w (Co, C0 + C1, 3, 3),
// bias (Co,), y (B, Co, H, W); nt in {8, 16, 32, 64}.
extern "C" int fd_conv3x3_reflect_fwd(const void* x0, int C0, const void* x1,
                                      int C1, const void* w, const void* bias,
                                      void* y, int B, int H, int W, int Co,
                                      int elu, int nt, void* stream) {
  const Input in{(const float*)x0, (const float*)x1, nullptr, nullptr,
                 C0, C1, H, W, /*reflect=*/1};
  return run_fwd(in, (const float*)w, (const float*)bias, (float*)y, B,
                 /*off=*/0, Co, elu, nt, stream);
}

// x (B, C, H, W), w (Co, C, 3, 3), scale/shift (C,) or both null (no input
// transform), y (B, Co, H, W); nt in {8, 16, 32, 64}.
extern "C" int fd_conv3x3_zero_act_fwd(const void* x, int C, const void* w,
                                       const void* scale, const void* shift,
                                       void* y, int B, int H, int W, int Co,
                                       int nt, void* stream) {
  const Input in{(const float*)x, nullptr, (const float*)scale,
                 (const float*)shift, C, 0, H, W, /*reflect=*/0};
  return run_fwd(in, (const float*)w, nullptr, (float*)y, B, /*off=*/0, Co,
                 /*elu=*/0, nt, stream);
}

// g (B, Co, H, W), wt (C0 + C1, Co, 3, 3) the flipped, transposed weight.
// Zero pad (reflect 0): writes dx0 (B, C0, H, W); C1 must be 0 and dxp is
// unused. Reflect pad: dxp (B, C0 + C1, H + 2, W + 2) is scratch, and the
// result goes to dx0 and dx1 (B, C1, H, W; null when C1 is 0). nt: the N
// tile over the C0 + C1 output channels.
extern "C" int fd_conv3x3_dgrad(const void* g, int Co, const void* wt,
                                void* dxp, void* dx0, int C0, void* dx1,
                                int C1, int B, int H, int W, int reflect,
                                int nt, void* stream) {
  const int Ci = C0 + C1;
  const Input in{(const float*)g, nullptr, nullptr, nullptr, Co, 0, H, W,
                 /*reflect=*/0};
  if (!reflect)
    return run_fwd(in, (const float*)wt, nullptr, (float*)dx0, B, /*off=*/0,
                   Ci, /*elu=*/0, nt, stream);
  int err = run_fwd(in, (const float*)wt, nullptr, (float*)dxp, B,
                    /*off=*/1, Ci, /*elu=*/0, nt, stream);
  if (err) return err;
  const long long total = (long long)B * Ci * H * W;
  const long long blocks = (total + 255) / 256;
  reflect_fold_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)dxp, (float*)dx0, C0, (float*)dx1, C1, H, W, total);
  return (int)cudaGetLastError();
}

// g (B, Co, H, W); x0 (B, C0, H, W), x1 (B, C1, H, W) or null; scale and
// shift (C0,) or both null (zero pad only); part scratch (splits, Co,
// C0 + C1, 9); dw (Co, C0 + C1, 3, 3). mw in {1, 2, 4}: the block's output
// channel tile is 16 mw; splits: how many runs of pixel tiles.
extern "C" int fd_conv3x3_wgrad(const void* g, int Co, const void* x0,
                                int C0, const void* x1, int C1,
                                const void* scale, const void* shift,
                                void* part, void* dw, int B, int H, int W,
                                int reflect, int mw, int splits,
                                void* stream) {
  const Input in{(const float*)x0, (const float*)x1, (const float*)scale,
                 (const float*)shift, C0, C1, H, W, reflect};
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (mw) {
    case 1: err = launch_wgrad<1>(in, (const float*)g, (float*)part, B, Co,
                                  splits, s); break;
    case 2: err = launch_wgrad<2>(in, (const float*)g, (float*)part, B, Co,
                                  splits, s); break;
    case 4: err = launch_wgrad<4>(in, (const float*)g, (float*)part, B, Co,
                                  splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const long long n = (long long)Co * (C0 + C1) * 9;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (float*)dw, splits, n);
  return (int)cudaGetLastError();
}
