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
//
// bfloat16 (compute_dtype="bfloat16"; the _bf16 entry points): kernels of
// their own, conv3x3_fwd_bf16_kernel (forward and dgrad) and
// conv3x3_wgrad_bf16_kernel, on the same blocks and warps (see "bfloat16:
// raw bf16 tiles" below; the bf16 operands of pallas_fold_conv.py:279-323
// and :511-575). Their tiles hold the raw bf16 values, staged ahead of the
// MMAs (register loads where the layout is transformed, cp.async where it
// is not), and each product is one mma.sync m16n8k16 bf16 with fp32
// accumulation: a bf16 x bf16 product is exact in fp32, which is what the
// Pallas kernel's bf16 MXU pass with preferred_element_type=f32 computes.
// Each tap's (forward) or 16-pixel (wgrad) sum still starts from 0 and
// joins the fp32 accumulator with an fp32 add. The act prologue rounds as
// the bf16 tensor ops of the plain version do (the product to bf16, then
// the sum to bf16; pallas_fold_conv.py:598 casts the scale and shift to
// bf16). Outputs, as the Pallas kernel writes them: the forward adds the
// float32 bias, applies ELU in float32 and rounds once to bf16; the
// zero-pad dgrad rounds its output to bf16 (:627); the reflect dgrad
// keeps its padded-domain sums in float32 (:539) and the pad adjoint
// rounds the folded result to bf16 (:564): the forward kernel rounds and
// stores the pixels that take their own sum only, and
// reflect_fold_border_bf16_kernel folds the rows and columns that take
// more (FoldOut); the wgrad sums its float32
// partials and rounds dW to bf16, the dtype of the weight operand it is
// the gradient of (:572). Bound: operations over the 989 TFLOP/s dense
// bf16 rate, or bytes over 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"

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

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// The input of a conv as the kernels read it: the virtual concat of x0
// (C0 channels) and x1 (C1), reflect- or zero-padded, optionally through
// relu(x * scale + shift) (x0 only; the wrapper refuses it with x1).
template <typename T>
struct Input {
  const T* x0;
  const T* x1;
  const T* scale;
  const T* shift;
  int C0, C1, H, W;
  int reflect;
};

// Address of the padded input's (c, h, w) in image b; null when that tap
// is padding (zero pad, channel tail, or beyond a reflected edge, which
// only feeds outputs that are not stored).
template <typename T>
__device__ __forceinline__ const T* halo_src(const Input<T>& in, long long b,
                                             int c, int h, int w) {
  if (in.reflect) {
    h = h < 0 ? -h : (h >= in.H ? 2 * in.H - 2 - h : h);
    w = w < 0 ? -w : (w >= in.W ? 2 * in.W - 2 - w : w);
  }
  if (c >= in.C0 + in.C1 || h < 0 || h >= in.H || w < 0 || w >= in.W)
    return nullptr;
  const long long HW = (long long)in.H * in.W;
  const T* plane = c < in.C0 ? in.x0 + (b * in.C0 + c) * HW
                             : in.x1 + (b * in.C1 + (c - in.C0)) * HW;
  return plane + (long long)h * in.W + w;
}

// Issue the copies of the (NCH, HH, HALO_W) halo of channels c0.. into
// xs (channel planes CS floats apart); halo row 0 is input row h0, column
// 0 input column w0.
template <typename T, int NCH, int CS, int HH, int NTHR>
__device__ __forceinline__ void stage_halo(float* xs, const Input<T>& in,
                                           long long b, int c0, int h0,
                                           int w0) {
  for (int e = threadIdx.x; e < NCH * HH * HALO_W; e += NTHR) {
    const int ci = e / (HH * HALO_W);
    const int pos = e - ci * (HH * HALO_W);
    const int r = pos / HALO_W;
    const int q = pos - r * HALO_W;
    const T* src = halo_src(in, b, c0 + ci, h0 + r, w0 + q);
    cp_async4(xs + ci * CS + pos, src ? src : in.x0, src != nullptr);
  }
}

// Once this thread's copies of stage_halo have landed: the act prologue on
// the values it copied, relu(x * s + t) on in-bounds taps (rounded as the
// plain version rounds it, a product, then a sum; padding stays 0), then
// the split, big in place, small into the plane `small`. Each value is
// split once here, not at each of its 9 uses.
template <typename T, int NCH, int CS, int HH, int NTHR>
__device__ __forceinline__ void split_halo(float* big, float* small,
                                           const Input<T>& in, long long b,
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
// image (warp w owns row w) and NT output channels. T is float (the bf16
// entry points have conv3x3_fwd_bf16_kernel).
template <typename T, typename TO, int NT>
__global__ void __launch_bounds__(FWD_THREADS, 2)
conv3x3_fwd_kernel(Input<T> in, const T* __restrict__ w,  // (Co, Ci, 3, 3)
                   const float* __restrict__ bias,        // (Co,) or null
                   TO* __restrict__ y, int Ho, int Wo, int off, int Co,
                   int tiles_w, int elu, int wvec) {
  using Tl = FwdTile<NT>;
  extern __shared__ float smem[];
  float* const xs0 = smem;             // + buf * XS
  float* const ws0 = smem + 2 * Tl::XS;  // + buf * WS

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
    stage_halo<T, CI_T, FWD_CS, FWD_HALO_H, FWD_THREADS>(
        xs0 + buf * Tl::XS, in, b, k * CI_T, h0, w0);
    // w[co][c][tap] of the chunk, 72 contiguous floats per co ->
    // ws[n][ci * 9 + tap]
    float* ws = ws0 + buf * Tl::WS;
    if (wvec) {  // 16-byte copies: Ci % 4 == 0, so a group is in or out
      for (int e = threadIdx.x; e < NT * CI_T * 9 / 4; e += FWD_THREADS) {
        const int n = e / (CI_T * 9 / 4);
        const int rem = (e - n * (CI_T * 9 / 4)) * 4;
        const int co = co0 + n;
        const bool ok = co < Co && k * CI_T + rem / 9 < Ci;
        cp_async16(ws + n * FWD_WS + rem,
                   ok ? (const float*)w + ((long long)co * Ci + k * CI_T) * 9 +
                            rem
                      : (const float*)w,
                   ok);
      }
    } else {
      for (int e = threadIdx.x; e < NT * CI_T * 9; e += FWD_THREADS) {
        const int n = e / (CI_T * 9);
        const int rem = e - n * (CI_T * 9);
        const int co = co0 + n;
        const bool ok = co < Co && k * CI_T + rem / 9 < Ci;
        cp_async4(ws + n * FWD_WS + rem,
                  ok ? (const float*)w + ((long long)co * Ci + k * CI_T) * 9 +
                           rem
                     : (const float*)w,
                  ok);
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
    float* const xs = xs0 + buf * Tl::XS;
    split_halo<T, CI_T, FWD_CS, FWD_HALO_H, FWD_THREADS>(
        xs, xs + CI_T * FWD_CS, in, b, k * CI_T, h0, w0);
    __syncthreads();

    const float* xw = xs + warp * HALO_W + gq;  // big; small CI_T planes on
    const float* wsb = ws0 + buf * Tl::WS + gq * FWD_WS + t * 9;
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
          st_f(y + (b * Co + co) * HWo + (long long)oh * Wo + ow, v);
        }
      }
}

// ---- bfloat16: raw bf16 tiles and mma.sync m16n8k16 ----
//
// conv3x3_fwd_bf16_kernel<TO, NT> (forward and dgrad): the forward's
// block (8 x 32 output pixels, one warp a row, NT output channels), K in
// chunks of BF_CI = 16 input channels, one m16n8k16 product a tap and
// tile. Fragments hold two consecutive K values in a 32-bit register, and
// K is the channel here, so the halo is kept channel-pair interleaved:
// word (pair, row, column) = channels (2 pair, 2 pair + 1) at that pixel
// (the lower channel in the low half). Every tap's shifted view is then a
// whole-word offset, and a lane's A fragment is four 32-bit loads. The
// weights are kept as [tap][output channel][16 input channels] (rows of
// BF_WROW words) and loaded with ldmatrix. Neither layout is a copy of
// the NCHW and OIHW rows, so cp.async cannot make them: each thread loads
// chunk k + 1 into registers (16-byte loads of 8 columns where the rows
// allow, 8- or 4-byte ones where W and the pointers allow less) before
// chunk k's MMAs, and interleaves and stores them after, into the other
// of two buffers. Per-element loads (halo_src) take the two halo edge
// columns, the column W that the reflect pad reads, a channel pair split
// by the x0/x1 concat, channel tails and rows a 4-byte load cannot take.
//
// conv3x3_wgrad_bf16_kernel<MW>: blocks of 16 MW output channels and 4
// warps, a warp one m16 tile of them and 8 input channels (BfWgTile),
// K = 16 pixels a product. A, the cotangent rows (co, pixel), is pixel-
// contiguous: cp.async copies it as it is and ldmatrix loads it. B is the
// halo row of each input channel, also copied as it is ([7] column -1,
// [8, 40) columns 0..31, [40] column 32; cp.async into [8, 40), the two
// edges and the reflect pad's column W by the thread). A B fragment takes
// pixel pairs (2t, 2t + 1) of a row; for kx = 1 they are whole words, for
// kx = 0 and 2 they start at an odd element and are packed from two words
// with one prmt (__byte_perm), the one of two remedies that needs no
// second copy of the halo in shared memory and no second pass over it.
// Three stages: the copies of tile i + 2 are issued after tile i's MMAs,
// and land during tile i + 1's. The act prologue runs in place, by the
// thread that copied the values, once they have landed.
//
// Accumulation, as in the fp32 kernels: each product's sum (16 channels
// of a tap, or 16 pixels of a tap) starts from 0 in the tensor core and
// joins the fp32 accumulator with an fp32 add, in a fixed order (chunks
// in order and taps in order; pixel tiles in order, splits summed by
// sum_splits_kernel in order). A bf16 x bf16 product is exact in fp32.
//
// Shared memory without bank conflicts: a forward halo plane of BF_PLANE
// words (= 24 mod 32: lanes (g, t) read t * 408 + g), weight rows of 48
// bytes (the 8 rows of an ldmatrix phase land on 8 different 4-bank
// groups), wgrad cotangent rows of 144 bytes (9 16-byte units: odd, so
// ldmatrix's 8 rows hit 8 groups) and wgrad halo planes of 100 words (=
// 4 mod 32: lanes read g * 100 + t). The forward holds <= 80 KB a block
// (NT = 64), the wgrad <= 45 KB (three stages, MW = 1).

constexpr int BF_CI = 16;      // bf16 forward: input channels per K chunk
constexpr int BF_ROW = 40;     // bf16 forward halo row: words, >= 3 + 34
constexpr int BF_PLANE = 408;  // bf16 forward halo plane: >= 10 x 40, = 24 mod 32
constexpr int BF_WROW = 12;    // bf16 weight row (tap, co): 16 bf16 + 8 pad, in words
constexpr int BG_STR = 72;     // bf16 wgrad cotangent row: 64 + 8 bf16
constexpr int BX_ROW = 48;     // bf16 wgrad halo row: [7, 41) used, in bf16
constexpr int BX_PLANE = 200;  // bf16 wgrad halo plane: >= 4 x 48, 100 words = 4 mod 32
constexpr int WG_STAGES = 3;

__device__ __forceinline__ uint32_t ldg_bits(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// relu(x * s + t) of one bf16 value (bits), the product and the sum each
// rounded to bf16 as the plain version's bf16 tensor ops round them
__device__ __forceinline__ uint32_t act_bits(uint32_t x, float s, float t) {
  const float v = round_bf16(__fadd_rn(round_bf16(__fmul_rn(bits_to_f(
      (unsigned short)x), s)), t));
  return f_to_bits(v > 0.f ? v : 0.f);
}

// The bits of the padded input's (c, h, w) in image b, 0 for padding; the
// act prologue applied to in-bounds taps.
__device__ __forceinline__ uint32_t bf_tap(const Input<bf16>& in,
                                           long long b, int c, int h,
                                           int w) {
  const bf16* p = halo_src(in, b, c, h, w);
  if (!p) return 0;
  const uint32_t x = ldg_bits(p);
  return in.scale ? act_bits(x, ldg_f(in.scale + c), ldg_f(in.shift + c))
                  : x;
}

// The bits of column w of a row of channel c (from halo_src(.., c, h, 0);
// null where the row or channel is padding), 0 for padding; reflected as
// halo_src reflects, the act prologue applied to in-bounds taps.
__device__ __forceinline__ uint32_t bf_row_tap(const Input<bf16>& in,
                                               const bf16* row, int c,
                                               int w) {
  if (in.reflect) w = w < 0 ? -w : (w >= in.W ? 2 * in.W - 2 - w : w);
  if (!row || w < 0 || w >= in.W) return 0;
  const uint32_t x = ldg_bits(row + w);
  return in.scale ? act_bits(x, ldg_f(in.scale + c), ldg_f(in.shift + c))
                  : x;
}

// The 8 columns from p of one row as 4 words (2 columns a word), in loads
// of va columns (va = 8, 4 or 2; the row and p aligned to it); the loads
// at or past the row's n valid columns (n a multiple of va) give 0.
__device__ __forceinline__ void ldg_cols(uint32_t* v, const bf16* p, int n,
                                         int va) {
  if (va == 8) {
    uint4 q = make_uint4(0, 0, 0, 0);
    if (n == 8) q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if (va == 4) {
    uint2 q0 = make_uint2(0, 0), q1 = make_uint2(0, 0);
    if (n >= 4) q0 = __ldg(reinterpret_cast<const uint2*>(p));
    if (n >= 8) q1 = __ldg(reinterpret_cast<const uint2*>(p + 4));
    v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = 2 * i < n ? __ldg(reinterpret_cast<const unsigned*>(p + 2 * i))
                       : 0u;
  }
}

// d = a * b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 out, from 0
__device__ __forceinline__ void mma_bf16_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// four (two) 8 x 8 b16 matrices from shared memory: lane l gives the row
// address of matrix l / 8; r[i] of lane (g, t) = matrix i's row g,
// elements 2t, 2t + 1
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// BYTES-byte asynchronous copy global -> shared (16, 8 or 4; dst and src
// aligned to it); zero fill when !valid (nothing is read then)
template <int BYTES>
__device__ __forceinline__ void cp_async_bf(void* dst, const void* src,
                                            bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- forward and dgrad ----

template <int NT>
struct BfFwdTile {
  // warps along N: from NT = 32 a warp takes NT / 2 output channels of
  // its row, so a block is 16 warps (one an SM) and a thread holds half
  // the accumulators and staged registers; NT <= 16 takes two 8-warp
  // blocks an SM. Either way <= 128 registers and 16 warps an SM.
  static constexpr int WN = NT >= 32 ? 2 : 1;
  static constexpr int NW = NT / WN;  // output channels a warp
  static constexpr int THREADS = FWD_THREADS * WN;
  static constexpr int MIN_BLOCKS = 2 / WN;
  static constexpr int XS = BF_CI / 2 * BF_PLANE;  // words a buffer
  static constexpr int WS = 9 * NT * BF_WROW;
  static constexpr int BYTES = 2 * (XS + WS) * 4;
  // what a thread stages: slots of halo groups (pair, row, 8 columns)
  // and, after them, halo edges (pair, row, side); weight copies
  static constexpr int GROUPS = BF_CI / 2 * FWD_HALO_H * 4;
  static constexpr int EDGES = BF_CI / 2 * FWD_HALO_H * 2;
  static constexpr int SLOTS = (GROUPS + EDGES + THREADS - 1) / THREADS;
  // weight copies: 16 bytes, two a (tap, output channel) row
  static constexpr int WCOPIES = 9 * NT * 2;
  static constexpr int WSLOTS = (WCOPIES + THREADS - 1) / THREADS;
};

// Output channels of the packed weights, a multiple of every N tile
constexpr int BF_CO_PAD = 64;

// The weights of the bf16 forward as its tiles take them: wp[k][tap][co]
// [16] = w[co][16 k + i][tap] (0 past Co and Ci), co < Co rounded up to
// BF_CO_PAD; one thread a value. A block then copies a chunk's (tap, co)
// rows with 16-byte cp.async, and no block transforms them again.
__global__ void pack_weights_bf16_kernel(const bf16* __restrict__ w,
                                         bf16* __restrict__ wp, int Co,
                                         int Ci, int co_pad, long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int i = (int)(e % BF_CI);
  long long r = e / BF_CI;
  const int co = (int)(r % co_pad);
  r /= co_pad;
  const int tap = (int)(r % 9);
  const int c = (int)(r / 9) * BF_CI + i;
  reinterpret_cast<unsigned short*>(wp)[e] =
      co < Co && c < Ci ? (unsigned short)ldg_bits(w + ((long long)co * Ci + c)
                                                         * 9 + tap)
                        : (unsigned short)0;
}

// what a staged halo slot holds: a group of zeros, of raw rows (channel
// c's 8 columns, then c + 1's), of interleaved words, nothing, or an edge
enum : int { BF_ZERO = 0, BF_RAW = 1, BF_PACKED = 2, BF_NONE = 3,
             BF_EDGE = 4 };

// The bf16 reflect dgrad's outputs: dx0 (B, C0, H, W) and dx1 (B, Co -
// C0, H, W) of the map the padded domain (H + 2, W + 2) pads. Its sums
// at positions that nothing folds into (not in row or column 1 or H - 2
// or W - 2) and that fold nowhere (not in row or column -1 or H or W) are
// dx itself: the kernel rounds and stores those there, and the rest into
// y for reflect_fold_border_bf16_kernel.
struct FoldOut {
  bf16* dx0;
  bf16* dx1;
  int C0;
};

// Output (b, co, oh, ow) of the (B, Co, Ho, Wo) result is the conv at
// input position (oh - off, ow - off), as conv3x3_fwd_kernel's; wp the
// packed weights (pack_weights_bf16_kernel). va: the columns a halo load
// takes (bf_vec). Persistent: block x takes the 8 x 32 tiles x, x +
// gridDim.x, ... of the n_tiles (images, then tile rows, then tile
// columns) for output channels 64 blockIdx.y.., and loads the next tile's
// first chunk during this tile's last MMAs and epilogue.
template <typename TO, int NT>
__global__ void __launch_bounds__(BfFwdTile<NT>::THREADS,
                                  BfFwdTile<NT>::MIN_BLOCKS)
conv3x3_fwd_bf16_kernel(Input<bf16> in, const bf16* __restrict__ wp,
                        const float* __restrict__ bias, TO* __restrict__ y,
                        int Ho, int Wo, int off, int Co, int co_pad,
                        int tiles_w, int tiles_img, int n_tiles, int elu,
                        int va, FoldOut fold) {
  using Tl = BfFwdTile<NT>;
  extern __shared__ uint4 bf_smem[];
  uint32_t* const xs0 = reinterpret_cast<uint32_t*>(bf_smem);  // + buf XS
  uint32_t* const ws0 = xs0 + 2 * Tl::XS;                      // + buf WS

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row = warp % FWD_TH;  // the warp's output row
  const int wn = warp / FWD_TH;   // and its NW output channels
  const int lane = tid % 32;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int co0 = blockIdx.y * NT;
  const int Ci = in.C0 + in.C1;
  const int H = in.H, W = in.W;
  // tile -> its image and first output row and column
  auto origin = [&](int tile, int& b, int& oh0, int& ow0) {
    b = tile / tiles_img;
    const int rem = tile - b * tiles_img;
    oh0 = (rem / tiles_w) * FWD_TH;
    ow0 = (rem % tiles_w) * TW;
  };
  // halo column q is word q + qoff of its row, so that the 8-column
  // groups (columns ow0 + 8 j, halo column 1 + off + 8 j) start at word
  // 4 + 8 j: 16-byte aligned
  const int qoff = 3 - off;
  const int chunks = (Ci + BF_CI - 1) / BF_CI;

  // a slot: a halo group (8 columns of a channel pair's row, 8 words) or
  // a halo edge (one column: words 0, 1 the two channels' bits)
  uint32_t gx[Tl::SLOTS][8];
  int gm[Tl::SLOTS];  // mode | group: valid columns << 3; edge: channel c
                      // in bounds << 3 | c + 1 << 4 | halo column << 5

  // chunk k of a tile: the halo into registers, the weights by cp.async
  // into buffer buf; no wait on either here
  auto load = [&](int tile, int k, int buf) {
    int b, oh0, ow0;
    origin(tile, b, oh0, ow0);
    const int h0 = oh0 - 1 - off;  // input row of halo row 0
    const int w0 = ow0 - 1 - off;  // input column of halo column 0
#pragma unroll
    for (int s = 0; s < Tl::SLOTS; ++s) {
      const int e = tid + s * Tl::THREADS;
      gm[s] = BF_NONE;
      if (e >= Tl::GROUPS + Tl::EDGES) continue;
      if (e >= Tl::GROUPS) {
        const int d = e - Tl::GROUPS;
        const int cp = d / (FWD_HALO_H * 2);
        const int rem = d - cp * (FWD_HALO_H * 2);
        const int r = rem >> 1, side = rem & 1;
        const int c = k * BF_CI + 2 * cp;
        // off 0: columns ow0 - 1 and ow0 + 32 (the reflect pad: column W
        // where it lies inside the tile); off 1: ow0 - 2 and ow0 - 1
        const int q = off ? side
                          : (side == 0 ? 0
                                       : (in.reflect ? min(HALO_W - 1, W - w0)
                                                     : HALO_W - 1));
        const bf16* p0 = halo_src(in, b, c, h0 + r, w0 + q);
        const bf16* p1 = halo_src(in, b, c + 1, h0 + r, w0 + q);
        gx[s][0] = p0 ? ldg_bits(p0) : 0u;
        gx[s][1] = p1 ? ldg_bits(p1) : 0u;
        gm[s] = BF_EDGE | (p0 != nullptr) << 3 | (p1 != nullptr) << 4 |
                q << 5;
        continue;
      }
      const int cp = e / (FWD_HALO_H * 4);
      const int rem = e - cp * (FWD_HALO_H * 4);
      const int r = rem >> 2, j = rem & 3;
      const int c = k * BF_CI + 2 * cp;
      const int hr = h0 + r;
      const int col0 = ow0 + 8 * j;
      const int n = min(max(W - col0, 0), 8);
      int hm = hr;
      if (in.reflect) hm = hr < 0 ? -hr : (hr >= H ? 2 * H - 2 - hr : hr);
      int mode;
      if (c >= Ci || hm < 0 || hm >= H || n == 0) {
        mode = BF_ZERO;
      } else if (va >= 2) {  // each channel from its own tensor, or 0
        ldg_cols(gx[s], halo_src(in, b, c, hr, col0), n, va);
        if (c + 1 < Ci) {
          ldg_cols(gx[s] + 4, halo_src(in, b, c + 1, hr, col0), n, va);
        } else {
#pragma unroll
          for (int i = 4; i < 8; ++i) gx[s][i] = 0u;
        }
        mode = BF_RAW;
      } else {  // per element, from the two channels' rows
        const bf16* r0 = halo_src(in, b, c, hr, 0);
        const bf16* r1 = halo_src(in, b, c + 1, hr, 0);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          gx[s][i] = bf_row_tap(in, r0, c, col0 + i) |
                     bf_row_tap(in, r1, c + 1, col0 + i) << 16;
        mode = BF_PACKED;
      }
      gm[s] = mode | n << 3;
    }
    uint32_t* const ws = ws0 + buf * Tl::WS;
#pragma unroll
    for (int s = 0; s < Tl::WSLOTS; ++s) {
      const int e = tid + s * Tl::THREADS;
      if (e >= Tl::WCOPIES) continue;
      const int row = e >> 1;  // (tap, n)
      const int tap = row / NT, n = row - tap * NT;
      cp_async_bf<16>(ws + row * BF_WROW + (e & 1) * 4,
                      wp + (((long long)k * 9 + tap) * co_pad + co0 + n) *
                               BF_CI + (e & 1) * 8,
                      true);
    }
    cp_async_commit();
  };

  // the halo registers of chunk k into buffer buf: interleaved, act
  // applied
  auto store = [&](int k, int buf) {
    uint32_t* const xs = xs0 + buf * Tl::XS;
#pragma unroll
    for (int s = 0; s < Tl::SLOTS; ++s) {
      const int mode = gm[s] & 7;
      if (mode == BF_NONE) continue;
      const int e = tid + s * Tl::THREADS;
      if (mode == BF_EDGE) {
        const int d = e - Tl::GROUPS;
        const int cp = d / (FWD_HALO_H * 2);
        const int r = (d - cp * (FWD_HALO_H * 2)) >> 1;
        const int c = k * BF_CI + 2 * cp;
        uint32_t v0 = gx[s][0], v1 = gx[s][1];
        if (in.scale) {
          if (gm[s] & 8)
            v0 = act_bits(v0, ldg_f(in.scale + c), ldg_f(in.shift + c));
          if (gm[s] & 16)
            v1 = act_bits(v1, ldg_f(in.scale + c + 1),
                          ldg_f(in.shift + c + 1));
        }
        xs[cp * BF_PLANE + r * BF_ROW + qoff + (gm[s] >> 5)] = v0 | v1 << 16;
        continue;
      }
      const int n = gm[s] >> 3;
      const int cp = e / (FWD_HALO_H * 4);
      const int rem = e - cp * (FWD_HALO_H * 4);
      const int r = rem >> 2, j = rem & 3;
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (mode == BF_RAW)  // column i of channels c (low) and c + 1
          v[i] = __byte_perm(gx[s][i / 2], gx[s][4 + i / 2],
                             i % 2 ? 0x7632 : 0x5410);
        else
          v[i] = mode == BF_ZERO ? 0u : gx[s][i];
      }
      if (mode == BF_RAW && in.scale) {
        const int c = k * BF_CI + 2 * cp;
        const bool c1 = c + 1 < Ci;  // else channel c + 1 stays 0
        const float s0 = ldg_f(in.scale + c), t0 = ldg_f(in.shift + c);
        const float s1 = c1 ? ldg_f(in.scale + c + 1) : 0.f;
        const float t1 = c1 ? ldg_f(in.shift + c + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < n)  // the zero pad past W stays 0
            v[i] = act_bits(v[i] & 0xffffu, s0, t0) |
                   (c1 ? act_bits(v[i] >> 16, s1, t1) : 0u) << 16;
      }
      // reflect: only the columns left of W (the edge item writes column
      // W; those right of it feed outputs that are not stored)
      const int nst = in.reflect ? n : 8;
      uint32_t* const dst = xs + cp * BF_PLANE + r * BF_ROW + 4 + 8 * j;
      if (nst == 8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 4) =
            make_uint4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < nst) dst[i] = v[i];
      }
    }
  };

  constexpr int NW = Tl::NW;
  float acc[2][NW / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // the row lane gives ldmatrix: x4 loads (n-tile j, k 0-7), (j, k 8-15),
  // (j + 1, k 0-7), (j + 1, k 8-15) of the warp's channels; x2 (NW = 8)
  // the first two
  const int wl = NW >= 16 ? lane : (lane & 15);
  const uint32_t wrow = ((wn * NW + (wl >> 4) * 8 + (wl & 7)) * BF_WROW +
                         ((wl >> 3) & 1) * 4) * 4;

  // C (16 x 8): c0, c1 at row gq, columns 2t, 2t + 1; c2, c3 at row gq + 8
  auto epilogue = [&](int tile) {
    int b, oh0, ow0;
    origin(tile, b, oh0, ow0);
    const int oh = oh0 + row;
    const long long HWo = (long long)Ho * Wo;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ow = ow0 + m * 16 + gq + (i >= 2 ? 8 : 0);
          const int co = co0 + wn * NW + n * 8 + 2 * t + (i & 1);
          if (oh < Ho && ow < Wo && co < Co) {
            float v = acc[m][n][i];
            if (bias) v += __ldg(bias + co);
            if (elu) v = v > 0.f ? v : expm1f(v);
            // float32 out: the reflect dgrad (off = 1), position (h, w)
            const int h = oh - 1, w = ow - 1, H = Ho - 2, W = Wo - 2;
            if (is_f32<TO>() && h != -1 && h != 1 && h != H - 2 && h != H &&
                w != -1 && w != 1 && w != W - 2 && w != W) {
              const long long HW = (long long)H * W;
              bf16* const dx =
                  co < fold.C0
                      ? fold.dx0 + ((long long)b * fold.C0 + co) * HW
                      : fold.dx1 + ((long long)b * (Co - fold.C0) +
                                    (co - fold.C0)) * HW;
              st_f(dx + (long long)h * W + w, v);
            } else {
              st_f(y + ((long long)b * Co + co) * HWo + (long long)oh * Wo +
                       ow, v);
            }
          }
          acc[m][n][i] = 0.f;
        }
  };

  int tile = blockIdx.x, k = 0, buf = 0;
  load(tile, 0, 0);
  store(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (;;) {
    // the next (tile, chunk): in flight during this chunk's MMAs
    int nk = k + 1, ntile = tile;
    if (nk == chunks) nk = 0, ntile += gridDim.x;
    const bool more = ntile < n_tiles;
    if (more) load(ntile, nk, buf ^ 1);
    const uint32_t* const xw =
        xs0 + buf * Tl::XS + row * BF_ROW + qoff + gq + t * BF_PLANE;
    const uint32_t wsa =
        (uint32_t)__cvta_generic_to_shared(ws0 + buf * Tl::WS) + wrow;
    // not unrolled: fragments of later taps are not hoisted into
    // registers (which spills at the 128 of 16 warps an SM)
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - 3 * ky;
      // A (16 pixels x 16 channels): pixels gq, gq + 8 of tile m; channel
      // pairs t, t + 4
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t* p = xw + ky * BF_ROW + kx + m * 16;
        a[m][0] = p[0];
        a[m][1] = p[8];
        a[m][2] = p[4 * BF_PLANE];
        a[m][3] = p[4 * BF_PLANE + 8];
      }
#pragma unroll
      for (int j = 0; j < (NW >= 16 ? NW / 16 : 1); ++j) {
        uint32_t bq[4];
        const uint32_t addr = wsa + (tap * NT + j * 16) * BF_WROW * 4;
        if constexpr (NW >= 16)
          ldmatrix_x4(bq, addr);
        else
          ldmatrix_x2(bq, addr);
#pragma unroll
        for (int h = 0; h < (NW >= 16 ? 2 : 1); ++h)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // the tap's 16 products start from 0; one fp32 add each
            float d[4];
            mma_bf16_zero(d, a[m], bq + 2 * h);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][2 * j + h][i] += d[i];
          }
      }
    }
    if (nk == 0) epilogue(tile);  // the tile's last chunk
    if (more) {
      store(nk, buf ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();  // buf ^ 1 is read next; buf is written after that
    if (!more) break;
    tile = ntile, k = nk, buf ^= 1;
  }
}

// The columns of a bf16 load that every row of W columns from p (and q)
// keeps aligned: 8, 4 or 2 where W is a multiple of it and the pointers
// are aligned to it; 1 (per-element loads) otherwise.
inline int bf_vec(int W, const void* p, const void* q) {
  for (int v = 8; v >= 2; v /= 2)
    if (W % v == 0 && (uintptr_t)p % (2 * v) == 0 &&
        (!q || (uintptr_t)q % (2 * v) == 0))
      return v;
  return 1;
}

template <typename TO, int NT>
int launch_fwd_bf16(const Input<bf16>& in, const bf16* w, bf16* wp,
                    const float* bias, TO* y, int B, int off, int Co,
                    int elu, cudaStream_t s, const FoldOut& fold) {
  const int Ci = in.C0 + in.C1;
  const int co_pad = (Co + BF_CO_PAD - 1) / BF_CO_PAD * BF_CO_PAD;
  const long long n = (long long)(Ci + BF_CI - 1) / BF_CI * 9 * co_pad * BF_CI;
  pack_weights_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      w, wp, Co, Ci, co_pad, n);
  const int Ho = in.H + 2 * off;
  const int Wo = in.W + 2 * off;
  const int tiles_w = (Wo + TW - 1) / TW;
  const int tiles_img = tiles_w * ((Ho + FWD_TH - 1) / FWD_TH);
  const int n_tiles = tiles_img * B;
  constexpr int bytes = BfFwdTile<NT>::BYTES;
  constexpr int threads = BfFwdTile<NT>::THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fwd_bf16_kernel<TO, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // one wave: as many blocks as the SMs hold, walking the tiles
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3x3_fwd_bf16_kernel<TO, NT>, threads, bytes)) !=
          cudaSuccess)
    return (int)err;
  const int co_blocks = (Co + NT - 1) / NT;
  const int slots = max(1, (sms * per_sm + co_blocks - 1) / co_blocks);
  const dim3 grid(min(n_tiles, slots), co_blocks);
  const int va = bf_vec(in.W, in.x0, in.x1);
  conv3x3_fwd_bf16_kernel<TO, NT><<<grid, threads, bytes, s>>>(
      in, wp, bias, y, Ho, Wo, off, Co, co_pad, tiles_w, tiles_img, n_tiles,
      elu, va, fold);
  return (int)cudaGetLastError();
}


// wp: the bf16 entries' packed-weight scratch, fold the bf16 reflect
// dgrad's outputs (both unused by float32)
template <typename T, typename TO, int NT>
int launch_fwd(const Input<T>& in, const T* w, T* wp, const float* bias,
               TO* y, int B, int off, int Co, int elu, cudaStream_t s,
               const FoldOut& fold) {
  if constexpr (!is_f32<T>()) {
    return launch_fwd_bf16<TO, NT>(in, w, wp, bias, y, B, off, Co, elu, s,
                                   fold);
  } else {
    const int Ho = in.H + 2 * off;
    const int Wo = in.W + 2 * off;
    const int tiles_w = (Wo + TW - 1) / TW;
    const int tiles = tiles_w * ((Ho + FWD_TH - 1) / FWD_TH);
    constexpr int bytes = FwdTile<NT>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_fwd_kernel<T, TO, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(tiles, (Co + NT - 1) / NT, B);
    // 16-byte copies of the weights when every row of 9 Ci floats is
    // 16-byte aligned
    const int wvec = (in.C0 + in.C1) % 4 == 0 && (uintptr_t)w % 16 == 0;
    conv3x3_fwd_kernel<T, TO, NT><<<grid, FWD_THREADS, bytes, s>>>(
        in, w, bias, y, Ho, Wo, off, Co, tiles_w, elu, wvec);
    return (int)cudaGetLastError();
  }
}

// Output (B, Co, H + 2 off, W + 2 off); off = 1 only with zero pad. nt: the
// N tile, from kernels/conv3x3.py::conv_tiles.
template <typename T, typename TO>
int run_fwd(const Input<T>& in, const T* w, void* wp, const float* bias,
            TO* y, int B, int off, int Co, int elu, int nt, void* stream,
            const FoldOut& fold = {nullptr, nullptr, 0}) {
  cudaStream_t s = (cudaStream_t)stream;
  T* const p = (T*)wp;
  switch (nt) {
    case 8:
      return launch_fwd<T, TO, 8>(in, w, p, bias, y, B, off, Co, elu, s,
                                  fold);
    case 16:
      return launch_fwd<T, TO, 16>(in, w, p, bias, y, B, off, Co, elu, s,
                                   fold);
    case 32:
      return launch_fwd<T, TO, 32>(in, w, p, bias, y, B, off, Co, elu, s,
                                   fold);
    case 64:
      return launch_fwd<T, TO, 64>(in, w, p, bias, y, B, off, Co, elu, s,
                                   fold);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Adjoint of ReflectionPad2d(1) with the channel split: dxp (B, C0 + C1,
// H + 2, W + 2) over padded positions -1..H, -1..W -> dx0 (B, C0, H, W),
// dx1 (B, C1, H, W). Additions in the order of the plain version
// (kernels/conv3x3.py::reflect_pad_adjoint): rows, then columns. The sums
// are float32 (the bf16 dgrad has reflect_fold_border_bf16_kernel).
template <typename TO>
__global__ void reflect_fold_kernel(const float* __restrict__ dxp,
                                    TO* __restrict__ dx0, int C0,
                                    TO* __restrict__ dx1, int C1, int H,
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
    st_f(dx0 + (b * C0 + c) * HW + (long long)h * W + w, v);
  else
    st_f(dx1 + (b * C1 + (c - C0)) * HW + (long long)h * W + w, v);
}

// The bf16 reflect dgrad's adjoint of ReflectionPad2d(1) on the pixels
// that take more than their own sum: rows 1 and H - 2, columns 1 and W - 2
// (the forward kernel stored every other pixel; FoldOut). reflect_fold_
// kernel's sums in its order; one (image, channel) plane a block, whose
// threads walk the 2 (W + H) pixels of those rows, then those columns (a
// pixel on both is written twice, with the same value).
__global__ void reflect_fold_border_bf16_kernel(const float* __restrict__ dxp,
                                                bf16* __restrict__ dx0,
                                                int C0,
                                                bf16* __restrict__ dx1,
                                                int C1, int H, int W) {
  const int Ci = C0 + C1;
  const int c = (int)(blockIdx.x % Ci);
  const long long b = blockIdx.x / Ci;
  const int Wp = W + 2;
  const float* p = dxp + (long long)blockIdx.x * (H + 2) * Wp;
  bf16* const out = c < C0 ? dx0 + (b * C0 + c) * H * W
                           : dx1 + (b * C1 + (c - C0)) * H * W;
  for (int k = threadIdx.x; k < 2 * (W + H); k += blockDim.x) {
    int h, w;
    if (k < 2 * W) {
      h = k < W ? 1 : H - 2;
      w = k < W ? k : k - W;
    } else {
      w = k < 2 * W + H ? 1 : W - 2;
      h = k < 2 * W + H ? k - 2 * W : k - 2 * W - H;
    }
    auto row = [&](int q) {
      float v = __ldg(p + (long long)(h + 1) * Wp + q);
      if (h == 1) v += __ldg(p + q);
      if (h == H - 2) v += __ldg(p + (long long)(H + 1) * Wp + q);
      return v;
    };
    float v = row(w + 1);
    if (w == 1) v += row(0);
    if (w == W - 2) v += row(W + 1);
    st_f(out + (long long)h * W + w, v);
  }
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
// tiles (2 x 32) of split blockIdx.y. T is float (the bf16 entry point
// has conv3x3_wgrad_bf16_kernel).
template <typename T, int MW>
__global__ void __launch_bounds__(WG_THREADS)
conv3x3_wgrad_kernel(Input<T> in, const T* __restrict__ g,  // (B, Co, H, W)
                     float* __restrict__ part,  // (splits, Co, Ci, 9)
                     int Co, int ci_tiles, int tiles_w, int tiles_img,
                     int n_tiles, int per_split, int vec) {
  using Tl = WgTile<MW>;
  constexpr int PX = WG_TH * TW;  // pixels per tile
  extern __shared__ float smem[];
  float* const gs0 = smem;              // + buf * GS
  float* const xs0 = smem + 2 * Tl::GS;  // + buf * XS

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / Tl::NWB;
  const int wn = warp % Tl::NWB;
  const int co0 = (blockIdx.x / ci_tiles) * Tl::CO_T;
  const int ci0 = (blockIdx.x % ci_tiles) * Tl::CI_TW;
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
    float* gs = gs0 + buf * Tl::GS;
    if (vec) {  // 16-byte copies: W % 4 == 0, so a group is in or out
      for (int e = threadIdx.x; e < Tl::CO_T * PX / 4; e += WG_THREADS) {
        const int k = e / (PX / 4);
        const int p = (e - k * (PX / 4)) * 4;
        const int r = p / TW;
        const int co = co0 + k;
        const int h = oh0 + r;
        const int x = ow0 + p - r * TW;
        const bool ok = co < Co && h < H && x < W;
        cp_async16(gs + k * WG_GS + p,
                   ok ? (const float*)g + ((b * Co + co) * H + h) *
                                              (long long)W + x
                      : (const float*)g,
                   ok);
      }
    } else {
      for (int e = threadIdx.x; e < Tl::CO_T * PX; e += WG_THREADS) {
        const int k = e / PX;
        const int p = e - k * PX;
        const int r = p / TW;
        const int co = co0 + k;
        const int h = oh0 + r;
        const int x = ow0 + p - r * TW;
        const bool ok = co < Co && h < H && x < W;
        cp_async4(gs + k * WG_GS + p,
                  ok ? (const float*)g + ((b * Co + co) * H + h) *
                                             (long long)W + x
                     : (const float*)g,
                  ok);
      }
    }
    stage_halo<T, Tl::CI_TW, WG_CS, WG_HALO_H, WG_THREADS>(
        xs0 + buf * Tl::XS, in, b, ci0, oh0 - 1, ow0 - 1);
    cp_async_commit();
  };

  float acc[Tl::WMT][9][4];
#pragma unroll
  for (int m = 0; m < Tl::WMT; ++m)
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
    float* const xs = xs0 + buf * Tl::XS;
    {
      long long b;
      int oh0, ow0;
      origin(tile, b, oh0, ow0);
      split_halo<T, Tl::CI_TW, WG_CS, WG_HALO_H, WG_THREADS>(
          xs, xs + Tl::CI_TW * WG_CS, in, b, ci0, oh0 - 1, ow0 - 1);
    }
    __syncthreads();

    // this tile's sums start from 0 and join acc by an fp32 add (see the
    // forward)
    float part[Tl::WMT][9][4];
#pragma unroll
    for (int m = 0; m < Tl::WMT; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[m][k][i] = 0.f;
    // A (16 channels x 8 pixels): rows gq, gq + 8; columns t, t + 4
    const float* ga =
        gs0 + buf * Tl::GS + (wm * Tl::WMT * 16 + gq) * WG_GS + t;
    // B (8 pixels x 8 channels): rows t, t + 4; column gq; split at staging
    const float* xb = xs + (wn * 8 + gq) * WG_CS + t;
#pragma unroll 2
    for (int j = 0; j < PX / 8; ++j) {
      const int r = j / (TW / 8);
      const int q0 = (j % (TW / 8)) * 8;
      uint32_t ab[Tl::WMT][4], as[Tl::WMT][4], bb[9][2], bs[9][2];
#pragma unroll
      for (int m = 0; m < Tl::WMT; ++m) {
        const float* p = ga + m * 16 * WG_GS + j * 8;
        split3(p[0], ab[m][0], as[m][0]);
        split3(p[8 * WG_GS], ab[m][1], as[m][1]);
        split3(p[4], ab[m][2], as[m][2]);
        split3(p[8 * WG_GS + 4], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* p = xb + (r + tap / 3) * HALO_W + q0 + tap % 3;
        const float* ps = p + Tl::CI_TW * WG_CS;
        bb[tap][0] = __float_as_uint(p[0]);
        bb[tap][1] = __float_as_uint(p[4]);
        bs[tap][0] = __float_as_uint(ps[0]);
        bs[tap][1] = __float_as_uint(ps[4]);
      }
      // pass by pass: no product waits on the one before it
#pragma unroll
      for (int m = 0; m < Tl::WMT; ++m)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tf32(part[m][tap], as[m], bb[tap]);
#pragma unroll
      for (int m = 0; m < Tl::WMT; ++m)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tf32(part[m][tap], ab[m], bs[tap]);
#pragma unroll
      for (int m = 0; m < Tl::WMT; ++m)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tf32(part[m][tap], ab[m], bb[tap]);
    }
#pragma unroll
    for (int m = 0; m < Tl::WMT; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][k][i] += part[m][k][i];
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

  // C (16 x 8): c0, c1 at row gq, columns 2t, 2t + 1; c2, c3 at row gq + 8
#pragma unroll
  for (int m = 0; m < Tl::WMT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + (wm * Tl::WMT + m) * 16 + gq + (i >= 2 ? 8 : 0);
      const int ci = ci0 + wn * 8 + 2 * t + (i & 1);
      if (co < Co && ci < Ci) {
        float* out = part + (((long long)split * Co + co) * Ci + ci) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) out[tap] = acc[m][tap][i];
      }
    }
}

// dw[i] = sum over splits s, in order, of part[s][i] (rounded once to a
// bf16 dw).
template <typename TO>
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  TO* __restrict__ dw, int splits,
                                  long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += __ldg(part + s * n + i);
  st_f(dw + i, v);
}

// ---- bfloat16 wgrad ----

// The 8 halo columns col0.. of one row into dst, in copies of V columns
// from p (column col0 of the row, null when col0 >= W): a copy inside the
// row, else zeros from `any` (nothing read); the reflect pad's column W
// is left to the thread that writes it.
template <int V>
__device__ __forceinline__ void copy_cols(bf16* dst, const bf16* p,
                                          const bf16* any, int col0, int W,
                                          int reflect) {
#pragma unroll
  for (int i = 0; i < 8 / V; ++i) {
    const int start = col0 + i * V;
    if (start + V <= W)
      cp_async_bf<2 * V>(dst + i * V, p + i * V, true);
    else if (!(reflect && start == W))
      cp_async_bf<2 * V>(dst + i * V, any, false);
  }
}

// The block's output channel tile is 16 MW, as in WgTile, but a warp owns
// one m16 tile (36 accumulators): the block's 4 warps are MW along the
// output and 4 / MW along the input channels, 8 input channels and their
// 9 taps a warp. <= 128 registers, four blocks an SM.
template <int MW>
struct BfWgTile {
  static constexpr int CO_T = 16 * MW;
  static constexpr int NWB = 4 / MW;
  static constexpr int CI_TW = 8 * NWB;  // 32, 16, 8
  static constexpr int GS = CO_T * BG_STR;  // bf16 a stage
  static constexpr int XS = CI_TW * BX_PLANE;
  static constexpr int STAGE = GS + XS;
  static constexpr int BYTES = WG_STAGES * STAGE * 2;
  // what a thread stages: cotangent groups (co, row, 8 pixels), halo
  // groups (ci, row, 8 columns), halo edges (ci, row)
  static constexpr int GSLOTS = CO_T * WG_TH * 4 / WG_THREADS;
  static constexpr int XSLOTS = CI_TW * WG_HALO_H * 4 / WG_THREADS;
  static constexpr int EDGES = CI_TW * WG_HALO_H;
};
static_assert(BfWgTile<1>::EDGES <= WG_THREADS &&
              BfWgTile<4>::XSLOTS * WG_THREADS ==
                  BfWgTile<4>::CI_TW * WG_HALO_H * 4, "wgrad staging");

// Partial weight gradient of one (CO_T, CI_TW) tile over the run of pixel
// tiles (2 x 32) of split blockIdx.y, as conv3x3_wgrad_kernel's. vg, vx:
// the columns a cotangent and a halo copy take (bf_vec).
template <int MW>
__global__ void __launch_bounds__(WG_THREADS, 4)
conv3x3_wgrad_bf16_kernel(Input<bf16> in, const bf16* __restrict__ g,
                          float* __restrict__ part, int Co, int ci_tiles,
                          int tiles_w, int tiles_img, int n_tiles,
                          int per_split, int vg, int vx) {
  using Tl = BfWgTile<MW>;
  extern __shared__ uint4 bf_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(bf_smem);  // + stage STAGE

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / Tl::NWB;
  const int wn = warp % Tl::NWB;
  const int co0 = (blockIdx.x / ci_tiles) * Tl::CO_T;
  const int ci0 = (blockIdx.x % ci_tiles) * Tl::CI_TW;
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
  uint32_t ex[3];
  int em;  // 1 | left in bounds << 1 | right << 2 | column W item << 3

  // the copies of a tile into stage st; the edges into registers
  auto fetch = [&](int tile, int st) {
    long long b;
    int oh0, ow0;
    origin(tile, b, oh0, ow0);
    bf16* const gs = sm + st * Tl::STAGE;
    bf16* const xs = gs + Tl::GS;
#pragma unroll
    for (int s = 0; s < Tl::GSLOTS; ++s) {
      const int e = tid + s * WG_THREADS;
      const int k = e >> 3, r = (e >> 2) & 1, j = e & 3;
      const int co = co0 + k, h = oh0 + r, col0 = ow0 + 8 * j;
      const int n = co < Co && h < H ? min(max(W - col0, 0), 8) : 0;
      bf16* const dst = gs + k * BG_STR + r * TW + 8 * j;
      const bf16* src =
          n ? g + ((b * Co + co) * H + h) * (long long)W + col0 : g;
      if (vg == 8) {
        cp_async_bf<16>(dst, src, n == 8);
      } else if (vg == 4) {
        cp_async_bf<8>(dst, src, n >= 4);
        cp_async_bf<8>(dst + 4, src + 4, n >= 8);
      } else if (vg == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async_bf<4>(dst + 2 * i, src + 2 * i, 2 * i < n);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          reinterpret_cast<unsigned short*>(dst)[i] =
              i < n ? (unsigned short)ldg_bits(src + i) : (unsigned short)0;
      }
    }
#pragma unroll
    for (int s = 0; s < Tl::XSLOTS; ++s) {
      const int e = tid + s * WG_THREADS;
      const int k = e >> 4, r = (e >> 2) & 3, j = e & 3;
      const int c = ci0 + k, hr = oh0 - 1 + r, col0 = ow0 + 8 * j;
      int hm = hr;
      if (in.reflect) hm = hr < 0 ? -hr : (hr >= H ? 2 * H - 2 - hr : hr);
      bf16* const dst = xs + k * BX_PLANE + r * BX_ROW + 8 + 8 * j;
      if (c >= Ci || hm < 0 || hm >= H) {
        cp_async_bf<16>(dst, g, false);
      } else if (vx >= 2) {
        const bf16* p = col0 < W ? halo_src(in, b, c, hr, col0) : nullptr;
        if (vx == 8)
          copy_cols<8>(dst, p, g, col0, W, in.reflect);
        else if (vx == 4)
          copy_cols<4>(dst, p, g, col0, W, in.reflect);
        else
          copy_cols<2>(dst, p, g, col0, W, in.reflect);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          reinterpret_cast<unsigned short*>(dst)[i] =
              (unsigned short)bf_tap(in, b, c, hr, col0 + i);
      }
    }
    cp_async_commit();
    em = 0;
    if (tid < Tl::EDGES) {
      const int c = ci0 + (tid >> 2), hr = oh0 - 1 + (tid & 3);
      const bf16* pl = halo_src(in, b, c, hr, ow0 - 1);
      const bf16* pr = halo_src(in, b, c, hr, ow0 + TW);
      ex[0] = pl ? ldg_bits(pl) : 0u;
      ex[1] = pr ? ldg_bits(pr) : 0u;
      em = 1 | (pl != nullptr) << 1 | (pr != nullptr) << 2;
      if (in.reflect && vx >= 2 && W < ow0 + TW) {
        const bf16* pw = halo_src(in, b, c, hr, W);
        ex[2] = pw ? ldg_bits(pw) : 0u;
        em |= 8;
      }
    }
  };

  // once this thread's copies of the tile in stage st have landed: the
  // edges, and the act prologue on the values it copied
  auto finish = [&](int tile, int st) {
    long long b;
    int oh0, ow0;
    origin(tile, b, oh0, ow0);
    bf16* const xs = sm + st * Tl::STAGE + Tl::GS;
    if (em & 1) {
      const int k = tid >> 2;
      const int c = ci0 + k;
      unsigned short* const row = reinterpret_cast<unsigned short*>(
          xs + k * BX_PLANE + (tid & 3) * BX_ROW);
      uint32_t l = ex[0], r = ex[1];
      if (in.scale) {
        const float s = ldg_f(in.scale + c), sh = ldg_f(in.shift + c);
        if (em & 2) l = act_bits(l, s, sh);
        if (em & 4) r = act_bits(r, s, sh);
      }
      row[7] = (unsigned short)l;
      row[8 + TW] = (unsigned short)r;
      if (em & 8) {  // the reflect pad's column W, then zeros
        unsigned short* const pw = row + 8 + (W - ow0);
        if (vx == 8)
          *reinterpret_cast<uint4*>(pw) = make_uint4(ex[2], 0, 0, 0);
        else if (vx == 4)
          *reinterpret_cast<uint2*>(pw) = make_uint2(ex[2], 0);
        else
          *reinterpret_cast<uint32_t*>(pw) = ex[2];
      }
    }
    if (!in.scale || vx < 2) return;  // per-element loads took the act
#pragma unroll
    for (int s = 0; s < Tl::XSLOTS; ++s) {
      const int e = tid + s * WG_THREADS;
      const int k = e >> 4, r = (e >> 2) & 3, j = e & 3;
      const int c = ci0 + k, h = oh0 - 1 + r, col0 = ow0 + 8 * j;
      const int n = min(max(W - col0, 0), 8);
      if (c >= Ci || h < 0 || h >= H || n == 0) continue;
      const float sc = ldg_f(in.scale + c), sh = ldg_f(in.shift + c);
      uint4* const p =
          reinterpret_cast<uint4*>(xs + k * BX_PLANE + r * BX_ROW + 8 + 8 * j);
      uint4 q = *p;
      uint32_t v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // columns past W stay 0
        const uint32_t lo = 2 * i < n ? act_bits(v[i] & 0xffffu, sc, sh) : 0u;
        const uint32_t hi =
            2 * i + 1 < n ? act_bits(v[i] >> 16, sc, sh) : 0u;
        v[i] = lo | hi << 16;
      }
      *p = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;

  // the row lane gives ldmatrix for A: (co 0-7, px 0-7), (co 8-15, px
  // 0-7), (co 0-7, px 8-15), (co 8-15, px 8-15) of the warp's m16 tile
  const uint32_t arow =
      ((wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * BG_STR +
       (lane >> 4) * 8) * 2;

  if (t_begin < t_end) {
    fetch(t_begin, 0);
    cp_async_wait_all();
    finish(t_begin, 0);
    if (t_begin + 1 < t_end) fetch(t_begin + 1, 1);
    __syncthreads();
  }
  int st = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const bf16* const gs = sm + st * Tl::STAGE;
    const uint32_t ga = (uint32_t)__cvta_generic_to_shared(gs) + arow;
    // B (16 pixels x 8 channels): lane (gq, t) reads channel wn 8 + gq
    const uint32_t* const xb =
        reinterpret_cast<const uint32_t*>(gs + Tl::GS) +
        (wn * 8 + gq) * (BX_PLANE / 2) + t;
#pragma unroll
    for (int s = 0; s < WG_TH * TW / 16; ++s) {
      const int r = s / (TW / 16), q0 = (s % (TW / 16)) * 16;
      uint32_t a[4];
      ldmatrix_x4(a, ga + (r * TW + q0) * 2);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // words 3 + i of the row from pixel q0 + 2t: word 4 holds
        // columns (q0 + 2t, q0 + 2t + 1), the pair of kx = 1; kx = 0 and
        // 2 take the halves across words 3 | 4 and 4 | 5 (b1: + 8 pixels)
        const uint32_t* p = xb + (r + ky) * (BX_ROW / 2) + q0 / 2;
        const uint32_t w3 = p[3], w4 = p[4], w5 = p[5];
        const uint32_t w7 = p[7], w8 = p[8], w9 = p[9];
        const uint32_t bk[3][2] = {
            {__byte_perm(w3, w4, 0x5432), __byte_perm(w7, w8, 0x5432)},
            {w4, w8},
            {__byte_perm(w4, w5, 0x5432), __byte_perm(w8, w9, 0x5432)}};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // the 16 pixels' products start from 0; one fp32 add each
          float d[4];
          mma_bf16_zero(d, a, bk[kx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[ky * 3 + kx][i] += d[i];
        }
      }
    }
    const int s1 = st == WG_STAGES - 1 ? 0 : st + 1;
    const int s2 = s1 == WG_STAGES - 1 ? 0 : s1 + 1;
    if (tile + 1 < t_end) {
      cp_async_wait_all();
      finish(tile + 1, s1);
    }
    if (tile + 2 < t_end) fetch(tile + 2, s2);  // lands during tile + 1
    __syncthreads();
    st = s1;
  }

  // C (16 x 8): c0, c1 at row gq, columns 2t, 2t + 1; c2, c3 at row gq + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + wm * 16 + gq + (i >= 2 ? 8 : 0);
    const int ci = ci0 + wn * 8 + 2 * t + (i & 1);
    if (co < Co && ci < Ci) {
      float* out = part + (((long long)split * Co + co) * Ci + ci) * 9;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) out[tap] = acc[tap][i];
    }
  }
}

template <typename TI, int MW>
int launch_wgrad(const Input<TI>& in, const TI* g, float* part, int B,
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
  if constexpr (!is_f32<TI>()) {
    using BT = BfWgTile<MW>;
    const int bf_ci_tiles = (in.C0 + in.C1 + BT::CI_TW - 1) / BT::CI_TW;
    constexpr int bytes = BT::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgrad_bf16_kernel<MW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    conv3x3_wgrad_bf16_kernel<MW>
        <<<dim3(co_tiles * bf_ci_tiles, splits), WG_THREADS, bytes, s>>>(
            in, g, part, Co, bf_ci_tiles, tiles_w, tiles_img, n_tiles,
            per_split, bf_vec(in.W, g, nullptr),
            bf_vec(in.W, in.x0, in.x1));
    return (int)cudaGetLastError();
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgrad_kernel<TI, MW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(co_tiles * ci_tiles, splits);
    // 16-byte copies of the cotangent when its rows are 16-byte aligned
    const int vec = in.W % 4 == 0 && (uintptr_t)g % 16 == 0;
    conv3x3_wgrad_kernel<TI, MW><<<grid, WG_THREADS, T::BYTES, s>>>(
        in, g, part, Co, ci_tiles, tiles_w, tiles_img, n_tiles, per_split,
        vec);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int reflect_fwd(const void* x0, int C0, const void* x1, int C1,
                const void* w, const void* bias, void* y, int B, int H,
                int W, int Co, int elu, int nt, void* stream, void* wp) {
  const Input<T> in{(const T*)x0, (const T*)x1, nullptr, nullptr,
                    C0, C1, H, W, /*reflect=*/1};
  return run_fwd<T, T>(in, (const T*)w, wp, (const float*)bias, (T*)y, B,
                       /*off=*/0, Co, elu, nt, stream);
}

template <typename T>
int zero_act_fwd(const void* x, int C, const void* w, const void* scale,
                 const void* shift, void* y, int B, int H, int W, int Co,
                 int nt, void* stream, void* wp) {
  const Input<T> in{(const T*)x, nullptr, (const T*)scale, (const T*)shift,
                    C, 0, H, W, /*reflect=*/0};
  return run_fwd<T, T>(in, (const T*)w, wp, nullptr, (T*)y, B, /*off=*/0,
                       Co, /*elu=*/0, nt, stream);
}

template <typename T>
int dgrad(const void* g, int Co, const void* wt, void* dxp, void* dx0,
          int C0, void* dx1, int C1, int B, int H, int W, int reflect,
          int nt, void* stream, void* wp) {
  const int Ci = C0 + C1;
  const Input<T> in{(const T*)g, nullptr, nullptr, nullptr, Co, 0, H, W,
                    /*reflect=*/0};
  if (!reflect)
    return run_fwd<T, T>(in, (const T*)wt, wp, nullptr, (T*)dx0, B,
                         /*off=*/0, Ci, /*elu=*/0, nt, stream);
  // the padded-domain sums stay float32 for the fold (dxp is float32); in
  // bf16 only those that fold (FoldOut)
  int err = run_fwd<T, float>(in, (const T*)wt, wp, nullptr, (float*)dxp, B,
                              /*off=*/1, Ci, /*elu=*/0, nt, stream,
                              {(bf16*)dx0, (bf16*)dx1, C0});
  if (err) return err;
  if constexpr (!is_f32<T>()) {
    reflect_fold_border_bf16_kernel<<<(unsigned)(B * Ci), 128, 0,
                                      (cudaStream_t)stream>>>(
        (const float*)dxp, (T*)dx0, C0, (T*)dx1, C1, H, W);
  } else {
    const long long total = (long long)B * Ci * H * W;
    const long long blocks = (total + 255) / 256;
    reflect_fold_kernel<T><<<(unsigned)blocks, 256, 0,
                             (cudaStream_t)stream>>>(
        (const float*)dxp, (T*)dx0, C0, (T*)dx1, C1, H, W, total);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad(const void* g, int Co, const void* x0, int C0, const void* x1,
          int C1, const void* scale, const void* shift, void* part, void* dw,
          int B, int H, int W, int reflect, int mw, int splits,
          void* stream) {
  const Input<T> in{(const T*)x0, (const T*)x1, (const T*)scale,
                    (const T*)shift, C0, C1, H, W, reflect};
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (mw) {
    case 1: err = launch_wgrad<T, 1>(in, (const T*)g, (float*)part, B, Co,
                                     splits, s); break;
    case 2: err = launch_wgrad<T, 2>(in, (const T*)g, (float*)part, B, Co,
                                     splits, s); break;
    case 4: err = launch_wgrad<T, 4>(in, (const T*)g, (float*)part, B, Co,
                                     splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const long long n = (long long)Co * (C0 + C1) * 9;
  sum_splits_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (T*)dw, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, which belongs to the current
// device, and returns cudaGetLastError() (cudaErrorInvalidValue for a tile
// choice it does not take). nt, mw and splits come from
// kernels/conv3x3.py::conv_tiles. The _bf16 entry points take the same
// arguments with every tensor bf16 but the bias (float32), dxp and part
// (float32 scratch); the forward and dgrad ones one more, wpack, bf16
// scratch of ceil(Ci / 16) x 9 x ceil(Co / 64) 64 x 16 values (Ci the
// input channels of the conv they run, Co its outputs: for the dgrad the
// cotangent's and C0 + C1), for the packed weights. It comes after the
// stream, so that the float32 entries' argument list is a prefix of it.

// x0 (B, C0, H, W), x1 (B, C1, H, W) or null, w (Co, C0 + C1, 3, 3),
// bias (Co,), y (B, Co, H, W); nt in {8, 16, 32, 64}.
extern "C" int fd_conv3x3_reflect_fwd(const void* x0, int C0, const void* x1,
                                      int C1, const void* w, const void* bias,
                                      void* y, int B, int H, int W, int Co,
                                      int elu, int nt, void* stream) {
  return reflect_fwd<float>(x0, C0, x1, C1, w, bias, y, B, H, W, Co, elu, nt,
                            stream, nullptr);
}

extern "C" int fd_conv3x3_reflect_fwd_bf16(const void* x0, int C0,
                                           const void* x1, int C1,
                                           const void* w, const void* bias,
                                           void* y, int B, int H, int W,
                                           int Co, int elu, int nt,
                                           void* stream, void* wpack) {
  return reflect_fwd<bf16>(x0, C0, x1, C1, w, bias, y, B, H, W, Co, elu, nt,
                           stream, wpack);
}

// x (B, C, H, W), w (Co, C, 3, 3), scale/shift (C,) or both null (no input
// transform), y (B, Co, H, W); nt in {8, 16, 32, 64}.
extern "C" int fd_conv3x3_zero_act_fwd(const void* x, int C, const void* w,
                                       const void* scale, const void* shift,
                                       void* y, int B, int H, int W, int Co,
                                       int nt, void* stream) {
  return zero_act_fwd<float>(x, C, w, scale, shift, y, B, H, W, Co, nt,
                             stream, nullptr);
}

extern "C" int fd_conv3x3_zero_act_fwd_bf16(const void* x, int C,
                                            const void* w, const void* scale,
                                            const void* shift, void* y,
                                            int B, int H, int W, int Co,
                                            int nt, void* stream,
                                            void* wpack) {
  return zero_act_fwd<bf16>(x, C, w, scale, shift, y, B, H, W, Co, nt,
                            stream, wpack);
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
  return dgrad<float>(g, Co, wt, dxp, dx0, C0, dx1, C1, B, H, W, reflect, nt,
                      stream, nullptr);
}

extern "C" int fd_conv3x3_dgrad_bf16(const void* g, int Co, const void* wt,
                                     void* dxp, void* dx0, int C0, void* dx1,
                                     int C1, int B, int H, int W, int reflect,
                                     int nt, void* stream, void* wpack) {
  return dgrad<bf16>(g, Co, wt, dxp, dx0, C0, dx1, C1, B, H, W, reflect, nt,
                     stream, wpack);
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
  return wgrad<float>(g, Co, x0, C0, x1, C1, scale, shift, part, dw, B, H, W,
                      reflect, mw, splits, stream);
}

extern "C" int fd_conv3x3_wgrad_bf16(const void* g, int Co, const void* x0,
                                     int C0, const void* x1, int C1,
                                     const void* scale, const void* shift,
                                     void* part, void* dw, int B, int H,
                                     int W, int reflect, int mw, int splits,
                                     void* stream) {
  return wgrad<bf16>(g, Co, x0, C0, x1, C1, scale, shift, part, dw, B, H, W,
                     reflect, mw, splits, stream);
}
