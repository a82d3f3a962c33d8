// Fused reprojection loss of the photometric objective: per pixel,
// 0.85 * clip((1 - SSIM) / 2, 0, 1) + 0.15 * |warped - target|, averaged
// over the channels, with its gradient to `warped`. NCHW planes, float32.
//
// Replaces the TPU kernels fusiondepth_tpu/ops/pallas_reproj.py
// (_fwd, pallas_call at :219; _bwd, pallas_call at :240). SSIM uses 3x3
// box means with reflect padding in H and W (row -1 is row 1, row H is row
// H-2; the same for columns), C1 = 0.01^2, C2 = 0.03^2, as
// ops/planes.py::ssim_planes. The TPU kernel cuts H into 16-row blocks,
// shifts rows through lane rolls and hands the halo rows' gradients back
// to an XLA pass; here the kernels address the reflection themselves, so
// any H, W >= 2 works and nothing but the loss map (forward) or the warped
// cotangent (backward) goes back to memory. The TPU kernel takes
// box3(target) and box3(target^2) as inputs; these kernels compute them
// from the target.
//
// Shapes: warped (N, K, B, C, H, W), target (B, C, H, W), loss and its
// cotangent g (N, K, B, H, W), dwarped (N, K, B, C, H, W).
//
// Backward, per channel: with a = dL/d(n/d) at each output pixel o, the
// loss depends on warped p through mu_x = box(p), E[x^2] = box(p^2) and
// E[xy] = box(p t), so
//   dp(q) = box3T(Gmu)(q) + 2 p(q) box3T(Gx2)(q) + t(q) box3T(Gxy)(q)
//           + 0.15 g(q) / C * sign(p(q) - t(q)),
// where box3T is the adjoint of the reflect-padded 3x3 mean: the taps of o
// that reflect onto q count once more (row 0's tap -1 lands on row 1, row
// H-1's tap +1 on row H-2, likewise in W), as in the conv dgrad's pad
// adjoint. The kinks take the JAX package's derivatives (jax.vjp of the
// Pallas kernel's jnp.clip and jnp.abs): the clip passes the gradient
// inside (0, 1) and half of it on either bound (jnp.clip is a max and a
// min, which split a tie), and d|t - p| / dp is -1 where p == t (jnp.abs
// takes +1 at 0); ops/planes.py::clip and ::jabs in the plain version.
//
// Bound: bytes. At 640x192, batch 12, 2 x 4 warps and C = 3 the forward
// reads 141.6 MB of warped and 17.7 MB of target and writes 47.2 MB
// (62 us at 3.35 TB/s); the backward also reads the 47.2 MB cotangent
// and writes 141.6 MB (348 MB, 104 us). The function needs about 42
// operations per pixel and channel of a warp forward and 73 backward
// (derived in chip_smoke.py, REPROJ_OPS), 22 us and 39 us at the fp32
// roof. The backward as compiled issues about 170 instructions per pixel
// and channel of a warp (the SSIM algebra, two quotients, the shuffles,
// addressing and masks), so the card's instruction issue rate, not its
// bytes, is what holds this kernel, and its design cuts the work done
// again.
//
// Forward design. A block of up to FWD_WARPS warps owns one batch element
// b, a band of FWD_COLS = 62 output columns and a strip of FWD_TH = 32
// output rows. It stages the target of every channel on the strip's rows
// with a 1-pixel reflected halo (34 x 64 a channel) and computes its
// moments mu_y and E[y^2] there once (32 x 64), for all the n * k warps of
// b. Each warp then streams the rows of one warp's strip (or, where b has
// fewer than FWD_WARPS warps, as in the identity call's 2, of a slice of
// it: the block's warps split the strip into 2, 4 or 8 slices, so that
// the block still runs FWD_WARPS warps). A lane holds 2 adjacent columns
// of the band and its 1-column halo (64 columns a warp, each column's
// reflection worked out once). Per output row the warp takes one new row
// of warped, all C channels, loaded one row ahead; keeps the 3-row
// windows of p, p^2 and p t of every channel in registers, in three Row
// slots that rotate instead of being copied; takes the box's horizontal
// taps from the neighbouring lanes by shuffles; sums the SSIM and L1
// terms over the channels in registers (the C channels are independent
// chains, which is what a step's latency wants); and writes the row.
// Every moment is rounded with tap3, in box3's order, and the SSIM
// factors as ssim_terms rounds them, so the map is the plain version's up
// to the channel mean's last rounding, and warped == target gives n == d
// and a loss of exactly 0. The kernel takes C <= FWD_MAX_C (the windows
// of every channel are registers): 75 KB of shared memory a block at C = 3,
// two blocks an SM. The identity call (2 planes a b) reads a quarter of
// the warp call's bytes; both together are bound at 81 us.
//
// Backward design. A block of up to 8 warps owns one batch element b, a
// band of BWD_COLS = 60 output columns and a strip of BWD_TH = 32 output
// rows. Per channel it stages the target on the strip's rows with a
// 2-pixel reflected halo (36 x 64) and computes its moments mu_y and
// E[y^2] there once (34 x 64), for all the n * k warps of b: each of the
// block's warps then walks one warp's strip down H. A lane holds 2
// adjacent columns of the band plus its halo (64 columns a warp, the
// reflection of each column worked out once). Per row it takes one new
// row of warped and of g, both loaded one row ahead (coalesced scalar
// loads; float2 loads of the unreflected columns measured no faster);
// keeps the 3-row windows of p, p^2, p t and of the adjoint's row sums in
// registers, in three Row slots that rotate instead of being copied;
// takes the horizontal taps of the box and of its adjoint from the
// neighbouring lanes by shuffles; computes each coefficient once per
// pixel (the 2-column halo and the strip's 2 halo rows aside: 64/60 x
// 34/32 of the work); and writes one output row behind. The moments of
// warped and of the target are rounded step by step in box3's order
// (tap3), so that warped == target gives n == d exactly, as in the plain
// version. A step is a long dependent chain, so the kernel lives on
// occupancy: BWD_BLOCKS_PER_SM = 3 caps it at 80 registers, with 26.6 KB
// of shared memory a block; 792 blocks at the b12 shape, two full waves.
//
// bfloat16 (compute_dtype="bfloat16"; the _bf16 entry points): the same
// kernels on bf16 warped, target, cotangent, map and dwarped. As the
// Pallas kernel does (pallas_reproj.py:87-93), every value is widened to
// float32 as it is loaded and the moments, the SSIM algebra and the
// adjoint run in float32; the map (:114) and dwarped (:128-130, :267) are
// rounded to bf16 once, where they are stored. The target's moments are
// computed here in float32 from the bf16 target (the JAX wrapper hands
// its kernel box3(target) already rounded to bf16, an HBM input there).

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr float C1 = 0.01f * 0.01f;
constexpr float C2 = 0.03f * 0.03f;

// float32(1/3), the factor of each separable 3-tap sum (ops/planes.py)
__device__ __forceinline__ float third() { return 1.0f / 3.0f; }

// reflect index of ReflectionPad2d(1), clamped for the unused outer ring
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

struct Moments {
  float mx, my, x2, y2, xy;
};

// The SSIM factors n = A1 * A2, d = B1 * B2, rounded step by step in the
// order of ops/planes.py::ssim_planes and without fused multiply-adds, so
// that warped == target gives n == d exactly, as in the plain version: the
// clip then sits exactly on its bound, where both pass the gradient.
struct Ssim {
  float A1, A2, B1, B2, q;
};

__device__ __forceinline__ Ssim ssim_terms(const Moments& m) {
  Ssim r;
  const float sx = __fsub_rn(m.x2, __fmul_rn(m.mx, m.mx));
  const float sy = __fsub_rn(m.y2, __fmul_rn(m.my, m.my));
  const float sxy = __fsub_rn(m.xy, __fmul_rn(m.mx, m.my));
  r.A1 = __fadd_rn(__fmul_rn(__fmul_rn(2.f, m.mx), m.my), C1);
  r.A2 = __fadd_rn(__fmul_rn(2.f, sxy), C2);
  r.B1 = __fadd_rn(__fadd_rn(__fmul_rn(m.mx, m.mx), __fmul_rn(m.my, m.my)),
                   C1);
  r.B2 = __fadd_rn(__fadd_rn(sx, sy), C2);
  r.q = __fdiv_rn(__fmul_rn(r.A1, r.A2), __fmul_rn(r.B1, r.B2));
  return r;
}

// The forward's SSIM term clip((1 - n / d) / 2, 0, 1), taken as
// (d - n) / 2d with the approximate quotient (2 ulp; d >= C1 C2 > 0): n == d
// still gives 0 exactly, and the IEEE quotient's instructions leave the
// forward's step (the backward keeps it for the clip's bounds).
__device__ __forceinline__ float ssim_loss_fwd(const Ssim& f) {
  const float n = __fmul_rn(f.A1, f.A2), d = __fmul_rn(f.B1, f.B2);
  return fminf(fmaxf(__fdividef(__fsub_rn(d, n), __fmul_rn(2.f, d)), 0.f),
               1.f);
}

// Weight with which output row o = q + d (d in -1, 0, 1) takes input row q
// in the reflect-padded 3-tap sum: 1 inside the image, once more where the
// reflected tap of row 0 or H-1 lands on q, 0 outside.
__device__ __forceinline__ float tap_weight(int q, int d, int n) {
  const int o = q + d;
  if (o < 0 || o >= n) return 0.f;
  float w = 1.f;
  if (d == -1 && q == 1) w += 1.f;       // o = 0, tap -1 reflects to row 1
  if (d == 1 && q == n - 2) w += 1.f;    // o = n-1, tap +1 reflects to n-2
  return w;
}

// The backward's tiling (see the header): a block of up to BWD_WARPS
// warps owns one batch element b, a band of BWD_COLS output columns and a
// strip of BWD_TH output rows; each warp walks the rows of one n * k warp
// of that b, a lane holding BWD_CPL adjacent columns of the band and its
// 2-column halo on either side.
constexpr int BWD_WARPS = 8;
constexpr int BWD_CPL = 2;
constexpr int BWD_SPAN = 32 * BWD_CPL;  // columns x0 - 2 ... x0 + SPAN - 3
constexpr int BWD_COLS = BWD_SPAN - 4;  // output columns x0 ... x0 + COLS - 1
constexpr int BWD_TH = 32;
// blocks an SM keeps: a step of a warp is a long dependent chain (two
// shuffles, the SSIM quotient), so the kernel lives on occupancy; this
// caps the registers at 65536 / (BWD_BLOCKS_PER_SM * 256)
constexpr int BWD_BLOCKS_PER_SM = 3;

// One row of a lane's columns in the backward's sliding windows: warped,
// its square and its product with the target on an input row; g / C and
// the box adjoint's row sums of (Gmu, Gx2, Gxy) on the moment row above.
struct Row {
  float p[BWD_CPL], pp[BWD_CPL], pt[BWD_CPL];
  float G[BWD_CPL], h[3][BWD_CPL];
};

// (a + b + c) / 3 of one 3-tap sum of box3, rounded step by step as
// ops/planes.py::box3 and never contracted into a fused multiply-add, so
// that the warped and the target moments, though computed apart, round
// alike (warped == target then gives n == d exactly, see ssim_terms)
__device__ __forceinline__ float tap3(float a, float b, float c) {
  return __fmul_rn(__fadd_rn(__fadd_rn(a, b), c), third());
}

__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

// the values of the lanes' columns left and right of this lane's
template <int CPL>
__device__ __forceinline__ void neighbours(const float (&v)[CPL], float& l,
                                           float& r) {
  l = __shfl_up_sync(0xffffffffu, v[CPL - 1], 1);
  r = __shfl_down_sync(0xffffffffu, v[0], 1);
}

// ((v[j-1] + v[j]) + v[j+1]) / 3 across the lane's columns and its
// neighbours'
template <int CPL>
__device__ __forceinline__ void hbox(const float (&v)[CPL], float (&out)[CPL]) {
  float l, r;
  neighbours<CPL>(v, l, r);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    out[j] = tap3(j ? v[j - 1] : l, v[j], j + 1 < CPL ? v[j + 1] : r);
}

// sum_d w_d G(column + d) of the box adjoint along a row
template <int CPL>
__device__ __forceinline__ void hadj(const float (&v)[CPL],
                                     const float (&w)[3][CPL],
                                     float (&out)[CPL]) {
  float l, r;
  neighbours<CPL>(v, l, r);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    out[j] = w[0][j] * (j ? v[j - 1] : l) + w[1][j] * v[j] +
             w[2][j] * (j + 1 < CPL ? v[j + 1] : r);
}

// The forward's tiling (see the header): a block of up to FWD_WARPS warps
// owns one batch element b, a band of FWD_COLS output columns and a strip
// of FWD_TH output rows; each warp walks the rows of one n * k warp of
// that b, or of a slice of the strip, a lane holding FWD_CPL adjacent
// columns of the band and its 1-column halo on either side.
constexpr int FWD_WARPS = 8;
constexpr int FWD_CPL = 2;
constexpr int FWD_SPAN = 32 * FWD_CPL;  // columns x0 - 1 ... x0 + SPAN - 2
constexpr int FWD_COLS = FWD_SPAN - 2;  // output columns x0 ... x0 + COLS - 1
constexpr int FWD_TH = 32;
constexpr int FWD_BLOCKS_PER_SM = 2;
constexpr int FWD_MAX_C = 4;
// shared floats a channel: the target on rows y0 - 1 ... y0 + TH, then its
// moments mu_y and E[y^2] on rows y0 ... y0 + TH - 1
constexpr int FWD_T_FLOATS = (FWD_TH + 2) * FWD_SPAN;
constexpr int FWD_M_FLOATS = FWD_TH * FWD_SPAN;
constexpr int FWD_CH_FLOATS = FWD_T_FLOATS + 2 * FWD_M_FLOATS;

// One input row of a lane's columns in the forward's sliding windows:
// warped, its square and its product with the target, every channel.
template <int C>
struct FwdRow {
  float p[C][FWD_CPL], pp[C][FWD_CPL], pt[C][FWD_CPL];
};

template <typename T, int C>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_BLOCKS_PER_SM)
    reproj_fwd_kernel(const T* __restrict__ warped,
                      const T* __restrict__ target,
                      T* __restrict__ out, int NK, int B, int H, int W,
                      int slices) {
  static_assert(C >= 1 && C <= FWD_MAX_C, "channels");
  constexpr int CPL = FWD_CPL, SPAN = FWD_SPAN, TH = FWD_TH;
  extern __shared__ __align__(16) float fwd_smem[];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * FWD_COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long HW = (long long)H * W;
  auto Ts = [&](int c) { return fwd_smem + c * FWD_CH_FLOATS; };
  auto MY = [&](int c) { return Ts(c) + FWD_T_FLOATS; };
  auto Y2 = [&](int c) { return Ts(c) + FWD_T_FLOATS + FWD_M_FLOATS; };

  // the target of every channel on the strip's rows y0 - 1 ... y0 + TH,
  // then its box moments on rows y0 ... y0 + TH - 1, shared by the block's
  // warps
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T* t = target + ((long long)b * C + c) * HW;
    for (int i = threadIdx.x; i < FWD_T_FLOATS; i += blockDim.x) {
      const int r = reflect(y0 - 1 + i / SPAN, H);
      Ts(c)[i] = ldg_f(t + (long long)r * W + reflect(x0 - 1 + i % SPAN, W));
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int i = threadIdx.x; i < FWD_M_FLOATS; i += blockDim.x) {
      const int s = i % SPAN;
      float my = 0.f, y2 = 0.f;
      if (s >= 1 && s <= SPAN - 2) {
        const float* a = Ts(c) + i;  // rows y0 - 1 + i / SPAN and the 2 below
        float v[3], q[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float t0 = a[d - 1], t1 = a[SPAN + d - 1],
                      t2 = a[2 * SPAN + d - 1];
          v[d] = tap3(t0, t1, t2);
          q[d] = tap3(sq(t0), sq(t1), sq(t2));
        }
        my = tap3(v[0], v[1], v[2]);
        y2 = tap3(q[0], q[1], q[2]);
      }
      MY(c)[i] = my;
      Y2(c)[i] = y2;
    }
  }
  __syncthreads();

  // this lane's columns: where they are read from (reflected once, here)
  // and whether their output (span columns 1 ... SPAN - 2) is in the image
  int xr[CPL], xs[CPL];
  bool oval[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int s = CPL * lane + j, x = x0 - 1 + s;
    xs[j] = x;
    xr[j] = reflect(x, W);
    oval[j] = s >= 1 && s <= SPAN - 2 && x < W;
  }
  const int rows = TH / slices;
  const float inv_c = 1.f / C;

  for (int task = warp; task < NK * slices; task += nwarps) {
    const int jp = task / slices;
    const int ys = y0 + (task % slices) * rows;
    const int ye = min(min(ys + rows, y0 + TH), H);
    if (ys >= ye) continue;  // the slice lies below the image
    const long long plane = (long long)jp * B + b;  // (n * K + k) * B + b
    const T* p = warped + plane * C * HW;
    T* orow = out + plane * HW;

    // warped at image row `row`, every channel
    auto fetch = [&](int row, float (&pv)[C][CPL]) {
      const T* src = p + (long long)reflect(row, H) * W;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < CPL; ++j) pv[c][j] = ldg_f(src + c * HW + xr[j]);
    };
    // p^2 and p t of image row `row`
    auto products = [&](int row, FwdRow<C>& x) {
      const int ti = (row - y0 + 1) * SPAN + CPL * lane;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          x.pp[c][j] = sq(x.p[c][j]);
          x.pt[c][j] = __fmul_rn(x.p[c][j], Ts(c)[ti + j]);
        }
    };
    // the next step's row of warped, loaded one step ahead so that its
    // latency overlaps a step's arithmetic
    float pn[C][CPL];

    // Step s: the input row r + 1 (r = ys + s) enters `cur`, and output row
    // r is computed from the windows of rows r - 1 (older), r (old) and
    // r + 1 (cur). The three FwdRows rotate over the steps.
    auto step = [&](int s, const FwdRow<C>& older, const FwdRow<C>& old,
                    FwdRow<C>& cur) {
      const int r = ys + s;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < CPL; ++j) cur.p[c][j] = pn[c][j];
      fetch(r + 2, pn);
      products(r + 1, cur);
      const int mi = (r - y0) * SPAN + CPL * lane;
      const int ti = mi + SPAN;  // the target at row r
      float ssim_sum[CPL], l1_sum[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) ssim_sum[j] = l1_sum[j] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v[CPL], vv[CPL], vt[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          v[j] = tap3(older.p[c][j], old.p[c][j], cur.p[c][j]);
          vv[j] = tap3(older.pp[c][j], old.pp[c][j], cur.pp[c][j]);
          vt[j] = tap3(older.pt[c][j], old.pt[c][j], cur.pt[c][j]);
        }
        float mx[CPL], x2[CPL], xy[CPL];
        hbox<CPL>(v, mx);
        hbox<CPL>(vv, x2);
        hbox<CPL>(vt, xy);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          Moments m;
          m.mx = mx[j];
          m.my = MY(c)[mi + j];
          m.x2 = x2[j];
          m.y2 = Y2(c)[mi + j];
          m.xy = xy[j];
          ssim_sum[j] = __fadd_rn(ssim_sum[j], ssim_loss_fwd(ssim_terms(m)));
          l1_sum[j] = __fadd_rn(
              l1_sum[j], fabsf(__fsub_rn(Ts(c)[ti + j], old.p[c][j])));
        }
      }
      // the channel means as torch's mean rounds them on the card: the
      // sum times float32(1 / C)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (oval[j])
          st_f(orow + (long long)r * W + xs[j],
               __fadd_rn(__fmul_rn(0.85f, __fmul_rn(ssim_sum[j], inv_c)),
                         __fmul_rn(0.15f, __fmul_rn(l1_sum[j], inv_c))));
    };

    FwdRow<C> r0, r1, r2;  // input rows ys - 1 and ys in r0 and r1
    fetch(ys - 1, r0.p);
    fetch(ys, r1.p);
    products(ys - 1, r0);
    products(ys, r1);
    fetch(ys + 1, pn);
    const int steps = ye - ys;
    for (int s = 0; s < steps; s += 3) {
      step(s, r0, r1, r2);
      if (s + 1 < steps) step(s + 1, r1, r2, r0);
      if (s + 2 < steps) step(s + 2, r2, r0, r1);
    }
  }
}

template <typename T, int C>
int launch_fwd(const T* warped, const T* target, T* out, int NK, int B,
               int H, int W, cudaStream_t stream) {
  constexpr int smem = C * FWD_CH_FLOATS * (int)sizeof(float);
  static bool sized = false;  // the opt-in above 48 KB, once per T, C
  if (!sized) {
    const int err = (int)cudaFuncSetAttribute(
        reproj_fwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err) return err;
    sized = true;
  }
  // slices of a strip a warp walks: enough that the block runs FWD_WARPS
  // warps where b has fewer n * k warps (a power of two, so rows divide)
  int slices = 1;
  while (slices * 2 * NK <= FWD_WARPS) slices *= 2;
  const dim3 grid((W + FWD_COLS - 1) / FWD_COLS, (H + FWD_TH - 1) / FWD_TH,
                  B);
  const int threads = 32 * min(NK * slices, FWD_WARPS);
  reproj_fwd_kernel<T, C><<<grid, threads, smem, stream>>>(
      warped, target, out, NK, B, H, W, slices);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(BWD_WARPS * 32, BWD_BLOCKS_PER_SM)
    reproj_bwd_kernel(const T* __restrict__ warped,
                      const T* __restrict__ target,
                      const T* __restrict__ g,
                      T* __restrict__ dwarped, int NK, int B, int C,
                      int H, int W) {
  constexpr int CPL = BWD_CPL, SPAN = BWD_SPAN, TH = BWD_TH;
  // the target of channel c on the strip's rows y0 - 2 ... y0 + TH + 1, and
  // its box moments mu_y, E[y^2] on rows y0 - 1 ... y0 + TH, staged once
  // and shared by the block's n * k warps
  __shared__ __align__(16) float Ts[(TH + 4) * SPAN];
  __shared__ __align__(16) float MY[(TH + 2) * SPAN];
  __shared__ __align__(16) float Y2[(TH + 2) * SPAN];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * BWD_COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long HW = (long long)H * W;
  const float inv_c = 1.f / C;
  const float k9 = third() * third();

  // this lane's columns: where they are read from (reflected once, here),
  // whether their moments (span columns 1 ... SPAN - 2) and their output
  // (2 ... SPAN - 3) are in the image, and the box adjoint's column weights
  int xr[CPL], xs[CPL];
  bool mval[CPL], oval[CPL];
  float wx[3][CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int s = CPL * lane + j, x = x0 - 2 + s;
    xs[j] = x;
    xr[j] = reflect(x, W);
    mval[j] = s >= 1 && s <= SPAN - 2 && x >= 0 && x < W;
    oval[j] = s >= 2 && s <= SPAN - 3 && x < W;
#pragma unroll
    for (int d = 0; d < 3; ++d) wx[d][j] = tap_weight(x, d - 1, W);
  }
  const int steps = min(TH + 2, H - y0 + 2);

  for (int c = 0; c < C; ++c) {
    const T* t = target + ((long long)b * C + c) * HW;
    __syncthreads();
    for (int i = threadIdx.x; i < (TH + 4) * SPAN; i += blockDim.x) {
      const int r = reflect(y0 - 2 + i / SPAN, H);
      Ts[i] = ldg_f(t + (long long)r * W + reflect(x0 - 2 + i % SPAN, W));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (TH + 2) * SPAN; i += blockDim.x) {
      const int s = i % SPAN;
      float my = 0.f, y2 = 0.f;
      if (s >= 1 && s <= SPAN - 2) {
        const float* a = Ts + i;  // rows y0 - 2 + i / SPAN and the 2 below
        float v[3], q[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float t0 = a[d - 1], t1 = a[SPAN + d - 1],
                      t2 = a[2 * SPAN + d - 1];
          v[d] = tap3(t0, t1, t2);
          q[d] = tap3(sq(t0), sq(t1), sq(t2));
        }
        my = tap3(v[0], v[1], v[2]);
        y2 = tap3(q[0], q[1], q[2]);
      }
      MY[i] = my;
      Y2[i] = y2;
    }
    __syncthreads();

    for (int jp = warp; jp < NK; jp += nwarps) {
      const long long plane = (long long)jp * B + b;  // (n * K + k) * B + b
      const T* p = warped + (plane * C + c) * HW;
      const T* gp = g + plane * HW;
      T* dp = dwarped + (plane * C + c) * HW;

      // warped at image row y0 - 2 + i; g at image row o, clamped (a lane
      // whose column is outside the image reads its reflection, unused)
      auto fetch = [&](int i, float (&pv)[CPL]) {
        const T* row = p + (long long)reflect(y0 - 2 + i, H) * W;
#pragma unroll
        for (int j = 0; j < CPL; ++j) pv[j] = ldg_f(row + xr[j]);
      };
      auto fetch_g = [&](int o, float (&gv)[CPL]) {
        const T* row = gp + (long long)min(max(o, 0), H - 1) * W;
#pragma unroll
        for (int j = 0; j < CPL; ++j) gv[j] = ldg_f(row + xr[j]);
      };
      // p^2 and p t of staged row i
      auto products = [&](int i, Row& x) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          x.pp[j] = sq(x.p[j]);
          x.pt[j] = __fmul_rn(x.p[j], Ts[i * SPAN + CPL * lane + j]);
        }
      };
      // the next step's row of warped and of g, loaded one step ahead so
      // that their latency overlaps a step's arithmetic
      float pn[CPL], gn[CPL];

      // Step s: the input row r = y0 + s enters `cur`; the moments, the
      // coefficients and the adjoint's row sums of o = r - 1 go to `cur`
      // as well; the output row q = o - 1 is written from the adjoint's
      // rows o - 2 (older), o - 1 (old) and o (cur). The three Rows rotate
      // over the steps, so that no window is copied.
      auto step = [&](int s, const Row& older, const Row& old, Row& cur) {
        float gv[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          cur.p[j] = pn[j];
          gv[j] = gn[j];
        }
        fetch(s + 3, pn);
        fetch_g(y0 + s, gn);
        products(s + 2, cur);
        float v[CPL], vv[CPL], vt[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          v[j] = tap3(older.p[j], old.p[j], cur.p[j]);
          vv[j] = tap3(older.pp[j], old.pp[j], cur.pp[j]);
          vt[j] = tap3(older.pt[j], old.pt[j], cur.pt[j]);
        }
        float mx[CPL], x2[CPL], xy[CPL];
        hbox<CPL>(v, mx);
        hbox<CPL>(vv, x2);
        hbox<CPL>(vt, xy);
        const int o = y0 + s - 1;
        const bool orow = o >= 0 && o < H;
        float cmu[CPL], cx2[CPL], cxy[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int si = s * SPAN + CPL * lane + j;
          Moments m;
          m.mx = mx[j];
          m.my = MY[si];
          m.x2 = x2[j];
          m.y2 = Y2[si];
          m.xy = xy[j];
          const bool ok = orow && mval[j];
          cur.G[j] = ok ? gv[j] * inv_c : 0.f;
          const Ssim f = ssim_terms(m);
          const float raw = __fsub_rn(1.f, f.q) * 0.5f;
          // d loss / d q, through the clip (half on a bound) and
          // (1 - q) / 2
          const float clip_d = (raw > 0.f && raw < 1.f) ? 1.f
                               : (raw == 0.f || raw == 1.f) ? 0.5f : 0.f;
          const float a = -0.5f * 0.85f * cur.G[j] * clip_d;
          // the coefficient's quotient: the approximate division (2 ulp)
          // is far inside the cotangent's tolerance, and a step's latency
          // chain runs through it (the SSIM quotient f.q stays IEEE)
          const float gq = __fdividef(a, f.B1 * f.B2);
          const float gd = -gq * f.q;
          const float gA1 = gq * f.A2, gA2 = gq * f.A1;
          const float gB1 = gd * f.B2, gB2 = gd * f.B1;
          cmu[j] = ok ? 2.f * m.my * (gA1 - gA2) + 2.f * m.mx * (gB1 - gB2)
                      : 0.f;
          cx2[j] = ok ? gB2 : 0.f;
          cxy[j] = ok ? 2.f * gA2 : 0.f;
        }
        hadj<CPL>(cmu, wx, cur.h[0]);
        hadj<CPL>(cx2, wx, cur.h[1]);
        hadj<CPL>(cxy, wx, cur.h[2]);
        if (s < 2) return;
        // output row q = o - 1 takes the adjoint's rows q - 1, q, q + 1
        const int q = o - 1;
        const float w0 = tap_weight(q, -1, H), w1 = tap_weight(q, 0, H),
                    w2 = tap_weight(q, 1, H);
        T* drow = dp + (long long)q * W;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float sum[3];
#pragma unroll
          for (int f = 0; f < 3; ++f)
            sum[f] = w0 * older.h[f][j] + w1 * old.h[f][j] + w2 * cur.h[f][j];
          const float pv = older.p[j];
          const float tv = Ts[s * SPAN + CPL * lane + j];
          const float diff = pv - tv;
          const float sgn = diff > 0.f ? 1.f : -1.f;  // d|t - p| / dp
          if (oval[j])
            st_f(drow + xs[j],
                 k9 * (sum[0] + 2.f * pv * sum[1] + tv * sum[2]) +
                     0.15f * old.G[j] * sgn);
        }
      };

      Row r0, r1, r2;  // input rows y0 - 2 and y0 - 1 in r0 and r1
      fetch(0, r0.p);
      fetch(1, r1.p);
      products(0, r0);
      products(1, r1);
      fetch(2, pn);
      fetch_g(y0 - 1, gn);
      for (int s = 0; s < steps; s += 3) {
        step(s, r0, r1, r2);
        if (s + 1 < steps) step(s + 1, r1, r2, r0);
        if (s + 2 < steps) step(s + 2, r2, r0, r1);
      }
    }
  }
}

template <typename T>
int run_fwd(const void* warped, const void* target, void* out, int NK, int B,
            int C, int H, int W, void* stream) {
  const T* w = (const T*)warped;
  const T* t = (const T*)target;
  T* o = (T*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_fwd<T, 1>(w, t, o, NK, B, H, W, st);
    case 2:
      return launch_fwd<T, 2>(w, t, o, NK, B, H, W, st);
    case 3:
      return launch_fwd<T, 3>(w, t, o, NK, B, H, W, st);
    case 4:
      return launch_fwd<T, 4>(w, t, o, NK, B, H, W, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run_bwd(const void* warped, const void* target, const void* g,
            void* dwarped, int NK, int B, int C, int H, int W, void* stream) {
  const dim3 grid((W + BWD_COLS - 1) / BWD_COLS, (H + BWD_TH - 1) / BWD_TH,
                  B);
  const int threads = 32 * min(NK, BWD_WARPS);
  reproj_bwd_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)warped, (const T*)target, (const T*)g, (T*)dwarped, NK, B, C,
      H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// warped (N, K, B, C, H, W), target (B, C, H, W) -> out (N, K, B, H, W).
// H, W >= 2, 1 <= C <= FWD_MAX_C. One block per (band of FWD_COLS columns,
// strip of FWD_TH rows, b). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fd_reproj_fwd(const void* warped, const void* target,
                             void* out, int NK, int B, int C, int H, int W,
                             void* stream) {
  return run_fwd<float>(warped, target, out, NK, B, C, H, W, stream);
}

// g (N, K, B, H, W) -> dwarped (N, K, B, C, H, W). One block per (band of
// BWD_COLS columns, strip of BWD_TH rows, b), min(N K, BWD_WARPS) warps.
extern "C" int fd_reproj_bwd(const void* warped, const void* target,
                             const void* g, void* dwarped, int NK, int B,
                             int C, int H, int W, void* stream) {
  return run_bwd<float>(warped, target, g, dwarped, NK, B, C, H, W, stream);
}

// The same on bfloat16 tensors (every argument bf16).
extern "C" int fd_reproj_fwd_bf16(const void* warped, const void* target,
                                  void* out, int NK, int B, int C, int H,
                                  int W, void* stream) {
  return run_fwd<bf16>(warped, target, out, NK, B, C, H, W, stream);
}

extern "C" int fd_reproj_bwd_bf16(const void* warped, const void* target,
                                  const void* g, void* dwarped, int NK,
                                  int B, int C, int H, int W, void* stream) {
  return run_bwd<bf16>(warped, target, g, dwarped, NK, B, C, H, W, stream);
}
