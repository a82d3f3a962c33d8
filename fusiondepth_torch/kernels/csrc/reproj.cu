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
// to an XLA pass; here a block owns a 32 x 8 pixel tile, stages the tile
// with its reflected halo in shared memory and addresses the reflection
// itself, so any H, W >= 2 works and nothing but the loss map (forward)
// or the warped cotangent (backward) goes back to memory. The target's
// moments are recomputed from the staged target; the wrapper passes no
// box3(target) fields.
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
// adjoint. One kernel: a block computes the coefficients Gmu, Gx2, Gxy on
// its tile plus a one-pixel halo (from warped and target staged with a
// two-pixel halo) in shared memory, then applies box3T. The clip passes
// the gradient on its closed interval [0, 1] and |.| has derivative 0 at
// 0, as torch's clamp and abs do.
//
// Bound: bytes. At 640x192, batch 12, 2 x 4 warps and C = 3 the forward
// reads 141.6 MB of warped and 17.7 MB of target and writes 47.2 MB
// (62 us at 3.35 TB/s); the backward also reads the 47.2 MB cotangent
// and writes 141.6 MB (104 us). The function needs about 42 operations per
// pixel and channel of a warp forward and 73 backward (derived in
// chip_smoke.py, REPROJ_OPS), 22 us and 39 us at the fp32 roof; this
// kernel does more, recomputing the halo's moments and coefficients in
// every block, and stays below the roof at these sizes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int THREADS = TX * TY;
constexpr float C1 = 0.01f * 0.01f;
constexpr float C2 = 0.03f * 0.03f;

// float32(1/3), the factor of each separable 3-tap sum (ops/planes.py)
__device__ __forceinline__ float third() { return 1.0f / 3.0f; }

// reflect index of ReflectionPad2d(1), clamped for the unused outer ring
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// 3x3 box mean of a staged (rows, cols) field f at (y, x), vertical sums
// first, each scaled by 1/3
template <int COLS>
__device__ __forceinline__ float box(const float* f, int y, int x) {
  float v0 = (f[(y - 1) * COLS + x - 1] + f[y * COLS + x - 1] +
              f[(y + 1) * COLS + x - 1]) * third();
  float v1 = (f[(y - 1) * COLS + x] + f[y * COLS + x] +
              f[(y + 1) * COLS + x]) * third();
  float v2 = (f[(y - 1) * COLS + x + 1] + f[y * COLS + x + 1] +
              f[(y + 1) * COLS + x + 1]) * third();
  return (v0 + v1 + v2) * third();
}

struct Moments {
  float mx, my, x2, y2, xy;
};

template <int COLS>
__device__ __forceinline__ Moments moments(const float* P, const float* T,
                                           const float* PP, const float* TT,
                                           const float* PT, int y, int x) {
  Moments m;
  m.mx = box<COLS>(P, y, x);
  m.my = box<COLS>(T, y, x);
  m.x2 = box<COLS>(PP, y, x);
  m.y2 = box<COLS>(TT, y, x);
  m.xy = box<COLS>(PT, y, x);
  return m;
}

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

// clip((1 - q) / 2, 0, 1)
__device__ __forceinline__ float ssim_loss(float q) {
  return fminf(fmaxf(__fsub_rn(1.f, q) * 0.5f, 0.f), 1.f);
}

// Stage warped and target of one channel on the tile with a halo of R
// pixels, reflected at the image border, plus the products p^2, t^2, p*t.
template <int R>
__device__ __forceinline__ void stage(const float* __restrict__ p,
                                      const float* __restrict__ t, int H,
                                      int W, int y0, int x0, float* P,
                                      float* T, float* PP, float* TT,
                                      float* PT) {
  constexpr int ROWS = TY + 2 * R, COLS = TX + 2 * R;
  for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
    const int yy = reflect(y0 - R + i / COLS, H);
    const int xx = reflect(x0 - R + i % COLS, W);
    const long long off = (long long)yy * W + xx;
    const float a = __ldg(p + off), b = __ldg(t + off);
    P[i] = a;
    T[i] = b;
    PP[i] = a * a;
    TT[i] = b * b;
    PT[i] = a * b;
  }
}

// One block per (plane n*K*B + b, 8-row band, 32-column band).
__global__ void __launch_bounds__(THREADS)
    reproj_fwd_kernel(const float* __restrict__ warped,
                      const float* __restrict__ target,
                      float* __restrict__ out, int B, int C, int H, int W) {
  constexpr int R = 1, ROWS = TY + 2, COLS = TX + 2;
  __shared__ float P[ROWS * COLS], T[ROWS * COLS], PP[ROWS * COLS],
      TT[ROWS * COLS], PT[ROWS * COLS];
  const long long plane = blockIdx.z;  // (n * K + k) * B + b
  const long long b = plane % B;
  const long long HW = (long long)H * W;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int y = y0 + ty, x = x0 + tx;
  float ssim_sum = 0.f, l1_sum = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* p = warped + (plane * C + c) * HW;
    const float* t = target + (b * C + c) * HW;
    __syncthreads();
    stage<R>(p, t, H, W, y0, x0, P, T, PP, TT, PT);
    __syncthreads();
    if (y < H && x < W) {
      const int sy = ty + R, sx = tx + R;
      const Moments m = moments<COLS>(P, T, PP, TT, PT, sy, sx);
      ssim_sum += ssim_loss(ssim_terms(m).q);
      l1_sum += fabsf(T[sy * COLS + sx] - P[sy * COLS + sx]);
    }
  }
  if (y < H && x < W)
    out[plane * HW + (long long)y * W + x] =
        0.85f * (ssim_sum / C) + 0.15f * (l1_sum / C);
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

__global__ void __launch_bounds__(THREADS)
    reproj_bwd_kernel(const float* __restrict__ warped,
                      const float* __restrict__ target,
                      const float* __restrict__ g,
                      float* __restrict__ dwarped, int B, int C, int H,
                      int W) {
  constexpr int R = 2, ROWS = TY + 4, COLS = TX + 4;
  constexpr int GR = TY + 2, GC = TX + 2;  // coefficient tile, 1-px halo
  __shared__ float P[ROWS * COLS], T[ROWS * COLS], PP[ROWS * COLS],
      TT[ROWS * COLS], PT[ROWS * COLS];
  __shared__ float Gmu[GR * GC], Gx2[GR * GC], Gxy[GR * GC];
  const long long plane = blockIdx.z;
  const long long b = plane % B;
  const long long HW = (long long)H * W;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int y = y0 + ty, x = x0 + tx;
  const float* gp = g + plane * HW;
  const float inv_c = 1.f / C;

  for (int c = 0; c < C; ++c) {
    const float* p = warped + (plane * C + c) * HW;
    const float* t = target + (b * C + c) * HW;
    __syncthreads();
    stage<R>(p, t, H, W, y0, x0, P, T, PP, TT, PT);
    __syncthreads();
    // coefficients at output pixels o of the tile and its 1-pixel halo
    for (int i = threadIdx.x; i < GR * GC; i += THREADS) {
      const int oy = y0 - 1 + i / GC, ox = x0 - 1 + i % GC;
      float gmu = 0.f, gx2 = 0.f, gxy = 0.f;
      if (oy >= 0 && oy < H && ox >= 0 && ox < W) {
        const int sy = i / GC + 1, sx = i % GC + 1;  // in the staged tile
        const Moments m = moments<COLS>(P, T, PP, TT, PT, sy, sx);
        const Ssim f = ssim_terms(m);
        const float raw = __fsub_rn(1.f, f.q) * 0.5f;
        const float G = __ldg(gp + (long long)oy * W + ox) * inv_c;
        // d loss / d q, through the clip (closed interval) and (1 - q) / 2
        const float a =
            (raw >= 0.f && raw <= 1.f) ? -0.5f * 0.85f * G : 0.f;
        const float d = f.B1 * f.B2;
        const float gn = a / d;
        const float gd = -a * f.q / d;
        const float gA1 = gn * f.A2, gA2 = gn * f.A1;
        const float gB1 = gd * f.B2, gB2 = gd * f.B1;
        gmu = gA1 * 2.f * m.my - gA2 * 2.f * m.my + gB1 * 2.f * m.mx -
              gB2 * 2.f * m.mx;
        gx2 = gB2;
        gxy = 2.f * gA2;
      }
      Gmu[i] = gmu;
      Gx2[i] = gx2;
      Gxy[i] = gxy;
    }
    __syncthreads();
    if (y < H && x < W) {
      float smu = 0.f, sx2 = 0.f, sxy = 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const float wy = tap_weight(y, dy, H);
        float rmu = 0.f, rx2 = 0.f, rxy = 0.f;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const float w = tap_weight(x, dx, W);
          const int i = (ty + 1 + dy) * GC + (tx + 1 + dx);
          rmu += w * Gmu[i];
          rx2 += w * Gx2[i];
          rxy += w * Gxy[i];
        }
        smu += wy * rmu;
        sx2 += wy * rx2;
        sxy += wy * rxy;
      }
      const float k9 = third() * third();
      const int si = (ty + R) * COLS + (tx + R);
      const float pv = P[si], tv = T[si];
      const float diff = pv - tv;
      const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
      const float G = __ldg(gp + (long long)y * W + x) * inv_c;
      dwarped[(plane * C + c) * HW + (long long)y * W + x] =
          k9 * (smu + 2.f * pv * sx2 + tv * sxy) + 0.15f * G * sgn;
    }
  }
}

}  // namespace

// warped (N, K, B, C, H, W), target (B, C, H, W) -> out (N, K, B, H, W).
// H, W >= 2. Launches on `stream`; returns cudaGetLastError().
extern "C" int fd_reproj_fwd(const void* warped, const void* target,
                             void* out, int NK, int B, int C, int H, int W,
                             void* stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, NK * B);
  reproj_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)warped, (const float*)target, (float*)out, B, C, H, W);
  return (int)cudaGetLastError();
}

// g (N, K, B, H, W) -> dwarped (N, K, B, C, H, W).
extern "C" int fd_reproj_bwd(const void* warped, const void* target,
                             const void* g, void* dwarped, int NK, int B,
                             int C, int H, int W, void* stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, NK * B);
  reproj_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)warped, (const float*)target, (const float*)g,
      (float*)dwarped, B, C, H, W);
  return (int)cudaGetLastError();
}
