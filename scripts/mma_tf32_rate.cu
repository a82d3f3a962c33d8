// The rate of mma.sync.aligned.m16n8k8 TF32 products from registers on
// one card: the ceiling of the conv kernels in
// fusiondepth_torch/kernels/csrc/conv3x3.cu, which take three such
// products per fp32-accurate multiply-add (3xTF32).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o mma_tf32_rate scripts/mma_tf32_rate.cu && ./mma_tf32_rate
//
// Prints TFLOP/s (2 x 16 x 8 x 8 per product) for 4 to 16 independent
// accumulators per warp and 4 or 8 warps a block, 4 blocks an SM.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  float c[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
void run(int warps) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * 4, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps * 32);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_loop<CHAINS><<<blocks, warps * 32>>>(out, iters);  // warm-up
  cudaEventRecord(e0);
  mma_loop<CHAINS><<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * 16 * 8 * 8 * CHAINS * (double)iters * blocks *
                       warps;
  printf("accumulators/warp %d, warps/block %d: %.1f TFLOP/s\n", CHAINS,
         warps, flops / ms / 1e9);
  cudaFree(out);
}

int main() {
  run<4>(4);
  run<8>(4);
  run<16>(4);
  run<8>(8);
  run<16>(8);
  return 0;
}
