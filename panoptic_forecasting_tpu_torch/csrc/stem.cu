// K2: fused one-hot assembly + HarDNet stem conv (3x3, stride 2, pad 1,
// bias, ReLU) over T segmentation maps and T depth maps.
//
// Replaces: panoptic_forecasting_tpu/kernels/stem.py::onehot_stem_conv
// (the Pallas TPU kernel that builds a one-hot im2col slab in VMEM and
// runs it through one MXU matmul per row slab).
//
// What bounds it on the H100: memory. At serving size it reads seg int32
// (1,3,1024,2048) = 25 MB and depth f32 = 25 MB and writes the f32
// (1,512,1024,16) output = 33.5 MB: some 84 MB, 25 us at 3.35 TB/s. The
// arithmetic the function needs is small: per output pixel, 27 gathered
// 16-vector adds plus 27 depth FMAs of 16, ~1.3 kFLOP, 0.7 GFLOP in all.
//
// What the design does about it: a one-hot row times the weight matrix
// is a gather of one weight row, so there is no one-hot tensor, no im2col
// and no GEMM. One thread computes all 16 channels of one output pixel:
// for each of the 9 taps and T frames it adds the weight row of the
// pixel's class (skipped for class >= C or < 0, the all-zero one-hot
// row) and an FMA of the depth value with the depth row. The (3,3,C_in,16)
// HWIO kernel (20 KB for C_in = 36) sits in shared memory; seg and depth
// are read straight from global memory (neighbouring threads read
// neighbouring columns, stride 2); the 16 outputs leave as four float4
// stores, so a warp writes 2 KB contiguously. Everything is f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCout = 16;

__global__ void stem_kernel(const int32_t* __restrict__ seg,
                            const float* __restrict__ depth,
                            const float* __restrict__ weight,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int B, int T, int H,
                            int W, int C, int use_depth) {
  extern __shared__ float sw[];  // HWIO kernel: [9][c_in][kCout]
  const int c_in = T * C + (use_depth ? T : 0);
  const int nw = 9 * c_in * kCout;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = weight[i];
  __syncthreads();

  const int H2 = H / 2, W2 = W / 2;
  const int64_t total = (int64_t)B * H2 * W2;
  const int64_t plane = (int64_t)H * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += stride) {
    const int x = (int)(p % W2);
    const int64_t r = p / W2;
    const int y = (int)(r % H2);
    const int b = (int)(r / H2);

    float acc[kCout];
#pragma unroll
    for (int o = 0; o < kCout; ++o) acc[o] = bias[o];

    for (int t = 0; t < T; ++t) {
      const int32_t* seg_t = seg + ((int64_t)b * T + t) * plane;
      const float* dep_t = use_depth ? depth + ((int64_t)b * T + t) * plane
                                     : nullptr;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int iy = 2 * y + dy - 1;
        if (iy < 0 || iy >= H) continue;  // zero padding
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ix = 2 * x + dx - 1;
          if (ix < 0 || ix >= W) continue;
          const int64_t off = (int64_t)iy * W + ix;
          const float* w_tap = sw + (dy * 3 + dx) * c_in * kCout;
          const int s = seg_t[off];
          if ((unsigned)s < (unsigned)C) {
            const float* w_row = w_tap + (t * C + s) * kCout;
#pragma unroll
            for (int o = 0; o < kCout; ++o) acc[o] += w_row[o];
          }
          if (use_depth) {
            const float d = dep_t[off];
            const float* w_row = w_tap + (T * C + t) * kCout;
#pragma unroll
            for (int o = 0; o < kCout; ++o) acc[o] = fmaf(d, w_row[o], acc[o]);
          }
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(out + p * kCout);
#pragma unroll
    for (int q = 0; q < kCout / 4; ++q) {
      dst[q] = make_float4(fmaxf(acc[4 * q], 0.f), fmaxf(acc[4 * q + 1], 0.f),
                           fmaxf(acc[4 * q + 2], 0.f),
                           fmaxf(acc[4 * q + 3], 0.f));
    }
  }
}

}  // namespace

// out (B, H/2, W/2, 16) = relu(conv3x3_s2_p1(onehot(seg) ++ depth) + bias).
// seg (B,T,H,W) int32; depth (B,T,H,W) f32 or null when use_depth == 0;
// kernel (3,3,T*C[+T],16) f32 HWIO; bias (16,) f32. H and W even.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int onehot_stem_conv(const void* seg, const void* depth,
                                const void* kernel, const void* bias,
                                void* out, int B, int T, int H, int W, int C,
                                int c_out, int use_depth, void* stream) {
  if (c_out != kCout || (H & 1) || (W & 1) || B <= 0 || T <= 0 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int c_in = T * C + (use_depth ? T : 0);
  const size_t smem = (size_t)9 * c_in * kCout * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t total = (int64_t)B * (H / 2) * (W / 2);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 8;  // grid-stride beyond ~8 blocks per SM
  if (blocks > cap) blocks = cap;
  stem_kernel<<<(int)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<const float*>(depth),
      static_cast<const float*>(kernel), static_cast<const float*>(bias),
      static_cast<float*>(out), B, T, H, W, C, use_depth);
  return (int)cudaGetLastError();
}
