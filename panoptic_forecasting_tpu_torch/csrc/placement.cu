// K1: dense per-group min canvas of int32 keys, for the packed z-buffer.
//
// Replaces: panoptic_forecasting_tpu/kernels/placement.py::place_sorted
// (the Pallas TPU kernel that places SORTED (group, key) runs into the
// canvas through one-hot byte-plane matmuls, because a TPU scatter with
// colliding indices serialises).
//
// What bounds it on the H100: memory. At serving size (1x3 frames of
// 1024x2048) it reads 6.29 M (group, key) pairs = 50 MB and fills and
// writes an 8.39 M-entry int32 canvas = 2 x 33.5 MB; at 3.35 TB/s that is
// some 25-35 us. The arithmetic is one compare per entry.
//
// What the design does about it: Hopper has native int32 atomicMin in
// L2, and min does not depend on order, so the stream is placed UNSORTED
// with one atomicMin per entry -- the sort the TPU kernel needs
// (kernels/zbuffer.py:195-204 of the JAX package) has no counterpart and
// the canvas is bit-identical to the TPU kernel's. Loads are coalesced
// (neighbouring threads read neighbouring entries); the canvas fill is a
// separate coalesced pass. Entries with group outside [0, num_groups)
// are skipped; untouched groups keep EMPTY = 0x7FFFFFFF.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmpty = 0x7FFFFFFF;

__global__ void fill_empty(int32_t* __restrict__ canvas, int64_t n) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    canvas[i] = kEmpty;
  }
}

__global__ void place_min_kernel(const int32_t* __restrict__ group,
                                 const int32_t* __restrict__ key, int64_t n,
                                 int32_t* __restrict__ canvas,
                                 int64_t num_groups) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t g = group[i];
    if (g >= 0 && (int64_t)g < num_groups) {
      atomicMin(canvas + g, key[i]);
    }
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  // 132 SMs x 16 resident blocks of 256 threads covers the card; the
  // grid-stride loop takes the rest.
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// canvas[g] = min over entries i with group[i] == g of key[i], else EMPTY.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int place_min(const void* group, const void* key, int64_t n,
                         void* canvas, int64_t num_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(canvas);
  fill_empty<<<grid_for(num_groups), kThreads, 0, s>>>(out, num_groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    place_min_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(group), static_cast<const int32_t*>(key),
        n, out, num_groups);
  }
  return (int)cudaGetLastError();
}
