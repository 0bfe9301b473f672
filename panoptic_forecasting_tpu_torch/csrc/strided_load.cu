// K4: the strided-load probes, f32[R, C] -> f32[R, C/2], out[r, c] =
// x[r, start + 2c] with start in {0, 1}.
//
// Replaces: scripts/prof_strided_load.py, the three Pallas probe bodies
// passed to pl.pallas_call there (k_strided_ref: even lanes read
// straight from the ref; k_strided_val: the whole block loaded, then
// its even lanes taken; k_dyn_row_strided: the odd lanes of one dynamic
// row per loop step, the fused stem kernel's access pattern). On the TPU
// they asked whether Mosaic lowers lane-strided loads; here each probes
// the matching CUDA access pattern.
//
// What bounds them on the H100: memory, and at the probe's own size
// (8 x 2048 in, 8 x 1024 out, 98,304 bytes) the launch: moving the bytes
// at 3.35 TB/s takes some 0.03 us, far below a kernel launch.
//
// What each design does:
// * strided_ref: one thread per output element, a stride-2 read
//   straight from global memory. A warp's 32 reads span 256 bytes, so
//   half of every sector it fetches is thrown away; its writes are
//   coalesced.
// * strided_val: a block copies a tile of one row into shared memory
//   with coalesced reads (every byte of each sector used), then writes
//   the selected lanes from shared memory (a stride-2 read there costs a
//   two-way bank conflict).
// * dyn_row_strided: ONE block walks the rows in a runtime loop, the row
//   index a value computed in the loop, each row's lanes read with
//   stride 2 as in strided_ref. It uses one SM of 132 and is the
//   slowest by design: it is the probe of that pattern, not a copy
//   kernel to use.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // input floats per strided_val block: 8 KB

__global__ void strided_ref_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t rows,
                                   int64_t cols, int start) {
  const int64_t half = cols / 2;
  const int64_t total = rows * half;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / half;
    const int64_t c = i - r * half;
    out[i] = x[r * cols + start + 2 * c];
  }
}

// Grid (ceil(cols / kTile), rows): block (t, r) handles input columns
// [t·kTile, min((t+1)·kTile, cols)) of row r; kTile is even, so each
// tile's outputs are the contiguous run starting at t·kTile / 2.
__global__ void strided_val_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t cols,
                                   int start) {
  __shared__ float tile[kTile];
  const int64_t r = blockIdx.y;
  const int64_t c0 = (int64_t)blockIdx.x * kTile;
  const int64_t n = cols - c0 < kTile ? cols - c0 : kTile;
  const float* src = x + r * cols + c0;
  for (int64_t j = threadIdx.x; j < n; j += blockDim.x) tile[j] = src[j];
  __syncthreads();
  float* dst = out + r * (cols / 2) + c0 / 2;
  for (int64_t j = threadIdx.x; j < n / 2; j += blockDim.x) {
    dst[j] = tile[start + 2 * j];
  }
}

__global__ void dyn_row_strided_kernel(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       int64_t rows, int64_t cols,
                                       int start) {
  const int64_t half = cols / 2;
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = x + r * cols + start;
    float* dst = out + r * half;
    for (int64_t c = threadIdx.x; c < half; c += blockDim.x) {
      dst[c] = row[2 * c];
    }
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success). cols is even, start is 0 or 1, and
// x and out are contiguous; the Python wrapper checks all three.
extern "C" int strided_ref(const void* x, void* out, int64_t rows,
                           int64_t cols, int start, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  strided_ref_kernel<<<grid_for(rows * (cols / 2)), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols,
      start);
  return (int)cudaGetLastError();
}

extern "C" int strided_val(const void* x, void* out, int64_t rows,
                           int64_t cols, int start, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)((cols + kTile - 1) / kTile), (unsigned)rows);
  strided_val_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), cols, start);
  return (int)cudaGetLastError();
}

extern "C" int dyn_row_strided(const void* x, void* out, int64_t rows,
                               int64_t cols, int start, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dyn_row_strided_kernel<<<1, 1024, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols,
      start);
  return (int)cudaGetLastError();
}
