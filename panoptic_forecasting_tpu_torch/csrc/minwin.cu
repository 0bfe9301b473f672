// K3: dense per-group min canvas of int32 keys from an UNSORTED stream,
// with warp-aggregated atomics.
//
// Replaces: panoptic_forecasting_tpu/kernels/experimental/minwin.py::
// place_minwin (the Pallas TPU kernel that places an unsorted stream
// through per-sub-chunk span windows, byte-plane matmuls with a hit-count
// row, and a masked-min fix-up for groups hit twice in one sub-chunk;
// its static chunk capacity is reported as `overflow`, which the wrapper
// computes in plain PyTorch exactly as the JAX code does outside the
// pallas_call).
//
// What bounds it on the H100: memory. At the script's size (3 frames of
// 1024x2048, N = G = 6,291,456) it reads N (group, key) pairs = 50.3 MB
// and writes a G-entry int32 canvas = 25.2 MB; at 3.35 TB/s that is some
// 23 us. The arithmetic is a few integer operations per entry.
//
// What the design does about it: the TPU kernel exists to exploit the
// duplicates and locality of a raster-coherent stream without sorting
// it. Here a warp reads 32 neighbouring entries (coalesced), groups the
// lanes that hold the same group with __match_any_sync, takes their
// minimum key with __reduce_min_sync (each lane passes its own group's
// mask, which is the same for every lane of the group), and only the
// group's lowest lane issues one atomicMin into the EMPTY-filled canvas.
// A border pile (many entries of one group in a warp) thus costs one
// atomic per warp instead of 32. Ignored entries (group < 0 or
// >= num_groups) and the lanes past the end of the stream all match on
// a reserved group value and issue nothing. The loop strides by whole
// warps, so every lane of a warp runs the same number of iterations and
// the *_sync calls are always made by the full warp.
//
// The canvas is exact whatever the TPU kernel's `overflow` says: there is
// no static capacity here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmpty = 0x7FFFFFFF;
constexpr int32_t kIgnored = -1;  // match value of ignored entries
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void fill_empty(int32_t* __restrict__ canvas, int64_t n) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    canvas[i] = kEmpty;
  }
}

__global__ void minwin_kernel(const int32_t* __restrict__ group,
                              const int32_t* __restrict__ key, int64_t n,
                              int32_t* __restrict__ canvas,
                              int64_t num_groups) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warp_stride = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // Every lane of a warp sees the same `base`, so the loop's trip count
  // is uniform across the warp and the *_sync calls below stay converged
  // at the tail of the stream.
  for (int64_t base = warp * 32; base < n; base += warp_stride * 32) {
    const int64_t i = base + lane;
    int32_t g = kIgnored;
    int32_t k = kEmpty;
    if (i < n) {
      const int32_t gi = group[i];
      if (gi >= 0 && (int64_t)gi < num_groups) {
        g = gi;
        k = key[i];
      }
    }
    const unsigned peers = __match_any_sync(kFull, g);
    const int32_t m = __reduce_min_sync(peers, k);
    if (g != kIgnored && lane == __ffs(peers) - 1) {
      atomicMin(canvas + g, m);
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
extern "C" int place_minwin(const void* group, const void* key, int64_t n,
                            void* canvas, int64_t num_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(canvas);
  fill_empty<<<grid_for(num_groups), kThreads, 0, s>>>(out, num_groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    minwin_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(group), static_cast<const int32_t*>(key),
        n, out, num_groups);
  }
  return (int)cudaGetLastError();
}
