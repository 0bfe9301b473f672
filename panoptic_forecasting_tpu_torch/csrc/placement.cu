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
//
// place_min_fold: the same placement fused with the packed z-buffer's
// corner fold (kernels/zbuffer.py of the JAX package, :238-254), for the
// forecast path. The stream's groups are (batch, corner plane, pixel)
// indices of B*4*P, P = H*W; each entry takes the min at its pixel and,
// by its plane's ceil offsets (fu = plane & 1, fv = plane >> 1), at the
// pixel to its right (fu, not in the last column), below (fv, not in the
// last row) and diagonally (both), straight into a ONE-plane (B, H, W)
// canvas. That is what the fold of the 4-plane canvas computes, so the
// result is bit-identical to place_min + fold on any stream.
//
// Its bound on the H100 is memory: at serving size it reads the 6.29 M
// entry stream (50.3 MB) and writes the 3 x 1024 x 2048 canvas (25.2 MB),
// 75.5 MB, 23 us at 3.35 TB/s. The 4-plane canvas (100.7 MB) and the fold's
// dozen elementwise passes over it are gone; the one-plane canvas fits the
// 50 MB L2, so its fill and its atomics (up to 4 per entry) stay there.
// What holds it back in practice is L2 atomic throughput: ~20 M targets,
// and on the synthetic forecast stream (random depth, so random parallax)
// a warp's targets rarely share a sector. Group decoding divides by
// constants through multiply-high magic numbers computed on the host (no
// integer division per entry).
//
// The fan-out puts an entry's two targets of one row on two neighbouring
// lanes of one instruction: a warp places 16 entries per round, lane 2e
// entry e's pixel (then the pixel below) and lane 2e + 1 the pixel to its
// right (then the diagonal), so an atomic instruction meets about 16 L2
// sectors where one atomic per target and lane meets about 32. The loop
// strides by whole warps, so the shuffles are always converged.
// scripts/prof_fold.py times it against one atomic per target and against
// neighbouring lanes merging their shared targets first.
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

// n / d for 0 <= n < 2^31 by a multiply-high (the round-up method of
// Granlund and Montgomery, as in PyTorch's IntDivider).
struct FastDiv {
  uint32_t d, m, s;
};

bool make_fastdiv(uint32_t d, FastDiv* f) {
  if (d == 0 || d >= (1u << 31)) return false;
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  if (m > 0xFFFFFFFFull) return false;
  *f = FastDiv{d, (uint32_t)m, s};
  return true;
}

__device__ __forceinline__ uint32_t fdiv(const FastDiv& f, uint32_t n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct FoldShape {
  FastDiv plane4, plane, width;  // 4*P, P, W
  int num_groups, H, W;          // num_groups = B*4*P
};

// The <= 4 canvas targets of one entry; t0 < 0 when the group is ignored.
__device__ __forceinline__ void fold_targets(int32_t g, const FoldShape& fs,
                                             int* t0, int* t1, int* t2,
                                             int* t3) {
  *t0 = *t1 = *t2 = *t3 = -1;
  if ((uint32_t)g >= (uint32_t)fs.num_groups) return;  // also g < 0
  const uint32_t b = fdiv(fs.plane4, g);
  const uint32_t rem = g - b * fs.plane4.d;
  const uint32_t corner = fdiv(fs.plane, rem);
  const uint32_t base = rem - corner * fs.plane.d;
  const uint32_t row = fdiv(fs.width, base);
  const uint32_t col = base - row * fs.width.d;
  const int t = (int)(b * fs.plane.d + base);
  const bool right = (corner & 1) && (int)col < fs.W - 1;
  const bool down = (corner >> 1) && (int)row < fs.H - 1;
  *t0 = t;
  if (right) *t1 = t + 1;
  if (down) *t2 = t + fs.W;
  if (right && down) *t3 = t + fs.W + 1;
}

__global__ void fill_empty4(int4* __restrict__ canvas, int64_t n4) {
  const int4 e = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    canvas[i] = e;
  }
}

__global__ void fold_place(const int32_t* __restrict__ group,
                           const int32_t* __restrict__ key, int64_t n,
                           int32_t* __restrict__ canvas, FoldShape fs) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const bool right = lane & 1;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t w0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
       w0 < n; w0 += warps * 32) {
    const int64_t i = w0 + lane;
    int t0 = -1, t1 = -1, t2 = -1, t3 = -1;
    int32_t k = 0;
    if (i < n) {
      fold_targets(group[i], fs, &t0, &t1, &t2, &t3);
      if (t0 >= 0) k = key[i];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int src = 16 * half + (lane >> 1);
      const int a0 = __shfl_sync(kAll, t0, src);
      const int a1 = __shfl_sync(kAll, t1, src);
      const int a2 = __shfl_sync(kAll, t2, src);
      const int a3 = __shfl_sync(kAll, t3, src);
      const int32_t ak = __shfl_sync(kAll, k, src);
      const int top = right ? a1 : a0;
      const int bottom = right ? a3 : a2;
      if (top >= 0) atomicMin(canvas + top, ak);
      if (bottom >= 0) atomicMin(canvas + bottom, ak);
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

// canvas (batch, height, width) = per pixel the min key over the entries
// whose fold targets include it (see the note at the top), EMPTY where none
// does. canvas must be 16-byte aligned; batch*4*height*width < 2^31.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int place_min_fold(const void* group, const void* key, int64_t n,
                              void* canvas, int batch, int height, int width,
                              void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || n < 0 ||
      (int64_t)batch * 4 * height * width >= ((int64_t)1 << 31) ||
      ((uintptr_t)canvas & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = height * width;
  FoldShape fs;
  if (!make_fastdiv(4u * P, &fs.plane4) || !make_fastdiv(P, &fs.plane) ||
      !make_fastdiv(width, &fs.width)) {
    return (int)cudaErrorInvalidValue;
  }
  fs.num_groups = batch * 4 * P;
  fs.H = height;
  fs.W = width;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(canvas);
  const int64_t cells = (int64_t)batch * P;
  fill_empty4<<<grid_for(cells / 4), kThreads, 0, s>>>(
      reinterpret_cast<int4*>(out), cells / 4);
  if (cells % 4) {
    fill_empty<<<1, kThreads, 0, s>>>(out + cells / 4 * 4, cells % 4);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  const int32_t* g = static_cast<const int32_t*>(group);
  const int32_t* k = static_cast<const int32_t*>(key);
  fold_place<<<grid_for(n), kThreads, 0, s>>>(g, k, n, out, fs);
  return (int)cudaGetLastError();
}
