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
// * strided_ref: read straight from global memory, nothing staged. Each
//   thread takes four outputs of one row: two 16-byte loads of its eight
//   inputs and one 16-byte store ({a.x, a.z, b.x, b.z} for start 0,
//   {a.y, a.w, b.y, b.w} for start 1), so every fetched sector is used
//   and an instruction moves 16 bytes. Rows come from the grid (grid.y,
//   a loop past 65535 rows), columns from grid.x: no division per
//   element. At (8192, 8192) it moves 268.4 MB in and 134.2 MB out, 120
//   us at 3.35 TB/s; at the probe's size the launch dominates.
// * strided_val: the value loaded whole into registers. Each thread
//   reads one quad of four input floats with a 16-byte load and stores
//   the two it keeps ({v.x, v.z} for start 0, {v.y, v.w} for start 1) as
//   one 8-byte store; no shared memory, no barrier. 128-thread CTAs over
//   the R*C/4 quads: the probe's 4,096 quads take 32 CTAs on 32 SMs.
// * dyn_row_strided: the probe of a row index computed in a runtime
//   loop, reading the odd lanes of each row. The CTAs take rows in a
//   grid-stride loop (grid.y of them, two rows each), each CTA one slice
//   of a row's quads (grid.x), with strided_val's vector loads: 8 slices
//   x 4 row-CTAs = 32 CTAs at the probe's size.
// A quad takes the 16-byte path when the input is 16-byte aligned and
// C % 4 == 0 (every row then starts aligned); otherwise (C % 4 == 2, an
// input at an odd storage offset) the same kernel reads the quad's two
// kept floats as scalars. strided_ref's 16-byte path needs C % 8 == 0
// and both pointers 16-byte aligned (every output row then starts
// aligned too); otherwise its kernel reads and writes its four outputs
// as scalars.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuadThreads = 128;  // strided_val, dyn_row_strided

// Grid (column CTAs, row CTAs): thread x of CTA (bx, by) writes outputs
// 4x..4x+3, x = bx * blockDim.x + threadIdx.x, of rows by, by + gridDim.y,
// ...
template <bool kVec>
__global__ void strided_ref_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t rows,
                                   int64_t cols, int start) {
  const int64_t half = cols / 2;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * q >= half) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* row = x + r * cols;
    float* dst = out + r * half;
    if (kVec) {
      const float4* src = reinterpret_cast<const float4*>(row) + 2 * q;
      const float4 a = __ldcs(src);
      const float4 b = __ldcs(src + 1);
      reinterpret_cast<float4*>(dst)[q] =
          start ? make_float4(a.y, a.w, b.y, b.w)
                : make_float4(a.x, a.z, b.x, b.z);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t o = 4 * q + c;
        if (o < half) dst[o] = row[start + 2 * o];
      }
    }
  }
}

// Quad q of a row (input floats 4q..4q+3, outputs 2q and 2q+1): the
// outputs that exist (half = cols / 2 may be odd) from lanes start + 4q
// and start + 4q + 2.
template <bool kVec>
__device__ __forceinline__ void copy_quad(const float* __restrict__ row,
                                          float* __restrict__ dst,
                                          int64_t q, int64_t half,
                                          int start) {
  if (kVec) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(row) + q);
    reinterpret_cast<float2*>(dst)[q] =
        start ? make_float2(v.y, v.w) : make_float2(v.x, v.z);
  } else {
    const int64_t o = 2 * q;
    dst[o] = row[start + 2 * o];
    if (o + 1 < half) dst[o + 1] = row[start + 2 * o + 2];
  }
}

template <bool kVec>
__global__ void strided_val_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t rows,
                                   int64_t cols, int start) {
  const int64_t half = cols / 2;
  const int64_t quads = (half + 1) / 2;  // per row
  const int64_t total = rows * quads;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / quads;
    copy_quad<kVec>(x + r * cols, out + r * half, i - r * quads, half, start);
  }
}

// Grid (slices, row CTAs): CTA (sx, sy) copies quads [sx * T, sx * T + T)
// of rows sy, sy + gridDim.y, ...
template <bool kVec>
__global__ void dyn_row_strided_kernel(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       int64_t rows, int64_t cols,
                                       int start) {
  const int64_t half = cols / 2;
  const int64_t quads = (half + 1) / 2;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    copy_quad<kVec>(x + r * cols, out + r * half, q, half, start);
  }
}

bool vector_ok(const void* x, const void* out, int64_t cols) {
  return cols % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
         ((uintptr_t)out & 7) == 0;
}

// CTAs of `threads` for n items; a grid-stride loop takes the rest.
int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
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
  const int64_t groups = (cols / 2 + 3) / 4;  // threads a row
  const int64_t col_ctas = (groups + kThreads - 1) / kThreads;
  const int64_t row_ctas = rows < 65535 ? rows : 65535;
  if (col_ctas > 0x7FFFFFFF || row_ctas < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)col_ctas, (unsigned)row_ctas);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (cols % 8 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0) {
    strided_ref_kernel<true><<<grid, kThreads, 0, s>>>(xf, of, rows, cols,
                                                         start);
  } else {
    strided_ref_kernel<false><<<grid, kThreads, 0, s>>>(xf, of, rows, cols,
                                                          start);
  }
  return (int)cudaGetLastError();
}

extern "C" int strided_val(const void* x, void* out, int64_t rows,
                           int64_t cols, int start, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(rows * ((cols / 2 + 1) / 2), kQuadThreads);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (vector_ok(x, out, cols)) {
    strided_val_kernel<true><<<blocks, kQuadThreads, 0, s>>>(
        xf, of, rows, cols, start);
  } else {
    strided_val_kernel<false><<<blocks, kQuadThreads, 0, s>>>(
        xf, of, rows, cols, start);
  }
  return (int)cudaGetLastError();
}

extern "C" int dyn_row_strided(const void* x, void* out, int64_t rows,
                               int64_t cols, int start, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t quads = (cols / 2 + 1) / 2;
  const int64_t slices = (quads + kQuadThreads - 1) / kQuadThreads;
  int64_t row_ctas = (rows + 1) / 2;  // two rows per CTA
  if (row_ctas > 65535) row_ctas = 65535;
  if (slices > 0x7FFFFFFF || row_ctas < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)slices, (unsigned)row_ctas);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (vector_ok(x, out, cols)) {
    dyn_row_strided_kernel<true><<<grid, kQuadThreads, 0, s>>>(
        xf, of, rows, cols, start);
  } else {
    dyn_row_strided_kernel<false><<<grid, kQuadThreads, 0, s>>>(
        xf, of, rows, cols, start);
  }
  return (int)cudaGetLastError();
}
