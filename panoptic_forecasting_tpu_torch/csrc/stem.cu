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
// arithmetic is small (per output pixel 27 gathered 16-vector adds and 27
// depth FMAs of 16, 0.7 GFLOP in all), but every tap reads a gathered
// weight row from shared memory, so shared-memory wavefronts are the next
// limit after DRAM.
//
// What the design does about it: a one-hot row times the weight matrix
// is a gather of one weight row, so there is no one-hot tensor, no im2col
// and no GEMM. A persistent CTA of kThreads threads stages the
// (3,3,C_in,16) weights once in shared memory (16-byte loads, several in
// flight) and then walks output tiles of kTileH x kTileW pixels of one
// batch entry; a thread owns kPix output pixels of one column, all 16
// channels of each.
//  * Tiling: per tile the (2*kTileH+1)-row input window of every frame is
//    staged in shared memory by 16-byte loads (4 neighbouring columns per
//    thread, neighbouring threads on neighbouring chunks, kStage chunks'
//    loads issued before any store), scalar loads only on a ragged edge,
//    when W is not a multiple of 4 or when an input is not 16-byte
//    aligned. The staging goes through registers, not cp.async, because
//    it rearranges on the way: columns are split into an even and an odd
//    plane, so the stride-2 taps of a warp read 32 consecutive words (no
//    bank conflict), and each seg id is stored as the offset of its weight
//    row (the all-zero row for ids outside [0, C) and for the zero
//    padding, whose depth is 0), so the inner loop has no branch.
//  * Weight gathers: each class's 16 weights sit in a row padded to an
//    odd kRow = 17 floats and are read as 16 scalars. Weight o of row r
//    lies on bank (17 r + o) mod 32, so the <= 12 rows a warp gathers in
//    one tap and frame (11 classes and the zero row) fall on distinct
//    banks: one wavefront per load. (Rows of 16 floats read as float4s
//    are slower: a quarter-warp of 8 lanes then meets several rows on one
//    bank group.) The depth rows are stored apart, 16-byte aligned, read
//    as float4 broadcasts and shared by a thread's kPix pixels.
//  * Indexing is int32 from blockIdx/threadIdx inside a plane (H*W <
//    2^31); only the per-tile plane base is 64-bit.
//  * Stores: 16 channels leave as four float4s; a warp's pixels are 32
//    neighbours of one output row, so its 2 KB are contiguous.
//  * Occupancy: 128 threads, ~110 registers, 50.3 kB of shared memory at
//    T = 3, C = 11: four CTAs per SM, the grid the count that fits.
//    Shared memory is 4 * (2456 T + 153 (T C + 1)) bytes (up to 12 more for
//    alignment) and may not pass the 227 KB a CTA can opt into: C <= 110
//    at T = 3 (kernels/stem.py raises beyond it). The padded rows and the
//    staged windows cost that range: the 16-float weights alone would fit
//    C <= 133.
// scripts/prof_stem.py times the kernel beside builds with one part cut
// (arithmetic, staging, stores, depth, class gathers). The arithmetic is
// f32. The output is f32 (onehot_stem_conv) or, for a network that runs
// in bf16, the same f32 values rounded to nearest even and stored as
// bf16 pairs (onehot_stem_conv_bf16): the JAX model casts the f32 stem to
// bf16 as its next op, so the function is the same, and the largest
// write halves (33.5 MB -> 16.8 MB at 1024x2048).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 16;
constexpr int kRow = 17;               // padded class weight row, floats
constexpr int kTileW = 32;             // output columns per tile
constexpr int kTileH = 8;              // output rows per tile
constexpr int kThreads = 128;
constexpr int kRowsPerPass = kThreads / kTileW;
// Output pixels per thread, in rows ly, ly + kRowsPerPass, ... They share
// each tap's depth-weight row, read once into registers.
constexpr int kPix = kTileH / kRowsPerPass;
constexpr int kWinRows = 2 * kTileH + 1;
// Input columns 2*x0 - 4 .. 2*x0 + 2*kTileW - 1 (aligned chunks of 4),
// split by parity into two planes of kHalf entries.
constexpr int kChunks = kTileW / 2 + 1;
constexpr int kHalf = 2 * kChunks;

constexpr int kStage = 4;  // window chunks a thread loads before storing any

// Four neighbouring columns of one seg row and one depth row.
struct Chunk {
  int4 s;
  float4 d;
};

struct Window {
  int row0, col0;      // top-left input pixel of the window
  int64_t frame0;      // offset of frame 0 of the tile's batch entry
};

__device__ __forceinline__ int chunk_row(int i, int* c4) {
  *c4 = i % kChunks;
  return i / kChunks;  // t * kWinRows + window row
}

// Where window chunk i starts in the (B, T, H, W) inputs: false when its
// row lies off the image; *ix is its first column.
__device__ __forceinline__ bool chunk_at(int i, const Window& win, int H,
                                         int W, int64_t* off, int* ix) {
  int c4;
  const int tr = chunk_row(i, &c4);
  const int t = tr / kWinRows;
  const int iy = win.row0 + (tr - t * kWinRows);
  *ix = win.col0 + 4 * c4;
  *off = win.frame0 + (int64_t)t * H * W + iy * W + *ix;
  return iy >= 0 && iy < H;
}

// Window chunk i (ids -1 and depth 0 off the image).
__device__ __forceinline__ Chunk load_chunk(
    const int32_t* __restrict__ seg, const float* __restrict__ depth, int i,
    int n_chunks, const Window& win, int H, int W, bool vec, int use_depth) {
  Chunk c{make_int4(-1, -1, -1, -1), make_float4(0.f, 0.f, 0.f, 0.f)};
  int64_t off;
  int ix;
  if (i >= n_chunks || !chunk_at(i, win, H, W, &off, &ix)) return c;
  if (vec && ix >= 0 && ix + 3 < W) {
    c.s = __ldg(reinterpret_cast<const int4*>(seg + off));
    if (use_depth) c.d = __ldg(reinterpret_cast<const float4*>(depth + off));
    return c;
  }
  const bool in0 = ix >= 0 && ix < W, in1 = ix + 1 >= 0 && ix + 1 < W;
  const bool in2 = ix + 2 >= 0 && ix + 2 < W, in3 = ix + 3 >= 0 && ix + 3 < W;
  if (in0) c.s.x = __ldg(seg + off);
  if (in1) c.s.y = __ldg(seg + off + 1);
  if (in2) c.s.z = __ldg(seg + off + 2);
  if (in3) c.s.w = __ldg(seg + off + 3);
  if (use_depth) {
    if (in0) c.d.x = __ldg(depth + off);
    if (in1) c.d.y = __ldg(depth + off + 1);
    if (in2) c.d.z = __ldg(depth + off + 2);
    if (in3) c.d.w = __ldg(depth + off + 3);
  }
  return c;
}

__device__ __forceinline__ float4 ldg4(const float* __restrict__ p,
                                       bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ int weight_offset(int s, int t, int C, int zero_off) {
  return (unsigned)s < (unsigned)C ? (t * C + s) * kRow : zero_off;
}

// Columns 4*c4 .. 4*c4 + 3 of window row tr: even ones to the even plane,
// odd ones to the odd plane, seg ids as weight-row offsets.
__device__ __forceinline__ void store_chunk(int* sseg, float* sdep, int i,
                                            int n_chunks, const Chunk& c,
                                            int C, int zero_off) {
  if (i >= n_chunks) return;
  int c4;
  const int tr = chunk_row(i, &c4);
  const int t = tr / kWinRows;
  const int e = tr * 2 * kHalf + 2 * c4;  // even plane; odd at + kHalf
  *reinterpret_cast<int2*>(sseg + e) = make_int2(
      weight_offset(c.s.x, t, C, zero_off), weight_offset(c.s.z, t, C, zero_off));
  *reinterpret_cast<int2*>(sseg + e + kHalf) = make_int2(
      weight_offset(c.s.y, t, C, zero_off), weight_offset(c.s.w, t, C, zero_off));
  *reinterpret_cast<float2*>(sdep + e) = make_float2(c.d.x, c.d.z);
  *reinterpret_cast<float2*>(sdep + e + kHalf) = make_float2(c.d.y, c.d.w);
}

// One pixel's 16 channels after the ReLU: four float4s (f32 output) or
// eight bf16 pairs in two 16-byte stores (bf16 output).
__device__ __forceinline__ void store_pixel(float* out, int64_t pix,
                                            const float* acc) {
  float4* dst = reinterpret_cast<float4*>(out + pix * kCout);
#pragma unroll
  for (int q = 0; q < kCout / 4; ++q) {
    dst[q] = make_float4(fmaxf(acc[4 * q], 0.f), fmaxf(acc[4 * q + 1], 0.f),
                         fmaxf(acc[4 * q + 2], 0.f),
                         fmaxf(acc[4 * q + 3], 0.f));
  }
}

__device__ __forceinline__ void store_pixel(__nv_bfloat16* out, int64_t pix,
                                            const float* acc) {
  __nv_bfloat162 h[kCout / 2];
#pragma unroll
  for (int q = 0; q < kCout / 2; ++q) {
    h[q] = __floats2bfloat162_rn(fmaxf(acc[2 * q], 0.f),
                                 fmaxf(acc[2 * q + 1], 0.f));
  }
  uint4* dst = reinterpret_cast<uint4*>(out + pix * kCout);
  dst[0] = *reinterpret_cast<const uint4*>(&h[0]);
  dst[1] = *reinterpret_cast<const uint4*>(&h[4]);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads, 4)
stem_kernel(const int32_t* __restrict__ seg, const float* __restrict__ depth,
            const float* __restrict__ weight, const float* __restrict__ bias,
            Out* __restrict__ out, int B, int T, int H, int W, int C,
            int use_depth) {
  extern __shared__ float4 smem4[];
  const int c_in = T * C + (use_depth ? T : 0);
  const int tap_stride = (T * C + 1) * kRow;  // class rows + the zero row
  const int zero_off = T * C * kRow;
  // [9][T][kCout] depth weights, [9][T*C + 1][kRow] class weights (padded
  // to 16 bytes), then per frame and window row the even and odd
  // seg-offset planes and the even and odd depth planes.
  float* sdw = reinterpret_cast<float*>(smem4);
  float* sw = sdw + 9 * T * kCout;
  int* sseg = reinterpret_cast<int*>(sw + ((9 * tap_stride + 3) & ~3));
  float* sdep = reinterpret_cast<float*>(sseg + T * kWinRows * 2 * kHalf);

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + kTileW - 1) / kTileW;
  const int tiles_y = (H2 + kTileH - 1) / kTileH;
  const int tiles = B * tiles_x * tiles_y;
  const bool vec = (W & 3) == 0 && ((uintptr_t)seg & 15) == 0 &&
                   (!use_depth || ((uintptr_t)depth & 15) == 0);
  const int plane = H * W;
  const int lx = threadIdx.x % kTileW, ly = threadIdx.x / kTileW;
  const int n_chunks = T * kWinRows * kChunks;

  // Weights in 16-byte pieces, four loads in flight per thread: a CTA
  // stages them once, before its first tile.
  const bool wvec = ((uintptr_t)weight & 15) == 0;
  const int class_rows = 9 * T * C;  // (tap, class) rows of 16 weights
#pragma unroll 4
  for (int i = threadIdx.x; i < class_rows * 4; i += kThreads) {
    const int row = i >> 2, q = i & 3;
    const int tap = row / (T * C);
    const int r = row - tap * T * C;
    const float4 v = ldg4(weight + (tap * c_in + r) * kCout + 4 * q, wvec);
    float* d = sw + tap * tap_stride + r * kRow + 4 * q;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int i = threadIdx.x; i < 9 * kCout; i += kThreads) {
    sw[(i / kCout) * tap_stride + zero_off + i % kCout] = 0.f;
  }
  if (use_depth) {
#pragma unroll 4
    for (int i = threadIdx.x; i < 9 * T * 4; i += kThreads) {
      const int tap = i / (T * 4);
      const int rem = i - tap * T * 4;  // t * 4 + q
      reinterpret_cast<float4*>(sdw)[i] =
          ldg4(weight + (tap * c_in + T * C) * kCout + 4 * rem, wvec);
    }
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int ty = rest % tiles_y;
    const int b = rest / tiles_y;
    const int x0 = tx * kTileW, y0 = ty * kTileH;
    const Window win{2 * y0 - 1, 2 * x0 - 4, (int64_t)b * T * plane};
    __syncthreads();  // the previous tile's reads of the window are done
    for (int i0 = threadIdx.x; i0 < n_chunks; i0 += kStage * kThreads) {
      Chunk c[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        c[u] = load_chunk(seg, depth, i0 + u * kThreads, n_chunks, win, H, W,
                          vec, use_depth);
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        store_chunk(sseg, sdep, i0 + u * kThreads, n_chunks, c[u], C, zero_off);
      }
    }
    __syncthreads();

    const int x = x0 + lx;
    if (x >= W2 || y0 + ly >= H2) continue;
    float acc[kPix][kCout];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) acc[p][o] = __ldg(bias + o);
    }
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* w_tap = sw + (dy * 3 + dx) * tap_stride;
          int k[kPix];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            // window row 2*(ly + p*kRowsPerPass) + dy; window column 2*lx + dx + 3,
            // odd for dx 0 and 2, even for 1
            const int wr =
                (t * kWinRows + 2 * (ly + p * kRowsPerPass) + dy) * 2 * kHalf;
            k[p] = (dx == 1) ? wr + lx + 2 : wr + kHalf + lx + 1 + dx / 2;
            const float* wrow = w_tap + sseg[k[p]];
#pragma unroll
            for (int o = 0; o < kCout; ++o) acc[p][o] += wrow[o];
          }
          if (use_depth) {
            const float4* drow = reinterpret_cast<const float4*>(
                sdw + ((dy * 3 + dx) * T + t) * kCout);
            float dw[kCout];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 v = drow[q];
              dw[4 * q] = v.x;
              dw[4 * q + 1] = v.y;
              dw[4 * q + 2] = v.z;
              dw[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              const float dv = sdep[k[p]];
#pragma unroll
              for (int o = 0; o < kCout; ++o) acc[p][o] = fmaf(dv, dw[o], acc[p][o]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int y = y0 + ly + p * kRowsPerPass;
      if (y >= H2) break;
      store_pixel(out, ((int64_t)b * H2 + y) * W2 + x, acc[p]);
    }
  }
}

}  // namespace

template <typename Out>
int launch_stem(const void* seg, const void* depth, const void* kernel,
                const void* bias, void* out, int B, int T, int H, int W, int C,
                int c_out, int use_depth, void* stream) {
  if (c_out != kCout || (H & 1) || (W & 1) || B <= 0 || T <= 0 || C <= 0 ||
      H <= 0 || W <= 0 || (int64_t)H * W >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t class_floats = ((size_t)9 * (T * C + 1) * kRow + 3) & ~(size_t)3;
  const size_t smem = sizeof(float) * ((size_t)9 * T * kCout + class_floats +
                                       (size_t)T * kWinRows * 4 * kHalf);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stem_kernel<Out>, kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (int64_t)B * ((H / 2 + kTileH - 1) / kTileH) *
                        ((W / 2 + kTileW - 1) / kTileW);
  if (tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int64_t resident = (int64_t)sms * per_sm;
  const int64_t grid = tiles < resident ? tiles : resident;
  stem_kernel<Out><<<(int)grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<const float*>(depth),
      static_cast<const float*>(kernel), static_cast<const float*>(bias),
      static_cast<Out*>(out), B, T, H, W, C, use_depth);
  return (int)cudaGetLastError();
}

// out (B, H/2, W/2, 16) = relu(conv3x3_s2_p1(onehot(seg) ++ depth) + bias).
// seg (B,T,H,W) int32; depth (B,T,H,W) f32 or null when use_depth == 0;
// kernel (3,3,T*C[+T],16) f32 HWIO; bias (16,) f32. H and W even,
// H*W < 2^31. Returns cudaGetLastError() after the launch (0 on success).
// out is f32.
extern "C" int onehot_stem_conv(const void* seg, const void* depth,
                                const void* kernel, const void* bias,
                                void* out, int B, int T, int H, int W, int C,
                                int c_out, int use_depth, void* stream) {
  return launch_stem<float>(seg, depth, kernel, bias, out, B, T, H, W, C,
                            c_out, use_depth, stream);
}

// The same, with out bf16: each f32 value rounded to nearest even.
extern "C" int onehot_stem_conv_bf16(const void* seg, const void* depth,
                                     const void* kernel, const void* bias,
                                     void* out, int B, int T, int H, int W,
                                     int C, int c_out, int use_depth,
                                     void* stream) {
  return launch_stem<__nv_bfloat16>(seg, depth, kernel, bias, out, B, T, H,
                                    W, C, c_out, use_depth, stream);
}
