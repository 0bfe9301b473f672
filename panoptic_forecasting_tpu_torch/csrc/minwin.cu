// K3: dense per-group min canvas of int32 keys from an UNSORTED stream,
// placed through a per-block window canvas in shared memory, with the
// TPU kernel's overflow count computed in the same launch.
//
// Replaces: panoptic_forecasting_tpu/kernels/experimental/minwin.py::
// place_minwin (the Pallas TPU kernel that places an unsorted stream
// block by block through windows of the canvas kept on chip: per-block
// group intervals (interior, top pile, bottom pile) are cut into
// (supertile, block) chunks, each placed by byte-plane matmuls; its static
// chunk capacity is reported as `overflow`).
//
// What bounds it on the H100: memory. At the entry point's size (3
// frames of 1024x2048, N = G = 6,291,456) it reads N (group, key) pairs =
// 50.3 MB and writes a G-entry int32 canvas = 25.2 MB; at 3.35 TB/s that
// is some 23 us. The count reads nothing more. What held the earlier
// kernel back was neither: one L2 atomicMin per entry (or per group of
// equal lanes) meets ~26 L2 sectors per instruction on a coherent stream
// with jitter, and L2 atomics are bound by the sectors an instruction
// touches.
//
// What the design does about it. One CTA per block of `block` entries
// (the TPU kernel's own blocks: the stream padded with _BIG to whole
// blocks, plus one sentinel block), in three passes:
// 1. Spans. The CTA loads the block's groups and keys into registers
//    (16-byte loads where the block and the pointers allow, else scalar
//    ones) and reduces the min and max of the interior, top-pile and
//    bottom-pile groups by JAX's rules (an entry is valid when
//    group < num_groups, negative groups included; piles by floor mod of
//    plane_size). Thread 0 computes the block's chunk count, the
//    supertiles of `sw` groups the three intervals cover
//    (inclusion-exclusion, in int64).
// 2. Placement. The window is the block's interior span clipped to
//    [0, num_groups), when it fits the window's capacity (2 * block int32
//    slots, 1024 to 16384) in shared memory. Runs of equal groups merge
//    first: among a thread's four neighbouring entries, then, where a
//    warp has any, across the last runs of neighbouring lanes (a
//    segmented min by shuffles). Each run inside the window does a
//    shared-memory atomicMin, every other valid run (piles, strays,
//    blocks whose span does not fit) a global one. Entries with group < 0
//    or >= num_groups are not placed.
// 3. Flush. The threads walk the window's consecutive slots and issue one
//    global atomicMin per slot that is not EMPTY: about 4 L2 sectors per
//    instruction. Windows of neighbouring blocks overlap, so the flush
//    is an atomicMin, not a store.
// At its end each CTA adds its chunk count to a device counter and takes
// a ticket; the last CTA writes overflow = max(total - (5 * nblocks
// + 2 * n_super), 0) as int32. The canvas is filled with EMPTY by a
// kernel of its own before, which also zeroes the two counters. The
// canvas equals the plain scatter-min on any stream, whatever the
// overflow says.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7FFFFFFF;
constexpr int32_t kBig = 0x7FFFFFFF;  // JAX's _BIG: the padding's group
constexpr int kSlots = 16;            // entries a thread holds
constexpr int kMaxThreads = 512;
constexpr int64_t kMinWindow = 1024, kMaxWindow = 16384;  // int32 slots
constexpr int kFillThreads = 256;

// n / d for 0 <= n < 2^31 by a multiply-high (as in csrc/placement.cu).
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

struct Params {
  const int32_t* group;
  const int32_t* key;
  int32_t* canvas;
  int64_t n, block, n_super, nblocks;
  int32_t num_groups, sw;
  int32_t plane, pile;  // plane == 0: no pile split
  FastDiv plane_div;
  int32_t window;       // capacity in int32 slots
  unsigned long long* counters;  // [0] chunks, [1] tickets
  int32_t* overflow;
};

__global__ void fill_empty(int4* __restrict__ canvas4, int64_t n4,
                           int32_t* __restrict__ tail, int tail_n,
                           unsigned long long* __restrict__ counters) {
  const int4 e = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n4; i += stride) canvas4[i] = e;
  if (first < tail_n) tail[first] = kEmpty;
  if (first < 2) counters[first] = 0;
}

// The tile's entries [base, base + kSlots * T) below `lim` into v,
// `fill` past it. Vector layout: slot 4j + c holds entry base + 4(t + jT)
// + c (one 16-byte load per j); scalar layout: slot s holds base + t + sT.
template <bool kVec>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ src,
                                          int64_t base, int64_t lim,
                                          int32_t fill,
                                          int32_t (&v)[kSlots]) {
  const int64_t t = threadIdx.x, T = blockDim.x;
  if (kVec) {
#pragma unroll
    for (int j = 0; j < kSlots / 4; ++j) {
      const int64_t e = base + 4 * (t + j * T);
      if (e + 4 <= lim) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(src + e));
        v[4 * j] = q.x;
        v[4 * j + 1] = q.y;
        v[4 * j + 2] = q.z;
        v[4 * j + 3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[4 * j + c] = e + c < lim ? src[e + c] : fill;
        }
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t e = base + t + s * T;
      v[s] = e < lim ? __ldcs(src + e) : fill;
    }
  }
}

__device__ __forceinline__ int64_t range_size(int64_t lo, int64_t hi) {
  return hi >= lo ? hi - lo + 1 : 0;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// floor(x / d) for d > 0, in int32 (C's / truncates toward zero).
__device__ __forceinline__ int32_t floor_div(int32_t x, int32_t d) {
  const int32_t q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

// The block's chunk count: the supertiles of sw groups that the interior
// (a), top-pile (b) and bottom-pile (c) intervals cover, by
// inclusion-exclusion; an empty class has mn = _BIG, mx = -1. span holds
// the three mins, then the three maxes.
__device__ __forceinline__ int64_t chunk_count(const int32_t* span,
                                               int32_t sw, int64_t n_super) {
  int64_t lo[3], hi[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = max64(floor_div(span[i], sw), 0);
    hi[i] = min64(floor_div(span[i + 3], sw), n_super - 1);
  }
  return range_size(lo[0], hi[0]) + range_size(lo[1], hi[1]) +
         range_size(lo[2], hi[2]) -
         range_size(max64(lo[0], lo[1]), min64(hi[0], hi[1])) -
         range_size(max64(lo[0], lo[2]), min64(hi[0], hi[2])) -
         range_size(max64(lo[1], lo[2]), min64(hi[1], hi[2])) +
         range_size(max64(max64(lo[0], lo[1]), lo[2]),
                    min64(min64(hi[0], hi[1]), hi[2]));
}

// One run of group x with min key v: into the window when x lies in it,
// else straight into the canvas; x < 0 or >= num_groups is not placed.
__device__ __forceinline__ void place(int32_t x, int32_t v, const Params& p,
                                      int32_t wlo, int32_t wlen,
                                      int32_t* window) {
  if ((uint32_t)x >= (uint32_t)p.num_groups) return;  // also x < 0
  const uint32_t off = (uint32_t)(x - wlo);
  if (off < (uint32_t)wlen) {
    atomicMin(window + off, v);
  } else {
    atomicMin(p.canvas + x, v);
  }
}

// The per-entry work of spans: entry x widens the interval of its class
// (named registers, selected by predicates: an array indexed by the class
// would live in local memory).
struct Spans {
  int32_t imn = kBig, tmn = kBig, bmn = kBig, imx = -1, tmx = -1, bmx = -1;
};

__device__ __forceinline__ void widen(int32_t x, const Params& p, Spans& sp) {
  if (x >= p.num_groups) return;  // padding, sentinels
  bool top = false, bot = false;
  if (p.plane) {
    int32_t local;  // floor mod, as jnp's %
    if (x >= 0) {
      local = x - (int32_t)(fdiv(p.plane_div, x) * p.plane_div.d);
    } else {
      const uint32_t u = (uint32_t)(-(x + 1));
      local = p.plane - 1 - (int32_t)(u - fdiv(p.plane_div, u) * p.plane_div.d);
    }
    top = local < p.pile;
    bot = local >= p.plane - p.pile;
  }
  if (top) {
    sp.tmn = min(sp.tmn, x);
    sp.tmx = max(sp.tmx, x);
  }
  if (bot) {  // also top, when a pile is wider than half the plane
    sp.bmn = min(sp.bmn, x);
    sp.bmx = max(sp.bmx, x);
  }
  if (!top && !bot) {
    sp.imn = min(sp.imn, x);
    sp.imx = max(sp.imx, x);
  }
}

// One CTA per block of the padded stream.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
minwin_kernel(Params p) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  extern __shared__ int32_t window[];
  __shared__ int32_t red[6][kMaxThreads / 32];
  __shared__ int32_t s_lo, s_len;

  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t tile = (int64_t)kSlots * T;
  const int ntiles = (int)((p.block + tile - 1) / tile);
  const int64_t b0 = (int64_t)blockIdx.x * p.block;
  const int64_t lim = min64(b0 + p.block, p.n);  // past it: _BIG padding

  // ---- 1. spans and count ----
  int32_t g[kSlots], k[kSlots];
  Spans sp;
  for (int it = 0; it < ntiles; ++it) {
    const int64_t base = b0 + (int64_t)it * tile;
    load_tile<kVec>(p.group, base, lim, kBig, g);
    if (it == ntiles - 1) load_tile<kVec>(p.key, base, lim, 0, k);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) widen(g[s], p, sp);
  }
  // [0..2] min of interior, top, bottom; [3..5] their max
  int32_t span[6] = {sp.imn, sp.tmn, sp.bmn, sp.imx, sp.tmx, sp.bmx};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int32_t r = i < 3 ? __reduce_min_sync(kAll, span[i])
                            : __reduce_max_sync(kAll, span[i]);
    if (lane == 0) red[i][warp] = r;
  }
  __syncthreads();
  int64_t chunks = 0;  // thread 0: the block's chunk count
  if (warp == 0) {
    const int nwarps = T >> 5;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int32_t v = lane < nwarps ? red[i][lane] : (i < 3 ? kBig : -1);
      span[i] = i < 3 ? __reduce_min_sync(kAll, v) : __reduce_max_sync(kAll, v);
    }
    if (lane == 0) {
      chunks = chunk_count(span, p.sw, p.n_super);
      const int64_t lo = max64(span[0], 0);
      const int64_t hi = min64(span[3], p.num_groups - 1);
      const int64_t len = hi - lo + 1;
      const bool fits = len > 0 && len <= p.window;
      s_lo = fits ? (int32_t)lo : 0;
      s_len = fits ? (int32_t)len : 0;
    }
  }
  __syncthreads();

  // ---- 2. placement: the window in shared memory, the rest direct ----
  const int32_t wlo = s_lo, wlen = s_len;
  for (int s = t; s < wlen; s += T) window[s] = kEmpty;
  __syncthreads();
  for (int it = ntiles - 1; it >= 0; --it) {
    if (it != ntiles - 1) {  // the last tile is still in registers
      const int64_t base = b0 + (int64_t)it * tile;
      load_tile<kVec>(p.group, base, lim, kBig, g);
      load_tile<kVec>(p.key, base, lim, 0, k);
    }
    // A run of equal groups among a thread's four
    // neighbouring slots is placed once, with its min key; so is a run
    // that the last runs of neighbouring lanes make (a segmented min over
    // the warp, taken when a warp has one: the first lane of each run of
    // equal groups places it)
#pragma unroll
    for (int j = 0; j < kSlots / 4; ++j) {
      int32_t rg = g[4 * j], rk = k[4 * j];
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        if (g[4 * j + c] == rg) {
          rk = min(rk, k[4 * j + c]);
        } else {
          place(rg, rk, p, wlo, wlen, window);
          rg = g[4 * j + c];
          rk = k[4 * j + c];
        }
      }
      const int32_t next = __shfl_down_sync(kAll, rg, 1);
      if (__any_sync(kAll, lane < 31 && next == rg)) {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int32_t og = __shfl_down_sync(kAll, rg, d);
          const int32_t ok = __shfl_down_sync(kAll, rk, d);
          if (lane + d < 32 && og == rg) rk = min(rk, ok);
        }
        const int32_t prev = __shfl_up_sync(kAll, rg, 1);
        if (lane == 0 || prev != rg) place(rg, rk, p, wlo, wlen, window);
      } else {  // no two neighbouring lanes share a run
        place(rg, rk, p, wlo, wlen, window);
      }
    }
  }
  __syncthreads();

  // ---- 3. flush: consecutive slots, one global atomicMin each ----
  for (int s = t; s < wlen; s += T) {
    const int32_t v = window[s];
    if (v != kEmpty) atomicMin(p.canvas + wlo + s, v);
  }

  // ---- the count, last (nothing above waits for it): the last CTA
  // through the ticket writes the overflow ----
  if (t == 0) {
    atomicAdd(p.counters, (unsigned long long)chunks);
    __threadfence();
    const unsigned long long ticket = atomicAdd(p.counters + 1, 1ull);
    if (ticket == (unsigned long long)(p.nblocks - 1)) {
      __threadfence();
      const int64_t total = (int64_t)atomicAdd(p.counters, 0ull);
      const int64_t over = total - (5 * p.nblocks + 2 * p.n_super);
      *p.overflow = (int32_t)(over > 0 ? over : 0);
    }
  }
}

int fill_grid(int64_t n) {
  int64_t blocks = (n + kFillThreads - 1) / kFillThreads;
  // 132 SMs x 8 resident blocks of 256 threads; a grid-stride loop takes
  // the rest.
  const int64_t cap = 132 * 8;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// canvas[g] = min over entries i with group[i] == g of key[i], else EMPTY;
// *overflow = the TPU kernel's overflow for (block, sw, plane_size,
// pile_width) (JAX minwin.py:229-282). counters: 2 x uint64 of scratch.
// canvas must be 16-byte aligned, 0 < num_groups < 2^31, block > 0,
// 0 < sw <= 65536, 0 <= plane_size < 2^31, pile_width >= 0.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int place_minwin(const void* group, const void* key, int64_t n,
                            void* canvas, int64_t num_groups, int64_t block,
                            int64_t sw, int64_t plane_size,
                            int64_t pile_width, void* overflow,
                            void* counters, void* stream) {
  if (n < 0 || num_groups <= 0 || num_groups >= ((int64_t)1 << 31) ||
      block <= 0 || sw <= 0 || sw > 65536 || plane_size < 0 ||
      plane_size >= ((int64_t)1 << 31) || pile_width < 0 ||
      ((uintptr_t)canvas & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.group = static_cast<const int32_t*>(group);
  p.key = static_cast<const int32_t*>(key);
  p.canvas = static_cast<int32_t*>(canvas);
  p.n = n;
  p.block = block;
  p.nblocks = (n + block - 1) / block + 1;  // + the sentinel block
  p.num_groups = (int32_t)num_groups;
  p.sw = (int32_t)sw;
  p.n_super = (num_groups + sw - 1) / sw;
  p.plane = 0;
  p.pile = 0;
  p.plane_div = FastDiv{1, 1, 0};
  if (plane_size > 0 && pile_width > 0) {
    p.plane = (int32_t)plane_size;
    // a pile as wide as the plane already takes every entry
    p.pile = (int32_t)(pile_width < plane_size ? pile_width : plane_size);
    if (!make_fastdiv((uint32_t)plane_size, &p.plane_div)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  int64_t window = 2 * block;
  window = window < kMinWindow ? kMinWindow : window;
  window = window > kMaxWindow ? kMaxWindow : window;
  p.window = (int32_t)window;
  p.counters = static_cast<unsigned long long*>(counters);
  p.overflow = static_cast<int32_t*>(overflow);
  if (p.nblocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;

  int64_t threads = (block + kSlots - 1) / kSlots;
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const bool vec = block % 4 == 0 && ((uintptr_t)group & 15) == 0 &&
                   ((uintptr_t)key & 15) == 0;
  const size_t smem = (size_t)window * sizeof(int32_t);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n4 = num_groups / 4;
  fill_empty<<<fill_grid(n4 > 0 ? n4 : 1), kFillThreads, 0, s>>>(
      reinterpret_cast<int4*>(p.canvas), n4, p.canvas + n4 * 4,
      (int)(num_groups - n4 * 4), p.counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = vec ? minwin_kernel<true> : minwin_kernel<false>;
  // More than 48 KB of dynamic shared memory must be allowed per kernel
  // and device: once, for the largest window.
  static uint64_t raised[2];  // per kernel, a bit per device (64 at most)
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (smem > 48 * 1024 && !(raised[vec] & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kMaxWindow * sizeof(int32_t)));
    if (err != cudaSuccess) return (int)err;
    raised[vec] |= bit;
  }
  kernel<<<(unsigned)p.nblocks, (unsigned)threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}
