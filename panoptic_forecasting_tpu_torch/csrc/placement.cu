// K1: dense per-group min canvas of int32 keys, for the packed z-buffer.
//
// Replaces: panoptic_forecasting_tpu/kernels/placement.py::place_sorted
// (the Pallas TPU kernel that places SORTED (group, key) runs into the
// canvas through one-hot byte-plane matmuls, because a TPU scatter with
// colliding indices serialises). min does not depend on order, so both
// entry points take the stream UNSORTED: the sort the TPU kernel needs
// (kernels/zbuffer.py:195-204 of the JAX package) has no counterpart, and
// the canvas is bit-identical to the TPU kernel's. Entries with group
// outside [0, num_groups) are skipped; untouched groups keep EMPTY =
// 0x7FFFFFFF.
//
// place_min: the generic canvas of any size, as a tile-owned canvas.
//
// What bounds it on the H100: memory. On the forecast stream (3 frames x
// 4 corner planes x 1024x2048 = 25.17 M groups, N = 6.29 M entries) it
// must read 50.3 MB of stream and write a 100.7 MB canvas: 45 us at
// 3.35 TB/s. The earlier kernel (an EMPTY fill pass, then one L2
// atomicMin per entry) took about three times that: the canvas is twice
// the 50 MB L2, so most filled lines left L2 before an atomic reached
// them, and each atomic pulled its sector back from HBM and dirtied it.
//
// What the design does about it: the canvas is cut into tiles of T = 2^s
// groups (s = tile_shift, 2..15, from the host's plan), and each tile is
// owned by one CTA that holds it in shared memory, so a tile's canvas is
// written once, with 16-byte stores, and never read back. Three kernels
// after a memset of the counters:
// 1. count: each CTA counts a contiguous span of groups, a warp 128
//    entries a load round with the next round's loads in flight (16-byte
//    loads where the pointer allows, else scalar ones; entries outside
//    [0, num_groups) dropped). A run of neighbouring lanes on one tile
//    adds its length once to a histogram in shared memory, which the CTA
//    adds to the global tile counters, one atomic per touched tile. The
//    last CTA through a ticket scans the counters into the buckets'
//    starts, and the hot tiles (buckets longer than one place chunk) into
//    a prefix of their chunks.
// 2. partition: each CTA holds kPartChunk entries in registers, ranks
//    them per tile in shared memory (one atomic per run of lanes), sorts
//    them by tile in shared memory (a counting sort over its histogram),
//    reserves its run in each touched tile's bucket with one global
//    atomic, and writes its sorted entries as (offset in tile, key), 8
//    bytes, neighbouring threads to neighbouring slots of a run. Its CTAs
//    also set the hot tiles' canvas to EMPTY.
// 3. place: the CTA of a cold tile fills a window with EMPTY in shared
//    memory, reads its bucket with 16-byte loads (two entries a lane, the
//    next round's in flight), takes a shared atomicMin per run of equal
//    offsets (a lane's two entries merge first, then runs across
//    neighbouring lanes by a segmented min of shuffles, as in
//    csrc/minwin.cu), and writes the window with 16-byte streaming
//    stores. A hot tile's bucket is cut into chunks of kPlaceChunk, each
//    placed by a CTA of its own into its own window, which it then takes
//    into the canvas with one global atomicMin per slot that is not EMPTY.
//    These CTAs run in the same launch as the cold tiles', so a bucket
//    that holds a pile-up (the forecast stream's out-of-frame points,
//    clamped onto the last rows, put 0.43 M entries in one tile) spreads
//    over many SMs, and its few groups cost a few atomics a chunk.
// On the forecast stream that moves 25.2 MB (count) + 100.7 MB
// (partition) + 50.3 + 100.7 MB (place) = 276.8 MB, 83 us at 3.35 TB/s.
// The stream's random parallax scatters neighbouring entries over many
// tiles, so the count and the partition take about one shared atomic an
// entry, and a partition CTA's runs in each bucket are short.
//
// Skew: equal offsets in a warp cost one shared atomic per run (N/32 for
// a stream on one group); a bucket holding all of a 6.29 M-entry stream
// takes 384 chunk CTAs across the card; chip_smoke.py phase 2 times that
// stream.
//
// Limits: 0 < num_groups < 2^31, any N (the counters are 64-bit); past
// kHistMax tiles the partition ranks entries in the global cursors
// directly, unsorted. The caller passes a bucket of N x 8 bytes,
// 2 tiles + 2 counters of 8 bytes (16- and 8-byte aligned) and the canvas
// (16-byte aligned); the kernels allocate nothing.
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

// ---- place_min: the tile-owned canvas (see the note at the top) ----

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kCountThreads = 512;
constexpr int kCountQuads = 2;  // 16-byte loads a lane has in flight
constexpr int kPartThreads = 256;
constexpr int kPartSlots = 16;  // entries a partition thread holds
constexpr int kPartChunk = kPartThreads * kPartSlots;
constexpr int kPlaceThreads = 512;
constexpr int kPlacePairs = 2;  // 16-byte bucket loads a lane has in flight
constexpr int64_t kPlaceChunk = 16384;  // bucket entries a place CTA takes
constexpr int kMinTileShift = 2, kMaxTileShift = 15;  // 16 B .. 128 KB
constexpr int64_t kHistMax = 8192;  // tiles a partition CTA sorts locally

struct Tiles {
  const int32_t* group;
  const int32_t* key;
  int64_t n, tiles, count_span;
  int32_t num_groups;
  int shift;
  int2* bucket;  // (offset in tile, key) per kept entry
  // [0, tiles) the buckets' cursors, [tiles] the count's ticket,
  // [tiles + 1, 2 tiles + 2) the chunk prefix of the hot tiles
  unsigned long long* counters;
  int32_t* canvas;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The entry's tile, -1 when its group is outside [0, num_groups).
__device__ __forceinline__ int tile_of(int32_t g, const Tiles& p) {
  return (uint32_t)g < (uint32_t)p.num_groups ? g >> p.shift : -1;
}

// Chunks of kPlaceChunk a bucket of `len` entries takes when it is hot
// (longer than one chunk), else 0: a place CTA takes a cold bucket whole.
__device__ __forceinline__ unsigned long long hot_chunks(
    unsigned long long len) {
  return len > (unsigned long long)kPlaceChunk
             ? (len + kPlaceChunk - 1) / kPlaceChunk
             : 0;
}

// Four entries of a warp's 128 at `base`, entries past `lim` as `fill`.
// Vector layout: lane l holds base + 4l + c (one 16-byte load; base is a
// multiple of 4 and src 16-byte aligned); scalar: base + 32c + l.
template <bool kVec>
__device__ __forceinline__ void load_quad(const int32_t* __restrict__ src,
                                          int64_t base, int64_t lim,
                                          int lane, int32_t fill, int32_t& a,
                                          int32_t& b, int32_t& c,
                                          int32_t& d) {
  if (kVec) {
    const int64_t e = base + 4 * lane;
    if (e + 4 <= lim) {
      const int4 q = *reinterpret_cast<const int4*>(src + e);
      a = q.x;
      b = q.y;
      c = q.z;
      d = q.w;
    } else {
      a = e < lim ? src[e] : fill;
      b = e + 1 < lim ? src[e + 1] : fill;
      c = e + 2 < lim ? src[e + 2] : fill;
      d = e + 3 < lim ? src[e + 3] : fill;
    }
  } else {
    const int64_t e = base + lane;
    a = e < lim ? src[e] : fill;
    b = e + 32 < lim ? src[e + 32] : fill;
    c = e + 64 < lim ? src[e + 64] : fill;
    d = e + 96 < lim ? src[e + 96] : fill;
  }
}

// The run of neighbouring lanes holding the same tile that this lane is
// in: its first lane and, on that lane (head), its length. Called by the
// whole warp. (A warp-wide match of equal tiles, __match_any_sync, made
// fewer atomics on a scattered stream but cost more than it saved.)
struct Run {
  bool head;
  int first, len;
};

__device__ __forceinline__ Run lane_run(int tile, int lane) {
  const int prev = __shfl_up_sync(kAll, tile, 1);
  const bool head = lane == 0 || prev != tile;
  const unsigned heads = __ballot_sync(kAll, head);
  const unsigned upto = lane == 31 ? kAll : (2u << lane) - 1;  // lanes <= lane
  const unsigned later = heads & ~upto;
  const int next = later ? __ffs(later) - 1 : 32;
  return Run{head, 31 - __clz(heads & upto), next - lane};
}

// Exclusive prefix of v over the CTA and the CTA's total, by the whole
// CTA (at most 32 warps); part is scratch of one slot a warp.
__device__ unsigned long long block_scan(unsigned long long v,
                                         unsigned long long* part,
                                         unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned long long x = v;  // inclusive over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < nwarps ? part[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(kAll, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) part[lane] = w;
  }
  __syncthreads();
  const unsigned long long out = x - v + (warp ? part[warp - 1] : 0);
  *total = part[nwarps - 1];
  __syncthreads();  // part is free again
  return out;
}

// The last count CTA: counters[0..tiles) from counts to the buckets'
// starts, and the prefix of the hot tiles' chunks (hot_chunks) by tile.
__device__ void scan_counts(const Tiles& p) {
  __shared__ unsigned long long part[kCountThreads / 32];
  unsigned long long* c = p.counters;
  unsigned long long* chunks = p.counters + p.tiles + 1;
  const int64_t len = p.tiles;
  const int64_t per = (len + blockDim.x - 1) / blockDim.x;
  const int64_t lo = min64((int64_t)threadIdx.x * per, len);
  const int64_t hi = min64(lo + per, len);
  unsigned long long sum = 0, hot = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const unsigned long long v = __ldcg(c + i);
    sum += v;
    hot += hot_chunks(v);
  }
  unsigned long long total;
  unsigned long long run = block_scan(sum, part, &total);
  unsigned long long hrun = block_scan(hot, part, &total);
  for (int64_t i = lo; i < hi; ++i) {
    const unsigned long long v = __ldcg(c + i);
    c[i] = run;
    chunks[i] = hrun;
    run += v;
    hrun += hot_chunks(v);
  }
  if (threadIdx.x == 0) chunks[len] = total;
}

// 1. count: entries per tile into counters[0..tiles); the last CTA scans.
// CTA b counts entries [b * count_span, (b + 1) * count_span), its warps
// 128 at a time (kCountQuads loads in flight a lane), into a shared
// histogram when the tiles fit one (kShared).
template <bool kVec, bool kShared>
__global__ void __launch_bounds__(kCountThreads) count_tiles(Tiles p) {
  extern __shared__ unsigned count_hist[];  // tiles, when kShared
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31;
  if (kShared) {
    for (int64_t i = t; i < p.tiles; i += blockDim.x) count_hist[i] = 0;
    __syncthreads();
  }
  const int64_t lim = min64((int64_t)(blockIdx.x + 1) * p.count_span, p.n);
  const int64_t stride = (int64_t)(blockDim.x >> 5) * 128 * kCountQuads;
  // the next round's loads are in flight while this round is counted
  int32_t g[4 * kCountQuads], next[4 * kCountQuads];
  int64_t w0 = (int64_t)blockIdx.x * p.count_span + (t >> 5) * 128;
#pragma unroll
  for (int j = 0; j < kCountQuads; ++j) {
    load_quad<kVec>(p.group, w0 + j * (stride / kCountQuads), lim, lane, -1,
                    next[4 * j], next[4 * j + 1], next[4 * j + 2],
                    next[4 * j + 3]);
  }
  for (; w0 < lim; w0 += stride) {
#pragma unroll
    for (int c = 0; c < 4 * kCountQuads; ++c) g[c] = next[c];
    if (w0 + stride < lim) {
#pragma unroll
      for (int j = 0; j < kCountQuads; ++j) {
        load_quad<kVec>(p.group, w0 + stride + j * (stride / kCountQuads),
                        lim, lane, -1, next[4 * j], next[4 * j + 1],
                        next[4 * j + 2], next[4 * j + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4 * kCountQuads; ++c) {
      const int tile = tile_of(g[c], p);
      const Run r = lane_run(tile, lane);
      if (r.head && tile >= 0) {
        if (kShared) {
          atomicAdd(count_hist + tile, (unsigned)r.len);
        } else {
          atomicAdd(p.counters + tile, (unsigned long long)r.len);
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int64_t i = t; i < p.tiles; i += blockDim.x) {
      const unsigned c = count_hist[i];
      if (c) atomicAdd(p.counters + i, (unsigned long long)c);
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    s_last = atomicAdd(p.counters + p.tiles, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    scan_counts(p);
  }
}

// The canvas of every hot tile to EMPTY, its CTA's share (tiles b, b +
// grid, ...): the hot tiles' chunks take their min into it later.
__device__ void empty_hot_tiles(const Tiles& p) {
  const unsigned long long* chunks = p.counters + p.tiles + 1;
  const int4 empty4 = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  for (int64_t t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    if (chunks[t + 1] == chunks[t]) continue;
    const int64_t g0 = t << p.shift;
    const int len = (int)min64((int64_t)1 << p.shift, p.num_groups - g0);
    int32_t* dst = p.canvas + g0;
    for (int i = threadIdx.x; i < len >> 2; i += blockDim.x) {
      reinterpret_cast<int4*>(dst)[i] = empty4;
    }
    for (int i = (len & ~3) + threadIdx.x; i < len; i += blockDim.x) {
      dst[i] = kEmpty;
    }
  }
}

// 2. partition: each kept entry to (offset, key) in its tile's bucket.
// CTA b holds entries [b * kPartChunk, (b + 1) * kPartChunk) in registers
// (warp w 32 * kPartSlots of them, as kPartSlots / 4 quads of load_quad).
// kShared: it ranks them per tile in shared memory, sorts them by tile
// there (a local counting sort: the exclusive scan of its histogram),
// reserves its run in each touched bucket with one global atomic per
// tile, and writes the sorted entries out, neighbouring threads to
// neighbouring slots of a run. Otherwise (more tiles than kHistMax) each
// run of lanes reserves its slots in the global cursor itself.
template <bool kVec, bool kShared>
__global__ void __launch_bounds__(kPartThreads) partition_tiles(Tiles p) {
  // kShared: delta[tiles] (u64), hist[tiles] (u32), stage[kPartChunk]
  extern __shared__ unsigned long long part_smem[];
  __shared__ unsigned long long part_scan[kPartThreads / 32];
  unsigned long long* delta = part_smem;
  unsigned* hist = reinterpret_cast<unsigned*>(part_smem + p.tiles);
  int2* stage = reinterpret_cast<int2*>(part_smem + p.tiles +
                                        (p.tiles + 1) / 2);
  const int t = threadIdx.x, lane = t & 31;
  if (kShared) {
    for (int64_t i = t; i < p.tiles; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  const int64_t w0 = ((int64_t)blockIdx.x * (kPartThreads / 32) + (t >> 5)) *
                     (32 * kPartSlots);
  const int32_t mask = (1 << p.shift) - 1;
  int32_t g[kPartSlots], k[kPartSlots];
  unsigned rank[kPartSlots];
#pragma unroll
  for (int j = 0; j < kPartSlots / 4; ++j) {
    const int64_t base = w0 + 128 * j;
    load_quad<kVec>(p.group, base, p.n, lane, -1, g[4 * j], g[4 * j + 1],
                    g[4 * j + 2], g[4 * j + 3]);
    load_quad<kVec>(p.key, base, p.n, lane, 0, k[4 * j], k[4 * j + 1],
                    k[4 * j + 2], k[4 * j + 3]);
  }
#pragma unroll
  for (int s = 0; s < kPartSlots; ++s) {
    const int tile = tile_of(g[s], p);
    const Run r = lane_run(tile, lane);
    if (kShared) {
      unsigned b = 0;
      if (r.head && tile >= 0) b = atomicAdd(hist + tile, (unsigned)r.len);
      rank[s] = __shfl_sync(kAll, b, r.first) + (unsigned)(lane - r.first);
    } else {
      unsigned long long b = 0;
      if (r.head && tile >= 0) {
        b = atomicAdd(p.counters + tile, (unsigned long long)r.len);
      }
      b = __shfl_sync(kAll, b, r.first) + (unsigned)(lane - r.first);
      if (tile >= 0) p.bucket[b] = make_int2(g[s] & mask, k[s]);
    }
  }
  if (kShared) {
    __syncthreads();
    // the histogram to local starts (a thread's segment of tiles in turn)
    const int64_t per = (p.tiles + blockDim.x - 1) / blockDim.x;
    const int64_t lo = min64((int64_t)t * per, p.tiles);
    const int64_t hi = min64(lo + per, p.tiles);
    unsigned long long sum = 0, kept;
    for (int64_t i = lo; i < hi; ++i) sum += hist[i];
    unsigned long long run = block_scan(sum, part_scan, &kept);
    for (int64_t i = lo; i < hi; ++i) {
      const unsigned c = hist[i];
      delta[i] = c;
      hist[i] = (unsigned)run;
      run += c;
    }
    __syncthreads();
    // the reservations, tiles dealt round the threads: the touched tiles
    // are often neighbours, and each atomic's answer is waited for
    for (int64_t i = t; i < p.tiles; i += blockDim.x) {
      const unsigned long long c = delta[i];
      // global slot of the CTA's sorted entry e of tile i: delta[i] + e
      if (c) delta[i] = atomicAdd(p.counters + i, c) - hist[i];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kPartSlots; ++s) {
      const int tile = tile_of(g[s], p);
      if (tile >= 0) stage[hist[tile] + rank[s]] = make_int2(g[s], k[s]);
    }
    __syncthreads();
    for (int e = t; e < (int)kept; e += blockDim.x) {
      const int2 v = stage[e];
      p.bucket[delta[v.x >> p.shift] + e] = make_int2(v.x & mask, v.y);
    }
  }
  empty_hot_tiles(p);
}

// A lane's two bucket entries into the window: equal offsets merge in the
// lane, then the lanes' second entries by the segmented min of
// csrc/minwin.cu (the first lane of each run of equal offsets places it).
// Offset -1: no entry. Called by the whole warp.
__device__ __forceinline__ void place_pair(int o0, int32_t k0, int o1,
                                           int32_t k1, int lane,
                                           int32_t* window) {
  if (o0 == o1) {
    k1 = min(k0, k1);
  } else if (o0 >= 0) {
    atomicMin(window + o0, k0);
  }
  const int next = __shfl_down_sync(kAll, o1, 1);
  if (__any_sync(kAll, lane < 31 && next == o1 && o1 >= 0)) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int og = __shfl_down_sync(kAll, o1, d);
      const int32_t ok = __shfl_down_sync(kAll, k1, d);
      if (lane + d < 32 && og == o1) k1 = min(k1, ok);
    }
    const int prev = __shfl_up_sync(kAll, o1, 1);
    if (o1 >= 0 && (lane == 0 || prev != o1)) atomicMin(window + o1, k1);
  } else if (o1 >= 0) {
    atomicMin(window + o1, k1);
  }
}

// Entries 2q and 2q + 1 of the bucket, those outside [begin, end) as
// offset -1; one 16-byte load when both are inside.
__device__ __forceinline__ void load_pair(const int2* __restrict__ bucket,
                                          int64_t q, int64_t begin,
                                          int64_t end, int& o0, int32_t& k0,
                                          int& o1, int32_t& k1) {
  const int64_t e = 2 * q;
  o0 = o1 = -1;
  k0 = k1 = 0;
  if (e >= begin && e + 1 < end) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(bucket) + q);
    o0 = v.x;
    k0 = v.y;
    o1 = v.z;
    k1 = v.w;
    return;
  }
  if (e >= begin && e < end) {
    const int2 v = __ldcs(bucket + e);
    o0 = v.x;
    k0 = v.y;
  }
  if (e + 1 >= begin && e + 1 < end) {
    const int2 v = __ldcs(bucket + e + 1);
    o1 = v.x;
    k1 = v.y;
  }
}

// 3. place. CTA b < tiles owns groups [b * T, b * T + T): a cold bucket
// (at most kPlaceChunk entries) is placed into an EMPTY window in shared
// memory and the window written to the canvas with 16-byte streaming
// stores. A hot bucket is left to CTAs tiles + j, one per chunk j of the
// hot tiles (the chunk prefix maps j to its tile): each places its chunk
// into a window of its own and takes the min into the canvas, which the
// partition pass set to EMPTY, with one global atomicMin per slot that is
// not EMPTY (a pile-up of a few groups flushes a few slots). So the hot
// tiles' chunks run beside the cold tiles, in the same launch.
__global__ void __launch_bounds__(kPlaceThreads) place_tiles(Tiles p) {
  extern __shared__ int4 place_window[];  // T int32
  __shared__ int64_t s_tile;
  const unsigned long long* chunks = p.counters + p.tiles + 1;
  const int64_t b = blockIdx.x;
  int64_t tile, begin;
  if (b < p.tiles) {
    if (chunks[b + 1] != chunks[b]) return;  // hot: its chunks place it
    tile = b;
    begin = b ? (int64_t)p.counters[b - 1] : 0;
  } else {
    const unsigned long long j = b - p.tiles;
    if (j >= chunks[p.tiles]) return;  // the grid is an upper bound
    if (threadIdx.x == 0) {  // the last tile whose prefix is <= j
      int64_t lo = 0, hi = p.tiles - 1;
      while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        if (chunks[mid] <= j) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      s_tile = lo;
    }
    __syncthreads();
    tile = s_tile;
    begin = (tile ? (int64_t)p.counters[tile - 1] : 0) +
            (int64_t)(j - chunks[tile]) * kPlaceChunk;
  }
  const int64_t end = min64((int64_t)p.counters[tile], begin + kPlaceChunk);
  int32_t* window = reinterpret_cast<int32_t*>(place_window);
  const int4 empty4 = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  for (int i = threadIdx.x; i < (1 << p.shift) / 4; i += blockDim.x) {
    place_window[i] = empty4;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)(blockDim.x >> 5) * 32 * kPlacePairs;
  // A warp takes 32 kPlacePairs pairs a round (lane l pairs q0 + 32 i + l),
  // all loaded before any is placed, and the next round's loads are in
  // flight while this round is placed.
  const int64_t q_end = (end + 1) >> 1;
  int64_t q0 = (begin >> 1) + (threadIdx.x >> 5) * 32 * kPlacePairs;
  int o[2 * kPlacePairs], no[2 * kPlacePairs];
  int32_t k[2 * kPlacePairs], nk[2 * kPlacePairs];
#pragma unroll
  for (int i = 0; i < kPlacePairs; ++i) {
    load_pair(p.bucket, q0 + 32 * i + lane, begin, end, no[2 * i], nk[2 * i],
              no[2 * i + 1], nk[2 * i + 1]);
  }
  for (; q0 < q_end; q0 += step) {
#pragma unroll
    for (int i = 0; i < 2 * kPlacePairs; ++i) {
      o[i] = no[i];
      k[i] = nk[i];
    }
    if (q0 + step < q_end) {
#pragma unroll
      for (int i = 0; i < kPlacePairs; ++i) {
        load_pair(p.bucket, q0 + step + 32 * i + lane, begin, end,
                  no[2 * i], nk[2 * i], no[2 * i + 1], nk[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPlacePairs; ++i) {
      place_pair(o[2 * i], k[2 * i], o[2 * i + 1], k[2 * i + 1], lane, window);
    }
  }
  __syncthreads();
  const int64_t g0 = tile << p.shift;
  const int len = (int)min64((int64_t)1 << p.shift, p.num_groups - g0);
  int32_t* dst = p.canvas + g0;
  if (b < p.tiles) {
    for (int i = threadIdx.x; i < len >> 2; i += blockDim.x) {
      __stcs(reinterpret_cast<int4*>(dst) + i, place_window[i]);
    }
    for (int i = (len & ~3) + threadIdx.x; i < len; i += blockDim.x) {
      dst[i] = window[i];
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int32_t v = window[i];
      if (v != kEmpty) atomicMin(dst + i, v);
    }
  }
}

// More than 48 KB of dynamic shared memory must be allowed per kernel
// and device: once, for the most that kernel asks.
cudaError_t allow_shared(const void* kernel, int slot, size_t bytes,
                         size_t most) {
  static uint64_t raised[8];  // per kernel, a bit per device (64 at most)
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (raised[slot] & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
  if (err == cudaSuccess) raised[slot] |= bit;
  return err;
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

// canvas[g] = min over entries i with group[i] == g of key[i], else EMPTY,
// by the tile-owned passes (see the note at the top). The host's plan
// (kernels/placement.py::place_min_plan) gives tile_shift (2..15),
// count_ctas (>= 1 when n > 0) and part_ctas (n / kPartChunk, rounded
// up); the place pass takes tiles + 2 (n / kPlaceChunk) CTAs, enough for
// every chunk of the hot tiles. bucket holds n x 8 bytes (16-byte
// aligned), counters 2 tiles + 2 x 8 bytes, canvas num_groups int32
// (16-byte aligned). Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for arguments the kernels cannot take.
extern "C" int place_min(const void* group, const void* key, int64_t n,
                         void* canvas, int64_t num_groups, int tile_shift,
                         int count_ctas, int64_t part_ctas, void* bucket,
                         void* counters, void* stream) {
  if (n < 0 || num_groups <= 0 || num_groups >= ((int64_t)1 << 31) ||
      tile_shift < kMinTileShift || tile_shift > kMaxTileShift ||
      part_ctas != (n + kPartChunk - 1) / kPartChunk ||
      (n > 0 && count_ctas < 1) || ((uintptr_t)canvas & 15) ||
      ((uintptr_t)bucket & 15) || ((uintptr_t)counters & 7)) {
    return (int)cudaErrorInvalidValue;
  }
  Tiles p;
  p.group = static_cast<const int32_t*>(group);
  p.key = static_cast<const int32_t*>(key);
  p.n = n;
  p.shift = tile_shift;
  p.tiles = (num_groups + ((int64_t)1 << tile_shift) - 1) >> tile_shift;
  p.num_groups = (int32_t)num_groups;
  p.bucket = static_cast<int2*>(bucket);
  p.counters = static_cast<unsigned long long*>(counters);
  p.canvas = static_cast<int32_t*>(canvas);
  // whole rounds of a count CTA's warps: 16-byte loads stay aligned
  const int64_t round = (int64_t)(kCountThreads / 32) * 128 * kCountQuads;
  p.count_span = n > 0 ? ((n + count_ctas - 1) / count_ctas + round - 1) /
                             round * round
                       : 0;
  const int64_t place_ctas = p.tiles + 2 * (n / kPlaceChunk);
  if (place_ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counters, 0, (size_t)(2 * p.tiles + 2) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const bool shared = p.tiles <= kHistMax;
    const bool vec_g = ((uintptr_t)group & 15) == 0;
    const bool vec = vec_g && ((uintptr_t)key & 15) == 0;
    auto count = vec_g ? (shared ? count_tiles<true, true>
                                 : count_tiles<true, false>)
                       : (shared ? count_tiles<false, true>
                                 : count_tiles<false, false>);
    auto part = vec ? (shared ? partition_tiles<true, true>
                              : partition_tiles<true, false>)
                    : (shared ? partition_tiles<false, true>
                              : partition_tiles<false, false>);
    // delta (8 bytes a tile), hist (4), stage (8 an entry)
    auto part_bytes = [](int64_t tiles) {
      return (size_t)(tiles + (tiles + 1) / 2 + kPartChunk) * 8;
    };
    const size_t count_smem = shared ? (size_t)p.tiles * 4 : 0;
    const size_t part_smem = shared ? part_bytes(p.tiles) : 0;
    err = allow_shared((const void*)part, vec ? 0 : 1, part_smem,
                       part_bytes(kHistMax));
    if (err != cudaSuccess) return (int)err;
    count<<<count_ctas, kCountThreads, count_smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    part<<<(unsigned)part_ctas, kPartThreads, part_smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t window = sizeof(int32_t) << tile_shift;
  err = allow_shared((const void*)place_tiles, 2, window,
                     sizeof(int32_t) << kMaxTileShift);
  if (err != cudaSuccess) return (int)err;
  place_tiles<<<(unsigned)place_ctas, kPlaceThreads, window, s>>>(p);
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
