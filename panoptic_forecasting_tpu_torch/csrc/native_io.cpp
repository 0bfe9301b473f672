// Host IO of the port: the PNG row filters, the label LUT, the Cityscapes
// depth and disparity codecs and the nearest label resize.
//
// Counterpart of the JAX package's native library (libpng + zlib behind a
// C ABI, in the repo's root native/ directory). The port links neither:
// Python's zlib inflates and deflates (it releases the interpreter lock
// while it does), and this file does the byte work around it that numpy
// cannot vectorise: undoing the Average and Paeth filters, whose every
// byte depends on the byte to its left, and libpng's per-row filter choice
// when writing. The pixel transforms compute what the JAX C functions of
// the same name compute, in the same float32 operations, so their results
// are bitwise equal.
//
// Plain C ABI, loaded with ctypes (which releases the interpreter lock for
// the call, so threads decode files in parallel). Only the C++ standard
// library is included. Every function returns 0 or a negative code and
// never throws across the ABI.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// libpng's PNG_FILTER_* mask bits, NONE to PAETH
constexpr int kMaskNone = 0x08, kMaskSub = 0x10, kMaskUp = 0x20,
              kMaskAvg = 0x40, kMaskPaeth = 0x80, kMaskAll = 0xF8;

inline int paeth(int a, int b, int c) {
  // |p - a|, |p - b|, |p - c| with p = a + b - c
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// The prediction of filter `kind` (1-4) for byte i of a row: left a, up b,
// up-left c, each 0 off the image.
inline int predict(int kind, int a, int b, int c) {
  switch (kind) {
    case 1: return a;
    case 2: return b;
    case 3: return (a + b) >> 1;
    default: return paeth(a, b, c);
  }
}

// Row `out` filtered with `kind` from the unfiltered `row` and `prior` (the
// row above, unfiltered; zeros for the first row).
void filter_row(int kind, const uint8_t* row, const uint8_t* prior,
                int64_t stride, int bpp, uint8_t* out) {
  if (kind == 0) {
    std::memcpy(out, row, stride);
    return;
  }
  for (int64_t i = 0; i < stride; ++i) {
    const int a = i >= bpp ? row[i - bpp] : 0;
    const int c = i >= bpp ? prior[i - bpp] : 0;
    out[i] = static_cast<uint8_t>(row[i] - predict(kind, a, prior[i], c));
  }
}

// libpng's row cost: the filtered bytes read as signed magnitudes.
uint64_t row_cost(const uint8_t* f, int64_t stride) {
  uint64_t sum = 0;
  for (int64_t i = 0; i < stride; ++i) sum += f[i] < 128 ? f[i] : 256 - f[i];
  return sum;
}

}  // namespace

extern "C" {

// Undo the row filters of one pass: `in` holds `rows` rows of a filter
// byte and `stride` bytes, `out` receives rows x stride bytes. bpp is the
// filters' byte distance, max(1, bits per pixel / 8). -1 on a filter byte
// above 4, -2 on a bad size, -4 when the row of zeros cannot be allocated.
int pf_png_unfilter(const uint8_t* in, int64_t rows, int64_t stride,
                    int32_t bpp, uint8_t* out) try {
  if (rows < 0 || stride < 0 || bpp < 1) return -2;
  std::vector<uint8_t> zeros(stride, 0);
  const uint8_t* prior = zeros.data();
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t kind = in[r * (stride + 1)];
    const uint8_t* src = in + r * (stride + 1) + 1;
    uint8_t* dst = out + r * stride;
    const int64_t head = bpp < stride ? bpp : stride;  // bytes with no left
    switch (kind) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        std::memcpy(dst, src, head);
        for (int64_t i = head; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + dst[i - bpp]);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + prior[i]);
        break;
      case 3:
        for (int64_t i = 0; i < head; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (prior[i] >> 1));
        for (int64_t i = head; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + ((dst[i - bpp] + prior[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < head; ++i)  // paeth(0, b, 0) is b
          dst[i] = static_cast<uint8_t>(src[i] + prior[i]);
        for (int64_t i = head; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(
              src[i] + paeth(dst[i - bpp], prior[i], prior[i - bpp]));
        break;
      default:
        return -1;
    }
    prior = dst;
  }
  return 0;
} catch (...) {
  return -4;
}

// Filter rows x stride bytes for writing into rows x (1 + stride) bytes,
// as libpng 1.6 does after png_set_filter(filters) (or with -1, without
// it). libpng keeps the low byte of `filters` as its mask (0x08 NONE ...
// 0x80 PAETH; a value of 5-7 is its error, -3 here) and reads an empty
// mask as all five filters. A one-row image drops UP, AVG and PAETH, a
// one-column image SUB, AVG and PAETH, and a mask left empty is NONE. One
// filter of the mask is applied to every row, none is NONE; of several,
// each row takes the one whose bytes, read as signed magnitudes, sum
// least (the first in NONE..PAETH order on a tie). *used receives the mask
// (libpng deflates with Z_FILTERED unless it is NONE alone). -2 on a bad
// size, -4 when its row buffers cannot be allocated.
int pf_png_filter(const uint8_t* raw, int64_t rows, int64_t stride,
                  int32_t bpp, int32_t width, int32_t filters, uint8_t* out,
                  int32_t* used) try {
  if (rows < 0 || stride < 0 || bpp < 1) return -2;
  int mask = filters < 0 ? 0 : filters & 0xFF;
  if (mask >= 5 && mask <= 7) return -3;
  if (mask == 0) mask = kMaskAll;
  if (rows == 1) mask &= ~(kMaskUp | kMaskAvg | kMaskPaeth);
  if (width == 1) mask &= ~(kMaskSub | kMaskAvg | kMaskPaeth);
  if (mask == 0) mask = kMaskNone;
  *used = mask;

  int kinds[5] = {0}, n = 0;
  for (int k = 0; k < 5; ++k)
    if (mask & (kMaskNone << k)) kinds[n++] = k;
  if (n == 0) n = 1;  // no filter bit: NONE
  std::vector<uint8_t> zeros(stride, 0), trial(n > 1 ? stride : 0);
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* row = raw + r * stride;
    const uint8_t* prior = r > 0 ? row - stride : zeros.data();
    uint8_t* dst = out + r * (stride + 1);
    dst[0] = static_cast<uint8_t>(kinds[0]);
    filter_row(kinds[0], row, prior, stride, bpp, dst + 1);
    if (n == 1) continue;
    uint64_t best = row_cost(dst + 1, stride);
    for (int j = 1; j < n; ++j) {
      filter_row(kinds[j], row, prior, stride, bpp, trial.data());
      const uint64_t cost = row_cost(trial.data(), stride);
      if (cost < best) {
        best = cost;
        dst[0] = static_cast<uint8_t>(kinds[j]);
        std::memcpy(dst + 1, trial.data(), stride);
      }
    }
  }
  return 0;
} catch (...) {
  return -4;
}

// In-place 256-entry LUT relabel over uint8 ids (trainId <-> labelId).
int pf_lut_u8(uint8_t* data, int64_t n, const uint8_t* lut) {
  for (int64_t i = 0; i < n; ++i) data[i] = lut[data[i]];
  return 0;
}

// Cityscapes depth PNG: depth p / 256 - 1, p = 0 invalid (depth -1).
int pf_decode_depth_png_u16(const uint16_t* png, int64_t n, float* depth,
                            uint8_t* valid) {
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t p = png[i];
    valid[i] = p > 0;
    depth[i] = p > 0 ? (static_cast<float>(p) / 256.0f - 1.0f) : -1.0f;
  }
  return 0;
}

// Cityscapes disparity PNG: disparity (p - 1) / 256, p = 0 invalid;
// depth baseline * fx / disparity, -1 where invalid or not positive.
int pf_disparity_to_depth_u16(const uint16_t* png, int64_t n,
                              float baseline_fx, float* depth,
                              uint8_t* valid) {
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t p = png[i];
    const float disp = (static_cast<float>(p) - 1.0f) / 256.0f;
    const bool ok = p > 0 && disp > 0.0f;
    valid[i] = ok;
    depth[i] = ok ? baseline_fx / disp : -1.0f;
  }
  return 0;
}

// Nearest resize of a uint8 label map by Pillow's NEAREST rule: source index
// (int)((y + 0.5) * sh / dh) in float32, clamped to the last row (columns
// alike). Not OpenCV's INTER_NEAREST rule, which data/transforms.py uses.
int pf_resize_nearest_u8(const uint8_t* src, int32_t sh, int32_t sw,
                         uint8_t* dst, int32_t dh, int32_t dw) {
  if (sh < 1 || sw < 1 || dh < 0 || dw < 0) return -2;
  for (int32_t y = 0; y < dh; ++y) {
    int32_t sy = static_cast<int32_t>((y + 0.5f) * sh / dh);
    if (sy >= sh) sy = sh - 1;
    const uint8_t* srow = src + static_cast<int64_t>(sy) * sw;
    uint8_t* drow = dst + static_cast<int64_t>(y) * dw;
    for (int32_t x = 0; x < dw; ++x) {
      int32_t sx = static_cast<int32_t>((x + 0.5f) * sw / dw);
      if (sx >= sw) sx = sw - 1;
      drow[x] = srow[sx];
    }
  }
  return 0;
}

}  // extern "C"
