// The port's frame decoder: PNG -> RGB -> resize to 1024x512 -> one 512-wide
// half -> resize to the frame size, uint8 throughout, with no OpenCV.
//
// It is the counterpart of native/videoload.cc (cv::imread, cv::cvtColor,
// cv::resize INTER_LINEAR twice) and gives the same bytes: the PNG is decoded
// exactly, and the resize follows OpenCV's uint8 rules (imgproc/resize.cpp):
//   * equal sizes copy;
//   * an exact 2x downscale in both directions is INTER_AREA's fast path,
//     the mean of each 2x2 block rounded with +2 (a 1024x512 RealVSR frame's
//     512 -> 256 step);
//   * otherwise INTER_LINEAR in fixed point: 11-bit coefficients from
//     half-pixel centres, the horizontal pass exact in int32, the vertical
//     pass rounded in two stages as OpenCV's SIMD loop rounds it (each row
//     >> 4, the high half of its product with the coefficient, then
//     (sum + 2) >> 2), on every element of the row: the one-stage rounding
//     of OpenCV's scalar loop, (sum + 2^21) >> 22, differs from it, and held
//     against libopencv 4.6 (native/libvideoload.so) at random sizes, every
//     element, the row's last ones included, takes the two-stage path.
//
// The inflate is not here: the caller hands over the IDAT stream already
// inflated (Python's zlib releases the GIL while it inflates), so this file
// needs no header beyond the standard library. Every entry point is plain C,
// bound with ctypes, and touches no Python object.
//
//   rovr_png_chunks(data, n, info, idat, cap, palette) -> IDAT bytes or < 0
//   rovr_png_decode_half(raw, n, info, palette, half, out_h, out_w, out) -> 0 or < 0
//   rovr_png_unfilter_rgb(raw, n, info, palette, rgb) -> 0 or < 0

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Error codes, named in rovr_torch/data/native_loader.py.
enum {
  ERR_SIGNATURE = -1,   // not a PNG
  ERR_TRUNCATED = -2,   // a chunk runs past the end of the file
  ERR_IHDR = -3,        // IHDR missing, not first, or malformed
  ERR_DEPTH16 = -4,     // 16 bits per sample
  ERR_DEPTH = -5,       // 1, 2 or 4 bits per sample
  ERR_INTERLACE = -6,   // Adam7 interlacing
  ERR_COLOR = -7,       // an unknown color type or compression/filter method
  ERR_PALETTE = -8,     // palette missing, too long, or an index past its end
  ERR_DATA = -9,        // fewer inflated bytes than the rows need
  ERR_FILTER = -10,     // a row filter type above 4
  ERR_CAPACITY = -11,   // IDAT longer than the caller's buffer
};

// info[] slots shared with the Python side.
enum { I_W = 0, I_H, I_DEPTH, I_COLOR, I_NPAL, I_COUNT };

constexpr int kCoefBits = 11;                  // INTER_RESIZE_COEF_BITS
constexpr int kCoefScale = 1 << kCoefBits;     // INTER_RESIZE_COEF_SCALE

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int channels_of(int color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

// Undo the row filters of h rows of `stride` bytes (each led by its filter
// type byte) and write the image as packed RGB: gray is repeated, a palette
// index looked up, alpha dropped (cv::IMREAD_COLOR strips it).
int unfilter_rgb(const uint8_t* raw, int64_t n, const int* info,
                 const uint8_t* palette, uint8_t* rgb) {
  const int w = info[I_W], h = info[I_H], color = info[I_COLOR], npal = info[I_NPAL];
  const int bpp = channels_of(color);
  const int64_t stride = int64_t(w) * bpp;
  if (n < int64_t(h) * (stride + 1)) return ERR_DATA;
  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = raw + int64_t(y) * (stride + 1);
    const int filter = row[0];
    const uint8_t* in = row + 1;
    switch (filter) {
      case 0:
        std::memcpy(cur.data(), in, stride);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i) cur[i] = uint8_t(in[i] + prev[i]);
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = uint8_t(in[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int upleft = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = uint8_t(in[i] + paeth(left, prev[i], upleft));
        }
        break;
      default:
        return ERR_FILTER;
    }
    uint8_t* out = rgb + int64_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = cur.data() + int64_t(x) * bpp;
      uint8_t* o = out + int64_t(x) * 3;
      if (color == 2 || color == 6) {
        o[0] = px[0]; o[1] = px[1]; o[2] = px[2];
      } else if (color == 3) {
        if (px[0] >= npal) return ERR_PALETTE;
        std::memcpy(o, palette + 3 * px[0], 3);
      } else {
        o[0] = o[1] = o[2] = px[0];
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

uint8_t sat_u8(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }
int16_t sat_s16(int v) { return int16_t(v < -32768 ? -32768 : (v > 32767 ? 32767 : v)); }
int16_t mul_hi(int16_t a, int16_t b) { return int16_t((int32_t(a) * b) >> 16); }

// One output element of the vertical pass as OpenCV's SIMD loop
// (VResizeLinearVec_32s8u) computes it from two horizontal-pass values.
uint8_t vlinear(int s0, int s1, int16_t b0, int16_t b1) {
  int16_t t = sat_s16(mul_hi(sat_s16(s0 >> 4), b0) + mul_hi(sat_s16(s1 >> 4), b1));
  return sat_u8(sat_s16(t + 2) >> 2);
}

// Linear-interpolation taps of one axis: source index and two 11-bit
// coefficients per destination index (resize.cpp's xofs/ialpha, yofs/ibeta).
// `clamp` pins the taps past either edge to the edge pixel with weight 1,
// as the horizontal axis does; the vertical axis clamps rows instead.
void taps(int src, int dst, bool clamp, std::vector<int>& ofs, std::vector<int16_t>& coef) {
  const double scale = 1. / (double(dst) / src);
  ofs.resize(dst);
  coef.resize(2 * dst);
  for (int d = 0; d < dst; ++d) {
    float f = float((d + 0.5) * scale - 0.5);
    int s = int(std::floor(f));
    f -= s;
    if (clamp && s < 0) { f = 0.f; s = 0; }
    if (clamp && s >= src - 1) { f = 0.f; s = src - 1; }
    ofs[d] = s;
    coef[2 * d] = int16_t(std::lrint((1.f - f) * kCoefScale));
    coef[2 * d + 1] = int16_t(std::lrint(f * kCoefScale));
  }
}

void resize_rgb(const uint8_t* src, int sh, int sw, int sstride,
                uint8_t* dst, int dh, int dw) {
  const int cn = 3;
  if (sh == dh && sw == dw) {
    for (int y = 0; y < dh; ++y)
      std::memcpy(dst + int64_t(y) * dw * cn, src + int64_t(y) * sstride, size_t(dw) * cn);
    return;
  }
  const double scale_x = 1. / (double(dw) / sw), scale_y = 1. / (double(dh) / sh);
  const bool area2 = std::fabs(scale_x - 2.0) < DBL_EPSILON && std::fabs(scale_y - 2.0) < DBL_EPSILON;
  if (area2) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = src + int64_t(2 * y) * sstride;
      const uint8_t* r1 = r0 + sstride;
      uint8_t* o = dst + int64_t(y) * dw * cn;
      for (int x = 0; x < dw; ++x)
        for (int c = 0; c < cn; ++c) {
          const int i = 2 * x * cn + c;
          o[x * cn + c] = uint8_t((r0[i] + r0[i + cn] + r1[i] + r1[i + cn] + 2) >> 2);
        }
    }
    return;
  }
  std::vector<int> xofs, yofs;
  std::vector<int16_t> alpha, beta;
  taps(sw, dw, true, xofs, alpha);
  taps(sh, dh, false, yofs, beta);
  const int width = dw * cn;

  std::vector<int> r0(width), r1(width);
  auto hrow = [&](int sy, std::vector<int>& out) {
    const uint8_t* s = src + int64_t(sy) * sstride;
    for (int dx = 0; dx < dw; ++dx) {
      const int sx = xofs[dx] * cn;
      const int a0 = alpha[2 * dx], a1 = alpha[2 * dx + 1];
      for (int c = 0; c < cn; ++c) {
        const int v1 = a1 != 0 ? s[sx + cn + c] : 0;  // a1 is 0 at the right edge
        out[dx * cn + c] = s[sx + c] * a0 + v1 * a1;
      }
    }
  };
  for (int dy = 0; dy < dh; ++dy) {
    hrow(std::clamp(yofs[dy], 0, sh - 1), r0);
    hrow(std::clamp(yofs[dy] + 1, 0, sh - 1), r1);
    const int16_t b0 = beta[2 * dy], b1 = beta[2 * dy + 1];
    uint8_t* o = dst + int64_t(dy) * width;
    for (int x = 0; x < width; ++x) o[x] = vlinear(r0[x], r1[x], b0, b1);
  }
}

}  // namespace

extern "C" {

// Check the signature and IHDR of the PNG in data[0, n), fill info (width,
// height, bit depth, color type, palette entries), copy PLTE into palette
// (768 bytes) and the IDAT chunks, concatenated, into idat (cap bytes).
// Returns the IDAT byte count, or an error code < 0.
int64_t rovr_png_chunks(const uint8_t* data, int64_t n, int* info, uint8_t* idat,
                        int64_t cap, uint8_t* palette) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (n < 8 || std::memcmp(data, kSig, 8) != 0) return ERR_SIGNATURE;
  std::memset(info, 0, sizeof(int) * I_COUNT);
  int64_t pos = 8, got = 0;
  bool seen_ihdr = false;
  while (true) {
    if (pos + 12 > n) return ERR_TRUNCATED;
    const int64_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + len > n) return ERR_TRUNCATED;
    if (!seen_ihdr && std::memcmp(type, "IHDR", 4) != 0) return ERR_IHDR;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (seen_ihdr || len != 13) return ERR_IHDR;
      seen_ihdr = true;
      info[I_W] = int(be32(body));
      info[I_H] = int(be32(body + 4));
      info[I_DEPTH] = body[8];
      info[I_COLOR] = body[9];
      if (info[I_W] <= 0 || info[I_H] <= 0 || info[I_W] > (1 << 16) || info[I_H] > (1 << 16))
        return ERR_IHDR;
      if (channels_of(info[I_COLOR]) == 0 || body[10] != 0 || body[11] != 0) return ERR_COLOR;
      if (info[I_DEPTH] == 16) return ERR_DEPTH16;
      if (info[I_DEPTH] != 8) return ERR_DEPTH;
      if (body[12] != 0) return ERR_INTERLACE;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len > 768) return ERR_PALETTE;
      std::memcpy(palette, body, len);
      info[I_NPAL] = int(len / 3);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (got + len > cap) return ERR_CAPACITY;
      std::memcpy(idat + got, body, len);
      got += len;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (info[I_COLOR] == 3 && info[I_NPAL] == 0) return ERR_PALETTE;
  return got;
}

// The inflated IDAT stream raw[0, n) of the image `info` describes ->
// packed RGB (h, w, 3) in rgb.
int rovr_png_unfilter_rgb(const uint8_t* raw, int64_t n, const int* info,
                          const uint8_t* palette, uint8_t* rgb) {
  return unfilter_rgb(raw, n, info, palette, rgb);
}

// The inflated IDAT stream -> RGB -> 1024x512 -> the left (half 0) or right
// (half 1) 512x512 -> out (out_h, out_w, 3): videoload.cc's decode_half_impl.
int rovr_png_decode_half(const uint8_t* raw, int64_t n, const int* info,
                         const uint8_t* palette, int half, int out_h, int out_w,
                         uint8_t* out) {
  const int w = info[I_W], h = info[I_H];
  std::vector<uint8_t> rgb(size_t(w) * h * 3);
  const int rc = unfilter_rgb(raw, n, info, palette, rgb.data());
  if (rc != 0) return rc;
  std::vector<uint8_t> full(size_t(1024) * 512 * 3);
  resize_rgb(rgb.data(), h, w, w * 3, full.data(), 512, 1024);
  resize_rgb(full.data() + (half == 0 ? 0 : 512 * 3), 512, 512, 1024 * 3, out, out_h, out_w);
  return 0;
}

}  // extern "C"
