// JPEG region-of-interest decode and the SPIN crop sampler of the
// port's host data path (spec_tpu_torch/data/transforms.py,
// data/cam_dataset.py, data/region_cache.py). A copy of the JAX
// package's spec_tpu/native/jpegroi.cpp.
//
// libjpeg-turbo's partial-decode API (jpeg_crop_scanline +
// jpeg_skip_scanlines) decodes ONLY the scanline window a crop samples:
// IDCT, upsampling and color conversion are skipped outside the window
// (the entropy pass over the preceding rows remains, so the saving
// depends on the window's position and size).
//
// Entry points (C ABI for ctypes, bound in spec_tpu_torch/native.py):
//   jpeg_probe       header-only dims + EXIF orientation + progressive
//   jpeg_decode_roi  decode a scaled window into a caller buffer (the
//                    region-cache fill path)
//   jpeg_roi_crop    fused decode + affine bilinear crop -> float32
//   crop_affine_u8   the same crop sampler over an in-memory uint8
//                    strip (frame-cache / region-cache hit paths)
//
// Pixel parity: this links the system libjpeg-turbo, the decoder cv2
// uses, so the ROI window equals the same slice of a full cv2.imread
// decode bit for bit.
//
// EXIF: cv2.imread APPLIES EXIF orientation; this decoder does not.
// jpeg_probe reports the orientation tag so Python callers take the cv2
// path for orientation != 1.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void swallow_message(j_common_ptr, int) {}

// Parse the EXIF orientation tag (0x0112) out of a saved APP1 marker.
// Minimal TIFF IFD0 walk with bounds checks; returns 1 (top-left)
// when absent or malformed.
int exif_orientation(const jpeg_decompress_struct& cinfo) {
  for (jpeg_saved_marker_ptr m = cinfo.marker_list; m; m = m->next) {
    if (m->marker != JPEG_APP0 + 1 || m->data_length < 14) continue;
    const uint8_t* d = m->data;
    if (std::memcmp(d, "Exif\0\0", 6) != 0) continue;
    const uint8_t* tiff = d + 6;
    const size_t n = m->data_length - 6;
    if (n < 8) continue;
    bool le;
    if (tiff[0] == 'I' && tiff[1] == 'I') le = true;
    else if (tiff[0] == 'M' && tiff[1] == 'M') le = false;
    else continue;
    auto rd16 = [&](size_t off) -> uint32_t {
      return le ? tiff[off] | (tiff[off + 1] << 8)
                : (tiff[off] << 8) | tiff[off + 1];
    };
    auto rd32 = [&](size_t off) -> uint32_t {
      return le ? tiff[off] | (tiff[off + 1] << 8) |
                      (tiff[off + 2] << 16) |
                      (static_cast<uint32_t>(tiff[off + 3]) << 24)
                : (static_cast<uint32_t>(tiff[off]) << 24) |
                      (tiff[off + 1] << 16) | (tiff[off + 2] << 8) |
                      tiff[off + 3];
    };
    if (rd16(2) != 42) continue;
    uint32_t ifd = rd32(4);
    if (ifd + 2 > n) continue;
    uint32_t count = rd16(ifd);
    for (uint32_t i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > n) break;
      if (rd16(e) == 0x0112 && rd16(e + 2) == 3 /* SHORT */) {
        uint32_t v = rd16(e + 8);
        return (v >= 1 && v <= 8) ? static_cast<int>(v) : 1;
      }
    }
  }
  return 1;
}

// Start a decompress at 1/reduce scale; 0 on success.
int open_scaled(jpeg_decompress_struct* c, ErrMgr* err,
                const uint8_t* bytes, long n, int reduce,
                bool save_exif) {
  c->err = jpeg_std_error(&err->pub);
  err->pub.error_exit = on_error;
  err->pub.emit_message = swallow_message;
  if (setjmp(err->jb)) {
    jpeg_destroy_decompress(c);
    return 1;
  }
  jpeg_create_decompress(c);
  jpeg_mem_src(c, const_cast<uint8_t*>(bytes),
               static_cast<unsigned long>(n));
  if (save_exif) jpeg_save_markers(c, JPEG_APP0 + 1, 0xFFFF);
  jpeg_read_header(c, TRUE);
  c->out_color_space = JCS_RGB;
  c->scale_num = 1;
  c->scale_denom = reduce;
  return 0;
}

// Decode rows [y0, y0+h) of the x-window [*x0, *x0+*w) at 1/reduce
// scale into `strip` (row stride = stride_px * 3). jpeg_crop_scanline
// aligns the window outward to iMCU boundaries; actual *x0/*w are
// written back. Caller guarantees stride_px >= aligned width (align
// requested x0 down / x1 up by 16+margin and the result always fits).
// The requested window is silently widened by an 8 px margin each side
// (clamped to the image): the fancy chroma upsampler lacks context at
// the cropped window's edges, perturbing the outermost 1-2 columns by
// up to ~6/255 (measured) — the margin puts those columns outside the
// window the caller reads, making in-window pixels BIT-IDENTICAL to a
// full decode. Vertical skips have no such artifact (verified).
// Returns 0 on success.
int decode_roi(const uint8_t* bytes, long n, int reduce, int* x0, int* w,
               int y0, int h, uint8_t* strip, int stride_px) {
  jpeg_decompress_struct c;
  ErrMgr err;
  if (open_scaled(&c, &err, bytes, n, reduce, false)) return 1;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&c);
    return 1;
  }
  jpeg_start_decompress(&c);
  const int W = static_cast<int>(c.output_width);
  const int H = static_cast<int>(c.output_height);
  if (*x0 < 0 || *w <= 0 || *x0 + *w > W || y0 < 0 || h <= 0 ||
      y0 + h > H) {
    jpeg_abort_decompress(&c);
    jpeg_destroy_decompress(&c);
    return 2;
  }
  const int mx0 = std::max(0, *x0 - 8);
  const int mx1 = std::min(W, *x0 + *w + 8);
  *x0 = mx0;
  *w = mx1 - mx0;
  JDIMENSION jx = static_cast<JDIMENSION>(*x0);
  JDIMENSION jw = static_cast<JDIMENSION>(*w);
  if (!(jx == 0 && jw == c.output_width))
    jpeg_crop_scanline(&c, &jx, &jw);
  *x0 = static_cast<int>(jx);
  *w = static_cast<int>(jw);
  if (*w > stride_px) {  // caller buffer too narrow for the alignment
    jpeg_abort_decompress(&c);
    jpeg_destroy_decompress(&c);
    return 3;
  }
  if (y0 > 0) jpeg_skip_scanlines(&c, static_cast<JDIMENSION>(y0));
  const size_t stride = static_cast<size_t>(stride_px) * 3;
  for (int y = 0; y < h;) {
    JSAMPROW rows[8];
    int take = std::min(8, h - y);
    for (int k = 0; k < take; ++k) rows[k] = strip + (y + k) * stride;
    int got = static_cast<int>(
        jpeg_read_scanlines(&c, rows, static_cast<JDIMENSION>(take)));
    if (got <= 0) {
      jpeg_abort_decompress(&c);
      jpeg_destroy_decompress(&c);
      return 4;
    }
    y += got;
  }
  jpeg_abort_decompress(&c);
  jpeg_destroy_decompress(&c);
  (void)H;
  return 0;
}

// Bilinear tap over a uint8 strip that is a window of a (possibly
// 1/reduce-scaled) frame. Coordinates arrive in STRIP grid units;
// taps outside [0, strip) are zero (the strip covers the whole frame
// extent any in-bounds tap can reach — callers size the window so).
inline float tap_strip(const uint8_t* strip, int sh, int sw, int stride,
                       float ys, float xs, int ch) {
  const int x0 = static_cast<int>(std::floor(xs));
  const int y0 = static_cast<int>(std::floor(ys));
  const float fx = xs - x0;
  const float fy = ys - y0;
  float acc = 0.0f;
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = y0 + dy;
    if (yy < 0 || yy >= sh) continue;
    const float wy = dy ? fy : 1.0f - fy;
    for (int dx = 0; dx < 2; ++dx) {
      const int xx = x0 + dx;
      if (xx < 0 || xx >= sw) continue;
      const float wx = dx ? fx : 1.0f - fx;
      acc += wy * wx *
             strip[(static_cast<int64_t>(yy) * stride + xx) * 3 + ch];
    }
  }
  return acc;
}

// The shared crop sampler: dst (res_h x res_w) -> full-res source via a
// 2x3 affine; optional SPIN box clamp (the zero-pad-slice + resize
// semantics of transforms.crop: sample coords clamp to the box interior
// [bx0, bx0+bw-1] x [by0, by0+bh-1], zero outside the frame). The strip
// is the window [ox, oy) .. of the 1/reduce grid; full-res coord u maps
// to strip coord (u - (reduce-1)/2) / reduce - o.
void sample_crop(const uint8_t* strip, int sh, int sw, int stride,
                 int reduce, float ox, float oy, const float* aff,
                 int res_h, int res_w, int box_clamp, const float* box,
                 float* out) {
  const float off = (reduce - 1) * 0.5f;
  const float inv_r = 1.0f / reduce;
  float bx0 = 0, by0 = 0, bx1 = 0, by1 = 0;
  if (box_clamp) {
    bx0 = box[0];
    by0 = box[1];
    bx1 = box[2];
    by1 = box[3];
  }
  for (int y = 0; y < res_h; ++y) {
    for (int x = 0; x < res_w; ++x) {
      float u = aff[0] * x + aff[1] * y + aff[2];
      float v = aff[3] * x + aff[4] * y + aff[5];
      if (box_clamp) {
        u = u < bx0 ? bx0 : (u > bx1 ? bx1 : u);
        v = v < by0 ? by0 : (v > by1 ? by1 : v);
      }
      const float xs = (u - off) * inv_r - ox;
      const float ys = (v - off) * inv_r - oy;
      float* dst = out + (static_cast<int64_t>(y) * res_w + x) * 3;
      for (int ch = 0; ch < 3; ++ch)
        dst[ch] = tap_strip(strip, sh, sw, stride, ys, xs, ch);
    }
  }
}

// Reusable per-thread strip buffer: loader worker threads call into
// this once per sample; malloc churn of multi-MB strips is measurable.
thread_local uint8_t* tls_strip = nullptr;
thread_local size_t tls_cap = 0;

uint8_t* strip_buffer(size_t need) {
  if (tls_cap < need) {
    std::free(tls_strip);
    tls_strip = static_cast<uint8_t*>(std::malloc(need));
    tls_cap = tls_strip ? need : 0;
  }
  return tls_strip;
}

}  // namespace

extern "C" {

// Header-only probe. out = [height, width, exif_orientation,
// progressive]. Returns 0 on success.
int jpeg_probe(const uint8_t* bytes, long n, int32_t* out) {
  jpeg_decompress_struct c;
  ErrMgr err;
  if (open_scaled(&c, &err, bytes, n, 1, true)) return 1;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&c);
    return 1;
  }
  out[0] = static_cast<int32_t>(c.image_height);
  out[1] = static_cast<int32_t>(c.image_width);
  out[2] = exif_orientation(c);
  out[3] = c.progressive_mode ? 1 : 0;
  jpeg_abort_decompress(&c);
  jpeg_destroy_decompress(&c);
  return 0;
}

// Decode a window at 1/reduce scale into `out` (capacity stride_px
// columns x h rows x 3). On entry *x0/*w is the requested window; on
// exit the actual iMCU-aligned one. Returns 0 on success.
int jpeg_decode_roi(const uint8_t* bytes, long n, int reduce, int32_t* x0,
                    int32_t* w, int y0, int h, uint8_t* out,
                    int stride_px) {
  int xx = *x0, ww = *w;
  int rc = decode_roi(bytes, n, reduce, &xx, &ww, y0, h, out, stride_px);
  *x0 = xx;
  *w = ww;
  return rc;
}

// The crop sampler over an in-memory uint8 image/strip (C-contiguous
// HxWx3). `origin`/`reduce` place the strip on the full-res grid (pass
// 0,0,1 for a full-res frame). aff: 2x3 dst->full-res affine, row-major
// [a, b, c, d, e, f]: u = a*x + b*y + c. box: SPIN clamp box
// [x0, y0, x1, y1] in full-res coords, used when box_clamp != 0.
// out: res_h x res_w x 3 float32 in the strip's value range.
void crop_affine_u8(const uint8_t* img, int h, int w, int reduce,
                    float origin_x, float origin_y, const float* aff,
                    int res_h, int res_w, int box_clamp, const float* box,
                    float* out) {
  sample_crop(img, h, w, w, reduce, origin_x, origin_y, aff, res_h, res_w,
              box_clamp, box, out);
}

// Fused JPEG ROI decode + crop. The window (reduced-grid coords) is
// computed by the python caller from the affine/box (single definition
// of the SPIN corner math stays in python); this decodes it and samples
// the crop in one pass without materializing a python-visible frame.
// Returns 0 on success (decode errors propagate for python fallback).
int jpeg_roi_crop(const uint8_t* bytes, long n, int reduce, int win_x0,
                  int win_y0, int win_w, int win_h, const float* aff,
                  int res_h, int res_w, int box_clamp, const float* box,
                  float* out) {
  // align the request outward to iMCU-safe bounds so the actual window
  // jpeg_crop_scanline picks always fits the buffer
  int x0 = std::max(0, win_x0);
  int w = win_w;
  const int stride_px = ((w + 31) / 32 + 2) * 32;
  uint8_t* strip =
      strip_buffer(static_cast<size_t>(stride_px) * win_h * 3);
  if (!strip) return 5;
  int rc = decode_roi(bytes, n, reduce, &x0, &w, win_y0, win_h, strip,
                      stride_px);
  if (rc) return rc;
  sample_crop(strip, win_h, w, stride_px, reduce, static_cast<float>(x0),
              static_cast<float>(win_y0), aff, res_h, res_w, box_clamp,
              box, out);
  return 0;
}

}  // extern "C"
