// Native image-decode/resample core for the host data pipeline.
//
// A copy of semivl_tpu/native/image_core.cpp. The reference rides torch's
// C++ DataLoader + PIL (third_party/unimatch/dataset/semi.py); on a host
// with few CPU cores decode+resize is the train loop's host bottleneck.
// This core provides:
//   - JPEG (libjpeg) and PNG (libpng) decoding to RGB8 / GRAY8,
//   - PIL-parity triangle-filter (BILINEAR) resampling, incl. the
//     area-style widened support on downscale,
//   - nearest-neighbour resampling for label masks,
// exposed with a C ABI for ctypes (no pybind11 on this image).
//
// Build: see semivl_tpu_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------- decode

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void err_exit(j_common_ptr cinfo) {
  ErrMgr* mgr = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(mgr->jb, 1);
}

// Decode JPEG bytes to RGB8 with optional fractional-scale decode
// (scale_denom in {1, 2, 4, 8}: IDCT-level downscaling — decoding at 1/2
// costs ~1/4 of the full IDCT work, the key saving for large images like
// Cityscapes 2048x1024 that are immediately downscaled in the weak-aug
// resize). Returns 0 on success; fills w/h (POST-scaling) and writes into
// out (caller-allocated if *out non-null with cap bytes, else malloc'd).
int decode_jpeg_scaled(const uint8_t* data, long len, int scale_denom,
                       uint8_t** out, long cap, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  long need = 3L * (*w) * (*h);
  if (*out == nullptr) {
    *out = static_cast<uint8_t*>(malloc(need));
  } else if (cap < need) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  uint8_t* dst = *out;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = dst + 3L * (*w) * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_jpeg(const uint8_t* data, long len, uint8_t** out, long cap,
                int* w, int* h) {
  return decode_jpeg_scaled(data, len, 1, out, cap, w, h);
}

struct PngReadState {
  const uint8_t* data;
  long len;
  long pos;
};

static void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + static_cast<long>(n) > s->len) {
    png_error(png, "eof");
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

// Decode PNG to RGB8 (channels=3) or GRAY8 (channels=1, for label masks —
// palette indices are preserved, not expanded to RGB).
int decode_png(const uint8_t* data, long len, int channels, uint8_t** out,
               long cap, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState state{data, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (channels == 3) {
    // expand palette/gray to RGB, drop alpha
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
  } else {
    // label masks: keep raw palette indices / gray values
    if (depth < 8) png_set_packing(png);
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_GRAY_ALPHA) {
      png_destroy_read_struct(&png, &info, nullptr);
      return 3;  // not an index/gray mask
    }
  }
  png_read_update_info(png, info);
  long rowbytes = png_get_rowbytes(png, info);
  long need = rowbytes * (*h);
  if (*out == nullptr) {
    *out = static_cast<uint8_t*>(malloc(need));
  } else if (cap < need) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; y++) rows[y] = *out + rowbytes * y;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

void free_buffer(uint8_t* p) { free(p); }

// ---------------------------------------------------------- resampling

// PIL-parity triangle (BILINEAR) filter: support widens by the scale factor
// on downscale (convolution resampling, Pillow Resample.c semantics).
static void resample_axis_u8(const uint8_t* src, int in_size, int stride_in,
                             int lines, int line_stride_in, uint8_t* dst,
                             int out_size, int stride_out,
                             int line_stride_out, int channels) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(ceil(support)) * 2 + 1;

  std::vector<int> bounds(out_size * 2);
  std::vector<double> kk(out_size * ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = std::max(0, static_cast<int>(center - support + 0.5));
    int xmax = std::min(in_size, static_cast<int>(center + support + 0.5));
    double* k = &kk[xx * ksize];
    int n = xmax - xmin;
    for (int x = 0; x < n; x++) {
      double arg = (x + xmin - center + 0.5) * ss;
      double wgt = arg < 0 ? arg + 1.0 : 1.0 - arg;  // triangle
      if (wgt < 0) wgt = 0;
      k[x] = wgt;
      ww += wgt;
    }
    for (int x = 0; x < n; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = n;
  }

  for (int line = 0; line < lines; line++) {
    const uint8_t* in_line = src + static_cast<long>(line) * line_stride_in;
    uint8_t* out_line = dst + static_cast<long>(line) * line_stride_out;
    for (int xx = 0; xx < out_size; xx++) {
      int xmin = bounds[xx * 2 + 0];
      int n = bounds[xx * 2 + 1];
      const double* k = &kk[xx * ksize];
      for (int c = 0; c < channels; c++) {
        double acc = 0.0;
        for (int x = 0; x < n; x++) {
          acc += in_line[static_cast<long>(xmin + x) * stride_in + c] * k[x];
        }
        long v = lround(acc);
        out_line[static_cast<long>(xx) * stride_out + c] =
            static_cast<uint8_t>(std::clamp<long>(v, 0, 255));
      }
    }
  }
}

// Bilinear (PIL triangle filter) resize, HWC uint8.
void resize_bilinear_u8(const uint8_t* src, int h, int w, int channels,
                        uint8_t* dst, int oh, int ow) {
  // horizontal pass then vertical pass (separable), as Pillow does
  std::vector<uint8_t> tmp(static_cast<long>(h) * ow * channels);
  resample_axis_u8(src, w, channels, h, w * channels, tmp.data(), ow,
                   channels, ow * channels, channels);
  // vertical: treat columns as the resample axis
  // reorganize: operate with stride tricks — lines are columns now
  std::vector<uint8_t> tmp2(static_cast<long>(oh) * ow * channels);
  // transpose-free: for vertical, in-line stride is row pitch
  {
    double scale = static_cast<double>(h) / oh;
    double filterscale = std::max(scale, 1.0);
    double support = 1.0 * filterscale;
    int ksize = static_cast<int>(ceil(support)) * 2 + 1;
    std::vector<int> bounds(oh * 2);
    std::vector<double> kk(static_cast<long>(oh) * ksize);
    for (int yy = 0; yy < oh; yy++) {
      double center = (yy + 0.5) * scale;
      double ww = 0.0;
      double ss = 1.0 / filterscale;
      int ymin = std::max(0, static_cast<int>(center - support + 0.5));
      int ymax = std::min(h, static_cast<int>(center + support + 0.5));
      double* k = &kk[static_cast<long>(yy) * ksize];
      int n = ymax - ymin;
      for (int y = 0; y < n; y++) {
        double arg = (y + ymin - center + 0.5) * ss;
        double wgt = arg < 0 ? arg + 1.0 : 1.0 - arg;
        if (wgt < 0) wgt = 0;
        k[y] = wgt;
        ww += wgt;
      }
      for (int y = 0; y < n; y++) {
        if (ww != 0.0) k[y] /= ww;
      }
      bounds[yy * 2 + 0] = ymin;
      bounds[yy * 2 + 1] = n;
    }
    long row_pitch = static_cast<long>(ow) * channels;
    for (int yy = 0; yy < oh; yy++) {
      int ymin = bounds[yy * 2 + 0];
      int n = bounds[yy * 2 + 1];
      const double* k = &kk[static_cast<long>(yy) * ksize];
      for (long i = 0; i < row_pitch; i++) {
        double acc = 0.0;
        for (int y = 0; y < n; y++) {
          acc += tmp[(ymin + y) * row_pitch + i] * k[y];
        }
        long v = lround(acc);
        tmp2[yy * row_pitch + i] =
            static_cast<uint8_t>(std::clamp<long>(v, 0, 255));
      }
    }
  }
  memcpy(dst, tmp2.data(), tmp2.size());
}

// Nearest-neighbour resize (PIL NEAREST parity: sample at pixel centers,
// floor((x + 0.5) * in/out)).
void resize_nearest_u8(const uint8_t* src, int h, int w, int channels,
                       uint8_t* dst, int oh, int ow) {
  for (int yy = 0; yy < oh; yy++) {
    int sy = std::min(
        static_cast<int>((yy + 0.5) * (static_cast<double>(h) / oh)), h - 1);
    for (int xx = 0; xx < ow; xx++) {
      int sx = std::min(
          static_cast<int>((xx + 0.5) * (static_cast<double>(w) / ow)),
          w - 1);
      for (int c = 0; c < channels; c++) {
        dst[(static_cast<long>(yy) * ow + xx) * channels + c] =
            src[(static_cast<long>(sy) * w + sx) * channels + c];
      }
    }
  }
}

// uint8 HWC -> float32 HWC ImageNet-normalised.
void normalize_imagenet_f32(const uint8_t* src, long n_pixels, float* dst) {
  static const float mean[3] = {0.485f, 0.456f, 0.406f};
  static const float inv_std[3] = {1.0f / 0.229f, 1.0f / 0.224f,
                                   1.0f / 0.225f};
  for (long i = 0; i < n_pixels; i++) {
    for (int c = 0; c < 3; c++) {
      dst[i * 3 + c] =
          (src[i * 3 + c] * (1.0f / 255.0f) - mean[c]) * inv_std[c];
    }
  }
}

}  // extern "C"
