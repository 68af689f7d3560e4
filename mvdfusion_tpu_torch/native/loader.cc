// Native image loader: threaded decode + resize + composite on the host.
//
// libjpeg / libpng decode to float32 HWC divided by 255 (16-bit png samples
// too, so 16-bit depth lands in [0, 257]), an area (box) average to
// downscale and a half-pixel bilinear to upscale, the hard alpha < 0.5
// white composite after the resize, and a std::thread pool for a batch.
// A plain C ABI, loaded with ctypes (mvdfusion_tpu_torch/native/__init__.py).
// The arithmetic is the JAX package's loader's, operation for operation:
// built with the same flags, both give the same floats.
//
// Build (native/__init__.py::build, into build/mvdfusion_tpu_torch/):
//   g++ -O3 -fPIC -std=c++17 -Wall -shared -o libmvdf_loader.so loader.cc -ljpeg -lpng -lz -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<float> data;  // HWC, [0,1]
};

// ------------------------------------------------------------------ JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* fp, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  std::vector<uint8_t> row(size_t(out->w) * cinfo.output_components);
  uint8_t* rowp = row.data();
  for (int y = 0; y < out->h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out->data.data() + size_t(y) * out->w * 3;
    for (int i = 0; i < out->w * 3; ++i) dst[i] = row[i] * (1.0f / 255.0f);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------------- PNG
bool decode_png(FILE* fp, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);
  // 16-bit samples (the Objaverse depth renders) keep full precision and
  // are divided by 255 like every other sample, so they may exceed 1.
  const bool is16 = (bit_depth == 16) && (color_type != PNG_COLOR_TYPE_PALETTE);
  if (is16) png_set_swap(png);  // png stores big-endian; the host is little-endian
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  out->h = h;
  out->w = w;
  out->c = channels;
  out->data.resize(size_t(h) * w * channels);
  if (is16) {
    std::vector<uint16_t> row(size_t(w) * channels);
    for (png_uint_32 y = 0; y < h; ++y) {
      png_read_row(png, reinterpret_cast<png_bytep>(row.data()), nullptr);
      float* dst = out->data.data() + size_t(y) * w * channels;
      for (size_t i = 0; i < row.size(); ++i) dst[i] = row[i] * (1.0f / 255.0f);
    }
  } else {
    std::vector<uint8_t> row(size_t(w) * channels);
    for (png_uint_32 y = 0; y < h; ++y) {
      png_read_row(png, row.data(), nullptr);
      float* dst = out->data.data() + size_t(y) * w * channels;
      for (size_t i = 0; i < row.size(); ++i) dst[i] = row[i] * (1.0f / 255.0f);
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  uint8_t magic[8] = {0};
  if (fread(magic, 1, 8, fp) != 8) {
    fclose(fp);
    return false;
  }
  rewind(fp);
  bool ok = false;
  if (magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(fp, out);
  } else if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(fp, out);
  }
  fclose(fp);
  return ok;
}

// ---------------------------------------------------------------- resize
// Area average (box filter) when either ratio is >= 1, else bilinear with
// half-pixel centres.
void resize_image(const Image& src, int oh, int ow, Image* dst) {
  dst->h = oh;
  dst->w = ow;
  dst->c = src.c;
  dst->data.resize(size_t(oh) * ow * src.c);
  const int c = src.c;
  if (oh == src.h && ow == src.w) {
    dst->data = src.data;
    return;
  }
  const float sy = float(src.h) / oh, sx = float(src.w) / ow;
  if (sy >= 1.0f || sx >= 1.0f) {  // box-filter downscale
    for (int y = 0; y < oh; ++y) {
      const float y0 = y * sy, y1 = (y + 1) * sy;
      const int iy0 = int(y0), iy1 = std::min(int(y1 + 0.9999f), src.h);
      for (int x = 0; x < ow; ++x) {
        const float x0 = x * sx, x1 = (x + 1) * sx;
        const int ix0 = int(x0), ix1 = std::min(int(x1 + 0.9999f), src.w);
        for (int k = 0; k < c; ++k) {
          float acc = 0.0f, area = 0.0f;
          for (int yy = iy0; yy < iy1; ++yy) {
            const float wy = std::min(float(yy + 1), y1) - std::max(float(yy), y0);
            for (int xx = ix0; xx < ix1; ++xx) {
              const float wx = std::min(float(xx + 1), x1) - std::max(float(xx), x0);
              acc += wy * wx * src.data[(size_t(yy) * src.w + xx) * c + k];
              area += wy * wx;
            }
          }
          dst->data[(size_t(y) * ow + x) * c + k] = acc / area;
        }
      }
    }
  } else {  // bilinear upscale (half-pixel centers)
    for (int y = 0; y < oh; ++y) {
      const float fy = (y + 0.5f) * sy - 0.5f;
      const int iy0 = std::max(0, std::min(int(fy), src.h - 1));
      const int iy1 = std::min(iy0 + 1, src.h - 1);
      const float ty = fy - iy0;
      for (int x = 0; x < ow; ++x) {
        const float fx = (x + 0.5f) * sx - 0.5f;
        const int ix0 = std::max(0, std::min(int(fx), src.w - 1));
        const int ix1 = std::min(ix0 + 1, src.w - 1);
        const float tx = fx - ix0;
        for (int k = 0; k < c; ++k) {
          auto at = [&](int yy, int xx) {
            return src.data[(size_t(yy) * src.w + xx) * c + k];
          };
          dst->data[(size_t(y) * ow + x) * c + k] =
              (1 - ty) * ((1 - tx) * at(iy0, ix0) + tx * at(iy0, ix1)) +
              ty * ((1 - tx) * at(iy1, ix0) + tx * at(iy1, ix1));
        }
      }
    }
  }
}

// one fully processed sample into `out` (out_h*out_w*out_c floats)
bool load_one(const char* path, int out_h, int out_w, int out_c, bool white_composite,
              float* out) {
  Image img;
  if (!decode_file(path, &img)) return false;
  Image resized;
  resize_image(img, out_h, out_w, &resized);
  const int c_in = resized.c;
  for (int i = 0; i < out_h * out_w; ++i) {
    float r = resized.data[size_t(i) * c_in + 0];
    float g = c_in >= 3 ? resized.data[size_t(i) * c_in + 1] : r;
    float b = c_in >= 3 ? resized.data[size_t(i) * c_in + 2] : r;
    float a = c_in == 4 ? resized.data[size_t(i) * c_in + 3] : 1.0f;
    if (white_composite && c_in == 4 && a < 0.5f) {
      // a hard threshold, not alpha blending
      r = g = b = 1.0f;
    }
    if (out_c == 1) {
      out[i] = r;
    } else {
      out[size_t(i) * out_c + 0] = r;
      if (out_c >= 2) out[size_t(i) * out_c + 1] = g;
      if (out_c >= 3) out[size_t(i) * out_c + 2] = b;
      if (out_c == 4) out[size_t(i) * out_c + 3] = a;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode + resize + (optionally) white-composite one image into a
// caller-allocated float32 HWC buffer. Returns 0 on success.
int mvdf_decode(const char* path, float* out, int out_h, int out_w, int out_c,
                int white_composite) {
  return load_one(path, out_h, out_w, out_c, white_composite != 0, out) ? 0 : 1;
}

// Batch decode with a worker pool; `out` holds n contiguous images.
// Returns the number of failed files.
int mvdf_decode_batch(const char** paths, int n, float* out, int out_h, int out_w,
                      int out_c, int white_composite, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out + size_t(i) * out_h * out_w * out_c;
      if (!load_one(paths[i], out_h, out_w, out_c, white_composite != 0, dst)) {
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  const int nt = std::min(n_threads, n);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
