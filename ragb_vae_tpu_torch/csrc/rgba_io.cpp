// Native data-loader core: PNG decode -> RGBA8 -> float32 [0,1] NHWC with
// zero padding, plus a threaded batch assembler.
//
// Replaces the Python-side hot path of the input pipeline (the reference
// leans on PIL + torch DataLoader workers; SURVEY.md §2.4 keeps decode on
// the host). PIL's decode releases the GIL but the uint8->float conversion,
// padding and batch stacking run under it; this module does the whole
// decode->normalize->pad->stack chain in C++ worker threads and hands back
// one ready float32 batch buffer.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Decode a PNG into caller-provided float32 buffer of shape
// (max_h, max_w, 4), values in [0,1], zero-padded bottom/right.
// Returns 0 on success; fills *out_w/*out_h with the true size.
// Grayscale/RGB/palette inputs are expanded; missing alpha -> 1.0.
int ragb_decode_png_f32(const char* path, float* dst, int max_h, int max_w,
                        int* out_w, int* out_h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;

  // declared before setjmp: a libpng longjmp must not skip the destructor
  std::vector<uint8_t> row;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(fp);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  // normalize every input to 8-bit RGBA
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_RGB || color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_PALETTE)
    png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  if ((int)height > max_h || (int)width > max_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -4;  // caller buffer too small
  }

  row.resize(png_get_rowbytes(png, info));
  const float inv = 1.0f / 255.0f;
  // zero the destination (padding)
  std::memset(dst, 0, sizeof(float) * (size_t)max_h * max_w * 4);
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* drow = dst + (size_t)y * max_w * 4;
    const uint8_t* src = row.data();
    for (png_uint_32 x = 0; x < width * 4; ++x) drow[x] = src[x] * inv;
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  *out_w = (int)width;
  *out_h = (int)height;
  return 0;
}

// Probe a PNG's dimensions without decoding pixel data.
int ragb_png_size(const char* path, int* out_w, int* out_h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(fp);
    return -2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *out_w = (int)png_get_image_width(png, info);
  *out_h = (int)png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// Decode `count` PNGs into one (count, max_h, max_w, 4) float32 batch with
// `num_threads` workers. paths: array of C strings. Returns the number of
// failures (0 == all good); per-image status in `status` if non-null.
int ragb_decode_batch_f32(const char** paths, int count, float* dst, int max_h,
                          int max_w, int num_threads, int* status) {
  if (count <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > count) num_threads = count;

  std::atomic<int> next(0), failures(0);
  const size_t stride = (size_t)max_h * max_w * 4;

  auto worker = [&]() {
    int w, h;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) break;
      int rc = ragb_decode_png_f32(paths[i], dst + stride * i, max_h, max_w,
                                   &w, &h);
      if (status) status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Encode a float32 [0,1] (h, w, 4) RGBA image to an 8-bit RGBA PNG.
// compression: zlib level 0-9 (6 = libpng default; serving wants 1).
// Returns 0 on success.
int ragb_encode_png_f32(const char* path, const float* src, int h, int w,
                        int compression) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  // declared before setjmp: a libpng longjmp must not skip the destructor
  std::vector<uint8_t> row((size_t)w * 4);
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
    fclose(fp);
    return -2;
  }
  png_init_io(png, fp);
  if (compression >= 0 && compression <= 9)
    png_set_compression_level(png, compression);
  png_set_IHDR(png, info, (png_uint_32)w, (png_uint_32)h, 8,
               PNG_COLOR_TYPE_RGBA, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  for (int y = 0; y < h; ++y) {
    const float* srow = src + (size_t)y * w * 4;
    for (int x = 0; x < w * 4; ++x) {
      float v = srow[x];
      v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      // floor, matching the PIL path's (arr * 255).astype(uint8) exactly
      row[x] = (uint8_t)(v * 255.0f);
    }
    png_write_row(png, row.data());
  }
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

// Encode `count` same-sized images from one (count, h, w, 4) float32 batch
// with `num_threads` workers (the serving daemon's response path). Returns
// the number of failures; per-image status in `status` if non-null.
int ragb_encode_batch_f32(const char** paths, int count, const float* src,
                          int h, int w, int compression, int num_threads,
                          int* status) {
  if (count <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > count) num_threads = count;
  std::atomic<int> next(0), failures(0);
  const size_t stride = (size_t)h * w * 4;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) break;
      int rc = ragb_encode_png_f32(paths[i], src + stride * i, h, w,
                                   compression);
      if (status) status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// uint8 HWC -> float32 [0,1] (utility for non-PNG sources).
void ragb_u8_to_f32(const uint8_t* src, float* dst, long long n) {
  const float inv = 1.0f / 255.0f;
  for (long long i = 0; i < n; ++i) dst[i] = src[i] * inv;
}

}  // extern "C"
